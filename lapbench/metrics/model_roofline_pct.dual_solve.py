"""The DualGNN forward's least time (dual_serve_bound, edge_fc3 folded) over the mean device time of the program's span lapgnn.predict.model (%)."""

from lapbench import dual_serve_bound, program_spans


def read(rec):
    return dual_serve_bound.model_roofline_pct(rec, program_spans.mean_ms("lapgnn.predict.model"))
