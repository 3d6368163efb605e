"""The whole DualGNN-served step: instances times the least time of one (dual_serve_bound), over the window (%)."""

from lapbench import dual_serve_bound


def read(rec):
    return dual_serve_bound.solve_mfu_pct(rec)
