"""Mean device time of the program's span lapgnn.dual.attention, one a layer: the node projections, both attention directions and the node updates (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.dual.attention")
