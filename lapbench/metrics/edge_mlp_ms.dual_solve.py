"""Mean device time of the program's span lapgnn.dual.edge, one a layer: the edge MLP and the two edge terms (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.dual.edge")
