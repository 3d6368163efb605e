"""Mean device time of the program's span lapgnn.predict.seed: auto_select_seed, rank-1, the K2 min-tricks, Sinkhorn and the selection (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.predict.seed")
