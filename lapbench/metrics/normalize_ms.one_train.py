"""Mean device time of the program's span lapgnn.train.normalize: robust_normalize of the batch and its targets (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.train.normalize")
