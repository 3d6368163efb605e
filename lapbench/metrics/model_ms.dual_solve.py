"""Mean device time of the program's span lapgnn.predict.model: the DualGNN forward over n^2 edges (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.predict.model")
