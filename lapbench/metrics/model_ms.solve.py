"""Mean device time of the program's span lapgnn.predict.model: the OneGNN forward and the rescale of u (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.predict.model")
