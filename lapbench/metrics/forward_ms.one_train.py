"""Mean device time of the program's span lapgnn.train.forward: the OneGNN forward with dropout and the top-k refinement (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.train.forward")
