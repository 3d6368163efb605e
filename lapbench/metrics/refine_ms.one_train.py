"""Mean device time of the program's span lapgnn.one.refine: the top-k refinement inside the forward (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.one.refine")
