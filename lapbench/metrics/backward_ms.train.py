"""Mean device time of the program's span lapgnn.train.backward: torch.autograd.grad of the loss (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.train.backward")
