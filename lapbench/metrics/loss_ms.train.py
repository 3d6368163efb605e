"""Mean device time of the program's span lapgnn.train.loss: dual_gnn_loss with the greedy kernel (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.train.loss")
