"""Mean device time of the program's span lapgnn.train.features: graph_features inside the step (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.train.features")
