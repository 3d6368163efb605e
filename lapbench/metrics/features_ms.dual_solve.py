"""Mean device time of the program's span lapgnn.predict.features: graph_features, the dense edge and node features (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.predict.features")
