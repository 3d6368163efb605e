"""Mean device time of the program's span lapgnn.predict.features: robust_normalize and the row features, K3 with K1 (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.predict.features")
