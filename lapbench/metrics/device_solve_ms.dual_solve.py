"""Mean device time of the program's span lapgnn.seeded: the seeded device solve (S3, S2, S1 and the gate) from the DualGNN's seed (CUDA events, ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.seeded")
