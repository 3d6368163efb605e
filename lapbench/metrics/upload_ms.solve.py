"""Mean host time of the program's span lapgnn.stage: a solve call's pack of the host matrix and its blocking upload (ms)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_ms("lapgnn.stage", host=True)
