"""Mean rise of the program's host_syncs counter over its span lapgnn.solve: the host's waits on the device in one DualGNN-served solve call."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_count("lapgnn.solve", "host_syncs")
