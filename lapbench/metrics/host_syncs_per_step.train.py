"""Mean rise of the program's host_syncs counter over its span lapgnn.train.step: the host's waits on the device in one train step."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_count("lapgnn.train.step", "host_syncs")
