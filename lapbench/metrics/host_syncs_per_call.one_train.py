"""Mean rise of the program's host_syncs counter over its span lapgnn.train.call: the host's waits on the device in one curriculum call (the fetch's index upload, the step's, the loss readback)."""

from lapbench import program_spans


def read(rec):
    return program_spans.mean_count("lapgnn.train.call", "host_syncs")
