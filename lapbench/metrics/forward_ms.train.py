"""Mean device time of the DualGNN forward inside the step (CUDA events, ms)."""

from lapbench import yardstick


def read(rec):
    return yardstick.mean_span_ms(rec, "forward")
