"""The train step's model FLOPs over the window at the float32 rate (%)."""

from lapbench import yardstick


def read(rec):
    return yardstick.train_mfu_pct(rec)
