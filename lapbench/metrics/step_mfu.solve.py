"""The whole serving step: instances times the least time of one, over the window (%)."""

from lapbench import yardstick


def read(rec):
    return yardstick.solve_mfu_pct(rec)
