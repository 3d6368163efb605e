"""The port's hand-written kernels in the traced window: their least times over their device times (%)."""

from lapbench import yardstick


def read(rec):
    return yardstick.kernel_roofline_pct(rec)
