"""Share of the traced window with nothing running on the card (torch.profiler, %)."""

from lapbench import yardstick


def read(rec):
    return yardstick.device_idle_pct(rec)
