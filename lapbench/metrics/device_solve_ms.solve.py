"""Mean device time of solver.seeded.lapjv_seeded_single (S3, S2, S1 and the gate) a solve (CUDA events, ms)."""

from lapbench import yardstick


def read(rec):
    return yardstick.mean_span_ms(rec, "device_solve")
