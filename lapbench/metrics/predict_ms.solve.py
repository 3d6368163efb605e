"""Mean device time of pipeline.predict_duals_fn's predict in a solve call (CUDA events, ms)."""

from lapbench import yardstick


def read(rec):
    return yardstick.mean_span_ms(rec, "predict")
