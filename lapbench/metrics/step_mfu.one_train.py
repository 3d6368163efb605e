"""Steps times the least time of one OneGNN train step (one_train_bound: its model FLOPs against one read of the batch's costs), over the window (%)."""

from lapbench import one_train_bound


def read(rec):
    return one_train_bound.step_mfu_pct(rec)
