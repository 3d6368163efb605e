"""Samples trained on over the whole window, up to the device's end of the last step (host clock)."""


def read(rec):
    return rec["samples"] / rec["window_s"] if "samples" in rec else None
