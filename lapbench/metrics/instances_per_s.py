"""Correct instances completed over the whole window (host clock)."""


def read(rec):
    return rec["instances_ok"] / rec["window_s"] if "instances_ok" in rec else None
