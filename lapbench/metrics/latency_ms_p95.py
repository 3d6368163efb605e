"""95th percentile of the time of a solve call over every request of the window (host clock, ms); a failed request counts as infinitely late."""

from lapbench import yardstick


def read(rec):
    return yardstick.percentile(rec["latencies_ms"], 95) if rec.get("latencies_ms") else None
