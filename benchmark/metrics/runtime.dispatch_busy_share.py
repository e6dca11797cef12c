"""runtime.dispatch_busy_share: the share of the window in which the
device runtime's one dispatch thread held a job (the sum of replied -
pick over the window's jobs, the rise of device_stats()["stages"]
["busy_ns"]), in %."""

from harness.timeline import window_stages


def read(run):
    both = window_stages(run)
    window_s = run["calls"]["window_s"]
    if both is None or window_s <= 0:
        return None
    before, after = both
    return 100.0 * (after["busy_ns"] - before["busy_ns"]) / 1e9 / window_s
