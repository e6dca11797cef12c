"""device.idle_share: the share of the traced slice in which no operation
ran on the card (the union of the profiler's kernel and copy intervals),
in %, in the process that holds the card."""

from harness.trace import busy_s


def read(run):
    trace = run["trace"]
    if not trace.ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(trace.ops) / trace.window_s)
