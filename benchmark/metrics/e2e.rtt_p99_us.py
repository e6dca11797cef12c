"""e2e.rtt_p99_us: the end-to-end tail, the 99th percentile of the round
trips of every call of the traced run's window (a miss as its deadline).
It stands in for an end-to-end rtt_p99_us, which no bound of at most 25%
holds yet (PERF.md §2): about 1% of the calls sit in host stalls of
10-40 ms, so the 99th percentile falls on either side of them."""

from harness.stats import percentile


def read(run):
    rtt = run["calls"]["rtt_us"]
    return percentile(rtt, 99) if len(rtt) else None
