"""server.dispatch_to_done_p50_us: the server's device-method hop, from
the device runtime's EnqueueJob to the job's reply written (the hop `job`
= replied - enq: queue wait, host prep, the round trip through the card
and the server's done()), at its median over every job of the window,
from the device runtime's cumulative hop histograms
(device_stats()["stages"], after - before)."""

from harness.timeline import hop_percentile_us


def read(run):
    return hop_percentile_us(run, "job", 50)
