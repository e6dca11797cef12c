"""runtime.queue_wait_p50_us: a device job's wait in the runtime's queue
(pick - enq: EnqueueJob to the dispatch thread's pop), at its median over
every job of the window, from the device runtime's cumulative hop
histograms (device_stats()["stages"], after - before)."""

from harness.timeline import hop_percentile_us


def read(run):
    return hop_percentile_us(run, "queue", 50)
