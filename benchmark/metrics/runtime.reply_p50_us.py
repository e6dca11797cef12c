"""runtime.reply_p50_us: the job's callback on the dispatch thread
(replied - synced: the server's done(), which writes the response), at
its median over every job of the window, from the device runtime's
cumulative hop histograms."""

from harness.timeline import hop_percentile_us


def read(run):
    return hop_percentile_us(run, "reply", 50)
