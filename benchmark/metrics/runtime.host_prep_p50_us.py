"""runtime.host_prep_p50_us: the dispatch thread's host work on a job
before its first copy to the card (h2d - pick: the plan, the DMA pins,
donation or staging), at its median over every job of the window, from
the device runtime's cumulative hop histograms."""

from harness.timeline import hop_percentile_us


def read(run):
    return hop_percentile_us(run, "host_prep", 50)
