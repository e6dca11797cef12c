"""runtime.device_p50_us: a job's round trip through the card (synced -
h2d: the copy in, the kernel, the copy out and the Sync that waits for
them), at its median over every job of the window, from the device
runtime's cumulative hop histograms."""

from harness.timeline import hop_percentile_us


def read(run):
    return hop_percentile_us(run, "device", 50)
