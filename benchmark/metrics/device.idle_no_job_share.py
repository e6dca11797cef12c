"""device.idle_no_job_share: the share of the traced slice in which the
device runtime's dispatch thread held no job (between one job's reply and
the next job's pick), in %, from the job records on CLOCK_MONOTONIC, the
clock of the slice's start. None where the records no longer reach back
to the slice's start (the ring keeps the newest jobs only).

It is the card's idle time that the upstream (the transport and the
server's request pickup) leaves: the runtime issues every copy and kernel
inside its job's [h2d, synced] and waits for them there, so the card is
idle whenever no job is held. Read from the records alone, it is also
100 - the dispatch thread's busy share over the slice.
runtime.dispatch_busy_share is that thread's busy share over the whole
window instead, so the two need not sum to 100. On an H100 the thread
was 7-11 points busier in the slice than over the window: under the
profiler a job held it 10-20 us longer, and fewer of the thread's idle
gaps over 1 ms fell in the slice (PERF.md section 6)."""

from harness.timeline import covers, no_job_seconds, slice_jobs


def read(run):
    trace = run["trace"]
    t0 = getattr(trace, "_t0", 0.0) * 1e9
    if not trace.ops or trace.window_s <= 0 or t0 <= 0:
        return None
    lo, hi = t0, t0 + trace.window_s * 1e9
    jobs = slice_jobs(since_ns=lo, until_ns=hi)
    if jobs is None or not covers(jobs, lo):
        return None
    return 100.0 * no_job_seconds(jobs, lo, hi) / trace.window_s
