"""The readers of the device runtime's job timeline (harness/timeline.py
and the six metrics that read it) against hand-worked answers and a
synthetic slice, and every reader that was there before them giving the
same value whether or not the new records are in the readings."""

import copy
from types import SimpleNamespace

import numpy as np
import pytest

from harness import spec, timeline

NEW = ["runtime.queue_wait_p50_us", "runtime.host_prep_p50_us",
       "runtime.device_p50_us", "runtime.reply_p50_us",
       "runtime.dispatch_busy_share", "device.idle_no_job_share"]
OLD = [m["name"] for m in spec.benchmark()["per_layer"]
       if m["name"] not in NEW]
JOB_DTYPE = [("seq", "<i8"), ("enq", "<i8"), ("pick", "<i8"),
             ("h2d", "<i8"), ("exec", "<i8"), ("synced", "<i8"),
             ("replied", "<i8"), ("trace_id", "<u8"), ("span_id", "<u8"),
             ("depth", "<i4"), ("rc", "<i4")]


def _bucket_lo():
    """The runtime's bucket bounds: [0, 64), 16 an octave to 2^36, open."""
    lo = [0]
    for e in range(6, 36):
        lo += [(1 << e) + (s << (e - 4)) for s in range(16)]
    return lo + [1 << 36]


LO = _bucket_lo()


def _bucket(ns):
    return next(b for b in range(len(LO) - 1, -1, -1) if LO[b] <= ns)


def _stages(jobs, hops, busy_ns):
    return {"jobs": jobs, "ring_capacity": 131072, "bucket_lo_ns": LO,
            "hops": {h: {"count": sum(n for _, n in b), "sum_ns": 0,
                         "buckets": b} for h, b in hops.items()},
            "depth": [], "busy_ns": busy_ns,
            "slow_jobs": {"over_ns": 5000000, "queue": 0, "host_prep": 0,
                          "device": 0, "reply": 0}}


def _recorded_run():
    """A traced run's readings as an older program gives them (no
    "stages" block), hand-made."""
    ops = [("Memcpy HtoD (Pinned -> Device)", 0.0, 40.0),
           ("void (anonymous namespace)::u8_transform_kernel<1>(uint4 "
            "const*)", 42.0, 44.0),
           ("Memcpy DtoH (Device -> Pinned)", 46.0, 86.0),
           ("Memcpy HtoD (Pinned -> Device)", 200.0, 240.0),
           ("void (anonymous namespace)::u8_transform_kernel<1>(uint4 "
            "const*)", 242.0, 245.0),
           ("Memcpy DtoH (Device -> Pinned)", 247.0, 290.0)]
    stage = {"tbus_shm_stage_dispatch_to_done": {"count": 90,
                                                 "p50_ns": 567000,
                                                 "p99_ns": 900000},
             "tbus_shm_stage_ring_to_pickup": {"count": 90, "p50_ns": 1000,
                                               "p99_ns": 233900}}
    dma = {"h2d_copy_bytes": 10, "d2h_copy_bytes": 20}
    return {
        "traffic": {"payload_bytes": 1 << 20},
        "calls": {"attempted": 100, "completed": 100, "ok": 100,
                  "window_s": 2.0,
                  "rtt_us": np.arange(1.0, 101.0)},
        "before": {"device": {"executions": 0},
                   "dma": {"h2d_copy_bytes": 0, "d2h_copy_bytes": 0},
                   "stage": {"tbus_shm_stage_dispatch_to_done":
                             {"count": 10}}},
        "after": {"device": {"executions": 100}, "dma": dma, "stage": stage},
        "stage_client": {"tbus_shm_stage_ring_to_pickup":
                         {"count": 5, "p99_ns": 120000}},
        "trace": SimpleNamespace(ops=ops, window_s=0.001, _t0=1000.0),
    }


def _with_stages(run):
    """The same run with the job timeline's records in its readings."""
    run = copy.deepcopy(run)
    run["before"]["device"]["stages"] = _stages(
        10, {h: [[_bucket(1050), 10]] for h in timeline.HOPS}, 1_000_000)
    after = {h: [[_bucket(1050), 10]] for h in timeline.HOPS}
    after["queue"] = [[_bucket(1050), 13], [_bucket(2100), 1]]
    after["host_prep"] = [[_bucket(1050), 10], [_bucket(30000), 4]]
    after["device"] = [[_bucket(1050), 10], [_bucket(60000), 3],
                       [_bucket(200000), 1]]
    after["reply"] = [[_bucket(1050), 10], [_bucket(5000), 4]]
    after["job"] = [[_bucket(1050), 10], [_bucket(300000), 4]]
    run["after"]["device"]["stages"] = _stages(14, after, 1_201_000_000)
    return run


def _read(name, run):
    return spec.reader(name)(run)


def test_bucket_bounds_match_the_runtimes_rule():
    assert len(LO) == 2 + 30 * 16 and LO[1] == 64 and LO[-1] == 1 << 36
    assert _bucket(63) == 0 and _bucket(64) == 1 and _bucket(67) == 1
    assert _bucket(68) == 2 and _bucket(1 << 40) == len(LO) - 1


def test_bucket_percentile_is_the_middle_of_the_bucket_holding_it():
    delta = {_bucket(1000): 50, _bucket(2000): 49, _bucket(100000): 1}
    # 1000 lies in [992, 1024): the median is its middle.
    assert timeline.bucket_percentile(delta, LO, 50) == 1008.0
    assert timeline.bucket_percentile(delta, LO, 99) == (1984 + 2048) / 2
    assert timeline.bucket_percentile(delta, LO, 100) == (98304 + 102400) / 2
    assert timeline.bucket_percentile({}, LO, 50) is None
    assert timeline.bucket_percentile({len(LO) - 1: 1}, LO, 50) == 1 << 36


@pytest.mark.parametrize("name,want", [
    # 4 new jobs: 3 queued in [1024, 1088), 1 in [2048, 2176).
    ("runtime.queue_wait_p50_us", 1.056),
    # 4 new jobs, all in [29696, 30720).
    ("runtime.host_prep_p50_us", 30.208),
    # 3 in [59392, 61440), 1 in [196608, 204800): the median is the first.
    ("runtime.device_p50_us", 60.416),
    # 4 new jobs, all in [4864, 5120).
    ("runtime.reply_p50_us", 4.992),
    # 1.2 s busy over a 2 s window.
    ("runtime.dispatch_busy_share", 60.0),
])
def test_counter_readers_against_hand_worked_answers(name, want):
    assert _read(name, _with_stages(_recorded_run())) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_new_readers_find_nothing_in_an_older_programs_run(name,
                                                           monkeypatch):
    monkeypatch.setattr(timeline, "slice_jobs", lambda **kw: None)
    assert _read(name, _recorded_run()) is None


def test_no_window_jobs_read_as_nothing():
    run = _with_stages(_recorded_run())
    run["after"]["device"]["stages"] = run["before"]["device"]["stages"]
    for name in NEW[:5]:
        assert _read(name, run) is None, name


@pytest.mark.parametrize("name", OLD)
def test_existing_readers_read_the_same_with_the_new_records(name,
                                                             monkeypatch):
    jobs = _synthetic_slice(seed=3)[1]
    monkeypatch.setattr(timeline, "slice_jobs", lambda **kw: jobs)
    run = _recorded_run()
    first = _read(name, run)
    assert first is not None
    assert _read(name, _with_stages(run)) == first
    assert _read(name, run) == first


OFFSET = 1_000_000_123_456.0  # the profiler's zero on the monotonic clock
DRIFT = 20e-6                 # the card's clock against the host's
T0 = OFFSET + 2.3e6           # DeviceTrace's start, just after it
WINDOW_S = 1.0


def _synthetic_slice(seed):
    """A serial dispatch thread's jobs (pick, h2d, exec, synced, replied)
    and the card's copies and kernel for each, the way the card sees them:
    each copy starts 2-6 us after its issue and the last ends 2-6 us
    before the Sync returns; gaps between jobs mostly short, some long;
    the profiler's times run DRIFT fast of the host's."""
    rng = np.random.default_rng(seed)
    u = rng.uniform
    t = OFFSET - 3e6
    rows, ops = [], []
    while t < T0 + WINDOW_S * 1e9 + 3e6:
        gap = u(5e3, 30e3) if u() > 0.05 else u(2e5, 3e6)
        pick = t + gap
        h2d = pick + u(15e3, 40e3)
        exe = h2d + 1e3
        a = h2d + u(2e3, 6e3)
        b = a + u(25e3, 45e3)
        k0 = b + u(1e3, 3e3)
        k1 = k0 + 2e3
        c = k1 + u(1e3, 3e3)
        d = c + u(25e3, 45e3)
        synced = d + u(2e3, 6e3)
        replied = synced + u(10e3, 30e3)
        rows.append((pick - u(0, 1e5), pick, h2d, exe, synced, replied))
        for name, s, e in (("Memcpy HtoD (Pinned -> Device)", a, b),
                           ("void u8_transform_kernel<1>(uint4 const*)",
                            k0, k1),
                           ("Memcpy DtoH (Device -> Pinned)", c, d)):
            if s >= OFFSET and e <= T0 + WINDOW_S * 1e9 + 1e6:
                ops.append((name, (s - OFFSET) / (1 + DRIFT) / 1e3,
                            (e - OFFSET) / (1 + DRIFT) / 1e3))
        t = replied
    jobs = np.zeros(len(rows), dtype=JOB_DTYPE)
    for k, r in enumerate(rows):
        for f, v in zip(("enq", "pick", "h2d", "exec", "synced", "replied"),
                        r):
            jobs[k][f] = int(v)
    jobs["seq"] = np.arange(len(rows))
    return ops, jobs


def _mono(us):
    """The synthetic profiler's times on the jobs' clock (ns)."""
    return np.asarray(us, dtype=np.float64) * 1e3 * (1 + DRIFT) + OFFSET


@pytest.mark.parametrize("seed", [1, 2])
def test_idle_no_job_share_is_the_no_job_part_of_the_idle_time(
        seed, monkeypatch):
    ops, jobs = _synthetic_slice(seed)
    monkeypatch.setattr(timeline, "slice_jobs", lambda **kw: jobs)
    trace = SimpleNamespace(ops=ops, window_s=WINDOW_S, _t0=T0 / 1e9)
    got = _read("device.idle_no_job_share", {"trace": trace})
    lo, hi = T0, T0 + WINDOW_S * 1e9
    held = timeline.merged([("", max(float(a), lo), min(float(b), hi))
                            for a, b in zip(jobs["pick"], jobs["replied"])
                            if b > lo and a < hi])
    assert got == pytest.approx(
        100 * (1 - sum(b - a for a, b, _ in held) / (hi - lo)), rel=1e-9)
    # The card runs nothing while no job is held, so that time is part
    # of its idle time on the true clock.
    ops_ns = [tuple(_mono([s, e])) for _, s, e in ops]
    k = np.searchsorted(jobs["pick"], [a for a, _ in ops_ns], "right") - 1
    assert all(jobs["pick"][i] <= a and b <= jobs["replied"][i]
               for i, (a, b) in zip(k, ops_ns))
    busy = sum(e - s for s, e, _ in timeline.merged(
        [("", max(a, lo), min(b, hi)) for a, b in ops_ns
         if b > lo and a < hi]))
    assert 0 < got < 100 * (1 - busy / (hi - lo))


@pytest.mark.parametrize("lost", ["start", "middle"])
def test_idle_no_job_share_needs_the_slices_start_in_the_ring(
        lost, monkeypatch):
    ops, jobs = _synthetic_slice(1)
    if lost == "start":  # the ring has overwritten the slice's first jobs
        first = int(np.searchsorted(jobs["pick"], T0 + 1e8))
        jobs = jobs[first:]
    else:  # a read dropped a record overwritten while it was copied
        jobs = np.delete(jobs, len(jobs) // 2)
    monkeypatch.setattr(timeline, "slice_jobs", lambda **kw: jobs)
    trace = SimpleNamespace(ops=ops, window_s=WINDOW_S, _t0=T0 / 1e9)
    assert _read("device.idle_no_job_share", {"trace": trace}) is None


def test_covers_from_the_first_job_or_one_picked_by_the_start():
    jobs = np.zeros(3, dtype=JOB_DTYPE)
    jobs["seq"], jobs["pick"] = [0, 1, 2], [50, 60, 70]
    assert timeline.covers(jobs, 10.0)       # the thread's first job
    later = jobs.copy()
    later["seq"] += 7
    assert not timeline.covers(later, 10.0)  # jobs 0-6 may have run by 10
    assert timeline.covers(later, 50.0)
    assert not timeline.covers(jobs[:0], 10.0)


def test_no_job_seconds_against_a_hand_worked_slice():
    jobs = np.zeros(3, dtype=JOB_DTYPE)
    for k, (pick, replied) in enumerate([(10, 60), (70, 95), (90, 120)]):
        jobs[k]["pick"], jobs[k]["replied"] = pick, replied
    # Held [10, 60] and [70, 100] of [0, 100].
    assert timeline.no_job_seconds(jobs, 0.0, 100.0) == pytest.approx(
        20e-9)
    assert timeline.no_job_seconds(jobs[:0], 0.0, 100.0) == pytest.approx(
        100e-9)
