"""The device runtime's job timeline (tbus_torch/csrc/cuda_runtime.cc), on
the CPU backend: per-job stamps on the core's clock, the record ring read
by rpc.device_jobs, and the window-wide hop histograms of
rpc.device_stats()["stages"].

Held here:
- N device-method calls give N records and N counts in every hop
  histogram, the rise of executions + errors;
- every record's stamps come in order (enq <= pick <= h2d <= exec <=
  synced <= replied);
- a record carries its call's rpcz server span ids with rpcz on, and 0s
  with it off;
- the ring wraps past its capacity without blocking and keeps the newest
  records;
- a jammed queue counts its refusals as overcrowded and adds no record;
- a percentile read from the histograms' buckets lies within 5% of the
  exact percentile of the same jobs' stamps, on a known spread of
  durations.

The runtime is one per process, so one child brings it up, drives every
case and writes what it saw; the tests read that.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import ctypes, json, os, sys, threading, time
sys.path.insert(0, %(root)r)
import numpy as np
import tbus_torch as tt
from tbus_torch import rpc

STAMPS = %(stamps)r
out = {}
tt.init()
out["stages_before_init"] = rpc.device_stats()["stages"]
try:
    rpc.device_jobs()
    out["jobs_before_init"] = "answered"
except RuntimeError as e:
    out["jobs_before_init"] = str(e)
tt.device_init("cpu")
B = rpc._device_bridge()
server = tt.Server()
server.add_device_method("Dev", "Xor", "xor255")
ch = tt.Channel(f"127.0.0.1:{server.start(0)}", timeout_ms=30000)
arrays = {}

def reading():
    # A job's record lands just after its callback returns, so its caller
    # can read the counters a moment before it: wait for it.
    deadline = time.monotonic() + 10
    while True:
        st = rpc.device_stats()
        ran = st["executions"] + st["errors"] - st["overcrowded"]
        if st["stages"]["jobs"] == ran or time.monotonic() > deadline:
            break
        time.sleep(0.001)
    return {"executions": st["executions"], "errors": st["errors"],
            "overcrowded": st["overcrowded"], "stages": st["stages"]}

def calls(tag, n):
    before = reading()
    for i in range(n):
        p = bytes((i + j) %% 256 for j in range(3000))
        assert ch.call("Dev", "Xor", p) == bytes(b ^ 0xFF for b in p)
    after = reading()
    jobs = rpc.device_jobs(before_ns[tag], 2**63 - 1)
    out[tag] = {"before": before, "after": after}
    arrays[tag] = jobs

before_ns = {"off": time.monotonic_ns()}
calls("off", 40)
rpc.rpcz_enable(True)
before_ns["on"] = time.monotonic_ns()
calls("on", 20)
out["spans"] = [s for s in rpc.rpcz_dump_json()
                if s.get("service") == "Dev"]
rpc.rpcz_enable(False)

# A known spread of durations: each execution sleeps a set time.
delays_us = [int(100 * 2 ** (k / 10)) for k in range(80)]  # 100 us..25 ms
before = reading()
t0 = time.monotonic_ns()
data = bytes(256)
buf = ctypes.create_string_buffer(256)
got = ctypes.c_longlong(0)
for d in delays_us:
    os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = str(d)
    assert B.tbus_torch_device_run_mode(b"echo", data, 256, 1, 1, buf, 256,
                                        30000, ctypes.byref(got)) == 0
os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "0"
out["spread"] = {"before": before, "after": reading(), "delays_us": delays_us}
arrays["spread"] = rpc.device_jobs(t0, 2**63 - 1)

# A jammed queue: one job runs for 20 ms, 128 wait, the rest bounce.
os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "20000"
before = reading()
n = 200
rcs = (ctypes.c_int * n)()
assert B.tbus_torch_device_burst(b"echo", 256, n, rcs) == 0
os.environ["TBUS_TORCH_DEVICE_DELAY_US"] = "0"
out["jam"] = {"before": before, "after": reading(), "rcs": list(rcs)}

# Past the ring's capacity, in bursts under the queue bound, while two
# threads read the ring over and over: every read is whole (consecutive
# records, stamps in order) and the writer never waits for them.
before = reading()
cap = before["stages"]["ring_capacity"]
total = cap + 777 - before["stages"]["jobs"]
done = threading.Event()
reads = []

def reader():
    while not done.is_set():
        jobs = rpc.device_jobs()
        ok = bool((np.diff(jobs["seq"]) == 1).all())
        for a, b in zip(STAMPS, STAMPS[1:]):
            ok = ok and bool((jobs[a] <= jobs[b]).all())
        reads.append((len(jobs), ok))

readers = [threading.Thread(target=reader) for _ in range(2)]
for t in readers:
    t.start()
rcs = (ctypes.c_int * 100)()
left = total
try:
    while left > 0:
        k = min(100, left)
        assert B.tbus_torch_device_burst(b"echo", 128, k, rcs) == 0
        assert list(rcs)[:k] == [0] * k
        left -= k
finally:
    done.set()
    for t in readers:
        t.join(60)
assert not any(t.is_alive() for t in readers)
out["wrap"] = {"before": before, "after": reading(), "submitted": total,
               "reads": reads}
arrays["wrap"] = rpc.device_jobs()
server.stop()
np.savez(sys.argv[1] + ".npz", **arrays)
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(out, f)
leaked = sorted(m for m in sys.modules
                if m in ("jax", "tbus") or m.startswith(("jax.", "tbus.")))
assert not leaked, leaked
print("CHILD-OK", flush=True)
"""

HOPS = ("queue", "host_prep", "device", "reply", "job")
STAMPS = ("enq", "pick", "h2d", "exec", "synced", "replied")
HOP_OF = {"queue": ("enq", "pick"), "host_prep": ("pick", "h2d"),
          "device": ("h2d", "synced"), "reply": ("synced", "replied"),
          "job": ("enq", "replied")}


@pytest.fixture(scope="module")
def seen(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("timeline") / "seen")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD % {"root": ROOT, "stamps": STAMPS},
         base], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0 and "CHILD-OK" in proc.stdout, (
        proc.returncode, proc.stdout[-2000:], proc.stderr[-4000:])
    with open(base + ".json") as f:
        out = json.load(f)
    out["arrays"] = dict(np.load(base + ".npz"))
    return out


def _delta(before: dict, after: dict, hop: str) -> dict:
    """The hop's bucket counts between two readings."""
    was = dict(map(tuple, before["stages"]["hops"][hop]["buckets"]))
    return {b: n - was.get(b, 0)
            for b, n in after["stages"]["hops"][hop]["buckets"]
            if n - was.get(b, 0) > 0}


def _bucket_percentile(delta: dict, lo: list, q: float) -> float:
    """The nearest-rank q-th percentile of the bucket counts: the middle
    of the bucket that holds it."""
    total = sum(delta.values())
    rank = max(1, math.ceil(q / 100 * total))
    seen = 0
    for b in sorted(delta):
        seen += delta[b]
        if seen >= rank:
            return (lo[b] + lo[b + 1]) / 2 if b + 1 < len(lo) else lo[b]
    raise AssertionError("rank past the counts")


def _exact_percentile(values: np.ndarray, q: float) -> float:
    ordered = np.sort(values)
    return float(ordered[max(1, math.ceil(q / 100 * len(ordered))) - 1])


def _rise(case: dict, key: str) -> int:
    return case["after"][key] - case["before"][key]


def test_stages_and_jobs_without_the_runtime(seen):
    assert seen["stages_before_init"] is None
    assert "not up" in seen["jobs_before_init"]


@pytest.mark.parametrize("hop", HOPS)
def test_every_call_gives_one_record_and_one_count_a_hop(seen, hop):
    for tag, n in (("off", 40), ("on", 20)):
        case = seen[tag]
        done = _rise(case, "executions") + _rise(case, "errors")
        assert done == n
        assert len(seen["arrays"][tag]) == n
        assert sum(_delta(case["before"], case["after"], hop).values()) == n
        st_b, st_a = case["before"]["stages"], case["after"]["stages"]
        assert st_a["hops"][hop]["count"] - st_b["hops"][hop]["count"] == n
        assert st_a["jobs"] - st_b["jobs"] == n


@pytest.mark.parametrize("tag", ["off", "on", "spread", "wrap"])
def test_stamps_come_in_order(seen, tag):
    jobs = seen["arrays"][tag]
    assert len(jobs)
    for a, b in zip(STAMPS, STAMPS[1:]):
        assert (jobs[a] <= jobs[b]).all(), (a, b)
    assert (jobs["enq"] > 0).all()
    assert (jobs["rc"] == 0).all()
    assert (np.diff(jobs["seq"]) == 1).all()


@pytest.mark.parametrize("rpcz", ["off", "on"])
def test_span_ids_follow_rpcz(seen, rpcz):
    jobs = seen["arrays"][rpcz]
    if rpcz == "on":
        assert (jobs["trace_id"] != 0).all() and (jobs["span_id"] != 0).all()
    else:
        assert (jobs["trace_id"] == 0).all() and (jobs["span_id"] == 0).all()


def test_span_ids_join_the_server_spans(seen):
    jobs = seen["arrays"]["on"]
    server = {(int(s["trace_id"], 16), int(s["span_id"], 16))
              for s in seen["spans"] if s["side"] == "server"}
    assert len(server) >= len(jobs) == 20
    assert {(int(t), int(s)) for t, s in zip(jobs["trace_id"],
                                              jobs["span_id"])} <= server


def test_ring_wraps_and_keeps_the_newest(seen):
    case, jobs = seen["wrap"], seen["arrays"]["wrap"]
    cap = case["after"]["stages"]["ring_capacity"]
    assert cap >= 65536
    written = case["after"]["stages"]["jobs"]
    assert written - case["before"]["stages"]["jobs"] == case["submitted"]
    assert written > cap and len(jobs) == cap
    assert jobs["seq"][0] == written - cap and jobs["seq"][-1] == written - 1
    assert _rise(case, "executions") == case["submitted"]


def test_ring_reads_beside_the_writer_are_whole(seen):
    reads = seen["wrap"]["reads"]
    assert len(reads) >= 2
    assert all(ok for _, ok in reads)
    cap = seen["wrap"]["after"]["stages"]["ring_capacity"]
    assert all(0 < n <= cap for n, _ in reads)


def test_jammed_queue_counts_overcrowded_and_adds_no_record(seen):
    case = seen["jam"]
    over = case["rcs"].count(1011)  # EOVERCROWDED
    ran = case["rcs"].count(0)
    assert over >= 1 and over + ran == len(case["rcs"])
    assert _rise(case, "overcrowded") == over
    added = case["after"]["stages"]["jobs"] - case["before"]["stages"]["jobs"]
    assert added == ran == _rise(case, "executions")
    for hop in HOPS:
        assert sum(_delta(case["before"], case["after"], hop).values()) == ran
    # The jobs that waited found the queue up to its bound.
    depth = dict(map(tuple, case["after"]["stages"]["depth"]))
    assert max(depth) == 127


@pytest.mark.parametrize("q", [10, 50, 90, 99])
@pytest.mark.parametrize("hop", ["device", "job", "host_prep"])
def test_bucket_percentiles_lie_within_5pct_of_exact(seen, hop, q):
    case, jobs = seen["spread"], seen["arrays"]["spread"]
    assert len(jobs) == len(case["delays_us"])
    lo = case["after"]["stages"]["bucket_lo_ns"]
    start, end = HOP_OF[hop]
    exact = _exact_percentile(jobs[end] - jobs[start], q)
    got = _bucket_percentile(_delta(case["before"], case["after"], hop), lo,
                             q)
    assert abs(got - exact) <= 0.05 * exact, (got, exact)
    if hop == "device":  # the spread is the executions' own sleep
        want = _exact_percentile(np.array(case["delays_us"]) * 1e3, q)
        assert want <= exact < want + 5e6


def test_buckets_cover_64ns_to_a_minute_at_16_an_octave(seen):
    lo = seen["spread"]["after"]["stages"]["bucket_lo_ns"]
    assert lo[0] == 0 and lo[1] == 64 and lo[-1] >= 60e9
    assert all(b > a for a, b in zip(lo, lo[1:]))
    widths = [(b - a) / a for a, b in zip(lo[1:-1], lo[2:])]
    assert max(widths) <= 1 / 16 + 1e-12


def test_busy_time_and_slow_jobs(seen):
    case, jobs = seen["spread"], seen["arrays"]["spread"]
    st_b, st_a = case["before"]["stages"], case["after"]["stages"]
    busy = st_a["busy_ns"] - st_b["busy_ns"]
    assert busy == int((jobs["replied"] - jobs["pick"]).sum())
    # Each job over 5 ms counts once, under the hop that took most of it;
    # here most spent it in their execution's sleep.
    over = st_a["slow_jobs"]["over_ns"]
    assert over == 5_000_000
    hops = np.stack([jobs[b] - jobs[a] for a, b in
                     (HOP_OF[h] for h in HOPS[:4])])
    slow = (jobs["replied"] - jobs["enq"]) > over
    largest = np.argmax(hops[:, slow], axis=0)
    for k, hop in enumerate(HOPS[:4]):
        rise = st_a["slow_jobs"][hop] - st_b["slow_jobs"][hop]
        assert rise == int((largest == k).sum()), hop
    assert st_a["slow_jobs"]["device"] - st_b["slow_jobs"]["device"] >= 15

