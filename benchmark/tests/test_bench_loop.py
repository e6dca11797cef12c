"""The copied load generator's bookkeeping at a tiny size, on the CPU: the
calls it counts, the latencies it keeps, a wrong reply and a failed call
each counted as a miss, and a paced loop's schedule, on plain channels and
on combo channels (a ParallelChannel a client, whose merged reply is
compared whole). Each case runs in a child process (one core per
process)."""

import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

_CHILD = r"""
import sys
sys.path[:0] = [%(bench)r, %(root)r]
import numpy as np
import tbus_torch as tt
from harness import gen, reference

tt.init()
server = tt.Server()
server.add_echo("LgSvc", "Echo")
payloads = (np.arange(2 * 3 * 64) %% 251).astype(np.uint8).reshape(2, 3, 64)
addr = f"127.0.0.1:{server.start(0)}"

loop = gen.Loop(payloads, reference.replies("echo", payloads), "LgSvc",
                "Echo", 2000, addr=addr)
r = loop.run(calls=5)
assert (r.attempted, r.ok, r.failed, r.wrong) == (10, 10, 0, 0), r.as_dict()
assert (r.latencies_ns > 0).all() and r.t_end_ns > r.t_start_ns
assert r.compared == 10
timed = loop.run(seconds=0.3)
assert timed.attempted > 0 and timed.ok == timed.attempted
assert (timed.t_end_ns - timed.t_start_ns) / 1e9 >= 0.3
paced = loop.run(seconds=0.5, rate=100)
assert 40 <= paced.attempted <= 51, paced.attempted
loop.close()

wrong = gen.Loop(payloads, reference.replies("xor255", payloads), "LgSvc",
                 "Echo", 2000, addr=addr)
r = wrong.run(calls=2)
assert (r.attempted, r.ok, r.wrong, r.failed) == (4, 0, 4, 0), r.as_dict()
assert (r.latencies_ns == -1).all() and r.compared == 4
wrong.close()

failing = gen.Loop(payloads, reference.replies("echo", payloads), "LgSvc",
                   "NoSuchMethod", 2000, addr=addr)
r = failing.run(calls=2)
assert (r.attempted, r.ok, r.failed) == (4, 0, 4), r.as_dict()
assert r.first_error != 0 and r.compared == 0
failing.close()

# Combo channels over 8 echo servers: the merged reply is 8 echoes in
# sub-channel order; over 4 of them it is short, so every call is wrong.
fleet = [tt.Server() for _ in range(8)]
subs = []
for s in fleet:
    s.add_echo("LgSvc", "Echo")
    subs.append(f"127.0.0.1:{s.start(0)}")
merged = reference.replies("echo_fanout8", payloads)
assert merged.shape == (2, 3, 8 * 64)
combo = gen.Loop(payloads, merged, "LgSvc", "Echo", 2000, subs=subs)
r = combo.run(calls=4)
assert (r.attempted, r.ok, r.failed, r.wrong) == (8, 8, 0, 0), r.as_dict()
assert (r.latencies_ns > 0).all() and r.compared == 8
timed = combo.run(seconds=0.3)
assert timed.attempted > 0 and timed.ok == timed.attempted
combo.close()
short = gen.Loop(payloads, merged, "LgSvc", "Echo", 2000, subs=subs[:4])
r = short.run(calls=2)
assert (r.attempted, r.ok, r.wrong, r.failed) == (4, 0, 4, 0), r.as_dict()
short.close()
for bad in ({}, {"addr": addr, "subs": subs}):
    try:
        gen.Loop(payloads, merged, "LgSvc", "Echo", 2000, **bad)
        raise AssertionError(bad)
    except ValueError:
        pass
for s in fleet:
    s.stop()
server.stop()
print("LOOP-OK")
"""


def test_loop_bookkeeping():
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD % {"bench": BENCH, "root": ROOT}],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0 and "LOOP-OK" in proc.stdout, (
        proc.stdout[-2000:], proc.stderr[-4000:])
