"""The yardstick's arithmetic against hand-worked answers: percentiles and
goodput with misses, goodput from the bytes a layout counts for one right
call, the kernels' byte counts and roofline shares, every rule of the
plain reference, and the trace's reduction to busy time and breakdown."""

from types import SimpleNamespace

import numpy as np
import pytest

from harness import deploy, reference, roofline, stats, trace


def test_misses_count_as_the_deadline():
    lat = np.array([1000, -1, 3000, 2000], dtype=np.int64)  # ns
    assert stats.rtt_us(lat, 5000).tolist() == [1.0, 5e6, 3.0, 2.0]


def test_nearest_rank_percentiles():
    v = np.arange(1, 101, dtype=np.float64)  # 1..100
    assert stats.percentile(v, 50) == 50
    assert stats.percentile(v, 99) == 99
    assert stats.percentile(v[::-1], 99) == 99
    assert stats.percentile(np.array([7.0]), 99) == 7
    # Two misses in 100 calls: the 99th percentile is a miss.
    lat = np.concatenate([np.full(98, 1000), [-1, -1]]).astype(np.int64)
    assert stats.percentile(stats.rtt_us(lat, 5000), 99) == 5e6
    assert stats.percentile(stats.rtt_us(lat, 5000), 50) == 1.0
    with pytest.raises(ValueError):
        stats.percentile(np.array([]), 50)


def test_goodput_counts_request_and_reply_of_right_calls():
    # 1,000 right calls of 1 MiB out and 1 MiB back in 2 s.
    assert stats.goodput_gbps(1000, 2 << 20, 2.0) == pytest.approx(
        1000 * 2097152 / 2 / 1e9)


def test_kernel_byte_counts():
    mib = 1 << 20
    assert roofline.u8_transform_bytes(mib) == 2 * mib
    # 2 MiB at 3.35 TB/s is 0.626 us: a 1.252 us launch is at 50%.
    t = 2 * mib / 3.35e12
    assert roofline.roofline_share(2 * mib, 2 * t) == pytest.approx(50.0)


@pytest.mark.parametrize("rule", reference.known())
def test_rule_against_its_hand_worked_answers(rule):
    examples = reference.module(rule).EXAMPLES
    assert examples
    for request, owed in examples:
        req = np.array(request, dtype=np.uint8)
        got = reference.reply(rule, req)
        assert got.dtype == np.uint8 and got.tolist() == owed, request
        assert req.tolist() == request  # the request is left alone
        assert reference.reply_bytes(rule, len(request)) == len(owed)


def test_the_rules_hand_worked_answers():
    """The three rules' files hold these answers, among others."""
    req = [0, 1, 254, 255]
    for rule, owed in (("echo", req), ("xor255", [255, 254, 1, 0]),
                       ("echo_fanout8", req * 8)):
        assert (req, owed) in reference.module(rule).EXAMPLES, rule


def test_a_reply_longer_than_its_request():
    block = np.arange(12, dtype=np.uint8).reshape(2, 3, 2)
    out = reference.replies("echo_fanout8", block)
    assert out.shape == (2, 3, 16)
    assert out[1, 2].tolist() == [10, 11] * 8
    assert reference.reply_bytes("echo_fanout8", 1 << 20) == 8 << 20


def test_replies_of_a_block():
    block = np.arange(12, dtype=np.uint8).reshape(2, 3, 2)
    out = reference.replies("xor255", block)
    assert out.shape == (2, 3, 2)
    assert out[1, 2].tolist() == [245, 244]


def test_an_unknown_rule_names_the_known_ones():
    with pytest.raises(ValueError, match="incr") as err:
        reference.reply("incr", np.zeros(4, dtype=np.uint8))
    assert ", ".join(reference.known()) in str(err.value)


@pytest.mark.parametrize("rule,call_bytes,goodput", [
    # 1 MiB out, 1 MiB back: 1,000 right calls in 2 s are 1.048576 GB/s.
    ("xor255", 2 << 20, 1.048576),
    # 1 MiB out, 8 merged MiB back: 4.718592 GB/s.
    ("echo_fanout8", 9 << 20, 4.718592),
])
def test_goodput_from_the_bytes_a_right_call_carries(rule, call_bytes,
                                                      goodput):
    from harness.cell import _end_to_end

    config = {"guarantee": {"M": rule}}
    mix = {"method": "M", "payload_bytes": 1 << 20}
    assert deploy.call_bytes(config, mix) == call_bytes
    cell = SimpleNamespace(end_to_end=[{"name": "goodput_GBps",
                                        "unit": "GB/s"}])
    # 1,003 calls in a 2 s window, 3 of them misses.
    lat = np.array([1000] * 1000 + [-1] * 3, dtype=np.int64)
    ok = int((lat >= 0).sum())
    got = _end_to_end(cell, ok, stats.rtt_us(lat, 5000),
                      deploy.call_bytes(config, mix), 2.0, 1.0)
    assert got == {"goodput_GBps": {"value": pytest.approx(goodput),
                                    "unit": "GB/s"}}


def test_busy_time_counts_overlaps_once():
    ops = [("k", 0.0, 10.0), ("h2d", 5.0, 20.0), ("d2h", 30.0, 40.0)]
    assert trace.busy_s(ops) == pytest.approx(30e-6)
    assert trace.merged(ops) == [(0.0, 20.0, "k"), (30.0, 40.0, "d2h")]


def test_breakdown_names_gaps_by_what_ended_them():
    ops = [("Memcpy HtoD", 0.0, 10.0), ("u8_transform_kernel<1>", 10.0,
                                          12.0),
           ("Memcpy DtoH", 20.0, 30.0), ("Memcpy HtoD", 100.0, 110.0)]
    b = trace.breakdown(ops)
    assert b["device_ops"][0] == ["Memcpy HtoD", pytest.approx(20e-6)]
    assert b["idle_gaps"] == [["idle before Memcpy HtoD",
                               pytest.approx(70e-6)],
                              ["idle before Memcpy DtoH",
                               pytest.approx(8e-6)]]


def test_kernel_mean_matches_whole_names_only():
    ops = [("void u8_transform_kernel<1>(uint4 const*)", 0.0, 2.0),
           ("void u8_transform_kernel<0>(uint4 const*)", 5.0, 9.0),
           ("u8_transform_v1_kernel", 10.0, 30.0),
           ("dot128_kernel", 40.0, 44.0)]
    assert trace.kernel_mean_s(ops, "u8_transform_kernel") == (
        pytest.approx(3e-6), 2)
    assert trace.kernel_mean_s(ops, "dot128_kernel") == (
        pytest.approx(4e-6), 1)
    assert trace.kernel_mean_s(ops, "fanout_kernel") == (0.0, 0)


def test_leak_check_reports_only_segments_this_run_mapped(monkeypatch):
    from harness import guard

    monkeypatch.setattr(guard, "shm_segments", lambda: {
        "tbus_nfy_a", "tbus_pool_a_0", "tbus_nfy_other", "tbus_nfy_self"})
    monkeypatch.setattr(guard, "own_segments", lambda: {"tbus_nfy_self"})
    mapped = {"tbus_nfy_a", "tbus_pool_a_0", "tbus_nfy_gone",
              "tbus_nfy_self"}
    # Another process's segment (other) is never reported; one that is gone,
    # or that this process still maps, is not left behind.
    assert guard.leaked_segments(mapped) == ["tbus_nfy_a", "tbus_pool_a_0"]
