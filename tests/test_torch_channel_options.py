"""The port's Channel with the reference's options (tbus_torch.rpc:
protocol, connection, compress, lb) and GrpcStub, against port echo
servers in this process: every reply byte-equal to its request, payloads
from one numpy seed. Cluster mode runs over a list:// of two port
servers, and each of them takes calls (its own /status counts them).
"""

import urllib.request

import numpy as np
import pytest

import tbus_torch as tt

_RNG = np.random.default_rng(0)
PAYLOADS = [b"", b"x", _RNG.integers(0, 256, 4096, np.uint8).tobytes(),
            _RNG.integers(0, 256, 1 << 20, np.uint8).tobytes()]


def _served(port: int, method: str) -> int:
    """Calls a port server has served of `method` (its /status line)."""
    status = urllib.request.urlopen(
        f"http://127.0.0.1:{port}/status", timeout=10).read().decode()
    line = [x for x in status.splitlines()
            if x.strip().startswith(method + " ")][0]
    return int(line.split("count=")[1].split()[0])


@pytest.fixture(scope="module")
def ports():
    """Two port servers, each with the echo and the cache tier."""
    tt.init()
    servers = []
    for _ in range(2):
        s = tt.Server()
        s.add_echo()
        s.add_cache()
        s.start(0)
        servers.append(s)
    yield [s.port for s in servers]
    for s in servers:
        s.stop()


def _echo_all(ch):
    for body in PAYLOADS:
        assert ch.call("EchoService", "Echo", body) == body, len(body)


@pytest.mark.parametrize("protocol", ["", "http", "h2", "grpc"])
def test_protocol(ports, protocol):
    _echo_all(tt.Channel(f"127.0.0.1:{ports[0]}", timeout_ms=10000,
                         protocol=protocol))


@pytest.mark.parametrize("connection", ["single", "pooled", "short"])
def test_connection(ports, connection):
    _echo_all(tt.Channel(f"127.0.0.1:{ports[0]}", timeout_ms=10000,
                         connection=connection))


@pytest.mark.parametrize("compress", [0, 1, 2])
def test_compress(ports, compress):
    _echo_all(tt.Channel(f"127.0.0.1:{ports[0]}", timeout_ms=10000,
                         compress=compress))


def test_lb_rr_spreads_over_both_servers(ports):
    before = [_served(p, "EchoService.Echo") for p in ports]
    ch = tt.Channel("list://" + ",".join(f"127.0.0.1:{p}" for p in ports),
                    timeout_ms=10000, lb="rr")
    for _ in range(8):
        _echo_all(ch)
    after = [_served(p, "EchoService.Echo") for p in ports]
    assert all(a - b >= 8 for a, b in zip(after, before)), (before, after)


def test_lb_c_hash_shards_keys_over_both_servers(ports):
    before = [_served(p, "Cache.Set") for p in ports]
    ch = tt.Channel("list://" + ",".join(f"127.0.0.1:{p}" for p in ports),
                    timeout_ms=10000, lb="c_hash")
    values = {f"k{i}": PAYLOADS[2][i:] for i in range(64)}
    for key, value in values.items():
        ch.cache_set(key, value)
    for key, value in values.items():
        assert ch.cache_get(key) == value, key
    after = [_served(p, "Cache.Set") for p in ports]
    assert all(a > b for a, b in zip(after, before)), (before, after)
    assert sum(after) - sum(before) == len(values)
    for key in values:
        assert ch.cache_del(key) is True


def test_grpc_stub_with_serializers(ports):
    stub = tt.GrpcStub(f"127.0.0.1:{ports[0]}")
    raw = stub.unary_unary("/EchoService/Echo")
    for body in PAYLOADS:
        assert raw(body) == body
    typed = stub.unary_unary("/EchoService/Echo",
                             request_serializer=str.encode,
                             response_deserializer=bytes.decode)
    assert typed("typed message", timeout=5) == "typed message"
