"""client_server: this process holds the card and serves the
configuration's device methods (Server.add_device_method) over tpu://; a
client process (benchmark/harness/client.py) runs the load generator
against it, each client on a channel of its own, and computes the answers
the reference owes.

Configuration keys: service; methods {name: {"transform": <device
transform>}}; guarantee {name: <rule>}; dma_registration."""

from __future__ import annotations

import base64
import json
import os
import subprocess
import sys

import numpy as np

from harness import deploy, gen, guard
from harness.spec import BENCH_DIR, ROOT

CLIENT = os.path.join(BENCH_DIR, "harness", "client.py")


class Layout:
    """The configuration's server here, the generator in a client
    process."""

    def __init__(self, config: dict, mix: dict, seed: int, seconds: float,
                 device: str) -> None:
        import tbus_torch as tt

        deploy.open_device(config, device)
        self.server = tt.Server()
        for method, spec in config["methods"].items():
            self.server.add_device_method(config["service"], method,
                                          spec["transform"])
        port = self.server.start(0)
        self.proc = subprocess.Popen(
            [sys.executable, CLIENT], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True, cwd=ROOT)
        self._send(json.dumps({
            "addr": f"tpu://127.0.0.1:{port}", "service": config["service"],
            "traffic": mix, "seed": seed, "seconds": seconds,
            "rule": config["guarantee"][mix["method"]]}))
        self.ready = self._read("ready")["ready"]
        self.call_bytes = deploy.call_bytes(config, mix)
        self.stage_client: dict = {}
        self.forbidden: list = []
        self.segments: set = set()

    def _send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def _read(self, key: str) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the client process ended before {key!r} "
                               f"(exit {self.proc.wait()})")
        return json.loads(line)

    def counters(self) -> dict:
        return {}

    def window(self) -> gen.Result:
        self._send("go")
        out = self._read("window")
        w = out["window"]
        self.stage_client = out["stage_stats"]
        self.forbidden = out["forbidden"]
        self.segments = set(out["segments"]) | guard.own_segments()
        lat = np.frombuffer(base64.b64decode(out["latencies"]),
                            dtype=np.int64)
        return gen.Result(lat, w["failed"], w["wrong"], w["first_error"],
                          w["t_start_ns"], w["t_end_ns"])

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.stdin.close()
            try:
                self.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.server.stop()
