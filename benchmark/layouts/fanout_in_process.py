"""fanout_in_process: the layout of upstream brpc's
example/parallel_echo_c++. One process holds the card, runs `servers`
tpu:// servers that advertise the configuration's methods under their
device twin's id, installs the port's C++ collective fan-out engine
(enable_native_fanout, after device_init), and runs the load generator
itself, each client on a ParallelChannel over those servers: an eligible
call runs as one execution of the fan-out kernel on the device runtime,
and its merged reply is what the reference's rule owes.

Configuration keys: service; methods {name: {"transform": <builtin of the
fan-out engine: echo, xor255, add_peer_index>}}, which each server also
answers point to point with the program's own twin of that builtin;
impl_id; servers; guarantee {name: <rule>}; dma_registration. The mix's
client_workers are this process's fiber workers."""

from __future__ import annotations

from harness import deploy, gen, guard, reference, traffic


class Layout:
    """The servers, the engine and the generator, all in this process."""

    def __init__(self, config: dict, mix: dict, seed: int, seconds: float,
                 device: str) -> None:
        import tbus_torch as tt

        self.mix, self.seconds = mix, seconds
        deploy.open_device(config, device, mix["client_workers"])
        if not tt.enable_native_fanout():
            raise RuntimeError("the collective fan-out engine did not "
                               "install")
        service, impl = config["service"], config["impl_id"]
        for method, spec in config["methods"].items():
            if not tt.register_native_device_method(
                    service, method, spec["transform"], impl):
                raise RuntimeError(f"fan-out engine: no builtin "
                                   f"{spec['transform']!r}")
            tt.advertise_device_method(service, method, impl)
        self.servers, subs = [], []
        for i in range(config["servers"]):
            server = tt.Server()
            for method, spec in config["methods"].items():
                if spec["transform"] == "echo":
                    server.add_echo(service, method)
                else:
                    server.add_method(service, method, tt.builtin_handler(
                        spec["transform"], i))
            subs.append(f"tpu://127.0.0.1:{server.start(0)}")
            self.servers.append(server)
        _, build_s = gen.build()
        payloads = traffic.payloads(mix, seed)
        expected = reference.replies(config["guarantee"][mix["method"]],
                                     payloads)
        self.loop = gen.Loop(payloads, expected, service, mix["method"],
                             mix["timeout_ms"], subs=subs)
        warm = self.loop.run(calls=mix["warmup_calls_per_client"],
                             rate=mix["rate"])
        self.ready = {"build_s": build_s, **warm.as_dict()}
        self.call_bytes = deploy.call_bytes(config, mix)
        self.stage_client: dict = {}
        self.forbidden: list = []
        self.segments: set = set()

    def counters(self) -> dict:
        """The fan-out engine's counters (lowered calls, executions of the
        kernel, divergence checks, quarantines, ...)."""
        import tbus_torch as tt

        return {"fanout": tt.native_fanout_stats()}

    def window(self) -> gen.Result:
        return self.loop.run(seconds=self.seconds, rate=self.mix["rate"])

    def close(self) -> None:
        from tbus_torch import rpc

        self.loop.close()
        for server in self.servers:
            server.stop()
        self.stage_client = rpc.stage_stats()
        self.segments = guard.own_segments()
