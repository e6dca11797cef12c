"""tbus_torch: the PyTorch/CUDA port of tbus's device plane.

The framework-neutral C++ core (cpp/, libtbus.so) is shared and reached
through the port's own ctypes bindings (tbus_torch._native,
tbus_torch.rpc), with its C++ load generators, per-stage timing and
tracing. The device plane lives in tbus_torch.parallel and, for
the C++ plane (device methods, the serving step engines, the collective
fan-out engine, the device stream sink), in the runtime of
tbus_torch/csrc/cuda_runtime.cc; its kernels, written by hand for
Hopper, in tbus_torch.kernels and tbus_torch/csrc. The graft entry points (entry, dryrun_multichip)
are in tbus_torch.entry. The port imports nothing of the JAX package.
"""

from tbus_torch.rpc import (Channel, ParallelChannel,  # noqa: F401
                            PartitionChannel, RpcError, Server, Stream,
                            advertise_device_method, bench_device_stream,
                            bench_echo, bench_echo_overload, bench_serve,
                            bench_stream, budget_breakdown, builtin_handler,
                            connections_dump, device_available,
                            device_dma_stats, device_enable_dma,
                            device_init, device_stats, enable_native_fanout,
                            enable_torch_fanout, fanout_step_stats,
                            fd_loops, fd_rtc_max_bytes, fi_disable_all,
                            fi_dump, fi_injected, fi_probe, fi_set,
                            fi_set_seed, flag_domains, flag_get, flag_set,
                            init, native_fanout_lowered_calls,
                            native_fanout_stats, register_device_echo,
                            register_device_method,
                            register_native_device_echo,
                            register_native_device_method, rpcz_dump,
                            rpcz_dump_json, rpcz_enable, serve_stats,
                            shm_lanes, shm_payload_copy_bytes,
                            shm_zero_copy_frames, stage_stats,
                            stream_sink_stats, timeline_dump,
                            torch_lowered_calls, trace_flush,
                            trace_perfetto, trace_query,
                            trace_set_collector, trace_stats, var_value)
from tbus_torch import entry  # noqa: F401,E402
