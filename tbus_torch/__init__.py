"""tbus_torch: the PyTorch/CUDA port of tbus's device plane.

The framework-neutral C++ core (cpp/, libtbus.so) is shared and reached
through the port's own ctypes bindings (tbus_torch._native,
tbus_torch.rpc). The device plane lives in tbus_torch.parallel and, for
the C++ plane (device methods, the serving step engines, the collective
fan-out engine, the device stream sink), in the runtime of
tbus_torch/csrc/cuda_runtime.cc; its kernels, written by hand for
Hopper, in tbus_torch.kernels and tbus_torch/csrc. The graft entry points (entry, dryrun_multichip)
are in tbus_torch.entry. The port imports nothing of the JAX package.
"""

from tbus_torch.rpc import (Channel, ParallelChannel,  # noqa: F401
                            PartitionChannel, RpcError, Server, Stream,
                            advertise_device_method, bench_device_stream,
                            bench_serve, builtin_handler, device_available,
                            device_dma_stats, device_enable_dma,
                            device_init, device_stats, enable_native_fanout,
                            enable_torch_fanout, fanout_step_stats,
                            fi_disable_all, fi_set, flag_set, init,
                            native_fanout_lowered_calls, native_fanout_stats,
                            register_device_echo, register_device_method,
                            register_native_device_echo,
                            register_native_device_method, serve_stats,
                            stream_sink_stats, torch_lowered_calls,
                            var_value)
from tbus_torch import entry  # noqa: F401,E402
