"""tbus_torch: the PyTorch/CUDA port of tbus's device plane.

The framework-neutral C++ core (cpp/, libtbus.so) is shared and reached
through the port's own ctypes bindings (tbus_torch._native,
tbus_torch.rpc), with its C++ load generators, per-stage timing,
tracing and ops planes (flight recorder, SLO, autotune, cache tier,
metrics sink), and the fleet drills (fleet_drill, fleet_roll,
link_redial) with the port's own fleet node (fleet_node_argv). The
device plane lives in tbus_torch.parallel and, for the C++ plane (device methods, the serving step engines, the collective
fan-out engine, the device stream sink), in the runtime of
tbus_torch/csrc/cuda_runtime.cc; its kernels, written by hand for
Hopper, in tbus_torch.kernels and tbus_torch/csrc. The graft entry
points (entry, dryrun_multichip) are in tbus_torch.entry, imported on
first use: ``import tbus_torch`` alone does not load torch, so a fleet
node starts in a fraction of a second. The port imports nothing of the
JAX package.
"""

from tbus_torch.rpc import (Channel, GrpcStub,  # noqa: F401
                            ParallelChannel, PartitionChannel, RpcError,
                            Server, Stream, advertise_device_method,
                            autotune_disable, autotune_enable,
                            autotune_last_good, autotune_stats,
                            bench_cache, bench_device_stream, bench_echo,
                            bench_echo_overload, bench_serve, bench_stream,
                            budget_breakdown, builtin_handler,
                            cache_corpus_write, cache_reshard_drill,
                            cache_stats, connections_dump, device_available,
                            device_dma_stats, device_enable_dma,
                            device_init, device_registered_regions,
                            device_stats, enable_native_fanout,
                            enable_torch_fanout, fanout_step_stats,
                            fd_loops, fd_rtc_max_bytes, fi_disable_all,
                            fi_dump, fi_injected, fi_probe, fi_set,
                            fi_set_seed, flag_domains, flag_get, flag_set,
                            fleet_drill, fleet_node_argv, fleet_node_run,
                            fleet_query, fleet_roll, flight_ring, init,
                            link_redial, metrics_flush,
                            metrics_set_collector, metrics_sink_reset,
                            metrics_stats, native_fanout_lowered_calls,
                            native_fanout_stats, pjrt_d2h_copy_bytes,
                            pjrt_h2d_copy_bytes, recorder_arm,
                            recorder_bundle_text, recorder_bundles,
                            recorder_capture, recorder_disarm,
                            recorder_stats, register_device_echo,
                            register_device_method,
                            register_native_device_echo,
                            register_native_device_method, replay,
                            rpc_dump_disable, rpc_dump_enable, rpcz_dump,
                            rpcz_dump_json, rpcz_enable, serve_stats,
                            shm_lanes, shm_links, shm_payload_copy_bytes,
                            shm_zero_copy_frames, slo_burn, slo_fleet,
                            slo_status, slo_text, stage_stats,
                            stream_sink_stats, timeline_dump,
                            torch_lowered_calls, trace_flush,
                            trace_perfetto, trace_query,
                            trace_set_collector, trace_stats, var_value,
                            wait_profile_dump, wait_profile_reset,
                            wait_profile_stats, wait_profiler_enable)


def __getattr__(name):
    if name == "entry":
        import importlib

        return importlib.import_module("tbus_torch.entry")
    raise AttributeError(f"module 'tbus_torch' has no attribute {name!r}")
