"""tpu.ring_to_pickup_p99_us: a frame's wait in the tpu:// ring until the
receiving side picks it up, at its 99th percentile, from the core's stage
clock on both sides (the server's for requests, the client's for
replies): the larger of the two. Recent samples only, as every
stage_stats() percentile."""

HOP = "tbus_shm_stage_ring_to_pickup"


def read(run):
    sides = [run["after"]["stage"].get(HOP), run["stage_client"].get(HOP)]
    p99 = [s["p99_ns"] / 1e3 for s in sides if s and s["count"] > 0]
    return max(p99) if p99 else None
