"""server.dispatch_to_done_p50_us: the server's handler hop, dispatch to
done, at its median, from the core's stage clock (stage_stats() of the
process that serves). Its percentiles cover the recorder's recent samples,
the window's last calls, not the whole window."""


def read(run):
    st = run["after"]["stage"].get("tbus_shm_stage_dispatch_to_done")
    before = run["before"]["stage"].get("tbus_shm_stage_dispatch_to_done",
                                        {"count": 0})
    if not st or st["count"] <= before["count"]:
        return None
    return st["p50_ns"] / 1e3
