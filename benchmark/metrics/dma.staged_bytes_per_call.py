"""dma.staged_bytes_per_call: bytes that crossed a staging copy on their
way to or from the card, per completed call, over the window: the rise of
device_dma_stats()'s h2d_copy_bytes and d2h_copy_bytes tripwires. 0 where
every call's bytes went straight through registered blocks."""

KEYS = ("h2d_copy_bytes", "d2h_copy_bytes")


def read(run):
    done = run["calls"]["completed"]
    if done <= 0:
        return None
    staged = sum(run["after"]["dma"][k] - run["before"]["dma"][k]
                 for k in KEYS)
    return staged / done
