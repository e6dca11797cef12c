"""What every layout (benchmark/layouts/) does the same way: open the
device runtime as the configuration asks, and count the bytes of one
right call."""

from __future__ import annotations

from harness import reference


def open_device(config: dict, device: str, workers: int = 0) -> None:
    """DMA registration where the configuration asks for it (before the
    core's block pool comes up), the core on `workers` fiber workers (0:
    its default), then the device runtime on `device`."""
    import tbus_torch as tt

    if config.get("dma_registration"):
        tt.device_enable_dma()
    tt.init(workers)
    tt.device_init(device)


def call_bytes(config: dict, mix: dict) -> int:
    """The request and the reply of one right call: the mix's payload and
    the reply the reference's rule owes it."""
    n = mix["payload_bytes"]
    return n + reference.reply_bytes(config["guarantee"][mix["method"]], n)
