"""The yardstick's table of peaks and the bytes each kernel's work needs.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet (dense, at the full
700 W power limit): 80 GB of HBM3 at 3.35 TB/s. The byte counts count each
input byte read once and each output byte written once, whatever the
kernel reads again or pads, as PERF.md §6's bound column does.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def u8_transform_bytes(payload: int) -> int:
    """K4 (tbus_u8_transform: echo, xor255, incr): the payload read once
    and its transform written once."""
    return 2 * payload


def roofline_share(bytes_moved: int, seconds: float) -> float:
    """The least time the card could take to move the bytes at its peak,
    as a % of the time the kernel took."""
    return bytes_moved / HBM_BYTES_PER_S / seconds * 100.0
