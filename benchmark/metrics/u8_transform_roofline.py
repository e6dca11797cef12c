"""u8_transform_roofline: K4 (tbus_u8_transform, u8_transform_kernel) at
its mean time a launch in the traced slice, as a % of the time the card's
HBM peak needs for the bytes a call's transform must move (the payload
read once, its transform written once)."""

from harness.roofline import roofline_share, u8_transform_bytes
from harness.trace import kernel_mean_s


def read(run):
    trace = run["trace"]
    mean_s, n = kernel_mean_s(trace.ops, "u8_transform_kernel")
    if n == 0 or mean_s <= 0:
        return None
    return roofline_share(u8_transform_bytes(run["traffic"]["payload_bytes"]),
                          mean_s)
