"""The port's device plane: lowered ParallelChannel fan-out on CUDA."""

from tbus_torch.parallel.runtime import (  # noqa: F401
    broadcast_gather,
    broadcast_gather_batch,
    register_builtin,
    register_device_method,
)
