"""The port's device plane: lowered ParallelChannel fan-out on CUDA, the
collective fan-out step and ring attention over torch.distributed, and
single-host process-group bring-up."""

from tbus_torch.parallel.runtime import (  # noqa: F401
    broadcast_gather,
    broadcast_gather_batch,
    register_builtin,
    register_device_method,
)
from tbus_torch.parallel.collective import (  # noqa: F401
    default_mesh,
    gather_merge,
    make_fanout_step,
    make_ring_attention,
    partition_scatter_gather,
    reduce_scatter_merge,
    replicated_fanout_merge,
    ring_attention,
    ring_cascade,
)
from tbus_torch.parallel import distributed, params  # noqa: F401,E402
