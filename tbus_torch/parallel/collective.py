"""Collective lowering of combo-channel fan-out, on torch.distributed.

The port of tbus/parallel/collective.py. The reference runs each function
inside shard_map over a named mesh axis; the port is SPMD in the same
sense, but per process: every rank of a torch.distributed job calls the
same function on its own shard, and each primitive takes the process
group of a mesh axis where the reference takes the axis name.

  ParallelChannel broadcast+merge  -> all_gather / all_reduce
  PartitionChannel scatter/gather  -> all_to_all / reduce_scatter
  cascade pipeline                 -> batch_isend_irecv ring

Like the reference, every primitive returns a new tensor and leaves its
input as it is. :func:`make_fanout_step` and :func:`ring_attention` are
the device programs of the graft entry's path; their compute runs through
the kernels K1, K2 (tbus_torch.kernels.gemm), K8a, K8b, K9
(tbus_torch.kernels.loss_update) and K3 (tbus_torch.kernels.ring_fold).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from tbus_torch.kernels.gemm import BF16Matmul
from tbus_torch.kernels.loss_update import SumSquares, sgd_update
from tbus_torch.kernels.ring_fold import fold_

# (k, v) rotations made by ring_attention in this process: n - 1 per call.
ring_rotations = 0


def replicated_fanout_merge(shard: torch.Tensor,
                            group: dist.ProcessGroup) -> torch.Tensor:
    """ParallelChannel with an accumulating merger: every rank contributes
    its response and every rank sees the sum (the reference's psum)."""
    out = shard.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def gather_merge(shard: torch.Tensor,
                 group: dist.ProcessGroup) -> torch.Tensor:
    """ParallelChannel whose merger concatenates: the tiled all_gather,
    every rank's shard stacked on dim 0 in rank order."""
    shard = shard.contiguous()
    n = dist.get_world_size(group)
    out = shard.new_empty((n * shard.shape[0],) + tuple(shard.shape[1:]))
    dist.all_gather_into_tensor(out, shard, group=group)
    return out


def partition_scatter_gather(shard: torch.Tensor,
                             group: dist.ProcessGroup) -> torch.Tensor:
    """PartitionChannel: dim 0 of `shard` enumerates destination
    partitions in equal chunks; rank i receives chunk i of every rank j,
    concatenated in j order (the reference's tiled all_to_all)."""
    n = dist.get_world_size(group)
    if shard.shape[0] % n:
        raise ValueError(f"partition_scatter_gather: dim 0 ({shard.shape[0]})"
                         f" must split into {n} equal chunks")
    shard = shard.contiguous()
    out = torch.empty_like(shard)
    dist.all_to_all_single(out, shard, group=group)
    return out


def reduce_scatter_merge(shard: torch.Tensor,
                         group: dist.ProcessGroup) -> torch.Tensor:
    """Partitioned reducing merge: rank i keeps chunk i of the sum over
    ranks (the reference's tiled psum_scatter)."""
    n = dist.get_world_size(group)
    if shard.shape[0] % n:
        raise ValueError(f"reduce_scatter_merge: dim 0 ({shard.shape[0]}) "
                         f"must split into {n} equal chunks")
    shard = shard.contiguous()
    out = shard.new_empty((shard.shape[0] // n,) + tuple(shard.shape[1:]))
    dist.reduce_scatter_tensor(out, shard, op=dist.ReduceOp.SUM, group=group)
    return out


def _ring_start(tensors: Sequence[torch.Tensor], group: dist.ProcessGroup,
                steps: int) -> Tuple[List[torch.Tensor], list]:
    """Starts sending each tensor to ring position (i + steps) % n and
    receiving its twin from (i - steps) % n, in one batch_isend_irecv.
    Returns the receive buffers and the works to wait on; with nothing to
    move (n = 1, or steps a multiple of n) the buffers are copies."""
    n = dist.get_world_size(group)
    if steps % n == 0:
        return [t.clone() for t in tensors], []
    i = dist.get_rank(group)
    dst = dist.get_global_rank(group, (i + steps) % n)
    src = dist.get_global_rank(group, (i - steps) % n)
    outs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), dst, group, tag)
           for tag, t in enumerate(tensors)]
    ops += [dist.P2POp(dist.irecv, o, src, group, tag)
            for tag, o in enumerate(outs)]
    return outs, dist.batch_isend_irecv(ops)


def _finish(works: list) -> None:
    for w in works:
        w.wait()


def ring_cascade(shard: torch.Tensor, group: dist.ProcessGroup,
                 steps: int = 1) -> torch.Tensor:
    """Cascade as a ring: position i forwards its payload to position
    i + steps (mod n) and takes the one of position i - steps (the
    reference's ppermute ring)."""
    (out,), works = _ring_start((shard,), group, steps)
    _finish(works)
    return out


def default_mesh(world: int, device: str = "cuda",
                 dp_axis: str = "dp", tp_axis: str = "tp") -> DeviceMesh:
    """Factors the job's `world` ranks into a 2-D (dp, tp) mesh: tp is the
    largest power of two <= sqrt(world) that divides it, as in the
    reference, so 8 ranks give dp 4 x tp 2. Rank r sits at
    (r // tp, r % tp). Needs the process group to be initialised."""
    if world != dist.get_world_size():
        raise ValueError(f"default_mesh: world {world} but the process "
                         f"group has {dist.get_world_size()} ranks")
    tp = 1
    while tp * 2 <= world // (tp * 2) and world % (tp * 2) == 0:
        tp *= 2
    return init_device_mesh(device, (world // tp, tp),
                            mesh_dim_names=(dp_axis, tp_axis))


# ---- autograd of the collectives, as the reference differentiates them ----

class _AllReduce(torch.autograd.Function):
    """all_reduce(SUM) whose backward passes the cotangent through
    unchanged. In the reference the psum's output is replicated and the
    loss is read once, so each rank's cotangent is already the global one;
    torch.distributed.nn's all_reduce would sum it again over the group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup):
        return replicated_fanout_merge(x, group)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        return dy, None


class _RingCascade(torch.autograd.Function):
    """ring_cascade whose backward sends the cotangent the reverse way."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group: dist.ProcessGroup, steps: int):
        ctx.group, ctx.steps = group, steps
        return ring_cascade(x, group, steps)

    @staticmethod
    def backward(ctx, dy: torch.Tensor):
        return ring_cascade(dy, ctx.group, -ctx.steps), None, None


def make_fanout_step(mesh: DeviceMesh, dp_axis: str = "dp",
                     tp_axis: str = "tp"
                     ) -> Callable[[torch.Tensor, torch.Tensor],
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """The training-shaped fan-out step, per rank of a (dp, tp) mesh: the
    SPMD twin of the reference's jitted step.

    ``step(w_shard f32[K, N/tp], x_shard f32[R, K]) -> (loss, w1_shard)``,
    where w is sharded on tp (replicated over dp) and x on dp:

      1. all_to_all reshard of the request rows over dp;
      2. the service handler, bf16 x bf16 -> f32 (K1);
      3. all_reduce merge of the partial responses over tp;
      4. one ring hop over dp;
      5. loss = sum of squares (K8a, its gradient K8b), summed over dp;
      6. dW per rank (K2, rounded to bf16 as the reference rounds it), then
         summed over dp in f32, and w1 = w - 1e-3 * g rounded once, as
         the reference's fused multiply-subtract (K9).

    The gradient is that of the global loss, as in the reference: neither
    the loss's dp sum nor the tp merge scales it."""
    dp = mesh.get_group(dp_axis)
    tp = mesh.get_group(tp_axis)

    def step(w: torch.Tensor, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        w = w.detach().requires_grad_(True)
        with torch.enable_grad():
            xs = partition_scatter_gather(x, dp)
            y = BF16Matmul.apply(xs, w)
            y = _AllReduce.apply(y, tp)
            y = _RingCascade.apply(y, dp, 1)
            loss = _AllReduce.apply(SumSquares.apply(y), dp)
            (g,) = torch.autograd.grad(loss, (w,))
        # w is replicated over dp: its gradient is the dp sum of each
        # rank's bf16-rounded dW, taken in f32.
        g = replicated_fanout_merge(g, dp)
        return loss.detach(), sgd_update(w.detach(), g, 1e-3)

    return step


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: dist.ProcessGroup) -> torch.Tensor:
    """Sequence-parallel attention over a ring: each rank holds its shard
    of the sequence (q, k, v: [local_len, d]); the k/v shards rotate around
    the ring while every rank folds its queries' attention over the whole
    sequence into an f32 online-softmax carry (K3), whatever the input
    dtype. Returns softmax(q k^T / sqrt(d)) v for the local queries, cast
    back to q's dtype.

    Exactly n - 1 rotations of the (k, v) pair, each one batch_isend_irecv
    started before the fold of the block it carries away, then a final
    fold with no trailing rotation, which also normalises and casts (o / l
    in q's dtype, inside the kernel on the card)."""
    global ring_rotations
    n = dist.get_world_size(group)
    lq, d = q.shape
    m = torch.full((lq,), float("-inf"), dtype=torch.float32, device=q.device)
    l = torch.zeros((lq,), dtype=torch.float32, device=q.device)
    o = torch.zeros((lq, d), dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    for _ in range(n - 1):
        (k_next, v_next), works = _ring_start((k_blk, v_blk), group, 1)
        fold_(q, k_blk, v_blk, m, l, o)
        _finish(works)
        ring_rotations += 1
        k_blk, v_blk = k_next, v_next
    return fold_(q, k_blk, v_blk, m, l, o, final=True)


def make_ring_attention(mesh: DeviceMesh, axis: str = "sp"
                        ) -> Callable[[torch.Tensor, torch.Tensor,
                                       torch.Tensor], torch.Tensor]:
    """Per-rank sequence-parallel attention over the mesh axis `axis`:
    ``attn(q, k, v)`` on this rank's [local_len, d] shards returns its
    shard of the output."""
    group = mesh.get_group(axis)
    return lambda q, k, v: ring_attention(q, k, v, group)
