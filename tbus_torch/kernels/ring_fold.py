"""Ring attention's online-softmax fold: kernel K3 (csrc/ring_fold.cu) and
its plain PyTorch version.

It replaces tbus/parallel/collective.py:125 ring_attention.fold: the local
queries q [lq, d] against one visiting block k, v [lk, d] (f32 or bf16),
folded into the f32 carry (m [lq], l [lq], o [lq, d]) as :128-137 compute
it, all in f32 after the input cast:

    s = q k^T / sqrt(d); m' = max(m, rowmax s); a = exp(m - m')
    l' = l a + rowsum exp(s - m'); o' = o a + exp(s - m') v

The reference is pure and returns the new carry; :func:`fold_` writes it
into m, l and o in place, which saves the carry's copy per ring step. With
``final=True`` the fold also ends the ring (the reference's :158): it
returns ``(o' / l').to(q.dtype)`` instead of writing o' (m' and l' are
still written), so the last step's normalise-and-cast runs inside the
kernel.

On the card every width runs on the tensor cores, over exact bf16 terms
of the f32 operands (csrc/ring_fold.cu): a pack, the fold, and a merge of
the partials where there are any. Heads up to :data:`RESIDENT_MAX_D` wide
keep q resident in a block, d padded to 128, 192 or 256; wider heads
stream q's and k's 64-column chunks through the block and split o's
columns into groups of 192 or 256, one group a block, each group
computing all of s.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from tbus_torch.kernels import DTYPE_CODES, ieee_fp32

# Kernel launches made by this process (bumped only where the kernel is
# launched, never by the plain version); wide_launches counts those that
# ran the wide heads' kernels (128 < d <= RESIDENT_MAX_D), stream_launches
# those past it (the head-dim-streamed kernels).
launches = 0
wide_launches = 0
stream_launches = 0

# The widest head whose q stays resident in a block of the split-term
# wgmma fold; a wider d streams q through the block (csrc/ring_fold.cu).
RESIDENT_MAX_D = 256


def column_groups(d: int) -> Tuple[int, int]:
    """Past RESIDENT_MAX_D: (G, OW), o's column groups and their width, as
    csrc/ring_fold.cu group_width makes them: d padded to D, a multiple
    of 64, in G = ceil(D / 256) groups of D / G columns rounded up to 64
    (192 or 256), one group a block."""
    if d <= RESIDENT_MAX_D:
        raise ValueError(f"column_groups: d {d} keeps q resident")
    dpad = -(-d // 64) * 64
    groups = -(-dpad // 256)
    width = -(-dpad // groups)
    return groups, -(-width // 64) * 64


def _check(q, k_blk, v_blk, m, l, o) -> None:
    if q.dim() != 2 or q.dtype not in DTYPE_CODES:
        raise ValueError(f"q must be 2-D f32 or bf16, got {q.dtype} "
                         f"{tuple(q.shape)}")
    lq, d = q.shape
    for name, t in (("k_blk", k_blk), ("v_blk", v_blk)):
        if t.dtype != q.dtype or t.dim() != 2 or t.shape[1] != d:
            raise ValueError(f"{name} must be {q.dtype} [lk, {d}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if k_blk.shape != v_blk.shape:
        raise ValueError("k_blk and v_blk differ in shape")
    for name, t, shape in (("m", m, (lq,)), ("l", l, (lq,)),
                           ("o", o, (lq, d))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"carry {name} must be f32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    devices = {t.device for t in (q, k_blk, v_blk, m, l, o)}
    if len(devices) != 1:
        raise ValueError(f"fold: tensors on several devices {devices}")


def _scale(d: int) -> torch.Tensor:
    """1 / sqrt(d) in f32, computed as the reference computes it."""
    return 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))


def fold_reference(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
                   m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                   final: bool = False
                   ) -> Union[Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
                              torch.Tensor]:
    """Plain version of the kernel, on any device: returns the new carry
    (m', l', o'), or with final=True the ring's output (o' / l') in q's
    dtype; leaves its inputs as they are."""
    _check(q, k_blk, v_blk, m, l, o)
    with ieee_fp32():
        s = torch.einsum("qd,kd->qk", q.float(), k_blk.float())
        s = s * _scale(q.shape[1]).to(s.device)
        m_new = torch.maximum(m, s.max(dim=-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l_new = l * alpha + p.sum(dim=-1)
        o_new = o * alpha[:, None] + p @ v_blk.float()
    if final:
        return (o_new / l_new[:, None]).to(q.dtype)
    return m_new, l_new, o_new


def fold_(q: torch.Tensor, k_blk: torch.Tensor, v_blk: torch.Tensor,
          m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
          final: bool = False) -> Optional[torch.Tensor]:
    """Folds one visiting k/v block into the carry (m, l, o) IN PLACE; with
    final=True writes m and l, leaves o, and returns (o' / l') in q's
    dtype. Launches the kernel for CUDA tensors; the plain version serves
    only tensors on the CPU."""
    global launches, wide_launches, stream_launches
    _check(q, k_blk, v_blk, m, l, o)
    if q.device.type == "cpu":
        m_new, l_new, o_new = fold_reference(q, k_blk, v_blk, m, l, o)
        m.copy_(m_new)
        l.copy_(l_new)
        if final:
            return (o_new / l_new[:, None]).to(q.dtype)
        o.copy_(o_new)
        return None
    if q.device.type != "cuda":
        raise ValueError(f"fold_: unsupported device {q.device}")
    lq, d = q.shape
    lk = k_blk.shape[0]
    if max(lq, lk, d) >= 2**31:
        raise ValueError(f"fold_: the kernel takes lq, lk, d < 2^31; got "
                         f"lq {lq}, lk {lk}, d {d}")
    if not all(t.is_contiguous() for t in (m, l, o)):
        raise ValueError("fold_: the carry must be contiguous")
    from tbus_torch.kernels import _build

    lib = _build.ring_fold_lib()
    q, k_blk, v_blk = (t.contiguous() for t in (q, k_blk, v_blk))
    code = DTYPE_CODES[q.dtype]
    out = torch.empty((lq, d), dtype=q.dtype, device=q.device) \
        if final else None
    with torch.cuda.device(q.device):
        nbytes = lib.tbus_ring_fold_scratch_bytes(lq, lk, d, code)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        err = lib.tbus_ring_fold(
            q.data_ptr(), k_blk.data_ptr(), v_blk.data_ptr(), m.data_ptr(),
            l.data_ptr(), o.data_ptr(), out.data_ptr() if final else None,
            scratch.data_ptr(), lq, lk, d, float(_scale(d)), code,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_fold kernel launch failed: CUDA error {err}")
    launches += 1
    if 128 < d <= RESIDENT_MAX_D:
        wide_launches += 1
    elif d > RESIDENT_MAX_D:
        stream_launches += 1
    return out
