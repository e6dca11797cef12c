"""The C++ device plane's programs: the CUDA kernels' wrappers K4-K6 and
their plain PyTorch versions.

- ``u8_transform`` (K4) replaces cpp/tpu/serve_engine.cc:28 ``step_mlir``
  and the echo/xor255/incr bodies of cpp/tpu/pjrt_runtime.cc:191
  ``build_mlir``: u8[n] -> u8[n], copy, ``^ 0xFF`` or ``+ 1 mod 256``.
- ``dot128`` (K5) replaces pjrt_runtime.cc:207: f32[k, 128] . W in true
  f32, W[i, j] = ((3i + 5j) mod 11 - 5) / 8 (``dot128_weight``). The
  kernel runs on the tensor cores over an exact three-term bf16 split of
  x (``dot128_split_reference`` restates its arithmetic), reading W^T in
  bf16 from a 32 KiB device scratch built once per device
  (``dot128_weight_image`` is that scratch's plain version).
- ``dotbench`` (K6) replaces pjrt_runtime.cc:245 ``dotbench<N>x<T>``: the
  bf16 seed added to A0[i, j] = ((i + j) mod 7 - 3) / 8, T chained bf16
  products with W, each summed in f32 and rounded once, then scaled by
  bf16(1/N) in bf16; the checksum is the f32 sum rounded once to bf16
  (``dotbench_operands`` builds A0 and W by the reference's formulas).

The device runtime (tbus_torch/csrc/cuda_runtime.cc) launches the same
kernels from C++; ``device_method_reference`` is the plain version of one
of its device-method round trips (zero-padded to the length class, the
program, the reply cut to the request's length). The kernels live in
tbus_torch/csrc/device_programs.cu. A wrapper launches its kernel for a
CUDA tensor and takes the plain version only for a tensor on the CPU.
"""

from __future__ import annotations

import re
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from tbus_torch.kernels import ieee_fp32

# Transform name -> K4's op code (csrc/device_programs.cu).
U8_OPS = {"echo": 0, "xor255": 1, "incr": 2}

# Kernel launches made by this process through these wrappers (bumped
# only where a kernel is launched, never by a plain version). The device
# runtime counts its own launches (tbus_torch.rpc.device_stats()).
u8_launches = 0
dot128_launches = 0
dotbench_launches = 0


def _lib():
    from tbus_torch.kernels import _build

    return _build.device_programs_lib()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _device_of(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type


# ---- K4 ----

def _check_u8(x: torch.Tensor, transform: str) -> None:
    if transform not in U8_OPS:
        raise KeyError(f"unknown transform {transform!r}")
    if x.dtype != torch.uint8 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"want a contiguous u8[n], got {x.dtype} "
                         f"{tuple(x.shape)}")


def u8_transform_reference(x: torch.Tensor, transform: str) -> torch.Tensor:
    """Plain PyTorch version of K4, on any device."""
    _check_u8(x, transform)
    if transform == "xor255":
        return x ^ 0xFF
    if transform == "incr":
        return x + 1  # u8 arithmetic wraps mod 256
    return x.clone()


def u8_transform(x: torch.Tensor, transform: str) -> torch.Tensor:
    """u8[n] -> u8[n]: K4 for a CUDA tensor, the plain version for a CPU
    one."""
    global u8_launches
    _check_u8(x, transform)
    if _device_of(x, "u8_transform") == "cpu":
        return u8_transform_reference(x, transform)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        err = _lib().tbus_u8_transform(x.data_ptr(), out.data_ptr(),
                                       x.numel(), U8_OPS[transform],
                                       _stream(x))
    _raise_on(err, "u8_transform")
    u8_launches += 1
    return out


# ---- K5 ----

def dot128_weight(device="cpu") -> torch.Tensor:
    """W f32[128, 128], W[i, j] = ((3i + 5j) mod 11 - 5) / 8, computed in
    f32 from iotas as the reference's program computes it (exact)."""
    i = torch.arange(128, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(128, dtype=torch.float32, device=device)[None, :]
    return (torch.remainder(i * 3 + j * 5, 11) - 5) * 0.125


def _check_dot128(x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 128 \
            or not x.is_contiguous():
        raise ValueError(f"want a contiguous f32[k, 128], got {x.dtype} "
                         f"{tuple(x.shape)}")


def dot128_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K5: x . W in full f32 (TF32 off)."""
    _check_dot128(x)
    with ieee_fp32():
        return x @ dot128_weight(x.device)


# K5's warpgroups a block, each over 128 / DOT128_GROUPS of x's columns
# (csrc/device_programs.cu kDotGroups).
DOT128_GROUPS = 4


def dot128_row_scale(x: torch.Tensor) -> torch.Tensor:
    """K5's exponent s >= 0 for each row of x (k x 1, int): the least that
    brings the row's largest |x| to at least 1; 0 for a row there
    already, all zero, or holding inf or NaN (whose every sum is inf or
    NaN, whatever the rest)."""
    m = torch.where(torch.isfinite(x), x.abs(),
                    torch.full_like(x, float("inf"))).amax(dim=1,
                                                            keepdim=True)
    _, e = torch.frexp(m.double())  # m = f * 2^e, f in [0.5, 1)
    return torch.where((m > 0) & (m < 1), 1 - e, torch.zeros_like(e))


def split3_trunc_reference(a: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5's split of f32 values into three bf16 terms by truncation
    (csrc/device_programs.cu split3_trunc): hi = a's upper 16 bits, r = a -
    hi (exact), mid = r's upper 16 bits, lo = r - mid (exact, at most 8
    significant bits; its upper 16 bits taken), so hi + mid + lo == a
    wherever lo is a normal f32 (|a| >= 2^-103). inf splits to (inf, 0, 0),
    NaN to (NaN, 0, 0)."""
    a = a.float()
    fin = torch.isfinite(a)

    def upper(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)

    hi = torch.where(torch.isnan(a), a, upper(a))
    r = torch.where(fin, a - upper(a), torch.zeros_like(a))
    mid = upper(r)
    lo = upper(r - mid)
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


def dot128_split_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch restatement of K5's arithmetic (the tensor cores' own
    f32 addition order aside). For each of the DOT128_GROUPS column
    blocks of x (one warpgroup's): each row scaled by 2^s (s from
    dot128_row_scale, exact); split exactly into bf16 terms
    (split3_trunc_reference); three products of bf16 terms with W's rows
    in bf16 (exact in f32), each summed in f32, then added smallest first
    ((lo + mid) + hi); the scale undone with one rounding (in f64, then
    to f32). The blocks' sums are then added in f32 in order."""
    _check_dot128(x)
    w = dot128_weight(x.device).bfloat16().float()
    width = 128 // DOT128_GROUPS
    y = None
    for g in range(DOT128_GROUPS):
        xg = x[:, g * width:(g + 1) * width]
        s = dot128_row_scale(xg).double()
        xs = (xg.double() * torch.pow(2.0, s)).float()
        wg = w[g * width:(g + 1) * width]
        hi, mid, lo = split3_trunc_reference(xs)
        with ieee_fp32():
            acc = (lo.float() @ wg + mid.float() @ wg) + hi.float() @ wg
        part = (acc.double() * torch.pow(2.0, -s)).float()
        y = part if y is None else y + part
    return y


def dot128_payload(kind: str, k: int, seed: int) -> np.ndarray:
    """K5's hard payloads, f32[k, 128], made from `seed`: "subnormal",
    rows made only of f32 subnormals (every bit pattern equally likely,
    either sign); "scales", rows whose values sit near 2^-126, 2^-100,
    2^0, 2^60 and 2^99 in turn; "nonfinite", finite values below 2^100
    with +inf, -inf, both, or NaN in turn in every even row."""
    rng = np.random.default_rng(seed)
    if kind == "subnormal":
        bits = rng.integers(1, 1 << 23, (k, 128), dtype=np.uint32)
        bits |= rng.integers(0, 2, (k, 128), dtype=np.uint32) << 31
        return bits.view(np.float32)
    if kind == "scales":
        e = np.array([-126, -100, 0, 60, 99])[np.arange(k) % 5][:, None]
        return (rng.standard_normal((k, 128)) * 2.0**e).astype(np.float32)
    if kind != "nonfinite":
        raise ValueError(f"unknown payload kind {kind!r}")
    x = rng.standard_normal((k, 128)) * 2.0 ** rng.uniform(-30, 30, (k, 128))
    x = np.clip(x, -2.0**99, 2.0**99).astype(np.float32)
    kinds = ([np.inf], [-np.inf], [np.inf, -np.inf], [np.nan])
    for r in range(0, k, 2):
        vals = kinds[(r // 2) % len(kinds)]
        x[r, rng.choice(128, size=len(vals), replace=False)] = vals
    return x


def dot128_phys(slot: torch.Tensor) -> torch.Tensor:
    """The k index of x that K5's k slot multiplies (csrc dot128_phys): in
    each k16 step a thread's A slots 2q, 2q + 1, 2q + 8, 2q + 9 are x's
    4q .. 4q + 3, one float4 a row."""
    return (slot & ~15) | ((slot & 6) << 1) | ((slot >> 2) & 2) | (slot & 1)


def dot128_weight_image(device="cpu") -> torch.Tensor:
    """Plain version of K5's weight scratch (tbus_dot128_weight): bf16[16384],
    four slices of 32 columns j, each two boxes of 64 k slots, each 32 rows
    (j) of 128 bytes whose 16-byte chunk pc holds the row's logical chunk
    pc ^ (row % 8) (the 128-byte swizzle); slot s of row j holds
    W[dot128_phys(s), j]."""
    e = torch.arange(128 * 128, device=device)
    ns, kb = e // 4096, (e // 2048) % 2
    r, pc, el = (e // 64) % 32, (e // 8) % 8, e % 8
    slot = kb * 64 + (pc ^ (r % 8)) * 8 + el
    i, j = dot128_phys(slot), ns * 32 + r
    return ((((3 * i + 5 * j) % 11) - 5).float() * 0.125).bfloat16()


_dot128_weights: Dict[int, torch.Tensor] = {}
_dot128_weights_lock = threading.Lock()


def _dot128_weight_scratch(device: torch.device) -> torch.Tensor:
    """K5's weight scratch on `device`, built by its kernel at first use
    and kept for the process (finished before any caller's stream reads
    it)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    w = _dot128_weights.get(index)
    if w is not None:
        return w
    with _dot128_weights_lock:
        w = _dot128_weights.get(index)
        if w is None:
            lib = _lib()
            with torch.cuda.device(index):
                w = torch.empty(lib.tbus_dot128_weight_bytes(),
                                dtype=torch.uint8, device=f"cuda:{index}")
                stream = torch.cuda.current_stream(w.device)
                _raise_on(lib.tbus_dot128_weight(w.data_ptr(),
                                                 stream.cuda_stream),
                          "dot128 weight")
                stream.synchronize()
            _dot128_weights[index] = w
    return w


def dot128(x: torch.Tensor) -> torch.Tensor:
    """f32[k, 128] . W: K5 for a CUDA tensor, the plain version for a CPU
    one."""
    global dot128_launches
    _check_dot128(x)
    if _device_of(x, "dot128") == "cpu":
        return dot128_reference(x)
    if x.data_ptr() % 16:
        raise ValueError("dot128: x must be 16-byte aligned")
    out = torch.empty_like(x)
    w = _dot128_weight_scratch(x.device)
    with torch.cuda.device(x.device):
        err = _lib().tbus_dot128(x.data_ptr(), out.data_ptr(), x.shape[0],
                                 w.data_ptr(), _stream(x))
    _raise_on(err, "dot128")
    dot128_launches += 1
    return out


# ---- K6 ----

_DOTBENCH = re.compile(r"dotbench(\d+)x(\d+)")


def parse_dotbench(transform: str) -> Tuple[int, int]:
    """(N, T) of "dotbench<N>x<T>"; ValueError with the reference's text
    (pjrt_runtime.cc:265) outside 128 <= N <= 16384, 1 <= T <= 256."""
    m = _DOTBENCH.match(transform)
    n, t = (int(m.group(1)), int(m.group(2))) if m else (0, 0)
    if n < 128 or n > 16384 or t < 1 or t > 256:
        raise ValueError("dotbench wants dotbench<N>x<T>, 128<=N<=16384, "
                         f"1<=T<=256; got {transform}")
    return n, t


def dotbench_inverse(n: int) -> torch.Tensor:
    """bf16(1/N), the chain's scale."""
    return torch.tensor(1.0 / n, dtype=torch.float32).bfloat16()


def dotbench_operands(seed: float, n: int, device="cpu"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A0, W), both bf16[n, n]: A0[i, j] = bf16(((i + j) mod 7 - 3) / 8)
    + bf16(seed), added in f32 and rounded to bf16; W[i, j] = bf16(((3i +
    5j) mod 11 - 5) / 8), from f32 iotas as the reference computes them."""
    i = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    j = torch.arange(n, dtype=torch.float32, device=device)[None, :]
    w = ((torch.remainder(i * 3 + j * 5, 11) - 5) * 0.125).bfloat16()
    a = ((torch.remainder(i + j, 7) - 3) * 0.125).bfloat16()
    s = torch.tensor(seed, dtype=torch.float32).bfloat16().float()
    return (a.float() + s).bfloat16(), w


def dotbench_reference(seed: float, n: int, t: int, device="cpu",
                       return_last: bool = False):
    """Plain PyTorch version of K6: the f32 checksum as a 0-d tensor, and
    with return_last also the last bf16[n, n] matrix. Each product is
    taken in f32 on the bf16 operands (exact products, f32 sums, TF32 off)
    and rounded once to bf16; the scale multiplies in f32 and rounds once
    (bf16 * bf16 is exact in f32)."""
    v, w = dotbench_operands(seed, n, device)
    inv = dotbench_inverse(n).float().to(device)
    wf = w.float()
    with ieee_fp32():
        for _ in range(t):
            d = (v.float() @ wf).bfloat16()
            v = (d.float() * inv).bfloat16()
    total = v.float().sum().bfloat16().float()
    return (total, v) if return_last else total


def dotbench(seed: torch.Tensor, n: int, t: int, return_last: bool = False):
    """K6 on a one-element f32 seed tensor: the f32 checksum (a 1-element
    tensor on the seed's device), and with return_last also the last
    bf16[n, n] matrix. A CPU seed takes the plain version."""
    global dotbench_launches
    if seed.dtype != torch.float32 or seed.numel() != 1:
        raise ValueError(f"want a one-element f32 seed, got {seed.dtype} "
                         f"{tuple(seed.shape)}")
    if not (1 <= n <= 65536 and t >= 0):
        raise ValueError(f"dotbench: bad n {n} or t {t}")
    if _device_of(seed, "dotbench") == "cpu":
        res = dotbench_reference(float(seed.reshape(())), n, t,
                                 return_last=return_last)
        if return_last:
            return res[0].reshape(1), res[1]
        return res.reshape(1)
    lib = _lib()
    np_ = lib.tbus_dotbench_padded(n)
    dev = seed.device
    wt = torch.empty((np_, np_), dtype=torch.bfloat16, device=dev)
    bufs = [torch.empty((np_, np_), dtype=torch.bfloat16, device=dev)
            for _ in range(2)]
    partial = torch.empty(lib.tbus_dotbench_partial_bytes() // 4,
                          dtype=torch.float32, device=dev)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    seed = seed.reshape(1).contiguous()
    with torch.cuda.device(dev):
        err = lib.tbus_dotbench(
            seed.data_ptr(), wt.data_ptr(), bufs[0].data_ptr(),
            bufs[1].data_ptr(), partial.data_ptr(), out.data_ptr(), n, t,
            float(dotbench_inverse(n)), _stream(seed))
    _raise_on(err, "dotbench")
    dotbench_launches += 1
    if return_last:
        return out, bufs[t % 2][:n, :n]
    return out


# ---- a device-method round trip ----

def device_len_class(n: int) -> int:
    """The padded length of an n-byte device-method payload: powers of two
    with 1.5x half-steps from 128 (the port's copy of
    pjrt_runtime.cc:1185 DeviceLenClass)."""
    if n <= 128:
        return 128
    p = 128
    while p < n:
        if p + p // 2 >= n:
            return p + p // 2
        p *= 2
    return p


def device_method_reference(transform: str, payload: bytes,
                            device="cpu") -> bytes:
    """What a device method mounted with `transform` replies to `payload`,
    through the plain versions: dotbench takes its 4-byte seed as is;
    everything else is zero-padded to its length class, run, and cut to
    the payload's length. Raises ValueError for a payload the program
    refuses."""
    if transform.startswith("dotbench"):
        n, t = parse_dotbench(transform)
        if len(payload) != 4:
            raise ValueError("dotbench takes a 4-byte f32 seed payload; got "
                             f"length {len(payload)}")
        seed = torch.frombuffer(bytearray(payload), dtype=torch.float32)
        return dotbench_reference(float(seed[0]), n, t,
                                  device=device).reshape(1).cpu().numpy(
                                  ).tobytes()
    plen = device_len_class(len(payload))
    buf = torch.zeros(plen, dtype=torch.uint8)
    if payload:
        buf[:len(payload)] = torch.frombuffer(bytearray(payload),
                                              dtype=torch.uint8)
    buf = buf.to(device)
    if transform == "dot128":
        if plen % 512:
            raise ValueError(
                "dot128 needs a payload length that is a positive multiple "
                f"of 512 (f32[k,128] rows); got {plen}")
        out = dot128_reference(buf.view(torch.float32).view(-1, 128))
        out = out.reshape(-1).view(torch.uint8)
    else:
        out = u8_transform_reference(buf, transform)
    return out[:len(payload)].cpu().numpy().tobytes()
