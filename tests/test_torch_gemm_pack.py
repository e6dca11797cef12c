"""K1's pack (bf16 operands, K-major, zero-padded to the shared GEMM's tile)
through its plain version, the kernel build key's dependence on the
headers a source includes, and the build report kept beside a library.
Runs on the CPU; no nvcc is needed.

Tolerance: the packed product is compared in float64, where the sums of
these bf16 products are exact, so it must equal the exact product of the
rounded operands bit for bit; against K1's f32 plain version it may differ
by the order of the f32 sum, K * 2^-24 * (|x| @ |w|).
"""

import os
import re
import shutil
import sys
import types

import numpy as np
import pytest
import torch

from tbus_torch.kernels import _build, gemm, ieee_fp32

# (M, K, N): one element, the entry's shape, ragged shapes, and shapes one
# past the GEMM's block edges (128 rows, 256 columns, 64 deep).
SHAPES = [(1, 1, 1), (4, 16, 16), (37, 29, 50), (129, 65, 257),
          (130, 129, 257)]
DTYPES = [torch.float32, torch.bfloat16]


def _operands(m, k, n, x_dtype, w_dtype):
    rng = np.random.default_rng(m * 10007 + k * 101 + n)
    x = torch.from_numpy(rng.standard_normal((m, k), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n), dtype=np.float32)
                         * np.float32(0.02))
    return x.to(x_dtype), w.to(w_dtype)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("x_dtype", DTYPES, ids=str)
@pytest.mark.parametrize("w_dtype", DTYPES, ids=str)
def test_packed_product_equals_plain_matmul(shape, x_dtype, w_dtype):
    m, k, n = shape
    x, w = _operands(m, k, n, x_dtype, w_dtype)
    xb, wtb = gemm.pack_reference(x, w, gemm.TILE)
    assert xb.dtype == wtb.dtype == torch.bfloat16
    got = (xb.double() @ wtb.double().T)[:m, :n]
    exact = x.bfloat16().double() @ w.bfloat16().double()
    assert torch.equal(got, exact)
    with ieee_fp32():
        packed = (xb.float() @ wtb.float().T)[:m, :n]
        tol = k * 2.0**-24 * (x.bfloat16().float().abs()
                              @ w.bfloat16().float().abs())
    want = gemm.matmul_bf16_f32_reference(x, w)
    assert bool(((packed - want).abs() <= tol).all())


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_pack_pads_with_zeros_to_the_tile(shape):
    m, k, n = shape
    x, w = _operands(m, k, n, torch.float32, torch.float32)
    xb, wtb = gemm.pack_reference(x, w)
    bm, bn, bk = gemm.TILE
    mp, kp, np_ = gemm.padded_shape(m, k, n)
    assert xb.shape == (mp, kp) and wtb.shape == (np_, kp)
    assert mp % bm == 0 and np_ % bn == 0 and kp % bk == 0
    assert m <= mp < m + bm and n <= np_ < n + bn and k <= kp < k + bk
    assert torch.equal(xb[:m, :k], x.bfloat16())
    assert torch.equal(wtb[:n, :k], w.bfloat16().T)
    pad_x = xb.clone()
    pad_x[:m, :k] = 0
    pad_w = wtb.clone()
    pad_w[:n, :k] = 0
    assert not pad_x.any() and not pad_w.any()


def test_pack_rounds_to_nearest_even():
    """1 + 2^-8 is a tie between the bf16 values 1 and 1 + 2^-7: it rounds
    to 1 (the even one); 1 + 3 * 2^-8 rounds up to 1 + 2^-6."""
    x = torch.tensor([[1 + 2**-8, 1 + 3 * 2**-8]])
    w = torch.ones((2, 1))
    xb, wtb = gemm.pack_reference(x, w)
    assert xb[0, :2].float().tolist() == [1.0, 1 + 2**-6]
    assert wtb[0, :2].float().tolist() == [1.0, 1.0]


@pytest.mark.parametrize("name", ["gemm_bf16", "device_programs"])
def test_build_key_follows_the_shared_header(tmp_path, name):
    csrc = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")
    for f in (f"{name}.cu", "gemm_sm90.cuh"):
        shutil.copy(os.path.join(csrc, f), tmp_path / f)
    sources = _build.cuda_sources(name, str(tmp_path))
    assert [os.path.basename(p) for p in sources] == [f"{name}.cu",
                                                      "gemm_sm90.cuh"]
    before = _build.cuda_digest(name, str(tmp_path))
    assert before == _build.cuda_digest(name, csrc)
    with open(tmp_path / "gemm_sm90.cuh", "a") as f:
        f.write("// an edit to the header alone\n")
    assert _build.cuda_digest(name, str(tmp_path)) != before


def test_tile_is_the_headers_tile():
    """The plain pack's TILE is the mainloop's: kCluster blocks of kBM rows,
    kBN columns, kBK deep (the kernel takes its own from tbus_gemm_padded)."""
    csrc = os.path.join(os.path.dirname(_build.__file__), os.pardir, "csrc")
    with open(os.path.join(csrc, "gemm_sm90.cuh")) as f:
        text = f.read()
    c = {name: int(v) for name, v in re.findall(
        r"\b(kBM|kBN|kBK|kCluster) = (\d+)", text)}
    assert gemm.TILE == (c["kBM"] * c["kCluster"], c["kBN"], c["kBK"])


def test_build_keeps_its_report_beside_the_output(tmp_path, monkeypatch):
    """A build's compiler report stays beside its output, so ptxas_usage
    reads it when a later process finds the library already built."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "build_logs", {})
    monkeypatch.setattr(_build, "build_seconds", {})
    src = tmp_path / "fake.cu"
    src.write_text("// a source\n")
    report = "ptxas info    : Function properties for _Z4gemmv\n" \
             "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill " \
             "loads\nptxas info    : Used 168 registers\n"
    script = ("import sys; open(sys.argv[1], 'w').write('lib'); "
              f"sys.stderr.write({report!r})")
    calls = []

    def cmd(tmp):
        calls.append(tmp)
        return [sys.executable, "-c", script, tmp]

    out = _build._build("fake", "libfake.so", cmd, ([str(src)], []))
    _build.build_logs.clear()
    assert _build._build("fake", "libfake.so", cmd,
                         ([str(src)], [])) == out
    assert len(calls) == 1  # the second found it built
    monkeypatch.setitem(_build._loaded, "fake",
                        types.SimpleNamespace(_name=out))
    assert _build.ptxas_usage("fake") == {
        "_Z4gemmv": {"spill_stores": 0, "spill_loads": 0, "registers": 168}}
    os.remove(f"{out}.log")
    with pytest.raises(RuntimeError, match="no build report"):
        _build.ptxas_usage("fake")


def test_ptxas_report_is_read_per_kernel():
    """chip_smoke.py's spill check reads -Xptxas=-v's report per kernel."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z4packv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4packv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 39 registers, used 1 barriers, 16640 bytes smem",
        "ptxas info    : Compiling entry function '_Z4gemmv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z4gemmv",
        "    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers"])
    assert _build.parse_ptxas(log) == {
        "_Z4packv": {"spill_stores": 0, "spill_loads": 0, "registers": 39},
        "_Z4gemmv": {"spill_stores": 4, "spill_loads": 12, "registers": 168}}
    assert _build.parse_ptxas("") == {}
