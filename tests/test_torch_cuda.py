"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips where torch sees no GPU.  The
file imports no JAX, so on a machine with a card and without JAX it runs
with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: f32 within 1e-5 (1e-4 for the down
conv, whose plain version sums with a mean-centred cumsum) of the
largest sum of |terms|; bf16 adds one bf16 rounding of the output.
"""

import numpy as np
import pytest
import torch

from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.ops import coords as tc
from taseg_tpu_torch.ops import join as tj
from taseg_tpu_torch.ops import rulebook as tr
from taseg_tpu_torch.ops import sparse_conv as tsc
from taseg_tpu_torch.ops import strided_conv as tst
from taseg_tpu_torch.ops.join_scan import join_scan, join_scan_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _level(dev, seed=0, n=3000, span=30, cap=4096):
    rng = np.random.default_rng(seed)
    coords = np.concatenate(
        [rng.integers(-span, span, size=(n, 3)), rng.integers(0, 2, size=(n, 1))], 1
    ).astype(np.int32)
    c = torch.from_numpy(coords).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    b = tc.compute_bounds(c, valid)
    u, num, _, _ = tj.unique_coords(c, valid, b, cap)
    return rng, u, num, b


def _close(got, want, ref_abs, dtype, rel):
    err = (got.float() - want.float()).abs().max().item()
    tol = rel * ref_abs.float().abs().max().item()
    if dtype == torch.bfloat16:
        tol += 2.0**-7 * want.float().abs().max().item()
    assert err <= tol, (err, tol)


def test_join_scan_kernel_bit_exact(cuda):
    _, u, num, b = _level(cuda)
    hi, lo, q_hi, q_lo = tr.k3_floor_queries(u, num, 1, b)
    shi, slo2, srow = tj.sorted_union(hi, lo, q_hi, q_lo)
    for nref in (num, num // 2):
        nref = nref.reshape(1).to(torch.int32)
        for mode in (0, 1):
            got = join_scan(shi, slo2, srow, nref, hi.shape[0], int(tc.QUERY_SENTINEL_HI), mode)
            want = join_scan_plain(shi, slo2, srow, nref, hi.shape[0], int(tc.QUERY_SENTINEL_HI), mode)
            assert torch.equal(got, want)


def test_rulebook_on_card_equals_cpu(cuda):
    _, u, num, b = _level(cuda, seed=1)
    got = tr.build_rulebook_k3(u, num, 1, b).cpu()
    bc = tc.GridBounds(b.origin.cpu(), b.extent.cpu())
    want = tr.build_rulebook_k3(u.cpu(), num.cpu(), 1, bc)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out", [(4, 32), (37, 70), (128, 96), (384, 256)])
def test_sparse_conv_kernel(cuda, dtype, c_in, c_out):
    rng, u, num, b = _level(cuda, seed=c_in)
    rb = tr.build_rulebook_k3(u, num, 1, b)
    v = rb.shape[1]
    x = torch.from_numpy(rng.normal(size=(v, c_in)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.normal(size=(27, c_in, c_out)).astype(np.float32)).to(cuda, dtype)
    got = tsc.sparse_conv_k3(x, w, rb)
    _close(got, tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(x.abs(), w.abs(), rb), dtype, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_kernels(cuda, dtype):
    """Negative coords included: cell 0 then holds children of repeated
    slots, which the down kernel takes in several rounds."""
    rng, u, num, b = _level(cuda, seed=5)
    c2, n2, par, cnt, perm = tr.spdownsample(u, num, 2, 1, b, 4096, return_inverse=True)
    tab = tst.build_strided_tables(u, num, par, cnt, perm, 1)
    for c_in, c_out in ((32, 32), (70, 45)):
        x = torch.from_numpy(rng.normal(size=(u.shape[0], c_in)).astype(np.float32)).to(cuda, dtype)
        w = torch.from_numpy(rng.normal(size=(8, c_in, c_out)).astype(np.float32)).to(cuda, dtype)
        _close(
            tst.downsample_conv_apply(x, w, tab), tst.downsample_conv_plain(x, w, tab),
            tst.downsample_conv_plain(x.abs(), w.abs(), tab), dtype, 1e-4,
        )
        xc = torch.from_numpy(rng.normal(size=(c2.shape[0], c_in)).astype(np.float32)).to(cuda, dtype)
        _close(
            tst.upsample_conv_apply(xc, w, tab), tst.upsample_conv_plain(xc, w, tab),
            tst.upsample_conv_plain(xc.abs(), w.abs(), tab), dtype, 1e-5,
        )


def test_launch_counters_count_kernel_launches(cuda):
    _, u, num, b = _level(cuda, seed=2)
    _build.reset_launches()
    tr.build_rulebook_k3(u, num, 1, b)
    assert _build.LAUNCHES["join_scan"] == 1
    tr.build_rulebook_k3(u.cpu(), num.cpu(), 1, tc.GridBounds(b.origin.cpu(), b.extent.cpu()))
    assert _build.LAUNCHES["join_scan"] == 1  # the plain version counts nothing


def test_cuda_tensor_without_library_raises(cuda, monkeypatch, tmp_path):
    """No kernel library and no way to build one: a CUDA tensor handed to
    a wrapper raises; it never falls back to the plain version."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    x = torch.zeros(64, 8, device=cuda)
    rb = torch.full((27, 64), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="nvcc"):
        tsc.sparse_conv_k3(x, torch.zeros(27, 8, 4, device=cuda), rb)
