"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips where torch sees no GPU.  The
file imports no JAX, so on a machine with a card and without JAX it runs
with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: f32 within 1e-5 (1e-4 for the down
conv, whose plain version sums with a mean-centred cumsum) of the
largest sum of |terms|; bf16 adds one bf16 rounding of the output.
bf16 cases with widths that are multiples of 8 take the tensor-core
route of K2 and K3-up, f32 and ragged cases the CUDA-core route.
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
    return (rng, *_unique_level(dev, coords, cap))


def _unique_level(dev, coords, cap):
    n = coords.shape[0]
    c = torch.from_numpy(coords).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    b = tc.compute_bounds(c, valid)
    u, num, _, _ = tj.unique_coords(c, valid, b, cap)
    return u, num, b


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


def _check_k3(rng, rb, dtype, c_in, c_out):
    dev = rb.device
    v = rb.shape[1]
    x = torch.from_numpy(rng.normal(size=(v, c_in)).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(rng.normal(size=(27, c_in, c_out)).astype(np.float32)).to(dev, dtype)
    _build.reset_launches()
    got = tsc.sparse_conv_k3(x, w, rb)
    mma = tsc.route(dtype, c_in, c_out) == "mma"
    assert _build.LAUNCHES["sparse_conv_k3"] == 1
    assert _build.LAUNCHES["sparse_conv_k3_mma"] == int(mma)
    _close(got, tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(x.abs(), w.abs(), rb), dtype, 1e-5)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "c_in,c_out",
    [(4, 32), (37, 70), (128, 96), (384, 256), (32, 32), (96, 96), (192, 128), (256, 256)],
)
def test_sparse_conv_kernel(cuda, dtype, c_in, c_out):
    rng, u, num, b = _level(cuda, seed=c_in)
    rb = tr.build_rulebook_k3(u, num, 1, b)
    _check_k3(rng, rb, dtype, c_in, c_out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ragged_rows", "absent_tiles", "dense_cube"])
def test_sparse_conv_kernel_edges(cuda, dtype, case):
    """V not a multiple of the 64-row tile; whole tiles with every offset
    absent (their rows must come out 0); a dense 8^3 cube, whose inner
    voxels have all 27 neighbours."""
    if case == "dense_cube":
        g = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3)
        coords = np.concatenate([g, np.zeros((len(g), 1))], 1).astype(np.int32)
        rng = np.random.default_rng(3)
        u, num, b = _unique_level(cuda, coords, 576)
    else:
        rng, u, num, b = _level(cuda, seed=4, n=800, span=8, cap=1000)
    rb = tr.build_rulebook_k3(u, num, 1, b)
    if case == "absent_tiles":
        rb[:, 64:192] = -1
    if case == "dense_cube":
        assert bool((rb >= 0).all(0).any())  # some row has every offset
    got = _check_k3(rng, rb, dtype, 64, 96)
    if case == "absent_tiles":
        assert not got[64:192].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_kernels(cuda, dtype):
    """Negative coords included: cell 0 then holds children of repeated
    slots, which the down kernel takes in several rounds."""
    rng, u, num, b = _level(cuda, seed=5)
    c2, n2, par, cnt, perm = tr.spdownsample(u, num, 2, 1, b, 4096, return_inverse=True)
    tab = tst.build_strided_tables(u, num, par, cnt, perm, 1)
    widths = ((32, 32), (70, 45), (256, 256), (256, 128), (128, 96), (96, 96))
    for c_in, c_out in widths:
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


def test_launch_counters_per_route(cuda):
    """Every K3-up launch counts under strided_up; the tensor-core ones
    under strided_up_mma too."""
    _, u, num, b = _level(cuda, seed=6)
    c2, n2, par, cnt, perm = tr.spdownsample(u, num, 2, 1, b, 4096, return_inverse=True)
    tab = tst.build_strided_tables(u, num, par, cnt, perm, 1)
    for dtype, mma in ((torch.bfloat16, 1), (torch.float32, 0)):
        _build.reset_launches()
        x = torch.ones(c2.shape[0], 16, device=cuda, dtype=dtype)
        tst.upsample_conv_apply(x, torch.ones(8, 16, 8, device=cuda, dtype=dtype), tab)
        assert (_build.LAUNCHES["strided_up"], _build.LAUNCHES["strided_up_mma"]) == (1, mma)


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
    # the tensor-core route (bf16, widths multiples of 8) raises too
    assert tsc.route(torch.bfloat16, 8, 8) == "mma"
    with pytest.raises(RuntimeError, match="nvcc"):
        tsc.sparse_conv_k3(x.bfloat16(), torch.zeros(27, 8, 8, device=cuda, dtype=torch.bfloat16), rb)
