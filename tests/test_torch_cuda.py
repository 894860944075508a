"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips where torch sees no GPU.  The
file imports no JAX, so on a machine with a card and without JAX it runs
with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: f32 within 1e-5 (1e-4 for the down
conv, whose plain version sums with a mean-centred cumsum) of the
largest sum of |terms|; bf16 adds one bf16 rounding of the output.
bf16 cases with widths that are multiples of 8 take the tensor-core
route of K2 and K3, f32 and ragged cases the CUDA-core route.  K1, the
single-pass join scan, is bit-exact in both modes at tile edges, at the
main path's largest size, and across calls that reuse and grow its
look-back state.

The backward kernels: K4 (`k3_conv_dw`) and K5 (`strided_dw`) reduce
over up to all V rows in f32 in another order than the plain matmuls,
so they are held within 1e-4 of the largest sum of |terms|; K6
(`segment_sum`) within 1e-5 (against its plain version in f64 where
segments are long).  Each is called twice on the same inputs and must
give the same bits.  K4 takes its tensor-core route (over the pair
lists of `f3conv.k3_pair_lists`) in bf16 with widths that are multiples
of 8, its CUDA-core route in f32 and at ragged widths; K5 likewise, over
the per-slot lists of `strided_conv.slot_pair_lists`.  K7
(`devoxelize`) repeats its plain version's roundings and is held to the
same bits, signed zeros included.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.ops import f3conv as tf3
from taseg_tpu_torch.ops import join_scan as tjs
from taseg_tpu_torch.ops import voxelize as tvx
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


def _scan_inputs(dev, n, seed):
    """An arbitrary (shi, slo2, srow, num_refs, v, qsent) for the scan:
    sorted high keys with runs of equal keys, the last rows at the query
    sentinel, reference rows (srow < v) scattered, num_refs < v.  Kernel
    and plain version compute the same function of any such arrays."""
    rng = np.random.default_rng(seed)
    shi = np.sort(rng.integers(0, max(n // 3, 2), n)).astype(np.int32)
    shi[n - max(n // 50, 1):] = int(tc.QUERY_SENTINEL_HI)
    slo2 = rng.integers(0, 6, n).astype(np.int32)
    v = n // 2 + 1
    srow = rng.integers(0, 2 * v, n).astype(np.int32)
    t = [torch.from_numpy(x).to(dev) for x in (shi, slo2, srow)]
    num = torch.tensor([max(v - 3, 1)], dtype=torch.int32, device=dev)
    return (*t, num, v, int(tc.QUERY_SENTINEL_HI))


@pytest.mark.parametrize(
    "n", [1, 2047, 2048, 2049, 4095, 4096, 4097, 64 * 2048 + 5, 1310720]
)
def test_join_scan_single_pass_bit_exact(cuda, n):
    """One launch per call, bit-exact in both modes; rows around the tile
    edges (tjs.TILE rows per tile, 16 per thread) and level 0's
    n = 10 x 131072.  The counter is 0 again after each call.  Inputs
    that start off a 16-byte boundary take the kernel's scalar loads."""
    args = _scan_inputs(cuda, n, seed=n % 1009)
    for mode in (0, 1):
        _build.reset_launches()
        got = join_scan(*args, mode)
        assert _build.LAUNCHES["join_scan"] == 1
        assert torch.equal(got, join_scan_plain(*args, mode)), mode
    assert int(tjs._state(cuda).counter) == 0
    if n > 1:
        shifted = [x[1:] for x in args[:3]] + list(args[3:])
        for mode in (0, 1):
            assert torch.equal(join_scan(*shifted, mode), join_scan_plain(*shifted, mode))


def test_join_scan_state_across_calls(cuda, monkeypatch):
    """Calls queued back to back without a synchronisation: three of one
    size (the epoch tells their status words apart), a larger one (the
    buffer grows), small ones after a large one (the words of earlier
    calls lie beyond and within their tiles)."""
    monkeypatch.setattr(tjs, "_STATES", {})
    sizes = (5000, 5000, 5000, 300_000, 3000, 2049, 300_000, 1)
    inputs = [_scan_inputs(cuda, n, seed=i) for i, n in enumerate(sizes)]
    got = [join_scan(*a, i % 2) for i, a in enumerate(inputs)]
    for i, (a, g) in enumerate(zip(inputs, got)):
        assert torch.equal(g, join_scan_plain(*a, i % 2)), (i, sizes[i])
    st = tjs._state(cuda)
    assert st.epoch == len(sizes)
    assert st.status.shape[0] == 3 * ((300_000 + tjs.TILE - 1) // tjs.TILE)
    assert int(st.counter) == 0


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


def _down_case(dev, case):
    """Strided tables of one level pair for the down kernel:
    path:     non-negative coordinates, as the host pipeline gives them
              (one round);
    negative: coordinates around 0, so cell 0 holds repeated slots
              (several rounds);
    ragged:   V_coarse = 1000, not a multiple of the 64-row tile;
    empty:    whole tiles of coarse rows past the live ones, without
              children;
    dead:     the children of coarse rows 64-127 and every 7th fine row
              have parent -1 (skipped)."""
    span = 8
    rng = np.random.default_rng(11)
    coords = np.concatenate(
        [rng.integers(-span, span, size=(2000, 3)), rng.integers(0, 2, size=(2000, 1))], 1
    ).astype(np.int32)
    if case != "negative":
        coords[:, :3] += span
    u, num, b = _unique_level(dev, coords, 2048)
    cap2 = 1000 if case == "ragged" else 2048
    c2, n2, par, cnt, perm = tr.spdownsample(u, num, 2, 1, b, cap2, return_inverse=True)
    tab = tst.build_strided_tables(u, num, par, cnt, perm, 1)
    if case == "dead":
        parent = tab.parent.clone()
        kids = tab.perm[int(tab.starts[64]) : int(tab.starts[128])].long()
        parent[kids] = -1
        parent[::7] = -1
        tab = tst.StridedTables(parent=parent, slot=tab.slot, perm=tab.perm, starts=tab.starts)
    rounds = tst.slot_child_table(tab).shape[0]
    assert (rounds > 1) == (case == "negative"), rounds
    if case == "empty":
        assert int(n2) + 128 <= cap2
    if case == "ragged":
        assert cap2 % 64 and int(n2) <= cap2
    return rng, u.shape[0], tab, int(n2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["path", "negative", "ragged", "empty", "dead"])
@pytest.mark.parametrize("c_in,c_out", [(32, 32), (64, 64), (128, 128)])
def test_strided_down_kernel(cuda, dtype, case, c_in, c_out):
    """K3-down at the main path's widths (32->32 twice, 64->64,
    128->128): bf16 on the tensor-core route, f32 on CUDA cores."""
    rng, v_fine, tab, n2 = _down_case(cuda, case)
    x = torch.from_numpy(rng.normal(size=(v_fine, c_in)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.normal(size=(8, c_in, c_out)).astype(np.float32)).to(cuda, dtype)
    _build.reset_launches()
    got = tst.downsample_conv_apply(x, w, tab)
    mma = tst.downsample_route(dtype, c_in, c_out) == "mma"
    assert mma == (dtype == torch.bfloat16)
    assert (_build.LAUNCHES["strided_down"], _build.LAUNCHES["strided_down_mma"]) == (1, int(mma))
    _close(
        got, tst.downsample_conv_plain(x, w, tab),
        tst.downsample_conv_plain(x.abs(), w.abs(), tab), dtype, 1e-4,
    )
    if case in ("empty", "ragged"):
        assert not got[n2:].any()
    if case == "dead":
        assert not got[64:128].any()


def test_launch_counters_count_kernel_launches(cuda):
    _, u, num, b = _level(cuda, seed=2)
    _build.reset_launches()
    tr.build_rulebook_k3(u, num, 1, b)
    assert _build.LAUNCHES["join_scan"] == 1
    tr.build_rulebook_k3(u.cpu(), num.cpu(), 1, tc.GridBounds(b.origin.cpu(), b.extent.cpu()))
    assert _build.LAUNCHES["join_scan"] == 1  # the plain version counts nothing


def test_launch_counters_per_route(cuda):
    """Every K3 launch counts under strided_down / strided_up; the
    tensor-core ones under strided_down_mma / strided_up_mma too."""
    _, u, num, b = _level(cuda, seed=6)
    c2, n2, par, cnt, perm = tr.spdownsample(u, num, 2, 1, b, 4096, return_inverse=True)
    tab = tst.build_strided_tables(u, num, par, cnt, perm, 1)
    for dtype, mma in ((torch.bfloat16, 1), (torch.float32, 0)):
        _build.reset_launches()
        x = torch.ones(c2.shape[0], 16, device=cuda, dtype=dtype)
        tst.upsample_conv_apply(x, torch.ones(8, 16, 8, device=cuda, dtype=dtype), tab)
        assert (_build.LAUNCHES["strided_up"], _build.LAUNCHES["strided_up_mma"]) == (1, mma)
        xf = torch.ones(u.shape[0], 16, device=cuda, dtype=dtype)
        tst.downsample_conv_apply(xf, torch.ones(8, 16, 8, device=cuda, dtype=dtype), tab)
        assert (_build.LAUNCHES["strided_down"], _build.LAUNCHES["strided_down_mma"]) == (1, mma)
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
    # and so do K3-down's tensor-core route and K1
    i32 = dict(dtype=torch.int32, device=cuda)
    tab = tst.StridedTables(
        parent=torch.zeros(64, **i32), slot=torch.zeros(64, **i32),
        perm=torch.arange(64, **i32), starts=torch.tensor([0, 64], **i32),
    )
    assert tst.downsample_route(torch.bfloat16, 8, 8) == "mma"
    with pytest.raises(RuntimeError, match="nvcc"):
        tst.downsample_conv_apply(x.bfloat16(), torch.zeros(8, 8, 8, device=cuda, dtype=torch.bfloat16), tab)
    k = torch.zeros(64, **i32)
    with pytest.raises(RuntimeError, match="nvcc"):
        join_scan(k, k, k, torch.zeros(1, **i32), 32, 100, 1)


def _rand(rng, shape, dev, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev, dtype)


def _twice_same(fn):
    """fn() twice: the two results must be bit-identical."""
    a, b = fn(), fn()
    assert torch.equal(a, b)
    return a


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "c_in,c_out", [(4, 32), (37, 70), (32, 32), (64, 64), (128, 96), (384, 256)]
)
def test_k3_conv_dw_kernel(cuda, dtype, c_in, c_out):
    """K4 against its plain version, ragged widths (C_in = 4 is the
    stem's); one launch per call, the same bits on a repeat call, and the
    rounding to the weight dtype."""
    rng, u, num, b = _level(cuda, seed=20 + c_in)
    rb_bwd = tsc.flip_rulebook(tr.build_rulebook_k3(u, num, 1, b))
    x = _rand(rng, (u.shape[0], c_in), cuda, dtype)
    g = _rand(rng, (u.shape[0], c_out), cuda, dtype)
    _build.reset_launches()
    got = _twice_same(lambda: tf3.k3_conv_dw(x, g, rb_bwd))
    assert _build.LAUNCHES["k3_conv_dw"] == 2
    assert got.dtype == torch.float32 and got.shape == (27, c_in, c_out)
    _close(got, tf3.k3_conv_dw_plain(x, g, rb_bwd), tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd), torch.float32, 1e-4)
    assert torch.equal(tf3.k3_conv_dw(x, g, rb_bwd, out_dtype=dtype), got.to(dtype))


def test_k3_conv_dw_kernel_edges(cuda):
    """Empty V gives zeros; offsets absent from every row give a zero
    d_W[k]; a split of the rows (level-0 sized V) gives the same sums."""
    rb = torch.full((27, 0), -1, dtype=torch.int32, device=cuda)
    z = tf3.k3_conv_dw(torch.zeros(0, 8, device=cuda), torch.zeros(0, 16, device=cuda), rb)
    assert z.shape == (27, 8, 16) and not z.any()
    rng, u, num, b = _level(cuda, seed=31)
    rb_bwd = tsc.flip_rulebook(tr.build_rulebook_k3(u, num, 1, b))
    rb_bwd[[0, 5, 26]] = -1
    x = _rand(rng, (u.shape[0], 32), cuda, torch.float32)
    g = _rand(rng, (u.shape[0], 32), cuda, torch.float32)
    got = tf3.k3_conv_dw(x, g, rb_bwd)
    assert not got[[0, 5, 26]].any() and got[13].abs().sum() > 0
    v = 131072
    assert tf3.dw_splits(v, 27, 32, 32)[0] > 1
    idx = torch.from_numpy(np.random.default_rng(3).integers(-1, v, (27, v)).astype(np.int32)).to(cuda)
    xb = _rand(rng, (v, 32), cuda, torch.bfloat16)
    gb = _rand(rng, (v, 32), cuda, torch.bfloat16)
    got = _twice_same(lambda: tf3.k3_conv_dw(xb, gb, idx))
    _close(got, tf3.k3_conv_dw_plain(xb, gb, idx), tf3.k3_conv_dw_plain(xb.abs(), gb.abs(), idx), torch.float32, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["path", "negative", "dead"])
@pytest.mark.parametrize("c_in,c_out", [(4, 12), (32, 32), (256, 128)])
def test_strided_dw_kernel(cuda, dtype, case, c_in, c_out):
    """K5, both directions: non-negative coordinates, negative ones
    (children in 2+ rounds), children with parent -1; the same bits on a
    repeat call."""
    rng, v_fine, tab, n2 = _down_case(cuda, case)
    v_coarse = tab.starts.shape[0] - 1
    xf = _rand(rng, (v_fine, c_in), cuda, dtype)
    gc = _rand(rng, (v_coarse, c_out), cuda, dtype)
    xc = _rand(rng, (v_coarse, c_in), cuda, dtype)
    gf = _rand(rng, (v_fine, c_out), cuda, dtype)
    _build.reset_launches()
    for x, y, up in ((xf, gc, False), (xc, gf, True)):
        got = _twice_same(lambda: tst.strided_dw(x, y, tab, up))
        _close(
            got, tst.strided_dw_plain(x, y, tab, up),
            tst.strided_dw_plain(x.abs(), y.abs(), tab, up), torch.float32, 1e-4,
        )
    assert _build.LAUNCHES["strided_dw"] == 4


def _trilinear(dev, seed=41, n=3000):
    rng, u, num, b = _level(dev, seed=seed, n=n, span=20, cap=4096)
    c2, n2, _, _, _ = tr.spdownsample(u, num, 2, 1, b, 4096, return_inverse=True)
    pts = u[:, :3].float() + torch.from_numpy(rng.uniform(0, 1, (u.shape[0], 3)).astype(np.float32)).to(dev)
    pts = torch.cat([pts, u[:, 3:].float()], 1)
    valid = torch.arange(u.shape[0], device=dev) < num
    tab = tvx.trilinear_table(pts, valid, c2, n2, 2, b)
    return rng, u, num, tab


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [4, 20, 45])
def test_segment_sum_kernel(cuda, dtype, c):
    """K6 over the voxelize / identity-devox tables (ids with -1 rows)
    and over the trilinear pair table with weights; the same bits on a
    repeat call."""
    rng, u, num, tab = _trilinear(cuda)
    p = u.shape[0]
    ids = torch.from_numpy(rng.integers(-1, 700, p).astype(np.int32)).to(cuda)
    seg = tvx.build_segment_tables(ids, 1024)
    src = _rand(rng, (p, c), cuda, dtype)
    _build.reset_launches()
    for tables, w in ((seg, None), (tab.pairs, tab.weights.reshape(-1))):
        got = _twice_same(lambda: tvx.segment_sum(src, tables, w))
        want = tvx.segment_sum_plain(src, tables, w)
        ref = tvx.segment_sum_plain(src.abs(), tables, None if w is None else w.abs())
        _close(got, want, ref, torch.float32, 1e-5)
    assert _build.LAUNCHES["segment_sum"] == 4
    assert not tvx.segment_sum(src, seg)[700:].any()


def test_segment_sum_kernel_edges(cuda):
    """No segments; no real rows (only sentinels)."""
    src = torch.ones(5, 3, device=cuda)
    t0 = tvx.build_segment_tables(torch.zeros(5, dtype=torch.int32, device=cuda), 0)
    assert tvx.segment_sum(src, t0).shape == (0, 3)
    empty = tvx.build_segment_tables(torch.zeros(0, dtype=torch.int32, device=cuda), 7)
    out = tvx.segment_sum(torch.zeros(0, 3, device=cuda), empty)
    assert out.shape == (7, 3) and not out.any()


def test_backward_routes_and_counts(cuda):
    """Autograd through the k3 conv and the strided pair on the card: the
    input gradients run K2 / K3 on W^T and count under `_dgrad`, on the
    tensor-core route where the forward takes it (bf16, widths % 8 == 0),
    on CUDA cores in f32; every d_W runs K4 / K5 once."""
    rng, u, num, b = _level(cuda, seed=51)
    rb = tr.build_rulebook_k3(u, num, 1, b)
    c2, n2, par, cnt, perm = tr.spdownsample(u, num, 2, 1, b, 4096, return_inverse=True)
    tab = tst.build_strided_tables(u, num, par, cnt, perm, 1)
    for dtype, mma in ((torch.bfloat16, 1), (torch.float32, 0)):
        x = _rand(rng, (u.shape[0], 32), cuda, dtype).requires_grad_()
        w = _rand(rng, (27, 32, 32), cuda, dtype).requires_grad_()
        wd = _rand(rng, (8, 32, 64), cuda, dtype).requires_grad_()
        wu = _rand(rng, (8, 64, 32), cuda, dtype).requires_grad_()
        h = tsc.k3_conv(x, w, rb, tsc.flip_rulebook(rb))
        y = tst.upsample_conv(tst.downsample_conv(h, wd, tab), wu, tab)
        _build.reset_launches()
        y.float().square().sum().backward()
        L = _build.LAUNCHES
        assert (L["sparse_conv_k3_dgrad"], L["sparse_conv_k3_dgrad_mma"]) == (1, mma)
        assert (L["strided_down_dgrad"], L["strided_down_dgrad_mma"]) == (1, mma)
        assert (L["strided_up_dgrad"], L["strided_up_dgrad_mma"]) == (1, mma)
        assert (L["k3_conv_dw"], L["strided_dw"]) == (1, 2)
        assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (x, w, wd, wu))


@pytest.mark.parametrize("c_in,c_out", [(8, 8), (32, 32), (96, 96), (384, 256)])
def test_k3_conv_dw_mma_route(cuda, c_in, c_out):
    """K4's tensor-core route against its plain version: with the pair
    lists given and built by the wrapper (the same bits), offsets without
    pairs, pair counts that are not a multiple of the 32-pair stage; each
    launch counts under k3_conv_dw and k3_conv_dw_mma."""
    rng, u, num, b = _level(cuda, seed=60 + c_in)
    rb_bwd = tsc.flip_rulebook(tr.build_rulebook_k3(u, num, 1, b))
    rb_bwd[[0, 7, 26]] = -1
    pairs = tf3.k3_pair_lists(rb_bwd)
    counts = (pairs.starts[1:] - pairs.starts[:-1]).tolist()
    assert counts[0] == counts[7] == 0 and any(n % 32 for n in counts)
    x = _rand(rng, (u.shape[0], c_in), cuda, torch.bfloat16)
    g = _rand(rng, (u.shape[0], c_out), cuda, torch.bfloat16)
    assert tf3.dw_route(torch.bfloat16, c_in, c_out) == "mma"
    _build.reset_launches()
    got = _twice_same(lambda: tf3.k3_conv_dw(x, g, rb_bwd, pairs=pairs))
    assert (_build.LAUNCHES["k3_conv_dw"], _build.LAUNCHES["k3_conv_dw_mma"]) == (2, 2)
    assert torch.equal(tf3.k3_conv_dw(x, g, rb_bwd), got)
    assert not got[[0, 7, 26]].any()
    _close(got, tf3.k3_conv_dw_plain(x, g, rb_bwd), tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd), torch.float32, 1e-4)


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (64, 128)])
def test_k3_conv_dw_mma_many_splits(cuda, c_in, c_out):
    """A level-0 sized V splits every offset's list many times (the
    partials are added in split order): within tolerance, the same bits
    on a repeat call; the f32 call of the same shape takes the CUDA-core
    route."""
    v = 131072
    splits, per = tf3.dw_mma_splits(v, c_in, c_out)
    assert splits > 16
    rng = np.random.default_rng(7)
    idx = rng.integers(-3, v, (27, v)).astype(np.int32)
    idx[4, : v // 2] = -1  # an offset with half its rows
    idx = torch.from_numpy(idx).to(cuda)
    x = _rand(rng, (v, c_in), cuda, torch.bfloat16)
    g = _rand(rng, (v, c_out), cuda, torch.bfloat16)
    _build.reset_launches()
    got = _twice_same(lambda: tf3.k3_conv_dw(x, g, idx))
    _close(got, tf3.k3_conv_dw_plain(x, g, idx), tf3.k3_conv_dw_plain(x.abs(), g.abs(), idx), torch.float32, 1e-4)
    tf3.k3_conv_dw(x.float(), g.float(), idx)
    assert (_build.LAUNCHES["k3_conv_dw"], _build.LAUNCHES["k3_conv_dw_mma"]) == (3, 2)


def _long_short_ids(rng, p):
    """One segment of 4096+ members beside many 1-member ones, segments
    of random length that cross the 256-row chunks, dropped rows (-1)
    and segments with no real member (only their sentinel)."""
    ids = np.concatenate([
        np.full(4500, 5), np.arange(10, 1010), rng.integers(1100, 1400, p - 5500),
    ])
    ids[rng.integers(0, p, p // 20)] = -1
    return torch.from_numpy(ids.astype(np.int32)), 1600


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("c", [4, 20, 45])
def test_segment_sum_long_and_short_segments(cuda, dtype, weighted, c):
    """K6 against its plain version in f64 over long, short, chunk-
    crossing and sentinel-only segments; a repeat call gives the same
    bits; one launch counted per call."""
    rng = np.random.default_rng(90 + c)
    p = 12000
    ids, v = _long_short_ids(rng, p)
    reps = 2 if weighted else 1  # the trilinear table's R = k P rows
    tables = tvx.build_segment_tables(ids.repeat(reps).to(cuda), v)
    src = _rand(rng, (p, c), cuda, dtype)
    w = _rand(rng, (reps * p,), cuda, torch.float32) if weighted else None
    _build.reset_launches()
    got = _twice_same(lambda: tvx.segment_sum(src, tables, w))
    assert _build.LAUNCHES["segment_sum"] == 2
    w64 = None if w is None else w.double()
    want = tvx.segment_sum_plain(src.double(), tables, w64)
    ref = tvx.segment_sum_plain(src.double().abs(), tables, None if w is None else w64.abs())
    _close(got, want, ref, torch.float32, 1e-5)
    counts = tables.counts.cpu()
    assert (counts == 0).sum() > 100 and counts.max() >= 4096
    assert not got[counts.to(cuda) == 0].any()


# K5's widths on the main path: down1-4 (32 -> 32 twice), up1-4
K5_WIDTHS = [(32, 32), (64, 64), (128, 128), (256, 256), (256, 128), (128, 96), (96, 96)]


@pytest.mark.parametrize("case", ["path", "negative", "dead"])
@pytest.mark.parametrize("c_in,c_out", K5_WIDTHS)
def test_strided_dw_mma_route(cuda, case, c_in, c_out):
    """K5's tensor-core route, both directions, at the path's widths on
    non-negative coordinates (the up direction gathers each coarse row
    for each of its children), on negative ones (cells with repeated
    slots) and with dead children: within tolerance of its plain version,
    the same bits on a repeat call and with the pair lists built by the
    wrapper; each launch counts under strided_dw and strided_dw_mma."""
    rng, v_fine, bare, _ = _down_case(cuda, case)
    tab = replace(bare, pairs=tst.slot_pair_lists(bare))
    v_coarse = tab.starts.shape[0] - 1
    xf = _rand(rng, (v_fine, c_in), cuda, torch.bfloat16)
    gc = _rand(rng, (v_coarse, c_out), cuda, torch.bfloat16)
    xc = _rand(rng, (v_coarse, c_in), cuda, torch.bfloat16)
    gf = _rand(rng, (v_fine, c_out), cuda, torch.bfloat16)
    assert tf3.dw_route(torch.bfloat16, c_in, c_out) == "mma"
    _build.reset_launches()
    for x, y, up in ((xf, gc, False), (xc, gf, True)):
        got = _twice_same(lambda: tst.strided_dw(x, y, tab, up))
        assert torch.equal(tst.strided_dw(x, y, bare, up), got)
        _close(
            got, tst.strided_dw_plain(x, y, bare, up),
            tst.strided_dw_plain(x.abs(), y.abs(), bare, up), torch.float32, 1e-4,
        )
    assert (_build.LAUNCHES["strided_dw"], _build.LAUNCHES["strided_dw_mma"]) == (6, 6)


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (96, 96)])
def test_strided_dw_mma_many_splits(cuda, c_in, c_out):
    """A level-0 sized V_fine splits every slot's list many times, slot 3
    has no pairs and every 9th row is dead: within tolerance, the same
    bits on a repeat call, slot 3 zero; the f32 call takes the CUDA-core
    route."""
    v, v_coarse = 131072, 20000
    splits, _ = tf3.dw_mma_splits(v, c_in, c_out, n_out=8)
    assert splits > 16
    rng = np.random.default_rng(17)
    parent = rng.integers(0, v_coarse, v).astype(np.int32)
    parent[::9] = -1
    slot = rng.integers(0, 8, v).astype(np.int32)
    slot[slot == 3] = 6
    i32 = lambda a: torch.from_numpy(a).to(cuda)
    tab = tst.StridedTables(
        parent=i32(parent), slot=i32(slot), perm=i32(np.arange(v, dtype=np.int32)),
        starts=torch.zeros(v_coarse + 1, dtype=torch.int32, device=cuda),
    )
    _build.reset_launches()
    for up in (False, True):
        x = _rand(rng, (v_coarse if up else v, c_in), cuda, torch.bfloat16)
        y = _rand(rng, (v if up else v_coarse, c_out), cuda, torch.bfloat16)
        got = _twice_same(lambda: tst.strided_dw(x, y, tab, up))
        _close(
            got, tst.strided_dw_plain(x, y, tab, up),
            tst.strided_dw_plain(x.abs(), y.abs(), tab, up), torch.float32, 1e-4,
        )
        assert not got[3].any() and got[2].abs().sum() > 0
    tst.strided_dw(x.float(), y.float(), tab, True)
    assert (_build.LAUNCHES["strided_dw"], _build.LAUNCHES["strided_dw_mma"]) == (5, 4)


def test_strided_dw_mma_with_topology_lists(cuda):
    """The same bits from the pair lists of a train topology as from the
    wrapper's own, at every level, both directions."""
    from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities, build_unet_topology

    rng = np.random.default_rng(23)
    pts = np.zeros((4096, 4), np.float32)
    rows = np.unique(np.floor(rng.uniform(0, 48, size=(3500, 3))), axis=0)
    pts[: len(rows), :3] = rows
    topo = build_unet_topology(
        torch.from_numpy(pts).to(cuda), torch.tensor(len(rows), dtype=torch.int32),
        UNetCapacities.for_points(4096), devox_pairs=True,
    )
    for l in range(1, len(topo.levels)):
        tab = topo.levels[l].strided
        assert tab.pairs is not None
        bare = replace(tab, pairs=None)
        v_fine, v_coarse = tab.parent.shape[0], tab.starts.shape[0] - 1
        for up in (False, True):
            x = _rand(rng, (v_coarse if up else v_fine, 64), cuda, torch.bfloat16)
            y = _rand(rng, (v_fine if up else v_coarse, 32), cuda, torch.bfloat16)
            assert torch.equal(tst.strided_dw(x, y, tab, up), tst.strided_dw(x, y, bare, up))


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _devox_case(dev, dtype, c, misaligned):
    """A stride-2 trilinear table with 40 all-absent points, 40 points
    whose 8 corners all read one negative row with weight 0 (so every
    product and the sum are -0), 40 more points with one zero-weight
    present corner, and an identity inverse with -1 rows; `misaligned`
    starts the features 2 or 4 bytes off their vector boundary (the
    kernel's scalar path)."""
    rng, u, num, tab = _trilinear(dev, seed=47)
    idx, w = tab.idx.clone(), tab.weights.clone()
    idx[:, :40], w[:, :40] = -1, 0.0
    idx[:, 40:80], w[:, 40:80] = 0, 0.0
    present = torch.nonzero(idx[0, 80:] >= 0).flatten()[:40] + 80
    w[0, present] = 0.0
    tri = tvx.DevoxTable(idx=idx, weights=w, pairs=tab.pairs)
    v = int(idx.max()) + 1
    base = _rand(rng, (v * c + 1,), dev, dtype)
    vox = (base[1:] if misaligned else base[:-1]).view(v, c)
    vox[0] = -vox[0].abs() - 0.5
    inv = torch.from_numpy(rng.integers(-1, v, idx.shape[1]).astype(np.int32)).to(dev)
    return vox, tri, inv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [20, 19])
@pytest.mark.parametrize("misaligned", [False, True])
def test_devoxelize_kernel_bit_identical(cuda, dtype, c, misaligned):
    """K7 trilinear and identity give the plain versions' bits (signed
    zeros included) at the head's class width and at a ragged one, with
    all-absent points and zero-weight present corners; one launch per
    call, through `devoxelize` with and without autograd."""
    vox, tri, inv = _devox_case(cuda, dtype, c, misaligned)
    assert (vox.data_ptr() % 8 != 0) == misaligned
    _build.reset_launches()
    got = tvx.devoxelize_trilinear(vox, tri)
    want = tvx._devox_trilinear(vox, tri)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got[40:80]), _bits(torch.full_like(got[40:80], -0.0)))
    assert torch.equal(_bits(got[:40]), _bits(torch.zeros_like(got[:40])))
    got_id = tvx.devoxelize_identity(vox, inv)
    assert torch.equal(_bits(got_id), _bits(tvx._devox_identity(vox, inv)))
    assert _build.LAUNCHES["devoxelize"] == 2
    v = vox.detach().clone().requires_grad_()
    assert torch.equal(_bits(tvx.devoxelize(v, tri).detach()), _bits(want))
    assert torch.equal(_bits(tvx.devoxelize(vox, tri)), _bits(want))
    assert _build.LAUNCHES["devoxelize"] == 4


def test_devoxelize_kernel_empty(cuda):
    """P = 0 launches nothing; so do CPU tensors."""
    vox = torch.ones(5, 20, device=cuda, dtype=torch.bfloat16)
    _build.reset_launches()
    out = tvx.devoxelize_identity(vox, torch.zeros(0, dtype=torch.int32, device=cuda))
    assert out.shape == (0, 20)
    tri = tvx.DevoxTable(
        idx=torch.zeros(8, 0, dtype=torch.int32, device=cuda),
        weights=torch.zeros(8, 0, device=cuda),
    )
    assert tvx.devoxelize_trilinear(vox, tri).shape == (0, 20)
    tvx.devoxelize_identity(vox.cpu(), torch.zeros(3, dtype=torch.int32))
    assert _build.LAUNCHES["devoxelize"] == 0
