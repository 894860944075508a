"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked `cuda` and skips where torch sees no GPU.  The
file imports no JAX, so on a machine with a card and without JAX it runs
with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in chip_smoke.py: f32 within 1e-5 (1e-4 for the down
conv, whose plain version sums with a mean-centred cumsum) of the
largest sum of |terms|; bf16 adds one bf16 rounding of the output.
bf16 cases with widths that are multiples of 8 take the Hopper wgmma
route of K2, K3-down and K3-up (over row orders, chains cut on small
tables); f32 K3-down over a one-round child table and K3-up over the up
table K2 at K's 3xTF32 tile; child tables of several rounds (negative
coordinates) K3-down's round kernels; f32 and ragged cases the
CUDA-core route.  K3-up is held forward and as the down conv's input
gradient in both dtypes at the widths of MinkUNet's and TIAF's paths.  The wgmma route is held at every (C_in, C_out) of the
MinkUNet path and its input gradients, with and without split chains,
and to the same bits on repeat.  K1, the
single-pass join scan, is bit-exact in both modes at tile edges, at the
main path's largest size, and across calls that reuse and grow its
look-back state.

The backward kernels: K4 (`k3_conv_dw`) and K5 (`strided_dw`) reduce
over up to all V rows in f32 in another order than the plain matmuls,
so they are held within 1e-4 of the largest sum of |terms| (K4's
wgmma route at every width of the path, on small tables, within 1e-5 of
its f64 sum, with every list in one piece, in three and in many); K6
(`segment_sum`) within 1e-5 (against its plain version in f64 where
segments are long; at pixel-table shapes, on its rows kernel, and on
segments cut across many units).  Each is called twice on the same
inputs and must give the same bits.  K4 takes its wgmma route (over
the pair lists of `f3conv.k3_pair_lists`, one launch a call) in bf16
with widths that are multiples of 8, its CUDA-core route in f32 and at
ragged widths; K5 runs over the per-slot lists of
`strided_conv.slot_pair_lists` in one launch, on wgmma in bf16 and on
3xTF32 in f32 (widths in 8s / 4s), else on its CUDA-core kernel.  K7
(`devoxelize`) repeats its plain version's roundings and is held to the
same bits, signed zeros included, at 8 corners and at 4 (RPVNet's
bilinear sample of the range image), and so is its multi-scale entry
(the head's sum and the cat of KD's features; the head's backward, K6
once over the stacked pair table, within 1e-5 of the three separate
calls); so is K8 (`voxelize_bwd`), the
gradient of the voxelize mean.  A small SPVCNN f32 step on the card is
held against the CPU's.

K2 and K4 at K offsets (`sparse_conv`, `sparse_conv_dw`; Cylinder3D's
convs at K = 9, 3, 8 and 4, between two levels for the pooling and
transposed convs, and its 3^3 head at K = 27) are held as K2 and K4 are;
in f32 with widths that are multiples of 4 they take the 3xTF32 route
(over `mask_row_order` and `pair_lists`), held to the same tolerances and
to the same bits on repeat, at ragged V, all-empty tables and single-row
tiles too; the autograd Function of the conv over K offsets,
`segment_max` and a small Cylinder_TS f32 step on the card against the
CPU.  TASeg's temporal stages: small f32 steps of the tiny FSA and KD
recipes on the card against the CPU.  The range view: K9 (`knn`, the
KNN clean-up) equal to its plain version's labels on random scans, all
ties and class-0 votes; the four range models'
eval logits and train-mode gradients on the card against the CPU.  A
`Segmenter` built on the card
(without this file's `cuda` fixture, which switches TF32 off itself)
reads both TF32 flags as False.  K10 (`segment_max`) forward and
backward to the bits of its plain versions (`_bits`: signed zeros told
apart, a max of zeros +0.0 in both) at Cylinder3D's and the global max
pool's shapes with ties, f32 and bf16, the same bits on repeat, one
launch each way, through autograd against the CPU, and a NaN member;
SparseResNet21D and SparseResUNet42 at width 0.25 card against CPU
(eval features within 1e-4 of the CPU's largest; the parameters'
gradients, the ResNet's each within 1e-4, the UNet's as a whole within
1e-3 of its norm).
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
    wg = tsc.route(dtype, c_in, c_out) == "wgmma"
    assert _build.LAUNCHES["sparse_conv_k3"] == 1
    assert _build.LAUNCHES["sparse_conv_k3_wgmma"] == int(wg)
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
    128->128): over a one-round child table bf16 on the wgmma route, f32
    on 3xTF32; over several rounds (`negative`) the round kernels."""
    rng, v_fine, tab, n2 = _down_case(cuda, case)
    x = torch.from_numpy(rng.normal(size=(v_fine, c_in)).astype(np.float32)).to(cuda, dtype)
    w = torch.from_numpy(rng.normal(size=(8, c_in, c_out)).astype(np.float32)).to(cuda, dtype)
    _build.reset_launches()
    got = tst.downsample_conv_apply(x, w, tab)
    rounds = tst.slot_child_table(tab).shape[0]
    r = tst.downsample_route(dtype, c_in, c_out, rounds)
    want = "rounds" if case == "negative" else ("wgmma" if dtype == torch.bfloat16 else "tf32x3")
    assert r == want
    entry = {"wgmma": "strided_down_wgmma", "tf32x3": "strided_down_tf32", "rounds": "strided_down_rounds"}[r]
    assert (_build.LAUNCHES["strided_down"], _build.LAUNCHES[entry]) == (1, 1)
    _close(
        got, tst.downsample_conv_plain(x, w, tab),
        tst.downsample_conv_plain(x.abs(), w.abs(), tab), dtype, 1e-4,
    )
    if case in ("empty", "ragged"):
        assert not got[n2:].any()
    if case == "dead":
        assert not got[64:128].any()


# every (C_in, C_out) of MinkUNet mk34 cr1.0's 3^3 convs but the stem's
# C_in = 4, then their input gradients' (swapped; 256 -> 384 takes two
# 256-wide column blocks)
K2_WGMMA_WIDTHS = [
    (32, 32), (32, 64), (64, 64), (64, 128), (96, 96), (128, 96), (128, 128),
    (128, 256), (192, 128), (256, 256), (384, 256),
    (64, 32), (96, 128), (128, 64), (128, 192), (256, 128), (256, 384),
]


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("c_in,c_out", K2_WGMMA_WIDTHS)
def test_k2_wgmma_path_widths(cuda, monkeypatch, c_in, c_out, splits):
    """K2's wgmma route at every width of the path (bf16, within 1e-5 of
    the largest sum of |terms| plus one bf16 rounding), uncut and with
    each tile's chain in 3 parts; the same bits on repeat and with the
    order given; the flipped table (an input gradient's) over the same
    order."""
    monkeypatch.setattr(tsc, "wgmma_splits", lambda *shape: splits)
    rng, u, num, b = _level(cuda, seed=c_in + 3 * c_out)
    rb = tr.build_rulebook_k3(u, num, 1, b)
    x = _rand(rng, (rb.shape[1], c_in), cuda, torch.bfloat16)
    w = _rand(rng, (27, c_in, c_out), cuda, torch.bfloat16)
    assert tsc.route(torch.bfloat16, c_in, c_out) == "wgmma"
    _build.reset_launches()
    got = _twice_same(lambda: tsc.sparse_conv_k3(x, w, rb))
    order = tsc.mask_row_order(rb)
    assert torch.equal(got, tsc.sparse_conv_k3(x, w, rb, order=order))
    assert (_build.LAUNCHES["sparse_conv_k3"], _build.LAUNCHES["sparse_conv_k3_wgmma"]) == (3, 3)
    _close(got, tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(x.abs(), w.abs(), rb),
           torch.bfloat16, 1e-5)
    flip = tsc.flip_rulebook(rb)
    back = tsc.sparse_conv_k3(x, w, flip, dgrad=True, order=order)
    assert _build.LAUNCHES["sparse_conv_k3_dgrad_wgmma"] == 1
    _close(back, tsc.sparse_conv_plain(x, w, flip), tsc.sparse_conv_plain(x.abs(), w.abs(), flip),
           torch.bfloat16, 1e-5)


@pytest.mark.parametrize("splits", [1, 4])
@pytest.mark.parametrize("case", ["ragged", "empty", "one_row", "dense"])
def test_k2_wgmma_edges(cuda, monkeypatch, case, splits):
    """The wgmma route at 27 offsets on random tables (through K2 at K,
    whose V_in may differ from V_out): V_out = 1000 over V_in = 777
    (ragged tiles, ~2/3 of the entries present), a table with no present
    entry (zeros out, every tile empty), one output row (a one-row tile),
    every entry present (a dense chain in every tile); 32 -> 32, 96 ->
    96, 40 -> 24 (a 24-wide tail of a 32-column block, a 40-channel tail
    of a 32-channel stage) and 256 -> 384; uncut and in 4 parts, the same
    bits on repeat."""
    monkeypatch.setattr(tsc, "wgmma_splits", lambda *shape: splits)
    rng = np.random.default_rng(splits)
    v_in, v_out = {"ragged": (777, 1000), "empty": (300, 200), "one_row": (50, 1), "dense": (500, 700)}[case]
    rb = rng.integers(0, v_in, (27, v_out))
    rb[rng.random((27, v_out)) < {"empty": 1.0, "dense": 0.0}.get(case, 0.35)] = -1
    rb = torch.tensor(rb, dtype=torch.int32, device=cuda)
    for c_in, c_out in ((32, 32), (96, 96), (40, 24), (256, 384)):
        x = _rand(rng, (v_in, c_in), cuda, torch.bfloat16)
        w = _rand(rng, (27, c_in, c_out), cuda, torch.bfloat16)
        _build.reset_launches()
        out = _twice_same(lambda: tsc.sparse_conv(x, w, rb))
        assert _build.LAUNCHES["sparse_conv_k_wgmma"] == 2
        if case == "empty":
            assert not out.any()
        _close(out, tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(x.abs(), w.abs(), rb),
               torch.bfloat16, 1e-5)


@pytest.mark.parametrize("splits", [1, 2])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c_in,c_out", [(96, 96), (96, 128), (128, 256), (256, 256)])
def test_strided_down_input_gradient_widths(cuda, monkeypatch, dtype, c_in, c_out, splits):
    """K3-down at the widths of the up convs' input gradients (W^T of
    96 -> 96, 128 -> 96, 256 -> 128, 256 -> 256) over the one-round child
    table and its order as the topology builds them: bf16 on wgmma, f32
    on 3xTF32, chains uncut and in 2 parts; the same bits on repeat."""
    monkeypatch.setattr(tsc, "wgmma_splits", lambda *shape: splits)
    monkeypatch.setattr(tsc, "k_splits", lambda v: splits)
    rng, v_fine, tab, n2 = _down_case(cuda, "path")
    child = tst.slot_child_table(tab, rounds=1)
    assert torch.equal(child, tst.slot_child_table(tab))
    tab = replace(tab, child=child, child_order=tsc.mask_row_order(child[0]))
    x = _rand(rng, (v_fine, c_in), cuda, dtype)
    w = _rand(rng, (8, c_in, c_out), cuda, dtype)
    _build.reset_launches()
    got = _twice_same(lambda: tst.downsample_conv_apply(x, w, tab, dgrad=True))
    entry = "strided_down_dgrad_wgmma" if dtype == torch.bfloat16 else "strided_down_dgrad_tf32"
    assert (_build.LAUNCHES["strided_down_dgrad"], _build.LAUNCHES[entry]) == (2, 2)
    _close(got, tst.downsample_conv_plain(x, w, tab), tst.downsample_conv_plain(x.abs(), w.abs(), tab),
           dtype, 1e-4)


def test_launch_counters_count_kernel_launches(cuda):
    _, u, num, b = _level(cuda, seed=2)
    _build.reset_launches()
    tr.build_rulebook_k3(u, num, 1, b)
    assert _build.LAUNCHES["join_scan"] == 1
    tr.build_rulebook_k3(u.cpu(), num.cpu(), 1, tc.GridBounds(b.origin.cpu(), b.extent.cpu()))
    assert _build.LAUNCHES["join_scan"] == 1  # the plain version counts nothing


def test_launch_counters_per_route(cuda):
    """Every K3 launch counts under strided_down / strided_up; the
    tensor-core ones under their route's entry too: K3-up over the up
    table and K3-down over a one-round child table strided_up_wgmma /
    strided_down_wgmma (bf16) or strided_up_tf32 / strided_down_tf32
    (f32), K3-down over several rounds strided_down_rounds."""
    _, u, num, b = _level(cuda, seed=6)
    c2, n2, par, cnt, perm = tr.spdownsample(u, num, 2, 1, b, 4096, return_inverse=True)
    tab = tst.build_strided_tables(u, num, par, cnt, perm, 1)
    assert tst.slot_child_table(tab).shape[0] > 1  # coordinates around 0
    one = replace(tab, child=tst.slot_child_table(tab)[:1])  # one round of it
    for dtype, mma in ((torch.bfloat16, 1), (torch.float32, 0)):
        _build.reset_launches()
        up = "strided_up_wgmma" if mma else "strided_up_tf32"
        x = torch.ones(c2.shape[0], 16, device=cuda, dtype=dtype)
        tst.upsample_conv_apply(x, torch.ones(8, 16, 8, device=cuda, dtype=dtype), tab)
        assert (_build.LAUNCHES["strided_up"], _build.LAUNCHES[up]) == (1, 1)
        xf = torch.ones(u.shape[0], 16, device=cuda, dtype=dtype)
        tst.downsample_conv_apply(xf, torch.ones(8, 16, 8, device=cuda, dtype=dtype), tab)
        assert (_build.LAUNCHES["strided_down"], _build.LAUNCHES["strided_down_rounds"]) == (1, 1)
        tst.downsample_conv_apply(xf, torch.ones(8, 16, 8, device=cuda, dtype=dtype), one)
        entry = "strided_down_wgmma" if mma else "strided_down_tf32"
        assert (_build.LAUNCHES["strided_down"], _build.LAUNCHES[entry]) == (2, 1)
        assert (_build.LAUNCHES["strided_up"], _build.LAUNCHES[up]) == (1, 1)


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
    # the wgmma route (bf16, widths multiples of 8) raises too
    assert tsc.route(torch.bfloat16, 8, 8) == "wgmma"
    with pytest.raises(RuntimeError, match="nvcc"):
        tsc.sparse_conv_k3(x.bfloat16(), torch.zeros(27, 8, 8, device=cuda, dtype=torch.bfloat16), rb)
    # and so do K3-down's wgmma route and K1
    i32 = dict(dtype=torch.int32, device=cuda)
    tab = tst.StridedTables(
        parent=torch.zeros(64, **i32), slot=torch.zeros(64, **i32),
        perm=torch.arange(64, **i32), starts=torch.tensor([0, 64], **i32),
    )
    assert tst.downsample_route(torch.bfloat16, 8, 8) == "wgmma"
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
    tensor-core routes where the forward takes them (bf16, widths % 8 ==
    0: K2 and K3-up on wgmma, K4 on its wgmma tile); in f32 the k3 conv
    takes K2 and K4 at K = 27 on 3xTF32 (`k_route`) and K3-up K2 at K's
    3xTF32 tile over the up table; the level's coordinates straddle 0, so
    K3-down takes its round kernel in both; every d_W runs K4 / K5
    once."""
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
        k3 = (L["sparse_conv_k3_dgrad"], L["sparse_conv_k3_dgrad_wgmma"], L["k3_conv_dw"],
              L["k3_conv_dw_wgmma"])
        k27 = (L["sparse_conv_k_dgrad_tf32"], L["sparse_conv_dw_tf32"])
        assert (k3, k27) == (((1, 1, 1, 1), (0, 0)) if mma else ((0, 0, 0, 0), (1, 1)))
        assert (L["strided_down_dgrad"], L["strided_down_dgrad_rounds"]) == (1, 1)
        up = "strided_up_dgrad_wgmma" if mma else "strided_up_dgrad_tf32"
        assert (L["strided_up_dgrad"], L[up]) == (1, 1)
        assert L["strided_dw"] == 2
        assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in (x, w, wd, wu))


@pytest.mark.parametrize("c_in,c_out", [(8, 8), (32, 32), (96, 96), (384, 256)])
def test_k3_conv_dw_mma_route(cuda, c_in, c_out):
    """K4's tensor-core route (the wgmma tile) against its plain version:
    with the pair lists given and built by the wrapper (the same bits),
    offsets without pairs, pair counts that are not a multiple of the
    stage; each launch counts under k3_conv_dw and k3_conv_dw_wgmma."""
    rng, u, num, b = _level(cuda, seed=60 + c_in)
    rb_bwd = tsc.flip_rulebook(tr.build_rulebook_k3(u, num, 1, b))
    rb_bwd[[0, 7, 26]] = -1
    pairs = tf3.k3_pair_lists(rb_bwd)
    counts = (pairs.starts[1:] - pairs.starts[:-1]).tolist()
    assert counts[0] == counts[7] == 0 and any(n % 32 for n in counts)
    x = _rand(rng, (u.shape[0], c_in), cuda, torch.bfloat16)
    g = _rand(rng, (u.shape[0], c_out), cuda, torch.bfloat16)
    assert tf3.dw_route(torch.bfloat16, c_in, c_out) == "wgmma"
    _build.reset_launches()
    got = _twice_same(lambda: tf3.k3_conv_dw(x, g, rb_bwd, pairs=pairs))
    assert (_build.LAUNCHES["k3_conv_dw"], _build.LAUNCHES["k3_conv_dw_wgmma"]) == (2, 2)
    assert torch.equal(tf3.k3_conv_dw(x, g, rb_bwd), got)
    assert not got[[0, 7, 26]].any()
    _close(got, tf3.k3_conv_dw_plain(x, g, rb_bwd), tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd), torch.float32, 1e-4)


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (64, 128)])
def test_k3_conv_dw_mma_many_splits(cuda, c_in, c_out):
    """A level-0 sized V splits every offset's list many times (the
    last block of each list adds the partials in split order): within
    tolerance, the same bits on a repeat call; the f32 call of the same
    shape takes the CUDA-core route."""
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
    assert (_build.LAUNCHES["k3_conv_dw"], _build.LAUNCHES["k3_conv_dw_wgmma"]) == (3, 2)


# every (C_in, C_out) of MinkUNet mk34 cr1.0's 3^3 convs on K4's wgmma
# route (all but the stem's 4 -> 32)
K4_WIDTHS = [
    (32, 32), (32, 64), (64, 64), (64, 128), (96, 96), (128, 96), (128, 128),
    (128, 256), (192, 128), (256, 256), (384, 256),
]


def _k4_table(dev, table):
    """(V, reverse table) of a K4 case: `ragged`, a level's flipped
    rulebook (V not a multiple of any tile) with three offsets emptied;
    `empty`, no pair at all; `one_row`, one row with its centre pair."""
    if table == "ragged":
        _, u, num, b = _level(dev, seed=71)
        rb = tsc.flip_rulebook(tr.build_rulebook_k3(u, num, 1, b))
        rb[[0, 7, 26]] = -1
        return u.shape[0], rb
    v = 1 if table == "one_row" else 300
    rb = torch.full((27, v), -1, dtype=torch.int32, device=dev)
    if table == "one_row":
        rb[13, 0] = 0
    return v, rb


def _dw_f64(x, g, pairs):
    """d_W over the pair lists in f64 (the sums and the sums of |terms|)."""
    s = pairs.starts.tolist()
    out, ref = [], []
    for k in range(27):
        p = pairs.pairs[s[k] : s[k + 1]].long()
        a, b = x[p[:, 0]].double(), g[p[:, 1]].double()
        out.append(a.t() @ b)
        ref.append(a.abs().t() @ b.abs())
    return torch.stack(out), torch.stack(ref)


@pytest.mark.parametrize("splits", ["one", "three", "many"])
@pytest.mark.parametrize("table", ["ragged", "empty", "one_row"])
@pytest.mark.parametrize("c_in,c_out", K4_WIDTHS)
def test_k4_wgmma_path_widths(cuda, c_in, c_out, table, splits):
    """K4's wgmma route at every width of the path (its tile: the whole
    C_out, 128 C_in rows from C_in 128) against the f64 sum over the pair
    lists, within 1e-5 of the f64 sum of |terms|, with every list in one
    piece, the longest in three and every list in many (the last block
    adds them in split order); the same bits on repeat, one launch a
    call, empty lists zero."""
    v, rb = _k4_table(cuda, table)
    pairs = tf3.k3_pair_lists(rb)
    counts = (pairs.starts[1:] - pairs.starts[:-1]).tolist()
    rng = np.random.default_rng(c_in + c_out)
    x = _rand(rng, (v, c_in), cuda, torch.bfloat16)
    g = _rand(rng, (v, c_out), cuda, torch.bfloat16)
    plan = tf3.k4_one_split(v, c_in, c_out)
    if splits != "one":
        per = max(1, -(-max(counts) // 3)) if splits == "three" else 64
        plan = plan._replace(per_min=per)
    _build.reset_launches()
    got = _twice_same(lambda: tf3.k3_conv_dw_wgmma(x, g, pairs, plan))
    assert (_build.LAUNCHES["k3_conv_dw"], _build.LAUNCHES["k3_conv_dw_wgmma"]) == (2, 2)
    want, ref = _dw_f64(x, g, pairs)
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * ref.max().item(), err
    assert not got[[k for k in range(27) if counts[k] == 0]].any()
    if table == "ragged":  # the default plan splits by the lists' lengths
        _close(tf3.k3_conv_dw(x, g, rb), want, ref, torch.float32, 1e-5)


def test_k4_wgmma_one_split_against_pieces(cuda):
    """At a level-0 sized table the default plan cuts the lists into
    pieces and the one-piece plan does not: both within tolerance of each
    other (f32 sums in another order), each bit-identical on repeat."""
    v = 131072
    rng = np.random.default_rng(5)
    idx = torch.from_numpy(rng.integers(-8, v, (27, v)).astype(np.int32)).to(cuda)
    pairs = tf3.k3_pair_lists(idx)
    x = _rand(rng, (v, 32), cuda, torch.bfloat16)
    g = _rand(rng, (v, 32), cuda, torch.bfloat16)
    many = _twice_same(lambda: tf3.k3_conv_dw_wgmma(x, g, pairs))
    one = _twice_same(lambda: tf3.k3_conv_dw_wgmma(x, g, pairs, tf3.k4_one_split(v, 32, 32)))
    ref = tf3.k3_conv_dw_plain(x.abs(), g.abs(), idx)
    _close(many, one, ref, torch.float32, 1e-4)
    _close(many, tf3.k3_conv_dw_plain(x, g, idx), ref, torch.float32, 1e-4)


# K3-up's widths: forward on the deconvs of MinkUNet and TIAF's branches,
# input gradient of the down convs (C_out -> C_in on W^T)
K3_UP_WIDTHS = [(16, 16), (32, 32), (48, 48), (64, 64), (96, 96), (128, 96), (128, 128), (256, 128), (256, 256)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ["path", "negative", "dead"])
@pytest.mark.parametrize("c_in,c_out", K3_UP_WIDTHS)
def test_k3_up_over_up_table(cuda, dtype, case, c_in, c_out):
    """K3-up on K2's tiles over the level's up table (wgmma in bf16,
    3xTF32 in f32), forward and as an input gradient, within 1e-5 (bf16:
    plus one rounding) of its plain version, with the topology's up table
    and order and without them (built per call: the same bits); dead
    fine rows are zero."""
    rng, v_fine, bare, _ = _down_case(cuda, case)
    up = tst.slot_up_table(bare)
    tab = replace(bare, up=up, up_order=tsc.mask_row_order(up))
    v_coarse = tab.starts.shape[0] - 1
    x = _rand(rng, (v_coarse, c_in), cuda, dtype)
    w = _rand(rng, (8, c_in, c_out), cuda, dtype)
    route = tst.upsample_route(dtype, c_in, c_out)
    assert route == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")
    entry = "_wgmma" if route == "wgmma" else "_tf32"
    _build.reset_launches()
    got = _twice_same(lambda: tst.upsample_conv_apply(x, w, tab))
    grad = tst.upsample_conv_apply(x, w, tab, dgrad=True)
    assert torch.equal(grad, got) and torch.equal(tst.upsample_conv_apply(x, w, bare), got)
    L = _build.LAUNCHES
    assert (L["strided_up"], L["strided_up" + entry], L["strided_up_dgrad"], L["strided_up_dgrad" + entry]) == (4, 4, 1, 1)
    ref = tst.upsample_conv_plain(x.abs(), w.abs(), tab)
    _close(got, tst.upsample_conv_plain(x, w, tab), ref, dtype, 1e-5)
    _close(got, tst.upsample_conv_up_plain(x, w, up), ref, dtype, 1e-5)
    if case == "dead":
        assert not got[tab.parent < 0].any()


def test_segmenter_switches_tf32_off(monkeypatch):
    """A `Segmenter` built on the card through its entry point, without
    the `cuda` fixture, runs with cuDNN's and the matmuls' TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from taseg_tpu_torch.configs import MINKUNET_TINY
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    p, s = init_params_numpy(MINKUNET_TINY, seed=0)
    seg = Segmenter(MINKUNET_TINY, {"params": p, "batch_stats": s})
    assert seg.device.type == "cuda"
    assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32


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
    wrapper; each launch counts under strided_dw and strided_dw_wgmma
    (the wgmma tile over the slot lists, one launch per call)."""
    rng, v_fine, bare, _ = _down_case(cuda, case)
    tab = replace(bare, pairs=tst.slot_pair_lists(bare))
    v_coarse = tab.starts.shape[0] - 1
    xf = _rand(rng, (v_fine, c_in), cuda, torch.bfloat16)
    gc = _rand(rng, (v_coarse, c_out), cuda, torch.bfloat16)
    xc = _rand(rng, (v_coarse, c_in), cuda, torch.bfloat16)
    gf = _rand(rng, (v_fine, c_out), cuda, torch.bfloat16)
    assert tf3.dw_route(torch.bfloat16, c_in, c_out, strided=True) == "wgmma"
    _build.reset_launches()
    for x, y, up in ((xf, gc, False), (xc, gf, True)):
        got = _twice_same(lambda: tst.strided_dw(x, y, tab, up))
        assert torch.equal(tst.strided_dw(x, y, bare, up), got)
        _close(
            got, tst.strided_dw_plain(x, y, bare, up),
            tst.strided_dw_plain(x.abs(), y.abs(), bare, up), torch.float32, 1e-4,
        )
    assert (_build.LAUNCHES["strided_dw"], _build.LAUNCHES["strided_dw_wgmma"]) == (6, 6)


@pytest.mark.parametrize("c_in,c_out", [(32, 32), (96, 96)])
def test_strided_dw_mma_many_splits(cuda, c_in, c_out):
    """A level-0 sized V_fine splits every slot's list many times (the
    last block of each list adds the splits in split order), slot 3 has
    no pairs and every 9th row is dead: within tolerance, the same bits
    on a repeat call, slot 3 zero; the f32 call takes the 3xTF32 tile."""
    v, v_coarse = 131072, 20000
    splits, _ = tf3.k5_splits(v, c_in, c_out)
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
    L = _build.LAUNCHES
    assert (L["strided_dw"], L["strided_dw_wgmma"], L["strided_dw_tf32"]) == (5, 4, 1)


# K5's widths on TIAF's f32 step (its branches' strided convs)
K5_TIAF_WIDTHS = [(16, 16), (32, 32), (48, 48), (64, 64), (128, 128), (256, 128), (128, 96), (96, 96)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c_in,c_out", sorted(set(K5_WIDTHS) | set(K5_TIAF_WIDTHS)))
@pytest.mark.parametrize("v", [3000, 131072])
def test_strided_dw_slot_lists_both_dtypes(cuda, dtype, c_in, c_out, v):
    """K5 over the slot lists in both dtypes (wgmma in bf16, 3xTF32 in
    f32) at MinkUNet's and TIAF's widths, down and up, on one list per
    split and on many (a level-0 V_fine): within 1e-4 of
    `strided_dw_plain`'s largest sum of |terms|, the same bits on repeat,
    one launch per call on the dtype's route."""
    v_coarse = v // 6
    rng = np.random.default_rng(c_in + c_out + v)
    parent = rng.integers(0, v_coarse, v).astype(np.int32)
    parent[::7] = -1
    slot = rng.integers(0, 8, v).astype(np.int32)
    i32 = lambda a: torch.from_numpy(a).to(cuda)
    bare = tst.StridedTables(
        parent=i32(parent), slot=i32(slot), perm=i32(np.arange(v, dtype=np.int32)),
        starts=torch.zeros(v_coarse + 1, dtype=torch.int32, device=cuda),
    )
    tab = replace(bare, pairs=tst.slot_pair_lists(bare))
    route = tf3.dw_route(dtype, c_in, c_out, strided=True)
    assert route == ("wgmma" if dtype == torch.bfloat16 else "tf32x3")
    _build.reset_launches()
    for up in (False, True):
        x = _rand(rng, (v_coarse if up else v, c_in), cuda, dtype)
        y = _rand(rng, (v if up else v_coarse, c_out), cuda, dtype)
        got = _twice_same(lambda: tst.strided_dw(x, y, tab, up))
        _close(
            got, tst.strided_dw_plain(x, y, bare, up),
            tst.strided_dw_plain(x.abs(), y.abs(), bare, up), torch.float32, 1e-4,
        )
    suffix = "_wgmma" if route == "wgmma" else "_tf32"
    assert (_build.LAUNCHES["strided_dw"], _build.LAUNCHES["strided_dw" + suffix]) == (4, 4)


def _pixel_ids(rng, p, v):
    """A pixel table's shape: P rows over V >> P segments (~95% empty)."""
    return torch.from_numpy(rng.integers(0, v, p).astype(np.int32)), v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("c", [4, 20, 32, 96, 256])
@pytest.mark.parametrize("shape", ["pixel", "hot_pixel", "long"])
def test_segment_sum_units_on_card(cuda, dtype, weighted, c, shape):
    """K6 in one launch at a pixel table's shape (20x more segments than
    rows: its rows kernel), the same with one pixel of 3000 members, and
    on segments of 4096+ members cut across many units, at the path's
    widths: within 1e-5 of the plain version in f64 (of the sum of
    |terms|), empty segments exactly 0, the same bits on repeat, one
    launch per call."""
    rng = np.random.default_rng(c + 7 * weighted + 13 * ["pixel", "hot_pixel", "long"].index(shape))
    p = 12000
    if shape == "long":
        ids, v = _long_short_ids(rng, p)
    else:
        ids, v = _pixel_ids(rng, p, 20 * p)
        if shape == "hot_pixel":
            ids[:3000] = 77
    assert tvx.segment_sum_by_rows(p, v) == (shape != "long")
    reps = 2 if weighted else 1
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
    counts = tables.counts.to(cuda)
    assert not got[counts == 0].any()
    if shape == "long":
        unit = tvx.segment_sum_plan(c, src.element_size(), src.data_ptr()).unit
        assert int(counts.max()) > 8 * unit


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


def _bilinear_case(dev, dtype, c, misaligned, seed=59):
    """RPVNet's range_to_point on a (2 * 16, 64) canvas: a bilinear table
    of 3000 points with 40 invalid (all corners absent), 40 whose 4
    corners all read one negative pixel row with weight 0 (every product
    and the sum -0), and the rest at random fractions."""
    from taseg_tpu_torch.ops.point_range import range_sample_table

    rng = np.random.default_rng(seed)
    h, w, p = 32, 64, 3000
    pxf = torch.from_numpy(rng.uniform(0, w - 1.001, p).astype(np.float32))
    pyf = torch.from_numpy(rng.uniform(0, h - 1.001, p).astype(np.float32))
    valid = torch.arange(p) >= 40
    tab = range_sample_table(pxf, pyf, valid, h, w)
    idx, wt = tab.idx.clone(), tab.weights.clone()
    idx[:, 40:80], wt[:, 40:80] = 0, 0.0
    table = tvx.DevoxTable(idx=idx.to(dev), weights=wt.to(dev))
    base = _rand(rng, (h * w * c + 1,), dev, dtype)
    img = (base[1:] if misaligned else base[:-1]).view(h * w, c)
    img[0] = -img[0].abs() - 0.5
    return img, table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [32, 96, 19])
@pytest.mark.parametrize("misaligned", [False, True])
def test_devoxelize_bilinear_kernel_bit_identical(cuda, dtype, c, misaligned):
    """K7 at 4 corners (RPVNet's range_to_point) gives its plain version's
    bits, signed zeros included, at the range branch's widths and a
    ragged one, and the same bits on a repeat call; one launch per call,
    counted under `devoxelize` and `devoxelize_bilinear`."""
    img, table = _bilinear_case(cuda, dtype, c, misaligned)
    _build.reset_launches()
    got = _twice_same(lambda: tvx.devoxelize_trilinear(img, table))
    want = tvx._devox_trilinear(img, table)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got[:40]), _bits(torch.zeros_like(got[:40])))
    assert torch.equal(_bits(got[40:80]), _bits(torch.full_like(got[40:80], -0.0)))
    assert (_build.LAUNCHES["devoxelize"], _build.LAUNCHES["devoxelize_bilinear"]) == (2, 2)


def _head_topology(dev, seed=61):
    """A train topology of ~3500 integer points: the head's tables at
    strides 16, 4 (8 corners, fractions in 1/s) and 1 (the identity),
    and their stacked pair table."""
    from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities, build_unet_topology

    rng = np.random.default_rng(seed)
    pts = np.zeros((4096, 4), np.float32)
    rows = np.unique(np.floor(rng.uniform(0, 48, size=(3500, 3))), axis=0)
    pts[: len(rows), :3] = rows
    topo = build_unet_topology(
        torch.from_numpy(pts).to(dev), torch.tensor(len(rows), dtype=torch.int32),
        UNetCapacities.for_points(4096), devox_pairs=True,
    )
    return rng, topo, (topo.devox[16], topo.devox[4], topo.devox[1])


def _table_rows(t):
    return t.tables.counts.shape[0] if isinstance(t, tvx.IdentityDevoxTable) else t.pairs.counts.shape[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "widths,bias", [((20,) * 3, True), ((19,) * 3, True), ((256, 128, 96), False), ((48, 19, 20), False)]
)
def test_devoxelize_multi_bit_identical(cuda, dtype, widths, bias):
    """K7's multi-scale entry, one launch a call: the sum epilogue (the
    head: f32 casts summed in scale order, plus the bias) and the cat
    epilogue (columns), at the head's widths, KD's feature widths and
    ragged ones, give `devox_multi_plain`'s bits and the same bits on a
    repeat call; a negative row read at weight 0 gives -0 as there."""
    rng, topo, tables = _head_topology(cuda)
    feats = [_rand(rng, (_table_rows(t), c), cuda, dtype) for t, c in zip(tables, widths)]
    for f in feats:
        f[0] = -f[0].abs() - 0.5
    b = _rand(rng, (widths[0],), cuda, torch.float32) if bias else None
    _build.reset_launches()
    got = _twice_same(lambda: tvx.devoxelize_multi_kernel(feats, tables, b))
    want = tvx.devox_multi_plain(feats, tables, b)
    assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))
    assert (_build.LAUNCHES["devoxelize"], _build.LAUNCHES["devoxelize_multi"]) == (2, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_k6_backward_on_card(cuda, dtype):
    """The head's backward: K6 once over the stacked pair table, against
    the three per-scale K6 calls within 1e-5 of the largest sum of |terms|
    (a segment's members are summed in another split), the same bits on
    repeat, and one K6 launch in the backward of `devoxelize_multi`."""
    rng, topo, tables = _head_topology(cuda, seed=67)
    st = topo.devox_head
    g = _rand(rng, (tables[2].inverse.shape[0], 20), cuda, dtype)
    got = _twice_same(lambda: tvx.segment_sum(g, st.tables, st.weights)).split(list(st.rows))
    for x, t in zip(got, tables):
        pt, w = tvx._pair_tables(t)
        want = tvx.segment_sum(g, pt, w)
        ref = tvx.segment_sum_plain(g.float().abs(), pt, w.abs()).max()
        assert (x - want).abs().max() <= 1e-5 * ref
    zs = [_rand(rng, (_table_rows(t), 20), cuda, dtype).requires_grad_() for t in tables]
    bias = torch.zeros(20, device=cuda, requires_grad=True)
    out = tvx.devoxelize_multi(zs, tables, bias=bias, stacked=st)
    _build.reset_launches()
    out.backward(g.float())
    assert _build.LAUNCHES["segment_sum"] == 1
    for z, x in zip(zs, torch.cat(got).split(list(st.rows))):
        assert torch.equal(z.grad, x.to(dtype))


@pytest.mark.parametrize("block", ["res_context", "salsa_res", "salsa_up"])
def test_range_blocks_train_backward_card_equals_cpu(cuda, block):
    """RPVNet's range blocks in train mode (dropout off) on the card
    against the CPU on the same NHWC f32 inputs, weights and output
    gradients: outputs, input gradients and parameter gradients within
    1e-4 of their L2 norm (cuDNN sums in another order; TF32 off).  The
    average pool of `SalsaResBlock` runs on an NCHW-contiguous copy: on a
    channels-last input torch's CUDA avg_pool2d backward returned a wrong
    input gradient (tools/range_ops_check.py)."""
    from taseg_tpu_torch.models.range2d import blocks as B

    gen = torch.Generator().manual_seed(3)
    make = {
        "res_context": lambda: B.ResContextBlock(32, 32, device="cpu"),
        "salsa_res": lambda: B.SalsaResBlock(32, 48, drop_out=False, device="cpu"),
        "salsa_up": lambda: B.SalsaUpBlock(64, 16, 32, drop_out=False, device="cpu"),
    }[block]
    m = make().train()
    with torch.no_grad():
        for q in m.parameters():
            q.copy_(torch.randn(q.shape, generator=gen) * 0.1)
    x0 = torch.randn(2, 16, 64, 64 if block == "salsa_up" else 32, generator=gen)
    s0 = torch.randn(2, 32, 128, 16, generator=gen) if block == "salsa_up" else None
    res = {}
    for dev in ("cpu", cuda):
        m.to(dev)
        x = x0.detach().to(dev).clone().requires_grad_()
        args = (x,) if s0 is None else (x, s0.to(dev))
        ys = m(*args)
        ys = ys if isinstance(ys, tuple) else (ys,)
        gs = [torch.randn(y.shape, generator=torch.Generator().manual_seed(4)).to(dev) for y in ys]
        torch.autograd.backward(list(ys), gs)
        res[str(dev)] = [y.detach().cpu() for y in ys] + [x.grad.cpu()] + [q.grad.cpu() for q in m.parameters()]
        m.zero_grad(set_to_none=True)
    for got, want in zip(res["cuda"], res["cpu"]):
        assert (got - want).norm() <= 1e-4 * want.norm()


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


def _voxelize_bwd_case(dev, dtype, c, misaligned, seed=53):
    """g (V, C) and a point -> voxel map with segments of 301 and 257
    members (counts 300 and 256 in bf16), empty voxels, points without a
    voxel and negative zeros in g; `misaligned` starts g 2 or 4 bytes off
    its 16-byte boundary (the kernel's scalar path)."""
    rng = np.random.default_rng(seed)
    v, p = int(rng.integers(300, 2000)), int(rng.integers(3000, 9000))
    inv = rng.integers(2, v, p).astype(np.int32)
    inv[rng.random(p) < 0.05] = -1
    inv[inv == 7] = 5
    inv[:301], inv[301:558] = 0, 1
    base = _rand(rng, (v * c + 1,), dev, dtype)
    g = (base[1:] if misaligned else base[:-1]).view(v, c)
    g[3] = -0.0
    t_inv = torch.from_numpy(inv).to(dev)
    return g, t_inv, tvx.build_segment_tables(t_inv, v)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [32, 19, 256])
@pytest.mark.parametrize("misaligned", [False, True])
def test_voxelize_bwd_kernel_bit_identical(cuda, dtype, c, misaligned):
    """K8 gives the plain version's bits (signed zeros, the bf16 count
    rounding and the +0 rows included), the same bits on a repeat call,
    one launch per call, and the same through the VoxelizeAvg backward."""
    g, inv, tables = _voxelize_bwd_case(cuda, dtype, c, misaligned)
    assert (g.data_ptr() % 16 != 0) == misaligned
    _build.reset_launches()
    got = tvx.voxelize_bwd(g, inv, tables.counts)
    want = tvx._voxelize_bwd_plain(g, inv, tables.counts)
    assert got.dtype == dtype and got.shape == (inv.shape[0], c)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(tvx.voxelize_bwd(g, inv, tables.counts)), _bits(got))
    assert torch.equal(_bits(got[inv < 0]), _bits(torch.zeros_like(got[inv < 0])))
    assert _build.LAUNCHES["voxelize_bwd"] == 2
    f = torch.zeros(inv.shape[0], c, device=cuda, dtype=dtype, requires_grad=True)
    (d,) = torch.autograd.grad(tvx.voxelize_avg(f, inv, tables), f, g)
    assert torch.equal(_bits(d), _bits(want))
    assert _build.LAUNCHES["voxelize_bwd"] == 3


def test_voxelize_bwd_kernel_empty(cuda):
    """P = 0 launches nothing; neither do CPU tensors."""
    g = torch.ones(5, 32, device=cuda)
    counts = torch.ones(5, dtype=torch.int32, device=cuda)
    _build.reset_launches()
    out = tvx.voxelize_bwd(g, torch.zeros(0, dtype=torch.int32, device=cuda), counts)
    assert out.shape == (0, 32)
    tvx.voxelize_bwd(g.cpu(), torch.zeros(3, dtype=torch.int32), counts.cpu())
    assert _build.LAUNCHES["voxelize_bwd"] == 0


def test_spvcnn_small_step_card_equals_cpu(cuda):
    """2 f32 SPVCNN train steps (the tiny recipe's widths, one small
    synthetic scan) on the card and on the CPU: the loss within 1e-4
    relative, the grad norm within 1e-3 and the parameters' updates within
    3e-2 of the update's L2 norm, as chip_smoke.py holds MinkUNet's; K8
    launched 3 times per step on the card."""
    from taseg_tpu_torch.configs import MINKUNET_TINY
    from taseg_tpu_torch.data.synthetic import synthetic_scan
    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

    cfg = {**MINKUNET_TINY, "MODEL": {**MINKUNET_TINY["MODEL"], "NAME": "SPVCNN"}}
    pts, labels = synthetic_scan(np.random.default_rng(7), 4000)
    scan = {"xyzret": np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1), "labels": labels}
    p0, s0 = init_params_numpy(cfg, seed=2)
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, {"params": p0, "batch_stats": s0}, dev, iters_per_epoch=1,
                     total_epochs=4, compute_dtype="float32", point_capacity=4096)
        _build.reset_launches()
        outs = [tr.step([scan]) for _ in range(2)]
        runs[dev] = outs, export_flax_params(tr.model)[0], _build.LAUNCHES["voxelize_bwd"]
    (g_out, g_par, g_k8), (c_out, c_par, c_k8) = runs["cuda"], runs["cpu"]
    assert (g_k8, c_k8) == (6, 0)
    for g, c in zip(g_out, c_out):
        assert g["loss"] == pytest.approx(c["loss"], rel=1e-4)
        assert g["grad_norm"] == pytest.approx(c["grad_norm"], rel=1e-3)

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict) else {pre + k: np.asarray(v, np.float64)})
        return out

    a, b, z = flat(g_par), flat(c_par), flat(p0)
    diff = np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
    upd = np.sqrt(sum(((b[k] - z[k]) ** 2).sum() for k in a))
    assert diff <= 3e-2 * upd, diff / upd


# ------------------------------------------------ the harness on the card
def _harness_trainer(tmp_path, dtype):
    from taseg_tpu_torch.configs import MINKUNET_TINY
    from taseg_tpu_torch.data import build_dataloader
    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    data = {**MINKUNET_TINY["DATA"], "LENGTH": 3}
    cfg = {**MINKUNET_TINY, "DATA": data}
    p, s = init_params_numpy(cfg, seed=2)
    return Trainer(
        cfg, {"params": p, "batch_stats": s}, "cuda", compute_dtype=dtype,
        train_loader=build_dataloader(data, training=True, scans_per_shard=1),
        val_loader=build_dataloader(data, training=False, scans_per_shard=1),
        output_dir=tmp_path, total_epochs=2,
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_harness_resume_bit_exact(cuda, tmp_path, dtype):
    """One epoch through the loader on the card, a checkpoint, and a
    fresh Trainer resumed from it: parameters, BN buffers, momentum
    traces and the schedule's count carry the same bits."""
    a = _harness_trainer(tmp_path, dtype)
    a.train_one_epoch(0)
    a.save_checkpoint(0)
    c = _harness_trainer(tmp_path, dtype)
    assert c.resume_latest() and c.start_epoch == 1
    assert c.optimizer.count == a.optimizer.count == 3
    for (k, x), y in zip(c.model.state_dict().items(), a.model.state_dict().values()):
        assert torch.equal(x, y), k
    for p, q in zip(c.model.parameters(), a.model.parameters()):
        assert torch.equal(c.optimizer.state[p]["trace"], a.optimizer.state[q]["trace"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_harness_eval_equals_segmenter(cuda, tmp_path, dtype):
    """`evaluate_points` on the card writes the logits and labels that
    `Segmenter.predict` gives for the same scans and weights, bit for
    bit, and leaves the model in train mode."""
    from taseg_tpu_torch.data.semantickitti.labels import LEARNING_MAP_LUT
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params

    tr = _harness_trainer(tmp_path, dtype)
    tr.train_one_epoch(0)
    tr.evaluate_points(save_path=tmp_path / "p", save_score=True)
    assert tr.model.training
    p, s = export_flax_params(tr.model)
    seg = Segmenter(tr.cfg, {"params": p, "batch_stats": s}, "cuda", compute_dtype=dtype,
                    point_capacity=tr.val_loader.point_capacity)
    reader = tr.val_loader.reader
    got = seg.predict([reader[i] for i in range(len(reader))])
    for i, o in enumerate(got):
        f = tmp_path / "p" / "sequences" / "08" / "predictions" / f"{i:06d}"
        logits = np.fromfile(f.with_suffix(".bin"), np.float32).reshape(o["logits"].shape)
        assert np.array_equal(logits.view(np.uint32), o["logits"].view(np.uint32))
        raw = np.fromfile(f.with_suffix(".label"), np.uint32)
        np.testing.assert_array_equal(LEARNING_MAP_LUT[raw], o["labels"])


# ------------------------------------ K2 and K4 at K offsets (Cylinder3D)
def _k_tables(dev, kind, seed=61):
    """(rb, rb_bwd, V_in) of a conv over K offsets on a random level:
    `asym9` a (1,3,3) conv on the level (K = 9), `recon3` a (1,1,3) conv
    (K = 3), `head27` the 3^3 conv (K = 27), `down8` / `down4` the pooling conv into the level at step
    (2,2,2) / (2,2,1) (V_in the finer level's rows, V_out the coarser
    one's), `up8` / `up4` its transposed conv (the reverse table)."""
    _, u, num, b = _level(dev, seed=seed)
    if kind == "head27":
        rb = tr.build_rulebook_k3(u, num, 1, b)
        return rb, tsc.flip_rulebook(rb), u.shape[0]
    if kind in ("asym9", "recon3"):
        offs = tr.kernel_offsets((1, 3, 3) if kind == "asym9" else (1, 1, 3))
        rb = tr.build_rulebook(u, num, u, num, offs, b)
        return rb, tsc.flip_rulebook(rb), u.shape[0]
    step = (2, 2, 2) if kind.endswith("8") else (2, 2, 1)
    cu, cn = tr.spdownsample(u, num, step, 1, b, 2048)
    offs = tr.kernel_offsets(step)
    down = tr.build_rulebook(cu, cn, u, num, offs, b)
    up = tr.build_reverse_rulebook(u, num, cu, cn, offs, b)
    return (down, up, u.shape[0]) if kind.startswith("down") else (up, down, cu.shape[0])


K_KINDS = ("asym9", "recon3", "down8", "down4", "up8", "up4")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", K_KINDS)
@pytest.mark.parametrize("c_in,c_out", [(16, 32), (37, 20), (128, 64), (768, 512)])
def test_sparse_conv_k_kernel(cuda, dtype, kind, c_in, c_out):
    """K2 at K offsets against its plain version (f32 within 1e-5 of the
    largest sum of |terms|, bf16 plus one rounding), on both routes; one
    `sparse_conv_k` launch, none under K2's 27-offset counter."""
    rng = np.random.default_rng(c_in + c_out)
    rb, _, v_in = _k_tables(cuda, kind)
    x = _rand(rng, (v_in, c_in), cuda, dtype)
    w = _rand(rng, (rb.shape[0], c_in, c_out), cuda, dtype)
    _build.reset_launches()
    got = tsc.sparse_conv(x, w, rb)
    wg = tsc.route(dtype, c_in, c_out) == "wgmma"
    assert (_build.LAUNCHES["sparse_conv_k"], _build.LAUNCHES["sparse_conv_k_wgmma"]) == (1, int(wg))
    assert _build.LAUNCHES["sparse_conv_k3"] == 0
    assert got.shape == (rb.shape[1], c_out)
    _close(got, tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(x.abs(), w.abs(), rb), dtype, 1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", K_KINDS)
@pytest.mark.parametrize("c_in,c_out", [(16, 32), (37, 20), (768, 512)])
def test_sparse_conv_dw_kernel(cuda, dtype, kind, c_in, c_out):
    """K4 at K offsets against its plain version within 1e-4 of the
    largest sum of |terms|, V_in != V_out for the pooling convs; the same
    bits on a repeat call; one `sparse_conv_dw` launch per call."""
    rng = np.random.default_rng(c_in * 3 + c_out)
    rb, rb_bwd, v_in = _k_tables(cuda, kind)
    x = _rand(rng, (v_in, c_in), cuda, dtype)
    g = _rand(rng, (rb.shape[1], c_out), cuda, dtype)
    _build.reset_launches()
    got = _twice_same(lambda: tf3.sparse_conv_dw(x, g, rb_bwd))
    assert _build.LAUNCHES["sparse_conv_dw"] == 2 and _build.LAUNCHES["k3_conv_dw"] == 0
    assert got.dtype == torch.float32 and got.shape == (rb.shape[0], c_in, c_out)
    _close(got, tf3.k3_conv_dw_plain(x, g, rb_bwd), tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd),
           torch.float32, 1e-4)


@pytest.mark.parametrize("kind", K_KINDS)
def test_conv_k_gradient_card_equals_cpu(cuda, kind):
    """`conv_k`'s autograd Function on the card (K2 at K forward and
    input gradient, K4 at K) against the same on the CPU (the plain
    versions): d_feats within 1e-5 and d_W within 1e-4 of their scale."""
    rng = np.random.default_rng(5)
    rb, rb_bwd, v_in = _k_tables(cuda, kind)
    x0 = rng.normal(size=(v_in, 24)).astype(np.float32)
    w0 = rng.normal(size=(rb.shape[0], 24, 40)).astype(np.float32)
    g0 = rng.normal(size=(rb.shape[1], 40)).astype(np.float32)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        x = torch.tensor(x0, device=dev, requires_grad=True)
        w = torch.tensor(w0, device=dev, requires_grad=True)
        _build.reset_launches()
        out = tsc.conv_k(x, w, rb.to(dev), rb_bwd.to(dev))
        out.backward(torch.tensor(g0, device=dev))
        res[dev.type] = [t.detach().cpu() for t in (out, x.grad, w.grad)], dict(_build.LAUNCHES)
    (got, launches), (want, none) = res["cuda"], res["cpu"]
    assert (launches["sparse_conv_k"], launches["sparse_conv_k_dgrad"], launches["sparse_conv_dw"]) == (2, 1, 1)
    assert not any(none.values())
    for a, b, rel in zip(got, want, (1e-5, 1e-5, 1e-4)):
        assert (a - b).abs().max() <= rel * b.abs().max()


def test_segment_max_card_equals_cpu(cuda):
    """`segment_max` and its gradient on the card against the CPU, with
    ties and empty segments: the same values and the same gradient."""
    rng = np.random.default_rng(3)
    x0 = rng.integers(-3, 3, size=(4000, 16)).astype(np.float32)
    seg0 = rng.integers(0, 1200, 4000)
    res = []
    for dev in (cuda, torch.device("cpu")):
        x = torch.tensor(x0, device=dev, requires_grad=True)
        out = tvx.segment_max(x, torch.tensor(seg0, device=dev), 1300)
        out = torch.where(torch.isfinite(out), out, 0.0)
        (out * torch.arange(16, device=dev)).sum().backward()
        res.append((out.detach().cpu(), x.grad.cpu()))
    assert torch.equal(res[0][0], res[1][0]) and torch.equal(res[0][1], res[1][1])


TF32_KINDS = K_KINDS + ("head27",)
TF32_WIDTHS = [(16, 32), (768, 512), (128, 20)]


@pytest.mark.parametrize("kind", TF32_KINDS)
@pytest.mark.parametrize("c_in,c_out", TF32_WIDTHS)
def test_sparse_conv_k_tf32_kernel(cuda, kind, c_in, c_out):
    """K2 at K offsets on its 3xTF32 route (K = 9, 3, 8, 4, 27; f32)
    against its plain version within 1e-5 of the largest sum of |terms|;
    the same bits on repeat and with the order given; one
    `sparse_conv_k_tf32` launch per call, none on another route."""
    rng = np.random.default_rng(c_in + 7 * c_out)
    rb, _, v_in = _k_tables(cuda, kind)
    x = _rand(rng, (v_in, c_in), cuda, torch.float32)
    w = _rand(rng, (rb.shape[0], c_in, c_out), cuda, torch.float32)
    assert tsc.k_route(torch.float32, c_in, c_out) == "tf32x3"
    _build.reset_launches()
    got = _twice_same(lambda: tsc.sparse_conv(x, w, rb))
    assert torch.equal(got, tsc.sparse_conv(x, w, rb, order=tsc.mask_row_order(rb)))
    L = _build.LAUNCHES
    assert (L["sparse_conv_k"], L["sparse_conv_k_tf32"], L["sparse_conv_k_wgmma"], L["sparse_conv_k3"]) == (3, 3, 0, 0)
    _close(got, tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(x.abs(), w.abs(), rb), torch.float32, 1e-5)


@pytest.mark.parametrize("kind", TF32_KINDS)
@pytest.mark.parametrize("c_in,c_out", TF32_WIDTHS)
def test_sparse_conv_dw_tf32_kernel(cuda, kind, c_in, c_out):
    """K4 at K offsets on its 3xTF32 route over `pair_lists(rb_bwd)`
    against its plain version within 1e-4 of the largest sum of |terms|;
    the same bits on repeat and with the lists given; one
    `sparse_conv_dw_tf32` launch per call."""
    rng = np.random.default_rng(c_in * 5 + c_out)
    rb, rb_bwd, v_in = _k_tables(cuda, kind)
    x = _rand(rng, (v_in, c_in), cuda, torch.float32)
    g = _rand(rng, (rb.shape[1], c_out), cuda, torch.float32)
    _build.reset_launches()
    got = _twice_same(lambda: tf3.sparse_conv_dw(x, g, rb_bwd))
    assert torch.equal(got, tf3.sparse_conv_dw(x, g, rb_bwd, pairs=tf3.pair_lists(rb_bwd)))
    L = _build.LAUNCHES
    assert (L["sparse_conv_dw"], L["sparse_conv_dw_tf32"], L["k3_conv_dw"]) == (3, 3, 0)
    assert got.shape == (rb.shape[0], c_in, c_out)
    _close(got, tf3.k3_conv_dw_plain(x, g, rb_bwd), tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd),
           torch.float32, 1e-4)


@pytest.mark.parametrize("k", [3, 4, 8, 9, 27])
@pytest.mark.parametrize("case", ["ragged", "empty", "one_row", "tall"])
def test_k_offsets_tf32_edges(cuda, k, case):
    """Both 3xTF32 entries at V_out = 1000 and V_in = 777 (ragged tiles;
    ~2/3 of the entries present), at a table with no present entry (zeros
    out, every tile empty), and at one output row (a one-row tile); 128 ->
    20, 16 -> 32 and 768 -> 32 on the same table, the same bits on
    repeat.  These tables have at most `K_SPLIT_ROWS` output rows, so K2
    cuts each tile's chain into `k_splits` parts; `tall` (40 000 output
    rows over 5000) runs it uncut."""
    rng = np.random.default_rng(k)
    v_in, v_out = {"ragged": (777, 1000), "empty": (300, 200), "one_row": (50, 1), "tall": (5000, 40000)}[case]
    assert tsc.k_splits(v_out) == (1 if case == "tall" else tsc.K_SPLITS)
    rb = rng.integers(0, v_in, (k, v_out))
    rb[rng.random((k, v_out)) < (1.0 if case == "empty" else 0.35)] = -1
    rb = torch.tensor(rb, dtype=torch.int32, device=cuda)
    rb_bwd = torch.full((k, v_in), -1, dtype=torch.int32, device=cuda)  # one pair per input row
    kk, vv = torch.nonzero(rb >= 0, as_tuple=True)
    rb_bwd[kk, rb[kk, vv].long()] = vv.int()
    keep = rb_bwd >= 0
    rb = torch.full_like(rb, -1)
    kk, ii = torch.nonzero(keep, as_tuple=True)
    rb[kk, rb_bwd[kk, ii].long()] = ii.int()
    for c_in, c_out in ((128, 20), (16, 32), (768, 32)):
        x = _rand(rng, (v_in, c_in), cuda, torch.float32)
        w = _rand(rng, (k, c_in, c_out), cuda, torch.float32)
        g = _rand(rng, (v_out, c_out), cuda, torch.float32)
        _build.reset_launches()
        out = _twice_same(lambda: tsc.sparse_conv(x, w, rb))
        dw = _twice_same(lambda: tf3.sparse_conv_dw(x, g, rb_bwd))
        assert (_build.LAUNCHES["sparse_conv_k_tf32"], _build.LAUNCHES["sparse_conv_dw_tf32"]) == (2, 2)
        if case == "empty":
            assert not out.any() and not dw.any()
        _close(out, tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(x.abs(), w.abs(), rb), torch.float32, 1e-5)
        _close(dw, tf3.k3_conv_dw_plain(x, g, rb_bwd), tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd),
               torch.float32, 1e-4)


def test_cylinder_small_step_card_equals_cpu(cuda):
    """2 f32 Cylinder_TS train steps (the tiny recipe: INIT_SIZE 4, a 64 x
    64 x 16 grid, one synthetic scan) on the card and on the CPU: the
    loss within 1e-4 relative, the grad norm within 1e-3 and the updates
    within 3e-2 of the update's L2 norm; per step 48 K2-at-K forwards and
    48 input gradients, 48 K4-at-K calls (the 3^3 head's among them), all
    on the 3xTF32 route, and no 27-offset launch."""
    from taseg_tpu_torch.configs import CYLINDER_TINY
    from taseg_tpu_torch.data.synthetic import synthetic_scan
    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

    cfg = CYLINDER_TINY
    pts, labels = synthetic_scan(np.random.default_rng(7), 4000)
    scan = {"xyzret": np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1), "labels": labels}
    p0, s0 = init_params_numpy(cfg, seed=2)
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, {"params": p0, "batch_stats": s0}, dev, iters_per_epoch=1,
                     total_epochs=4, point_capacity=4096)
        _build.reset_launches()
        outs = [tr.step([scan]) for _ in range(2)]
        runs[dev] = outs, export_flax_params(tr.model)[0], dict(_build.LAUNCHES)
    (g_out, g_par, g_n), (c_out, c_par, c_n) = runs["cuda"], runs["cpu"]
    assert not any(c_n.values())
    want = {"sparse_conv_k": 192, "sparse_conv_k_dgrad": 96, "sparse_conv_dw": 96,
            "sparse_conv_k_tf32": 192, "sparse_conv_k_dgrad_tf32": 96, "sparse_conv_dw_tf32": 96,
            "sparse_conv_k3": 0, "sparse_conv_k3_dgrad": 0, "k3_conv_dw": 0}
    assert {k: g_n[k] for k in want} == want
    for g, c in zip(g_out, c_out):
        assert g["loss"] == pytest.approx(c["loss"], rel=1e-4)
        assert g["grad_norm"] == pytest.approx(c["grad_norm"], rel=1e-3)

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict) else {pre + k: np.asarray(v, np.float64)})
        return out

    a, b, z = flat(g_par), flat(c_par), flat(p0)
    diff = np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
    upd = np.sqrt(sum(((b[k] - z[k]) ** 2).sum() for k in a))
    assert diff <= 3e-2 * upd, diff / upd


# ------------------------------------------- TASeg's temporal stages (FSA, KD)
def _flat_params(t, pre=""):
    out = {}
    for k, v in t.items():
        out.update(_flat_params(v, pre + k + "/") if isinstance(v, dict) else {pre + k: np.asarray(v, np.float64)})
    return out


@pytest.mark.parametrize("kd", [False, True])
def test_fsa_and_kd_small_steps_card_equal_cpu(cuda, kd):
    """2 f32 steps of the tiny FSA recipe (MinkUNetMs, 5 input features,
    one synthetic fused cloud) or of the tiny KD recipe (MinkUNetMsKd with
    a teacher of other weights) on the card and on the CPU: the losses
    (and for KD loss_seg and loss_feat_kd) within 1e-4 relative, the grad
    norm within 1e-3 and the parameters' updates within 3e-2 of the
    update's L2 norm, as chip_smoke.py holds MinkUNet's step; the KD
    teacher unchanged on the card."""
    from taseg_tpu_torch.configs import MINKUNET_MS_KD_TINY, MINKUNET_MS_TINY
    from taseg_tpu_torch.data.synthetic import SyntheticMsKittiReader
    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

    base = MINKUNET_MS_KD_TINY if kd else MINKUNET_MS_TINY
    cfg = {**base, "MODEL": {**base["MODEL"], "CAPACITY_SCHEDULE": (1.0,) * 5}}
    scan = SyntheticMsKittiReader(length=1, n_points=2000, kd=True)[0]
    p0, s0 = init_params_numpy(cfg, seed=2)
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, {"params": p0, "batch_stats": s0}, dev, iters_per_epoch=1,
                     total_epochs=4, compute_dtype="float32", point_capacity=8192)
        if kd:
            tr.set_teacher(*init_params_numpy(cfg, seed=3))
            before = {k: v.clone() for k, v in tr.teacher.state_dict().items()}
        outs = [tr.step([scan]) for _ in range(2)]
        if kd:
            assert all(torch.equal(v, before[k]) for k, v in tr.teacher.state_dict().items())
        runs[dev] = outs, export_flax_params(tr.model)[0]
    (g_out, g_par), (c_out, c_par) = runs["cuda"], runs["cpu"]
    for g, c in zip(g_out, c_out):
        for k in ("loss", "loss_seg", "loss_feat_kd") if kd else ("loss",):
            assert g[k] == pytest.approx(c[k], rel=1e-4), k
        assert g["grad_norm"] == pytest.approx(c["grad_norm"], rel=1e-3)
    a, b, z = _flat_params(g_par), _flat_params(c_par), _flat_params(p0)
    diff = np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
    upd = np.sqrt(sum(((b[k] - z[k]) ** 2).sum() for k in a))
    assert diff <= 3e-2 * upd, diff / upd


# ------------------------------------------------------------ the range view
def _knn_case(case: str, seed: int = 0):
    """(proj_range (B, H, W), unproj, labels (B, H, W), px, py, img) of 3
    images of 16 x 48 with 700 points each: random ranges with empty
    pixels, or every distance 0 ('ties'), or labels all 0 ('class0');
    'beam': two images of 64 x 512 with 60 000 points each in beam order
    (sorted by image, row, column; one block spans the two images),
    labels outside [0, 20) planted; 'scattered': one 64 x 512 image,
    its points shuffled; 'edges': the points on the two rows and
    columns at each edge of the image, the column seam (columns W - 1 and
    0) among them, in beam order."""
    rng = np.random.default_rng(seed)
    b, h, w, p = {"beam": (2, 64, 512, 60_000), "scattered": (1, 64, 512, 120_000)}.get(case, (3, 16, 48, 700))
    r = rng.uniform(0.5, 4.0, (b, h, w)).astype(np.float32)
    r[rng.random((b, h, w)) < 0.3] = 0.0
    lab = rng.integers(0, 20, (b, h, w)).astype(np.int32)
    img = np.repeat(np.arange(b), p).astype(np.int32)
    px = rng.integers(0, w, b * p).astype(np.int32)
    py = rng.integers(0, h, b * p).astype(np.int32)
    if case == "edges":
        px = rng.choice([0, 1, w - 2, w - 1], b * p).astype(np.int32)
        py = np.where(rng.random(b * p) < 0.5, rng.choice([0, 1, h - 2, h - 1], b * p), py).astype(np.int32)
    if case in ("beam", "edges"):
        o = np.lexsort((px, py, img))
        px, py = px[o], py[o]
    if case == "beam":
        lab[rng.random((b, h, w)) < 0.01] = -1
        lab[rng.random((b, h, w)) < 0.01] = 300
    u = (r[img, py, px] + rng.normal(0, 0.5, b * p)).astype(np.float32)
    if case in ("ties", "class0"):
        r, u = np.ones_like(r), np.ones_like(u)
    if case == "class0":
        lab[:] = 0
    return r, u, lab, px, py, img


@pytest.mark.parametrize("case", ["random", "ties", "class0", "beam", "scattered", "edges"])
def test_knn_kernel_equals_plain(cuda, case):
    """K9 (one launch) gives its plain version's labels exactly, and the
    same bits on repeat; so does its first design (the yardstick)."""
    from taseg_tpu_torch.ops.knn import knn_postprocess, knn_postprocess_v1

    args = [torch.from_numpy(a) for a in _knn_case(case)]
    want = knn_postprocess(*args, num_classes=20)
    before = _build.LAUNCHES["knn"]
    got = knn_postprocess(*(a.to(cuda) for a in args), num_classes=20)
    again = knn_postprocess(*(a.to(cuda) for a in args), num_classes=20)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["knn"] == before + 2
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), want) and torch.equal(got, again)
    assert torch.equal(knn_postprocess_v1(*(a.to(cuda) for a in args), num_classes=20).cpu(), want)


@pytest.mark.parametrize("name", ["SalsaNext", "FIDNet", "CENet", "RangeNet"])
def test_range_models_card_equal_cpu(cuda, name):
    """Each range model (SalsaNext and RangeNet narrow, 16 x 64 images,
    batch 2), card against CPU (the NHWC views' convs, pools, transposed
    convs and bilinear resizes, forward and backward): eval logits within
    1e-4 of their scale; in train mode (dropout off) the gradients of a
    seeded cotangent, all parameters together, within 5e-2 of their L2
    norm.  The train-mode gradients are discontinuous (leaky ReLU's kink,
    batch statistics over as few as 32 values, conv biases before a BN
    whose exact gradient is 0): on the CPU alone a 1e-7 relative change
    of the input moves them by 1.7e-5 (SalsaNext), 1.1e-2 (CENet),
    4.6e-3 (FIDNet) and 3.6e-3 (RangeNet) of their norm, and single
    entries by up to 49%.  A wrong backward (as torch's CUDA avg_pool2d
    on a channels-last view, 104% off) is far outside."""
    from torch_range_narrow import narrow_range_models

    from taseg_tpu_torch.models.layers import Dropout
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy, load_flax_params

    cfg = {"MODEL": {"NAME": name, "NUM_CLASS": 20}}
    narrow = narrow_range_models(SalsaNext={"base": 8}, RangeNet={"base": 8, "layers": (1, 1, 2, 2, 1)})
    with narrow as build:
        p, s = init_params_numpy(cfg, seed=1)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 16, 64, 6)).astype(np.float32)
    ct = rng.normal(size=(2, 16, 64, 20)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        m = build(cfg, device=dev)
        load_flax_params(m, p, s)
        for mod in m.modules():
            if isinstance(mod, Dropout):
                mod.rate = 0.0
        with torch.no_grad():
            ev = m.eval()(torch.from_numpy(x).to(dev)).cpu()
        y = m.train()(torch.from_numpy(x).to(dev))
        y = y[0] if isinstance(y, tuple) else y
        (y * torch.from_numpy(ct).to(dev)).sum().backward()
        out[dev] = ev, {k: q.grad.cpu() for k, q in m.named_parameters() if q.grad is not None}
    (ge, gg), (ce, cg) = out["cuda"], out["cpu"]
    assert (ge - ce).abs().max() <= 1e-4 * max(ce.abs().max(), 1.0)
    assert gg.keys() == cg.keys()
    diff = sum(float(((gg[k] - cg[k]) ** 2).sum()) for k in cg) ** 0.5
    norm = sum(float((cg[k] ** 2).sum()) for k in cg) ** 0.5
    assert diff <= 5e-2 * norm, diff / norm


# ------------------------------------------------------ nuScenes and Waymo
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [17, 23])
def test_head_k7_at_nuscenes_and_waymo_classes(cuda, dtype, c):
    """K7's multi-scale entry as the MinkUNet head calls it at nuScenes'
    17 and Waymo's 23 classes (bf16 rows of 34 and 46 bytes: 2-byte
    pieces): `devox_multi_plain`'s bits, signed zeros included, and the
    same bits on repeat, in one launch."""
    rng, topo, tables = _head_topology(cuda, seed=c)
    feats = [_rand(rng, (_table_rows(t), c), cuda, dtype) for t in tables]
    for f in feats:
        f[0] = -f[0].abs() - 0.5
    b = _rand(rng, (c,), cuda, torch.float32)
    _build.reset_launches()
    got = _twice_same(lambda: tvx.devoxelize_multi_kernel(feats, tables, b))
    want = tvx.devox_multi_plain(feats, tables, b)
    assert got.shape[1] == c and torch.equal(_bits(got), _bits(want))
    assert _build.LAUNCHES["devoxelize_multi"] == 2


@pytest.mark.parametrize("dataset", ["nuscenes", "waymo"])
def test_nuscenes_and_waymo_scans_card_equal_cpu(cuda, dataset, tmp_path):
    """One scan of each dataset's reader (trees of `torch_nuscenes_fixture`)
    through `Segmenter.predict` of its recipe at a narrow width (cr 0.25),
    f32, on the card and on the CPU: logits within 1e-3 of their scale."""
    from torch_nuscenes_fixture import make_nuscenes_root, make_waymo_root

    from taseg_tpu_torch.configs import RECIPES
    from taseg_tpu_torch.data import build_reader
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    if dataset == "nuscenes":
        root = make_nuscenes_root(tmp_path, cameras=False)
        cfg = RECIPES["tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa.yaml"]
    else:
        root = make_waymo_root(tmp_path)
        cfg = RECIPES["tools/cfgs/voxel/waymo/minkunet_mk34_cr10.yaml"]
    cfg = {**cfg, "DATA": {**cfg["DATA"], "DATA_PATH": str(root)},
           "MODEL": {**cfg["MODEL"], "cr": 0.25, "CAPACITY_SCHEDULE": (1.0,) * 5}}
    reader = build_reader(cfg["DATA"], False)
    scan = reader[len(reader) - 1]
    p, s = init_params_numpy(cfg, seed=5)
    out = {dev: Segmenter(cfg, {"params": p, "batch_stats": s}, dev, compute_dtype="float32",
                          point_capacity=16384).predict([scan])[0]["logits"]
           for dev in ("cuda", "cpu")}
    assert out["cpu"].shape == (len(scan["xyzret"]), cfg["MODEL"]["NUM_CLASS"])
    scale = max(1.0, float(np.abs(out["cpu"]).max()))
    assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-3 * scale


# ------------------------------------------------ ragged widths (cr 1.6)
# every distinct (C_in, C_out) of MinkUNet / SPVCNN mk34 cr 1.6's convs
# (int(1.6 x PLANES): 51, 102, 204, 409, 153; the decoder's 613 and 306):
# the 3^3 convs (the 4-wide stem and the _xyz recipe's 3-wide one among
# them), the strided down and up convs.  None is a multiple of 8: the
# wrappers pad them to one and take the tensor-core routes
CR16_K3 = [
    (3, 51), (4, 51), (51, 51), (51, 102), (102, 102), (102, 204), (153, 153), (204, 153),
    (204, 204), (204, 409), (306, 204), (409, 409), (613, 409),
]
CR16_DOWN = [(51, 51), (102, 102), (204, 204)]
CR16_UP = [(153, 153), (204, 153), (409, 204), (409, 409)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out", CR16_K3)
def test_cr16_k3_padded_routes(cuda, dtype, c_in, c_out):
    """The 3^3 conv at cr 1.6's widths on its padded tensor-core route:
    bf16 K2 at 27 on wgmma (forward, and on W^T as the input gradient),
    f32 K2 at K = 27 on 3xTF32 (`k3_conv`'s f32 route); K4 (bf16, wgmma)
    and K4 at K (f32, 3xTF32) for d_W within 1e-4; outputs contiguous at
    the logical widths, no CUDA-core launch, the same bits on repeat."""
    rng, u, num, b = _level(cuda, seed=c_in + c_out)
    rb = tr.build_rulebook_k3(u, num, 1, b)
    rb_bwd = tsc.flip_rulebook(rb)
    v = u.shape[0]
    x, g = _rand(rng, (v, c_in), cuda, dtype), _rand(rng, (v, c_out), cuda, dtype)
    w = _rand(rng, (27, c_in, c_out), cuda, dtype) / np.sqrt(27 * c_in)
    w_t = w.transpose(1, 2).contiguous()
    _build.reset_launches()
    if dtype == torch.bfloat16:
        fwd = _twice_same(lambda: tsc.sparse_conv_k3(x, w, rb))
        dx = tsc.sparse_conv_k3(g, w_t, rb_bwd, dgrad=True)
        dw = _twice_same(lambda: tf3.k3_conv_dw(x, g, rb_bwd))
        L = _build.LAUNCHES
        assert (L["sparse_conv_k3"], L["sparse_conv_k3_wgmma"], L["k3_conv_dw"], L["k3_conv_dw_wgmma"]) == (3, 3, 2, 2)
    else:
        fwd = _twice_same(lambda: tsc.sparse_conv(x, w, rb))
        dx = tsc.sparse_conv(g, w_t, rb_bwd, dgrad=True)
        dw = _twice_same(lambda: tf3.sparse_conv_dw(x, g, rb_bwd))
        L = _build.LAUNCHES
        assert (L["sparse_conv_k"], L["sparse_conv_k_tf32"], L["sparse_conv_dw"], L["sparse_conv_dw_tf32"]) == (3, 3, 2, 2)
        assert L["sparse_conv_k3"] == 0
    for t, shape in ((fwd, (v, c_out)), (dx, (v, c_in)), (dw, (27, c_in, c_out))):
        assert t.shape == shape and t.is_contiguous()
    _close(fwd, tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(x.abs(), w.abs(), rb), dtype, 1e-5)
    _close(dx, tsc.sparse_conv_plain(g, w_t, rb_bwd), tsc.sparse_conv_plain(g.abs(), w_t.abs(), rb_bwd), dtype, 1e-5)
    _close(dw, tf3.k3_conv_dw_plain(x, g, rb_bwd), tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd), torch.float32, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c_in,c_out", CR16_DOWN + CR16_UP)
def test_cr16_strided_padded_routes(cuda, dtype, c_in, c_out):
    """K3-down over a one-round child table, K3-up over the up table (and
    each on W^T as the other's input gradient) and K5 both ways at cr
    1.6's strided widths, padded: wgmma in bf16, 3xTF32 in f32; no
    CUDA-core launch."""
    rng, v_fine, tab, _ = _down_case(cuda, "path")
    v_coarse = tab.starts.shape[0] - 1
    child = tst.slot_child_table(tab, rounds=1)
    tab = replace(tab, child=child, child_order=tsc.mask_row_order(child[0]),
                  up=tst.slot_up_table(tab), pairs=tst.slot_pair_lists(tab))
    w = _rand(rng, (8, c_in, c_out), cuda, dtype) / np.sqrt(8 * c_in)
    xf, xc = _rand(rng, (v_fine, c_in), cuda, dtype), _rand(rng, (v_coarse, c_in), cuda, dtype)
    gf, gc = _rand(rng, (v_fine, c_out), cuda, dtype), _rand(rng, (v_coarse, c_out), cuda, dtype)
    tc_ = "_wgmma" if dtype == torch.bfloat16 else "_tf32"
    _build.reset_launches()
    down = _twice_same(lambda: tst.downsample_conv_apply(xf, w, tab))
    up = _twice_same(lambda: tst.upsample_conv_apply(xc, w, tab))
    _close(down, tst.downsample_conv_slot_plain(xf, w, child), tst.downsample_conv_slot_plain(xf.abs(), w.abs(), child), dtype, 1e-5)
    _close(up, tst.upsample_conv_plain(xc, w, tab), tst.upsample_conv_plain(xc.abs(), w.abs(), tab), dtype, 1e-5)
    for x, y, is_up in ((xf, gc, False), (xc, gf, True)):
        got = _twice_same(lambda: tst.strided_dw(x, y, tab, is_up))
        assert got.shape == (8, c_in, c_out) and got.is_contiguous()
        _close(got, tst.strided_dw_plain(x, y, tab, is_up), tst.strided_dw_plain(x.abs(), y.abs(), tab, is_up), torch.float32, 1e-4)
    L = _build.LAUNCHES
    assert (L["strided_down"], L["strided_down" + tc_], L["strided_up"], L["strided_up" + tc_]) == (2, 2, 2, 2)
    assert (L["strided_dw"], L["strided_dw" + tc_]) == (4, 4)


@pytest.mark.parametrize("kind", ["head27", "down8"])
@pytest.mark.parametrize("c_in,c_out", [(128, 23), (5, 32), (3, 51)])
def test_cr16_k_offsets_padded_tf32(cuda, kind, c_in, c_out):
    """K2 and K4 at K offsets in f32 at ragged widths (Waymo Cylinder's
    128 -> 23 head, TIAF's 5-wide stem, a 3-wide one) on 3xTF32 at widths
    padded to multiples of 4: within 1e-5 / 1e-4 of their plain versions,
    the same bits on repeat, no CUDA-core launch."""
    rng = np.random.default_rng(c_in + c_out)
    rb, rb_bwd, v_in = _k_tables(cuda, kind)
    x = _rand(rng, (v_in, c_in), cuda, torch.float32)
    w = _rand(rng, (rb.shape[0], c_in, c_out), cuda, torch.float32)
    g = _rand(rng, (rb.shape[1], c_out), cuda, torch.float32)
    _build.reset_launches()
    got = _twice_same(lambda: tsc.sparse_conv(x, w, rb))
    dw = _twice_same(lambda: tf3.sparse_conv_dw(x, g, rb_bwd))
    L = _build.LAUNCHES
    assert (L["sparse_conv_k"], L["sparse_conv_k_tf32"], L["sparse_conv_dw"], L["sparse_conv_dw_tf32"]) == (2, 2, 2, 2)
    assert got.shape == (rb.shape[1], c_out) and dw.shape == (rb.shape[0], c_in, c_out)
    _close(got, tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(x.abs(), w.abs(), rb), torch.float32, 1e-5)
    _close(dw, tf3.k3_conv_dw_plain(x, g, rb_bwd), tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd), torch.float32, 1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cr16_gradients_through_the_padded_functions(cuda, dtype):
    """The autograd Functions at ragged widths, where each pads its input
    once and saves it so, and its backward pads the cotangent once for the
    input and the weight gradient: the 3^3 conv 51 -> 23 (K3Conv in bf16,
    SparseConvK at K = 27 in f32) and the strided pair 51 -> 102 both
    ways; output, d_feats and d_W at their logical widths against the
    plain versions on the same tensors (the convs within 1e-5 of the
    largest sum of |terms|, d_W within 1e-4; bf16 plus one rounding)."""
    rng, u, num, b = _level(cuda, seed=51)
    rb = tr.build_rulebook_k3(u, num, 1, b)
    rb_bwd = tsc.flip_rulebook(rb)
    _, v_fine, tab, _ = _down_case(cuda, "path")
    v_coarse = tab.starts.shape[0] - 1
    child = tst.slot_child_table(tab, rounds=1)
    tab = replace(tab, child=child, child_order=tsc.mask_row_order(child[0]),
                  up=tst.slot_up_table(tab), pairs=tst.slot_pair_lists(tab))

    def k3(x, w, g):
        return (tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(g, w.transpose(1, 2).contiguous(), rb_bwd),
                tf3.k3_conv_dw_plain(x, g, rb_bwd))

    def down(x, w, g):
        return (tst.downsample_conv_slot_plain(x, w, child), tst.upsample_conv_plain(g, w.transpose(1, 2).contiguous(), tab),
                tst.strided_dw_plain(x, g, tab, False))

    def up(x, w, g):
        return (tst.upsample_conv_plain(x, w, tab), tst.downsample_conv_slot_plain(g, w.transpose(1, 2).contiguous(), child),
                tst.strided_dw_plain(x, g, tab, True))

    cases = (
        (lambda x, w: tsc.k3_conv(x, w, rb, rb_bwd), k3, u.shape[0], u.shape[0], 27, 51, 23),
        (lambda x, w: tst.downsample_conv(x, w, tab), down, v_fine, v_coarse, 8, 51, 102),
        (lambda x, w: tst.upsample_conv(x, w, tab), up, v_coarse, v_fine, 8, 51, 102),
    )
    for conv, plain, v_in, v_out, k, c_in, c_out in cases:
        x = _rand(rng, (v_in, c_in), cuda, dtype).requires_grad_()
        w = (_rand(rng, (k, c_in, c_out), cuda, dtype) / np.sqrt(k * c_in)).requires_grad_()
        g = _rand(rng, (v_out, c_out), cuda, dtype)
        _build.reset_launches()
        out = conv(x, w)
        out.backward(g)
        L = _build.LAUNCHES
        bases = ("sparse_conv_k3", "sparse_conv_k", "strided_down", "strided_up", "k3_conv_dw", "sparse_conv_dw",
                 "strided_dw")
        assert all(L[n] == L.get(n + "_wgmma", 0) + L.get(n + "_tf32", 0) for n in bases), dict(L)  # no CUDA core
        assert L["k3_conv_dw" if dtype == torch.bfloat16 else "sparse_conv_dw"] + L["strided_dw"] == 1
        with torch.no_grad():
            want = plain(x, w, g)
            ref = plain(x.abs(), w.abs(), g.abs())
        for got, shape, wt, rl, rf, dt in zip(
            (out.detach(), x.grad, w.grad), ((v_out, c_out), (v_in, c_in), (k, c_in, c_out)),
            want, (1e-5, 1e-5, 1e-4), ref, (dtype, dtype, dtype),
        ):
            assert got.shape == shape and got.is_contiguous() and got.dtype == dtype
            _close(got, wt, rf, dt, rl)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [409, 204, 153])
def test_cr16_point_widths_k6_k7_k8(cuda, dtype, c):
    """SPVCNN cr 1.6's point widths: K6 (the re-voxelize and the devox
    backward, on a copy padded to 16-byte pieces at 409) within 1e-5 of its plain version
    in f64, K7 (the trilinear devoxelize) and K8 (the voxelize mean's
    gradient) bit-identical to theirs."""
    rng, u, num, tab = _trilinear(cuda)
    p = u.shape[0]
    ids = torch.from_numpy(rng.integers(-1, 700, p).astype(np.int32)).to(cuda)
    seg = tvx.build_segment_tables(ids, 1024)
    src = _rand(rng, (p, c), cuda, dtype)
    for tables, wt in ((seg, None), (tab.pairs, tab.weights.reshape(-1))):
        got = _twice_same(lambda: tvx.segment_sum(src, tables, wt))
        want = tvx.segment_sum_plain(src.double(), tables, None if wt is None else wt.double())
        ref = tvx.segment_sum_plain(src.double().abs(), tables, None if wt is None else wt.double().abs())
        _close(got, want, ref, torch.float32, 1e-5)
    vox, tri, _ = _devox_case(cuda, dtype, c, False)
    assert torch.equal(_bits(tvx.devoxelize_trilinear(vox, tri)), _bits(tvx._devox_trilinear(vox, tri)))
    g, inv, t = _voxelize_bwd_case(cuda, dtype, c, False)
    assert torch.equal(_bits(tvx.voxelize_bwd(g, inv, t.counts)), _bits(tvx._voxelize_bwd_plain(g, inv, t.counts)))


@pytest.mark.parametrize("name", ["minkunet", "spvcnn"])
def test_cr16_narrow_scan_card_equals_cpu(cuda, name):
    """A narrow cr 1.6 MinkUNet and SPVCNN (`torch_cr16_narrow`: widths
    12 ... 102, none a multiple of 8) on one synthetic scan through
    `Segmenter.predict`, f32 on the card against the CPU: logits within
    1e-3 of their scale; every 3^3 conv on K2 at K (3xTF32), none on K2
    at 27; in bf16 every K2 at 27 on wgmma."""
    from torch_cr16_narrow import CR16_RECIPES, narrow_cr16

    from taseg_tpu_torch.data.synthetic import synthetic_scan
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    path = CR16_RECIPES[0 if name == "minkunet" else 3]
    cfg = narrow_cr16(path, CAPACITY_SCHEDULE=(1.0,) * 5)
    pts, labels = synthetic_scan(np.random.default_rng(9), 4000)
    scan = {"xyzret": np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1), "labels": labels}
    p, s = init_params_numpy(cfg, seed=3)
    out = {}
    for dev in ("cuda", "cpu"):
        _build.reset_launches()
        out[dev] = Segmenter(cfg, {"params": p, "batch_stats": s}, dev, compute_dtype="float32",
                             point_capacity=4096).predict([scan])[0]["logits"]
        if dev == "cuda":
            assert _build.LAUNCHES["sparse_conv_k3"] == 0
            assert _build.LAUNCHES["sparse_conv_k"] == _build.LAUNCHES["sparse_conv_k_tf32"] == 18
    scale = max(1.0, float(np.abs(out["cpu"]).max()))
    assert np.abs(out["cuda"] - out["cpu"]).max() <= 1e-3 * scale
    _build.reset_launches()
    Segmenter(cfg, {"params": p, "batch_stats": s}, "cuda", compute_dtype="bfloat16",
              point_capacity=4096).predict([scan])
    assert _build.LAUNCHES["sparse_conv_k3"] == _build.LAUNCHES["sparse_conv_k3_wgmma"] == 18


# ------------------------------------------ 3xTF32 on wgmma; K8's layouts
# f32 (C_in, C_out) of the recipes' K2-at-K and K3 calls: Cylinder's 32-512
# (its convs reach 512 -> 512), TIAF's main branch (96 and 128 -> 96), the
# heads' 128 -> 20 and Waymo's 128 -> 23 (padded to 24), and ragged widths
# padded to 4s (the stems' C_in 5 and 84, 51 -> 102)
TF32_WGMMA_WIDTHS = [
    (32, 32), (32, 64), (64, 128), (128, 128), (128, 256), (256, 512), (512, 512), (512, 256),
    (96, 96), (128, 96), (128, 20), (128, 23), (5, 32), (84, 32), (51, 102),
]


@pytest.mark.parametrize("kind", ("asym9", "recon3", "down8", "up4", "head27"))
@pytest.mark.parametrize("c_in,c_out", TF32_WGMMA_WIDTHS)
def test_tf32_wgmma_k2_at_k_both_ways(cuda, kind, c_in, c_out):
    """K2 at K on the 3xTF32 wgmma tile: the forward (W as stored, which
    the launch splits and transposes) and the input gradient (W^T handed
    as a transposed view of W, read as W is stored) within 1e-5 of the
    largest sum of |terms| of the plain version and the same bits on
    repeat, with the table's chains cut (`k_splits`) and uncut; one
    `sparse_conv_k_tf32` launch a call, none on another route."""
    rng = np.random.default_rng(c_in * 1000 + c_out)
    rb, rb_bwd, v_in = _k_tables(cuda, kind)
    k, v_out = rb.shape
    x = _rand(rng, (v_in, c_in), cuda, torch.float32)
    w = _rand(rng, (k, c_in, c_out), cuda, torch.float32)
    g = _rand(rng, (v_out, c_out), cuda, torch.float32)
    w_t = w.transpose(1, 2)
    assert not w_t.is_contiguous()
    _build.reset_launches()
    out = _twice_same(lambda: tsc.sparse_conv(x, w, rb))
    d = _twice_same(lambda: tsc.sparse_conv(g, w_t, rb_bwd, dgrad=True))
    L = _build.LAUNCHES
    assert (L["sparse_conv_k"], L["sparse_conv_k_tf32"], L["sparse_conv_k_dgrad_tf32"], L["sparse_conv_k_wgmma"]) == (
        4, 4, 2, 0)
    plain = tsc.sparse_conv_plain
    _close(out, plain(x, w, rb), plain(x.abs(), w.abs(), rb), torch.float32, 1e-5)
    _close(d, plain(g, w_t, rb_bwd), plain(g.abs(), w_t.abs(), rb_bwd), torch.float32, 1e-5)
    ci, co = tsc.padded_width(torch.float32, c_in), tsc.padded_width(torch.float32, c_out)
    uncut = torch.empty(v_out, c_out, device=cuda)
    tsc.launch_k_tf32(tsc.pad_cols(x, ci), tsc.pad_weight(w, ci, co), rb, None, uncut, (), splits=1)
    _close(uncut, plain(x, w, rb), plain(x.abs(), w.abs(), rb), torch.float32, 1e-5)


def test_tf32_wgmma_served_weight_is_split_once(cuda):
    """A weight that takes no gradient keeps its split operand: the next
    call reuses it (no split) with the same bits; an in-place change of
    the weight splits it again and the output follows the new weight; a
    weight that takes a gradient is split on every call."""
    rng = np.random.default_rng(5)
    rb, _, v_in = _k_tables(cuda, "asym9")
    x = _rand(rng, (v_in, 64), cuda, torch.float32)
    w = _rand(rng, (9, 64, 32), cuda, torch.float32)
    first = tsc.sparse_conv(x, w, rb)
    buf, fresh = tsc.tf32_operand(w)
    assert not fresh and buf is w._taseg_tf32[1]
    assert torch.equal(tsc.sparse_conv(x, w, rb), first) and w._taseg_tf32[1] is buf
    w.mul_(2.0)
    assert tsc.tf32_operand(w)[1]
    _close(tsc.sparse_conv(x, w, rb), tsc.sparse_conv_plain(x, w, rb),
           tsc.sparse_conv_plain(x.abs(), w.abs(), rb), torch.float32, 1e-5)
    trained = w.clone().requires_grad_()
    for _ in range(2):
        assert tsc.tf32_operand(trained)[1]
        tsc.sparse_conv(x, trained, rb)
    assert not hasattr(trained, "_taseg_tf32")


@pytest.mark.parametrize("case", ["path", "ragged", "dead"])
@pytest.mark.parametrize("c_in,c_out", [(32, 64), (64, 32), (128, 256), (256, 128), (96, 96), (51, 102)])
def test_tf32_wgmma_k3_both_ways(cuda, case, c_in, c_out):
    """K3 in f32 on the 3xTF32 wgmma tile, both ways and as each other's
    input gradient (W^T a view of W): K3-down over the child table within
    1e-4 of the largest sum of |terms| (its plain version sums by a
    mean-centred cumsum), K3-up over the up table within 1e-5, the same
    bits on repeat, every launch on the `_tf32` route."""
    rng, v_fine, tab, n2 = _down_case(cuda, case)
    tab = replace(tab, child=tst.slot_child_table(tab, rounds=1), up=tst.slot_up_table(tab))
    tab = replace(tab, child_order=tsc.mask_row_order(tab.child[0]), up_order=tsc.mask_row_order(tab.up))
    v_coarse = tab.starts.shape[0] - 1
    xf = _rand(rng, (v_fine, c_in), cuda, torch.float32)
    xc = _rand(rng, (v_coarse, c_in), cuda, torch.float32)
    w = _rand(rng, (8, c_in, c_out), cuda, torch.float32)
    w_t = _rand(rng, (8, c_out, c_in), cuda, torch.float32).transpose(1, 2)
    _build.reset_launches()
    down = _twice_same(lambda: tst.downsample_conv_apply(xf, w, tab))
    up = _twice_same(lambda: tst.upsample_conv_apply(xc, w_t, tab, dgrad=True))
    L = _build.LAUNCHES
    assert (L["strided_down"], L["strided_down_tf32"], L["strided_up"], L["strided_up_tf32"],
            L["strided_up_dgrad_tf32"]) == (2, 2, 2, 2, 2)
    _close(down, tst.downsample_conv_plain(xf, w, tab), tst.downsample_conv_plain(xf.abs(), w.abs(), tab),
           torch.float32, 1e-4)
    _close(up, tst.upsample_conv_plain(xc, w_t, tab), tst.upsample_conv_plain(xc.abs(), w_t.abs(), tab),
           torch.float32, 1e-5)


@pytest.mark.parametrize("dtype,c", [
    (torch.bfloat16, 51), (torch.float32, 204), (torch.float32, 409), (torch.bfloat16, 153),
    (torch.bfloat16, 409), (torch.bfloat16, 64), (torch.float32, 96), (torch.bfloat16, 20), (torch.float32, 3),
])
@pytest.mark.parametrize("misaligned", [False, True])
def test_voxelize_bwd_layouts_bit_equal(cuda, dtype, c, misaligned):
    """K8 in each layout (the rows layout in its widest piece, the flat
    layout of 16-byte output pieces where the row holds one, and the
    first kernel) gives the plain version's bits at SPVCNN cr 1.6's point
    widths (51 bf16, 204 and 409 f32, 153 bf16) and aligned ones, with g
    at and off a 16-byte boundary; the wrapper launches once a call, in
    the layout `voxelize_bwd_plan` picks."""
    g, inv, tables = _voxelize_bwd_case(cuda, dtype, c, misaligned)
    want = _bits(tvx._voxelize_bwd_plain(g, inv, tables.counts))
    _build.reset_launches()
    assert torch.equal(_bits(tvx.voxelize_bwd(g, inv, tables.counts)), want)
    assert _build.LAUNCHES["voxelize_bwd"] == 1
    p = inv.shape[0]
    for name, layout in tvx.K8_LAYOUTS.items():
        if name == "flat" and c * g.element_size() < 16:
            continue  # a flat piece would span more than two rows
        out = torch.full((p, c), float("nan"), device=cuda, dtype=dtype)
        _build.launch("taseg_voxelize_bwd", (), g.data_ptr(), inv.data_ptr(), tables.counts.data_ptr(),
                      out.data_ptr(), p, c, tsc.DTYPE_CODES[dtype], layout)
        assert torch.equal(_bits(out), want), name


# ------------------------------- the f32 weight gradients on 3xTF32 wgmma
# (C_in, C_out, K) of every K4-at-K call of the recipes' f32 paths:
# Cylinder cy480's convs (K = 9, 8, 4, 3) and its head (128 -> 20 at 27),
# TIAF's main-branch 3^3 convs (K = 27, the stem's C_in 5 padded to 8),
# the Waymo Cylinder head (128 -> 23, padded to 24) and ragged widths
DW_TF32_WIDTHS = [
    (16, 32, 9), (32, 32, 9), (32, 64, 8), (64, 64, 3), (64, 64, 9), (64, 128, 8), (96, 64, 9),
    (128, 20, 27), (128, 64, 8), (128, 128, 9), (128, 256, 4), (192, 128, 9), (256, 128, 8),
    (256, 256, 9), (256, 512, 4), (384, 256, 9), (512, 256, 4), (512, 512, 4), (512, 512, 9),
    (768, 512, 9),
    (5, 32, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27), (32, 64, 27), (48, 48, 27), (64, 48, 27),
    (64, 64, 27), (64, 128, 27), (88, 16, 27), (96, 64, 27), (96, 96, 27), (128, 96, 27),
    (128, 128, 27), (128, 256, 27), (192, 128, 27), (256, 256, 27), (384, 256, 27),
    (128, 23, 27), (51, 102, 9),
]
# a level's table of each K (`_k_tables`)
DW_TF32_KIND = {9: "asym9", 3: "recon3", 8: "down8", 4: "up4", 27: "head27"}


def _dw_mma_sync(x, g, lists, k, v_in):
    """K4 at K on the mma.sync tile the wgmma tile replaced, at the
    widths the wrapper pads to (counted nowhere)."""
    ci, co = tsc.padded_width(torch.float32, x.shape[1]), tsc.padded_width(torch.float32, g.shape[1])
    out = tf3.launch_dw_mma("taseg_sparse_conv_dw_tf32_mma", tsc.pad_cols(x, ci), tsc.pad_cols(g, co), lists,
                            k, v_in, k * v_in, k)
    return out[:, : x.shape[1], : g.shape[1]]


@pytest.mark.parametrize("c_in,c_out,k", DW_TF32_WIDTHS)
def test_tf32_wgmma_dw_at_k_every_width(cuda, c_in, c_out, k):
    """K4 at K on the 3xTF32 wgmma tile at every width of the recipes' f32
    paths, on a level's table of the width's K: within 1e-4 of the largest
    sum of |terms| of the plain version, and so is the mma.sync tile it
    replaced at the same inputs; the same bits on repeat and with the
    lists built by the wrapper; one `sparse_conv_dw_tf32` launch a call."""
    rng = np.random.default_rng(c_in * 1000 + c_out + k)
    rb, rb_bwd, v_in = _k_tables(cuda, DW_TF32_KIND[k])
    x = _rand(rng, (v_in, c_in), cuda, torch.float32)
    g = _rand(rng, (rb.shape[1], c_out), cuda, torch.float32)
    lists = tf3.pair_lists(rb_bwd)
    _build.reset_launches()
    got = _twice_same(lambda: tf3.sparse_conv_dw(x, g, rb_bwd, pairs=lists))
    assert torch.equal(tf3.sparse_conv_dw(x, g, rb_bwd), got)
    old = _dw_mma_sync(x, g, lists, k, v_in)
    L = _build.LAUNCHES
    assert (L["sparse_conv_dw"], L["sparse_conv_dw_tf32"], L["k3_conv_dw"]) == (3, 3, 0)
    want, ref = tf3.k3_conv_dw_plain(x, g, rb_bwd), tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd)
    assert got.shape == (k, c_in, c_out)
    _close(got, want, ref, torch.float32, 1e-4)
    _close(old, want, ref, torch.float32, 1e-4)


@pytest.mark.parametrize("k", [1, 9, 27, 32])
@pytest.mark.parametrize("case", ["empty", "one_pair", "long"])
def test_tf32_wgmma_dw_edges(cuda, k, case):
    """K4 at K on the wgmma tile at its edges: every list empty (zeros),
    one pair in all, and lists longer than a wave (131 072 input rows, ~2/3
    of them in each list: every list cut into pieces, which its last block
    adds in split order); K = 1 and 32 (the most lists a call takes);
    widths 128 -> 24, 32 -> 64 and 256 -> 128; within 1e-4 of the plain
    version, the same bits on repeat, one launch a call."""
    rng = np.random.default_rng(10 * k + len(case))
    v_in, v_out = (131072, 131072) if case == "long" else (300, 200)
    rb_bwd = rng.integers(0, v_out, (k, v_in))
    rb_bwd[rng.random((k, v_in)) < {"empty": 1.0, "one_pair": 1.0, "long": 0.35}[case]] = -1
    if case == "one_pair":
        rb_bwd[k // 2, 7] = 3
    rb_bwd = torch.tensor(rb_bwd, dtype=torch.int32, device=cuda)
    lists = tf3.pair_lists(rb_bwd)
    longest = int((lists.starts[1:] - lists.starts[:-1]).max())
    for c_in, c_out in ((128, 24), (32, 64), (256, 128)):
        if case == "long":
            p = tf3.dw_tf32_plan(c_in, c_out)
            per = tf3.k4_split_pairs(lists.starts.tolist(), p.per_min, p.target, tf3.DW_TF32_STAGE)
            assert per < longest  # the lists split
        x = _rand(rng, (v_in, c_in), cuda, torch.float32)
        g = _rand(rng, (v_out, c_out), cuda, torch.float32)
        _build.reset_launches()
        dw = _twice_same(lambda: tf3.sparse_conv_dw(x, g, rb_bwd, pairs=lists))
        assert (_build.LAUNCHES["sparse_conv_dw"], _build.LAUNCHES["sparse_conv_dw_tf32"]) == (2, 2)
        if case == "empty":
            assert not dw.any()
        want = tf3.k3_conv_dw_plain(x, g, rb_bwd)
        if case == "one_pair":
            assert torch.count_nonzero(dw.abs().sum((1, 2))) == 1
        _close(dw, want, tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd), torch.float32, 1e-4)


# (C_in, C_out) of K5's f32 calls: TIAF's strided convs (both branches)
K5_F32_WIDTHS = [
    (16, 16), (32, 32), (48, 48), (64, 48), (64, 64), (96, 96), (128, 64), (128, 96), (128, 128),
    (256, 128), (256, 256),
]


@pytest.mark.parametrize("c_in,c_out", K5_F32_WIDTHS)
@pytest.mark.parametrize("v", [1, 3000, 131072])
def test_tf32_wgmma_k5_against_mma_sync(cuda, c_in, c_out, v):
    """K5 in f32 on the 3xTF32 wgmma tile, down and up, at TIAF's widths,
    with one fine row (one pair), a small level and a level-0 sized one
    (every slot's list cut into pieces), slot 3 empty and every 7th row
    dead: within 1e-4 of `strided_dw_plain`'s largest sum of |terms|, and
    so is the mma.sync tile it replaced; the same bits on repeat, slot 3
    zero; one `strided_dw_tf32` launch a call."""
    v_coarse = max(1, v // 6)
    rng = np.random.default_rng(c_in + 3 * c_out + v)
    parent = rng.integers(0, v_coarse, v).astype(np.int32)
    parent[7::7] = -1
    slot = rng.integers(0, 8, v).astype(np.int32)
    slot[slot == 3] = 5
    i32 = lambda a: torch.from_numpy(a).to(cuda)
    bare = tst.StridedTables(
        parent=i32(parent), slot=i32(slot), perm=i32(np.arange(v, dtype=np.int32)),
        starts=torch.zeros(v_coarse + 1, dtype=torch.int32, device=cuda),
    )
    tab = replace(bare, pairs=tst.slot_pair_lists(bare))
    _build.reset_launches()
    for up in (False, True):
        x = _rand(rng, (v_coarse if up else v, c_in), cuda, torch.float32)
        y = _rand(rng, (v if up else v_coarse, c_out), cuda, torch.float32)
        got = _twice_same(lambda: tst.strided_dw(x, y, tab, up))
        old = tst.strided_dw_tf32_mma(x, y, tab.pairs, v, up)
        want, ref = tst.strided_dw_plain(x, y, bare, up), tst.strided_dw_plain(x.abs(), y.abs(), bare, up)
        _close(got, want, ref, torch.float32, 1e-4)
        _close(old, want, ref, torch.float32, 1e-4)
        assert not got[3].any()
    assert (_build.LAUNCHES["strided_dw"], _build.LAUNCHES["strided_dw_tf32"]) == (4, 4)


def _bits(t):
    """A float tensor's bits (f32 as int32, bf16 as int16)."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def _k10_case(kind, dtype, dev):
    """(x, seg, num_segments) at K10's two shapes with planted ties:
    Cylinder3D's (P = 120 000 rows x 16 ReLU features, almost every row
    its own segment, the padding rows in a sentinel segment, exact zeros
    and -0.0 among the maxima; 'cylinder_padded': 131 072 rows whose last
    11 072, all -inf, are the padding rows in one dummy segment, as the
    model lays them out, every two real rows in one segment) or the
    pool's (two batches of ~60 000 sorted rows at 128 columns, values on
    a coarse grid so that most maxima are tied)."""
    rng = np.random.default_rng(5)
    if kind == "cylinder":
        p, c = 120_000, 16
        x = np.maximum(rng.normal(size=(p, c)), 0).astype(np.float32)
        x[rng.random((p, c)) < 0.05] = -0.0
        seg = rng.permutation(np.minimum(np.arange(p), p - 3000)).astype(np.int32)  # a few shared
        pad = rng.random(p) < 0.02
        seg[pad] = p - 2999
        x[pad] = -np.inf
        s = p - 2998
    elif kind == "cylinder_padded":
        p, c, real = 131_072, 16, 120_000
        x = np.maximum(np.round(rng.normal(size=(p, c)) * 8) / 8, 0).astype(np.float32)
        x[rng.random((p, c)) < 0.05] = -0.0
        x[real:] = -np.inf
        seg = np.concatenate([rng.permutation(real) // 2, np.full(p - real, real // 2)]).astype(np.int32)
        s = real // 2 + 1
    else:
        p, c = 120_000, 128
        x = np.round(rng.normal(size=(p, c)) * 2) / 2
        x = x.astype(np.float32)
        seg = (np.arange(p) >= p // 2).astype(np.int32)
        seg[-500:] = 2  # the dropped rows' segment
        s = 3
    t = torch.from_numpy(x).to(dev, dtype)
    return t, torch.from_numpy(seg).to(dev), s


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["cylinder", "cylinder_padded", "pool"])
def test_segment_max_kernel_bit_exact(cuda, kind, dtype):
    """K10 forward and backward against `segment_max_plain` /
    `segment_max_bwd_plain` on the same card tensors, to the bit (a max
    of zeros is +0.0 in both), at Cylinder3D's and the pool's shapes with
    ties; the same bits on repeat; one launch each way; the first design
    (the yardstick) to the same bits."""
    x, seg, s = _k10_case(kind, dtype, cuda)
    _build.reset_launches()
    out = _twice_same(lambda: tvx.segment_max_kernel(x, seg, s))
    assert _build.LAUNCHES["segment_max"] == 2
    want = tvx.segment_max_plain(x, seg, s)
    assert torch.equal(_bits(out), _bits(want))
    g = torch.from_numpy(np.random.default_rng(6).normal(size=out.shape).astype(np.float32)).to(cuda, dtype)
    _build.reset_launches()
    dx = _twice_same(lambda: tvx.segment_max_bwd_kernel(x, seg, out, g))
    assert (_build.LAUNCHES["segment_max"], _build.LAUNCHES["segment_max_bwd"]) == (2, 2)
    dwant = tvx.segment_max_bwd_plain(x, seg, out, g)
    assert torch.equal(_bits(dx), _bits(dwant))
    assert ((dx != 0).sum(0) >= 1).all()  # every column's maximum took its share
    assert torch.equal(_bits(tvx.segment_max_v1(x, seg, s)), _bits(want))
    assert torch.equal(_bits(tvx.segment_max_bwd_v1(x, seg, out, g)), _bits(dwant))


def test_segment_max_autograd_and_nan_on_card(cuda):
    """`segment_max` through autograd on the card (one K10 launch each
    way) against the CPU's plain path, ties and empty segments included;
    a NaN member makes its segment NaN, as `scatter_reduce` amax does."""
    rng = np.random.default_rng(9)
    x0 = rng.integers(-3, 3, size=(5000, 24)).astype(np.float32)
    seg0 = rng.integers(0, 1500, 5000)
    res = []
    for dev in (cuda, torch.device("cpu")):
        x = torch.tensor(x0, device=dev, requires_grad=True)
        _build.reset_launches()
        out = tvx.segment_max(x, torch.tensor(seg0, device=dev), 1600)
        out = torch.where(torch.isfinite(out), out, 0.0)
        (out * torch.arange(24, device=dev)).sum().backward()
        res.append((out.detach().cpu(), x.grad.cpu(), dict(_build.LAUNCHES)))
    assert torch.equal(_bits(res[0][0]), _bits(res[1][0])) and torch.equal(res[0][1], res[1][1])
    assert (res[0][2]["segment_max"], res[0][2]["segment_max_bwd"]) == (2, 1)
    assert not any(res[1][2].values())
    xn = torch.tensor(x0, device=cuda)
    xn[7, 3] = float("nan")
    got = tvx.segment_max_kernel(xn, torch.tensor(seg0, device=cuda), 1600)
    assert torch.isnan(got[int(seg0[7]), 3]) and torch.isnan(got).sum() == 1


@pytest.mark.parametrize("kind", ["resnet", "unet"])
def test_backbones_card_equals_cpu(cuda, kind):
    """SparseResNet21D and SparseResUNet42 at width 0.25 on ~800 voxels of
    two batches, f32, the same weights on both: every stage's eval
    features within 1e-4 of the CPU's largest (3xTF32 and another
    summation order), and the gradient of a weighted sum of them in every
    parameter (eval mode, the train form of the topology): the ResNet's
    each within 1e-4 of its largest (measured 1.2e-6 on an H100 80GB HBM3
    at 700 W); the UNet's as a whole within 1e-3 of its L2 norm (measured
    1.7e-4 there).  The
    UNet's nine outputs meet in its decoder, where some gradients are
    ~1e-4 small differences of terms of ~1e3: held one by one, the
    decoder's convs are off by up to 1.9e-2 of their own largest.  K2 at
    K offsets and K4 at K launched on the card (the strided entry convs
    of the ResNet, the 3^3 convs on 3xTF32)."""
    from taseg_tpu_torch.models.voxel import backbones as tbb
    from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities, build_unet_topology
    from taseg_tpu_torch.utils.params_from_jax import init_module_numpy, load_flax_params

    rng = np.random.default_rng(2)
    xyz = np.unique(rng.integers(0, 28, (900, 3)), axis=0).astype(np.int32)
    coords = np.zeros((1024, 4), np.int32)
    coords[: len(xyz), :3] = xyz
    coords[: len(xyz), 3] = rng.integers(0, 2, len(xyz))
    feats = rng.normal(size=(1024, 4)).astype(np.float32)
    net = tbb.SparseResNet21D if kind == "resnet" else tbb.SparseResUNet42
    params, stats = init_module_numpy(net(in_channels=4, width_multiplier=0.25, device="cpu"), 1)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        model = net(in_channels=4, width_multiplier=0.25, device=dev)
        load_flax_params(model, params, stats)
        model.eval()
        c = torch.from_numpy(coords).to(dev)
        if kind == "resnet":
            topo = tbb.build_resnet_topology(c, len(xyz), (1024, 1024, 512, 512, 512), train=True)
        else:
            topo = build_unet_topology(
                c.float(), torch.tensor(len(xyz), dtype=torch.int32, device=dev),
                UNetCapacities.for_points(1024), devox_pairs=True,
            )
        x0 = tvx.voxelize_avg(torch.from_numpy(feats).to(dev), topo.point_inverse, topo.point_tables)
        _build.reset_launches()
        outs = model(x0, topo)
        sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
        res[dev.type] = ([o.detach().cpu() for o in outs],
                         {n: p.grad.cpu() for n, p in model.named_parameters()}, dict(_build.LAUNCHES))
    (outs, grads, launches), (outs_c, grads_c, none) = res["cuda"], res["cpu"]
    assert not any(none.values())
    assert launches["sparse_conv_k"] > 0 and launches["sparse_conv_dw"] > 0
    for a, b in zip(outs, outs_c, strict=True):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max()
    errs = {n: float((grads[n] - g).abs().max() / g.abs().max()) for n, g in grads_c.items()}
    worst = max(errs, key=errs.get)
    diff = sum(float(((grads[n] - g).double() ** 2).sum()) for n, g in grads_c.items()) ** 0.5
    norm = sum(float((g.double() ** 2).sum()) for g in grads_c.values()) ** 0.5
    if kind == "resnet":
        assert errs[worst] <= 1e-4, (worst, errs[worst])
    else:
        assert diff <= 1e-3 * norm, (diff / norm, worst, errs[worst])
