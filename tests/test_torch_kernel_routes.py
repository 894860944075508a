"""Which kernel each conv of the main path takes on the card, decided on the
CPU from the modules' widths: K2 (`sparse_conv.route`) and K3-down
(`strided_conv.downsample_route`, over a one-round child table) take the
Hopper wgmma tile ("wgmma") in bf16 at every width, each padded to a
multiple of 8 (`sparse_conv.padded_width`), and so does K3-up
(`strided_conv.upsample_route`, over the level's up table); K4 and K5,
the weight gradients of the k3 conv and of the strided pair
(`f3conv.dw_route`), take the wgmma tile over pair lists there; K5 takes
3xTF32 ("tf32x3") in f32 at widths padded to multiples of 4, as K3-down
and K3-up take K2 at K's 3xTF32 tile in f32; only a direct f32 call of
K2 or K4 at 27 offsets (the models send f32 to K2 and K4 at K) and
K3-down's f32 round kernel stay on CUDA cores ("simt").  K4's and K5's
split rules and their pieces are checked against a numpy model here, K6's
plan at SPVCNN cr 1.6's widths (409 channels on a padded copy), the
padded inputs and served weights that the wrappers take as they are, and
the TF32 switch of the entry points' device resolution; ~5 s for the
file.
MinkUNet mk34 cr1.0 at full width; nothing runs on a card here."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
from taseg_tpu_torch.models.layers import SparseConv
from taseg_tpu_torch.models.voxel.minkunet import MinkUNet
from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.ops import f3conv as tf3
from taseg_tpu_torch.ops import sparse_conv as tsc
from taseg_tpu_torch.ops import strided_conv as tst
from taseg_tpu_torch.ops import voxelize as tvx


@pytest.fixture(scope="module")
def convs():
    model = MinkUNet.from_cfg(MINKUNET_MK34_CR10, device="cpu")
    return {
        name: m
        for name, m in model.named_modules()
        if isinstance(m, SparseConv) and m.kernel_volume > 1
    }


def test_k2_routes_in_bf16(convs):
    """Every 27-point conv is on tensor cores, the stem's first (C_in =
    4) at C_in padded to 8: 48 of the 48 K2 launches of a scan."""
    k3 = {n: m for n, m in convs.items() if m.kernel_volume == 27}
    routes = {n: tsc.route(torch.bfloat16, m.in_channels, m.out_channels) for n, m in k3.items()}
    assert len(k3) == 48
    assert set(routes.values()) == {"wgmma"}
    stem = k3["stem_0.SparseConv_0"]
    assert (stem.in_channels, tsc.padded_width(torch.bfloat16, stem.in_channels)) == (4, 8)


def test_k4_routes_in_bf16(convs):
    """The train step's d_W of every 27-point conv is on tensor cores,
    the stem's first (4 -> 32) at C_in padded to 8: 48 of the 48 K4
    launches of a step, on the wgmma tile over the offset lists."""
    k3 = {n: m for n, m in convs.items() if m.kernel_volume == 27}
    routes = {n: tf3.dw_route(torch.bfloat16, m.in_channels, m.out_channels) for n, m in k3.items()}
    assert len(routes) == 48 and set(routes.values()) == {"wgmma"}


def test_k5_routes_in_bf16(convs):
    """The train step's d_W of all 8 strided convs (down1-4 and the four
    deconvs) is on tensor cores: 8 of the 8 K5 launches of a step, on the
    wgmma tile over the slot lists."""
    strided = {n: m for n, m in convs.items() if m.kernel_volume == 8}
    widths = sorted((m.in_channels, m.out_channels) for m in strided.values())
    assert widths == sorted(K5_PATH_WIDTHS)
    assert all(tf3.dw_route(torch.bfloat16, *wd, strided=True) == "wgmma" for wd in widths)
    assert all(tf3.dw_route(torch.bfloat16, *wd) == "wgmma" for wd in widths)  # K4's tile
    assert all(tf3.dw_route(torch.float32, *wd) == "simt" for wd in widths)


def test_k5_routes_in_f32(convs):
    """In f32 (TIAF's step, whose branches are MinkUNets of these widths)
    every K5 call takes the 3xTF32 tile over the slot lists; so does a
    ragged width, padded to a multiple of 4; a dtype without a kernel
    gets none."""
    strided = [m for m in convs.values() if m.kernel_volume == 8]
    assert len(strided) == 8
    for m in strided:
        assert tf3.dw_route(torch.float32, m.in_channels, m.out_channels, strided=True) == "tf32x3"
    assert tf3.dw_route(torch.float32, 5, 32, strided=True) == "tf32x3"
    assert tf3.dw_route(torch.float32, 32, 6, strided=True) == "tf32x3"
    assert [tsc.padded_width(torch.float32, c) for c in (5, 6, 32)] == [8, 8, 32]
    assert tf3.dw_route(torch.float16, 32, 32, strided=True) == "simt"


def test_k3_up_routes_in_bf16(convs):
    """All four transposed 8-point convs (the deconvs) are on the wgmma
    tile over the level's up table: 4 of the 4 K3-up launches of a scan."""
    up = {n: m for n, m in convs.items() if m.kernel_volume == 8 and m.transposed}
    widths = sorted((m.in_channels, m.out_channels) for m in up.values())
    assert widths == [(96, 96), (128, 96), (256, 128), (256, 256)]
    assert all(
        tst.upsample_route(torch.bfloat16, m.in_channels, m.out_channels) == "wgmma"
        for m in up.values()
    )
    assert sum(m.kernel_volume == 8 and not m.transposed for m in convs.values()) == 4


def test_k3_down_routes_in_bf16(convs):
    """All four strided 8-point convs (down1-down4, C_in = C_out) are on
    the wgmma tile: 4 of the 4 K3-down launches of a scan."""
    down = {n: m for n, m in convs.items() if m.kernel_volume == 8 and not m.transposed}
    assert sorted(down) == [f"down{l}.SparseConv_0" for l in range(1, 5)]
    widths = [(down[n].in_channels, down[n].out_channels) for n in sorted(down)]
    assert widths == [(32, 32), (32, 32), (64, 64), (128, 128)]
    assert all(tst.downsample_route(torch.bfloat16, *wd) == "wgmma" for wd in widths)


def test_input_gradient_routes_in_bf16(convs):
    """The train step's input gradients run the forward kernels on W^T,
    with C_in and C_out swapped: the 47 of K2 (every 27-point conv but
    the stem's first, whose input needs no gradient), the 4 of K3-up
    (down's backward) and the 4 of K3-down (the deconvs' backward) all
    take the wgmma tile."""
    k3 = [m for n, m in convs.items() if m.kernel_volume == 27 and n != "stem_0.SparseConv_0"]
    assert len(k3) == 47
    assert all(tsc.route(torch.bfloat16, m.out_channels, m.in_channels) == "wgmma" for m in k3)
    for m in (m for m in convs.values() if m.kernel_volume == 8):
        if m.transposed:
            assert tst.downsample_route(torch.bfloat16, m.out_channels, m.in_channels) == "wgmma"
        else:
            assert tst.upsample_route(torch.bfloat16, m.out_channels, m.in_channels) == "wgmma"


def test_f32_routes_stay_on_cuda_cores(convs):
    """f32 keeps K2 at 27 and K4 on CUDA cores (their f32 calls go to K2
    and K4 at K through `k_route`); K3-down over a one-round child table,
    K3-up over the up table and K5 take 3xTF32 tiles (every width of the
    path is a multiple of 4), K3-down over several rounds its round
    kernel."""
    for m in convs.values():
        assert tsc.route(torch.float32, m.in_channels, m.out_channels) == "simt"
        assert tst.upsample_route(torch.float32, m.in_channels, m.out_channels) == "tf32x3"
        assert tst.downsample_route(torch.float32, m.in_channels, m.out_channels) == "tf32x3"
        assert tst.downsample_route(torch.float32, m.in_channels, m.out_channels, 2) == "rounds"
        assert tf3.dw_route(torch.float32, m.in_channels, m.out_channels) == "simt"
        assert tf3.dw_route(torch.float32, m.in_channels, m.out_channels, strided=True) == "tf32x3"


@pytest.mark.parametrize(
    "c_in,c_out",
    [
        (4, 32), (37, 70), (64, 20), (12, 8), (8, 8), (32, 32), (40, 24), (384, 256),
        # MinkUNet / SPVCNN cr 1.6 (int(1.6 x PLANES): 51, 102, 204, 409,
        # 153; the decoder's concatenations 613 and 306), Waymo Cylinder's
        # 23-class head, the 4-wide stem
        (51, 51), (102, 102), (409, 409), (613, 409), (306, 204), (128, 23), (4, 51),
    ],
)
def test_ragged_widths_take_the_tensor_core_routes(c_in, c_out):
    """Every width takes the tensor-core routes of K2, K3 both ways, K4
    and K5, at widths padded to whole 16-byte pieces: multiples of 8 in
    bf16 (the wgmma tiles), of 4 in f32 (the 3xTF32 tiles; K2 and K4 at
    K, `k_route`, serve the f32 3^3 convs); a child table of several
    rounds takes K3-down's round kernels."""
    for dtype, tc, q in ((torch.bfloat16, "wgmma", 8), (torch.float32, "tf32x3", 4)):
        for c in (c_in, c_out):
            p = tsc.padded_width(dtype, c)
            assert p % q == 0 and c <= p < c + q
        assert tsc.k_route(dtype, c_in, c_out) == tc
        assert tst.upsample_route(dtype, c_in, c_out) == tc
        assert tst.downsample_route(dtype, c_in, c_out) == tc
        assert tst.downsample_route(dtype, c_in, c_out, 3) == "rounds"
        assert tf3.dw_route(dtype, c_in, c_out, strided=True) == tc
    assert tsc.route(torch.bfloat16, c_in, c_out) == "wgmma"
    assert tf3.dw_route(torch.bfloat16, c_in, c_out) == "wgmma"
    assert tf3.dw_route(torch.float32, c_in, c_out) == "simt"  # f32 d_W takes K4 at K


@pytest.mark.parametrize("esz", [4, 2])
def test_k6_plan_takes_spvcnn_cr16_widths(esz):
    """K6 takes SPVCNN cr 1.6's re-voxelize and devoxelize-backward
    widths (409, 204, 153) in f32 and bf16: 409 f32 channels in 16
    pieces of 4 bytes a lane of 32 lanes; 409 bf16 channels, which would
    need 16 pieces of 2 bytes, on a copy padded to 416 columns (2 pieces
    of 16 bytes); 204 and 153 at their own widths; rows of more than 4096
    bytes are too wide."""
    for c in (409, 204, 153):
        p = tvx.segment_sum_plan(c, esz)
        cols = tvx.segment_sum_cols(c, esz)
        assert p.lanes * p.pieces * (p.vw // esz) >= cols >= c and p.pieces <= 16
        assert cols == (416 if (c, esz) == (409, 2) else c)
    want = (4, 32, 16, 64) if esz == 4 else (16, 32, 2, 64)
    assert tvx.segment_sum_plan(409, esz) == tvx.SegmentSumPlan(*want)
    with pytest.raises(ValueError, match="wider than K6 takes"):
        tvx.segment_sum_plan(4096 // esz + 1, esz)


@pytest.mark.parametrize(
    "v,c_in,c_out",
    [(131072, 32, 32), (131072, 96, 96), (19712, 384, 256), (7936, 256, 256), (100, 8, 8)],
)
def test_k4_mma_splits_from_shapes(v, c_in, c_out):
    """K4's tensor-core splits cover V pairs (the most one offset can
    hold) in whole 32-pair stages, keep the partials within their budget
    and split only where a split has at least DW_MMA_MIN_PAIRS pairs."""
    splits, per = tf3.dw_mma_splits(v, c_in, c_out)
    assert per % tf3.DW_MMA_STAGE == 0 and per >= tf3.DW_MMA_MIN_PAIRS
    assert splits * per >= v and (splits - 1) * per < v
    if splits > 1:
        assert splits * 27 * c_in * c_out * 4 <= tf3.DW_MMA_PART_BYTES


# K5's calls of a train step at TRAIN_CAPACITY_SCHEDULE: (V_fine, C_in,
# C_out) of down1-down4, then up1-up4
K5_PATH_SHAPES = [
    (131072, 32, 32), (91904, 32, 32), (46080, 64, 64), (19712, 128, 128),
    (19712, 256, 256), (46080, 256, 128), (91904, 128, 96), (131072, 96, 96),
]
K5_PATH_WIDTHS = [(c_in, c_out) for _, c_in, c_out in K5_PATH_SHAPES]


@pytest.mark.parametrize("v,c_in,c_out", K5_PATH_SHAPES)
def test_k5_mma_splits_from_shapes(v, c_in, c_out):
    """K5's splits cover V_fine pairs (the most one slot can hold) in
    whole 64-pair stages, at least K5_MIN_PAIRS a split, and about one
    wave of live blocks over the 8 lists at 2 resident blocks per SM; the
    tile is 32, 64, 96 or 128 columns wide."""
    splits, per = tf3.k5_splits(v, c_in, c_out)
    assert per % tf3.K5_STAGE == 0 and per >= tf3.K5_MIN_PAIRS
    assert splits * per >= v and (splits - 1) * per < v
    bn = tf3.k5_tile_n(c_out)
    assert bn in (32, 64, 96, 128) and (bn >= c_out or bn == 128)
    tiles = -(-c_in // 64) * -(-c_out // bn)
    live = tiles * (v // per + 8)
    assert live <= tf3.K5_SMS * tf3.K5_PER_SM + 8 * tiles


def _k5_pieces(starts, per):
    """numpy model of K5's split partition over the slot lists
    (csrc/conv_dw.cu, k5): split z of slot k takes pairs [z per, (z + 1)
    per) of k's list; a list of one piece goes straight to out, else
    piece z of slot k is partial p(k, z) = starts[k] // per + k + z.
    Returns {(k, z): piece index or None}."""
    out = {}
    for k in range(8):
        n_k = starts[k + 1] - starts[k]
        live = max(1, -(-n_k // per))
        for z in range(live):
            out[k, z] = None if live == 1 else starts[k] // per + k + z
    return out


@pytest.mark.parametrize("per", [64, 128, 256])
@pytest.mark.parametrize("up", [False, True])
def test_k5_split_pieces_and_their_sum(per, up):
    """The pieces of K5's splits never collide and stay within the
    wrapper's V / per + 9 buffer, over lists of every length (empty,
    shorter than a split, many splits); adding each list's piece sums in
    split order gives `strided_dw_pairs_plain` and `strided_dw_plain`
    (f32; the plain versions sum each list as one product).  ~0.2 s."""
    rng = np.random.default_rng(per + up)
    v, v_coarse = 3000, 500
    parent = rng.integers(0, v_coarse, v).astype(np.int32)
    parent[::11] = -1
    slot = rng.choice([0, 1, 2, 4, 5, 6, 7], v, p=[0.55, 0.2, 0.01, 0.1, 0.1, 0.02, 0.02]).astype(np.int32)
    tab = tst.StridedTables(
        parent=torch.from_numpy(parent), slot=torch.from_numpy(slot),
        perm=torch.arange(v, dtype=torch.int32), starts=torch.zeros(v_coarse + 1, dtype=torch.int32),
    )
    lists = tst.slot_pair_lists(tab)
    starts = lists.starts.tolist()
    pieces = _k5_pieces(starts, per)
    used = [p for p in pieces.values() if p is not None]
    assert len(used) == len(set(used)) and max(used) < v // per + 9
    assert starts[4] == starts[3]  # slot 3 holds no pair
    c_in, c_out = 8, 12
    x = torch.from_numpy(rng.normal(size=(v_coarse if up else v, c_in)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(v if up else v_coarse, c_out)).astype(np.float32))
    pairs = lists.pairs.long()
    if up:
        pairs = pairs.flip(1)
    got = torch.zeros(8, c_in, c_out)
    for (k, z), _ in sorted(pieces.items()):
        lo = starts[k] + z * per
        p = pairs[lo : min(lo + per, starts[k + 1])]
        got[k] = got[k] + x[p[:, 0]].t() @ y[p[:, 1]]
    want = tst.strided_dw_pairs_plain(x, y, lists, up)
    ref = tst.strided_dw_plain(x.abs(), y.abs(), tab, up).abs().max()
    assert (got - want).abs().max() <= 1e-5 * ref
    assert (got - tst.strided_dw_plain(x, y, tab, up)).abs().max() <= 1e-5 * ref
    assert not got[3].any()


# K4's calls of a bf16 train step at TRAIN_CAPACITY_SCHEDULE: (V, C_in,
# C_out) of each distinct 3^3 conv shape on the wgmma route, levels 0-4
# (the stem and up4, stage1 and up3, stage2 and up2, stage3 and up1,
# stage4)
K4_PATH_SHAPES = [
    (131072, 32, 32), (131072, 128, 96), (131072, 96, 96),
    (91904, 32, 32), (91904, 128, 96), (91904, 96, 96),
    (46080, 32, 64), (46080, 64, 64), (46080, 192, 128), (46080, 128, 128),
    (19712, 64, 128), (19712, 128, 128), (19712, 384, 256), (19712, 256, 256),
    (7936, 128, 256), (7936, 256, 256),
]


@pytest.mark.parametrize("v,c_in,c_out", K4_PATH_SHAPES)
def test_k4_plan_from_shapes(v, c_in, c_out):
    """K4's wgmma tile takes the whole C_out up to 256 columns (a feats row
    is gathered once) and 128 C_in rows where C_in >= 256 (a g row is
    gathered ceil(C_in / 128) times); its ring fits the H100's shared
    memory; the grid's pieces cover every split of 27 lists of up to V
    pairs, and the target is one wave of live blocks."""
    p = tf3.k4_plan(v, c_in, c_out)
    assert p.bn >= c_out and p.bn in (32, 64, 96, 128, 256) and p.bn - c_out < 32 + 96 * (p.bn == 256)
    assert p.cw == (2 if c_in >= 256 else 1)
    tiles = tf3.k4_tiles(c_in, c_out, p.cw, p.bn)
    assert tiles == -(-c_in // (64 * p.cw)) * -(-c_out // p.bn)
    assert tiles <= 3  # at 384 -> 256: g rows gathered 3 times, feats rows once
    assert tf3.k4_smem_bytes(p.cw, p.bn) <= tf3.K4_SMEM
    assert p.per_min == tf3.K4_MIN_PAIRS and tf3.k4_pieces(v, p.target, p.per_min) == max(p.target, 27) + 27
    wave = tf3.K4_SMS * tf3.k4_resident(p.cw, p.bn)
    assert p.target == -(-wave // tiles) and tiles * p.target < wave + tiles
    one = tf3.k4_one_split(v, c_in, c_out)
    assert (one.target, one.per_min, tf3.k4_pieces(v, one.target, one.per_min)) == (0, v, 54)


def _k4_pieces(starts, per_min, target, stage=64):
    """numpy model of K4's pieces over its 27 offset lists (csrc/conv_dw.cu,
    lists::split_pairs and piece_of): with a target, pairs per split the
    least multiple of the stage, at least per_min, at which the lists'
    pieces (each list at least one) number at most the target, else the
    longest list (found here by a linear scan; the kernel bisects); split
    z of list k takes pairs [z per, (z + 1) per) of k's list; a list of
    one piece goes straight to out, else piece z of list k is p(k, z) =
    (starts[k] - starts[0]) // per + k + z.  Returns (per, {(k, z):
    piece index or None})."""
    n = np.diff(starts)
    per = per_min
    if target > 0:
        per = -(-per_min // stage) * stage
        while np.maximum(1, -(-n // per)).sum() > target and per < n.max():
            per += stage
    out = {}
    for k in range(27):
        live = max(1, -(-int(n[k]) // per))
        for z in range(live):
            out[k, z] = None if live == 1 else (starts[k] - starts[0]) // per + k + z
    return per, out


def _k4_rulebook(case: str, v: int, rng) -> torch.Tensor:
    """(27, V) reverse tables: random neighbours with absent offsets,
    offsets without any pair, one-pair lists, the centre offset holding
    every row and nothing else."""
    rb = np.full((27, v), -1, np.int32)
    if case == "random":
        rb[:] = rng.integers(-2, v, (27, v))
        rb[[0, 9, 26]] = -1
    elif case == "one_pair":
        rb[np.arange(27), rng.integers(0, v, 27)] = rng.integers(0, v, 27)
        rb[5] = -1
    elif case == "centre":
        rb[13] = np.arange(v)
    return torch.from_numpy(rb)


@pytest.mark.parametrize("case", ["random", "one_pair", "centre", "empty"])
@pytest.mark.parametrize("per_min,target", [
    (64, 0), (256, 0), (256, 40), (64, 300), (4000, 0), (256, 10), (64, 27), (1, 132),
])
def test_k4_split_pieces_and_their_sum(case, per_min, target):
    """The pieces of K4's splits never collide and stay below the grid's
    `k4_pieces` blocks, with at most max(target, 27) of them, over lists
    of every length (empty, one pair, the centre offset holding every
    row, many splits); the kernel's bisection (`k4_split_pairs`, its host
    model) finds the scan's pairs per split; adding each list's pieces in
    split order gives `k3_conv_dw_pairs_plain` and `k3_conv_dw_plain`
    (f32).  ~0.5 s."""
    rng = np.random.default_rng(per_min + target)
    v, c_in, c_out = 3000, 8, 16
    rb = _k4_rulebook(case, v, rng)
    lists = tf3.k3_pair_lists(rb)
    starts = lists.starts.tolist()
    per, pieces = _k4_pieces(np.array(starts), per_min, target)
    assert per == tf3.k4_split_pairs(starts, per_min, target)
    used = [p for p in pieces.values() if p is not None]
    assert len(used) == len(set(used))
    assert max(used, default=-1) < tf3.k4_pieces(v, target, per_min)
    if target > 0:
        assert len(pieces) <= max(target, 27)
    if case == "centre":
        assert starts[13] == 0 and starts[14] == starts[27] == v
    x = torch.from_numpy(rng.normal(size=(v, c_in)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(v, c_out)).astype(np.float32))
    pairs = lists.pairs.long()
    got = torch.zeros(27, c_in, c_out)
    for (k, z), _ in sorted(pieces.items()):
        lo = starts[k] + z * per
        p = pairs[lo : min(lo + per, starts[k + 1])]
        got[k] = got[k] + x[p[:, 0]].t() @ y[p[:, 1]]
    ref = tf3.k3_conv_dw_plain(x.abs(), y.abs(), rb).abs().max().clamp(min=1e-6)
    assert (got - tf3.k3_conv_dw_pairs_plain(x, y, lists)).abs().max() <= 1e-5 * ref
    assert (got - tf3.k3_conv_dw_plain(x, y, rb)).abs().max() <= 1e-5 * ref
    empty = [k for k in range(27) if starts[k + 1] == starts[k]]
    assert not got[empty].any()


def test_k4_launches_once_per_call(monkeypatch):
    """K4 on its wgmma route is one C entry per call, counted under
    `k3_conv_dw` and `k3_conv_dw_wgmma`, with the plan's tile and pieces,
    the partial buffer and the counters (the pairs per split follow the
    lists' lengths on the device); with every list in one piece, neither.
    The stem's 4 -> 32 takes the same tile at C_in padded to 8.  (The
    launch is recorded, not made.)"""
    calls = []
    monkeypatch.setattr(_build, "dispatch", lambda t: True)
    monkeypatch.setattr(_build, "check_aligned", lambda **t: None)
    monkeypatch.setattr(_build, "zeroed_counters", lambda dev, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(_build, "launch", lambda name, counters, *a: calls.append((name, counters, a)))
    v = 500
    rb = _k4_rulebook("random", v, np.random.default_rng(0))
    x, g = torch.ones(v, 384, dtype=torch.bfloat16), torch.ones(v, 256, dtype=torch.bfloat16)
    tf3.k3_conv_dw(x, g, rb)
    lists = tf3.k3_pair_lists(rb)
    tf3.k3_conv_dw_wgmma(x, g, lists, tf3.k4_one_split(v, 384, 256))
    tf3.k3_conv_dw(torch.ones(v, 4, dtype=torch.bfloat16), torch.ones(v, 32, dtype=torch.bfloat16), rb)
    wg = ("k3_conv_dw", "k3_conv_dw_wgmma")
    assert [c[:2] for c in calls] == [("taseg_k3_conv_dw_wgmma", wg)] * 3
    assert calls[2][2][7:9] == (8, 32)
    p = tf3.k4_plan(v, 384, 256)
    plan, one = calls[0][2], calls[1][2]  # (..., part, cnt, c_in, c_out, cw, bn, pieces, per_min, target)
    pieces = tf3.k4_pieces(v, p.target, 256)
    assert plan[5] is not None and plan[6] is not None and plan[7:] == (384, 256, 2, 256, pieces, 256, p.target)
    assert (tf3.k4_tiles(384, 256, p.cw, p.bn), pieces) == (3, max(p.target, 27) + 27)
    assert one[5] is None and one[6] is None and one[7:] == (384, 256, 2, 256, 54, v, 0)


def test_cuda_resolution_switches_tf32_off(monkeypatch):
    """Resolving a CUDA device (every entry point does: `Segmenter`,
    `Trainer`, the models) sets cuDNN's and the matmuls' TF32 flags to
    False for the process; a CPU device leaves them as they are.  (CUDA
    is reported present, not used.)"""
    from taseg_tpu_torch import resolve_device

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("dtype,entry,suffix", [
    (torch.bfloat16, "taseg_strided_dw_wgmma", "_wgmma"),
    (torch.float32, "taseg_strided_dw_tf32", "_tf32"),
])
def test_k5_launches_once_per_call(monkeypatch, dtype, entry, suffix):
    """K5 on either tensor-core route is one C entry per call, counted
    under `strided_dw` and its route's entry, with the partial buffer and
    the counters only where a list can be split: the bf16 wgmma tile with
    its pairs per split from the shapes (`k5_splits`), the f32 3xTF32
    wgmma tile with `dw_tf32_plan`'s least pairs per split and target and
    `dw_pieces` blocks a tile.  (The launch is recorded, not made.)"""
    calls = []
    monkeypatch.setattr(_build, "dispatch", lambda t: True)
    monkeypatch.setattr(_build, "check_aligned", lambda **t: None)
    monkeypatch.setattr(_build, "zeroed_counters", lambda dev, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(_build, "launch", lambda name, counters, *a: calls.append((name, counters, a)))
    for v in (200, 20000):
        tab = tst.StridedTables(
            parent=torch.zeros(v, dtype=torch.int32), slot=torch.zeros(v, dtype=torch.int32),
            perm=torch.arange(v, dtype=torch.int32), starts=torch.tensor([0, v], dtype=torch.int32),
        )
        tst.strided_dw(torch.ones(v, 32, dtype=dtype), torch.ones(1, 64, dtype=dtype), tab, False)
    assert [(c[0], c[1]) for c in calls] == [(entry, ("strided_dw", "strided_dw" + suffix))] * 2
    small, big = (c[2] for c in calls)
    assert small[5] is None and small[6] is None
    assert big[5] is not None and big[6] is not None
    if dtype == torch.bfloat16:  # (..., pieces, pairs per split)
        assert small[-2] == 8 and big[-2] == 20000 // big[-1] + 9
    else:  # (..., up, pieces, least pairs per split, target)
        p = tf3.dw_tf32_plan(32, 64)
        assert small[-3:] == (tf3.dw_pieces(8, 200, p.target, p.per_min), p.per_min, p.target)
        assert big[-3:] == (tf3.dw_pieces(8, 20000, p.target, p.per_min), p.per_min, p.target)
        assert small[-4] == big[-4] == 0  # the down direction


def test_launch_counters_have_the_route_entries():
    assert set(_build.LAUNCHES) == {
        "join_scan", "sparse_conv_k3", "sparse_conv_k3_wgmma",
        "strided_down", "strided_down_wgmma", "strided_down_tf32", "strided_down_rounds",
        "strided_up", "strided_up_wgmma", "strided_up_tf32",
        "sparse_conv_k3_dgrad", "sparse_conv_k3_dgrad_wgmma",
        "strided_down_dgrad", "strided_down_dgrad_wgmma", "strided_down_dgrad_tf32",
        "strided_down_dgrad_rounds",
        "strided_up_dgrad", "strided_up_dgrad_wgmma", "strided_up_dgrad_tf32",
        "k3_conv_dw", "k3_conv_dw_wgmma", "strided_dw", "strided_dw_wgmma", "strided_dw_tf32",
        "segment_sum", "devoxelize", "devoxelize_bilinear", "devoxelize_multi", "voxelize_bwd",
        "sparse_conv_k", "sparse_conv_k_wgmma", "sparse_conv_k_dgrad",
        "sparse_conv_k_dgrad_wgmma", "sparse_conv_dw",
        "sparse_conv_k_tf32", "sparse_conv_k_dgrad_tf32", "sparse_conv_dw_tf32", "knn",
        "segment_max", "segment_max_bwd",
    }
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values())


def test_cpu_tensors_launch_nothing():
    """On CPU tensors the wrappers run the plain versions and count no
    launch, on either route's widths."""
    _build.reset_launches()
    rb = torch.full((27, 16), -1, dtype=torch.int32)
    rb[13] = torch.arange(16, dtype=torch.int32)  # the centre offset
    x = torch.ones(16, 8, dtype=torch.bfloat16)
    out = tsc.sparse_conv_k3(x, torch.ones(27, 8, 8, dtype=torch.bfloat16), rb)
    assert torch.equal(out, torch.full((16, 8), 8.0, dtype=torch.bfloat16))
    assert not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_devoxelize_launches_nothing(dtype):
    """K7's wrappers run the plain versions on CPU tensors and count no
    launch, with and without autograd."""
    vox = torch.arange(12, dtype=torch.float32).reshape(4, 3).to(dtype)
    inv = torch.tensor([2, -1, 0], dtype=torch.int32)
    idx = torch.full((8, 3), -1, dtype=torch.int32)
    idx[0], idx[5, 1] = torch.tensor([1, 3, -1], dtype=torch.int32), 0
    w = torch.zeros(8, 3)
    w[0], w[5, 1] = torch.tensor([0.5, 0.25, 0.0]), 0.75
    tri = tvx.DevoxTable(idx=idx, weights=w, pairs=tvx.build_segment_tables(idx.reshape(-1), 4))
    ident = tvx.IdentityDevoxTable(inverse=inv, tables=tvx.build_segment_tables(inv, 4))
    _build.reset_launches()
    got = tvx.devoxelize(vox, ident)
    assert torch.equal(got, torch.stack([vox[2], torch.zeros(3, dtype=dtype), vox[0]]))
    assert torch.equal(tvx.devoxelize_identity(vox, inv), got)
    want = torch.stack([vox[1] * 0.5, vox[3] * 0.25 + vox[0] * 0.75, torch.zeros(3, dtype=dtype)])
    assert torch.equal(tvx.devoxelize(vox, tri), want)
    v = vox.clone().requires_grad_()
    tvx.devoxelize(v, tri).float().sum().backward()
    assert v.grad is not None and not any(_build.LAUNCHES.values())


@pytest.mark.parametrize("corners", [4, 8])
def test_devoxelize_corner_entries(corners, monkeypatch):
    """K7 picks its C entry by the table's corner count: (4, P) tables
    (RPVNet's `range_to_point`) the bilinear one, counted under
    `devoxelize` and `devoxelize_bilinear`; (8, P) the trilinear one,
    under `devoxelize` only.  (The launch is recorded, not made: the
    route is a pure function of the table.)"""
    calls = []
    monkeypatch.setattr(_build, "dispatch", lambda t: True)
    monkeypatch.setattr(_build, "launch", lambda name, counters, *a: calls.append((name, counters)))
    idx = torch.zeros(corners, 5, dtype=torch.int32)
    table = tvx.DevoxTable(idx=idx, weights=torch.zeros(corners, 5))
    tvx.devoxelize_trilinear(torch.ones(3, 4), table)
    want = ("taseg_devox_bilinear", ("devoxelize", "devoxelize_bilinear")) if corners == 4 else (
        "taseg_devox_trilinear", ("devoxelize",))
    assert calls == [want]


def test_tensor_core_route_rejects_misaligned_rows():
    """The tensor-core kernels copy rows in 16-byte pieces: a tensor whose
    data starts off a 16-byte boundary is refused before any launch."""
    base = torch.zeros(8 * 9, dtype=torch.bfloat16)
    _build.check_aligned(feats=base[:64].view(8, 8))
    with pytest.raises(ValueError, match="feats: data not 16-byte aligned"):
        _build.check_aligned(feats=base[1:65].view(8, 8))


def test_served_weight_is_cast_and_padded_once():
    """A served conv (no autograd recording) casts its kernel once and the
    padded copy of that cast is made once, both kept while the kernel's
    version holds; a train call casts and pads anew; an in-place change
    of the kernel (an optimizer step) drops both.  In f32 the served
    weight is the kernel itself, detached."""
    torch.manual_seed(0)
    conv = SparseConv(51, 23, 27)
    torch.nn.init.normal_(conv.kernel)
    with torch.no_grad():
        w = conv.kernel_as(torch.bfloat16)
        assert conv.kernel_as(torch.bfloat16) is w and not w.requires_grad
        assert conv.kernel_as(torch.float32).data_ptr() == conv.kernel.data_ptr()
    p = tsc.pad_weight(w, 56, 24)
    assert tsc.pad_weight(w, 56, 24) is p and p.shape == (27, 56, 24) and p.is_contiguous()
    assert torch.equal(p[:, :51, :23], w) and not p[:, 51:].any() and not p[:, :, 23:].any()
    trained = conv.kernel_as(torch.bfloat16)
    assert trained is not w and trained.requires_grad
    assert tsc.pad_weight(trained, 56, 24) is not tsc.pad_weight(trained, 56, 24)
    with torch.no_grad():
        conv.kernel.add_(1.0)
        w2 = conv.kernel_as(torch.bfloat16)
    assert w2 is not w and torch.equal(w2, conv.kernel.detach().bfloat16())
    w.add_(1.0)  # a change of the cast itself: its padded copy is made again
    assert torch.equal(tsc.pad_weight(w, 56, 24)[:, :51, :23], w)


@pytest.mark.parametrize("dtype,ci,co", [(torch.bfloat16, 56, 24), (torch.float32, 52, 24)])
def test_wrappers_take_padded_inputs_as_they_are(monkeypatch, dtype, ci, co):
    """K2 at 27 and at K take an input zero-padded to the route's width
    (as the autograd Functions save it) without copying it again, pad a
    logical input once, hand the kernel the padded weight (the same copy
    on every call for a served weight) and return the logical output
    columns; an input of any other width is refused.  (The launches are
    recorded, not made.)"""
    calls = []
    monkeypatch.setattr(_build, "dispatch", lambda t: True)
    monkeypatch.setattr(_build, "check_aligned", lambda **t: None)
    monkeypatch.setattr(_build, "launch", lambda name, counters, *a: calls.append((name, a)))
    v = 300
    rb = _k4_rulebook("random", v, np.random.default_rng(1))
    w = torch.ones(27, 51, 23, dtype=dtype)
    x = torch.ones(v, 51, dtype=dtype)
    xp = tsc.pad_cols(x, ci)
    call = tsc.sparse_conv_k3 if dtype == torch.bfloat16 else tsc.sparse_conv
    for feats in (xp, x, xp):
        out = call(feats, w, rb)
        assert out.shape == (v, 23) and out.is_contiguous()
    (_, a0), (_, a1), (_, a2) = calls
    assert a0[0] == xp.data_ptr() == a2[0] and a1[0] != x.data_ptr()
    assert a0[1] == a1[1] == a2[1] != w.data_ptr()  # one padded copy of the weight
    assert a0[-5:-3] == (ci, co) and a0[-1] == 23
    with pytest.raises(ValueError, match="do not fit"):
        call(tsc.pad_cols(x, ci + 8), w, rb)


def test_k6_pads_rows_that_need_16_pieces(monkeypatch):
    """K6 runs 409 bf16 channels (16 pieces of 2 bytes a lane at their own
    width) on a copy padded to 416 columns, 2 pieces of 16 bytes a lane,
    and returns the 409 logical columns; 153 channels (8 pieces of 2
    bytes) run as they are, and so do 409 f32 channels (16 pieces of 4
    bytes).  (The launches are recorded, not made.)"""
    calls = []
    monkeypatch.setattr(_build, "dispatch", lambda t: True)
    monkeypatch.setattr(_build, "zeroed_counters", lambda dev, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(_build, "launch", lambda name, counters, *a: calls.append((name, a)))
    ids = torch.from_numpy(np.random.default_rng(2).integers(-1, 50, 400).astype(np.int32))
    tables = tvx.build_segment_tables(ids, 64)
    for c in (409, 153):
        src = torch.ones(400, c, dtype=torch.bfloat16)
        out = tvx.segment_sum(src, tables)
        assert out.shape == (64, c) and out.is_contiguous() and out.dtype == torch.float32
        a = calls[-1][1]
        assert (a[0] == src.data_ptr()) == (c == 153)
        # (..., v, cols, r_real, p, n, dtype, vw, lanes, pieces, unit, rows)
        assert a[7:9] == (64, 416 if c == 409 else 153) and a[13:16] == ((16, 32, 2) if c == 409 else (2, 32, 8))
    src = torch.ones(400, 409)
    assert tvx.segment_sum(src, tables).shape == (64, 409)
    assert calls[-1][1][0] == src.data_ptr() and calls[-1][1][8] == 409 and calls[-1][1][13:16] == (4, 32, 16)


def _cpu_level(seed: int):
    """A level of ~1500 voxels with its 3^3 rulebook and one strided
    level pair (a one-round child table, the up table and the slot pair
    lists), on the CPU."""
    from taseg_tpu_torch.ops import coords as tc
    from taseg_tpu_torch.ops import join as tj
    from taseg_tpu_torch.ops import rulebook as tr

    rng = np.random.default_rng(seed)
    coords = np.concatenate([rng.integers(0, 16, size=(2000, 3)), rng.integers(0, 2, size=(2000, 1))], 1)
    c = torch.from_numpy(coords.astype(np.int32))
    valid = torch.ones(len(c), dtype=torch.bool)
    b = tc.compute_bounds(c, valid)
    u, num, _, _ = tj.unique_coords(c, valid, b, 4096)
    rb = tr.build_rulebook_k3(u, num, 1, b)
    _, _, par, cnt, perm = tr.spdownsample(u, num, 2, 1, b, 2048, return_inverse=True)
    tab = tst.build_strided_tables(u, num, par, cnt, perm, 1)
    child = tst.slot_child_table(tab, rounds=1)
    tab = replace(tab, child=child, child_order=tsc.mask_row_order(child[0]), up=tst.slot_up_table(tab),
                  pairs=tst.slot_pair_lists(tab))
    return rng, rb, tab


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_functions_pad_once_and_return_logical_gradients(monkeypatch, dtype):
    """The autograd Functions at ragged widths on the tensor-core routes,
    with each kernel emulated by its plain version at the padded widths
    it is handed: the 3^3 conv 51 -> 23 (K3Conv in bf16, SparseConvK at
    K = 27 in f32) and the strided pair 51 -> 102 both ways give the
    logical output, d_feats and d_W (contiguous, in the operands' dtype)
    of the plain versions; every kernel sees 16-byte widths, and the
    forward's input and the cotangent are each padded once for the two
    kernels that read them."""
    rng, rb, tab = _cpu_level(3)
    rb_bwd = tsc.flip_rulebook(rb)
    seen = []

    def conv_tile(x, w, table, order, out, counters, **kw):
        seen.append(("conv", x.data_ptr(), x.shape[1], w.shape[1:]))
        out.copy_(tsc.sparse_conv_plain(x, w, table)[:, : out.shape[1]])

    def dw(x, g, lists, *a):
        seen.append(("dw", x.data_ptr(), x.shape[1], g.shape[1]))
        return tf3.k3_conv_dw_plain(x.float(), g.float(), lists)

    def strided_dw_tile(x, y, pairs, v_fine, up, route):
        seen.append(("dw", x.data_ptr(), x.shape[1], y.shape[1]))
        return tst.strided_dw_plain(x.float(), y.float(), tab, up)

    monkeypatch.setattr(_build, "dispatch", lambda t: True)
    for mod in (tsc, tst):
        monkeypatch.setattr(mod, "launch_wgmma", conv_tile)
        monkeypatch.setattr(mod, "launch_k_tf32", conv_tile)
    monkeypatch.setattr(tf3, "k3_pair_lists", lambda t: t)
    monkeypatch.setattr(tf3, "pair_lists", lambda t: t)
    monkeypatch.setattr(tf3, "k3_conv_dw_wgmma", dw)
    monkeypatch.setattr(tf3, "launch_dw_tf32", lambda name, counter, x, g, lists, *a: dw(x, g, lists))
    monkeypatch.setattr(tst, "_strided_dw_lists", strided_dw_tile)

    def k3(x, w, g):
        return (tsc.sparse_conv_plain(x, w, rb), tsc.sparse_conv_plain(g, w.transpose(1, 2), rb_bwd),
                tf3.k3_conv_dw_plain(x, g, rb_bwd))

    def down(x, w, g):
        return (tst.downsample_conv_slot_plain(x, w, tab.child), tst.upsample_conv_plain(g, w.transpose(1, 2), tab),
                tst.strided_dw_plain(x, g, tab, False))

    def up(x, w, g):
        return (tst.upsample_conv_plain(x, w, tab), tst.downsample_conv_slot_plain(g, w.transpose(1, 2), tab.child),
                tst.strided_dw_plain(x, g, tab, True))

    v, v_fine, v_coarse = rb.shape[1], tab.parent.shape[0], tab.starts.shape[0] - 1
    for conv, plain, v_in, v_out, k, c_out in (
        (lambda x, w: tsc.k3_conv(x, w, rb, rb_bwd), k3, v, v, 27, 23),
        (lambda x, w: tst.downsample_conv(x, w, tab), down, v_fine, v_coarse, 8, 102),
        (lambda x, w: tst.upsample_conv(x, w, tab), up, v_coarse, v_fine, 8, 102),
    ):
        x = torch.from_numpy(rng.normal(size=(v_in, 51)).astype(np.float32)).to(dtype).requires_grad_()
        w = torch.from_numpy(rng.normal(size=(k, 51, c_out)).astype(np.float32) / 20).to(dtype).requires_grad_()
        g = torch.from_numpy(rng.normal(size=(v_out, c_out)).astype(np.float32)).to(dtype)
        seen.clear()
        out = conv(x, w)
        out.backward(g)
        q = 16 // x.element_size()
        assert all(s[2] % q == 0 for s in seen) and all(d % q == 0 for s in seen for d in s[3:] if isinstance(d, int))
        assert all(d % q == 0 for s in seen if s[0] == "conv" for d in s[3])
        (fwd, x_p), (dgrad, g_p), (wgrad, x_dw) = [(s[0], s[1]) for s in seen]
        assert (fwd, dgrad, wgrad) == ("conv", "conv", "dw") and x_p == x_dw  # the input padded once
        with torch.no_grad():
            want = plain(x.float(), w.float(), g.float())
        for got, shape, wt in zip((out.detach(), x.grad, w.grad), ((v_out, c_out), (v_in, 51), (k, 51, c_out)), want):
            assert got.shape == shape and got.is_contiguous() and got.dtype == dtype
            tol = 1e-5 * wt.abs().max().item() if dtype == torch.float32 else 2.0**-7 * wt.abs().max().item()
            assert (got.float() - wt).abs().max().item() <= tol
