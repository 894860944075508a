"""Which kernel each conv of the main path takes on the card, decided on the
CPU from the modules' widths: K2 (`sparse_conv.route`), K3-down
(`strided_conv.downsample_route`) and K3-up (`strided_conv.upsample_route`)
K4 and K5, the weight gradients of the k3 conv and of the strided pair
(`f3conv.dw_route`), take the tensor-core route ("mma") in bf16 where
C_in and C_out are multiples of 8, the CUDA-core route ("simt") in f32
and at ragged widths.
MinkUNet mk34 cr1.0 at full width; nothing runs on a card here."""

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
    """Every 27-point conv but the stem's first (C_in = 4) is on tensor
    cores: 47 of the 48 K2 launches of a scan."""
    k3 = {n: m for n, m in convs.items() if m.kernel_volume == 27}
    routes = {n: tsc.route(torch.bfloat16, m.in_channels, m.out_channels) for n, m in k3.items()}
    assert len(k3) == 48
    assert [n for n, r in routes.items() if r == "simt"] == ["stem_0.SparseConv_0"]
    assert sum(r == "mma" for r in routes.values()) == 47


def test_k4_routes_in_bf16(convs):
    """The train step's d_W of every 27-point conv but the stem's first
    (C_in = 4) is on tensor cores: 47 of the 48 K4 launches of a step."""
    k3 = {n: m for n, m in convs.items() if m.kernel_volume == 27}
    routes = {n: tf3.dw_route(torch.bfloat16, m.in_channels, m.out_channels) for n, m in k3.items()}
    assert [n for n, r in routes.items() if r == "simt"] == ["stem_0.SparseConv_0"]
    assert sum(r == "mma" for r in routes.values()) == 47


def test_k5_routes_in_bf16(convs):
    """The train step's d_W of all 8 strided convs (down1-4 and the four
    deconvs) is on tensor cores: 8 of the 8 K5 launches of a step."""
    strided = {n: m for n, m in convs.items() if m.kernel_volume == 8}
    widths = sorted((m.in_channels, m.out_channels) for m in strided.values())
    assert widths == sorted(K5_PATH_WIDTHS)
    assert all(tf3.dw_route(torch.bfloat16, *wd) == "mma" for wd in widths)
    assert all(tf3.dw_route(torch.float32, *wd) == "simt" for wd in widths)


def test_k3_up_routes_in_bf16(convs):
    """All four transposed 8-point convs (the deconvs) are on tensor
    cores."""
    up = {n: m for n, m in convs.items() if m.kernel_volume == 8 and m.transposed}
    widths = sorted((m.in_channels, m.out_channels) for m in up.values())
    assert widths == [(96, 96), (128, 96), (256, 128), (256, 256)]
    assert all(
        tst.upsample_route(torch.bfloat16, m.in_channels, m.out_channels) == "mma"
        for m in up.values()
    )
    assert sum(m.kernel_volume == 8 and not m.transposed for m in convs.values()) == 4


def test_k3_down_routes_in_bf16(convs):
    """All four strided 8-point convs (down1-down4, C_in = C_out) are on
    tensor cores: 4 of the 4 K3-down launches of a scan."""
    down = {n: m for n, m in convs.items() if m.kernel_volume == 8 and not m.transposed}
    assert sorted(down) == [f"down{l}.SparseConv_0" for l in range(1, 5)]
    widths = [(down[n].in_channels, down[n].out_channels) for n in sorted(down)]
    assert widths == [(32, 32), (32, 32), (64, 64), (128, 128)]
    assert all(tst.downsample_route(torch.bfloat16, *wd) == "mma" for wd in widths)


def test_input_gradient_routes_in_bf16(convs):
    """The train step's input gradients run the forward kernels on W^T,
    with C_in and C_out swapped: the 47 of K2 (every 27-point conv but
    the stem's first, whose input needs no gradient), the 4 of K3-up
    (down's backward) and the 4 of K3-down (the deconvs' backward) all
    take the tensor-core route."""
    k3 = [m for n, m in convs.items() if m.kernel_volume == 27 and n != "stem_0.SparseConv_0"]
    assert len(k3) == 47
    assert all(tsc.route(torch.bfloat16, m.out_channels, m.in_channels) == "mma" for m in k3)
    for m in (m for m in convs.values() if m.kernel_volume == 8):
        back = tst.downsample_route if m.transposed else tst.upsample_route
        assert back(torch.bfloat16, m.out_channels, m.in_channels) == "mma"


def test_f32_routes_stay_on_cuda_cores(convs):
    for m in convs.values():
        assert tsc.route(torch.float32, m.in_channels, m.out_channels) == "simt"
        assert tst.upsample_route(torch.float32, m.in_channels, m.out_channels) == "simt"
        assert tst.downsample_route(torch.float32, m.in_channels, m.out_channels) == "simt"
        assert tf3.dw_route(torch.float32, m.in_channels, m.out_channels) == "simt"


@pytest.mark.parametrize(
    "c_in,c_out,want",
    [
        (4, 32, "simt"), (37, 70, "simt"), (64, 20, "simt"), (12, 8, "simt"),
        (8, 8, "mma"), (32, 32, "mma"), (40, 24, "mma"), (384, 256, "mma"),
    ],
)
def test_ragged_widths_take_the_simt_route(c_in, c_out, want):
    assert tsc.route(torch.bfloat16, c_in, c_out) == want
    assert tst.upsample_route(torch.bfloat16, c_in, c_out) == want
    assert tst.downsample_route(torch.bfloat16, c_in, c_out) == want
    assert tf3.dw_route(torch.bfloat16, c_in, c_out) == want
    assert tf3.dw_route(torch.float32, c_in, c_out) == "simt"


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
    """K5's tensor-core splits cover V_fine pairs (the most one slot can
    hold) in whole 32-pair stages and count the partials of 8 slots, not
    27, against their budget: never fewer pairs per split than K4's rule
    would give the same shape."""
    splits, per = tf3.dw_mma_splits(v, c_in, c_out, n_out=8)
    assert per % tf3.DW_MMA_STAGE == 0 and per >= tf3.DW_MMA_MIN_PAIRS
    assert splits * per >= v and (splits - 1) * per < v
    assert splits * 8 * c_in * c_out * 4 <= max(tf3.DW_MMA_PART_BYTES, 8 * c_in * c_out * 4)
    assert splits >= tf3.dw_mma_splits(v, c_in, c_out)[0]


def test_launch_counters_have_the_route_entries():
    assert set(_build.LAUNCHES) == {
        "join_scan", "sparse_conv_k3", "sparse_conv_k3_mma",
        "strided_down", "strided_down_mma", "strided_up", "strided_up_mma",
        "sparse_conv_k3_dgrad", "sparse_conv_k3_dgrad_mma",
        "strided_down_dgrad", "strided_down_dgrad_mma",
        "strided_up_dgrad", "strided_up_dgrad_mma",
        "k3_conv_dw", "k3_conv_dw_mma", "strided_dw", "strided_dw_mma",
        "segment_sum", "devoxelize",
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


def test_tensor_core_route_rejects_misaligned_rows():
    """The tensor-core kernels copy rows in 16-byte pieces: a tensor whose
    data starts off a 16-byte boundary is refused before any launch."""
    base = torch.zeros(8 * 9, dtype=torch.bfloat16)
    _build.check_aligned(feats=base[:64].view(8, 8))
    with pytest.raises(ValueError, match="feats: data not 16-byte aligned"):
        _build.check_aligned(feats=base[1:65].view(8, 8))
