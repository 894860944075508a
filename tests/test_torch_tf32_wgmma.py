"""The f32 gather-conv's 3xTF32 tile on Hopper's wgmma, and K8's layouts,
on the CPU (no kernel runs here; the card tests are
`test_torch_cuda.py -m cuda -k "tf32_wgmma or voxelize_bwd"`):

  * the tile's plan (`sparse_conv.tf32_tile`: output columns a block,
    column blocks, 32-channel stages per offset, shared memory, blocks an
    SM) at every f32 width of a recipe's conv over K offsets and of its
    input gradient: Cylinder cy480's, TIAF's main branch and FOV branch
    (the 3^3 convs at K = 27 and K3 at 8), the heads' 128 -> 20 and
    Waymo's 128 -> 23, ragged widths padded to 4s; the split rule of the
    coarse levels unchanged;
  * the K-major weight operand both ways: the forward hands the launch
    W as stored, (K, C_in, C_out), and the split reads it transposed; the
    input gradient hands W^T as a view of W (no copy), which the split
    reads as W is stored; a served weight keeps its operand;
  * a plain-torch emulation of the tile's arithmetic (A and B split into
    TF32 high and low parts, lo*hi + hi*lo + hi*hi a stage, the stages
    added in f32) within 1e-5 of the largest sum of |terms| of an f64
    product, and, on a conv's forward and input gradient, of JAX's
    `sparse_conv_apply` and `jax.vjp`;
  * K8's layout and piece at SPVCNN cr 1.6's point widths (51 bf16, 204
    and 409 f32, 153 bf16) and at aligned ones, and the layout code the
    wrapper hands its C entry.

About 7 s on one worker (`--durations`; 6.0-6.7 s in three runs), 2 s of it
JAX compiling the conv and its VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.ops.sparse_conv import sparse_conv_apply
from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.ops import f3conv as tf3
from taseg_tpu_torch.ops import sparse_conv as tsc
from taseg_tpu_torch.ops import strided_conv as tst
from taseg_tpu_torch.ops import voxelize as tvx


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (C_in, C_out, K) of every conv over K offsets of Cylinder cy480
# (INIT_SIZE 32) and of TIAF's f32 3^3 convs and K3 (the _fsa_tiaf
# recipe); `test_widths_are_the_recipes` rebuilds both on the meta device
CY480 = [
    (16, 32, 9), (32, 32, 9), (32, 64, 8), (64, 64, 3), (64, 64, 9), (64, 128, 8), (96, 64, 9),
    (128, 20, 27), (128, 64, 8), (128, 128, 9), (128, 256, 4), (192, 128, 9), (256, 128, 8),
    (256, 256, 9), (256, 512, 4), (384, 256, 9), (512, 256, 4), (512, 512, 4), (512, 512, 9),
    (768, 512, 9),
]
TIAF = [
    (5, 32, 27), (16, 16, 8), (16, 16, 27), (16, 32, 27), (32, 32, 8), (32, 32, 27), (32, 64, 27),
    (48, 48, 8), (48, 48, 27), (64, 48, 8), (64, 48, 27), (64, 64, 8), (64, 64, 27), (64, 128, 27),
    (88, 16, 27), (96, 64, 27), (96, 96, 8), (96, 96, 27), (128, 64, 8), (128, 96, 8), (128, 96, 27),
    (128, 128, 8), (128, 128, 27), (128, 256, 27), (192, 128, 27), (256, 128, 8), (256, 256, 8),
    (256, 256, 27), (384, 256, 27),
]
# Waymo Cylinder's 23-class head and ragged widths that the wrappers pad
EXTRA = [(128, 23, 27), (51, 102, 9), (4, 51, 27)]


def _with_grads(widths):
    """The widths and their input gradients' (C_in and C_out swapped)."""
    return sorted(set(widths) | {(b, a, k) for a, b, k in widths})


PLAN_WIDTHS = _with_grads(CY480 + TIAF + EXTRA)


def test_widths_are_the_recipes():
    """CY480 and TIAF hold every conv over more than one offset of the
    cy480 model and of TIAF's model (the recipes' widths, built on the
    meta device)."""
    from taseg_tpu_torch.configs import RECIPES
    from taseg_tpu_torch.models import build_segmentor
    from taseg_tpu_torch.models.layers import SparseConv
    from taseg_tpu_torch.models.voxel.cylinder3d import CylinderTS

    def widths(m):
        return sorted({(c.in_channels, c.out_channels, c.kernel_volume) for c in m.modules()
                       if isinstance(c, SparseConv) and c.kernel_volume > 1})

    assert widths(CylinderTS(20, init_size=32, device="meta")) == CY480
    tiaf = RECIPES["tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10_fsa_tiaf.yaml"]
    assert widths(build_segmentor(tiaf, device="meta")) == TIAF


@pytest.mark.parametrize("c_in,c_out,k", PLAN_WIDTHS)
def test_tile_plan_at_recipe_widths(c_in, c_out, k):
    """At the padded widths: at most 128 output columns a block, the
    fewest 128-column blocks that hold C_out (a 512-wide conv gathers its
    rows 4 times, a 256-wide one twice), C_in / 32 stages a present
    offset, shared memory within a block's 227 KB at every K <= 32, two
    blocks an SM (within the SM's 228 KB) for tiles of 64 columns or
    fewer; the f32 route is 3xTF32 at every width."""
    ci, co = tsc.padded_width(torch.float32, c_in), tsc.padded_width(torch.float32, c_out)
    assert ci % 4 == 0 and co % 4 == 0 and tsc.k_route(torch.float32, c_in, c_out) == "tf32x3"
    p = tsc.tf32_tile(ci, co, k)
    assert p.bn in tsc.TF32_TILE_COLS and (p.bn >= co or p.bn == 128)
    assert p.column_blocks == -(-co // p.bn) and (p.column_blocks - 1) * p.bn < co
    assert p.chunks == -(-ci // 32)
    assert tsc.tf32_tile(ci, co, 32).smem_bytes <= tsc.SMEM_PER_BLOCK
    if p.blocks_per_sm == 2:
        assert p.bn <= 64 and 2 * (tsc.tf32_tile(ci, co, 32).smem_bytes + 1024) <= 228 * 1024
    if co == 512:
        assert p.column_blocks == 4
    if co == 24:  # Waymo's head at C_out padded to 24: one 32-column block
        assert (p.bn, p.column_blocks) == (32, 1)


def test_split_rules_unchanged():
    """The coarse levels still cut each tile's chain: K2 at K in
    `K_SPLITS` parts up to `K_SPLIT_ROWS` output rows, K3 at most one part
    per 16 stages of its 8 slots; the chain counts 32-channel stages, as
    before the wgmma tile."""
    assert [tsc.k_splits(v) for v in (1, 12_000, 32_768, 32_769, 131_072)] == [4, 4, 4, 1, 1]
    assert [tst.k3_tf32_splits(20_000, c) for c in (32, 64, 128, 256)] == [1, 1, 2, 4]
    assert tsc.TF32_STAGE_CHANNELS == 32


def _recording(monkeypatch):
    calls = []
    monkeypatch.setattr(_build, "dispatch", lambda t: True)
    monkeypatch.setattr(_build, "check_aligned", lambda **t: None)
    monkeypatch.setattr(_build, "zeroed_counters", lambda dev, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(_build, "launch", lambda name, counters, *a: calls.append((name, counters, a)))
    return calls


def _table(rng, k, v_in, v_out):
    rb = rng.integers(0, v_in, (k, v_out)).astype(np.int32)
    rb[rng.random((k, v_out)) < 0.4] = -1
    return torch.from_numpy(rb)


def test_weight_operand_both_ways(monkeypatch):
    """The forward hands the 3xTF32 launch W as stored (K, C_in, C_out),
    strides (C_in C_out, C_out, 1): the split reads it across C_out and
    writes it K-major; the input gradient (`f3conv.sparse_conv_bwd`) hands
    W^T as a view of W, strides (C_in C_out, 1, C_out): the same storage,
    no transposed copy, read as W is stored; each launch splits
    (`fresh`) a weight that takes a gradient.  Arguments: (feats, w, rb,
    order, out, part, live, operand, fresh, s_k, s_ci, s_co, V_out, C_in,
    C_out, K, splits, ldo).  (The launches are recorded, not made.)"""
    calls = _recording(monkeypatch)
    rng = np.random.default_rng(1)
    k, v_in, v_out, c_in, c_out = 9, 300, 200, 64, 32
    rb = _table(rng, k, v_in, v_out)
    rb_bwd = _table(rng, k, v_out, v_in)
    x = torch.randn(v_in, c_in)
    w = torch.randn(k, c_in, c_out, requires_grad=True)
    tsc.sparse_conv(x, w, rb)
    tf3.sparse_conv_bwd(x, w.detach().requires_grad_(), torch.randn(v_out, c_out), rb_bwd)
    convs = [a for name, _, a in calls if name == "taseg_sparse_conv_k_tf32"]
    (fwd, dgrad) = convs
    assert fwd[1] == w.data_ptr() and fwd[8] == 1 and fwd[9:12] == (c_in * c_out, c_out, 1)
    assert fwd[12:] == (v_out, c_in, c_out, k, tsc.k_splits(v_out), c_out)
    assert dgrad[1] == w.data_ptr() and dgrad[8] == 1 and dgrad[9:12] == (c_in * c_out, 1, c_out)
    assert dgrad[12:] == (v_in, c_out, c_in, k, tsc.k_splits(v_in), c_in)


def test_served_weight_keeps_its_operand(monkeypatch):
    """A weight that takes no gradient is split by its first launch only
    (the operand buffer kept beside it while its version holds); an
    in-place change splits it again; a ragged weight's operand is kept
    beside its padded copy."""
    calls = _recording(monkeypatch)
    rng = np.random.default_rng(2)
    rb = _table(rng, 27, 100, 100)
    x = torch.randn(100, 128)
    for w in (torch.randn(27, 128, 20), torch.randn(27, 128, 23)):
        calls.clear()
        for _ in range(3):
            tsc.sparse_conv(x, w, rb)
        w.add_(1.0)
        tsc.sparse_conv(x, w, rb)
        args = [a for _, _, a in calls]
        assert [a[8] for a in args] == [1, 0, 0, 1]
        assert args[0][7] == args[1][7] == args[2][7] and args[0][14] == 24 - 4 * (w.shape[2] == 20)


def _tf32_conv(x, w, rb):
    """The tile's arithmetic on CPU tensors: per offset and 32-channel
    stage, A = the gathered rows and B = W[k] split into TF32 high and low
    parts (B by the split's plain version), the stage's products lo*hi +
    hi*lo + hi*hi summed in f64 (the tensor cores' sum, exact enough
    here), each stage added to the running f32 sum."""
    k, v_out = rb.shape
    split = tsc.tf32_split_plain(w)  # (2, K, C_out, C_in)
    out = torch.zeros(v_out, w.shape[2])
    for j in range(k):
        idx = rb[j]
        a = torch.where((idx >= 0)[:, None], x[idx.clamp(min=0).long()], 0.0)
        for c0 in range(0, x.shape[1], 32):
            ah = tsc.tf32_round(a[:, c0:c0 + 32])
            al = tsc.tf32_round(a[:, c0:c0 + 32] - ah)
            bh, bl = split[0, j, :, c0:c0 + 32].T, split[1, j, :, c0:c0 + 32].T
            stage = al.double() @ bh.double() + ah.double() @ bl.double() + ah.double() @ bh.double()
            out = out + stage.float()
    return out


@pytest.mark.parametrize("c_in,c_out,k", [(32, 32, 9), (128, 20, 27), (768, 512, 9), (256, 512, 4), (88, 16, 27)])
def test_3xtf32_emulation_holds_the_f32_gate(c_in, c_out, k):
    """The tile's arithmetic (`_tf32_conv`) within 1e-5 of the largest
    sum of |terms| of the f64 product, at Cylinder's and TIAF's widths;
    the split's plain version: hi + lo within 2^-21 of each weight, hi
    and lo with 10 mantissa bits."""
    rng = np.random.default_rng(c_in + c_out + k)
    rb = _table(rng, k, 60, 48)
    x = torch.from_numpy(rng.normal(size=(60, c_in)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, c_in, c_out)) / np.sqrt(c_in)).astype(np.float32))
    want = tsc.sparse_conv_plain(x.double(), w.double(), rb)
    scale = tsc.sparse_conv_plain(x.abs().double(), w.abs().double(), rb).max().item()
    err = (_tf32_conv(x, w, rb).double() - want).abs().max().item()
    assert err <= 1e-5 * scale, err / scale
    hi, lo = tsc.tf32_split_plain(w)
    assert ((hi + lo).double() - w.transpose(1, 2).double()).abs().max() <= 2.0**-21 * w.abs().max()
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()


def test_3xtf32_conv_and_input_gradient_match_jax():
    """A conv over 9 offsets (64 -> 32, V_in 300, V_out 200) and its input
    gradient through the tile's arithmetic, the forward with W and the
    input gradient with W^T as a view of W, against JAX's
    `sparse_conv_apply` and `jax.vjp` of it: within 1e-5 of the largest
    sum of |terms|."""
    rng = np.random.default_rng(3)
    k, v_in, v_out = 9, 300, 200
    rb = _table(rng, k, v_in, v_out)
    rb_bwd = torch.full((k, v_in), -1, dtype=torch.int32)  # the reverse table, one pair an input row
    kk, vv = torch.nonzero(rb >= 0, as_tuple=True)
    rb_bwd[kk, rb[kk, vv].long()] = vv.int()
    keep = rb_bwd >= 0
    rb = torch.full_like(rb, -1)
    kk, ii = torch.nonzero(keep, as_tuple=True)
    rb[kk, rb_bwd[kk, ii].long()] = ii.int()
    x0 = rng.normal(size=(v_in, 64)).astype(np.float32)
    w0 = (rng.normal(size=(k, 64, 32)) / 8).astype(np.float32)
    g0 = rng.normal(size=(v_out, 32)).astype(np.float32)
    out, vjp = jax.vjp(lambda x, w: sparse_conv_apply(x, w, jnp.asarray(rb.numpy()), jnp.asarray(rb_bwd.numpy())),
                       jnp.asarray(x0), jnp.asarray(w0))
    jdx, _ = vjp(jnp.asarray(g0))
    x, w, g = torch.from_numpy(x0), torch.from_numpy(w0), torch.from_numpy(g0)
    w_t = w.transpose(1, 2)
    for got, want, scale in (
        (_tf32_conv(x, w, rb), out, tsc.sparse_conv_plain(x.abs(), w.abs(), rb).max()),
        (_tf32_conv(g, w_t, rb_bwd), jdx, tsc.sparse_conv_plain(g.abs(), w_t.abs(), rb_bwd).max()),
    ):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * float(scale)


@pytest.mark.parametrize("c,esz,base,want", [
    (51, 2, 0, ("flat", 16)), (204, 4, 0, ("rows", 16)), (409, 4, 0, ("flat", 16)),
    (153, 2, 0, ("flat", 16)), (409, 2, 0, ("flat", 16)), (32, 2, 0, ("rows", 16)),
    (96, 2, 0, ("rows", 16)), (256, 4, 0, ("rows", 16)), (20, 2, 0, ("flat", 16)),
    (64, 2, 2, ("flat", 16)), (3, 4, 0, ("rows", 4)), (4, 2, 0, ("rows", 8)),
])
def test_k8_piece_choice(c, esz, base, want):
    """K8's layout: rows whose bytes and g's base allow 16-byte pieces
    (204 and 256 f32, 32 and 96 bf16) take one thread a (point, 16-byte
    piece); narrower pieces (51 and 153 bf16: 2 bytes; 409 f32: 4; a
    base 2 bytes off) take the flat layout's 16-byte output pieces; rows
    narrower than 16 bytes the rows layout in their widest piece."""
    assert tvx.voxelize_bwd_plan(c, esz, base) == want
    assert tvx.voxelize_bwd_plan(c, esz, base, 2**31) == ("old", 16)


def test_k8_wrapper_hands_its_layout(monkeypatch):
    """The wrapper launches K8 once a call with the plan's layout code (1
    rows, 2 flat) for g at and off a 16-byte boundary."""
    calls = _recording(monkeypatch)
    inv = torch.tensor([0, 1, -1, 2], dtype=torch.int32)
    counts = torch.tensor([1, 1, 1], dtype=torch.int32)
    for c, dt, want in ((51, torch.bfloat16, 2), (204, torch.float32, 1), (409, torch.float32, 2)):
        g = torch.zeros(3, c, dtype=dt)
        out = tvx.voxelize_bwd(g, inv, counts)
        name, counters, a = calls[-1]
        assert (name, counters, out.shape) == ("taseg_voxelize_bwd", ("voxelize_bwd",), (4, c))
        assert a[-1] == want and a[-4:-1] == (4, c, tsc.DTYPE_CODES[dt])
    assert len(calls) == 3
