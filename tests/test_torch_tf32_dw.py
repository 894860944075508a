"""The f32 weight gradients' 3xTF32 tile on Hopper's wgmma (K4 at K
offsets and K5 in f32, `csrc/wgmma_tf32_dw.cuh`) on the CPU: no kernel
runs here (the card tests are `test_torch_cuda.py -m cuda -k
"tf32_wgmma_dw or tf32_wgmma_k5"`):

  * the plan (`f3conv.dw_tf32_plan`: C_out columns a block, blocks a
    piece, the pieces' target, the least pairs per split) at every
    (C_in, C_out, K) of K4 at K on Cylinder cy480's, TIAF's main branch's
    and the Waymo Cylinder head's paths and at K5's f32 and path shapes:
    at most 128 columns, the pieces of lists as long as the level within
    one wave and inside the grid, one launch a call;
  * the launch that `sparse_conv_dw` and `strided_dw` make: its pieces,
    pairs per split and target, the counters, a (pieces, C_in, C_out)
    partial buffer only where a list can split, and no (splits, K, C_in,
    C_out) one;
  * a plain-torch emulation of the tile's arithmetic (both operands split
    into TF32 high and low parts, lo*hi + hi*lo + hi*hi a 32-pair stage,
    the stages added in f32, the pieces of a list added in split order)
    within 1e-4 of the largest sum of |terms| of JAX's d_W: `jax.vjp` of
    `sparse_conv_apply` at K = 9 and 27, and of `downsample_conv_apply`
    and `upsample_conv_apply`.

About 11 s on one worker (10.4-11.9 s in three runs, imports and
collection included), ~5 s of it JAX building the strided level's tables
and compiling the four gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.ops import (
    compute_bounds as j_bounds,
    downsample_conv_apply as j_down,
    spdownsample as j_spdown,
    unique_coords as j_unique,
    upsample_conv_apply as j_up,
)
from taseg_tpu.ops.sparse_conv import sparse_conv_apply
from taseg_tpu.ops.strided_conv import build_strided_tables as j_strided
from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.ops import coords as tc
from taseg_tpu_torch.ops import f3conv as tf3
from taseg_tpu_torch.ops import join as tj
from taseg_tpu_torch.ops import rulebook as tr
from taseg_tpu_torch.ops import sparse_conv as tsc
from taseg_tpu_torch.ops import strided_conv as tst
from test_torch_kernel_routes import K5_PATH_SHAPES
from test_torch_tf32_wgmma import CY480, EXTRA, TIAF

# d_W of each JAX function, jitted once for the module
J_CONV_DW = jax.jit(lambda x, w, rb, rbb, g: jax.vjp(lambda a: sparse_conv_apply(x, a, rb, rbb), w)[1](g)[0])
J_DOWN_DW = jax.jit(lambda x, w, tab, g: jax.vjp(lambda a: j_down(x, a, tab), w)[1](g)[0])
J_UP_DW = jax.jit(lambda x, w, tab, g: jax.vjp(lambda a: j_up(x, a, tab), w)[1](g)[0])

SMS = 132
SM_SMEM = 228 * 1024  # an SM's shared memory, 1 KB of it reserved per block


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recording(monkeypatch):
    """Record each launch (entry, counters, arguments) without making it,
    and every tensor `torch.empty` allocates (its shape)."""
    calls, shapes = [], []
    empty = torch.empty

    def recorded_empty(*size, **kw):
        t = empty(*size, **kw)
        shapes.append(tuple(t.shape))
        return t

    monkeypatch.setattr(_build, "dispatch", lambda t: True)
    monkeypatch.setattr(_build, "check_aligned", lambda **t: None)
    monkeypatch.setattr(_build, "zeroed_counters", lambda dev, n: torch.zeros(n, dtype=torch.int32))
    monkeypatch.setattr(_build, "launch", lambda name, counters, *a: calls.append((name, counters, a)))
    monkeypatch.setattr(torch, "empty", recorded_empty)
    return calls, shapes


# K4 at K: the recipes' (C_in, C_out, K) but K3's (the 8 slots of TIAF's
# strided convs); K5: those and MinkUNet's path shapes, at K = 8
K4_AT_K = sorted({w for w in CY480 + TIAF + EXTRA if w[2] != 8 or w in CY480})
K5_F32 = sorted({(c_in, c_out, 8) for c_in, c_out, k in TIAF if k == 8}
                | {(c_in, c_out, 8) for _, c_in, c_out in K5_PATH_SHAPES})


@pytest.mark.parametrize("c_in,c_out,k,strided", [w + (False,) for w in K4_AT_K] + [w + (True,) for w in K5_F32])
def test_dw_tile_plan_at_recipe_widths(monkeypatch, c_in, c_out, k, strided):
    """At the padded widths: at most 128 columns a block (the whole C_out
    up to 128), one 64-row C_in tile a block, shared memory within a
    block's 227 KB, two blocks an SM (registers and shared memory) at 64
    columns or fewer; the target's pieces fill at most one wave; lists as
    long as a level-0 table (131 072 rows, ~2/3 of them in every list)
    are cut into at most max(target, K) pieces (`k4_split_pairs`, the
    kernel's bisection at 32-pair stages), all inside the grid's
    `dw_pieces`; a call is one launch of the f32 entry."""
    ci, co = tsc.padded_width(torch.float32, c_in), tsc.padded_width(torch.float32, c_out)
    p = tf3.dw_tf32_plan(ci, co)
    assert p.bn in tf3.DW_TF32_TILE_COLS and (p.bn >= co or p.bn == 128)
    assert p.tiles == -(-ci // 64) * -(-co // p.bn)
    smem = tf3.dw_tf32_smem_bytes(p.bn)
    assert smem <= 232448
    resident = tf3.dw_tf32_resident(p.bn)
    assert resident == (2 if p.bn <= 64 else 1) and resident * (smem + 1024 + 4) <= SM_SMEM
    assert p.per_min % tf3.DW_TF32_STAGE == 0 and (p.target - 1) * p.tiles < SMS * resident <= p.target * p.tiles

    v = 131072
    lens = np.random.default_rng(c_in + c_out + k).integers(v // 2, 5 * v // 6, k)
    starts = np.concatenate([[0], np.cumsum(lens)]).tolist()
    per = tf3.k4_split_pairs(starts, p.per_min, p.target, tf3.DW_TF32_STAGE)
    pieces = [max(1, -(-int(n) // per)) for n in lens]
    assert per % tf3.DW_TF32_STAGE == 0 and per >= p.per_min and sum(pieces) <= max(p.target, k)
    last = max(starts[o] // per + o + pieces[o] - 1 for o in range(k))
    assert last < tf3.dw_pieces(k, v, p.target, p.per_min)

    calls, _ = _recording(monkeypatch)
    rows = 64
    x, y = torch.ones(rows, c_in), torch.ones(rows, c_out)
    if strided:
        tab = tst.StridedTables(
            parent=torch.zeros(rows, dtype=torch.int32), slot=torch.arange(rows, dtype=torch.int32) % 8,
            perm=torch.arange(rows, dtype=torch.int32), starts=torch.tensor([0, rows], dtype=torch.int32),
        )
        tst.strided_dw(x, y[:1], tab, False)
    else:
        tf3.sparse_conv_dw(x, y, torch.zeros((k, rows), dtype=torch.int32))
    entry = "taseg_strided_dw_tf32" if strided else "taseg_sparse_conv_dw_tf32"
    assert [c[0] for c in calls] == [entry]
    assert calls[0][2][7:9] == (ci, co)


def test_dw_launch_hands_pieces_and_no_split_buffer(monkeypatch):
    """`sparse_conv_dw` (K = 9 and 27) and `strided_dw` (down and up) in
    f32 hand their entry the pieces (`dw_pieces`), the least pairs per
    split and the target (`dw_tf32_plan`), and where a list can split
    (more rows than the least pairs per split) a (pieces, C_in, C_out)
    partial buffer and n_out x tiles counters; no launch allocates a
    (splits, K, C_in, C_out) buffer, and there is no second launch.
    Arguments: (x, y, pairs, starts, out, part, cnt, C_in, C_out, K or
    up, pieces, per_min, target)."""
    calls, shapes = _recording(monkeypatch)
    for k, v_in, c_in, c_out in ((9, 200, 64, 32), (27, 3000, 128, 20), (9, 3000, 768, 512)):
        calls.clear()
        shapes.clear()
        g = torch.ones(100, c_out)
        tf3.sparse_conv_dw(torch.ones(v_in, c_in), g, torch.zeros((k, v_in), dtype=torch.int32))
        ((name, counters, a),) = calls
        co = tsc.padded_width(torch.float32, c_out)
        p = tf3.dw_tf32_plan(c_in, co)
        pieces = tf3.dw_pieces(k, v_in, p.target, p.per_min)
        assert (name, counters) == ("taseg_sparse_conv_dw_tf32", ("sparse_conv_dw", "sparse_conv_dw_tf32"))
        assert a[7:] == (c_in, co, k, pieces, p.per_min, p.target)
        split = v_in > p.per_min
        assert (a[5] is not None, a[6] is not None) == (split, split)
        assert ((pieces, c_in, co) in shapes) == split
        assert not any(len(s) == 4 for s in shapes)
    for v, up in ((200, False), (20000, True)):
        calls.clear()
        shapes.clear()
        tab = tst.StridedTables(
            parent=torch.zeros(v, dtype=torch.int32), slot=torch.zeros(v, dtype=torch.int32),
            perm=torch.arange(v, dtype=torch.int32), starts=torch.tensor([0, v], dtype=torch.int32),
        )
        x, y = (torch.ones(1, 96), torch.ones(v, 64)) if up else (torch.ones(v, 96), torch.ones(1, 64))
        tst.strided_dw(x, y, tab, up)
        ((name, counters, a),) = calls
        p = tf3.dw_tf32_plan(96, 64)
        assert (name, counters) == ("taseg_strided_dw_tf32", ("strided_dw", "strided_dw_tf32"))
        assert a[7:] == (96, 64, int(up), tf3.dw_pieces(8, v, p.target, p.per_min), p.per_min, p.target)
        assert (a[5] is not None) == (a[6] is not None) == (v > p.per_min)
        assert not any(len(s) == 4 for s in shapes)


def _tile_dw(x, y, lists: tf3.PairLists, per: int) -> torch.Tensor:
    """The tile's arithmetic on CPU tensors: per list, its pairs cut into
    pieces of `per`; per piece, stages of 32 pairs, each stage's A = X^T
    and B = Y split into TF32 high and low parts (`tf32_round`), the
    stage's lo*hi + hi*lo + hi*hi summed in f64 (the tensor cores' sum,
    exact enough here) and added to the piece's f32 sum; the pieces
    added in f32 in split order."""
    s = lists.starts.tolist()
    out = []
    for o in range(len(s) - 1):
        p = lists.pairs[s[o] : s[o + 1]].long()
        xs, ys = x[p[:, 0]], y[p[:, 1]]
        total = torch.zeros(x.shape[1], y.shape[1])
        for z0 in range(0, len(p), per):
            acc = torch.zeros(x.shape[1], y.shape[1])
            for q0 in range(z0, min(z0 + per, len(p)), 32):
                a, b = xs[q0 : q0 + 32], ys[q0 : q0 + 32]
                ah, bh = tsc.tf32_round(a), tsc.tf32_round(b)
                al, bl = tsc.tf32_round(a - ah).double(), tsc.tf32_round(b - bh).double()
                ah, bh = ah.double(), bh.double()
                acc = acc + (al.T @ bh + ah.T @ bl + ah.T @ bh).float()
            total = total + acc
        out.append(total)
    return torch.stack(out)


def _conv_tables(rng, k, v_in, v_out):
    """A conv over k offsets with one pair per input row and offset:
    (rb (k, V_out), rb_bwd (k, V_in)) that agree."""
    rb = rng.integers(0, v_in, (k, v_out)).astype(np.int32)
    rb[rng.random((k, v_out)) < 0.3] = -1
    rb = torch.from_numpy(rb)
    rb_bwd = torch.full((k, v_in), -1, dtype=torch.int32)
    kk, vv = torch.nonzero(rb >= 0, as_tuple=True)
    rb_bwd[kk, rb[kk, vv].long()] = vv.int()
    rb = torch.full_like(rb, -1)
    kk, ii = torch.nonzero(rb_bwd >= 0, as_tuple=True)
    rb[kk, rb_bwd[kk, ii].long()] = ii.int()
    return rb, rb_bwd


@pytest.mark.parametrize("k,c_in,c_out,per", [(9, 64, 32, 64), (27, 128, 20, 96), (27, 32, 64, 100000)])
def test_tile_arithmetic_matches_jax_conv_dw(k, c_in, c_out, per):
    """K4 at K: the tile's arithmetic over `pair_lists(rb_bwd)` (lists cut
    into pieces of 64 or 96 pairs, or whole) within 1e-4 of the largest
    sum of |terms| of JAX's d_W, `jax.vjp` of `sparse_conv_apply` (V_in
    400, V_out 300), and of the plain version; 128 -> 20 at the padded 24."""
    rng = np.random.default_rng(k + c_in)
    rb, rb_bwd = _conv_tables(rng, k, 400, 300)
    x0 = rng.normal(size=(400, c_in)).astype(np.float32)
    w0 = (rng.normal(size=(k, c_in, c_out)) / np.sqrt(k * c_in)).astype(np.float32)
    g0 = rng.normal(size=(300, c_out)).astype(np.float32)
    want = np.asarray(J_CONV_DW(jnp.asarray(x0), jnp.asarray(w0), jnp.asarray(rb.numpy()),
                                jnp.asarray(rb_bwd.numpy()), jnp.asarray(g0)))
    x, g = torch.from_numpy(x0), torch.from_numpy(g0)
    co = tsc.padded_width(torch.float32, c_out)
    got = _tile_dw(x, tsc.pad_cols(g, co), tf3.pair_lists(rb_bwd), per)[:, :, :c_out]
    scale = float(tf3.k3_conv_dw_plain(x.abs(), g.abs(), rb_bwd).max())
    assert np.abs(got.numpy() - want).max() <= 1e-4 * scale
    assert (got - tf3.k3_conv_dw_plain(x, g, rb_bwd)).abs().max() <= 1e-4 * scale


@pytest.fixture(scope="module")
def level_pair():
    """A fine level and its 2x-coarser level, JAX and port views, on the
    same coordinates (voxels in [0, 14)^3 x 2 batches)."""
    rng = np.random.default_rng(7)
    coords = np.concatenate([rng.integers(0, 14, size=(600, 3)), rng.integers(0, 2, size=(600, 1))], 1)
    coords = coords.astype(np.int32)
    valid = np.ones(len(coords), bool)
    jb = j_bounds(jnp.asarray(coords), jnp.asarray(valid))
    ju, jn, _, _ = j_unique(jnp.asarray(coords), jnp.asarray(valid), jb, 768)
    _, _, jpar, jcnt, jperm = j_spdown(ju, jn, 2, 1, jb, 512, return_inverse=True)
    tb = tc.compute_bounds(torch.from_numpy(coords), torch.from_numpy(valid))
    tu, tn, _, _ = tj.unique_coords(torch.from_numpy(coords), torch.from_numpy(valid), tb, 768)
    _, _, tpar, tcnt, tperm = tr.spdownsample(tu, tn, 2, 1, tb, 512, return_inverse=True)
    return j_strided(ju, jn, jpar, jcnt, jperm, 1), tst.build_strided_tables(tu, tn, tpar, tcnt, tperm, 1)


@pytest.mark.parametrize("up,c_in,c_out,per", [(False, 32, 64, 32), (True, 96, 48, 64)])
def test_tile_arithmetic_matches_jax_strided_dw(level_pair, up, c_in, c_out, per):
    """K5: the tile's arithmetic over the slot lists (the up direction
    reading each (fine, parent) pair swapped; lists cut into pieces of 32
    and 64 pairs) within 1e-4 of the largest sum of |terms| of JAX's d_W,
    `jax.vjp` of `downsample_conv_apply` / `upsample_conv_apply`."""
    jtab, ttab = level_pair
    rng = np.random.default_rng(c_in + c_out)
    v_fine, v_coarse = ttab.parent.shape[0], ttab.starts.shape[0] - 1
    n_x, n_y = (v_coarse, v_fine) if up else (v_fine, v_coarse)
    x0 = rng.normal(size=(n_x, c_in)).astype(np.float32)
    w0 = (rng.normal(size=(8, c_in, c_out)) / np.sqrt(c_in)).astype(np.float32)
    g0 = rng.normal(size=(n_y, c_out)).astype(np.float32)
    want = np.asarray((J_UP_DW if up else J_DOWN_DW)(jnp.asarray(x0), jnp.asarray(w0), jtab, jnp.asarray(g0)))
    x, g = torch.from_numpy(x0), torch.from_numpy(g0)
    lists = tst.slot_pair_lists(ttab)
    if up:
        lists = tf3.PairLists(pairs=lists.pairs.flip(1), starts=lists.starts)
    got = _tile_dw(x, g, lists, per)
    scale = float(tst.strided_dw_plain(x.abs(), g.abs(), ttab, up).max())
    assert np.abs(got.numpy() - want).max() <= 1e-4 * scale
