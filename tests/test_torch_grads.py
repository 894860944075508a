"""The port's gradients against the JAX package's VJPs: the same numpy
inputs and cotangent through `torch.autograd.grad` and `jax.vjp`.

Ops: the stride-1 k3 conv (`k3_conv`, backward K2 on W^T + K4) against
`tgf_conv_apply`; `f3_bwd_fused` against JAX `f3_bwd_fused` and d_W
against `f3_dw_impl`; both strided directions on coordinates around 0
(negative ones fold into cell 0); identity and trilinear devoxelize;
`voxelize_avg`.  On the CPU every wrapper runs its plain version.

Tolerances: f32 within 1e-5 of the largest sum of |terms| of each
gradient (summation order only).  bf16: the port sums in f32 and rounds
once; the JAX TGF path rounds per group, and the JAX VJPs keep d_W in
f32 where the port rounds it to the bf16 weight, so bf16 gradients are
held within 2^-6 of the gradient's scale (a few roundings).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.ops import (
    build_rulebook_k3 as j_rb_k3,
    build_segment_tables as j_seg_tables,
    compute_bounds as j_bounds,
    devoxelize as j_devox,
    downsample_conv_apply as j_down,
    flip_rulebook as j_flip,
    spdownsample as j_spdown,
    trilinear_table as j_trilinear,
    unique_coords as j_unique,
    upsample_conv_apply as j_up,
    voxelize_avg as j_voxelize,
)
from taseg_tpu.ops.f3conv import f3_bwd_fused as j_f3_bwd, f3_dw_impl
from taseg_tpu.ops.strided_conv import build_strided_tables as j_strided
from taseg_tpu.ops.tgf import build_tgf_tables, tgf_conv_apply
from taseg_tpu.ops.voxelize import IdentityDevoxTable as JIdentity
from taseg_tpu_torch.ops import coords as tc
from taseg_tpu_torch.ops import f3conv as tf3
from taseg_tpu_torch.ops import join as tj
from taseg_tpu_torch.ops import rulebook as tr
from taseg_tpu_torch.ops import sparse_conv as tsc
from taseg_tpu_torch.ops import strided_conv as tst
from taseg_tpu_torch.ops import voxelize as tvx

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def t2n(x):
    return x.detach().float().numpy()


def check(got, want, ref_abs, dtype):
    """f32: within 1e-5 of max sum |terms|; bf16: within 2^-6 of the
    gradient's scale."""
    err = np.abs(got - want).max()
    tol = 1e-5 * np.abs(ref_abs).max() if dtype == "float32" else 2.0**-6 * np.abs(want).max()
    assert err <= tol, (err, tol)


def level(seed, cap=512, n=400, span=10, lo=0):
    """A unique voxel level, JAX and port views, coords in [lo, span)."""
    rng = np.random.default_rng(seed)
    coords = np.concatenate(
        [rng.integers(lo, span, size=(n, 3)), rng.integers(0, 2, size=(n, 1))], 1
    ).astype(np.int32)
    valid = np.ones(n, bool)
    jb = j_bounds(jnp.asarray(coords), jnp.asarray(valid))
    ju, jn, _, _ = j_unique(jnp.asarray(coords), jnp.asarray(valid), jb, cap)
    tb = tc.compute_bounds(torch.from_numpy(coords), torch.from_numpy(valid))
    tu, tn, _, _ = tj.unique_coords(torch.from_numpy(coords), torch.from_numpy(valid), tb, cap)
    return rng, (ju, jn, jb), (tu, tn, tb)


@pytest.fixture(scope="module")
def k3_level():
    rng, (ju, jn, jb), _ = level(3)
    rb = j_rb_k3(ju, jn, 1, jb)
    tabs = jax.jit(
        lambda rb: (
            build_tgf_tables(rb, ju, jn, 1, jb),
            build_tgf_tables(j_flip(rb), ju, jn, 1, jb, flipped=True),
        )
    )(rb)
    return rng, rb, tabs, int(jn)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out", [(4, 32), (24, 40), (128, 96)])
def test_k3_conv_grad_matches_tgf_vjp(k3_level, dtype, c_in, c_out):
    jdt, tdt = DTYPES[dtype]
    rng, rb, (tab, tab_bwd), n = k3_level
    v = rb.shape[1]
    feats = rng.normal(size=(v, c_in)).astype(np.float32)
    feats[n:] = 0
    w = (rng.normal(size=(27, c_in, c_out)) / np.sqrt(27 * c_in)).astype(np.float32)
    ct = rng.normal(size=(v, c_out)).astype(np.float32)
    ct[n:] = 0

    _, vjp = jax.vjp(
        lambda f, w: tgf_conv_apply(f, w, tab, tab_bwd, rb),
        jnp.asarray(feats, jdt), jnp.asarray(w),
    )
    jdf, jdw = vjp(jnp.asarray(ct, jdt))

    trb = torch.from_numpy(np.array(rb))
    f = torch.from_numpy(feats).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tsc.k3_conv(f, wt.to(tdt).contiguous(), trb, tsc.flip_rulebook(trb))
    df, dw = torch.autograd.grad(out, (f, wt), torch.from_numpy(ct).to(tdt))

    rb_bwd = tsc.flip_rulebook(trb)
    fa, ca = torch.from_numpy(np.abs(feats)), torch.from_numpy(np.abs(ct))
    ref_df = t2n(tsc.sparse_conv_plain(ca, torch.from_numpy(np.abs(w)).transpose(1, 2).contiguous(), rb_bwd))
    ref_dw = t2n(tf3.k3_conv_dw_plain(fa, ca, rb_bwd))
    check(t2n(df), to_np(jdf), ref_df, dtype)
    check(t2n(dw), to_np(jdw), ref_dw, dtype)


@pytest.mark.parametrize("c_in,c_out", [(4, 32), (64, 16)])
def test_f3_bwd_fused_matches_jax(k3_level, c_in, c_out):
    """Both halves against JAX `f3_bwd_fused`, and d_W against the second
    oracle `f3_dw_impl` (forward rulebook); the plain composition equals
    the wrapper on the CPU; need_feats=False returns no d_feats."""
    rng, rb, _, n = k3_level
    v = rb.shape[1]
    feats = rng.normal(size=(v, c_in)).astype(np.float32)
    w = rng.normal(size=(27, c_in, c_out)).astype(np.float32)
    g = rng.normal(size=(v, c_out)).astype(np.float32)
    jf, jw, jg = jnp.asarray(feats), jnp.asarray(w), jnp.asarray(g)
    jdf, jdw = j_f3_bwd(jf, jw, jg, j_flip(rb))
    jdw2 = f3_dw_impl(jf, jg, rb)

    tf, tw, tg = (torch.from_numpy(x) for x in (feats, w, g))
    rb_bwd = tsc.flip_rulebook(torch.from_numpy(np.array(rb)))
    df, dw = tf3.f3_bwd_fused(tf, tw, tg, rb_bwd)
    pdf, pdw = tf3.f3_bwd_fused_plain(tf, tw, tg, rb_bwd)
    assert torch.equal(df, pdf) and torch.equal(dw, pdw)
    ref_df = t2n(tsc.sparse_conv_plain(tg.abs(), tw.abs().transpose(1, 2).contiguous(), rb_bwd))
    ref_dw = t2n(tf3.k3_conv_dw_plain(tf.abs(), tg.abs(), rb_bwd))
    check(t2n(df), to_np(jdf), ref_df, "float32")
    check(t2n(dw), to_np(jdw), ref_dw, "float32")
    check(t2n(dw), to_np(jdw2), ref_dw, "float32")
    none, dw3 = tf3.f3_bwd_fused(tf, tw, tg, rb_bwd, need_feats=False)
    assert none is None and torch.equal(dw3, dw)


@pytest.mark.parametrize("c_in,c_out", [(4, 32), (64, 16), (32, 32)])
def test_k4_pair_lists_match_jax(k3_level, c_in, c_out):
    """K4 over the level's pair lists (`k3_pair_lists` of the flipped
    rulebook, the form its tensor-core route reads) equals the plain K4
    over rb_bwd, and JAX `f3_dw_impl` within the tolerance above; the
    backward given the lists returns the same d_W as without them."""
    rng, rb, _, _ = k3_level
    v = rb.shape[1]
    feats = rng.normal(size=(v, c_in)).astype(np.float32)
    g = rng.normal(size=(v, c_out)).astype(np.float32)
    jdw = f3_dw_impl(jnp.asarray(feats), jnp.asarray(g), rb)
    tf, tg = torch.from_numpy(feats), torch.from_numpy(g)
    rb_bwd = tsc.flip_rulebook(torch.from_numpy(np.array(rb)))
    pairs = tf3.k3_pair_lists(rb_bwd)
    dw = tf3.k3_conv_dw_pairs_plain(tf, tg, pairs)
    torch.testing.assert_close(dw, tf3.k3_conv_dw_plain(tf, tg, rb_bwd), rtol=0, atol=1e-4)
    ref = t2n(tf3.k3_conv_dw_plain(tf.abs(), tg.abs(), rb_bwd))
    check(t2n(dw), to_np(jdw), ref, "float32")
    w = torch.from_numpy(rng.normal(size=(27, c_in, c_out)).astype(np.float32))
    _, dw2 = tf3.f3_bwd_fused(tf, w, tg, rb_bwd, pairs=pairs)
    assert torch.equal(dw2, tf3.f3_bwd_fused(tf, w, tg, rb_bwd)[1])


@pytest.fixture(scope="module")
def strided_pair():
    """A fine level around 0 (negative coordinates: truncating division
    folds {-1, 0, 1} into cell 0, whose children repeat slots) and its
    parent relation in both packages."""
    rng, (ju, jn, jb), (tu, tn, tb) = level(7, n=500, span=7, lo=-7)
    cap2 = 512
    jc2, jn2, jpar, jcnt, jperm = j_spdown(ju, jn, 2, 1, jb, cap2, return_inverse=True)
    jtab = j_strided(ju, jn, jpar, jcnt, jperm, 1)
    tc2, tn2, tpar, tcnt, tperm = tr.spdownsample(tu, tn, 2, 1, tb, cap2, return_inverse=True)
    ttab = tst.build_strided_tables(tu, tn, tpar, tcnt, tperm, 1)
    assert tst.slot_child_table(ttab).shape[0] > 1
    return rng, jtab, ttab, ju.shape[0], cap2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("c_in,c_out", [(4, 12), (96, 64)])
def test_strided_grads_match_jax(strided_pair, dtype, up, c_in, c_out):
    jdt, tdt = DTYPES[dtype]
    rng, jtab, ttab, v_fine, v_coarse = strided_pair
    v_in, v_out = (v_coarse, v_fine) if up else (v_fine, v_coarse)
    feats = rng.normal(size=(v_in, c_in)).astype(np.float32)
    w = rng.normal(size=(8, c_in, c_out)).astype(np.float32)
    ct = rng.normal(size=(v_out, c_out)).astype(np.float32)
    j_fn, t_fn = (j_up, tst.upsample_conv) if up else (j_down, tst.downsample_conv)

    _, vjp = jax.vjp(lambda f, w: j_fn(f, w, jtab), jnp.asarray(feats, jdt), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(ct, jdt))

    f = torch.from_numpy(feats).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = t_fn(f, wt.to(tdt).contiguous(), ttab)
    df, dw = torch.autograd.grad(out, (f, wt), torch.from_numpy(ct).to(tdt))

    fa, wa, ca = (torch.from_numpy(np.abs(x)) for x in (feats, w, ct))
    other = tst.downsample_conv_plain if up else tst.upsample_conv_plain
    ref_df = t2n(other(ca, wa.transpose(1, 2).contiguous(), ttab))
    ref_dw = t2n(tst.strided_dw_plain(fa, ca, ttab, up))
    check(t2n(df), to_np(jdf), ref_df, dtype)
    check(t2n(dw), to_np(jdw), ref_dw, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("up", [False, True])
def test_strided_dw_pair_lists_match_jax(strided_pair, dtype, up):
    """K5's tensor-core arithmetic: d_W over the per-slot pair lists
    (`strided_dw_pairs_plain` on `slot_pair_lists`, the up direction
    reading each pair swapped) equals `strided_dw_plain` and the d_W of
    JAX's `_down_bwd` / `_up_bwd`, on coordinates around 0 (cells whose
    children repeat a slot).  The inputs are exact in both dtypes and
    every version sums in f32, so both dtypes are held within 1e-5 of the
    largest sum of |terms|."""
    jdt, tdt = DTYPES[dtype]
    rng, jtab, ttab, v_fine, v_coarse = strided_pair
    c_in, c_out = 24, 40
    v_x, v_y = (v_coarse, v_fine) if up else (v_fine, v_coarse)
    x = rng.normal(size=(v_x, c_in)).astype(np.float32)
    y = rng.normal(size=(v_y, c_out)).astype(np.float32)
    w = rng.normal(size=(8, c_in, c_out)).astype(np.float32)
    j_fn = j_up if up else j_down
    _, vjp = jax.vjp(lambda w: j_fn(jnp.asarray(x, jdt), w, jtab), jnp.asarray(w))
    (jdw,) = vjp(jnp.asarray(y, jdt))

    xt, yt = torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)
    pairs = tst.slot_pair_lists(ttab)
    live = ttab.parent >= 0
    assert int(pairs.starts[-1]) == int(live.sum())
    got = tst.strided_dw_pairs_plain(xt, yt, pairs, up)
    ref = t2n(tst.strided_dw_plain(xt.abs(), yt.abs(), ttab, up))
    check(t2n(got), t2n(tst.strided_dw_plain(xt, yt, ttab, up)), ref, "float32")
    check(t2n(got), to_np(jdw), ref, "float32")
    assert torch.equal(tst.strided_dw(xt, yt, ttab, up), tst.strided_dw_plain(xt, yt, ttab, up))


@pytest.fixture(scope="module")
def point_tables():
    rng = np.random.default_rng(11)
    p, cap = 300, 128
    inverse = rng.integers(-1, 40, size=p).astype(np.int32)
    jt = j_seg_tables(jnp.asarray(inverse), cap)
    tt = tvx.build_segment_tables(torch.from_numpy(inverse), cap)
    _, (ju, jn, jb), (tu, tn, tb) = level(9, cap=256, n=200, span=8)
    pts = np.concatenate(
        [rng.uniform(0, 8, size=(p, 3)), rng.integers(0, 2, size=(p, 1))], 1
    ).astype(np.float32)
    pv = np.ones(p, bool)
    jtri = j_trilinear(jnp.asarray(pts), jnp.asarray(pv), ju, jn, 2, jb)
    ttri = tvx.trilinear_table(torch.from_numpy(pts), torch.from_numpy(pv), tu, tn, 2, tb)
    np.testing.assert_array_equal(ttri.pairs.starts.numpy(), np.asarray(jtri.pairs.starts))
    return rng, inverse, (jt, tt), (jtri, ttri), (cap, ju.shape[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["identity", "trilinear"])
def test_devoxelize_grads_match_jax(point_tables, dtype, kind):
    jdt, tdt = DTYPES[dtype]
    rng, inverse, (jt, tt), (jtri, ttri), (cap, v_tri) = point_tables
    c = 20
    if kind == "identity":
        jtab = JIdentity(inverse=jnp.asarray(inverse), tables=jt)
        ttab = tvx.IdentityDevoxTable(inverse=torch.from_numpy(inverse), tables=tt)
        v = cap
    else:
        jtab, ttab, v = jtri, ttri, v_tri
    vox = rng.normal(size=(v, c)).astype(np.float32)
    ct = rng.normal(size=(inverse.shape[0], c)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: j_devox(x, jtab), jnp.asarray(vox, jdt))
    (jd,) = vjp(jnp.asarray(ct, jdt))

    x = torch.from_numpy(vox).to(tdt).requires_grad_()
    (d,) = torch.autograd.grad(tvx.devoxelize(x, ttab), x, torch.from_numpy(ct).to(tdt))
    assert d.dtype == tdt
    ca = torch.from_numpy(np.abs(ct))
    if kind == "identity":
        ref = t2n(tvx.segment_sum_plain(ca, tt))
    else:
        ref = t2n(tvx.segment_sum_plain(ca, ttri.pairs, ttri.weights.reshape(-1)))
    check(t2n(d), to_np(jd), ref, dtype)


def test_voxelize_avg_grad_matches_jax(point_tables):
    rng, inverse, (jt, tt), _, (cap, _) = point_tables
    feats = rng.normal(size=(inverse.shape[0], 4)).astype(np.float32)
    ct = rng.normal(size=(cap, 4)).astype(np.float32)
    _, vjp = jax.vjp(lambda f: j_voxelize(f, jnp.asarray(inverse), jt), jnp.asarray(feats))
    (jd,) = vjp(jnp.asarray(ct))
    f = torch.from_numpy(feats).requires_grad_()
    out = tvx.voxelize_avg(f, torch.from_numpy(inverse), tt)
    (d,) = torch.autograd.grad(out, f, torch.from_numpy(ct))
    np.testing.assert_allclose(t2n(d), to_np(jd), rtol=1e-6, atol=1e-7)
    assert not d[inverse < 0].any()
