"""The plain versions of the port's feature ops (what the CUDA kernels are
held to on the card) against the JAX package, in f32 and bf16.

Tolerances: f32 results differ by summation order only (1e-5 of the
output scale; 1e-4 where a mean-centred cumsum sums the strided
children).  In bf16 the port and the JAX oracle `sparse_conv_apply` both
accumulate in f32 and round once, so they differ by at most one bf16
rounding (2^-7 of the scale); the JAX TGF path rounds each group's
transformed rows to bf16 before summing them, so it is held to 3e-2 of
the scale.
"""

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
    flip_rulebook,
    sparse_conv_apply as j_sparse_conv,
    spdownsample as j_spdown,
    trilinear_table as j_trilinear,
    unique_coords as j_unique,
    upsample_conv_apply as j_up,
    voxelize_avg as j_voxelize,
)
from taseg_tpu.ops.strided_conv import build_strided_tables as j_strided
from taseg_tpu.ops.tgf import build_tgf_tables, tgf_conv_apply
from taseg_tpu.ops.voxelize import IdentityDevoxTable as JIdentity
from taseg_tpu_torch.ops import coords as tc
from taseg_tpu_torch.ops import join as tj
from taseg_tpu_torch.ops import rulebook as tr
from taseg_tpu_torch.ops import sparse_conv as tsc
from taseg_tpu_torch.ops import strided_conv as tst
from taseg_tpu_torch.ops import voxelize as tvx

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def scale_err(got, want):
    return np.abs(got - want).max(), max(np.abs(want).max(), 1e-6)


def make_level(seed, cap=512, n=400, span=10, stride=1):
    """A unique voxel level (JAX and port views of the same arrays)."""
    rng = np.random.default_rng(seed)
    coords = np.concatenate(
        [rng.integers(0, span, size=(n, 3)) * stride, rng.integers(0, 2, size=(n, 1))], 1
    ).astype(np.int32)
    valid = np.ones(n, bool)
    jb = j_bounds(jnp.asarray(coords), jnp.asarray(valid))
    ju, jn, _, _ = j_unique(jnp.asarray(coords), jnp.asarray(valid), jb, cap)
    tb = tc.compute_bounds(torch.from_numpy(coords), torch.from_numpy(valid))
    tu, tn, _, _ = tj.unique_coords(torch.from_numpy(coords), torch.from_numpy(valid), tb, cap)
    return rng, (ju, jn, jb), (tu, tn, tb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out", [(4, 32), (24, 40), (64, 16)])
def test_k3_conv_plain_matches_jax(dtype, c_in, c_out):
    jdt, tdt = DTYPES[dtype]
    rng, (ju, jn, jb), (tu, tn, tb) = make_level(1 + c_in)
    rb = j_rb_k3(ju, jn, 1, jb)
    cap = rb.shape[1]
    feats = rng.normal(size=(cap, c_in)).astype(np.float32)
    feats[int(jn):] = 0
    w = (rng.normal(size=(27, c_in, c_out)) / np.sqrt(27 * c_in)).astype(np.float32)
    jf, jw = jnp.asarray(feats, jdt), jnp.asarray(w)
    oracle = to_np(j_sparse_conv(jf, jw.astype(jdt), rb, flip_rulebook(rb)))
    tab = build_tgf_tables(rb, ju, jn, 1, jb)
    tgf = to_np(tgf_conv_apply(jf, jw, tab, None, rb))

    trb = torch.from_numpy(np.array(rb))
    np.testing.assert_array_equal(trb.numpy(), tr.build_rulebook_k3(tu, tn, 1, tb).numpy())
    tf = torch.from_numpy(feats).to(tdt)
    got = tsc.sparse_conv_k3(tf, torch.from_numpy(w).to(tdt), trb).float().numpy()
    err, scale = scale_err(got, oracle)
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    assert err <= tol * scale, (err, scale)
    err, scale = scale_err(got, tgf)
    assert err <= (1e-5 if dtype == "float32" else 3e-2) * scale, (err, scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_plain_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    c_in, c_out, cap2 = 12, 20, 512
    rng, (ju, jn, jb), (tu, tn, tb) = make_level(7, span=14)
    jc2, jn2, jpar, jcnt, jperm = j_spdown(ju, jn, 2, 1, jb, cap2, return_inverse=True)
    jtab = j_strided(ju, jn, jpar, jcnt, jperm, 1)
    tc2, tn2, tpar, tcnt, tperm = tr.spdownsample(tu, tn, 2, 1, tb, cap2, return_inverse=True)
    ttab = tst.build_strided_tables(tu, tn, tpar, tcnt, tperm, 1)
    np.testing.assert_array_equal(tc2.numpy(), np.asarray(jc2))
    for f in ("parent", "slot", "starts"):
        np.testing.assert_array_equal(getattr(ttab, f).numpy(), np.asarray(getattr(jtab, f)))

    cap = ju.shape[0]
    feats = rng.normal(size=(cap, c_in)).astype(np.float32)
    w = (rng.normal(size=(8, c_in, c_out)) / np.sqrt(8 * c_in)).astype(np.float32)
    coarse = rng.normal(size=(cap2, c_out)).astype(np.float32)
    wt = (rng.normal(size=(8, c_out, c_in)) / np.sqrt(8 * c_out)).astype(np.float32)
    tol = 1e-4 if dtype == "float32" else 2.0**-7
    cases = (
        (j_down, tst.downsample_conv_apply, feats, w),
        (j_up, tst.upsample_conv_apply, coarse, wt),
    )
    for jfn, tfn, x, wx in cases:
        want = to_np(jfn(jnp.asarray(x, jdt), jnp.asarray(wx, jdt), jtab))
        got = tfn(torch.from_numpy(x).to(tdt), torch.from_numpy(wx).to(tdt), ttab)
        err, scale = scale_err(got.float().numpy(), want)
        assert err <= tol * scale, (tfn.__name__, err, scale)


def test_strided_children_of_negative_cells():
    """Truncating division folds x in {-1, 0, 1} into cell 0, so a coarse
    cell can hold two children of one slot: the plain down conv sums them
    all (as the kernel's child rounds do)."""
    coords = np.array([[-1, 0, 0, 0], [0, 0, 0, 0], [1, 0, 0, 0], [3, 0, 0, 0]], np.int32)
    valid = np.ones(4, bool)
    tb = tc.compute_bounds(torch.from_numpy(coords), torch.from_numpy(valid))
    tu, tn, _, _ = tj.unique_coords(torch.from_numpy(coords), torch.from_numpy(valid), tb, 8)
    c2, n2, par, cnt, perm = tr.spdownsample(tu, tn, 2, 1, tb, 8, return_inverse=True)
    tab = tst.build_strided_tables(tu, tn, par, cnt, perm, 1)
    feats = torch.zeros(8, 1)
    feats[:4, 0] = torch.tensor([1.0, 2.0, 4.0, 8.0])
    w = torch.arange(1, 9, dtype=torch.float32).reshape(8, 1, 1)
    out = tst.downsample_conv_apply(feats, w, tab)
    # cell 0: x=-1 (slot 4), x=0 (slot 0), x=1 (slot 4); cell 2: x=3 (slot 4)
    assert int(n2) == 2
    torch.testing.assert_close(out[:2, 0], torch.tensor([1 * 5 + 2 * 1 + 4 * 5, 8 * 5.0]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_voxelize_and_devoxelize_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    p, cap, c = 300, 128, 6
    inverse = rng.integers(-1, 40, size=p).astype(np.int32)
    feats = rng.normal(size=(p, c)).astype(np.float32)
    jt = j_seg_tables(jnp.asarray(inverse), cap)
    tt = tvx.build_segment_tables(torch.from_numpy(inverse), cap)
    np.testing.assert_array_equal(tt.starts.numpy(), np.asarray(jt.starts))
    np.testing.assert_array_equal(tt.counts.numpy(), np.asarray(jt.counts))
    want = np.asarray(j_voxelize(jnp.asarray(feats), jnp.asarray(inverse), jt))
    got = tvx.voxelize_avg(torch.from_numpy(feats), torch.from_numpy(inverse), tt).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    # identity devox: a gather through the inverse map
    vox = rng.normal(size=(cap, c)).astype(np.float32)
    jv, tv = jnp.asarray(vox, jdt), torch.from_numpy(vox).to(tdt)
    want = to_np(j_devox(jv, JIdentity(inverse=jnp.asarray(inverse), tables=jt)))
    got = tvx.devoxelize(tv, tvx.IdentityDevoxTable(inverse=torch.from_numpy(inverse)))
    np.testing.assert_array_equal(got.float().numpy(), want)

    # trilinear devox on a stride-2 level, tables built by both packages
    _, (ju, jn, jb), (tu, tn, tb) = make_level(9, cap=256, n=200, span=8)
    pts = np.concatenate(
        [rng.uniform(0, 8, size=(p, 3)), rng.integers(0, 2, size=(p, 1))], 1
    ).astype(np.float32)
    pv = np.ones(p, bool)
    jtab = j_trilinear(jnp.asarray(pts), jnp.asarray(pv), ju, jn, 2, jb, with_pairs=False)
    ttab = tvx.trilinear_table(torch.from_numpy(pts), torch.from_numpy(pv), tu, tn, 2, tb)
    np.testing.assert_array_equal(ttab.idx.numpy(), np.asarray(jtab.idx))
    np.testing.assert_allclose(ttab.weights.numpy(), np.asarray(jtab.weights), atol=1e-6)
    vox = rng.normal(size=(ju.shape[0], c)).astype(np.float32)
    want = to_np(j_devox(jnp.asarray(vox, jdt), jtab))
    got = tvx.devoxelize(torch.from_numpy(vox).to(tdt), ttab).float().numpy()
    err, scale = scale_err(got, want)
    assert err <= (1e-6 if dtype == "float32" else 2.0**-6) * scale, (err, scale)


def test_kernel_wrappers_reject_bad_inputs():
    x = torch.zeros(16, 8)
    rb = torch.full((27, 16), -1, dtype=torch.int32)
    with pytest.raises(TypeError):  # dtype the kernel does not take
        tsc.sparse_conv_k3(x.half(), torch.zeros(27, 8, 4).half(), rb)
    with pytest.raises(TypeError):  # weight dtype differs from feats
        tsc.sparse_conv_k3(x, torch.zeros(27, 8, 4, dtype=torch.bfloat16), rb)
    with pytest.raises(ValueError):  # wrong weight shape
        tsc.sparse_conv_k3(x, torch.zeros(27, 4, 4), rb)
    with pytest.raises(ValueError):  # non-contiguous
        tsc.sparse_conv_k3(torch.zeros(8, 16).t(), torch.zeros(27, 8, 4), rb)
    with pytest.raises(TypeError):
        tsc.sparse_conv_k3(x, torch.zeros(27, 8, 4), rb.long())
    tab = tst.StridedTables(
        parent=torch.zeros(16, dtype=torch.int32), slot=torch.zeros(16, dtype=torch.int32),
        perm=torch.arange(16, dtype=torch.int32), starts=torch.zeros(5, dtype=torch.int32),
    )
    with pytest.raises(ValueError):  # (8, C_in, C_out) expected
        tst.downsample_conv_apply(x, torch.zeros(27, 8, 4), tab)
    with pytest.raises(ValueError):  # starts does not fit the coarse rows
        tst.upsample_conv_apply(torch.zeros(3, 8), torch.zeros(8, 8, 4), tab)
