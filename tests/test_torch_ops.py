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
@pytest.mark.parametrize(
    "c_in,c_out",
    [(4, 32), (24, 40), (64, 16), (32, 32), (128, 96), (192, 128), (384, 256)],
)
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
@pytest.mark.parametrize(
    "c_in,c_out", [(12, 20), (256, 256), (256, 128), (128, 96), (96, 96)]
)
def test_strided_plain_matches_jax(dtype, c_in, c_out):
    """Down C_in -> C_out on the fine level, up (the deconv) C_in -> C_out
    from the coarse level; the main path's deconvs are 256->256,
    256->128, 128->96 and 96->96."""
    jdt, tdt = DTYPES[dtype]
    cap2 = 512
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
    coarse = rng.normal(size=(cap2, c_in)).astype(np.float32)
    wt = (rng.normal(size=(8, c_in, c_out)) / np.sqrt(8 * c_in)).astype(np.float32)
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


def _down_by_child_table(x, w, table):
    """sum_q sum_s x[table[q, s]] @ W[s], accumulated in f32 and rounded
    once: the sum that the tensor-core down kernel takes, round by round."""
    out = torch.zeros(table.shape[2], w.shape[2])
    for q in range(table.shape[0]):
        for s in range(8):
            idx = table[q, s]
            g = torch.where((idx >= 0)[:, None], x[idx.clamp(min=0).long()], 0)
            out += g.float() @ w[s].float()
    return out.to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c_in,c_out", [(12, 20), (32, 32), (64, 64), (128, 128)])
def test_slot_child_table_matches_jax(dtype, c_in, c_out):
    """The (round, slot, coarse row) child table summed per slot equals
    JAX's downsample_conv_apply on the scene of
    test_strided_plain_matches_jax (non-negative coordinates: one round);
    the main path's down convs are 32->32, 32->32, 64->64, 128->128."""
    jdt, tdt = DTYPES[dtype]
    rng, (ju, jn, jb), (tu, tn, tb) = make_level(7, span=14)
    jc2, jn2, jpar, jcnt, jperm = j_spdown(ju, jn, 2, 1, jb, 512, return_inverse=True)
    jtab = j_strided(ju, jn, jpar, jcnt, jperm, 1)
    _, _, tpar, tcnt, tperm = tr.spdownsample(tu, tn, 2, 1, tb, 512, return_inverse=True)
    ttab = tst.build_strided_tables(tu, tn, tpar, tcnt, tperm, 1)
    table = tst.slot_child_table(ttab)
    assert table.shape == (1, 8, 512)
    # every live fine row appears exactly once
    live = table[table >= 0]
    assert live.numel() == int(tn) and live.unique().numel() == int(tn)

    feats = rng.normal(size=(ju.shape[0], c_in)).astype(np.float32)
    w = (rng.normal(size=(8, c_in, c_out)) / np.sqrt(8 * c_in)).astype(np.float32)
    want = to_np(j_down(jnp.asarray(feats, jdt), jnp.asarray(w, jdt), jtab))
    got = _down_by_child_table(torch.from_numpy(feats).to(tdt), torch.from_numpy(w).to(tdt), table)
    err, scale = scale_err(got.float().numpy(), want)
    assert err <= (1e-4 if dtype == "float32" else 2.0**-7) * scale, (err, scale)


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
    # the child table takes the two slot-4 children of cell 0 in two rounds
    table = tst.slot_child_table(tab)
    assert table.shape == (2, 8, 8)
    assert table[:, 4, 0].tolist() == [0, 2] and table[:, 0, 0].tolist() == [1, -1]
    torch.testing.assert_close(_down_by_child_table(feats, w, table), out)
    jb = j_bounds(jnp.asarray(coords), jnp.asarray(valid))
    ju, jn, _, _ = j_unique(jnp.asarray(coords), jnp.asarray(valid), jb, 8)
    _, _, jpar, jcnt, jperm = j_spdown(ju, jn, 2, 1, jb, 8, return_inverse=True)
    want = to_np(j_down(jnp.asarray(feats.numpy()), jnp.asarray(w.numpy()), j_strided(ju, jn, jpar, jcnt, jperm, 1)))
    err, scale = scale_err(_down_by_child_table(feats, w, table).numpy(), want)
    assert err <= 1e-4 * scale, (err, scale)


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


def _k6_two_passes(src, tables, w, chunk, r_real=None):
    """numpy model of K6's two passes (csrc/segment_sum.cu): per chunk of
    sorted rows, run sums written to out, or to the chunk's two partial
    slots where the seg ids beside the chunk's ends show that its first
    or last segment runs over; gaps (segments without rows) written 0;
    then, per chunk whose last segment begins in it and runs on, that
    segment's partials added in chunk order.  Unwritten rows stay NaN."""
    perm, seg, starts = (t.numpy().astype(np.int64) for t in (tables.perm, tables.seg, tables.starts))
    v = len(starts) - 1
    r_real = len(perm) - v if r_real is None else r_real
    p = src.shape[0]
    m = starts[v]
    n_chunks = -(-len(perm) // chunk)
    out = np.full((v, src.shape[1]), np.nan)
    part = np.full((n_chunks, 2, src.shape[1]), np.nan)
    for c in range(n_chunks):
        b = c * chunk
        if b >= m:
            continue
        e = min(b + chunk, m)
        u_first, u_last = seg[b], seg[e - 1]
        before = seg[b - 1] if b > 0 else -1
        first_open, last_open = before == u_first, e < m and seg[e] == u_last
        out[before + 1 : u_first] = 0.0
        if e == m:
            out[u_last + 1 :] = 0.0
        j = b
        while j < e:
            key, acc = seg[j], 0.0
            while j < e and seg[j] == key:
                r = perm[j]
                if r < r_real:
                    acc = acc + (1.0 if w is None else w[r]) * src[r % p]
                j += 1
            if (key == u_first and first_open) or (key == u_last and last_open):
                part[c, 0 if key == u_first else 1] = acc
            else:
                out[key] = acc
            if j < e:
                out[key + 1 : seg[j]] = 0.0
    for c in range(n_chunks):
        b = c * chunk
        if b >= m:
            continue
        e = min(b + chunk, m)
        u = seg[e - 1]
        if e >= m or seg[e] != u or (u == seg[b] and b > 0 and seg[b - 1] == u):
            continue
        last = (starts[u + 1] - 1) // chunk
        out[u] = part[c, 0 if u == seg[b] else 1] + part[c + 1 : last + 1, 0].sum(0)
    return out


@pytest.mark.parametrize("chunk", [8, 32, tvx.SEGMENT_CHUNK])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_sum_chunk_passes(chunk, weighted):
    """The sorted segment ids that K6 reads (`SegmentTables.seg`) and the
    decomposition of its two passes into chunk sums and partials give the
    segment sums of JAX `_segment_sum_sorted` (via the port's plain
    version, checked against JAX here) over long, short, chunk-crossing,
    sentinel-only and dropped rows; without sentinels (segments with no
    rows at all) every such segment is 0."""
    from taseg_tpu.ops.voxelize import _segment_sum_sorted

    rng = np.random.default_rng(17 + chunk)
    p, v = 1500, 300
    ids = np.concatenate([np.full(600, 3), rng.integers(10, 200, p - 600)]).astype(np.int32)
    ids[rng.integers(0, p, 50)] = -1
    reps = 2 if weighted else 1
    tt = tvx.build_segment_tables(torch.from_numpy(np.tile(ids, reps)), v)
    key = np.where(np.tile(ids, reps) >= 0, np.tile(ids, reps), v)
    np.testing.assert_array_equal(tt.seg.numpy(), np.sort(np.concatenate([key, np.arange(v)])))
    src = rng.normal(size=(p, 5))
    w = rng.normal(size=reps * p) if weighted else None
    got = _k6_two_passes(src, tt, w, chunk)
    assert not np.isnan(got).any()
    tw = None if w is None else torch.from_numpy(w)
    want = tvx.segment_sum_plain(torch.from_numpy(src), tt, tw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    jt = j_seg_tables(jnp.asarray(np.tile(ids, reps)), v)
    rows = np.tile(src, (reps, 1)) * (1.0 if w is None else w[:, None])
    jwant = np.asarray(_segment_sum_sorted(jnp.asarray(rows, jnp.float32), jt))
    np.testing.assert_allclose(got, jwant, rtol=0, atol=1e-4 * np.abs(rows).sum(0).max())
    # drop the sentinel rows: empty segments, and gaps inside chunks
    keep = tt.perm.numpy() < reps * p
    bare = tvx.SegmentTables(
        perm=tt.perm[keep], seg=tt.seg[keep], counts=tt.counts,
        starts=torch.from_numpy(np.searchsorted(tt.seg[keep].numpy(), np.arange(v + 1)).astype(np.int32)),
    )
    got = _k6_two_passes(src, bare, w, chunk, r_real=reps * p)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
