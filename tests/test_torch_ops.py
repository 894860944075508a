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


def _k6_units(src, tables, w, unit, seed=0):
    """numpy model of K6's one-launch partition (csrc/segment_sum.cu):
    the sorted positions [0, starts[V]) cut into units of `unit` items
    (real members and one end per segment), each unit walking its
    segments from the one that holds its first item, reading the perm
    entries of real members only; a segment wholly inside a unit is
    written by it (on the card an empty one by its block, all its zero
    rows at once), one cut across units ka..kb leaves a partial in each
    (slot 1 in ka, where it begins, slot 0 in the others) and is written
    by the piece that arrives last, as the sum of the partials in unit
    order.  Units run in a shuffled order (the card runs them in any).
    Returns out (NaN where unwritten) and (cut segments, most pieces)."""
    perm = tables.perm.numpy().astype(np.int64)
    starts = tables.starts.numpy().astype(np.int64)
    v = len(starts) - 1
    r_real = len(perm) - v
    p, c = src.shape
    m_total = starts[v]
    n_units = -(-len(perm) // unit)
    out = np.full((v, c), np.nan)
    part = np.full((n_units, 2, c), np.nan)
    arrived = np.zeros(n_units, np.int64)
    read = np.zeros(len(perm), bool)
    cuts, most = 0, 0
    for k in np.random.default_rng(seed).permutation(n_units):
        j0 = k * unit
        if j0 >= m_total:
            continue
        j1 = min(j0 + unit, m_total)
        u = int(np.searchsorted(starts, j0, "right")) - 1
        j = j0
        while j < j1:
            su, e = starts[u], starts[u + 1] - 1  # e: u's sentinel
            acc = np.zeros(c)
            for m in range(j, min(e, j1)):
                read[m] = True
                r = perm[m]
                if r < r_real:
                    acc = acc + (1.0 if w is None else w[r]) * src[r % p]
            ends, began = e < j1, su >= j0
            if ends and began:
                out[u] = acc
            else:
                ka, kb = su // unit, e // unit
                part[k, 1 if began else 0] = acc
                arrived[ka] += 1
                if arrived[ka] == kb - ka + 1:  # the last piece
                    total = np.zeros(c)
                    for kk in range(ka, kb + 1):
                        total = total + part[kk, 1 if kk == ka else 0]
                    out[u] = total
                    cuts, most = cuts + 1, max(most, kb - ka + 1)
            if not ends:
                break
            j, u = e + 1, u + 1
    assert not read[starts[1:] - 1].any(), "a sentinel's perm entry was read"
    assert (perm[starts[1:] - 1] == r_real + np.arange(v)).all()
    return out, (cuts, most)


def _k6_check(src, ids, v, reps, w, unit, seed):
    """The model against the port's plain version and JAX."""
    from taseg_tpu.ops.voxelize import _segment_sum_sorted

    tt = tvx.build_segment_tables(torch.from_numpy(np.tile(ids, reps)), v)
    got, stats = _k6_units(src, tt, w, unit, seed)
    assert not np.isnan(got).any()
    tw = None if w is None else torch.from_numpy(w)
    want = tvx.segment_sum_plain(torch.from_numpy(src), tt, tw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    jt = j_seg_tables(jnp.asarray(np.tile(ids, reps)), v)
    rows = np.tile(src, (reps, 1)) * (1.0 if w is None else w[:, None])
    jwant = np.asarray(_segment_sum_sorted(jnp.asarray(rows, jnp.float32), jt))
    np.testing.assert_allclose(got, jwant, rtol=0, atol=1e-4 * np.abs(rows).sum(0).max())
    return got, stats, tt


@pytest.mark.parametrize("unit", [2, 8, 64])
@pytest.mark.parametrize("weighted", [False, True])
def test_segment_sum_units(unit, weighted):
    """K6's partition into units of equal work gives the segment sums of
    JAX `_segment_sum_sorted` (via the port's plain version, checked
    against JAX here) over a 600-member segment cut across many units,
    short and one-member segments, segments with only their sentinel and
    dropped rows; the weighted case is the trilinear table's R = 2 P
    rows.  ~1 s each."""
    rng = np.random.default_rng(17 + unit)
    p, v = 1500, 300
    ids = np.concatenate([np.full(600, 3), rng.integers(10, 200, p - 700), np.arange(200, 300)])
    ids = ids.astype(np.int32)
    ids[rng.integers(0, p, 50)] = -1
    reps = 2 if weighted else 1
    src = rng.normal(size=(p, 5))
    w = rng.normal(size=reps * p) if weighted else None
    got, (cuts, most), tt = _k6_check(src, ids, v, reps, w, unit, seed=unit)
    counts = tt.counts.numpy()
    assert (counts == 0).any() and (counts == reps).any()  # one member each copy
    assert not got[counts == 0].any()
    assert cuts > 0 and most >= counts.max() // unit


@pytest.mark.parametrize("weighted", [False, True])
def test_segment_sum_units_pixel_table(weighted):
    """A pixel table's shape (TIAF's image tables: many more segments
    than members, ~95% of them empty) at the unit K6 takes for C = 20 f32
    rows: every empty segment reads no perm entry and is written 0; the
    rows kernel, which such tables take, sums each row's members in
    order to the same values.  ~2 s each."""
    rng = np.random.default_rng(5 + weighted)
    p, v = 400, 8000
    plan = tvx.segment_sum_plan(20, 4)
    assert (plan.vw, plan.lanes, plan.pieces, plan.unit) == (16, 8, 1, 64)
    ids = rng.integers(0, v, p).astype(np.int32)
    reps = 2 if weighted else 1
    src = rng.normal(size=(p, 3))
    w = rng.normal(size=reps * p) if weighted else None
    got, _, tt = _k6_check(src, ids, v, reps, w, plan.unit, seed=3)
    counts = tt.counts.numpy()
    assert (counts == 0).mean() > 0.9 and not got[counts == 0].any()
    # such a table takes K6's rows kernel: each row's members in order
    assert tvx.segment_sum_by_rows(reps * p, v)
    perm, starts = tt.perm.numpy(), tt.starts.numpy()
    rows = np.stack([
        sum(((1.0 if w is None else w[r]) * src[r % p] for r in perm[starts[u] : starts[u + 1] - 1]),
            np.zeros(3))
        for u in range(v)
    ])
    np.testing.assert_allclose(rows, got, rtol=0, atol=1e-12)
    assert not tvx.segment_sum_by_rows(reps * p, reps * p)  # point tables: units


def test_segment_tables_sentinel_last():
    """`build_segment_tables` puts segment u's sentinel (row N + u) last
    in u, after its real rows in row order, and the dropped rows after
    starts[V]: what K6 relies on to read no sentinel."""
    rng = np.random.default_rng(2)
    n, v = 5000, 700
    ids = rng.integers(-1, v, n).astype(np.int32)
    ids[:300] = 9
    tt = tvx.build_segment_tables(torch.from_numpy(ids), v)
    perm, starts = tt.perm.numpy(), tt.starts.numpy().astype(np.int64)
    assert (np.diff(starts) >= 1).all()
    assert (perm[starts[1:] - 1] == n + np.arange(v)).all()
    for u in (0, 9, v - 1):
        members = perm[starts[u] : starts[u + 1] - 1]
        np.testing.assert_array_equal(members, np.flatnonzero(ids == u))
    assert set(perm[starts[v]:]) == set(np.flatnonzero(ids < 0))
    np.testing.assert_array_equal(tt.counts.numpy(), np.bincount(ids[ids >= 0], minlength=v))


@pytest.mark.parametrize(
    "c,esz,addr,want",
    [
        (4, 4, 0, (16, 1, 1, 8)), (5, 4, 0, (4, 8, 1, 64)), (20, 4, 0, (16, 8, 1, 64)),
        (32, 4, 0, (16, 8, 1, 64)), (96, 4, 0, (16, 32, 1, 64)), (256, 4, 0, (16, 32, 2, 64)),
        (20, 2, 0, (8, 8, 1, 64)), (256, 2, 0, (16, 32, 1, 64)), (88, 4, 0, (16, 32, 1, 64)),
        (48, 4, 0, (16, 16, 1, 64)), (8, 4, 0, (16, 2, 1, 16)),
        (32, 2, 8, (8, 8, 1, 64)), (5, 2, 0, (2, 8, 1, 64)),
    ],
)
def test_segment_sum_plan(c, esz, addr, want):
    """K6's layout per row width: the widest piece that divides the row
    and the address, the lanes (a power of two) that cover a row, pieces
    per lane past 32 lanes, and the unit: 8 items a lane, at most 64."""
    assert tuple(tvx.segment_sum_plan(c, esz, addr)) == want
