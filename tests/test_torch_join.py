"""The port's coordinate keys, unique and sort-joins against the JAX
package, on the same numpy inputs (CPU: the plain join scan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.ops import compute_bounds as j_bounds
from taseg_tpu.ops import join_keys as j_join_keys
from taseg_tpu.ops import pack_keys as j_pack
from taseg_tpu.ops import unique_coords as j_unique
from taseg_tpu.ops.coords import QUERY_SENTINEL_HI
from taseg_tpu.ops.join_scan import BLOCK, join_scan as j_join_scan
from taseg_tpu_torch.ops import coords as tc
from taseg_tpu_torch.ops import join as tj
from taseg_tpu_torch.ops.join_scan import join_scan, join_scan_plain


def random_coords(rng, n, lo=-50, hi=50, batches=3):
    xyz = rng.integers(lo, hi, size=(n, 3))
    b = rng.integers(0, batches, size=(n, 1))
    return np.concatenate([xyz, b], axis=1).astype(np.int32)


def t_bounds(coords, valid):
    return tc.compute_bounds(torch.from_numpy(coords), torch.from_numpy(valid))


def test_bounds_and_pack_keys_equal():
    rng = np.random.default_rng(0)
    coords = random_coords(rng, 500)
    valid = rng.random(500) > 0.2
    jb = j_bounds(jnp.asarray(coords), jnp.asarray(valid))
    tb = t_bounds(coords, valid)
    np.testing.assert_array_equal(np.asarray(jb.origin), tb.origin.numpy())
    np.testing.assert_array_equal(np.asarray(jb.extent), tb.extent.numpy())
    q = coords.copy()
    q[::7, 2] += 500  # out of bounds
    for is_query in (False, True):
        jh, jl = j_pack(jnp.asarray(q), jb, jnp.asarray(valid), is_query=is_query)
        th, tl = tc.pack_keys(torch.from_numpy(q), tb, torch.from_numpy(valid), is_query=is_query)
        np.testing.assert_array_equal(np.asarray(jh), th.numpy())
        np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    assert tc.REF_SENTINEL_HI == 2**31 - 1 and tc.QUERY_SENTINEL_HI == 2**31 - 2


def _union(rng, v, q):
    """A random sorted union as `tests/test_ops_join.py` builds it: heavy
    key collisions, padded refs, sentinel queries, num_refs < v."""
    ref_keys = np.unique(np.sort(rng.integers(0, v, size=v).astype(np.int64)))
    pad_r = v - len(ref_keys)
    ref_hi = np.concatenate([ref_keys // 7, np.full(pad_r, 2**31 - 1)]).astype(np.int32)
    ref_lo = np.concatenate([ref_keys % 7, np.zeros(pad_r)]).astype(np.int32)
    q_hi = rng.integers(0, max(v // 7, 2), size=q).astype(np.int32)
    q_lo = rng.integers(0, 7, size=q).astype(np.int32)
    q_hi[::13] = int(QUERY_SENTINEL_HI)
    q_lo[::13] = 0
    return ref_hi, ref_lo, len(ref_keys), q_hi, q_lo


SIZES = ((600, 2200), (4096, 8192), (33, 40))


@pytest.mark.parametrize("v,q", SIZES)
@pytest.mark.parametrize("floor", [False, True])
def test_join_keys_matches_jax(v, q, floor):
    rng = np.random.default_rng(17 + v)
    ref_hi, ref_lo, nref, q_hi, q_lo = _union(rng, v, q)
    for num_refs in (nref, max(nref // 2, 1)):  # also refs cut below V
        want = np.asarray(
            j_join_keys(
                jnp.asarray(ref_hi), jnp.asarray(ref_lo), jnp.int32(num_refs),
                jnp.asarray(q_hi), jnp.asarray(q_lo), floor=floor,
            )
        )
        got = tj.join_keys(
            torch.from_numpy(ref_hi), torch.from_numpy(ref_lo),
            torch.tensor(num_refs, dtype=torch.int32),
            torch.from_numpy(q_hi), torch.from_numpy(q_lo), floor=floor,
        ).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("v,q", SIZES)
def test_plain_join_scan_matches_pallas_interpret(v, q):
    """The plain join scan (what K1 is held to on the card) against the
    Pallas kernel in interpret mode, both modes, bit-exact."""
    rng = np.random.default_rng(5 + q)
    ref_hi, ref_lo, nref, q_hi, q_lo = _union(rng, v, q)
    n = v + q
    hi = jnp.concatenate([jnp.asarray(ref_hi), jnp.asarray(q_hi)])
    lo2 = jnp.concatenate([jnp.asarray(ref_lo) * 2, jnp.asarray(q_lo) * 2 + 1])
    shi, slo2, srow = jax.lax.sort((hi, lo2, jnp.arange(n, dtype=jnp.int32)), num_keys=2)
    n_pad = (n + BLOCK - 1) // BLOCK * BLOCK
    padn = n_pad - n
    shi_p = jnp.concatenate([shi, jnp.full((padn,), QUERY_SENTINEL_HI, jnp.int32)])
    slo2_p = jnp.concatenate([slo2, jnp.ones((padn,), jnp.int32)])
    srow_p = jnp.concatenate([srow, jnp.full((padn,), 2**30, jnp.int32)])
    t_args = [torch.from_numpy(np.array(x)) for x in (shi, slo2, srow)]
    for mode in (0, 1):
        scalars = jnp.stack([jnp.int32(nref), jnp.int32(v), QUERY_SENTINEL_HI, jnp.int32(mode)])
        want = np.asarray(j_join_scan(shi_p, slo2_p, srow_p, scalars, n_pad, True))[:n]
        num = torch.tensor([nref], dtype=torch.int32)
        got = join_scan(*t_args, num, v, int(QUERY_SENTINEL_HI), mode).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"mode {mode}")
        plain = join_scan_plain(*t_args, num, v, int(QUERY_SENTINEL_HI), mode)
        np.testing.assert_array_equal(plain.numpy(), want)


def test_join_scan_rejects_bad_inputs():
    x = torch.zeros(8, dtype=torch.int32)
    num = torch.tensor([1], dtype=torch.int32)
    with pytest.raises(TypeError):
        join_scan(x.long(), x, x, num, 4, 0, 0)
    with pytest.raises(ValueError):
        join_scan(x, x[:4], x, num, 4, 0, 0)
    with pytest.raises(ValueError):
        join_scan(x, x, x, num, 4, 0, 2)
    with pytest.raises(ValueError):
        join_scan(x[::2], x[::2].clone(), x[::2].clone(), num, 4, 0, 0)


def _unique_both(coords, valid, cap, **kw):
    jb = j_bounds(jnp.asarray(coords), jnp.asarray(valid))
    tb = t_bounds(coords, valid)
    j = j_unique(jnp.asarray(coords), jnp.asarray(valid), jb, cap, **kw)
    t = tj.unique_coords(torch.from_numpy(coords), torch.from_numpy(valid), tb, cap, **kw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


@pytest.mark.parametrize("cap", [512, 16])
def test_unique_coords_matches_jax(cap):
    """coords, num, inverse and counts equal; perm equal as a set within
    every equal-key run (`lax.sort` is not stable)."""
    rng = np.random.default_rng(1)
    n = 400
    coords = random_coords(rng, n, lo=-10, hi=10)
    valid = rng.random(n) > 0.1
    j, t = _unique_both(coords, valid, cap, return_perm=True)
    for name, a, b in zip(("coords", "num", "inverse", "counts"), j[:4], t[:4]):
        np.testing.assert_array_equal(b, a, err_msg=name)
    num = min(int(j[1]), cap)
    starts = np.concatenate([[0], np.cumsum(j[3])])
    for u in range(num):
        run = slice(starts[u], starts[u + 1])
        assert set(j[4][run]) == set(t[4][run]), u
    # invalid rows sort last in both
    assert set(j[4][valid.sum():]) == set(t[4][valid.sum():])


def test_unique_coords_assume_sorted():
    rng = np.random.default_rng(11)
    n, cap = 500, 1024
    coords = random_coords(rng, n, lo=-15, hi=15)
    valid = np.ones(n, bool)
    tb = t_bounds(coords, valid)
    hi, lo = tc.pack_keys(torch.from_numpy(coords), tb, torch.from_numpy(valid))
    order = np.lexsort((lo.numpy(), hi.numpy()))
    sorted_coords = coords[order]
    j, t = _unique_both(sorted_coords, valid, cap, return_perm=True, assume_sorted=True)
    for name, a, b in zip(("coords", "num", "inverse", "counts", "perm"), j, t):
        np.testing.assert_array_equal(b, a, err_msg=name)
    # the promise is checked: unsorted keys, or a valid row after an
    # invalid one, raise
    with pytest.raises(ValueError):
        tj.unique_coords(torch.from_numpy(coords), torch.from_numpy(valid), tb, cap, assume_sorted=True)
    holes = valid.copy()
    holes[10] = False
    with pytest.raises(ValueError):
        tj.unique_coords(torch.from_numpy(sorted_coords), torch.from_numpy(holes), tb, cap, assume_sorted=True)


@pytest.mark.parametrize("seed", [0, 7])
def test_query_coords_matches_jax(seed):
    from taseg_tpu.ops import query_coords as j_query

    rng = np.random.default_rng(seed)
    n, cap = 300, 512
    coords = random_coords(rng, n, lo=-20, hi=20)
    valid = np.ones(n, bool)
    (ju, jn, _, _), (tu, tn, _, _) = _unique_both(coords, valid, cap)
    q = np.concatenate([coords[rng.integers(0, n, 100)], random_coords(rng, 100, lo=200, hi=260)])
    q_valid = np.ones(len(q), bool)
    q_valid[-10:] = False
    jb = j_bounds(jnp.asarray(coords), jnp.asarray(valid))
    want = np.asarray(j_query(jnp.asarray(q), jnp.asarray(q_valid), jnp.asarray(ju), jnp.int32(jn), jb))
    got = tj.query_coords(
        torch.from_numpy(q), torch.from_numpy(q_valid), torch.from_numpy(tu),
        torch.tensor(int(tn), dtype=torch.int32), t_bounds(coords, valid),
    ).numpy()
    np.testing.assert_array_equal(got, want)
