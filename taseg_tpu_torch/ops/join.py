"""Sort-based unique / join primitives on coordinate keys (port of
`taseg_tpu/ops/join.py`).

Equivalents of the reference's hash-map ops (`sphash` / `sphashquery` /
`spcount`, torchsparse `nn/functional/{hash,query,count}.py`):

  * `unique_coords`: one key sort + prefix-sum ids + compaction;
  * `join_keys`: sort the tagged union of reference and query keys (refs
    first on equal keys), run the post-sort join scan (`join_scan`, K1)
    and write the results back to the original row order.

The JAX package sorts the pair (hi, lo) with a two-key `lax.sort`; here
the pair is one int64 key `hi * 2**31 + lo` (both parts are non-negative
and lo < 2**31, so it fits in 62 bits) sorted with one stable
`torch.sort`.  `lax.sort` is not stable, so the order of rows with equal
keys (the `perm` of `unique_coords`) may differ between the packages;
nothing downstream depends on it beyond float summation order.
"""

from __future__ import annotations

import torch

from .coords import GridBounds, QUERY_SENTINEL_HI, pack_keys
from .join_scan import join_scan

_LO_BITS = 31


def _key64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    return (hi.to(torch.int64) << _LO_BITS) | lo.to(torch.int64)


def _split64(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = (key >> _LO_BITS).to(torch.int32)
    lo = (key & (2**_LO_BITS - 1)).to(torch.int32)
    return hi, lo


def check_sorted_keys(hi: torch.Tensor, lo: torch.Tensor) -> None:
    """Raise unless the packed keys are non-decreasing.  Invalid rows
    carry the largest (sentinel) key, so this also checks that every
    valid row comes before every invalid one.  One comparison pass and
    one host read."""
    key = _key64(hi, lo)
    if key.shape[0] > 1 and not bool((key[1:] >= key[:-1]).all()):
        raise ValueError(
            "assume_sorted=True but the coords are not key-sorted with "
            "valid rows first"
        )


def unique_coords(
    coords: torch.Tensor,
    valid: torch.Tensor,
    bounds: GridBounds,
    capacity: int,
    *,
    return_perm: bool = False,
    assume_sorted: bool = False,
) -> tuple:
    """Deduplicate (N, 4) int coords into a capacity-padded unique set.

    Returns (unique_coords (capacity, 4) int32 — key-sorted, valid rows
    first, zero padding; num_unique () int32 — the TRUE count, callers
    detect overflow via num > capacity; inverse (N,) int32, -1 for
    invalid rows; counts (capacity,) int32).  With `return_perm`, also the
    sort permutation (N,) int32: rows sharing a unique id form contiguous
    runs [starts[u], starts[u+1]) for starts = exclusive-cumsum(counts),
    invalid rows last.

    `assume_sorted=True` promises key-sorted input with every valid row
    first (the host pipeline's order); the sort is then skipped.  The
    promise is checked (`check_sorted_keys`) and a broken one raises.
    """
    dev = coords.device
    n_in = coords.shape[0]
    if n_in < capacity:  # pad so the compaction below is well-formed
        pad = capacity - n_in
        coords = torch.cat(
            [coords, torch.zeros((pad, 4), dtype=coords.dtype, device=dev)]
        )
        valid = torch.cat(
            [valid, torch.zeros(pad, dtype=torch.bool, device=dev)]
        )
    n = coords.shape[0]
    hi, lo = pack_keys(coords, bounds, valid)
    if assume_sorted:
        check_sorted_keys(hi, lo)
        skey = _key64(hi, lo)
        sperm = torch.arange(n, dtype=torch.int64, device=dev)
    else:
        skey, sperm = torch.sort(_key64(hi, lo), stable=True)
    shi = (skey >> _LO_BITS).to(torch.int32)

    valid_sorted = shi < int(QUERY_SENTINEL_HI)
    prev_differs = torch.ones(n, dtype=torch.bool, device=dev)
    prev_differs[1:] = skey[1:] != skey[:-1]
    is_first = valid_sorted & prev_differs
    uid = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1
    num_unique = is_first.sum(dtype=torch.int32)
    uid_ok = torch.where(valid_sorted & (uid < capacity), uid, -1)

    # inverse map: the sort permutation's inverse is one index write
    if assume_sorted:
        inverse = uid_ok
    else:
        inverse = torch.empty_like(uid_ok)
        inverse[sperm] = uid_ok

    # take[u] = sorted position of voxel u's first row (slot `capacity`
    # collects the rows that are not first and is dropped)
    first_ok = is_first & (uid < capacity)
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    take = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    take.scatter_(0, torch.where(first_ok, uid.to(torch.int64), capacity), pos)
    take = take[:capacity]

    coords_i = coords.to(torch.int32)
    coords_sorted = coords_i if assume_sorted else coords_i[sperm]
    num_cap = torch.clamp(num_unique, max=capacity)
    in_cap = torch.arange(capacity, dtype=torch.int32, device=dev) < num_cap
    out_coords = torch.where(in_cap[:, None], coords_sorted[take], 0)

    # counts via segment boundaries: next first-position minus mine
    n_valid = valid_sorted.sum(dtype=torch.int64)
    next_start = torch.zeros(capacity, dtype=torch.int64, device=dev)
    next_start[:-1] = take[1:]
    last_u = num_cap - 1
    next_start = torch.where(
        torch.arange(capacity, device=dev) == last_u, n_valid, next_start
    )
    counts = torch.where(in_cap, next_start - take, 0).to(torch.int32)
    if return_perm:
        return (
            out_coords, num_unique, inverse[:n_in], counts,
            sperm.to(torch.int32),
        )
    return out_coords, num_unique, inverse[:n_in], counts


def sorted_union(
    ref_hi: torch.Tensor,
    ref_lo: torch.Tensor,
    q_hi: torch.Tensor,
    q_lo: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The key-sorted union of references and queries that `join_scan`
    sweeps: (shi, slo2, srow) int32, rows < len(ref_hi) are references.
    The ref/query tag in lo's low bit sorts refs first on equal keys;
    callers keep lo < 2^30 (coords.pack_keys)."""
    hi = torch.cat([ref_hi, q_hi])
    lo2 = torch.cat([ref_lo * 2, q_lo * 2 + 1])
    skey, srow = torch.sort(_key64(hi, lo2), stable=True)
    shi, slo2 = _split64(skey)
    return shi, slo2, srow.to(torch.int32)


def join_keys(
    ref_hi: torch.Tensor,
    ref_lo: torch.Tensor,
    num_refs: torch.Tensor,
    q_hi: torch.Tensor,
    q_lo: torch.Tensor,
    *,
    floor: bool = False,
) -> torch.Tensor:
    """For each query key, the index of the equal reference key or -1.

    With `floor=True`, returns the encoded FLOOR result `f * 2 + exact`:
    f is the index of the largest reference key <= the query key (-1 when
    the query sorts before every reference, encoding -2), exact is 1 iff
    ref[f] equals the query key.

    References must be unique among their first `num_refs` rows and
    key-sorted ascending (both hold for `unique_coords` output).
    """
    v = ref_hi.shape[0]
    dev = ref_hi.device
    shi, slo2, srow = sorted_union(ref_hi, ref_lo, q_hi, q_lo)
    num_refs = torch.as_tensor(num_refs, dtype=torch.int32, device=dev)
    result_sorted = join_scan(
        shi, slo2, srow, num_refs, v, int(QUERY_SENTINEL_HI),
        1 if floor else 0,
    )
    # back to the original row order with one index write
    out = torch.empty_like(result_sorted)
    out[srow.to(torch.int64)] = result_sorted
    return out[v:]


def query_coords(
    query: torch.Tensor,
    query_valid: torch.Tensor,
    refs: torch.Tensor,
    num_refs: torch.Tensor,
    bounds: GridBounds,
) -> torch.Tensor:
    """Find each query coord (..., 4) in a reference coord set (the
    `unique_coords` output).  Returns int32 indices into `refs`, -1 when
    absent."""
    ref_valid = (
        torch.arange(refs.shape[0], dtype=torch.int32, device=refs.device)
        < num_refs
    )
    ref_hi, ref_lo = pack_keys(refs, bounds, ref_valid)
    q_hi, q_lo = pack_keys(
        query.reshape(-1, 4), bounds, query_valid.reshape(-1), is_query=True
    )
    idx = join_keys(ref_hi, ref_lo, num_refs, q_hi, q_lo)
    return idx.reshape(query.shape[:-1])
