"""K10's plan (`voxelize.segment_max_plan`) at the main paths' shapes,
each value worked out by hand; the first designs of K9 and K10 (the
yardsticks) behind the kernels' own argument checks; and K10's run
merging (`csrc/segment_max.cu`, `k10_runs_kernel`) emulated in numpy:
the warps' passes, their segmented scans (or the fold of a pass that
only continues the carry), the carry from pass to pass,
each warp's held-back head and tail and the block's merge of its warps
in row order, flushing every row exactly once (a count of the members)
and the max of each segment, at every plan shape (16-byte pieces and one
column a thread, 1-32 threads a row, several blocks along a row).  No
JAX, no card.  Measured ~5 s in one process.
"""

import numpy as np
import pytest
import torch

from taseg_tpu_torch.ops import knn
from taseg_tpu_torch.ops import voxelize as vx


@pytest.mark.parametrize("args,want", [
    # Cylinder_TS: 131 072 x 16 f32; 16-byte pieces of 4 columns, 4
    # threads a row, 8 rows a warp pass; 8448 warps a wave take
    # ceil(131 072 / 8448) = 16 rows each, two passes; 131 072 / (8 x 16)
    # = 1024 blocks
    ((131_072, 16, 4), (4, 4, 1, 16, 1024)),
    # the pool: 65 536 x 128 f32, 32 threads a row (one row a pass),
    # ceil(65 536 / 8448) = 8 rows a warp, 65 536 / 64 = 1024 blocks
    ((65_536, 128, 4), (4, 32, 1, 8, 1024)),
    # the pool in bf16: 8 columns a piece, 16 threads a row, 2 rows a pass
    ((65_536, 128, 2), (8, 16, 1, 8, 1024)),
    # 3 f32 columns hold no whole piece: one column a thread, 4 threads
    # (the power of two over 3), 8 rows a pass, one pass a warp
    ((60, 3, 4), (1, 4, 1, 8, 1)),
    # 300 f32 columns: 75 pieces, 32 threads a row, 3 blocks along it;
    # ceil(120 000 x 3 / 8448) = 43 rows a warp, ceil(120 000 / 344) = 349
    ((120_000, 300, 4), (4, 32, 3, 43, 349)),
    # one column: one thread a row, 32 rows a pass
    ((10, 1, 4), (1, 1, 1, 32, 1)),
    # Cylinder_TS's call in bf16: 16 columns are 2 pieces of 8, 2 threads
    # a row, 16 rows a pass; ceil(131 072 / 8448) = 16 rows a warp, one
    # pass; 131 072 / (8 x 16) = 1024 blocks
    ((131_072, 16, 2), (8, 2, 1, 16, 1024)),
    # the global max pool on SparseResNet21D's last stage: 38 450 x 128
    # f32, 32 threads a row, ceil(38 450 / 8448) = 5 rows a warp,
    # ceil(38 450 / 40) = 962 blocks
    ((38_450, 128, 4), (4, 32, 1, 5, 962)),
])
def test_segment_max_plan_by_hand(args, want):
    assert tuple(vx.segment_max_plan(*args)) == want


def test_segment_max_plan_unaligned_rows_take_one_column_a_thread():
    # 16 threads a row, 2 rows a pass; 16 rows a warp, 1024 blocks as above
    assert tuple(vx.segment_max_plan(131_072, 16, 4, aligned=False)) == (1, 16, 1, 16, 1024)


def _knn_args():
    rng = np.random.default_rng(3)
    r = torch.from_numpy(rng.uniform(1.0, 9.0, (4, 8)).astype(np.float32))
    lab = torch.from_numpy(rng.integers(0, 5, (4, 8)).astype(np.int32))
    px, py = torch.tensor([0, 7, 3], dtype=torch.int32), torch.tensor([0, 3, 2], dtype=torch.int32)
    return [r, r[py.long(), px.long()] + 0.1, lab, px, py]


@pytest.mark.parametrize("fn", [knn.knn_postprocess, knn.knn_postprocess_v1])
@pytest.mark.parametrize("bad", ["dtype", "points", "cutoff"])
def test_knn_and_its_first_design_check_alike(fn, bad):
    """K9's wrapper and its first design's (the yardstick, timed beside
    it) refuse the same arguments before any launch, so their `cuda_ms`
    pay for the same checks."""
    args, kw = _knn_args(), {"num_classes": 5}
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "points":
        args[3] = args[3][:2]
    else:
        kw["cutoff"] = 0.0
    with pytest.raises((TypeError, ValueError)):
        fn(*args, **kw)


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_segment_max_backward_and_its_first_design_check_alike(bad):
    """K10's backward wrapper and its first design's refuse the same
    arguments before any launch."""
    x = torch.zeros(6, 4)
    seg = torch.tensor([0, 0, 1, 1, 2, 2])
    out, g = torch.zeros(3, 4), torch.zeros(3, 4)
    if bad == "dtype":
        g = g.double()
    else:
        g = torch.zeros(3, 5)
    for fn in (vx.segment_max_bwd_kernel, vx.segment_max_bwd_v1):
        with pytest.raises((TypeError, ValueError)):
            fn(x, seg, out, g)


def test_segment_max_plan_lengthens_long_segments():
    # the pool: 65 536 rows into 3 segments (>= 64 rows each on average):
    # chunks 4 x 8 = 32 rows, 65 536 / 256 = 256 blocks; Cylinder's 131 073
    # segments of 131 072 rows keep the plan above
    assert tuple(vx.segment_max_plan(65_536, 128, 4, True, 3)) == (4, 32, 1, 32, 256)
    assert tuple(vx.segment_max_plan(131_072, 16, 4, True, 131_073)) == (4, 4, 1, 16, 1024)
    # 64 rows a segment on average is long; 63 is not
    assert vx.segment_max_plan(6400, 16, 4, True, 100).chunk == 4 * vx.segment_max_plan(6400, 16, 4).chunk
    assert vx.segment_max_plan(6300, 16, 4, True, 100).chunk == vx.segment_max_plan(6300, 16, 4).chunk


def _emulate_runs(x, seg, s, plan, count: bool):
    """`k10_runs_kernel` step by step: per block along the rows and the
    row, per warp its chunk in passes of 32 / tpr rows (all tpr x vec
    columns of a pass at once); the flushes added into (s, c)."""
    p, c = x.shape
    vec, tpr, col_blocks, chunk, blocks = plan
    rpw, width = 32 // tpr, tpr * vec
    ident = 0.0 if count else -np.inf
    comb = np.add if count else np.maximum
    out = np.full((s, c), ident)

    def flush(i, cols, v):
        if i >= 0:
            ok = cols < c
            out[i, cols[ok]] = comb(out[i, cols[ok]], v[ok])

    for by in range(col_blocks):
        cols = by * width + np.arange(width)
        for bx in range(blocks):
            warps = []
            for w in range(vx.K10_WARPS):
                row0 = (bx * vx.K10_WARPS + w) * chunk
                cid, cv, pending, head = -1, None, True, None
                for k in range(chunk // rpw):
                    rows = row0 + k * rpw + np.arange(rpw)
                    ids = np.array([seg[r] if r < p else -1 for r in rows])
                    v = np.full((rpw, width), ident)
                    for i, r in enumerate(rows):
                        if ids[i] >= 0:
                            v[i, cols < c] = 1.0 if count else x[r, cols[cols < c]]
                    if k > 0 and (ids == cid).all():  # the pass only continues the carry
                        cv = comb(cv, comb.reduce(v, axis=0))
                        continue
                    run = np.zeros(rpw, int)
                    for i in range(1, rpw):
                        run[i] = i if ids[i] != ids[i - 1] else run[i - 1]
                    d = 1
                    while d < rpw:  # the segmented scan, Hillis-Steele
                        o = np.concatenate([np.full((d, width), ident), v[:-d]])
                        v = np.where((np.arange(rpw) - d >= run)[:, None], comb(v, o), v)
                        d <<= 1
                    ends = np.array([i != rpw - 1 and ids[i + 1] != ids[i] for i in range(rpw)])
                    cont = k > 0 and ids[0] == cid
                    if cont:
                        v = np.where((run == 0)[:, None], comb(v, cv[None]), v)
                    head_slot = -1
                    if k > 0 and not cont:  # the carry's run ended at the pass boundary
                        if pending:
                            head, pending = (cid, cv), False
                        else:
                            flush(cid, cols, cv)
                    elif pending and ends.any():
                        head_slot, pending = int(np.argmax(ends)), False
                    for i in np.flatnonzero(ends):
                        if i == head_slot:
                            head = (ids[i], v[i].copy())
                        else:
                            flush(ids[i], cols, v[i])
                    cid, cv = ids[-1], v[-1].copy()
                warps.append((pending, head, (cid, cv)))
            cur, acc = -1, np.full(width, ident)
            for single, head, (tid, tv) in warps:  # the block's merge in row order
                if single:
                    if tid == cur:
                        acc = comb(acc, tv)
                    else:
                        flush(cur, cols, acc)
                        cur, acc = tid, tv
                    continue
                if head[0] == cur:
                    flush(cur, cols, comb(acc, head[1]))
                else:
                    flush(cur, cols, acc)
                    flush(head[0], cols, head[1])
                cur, acc = tid, tv
            flush(cur, cols, acc)
    return out


@pytest.mark.parametrize("p,c,esz,aligned,layout", [
    (2000, 16, 4, True, "cylinder"),  # one row a segment, shuffled, padding at the end
    (1500, 16, 4, True, "pairs"),     # two rows a segment
    (3000, 128, 4, True, "pool"),     # three sorted segments
    (900, 20, 2, False, "runs"),      # runs of 7 rows, one column a thread
    (700, 300, 4, True, "random"),    # three blocks along the row
    (500, 16, 2, True, "random"),     # bf16 pieces of 8, 2 threads a row
])
def test_runs_merge_flushes_every_row_once(p, c, esz, aligned, layout):
    rng = np.random.default_rng(p + c)
    if layout == "cylinder":
        seg = np.concatenate([rng.permutation(p - 300), np.full(300, p - 300)])
    elif layout == "pairs":
        seg = rng.permutation(p) // 2
    elif layout == "pool":
        seg = np.sort(rng.integers(0, 3, p))
    elif layout == "runs":
        seg = np.repeat(rng.integers(0, 40, p // 7 + 1), 7)[:p]
    else:
        seg = rng.integers(0, 60, p)
    s = int(seg.max()) + 1
    x = rng.normal(size=(p, c))
    plan = vx.segment_max_plan(p, c, esz, aligned)
    n = np.zeros((s, c))
    np.add.at(n, seg, 1.0)
    m = np.full((s, c), -np.inf)
    np.maximum.at(m, seg, x)
    np.testing.assert_array_equal(_emulate_runs(x, seg, s, plan, count=True), n)
    np.testing.assert_array_equal(_emulate_runs(x, seg, s, plan, count=False), m)
