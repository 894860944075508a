"""What the 3xTF32 route of K2 and K4 at K offsets reads, on the CPU: the
row orders and pair lists of the cylinder_tiny topology, the route rule,
and a numpy emulation of the 3xTF32 products.

The topology: the cylinder_tiny recipe's pipeline (64 x 64 x 16 polar
grid) on one 4000-point synthetic scan, 4096 rows, in its train form (22
tables, 22 reverse tables with pair lists).  Checked against numpy:
`mask_row_order` is a permutation that groups the rows by their bitmask
of present offsets (each mask's rows in one run, in table order, rows
without offsets last), the topology's batched orders (`mask_row_orders`)
equal it, a flipped table's order groups the same rows, and the pair
lists of every reverse table (`pair_lists_many`, one buffer per row
count) list the present (row, entry) pairs per offset in row order.

The tile work: a 64-row tile runs every offset that one of its rows has,
so it does 64 x (offsets in its union) row products.  Over the 22 tables
of this small scene (1127 voxels at level 0, up to 691 distinct masks in
a table) that is [measured] 3.09x the present pairs in table order (the
CUDA-core kernel's tiles) and 2.11x over `mask_row_order` (the 3xTF32
kernel's); `chip_smoke.py` states the ratios of the full-size tables.

The emulation: TF32 is f32 rounded to nearest (ties away) at 10 mantissa
bits; x = hi + lo with hi, lo both TF32, each product as lo*hi + hi*lo +
hi*hi, f32 sums.  At every (C_in, C_out) of the cy480 convs and their
input gradients, at K = 9 and 27, its conv is within 1e-5 of the largest
sum of |terms| of the f32 plain version [worst 6.9e-8 of it] while one
TF32 pass is not [worst 9.9e-5].  About 9 s on one worker.
"""

import numpy as np
import pytest
import torch

from taseg_tpu_torch.data.cylinder_dataset import CylinderPipeline
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.models.layers import SparseConv
from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities
from taseg_tpu_torch.models.voxel.cylinder3d import CylinderTS, build_cylinder_topology
from taseg_tpu_torch.ops import f3conv as tf3
from taseg_tpu_torch.ops import sparse_conv as tsc

CAP = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def topo():
    pts, labels = synthetic_scan(np.random.default_rng(7), 4000)
    scan = {"xyzret": np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1), "labels": labels}
    pipe = CylinderPipeline(grid=(64, 64, 16), training=False)
    arrays = pipe.collate([pipe(scan)], CAP)
    return build_cylinder_topology(
        torch.from_numpy(arrays["point_coords"]), torch.from_numpy(arrays["num_points"].reshape(())),
        UNetCapacities.for_points(CAP), train=True,
    )


def _tables(t):
    """name -> (forward KTable, its reverse KTable) of every conv table."""
    out = {}
    for l, lv in enumerate(t.levels):
        for i, (f, b) in enumerate(zip(lv.asym, lv.asym_bwd)):
            out[f"asym{i}_l{l}"] = (f, b)
        if l:
            out[f"down_l{l}"] = (lv.down, lv.up)
            out[f"up_l{l}"] = (lv.up, lv.down)
    for i, (f, b) in enumerate(zip(t.recon, t.recon_bwd)):
        out[f"recon{i}"] = (f, b)
    out["head"] = (t.head, t.head_bwd)
    return out


NAMES = (
    [f"asym{i}_l{l}" for l in range(5) for i in range(2)]
    + [f"{d}_l{l}" for l in range(1, 5) for d in ("down", "up")]
    + ["recon0", "recon1", "recon2", "head"]
)


def _masks(rb: np.ndarray) -> np.ndarray:
    return ((rb >= 0).astype(np.int64) << np.arange(rb.shape[0])[:, None]).sum(0)


def test_every_table_has_its_order_and_lists(topo):
    """22 tables, each with its row order; the reverse tables (22) with
    their pair lists; the flipped tables share their table's order."""
    tabs = _tables(topo)
    assert sorted(tabs) == sorted(NAMES)
    for name, (f, b) in tabs.items():
        assert f.order is not None and f.order.dtype == torch.int32
        assert b.pairs is not None and b.order is not None
        if not name.startswith(("down", "up")):
            assert b.order is f.order and f.pairs is None
            assert torch.equal(b.rb, tsc.flip_rulebook(f.rb))


@pytest.mark.parametrize("name", NAMES)
def test_mask_row_order_groups_rows(topo, name):
    """A permutation; the rows of each bitmask form one run, in table
    order; the rows with no offset come last.  The topology's order (one
    sort for all tables of its row count) equals the table's own."""
    f, _ = _tables(topo)[name]
    order = f.order.numpy()
    assert torch.equal(f.order, tsc.mask_row_order(f.rb))
    v = f.rb.shape[1]
    np.testing.assert_array_equal(np.sort(order), np.arange(v))
    m = _masks(f.rb.numpy())[order]
    n = int((m > 0).sum())
    assert (m[:n] > 0).all() and not m[n:].any()
    runs = m[np.r_[True, np.diff(m) != 0]]
    assert len(runs) == len(np.unique(m))
    same = np.diff(m) == 0
    assert (np.diff(order)[same] > 0).all()


@pytest.mark.parametrize("name", [n for n in NAMES if not n.startswith(("down", "up"))])
def test_flipped_table_order_groups_the_same_rows(topo, name):
    """flip(rb) reverses each row's offsets, so rows with equal masks in
    rb have equal masks in flip(rb): the order that the topology shares
    between the two groups the flipped table's rows as its own does."""
    f, b = _tables(topo)[name]
    m_f = _masks(f.rb.numpy())
    m_b = _masks(b.rb.numpy())
    order = f.order.numpy()
    own = tsc.mask_row_order(b.rb).numpy()

    def groups(m, o):
        return sorted(tuple(sorted(o[m[o] == u])) for u in np.unique(m[o]))

    assert groups(m_f, order) == groups(m_b, order) == groups(m_b, own)


def _tile_work(rb: np.ndarray, rows: np.ndarray) -> int:
    """64 x the offsets each 64-row tile of `rows` runs (their union)."""
    work = 0
    for t in range(0, len(rows), 64):
        work += 64 * int((rb[:, rows[t : t + 64]] >= 0).any(1).sum())
    return work


def test_mask_sorted_tiles_run_fewer_offsets(topo):
    """Over all 22 tables, the 64-row tiles' union work against the
    present pairs: in table order (the CUDA-core kernel) and over the
    mask-sorted order (the 3xTF32 kernel), the sorted one no larger in
    each table and [measured] 3.09x -> 2.11x in all."""
    present = plain = sort = 0
    for name in NAMES:
        f, _ = _tables(topo)[name]
        rb = f.rb.numpy()
        p = int((rb >= 0).sum())
        a = _tile_work(rb, np.arange(rb.shape[1]))
        b = _tile_work(rb, f.order.numpy())
        assert b <= a, name
        present, plain, sort = present + p, plain + a, sort + b
    assert sort / present < 2.4 < 2.9 < plain / present, (plain / present, sort / present)


@pytest.mark.parametrize("name", NAMES)
def test_pair_lists_equal_numpy(topo, name):
    """The pair lists of each reverse table: per offset the (row, entry)
    pairs of its present entries in row order, and the start table, the
    same as the table's own `pair_lists`."""
    _, b = _tables(topo)[name]
    rb = b.rb.numpy()
    want, starts = [], [0]
    for k in range(rb.shape[0]):
        i = np.nonzero(rb[k] >= 0)[0]
        want.append(np.stack([i, rb[k, i]], 1))
        starts.append(starts[-1] + len(i))
    got = b.pairs
    at = int(got.starts[0])  # where the table's lists sit in the shared buffer
    np.testing.assert_array_equal(got.starts.numpy() - at, starts)
    np.testing.assert_array_equal(got.pairs[at : at + starts[-1]].numpy(), np.concatenate(want))
    own = tf3.pair_lists(b.rb)
    assert torch.equal(own.starts, got.starts - at)
    assert torch.equal(own.pairs[: starts[-1]], got.pairs[at : at + starts[-1]])
    assert tf3.k3_pair_lists is tf3.pair_lists


# ---------------------------------------------------------------- 3xTF32
def _tf32(x: np.ndarray) -> np.ndarray:
    """f32 rounded to nearest, ties away from zero, at 10 mantissa bits
    (cvt.rna.tf32.f32)."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _gathered(x, rb):
    g = x[np.clip(rb, 0, None)]
    return np.where((rb >= 0)[..., None], g, np.float32(0))


def _conv_3xtf32(x, w, rb):
    """The kernel's arithmetic per offset: lo*hi + hi*lo + hi*hi."""
    out = np.zeros((rb.shape[1], w.shape[2]), np.float32)
    wh, wl = _split(w)
    for k in range(rb.shape[0]):
        ah, al = _split(_gathered(x, rb[k]))
        out = out + al @ wh[k]
        out = out + ah @ wl[k]
        out = out + ah @ wh[k]
    return out


def _conv_1xtf32(x, w, rb):
    out = np.zeros((rb.shape[1], w.shape[2]), np.float32)
    for k in range(rb.shape[0]):
        out = out + _tf32(_gathered(x, rb[k])) @ _tf32(w[k])
    return out


def _cy480_widths():
    """(C_in, C_out) of every conv over K offsets of cy480 (INIT_SIZE 32)
    and of its input gradient (the widths swapped)."""
    m = CylinderTS(20, init_size=32, device="meta")
    w = {(c.in_channels, c.out_channels) for c in m.modules()
         if isinstance(c, SparseConv) and c.kernel_volume > 1}
    return sorted(w | {(b, a) for a, b in w})


CY480 = _cy480_widths()


def test_cy480_widths():
    """The head (128 -> 20) and the widest conv (768 -> 512) are among
    them, and every width is a multiple of 4."""
    assert (128, 20) in CY480 and (768, 512) in CY480 and (20, 128) in CY480
    assert all(a % 4 == 0 and b % 4 == 0 for a, b in CY480)


@pytest.mark.parametrize("c_in,c_out", CY480)
def test_3xtf32_emulation_holds_the_f32_tolerance(c_in, c_out):
    """At K = 9 and 27, 24 output rows over 40 input rows (each entry
    present with probability 0.6): the 3xTF32 conv within 1e-5 of the
    largest sum of |terms| of the f32 plain version; one TF32 pass is
    more than 10x further from it."""
    rng = np.random.default_rng(c_in * 1000 + c_out)
    for k in (9, 27):
        rb = rng.integers(0, 40, (k, 24)).astype(np.int32)
        rb[rng.random((k, 24)) > 0.6] = -1
        x = rng.normal(size=(40, c_in)).astype(np.float32)
        w = (rng.normal(size=(k, c_in, c_out)) / np.sqrt(c_in)).astype(np.float32)
        t = torch.from_numpy
        want = tsc.sparse_conv_plain(t(x), t(w), t(rb)).numpy()
        scale = tsc.sparse_conv_plain(t(np.abs(x)), t(np.abs(w)), t(rb)).numpy().max()
        err3 = np.abs(_conv_3xtf32(x, w, rb) - want).max()
        err1 = np.abs(_conv_1xtf32(x, w, rb) - want).max()
        assert err3 <= 1e-5 * scale, (k, err3 / scale)
        assert err1 > 10 * err3, (k, err1 / scale, err3 / scale)


def test_k_route():
    """f32 at cy480's widths: the 3xTF32 route; bf16 the wgmma tile; a
    ragged width (the 20- and 23-class heads, odd widths) the same
    routes, padded to a multiple of 4 (f32) or 8 (bf16); the split rule
    of K2's 3xTF32 route at cy480's level capacities."""
    for a, b in CY480 + [(128, 20), (128, 23), (37, 20), (16, 30), (6, 32)]:
        assert tsc.k_route(torch.float32, a, b) == "tf32x3"
        assert tsc.k_route(torch.bfloat16, a, b) == "wgmma"
    assert [tsc.padded_width(torch.float32, c) for c in (20, 23, 37)] == [20, 24, 40]
    assert [tsc.padded_width(torch.bfloat16, c) for c in (20, 23, 37)] == [24, 24, 40]
    # the 27-offset conv's own rule: a direct f32 call stays on CUDA cores
    assert tsc.route(torch.float32, 128, 128) == "simt"
    # K2's chains are cut on cy480's coarse levels (capacities 28928,
    # 12032, 4608), not on levels 0 and 1 (131072, 78848)
    assert [tsc.k_splits(v) for v in (131072, 78848, 28928, 12032, 4608)] == [1, 1, 4, 4, 4]
