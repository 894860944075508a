"""What the wgmma route of K2 and K3 reads, planned on the CPU.

The topology of a small synthetic scan (8000 raycast points at 0.2 m
voxels, non-negative coordinates as the host pipelines give them, point
capacity 8192): every level carries its row order `k3_order` (bf16
topologies too), and every level below the first the child table of
K3-down (`StridedTables.child`, one round) with its own order
(`child_order`), all equal to a numpy build; built with
`nonneg_coords=True` (one scatter, nothing read back) they equal the
tables whose rounds are counted on the host; and the up table of K3-up
(`StridedTables.up`: each live fine row's parent at its slot) with its
order (`up_order`: the fine rows grouped by slot, dead rows last), equal
to numpy.  The tile work: a 64-row
tile runs every offset one of its rows has, so over the order it comes
nearer the present pairs than in table order (numpy counts them too).
The split rule of the wgmma route (`wgmma_splits`, from V_out alone) at
the capacities of MinkUNet's and FSA's levels, and the entry, counters
and splits each wrapper hands its launch, recorded without a card.
K3-down through the child table (`downsample_conv_slot_plain`, the
arithmetic of its tensor-core routes) against JAX's
`downsample_conv_apply` and, as the up conv's input gradient (down on
W^T), against `jax.vjp(upsample_conv_apply)`, in f32 within 1e-4 of the
output scale (JAX sums the children with a mean-centred cumsum), on
non-negative coordinates (one round) and around 0 (several rounds).
K3-up through the up table (`upsample_conv_up_plain`, the arithmetic of
its tensor-core routes) against JAX's `upsample_conv_apply` and, as the
down conv's input gradient (up on W^T, JAX `_down_bwd`), against
`jax.vjp(downsample_conv_apply)`, in f32 within 1e-5 of the output scale.

Torch runs on one thread; JAX's references are jitted once per module.
About 12 s on one worker.
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
from taseg_tpu.ops.strided_conv import build_strided_tables as j_strided
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.models.voxel.backbone_context import (
    UNetCapacities,
    build_unet_topology,
    host_nonneg,
)
from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.ops import coords as tc
from taseg_tpu_torch.ops import join as tj
from taseg_tpu_torch.ops import rulebook as tr
from taseg_tpu_torch.ops import sparse_conv as tsc
from taseg_tpu_torch.ops import strided_conv as tst

P = 8192
J_DOWN = jax.jit(j_down)
J_UP_VJP = jax.jit(lambda x, w, tab, g: jax.vjp(lambda a: j_up(a, w, tab), x)[1](g)[0])
J_UP = jax.jit(j_up)
J_DOWN_VJP = jax.jit(lambda x, w, tab, g: jax.vjp(lambda a: j_down(a, w, tab), x)[1](g)[0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan_coords():
    """(P, 4) float32 voxel coordinates of one synthetic scan, shifted to
    be non-negative and padded with zeros, and the valid count."""
    pts, _ = synthetic_scan(np.random.default_rng(3), 8000)
    vox = np.unique(np.floor(pts[:, :3] / 0.2).astype(np.int64), axis=0)
    vox -= vox.min(0)
    n = min(len(vox), P)
    coords = np.zeros((P, 4), np.float32)
    coords[:n, :3] = vox[:n]
    return coords, n


@pytest.fixture(scope="module")
def topos():
    coords, n = _scan_coords()
    assert host_nonneg(coords)
    caps = UNetCapacities.for_points(P)
    args = (torch.from_numpy(coords), torch.tensor(n, dtype=torch.int32), caps)
    return build_unet_topology(*args, nonneg_coords=True), build_unet_topology(*args)


def _np_order(rb: np.ndarray) -> np.ndarray:
    """Rows by their bitmask of absent offsets, stable: the numpy
    `mask_row_order`."""
    keys = ((rb < 0).astype(np.int64) << np.arange(rb.shape[0])[:, None]).sum(0)
    return np.argsort(keys, kind="stable")


def _np_child(parent: np.ndarray, slot: np.ndarray, v_coarse: int) -> np.ndarray:
    table = np.full((8, v_coarse), -1, np.int64)
    for f in np.nonzero(parent >= 0)[0]:
        assert table[slot[f] & 7, parent[f]] < 0  # one child per slot
        table[slot[f] & 7, parent[f]] = f
    return table


def _np_tile_work(rb: np.ndarray, order=None) -> int:
    present = rb >= 0
    if order is not None:
        present = present[:, order]
    v = present.shape[1]
    tiles = [present[:, i : i + 64].any(1).sum() for i in range(0, v, 64)]
    return 64 * int(sum(tiles))


def test_topology_carries_orders_and_child_tables(topos):
    fast, counted = topos
    for l, (a, b) in enumerate(zip(fast.levels, counted.levels)):
        rb = a.rb_k3.numpy()
        np.testing.assert_array_equal(a.k3_order.numpy(), _np_order(rb))
        assert torch.equal(a.k3_order, b.k3_order)
        if l == 0:
            assert a.strided is None
            continue
        s = a.strided
        v_coarse = s.starts.shape[0] - 1
        assert s.child.shape == (1, 8, v_coarse) == b.strided.child.shape
        want = _np_child(s.parent.numpy(), s.slot.numpy(), v_coarse)
        np.testing.assert_array_equal(s.child[0].numpy(), want)
        assert torch.equal(s.child, b.strided.child)
        np.testing.assert_array_equal(s.child_order.numpy(), _np_order(want))
        assert torch.equal(s.child_order, b.strided.child_order)
        # every live fine row of the level below is one child
        assert int((s.child >= 0).sum()) == int(fast.levels[l - 1].num)


def _np_up(parent: np.ndarray, slot: np.ndarray) -> np.ndarray:
    table = np.full((8, parent.shape[0]), -1, np.int64)
    for f in np.nonzero(parent >= 0)[0]:
        table[slot[f] & 7, f] = parent[f]
    return table


def test_topology_carries_up_tables(topos):
    """Each level's up table: one slot per live fine row holding its
    parent, nothing for dead rows; its order groups the fine rows by slot
    (slot 7 first: the key is the mask of absent slots), dead rows last,
    table order within a slot."""
    fast, counted = topos
    for l in range(1, len(fast.levels)):
        s = fast.levels[l].strided
        parent, slot = s.parent.numpy(), s.slot.numpy()
        up = s.up.numpy()
        assert up.shape == (8, parent.shape[0]) and up.dtype == np.int32
        np.testing.assert_array_equal(up, _np_up(parent, slot))
        live = parent >= 0
        np.testing.assert_array_equal((up >= 0).sum(0), live.astype(np.int64))
        assert int(live.sum()) == int(fast.levels[l - 1].num)
        order = s.up_order.numpy()
        np.testing.assert_array_equal(order, _np_order(up))
        want = np.concatenate(
            [np.nonzero(live & ((slot & 7) == k))[0] for k in range(7, -1, -1)]
            + [np.nonzero(~live)[0]]
        )
        np.testing.assert_array_equal(order, want)
        assert torch.equal(s.up, counted.levels[l].strided.up)
        assert torch.equal(s.up_order, counted.levels[l].strided.up_order)
        assert torch.equal(s.up, tst.slot_up_table(s))


def test_tile_work_over_the_order(topos):
    """Tile work over present pairs, in table order and over the order,
    per level.  On this small scene (4721, 2974, 1676, 722 and 246
    voxels) [measured] the 3^3 tables run 2.1-3.2x the present pairs in
    table order and 2.3-2.7x over the order (0.84 of the work in all:
    the coarse tables are too small for the masks to group), the child
    tables 2.8-4.4x and 1.7-2.2x (0.46)."""
    topo = topos[0]
    k3, child = [0, 0], [0, 0]
    for l, lt in enumerate(topo.levels):
        tables = [(lt.rb_k3, lt.k3_order, k3)]
        if l:
            tables.append((lt.strided.child[0], lt.strided.child_order, child))
        for rb, order, acc in tables:
            pairs = int((rb >= 0).sum())
            flat, sorted_ = tsc.tile_work(rb), tsc.tile_work(rb, order)
            assert flat == _np_tile_work(rb.numpy())
            assert sorted_ == _np_tile_work(rb.numpy(), order.numpy())
            assert pairs <= sorted_ <= 1.1 * flat
            acc[0] += flat
            acc[1] += sorted_
    assert k3[1] < 0.9 * k3[0] and child[1] < 0.5 * child[0], (k3, child)


def test_wgmma_split_rule():
    """Parts per tile chain from the shapes alone: MinkUNet's level
    capacities at 131 072 points (2048, 1232, 452, 188, 72 tiles), the
    main path's (2048, 1232, 616, 248, 104: `chip_smoke.py`'s schedule)
    and FSA's at 262 144; at least 2 x 132 blocks where the tiles allow,
    at most 8 parts and at most one per 8 stages of the full chain (K x
    C_in chunks of 64, or of 32 where C_in is not a multiple of 64)."""
    mink = UNetCapacities.for_points(131072).voxels
    assert mink == (131072, 78848, 28928, 12032, 4608)
    assert [tsc.wgmma_splits(v, 27, 256) for v in mink] == [1, 1, 1, 2, 4]
    assert [tsc.wgmma_splits(v, 27, 32) for v in mink] == [1, 1, 1, 2, 3]
    assert [tsc.wgmma_splits(v, 8, 64) for v in mink] == [1, 1, 1, 1, 1]
    assert [tsc.wgmma_splits(v, 8, 128) for v in mink] == [1, 1, 1, 2, 2]
    path = (131072, 78848, 39424, 15872, 6656)
    assert [tsc.wgmma_splits(v, 27, 256) for v in path] == [1, 1, 1, 2, 3]
    assert [tsc.wgmma_splits(v, 27, 64) for v in path] == [1, 1, 1, 2, 3]
    fsa = UNetCapacities.for_points(262144).voxels
    assert [tsc.wgmma_splits(v, 27, 384) for v in fsa] == [1, 1, 1, 1, 2]
    assert tsc.wgmma_splits(1, 27, 384) == 8 and tsc.wgmma_splits(64 * 264, 27, 384) == 1
    for v in (1, 64, 4608, 12032, 16895, 16896, 28928):
        for k, c in ((27, 32), (27, 256), (8, 64), (9, 512)):
            s = tsc.wgmma_splits(v, k, c)
            assert 1 <= s <= tsc.WGMMA_MAX_SPLITS
            assert s == 1 or -(-v // 64) * (s - 1) < tsc.WGMMA_SPLIT_BLOCKS


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' launches recorded, not made: the route and its
    arguments are a pure function of the inputs."""
    calls = []
    monkeypatch.setattr(_build, "dispatch", lambda t: True)
    monkeypatch.setattr(_build, "launch", lambda name, counters, *a: calls.append((name, counters, a)))
    return calls


def test_routes_hand_their_launch_the_split_and_order(recorded, topos):
    lt = topos[0].levels[3]
    v = lt.rb_k3.shape[1]
    x = torch.ones(v, 64, dtype=torch.bfloat16)
    tsc.sparse_conv_k3(x, torch.ones(27, 64, 128, dtype=torch.bfloat16), lt.rb_k3, order=lt.k3_order)
    tsc.sparse_conv_k3(x.float(), torch.ones(27, 64, 128), lt.rb_k3)
    x4 = torch.ones(v, 4, dtype=torch.bfloat16)
    out4 = tsc.sparse_conv_k3(x4, torch.ones(27, 4, 51, dtype=torch.bfloat16), lt.rb_k3)
    name, counters, a = recorded[0]
    assert (name, counters) == ("taseg_sparse_conv_wgmma", ("sparse_conv_k3", "sparse_conv_k3_wgmma"))
    assert a[3] == lt.k3_order.data_ptr()  # the topology's order, not a new one
    assert a[-6:] == (v, 64, 128, 27, tsc.wgmma_splits(v, 27, 64), 128)  # ..., splits, output columns
    assert recorded[1][:2] == ("taseg_sparse_conv_k3", ("sparse_conv_k3",))  # a direct f32 call
    # a 4 -> 51 conv on the same tile at C_in padded to 8 and C_out to
    # 56, writing its 51 output columns
    assert recorded[2][:2] == ("taseg_sparse_conv_wgmma", ("sparse_conv_k3", "sparse_conv_k3_wgmma"))
    assert recorded[2][2][-6:] == (v, 8, 56, 27, tsc.wgmma_splits(v, 27, 8), 51)
    assert out4.shape == (v, 51) and out4.is_contiguous()

    s = lt.strided
    fine = s.parent.shape[0]
    recorded.clear()
    for dt in (torch.bfloat16, torch.float32):
        xf = torch.ones(fine, 32, dtype=dt)
        tst.downsample_conv_apply(xf, torch.ones(8, 32, 32, dtype=dt), s, dgrad=True)
    (n0, c0, a0), (n1, c1, a1) = recorded
    assert (n0, c0) == ("taseg_strided_down_wgmma", (
        "strided_down", "strided_down_dgrad", "strided_down_wgmma", "strided_down_dgrad_wgmma"))
    assert (n1, c1) == ("taseg_sparse_conv_k_tf32", (
        "strided_down", "strided_down_dgrad", "strided_down_tf32", "strided_down_dgrad_tf32"))
    v_coarse = s.starts.shape[0] - 1
    assert a0[2] == s.child.data_ptr() and a0[3] == s.child_order.data_ptr()
    assert a0[-6:] == (v_coarse, 32, 32, 8, tsc.wgmma_splits(v_coarse, 8, 32), 32)
    assert a1[-6:] == (v_coarse, 32, 32, 8, tst.k3_tf32_splits(v_coarse, 32), 32) == (v_coarse, 32, 32, 8, 1, 32)

    recorded.clear()
    two = tst.StridedTables(s.parent, s.slot, s.perm, s.starts, child=torch.cat([s.child, s.child]))
    for dt, c in ((torch.bfloat16, 32), (torch.float32, 32), (torch.bfloat16, 12)):
        tst.downsample_conv_apply(torch.ones(fine, c, dtype=dt), torch.ones(8, c, c, dtype=dt), two)
    assert [r[:2] for r in recorded] == [
        ("taseg_strided_down_mma", ("strided_down", "strided_down_rounds")),
        ("taseg_strided_down", ("strided_down", "strided_down_rounds")),
        ("taseg_strided_down_mma", ("strided_down", "strided_down_rounds")),
    ]
    assert recorded[2][2][-3:] == (v_coarse, 16, 16)  # 12 channels padded to 16


def test_up_routes_hand_their_launch_the_table_and_order(recorded, topos):
    """K3-up and its input-gradient use: bf16 widths in 8s on K2's wgmma
    tile over the level's up table and order (its own C entry), f32
    widths in 4s on K2 at K's 3xTF32 tile over the same, ragged bf16
    widths on the wgmma tile, padded to a multiple of 8; a table without the topology's up table
    gets one built (no order: the launch builds it)."""
    s = topos[0].levels[3].strided
    fine, v_coarse = s.parent.shape[0], s.starts.shape[0] - 1
    for dt, c in ((torch.bfloat16, 64), (torch.float32, 64), (torch.bfloat16, 12)):
        tst.upsample_conv_apply(torch.ones(v_coarse, c, dtype=dt), torch.ones(8, c, 32, dtype=dt), s, dgrad=True)
    (n0, c0, a0), (n1, c1, a1), (n2, c2, a2) = recorded
    assert (n0, c0) == ("taseg_strided_up_wgmma", (
        "strided_up", "strided_up_dgrad", "strided_up_wgmma", "strided_up_dgrad_wgmma"))
    assert (n1, c1) == ("taseg_sparse_conv_k_tf32", (
        "strided_up", "strided_up_dgrad", "strided_up_tf32", "strided_up_dgrad_tf32"))
    assert (n2, c2) == (n0, c0)
    assert a2[-6:] == (fine, 16, 32, 8, tsc.wgmma_splits(fine, 8, 16), 32)  # 12 channels padded to 16
    for a in (a0, a1, a2):
        assert a[2] == s.up.data_ptr() and a[3] == s.up_order.data_ptr()
    assert a0[-6:] == (fine, 64, 32, 8, tsc.wgmma_splits(fine, 8, 64), 32)
    assert a1[-6:] == (fine, 64, 32, 8, tst.k3_tf32_splits(fine, 64), 32)
    recorded.clear()
    bare = tst.StridedTables(s.parent, s.slot, s.perm, s.starts)
    tst.upsample_conv_apply(torch.ones(v_coarse, 64, dtype=torch.bfloat16),
                            torch.ones(8, 64, 32, dtype=torch.bfloat16), bare)
    assert recorded[0][0] == "taseg_strided_up_wgmma"


def _level_pair(negative: bool):
    """A fine level and its 2x-coarser level, JAX and port views: voxels
    in [0, 14)^3 x 2 batches, or in [-7, 7)^3 (cells around 0 fold
    several children of one slot: several rounds)."""
    rng = np.random.default_rng(7)
    coords = np.concatenate(
        [rng.integers(0, 14, size=(600, 3)) - (7 if negative else 0), rng.integers(0, 2, size=(600, 1))], 1
    ).astype(np.int32)
    valid = np.ones(len(coords), bool)
    jb = j_bounds(jnp.asarray(coords), jnp.asarray(valid))
    ju, jn, _, _ = j_unique(jnp.asarray(coords), jnp.asarray(valid), jb, 768)
    _, _, jpar, jcnt, jperm = j_spdown(ju, jn, 2, 1, jb, 512, return_inverse=True)
    tb = tc.compute_bounds(torch.from_numpy(coords), torch.from_numpy(valid))
    tu, tn, _, _ = tj.unique_coords(torch.from_numpy(coords), torch.from_numpy(valid), tb, 768)
    _, _, tpar, tcnt, tperm = tr.spdownsample(tu, tn, 2, 1, tb, 512, return_inverse=True)
    ttab = tst.build_strided_tables(tu, tn, tpar, tcnt, tperm, 1)
    return rng, j_strided(ju, jn, jpar, jcnt, jperm, 1), ttab


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("c_in,c_out", [(32, 32), (128, 128), (96, 128)])
def test_down_through_child_table_matches_jax(negative, c_in, c_out):
    rng, jtab, ttab = _level_pair(negative)
    child = tst.slot_child_table(ttab)
    assert (child.shape[0] > 1) == negative, child.shape
    if not negative:
        assert torch.equal(child, tst.slot_child_table(ttab, rounds=1))
    v_fine, v_coarse = ttab.parent.shape[0], child.shape[2]
    x = rng.normal(size=(v_fine, c_in)).astype(np.float32)
    w = (rng.normal(size=(8, c_in, c_out)) / np.sqrt(8 * c_in)).astype(np.float32)
    g = rng.normal(size=(v_coarse, c_out)).astype(np.float32)

    want = np.asarray(J_DOWN(jnp.asarray(x), jnp.asarray(w), jtab))
    got = tst.downsample_conv_slot_plain(torch.from_numpy(x), torch.from_numpy(w), child).numpy()
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= 1e-4 * scale

    # the up conv C_out -> C_in: its input gradient is down(g', W^T)
    gf = rng.normal(size=(v_fine, c_in)).astype(np.float32)
    wu = np.ascontiguousarray(w.transpose(0, 2, 1))  # (8, C_out, C_in)
    want = np.asarray(J_UP_VJP(jnp.asarray(g), jnp.asarray(wu), jtab, jnp.asarray(gf)))
    w_t = torch.from_numpy(wu).transpose(1, 2).contiguous()
    got = tst.downsample_conv_slot_plain(torch.from_numpy(gf), w_t, child).numpy()
    scale = max(np.abs(want).max(), 1e-6)
    assert np.abs(got - want).max() <= 1e-4 * scale


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("c_in,c_out", [(256, 256), (256, 128), (128, 96), (96, 96)])
def test_up_through_up_table_matches_jax(negative, c_in, c_out):
    """K3-up over the up table at the deconvs' widths: the forward against
    JAX's `upsample_conv_apply`; as the down conv's input gradient (its
    widths swapped, on W^T) against `jax.vjp(downsample_conv_apply)`,
    JAX's `_down_bwd` d_feats."""
    rng, jtab, ttab = _level_pair(negative)
    up = tst.slot_up_table(ttab)
    v_fine, v_coarse = ttab.parent.shape[0], ttab.starts.shape[0] - 1
    x = rng.normal(size=(v_coarse, c_in)).astype(np.float32)
    w = (rng.normal(size=(8, c_in, c_out)) / np.sqrt(c_in)).astype(np.float32)
    want = np.asarray(J_UP(jnp.asarray(x), jnp.asarray(w), jtab))
    got = tst.upsample_conv_up_plain(torch.from_numpy(x), torch.from_numpy(w), up).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-6)
    assert torch.equal(
        torch.from_numpy(got), tst.upsample_conv_plain(torch.from_numpy(x), torch.from_numpy(w), ttab)
    )

    # the down conv C_out -> C_in: its input gradient is up(g, W^T)
    xf = rng.normal(size=(v_fine, c_out)).astype(np.float32)
    wd = np.ascontiguousarray(w.transpose(0, 2, 1))  # (8, C_out, C_in)
    want = np.asarray(J_DOWN_VJP(jnp.asarray(xf), jnp.asarray(wd), jtab, jnp.asarray(x)))
    w_t = torch.from_numpy(wd).transpose(1, 2).contiguous()
    got = tst.upsample_conv_up_plain(torch.from_numpy(x), w_t, up).numpy()
    assert np.abs(got - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-6)
