"""The port's rulebooks and UNet topology against the JAX package: every
integer equal (perms as sets within their equal-key runs), devox weights
within f32 rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models import build_unet_topology as j_topology
from taseg_tpu.ops import build_rulebook_k3 as j_rb_k3
from taseg_tpu.ops import compute_bounds as j_bounds
from taseg_tpu.ops import flip_rulebook as j_flip
from taseg_tpu.ops import unique_coords as j_unique
from taseg_tpu_torch.models.voxel.backbone_context import (
    UNetCapacities,
    build_unet_topology,
)
from taseg_tpu_torch.ops import coords as tc
from taseg_tpu_torch.ops import f3conv as tf3
from taseg_tpu_torch.ops import join as tj
from taseg_tpu_torch.ops import rulebook as tr
from taseg_tpu_torch.ops import strided_conv as tst


def random_coords(rng, n, lo, hi, batches=3):
    xyz = rng.integers(lo, hi, size=(n, 3))
    b = rng.integers(0, batches, size=(n, 1))
    return np.concatenate([xyz, b], axis=1).astype(np.int32)


@pytest.mark.parametrize("seed,stride", [(3, 1), (4, 2), (5, 4), (6, 16)])
def test_rulebook_k3_matches_dense_and_jax(seed, stride):
    """Negative coords, two batches, padding rows, dense and sparse
    regions (the cases of `test_grouped_k3_rulebook_matches_dense_build`)."""
    rng = np.random.default_rng(seed)
    n, cap = 700, 1024
    dense = random_coords(rng, n // 2, -4, 4) * stride
    sparse = random_coords(rng, n - n // 2, -30, 30) * stride
    coords = np.concatenate([dense, sparse])
    coords[:, 3] = np.abs(coords[:, 3]) // stride % 2
    valid = rng.random(n) > 0.05
    jb = j_bounds(jnp.asarray(coords), jnp.asarray(valid))
    ju, jn, _, _ = j_unique(jnp.asarray(coords), jnp.asarray(valid), jb, cap)
    want = np.asarray(j_rb_k3(ju, jn, stride, jb))

    tb = tc.compute_bounds(torch.from_numpy(coords), torch.from_numpy(valid))
    tu, tn, _, _ = tj.unique_coords(torch.from_numpy(coords), torch.from_numpy(valid), tb, cap)
    got = tr.build_rulebook_k3(tu, tn, stride, tb).numpy()
    dense_rb = tr.build_rulebook(
        tu, tn, tu, tn, tr.kernel_offsets(3, stride=stride), tb
    ).numpy()
    np.testing.assert_array_equal(got, dense_rb)
    np.testing.assert_array_equal(got, want)


def _scene(seed, cap=2048, n=1500, span=40.0):
    """Deduped integer points as `tests/test_minkunet.py` builds them."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((cap, 4), np.float32)
    xyz = np.floor(rng.uniform(0, span, size=(n, 3))).astype(np.float32)
    b = rng.integers(0, 2, size=(n, 1)).astype(np.float32)
    rows = np.unique(np.concatenate([xyz, b], 1), axis=0)
    pts[: len(rows)] = rows
    return pts, len(rows)


def _sorted_scene(seed):
    """A key-sorted shard from the port's host pipeline (the serving
    path's `assume_sorted_points` input)."""
    from taseg_tpu_torch.data.synthetic import synthetic_scan
    from taseg_tpu_torch.data.voxel_dataset import VoxelPipeline, collate_shard

    rng = np.random.default_rng(seed)
    pipe = VoxelPipeline(voxel_size=0.2, training=False)
    samples = []
    for _ in range(2):
        pts, labels = synthetic_scan(rng, 2500)
        ring = np.zeros((len(pts), 1), np.float32)
        samples.append(pipe({"xyzret": np.concatenate([pts, ring], 1), "labels": labels}))
    arrays = collate_shard(samples, 6144)
    return arrays["point_coords"], int(arrays["num_points"][0])


def _runs_equal_as_sets(a, b, starts, what):
    for u in range(len(starts) - 1):
        lo, hi = starts[u], starts[u + 1]
        if hi > lo:
            assert set(a[lo:hi]) == set(b[lo:hi]), f"{what} run {u}"


@pytest.mark.parametrize("scene", ["random", "pipeline_sorted"])
def test_unet_topology_matches_jax(scene):
    if scene == "random":
        pts, n = _scene(11)
        sorted_pts = False
    else:
        pts, n = _sorted_scene(3)
        sorted_pts = True
    cap = pts.shape[0]
    jcaps = JCaps.for_points(cap)
    jt = jax.jit(
        lambda c, m: j_topology(c, m, jcaps, devox_pairs=False, assume_sorted_points=sorted_pts)
    )(jnp.asarray(pts), jnp.int32(n))
    tt = build_unet_topology(
        torch.from_numpy(pts), torch.tensor(n, dtype=torch.int32),
        UNetCapacities.for_points(cap), assume_sorted_points=sorted_pts,
    )
    assert UNetCapacities.for_points(cap).voxels == jcaps.voxels
    np.testing.assert_array_equal(tt.bounds.origin.numpy(), np.asarray(jt.bounds.origin))
    np.testing.assert_array_equal(tt.bounds.extent.numpy(), np.asarray(jt.bounds.extent))
    np.testing.assert_array_equal(tt.point_inverse.numpy(), np.asarray(jt.point_inverse))
    jst = jt.point_tables
    np.testing.assert_array_equal(tt.point_tables.starts.numpy(), np.asarray(jst.starts))
    np.testing.assert_array_equal(tt.point_tables.counts.numpy(), np.asarray(jst.counts))
    _runs_equal_as_sets(
        np.asarray(jst.perm), tt.point_tables.perm.numpy(), np.asarray(jst.starts), "segments"
    )
    for l, (a, b) in enumerate(zip(jt.levels, tt.levels)):
        assert int(a.num) == int(b.num), l
        np.testing.assert_array_equal(b.coords.numpy(), np.asarray(a.coords), err_msg=f"L{l}")
        np.testing.assert_array_equal(b.rb_k3.numpy(), np.asarray(a.rb_k3), err_msg=f"L{l}")
        if l == 0:
            continue
        for f in ("parent", "slot", "starts"):
            np.testing.assert_array_equal(
                getattr(b.strided, f).numpy(), np.asarray(getattr(a.strided, f)),
                err_msg=f"L{l} {f}",
            )
        _runs_equal_as_sets(
            np.asarray(a.strided.perm), b.strided.perm.numpy(),
            np.asarray(a.strided.starts), f"L{l} perm",
        )
    np.testing.assert_array_equal(
        tt.devox[1].inverse.numpy(), np.asarray(jt.devox[1].inverse)
    )
    for s in (4, 16):
        np.testing.assert_array_equal(tt.devox[s].idx.numpy(), np.asarray(jt.devox[s].idx))
        np.testing.assert_allclose(
            tt.devox[s].weights.numpy(), np.asarray(jt.devox[s].weights), rtol=0, atol=1e-6
        )


def test_capacities_match_jax():
    for pts in (2048, 131072, 1_000_000):
        assert UNetCapacities.for_points(pts) == UNetCapacities(
            **vars(JCaps.for_points(pts))
        )
    nums = (90000, 51000, 23000, 9000, 3100)
    assert UNetCapacities.fit(131072, nums).voxels == JCaps.fit(131072, nums).voxels


def _want_pairs(rb_bwd):
    """The present (i, rb_bwd[k, i]) pairs, offset by offset in row
    order, and the start table."""
    pairs, starts = [], [0]
    for k in range(rb_bwd.shape[0]):
        rows = np.nonzero(rb_bwd[k] >= 0)[0]
        pairs.append(np.stack([rows, rb_bwd[k, rows]], 1))
        starts.append(starts[-1] + len(rows))
    return np.concatenate(pairs).astype(np.int32), np.asarray(starts, np.int32)


def _planar_scene(seed):
    """Integer points on one z plane: every offset with dz != 0 is empty
    at every level."""
    pts, n = _scene(seed)
    pts[:n, 2] = 5.0
    rows = np.unique(pts[:n], axis=0)
    pts[:] = 0
    pts[: len(rows)] = rows
    return pts, len(rows)


@pytest.mark.parametrize("scene", ["random", "pipeline_sorted", "planar"])
def test_train_topology_pair_lists(scene):
    """K4's pair lists, built once per level by the train topology: the
    present pairs of the flipped rulebook (JAX `flip_rulebook` of the JAX
    level's rulebook), per offset in row order, with their start table,
    also where offsets have no pairs (the planar scene).  Inference
    topologies build none."""
    scenes = {"random": lambda: _scene(11), "pipeline_sorted": lambda: _sorted_scene(3), "planar": lambda: _planar_scene(12)}
    pts, n = scenes[scene]()
    cap = pts.shape[0]
    jcaps = JCaps.for_points(cap)
    jt = jax.jit(lambda c, m: j_topology(c, m, jcaps, devox_pairs=False))(jnp.asarray(pts), jnp.int32(n))
    args = (torch.from_numpy(pts), torch.tensor(n, dtype=torch.int32), UNetCapacities.for_points(cap))
    tt = build_unet_topology(*args, devox_pairs=True)
    empty = 0
    for l, (a, b) in enumerate(zip(jt.levels, tt.levels)):
        want_rb = np.asarray(j_flip(a.rb_k3))
        np.testing.assert_array_equal(b.rb_k3_bwd.numpy(), want_rb, err_msg=f"L{l}")
        pairs, starts = _want_pairs(want_rb)
        np.testing.assert_array_equal(b.k3_pairs.starts.numpy(), starts, err_msg=f"L{l}")
        assert b.k3_pairs.pairs.shape == (27 * want_rb.shape[1], 2)
        np.testing.assert_array_equal(b.k3_pairs.pairs[: starts[-1]].numpy(), pairs, err_msg=f"L{l}")
        empty += int((np.diff(starts) == 0).sum())
    assert (empty >= 18 * len(tt.levels)) == (scene == "planar")
    inference = build_unet_topology(*args)
    assert all(l.k3_pairs is None and l.rb_k3_bwd is None for l in inference.levels)


def test_pair_lists_of_a_lone_voxel():
    """One voxel: only the centre offset has a pair; the other 26 lists
    are empty and the padding rows are not pairs."""
    rb = torch.full((27, 4), -1, dtype=torch.int32)
    rb[13, 0] = 0
    got = tf3.k3_pair_lists(rb)
    assert got.starts.tolist() == [0] * 14 + [1] * 14
    assert got.pairs[:1].tolist() == [[0, 0]]


def _want_slot_pairs(parent, slot):
    """The (f, parent f) pairs of the live fine rows, slot by slot in row
    order, and the (9,) start table."""
    pairs, starts = [], [0]
    for s in range(8):
        rows = np.nonzero((parent >= 0) & ((slot & 7) == s))[0]
        pairs.append(np.stack([rows, parent[rows]], 1))
        starts.append(starts[-1] + len(rows))
    return np.concatenate(pairs).astype(np.int32), np.asarray(starts, np.int32)


def _negative_scene(seed):
    """`_scene` moved to coordinates around 0: truncating division folds
    -1, 0 and 1 into one coarse cell, whose children repeat slots."""
    pts, n = _scene(seed, span=24.0)
    pts[:n, :3] -= 12.0
    return pts, n


@pytest.mark.parametrize("scene", ["random", "pipeline_sorted", "negative"])
def test_train_topology_slot_pair_lists(scene):
    """K5's per-slot pair lists, built once per level by the train
    topology: they partition the live fine rows of the JAX level's parent
    relation, slot by slot in row order, with their start table, also
    where cells hold two children of one slot (the negative scene).
    Inference topologies build none."""
    scenes = {"random": lambda: _scene(11), "pipeline_sorted": lambda: _sorted_scene(3), "negative": lambda: _negative_scene(13)}
    pts, n = scenes[scene]()
    cap = pts.shape[0]
    jcaps = JCaps.for_points(cap)
    jt = jax.jit(lambda c, m: j_topology(c, m, jcaps, devox_pairs=False))(jnp.asarray(pts), jnp.int32(n))
    args = (torch.from_numpy(pts), torch.tensor(n, dtype=torch.int32), UNetCapacities.for_points(cap))
    tt = build_unet_topology(*args, devox_pairs=True)
    rounds = []
    for l in range(1, len(tt.levels)):
        a, b = jt.levels[l].strided, tt.levels[l].strided
        parent, slot = np.asarray(a.parent), np.asarray(a.slot)
        pairs, starts = _want_slot_pairs(parent, slot)
        assert 0 < starts[-1] == (parent >= 0).sum() <= int(tt.levels[l - 1].num)
        np.testing.assert_array_equal(b.pairs.starts.numpy(), starts, err_msg=f"L{l}")
        assert b.pairs.pairs.shape == (parent.shape[0], 2)
        np.testing.assert_array_equal(b.pairs.pairs[: starts[-1]].numpy(), pairs, err_msg=f"L{l}")
        rounds.append(tst.slot_child_table(b).shape[0])
    assert (max(rounds) > 1) == (scene == "negative"), rounds
    inference = build_unet_topology(*args)
    assert all(l.strided.pairs is None for l in inference.levels[1:])


def test_slot_pair_lists_of_a_lone_voxel():
    """One live fine row: only its slot's list holds a pair; padding rows
    (parent -1) are no pairs."""
    tab = tst.StridedTables(
        parent=torch.tensor([0, -1, -1], dtype=torch.int32),
        slot=torch.tensor([5, 0, 3], dtype=torch.int32),
        perm=torch.arange(3, dtype=torch.int32),
        starts=torch.tensor([0, 1], dtype=torch.int32),
    )
    got = tst.slot_pair_lists(tab)
    assert got.starts.tolist() == [0] * 6 + [1] * 3
    assert got.pairs.shape == (3, 2) and got.pairs[:1].tolist() == [[0, 0]]
