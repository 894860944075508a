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
from taseg_tpu.ops import unique_coords as j_unique
from taseg_tpu_torch.models.voxel.backbone_context import (
    UNetCapacities,
    build_unet_topology,
)
from taseg_tpu_torch.ops import coords as tc
from taseg_tpu_torch.ops import join as tj
from taseg_tpu_torch.ops import rulebook as tr


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
