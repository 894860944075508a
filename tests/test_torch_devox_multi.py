"""K7's multi-scale entry (`voxelize.devoxelize_multi`) on the CPU, where
it runs its plain version: the sum is bit-equal to the head's former
sequence of three devoxelizations, casts and adds, the cat to
`torch.cat` of the three calls; the stacked pair table of the train
topology is integer-equal to one `build_segment_tables` over the three
scales' ids with row offsets, and K6 over it (one call on the card)
agrees with the three separate calls within 1e-5 of the largest sum of
|terms| (the mean-centred cumsum of the plain K6 rounds differently over
the longer stacked rows; the backward's CPU path runs the three calls);
the head against JAX's
`_TriScaleHead` on the same voxel features and JAX's own tables, within
`test_torch_minkunet.py`'s f32 tolerance (rtol 1e-3, atol 1e-3; the
head alone agrees to ~1e-6).  ~10 s on one worker.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.data.voxel_dataset import VoxelPipeline as JPipeline
from taseg_tpu.data.voxel_dataset import collate_shard as j_collate
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models import build_unet_topology as j_topology
from taseg_tpu.models.voxel.minkunet import _TriScaleHead as JHead
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.models.voxel.backbone_context import (
    UNetCapacities,
    build_unet_topology,
    head_tables,
)
from taseg_tpu_torch.models.voxel.minkunet import _TriScaleHead
from taseg_tpu_torch.ops import voxelize as tvx

CAP = 2048
SCHEDULE = (1.0,) * 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(31)
    scans = []
    for _ in range(2):
        pts, labels = synthetic_scan(rng, 900)
        ring = np.zeros((len(pts), 1), np.float32)
        scans.append({"xyzret": np.concatenate([pts, ring], 1), "labels": labels})
    arrays = j_collate([JPipeline(0.05, training=False)(s) for s in scans], CAP)
    topo = build_unet_topology(
        torch.from_numpy(arrays["point_coords"]), torch.tensor(int(arrays["num_points"][0])),
        UNetCapacities.for_points(CAP, schedule=SCHEDULE), devox_pairs=True,
        assume_sorted_points=True,
    )
    return arrays, topo, rng


def _feats(topo, rng, widths, dtype):
    rows = [t.tables.counts.shape[0] if isinstance(t, tvx.IdentityDevoxTable)
            else t.pairs.counts.shape[0] for t in head_tables(topo.devox)]
    return [
        torch.from_numpy(rng.normal(0, 1, (v, c)).astype(np.float32)).to(dtype)
        for v, c in zip(rows, widths)
    ]


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multi_equals_the_per_scale_sequence(scene, dtype):
    """Sum: ((f32(d0) + f32(d1)) + f32(d2)) + bias, bit for bit; cat:
    torch.cat of the three devoxelizations, bit for bit."""
    _, topo, rng = scene
    tables = head_tables(topo.devox)
    zs = _feats(topo, rng, (20, 20, 20), dtype)
    bias = torch.from_numpy(rng.normal(0, 1, 20).astype(np.float32))
    want = None
    for z, t in zip(zs, tables):
        c = tvx.devoxelize(z, t).float()
        want = c if want is None else want + c
    want = want + bias
    got = tvx.devoxelize_multi(zs, tables, bias=bias)
    assert got.dtype == torch.float32 and torch.equal(_bits(got), _bits(want))
    xs = _feats(topo, rng, (32, 16, 12), dtype)
    got = tvx.devoxelize_multi(xs, tables)
    want = torch.cat([tvx.devoxelize(x, t) for x, t in zip(xs, tables)], dim=-1)
    assert got.dtype == dtype and torch.equal(_bits(got), _bits(want))
    with pytest.raises(ValueError):
        tvx.devoxelize_multi(xs, tables, bias=bias)  # a sum needs equal widths


def test_stacked_table_is_one_segment_table(scene):
    """`devox_head` equals `build_segment_tables` over the three scales'
    corner ids with row offsets (the identity's inverse last), exactly."""
    _, topo, _ = scene
    t16, t4, t1 = head_tables(topo.devox)
    v16, v4, v1 = (t16.pairs.counts.shape[0], t4.pairs.counts.shape[0], t1.tables.counts.shape[0])
    shift = lambda ids, off: torch.where(ids >= 0, ids + off, -1)
    ids = torch.cat([
        t16.idx.reshape(-1), shift(t4.idx.reshape(-1), v16), shift(t1.inverse, v16 + v4),
    ])
    want = tvx.build_segment_tables(ids, v16 + v4 + v1)
    got = topo.devox_head
    assert got.rows == (v16, v4, v1)
    for a, b in zip(got.tables, want):
        assert torch.equal(a, b)
    p = t1.inverse.shape[0]
    w = torch.cat([t16.weights.reshape(-1), t4.weights.reshape(-1), torch.ones(p)])
    assert torch.equal(got.weights, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_k6_matches_three_calls(scene, dtype):
    """K6 over the stacked table (its plain version here) against the
    three separate calls, within 1e-5 of the largest sum of |terms|; and
    the sum's backward gives each scale the gradient of the separate
    calls and the bias the column sums (on the CPU it runs them)."""
    _, topo, rng = scene
    tables = head_tables(topo.devox)
    g = torch.from_numpy(rng.normal(0, 1, (tables[2].inverse.shape[0], 20)).astype(np.float32))
    gb = g.to(dtype)
    st = topo.devox_head
    got = tvx.segment_sum(gb, st.tables, st.weights).split(list(st.rows))
    for x, t in zip(got, tables):
        pt, w = tvx._pair_tables(t)
        want = tvx.segment_sum(gb, pt, w)
        ref = tvx.segment_sum_plain(gb.float().abs(), pt, w.abs()).max()
        assert (x - want).abs().max() <= 1e-5 * ref
    zs = [z.requires_grad_() for z in _feats(topo, rng, (20,) * 3, dtype)]
    bias = torch.zeros(20, requires_grad=True)
    tvx.devoxelize_multi(zs, tables, bias=bias, stacked=st).backward(g)
    assert torch.equal(bias.grad, g.sum(0))
    for z, t in zip(zs, tables):
        pt, w = tvx._pair_tables(t)
        want = tvx.segment_sum(gb, pt, None if isinstance(t, tvx.IdentityDevoxTable) else w)
        assert z.grad.dtype == dtype and torch.equal(z.grad, want.to(dtype))


def test_head_matches_jax(scene):
    """The port's head (one multi-scale sum) against JAX's `_TriScaleHead`
    on the same voxel features and kernel, each over its own package's
    topology of the same points."""
    arrays, topo, rng = scene
    caps = JCaps.for_points(CAP, schedule=SCHEDULE)
    jt = jax.jit(lambda c, n: j_topology(c, n, caps, devox_pairs=False, assume_sorted_points=True))(
        jnp.asarray(arrays["point_coords"]), jnp.int32(arrays["num_points"][0])
    )
    xs = _feats(topo, rng, (32, 16, 12), torch.float32)
    kernel = rng.normal(0, 0.3, (60, 20)).astype(np.float32)
    bias = rng.normal(0, 0.1, 20).astype(np.float32)
    head = _TriScaleHead((32, 16, 12), 20, device="cpu")
    with torch.no_grad():
        head.kernel.copy_(torch.from_numpy(kernel))
        head.bias.copy_(torch.from_numpy(bias))
        got = head(xs, head_tables(topo.devox)).numpy()
    jx = [jnp.asarray(x.numpy()) for x in xs]
    want = np.asarray(JHead(20).apply(
        {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}},
        jx, (jt.devox[16], jt.devox[4], jt.devox[1]),
    ))
    n = int(arrays["num_points"][0])
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-3, atol=1e-3)
