"""Cylinder3D's ops in the port against the JAX package, on the CPU: the
kernel offsets of even volumes and the anisotropic `spdownsample`, every
rulebook of the cylinder topology (integer-equal), the conv over K
offsets (the plain versions of K2 and K4 at K = 3, 4, 8 and 9, with
V_in != V_out and the transposed direction) against `sparse_conv_apply`
and `jax.vjp` of it, and at K = 27 (the 3^3 head) against
`f3_conv_apply`, `segment_max` and its gradient against
`jax.ops.segment_max` and `jax.grad` (ties, and Cylinder3D's large -inf
dummy segment of padding rows), and the CylinderPipeline against JAX's,
tied majority labels included.

The scene: 1500 uniform points in [-30, 30]^3 on the 64 x 64 x 16 polar
grid (JAX's own `tests/test_cylinder.py` scene), 2048 rows; JAX's
topology jitted once for the module.  Tolerances (f32, measured values in
brackets): the conv forward, d_feats and d_W within 1e-5 of their
largest sum of |terms| [<= 1.1e-7, 1.3e-7 and 1.4e-7 of it]; the segment
max and its gradient exact.  About 23 s on one worker (`--durations`), 3 s of
it JAX compiling the topology and 3 s the head's `f3_conv_apply` case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.data.augment import AugParams as JAug
from taseg_tpu.data.cylinder_dataset import CylinderPipeline as JPipeline
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models.voxel.cylinder3d import build_cylinder_topology as j_topology
from taseg_tpu.ops import rulebook as jrb
from taseg_tpu.ops.f3conv import f3_conv_apply
from taseg_tpu.ops.sparse_conv import sparse_conv_apply
from taseg_tpu_torch.data.augment import AugParams
from taseg_tpu_torch.data.cylinder_dataset import CylinderPipeline, majority_labels
from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities
from taseg_tpu_torch.models.voxel.cylinder3d import CYL_STRIDES, build_cylinder_topology, pool_step
from taseg_tpu_torch.ops import _build
from taseg_tpu_torch.ops import f3conv as tf3
from taseg_tpu_torch.ops import rulebook as trb
from taseg_tpu_torch.ops import sparse_conv as tsc
from taseg_tpu_torch.ops.voxelize import segment_max

CAP = 2048
GRID = (64, 64, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(seed=1, n=1500):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30, 30, (n, 4)).astype(np.float32)
    labels = rng.integers(0, 20, n).astype(np.int32)
    s = CylinderPipeline(grid=GRID, training=False)({"xyzret": pts, "labels": labels})
    coords = np.zeros((CAP, 4), np.float32)
    coords[: len(s.coords), :3] = s.coords
    return coords, len(s.coords)


@pytest.fixture(scope="module")
def topo():
    coords, n = _rows()
    caps = JCaps.for_points(CAP)
    want = jax.jit(lambda c, k: j_topology(c, k, caps))(jnp.asarray(coords), jnp.int32(n))
    want = jax.tree_util.tree_map(np.asarray, want)
    got = build_cylinder_topology(
        torch.from_numpy(coords), torch.tensor(n, dtype=torch.int32),
        UNetCapacities.for_points(CAP), train=True,
    )
    return got, want


@pytest.mark.parametrize("ks", [(2, 2, 2), (2, 2, 1), (1, 3, 3), (3, 1, 3), (3, 1, 1), (1, 1, 3), 3])
@pytest.mark.parametrize("stride", CYL_STRIDES)
def test_kernel_offsets_match_jax(ks, stride):
    """torchsparse's order for every kernel shape and tensor stride of
    the cylinder topology: z fastest for the even volumes."""
    got = trb.kernel_offsets(ks, stride=stride)
    np.testing.assert_array_equal(got, jrb.kernel_offsets(ks, stride=stride))
    if ks == (2, 2, 1):
        np.testing.assert_array_equal(got // np.asarray(stride), [[0, 0, 0], [0, 1, 0], [1, 0, 0], [1, 1, 0]])


def test_pool_steps():
    assert [pool_step(l) for l in range(1, 5)] == [(2, 2, 2), (2, 2, 2), (2, 2, 1), (2, 2, 1)]


@pytest.mark.parametrize("l", [1, 2, 3, 4])
def test_anisotropic_spdownsample_matches_jax(topo, l):
    """`spdownsample` at the step into level l and the tensor stride of
    level l - 1, from the level's JAX coords: the same coarse set."""
    _, want = topo
    prev = want.levels[l - 1]
    bounds = jax.tree_util.tree_map(jnp.asarray, want.bounds)
    jc, jn = jrb.spdownsample(
        jnp.asarray(prev.coords), jnp.asarray(prev.num), pool_step(l), CYL_STRIDES[l - 1],
        bounds, want.levels[l].coords.shape[0],
    )
    tb = trb.GridBounds(torch.from_numpy(want.bounds.origin), torch.from_numpy(want.bounds.extent))
    tc, tn = trb.spdownsample(
        torch.from_numpy(prev.coords), torch.from_numpy(prev.num), pool_step(l),
        CYL_STRIDES[l - 1], tb, want.levels[l].coords.shape[0],
    )
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tn) == int(jn)


@pytest.mark.parametrize("l", [0, 1, 2, 3, 4])
def test_level_tables_integer_equal(topo, l):
    """Coords, count, both asymmetric rulebooks, and (l > 0) the pooling
    table (K = 8 or 4) and its reverse, integer-equal to JAX's."""
    got, want = topo
    g, w = got.levels[l], want.levels[l]
    np.testing.assert_array_equal(g.coords.numpy(), w.coords)
    assert int(g.num) == int(w.num) > 0
    for a, b in zip(g.rb_asym, w.rb_asym):
        assert a.dtype == torch.int32 and a.shape[0] == 9
        np.testing.assert_array_equal(a.numpy(), b)
    if l == 0:
        assert g.rb_down is None and g.rb_up is None
        return
    k = int(np.prod(pool_step(l)))
    assert g.rb_down.shape == (k, g.coords.shape[0]) and g.rb_up.shape == (k, got.levels[l - 1].coords.shape[0])
    np.testing.assert_array_equal(g.rb_down.numpy(), w.rb_down)
    np.testing.assert_array_equal(g.rb_up.numpy(), w.rb_up)
    assert (g.rb_down >= 0).sum() == (g.rb_up >= 0).sum() == int(got.levels[l - 1].num)


def test_level0_tables_integer_equal(topo):
    """The recon rulebooks (K = 3), the 3^3 head rulebook (built from
    floor queries here, by the general build in JAX) and the row ->
    voxel map."""
    got, want = topo
    for a, b in zip(got.rb_recon, want.rb_recon):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(got.rb_head.numpy(), want.rb_head)
    np.testing.assert_array_equal(got.point_inverse.numpy(), want.point_inverse)
    assert int(got.num_points) == int(want.num_points)


def test_train_tables_are_the_reverse(topo):
    """The train form's flipped tables and the pooling table pairs are
    exact inverses: rb_bwd[k, i] = v <=> rb[k, v] = i."""
    got, _ = topo

    def pairs(rb, swap=False):
        k, v = np.nonzero(rb.numpy() >= 0)
        i = rb.numpy()[k, v]
        return set(zip(k, i, v) if not swap else zip(k, v, i))

    for l, lv in enumerate(got.levels):
        for rb, bwd in zip(lv.rb_asym, lv.rb_asym_bwd):
            assert pairs(rb) == pairs(bwd, swap=True)
        if l:
            assert pairs(lv.rb_down) == pairs(lv.rb_up, swap=True)
    for rb, bwd in zip(got.rb_recon, got.rb_recon_bwd):
        assert pairs(rb) == pairs(bwd, swap=True)
    assert pairs(got.rb_head) == pairs(got.rb_head_bwd, swap=True)


# ------------------------------------------------- the conv over K offsets
def _case(topo, kind):
    """(rb_fwd, rb_bwd, V_in) of a conv of the topology."""
    t, _ = topo
    if kind == "asym9":
        return t.levels[0].rb_asym[1], t.levels[0].rb_asym_bwd[1], CAP
    if kind == "recon3":
        return t.rb_recon[2], t.rb_recon_bwd[2], CAP
    if kind == "head27":
        return t.rb_head, t.rb_head_bwd, CAP
    l = {"8": 1, "4": 3}[kind[-1]]
    lv = t.levels[l]
    fine = t.levels[l - 1].coords.shape[0]
    if kind.startswith("down"):
        return lv.rb_down, lv.rb_up, fine
    return lv.rb_up, lv.rb_down, lv.coords.shape[0]


KINDS = ("asym9", "recon3", "down8", "up8", "down4", "up4", "head27")


@pytest.mark.parametrize("kind", KINDS)
def test_conv_k_matches_sparse_conv_apply(topo, kind):
    """Forward and VJP of the port's conv over K offsets (`conv_k` on CPU
    tensors: the plain versions of K2 at K and K4 at K) against
    `sparse_conv_apply` and `jax.vjp` of it; V_in != V_out for the
    pooling (down) and transposed (up) convs.  `head27` is Cylinder's 3^3
    head, which JAX runs on `f3_conv_apply` and the port on `conv_k` over
    the topology's KTables (rulebook, row order, pair lists)."""
    rb, rb_bwd, v_in = _case(topo, kind)
    jconv = f3_conv_apply if kind == "head27" else sparse_conv_apply
    k, v_out = rb.shape
    rng = np.random.default_rng(k * 7 + v_in)
    x0 = rng.normal(size=(v_in, 12)).astype(np.float32)
    w0 = rng.normal(size=(k, 12, 20)).astype(np.float32)
    g0 = rng.normal(size=(v_out, 20)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda x, w: jconv(x, w, jnp.asarray(rb.numpy()), jnp.asarray(rb_bwd.numpy())),
        jnp.asarray(x0), jnp.asarray(w0),
    )
    jdx, jdw = vjp(jnp.asarray(g0))
    x = torch.tensor(x0, requires_grad=True)
    w = torch.tensor(w0, requires_grad=True)
    _build.reset_launches()
    t, _ = topo
    tables = (t.head, t.head_bwd) if kind == "head27" else (rb, rb_bwd)
    got = tsc.conv_k(x, w, *tables)
    got.backward(torch.from_numpy(g0))
    assert not any(_build.LAUNCHES.values())
    scale_out = tsc.sparse_conv_plain(x.detach().abs(), w.detach().abs(), rb).max()
    scale_dx = tsc.sparse_conv_plain(torch.from_numpy(np.abs(g0)), w.detach().abs().transpose(1, 2).contiguous(), rb_bwd).max()
    scale_dw = tf3.k3_conv_dw_plain(x.detach().abs(), torch.from_numpy(np.abs(g0)), rb_bwd).max()
    for a, b, s in ((got.detach(), out, scale_out), (x.grad, jdx, scale_dx), (w.grad, jdw, scale_dw)):
        assert a.shape == b.shape
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-5 * float(s)


def test_conv_k_needs_a_reverse_table_for_a_gradient(topo):
    """A gradient needs the reverse table (the train topology's); the
    inference form needs none."""
    down, _, v_in = _case(topo, "down8")
    xf = torch.randn(v_in, 4, requires_grad=True)
    with pytest.raises(ValueError, match="reverse rulebook"):
        tsc.conv_k(xf, torch.randn(8, 4, 5, requires_grad=True), down)
    with torch.no_grad():
        assert tsc.conv_k(xf, torch.randn(8, 4, 5), down).shape == (down.shape[1], 5)


def test_sparse_conv_wrappers_check_their_inputs():
    rb = torch.zeros((9, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not fit"):
        tsc.sparse_conv(torch.zeros(16, 4), torch.zeros(8, 4, 5), rb)
    with pytest.raises(ValueError, match="do not fit"):
        tsc.sparse_conv(torch.zeros(16, 4), torch.zeros(33, 4, 5), torch.zeros((33, 16), dtype=torch.int32))
    with pytest.raises(ValueError, match="do not fit"):
        tf3.sparse_conv_dw(torch.zeros(15, 4), torch.zeros(16, 5), rb)
    with pytest.raises(TypeError):
        tsc.sparse_conv(torch.zeros(16, 4), torch.zeros(9, 4, 5), rb.long())


# --------------------------------------------------------------- segment max
def _segmax_case():
    """Integer values so that ties are common; rows 0-3 at -inf in the
    dummy segment 12 (the padding rows of the model), segments 5 and 9
    empty, segment 10's one member equal to the zero fill."""
    rng = np.random.default_rng(0)
    x = rng.integers(-2, 3, size=(60, 3)).astype(np.float32)
    seg = rng.choice([0, 1, 2, 3, 4, 6, 7, 8, 11], 60)
    x[:4], seg[:4] = -np.inf, 12
    x[4], seg[4] = 0.0, 10
    return x, seg, 13


def test_segment_max_matches_jax_with_ties():
    x0, seg0, n = _segmax_case()
    coef = np.arange(1, n * 3 + 1, dtype=np.float32).reshape(n, 3)

    def jloss(x):
        m = jax.ops.segment_max(x, jnp.asarray(seg0), num_segments=n)[:-1]
        m = jnp.where(jnp.isfinite(m), m, 0.0)
        return (m * coef[:-1]).sum(), m

    (_, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    m = segment_max(x, torch.from_numpy(seg0), n)[:-1]
    m = torch.where(torch.isfinite(m), m, 0.0)
    (m * torch.from_numpy(coef[:-1])).sum().backward()
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(jm))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    # ties split the cotangent: some member got a fraction of its segment's
    g = x.grad.numpy()
    assert ((g > 0) & (g < 1)).any()
    assert (m[5] == 0).all() and (m[9] == 0).all()


def test_segment_max_matches_jax_with_a_large_dummy_segment():
    """Cylinder3D's layout at a small size: 3000 rows of 4 columns, the
    last 1000 all -inf in one dummy segment (the padding rows), every two
    real rows in one segment in shuffled order, values on a grid of 0.5
    with -0.0 planted so that most segments tie (their zeros among them):
    the plain version's max equals JAX's as values (the port's max of
    zeros is +0.0 where JAX may keep a -0.0), its gradient to the bit.
    Measured ~0.3 s."""
    rng = np.random.default_rng(4)
    p, real = 3000, 2000
    x0 = np.maximum(np.round(rng.normal(size=(p, 4)) * 2) / 2, 0).astype(np.float32)
    x0[rng.random((p, 4)) < 0.1] = -0.0
    x0[real:] = -np.inf
    seg0 = np.concatenate([rng.permutation(real) // 2, np.full(p - real, real // 2)]).astype(np.int32)
    n = real // 2 + 1
    coef = rng.normal(size=(n - 1, 4)).astype(np.float32)

    def jloss(x):
        m = jax.ops.segment_max(x, jnp.asarray(seg0), num_segments=n)[:-1]
        return (m * coef).sum(), m

    (_, jm), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    m = segment_max(x, torch.from_numpy(seg0), n)[:-1]
    (m * torch.from_numpy(coef)).sum().backward()
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(jm))
    assert not np.signbit(m.detach().numpy()[m.detach().numpy() == 0]).any()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))
    g = x.grad.numpy()
    assert ((g != 0) & (np.abs(g) < np.abs(coef).max() / 1.5)).any()  # some ties split their share
    assert not g[real:].any()


# -------------------------------------------------------------- the pipeline
@pytest.mark.parametrize("grid", [GRID, (8, 8, 4)])
@pytest.mark.parametrize("aug", [None, "train", "tta"])
def test_cylinder_pipeline_matches_jax(grid, aug):
    """The same reader dict and augmentation through both pipelines: the
    same rows, features, majority labels and maps.  The coarse (8, 8, 4)
    grid puts dozens of points of 4 labels in a voxel, so tied counts are
    common (the smallest label wins in both)."""
    rng = np.random.default_rng(3)
    pts = rng.uniform(-40, 40, (3000, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 3000).astype(np.int32)
    sample = {"xyzret": pts, "labels": labels, "path": "x"}
    if aug == "train":
        ja = JAug.sample(np.random.default_rng(5))
        ta = AugParams.sample(np.random.default_rng(5))
    elif aug == "tta":
        ja = JAug.tta_vote(3, rng=np.random.default_rng(6))
        ta = AugParams.tta_vote(3, rng=np.random.default_rng(6))
    else:
        ja = ta = None
    a = JPipeline(grid=grid, training=False)(sample, aug=ja)
    b = CylinderPipeline(grid=grid, training=False)(sample, aug=ta)
    for f in ("coords", "feats", "labels", "inverse_map", "raw_labels"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert (a.num_raw_points, a.name) == (b.num_raw_points, b.name)
    if grid == (8, 8, 4):
        counts = [np.bincount(labels[b.inverse_map == v], minlength=4) for v in range(len(b.coords))]
        assert sum((c == c.max()).sum() > 1 for c in counts) >= 5


def test_majority_labels_equal_the_bincount_loop():
    rng = np.random.default_rng(8)
    for n_lbl in (1, 3, 20):
        inverse = rng.integers(0, 50, 700)
        inverse[:50] = np.arange(50)  # every voxel has a point
        labels = rng.integers(0, n_lbl, 700).astype(np.int32)
        want = [np.bincount(labels[inverse == v]).argmax() for v in range(50)]
        np.testing.assert_array_equal(majority_labels(inverse, labels, 50), want)


def test_training_pipeline_draws_augmentations():
    """training=True draws AugParams from the pipeline's seeded generator,
    as JAX's does: the same seed gives the same sample."""
    rng = np.random.default_rng(4)
    s = {"xyzret": rng.uniform(-20, 20, (500, 4)).astype(np.float32),
         "labels": rng.integers(0, 20, 500).astype(np.int32)}
    a = JPipeline(grid=GRID, training=True, seed=2)(s)
    b = CylinderPipeline(grid=GRID, training=True, seed=2)(s)
    np.testing.assert_array_equal(a.feats, b.feats)
    np.testing.assert_array_equal(a.labels, b.labels)
