"""The port's global pools and BEV family (`taseg_tpu_torch.ops.bev`,
`.models.bev`) and `segment_max` against the JAX package, on the CPU.

The grid is `tests/test_bev.py`'s: capacity 256, 8 channels, 3 batches,
a 16 x 16 x 4 map, ~180 unique voxels from a seeded numpy generator; the
same arrays go through both.  Integers (coordinates, counts) are equal;
floats within 1e-5 (f32; the sums run in another order).  The
parameterised modules get JAX's initial parameters (`load_flax_params`).
`segment_max` forward and backward with planted ties, +0.0 and -0.0
among them, are held to the bits of `jax.ops.segment_max` and its
`jax.grad` (both treat the signed zeros as one value).  About 18 s alone
(`--durations`), 26 s in the 6-worker tier-1 run, most of it JAX
compiling its references.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu import models as jm
from taseg_tpu import ops as jo
from taseg_tpu.ops import bev as jbev
from taseg_tpu_torch import models as tm
from taseg_tpu_torch import ops as to
from taseg_tpu_torch.ops import bev as tbev
from taseg_tpu_torch.ops.voxelize import segment_max
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, load_flax_params

CAP, C, B = 256, 8, 3
H = W = 16
D = 4
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def grids():
    rng = np.random.default_rng(7)
    n = 180
    coords = np.zeros((CAP, 4), np.int32)
    coords[:n, 0] = rng.integers(0, H, n)
    coords[:n, 1] = rng.integers(0, W, n)
    coords[:n, 2] = rng.integers(0, D, n)
    coords[:n, 3] = rng.integers(0, B, n)
    _, keep = np.unique(
        coords[:n, 0] * 10000 + coords[:n, 1] * 100 + coords[:n, 2] * 10 + coords[:n, 3],
        return_index=True,
    )
    n = len(keep)
    coords[:n] = coords[sorted(keep)]
    coords[n:] = 0
    feats = np.zeros((CAP, C), np.float32)
    feats[:n] = rng.normal(size=(n, C)).astype(np.float32)
    jg = jo.SparseGrid(coords=jnp.asarray(coords), feats=jnp.asarray(feats), num=jnp.int32(n), stride=1)
    tg = to.SparseGrid(
        coords=torch.from_numpy(coords), feats=torch.from_numpy(feats),
        num=torch.tensor(n, dtype=torch.int32), stride=1,
    )
    valid = np.arange(CAP) < n
    jb = jo.compute_bounds(jnp.asarray(coords), jnp.asarray(valid))
    tb = to.compute_bounds(torch.from_numpy(coords), torch.from_numpy(valid))
    return jg, tg, jb, tb


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(1.0, np.abs(want).max())


def _grid_equal(tgrid, jgrid, tol=TOL):
    assert int(tgrid.num) == int(jgrid.num)
    assert tgrid.stride == jgrid.stride
    np.testing.assert_array_equal(tgrid.coords.numpy(), np.asarray(jgrid.coords))
    n = int(jgrid.num)
    _close(tgrid.feats.detach().numpy()[:n], np.asarray(jgrid.feats)[:n], tol)


def test_sparse_tensor_surface(grids):
    jg, tg, _, _ = grids
    assert tg.capacity == jg.capacity == CAP
    np.testing.assert_array_equal(tg.valid_mask().numpy(), np.asarray(jg.valid_mask()))
    pts = to.PointSet(coords=tg.coords.float(), feats=tg.feats, num=tg.num)
    assert pts.capacity == CAP and int(pts.valid_mask().sum()) == int(jg.num)
    assert tg.with_feats(tg.feats * 2).feats.shape == (CAP, C)


@pytest.mark.parametrize("pool", ["global_avg_pool", "global_max_pool"])
def test_global_pools_match_jax(grids, pool):
    jg, tg, _, _ = grids
    want = jax.jit(lambda g: getattr(jbev, pool)(g, B + 1))(jg)  # batch 3 is empty
    got = getattr(tbev, pool)(tg, B + 1)
    _close(got.numpy(), want)
    assert (got[B] == 0).all()
    mod = {"global_avg_pool": "GlobalAvgPool", "global_max_pool": "GlobalMaxPool"}[pool]
    _close(getattr(tm, mod)(B + 1)(tg).numpy(), np.asarray(getattr(jm, mod)(B + 1).apply({}, jg)))


@pytest.mark.parametrize("dim", [2, 0])
def test_bev_reduction_matches_jax(grids, dim):
    jg, tg, jb, tb = grids
    want = jax.jit(lambda g: jbev.bev_reduction(g, jb, dim=dim))(jg)
    _grid_equal(tbev.bev_reduction(tg, tb, dim=dim), want)
    _grid_equal(tm.ToBEVReduction(dim)(tg, tb), jm.ToBEVReduction(dim).apply({}, jg, jb))


@pytest.mark.parametrize("n_kernels,stride", [(4, 1), (3, 2), (40, 1)])
def test_slice_kernel_matmul_matches_jax(grids, n_kernels, stride):
    """Every row on its slice, out-of-range heights clipped, and more
    slices than one K2 call takes (40 > 32)."""
    jg, tg, _, _ = grids
    rng = np.random.default_rng(n_kernels)
    k = rng.normal(size=(n_kernels, C, 5)).astype(np.float32)
    want = jax.jit(lambda f, c, kk: jbev._slice_kernel_matmul(f, c, kk, stride, 2))(jg.feats, jg.coords, k)
    got = tbev._slice_kernel_matmul(tg.feats, tg.coords, torch.from_numpy(k), stride, 2)
    _close(got.numpy(), want)
    rb = tbev.slice_table(tg.coords, n_kernels, stride, 2)
    assert ((rb >= 0).sum(0) == 1).all()


@pytest.mark.parametrize("offset", [(0, 0, 0), (2, 3, 0)])
def test_to_dense_bev_matches_jax(grids, offset):
    jg, tg, _, _ = grids
    want = jax.jit(lambda g: jbev.to_dense_bev(g, g.feats, B, (H - 4, W), offset=offset))(jg)
    got = tbev.to_dense_bev(tg, tg.feats, B, (H - 4, W), offset=offset)
    assert got.shape == (B, H - 4, W, C)
    _close(got.numpy(), want)


@pytest.mark.parametrize("dim", [2, 1])
def test_height_compression_matches_jax(grids, dim):
    jg, tg, _, _ = grids
    shape = (H, W, D) if dim == 2 else (H, 3, D)
    want = jax.jit(lambda g: jbev.bev_height_compression(g, B, shape, dim=dim))(jg)
    _close(tbev.bev_height_compression(tg, B, shape, dim=dim).numpy(), want)
    mod = tm.ToBEVHeightCompression(C, shape, dim=dim, batch_size=B)
    ref = jm.ToBEVHeightCompression(C, shape, dim=dim, batch_size=B).apply({}, jg)
    _close(mod(tg).numpy(), ref)


@pytest.mark.parametrize("out_stride,bias", [(1, False), (2, True)])
def test_bev_sparse_conv_matches_jax(grids, out_stride, bias):
    jg, tg, jb, tb = grids
    jmod = jm.ToBEVConvolution(C, 6, D, stride=out_stride, use_bias=bias)
    variables = jmod.init(jax.random.PRNGKey(1), jg, jb)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    if bias:
        params["bias"] = np.linspace(-1, 1, 6).astype(np.float32)
    want = jax.jit(lambda p, g: jmod.apply({"params": p}, g, jb))(params, jg)
    tmod = tm.ToBEVConvolution(C, 6, D, stride=out_stride, use_bias=bias)
    load_flax_params(tmod, params, {})
    _grid_equal(tmod(tg, tb), want)
    got = tbev.bev_sparse_conv(
        tg, torch.from_numpy(params["kernel"]), tb, out_stride=out_stride,
        bias=torch.from_numpy(params["bias"]) if bias else None,
    )
    _grid_equal(got, want)


def test_dense_bev_convolution_value_and_grad_match_jax(grids):
    """ToDenseBEVConvolution forward with JAX's initial parameters, and
    the gradient of a weighted sum of its map in the kernel, the bias and
    the input features (the slice conv's backward, K2 / K4 at K, and the
    dense scatter's, the identity gather)."""
    jg, tg, _, _ = grids
    shape = (H, W, D)
    jmod = jm.ToDenseBEVConvolution(C, 6, shape, use_bias=True, batch_size=B)
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(2), jg)["params"])
    coef = np.random.default_rng(4).normal(size=(B, H, W, 6)).astype(np.float32)

    def jloss(p, f):
        out = jmod.apply({"params": p}, jg.replace(feats=f))
        return (out * coef).sum(), out

    (_, jout), (jgp, jgf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(params, jg.feats)
    tmod = tm.ToDenseBEVConvolution(C, 6, shape, use_bias=True, batch_size=B)
    load_flax_params(tmod, params, {})
    f = tg.feats.clone().requires_grad_(True)
    out = tmod(tg.with_feats(f))
    (out * torch.from_numpy(coef)).sum().backward()
    _close(out.detach().numpy(), jout)
    _close(tmod.kernel.grad.numpy(), jgp["kernel"], 1e-4)
    _close(tmod.bias.grad.numpy(), jgp["bias"], 1e-4)
    _close(f.grad.numpy(), jgf, 1e-4)


def test_module_init_distribution_and_names():
    """The kernel's uniform(+-1/sqrt(C_in)) draws from an explicit
    generator (the same draws from the same seed), and the flax names."""
    gen = torch.Generator().manual_seed(0)
    a = tm.ToBEVConvolution(16, 8, 5, use_bias=True, generator=gen)
    b = tm.ToBEVConvolution(16, 8, 5, use_bias=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a.kernel, b.kernel)
    assert a.kernel.abs().max() <= 0.25 and a.kernel.abs().max() > 0.2
    params, stats = export_flax_params(a)
    assert set(params) == {"kernel", "bias"} and not stats
    d = tm.ToDenseBEVConvolution(16, 8, (H, W, 7))
    assert tuple(d.kernel.shape) == (7, 16, 8) and d.bias is None


def _segmax_case():
    """Rows into 13 segments with planted ties: equal maxima, +0.0 beside
    -0.0, a segment of -0.0 only, a segment of -inf, empty segments."""
    rng = np.random.default_rng(11)
    p, n = 300, 13
    x = rng.integers(-4, 4, size=(p, 3)).astype(np.float32)
    seg = rng.integers(0, n - 3, p).astype(np.int32)
    seg[:6] = n - 3  # +0.0 and -0.0 ties
    x[:6] = [[0.0, -0.0, 0.0], [-0.0, 0.0, -0.0], [0.0, 0.0, 0.0],
             [-0.0, -0.0, -0.0], [-1.0, -2.0, -0.0], [-0.0, -1.0, 0.0]]
    seg[6:9] = n - 2  # -0.0 only
    x[6:9] = -0.0
    seg[9:12] = n - 1  # -inf only (a padding row's value)
    x[9:12] = -np.inf
    seg[seg == 4] = 5  # segment 4 empty
    return x, seg, n


def test_segment_max_matches_jax_with_signed_zero_ties():
    x0, seg0, n = _segmax_case()
    coef = np.arange(1, n * 3 + 1, dtype=np.float32).reshape(n, 3)

    def jloss(x):
        m = jax.ops.segment_max(x, jnp.asarray(seg0), num_segments=n)
        m = jnp.where(jnp.isfinite(m), m, 0.0)
        return (m * coef).sum(), m

    (_, jmax), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jnp.asarray(x0))
    x = torch.tensor(x0, requires_grad=True)
    m = segment_max(x, torch.from_numpy(seg0), n)
    assert not torch.signbit(m[m == 0]).any()  # a max of zeros is +0.0
    m = torch.where(torch.isfinite(m), m, 0.0)
    (m * torch.from_numpy(coef)).sum().backward()
    np.testing.assert_array_equal(m.detach().numpy(), np.asarray(jmax))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jgrad))
    g = x.grad.numpy()
    assert ((g > 0) & (g < coef.max())).any() and (g[:6] != 0).sum() > 6  # ties split
