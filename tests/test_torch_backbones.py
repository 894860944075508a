"""The port's torchsparse demo backbones (`taseg_tpu_torch.models.voxel.
backbones`) against the JAX package, on the CPU.

`general_downsample` over `tests/test_backbones.py:56`'s grid (kernel 3
at stride 2 from tensor stride 1, and the anisotropic (1, 3, 1) at
(1, 2, 1) from tensor stride 4) and every table of
`build_resnet_topology` (stage coordinates, counts, entry tables and
their reverses, the residual blocks' 3^3 tables) are integer-equal to
JAX's.  SparseResNet21D at width_multiplier 0.25 on ~500 voxels of two
batches, the same weights in both (`init_module_numpy`'s draws, carried
with `load_flax_params`): every stage's eval features within 1e-5 of the
largest (f32), and one train-mode forward and backward of a weighted sum
of the outputs, the features within 1e-4 and each parameter's gradient
within 1e-4 of its largest (measured 2e-6).  SparseResUNet42 is held the
same way in `test_torch_backbones_unet.py`.  JAX's references are
compiled once per module (`resnet_run`, XLA's backend optimisation level
0 for the forward and 1 for the gradient).  About 66 s alone
(`--durations`), ~50 s of it JAX compiling; 85 s in the 6-worker tier-1
run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.models.voxel import backbones as jbb
from taseg_tpu.models.voxel.backbone_context import UNetCapacities as JCaps
from taseg_tpu.models.voxel.backbone_context import build_unet_topology as j_unet_topology
from taseg_tpu.ops import compute_bounds as j_bounds
from taseg_tpu.ops import voxelize_avg as j_voxelize_avg
from taseg_tpu_torch.models.voxel import backbones as tbb
from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities, build_unet_topology
from taseg_tpu_torch.ops import compute_bounds, voxelize_avg
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_module_numpy, load_flax_params

WM = 0.25
# f32 eval features; parameter gradients
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unique_coords(rng, n, lo, hi):
    c = np.unique(rng.integers(lo, hi, (n, 3)).astype(np.int32), axis=0)
    b = rng.integers(0, 2, (len(c), 1)).astype(np.int32)
    return np.concatenate([c, b], axis=1)


def _pad(coords, cap):
    out = np.zeros((cap, 4), np.int32)
    out[: len(coords)] = coords
    return out, len(coords)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-12)


@pytest.mark.parametrize(
    "kernel_size,stride,tensor_stride",
    [(3, (2, 2, 2), (1, 1, 1)), ((1, 3, 1), (1, 2, 1), (4, 4, 4))],
)
def test_general_downsample_equals_jax(kernel_size, stride, tensor_stride):
    rng = np.random.default_rng(0)
    coords = _unique_coords(rng, 600, -6, 6)
    coords[:, :3] *= np.asarray(tensor_stride)
    c, num = _pad(coords, 4096)
    valid = np.arange(4096) < num
    jb = j_bounds(jnp.asarray(c), jnp.asarray(valid), margin=64)
    want_c, want_n = jax.jit(jbb.general_downsample, static_argnums=(2, 3, 4, 6))(
        jnp.asarray(c), jnp.int32(num), kernel_size, stride, tensor_stride, jb, 1024,
    )
    tb = compute_bounds(torch.from_numpy(c), torch.from_numpy(valid), margin=64)
    got_c, got_n = tbb.general_downsample(
        torch.from_numpy(c), torch.tensor(num, dtype=torch.int32), kernel_size, stride,
        tensor_stride, tb, 1024,
    )
    assert int(got_n) == int(want_n) > 0
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


RESNET_CAPS = (1024, 1024, 512, 512, 512)


@pytest.fixture(scope="module")
def resnet_input():
    rng = np.random.default_rng(1)
    coords = _unique_coords(rng, 500, 0, 24)
    c, num = _pad(coords, 1024)
    feats = rng.normal(size=(1024, 4)).astype(np.float32)
    return c, num, feats


@pytest.mark.parametrize("train", [False, True])
def test_resnet_topology_equals_jax(resnet_input, train):
    c, num, _ = resnet_input
    want = jax.jit(lambda x, n: jbb.build_resnet_topology(x, n, RESNET_CAPS))(jnp.asarray(c), jnp.int32(num))
    got = tbb.build_resnet_topology(torch.from_numpy(c), num, RESNET_CAPS, train=train)
    np.testing.assert_array_equal(got.point_inverse.numpy(), np.asarray(want.point_inverse))
    for g, w in zip(got.stages, want.stages, strict=True):
        assert int(g.num) == int(w.num) > 0
        for name in ("coords", "rb_entry", "rb_entry_bwd", "rb_res"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
        assert g.entry.rb is g.rb_entry and (g.entry_bwd is not None) == train
    assert got.stages[-1].rb_entry.shape[0] == 3  # the (1, 3, 1) kernel: K = 3


def _run(fn, *args, level=0):
    """`fn` jitted and compiled once at XLA's backend optimisation level
    `level` (0 for the forwards, 1 for the gradients), run on `args`."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_backend_optimization_level": level})(*args)


def _jax_grads(model, variables, x0, topo, coefs, train):
    """The outputs of `model` (train or eval mode) and the gradient of
    sum(outputs x coefs) in the parameters."""
    def loss(p):
        v = {"params": p, "batch_stats": variables["batch_stats"]}
        outs = model.apply(v, x0, topo, True, mutable=["batch_stats"])[0] if train else model.apply(v, x0, topo, False)
        return sum((o * cf).sum() for o, cf in zip(outs, coefs)), outs

    (_, outs), g = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    return outs, g


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(kind):
    net = tbb.SparseResNet21D if kind == "resnet" else tbb.SparseResUNet42
    return net(in_channels=4, width_multiplier=WM, device="cpu")


def _port(kind, c, num, feats, train):
    """The port's model (JAX's weights loaded) and topology on the
    input, and the voxelized input features."""
    model = _port_model(kind)
    if kind == "resnet":
        topo = tbb.build_resnet_topology(torch.from_numpy(c), num, RESNET_CAPS, train=train)
    else:
        topo = build_unet_topology(
            torch.from_numpy(c).float(), torch.tensor(num, dtype=torch.int32),
            UNetCapacities.for_points(1024), devox_pairs=train,
        )
    x0 = voxelize_avg(torch.from_numpy(feats), topo.point_inverse, topo.point_tables)
    return model, topo, x0


def _input(x0, x0_jax):
    """JAX's voxelized input (the two mean-centred cumsums round apart,
    within 1e-5), so the backbones see the same bits."""
    _close(x0.numpy(), x0_jax, 1e-5)
    return torch.from_numpy(np.array(x0_jax))


def jax_run(kind, c, num, feats, train_grads: bool):
    """JAX's backbone on the input: (weights, eval outputs, grad outputs,
    parameter gradients, coefs, voxelized input).  The weights are the
    port's `init_module_numpy` draws, given to both.  ResNet: the eval
    forward compiled apart, the gradient in train mode; UNet
    (`train_grads` False): the eval forward and its gradient in one
    compile."""
    rng = np.random.default_rng(5)
    cj, nj = jnp.asarray(c), jnp.int32(num)
    if kind == "resnet":
        model = jbb.SparseResNet21D(width_multiplier=WM)
        topo = _run(lambda x, n: jbb.build_resnet_topology(x, n, RESNET_CAPS), cj, nj)
    else:
        caps = JCaps.for_points(1024)
        model = jbb.SparseResUNet42(width_multiplier=WM)
        topo = _run(lambda x, n: j_unet_topology(x.astype(jnp.float32), n, caps, devox_strides=()), cj, nj)
    x0 = j_voxelize_avg(jnp.asarray(feats), topo.point_inverse, topo.point_tables)
    params, stats = init_module_numpy(_port_model(kind), 3)
    variables = {"params": params, "batch_stats": stats}
    shapes = jax.eval_shape(lambda v, x: model.apply(v, x, topo, False), variables, x0)
    coefs = [rng.normal(size=o.shape).astype(np.float32) for o in shapes]
    outs, grads = _run(
        lambda v, x: _jax_grads(model, v, x, topo, coefs, train_grads), variables, x0, level=1,
    )
    evals = _run(lambda v, x: model.apply(v, x, topo, False), variables, x0) if train_grads else outs
    return variables, evals, outs, grads, coefs, np.asarray(x0)


@pytest.fixture(scope="module")
def resnet_run(resnet_input):
    return jax_run("resnet", *resnet_input, train_grads=True)


def check_eval(kind, inp, run):
    """Every stage's eval features within FWD_TOL of JAX's, and the
    weight tree's names and shapes as JAX's."""
    c, num, feats = inp
    variables, evals, *_, x0_jax = run
    model, topo, x0 = _port(kind, c, num, feats, train=False)
    x0 = _input(x0, x0_jax)
    load_flax_params(model, variables["params"], variables["batch_stats"])
    model.eval()
    with torch.no_grad():
        outs = model(x0, topo)
    want_widths = [16, 32, 64, 128, 128] if kind == "resnet" else [32, 32, 64, 128, 256, 256, 128, 96, 96]
    assert [o.shape[1] for o in outs] == [int(w * WM) for w in want_widths]
    for o, w in zip(outs, evals, strict=True):
        _close(o.numpy(), w, FWD_TOL)
    params, _ = export_flax_params(model)
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(variables["params"])


def check_backward(kind, inp, run, train: bool):
    """The outputs (within 1e-4) and every parameter's gradient (within
    GRAD_TOL) of sum(outputs x coefs), in train or eval mode, against
    JAX's; the topology in its train form either way."""
    c, num, feats = inp
    variables, _, outs_jax, grads_jax, coefs, x0_jax = run
    model, topo, x0 = _port(kind, c, num, feats, train=True)
    x0 = _input(x0, x0_jax)
    load_flax_params(model, variables["params"], variables["batch_stats"])
    model.train(train)
    outs = model(x0, topo)
    sum((o * torch.from_numpy(cf)).sum() for o, cf in zip(outs, coefs)).backward()
    for o, w in zip(outs, outs_jax, strict=True):
        _close(o.detach().numpy(), w, 1e-4)
    flat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(grads_jax)}
    named = dict(model.named_parameters())
    assert len(flat) == len(named)
    for key, g in flat.items():
        name = ".".join(p.strip("[]'") for p in key.split("]["))
        _close(named[name].grad.numpy(), g, GRAD_TOL)


def test_resnet21d_eval_matches_jax(resnet_input, resnet_run):
    check_eval("resnet", resnet_input, resnet_run)


def test_resnet21d_train_backward_matches_jax(resnet_input, resnet_run):
    check_backward("resnet", resnet_input, resnet_run, train=True)
