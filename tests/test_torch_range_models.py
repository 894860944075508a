"""The range view's four segmentors in the port against the JAX package's
flax models (`models/range2d/salsanext.py`, `resnet_range.py`,
`rangenet.py`): SalsaNext at base 8 on 16 x 128 images, FIDNet and CENet
at their widths on 16 x 64, RangeNet with darknet21's depths on 16 x 64,
batch 2, f32.

Weights: `init_params_numpy` with the BN affine terms, the running
statistics and the conv biases drawn at random, loaded into both (the
port's tree must have JAX's names and shapes: `load_flax_params` maps
them one to one and raises otherwise).  Eval logits within 2e-5 of their
largest magnitude (torch's CPU convs sum in another order than XLA's).
Train mode, dropout the identity on both sides (patched here; the JAX
package does not change): the logits, CENet's three aux logits and every
BN running statistic within 2e-4 of its scale (batch statistics over 2 x
16 x 64 pixels pass the summation-order differences on through up to 25
BN layers).  Also: flax "SAME" at stride 2 (pads (0, 1)) and the
transposed conv's layout, on their own; the bilinear upsampling against
`jax.image.resize`.  JAX's references are jitted once per model.  ~25 s
in one process, 45 s in the 6-worker tier-1 run.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_range_narrow import narrow_range_models

from taseg_tpu.models.range2d import CENet as JCENet
from taseg_tpu.models.range2d import FIDNet as JFIDNet
from taseg_tpu.models.range2d import RangeNet as JRangeNet
from taseg_tpu.models.range2d import SalsaNext as JSalsaNext
from taseg_tpu.models.range2d.resnet_range import bilinear_resize as j_resize
from taseg_tpu_torch.models import CENet, FIDNet, RangeNet, SalsaNext
from taseg_tpu_torch.models.layers import Dropout
from taseg_tpu_torch.models.range2d import blocks as tblocks
from taseg_tpu_torch.models.range2d.rangenet import DARKNET21
from taseg_tpu_torch.models.range2d.resnet_range import bilinear_resize
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy, load_flax_params

NC = 20
# name: (MODEL block, JAX module, port class, (H, W))
MODELS = {
    "salsanext": ({"NAME": "SalsaNext"}, lambda: JSalsaNext(NC, base=8), SalsaNext, (16, 128)),
    "fidnet": ({"NAME": "FIDNet"}, lambda: JFIDNet(NC), FIDNet, (16, 64)),
    "cenet": ({"NAME": "CENet", "IF_AUX": True}, lambda: JCENet(NC), CENet, (16, 64)),
    "rangenet": (
        {"NAME": "RangeNet"},
        lambda: JRangeNet(NC, layers=DARKNET21), RangeNet, (16, 64),
    ),
}

# the narrow widths (`torch_range_narrow`): the recipes build them at full width
WIDTHS = {"SalsaNext": {"base": 8}, "RangeNet": {"layers": DARKNET21}}


@pytest.fixture(autouse=True, scope="module")
def build():
    """`build_segmentor` at WIDTHS, also inside `init_params_numpy`."""
    with narrow_range_models(**WIDTHS) as b:
        yield b


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_of(name: str) -> dict:
    model = {"NUM_CLASS": NC, "IN_FEATURE_DIM": 6, **MODELS[name][0]}
    return {"MODALITY": "range", "MODEL": model}


def _randomize(tree, rng, stats):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, stats)
            continue
        v = np.array(v, np.float32)
        if stats:
            v = rng.uniform(0.5, 1.5, v.shape) if k == "var" else rng.normal(0, 0.2, v.shape)
        elif k == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k == "bias":
            v = rng.normal(0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


def weights(name: str, seed: int = 0):
    p, s = init_params_numpy(cfg_of(name), seed=seed)
    rng = np.random.default_rng(seed + 1)
    return _randomize(p, rng, False), _randomize(s, rng, True)


def scan_input(hw, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, *hw, 6)).astype(np.float32)
    x[..., 5] = rng.random((2, *hw)) < 0.8
    x[..., :5] *= x[..., 5:6]
    return x


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-3), (err, np.abs(want).max())


@pytest.fixture(scope="module", params=sorted(MODELS))
def run(request, build):
    """(name, JAX eval logits, JAX train (out, batch_stats), port model,
    port eval logits, port train out, port batch stats after the train
    forward)."""
    name = request.param
    _, jmod, cls, hw = MODELS[name]
    p, s = weights(name)
    x = scan_input(hw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
        mp.setattr(Dropout, "forward", lambda self, x: x)
        jm = jmod()
        variables = {"params": jax.tree_util.tree_map(jnp.asarray, p),
                     "batch_stats": jax.tree_util.tree_map(jnp.asarray, s)}
        j_eval = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, False))(variables, x))
        j_train = jax.jit(lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"]))(variables, x)
        j_train = jax.tree_util.tree_map(np.asarray, j_train)
        m = build(cfg_of(name), device="cpu")
        assert isinstance(m, cls)
        load_flax_params(m, p, s)
        m.eval()
        with torch.no_grad():
            t_eval = m(torch.from_numpy(x)).numpy()
        m.train()
        with torch.no_grad():
            t_train = m(torch.from_numpy(x))
        t_train = jax.tree_util.tree_map(lambda t: t.numpy(), t_train)
        _, t_stats = export_flax_params(m)
    return name, j_eval, j_train, m, t_eval, t_train, t_stats


def test_eval_logits_match_jax(run):
    name, j_eval, _, _, t_eval, _, _ = run
    assert t_eval.shape == j_eval.shape == (2, *MODELS[name][3], NC)
    assert t_eval.dtype == np.float32
    _close(t_eval, j_eval, 2e-5)


def test_train_forward_and_bn_statistics_match_jax(run):
    name, _, (j_out, j_upd), _, _, t_out, t_stats = run
    if name == "cenet":
        (jl, jaux), (tl, taux) = j_out, t_out
        assert len(taux) == len(jaux) == 3
        for a, b in zip(taux, jaux):
            _close(a, b, 2e-4)
    else:
        jl, tl = j_out, t_out
    _close(tl, jl, 2e-4)
    flat_j = jax.tree_util.tree_flatten_with_path(j_upd["batch_stats"])[0]
    flat_t = {"/".join(str(k.key) for k in path): v for path, v in
              jax.tree_util.tree_flatten_with_path(t_stats)[0]}
    assert len(flat_j) == len(flat_t)
    for path, v in flat_j:
        key = "/".join(str(k.key) for k in path)
        _close(flat_t[key], v, 2e-4)


def test_cenet_aux_heads_only_in_train(build):
    """CENet's aux heads have parameters in eval too, and give their
    logits only in train mode (JAX :109-118); without IF_AUX there are
    none."""
    m = build(cfg_of("cenet"), device="cpu")
    assert {"aux_head1.kernel", "aux_head3.bias"} <= set(dict(m.named_parameters()))
    p, s = weights("cenet")
    load_flax_params(m, p, s)
    x = torch.from_numpy(scan_input((16, 64)))
    assert isinstance(m.eval()(x), torch.Tensor)
    no_aux = build({**cfg_of("cenet"), "MODEL": {**cfg_of("cenet")["MODEL"], "IF_AUX": False}})
    assert not any(k.startswith("aux_head") for k, _ in no_aux.named_parameters())


@pytest.mark.parametrize("size", [(16, 64), (15, 63)])
def test_stride_two_conv_pads_as_flax_same(size):
    """flax "SAME" at stride 2: (0, 1) on an even size, (1, 1) on an odd
    one; RangeNet's (1, 2) strides pad H (1, 1) and W (0, 1)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, *size, 3)).astype(np.float32)
    k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    for stride in ((2, 2), (1, 2)):
        want = fnn.Conv(4, (3, 3), strides=stride, padding="SAME", use_bias=False).apply(
            {"params": {"kernel": k}}, x)
        conv = tblocks.Conv(3, 4, stride=stride, use_bias=False, device="cpu")
        with torch.no_grad():
            conv.kernel.copy_(torch.from_numpy(k))
            got = conv(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape
        _close(got, want, 1e-6)


def test_conv_transpose_matches_flax():
    """flax's ConvTranspose (kernel (1, 4), strides (1, 2), "SAME", no
    kernel flip) against `conv_transpose2d` of the flipped kernel."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 8, 5)).astype(np.float32)
    k = rng.normal(size=(1, 4, 5, 6)).astype(np.float32)
    want = fnn.ConvTranspose(6, (1, 4), strides=(1, 2), padding="SAME", use_bias=False).apply(
        {"params": {"kernel": k}}, x)
    m = tblocks.ConvTranspose(5, 6, device="cpu")
    with torch.no_grad():
        m.kernel.copy_(torch.from_numpy(k))
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 3, 16, 6)
    _close(got, want, 1e-6)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_bilinear_upsampling_matches_jax_resize(factor):
    """`F.interpolate` (clamped edges) and `jax.image.resize` (dropped and
    renormalised taps) agree at the backbone's upsampling factors."""
    x = np.random.default_rng(factor).normal(size=(2, 3, 5, 4)).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), 3 * factor, 5 * factor))
    got = bilinear_resize(torch.from_numpy(x), 3 * factor, 5 * factor).numpy()
    _close(got, want, 1e-6)
