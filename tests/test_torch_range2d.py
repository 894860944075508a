"""The range-view blocks of the port against the JAX package's flax
blocks (`models/range2d/blocks.py`), and the port's Dropout.

Each block gets the flax init's weights with the BN affine terms and
running statistics drawn at random, and the same NHWC f32 input.  Eval:
outputs within 1e-5 of their scale (torch's CPU convs sum in another
order than XLA's).  Train (dropout the identity on
both sides, patched in this test; JAX's package does not change): the
outputs within 1e-5 and the new running statistics within 1e-5 of their
scale (flax keeps 0.9 of the old value and the biased batch variance).
`pixel_shuffle` is a permutation, equal to JAX's.  Dropout: kept share
within 4.5 standard deviations of 1 - p, kept values x / (1 - p) exactly,
the same mask from the same seed, the identity at eval and at p = 0.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.models.range2d import blocks as jblocks
from taseg_tpu_torch.models.layers import Dropout, seed_dropout
from taseg_tpu_torch.models.range2d import blocks as tblocks
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, load_flax_params

N, H, W = 2, 8, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores
    (the range branch's many small convs then slow down tenfold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# (name, JAX module, torch module, input channels, skip channels or 0)
BLOCKS = {
    "res_context": (lambda: jblocks.ResContextBlock(8), lambda: tblocks.ResContextBlock(6, 8, device="cpu"), 6, 0),
    "salsa_res_pool": (
        lambda: jblocks.SalsaResBlock(12), lambda: tblocks.SalsaResBlock(8, 12, device="cpu"), 8, 0,
    ),
    "salsa_res_flat": (
        lambda: jblocks.SalsaResBlock(12, pooling=False),
        lambda: tblocks.SalsaResBlock(8, 12, pooling=False, device="cpu"), 8, 0,
    ),
    "salsa_up": (
        lambda: jblocks.SalsaUpBlock(10), lambda: tblocks.SalsaUpBlock(16, 6, 10, device="cpu"), 16, 6,
    ),
}


def _inputs(cin, skip, seed):
    rng = np.random.default_rng(seed)
    hh, ww = (H // 2, W // 2) if skip else (H, W)
    x = rng.normal(size=(N, hh, ww, cin)).astype(np.float32)
    s = rng.normal(size=(N, H, W, skip)).astype(np.float32) if skip else None
    return x, s


def _no_dropout(monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(Dropout, "forward", lambda self, x: x)


def _flat(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_range_block_matches_jax(name, train, monkeypatch):
    make_j, make_t, cin, skip = BLOCKS[name]
    x, s = _inputs(cin, skip, seed=len(name))
    args = (jnp.asarray(x),) + ((jnp.asarray(s),) if skip else ())
    jm = make_j()
    v = jax.jit(lambda *a: jm.init({"params": jax.random.PRNGKey(1)}, *a, False))(*args)
    rng = np.random.default_rng(3)
    params = _randomize(jax.tree_util.tree_map(np.asarray, v["params"]), rng, False)
    stats = _randomize(jax.tree_util.tree_map(np.asarray, v["batch_stats"]), rng, True)
    variables = {"params": params, "batch_stats": stats}
    tm = make_t()
    load_flax_params(tm, params, stats)
    if train:
        _no_dropout(monkeypatch)
        want, upd = jax.jit(
            lambda vv, *a: jm.apply(vv, *a, True, mutable=["batch_stats"])
        )(variables, *args)
        tm.train()
    else:
        want = jax.jit(lambda vv, *a: jm.apply(vv, *a, False))(variables, *args)
        tm.eval()
    got = tm(*(torch.from_numpy(a) for a in (x, s) if a is not None))
    for g, w_ in zip(_flat(got), _flat(want)):
        w_ = np.asarray(w_)
        assert g.dtype == torch.float32 and tuple(g.shape) == w_.shape
        assert np.abs(g.detach().numpy() - w_).max() <= 1e-5 * np.abs(w_).max()
    if name == "salsa_res_pool":
        assert _flat(got)[0].shape == (N, H // 2, W // 2, 12)
    if train:
        _, new_stats = export_flax_params(tm)
        a = jax.tree_util.tree_leaves_with_path(new_stats)
        b = dict(jax.tree_util.tree_leaves_with_path(upd["batch_stats"]))
        assert len(a) == len(b) > 0
        for k, leaf in a:
            ref = np.asarray(b[k])
            assert np.abs(leaf - ref).max() <= 1e-5 * np.abs(ref).max(), jax.tree_util.keystr(k)
            old = np.asarray(dict(jax.tree_util.tree_leaves_with_path(stats))[k])
            assert not np.array_equal(leaf, old)


def test_bf16_input_computes_in_f32():
    """flax's Conv promotes a bf16 input against its f32 kernel: the
    block's output is f32, equal to the block on the input rounded to
    bf16 and read as f32."""
    tm = tblocks.ResContextBlock(6, 8, device="cpu").eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in tm.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.3)
    x = torch.from_numpy(_inputs(6, 0, 1)[0]).to(torch.bfloat16)
    y = tm(x)
    assert y.dtype == torch.float32
    assert torch.equal(y, tm(x.float()))


def test_pixel_shuffle_equal_jax():
    x = np.arange(2 * 3 * 5 * 12, dtype=np.float32).reshape(2, 3, 5, 12)
    want = np.asarray(jblocks.pixel_shuffle(jnp.asarray(x), 2))
    got = tblocks.pixel_shuffle(torch.from_numpy(x), 2)
    assert got.shape == (2, 6, 10, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # not torch's channel order
    ps = torch.nn.functional.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    assert not torch.equal(ps.permute(0, 2, 3, 1), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dropout_statistics_and_determinism(dtype):
    n = 200_000
    x = (torch.rand(n, generator=torch.Generator().manual_seed(0)) + 0.5).to(dtype)
    d = Dropout(0.2).train()
    d.generator = torch.Generator().manual_seed(7)
    y = d(x)
    assert y.dtype == dtype
    kept = y != 0
    share = kept.float().mean().item()
    assert abs(share - 0.8) <= 4.5 * (0.8 * 0.2 / n) ** 0.5
    assert torch.equal(y[kept], x[kept] / 0.8)
    d.generator = torch.Generator().manual_seed(7)
    assert torch.equal(d(x), y)  # same seed, same mask
    d.generator = torch.Generator().manual_seed(8)
    assert not torch.equal(d(x), y)
    assert d.eval()(x) is x
    assert Dropout(0.0).train()(x) is x


def test_seed_dropout_reaches_every_dropout():
    m = tblocks.SalsaUpBlock(16, 6, 10, device="cpu")
    enc = tblocks.SalsaResBlock(8, 12, device="cpu")
    m.add_module("enc", enc)
    gen = seed_dropout(m, 5)
    drops = [x for x in m.modules() if isinstance(x, Dropout)]
    assert len(drops) == 2 and all(x.generator is gen for x in drops)
    assert gen.initial_seed() == 5
