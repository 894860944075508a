"""The port's torchsparse checkpoint converter (`taseg_tpu_torch.utils.
ckpt_convert`) against the JAX package's, on the CPU.

A torchsparse-layout MinkUNet state dict (the reference's module names,
`stem.0.kernel`, `stage2.1.net.3.kernel`, `up1.1.0.downsample.1.running_
var`, `classifier.0.weight` as a torch Linear's (C_out, C_in), ...) is
built in the test from seeded weights, for the ResBlock and the
Bottleneck tiny MinkUNets.  It goes through the port's
`translate_minkunet_state` / `load_minkunet_state` and through JAX's
`translate_minkunet_state` + the port's `load_flax_params`: the trees are
equal to the bit (and to the weights the state dict was made from), and
the two port models give the same logits, bit for bit, on a small
synthetic scan.  About 15 s alone (`--durations`), most of it the
two tiny MinkUNets' forwards; 11 s in the 6-worker tier-1 run.
"""

import numpy as np
import pytest
import torch

from taseg_tpu.utils.ckpt_convert import translate_minkunet_state as j_translate
from taseg_tpu_torch.configs import MINKUNET_TINY
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.engine import Segmenter
from taseg_tpu_torch.models import build_segmentor
from taseg_tpu_torch.utils.ckpt_convert import load_minkunet_state, translate_minkunet_state
from taseg_tpu_torch.utils.params_from_jax import _flatten, export_flax_params, init_params_numpy

NUM_LAYER = [1, 2, 1, 1, 1, 1, 2, 1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(block: str) -> dict:
    return {**MINKUNET_TINY, "MODEL": {**MINKUNET_TINY["MODEL"], "BLOCK": block, "NUM_LAYER": NUM_LAYER}}


def _to_torchsparse(params: dict, stats: dict) -> dict:
    """The reference's state dict of the port's MinkUNet trees: a block's
    k-th conv and BN at `net.{3k}` / `net.{3k+1}` (conv, BN, ReLU per
    stage of the block), its projection at `downsample.{0,1}`."""
    p, s = _flatten(params), _flatten(stats)
    sd = {}

    def conv(ref, scope):
        sd[f"{ref}.kernel"] = torch.from_numpy(p[f"{scope}/kernel"].copy())

    def bn(ref, scope):
        for a, b in (("weight", "scale"), ("bias", "bias")):
            sd[f"{ref}.{a}"] = torch.from_numpy(p[f"{scope}/{b}"].copy())
        for a, b in (("running_mean", "mean"), ("running_var", "var")):
            sd[f"{ref}.{a}"] = torch.from_numpy(s[f"{scope}/{b}"].copy())
        sd[f"{ref}.num_batches_tracked"] = torch.tensor(0)

    def block(ref, scope):
        n_conv = len({k.split("/")[1] for k in p if k.startswith(scope + "/SparseConv_")})
        bottleneck = p[f"{scope}/SparseConv_0/kernel"].ndim == 2  # its first conv is 1x1
        n_main = 3 if bottleneck else 2
        proj = n_conv > n_main
        for k in range(n_main):
            conv(f"{ref}.net.{3 * k}", f"{scope}/SparseConv_{k}")
            bn(f"{ref}.net.{3 * k + 1}", f"{scope}/MaskedBatchNorm_{k}")
        if proj:
            conv(f"{ref}.downsample.0", f"{scope}/SparseConv_{n_main}")
            bn(f"{ref}.downsample.1", f"{scope}/MaskedBatchNorm_{n_main}")

    conv("stem.0", "stem_0/SparseConv_0")
    bn("stem.1", "stem_0/MaskedBatchNorm_0")
    conv("stem.3", "stem_1/SparseConv_0")
    bn("stem.4", "stem_1/MaskedBatchNorm_0")
    for l in range(1, 5):
        conv(f"stage{l}.0.net.0", f"down{l}/SparseConv_0")
        bn(f"stage{l}.0.net.1", f"down{l}/MaskedBatchNorm_0")
        for i in range(NUM_LAYER[l - 1]):
            block(f"stage{l}.{i + 1}", f"stage{l}_{i}")
    for n in range(1, 5):
        conv(f"up{n}.0.net.0", f"up{n}_deconv/SparseConv_0")
        bn(f"up{n}.0.net.1", f"up{n}_deconv/MaskedBatchNorm_0")
        for i in range(NUM_LAYER[3 + n]):
            block(f"up{n}.1.{i}", f"up{n}_blocks_{i}")
    sd["classifier.0.weight"] = torch.from_numpy(p["classifier/kernel"].T.copy())
    sd["classifier.0.bias"] = torch.from_numpy(p["classifier/bias"].copy())
    return sd


def _equal_trees(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].dtype == np.float32 and np.array_equal(fa[k], fb[k]), k


@pytest.mark.parametrize("block", ["ResBlock", "Bottleneck"])
def test_converter_matches_jax(block):
    cfg = _cfg(block)
    params, stats = init_params_numpy(cfg, seed=6)
    rng = np.random.default_rng(6)
    for k, v in _flatten(stats).items():  # running statistics other than 0 / 1
        *path, leaf = k.split("/")
        node = stats
        for part in path:
            node = node[part]
        node[leaf] = (rng.uniform(0.5, 1.5, v.shape) if leaf == "var" else rng.normal(size=v.shape)).astype(np.float32)
    sd = _to_torchsparse(params, stats)
    tp, ts = translate_minkunet_state(sd, NUM_LAYER)
    jp, js = j_translate(sd, NUM_LAYER)
    _equal_trees(tp, jp)
    _equal_trees(ts, js)
    _equal_trees(tp, params)
    _equal_trees(ts, stats)
    a = build_segmentor(cfg, device="cpu")
    load_minkunet_state(a, sd, NUM_LAYER)
    ea = export_flax_params(a)
    _equal_trees(ea[0], params)
    _equal_trees(ea[1], stats)


def test_converted_models_give_the_same_logits():
    cfg = _cfg("ResBlock")
    params, stats = init_params_numpy(cfg, seed=8)
    sd = _to_torchsparse(params, stats)
    pts, labels = synthetic_scan(np.random.default_rng(2), 3000)
    scan = {"xyzret": np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1), "labels": labels}
    logits = []
    for tp, ts in (translate_minkunet_state(sd, NUM_LAYER), j_translate(sd, NUM_LAYER)):
        seg = Segmenter(cfg, {"params": tp, "batch_stats": ts}, device="cpu")
        logits.append(seg.predict([scan])[0]["logits"])
    assert logits[0].shape == (len(pts), 20) and np.isfinite(logits[0]).all()
    np.testing.assert_array_equal(logits[0], logits[1])
