"""The cr 1.6 recipes in the port against the JAX package.

The five cr 1.6 recipes (MinkUNet and SPVCNN mk34 on SemanticKITTI and
Waymo, and Waymo's xyz-only MinkUNet) load through
`utils.config.load_config` as their YAML files say and build their stems
at the widths JAX's loader gives them (4; 3 for `_xyz`), at full width.
A narrow cr 1.6 MinkUNet and SPVCNN (`torch_cr16_narrow`: PLANES [8, 8,
16, 32, 64, 64, 32, 24, 24] at cr 1.6 make widths 12, 12, 25, 51, 102,
102, 51, 38, 38, and the decoder concatenates 153, 76 and 50; one block
a stage) take the same numpy scans and parameters as JAX's: their eval
logits and one f32 train step against `make_train_step`.  On the CPU the
wrappers run their plain versions, which take any width; on the card the
same convs take the padded tensor-core routes (`test_torch_cuda.py`).

Tolerances (f32), measured values in brackets (MinkUNet / SPVCNN, the
latter in `test_torch_cr16_spvcnn.py`): eval logits within 1e-4 of the
logit scale [5.6e-6 / 6.4e-6]; the step's loss within 5e-5 relative [0 /
0], its grad norm within 5e-4 [3.9e-5 / 9.2e-6], the parameters' update
within 3e-2 of its L2 norm [7.9e-3 / 2.2e-3] and the BN statistics
within 1e-4 of their scale [3.5e-6 / 3.9e-6], as `test_torch_spvcnn.py`
holds the first step.  JAX's references are jitted once (the eval
forward at XLA backend optimisation level 0, the step at level 1: level
0 gives it a NaN grad norm); torch runs on one thread.  ~65 s for the
file on one worker, ~48 s of it JAX tracing and compiling the step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_cr16_narrow import CR16_RECIPES, narrow_cr16

from taseg_tpu.data.voxel_dataset import VoxelPipeline as JPipeline
from taseg_tpu.data.voxel_dataset import collate_shard as j_collate
from taseg_tpu.loss import Losses as JLosses
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models import build_segmentor as j_build
from taseg_tpu.models import build_unet_topology as j_topology
from taseg_tpu.ops import PointSet
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.parallel import Batch, TrainState, make_mesh, make_train_step
from taseg_tpu_torch.configs import RECIPES
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.engine import Segmenter, Trainer
from taseg_tpu_torch.models import build_segmentor, stem_width
from taseg_tpu_torch.models.layers import SparseConv
from taseg_tpu_torch.utils import config as tcfg
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CAP = 2048
SCHEDULE = (1.0,) * 5
SCHED = dict(iters_per_epoch=2, total_epochs=3)
MODELS = {
    "MinkUNet": CR16_RECIPES[0],  # voxel/semantic_kitti/minkunet_mk34_cr16
    "SPVCNN": CR16_RECIPES[3],  # fusion/semantic_kitti/spvcnn_mk34_cr16
}


def _cfg(name):
    return narrow_cr16(MODELS[name], CAPACITY_SCHEDULE=SCHEDULE, TRAIN_CAPACITY_SCHEDULE=SCHEDULE)


def _jax_model(name):
    # IF_DIST names a mesh axis; one device without it is the same BN
    return j_build({**_cfg(name)["MODEL"], "IF_DIST": False}, 20)


def _topo_kwargs(name):
    kw = {"assume_sorted_points": True}
    if name == "SPVCNN":
        kw["point_voxel_strides"] = (1, 4, 16)
    return kw


def _scans(seed=21, n=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts, labels = synthetic_scan(rng, 900)
        ring = np.zeros((len(pts), 1), np.float32)
        out.append({"xyzret": np.concatenate([pts, ring], 1), "labels": labels})
    return out


def _randomize_bn(tree, rng, kind):
    """BN statistics and affine terms (and the Dense biases) at random, so
    that the logits are O(1) (flax's init leaves them near zero)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng, kind)
            continue
        v = np.array(v, np.float32)
        if kind == "stats":
            v = rng.uniform(0.05, 0.15, v.shape) if k == "var" else rng.normal(0, 0.05, v.shape)
        elif k == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k == "bias" and v.shape[0] != 20:  # not the head's
            v = rng.normal(0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("path", CR16_RECIPES)
def test_cr16_recipes_load_and_build_their_stems(path):
    """Each cr 1.6 recipe loads from the registry as its entry, at cr 1.6
    and mk34 depth, and its model (built here at full width on the meta
    device: no memory) has the stem `models.stem_width` gives, the widths
    int(1.6 x PLANES), none a multiple of 8, and 48 convs of 27 offsets."""
    cfg = tcfg.load_config(path)
    assert cfg.TAG == path.rsplit("/", 1)[1][: -len(".yaml")]
    assert {k: v for k, v in cfg.items() if k != "TAG"} == tcfg.Config.wrap(RECIPES[path])
    m = cfg["MODEL"]
    assert m["cr"] == 1.6 and m["NUM_LAYER"] == [2, 3, 4, 6, 2, 2, 2, 2]
    want_stem = 3 if path.endswith("_xyz.yaml") else 4
    assert stem_width(RECIPES[path], 4) == want_stem
    model = build_segmentor(RECIPES[path], device="meta")
    k3 = [x for x in model.modules() if isinstance(x, SparseConv) and x.kernel_volume == 27]
    assert len(k3) == 48 and k3[0].in_channels == want_stem
    widths = {int(1.6 * p) for p in m["PLANES"]}
    assert widths == {51, 102, 204, 409, 153}
    assert {x.out_channels for x in k3} == widths and not any(c % 8 == 0 for c in widths)


def _logits_against_jax(name):
    """f32 eval logits of the narrow cr 1.6 model `name`: the port's
    `Segmenter` against JAX's `apply` on the same points and weights (BN
    terms at random: O(1) logits)."""
    scans = _scans()
    arrays = j_collate([JPipeline(0.05, training=False)(s) for s in scans], CAP)
    coords = jnp.asarray(arrays["point_coords"])
    num = jnp.int32(arrays["num_points"][0])
    points = PointSet(coords=coords, feats=jnp.asarray(arrays["point_feats"]), num=num)
    caps = JCaps.for_points(CAP, schedule=SCHEDULE)
    topo = jax.jit(lambda c, n: j_topology(c, n, caps, **_topo_kwargs(name)))(coords, num)
    params, stats = init_params_numpy(_cfg(name), seed=3)
    r = np.random.default_rng(5)
    variables = {
        "params": _randomize_bn(params, r, "params"),
        "batch_stats": _randomize_bn(stats, r, "stats"),
    }
    model = _jax_model(name)
    fwd = jax.jit(lambda v, p: model.apply(v, p, topo, False)).lower(variables, points)
    logits = np.asarray(fwd.compile(compiler_options={"xla_backend_optimization_level": 0})(variables, points))
    off = arrays["offsets"]
    want = np.concatenate([logits[off[b] : off[b + 1]][s.inverse_map] for b, s in enumerate(arrays["samples"])])
    seg = Segmenter(_cfg(name), variables, device="cpu", compute_dtype="float32", batch_size=2,
                    point_capacity=CAP)
    got = np.concatenate([o["logits"] for o in seg.predict(scans)])
    assert got.shape == want.shape == (sum(len(s["labels"]) for s in scans), 20)
    scale = np.abs(want).max()
    assert scale > 0.5
    assert np.abs(got - want).max() <= 1e-4 * scale, np.abs(got - want).max() / scale


def _step_against_jax(name):
    """One f32 train step of the narrow cr 1.6 model `name` (SGD, warmup,
    the recipe's CE + Lovász loss) against `make_train_step` on the same
    collated shard: loss, grad norm, level counts, the updated parameters
    and BN statistics."""
    cfg = _cfg(name)
    params, stats = init_params_numpy(cfg, seed=4)
    tr = Trainer(cfg, {"params": params, "batch_stats": stats}, device="cpu", batch_size=2, seed=9,
                 compute_dtype="float32", point_capacity=CAP, **SCHED)
    criterion = JLosses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0,
                        label_smoothing=cfg["MODEL"]["LABEL_SMOOTHING"])
    tx = j_build_optimizer({**cfg["OPTIM"], "LR": cfg["OPTIM"]["LR_PER_SAMPLE"] * 2},
                           SCHED["iters_per_epoch"], SCHED["total_epochs"], clip_grad_norm=10.0)
    step = make_train_step(
        _jax_model(name), criterion, tx, JCaps.for_points(CAP, schedule=SCHEDULE),
        make_mesh(jax.devices()[:1]), donate=False, topo_kwargs=_topo_kwargs(name),
    )
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(params=jp, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(jp), step=jnp.int32(0))
    a = tr.collate(_scans())
    batch = Batch(
        point_coords=jnp.asarray(a["point_coords"][None]), point_feats=jnp.asarray(a["point_feats"][None]),
        labels=jnp.asarray(a["labels"][None]), num_points=jnp.asarray(a["num_points"].reshape(1, 1)),
    )
    key = jax.random.PRNGKey(0)
    compiled = step.lower(state, batch, key).compile(compiler_options={"xla_backend_optimization_level": 1})
    state, metrics = compiled(state, batch, key)
    got = tr.train_on(a)
    assert got["loss"] == pytest.approx(float(metrics["loss"]), rel=5e-5)
    assert got["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=5e-4)
    assert got["level_nums"] == np.asarray(metrics["level_nums"]).tolist()
    p, s = export_flax_params(tr.model)
    a_, b_, prev = _flat(p), _flat(state.params), _flat(params)
    assert a_.keys() == b_.keys()
    diff = np.sqrt(sum(np.sum((a_[k] - b_[k]).astype(np.float64) ** 2) for k in a_))
    upd = np.sqrt(sum(np.sum((b_[k] - prev[k]).astype(np.float64) ** 2) for k in a_))
    assert upd > 0 and diff <= 3e-2 * upd, (diff, upd)
    sa, sb = _flat(s), _flat(state.batch_stats)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert np.abs(sa[k] - sb[k]).max() <= 1e-4 * max(np.abs(sb[k]).max(), 1e-3), k


def test_cr16_minkunet_logits_match_jax():
    _logits_against_jax("MinkUNet")


def test_cr16_minkunet_train_step_matches_jax():
    _step_against_jax("MinkUNet")
