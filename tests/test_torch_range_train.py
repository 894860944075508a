"""The range view's `Trainer` kind in the port against JAX's
`make_range_train_step` (`parallel/range_step.py`), and its harness.

  * Two f32 steps of SalsaNext at base 8 on 16 x 128 images, batch 2,
    adamW over the onecycle schedule (the recipes' optimizer), the port's
    augmented shard fed to both, dropout the identity on both sides
    (patched here; the JAX package does not change); and one step of
    CENet with its aux heads (1.25 x main + 3 aux terms, top-k 0.5 on the
    main term only).  Tolerances from measurement: the step is
    ill-conditioned (the boundary loss's max pools tie over the flat
    regions of empty pixels, a subgradient that flips): in the port alone
    a 1e-7 relative change of the weights moves SalsaNext's step-0 grad
    norm by 3.5e-3 (full width, 16 x 128), and Adam's first steps move
    every weight by about the LR whatever the size of its gradient, so a
    near-zero gradient that changes sign moves its weight by twice the
    LR: a 1e-7 relative change of the weights moves the port's own update
    by 1.1e-2 and 1.3e-2 of its L2 norm at SalsaNext's steps 0 and 1 (base
    8) and CENet's by 3.7e-2.  So: the loss within 1e-5 relative at step
    0 and 1e-3 at step 1, the grad norm within 2e-2, the parameters after
    each step within 5e-2 (SalsaNext) and 0.15 (CENet) of the update's
    L2 norm, the BN statistics within 1e-4 of their scale after step 0
    and 5e-2 after step 1 (`TOL`).
  * `evaluate()` (pixel histogram) equal to one built from JAX's
    `make_range_eval_step` logits' argmax; `evaluate_points` writes one
    .label file of raw ids per scan, its labels K9's: equal to JAX's
    `knn_postprocess` on the port's pixel argmax, and to
    `Segmenter.predict` on the same weights and scans.
  * The CLI on `salsanext_tiny` (train one epoch, then `--eval
    --save_path`), the recipes: salsanext_res34, fidnet_res34 and
    rangenet_darknet53 build at their widths; cenet_res34 raises, naming
    the nuScenes reader.

JAX's steps are jitted once per model.  ~55 s in one process, 122 s in
the 6-worker tier-1 run.
"""

import subprocess
import sys
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec
from torch_range_narrow import narrow_range_models

from taseg_tpu.models.range2d import CENet as JCENet
from taseg_tpu.models.range2d import SalsaNext as JSalsaNext
from taseg_tpu.models.range2d.postproc import knn_postprocess as j_knn
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.parallel import TrainState, make_mesh
from taseg_tpu.parallel.range_step import RangeBatch, make_range_eval_step, make_range_train_step
from taseg_tpu_torch.data import build_dataloader
from taseg_tpu_torch.data.synthetic import SyntheticKittiReader
from taseg_tpu_torch.engine import Segmenter, Trainer, _NullWriter
from taseg_tpu_torch.loss.range import range_class_weights
from taseg_tpu_torch.models.layers import Dropout
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

REPO = Path(__file__).resolve().parents[1]
H, W, B = 16, 128, 2
SCHED = dict(iters_per_epoch=5, total_epochs=2)
OPTIM = {
    "OPTIMIZER": "adamW", "WEIGHT_DECAY": 0.01, "LR_PER_SAMPLE": 0.0025, "GRAD_NORM_CLIP": 10.0,
    "SCHEDULER": "onecycle", "NUM_EPOCHS": 2,
}
DATA = {"DATASET": "synthetic", "LENGTH": 3, "N_RAW_POINTS": 3000, "H": H, "W": W}


def cfg_of(name: str, **model) -> dict:
    return {
        "MODALITY": "range", "DATA": dict(DATA),
        "MODEL": {"NAME": name, "NUM_CLASS": 20, "IN_FEATURE_DIM": 6, "IGNORE_LABEL": 0,
                  "LOSS_CONFIG": {"TOP_K_PERCENT": 1.0, "LS_WEIGHT": 3.0, "BD_WEIGHT": 1.0}, **model},
        "OPTIM": dict(OPTIM),
    }


SALSA = cfg_of("SalsaNext")
CENET = cfg_of("CENet", IF_AUX=True)
CENET["MODEL"]["LOSS_CONFIG"]["TOP_K_PERCENT"] = 0.5


@pytest.fixture(autouse=True, scope="module")
def _narrow():
    """SalsaNext at base 8 in the Trainer, Segmenter and
    `init_params_numpy` (`torch_range_narrow`); the CLI's subprocess
    builds the recipe's."""
    with narrow_range_models(SalsaNext={"base": 8}):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float64)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _scans(n, seed):
    reader = SyntheticKittiReader(length=n, n_points=3000, seed=seed)
    return [reader[i] for i in range(n)]


def _steps(cfg, jmodel, n_steps):
    """(port results, JAX results, initial params) of n_steps on the same
    shards."""
    lw = cfg["MODEL"]["LOSS_CONFIG"]
    p, s = init_params_numpy(cfg, seed=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
        mp.setattr(Dropout, "forward", lambda self, x: x)
        tr = Trainer(cfg, {"params": p, "batch_stats": s}, device="cpu", batch_size=B, seed=9, **SCHED)
        tx = j_build_optimizer({**cfg["OPTIM"], "LR": 0.0025 * B}, SCHED["iters_per_epoch"],
                               SCHED["total_epochs"], clip_grad_norm=10.0)
        mesh = make_mesh(jax.devices()[:1])
        step = make_range_train_step(
            jmodel, tx, mesh, jnp.asarray(range_class_weights("synthetic", 20)),
            top_k_percent=lw["TOP_K_PERCENT"], ls_weight=lw["LS_WEIGHT"], bd_weight=lw["BD_WEIGHT"],
            aux=bool(cfg["MODEL"].get("IF_AUX", False)), donate=False,
        )
        jp = jax.tree_util.tree_map(jnp.asarray, p)
        state = jax.device_put(TrainState(
            params=jp, batch_stats=jax.tree_util.tree_map(jnp.asarray, s),
            opt_state=tx.init(jp), step=jnp.int32(0),
        ), NamedSharding(mesh, PartitionSpec()))
        got, want = [], []
        for i in range(n_steps):
            arrays = tr.collate(_scans(B, 10 + i), _scans(B, 20 + i))
            batch = RangeBatch(**{k: jnp.asarray(arrays[k][None]) for k in ("scan", "label", "mask")})
            state, metrics = step(state, batch, jax.random.PRNGKey(i))
            w = {k: float(v) for k, v in metrics.items()}
            w["variables"] = jax.tree_util.tree_map(np.asarray, (state.params, state.batch_stats))
            want.append(w)
            g = tr.train_on(arrays)
            g["variables"] = export_flax_params(tr.model)
            got.append(g)
    return got, want, p


# per model and step: (loss rel, grad norm rel, update L2 rel, BN
# statistics rel); the update's, ~4x what a 1e-7 relative change of the
# weights does to the port alone here (SalsaNext 1.1e-2 and 1.3e-2 of the
# update at steps 0 and 1, CENet 3.7e-2); step 1's BN statistics are
# taken with step 0's weights (measured 1.7e-2 of their scale)
TOL = {
    "salsanext": [(1e-5, 2e-2, 5e-2, 1e-4), (1e-3, 2e-2, 5e-2, 5e-2)],
    "cenet": [(1e-5, 2e-2, 0.15, 1e-4)],
}


@pytest.mark.parametrize("name", ["salsanext", "cenet"])
def test_steps_match_jax(name):
    cfg, jmodel, n = (SALSA, JSalsaNext(20, base=8), 2) if name == "salsanext" else (CENET, JCENet(20), 1)
    got, want, p0 = _steps(cfg, jmodel, n)
    prev = _flat(p0)
    for i, (g, w, (tl, tn, tu, tb)) in enumerate(zip(got, want, TOL[name])):
        assert np.isfinite(g["loss"]) and np.isfinite(g["grad_norm"]) and g["level_nums"] == []
        assert g["loss"] == pytest.approx(w["loss"], rel=tl), i
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=tn), i
        (p, s), (jp, js) = g["variables"], w["variables"]
        a, b = _flat(p), _flat(jp)
        assert a.keys() == b.keys()
        diff = np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in a))
        upd = np.sqrt(sum(np.sum((b[k] - prev[k]) ** 2) for k in a))
        assert diff <= tu * upd, (i, diff, upd)
        sa, sb = _flat(s), _flat(js)
        assert sa.keys() == sb.keys()
        for k in sa:
            assert np.abs(sa[k] - sb[k]).max() <= tb * max(np.abs(sb[k]).max(), 1e-3), (i, k)
        prev = b


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("range_eval")
    p, s = init_params_numpy(SALSA, seed=2)
    variables = {"params": p, "batch_stats": s}
    val = build_dataloader(DATA, training=False, scans_per_shard=2, modality="range")
    tr = Trainer(SALSA, variables, device="cpu", iters_per_epoch=1, val_loader=val, output_dir=tmp)
    tr._writer = _NullWriter()  # TensorBoard's import alone takes ~15 s here
    hist = tr.evaluate()["hist"]
    res = tr.evaluate_points(save_path=tmp / "preds")
    return tr, variables, val, hist, res, tmp


def test_evaluate_is_jax_pixel_histogram(evaluated):
    tr, variables, val, hist, _, _ = evaluated
    ev = make_range_eval_step(JSalsaNext(20, base=8), make_mesh(jax.devices()[:1]), 20)
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    want = np.zeros((20, 20), np.int64)
    for arrays, _ in val:
        batch = RangeBatch(**{k: jnp.asarray(arrays[k][None]) for k in ("scan", "label", "mask")})
        h, _ = ev(v["params"], v["batch_stats"], batch)
        want += np.asarray(h, np.int64)
    assert want.sum() > 0
    # per-pixel argmax ties are measure-zero: the histograms are equal
    np.testing.assert_array_equal(hist, want)


def test_evaluate_points_writes_knn_labels(evaluated):
    tr, variables, val, _, res, tmp = evaluated
    files = sorted((tmp / "preds").rglob("*.label"))
    assert len(files) == DATA["LENGTH"] and res["hist"].sum() > 0
    seg = Segmenter(SALSA, variables, device="cpu", batch_size=2)
    reader = val.reader
    scans = [reader[i] for i in range(len(reader))]
    pred = seg.predict(scans)
    from taseg_tpu_torch.data.semantickitti.labels import train_to_raw

    for f, s, o in zip(files, scans, pred):
        raw = np.fromfile(f, dtype=np.uint32)
        assert raw.shape == (len(s["labels"]),)
        np.testing.assert_array_equal(raw, train_to_raw(o["labels"]))
        assert o["logits"].shape == (len(s["labels"]), 20) and o["labels"].dtype == np.int32
    # K9's labels against JAX's knn_postprocess on the port's pixel argmax
    seg = Segmenter(SALSA, variables, device="cpu")
    pred = seg.predict(scans[:1])
    arrays = seg.collate(scans[:1])
    logits = seg.forward(arrays, None)
    pix = logits.argmax(-1).to(torch.int32)[0].numpy()
    want = np.asarray(j_knn(
        jnp.asarray(arrays["scan"][0, :, :, 4] * 80.0), jnp.asarray(arrays["unproj_range"]),
        jnp.asarray(pix), jnp.asarray(arrays["px"]), jnp.asarray(arrays["py"]), num_classes=20,
    ))
    np.testing.assert_array_equal(pred[0]["labels"], want)
    # the logits of each point are its pixel's
    lg = logits[0].numpy()
    np.testing.assert_array_equal(pred[0]["logits"], lg[arrays["py"], arrays["px"]])


def test_recipes_build_and_cenet_raises(tmp_path):
    from taseg_tpu_torch.models import FIDNet, RangeNet, SalsaNext, build_segmentor
    from taseg_tpu_torch.train import check_ported
    from taseg_tpu_torch.utils.config import load_config

    for path, cls in (("salsanext_res34", SalsaNext), ("fidnet_res34", FIDNet), ("rangenet_darknet53", RangeNet)):
        cfg = load_config(f"tools/cfgs/range/semantic_kitti/{path}.yaml")
        assert check_ported(cfg) == "range"
        m = build_segmentor(cfg, device="meta")
        assert isinstance(m, cls)
        with pytest.raises(ValueError, match="float32"):
            build_segmentor(cfg, device="meta", compute_dtype="bfloat16")
    # CENet's nuScenes recipe: ported since the nuScenes reader (a tree of
    # `torch_nuscenes_fixture`); an unknown dataset still raises
    from torch_nuscenes_fixture import make_nuscenes_root

    from taseg_tpu_torch.models import CENet

    cfg = load_config("tools/cfgs/range/nuscenes/cenet_res34.yaml")
    assert check_ported(cfg) == "range"
    assert isinstance(build_segmentor(cfg, device="meta"), CENet)
    root = make_nuscenes_root(tmp_path / "nus", n_key=2, splits=("train",), jpeg_hw=None)
    loader = build_dataloader({**cfg.DATA, "DATA_PATH": str(root), "H": 16, "W": 64}, training=True,
                              scans_per_shard=1, modality="range")
    assert len(loader) == 2
    with pytest.raises(NotImplementedError, match="dataset"):
        build_dataloader({**cfg.DATA, "DATASET": "kitti360"}, training=True, scans_per_shard=1,
                         modality="range")


def test_cli_trains_and_evaluates_salsanext_tiny(tmp_path):
    cmd = [sys.executable, "-m", "taseg_tpu_torch.train", "--cfg_file",
           "tools/cfgs/range/synthetic/salsanext_tiny.yaml", "--device", "cpu"]
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1"}
    r = subprocess.run(cmd + ["--epochs", "1"], cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    log = (tmp_path / "output/salsanext_tiny/default/log.txt").read_text()
    assert "epoch 0 mean loss" in log and "saved checkpoint" in log and "mIoU" in log
    r = subprocess.run(cmd + ["--eval", "--save_path", "preds"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    files = sorted((tmp_path / "preds").rglob("*.label"))
    assert len(files) == 8
    assert all(np.fromfile(f, dtype=np.uint32).shape == (4000,) for f in files)
