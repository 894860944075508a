"""The port's train/eval harness (`engine.Trainer` with loaders, the
checkpoints, evaluation, TTA and the CLI) on the CPU, in f32, against
itself and against the JAX package.

Small size: the `minkunet_tiny` recipe (cr 0.125, one block per stage,
voxel 0.2 m) on synthetic scans of 2 000 points (train, 2 per step) and
4 000 points (the recipe's val set of 8 scans).

- The loop adds nothing: `Trainer.train`'s per-step losses, grad norms
  and LRs equal, bit for bit, those of a second Trainer's `train_on`
  over the same collated batches, and the LRs equal JAX's
  `build_optimizer` schedule within 1e-6 relative (f32 schedule).
- A resume restores the parameters, BN buffers, momentum traces and the
  schedule's count bit for bit; the next step repeats the first
  Trainer's.
- Evaluation against JAX: the same weights (`init_params_numpy`, BN
  terms drawn at random) and the same val batches through JAX's MinkUNet
  eval forward; the per-point
  predictions must agree wherever JAX's top-2 logit gap is at least
  1e-4, and the histograms are equal once the points under that gap
  count the port's prediction (measured: 14 such points of the 32 000
  without TTA, 42 with 2 votes; at most 0.5% allowed).
"""

import copy
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu import data as jdata
from taseg_tpu.models import MinkUNet as JMinkUNet
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models import build_unet_topology as j_topology
from taseg_tpu.ops import PointSet
from taseg_tpu.optim import build_schedule as j_schedule
from taseg_tpu.utils.metrics import confusion_hist as j_confusion_hist
from taseg_tpu.utils.metrics import miou_from_hist as j_miou
from taseg_tpu_torch import data as tdata
from taseg_tpu_torch.configs import MINKUNET_TINY
from taseg_tpu_torch.data.semantickitti.labels import LEARNING_MAP_LUT
from taseg_tpu_torch.engine import Segmenter, Trainer, load_matching_params, to_device
from taseg_tpu_torch.optim import build_optimizer
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

REPO = Path(__file__).resolve().parents[1]
TINY = "tools/cfgs/voxel/synthetic/minkunet_tiny.yaml"
CFG = {**MINKUNET_TINY, "DATA": {**MINKUNET_TINY["DATA"], "LENGTH": 4, "N_RAW_POINTS": 2000}}
LABEL_KEYS = ("point_coords", "point_feats", "labels")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tiny model's ops gain nothing from torch's thread pool, and
    beside other test workers its threads, the loader's producer thread
    and the GIL slow each other down; one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jsonl_metrics_only(monkeypatch):
    """`utils.tb.MetricsWriter` writes TensorBoard files where
    `torch.utils.tensorboard` imports; that import loads TensorFlow where
    it is installed (13 s on one idle core, minutes beside other test
    workers).  These tests read the JSONL mirror only."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


class Log:
    def __init__(self):
        self.lines = []

    def info(self, msg, *args):
        self.lines.append(msg % args if args else msg)


def _variables(cfg=CFG, seed=4):
    p, s = init_params_numpy(cfg, seed=seed)
    return {"params": p, "batch_stats": s}


def _trainer(tmp_path, cfg=CFG):
    train = tdata.build_dataloader(cfg["DATA"], training=True, scans_per_shard=2)
    return Trainer(
        cfg, _variables(cfg), "cpu", train_loader=train, total_epochs=2,
        output_dir=tmp_path, logger=Log(), compute_dtype="float32",
    )


def _state(tr):
    sd = {k: v.clone() for k, v in tr.model.state_dict().items()}
    traces = [tr.optimizer.state[p]["trace"].clone() for p in tr.model.parameters()]
    return sd, traces, tr.optimizer.count


def _jax_lrs(n, iters_per_epoch=2, total_epochs=2, batch=2):
    sched = j_schedule(CFG["OPTIM"], iters_per_epoch, total_epochs)
    return [float(CFG["OPTIM"]["LR_PER_SAMPLE"] * batch * sched(jnp.int32(i))) for i in range(n)]


def test_clipped_sgd_count_travels_in_its_state_dict():
    def make():
        torch.manual_seed(0)
        w = torch.nn.Parameter(torch.randn(5))
        return w, build_optimizer([w], {**CFG["OPTIM"], "LR": 0.1}, 3, 2)

    w, opt = make()
    for _ in range(4):
        w.grad = torch.ones(5)
        opt.step()
    sd = copy.deepcopy(opt.state_dict())  # state_dict() shares the traces
    assert sd["count"] == 4
    w2, opt2 = make()
    with torch.no_grad():
        w2.copy_(w)
    opt2.load_state_dict(sd)
    assert opt2.count == 4
    w.grad = w2.grad = torch.ones(5)
    assert opt.step()[1] == opt2.step()[1]
    torch.testing.assert_close(w, w2, rtol=0, atol=0)


def test_train_loop_equals_train_on(tmp_path):
    a = _trainer(tmp_path)
    hist = a.train()
    got = [s for epoch in hist for s in epoch["steps"]]
    assert len(got) == 4 and a.optimizer.count == 4
    assert [e for e, _ in a.ckptr.list_epochs(a.ckpt_dir)] == [0, 1]

    b = Trainer(CFG, _variables(), "cpu", iters_per_epoch=2, total_epochs=2,
                batch_size=2, point_capacity=2 * CFG["DATA"]["NUM_POINTS"],
                compute_dtype="float32", logger=Log())
    loader = tdata.build_dataloader(CFG["DATA"], training=True, scans_per_shard=2)
    want = [b.train_on(to_device(arrays, "cpu", LABEL_KEYS))
            for _ in range(2) for arrays, _ in loader]
    for g, w in zip(got, want):
        assert (g["loss"], g["grad_norm"], g["lr"]) == (w["loss"], w["grad_norm"], w["lr"])
        assert g["level_nums"] == w["level_nums"]
        assert g["data_s"] >= 0 and g["step_s"] > 0
    np.testing.assert_allclose([g["lr"] for g in got], _jax_lrs(4), rtol=1e-6)
    assert len(list((tmp_path / "metrics").glob("metrics.jsonl"))) == 1


def test_resume_is_bit_exact(tmp_path):
    a = _trainer(tmp_path)
    a.train_one_epoch(0)
    a.save_checkpoint(0)
    want = _state(a)

    c = _trainer(tmp_path)
    assert c.resume_latest() and c.start_epoch == 1
    sd, traces, count = _state(c)
    assert count == want[2] == 2
    assert sd.keys() == want[0].keys()
    for k in sd:
        assert torch.equal(sd[k], want[0][k]), k
    for x, y in zip(traces, want[1]):
        assert torch.equal(x, y)

    arrays = next(iter(tdata.build_dataloader(CFG["DATA"], training=True, scans_per_shard=2)))[0]
    out_a = a.train_on(to_device(dict(arrays), "cpu", LABEL_KEYS))
    out_c = c.train_on(to_device(dict(arrays), "cpu", LABEL_KEYS))
    assert (out_a["loss"], out_a["grad_norm"], out_a["lr"]) == (out_c["loss"], out_c["grad_norm"], out_c["lr"])
    assert out_c["lr"] == pytest.approx(_jax_lrs(3)[2], rel=1e-6)
    # the resumed run trains the remaining epoch only
    assert len(c.train()) == 1 and c.optimizer.count == 5


def test_checkpoints_pruned_and_pretrained_loaded(tmp_path):
    a = _trainer(tmp_path)
    for e in range(4):
        a.save_checkpoint(e, max_keep=2)
    assert [e for e, _ in a.ckptr.list_epochs(a.ckpt_dir)] == [2, 3]
    with torch.no_grad():
        for p in a.model.parameters():
            p.add_(0.25)
    a.save_checkpoint(4)
    flax_file = tmp_path / "flax.pt"
    p, s = export_flax_params(a.model)
    torch.save({"params": p, "batch_stats": s}, flax_file)
    for src in (a.ckpt_dir / "checkpoint_epoch_4", flax_file):
        d = _trainer(tmp_path / "d")
        d.load_pretrained(str(src), strict=True)
        for (k, x), y in zip(d.model.state_dict().items(), a.model.state_dict().values()):
            assert torch.equal(x, y), k
        assert d.logger.lines[-2].endswith("0 kept")


def test_load_matching_params_as_jax():
    """JAX's wrapper-scope case (tests/test_engine.py): the same matched
    and kept counts, in a nested tree and in a flat state dict."""
    from taseg_tpu.engine import load_matching_params as j_load

    src = {"stem_0": {"kernel": np.ones((3, 4))}, "classifier": {"kernel": np.full((4, 2), 2.0)}}
    dst = {
        "main": {"stem_0": {"kernel": np.zeros((3, 4))}, "classifier": {"kernel": np.zeros((4, 2))}},
        "image_backbone": {"conv": {"kernel": np.zeros((5, 5))}},
    }
    jl, tl = Log(), Log()
    want = j_load(dst, src, logger=jl)
    got = load_matching_params(dst, src, logger=tl)
    assert tl.lines == jl.lines == ["pretrained load: 2 matched, 1 kept"]
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for x, y in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(x, y)
    flat = {"main.stem_0.kernel": torch.zeros(3, 4), "main.classifier.kernel": torch.zeros(4, 2)}
    out = load_matching_params(flat, src, logger=tl)
    assert float(out["main.stem_0.kernel"][0, 0]) == 1.0 and tl.lines[-1].endswith("2 matched, 0 kept")
    with pytest.raises(KeyError):
        load_matching_params(dst, src, strict=True)


def test_capacity_overflow_raises_in_the_epoch(tmp_path):
    """The JAX loop warns and drops voxels (engine.py:607-624); the port's
    raises.  The default schedule is far too tight for the tiny scans."""
    m = {k: v for k, v in CFG["MODEL"].items() if k != "CAPACITY_SCHEDULE"}
    cfg = {**CFG, "MODEL": m, "DATA": {**CFG["DATA"], "N_RAW_POINTS": 4000}}
    tr = _trainer(tmp_path, cfg=cfg)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        tr.train()
    assert tr.ckptr.list_epochs(tr.ckpt_dir) == []


# ---------------------------------------------------------- eval against JAX
VAL_CFG = MINKUNET_TINY


def _eval_variables():
    """`init_params_numpy`'s weights with the BN affine terms and running
    statistics drawn at random, as tests/test_torch_minkunet.py draws
    them: the flax init makes BN near-identity and leaves the logits so
    close to each other that half the points' top-2 gaps fall under
    1e-4; with these the logits are O(1)."""
    v = _variables(VAL_CFG, seed=7)
    rng = np.random.default_rng(5)

    def draw(tree, stats):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = draw(x, stats)
            elif stats:
                out[k] = (rng.uniform(0.05, 0.15, x.shape) if k == "var"
                          else rng.normal(0, 0.05, x.shape)).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
            elif k == "bias" and x.shape[0] != 20:  # BN bias, not the head's
                out[k] = rng.normal(0, 0.1, x.shape).astype(np.float32)
            else:
                out[k] = x
        return out

    return {"params": draw(v["params"], False), "batch_stats": draw(v["batch_stats"], True)}


@pytest.fixture(scope="module")
def jax_eval():
    """JAX's eval forward of the tiny MinkUNet (f32) over JAX's val
    batches, plain and with 2 TTA votes: per scan (name, raw labels,
    per-point logits or summed vote probabilities), and the voxel-level
    histogram of `make_eval_step` with the count of its valid voxels
    whose top-2 logit gap is under 1e-4."""
    m = VAL_CFG["MODEL"]
    cap = VAL_CFG["DATA"]["NUM_POINTS"]
    caps = JCaps.for_points(cap, schedule=m["CAPACITY_SCHEDULE"])
    model = JMinkUNet(num_classes=20, cr=m["cr"], num_layer=tuple(m["NUM_LAYER"]),
                      block="ResBlock", compute_dtype="float32", dropout_p=0.0)
    variables = jax.tree_util.tree_map(jnp.asarray, _eval_variables())

    @jax.jit
    def fwd(coords, feats, labels, num):
        topo = j_topology(coords, num, caps, devox_pairs=False, assume_sorted_points=True)
        pts = PointSet(coords=coords, feats=feats, num=num)
        logits = model.apply(variables, pts, topo, False)
        valid = pts.valid_mask() & (labels != 0)
        top2 = jax.lax.top_k(logits, 2)[0]
        close = jnp.sum(valid & (top2[:, 0] - top2[:, 1] < 1e-4))
        hist = j_confusion_hist(jnp.argmax(logits, -1).astype(jnp.int32), labels, valid, 20)
        return logits, hist, close

    def run(arrays, meta):
        logits, h, close = fwd(*(jnp.asarray(arrays[k][0]) for k in LABEL_KEYS),
                               jnp.int32(arrays["num_points"][0, 0]))
        logits = np.asarray(logits)
        off = meta[0]["offsets"]
        out = [(s.name, s.raw_labels, logits[off[b]: off[b + 1]][s.inverse_map])
               for b, s in enumerate(meta[0]["samples"]) if not meta[0]["padded"][b]]
        return out, np.asarray(h, np.int64), int(close)

    loader = jdata.build_dataloader(VAL_CFG["DATA"], training=False, n_shards=1,
                                    scans_per_shard=1, point_capacity=cap)
    plain, vox_hist, vox_close = [], np.zeros((20, 20), np.int64), 0
    for arrays, meta in loader:
        out, h, close = run(arrays, meta)
        plain += out
        vox_hist += h
        vox_close += close
    tta = []
    for per_vote in loader.iter_tta(2):
        acc = {}
        for arrays, meta in per_vote:
            for name, raw, lg in run(arrays, meta)[0]:
                prob = np.asarray(jax.nn.softmax(jnp.asarray(lg), axis=-1))
                acc[name] = (raw, acc[name][1] + prob) if name in acc else (raw, prob)
        tta += [(n, raw, p) for n, (raw, p) in acc.items()]
    return {"plain": plain, "tta": tta, "voxel_hist": vox_hist, "voxel_close": vox_close}


def _port_evaluator(tmp_path):
    val = tdata.build_dataloader(VAL_CFG["DATA"], training=False, scans_per_shard=1,
                                 point_capacity=VAL_CFG["DATA"]["NUM_POINTS"])
    tr = Trainer(VAL_CFG, _eval_variables(), "cpu", iters_per_epoch=1,
                 val_loader=val, output_dir=tmp_path, logger=Log(), compute_dtype="float32")
    return tr


def _read_preds(save_path, name):
    f = Path(save_path) / "sequences" / "08" / "predictions" / (Path(name).stem + ".label")
    return LEARNING_MAP_LUT[np.fromfile(f, np.uint32)]


def _hist(labels, pred):
    keep = labels != 0
    return np.bincount(labels[keep] * 20 + pred[keep], minlength=400).reshape(20, 20)


@pytest.mark.parametrize("votes", [0, 2])
def test_evaluate_points_matches_jax(tmp_path, jax_eval, votes):
    """Per point, the port's prediction is JAX's wherever JAX's top-2 gap
    is at least 1e-4; the port's histogram is JAX's with the port's
    predictions at the other points.  Measured: 14 such points of the
    32 000 without TTA, 42 with 2 votes."""
    tr = _port_evaluator(tmp_path)
    out = tr.evaluate_points(tta_votes=votes, save_path=tmp_path / "preds")
    assert tr.model.training  # switched back after the eval forward
    scans = jax_eval["tta" if votes else "plain"]
    assert len(scans) == 8
    want = np.zeros((20, 20), np.int64)
    n_close = n_points = 0
    for name, raw, scores in scans:
        top2 = np.sort(scores, axis=1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] >= 1e-4
        n_close += int((~sure).sum())
        n_points += len(raw)
        jpred, tpred = scores.argmax(1), _read_preds(tmp_path / "preds", name)
        np.testing.assert_array_equal(tpred[sure], jpred[sure])
        want += _hist(raw, np.where(sure, jpred, tpred))
    assert n_points == 32000 and n_close <= 0.005 * n_points
    np.testing.assert_array_equal(out["hist"], want)
    assert out["miou"] == pytest.approx(j_miou(want), abs=1e-12)


def test_evaluate_matches_jax_voxel_hist(tmp_path, jax_eval):
    """The voxel-level histogram is JAX's but for the valid voxels whose
    top-2 gap in JAX is under 1e-4 (each moves one count; measured: 14 of
    the 29 064)."""
    tr = _port_evaluator(tmp_path)
    out = tr.evaluate()
    close = jax_eval["voxel_close"]
    assert close <= 0.005 * jax_eval["voxel_hist"].sum()
    assert np.abs(out["hist"] - jax_eval["voxel_hist"]).sum() <= 2 * close
    assert out["hist"].sum() == jax_eval["voxel_hist"].sum()
    assert any("IoU" in line for line in tr.logger.lines)


def test_evaluate_points_equals_segmenter(tmp_path):
    """Trainer's evaluation runs Segmenter's stages: the same logits bit
    for bit (the .bin files of --save_score) and predictions."""
    tr = _port_evaluator(tmp_path)
    tr.evaluate_points(save_path=tmp_path / "p", save_score=True)
    p, s = export_flax_params(tr.model)
    seg = Segmenter(VAL_CFG, {"params": p, "batch_stats": s}, "cpu", compute_dtype="float32",
                    point_capacity=VAL_CFG["DATA"]["NUM_POINTS"])
    reader = tr.val_loader.reader
    got = seg.predict([reader[i] for i in range(len(reader))])
    for i, o in enumerate(got):
        f = tmp_path / "p" / "sequences" / "08" / "predictions" / f"{i:06d}"
        logits = np.fromfile(f.with_suffix(".bin"), np.float32).reshape(o["logits"].shape)
        assert np.array_equal(logits.view(np.uint32), o["logits"].view(np.uint32))
        np.testing.assert_array_equal(_read_preds(tmp_path / "p", f"{i:06d}.bin"), o["labels"])


# ---------------------------------------------------------------------- CLI
def test_cli_trains_resumes_and_writes_submissions(tmp_path, monkeypatch):
    from taseg_tpu_torch.train import main

    monkeypatch.chdir(tmp_path)
    main(["--cfg_file", TINY, "--epochs", "1", "--device", "cpu"])
    run = tmp_path / "output" / "minkunet_tiny" / "default"
    assert (run / "ckpt" / "checkpoint_epoch_0").is_file()
    log = (run / "log.txt").read_text()
    assert "eval per-class IoU" in log and "saved checkpoint" in log

    main(["--cfg_file", TINY, "--eval", "--tta", "--votes_max", "2",
          "--save_path", "preds", "--device", "cpu"])
    log = (run / "log.txt").read_text()
    assert "resumed from" in log and "point-eval mIoU" in log and "RANDOM" not in log
    files = sorted((tmp_path / "preds" / "sequences" / "08" / "predictions").glob("*.label"))
    assert len(files) == 8
    raw = [np.fromfile(f, np.uint32) for f in files]
    assert all(len(r) == 4000 for r in raw)
    assert set(np.unique(np.concatenate(raw))) <= {10, 11, 15, 18, 20, 30, 31, 32, 40, 44,
                                                   48, 49, 50, 51, 70, 71, 72, 80, 81}

    r = subprocess.run(
        [sys.executable, "-m", "taseg_tpu_torch.tta_remap", "--path", "preds",
         "--direction", "raw_to_train"],
        cwd=tmp_path, env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0 and "remapped 8 label files" in r.stdout, r.stderr
    for f, before in zip(files, raw):
        np.testing.assert_array_equal(np.fromfile(f, np.uint32), LEARNING_MAP_LUT[before])
