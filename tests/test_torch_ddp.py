"""The port's data parallelism (`taseg_tpu_torch.parallel`) on the CPU:
two gloo processes (`torch_ddp_worker.py`, started with
`torch.multiprocessing` and met through a `FileStore` in the test's
temporary directory, with a rendezvous timeout of 60 s and a wait of
240 s here, after which the ranks are killed and the test fails).

  * The plain train step of a tiny MinkUNet (cr 0.125, one block per
    stage, IF_DIST, dropout 0) over a global batch of 2 (one augmented
    ~900-point scan per rank, each in a 2048-row shard), 2 steps, against
    JAX's `make_train_step` on a 2-device mesh of the same shards (2 of
    the 8 CPU devices `conftest.py` sets up).  Tolerances (f32) as
    `test_torch_train.py`'s first two steps: loss within 5e-5 relative,
    grad norm within 1e-4, every parameter after step 0 within 1e-6 of
    its scale, the update within 1e-2 of its L2 norm, BN running
    statistics within 1e-4 of their scale; the level counts (maxed over
    the ranks) equal.  Both ranks end with the same bits.
  * The loader's per-process slices equal JAX's per-shard slices (eval:
    every array; train: the scans of each slice).
  * One KD step of the tiny KD recipe (IF_DIST): the ranks' parameters
    and BN statistics bit-identical after it.
  * `Trainer.evaluate()` over 2 processes (5 scans: the last global
    batch pads rank 1) gives the single-process confusion histogram.
  * The range kind: 2 adamW + onecycle steps of SalsaNext at base 8 on
    16 x 128 images, one augmented scan per rank, dropout off, against
    JAX's `make_range_train_step` on the 2-device mesh (its dropout
    patched to the identity here): the ranks' parameters bit-identical,
    step 0 as `test_torch_range_train.py` holds it, step 1 (ill-conditioned
    here: see RANGE_TOL) looser, rank 0's BN
    statistics (each rank keeps its own, as each device does in JAX,
    whose replicated output is device 0's) within its tolerances.

~75 s on one worker with the range case (~55 s before it; 286 s in the
6-worker tier-1 run), most of it JAX compiling and running the 2-device
steps while the two ranks run (at XLA's backend optimisation level 1: the
default level took ~95 s, level 0 gave a NaN grad norm).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_ddp_worker
from torch_range_narrow import narrow_range_models
from taseg_tpu.data import build_dataloader as j_build_dataloader
from taseg_tpu.loss import Losses as JLosses
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models import build_segmentor as j_build
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.models.range2d import SalsaNext as JSalsaNext
from taseg_tpu.parallel import Batch, TrainState, make_mesh, make_train_step
from taseg_tpu.parallel.range_step import RangeBatch, make_range_train_step
from taseg_tpu_torch.configs import MINKUNET_MS_KD_TINY, MINKUNET_TINY
from taseg_tpu_torch.data import build_dataloader
from taseg_tpu_torch.data.range_dataset import RangeViewPipeline
from taseg_tpu_torch.data.synthetic import SyntheticKittiReader, synthetic_scan
from taseg_tpu_torch.loss.range import range_class_weights
from taseg_tpu_torch.data.voxel_dataset import VoxelPipeline, collate_shard
from taseg_tpu_torch.engine import Trainer, _NullWriter
from taseg_tpu_torch.range_step import RANGE_KEYS
from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

WORLD = 2
WAIT_S = 240
CAP = 2048
STEPS = 2
KEYS = ("point_coords", "point_feats", "labels", "num_points")
CFG = {
    "DATA": {"VOXEL_SIZE": 0.05},
    "MODEL": {
        "NAME": "MinkUNet", "NUM_CLASS": 20, "IN_FEATURE_DIM": 4, "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock", "cr": 0.125, "NUM_LAYER": [1] * 8, "IF_DIST": True,
        "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96], "DROPOUT_P": 0.0,
        "LABEL_SMOOTHING": 0.1, "CAPACITY_SCHEDULE": (1.0,) * 5,
        "LOSS_CONFIG": {"LOSS_TYPES": ["CELoss", "LovLoss"], "LOSS_WEIGHTS": [1.0, 1.0]},
    },
    "OPTIM": {
        "OPTIMIZER": "sgd", "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 1e-4,
        "MOMENTUM": 0.9, "NESTEROV": True, "GRAD_NORM_CLIP": 10.0,
        "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1,
    },
}
SCHED = dict(iters_per_epoch=2, total_epochs=3)
KD_CFG = {
    **MINKUNET_MS_KD_TINY,
    "MODEL": {**MINKUNET_MS_KD_TINY["MODEL"], "CAPACITY_SCHEDULE": (1.0,) * 5, "IF_DIST": True},
}
EVAL_CFG = {**MINKUNET_TINY, "DATA": {**MINKUNET_TINY["DATA"], "LENGTH": 5}}
RANGE_CFG = {
    "MODALITY": "range",
    "DATA": {"DATASET": "synthetic", "H": 16, "W": 128},
    "MODEL": {
        "NAME": "SalsaNext", "NUM_CLASS": 20, "IN_FEATURE_DIM": 6, "IGNORE_LABEL": 0,
        "LOSS_CONFIG": {"TOP_K_PERCENT": 1.0, "LS_WEIGHT": 3.0, "BD_WEIGHT": 1.0},
    },
    "OPTIM": {"OPTIMIZER": "adamW", "WEIGHT_DECAY": 0.01, "LR_PER_SAMPLE": 0.0025,
              "GRAD_NORM_CLIP": 10.0, "SCHEDULER": "onecycle"},
}
RANGE_SCHED = dict(iters_per_epoch=5, total_epochs=2)
RANGE_WIDTHS = {"SalsaNext": {"base": 8}}
LOADER_DATA = {"DATASET": "synthetic", "LENGTH": 5, "N_RAW_POINTS": 2000, "VOXEL_SIZE": 0.2,
               "NUM_POINTS": 4096}


def _shards() -> list:
    """[step][rank] collated numpy shards of one augmented scan each."""
    rng = np.random.default_rng(21)
    pipe = VoxelPipeline(0.05, training=True, seed=3)
    out = []
    for _ in range(STEPS):
        row = []
        for _ in range(WORLD):
            pts, labels = synthetic_scan(rng, 900)
            ring = np.zeros((len(pts), 1), np.float32)
            scan = {"xyzret": np.concatenate([pts, ring], 1), "labels": labels}
            a = collate_shard([pipe(scan)], CAP)
            row.append({k: a[k] for k in KEYS})
        out.append(row)
    return out


def _range_shards() -> list:
    """[step][rank] collated range shards of one augmented scan each."""
    reader = SyntheticKittiReader(length=2 * STEPS * WORLD, n_points=3000, seed=5)
    pipe = RangeViewPipeline(16, 128, training=True, seed=3)
    return [
        [{k: v for k, v in pipe.collate([pipe(reader[2 * (i * WORLD + r)], reader[2 * (i * WORLD + r) + 1])]).items()
          if k in RANGE_KEYS} for r in range(WORLD)]
        for i in range(STEPS)
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two ranks, started (not joined) with every input they read."""
    tmp = tmp_path_factory.mktemp("ddp")
    shards = _shards()
    (tmp / "shards").mkdir()
    for i, row in enumerate(shards):
        for r, a in enumerate(row):
            np.savez(tmp / "shards" / f"step{i}_rank{r}.npz", **a)
    range_shards = _range_shards()
    for i, row in enumerate(range_shards):
        for r, a in enumerate(row):
            np.savez(tmp / "shards" / f"range_step{i}_rank{r}.npz", **a)
    with narrow_range_models(**RANGE_WIDTHS):
        rp = init_params_numpy(RANGE_CFG, seed=4)
    p, s = init_params_numpy(CFG, seed=4)
    kd_s, kd_t = init_params_numpy(KD_CFG, seed=4), init_params_numpy(KD_CFG, seed=5)
    ev = init_params_numpy(EVAL_CFG, seed=3)
    spec = {
        "step": {"cfg": CFG, "params": {"params": p, "batch_stats": s}, "global_batch": WORLD,
                 "cap": CAP, "steps": STEPS, **SCHED},
        "kd": {"cfg": KD_CFG, "student": {"params": kd_s[0], "batch_stats": kd_s[1]},
               "teacher": kd_t, "cap": 8192},
        "eval": {"cfg": EVAL_CFG, "params": {"params": ev[0], "batch_stats": ev[1]},
                 "output_dir": str(tmp / "eval")},
        "range": {"cfg": RANGE_CFG, "widths": RANGE_WIDTHS,
                  "params": {"params": rp[0], "batch_stats": rp[1]},
                  "global_batch": WORLD, "steps": STEPS, **RANGE_SCHED},
    }
    ctx = mp.start_processes(
        torch_ddp_worker.run, args=(WORLD, str(tmp), spec), nprocs=WORLD, join=False,
        start_method="spawn",
    )
    state = {"tmp": tmp, "shards": shards, "range_shards": range_shards, "ctx": ctx, "spec": spec,
             "out": None}
    yield state
    for proc in ctx.processes:
        if proc.is_alive():
            proc.kill()
        proc.join(5)


def _results(state) -> list:
    """Each rank's outputs, once both have exited (within WAIT_S)."""
    if state["out"] is None:
        ctx, deadline = state["ctx"], time.monotonic() + WAIT_S
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                pytest.fail(f"the {WORLD} ranks did not finish within {WAIT_S} s")
        state["out"] = [torch.load(state["tmp"] / f"out_rank{r}.pt", weights_only=False)
                        for r in range(WORLD)]
    return state["out"]


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jax_steps(shards, params, stats) -> list:
    criterion = JLosses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0, label_smoothing=0.1)
    tx = j_build_optimizer(
        {**CFG["OPTIM"], "LR": 0.02 * WORLD}, SCHED["iters_per_epoch"], SCHED["total_epochs"],
        clip_grad_norm=10.0,
    )
    model = j_build(CFG["MODEL"], 20)
    assert model.axis_name == "data"  # IF_DIST: BN statistics psum-ed
    step = make_train_step(
        model, criterion, tx, JCaps.for_points(CAP, schedule=CFG["MODEL"]["CAPACITY_SCHEDULE"]),
        make_mesh(jax.devices()[:WORLD]), donate=False, topo_kwargs={"assume_sorted_points": True},
    )
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(
        params=jp, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
        opt_state=tx.init(jp), step=jnp.int32(0),
    )
    want, compiled = [], None
    for i, row in enumerate(shards):
        batch = Batch(
            point_coords=jnp.asarray(np.stack([a["point_coords"] for a in row])),
            point_feats=jnp.asarray(np.stack([a["point_feats"] for a in row])),
            labels=jnp.asarray(np.stack([a["labels"] for a in row])),
            num_points=jnp.asarray(np.stack([a["num_points"].reshape(1) for a in row])),
        )
        key = jax.random.fold_in(jax.random.PRNGKey(0), i)
        if compiled is None:
            compiled = step.lower(state, batch, key).compile(
                compiler_options={"xla_backend_optimization_level": 1}
            )
        state, metrics = compiled(state, batch, key)
        w = {k: np.asarray(v) for k, v in metrics.items()}
        w["variables"] = (state.params, state.batch_stats)
        want.append(w)
    return want


# per step: (grad norm rel, update L2 rel, BN statistics rel), as
# test_torch_train.py's first two steps
TOL = [(1e-4, 1e-2, 1e-4), (1e-4, 1e-2, 1e-4)]


def test_two_rank_steps_match_jax_two_device_step(ranks):
    params, stats = ranks["spec"]["step"]["params"].values()
    want = _jax_steps(ranks["shards"], params, stats)  # compiles while the ranks run
    out = _results(ranks)
    got, other = out[0]["step"], out[1]["step"]
    prev = _flat(params)
    for i, (g, w, (tol_norm, tol_upd, tol_bn)) in enumerate(zip(got, want, TOL)):
        assert g["loss"] == other[i]["loss"] and g["grad_norm"] == other[i]["grad_norm"]
        assert g["loss"] == pytest.approx(float(w["loss"]), rel=5e-5), i
        assert g["grad_norm"] == pytest.approx(float(w["grad_norm"]), rel=tol_norm), i
        assert g["level_nums"] == other[i]["level_nums"] == w["level_nums"].tolist()
        (p, s), (jp, js) = g["variables"], w["variables"]
        a, b = _flat(p), _flat(jp)
        for mine, theirs in zip((p, s), other[i]["variables"]):  # the ranks agree, bit for bit
            x, y = _flat(mine), _flat(theirs)
            assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        diff = np.sqrt(sum(np.sum((a[k] - b[k]).astype(np.float64) ** 2) for k in a))
        upd = np.sqrt(sum(np.sum((b[k] - prev[k]).astype(np.float64) ** 2) for k in a))
        assert diff <= tol_upd * upd, (i, diff, upd)
        if i == 0:
            for k in a:
                assert np.abs(a[k] - b[k]).max() <= 1e-6 * max(np.abs(b[k]).max(), 1e-3), k
        sa, sb = _flat(s), _flat(js)
        for k in sa:
            err = np.abs(sa[k] - sb[k]).max()
            assert err <= tol_bn * max(np.abs(sb[k]).max(), 1e-3), (i, k, err)
        prev = b


@pytest.mark.parametrize("training", [False, True])
def test_loader_slices_are_jax_shards(training):
    """Process r of 2 loads JAX's shard r of each global batch: in eval
    the same arrays and padding flags, in training the same scans (each
    loader draws its own augmentations)."""
    j = j_build_dataloader(LOADER_DATA, training=training, n_shards=WORLD, scans_per_shard=1)
    t = [build_dataloader(LOADER_DATA, training=training, scans_per_shard=1, process_index=r,
                          process_count=WORLD) for r in range(WORLD)]
    assert len(j) == len(t[0]) == len(t[1]) == (2 if training else 3)
    for jb, *tb in zip(j, *t):
        (ja, jm) = jb
        for r, (ta, tm) in enumerate(tb):
            assert [s.name for s in jm[r]["samples"]] == [s.name for s in tm[0]["samples"]]
            assert jm[r]["padded"] == tm[0]["padded"]
            if not training:
                for k in KEYS:
                    np.testing.assert_array_equal(ja[k][r], ta[k].reshape(ja[k][r].shape), err_msg=k)


def test_kd_step_leaves_the_ranks_identical(ranks):
    a, b = (o["kd"] for o in _results(ranks))
    assert a["loss"] == b["loss"] and np.isfinite(a["loss"])
    assert a["state"].keys() == b["state"].keys()
    for k in a["state"]:
        assert torch.equal(a["state"][k], b["state"][k]), k


def test_two_rank_eval_is_the_single_process_histogram(ranks, tmp_path):
    out = _results(ranks)
    spec = ranks["spec"]["eval"]
    val = build_dataloader(EVAL_CFG["DATA"], training=False, scans_per_shard=1)
    tr = Trainer(EVAL_CFG, spec["params"], device="cpu", iters_per_epoch=1, val_loader=val,
                 output_dir=tmp_path)
    tr._writer = _NullWriter()  # TensorBoard's import alone takes ~15 s here
    want = tr.evaluate()["hist"]
    assert want.sum() > 0
    for o in out:
        np.testing.assert_array_equal(o["eval"], want)


def _jax_range_steps(shards, params, stats) -> list:
    import flax.linen as fnn

    lw = RANGE_CFG["MODEL"]["LOSS_CONFIG"]
    tx = j_build_optimizer({**RANGE_CFG["OPTIM"], "LR": 0.0025 * WORLD}, RANGE_SCHED["iters_per_epoch"],
                           RANGE_SCHED["total_epochs"], clip_grad_norm=10.0)
    step = make_range_train_step(
        JSalsaNext(20, base=8), tx, make_mesh(jax.devices()[:WORLD]),
        jnp.asarray(range_class_weights("synthetic", 20)), top_k_percent=lw["TOP_K_PERCENT"],
        ls_weight=lw["LS_WEIGHT"], bd_weight=lw["BD_WEIGHT"], donate=False,
    )
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = TrainState(params=jp, batch_stats=jax.tree_util.tree_map(jnp.asarray, stats),
                       opt_state=tx.init(jp), step=jnp.int32(0))
    want = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
        for i, row in enumerate(shards):
            batch = RangeBatch(**{k: jnp.asarray(np.stack([a[k] for a in row])) for k in ("scan", "label", "mask")})
            state, metrics = step(state, batch, jax.random.PRNGKey(i))
            w = {k: float(v) for k, v in metrics.items()}
            w["variables"] = (state.params, state.batch_stats)
            want.append(w)
    return want


# per step: (loss rel, grad norm rel, update L2 rel, BN statistics rel), as
# test_torch_range_train.py's at step 0; step 1 is ill-conditioned on
# these shards: in the port alone (the two shards' gradients averaged in
# one process) a 1e-7 relative change of the weights moves step 1's
# update by 9.7e-2 and 0.15 of its L2 norm (step 0: 3.3e-2) and its grad
# norm by 7e-3; against JAX (measured): grad norm 2.3e-3 and 4.1e-2, step
# 1's update 0.28 of its norm
RANGE_TOL = [(1e-5, 2e-2, 5e-2, 1e-4), (1e-3, 0.1, 0.5, 5e-2)]


def test_two_rank_range_steps_match_jax_two_device_step(ranks):
    params, stats = ranks["spec"]["range"]["params"].values()
    want = _jax_range_steps(ranks["range_shards"], params, stats)
    got, other = (o["range"] for o in _results(ranks))
    prev = _flat(params)
    for i, (g, w, (tl, tn, tu, tb)) in enumerate(zip(got, want, RANGE_TOL)):
        assert g["loss"] == other[i]["loss"] and g["grad_norm"] == other[i]["grad_norm"]
        assert g["loss"] == pytest.approx(w["loss"], rel=tl), i
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=tn), i
        (p, s), (jp, js) = g["variables"], w["variables"]
        x, y = _flat(p), _flat(other[i]["variables"][0])
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        a, b = _flat(p), _flat(jp)
        diff = np.sqrt(sum(np.sum((a[k] - b[k]).astype(np.float64) ** 2) for k in a))
        upd = np.sqrt(sum(np.sum((b[k] - prev[k]).astype(np.float64) ** 2) for k in a))
        assert diff <= tu * upd, (i, diff, upd)
        sa, sb = _flat(s), _flat(js)
        for k in sa:
            assert np.abs(sa[k] - sb[k]).max() <= tb * max(np.abs(sb[k]).max(), 1e-3), (i, k)
        prev = b
