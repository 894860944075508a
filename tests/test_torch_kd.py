"""Mask distillation (KD) in the port against the JAX package.

Host side, array-equal: `MsKdVoxelPipeline` (one augmentation for the
frame, the student's and the teacher's clouds, the shared origin, and the
pairs of matching voxels in student-row order, then JAX's
`rng.permutation` draw where more than `max_voxel` pairs exist) against
JAX's dict loop, the vectorised `match_voxels` on its own (no match,
empty clouds, every row matched), `collate_kd_shard` against
`collate_kd_batch` and the `synthetic_ms_kd` loader against JAX's.

The step: tiny MinkUNetMsKd (cr 0.125, one block per stage, 5 input
features) on two synthetic multi-scan scans per step, a teacher with
other weights and random BN statistics, 2 f32 steps through
`Trainer.train_on` and through JAX's `make_kd_train_step` on a 1-device
CPU mesh (iters_per_epoch 1: step 0 at the warmup's LR, step 1 at the
full LR).  Tolerances (f32, after tests/test_torch_train.py's for the
ordinary step; measured values in brackets): loss, loss_seg and
loss_feat_kd within 1e-4 relative [<= 2.2e-5: the distillation term is
large at random weights, 10 x 2.2 of a loss of 27], grad norm within
5e-4 [<= 8.6e-5], every parameter after step 0 within 1e-6 of its
tensor's scale (the warmup's LR moves them by about an ulp), step 1's
update within 1e-2 of its L2 norm [4.0e-4], BN running statistics within
1e-4 of their scale [<= 2.0e-6]; the teacher's parameters and buffers
bit-identical after the steps and in no optimizer group.  Then the CLI
on minkunet_ms_tiny (the teacher) and minkunet_ms_kd_tiny with
MODEL.TEACHER_CKPT, on the CPU.  About 150 s on one worker
(`--durations`): 118 s for the steps on both sides, most of it JAX
compiling the KD step once (its teacher forward, student forward and
backward; at XLA's backend optimisation level 1,
`torch_jit_once.compile_once`: 95 s for the steps in a run beside
another module), 26 s for the CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.data import build_dataloader as j_build_dataloader
from taseg_tpu.data.voxel_dataset import MsKdVoxelPipeline as JKdPipeline
from taseg_tpu.data.voxel_dataset import collate_kd_batch as j_collate_kd
from taseg_tpu.loss import Losses as JLosses
from taseg_tpu.models import MinkUNet as JMinkUNet
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.optim import build_optimizer as j_build_optimizer
from taseg_tpu.parallel import Batch, TrainState, make_mesh
from taseg_tpu.parallel.kd import KdBatch, make_kd_train_step
from taseg_tpu_torch import data as tdata
from taseg_tpu_torch.configs import MINKUNET_MS_KD_TINY
from taseg_tpu_torch.data.synthetic import SyntheticMsKittiReader
from taseg_tpu_torch.data.voxel_dataset import MsKdVoxelPipeline, collate_kd_shard, match_voxels
from taseg_tpu_torch.engine import Trainer
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy
from torch_jit_once import compile_once

CAP = 8192
MAX_VOXEL = 256
CFG = {
    **MINKUNET_MS_KD_TINY,
    "MODEL": {**MINKUNET_MS_KD_TINY["MODEL"], "CAPACITY_SCHEDULE": (1.0,) * 5},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scans(n=2, seed=0, points=1500):
    reader = SyntheticMsKittiReader(length=n, n_points=points, seed=seed, kd=True)
    return [reader[i] for i in range(n)]


def _dict_pairs(student, teacher):
    """JAX's alignment loop (voxel_dataset.py:311-318), as written."""
    lut = {tuple(c): i for i, c in enumerate(teacher)}
    s_idx, t_idx = [], []
    for i, c in enumerate(student):
        j = lut.get(tuple(c))
        if j is not None:
            s_idx.append(i)
            t_idx.append(j)
    return np.asarray(s_idx, np.int32), np.asarray(t_idx, np.int32)


def test_match_voxels_is_the_dict_loop():
    rng = np.random.default_rng(0)
    cases = []
    for n_s, n_t in ((500, 400), (0, 10), (10, 0), (1, 1)):
        allc = np.unique(rng.integers(0, 12, (3 * (n_s + n_t) + 3, 3)), axis=0)
        perm = rng.permutation(len(allc))
        s = allc[perm[:n_s]]
        t = allc[rng.permutation(len(allc))[:n_t]]
        cases.append((s.astype(np.int32), t.astype(np.int32)))
    s = np.unique(rng.integers(0, 40, (300, 3)), axis=0).astype(np.int32)
    cases.append((s, s[rng.permutation(len(s))]))  # every row matched
    cases.append((s, s + 100))  # none
    for s, t in cases:
        got, want = match_voxels(s, t), _dict_pairs(s, t)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("max_voxel", [MAX_VOXEL, 100_000])
def test_kd_pipeline_matches_jax(max_voxel):
    scans = _scans(3)
    jp = JKdPipeline(0.2, training=True, max_voxel=max_voxel, seed=7)
    tp = MsKdVoxelPipeline(0.2, training=True, max_voxel=max_voxel, seed=7)
    for s in scans:
        a, b = jp(s), tp(s)
        for x, y in ((a.student.frame, b.student.frame), (a.student.fused, b.student.fused),
                     (a.teacher, b.teacher)):
            for f in ("coords", "feats", "labels", "inverse_map", "raw_labels"):
                np.testing.assert_array_equal(getattr(x, f), getattr(y, f), err_msg=f)
        assert a.student.num_frame_points == b.student.num_frame_points
        for f in ("pair_student", "pair_teacher"):
            assert getattr(a, f).dtype == getattr(b, f).dtype
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        np.testing.assert_array_equal(
            b.student.fused.coords[b.pair_student], b.teacher.coords[b.pair_teacher]
        )
        assert len(b.pair_student) == min(max_voxel, len(match_voxels(
            b.student.fused.coords, b.teacher.coords)[0]))
    np.testing.assert_array_equal(jp.rng.random(3), tp.rng.random(3))


def test_kd_collate_and_loader_match_jax():
    """`collate_kd_shard` (one padded pair table, rows offset per sample)
    against `collate_kd_batch`, and the `synthetic_ms_kd` loader (teacher
    capacity and pairs per scan from DATA) against JAX's, train and
    eval."""
    scans = _scans(2)
    samples = [MsKdVoxelPipeline(0.2, training=False, max_voxel=MAX_VOXEL)(s) for s in scans]
    t = collate_kd_shard(samples, CAP, 6144, MAX_VOXEL)
    j, jmeta = j_collate_kd([samples], CAP, 6144, MAX_VOXEL)
    for side in ("student", "teacher"):
        for k in ("point_coords", "point_feats", "labels", "num_points"):
            np.testing.assert_array_equal(j[side][k][0], t[side][k], err_msg=(side, k))
    assert t["teacher"]["point_coords"].shape[0] == 6144
    for k in ("kd_student_idx", "kd_teacher_idx", "kd_mask"):
        np.testing.assert_array_equal(j[k][0], t[k], err_msg=k)
    np.testing.assert_array_equal(jmeta[0]["offsets"], t["offsets"])
    assert all(f.ms_pair is k.student for f, k in zip(t["samples"], samples))

    data = {**CFG["DATA"], "LENGTH": 3, "N_RAW_POINTS": 1200, "TEACHER_NUM_POINTS": 6144}
    for training in (True, False):
        kw = dict(training=training, scans_per_shard=2, point_capacity=CAP)
        jl = j_build_dataloader(data, n_shards=1, **kw)
        tl = tdata.build_dataloader(data, **kw)
        assert (tl.teacher_capacity, tl.kd_max_voxel) == (6144, MAX_VOXEL)
        assert isinstance(tl.pipeline, MsKdVoxelPipeline)
        for (ja, jm), (ta, tm) in zip(jl, tl):
            for k in ("kd_student_idx", "kd_teacher_idx", "kd_mask"):
                np.testing.assert_array_equal(ja[k][0], ta[k], err_msg=k)
            for side in ("student", "teacher"):
                for k in ("point_coords", "point_feats", "labels", "num_points"):
                    np.testing.assert_array_equal(ja[side][k][0], ta[side][k], err_msg=(side, k))
            assert jm[0]["padded"] == tm[0]["padded"]
            np.testing.assert_array_equal(jm[0]["offsets"], tm[0]["offsets"])


def _randomize_bn(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize_bn(v, rng)
        elif k == "var":
            out[k] = rng.uniform(0.05, 0.15, v.shape).astype(np.float32)
        elif k == "mean":
            out[k] = rng.normal(0, 0.05, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict) else {pre + k: np.asarray(v, np.float64)})
    return out


@pytest.fixture(scope="module")
def kd_run():
    """2 KD steps on the same shards through the port and through JAX."""
    student = init_params_numpy(CFG, seed=4)
    t_params, t_stats = init_params_numpy(CFG, seed=5)
    t_stats = _randomize_bn(t_stats, np.random.default_rng(6))
    sched = dict(iters_per_epoch=1, total_epochs=3)

    tr = Trainer(
        CFG, {"params": student[0], "batch_stats": student[1]}, device="cpu", batch_size=2,
        point_capacity=CAP, teacher_capacity=CAP, seed=9, **sched,
    )
    with pytest.raises(RuntimeError, match="TEACHER_CKPT"):
        tr.step(_scans(2, seed=1))  # a KD step without a teacher raises
    tr = Trainer(
        CFG, {"params": student[0], "batch_stats": student[1]}, device="cpu", batch_size=2,
        point_capacity=CAP, teacher_capacity=CAP, seed=9, **sched,
    )
    tr.set_teacher(t_params, t_stats)
    teacher0 = {k: v.clone() for k, v in tr.teacher.state_dict().items()}

    m = CFG["MODEL"]
    model = JMinkUNet(
        num_classes=20, in_dim=5, cr=m["cr"], num_layer=tuple(m["NUM_LAYER"]),
        block="ResBlock", dropout_p=0.0, compute_dtype="float32",
    )
    tx = j_build_optimizer(
        {**CFG["OPTIM"], "LR": CFG["OPTIM"]["LR_PER_SAMPLE"] * 2}, clip_grad_norm=10.0, **sched,
    )
    caps = JCaps.for_points(CAP, schedule=m["CAPACITY_SCHEDULE"])
    step = compile_once(make_kd_train_step(
        model, JLosses(["CELoss", "LovLoss"], [1.0, 1.0], ignore_index=0), tx, caps, caps,
        make_mesh(jax.devices()[:1]), feat_kd_weight=m["FEAT_KD_WEIGHT"], donate=False,
    ))
    p0 = jax.tree_util.tree_map(jnp.asarray, student[0])
    state = TrainState(
        params=p0, batch_stats=jax.tree_util.tree_map(jnp.asarray, student[1]),
        opt_state=tx.init(p0), step=jnp.int32(0),
    )
    jt = (jax.tree_util.tree_map(jnp.asarray, t_params), jax.tree_util.tree_map(jnp.asarray, t_stats))
    jpipe = JKdPipeline(0.2, training=True, max_voxel=MAX_VOXEL, seed=9)
    got, want = [], []
    for i, scans in enumerate((_scans(2, seed=1), _scans(2, seed=2))):
        a = tr.collate(scans)
        ja, _ = j_collate_kd([[jpipe(s) for s in scans]], CAP, CAP, MAX_VOXEL)
        for k in ("kd_student_idx", "kd_mask"):
            np.testing.assert_array_equal(ja[k][0], a[k])
        np.testing.assert_array_equal(ja["student"]["point_feats"][0], a["student"]["point_feats"])

        def batch(d):
            return Batch(**{k: jnp.asarray(d[k]) for k in ("point_coords", "point_feats", "labels", "num_points")})

        kb = KdBatch(
            student=batch(ja["student"]), teacher=batch(ja["teacher"]),
            kd_student_idx=jnp.asarray(ja["kd_student_idx"]),
            kd_teacher_idx=jnp.asarray(ja["kd_teacher_idx"]), kd_mask=jnp.asarray(ja["kd_mask"]),
        )
        state, metrics = step(state, *jt, kb, jax.random.PRNGKey(i))
        want.append({**{k: float(v) for k, v in metrics.items()},
                     "params": _flat(state.params), "stats": _flat(state.batch_stats)})
        out = tr.train_on(a)
        p, s = export_flax_params(tr.model)
        got.append({**out, "params": _flat(p), "stats": _flat(s)})
    return tr, teacher0, _flat(student[0]), got, want


def test_kd_steps_match_jax(kd_run):
    tr, _, p0, got, want = kd_run
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "loss_seg", "loss_feat_kd"):
            assert g[k] == pytest.approx(w[k], rel=1e-4), (i, k)
        assert g["loss_feat_kd"] > 0
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=5e-4), i
        for k, v in w["stats"].items():
            assert np.abs(g["stats"][k] - v).max() <= 1e-4 * max(np.abs(v).max(), 1.0), (i, k)
    # step 0 (the warmup's LR) moves the parameters by about their ulp:
    # held per tensor; step 1 by its update
    for k, v in want[0]["params"].items():
        assert np.abs(got[0]["params"][k] - v).max() <= 1e-6 * max(np.abs(v).max(), 1e-3), k
    du = np.sqrt(sum((((got[1]["params"][k] - got[0]["params"][k])
                       - (want[1]["params"][k] - want[0]["params"][k])) ** 2).sum() for k in p0))
    un = np.sqrt(sum(((want[1]["params"][k] - want[0]["params"][k]) ** 2).sum() for k in p0))
    assert du <= 1e-2 * un, du / un


def test_kd_teacher_is_frozen(kd_run):
    tr, teacher0, *_ = kd_run
    for k, v in tr.teacher.state_dict().items():
        assert torch.equal(v, teacher0[k]), k
    assert not tr.teacher.training
    assert not any(p.requires_grad for p in tr.teacher.parameters())
    opt_ids = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
    assert not opt_ids & {id(p) for p in tr.teacher.parameters()}


def test_cli_fsa_then_kd(tmp_path, monkeypatch):
    """The FSA tiny recipe trains one epoch and writes frame-length
    submission files with 2 TTA votes; its checkpoint is the KD tiny
    recipe's teacher (MODEL.TEACHER_CKPT through --set), whose epoch logs
    the distillation term; without a teacher the KD recipe raises."""
    from taseg_tpu_torch.train import main

    monkeypatch.chdir(tmp_path)
    fsa = "tools/cfgs/voxel/synthetic/minkunet_ms_tiny.yaml"
    kd = "tools/cfgs/voxel/synthetic/minkunet_ms_kd_tiny.yaml"
    short = ["--set", "DATA.LENGTH", "4"]
    main(["--cfg_file", fsa, "--epochs", "1", "--device", "cpu", *short])
    ckpt = tmp_path / "output" / "minkunet_ms_tiny" / "default" / "ckpt" / "checkpoint_epoch_0"
    assert ckpt.is_file()
    main(["--cfg_file", fsa, "--eval", "--tta", "--votes_max", "2", "--save_path", "preds",
          "--device", "cpu", *short])
    files = sorted((tmp_path / "preds" / "sequences" / "08" / "predictions").glob("*.label"))
    assert [len(np.fromfile(f, np.uint32)) for f in files] == [2000] * 4  # frame points only

    with pytest.raises(RuntimeError, match="TEACHER_CKPT"):
        main(["--cfg_file", kd, "--epochs", "1", "--device", "cpu", "--extra_tag", "none", *short])
    main(["--cfg_file", kd, "--epochs", "1", "--device", "cpu", "--set", "DATA.LENGTH", "4",
          "MODEL.TEACHER_CKPT", str(ckpt)])
    run = tmp_path / "output" / "minkunet_ms_kd_tiny" / "default"
    log = (run / "log.txt").read_text()
    assert "loaded frozen KD teacher" in log and "saved checkpoint" in log
    tags = (run / "metrics" / "metrics.jsonl").read_text()
    assert '"train/loss_feat_kd"' in tags and '"train/loss_seg"' in tags
