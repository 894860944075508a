"""FSA (TASeg's multi-frame fusion) in the port against the JAX package.

Host side, array-equal on a tiny SemanticKITTI tree written by the
module's fixture (`torch_kitti_fixture.py`): the pose files, the
multi-scan reader (flexible steps over GT and over pseudo masks, history
only or both ways, and in train the LaserMix / PolarMix replay on frame
and fused cloud, drawing the reader's generator in JAX's order), the
synthetic multi-scan reader, the coupled `MsVoxelPipeline` (train and
eval) and the loader's collate of `MsVoxelSample`s with its metadata.

Device side, tiny MinkUNetMs (cr 0.125, one block per stage, 5 input
features, random BN statistics so the logits are O(1)), f32 on the CPU:
the logits of a fused shard and the tri-scale `return_features` against
JAX's model (`allclose(rtol=1e-3, atol=1e-3)`, the MinkUNet slice's
tolerance), `Segmenter.predict` returning each scan's current-frame
points only (JAX engine.py:700-710), `evaluate_points` over the
multi-scan loader equal to `Segmenter.predict` bit for bit, and
`evaluate()` over the fused voxels' labels, as JAX's.  About 25 s
on one worker (`--durations`), most of it JAX compiling the model once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taseg_tpu.data import build_dataloader as j_build_dataloader
from taseg_tpu.data.semantickitti import poses as jposes
from taseg_tpu.data.semantickitti.reader_ms import MultiScanKittiReader as JReader
from taseg_tpu.data.synthetic import SyntheticMsKittiReader as JSynth
from taseg_tpu.data.voxel_dataset import MsVoxelPipeline as JPipeline
from taseg_tpu.data.voxel_dataset import collate_shard as j_collate
from taseg_tpu.models import MinkUNet as JMinkUNet
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models import build_unet_topology as j_topology
from taseg_tpu.ops import PointSet
from taseg_tpu_torch import data as tdata
from taseg_tpu_torch.configs import MINKUNET_MS_TINY
from taseg_tpu_torch.data.semantickitti import poses as tposes
from taseg_tpu_torch.data.semantickitti.reader_ms import MultiScanKittiReader as TReader
from taseg_tpu_torch.data.synthetic import SyntheticMsKittiReader as TSynth
from taseg_tpu_torch.data.voxel_dataset import MsVoxelPipeline as TPipeline
from taseg_tpu_torch.engine import Segmenter, Trainer
from taseg_tpu_torch.models import build_segmentor
from taseg_tpu_torch.utils.params_from_jax import init_params_numpy
from torch_kitti_fixture import N_FRAMES, make_kitti_root

# per-class flexible steps of the FSA recipe (tools/cfgs/voxel/semantic_kitti/
# minkunet_mk34_cr10_fsa.yaml)
FLEX = [0, 0, 2, 2, 2, 2, 2, 2, 2, 0, 4, 4, 4, 0, 4, 0, 2, 4, 2, 2]
CAP = 8192
CFG = {
    **MINKUNET_MS_TINY,
    "MODEL": {**MINKUNET_MS_TINY["MODEL"], "CAPACITY_SCHEDULE": (1.0,) * 5},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    return make_kitti_root(tmp_path_factory.mktemp("kitti"))


def assert_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def assert_samples_equal(a, b):
    for f in ("coords", "feats", "labels", "inverse_map", "raw_labels"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.num_raw_points, a.name, a.token) == (b.num_raw_points, b.name, b.token)


def test_poses_match_jax(kitti):
    seq = kitti / "00"
    jc, tc = jposes.parse_calibration(seq / "calib.txt"), tposes.parse_calibration(seq / "calib.txt")
    assert jc.keys() == tc.keys()
    for k in jc:
        np.testing.assert_array_equal(jc[k], tc[k])
    jp, tp = jposes.load_sequence_poses(seq), tposes.load_sequence_poses(seq)
    assert len(jp) == len(tp) == N_FRAMES
    for a, b in zip(jp, tp):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(0).normal(0, 5, (50, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        jposes.warp_to_frame(pts, jp[1], jp[4]), tposes.warp_to_frame(pts, tp[1], tp[4])
    )


READERS = [
    # (split, augment, pseudo_mask, only_history, flexible_steps)
    ("val", "NoAug", "gt", True, [0] + [1] * 19),
    ("val", "NoAug", "mink_notta", False, FLEX),
    ("train", "GlobalAugment", "gt", True, FLEX),
    ("train", "GlobalAugment", "mink_notta", True, [0] + [1] * 19),
]


@pytest.mark.parametrize("split,augment,mask,history,steps", READERS)
def test_multiscan_reader_matches_jax(kitti, split, augment, mask, history, steps):
    kw = dict(
        split=split, augment=augment, multiscan=3, only_history=history,
        flexible_steps=steps, pseudo_mask=mask,
        pseudo_label_root=str(kitti.parent / "pseudo"), seed=3,
    )
    j, t = JReader(str(kitti), **kw), TReader(str(kitti), **kw)
    assert len(j) == len(t) == N_FRAMES
    fused = 0
    for i in range(len(j)):  # in order: train draws the reader's generator
        a, b = j[i], t[i]
        assert_dicts_equal(a, b)
        fused += len(b["xyzret_ms"]) - len(b["xyzret"])
    assert fused > 0  # history got fused
    assert len(t._poses_cache) == 1
    np.testing.assert_array_equal(j.rng.random(4), t.rng.random(4))


@pytest.mark.parametrize("kd", [False, True])
def test_synthetic_ms_reader_matches_jax(kd):
    j, t = JSynth(length=3, n_points=3000, kd=kd), TSynth(length=3, n_points=3000, kd=kd)
    for i in range(3):
        assert_dicts_equal(j[i], t[i])


@pytest.mark.parametrize("training", [True, False])
def test_ms_pipeline_matches_jax(kitti, training):
    reader = TReader(str(kitti), split="val", augment="NoAug", multiscan=3, flexible_steps=FLEX)
    jp, tp = JPipeline(0.1, training=training, seed=5), TPipeline(0.1, training=training, seed=5)
    for i in range(N_FRAMES):
        s = reader[i]
        a, b = jp(s), tp(s)
        assert a.num_frame_points == b.num_frame_points == len(s["xyzret"])
        assert_samples_equal(a.frame, b.frame)
        assert_samples_equal(a.fused, b.fused)
        assert b.fused.feats.shape[1] == 5  # xyzr + time flag
    assert tp.sorted_points is False


def test_ms_loader_matches_jax():
    """build_dataloader on `synthetic_ms` (train: shuffled, augmented; eval:
    in order, padded last batch): the collated arrays equal JAX's shard,
    and the metadata's fused samples carry their (frame, fused) pair."""
    data = {**MINKUNET_MS_TINY["DATA"], "LENGTH": 5, "N_RAW_POINTS": 1200}
    for training in (True, False):
        kw = dict(training=training, scans_per_shard=2, point_capacity=CAP)
        jl = j_build_dataloader(data, n_shards=1, **kw)
        tl = tdata.build_dataloader(data, **kw)
        assert isinstance(tl.pipeline, TPipeline)
        assert len(jl) == len(tl)
        for (ja, jm), (ta, tm) in zip(jl, tl):
            for k in ("point_coords", "point_feats", "labels", "num_points"):
                np.testing.assert_array_equal(ja[k][0], ta[k], err_msg=k)
            np.testing.assert_array_equal(jm[0]["offsets"], tm[0]["offsets"])
            assert jm[0]["padded"] == tm[0]["padded"]
            for js, ts, pad in zip(jm[0]["samples"], tm[0]["samples"], tm[0]["padded"]):
                assert ts.ms_pair.fused is ts
                assert ts.ms_pair.num_frame_points == js.ms_pair.num_frame_points
                assert_samples_equal(js.ms_pair.frame, ts.ms_pair.frame)
                if pad:  # a padding repeat's labels are zeroed, frame's too
                    assert not ts.labels.any() and not ts.ms_pair.frame.raw_labels.any()


def _randomize_bn(tree, rng, kind):
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
        elif k == "bias" and v.shape[0] != 20:  # BN bias, not the head
            v = rng.normal(0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


def _variables(seed=4):
    p, s = init_params_numpy(CFG, seed=seed)
    rng = np.random.default_rng(seed + 100)
    return {"params": _randomize_bn(p, rng, "params"), "batch_stats": _randomize_bn(s, rng, "stats")}


def _scans(n=2, seed=0):
    reader = TSynth(length=n, n_points=1500, seed=seed)
    return [reader[i] for i in range(n)]


@pytest.fixture(scope="module")
def jax_forward():
    """JAX's MinkUNetMs (eval) on a collated fused shard, jitted once:
    (logits, tri-scale point features)."""
    m = CFG["MODEL"]
    model = JMinkUNet(
        num_classes=20, in_dim=5, cr=m["cr"], num_layer=tuple(m["NUM_LAYER"]),
        block="ResBlock", dropout_p=0.0, compute_dtype="float32",
    )
    caps = JCaps.for_points(CAP, schedule=m["CAPACITY_SCHEDULE"])

    @jax.jit
    def fwd(variables, coords, feats, num):
        topo = j_topology(coords, num, caps)
        return model.apply(variables, PointSet(coords=coords, feats=feats, num=num), topo, False, True)

    return fwd


def test_fsa_logits_and_features_match_jax(jax_forward):
    variables = _variables()
    scans = _scans()
    arrays = j_collate([JPipeline(0.2, training=False)(s).fused for s in scans], CAP)
    jl, jz = jax_forward(
        variables, jnp.asarray(arrays["point_coords"]), jnp.asarray(arrays["point_feats"]),
        jnp.asarray(arrays["num_points"][0]),
    )
    n = int(arrays["num_points"][0])

    seg = Segmenter(CFG, variables, device="cpu", compute_dtype="float32", point_capacity=CAP, batch_size=2)
    assert seg.model.in_dim == 5 and isinstance(seg.pipeline, TPipeline)
    a = seg.collate(scans)
    np.testing.assert_array_equal(a["point_feats"], arrays["point_feats"])
    with torch.no_grad():
        tl, tz = seg.model(a["point_feats_t"], seg.topology(a), return_features=True)
    assert tz.dtype == torch.float32 and tz.shape == (CAP, (256 + 128 + 96) // 8)
    np.testing.assert_allclose(tl[:n].numpy(), np.asarray(jl)[:n], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tz[:n].numpy(), np.asarray(jz)[:n], rtol=1e-3, atol=1e-3)
    assert np.abs(np.asarray(jl)[:n]).max() > 0.5  # O(1) logits

    # Segmenter.predict: the current frame's points only, in frame order
    out = seg.predict(scans)
    for b, (s, o) in enumerate(zip(scans, out)):
        ms = JPipeline(0.2, training=False)(s)
        rows = np.asarray(jl)[arrays["offsets"][b]: arrays["offsets"][b + 1]]
        want = rows[ms.fused.inverse_map][: len(s["xyzret"])]
        assert o["logits"].shape == (len(s["xyzret"]), 20) == want.shape
        np.testing.assert_allclose(o["logits"], want, rtol=1e-3, atol=1e-3)
        np.testing.assert_array_equal(o["labels"], o["logits"].argmax(1))


def test_fsa_evaluate_points_matches_segmenter(tmp_path):
    """`evaluate_points` over the multi-scan eval loader (3 scans, batch
    2: a padded last batch) writes, per scan, the frame-length labels of
    `Segmenter.predict` on the same weights, bit for bit; 2 TTA votes
    write frame-length files too."""
    data = {**CFG["DATA"], "LENGTH": 3, "N_RAW_POINTS": 1500}
    cfg = {**CFG, "DATA": data}
    val = tdata.build_dataloader(data, training=False, scans_per_shard=2, point_capacity=CAP)
    variables = _variables()
    tr = Trainer(
        cfg, variables, device="cpu", iters_per_epoch=1, total_epochs=1, batch_size=2,
        point_capacity=CAP, val_loader=val, output_dir=tmp_path,
    )
    res = tr.evaluate_points(save_path=tmp_path / "preds", save_score=True)
    assert res["hist"].sum() > 0
    # evaluate() keeps JAX's voxel-level histogram over the fused shards
    fused = [TPipeline(0.2, training=False)(val.reader[i]).fused for i in range(3)]
    assert tr.evaluate()["hist"].sum() == sum(int((f.labels != 0).sum()) for f in fused)
    seg = Segmenter(cfg, variables, device="cpu", point_capacity=CAP, batch_size=2)
    scans = [val.reader[i] for i in range(3)]
    pred_dir = tmp_path / "preds" / "sequences" / "08" / "predictions"
    from taseg_tpu_torch.data.semantickitti.labels import train_to_raw

    for i, o in enumerate(seg.predict(scans)):
        got = np.fromfile(pred_dir / f"{i:06d}.label", np.uint32)
        assert len(got) == len(scans[i]["xyzret"])
        np.testing.assert_array_equal(got, train_to_raw(o["labels"]))
    tr.evaluate_points(tta_votes=2, save_path=tmp_path / "tta")
    files = sorted((tmp_path / "tta" / "sequences" / "08" / "predictions").glob("*.label"))
    assert [len(np.fromfile(f, np.uint32)) for f in files] == [1500] * 3


def test_fsa_train_step_runs_on_fused_clouds():
    """`Trainer.step` on reader dicts of the fused cloud: the multi-scan
    pipeline in train mode, the fused labels (`labels_ms`), a finite
    loss, and the stem at 5 input channels."""
    tr = Trainer(CFG, _variables(), device="cpu", iters_per_epoch=2, total_epochs=1,
                 batch_size=2, point_capacity=CAP)
    scans = _scans(seed=2)
    arrays = tr.collate(scans)
    pipe = TPipeline(0.2, training=True, seed=0)
    fused = [pipe(s).fused for s in scans]
    np.testing.assert_array_equal(arrays["labels"][: sum(len(f.labels) for f in fused)],
                                  np.concatenate([f.labels for f in fused]))
    assert tuple(tr.model.stem_0.SparseConv_0.kernel.shape) == (27, 5, 4)
    out = tr.train_on(arrays)
    assert np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])
    assert type(build_segmentor(CFG, device="cpu")) is type(tr.model)
