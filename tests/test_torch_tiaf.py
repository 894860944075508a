"""TIAF (MinkUNetMsMm) in the port against the JAX package: the host side
and the model.

Host side, array-equal: the projection helpers (`projection_matrix`,
`project_to_image` with its crop, `select_points_in_frustum`),
`driving_distance` and `image_window` (the speed-adaptive step), the
dilation and the colour jitter, the disk reader `TiafKittiReader` over
the tiny SemanticKITTI tree with camera images written here (train, with
its jitter, and val), the synthetic reader's dict, `MsMmVoxelPipeline`
(main frame and fused cloud, the FOV cloud, each FOV voxel's (row, col)),
`collate_mm_shard` against `collate_mm_batch`, and the `synthetic_ms_mm`
loader (FOV capacity, padding) against JAX's.

Model: tiny MinkUNetMsMm (cr 0.125, FOV_CR 0.125, IMAGE_BASE 8, 2 images
of 32 x 64 per scan, capacities 8192 / 4096; random BN statistics so
the outputs are O(1)), f32 on the CPU, on a shard of 2 synthetic scans,
`init_params_numpy`'s weights in both (flax's apply raises on a missing
leaf), JAX's forward jitted once for both modes: the FOV -> main tables (the
main cloud is wider than the FOV cloud, so many main points fall outside
the FOV topology's bounds: index -1, weight 0) integer-equal, their
weights within 1e-6; the six outputs in eval (the replace ensemble)
within 1e-4 of their scale [measured <= 3.5e-6 of an O(1) scale] and in
train (dropout the identity on both sides; the port's masks come from
its own generator) within 1e-3 [measured <= 2.2e-4: train-mode BN takes
batch statistics, and in the port alone a 1e-6 relative change of the
main cloud's features moves the main logits by 1.2e-4 of their scale],
`overlap` equal, the BN statistics after the train forward within 1e-5
of their scale [5.1e-6].  About 75 s on one worker (`--durations`), ~65 s
of it JAX compiling the two forwards (at XLA's lowest backend
optimisation level, which saves ~25 s).
"""

import jax
import jax.numpy as jnp
import flax.linen as fnn
import numpy as np
import pytest
import torch

from taseg_tpu.data import build_dataloader as j_build_dataloader
from taseg_tpu.data.semantickitti import tiaf as jtiaf
from taseg_tpu.data.semantickitti.reader_mm import TiafKittiReader as JTiafReader
from taseg_tpu.data.synthetic import SyntheticTiafReader as JSynth
from taseg_tpu.data.voxel_mm import MsMmVoxelPipeline as JPipeline
from taseg_tpu.data.voxel_mm import collate_mm_batch as j_collate
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models.voxel.minkunet_mm import MinkUNetMsMm as JModel
from taseg_tpu.parallel import Batch
from taseg_tpu.parallel.tiaf import TiafBatch, _unpack
from taseg_tpu_torch import data as tdata
from taseg_tpu_torch.configs import TIAF_TINY
from taseg_tpu_torch.data.semantickitti import tiaf as ttiaf
from taseg_tpu_torch.data.semantickitti.reader_mm import TiafKittiReader as TTiafReader
from taseg_tpu_torch.data.synthetic import SyntheticTiafReader as TSynth
from taseg_tpu_torch.data.voxel_mm import MsMmVoxelPipeline as TPipeline
from taseg_tpu_torch.data.voxel_mm import collate_mm_shard
from taseg_tpu_torch.engine import to_device
from taseg_tpu_torch.models import MinkUNetMsMm, build_segmentor
from taseg_tpu_torch.models.layers import Dropout
from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities
from taseg_tpu_torch.models.voxel.minkunet_mm import TAP_STRIDES, tiaf_inputs
from taseg_tpu_torch.utils.params_from_jax import init_params_numpy, load_flax_params
from torch_kitti_fixture import N_FRAMES, make_kitti_root

CAP, FOV_CAP = 8192, 4096
SCHEDULE = (1.0,) * 5
CFG = {**TIAF_TINY, "MODEL": {**TIAF_TINY["MODEL"], "CAPACITY_SCHEDULE": SCHEDULE}}
OUTPUTS = ("logits", "fusion_logits", "image_logits", "image_point_logits", "fov_point_logits")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_equal(a, b, what=""):
    assert a.dtype == b.dtype, what
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_dicts_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert_equal(a[k], b[k], k)
        else:
            assert a[k] == b[k], k


def assert_samples_equal(a, b):
    for f in ("coords", "feats", "labels", "inverse_map", "raw_labels"):
        assert_equal(getattr(a, f), getattr(b, f), f)
    assert (a.num_raw_points, a.name) == (b.num_raw_points, b.name)


# ------------------------------------------------------------ host side

CALIB = {
    "P2": np.array([[20.0, 0, 20, 0], [0, 20.0, 12, 0], [0, 0, 1, 0]]),
    # velodyne x-forward -> camera z-forward, with an offset
    "Tr": np.array([[0, -1, 0, 0.1], [0, 0, -1, -0.05], [1, 0, 0, 0.2], [0, 0, 0, 1.0]]),
}


def test_projection_helpers_match_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (4000, 4)).astype(np.float32)
    pj, pt = jtiaf.projection_matrix(CALIB), ttiaf.projection_matrix(CALIB)
    assert_equal(pj, pt)
    for crop in ((None, None), (16, 32)):
        a = jtiaf.project_to_image(pts, pj, 40, 24, crop_h=crop[0], crop_w=crop[1])
        b = ttiaf.project_to_image(pts, pt, 40, 24, crop_h=crop[0], crop_w=crop[1])
        for x, y in zip(a, b):
            assert_equal(x, y)
        assert 0 < b[0].sum() < len(pts)
    uv = rng.uniform(-5, 50, (500, 2))
    assert_equal(jtiaf.select_points_in_frustum(uv, 0, 0, 40, 24),
                 ttiaf.select_points_in_frustum(uv, 0, 0, 40, 24))


def test_window_dilation_and_jitter_match_jax():
    slow = [np.eye(4) for _ in range(100)]
    fast = []
    for t in range(100):
        p = np.eye(4)
        p[:3, 3] = [2.0 * t, 0, 0]
        fast.append(p)
    for poses in (slow, fast, None):
        for frame in (0, 7, 60):
            kw = dict(multiscan_image=48, step_image=12, poses=poses)
            assert jtiaf.image_window(frame, **kw) == ttiaf.image_window(frame, **kw)
    assert ttiaf.image_window(60, poses=slow) == [60, 48, 36, 24, 12]
    assert len(ttiaf.image_window(60, poses=fast)) == 9  # the step halved
    assert jtiaf.driving_distance(fast, 60, 48) == ttiaf.driving_distance(fast, 60, 48)
    rng = np.random.default_rng(1)
    img = np.zeros((24, 40), np.int32)
    hit = rng.random(img.shape) < 0.05
    img[hit] = rng.integers(1, 20, int(hit.sum()))
    for it in (1, 2, 3):
        assert_equal(jtiaf.dilate_semantic_map(img, it), ttiaf.dilate_semantic_map(img, it))
    rgb = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    for x in (rgb, rgb * 255):
        a = jtiaf.color_jitter(x, np.random.default_rng(5))
        b = ttiaf.color_jitter(x, np.random.default_rng(5))
        assert_equal(a, b)


@pytest.fixture(scope="module")
def kitti_mm(tmp_path_factory):
    """The tiny SemanticKITTI tree with a camera: a P2 and a velodyne ->
    camera Tr in calib.txt and a 24 x 40 PNG per frame but the second
    (a missing image is skipped)."""
    from PIL import Image

    root = make_kitti_root(tmp_path_factory.mktemp("kitti_mm"))
    rng = np.random.default_rng(2)
    for seq in ("00", "08"):
        d = root / seq
        lines = [f"{k}: " + " ".join(["0"] * 12) for k in ("P0", "P1", "P3")]
        lines.append("P2: " + " ".join(str(v) for v in CALIB["P2"].reshape(-1)))
        lines.append("Tr: " + " ".join(str(v) for v in CALIB["Tr"][:3].reshape(-1)))
        (d / "calib.txt").write_text("\n".join(lines))
        (d / "image_2").mkdir()
        for t in range(N_FRAMES):
            if t != 1:
                px = rng.integers(0, 256, (24, 40, 3), dtype=np.uint8)
                Image.fromarray(px).save(d / "image_2" / f"{t:06d}.png")
    return root


@pytest.mark.parametrize("split", ["train", "val"])
def test_disk_reader_matches_jax(kitti_mm, split):
    """Window of every 2nd frame over 4 (frames t, t-2, t-4), crop 16 x 32
    of the 24 x 40 images, the 2D targets projected and dilated; train
    draws the jitter from the reader's generator in JAX's order."""
    kw = dict(
        split=split, augment="NoAug", multiscan=2, only_history=True, pseudo_mask="gt",
        multiscan_image=4, step_image=2, image_height=16, image_width=32,
    )
    j, t = JTiafReader(str(kitti_mm), **kw), TTiafReader(str(kitti_mm), **kw)
    assert len(j) == len(t) == N_FRAMES
    n_img = []
    for i in range(len(j)):
        a, b = j[i], t[i]
        assert_dicts_equal(a, b)
        n_img.append(b["images"].shape[0])
        assert b["fov_rowcol"].shape == (int(b["fov_mask"].sum()), 2)
    assert max(n_img) == 3 and b["images"].shape[1:] == (16, 32, 3)
    np.testing.assert_array_equal(j.rng.random(4), t.rng.random(4))


def _scans(n=2, seed=0, points=1500, **kw):
    return [TSynth(length=n, n_points=points, seed=seed, **kw)[i] for i in range(n)]


def test_synthetic_reader_matches_jax():
    j, t = JSynth(length=2, n_points=1500, n_images=3), TSynth(length=2, n_points=1500, n_images=3)
    for i in range(2):
        a, b = j[i], t[i]
        assert_dicts_equal(a, b)
        assert b["images"].shape == (3, 32, 64, 3) and b["fov_mask"].sum() > 0


@pytest.mark.parametrize("training", [False, True])
def test_mm_pipeline_and_collate_match_jax(training):
    scans = _scans(3)
    jp, tp = JPipeline(0.2, training=training, seed=7), TPipeline(0.2, training=training, seed=7)
    js, ts = [jp(s) for s in scans], [tp(s) for s in scans]
    for a, b in zip(js, ts):
        assert_samples_equal(a.main.frame, b.main.frame)
        assert_samples_equal(a.main.fused, b.main.fused)
        assert_samples_equal(a.fov, b.fov)
        assert a.main.num_frame_points == b.main.num_frame_points
        for f in ("fov_rowcol", "images", "image_labels"):
            assert_equal(getattr(a, f), getattr(b, f), f)
        assert len(b.fov_rowcol) == len(b.fov.coords) > 0
    np.testing.assert_array_equal(jp.rng.random(3), tp.rng.random(3))
    ja, jmeta = j_collate([js], CAP, FOV_CAP)
    ta = collate_mm_shard(ts, CAP, FOV_CAP)
    for side in ("main", "fov"):
        for k in ("point_coords", "point_feats", "labels", "num_points"):
            np.testing.assert_array_equal(ja[side][k][0], ta[side][k], err_msg=(side, k))
    for k in ("fov_rowcol", "images", "image_labels"):
        np.testing.assert_array_equal(ja[k][0], ta[k], err_msg=k)
    assert ta["fov_rowcol"][:, 0].max() >= 2 * 32  # the third scan's rows are offset
    np.testing.assert_array_equal(jmeta[0]["offsets"], ta["offsets"])
    assert all(f.ms_pair is m.main for f, m in zip(ta["samples"], ts))


def test_mm_loader_matches_jax():
    data = {**CFG["DATA"], "LENGTH": 3}
    for training in (True, False):
        kw = dict(training=training, scans_per_shard=2)
        jl = j_build_dataloader(data, n_shards=1, **kw)
        tl = tdata.build_dataloader(data, **kw)
        assert (tl.point_capacity, tl.fov_capacity) == (2 * 8192, 4096)
        assert isinstance(tl.pipeline, TPipeline)
        for (ja, jm), (ta, tm) in zip(jl, tl):
            for side in ("main", "fov"):
                for k in ("point_coords", "point_feats", "labels", "num_points"):
                    np.testing.assert_array_equal(ja[side][k][0], ta[side][k], err_msg=(side, k))
            for k in ("fov_rowcol", "images", "image_labels"):
                np.testing.assert_array_equal(ja[k][0], ta[k], err_msg=k)
            assert jm[0]["padded"] == tm[0]["padded"]
            np.testing.assert_array_equal(jm[0]["offsets"], tm[0]["offsets"])
    # the default FOV capacity: half the point capacity
    no_fov = {k: v for k, v in data.items() if k != "FOV_NUM_POINTS"}
    assert tdata.build_dataloader(no_fov, training=False, scans_per_shard=1).fov_capacity == 4096


# ---------------------------------------------------------------- model


def _random_stats(tree, rng):
    return {
        k: _random_stats(v, rng) if isinstance(v, dict) else (
            rng.uniform(0.5, 1.5, v.shape) if k == "var" else rng.normal(0, 0.1, v.shape)
        ).astype(np.float32)
        for k, v in tree.items()
    }


def _tiaf_batch(ja: dict) -> TiafBatch:
    """JAX's batch of a `collate_mm_batch` shard."""

    def batch(d):
        return Batch(**{k: jnp.asarray(d[k]) for k in ("point_coords", "point_feats", "labels", "num_points")})

    return TiafBatch(
        main=batch(ja["main"]), fov=batch(ja["fov"]), fov_rowcol=jnp.asarray(ja["fov_rowcol"]),
        images=jnp.asarray(ja["images"]), image_labels=jnp.asarray(ja["image_labels"]),
    )


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict) else {pre + k: np.asarray(v)})
    return out


@pytest.fixture(scope="module")
def forward_run():
    """One shard of 2 synthetic scans through both packages: JAX's
    `_unpack` and model (jitted once, eval and train), and the port's
    `tiaf_inputs` and model, with the same weights."""
    p, s = init_params_numpy(CFG, seed=3)
    s = _random_stats(s, np.random.default_rng(0))
    scans = _scans(2)
    samples = [TPipeline(0.2, training=False)(x) for x in scans]
    ta = collate_mm_shard(samples, CAP, FOV_CAP)
    ja, _ = j_collate([samples], CAP, FOV_CAP)
    tb = _tiaf_batch(ja)
    caps, fov_caps = JCaps.for_points(CAP, schedule=SCHEDULE), JCaps.for_points(FOV_CAP)
    model = JModel(num_classes=20, in_dim=5, cr=0.125, fov_cr=0.125, image_base=8)

    @jax.jit
    def fwd(params, stats, tb):
        main, topo, fov, fov_topo, fov_devox = _unpack(tb, caps, fov_caps)
        args = (main, topo, fov, fov_topo, fov_devox, tb.images[0], tb.fov_rowcol[0])
        v = {"params": params, "batch_stats": stats}
        ev = model.apply(v, *args, False)
        tr, upd = model.apply(v, *args, True, mutable=["batch_stats"])
        tables = {st: (t.idx, t.weights) for st, t in fov_devox.items()}
        return ev, tr, upd["batch_stats"], tables, (fov_topo.bounds.origin, fov_topo.bounds.extent)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, x, deterministic=None, rng=None: x)
        mp.setattr(Dropout, "forward", lambda self, x: x)
        # compiled once at XLA's lowest backend optimisation level (the
        # compile dominates this module)
        compiled = fwd.lower(p, s, tb).compile(compiler_options={"xla_backend_optimization_level": 0})
        want = jax.tree_util.tree_map(np.asarray, compiled(p, s, tb))
        tm = build_segmentor(CFG, device="cpu")
        load_flax_params(tm, p, s)
        a = to_device(ta, "cpu", ("point_coords", "point_feats", "labels"))
        tcaps, tfov_caps = UNetCapacities.for_points(CAP, schedule=SCHEDULE), UNetCapacities.for_points(FOV_CAP)
        with torch.no_grad():
            tm.eval()
            ev_in = tiaf_inputs(a, tcaps, tfov_caps, train=False)
            ev = tm(a["main"]["point_feats_t"], ev_in)
            tm.train()
            tr = tm(a["main"]["point_feats_t"], tiaf_inputs(a, tcaps, tfov_caps, train=True))
    stats = {k.replace(".", "/"): v for k, v in tm.named_buffers()}
    return {"want": want, "eval": ev, "train": tr, "stats": stats, "inputs": ev_in, "arrays": ta}


def test_model_builds_as_jax():
    m = build_segmentor(TIAF_TINY, device="cpu")
    assert isinstance(m, MinkUNetMsMm)
    assert m.lidar_backbone.stem.SparseConv_0.kernel.shape == (27, 4 + 16 + 20, 4)
    assert m.classifier_fusion.kernel.shape == (2 * (32 + 16 + 12), 20)  # main's + the FOV's
    assert m.main.dropout.rate == 0.3 and m.image_backbone.SalsaResBlock_0.dropout is None
    with pytest.raises(ValueError, match="float32"):
        build_segmentor(TIAF_TINY, device="cpu", compute_dtype="bfloat16")


def test_fov_to_main_tables_match_jax(forward_run):
    """The FOV -> main trilinear tables: indices integer-equal, weights
    within 1e-6; main points outside the FOV topology's bounds (the main
    cloud is wider) map to -1 / 0 at every corner."""
    r = forward_run
    inputs, want_tables, (origin, extent) = r["inputs"], r["want"][3], r["want"][4]
    coords = r["arrays"]["main"]["point_coords"][:, :3].astype(np.int64)
    n = int(r["arrays"]["main"]["num_points"][0])
    outside = ((coords < origin) | (coords >= origin + extent)).any(1)[:n]
    assert outside.sum() > 100
    for s in TAP_STRIDES:
        t = inputs.fov_devox[s]
        assert_equal(t.idx.numpy(), want_tables[s][0], f"idx {s}")
        np.testing.assert_allclose(t.weights.numpy(), want_tables[s][1], rtol=0, atol=1e-6)
        assert (t.idx.numpy()[:, :n][:, outside] == -1).all()
        assert (t.weights.numpy()[:, :n][:, outside] == 0).all()
    # the pixel table: the FOV rows' flat pixel, -1 for padding rows
    rc = r["arrays"]["fov_rowcol"]
    nf = int(r["arrays"]["fov"]["num_points"][0])
    want = np.clip(rc[:, 0] * 64 + rc[:, 1], 0, 2 * 2 * 32 * 64 - 1)
    want[nf:] = -1
    assert_equal(inputs.pixels.inverse.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("mode,tol", [("eval", 1e-4), ("train", 1e-3)])
def test_model_outputs_match_jax(forward_run, mode, tol):
    """The six outputs within `tol` of their scale, `overlap` equal; in
    eval the main logits are the fusion logits on the overlap (replace)."""
    r = forward_run
    got, want = r[mode], r["want"][0 if mode == "eval" else 1]
    assert got.keys() == want.keys()
    for k in OUTPUTS:
        w = want[k]
        assert got[k].shape == w.shape, k
        err = np.abs(got[k].numpy() - w).max()
        assert err <= tol * max(np.abs(w).max(), 1.0), (k, err)
    assert_equal(got["overlap"].numpy(), want["overlap"], "overlap")
    ov = got["overlap"].numpy()
    assert 0 < ov.sum() < int(r["arrays"]["main"]["num_points"][0])
    if mode == "eval":
        assert torch.equal(got["logits"][ov], got["fusion_logits"][ov])


def test_train_forward_bn_statistics_match_jax(forward_run):
    """Every BN's running statistics after the train forward (the main
    branch's among them) within 1e-5 of their scale."""
    got, want = forward_run["stats"], _flat(forward_run["want"][2])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(got[k].numpy() - w).max() <= 1e-5 * max(np.abs(w).max(), 1.0), k
