"""Cylinder_TS through the port's harness on the CPU: the CLI on the tiny
recipe (`tools/cfgs/voxel/synthetic/cylinder_tiny.yaml`, MODALITY voxel:
the cylinder pipeline is picked by the model's name, as the JAX CLI
picks it; one epoch with its checkpoint and evaluation, then 2 TTA votes
writing raw-id `.label` files), `Trainer.train` over the cylinder loader
and `evaluate_points` writing the labels of `Segmenter.predict` on the
same weights and scans.  About 30 s on one worker (`--durations`).
"""

import numpy as np
import pytest
import torch

from taseg_tpu_torch import data as tdata
from taseg_tpu_torch.configs import CYLINDER_TINY
from taseg_tpu_torch.data.cylinder_dataset import CylinderPipeline
from taseg_tpu_torch.data.semantickitti.labels import LEARNING_MAP_LUT
from taseg_tpu_torch.engine import Segmenter, Trainer
from taseg_tpu_torch.models import CylinderTS
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

TINY = "tools/cfgs/voxel/synthetic/cylinder_tiny.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_cli_trains_cylinder_and_writes_submissions(tmp_path, monkeypatch):
    from taseg_tpu_torch.train import check_ported, main, pipeline_kind
    from taseg_tpu_torch.utils.config import load_config

    cfg = load_config(TINY)
    assert (check_ported(cfg), pipeline_kind(cfg)) == ("voxel", "cylinder")
    big = load_config("tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml")
    assert (check_ported(big), pipeline_kind(big)) == ("cylinder", "cylinder")

    monkeypatch.chdir(tmp_path)
    main(["--cfg_file", TINY, "--epochs", "1", "--device", "cpu"])
    run = tmp_path / "output" / "cylinder_tiny" / "default"
    assert (run / "ckpt" / "checkpoint_epoch_0").is_file()
    log = (run / "log.txt").read_text()
    assert "eval per-class IoU" in log and "saved checkpoint" in log
    assert "epoch 0 it 0/8" in log

    main(["--cfg_file", TINY, "--eval", "--tta", "--votes_max", "2",
          "--save_path", "preds", "--device", "cpu"])
    log = (run / "log.txt").read_text()
    assert "resumed from" in log and "point-eval mIoU" in log and "RANDOM" not in log
    files = sorted((tmp_path / "preds" / "sequences" / "08" / "predictions").glob("*.label"))
    assert len(files) == 8
    raw = [np.fromfile(f, np.uint32) for f in files]
    assert all(len(r) == 4000 for r in raw)
    # raw ids of the 20 train ids (0 too: the loss ignores class 0)
    assert set(np.unique(np.concatenate(raw))) <= {0, 10, 11, 15, 18, 20, 30, 31, 32, 40, 44,
                                                   48, 49, 50, 51, 70, 71, 72, 80, 81}


def test_cylinder_through_the_harness(tmp_path):
    """The cylinder loader at batch 2, one epoch, a checkpoint, and
    `evaluate_points` writing the labels of `Segmenter.predict` on the
    same weights and scans."""
    data = {**CYLINDER_TINY["DATA"], "LENGTH": 4, "N_RAW_POINTS": 1500}
    cfg = {**CYLINDER_TINY, "DATA": data}
    p, s = init_params_numpy(cfg, seed=4)
    loaders = {
        t: tdata.build_dataloader(data, training=t, scans_per_shard=2, pipeline_kind="cylinder")
        for t in (True, False)
    }
    assert isinstance(loaders[True].pipeline, CylinderPipeline) and loaders[True].pipeline.training
    tr = Trainer(
        cfg, {"params": p, "batch_stats": s}, "cpu", train_loader=loaders[True],
        val_loader=loaders[False], total_epochs=1, output_dir=tmp_path,
    )
    assert isinstance(tr.model, CylinderTS)
    hist = tr.train()
    assert len(hist[0]["steps"]) == 2 and np.isfinite(hist[0]["loss"])
    assert len(tr.ckptr.list_epochs(tr.ckpt_dir)) == 1
    tr.evaluate_points(save_path=tmp_path / "p")
    pe, se = export_flax_params(tr.model)
    seg = Segmenter(cfg, {"params": pe, "batch_stats": se}, "cpu",
                    point_capacity=loaders[False].point_capacity)
    reader = loaders[False].reader
    got = seg.predict([reader[i] for i in range(len(reader))])
    for i, o in enumerate(got):
        raw = np.fromfile(tmp_path / "p" / "sequences" / "08" / "predictions" / f"{i:06d}.label", np.uint32)
        np.testing.assert_array_equal(LEARNING_MAP_LUT[raw], o["labels"])
