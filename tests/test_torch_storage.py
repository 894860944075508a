"""The port's Petrel (`s3://`) storage backend and remote checkpoints
(`taseg_tpu_torch.utils.storage`) against an in-test stand-in for
`petrel_client`, as `tests/test_storage.py:108-153` holds JAX's, on the
CPU.

The stand-in client keeps every object in a dict.  Arrays, pickles and
bytes round-trip through `s3://` paths (a loaded array is writable, as
`np.fromfile`'s); a local path next to them still goes to the
filesystem; `CheckpointIO` saves, lists, restores and prunes
`checkpoint_epoch_<n>` objects through the client alone; and a
`Trainer` with an `s3://` CKPT_DIR saves its checkpoint (EQLv2's
statistics in it) there, a fresh one resumes from it bit for bit, and
the next step of both gives the same bits.
JAX's backend reads the same store: arrays saved by one side load on
the other.  About 35 s alone (`--durations`), 30 s of it
the Trainer case (its two Trainers and two steps); 102 s in the 6-worker
tier-1 run.
"""

import copy
import pickle
import sys
import types

import numpy as np
import pytest
import torch

from taseg_tpu.utils import storage as jst
from taseg_tpu_torch.configs import MINKUNET_TINY
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.engine import Trainer
from taseg_tpu_torch.utils import storage as tst
from taseg_tpu_torch.utils.params_from_jax import init_params_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def store(monkeypatch):
    """A stand-in `petrel_client` over a dict, installed for both
    packages; their cached backends reset."""
    objects = {}

    class Client:
        def __init__(self, conf):
            self.conf = conf

        def get(self, path):
            return objects[path]

        def put(self, path, data):
            objects[path] = bytes(data)

        def contains(self, path):
            return path in objects

        def list(self, prefix):
            return [k[len(prefix):].split("/", 1)[0] for k in objects if k.startswith(prefix)]

        def delete(self, path):
            objects.pop(path, None)

    mod = types.ModuleType("petrel_client.client")
    mod.Client = Client
    pkg = types.ModuleType("petrel_client")
    pkg.client = mod
    monkeypatch.setitem(sys.modules, "petrel_client", pkg)
    monkeypatch.setitem(sys.modules, "petrel_client.client", mod)
    monkeypatch.setattr(tst, "_PETREL", None)
    monkeypatch.setattr(jst, "_PETREL", None)
    return objects


def test_petrel_backend_round_trips(store, tmp_path):
    assert isinstance(tst.get_backend("s3://bucket/x.bin"), tst.PetrelBackend)
    assert isinstance(tst.get_backend(tmp_path / "x.bin"), tst.LocalBackend)
    arr = np.arange(7, dtype=np.float32)
    tst.save_bin("s3://bucket/x.bin", arr)
    got = tst.load_bin("s3://bucket/x.bin", "float32")
    assert np.array_equal(got, arr)
    got[0] = 5.0  # writable, as np.fromfile's
    assert tst.exists("s3://bucket/x.bin") and not tst.exists("s3://bucket/missing.bin")
    tst.save_bytes("s3://bucket/p.pkl", pickle.dumps([3, 4]))
    assert tst.load_pkl("s3://bucket/p.pkl") == [3, 4]
    buf = __import__("io").BytesIO()
    np.save(buf, arr.reshape(7, 1))
    tst.save_bytes("s3://bucket/a.npy", buf.getvalue())
    assert tst.load_npy("s3://bucket/a.npy").shape == (7, 1)
    assert tst.listdir("s3://bucket") == ["a.npy", "p.pkl", "x.bin"]
    tst.remove("s3://bucket/a.npy")
    assert not tst.exists("s3://bucket/a.npy")
    # the two packages read each other's objects
    assert np.array_equal(jst.load_bin("s3://bucket/x.bin", "float32"), arr)
    jst.save_bin("s3://bucket/j.bin", arr * 2)
    assert np.array_equal(tst.load_bin("s3://bucket/j.bin"), arr * 2)
    # a local path beside them
    tst.save_bin(tmp_path / "l.bin", arr)
    assert np.array_equal(tst.load_bin(tmp_path / "l.bin"), arr)
    assert all(k.startswith("s3://") for k in store)


def test_checkpoint_io_s3_roundtrip(store):
    io = tst.CheckpointIO()
    root = "s3://bucket/exp/ckpt"
    for epoch in (1, 2, 3):
        io.save(f"{root}/checkpoint_epoch_{epoch}", {"w": torch.arange(4.0) * epoch, "epoch": epoch})
    io.save(f"{root}/other", {"x": 1})
    found = io.list_epochs(root)
    assert [e for e, _ in found] == [1, 2, 3]
    got = io.restore(found[-1][1])
    assert got["epoch"] == 3 and torch.equal(got["w"], torch.arange(4.0) * 3)
    io.remove(found[0][1])
    assert [e for e, _ in io.list_epochs(root)] == [2, 3]
    assert all(k.startswith("s3://") for k in store)


def test_trainer_checkpoint_on_s3_resumes_bit_for_bit(store, tmp_path):
    """The tiny recipe with EQLv2 in its loss and an s3:// CKPT_DIR: a
    step, a checkpoint through the client, a fresh Trainer resumed from
    it holds the same parameters, optimizer count and EQLv2 statistics."""
    cfg = {
        **MINKUNET_TINY, "CKPT_DIR": "s3://bucket/run/ckpt",
        "MODEL": {**MINKUNET_TINY["MODEL"], "LOSS_CONFIG": {
            "LOSS_TYPES": ["CELoss", "LovLoss", "EQLv2"], "LOSS_WEIGHTS": [1.0, 1.0, 1.0]}},
    }
    p, s = init_params_numpy(cfg, seed=1)
    rng = np.random.default_rng(4)
    scans = []
    for _ in range(1):
        pts, labels = synthetic_scan(rng, 2000)
        scans.append({"xyzret": np.concatenate([pts, np.zeros((len(pts), 1), np.float32)], 1), "labels": labels})

    def trainer():
        return Trainer(cfg, {"params": p, "batch_stats": s}, device="cpu", iters_per_epoch=2,
                       total_epochs=2, batch_size=1, seed=3, output_dir=tmp_path)

    a = trainer()
    assert a.ckpt_dir == "s3://bucket/run/ckpt"
    for scan in scans:
        a.step([scan])
    assert (a.loss_state.pos_grad > 0).any() and (a.loss_state.neg_grad > 0).all()
    a.save_checkpoint(0)
    assert "s3://bucket/run/ckpt/checkpoint_epoch_0" in store
    b = trainer()
    assert b.resume_latest() and b.start_epoch == 1
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    assert b.optimizer.count == a.optimizer.count == 1
    for x, y in zip(a.loss_state, b.loss_state):
        assert torch.equal(x, y)
    assert not (tmp_path / "ckpt").exists()
    # one more step each on the same shard: the resumed run goes on as
    # the unbroken one
    arrays = a.collate(scans)
    arrays_b = copy.deepcopy(arrays)
    a.train_on(arrays)
    b.train_on(arrays_b)
    for (k, x), y in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(x, y), k
    for x, y in zip(a.loss_state, b.loss_state):
        assert torch.equal(x, y)
