"""Storage: the local filesystem backend and checkpoint files.

Port of the local half of `taseg_tpu/utils/storage.py` (reference
`pcseg/data/dataset/ceph.py:52-200`): byte- and array-level load/save,
listing and removal, and `CheckpointIO` with JAX's `checkpoint_epoch_<n>`
naming, listing order and pruning.  A checkpoint is one file written by
`torch.save` (JAX writes an orbax directory); `restore` reads it back with
`torch.load(weights_only=False)`.  `s3://` paths (the Petrel backend)
raise: ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import pickle
import shutil
from pathlib import Path

import numpy as np
import torch


def is_remote(path) -> bool:
    return str(path).startswith("s3://")


def _local(path) -> Path:
    if is_remote(path):
        raise NotImplementedError(
            f"{path}: the s3/Petrel storage backend is not ported yet "
            f"(ROADMAP Queue 1 item 7); use a local path"
        )
    return Path(path)


def load_bytes(path) -> bytes:
    return _local(path).read_bytes()


def load_bin(path, dtype="float32") -> np.ndarray:
    return np.fromfile(_local(path), dtype=np.dtype(dtype))


def load_npy(path) -> np.ndarray:
    return np.load(_local(path))


def load_pkl(path):
    """A pickled object (nuScenes' info files)."""
    with open(_local(path), "rb") as f:
        return pickle.load(f)


def load_image(path):
    """A PIL image (TIAF camera frames).  Pillow is imported here, so
    only a reader of camera images needs it."""
    from PIL import Image

    return Image.open(_local(path))


def save_bytes(path, data: bytes) -> None:
    p = _local(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(data)


def save_bin(path, arr: np.ndarray) -> None:
    p = _local(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.asarray(arr).tofile(p)


def exists(path) -> bool:
    return _local(path).exists()


def listdir(path) -> list:
    return sorted(p.name for p in _local(path).iterdir())


def remove(path) -> None:
    """Remove a file or a directory tree (checkpoint pruning)."""
    p = _local(path)
    if p.is_dir():
        shutil.rmtree(p, ignore_errors=True)
    elif p.exists():
        p.unlink()


class CheckpointIO:
    """Checkpoint save / restore / list / prune on the local filesystem."""

    def save(self, path, payload) -> None:
        p = _local(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        torch.save(payload, p)

    def restore(self, path, map_location=None):
        return torch.load(_local(path), map_location=map_location, weights_only=False)

    def list_epochs(self, ckpt_dir) -> list:
        """Sorted [(epoch, full_path)] of `checkpoint_epoch_*` under
        ckpt_dir (reference auto-resume scan, train.py:232-242)."""
        d = _local(ckpt_dir)
        found = []
        for p in d.glob("checkpoint_epoch_*") if d.exists() else []:
            try:
                epoch = int(p.name.rsplit("_", 1)[1])
            except ValueError:
                continue
            found.append((epoch, f"{str(ckpt_dir).rstrip('/')}/{p.name}"))
        return sorted(found)

    def remove(self, path) -> None:
        remove(path)
