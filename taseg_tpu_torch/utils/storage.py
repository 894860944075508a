"""Storage: the local filesystem and the Petrel (Ceph / S3) backend, and
checkpoint files (port of `taseg_tpu/utils/storage.py`; reference
`pcseg/data/dataset/ceph.py:52-200`).

Byte- and array-level load/save, listing and removal go through
`get_backend(path)`: `s3://` paths to a `PetrelBackend` (a
`petrel_client.client.Client`, made once when the package is
importable; without it an `s3://` path raises ImportError), every other
path to the local filesystem.  `CheckpointIO` keeps JAX's
`checkpoint_epoch_<n>` naming, listing order and pruning on either: a
checkpoint is what `torch.save` writes, one local file (JAX writes an
orbax directory) or one remote object (JAX pickles its pytree there);
`restore` reads it back with `torch.load(weights_only=False)`.
"""

from __future__ import annotations

import io
import pickle
import shutil
from pathlib import Path

import numpy as np
import torch


def is_remote(path) -> bool:
    return str(path).startswith("s3://")


class LocalBackend:
    def load_bytes(self, path) -> bytes:
        return Path(path).read_bytes()

    def load_bin(self, path, dtype="float32") -> np.ndarray:
        return np.fromfile(path, dtype=np.dtype(dtype))

    def load_npy(self, path) -> np.ndarray:
        return np.load(path)

    def load_pkl(self, path):
        with open(path, "rb") as f:
            return pickle.load(f)

    def save_bytes(self, path, data: bytes) -> None:
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(data)

    def save_bin(self, path, arr: np.ndarray) -> None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        np.asarray(arr).tofile(path)

    def exists(self, path) -> bool:
        return Path(path).exists()

    def listdir(self, path) -> list:
        return sorted(p.name for p in Path(path).iterdir())

    def remove(self, path) -> None:
        """Remove a file or a directory tree (checkpoint pruning)."""
        p = Path(path)
        if p.is_dir():
            shutil.rmtree(p, ignore_errors=True)
        elif p.exists():
            p.unlink()


class PetrelBackend(LocalBackend):
    """Ceph / S3 through petrel-oss-sdk for `s3://` paths, the local
    filesystem for the others (JAX storage.py:59)."""

    def __init__(self, conf_path: str = "~/petreloss.conf"):
        try:
            from petrel_client.client import Client
        except ImportError as e:
            raise ImportError(
                "petrel-oss-sdk (petrel_client) is not installed: s3:// paths need it; "
                "use a local path"
            ) from e
        self._client = Client(conf_path)

    def load_bytes(self, path) -> bytes:
        if is_remote(path):
            return bytes(self._client.get(str(path)))
        return super().load_bytes(path)

    def load_bin(self, path, dtype="float32") -> np.ndarray:
        if is_remote(path):
            # a copy, as np.fromfile gives: callers may write to it
            return np.frombuffer(self.load_bytes(path), dtype=np.dtype(dtype)).copy()
        return super().load_bin(path, dtype)

    def load_npy(self, path) -> np.ndarray:
        if is_remote(path):
            return np.load(io.BytesIO(self.load_bytes(path)))
        return super().load_npy(path)

    def load_pkl(self, path):
        if is_remote(path):
            return pickle.loads(self.load_bytes(path))
        return super().load_pkl(path)

    def save_bytes(self, path, data: bytes) -> None:
        if is_remote(path):
            self._client.put(str(path), data)
            return
        super().save_bytes(path, data)

    def save_bin(self, path, arr: np.ndarray) -> None:
        if is_remote(path):
            self.save_bytes(path, np.asarray(arr).tobytes())
            return
        super().save_bin(path, arr)

    def exists(self, path) -> bool:
        if is_remote(path):
            return bool(self._client.contains(str(path)))
        return super().exists(path)

    def listdir(self, path) -> list:
        if is_remote(path):
            # petrel's `list` yields the names under the prefix
            return sorted(self._client.list(str(path).rstrip("/") + "/"))
        return super().listdir(path)

    def remove(self, path) -> None:
        if is_remote(path):
            self._client.delete(str(path))
            return
        super().remove(path)


_LOCAL = LocalBackend()
_PETREL = None


def get_backend(path) -> LocalBackend:
    """The backend of a path: `s3://` to the (cached) Petrel client,
    anything else to the local filesystem (JAX storage.py:134)."""
    global _PETREL
    if is_remote(path):
        if _PETREL is None:
            _PETREL = PetrelBackend()
        return _PETREL
    return _LOCAL


def load_bytes(path) -> bytes:
    return get_backend(path).load_bytes(path)


def load_bin(path, dtype="float32") -> np.ndarray:
    return get_backend(path).load_bin(path, dtype)


def load_npy(path) -> np.ndarray:
    return get_backend(path).load_npy(path)


def load_pkl(path):
    """A pickled object (nuScenes' info files)."""
    return get_backend(path).load_pkl(path)


def load_image(path):
    """A PIL image (TIAF camera frames).  Pillow is imported here, so
    only a reader of camera images needs it."""
    from PIL import Image

    if is_remote(path):
        return Image.open(io.BytesIO(load_bytes(path)))
    return Image.open(path)


def save_bytes(path, data: bytes) -> None:
    get_backend(path).save_bytes(path, data)


def save_bin(path, arr: np.ndarray) -> None:
    get_backend(path).save_bin(path, arr)


def exists(path) -> bool:
    return get_backend(path).exists(path)


def listdir(path) -> list:
    return get_backend(path).listdir(path)


def remove(path) -> None:
    get_backend(path).remove(path)


class CheckpointIO:
    """Checkpoint save / restore / list / prune on either backend."""

    def save(self, path, payload) -> None:
        if is_remote(path):
            buf = io.BytesIO()
            torch.save(payload, buf)
            save_bytes(path, buf.getvalue())
            return
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        torch.save(payload, p)

    def restore(self, path, map_location=None):
        src = io.BytesIO(load_bytes(path)) if is_remote(path) else Path(path)
        return torch.load(src, map_location=map_location, weights_only=False)

    def list_epochs(self, ckpt_dir) -> list:
        """Sorted [(epoch, full_path)] of `checkpoint_epoch_*` under
        ckpt_dir (reference auto-resume scan, train.py:232-242)."""
        if is_remote(ckpt_dir):
            names = listdir(ckpt_dir)
        else:
            d = Path(ckpt_dir)
            names = [p.name for p in d.glob("checkpoint_epoch_*")] if d.exists() else []
        found = []
        for name in names:
            tail = name.rstrip("/").rsplit("/", 1)[-1]
            if not tail.startswith("checkpoint_epoch_"):
                continue
            try:
                epoch = int(tail.rsplit("_", 1)[1])
            except ValueError:
                continue
            found.append((epoch, f"{str(ckpt_dir).rstrip('/')}/{tail}"))
        return sorted(found)

    def remove(self, path) -> None:
        remove(path)
