"""The range view's KNN clean-up, hand kernel K9 (`csrc/knn_postproc.cu`).

Counterpart of JAX `models/range2d/postproc.py:19 knn_postprocess`, an
XLA op chain (reference `rangenet/postproc/KNN.py:36-142`): each point
looks at the ks x ks window of range-image pixels around its pixel, takes
the k nearest by the range difference |pixel range - point range| with
the inverse-gaussian penalty of its window offset (d * w[o] + d), and
the majority of their predicted labels within `cutoff`:

  * the window in dy-major order; pixels outside the image read range
    1e9 and label 0;
  * the k smallest distances, ties to the lower window index (as
    `lax.top_k` of the negated distances);
  * the vote counts the labels 1 .. C-1 of the kept candidates within the
    cutoff (every candidate where cutoff <= 0); the lowest label among
    equal counts wins; a point with no candidate within the cutoff keeps
    its own pixel's label.  A point whose candidates within the cutoff
    all carry label 0 has a vote (JAX counts class 0 in `has_vote`)
    whose counts are [-1, 0, ...]: label 1, as JAX gives it.

`knn_postprocess` takes a batch of images (B, H, W) and each point's
image index, so one call (one K9 launch on the card) serves a batch of
scans.  It runs the window and k of every caller (JAX's defaults: a 5 x
5 window, k = 5) and takes a cutoff above 0 only;
`knn_postprocess_plain` keeps JAX's general signature.  On CUDA tensors
it launches K9 (one thread a point in blocks of 256 consecutive points;
the window weights passed by value; the k best kept in registers by
insertion; the multiply and add of the penalty rounded apart, as XLA and
torch round them); on CPU tensors it runs the plain version, JAX's steps
in torch.  K9 moves 20 bytes per point (its range, column, row and image
in, its label out) and reads at most 25 pixels of 8 bytes per point,
most from cache: it is bound by the bytes it moves.  `knn_postprocess_v1`
is its first design, the yardstick of chip_smoke.py, on no path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# the window's side and the candidates kept, K9's compile-time constants
KERNEL_SIZE = 5
K = 5
# the range of a pixel outside the image (JAX postproc.py:47)
BIG = 1e9


def inv_gauss(kernel_size: int, sigma: float) -> np.ndarray:
    """(ks * ks,) f32 penalty per window offset, dy-major: 1 - the
    gaussian of the offset, computed in float64 and rounded (JAX
    postproc.py:37-39)."""
    half = kernel_size // 2
    xs = np.arange(-half, half + 1)
    g = np.exp(-(xs[:, None] ** 2 + xs[None, :] ** 2) / (2 * sigma**2))
    return (1.0 - g.reshape(-1)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _host_weights(sigma: float) -> tuple[np.ndarray, int]:
    """K9's `inv_gauss` in host memory and its address: the C entry
    copies it into the launch's arguments."""
    w = np.ascontiguousarray(inv_gauss(KERNEL_SIZE, sigma))
    w.setflags(write=False)
    return w, w.ctypes.data


@functools.lru_cache(maxsize=None)
def _device_weights(sigma: float, device: torch.device) -> torch.Tensor:
    """The first design's `inv_gauss` on `device`, copied there once per
    sigma."""
    return torch.from_numpy(inv_gauss(KERNEL_SIZE, sigma)).to(device)


def _as_batch(proj_range, proj_argmax, img, n_points: int):
    if proj_range.dim() == 2:
        proj_range, proj_argmax = proj_range[None], proj_argmax[None]
    if img is None:
        if proj_range.shape[0] != 1:
            raise ValueError("several images need each point's image index `img`")
        img = torch.zeros(n_points, dtype=torch.int32, device=proj_range.device)
    return proj_range, proj_argmax, img


def knn_postprocess_plain(
    proj_range, unproj_range, proj_argmax, px, py, img=None, *, num_classes: int, k: int = 5,
    kernel_size: int = 5, sigma: float = 1.0, cutoff: float = 1.0,
) -> torch.Tensor:
    """K9's plain version, JAX's steps over a batch of images: the
    shifted copies of the padded images, the (ks * ks, P) gather, the k
    nearest (a stable ascending sort, so ties go to the lower window
    index as in `lax.top_k`), the one-hot vote."""
    proj_range, proj_argmax, img = _as_batch(proj_range, proj_argmax, img, unproj_range.shape[0])
    _, h, w = proj_range.shape
    half = kernel_size // 2
    pad = (half, half, half, half)
    padded_r = F.pad(proj_range.float(), pad, value=BIG)
    padded_l = F.pad(proj_argmax, pad, value=0)
    i, y, x = img.long(), py.long(), px.long()
    win_r, win_l = [], []
    for dy in range(kernel_size):
        for dx in range(kernel_size):
            win_r.append(padded_r[i, y + dy, x + dx])
            win_l.append(padded_l[i, y + dy, x + dx])
    pr, pl = torch.stack(win_r), torch.stack(win_l)  # (K2, P)
    g = torch.from_numpy(inv_gauss(kernel_size, sigma)).to(pr.device)[:, None]
    dist = (pr - unproj_range[None, :]).abs()
    dist = dist * g + dist
    knn_dist, top_idx = torch.sort(dist.t(), dim=1, stable=True)
    knn_dist, top_idx = knn_dist[:, :k], top_idx[:, :k]
    knn_label = torch.take_along_dim(pl.t(), top_idx, dim=1).long()
    ok = knn_dist <= cutoff if cutoff > 0 else torch.ones_like(knn_dist, dtype=torch.bool)
    in_range = (knn_label >= 0) & (knn_label < num_classes)
    votes = F.one_hot(knn_label.clamp(0, num_classes - 1), num_classes) * (ok & in_range)[..., None]
    counts = votes.sum(1).float()
    has_vote = counts.sum(-1) > 0
    counts[:, 0] = -1.0
    voted = counts.argmax(-1).to(torch.int32)
    direct = proj_argmax[i, y, x].to(torch.int32)
    return torch.where(has_vote, voted, direct)


def _checked(proj_range, unproj_range, proj_argmax, px, py, img, cutoff) -> None:
    """The arguments of K9 and of its first design: dtypes, ranks, one
    device, matching point counts, a cutoff above 0."""
    dev = proj_range.device
    nd = proj_range.dim()
    if nd not in (2, 3):
        raise ValueError(f"proj_range: expected (H, W) or (B, H, W), got {tuple(proj_range.shape)}")
    _build.check("proj_range", proj_range, (torch.float32,), nd, dev)
    _build.check("proj_argmax", proj_argmax, (torch.int32,), nd, dev)
    _build.check("unproj_range", unproj_range, (torch.float32,), 1, dev)
    _build.check("px", px, (torch.int32,), 1, dev)
    _build.check("py", py, (torch.int32,), 1, dev)
    if proj_argmax.shape != proj_range.shape:
        raise ValueError(f"proj_argmax {tuple(proj_argmax.shape)} != proj_range {tuple(proj_range.shape)}")
    p = unproj_range.shape[0]
    if px.shape[0] != p or py.shape[0] != p:
        raise ValueError(f"px / py: {px.shape[0]} / {py.shape[0]} points, unproj_range has {p}")
    if img is not None:
        _build.check("img", img, (torch.int32,), 1, dev)
        if img.shape[0] != p:
            raise ValueError(f"img: {img.shape[0]} points, unproj_range has {p}")
    if not cutoff > 0:
        raise ValueError(f"cutoff {cutoff}: K9 needs a cutoff above 0 (knn_postprocess_plain takes any)")


def _launch(entry: str, counters: tuple, weights: int, proj_range, unproj_range, proj_argmax, px, py, img,
            num_classes: int, cutoff: float) -> torch.Tensor:
    p = unproj_range.shape[0]
    proj_range, proj_argmax, img = _as_batch(proj_range, proj_argmax, img, p)
    b, h, w = proj_range.shape
    if b * h * w >= 2**31:
        raise ValueError(f"K9 indexes the images with 32-bit ints: {b} x {h} x {w} pixels")
    out = torch.empty(p, dtype=torch.int32, device=proj_range.device)
    if p:
        _build.launch(
            entry, counters, proj_range.data_ptr(), proj_argmax.data_ptr(), unproj_range.data_ptr(),
            px.data_ptr(), py.data_ptr(), img.data_ptr(), weights, out.data_ptr(), p, h, w, num_classes,
            float(cutoff),
        )
    return out


def knn_postprocess(
    proj_range: torch.Tensor, unproj_range: torch.Tensor, proj_argmax: torch.Tensor,
    px: torch.Tensor, py: torch.Tensor, img: torch.Tensor = None, *, num_classes: int,
    sigma: float = 1.0, cutoff: float = 1.0,
) -> torch.Tensor:
    """K9.  proj_range (B, H, W) or (H, W) f32, unproj_range (P,) f32,
    proj_argmax like proj_range int32, px / py (P,) int32 (each point's
    column and row, inside the image), img (P,) int32 (each point's
    image; None for one image) -> (P,) int32 labels, with K9's window
    and k (`KERNEL_SIZE`, `K`) and a `cutoff` above 0."""
    _checked(proj_range, unproj_range, proj_argmax, px, py, img, cutoff)
    if not _build.dispatch(proj_range):
        return knn_postprocess_plain(proj_range, unproj_range, proj_argmax, px, py, img, num_classes=num_classes,
                                     k=K, kernel_size=KERNEL_SIZE, sigma=sigma, cutoff=cutoff)
    return _launch("taseg_knn_postproc", ("knn",), _host_weights(float(sigma))[1], proj_range, unproj_range,
                   proj_argmax, px, py, img, num_classes, cutoff)


def knn_postprocess_v1(proj_range, unproj_range, proj_argmax, px, py, img=None, *, num_classes: int,
                       sigma: float = 1.0, cutoff: float = 1.0) -> torch.Tensor:
    """K9's first design (C entry `taseg_knn_postproc_v1`: int64
    index math and a bounds test a pixel, the weights from device
    memory) on CUDA tensors, behind K9's own argument checks, counted
    nowhere: the yardstick `old_ms` of chip_smoke.py and the card tests,
    on no path."""
    _checked(proj_range, unproj_range, proj_argmax, px, py, img, cutoff)
    return _launch("taseg_knn_postproc_v1", (), _device_weights(float(sigma), proj_range.device).data_ptr(),
                   proj_range, unproj_range, proj_argmax, px, py, img, num_classes, cutoff)
