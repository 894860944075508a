"""Range-view post-processing (port of
`taseg_tpu/models/range2d/postproc.py`).

  * `knn_postprocess`: the KNN clean-up of per-point labels, hand kernel
    K9 on CUDA tensors, its plain version on CPU tensors
    (`ops/knn.py`); the range family's raw-point evaluation and
    `Segmenter.predict` run it once per batch of scans;
  * `border_mask` and `crf_refine`: plain torch, as JAX's are plain XLA;
    no path of either package calls them.
"""

from __future__ import annotations

import torch

from ...ops.knn import knn_postprocess, knn_postprocess_plain


def border_mask(
    label_img: torch.Tensor, *, border_size: int = 1, kern_conn: int = 4,
    background_class: int | None = 0,
) -> torch.Tensor:
    """(H, W) int labels -> (H, W) bool border pixels (JAX :81, reference
    borderMask.py:92-195): real classes dilated over the background, then
    a pixel whose 4- or 8-neighbourhood (wrapping around, as `jnp.roll`)
    holds another class is border; the background is never border."""
    lab = label_img
    if background_class is not None:
        for _ in range(border_size):
            fill = _neighbor_stack(lab, kern_conn).max(0).values
            lab = torch.where(lab == background_class, fill, lab)
    eroded = lab
    for _ in range(border_size):
        same = (_neighbor_stack(eroded, kern_conn) == eroded[None]).all(0)
        eroded = torch.where(same, eroded, -1)
    border = eroded != lab
    if background_class is not None:
        border = border & (label_img != background_class)
    return border


def _neighbor_stack(x: torch.Tensor, kern_conn: int) -> torch.Tensor:
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if kern_conn == 8:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    return torch.stack([torch.roll(x, (dy, dx), (0, 1)) for dy, dx in offs])


def crf_refine(
    prob: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, *, iters: int = 3,
    win_h: int = 3, win_w: int = 5, sigma_xyz: float = 0.7, compat: float = 1.0,
) -> torch.Tensor:
    """Locally connected CRF over the range image (JAX :119, reference
    CRF.py:12-140): each iteration adds the xyz-gaussian weighted sum of
    the neighbours' scores (wrapping around) to the log scores and takes
    the softmax.  prob (H, W, C), xyz (H, W, 3), mask (H, W)."""
    m = mask.to(prob.dtype)[..., None]
    p = prob * m
    offs = [
        (dy, dx)
        for dy in range(-(win_h // 2), win_h // 2 + 1)
        for dx in range(-(win_w // 2), win_w // 2 + 1)
        if not (dy == 0 and dx == 0)
    ]
    for _ in range(iters):
        msg = torch.zeros_like(p)
        for dy, dx in offs:
            sx = torch.roll(xyz, (dy, dx), (0, 1))
            sp = torch.roll(p, (dy, dx), (0, 1))
            d2 = ((xyz - sx) ** 2).sum(-1, keepdim=True)
            msg = msg + torch.exp(-d2 / (2.0 * sigma_xyz**2)) * sp
        logit = torch.log(p.clamp(1e-8, 1.0)) + compat * msg
        p = torch.softmax(logit, dim=-1) * m
    return p


__all__ = ["border_mask", "crf_refine", "knn_postprocess", "knn_postprocess_plain"]
