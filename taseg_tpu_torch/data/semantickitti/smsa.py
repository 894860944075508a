"""SMSA — Static-Moving Switch Augmentation (26-class multi-scan task);
copy of `taseg_tpu/data/semantickitti/smsa.py`.

Capability match of the reference
(`pcseg/data/dataset/semantickitti/semantickitti_ms_ms.py:305-384`):

  * static2moving: a static truck(18)/other-vehicle(20) instance is turned
    into a moving one (258/259) by translating its points proportionally to
    their frame delta (synthetic temporal motion), with a lane-aware lateral
    nudge when the instance is elongated along x;
  * moving2static: a moving bicyclist(253)/motorcyclist(255) instance is
    frozen into its static class (31/32) by cancelling its observed
    per-frame motion (extrapolated from the delta = -step history frame).

Both operate on raw (pre-learning-map) labels with the instance id from
the upper 16 bits of the .label uint32, on the frame + fused clouds
coherently, and are train-split only.
"""

from __future__ import annotations

import numpy as np

MOVING_TRUCK, MOVING_OTHER_VEH = 258, 259
STATIC_TRUCK, STATIC_OTHER_VEH = 18, 20
MOVING_BICYCLIST, MOVING_MOTORCYCLIST = 253, 255
STATIC_BICYCLIST, STATIC_MOTORCYCLIST = 31, 32


def static2moving(
    frame_pts, frame_raw, frame_inst,
    fused_pts, fused_raw, fused_inst, fused_delta,
    *,
    rng: np.random.Generator,
    prob: float = 0.5,
    shift_x_range: float = 1.0,
    shift_y_range: float = 1.0,
):
    """Synthesize motion for static truck / other-vehicle instances."""
    target = (frame_raw == STATIC_TRUCK) | (frame_raw == STATIC_OTHER_VEH)
    for inst in np.unique(frame_inst[target]):
        if rng.random() > prob:
            continue
        m = frame_inst == inst
        m_ms = fused_inst == inst
        if not m_ms.any():
            continue
        pc = fused_pts[m_ms]
        elongated_x = (
            pc[:, 0].max() - pc[:, 0].min() > pc[:, 1].max() - pc[:, 1].min()
        )
        if elongated_x:
            center_y = pc[:, 1].mean()
            if center_y > 4:  # pull toward the ego lane
                shift = 2 + rng.random() * 3
                fused_pts[m_ms, 1] -= shift
                frame_pts[m, 1] -= shift
            elif center_y < -2:
                shift = 2 + rng.random() * 3
                fused_pts[m_ms, 1] += shift
                frame_pts[m, 1] += shift
            step = rng.random() * shift_x_range + 0.5
            fused_pts[m_ms, 0] += fused_delta[m_ms] * step
        else:
            step = rng.random() * shift_y_range + 0.5
            fused_pts[m_ms, 1] += fused_delta[m_ms] * step

        for static_id, moving_id in (
            (STATIC_TRUCK, MOVING_TRUCK),
            (STATIC_OTHER_VEH, MOVING_OTHER_VEH),
        ):
            frame_raw[m & (frame_raw == static_id)] = moving_id
            fused_raw[m_ms & (fused_raw == static_id)] = moving_id
    return frame_pts, frame_raw, fused_pts, fused_raw


def moving2static(
    frame_pts, frame_raw, frame_inst,
    fused_pts, fused_raw, fused_inst, fused_delta,
    *,
    rng: np.random.Generator,
    prob: float = 0.5,
    min_points: int = 20,
):
    """Freeze moving bicyclist / motorcyclist instances by cancelling their
    observed per-frame displacement."""
    target = (frame_raw == MOVING_BICYCLIST) | (frame_raw == MOVING_MOTORCYCLIST)
    for inst in np.unique(frame_inst[target]):
        if rng.random() > prob:
            continue
        m = frame_inst == inst
        m_ms = fused_inst == inst
        prev = m_ms & (fused_delta == -1)
        if m.sum() < min_points or not m_ms.any() or not prev.any():
            continue
        cur = frame_pts[m]
        shift_x = fused_pts[prev][:, 0].mean() - cur[:, 0].mean()
        shift_y = fused_pts[prev][:, 1].mean() - cur[:, 1].mean()
        # cancel the per-frame motion: history frame at delta d moves by
        # -d * per-frame displacement (delta is negative for history)
        fused_pts[m_ms, 0] += fused_delta[m_ms] * shift_x
        fused_pts[m_ms, 1] += fused_delta[m_ms] * shift_y

        for moving_id, static_id in (
            (MOVING_BICYCLIST, STATIC_BICYCLIST),
            (MOVING_MOTORCYCLIST, STATIC_MOTORCYCLIST),
        ):
            frame_raw[m & (frame_raw == moving_id)] = static_id
            fused_raw[m_ms & (fused_raw == moving_id)] = static_id
    return frame_pts, frame_raw, fused_pts, fused_raw
