"""Waymo Open Dataset: the reader of the preprocessed per-frame returns
(copy of `taseg_tpu/data/waymo/`)."""

from .reader import WAYMO_CLASS_NAMES, WaymoReader

__all__ = ["WAYMO_CLASS_NAMES", "WaymoReader"]
