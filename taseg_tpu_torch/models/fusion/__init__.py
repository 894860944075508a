"""Point-voxel fusion models of the port."""

from .spvcnn import SPVCNN, PointTransform

__all__ = ["PointTransform", "SPVCNN"]
