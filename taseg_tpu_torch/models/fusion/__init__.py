"""Point-voxel(-range) fusion models of the port."""

from .rpvnet import RPVNet
from .spvcnn import SPVCNN, PointTransform

__all__ = ["PointTransform", "RPVNet", "SPVCNN"]
