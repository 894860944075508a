"""Sparse-voxel models of the port (counterpart of
`taseg_tpu.models.voxel`, exported under its names)."""

from .backbone_context import UNetCapacities, UNetTopology, build_unet_topology
from .backbones import (
    RESNET21D_BLOCKS,
    ResNetTopology,
    SparseResNet21D,
    SparseResUNet42,
    build_resnet_topology,
    general_downsample,
)
from .cylinder3d import CylinderTS, CylTopology, build_cylinder_topology
from .minkunet import MinkUNet
from .minkunet_mm import MinkUNetMsMm, MinkUNetMsMmNus, SparseEncoderFov, UNet2D

__all__ = [
    "CylinderTS", "CylTopology", "MinkUNet", "MinkUNetMsMm", "MinkUNetMsMmNus",
    "RESNET21D_BLOCKS", "ResNetTopology", "SparseResNet21D", "SparseResUNet42",
    "UNetCapacities", "UNetTopology", "build_cylinder_topology", "build_resnet_topology",
    "SparseEncoderFov", "UNet2D", "build_unet_topology", "general_downsample",
]
