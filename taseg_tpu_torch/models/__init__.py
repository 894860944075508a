"""Models of the port (counterpart of `taseg_tpu.models`), and the
dispatch on `MODEL.NAME` (JAX `models/__init__.py:54 build_segmentor`)."""

from __future__ import annotations

from ..data import feature_columns
from .bev import (
    GlobalAvgPool,
    GlobalMaxPool,
    ToBEVConvolution,
    ToBEVHeightCompression,
    ToBEVReduction,
    ToDenseBEVConvolution,
)
from .fusion.rpvnet import RPVNet
from .range2d.rangenet import RangeNet
from .range2d.resnet_range import CENet, FIDNet
from .range2d.salsanext import SalsaNext
from .fusion.spvcnn import SPVCNN
from .voxel.backbone_context import UNetCapacities, UNetTopology, build_unet_topology
from .voxel.backbones import (
    RESNET21D_BLOCKS,
    ResNetTopology,
    SparseResNet21D,
    SparseResUNet42,
    build_resnet_topology,
)
from .voxel.cylinder3d import CylinderTS
from .voxel.minkunet import MinkUNet
from .voxel.minkunet_mm import MinkUNetMsMm, MinkUNetMsMmNus

# the segmentors the port builds (JAX VOXEL_SEGMENTORS, models/__init__.py:25,
# and Cylinder_TS and MinkUNetMsMm of its SEGMENTORS).  MinkUNetMs (FSA) is
# the MinkUNet backbone on the fused multi-scan cloud (5 input features,
# the time flag among them); MinkUNetMsKd is the KD stage's student (and
# teacher), a MinkUNet too, whose distillation wiring is the Trainer's kd
# step; MinkUNetMsMm is TIAF (camera images, the FOV branch, the fusion
# head), whose five-term loss is the Trainer's tiaf step; MinkUNetMsMmNus
# is TIAF over nuScenes' six cameras, the same modules
SEGMENTORS = {
    "MinkUNet": MinkUNet, "SPVCNN": SPVCNN, "RPVNet": RPVNet, "Cylinder_TS": CylinderTS,
    "MinkUNetMs": MinkUNet, "MinkUNetMsKd": MinkUNet, "MinkUNetMsMm": MinkUNetMsMm,
    "MinkUNetMsMmNus": MinkUNetMsMmNus,
}
# TIAF's models: the `mm` pipeline, `tiaf_inputs`, the Trainer's tiaf step
TIAF_MODELS = ("MinkUNetMsMm", "MinkUNetMsMmNus")
# the range view's 2D segmentors (JAX RANGE_SEGMENTORS, models/__init__.py:38),
# trained and served on the `range` pipeline
RANGE_SEGMENTORS = {"SalsaNext": SalsaNext, "CENet": CENet, "FIDNet": FIDNet, "RangeNet": RangeNet}
SEGMENTORS.update(RANGE_SEGMENTORS)
# the models JAX builds in f32 only: another compute dtype raises
F32_ONLY = ("Cylinder_TS", *TIAF_MODELS, *RANGE_SEGMENTORS)


def stem_width(cfg: dict, default: int) -> int:
    """The input features of a voxel-family model: MODEL.IN_FEATURE_DIM,
    at most the columns its dataset's loader keeps
    (`data.feature_columns`), as JAX's `init` takes the stem's width from
    the loader's batch (`engine.py:449-522`): Waymo's single-frame recipes
    name 5 (xyz, intensity, elongation) and get 4."""
    width = int(cfg["MODEL"].get("IN_FEATURE_DIM", default))
    data = cfg.get("DATA") or {}
    return min(width, feature_columns(data)) if "DATASET" in data else width


def build_segmentor(cfg: dict, device=None, compute_dtype: str = None):
    """The model of a config dict with the YAML's layout (`MODEL.NAME`,
    `PLANES`, `NUM_LAYER`, `cr`, `NUM_CLASS`, `IN_FEATURE_DIM`, `BLOCK`,
    `COMPUTE_DTYPE`, `DROPOUT_P`, `BN_MOMENTUM`, and SPVCNN's
    `MULTI_SCALE`), defaults as in the JAX `build_segmentor`, which passes
    `BN_MOMENTUM` to the MinkUNets (MinkUNet, MinkUNetMs, MinkUNetMsKd)
    and SPVCNN only and `MULTI_SCALE` to SPVCNN
    only (RPVNet keeps momentum 0.1 and its 'concat' head).  Cylinder_TS
    reads `INIT_SIZE` (32) and `IN_FEATURE_DIM` (9; its pre-net is at
    most the pipeline's 9 columns wide, as JAX's parameters come out)
    only, as JAX (`models/__init__.py:58-64`);
    MinkUNetMsMm and MinkUNetMsMmNus read `IN_FEATURE_DIM` (5), `cr`
    (1.0), `FOV_CR` (0.5), `IMAGE_BASE` (32) and `ENSEMBLE_TYPE`
    ('replace') only (:65-75).  The range models read
    `IN_FEATURE_DIM` (6), CENet also `IF_AUX` (True), as JAX (:118-126),
    at their full widths (RangeNet on darknet53).  These run in f32:
    another compute dtype raises.  A name the port has not ported raises, listing
    those it has."""
    m = cfg["MODEL"]
    name = m.get("NAME", "MinkUNet")
    if name not in SEGMENTORS:
        raise ValueError(
            f"MODEL.NAME {name!r} is no segmentor of the port; the port "
            f"builds {sorted(SEGMENTORS)}"
        )
    if name in F32_ONLY:
        dtype = compute_dtype or m.get("COMPUTE_DTYPE", "float32")
        if dtype != "float32":
            raise ValueError(f"{name} runs in float32, as the JAX model; got {dtype!r}")
    if name in RANGE_SEGMENTORS:
        kw = dict(num_classes=m["NUM_CLASS"], in_channels=m.get("IN_FEATURE_DIM", 6), device=device)
        if name == "CENet":
            kw["aux"] = bool(m.get("IF_AUX", True))
        return RANGE_SEGMENTORS[name](**kw)
    if name in TIAF_MODELS:
        return SEGMENTORS[name](
            num_classes=m["NUM_CLASS"], in_dim=stem_width(cfg, 5), cr=m.get("cr", 1.0),
            fov_cr=m.get("FOV_CR", 0.5), image_base=m.get("IMAGE_BASE", 32),
            ensemble_type=m.get("ENSEMBLE_TYPE", "replace"), device=device,
        )
    if name == "Cylinder_TS":
        return CylinderTS(
            num_classes=m["NUM_CLASS"],
            in_dim=m.get("IN_FEATURE_DIM", 9),
            init_size=m.get("INIT_SIZE", 32), device=device,
        )
    kw = dict(
        num_classes=m["NUM_CLASS"],
        in_dim=stem_width(cfg, 4),
        planes=tuple(m.get("PLANES", (32, 32, 64, 128, 256, 256, 128, 96, 96))),
        num_layer=tuple(m.get("NUM_LAYER", (2, 3, 4, 6, 2, 2, 2, 2))),
        block=m.get("BLOCK", "Bottleneck"),
        cr=m.get("cr", 1.0),
        compute_dtype=compute_dtype or m.get("COMPUTE_DTYPE", "float32"),
        dropout_p=float(m.get("DROPOUT_P", 0.3)),
        device=device,
    )
    if SEGMENTORS[name] in (MinkUNet, SPVCNN):
        kw["bn_momentum"] = float(m.get("BN_MOMENTUM", 0.1))
    if name == "SPVCNN":
        kw["multi_scale"] = m.get("MULTI_SCALE", "concat")
    return SEGMENTORS[name](**kw)


__all__ = [
    "GlobalAvgPool", "GlobalMaxPool", "ToBEVConvolution", "ToBEVHeightCompression",
    "ToBEVReduction", "ToDenseBEVConvolution",
    "RESNET21D_BLOCKS", "ResNetTopology", "SparseResNet21D", "SparseResUNet42",
    "UNetCapacities", "UNetTopology", "build_resnet_topology", "build_unet_topology",
    "CENet", "CylinderTS", "FIDNet", "MinkUNet", "MinkUNetMsMm", "MinkUNetMsMmNus",
    "RANGE_SEGMENTORS", "RPVNet", "RangeNet", "SEGMENTORS", "SPVCNN", "SalsaNext",
    "TIAF_MODELS", "build_segmentor",
]
