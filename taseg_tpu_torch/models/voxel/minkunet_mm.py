"""MinkUNetMsMm — TIAF: Temporal Image Aggregation & Fusion segmentor (port
of `taseg_tpu/models/voxel/minkunet_mm.py`, train and eval forms;
reference `pcseg/model/segmentor/voxel/minkunet/minkunet_ms_mm.py:341-572`).

  * `UNet2D`, the image branch (SalsaNext-shaped, on the range blocks of
    `models.range2d.blocks`: NHWC f32 `F.conv2d`, flax-style BN, the
    NCHW avg-pool copy), over the stacked window images; its logits feed
    the dense 2D loss, and its [stem ‖ decoder] features and logits are
    gathered at each FOV row's (row, col) pixel (reference
    unet2d.py:189-214) by K7's identity devoxelize over the flat pixel
    rows, whose gradient is K6 over the pixel table;
  * `SparseEncoderFov`, the lidar-FOV branch: a compact sparse UNet (one
    ResBlock per stage) over the FOV-cropped fused cloud, fed [lidar
    features ‖ image features ‖ image logits] (4 + 2 IMAGE_BASE +
    NUM_CLASS channels) and tapped at strides 16 / 4 / 1;
  * `main`, the FSA MinkUNet on the full fused cloud, with its tri-scale
    point features; the FOV taps are interpolated onto the main points
    (FOV -> main trilinear tables, zero outside the FOV) and concatenated
    with them for `classifier_fusion`, on the overlap mask;
  * eval ENSEMBLE_TYPE 'replace': fusion logits overwrite main logits on
    the overlap (minkunet_ms_mm.py:537-538).

The whole model runs in f32, as JAX builds it (its MinkUNet has no
compute dtype: `minkunet.py:77`).  Both topologies carry their levels'
row orders, so every 3^3 conv of both sparse branches takes the f32
route of `sparse_conv.k3_conv`: on the card K2 at K = 27 offsets on
3xTF32 tensor cores over the level's `mask_row_order` wherever C_in and
C_out are multiples of 4, and in training K4 at K = 27 over the level's
pair lists; the main stem's first conv (C_in 5) takes K2 / K4 at 27 on
CUDA cores.  Dropout: `main` at 0.3 (JAX builds it
without DROPOUT_P), the image branch's SalsaNext blocks at 0.2 except
`SalsaResBlock_0` and `SalsaUpBlock_2` (JAX's `d0` and `u1`).

Module names follow the flax tree (`image_backbone`, `lidar_backbone`,
`main`, `classifier_fov`, `classifier_fusion`), so
`utils.params_from_jax` and `engine.load_matching_params` map the two
one to one; an FSA MinkUNetMs checkpoint loads into `main/`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from ..._device import resolve_device
from ...ops.voxelize import (
    IdentityDevoxTable,
    build_segment_tables,
    devoxelize_multi,
    trilinear_table,
    voxelize_avg,
)
from ..layers import ConvBNReLU, Dense, ResidualBlock
from ..range2d.blocks import Conv, ResContextBlock, SalsaResBlock, SalsaUpBlock
from .backbone_context import (
    UNetCapacities,
    UNetTopology,
    build_unet_topology,
    conv_tables,
    host_nonneg,
)
from .minkunet import MinkUNet

# the FOV taps' strides (x4, y2, y4), as the main head's
TAP_STRIDES = (16, 4, 1)
TRAINABLE_PREFIXES = ("image_backbone", "lidar_backbone", "classifier_fusion", "classifier_fov")


class TiafInputs(NamedTuple):
    """What MinkUNetMsMm reads besides the main cloud's point features."""

    topo: UNetTopology  # main fused cloud
    fov_topo: UNetTopology  # FOV-cropped fused cloud
    # stride -> DevoxTable: the FOV level's voxels -> the MAIN points
    fov_devox: dict
    fov_feats: torch.Tensor  # (P_fov, C) f32
    images: torch.Tensor  # (B_img, H, W, 3) f32
    # FOV rows -> flat pixel rows of the (B_img H W) image rows (-1: none)
    pixels: IdentityDevoxTable


def tiaf_inputs(
    arrays: dict, caps: UNetCapacities, fov_caps: UNetCapacities, *, train: bool
) -> TiafInputs:
    """The counterpart of JAX `parallel/tiaf.py:_unpack` on one collated
    shard on the device (`data.voxel_mm.collate_mm_shard` arrays with
    their `_t` tensors): both topologies (the tables that only the
    backward reads where `train`), the FOV -> main trilinear tables at
    strides 1, 4 and 16 (query points: the main cloud; bounds: the FOV
    topology's, so main points outside them query the sentinel and get
    index -1 and weight 0), the pixel table of the FOV rows (rows pre-offset
    by image slot x H; flat index row * W + col clipped into the image
    rows, -1 for padding rows)."""
    main, fov = arrays["main"], arrays["fov"]
    topo = build_unet_topology(
        main["point_coords_t"], main["num_points_t"], caps, devox_pairs=train,
        nonneg_coords=host_nonneg(main["point_coords"]),
    )
    fov_topo = build_unet_topology(
        fov["point_coords_t"], fov["num_points_t"], fov_caps, devox_pairs=train,
        nonneg_coords=host_nonneg(fov["point_coords"]),
    )
    coords = main["point_coords_t"]
    valid = torch.arange(coords.shape[0], device=coords.device) < topo.num_points
    fov_devox = {}
    for s in TAP_STRIDES:
        lvl = fov_topo.levels[s.bit_length() - 1]
        fov_devox[s] = trilinear_table(
            coords, valid, lvl.coords, lvl.num, s, fov_topo.bounds, with_pairs=train
        )
    images = arrays["images_t"]
    b, h, w, _ = images.shape
    rc = arrays["fov_rowcol_t"]
    fvalid = torch.arange(rc.shape[0], device=rc.device) < fov_topo.num_points
    flat = torch.clamp(rc[:, 0] * w + rc[:, 1], 0, b * h * w - 1)
    inv = torch.where(fvalid, flat, -1).to(torch.int32)
    pixels = IdentityDevoxTable(inv, build_segment_tables(inv, b * h * w) if train else None)
    return TiafInputs(
        topo=topo, fov_topo=fov_topo, fov_devox=fov_devox, fov_feats=fov["point_feats_t"],
        images=images, pixels=pixels,
    )


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B H W, C) rows."""
    return x.reshape(-1, x.shape[-1])


class UNet2D(nn.Module):
    """SalsaNext-shaped image UNet with per-point feature gathering
    (reference unet2d.py:154-216): returns the image logits (B, H, W,
    num_classes) plus per-FOV-row [stem ‖ decoder] features (P, 2 base)
    and logits (P, num_classes), 0 on rows without a pixel."""

    def __init__(self, num_classes: int, base: int = 32, device=None):
        super().__init__()
        b, kw = base, dict(device=device)
        self.ResContextBlock_0 = ResContextBlock(3, b, **kw)  # RGB
        self.ResContextBlock_1 = ResContextBlock(b, b, **kw)
        self.SalsaResBlock_0 = SalsaResBlock(b, 2 * b, pooling=True, drop_out=False, **kw)
        self.SalsaResBlock_1 = SalsaResBlock(2 * b, 4 * b, pooling=True, **kw)
        self.SalsaResBlock_2 = SalsaResBlock(4 * b, 4 * b, pooling=True, **kw)
        self.SalsaResBlock_3 = SalsaResBlock(4 * b, 4 * b, pooling=False, **kw)
        self.SalsaUpBlock_0 = SalsaUpBlock(4 * b, 4 * b, 4 * b, **kw)
        self.SalsaUpBlock_1 = SalsaUpBlock(4 * b, 4 * b, 2 * b, **kw)
        self.SalsaUpBlock_2 = SalsaUpBlock(2 * b, 2 * b, b, drop_out=False, **kw)
        self.image_head = Conv(b, num_classes, (1, 1), **kw)

    def forward(self, images: torch.Tensor, pixels: IdentityDevoxTable):
        """images (B, H, W, C) f32, H and W multiples of 8; `pixels` the
        FOV rows' flat pixel rows (`tiaf_inputs`)."""
        x = self.ResContextBlock_1(self.ResContextBlock_0(images))
        stem = x
        d0c, d0b = self.SalsaResBlock_0(x)
        d1c, d1b = self.SalsaResBlock_1(d0c)
        d2c, d2b = self.SalsaResBlock_2(d1c)
        d5c = self.SalsaResBlock_3(d2c)
        u3 = self.SalsaUpBlock_0(d5c, d2b)
        u2 = self.SalsaUpBlock_1(u3, d1b)
        u1 = self.SalsaUpBlock_2(u2, d0b)
        logits = self.image_head(u1.float())
        # [stem ‖ u1] and the logits at the FOV rows' pixels: one K7 launch
        # over the three maps, split after
        g = devoxelize_multi((_flat(stem), _flat(u1), _flat(logits)), (pixels,) * 3)
        c = stem.shape[-1] + u1.shape[-1]
        return logits, g[:, :c], g[:, c:]


class SparseEncoderFov(nn.Module):
    """UNet3D FOV branch (reference unet3d.py:182-316): a compact sparse
    UNet, one ResBlock per stage, over the FOV cloud, tapped at strides
    16 / 4 / 1; f32."""

    def __init__(
        self,
        in_dim: int,
        planes: Sequence[int] = (32, 32, 64, 128, 256, 256, 128, 96, 96),
        cr: float = 0.5,
        device=None,
    ):
        super().__init__()
        cs = [int(cr * x) for x in planes]
        self.widths = cs
        add, kw = self.add_module, dict(device=device)
        add("stem", ConvBNReLU(in_dim, cs[0], 27, **kw))
        ch = cs[0]
        enc_ch = [ch]
        for l in range(1, 5):
            add(f"down{l}", ConvBNReLU(ch, ch, 8, **kw))
            add(f"stage{l}_0", ResidualBlock(ch, cs[l], **kw))
            ch = cs[l]
            enc_ch.append(ch)
        for k, lvl in enumerate((4, 3, 2, 1), start=1):
            out_ch = cs[4 + k]
            add(f"up{k}_deconv", ConvBNReLU(ch, out_ch, 8, transposed=True, **kw))
            add(f"up{k}_blocks_0", ResidualBlock(out_ch + enc_ch[lvl - 1], out_ch, **kw))
            ch = out_ch

    @property
    def tap_widths(self) -> tuple:
        cs = self.widths
        return cs[4], cs[6], cs[8]

    def forward(self, feats: torch.Tensor, topo: UNetTopology):
        """feats (P_fov, in_dim) f32 -> the voxel taps (x4, y2, y4) at
        strides 16, 4, 1."""
        levels = topo.levels
        k3 = conv_tables(topo, self.training)
        if self.training:
            masks = [torch.arange(l.coords.shape[0], device=l.num.device) < l.num for l in levels]
        else:
            masks = [None] * len(levels)
        x0 = voxelize_avg(feats, topo.point_inverse, topo.point_tables)
        x0 = self.stem(x0, k3[0], masks[0])
        enc = [x0]
        x = x0
        for l in range(1, 5):
            x = getattr(self, f"down{l}")(x, levels[l].strided, masks[l])
            x = getattr(self, f"stage{l}_0")(x, k3[l], masks[l])
            enc.append(x)

        def up(x, k, lvl):
            h = getattr(self, f"up{k}_deconv")(x, levels[lvl].strided, masks[lvl - 1])
            h = torch.cat([h, enc[lvl - 1]], dim=-1)
            return getattr(self, f"up{k}_blocks_0")(h, k3[lvl - 1], masks[lvl - 1])

        y1 = up(enc[4], 1, 4)
        y2 = up(y1, 2, 3)
        y3 = up(y2, 3, 2)
        y4 = up(y3, 4, 1)
        return enc[4], y2, y4


class MinkUNetMsMm(nn.Module):
    """TIAF model: `forward(point_feats, inputs)` with the main fused
    cloud's point features (P, in_dim) and a `TiafInputs`; returns
    {"logits" (P, C) (the replace ensemble applied in eval),
    "fusion_logits" (P, C), "overlap" (P,) bool, "image_logits" (B, H, W,
    C), "image_point_logits" (P_fov, C), "fov_point_logits" (P_fov, C)},
    all f32 (JAX `minkunet_mm.py:143-236`)."""

    # the engine builds its inputs with `tiaf_inputs`
    tiaf = True

    def __init__(
        self,
        num_classes: int,
        in_dim: int = 5,
        cr: float = 1.0,
        fov_cr: float = 0.5,
        image_base: int = 32,
        ensemble_type: str = "replace",
        device=None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.in_dim = in_dim
        self.ensemble_type = ensemble_type
        self.image_backbone = UNet2D(num_classes, base=image_base, device=dev)
        self.lidar_backbone = SparseEncoderFov(
            in_dim - 1 + 2 * image_base + num_classes, cr=fov_cr, device=dev
        )
        fov_w = sum(self.lidar_backbone.tap_widths)
        self.classifier_fov = Dense(fov_w, num_classes, device=dev)
        self.main = MinkUNet(num_classes=num_classes, in_dim=in_dim, cr=cr, device=dev)
        main_w = sum(int(cr * c) for c in (256, 128, 96))
        self.classifier_fusion = Dense(main_w + fov_w, num_classes, device=dev)

    def forward(self, point_feats: torch.Tensor, inputs: TiafInputs) -> dict:
        img_logits, img_point_feats, img_point_logits = self.image_backbone(
            inputs.images, inputs.pixels
        )
        # lidar-FOV branch: [lidar ‖ image feats ‖ image logits]
        fov_in = torch.cat(
            [inputs.fov_feats[:, : self.in_dim - 1], img_point_feats, img_point_logits], dim=-1
        )
        taps = self.lidar_backbone(fov_in, inputs.fov_topo)
        fov_tri = devoxelize_multi(taps, [inputs.fov_topo.devox[s] for s in TAP_STRIDES])
        fov_point_logits = self.classifier_fov(fov_tri)

        main_logits, main_tri = self.main(point_feats, inputs.topo, return_features=True)
        # FOV voxel features interpolated onto MAIN points; zero outside
        # the FOV (voxel_to_point_fov, minkunet/utils.py:150-170).  A main
        # point counts as in the overlap where any tapped feature is
        # nonzero, as JAX tests it
        fov_on_main = devoxelize_multi(taps, [inputs.fov_devox[s] for s in TAP_STRIDES])
        overlap = fov_on_main.abs().sum(-1) > 0
        fusion_logits = self.classifier_fusion(torch.cat([main_tri, fov_on_main], dim=-1))
        if not self.training and self.ensemble_type == "replace":
            main_logits = torch.where(overlap[:, None], fusion_logits, main_logits)
        return {
            "logits": main_logits,
            "fusion_logits": fusion_logits,
            "overlap": overlap,
            "image_logits": img_logits,
            "image_point_logits": img_point_logits,
            "fov_point_logits": fov_point_logits,
        }


class MinkUNetMsMmNus(MinkUNetMsMm):
    """nuScenes 6-camera TIAF (JAX `minkunet_mm.py:240`, reference
    minkunet_ms_mm_nus.py:190).  The fusion architecture is
    MinkUNetMsMm's: `images` stacks the six cameras of the selected
    keyframes as one (B_img, H, W, C) tensor and `fov_rowcol` rows arrive
    offset by image slot from the nuScenes reader, so several cameras
    need no new modules."""
