"""Narrow cr 1.6 recipes for the port's tests.

The five cr 1.6 recipes build MinkUNet and SPVCNN at widths int(1.6 x
PLANES): 51, 102, 204, 409, 153 and the decoder's concatenations 613 and
306, none a multiple of 8.  `narrow_cr16` keeps a recipe's cr and cuts
its PLANES to NARROW_PLANES, which cr 1.6 makes 12, 12, 25, 51, 102, 102,
51, 38, 38 (ragged too: every conv takes the padded routes on the card),
one block a stage.
"""

from taseg_tpu_torch.configs import RECIPES

NARROW_PLANES = [8, 8, 16, 32, 64, 64, 32, 24, 24]
CR16_RECIPES = (
    "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr16.yaml",
    "tools/cfgs/voxel/waymo/minkunet_mk34_cr16.yaml",
    "tools/cfgs/voxel/waymo/minkunet_mk34_cr16_xyz.yaml",
    "tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr16.yaml",
    "tools/cfgs/fusion/waymo/spvcnn_mk34_cr16.yaml",
)


def narrow_cr16(path: str, **model) -> dict:
    """The recipe at `path` with NARROW_PLANES, one block a stage, and
    `model`'s MODEL keys on top."""
    cfg = RECIPES[path]
    return {**cfg, "MODEL": {**cfg["MODEL"], "PLANES": list(NARROW_PLANES), "NUM_LAYER": [1] * 8, **model}}
