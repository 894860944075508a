"""Model configurations of the port, as dicts with the YAML's layout.

The port reads no YAML (the machine with the card has no YAML parser
guaranteed), so each configuration it serves is written out here; a
test holds every entry equal to its YAML file.
"""

# tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml: the flagship
# single-frame MinkUNet (fields the inference path reads)
MINKUNET_MK34_CR10 = {
    "DATA": {
        "DATASET": "semantickitti",
        "VOXEL_SIZE": 0.05,
        "NUM_POINTS": 1000000,
    },
    "MODEL": {
        "NAME": "MinkUNet",
        "IN_FEATURE_DIM": 4,
        "NUM_CLASS": 20,
        "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock",
        "NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2],
        "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
        "cr": 1.0,
        "DROPOUT_P": 0.0,
        # not in the YAML: per-level voxel capacities as fractions of the
        # 131072-row point capacity, with >= 30% headroom over the
        # synthetic 120k-point scans (level 2 reached 0.232 of it, over
        # the JAX default schedule's 0.22)
        "CAPACITY_SCHEDULE": (1.0, 0.60, 0.30, 0.12, 0.05),
    },
}
