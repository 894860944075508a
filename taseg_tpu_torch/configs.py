"""Model configurations of the port, as dicts with the YAML's layout.

The port reads no YAML (the machine with the card has no YAML parser
guaranteed), so each configuration it serves is written out here and
registered in `RECIPES` under its YAML file's path, relative to the
repository (`utils.config.load_config` looks it up there); a test holds
every entry equal to its YAML file.
"""

# tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml: the flagship
# single-frame MinkUNet (fields the inference and train paths read)
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
        "LABEL_SMOOTHING": 0.1,
        "LOSS_CONFIG": {
            "LOSS_TYPES": ["CELoss", "LovLoss"],
            "LOSS_WEIGHTS": [1.0, 1.0],
        },
        # not in the YAML: per-level voxel capacities as fractions of the
        # 131072-row point capacity, with >= 30% headroom over the
        # synthetic 120k-point scans (level 2 reached 0.232 of it, over
        # the JAX default schedule's 0.22)
        "CAPACITY_SCHEDULE": (1.0, 0.60, 0.30, 0.12, 0.05),
        # not in the YAML: the train step's capacities.  The training
        # augmentation (scale up to 1.1, rotation) raises the coarse
        # levels' occupancy of the same scans by up to 64% (worst over 36
        # augmented 120k-point scans: 0.73 / 0.55 / 0.26 / 0.114 / 0.040
        # of the point capacity), so the train step has its own headroom
        "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.70, 0.35, 0.15, 0.06),
    },
    "OPTIM": {
        "BATCH_SIZE_PER_GPU": 12,
        "NUM_EPOCHS": 36,
        "OPTIMIZER": "sgd",
        "LR_PER_SAMPLE": 0.02,
        "WEIGHT_DECAY": 0.0001,
        "MOMENTUM": 0.9,
        "NESTEROV": True,
        "GRAD_NORM_CLIP": 10.0,
        "SCHEDULER": "linear_warmup_with_cosdecay",
        "WARMUP_EPOCH": 1,
    },
}

# tools/cfgs/voxel/synthetic/minkunet_tiny.yaml: the fast end-to-end
# smoke recipe of the CLI (MinkUNet cr 0.125, one block per stage)
MINKUNET_TINY = {
    "MODALITY": "voxel",
    "DATA": {
        "DATASET": "synthetic",
        "LENGTH": 8,
        "N_RAW_POINTS": 4000,
        "VOXEL_SIZE": 0.2,
        "NUM_POINTS": 4096,
    },
    "MODEL": {
        "NAME": "MinkUNet",
        "IN_FEATURE_DIM": 4,
        "NUM_CLASS": 20,
        "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock",
        "NUM_LAYER": [1, 1, 1, 1, 1, 1, 1, 1],
        "cr": 0.125,
        "DROPOUT_P": 0.0,
        "LOSS_CONFIG": {
            "LOSS_TYPES": ["CELoss", "LovLoss"],
            "LOSS_WEIGHTS": [1.0, 1.0],
        },
        # not in the YAML: per-level voxel capacities as fractions of the
        # 4096-row point capacity.  At voxel 0.2 the 4000-point scans fill
        # the coarse levels far more than the default schedule allows
        # (worst over the 8 train scans of 2 epochs and the 8 val scans:
        # 0.66 / 0.39 / 0.15 / 0.066), and the port raises on overflow
        "CAPACITY_SCHEDULE": (1.0, 0.90, 0.55, 0.25, 0.125),
    },
    "OPTIM": {
        "BATCH_SIZE_PER_GPU": 1,
        "NUM_EPOCHS": 1,
        "OPTIMIZER": "sgd",
        "LR_PER_SAMPLE": 0.01,
        "WEIGHT_DECAY": 0.0001,
        "MOMENTUM": 0.9,
        "SCHEDULER": "linear_warmup_with_cosdecay",
        "WARMUP_EPOCH": 1,
    },
}

# tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr10.yaml: SPVCNN, the
# MinkUNet mk34 backbone with the point branch (the JAX CLI runs its
# MODALITY fusion on the voxel pipeline); the YAML's IF_DIST (cross-device
# BN) is left out, the port runs one device
SPVCNN_MK34_CR10 = {
    "MODALITY": "fusion",
    "DATA": {
        "DATASET": "semantickitti",
        "VOXEL_SIZE": 0.05,
        "NUM_POINTS": 1000000,
    },
    "MODEL": {
        "NAME": "SPVCNN",
        "IN_FEATURE_DIM": 4,
        "NUM_CLASS": 20,
        "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock",
        "NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2],
        "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
        "cr": 1.0,
        "DROPOUT_P": 0.0,
        "LABEL_SMOOTHING": 0.0,
        "LOSS_CONFIG": {
            "LOSS_TYPES": ["CELoss", "LovLoss"],
            "LOSS_WEIGHTS": [1.0, 1.0],
        },
        # not in the YAML: the MinkUNet recipe's capacities (the voxel
        # levels are those of the same scans at the same voxel size)
        "CAPACITY_SCHEDULE": (1.0, 0.60, 0.30, 0.12, 0.05),
        "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.70, 0.35, 0.15, 0.06),
    },
    "OPTIM": {
        "BATCH_SIZE_PER_GPU": 12,
        "NUM_EPOCHS": 36,
        "OPTIMIZER": "sgd",
        "LR_PER_SAMPLE": 0.02,
        "WEIGHT_DECAY": 0.0001,
        "MOMENTUM": 0.9,
        "NESTEROV": True,
        "GRAD_NORM_CLIP": 10.0,
        "SCHEDULER": "linear_warmup_with_cosdecay",
        "WARMUP_EPOCH": 1,
    },
}

# tools/cfgs/fusion/semantic_kitti/rpvnet_mk18_cr10.yaml: RPVNet, the
# three-branch fusion segmentor (range images on the fusion pipeline, the
# FusionPipeline's 64 x 2048 default); the YAML's IF_DIST is left out, as
# for SPVCNN
RPVNET_MK18_CR10 = {
    "MODALITY": "fusion",
    "DATA": {
        "DATASET": "semantickitti",
        "VOXEL_SIZE": 0.05,
        "NUM_POINTS": 1000000,
    },
    "MODEL": {
        "NAME": "RPVNet",
        "IN_FEATURE_DIM": 4,
        "NUM_CLASS": 20,
        "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock",
        "NUM_LAYER": [2, 2, 2, 2, 2, 2, 2, 2],
        "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
        "cr": 1.0,
        "DROPOUT_P": 0.0,
        "LABEL_SMOOTHING": 0.0,
        "LOSS_CONFIG": {
            "LOSS_TYPES": ["CELoss", "LovLoss"],
            "LOSS_WEIGHTS": [1.0, 1.0],
        },
        # not in the YAML: the MinkUNet recipe's capacities (the voxel
        # levels are those of the same scans at the same voxel size)
        "CAPACITY_SCHEDULE": (1.0, 0.60, 0.30, 0.12, 0.05),
        "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.70, 0.35, 0.15, 0.06),
    },
    "OPTIM": {
        "BATCH_SIZE_PER_GPU": 16,
        "NUM_EPOCHS": 36,
        "OPTIMIZER": "sgd",
        "LR_PER_SAMPLE": 0.02,
        "WEIGHT_DECAY": 0.0001,
        "MOMENTUM": 0.9,
        "NESTEROV": True,
        "GRAD_NORM_CLIP": 10.0,
        "SCHEDULER": "linear_warmup_with_cosdecay",
        "WARMUP_EPOCH": 1,
    },
}

# tools/cfgs/fusion/synthetic/rpvnet_tiny.yaml: the CLI smoke recipe of
# the fusion modality (RPVNet cr 0.125, one block per stage, 16 x 64
# range images)
RPVNET_TINY = {
    "MODALITY": "fusion",
    "DATA": {
        "DATASET": "synthetic",
        "LENGTH": 8,
        "N_RAW_POINTS": 3000,
        "VOXEL_SIZE": 0.2,
        "NUM_POINTS": 4096,
        "H": 16,
        "W": 64,
    },
    "MODEL": {
        "NAME": "RPVNet",
        "IN_FEATURE_DIM": 4,
        "NUM_CLASS": 20,
        "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock",
        "NUM_LAYER": [1, 1, 1, 1, 1, 1, 1, 1],
        "cr": 0.125,
        "DROPOUT_P": 0.0,
        # not in the YAML: MINKUNET_TINY's capacities (the same voxel size
        # and point capacity, 3000-point scans); the port raises on
        # overflow where the default schedule would drop voxels
        "CAPACITY_SCHEDULE": (1.0, 0.90, 0.55, 0.25, 0.125),
    },
    "OPTIM": {
        "BATCH_SIZE_PER_GPU": 1,
        "NUM_EPOCHS": 1,
        "OPTIMIZER": "sgd",
        "LR_PER_SAMPLE": 0.01,
        "WEIGHT_DECAY": 0.0001,
        "MOMENTUM": 0.9,
        "SCHEDULER": "linear_warmup_with_cosdecay",
        "WARMUP_EPOCH": 1,
    },
}

# tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml: Cylinder_TS on
# the 480 x 360 x 32 polar grid (MODALITY cylinder, the cylinder pipeline,
# f32); the YAML's IF_DIST is left out, as for SPVCNN.  No capacity
# schedule: JAX's default holds the synthetic 120k-point scans at 131072
# rows (chip_smoke.py prints each level's count beside its capacity)
CYLINDER_CY480_CR10 = {
    "MODALITY": "cylinder",
    "DATA": {
        "DATASET": "semantickitti",
        "GRID_SIZE": [480, 360, 32],
    },
    "MODEL": {
        "NAME": "Cylinder_TS",
        "IN_FEATURE_DIM": 9,
        "NUM_CLASS": 20,
        "IGNORE_LABEL": 0,
        "DROPOUT_P": 0.0,
        "LABEL_SMOOTHING": 0.0,
        "INIT_SIZE": 32,
        "LOSS_CONFIG": {
            "LOSS_TYPES": ["CELoss", "LovLoss"],
            "LOSS_WEIGHTS": [1.0, 1.0],
        },
    },
    "OPTIM": {
        "BATCH_SIZE_PER_GPU": 12,
        "NUM_EPOCHS": 36,
        "OPTIMIZER": "sgd",
        "LR_PER_SAMPLE": 0.02,
        "WEIGHT_DECAY": 0.0001,
        "MOMENTUM": 0.9,
        "NESTEROV": True,
        "GRAD_NORM_CLIP": 10.0,
        "SCHEDULER": "linear_warmup_with_cosdecay",
        "WARMUP_EPOCH": 1,
    },
}

# tools/cfgs/voxel/synthetic/cylinder_tiny.yaml: the CLI smoke recipe of
# Cylinder_TS (INIT_SIZE 4, a 64 x 64 x 16 polar grid; MODALITY voxel,
# the cylinder pipeline picked by the model's name, as the JAX CLI does)
CYLINDER_TINY = {
    "MODALITY": "voxel",
    "DATA": {
        "DATASET": "synthetic",
        "LENGTH": 8,
        "N_RAW_POINTS": 4000,
        "GRID_SIZE": [64, 64, 16],
        "NUM_POINTS": 4096,
    },
    "MODEL": {
        "NAME": "Cylinder_TS",
        "IN_FEATURE_DIM": 9,
        "NUM_CLASS": 20,
        "IGNORE_LABEL": 0,
        "INIT_SIZE": 4,
        "LOSS_CONFIG": {
            "LOSS_TYPES": ["CELoss", "LovLoss"],
            "LOSS_WEIGHTS": [1.0, 1.0],
        },
    },
    "OPTIM": {
        "BATCH_SIZE_PER_GPU": 1,
        "NUM_EPOCHS": 1,
        "OPTIMIZER": "sgd",
        "LR_PER_SAMPLE": 0.01,
        "WEIGHT_DECAY": 0.0001,
        "MOMENTUM": 0.9,
        "SCHEDULER": "linear_warmup_with_cosdecay",
        "WARMUP_EPOCH": 1,
    },
}

# TASeg's temporal stages on SemanticKITTI: the frame fused with up to 16
# history scans (pose-warped, per-class flexible steps over pseudo masks,
# the time flag as the 5th input feature).  Port-only deployment settings
# (not in the YAMLs): the YAMLs' NUM_POINTS of 3 000 000 (and batch 6)
# size the JAX loader; the port serves and trains one fused cloud per step
# at POINTS_PER_SCAN rows.  tools/ms_capacity.py over 24 synthetic fused
# clouds (120 000-point frames with 3 history copies, 227-228k points):
# at most 0.668 / 0.504 / 0.300 / 0.118 / 0.035 of 262 144 rows per level
# when augmented for training (the KD student's), 0.651 / 0.480 / 0.272 /
# 0.103 / 0.032 unaugmented; each schedule holds >= 32% headroom over
# those (the KD teacher's GT-mask cloud fills less and takes the train
# schedule at its own capacity)
_FSA_DATA = {
    "DATA_PATH": "/data/SemanticKITTI/dataset/sequences",
    "VOXEL_SIZE": 0.05,
    "NUM_POINTS": 3000000,
    "IN_FEATURE_DIM": 5,
    "MULTISCAN": 16,
    "ONLY_HISTORY": True,
    "PSEUDO_MASK": "mink_notta",
    "PSEUDO_LABEL_ROOT": "output/minkunet_mk34_cr10/default/trainval_notta",
    "FLEXIBLE_STEPS": [0, 0, 2, 2, 2, 2, 2, 2, 2, 0, 4, 4, 4, 0, 4, 0, 2, 4, 2, 2],
}
_FSA_MODEL = {
    "IN_FEATURE_DIM": 5,
    "NUM_CLASS": 20,
    "IGNORE_LABEL": 0,
    "BLOCK": "ResBlock",
    "NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2],
    "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96],
    "cr": 1.0,
    "DROPOUT_P": 0.0,
    "LABEL_SMOOTHING": 0.1,
    "LOSS_CONFIG": {
        "LOSS_TYPES": ["CELoss", "LovLoss"],
        "LOSS_WEIGHTS": [1.0, 1.0],
    },
    "POINTS_PER_SCAN": 262144,
    "CAPACITY_SCHEDULE": (1.0, 0.65, 0.36, 0.14, 0.045),
    "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.70, 0.40, 0.16, 0.05),
}
_FSA_OPTIM = {
    "BATCH_SIZE_PER_GPU": 6,
    "NUM_EPOCHS": 12,
    "OPTIMIZER": "sgd",
    "LR_PER_SAMPLE": 0.02,
    "WEIGHT_DECAY": 0.0001,
    "MOMENTUM": 0.9,
    "NESTEROV": True,
    "GRAD_NORM_CLIP": 10.0,
    "SCHEDULER": "linear_warmup_with_cosdecay",
    "WARMUP_EPOCH": 1,
}

# tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10_fsa.yaml: FSA, the
# mk34 MinkUNet on the fused cloud; the YAML's IF_DIST is left out, as for
# SPVCNN
MINKUNET_MK34_CR10_FSA = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "semantickitti_ms", **_FSA_DATA},
    "MODEL": {"NAME": "MinkUNetMs", **_FSA_MODEL},
    "OPTIM": dict(_FSA_OPTIM),
}

# tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10_fsa_kd.yaml: mask
# distillation, a frozen teacher on the GT-mask cloud (MODEL.TEACHER_CKPT)
# distils its tri-scale features into the student on the pseudo-mask cloud
MINKUNET_MK34_CR10_FSA_KD = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "semantickitti_ms_kd", **_FSA_DATA, "MAX_VOXEL": 3000},
    "MODEL": {
        "NAME": "MinkUNetMsKd", **_FSA_MODEL,
        "MAX_VOXEL": 3000, "FEAT_KD_WEIGHT": 10.0, "TEACHER_CKPT": None,
    },
    "OPTIM": dict(_FSA_OPTIM),
}

# tools/cfgs/voxel/semantic_kitti_ms/minkunet_mk34_cr10_smsa.yaml: SMSA,
# the 26-class multi-scan task (moving classes) with the static/moving
# switch augmentation on the fused cloud
MINKUNET_MK34_CR10_SMSA = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "semantickitti_ms_ms", **_FSA_DATA},
    "MODEL": {"NAME": "MinkUNetMs", **_FSA_MODEL, "NUM_CLASS": 26},
    "OPTIM": dict(_FSA_OPTIM),
}

_MS_TINY_OPTIM = {
    "BATCH_SIZE_PER_GPU": 1,
    "NUM_EPOCHS": 1,
    "OPTIMIZER": "sgd",
    "LR_PER_SAMPLE": 0.01,
    "WEIGHT_DECAY": 0.0001,
    "MOMENTUM": 0.9,
    "SCHEDULER": "linear_warmup_with_cosdecay",
    "WARMUP_EPOCH": 1,
}
_MS_TINY_MODEL = {
    "IN_FEATURE_DIM": 5,
    "NUM_CLASS": 20,
    "IGNORE_LABEL": 0,
    "BLOCK": "ResBlock",
    "NUM_LAYER": [1, 1, 1, 1, 1, 1, 1, 1],
    "cr": 0.125,
    "DROPOUT_P": 0.0,
    # not in the YAML: tools/ms_capacity.py (--points 2000 --voxel 0.2
    # --capacity 8192) over the 8 train and 8 eval fused clouds: at most
    # 0.44 / 0.35 / 0.19 / 0.10 / 0.045 of the 8192 rows (the train
    # augmentation included); JAX's default schedule overflows at levels 3
    # and 4, and the port raises on overflow
    "CAPACITY_SCHEDULE": (1.0, 0.60, 0.30, 0.15, 0.07),
}

# tools/cfgs/voxel/synthetic/minkunet_ms_tiny.yaml: the FSA smoke recipe
# of the CLI (the teacher stage of the KD smoke)
MINKUNET_MS_TINY = {
    "MODALITY": "voxel",
    "DATA": {
        "DATASET": "synthetic_ms",
        "LENGTH": 8,
        "N_RAW_POINTS": 2000,
        "VOXEL_SIZE": 0.2,
        "NUM_POINTS": 8192,
        "IN_FEATURE_DIM": 5,
    },
    "MODEL": {"NAME": "MinkUNetMs", **_MS_TINY_MODEL},
    "OPTIM": dict(_MS_TINY_OPTIM),
}

# tools/cfgs/voxel/synthetic/minkunet_ms_kd_tiny.yaml: the KD smoke
# recipe of the CLI (set MODEL.TEACHER_CKPT to a MinkUNetMs checkpoint)
MINKUNET_MS_KD_TINY = {
    "MODALITY": "voxel",
    "DATA": {
        "DATASET": "synthetic_ms_kd",
        "LENGTH": 8,
        "N_RAW_POINTS": 2000,
        "VOXEL_SIZE": 0.2,
        "NUM_POINTS": 8192,
        "IN_FEATURE_DIM": 5,
        "MAX_VOXEL": 256,
    },
    "MODEL": {
        "NAME": "MinkUNetMsKd", **_MS_TINY_MODEL,
        "FEAT_KD_WEIGHT": 10.0, "TEACHER_CKPT": None,
    },
    "OPTIM": dict(_MS_TINY_OPTIM),
}

# tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10_fsa_tiaf.yaml: TIAF,
# the FSA MinkUNet (`main`) beside the UNet2D image branch over the
# 48-frame camera window (every 12th frame: 5 images of 384 x 1280) and
# the FOV sparse branch (FOV_CR 0.5), fused by `classifier_fusion`; the
# YAML's IF_DIST is left out, as for FSA.  The main cloud is FSA's, so
# are its port-only capacities; the FOV cloud takes JAX's default
# schedule at half the point capacity (tools/ms_capacity.py --tiaf: at
# most 0.233 / 0.195 / 0.134 / 0.063 / 0.022 of 131 072 rows per level
# over 12 synthetic clouds, each unaugmented and augmented, >= 29% under
# the default's)
MINKUNET_MK34_CR10_FSA_TIAF = {
    "MODALITY": "voxel",
    "DATA": {
        "DATASET": "semantickitti_ms_mm", **_FSA_DATA,
        "MULTISCAN_IMAGE": 48,
        "STEP_IMAGE": 12,
        "IMAGE_ROOT": "/data/SemanticKITTI/dataset/sequences",
        "SEMANTIC_MAP_ROOT": "/data/SemanticKITTI/semantic_map_dilate",
    },
    "MODEL": {
        "NAME": "MinkUNetMsMm", **_FSA_MODEL,
        "LOSS_WEIGHT": [0, 1, 0.5, 0.5, 1],
        "ENSEMBLE_TYPE": "replace",
    },
    "OPTIM": {**_FSA_OPTIM, "BATCH_SIZE_PER_GPU": 2},
}

# tools/cfgs/voxel/synthetic/tiaf_tiny.yaml: the TIAF smoke recipe of the
# CLI (cr 0.125, FOV_CR 0.125, IMAGE_BASE 8, 2 images of 32 x 64; the
# staged recipe's freezing: only the image / FOV / fusion modules train)
TIAF_TINY = {
    "MODALITY": "voxel",
    "DATA": {
        "DATASET": "synthetic_ms_mm",
        "LENGTH": 8,
        "N_RAW_POINTS": 1500,
        "VOXEL_SIZE": 0.2,
        "NUM_POINTS": 8192,
        "FOV_NUM_POINTS": 4096,
        "IN_FEATURE_DIM": 5,
        "N_IMAGES": 2,
        "IMG_H": 32,
        "IMG_W": 64,
    },
    "MODEL": {
        "NAME": "MinkUNetMsMm",
        "IN_FEATURE_DIM": 5,
        "NUM_CLASS": 20,
        "IGNORE_LABEL": 0,
        "cr": 0.125,
        "FOV_CR": 0.125,
        "IMAGE_BASE": 8,
        "FIX_PART_PARAM": True,
        "LOSS_WEIGHT": [0, 1, 0.5, 0.5, 1],
        "ENSEMBLE_TYPE": "replace",
        # not in the YAML: the main clouds of the 8 train (augmented 3
        # times) and 8 eval scans fill at most 0.338 / 0.298 / 0.194 /
        # 0.089 / 0.040 of the 8192 rows; JAX's default schedule leaves
        # level 3 5% of headroom (768 rows), and the port raises on
        # overflow.  The FOV clouds fill at most 674 / 617 / 415 / 209 /
        # 102 rows, inside the default's at 4096
        "CAPACITY_SCHEDULE": (1.0, 0.60, 0.30, 0.15, 0.07),
    },
    "OPTIM": dict(_MS_TINY_OPTIM),
}

# the SGD recipe every KITTI and synthetic MinkUNet-family YAML below
# shares (the reference's warmup-cosine schedule)
_SGD = {
    "NUM_EPOCHS": 36,
    "OPTIMIZER": "sgd",
    "LR_PER_SAMPLE": 0.02,
    "WEIGHT_DECAY": 0.0001,
    "MOMENTUM": 0.9,
    "NESTEROV": True,
    "GRAD_NORM_CLIP": 10.0,
    "SCHEDULER": "linear_warmup_with_cosdecay",
    "WARMUP_EPOCH": 1,
}
_KITTI_DATA = {
    "DATASET": "semantickitti",
    "DATA_PATH": "/data/SemanticKITTI/dataset/sequences",
    "VOXEL_SIZE": 0.05,
    "NUM_POINTS": 1000000,
}
_CE_LOVASZ = {"LOSS_TYPES": ["CELoss", "LovLoss"], "LOSS_WEIGHTS": [1.0, 1.0]}
_PLANES = [32, 32, 64, 128, 256, 256, 128, 96, 96]
# not in the YAMLs: the flagship's capacities (the same scans at the same
# voxel size; cr and depth change no voxel set)
_KITTI_CAPS = {
    "CAPACITY_SCHEDULE": (1.0, 0.60, 0.30, 0.12, 0.05),
    "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.70, 0.35, 0.15, 0.06),
}


def _mink18(name: str, cr: float, **model) -> dict:
    """A KITTI MinkUNet-family recipe at mk18 depth (two blocks a stage)."""
    return {
        "MODALITY": "fusion" if name == "SPVCNN" else "voxel",
        "DATA": dict(_KITTI_DATA),
        "MODEL": {
            "NAME": name, "IN_FEATURE_DIM": 4, "NUM_CLASS": 20, "IGNORE_LABEL": 0,
            "BLOCK": "ResBlock", "NUM_LAYER": [2] * 8, "PLANES": list(_PLANES), "cr": cr,
            "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.1, "IF_DIST": True,
            "LOSS_CONFIG": _CE_LOVASZ, **_KITTI_CAPS, **model,
        },
        "OPTIM": {**_SGD, "BATCH_SIZE_PER_GPU": 16},
    }


# tools/cfgs/voxel/semantic_kitti/minkunet_mk18_cr10.yaml and _cr5.yaml:
# MinkUNet at mk18 depth, full and half width (cr5 at one scan per card)
MINKUNET_MK18_CR10 = _mink18("MinkUNet", 1.0)
MINKUNET_MK18_CR5 = {
    **_mink18("MinkUNet", 0.5), "OPTIM": {**_SGD, "BATCH_SIZE_PER_GPU": 1},
}
# tools/cfgs/fusion/semantic_kitti/spvcnn_mk18_cr10.yaml and _cr5.yaml
SPVCNN_MK18_CR10 = _mink18("SPVCNN", 1.0)
SPVCNN_MK18_CR5 = _mink18("SPVCNN", 0.5)

# tools/cfgs/fusion/semantic_kitti/rpvnet_mk34_cr17_5.yaml: RPVNet at
# mk34 depth and cr 1.75 (widths 56 ... 448, all multiples of 8), five
# input features
RPVNET_MK34_CR17_5 = {
    "MODALITY": "fusion",
    "DATA": dict(_KITTI_DATA),
    "MODEL": {
        "NAME": "RPVNet", "IN_FEATURE_DIM": 5, "NUM_CLASS": 20, "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock", "NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2], "PLANES": list(_PLANES),
        "cr": 1.75, "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.0, "IF_DIST": True,
        "LOSS_CONFIG": _CE_LOVASZ, **_KITTI_CAPS,
    },
    "OPTIM": {**_SGD, "BATCH_SIZE_PER_GPU": 4},
}

# tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr5.yaml: Cylinder_TS at
# half width (INIT_SIZE 16) on the 480 x 360 x 32 polar grid; its
# capacities are the grid's, as cy480_cr10's
CYLINDER_CY480_CR5 = {
    "MODALITY": "cylinder",
    "DATA": {
        "DATASET": "semantickitti",
        "DATA_PATH": "/data/SemanticKITTI/dataset/sequences",
        "GRID_SIZE": [480, 360, 32],
    },
    "MODEL": {
        "NAME": "Cylinder_TS", "IN_FEATURE_DIM": 9, "NUM_CLASS": 20, "IGNORE_LABEL": 0,
        "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.0, "IF_DIST": True, "INIT_SIZE": 16,
        "LOSS_CONFIG": _CE_LOVASZ,
    },
    "OPTIM": {**_SGD, "BATCH_SIZE_PER_GPU": 16},
}

# tools/cfgs/voxel/synthetic/minkunet_demo_cr5.yaml: the learning check
# (MinkUNet mk18 cr 0.5 on 32 synthetic scenes of 60 000 points at voxel
# 0.1, 8 epochs, BN momentum 0.005)
MINKUNET_DEMO_CR5 = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "synthetic", "LENGTH": 32, "N_RAW_POINTS": 60000, "VOXEL_SIZE": 0.1,
             "NUM_POINTS": 65536},
    "MODEL": {
        "NAME": "MinkUNet", "IN_FEATURE_DIM": 4, "NUM_CLASS": 20, "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock", "NUM_LAYER": [2] * 8, "PLANES": list(_PLANES), "cr": 0.5,
        "DROPOUT_P": 0.0, "BN_MOMENTUM": 0.005, "LABEL_SMOOTHING": 0.1, "IF_DIST": True,
        "LOSS_CONFIG": _CE_LOVASZ,
        # not in the YAML: the 32 train scans over 2 augmented epochs and
        # the 32 val scans fill at most 0.689 / 0.456 / 0.196 / 0.083 /
        # 0.030 of the 65 536 rows; levels 2-4 sit 8-15% under JAX's
        # default schedule, which 8 epochs of augmentations may pass, and
        # the port raises on overflow: >= 27% headroom here
        "CAPACITY_SCHEDULE": (1.0, 0.60, 0.25, 0.11, 0.045),
    },
    "OPTIM": {**_SGD, "BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 8},
}

# tools/cfgs/voxel/synthetic/minkunet_synthetic.yaml: the flagship mk34
# cr 1.0 on 16 synthetic 120 000-point scans at voxel 0.05, 2 epochs
MINKUNET_SYNTHETIC = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "synthetic", "LENGTH": 16, "N_RAW_POINTS": 120000, "VOXEL_SIZE": 0.05,
             "NUM_POINTS": 120000},
    "MODEL": {
        "NAME": "MinkUNet", "IN_FEATURE_DIM": 4, "NUM_CLASS": 20, "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock", "NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2], "PLANES": list(_PLANES),
        "cr": 1.0, "DROPOUT_P": 0.3, "IF_DIST": True, "LOSS_CONFIG": _CE_LOVASZ,
        # not in the YAML: the flagship's schedules (the same scans at the
        # same voxel size; its measured worst levels, in rows, stay >= 13%
        # under these fractions of 120 000 rows)
        **_KITTI_CAPS,
    },
    "OPTIM": {
        **{k: v for k, v in _SGD.items() if k != "NESTEROV"},
        "BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 2,
    },
}

# tools/cfgs/range/semantic_kitti/{salsanext_res34, fidnet_res34,
# rangenet_darknet53}.yaml: the range view's recipes, 64 x 512 images,
# adamW on the onecycle schedule (LR = LR_PER_SAMPLE x global batch;
# LEARNING_RATE and WARMUP_EPOCH are unread, as in JAX), batch 30 per
# card; the mixes' IF_RANGE_* are truthy flags (each taken with
# probability 0.5)
_RANGE_KITTI_DATA = {
    "DATASET": "semantickitti", "DATA_PATH": "/data/SemanticKITTI/dataset/sequences",
    "H": 64, "W": 512, "IF_RANGE_MIX": 0.9, "IF_RANGE_SHIFT": 0.9, "IF_RANGE_PASTE": 0.9,
    "IF_RANGE_UNION": 0.0,
}
_RANGE_LOSS = {"TOP_K_PERCENT": 1.0, "LS_WEIGHT": 3.0, "BD_WEIGHT": 1.0}
_ADAMW_ONECYCLE = {
    "BATCH_SIZE_PER_GPU": 30, "NUM_EPOCHS": 50, "WARMUP_EPOCH": 10, "GRAD_NORM_CLIP": 10.0,
    "OPTIMIZER": "adamW", "WEIGHT_DECAY": 0.01, "LR_PER_SAMPLE": 0.0025,
    "LEARNING_RATE": 0.0025, "SCHEDULER": "onecycle",
}


def _range_kitti(name: str, **model) -> dict:
    return {
        "MODALITY": "range",
        "DATA": dict(_RANGE_KITTI_DATA),
        "MODEL": {
            "NAME": name, "IN_FEATURE_DIM": 6, "NUM_CLASS": 20, "IGNORE_LABEL": 0,
            **model, "LOSS_CONFIG": dict(_RANGE_LOSS),
        },
        "OPTIM": dict(_ADAMW_ONECYCLE),
    }


SALSANEXT_RES34 = _range_kitti("SalsaNext")
FIDNET_RES34 = _range_kitti("FIDNet")
RANGENET_DARKNET53 = _range_kitti("RangeNet", IF_AUX=False)
# tools/cfgs/range/nuscenes/cenet_res34.yaml: CENet with its aux heads on
# nuScenes' 32 x 1920 images, read by the nuScenes reader; the range
# pipeline projects with KITTI's field of view (+3, -25 degrees) for every
# dataset, as JAX builds it, where nuScenes' 32-beam lidar spans about +10
# to -30 (ROADMAP, "Open against the JAX package")
CENET_RES34 = {
    "MODALITY": "range",
    "DATA": {
        "DATASET": "nuscenes", "DATA_PATH": "/data/nuscenes", "H": 32, "W": 1920,
        "IF_RANGE_MIX": 0.9, "IF_RANGE_SHIFT": 0.9, "IF_RANGE_PASTE": 0.9, "IF_RANGE_UNION": 0.0,
    },
    "MODEL": {
        "NAME": "CENet", "IN_FEATURE_DIM": 6, "NUM_CLASS": 17, "IGNORE_LABEL": 0, "IF_AUX": True,
        "LOSS_CONFIG": dict(_RANGE_LOSS),
    },
    "OPTIM": {**_ADAMW_ONECYCLE, "BATCH_SIZE_PER_GPU": 1},
}
# tools/cfgs/range/synthetic/salsanext_tiny.yaml: the range view's CLI
# smoke recipe (SalsaNext at full width on 16 x 128 images of 8 synthetic
# 4000-point scans, sgd on the warmup-cosine schedule)
SALSANEXT_TINY = {
    "MODALITY": "range",
    "DATA": {"DATASET": "synthetic", "LENGTH": 8, "N_RAW_POINTS": 4000, "H": 16, "W": 128},
    "MODEL": {
        "NAME": "SalsaNext", "IN_FEATURE_DIM": 6, "NUM_CLASS": 20, "IGNORE_LABEL": 0,
        "IF_DIST": True, "LOSS_CONFIG": dict(_RANGE_LOSS),
    },
    "OPTIM": {
        "BATCH_SIZE_PER_GPU": 1, "NUM_EPOCHS": 1, "OPTIMIZER": "sgd", "LR_PER_SAMPLE": 0.01,
        "WEIGHT_DECAY": 0.0001, "MOMENTUM": 0.9, "SCHEDULER": "linear_warmup_with_cosdecay",
        "WARMUP_EPOCH": 1,
    },
}

# nuScenes lidarseg and Waymo: the YAMLs' NUM_POINTS of 1 000 000 (and
# batches of 12 / 2 / 1 / 4) size the JAX loader; the port serves and
# trains one scan per step at POINTS_PER_SCAN rows.  The port-only
# capacities hold >= 30% headroom over `tools/nus_waymo_capacity.py` (the
# largest level counts over the sensor-sized synthetic trees of
# `tests/torch_nuscenes_fixture.make_card_trees`, every scan unaugmented
# and 2 times augmented): a nuScenes keyframe of 34 000 points (24-27k
# voxels at 0.1 m), its fused TLAD cloud of ~645 000 points over 18
# sweeps (83k voxels, 116k augmented: the sweeps sample one static
# street, so a real street with more new surface per meter fills more),
# a Waymo frame of 170 000 returns (110k voxels at 0.05 m, 125k
# augmented).  The port raises on overflow where JAX drops voxels
#
# the largest level counts as fractions of the point capacity, serving
# (unaugmented) / train (augmented), and what each recipe takes:
#   nuScenes keyframe, 65 536 rows: 0.360 0.225 0.107 0.043 0.014 /
#     0.410 0.253 0.123 0.051 0.017
#   nuScenes TLAD (FSA), 262 144 rows: 0.315 0.124 0.040 0.013 0.0038 /
#     0.441 0.165 0.050 0.016 0.0048
#   nuScenes TIAF: the FOV cloud fills ~93% of the main one (six cameras
#     all round) and takes half the point capacity (JAX's default), so
#     the point capacity is 327 680 rows: main 0.252 0.099 0.032 0.010
#     0.0030 / 0.353 0.132 0.040 0.013 0.0038; FOV, at JAX's default
#     schedule of 163 840 rows, 0.468 0.184 0.059 0.019 0.0058 / 0.661
#     0.244 0.075 0.024 0.0072
#   Waymo frame, 262 144 rows: 0.419 0.301 0.185 0.077 0.026 / 0.475
#     0.347 0.189 0.083 0.029
#   Waymo on the polar grid, 131 072 rows: 0.447 0.218 0.076 0.029
#     0.011 / 0.446 0.206 0.073 0.029 0.011
NUS_CAPS = {
    "POINTS_PER_SCAN": 65536,
    "CAPACITY_SCHEDULE": (1.0, 0.30, 0.14, 0.06, 0.02),
    "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.35, 0.17, 0.07, 0.025),
}
NUS_TLAD_CAPS = {
    "POINTS_PER_SCAN": 262144,
    "CAPACITY_SCHEDULE": (1.0, 0.17, 0.055, 0.017, 0.005),
    "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.22, 0.07, 0.022, 0.0065),
}
NUS_TIAF_CAPS = {
    "POINTS_PER_SCAN": 327680,
    "CAPACITY_SCHEDULE": (1.0, 0.13, 0.042, 0.014, 0.004),
    "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.175, 0.053, 0.017, 0.005),
}
WAYMO_CAPS = {
    "POINTS_PER_SCAN": 262144,
    "CAPACITY_SCHEDULE": (1.0, 0.40, 0.25, 0.105, 0.035),
    "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.46, 0.25, 0.11, 0.04),
}
WAYMO_CYL_CAPS = {
    "CAPACITY_SCHEDULE": (1.0, 0.30, 0.10, 0.04, 0.015),
    "TRAIN_CAPACITY_SCHEDULE": (1.0, 0.30, 0.10, 0.04, 0.015),
}
_NUS_DATA = {"DATA_PATH": "/data/nuscenes", "VOXEL_SIZE": 0.1, "NUM_POINTS": 1000000}
_NUS_TLAD = {
    "MULTISCAN": 15, "STEP": 1.0, "PSEUDO_MASK": "mink_sweep_notta",
    "FLEXIBLE_STEPS": [0, 1, 1, 1, 3, 1, 1, 3, 1, 3, 3, 0, 1, 1, 1, 1, 1],
}
_MK34 = {"NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2], "PLANES": list(_PLANES), "cr": 1.0}
_NUS_MODEL = {
    "IN_FEATURE_DIM": 4, "NUM_CLASS": 17, "IGNORE_LABEL": 0, "BLOCK": "ResBlock", **_MK34,
    "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.1, "IF_DIST": True, "LOSS_CONFIG": _CE_LOVASZ,
}
_NUS_SGD = {**_SGD, "LR_PER_SAMPLE": 0.005, "BATCH_SIZE_PER_GPU": 12}

# tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10.yaml: the single-sweep
# MinkUNet on nuScenes lidarseg (17 classes, voxel 0.1 m)
MINKUNET_MK34_CR10_NUS = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "nuscenes", **_NUS_DATA},
    "MODEL": {"NAME": "MinkUNet", **_NUS_MODEL, **NUS_CAPS},
    "OPTIM": {**_NUS_SGD, "NUM_EPOCHS": 48},
}
# tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa.yaml: TLAD, the
# distance-based sweep selection (one sweep a meter, 15 rings) with the
# per-class flexible steps; the model reads 4 of the 5 columns (the time
# lag is sliced off, as in JAX)
MINKUNET_MK34_CR10_FSA_NUS = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "nuscenes_ms", **_NUS_DATA, **_NUS_TLAD},
    "MODEL": {"NAME": "MinkUNetMs", **_NUS_MODEL, **NUS_TLAD_CAPS},
    "OPTIM": dict(_NUS_SGD),
}
# tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa_tiaf.yaml: TIAF over
# the six cameras of the keyframe (MULTISCAN_IMAGE 0), 448 x 800 images,
# in f32; the main cloud is TLAD's, the FOV cloud (every fused point in
# a camera's frustum) takes half the point capacity
MINKUNET_MK34_CR10_FSA_TIAF_NUS = {
    "MODALITY": "voxel",
    "DATA": {"DATASET": "nuscenes_ms_mm", **_NUS_DATA, **_NUS_TLAD, "MULTISCAN_IMAGE": 0,
             "STEP_IMAGE": 7},
    "MODEL": {
        "NAME": "MinkUNetMsMmNus", **_NUS_MODEL, "LOSS_WEIGHT": [0, 1, 0.5, 0.5, 1],
        "ENSEMBLE_TYPE": "replace", **NUS_TIAF_CAPS,
    },
    "OPTIM": {**_NUS_SGD, "BATCH_SIZE_PER_GPU": 2},
}

_WAYMO_DATA = {"DATASET": "waymo", "DATA_PATH": "/data/waymo_preprocessed", "VOXEL_SIZE": 0.05,
               "NUM_POINTS": 1000000}


def _waymo(name: str, num_layer: list, batch: int = 1, epochs: int = 12, smoothing: float = 0.1,
           **model) -> dict:
    """A Waymo MinkUNet-family recipe (23 classes; of its IN_FEATURE_DIM
    5 the loader keeps 4 columns, as JAX's, so the stem is 4 wide:
    `models.stem_width`), with `model`'s MODEL keys on top."""
    return {
        "MODALITY": "voxel" if name == "MinkUNet" else "fusion",
        "DATA": dict(_WAYMO_DATA),
        "MODEL": {
            "NAME": name, "IN_FEATURE_DIM": 5, "NUM_CLASS": 23, "IGNORE_LABEL": 0,
            "BLOCK": "ResBlock", "NUM_LAYER": list(num_layer), "PLANES": list(_PLANES), "cr": 1.0,
            "DROPOUT_P": 0.0, "LABEL_SMOOTHING": smoothing, "IF_DIST": True,
            "LOSS_CONFIG": _CE_LOVASZ, **WAYMO_CAPS, **model,
        },
        "OPTIM": {**_SGD, "BATCH_SIZE_PER_GPU": batch, "NUM_EPOCHS": epochs},
    }


# tools/cfgs/voxel/waymo/minkunet_mk34_cr10.yaml and _mk18_cr10.yaml
MINKUNET_MK34_CR10_WAYMO = _waymo("MinkUNet", _MK34["NUM_LAYER"])
MINKUNET_MK18_CR10_WAYMO = _waymo("MinkUNet", [2] * 8)
# tools/cfgs/fusion/waymo/spvcnn_mk18_cr10.yaml and rpvnet_mk18_cr10.yaml
# (RPVNet's range images: the FusionPipeline's 64 x 2048 default)
SPVCNN_MK18_CR10_WAYMO = _waymo("SPVCNN", [2] * 8)
RPVNET_MK18_CR10_WAYMO = _waymo("RPVNet", [2] * 8, batch=4, epochs=36, smoothing=0.0)
# tools/cfgs/voxel/waymo/cylinder_cy480_cr10.yaml: Cylinder_TS on the
# 480 x 360 x 32 polar grid; the YAML's IN_FEATURE_DIM 10 builds the
# 9-wide pre-net of the pipeline's 9 columns, as JAX's parameters come out
CYLINDER_CY480_CR10_WAYMO = {
    "MODALITY": "cylinder",
    "DATA": {"DATASET": "waymo", "DATA_PATH": "/data/waymo_preprocessed", "GRID_SIZE": [480, 360, 32]},
    "MODEL": {
        "NAME": "Cylinder_TS", "IN_FEATURE_DIM": 10, "NUM_CLASS": 23, "IGNORE_LABEL": 0,
        "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.0, "IF_DIST": True, "INIT_SIZE": 32,
        "LOSS_CONFIG": _CE_LOVASZ, **WAYMO_CYL_CAPS,
    },
    "OPTIM": {**_SGD, "BATCH_SIZE_PER_GPU": 1},
}

# the mk34 backbone at cr 1.6: widths int(1.6 x PLANES) = 51, 51, 102,
# 204, 409, 409, 204, 153, 153 and the decoder's concatenations 613 and
# 306, none a multiple of 8, so every conv of these recipes takes its
# tensor-core route at widths the wrappers pad to whole 16-byte pieces
# (`ops.sparse_conv.padded_width`).  Capacities as the same backbone's at
# cr 1.0: the voxel levels depend on the scans and the voxel size, not on
# the widths.
_MK34_CR16 = {**_MK34, "cr": 1.6}


def _kitti_mk34_cr16(name: str) -> dict:
    """A KITTI MinkUNet-family recipe at mk34 depth and cr 1.6."""
    return {
        "MODALITY": "fusion" if name == "SPVCNN" else "voxel",
        "DATA": dict(_KITTI_DATA),
        "MODEL": {
            "NAME": name, "IN_FEATURE_DIM": 4, "NUM_CLASS": 20, "IGNORE_LABEL": 0,
            "BLOCK": "ResBlock", **_MK34_CR16, "DROPOUT_P": 0.0, "LABEL_SMOOTHING": 0.0,
            "IF_DIST": True, "LOSS_CONFIG": _CE_LOVASZ, **_KITTI_CAPS,
        },
        "OPTIM": {**_SGD, "BATCH_SIZE_PER_GPU": 12},
    }


# tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr16.yaml and
# tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr16.yaml
MINKUNET_MK34_CR16 = _kitti_mk34_cr16("MinkUNet")
SPVCNN_MK34_CR16 = _kitti_mk34_cr16("SPVCNN")
# tools/cfgs/voxel/waymo/minkunet_mk34_cr16.yaml and _cr16_xyz.yaml (the
# latter's IN_FEATURE_DIM 3 builds a 3-wide stem: xyz only), and
# tools/cfgs/fusion/waymo/spvcnn_mk34_cr16.yaml
MINKUNET_MK34_CR16_WAYMO = _waymo("MinkUNet", _MK34["NUM_LAYER"], cr=1.6)
MINKUNET_MK34_CR16_XYZ_WAYMO = _waymo("MinkUNet", _MK34["NUM_LAYER"], cr=1.6, IN_FEATURE_DIM=3)
SPVCNN_MK34_CR16_WAYMO = _waymo("SPVCNN", _MK34["NUM_LAYER"], batch=12, epochs=36, smoothing=0.0, cr=1.6)

# the recipes `utils.config.load_config` serves, by YAML path
RECIPES = {
    "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml": MINKUNET_MK34_CR10,
    "tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr10.yaml": SPVCNN_MK34_CR10,
    "tools/cfgs/voxel/synthetic/minkunet_tiny.yaml": MINKUNET_TINY,
    "tools/cfgs/fusion/semantic_kitti/rpvnet_mk18_cr10.yaml": RPVNET_MK18_CR10,
    "tools/cfgs/fusion/synthetic/rpvnet_tiny.yaml": RPVNET_TINY,
    "tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml": CYLINDER_CY480_CR10,
    "tools/cfgs/voxel/synthetic/cylinder_tiny.yaml": CYLINDER_TINY,
    "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10_fsa.yaml": MINKUNET_MK34_CR10_FSA,
    "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10_fsa_kd.yaml": MINKUNET_MK34_CR10_FSA_KD,
    "tools/cfgs/voxel/semantic_kitti_ms/minkunet_mk34_cr10_smsa.yaml": MINKUNET_MK34_CR10_SMSA,
    "tools/cfgs/voxel/synthetic/minkunet_ms_tiny.yaml": MINKUNET_MS_TINY,
    "tools/cfgs/voxel/synthetic/minkunet_ms_kd_tiny.yaml": MINKUNET_MS_KD_TINY,
    "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10_fsa_tiaf.yaml": MINKUNET_MK34_CR10_FSA_TIAF,
    "tools/cfgs/voxel/synthetic/tiaf_tiny.yaml": TIAF_TINY,
    "tools/cfgs/voxel/semantic_kitti/minkunet_mk18_cr10.yaml": MINKUNET_MK18_CR10,
    "tools/cfgs/voxel/semantic_kitti/minkunet_mk18_cr5.yaml": MINKUNET_MK18_CR5,
    "tools/cfgs/voxel/synthetic/minkunet_demo_cr5.yaml": MINKUNET_DEMO_CR5,
    "tools/cfgs/voxel/synthetic/minkunet_synthetic.yaml": MINKUNET_SYNTHETIC,
    "tools/cfgs/fusion/semantic_kitti/spvcnn_mk18_cr10.yaml": SPVCNN_MK18_CR10,
    "tools/cfgs/fusion/semantic_kitti/spvcnn_mk18_cr5.yaml": SPVCNN_MK18_CR5,
    "tools/cfgs/fusion/semantic_kitti/rpvnet_mk34_cr17_5.yaml": RPVNET_MK34_CR17_5,
    "tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr5.yaml": CYLINDER_CY480_CR5,
    "tools/cfgs/range/semantic_kitti/salsanext_res34.yaml": SALSANEXT_RES34,
    "tools/cfgs/range/semantic_kitti/fidnet_res34.yaml": FIDNET_RES34,
    "tools/cfgs/range/semantic_kitti/rangenet_darknet53.yaml": RANGENET_DARKNET53,
    "tools/cfgs/range/nuscenes/cenet_res34.yaml": CENET_RES34,
    "tools/cfgs/range/synthetic/salsanext_tiny.yaml": SALSANEXT_TINY,
    "tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10.yaml": MINKUNET_MK34_CR10_NUS,
    "tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa.yaml": MINKUNET_MK34_CR10_FSA_NUS,
    "tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa_tiaf.yaml": MINKUNET_MK34_CR10_FSA_TIAF_NUS,
    "tools/cfgs/voxel/waymo/minkunet_mk34_cr10.yaml": MINKUNET_MK34_CR10_WAYMO,
    "tools/cfgs/voxel/waymo/minkunet_mk18_cr10.yaml": MINKUNET_MK18_CR10_WAYMO,
    "tools/cfgs/voxel/waymo/cylinder_cy480_cr10.yaml": CYLINDER_CY480_CR10_WAYMO,
    "tools/cfgs/fusion/waymo/spvcnn_mk18_cr10.yaml": SPVCNN_MK18_CR10_WAYMO,
    "tools/cfgs/fusion/waymo/rpvnet_mk18_cr10.yaml": RPVNET_MK18_CR10_WAYMO,
    "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr16.yaml": MINKUNET_MK34_CR16,
    "tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr16.yaml": SPVCNN_MK34_CR16,
    "tools/cfgs/voxel/waymo/minkunet_mk34_cr16.yaml": MINKUNET_MK34_CR16_WAYMO,
    "tools/cfgs/voxel/waymo/minkunet_mk34_cr16_xyz.yaml": MINKUNET_MK34_CR16_XYZ_WAYMO,
    "tools/cfgs/fusion/waymo/spvcnn_mk34_cr16.yaml": SPVCNN_MK34_CR16_WAYMO,
}
