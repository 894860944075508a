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

# the recipes `utils.config.load_config` serves, by YAML path
RECIPES = {
    "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml": MINKUNET_MK34_CR10,
    "tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr10.yaml": SPVCNN_MK34_CR10,
    "tools/cfgs/voxel/synthetic/minkunet_tiny.yaml": MINKUNET_TINY,
    "tools/cfgs/fusion/semantic_kitti/rpvnet_mk18_cr10.yaml": RPVNET_MK18_CR10,
    "tools/cfgs/fusion/synthetic/rpvnet_tiny.yaml": RPVNET_TINY,
    "tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml": CYLINDER_CY480_CR10,
    "tools/cfgs/voxel/synthetic/cylinder_tiny.yaml": CYLINDER_TINY,
}
