"""Shared inputs of the RPVNet tests (`test_torch_rpvnet*.py`): the small
configuration, two synthetic scans through the fusion pipeline of both
packages, the JAX model and its inputs (jitted: an eager RPVNet forward
takes minutes on the CPU).

Small size: cr 0.125, one block per stage, 20 classes, Dropout 0; two
~900-point scans in a 2048-row shard with 16 x 64 range images (scales
16 x 64, 4 x 16 and 1 x 4).
"""

import jax
import jax.numpy as jnp
import numpy as np

from taseg_tpu.data.fusion_dataset import FusionPipeline as JFusionPipeline
from taseg_tpu.data.fusion_dataset import collate_fusion_batch
from taseg_tpu.models import UNetCapacities as JCaps
from taseg_tpu.models.fusion.rpvnet import RPVNet as JRPVNet
from taseg_tpu.parallel import Batch
from taseg_tpu.parallel.fusion_step import FusionBatch, _unpack
from taseg_tpu_torch.data.synthetic import synthetic_scan
from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

CAP = 2048
H, W = 16, 64
SCHEDULE = (1.0,) * 5
CFG = {
    "MODALITY": "fusion",
    "DATA": {"VOXEL_SIZE": 0.05, "H": H, "W": W},
    "MODEL": {
        "NAME": "RPVNet", "NUM_CLASS": 20, "IN_FEATURE_DIM": 4, "IGNORE_LABEL": 0,
        "BLOCK": "ResBlock", "cr": 0.125, "NUM_LAYER": [1] * 8,
        "PLANES": [32, 32, 64, 128, 256, 256, 128, 96, 96], "DROPOUT_P": 0.0,
        "LABEL_SMOOTHING": 0.0, "CAPACITY_SCHEDULE": SCHEDULE,
        "LOSS_CONFIG": {"LOSS_TYPES": ["CELoss", "LovLoss"], "LOSS_WEIGHTS": [1.0, 1.0]},
    },
    "OPTIM": {
        "OPTIMIZER": "sgd", "LR_PER_SAMPLE": 0.02, "WEIGHT_DECAY": 1e-4,
        "MOMENTUM": 0.9, "NESTEROV": True, "GRAD_NORM_CLIP": 10.0,
        "SCHEDULER": "linear_warmup_with_cosdecay", "WARMUP_EPOCH": 1,
    },
}


def jax_model(dtype="float32", multi_scale="concat"):
    m = CFG["MODEL"]
    return JRPVNet(
        num_classes=m["NUM_CLASS"], cr=m["cr"], num_layer=tuple(m["NUM_LAYER"]),
        block="ResBlock", dropout_p=0.0, compute_dtype=dtype, multi_scale=multi_scale,
    )


def scans(seed=21, n=2, points=900):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        pts, labels = synthetic_scan(rng, points)
        ring = rng.uniform(0, 1, (len(pts), 1)).astype(np.float32)
        out.append({"xyzret": np.concatenate([pts, ring], 1), "labels": labels})
    return out


def jax_arrays(samples_in, training=False, seed=0):
    """JAX's pipeline and collate of one shard (leading shard axis of 1)."""
    pipe = JFusionPipeline(CFG["DATA"]["VOXEL_SIZE"], training=training, h=H, w=W, seed=seed)
    return collate_fusion_batch([[pipe(s) for s in samples_in]], CAP)


def fusion_batch(arrays) -> FusionBatch:
    return FusionBatch(
        points=Batch(
            point_coords=jnp.asarray(arrays["point_coords"]),
            point_feats=jnp.asarray(arrays["point_feats"]),
            labels=jnp.asarray(arrays["labels"]),
            num_points=jnp.asarray(np.asarray(arrays["num_points"]).reshape(1, 1)),
        ),
        range_image=jnp.asarray(arrays["range_image"]),
        range_pxpy=jnp.asarray(arrays["range_pxpy"]),
    )


def jax_inputs(arrays):
    """(points, topo, rpv, canvas) as JAX's fusion step unpacks them."""
    caps = JCaps.for_points(CAP, schedule=SCHEDULE)
    return jax.jit(lambda fb: _unpack(fb, caps))(fusion_batch(arrays))


def randomize_bn(tree, rng, kind, parent=""):
    """BN affine terms, Dense biases (not the head's) and running
    statistics drawn at random, so that the logits are O(1): the voxel
    branch's as the SPVCNN tests draw them, the range branch's (flax
    `BatchNorm`, some 30 in a row) with variances near 1."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize_bn(v, rng, kind, k)
            continue
        v = np.array(v, np.float32)
        if kind == "stats":
            lo, hi = (0.5, 1.5) if parent.startswith("BatchNorm") else (0.05, 0.15)
            v = rng.uniform(lo, hi, v.shape) if k == "var" else rng.normal(0, 0.05, v.shape)
        elif k == "scale":
            v = rng.uniform(0.8, 1.2, v.shape)
        elif k == "bias" and v.shape[0] != 20:
            v = rng.normal(0, 0.1, v.shape)
        out[k] = v.astype(np.float32)
    return out


def with_conv_biases(params, seed, std=0.05):
    """`params` with every range conv bias (`.../Conv_0/bias`) drawn from
    N(0, std).  With the init's zero biases the convs over the range
    images' empty pixels are exactly 0, where leaky_relu's derivative
    jumps from 1 to 0.01, and XLA's and torch's f32 step-0 gradients
    differed by 1.1e-3 in norm (6.8e-5 with these biases)."""
    rng = np.random.default_rng(seed)

    def walk(tree, parent=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
            elif k == "bias" and parent == "Conv_0":
                out[k] = rng.normal(0.0, std, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(params)


def variables(cfg=CFG, seed=3):
    params, stats = init_params_numpy(cfg, seed=seed)
    r = np.random.default_rng(5)
    return {
        "params": randomize_bn(params, r, "params"),
        "batch_stats": randomize_bn(stats, r, "stats"),
    }


def jax_point_logits(arrays, inputs, variables_, dtype="float32", multi_scale="concat"):
    """Per-raw-point logits of each scan from JAX's eval forward."""
    model = jax_model(dtype, multi_scale)
    pts, topo, rpv, canvas = inputs
    logits = np.asarray(
        jax.jit(lambda v, p, t, r, c: model.apply(v, p, t, r, c, False))(
            variables_, pts, topo, rpv, canvas
        )
    )
    meta = arrays[1][0]
    off = meta["offsets"]
    return [logits[off[b]: off[b + 1]][s.inverse_map] for b, s in enumerate(meta["samples"])]
