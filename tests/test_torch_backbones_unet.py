"""The port's SparseResUNet42 against the JAX package, on the CPU, with
`test_torch_backbones.py`'s input and helpers: width_multiplier 0.25 on
~500 voxels of two batches, the same weights in both.  Every one of the
nine stage outputs in eval mode within 1e-5 of the largest (f32), and
the gradient of a weighted sum of them in every parameter, in eval mode
(the train form of the topology), within 1e-4 of its largest.  In train
mode the gradient is ill-conditioned at this size (a few voxels hold
the coarse levels' batch statistics: JAX's own gradient moves by up to
1.8e-2 of its largest when the input moves by 1e-7 relative), so the
train-mode backward is held on SparseResNet21D.  A module of its own so
that the runners take it apart from the ResNet's: about 80 s alone
(`--durations`), ~70 s of it JAX compiling the gradient; 123 s in the
6-worker tier-1 run.
"""

import pytest

from test_torch_backbones import (  # noqa: F401  (a fixture)
    _one_torch_thread,
    check_backward,
    check_eval,
    jax_run,
    resnet_input,
)


@pytest.fixture(scope="module")
def unet_run(resnet_input):
    return jax_run("unet", *resnet_input, train_grads=False)


def test_resunet42_eval_matches_jax(resnet_input, unet_run):
    check_eval("unet", resnet_input, unet_run)


def test_resunet42_backward_matches_jax(resnet_input, unet_run):
    check_backward("unet", resnet_input, unet_run, train=False)
