"""SPVCNN at cr 1.6 in the port against the JAX package: a narrow cr 1.6
SPVCNN (`torch_cr16_narrow`) on the same numpy scans and parameters as
JAX's, its f32 eval logits and one f32 train step against
`make_train_step`, with `test_torch_cr16.py`'s helpers and tolerances
(measured values there).  Its point branch re-voxelizes 51-, 102- and
38-wide point features (K6's and K8's widths on the card).  A file of
its own so that the runners take it apart from the MinkUNet's: ~60 s
on one worker, ~47 s of it JAX tracing and compiling the step.
"""

from test_torch_cr16 import _logits_against_jax, _step_against_jax


def test_cr16_spvcnn_logits_match_jax():
    _logits_against_jax("SPVCNN")


def test_cr16_spvcnn_train_step_matches_jax():
    _step_against_jax("SPVCNN")
