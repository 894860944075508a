"""TIAF's harness in the port: `load_pretrained` of an FSA MinkUNetMs
checkpoint into the TIAF model's `main/` (matched by suffix, parameters
and BN statistics), equal to JAX's `load_matching_params` on the same
trees, and one CLI epoch of `tiaf_tiny` (4 scans) with its evaluation
and the point evaluation from its checkpoint.  About 35 s on one worker
(`--durations`).
"""

import jax
import numpy as np
import pytest
import torch

from taseg_tpu.engine import load_matching_params as j_load_matching
from taseg_tpu_torch.configs import MINKUNET_MS_TINY, TIAF_TINY
from taseg_tpu_torch.engine import TIAF_TERMS, Trainer
from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

CFG = {**TIAF_TINY, "MODEL": {**TIAF_TINY["MODEL"], "CAPACITY_SCHEDULE": (1.0,) * 5}}
SCHED = dict(iters_per_epoch=1, total_epochs=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's thread team per process oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict) else {pre + k: np.asarray(v, np.float64)})
    return out


def test_load_pretrained_fsa_into_main(tmp_path):
    """An FSA MinkUNetMs checkpoint (the TIAF main branch's architecture:
    mk34 depth at cr 0.125, 5 features) loads into `main/` by suffix,
    parameters and BN statistics, as JAX's `load_matching_params` loads
    the same trees."""
    fsa_cfg = {**MINKUNET_MS_TINY, "MODEL": {**MINKUNET_MS_TINY["MODEL"], "NUM_LAYER": [2, 3, 4, 6, 2, 2, 2, 2]}}
    fp, fs = init_params_numpy(fsa_cfg, seed=11)
    rng = np.random.default_rng(0)
    fs = jax.tree_util.tree_map(lambda v: (v + rng.uniform(0.1, 0.2, v.shape)).astype(np.float32), fs)
    fsa = Trainer(fsa_cfg, {"params": fp, "batch_stats": fs}, device="cpu", output_dir=tmp_path / "fsa", **SCHED)
    fsa.save_checkpoint(0)
    p, s = init_params_numpy(CFG, seed=3)
    tr = Trainer(CFG, {"params": p, "batch_stats": s}, device="cpu", output_dir=tmp_path / "tiaf", **SCHED)
    tr.load_pretrained(str(tmp_path / "fsa" / "ckpt" / "checkpoint_epoch_0"))
    got_p, got_s = (_flat(t) for t in export_flax_params(tr.model))
    want_p = _flat(j_load_matching(p, fp))
    want_s = _flat(j_load_matching(s, fs))
    for got, want in ((got_p, want_p), (got_s, want_s)):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    src = _flat(fp)
    main = [k for k in got_p if k.startswith("main/")]
    assert main and all(np.array_equal(got_p[k], src[k[len("main/"):]]) for k in main)


def test_cli_trains_tiaf_tiny(tmp_path, monkeypatch):
    """One epoch of tiaf_tiny through the CLI (4 scans): the staged
    freezing logged, the five terms in the metrics, a checkpoint, and the
    evaluation; then point evaluation from the checkpoint."""
    from taseg_tpu_torch.train import main

    monkeypatch.chdir(tmp_path)
    cfg = "tools/cfgs/voxel/synthetic/tiaf_tiny.yaml"
    main(["--cfg_file", cfg, "--epochs", "1", "--device", "cpu", "--set", "DATA.LENGTH", "4"])
    run = tmp_path / "output" / "tiaf_tiny" / "default"
    log = (run / "log.txt").read_text()
    assert "fix_part_param: training only" in log and "saved checkpoint" in log and "mIoU" in log
    tags = (run / "metrics" / "metrics.jsonl").read_text()
    assert all(f'"train/{k}"' in tags for k in TIAF_TERMS)
    main(["--cfg_file", cfg, "--eval", "--save_path", "preds", "--device", "cpu", "--set", "DATA.LENGTH", "4"])
    files = sorted((tmp_path / "preds" / "sequences" / "08" / "predictions").glob("*.label"))
    assert [len(np.fromfile(f, np.uint32)) for f in files] == [1500] * 4  # frame points only
