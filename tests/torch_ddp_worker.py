"""One rank of `test_torch_ddp.py`'s process group (gloo, on the CPU).

Imports no JAX: `torch.multiprocessing` starts each rank in a fresh
interpreter, and JAX's start-up would only cost time there.  The
rendezvous is a `FileStore` in the test's temporary directory, with a
timeout of its own, so a rank that never arrives fails the run instead of
holding it.  Each rank runs, in order:

  * `step`: the plain train step of a tiny MinkUNet with IF_DIST, its
    collated shard per step read from `shards/step<i>_rank<r>.npz`;
  * `kd`: one KD step of the tiny KD recipe on its own scan;
  * `eval`: `Trainer.evaluate()` over its slice of the val loader;
  * `range`: two adamW steps of SalsaNext (base 8, dropout off), its
    collated range shard per step read from `range_step<i>_rank<r>.npz`;
  * `eqlv2`: the EQLv2 loss with `dist` over its own logits per step,
    its statistics summed over the ranks, carried from step to step;

and writes what it saw to `out_rank<r>.pt`.  A spec holds the stages it
wants; the others are not run.
"""

from __future__ import annotations

import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

RDV_TIMEOUT_S = 60


def run(rank: int, world: int, tmp: str, spec: dict) -> None:
    torch.set_num_threads(1)
    tmp = Path(tmp)
    store = dist.FileStore(str(tmp / "rendezvous"), world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RDV_TIMEOUT_S),
    )
    try:
        out = {"rank": rank}
        stages = {"step": lambda s: _steps(rank, tmp, s), "kd": lambda s: _kd(rank, s),
                  "eval": _eval, "range": lambda s: _range(rank, tmp, s),
                  "eqlv2": lambda s: _eqlv2(rank, s)}
        for name, fn in stages.items():
            if name in spec:
                out[name] = fn(spec[name])
        torch.save(out, tmp / f"out_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _flat_state(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _steps(rank: int, tmp: Path, spec: dict) -> list:
    from taseg_tpu_torch.engine import Trainer, to_device
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params

    tr = Trainer(
        spec["cfg"], spec["params"], device="cpu", batch_size=spec["global_batch"], seed=9,
        point_capacity=spec["cap"], iters_per_epoch=spec["iters_per_epoch"],
        total_epochs=spec["total_epochs"],
    )
    got = []
    for i in range(spec["steps"]):
        arrays = dict(np.load(tmp / "shards" / f"step{i}_rank{rank}.npz"))
        arrays = to_device(arrays, torch.device("cpu"), ("point_coords", "point_feats", "labels"))
        r = tr.train_on(arrays)
        r["variables"] = export_flax_params(tr.model)
        got.append(r)
    return got


def _kd(rank: int, spec: dict) -> dict:
    from taseg_tpu_torch.data.synthetic import SyntheticMsKittiReader
    from taseg_tpu_torch.engine import Trainer

    tr = Trainer(
        spec["cfg"], spec["student"], device="cpu", batch_size=2, point_capacity=spec["cap"],
        teacher_capacity=spec["cap"], seed=9, iters_per_epoch=1, total_epochs=3,
    )
    tr.set_teacher(*spec["teacher"])
    reader = SyntheticMsKittiReader(length=2, n_points=1500, seed=1, kd=True)
    r = tr.step([reader[rank]])
    return {"loss": r["loss"], "state": _flat_state(tr.model)}


def _eval(spec: dict) -> np.ndarray:
    from taseg_tpu_torch.data import build_dataloader
    from taseg_tpu_torch import parallel
    from taseg_tpu_torch.engine import Trainer, _NullWriter

    cfg = spec["cfg"]
    val = build_dataloader(
        cfg["DATA"], training=False, scans_per_shard=1,
        process_index=parallel.rank(), process_count=parallel.world_size(),
    )
    tr = Trainer(
        cfg, spec["params"], device="cpu", iters_per_epoch=1, val_loader=val,
        output_dir=spec["output_dir"],
    )
    tr._writer = _NullWriter()  # TensorBoard's import alone takes ~15 s here
    return tr.evaluate()["hist"]


def _range(rank: int, tmp: Path, spec: dict) -> list:
    from torch_range_narrow import narrow_range_models

    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.models.layers import Dropout
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params

    with narrow_range_models(**spec["widths"]):
        tr = Trainer(
            spec["cfg"], spec["params"], device="cpu", batch_size=spec["global_batch"], seed=9,
            iters_per_epoch=spec["iters_per_epoch"], total_epochs=spec["total_epochs"],
        )
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.rate = 0.0
    got = []
    for i in range(spec["steps"]):
        arrays = dict(np.load(tmp / "shards" / f"range_step{i}_rank{rank}.npz"))
        r = tr.train_on(tr.shard_to_device(arrays))
        r["variables"] = export_flax_params(tr.model)
        got.append(r)
    return got


if __name__ == "__main__":
    sys.exit("run through tests/test_torch_ddp.py")


def _eqlv2(rank: int, spec: dict) -> list:
    """[(loss, pos_grad, neg_grad)] per step of `Losses(["EQLv2"], dist=True)`
    on this rank's rows of spec's (step, rank, N, C) logits."""
    from taseg_tpu_torch.loss import Losses

    crit = Losses(["EQLv2"], [1.0], dist=True)
    state = crit.init_state(spec["logits"].shape[-1])
    out = []
    for i in range(spec["logits"].shape[0]):
        loss, state = crit(
            torch.from_numpy(spec["logits"][i, rank]), torch.from_numpy(spec["labels"][i, rank]).long(),
            torch.from_numpy(spec["valid"][i, rank]), state,
        )
        out.append((float(loss), state.pos_grad.clone(), state.neg_grad.clone()))
    return out
