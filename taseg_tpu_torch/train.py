"""Train/eval CLI of the port: `python -m taseg_tpu_torch.train`.

Counterpart of the JAX package's `train.py:37-147` (reference
`train.py:55-125`): --cfg_file names a recipe by its YAML path (served
from `configs.RECIPES`, the port reads no YAML), --set dotted overrides,
--eval, --tta votes, --save_path submission files, --pretrained_model,
batch-size / epoch overrides.  Outputs go to
`output/<recipe>/<extra_tag>/` under the working directory (log.txt,
ckpt/checkpoint_epoch_<n>, metrics/); a run resumes from the newest
checkpoint there.  One process drives one device: `--device` (default
cuda; cpu runs the plain versions of the kernels).  MinkUNet and SPVCNN
on the `voxel` pipeline, RPVNet on the `fusion` one and Cylinder_TS on the
`cylinder` one (as JAX `train.py:102-107` picks them, by model name);
the range view's SalsaNext, FIDNet, CENet and RangeNet on the `range`
one (MODALITY range);
TASeg's temporal stages by dataset: MinkUNetMs on the multi-scan
pipeline (FSA, SMSA), MinkUNetMsKd on the `kd` one, whose frozen
teacher is MODEL.TEACHER_CKPT (JAX `train.py:127-128`; a checkpoint of
the FSA stage), and MinkUNetMsMm / MinkUNetMsMmNus (TIAF) on the `mm`
one, whose FSA branch loads from --pretrained_model (`main/` matched by
suffix); nuScenes and Waymo recipes likewise (`tools/cfgs/*/nuscenes/`,
`*/waymo/`; an evaluation of nuScenes with --save_path writes its
lidarseg submission files).

Several cards: `--distributed` under `torchrun`, one process per card
(`parallel.init_from_env`: NCCL on the card, gloo with `--device cpu`);
each process loads its slice of every global batch (batch size per
card x cards, the LR scaled by it), the gradients and the masked BN's
statistics (MODEL.IF_DIST) are summed over the cards, rank 0 writes the
log file, metrics and checkpoints:

    torchrun --nproc_per_node 4 -m taseg_tpu_torch.train --distributed \
        --cfg_file tools/cfgs/voxel/semantic_kitti/minkunet_mk18_cr10.yaml

    python -m taseg_tpu_torch.train \\
        --cfg_file tools/cfgs/voxel/synthetic/minkunet_tiny.yaml --epochs 1
    python -m taseg_tpu_torch.train \\
        --cfg_file tools/cfgs/voxel/synthetic/minkunet_tiny.yaml \\
        --eval --tta --votes_max 2 --save_path preds
    python -m taseg_tpu_torch.train \
        --cfg_file tools/cfgs/voxel/synthetic/minkunet_ms_kd_tiny.yaml --epochs 1 \
        --set MODEL.TEACHER_CKPT output/minkunet_ms_tiny/default/ckpt/checkpoint_epoch_0
    python -m taseg_tpu_torch.train \
        --cfg_file tools/cfgs/voxel/synthetic/tiaf_tiny.yaml --epochs 1
    python -m taseg_tpu_torch.train \
        --cfg_file tools/cfgs/range/synthetic/salsanext_tiny.yaml
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from . import parallel
from .data import build_dataloader
from .engine import Trainer
from .models import RANGE_SEGMENTORS, SEGMENTORS
from .utils.common import create_logger
from .utils.config import apply_overrides, load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="taseg_tpu_torch train/eval")
    p.add_argument("--cfg_file", required=True,
                   help="recipe YAML path (relative to the repository)")
    p.add_argument("--extra_tag", default="default", help="experiment tag")
    p.add_argument("--set", dest="set_cfgs", nargs=argparse.REMAINDER,
                   default=[], help="dotted-path config overrides")
    p.add_argument("--eval", action="store_true", help="evaluate only")
    p.add_argument("--seq", type=int, default=None,
                   help="restrict eval to one sequence (11-21 selects the "
                        "label-free test split for benchmark submissions)")
    p.add_argument("--tta", action="store_true", help="rotation-vote TTA")
    p.add_argument("--votes_min", type=int, default=0)
    p.add_argument("--votes_max", type=int, default=10)
    p.add_argument("--save_path", default=None,
                   help="write predictions (submission/pseudo-mask format)")
    p.add_argument("--save_score", action="store_true",
                   help="also write float logits per scan")
    p.add_argument("--pretrained_model", default=None)
    p.add_argument("--fix_random_seed", action="store_true")
    p.add_argument("--batch_size", type=int, default=None,
                   help="scans per step (per device)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--eval_interval", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (the hand kernels) or cpu (their plain versions)")
    p.add_argument("--distributed", action="store_true",
                   help="one process per card under torchrun (DDP)")
    return p.parse_args(argv)


def check_ported(cfg) -> str:
    """The recipe's MODALITY, where the port trains its model; raises
    otherwise.  The JAX CLI runs SPVCNN (MODALITY fusion) as the `voxel`
    kind, on the voxel pipeline, RPVNet on the `fusion` pipeline and
    Cylinder_TS (MODALITY voxel or cylinder) on the `cylinder` one (JAX
    engine.py:164-176, train.py:101-107), the range models with MODALITY
    range on the `range` one.  Every dataset of the JAX package is read
    (`data.build_reader` raises for another)."""
    modality = str(cfg.get("MODALITY", "voxel"))
    name = cfg["MODEL"]["NAME"]
    if name in RANGE_SEGMENTORS:
        ok = ("range",)
    elif name == "Cylinder_TS":
        ok = ("voxel", "fusion", "cylinder")
    else:
        ok = ("voxel", "fusion")
    if name not in SEGMENTORS or modality not in ok:
        raise NotImplementedError(
            f"{name} ({modality}) is no segmentor of the CLI (the backbones and BEV "
            f"modules are built in code); the port trains {sorted(SEGMENTORS)} on the voxel, fusion, "
            f"cylinder and range pipelines"
        )
    return modality


def pipeline_kind(cfg) -> str:
    """The host pipeline by model name, as JAX `train.py:102-107`:
    `cylinder` for Cylinder_TS, `fusion` for RPVNet, else None (the
    modality's)."""
    return {"Cylinder_TS": "cylinder", "RPVNet": "fusion"}.get(cfg.MODEL["NAME"])


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = load_config(args.cfg_file)
    if args.set_cfgs:
        cfg = apply_overrides(cfg, args.set_cfgs)
    if args.seq is not None:
        # per-sequence submission eval (reference train.py:75-76): test
        # sequences 11-21 are label-free, the eval loader serves them via
        # DATA.EVAL_SPLIT + DATA.SEQUENCES
        cfg.DATA["SEQUENCES"] = [args.seq]
        cfg.DATA["EVAL_SPLIT"] = "test" if args.seq >= 11 else "val"
    modality = check_ported(cfg)
    kind = pipeline_kind(cfg)

    device = parallel.init_from_env(args.device) if args.distributed else args.device
    rank, world = parallel.rank(), parallel.world_size()
    out_dir = Path("output") / cfg.TAG / args.extra_tag
    out_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(out_dir / "log.txt" if rank == 0 else None)
    if rank != 0:
        logger.setLevel(logging.WARNING)
    logger.info(f"device: {args.device}, {world} process(es)")

    scans_per_shard = args.batch_size or int(cfg.OPTIM.get("BATCH_SIZE_PER_GPU", 2))
    shard = dict(process_index=rank, process_count=world)
    train_loader = build_dataloader(
        cfg.DATA, training=True, scans_per_shard=scans_per_shard, modality=modality,
        pipeline_kind=kind, **shard,
    )
    val_loader = build_dataloader(
        cfg.DATA, training=False, scans_per_shard=scans_per_shard,
        point_capacity=train_loader.point_capacity, modality=modality, pipeline_kind=kind,
        **shard,
    )
    trainer = Trainer(
        cfg, None, device, train_loader=train_loader, val_loader=val_loader,
        output_dir=out_dir, logger=logger, total_epochs=args.epochs,
    )
    if args.pretrained_model:
        trainer.load_pretrained(args.pretrained_model)
    if cfg.MODEL.get("TEACHER_CKPT"):
        trainer.load_teacher(cfg.MODEL["TEACHER_CKPT"])
    resumed = trainer.resume_latest()

    if args.eval:
        if not resumed and not args.pretrained_model:
            logger.warning(
                "--eval with no checkpoint in %s and no "
                "--pretrained_model: evaluating RANDOM weights",
                trainer.ckpt_dir,
            )
        if args.tta or args.save_path:
            trainer.evaluate_points(
                tta_votes=(args.votes_max - args.votes_min) if args.tta else 0,
                save_path=args.save_path,
                save_score=args.save_score,
            )
        else:
            trainer.evaluate_points()
    else:
        trainer.train(eval_interval=args.eval_interval)
    parallel.shutdown()


if __name__ == "__main__":
    main()
