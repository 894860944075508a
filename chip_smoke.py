#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`taseg_tpu_torch`) on one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase 5e --phase 5g   # phases alone (`ALONE`)

Drives the port's main paths — `Segmenter.predict`, `Trainer.step` and
the harness around it (`Trainer.train` over the prefetching loader,
checkpoints, evaluation, TTA) of MinkUNet mk34 cr1.0
(tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10.yaml), then
`Segmenter.predict` and `Trainer.step` of SPVCNN mk34 cr1.0
(tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr10.yaml) and of RPVNet
mk18 cr1.0 (tools/cfgs/fusion/semantic_kitti/rpvnet_mk18_cr10.yaml, with
64 x 2048 range images), in bf16, and of Cylinder_TS cy480 cr1.0
(tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml) in f32, on
synthetic 120 000-point scans, and of TASeg's temporal stages, MinkUNetMs
mk34 cr1.0 (FSA, tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10_fsa.yaml)
and its mask-distillation step (_fsa_kd.yaml) in bf16 on fused
multi-scan clouds, and TIAF, MinkUNetMsMm (_fsa_tiaf.yaml) in f32 on
fused clouds with 5 camera images each, and the nuScenes and Waymo
recipes on sensor-sized synthetic trees, and torchsparse's demo
backbones SparseResNet21D and SparseResUNet42 with the global pools and
the BEV family on two scans (phase 5m), weights drawn from a seed — and
checks them:

  1. the card's name and power limit (nvidia-smi);
  2. the kernel build from the sources in the checkout, with its time;
  3. one phase per kernel at the main path's real shapes (captured from
     a real forward): K1 join_scan (one launch per call) bit-exact against
     its plain version, K2 sparse_conv_k3 and K3 strided down/up within
     stated tolerances, with kernel, plain and library times.  bf16 takes
     the Hopper wgmma route of K2 and K3 both ways (over the level's row
     order, child table and up table) at every width (ragged ones padded
     to a multiple of 8), f32 the CUDA-core route for a direct K2 call at
     27 offsets and the 3xTF32 route for K3; each
     per-shape line names its route, and beside the wgmma route's time
     stand the kernels it replaced (`old_ms`: the mma.sync K2 tile, the
     K3-down and K3-up tiles, through their C entries), its tile work over present
     pairs, blocks per SM and TFLOP/s, and per level of K2 the sums.  The
     real topology's child tables take one round at every level and
     equal the counted ones; what the child tables and row orders add to
     the topology, timed apart.  voxelize_avg
     (K6) and K7's single calls at the head's three real tables,
     bit-identical to the plain versions, with kernel, plain, bound and
     library (index_select, embedding_bag) times; K7's multi-scale entry
     at the same tables: the head's sum (one launch, bit-identical to its
     plain version, to the three calls and adds it replaced and on
     repeat, timed beside them) and the cat at KD's feature widths;
  4. the main path on 3 scans: finite logits of the right shape, every
     kernel's launch count above 0, 48 of the 48 K2 launches and 4 of the
     4 K3-down and 4 of the 4 K3-up launches of each scan on the wgmma
     route, 1 K7 launch per scan (the head's multi-scale sum, where the
     head took 3), bf16/f32 argmax agreement, agreement of the card's
     f32 path with the CPU's plain path on a small scan, and scans/s with
     the topology / forward split;
  5. the train path, `Trainer` of the same model in bf16: the backward
     kernels K4 k3_conv_dw (one launch on wgmma over the level's pair
     lists in bf16, the stem's 4 -> 32 at C_in padded to 8, beside the
     mma.sync tile it replaced, `old_ms`; CUDA cores in f32), K5 strided_dw
     (one launch over the level's per-slot pair lists: wgmma in bf16,
     the f32 weight gradients' 3xTF32 wgmma tile in f32, beside the
     mma.sync tile it replaced), K6 segment_sum (each of its 4 calls named and timed,
     one launch each, its bound recounted for the entries it reads),
     K5 and K6 with their device time beside their yardstick's,
     and the input-gradient calls of K2 and K3 on both routes (K2 and
     K3-down over the level's order and child table, beside the mma.sync
     3's tiles), at every shape that one real step gives them, against
     their plain versions (and bit-identical on a repeat call), K7 bit-identical to its plain
     version in the train forward; the head's backward, K6 once over the
     stacked pair table against the three calls it replaced (1e-5 of the
     largest sum of |terms|), bit-identical on repeat, device times of
     both; what the pair lists cost the
     topology; a small-scan f32 step on the card
     against the CPU's plain path; 4 full-width steps on 120 000-point
     scans with finite loss, grad norm and parameters and the launches of
     every kernel per step; ms per step by stage and peak memory;
  5b. the harness: `build_dataloader` over the synthetic reader (6 train
     and 3 eval scans of 120 000 points, batch 1, point capacity 131 072)
     and `Trainer.train(eval_interval=1)` for one epoch: 6 steps through
     the prefetching loader, a checkpoint and `evaluate()`, every launch
     counted (each kernel as TRAIN_PER_STEP and the inference path give
     it, so nothing ran a plain version); a fresh Trainer resumed from the
     checkpoint with the same bits (parameters, BN buffers, momentum
     traces, the schedule's count); `evaluate_points()` writing the
     logits and labels of `Segmenter.predict` on the same scans and
     weights, bit for bit; 2 TTA votes writing 3 .label files of raw
     ids; ms per step through the loader, the wait on its queue, the host
     stage inside the producer, the device stages beside the serial ones
     of 5, and eval scans/s without and with TTA;
  5c. SPVCNN at full width in bf16 on the same scans: `Segmenter.predict`
     with every launch counted (per scan K2 48 (all on tensor cores), K3
     4 + 4, K6 4, K7 4, K8 0), finite logits of the right shape, bf16/f32
     argmax agreement, the small-scan card f32 logits against the CPU,
     serving ms per scan by stage; K8 voxelize_bwd at the 3 calls of one
     real train step, bit-identical to its plain version (and in its
     other layout and its first kernel), with kernel, device, the other
     layout, the first kernel (`old_ms`), plain, bound and library
     times (`k8_call`); a small-scan f32 step on the
     card against the CPU; 4 counted full-width steps (per step K8 3, K6
     8, K7 4, the convs as MinkUNet's), ms per step by stage, peak
     memory, and (after them) each kernel's device time per step;
  5d. RPVNet at full width, the range branch in f32 as in JAX:
     `Segmenter.predict` with every launch counted (per scan K2 34 (all
     on tensor cores), K3 4 + 4, K6 7, K7 8 of which 4 at 4 corners, K8
     0), bf16/f32 argmax agreement, the small-scan card f32 logits
     against the CPU, serving ms per scan by stage, what the RpvContext
     adds to the topology, the range stages' forward; a small-scan f32
     step on the card against the CPU (dropout off on both); 4 counted
     full-width steps (per step K6 15, K7 8 of which 4 at 4 corners, K8
     6), ms per step by stage, peak memory, the range stages' forward and
     backward; then K7 at 4 corners at the 4 samples of a real step,
     bit-identical to its plain version and on repeat, with kernel,
     device, plain, bound and `embedding_bag` times, K6 over the 3 pixel
     tables and the 4 corner-pair tables against its plain version in
     f64, K8 at the 3 pixel scatters bit-identical (`k8_call`); each kernel's device
     time per step;
  5e. Cylinder_TS cy480 cr1.0 at full width (INIT_SIZE 32, the 480 x
     360 x 32 polar grid) in f32: `Segmenter.predict` with every launch
     counted (per scan K2 at K offsets 48, the 3^3 head's among them, all
     on the 3xTF32 route, K1 22, nothing else), finite logits of the
     right shape, the level counts beside their capacities, the
     small-scan card f32 logits against the CPU, serving ms per scan by
     stage and each kernel's device time per scan; K2 at K at every call
     of a real forward against its plain version, bit-identical on
     repeat, with its device time, beside the mma.sync 3xTF32 tile that
     its wgmma tile replaced (`old_ms`) and the CUDA-core kernel at the
     same inputs (through their C entries), with two bounds (f32 CUDA
     cores, 3xTF32), and once in
     bf16 (the tensor-core route) at the same shapes; the input and
     weight gradients (K2 at K, K4 at K) at every call of a real step the
     same way; what the row orders and pair lists cost; a small-scan f32
     step on the card against the CPU; 4 counted full-width steps (per
     step K2 at K 48 + 48, K4 at K 48, all on the 3xTF32 route, K1 22),
     ms per step by stage, peak memory and each kernel's device time per
     step; the phase's seconds;
  5f. FSA and KD at full width in bf16 on 3 fused clouds of
     SyntheticMsKittiReader(120 000 points, history 3), 262 144 rows per
     scan: the level counts beside their capacities; K2 and K3 at every
     conv shape of a fused forward (the stem's C_in 5 on K2's wgmma
     tile at C_in padded to 8), K6 at the voxelize forward (C = 5) and the head's K7
     against their plain versions, with their times; `Segmenter.predict`
     with every launch counted (MinkUNet's per scan), frame-length labels,
     bf16/f32 argmax agreement, a small fused cloud's f32 logits against
     the CPU, serving ms per scan by stage; 4 counted FSA steps
     (TRAIN_PER_STEP) by stage; the KD step's backward kernels and K7
     calls (the 480-wide features: K7 at C = 256 / 128 / 96 and their K6
     backwards) against their plain versions, 4 counted KD steps (the
     teacher's eval forward and the features added) by stage with the
     teacher's topology and forward apart, peak memory, the teacher's
     parameters and buffers bit-identical after them; the phase's seconds;
  5g. TIAF at full width in f32 (the _fsa_tiaf recipe: the mk34 main
     branch, UNet2D at IMAGE_BASE 32, the FOV branch at FOV_CR 0.5) on 2
     fused clouds of SyntheticTiafReader(120 000 points, history 3) with
     5 images of 384 x 1280, 262 144 main and 131 072 FOV rows per scan:
     the level counts of both topologies beside their capacities; one
     main-branch conv (the second stem conv, level 0) on K2 at 27 over
     the 3xTF32 route and on the 27-offset CUDA-core K2, and its weight
     gradient on K4 at 27 both ways, against the plain versions, with
     their times, bounds and one torch.mm; `Segmenter.predict` with every
     launch counted (TIAF_PER_SCAN: K2 at K 65, all on 3xTF32, K3
     8 + 8, K6 2, K7 15, K1 13), frame-length finite logits, the replace
     ensemble on the overlap; a small fused cloud with 5 images of 48 x
     160 on the card against the CPU; serving by stage; 3 counted
     `Trainer` steps with the staged recipe's freezing (TIAF_PER_STEP):
     finite loss, five terms and grad norm, the trainable parameters
     moved, `main/` bit-identical, `main`'s BN buffers moved, peak
     memory; the steps by stage (host, the topology's pieces, each
     branch's forward, loss, backward, optimizer) and each branch's
     forward and backward alone; the phase's seconds;
  5h. MinkUNet mk34 cr1.0 with the default block (Bottleneck, the
     flagship recipe without BLOCK) in bf16: one serving scan with every
     launch counted (K2 at each 3^3 conv, all on wgmma, K3 4 + 4 on
     wgmma: no width leaves the tensor-core routes),
     finite logits, the small-scan f32 logits card vs CPU; one counted
     train step, its time and peak memory; the phase's seconds;
  5i. the flagship's bf16 train step with MODEL.IF_DIST, 2 steps without
     torch.distributed and 2 in a NCCL process group of world size 1:
     losses, grad norms, level counts, parameters and BN statistics
     bit-equal; each run's ms per step and the phase's seconds;
  5j. the range view (tools/cfgs/range/semantic_kitti/salsanext_res34.yaml:
     SalsaNext at base 32 on 64 x 512 images, f32) on the same scans:
     `Segmenter.predict` counted (K9, the KNN clean-up, once a scan and
     no other kernel), finite logits, labels in range, serving by stage
     (host, forward, K9, mapping); K9 at a real scan's shapes
     array-equal to its plain version on the card and on the CPU and to
     its first design, with kernel and device times in turns with the
     first design's (`old_ms`), plain and bound times, its kernels a
     call (`graph_kernels`), and the same points again in beam order
     (`k9_check`); a small scan card vs CPU
     (logits, two f32 steps); 2 adamW + onecycle steps at the recipe's
     batch of 30 by stage with the peak memory; the salsanext_tiny
     recipe through the loader for 4 epochs, its loss falling; FIDNet
     and RangeNet++ at their recipes' widths: a counted scan and a step
     at batch 30 each; the phase's seconds;
  5k. nuScenes and Waymo (`phase_nus_waymo`): the eight recipes of
     tools/cfgs/{voxel,fusion}/{nuscenes,waymo}/ and CENet's nuScenes
     recipe at full width through their readers, on trees written from
     seeded synthetic scans at the sensors' sizes: serving and train
     steps counted (the launches per scan and per step as the recipe's
     backbone gives them) and by stage, with peak memory; the Waymo
     Cylinder's calls of one step (its 23-class head on K2 and K4 at K =
     27 over 3xTF32 at C_out padded to 24, timed beside the CUDA-core
     kernels that took it before) and K7's head at 17 and 23 classes
     against their plain versions; K9 at CENet's real call with seeded
     labels (`k9_check`, `seeded_labels`);
     `Trainer.train` and the nuScenes submission files of
     `evaluate_points`, equal to `Segmenter.predict`; each recipe's
     small scan card vs CPU at a narrow width; the phase's seconds;
  5l. MinkUNet and SPVCNN mk34 at cr 1.6 (`phase_cr16`): the five cr 1.6
     recipes (tools/cfgs/{voxel,fusion}/{semantic_kitti,waymo}/*_cr16*.yaml)
     at full width in bf16, whose widths (51, 102, 204, 409, 153, 613,
     306; 3 and 4 at the stems) are no multiples of 8: each serves 2
     counted scans by stage with peak memory (the KITTI ones on the
     synthetic 120 000-point scans, the Waymo ones on a sensor-sized
     tree), the KITTI MinkUNet and SPVCNN and the Waymo MinkUNet take a
     counted train step and two by stage; no K2, K3, K4 or K5 launch of
     these paths takes a CUDA-core kernel; every padded call of the KITTI
     MinkUNet's forward and step (and the xyz recipe's 3-wide stem)
     against its plain version at its captured shape, with kernel,
     device, padded-copy, CUDA-core (the kernel it replaced, through its C
     entry), plain, bound and torch.mm times; SPVCNN's K6 (409 channels:
     16 pieces a lane, beside K6 on rows padded to 412), K7 and K8 at its
     point widths; MinkUNet cr 1.0's stem K4 (4 -> 32) on wgmma beside
     the CUDA-core time in PERF.md §6; the phase's seconds;
  5m. torchsparse's demo backbones and the BEV family (`phase_backbones`):
     two synthetic 120 000-point scans quantized at 0.05 m in one batch
     of 2; SparseResNet21D (16-128, its strided entry convs on K2 / K4
     at K offsets over two levels, the (1, 3, 1) finisher at K = 3) and
     SparseResUNet42 (32-256, decoder 256/128/96/96) at full width, each
     by stage (topology, forward in f32 and in bf16, one f32 train step
     with a feature loss: topology, forward, backward, update) with its
     launches per wrapper and peak memory, bf16 within 5e-2 of f32; the
     six pools and BEV modules on the ResNet's last stage, counted (K10
     once, in the max pool); K10 at that pool's shape in f32 and bf16,
     and with ties planted (`k10_check`);
     both backbones and the six modules card against CPU on two small
     scans; the MinkUNet flagship's two bf16 steps with each of
     LOSS_VARIANTS (EQLv2 with sgd_fc; WCE, focal, dice v1 and ELL with
     adam; adam_onecycle) and the second's small-scan f32 steps card
     against CPU (`SMALL_STEP_VARIANT`);
     the phase's seconds.  In phase 5e K10 at Cylinder_TS's call
     (`phase_k10_cylinder`: bit-exact both ways, on repeat, one counted
     launch a call each way and the kernels a call that
     K10_KERNELS_PER_CALL says, counted in a captured CUDA graph
     (`graph_kernels`), each way and a train step's pair timed
     in turns with the first design's, beside its bound and one
     scatter_reduce(amax) with its fill), and no scatter_reduce and no
     first-design K9 / K10 kernel on its serving or train path;
  6. each kernel's device time per scan (inference) and per step (train)
     on the main paths (torch.profiler device events), and the train
     step's largest plain-torch kernels;
  7. one JSON line listing the kernels, K2, K3, K4 and K5 with their
     launches per route, K2, K3 and K4 with `old_ms` (the tiles their
     wgmma routes replaced, at the same calls) and their input gradients' too, K2, K3 and K7 with their train launches, K7 at 4
     corners as its own entry (`devoxelize_bilinear`, RPVNet's serving
     launches), K6 and K8 with their times at RPVNet's pixel tables, every
     kernel with its launches per scan and per step on SPVCNN's and
     RPVNet's paths; K7's multi-scale entry (`devoxelize_multi`, the
     head's launches, its time beside the three calls and adds it
     replaced, `old_ms`); K2 at K offsets (`sparse_conv_k`, with its train
     launches and input-gradient times) and K4 at K offsets
     (`sparse_conv_dw`) with Cylinder_TS's launches per route, the
     CUDA-core time (`cuda_core_ms`), the mma.sync 3xTF32 tiles that the
     wgmma tiles replaced (`old_ms`, `old_device_ms`), the device time,
     the 3xTF32 bound and the head's share, K5 in f32 on TIAF's step
     (`strided_dw_tf32`: its wgmma tile beside the mma.sync one),
     and every kernel's launches on Cylinder_TS's path; K10
     (`segment_max`) with Cylinder_TS's serving launches, its train
     launches, its kernels a call, its numbers both ways at Cylinder's
     call beside its first design's (`old_ms`) and at the max pool's
     (`pool`, `pool_bf16`, phase 5m); every kernel's
     launches per scan, per FSA step and per KD step, and its times at
     the fused shapes (`fsa`); every kernel's TIAF launches per scan and
     per step (`tiaf`), on each nuScenes / Waymo path (`nus_waymo`) and
     on each cr 1.6 path with the padded calls' times (`cr16`),
     with the 3xTF32 / CUDA-core route call beside K2
     and K4 at K offsets; K9 (`knn`) with SalsaNext's serving launches
     and its times at one scan beside its first design's (`old_ms`), in
     beam order (`beam_order`) and at CENet's call (`cenet_nuscenes`).
     Beside each kernel and plain time stands one PyTorch call of the
     same function (`library_ms`): K1 three cummax, K6 one index_add_, K7
     index_select and embedding_bag, K8 index_select of rows divided
     beforehand, the convs one torch.mm on rows gathered beforehand.

The last line is {"ok": true, "device": {...}}.  Any failure raises and
the exit code is not 0.  Without CUDA, or without the package beside
this file, it exits non-zero and prints no result.  It imports no JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from functools import partial
from pathlib import Path

REPO = Path(__file__).resolve().parent
N_POINTS = 120_000
N_SCANS = 3
ROUNDS = 14  # throughput samples: ROUNDS * N_SCANS scans, 10+ beyond p75
SEED = 0
# launches per scan of the main path: (all, tensor-core route: K2 and
# K3-down and K3-up the wgmma tile); the stem's first conv (C_in = 4)
# takes K2's wgmma tile at C_in padded to 8, as every ragged width
K2_PER_SCAN = (48, 48)
DOWN_PER_SCAN = (4, 4)
UP_PER_SCAN = (4, 4)
# the inference path's kernels
INFER_KERNELS = (
    "join_scan", "sparse_conv_k3", "sparse_conv_k3_wgmma", "strided_down",
    "strided_down_wgmma", "strided_up", "strided_up_wgmma", "segment_sum",
    "devoxelize", "devoxelize_multi",
)
# the head's strides 16, 4 and 1 in one launch of K7's multi-scale entry
# (counted under `devoxelize` and `devoxelize_multi`; 3 launches before)
DEVOX_PER_SCAN = 1
# the LAUNCHES entry of each wrapper's tensor-core route on the path
ROUTE_ENTRY = {"sparse_conv_k3": "_wgmma", "strided_down": "_wgmma", "strided_up": "_wgmma"}
# each wrapper's kernels, by fragments of their names in the profiler
KERNEL_NAMES = {
    "join_scan": ("join_scan_kernel",),
    # the wgmma kernel is one template for K2 and K3 both ways, named
    # apart by its table (K2Rows / DownSlots / UpSlots); the wgmma tile of
    # K4 and K5 by its lists (K3Lists / SlotLists)
    "sparse_conv_k3": ("k3_conv", "K2Rows"),
    "strided_down": ("strided_down", "DownSlots"),
    "strided_up": ("strided_up", "UpSlots"),
    "segment_sum": ("segment_sum_",),
    "k3_conv_dw": ("PairsK3", "K3Lists"),
    # K5: its CUDA-core kernel and the lists' tiles (bf16 wgmma, f32 3xTF32
    # wgmma) over the slot lists
    "strided_dw": ("PairsStrided", "SlotLists"),
    # K7: its column kernel (single calls and the cat epilogue) and its
    # sum kernel (the head)
    "devoxelize": ("devox_cols_kernel", "devox_sum_kernel"),
    # K7's 4-corner instances (a tuple: every fragment must appear; the
    # last template argument is the calls' corner count)
    "devoxelize_bilinear": (("devox_cols_kernel", ", 4>"),),
    "devoxelize_multi": ("devox_sum_kernel",),
    # K8's two layouts (its first kernel, `voxelize_bwd_kernel`, is the
    # yardstick `old_ms`, never on a path)
    "voxelize_bwd": ("voxelize_bwd_rows_kernel", "voxelize_bwd_flat_kernel"),
    # K2 at K: its CUDA-core kernel, the 3xTF32 wgmma tile with its split
    # reduction and the weight's split (`tf32_split_kernel`, a launch of
    # the call where the weight keeps no split operand); K3's f32 calls
    # run the same kernels
    "sparse_conv_k": ("sparse_conv_k_", "tf32_split_kernel"),
    # K4 at K: its CUDA-core kernel and the 3xTF32 wgmma tile over the
    # offset lists (one kernel a call)
    "sparse_conv_dw": ("PairsOffsets", ("dw_tf32_wgmma_kernel", "OffsetLists")),
    # K10: the -inf fill, the runs kernel (the forward's max, the
    # backward's tie count) and the shares
    "segment_max": ("k10_",),
}
# the first designs of K9 and K10 (the yardsticks `old_ms`, through their
# C entries, on no path); a profiled Cylinder_TS scan or step holding one
# of them fails
OLD_K9K10_KERNELS = ("segment_max_fwd_kernel", "segment_max_bwd_kernel", "knn_postproc_v1_kernel")
# the mma.sync pair-list tiles that wgmma tiles replaced (K4's bf16 tile,
# the 3xTF32 tiles of K4 at K and of K5, K4 at K's split reduction): the
# yardsticks `old_ms`, through their C entries, on no path; a profiled
# train step holding one of them fails
OLD_DW_KERNELS = ("dw_mma_kernel", "dw_mma_reduce_splits_kernel", "sparse_conv_dw_tf32_kernel",
                  "strided_dw_tf32_kernel")
TRAIN_STEPS = 4
# launches per train step (bf16, batch 1): K2 48 forward + 47 input
# gradients (the stem's first conv takes none), all on tensor cores; K3 4
# + 4 each way; K4 one per k3 conv, all on the wgmma tile over the offset
# lists (the stem's first, 4 -> 32, at C_in padded to 8), K5
# one per strided conv, all on the wgmma tile; K6 the voxelize forward and
# the head's backward (one call over its stacked pair tables; 3 before);
# K7 the head's one multi-scale launch (3 before)
TRAIN_PER_STEP = {
    "join_scan": 5,
    "sparse_conv_k3": 95, "sparse_conv_k3_wgmma": 95,
    "sparse_conv_k3_dgrad": 47, "sparse_conv_k3_dgrad_wgmma": 47,
    "strided_down": 8, "strided_down_wgmma": 8,
    "strided_down_dgrad": 4, "strided_down_dgrad_wgmma": 4,
    "strided_up": 8, "strided_up_wgmma": 8,
    "strided_up_dgrad": 4, "strided_up_dgrad_wgmma": 4,
    "k3_conv_dw": 48, "k3_conv_dw_wgmma": 48, "strided_dw": 8, "strided_dw_wgmma": 8,
    "segment_sum": 2, "devoxelize": 1, "devoxelize_multi": 1, "devoxelize_bilinear": 0,
    "voxelize_bwd": 0,
}

# SPVCNN (tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr10.yaml), the same
# backbone with the point branch: per scan the convs of MinkUNet, K6 on
# the stem's voxelize and the three re-voxelizations (strides 1, 16, 4),
# K7 on the four devoxelizations (strides 1, 16, 4, 1); per train step
# also K6 on the four devox backwards and K8 on the three re-voxelize
# backwards (the stem's input takes no gradient)
SPVCNN_PER_SCAN = {
    "join_scan": 5, "sparse_conv_k3": 48, "sparse_conv_k3_wgmma": 48,
    "strided_down": 4, "strided_down_wgmma": 4, "strided_up": 4, "strided_up_wgmma": 4,
    "segment_sum": 4, "devoxelize": 4, "devoxelize_multi": 0, "voxelize_bwd": 0,
}
SPVCNN_PER_STEP = {
    **TRAIN_PER_STEP, "segment_sum": 8, "devoxelize": 4, "devoxelize_multi": 0, "voxelize_bwd": 3,
}
SPVCNN_ROUNDS = 4  # serving samples: SPVCNN_ROUNDS * N_SCANS scans

# RPVNet (tools/cfgs/fusion/semantic_kitti/rpvnet_mk18_cr10.yaml): the
# mk18 backbone (two blocks per stage: K2 34 per scan, all on wgmma), the point branch, and the range branch on 64 x 2048
# images.  Per scan K6 on the stem's voxelize, the three re-voxelizations
# and the three scatters to the range image (pixel tables at scales 1, 16
# and 4); K7 on the four voxel devoxelizations and the four bilinear
# samples of the range stages (4 corners, scales 1, 16, 4, 1).  Per train
# step also K6 on the four devox and the four sample backwards (over the
# 4P corner pairs), K8 on the three re-voxelize and the three scatter
# backwards
RPVNET_PER_SCAN = {
    "join_scan": 5, "sparse_conv_k3": 34, "sparse_conv_k3_wgmma": 34,
    "strided_down": 4, "strided_down_wgmma": 4, "strided_up": 4, "strided_up_wgmma": 4,
    "segment_sum": 7, "devoxelize": 8, "devoxelize_bilinear": 4, "devoxelize_multi": 0,
    "voxelize_bwd": 0,
}
RPVNET_PER_STEP = {
    **TRAIN_PER_STEP,
    "sparse_conv_k3": 67, "sparse_conv_k3_wgmma": 67,
    "sparse_conv_k3_dgrad": 33, "sparse_conv_k3_dgrad_wgmma": 33,
    "k3_conv_dw": 34, "k3_conv_dw_wgmma": 34,
    "segment_sum": 15, "devoxelize": 8, "devoxelize_bilinear": 4, "devoxelize_multi": 0,
    "voxelize_bwd": 6,
}
RPVNET_ROUNDS = 3  # serving samples: RPVNET_ROUNDS * N_SCANS scans
RANGE_MODULES = ("range_stem", "range_encoder", "range_dec_top", "range_dec_bottom")

# Cylinder_TS (tools/cfgs/voxel/semantic_kitti/cylinder_cy480_cr10.yaml),
# f32 on the 480 x 360 x 32 polar grid: per scan 48 convs over K offsets
# (K2 at K: 36 at K = 9, 4 at 8, 4 at 4, 3 at 3, the 3^3 head (20
# classes) at 27), all on the 3xTF32 route, and 22 joins (K1: 2
# asymmetric rulebooks per level, the 4 pooling tables and their
# reverses, 3 recon rulebooks, the head's); per train step also the 48
# input gradients (K2 at K) and weight gradients (K4 at K), all on the
# 3xTF32 route (K4 at K on the f32 weight gradients' wgmma tile, one
# kernel a call); its max-pooled voxelization on K10 (`segment_max`,
# once a scan, forward and backward once each a step: no scatter_reduce
# on the path), no other kernel (its devoxelization is a gather), none at
# 27 offsets
CYLINDER_PER_SCAN = {"join_scan": 22, "sparse_conv_k": 48, "sparse_conv_k_tf32": 48, "segment_max": 1}
CYLINDER_PER_STEP = {
    "join_scan": 22, "sparse_conv_k": 96, "sparse_conv_k_tf32": 96,
    "sparse_conv_k_dgrad": 48, "sparse_conv_k_dgrad_tf32": 48,
    "sparse_conv_dw": 48, "sparse_conv_dw_tf32": 48,
    "segment_max": 2, "segment_max_bwd": 1,
}
CYLINDER_ROUNDS = 3  # serving samples: CYLINDER_ROUNDS * N_SCANS scans

# TASeg's temporal stages (tools/cfgs/voxel/semantic_kitti/
# minkunet_mk34_cr10_fsa.yaml and _fsa_kd.yaml): MinkUNetMs mk34 cr1.0 on
# fused clouds of SyntheticMsKittiReader(n_points=120 000, history=3) at
# 262 144 rows per scan (POINTS_PER_SCAN of the recipes).  Serving runs
# MinkUNet's kernels per scan, the stem's first conv (C_in 5: xyz, r and
# the time flag) on K2's wgmma tile at C_in padded to 8; an FSA train step those of
# TRAIN_PER_STEP; a KD step adds the teacher's eval forward (K2 48, K3 4
# + 4, K6 1, K7 1 + 1: the head's and the features' multi-scale
# launches) and the student's feature devoxelizations (K7 1, the cat)
# and their backwards (K6 3, one per scale's columns).  K1's count is the one serving
# measures (the fused rows come unsorted), and a KD step's is the
# student's plus the teacher's
FSA_HISTORY = 3
FSA_PER_SCAN = {
    "sparse_conv_k3": 48, "sparse_conv_k3_wgmma": 48, "strided_down": 4, "strided_down_wgmma": 4,
    "strided_up": 4, "strided_up_wgmma": 4, "segment_sum": 1, "devoxelize": 1,
    "devoxelize_multi": 1,
}
KD_TEACHER = {
    "sparse_conv_k3": 48, "sparse_conv_k3_wgmma": 48, "strided_down": 4, "strided_down_wgmma": 4,
    "strided_up": 4, "strided_up_wgmma": 4, "segment_sum": 1, "devoxelize": 2,
    "devoxelize_multi": 2,
}
FSA_ROUNDS = 2  # serving samples: FSA_ROUNDS * N_SCANS scans

# the harness phase: one epoch of train scans through the loader, the
# eval scans, and the point capacity passed as bench.py passes it (the
# YAML's NUM_POINTS of 1 000 000 would give 1 M rows per scan)
HARNESS_TRAIN_SCANS = 6
HARNESS_EVAL_SCANS = 3
HARNESS_POINT_CAPACITY = 131072

# the range view (phase 5j): serving samples, the recipes' batch per
# card, timed steps, and the tiny recipe's epochs through the loader
RANGE_ROUNDS = 4
RANGE_BATCH = 30
RANGE_STEPS = 2
RANGE_TINY_EPOCHS = 4

# seconds that `device_ms` holds a profiled window open on each side
# (times the try's number)
PROFILE_MARGIN_S = 0.01

# published H100 SXM peaks (NVIDIA data sheet), dense
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 494.7e12 / 3}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of `fn` over `iters` calls, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def named(key: str, frags) -> bool:
    """Whether a profiler key holds one of `frags` (a tuple in `frags`:
    all of its fragments)."""
    return any(all(p in key for p in f) if isinstance(f, tuple) else f in key for f in frags)


def device_ms(fn, frags, iters: int = 10, tries: int = 6):
    """Mean device time per call of `fn`'s kernels whose names hold one
    of `frags`, from torch.profiler's device events over `iters` calls after
    one warm-up; None (not measured, and said so in the log) where no try
    of `tries` records each matching kernel at least once a call (a call
    of several kernels, as a split call and its reduction, whose profile
    lost some of one kernel's events would be undercounted).  Each try holds
    the profiled window open PROFILE_MARGIN_S (times the try's number)
    before the first call and after the last: with short windows the
    profiler lost every device event of some calls, or most of them, in
    the same calls from run to run.  Unlike `cuda_ms` it leaves out the
    host's cost per launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for t in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_MARGIN_S * t)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_MARGIN_S * t)
        events = [e for e in prof.key_averages() if e.device_type != torch.autograd.DeviceType.CPU]
        hit = [e for e in events if named(e.key, frags)]
        n = min((e.count for e in hit), default=0)
        if n >= iters:
            return sum(e.self_device_time_total for e in hit) / 1e3 / iters
        seen.append(f"{n} ({len(events)} kinds of device event)")
    log(f"  device time not measured: a kernel named {frags} with fewer device events than calls in {tries} "
        f"profiles of {iters} calls (its fewest events per try: {', '.join(seen)})")
    return None


def call_device_ms(fn, iters: int = 10):
    """Device ms of one call of `fn`, every kernel of it (some launched
    more than once, and calls that read a count back to the host, which
    a CUDA graph cannot hold): every device event's time in a
    torch.profiler window of `iters` calls after one warm-up, over the
    calls (an event the profiler lost counts nothing); None where it saw
    no event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    ev = [e for e in prof.key_averages()
          if e.device_type != torch.autograd.DeviceType.CPU and not e.is_user_annotation]
    return sum(e.self_device_time_total for e in ev) / 1e3 / iters if ev else None


def graph_ms(fn, n: int = 20, reps: int = 5):
    """Device ms of one call of `fn`, every kernel of it: CUDA events
    around `reps` replays of a CUDA graph of `n` calls (no host cost
    between the launches; the profiler lost one event of ten of these
    short kernels in whole runs); None (said so in the log) where the
    calls cannot be captured."""
    import torch

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(n):
                fn()
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as e:
        torch.cuda.synchronize()
        log(f"  device time not measured: the calls were not captured ({str(e).splitlines()[0][:120]})")
        return None
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / (reps * n)


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def msum(*xs):
    """The sum of `xs`; None (not measured) where one of them is."""
    return None if any(x is None for x in xs) else sum(xs)


def mscale(n, x):
    """n * x; None where x is None."""
    return None if x is None else n * x


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_scans(n: int, n_points: int = N_POINTS, seed: int = SEED) -> list:
    import numpy as np

    from taseg_tpu_torch.data.synthetic import synthetic_scan

    rng = np.random.default_rng(seed)
    scans = []
    for _ in range(n):
        pts, labels = synthetic_scan(rng, n_points)
        ring = np.zeros((len(pts), 1), np.float32)
        scans.append(
            {"xyzret": np.concatenate([pts, ring], 1), "labels": labels}
        )
    return scans


class Capture:
    """Forward pre-hooks on every SparseConv of more than one offset: per
    distinct (kind, rows, C_in, C_out) the first call's input, weight,
    forward table (with the level's order), reverse table (a train
    forward's KTable, else None) and whether the input takes a gradient;
    and how often each key occurs."""

    def __init__(self, model):
        from taseg_tpu_torch.models.layers import SparseConv
        from taseg_tpu_torch.ops.strided_conv import StridedTables

        self.seen: dict = {}
        self.count: dict = {}
        self.handles = []
        self._strided = StridedTables
        for m in model.modules():
            if isinstance(m, SparseConv) and m.kernel_volume > 1:
                self.handles.append(m.register_forward_pre_hook(self._hook))

    def _hook(self, module, args):
        from taseg_tpu_torch.ops.sparse_conv import KTable, as_table

        feats, table = args
        bwd = None
        if isinstance(table, self._strided):
            kind = "strided_up" if module.transposed else "strided_down"
        else:  # the forward table, with the level's order (of a pair in training)
            kind = "sparse_conv_k3"
            pair = isinstance(table, tuple) and not isinstance(table, KTable)
            table, bwd = (as_table(table[0]), table[1]) if pair else (as_table(table), None)
        key = (kind, feats.shape[0], module.in_channels, module.out_channels)
        self.count[key] = self.count.get(key, 0) + 1
        if key not in self.seen:
            self.seen[key] = (feats.detach(), module.kernel.detach(), table, bwd, feats.requires_grad)

    def remove(self):
        for h in self.handles:
            h.remove()


def check_close(name, got, want, ref_abs, dtype: str, rel: float) -> float:
    """max |got - want|, raising above rel * max|sum of |terms|| (f32
    summation order) plus, in bf16, one rounding of the output."""
    err = (got.float() - want.float()).abs().max().item()
    tol = rel * ref_abs.float().abs().max().item()
    if dtype == "bfloat16":
        tol += 2.0**-7 * want.float().abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max |err| {err:.3e} > tol {tol:.3e}")
    return err


def gathered_rows(x, idx):
    """(V, K * C): row v holds x[idx[k, v]] for k = 0..K-1 side by side,
    zero where idx is -1 (the rows a gather-GEMM reads, laid out for one
    dense matrix product)."""
    import torch

    g = x[idx.clamp(min=0).long()]
    g = torch.where((idx >= 0)[:, :, None], g, 0)
    return g.permute(1, 0, 2).reshape(idx.shape[1], -1)


def conv_library_ms(name: str, x, w, table) -> float:
    """One torch.mm that computes a conv call of K2 / K3 (forward or input
    gradient) on rows gathered beforehand: (rows x K C_in) @ W reshaped
    to (K C_in x C_out); K = the rulebook's offsets, or the 8 slots."""
    import torch

    from taseg_tpu_torch.ops.strided_conv import slot_child_table, slot_up_table

    if name in ("sparse_conv_k3", "sparse_conv_k", "sparse_conv_k_dgrad"):
        idx = table
    elif name == "strided_down":
        idx = slot_child_table(table)[0]  # one round on the path
    else:
        idx = slot_up_table(table)
    a = gathered_rows(x, idx)
    b = w.reshape(-1, w.shape[2])
    ms = cuda_ms(lambda: torch.mm(a, b))
    del a
    return ms


def dw_library(name: str, x, y, table, up: bool = False):
    """One torch.mm that computes a weight gradient of K4 / K5: x^T @ the
    cotangent rows gathered per offset or slot side by side (zero where
    absent), as a call on rows gathered beforehand."""
    import torch

    from taseg_tpu_torch.ops.strided_conv import slot_child_table, slot_up_table

    if name in ("k3_conv_dw", "sparse_conv_dw"):
        b = gathered_rows(y, table)
    elif up:  # x coarse rows, y fine rows: the children per slot
        b = gathered_rows(y, slot_child_table(table)[0])
    else:  # x fine rows, y coarse rows at each fine row's slot
        b = gathered_rows(y, slot_up_table(table))
    xt = x.t()
    return lambda: torch.mm(xt, b)


def dw_library_ms(name: str, x, y, table, up: bool = False) -> float:
    return cuda_ms(dw_library(name, x, y, table, up))


def k6_library(x, t, w):
    """K6's yardstick on one call: zero the (V, C) output and
    `index_add_` the call's (weighted) real rows, prepared beforehand,
    into their segments."""
    import torch

    v = t.starts.shape[0] - 1
    r_real = t.perm.shape[0] - v
    p, c = x.shape
    seg = torch.repeat_interleave(torch.arange(v, device=x.device), (t.starts[1:] - t.starts[:-1]).long())
    members = t.perm[: seg.shape[0]]
    keep = members < r_real
    rows_idx = members[keep]
    rows = x[rows_idx % p].float()
    if w is not None:
        rows = rows * w.reshape(-1)[rows_idx][:, None]
    ids = seg[keep]
    out = torch.zeros(v, c, device=x.device)
    return lambda: out.zero_().index_add_(0, ids, rows)


def k6_bytes(x, t, w) -> tuple[int, int]:
    """(bytes, the sentinel-inclusive count) of one K6 call: starts, the
    real members' perm entries (8 bytes) and weights (4), src read once
    and out written once; the earlier count read a perm entry for every
    sorted row, the sentinels' included, and every weight."""
    v = t.starts.shape[0] - 1
    r_real = t.perm.shape[0] - v
    members = int(t.starts[-1]) - v
    common = (v + 1) * 4 + x.numel() * x.element_size() + v * x.shape[1] * 4
    new = common + members * (8 + (4 if w is not None else 0))
    old = common + t.perm.numel() * 8 + (r_real * 4 if w is not None else 0)
    return new, old


def k1_call(topo, l: int):
    """K1's floor-mode call at level `l` of the main path, on the sorted
    union that `build_rulebook_k3` scans there."""
    import torch

    from taseg_tpu_torch.ops.coords import QUERY_SENTINEL_HI
    from taseg_tpu_torch.ops.join import sorted_union
    from taseg_tpu_torch.ops.join_scan import join_scan
    from taseg_tpu_torch.ops.rulebook import k3_floor_queries

    lt = topo.levels[l]
    hi, lo, q_hi, q_lo = k3_floor_queries(lt.coords, lt.num, 2**l, topo.bounds)
    shi, slo2, srow = sorted_union(hi, lo, q_hi, q_lo)
    num = lt.num.reshape(1).to(torch.int32)
    return partial(join_scan, shi, slo2, srow, num, hi.shape[0], int(QUERY_SENTINEL_HI), 1)


def down_call(kern, rows: int, c_in: int, w, table):
    """A K3-down call at a main-path shape, on seeded random features
    (its time does not depend on their values)."""
    import torch

    gen = torch.Generator(device=w.device).manual_seed(SEED)
    x = torch.randn(rows, c_in, device=w.device, generator=gen).to(w.dtype)
    return partial(kern, x, w, table)


def old_call(name: str, x, w, t):
    """The kernels the wgmma and 3xTF32 routes replaced on the path, at
    the same inputs, through their C entries (counted nowhere): the
    tensor-core K2 tile in table order (`sparse_conv_k3`, bf16 widths in
    8s), the mma.sync K3-down round tile and K3-up tile (`strided_down`,
    `strided_up`, bf16 widths in 8s) and the CUDA-core K3 kernels (f32).
    Returns the output."""
    import torch

    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops.sparse_conv import DTYPE_CODES

    c_in, c_out = x.shape[1], w.shape[2]
    w = w.contiguous()  # an input gradient's W^T comes as a view of W
    if name == "sparse_conv_k3":
        out = torch.empty((x.shape[0], c_out), dtype=x.dtype, device=x.device)
        _build.launch("taseg_sparse_conv_k3_mma", (), x.data_ptr(), w.data_ptr(), t.data_ptr(),
                      out.data_ptr(), x.shape[0], c_in, c_out)
        return out
    if name == "strided_up":
        v_fine = t.parent.shape[0]
        out = torch.empty((v_fine, c_out), dtype=x.dtype, device=x.device)
        ptrs = (x.data_ptr(), w.data_ptr(), t.parent.data_ptr(), t.slot.data_ptr(), out.data_ptr())
        if x.dtype == torch.bfloat16:
            _build.launch("taseg_strided_up_mma", (), *ptrs, v_fine, c_in, c_out)
        else:
            _build.launch("taseg_strided_up", (), *ptrs, v_fine, c_in, c_out, DTYPE_CODES[x.dtype])
        return out
    v_coarse = t.starts.shape[0] - 1
    out = torch.empty((v_coarse, c_out), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), w.data_ptr(), t.parent.data_ptr(), t.slot.data_ptr(), t.perm.data_ptr(),
            t.starts.data_ptr(), out.data_ptr())
    if x.dtype == torch.bfloat16:
        _build.launch("taseg_strided_down_mma", (), *ptrs, v_coarse, c_in, c_out)
    else:
        _build.launch("taseg_strided_down", (), *ptrs, x.shape[0], v_coarse, c_in, c_out,
                      DTYPE_CODES[x.dtype])
    return out


def old_times(name: str, x, w, t, want, ref, dtype: str, rel: float):
    """(ms, max|err|) of `old_call` at one call, held to the route's
    tolerance against the plain version; (None, None) where the call has
    no old kernel (K2's f32 and ragged calls, ragged bf16 K3)."""
    import torch

    wide = x.shape[1] % 8 == 0 and w.shape[2] % 8 == 0
    if (name in ("strided_down", "strided_up") and (wide or x.dtype == torch.float32)) or (
            name == "sparse_conv_k3" and x.dtype == torch.bfloat16 and wide):
        err = check_close(f"{name} old kernel", old_call(name, x, w, t), want, ref, dtype, rel)
        return cuda_ms(lambda: old_call(name, x, w, t)), err
    return None, None


def old_k4(x, g, pairs):
    """K4's mma.sync tile over the same pair lists (the tile its wgmma
    route replaced; two launches where a list splits), through its C
    entry, counted nowhere: the f32 (27, C_in, C_out) result."""
    from taseg_tpu_torch.ops import f3conv

    v = x.shape[0]
    return f3conv.launch_dw_mma("taseg_k3_conv_dw_mma", x, g, pairs, 27, v, 27 * v)


def old_k4_times(x, g, pairs, want, ref):
    """(ms, max|err|) of `old_k4` at one call, held to K4's tolerance."""
    err = check_close("k3_conv_dw old kernel", old_k4(x, g, pairs), want, ref, "float32", 1e-4)
    return cuda_ms(lambda: old_k4(x, g, pairs)), err


def old_dw_tf32(x, g, rb, lists):
    """K4 at K offsets on the mma.sync 3xTF32 tile that the wgmma tile
    replaced (`taseg_sparse_conv_dw_tf32_mma`, two launches where a list
    splits), counted nowhere: x (V_in, C_in), g (V_out, C_out) f32 padded
    to 4s as the wrapper pads them, over the same pair lists; the f32 (K,
    C_in, C_out) result at the logical widths."""
    import torch

    from taseg_tpu_torch.ops import f3conv
    from taseg_tpu_torch.ops.sparse_conv import pad_cols, padded_width

    k, v_in = rb.shape
    lists = f3conv.pair_lists(rb) if lists is None else lists
    ci, co = padded_width(torch.float32, x.shape[1]), padded_width(torch.float32, g.shape[1])
    out = f3conv.launch_dw_mma("taseg_sparse_conv_dw_tf32_mma", pad_cols(x, ci), pad_cols(g, co), lists, k, v_in,
                               k * v_in, k)
    return out[:, : x.shape[1], : g.shape[1]]


def old_k5_tf32(x, y, t, up: bool):
    """K5 in f32 on the mma.sync 3xTF32 tile that the wgmma tile replaced
    (`strided_conv.strided_dw_tf32_mma`), counted nowhere, over the level's
    slot lists, at widths padded to 4s; the logical (8, C_in, C_out)."""
    import torch

    from taseg_tpu_torch.ops import strided_conv
    from taseg_tpu_torch.ops.sparse_conv import pad_cols, padded_width

    pairs = t.pairs if t.pairs is not None else strided_conv.slot_pair_lists(t)
    ci, co = padded_width(torch.float32, x.shape[1]), padded_width(torch.float32, y.shape[1])
    out = strided_conv.strided_dw_tf32_mma(pad_cols(x, ci), pad_cols(y, co), pairs, t.parent.shape[0], up)
    return out[:, : x.shape[1], : y.shape[1]]


def old_tf32_dw_times(label: str, old, want, ref) -> dict:
    """The mma.sync 3xTF32 weight-gradient tile at one call (`old`: its
    call, `old_dw_tf32` or `old_k5_tf32`): held to the wgmma tile's gate
    (1e-4 of the largest sum of |terms|), its time (`old_ms`) and its
    device time (`old_device_ms`, the profiler)."""
    err = check_close(f"{label} mma.sync tile", old(), want, ref, "float32", 1e-4)
    return {"old_ms": cuda_ms(old), "old_device_ms": device_ms(old, OLD_DW_KERNELS, iters=5),
            "old_max_abs_err": err}


def tile_stats(name: str, table, c_in: int, c_out: int, ms: float, pairs: int) -> dict:
    """The wgmma route's plan of one bf16 call: tile work over present
    pairs over the order (`tile`) and before (`before`: the mma.sync K2
    and K3-up tiles in table order; the K3-down round tile, 8 slots x 64
    rows in every tile with a child), resident blocks per SM, grid blocks
    per SM, and the rates of the present-pair and of the tile work
    (TFLOP/s)."""
    import torch

    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops.sparse_conv import padded_width, tile_work, wgmma_splits

    c_in_p, c_out_p = padded_width(torch.bfloat16, c_in), padded_width(torch.bfloat16, c_out)
    if name == "sparse_conv_k3":
        rb, order = table.rb, table.order
        before = tile_work(rb)
    elif name == "strided_up":
        rb, order = table.up, table.up_order
        before = tile_work(rb)
    else:
        rb, order = table.child[0], table.child_order
        v = rb.shape[1]
        live = torch.nn.functional.pad((rb >= 0).any(0).to(torch.int8), (0, (-v) % 64))
        before = 8 * 64 * int(live.reshape(-1, 64).amax(1).sum())
    work = tile_work(rb, order)
    v_out, k = rb.shape[1], rb.shape[0]
    splits = wgmma_splits(v_out, k, c_in_p)
    grid = -(-v_out // 64) * max(1, -(-c_out_p // 256)) * splits
    return {
        "tile": work / max(pairs, 1), "before": before / max(pairs, 1),
        "resident_per_sm": _build.wgmma_blocks_per_sm(c_in_p, c_out_p, k),
        "grid_per_sm": grid / 132, "splits": splits,
        "tflops": 2.0 * pairs * c_in * c_out / ms / 1e9,
        "tile_tflops": 2.0 * work * c_in * c_out / ms / 1e9,
    }


def fmt_tiles(s: dict) -> str:
    return (
        f"tile work {s['tile']:.2f}x present pairs ({s['before']:.2f}x before), "
        f"{s['resident_per_sm']} blocks/SM resident, grid {s['grid_per_sm']:.2f}/SM "
        f"({s['splits']} parts), {s['tflops']:.1f} TFLOP/s present, {s['tile_tflops']:.1f} tile"
    )


def phase_join_scan(topo, results: dict, probes: list) -> None:
    """K1 on the 5 levels' unions of the real topology; both modes
    bit-exact against the plain (cummax) version on the card.  Each
    level's call goes into `probes` (as a function that makes it) for its
    device time."""
    import torch

    from taseg_tpu_torch.ops.join_scan import join_scan, join_scan_plain

    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for l in range(len(topo.levels)):
        call = k1_call(topo, l)
        shi, slo2, srow, num, v, qsent, _ = call.args
        n = shi.shape[0]
        for mode in (0, 1):
            got = join_scan(shi, slo2, srow, num, v, qsent, mode)
            want = join_scan_plain(shi, slo2, srow, num, v, qsent, mode)
            if not torch.equal(got, want):
                bad = (got != want).sum().item()
                raise AssertionError(f"join_scan level {l} mode {mode}: {bad} rows differ")
        ms = cuda_ms(call)
        probes.append(("join_scan", f"K1 join_scan level {l}", partial(k1_call, topo, l)))
        plain = cuda_ms(lambda: join_scan_plain(shi, slo2, srow, num, v, qsent, 1))
        # library yardstick: the three cummax calls of the plain version
        # on its masked arrays
        pos = torch.arange(n, dtype=torch.int32, device=shi.device)
        differs = torch.ones(n, dtype=torch.bool, device=shi.device)
        differs[1:] = (shi[1:] != shi[:-1]) | ((slo2[1:] >> 1) != (slo2[:-1] >> 1))
        masked = (
            torch.where(differs, pos, -1),
            torch.where(srow < v, pos, -1),
            torch.where((srow < v) & (srow < num), srow, -1),
        )
        lib = cuda_ms(lambda: [torch.cummax(x, 0) for x in masked])
        b, _ = bound_ms(16.0 * n, 0.0, "float32")  # 3 int32 in, 1 out
        log(
            f"K1 join_scan level {l}: n={n} bit-exact (modes 0,1) "
            f"kernel {ms:.4f} ms plain {plain:.4f} ms "
            f"cummax x3 {lib:.4f} ms bound {b:.4f} ms"
        )
        for k, x in (("ms", ms), ("plain_ms", plain), ("bound_ms", b), ("library_ms", lib)):
            tot[k] += x
    results["join_scan"] = dict(tot, max_abs_err=0.0, bound_by="bytes")


def phase_convs(cap: Capture, results: dict, probes: list) -> None:
    """K2 and K3 on every distinct shape of the path, bf16 (the path's
    dtype) and f32; per-scan totals weight each shape by its count.  K2
    and K3 read the level's row order and child or up table as the path
    does.  Beside each bf16 time: the kernel the route replaced
    (`old_ms`: the mma.sync K2 tile, the K3-down round tile, the K3-up
    tile, through their C entries, held to the same tolerance), the wgmma route's plan (tile
    work over present pairs, blocks per SM, TFLOP/s), and per level of K2
    the sums over its shapes.  The bf16 K3-down calls go into `probes`
    for their device time."""
    import torch

    from taseg_tpu_torch.ops import sparse_conv, strided_conv

    kernels = {
        "sparse_conv_k3": (sparse_conv.sparse_conv_k3, sparse_conv.sparse_conv_plain, 1e-5),
        # the plain down path sums with a mean-centred cumsum
        "strided_down": (strided_conv.downsample_conv_apply, strided_conv.downsample_conv_plain, 1e-4),
        "strided_up": (strided_conv.upsample_conv_apply, strided_conv.upsample_conv_plain, 1e-5),
    }
    for name in kernels:
        results[name] = {
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
            "library_ms": 0.0, "_bound_parts": [0.0, 0.0],
        }
        results[name]["old_ms"] = 0.0
    levels: dict = {}  # K2 by level rows: ms, old, library, present and tile operations
    for key, (feats, w32, table, _, _) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name, rows, c_in, c_out = key
        kern, plain, rel = kernels[name]
        count = cap.count[key]
        arg = table.rb if name == "sparse_conv_k3" else table
        kw = {"order": table.order} if name == "sparse_conv_k3" else {}
        for dtype, tdt in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
            x = feats.to(tdt).contiguous()
            w = w32.to(tdt).contiguous()
            got = kern(x, w, arg, **kw)
            want = plain(x, w, arg)
            ref_abs = plain(x.abs(), w.abs(), arg)
            err = check_close(f"{name} {key[1:]} {dtype}", got, want, ref_abs, dtype, rel)
            if name == "sparse_conv_k3":
                route = sparse_conv.route(tdt, c_in, c_out)
            elif name == "strided_down":
                route = strided_conv.downsample_route(tdt, c_in, c_out, table.child.shape[0])
            else:
                route = strided_conv.upsample_route(tdt, c_in, c_out)
            if dtype != "bfloat16":
                log(f"  {name} rows={rows} {c_in}->{c_out} f32 route {route} max|err| {err:.3e}")
                continue
            ms = cuda_ms(lambda: kern(x, w, arg, **kw))
            old, old_err = old_times(name, x, w, arg, want, ref_abs, dtype, rel)
            if name == "strided_down":
                probes.append((
                    name, f"{name} rows={rows} {c_in}->{c_out}",
                    partial(down_call, kern, rows, c_in, w, table),
                ))
            pms = cuda_ms(lambda: plain(x, w, arg), iters=3)
            esz = x.element_size()
            if name == "sparse_conv_k3":
                pairs = int((arg >= 0).sum().item())
                nbytes = rows * c_in * esz + w.numel() * esz + arg.numel() * 4 + rows * c_out * esz
            else:
                fine = int((table.parent >= 0).sum().item())
                pairs = fine
                out_rows = table.starts.shape[0] - 1 if name == "strided_down" else table.parent.shape[0]
                nbytes = (
                    rows * c_in * esz + w.numel() * esz
                    + 4 * (3 * table.parent.shape[0] + table.starts.shape[0])
                    + out_rows * c_out * esz
                )
            ops = 2.0 * pairs * c_in * c_out
            b, by = bound_ms(nbytes, ops, dtype)
            lib = conv_library_ms(name, x, w, arg)
            plan = tile_stats(name, table, c_in, c_out, ms, pairs) if route == "wgmma" else None
            log(
                f"{name} rows={rows} {c_in}->{c_out} x{count}/scan bf16 route {route} "
                f"max|err| {err:.3e} kernel {ms:.4f} ms"
                + ("" if old is None else f" old {old:.4f} ms (max|err| {old_err:.3e})")
                + f" plain {pms:.4f} ms bound {b:.4f} ms ({by}) one torch.mm {lib:.4f} ms"
                + f" pairs={pairs}" + ("" if plan is None else "; " + fmt_tiles(plan))
                + (" SLOWER than torch.mm" if ms > lib else "")
            )
            r = results[name]
            r["library_ms"] += count * lib
            r["ms"] += count * ms
            r["plain_ms"] += count * pms
            r["bound_ms"] += count * b
            r["_bound_parts"][0 if by == "bytes" else 1] += count * b
            r["max_abs_err"] = max(r["max_abs_err"], err)
            if old is not None:
                r["old_ms"] += count * old
            if name == "sparse_conv_k3" and plan is not None:
                lv = levels.setdefault(rows, [0.0, 0.0, 0.0, 0.0, 0.0, 0])
                for i, val in enumerate((ms, old or 0.0, lib, ops, ops * plan["tile"] if pairs else 0.0)):
                    lv[i] += count * val
                lv[5] += count
    for rows, (ms, old, lib, ops, tile_ops, n) in sorted(levels.items(), key=lambda kv: -kv[0]):
        log(
            f"K2 wgmma level of {rows} rows ({n} calls/scan): kernel {ms:.4f} ms old {old:.4f} ms "
            f"one torch.mm {lib:.4f} ms, {ops / ms / 1e9:.1f} TFLOP/s present, "
            f"{tile_ops / ms / 1e9:.1f} TFLOP/s tile (tile work {tile_ops / max(ops, 1):.2f}x)"
        )
    for name in kernels:
        r = results[name]
        parts = r.pop("_bound_parts")
        r["bound_by"] = "bytes" if parts[0] >= parts[1] else "operations"


def check_child_rounds(topo) -> None:
    """The host pipeline's coordinates are non-negative, so every coarse
    cell has at most one child per slot: the topology's child tables
    (built with one round and nothing read back) take one round at every
    level of the path, equal to the tables whose rounds are counted."""
    import torch

    from taseg_tpu_torch.ops.strided_conv import slot_child_table

    rounds = [slot_child_table(lt.strided).shape[0] for lt in topo.levels[1:]]
    log(f"K3-down child rounds per level 1-4: {rounds}")
    if rounds != [1] * len(rounds):
        raise AssertionError(f"expected one child round per level, got {rounds}")
    for l, lt in enumerate(topo.levels[1:], 1):
        if not torch.equal(lt.strided.child, slot_child_table(lt.strided)):
            raise AssertionError(f"level {l}: the topology's child table differs from the counted one")


def topology_cost(seg, arrays) -> None:
    """What the wgmma routes add to the serving topology: the child table
    and the up table of each level (one scatter and one elementwise op,
    nothing read back) and the row orders of the levels' 3^3 rulebooks,
    child tables and up tables (one batched sort per level size), each
    timed on its own at the real topology's tables (CUDA events, host
    cost included) beside the whole stage; the up tables' share (their
    build and what they add to the sorts) apart."""
    from taseg_tpu_torch.ops.sparse_conv import mask_row_orders
    from taseg_tpu_torch.ops.strided_conv import slot_child_table, slot_up_table

    topo = seg.topology(arrays)
    lv = topo.levels
    child = cuda_ms(lambda: [slot_child_table(l.strided, rounds=1) for l in lv[1:]])
    up = cuda_ms(lambda: [slot_up_table(l.strided) for l in lv[1:]])
    tables = [l.rb_k3 for l in lv] + [l.strided.child[0] for l in lv[1:]]
    orders = cuda_ms(lambda: mask_row_orders(tables + [l.strided.up for l in lv[1:]]))
    no_up = cuda_ms(lambda: mask_row_orders(tables))
    k3_only = cuda_ms(lambda: mask_row_orders([l.rb_k3 for l in lv]))
    whole = cuda_ms(lambda: seg.topology(arrays))
    log(
        f"topology {whole:.3f} ms per scan; of it the child tables {child:.3f} ms, the up tables "
        f"{up:.3f} ms and the row orders {orders:.3f} ms (without the up tables' {no_up:.3f} ms, "
        f"the 3^3 tables' alone {k3_only:.3f} ms): {child + up + orders:.3f} ms added by the wgmma "
        f"routes, {up + orders - no_up:.3f} ms of it by the up tables"
    )


def phase_profile(seg, scans, results: dict, calls: dict, probes: list) -> None:
    """Device time per scan of each kernel on the main path (topology +
    forward), from torch.profiler's device events as
    tools/profile_port.py sums them; K1 must launch one kernel per call
    (`calls`: wrapper calls per scan).  Then the device time per call of
    each of `probes` (K1 per level, K3-down per shape; each makes its call
    only now, so that its inputs do not stay on the card through the
    throughput samples).  Runs after those samples: a profiler session
    before them slowed the launch-bound topology stage by 4-6 ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = [seg.collate([s]) for s in scans]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for a in batches:
            seg.forward(a, seg.topology(a))
        torch.cuda.synchronize()
    n = len(batches)
    dev = {k: [0.0, 0] for k in KERNEL_NAMES}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU:
            continue
        for k, frags in KERNEL_NAMES.items():
            if named(e.key, frags) and e.self_device_time_total > 0:
                dev[k][0] += e.self_device_time_total / 1e3 / n
                dev[k][1] += e.count
    for k, (ms, count) in dev.items():
        per_call = count / (n * calls[k]) if calls[k] else 0.0
        log(
            f"profiler {k}: {ms:.4f} ms per scan on the device, "
            f"{count / n:g} kernel launches per scan, {per_call:g} per wrapper call"
        )
        if calls[k] or count:  # a kernel off the main path keeps its own phase's device time
            results.setdefault(k, {})["device_ms"] = ms if count else None
    k1_count = dev["join_scan"][1]
    if k1_count and k1_count != n * calls["join_scan"]:
        raise AssertionError(
            f"K1: {k1_count} kernel launches for {n * calls['join_scan']} calls"
        )
    results["join_scan"]["kernel_launches_per_call"] = 1 if k1_count else None
    if not k1_count:
        log("profiler: no device events for K1 (launches per call not measured)")
    for name, label, make in probes:
        log(f"profiler {label}: device {fmt_ms(device_ms(make(), KERNEL_NAMES[name]))} per call")


def phase_point_ops(seg, arrays, topo, k: int, results: dict, probes: list) -> None:
    """voxelize_avg (K6's segment sum, then the mean) and the head's
    three devoxelize calls (K7, held bit-identical to its plain version)
    on the main path's tables: time per scan, bound (bytes: each input
    read once, the output written once) and, where one PyTorch call
    computes the same function, that call's time.  The head devoxelizes
    (V, k) bf16 rows (k classes).  Each K7 call goes into `probes` for
    its device time."""
    import torch

    from taseg_tpu_torch.ops import voxelize as vx

    feats = arrays["point_feats_t"][:, : seg.model.in_dim].contiguous()
    inv, tables = topo.point_inverse, topo.point_tables
    v, (p, c) = tables.counts.shape[0], feats.shape
    want = vx.voxelize_avg(feats, inv, tables)
    ms = cuda_ms(lambda: vx.voxelize_avg(feats, inv, tables))
    # row v takes the dropped points; include_self=False leaves rows
    # without points at 0
    idx = torch.where(inv >= 0, inv, v).long()[:, None].expand(p, c).contiguous()
    buf = torch.zeros(v + 1, c, device=feats.device)
    lib = cuda_ms(lambda: buf.scatter_reduce_(0, idx, feats, "mean", include_self=False))
    # the plain version's mean-centred f32 cumsum rounds by up to ~2e-4
    # of the feature scale over 131 072 points
    err = (buf[:v] - want).abs().max().item()
    if not err <= 1e-3 * max(1.0, want.abs().max().item()):
        raise AssertionError(f"scatter_reduce mean differs from voxelize_avg by {err:.3e}")
    b, _ = bound_ms(p * c * 4 + p * 4 + v * c * 4, 0.0, "float32")
    log(
        f"voxelize_avg (K6 segment sum + mean) P={p} V={v} C={c} x1/scan: {ms:.4f} ms, "
        f"scatter_reduce_ mean {lib:.4f} ms, bound {b:.4f} ms (bytes)"
    )

    gen = torch.Generator(device=feats.device).manual_seed(SEED)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}
    for s in (1, 4, 16):
        tab = topo.devox[s]
        lvl = topo.levels[s.bit_length() - 1]
        z = torch.randn(lvl.coords.shape[0], k, device=feats.device, generator=gen)
        z = z.to(torch.bfloat16)
        ms, pms, lib, lib_err, pts = devox_times(z, tab)
        corners = 1 if s == 1 else 8
        b, _ = bound_ms(corners * pts * (4 if s == 1 else 8) + z.numel() * 2 + pts * k * 2, 0.0, "float32")
        yardstick = "index_select" if s == 1 else "embedding_bag"
        log(
            f"K7 devoxelize {'identity' if s == 1 else 'trilinear'} stride {s} P={pts} "
            f"V={z.shape[0]} C={k} x1/scan: bit-identical, kernel {ms:.4f} ms plain {pms:.4f} ms "
            f"{yardstick} {lib:.4f} ms (max|diff| {lib_err:.3e}) bound {b:.4f} ms (bytes)"
        )
        for key, x in (("ms", ms), ("plain_ms", pms), ("bound_ms", b), ("library_ms", lib)):
            tot[key] += x
        probes.append(("devoxelize", f"K7 devoxelize stride {s}", partial(devox_call, topo, s, k)))
    results["devoxelize"] = dict(tot, bound_by="bytes")
    phase_multi(topo, k, results, probes)


def multi_check(feats, tables, bias) -> None:
    """K7's multi-scale entry: the same bits as its plain version (signed
    zeros included) and on a repeat call."""
    from taseg_tpu_torch.ops import voxelize as vx

    got = twice_same("K7 devoxelize_multi", lambda: vx.devoxelize_multi_kernel(feats, tables, bias))
    if not bits(got).equal(bits(vx.devox_multi_plain(feats, tables, bias))):
        bad = (bits(got) != bits(vx.devox_multi_plain(feats, tables, bias))).sum().item()
        raise AssertionError(f"K7 devoxelize_multi: {bad} values differ from the plain version")


def multi_bytes(feats, tables, bias) -> int:
    """Bytes of one multi-scale call: each scale's table read once, each
    row its table references read once, the output written once."""
    import torch

    from taseg_tpu_torch.ops import voxelize as vx

    p = vx._table_points(tables[0])
    n = 0
    for x, t in zip(feats, tables):
        identity = isinstance(t, vx.IdentityDevoxTable)
        idx = t.inverse if identity else t.idx
        n += p * (4 if identity else 8 * t.idx.shape[0])
        n += int(torch.unique(idx[idx >= 0]).numel()) * x.shape[1] * x.element_size()
    c = feats[0].shape[1] if bias is not None else sum(x.shape[1] for x in feats)
    return n + p * c * (4 if bias is not None else feats[0].element_size())


def multi_call(topo, k: int):
    """The head's multi-scale call of the main path on seeded random (V_s,
    k) bf16 rows and bias."""
    import torch

    from taseg_tpu_torch.models.voxel.backbone_context import head_tables
    from taseg_tpu_torch.ops import voxelize as vx

    gen = torch.Generator(device=topo.bounds.origin.device).manual_seed(SEED)
    zs = [torch.randn(t.shape[0], k, device=gen.device, generator=gen).to(torch.bfloat16)
          for t in (topo.levels[4].coords, topo.levels[2].coords, topo.levels[0].coords)]
    bias = torch.randn(k, device=gen.device, generator=gen)
    return partial(vx.devoxelize_multi_kernel, zs, head_tables(topo.devox), bias)


def phase_multi(topo, k: int, results: dict, probes: list) -> None:
    """K7's multi-scale entry at the head's real tables: the sum (the head:
    one launch for the three scales, their f32 casts summed and the bias)
    and the cat at KD's feature widths (256 / 128 / 96 bf16), each the
    same bits as its plain version and on repeat; the sum's time beside
    the sequence it replaced (three single K7 calls, three f32 casts, two
    adds and the bias, `old_ms`), its plain version and its bound (no
    single PyTorch call computes it: `library_ms` null)."""
    import torch

    from taseg_tpu_torch.ops import voxelize as vx

    fn = multi_call(topo, k)
    zs, tables, bias = fn.args
    multi_check(zs, tables, bias)

    def sequence():
        out = None
        for z, t in zip(zs, tables):
            c = vx.devoxelize(z, t).float()
            out = c if out is None else out + c
        return out + bias

    if not bits(sequence()).equal(bits(fn())):
        raise AssertionError("K7 devoxelize_multi: differs from the head's three calls and adds")
    ms, pms = cuda_ms(fn), cuda_ms(lambda: vx.devox_multi_plain(zs, tables, bias))
    old = cuda_ms(sequence)
    b, by = bound_ms(multi_bytes(zs, tables, bias), 0.0, "float32")
    log(
        f"K7 devoxelize_multi sum (the head, strides 16 / 4 / 1, C={k} bf16 -> f32) P="
        f"{vx._table_points(tables[0])} x1/scan: bit-identical (and on repeat, and to the three "
        f"calls and adds), kernel {ms:.4f} ms plain {pms:.4f} ms, the three calls + f32 glue "
        f"{old:.4f} ms, bound {b:.4f} ms ({by})"
    )
    results["devoxelize_multi"] = {
        "ms": ms, "plain_ms": pms, "bound_ms": b, "bound_by": by, "library_ms": None,
        "max_abs_err": 0.0, "old_ms": old,
    }
    probes.append(("devoxelize_multi", "K7 devoxelize_multi (the head)", partial(multi_call, topo, k)))
    gen = torch.Generator(device=zs[0].device).manual_seed(SEED + 1)
    xs = [torch.randn(z.shape[0], c, device=zs[0].device, generator=gen).to(torch.bfloat16)
          for z, c in zip(zs, (256, 128, 96))]
    multi_check(xs, tables, None)
    cat = lambda: torch.cat([vx.devoxelize(x, t) for x, t in zip(xs, tables)], dim=-1)
    if not bits(cat()).equal(bits(vx.devoxelize_multi_kernel(xs, tables))):
        raise AssertionError("K7 devoxelize_multi: the cat differs from torch.cat of the three calls")
    cb, _ = bound_ms(multi_bytes(xs, tables, None), 0.0, "float32")
    log(
        f"K7 devoxelize_multi cat (KD's features, C = 256 / 128 / 96 bf16): bit-identical (and "
        f"on repeat, and to torch.cat of the three calls), kernel "
        f"{cuda_ms(lambda: vx.devoxelize_multi_kernel(xs, tables)):.4f} ms, three calls + cat "
        f"{cuda_ms(cat):.4f} ms, bound {cb:.4f} ms (bytes)"
    )


def devox_call(topo, s: int, k: int):
    """K7's call at head stride `s` of the main path, on seeded random
    (V, k) bf16 rows (its time does not depend on their values)."""
    import torch

    from taseg_tpu_torch.ops import voxelize as vx

    rows = topo.levels[s.bit_length() - 1].coords.shape[0]
    gen = torch.Generator(device=topo.bounds.origin.device).manual_seed(SEED)
    z = torch.randn(rows, k, device=gen.device, generator=gen).to(torch.bfloat16)
    return partial(vx.devoxelize, z, topo.devox[s])


def bits(t):
    """The raw bits of a f32 or bf16 tensor (tells -0 from +0)."""
    import torch

    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def devox_check(z, table) -> None:
    """K7 on (V, C) rows `z` and a head table: the same bits as the plain
    version."""
    from taseg_tpu_torch.ops import voxelize as vx

    if isinstance(table, vx.IdentityDevoxTable):
        got, want = vx.devoxelize_identity(z, table.inverse), vx._devox_identity(z, table.inverse)
    else:
        got, want = vx.devoxelize_trilinear(z, table), vx._devox_trilinear(z, table)
    if not bits(got).equal(bits(want)):
        bad = (bits(got) != bits(want)).sum().item()
        raise AssertionError(f"K7 devoxelize: {bad} values differ from the plain version")


def devox_times(z, table):
    """K7 against its plain version on one head call: (kernel ms, plain
    ms, library ms, library max |diff|, points).  The library call is
    `index_select` for the identity (exact) and `F.embedding_bag` (sum
    with per-sample weights) for the trilinear, both over a zero row
    appended for absent corners; embedding_bag sums in f32 and rounds
    once, where K7 rounds each of its 15 products and sums to bf16, so
    it is held within 2^-5 of the largest sum of |terms|."""
    import torch
    import torch.nn.functional as F

    from taseg_tpu_torch.ops import voxelize as vx

    devox_check(z, table)
    k = z.shape[1]
    zpad = torch.cat([z, z.new_zeros(1, k)])
    ms = cuda_ms(lambda: vx.devoxelize(z, table))
    if isinstance(table, vx.IdentityDevoxTable):
        inv = table.inverse
        pms = cuda_ms(lambda: vx._devox_identity(z, inv))
        gidx = torch.where(inv >= 0, inv, z.shape[0]).long()
        lib = cuda_ms(lambda: torch.index_select(zpad, 0, gidx))
        if not bits(torch.index_select(zpad, 0, gidx)).equal(bits(vx._devox_identity(z, inv))):
            raise AssertionError("index_select differs from the identity devoxelize")
        return ms, pms, lib, 0.0, inv.shape[0]
    pms = cuda_ms(lambda: vx._devox_trilinear(z, table))
    eidx = torch.where(table.idx >= 0, table.idx, z.shape[0]).t().contiguous()
    ew = table.weights.t().contiguous().to(z.dtype)
    lib = cuda_ms(lambda: F.embedding_bag(eidx, zpad, per_sample_weights=ew, mode="sum"))
    want = vx._devox_trilinear(z, table).float()
    err = (F.embedding_bag(eidx, zpad, per_sample_weights=ew, mode="sum").float() - want).abs().max().item()
    ref = F.embedding_bag(eidx, zpad.float().abs(), per_sample_weights=ew.float().abs(), mode="sum")
    if not err <= 2.0**-5 * ref.max().item():
        raise AssertionError(f"embedding_bag differs from the trilinear devoxelize by {err:.3e}")
    return ms, pms, lib, err, table.idx.shape[1]


def _kept(a):
    """A captured argument as the call saw it: a view (the backward's W^T,
    a view of a parameter that the step's optimizer then updates in place)
    is cloned at its strides; any other argument is kept as it is."""
    import torch

    return a.detach().clone() if isinstance(a, torch.Tensor) and a._is_view() else a


class CallCapture:
    """Wraps module-level functions for one train step: the first call of
    each distinct key (from `key_fn` of the call's arguments; None skips
    the call) is kept with its arguments (a view cloned: `_kept`), and
    every key is counted."""

    def __init__(self):
        self.seen: dict = {}
        self.count: dict = {}
        self._restore = []

    def patch(self, module, name, key_fn):
        orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            key = key_fn(*args, **kwargs)
            if key is not None:
                self.count[key] = self.count.get(key, 0) + 1
                if key not in self.seen:
                    self.seen[key] = (tuple(_kept(a) for a in args), {k: _kept(v) for k, v in kwargs.items()})
            return orig(*args, **kwargs)

        setattr(module, name, wrapper)
        self._restore.append((module, name, orig))

    def remove(self):
        for module, name, orig in self._restore:
            setattr(module, name, orig)
        self._restore.clear()

    @staticmethod
    def only(cap: "CallCapture", keep) -> "CallCapture":
        """A copy of `cap` with the keys for which `keep(key)` holds."""
        out = CallCapture()
        out.seen = {k: v for k, v in cap.seen.items() if keep(k)}
        out.count = {k: cap.count[k] for k in out.seen}
        return out


def capture_train_calls(trainer, scans) -> CallCapture:
    """One real train step with the backward kernels' wrappers wrapped:
    the inputs of K4, K5, K6, of the input-gradient calls of K2 and K3
    and of the forward's K7 calls at every shape the step gives them."""
    from taseg_tpu_torch.ops import f3conv, strided_conv, voxelize

    cap = CallCapture()
    cap.patch(
        f3conv, "k3_conv_dw",
        lambda f, g, rb, out_dtype=None, pairs=None: ("k3_conv_dw", *f.shape, g.shape[1]),
    )
    cap.patch(
        strided_conv, "strided_dw",
        lambda x, y, t, up, out_dtype=None: (
            "strided_dw", "up" if up else "down", t.parent.shape[0], x.shape[1], y.shape[1]
        ),
    )
    cap.patch(
        voxelize, "segment_sum",
        lambda src, t, w=None: (
            "segment_sum", t.perm.shape[0] - t.starts.shape[0] + 1, t.starts.shape[0] - 1,
            src.shape[1], w is not None, src.shape[0],
        ),
    )
    cap.patch(
        f3conv, "sparse_conv_k3",
        lambda x, w, rb, dgrad=False, order=None: (
            ("sparse_conv_k3", *x.shape, w.shape[2]) if dgrad else None),
    )
    for name in ("downsample_conv_apply", "upsample_conv_apply"):
        kind = "strided_down" if name.startswith("down") else "strided_up"
        cap.patch(
            strided_conv, name,
            lambda x, w, t, dgrad=False, kind=kind: (kind, *x.shape, w.shape[2]) if dgrad else None,
        )
    cap.patch(
        voxelize, "devoxelize_trilinear",
        lambda v, t: ("devoxelize", "trilinear", t.idx.shape[1], *v.shape),
    )
    cap.patch(
        voxelize, "devoxelize_identity",
        lambda v, inv: ("devoxelize", "identity", inv.shape[0], *v.shape),
    )
    cap.patch(voxelize, "devoxelize_multi_kernel", multi_key)
    trainer.step(scans)
    cap.remove()
    return cap


def multi_key(feats, tables, bias=None, ptr: bool = False) -> tuple:
    """The capture key of one call of K7's multi-scale entry: its
    epilogue, points and widths (with `ptr`, its first table's address)."""
    from taseg_tpu_torch.ops import voxelize as vx

    key = ("devoxelize_multi", "sum" if bias is not None else "cat",
           vx._table_points(tables[0]), tuple(x.shape[1] for x in feats))
    if ptr:
        t = tables[0]
        key += ((t.inverse if isinstance(t, vx.IdentityDevoxTable) else t.idx).data_ptr(),)
    return key


def twice_same(name, fn):
    """fn() twice on the same inputs: the results must be bit-identical."""
    import torch

    a, b = fn(), fn()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two calls on the same inputs differ")
    return a


def phase_train_kernels(cap: CallCapture, results: dict) -> None:
    """K4, K5, K6 and the input-gradient calls of K2 and K3 at every
    shape of one bf16 train step, against their plain versions, bit-
    identical on repeat (K7's forward calls bit-identical to its plain
    version); each kernel also once in f32 (K2 and K3: every
    shape in f32, their CUDA-core route).  Per-step totals weight each
    shape by its count in the step.  K4 and K5 sum up to all V rows in
    f32 in another order than the plain matmuls: 1e-4 of the largest sum
    of |terms|; K6 (against its plain version in f64) and the K2/K3 input
    gradients 1e-5 (K3-down 1e-4: its plain version sums by a
    mean-centred cumsum).  K4 in bf16 reads the level's pair lists as the
    step passed them, and must give the same bits when its wrapper builds
    them itself; its f32 call takes the CUDA-core route; K5 likewise
    over the level's per-slot pair lists.  Beside the bf16 K4 and K3-up
    calls stands the tile their wgmma route replaced (`old_ms`, through
    its C entry, held to the same tolerance).  Each K6 call is
    named by its place in the step, so the stride-16 call shows."""
    import torch

    from taseg_tpu_torch.ops import f3conv, sparse_conv, strided_conv, voxelize

    def k4(a, kw, x, g):
        rb, pairs = a[2], kw.get("pairs")
        if x.dtype == torch.bfloat16 and pairs is None:
            raise AssertionError("K4 was called without the level's pair lists")
        return (
            lambda: f3conv.k3_conv_dw(x, g, rb, pairs=pairs),
            lambda: f3conv.k3_conv_dw_plain(x, g, rb),
            lambda: f3conv.k3_conv_dw_plain(x.abs(), g.abs(), rb),
        )

    def k5(a, kw, x, y):
        t, up = a[2], (a[3] if len(a) > 3 else kw["up"])
        return (
            lambda: strided_conv.strided_dw(x, y, t, up),
            lambda: strided_conv.strided_dw_plain(x, y, t, up),
            lambda: strided_conv.strided_dw_plain(x.abs(), y.abs(), t, up),
        )

    def k6(a, kw, x, _):
        # held against the plain version in f64: the f32 cumsum's rounding
        # over ~10^6 rows is above K6's own error at these small sums
        t, w = a[1], (a[2] if len(a) > 2 else kw.get("weights"))
        w64 = None if w is None else w.double()
        return (
            lambda: voxelize.segment_sum(x, t, w),
            lambda: voxelize.segment_sum_plain(x.double(), t, w64),
            lambda: voxelize.segment_sum_plain(x.double().abs(), t, None if w is None else w64.abs()),
            lambda: voxelize.segment_sum_plain(x, t, w),
        )

    def dgrad(kern, plain):
        def make(a, kw, x, w):
            # the call as the step made it: K2 over the level's order
            t, more = a[2], {k: v for k, v in kw.items() if k != "dgrad"}
            return (
                lambda: kern(x, w, t, dgrad=True, **more),
                lambda: plain(x, w, t),
                lambda: plain(x.abs(), w.abs(), t),
            )
        return make

    makers = {
        "k3_conv_dw": (k4, 1e-4),
        "strided_dw": (k5, 1e-4),
        "segment_sum": (k6, 1e-5),
        "sparse_conv_k3": (dgrad(sparse_conv.sparse_conv_k3, sparse_conv.sparse_conv_plain), 1e-5),
        "strided_down": (dgrad(strided_conv.downsample_conv_apply, strided_conv.downsample_conv_plain), 1e-4),
        "strided_up": (dgrad(strided_conv.upsample_conv_apply, strided_conv.upsample_conv_plain), 1e-5),
    }
    routes = {
        "sparse_conv_k3": sparse_conv.route,
        "strided_down": strided_conv.downsample_route,
        "strided_up": strided_conv.upsample_route,
    }
    tot = {
        k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
            "library_ms": 0.0, "_parts": [0.0, 0.0], "f32_checked": False,
            **({"old_ms": 0.0} if k in ("sparse_conv_k3", "strided_down", "strided_up", "k3_conv_dw") else {})}
        for k in makers
    }
    for key in sorted((k for k in cap.seen if k[0] == "devoxelize"), key=str):
        (v, t), _ = cap.seen.pop(key)
        table = t if key[1] == "trilinear" else voxelize.IdentityDevoxTable(inverse=t)
        devox_check(v, table)
        log(f"devoxelize {key[1:]} x{cap.count[key]}/step (train forward): bit-identical to the plain version")
    for key in sorted((k for k in cap.seen if k[0] == "devoxelize_multi"), key=str):
        a, kw = cap.seen.pop(key)
        feats = [x.detach() for x in a[0]]
        bias = kw.get("bias", a[2] if len(a) > 2 else None)
        multi_check(feats, a[1], None if bias is None else bias.detach())
        log(f"devoxelize_multi {key[1:]} x{cap.count[key]}/step (train forward): bit-identical to "
            f"the plain version and on repeat")
    k6_names = k6_call_names([k for k in cap.seen if k[0] == "segment_sum"])
    for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name = key[0]
        make, rel = makers[name]
        count = cap.count[key]
        r = tot[name]
        x, second = a[0], a[1]
        f32_cases = name in routes or not r["f32_checked"]
        for dtype in ("bfloat16", "float32") if f32_cases else ("bfloat16",):
            tdt = getattr(torch, dtype)
            xd = x.to(tdt).contiguous()
            sd = second.to(tdt).contiguous() if name != "segment_sum" else None
            kern, want, ref, *timed = make(a, kw, xd, sd)
            plain = timed[0] if timed else want
            got = twice_same(f"{key} {dtype}", kern)
            err = check_close(f"{key} {dtype}", got, want(), ref(), "float32" if name in ("k3_conv_dw", "strided_dw", "segment_sum") else dtype, rel)
            label = f"{name} {key[1:]} x{count}/step {dtype}"
            if name == "segment_sum":
                label = f"{name} ({k6_names[key]}) {key[1:]} x{count}/step {dtype}"
            if name == "strided_down":
                label += f" route {routes[name](tdt, x.shape[1], second.shape[2], a[2].child.shape[0])}"
            elif name in routes:
                label += f" route {routes[name](tdt, x.shape[1], second.shape[2])}"
            if name == "k3_conv_dw":
                route = f3conv.dw_route(tdt, x.shape[1], second.shape[1])
                label += f" route {route}"
                if route == "wgmma" and not torch.equal(f3conv.k3_conv_dw(xd, sd, a[2]), got):
                    raise AssertionError(f"{key}: K4 differs with pair lists built by the wrapper")
            if name == "strided_dw":
                route = f3conv.dw_route(tdt, x.shape[1], second.shape[1], strided=True)
                label += f" route {route}"
                t, up = a[2], (a[3] if len(a) > 3 else kw["up"])
                if route != "simt":
                    if t.pairs is None:
                        raise AssertionError("K5 was called without the level's pair lists")
                    bare = replace(t, pairs=None)
                    if not torch.equal(strided_conv.strided_dw(xd, sd, bare, up), got):
                        raise AssertionError(f"{key}: K5 differs with pair lists built by the wrapper")
            if dtype == "float32":
                r["f32_checked"] = True
                log(f"  {label} max|err| {err:.3e} (bit-identical on repeat)")
                continue
            ms = cuda_ms(kern)
            old = None
            if name in ("sparse_conv_k3", "strided_down", "strided_up"):
                old, old_err = old_times(name, xd, sd, a[2], want(), ref(), dtype, rel)
            elif name == "k3_conv_dw" and x.shape[1] % 8 == 0 and second.shape[1] % 8 == 0:
                # the mma.sync tile the wgmma one replaced takes widths in 8s
                old, old_err = old_k4_times(xd, sd, kw["pairs"], want(), ref())
            pms = cuda_ms(plain, iters=3)
            nbytes, ops, lib = train_cost(name, a, kw, xd, sd)
            b, by = bound_ms(nbytes, ops, dtype)
            dev = ""
            if name in ("strided_dw", "segment_sum"):
                dev, lib_dev = yardstick_devices(name, kern, a, kw, xd, sd)
                r["device_ms"] = msum(r.get("device_ms", 0.0), mscale(count, dev))
                r["library_device_ms"] = msum(r.get("library_device_ms", 0.0), mscale(count, lib_dev))
                dev = f" device {fmt_ms(dev)} (yardstick device {fmt_ms(lib_dev)})"
                if name == "segment_sum":
                    old_b, _ = bound_ms(k6_bytes(xd, a[1], a[2] if len(a) > 2 else kw.get("weights"))[1], ops, dtype)
                    dev += f" sentinel-inclusive bound {old_b:.4f} ms"
            log(
                f"{label} max|err| {err:.3e} kernel {ms:.4f} ms{dev}"
                + ("" if old is None else f" old {old:.4f} ms (max|err| {old_err:.3e})")
                + f" plain {pms:.4f} ms bound {b:.4f} ms ({by}) "
                + ("index_add_" if name == "segment_sum" else "one torch.mm") + f" {lib:.4f} ms"
                + (" SLOWER than " + ("index_add_" if name == "segment_sum" else "torch.mm") if ms > lib else "")
            )
            if old is not None:
                r["old_ms"] += count * old
            r["ms"] += count * ms
            r["plain_ms"] += count * pms
            r["bound_ms"] += count * b
            r["_parts"][0 if by == "bytes" else 1] += count * b
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["library_ms"] += count * lib
    for name, r in tot.items():
        parts = r.pop("_parts")
        r.pop("f32_checked")
        r["bound_by"] = "bytes" if parts[0] >= parts[1] else "operations"
        key = name if name in ("k3_conv_dw", "strided_dw", "segment_sum") else name + "_dgrad"
        results.setdefault(key, {}).update(r)


def phase_head_backward(trainer, scans) -> dict:
    """The head's backward on one real train topology: K6 once over the
    stacked pair table (`UNetTopology.devox_head`) against the three
    per-scale K6 calls it replaced, within 1e-5 of the largest sum of
    |terms| (a segment's members are cut into units at other places in
    the stacked table), the same bits on a repeat call; device time of
    both, with which of K6's kernels each call takes (units or rows)."""
    import torch

    from taseg_tpu_torch.models.voxel.backbone_context import head_tables
    from taseg_tpu_torch.ops import voxelize as vx

    a = trainer.collate(scans[:1])
    topo = trainer.topology(a)
    st, tables = topo.devox_head, head_tables(topo.devox)
    gen = torch.Generator(device=trainer.device).manual_seed(SEED)
    p = tables[2].inverse.shape[0]
    g = torch.randn(p, trainer.num_class, device=trainer.device, generator=gen).to(torch.bfloat16)
    one = lambda: vx.segment_sum(g, st.tables, st.weights)
    got = twice_same("K6 over the stacked head table", one).split(list(st.rows))

    def three():
        return [vx.segment_sum(g, *vx._pair_tables(t)) for t in tables]

    err = 0.0
    for x, y, t in zip(got, three(), tables):
        pt, w = vx._pair_tables(t)
        ref = vx.segment_sum_plain(g.float().abs(), pt, w.abs()).max().item()
        e = (x - y).abs().max().item()
        if not e <= 1e-5 * ref:
            raise AssertionError(f"K6 stacked head backward: {e:.3e} > 1e-5 x {ref:.3e}")
        err = max(err, e)
    r_real = st.tables.perm.shape[0] - sum(st.rows)
    rows_kernel = [vx.segment_sum_by_rows(r_real, sum(st.rows))] + [
        vx.segment_sum_by_rows(vx._pair_tables(t)[0].perm.shape[0] - n, n)
        for t, n in zip(tables, st.rows)
    ]
    dev_one = device_ms(one, KERNEL_NAMES["segment_sum"])
    dev_three = device_ms(three, KERNEL_NAMES["segment_sum"])
    out = {
        "stacked_device_ms": dev_one, "three_calls_device_ms": dev_three,
        "stacked_ms": cuda_ms(one), "three_calls_ms": cuda_ms(three), "max_abs_err": err,
        "rows_kernel": rows_kernel,
    }
    log(
        f"K6 the head's backward over the stacked pair table (R={r_real} member rows, V={sum(st.rows)}): "
        f"within 1e-5 of the three calls (max|diff| {err:.3e}), bit-identical on repeat; device "
        f"{fmt_ms(dev_one)} (one launch) against {fmt_ms(dev_three)} (three), cuda_ms "
        f"{out['stacked_ms']:.4f} against {out['three_calls_ms']:.4f}; K6's rows kernel: stacked "
        f"{rows_kernel[0]}, the three {rows_kernel[1:]} (else its units)"
    )
    return out


def yardstick_devices(name, kern, a, kw, x, second) -> tuple:
    """(kernel, yardstick) device ms per call of one K5 or K6 call
    (torch.profiler device events): the kernel's own, and every kernel of
    its yardstick (one torch.mm on rows gathered beforehand; zeroing the
    output and one index_add_)."""
    if name == "segment_sum":
        lib = k6_library(x, a[1], a[2] if len(a) > 2 else kw.get("weights"))
    else:
        lib = dw_library(name, x, second, a[2], a[3] if len(a) > 3 else kw["up"])
    return device_ms(kern, KERNEL_NAMES[name]), device_ms(lib, ("",))


def k6_call_names(keys) -> dict:
    """Where each captured K6 call ("segment_sum", R, V, C, weighted, P)
    sits in the step: an unweighted call at a width of at most 9 is a
    voxelize forward (of the point features), a wider one the identity
    devoxelize backward at stride 1; a weighted one over 17 P rows the
    head's backward over its stacked pair tables (strides 16, 4 and 1);
    of the trilinear backwards the ones over the most voxels are at
    stride 4, the others at stride 16 (a KD step's features add one of
    each and an identity one at full width)."""
    names = {
        k: "voxelize forward" if k[3] <= 9 else "devox identity backward, stride 1"
        for k in keys if not k[4]
    }
    names.update({
        k: "the head's backward, stacked (strides 16, 4, 1)"
        for k in keys if k[4] and k[1] == 17 * k[5]
    })
    tri = [k for k in keys if k[4] and k not in names]
    most = max((k[2] for k in tri), default=0)
    names.update({k: f"devox trilinear backward, stride {4 if k[2] == most else 16}" for k in tri})
    return names


def train_cost(name, a, kw, x, second):
    """(bytes, operations, library ms) of one captured call: each input
    read once and the output written once; operations on the pairs that
    this call's tables hold.  K6's yardstick is one `index_add_` of its
    (weighted) rows into the segments, on rows prepared beforehand; the
    others' one torch.mm on rows gathered beforehand."""
    esz = x.element_size()
    if name == "k3_conv_dw":
        rb = a[2]
        v, ci, co = x.shape[0], x.shape[1], second.shape[1]
        pairs = int((rb >= 0).sum())
        return (v * (ci + co) * esz + rb.numel() * 4 + 27 * ci * co * 4,
                2.0 * pairs * ci * co, dw_library_ms(name, x, second, rb))
    if name == "strided_dw":
        t, up = a[2], (a[3] if len(a) > 3 else kw["up"])
        ci, co = x.shape[1], second.shape[1]
        live = int((t.parent >= 0).sum())
        return ((x.numel() + second.numel()) * esz + 8 * t.parent.shape[0] + 8 * ci * co * 4,
                2.0 * live * ci * co, dw_library_ms(name, x, second, t, up))
    if name == "segment_sum":
        t = a[1]
        w = a[2] if len(a) > 2 else kw.get("weights")
        r_real = t.perm.shape[0] - t.starts.shape[0] + 1
        return k6_bytes(x, t, w)[0], 2.0 * r_real * x.shape[1], cuda_ms(k6_library(x, t, w))
    # input-gradient calls of K2 / K3: the forward kernels' costs
    w, t = second, a[2]
    rows, ci = x.shape
    co = w.shape[2]
    lib = conv_library_ms(name, x, w, t)
    if name == "sparse_conv_k3":
        pairs = int((t >= 0).sum())
        return (rows * (ci + co) * esz + w.numel() * esz + t.numel() * 4, 2.0 * pairs * ci * co, lib)
    live = int((t.parent >= 0).sum())
    out_rows = t.starts.shape[0] - 1 if name == "strided_down" else t.parent.shape[0]
    nbytes = (rows * ci + w.numel() + out_rows * co) * esz + 4 * (3 * t.parent.shape[0] + t.starts.shape[0])
    return nbytes, 2.0 * live * ci * co, lib


def phase_pair_lists(trainer, scans) -> None:
    """What the pair lists of K4 and K5 cost the topology stage: per
    level of one train topology, the present pairs, the buffer and the
    time of `k3_pair_lists` (one per level and step) and of
    `slot_pair_lists` (one per level but the first).  The pipeline's random
    state is put back, so the timed steps see the augmentations they
    would see without this phase."""
    from taseg_tpu_torch.ops import f3conv, strided_conv

    rng = trainer.pipeline.rng.bit_generator
    state = rng.state
    topo = trainer.topology(trainer.collate(scans[:1]))
    rng.state = state
    tot = 0.0
    for l, lt in enumerate(topo.levels):
        ms = cuda_ms(lambda: f3conv.k3_pair_lists(lt.rb_k3_bwd))
        v, n = lt.rb_k3_bwd.shape[1], int(lt.k3_pairs.starts[-1])
        log(
            f"K4 pair lists level {l}: V={v} voxels={int(lt.num)} pairs={n} "
            f"({n / max(1, int(lt.num)):.2f} per voxel), {8 * 27 * v / 2**20:.1f} MiB, "
            f"built in {ms:.4f} ms"
        )
        tot += ms
    log(f"K4 pair lists: {tot:.4f} ms per step in the topology stage")
    tot = 0.0
    for l, lt in enumerate(topo.levels[1:], start=1):
        ms = cuda_ms(lambda: strided_conv.slot_pair_lists(lt.strided))
        log(
            f"K5 pair lists level {l}: V_fine={lt.strided.parent.shape[0]} "
            f"pairs={int(lt.strided.pairs.starts[-1])}, built in {ms:.4f} ms"
        )
        tot += ms
    log(f"K5 pair lists: {tot:.4f} ms per step in the topology stage")


def phase_small_train_step(cfg, variables, label: str = "", no_dropout: bool = False, prepare=None,
                           tol=(1e-4, 1e-3, 3e-2)) -> None:
    """The same small scan and weights through 2 f32 train steps on the
    card and on the CPU (plain versions): step 0 at LR * 1e-5, step 1 at
    the full LR (warmup of one step).  Loss within 1e-4 relative, grad
    norm within 1e-3, and the parameters' updates within 3e-2 of the
    update's L2 norm (measured 4.2e-4 and 1.3e-2 on an H100: the step
    amplifies summation-order differences, as tests/test_torch_train.py
    shows on the CPU).  `no_dropout` sets every Dropout's rate to 0 on
    both sides: a CUDA and a CPU generator draw different masks from one
    seed (RPVNet's range branch drops at 0.2 in every step).  `prepare`
    is called on each Trainer before its steps (a criterion rebuilt with
    class counts); `tol` replaces the three tolerances (loss, grad norm,
    update) for an optimizer that amplifies the difference
    (`LOSS_VARIANTS`' adam_onecycle)."""
    import numpy as np

    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.models.layers import Dropout
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params

    small = make_scans(1, n_points=8000, seed=SEED + 1)
    cfg_small = {**cfg, "MODEL": {**cfg["MODEL"], "TRAIN_CAPACITY_SCHEDULE": (1.0,) * 5}}
    runs = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(
            cfg_small, variables, device=dev, iters_per_epoch=1, total_epochs=4,
            compute_dtype="float32", point_capacity=8192, seed=SEED,
        )
        if no_dropout:
            for m in tr.model.modules():
                if isinstance(m, Dropout):
                    m.rate = 0.0
        if prepare is not None:
            prepare(tr)
        runs[dev] = [tr.step(small) for _ in range(2)], export_flax_params(tr.model)[0]
    (g_out, g_par), (c_out, c_par) = runs["cuda"], runs["cpu"]
    p0 = variables["params"]

    def flat(t, pre=""):
        out = {}
        for k, v in t.items():
            out.update(flat(v, pre + k + "/") if isinstance(v, dict) else {pre + k: np.asarray(v, np.float64)})
        return out

    a, b, z = flat(g_par), flat(c_par), flat(p0)
    diff = np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
    upd = np.sqrt(sum(((b[k] - z[k]) ** 2).sum() for k in a))
    for i, (g, c) in enumerate(zip(g_out, c_out)):
        log(
            f"{label}small-scan f32 step {i}: loss card {g['loss']:.7f} cpu {c['loss']:.7f}, "
            f"grad norm card {g['grad_norm']:.6f} cpu {c['grad_norm']:.6f}, lr {g['lr']:.3e}"
        )
        if not abs(g["loss"] - c["loss"]) <= tol[0] * abs(c["loss"]):
            raise AssertionError(f"small-scan step {i}: card and CPU losses disagree")
        if not abs(g["grad_norm"] - c["grad_norm"]) <= tol[1] * c["grad_norm"]:
            raise AssertionError(f"small-scan step {i}: card and CPU grad norms disagree")
    log(f"{label}small-scan f32 params after 2 steps: |card - cpu| / |update| = {diff / upd:.3e}")
    if not diff <= tol[2] * upd:
        raise AssertionError("small-scan step: card and CPU updates disagree")


def phase_train_steps(trainer, scans, per_step: dict = TRAIN_PER_STEP, label: str = "train") -> dict:
    """The train path, counted: TRAIN_STEPS calls of `Trainer.step`, one
    120 000-point scan each, with every launch count set to 0 just before
    and read just after; loss, grad norm and every parameter finite; each
    kernel's launches per step as `per_step` says.  Then the same
    number of steps again by stage (host clock for the host stage, CUDA
    events for the others), and the peak memory of the counted steps."""
    import numpy as np
    import torch

    from taseg_tpu_torch.engine import check_capacity
    from taseg_tpu_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    _build.reset_launches()
    t0 = time.perf_counter()
    outs = [trainer.step(scans[i % len(scans) : i % len(scans) + 1]) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, o in enumerate(outs):
        log(
            f"{label} step {i}: loss {o['loss']:.5f} grad norm {o['grad_norm']:.4f} "
            f"lr {o['lr']:.3e} level voxels {o['level_nums']}"
        )
        if not (np.isfinite(o["loss"]) and np.isfinite(o["grad_norm"])):
            raise AssertionError(f"{label} step {i}: non-finite loss or grad norm")
    for n, p in trainer.model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"{label}: parameter {n} is not finite")
    log(f"{label} path launches over {TRAIN_STEPS} steps: {launches}")
    for k, per in per_step.items():
        if launches[k] != per * TRAIN_STEPS:
            raise AssertionError(
                f"{label}: {k} launched {launches[k]} times, expected {per} per step"
            )
    log(f"{label}: launches per step as expected: {per_step}")

    stages = {k: [] for k in ("host", "topology", "forward", "backward", "optimizer", "step")}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        a = trainer.collate(scans[i % len(scans) : i % len(scans) + 1])
        t1 = time.perf_counter()
        ev[0].record()
        topo = trainer.topology(a)
        check_capacity(topo, trainer.caps)
        ev[1].record()
        loss = trainer.forward(a, topo)
        ev[2].record()
        trainer.backward(loss)
        ev[3].record()
        trainer.update()
        ev[4].record()
        ev[4].synchronize()
        stages["step"].append((time.perf_counter() - t0) * 1e3)
        stages["host"].append((t1 - t0) * 1e3)
        for j, k in enumerate(("topology", "forward", "backward", "optimizer")):
            stages[k].append(ev[j].elapsed_time(ev[j + 1]))
    med = {k: float(np.median(v)) for k, v in stages.items()}
    log(
        f"{label} ms per step (median of {TRAIN_STEPS}; counted steps {wall:.1f} ms "
        f"each end to end): " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f"; peak device memory {peak:.2f} GiB ({before:.2f} GiB allocated before the steps)"
    )
    return launches, med


class StageEvents:
    """CUDA events around a Trainer's stage methods, as `train_on` calls
    them: topology (until the forward starts, the capacity check
    included), forward + loss, backward and optimizer of each step."""

    STAGES = ("topology", "forward", "backward", "update")

    def __init__(self, trainer):
        import torch

        self.marks = []
        for name in self.STAGES:
            fn = getattr(trainer, name)

            def timed(*a, _fn=fn, _name=name, **kw):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.marks.append((_name, ev))
                out = _fn(*a, **kw)
                if _name == "update":
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.marks.append(("end", end))
                return out

            setattr(trainer, name, timed)

    def per_step(self) -> list:
        """[{stage: ms}] of each step."""
        out, step = [], {}
        for (name, ev), (_, nxt) in zip(self.marks, self.marks[1:]):
            if name == "end":
                continue
            step[name] = ev.elapsed_time(nxt)
            if name == "update":
                out.append(step)
                step = {}
        return out


def phase_harness(cfg, variables, infer_per_scan: dict, serial: dict) -> None:
    """The train/eval harness at full width: `build_dataloader` over the
    synthetic reader (HARNESS_TRAIN_SCANS train and HARNESS_EVAL_SCANS
    eval scans of N_POINTS points, batch 1, the point capacity passed
    explicitly as bench.py does) and `Trainer.train(eval_interval=1)` for
    one epoch: the steps through the prefetching loader, a checkpoint and
    `evaluate()`, with every launch counted and each kernel's launches
    as TRAIN_PER_STEP and the inference path give them.  A fresh Trainer
    resumes the same bits; `evaluate_points()` writes the logits and
    labels of `Segmenter.predict` on the same scans and weights, bit for
    bit; 2 TTA votes write 3 readable .label files of raw ids.  Prints ms
    per step, the wait for each batch, the host stage in the producer,
    the device stages while the producer runs beside the serial ones of
    `phase_train_steps`, and eval scans/s without TTA and with 2 votes."""
    import logging
    import shutil

    import numpy as np
    import torch

    from taseg_tpu_torch.data import build_dataloader
    from taseg_tpu_torch.data.semantickitti.labels import INV_LUT, LEARNING_MAP_LUT
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params

    out_dir = REPO / "build" / "harness"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    logger = logging.getLogger("chip_smoke.harness")
    logger.propagate = False
    logger.setLevel(logging.INFO)
    logger.addHandler(logging.FileHandler(out_dir / "log.txt"))
    data = {**cfg["DATA"], "DATASET": "synthetic", "N_RAW_POINTS": N_POINTS}
    hcfg = {**cfg, "DATA": data}

    def trainer():
        kw = dict(training=True, scans_per_shard=1, point_capacity=HARNESS_POINT_CAPACITY)
        train = build_dataloader({**data, "LENGTH": HARNESS_TRAIN_SCANS}, **kw)
        val = build_dataloader({**data, "LENGTH": HARNESS_EVAL_SCANS}, **{**kw, "training": False})
        return Trainer(
            hcfg, variables, train_loader=train, val_loader=val, output_dir=out_dir,
            logger=logger, compute_dtype="bfloat16", total_epochs=1,
        )

    def expect(launches, steps, scans, what):
        for k, n in launches.items():
            want = TRAIN_PER_STEP.get(k, 0) * steps + infer_per_scan.get(k, 0) * scans
            if n != want:
                raise AssertionError(f"harness {what}: {k} launched {n} times, expected {want}")
        missing = [k for k in INFER_KERNELS if infer_per_scan.get(k) and not launches[k]]
        if missing:
            raise AssertionError(f"harness {what}: {missing} not launched")

    a = trainer()
    make_ms = []
    make_batch = a.train_loader._make_batch

    def timed_make(*args):
        t0 = time.perf_counter()
        out = make_batch(*args)
        make_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    a.train_loader._make_batch = timed_make
    stages = StageEvents(a)
    torch.cuda.synchronize()
    _build.reset_launches()
    (epoch,) = a.train(eval_interval=1)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    expect(launches, HARNESS_TRAIN_SCANS, HARNESS_EVAL_SCANS, "train(eval_interval=1)")
    steps = epoch["steps"]
    for i, o in enumerate(steps):
        if not (np.isfinite(o["loss"]) and np.isfinite(o["grad_norm"])):
            raise AssertionError(f"harness step {i}: non-finite loss or grad norm")
    ckpts = a.ckptr.list_epochs(a.ckpt_dir)
    if [e for e, _ in ckpts] != [0]:
        raise AssertionError(f"harness: checkpoints {ckpts}")
    log(f"harness: {len(steps)} steps through the loader, losses "
        f"{[round(o['loss'], 5) for o in steps]}, lr {steps[-1]['lr']:.3e}; "
        f"launches as expected ({HARNESS_TRAIN_SCANS} steps + {HARNESS_EVAL_SCANS} eval scans)")
    later = slice(1, None)  # steps 2.. of the epoch
    wall = [(o["data_s"] + o["step_s"]) * 1e3 for o in steps]
    wait = [o["data_s"] * 1e3 for o in steps]
    per = stages.per_step()
    dev = {k: float(np.median([p[k] for p in per[later]])) for k in StageEvents.STAGES}
    log(
        f"harness ms per train step through the loader (median of steps 2-{len(steps)}): "
        f"{np.median(wall[later]):.3f} (each: {', '.join(f'{x:.1f}' for x in wall)}); "
        f"wait on the queue {np.median(wait[later]):.3f} (each: {', '.join(f'{x:.1f}' for x in wait)}); "
        f"host stage in the producer {np.median(make_ms):.3f} ms per scan "
        f"(each: {', '.join(f'{x:.1f}' for x in make_ms)})"
    )
    log(
        "harness device stages while the producer runs, against the serial "
        "steps (ms, medians): " + ", ".join(
            f"{k} {dev[k]:.3f} / {serial[k if k != 'update' else 'optimizer']:.3f}"
            for k in StageEvents.STAGES
        )
    )

    # a fresh Trainer resumes the same bits
    c = trainer()
    if not (c.resume_latest() and c.start_epoch == 1):
        raise AssertionError("harness: resume_latest found no checkpoint")
    if c.optimizer.count != a.optimizer.count:
        raise AssertionError(f"harness: count {c.optimizer.count} != {a.optimizer.count}")
    for (k, x), y in zip(c.model.state_dict().items(), a.model.state_dict().values()):
        if not torch.equal(x, y):
            raise AssertionError(f"harness: resumed {k} differs")
    for p, q in zip(c.model.parameters(), a.model.parameters()):
        if not torch.equal(c.optimizer.state[p]["trace"], a.optimizer.state[q]["trace"]):
            raise AssertionError("harness: resumed momentum trace differs")
    log(f"harness: resumed bit-exactly at count {c.optimizer.count}")

    # raw-point evaluation: scans/s, then the files against Segmenter
    timing = {}
    for votes in (0, 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c.evaluate_points(tta_votes=votes)
        torch.cuda.synchronize()
        timing[votes] = HARNESS_EVAL_SCANS / (time.perf_counter() - t0)
    _build.reset_launches()
    res = c.evaluate_points(save_path=out_dir / "plain", save_score=True)
    torch.cuda.synchronize()
    expect(dict(_build.LAUNCHES), 0, HARNESS_EVAL_SCANS, "evaluate_points()")
    p, s = export_flax_params(c.model)
    seg = Segmenter(hcfg, {"params": p, "batch_stats": s}, compute_dtype="bfloat16",
                    point_capacity=HARNESS_POINT_CAPACITY)
    reader = c.val_loader.reader
    want = seg.predict([reader[i] for i in range(HARNESS_EVAL_SCANS)])
    for i, o in enumerate(want):
        f = out_dir / "plain" / "sequences" / "08" / "predictions" / f"{i:06d}"
        logits = np.fromfile(f.with_suffix(".bin"), np.float32).reshape(o["logits"].shape)
        labels = LEARNING_MAP_LUT[np.fromfile(f.with_suffix(".label"), np.uint32)]
        if not (np.array_equal(logits.view(np.uint32), o["logits"].view(np.uint32))
                and np.array_equal(labels, o["labels"])):
            raise AssertionError(f"harness: evaluate_points differs from Segmenter on scan {i}")
    log(f"harness: evaluate_points() logits and labels bit-equal to Segmenter.predict on "
        f"{HARNESS_EVAL_SCANS} scans; point mIoU {res['miou']:.2f}")

    c.evaluate_points(tta_votes=2, save_path=out_dir / "tta")
    files = sorted((out_dir / "tta" / "sequences" / "08" / "predictions").glob("*.label"))
    if len(files) != HARNESS_EVAL_SCANS:
        raise AssertionError(f"harness: {len(files)} TTA label files")
    for f in files:
        raw = np.fromfile(f, np.uint32)
        if len(raw) != N_POINTS or not np.isin(raw, INV_LUT).all():
            raise AssertionError(f"harness: {f.name} is not {N_POINTS} raw ids")
    log(
        f"harness: evaluate_points {timing[0]:.4f} scans/s, with 2 TTA votes "
        f"{timing[2]:.4f} scans/s; {len(files)} TTA .label files of {N_POINTS} raw ids"
    )
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    del a, c, seg
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_train_profile(trainer, scans, results: dict, label: str = "") -> None:
    """Device time per train step of each kernel (torch.profiler device
    events over one step), the split reductions of K4/K5 apart.  User
    annotations (the optimizer's `Optimizer.step` range) span kernels
    that are counted already, and are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.step(scans[:1])
        torch.cuda.synchronize()
    dev = {k: 0.0 for k in KERNEL_NAMES}
    red = busy = 0.0
    others = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU or e.is_user_annotation:
            continue
        ms = e.self_device_time_total / 1e3
        busy += ms
        if named(e.key, OLD_DW_KERNELS):
            raise AssertionError(f"{label}train step launched a replaced mma.sync weight-gradient tile: {e.key}")
        if named(e.key, OLD_K9K10_KERNELS):
            raise AssertionError(f"{label}train step launched a first-design K9 / K10 kernel: {e.key}")
        if "reduce_splits" in e.key:
            red += ms
        mine = [k for k, frags in KERNEL_NAMES.items() if named(e.key, frags)]
        for k in mine:
            dev[k] += ms
        if not mine and "reduce_splits" not in e.key:
            others.append((ms, e.count, e.key[:90]))
    for k, ms in dev.items():
        log(f"{label}profiler train {k}: {ms:.4f} ms per step on the device")
        results.setdefault(k, {})["device_ms_per_step"] = ms or None
    log(f"{label}profiler train: K4 split reductions {red:.4f} ms, all kernels {busy:.4f} ms per step")
    others.sort(reverse=True)
    log(
        f"{label}profiler train: other kernels {sum(o[0] for o in others):.4f} ms per step "
        f"in {sum(o[1] for o in others)} launches; the largest:"
    )
    for ms, n, name in others[:10]:
        log(f"  {ms:.4f} ms x{n} {name}")


def phase_train_probes(trainer, scans) -> None:
    """Device time per call of K4, K5 and K6 at every shape of one more
    captured train step (torch.profiler device events, the call's own
    bf16 inputs and pair lists); after the timed steps, so that neither
    the profiler nor the captured inputs touch them."""
    from taseg_tpu_torch.ops import f3conv, strided_conv, voxelize

    cap = capture_train_calls(trainer, scans[:1])
    k6_names = k6_call_names([k for k in cap.seen if k[0] == "segment_sum"])
    for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name = key[0]
        if name == "k3_conv_dw":
            route = f3conv.dw_route(a[0].dtype, a[0].shape[1], a[1].shape[1])
            label = f"{name} {key[1:]} route {route}"
            call = partial(f3conv.k3_conv_dw, a[0], a[1], a[2], pairs=kw.get("pairs"))
        elif name == "strided_dw":
            route = f3conv.dw_route(a[0].dtype, a[0].shape[1], a[1].shape[1], strided=True)
            label = f"{name} {key[1:]} route {route}"
            call = partial(strided_conv.strided_dw, *a, **kw)
        elif name == "segment_sum":
            label = f"{name} ({k6_names[key]}) {key[1:]}"
            call = partial(voxelize.segment_sum, *a, **kw)
        else:
            continue
        log(f"profiler {label} x{cap.count[key]}/step: device {fmt_ms(device_ms(call, KERNEL_NAMES[name]))} per call")


def small_scan_check(cfg, variables, label: str = "", small=None, capacity: int = 8192) -> None:
    """The card's f32 `Segmenter` against the CPU's plain path on one
    small scan (a sparse small scan fills every level: capacities at the
    point count; by default an 8000-point scan at 8192 rows): logits
    within 1e-3 of their scale."""
    import numpy as np

    from taseg_tpu_torch.engine import Segmenter

    small = small or make_scans(1, n_points=8000, seed=SEED + 1)
    cfg_small = {**cfg, "MODEL": {**cfg["MODEL"], "CAPACITY_SCHEDULE": (1.0,) * 5}}
    gpu_small, cpu_small = (
        Segmenter(cfg_small, variables, device=dev, compute_dtype="float32",
                  point_capacity=capacity).predict(small)[0]
        for dev in ("cuda", "cpu")
    )
    d = np.abs(gpu_small["logits"] - cpu_small["logits"]).max()
    scale = max(1.0, float(np.abs(cpu_small["logits"]).max()))
    log(f"{label}small scan f32 card vs cpu plain: max|dlogit| {d:.3e} (scale {scale:.3e})")
    if not d <= 1e-3 * scale:
        raise AssertionError(f"{label}card and CPU logits disagree on the small scan")


def serve_split(seg, scans, rounds: int, label: str = "") -> None:
    """Serving time per scan after warm-up, host / topology / forward
    split (host clock, CUDA events), one scan per sample, `rounds` passes
    over the scans; median and p75, and the peak memory."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    samples = {"end_to_end": [], "host": [], "topology": [], "forward": []}
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(rounds):
        for s in scans:
            t0 = time.perf_counter()
            a = seg.collate([s])
            t1 = time.perf_counter()
            e[0].record()
            tp = seg.topology(a)
            e[1].record()
            lg = seg.forward(a, tp)
            e[2].record()
            seg.map_to_points(a, lg)  # copies to the host: synchronises
            samples["end_to_end"].append((time.perf_counter() - t0) * 1e3)
            samples["host"].append((t1 - t0) * 1e3)
            samples["topology"].append(e[0].elapsed_time(e[1]))
            samples["forward"].append(e[1].elapsed_time(e[2]))
    summary = {
        k: (float(np.median(v)), float(np.percentile(v, 75))) for k, v in samples.items()
    }
    n = len(samples["end_to_end"])
    log(
        f"{label}throughput over {n} scans (ms per scan, median / p75): "
        + ", ".join(f"{k} {m:.3f} / {q:.3f}" for k, (m, q) in summary.items())
        + f"; {1e3 / summary['end_to_end'][0]:.4f} scans/s end to end, "
        f"{1e3 / (summary['topology'][0] + summary['forward'][0]):.4f} scans/s on the "
        f"card (topology + forward); peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
    )


def check_launches(launches: dict, per: dict, n: int, what: str) -> None:
    """Every wrapper's launches equal per[k] * n (0 where `per` has no k)."""
    for k, got in launches.items():
        if got != per.get(k, 0) * n:
            raise AssertionError(
                f"{what}: {k} launched {got} times, expected {per.get(k, 0)} x {n}"
            )


def k8_calls(trainer, scans) -> CallCapture:
    """One real train step with K8's wrapper wrapped: the inputs of each
    of its calls (the re-voxelize backwards of SPVCNN's point branch)."""
    from taseg_tpu_torch.ops import voxelize

    cap = CallCapture()
    cap.patch(
        voxelize, "voxelize_bwd",
        lambda g, inv, counts: ("voxelize_bwd", inv.shape[0], *g.shape, str(g.dtype).split(".")[-1]),
    )
    trainer.step(scans[:1])
    cap.remove()
    return cap


def k8_layout_call(g, inv, counts, layout: str):
    """K8 in `layout` ("rows", "flat", or "old": its first kernel, the
    yardstick `old_ms`) through its C entry, counted nowhere: the (P, C)
    output."""
    import torch

    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops.sparse_conv import DTYPE_CODES
    from taseg_tpu_torch.ops.voxelize import K8_LAYOUTS

    out = torch.empty((inv.shape[0], g.shape[1]), dtype=g.dtype, device=g.device)
    _build.launch("taseg_voxelize_bwd", (), g.data_ptr(), inv.data_ptr(), counts.data_ptr(), out.data_ptr(),
                  inv.shape[0], g.shape[1], DTYPE_CODES[g.dtype], K8_LAYOUTS[layout])
    return out


def k8_call(label: str, g, inv, counts) -> dict:
    """K8 at one call through its wrapper: the same bits as its plain
    version (signed zeros included), on a repeat call, in its other
    layout (where the row holds a 16-byte piece) and in its first kernel.
    Times: kernel (`cuda_ms`), device (profiler), plain, the other layout
    (`other_ms`), the first kernel (`old_ms`), one `index_select` (and its
    device time) of g's
    rows divided by their counts beforehand over a zero row for points
    without a voxel (bit-equal to K8 where torch's division rounds as
    K8's; held within one bf16 rounding), and the bound (bytes: the (P, C)
    output written once, the (P,) map read once, g's rows and counts
    once per voxel that has points: what this call's data reads).  Logs
    one line; returns the times with the layout taken."""
    import torch

    from taseg_tpu_torch.ops import voxelize as vx

    v, c = g.shape
    p, es = inv.shape[0], g.element_size()
    got = twice_same(label, lambda: vx.voxelize_bwd(g, inv, counts))
    want = bits(vx._voxelize_bwd_plain(g, inv, counts))
    if not bits(got).equal(want):
        raise AssertionError(f"{label}: {(bits(got) != want).sum().item()} values differ from the plain version")
    layout, piece = vx.voxelize_bwd_plan(c, es, g.data_ptr() % 16, p * c)
    other = {"rows": "flat", "flat": "rows"}.get(layout) if c * es >= 16 else None
    for lay in (other, "old"):
        if lay is not None and not bits(k8_layout_call(g, inv, counts, lay)).equal(want):
            raise AssertionError(f"{label}: K8's {lay} layout differs from the plain version")
    scaled = torch.cat([g / counts.clamp(min=1).to(g.dtype)[:, None], g.new_zeros(1, c)])
    idx = torch.where(inv >= 0, inv, v).long()
    lib_err = (torch.index_select(scaled, 0, idx).float() - got.float()).abs().max().item()
    if not lib_err <= 2.0**-7 * got.float().abs().max().item():
        raise AssertionError(f"{label}: index_select differs by {lib_err:.3e}")
    used = int((counts > 0).sum())
    r = {
        "ms": cuda_ms(lambda: vx.voxelize_bwd(g, inv, counts)),
        "device_ms": device_ms(partial(vx.voxelize_bwd, g, inv, counts), KERNEL_NAMES["voxelize_bwd"]),
        "plain_ms": cuda_ms(lambda: vx._voxelize_bwd_plain(g, inv, counts)),
        "old_ms": cuda_ms(lambda: k8_layout_call(g, inv, counts, "old")),
        "library_ms": cuda_ms(lambda: torch.index_select(scaled, 0, idx)),
        "library_device_ms": device_ms(lambda: torch.index_select(scaled, 0, idx), ("",)),
        "bound_ms": bound_ms(p * c * es + used * (c * es + 4) + p * 4, 0.0, "float32")[0],
        "max_abs_err": 0.0,
    }
    other_ms = cuda_ms(lambda: k8_layout_call(g, inv, counts, other)) if other else None
    log(
        f"{label} P={p} V={v} ({used} with points) C={c} {str(g.dtype).split('.')[-1]} ({c * es} bytes a row): "
        f"bit-identical (and on repeat, in every layout), {layout} layout"
        + (f" ({piece}-byte pieces)" if layout == "rows" else "")
        + f" kernel {r['ms']:.4f} ms device {fmt_ms(r['device_ms'])}"
        + ("" if other is None else f", {other} layout {other_ms:.4f} ms")
        + f", first kernel (old_ms) {r['old_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms index_select "
        f"{r['library_ms']:.4f} ms (device {fmt_ms(r['library_device_ms'])}, max|diff| {lib_err:.3e}) "
        f"bound {r['bound_ms']:.4f} ms (bytes)"
        + (" SLOWER than index_select" if r["ms"] > r["library_ms"] else "")
    )
    return dict(r, layout=layout, other_ms=other_ms)


def phase_k8(cap: CallCapture, results: dict) -> None:
    """K8 at every call of one real SPVCNN train step (`k8_call`): the
    plain version's bits, its times beside its other layout, its first
    kernel and `index_select`, summed over the step's calls."""
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "library_device_ms": 0.0,
           "old_ms": 0.0, "device_ms": 0.0, "max_abs_err": 0.0}
    if sum(cap.count.values()) != SPVCNN_PER_STEP["voxelize_bwd"]:
        raise AssertionError(f"K8: calls per step {cap.count}")
    for key, (args, _) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        g, inv, counts = args
        r = k8_call(f"K8 voxelize_bwd x{cap.count[key]}/step", g, inv, counts)
        for k in tot:
            if k != "max_abs_err":
                tot[k] = msum(tot[k], mscale(cap.count[key], r[k]))
    results["voxelize_bwd"] = dict(tot, bound_by="bytes")


def point_vox_cost(seg, scans, rounds: int = 3) -> None:
    """What the point -> voxel tables add to the topology stage: the
    serving and the train topology of each scan built with and without
    `point_voxel_strides`, in turns (CUDA events), medians."""
    import numpy as np
    import torch

    from taseg_tpu_torch.models.voxel.backbone_context import build_unet_topology, host_nonneg

    strides = seg.model.point_voxel_strides
    e = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ms = {}
    batches = [seg.collate([s]) for s in scans]
    for _ in range(rounds):
        for a in batches:
            for pairs in (False, True):
                for pv in ((), strides):
                    e[0].record()
                    build_unet_topology(
                        a["point_coords_t"], a["num_points_t"], seg.caps, devox_pairs=pairs,
                        assume_sorted_points=True, point_voxel_strides=pv,
                        nonneg_coords=host_nonneg(a["point_coords"]),
                    )
                    e[1].record()
                    e[1].synchronize()
                    ms.setdefault((pairs, bool(pv)), []).append(e[0].elapsed_time(e[1]))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    log(
        f"spvcnn point_vox tables in the topology (medians of {len(ms[(False, False)])}, "
        f"in turns): serving {med[(False, False)]:.3f} -> {med[(False, True)]:.3f} ms, "
        f"train form {med[(True, False)]:.3f} -> {med[(True, True)]:.3f} ms"
    )


def stage_turns(models: dict, scans, rounds: int = 2) -> None:
    """Device stage times of each model's serving and train paths in
    turns on the same scans (the order of the models alternating per
    scan), so that what SPVCNN's point branch adds to MinkUNet's stages
    is read free of the drift between the script's phases.  `models`:
    name -> (Segmenter, Trainer).  CUDA events; medians."""
    import numpy as np
    import torch

    from taseg_tpu_torch.engine import check_capacity

    names = list(models)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    ms: dict = {}

    def add(name, keys):
        for j, k in enumerate(keys):
            ms.setdefault((name, k), []).append(ev[j].elapsed_time(ev[j + 1]))

    for r in range(rounds):
        for i, s in enumerate(scans):
            order = names if (r * len(scans) + i) % 2 == 0 else names[::-1]
            for name in order:
                seg, tr = models[name]
                a = seg.collate([s])
                ev[0].record()
                topo = seg.topology(a)
                ev[1].record()
                seg.forward(a, topo)
                ev[2].record()
                ev[2].synchronize()
                add(name, ("serve topology", "serve forward"))
                a = tr.collate([s])
                ev[0].record()
                topo = tr.topology(a)
                check_capacity(topo, tr.caps)
                ev[1].record()
                loss = tr.forward(a, topo)
                ev[2].record()
                tr.backward(loss)
                ev[3].record()
                tr.update()
                ev[4].record()
                ev[4].synchronize()
                add(name, ("train topology", "train forward", "backward", "optimizer"))
    for name in names:
        log(
            f"in turns ({rounds * len(scans)} each), {name} device stages (ms, medians): "
            + ", ".join(
                f"{k} {float(np.median(v)):.3f}" for (n, k), v in ms.items() if n == name
            )
        )


def phase_spvcnn(scans, results: dict, minkunet: tuple) -> dict:
    """SPVCNN mk34 cr1.0 (the same backbone with the point branch) at full
    width in bf16, seeded weights, on the same scans: `Segmenter.predict`
    with every launch count set to 0 just before and read just after
    (each kernel as SPVCNN_PER_SCAN says), finite logits of the right
    shape, bf16/f32 argmax agreement >= 0.97, the small-scan card f32
    logits against the CPU, serving ms per scan by stage; then the train
    path: the inputs of K8's calls in one real step, a small-scan f32 step
    on the card against the CPU, TRAIN_STEPS counted `Trainer` steps (each
    kernel as SPVCNN_PER_STEP says), ms per step by stage, peak memory,
    the device stages beside MinkUNet's in turns (`minkunet`: its
    Segmenter and Trainer); then, with the profiler, K8 at its captured
    calls (`phase_k8`) and the device time per step of each kernel.  The MinkUNet phases'
    objects stay alive (phase 6 uses them).  Returns the launches per
    scan and per step and the device ms per step."""
    import numpy as np
    import torch

    from taseg_tpu_torch.configs import SPVCNN_MK34_CR10
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.models import SPVCNN
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    cfg = SPVCNN_MK34_CR10
    params, stats = init_params_numpy(cfg, seed=SEED)
    variables = {"params": params, "batch_stats": stats}
    seg = Segmenter(cfg, variables, compute_dtype="bfloat16")
    if not isinstance(seg.model, SPVCNN):
        raise AssertionError(f"spvcnn: Segmenter built {type(seg.model).__name__}")
    torch.cuda.synchronize()
    _build.reset_launches()
    out = seg.predict(scans)
    torch.cuda.synchronize()
    serve = dict(_build.LAUNCHES)
    log(f"spvcnn serving launches over {len(scans)} scans: {serve}")
    check_launches(serve, SPVCNN_PER_SCAN, len(scans), "spvcnn serving")
    for s, o in zip(scans, out):
        if o["logits"].shape != (s["xyzret"].shape[0], cfg["MODEL"]["NUM_CLASS"]):
            raise AssertionError(f"spvcnn logits shape {o['logits'].shape}")
        if not np.isfinite(o["logits"]).all():
            raise AssertionError("spvcnn: non-finite logits")
    out32 = Segmenter(cfg, variables, compute_dtype="float32").predict(scans)
    agree = float(np.mean(np.concatenate([a["labels"] == b["labels"] for a, b in zip(out, out32)])))
    log(f"spvcnn bf16 vs f32 per-point argmax agreement {agree:.5f}")
    if agree < 0.97:
        raise AssertionError(f"spvcnn bf16/f32 argmax agreement {agree:.4f} < 0.97")
    del out32
    small_scan_check(cfg, variables, "spvcnn ")
    serve_split(seg, scans, SPVCNN_ROUNDS, "spvcnn ")
    point_vox_cost(seg, scans)

    trainer = Trainer(
        cfg, variables, iters_per_epoch=TRAIN_STEPS,
        total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], compute_dtype="bfloat16", seed=SEED,
    )
    cap = k8_calls(trainer, scans)
    phase_small_train_step(cfg, variables, "spvcnn ")
    train, _ = phase_train_steps(trainer, scans, SPVCNN_PER_STEP, "spvcnn train")
    stage_turns({"MinkUNet": minkunet, "SPVCNN": (seg, trainer)}, scans)
    del seg
    phase_k8(cap, results)
    del cap
    spv: dict = {}
    phase_train_profile(trainer, scans, spv, "spvcnn ")
    results["voxelize_bwd"]["device_ms_per_step"] = spv["voxelize_bwd"]["device_ms_per_step"]
    del trainer
    torch.cuda.empty_cache()
    return {
        "per_scan": {k: n // len(scans) for k, n in serve.items()},
        "per_step": {k: n // TRAIN_STEPS for k, n in train.items()},
        "device_ms_per_step": {k: v["device_ms_per_step"] for k, v in spv.items()},
    }


def rpv_calls(trainer, scans) -> CallCapture:
    """One real RPVNet train step with the model's point <-> range
    functions wrapped: the inputs of its 3 scatters to the range image
    (`point_to_range`: K6 over the pixel tables, K8 their backward) and
    of its 4 bilinear samples back (`devoxelize` on a 4-corner table: K7
    at 4 corners, K6 over the 4P corner pairs their backward)."""
    from taseg_tpu_torch.models.fusion import rpvnet

    cap = CallCapture()
    cap.patch(rpvnet, "point_to_range", lambda z, ids, t, h, w: ("scatter", h, w, z.shape[1]))
    cap.patch(
        rpvnet, "devoxelize",
        lambda v, t: ("sample", t.idx.shape[1], *v.shape)
        if getattr(t, "idx", None) is not None and t.idx.shape[0] == 4 else None,
    )
    trainer.step(scans[:1])
    cap.remove()
    return cap


def _tot():
    return {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
            "device_ms": 0.0, "max_abs_err": 0.0}


def _add(tot, **kw):
    for k, x in kw.items():
        tot[k] = max(tot.get(k, 0.0), x) if k == "max_abs_err" else msum(tot.get(k, 0.0), x)


def phase_rpv_kernels(cap: CallCapture, results: dict) -> None:
    """The kernels of RPVNet's point <-> range path at the tables and
    feature rows of one real train step (the backwards' cotangents drawn
    from a seed at the same shapes):
      * K7 at 4 corners, each of the 4 samples (scales 1, 16, 4, 1 at C =
        32, 256, 128, 96, f32): bit-identical to the plain version (signed
        zeros included) and on a repeat call; kernel, device (profiler),
        plain, bound (bytes: the (idx, w) pairs, the image rows the
        corners read, once each, and the output) and `F.embedding_bag`
        with per-sample weights (`devox_times`);
      * K6 over each scatter's pixel tables (the forward mean's sums) and
        over each sample's 4P corner pairs (its backward), against the
        plain version in f64 within 1e-5 of the largest sum of |terms|,
        bit-identical on repeat, with `index_add_` beside it;
      * K8 at each scatter's backward (g over the pixels, f32):
        bit-identical to the plain version, with `index_select` of rows
        divided beforehand beside it.
    Totals per step go to results["devoxelize_bilinear"] and to the
    "rpvnet_pixel_tables" entries of K6 and K8."""
    import torch

    from taseg_tpu_torch.ops import voxelize as vx

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    k7, k6, k8 = _tot(), _tot(), _tot()
    samples = sorted((k for k in cap.seen if k[0] == "sample"), key=str)
    scatters = sorted((k for k in cap.seen if k[0] == "scatter"), key=str)
    if len(samples) != 4 or len(scatters) != 3:
        raise AssertionError(f"rpvnet: {len(samples)} samples, {len(scatters)} scatters captured")
    for key in samples:
        (v, t), _ = cap.seen[key]
        img = v.detach()
        p, c = t.idx.shape[1], img.shape[1]
        twice_same("K7 bilinear", lambda: vx.devoxelize_trilinear(img, t))
        ms, pms, lib, lib_err, _ = devox_times(img, t)
        dev = device_ms(partial(vx.devoxelize_trilinear, img, t), KERNEL_NAMES["devoxelize"])
        rows = int(torch.unique(t.idx[t.idx >= 0]).numel())
        b, _ = bound_ms(4 * p * 8 + rows * c * 4 + p * c * 4, 7.0 * p * c, "float32")
        log(
            f"K7 bilinear (range_to_point) P={p} pixels={img.shape[0]} ({rows} read) C={c} f32 "
            f"x{cap.count[key]}/scan: bit-identical, kernel {ms:.4f} ms device {fmt_ms(dev)} "
            f"plain {pms:.4f} ms embedding_bag {lib:.4f} ms (max|diff| {lib_err:.3e}) "
            f"bound {b:.4f} ms (bytes)"
        )
        _add(k7, ms=ms, plain_ms=pms, bound_ms=b, library_ms=lib, device_ms=dev)
        # its backward: K6 over the 4P (corner, pixel) pairs, weighted
        g = torch.randn(p, c, device="cuda", generator=gen)
        w = t.weights.reshape(-1)
        _k6_check(f"K6 over the 4P corner pairs (sample backward) pixels={img.shape[0]} C={c}",
                  (g, t.pairs, w), k6)
    for key in scatters:
        (z, ids, tables, h, w_), _ = cap.seen[key]
        z = z.detach()
        _k6_check(f"K6 over the pixel tables (scatter forward) {h}x{w_} C={z.shape[1]}",
                  (z, tables, None), k6)
        v, c = h * w_, z.shape[1]
        g = torch.randn(v, c, device="cuda", generator=gen)
        r = k8_call(f"K8 scatter backward (point_to_range) pixels {h}x{w_}", g, ids, tables.counts)
        _add(k8, **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms", "old_ms")})
    results["devoxelize_bilinear"] = dict(k7, bound_by="bytes", device_ms_per_scan=k7["device_ms"])
    results.setdefault("segment_sum", {})["rpvnet_pixel_tables"] = dict(k6, bound_by="bytes")
    results.setdefault("voxelize_bwd", {})["rpvnet_pixel_tables"] = dict(k8, bound_by="bytes")
    log(
        "rpvnet point <-> range kernels per step: "
        + "; ".join(f"{n} kernel {t['ms']:.4f} ms device {fmt_ms(t['device_ms'])} bound {t['bound_ms']:.4f} "
                    f"plain {t['plain_ms']:.4f} library {t['library_ms']:.4f}"
                    for n, t in (("K7 bilinear x4", k7), ("K6 pixel/pair x7", k6), ("K8 pixel x3", k8)))
    )


def _k6_check(label, args, tot, count: int = 1, profile: bool = True) -> None:
    """K6 on one call's (src, tables, weights): against its plain version
    in f64, bit-identical on repeat, with kernel, device (where
    `profile`), plain, bound and `index_add_` times added to `tot`,
    `count` times."""
    from taseg_tpu_torch.ops import voxelize as vx

    x, t, w = args
    w64 = None if w is None else w.double()
    got = twice_same(label, lambda: vx.segment_sum(x, t, w))
    want = vx.segment_sum_plain(x.double(), t, w64)
    ref = vx.segment_sum_plain(x.double().abs(), t, None if w is None else w64.abs())
    err = check_close(label, got, want, ref, "float32", 1e-5)
    limit = 1e-5 * ref.abs().max().item()
    ms = cuda_ms(lambda: vx.segment_sum(x, t, w))
    pms = cuda_ms(lambda: vx.segment_sum_plain(x, t, w), iters=3)
    dev, lib_dev = (
        yardstick_devices("segment_sum", partial(vx.segment_sum, x, t, w), (x, t, w), {}, x, None)
        if profile else (None, None)
    )
    nbytes, ops, lib = train_cost("segment_sum", (x, t, w), {}, x, None)
    b, by = bound_ms(nbytes, ops, "float32")
    old_b, _ = bound_ms(k6_bytes(x, t, w)[1], ops, "float32")
    log(
        f"{label}: max|err| {err:.3e} (limit {limit:.3e}; bit-identical on repeat), kernel {ms:.4f} ms device "
        f"{fmt_ms(dev)} plain {pms:.4f} ms index_add_ {lib:.4f} ms (device {fmt_ms(lib_dev)}) "
        f"bound {b:.4f} ms ({by}; sentinel-inclusive count {old_b:.4f} ms)"
        + (" SLOWER than index_add_" if ms > lib else "")
    )
    _add(tot, ms=count * ms, plain_ms=count * pms, bound_ms=count * b, library_ms=count * lib,
         device_ms=mscale(count, dev), max_abs_err=err)
    tot["library_device_ms"] = msum(tot.get("library_device_ms", 0.0), mscale(count, lib_dev))


def _leaves(a):
    """A captured argument as fresh leaves: floating tensors detached,
    copied and asking for a gradient, tuples element by element."""
    import torch

    if isinstance(a, tuple):
        return tuple(_leaves(x) for x in a)
    if torch.is_tensor(a) and a.is_floating_point():
        return a.detach().clone().requires_grad_()
    return a


def range_branch_ms(model, runs, train: bool) -> None:
    """What RPVNet's range branch (its four 2D stages, f32 convs on the
    card's CUDA cores, TF32 off) costs: CUDA events around each stage's
    forward, from hooks, over real forwards; in train mode also its
    backward, replayed stage by stage from the inputs and the output
    shapes one real step gave them (cotangents drawn from a seed; the
    replays update the stages' BN statistics and gradients, so this runs
    after the counted steps)."""
    import numpy as np
    import torch

    mods = {n: getattr(model, n) for n in RANGE_MODULES}
    ev, seen, handles = {}, {}, []
    for n, m in mods.items():
        def pre(mod, args, n=n):
            seen.setdefault(n, args)
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.setdefault(n, []).append([e])

        def post(mod, args, out, n=n):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev[n][-1].append(e)

        handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    try:
        for run in runs:
            run()
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    fwd = {n: float(np.median([a.elapsed_time(b) for a, b in ev[n]])) for n in mods}
    msg = f"rpvnet range branch forward ({'train' if train else 'eval'}, medians over {len(ev['range_stem'])}): " + ", ".join(
        f"{n} {ms:.3f} ms" for n, ms in fwd.items()) + f"; total {sum(fwd.values()):.3f} ms"
    if train:
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        bwd = {}
        for n, m in mods.items():
            args = _leaves(tuple(seen[n]))
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            times = []
            for _ in range(3):
                out = m(*args)
                outs = out if isinstance(out, tuple) else (out,)
                flat = [o for x in outs for o in (x if isinstance(x, tuple) else (x,))]
                grads = [torch.randn(o.shape, device="cuda", generator=gen) for o in flat]
                e0.record()
                torch.autograd.backward(flat, grads)
                e1.record()
                e1.synchronize()
                times.append(e0.elapsed_time(e1))
            bwd[n] = float(np.median(times))
        msg += "; backward (replayed) " + ", ".join(f"{n} {ms:.3f} ms" for n, ms in bwd.items()) + f"; total {sum(bwd.values()):.3f} ms"
    log(msg)


def rpv_context_cost(seg, scans, rounds: int = 2) -> None:
    """What the RpvContext (the point <-> range tables at 3 scales:
    pixel ids and their segment tables, bilinear tables) adds to the
    serving and the train topology: `rpv_inputs` alone after the UNet
    topology (CUDA events), medians."""
    import numpy as np
    import torch

    from taseg_tpu_torch.models.fusion.rpvnet import rpv_inputs
    from taseg_tpu_torch.models.voxel.backbone_context import build_unet_topology, host_nonneg

    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ms = {}
    batches = [seg.collate([s]) for s in scans]
    for _ in range(rounds):
        for a in batches:
            for pairs in (False, True):
                e[0].record()
                topo = build_unet_topology(
                    a["point_coords_t"], a["num_points_t"], seg.caps, devox_pairs=pairs,
                    assume_sorted_points=True, point_voxel_strides=seg.model.point_voxel_strides,
                    nonneg_coords=host_nonneg(a["point_coords"]),
                )
                e[1].record()
                rpv_inputs(topo, a, with_pairs=pairs)
                e[2].record()
                e[2].synchronize()
                ms.setdefault(pairs, []).append((e[0].elapsed_time(e[1]), e[1].elapsed_time(e[2])))
    for pairs, v in ms.items():
        u, r = np.median([x[0] for x in v]), np.median([x[1] for x in v])
        log(f"rpvnet {'train' if pairs else 'serving'} topology: UNet {u:.3f} ms + RpvContext {r:.3f} ms (medians of {len(v)})")


def phase_rpvnet(scans, results: dict) -> dict:
    """RPVNet mk18 cr1.0 at full width in bf16 (the range branch in f32,
    as in JAX), seeded weights, on the same scans with 64 x 2048 range
    images: `Segmenter.predict` with every launch count set to 0 just
    before and read just after (each kernel as RPVNET_PER_SCAN says),
    finite logits of the right shape, bf16/f32 argmax agreement >= 0.97,
    the small-scan card f32 logits against the CPU, serving ms per scan
    by stage, the RpvContext's share of the topology and the range
    branch's forward; then the train path: the inputs of one real step's
    point <-> range calls, a small-scan f32 step on the card against the
    CPU (dropout off on both), TRAIN_STEPS counted `Trainer` steps (each
    kernel as RPVNET_PER_STEP says), ms per step by stage, peak memory,
    the range branch's forward and backward; then K7 at 4 corners, K6 and
    K8 at the captured calls (`phase_rpv_kernels`) and each kernel's
    device time per step.  Returns the launches per scan and per step
    and the device ms per step."""
    import numpy as np
    import torch

    from taseg_tpu_torch.configs import RPVNET_MK18_CR10
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.models import RPVNet
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    cfg = RPVNET_MK18_CR10
    params, stats = init_params_numpy(cfg, seed=SEED)
    variables = {"params": params, "batch_stats": stats}
    seg = Segmenter(cfg, variables, compute_dtype="bfloat16")
    if not isinstance(seg.model, RPVNet):
        raise AssertionError(f"rpvnet: Segmenter built {type(seg.model).__name__}")
    torch.cuda.synchronize()
    _build.reset_launches()
    out = seg.predict(scans)
    torch.cuda.synchronize()
    serve = dict(_build.LAUNCHES)
    log(f"rpvnet serving launches over {len(scans)} scans: {serve}")
    check_launches(serve, RPVNET_PER_SCAN, len(scans), "rpvnet serving")
    for s, o in zip(scans, out):
        if o["logits"].shape != (s["xyzret"].shape[0], cfg["MODEL"]["NUM_CLASS"]):
            raise AssertionError(f"rpvnet logits shape {o['logits'].shape}")
        if not np.isfinite(o["logits"]).all():
            raise AssertionError("rpvnet: non-finite logits")
    out32 = Segmenter(cfg, variables, compute_dtype="float32").predict(scans)
    agree = float(np.mean(np.concatenate([a["labels"] == b["labels"] for a, b in zip(out, out32)])))
    log(f"rpvnet bf16 vs f32 per-point argmax agreement {agree:.5f}")
    if agree < 0.97:
        raise AssertionError(f"rpvnet bf16/f32 argmax agreement {agree:.4f} < 0.97")
    del out32
    small_scan_check(cfg, variables, "rpvnet ")
    serve_split(seg, scans, RPVNET_ROUNDS, "rpvnet ")
    rpv_context_cost(seg, scans)
    batches = [seg.collate([s]) for s in scans]
    range_branch_ms(seg.model, [partial(seg.forward, a, seg.topology(a)) for a in batches], False)
    del batches

    trainer = Trainer(
        cfg, variables, iters_per_epoch=TRAIN_STEPS,
        total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], compute_dtype="bfloat16", seed=SEED,
    )
    cap = rpv_calls(trainer, scans)
    phase_small_train_step(cfg, variables, "rpvnet ", no_dropout=True)
    train, _ = phase_train_steps(trainer, scans, RPVNET_PER_STEP, "rpvnet train")
    del seg
    range_branch_ms(trainer.model, [partial(trainer.step, [s]) for s in scans], True)
    phase_rpv_kernels(cap, results)
    del cap
    rpv: dict = {}
    phase_train_profile(trainer, scans, rpv, "rpvnet ")
    del trainer
    torch.cuda.empty_cache()
    return {
        "per_scan": {k: n // len(scans) for k, n in serve.items()},
        "per_step": {k: n // TRAIN_STEPS for k, n in train.items()},
        "device_ms_per_step": {k: v["device_ms_per_step"] for k, v in rpv.items()},
        "launches": serve,
    }

def cylinder_calls(run) -> CallCapture:
    """`run()` (a Segmenter forward or a Trainer step) with the wrappers
    of K2 and K4 at K offsets wrapped: the inputs of every forward,
    input-gradient and weight-gradient call (with the topology's row
    order or pair lists) at each distinct (kind, K, V_in, C_in, V_out,
    C_out)."""
    from taseg_tpu_torch.ops import f3conv, sparse_conv

    def key(x, w, rb, dgrad=False, order=None):
        return ("sparse_conv_k" + ("_dgrad" if dgrad else ""), rb.shape[0], x.shape[0], w.shape[1],
                rb.shape[1], w.shape[2])

    cap = CallCapture()
    cap.patch(sparse_conv, "sparse_conv", key)
    cap.patch(f3conv, "sparse_conv", key)
    cap.patch(
        f3conv, "sparse_conv_dw",
        lambda x, g, rb, out_dtype=None, pairs=None: ("sparse_conv_dw", rb.shape[0], *x.shape, *g.shape),
    )
    run()
    cap.remove()
    return cap


def cuda_core_k(name: str, x, second, rb):
    """The CUDA-core kernel of K2 at K (`taseg_sparse_conv_k`) or K4
    at K (`taseg_sparse_conv_dw`) on the same f32 inputs, called through
    its C entry (no wrapper, so no launch is counted)."""
    import torch

    from taseg_tpu_torch.ops import _build, f3conv

    lib = _build.get_lib()
    stream = torch.cuda.current_stream().cuda_stream
    k = rb.shape[0]
    if name == "sparse_conv_dw":
        v_in, c_in = x.shape
        c_out = second.shape[1]
        out = torch.empty((k, c_in, c_out), device=x.device)
        splits, rows = f3conv.dw_splits(v_in, k, c_in, c_out)
        part = torch.empty((splits, k, c_in, c_out), device=x.device) if splits > 1 else None
        err = lib.taseg_sparse_conv_dw(
            x.data_ptr(), second.data_ptr(), rb.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), v_in, c_in, c_out, k, splits, rows, 0, stream,
        )
    else:
        c_in, c_out = x.shape[1], second.shape[2]
        second = second.contiguous()  # an input gradient's W^T comes as a view of W
        out = torch.empty((rb.shape[1], c_out), device=x.device)
        err = lib.taseg_sparse_conv_k(
            x.data_ptr(), second.data_ptr(), rb.data_ptr(), out.data_ptr(), rb.shape[1],
            c_in, c_out, k, 0, stream,
        )
    if err:
        raise RuntimeError(f"CUDA-core {name} failed with CUDA error {err}")
    return out


def tf32_mma_call(x, w, rb, order, splits: int):
    """The mma.sync 3xTF32 tile that the wgmma tile replaced (K2 at K and
    K3 in f32), at one call, through its C entry (counted nowhere): x
    (V_in, C_in) and w (K, C_in, C_out) f32 at their logical widths, padded
    here to 4s as the wrappers pad them, rb (K, V_out) and its order,
    `splits` parts per tile chain.  Returns the (V_out, C_out) output."""
    import torch

    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops.sparse_conv import mask_row_order, pad_cols, pad_weight, padded_width

    k, v_out = rb.shape
    c_in, c_out = w.shape[1], w.shape[2]
    ci, co = padded_width(torch.float32, c_in), padded_width(torch.float32, c_out)
    xp, wp = pad_cols(x, ci), pad_weight(w, ci, co).contiguous()
    order = mask_row_order(rb) if order is None else order
    out = torch.empty((v_out, c_out), device=x.device)
    part = live = None
    if splits > 1:
        part = torch.empty((splits - 1, v_out, co), device=x.device)
        live = torch.empty((splits - 1, -(-v_out // 64)), dtype=torch.int32, device=x.device)
    _build.launch("taseg_sparse_conv_k_tf32_mma", (), xp.data_ptr(), wp.data_ptr(), rb.data_ptr(),
                  order.data_ptr(), out.data_ptr(), None if part is None else part.data_ptr(),
                  None if live is None else live.data_ptr(), v_out, ci, co, k, splits, c_out)
    return out


def tf32_yardsticks(label: str, kern, x, w, rb, order, splits: int, want, ref, rel: float,
                    fresh: bool, old_device: bool = False) -> dict:
    """The 3xTF32 wgmma tile's times at one f32 call of K2 at K or K3
    (`kern`, through its wrapper) beside the mma.sync tile it replaced
    (`tf32_mma_call`, held to the same tolerance): `ms` (cuda_ms), `device_ms`
    (the profiler, the weight's split included where it runs) and `old_ms`
    (and, with `old_device`, the mma.sync tile's device time,
    `old_device_ms`).
    `fresh`: the call splits its weight every time, as a train step's
    calls do (the weight takes a gradient, or is a new view); else the
    weight keeps its split operand, as a served weight does, and that
    operand is held bit for bit against `sparse_conv.tf32_split_plain`."""
    import torch

    from taseg_tpu_torch.ops import sparse_conv

    mma_err = check_close(f"{label} mma.sync tile", tf32_mma_call(x, w, rb, order, splits), want, ref,
                          "float32", rel)
    if fresh:
        grad_w = w.detach().requires_grad_()
        run = lambda: kern(grad_w)  # noqa: E731
    else:
        run = lambda: kern(w)  # noqa: E731
        run()
        # the split kernel's operand, kept beside the weight (or its padded
        # copy), against its plain version, bit for bit
        held = w if hasattr(w, "_taseg_tf32") else getattr(w, "_taseg_padded", (None, None))[1]
        if held is None or not torch.equal(held._taseg_tf32[1], sparse_conv.tf32_split_plain(held)):
            raise AssertionError(f"{label}: the weight's kept 3xTF32 operand differs from tf32_split_plain")
    old = lambda: tf32_mma_call(x, w, rb, order, splits)  # noqa: E731
    r = {
        "ms": cuda_ms(run), "device_ms": device_ms(run, KERNEL_NAMES["sparse_conv_k"], iters=5),
        "old_ms": cuda_ms(old), "old_max_abs_err": mma_err,
    }
    if old_device:
        r["old_device_ms"] = device_ms(old, ("k_tf32_mma_kernel", "sparse_conv_k_tf32_reduce"), iters=5)
    return r


def phase_cylinder_kernels(cap: CallCapture, label: str, bf16: bool = True, train: bool = False,
                           old_device: bool = False) -> dict:
    """K2 and K4 at K offsets (the 3^3 head's at K = 27 among them) at
    every call of the captured forward or train step, on the call's own
    f32 inputs and the topology's row order / pair lists: the 3xTF32
    kernel against its plain version (the convs within 1e-5 of the
    largest sum of |terms|, the weight gradients within 1e-4: they sum up
    to all V rows in another order) and bit-identical on a repeat call;
    the CUDA-core kernel (`cuda_core_k`) and the mma.sync 3xTF32 tiles
    that the wgmma tiles replaced (`tf32_mma_call` for the convs,
    `old_dw_tf32` for the weight gradients) on the same inputs, held to
    the same tolerances.  Times: kernel (`cuda_ms`; a conv of a `train`
    capture splits its weight every call, as a train step does, a served
    one keeps the split operand), device (profiler), the mma.sync tile
    (`old_ms`; its device time too for the weight gradients, and with
    `old_device` for the convs), the CUDA-core kernel, plain,
    two bounds (bytes: inputs read once, output written once; operations:
    the rulebook's present pairs at the f32 CUDA-core rate, and at
    3xTF32's 494.7 / 3 TFLOP/s) and library (one torch.mm on rows
    gathered beforehand), summed over the calls by their count; a call
    slower than its torch.mm is named.  The convs also run once in bf16
    at the same shapes (their tensor-core route where the widths allow
    it), for correctness only: no path calls them in bf16 (`bf16` False
    leaves that out).  Returns the totals by kind (`sparse_conv_k`,
    `sparse_conv_k_dgrad`, `sparse_conv_dw`), each with a `head` part of
    its K = 27 calls; a device total holding a call not measured is
    None."""
    import torch

    from taseg_tpu_torch.ops import f3conv, sparse_conv

    tot: dict = {}
    for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name, k, v_in, c_in, v_out, c_out = key
        count = cap.count[key]
        x, second, rb = a[0], a[1], a[2]
        if name != "sparse_conv_dw":  # a conv's input at its weight's C_in (its Function padded it)
            x = x[:, : second.shape[1]].contiguous()
        pairs = int((rb >= 0).sum())
        route = sparse_conv.k_route(x.dtype, c_in, c_out)
        if route != "tf32x3":
            raise AssertionError(f"{label}{key}: route {route}, expected tf32x3")
        dgrad = name == "sparse_conv_k_dgrad"
        if name == "sparse_conv_dw":
            lists = kw.get("pairs")
            kern = lambda: f3conv.sparse_conv_dw(x, second, rb, pairs=lists)  # noqa: E731
            plain, rel = f3conv.k3_conv_dw_plain, 1e-4
            nbytes = (v_in * c_in + v_out * c_out + rb.numel() + k * c_in * c_out) * 4
        else:
            order = kw.get("order")
            kern = lambda: sparse_conv.sparse_conv(x, second, rb, dgrad=dgrad, order=order)  # noqa: E731
            plain, rel = sparse_conv.sparse_conv_plain, 1e-5
            nbytes = (v_in * c_in + second.numel() + rb.numel() + v_out * c_out) * 4
        want = plain(x, second, rb)
        ref = plain(x.abs(), second.abs(), rb)
        got = twice_same(f"{label}{key}", kern)
        err = check_close(f"{label}{key}", got, want, ref, "float32", rel)
        core_err = check_close(
            f"{label}{key} CUDA-core", cuda_core_k(name, x, second, rb), want, ref, "float32", rel
        )
        share = err / max(ref.abs().max().item(), 1e-30)  # of the largest sum of |terms|
        if name == "sparse_conv_dw":
            t = {"ms": cuda_ms(kern), "device_ms": device_ms(kern, KERNEL_NAMES[name], iters=5),
                 **old_tf32_dw_times(f"{label}{key}", partial(old_dw_tf32, x, second, rb, lists), want, ref)}
        else:
            t = tf32_yardsticks(
                f"{label}{key}", lambda w: sparse_conv.sparse_conv(x, w, rb, dgrad=dgrad, order=order),
                x, second, rb, order, sparse_conv.k_splits(v_out), want, ref, rel, fresh=train,
                old_device=old_device,
            )
        del got, want, ref
        extra = (f"3xTF32 max|err| {err:.3e} "
                 f"({share:.2e} of the largest sum of |terms|, limit {rel:.0e}), CUDA-core {core_err:.3e}"
                 + (f", mma.sync tile {t['old_max_abs_err']:.3e}" if "old_ms" in t else "")
                 + ", bit-identical on repeat")
        if name == "sparse_conv_k" and bf16:
            xb, wb = x.bfloat16(), second.bfloat16()
            berr = check_close(f"{label}{key} bf16", sparse_conv.sparse_conv(xb, wb, rb), plain(xb, wb, rb),
                               plain(xb.abs(), wb.abs(), rb), "bfloat16", 1e-5)
            extra += f"; bf16 route {sparse_conv.k_route(torch.bfloat16, c_in, c_out)} max|err| {berr:.3e}"
        base = "sparse_conv_k" if dgrad else name
        lib = (dw_library_ms if name == "sparse_conv_dw" else conv_library_ms)(base, x, second, rb)
        ms = t["ms"]
        core_ms = cuda_ms(lambda: cuda_core_k(name, x, second, rb))
        pms = cuda_ms(lambda: plain(x, second, rb), iters=3)
        ops = 2.0 * pairs * c_in * c_out
        b, by = bound_ms(nbytes, ops, "float32")
        b3, by3 = bound_ms(nbytes, ops, "tf32x3")
        slow = " SLOWER than torch.mm" if ms > lib else ""
        log(
            f"{label}{name} K={k} V_in={v_in} {c_in}->{c_out} V_out={v_out} x{count} "
            f"pairs={pairs} ({extra}) kernel {ms:.4f} ms (device {fmt_ms(t['device_ms'])}"
            + ("" if name == "sparse_conv_dw" or not train else ", the weight split every call")
            + ")" + (f" mma.sync tile {t['old_ms']:.4f} ms" if "old_ms" in t else "")
            + (f" (device {fmt_ms(t['old_device_ms'])})" if "old_device_ms" in t else "")
            + f" CUDA-core {core_ms:.4f} ms plain {pms:.4f} ms "
            f"bound {b:.4f} ms ({by}, f32 CUDA cores) / {b3:.4f} ms ({by3}, 3xTF32) "
            f"one torch.mm {lib:.4f} ms{slow}"
        )
        parts = [tot.setdefault(name, {})]
        if k == 27:
            parts.append(parts[0].setdefault("head", {}))
        vals = [("ms", ms), ("cuda_core_ms", core_ms), ("plain_ms", pms), ("bound_ms", b),
                ("bound_ms_3xtf32", b3), ("library_ms", lib)]
        if "old_ms" in t:
            vals.append(("old_ms", t["old_ms"]))
        for r in parts:
            for kk, val in vals:
                r[kk] = r.get(kk, 0.0) + count * val
            r["device_ms"] = msum(r.get("device_ms", 0.0), mscale(count, t["device_ms"]))
            if "old_device_ms" in t:
                r["old_device_ms"] = msum(r.get("old_device_ms", 0.0), mscale(count, t["old_device_ms"]))
            for kk, val in ((by, b), (by3 + "_3xtf32", b3)):
                r.setdefault("_parts", {})[kk] = r.get("_parts", {}).get(kk, 0.0) + count * val
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
            r["max_err_share"] = max(r.get("max_err_share", 0.0), share)
            r["cuda_core_max_abs_err"] = max(r.get("cuda_core_max_abs_err", 0.0), core_err)
            if "old_ms" in t:
                r["old_max_abs_err"] = max(r.get("old_max_abs_err", 0.0), t["old_max_abs_err"])
            r["calls"] = r.get("calls", 0) + count
    for r in tot.values():
        for q in (r, r.get("head")):
            if q is None:
                continue
            parts = q.pop("_parts")
            q["bound_by"] = "bytes" if parts.get("bytes", 0) >= parts.get("operations", 0) else "operations"
            q["bound_by_3xtf32"] = (
                "bytes" if parts.get("bytes_3xtf32", 0) >= parts.get("operations_3xtf32", 0) else "operations"
            )
    for name, r in sorted(tot.items()):
        log(f"{label}{name} over {r['calls']} calls: kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])})"
            + (f" mma.sync tile {r['old_ms']:.4f} ms" if "old_ms" in r else "")
            + (f" (device {fmt_ms(r['old_device_ms'])})" if "old_device_ms" in r else "")
            + f" CUDA-core {r['cuda_core_ms']:.4f} ms bound {r['bound_ms_3xtf32']:.4f} ms (3xTF32) one torch.mm "
            f"{r['library_ms']:.4f} ms")
    return tot


def cylinder_table_cost(topo, label: str) -> None:
    """What the 3xTF32 route adds to a Cylinder topology: the row order of
    each table (`mask_row_order`) and, in a train topology, the pair
    lists of each reverse table (`pair_lists`), rebuilt from its
    rulebooks (CUDA events, `cuda_ms`), and each rebuild equal to the
    topology's."""
    import torch

    from taseg_tpu_torch.ops.f3conv import pair_lists, pair_lists_many
    from taseg_tpu_torch.ops.sparse_conv import mask_row_order, mask_row_orders

    fwd = [t for l in topo.levels for t in (*l.asym, l.down, l.up) if t is not None]
    fwd += [*topo.recon, topo.head]
    rev = [t for t in fwd if t.pairs is not None]
    if topo.head_bwd is not None:
        rev += [t for l in topo.levels for t in l.asym_bwd] + [*topo.recon_bwd, topo.head_bwd]
    for t in fwd:
        if not torch.equal(mask_row_order(t.rb), t.order):
            raise AssertionError(f"{label}: a row order differs from its rebuild")
    for t in rev:
        p = pair_lists(t.rb)
        n, at = int(p.starts[-1]), int(t.pairs.starts[0])  # the table's place in its buffer
        if not (torch.equal(p.pairs[:n], t.pairs.pairs[at : at + n])
                and torch.equal(p.starts, t.pairs.starts - at)):
            raise AssertionError(f"{label}: pair lists differ from their rebuild")
    def tile_work(present):  # 64 x the offsets each 64-row tile runs
        k, v = present.shape
        pad = torch.zeros((k, -v % 64), dtype=torch.bool, device=present.device)
        return 64 * int(torch.cat([present, pad], 1).view(k, -1, 64).any(2).sum())

    n_pairs = by_table = by_order = 0
    for t in fwd:
        present = t.rb >= 0
        n_pairs += int(present.sum())
        by_table += tile_work(present)
        by_order += tile_work(present[:, t.order.long()])
    log(
        f"{label}tiles: 64-row tiles run {by_table / n_pairs:.3f}x the {n_pairs} present pairs "
        f"in table order, {by_order / n_pairs:.3f}x over the mask-sorted row order"
    )
    orders = cuda_ms(lambda: mask_row_orders([t.rb for t in fwd]))
    lists = cuda_ms(lambda: pair_lists_many([t.rb for t in rev])) if rev else 0.0
    log(
        f"{label}tables: {len(fwd)} row orders {orders:.4f} ms, {len(rev)} pair lists "
        f"{lists:.4f} ms, built as the topology builds them (one sort and one list buffer "
        f"per row count; CUDA events, host cost per launch included)"
    )


def cylinder_serve_profile(seg, scans, out: dict) -> None:
    """Device time per scan of Cylinder's serving (topology + forward) by
    kernel (torch.profiler device events over the scans): the hand
    kernels by name, the busy total, and the largest other kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batches = [seg.collate([s]) for s in scans]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for a in batches:
            seg.forward(a, seg.topology(a))
        torch.cuda.synchronize()
    n = len(batches)
    dev = {k: 0.0 for k in KERNEL_NAMES}
    busy = 0.0
    others = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU or e.is_user_annotation:
            continue
        ms = e.self_device_time_total / 1e3 / n
        busy += ms
        if named(e.key, OLD_K9K10_KERNELS):
            raise AssertionError(f"cylinder serving launched a first-design K10 kernel: {e.key}")
        mine = [k for k, frags in KERNEL_NAMES.items() if named(e.key, frags)]
        for k in mine:
            dev[k] += ms
        if not mine:
            others.append((ms, e.count / n, e.key[:90]))
    for k in ("join_scan", "sparse_conv_k", "segment_max"):
        log(f"cylinder profiler serving {k}: {dev[k]:.4f} ms per scan on the device")
        out[k] = dev[k] or None
    others.sort(reverse=True)
    log(
        f"cylinder profiler serving: all kernels {busy:.4f} ms per scan; other kernels "
        f"{sum(o[0] for o in others):.4f} ms in {sum(o[1] for o in others):g} launches; the largest:"
    )
    for ms, c, name in others[:8]:
        log(f"  {ms:.4f} ms x{c:g} {name}")


def permute_rows_ms(trainer, scans) -> None:
    """`loss.util.permute_rows` (plain torch: one `take_along_dim` each
    way) at the calls of one real Cylinder train step (the Lovász loss's
    sorted errors, with a backward, and sorted labels): host-clock and
    device time of each call's forward (and of the errors' forward +
    backward), beside its bound (bytes: x, the permutation and the output
    once each; the backward reads the cotangent and the inverse and
    writes the gradient) and one `take_along_dim` of the same rows
    (`library_ms` of its table row)."""
    import torch

    from taseg_tpu_torch.loss import lovasz

    cap = CallCapture()
    cap.patch(lovasz, "permute_rows", lambda x, perm, inv: ("permute_rows", *x.shape, x.requires_grad))
    trainer.step(scans[:1])
    cap.remove()
    for key, (a, _) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        x, perm, inv = (t.detach() for t in a)
        grad = key[-1]
        xg = x.clone().requires_grad_(grad)

        def fwd():
            lovasz.permute_rows(x, perm, inv)

        def fwd_bwd():
            lovasz.permute_rows(xg, perm, inv).sum().backward()

        nbytes = x.numel() * (2 * x.element_size() + perm.element_size())
        b, _ = bound_ms(nbytes * (2 if grad else 1), 0, "float32")
        both = (f", forward + backward {cuda_ms(fwd_bwd):.4f} ms (device "
                f"{fmt_ms(device_ms(fwd_bwd, ('',)))})" if grad else "")
        lib = cuda_ms(lambda: torch.take_along_dim(x, perm, 0))
        log(
            f"cylinder permute_rows {tuple(x.shape)} x{cap.count[key]}: forward {cuda_ms(fwd):.4f} ms "
            f"(device {fmt_ms(device_ms(fwd, ('',)))}){both}; bound {b:.4f} ms (bytes); one "
            f"take_along_dim {lib:.4f} ms"
        )


def phase_cylinder(scans, results: dict) -> dict:
    """Cylinder_TS cy480 cr1.0 at full width (INIT_SIZE 32, the 480 x 360
    x 32 polar grid) in f32, seeded weights, on the same scans:
    `Segmenter.predict` with every launch count set to 0 just before and
    read just after (each kernel as CYLINDER_PER_SCAN says, every other
    0), finite logits of the right shape, the level counts beside their
    capacities, the small-scan card f32 logits against the CPU, serving ms
    per scan by stage and each kernel's device time per scan; K2 at K at
    every call of a real forward against its plain version and the
    CUDA-core kernel (`phase_cylinder_kernels`), and what the row orders
    cost; then the train path: the inputs of every K2 / K4 call of one
    real step checked the same way (the input gradients and weight
    gradients), what the orders and pair lists cost, a small-scan f32
    step on the card against the CPU, TRAIN_STEPS counted `Trainer` steps
    (each kernel as CYLINDER_PER_STEP says), ms per step by stage, peak
    memory, and each kernel's device time per step.  Logs the phase's
    seconds.  Returns the launches per scan and per step and the device
    ms."""
    import numpy as np
    import torch

    from taseg_tpu_torch.configs import CYLINDER_CY480_CR10
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.models import CylinderTS
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    t_phase = time.perf_counter()
    cfg = CYLINDER_CY480_CR10
    params, stats = init_params_numpy(cfg, seed=SEED)
    variables = {"params": params, "batch_stats": stats}
    seg = Segmenter(cfg, variables)
    if not isinstance(seg.model, CylinderTS):
        raise AssertionError(f"cylinder: Segmenter built {type(seg.model).__name__}")
    for s in scans:
        a = seg.collate([s])
        topo = seg.topology(a)
        log(
            f"cylinder serving rows {int(a['num_points'][0])}, level voxels "
            f"{[int(l.num) for l in topo.levels]} caps {list(seg.caps.voxels)}"
        )
    a = seg.collate(scans[:1])
    cap = cylinder_calls(lambda: seg.forward(a, seg.topology(a)))
    del a, topo
    torch.cuda.synchronize()
    _build.reset_launches()
    out = seg.predict(scans)
    torch.cuda.synchronize()
    serve = dict(_build.LAUNCHES)
    log(f"cylinder serving launches over {len(scans)} scans: {serve}")
    check_launches(serve, CYLINDER_PER_SCAN, len(scans), "cylinder serving")
    for s, o in zip(scans, out):
        if o["logits"].shape != (s["xyzret"].shape[0], cfg["MODEL"]["NUM_CLASS"]):
            raise AssertionError(f"cylinder logits shape {o['logits'].shape}")
        if not np.isfinite(o["logits"]).all():
            raise AssertionError("cylinder: non-finite logits")
    del out
    small_scan_check(cfg, variables, "cylinder ")
    serve_split(seg, scans, CYLINDER_ROUNDS, "cylinder ")
    serve_k = phase_cylinder_kernels(cap, "cylinder serving ", old_device=True)
    results["sparse_conv_k"] = serve_k["sparse_conv_k"]
    del cap
    a = seg.collate(scans[:1])
    cylinder_table_cost(seg.topology(a), "cylinder serving ")
    del a
    results["segment_max"] = phase_k10_cylinder(seg, scans)
    no_aten_op(lambda: seg.predict(scans[:1]), "scatter_reduce", "cylinder serving")
    serve_dev: dict = {}
    cylinder_serve_profile(seg, scans, serve_dev)
    del seg
    torch.cuda.empty_cache()

    trainer = Trainer(
        cfg, variables, iters_per_epoch=TRAIN_STEPS,
        total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], seed=SEED,
    )
    log(f"cylinder train capacities {list(trainer.caps.voxels)}")
    kept: dict = {}

    def step():
        # keep the step's topology for cylinder_table_cost
        topo_fn = trainer.topology
        trainer.topology = lambda arrays: kept.setdefault("topo", topo_fn(arrays))
        try:
            trainer.step(scans[:1])
        finally:
            del trainer.topology

    cap = cylinder_calls(step)
    train_k = phase_cylinder_kernels(
        CallCapture.only(cap, lambda key: key[0] != "sparse_conv_k"), "cylinder train ", train=True,
        old_device=True,
    )
    del cap
    for k in ("sparse_conv_k_dgrad", "sparse_conv_dw"):
        results[k] = train_k[k]
    cylinder_table_cost(kept.pop("topo"), "cylinder train ")
    permute_rows_ms(trainer, scans)
    phase_small_train_step(cfg, variables, "cylinder ")
    no_aten_op(lambda: trainer.step(scans[:1]), "scatter_reduce", "cylinder train step")
    per_step = {k: CYLINDER_PER_STEP.get(k, 0) for k in _build.LAUNCHES}
    train, _ = phase_train_steps(trainer, scans, per_step, "cylinder train")
    cyl: dict = {}
    phase_train_profile(trainer, scans, cyl, "cylinder ")
    del trainer
    torch.cuda.empty_cache()
    return {
        "per_scan": {k: n // len(scans) for k, n in serve.items()},
        "per_step": {k: n // TRAIN_STEPS for k, n in train.items()},
        "device_ms_per_step": {k: v["device_ms_per_step"] for k, v in cyl.items()},
        "device_ms_per_scan": serve_dev,
        "launches": serve,
        "train_launches": train,
        "seconds": time.perf_counter() - t_phase,
    }


def fsa_scans(n: int, n_points: int = N_POINTS, seed: int = SEED) -> list:
    """`n` samples of SyntheticMsKittiReader(n_points, history=FSA_HISTORY,
    kd=True): the frame, the fused cloud (`xyzret_ms`) and the KD teacher's
    GT-mask cloud (`xyzret_ms_gt`)."""
    from taseg_tpu_torch.data.synthetic import SyntheticMsKittiReader

    reader = SyntheticMsKittiReader(length=n, n_points=n_points, history=FSA_HISTORY, seed=seed, kd=True)
    return [reader[i] for i in range(n)]


def k6_voxelize_check(feats, tables, label: str) -> dict:
    """K6 at the voxelize forward of the fused cloud (C = 5: its odd
    width takes the kernel's path without 16-byte rows) against its plain
    version in f64 (1e-5 of the largest sum of |terms|), bit-identical on
    repeat, with kernel, plain, bound and `index_add_` times."""
    from taseg_tpu_torch.ops import voxelize

    got = twice_same(f"{label}K6 voxelize", lambda: voxelize.segment_sum(feats, tables))
    err = check_close(
        f"{label}K6 voxelize", got, voxelize.segment_sum_plain(feats.double(), tables),
        voxelize.segment_sum_plain(feats.double().abs(), tables), "float32", 1e-5,
    )
    ms = cuda_ms(lambda: voxelize.segment_sum(feats, tables))
    pms = cuda_ms(lambda: voxelize.segment_sum_plain(feats, tables), iters=3)
    nbytes, ops, lib = train_cost("segment_sum", (feats, tables), {}, feats, None)
    b, by = bound_ms(nbytes, ops, "float32")
    log(
        f"{label}K6 voxelize forward R={feats.shape[0]} V={tables.starts.shape[0] - 1} "
        f"C={feats.shape[1]} x1/scan: max|err| {err:.3e} (bit-identical on repeat) kernel "
        f"{ms:.4f} ms plain {pms:.4f} ms bound {b:.4f} ms ({by}) index_add_ {lib:.4f} ms"
    )
    return {"ms": ms, "plain_ms": pms, "bound_ms": b, "bound_by": by, "library_ms": lib, "max_abs_err": err}


def kd_steps(trainer, scans) -> tuple:
    """TRAIN_STEPS counted KD steps (every count set to 0 just before and
    read just after; finite losses, grad norm and parameters), then as
    many by stage: host, the student's topology, the teacher's topology,
    forward + loss (both models), backward, optimizer; and the teacher's
    forward alone.  Returns (launches, outputs, median ms per stage, peak
    GiB)."""
    import numpy as np
    import torch

    from taseg_tpu_torch.engine import check_capacity
    from taseg_tpu_torch.ops import _build

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    outs = [trainer.step(scans[i % len(scans): i % len(scans) + 1]) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    for i, o in enumerate(outs):
        log(
            f"kd step {i}: loss {o['loss']:.5f} (seg {o['loss_seg']:.5f}, feat kd "
            f"{o['loss_feat_kd']:.5f}) grad norm {o['grad_norm']:.4f} lr {o['lr']:.3e} "
            f"level voxels {o['level_nums']}"
        )
        if not all(np.isfinite(o[k]) for k in ("loss", "loss_seg", "loss_feat_kd", "grad_norm")):
            raise AssertionError(f"kd step {i}: a non-finite loss or grad norm")
    for n, p in trainer.model.named_parameters():
        if not torch.isfinite(p).all():
            raise AssertionError(f"kd: parameter {n} is not finite")
    names = ("host", "topology", "teacher_topology", "forward", "backward", "optimizer", "step")
    stages = {k: [] for k in names + ("teacher_forward",)}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        a = trainer.collate(scans[i % len(scans): i % len(scans) + 1])
        t1 = time.perf_counter()
        ev[0].record()
        topo = trainer.topology(a)
        check_capacity(topo, trainer.caps)
        ev[1].record()
        t_topo = trainer.teacher_topology(a)
        ev[2].record()
        loss = trainer.forward(a, topo, t_topo)
        ev[3].record()
        trainer.backward(loss)
        ev[4].record()
        trainer.update()
        ev[5].record()
        ev[5].synchronize()
        stages["step"].append((time.perf_counter() - t0) * 1e3)
        stages["host"].append((t1 - t0) * 1e3)
        for j, k in enumerate(names[1:6]):
            stages[k].append(ev[j].elapsed_time(ev[j + 1]))
        with torch.no_grad():
            stages["teacher_forward"].append(cuda_ms(
                lambda: trainer.teacher(a["teacher"]["point_feats_t"], t_topo, return_features=True),
                iters=1,
            ))
    med = {k: float(np.median(v)) for k, v in stages.items()}
    return launches, outs, med, peak


def fsa_entry(fsa: dict, name: str) -> dict:
    """A kernel's numbers on the FSA / KD path: its launches per serving
    scan, per FSA step and per KD step, and its times and error at the
    fused cloud's shapes (per scan at serving; per KD step for the
    backward kernels and the input gradients), where phase 5f held it."""
    keep = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    serve, kd = fsa["serve"].get(name), fsa["kd"].get(name, fsa["kd"].get(f"{name}_dgrad"))
    return {
        "launches_per_scan": fsa["per_scan"].get(name, 0),
        "launches_per_step": fsa["per_step"].get(name, 0),
        "kd_launches_per_step": fsa["kd_per_step"].get(name, 0),
        "serving_per_scan": {k: serve[k] for k in keep if k in serve} if serve else None,
        "kd_step": {k: kd[k] for k in keep if k in kd} if kd else None,
    }


def phase_fsa_kd() -> dict:
    """TASeg's temporal stages at full width in bf16, seeded weights:
    MinkUNetMs mk34 cr1.0 (the FSA recipe) on N_SCANS fused clouds of
    SyntheticMsKittiReader(N_POINTS, history=FSA_HISTORY) at the recipe's
    262 144 rows per scan.  Serving: each scan's level counts beside
    their capacities; K2 and K3 at every conv shape of a fused forward
    (twice the flagship's rows; the stem's C_in 5 on the wgmma tile, padded)
    and K6 at the voxelize forward (C = 5) against their plain versions,
    the head's K7 bit-identical, with their times; `Segmenter.predict`
    counted (each kernel as FSA_PER_SCAN says, K1 the same per scan), its
    frame-length labels, finite logits, bf16/f32 argmax agreement >=
    0.97, the small fused cloud's f32 logits against the CPU, serving ms
    per scan by stage.  Train: TRAIN_STEPS counted FSA steps
    (TRAIN_PER_STEP, K1 as serving's) by stage with peak memory; then the
    KD stage (MinkUNetMsKd, a teacher with other seeded weights): one real
    KD step's backward kernels and K7 forward calls (the 480-wide
    features: K7 at C = 256 / 128 / 96, their K6 backwards) against their
    plain versions (`phase_train_kernels`), TRAIN_STEPS counted KD steps
    (FSA's launches plus KD_TEACHER and the features' K7 3 and K6 3) by
    stage, the teacher's topology and forward apart, peak memory, and the
    teacher's parameters and buffers bit-identical after them.  Returns
    the launches per scan and per step and the kernels' numbers at these
    shapes; logs the phase's seconds."""
    import numpy as np
    import torch

    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10_FSA, MINKUNET_MK34_CR10_FSA_KD
    from taseg_tpu_torch.engine import Segmenter, Trainer, check_capacity, points_per_scan
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    t_phase = time.perf_counter()
    cfg, kd_cfg = MINKUNET_MK34_CR10_FSA, MINKUNET_MK34_CR10_FSA_KD
    params, stats = init_params_numpy(cfg, seed=SEED)
    variables = {"params": params, "batch_stats": stats}
    t0 = time.perf_counter()
    scans = fsa_scans(N_SCANS)
    log(
        f"fsa scans: {N_SCANS} x (frame {[len(s['xyzret']) for s in scans]}, fused "
        f"{[len(s['xyzret_ms']) for s in scans]}, gt {[len(s['xyzret_ms_gt']) for s in scans]} "
        f"points) in {time.perf_counter() - t0:.1f} s"
    )
    seg = Segmenter(cfg, variables, compute_dtype="bfloat16")
    if seg.point_capacity != points_per_scan(cfg) or seg.model.in_dim != 5:
        raise AssertionError(f"fsa: capacity {seg.point_capacity}, in_dim {seg.model.in_dim}")
    for s in scans:
        a = seg.collate([s])
        topo = seg.topology(a)
        nums = check_capacity(topo, seg.caps)
        log(
            f"fsa serving rows {int(a['num_points'][0])} of {seg.point_capacity}, level voxels "
            f"{nums} caps {list(seg.caps.voxels)} ({[round(n / c, 3) for n, c in zip(nums, seg.caps.voxels)]})"
        )
    a = seg.collate(scans[:1])
    topo = seg.topology(a)
    cap = Capture(seg.model)
    seg.forward(a, topo)
    cap.remove()
    fsa: dict = {}
    phase_convs(cap, fsa, [])
    del cap
    feats = a["point_feats_t"][:, : seg.model.in_dim].contiguous()
    fsa["segment_sum"] = k6_voxelize_check(feats, topo.point_tables, "fsa ")
    phase_point_ops(seg, a, topo, cfg["MODEL"]["NUM_CLASS"], fsa, [])
    del a, topo, feats

    torch.cuda.synchronize()
    _build.reset_launches()
    out = seg.predict(scans)
    torch.cuda.synchronize()
    serve = dict(_build.LAUNCHES)
    log(f"fsa serving launches over {N_SCANS} scans: {serve}")
    if serve["join_scan"] <= 0 or serve["join_scan"] % N_SCANS:
        raise AssertionError(f"fsa serving: join_scan launched {serve['join_scan']} times")
    per_scan = {**FSA_PER_SCAN, "join_scan": serve["join_scan"] // N_SCANS}
    check_launches(serve, per_scan, N_SCANS, "fsa serving")
    for s, o in zip(scans, out):
        if o["logits"].shape != (len(s["xyzret"]), cfg["MODEL"]["NUM_CLASS"]):
            raise AssertionError(f"fsa: logits {o['logits'].shape} for a {len(s['xyzret'])}-point frame")
        if not np.isfinite(o["logits"]).all():
            raise AssertionError("fsa: non-finite logits")
    log(f"fsa Segmenter.predict: frame-length labels {[len(o['labels']) for o in out]}")
    out32 = Segmenter(cfg, variables, compute_dtype="float32").predict(scans)
    agree = float(np.mean(np.concatenate([x["labels"] == y["labels"] for x, y in zip(out, out32)])))
    log(f"fsa bf16 vs f32 per-point argmax agreement {agree:.5f}")
    if agree < 0.97:
        raise AssertionError(f"fsa bf16/f32 argmax agreement {agree:.4f} < 0.97")
    del out, out32
    # a 4000-point frame with its history (~7600 fused points)
    small_scan_check(cfg, variables, "fsa ", fsa_scans(1, n_points=4000, seed=SEED + 1), 16384)
    serve_split(seg, scans, FSA_ROUNDS, "fsa ")
    del seg
    torch.cuda.empty_cache()

    trainer = Trainer(
        cfg, variables, iters_per_epoch=TRAIN_STEPS,
        total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], compute_dtype="bfloat16", seed=SEED,
    )
    log(f"fsa train capacities {list(trainer.caps.voxels)}")
    per_step = {**TRAIN_PER_STEP, "join_scan": per_scan["join_scan"]}
    train, train_med = phase_train_steps(
        trainer, scans, {k: per_step.get(k, 0) for k in _build.LAUNCHES}, "fsa train"
    )
    del trainer
    torch.cuda.empty_cache()

    kd = Trainer(
        kd_cfg, variables, iters_per_epoch=TRAIN_STEPS,
        total_epochs=kd_cfg["OPTIM"]["NUM_EPOCHS"], compute_dtype="bfloat16", seed=SEED,
    )
    t_params, t_stats = init_params_numpy(kd_cfg, seed=SEED + 1)
    kd.set_teacher(t_params, t_stats)
    teacher0 = {k: v.clone() for k, v in kd.teacher.state_dict().items()}
    log(f"kd capacities: student {list(kd.caps.voxels)} teacher {list(kd.teacher_caps.voxels)}")
    kd_cap = capture_train_calls(kd, scans[:1])
    kd_k: dict = {}
    phase_train_kernels(kd_cap, kd_k)
    del kd_cap
    kd_launch, _, kd_med, kd_peak = kd_steps(kd, scans)
    log(f"kd path launches over {TRAIN_STEPS} steps: {kd_launch}")
    kd_per_step = {k: per_step.get(k, 0) + KD_TEACHER.get(k, 0) for k in _build.LAUNCHES}
    kd_per_step["join_scan"] = 2 * per_scan["join_scan"]
    kd_per_step["devoxelize"] += 1
    kd_per_step["devoxelize_multi"] += 1
    kd_per_step["segment_sum"] += 3
    check_launches(kd_launch, kd_per_step, TRAIN_STEPS, "kd train")
    log(f"kd: launches per step as expected: {kd_per_step}")
    for k, v in kd.teacher.state_dict().items():
        if not torch.equal(v, teacher0[k]):
            raise AssertionError(f"kd: the teacher's {k} changed")
    log("kd: the teacher's parameters and buffers are bit-identical after the steps")
    log(
        f"kd ms per step (median of {TRAIN_STEPS}): " + ", ".join(f"{k} {v:.3f}" for k, v in kd_med.items())
        + f"; peak device memory {kd_peak:.2f} GiB"
    )
    del kd
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"fsa/kd phase (5f): {seconds:.1f} s")
    return {
        "per_scan": {k: n // N_SCANS for k, n in serve.items()},
        "per_step": {k: n // TRAIN_STEPS for k, n in train.items()},
        "kd_per_step": {k: n // TRAIN_STEPS for k, n in kd_launch.items()},
        "serve": fsa, "kd": kd_k, "train_ms": train_med, "kd_ms": kd_med, "seconds": seconds,
    }


TIAF_SCANS = 2
TIAF_STEPS = 3
# TIAF (tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr10_fsa_tiaf.yaml)
# in f32: per scan the main branch's 48 convs and the FOV branch's 17: 64
# on K2 at K = 27 offsets on the f32 3xTF32 route over the levels' row
# orders, the main stem's first (C_in 5) among them at C_in padded to 8;
# K3 4 +
# 4 per branch (K3-down and K3-up on K2 at K's 3xTF32 tile over each
# level's child and up tables: `strided_down_tf32`, `strided_up_tf32`), K6 at
# the two voxelizes, K7 in 5 multi-scale launches (3 of each before): the
# main head's, the main features', the FOV taps to the FOV points and to
# the main points (trilinear FOV -> main) and the image gathers (stem,
# decoder, logits); K1 at
# both topologies' joins (5 each) and the corner joins of the three
# FOV -> main tables.  A train step adds the input gradients (47 main,
# 17 FOV: the FOV stem's input, the image features, takes one), K4 at K =
# 27 (65), K3's input gradients and K5 per strided conv (K4 at K and K5
# on the f32 weight gradients' 3xTF32 wgmma tile, one kernel a call), K6 at the devoxelize backwards (13: the main head's
# one over its stacked pair tables, 3 for each cat's columns, the image
# gathers' over the pixel table among them) and K8 at the FOV stem's
# voxelize backward
TIAF_PER_SCAN = {
    "join_scan": 13, "sparse_conv_k3": 0, "sparse_conv_k": 65, "sparse_conv_k_tf32": 65,
    "strided_down": 8, "strided_down_tf32": 8, "strided_up": 8, "strided_up_tf32": 8,
    "segment_sum": 2, "devoxelize": 5, "devoxelize_multi": 5,
}
TIAF_PER_STEP = {
    "join_scan": 13, "sparse_conv_k3": 0, "k3_conv_dw": 0, "sparse_conv_k": 129,
    "sparse_conv_k_tf32": 129, "sparse_conv_k_dgrad": 64, "sparse_conv_k_dgrad_tf32": 64,
    "sparse_conv_dw": 65, "sparse_conv_dw_tf32": 65,
    "strided_down": 16, "strided_down_tf32": 16, "strided_down_dgrad": 8,
    "strided_down_dgrad_tf32": 8, "strided_up": 16, "strided_up_tf32": 16,
    "strided_up_dgrad": 8, "strided_up_dgrad_tf32": 8,
    "strided_dw": 16, "strided_dw_tf32": 16, "segment_sum": 15, "devoxelize": 5,
    "devoxelize_multi": 5, "voxelize_bwd": 1,
}
TIAF_BRANCHES = ("image_backbone", "lidar_backbone", "main")


def tiaf_scans(n: int, n_points: int = N_POINTS, seed: int = SEED, img=(384, 1280)) -> list:
    """`n` samples of SyntheticTiafReader(n_points, history=FSA_HISTORY,
    5 images of `img`): the fused cloud with its camera window."""
    from taseg_tpu_torch.data.synthetic import SyntheticTiafReader

    reader = SyntheticTiafReader(
        length=n, n_points=n_points, history=FSA_HISTORY, seed=seed, n_images=5,
        img_h=img[0], img_w=img[1],
    )
    return [reader[i] for i in range(n)]


def tiaf_route_call(seg, arrays) -> dict:
    """The main branch's second stem conv (level 0, 32 -> 32) at its real
    input and tables: K2 at 27 on the 3xTF32 route (over the level's
    row order) and the 27-offset CUDA-core K2 (`sparse_conv_k3`) on the
    same inputs, each within 1e-5 of the largest sum of |terms| of the
    plain version; the weight gradient of a seeded cotangent the same way
    (K4 at 27 over the pair lists, 3xTF32, against the CUDA-core K4,
    1e-4).  Kernel, plain, both bounds and one torch.mm each."""
    import torch

    from taseg_tpu_torch.ops import f3conv, sparse_conv

    conv = seg.model.main.stem_1.SparseConv_0
    seen = {}
    h = conv.register_forward_pre_hook(lambda m, a: seen.setdefault("args", a))
    seg.forward(arrays, seg.topology(arrays))
    h.remove()
    x, table = seen["args"]
    w, rb, order = conv.kernel.detach().contiguous(), table.rb, table.order
    v, c_in, c_out = x.shape[0], x.shape[1], w.shape[2]
    gen = torch.Generator(device=x.device).manual_seed(SEED)
    g = torch.randn(v, c_out, device=x.device, generator=gen)
    rb_bwd = sparse_conv.flip_rulebook(rb)
    lists = f3conv.k3_pair_lists(rb_bwd)
    pairs = int((rb >= 0).sum())
    nbytes = (v * c_in + w.numel() + rb.numel() + v * c_out) * 4
    ops = 2.0 * pairs * c_in * c_out
    out = {}
    calls = (
        ("sparse_conv_k", lambda: sparse_conv.sparse_conv(x, w, rb, order=order),
         lambda: sparse_conv.sparse_conv_k3(x, w, rb), sparse_conv.sparse_conv_plain, (x, w, rb), 1e-5,
         conv_library_ms("sparse_conv_k3", x, w, rb)),
        ("sparse_conv_dw", lambda: f3conv.sparse_conv_dw(x, g, rb_bwd, pairs=lists),
         lambda: f3conv.k3_conv_dw(x, g, rb_bwd), f3conv.k3_conv_dw_plain, (x, g, rb_bwd), 1e-4,
         dw_library_ms("k3_conv_dw", x, g, rb_bwd)),
    )
    for name, tf32, simt, plain, args, rel, lib in calls:
        want = plain(*args)
        ref = plain(args[0].abs(), args[1].abs(), args[2])
        err = check_close(f"tiaf {name} 3xTF32", twice_same(name, tf32), want, ref, "float32", rel)
        old_err = check_close(f"tiaf {name} CUDA cores", simt(), want, ref, "float32", rel)
        b, by = bound_ms(nbytes, ops, "float32")
        b3, by3 = bound_ms(nbytes, ops, "tf32x3")
        r = {
            "ms": cuda_ms(tf32), "old_ms": cuda_ms(simt), "plain_ms": cuda_ms(lambda: plain(*args), iters=3),
            "max_abs_err": err, "old_max_abs_err": old_err, "bound_ms": b, "bound_by": by,
            "bound_ms_3xtf32": b3, "bound_by_3xtf32": by3, "library_ms": lib,
        }
        out[name] = r
        log(
            f"tiaf route, main stem_1 {name} V={v} {c_in}->{c_out} pairs={pairs}: 3xTF32 {r['ms']:.4f} ms "
            f"(max|err| {err:.3e}, bit-identical on repeat) CUDA cores (K2 / K4 at 27, `sparse_conv_k3` / `k3_conv_dw`) "
            f"{r['old_ms']:.4f} ms (max|err| {old_err:.3e}) plain {r['plain_ms']:.4f} ms bound {b:.4f} ms "
            f"({by}, f32 CUDA cores) / {b3:.4f} ms ({by3}, 3xTF32) one torch.mm {lib:.4f} ms"
        )
    return out


class ModuleEvents:
    """CUDA events before and after each forward of the named submodules
    of `model`, for the split of one forward."""

    def __init__(self, model, names):
        import torch

        self.marks: dict = {}
        self.handles = []
        for n in names:
            mod = model.get_submodule(n)

            def pre(m, a, _n=n):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.marks[_n] = [ev]

            def post(m, a, o, _n=n):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                self.marks[_n].append(ev)

            self.handles += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]

    def ms(self) -> dict:
        return {n: a.elapsed_time(b) for n, (a, b) in self.marks.items()}

    def remove(self):
        for h in self.handles:
            h.remove()


def tiaf_topology_split(trainer, arrays) -> dict:
    """The pieces of `tiaf_inputs` (the train form) one after another,
    CUDA events between them: the main topology, the FOV topology (each
    with its levels' row orders and child tables), the three FOV -> main
    tables and the pixel table."""
    import torch

    from taseg_tpu_torch.models.voxel.backbone_context import build_unet_topology, host_nonneg
    from taseg_tpu_torch.models.voxel.minkunet_mm import TAP_STRIDES
    from taseg_tpu_torch.ops.voxelize import build_segment_tables, trilinear_table

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    main, fov = arrays["main"], arrays["fov"]
    ev[0].record()
    topo = build_unet_topology(
        main["point_coords_t"], main["num_points_t"], trainer.caps, devox_pairs=True,
        nonneg_coords=host_nonneg(main["point_coords"]),
    )
    ev[1].record()
    fov_topo = build_unet_topology(
        fov["point_coords_t"], fov["num_points_t"], trainer.fov_caps, devox_pairs=True,
        nonneg_coords=host_nonneg(fov["point_coords"]),
    )
    ev[2].record()
    coords = main["point_coords_t"]
    valid = torch.arange(coords.shape[0], device=coords.device) < topo.num_points
    for s in TAP_STRIDES:
        lvl = fov_topo.levels[s.bit_length() - 1]
        trilinear_table(coords, valid, lvl.coords, lvl.num, s, fov_topo.bounds)
    ev[3].record()
    b, h, w, _ = arrays["images_t"].shape
    rc = arrays["fov_rowcol_t"]
    inv = torch.where(
        torch.arange(rc.shape[0], device=rc.device) < fov_topo.num_points,
        torch.clamp(rc[:, 0] * w + rc[:, 1], 0, b * h * w - 1), -1,
    ).to(torch.int32)
    build_segment_tables(inv, b * h * w)
    ev[4].record()
    ev[4].synchronize()
    names = ("main_topology", "fov_topology", "fov_to_main_tables", "pixel_table")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def tiaf_branch_backward(trainer, arrays) -> dict:
    """Each branch alone, forward and forward + backward of a seeded
    cotangent on its real inputs (CUDA events; train mode, so its BN
    statistics move as in a step): the image branch (UNet2D with its
    gathers), the FOV branch (its input taking a gradient, as the image
    features give it one) and the main branch (features and logits); and
    the image branch's conv operations with their f32 bound."""
    import torch

    from taseg_tpu_torch.models.range2d.blocks import Conv

    tr = trainer
    inputs = tr.topology(arrays)
    feats = arrays["main"]["point_feats_t"]
    m = tr.model
    gen = torch.Generator(device=feats.device).manual_seed(SEED)

    def fov_in():
        c = m.lidar_backbone.stem.SparseConv_0.in_channels
        x = torch.randn(inputs.fov_feats.shape[0], c, device=feats.device, generator=gen)
        return x.requires_grad_()

    runs = {
        "image_backbone": lambda: m.image_backbone(inputs.images, inputs.pixels),
        "lidar_backbone": lambda: m.lidar_backbone(fov_in(), inputs.fov_topo),
        "main": lambda: m.main(feats, inputs.topo, return_features=True),
    }
    # the image branch's conv operations, from the shapes of one forward,
    # beside the f32 bound (its backward does twice the operations)
    convs = [c for c in m.image_backbone.modules() if isinstance(c, Conv)]
    ops = []

    def count(mod, args, y):
        n, h, w, _ = y.shape
        kh, kw, ci, co = mod.kernel.shape
        ops.append(2.0 * n * h * w * kh * kw * ci * co)

    hooks = [c.register_forward_hook(count) for c in convs]
    with torch.no_grad():
        runs["image_backbone"]()
    for h in hooks:
        h.remove()
    b_fwd, _ = bound_ms(0, sum(ops), "float32")
    out = {"image_backbone_tflop": sum(ops) / 1e12, "image_backbone_bound_ms": b_fwd}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for name, fn in runs.items():
        fwd, bwd = [], []
        for _ in range(2):
            ev[0].record()
            outs = fn()
            ev[1].record()
            loss = sum((o * torch.randn(o.shape, device=o.device, generator=gen)).sum() for o in outs)
            loss.backward()
            ev[2].record()
            ev[2].synchronize()
            fwd.append(ev[0].elapsed_time(ev[1]))
            bwd.append(ev[1].elapsed_time(ev[2]))
            del outs, loss
        out[name] = {"forward": min(fwd), "backward": min(bwd)}
    m.zero_grad(set_to_none=True)
    log(
        f"tiaf UNet2D convs {out['image_backbone_tflop']:.4f} TFLOP forward: f32 bound {b_fwd:.3f} ms "
        f"forward, {2 * b_fwd:.3f} ms backward; measured {out['image_backbone']['forward']:.3f} / "
        f"{out['image_backbone']['backward']:.3f} ms"
    )
    return out


def tiaf_calls(trainer, scans) -> CallCapture:
    """One real TIAF train step with every kernel wrapper of its path
    wrapped: K2 and K4 at K offsets (forward, input-gradient and weight-
    gradient calls, with the tables' row order or pair lists), K2 and K4
    at 27 (the main stem's first conv), K3's forward and input-gradient
    calls, K5 and K6 at each distinct shape;
    K7 at each distinct (table, shape), so every gather of the path (the
    image gathers from the pixel rows, the FOV -> main trilinear tables)
    is kept; K8 at its call."""
    from taseg_tpu_torch.ops import f3conv, sparse_conv, strided_conv, voxelize

    def conv(x, w, rb, dgrad=False, order=None):
        return ("sparse_conv_k" + ("_dgrad" if dgrad else ""), rb.shape[0], x.shape[0], w.shape[1], rb.shape[1],
                w.shape[2])

    cap = CallCapture()
    cap.patch(sparse_conv, "sparse_conv", conv)
    cap.patch(f3conv, "sparse_conv", conv)
    cap.patch(
        f3conv, "sparse_conv_dw",
        lambda x, g, rb, out_dtype=None, pairs=None: ("sparse_conv_dw", rb.shape[0], *x.shape, *g.shape),
    )
    for module in (sparse_conv, f3conv):
        cap.patch(
            module, "sparse_conv_k3",
            lambda x, w, rb, dgrad=False, order=None: (
                "sparse_conv_k3" + ("_dgrad" if dgrad else ""), *x.shape, w.shape[2]
            ),
        )
    cap.patch(
        f3conv, "k3_conv_dw",
        lambda f, g, rb, out_dtype=None, pairs=None: ("k3_conv_dw", *f.shape, g.shape[1]),
    )
    for name in ("downsample_conv_apply", "upsample_conv_apply"):
        kind = "strided_down" if name.startswith("down") else "strided_up"
        cap.patch(
            strided_conv, name,
            lambda x, w, t, dgrad=False, kind=kind: (
                kind + ("_dgrad" if dgrad else ""), *x.shape, w.shape[2]),
        )
    cap.patch(
        strided_conv, "strided_dw",
        lambda x, y, t, up, out_dtype=None: (
            "strided_dw", "up" if up else "down", t.parent.shape[0], x.shape[1], y.shape[1]
        ),
    )
    cap.patch(
        voxelize, "segment_sum",
        lambda src, t, w=None: (
            "segment_sum", t.perm.shape[0] - t.starts.shape[0] + 1, t.starts.shape[0] - 1,
            src.shape[1], w is not None, src.shape[0],
        ),
    )
    cap.patch(
        voxelize, "devoxelize_trilinear",
        lambda v, t: ("devoxelize", "trilinear", t.idx.shape[1], *v.shape, t.idx.data_ptr()),
    )
    cap.patch(
        voxelize, "devoxelize_identity",
        lambda v, inv: ("devoxelize", "identity", inv.shape[0], *v.shape, inv.data_ptr()),
    )
    cap.patch(voxelize, "devoxelize_multi_kernel", partial(multi_key, ptr=True))
    cap.patch(voxelize, "voxelize_bwd", lambda g, inv, counts: ("voxelize_bwd", inv.shape[0], *g.shape))
    trainer.step(scans[:1])
    cap.remove()
    return cap


def phase_tiaf_kernels(cap: CallCapture, pixels: int) -> dict:
    """Every kernel of one real TIAF train step (`tiaf_calls`) at the
    step's own f32 inputs, against its plain version:
      * K2 and K4 at K offsets at every call (`phase_cylinder_kernels`:
        the 3xTF32 route; beside each the CUDA-core kernel), and K2 and K4
        at 27 at the main stem's first conv (C_in 5, CUDA cores; 1e-5 and
        1e-4 of the largest sum of |terms|);
      * K3-down and K3-up, forward and input gradient, at every call of
        both branches (1e-4 / 1e-5 of the largest sum of |terms|: the
        plain down path sums by a mean-centred cumsum), and K5 at every
        call (1e-4: it sums up to all fine rows in another order), beside
        the mma.sync 3xTF32 tile that its wgmma tile replaced (`old_ms`,
        `old_device_ms`);
      * K6 at every call (the two voxelizes, the devoxelize backwards, the
        image gathers' backward over the `pixels`-segment pixel table)
        against its plain version in f64 (1e-5);
      * K7 at every call (the main head and features, the FOV taps, the
        FOV -> main trilinear tables, the image gathers from the flat
        pixel rows) and K8 at the FOV stem's voxelize backward: the same
        bits as the plain version, signed zeros included.
    Every kernel bit-identical on a repeat call.  Times per step (each
    call by its count): kernel, plain, bound (bytes: inputs read once,
    output written once, K7 counting the source rows its tables read;
    operations at the f32 rate) and one library call (torch.mm on rows
    gathered beforehand; `index_add_` for K6; `index_select` /
    `embedding_bag` for K7 and K8).  Returns the totals by kernel name
    (the input gradients of K2 at K and K3 under `<name>_dgrad`)."""
    import torch

    from taseg_tpu_torch.ops import strided_conv
    from taseg_tpu_torch.ops import voxelize as vx

    from taseg_tpu_torch.ops import f3conv, sparse_conv

    out = phase_cylinder_kernels(
        CallCapture.only(cap, lambda k: k[0].startswith(("sparse_conv_k_", "sparse_conv_dw"))
                         or k[0] == "sparse_conv_k"), "tiaf ", bf16=False, train=True,
    )
    for r in out.values():
        r.pop("head", None)
    strided = {
        "strided_down": (strided_conv.downsample_conv_apply, strided_conv.downsample_conv_plain, 1e-4),
        "strided_up": (strided_conv.upsample_conv_apply, strided_conv.upsample_conv_plain, 1e-5),
    }
    routes = {"strided_down": strided_conv.downsample_route, "strided_up": strided_conv.upsample_route}
    tot: dict = {}

    def add(name, count, by, **kw):
        r = tot.setdefault(name, dict(_tot(), calls=0, _parts={"bytes": 0.0, "operations": 0.0}))
        if "device_ms" in kw:
            r["_dev"] = True
        _add(r, **{k: (v if k == "max_abs_err" else mscale(count, v)) for k, v in kw.items()})
        r["calls"] += count
        r["_parts"][by] += count * kw["bound_ms"]

    for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name, count = key[0], cap.count[key]
        label = f"tiaf {name} {key[1:]} x{count}/step f32"
        if name.startswith(("strided_", "sparse_conv_k3", "k3_conv_dw")):
            x, second, t = a[0].detach(), a[1].detach(), a[2]
            base = name.replace("_dgrad", "")
            if name == "k3_conv_dw":
                kern = partial(f3conv.k3_conv_dw, x, second, t, pairs=kw.get("pairs"))
                plain, rel, route = f3conv.k3_conv_dw_plain, 1e-4, f3conv.dw_route(x.dtype, x.shape[1], second.shape[1])
            elif base == "sparse_conv_k3":
                kern = partial(sparse_conv.sparse_conv_k3, x, second, t, dgrad=name != base)
                plain, rel = sparse_conv.sparse_conv_plain, 1e-5
                route = sparse_conv.route(x.dtype, x.shape[1], second.shape[2])
            elif name == "strided_dw":
                up = a[3] if len(a) > 3 else kw["up"]
                kern = partial(strided_conv.strided_dw, x, second, t, up)
                plain = partial(strided_conv.strided_dw_plain, up=up)
                rel, route = 1e-4, f3conv.dw_route(x.dtype, x.shape[1], second.shape[1], strided=True)
            else:
                fn, plain, rel = strided[base]
                kern = partial(fn, x, second, t, dgrad=name != base)
                rounds = (t.child.shape[0],) if base == "strided_down" else ()
                route = routes[base](x.dtype, x.shape[1], second.shape[2], *rounds)
            got = twice_same(label, kern)
            ref = plain(x.abs(), second.abs(), t)
            want = plain(x, second, t)
            err = check_close(label, got, want, ref, "float32", rel)
            limit = rel * ref.abs().max().item()
            # K5's f32 calls: the mma.sync tile the wgmma tile replaced
            old_k5 = (old_tf32_dw_times(label, partial(old_k5_tf32, x, second, t, up), want, ref)
                      if name == "strided_dw" and route == "tf32x3" else None)
            # K3's CUDA-core kernels, which the 3xTF32 route replaced
            core, core_err = (
                old_times(base, x, second, t, want, ref, "float32", rel)
                if base in ("strided_down", "strided_up") else (None, None)
            )
            dev = {}
            ms = None
            if base in ("strided_down", "strided_up") and route == "tf32x3":
                # the 3xTF32 wgmma tile over the child / up table, beside
                # the mma.sync tile it replaced
                down = base == "strided_down"
                rb_t = (t.child[0] if t.child is not None else strided_conv.slot_child_table(t)[0]) if down \
                    else (t.up if t.up is not None else strided_conv.slot_up_table(t))
                order = (t.child_order if t.child is not None else None) if down \
                    else (t.up_order if t.up is not None else None)
                splits = strided_conv.k3_tf32_splits(rb_t.shape[1], sparse_conv.padded_width(x.dtype, x.shape[1]))
                ty = tf32_yardsticks(label, lambda w: fn(x, w, t, dgrad=name != base), x, second, rb_t, order,
                                     splits, want, ref, rel, fresh=True)
                ms, dev = ty["ms"], {"device_ms": ty["device_ms"], "old_ms": ty["old_ms"]}
                label += (f" device {fmt_ms(ty['device_ms'])} (the weight split every call) mma.sync tile "
                          f"{ty['old_ms']:.4f} ms (max|err| {ty['old_max_abs_err']:.3e})")
            del got, ref, want
            ms = cuda_ms(kern) if ms is None else ms
            pms = cuda_ms(lambda: plain(x, second, t), iters=3)
            nbytes, ops, lib = train_cost(base, a, kw, x, second)
            b, by = bound_ms(nbytes, ops, "float32")
            if name == "strided_dw":
                d, ld = yardstick_devices(name, kern, a, kw, x, second)
                dev = {"device_ms": d, "library_device_ms": ld}
                label += f" device {fmt_ms(d)} (torch.mm device {fmt_ms(ld)})"
                if old_k5 is not None:
                    dev.update(old_ms=old_k5["old_ms"], old_device_ms=old_k5["old_device_ms"])
                    label += (f" mma.sync tile {old_k5['old_ms']:.4f} ms (device {fmt_ms(old_k5['old_device_ms'])}, "
                              f"max|err| {old_k5['old_max_abs_err']:.3e})")
            log(
                f"{label} route {route} max|err| {err:.3e} (limit {limit:.3e}; bit-identical on repeat) kernel {ms:.4f} ms "
                + ("" if core is None else f"CUDA-core {core:.4f} ms (max|err| {core_err:.3e}) ")
                + f"plain {pms:.4f} ms bound {b:.4f} ms ({by}) one torch.mm {lib:.4f} ms"
                + (" SLOWER than torch.mm" if ms > lib else "")
            )
            add(name, count, by, ms=ms, plain_ms=pms, bound_ms=b, library_ms=lib, max_abs_err=err,
                **({} if core is None else {"cuda_core_ms": core}), **dev)
        elif name == "segment_sum":
            x, t = a[0].detach(), a[1]
            w = a[2] if len(a) > 2 else kw.get("w")
            where = (
                "pixel table (the image gathers' backward)" if key[2] == pixels
                else "trilinear pairs (a devoxelize backward)" if w is not None else "point tables"
            )
            k6 = _tot()
            _k6_check(f"tiaf K6 over the {where} {key[1:]} x{count}/step", (x, t, w), k6, count)
            # K6 moves 4 bytes or more per f32 add: bytes bound it
            add(name, 1, "bytes", **k6)
            tot[name]["calls"] += count - 1
        elif name == "devoxelize":
            v = a[0].detach()
            trilinear = key[1] == "trilinear"
            table = a[1] if trilinear else vx.IdentityDevoxTable(inverse=a[1])
            fn = vx.devoxelize_trilinear if trilinear else vx.devoxelize_identity
            twice_same(label, partial(fn, v, a[1]))
            ms, pms, lib, lib_err, p = devox_times(v, table)
            idx = a[1].idx if trilinear else a[1][None]
            c = v.shape[1]
            rows = int(torch.unique(idx[idx >= 0]).numel())
            b, by = bound_ms(idx.shape[0] * p * (8 if trilinear else 4) + rows * c * 4 + p * c * 4, 0.0, "float32")
            log(
                f"tiaf K7 devoxelize {key[1]} P={p} {'pixel rows' if v.shape[0] == pixels else 'voxels'}="
                f"{v.shape[0]} ({rows} read) C={c} x{count}/step: bit-identical (and on repeat), kernel "
                f"{ms:.4f} ms plain {pms:.4f} ms {'embedding_bag' if trilinear else 'index_select'} "
                f"{lib:.4f} ms (max|diff| {lib_err:.3e}) bound {b:.4f} ms ({by})"
            )
            add(name, count, by, ms=ms, plain_ms=pms, bound_ms=b, library_ms=lib, max_abs_err=0.0)
        elif name == "devoxelize_multi":
            # K7's multi-scale entry (counted under K7): the same bits as
            # its plain version and on repeat; beside it the sum of each
            # scale's one-call yardstick
            feats, tables = [x.detach() for x in a[0]], a[1]
            bias = kw.get("bias", a[2] if len(a) > 2 else None)
            bias = None if bias is None else bias.detach()
            multi_check(feats, tables, bias)
            ms = cuda_ms(lambda: vx.devoxelize_multi_kernel(feats, tables, bias))
            pms = cuda_ms(lambda: vx.devox_multi_plain(feats, tables, bias))
            lib = sum(devox_times(x, t)[2] for x, t in zip(feats, tables))
            b, by = bound_ms(multi_bytes(feats, tables, bias), 0.0, "float32")
            log(
                f"tiaf K7 devoxelize_multi {key[1:4]} x{count}/step: bit-identical (and on repeat), "
                f"kernel {ms:.4f} ms plain {pms:.4f} ms, the scales' library calls {lib:.4f} ms, "
                f"bound {b:.4f} ms ({by})"
            )
            add("devoxelize", count, by, ms=ms, plain_ms=pms, bound_ms=b, library_ms=lib, max_abs_err=0.0)
        elif name == "voxelize_bwd":
            g, ids, counts = a[0].detach(), a[1], a[2]
            r = k8_call(f"tiaf K8 voxelize backward (the FOV stem) x{count}/step", g, ids, counts)
            add(name, count, "bytes", max_abs_err=0.0,
                **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "device_ms", "old_ms")})
    for r in tot.values():
        parts = r.pop("_parts")
        if not r.pop("_dev", False):  # K5 and K3's f32 calls are profiled here
            r.pop("device_ms")
        r["bound_by"] = "bytes" if parts["bytes"] >= parts["operations"] else "operations"
    out.update(tot)
    log(
        "tiaf kernels per step at the step's own calls: " + "; ".join(
            f"{n} x{r['calls']} kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} bound {r['bound_ms']:.4f} "
            f"library {r['library_ms']:.4f} max|err| {r['max_abs_err']:.3e}"
            + (f" device {fmt_ms(r['device_ms'])}" if "device_ms" in r else "")
            + (f" library device {fmt_ms(r['library_device_ms'])}" if "library_device_ms" in r else "")
            + (f" replaced kernel (old_ms) {r['old_ms']:.4f}" if "old_ms" in r else "")
            + (f" (device {fmt_ms(r['old_device_ms'])})" if "old_device_ms" in r else "")
            + (f" CUDA-core {r['cuda_core_ms']:.4f}" if "cuda_core_ms" in r else "")
            for n, r in sorted(out.items())
        )
    )
    return out


def tiaf_entry(tiaf: dict, name: str) -> dict:
    """A kernel's launches per TIAF serving scan and train step; its
    numbers per step at the calls of a real step (`phase_tiaf_kernels`:
    `step`, and `dgrad_step` for the input gradients of K2 at K and K3);
    for K2 and K4 at K offsets also the main-branch route call of
    `tiaf_route_call` (3xTF32 beside the 27-offset CUDA-core kernel)."""
    out = {
        "launches_per_scan": tiaf["per_scan"].get(name, 0),
        "launches_per_step": tiaf["per_step"].get(name, 0),
        "step": tiaf["kernels"].get(name),
    }
    if f"{name}_dgrad" in tiaf["kernels"]:
        out["dgrad_step"] = tiaf["kernels"][f"{name}_dgrad"]
    if name in tiaf["route"]:
        out["route_call"] = tiaf["route"][name]
    return out


def phase_tiaf() -> dict:
    """TIAF at full width in f32, seeded weights: MinkUNetMsMm (the
    _fsa_tiaf recipe: the mk34 cr1.0 MinkUNet `main` on the fused cloud,
    UNet2D at IMAGE_BASE 32 over 5 images of 384 x 1280, the FOV branch
    at FOV_CR 0.5) on TIAF_SCANS samples of SyntheticTiafReader(N_POINTS,
    history FSA_HISTORY), 262 144 main and 131 072 FOV rows per scan.
    The level counts beside their capacities; K2 at 27 on one main-branch
    call on the 3xTF32 route against the 27-offset CUDA-core route, and their
    weight gradients (`tiaf_route_call`); `Segmenter.predict` counted
    (TIAF_PER_SCAN), frame-length finite logits, the replace ensemble on
    the overlap; a small fused cloud with 5 small images, card against
    CPU; serving by stage; every kernel at every call of one real train
    step against its plain version (`phase_tiaf_kernels`); TIAF_STEPS
    counted `Trainer` steps with the staged recipe's freezing
    (MODEL.FIX_PART_PARAM, as tiaf_tiny):
    TIAF_PER_STEP, finite loss, terms and grad norm, the trainable
    parameters moved, `main/` bit-identical, `main`'s BN buffers moved,
    peak memory; then the same steps by stage (host, the topology's
    pieces, the forward by branch, loss, backward, optimizer) and each
    branch's forward and backward alone.  Returns the launches per scan
    and per step, the route call's and the kernels' numbers and the stage
    split; logs the phase's seconds."""
    import numpy as np
    import torch

    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10_FSA_TIAF
    from taseg_tpu_torch.engine import TIAF_TERMS, Segmenter, Trainer, check_capacity, points_per_scan
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    t_phase = time.perf_counter()
    base = MINKUNET_MK34_CR10_FSA_TIAF
    cfg = {**base, "MODEL": {**base["MODEL"], "FIX_PART_PARAM": True}}
    params, stats = init_params_numpy(cfg, seed=SEED)
    variables = {"params": params, "batch_stats": stats}
    t0 = time.perf_counter()
    scans = tiaf_scans(TIAF_SCANS)
    log(
        f"tiaf scans: {TIAF_SCANS} x (frame {[len(s['xyzret']) for s in scans]}, fused "
        f"{[len(s['xyzret_ms']) for s in scans]}, in the FOV {[int(s['fov_mask'].sum()) for s in scans]} "
        f"points, images {scans[0]['images'].shape}) in {time.perf_counter() - t0:.1f} s"
    )
    seg = Segmenter(cfg, variables)
    rows = points_per_scan(cfg)
    if (seg.point_capacity, seg.fov_capacity) != (rows, rows // 2):
        raise AssertionError(f"tiaf: capacities {seg.point_capacity}, {seg.fov_capacity}")
    for s in scans:
        a = seg.collate([s])
        inputs = seg.topology(a)
        nums = check_capacity(inputs, seg.caps, seg.fov_caps)
        fov_nums = [int(l.num) for l in inputs.fov_topo.levels]
        log(
            f"tiaf serving main rows {int(a['main']['num_points'][0])}, level voxels {nums} caps "
            f"{list(seg.caps.voxels)}; FOV rows {int(a['fov']['num_points'][0])}, level voxels "
            f"{fov_nums} caps {list(seg.fov_caps.voxels)}"
        )
    route = tiaf_route_call(seg, a)
    del a, inputs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out = seg.predict(scans)
    torch.cuda.synchronize()
    serve = dict(_build.LAUNCHES)
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"tiaf serving launches over {TIAF_SCANS} scans: {serve}")
    check_launches(serve, TIAF_PER_SCAN, TIAF_SCANS, "tiaf serving")
    for s, o in zip(scans, out):
        if o["logits"].shape != (len(s["xyzret"]), cfg["MODEL"]["NUM_CLASS"]):
            raise AssertionError(f"tiaf: logits {o['logits'].shape} for a {len(s['xyzret'])}-point frame")
        if not np.isfinite(o["logits"]).all():
            raise AssertionError("tiaf: non-finite logits")
    a = seg.collate(scans[:1])
    with torch.no_grad():
        res = seg.model(a["main"]["point_feats_t"], seg.topology(a))
    ov, n = res["overlap"], int(a["main"]["num_points"][0])
    if not 0 < int(ov.sum()) < n or not torch.equal(res["logits"][ov], res["fusion_logits"][ov]):
        raise AssertionError("tiaf: the replace ensemble does not hold on the overlap")
    for k, v in res.items():
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"tiaf: non-finite {k}")
    log(
        f"tiaf Segmenter.predict: frame-length labels {[len(o['labels']) for o in out]}, launches per "
        f"scan as expected, replace ensemble on {int(ov.sum())} of {n} main rows in the overlap; "
        f"image logits {tuple(res['image_logits'].shape)}; serving peak {serve_peak:.2f} GiB"
    )
    del a, res, out
    # the small sparse cloud fills the FOV's coarse levels more than the
    # default schedule's fractions of 8192 rows: 32 768 FOV rows
    small_cfg = {**cfg, "DATA": {**cfg["DATA"], "FOV_NUM_POINTS": 32768}}
    small = tiaf_scans(1, n_points=4000, seed=SEED + 1, img=(48, 160))
    small_scan_check(small_cfg, variables, "tiaf ", small, 16384)
    serve_split(seg, scans, 2, "tiaf ")
    del seg
    torch.cuda.empty_cache()

    trainer = Trainer(cfg, variables, iters_per_epoch=TIAF_STEPS, total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], seed=SEED)
    log(f"tiaf train capacities: main {list(trainer.caps.voxels)} FOV {list(trainer.fov_caps.voxels)}")
    cap = tiaf_calls(trainer, scans)
    n_img, h, w = scans[0]["images"].shape[:3]
    kernels = phase_tiaf_kernels(cap, n_img * h * w)
    del cap
    torch.cuda.empty_cache()
    named = dict(trainer.model.named_parameters())
    p0 = {k: v.detach().clone() for k, v in named.items()}
    b0 = {k: v.clone() for k, v in trainer.model.named_buffers()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2**30
    _build.reset_launches()
    outs = [trainer.step(scans[i % TIAF_SCANS: i % TIAF_SCANS + 1]) for i in range(TIAF_STEPS)]
    torch.cuda.synchronize()
    train = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"tiaf train launches over {TIAF_STEPS} steps: {train}")
    check_launches(train, TIAF_PER_STEP, TIAF_STEPS, "tiaf train")
    for i, o in enumerate(outs):
        log(
            f"tiaf step {i}: loss {o['loss']:.5f} (" + ", ".join(f"{k} {o[k]:.5f}" for k in TIAF_TERMS)
            + f") grad norm {o['grad_norm']:.4f} lr {o['lr']:.3e} level voxels {o['level_nums']}"
        )
        if not all(np.isfinite(o[k]) for k in ("loss", "grad_norm") + TIAF_TERMS):
            raise AssertionError(f"tiaf step {i}: a non-finite loss, term or grad norm")
    moved = frozen = 0
    for k, p in named.items():
        if not torch.isfinite(p).all():
            raise AssertionError(f"tiaf: parameter {k} is not finite")
        same = torch.equal(p.detach(), p0[k])
        if k.startswith("main."):
            if not same:
                raise AssertionError(f"tiaf: the frozen {k} moved")
            frozen += 1
        elif same:
            raise AssertionError(f"tiaf: the trainable {k} did not move")
        else:
            moved += 1
    bn = [k for k in b0 if k.startswith("main.")]
    still = [k for k in bn if torch.equal(dict(trainer.model.named_buffers())[k], b0[k])]
    if still:
        raise AssertionError(f"tiaf: main's BN buffers did not move: {still[:4]}")
    log(
        f"tiaf: {moved} trainable parameters moved, {frozen} main/ parameters bit-identical, "
        f"{len(bn)} main BN buffers moved; peak device memory {peak:.2f} GiB ({before:.2f} GiB "
        f"allocated before the steps)"
    )

    stages = {k: [] for k in ("host", "topology", *TIAF_BRANCHES, "forward_rest", "loss", "backward", "optimizer", "step")}
    split = {k: [] for k in ("main_topology", "fov_topology", "fov_to_main_tables", "pixel_table")}
    mods = ModuleEvents(trainer.model, TIAF_BRANCHES)
    done = torch.cuda.Event(enable_timing=True)
    hook = trainer.model.register_forward_hook(lambda m, a, o: done.record())
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for i in range(TIAF_STEPS):
        t0 = time.perf_counter()
        a = trainer.collate(scans[i % TIAF_SCANS: i % TIAF_SCANS + 1])
        t1 = time.perf_counter()
        ev[0].record()
        inputs = trainer.topology(a)
        check_capacity(inputs, trainer.caps, trainer.fov_caps)
        ev[1].record()
        loss = trainer.forward(a, inputs)
        ev[2].record()
        trainer.backward(loss)
        ev[3].record()
        trainer.update()
        ev[4].record()
        ev[4].synchronize()
        stages["step"].append((time.perf_counter() - t0) * 1e3)
        stages["host"].append((t1 - t0) * 1e3)
        for j, k in enumerate(("topology", None, "backward", "optimizer")):
            if k:
                stages[k].append(ev[j].elapsed_time(ev[j + 1]))
        br = mods.ms()
        for k in TIAF_BRANCHES:
            stages[k].append(br[k])
        fwd = ev[1].elapsed_time(done)
        stages["forward_rest"].append(fwd - sum(br.values()))
        stages["loss"].append(done.elapsed_time(ev[2]))
        for k, v in tiaf_topology_split(trainer, a).items():
            split[k].append(v)
        del a, inputs, loss
    mods.remove()
    hook.remove()
    med = {k: float(np.median(v)) for k, v in stages.items()}
    med_split = {k: float(np.median(v)) for k, v in split.items()}
    branches = tiaf_branch_backward(trainer, trainer.collate(scans[:1]))
    log(
        f"tiaf ms per step (median of {TIAF_STEPS}): " + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + "; topology pieces " + ", ".join(f"{k} {v:.3f}" for k, v in med_split.items())
        + "; each branch alone (forward / backward) " + ", ".join(
            f"{k} {branches[k]['forward']:.3f} / {branches[k]['backward']:.3f}" for k in TIAF_BRANCHES
        )
    )
    del trainer
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    log(f"tiaf phase (5g): {seconds:.1f} s")
    return {
        "per_scan": {k: n // TIAF_SCANS for k, n in serve.items()},
        "per_step": {k: n // TIAF_STEPS for k, n in train.items()},
        "route": route, "kernels": kernels, "train_ms": med, "topology_ms": med_split, "branches": branches,
        "peak_gib": peak, "serve_peak_gib": serve_peak, "seconds": seconds,
    }


def phase_bottleneck(scans) -> dict:
    """MinkUNet mk34 cr1.0 with JAX's default block (the flagship recipe
    without BLOCK: Bottleneck, 1-3-1 with expansion 4, so the stages run
    at 128 ... 1024 channels and the head reads 1024 / 512 / 384) in
    bf16: one serving scan with every launch counted (K2 at each 3^3 conv,
    all on the wgmma route; K3 4 + 4 on wgmma; K6 1;
    K7 1, the head), finite logits of the right shape, the small-scan f32
    logits card vs CPU; then two train steps, the second counted (K2 with
    its input gradients, K4 per 3^3 conv, K5 8, K6 2, K7 1) and timed,
    with peak memory; the phase's seconds."""
    import numpy as np
    import torch

    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.models.layers import Bottleneck, SparseConv
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    t_phase = time.perf_counter()
    model_cfg = {k: v for k, v in MINKUNET_MK34_CR10["MODEL"].items() if k != "BLOCK"}
    cfg = {**MINKUNET_MK34_CR10, "MODEL": model_cfg}
    p, st = init_params_numpy(cfg, seed=SEED)
    variables = {"params": p, "batch_stats": st}
    torch.cuda.reset_peak_memory_stats()
    seg = Segmenter(cfg, variables, compute_dtype="bfloat16")
    blocks = sum(isinstance(m, Bottleneck) for m in seg.model.modules())
    k3 = sum(isinstance(m, SparseConv) and m.kernel_volume == 27 for m in seg.model.modules())
    log(f"bottleneck: {blocks} Bottleneck blocks, {k3} 3^3 convs, head widths {seg.model.head_widths}")
    seg.predict(scans[:1])  # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = seg.predict(scans[1:2])
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    serve = dict(_build.LAUNCHES)
    per_scan = {
        "join_scan": serve["join_scan"], "sparse_conv_k3": k3, "sparse_conv_k3_wgmma": k3,
        "strided_down": 4, "strided_down_wgmma": 4, "strided_up": 4, "strided_up_wgmma": 4,
        "segment_sum": 1, "devoxelize": 1, "devoxelize_multi": 1,
    }
    check_launches(serve, per_scan, 1, "bottleneck serving")
    o = out[0]
    if o["logits"].shape != (len(scans[1]["xyzret"]), cfg["MODEL"]["NUM_CLASS"]):
        raise AssertionError(f"bottleneck: logits {o['logits'].shape}")
    if not np.isfinite(o["logits"]).all():
        raise AssertionError("bottleneck: non-finite logits")
    serve_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"bottleneck serving: one scan {serve_ms:.1f} ms end to end, launches as expected "
        f"({per_scan}), peak device memory {serve_peak:.2f} GiB")
    small_scan_check(cfg, variables, "bottleneck ")
    del seg
    torch.cuda.empty_cache()

    trainer = Trainer(cfg, variables, iters_per_epoch=2, total_epochs=cfg["OPTIM"]["NUM_EPOCHS"],
                      compute_dtype="bfloat16", seed=SEED)
    trainer.step(scans[:1])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    r = trainer.step(scans[1:2])
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    train = dict(_build.LAUNCHES)
    per_step = {
        "join_scan": serve["join_scan"], "sparse_conv_k3": 2 * k3 - 1,
        "sparse_conv_k3_wgmma": 2 * k3 - 1, "sparse_conv_k3_dgrad": k3 - 1,
        "sparse_conv_k3_dgrad_wgmma": k3 - 1, "strided_down": 8, "strided_down_wgmma": 8,
        "strided_down_dgrad": 4, "strided_down_dgrad_wgmma": 4, "strided_up": 8,
        "strided_up_wgmma": 8, "strided_up_dgrad": 4, "strided_up_dgrad_wgmma": 4,
        "k3_conv_dw": k3, "k3_conv_dw_wgmma": k3, "strided_dw": 8, "strided_dw_wgmma": 8,
        "segment_sum": 2, "devoxelize": 1, "devoxelize_multi": 1,
    }
    check_launches(train, per_step, 1, "bottleneck train")
    if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
        raise AssertionError("bottleneck: non-finite loss or grad norm")
    peak = torch.cuda.max_memory_allocated() / 2**30
    seconds = time.perf_counter() - t_phase
    log(f"bottleneck train step: {step_ms:.1f} ms end to end, loss {r['loss']:.5f} grad norm "
        f"{r['grad_norm']:.4f}, level voxels {r['level_nums']}, launches as expected ({per_step}), "
        f"peak device memory {peak:.2f} GiB; phase (5h) {seconds:.1f} s")
    del trainer
    torch.cuda.empty_cache()
    return {"serve_ms": serve_ms, "step_ms": step_ms, "peak_gib": peak, "seconds": seconds}


def phase_ddp_one_rank(scans) -> dict:
    """The flagship's bf16 train step with MODEL.IF_DIST on, twice: 2 steps
    of a Trainer without torch.distributed, then 2 steps of a fresh one
    (same seed, weights and scans) in a NCCL process group of world size
    1 (a FileStore under build/): the losses, grad norms, level counts,
    parameters and BN statistics bit-equal, since an all-reduce over one
    rank and a division by 1 change nothing.  Prints each run's second
    step's ms (the first pays first-call costs) and the phase's
    seconds."""
    import datetime
    import shutil

    import torch
    import torch.distributed as dist

    from taseg_tpu_torch import parallel
    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    t_phase = time.perf_counter()
    cfg = {**MINKUNET_MK34_CR10, "MODEL": {**MINKUNET_MK34_CR10["MODEL"], "IF_DIST": True}}
    p, st = init_params_numpy(cfg, seed=SEED)

    def run(label):
        tr = Trainer(cfg, {"params": p, "batch_stats": st}, iters_per_epoch=2,
                     total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], compute_dtype="bfloat16", seed=SEED)
        outs = [tr.step(scans[:1])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(tr.step(scans[1:2]))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        log(f"ddp {label}: world size {parallel.world_size()}, second step {ms:.1f} ms, "
            f"losses {[o['loss'] for o in outs]}")
        state = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
        return outs, state, ms

    plain = run("without torch.distributed")
    store_dir = REPO / "build" / "ddp_store"
    shutil.rmtree(store_dir, ignore_errors=True)
    store_dir.mkdir(parents=True)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(store_dir / "store"), 1), rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=120), device_id=torch.device("cuda", 0),
    )
    try:
        nccl = run("NCCL")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store_dir, ignore_errors=True)
    for a, b in zip(plain[0], nccl[0]):
        if (a["loss"], a["grad_norm"], a["level_nums"]) != (b["loss"], b["grad_norm"], b["level_nums"]):
            raise AssertionError(f"ddp: world size 1 changed a step: {a} against {b}")
    for k, v in plain[1].items():
        if not torch.equal(v, nccl[1][k]):
            raise AssertionError(f"ddp: world size 1 changed {k}")
    seconds = time.perf_counter() - t_phase
    log(f"ddp: the NCCL world-size-1 steps are bit-equal to the steps without torch.distributed "
        f"({len(plain[1])} tensors of parameters and BN statistics, losses, grad norms); phase (5i) "
        f"{seconds:.1f} s")
    return {"plain_ms": plain[2], "nccl_ms": nccl[2], "seconds": seconds}


def range_scan_split(seg, scans, rounds: int, label: str) -> dict:
    """A range model's serving per scan after warm-up, by stage: host
    (projection and collate, host clock), forward and K9 (CUDA events),
    the mapping back to the points and the copy to the host; median over
    `rounds` passes over the scans."""
    import numpy as np
    import torch

    samples = {"end_to_end": [], "host": [], "forward": [], "knn": [], "map": []}
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(rounds):
        for s in scans:
            t0 = time.perf_counter()
            a = seg.collate([s])
            t1 = time.perf_counter()
            e[0].record()
            lg = seg.forward(a, None)
            e[1].record()
            lab = seg.point_labels(a, lg)
            e[2].record()
            e[2].synchronize()
            t2 = time.perf_counter()
            seg.map_to_points(a, lg, lab)
            t3 = time.perf_counter()
            samples["end_to_end"].append((t3 - t0) * 1e3)
            samples["host"].append((t1 - t0) * 1e3)
            samples["forward"].append(e[0].elapsed_time(e[1]))
            samples["knn"].append(e[1].elapsed_time(e[2]))
            samples["map"].append((t3 - t2) * 1e3)
    med = {k: float(np.median(v)) for k, v in samples.items()}
    log(f"{label}serving over {len(samples['host'])} scans (ms per scan, median): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f"; {1e3 / med['end_to_end']:.3f} scans/s end to end")
    return med


def range_train_split(trainer, scans, others, steps: int, label: str) -> dict:
    """`steps` train steps after one warm-up, by stage (host collate on
    the host clock; forward with the loss, backward, optimizer with CUDA
    events), their losses, and the peak device memory."""
    import numpy as np
    import torch

    trainer.step(scans, others)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    split = {"end_to_end": [], "host": [], "forward_loss": [], "backward": [], "optimizer": []}
    losses = []
    e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    for _ in range(steps):
        t0 = time.perf_counter()
        arrays = trainer.collate(scans, others)
        t1 = time.perf_counter()
        e[0].record()
        loss = trainer.forward(arrays, None)
        e[1].record()
        trainer.backward(loss)
        e[2].record()
        g_norm, _ = trainer.update()
        e[3].record()
        losses.append(float(loss.detach()))
        split["end_to_end"].append((time.perf_counter() - t0) * 1e3)
        split["host"].append((t1 - t0) * 1e3)
        for k, (a, b) in zip(("forward_loss", "backward", "optimizer"), zip(e, e[1:])):
            split[k].append(a.elapsed_time(b))
        if not (np.isfinite(losses[-1]) and np.isfinite(float(g_norm))):
            raise AssertionError(f"{label}: non-finite loss {losses[-1]} or grad norm {float(g_norm)}")
    med = {k: float(np.median(v)) for k, v in split.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: {steps} steps of {len(scans)} images (ms per step, median): "
        + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
        + f"; losses {losses}; peak device memory {peak:.2f} GiB")
    return {**med, "losses": losses, "peak_gib": peak}


def k9_args(seg, scans) -> tuple:
    """K9's arguments at a range model's real call on `scans` (one batch):
    the range image as the model read it, each point's range, the pixel
    argmax of the model's logits, each point's column, row and image."""
    import torch

    arrays = seg.collate(scans)
    logits = seg.forward(arrays, None)
    return ((arrays["scan_t"][..., 4] * 80.0).contiguous(), arrays["unproj_range_t"],
            logits.argmax(-1).to(torch.int32), arrays["px_t"], arrays["py_t"], arrays["img_t"])


def beam_order(args) -> tuple:
    """The same points in beam order (by image, row, then column), as a
    real sensor's scans arrive."""
    import torch

    r, u, pix, px, py, img = args
    _, h, w = r.shape
    o = torch.argsort((img.long() * h + py.long()) * w + px.long(), stable=True)
    return r, u[o].contiguous(), pix, px[o].contiguous(), py[o].contiguous(), img[o].contiguous()


def seeded_labels(args, n_cls: int) -> tuple:
    """K9's arguments with the label image drawn from SEED in [0, n_cls):
    a model with random weights predicts one class almost everywhere
    (CENet's nuScenes sweep: no window disagrees, K9 relabels nothing),
    so its call takes these labels at its real image and points."""
    import torch

    r, u, pix, px, py, img = args
    gen = torch.Generator(device=pix.device).manual_seed(SEED)
    pix = torch.randint(0, n_cls, pix.shape, device=pix.device, generator=gen, dtype=torch.int32)
    return r, u, pix, px, py, img


def k9_check(label: str, args, n_cls: int) -> dict:
    """K9 at one call: its labels equal to its plain version's on the
    card and on the CPU, to its first design's (`knn_postprocess_v1`),
    and on repeat, with some points relabelled (else the check would pass
    a kernel that returned each point's own pixel); one counted launch
    and one kernel a call (`graph_kernels`); its `cuda_ms`
    and device ms in turns with the first design's (`old_ms`), the plain
    version's ms and the bound (bytes: per point its range, column, row
    and image in and its label out; each pixel's range and label once;
    the 25 weights)."""
    import torch

    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops.knn import knn_postprocess, knn_postprocess_plain, knn_postprocess_v1

    kern = lambda: knn_postprocess(*args, num_classes=n_cls)
    old = lambda: knn_postprocess_v1(*args, num_classes=n_cls)
    plain = lambda: knn_postprocess_plain(*args, num_classes=n_cls)
    _build.reset_launches()
    got = kern()
    torch.cuda.synchronize()
    if _build.LAUNCHES["knn"] != 1:
        raise AssertionError(f"K9 {label}: {_build.LAUNCHES['knn']} launches for one call")
    want, again, first = plain(), kern(), old()
    cpu = knn_postprocess(*(a.cpu() for a in args), num_classes=n_cls)
    if not (torch.equal(got, want) and torch.equal(got.cpu(), cpu) and torch.equal(got, again)
            and torch.equal(first, want)):
        raise AssertionError(
            f"K9 {label}: {int((got != want).sum())} labels differ from the plain version on the card, "
            f"{int((got.cpu() != cpu).sum())} from the CPU's, {int((got != again).sum())} on repeat, "
            f"{int((first != want).sum())} of the first design's"
        )
    r, _, pix, px, py, img = args
    changed = float((got != pix[img.long(), py.long(), px.long()]).float().mean())
    if not changed > 0:
        raise AssertionError(f"K9 {label}: no point relabelled, the vote is not exercised")
    kernels, others = graph_kernels(kern)
    if (kernels, others) != (1, 0):
        raise AssertionError(f"K9 {label}: {kernels} kernels and {others} other graph nodes a call, one kernel "
                             "expected")
    p_pts = px.shape[0]
    b, h, w = r.shape
    nbytes = p_pts * (4 * 4 + 4) + b * h * w * (4 + 4) + 25 * 4
    bound, by = bound_ms(nbytes, 0, "float32")
    ms, old_ms = in_turns(kern, old, 50)
    dev, old_dev = in_turns(kern, old, timer=graph_ms)
    k9 = {
        "max_abs_err": 0.0, "ms": ms, "old_ms": old_ms, "plain_ms": cuda_ms(plain, 20),
        "device_ms": dev, "old_device_ms": old_dev, "bound_ms": bound,
        "bound_by": by, "library_ms": None, "points": p_pts, "image": [b, h, w], "bytes": nbytes,
        "changed_share": changed, "kernels_per_call": kernels,
    }
    log(f"K9 {label} at {p_pts} points, {b} x {h} x {w} image: labels equal to the plain version's (card and "
        f"CPU), the first design's and on repeat, {kernels} kernel a call (the graph); {fmt_ms(ms)} (device "
        f"{fmt_ms(k9['device_ms'])}), first design {fmt_ms(old_ms)} (device {fmt_ms(k9['old_device_ms'])}), "
        f"plain {fmt_ms(k9['plain_ms'])}, bound {bound:.5f} ms ({by}, {nbytes} bytes), library none (no one "
        f"call); {k9['changed_share']:.4f} of the points relabelled")
    return k9


def phase_range(scans) -> dict:
    """The range view (5j): SalsaNext at the full width of
    tools/cfgs/range/semantic_kitti/salsanext_res34.yaml (base 32, 64 x
    512 images, f32) on the synthetic 120 000-point scans:

      * `Segmenter.predict` of the scans, one per batch, counted: K9 once
        per scan and nothing else; finite (N, 20) logits, labels in range;
        serving by stage (`range_scan_split`);
      * K9 at the main path's shapes against its plain version on the
        same inputs (on the card and on the CPU) and its first design,
        labels array-equal, with its time and device time in turns with
        the first design's, plain time and bound, one kernel a call (the
        graph); again with the points in beam order (`k9_check`);
      * a small scan (16 x 128 images) card vs CPU: f32 logits within
        1e-3 of their scale; two f32 train steps (dropout off on both
        sides), loss and grad norm within tolerances from measurement;
      * RANGE_STEPS adamW + onecycle steps at batch RANGE_BATCH (the
        recipe's) by stage, finite, with the peak memory;
      * the salsanext_tiny recipe through `build_dataloader` and
        `Trainer.train` for RANGE_TINY_EPOCHS epochs: the mean loss of
        the last epoch under the first's;
      * FIDNet (fidnet_res34) and RangeNet++ (rangenet_darknet53): one
        counted scan each (K9 once) and RANGE_STEPS steps at batch
        RANGE_BATCH, with their peak memory;
      * the phase's seconds."""
    import shutil

    import numpy as np
    import torch

    from taseg_tpu_torch.configs import FIDNET_RES34, RANGENET_DARKNET53, SALSANEXT_RES34, SALSANEXT_TINY
    from taseg_tpu_torch.data import build_dataloader
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.models.layers import Dropout
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops.knn import knn_postprocess
    from taseg_tpu_torch.range_step import range_point_labels
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    t_phase = time.perf_counter()
    out: dict = {}
    n_cls = SALSANEXT_RES34["MODEL"]["NUM_CLASS"]

    def weights(cfg):
        p, st = init_params_numpy(cfg, seed=SEED)
        return {"params": p, "batch_stats": st}

    def serve_counted(cfg, variables, label):
        seg = Segmenter(cfg, variables)
        seg.predict(scans[:1])  # warm-up
        torch.cuda.synchronize()
        _build.reset_launches()
        res = seg.predict(scans)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        check_launches(launches, {"knn": 1}, len(scans), f"{label} serving")
        for s, o in zip(scans, res):
            n = len(s["xyzret"])
            if o["logits"].shape != (n, n_cls) or o["labels"].shape != (n,):
                raise AssertionError(f"{label}: logits {o['logits'].shape} labels {o['labels'].shape}")
            if not np.isfinite(o["logits"]).all():
                raise AssertionError(f"{label}: non-finite logits")
            if o["labels"].dtype != np.int32 or o["labels"].min() < 0 or o["labels"].max() >= n_cls:
                raise AssertionError(f"{label}: labels out of range")
        log(f"{label} serving: {len(scans)} scans of {len(scans[0]['xyzret'])} points, launches "
            f"{ {k: v for k, v in launches.items() if v} } (K9 once a scan, nothing else)")
        return seg, launches

    # serving, counted, and by stage
    variables = weights(SALSANEXT_RES34)
    seg, launches = serve_counted(SALSANEXT_RES34, variables, "salsanext")
    out["launches"] = launches["knn"]
    out["serve"] = range_scan_split(seg, scans, RANGE_ROUNDS, "salsanext ")

    # K9 at the main path's shapes against its plain version and its
    # first design: the shuffled synthetic scan, then its points in beam
    # order
    args = k9_args(seg, scans[:1])
    arrays = seg.collate(scans[:1])
    if not torch.equal(knn_postprocess(*args, num_classes=n_cls),
                       range_point_labels(arrays, seg.forward(arrays, None), n_cls)):
        raise AssertionError("K9: the engine's call differs from the direct one")
    out["knn"] = k9_check("salsanext scan", args, n_cls)
    out["knn_beam"] = k9_check("salsanext scan in beam order", beam_order(args), n_cls)
    del arrays

    # a small scan, card vs CPU: logits, then two f32 train steps
    small_cfg = {**SALSANEXT_RES34, "DATA": {**SALSANEXT_RES34["DATA"], "H": 16, "W": 128}}
    small = make_scans(1, n_points=8000, seed=SEED + 1)
    lg = {dev: Segmenter(small_cfg, variables, device=dev).predict(small)[0]["logits"]
          for dev in ("cuda", "cpu")}
    d = float(np.abs(lg["cuda"] - lg["cpu"]).max())
    scale = max(1.0, float(np.abs(lg["cpu"]).max()))
    if not d <= 1e-3 * scale:
        raise AssertionError(f"salsanext: small-scan logits card vs CPU {d:.3e} (scale {scale:.3e})")
    steps = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(small_cfg, variables, device=dev, iters_per_epoch=5, total_epochs=2,
                     batch_size=1, seed=SEED)
        for m in tr.model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        steps[dev] = [tr.step(small) for _ in range(2)]
    # per step (loss, grad norm) relative tolerances, from measurement: the
    # step is ill-conditioned (the boundary loss's max pools over flat
    # regions of empty pixels tie, and Adam's first update moves every
    # weight by about the LR whatever its gradient): on the CPU alone a
    # 1e-7 relative change of the weights moves the step-0 grad norm by
    # 3.5e-3, and the thread count moves step 1's loss by 3e-4 and its grad
    # norm by 1.7e-2; on an H100 the card was 2.9e-3 and 6.8e-2 off the CPU
    for i, (a, c) in enumerate(zip(steps["cuda"], steps["cpu"])):
        tol_loss, tol_norm = ((1e-5, 1e-2), (1e-3, 0.2))[i]
        if abs(a["loss"] - c["loss"]) > tol_loss * abs(c["loss"]) or \
                abs(a["grad_norm"] - c["grad_norm"]) > tol_norm * abs(c["grad_norm"]):
            raise AssertionError(f"salsanext: small step {i} card {a} vs CPU {c}")
    log(f"salsanext small scan card vs CPU: max|dlogit| {d:.3e} (scale {scale:.3e}); two f32 steps "
        f"loss {[x['loss'] for x in steps['cuda']]} vs {[x['loss'] for x in steps['cpu']]}, grad norm "
        f"{[x['grad_norm'] for x in steps['cuda']]} vs {[x['grad_norm'] for x in steps['cpu']]}")

    # batch-30 adamW + onecycle steps
    del seg
    torch.cuda.empty_cache()
    batch = make_scans(RANGE_BATCH, seed=SEED + 30)
    others = batch[1:] + batch[:1]
    tr = Trainer(SALSANEXT_RES34, variables, iters_per_epoch=10,
                 total_epochs=SALSANEXT_RES34["OPTIM"]["NUM_EPOCHS"], batch_size=RANGE_BATCH, seed=SEED)
    out["train"] = range_train_split(tr, batch, others, RANGE_STEPS, "salsanext train (adamW, onecycle)")
    del tr
    torch.cuda.empty_cache()

    # the tiny recipe through the loader: the loss falls
    cfg = SALSANEXT_TINY
    loader = build_dataloader(cfg["DATA"], training=True, scans_per_shard=1, modality="range")
    tr = Trainer(cfg, None, train_loader=loader, total_epochs=RANGE_TINY_EPOCHS, seed=SEED,
                 output_dir=REPO / "build" / "range_tiny")
    hist = [tr.train_one_epoch(e)["loss"] for e in range(RANGE_TINY_EPOCHS)]
    if not (np.isfinite(hist).all() and hist[-1] < hist[0]):
        raise AssertionError(f"salsanext_tiny: epoch mean losses {hist} do not fall")
    log(f"salsanext_tiny through the loader: {len(loader)} steps an epoch, epoch mean losses {hist}")
    del tr
    shutil.rmtree(REPO / "build" / "range_tiny", ignore_errors=True)

    # FIDNet and RangeNet++ at their recipes' widths
    for name, cfg in (("fidnet", FIDNET_RES34), ("rangenet", RANGENET_DARKNET53)):
        v = weights(cfg)
        seg, _ = serve_counted(cfg, v, name)
        out[name] = {"serve": range_scan_split(seg, scans[:1], 2, f"{name} ")}
        del seg
        torch.cuda.empty_cache()
        tr = Trainer(cfg, v, iters_per_epoch=10, total_epochs=cfg["OPTIM"]["NUM_EPOCHS"],
                     batch_size=RANGE_BATCH, seed=SEED)
        out[name]["train"] = range_train_split(tr, batch, others, 1, f"{name} train (adamW, onecycle)")
        del tr
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"range phase (5j): {out['seconds']:.1f} s")
    return out


# nuScenes and Waymo (phase 5k): the sensors' trees (tests/
# torch_nuscenes_fixture.make_card_trees), scans served per recipe, and the
# launches per scan of the recipes whose backbone is the flagship's (mk34)
# or RPVNet's (mk18, two blocks a stage): K2 at each 3^3 conv, all on the
# wgmma tile (the stem's first, C_in 4, padded to 8); K3 4 + 4; K6 the voxelize; K7
# the head's one multi-scale launch.  K1's count per scan is measured.
# Served scans a recipe: 2 (3 until the f32 weight gradients' yardsticks
# were added to 5e, 5g and 5k: the script's time budget)
NW_SCANS = 1
MK34_PER_SCAN = FSA_PER_SCAN
MK34_PER_STEP = {k: v for k, v in TRAIN_PER_STEP.items() if k != "join_scan"}
MK18_PER_SCAN = {**MK34_PER_SCAN, "sparse_conv_k3": 34, "sparse_conv_k3_wgmma": 34}
MK18_PER_STEP = {
    **MK34_PER_STEP, "sparse_conv_k3": 67, "sparse_conv_k3_wgmma": 67, "sparse_conv_k3_dgrad": 33,
    "sparse_conv_k3_dgrad_wgmma": 33, "k3_conv_dw": 34, "k3_conv_dw_wgmma": 34,
}
SPV18_PER_SCAN = {k: v for k, v in SPVCNN_PER_SCAN.items() if k != "join_scan"}
SPV18_PER_SCAN.update(sparse_conv_k3=34, sparse_conv_k3_wgmma=34)
RPV18_PER_SCAN = {k: v for k, v in RPVNET_PER_SCAN.items() if k != "join_scan"}
# Waymo's 23 classes: the 3^3 head (128 -> 23, f32) runs K2 at K = 27 and
# K4 at K on 3xTF32 at C_out padded to 24, as the 20-class head does, so
# the launches are the KITTI recipe's; nothing at K2 or K4 at 27
CYL23_PER_SCAN = {**CYLINDER_PER_SCAN, "sparse_conv_k3": 0, "sparse_conv_k3_wgmma": 0}
CYL23_PER_STEP = {**CYLINDER_PER_STEP, "sparse_conv_k3": 0, "sparse_conv_k3_dgrad": 0, "k3_conv_dw": 0}
# TIAF on nuScenes (f32): every kernel of KITTI's TIAF path (TIAF_PER_SCAN)
# must launch but K2 at 27 (the main stem's C_in is 4 here: K2 at K's
# 3xTF32 tile takes it)
NW_TIAF_SERVE = ("join_scan", "sparse_conv_k", "sparse_conv_k_tf32", "strided_down", "strided_up",
                 "segment_sum", "devoxelize", "devoxelize_multi")
NW_TIAF_STEP = NW_TIAF_SERVE + ("sparse_conv_k_dgrad", "sparse_conv_dw", "strided_dw", "voxelize_bwd")


def nw_counted(what: str, fn, exact: dict = None, must: tuple = (), n: int = 1,
               never: tuple = ()) -> tuple:
    """`fn()` with every launch count set to 0 just before and read just
    after: each kernel of `exact` launched exact[k] x n times (the others
    of `exact`'s kernels none), each of `must` at least once, none of
    `never`; returns (fn's result, {kernel: launches / n} of those that
    launched)."""
    import torch

    from taseg_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"{what}: launches {({k: v for k, v in launches.items() if v})} over {n}")
    if exact:
        for k, per in exact.items():
            if launches.get(k, 0) != per * n:
                raise AssertionError(f"{what}: {k} launched {launches.get(k, 0)} times, expected {per} x {n}")
    for k in must:
        if launches.get(k, 0) <= 0:
            raise AssertionError(f"{what}: kernel {k} of the path was not launched")
    for k in never:
        if launches.get(k, 0):
            raise AssertionError(f"{what}: {k} launched {launches[k]} times, expected none")
    for k, v in launches.items():
        if v % n:
            raise AssertionError(f"{what}: {k} launched {v} times over {n} scans, not the same per scan")
    return out, {k: v // n for k, v in launches.items() if v}


def nw_check_points(what: str, scans, out, n_cls: int) -> None:
    """Finite (N, n_cls) logits and labels in range, N the scan's (its
    keyframe's) points."""
    import numpy as np

    for s, o in zip(scans, out):
        n = len(s["xyzret"])
        if o["logits"].shape != (n, n_cls) or o["labels"].shape != (n,):
            raise AssertionError(f"{what}: logits {o['logits'].shape} labels {o['labels'].shape}, {n} points")
        if not np.isfinite(o["logits"]).all():
            raise AssertionError(f"{what}: non-finite logits")
        if o["labels"].min() < 0 or o["labels"].max() >= n_cls:
            raise AssertionError(f"{what}: labels out of range")


def nw_serve_stages(seg, scans, label: str) -> dict:
    """Serving per scan after the counted run, by stage: host (reader
    dict -> collated arrays, host clock), topology and forward (CUDA
    events), mapping to the points with the copy to the host; the median
    over the scans, and the peak device memory of the pass."""
    import numpy as np
    import torch

    torch.cuda.reset_peak_memory_stats()
    st = {"end_to_end": [], "host": [], "topology": [], "forward": [], "map": []}
    e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for s in scans:
        t0 = time.perf_counter()
        a = seg.collate([s])
        t1 = time.perf_counter()
        e[0].record()
        tp = seg.topology(a)
        seg.check_capacity(tp)
        e[1].record()
        lg = seg.forward(a, tp)
        e[2].record()
        e[2].synchronize()
        t2 = time.perf_counter()
        seg.map_to_points(a, lg)
        t3 = time.perf_counter()
        st["end_to_end"].append((t3 - t0) * 1e3)
        st["host"].append((t1 - t0) * 1e3)
        st["topology"].append(e[0].elapsed_time(e[1]))
        st["forward"].append(e[1].elapsed_time(e[2]))
        st["map"].append((t3 - t2) * 1e3)
    med = {k: float(np.median(v)) for k, v in st.items()}
    med["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}serving over {len(scans)} scans (ms per scan, median): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items() if k != "peak_gib")
        + f"; {1e3 / med['end_to_end']:.3f} scans/s; peak device memory {med['peak_gib']:.2f} GiB")
    return med


def nw_step_stages(trainer, scans, label: str) -> dict:
    """One more train step on each of `scans` by stage: host (collate),
    topology (with the capacity check), forward + loss, backward and
    optimizer (CUDA events); the median, and the peak device memory."""
    import numpy as np
    import torch

    from taseg_tpu_torch.engine import check_capacity

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = {k: [] for k in ("step", "host", "topology", "forward", "backward", "optimizer")}
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    for s in scans:
        t0 = time.perf_counter()
        a = trainer.collate([s])
        t1 = time.perf_counter()
        ev[0].record()
        topo = trainer.topology(a)
        check_capacity(topo, trainer.caps, trainer.fov_caps)
        ev[1].record()
        loss = trainer.forward(a, topo)
        ev[2].record()
        trainer.backward(loss)
        ev[3].record()
        g_norm, _ = trainer.update()
        ev[4].record()
        ev[4].synchronize()
        if not (np.isfinite(float(loss.detach())) and np.isfinite(float(g_norm))):
            raise AssertionError(f"{label}: non-finite loss or grad norm")
        st["step"].append((time.perf_counter() - t0) * 1e3)
        st["host"].append((t1 - t0) * 1e3)
        for j, k in enumerate(("topology", "forward", "backward", "optimizer")):
            st[k].append(ev[j].elapsed_time(ev[j + 1]))
    med = {k: float(np.median(v)) for k, v in st.items()}
    med["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}train step by stage (ms, median of {len(scans)}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items() if k != "peak_gib")
        + f"; peak device memory {med['peak_gib']:.2f} GiB")
    return med


def nw_k_offsets(cap, label: str) -> dict:
    """K2 and K4 at K offsets at every call of a captured Waymo Cylinder
    step (`cylinder_calls`), on each call's own inputs: against the plain
    version (the convs within 1e-5 of the largest sum of |terms|, the
    weight gradients within 1e-4), bit-identical on repeat.  The 23-class
    head's calls (K = 27: 128 -> 23, its input gradient 23 -> 128 and its
    weight gradient, on 3xTF32 at C_out padded to 24) also timed: kernel,
    device, the padded copies, the CUDA-core kernel at the same inputs
    (`cuda_core_k`, which took them before), plain, both bounds and one
    torch.mm, beside the CUDA-core times recorded in PERF.md §6, and the
    mma.sync 3xTF32 tiles that the wgmma tiles replaced (`mma_ms`; the
    weight gradient's device time, `mma_device_ms`)."""
    from taseg_tpu_torch.ops import f3conv, sparse_conv

    out = {"calls": 0, "max_err_share": 0.0, "head": {}}
    # the logical (C_in, C_out) of each 27-offset conv, by (V_in, V_out):
    # its weight gradient's call sees the input and the cotangent as the
    # autograd Function padded them
    heads = {(k[2], k[4]): (k[3], k[5]) for k in cap.seen if k[0] == "sparse_conv_k" and k[1] == 27}
    for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        name, k, v_in, c_in, v_out, c_out = key
        x, second, rb = a[0], a[1], a[2]
        route = sparse_conv.k_route(x.dtype, c_in, c_out)
        dw = name == "sparse_conv_dw"
        if not dw:  # a conv's input at its weight's C_in (its Function padded it)
            x = x[:, : second.shape[1]].contiguous()
        if dw:
            lists = kw.get("pairs")
            kern = lambda: f3conv.sparse_conv_dw(x, second, rb, pairs=lists)  # noqa: E731
            plain, rel = f3conv.k3_conv_dw_plain, 1e-4
            nbytes = (v_in * c_in + v_out * c_out + rb.numel() + k * c_in * c_out) * 4
        else:
            order = kw.get("order")
            kern = lambda: sparse_conv.sparse_conv(x, second, rb, order=order)  # noqa: E731
            plain, rel = sparse_conv.sparse_conv_plain, 1e-5
            nbytes = (v_in * c_in + second.numel() + rb.numel() + v_out * c_out) * 4
        want, ref = plain(x, second, rb), plain(x.abs(), second.abs(), rb)
        got = twice_same(f"{label}{key}", kern)
        err = check_close(f"{label}{key}", got, want, ref, "float32", rel)
        share = err / max(ref.abs().max().item(), 1e-30)
        out["calls"] += cap.count[key]
        out["max_err_share"] = max(out["max_err_share"], share)
        if k == 27:  # the head, again at its logical widths, through the wrappers that pad them
            if dw:
                c_in, c_out = heads[(v_in, v_out)]
                x, second = x[:, :c_in].contiguous(), second[:, :c_out].contiguous()
            if dw:
                kern = lambda: f3conv.sparse_conv_dw(x, second, rb, pairs=lists)  # noqa: E731
            else:
                kern = lambda: sparse_conv.sparse_conv(x, second, rb, order=order)  # noqa: E731
            want, ref = plain(x, second, rb), plain(x.abs(), second.abs(), rb)
            err = check_close(f"{label}{key} logical", twice_same(f"{label}{key}", kern), want, ref,
                              "float32", rel)
            share = err / max(ref.abs().max().item(), 1e-30)
            old_err = check_close(f"{label}{key} CUDA-core", cuda_core_k(name, x, second, rb), want, ref,
                                  "float32", rel)
            nbytes = (x.numel() + second.numel() + rb.numel() + (k * c_in * c_out if dw else v_out * c_out)) * 4
            ops = 2.0 * int((rb >= 0).sum()) * c_in * c_out
            b, by = bound_ms(nbytes, ops, "float32")
            b3, by3 = bound_ms(nbytes, ops, "tf32x3")
            base = "sparse_conv_dw" if dw else "sparse_conv_k"
            lib = (dw_library_ms if dw else conv_library_ms)(base, x, second, rb)
            pads, wpad = pad_copies(x, second, k)
            r = {"route": route, "k": k, "c_in": c_in, "c_out": c_out, "v_out": v_out,
                 "max_abs_err": err, "ms": cuda_ms(kern), "device_ms": device_ms(kern, KERNEL_NAMES[base]),
                 "pad_ms": cuda_ms(pads) if pads else 0.0, "weight_pad_ms": cuda_ms(wpad) if wpad else 0.0,
                 "old_ms": cuda_ms(lambda: cuda_core_k(name, x, second, rb)),
                 "old_max_abs_err": old_err, "parent_ms": CYL23_HEAD_PARENT_MS[name],
                 "plain_ms": cuda_ms(lambda: plain(x, second, rb), 3), "bound_ms": b, "bound_by": by,
                 "bound_ms_3xtf32": b3, "bound_by_3xtf32": by3, "library_ms": lib}
            if dw:  # the mma.sync 3xTF32 tiles that the wgmma tiles replaced
                o = old_tf32_dw_times(f"{label}{key}", partial(old_dw_tf32, x, second, rb, lists), want, ref)
                r["mma_ms"], r["mma_device_ms"] = o["old_ms"], o["old_device_ms"]
            else:
                r["mma_ms"] = tf32_yardsticks(
                    f"{label}{key}", lambda w: sparse_conv.sparse_conv(x, w, rb, order=order), x, second, rb,
                    order, sparse_conv.k_splits(v_out), want, ref, rel, fresh=True)["old_ms"]
            out["head"][name] = r
            log(f"{label}head {name} K={k} {c_in}->{c_out} V_out={v_out} route {route}: max|err| {err:.3e} "
                f"({share:.2e} of the largest sum of |terms|, limit {rel:.0e}), bit-identical on repeat; "
                f"kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}, padded copies {r['pad_ms']:.4f} ms, "
                f"weight's padded copy {r['weight_pad_ms']:.4f} ms) "
                f"beside {r['parent_ms']} ms on CUDA cores in PERF.md §6 (CUDA-core kernel here "
                f"{r['old_ms']:.4f} ms, max|err| {old_err:.3e})"
                + (f", the mma.sync 3xTF32 tile {r['mma_ms']:.4f} ms" if "mma_ms" in r else "")
                + (f" (device {fmt_ms(r['mma_device_ms'])})" if "mma_device_ms" in r else "")
                + f"; plain {r['plain_ms']:.4f} ms bound {b:.4f} ms "
                f"({by}) / {b3:.4f} ms ({by3}, 3xTF32) one torch.mm {lib:.4f} ms")
    log(f"{label}K2 / K4 at K offsets: {out['calls']} calls of one step against their plain "
        f"versions, largest error {out['max_err_share']:.2e} of the largest sum of |terms|")
    return out


def nw_head_k7(seg, scans, label: str) -> dict:
    """K7's multi-scale entry (the MinkUNet head: strides 16, 4 and 1 in
    one launch, summed in f32 with the bias) at the recipe's class count
    in bf16 (rows of 34 or 46 bytes: 2-byte pieces) on the head's real
    tables of a served scan: the same bits as its plain version and on
    repeat, with its time, the plain version's and its bound."""
    from taseg_tpu_torch.ops import voxelize as vx

    a = seg.collate(scans[:1])
    topo = seg.topology(a)
    k = seg.model.classifier.bias.shape[0]
    fn = multi_call(topo, k)
    multi_check(*fn.args)
    nbytes = multi_bytes(*fn.args)
    b, by = bound_ms(nbytes, 0, "float32")
    r = {"classes": k, "max_abs_err": 0.0, "ms": cuda_ms(fn),
         "plain_ms": cuda_ms(lambda: vx.devox_multi_plain(*fn.args)), "bound_ms": b, "bound_by": by,
         "points": int(vx._table_points(fn.args[1][0]))}
    log(f"{label}K7 head at C = {k} bf16 ({2 * k} bytes a row) on {r['points']} points: bit-identical to "
        f"the plain version and on repeat; {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
        f"{b:.5f} ms ({by})")
    return r


def nus_waymo_entry(res: dict, name: str) -> dict:
    """A kernel's launches per scan and per step on each nuScenes / Waymo
    path of phase 5k (the paths where it ran)."""
    out = {}
    for path, p in res["paths"].items():
        scan, step = p.get("serve_launches", {}).get(name, 0), p.get("step_launches", {}).get(name, 0)
        if scan or step:
            out[path] = {"launches_per_scan": scan, "launches_per_step": step if "step_launches" in p else None}
    return out


def phase_nus_waymo() -> dict:
    """nuScenes and Waymo (5k), on trees written from seeded synthetic
    scans at the sensors' sizes (`tests/torch_nuscenes_fixture.
    make_card_trees`: one nuScenes scene of 9 keyframes with 9 sweeps of
    34 000 points between each pair, the ego at 5 m/s, six camera records
    per keyframe; Waymo frames of 150 000 first and 20 000 second
    returns), through the readers, at the recipes' full widths:

      * nuScenes MinkUNet mk34 cr1.0 and FSA (TLAD: ~645 000 fused points
        a scan) in bf16, Waymo MinkUNet mk34 and mk18 in bf16: serving of
        NW_SCANS scans through `Segmenter.predict`, counted (the flagship's
        launches per scan and per step on the mk34 recipes, RPVNet's
        backbone's on mk18), by stage; a train step counted, one by stage;
        K7's head at 17 and 23 classes against its plain version;
      * nuScenes TIAF (MinkUNetMsMmNus, f32, six images of 448 x 800):
        the real reader with the JPEG decode replaced by seeded images
        (the card's machine has no Pillow), serving and a step;
      * Waymo Cylinder_TS cy480 (f32, 23 classes): serving and a step
        counted; K2 and K4 at K offsets at every call of the step against
        their plain versions (the head's 128 -> 23 on CUDA cores);
      * Waymo SPVCNN mk18 and RPVNet mk18: one counted scan each;
      * CENet on nuScenes (32 x 1920): one scan (K9 once), K9 at its real
        image and points with seeded labels against its plain version and
        its first design (`k9_check`), and one step at its recipe's batch
        of 1;
      * `Trainer.train` for one epoch over two nuScenes keyframes and
        `evaluate_points(save_path=...)` on two: the lidarseg `.bin` files
        and `submission.json` read back, equal to `Segmenter.predict`;
      * card against CPU: one small scan of each new recipe at a narrow
        width (MinkUNets cr 0.25, TIAF cr / FOV_CR 0.25, IMAGE_BASE 8 and
        48 x 64 images, Cylinder INIT_SIZE 8, CENet on 16 x 128), f32
        logits within 1e-3 of their scale;
      * the phase's seconds.
    Returns each path's launches per scan and per step, and the times."""
    import json as _json
    import shutil
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, str(REPO / "tests"))
    from torch_nuscenes_fixture import NUS_CARD, WAYMO_CARD, make_card_trees, make_nuscenes_root, make_waymo_root

    from taseg_tpu_torch.configs import RECIPES
    from taseg_tpu_torch.data import build_dataloader, build_reader
    from taseg_tpu_torch.data.nuscenes import reader_mm
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.utils import submission
    from taseg_tpu_torch.utils.params_from_jax import export_flax_params, init_params_numpy

    t_phase = time.perf_counter()
    load_image = reader_mm._load_image
    (REPO / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="nus_waymo_", dir=REPO / "build"))
    res: dict = {"paths": {}}
    try:
        t0 = time.perf_counter()
        nus, waymo = make_card_trees(tmp / "card")
        small_nus = make_nuscenes_root(tmp / "small_nus", splits=("train", "val"), jpeg_hw=None)
        small_waymo = make_waymo_root(tmp / "small_waymo")
        log(f"5k trees in {time.perf_counter() - t0:.1f} s: nuScenes {NUS_CARD} (an HDL-32E at 20 Hz, "
            f"~34 000 points a sweep, keyframes at 2 Hz: nuScenes, Caesar et al., CVPR 2020); Waymo "
            f"{WAYMO_CARD} (the top lidar's 64 x 2650 range image, first and second returns: Waymo Open "
            f"Dataset, Sun et al., CVPR 2020)")

        def seeded_image(path, h, w):
            rng = np.random.default_rng(sum(map(ord, Path(path).as_posix()[-24:])))
            return rng.random((h, w, 3), dtype=np.float32)

        reader_mm._load_image = seeded_image
        log("5k: the nuScenes TIAF reader's JPEG decode is replaced by seeded (H, W, 3) float32 images "
            "(the card's host needs no Pillow); the camera files exist, everything else is the real reader")

        def cfg_of(path, root):
            c = RECIPES[path]
            return {**c, "DATA": {**c["DATA"], "DATA_PATH": str(root)}}

        def weights(cfg):
            p, st = init_params_numpy(cfg, seed=SEED)
            return {"params": p, "batch_stats": st}

        def scans_of(cfg, training, n):
            r = build_reader(cfg["DATA"], training)
            return [r[i] for i in range(len(r) - n, len(r))]

        def small_check(name, cfg, narrow, root):
            c = {**cfg, "DATA": {**cfg["DATA"], "DATA_PATH": str(root)},
                 "MODEL": {**cfg["MODEL"], **narrow}}
            if "IMAGE_HEIGHT" in narrow:
                # the FOV cloud of a small uniform scan fills its levels far
                # more than a street does: JAX's default schedule at 65 536
                c["DATA"].update(IMAGE_HEIGHT=narrow["IMAGE_HEIGHT"], IMAGE_WIDTH=narrow["IMAGE_WIDTH"],
                                 FOV_NUM_POINTS=65536)
            if c["MODEL"]["NAME"] in ("CENet", "RPVNet"):
                c["DATA"].update(H=16, W=128)
            r = build_reader(c["DATA"], False)
            small_scan_check(c, weights(c), f"{name} (narrow) ", small=[r[len(r) - 1]], capacity=16384)

        # ---- the MinkUNet-family recipes in bf16: serving, steps, counted
        bf16 = (
            ("nuscenes minkunet", "tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10.yaml", nus,
             MK34_PER_SCAN, MK34_PER_STEP),
            ("nuscenes fsa", "tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa.yaml", nus,
             MK34_PER_SCAN, MK34_PER_STEP),
            ("waymo minkunet mk34", "tools/cfgs/voxel/waymo/minkunet_mk34_cr10.yaml", waymo,
             MK34_PER_SCAN, MK34_PER_STEP),
            ("waymo minkunet mk18", "tools/cfgs/voxel/waymo/minkunet_mk18_cr10.yaml", waymo,
             MK18_PER_SCAN, MK18_PER_STEP),
        )
        for name, path, root, per_scan, per_step in bf16:
            cfg = cfg_of(path, root)
            v = weights(cfg)
            n_cls = cfg["MODEL"]["NUM_CLASS"]
            serve = scans_of(cfg, False, NW_SCANS)
            seg = Segmenter(cfg, v, compute_dtype="bfloat16")
            seg.predict(serve[:1])  # warm-up
            out, per = nw_counted(f"{name} serving", lambda: seg.predict(serve), exact=per_scan,
                                  must=("join_scan",), n=NW_SCANS, never=("voxelize_bwd",))
            nw_check_points(name, serve, out, n_cls)
            a = seg.collate(serve[-1:])
            levels = [int(l.num) for l in seg.topology(a).levels]
            rows = int(a["num_points"].reshape(-1)[0])
            log(f"{name}: rows {rows} of {seg.point_capacity}, level voxels {levels} "
                f"caps {list(seg.caps.voxels)}")
            p = {"serve_launches": per, "serve": nw_serve_stages(seg, serve, f"{name} "), "levels": levels}
            if name in ("nuscenes minkunet", "waymo minkunet mk34"):
                p["k7_head"] = nw_head_k7(seg, serve, f"{name} ")
            del seg
            torch.cuda.empty_cache()
            train = scans_of(cfg, True, 2)
            tr = Trainer(cfg, v, iters_per_epoch=4, total_epochs=cfg["OPTIM"]["NUM_EPOCHS"],
                         compute_dtype="bfloat16", seed=SEED)
            tr.step(train[:1])  # warm-up
            r, per_s = nw_counted(f"{name} train step", lambda: tr.step(train[1:]), exact=per_step,
                                  must=("join_scan",))
            if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
                raise AssertionError(f"{name}: non-finite loss or grad norm")
            log(f"{name} train step: loss {r['loss']:.5f} grad norm {r['grad_norm']:.4f} level voxels "
                f"{r['level_nums']} of {list(tr.caps.voxels)}")
            p.update(step_launches=per_s, step=nw_step_stages(tr, train[1:], f"{name} "))
            res["paths"][name] = p
            del tr
            torch.cuda.empty_cache()

        # ---- TIAF on nuScenes, f32
        name = "nuscenes tiaf"
        cfg = cfg_of("tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa_tiaf.yaml", nus)
        v = weights(cfg)
        serve = scans_of(cfg, False, NW_SCANS)
        log(f"{name}: {serve[-1]['images'].shape[0]} images of {serve[-1]['images'].shape[1:3]}, "
            f"{int(serve[-1]['fov_mask'].sum())} of {len(serve[-1]['xyzret_ms'])} fused points in a frustum")
        seg = Segmenter(cfg, v)
        seg.predict(serve[:1])
        out, per = nw_counted(f"{name} serving", lambda: seg.predict(serve), must=NW_TIAF_SERVE,
                              n=NW_SCANS, never=("voxelize_bwd",))
        nw_check_points(name, serve, out, 17)
        p = {"serve_launches": per, "serve": nw_serve_stages(seg, serve, f"{name} ")}
        del seg
        torch.cuda.empty_cache()
        train = scans_of(cfg, True, 2)
        tr = Trainer(cfg, v, iters_per_epoch=4, total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], seed=SEED)
        tr.step(train[:1])
        r, per_s = nw_counted(f"{name} train step", lambda: tr.step(train[1:]), must=NW_TIAF_STEP)
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise AssertionError(f"{name}: non-finite loss or grad norm")
        log(f"{name} train step: loss {r['loss']:.5f} grad norm {r['grad_norm']:.4f}")
        p.update(step_launches=per_s, step=nw_step_stages(tr, train[1:], f"{name} "))
        res["paths"][name] = p
        del tr
        torch.cuda.empty_cache()

        # ---- Waymo Cylinder_TS, f32, 23 classes
        name = "waymo cylinder"
        cfg = cfg_of("tools/cfgs/voxel/waymo/cylinder_cy480_cr10.yaml", waymo)
        v = weights(cfg)
        serve = scans_of(cfg, False, NW_SCANS)
        seg = Segmenter(cfg, v)
        if seg.model.in_dim != 9:
            raise AssertionError(f"{name}: pre-net {seg.model.in_dim} wide, expected the pipeline's 9")
        seg.predict(serve[:1])
        out, per = nw_counted(f"{name} serving", lambda: seg.predict(serve), exact=CYL23_PER_SCAN, n=NW_SCANS)
        nw_check_points(name, serve, out, 23)
        p = {"serve_launches": per, "serve": nw_serve_stages(seg, serve, f"{name} ")}
        del seg
        torch.cuda.empty_cache()
        train = scans_of(cfg, True, 2)
        tr = Trainer(cfg, v, iters_per_epoch=4, total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], seed=SEED)
        tr.step(train[:1])
        r, per_s = nw_counted(f"{name} train step", lambda: tr.step(train[1:]), exact=CYL23_PER_STEP)
        if not (np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])):
            raise AssertionError(f"{name}: non-finite loss or grad norm")
        p.update(step_launches=per_s, step=nw_step_stages(tr, train[1:], f"{name} "))
        cap = cylinder_calls(lambda: tr.step(train[:1]))
        heads = sorted(k[0] for k in cap.seen if k[1] == 27)
        if heads != ["sparse_conv_dw", "sparse_conv_k", "sparse_conv_k_dgrad"]:
            raise AssertionError(f"{name}: the head's calls at K = 27 {heads}")
        p["k_offsets"] = nw_k_offsets(cap, f"{name} ")
        res["paths"][name] = p
        del tr
        torch.cuda.empty_cache()

        # ---- Waymo SPVCNN mk18 and RPVNet mk18: one counted scan each
        for name, path, per_scan in (
            ("waymo spvcnn mk18", "tools/cfgs/fusion/waymo/spvcnn_mk18_cr10.yaml", SPV18_PER_SCAN),
            ("waymo rpvnet mk18", "tools/cfgs/fusion/waymo/rpvnet_mk18_cr10.yaml", RPV18_PER_SCAN),
        ):
            cfg = cfg_of(path, waymo)
            serve = scans_of(cfg, False, 2)
            seg = Segmenter(cfg, weights(cfg), compute_dtype="bfloat16")
            seg.predict(serve[:1])
            t0 = time.perf_counter()
            out, per = nw_counted(f"{name} serving", lambda: seg.predict(serve[1:]), exact=per_scan,
                                  must=("join_scan",))
            ms = (time.perf_counter() - t0) * 1e3
            nw_check_points(name, serve[1:], out, 23)
            log(f"{name}: one scan {ms:.1f} ms end to end")
            res["paths"][name] = {"serve_launches": per, "serve": {"end_to_end": ms}}
            del seg
            torch.cuda.empty_cache()

        # ---- CENet on nuScenes (the range view, 32 x 1920), batch 1
        name = "nuscenes cenet"
        cfg = cfg_of("tools/cfgs/range/nuscenes/cenet_res34.yaml", nus)
        v = weights(cfg)
        serve = scans_of(cfg, False, 2)
        seg = Segmenter(cfg, v)
        seg.predict(serve[:1])
        out, per = nw_counted(f"{name} serving", lambda: seg.predict(serve[1:]), exact={"knn": 1})
        nw_check_points(name, serve[1:], out, 17)
        p = {"serve_launches": per, "serve": range_scan_split(seg, serve[1:], 2, f"{name} ")}
        res["knn_cenet"] = k9_check("cenet nuscenes sweep, seeded labels",
                                    seeded_labels(k9_args(seg, serve[1:2]), 17), 17)
        del seg
        torch.cuda.empty_cache()
        train = scans_of(cfg, True, 2)
        tr = Trainer(cfg, v, iters_per_epoch=4, total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], batch_size=1, seed=SEED)
        p["step"] = range_train_split(tr, train[1:], train[:1], 1, f"{name} train (adamW, onecycle, batch 1)")
        res["paths"][name] = p
        del tr
        torch.cuda.empty_cache()

        # ---- Trainer.train and evaluate_points(save_path) on nuScenes
        name = "nuscenes minkunet"
        cfg = cfg_of("tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10.yaml", nus)
        v = weights(cfg)
        loaders = []
        for training in (True, False):
            ld = build_dataloader(cfg["DATA"], training=training, scans_per_shard=1,
                                  point_capacity=cfg["MODEL"]["POINTS_PER_SCAN"])
            ld.reader.sample_idx = ld.reader.sample_idx[-2:]  # two keyframes (for one epoch)
            loaders.append(ld)
        scans = [loaders[1].reader[i] for i in range(2)]
        tr = Trainer(cfg, v, train_loader=loaders[0], val_loader=loaders[1], total_epochs=1,
                     compute_dtype="bfloat16", seed=SEED, output_dir=tmp / "run")
        hist = tr.train()
        if not np.isfinite(hist[0]["loss"]):
            raise AssertionError("nuscenes Trainer.train: non-finite loss")
        preds = tmp / "preds"
        ev = tr.evaluate_points(save_path=preds)
        p_, s_ = export_flax_params(tr.model)
        seg = Segmenter(cfg, {"params": p_, "batch_stats": s_}, compute_dtype="bfloat16")
        files = sorted((preds / "lidarseg" / "test").glob("*_lidarseg.bin"))
        if len(files) != 2:
            raise AssertionError(f"evaluate_points wrote {len(files)} lidarseg files, expected 2")
        for s, o in zip(scans, seg.predict(scans)):
            got = submission.read_nuscenes_predictions(preds, s["token"])
            want = o["labels"].astype(np.uint8)
            same = np.array_equal(got[want != 0], want[want != 0])
            if len(got) != len(s["xyzret"]) or (got == 0).any() or not same:
                raise AssertionError(f"{s['token']}: the lidarseg file differs from Segmenter.predict's labels")
        meta = _json.loads((preds / "submission.json").read_text())["meta"]
        if meta != submission.NUSCENES_SUBMISSION_META:
            raise AssertionError(f"submission.json meta {meta}")
        log(f"nuscenes Trainer.train: one epoch of {len(hist[0]['steps'])} steps, loss {hist[0]['loss']:.5f}; "
            f"evaluate_points(save_path) wrote {[f.name for f in files]} ({[f.stat().st_size for f in files]} "
            f"bytes, uint8, no 0) and submission.json, equal to Segmenter.predict; mIoU {ev['miou']:.2f}")
        del tr, seg
        torch.cuda.empty_cache()

        # ---- card against CPU on small scans, narrow widths
        narrow = {"cr": 0.25}
        small_check("nuscenes minkunet", RECIPES["tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10.yaml"], narrow,
                    small_nus)
        small_check("nuscenes fsa", RECIPES["tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa.yaml"], narrow,
                    small_nus)
        small_check("nuscenes tiaf", RECIPES["tools/cfgs/voxel/nuscenes/minkunet_mk34_cr10_fsa_tiaf.yaml"],
                    {"cr": 0.25, "FOV_CR": 0.25, "IMAGE_BASE": 8, "IMAGE_HEIGHT": 48, "IMAGE_WIDTH": 64},
                    small_nus)
        for path in ("voxel/waymo/minkunet_mk34_cr10", "voxel/waymo/minkunet_mk18_cr10",
                     "fusion/waymo/spvcnn_mk18_cr10"):
            small_check(path, RECIPES[f"tools/cfgs/{path}.yaml"], narrow, small_waymo)
        small_check("waymo rpvnet mk18", RECIPES["tools/cfgs/fusion/waymo/rpvnet_mk18_cr10.yaml"],
                    narrow, small_waymo)
        small_check("waymo cylinder", RECIPES["tools/cfgs/voxel/waymo/cylinder_cy480_cr10.yaml"],
                    {"INIT_SIZE": 8}, small_waymo)
        small_check("nuscenes cenet", RECIPES["tools/cfgs/range/nuscenes/cenet_res34.yaml"], {}, small_nus)
    finally:
        reader_mm._load_image = load_image
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"nuscenes / waymo phase (5k): {res['seconds']:.1f} s")
    return res


# MinkUNet and SPVCNN mk34 at cr 1.6 (phase 5l): widths int(1.6 x PLANES)
# = 51, 102, 204, 409, 153 and the decoder's concatenations 613 and 306,
# none a multiple of 8, so every conv takes its tensor-core route at widths
# the wrappers pad to whole 16-byte pieces.  The launches per scan and per
# step are those of the cr 1.0 backbones (MK34_*, SPVCNN's); none of K2,
# K3, K4 and K5 may take a CUDA-core kernel
CR16_PATHS = (
    # (name, recipe, dataset, trained)
    ("kitti minkunet cr16", "tools/cfgs/voxel/semantic_kitti/minkunet_mk34_cr16.yaml", "kitti", True),
    ("kitti spvcnn cr16", "tools/cfgs/fusion/semantic_kitti/spvcnn_mk34_cr16.yaml", "kitti", True),
    ("waymo minkunet cr16", "tools/cfgs/voxel/waymo/minkunet_mk34_cr16.yaml", "waymo", True),
    ("waymo minkunet cr16 xyz", "tools/cfgs/voxel/waymo/minkunet_mk34_cr16_xyz.yaml", "waymo", False),
    ("waymo spvcnn cr16", "tools/cfgs/fusion/waymo/spvcnn_mk34_cr16.yaml", "waymo", False),
)
CR16_SCANS = 2  # served per recipe after a warm-up scan
SPV34_PER_SCAN = {k: v for k, v in SPVCNN_PER_SCAN.items() if k != "join_scan"}
SPV34_PER_STEP = {k: v for k, v in SPVCNN_PER_STEP.items() if k != "join_scan"}
# each wrapper of K2, K3, K4 and K5 with the LAUNCHES entries of its
# tensor-core routes: a launch counted under the first and none of the
# others took a CUDA-core kernel
TENSOR_CORE_ROUTES = {
    base: (base + "_wgmma", base + "_tf32")
    for base in (
        "sparse_conv_k3", "sparse_conv_k3_dgrad", "strided_down", "strided_down_dgrad", "strided_up",
        "strided_up_dgrad", "k3_conv_dw", "strided_dw", "sparse_conv_k", "sparse_conv_k_dgrad",
        "sparse_conv_dw",
    )
}
# the times recorded in PERF.md §6 (NVIDIA H100 80GB HBM3, 700 W) before the
# padded routes: the Waymo
# Cylinder head's calls (128 -> 23) on the CUDA-core kernels, and MinkUNet
# cr 1.0's stem K4 (4 -> 32) on CUDA cores, ms per call
CYL23_HEAD_PARENT_MS = {"sparse_conv_dw": 2.485, "sparse_conv_k": 1.216, "sparse_conv_k_dgrad": 0.598}
STEM_K4_PARENT_MS = 0.95


def cuda_core_launches(launches: dict) -> dict:
    """The launches of K2, K3, K4 and K5 in `launches` that took no
    tensor-core route, by wrapper (empty where there are none)."""
    out = {}
    for base, routes in TENSOR_CORE_ROUTES.items():
        n = launches.get(base, 0) - sum(launches.get(r, 0) for r in routes)
        if n:
            out[base] = n
    return out


def pad_copies(x, second, n_out: int = 0):
    """The copies that the wrapper of one padded call makes around its
    kernel on every call, as one callable: the zero-padded columns of the
    features (a conv, whose kernel writes the logical output columns
    itself and whose padded weight is kept beside a weight that takes no
    gradient), or those of the features and the cotangent and the
    logical (n_out, C_in, C_out) block rounded to the input dtype (a
    weight gradient); and the weight's padded copy alone (a conv whose
    weight changes every step pays it once a step, and W^T's once a
    backward), as a second callable or None.  (None, None) where the
    widths need no padding."""
    import torch

    from taseg_tpu_torch.ops.f3conv import dw_unpad
    from taseg_tpu_torch.ops.sparse_conv import pad_cols, padded_width

    dt = x.dtype
    c_in = x.shape[1]
    c_out = second.shape[1] if second.dim() == 2 else second.shape[2]
    ci, co = padded_width(dt, c_in), padded_width(dt, c_out)
    if (ci, co) == (c_in, c_out):
        return None, None
    if second.dim() == 2:  # a weight gradient: x and the cotangent
        out = torch.empty((n_out, ci, co), dtype=torch.float32, device=x.device)
        return lambda: (pad_cols(x, ci), pad_cols(second, co), dw_unpad(out, c_in, c_out, dt)), None
    return (lambda: pad_cols(x, ci)), lambda: torch.nn.functional.pad(second, (0, co - c_out, 0, ci - c_in))


def cuda_core_call(name: str, x, second, t, up: bool = False):
    """The CUDA-core kernel of one K2 (at 27), K3, K4 or K5 call on the
    same inputs, through its C entry (counted nowhere): the kernel that
    the padded tensor-core routes replaced at ragged widths.  `t` is the
    call's (27, V) table (K2; K4's reverse table) or its StridedTables
    (K3, K5).  Returns the output (f32 for the weight gradients)."""
    import torch

    from taseg_tpu_torch.ops import _build, f3conv
    from taseg_tpu_torch.ops.sparse_conv import DTYPE_CODES

    dt, dev = x.dtype, x.device
    code = DTYPE_CODES[dt]
    if name == "k3_conv_dw":
        v, c_in = x.shape
        return f3conv.launch_dw("taseg_k3_conv_dw", "", (x.data_ptr(), second.data_ptr(), t.data_ptr()),
                                (v, c_in, second.shape[1]), v, 27, dt, dev)
    if name == "strided_dw":
        v_fine = t.parent.shape[0]
        return f3conv.launch_dw(
            "taseg_strided_dw", "", (x.data_ptr(), second.data_ptr(), t.parent.data_ptr(), t.slot.data_ptr()),
            (v_fine, x.shape[1], second.shape[1], int(up)), v_fine, 8, dt, dev,
        )
    c_in, c_out = x.shape[1], second.shape[2]
    second = second.contiguous()
    if name == "sparse_conv_k3":
        v = x.shape[0]
        out = torch.empty((v, c_out), dtype=dt, device=dev)
        _build.launch("taseg_sparse_conv_k3", (), x.data_ptr(), second.data_ptr(), t.data_ptr(),
                      out.data_ptr(), v, c_in, c_out, code)
        return out
    if name == "strided_up":
        v_fine = t.parent.shape[0]
        out = torch.empty((v_fine, c_out), dtype=dt, device=dev)
        _build.launch("taseg_strided_up", (), x.data_ptr(), second.data_ptr(), t.parent.data_ptr(),
                      t.slot.data_ptr(), out.data_ptr(), v_fine, c_in, c_out, code)
        return out
    v_coarse = t.starts.shape[0] - 1
    out = torch.empty((v_coarse, c_out), dtype=dt, device=dev)
    _build.launch("taseg_strided_down", (), x.data_ptr(), second.data_ptr(), t.parent.data_ptr(),
                  t.slot.data_ptr(), t.perm.data_ptr(), t.starts.data_ptr(), out.data_ptr(),
                  x.shape[0], v_coarse, c_in, c_out, code)
    return out


def cr16_call(label: str, name: str, count: int, x, second, t, kw: dict, dgrad: bool = False,
              up: bool = False) -> dict:
    """One padded call of K2, K3, K4 or K5 at its captured shape and
    inputs: against its plain version within its route's tolerance (the
    convs within 1e-5 of the largest sum of |terms|, 1e-4 for K3-down,
    whose plain version sums by a mean-centred cumsum, and for the weight
    gradients, which sum up to all rows in another order; bf16 outputs
    plus one rounding), bit-identical on repeat, and the CUDA-core kernel
    at the same inputs held to the same tolerance.  Times per call:
    kernel (`cuda_ms`, the wrapper with the copies it makes on every call,
    as a served model calls it: a conv's padded weight is kept after the
    first call), device (the kernel's own, torch.profiler; None where no
    profile caught it), those copies alone, the weight's padded copy alone
    (`pad_copies`), the CUDA-core kernel, plain, bound (bytes and
    operations at the logical widths) and one torch.mm on rows gathered
    beforehand."""
    from taseg_tpu_torch.ops import f3conv, sparse_conv, strided_conv

    dt = x.dtype
    dtype = str(dt).split(".")[-1]
    if name == "k3_conv_dw":
        kern = partial(f3conv.k3_conv_dw, x, second, t, pairs=kw.get("pairs"))
        plain, rel, args, n_out = f3conv.k3_conv_dw_plain, 1e-4, (x, second, t), 27
    elif name == "strided_dw":
        kern = partial(strided_conv.strided_dw, x, second, t, up)
        plain, rel, args, n_out = partial(strided_conv.strided_dw_plain, up=up), 1e-4, (x, second, t), 8
    elif name == "sparse_conv_k3":
        kern = partial(sparse_conv.sparse_conv_k3, x, second, t, dgrad=dgrad, order=kw.get("order"))
        plain, rel, args, n_out = sparse_conv.sparse_conv_plain, 1e-5, (x, second, t), 0
    elif name == "strided_down":
        kern = partial(strided_conv.downsample_conv_apply, x, second, t, dgrad=dgrad)
        plain, rel, args, n_out = strided_conv.downsample_conv_plain, 1e-4, (x, second, t), 0
    else:
        kern = partial(strided_conv.upsample_conv_apply, x, second, t, dgrad=dgrad)
        plain, rel, args, n_out = strided_conv.upsample_conv_plain, 1e-5, (x, second, t), 0
    out_dtype = "float32" if n_out else dtype
    got = twice_same(label, kern)
    want = plain(*args)
    ref = plain(args[0].abs(), args[1].abs(), t)
    err = check_close(label, got, want, ref, out_dtype, rel)
    old = cuda_core_call(name, x, second, t, up)
    old_err = check_close(f"{label} CUDA-core", old, want, ref, out_dtype, rel)
    del got, want, ref, old
    cost_args = (x, second, t, up) if name == "strided_dw" else (x, second, t)
    nbytes, ops, lib = train_cost(name, cost_args, {"up": up}, x, second)
    b, by = bound_ms(nbytes, ops, dtype)
    pads, wpad = pad_copies(x, second, n_out)
    r = {
        "ms": cuda_ms(kern), "device_ms": device_ms(kern, KERNEL_NAMES[name], iters=5),
        "pad_ms": cuda_ms(pads) if pads else 0.0, "weight_pad_ms": cuda_ms(wpad) if wpad else 0.0,
        "old_ms": cuda_ms(lambda: cuda_core_call(name, x, second, t, up), iters=3),
        "plain_ms": cuda_ms(lambda: plain(*args), iters=3), "bound_ms": b, "library_ms": lib,
        "max_abs_err": err,
    }
    log(
        f"{label} x{count} route {route_of(name, dt, x, second)}: max|err| {err:.3e} (CUDA-core {old_err:.3e}), "
        f"bit-identical on repeat; kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}, padded copies "
        f"{r['pad_ms']:.4f} ms, weight's padded copy {r['weight_pad_ms']:.4f} ms) CUDA-core {r['old_ms']:.4f} ms "
        f"plain {r['plain_ms']:.4f} ms bound {b:.4f} ms ({by}) one torch.mm {lib:.4f} ms"
        + (" SLOWER than torch.mm" if r["ms"] > lib else "")
    )
    return r


def route_of(name: str, dt, x, second) -> str:
    from taseg_tpu_torch.ops import f3conv, sparse_conv, strided_conv

    c_in = x.shape[1]
    c_out = second.shape[1] if second.dim() == 2 else second.shape[2]
    if name in ("k3_conv_dw", "strided_dw"):
        return f3conv.dw_route(dt, c_in, c_out, strided=name == "strided_dw")
    if name == "sparse_conv_k3":
        return sparse_conv.route(dt, c_in, c_out)
    if name == "strided_up":
        return strided_conv.upsample_route(dt, c_in, c_out)
    return strided_conv.downsample_route(dt, c_in, c_out)


def conv_calls(trainer, scans) -> Capture:
    """One real train step of `trainer` with `Capture` hooks on its model."""
    calls = Capture(trainer.model)
    trainer.step(scans[:1])
    calls.remove()
    return calls


def cr16_padded_calls(calls: Capture, label: str) -> dict:
    """`cr16_call` at every conv of a train step (`conv_calls`), on the
    step's inputs at their logical widths through the wrappers, which pad
    them: the forward (K2 at 27, K3-down, K3-up), its input gradient (K2
    on W^T over the reverse table and its order; K3's other direction;
    none for an input that takes no gradient) and its weight gradient (K4
    over the level's pair lists, K5 over the slot lists), the cotangent a
    seeded normal of the output's shape.  (In the train step the autograd
    Functions pad the input and the cotangent once for the calls that
    share them.)  The totals per kernel (the input gradients under
    `<name>_dgrad`) weighted by the calls' counts per step; a total with a
    call whose device time was not measured is None."""
    import torch

    tot: dict = {}

    def add(key, count, r):
        t = tot.setdefault(key, {k: 0.0 for k in r} | {"calls": 0})
        for k, v in r.items():
            t[k] = max(t[k], v) if k == "max_abs_err" else msum(t[k], mscale(count, v))
        t["calls"] += count

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for key, (x, w32, table, bwd, grad_in) in sorted(calls.seen.items(), key=lambda kv: str(kv[0])):
        name, rows, c_in, c_out = key
        count = calls.count[key]
        what = f"{label}{name} rows={rows} {c_in}->{c_out}"
        w = w32.to(x.dtype).contiguous()
        w_t = w.transpose(1, 2).contiguous()
        if name == "sparse_conv_k3":
            fwd = table
            g = torch.randn(rows, c_out, device=x.device, generator=gen).to(x.dtype)
            add(name, count, cr16_call(what, name, count, x, w, fwd.rb, {"order": fwd.order}))
            if grad_in:
                add(name + "_dgrad", count, cr16_call(f"{what} input gradient", name, count, g, w_t, bwd.rb,
                                                      {"order": bwd.order}, dgrad=True))
            add("k3_conv_dw", count, cr16_call(f"{what} K4", "k3_conv_dw", count, x, g, bwd.rb,
                                               {"pairs": bwd.pairs}))
            continue
        up = name == "strided_up"
        out_rows = table.parent.shape[0] if up else table.starts.shape[0] - 1
        g = torch.randn(out_rows, c_out, device=x.device, generator=gen).to(x.dtype)
        add(name, count, cr16_call(what, name, count, x, w, table, {}))
        other = "strided_down" if up else "strided_up"
        add(other + "_dgrad", count, cr16_call(f"{what} input gradient", other, count, g, w_t, table, {},
                                               dgrad=True))
        add("strided_dw", count, cr16_call(f"{what} K5", "strided_dw", count, x, g, table, {}, up=up))
    for name, t in sorted(tot.items()):
        log(f"{label}{name} over {t['calls']} calls: kernel {t['ms']:.4f} ms (device {fmt_ms(t['device_ms'])}, "
            f"padded copies {t['pad_ms']:.4f} ms, weights' padded copies {t['weight_pad_ms']:.4f} ms) CUDA-core "
            f"{t['old_ms']:.4f} ms plain {t['plain_ms']:.4f} ms bound {t['bound_ms']:.4f} ms one torch.mm "
            f"{t['library_ms']:.4f} ms, max|err| {t['max_abs_err']:.3e}")
    return tot


def cr16_point_kernels(trainer, scans, label: str) -> dict:
    """SPVCNN cr 1.6's point widths on one captured train step: K6 at
    every call of 100 channels or more (the re-voxelizes of the 409-,
    204- and 153-wide point features, f32, and the devoxelize backwards)
    within 1e-5 of its plain version in f64, with its times, beside the
    layout that the wrapper did not take: where it pads the rows to whole
    16-byte pieces (`voxelize.segment_sum_cols`), K6 on the rows as they
    are, 16 pieces a lane, through its C entry (`k6_own_pieces`); else
    the copy to whole 16-byte pieces and K6 there, timed apart; K7 at its
    calls of 100 channels or more bit-identical to its plain version, with
    kernel, device, bound, plain and `index_select` / `embedding_bag`
    times; K8 at its 3 calls (`phase_k8`)."""
    import torch

    from taseg_tpu_torch.ops import voxelize as vx
    from taseg_tpu_torch.ops.sparse_conv import pad_cols, padded_width

    def hold(tag, fn, want, ref):
        got = twice_same(tag, fn)
        return check_close(tag, got, want, ref, "float32", 1e-5)

    cap = capture_train_calls(trainer, scans[:1])
    out = {"segment_sum": {}, "devoxelize": {}}
    for key, (a, kw) in sorted(cap.seen.items(), key=lambda kv: str(kv[0])):
        if key[0] == "segment_sum" and key[3] >= 100:
            x, t = a[0].detach(), a[1]
            w = a[2] if len(a) > 2 else kw.get("weights")
            kern = partial(vx.segment_sum, x, t, w)
            tag = f"{label}K6 {key[1:]}"
            want = vx.segment_sum_plain(x.double(), t, None if w is None else w.double())
            ref = vx.segment_sum_plain(x.double().abs(), t, None if w is None else w.double().abs())
            err = hold(tag, kern, want, ref)
            c, esz = x.shape[1], x.element_size()
            cols = vx.segment_sum_cols(c, esz, x.data_ptr() % 16)
            plan = vx.segment_sum_plan(c, esz, x.data_ptr() % 16)
            r = {
                "cols": cols, "ms": cuda_ms(kern), "device_ms": device_ms(kern, KERNEL_NAMES["segment_sum"], iters=5),
                "library_ms": cuda_ms(k6_library(x, t, w)),
                "bound_ms": bound_ms(k6_bytes(x, t, w)[0], 0.0, "float32")[0], "max_abs_err": err,
            }
            if cols != c:  # padded by the wrapper: the rows as they are, 16 pieces a lane
                own = partial(k6_own_pieces, x, t, w)
                hold(f"{tag} in its own pieces", own, want, ref)
                r["own_pieces_ms"] = cuda_ms(own)
                other = f"in its own pieces ({vx._layout(c, esz, x.data_ptr() % 16).pieces} a lane) " \
                        f"{r['own_pieces_ms']:.4f} ms"
            else:  # at its own width: the copy to whole 16-byte pieces and K6 there
                cp = padded_width(x.dtype, c)
                xp = pad_cols(x, cp)
                r["padded_copy_ms"] = cuda_ms(lambda: pad_cols(x, cp)) if cp != c else 0.0
                r["padded_k6_ms"] = cuda_ms(partial(vx.segment_sum, xp, t, w))
                other = f"padded to {cp} columns: copy {r['padded_copy_ms']:.4f} ms + K6 {r['padded_k6_ms']:.4f} ms"
                del xp
            del want, ref
            out["segment_sum"][str(key[1:])] = r
            log(f"{tag} {x.dtype} x{cap.count[key]}/step (run at {cols} columns, {plan.pieces} pieces of "
                f"{plan.vw} bytes a lane): max|err| {err:.3e}, bit-identical on repeat; kernel {r['ms']:.4f} ms "
                f"(device {fmt_ms(r['device_ms'])}) index_add_ {r['library_ms']:.4f} ms bound "
                f"{r['bound_ms']:.4f} ms; {other}")
        elif key[0] == "devoxelize" and key[-1] >= 100:
            z, t = a[0].detach(), a[1]
            table = t if key[1] == "trilinear" else vx.IdentityDevoxTable(inverse=t)
            ms, pms, lib, lib_err, points = devox_times(z, table)
            # device time, and the bound: the table's (idx, w) entries, the
            # rows it reads and the output, each once
            trilinear = key[1] == "trilinear"
            fn = vx.devoxelize_trilinear if trilinear else vx.devoxelize_identity
            dev = device_ms(partial(fn, z, t), KERNEL_NAMES["devoxelize"], iters=5)
            idx = t.idx if trilinear else t[None]
            c, es = z.shape[1], z.element_size()
            rows = int(torch.unique(idx[idx >= 0]).numel())
            b = bound_ms(idx.shape[0] * points * (8 if trilinear else 4) + rows * c * es + points * c * es,
                         0.0, "float32")[0]
            out["devoxelize"][str(key[1:])] = {"ms": ms, "device_ms": dev, "plain_ms": pms, "library_ms": lib,
                                               "bound_ms": b}
            log(f"{label}K7 {key[1:]} x{cap.count[key]}/step ({z.shape[1] * z.element_size()} bytes a row): "
                f"bit-identical; kernel {ms:.4f} ms (device {fmt_ms(dev)}, bound {b:.4f} ms, bytes) plain {pms:.4f} ms "
                f"{'index_select' if key[1] == 'identity' else 'embedding_bag'} {lib:.4f} ms"
                + (" SLOWER than the library call" if ms > lib else ""))
    k8 = {}
    phase_k8(k8_calls(trainer, scans), k8)
    out["voxelize_bwd"] = k8["voxelize_bwd"]
    del cap
    torch.cuda.empty_cache()
    return out


def k6_own_pieces(src, tables, weights=None):
    """K6 on `src` at its own width in its own pieces (16 a lane where
    they need more than 8: the layout that `voxelize.segment_sum` replaces
    by a padded copy), through its C entry (counted nowhere)."""
    import torch

    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops import voxelize as vx
    from taseg_tpu_torch.ops.sparse_conv import DTYPE_CODES

    dev = src.device
    v = tables.starts.shape[0] - 1
    n = tables.perm.shape[0]
    p, c = src.shape
    plan = vx._layout(c, src.element_size(), src.data_ptr() % 16)
    units = -(-n // plan.unit)
    out = torch.empty((v, c), dtype=torch.float32, device=dev)
    part = torch.empty((units, 2, c), dtype=torch.float32, device=dev)
    _build.launch(
        "taseg_segment_sum", (), src.data_ptr(), None if weights is None else weights.data_ptr(),
        tables.perm.data_ptr(), tables.starts.data_ptr(), out.data_ptr(), part.data_ptr(),
        _build.zeroed_counters(dev, units).data_ptr(), v, c, n - v, p, n, DTYPE_CODES[src.dtype],
        plan.vw, plan.lanes, plan.pieces, plan.unit, int(vx.segment_sum_by_rows(n - v, v)),
    )
    return out


def cr16_stem_k4(trainer, scans) -> dict:
    """MinkUNet cr 1.0's stem K4 (4 -> 32, bf16) at a real step's
    tables and input: the wgmma tile at C_in padded to 8 against its plain
    version and the CUDA-core kernel that took it before, with kernel,
    device, padded copies, CUDA-core, plain, bound and torch.mm times
    beside the CUDA-core time recorded in PERF.md §6."""
    import torch

    calls = conv_calls(trainer, scans)
    keys = [k for k in calls.seen if k[0] == "sparse_conv_k3" and k[2] == 4]
    if len(keys) != 1:
        raise AssertionError(f"the stem's first conv: {keys}")
    x, _, _, bwd, _ = calls.seen[keys[0]]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    g = torch.randn(x.shape[0], keys[0][3], device=x.device, generator=gen).to(x.dtype)
    r = cr16_call(f"stem K4 (cr 1.0) {keys[0][1:]}", "k3_conv_dw", 1, x, g, bwd.rb, {"pairs": bwd.pairs})
    log(f"stem K4 (cr 1.0, 4 -> 32): {r['ms']:.4f} ms on wgmma (device {fmt_ms(r['device_ms'])}, padded copies "
        f"{r['pad_ms']:.4f}) beside {STEM_K4_PARENT_MS} ms on CUDA cores in PERF.md §6 "
        f"(this run's CUDA-core kernel: {r['old_ms']:.4f} ms)")
    return r


def phase_cr16(scans=None, trainer=None) -> dict:
    """MinkUNet and SPVCNN mk34 at cr 1.6 (5l), the five recipes at full
    width in bf16: the KITTI ones on `scans` (synthetic 120 000-point
    scans), the Waymo ones on a sensor-sized tree
    (`tests/torch_nuscenes_fixture.make_waymo_root` at WAYMO_CARD).
    Each serves CR16_SCANS counted scans (the cr 1.0 backbones' launches
    per scan) by stage with its peak memory; the KITTI MinkUNet and
    SPVCNN and the Waymo MinkUNet take a counted train step and two by
    stage.  No K2, K3, K4 or K5 launch of these paths takes a CUDA-core
    kernel.  Every padded call of the KITTI MinkUNet's forward and step
    against its plain version at its captured shape, beside the
    CUDA-core kernel at the same call and the padded copies
    (`cr16_padded_calls`); the xyz recipe's 3-wide stem the same;
    SPVCNN's K6, K7 and K8 at its point widths (`cr16_point_kernels`);
    MinkUNet cr 1.0's stem K4 on the main `trainer` (`cr16_stem_k4`;
    without one, on a fresh bf16 trainer of the flagship, and `scans`
    made here where not given).  Returns the launches, times and the
    phase's seconds."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    sys.path.insert(0, str(REPO / "tests"))
    from torch_nuscenes_fixture import WAYMO_CARD, make_waymo_root

    from taseg_tpu_torch.configs import RECIPES
    from taseg_tpu_torch.data import build_reader
    from taseg_tpu_torch.engine import Segmenter, Trainer
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    t_phase = time.perf_counter()
    if scans is None:
        scans = make_scans(N_SCANS)
    if trainer is None:
        from taseg_tpu_torch.configs import MINKUNET_MK34_CR10

        p, st = init_params_numpy(MINKUNET_MK34_CR10, seed=SEED)
        trainer = Trainer(MINKUNET_MK34_CR10, {"params": p, "batch_stats": st}, iters_per_epoch=2,
                          total_epochs=36, compute_dtype="bfloat16", seed=SEED)
        trainer.step(scans[:1])  # warm-up
    res: dict = {"paths": {}}
    (REPO / "build").mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="cr16_", dir=REPO / "build"))
    try:
        waymo = make_waymo_root(tmp / "waymo", seed=SEED, **WAYMO_CARD)
        res["stem_k4"] = cr16_stem_k4(trainer, scans)
        for name, path, data, trained in CR16_PATHS:
            cfg = RECIPES[path]
            if data == "waymo":
                cfg = {**cfg, "DATA": {**cfg["DATA"], "DATA_PATH": str(waymo)}}
                r_serve, r_train = build_reader(cfg["DATA"], False), build_reader(cfg["DATA"], True)
                serve = [r_serve[i] for i in range(CR16_SCANS + 1)]
                train = [r_train[i] for i in range(3)]
            else:
                serve = train = scans[: CR16_SCANS + 1]
            spv = cfg["MODEL"]["NAME"] == "SPVCNN"
            p, st = init_params_numpy(cfg, seed=SEED)
            v = {"params": p, "batch_stats": st}
            seg = Segmenter(cfg, v, compute_dtype="bfloat16")
            seg.predict(serve[:1])  # warm-up
            out, per = nw_counted(f"{name} serving", lambda: seg.predict(serve[1:]),
                                  exact=SPV34_PER_SCAN if spv else MK34_PER_SCAN, must=("join_scan",),
                                  n=CR16_SCANS, never=("voxelize_bwd",))
            if cuda_core_launches(per):
                raise AssertionError(f"{name} serving: CUDA-core launches {cuda_core_launches(per)}")
            nw_check_points(name, serve[1:], out, cfg["MODEL"]["NUM_CLASS"])
            r = {"serve_launches": per, "serve": nw_serve_stages(seg, serve[1:], f"{name} ")}
            del seg
            torch.cuda.empty_cache()
            if trained:
                tr = Trainer(cfg, v, iters_per_epoch=4, total_epochs=cfg["OPTIM"]["NUM_EPOCHS"],
                             compute_dtype="bfloat16", seed=SEED)
                tr.step(train[:1])  # warm-up
                step, per_s = nw_counted(f"{name} train step", lambda: tr.step(train[1:2]),
                                         exact=SPV34_PER_STEP if spv else MK34_PER_STEP, must=("join_scan",))
                if cuda_core_launches(per_s):
                    raise AssertionError(f"{name} train step: CUDA-core launches {cuda_core_launches(per_s)}")
                if not (np.isfinite(step["loss"]) and np.isfinite(step["grad_norm"])):
                    raise AssertionError(f"{name}: non-finite loss or grad norm")
                log(f"{name} train step: loss {step['loss']:.5f} grad norm {step['grad_norm']:.4f} level "
                    f"voxels {step['level_nums']} of {list(tr.caps.voxels)}")
                r.update(step_launches=per_s, step=nw_step_stages(tr, train[1:], f"{name} "))
                if name == "kitti minkunet cr16":
                    r["padded"] = cr16_padded_calls(conv_calls(tr, train), f"{name} ")
                elif name == "kitti spvcnn cr16":
                    r["point_kernels"] = cr16_point_kernels(tr, train, f"{name} ")
                del tr
            elif name == "waymo minkunet cr16 xyz":  # the 3-wide stem's conv alone
                tr = Trainer(cfg, v, iters_per_epoch=4, total_epochs=cfg["OPTIM"]["NUM_EPOCHS"],
                             compute_dtype="bfloat16", seed=SEED)
                calls = conv_calls(tr, train)
                calls.seen = {k: c for k, c in calls.seen.items() if k[2] == 3}
                if len(calls.seen) != 1:
                    raise AssertionError(f"{name}: the stem's conv {sorted(calls.seen)}")
                r["padded"] = cr16_padded_calls(calls, f"{name} ")
                del tr, calls
            log(f"{name}: no CUDA-core launch of K2, K3, K4 or K5 "
                f"({'serving and train step' if trained else 'serving'})")
            res["paths"][name] = r
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"cr 1.6 phase (5l): {res['seconds']:.1f} s")
    return res


def cr16_entry(res: dict, name: str) -> dict:
    """A kernel's launches per scan and per step on each cr 1.6 path of
    phase 5l, and its padded calls' totals (the KITTI MinkUNet's per
    scan or per step; `<name>_dgrad` its input gradients)."""
    out = {}
    for path, p in res["paths"].items():
        scan, step = p["serve_launches"].get(name, 0), p.get("step_launches", {}).get(name, 0)
        if scan or step:
            out[path] = {"launches_per_scan": scan, "launches_per_step": step if "step_launches" in p else None}
        for key in (name, name + "_dgrad"):
            if key in p.get("padded", {}):
                out.setdefault(path, {})["padded" if key == name else "padded_dgrad"] = p["padded"][key]
        pk = p.get("point_kernels", {}).get(name)
        if pk:
            out.setdefault(path, {})["point_widths"] = pk
    if name == "k3_conv_dw":
        out["stem_k4_cr10"] = dict(res["stem_k4"], parent_ms=STEM_K4_PARENT_MS)
    return out


# K10 (`segment_max`, csrc/segment_max.cu): each check holds the kernels
# to the bits of their plain versions both ways, on repeat, with one
# counted launch a call each way and the kernels a call below (the
# kernel nodes of a captured CUDA graph, `graph_kernels`), and times
# them beside their first design (`old_ms`), their bound and one
# scatter_reduce(amax) with its -inf fill
K10_SOURCE = ("csrc/segment_max.cu", "taseg_tpu/models/voxel/cylinder3d.py:236, taseg_tpu/ops/bev.py:43")
# Cylinder_TS's serving and train paths: K10 once a scan, 1 + 1 a step
CYLINDER_K10_PER_SCAN = {"segment_max": 1}
CYLINDER_K10_PER_STEP = {"segment_max": 2, "segment_max_bwd": 1}
# K10's kernels a call: the forward's -inf fill and runs kernel; the
# backward's fill of the tie counts, tie count and shares
K10_KERNELS_PER_CALL = {"forward": 2, "backward": 3}

# Phase 5m (this slice's path): torchsparse's demo backbones and the BEV
# family on two synthetic 120 000-point scans quantized at 0.05 m, batch
# 2, 4 input features; the new losses and optimizers on the MinkUNet
# flagship.  The capacities hold the two scans' voxels with room to spare
# (the level counts are logged beside them and an overflow fails): the
# stride-2 stages of kernel 3 take every stride-2 point within one voxel
# of an input, so stage 1 holds more voxels than stage 0 (SEED's two
# scans: 159 581, 245 335, 155 865, 58 329, 38 450 on the CPU).
BB_POINT_CAP = 262_144
RESNET_CAPS = (262_144, 327_680, 196_608, 98_304, 65_536)
BB_TRAIN_LR = 0.01
# the flagship's 2-step variants of the new losses and optimizers:
# (label, LOSS_TYPES, OPTIM keys, the small-scan step's tolerances (loss,
# grad norm, update) card against CPU); WCELoss reads class counts, which
# no config carries (JAX's engine passes none either): the variant's
# criterion is rebuilt with the scans' label histogram.  adam_onecycle
# takes Adam's normalised step at LR / 10 from the first update, where
# each parameter moves by about the LR whichever way its gradient's last
# bits tip it: its step 1 is held looser (measured on an H100 80GB HBM3
# at 700 W: loss 4.0e-4, grad norm 4.9e-3, the update 1.4e-1 off the
# CPU's)
# the variant whose small-scan f32 steps run on the card against the CPU
# (the four new losses and adam; the CPU tests hold every variant to JAX)
SMALL_STEP_VARIANT = "wce/focal/dice1/ell+adam"
LOSS_VARIANTS = (
    ("eqlv2+sgd_fc", ["CELoss", "LovLoss", "EQLv2"], {"OPTIMIZER": "sgd_fc"}, (1e-4, 1e-3, 3e-2)),
    ("wce/focal/dice1/ell+adam", ["WCELoss", "FocalLoss", "DiceLossV1", "ELLLoss"],
     {"OPTIMIZER": "adam", "LR_PER_SAMPLE": 0.0005}, (1e-4, 1e-3, 3e-2)),
    ("ce/lov+adam_onecycle", ["CELoss", "LovLoss"],
     {"OPTIMIZER": "adam_onecycle", "LR_PER_SAMPLE": 0.0005, "MOMS": (0.95, 0.85), "DIV_FACTOR": 10.0,
      "PCT_START": 0.4}, (2e-3, 2e-2, 2.5e-1)),
)


def bits(t):
    """A float tensor's bits (f32 as int32, bf16 as int16)."""
    import torch

    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


def graph_kernels(fn) -> tuple:
    """(kernels, other nodes) that one call of `fn` puts on the card: the
    node types of a CUDA graph captured around the call, read back through
    libcuda (`cuGraphGetNodes`, `cuGraphNodeGetType`).  The capture
    records every launch, where the profiler loses events of such short
    kernels; raises where the graph cannot be captured or read."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    drv = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if drv.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * max(1, n.value))()
    if n.value and drv.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = []
    for node in nodes[: n.value]:
        kind = ctypes.c_int(-1)
        if drv.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds.append(kind.value)
    del graph
    torch.cuda.synchronize()
    kernels = kinds.count(0)  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels, len(kinds) - kernels


def in_turns(new, old, iters: int = 10, timer=None) -> tuple:
    """`cuda_ms` (or `timer`) of `new` and `old` in turns (new, old, old,
    new): each one's mean of its two samples (None where one is)."""
    t = timer or (lambda fn: cuda_ms(fn, iters))
    a, b, c, d = t(new), t(old), t(old), t(new)
    mean = lambda x, y: None if x is None or y is None else (x + y) / 2
    return mean(a, d), mean(b, c)


def k10_check(label: str, x, seg, s: int, g=None, timed: bool = True) -> dict:
    """K10 at one shape: forward and backward bit-equal to the plain
    versions on the same card tensors (a max of zeros +0.0 in both),
    bit-identical on repeat, one counted launch a call each way and the
    kernels a call that K10_KERNELS_PER_CALL says (`graph_kernels`); the
    first design (`segment_max_v1`, `segment_max_bwd_v1`) to the same
    bits.  With `timed`: each way's `cuda_ms` in turns with the first
    design's (`old_ms`: its torch fill and cast included), every kernel of
    a call on the device for both, a train step's pair (the forward, then
    the backward over its output) the same way, the plain versions' ms,
    the bound (bytes: x and the ids read and out written once; backward x,
    ids, out, g read and dx written) and, forward, one
    scatter_reduce(amax) with its -inf fill (`library_ms`)."""
    import torch

    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.ops import voxelize as vx

    if g is None:
        gen = torch.Generator(device=x.device).manual_seed(SEED)
        g = torch.randn((s, x.shape[1]), device=x.device, generator=gen).to(x.dtype)
    seg = seg.to(torch.int32).contiguous()
    _build.reset_launches()
    out = vx.segment_max_kernel(x, seg, s)
    again = vx.segment_max_kernel(x, seg, s)
    dx = vx.segment_max_bwd_kernel(x, seg, out, g)
    dx2 = vx.segment_max_bwd_kernel(x, seg, out, g)
    torch.cuda.synchronize()
    if (_build.LAUNCHES["segment_max"], _build.LAUNCHES["segment_max_bwd"]) != (4, 2):
        raise AssertionError(f"K10 {label}: launches {_build.LAUNCHES['segment_max']} for 2 + 2 calls")
    want, dwant = vx.segment_max_plain(x, seg, s), vx.segment_max_bwd_plain(x, seg, out, g)
    old, dold = vx.segment_max_v1(x, seg, s), vx.segment_max_bwd_v1(x, seg, out, g)
    for name, a, b in (("forward", out, want), ("repeat", again, out), ("backward", dx, dwant),
                       ("backward repeat", dx2, dx), ("first design", old, want),
                       ("first design's backward", dold, dwant)):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"K10 {label}: {name} differs from its plain version in the bits")
    fwd = lambda: vx.segment_max_kernel(x, seg, s)
    bwd = lambda: vx.segment_max_bwd_kernel(x, seg, out, g)
    step = lambda: vx.segment_max_bwd_kernel(x, seg, vx.segment_max_kernel(x, seg, s), g)
    per_call = {}
    for way, fn in (("forward", fwd), ("backward", bwd)):
        kernels, others = graph_kernels(fn)
        if (kernels, others) != (K10_KERNELS_PER_CALL[way], 0):
            raise AssertionError(f"K10 {label}: {way} {kernels} kernels and {others} other graph nodes a call, "
                                 f"{K10_KERNELS_PER_CALL[way]} kernels expected")
        per_call[way] = kernels
    # columns where some segment but the last (the dropped rows') has
    # more than one member at its max
    hit = (x == out.gather(0, seg.long()[:, None].expand_as(x))) & (seg < s - 1)[:, None]
    n_hit = torch.zeros((s, x.shape[1]), dtype=torch.int32, device=x.device)
    n_hit.scatter_add_(0, seg.long()[:, None].expand_as(x), hit.int())
    ties = int((n_hit > 1).any(0).sum())
    p, c = x.shape
    r = {"shape": [p, c, s], "dtype": str(x.dtype).split(".")[1], "max_abs_err": 0.0,
         "columns_with_tied_maxima": ties, "kernels_per_call": per_call}
    if not timed:
        log(f"K10 {label} P={p} C={c} S={s} {r['dtype']}: bit-exact both ways, repeat bit-identical, the first "
            f"design too, kernels a call {per_call} (the graph); {ties} of {c} columns with tied maxima")
        return r
    esz = x.element_size()
    b_f, by_f = bound_ms(p * c * esz + p * 4 + s * c * esz, 0, "float32")
    b_b, by_b = bound_ms(2 * p * c * esz + p * 4 + 2 * s * c * esz, 0, "float32")
    idx = seg.long()[:, None].expand(-1, c)
    library = lambda: torch.full((s, c), float("-inf"), dtype=x.dtype, device=x.device).scatter_reduce_(
        0, idx, x, "amax")
    old_fwd = lambda: vx.segment_max_v1(x, seg, s)
    old_bwd = lambda: vx.segment_max_bwd_v1(x, seg, out, g)
    old_step = lambda: vx.segment_max_bwd_v1(x, seg, vx.segment_max_v1(x, seg, s), g)
    for way, new, old in (("", fwd, old_fwd), ("bwd_", bwd, old_bwd), ("step_", step, old_step)):
        r[f"{way}ms"], r[f"{way}old_ms"] = in_turns(new, old)
        r[f"{way}device_ms"], r[f"{way}old_device_ms"] = in_turns(new, old, timer=graph_ms)
    r.update({
        "plain_ms": cuda_ms(lambda: vx.segment_max_plain(x, seg, s)),
        "bound_ms": b_f, "bound_by": by_f, "library_ms": cuda_ms(library),
        "library_device_ms": graph_ms(library),
        "bwd_plain_ms": cuda_ms(lambda: vx.segment_max_bwd_plain(x, seg, out, g)),
        "bwd_bound_ms": b_b, "bwd_bound_by": by_b, "bwd_library_ms": None,
        "step_bound_ms": b_f + b_b,
    })
    log(
        f"K10 {label} P={p} C={c} S={s} {r['dtype']}: bit-exact both ways, repeat bit-identical, the first "
        f"design too, kernels a call {per_call} (the graph); {ties} of {c} columns with tied maxima; forward "
        f"{r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}; first design {r['old_ms']:.4f}, device "
        f"{fmt_ms(r['old_device_ms'])}; plain {r['plain_ms']:.4f}; scatter_reduce amax with its fill "
        f"{r['library_ms']:.4f}, device {fmt_ms(r['library_device_ms'])}; bound {b_f:.4f}); backward "
        f"{r['bwd_ms']:.4f} ms (device {fmt_ms(r['bwd_device_ms'])}; first design {r['bwd_old_ms']:.4f}, device "
        f"{fmt_ms(r['bwd_old_device_ms'])}; plain {r['bwd_plain_ms']:.4f}; bound {b_b:.4f}); a step's pair "
        f"{r['step_ms']:.4f} ms (device {fmt_ms(r['step_device_ms'])}; first design {r['step_old_ms']:.4f}, "
        f"device {fmt_ms(r['step_old_device_ms'])}; bound {b_f + b_b:.4f})"
    )
    return r


def no_aten_op(fn, op: str, what: str) -> None:
    """Run `fn` under the profiler (host ops only) and fail if `op` ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    hits = [e.key for e in prof.key_averages() if op in e.key]
    if hits:
        raise AssertionError(f"{what} ran {hits}")
    log(f"{what}: no {op}")


def phase_k10_cylinder(seg, scans) -> dict:
    """K10 at Cylinder_TS's real call: the (P, 16) f32 compression
    features of one scan (a ReLU's output, -0.0 planted in 5% of them)
    into the level-0 voxels and the padding rows' sentinel segment, both
    ways (`k10_check`); each voxel holds one row there, so the same call
    again with every two voxels' rows in one segment plants the ties
    (exact zeros and equal values in most segments).  Returns the real
    call's numbers."""
    import torch

    a = seg.collate(scans[:1])
    topo = seg.topology(a)
    inv, v0 = topo.point_inverse, topo.levels[0].coords.shape[0]
    ids = torch.where(inv >= 0, inv, v0)
    gen = torch.Generator(device=inv.device).manual_seed(SEED)
    x = torch.relu(torch.randn(inv.shape[0], 16, device=inv.device, generator=gen))
    x = torch.where(torch.rand(x.shape, device=x.device, generator=gen) < 0.05, -0.0, x)
    x = torch.where((inv >= 0)[:, None], x, float("-inf"))
    r = k10_check("cylinder", x, ids, v0 + 1)
    k10_check("cylinder, ties planted", x, torch.where(inv >= 0, inv // 2, v0), v0 + 1, timed=False)
    return r


def bb_inputs(scans, dev, cap: int = BB_POINT_CAP) -> dict:
    """Two scans quantized at 0.05 m (the voxel pipeline, eval form),
    collated with a batch column: coords (cap, 4) int32, feats (cap, 4)
    f32, num, and the (x, y, z) extent of the voxels."""
    import numpy as np
    import torch

    from taseg_tpu_torch.data.voxel_dataset import VoxelPipeline, collate_shard

    pipe = VoxelPipeline(0.05, training=False)
    a = collate_shard([pipe(s) for s in scans[:2]], cap)
    n = int(a["num_points"][0])
    return {
        "coords": torch.from_numpy(a["point_coords"].astype(np.int32)).to(dev),
        "feats": torch.from_numpy(a["point_feats"]).to(dev), "num": n,
        "extent": a["point_coords"][:n, :3].max(0).astype(np.int64) + 1,
    }


def bb_topology(kind: str, inp: dict, train: bool, caps):
    """(topology, input features at its first level) of either backbone."""
    import torch

    from taseg_tpu_torch.models.voxel import backbones as bb
    from taseg_tpu_torch.models.voxel.backbone_context import build_unet_topology
    from taseg_tpu_torch.ops.voxelize import voxelize_avg

    if kind == "resnet":
        topo = bb.build_resnet_topology(inp["coords"], inp["num"], caps, train=train)
        levels = topo.stages
    else:
        topo = build_unet_topology(
            inp["coords"].float(), torch.tensor(inp["num"], dtype=torch.int32, device=inp["coords"].device),
            caps, devox_pairs=train, nonneg_coords=True,
        )
        levels = topo.levels
    for i, (l, c) in enumerate(zip(levels, caps if kind == "resnet" else caps.voxels)):
        if int(l.num) > c:
            raise AssertionError(f"{kind}: level {i} holds {int(l.num)} voxels > capacity {c}")
    return topo, voxelize_avg(inp["feats"], topo.point_inverse, topo.point_tables)


def bb_model(kind: str, dev, width: float = 1.0):
    from taseg_tpu_torch.models.voxel import backbones as bb
    from taseg_tpu_torch.utils.params_from_jax import init_module_numpy, load_flax_params

    net = bb.SparseResNet21D if kind == "resnet" else bb.SparseResUNet42
    model = net(in_channels=4, width_multiplier=width, device=dev)
    params, stats = init_module_numpy(net(in_channels=4, width_multiplier=width, device="cpu"), SEED)
    load_flax_params(model, params, stats)
    return model


def bb_caps(kind: str, cap: int):
    from taseg_tpu_torch.models.voxel.backbone_context import UNetCapacities

    if kind == "resnet":
        # small scans are sparser: their stride-2 stages grow more
        return RESNET_CAPS if cap == BB_POINT_CAP else (cap,) + (4 * cap,) * 4
    # the default schedule holds the two full scans (159 581, 105 993,
    # 53 517, 21 562, 7 421 voxels on the CPU); small scans fill every level
    return UNetCapacities.for_points(cap, schedule=None if cap == BB_POINT_CAP else (1.0,) * 5)


def bev_callables(grid, bounds, extent, dev) -> tuple:
    """The six pools and BEV modules on `grid` (SparseResNet21D's last
    stage, 128 channels, read at stride 8 on x and z; its y stride is 16),
    batch 2, a BEV map over the scans' extent, built here once (their
    weights drawn in this order from one seeded generator): name -> (a
    call of the module on `grid` returning its output tensors, the
    module's parameters), and the map's shape."""
    import math

    import torch

    from taseg_tpu_torch import models as tm

    s = grid.stride
    shape = tuple(int(math.ceil(e / s)) for e in extent)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    c = grid.feats.shape[1]
    dense = tm.ToDenseBEVConvolution(c, 64, shape, batch_size=2, use_bias=True, generator=gen).to(dev)
    conv = tm.ToBEVConvolution(c, 64, shape[2], stride=2, use_bias=True, generator=gen).to(dev)

    def sparse(out):
        return out.feats[: int(out.num)], out.coords[: int(out.num)]

    calls = {
        "GlobalAvgPool": (lambda: (tm.GlobalAvgPool(2)(grid),), ()),
        "GlobalMaxPool": (lambda: (tm.GlobalMaxPool(2)(grid),), ()),
        "ToBEVReduction": (lambda: sparse(tm.ToBEVReduction(2)(grid, bounds)), ()),
        "ToDenseBEVConvolution": (lambda: (dense(grid),), tuple(dense.parameters())),
        "ToBEVConvolution": (lambda: sparse(conv(grid, bounds)), tuple(conv.parameters())),
        "ToBEVHeightCompression": (lambda: (tm.ToBEVHeightCompression(c, shape, batch_size=2)(grid),), ()),
    }
    return calls, shape


def bev_modules(grid, bounds, extent, dev) -> tuple:
    """`bev_callables`' six modules built and run once: (name -> output
    (a tensor, or a SparseGrid's valid feats), the map's shape)."""
    calls, shape = bev_callables(grid, bounds, extent, dev)
    return {k: f()[0] for k, (f, _) in calls.items()}, shape


def bev_module_times(grid, bounds, extent) -> dict:
    """Each of the six modules' device ms (every kernel of a call,
    torch.profiler), `cuda_ms` and bytes bound: the grid's valid feats and
    coords and the module's parameters read once, its output tensors
    (a sparse output's valid rows and coords) written once."""
    import torch

    calls, _ = bev_callables(grid, bounds, extent, "cuda")
    n = int(grid.num)
    read = grid.feats[:n].nbytes + grid.coords[:n].nbytes
    out = {}
    with torch.no_grad():
        for k, (fn, params) in calls.items():
            nbytes = read + sum(p.nbytes for p in params) + sum(t.nbytes for t in fn())
            b, by = bound_ms(nbytes, 0, "float32")
            out[k] = {"device_ms": call_device_ms(fn), "ms": cuda_ms(fn), "bound_ms": b, "bound_by": by,
                      "bytes": nbytes}
    log("BEV / pools one by one (device ms, cuda_ms, bytes bound): " + "; ".join(
        f"{k} {fmt_ms(v['device_ms'])}, {v['ms']:.4f} ms, bound {v['bound_ms']:.5f} ms ({v['bytes']} bytes)"
        for k, v in out.items()))
    return out


def bb_grid(topo, out):
    from taseg_tpu_torch.ops.sparse_tensor import SparseGrid

    st = topo.stages[-1]
    return SparseGrid(coords=st.coords, feats=out, num=st.num, stride=8)


# phase_bb_small's tolerances, of each output's scale: the backbones'
# features (3xTF32 and another summation order); the pools and BEV maps,
# whose CPU side sums a batch's ~8 000 rows by a mean-centred cumsum (the
# JAX package's `segment_sum`, K6's plain version: ~1e-4 off over such
# segments, 1.24e-4 measured on an H100 80GB HBM3 at 700 W against K6's
# fixed-order sum)
BB_SMALL_TOL = {"resnet": 1e-4, "unet": 1e-4, "bev": 1e-3}


def phase_bb_small() -> None:
    """Card against CPU on two 8000-point scans: both backbones' eval
    features at width 0.25 in f32, and the six pools and BEV modules on
    the ResNet's last stage, within BB_SMALL_TOL of their scale."""
    import torch

    small = make_scans(2, n_points=8000, seed=SEED + 1)
    res = {}
    for dev in ("cuda", "cpu"):
        inp = bb_inputs(small, dev, cap=16_384)
        out = {}
        for kind in ("resnet", "unet"):
            model = bb_model(kind, dev, 0.25)
            model.eval()
            topo, x0 = bb_topology(kind, inp, False, bb_caps(kind, 16_384))
            with torch.no_grad():
                feats = model(x0, topo)
            out[kind] = [f.float().cpu() for f in feats]
            if kind == "resnet":
                with torch.no_grad():
                    bev, _ = bev_modules(bb_grid(topo, feats[-1]), topo.bounds, inp["extent"], dev)
                out["bev"] = [v.float().cpu() for v in bev.values()]
        res[dev] = out
    worst = {}
    for k in res["cpu"]:
        for a, b in zip(res["cuda"][k], res["cpu"][k], strict=True):
            err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)
            worst[k] = max(worst.get(k, 0.0), err)
            if not err <= BB_SMALL_TOL[k]:
                raise AssertionError(f"backbones small {k}: card vs cpu {err:.3e} of the scale")
    log(f"backbones/BEV small scans f32 card vs cpu, worst |d| / scale: "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def bb_counted(fn):
    """(fn's result, its launches, its device ms (CUDA events))."""
    import torch

    from taseg_tpu_torch.ops import _build

    torch.cuda.synchronize()
    _build.reset_launches()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    r = fn()
    e1.record()
    e1.synchronize()
    return r, {k: v for k, v in _build.LAUNCHES.items() if v}, e0.elapsed_time(e1)


def phase_backbone(kind: str, inp: dict) -> dict:
    """One backbone at full width on the two scans: the eval topology,
    an f32 and a bf16 forward (finite; bf16 within 5e-2 of f32's scale
    per stage), the train topology and one f32 train step with a feature
    loss (mean square of every stage output, the port's SGD), each
    stage counted (launches per wrapper) and timed (CUDA events), the
    second run of each after a warm-up; peak memory."""
    import torch

    from taseg_tpu_torch.optim import build_optimizer

    caps = bb_caps(kind, BB_POINT_CAP)
    model = bb_model(kind, "cuda")
    model.eval()
    r = {}
    for _ in range(2):  # the second pass is the measured one
        torch.cuda.reset_peak_memory_stats()
        (topo, x0), r["topology_launches"], r["topology_ms"] = bb_counted(lambda: bb_topology(kind, inp, False, caps))
        with torch.no_grad():
            f32, r["forward_f32_launches"], r["forward_f32_ms"] = bb_counted(lambda: model(x0, topo))
            b16, r["forward_bf16_launches"], r["forward_bf16_ms"] = bb_counted(lambda: model(x0.bfloat16(), topo))
        r["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    levels = topo.stages if kind == "resnet" else topo.levels
    r["level_voxels"] = [int(l.num) for l in levels]
    r["capacities"] = list(caps if kind == "resnet" else caps.voxels)
    agree = []
    for a, b in zip(b16, f32):
        if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
            raise AssertionError(f"{kind}: non-finite features")
        agree.append(float((a.float() - b).abs().max()) / max(float(b.abs().max()), 1e-6))
    r["bf16_vs_f32"] = agree
    if max(agree) > 5e-2:
        raise AssertionError(f"{kind}: bf16 features off f32's by {max(agree):.3e} of the scale")
    last = f32[-1]
    del f32, b16, topo
    model.train()
    # no warmup: the step runs at BB_TRAIN_LR
    opt = build_optimizer(model.parameters(), {"OPTIMIZER": "sgd", "LR": BB_TRAIN_LR, "WARMUP_EPOCH": 0}, 1, 1)
    for _ in range(2):
        torch.cuda.reset_peak_memory_stats()
        (topo, x0), r["train_topology_launches"], r["train_topology_ms"] = bb_counted(
            lambda: bb_topology(kind, inp, True, caps))
        outs, r["train_forward_launches"], r["train_forward_ms"] = bb_counted(lambda: model(x0, topo))
        loss = sum((o.float() ** 2).mean() for o in outs)
        _, r["backward_launches"], r["backward_ms"] = bb_counted(lambda: (opt.zero_grad(), loss.backward()))
        (g_norm, _), _, r["update_ms"] = bb_counted(opt.step)
        r["train_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if not (torch.isfinite(loss) and torch.isfinite(g_norm)):
            raise AssertionError(f"{kind}: non-finite train step")
        del outs, topo, loss
    r["loss_grad_norm"] = [float(g_norm)]
    log(f"backbone {kind}: level voxels {r['level_voxels']} caps {r['capacities']}; topology "
        f"{r['topology_ms']:.3f} ms, forward f32 {r['forward_f32_ms']:.3f} ms, bf16 "
        f"{r['forward_bf16_ms']:.3f} ms (bf16 vs f32 worst {max(agree):.3e}); train topology "
        f"{r['train_topology_ms']:.3f} ms, forward {r['train_forward_ms']:.3f} ms, backward "
        f"{r['backward_ms']:.3f} ms, update {r['update_ms']:.3f} ms; peak {r['serve_peak_gib']:.2f} / "
        f"{r['train_peak_gib']:.2f} GiB")
    for k in ("topology_launches", "forward_f32_launches", "forward_bf16_launches", "backward_launches"):
        log(f"  {kind} {k}: {r[k]}")
    if kind == "resnet":
        if not (r["forward_f32_launches"].get("sparse_conv_k_tf32", 0) >= 3
                and r["backward_launches"].get("sparse_conv_dw", 0) >= 3):
            raise AssertionError("resnet: its strided entry convs did not run K2 / K4 at K offsets")
    elif not (r["forward_bf16_launches"].get("strided_down_wgmma", 0) == 4
              and r["backward_launches"].get("strided_dw", 0) == 8):
        raise AssertionError("unet: K3-down on wgmma in bf16 and K5 in the step expected")
    r["last"] = last
    return r


def loss_variants(scans) -> dict:
    """The MinkUNet flagship (bf16, full width) with each of
    LOSS_VARIANTS: two counted train steps on the scans (finite loss and
    grad norm; EQLv2's statistics moved and summed into `loss_state`);
    then SMALL_STEP_VARIANT's small-scan f32 steps on the card against
    the CPU (`phase_small_train_step`)."""
    import numpy as np
    import torch

    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
    from taseg_tpu_torch.engine import Trainer
    from taseg_tpu_torch.loss import Losses
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    base = MINKUNET_MK34_CR10
    params, stats = init_params_numpy(base, seed=SEED)
    variables = {"params": params, "batch_stats": stats}
    counts = np.bincount(np.concatenate([s["labels"] for s in scans]), minlength=20).astype(np.float64) + 1.0
    out = {}

    def prepare(tr):
        if "WCELoss" in tr.criterion.loss_types:
            tr.criterion = Losses(tr.criterion.loss_types, [1.0] * len(tr.criterion.loss_types),
                                  ignore_index=0, cls_num_pts=counts)

    for label, types, optim, tol in LOSS_VARIANTS:
        cfg = {**base, "MODEL": {**base["MODEL"], "LOSS_CONFIG": {
            "LOSS_TYPES": types, "LOSS_WEIGHTS": [1.0] * len(types)}},
            "OPTIM": {**base["OPTIM"], **optim}}
        tr = Trainer(cfg, variables, iters_per_epoch=2, total_epochs=2, compute_dtype="bfloat16", seed=SEED)
        prepare(tr)
        steps = []
        t0 = time.perf_counter()
        for i in range(2):
            m = tr.step(scans[i : i + 1])
            steps.append((m["loss"], m["grad_norm"], m["lr"]))
            if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
                raise AssertionError(f"{label}: non-finite step {i}")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 2
        if "EQLv2" in types and not bool((tr.loss_state.neg_grad > 0).all()):
            raise AssertionError(f"{label}: EQLv2's statistics did not move")
        log(f"flagship {label}: 2 bf16 steps (loss, grad norm, lr) {steps}, {ms:.1f} ms a step on the host clock")
        out[label] = {"steps": steps, "ms_per_step": ms}
        del tr
        torch.cuda.empty_cache()
        if label == SMALL_STEP_VARIANT:
            phase_small_train_step(cfg, variables, f"flagship {label} ", prepare=prepare, tol=tol)
    return out


def phase_backbones(scans) -> dict:
    """Phase 5m: SparseResNet21D (torchsparse's widths, 16-128) and
    SparseResUNet42 (32-256, decoder 256/128/96/96) on two 120 000-point
    scans (`phase_backbone`), the six pools and BEV modules on
    SparseResNet21D's last stage with every launch counted (K10 in the
    max pool) and K10 held at the pool's shape, card against CPU on small
    scans, and the new losses and optimizers on the MinkUNet flagship
    (`loss_variants`).  Returns its numbers and seconds."""
    import torch

    t_phase = time.perf_counter()
    inp = bb_inputs(scans, "cuda")
    log(f"phase 5m: two scans, {inp['num']} voxels at 0.05 m, extent {inp['extent'].tolist()}")
    res = {"resnet": phase_backbone("resnet", inp)}
    last = res["resnet"].pop("last")
    topo, _ = bb_topology("resnet", inp, False, bb_caps("resnet", BB_POINT_CAP))
    grid = bb_grid(topo, last)
    with torch.no_grad():
        (bev, shape), launches, ms = bb_counted(lambda: bev_modules(grid, topo.bounds, inp["extent"], "cuda"))
    for k, v in bev.items():
        if not torch.isfinite(v).all():
            raise AssertionError(f"{k}: non-finite output")
    if launches.get("segment_max", 0) != 1 or not launches.get("segment_sum") or not launches.get("sparse_conv_k"):
        raise AssertionError(f"BEV modules: launches {launches} (K10 once, K6 and K2 at K expected)")
    res["bev"] = {"map_shape": list(shape), "launches": launches, "ms": ms,
                  "outputs": {k: list(v.shape) for k, v in bev.items()},
                  "modules": bev_module_times(grid, topo.bounds, inp["extent"])}
    log(f"BEV / pools on the last stage ({int(grid.num)} voxels x {grid.feats.shape[1]}, map {shape}): "
        f"{ms:.3f} ms, launches {launches}, outputs {res['bev']['outputs']}")
    bid = torch.where(grid.valid_mask(), grid.coords[:, 3], 2).to(torch.int32)
    res["k10_pool"] = k10_check("pool", grid.feats.float().contiguous(), bid, 3)
    res["k10_pool_bf16"] = k10_check("pool bf16", grid.feats.bfloat16().contiguous(), bid, 3)
    # the same rows on a grid of 0.5: most columns' maxima tied
    tied = (grid.feats.float() * 2).round() / 2
    k10_check("pool, ties planted", tied, bid, 3, timed=False)
    k10_check("pool bf16, ties planted", tied.bfloat16(), bid, 3, timed=False)
    del bev, grid, topo, last
    torch.cuda.empty_cache()
    res["unet"] = phase_backbone("unet", inp)
    res["unet"].pop("last")
    del inp
    torch.cuda.empty_cache()
    phase_bb_small()
    res["losses"] = loss_variants(scans)
    res["seconds"] = time.perf_counter() - t_phase
    log(f"phase 5m: {res['seconds']:.1f} s")
    return res


# the phases that `--phase` runs alone, after the card and the build
ALONE = {"5d": "phase_rpvnet", "5e": "phase_cylinder", "5g": "phase_tiaf", "5j": "phase_range",
         "5k": "phase_nus_waymo", "5l": "phase_cr16", "5m": "phase_backbones"}


def run_phases(phases: list, t_start: float) -> int:
    """Phases of `ALONE` by themselves (a development run: no kernels
    line, no other phase), each with its own checks, on the scans made
    from SEED; their results as one JSON line."""
    import torch

    scans = make_scans(N_SCANS)
    out = {}
    for ph in phases:
        fn = globals()[ALONE[ph]]
        t0 = time.perf_counter()
        r = fn() if ph in ("5g", "5k") else fn(scans, {}) if ph in ("5d", "5e") else fn(scans)
        out[ph] = {"seconds": time.perf_counter() - t0,
                   **{k: r[k] for k in ("per_scan", "per_step") if isinstance(r, dict) and k in r}}
        log(f"phase {ph}: {out[ph]['seconds']:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"phases": out}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    phases = sys.argv[1:][1::2] if sys.argv[1:2] == ["--phase"] else []
    if sys.argv[1:] and (len(sys.argv[1:]) % 2 or any(a != "--phase" for a in sys.argv[1::2])
                         or any(p not in ALONE for p in phases)):
        print(f"usage: chip_smoke.py [--phase {{{','.join(ALONE)}}}]...", file=sys.stderr)
        return 2
    if not (REPO / "taseg_tpu_torch" / "__init__.py").is_file():
        print("taseg_tpu_torch is not beside chip_smoke.py", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np

    from taseg_tpu_torch.configs import MINKUNET_MK34_CR10
    from taseg_tpu_torch.engine import Segmenter
    from taseg_tpu_torch.ops import _build
    from taseg_tpu_torch.utils.params_from_jax import init_params_numpy

    t_start = time.perf_counter()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 2. the build
    _build.get_lib()
    info = _build.build_info
    log(f"build: {info['seconds']:.1f} s (fresh={info['fresh']}) {info['path']}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  {line.strip()}")

    if phases:
        return run_phases(phases, t_start)

    # main-path objects: seeded weights, bf16 and f32 segmenters
    cfg = MINKUNET_MK34_CR10
    params, stats = init_params_numpy(cfg, seed=SEED)
    variables = {"params": params, "batch_stats": stats}
    seg = Segmenter(cfg, variables, compute_dtype="bfloat16")
    seg32 = Segmenter(cfg, variables, compute_dtype="float32")
    # the entry points switch TF32 off for the process (_device.resolve_device)
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    log(f"after Segmenter: torch.backends.cudnn.allow_tf32={tf32[0]} "
        f"torch.backends.cuda.matmul.allow_tf32={tf32[1]}")
    if any(tf32):
        raise AssertionError("an entry point left TF32 on")
    t0 = time.perf_counter()
    scans = make_scans(N_SCANS)
    log(f"scans: {N_SCANS} x {N_POINTS} points in {time.perf_counter() - t0:.1f} s")

    # one forward with hooks: the real inputs of every conv shape
    arrays = seg.collate(scans[:1])
    topo = seg.topology(arrays)
    seg.check_capacity(topo)
    log(f"level voxels {[int(l.num) for l in topo.levels]} caps {list(seg.caps.voxels)}")
    cap = Capture(seg.model)
    seg.forward(arrays, topo)
    cap.remove()
    torch.cuda.synchronize()

    # 3. kernel phases
    results: dict = {}
    probes: list = []
    phase_join_scan(topo, results, probes)
    phase_convs(cap, results, probes)
    check_child_rounds(topo)
    topology_cost(seg, arrays)
    phase_point_ops(seg, arrays, topo, cfg["MODEL"]["NUM_CLASS"], results, probes)
    del cap

    # 4. the main path, counted
    _build.reset_launches()
    out = seg.predict(scans)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"main path launches: {launches}")
    for k in INFER_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    per_scan = (
        ("sparse_conv_k3", K2_PER_SCAN), ("strided_down", DOWN_PER_SCAN),
        ("strided_up", UP_PER_SCAN),
    )
    for name, (total, mma) in per_scan:
        got = (launches[name], launches[name + ROUTE_ENTRY[name]])
        if got != (total * N_SCANS, mma * N_SCANS):
            raise AssertionError(
                f"{name}: (all, tensor-core) launches {got}, expected "
                f"{(total * N_SCANS, mma * N_SCANS)} over {N_SCANS} scans"
            )
    if launches["voxelize_bwd"]:
        raise AssertionError("voxelize_bwd (K8) launched on the inference path")
    for k in ("devoxelize", "devoxelize_multi"):
        if launches[k] != DEVOX_PER_SCAN * N_SCANS:
            raise AssertionError(
                f"{k}: {launches[k]} launches, expected {DEVOX_PER_SCAN} per scan over {N_SCANS} scans"
            )
    log(
        f"tensor-core route per scan: K2 {K2_PER_SCAN[1]} of {K2_PER_SCAN[0]} (wgmma), "
        f"K3-down {DOWN_PER_SCAN[1]} of {DOWN_PER_SCAN[0]} (wgmma), "
        f"K3-up {UP_PER_SCAN[1]} of {UP_PER_SCAN[0]} (wgmma)"
    )
    for s, o in zip(scans, out):
        n_raw = s["xyzret"].shape[0]
        if o["logits"].shape != (n_raw, cfg["MODEL"]["NUM_CLASS"]):
            raise AssertionError(f"logits shape {o['logits'].shape}")
        if not np.isfinite(o["logits"]).all():
            raise AssertionError("non-finite logits")
    out32 = seg32.predict(scans)
    agree = float(np.mean(np.concatenate(
        [a["labels"] == b["labels"] for a, b in zip(out, out32)]
    )))
    log(f"bf16 vs f32 per-point argmax agreement {agree:.5f}")
    if agree < 0.97:
        raise AssertionError(f"bf16/f32 argmax agreement {agree:.4f} < 0.97")

    # the card's f32 path against the CPU's plain path on a small scan
    small_scan_check(cfg, variables)
    # throughput: host / topology / forward split
    serve_split(seg, scans, ROUNDS)

    # 5. the train path: Trainer of the same model in bf16
    from taseg_tpu_torch.engine import Trainer

    trainer = Trainer(
        cfg, variables, iters_per_epoch=TRAIN_STEPS,
        total_epochs=cfg["OPTIM"]["NUM_EPOCHS"], compute_dtype="bfloat16", seed=SEED,
    )
    log(f"train capacities {list(trainer.caps.voxels)}")
    train_cap = capture_train_calls(trainer, scans[:1])
    phase_train_kernels(train_cap, results)
    del train_cap
    results.setdefault("segment_sum", {})["head_backward"] = phase_head_backward(trainer, scans)
    phase_pair_lists(trainer, scans)
    phase_small_train_step(cfg, variables)
    train_launches, serial = phase_train_steps(trainer, scans)

    # 5b. the harness: the epoch loop through the prefetching loader,
    # checkpoint and resume, evaluation, TTA and submission files
    phase_harness(cfg, variables, {k: launches[k] // N_SCANS for k in launches}, serial)

    # 5c. SPVCNN: serving and train paths at full width, K8 at its calls
    # (its profiler sessions after its timed samples)
    spvcnn = phase_spvcnn(scans, results, (seg, trainer))

    # 5d. RPVNet: serving and train paths at full width with the range
    # branch; K7 at 4 corners, K6 and K8 at its point <-> range tables
    rpvnet = phase_rpvnet(scans, results)

    # 5e. Cylinder_TS: serving and train paths at full width in f32, K2
    # and K4 at K offsets at every call of a real forward and step
    cylinder = phase_cylinder(scans, results)

    # 5f. TASeg's temporal stages: FSA serving and train steps, KD steps,
    # on 262 144-row fused clouds
    fsa = phase_fsa_kd()

    # 5g. TIAF in f32: the image and FOV branches beside the FSA branch,
    # serving and the staged train step
    tiaf = phase_tiaf()

    # 5h. MinkUNet with the default (Bottleneck) block: a serving scan and
    # a train step at full width, counted
    bottleneck = phase_bottleneck(scans)

    # 5i. the DDP step on NCCL at world size 1, bit-equal to the plain step
    ddp = phase_ddp_one_rank(scans)

    # 5j. the range view: SalsaNext serving with K9 (counted), K9 against
    # its plain version, adamW steps at batch 30, FIDNet and RangeNet++
    rng = phase_range(scans)

    # 5k. nuScenes and Waymo: their readers on sensor-sized trees, every
    # new recipe at full width, serving and train steps counted, the
    # submission files, card against CPU at narrow widths
    nus_waymo = phase_nus_waymo()

    # 5l. MinkUNet and SPVCNN at cr 1.6: ragged widths on the tensor cores,
    # the five recipes served (three trained) at full width, every padded
    # call against its plain version and the CUDA-core kernel it replaced
    cr16 = phase_cr16(scans, trainer)

    # 5m. torchsparse's SparseResNet21D and SparseResUNet42 on two scans,
    # the pools and the BEV family on the ResNet's last stage (K10 in the
    # max pool, held at that shape), the new losses and optimizers on the
    # flagship
    bb = phase_backbones(scans)

    # 6. device time per kernel on the main paths
    phase_profile(seg, scans, results, {k: launches[k] / N_SCANS for k in KERNEL_NAMES}, probes)
    phase_train_profile(trainer, scans, results)
    phase_train_probes(trainer, scans)

    # 7. the kernels line: K1-K3 and K7 with the inference path's
    # launches (and their train launches), K4-K6 with the train path's,
    # K8 with SPVCNN's train path's, K7 at 4 corners with RPVNet's serving
    # path's; each with its launches per scan and per step on the SPVCNN
    # and RPVNet paths, K6 and K8 with their times at RPVNet's pixel
    # tables
    meta = {
        "join_scan": ("csrc/join_scan.cu", "taseg_tpu/ops/join_scan.py:134"),
        "sparse_conv_k3": ("csrc/sparse_conv.cu", "taseg_tpu/ops/tgf.py:217"),
        "strided_down": ("csrc/sparse_conv.cu", "taseg_tpu/ops/strided_conv.py:124"),
        "strided_up": ("csrc/sparse_conv.cu", "taseg_tpu/ops/strided_conv.py:153"),
        "k3_conv_dw": ("csrc/conv_dw.cu", "taseg_tpu/ops/f3conv.py:219"),
        "strided_dw": ("csrc/conv_dw.cu", "taseg_tpu/ops/strided_conv.py:136"),
        "segment_sum": ("csrc/segment_sum.cu", "taseg_tpu/ops/voxelize.py:85"),
        "devoxelize": ("csrc/devoxelize.cu", "taseg_tpu/ops/voxelize.py:242,262"),
        "voxelize_bwd": ("csrc/devoxelize.cu", "taseg_tpu/ops/voxelize.py:126"),
        "devoxelize_bilinear": ("csrc/devoxelize.cu", "taseg_tpu/ops/point_range.py:82"),
        # K7's multi-scale entry: the head's three devoxelize calls, f32
        # casts and adds (JAX minkunet.py:36-66 over voxelize.py:242,262)
        "devoxelize_multi": ("csrc/devoxelize.cu", "taseg_tpu/models/voxel/minkunet.py:36"),
    }
    per_step = ("k3_conv_dw", "strided_dw", "segment_sum")
    spv_train = {k: n * TRAIN_STEPS for k, n in spvcnn["per_step"].items()}
    kernels = []
    for name, (src, replaces) in meta.items():
        r = results[name]
        entry = {
            "name": name, "route": "cuda", "source": f"taseg_tpu_torch/{src}",
            "replaces": replaces,
            "launches": (
                rpvnet["launches"] if name == "devoxelize_bilinear"
                else spv_train if name == "voxelize_bwd"
                else train_launches if name in per_step else launches
            )[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        if name == "devoxelize_bilinear":
            entry["per"] = "scan (RPVNet serving, K7 at 4 corners)"
            entry["route_of"] = "devoxelize"
            entry["device_ms_per_scan"] = r["device_ms_per_scan"]
        elif name == "voxelize_bwd":
            entry["per"] = "train step (SPVCNN)"
            # its first kernel at the same calls, and its profiled time
            entry["old_ms"] = r["old_ms"]
            entry["device_ms"] = r["device_ms"]
            entry["library_device_ms"] = r["library_device_ms"]
        elif name in per_step:
            entry["per"] = "train step"
            if name == "k3_conv_dw":
                wg = train_launches[f"{name}_wgmma"]
                entry["launches_by_route"] = {"wgmma": wg, "simt": train_launches[name] - wg}
                # the mma.sync tile the wgmma route replaced, at the same calls
                entry["old_ms"] = r["old_ms"]
            elif name == "strided_dw":
                wg = train_launches["strided_dw_wgmma"]
                entry["launches_by_route"] = {"wgmma": wg, "simt": train_launches[name] - wg}
            if name in ("strided_dw", "segment_sum"):
                entry["device_ms"] = r.get("device_ms")
                entry["library_device_ms"] = r.get("library_device_ms")
        else:
            entry["per"] = "scan"
            route = ROUTE_ENTRY.get(name)
            if route is not None:
                tc = launches[name + route]
                entry["launches_by_route"] = {route[1:]: tc, "simt": launches[name] - tc}
                d = results[f"{name}_dgrad"]
                entry["train"] = {
                    "launches": train_launches[name],
                    "dgrad_launches": train_launches[f"{name}_dgrad"],
                    f"dgrad{route}_launches": train_launches[f"{name}_dgrad{route}"],
                    "dgrad_ms_per_step": d["ms"], "dgrad_plain_ms_per_step": d["plain_ms"],
                    "dgrad_bound_ms_per_step": d["bound_ms"], "dgrad_max_abs_err": d["max_abs_err"],
                    "dgrad_library_ms_per_step": d["library_ms"],
                }
                if "old_ms" in r:
                    # the kernels the wgmma route replaced, at the same calls
                    entry["old_ms"] = r["old_ms"]
                    entry["train"]["dgrad_old_ms_per_step"] = d["old_ms"]
            else:
                entry["train"] = {"launches": train_launches[name]}
            if name == "devoxelize_multi":
                # the sequence it replaced: three single K7 calls, three
                # f32 casts, two adds and the bias
                entry["route_of"] = "devoxelize"
                entry["old_ms"] = r["old_ms"]
            entry["device_ms_per_scan"] = r["device_ms"]
        if name == "join_scan":
            entry["kernel_launches_per_call"] = r["kernel_launches_per_call"]
        entry["device_ms_per_train_step"] = r.get("device_ms_per_step")
        entry["spvcnn"] = {
            "launches_per_scan": spvcnn["per_scan"][name],
            "launches_per_step": spvcnn["per_step"][name],
            "device_ms_per_train_step": spvcnn["device_ms_per_step"].get(name),
        }
        entry["rpvnet"] = {
            "launches_per_scan": rpvnet["per_scan"][name],
            "launches_per_step": rpvnet["per_step"][name],
            "device_ms_per_train_step": rpvnet["device_ms_per_step"].get(name),
        }
        entry["cylinder"] = {
            "launches_per_scan": cylinder["per_scan"][name],
            "launches_per_step": cylinder["per_step"][name],
            "device_ms_per_train_step": cylinder["device_ms_per_step"].get(name),
        }
        entry["fsa"] = fsa_entry(fsa, name)
        entry["tiaf"] = tiaf_entry(tiaf, name)
        entry["nus_waymo"] = nus_waymo_entry(nus_waymo, name)
        entry["cr16"] = cr16_entry(cr16, name)
        if "rpvnet_pixel_tables" in r:
            entry["rpvnet_pixel_tables"] = dict(
                r["rpvnet_pixel_tables"], replaces="taseg_tpu/ops/point_range.py:42,82",
                per="train step (RPVNet)",
            )
        kernels.append(entry)
    # K2 and K4 at K offsets: Cylinder_TS's serving (per scan) and train
    # (per step) paths on the 3xTF32 route (K2 on its wgmma tile); beside
    # them the CUDA-core kernel at the same inputs (`cuda_core_ms`), K2's
    # mma.sync tile that the wgmma tile replaced (`old_ms`), the profiled
    # time, the 3xTF32 bound, and the 3^3 head's calls (K = 27) on their
    # own
    k2k, dgrad, k4k = results["sparse_conv_k"], results["sparse_conv_k_dgrad"], results["sparse_conv_dw"]
    serve, train = cylinder["launches"], cylinder["train_launches"]
    extra = ("old_ms", "old_device_ms", "old_max_abs_err", "cuda_core_ms", "cuda_core_max_abs_err", "device_ms",
             "max_err_share", "bound_ms_3xtf32", "bound_by_3xtf32", "calls", "head")
    kernels.append({
        "name": "sparse_conv_k", "route": "cuda", "source": "taseg_tpu_torch/csrc/sparse_conv.cu",
        "replaces": "taseg_tpu/ops/sparse_conv.py:137", "launches": serve["sparse_conv_k"],
        **{k: k2k[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{k: k2k[k] for k in extra if k in k2k},
        "per": "scan (Cylinder_TS serving, f32)",
        "launches_by_route": {
            "tf32x3": serve["sparse_conv_k_tf32"], "wgmma": serve["sparse_conv_k_wgmma"],
            "simt": serve["sparse_conv_k"] - serve["sparse_conv_k_tf32"] - serve["sparse_conv_k_wgmma"],
        },
        "device_ms_per_scan": cylinder["device_ms_per_scan"]["sparse_conv_k"],
        "fsa": fsa_entry(fsa, "sparse_conv_k"),
        "tiaf": tiaf_entry(tiaf, "sparse_conv_k"),
        "nus_waymo": nus_waymo_entry(nus_waymo, "sparse_conv_k"),
        "train": {
            "launches": train["sparse_conv_k"], "tf32x3_launches": train["sparse_conv_k_tf32"],
            "dgrad_launches": train["sparse_conv_k_dgrad"],
            "dgrad_tf32x3_launches": train["sparse_conv_k_dgrad_tf32"],
            **{f"dgrad_{k}_per_step": dgrad[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms", "old_ms",
                                                         "old_device_ms", "cuda_core_ms", "device_ms",
                                                         "bound_ms_3xtf32")},
            "dgrad_bound_by": dgrad["bound_by"], "dgrad_max_abs_err": dgrad["max_abs_err"],
            "dgrad_head": dgrad.get("head"),
            "device_ms_per_train_step": cylinder["device_ms_per_step"]["sparse_conv_k"],
        },
    })
    kernels.append({
        "name": "sparse_conv_dw", "route": "cuda", "source": "taseg_tpu_torch/csrc/conv_dw.cu",
        "replaces": "taseg_tpu/ops/sparse_conv.py:157", "launches": train["sparse_conv_dw"],
        **{k: k4k[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{k: k4k[k] for k in extra if k in k4k},
        "per": "train step (Cylinder_TS, f32)",
        "launches_by_route": {
            "tf32x3": train["sparse_conv_dw_tf32"],
            "simt": train["sparse_conv_dw"] - train["sparse_conv_dw_tf32"],
        },
        "device_ms_per_train_step": cylinder["device_ms_per_step"]["sparse_conv_dw"],
        "fsa": fsa_entry(fsa, "sparse_conv_dw"),
        "tiaf": tiaf_entry(tiaf, "sparse_conv_dw"),
        "nus_waymo": nus_waymo_entry(nus_waymo, "sparse_conv_dw"),
    })
    # K5 in f32 (TIAF's step) on the 3xTF32 wgmma tile: its launches over
    # the counted TIAF steps, its numbers per step at the calls of one real
    # step, beside the mma.sync tile it replaced (`old_ms`,
    # `old_device_ms`)
    k5f = tiaf["kernels"]["strided_dw"]
    kernels.append({
        "name": "strided_dw_tf32", "route": "cuda", "source": "taseg_tpu_torch/csrc/conv_dw.cu",
        "replaces": "taseg_tpu/ops/strided_conv.py:136", "route_of": "strided_dw",
        "launches": tiaf["per_step"]["strided_dw_tf32"] * TIAF_STEPS,
        **{k: k5f[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{k: k5f[k] for k in ("device_ms", "library_device_ms", "old_ms", "old_device_ms", "calls") if k in k5f},
        "per": "train step (TIAF, f32)",
    })
    log(f"cylinder phase (5e): {cylinder['seconds']:.1f} s")
    log(f"fsa/kd phase (5f): {fsa['seconds']:.1f} s")
    log(f"tiaf phase (5g): {tiaf['seconds']:.1f} s")
    # K9, the range view's KNN clean-up: SalsaNext's serving launches (one
    # a scan), its times at one 120 000-point scan on a 64 x 512 image
    # beside its first design's (`old_ms`), the same points in beam order,
    # and CENet's nuScenes call (32 x 1920, phase 5k)
    k9 = rng["knn"]
    kernels.append({
        "name": "knn", "route": "cuda", "source": "taseg_tpu_torch/csrc/knn_postproc.cu",
        "replaces": "taseg_tpu/models/range2d/postproc.py:19", "launches": rng["launches"],
        **{k: k9[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "per": "scan (SalsaNext serving, 64 x 512)", "device_ms_per_scan": k9["device_ms"],
        **{k: k9[k] for k in ("old_ms", "old_device_ms", "kernels_per_call", "points", "image", "bytes")},
        "beam_order": rng["knn_beam"], "cenet_nuscenes": nus_waymo["knn_cenet"],
        "nus_waymo": nus_waymo_entry(nus_waymo, "knn"),
    })
    # K10, the segment max: Cylinder_TS's serving launches (one a scan),
    # its numbers at one scan's (P, 16) call both ways beside its first
    # design's (`old_ms`), its train launches, and its numbers at the
    # global max pool's shape in f32 and bf16 (phase 5m)
    k10 = results["segment_max"]
    train_launches_cyl = cylinder["train_launches"]
    step_keys = ("step_ms", "step_old_ms", "step_device_ms", "step_old_device_ms", "step_bound_ms")
    kernels.append({
        "name": "segment_max", "route": "cuda", "source": f"taseg_tpu_torch/{K10_SOURCE[0]}",
        "replaces": K10_SOURCE[1], "launches": cylinder["launches"]["segment_max"],
        **{k: k10[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "per": "scan (Cylinder_TS serving, f32)", "shape": k10["shape"],
        **{k: k10[k] for k in ("old_ms", "device_ms", "old_device_ms", "library_device_ms", "kernels_per_call")},
        "train": {"launches": train_launches_cyl["segment_max"],
                  "bwd_launches": train_launches_cyl["segment_max_bwd"],
                  **{k: k10[k] for k in ("bwd_ms", "bwd_plain_ms", "bwd_bound_ms", "bwd_bound_by",
                                         "bwd_library_ms", "bwd_old_ms", "bwd_device_ms", "bwd_old_device_ms",
                                         *step_keys)}},
        "pool": {**bb["k10_pool"], "launches": bb["bev"]["launches"]["segment_max"],
                 "per": "the six BEV / pool modules on SparseResNet21D's last stage (phase 5m)"},
        "pool_bf16": bb["k10_pool_bf16"],
    })
    log(f"bottleneck phase (5h): {bottleneck['seconds']:.1f} s; ddp phase (5i): {ddp['seconds']:.1f} s; "
        f"range phase (5j): {rng['seconds']:.1f} s; nuscenes / waymo phase (5k): {nus_waymo['seconds']:.1f} s; "
        f"cr 1.6 phase (5l): {cr16['seconds']:.1f} s; backbones / BEV / losses phase (5m): "
        f"{bb['seconds']:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
