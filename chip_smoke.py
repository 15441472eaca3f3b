"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py [--train-clouds N]
    python3 chip_smoke.py --ranks N     # phase 21 alone, on N cards
    python3 chip_smoke.py --capture-stress ROOT  # phase 19's child

Phases, none of whose failures is caught:
1. build every CUDA kernel of the port from ``pillars_torch/csrc`` (one
   ``nvcc`` per source, all at once) and print the build seconds;
2. print the card's name and power limit (nvidia-smi);
3. each kernel against its plain PyTorch twin on the card, on random inputs
   at the main paths' shapes and beyond, with warm CUDA-event times of
   kernel and twin at the d435i shapes:
   - NMS keep-mask: B in {1, 4}, K in {100, 1000}, and B = 2 at K in {1,
     33, 1024}, duplicate boxes and invalid rows; bit-equal; its device
     time beside an empty kernel's (the launch floor);
   - fused RPN block: the three d435i block shapes at B in {1, 2} with
     random folded weights, one block per launch and the three chained in
     one launch; max |kernel - twin| <= 1e-5 * max |twin|; also timed
     beside the unfused port blocks (cuDNN convs + BN + ReLU), under CUDA
     events and, as device time summed over kernels, under torch.profiler;
   - eval BatchNorm + ReLU: every BN input of the RPN of
     ``configs/kitti_3class.yaml`` at B=1 and of the d435i config at B=1
     and B=8, NCHW, and the fast path's channels-last deconv outputs;
     max |kernel - twin| <= 1e-6 * max |twin|; kernel and twin (cuDNN's
     BN, then ``torch.relu``) timed in captured graphs, inputs rotating
     over 256 MB or more, against 8 bytes an element at 3.35 TB/s, and the
     kernel's device time under torch.profiler at kitti3's block1;
   - eval PFN (``ops/pfn_cuda.py::pfn_max``): kitti3's point-major front
     end at B=1 (P = 12000, N = 100, 131,072 point rows) and the d435i
     dense cell at B=1 and B=8, on voxelized random clouds with random
     weights; max |kernel - twin| <= 1e-6 * max |twin|, the dense cell's
     counts equal; kernel and twin (the modules' library path) timed in
     captured graphs, the kernel's device time under torch.profiler, beside
     the bytes it must move at 3.35 TB/s;
4. the dense-cell main path: ``PillarsDetector(Config.default())`` with the
   trained checkpoint ``benchmarks/hard_synth/weights_59.pkl`` through
   ``make_inference_fn`` on d435i-sized clouds (19200 points, NumPy seed 0)
   at B=1 and B=2, with the kernels' launch counts set to 0 before that run
   and read after it (19 BN + ReLU kernels and one PFN kernel a batch); the head tensors against the same clouds through the
   port on the CPU, and the card's postprocess fed the CPU's head tensors
   against the CPU's predictions; then the warm ms/cloud at B=1;
5. the point-major fast path: the same config with ``model.pfn.dense_cell``
   false and ``model.rpn.use_pallas_blocks`` true, the same checkpoint and
   clouds, launch counts set to 0 before and read after (the fused blocks
   and NMS once each per batch, the BN + ReLU kernel once per deconv, the
   PFN kernel once per batch); its head tensors against the port on the
   CPU; its valid and labels equal to the dense-cell path's on the card,
   scores within 1e-5 and boxes within 1e-4 + 2e-5 relative; then the warm
   ms/cloud at B=1, and its kernel launches and device time per cloud;
6. the big-grid voxelizer (more cells than ``max_voxels``: the pillar cap in
   arrival order) on the card against the port on the CPU, at the widths of
   the bucket ladder's rungs, B=1 and B=2: integers equal, means 1e-5;
7. bucketed dispatch: ``BucketedInference(Config.default())`` with the
   default ladder on scenes thinned to 3000, 9000 and 19200 points against
   the fixed full-width path (the rung chosen, valid/labels equal, scores
   and boxes within the tolerances), and a ladder forced into one front end
   (``max_voxels`` 2048, rungs 4096/8192/19968): the same bits in every rung;
8. serving: ``run_stream`` at 120 Hz for 3 s from the synthetic source,
   without and with buckets; ``run_multi_stream`` over a bank of 8 fixed
   frames at 30 Hz for 3 s with 1, 4 and 8 streams on the dense-cell config
   and 4 on the fast one. Every detection set served from the bank must be the directly computed B=1
   result of one of its frames; the kernels' launch counts are set to 0
   before each run and must equal the dispatches after it (NMS always, the
   fused chain on the fast config);
9. evaluation: the hard split of benchmarks/hard_synth/README.md (600
   train / 150 val clouds, seed 7) regenerated once through the port's
   ``synth-data`` into a temporary directory and shared with the training
   phases, its checksum, the port's ``Evaluator`` over the 150 val clouds
   on the card, the AP matrix, the stage times, and the aggregate score
   against the golden value of tests/golden/torch_hard_val_ap.json (the JAX
   package on the CPU in f32) within ``AP_TOL``;
10. the train step at full width, B=2, from the trained checkpoint, on one
   batch of the hard train split (``PedestrianDataset(training=True)`` with
   the GT-database sampler, seed 0): targets, loss, every gradient leaf and
   the new BN statistics on the card against the port on the CPU; then the
   captured step (``make_train_step``: one CUDA graph per batch shape) and
   the eager step in turns (eager, captured, captured, eager), each
   threading its state over its steps: ms per step (CUDA events over 20
   warm steps), host wall ms per step, graph and kernel launches, device
   ms and idle share per step (torch.profiler), the captured step's first
   call + capture seconds and the graph pool's MiB; the peak device memory
   of an eager step with ``rpn.remat`` off and on; the eager step's
   launches and device ms by stage (its ``record_function`` ranges:
   voxelize, anchors mask, assign_targets, forward, loss, backward, AdamW)
   beside the whole captured step's;
11. the Trainer: ``Trainer(Config.default())`` from ``PillarsDetector.init``
   on the first ``--train-clouds`` clouds of the hard train split (300, so
   150 steps per epoch at B=2; 600 runs the recipe's epochs), epoch 0 with
   its eval over the 150 val clouds and gating, then a NEW Trainer resumed
   from that run's weights_temp.pkl for epoch 1. Gates: the mean loss of
   epoch 0's last 50 steps below ``LOSS_GATE``, the step count doubled and
   epoch 1 after the resume, the NMS launches of each eval equal to its
   batches, the state on the card, and the epoch-1 aggregate AP above
   ``AP1_FLOOR``; printed beside the JAX run of the recipe at the same step
   (benchmarks/hard_synth/metrics.csv). The Trainer's step is the captured
   one (checked); a third Trainer runs epoch 0 with the eager step for its
   seconds beside the captured epoch's (its loss under the same gate).

12. SECOND sparse (``configs/second_sparse_d435i.yaml``) at full width with
   benchmarks/second_sparse_synth/weights_33.pkl on the val clouds of the
   same split: launch counts around four B=1 batches and one B=2 batch (NMS
   once per batch, the fused RPN blocks never: the SECOND RPN has plain
   convs); the active sets and rulebooks of both stages on the card equal to
   the CPU's, head tensors within ``HEAD_RTOL`` of each tensor's max, the
   card's postprocess fed the CPU's heads within ``POST_ATOL``; warm ms per
   cloud at B=1 (CUDA events), host wall, launches, device ms and idle share
   (torch.profiler) with the rulebooks' and ``gather_conv``'s device time;
   the ``Evaluator`` over the 150 val clouds against the golden AP of
   tests/golden/torch_second_sparse_val_ap.json within ``AP_TOL``; one B=2
   train step from the checkpoint, every gradient leaf and new BN statistic
   within ``GRAD_RTOL`` of its max against the CPU;
13. SECOND dense (``configs/second_d435i.yaml``, the conv3d middle) from a
   seeded ``PillarsDetector.init`` at full width, B=1 and B=2: launch counts,
   heads card vs CPU within ``HEAD_RTOL``, ms per cloud;
14. ``configs/kitti_second.yaml`` at full scale (grid 1408 x 1600 x 40) on
   one synthetic KITTI-range cloud of 120000 points (NumPy seed 0), B=1,
   seeded init: the active sets of all three sparse stages (the last a
   (3, 1, 1) z-squash) card vs CPU, heads within ``HEAD_RTOL``, launch
   counts, ms per cloud and the peak device memory of a call;
15. ``runtime.compute_dtype=bfloat16`` (the criteria of
   tests/torch_parity.py): the bfloat16 variant of the fused RPN chain
   kernel against its twin at the d435i block shapes, B in {1, 2}, one
   block per launch and the three chained in one launch (each element
   within one bf16 step, or near 0 within ``BLOCK_RTOL`` of the max; the
   share of elements that differ and the largest |diff| of the max); it
   and the float32 kernel in turns at B=1 and B=2 (float32, bfloat16,
   then back), µs per call and device µs per launch; the dense-cell and
   fast paths in
   bfloat16 from ``weights_59.pkl`` on phase 4's clouds (launch counts:
   NMS once per batch, the bfloat16 chain once per batch on the fast path;
   heads card vs CPU within 0.7 of the CPU's bf16-f32 rms gap; predictions
   matched as sets; ms and device ms per cloud beside phases 4-5); the
   bfloat16 ``Evaluator`` over phase 9's 150 val clouds against
   tests/golden/torch_hard_val_bf16_ap.json (the JAX package on the CPU in
   bfloat16) within ``AP_TOL``; SECOND sparse in bfloat16 from
   ``weights_33.pkl`` on four of phase 12's val clouds, card vs CPU;
16. ``runtime.compute_dtype=bfloat16`` training: the bf16 train step at
   full width, B=2, from ``weights_59.pkl`` on phase 10's first batch, card
   against CPU, both bf16, by the training criteria of tests/torch_parity.py
   (labels equal; each loss part within 3 x the CPU's own bf16-f32 gap of
   that part or 1e-2 relative; each gradient leaf's rms within 1.5 x the
   larger of its gap and one bf16 step; each new BN statistic's rms within
   1.5 x its gap); ms per step, host wall, launches, device ms and idle
   share of the captured and the eager step, f32 and bf16 in turns (f32,
   bf16, bf16, f32; each captured and eager in turns), and the eager
   step's peak MiB with ``rpn.remat`` off and on; then a bfloat16
   ``Trainer`` from
   ``PillarsDetector.init`` for epoch 0 on phase 11's train clouds with its
   bf16 eval: its NMS launches equal to the eval batches, the mean loss of
   its last 50 steps below ``LOSS_GATE`` and within ``BF16_LOSS_GAP`` of
   the f32 Trainer's epoch 0 in the same call;
17. ``pillars_torch/parallel/`` over process groups on the card
   (``parallel.launch.spawn``; the ranks run ``_p17_rank`` of this script):
   one NCCL rank (world size 1) takes the data-parallel train step through
   the process group and the flat gradient all-reduce, from
   ``weights_59.pkl`` on phase 10's first batch, held to the plain card
   step (loss parts 1e-6 relative, gradients 1e-6 of each leaf's max); then
   two gloo ranks sharing the one card with CUDA tensors (NCCL refuses two
   ranks on one device): a data-parallel step at B=2 (one cloud per rank;
   the CPU tests' criteria: loss parts 1e-6 relative, gradients 1e-5 of
   each leaf's max, new BN statistics 1e-6), a 2-band spatial forward
   (heads 1e-5 of their max) and train step (loss parts 1e-5 relative,
   each gradient leaf's relative L2 1e-3) against the single-rank card
   run, and the distributed ``Evaluator`` on the point-major fast config
   over ``P17_CLOUDS`` hard val clouds at batch ``P17_EVAL_BATCH`` (two
   batches split over the ranks, the remainder on rank 0) against a
   single-rank card ``Evaluator`` (names equal, scores 1e-4 relative +
   1e-5, locations 1e-4), each rank's NMS and fused-chain launches counted
   around its run and equal to the batches it ran; times and launches of
   the two-rank runs are those of two ranks sharing one card, not a
   speed-up. The mesh paths captured (the counterpart of ``jax.jit`` over
   a ``Mesh``): in the NCCL rank, under cuDNN's deterministic algorithms,
   for the ``data``, the one-band ``spatial`` and the 2-D mesh,
   ``make_train_step`` returns a ``CapturedTrainStep`` whose first call
   and two replays equal eager steps from the same state bit for bit
   (metrics, new parameters, BN statistics, Adam moments), then a step
   captured under cuDNN's default algorithms (a graph keeps the algorithms
   of its capture) and eager in turns (ms by CUDA events, host wall,
   graph and kernel
   launches, device ms, idle share, the NCCL kernels and device-to-device
   copies per step, graph pool MiB); one-band spatial inference on the
   point-major path through ``make_inference_fn`` at B=1 and B=2, a
   ``CapturedInference`` held to its eager function as phase 18 holds it
   (max |diff| 0), and in turns at B=1. In the gloo ranks the step stays
   eager (``make_train_step`` returns the eager step: its body holds gloo
   collectives), and the distributed ``Evaluator`` replays per-rank graphs
   (its inference holds no collective), its detections and launches held
   as above, its seconds for the first run (captures included) and for a
   second, replayed, beside the same ``Evaluator`` run eagerly;
18. the captured inference (pillars_torch/cuda_graph.py) against the eager
   function it captures, on the card: the dense-cell and fast paths at B=1
   and B=2 in float32 and bfloat16, both rungs of the default bucket ladder
   and one ``second_sparse_d435i`` cloud from ``weights_33.pkl``; valid
   and labels equal, scores, boxes and the head tensors (a graph of the
   network alone) within ``CAPTURE_RTOL`` of each tensor's max; launch
   counts of replays equal to the calls; call n's predictions unchanged
   after call n+1; the state swapped (a new dict, the same tensors scaled
   in place, inference tensors, the first state again), each call equal to
   eager on the same state; then eager and captured in turns at B=1 on the
   dense and fast paths: ms per cloud (CUDA events), host wall, graph and
   kernel launches, device ms and idle share, the capture seconds per
   shape, the graph pool's MiB and the path's analytic bound
   (utils/roofline.py);
19. the captured train and recalibration steps (train/loop.py
   ``CapturedTrainStep``, train/bn_recal.py ``CapturedRecal``) and the
   repairs of this slice, on phase 10's split (run before 18, while the
   split exists): an extra feature of 1e7, and a NaN and both infinities,
   through both voxelizers on the card against the CPU (integers equal,
   NaN and infinities where the CPU has them, means within ``MEAN_ATOL``
   of their scale), and both voxelizers captured at 19200 points, B=1 and
   2, in device ms against the earlier fixed-unit sums in turns; the captured
   step against the eager step from the same
   state for three B=2 steps at full width from ``weights_59.pkl`` (its
   first call, then replays), f32, bf16, ``rpn.remat`` and train metrics:
   loss parts, rate, positives and metrics equal, new BN statistics equal,
   moments within ``GRAD_RTOL`` of each leaf's max, parameters within two
   rates, and the gradients through a graph of the body's ``gradients``
   within ``GRAD_RTOL``; the same f32 steps under deterministic algorithms
   (warn only) and cuDNN's deterministic mode, with the ops PyTorch names
   nondeterministic: where two eager steps agree bit for bit, replays must
   equal eager bit for bit; two ``second_sparse_d435i`` steps from
   ``weights_33.pkl``; after replayed steps the detector's captured heads
   against eager heads on a fresh clone of the state (within
   ``CAPTURE_RTOL``); the AdaBN recalibration of ``Config.default()`` with
   ``eval_input.bn_recal_batches`` 8 through the ``Evaluator``, captured
   against eager, and both timed; ``profile_stages`` of the dense and fast
   configs (each stage a graph of its own, device ms) against the three
   stages in one graph: their sum within 0.8 and 1.1 times the whole plus
   three graph launches; the capture stress, in a child process
   (``--capture-stress``): a fresh f32 and a fresh bf16 captured step
   captured ``STRESS_ROUNDS`` times each, the step before dropped into a
   reference cycle, with Python's collector at thresholds (1, 1, 1), then
   ``STRESS_FORCED_ROUNDS`` times each with a collection forced inside the
   capture: no capture may be invalidated;
20. ``configs/kitti_3class.yaml`` (Car / Pedestrian / Cyclist, the 432 x 496
   grid, 1.29M anchors, NMS 1000 -> 300) from its trained checkpoint
   benchmarks/kitti3_synth/weights_73.pkl, run after phase 14: the split of
   benchmarks/kitti3_synth/README.md (300 train / 80 val clouds, seed 11)
   regenerated into a temporary directory, its checksum against the golden
   value's; the AdaBN recalibration of the ``Evaluator`` (32 train
   batches); serving from the recalibrated state through
   ``make_inference_fn`` at B=1 and B=2 (NMS launches equal to the batches,
   the fused chain's 0), the voxelization's integers and the anchors mask
   equal card vs CPU, head tensors within ``HEAD_RTOL`` of each tensor's
   max, the card's postprocess fed the CPU's heads within ``POST_ATOL``
   with valid and labels equal (the stable-sort top-k on trained ties);
   warm ms per cloud, launches, device ms and idle share, the sort's and
   the NMS kernel's device ms, the capture seconds and the graph pool; the
   NMS kernel on that cloud's K = 1000 boxes against its twin, timed, with
   its bound; the ``Evaluator`` (the config's bucket ladder) over the 80 val
   clouds against tests/golden/torch_kitti3_val_ap.json within ``AP_TOL``,
   NMS launches equal to the batches and the rungs' warm-ups, the recal
   step captured against eager in turns; the train step resumed from the
   checkpoint's TrainState (AdamW count 11100) at B=1 on the first train
   cloud against the CPU (targets, loss parts, new BN statistics, each
   gradient leaf's relative L2 within ``K3_SPREAD_FACTOR`` times what one
   float32 step on every parameter moves it by, a gate that the step with
   TF32 on must fail), at B=2 captured and eager in turns,
   its peak memory with ``rpn.remat`` off and on and the loader's ms per
   batch; a ``Trainer`` resumed from the checkpoint for a short epoch of
   ``K3_TRAIN_CLOUDS`` clouds and its eval: the step count from 11100 on,
   the rate equal to the schedule's, the mean loss below ``K3_LOSS_GATE``,
   the eval's NMS launches equal to its batches, the aggregate AP above
   ``K3_AP_FLOOR``;
22. the port's headline benchmark as a user runs it: ``python -m
   pillars_torch.cli bench`` in a child process for ``BENCH_RUNS`` (the
   dense cell and the fast path in float32, the fast path in bfloat16),
   ``BENCH_ITERS`` timed calls each: every child exits 0 and prints one
   JSON line with the JAX benchmark's keys, a finite rate and the card's
   name, its calls replay a captured graph, and the kernels' launches per
   timed call are one NMS everywhere, one fused chain on the fast path
   (bfloat16's counted as such) and, in float32, 19 BN + ReLU kernels on
   the dense cell and 3 (the deconvs) on the fast path; the lines and the
   launch counts printed.

23. ``configs/transfer_learning.yaml`` (stage 2 of the two-stage recipe:
   ``freeze_patterns`` pfn and block1-block3, lr 0.005, no GT sampling)
   from ``weights_59.pkl`` on the hard split, B=2, full width: (a) the
   captured step for 3 steps (the first call, then replays), each against
   the eager step from the same state by phase 19's criteria, the 67
   frozen leaves bit-equal to the checkpoint's after them; the 15
   trainable leaves' gradients, differentiated alone as the step does,
   against ``forward_backward``'s every-leaf gradients (bit-equal under
   cuDNN's deterministic mode, ``GRAD_RTOL`` under its defaults); one
   step card against CPU by phase 10's tolerances; (b) the captured
   transfer step and ``Config.default()``'s captured step on the same
   weights and batch in turns (transfer, full, transfer, full): ms per
   step, host wall, launches, device ms, idle share, capture s, graph
   pool, each first call's and each eager step's peak memory, and the
   eager transfer step's launches and device ms by stage; (c) a
   ``Trainer`` epoch from ``train.load_weights`` on phase 11's 300 train
   clouds with its eval on the 150 hard val clouds, beside the golden AP
   of the checkpoint: losses finite, AP above ``AP1_FLOOR``, the frozen
   leaves bit-equal to the loaded weights after the epoch, the eval's NMS
   launches equal to its batches (the kernel line's ``transfer_eval``).

21. only with ``--ranks N`` (and then alone): the captured mesh paths over
   N NCCL ranks, one per card, from ``weights_59.pkl`` on the regenerated
   hard split, two clouds per data rank: the checks of phase 17's NCCL
   rank over a data mesh of N, a spatial mesh of N bands and 2 x N/2
   (replays bit-equal to eager, one graph launch per captured step with
   NCCL kernels inside it, the band's inference captured equal to eager,
   and the parameters after the steps equal on every rank), then a
   ``Trainer`` from ``weights_59.pkl`` over the N ranks for one epoch of
   ``P21_TRAIN_CLOUDS`` clouds per rank, its step captured and
   its distributed ``Evaluator`` replaying per-rank graphs between the
   eager collectives: losses finite, variables equal on every rank, each
   rank's NMS launches equal to the batches it ran, and the detections
   equal to a single-rank card ``Evaluator``'s on the same variables.

Every inference phase runs what ``make_inference_fn`` returns on the card,
a captured CUDA graph per input shape: the launch counts read around a
phase add each replay's launches (cuda_graph.py); the first call at a shape
runs eagerly and counts its own.

Prints the kernel table as one JSON line (the NMS kernel, the fused RPN
chain kernel in float32 and in bfloat16), then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero without a card, or when
the port is not beside this script.
"""

import gc
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
CARD = "cuda"  # the device type every phase holds the port to
WEIGHTS = ROOT / "benchmarks" / "hard_synth" / "weights_59.pkl"
# published H100 SXM peaks: HBM bytes/s and f32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# head tensors, card vs CPU: the same f32 convs summed in another order
# (cuDNN vs oneDNN, TF32 off); logits are O(10)
HEAD_ATOL = 1e-3
# postprocess, card vs CPU on the same head tensors: exp/sin/cos/sigmoid
# differ by an ulp or so between the two libraries
POST_ATOL = 1e-5
# fused RPN block, kernel vs twin on the card: the same f32 products summed
# in another order (FMAs against cuBLAS), relative to the output's max
BLOCK_RTOL = 1e-5
# eval BN + ReLU kernel vs twin on the card: one fma against cuDNN's own
# order, relative to the output's max
BN_RELU_RTOL = 1e-6
BN_RELU_EPS = 1e-3
L2_MB = 50  # the H100's L2 cache
# the two front ends on the card, on the same clouds and weights: the
# port's CPU tolerances against the JAX package
SCORE_ATOL = 1e-5
BOX_ATOL = 1e-4
BOX_RTOL = 2e-5
FAST_OVERRIDES = (("model.pfn.dense_cell", False),
                  ("model.rpn.use_pallas_blocks", True))
# per-pillar point means, card vs CPU: exact fixed-point sums divided and
# recentred in f32 by two libraries
MEAN_ATOL = 1e-5
# aggregate AP score (0-100) on the card against the golden value: AP moves
# in steps when one borderline box flips; half a point of the aggregate
AP_TOL = 0.5
GOLDEN = ROOT / "tests" / "golden" / "torch_hard_val_ap.json"
# train step, card vs CPU on one batch: labels equal; the rest the same f32
# math in another order (cuDNN against oneDNN, TF32 off)
TARGET_ATOL = 1e-5
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3       # of each gradient leaf's max |value|
STAT_RTOL = 1e-4       # of each new BN statistic's max |value|
# the Trainer. The JAX run of the recipe (600 train clouds, B=2) read a mean
# loss of 2.10 over the steps logged in 100-149 and 1.74 at step 290, and
# aggregate AP 1.48 / 19.12 after 300 / 600 steps (benchmarks/hard_synth).
# The port, on an H100 (700 W), read AP 24.10 after 300 steps of the
# 300-cloud default, and 6.65-20.51 after 300 and 23.95-29.14 after 600
# steps in four runs of the 600-cloud split; a run is not repeatable (the
# augmentation order across the loader's threads, the card's atomics), so
# the floor sits well below, under the JAX run's 1.48 at 300 steps
LOSS_GATE = 4.0
AP1_FLOOR = 1.0
JAX_AP_AFTER_STEPS = {300: 1.48, 600: 19.12}
# SECOND: the three configs of the second model family, the trained sparse
# checkpoint and its golden AP (pillars_tpu on the CPU, f32)
CONFIGS = ROOT / "configs"
SECOND_WEIGHTS = ROOT / "benchmarks" / "second_sparse_synth" / "weights_33.pkl"
SECOND_GOLDEN = ROOT / "tests" / "golden" / "torch_second_sparse_val_ap.json"
# SECOND head tensors card vs CPU, of each tensor's max |value|: the same f32
# gathers, matmuls and convs summed in another order (TF32 off)
HEAD_RTOL = 1e-3


def _sorted_box_sets(rng, b, k):
    """[b, k, 4] score-sorted standup boxes with duplicates and invalid
    rows, + [b, k] valid."""
    centers = rng.uniform(0, 6, (b, k, 2)).astype(np.float32)
    sizes = rng.uniform(0.3, 1.0, (b, k, 2)).astype(np.float32)
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1)
    valid = rng.uniform(size=(b, k)) > 0.2
    for i in range(b):
        boxes[i, rng.choice(k, k // 10)] = boxes[i, rng.choice(k, k // 10)]
    return boxes, valid


def check_nms_kernel(iou_threshold):
    from pillars_torch.ops import nms_cuda
    from pillars_torch.ops.nms import keep_mask_plain
    from pillars_torch.utils.profiling import cuda_ms, device_busy

    rng = np.random.RandomState(0)
    max_err = 0.0
    for b, ks in ((1, (100, 1000)), (4, (100, 1000)), (2, (1, 33, 1024))):
        for k in ks:
            boxes, valid = _sorted_box_sets(rng, b, k)
            bt = torch.from_numpy(boxes).cuda()
            vt = torch.from_numpy(valid).cuda()
            got = nms_cuda.nms_keep_mask(bt, vt, iou_threshold)
            want = keep_mask_plain(bt, vt, iou_threshold)
            torch.cuda.synchronize()
            err = (got.int() - want.int()).abs().max().item()
            max_err = max(max_err, float(err))
            if not torch.equal(got, want):
                raise AssertionError(f"NMS kernel != plain twin at B={b} K={k}")
            print(f"nms_keep_mask B={b} K={k}: bit-equal, "
                  f"{int(got.sum())} kept of {int(vt.sum())} valid")

    # d435i shape: one sample of nms_pre_max_size = 100 boxes
    boxes, valid = _sorted_box_sets(rng, 1, 100)
    t = _nms_kernel_timing(torch.from_numpy(boxes).cuda(),
                           torch.from_numpy(valid).cuda(), iou_threshold)
    floor_ms = device_busy(nms_cuda.launch_floor, 200, "empty_kernel")[1]
    floor_call_ms = cuda_ms(nms_cuda.launch_floor, 500)
    print(f"nms_keep_mask B=1 K=100: kernel {t['ms'] * 1e3:.2f} us per call, "
          f"{t['device_ms'] * 1e3:.2f} us device time (torch.profiler); an "
          f"empty kernel of one block {floor_call_ms * 1e3:.2f} us per call, "
          f"{floor_ms * 1e3:.2f} us device time; plain twin "
          f"{t['plain_ms'] * 1e3:.2f} us; bound {t['bound_ms'] * 1e3:.4f} us "
          f"({t['bound_by']}: {t['flops']} f32 operations, {t['bytes']} "
          f"bytes)")
    return {"name": "nms_keep_mask", "route": "cuda",
            "source": "pillars_torch/csrc/nms_keep_mask.cu",
            "replaces": "pillars_tpu/ops/nms_pallas.py:24",
            "launches": None, "max_abs_err": max_err, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "device_ms": t["device_ms"], "launch_floor_device_ms": floor_ms}


def _nms_kernel_timing(boxes, valid, thr):
    """The NMS kernel on [B, K, 4] score-sorted boxes: bit-equal to its
    twin, its time per call (CUDA events), its device time (torch.profiler),
    the twin's time and the bound of the work these boxes need."""
    from pillars_torch.ops import nms_cuda
    from pillars_torch.ops.nms import keep_mask_plain
    from pillars_torch.utils.profiling import cuda_ms, device_busy

    call = lambda: nms_cuda.nms_keep_mask(boxes, valid, thr)  # noqa: E731
    got, want = call(), keep_mask_plain(boxes, valid, thr)
    if not torch.equal(got, want):
        raise AssertionError(f"NMS kernel != plain twin on "
                             f"{list(boxes.shape)} boxes")
    ms = cuda_ms(call, 500)
    device_ms = device_busy(call, 200, "nms_keep_mask_kernel")[1]
    plain_ms = cuda_ms(lambda: keep_mask_plain(boxes, valid, thr), 3)
    # greedy NMS holds each valid box against the kept boxes before it: per
    # such pair 2 max, 2 min, 4 add/sub, 2 clamps, mul, add, sub, div,
    # compare; per valid box its area (5). Each input read once, the keep
    # mask written once
    kept = got.int()
    pairs = int(((torch.cumsum(kept, 1) - kept) * valid).sum())
    n_valid = int(valid.sum())
    flops = 15 * pairs + 5 * n_valid
    n_bytes = boxes.numel() * 4 + 2 * valid.numel()
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    return {"shape": list(boxes.shape), "valid": n_valid,
            "kept": int(kept.sum()), "pairs": pairs, "ms": ms,
            "device_ms": device_ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "flops": flops, "bytes": n_bytes}


def _block_shapes(mcfg):
    """(H, W, C_in, C_out, num_layers, stride) of the three RPN blocks."""
    _, h, w = mcfg.feature_map_size
    cin = mcfg.pfn.num_filters
    rcfg = mcfg.rpn
    shapes = []
    for i in range(3):
        s, cout = rcfg.layer_strides[i], rcfg.num_filters[i]
        shapes.append((h, w, cin, cout, rcfg.layer_nums[i], s))
        h, w, cin = h // s, w // s, cout
    return shapes


def _block_work(b, h, w, cin, cout, n, stride, act_bytes=4):
    """(f32 operations, bytes) one fused block needs: per output pixel and
    layer the depthwise (9 multiply-adds per input channel), the pointwise
    (C_in multiply-adds per output channel), bias and ReLU; the input read
    once, the output and every weight written or read once. ``act_bytes``:
    the bytes of an input or output element (2 in bfloat16); the weights
    are float32."""
    px = b * (h // stride) * (w // stride)
    flops, n_bytes = 0, act_bytes * (b * h * w * cin + px * cout)
    for i in range(n + 1):
        ci = cin if i == 0 else cout
        flops += px * (2 * 9 * ci + 2 * ci * cout + 2 * cout)
        n_bytes += 4 * (9 * ci + ci * cout + cout)
    return flops, n_bytes


def check_rpn_kernel(mcfg):
    from pillars_torch.models.rpn import _Block
    from pillars_torch.ops import rpn_cuda
    from pillars_torch.ops.rpn_blocks import (FoldedLayer,
                                              fused_sep_block_plain,
                                              pack_block)
    from pillars_torch.utils.profiling import cuda_ms, device_busy

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(1)
    shapes = _block_shapes(mcfg)
    layers = []
    for h, w, cin, cout, n, s in shapes:
        blk = []
        for i in range(n + 1):
            ci = cin if i == 0 else cout
            blk.append(FoldedLayer(*(torch.from_numpy(a.astype(np.float32))
                                     .cuda() for a in (
                rng.randn(3, 3, ci), rng.randn(ci, cout) / np.sqrt(9 * ci),
                rng.randn(cout) * 0.1))))
        layers.append(blk)
    packed = [pack_block(layers[i], sh[4], sh[5])
              for i, sh in enumerate(shapes)]

    def check(label, got, want):
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if not (got.shape == want.shape and scale > 0
                and err <= BLOCK_RTOL * scale):
            raise AssertionError(f"{label}: kernel vs twin {err} > "
                                 f"{BLOCK_RTOL} * {scale}")
        print(f"rpn_sep_block {label}: max |diff| {err:.3e} (max |twin| "
              f"{scale:.3e})")
        return err

    max_err = 0.0
    for b in (1, 2):
        # the three blocks in one launch, as the fast path runs them
        x = torch.from_numpy(np.maximum(
            rng.randn(b, *shapes[0][:3]), 0).astype(np.float32)).cuda()
        got = rpn_cuda.fused_sep_chain(x, packed)
        torch.cuda.synchronize()
        for i, (h, w, cin, cout, n, s) in enumerate(shapes):
            x = fused_sep_block_plain(x, layers[i], n, s)
            max_err = max(max_err, check(
                f"chain block{i + 1} B={b} {h}x{w}x{cin}->{cout}", got[i], x))
        for i, (h, w, cin, cout, n, s) in enumerate(shapes):
            x = torch.from_numpy(np.maximum(rng.randn(b, h, w, cin), 0)
                                 .astype(np.float32)).cuda()
            got = rpn_cuda.fused_sep_block(x, layers[i], n, s)
            want = fused_sep_block_plain(x, layers[i], n, s)
            torch.cuda.synchronize()
            max_err = max(max_err, check(
                f"block{i + 1} B={b} {h}x{w}x{cin}->{cout} n={n} s={s}",
                got, want))

    # warm times at B=1, per block and the three chained as on the path
    xs = []
    for h, w, cin, *_ in shapes:
        xs.append(torch.from_numpy(np.maximum(rng.randn(1, h, w, cin), 0)
                                   .astype(np.float32)).cuda())
    unfused = [_Block(cin, cout, n, s, mcfg.rpn.bn_eps, True).cuda().eval()
               for _, _, cin, cout, n, s in shapes]

    def kernel(i, x):  # one block per launch, weights packed beforehand
        return rpn_cuda.fused_sep_chain(x, packed[i:i + 1])[0]

    def twin(i, x):
        return fused_sep_block_plain(x, layers[i], shapes[i][4], shapes[i][5])

    def cudnn(i, x):  # NCHW
        return unfused[i](x)

    def chain(f, x):
        for i in range(3):
            x = f(i, x)
        return x

    nchw = [x.permute(0, 3, 1, 2).contiguous() for x in xs]
    with torch.inference_mode():
        times = {name: [cuda_ms(lambda i=i: f(i, xin[i]), iters)
                        for i in range(3)]
                 for name, f, xin, iters in (("kernel", kernel, xs, 200),
                                             ("twin", twin, xs, 20),
                                             ("cudnn", cudnn, nchw, 200))}
        ms = cuda_ms(lambda: rpn_cuda.fused_sep_chain(xs[0], packed), 200)
        plain_ms = cuda_ms(lambda: chain(twin, xs[0]), 20)
        cudnn_ms = cuda_ms(lambda: chain(cudnn, nchw[0]), 200)
        # device time: kernel time summed per call under torch.profiler,
        # the same way for the fused kernel and for the unfused blocks
        dev = {name: [device_busy(lambda i=i: f(i, xin[i]), 50, must)[1]
                      for i in range(3)]
               for name, f, xin, must in (
                   ("kernel", kernel, xs, "rpn_sep_chain_kernel"),
                   ("cudnn", cudnn, nchw, ""))}
        _, dev_ms, rows, _ = device_busy(
            lambda: rpn_cuda.fused_sep_chain(xs[0], packed), 50,
            "rpn_sep_chain_kernel")
        _, cudnn_dev_ms, cudnn_rows, _ = device_busy(
            lambda: chain(cudnn, nchw[0]), 50)
    work = [_block_work(1, *sh) for sh in shapes]
    flops = sum(f for f, _ in work)
    n_bytes = sum(nb for _, nb in work)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    for i in range(3):
        print(f"rpn_sep_block block{i + 1} B=1: kernel "
              f"{times['kernel'][i] * 1e3:.2f} us, plain twin "
              f"{times['twin'][i] * 1e3:.2f} us, unfused cuDNN block "
              f"{times['cudnn'][i] * 1e3:.2f} us; bound "
              f"{max(work[i][0] / F32_FLOPS, work[i][1] / HBM_BYTES_PER_S) * 1e6:.2f}"
              f" us ({work[i][0] / 1e6:.1f} M f32 ops, "
              f"{work[i][1] / 1e6:.2f} MB)")
    print(f"rpn_sep_block three blocks B=1 (one launch): kernel "
          f"{ms * 1e3:.2f} us, plain twin {plain_ms * 1e3:.2f} us, unfused "
          f"cuDNN blocks {cudnn_ms * 1e3:.2f} us; bound "
          f"{max(bytes_ms, ops_ms) * 1e3:.2f} us ({flops / 1e6:.1f} M f32 "
          f"ops, {n_bytes / 1e6:.2f} MB)")
    print("rpn blocks device time B=1 (torch.profiler, kernels summed per "
          "call): fused kernel per block "
          + " / ".join(f"{t * 1e3:.2f}" for t in dev["kernel"])
          + f" us, three blocks in one launch {dev_ms * 1e3:.2f} us "
          f"({sum(c for _, c, _ in rows):g} launch); unfused cuDNN blocks "
          + " / ".join(f"{t * 1e3:.2f}" for t in dev["cudnn"])
          + f" us, three blocks {cudnn_dev_ms * 1e3:.2f} us "
          f"({sum(c for _, c, _ in cudnn_rows):g} launches)")
    return {"name": "rpn_sep_block", "route": "cuda",
            "source": "pillars_torch/csrc/rpn_sep_block.cu",
            "replaces": "pillars_tpu/ops/rpn_pallas.py:77",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "device_ms": dev_ms,
            "unfused_cudnn_ms": cudnn_ms,
            "unfused_cudnn_device_ms": cudnn_dev_ms}


def _bn_relu_shapes(mcfg, b):
    """{label: [B, C, H, W]} of the BN inputs of the RPN: each block's
    output and each deconv's."""
    shapes = {}
    for i, (h, w, _, cout, _, s) in enumerate(_block_shapes(mcfg)):
        u = mcfg.rpn.upsample_strides[i]
        shapes[f"block{i + 1}"] = (b, cout, h // s, w // s)
        shapes[f"deconv{i + 1}"] = (b, mcfg.rpn.num_upsample_filters[i],
                                    h // s * u, w // s * u)
    return shapes


def _bn_relu_per_call(det):
    """BN + ReLU kernel launches of one inference call of ``det``: every
    BatchNorm of the RPN in float32 (the fast path runs only the deconvs'
    through it, its blocks' are folded into the fused kernel); none in
    bfloat16."""
    from pillars_torch.models.layers import BatchNorm

    if det.dtype is not None:
        return 0
    rpn = det.rpn_tail if det.fast else det.network.rpn
    return sum(isinstance(m, BatchNorm) for m in rpn.modules())


def _bn_vectors(c, seed):
    """Random running mean and variance, weight and bias [c] on the card."""
    g = torch.Generator(device=CARD).manual_seed(seed)
    return (torch.randn(c, device=CARD, generator=g),
            torch.rand(c, device=CARD, generator=g) * 2 + 0.05,
            torch.randn(c, device=CARD, generator=g),
            torch.randn(c, device=CARD, generator=g) * 0.5)


def _bn_relu_case(ops, x, vec):
    """The kernel against its twin on ``x``, and both timed: per call from
    captured graphs over inputs rotating through 256 MB or more (at most
    8), each call writing an output of its own, so that large shapes read
    and write device memory, not L2; ``timed_mb`` what those calls move."""
    from pillars_torch.utils.profiling import captured_ms

    got = ops.bn_relu(x, *vec, BN_RELU_EPS)
    want = ops.bn_relu_plain(x, *vec, BN_RELU_EPS)
    torch.cuda.synchronize()
    layout = (torch.channels_last if not x.is_contiguous()
              else torch.contiguous_format)
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    if not (got.shape == want.shape and got.is_contiguous(memory_format=layout)
            and scale > 0 and err <= BN_RELU_RTOL * scale):
        raise AssertionError(f"bn_relu {list(x.shape)}: kernel vs twin "
                             f"{err} > {BN_RELU_RTOL} * {scale}")
    count = min(8, max(2, -(-256 * 2**20 // (4 * x.numel()))))
    xs = [x] + [torch.randn_like(x) for _ in range(count - 1)]

    def calls(f):
        def body():
            outs = [f(t, *vec, BN_RELU_EPS) for t in xs]  # noqa: F841
            return []  # no output: the graph holds the calls alone
        return body

    us, plain_us = (captured_ms(calls(f), 20) * 1e3 / count
                    for f in (ops.bn_relu, ops.bn_relu_plain))
    bound_us = 8 * x.numel() / HBM_BYTES_PER_S * 1e6
    return {"abs_err": err, "rel_err": err / scale, "us": us,
            "plain_us": plain_us, "bound_us": bound_us,
            "gb_s": 8 * x.numel() / us / 1e3, "peak_pct": 100 * bound_us / us,
            "timed_mb": 8 * x.numel() * count / 1e6}


def check_bn_relu_kernel(mcfg):
    """Kernel 3 at every BN input shape of the RPN of kitti3 (B=1) and
    d435i (``mcfg``, B=1 and B=8; the fast path's channels-last deconv
    outputs too): against its twin, timed beside it and its bound."""
    from pillars_torch.config import Config
    from pillars_torch.ops import bn_relu_cuda
    from pillars_torch.utils.profiling import device_busy

    k3 = Config.from_yaml(str(K3_CONFIG)).model
    cases = [(f"kitti3 {k} B=1", sh, "nchw")
             for k, sh in _bn_relu_shapes(k3, 1).items()]
    for b in (1, 8):
        cases += [(f"d435i {k} B={b}", sh, "nchw")
                  for k, sh in _bn_relu_shapes(mcfg, b).items()]
    cases.append(("d435i fast deconv B=1",
                  _bn_relu_shapes(mcfg, 1)["deconv1"], "channels_last"))
    rows = {}
    for i, (label, shape, layout) in enumerate(cases):
        x = torch.randn(shape, device=CARD)
        if layout == "channels_last":
            x = x.contiguous(memory_format=torch.channels_last)
        vec = _bn_vectors(shape[1], seed=i)
        r = rows[label] = {"shape": list(shape), "layout": layout,
                           **_bn_relu_case(bn_relu_cuda, x, vec)}
        in_l2 = ", which L2 holds" if r["timed_mb"] < L2_MB else ""
        print(f"bn_relu {label} {list(shape)} {layout}: max |diff| "
              f"{r['rel_err']:.2e} of max |twin|; kernel {r['us']:.2f} us "
              f"({r['gb_s']:.0f} GB/s, {r['peak_pct']:.1f}% of 3.35 TB/s), "
              f"library BN + relu {r['plain_us']:.2f} us; bound "
              f"{r['bound_us']:.2f} us (captured graphs over "
              f"{r['timed_mb']:.0f} MB{in_l2})")
        if label == "kitti3 block1 B=1":
            head = (x, vec)
        del x
    torch.cuda.empty_cache()
    x, vec = head
    device_ms = device_busy(
        lambda: bn_relu_cuda.bn_relu(x, *vec, BN_RELU_EPS), 50,
        "bn_relu_kernel")[1]
    print(f"bn_relu kitti3 block1 B=1: {device_ms * 1e3:.2f} us device time "
          f"(torch.profiler)")
    row = rows["kitti3 block1 B=1"]
    return {"name": "bn_relu", "route": "cuda",
            "source": "pillars_torch/csrc/bn_relu.cu", "replaces": None,
            "shape": row["shape"], "launches": None,
            "max_abs_err": max(r["abs_err"] for r in rows.values()),
            "ms": row["us"] / 1e3, "plain_ms": row["plain_us"] / 1e3,
            "bound_ms": row["bound_us"] / 1e3, "bound_by": "bytes",
            "library_ms": row["plain_us"] / 1e3, "device_ms": device_ms,
            "by_shape": rows}


# the PFN kernel's cases: (label, kitti3 config, dense cell, B, points a
# cloud, points in one pillar); about as many points and pillars as the
# cells' clouds hold (kitti3 7k-9k pillars, d435i about 14.6k points)
PFN_MAX_CASES = (("kitti3 B=1", True, False, 1, 9000, 150),
                 ("d435i dense B=1", False, True, 1, 14600, 120),
                 ("d435i dense B=8", False, True, 8, 14600, 120))
PFN_MAX_RTOL = 1e-6  # kernel vs twin: the Linear summed in another order


def _pfn_max_bytes(args, kwargs):
    """The bytes the kernel must move for these inputs: every point's kept
    flag; each kept point's features, mean xyz, cell and row (and count on
    the dense cell); each written row's mask and count (point-major); the
    [rows, F] output once (and the dense cell's [rows] counts)."""
    points, _, cell, row, kept = args[:5]
    rows, n_filters = args[-1], args[5].shape[0]
    dense = "count" in kwargs
    n_kept = int(kept.sum())
    per_point = 4 * points.shape[1] + 12 + 4 * (1 if dense else 3) + 4 \
        + (4 if dense else 0)
    reads = kept.numel() + n_kept * per_point
    if not dense:
        reads += 5 * int(torch.unique(row[kept]).numel())
    return reads + 4 * rows * n_filters + (4 * rows if dense else 8)


def check_pfn_max_kernel():
    """Kernel 4, the eval PFN, at the three cells' shapes (kitti3 point-major
    at B=1, the d435i dense cell at B=1 and B=8): against its twin (the
    modules' former library path), both timed in captured graphs, beside
    the bytes it must move at 3.35 TB/s."""
    from pillars_torch.config import Config
    from pillars_torch.ops import pfn_cuda
    from pillars_torch.utils.profiling import captured_ms, device_busy

    parity = _parity()
    rows = {}
    for label, kitti3, dense, b, n, clump in PFN_MAX_CASES:
        if kitti3:
            cfg = (Config.from_yaml(str(K3_CONFIG))
                   .override("model.voxel.max_voxels", 12000)
                   .override("model.voxel.max_points_per_voxel", 100))
        else:
            cfg = Config.default()
        mcfg = cfg.model
        pts, num = parity.pfn_clouds(mcfg.voxel, mcfg.num_point_features, b,
                                     n, seed=7, clump=clump)
        _, args, kwargs = parity.pfn_case(
            mcfg, torch.from_numpy(pts).cuda(), torch.from_numpy(num).cuda(),
            dense, seed=7)
        with torch.no_grad():
            got = pfn_cuda.pfn_max(*args, **kwargs)
            want = pfn_cuda.pfn_max_plain(*args, **kwargs)
        torch.cuda.synchronize()
        g, w = (got[0], want[0]) if dense else (got, want)
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        counts_equal = not dense or torch.equal(got[1], want[1])
        if not (g.shape == w.shape and scale > 0 and counts_equal
                and err <= PFN_MAX_RTOL * scale):
            raise AssertionError(f"pfn_max {label}: kernel vs twin {err} > "
                                 f"{PFN_MAX_RTOL} * {scale} or counts "
                                 f"unequal ({counts_equal})")
        with torch.no_grad():
            us, plain_us = (captured_ms(lambda f=f: f(*args, **kwargs), 50)
                            * 1e3 for f in (pfn_cuda.pfn_max,
                                            pfn_cuda.pfn_max_plain))
            dev_us = device_busy(lambda: pfn_cuda.pfn_max(*args, **kwargs),
                                 50, "pfn_max_kernel")[1] * 1e3
        nbytes = _pfn_max_bytes(args, kwargs)
        bound_us = nbytes / HBM_BYTES_PER_S * 1e6
        r = rows[label] = {
            "rows": args[-1], "points": int(args[4].numel()),
            "kept": int(args[4].sum()), "features": args[5].shape[0],
            "abs_err": err, "rel_err": err / scale, "us": us,
            "device_us": dev_us, "plain_us": plain_us, "bound_us": bound_us,
            "mb": nbytes / 1e6, "peak_pct": 100 * bound_us / us}
        print(f"pfn_max {label}: M {r['points']}, kept {r['kept']}, rows "
              f"{r['rows']}, F {r['features']}: max |diff| "
              f"{r['rel_err']:.2e} of max |twin|; kernel {us:.2f} us a "
              f"captured call ({dev_us:.2f} us device, torch.profiler), "
              f"twin {plain_us:.2f} us; bound {bound_us:.2f} us "
              f"({r['mb']:.2f} MB at 3.35 TB/s, {r['peak_pct']:.1f}%)")
    head = rows["kitti3 B=1"]
    return {"name": "pfn_max", "route": "cuda",
            "source": "pillars_torch/csrc/pfn_max.cu", "replaces": None,
            "shape": [head["points"], head["rows"], head["features"]],
            "launches": None,
            "max_abs_err": max(r["abs_err"] for r in rows.values()),
            "ms": head["us"] / 1e3, "plain_ms": head["plain_us"] / 1e3,
            "bound_ms": head["bound_us"] / 1e3, "bound_by": "bytes",
            "library_ms": None, "device_ms": head["device_us"] / 1e3,
            "by_shape": rows}


def _clouds(max_points, batch, n_clouds, n=19200):
    """d435i-like clouds (640x480 depth subsampled 1::4), as bench.py."""
    n = min(n, max_points)
    rng = np.random.RandomState(0)
    pts = np.zeros((n_clouds, batch, max_points, 3), np.float32)
    for c in range(n_clouds):
        for b in range(batch):
            pts[c, b, :n, 0] = rng.uniform(0.0, 6.4, n)
            pts[c, b, :n, 1] = rng.uniform(-2.56, 2.56, n)
            pts[c, b, :n, 2] = rng.uniform(-3.0, 3.0, n)
    return pts, np.full((batch,), n, np.int32)


# --------------------------------------------------------------------------
# phase 23: configs/transfer_learning.yaml, the captured fine-tune step
TL_CONFIG = CONFIGS / "transfer_learning.yaml"
TL_TRAINABLE = 15  # of the 82 parameter tensors: the deconvs and the heads


def _tl_config(root):
    """``transfer_learning.yaml`` on the hard split under ``root``, from
    ``weights_59.pkl`` (the stage-1 checkpoint)."""
    from pillars_torch.config import Config

    return (_with_split(Config.from_yaml(str(TL_CONFIG)), root)
            .override("train.load_weights", str(WEIGHTS)))


def _frozen_against_every_leaf(det, state, batch, thr):
    """The trainable leaves' gradients of ``batch`` at ``state``, taken
    with only those leaves differentiated (the transfer step's) and with
    every leaf (``forward_backward``'s): (max of each leaf's |diff| over
    its max, the leaves not bit-equal, whether the loss parts are)."""
    from pillars_torch.train.loop import gradients

    names = list(state.opt_state.mu)
    part = gradients(det, state.params, state.batch_stats, batch, thr, names)
    full = gradients(det, state.params, state.batch_stats, batch, thr)
    if list(part.grads) != names or len(full.grads) != len(state.params):
        raise AssertionError(f"transfer gradients: {len(part.grads)} and "
                             f"{len(full.grads)} leaves")
    err = max(_max_rel(part.grads[k], full.grads[k].cpu()) for k in names)
    differ = [k for k in names if not torch.equal(part.grads[k],
                                                  full.grads[k])]
    loss_equal = all(torch.equal(a, b) for a, b in zip(part.loss, full.loss))
    return err, differ, loss_equal


def _first_call_mib(step, state, on_card):
    """The captured step's first call (the body on a side stream, then its
    capture): (the state it returns, the peak device memory it allocated
    above what was allocated before, MiB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, _ = step(state, on_card)
    torch.cuda.synchronize()
    return state, (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def _tl_parity(cfg, state_cpu, batches, smi):
    """23a: the captured transfer step against the eager one, the frozen
    leaves after it, the trainable gradients against every leaf's, one
    step card against CPU."""
    from pillars_torch.models.detector import PillarsDetector

    thr = cfg.train_input.anchor_area_threshold
    step, _, state = _train_steps(cfg, state_cpu)
    trainable = list(state.opt_state.mu)
    frozen = [k for k in state.params if k not in state.opt_state.mu]
    if len(trainable) != TL_TRAINABLE:
        raise AssertionError(f"transfer: {len(trainable)} trainable leaves")
    lr = float(step.opt.schedule(0))
    worst, bitwise, state = _replays_against_eager(
        "captured transfer step", step, state, batches, lr)
    moved = [k for k in frozen
             if not torch.equal(state.params[k].cpu(), state_cpu[k])]
    if moved:
        raise AssertionError(f"transfer: frozen leaves moved {moved}")
    if any(torch.equal(state.params[k].cpu(), state_cpu[k])
           for k in trainable):
        raise AssertionError("transfer: a trainable leaf did not move")
    n_frozen = sum(state_cpu[k].numel() for k in frozen)
    n_all = sum(state_cpu[k].numel() for k in state.params)
    print(f"captured transfer step B=2 full width, 3 steps (the first call, "
          f"then replays) each against the eager step from the same state: "
          f"loss parts, rate and positives equal; new BN statistics max rel "
          f"{worst['stats']:.3e}, moments {worst['mu']:.3e} / "
          f"{worst['nu']:.3e} of each leaf's max (tol {GRAD_RTOL}), "
          f"parameters {worst['params_over_lr']:.3e} rates (tol 2); "
          f"bit-equal: {bitwise}; {len(frozen)} frozen leaves "
          f"({n_frozen} of {n_all} elements) bit-equal to weights_59.pkl's, "
          f"{len(trainable)} trainable moved [{smi}]")

    det = step.detector
    fresh, _ = _train_state(det, state_cpu)
    det_err, det_differ, det_loss = _deterministic(
        lambda: _frozen_against_every_leaf(det, fresh, batches[0], thr))
    err, differ, loss_equal = _frozen_against_every_leaf(det, fresh,
                                                         batches[0], thr)
    print(f"transfer gradients, {len(trainable)} trainable leaves "
          f"differentiated alone against forward_backward's every leaf: "
          f"cuDNN deterministic: loss parts bit-equal {det_loss}, "
          f"{len(det_differ)} leaves not bit-equal {det_differ}, max "
          f"{det_err:.3e} of each leaf's max; cuDNN's defaults: loss parts "
          f"bit-equal {loss_equal}, {len(differ)} not bit-equal, max "
          f"{err:.3e} (tol {GRAD_RTOL}) [{smi}]")
    if det_differ or not det_loss:
        raise AssertionError(f"transfer gradients under cuDNN's "
                             f"deterministic mode: {det_differ}")
    if not err <= GRAD_RTOL:
        raise AssertionError(f"transfer gradients: {err} of max")

    det_cpu = PillarsDetector(cfg, device="cpu")
    state_h, _ = _train_state(det_cpu, state_cpu)
    host = {k: v.cpu() for k, v in batches[0].items()}
    line = _step_close(det, det_cpu, fresh, state_h, host, thr,
                       names=trainable)
    print(f"transfer step B=2 full width, card vs CPU: {line}")
    return {**worst, "bitwise": bitwise, "frozen_leaves": len(frozen),
            "frozen_elements": n_frozen, "elements": n_all,
            "grad_max_rel_deterministic": det_err,
            "grad_max_rel": err, "grad_leaves_differing": differ}


def _tl_turns(cfg, full_cfg, state_cpu, on_card, smi):
    """23b: the captured transfer step and ``Config.default()``'s captured
    step from the same weights on the same batch, in turns (transfer,
    full, transfer, full); each first call's peak memory and each eager
    step's peak above the state."""
    steps, first, eager_mib = {}, {}, {}
    for name, c in (("transfer", cfg), ("full", full_cfg)):
        step, eager, state = _train_steps(c, state_cpu)
        eager_mib[name] = _eager_peak_mib(eager, _clone_state(state),
                                          on_card)
        state, first[name] = _first_call_mib(step, state, on_card)
        steps[name] = (step, state)
    turns = []
    for name in ("transfer", "full", "transfer", "full"):
        step, state = steps[name]
        t = _time_train_step(step, _clone_state(state), on_card, True)
        t.update(step=name, first_call_peak_mib=first[name],
                 eager_peak_mib=eager_mib[name])
        turns.append(t)
        print(f"{name} step B=2 full width in turns: {_step_line(t)}; "
              f"first call peak {first[name]:.1f} MiB above what was "
              f"allocated, eager step peak {eager_mib[name]:.1f} MiB above "
              f"the state [{smi}]")
    return turns


def run_transfer(state_cpu, smi, root):
    """Phase 23: configs/transfer_learning.yaml from ``weights_59.pkl``
    on the hard split; returns its numbers and the eval's NMS launches."""
    from pillars_torch.config import Config
    from pillars_torch.train.loop import batch_to_device
    from pillars_torch.train.optim import trainable_names

    t23 = time.perf_counter()
    cfg = _tl_config(root)
    t0 = time.perf_counter()
    host = _train_batches(cfg, 10)
    loader_ms = (time.perf_counter() - t0) * 1e3 / 10
    batches = [batch_to_device(b, CARD) for b in host[:3]]
    result = {"loader_ms_per_batch": loader_ms,
              "parity": _tl_parity(cfg, state_cpu, batches, smi)}
    full = _with_split(Config.default(), root)
    result["turns"] = _tl_turns(cfg, full, state_cpu, batches[0], smi)
    result["stages"] = _train_stages(cfg, state_cpu, batches[0],
                                     result["turns"], smi,
                                     label="transfer step")

    golden = json.loads(GOLDEN.read_text())["aggregate"]
    out = os.path.join(root, "runs_transfer")
    r = _trainer_epoch(_train_cfg(root, out, 300, cfg=cfg), 0, params=True)
    trainable = trainable_names(r["params"],
                                cfg.train.optimizer.freeze_patterns)
    frozen = [k for k in r["params"] if k not in trainable]
    moved = [k for k in frozen if not torch.equal(r["params"][k],
                                                  state_cpu[k])]
    print(f"Trainer transfer_learning.yaml from weights_59.pkl, "
          f"{_epoch_line(r, 0, 300)} (weights_59.pkl itself: golden "
          f"{golden:.3f}); losses finite {r['finite']}; {len(frozen)} "
          f"frozen leaves bit-equal to the loaded weights: {not moved}; the "
          f"loader makes one batch in {loader_ms:.1f} ms on one thread "
          f"[{smi}]")
    if not r["finite"]:
        raise AssertionError("transfer Trainer: a loss is not finite")
    if not r["ap"] > AP1_FLOOR:
        raise AssertionError(f"transfer Trainer: aggregate AP {r['ap']} not "
                             f"above {AP1_FLOOR}")
    if moved or len(frozen) != len(r["params"]) - TL_TRAINABLE:
        raise AssertionError(f"transfer Trainer: frozen leaves moved "
                             f"{moved}")
    result["trainer"] = {k: v for k, v in r.items()
                         if k not in ("dirs", "params")}
    result["seconds"] = time.perf_counter() - t23
    print(f"phase 23 (transfer learning): {result['seconds']:.1f} s [{smi}]")
    print("transfer: " + json.dumps(result))
    return result


def _reset_counts():
    from pillars_torch.ops import bn_relu_cuda, nms_cuda, pfn_cuda, rpn_cuda

    nms_cuda.nms_keep_mask.launches = 0
    rpn_cuda.fused_sep_block.launches = 0
    rpn_cuda.fused_sep_block.launches_bf16 = 0
    bn_relu_cuda.bn_relu.launches = 0
    pfn_cuda.pfn_max.launches = 0


def _read_counts():
    """Launches since :func:`_reset_counts`; ``rpn_sep_block`` counts both
    dtypes of the block kernel, ``rpn_sep_block_bf16`` the bfloat16 ones."""
    from pillars_torch.ops import bn_relu_cuda, nms_cuda, pfn_cuda, rpn_cuda

    return {"nms_keep_mask": nms_cuda.nms_keep_mask.launches,
            "rpn_sep_block": rpn_cuda.fused_sep_block.launches,
            "rpn_sep_block_bf16": rpn_cuda.fused_sep_block.launches_bf16,
            "bn_relu": bn_relu_cuda.bn_relu.launches,
            "pfn_max": pfn_cuda.pfn_max.launches}


def _check_outputs(cfg, on_card, outs):
    K = cfg.model.postprocess.nms_post_max_size
    for (p, _), out in zip(on_card, outs):
        b = p.shape[0]
        if (out.boxes_lidar.shape != (b, K, 7) or out.valid.shape != (b, K)
                or not out.valid.any()):
            raise AssertionError(f"unexpected predictions at B={b}")
        for t in (out.boxes_lidar, out.boxes_camera, out.scores):
            if not torch.isfinite(t[out.valid]).all():
                raise AssertionError("non-finite predictions")


def _warm_ms(fn, state, p, n, eye, label, group=None):
    from pillars_torch.utils.profiling import cuda_ms, device_busy

    ms = cuda_ms(lambda: fn(state, p, n, eye, eye), 50)
    t0 = time.perf_counter()
    for _ in range(50):
        fn(state, p, n, eye, eye)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 50
    print(f"{label} B=1: {ms:.3f} ms/cloud (CUDA events, warm), "
          f"{wall_ms:.3f} ms/cloud host wall")
    prof_wall, device, rows, graphs = device_busy(
        lambda: fn(state, p, n, eye, eye), 20, "nms_keep_mask_kernel", group)
    launches = sum(c for _, c, _ in rows)
    print(f"{label} B=1: {graphs:g} graph launches, {launches:g} kernel "
          f"launches and {device:.4f} ms of device time per cloud, idle "
          f"share {1 - device / prof_wall:.3f} (torch.profiler)")
    return {"ms": ms, "host_wall_ms": wall_ms, "launches": launches,
            "graph_launches": graphs, "device_ms": device,
            "idle_share": 1 - device / prof_wall}


def run_main_path(state_cpu):
    """The dense-cell path; returns (launches, clouds, clouds on the card,
    predictions)."""
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector

    cfg = Config.default()
    thr = cfg.eval_input.anchor_area_threshold
    det = PillarsDetector(cfg)
    det_cpu = PillarsDetector(cfg, device="cpu")
    state = det.state_to_device(state_cpu)
    fn = det.make_inference_fn()
    maxpts = cfg.model.voxel.max_points

    bank1, num1 = _clouds(maxpts, 1, 4)
    bank2, num2 = _clouds(maxpts, 2, 1)
    batches = [(bank1[c], num1) for c in range(len(bank1))]
    batches.append((bank2[0], num2))
    eye = {b: torch.eye(4).expand(b, 4, 4).contiguous().cuda() for b in (1, 2)}
    on_card = [(torch.from_numpy(p).cuda(), torch.from_numpy(n).cuda())
               for p, n in batches]

    # the main path, with every kernel's launch count read around it
    _reset_counts()
    outs = [fn(state, p, n, eye[p.shape[0]], eye[p.shape[0]])
            for p, n in on_card]
    torch.cuda.synchronize()
    launches = _read_counts()
    print(f"dense-cell path: {len(on_card)} batches, launches {launches}")
    if launches["nms_keep_mask"] < len(on_card):
        raise AssertionError("the main path did not run the NMS kernel")
    if launches["bn_relu"] != _bn_relu_per_call(det) * len(on_card):
        raise AssertionError(f"the main path ran the BN + ReLU kernel "
                             f"{launches['bn_relu']} times, not "
                             f"{_bn_relu_per_call(det)} per batch")
    if launches["pfn_max"] != len(on_card):
        raise AssertionError(f"the PFN kernel ran {launches['pfn_max']} "
                             f"times, not once per batch")
    _check_outputs(cfg, on_card, outs)

    # the card against the CPU on the same clouds and weights
    head_err, post_err = 0.0, 0.0
    with torch.inference_mode():
        for (pts, num), (p, n) in zip(batches, on_card):
            b = pts.shape[0]
            eye_cpu = torch.eye(4).expand(b, 4, 4)
            preds_cpu, amask_cpu = det_cpu._forward_dense(
                state_cpu, torch.from_numpy(pts), torch.from_numpy(num), thr)
            preds, amask = det._forward_dense(state, p, n, thr)
            if not torch.equal(amask.cpu(), amask_cpu):
                raise AssertionError("anchors mask differs between card and CPU")
            for key in preds_cpu:
                err = (preds[key].cpu() - preds_cpu[key]).abs().max().item()
                head_err = max(head_err, err)
                if err > HEAD_ATOL:
                    raise AssertionError(f"{key}: card vs CPU {err} > {HEAD_ATOL}")
            want = det_cpu.postprocess(preds_cpu, amask_cpu, eye_cpu, eye_cpu)
            got = det.postprocess({k: v.cuda() for k, v in preds_cpu.items()},
                                  amask_cpu.cuda(), eye[b], eye[b])
            got = type(got)(*(t.cpu() for t in got))
            if not (torch.equal(got.valid, want.valid)
                    and torch.equal(got.labels[want.valid],
                                    want.labels[want.valid])):
                raise AssertionError("postprocess valid/labels differ")
            v = want.valid
            for name in ("boxes_lidar", "boxes_camera", "scores"):
                err = (getattr(got, name)[v] - getattr(want, name)[v]
                       ).abs().max().item()
                post_err = max(post_err, err)
                if err > POST_ATOL:
                    raise AssertionError(f"postprocess {name}: {err} > {POST_ATOL}")
    print(f"card vs CPU: head tensors max |diff| {head_err:.3e} "
          f"(tol {HEAD_ATOL}), postprocess on the same heads max |diff| "
          f"{post_err:.3e} (tol {POST_ATOL}); valid/labels/anchors mask equal")
    times = _warm_ms(fn, state, *on_card[0], eye[1], "dense-cell path")
    return launches, batches, on_card, outs, times


def run_fast_path(state_cpu, batches, on_card, dense_outs):
    """The point-major path with the fused RPN blocks; returns launches."""
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector

    cfg = Config.default()
    for key, value in FAST_OVERRIDES:
        cfg = cfg.override(key, value)
    thr = cfg.eval_input.anchor_area_threshold
    det = PillarsDetector(cfg)
    det_cpu = PillarsDetector(cfg, device="cpu")
    if not (det.fast and det_cpu.fast):
        raise AssertionError("the point-major config did not select the "
                             "fused blocks")
    state = det.state_to_device(state_cpu)
    fn = det.make_inference_fn()
    eye = {b: torch.eye(4).expand(b, 4, 4).contiguous().cuda() for b in (1, 2)}

    _reset_counts()
    outs = [fn(state, p, n, eye[p.shape[0]], eye[p.shape[0]])
            for p, n in on_card]
    torch.cuda.synchronize()
    launches = _read_counts()
    print(f"point-major fast path: {len(on_card)} batches, launches "
          f"{launches}")
    if launches["rpn_sep_block"] != len(on_card):
        raise AssertionError("the fast path did not run the fused block "
                             "kernel once per batch")
    if launches["nms_keep_mask"] != len(on_card):
        raise AssertionError("the fast path did not run the NMS kernel once "
                             "per batch")
    if launches["bn_relu"] != _bn_relu_per_call(det) * len(on_card):
        raise AssertionError(f"the fast path ran the BN + ReLU kernel "
                             f"{launches['bn_relu']} times, not "
                             f"{_bn_relu_per_call(det)} per batch")
    if launches["pfn_max"] != len(on_card):
        raise AssertionError(f"the PFN kernel ran {launches['pfn_max']} "
                             f"times, not once per batch")
    _check_outputs(cfg, on_card, outs)

    head_err = 0.0
    with torch.inference_mode():
        for (pts, num), (p, n) in zip(batches, on_card):
            v_cpu = det_cpu.voxelize_batch(torch.from_numpy(pts),
                                           torch.from_numpy(num))
            v = det.voxelize_batch(p, n)
            if not torch.equal(
                    det.anchors_mask_batch(v.coords, v.pillar_mask, thr).cpu(),
                    det_cpu.anchors_mask_batch(v_cpu.coords,
                                               v_cpu.pillar_mask, thr)):
                raise AssertionError("anchors mask differs between card and CPU")
            preds_cpu = det_cpu._forward_fast(state_cpu, v_cpu)
            preds = det._forward_fast(state, v)
            for key in preds_cpu:
                err = (preds[key].cpu() - preds_cpu[key]).abs().max().item()
                head_err = max(head_err, err)
                if err > HEAD_ATOL:
                    raise AssertionError(f"fast {key}: card vs CPU {err} > "
                                         f"{HEAD_ATOL}")
    print(f"fast path card vs CPU: head tensors max |diff| {head_err:.3e} "
          f"(tol {HEAD_ATOL}); anchors mask equal")

    score_err, box_err = 0.0, 0.0
    for got, want in zip(outs, dense_outs):
        v = want.valid
        if not (torch.equal(got.valid, v)
                and torch.equal(got.labels[v], want.labels[v])):
            raise AssertionError("fast path valid/labels differ from the "
                                 "dense-cell path's")
        err = (got.scores[v] - want.scores[v]).abs().max().item()
        score_err = max(score_err, err)
        if err > SCORE_ATOL:
            raise AssertionError(f"fast path scores: {err} > {SCORE_ATOL}")
        for name in ("boxes_lidar", "boxes_camera"):
            g, w = getattr(got, name)[v], getattr(want, name)[v]
            err = (g - w).abs().max().item()
            box_err = max(box_err, err)
            if not torch.all((g - w).abs() <= BOX_ATOL + BOX_RTOL * w.abs()):
                raise AssertionError(f"fast path {name}: max |diff| {err}")
    print(f"fast path vs dense-cell path on the card: valid/labels equal, "
          f"scores max |diff| {score_err:.3e} (tol {SCORE_ATOL}), boxes max "
          f"|diff| {box_err:.3e} (tol {BOX_ATOL} + {BOX_RTOL} relative)")
    times = _warm_ms(fn, state, *on_card[0], eye[1], "point-major fast path")
    return launches, times


def _fast_config():
    from pillars_torch.config import Config

    cfg = Config.default()
    for key, value in FAST_OVERRIDES:
        cfg = cfg.override(key, value)
    return cfg


def _scenes(count, n_points, seed):
    from pillars_torch.data.stream import synthetic_bank

    return synthetic_bank(count, seed, max_points=n_points)


def _padded(frames, width):
    pts = np.zeros((len(frames), width, 3), np.float32)
    for i, f in enumerate(frames):
        pts[i, :len(f)] = f
    return pts, np.asarray([len(f) for f in frames], np.int32)


def _same_predictions(got, want, label):
    """valid/labels equal, scores and boxes within the CPU tolerances;
    returns (score error, box error)."""
    v = want.valid
    if not (torch.equal(got.valid, v)
            and torch.equal(got.labels[v], want.labels[v])):
        raise AssertionError(f"{label}: valid/labels differ")
    if not v.any():
        raise AssertionError(f"{label}: no valid detection to compare")
    score_err = (got.scores[v] - want.scores[v]).abs().max().item()
    if score_err > SCORE_ATOL:
        raise AssertionError(f"{label}: scores {score_err} > {SCORE_ATOL}")
    box_err = 0.0
    for name in ("boxes_lidar", "boxes_camera"):
        g, w = getattr(got, name)[v], getattr(want, name)[v]
        box_err = max(box_err, (g - w).abs().max().item())
        if not torch.all((g - w).abs() <= BOX_ATOL + BOX_RTOL * w.abs()):
            raise AssertionError(f"{label}: {name} max |diff| {box_err}")
    return score_err, box_err


def check_big_grid_voxelizer(smi):
    from pillars_torch.config import Config
    from pillars_torch.ops.voxelize import make_point_voxelizer

    worst = 0.0
    for max_voxels, width, n in ((9984, 9984, 9000), (2048, 19968, 19200)):
        vcfg = (Config.default().override("model.voxel.max_voxels", max_voxels)
                .override("model.voxel.max_points", width).model.voxel)
        fn = make_point_voxelizer(vcfg)
        for b in (1, 2):
            pts, num = _padded(_scenes(b, n, seed=10 * b), width)
            num[-1] = n // b  # different counts inside a batch
            want = fn(torch.from_numpy(pts), torch.from_numpy(num))
            got = fn(torch.from_numpy(pts).cuda(), torch.from_numpy(num).cuda())
            for name, g, w in zip(want._fields, got, want):
                g = g.cpu()
                if name in ("point_mean", "voxel_mean"):
                    err = (g - w).abs().max().item()
                    worst = max(worst, err)
                    if err > MEAN_ATOL:
                        raise AssertionError(
                            f"big-grid voxelizer {name}: {err} > {MEAN_ATOL}")
                elif not torch.equal(g, w):
                    raise AssertionError(f"big-grid voxelizer: {name} differs "
                                         f"at max_voxels={max_voxels} B={b}")
            print(f"big-grid voxelizer max_voxels={max_voxels} width={width} "
                  f"B={b}: {int(want.pillar_mask.sum())} pillars, "
                  f"{int(want.point_kept.sum())} of {int(num.sum())} points "
                  f"kept; card == CPU in every integer output")
    print(f"big-grid voxelizer: means card vs CPU max |diff| {worst:.3e} "
          f"(tol {MEAN_ATOL}) [{smi}]")


def check_bucketed(state_cpu, smi):
    from pillars_torch.config import Config
    from pillars_torch.infer import BucketedInference
    from pillars_torch.models.detector import PillarsDetector

    cfg = Config.default()
    width = cfg.model.voxel.max_points
    eye = torch.eye(4)[None].cuda()
    bi = BucketedInference(cfg)
    state = bi.state_to_device(state_cpu)
    bi.warmup(state)
    fixed = PillarsDetector(cfg).make_inference_fn()
    expect = {3000: 9984, 9000: 9984, 19200: 19968}
    for n, rung in expect.items():
        pts, num = _padded(_scenes(1, n, seed=n), width)
        if bi.select_bucket(int(num[0])) != rung:
            raise AssertionError(f"{n} points went to rung "
                                 f"{bi.select_bucket(int(num[0]))}, not {rung}")
        got = bi(state, pts, num, eye, eye)
        want = fixed(state, pts, num, eye, eye)
        s_err, b_err = _same_predictions(got, want, f"bucketed n={n}")
        front = "dense cell" if bi._dets[rung].dense_cell else "point-major"
        print(f"bucketed n={n}: rung {rung} ({front}), "
              f"{int(want.valid.sum())} detections, valid/labels equal to the "
              f"fixed width, scores max |diff| {s_err:.3e}, boxes {b_err:.3e}")
    if bi._dets[9984].dense_cell or not bi._dets[19968].dense_cell:
        raise AssertionError("the default ladder's rungs did not split into "
                             "the two front ends")

    one = cfg.override("model.voxel.max_voxels", 2048)
    ladder = BucketedInference(one, buckets=(4096, 8192, 19968))
    for n in (3000, 4000):
        pts, num = _padded(_scenes(1, n, seed=n + 1), width)
        outs = [ladder._fn(b)(state, pts[:, :b], num, eye, eye)
                for b in ladder.buckets]
        torch.cuda.synchronize()
        if not outs[0].valid.any():
            raise AssertionError("no detection in the one-front-end ladder")
        for b, out in zip(ladder.buckets[1:], outs[1:]):
            for name, x, y in zip(out._fields, out, outs[0]):
                if not torch.equal(x, y):
                    raise AssertionError(f"rung {b} != rung "
                                         f"{ladder.buckets[0]} in {name}")
    print(f"bucketed, one front end (max_voxels 2048, rungs "
          f"{ladder.buckets}): every output equal bit for bit across the "
          f"rungs [{smi}]")


class _CountedDetector:
    """Counts the calls of the inference functions a detector hands out."""

    def __init__(self, det):
        self.calls = 0
        make = det.make_inference_fn

        def counting(threshold=None):
            fn = make(threshold)

            def counted(*args):
                self.calls += 1
                return fn(*args)

            return counted

        det.make_inference_fn = counting


def _direct(cfg, det, state, frames):
    """The B=1 detections of every bank frame, filtered as the loops do."""
    from pillars_torch.models.detector import HostFetch

    fn = det.make_inference_fn(cfg.eval_input.anchor_area_threshold)
    eye = torch.eye(4)[None].cuda()
    out = []
    for frame in frames:
        pts, num = _padded([frame], cfg.model.voxel.max_points)
        p = HostFetch(fn(state, pts, num, eye, eye)).result()
        keep = p.valid[0] & (p.scores[0] >= cfg.runtime.prediction_min_score)
        out.append((p.boxes_lidar[0][keep], p.scores[0][keep]))
    if not any(len(s) for _, s in out):
        raise AssertionError("no bank frame has a detection")
    return out


def _is_one_of(boxes, scores, wanted):
    return any(len(s) == len(scores)
               and np.allclose(scores, s, atol=SCORE_ATOL, rtol=0)
               and np.allclose(boxes, b, atol=BOX_ATOL, rtol=BOX_RTOL)
               for b, s in wanted)


def run_serving(state_cpu, smi):
    """The stream loops on the card; returns {run: launches}."""
    from pillars_torch.config import Config
    from pillars_torch.data.stream import (bank_source, run_multi_stream,
                                           run_stream)
    from pillars_torch.models.detector import PillarsDetector

    launches = {}
    cfg = Config.default()
    det = PillarsDetector(cfg)
    state = det.state_to_device(state_cpu)
    for buckets in (None, (9984, 19968)):
        served = []
        _reset_counts()
        stats = run_stream(cfg, det, state, hz=120.0, duration_s=3.0,
                           buckets=buckets,
                           on_detections=lambda b, s: served.append((b, s)))
        name = "stream" + ("_buckets" if buckets else "")
        launches[name] = _read_counts()
        dispatches = stats["frames_processed"] + len(buckets or (0,))
        if stats["frames_processed"] < 1 or len(served) != stats[
                "frames_processed"]:
            raise AssertionError(f"{name}: {stats}")
        if launches[name]["nms_keep_mask"] != dispatches:
            raise AssertionError(f"{name}: NMS launches {launches[name]} for "
                                 f"{dispatches} dispatches (warm-up included)")
        if not all(b.shape == (len(s), 7) and np.isfinite(b).all()
                   for b, s in served):
            raise AssertionError(f"{name}: malformed detections")
        print(f"run_stream 120 Hz 3 s synthetic, dense cell, buckets "
              f"{buckets}: {json.dumps(stats)}; "
              f"{sum(len(s) for _, s in served)} boxes served; NMS launches "
              f"{launches[name]['nms_keep_mask']} = dispatches [{smi}]")

    frames = _scenes(8, cfg.model.voxel.max_points, seed=3)
    for label, run_cfg, streams in (("dense", cfg, (1, 4, 8)),
                                    ("fast", _fast_config(), (4,))):
        det = PillarsDetector(run_cfg)
        state = det.state_to_device(state_cpu)
        wanted = _direct(run_cfg, det, state, frames)
        counter = _CountedDetector(det)
        for n_streams in streams:
            served = []
            counter.calls = 0
            _reset_counts()
            stats = run_multi_stream(
                run_cfg, det, state, num_streams=n_streams, hz=30.0,
                duration_s=3.0,
                on_detections=lambda i, b, s: served.append((b, s)),
                source_fn=lambda mb, i: bank_source(
                    mb, 30.0, 3.0, frames[i:] + frames[:i]))
            name = f"multi_{label}_n{n_streams}"
            launches[name] = _read_counts()
            if stats["frames_processed"] < 1 or len(served) != stats[
                    "frames_processed"]:
                raise AssertionError(f"{name}: {stats}")
            strangers = sum(not _is_one_of(b, s, wanted) for b, s in served)
            if strangers:
                raise AssertionError(
                    f"{name}: {strangers} of {len(served)} served detection "
                    f"sets match no bank frame")
            want_chain = counter.calls if label == "fast" else 0
            if (launches[name]["nms_keep_mask"] != counter.calls
                    or launches[name]["rpn_sep_block"] != want_chain):
                raise AssertionError(
                    f"{name}: launches {launches[name]} for "
                    f"{counter.calls} dispatches")
            print(f"run_multi_stream 30 Hz 3 s bank of 8, {label}, "
                  f"N={n_streams}: {json.dumps(stats)}; every served set is "
                  f"a bank frame's; dispatches {counter.calls} (warm-up "
                  f"included), launches {launches[name]} [{smi}]")
    return launches


def make_hard_split(root):
    """The hard split (600 train / 150 val, seed 7) into ``root``, checked
    against the golden value's checksum."""
    from pillars_torch import cli
    from pillars_torch.data.synthetic import split_checksum

    golden = json.loads(GOLDEN.read_text())
    t0 = time.perf_counter()
    cli.main(["synth-data", "--root", root, "--num-train", "600",
              "--num-test", "150", "--profile", "hard", "--seed", "7"])
    checksum = split_checksum(root)
    print(f"hard split regenerated in {time.perf_counter() - t0:.1f} s, "
          f"val sha256 {checksum}")
    if checksum != golden["val_checksum"]:
        raise AssertionError("the regenerated val split is not the golden "
                             "value's")


def _with_split(cfg, root):
    for key, value in (
            ("train_input.dataset_root", root),
            ("train_input.info_path", f"{root}/kitti_infos_train.pkl"),
            ("train_input.sampler.info_path",
             f"{root}/kitti_dbinfos_train.pkl"),
            ("eval_input.dataset_root", root),
            ("eval_input.info_path", f"{root}/kitti_infos_val.pkl")):
        cfg = cfg.override(key, value)
    return cfg


def run_evaluate(state_cpu, smi, root):
    """Offline evaluation on the card against the golden AP; returns the
    NMS launches of the run."""
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.trainer import Evaluator

    golden = json.loads(GOLDEN.read_text())
    cfg = _with_split(Config.default(), root)
    det = PillarsDetector(cfg)
    ev = Evaluator(cfg, det, measure_time=True)
    _reset_counts()
    t0 = time.perf_counter()
    text, bev, d3, aos, score = ev.evaluate(det.state_to_device(state_cpu))
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    print(text)
    n_batches = -(-150 // cfg.eval_input.batch_size)
    if launches["nms_keep_mask"] != n_batches + 1:
        raise AssertionError(f"evaluate: NMS launches {launches} for "
                             f"{n_batches} batches and one warm-up")
    worst = max(np.abs(np.asarray(got) - np.asarray(golden[key])).max()
                for got, key in ((bev, "mAP_bev"), (d3, "mAP_3d"),
                                 (aos, "mAP_aos")))
    print(f"evaluate, 150 hard val clouds, batch "
          f"{cfg.eval_input.batch_size}: aggregate {score:.4f}, golden "
          f"{golden['aggregate']:.4f} (pillars_tpu on the CPU, f32), "
          f"difference {score - golden['aggregate']:+.4f} (tol {AP_TOL}), "
          f"largest AP cell difference {worst:.4f}; the archived TPU run's "
          f"model_result_59.txt reads 64.88 at another matmul precision and "
          f"is not held against; {seconds:.2f} s with AP, stages ms/cloud "
          f"{json.dumps({k: round(v, 4) for k, v in sorted(ev.last_stage_ms.items())})}"
          f"; NMS launches {launches['nms_keep_mask']} = batches + warm-up "
          f"[{smi}]")
    if not abs(score - golden["aggregate"]) <= AP_TOL:
        raise AssertionError(f"aggregate {score} vs golden "
                             f"{golden['aggregate']}: more than {AP_TOL}")
    return launches


def _max_rel(got, want):
    """max |got - want| over max |want| (``got`` on the card)."""
    return (float((got.cpu().double() - want.double()).abs().max())
            / max(float(want.abs().max()), 1e-30))


def _train_state(det, state_cpu):
    from pillars_torch.train.loop import TrainState, split_state
    from pillars_torch.train.optim import AdamW

    params, stats = split_state(det.state_to_device(state_cpu))
    opt = AdamW(det.config.train.optimizer,
                det.config.train_input.batch_size)
    return TrainState(0, params, stats, opt.init(params)), opt


def run_train_step(state_cpu, smi, root):
    """The train step at full width, B=2, from the trained checkpoint: the
    card against the port on the CPU, then its times and memory."""
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.loop import batch_to_device

    cfg = _with_split(Config.default(), root)
    thr = cfg.train_input.anchor_area_threshold
    t0 = time.perf_counter()
    batches = _train_batches(cfg, 20)
    loader_ms = (time.perf_counter() - t0) * 1e3 / 20
    batch = batches[0]
    det, det_cpu = PillarsDetector(cfg), PillarsDetector(cfg, device="cpu")
    state, _ = _train_state(det, state_cpu)
    state_h, _ = _train_state(det_cpu, state_cpu)

    print(f"train step B=2 full width, card vs CPU: "
          f"{_step_close(det, det_cpu, state, state_h, batch, thr)}")

    on_card = batch_to_device(batch, det.device)
    turns = _step_turns(cfg, state_cpu, on_card)
    memory = _step_memory(cfg, state_cpu, on_card)
    stats = {"loader_ms_per_batch": loader_ms, "turns": turns, **memory}
    print(f"train step B=2 full width in turns: {_turns_line(turns)} "
          f"[{smi}]")
    print(f"train step B=2 full width: peak device memory of an eager step "
          f"above the state {memory['peak_mib_remat_off']:.1f} MiB with "
          f"rpn.remat off, {memory['peak_mib_remat_on']:.1f} MiB on; the "
          f"host makes one augmented batch (sampler, noise, global "
          f"transforms) in {loader_ms:.1f} ms on one thread [{smi}]")
    stats["stages"] = _train_stages(cfg, state_cpu, on_card, turns, smi)
    print("train step: " + json.dumps(stats))
    return stats


def _rel_l2(got, want):
    """||got - want|| over ||want|| (``got`` on the card)."""
    want = want.double()
    return (float((got.cpu().double() - want).norm())
            / max(float(want.norm()), 1e-30))


def _step_close(det, det_cpu, state, state_h, batch, thr, grad_l2=None,
                fb_h=None, names=None):
    """One batch's targets, loss parts, gradients and new BN statistics on
    the card (``det``, ``state``) against the CPU's (``fb_h``, computed
    unless given); returns the line that says how close. The gradients are
    held to ``GRAD_RTOL`` of each leaf's max or, with ``grad_l2``, by each
    leaf's relative L2. ``names``: the leaves to differentiate, as the
    train step does (default every one)."""
    from pillars_torch.train.loop import batch_to_device, gradients

    def fb_of(d, st):
        return gradients(d, st.params, st.batch_stats,
                         batch_to_device(batch, d.device), thr, names)

    fb = fb_of(det, state)
    if fb_h is None:
        fb_h = fb_of(det_cpu, state_h)
    torch.cuda.synchronize()
    if not torch.equal(fb.targets.labels.cpu(), fb_h.targets.labels):
        raise AssertionError("train step: labels differ between card and CPU")
    n_pos = int((fb_h.targets.labels > 0).sum())
    if not n_pos:
        raise AssertionError("train step: the batch has no positive anchor")
    t_err = float((fb.targets.bbox_targets.cpu()
                   - fb_h.targets.bbox_targets).abs().max())
    if t_err > TARGET_ATOL:
        raise AssertionError(f"bbox_targets card vs CPU {t_err}")
    loss_err = 0.0
    for name, a, b in zip(fb_h.loss._fields, fb.loss, fb_h.loss):
        err = abs(float(a) - float(b)) / max(abs(float(b)), 1e-6)
        loss_err = max(loss_err, err)
        if err > LOSS_RTOL:
            raise AssertionError(f"{name}: card {float(a)} vs CPU {float(b)}")
    rel = {k: _max_rel(fb.grads[k], g) for k, g in fb_h.grads.items()}
    worst = max(rel, key=rel.get)
    grads = (f"{len(fb_h.grads)} gradient leaves max diff {rel[worst]:.3e} "
             f"of their max ({worst})")
    if grad_l2 is None:
        grads += f" (tol {GRAD_RTOL})"
        if rel[worst] > GRAD_RTOL:
            raise AssertionError(f"gradients card vs CPU: {grads}")
    else:
        l2 = {k: _rel_l2(fb.grads[k], g) for k, g in fb_h.grads.items()}
        worst_l2 = max(l2, key=l2.get)
        grads += (f", relative L2 at most {l2[worst_l2]:.3e} ({worst_l2}; "
                  f"tol {grad_l2:.3e})")
        if l2[worst_l2] > grad_l2:
            raise AssertionError(f"gradients card vs CPU: {grads}")
    stat_err = max(_max_rel(fb.batch_stats[k], v)
                   for k, v in fb_h.batch_stats.items()
                   if v.is_floating_point())
    if stat_err > STAT_RTOL:
        raise AssertionError(f"new BN statistics card vs CPU {stat_err}")
    return (f"labels equal ({n_pos} positive anchors), bbox_targets max "
            f"|diff| {t_err:.3e} (tol {TARGET_ATOL}), loss parts max rel "
            f"{loss_err:.3e} (tol {LOSS_RTOL}), {grads}, new BN statistics "
            f"{stat_err:.3e} (tol {STAT_RTOL}); loss "
            f"{float(fb.loss.loss):.4f} (CPU {float(fb_h.loss.loss):.4f})")


def _train_stages(cfg, state_cpu, on_card, turns, smi, host=None,
                  label="train step"):
    """The eager step's launches and device ms by stage (record_function
    ranges under torch.profiler), beside the whole captured step's."""
    from pillars_torch.utils.profiling import train_stage_breakdown

    _, eager, state = _train_steps(cfg, state_cpu, host)
    stages = train_stage_breakdown(eager, state, on_card, 5)
    captured = [t for t in turns if t["variant"] == "captured"]
    total = sum(ms for _, ms in stages.values())
    if not total > 0:
        raise AssertionError(f"train stages: no device time attributed "
                             f"{stages}")
    print(f"{label} stages (eager, per step: kernel launches, device ms): "
          + ", ".join(f"{k} {c:g} / {ms:.3f}" for k, (c, ms)
                      in stages.items())
          + f"; sum {sum(c for c, _ in stages.values()):g} / {total:.3f}; "
          f"the whole captured step "
          f"{captured[0]['launches_per_step']:g} / "
          f"{captured[0]['device_ms_per_step']:.3f} [{smi}]")
    return {k: {"launches": c, "device_ms": ms}
            for k, (c, ms) in stages.items()}


def _train_batches(cfg, n, b=2):
    """The first ``n`` batches of ``b`` clouds of the train split as
    training reads it (``PedestrianDataset(training=True)`` with the
    GT-database sampler, seed 0)."""
    from pillars_torch.data.pipeline import PedestrianDataset, collate
    from pillars_torch.data.sampler import DataBaseSampler

    sampler = DataBaseSampler(cfg.train_input.sampler.info_path,
                              cfg.train_input.sampler,
                              rng=np.random.RandomState(0))
    ds = PedestrianDataset(cfg, cfg.train_input, training=True,
                           sampler=sampler, rng=np.random.RandomState(0))
    return [collate([ds[b * i + j] for j in range(b)]) for i in range(n)]


def _clone_state(state):
    from pillars_torch.train.loop import TrainState
    from pillars_torch.train.optim import AdamState

    c = lambda d: {k: v.clone() for k, v in d.items()}  # noqa: E731
    return TrainState(state.step, c(state.params), c(state.batch_stats),
                      AdamState(state.opt_state.count, c(state.opt_state.mu),
                                c(state.opt_state.nu)))


def _train_steps(cfg, state_cpu, host=None):
    """(the captured step of ``cfg`` on the card, its eager step, the state
    from ``state_cpu``, or resumed from the checkpoint's TrainState ``host``
    with its AdamW moments and count); raises unless ``make_train_step``
    captured."""
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train import checkpoint as ckpt
    from pillars_torch.train.loop import CapturedTrainStep, make_train_step

    det = PillarsDetector(cfg)
    state, opt = _train_state(det, state_cpu)
    if host is not None:
        state = ckpt.train_state_from_host(host, cfg, det.device)
    step = make_train_step(det, opt)
    if not isinstance(step, CapturedTrainStep):
        raise AssertionError("make_train_step did not capture on the card")
    return step, step.eager, state


def _time_train_step(fn, state, on_card, captured, iters=20, prof_iters=5,
                     group=None):
    """ms per step (CUDA events over ``iters`` warm steps), host wall ms per
    step, kernel and graph launches, device ms and idle share per step
    (torch.profiler over ``prof_iters``) of the train step ``fn`` threaded
    from ``state`` on the batch ``on_card``; for a captured step also the
    seconds of its first call and capture and the graph pool's MiB.
    ``group``: the ranks that take the same steps (``device_busy``)."""
    from pillars_torch.cuda_graph import pool_mib
    from pillars_torch.utils.profiling import cuda_ms, device_busy

    box = [state]

    def one():
        box[0] = fn(box[0], on_card)[0]

    for _ in range(3):
        one()
    ms = cuda_ms(one, iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        one()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    prof_wall, device_ms, rows, graphs = device_busy(one, prof_iters,
                                                     group=group)
    out = {"variant": "captured" if captured else "eager",
           "ms_per_step": ms, "host_wall_ms_per_step": wall_ms,
           "launches_per_step": sum(c for _, c, _ in rows),
           "graph_launches_per_step": graphs,
           "device_ms_per_step": device_ms,
           "idle_share": 1 - device_ms / prof_wall,
           "nccl_kernels_per_step": sum(c for k, c, _ in rows
                                        if "nccl" in k.lower()),
           "dtod_copies_per_step": sum(c for k, c, _ in rows
                                       if "DtoD" in k)}
    if captured:
        out["capture_s"] = [g.seconds for g in fn.graphs.values()]
        out["pool_mib"] = pool_mib()
    return out


def _step_turns(cfg, state_cpu, on_card, host=None):
    """The captured and the eager step of ``cfg`` timed in turns (eager,
    captured, captured, eager), each from the state of :func:`_train_steps`."""
    step, eager, state = _train_steps(cfg, state_cpu, host)
    return [_time_train_step(step if v == "captured" else eager,
                             _clone_state(state), on_card, v == "captured")
            for v in ("eager", "captured", "captured", "eager")]


def _eager_peak_mib(eager, state, on_card):
    """Peak device memory of an eager step above the state (MiB)."""
    eager(state, on_card)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager(state, on_card)
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def _step_memory(cfg, state_cpu, on_card, host=None):
    """Peak device memory of an eager step above the state with
    ``rpn.remat`` off and on (MiB)."""
    peak = {}
    for remat in (False, True):
        _, eager, state = _train_steps(
            cfg.override("model.rpn.remat", remat), state_cpu, host)
        peak[remat] = _eager_peak_mib(eager, state, on_card)
    return {"peak_mib_remat_off": peak[False],
            "peak_mib_remat_on": peak[True]}


def _step_line(t):
    line = (f"{t['variant']} {t['ms_per_step']:.3f} ms per step (CUDA "
            f"events, 20 warm steps), {t['host_wall_ms_per_step']:.3f} ms "
            f"host wall; {t['graph_launches_per_step']:g} graph and "
            f"{t['launches_per_step']:g} kernel launches and "
            f"{t['device_ms_per_step']:.3f} ms of device time per step, idle "
            f"share {t['idle_share']:.3f} (torch.profiler)")
    if "capture_s" in t:
        line += (f"; first call + capture {t['capture_s']} s, graph pool "
                 f"{t['pool_mib']:.1f} MiB")
    return line


def _turns_line(turns):
    return "; ".join(_step_line(t) for t in turns)


def _train_cfg(root, out, n_clouds, cfg=None):
    """``cfg`` (``Config.default()``) on the first ``n_clouds`` clouds of
    the train split under ``root``, writing its runs under ``out``."""
    import pickle

    from pillars_torch.config import Config

    with open(f"{root}/kitti_infos_train.pkl", "rb") as f:
        infos = pickle.load(f)
    train_info = f"{out}_infos_train.pkl"
    with open(train_info, "wb") as f:
        pickle.dump(infos[:n_clouds], f, 2)
    return (_with_split(cfg or Config.default(), root)
            .override("out_dir", out)
            .override("train_input.info_path", train_info))


def _trainer_epoch(cfg, epoch, resume=None, eager=False, params=False):
    """Epoch ``epoch`` of a new ``Trainer(cfg)`` (from ``PillarsDetector.
    init``, or ``train.load_weights``, or resumed from ``resume``: an
    earlier result's weights_temp.pkl, or a (checkpoint path, step) pair)
    with its eval: the losses and rates of its steps, whether all were
    finite, its NMS launches and its times, and with ``params`` the
    parameters after the epoch; its captured step, or with ``eager`` the
    eager one. Gates: the state on the card, the eval's NMS launches equal
    to its batches."""
    from pillars_torch.train.loop import CapturedTrainStep
    from pillars_torch.train.trainer import Trainer

    trainer = Trainer(cfg)
    if not isinstance(trainer.step_fn, CapturedTrainStep):
        raise AssertionError("the Trainer's step is not captured")
    if eager:
        trainer.step_fn = trainer.step_fn.eager
    if resume is not None:
        path, want = ((os.path.join(resume["dirs"]["checkpoints"],
                                    "weights_temp.pkl"), resume["steps"])
                      if isinstance(resume, dict) else resume)
        step = trainer.resume(path)
        if step != want or trainer._start_epoch != epoch:
            raise AssertionError(f"resume: step {step}, epoch "
                                 f"{trainer._start_epoch}")
    losses, rates, evals = [], [], []
    inner_step, inner_eval = trainer.step_fn, trainer.evaluator.evaluate

    def step_fn(state, batch):
        state, metrics = inner_step(state, batch)
        losses.append(metrics.loss)
        rates.append(metrics.learning_rate)
        return state, metrics

    def evaluate(*args, **kwargs):
        _reset_counts()
        t0 = time.perf_counter()
        out = inner_eval(*args, **kwargs)
        evals.append((out[4], _read_counts()["nms_keep_mask"],
                      time.perf_counter() - t0))
        return out

    trainer.step_fn, trainer.evaluator.evaluate = step_fn, evaluate
    t0 = time.perf_counter()
    trainer.train(epochs=epoch + 1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0 - sum(e[2] for e in evals)
    if trainer.device.type != CARD or any(
            t.device.type != CARD
            for t in (*trainer.state.params.values(),
                      *trainer.state.batch_stats.values(),
                      *trainer.state.opt_state.mu.values())):
        raise AssertionError("the Trainer's state left the card")
    n_eval = len(trainer.evaluator.dataset)
    batches = -(-n_eval // cfg.eval_input.batch_size)
    if len(evals) != 1 or evals[0][1] != batches:
        raise AssertionError(f"epoch {epoch} eval: NMS launches "
                             f"{[e[1] for e in evals]} for {batches} "
                             f"batches")
    loss = torch.stack(losses).float().cpu()
    out = {"dirs": trainer.dirs, "steps": trainer.state.step,
           "n_steps": len(losses), "seconds": seconds,
           "first_loss": float(loss[0]), "last50": float(loss[-50:].mean()),
           "mean_loss": float(loss.mean()), "first_rate": float(rates[0]),
           "finite": bool(torch.isfinite(loss).all()),
           "ap": evals[0][0], "eval_seconds": evals[0][2],
           "nms_launches": evals[0][1],
           "recal_batches": len(trainer.evaluator._recal_batches or ())}
    if params:
        out["params"] = {k: v.cpu() for k, v in trainer.state.params.items()}
    return out


def _epoch_line(r, epoch, n_clouds):
    return (f"epoch {epoch}, {n_clouds} train clouds: {r['n_steps']} steps "
            f"in {r['seconds']:.2f} s ({r['n_steps'] / r['seconds']:.2f} "
            f"steps/s, B=2), loss first {r['first_loss']:.4f}, mean of the "
            f"last 50 {r['last50']:.4f}; eval {r['eval_seconds']:.2f} s, NMS "
            f"launches {r['nms_launches']} = eval batches; aggregate AP "
            f"{r['ap']:.4f} after {r['steps']} steps")


def run_trainer(smi, root, out, n_clouds):
    """Epoch 0 of a Trainer from ``PillarsDetector.init`` on the first
    ``n_clouds`` train clouds, then epoch 1 in a new Trainer resumed from
    the first's weights_temp.pkl; returns both epochs' results."""
    cfg = _train_cfg(root, out, n_clouds)
    r0 = _trainer_epoch(cfg, 0)
    r1 = _trainer_epoch(cfg, 1, resume=r0)
    for epoch, r in enumerate((r0, r1)):
        print(f"Trainer {_epoch_line(r, epoch, n_clouds)} (the JAX run after "
              f"{r['steps']} steps: "
              f"{JAX_AP_AFTER_STEPS.get(r['steps'], 'no eval')}) [{smi}]")
    r_eager = _trainer_epoch(cfg, 0, eager=True)
    print(f"Trainer with the eager step {_epoch_line(r_eager, 0, n_clouds)}; "
          f"epoch 0 captured {r0['seconds']:.2f} s against eager "
          f"{r_eager['seconds']:.2f} s [{smi}]")
    if not r_eager["last50"] < LOSS_GATE:
        raise AssertionError(f"eager epoch 0: mean loss of the last 50 steps "
                             f"{r_eager['last50']} not below {LOSS_GATE}")
    if not r0["last50"] < LOSS_GATE:
        raise AssertionError(f"epoch 0: mean loss of the last 50 steps "
                             f"{r0['last50']} not below {LOSS_GATE}")
    if r1["steps"] != 2 * r0["steps"] or r0["steps"] != r0["n_steps"]:
        raise AssertionError(f"steps {r0['steps']} then {r1['steps']}")
    if not os.path.exists(os.path.join(r1["dirs"]["results"],
                                       "model_result_1.txt")):
        raise AssertionError("the resumed run did not number its epoch 1")
    if not r1["ap"] > AP1_FLOOR:
        raise AssertionError(f"epoch-1 aggregate AP {r1['ap']} not above "
                             f"{AP1_FLOOR}")
    summary = {"train_clouds": n_clouds,
               "epoch_seconds": [r0["seconds"], r1["seconds"]],
               "steps_per_s": [r["n_steps"] / r["seconds"] for r in (r0, r1)],
               "last50_loss_epoch0": r0["last50"],
               "ap": [r0["ap"], r1["ap"]], "steps": [r0["steps"], r1["steps"]],
               "eval_seconds": [r0["eval_seconds"], r1["eval_seconds"]],
               "eager_epoch0": {k: v for k, v in r_eager.items()
                                if k != "dirs"},
               "jax_ap_after_steps": JAX_AP_AFTER_STEPS}
    print("trainer: " + json.dumps(summary))
    return r0, r1


def _rulebooks_equal(det, det_cpu, v, v_cpu, label):
    """The voxelization's integers and every stage's active set and
    rulebooks, card against CPU; returns the active rows per stage."""
    for name in ("coords", "pillar_mask", "num_points"):
        if not torch.equal(getattr(v, name).cpu(), getattr(v_cpu, name)):
            raise AssertionError(f"{label}: voxelization {name} differs")
    stages, last = det.network.middle.rulebooks(v.coords, v.pillar_mask)
    want, want_last = det_cpu.network.middle.rulebooks(v_cpu.coords,
                                                       v_cpu.pillar_mask)
    names = ("keys", "valid", "subm_rulebook", "out_keys", "out_valid",
             "strided_rulebook")
    for i, (got, exp) in enumerate(zip(stages, want)):
        for name, g, w in zip(names, got, exp):
            if not torch.equal(g.cpu(), w):
                raise AssertionError(f"{label}: stage {i} {name} differs "
                                     f"between card and CPU")
    for g, w in zip(last[:2], want_last[:2]):
        if not torch.equal(g.cpu(), w):
            raise AssertionError(f"{label}: the last active set differs")
    return [int(st[1].sum()) for st in want] + [int(want_last[1].sum())]


def _heads_close(preds, preds_cpu, label):
    worst = 0.0
    for key, w in preds_cpu.items():
        if not torch.isfinite(preds[key]).all():
            raise AssertionError(f"{label} {key}: non-finite on the card")
        err = _max_rel(preds[key], w)
        worst = max(worst, err)
        if err > HEAD_RTOL:
            raise AssertionError(f"{label} {key}: card vs CPU {err} of max "
                                 f"> {HEAD_RTOL}")
    return worst


def _post_close(det, det_cpu, preds_cpu, amask_cpu, rect, trv2c, label):
    """The card's postprocess fed the CPU's heads against the CPU's."""
    want = det_cpu.postprocess(preds_cpu, amask_cpu, rect, trv2c)
    got = det.postprocess({k: v.cuda() for k, v in preds_cpu.items()},
                          amask_cpu.cuda(), rect.cuda(), trv2c.cuda())
    got = type(got)(*(t.cpu() for t in got))
    v = want.valid
    if not (torch.equal(got.valid, v)
            and torch.equal(got.labels[v], want.labels[v])):
        raise AssertionError(f"{label}: postprocess valid/labels differ")
    err = 0.0
    for name in ("boxes_lidar", "boxes_camera", "scores"):
        e = (getattr(got, name)[v] - getattr(want, name)[v]).abs()
        err = max(err, float(e.max()) if e.numel() else 0.0)
    if err > POST_ATOL:
        raise AssertionError(f"{label}: postprocess {err} > {POST_ATOL}")
    return err


def _counted(fn, state, batches):
    """Launch counts around ``fn`` over ``batches`` (dicts on the card)."""
    _reset_counts()
    outs = [fn(state, b["points"], b["num_points"], b["rect"], b["trv2c"])
            for b in batches]
    torch.cuda.synchronize()
    launches = _read_counts()
    if (launches["nms_keep_mask"] != len(batches)
            or launches["rpn_sep_block"] != 0):
        raise AssertionError(f"launches {launches} for {len(batches)} "
                             f"batches")
    for out in outs:
        if not out.valid.any():
            raise AssertionError("no valid detection")
    return launches


def _cloud_times(call, iters=50):
    """Warm ms per call (CUDA events), host wall ms, and kernel and graph
    launches, device ms and idle share per call (torch.profiler)."""
    from pillars_torch.utils.profiling import cuda_ms, device_busy

    ms = cuda_ms(call, iters)
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / iters
    prof_wall, device, rows, graphs = device_busy(call, 20,
                                                  "nms_keep_mask_kernel")
    top = sorted(rows, key=lambda r: -r[2])[:6]
    return {"ms": ms, "host_wall_ms": wall,
            "launches": sum(c for _, c, _ in rows), "graph_launches": graphs,
            "device_ms": device, "idle_share": 1 - device / prof_wall,
            "top_kernels": [[n[:60], c, t] for n, c, t in top]}


def _on_card(batch):
    return {k: torch.as_tensor(batch[k]).cuda()
            for k in ("points", "num_points", "rect", "trv2c")}


def run_second_sparse(smi, root):
    """Phase 12; returns {path: launches}."""
    from pillars_torch.config import Config
    from pillars_torch.data.pipeline import (PedestrianDataset, collate)
    from pillars_torch.data.sampler import DataBaseSampler
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.ops import sparse_conv
    from pillars_torch.train.loop import forward_backward
    from pillars_torch.train.trainer import Evaluator
    from pillars_torch.utils.profiling import device_busy
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = _with_split(Config.from_yaml(str(CONFIGS
                                           / "second_sparse_d435i.yaml")),
                      root)
    thr = cfg.eval_input.anchor_area_threshold
    det, det_cpu = PillarsDetector(cfg), PillarsDetector(cfg, device="cpu")
    state_cpu = from_jax_variables(*load_params(str(SECOND_WEIGHTS)), cfg)
    state = det.state_to_device(state_cpu)
    fn = det.make_inference_fn()
    ev = Evaluator(cfg, det, measure_time=True)
    items = [ev.dataset[i] for i in range(6)]
    batches = [collate([it]) for it in items[:4]] + [collate(items[4:])]
    on_card = [_on_card(b) for b in batches]
    launches = {"B1": _counted(fn, state, on_card[:4]),
                "B2": _counted(fn, state, on_card[4:])}
    print(f"SECOND sparse, 4 batches at B=1 and 1 at B=2: launches "
          f"{launches}")

    head_err, post_err, active = 0.0, 0.0, []
    with torch.inference_mode():
        for b, bc in zip(batches, on_card):
            pts, num = torch.from_numpy(b["points"]), torch.from_numpy(
                b["num_points"])
            v_cpu = det_cpu.voxelize_batch(pts, num)
            v = det.voxelize_batch(bc["points"], bc["num_points"])
            active.append(_rulebooks_equal(det, det_cpu, v, v_cpu,
                                           "SECOND sparse"))
            amask_cpu = det_cpu.anchors_mask_batch(v_cpu.coords,
                                                   v_cpu.pillar_mask, thr)
            if not torch.equal(det.anchors_mask_batch(
                    v.coords, v.pillar_mask, thr).cpu(), amask_cpu):
                raise AssertionError("SECOND sparse: anchors mask differs")
            preds_cpu = det_cpu.apply(state_cpu, v_cpu)
            head_err = max(head_err, _heads_close(
                det.apply(state, v), preds_cpu, "SECOND sparse"))
            post_err = max(post_err, _post_close(
                det, det_cpu, preds_cpu, amask_cpu,
                torch.from_numpy(b["rect"]), torch.from_numpy(b["trv2c"]),
                "SECOND sparse"))
    print(f"SECOND sparse card vs CPU: active rows per stage (input, "
          f"stage 1, stage 2 out) {active}, every active set and rulebook "
          f"equal; head tensors max diff {head_err:.3e} of their max (tol "
          f"{HEAD_RTOL}); postprocess on the same heads max |diff| "
          f"{post_err:.3e} (tol {POST_ATOL}); anchors mask equal")

    b0 = on_card[0]
    times = _cloud_times(lambda: fn(state, b0["points"], b0["num_points"],
                                    b0["rect"], b0["trv2c"]))
    with torch.inference_mode():
        v = det.voxelize_batch(b0["points"], b0["num_points"])
        mid = det.network.middle
        _, rulebook_ms, rows, _ = device_busy(
            lambda: mid.rulebooks(v.coords, v.pillar_mask), 20)
        rulebook_launches = sum(c for _, c, _ in rows)
        # the eager function runs the Python a replay skips
        calls, inner = [], sparse_conv.gather_conv
        sparse_conv.gather_conv = lambda *a: (calls.append(a), inner(*a))[1]
        try:
            fn.eager(state, b0["points"], b0["num_points"], b0["rect"],
                     b0["trv2c"])
        finally:
            sparse_conv.gather_conv = inner
        _, gather_ms, rows, _ = device_busy(
            lambda: [inner(*a) for a in calls], 20)
    times.update(rulebooks_launches=rulebook_launches,
                 gather_conv_launches=sum(c for _, c, _ in rows),
                 rulebooks_device_ms=rulebook_ms,
                 gather_conv_device_ms=gather_ms, gather_conv_calls=len(calls),
                 rulebooks_share=rulebook_ms / times["device_ms"],
                 gather_conv_share=gather_ms / times["device_ms"])
    print(f"SECOND sparse B=1: {times['ms']:.3f} ms/cloud (CUDA events, "
          f"warm), {times['host_wall_ms']:.3f} ms host wall; "
          f"{times['launches']:g} launches, {times['device_ms']:.4f} ms of "
          f"device time per cloud, idle share {times['idle_share']:.3f} "
          f"(torch.profiler); rulebooks {rulebook_ms:.4f} ms "
          f"({times['rulebooks_share']:.3f} of the device time), gather_conv "
          f"x{len(calls)} {gather_ms:.4f} ms "
          f"({times['gather_conv_share']:.3f}) [{smi}]")
    print("second sparse: " + json.dumps(times))

    golden = json.loads(SECOND_GOLDEN.read_text())
    _reset_counts()
    t0 = time.perf_counter()
    text, bev, d3, aos, score = ev.evaluate(state)
    seconds = time.perf_counter() - t0
    launches["eval"] = _read_counts()
    print(text)
    n_batches = -(-len(ev.dataset) // cfg.eval_input.batch_size)
    if (launches["eval"]["nms_keep_mask"] != n_batches + 1
            or launches["eval"]["rpn_sep_block"] != 0):
        raise AssertionError(f"SECOND evaluate: launches {launches['eval']} "
                             f"for {n_batches} batches and one warm-up")
    worst = max(np.abs(np.asarray(got) - np.asarray(golden[key])).max()
                for got, key in ((bev, "mAP_bev"), (d3, "mAP_3d"),
                                 (aos, "mAP_aos")))
    print(f"SECOND sparse evaluate, {len(ev.dataset)} hard val clouds: "
          f"aggregate {score:.4f}, golden {golden['aggregate']:.4f} "
          f"(pillars_tpu on the CPU, f32), difference "
          f"{score - golden['aggregate']:+.4f} (tol {AP_TOL}), largest AP "
          f"cell difference {worst:.4f}; {seconds:.2f} s with AP, stages "
          f"ms/cloud "
          f"{json.dumps({k: round(v, 4) for k, v in sorted(ev.last_stage_ms.items())})}"
          f"; NMS launches {launches['eval']['nms_keep_mask']} = batches + "
          f"warm-up [{smi}]")
    if not abs(score - golden["aggregate"]) <= AP_TOL:
        raise AssertionError(f"SECOND aggregate {score} vs golden "
                             f"{golden['aggregate']}: more than {AP_TOL}")

    sampler = DataBaseSampler(cfg.train_input.sampler.info_path,
                              cfg.train_input.sampler,
                              rng=np.random.RandomState(0))
    ds = PedestrianDataset(cfg, cfg.train_input, training=True,
                           sampler=sampler, rng=np.random.RandomState(0))
    batch = collate([ds[0], ds[1]])
    state_t, _ = _train_state(det, state_cpu)
    state_h, _ = _train_state(det_cpu, state_cpu)
    fb = forward_backward(det, state_t, batch,
                          cfg.train_input.anchor_area_threshold)
    fb_h = forward_backward(det_cpu, state_h, batch,
                            cfg.train_input.anchor_area_threshold)
    torch.cuda.synchronize()
    if not torch.equal(fb.targets.labels.cpu(), fb_h.targets.labels):
        raise AssertionError("SECOND train step: labels differ")
    n_pos = int((fb_h.targets.labels > 0).sum())
    loss_err = abs(float(fb.loss.loss) - float(fb_h.loss.loss)) / max(
        abs(float(fb_h.loss.loss)), 1e-6)
    grad_err = max(_max_rel(fb.grads[k], g) for k, g in fb_h.grads.items())
    stat_err = max(_max_rel(fb.batch_stats[k], v)
                   for k, v in fb_h.batch_stats.items()
                   if v.is_floating_point())
    if loss_err > LOSS_RTOL or grad_err > GRAD_RTOL or stat_err > GRAD_RTOL:
        raise AssertionError(f"SECOND train step card vs CPU: loss "
                             f"{loss_err}, gradients {grad_err}, BN "
                             f"statistics {stat_err}")
    if not any(k.startswith("middle.") for k in fb_h.batch_stats):
        raise AssertionError("SECOND train step: no middle BN statistics")
    print(f"SECOND sparse train step B=2 from the checkpoint, card vs CPU: "
          f"labels equal ({n_pos} positive anchors), loss rel {loss_err:.3e} "
          f"(tol {LOSS_RTOL}), {len(fb_h.grads)} gradient leaves max diff "
          f"{grad_err:.3e} of their max (tol {GRAD_RTOL}), "
          f"{len(fb_h.batch_stats)} new BN statistics {stat_err:.3e} (tol "
          f"{GRAD_RTOL}); loss {float(fb.loss.loss):.4f}")
    return launches


def run_second_dense(smi):
    """Phase 13; returns the launches."""
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector

    cfg = Config.from_yaml(str(CONFIGS / "second_d435i.yaml"))
    det, det_cpu = PillarsDetector(cfg), PillarsDetector(cfg, device="cpu")
    state_cpu = det_cpu.init(torch.Generator().manual_seed(0))
    state = det.state_to_device(state_cpu)
    fn = det.make_inference_fn()
    maxpts = cfg.model.voxel.max_points
    head_err, launches, on_card = 0.0, {}, {}
    for b in (1, 2):
        pts, num = _clouds(maxpts, b, 1)
        eye = torch.eye(4).expand(b, 4, 4).contiguous()
        on_card[b] = {"points": torch.from_numpy(pts[0]).cuda(),
                      "num_points": torch.from_numpy(num).cuda(),
                      "rect": eye.cuda(), "trv2c": eye.cuda()}
        launches[f"B{b}"] = _counted(fn, state, [on_card[b]])
        with torch.inference_mode():
            v = det.voxelize_batch(on_card[b]["points"],
                                   on_card[b]["num_points"])
            v_cpu = det_cpu.voxelize_batch(torch.from_numpy(pts[0]),
                                           torch.from_numpy(num))
            head_err = max(head_err, _heads_close(
                det.apply(state, v), det_cpu.apply(state_cpu, v_cpu),
                f"SECOND dense B={b}"))
    b1 = on_card[1]
    times = _cloud_times(lambda: fn(state, b1["points"], b1["num_points"],
                                    b1["rect"], b1["trv2c"]))
    print(f"SECOND dense (conv3d middle) seeded init, 19200-point clouds: "
          f"launches {launches}; head tensors card vs CPU max diff "
          f"{head_err:.3e} of their max (tol {HEAD_RTOL}) at B=1 and B=2; "
          f"B=1 {times['ms']:.3f} ms/cloud (CUDA events), "
          f"{times['host_wall_ms']:.3f} ms host wall, {times['launches']:g} "
          f"launches, {times['device_ms']:.4f} ms device, idle share "
          f"{times['idle_share']:.3f} [{smi}]")
    print("second dense: " + json.dumps(times))
    return launches


def _kitti_cloud(n=120000, seed=0):
    """A KITTI-range cloud [n, 4]: a ground plane and upright clutter in the
    front camera's 90 degrees, denser near the sensor; intensity in [0, 1)."""
    r = np.random.RandomState(seed)
    az = r.uniform(-np.pi / 4, np.pi / 4, n)
    rng_m = 2.0 + 68.0 * r.uniform(0, 1, n) ** 2
    ground = r.uniform(size=n) < 0.7
    z = np.where(ground, -1.73 + r.normal(0, 0.05, n), r.uniform(-1.7, 0.9, n))
    return np.stack([rng_m * np.cos(az), rng_m * np.sin(az), z,
                     r.uniform(0, 1, n)], 1).astype(np.float32)


def run_kitti_second(smi):
    """Phase 14; returns the launches."""
    from pillars_torch.config import Config
    from pillars_torch.cuda_graph import pool_mib
    from pillars_torch.models.detector import PillarsDetector

    cfg = Config.from_yaml(str(CONFIGS / "kitti_second.yaml"))
    det, det_cpu = PillarsDetector(cfg), PillarsDetector(cfg, device="cpu")
    state_cpu = det_cpu.init(torch.Generator().manual_seed(0))
    state = det.state_to_device(state_cpu)
    fn = det.make_inference_fn()
    cloud = _kitti_cloud()
    pts = np.zeros((1, cfg.model.voxel.max_points, 4), np.float32)
    pts[0, :len(cloud)] = cloud
    num = np.asarray([len(cloud)], np.int32)
    eye = torch.eye(4)[None]
    bc = {"points": torch.from_numpy(pts).cuda(),
          "num_points": torch.from_numpy(num).cuda(), "rect": eye.cuda(),
          "trv2c": eye.cuda()}
    launches = _counted(fn, state, [bc])
    with torch.inference_mode():
        v = det.voxelize_batch(bc["points"], bc["num_points"])
        v_cpu = det_cpu.voxelize_batch(torch.from_numpy(pts),
                                       torch.from_numpy(num))
        active = _rulebooks_equal(det, det_cpu, v, v_cpu, "kitti_second")
        head_err = _heads_close(det.apply(state, v),
                                det_cpu.apply(state_cpu, v_cpu),
                                "kitti_second")
    call = lambda: fn(state, bc["points"], bc["num_points"], bc["rect"],  # noqa: E731
                      bc["trv2c"])
    times = _cloud_times(call, iters=10)
    # the eager body's peak: a replay allocates from the graph pool, held
    # since its capture
    eager = lambda: fn.eager(state, bc["points"], bc["num_points"],  # noqa: E731
                             bc["rect"], bc["trv2c"])
    eager()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager()
    torch.cuda.synchronize()
    times["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
    times["graph_pool_mib"] = pool_mib()
    print(f"kitti_second full scale (grid 1408x1600x40), one cloud of "
          f"{len(cloud)} points, seeded init: launches {launches}; active "
          f"rows per stage (input, stage 1, stage 2, stage 3 out) {active}, "
          f"every active set and rulebook equal card vs CPU; head tensors "
          f"max diff {head_err:.3e} of their max (tol {HEAD_RTOL}); "
          f"{times['ms']:.3f} ms/cloud (CUDA events), "
          f"{times['host_wall_ms']:.3f} ms host wall, {times['launches']:g} "
          f"launches, {times['device_ms']:.4f} ms device, idle share "
          f"{times['idle_share']:.3f}; peak device memory of an eager call "
          f"{times['peak_mib']:.1f} MiB above the state, graph pool "
          f"{times['graph_pool_mib']:.1f} MiB [{smi}]")
    print("kitti second: " + json.dumps(times))
    return launches


# --------------------------------------------------------------------------
# phase 15: runtime.compute_dtype=bfloat16

BF16_GOLDEN = ROOT / "tests" / "golden" / "torch_hard_val_bf16_ap.json"


def _parity():
    """tests/torch_parity.py, the bfloat16 criteria of the CPU tests: the
    kernel against its twin (``bf16_rounded_close``: each rounds float32
    results that agree within BLOCK_RTOL of their max once, so within one
    bfloat16 step, or near 0 within BLOCK_RTOL of the max), the heads card
    against CPU (``heads_criterion`` with BF16_RMS_FACTOR_FULL: rms within
    0.7 of the CPU's own bfloat16-float32 gap, max within the gap's max; a
    whole network at full width, where flipped roundings spread), and the
    predictions matched as sets (``compare_predictions_bf16``)."""
    tests = str(ROOT / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_parity

    return torch_parity


def check_rpn_kernel_bf16(mcfg, f32):
    """15.1: the bfloat16 chain kernel against its twin on the card, timed
    in turns with the float32 kernel (``f32``: phase 3's entry) at B=1 and
    B=2. Returns the kernel line's entry."""
    from pillars_torch.models.rpn import _Block
    from pillars_torch.ops import rpn_cuda
    from pillars_torch.ops.rpn_blocks import (FoldedLayer,
                                              fused_sep_block_plain,
                                              pack_block)
    from pillars_torch.utils.profiling import cuda_ms, device_busy

    tp = _parity()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(2)
    bf = torch.bfloat16
    shapes = _block_shapes(mcfg)
    layers = []
    for h, w, cin, cout, n, s in shapes:
        layers.append([FoldedLayer(*(torch.from_numpy(a.astype(np.float32))
                                     .cuda() for a in (
            rng.randn(3, 3, ci), rng.randn(ci, cout) / np.sqrt(9 * ci),
            rng.randn(cout) * 0.1)))
            for ci in [cin] + [cout] * n])
    packed = [pack_block(layers[i], sh[4], sh[5])
              for i, sh in enumerate(shapes)]

    def relu_input(*shape):
        return torch.from_numpy(np.maximum(rng.randn(*shape), 0).astype(
            np.float32)).cuda().to(bf)

    # (share of a tensor's elements that differ from the twin, bf16 steps,
    # max |diff|, max |diff| / max |twin|), worst over the checks
    worst = (0.0, 0, 0.0, 0.0)
    with torch.inference_mode():
        for b in (1, 2):
            checks = []
            # the three blocks in one launch, each held against the twin
            # fed what the kernel's block before it wrote
            x = relu_input(b, *shapes[0][:3])
            got = rpn_cuda.fused_sep_chain(x, packed)
            torch.cuda.synchronize()
            for i, (h, w, cin, cout, n, s) in enumerate(shapes):
                checks.append((f"chain block{i + 1} B={b}", got[i],
                               fused_sep_block_plain(x, layers[i], n, s)))
                x = got[i]
            for i, (h, w, cin, cout, n, s) in enumerate(shapes):
                x = relu_input(b, h, w, cin)
                checks.append((f"block{i + 1} B={b} {h}x{w}x{cin}->{cout}",
                               rpn_cuda.fused_sep_block(x, layers[i], n, s),
                               fused_sep_block_plain(x, layers[i], n, s)))
            torch.cuda.synchronize()
            for label, g, want in checks:
                if g.dtype != bf or want.dtype != bf:
                    raise AssertionError(f"{label}: not bfloat16")
                share, steps = tp.bf16_rounded_close(
                    g, want, BLOCK_RTOL, f"rpn_sep_block bf16 {label}")
                err = (g.float() - want.float()).abs().max().item()
                rel = err / want.float().abs().max().item()
                worst = tuple(max(a, c) for a, c in zip(
                    worst, (share, steps, err, rel)))

        xs = [relu_input(1, h, w, cin) for h, w, cin, *_ in shapes]
        unfused = [_Block(cin, cout, n, s, mcfg.rpn.bn_eps, True,
                          dtype=bf).cuda().eval()
                   for _, _, cin, cout, n, s in shapes]
        nchw = xs[0].permute(0, 3, 1, 2).contiguous()

        def twin_chain():
            x = xs[0]
            for i, (*_, n, s) in enumerate(shapes):
                x = fused_sep_block_plain(x, layers[i], n, s)
            return x

        def cudnn_chain():
            x = nchw
            for blk in unfused:
                x = blk(x)
            return x

        plain_ms = cuda_ms(twin_chain, 20)
        cudnn_ms = cuda_ms(cudnn_chain, 200)
        _, cudnn_dev_ms, cudnn_rows, _ = device_busy(cudnn_chain, 50)
        # the chain kernel in both dtypes, in turns, on the same inputs:
        # warm events per call, and the device time per launch from the
        # kernel's own profiler rows (a trace may miss a launch)
        times = {}
        for b in (1, 2):
            x = relu_input(b, *shapes[0][:3])
            for kernel in ("float32", "bfloat16", "bfloat16", "float32"):
                xd = x.to(getattr(torch, kernel))
                call = lambda xd=xd: rpn_cuda.fused_sep_chain(xd, packed)
                ms = cuda_ms(call, 200)
                _, _, rows, _ = device_busy(call, 50, "rpn_sep_chain")
                mine = [(c, t) for name, c, t in rows
                        if "rpn_sep_chain" in name]
                per_launch = sum(t for _, t in mine) / sum(c for c, _ in mine)
                times.setdefault((b, kernel), []).append(
                    (ms, per_launch, sum(c for c, _ in mine)))
    work = [_block_work(1, *sh, act_bytes=2) for sh in shapes]
    flops = sum(f for f, _ in work)
    n_bytes = sum(nb for _, nb in work)
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    share, steps, err, rel = worst
    print(f"rpn_sep_block bf16 against the twin: every element within one "
          f"bf16 step or within {BLOCK_RTOL} of its max; at most "
          f"{share:.2e} of a tensor's elements differ, at most {steps} "
          f"steps (near 0), max |diff| {err:.3e}, {rel:.3e} of the "
          f"tensor's max")
    for (b, kernel), runs in sorted(times.items()):
        print(f"rpn three blocks B={b} {kernel} kernel (one launch, two runs"
              f" in turns): "
              + "; ".join(f"{ms * 1e3:.2f} us per call, {dev * 1e3:.2f} us "
                          f"device per launch ({n:g} traced per call)"
                          for ms, dev, n in runs))
    print(f"rpn bf16 B=1: plain twin {plain_ms * 1e3:.2f} us; "
          f"unfused bf16 cuDNN blocks {cudnn_ms * 1e3:.2f} us, "
          f"{cudnn_dev_ms * 1e3:.2f} us device "
          f"({sum(c for _, c, _ in cudnn_rows):g} launches); bound "
          f"{max(bytes_ms, ops_ms) * 1e3:.2f} us ({flops / 1e6:.1f} M f32 "
          f"ops, {n_bytes / 1e6:.2f} MB with bf16 activations); phase 3's "
          f"f32 kernel {f32['ms'] * 1e3:.2f} us per call, "
          f"{f32['device_ms'] * 1e3:.2f} us device")
    best = {k: min(r, key=lambda t: t[1]) for k, r in times.items()}
    same_call = {k: {f"B{b}": [{"ms": ms, "device_ms": dev}
                               for ms, dev, _ in times[(b, k)]]
                     for b in (1, 2)}
                 for k in ("float32", "bfloat16")}
    return {"name": "rpn_sep_chain_bf16", "route": "cuda",
            "source": "pillars_torch/csrc/rpn_sep_block.cu",
            "replaces": "pillars_tpu/ops/rpn_pallas.py:77",
            "dtype": "bfloat16", "launches": None,
            "max_abs_err": err,
            "ms": best[(1, "bfloat16")][0], "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "device_ms": best[(1, "bfloat16")][1],
            "ms_b2": best[(2, "bfloat16")][0],
            "device_ms_b2": best[(2, "bfloat16")][1],
            "same_call": same_call,
            "unfused_cudnn_ms": cudnn_ms,
            "unfused_cudnn_device_ms": cudnn_dev_ms,
            "max_share_differing": share, "max_rel_diff": rel}


def run_bf16_paths(state_cpu, batches, on_card, f32_times):
    """15.2: the dense-cell and the fast path in bfloat16 on phase 4's
    clouds, against the port on the CPU; returns {path: launches}."""
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector, Predictions

    tp = _parity()
    eye = {b: torch.eye(4).expand(b, 4, 4).contiguous().cuda() for b in (1, 2)}
    result = {}
    for name, cfg in (("dense", Config.default()), ("fast", _fast_config())):
        thr = cfg.eval_input.anchor_area_threshold
        pp = cfg.model.postprocess
        cfg_bf = cfg.override("runtime.compute_dtype", "bfloat16")
        det = PillarsDetector(cfg_bf)
        det_cpu = PillarsDetector(cfg_bf, device="cpu")
        det32_cpu = PillarsDetector(cfg, device="cpu")
        state = det.state_to_device(state_cpu)
        fn, fn_cpu = det.make_inference_fn(), det_cpu.make_inference_fn()
        _reset_counts()
        outs = [fn(state, p, n, eye[p.shape[0]], eye[p.shape[0]])
                for p, n in on_card]
        torch.cuda.synchronize()
        launches = _read_counts()
        want_rpn = len(on_card) if name == "fast" else 0
        print(f"{name} path bf16: {len(on_card)} batches, launches "
              f"{launches}")
        if (launches["nms_keep_mask"] != len(on_card)
                or launches["rpn_sep_block"] != want_rpn
                or launches["rpn_sep_block_bf16"] != want_rpn):
            raise AssertionError(f"{name} bf16: launches {launches}")
        _check_outputs(cfg, on_card, outs)

        def heads(d, st, p, n):
            if name == "dense":
                return d._forward_dense(st, p, n, thr)[0]
            return d._forward_fast(st, d.voxelize_batch(p, n))

        worst, exceptions = {}, 0
        with torch.inference_mode():
            for (pts, num), (p, n), got in zip(batches, on_card, outs):
                b = pts.shape[0]
                pts_t, num_t = torch.from_numpy(pts), torch.from_numpy(num)
                card = {k: v.cpu() for k, v in heads(det, state, p, n).items()}
                if any(v.dtype != torch.bfloat16 for v in card.values()):
                    raise AssertionError(f"{name} bf16: heads not bfloat16")
                ratios = tp.heads_criterion(
                    card, heads(det_cpu, state_cpu, pts_t, num_t),
                    heads(det32_cpu, state_cpu, pts_t, num_t),
                    f"{name} bf16 B={b} card vs CPU",
                    tp.BF16_RMS_FACTOR_FULL)
                for k, (ratio, err) in ratios.items():
                    r0, e0 = worst.get(k, (0.0, 0.0))
                    worst[k] = (max(r0, ratio), max(e0, err))
                eye_cpu = torch.eye(4).expand(b, 4, 4)
                exceptions += tp.compare_predictions_bf16(
                    fn_cpu(state_cpu, pts_t, num_t, eye_cpu, eye_cpu),
                    Predictions(*(t.cpu() for t in got)),
                    pp.nms_score_threshold, pp.nms_iou_threshold,
                    f"{name} bf16 B={b} card vs CPU")
        print(f"{name} path bf16, card vs CPU: heads rms ratio / max |diff| "
              + ", ".join(f"{k} {r:.4f} / {e:.3e}"
                          for k, (r, e) in sorted(worst.items()))
              + f" (rms within {tp.BF16_RMS_FACTOR_FULL} of the CPU's "
              f"bf16-f32 gap); predictions matched as sets, "
              f"{exceptions} borderline exceptions")
        times = _warm_ms(fn, state, *on_card[0], eye[1], f"{name} path bf16")
        ref = f32_times[name]
        print(f"{name} path B=1, bf16 against f32: {times['ms']:.3f} against "
              f"{ref['ms']:.3f} ms/cloud (events), {times['device_ms']:.4f} "
              f"against {ref['device_ms']:.4f} ms device, "
              f"{times['launches']:g} against {ref['launches']:g} launches, "
              f"idle share {times['idle_share']:.3f} against "
              f"{ref['idle_share']:.3f}")
        print(f"{name} bf16: " + json.dumps({"bf16": times, "f32": ref}))
        result[name] = launches
    return result


def run_bf16_evaluate(state_cpu, smi, root):
    """15.3: the Evaluator in bfloat16 against the bfloat16 golden."""
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.trainer import Evaluator

    golden = json.loads(BF16_GOLDEN.read_text())
    f32_golden = json.loads(GOLDEN.read_text())
    cfg = _with_split(Config.default(), root).override(
        "runtime.compute_dtype", "bfloat16")
    det = PillarsDetector(cfg)
    ev = Evaluator(cfg, det, measure_time=True)
    _reset_counts()
    t0 = time.perf_counter()
    text, bev, d3, aos, score = ev.evaluate(det.state_to_device(state_cpu))
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    print(text)
    n_batches = -(-len(ev.dataset) // cfg.eval_input.batch_size)
    if (launches["nms_keep_mask"] != n_batches + 1
            or launches["rpn_sep_block"] != 0):
        raise AssertionError(f"evaluate bf16: launches {launches} for "
                             f"{n_batches} batches and one warm-up")
    worst = max(np.abs(np.asarray(got) - np.asarray(golden[key])).max()
                for got, key in ((bev, "mAP_bev"), (d3, "mAP_3d"),
                                 (aos, "mAP_aos")))
    print(f"evaluate bf16, {len(ev.dataset)} hard val clouds: aggregate "
          f"{score:.4f}, bf16 golden {golden['aggregate']:.4f} (pillars_tpu "
          f"on the CPU in bf16), difference "
          f"{score - golden['aggregate']:+.4f} (tol {AP_TOL}), largest AP "
          f"cell difference {worst:.4f}; the f32 golden reads "
          f"{f32_golden['aggregate']:.4f}; {seconds:.2f} s with AP, stages "
          f"ms/cloud "
          f"{json.dumps({k: round(v, 4) for k, v in sorted(ev.last_stage_ms.items())})}"
          f"; NMS launches {launches['nms_keep_mask']} [{smi}]")
    if golden["val_checksum"] != f32_golden["val_checksum"]:
        raise AssertionError("the bf16 golden was read on another split")
    if not abs(score - golden["aggregate"]) <= AP_TOL:
        raise AssertionError(f"bf16 aggregate {score} vs golden "
                             f"{golden['aggregate']}: more than {AP_TOL}")
    return launches


def run_bf16_second(root):
    """15.4: SECOND sparse in bfloat16 from its checkpoint, four B=1 val
    clouds of phase 12, card against CPU; returns the launches."""
    from pillars_torch.config import Config
    from pillars_torch.data.pipeline import collate
    from pillars_torch.models.detector import PillarsDetector, Predictions
    from pillars_torch.train.trainer import Evaluator
    from pillars_torch.weights import from_jax_variables, load_params

    tp = _parity()
    cfg = _with_split(Config.from_yaml(str(CONFIGS
                                           / "second_sparse_d435i.yaml")),
                      root)
    pp = cfg.model.postprocess
    cfg_bf = cfg.override("runtime.compute_dtype", "bfloat16")
    det = PillarsDetector(cfg_bf)
    det_cpu = PillarsDetector(cfg_bf, device="cpu")
    det32_cpu = PillarsDetector(cfg, device="cpu")
    state_cpu = from_jax_variables(*load_params(str(SECOND_WEIGHTS)), cfg)
    state = det.state_to_device(state_cpu)
    fn, fn_cpu = det.make_inference_fn(), det_cpu.make_inference_fn()
    dataset = Evaluator(cfg_bf, det_cpu).dataset
    batches = [collate([dataset[i]]) for i in range(4)]
    on_card = [_on_card(b) for b in batches]
    launches = _counted(fn, state, on_card)
    worst, exceptions = {}, 0
    with torch.inference_mode():
        for b, bc in zip(batches, on_card):
            pts, num = (torch.from_numpy(b["points"]),
                        torch.from_numpy(b["num_points"]))
            card = det.apply(state, det.voxelize_batch(bc["points"],
                                                       bc["num_points"]))
            card = {k: v.cpu() for k, v in card.items()}
            ratios = tp.heads_criterion(
                card, det_cpu.apply(state_cpu, det_cpu.voxelize_batch(pts,
                                                                      num)),
                det32_cpu.apply(state_cpu, det32_cpu.voxelize_batch(pts, num)),
                "SECOND sparse bf16 card vs CPU", tp.BF16_RMS_FACTOR_FULL)
            for k, (ratio, err) in ratios.items():
                r0, e0 = worst.get(k, (0.0, 0.0))
                worst[k] = (max(r0, ratio), max(e0, err))
            got = fn(state, bc["points"], bc["num_points"], bc["rect"],
                     bc["trv2c"])
            exceptions += tp.compare_predictions_bf16(
                fn_cpu(state_cpu, pts, num, torch.from_numpy(b["rect"]),
                       torch.from_numpy(b["trv2c"])),
                Predictions(*(t.cpu() for t in got)),
                pp.nms_score_threshold, pp.nms_iou_threshold,
                "SECOND sparse bf16 card vs CPU")
    print(f"SECOND sparse bf16, 4 val clouds at B=1, card vs CPU: launches "
          f"{launches}; heads rms ratio / max |diff| "
          + ", ".join(f"{k} {r:.4f} / {e:.3e}"
                      for k, (r, e) in sorted(worst.items()))
          + f"; predictions matched as sets, {exceptions} borderline "
          f"exceptions")
    return launches


# --------------------------------------------------------------------------
# phase 16: runtime.compute_dtype=bfloat16 training

# the bfloat16 Trainer's last-50-step mean loss against the f32 Trainer's
# epoch 0 in the same call
BF16_LOSS_GAP = 0.3


def run_bf16_train_step(state_cpu, smi, root):
    """16.1: the bf16 train step at full width, B=2, from the trained
    checkpoint on phase 10's first batch, the card against the port on the
    CPU in bf16 relative to the CPU's own bf16-f32 gap (the training
    criteria of tests/torch_parity.py); then bf16 and f32 step times in
    turns (f32, bf16, bf16, f32)."""
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.loop import batch_to_device, forward_backward

    tp = _parity()
    cfg = _with_split(Config.default(), root)
    cfg_bf = cfg.override("runtime.compute_dtype", "bfloat16")
    thr = cfg.train_input.anchor_area_threshold
    batch = _train_batches(cfg, 1)[0]
    fbs = {}
    for name, c, dev in (("card", cfg_bf, None), ("cpu", cfg_bf, "cpu"),
                         ("cpu32", cfg, "cpu")):
        det = PillarsDetector(c, device=dev)
        fbs[name] = forward_backward(det, _train_state(det, state_cpu)[0],
                                     batch, thr)
    torch.cuda.synchronize()
    fb, fb_h, fb32 = fbs["card"], fbs["cpu"], fbs["cpu32"]
    if not torch.equal(fb.targets.labels.cpu(), fb_h.targets.labels):
        raise AssertionError("bf16 train step: labels differ between card "
                             "and CPU")
    if not (fb_h.targets.labels > 0).any():
        raise AssertionError("bf16 train step: no positive anchor")
    if fb.cls_preds.dtype != torch.bfloat16:
        raise AssertionError(f"bf16 train step: heads {fb.cls_preds.dtype}")
    if any(g.dtype != torch.float32 or g.device.type != CARD
           for g in fb.grads.values()):
        raise AssertionError("bf16 train step: gradients not f32 on the card")
    # every ratio first, then the gates: a failing run still prints them
    loss = {}
    for k, a, b, c in zip(fb.loss._fields, fb.loss, fb_h.loss, fb32.loss):
        a, b, c = float(a), float(b), float(c)
        loss[k] = (abs(a - b) / max(abs(b - c), 1e-30),
                   abs(a - b) / max(abs(b), 1e-30))
    grads = {k: tp.grad_ratios(fb.grads[k].cpu(), g, fb32.grads[k])
             for k, g in fb_h.grads.items()}
    stats = {k: (tp.head_ratio(fb.batch_stats[k], v, fb32.batch_stats[k]),
                 float((fb.batch_stats[k].cpu() - v).abs().max()
                       / (v - fb32.batch_stats[k]).abs().max()))
             for k, v in fb_h.batch_stats.items() if v.is_floating_point()}

    def worst(d, i):
        k = max(d, key=lambda k: d[k][i])
        return f"{d[k][i]:.4f} ({k})"

    print(f"bf16 train step B=2 full width, card vs CPU (both bf16): labels "
          f"equal; loss parts |card - CPU| over the CPU's bf16-f32 gap, and "
          f"relative: " + ", ".join(f"{k} {g:.3f} / {r:.2e}"
                                    for k, (g, r) in loss.items())
          + f" (gate: {tp.BF16_LOSS_GAP_FACTOR} x the gap or "
          f"{tp.BF16_LOSS_RTOL} relative); {len(grads)} gradient leaves, rms "
          f"over the larger of the gap and one bf16 step: worst "
          f"{worst(grads, 0)}, median "
          f"{np.median([r for r, _ in grads.values()]):.4f} (gate "
          f"{tp.BF16_GRAD_FACTOR}), max over its max: worst "
          f"{worst(grads, 1)}; {len(stats)} new BN statistics, rms over the "
          f"gap: worst {worst(stats, 0)}, median "
          f"{np.median([r for r, _ in stats.values()]):.4f} (gate "
          f"{tp.BF16_RMS_FACTOR_TRAIN}), max over its max: worst "
          f"{worst(stats, 1)}; loss {float(fb.loss.loss):.4f} (f32 "
          f"{float(fb32.loss.loss):.4f})")
    bad = ([k for k, (g, r) in loss.items()
            if g > tp.BF16_LOSS_GAP_FACTOR and r > tp.BF16_LOSS_RTOL]
           + [k for k, (r, _) in grads.items() if r > tp.BF16_GRAD_FACTOR]
           + [k for k, (r, _) in stats.items()
              if r > tp.BF16_RMS_FACTOR_TRAIN])
    if bad:
        raise AssertionError(f"bf16 train step card vs CPU: {bad}")

    on_card = batch_to_device(batch, CARD)
    steps = {c.runtime.compute_dtype: _train_steps(c, state_cpu)
             for c in (cfg, cfg_bf)}
    times = {"float32": [], "bfloat16": []}
    for dtype in ("float32", "bfloat16", "bfloat16", "float32"):
        step, eager, state = steps[dtype]
        for v in (("eager", "captured") if len(times[dtype]) == 0
                  else ("captured", "eager")):
            times[dtype].append(_time_train_step(
                step if v == "captured" else eager, _clone_state(state),
                on_card, v == "captured"))
    for dtype, runs in times.items():
        print(f"train step {dtype} in turns: {_turns_line(runs)}")
    memory = {c.runtime.compute_dtype: _step_memory(c, state_cpu, on_card)
              for c in (cfg, cfg_bf)}
    print(f"train step peak device memory above the state (MiB), eager: "
          f"{memory}")
    print(f"bf16 train step [{smi}]: " + json.dumps(
        {"turns": times, "memory": memory}))
    return times


def run_bf16_trainer(smi, root, out, n_clouds, f32_epoch0):
    """16.2: epoch 0 of a bfloat16 Trainer from ``PillarsDetector.init`` on
    phase 11's train clouds, with its bfloat16 eval; returns its results."""
    cfg = _train_cfg(root, out, n_clouds).override("runtime.compute_dtype",
                                                   "bfloat16")
    r = _trainer_epoch(cfg, 0)
    print(f"bf16 Trainer {_epoch_line(r, 0, n_clouds)}; the f32 Trainer's "
          f"epoch 0 in this call: last-50 mean {f32_epoch0['last50']:.4f}, "
          f"{f32_epoch0['seconds']:.2f} s, AP {f32_epoch0['ap']:.4f} [{smi}]")
    if not r["last50"] < LOSS_GATE:
        raise AssertionError(f"bf16 epoch 0: mean loss of the last 50 steps "
                             f"{r['last50']} not below {LOSS_GATE}")
    if not abs(r["last50"] - f32_epoch0["last50"]) <= BF16_LOSS_GAP:
        raise AssertionError(f"bf16 epoch 0: last-50 mean {r['last50']} "
                             f"against f32 {f32_epoch0['last50']}")
    print("bf16 trainer: " + json.dumps(
        {k: v for k, v in r.items() if k != "dirs"}))
    return r


# ----------------------------------------------------------------------
# phase 17: pillars_torch/parallel/ over process groups on the card

P17_CLOUDS = 5        # hard val clouds of the distributed Evaluator
P17_EVAL_BATCH = 2    # two batches split over two ranks, one on rank 0
DP_LOSS_RTOL = 1e-6   # tests/test_torch_parallel.py's criteria
DP_GRAD_TOL = 1e-5    # of each gradient leaf's max |value|
DP_STAT_TOL = 1e-6    # of each new BN statistic's max |value|
NCCL1_GRAD_TOL = 1e-6
SPATIAL_HEAD_TOL = 1e-5
SPATIAL_LOSS_RTOL = 1e-5
SPATIAL_GRAD_L2 = 1e-3


def _p17_cfgs(root, tmp, world):
    """(train config, distributed Evaluator config) of phase 17."""
    import pickle

    from pillars_torch.config import Config

    with open(f"{root}/kitti_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    val = os.path.join(tmp, "kitti_infos_val_p17.pkl")
    if not os.path.exists(val):
        with open(val, "wb") as f:
            pickle.dump(infos[:P17_CLOUDS], f, 2)
    ecfg = _with_split(_fast_config(), root)
    for key, value in (("eval_input.info_path", val),
                       ("eval_input.batch_size", P17_EVAL_BATCH),
                       ("eval_input.num_workers", 1),
                       ("runtime.num_devices", world)):
        ecfg = ecfg.override(key, value)
    return _with_split(Config.default(), root), ecfg


def _p17_times(det, state, opt, on_card, group):
    """Of the eager step (and whether ``make_train_step`` captured): host
    wall ms per train step and per flat gradient all-reduce (each
    over 5 calls, synchronized), launches and device ms per step
    (torch.profiler), and the collectives' own cost in 3 steps: before each
    ``torch.distributed`` collective the card is synchronized and the ranks
    of its group meet at a barrier, so the timed call excludes the wait for
    another rank; the barriers' time leaves the step's window too.
    ``overlaps`` counts collectives timed while another was in flight."""
    import torch.distributed as dist

    from pillars_torch.parallel.collectives import all_reduce_flat
    from pillars_torch.train.loop import make_train_step
    from pillars_torch.utils.profiling import device_busy

    made = make_train_step(det, opt)
    step = made.eager

    def wall(fn, n=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    grads = list(state.params.values())
    step_ms = wall(lambda: step(state, on_card))
    reduce_ms = wall(lambda: all_reduce_flat(grads, group))
    _, device_ms, rows, _ = device_busy(lambda: step(state, on_card), 3)
    spent = {"s": 0.0, "wait": 0.0, "calls": 0, "active": 0, "overlaps": 0}
    names = ("all_reduce", "all_gather", "broadcast")
    inner = {n: getattr(dist, n) for n in names}

    def timed(fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.barrier(group=kwargs.get("group"))
            t1 = time.perf_counter()
            spent["overlaps"] += spent["active"] > 0
            spent["active"] += 1
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            spent["active"] -= 1
            spent["wait"] += t1 - t0
            spent["s"] += time.perf_counter() - t1
            spent["calls"] += 1
            return out
        return call

    for n in names:
        setattr(dist, n, timed(inner[n]))
    try:
        step(state, on_card)
        torch.cuda.synchronize()
        spent.update(s=0.0, wait=0.0, calls=0, overlaps=0)
        t0 = time.perf_counter()
        for _ in range(3):
            step(state, on_card)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0 - spent["wait"]
    finally:
        for n in names:
            setattr(dist, n, inner[n])
    return {"step_ms": step_ms, "allreduce_ms": reduce_ms,
            "allreduce_mb": sum(g.numel() for g in grads) * 4 / 1e6,
            "launches_per_step": sum(c for _, c, _ in rows),
            "device_ms_per_step": device_ms,
            "collectives_per_step": spent["calls"] / 3,
            "collective_ms_per_step": spent["s"] * 1e3 / 3,
            "window_ms_per_step": window * 1e3 / 3,
            "wait_ms_per_step": spent["wait"] * 1e3 / 3,
            "overlaps": spent["overlaps"],
            "collective_share": spent["s"] / window,
            "captured": made is not step}


def _p17_rank(rank, device, spec_file):
    """One rank of phase 17 (a module-level function: the spawned children
    import this script). Writes its results to rank<r>.pt beside the
    spec."""
    import pickle

    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.parallel.mesh import Mesh, shard_batch
    from pillars_torch.train.loop import batch_to_device, forward_backward
    from pillars_torch.train.trainer import Evaluator
    from pillars_torch.weights import from_jax_variables, load_params

    # cuDNN's deterministic algorithms, as the reference in run_parallel:
    # the comparison then holds the port, not the order of atomic adds
    torch.backends.cudnn.deterministic = True
    with open(spec_file, "rb") as f:
        spec = pickle.load(f)
    world, batch = spec["world"], spec["batch"]
    cfg, ecfg = _p17_cfgs(spec["root"], os.path.dirname(spec_file), world)
    state_cpu = from_jax_variables(*load_params(str(WEIGHTS)), cfg)
    thr = cfg.train_input.anchor_area_threshold
    out = {}

    def cpu(d):
        return {k: v.detach().cpu() for k, v in d.items()}

    if "dp" in spec["parts"]:
        mesh = Mesh([("data", world)])
        det = PillarsDetector(cfg, device=device, mesh=mesh)
        state, opt = _train_state(det, state_cpu)
        local = batch_to_device(shard_batch(batch, mesh), device)
        fb = forward_backward(det, state, local, thr)
        out["dp"] = {"loss": [float(t) for t in fb.loss],
                     "grads": cpu(fb.grads), "stats": cpu(fb.batch_stats),
                     "num_positives": int(fb.num_positives),
                     **_p17_times(det, state, opt, local, mesh.group())}
    if "spatial" in spec["parts"]:
        mesh = Mesh([("spatial", world)])
        det = PillarsDetector(cfg.override("runtime.spatial_axis",
                                           "spatial"), device=device,
                              mesh=mesh)
        state, opt = _train_state(det, state_cpu)
        on_card = batch_to_device(batch, device)
        with torch.inference_mode():
            vox = det.voxelize_batch(on_card["points"],
                                     on_card["num_points"])
            heads = det.apply({**state.params, **state.batch_stats}, vox)
        fb = forward_backward(det, state, on_card, thr)
        out["spatial"] = {"heads": cpu(heads),
                          "loss": [float(t) for t in fb.loss],
                          "grads": cpu(fb.grads),
                          "num_positives": int(fb.num_positives),
                          **_p17_times(det, state, opt, on_card,
                                       mesh.group())}
    if "captured" in spec["parts"]:
        out["captured"] = _p17_captured(
            cfg, state_cpu, {name: spec["batches"] for name, _ in P17_MESHES},
            device)
    if "eval" in spec["parts"]:
        from pillars_torch.cuda_graph import CapturedInference

        det = PillarsDetector(ecfg, device=device)
        ev = Evaluator(ecfg, det)
        if not isinstance(ev.infer, CapturedInference):
            raise AssertionError("the distributed Evaluator does not replay "
                                 "graphs")
        state = det.state_to_device(state_cpu)
        _reset_counts()
        t0 = time.perf_counter()
        annos, _ = ev.run(state, progress=False)
        torch.cuda.synchronize()
        out["eval"] = {"annos": annos, "launches": _read_counts(),
                       "s": time.perf_counter() - t0,
                       "graphs": len(ev.infer.graphs)}
        t0 = time.perf_counter()  # again, every shape's graph captured
        out["eval"]["annos_replayed"], _ = ev.run(state, progress=False)
        torch.cuda.synchronize()
        out["eval"]["s_replayed"] = time.perf_counter() - t0
        ev.infer = ev.infer.eager  # the same run op by op, warm
        t0 = time.perf_counter()
        out["eval"]["annos_eager"], _ = ev.run(state, progress=False)
        torch.cuda.synchronize()
        out["eval"]["s_eager"] = time.perf_counter() - t0
    torch.save(out, os.path.join(os.path.dirname(spec_file),
                                 f"rank{rank}.pt"))


P17_MESHES = (("data", (("data", 1),)), ("spatial", (("spatial", 1),)),
              ("2d", (("data", 1), ("spatial", 1))))


def _digest(tensors):
    """sha256 of a dict of tensors' bytes, in key order."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _p17_captured(cfg, state_cpu, batches, device, meshes=P17_MESHES,
                  timed=True):
    """The mesh paths captured over the NCCL ranks of the process group (at
    one rank every axis group is the world, so every collective of the body
    runs, though NCCL runs no kernel for an in-place sum of one rank): for
    each (name, shape) of ``meshes``, under cuDNN's deterministic
    algorithms, the train step of ``make_train_step``, its first call and
    replays against the eager step from the same state, bit for bit, on the
    global batches ``batches[name]`` (this rank's block taken here), and
    the sha256 of the parameters after them; with ``timed``, a step
    captured under cuDNN's defaults and eager in turns (one graph launch
    per captured step, and over several ranks NCCL kernels inside it). Then
    a band on every rank: inference on the point-major path through
    ``make_inference_fn`` at B=1 and B=2 against its eager function (max
    |diff| 0), and with ``timed`` in turns at B=1."""
    import torch.distributed as dist

    from pillars_torch.cuda_graph import CapturedInference
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.parallel.mesh import Mesh, shard_batch
    from pillars_torch.train.loop import (CapturedTrainStep, batch_to_device,
                                          make_train_step)

    world, group = dist.get_world_size(), dist.group.WORLD
    out = {}
    for name, shape in meshes:
        t0 = time.perf_counter()
        label = f"NCCL-{world} {name} mesh"
        c = (cfg if name == "data"
             else cfg.override("runtime.spatial_axis", "spatial"))
        mesh = Mesh(list(shape))
        det = PillarsDetector(c, device=device, mesh=mesh)
        state, opt = _train_state(det, state_cpu)
        step = make_train_step(det, opt)
        if not isinstance(step, CapturedTrainStep):
            raise AssertionError(f"{label}: make_train_step did not capture")
        on_card = [batch_to_device(shard_batch(b, mesh), device)
                   for b in batches[name]]
        worst, bitwise, last = _replays_against_eager(
            label, step, _clone_state(state), on_card,
            float(opt.schedule(0)))
        if not bitwise:
            raise AssertionError(f"{label}: replays differ from eager steps:"
                                 f" {worst}")
        out[name] = {"steps": len(on_card),
                     "batch": len(batches[name][0]["points"]),
                     "params_sha": _digest(last.params)}
        if timed:
            # timed with cuDNN's default algorithms, as users train: a step
            # captured under them (a graph keeps the algorithms of its
            # capture)
            torch.backends.cudnn.deterministic = False
            try:
                timed_step = make_train_step(det, opt)
                turns = [_time_train_step(
                    timed_step if v == "captured" else timed_step.eager,
                    _clone_state(state), on_card[0], v == "captured",
                    iters=10, prof_iters=3, group=group)
                         for v in ("eager", "captured", "captured", "eager")]
            finally:
                torch.backends.cudnn.deterministic = True
            for t in turns:
                if t["variant"] != "captured":
                    continue
                if t["graph_launches_per_step"] != 1:
                    raise AssertionError(f"{label}: "
                                         f"{t['graph_launches_per_step']} "
                                         f"graph launches per captured step")
                if world > 1 and not t["nccl_kernels_per_step"] > 0:
                    raise AssertionError(f"{label}: no NCCL kernel in the "
                                         f"captured step's graph")
            out[name]["turns"] = turns
        out[name]["s"] = time.perf_counter() - t0

    icfg = (cfg.override("model.pfn.dense_cell", False)
            .override("runtime.spatial_axis", "spatial"))
    det = PillarsDetector(icfg, device=device,
                          mesh=Mesh([("spatial", world)]))
    state = det.state_to_device(state_cpu)
    per_call = {"nms_keep_mask": 1, "rpn_sep_block": 0,
                "rpn_sep_block_bf16": 0, "bn_relu": _bn_relu_per_call(det),
                "pfn_max": 1}
    infer = {"max_abs_diff": {}, "launches_per_replay": {}}
    t0 = time.perf_counter()
    for b in (1, 2):
        label = f"{world}-band spatial inference B={b}"
        pts, num = _clouds(icfg.model.voxel.max_points, b, 2)
        eye = torch.eye(4, device=device).expand(b, 4, 4).contiguous()
        inputs = [(torch.from_numpy(pts[i]).to(device),
                   torch.from_numpy(num).to(device), eye, eye)
                  for i in range(2)]
        fn, worst = _replay_path(label, det, state, inputs, per_call)
        if not isinstance(fn, CapturedInference):
            raise AssertionError(f"{label} over NCCL: make_inference_fn did "
                                 f"not capture")
        if worst != 0:
            raise AssertionError(f"{label}: replay against eager max |diff| "
                                 f"{worst}")
        _reset_counts()
        fn(state, *inputs[0])
        torch.cuda.synchronize()
        infer["launches_per_replay"][f"B{b}"] = _read_counts()
        infer["max_abs_diff"][f"B{b}"] = worst
        if b == 1 and timed:  # as the steps are, under cuDNN's defaults
            p, n = inputs[0][:2]
            torch.backends.cudnn.deterministic = False
            try:
                timed_fn = det.make_inference_fn()
                infer["turns"] = [
                    (v, _warm_ms(timed_fn if v == "captured"
                                 else timed_fn.eager, state, p, n, eye,
                                 f"{world}-band spatial {v}", group))
                    for v in ("eager", "captured", "eager", "captured")]
            finally:
                torch.backends.cudnn.deterministic = True
    infer["s"] = time.perf_counter() - t0
    out["spatial_inference"] = infer
    return out


def _p17_spawn(tmp, name, world, backend, spec, fn=None):
    """Runs ``fn`` (``_p17_rank``) in ``world`` ranks on the card over
    ``spec``; returns what each rank saved and the seconds."""
    import pickle

    from pillars_torch.parallel.launch import spawn

    d = os.path.join(tmp, name)
    os.makedirs(d)
    path = os.path.join(d, "spec.pkl")
    with open(path, "wb") as f:
        pickle.dump({**spec, "world": world}, f)
    t0 = time.perf_counter()
    spawn(fn or _p17_rank, world, args=(path,), device="cuda",
          backend=backend)
    seconds = time.perf_counter() - t0
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(world)], seconds


def _p17_loss_grads(got, fb, loss_rtol, grad_tol, label):
    """Loss parts within ``loss_rtol`` relative and each gradient leaf
    within ``grad_tol`` of its max against the plain card step ``fb``;
    returns (loss error, gradient error)."""
    if got["num_positives"] != int(fb.num_positives):
        raise AssertionError(f"{label}: num_positives {got['num_positives']}"
                             f" vs {int(fb.num_positives)}")
    loss_err = max(abs(g - float(w)) / max(abs(float(w)), 1e-6)
                   for g, w in zip(got["loss"], fb.loss))
    if loss_err > loss_rtol:
        raise AssertionError(f"{label}: loss parts {loss_err} relative")
    grad_err = max(_max_rel(got["grads"][k], g.cpu())
                   for k, g in fb.grads.items())
    if grad_err > grad_tol:
        raise AssertionError(f"{label}: gradients {grad_err} of their max")
    return loss_err, grad_err


def _p17_annos_close(got, want, label):
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} annos vs {len(want)}")
    n = 0
    for a, b in zip(got, want):
        if list(a["name"]) != list(b["name"]):
            raise AssertionError(f"{label}: names differ")
        np.testing.assert_allclose(a["score"], b["score"], rtol=1e-4,
                                   atol=1e-5, err_msg=label)
        np.testing.assert_allclose(a["location"], b["location"], rtol=1e-4,
                                   atol=1e-4, err_msg=label)
        n += len(a["name"])
    return n


def _p17_captured_lines(cap, smi, meshes=P17_MESHES, world=1):
    """Prints the captured mesh paths of rank 0 of ``world`` NCCL ranks;
    returns the kernels' launches on the captured spatial inference."""
    ranks = ("one NCCL rank" if world == 1
             else f"{world} NCCL ranks, one per card")
    for name, shape in meshes:
        m = cap[name]
        turns = m["turns"]
        line = "; ".join(
            f"{t['variant']} {t['ms_per_step']:.3f} ms (events) / "
            f"{t['host_wall_ms_per_step']:.3f} ms host wall, "
            f"{t['graph_launches_per_step']:g} graph and "
            f"{t['launches_per_step']:g} kernel launches, "
            f"{t['device_ms_per_step']:.3f} ms device, idle "
            f"{t['idle_share']:.3f}, NCCL kernels "
            f"{t['nccl_kernels_per_step']:g} and device-to-device copies "
            f"{t['dtod_copies_per_step']:g}" for t in turns)
        cap_t = [t for t in turns if t["variant"] == "captured"]
        print(f"captured mesh step, {ranks}, {name} mesh {dict(shape)}, "
              f"global B={m['batch']} full width from weights_59.pkl, cuDNN "
              f"deterministic: make_train_step gave a CapturedTrainStep; its "
              f"first call and {m['steps'] - 1} replays bit-equal to eager "
              f"steps from the same state (metrics, parameters, BN "
              f"statistics, Adam moments); rank 0 in turns with cuDNN's "
              f"default algorithms: {line}; capture {cap_t[0]['capture_s']} "
              f"s, graph pool {cap_t[-1]['pool_mib']:.1f} MiB; "
              f"{m['s']:.1f} s [{smi}]")
    inf = cap["spatial_inference"]
    ms = {v: [t["ms"] for w, t in inf["turns"] if w == v]
          for v in ("eager", "captured")}
    wall = {v: [t["host_wall_ms"] for w, t in inf["turns"] if w == v]
            for v in ("eager", "captured")}
    print(f"captured {world}-band spatial inference, {ranks}, point-major "
          f"from weights_59.pkl: make_inference_fn gave a CapturedInference; "
          f"B=1 and B=2 replays against eager valid/labels equal, max |diff|"
          f" {inf['max_abs_diff']}; heads likewise; launches per replay "
          f"{inf['launches_per_replay']}; rank 0 at B=1 in turns with "
          f"cuDNN's default algorithms, ms/cloud (events) eager "
          f"{ms['eager']}, captured {ms['captured']}; host wall eager "
          f"{wall['eager']}, captured {wall['captured']}; {inf['s']:.1f} s "
          f"[{smi}]")
    return {f"parallel_spatial_nccl{world}": {
        k: sum(c[k] for c in inf["launches_per_replay"].values())
        for k in ("nms_keep_mask", "rpn_sep_block", "rpn_sep_block_bf16",
                  "bn_relu")}}


def _p17_line(t):
    return (f"{t['step_ms']:.3f} ms per step (host wall, synchronized), "
            f"{t['launches_per_step']:g} launches and "
            f"{t['device_ms_per_step']:.3f} ms of device time per step; the "
            f"flat gradient all-reduce ({t['allreduce_mb']:.2f} MB) "
            f"{t['allreduce_ms']:.3f} ms, "
            f"{t['allreduce_ms'] / t['step_ms']:.3f} of the step; "
            f"{t['collectives_per_step']:g} collectives per step, their own "
            f"{t['collective_ms_per_step']:.3f} ms of a "
            f"{t['window_ms_per_step']:.3f} ms step timed with them "
            f"({t['collective_share']:.3f}; {t['wait_ms_per_step']:.3f} ms "
            f"per step waiting for the other ranks left out; "
            f"{t['overlaps']} timed while another was in flight)")


def run_parallel(state_cpu, smi, root):
    """Phase 17 with cuDNN's deterministic algorithms (in the ranks too);
    returns the kernels' launches by path."""
    t17 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return _run_parallel(state_cpu, smi, root, t17)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _run_parallel(state_cpu, smi, root, t17):
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.loop import batch_to_device, forward_backward
    from pillars_torch.train.trainer import Evaluator

    tmp = tempfile.mkdtemp(prefix="p17_", dir=root)
    cfg, ecfg = _p17_cfgs(root, tmp, 1)
    thr = cfg.train_input.anchor_area_threshold
    batches = _train_batches(cfg, 3)
    batch = batches[0]
    spec = {"root": root, "batch": batch, "batches": batches}
    # the plain single-rank references on the card
    det = PillarsDetector(cfg)
    state, _ = _train_state(det, state_cpu)
    on_card = batch_to_device(batch, det.device)
    fb = forward_backward(det, state, on_card, thr)
    again = forward_backward(det, state, on_card, thr)
    noise = max(_max_rel(again.grads[k], g.cpu()) for k, g in fb.grads.items())
    print(f"parallel: the plain card step against itself, gradients "
          f"{noise:.3e} of their max")
    with torch.inference_mode():
        vox = det.voxelize_batch(on_card["points"], on_card["num_points"])
        heads = det.apply({**state.params, **state.batch_stats}, vox)
    edet = PillarsDetector(ecfg)
    single, _ = Evaluator(ecfg, edet).run(edet.state_to_device(state_cpu),
                                          progress=False)

    (r,), s1 = _p17_spawn(tmp, "nccl1", 1, "nccl",
                          {**spec, "parts": ["dp", "captured"]})
    errs = _p17_loss_grads(r["dp"], fb, DP_LOSS_RTOL, NCCL1_GRAD_TOL,
                           "NCCL world 1")
    if not r["dp"]["captured"]:
        raise AssertionError("NCCL world 1: make_train_step did not capture")
    print(f"parallel, one NCCL rank (world size 1), B=2 full width from "
          f"weights_59.pkl: loss parts {errs[0]:.3e} relative (tol "
          f"{DP_LOSS_RTOL}), gradients {errs[1]:.3e} of their max (tol "
          f"{NCCL1_GRAD_TOL}) against the plain card step; the eager step: "
          f"{_p17_line(r['dp'])}; {s1:.1f} s with the rank's start [{smi}]")
    launches = _p17_captured_lines(r["captured"], smi)

    ranks, s2 = _p17_spawn(tmp, "gloo2", 2, "gloo",
                           {**spec, "parts": ["dp", "spatial", "eval"]})
    for i, r in enumerate(ranks):
        if r["dp"]["captured"] or r["spatial"]["captured"]:
            raise AssertionError(f"gloo rank {i}: make_train_step captured a "
                                 f"body with gloo collectives")
        errs = _p17_loss_grads(r["dp"], fb, DP_LOSS_RTOL, DP_GRAD_TOL,
                               f"data-parallel rank {i}")
        stat_err = max(_max_rel(r["dp"]["stats"][k], v.cpu())
                       for k, v in fb.batch_stats.items()
                       if v.is_floating_point())
        if stat_err > DP_STAT_TOL:
            raise AssertionError(f"data-parallel rank {i}: new BN statistics "
                                 f"{stat_err} of their max")
        print(f"parallel, two gloo ranks sharing one card, data-parallel "
              f"B=2 (one cloud per rank), rank {i}: loss parts "
              f"{errs[0]:.3e} relative (tol {DP_LOSS_RTOL}), gradients "
              f"{errs[1]:.3e} (tol {DP_GRAD_TOL}), new BN statistics "
              f"{stat_err:.3e} (tol {DP_STAT_TOL}) of their max against the "
              f"single-rank card step; {_p17_line(r['dp'])}")
        sp = r["spatial"]
        head_err = max(_max_rel(sp["heads"][k], v.cpu())
                       for k, v in heads.items())
        if head_err > SPATIAL_HEAD_TOL:
            raise AssertionError(f"2 bands, rank {i}: heads {head_err}")
        loss_err, _ = _p17_loss_grads(sp, fb, SPATIAL_LOSS_RTOL, np.inf,
                                      f"2 bands, rank {i}")
        l2 = max(float((sp["grads"][k].double() - g.cpu().double()).norm()
                       / max(float(g.double().norm()), 1e-12))
                 for k, g in fb.grads.items())
        if l2 > SPATIAL_GRAD_L2:
            raise AssertionError(f"2 bands, rank {i}: gradients {l2}")
        print(f"parallel, two gloo ranks sharing one card, 2 bands of 64 "
              f"rows, rank {i}: heads {head_err:.3e} of their max (tol "
              f"{SPATIAL_HEAD_TOL}), train step loss parts {loss_err:.3e} "
              f"relative (tol {SPATIAL_LOSS_RTOL}), gradients' relative L2 "
              f"{l2:.3e} (tol {SPATIAL_GRAD_L2}) against the single-rank "
              f"card run; {_p17_line(sp)}")
    n_batches = -(-P17_CLOUDS // P17_EVAL_BATCH)
    split = P17_CLOUDS // P17_EVAL_BATCH  # full batches, split
    for i, r in enumerate(ranks):
        n_det = _p17_annos_close(r["eval"]["annos"], single,
                                 f"distributed Evaluator rank {i}")
        _p17_annos_close(r["eval"]["annos_replayed"], single,
                         f"distributed Evaluator rank {i}, replayed")
        _p17_annos_close(r["eval"]["annos_eager"], single,
                         f"distributed Evaluator rank {i}, eager")
        want = split + (n_batches - split if i == 0 else 0)
        got = r["eval"]["launches"]
        if (got["nms_keep_mask"] != want or got["rpn_sep_block"] != want
                or got["rpn_sep_block_bf16"]):
            raise AssertionError(f"distributed Evaluator rank {i}: launches "
                                 f"{got}, {want} batches ran there")
        launches[f"parallel_eval_rank{i}"] = got
        print(f"parallel, distributed Evaluator on the fast config, two gloo "
              f"ranks sharing one card, rank {i}: {P17_CLOUDS} hard val "
              f"clouds at batch {P17_EVAL_BATCH} ({split} batches split, the "
              f"remainder on rank 0), {n_det} detections equal to the "
              f"single-rank card Evaluator's; kernel launches {got} for the "
              f"{want} batches this rank ran, replayed from "
              f"{r['eval']['graphs']} captured graph(s) (the first call at a "
              f"shape runs eagerly); {r['eval']['s']:.2f} s for the first "
              f"run (its captures included), {r['eval']['s_replayed']:.2f} s "
              f"for it again replayed, {r['eval']['s_eager']:.2f} s for the "
              f"same run eagerly after them [{smi}]")
    print(f"phase 17 (parallel): {time.perf_counter() - t17:.1f} s, the "
          f"two-rank spawn {s2:.1f} s [{smi}]")
    shutil.rmtree(tmp, ignore_errors=True)
    return launches



# --------------------------------------------------------------------------
# phase 21 (``--ranks N``, N cards): the captured mesh paths over N NCCL
# ranks, one per card

P21_TRAIN_CLOUDS = 16  # train clouds per rank: 8 steps of 2 per rank
P21_EVAL_CLOUDS = 18   # eval batches of one cloud per rank, a remainder


def _p21_meshes(world):
    """Every rank on the data axis, every rank a band, and 2 x world/2 (at
    an odd world 1 x world)."""
    d = 2 if world % 2 == 0 else 1
    return (("data", (("data", world),)), ("spatial", (("spatial", world),)),
            ("2d", (("data", d), ("spatial", world // d))))


def _p21_cfg(root, world):
    """The Trainer's config of phase 21: ``P21_TRAIN_CLOUDS`` train clouds
    per rank at two per rank and step, its Evaluator over the first
    ``P21_EVAL_CLOUDS`` val clouds at one per rank and batch."""
    import pickle

    with open(f"{root}/kitti_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    val = os.path.join(root, "kitti_infos_val_p21.pkl")
    with open(val, "wb") as f:
        pickle.dump(infos[:P21_EVAL_CLOUDS], f, 2)
    cfg = _train_cfg(root, os.path.join(root, "runs_p21"),
                     P21_TRAIN_CLOUDS * world)
    for key, value in (("train_input.batch_size", 2 * world),
                       ("runtime.num_devices", world),
                       ("eval_input.info_path", val),
                       ("eval_input.batch_size", world)):
        cfg = cfg.override(key, value)
    return cfg


def _p21_trainer(cfg, state_cpu, device):
    """One epoch of a ``Trainer`` over the NCCL ranks from ``state_cpu``
    with its eval: the captured step (checked) between the Trainer's eager
    collectives, and
    the distributed ``Evaluator`` replaying its per-rank graphs (checked)
    between its eager gathers and broadcasts. Returns the losses, the
    epoch's and the eval's seconds, this rank's NMS launches in the eval,
    the sha256 of the variables after the epoch, and on rank 0 the
    variables and the results directory."""
    from pillars_torch.cuda_graph import CapturedInference
    from pillars_torch.train.loop import CapturedTrainStep
    from pillars_torch.train.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    trainer.state, _ = _train_state(trainer.detector, state_cpu)
    inner_step, inner_eval = trainer.step_fn, trainer.evaluator.evaluate
    if not isinstance(inner_step, CapturedTrainStep):
        raise AssertionError("the NCCL Trainer's step is not captured")
    if not isinstance(trainer.evaluator.infer, CapturedInference):
        raise AssertionError("the NCCL Trainer's Evaluator does not replay "
                             "graphs")
    losses, evals = [], []

    def step_fn(state, batch):
        state, metrics = inner_step(state, batch)
        losses.append(metrics.loss)
        return state, metrics

    def evaluate(*args, **kwargs):
        _reset_counts()
        t0 = time.perf_counter()
        out = inner_eval(*args, **kwargs)
        torch.cuda.synchronize()
        evals.append((_read_counts(), time.perf_counter() - t0, out[4]))
        return out

    trainer.step_fn, trainer.evaluator.evaluate = step_fn, evaluate
    t0 = time.perf_counter()
    trainer.train(epochs=1)
    torch.cuda.synchronize()
    (launches, eval_s, score), = evals
    variables = {k: v.detach().cpu() for k, v in trainer.variables().items()}
    return {"losses": [float(t) for t in losses],
            "seconds": time.perf_counter() - t0 - eval_s,
            "eval_s": eval_s, "launches": launches, "score": score,
            "graphs": len(inner_step.graphs),
            "variables_sha": _digest(variables),
            **({"variables": variables, "results": trainer.dirs["results"]}
               if trainer.is_main else {})}


def _p21_rank(rank, device, spec_file):
    """One of phase 21's NCCL ranks (module level: the spawned children
    import this script); rank 0 alone prints."""
    import pickle

    from pillars_torch.config import Config
    from pillars_torch.weights import from_jax_variables, load_params

    if rank:
        sys.stdout = open(os.devnull, "w")
    torch.backends.cudnn.deterministic = True
    with open(spec_file, "rb") as f:
        spec = pickle.load(f)
    cfg = _with_split(Config.default(), spec["root"])
    state_cpu = from_jax_variables(*load_params(str(WEIGHTS)), cfg)
    out = {"captured": _p17_captured(cfg, state_cpu, spec["batches"], device,
                                     _p21_meshes(spec["world"]))}
    torch.backends.cudnn.deterministic = False  # as users train
    out["trainer"] = _p21_trainer(spec["tcfg"], state_cpu, device)
    torch.save(out, os.path.join(os.path.dirname(spec_file),
                                 f"rank{rank}.pt"))


def run_mesh_ranks(world, smi):
    """Phase 21 over ``world`` NCCL ranks, one per card: the captured mesh
    paths of ``_p17_captured`` over the meshes of ``_p21_meshes`` (two
    clouds per data rank), their parameters equal on every rank, and a
    ``Trainer`` epoch with its distributed ``Evaluator``, whose detections
    must equal a single-rank card ``Evaluator``'s on the same variables."""
    import pickle

    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.trainer import Evaluator

    t21 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="hard_data_")
    try:
        make_hard_split(root)
        cfg = _with_split(Config.default(), root)
        meshes = _p21_meshes(world)
        batches = {name: _train_batches(cfg, 3, 2 * dict(shape).get("data", 1))
                   for name, shape in meshes}
        tcfg = _p21_cfg(root, world)
        ranks, seconds = _p17_spawn(
            root, "nccl", world, "nccl",
            {"root": root, "batches": batches, "tcfg": tcfg}, _p21_rank)
        print(f"phase 21: {world} NCCL ranks spawned and run in "
              f"{seconds:.1f} s [{smi}]")
        for name, _ in meshes:
            shas = {r["captured"][name]["params_sha"] for r in ranks}
            if len(shas) != 1:
                raise AssertionError(f"{name} mesh: the ranks' parameters "
                                     f"differ after the captured steps")
        _p17_captured_lines(ranks[0]["captured"], smi, meshes, world)

        tr = [r["trainer"] for r in ranks]
        steps = P21_TRAIN_CLOUDS // 2
        for i, t in enumerate(tr):
            if len(t["losses"]) != steps or not np.isfinite(t["losses"]).all():
                raise AssertionError(f"Trainer rank {i}: losses {t['losses']}")
            if t["graphs"] != 1:
                raise AssertionError(f"Trainer rank {i}: {t['graphs']} "
                                     f"captured step graphs")
        if len({t["variables_sha"] for t in tr}) != 1:
            raise AssertionError("the Trainer's variables differ between "
                                 "the ranks after the epoch")
        split = P21_EVAL_CLOUDS // world
        rest = -(-(P21_EVAL_CLOUDS - split * world) // world)
        for i, t in enumerate(tr):
            want = split + (rest if i == 0 else 0)
            if (t["launches"]["nms_keep_mask"] != want
                    or t["launches"]["rpn_sep_block"]):
                raise AssertionError(f"Trainer eval rank {i}: launches "
                                     f"{t['launches']}, {want} batches ran "
                                     f"there")
        with open(os.path.join(tr[0]["results"], "result_0.pkl"), "rb") as f:
            annos = pickle.load(f)
        ecfg = tcfg.override("runtime.num_devices", 1)
        det = PillarsDetector(ecfg)
        single, _ = Evaluator(ecfg, det).run(
            det.state_to_device(tr[0]["variables"]), progress=False)
        n_det = _p17_annos_close(annos, single, "the NCCL Trainer's eval")
        if not n_det:
            raise AssertionError("the NCCL Trainer's eval: no detection to "
                                 "compare")
        print(f"Trainer over {world} NCCL ranks, one per card, from "
              f"weights_59.pkl: epoch 0 on {P21_TRAIN_CLOUDS * world} "
              f"hard train clouds, {steps} captured steps of global B="
              f"{2 * world} in {tr[0]['seconds']:.2f} s on rank 0 "
              f"({steps * 2 * world / tr[0]['seconds']:.1f} clouds/s, the "
              f"first call and capture included), loss first "
              f"{tr[0]['losses'][0]:.4f} last {tr[0]['losses'][-1]:.4f}; "
              f"variables equal on every rank after it; its distributed "
              f"Evaluator over {P21_EVAL_CLOUDS} val clouds at one cloud per "
              f"rank ({split} batches split, the remainder on rank 0) in "
              f"{tr[0]['eval_s']:.2f} s, NMS launches per rank "
              f"{[t['launches']['nms_keep_mask'] for t in tr]} = the batches "
              f"each ran, score {tr[0]['score']:.4f}, {n_det} detections "
              f"equal to a single-rank card Evaluator's on the same "
              f"variables [{smi}]")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"phase 21 ({world} NCCL ranks): {time.perf_counter() - t21:.1f} s "
          f"[{smi}]")

# --------------------------------------------------------------------------
# phase 18: the captured inference (pillars_torch/cuda_graph.py)
# replay against eager on the card: the same kernels in the same order, so
# bit-equality is expected; 1e-6 of each tensor's max |value|
CAPTURE_RTOL = 1e-6


def _replay_close(got, want, label):
    """Every field of two NamedTuples of tensors: integer and bool fields
    equal, float fields within ``CAPTURE_RTOL`` of the eager field's max
    |value|; returns the largest |difference|."""
    worst = 0.0
    for name, g, w in zip(want._fields, got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label} {name}: {tuple(g.shape)} "
                                 f"{g.dtype} against {tuple(w.shape)} "
                                 f"{w.dtype}")
        if not w.is_floating_point():
            if not torch.equal(g, w):
                raise AssertionError(f"{label} {name}: replay differs from "
                                     f"eager")
            continue
        g, w = g.float(), w.float()
        err = (g - w).abs().max().item()
        worst = max(worst, err)
        if not err <= CAPTURE_RTOL * w.abs().max().item():
            raise AssertionError(f"{label} {name}: replay against eager "
                                 f"max |diff| {err}")
    return worst


def _captured_heads(det, thr):
    """(captured, eager) head-tensor functions of ``det``'s inference
    path, ``fn(state, points, num_valid, rect, trv2c)`` -> a NamedTuple of
    the heads, the captured one reading the detector's static state."""
    import collections
    import functools

    from pillars_torch.cuda_graph import CapturedInference

    fields = []

    def body(state, points, num_valid, rect, trv2c, folded=None):
        if det.dense_cell:
            heads = det._forward_dense(state, points, num_valid, thr)[0]
        else:
            v = det.voxelize_batch(points, num_valid)
            heads = (det._forward_fast(state, v, folded) if det.fast
                     else det.apply(state, v))
        if not fields:
            fields.append(collections.namedtuple("Heads", sorted(heads)))
        return fields[0](*(heads[k] for k in fields[0]._fields))

    def eager(state, points, num_valid, rect, trv2c):
        with torch.inference_mode():
            return body(state, points, num_valid, rect, trv2c)

    captured = CapturedInference(
        functools.partial(body, folded=det.graph_state), eager,
        det.graph_state, det.device, lambda *t: fields[0](*t))
    return captured, eager


def _replay_path(label, det, state, inputs, launches_per_call):
    """Captured against eager at one input shape: the predictions (the
    first call, which captures, and replays), the heads, the launch counts
    of replays and the outputs of call n after call n+1. ``inputs`` holds
    two batches of one shape. Returns the largest |difference|."""
    fn = det.make_inference_fn()
    thr = det.config.eval_input.anchor_area_threshold
    heads, heads_eager = _captured_heads(det, thr)
    a, b = inputs
    first = fn(state, *a)
    want = fn.eager(state, *a)
    worst = _replay_close(first, want, f"{label} first call")
    _reset_counts()
    got = [fn(state, *a) for _ in range(3)]
    torch.cuda.synchronize()
    counts = _read_counts()
    expect = {k: 3 * v for k, v in launches_per_call.items()}
    if counts != expect:
        raise AssertionError(f"{label}: 3 replays counted {counts}, "
                             f"expected {expect}")
    for g in got:
        worst = max(worst, _replay_close(g, want, f"{label} replay"))
    heads(state, *a)
    worst = max(worst, _replay_close(heads(state, *a),
                                     heads_eager(state, *a),
                                     f"{label} heads"))
    # call n's predictions after call n+1 on another batch
    kept = type(got[0])(*(t.clone() for t in got[0]))
    after = fn(state, *b)
    torch.cuda.synchronize()
    _replay_close(got[0], kept, f"{label} call n after call n+1")
    worst = max(worst, _replay_close(after, fn.eager(state, *b),
                                     f"{label} second batch"))
    if not want.valid.any():
        raise AssertionError(f"{label}: no valid detection to compare")
    return fn, worst


def _state_swap(label, fn, state, inputs):
    """The captured function against eager as the state changes: a new
    dict of new tensors, its tensors scaled in place by 1.01, a dict of
    inference tensors (also written in place), then ``state`` again.
    Returns the copies into the static state over these calls."""
    copies = fn.state.copies
    base = fn(state, *inputs)
    _replay_close(base, fn.eager(state, *inputs), f"{label}: first state")
    other = {k: v.clone() for k, v in state.items()}
    _replay_close(fn(other, *inputs), fn.eager(other, *inputs),
                  f"{label}: a new dict")
    with torch.no_grad():
        for t in other.values():
            if t.is_floating_point():
                t.mul_(1.01)
    scaled = fn(other, *inputs)
    _replay_close(scaled, fn.eager(other, *inputs),
                  f"{label}: scaled in place")
    if torch.equal(scaled.scores, base.scores):
        raise AssertionError(f"{label}: scaling the state by 1.01 left the "
                             f"scores as they were")
    with torch.inference_mode():
        frozen = {k: v.clone() for k, v in state.items()}
        _replay_close(fn(frozen, *inputs), fn.eager(frozen, *inputs),
                      f"{label}: inference tensors")
        for t in frozen.values():
            if t.is_floating_point():
                t.mul_(1.01)
        _replay_close(fn(frozen, *inputs), fn.eager(frozen, *inputs),
                      f"{label}: inference tensors written in place")
    _replay_close(fn(state, *inputs), base, f"{label}: the first state again")
    return fn.state.copies - copies


def run_captured(state_cpu, smi):
    """Phase 18; returns its numbers."""
    from pillars_torch.config import Config
    from pillars_torch.cuda_graph import CapturedInference, pool_mib
    from pillars_torch.infer import BucketedInference
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.utils.profiling import device_busy
    from pillars_torch.utils.roofline import roofline_report
    from pillars_torch.weights import from_jax_variables, load_params

    t18 = time.perf_counter()
    bf16 = lambda c: c.override("runtime.compute_dtype", "bfloat16")  # noqa: E731
    paths = (("dense", Config.default()), ("fast", _fast_config()),
             ("dense_bf16", bf16(Config.default())),
             ("fast_bf16", bf16(_fast_config())))
    result, fns = {"max_abs_diff": {}}, {}
    for name, cfg in paths:
        det = PillarsDetector(cfg)
        state = det.state_to_device(state_cpu)
        per_call = {"nms_keep_mask": 1,
                    "rpn_sep_block": int(det.fast),
                    "rpn_sep_block_bf16": int(det.fast and name.endswith(
                        "bf16")),
                    "bn_relu": _bn_relu_per_call(det),
                    "pfn_max": int(det.dtype is None)}
        for b in (1, 2):
            pts, num = _clouds(cfg.model.voxel.max_points, b, 2)
            eye = torch.eye(4).expand(b, 4, 4).contiguous().cuda()
            inputs = [(torch.from_numpy(pts[c]).cuda(),
                       torch.from_numpy(num).cuda(), eye, eye)
                      for c in range(2)]
            fn, worst = _replay_path(f"{name} B={b}", det, state, inputs,
                                     per_call)
            result["max_abs_diff"][f"{name}_B{b}"] = worst
            if not isinstance(fn, CapturedInference):
                raise AssertionError(f"{name}: make_inference_fn did not "
                                     f"capture on the card")
            if b == 1:
                fns[name] = (det, fn, state, inputs[0])
        print(f"captured {name}: replay against eager at B=1 and B=2, "
              f"valid/labels equal, max |diff| "
              f"{max(result['max_abs_diff'][f'{name}_B{b}'] for b in (1, 2)):.3e}"
              f" (tol {CAPTURE_RTOL} of each tensor's max); heads likewise; "
              f"launch counts of replays = calls; call n's predictions "
              f"unchanged after call n+1")

    for name in ("dense", "fast"):
        _, fn, state, inputs = fns[name]
        copies = _state_swap(f"captured {name} state swap", fn, state,
                             inputs)
        print(f"captured {name} state swap: a new dict, in-place x1.01, "
              f"inference tensors (copied on every call) and back, each "
              f"equal to eager; {copies} copies into the static state")

    cfg = Config.default()
    bi = BucketedInference(cfg)
    state = bi.state_to_device(state_cpu)
    bi.warmup(state)
    eye = torch.eye(4)[None].cuda()
    for n, rung in ((3000, 9984), (19200, 19968)):
        pts, num = _padded(_scenes(1, n, seed=n), rung)
        fn = bi._fn(rung)
        if len(fn.graphs) != 1:
            raise AssertionError(f"rung {rung}: warmup captured "
                                 f"{len(fn.graphs)} graphs")
        worst = _replay_close(fn(state, pts, num, eye, eye),
                              fn.eager(state, pts, num, eye, eye),
                              f"rung {rung}")
        result["max_abs_diff"][f"rung_{rung}"] = worst
        print(f"captured ladder rung {rung} ({n} points, "
              f"{'dense cell' if bi._dets[rung].dense_cell else 'point-major'}"
              f"): replay against eager max |diff| {worst:.3e}")

    scfg = Config.from_yaml(str(CONFIGS / "second_sparse_d435i.yaml"))
    det = PillarsDetector(scfg)
    state = det.state_to_device(
        from_jax_variables(*load_params(str(SECOND_WEIGHTS)), scfg))
    pts, num = _padded(_scenes(2, 19200, seed=5),
                       scfg.model.voxel.max_points)
    inputs = [(torch.from_numpy(pts[i:i + 1]).cuda(),
               torch.from_numpy(num[i:i + 1]).cuda(), eye, eye)
              for i in range(2)]
    _, worst = _replay_path("second_sparse B=1", det, state, inputs,
                            {"nms_keep_mask": 1, "rpn_sep_block": 0,
                             "rpn_sep_block_bf16": 0,
                             "bn_relu": _bn_relu_per_call(det),
                             "pfn_max": 0})
    result["max_abs_diff"]["second_sparse_B1"] = worst
    print(f"captured second_sparse_d435i B=1: replay against eager max "
          f"|diff| {worst:.3e}, heads likewise")

    # times in turns: eager, captured, eager, captured
    result["times"] = {}
    for name in ("dense", "fast"):
        det, fn, state, (p, n, eye, _) = fns[name]
        turns = []
        for variant in ("eager", "captured", "eager", "captured"):
            call = fn.eager if variant == "eager" else fn
            turns.append((variant, _warm_ms(call, state, p, n, eye,
                                            f"{name} {variant}")))
        counts = []
        for call in (fn.eager, fn):
            rows = device_busy(lambda: call(state, p, n, eye, eye), 10)[2]
            counts.append({k: c for k, c, _ in rows})
        moved = {k[:60]: [c.get(k, 0) for c in counts]
                 for k in set(counts[0]) | set(counts[1])
                 if counts[0].get(k, 0) != counts[1].get(k, 0)}
        print(f"{name} B=1: kernels (and copies) per cloud that differ, "
              f"eager against captured: {moved}")
        cfg = det.config
        roof = roofline_report(cfg, turns[1][1]["device_ms"], 1)
        seconds = {str(k[0]): g.seconds for k, g in fn.graphs.items()}
        result["times"][name] = {
            "turns": turns, "capture_s": seconds,
            "bound_ms": roof["bound_ms"], "bound_by": roof["bound_by"],
            "flops": roof["flops"], "bytes": roof["bytes"]}
        eager_ms = [t["ms"] for v, t in turns if v == "eager"]
        graph_ms = [t["ms"] for v, t in turns if v == "captured"]
        print(f"{name} B=1 in turns: eager {eager_ms} against captured "
              f"{graph_ms} ms/cloud (CUDA events); capture s per shape "
              f"{seconds}; analytic bound of the whole path "
              f"{roof['bound_ms']:.4f} ms ({roof['bound_by']}: "
              f"{roof['flops']:.4g} FLOP, {roof['bytes']:.4g} B, "
              f"utils/roofline.py) [{smi}]")
    # the full collection that cuda_graph._capture_graph runs before each
    # capture, timed on this process's heap (the capture seconds above
    # include it)
    collect_s = []
    for _ in range(3):
        t = time.perf_counter()
        gc.collect()
        collect_s.append(time.perf_counter() - t)
    result["gc_collect_s"] = collect_s
    print(f"captured: the collection before each capture takes {collect_s} s "
          f"on this heap ({len(gc.get_objects())} objects tracked)")
    result["pool_mib"] = pool_mib()
    print(f"phase 18 (captured inference): graph pool {result['pool_mib']:.1f}"
          f" MiB; {time.perf_counter() - t18:.1f} s [{smi}]")
    print("captured: " + json.dumps(result))
    return result


# --------------------------------------------------------------------------
# phase 19: the captured train and recalibration steps (train/loop.py
# CapturedTrainStep, train/bn_recal.py CapturedRecal) and the repairs


def _voxelizer_range(smi):
    """19.1: an extra feature of 1e7 and one NaN / infinite feature through
    both voxelizers, the card against the CPU: integers equal, NaN and
    infinities where the CPU has them, means within ``MEAN_ATOL`` of the
    CPU's (relative to their scale for the feature)."""
    from pillars_torch.config import Config
    from pillars_torch.ops.voxelize import (make_cell_voxelizer,
                                            make_point_voxelizer)

    vcfg = Config.default().model.voxel
    pts, num = _clouds(vcfg.max_points, 2, 1)
    pts = np.concatenate([pts[0], np.zeros(pts.shape[1:3] + (1,),
                                           np.float32)], -1)
    r = np.random.RandomState(19)
    pts[..., :num[0], 3] = r.uniform(-1e7, 1e7, (2, num[0]))
    bad = pts.copy()
    bad[0, 7, 3], bad[1, 11, 3], bad[1, 12, 3] = np.nan, np.inf, -np.inf
    worst = {}
    for name, fn in (("cells", make_cell_voxelizer(vcfg)),
                     ("points", make_point_voxelizer(vcfg))):
        for label, cloud in (("1e7", pts), ("non-finite", bad)):
            args = (torch.from_numpy(cloud), torch.from_numpy(num))
            want = fn(*args)
            got = fn(*(a.cuda() for a in args))
            err = 0.0
            for field, g, w in zip(want._fields, got, want):
                g = g.cpu()
                if not w.is_floating_point():
                    if not torch.equal(g, w):
                        raise AssertionError(f"voxelize_{name} {label} "
                                             f"{field}: card against CPU")
                    continue
                for check in (torch.isnan, torch.isinf):
                    if not torch.equal(check(g), check(w)):
                        raise AssertionError(
                            f"voxelize_{name} {label} {field}: "
                            f"{check.__name__} differs from the CPU")
                fin = torch.isfinite(w)
                scale = torch.ones_like(w)
                if w.shape[-1] == 4:  # the 1e7 feature's column
                    scale[..., 3] = 1e7
                diff = ((g - w).abs() / scale)[fin]
                err = max(err, float(diff.max()) if diff.numel() else 0.0)
            if not err <= MEAN_ATOL:
                raise AssertionError(f"voxelize_{name} {label}: means card "
                                     f"against CPU {err} of their scale")
            nan = int(torch.isnan(want[-1]).sum()) if name == "points" else 0
            worst[f"{name}_{label}"] = err
            print(f"voxelize_{name} with an extra feature of 1e7 ({label}): "
                  f"card against CPU, integers equal, NaN/inf positions "
                  f"equal ({nan} NaN pillar means), means within {err:.3e} "
                  f"of their scale (tol {MEAN_ATOL}) [{smi}]")
    return worst


def _fixed_scale_sums(vals, seg, n):
    """The voxelizers' earlier segment sums, for timing only: a
    fixed 2^-40 unit (which wraps beyond |value| * n = 2^23) and no
    non-finite sum."""
    sums = torch.zeros(vals.shape, dtype=torch.int64, device=vals.device)
    sums.index_add_(0, seg, (vals * float(2 ** 40)).to(torch.int64))
    return sums[seg].to(vals.dtype) * (1.0 / 2 ** 40)


def _voxelizer_cost(smi):
    """19.2: both voxelizers captured at the main paths' shapes (19200
    points, B=1 and 2), device ms with the adaptive fixed point against
    the earlier fixed one, in turns (new, fixed, fixed, new)."""
    from pillars_torch.config import Config
    from pillars_torch.ops import voxelize as vox
    from pillars_torch.utils.profiling import captured_ms

    vcfg = Config.default().model.voxel
    adaptive = vox._segment_sums
    out = {}
    for b in (1, 2):
        pts, num = _clouds(vcfg.max_points, b, 1)
        p, n = torch.from_numpy(pts[0]).cuda(), torch.from_numpy(num).cuda()
        for name, make in (("cells", vox.make_cell_voxelizer),
                           ("points", vox.make_point_voxelizer)):
            fn = make(vcfg)
            turns = []
            for sums in (adaptive, _fixed_scale_sums, _fixed_scale_sums,
                         adaptive):
                vox._segment_sums = sums
                try:
                    turns.append(captured_ms(lambda: fn(p, n), 50))
                finally:
                    vox._segment_sums = adaptive
            out[f"{name}_B{b}"] = {"adaptive": [turns[0], turns[3]],
                                   "fixed": [turns[1], turns[2]]}
            print(f"voxelize_{name} B={b}, captured, device ms per call in "
                  f"turns: adaptive fixed point {turns[0]:.4f}, "
                  f"{turns[3]:.4f}; the fixed 2^-40 unit {turns[1]:.4f}, "
                  f"{turns[2]:.4f} [{smi}]")
    return out


def _nondeterministic_ops(caught):
    """The op names of PyTorch's 'does not have a deterministic
    implementation' warnings."""
    names = set()
    for w in caught:
        text = str(w.message)
        if "deterministic" in text:
            names.add(text.split(" does not have")[0].split(" ")[-1])
    return sorted(names)


def _replays_against_eager(label, step, state, batches, lr, tm_state=None):
    """Captured steps against the eager step, each from the state the
    captured step holds (its first call, then replays): metrics equal, new
    BN statistics equal, moments within ``GRAD_RTOL`` of each leaf's max,
    parameters within two rates; returns the differences and whether all
    was bit-equal, and the last state."""
    worst = {"stats": 0.0, "mu": 0.0, "nu": 0.0, "params_over_lr": 0.0}
    bitwise = True
    for batch in batches:
        ref = _clone_state(state)
        if tm_state is not None:
            want, _, m_want, v_want = step.eager(ref, _tm_clone(tm_state),
                                                 batch)
            state, tm_state, m_got, v_got = step(state, tm_state, batch)
            for k in v_want:
                if not torch.equal(v_got[k], v_want[k]):
                    raise AssertionError(f"{label}: metric {k} replay "
                                         f"{float(v_got[k])} against eager "
                                         f"{float(v_want[k])}")
        else:
            want, m_want = step.eager(ref, batch)
            state, m_got = step(state, batch)
        for name, g, w in zip(m_want._fields, m_got, m_want):
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: {name} replay {float(g)} "
                                     f"against eager {float(w)}")
        for part, got, exp in (("stats", state.batch_stats,
                                want.batch_stats),
                               ("mu", state.opt_state.mu, want.opt_state.mu),
                               ("nu", state.opt_state.nu, want.opt_state.nu),
                               ("params", state.params, want.params)):
            for k, w in exp.items():
                g = got[k]
                bitwise = bitwise and torch.equal(g, w)
                if part == "params":
                    err = float((g - w).abs().max()) / lr
                    key, tol = "params_over_lr", 2.0
                else:
                    err = (float((g.double() - w.double()).abs().max())
                           / max(float(w.abs().max()), 1e-30))
                    key, tol = part, (0.0 if part == "stats" else GRAD_RTOL)
                worst[key] = max(worst[key], err)
                if not err <= tol:
                    raise AssertionError(f"{label}: {part} {k} replay "
                                         f"against eager {err} (tol {tol})")
    return worst, bitwise, state


def _tm_clone(tm_state):
    from pillars_torch.train.loop import _leaves, _rebuild

    return _rebuild(tm_state, iter([t.clone() for t in _leaves(tm_state)]))


def _gradients_graph(det, state, batch, thr):
    """The gradients of ``batch`` at ``state`` through a graph of the
    train body's ``gradients`` and eagerly: (max of each leaf's |diff| over
    its max, the leaves that are not bit-equal)."""
    from pillars_torch.cuda_graph import CapturedCall
    from pillars_torch.train.loop import BATCH_DTYPES, BATCH_KEYS, gradients

    call = CapturedCall(
        lambda *b: list(gradients(det, state.params, state.batch_stats,
                                  dict(zip(BATCH_KEYS, b)), thr)
                        .grads.values()),
        det.device, BATCH_DTYPES, context=torch.no_grad)
    args = [batch[k] for k in BATCH_KEYS]
    call(*args)
    got = call(*args)
    want = gradients(det, state.params, state.batch_stats, batch, thr).grads
    err = max(_max_rel(g, w.cpu()) for g, w in zip(got, want.values()))
    differ = [k for g, (k, w) in zip(got, want.items())
              if not torch.equal(g, w)]
    return err, differ


def _deterministic(fn, algorithms=True, cudnn=True):
    """``fn()`` with ``torch.use_deterministic_algorithms(algorithms,
    warn_only=True)``, ``cudnn.deterministic = cudnn`` and cuDNN's
    benchmark off; the flags restored after."""
    flags = (torch.are_deterministic_algorithms_enabled(),
             torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(algorithms, warn_only=True)
    torch.backends.cudnn.deterministic = cudnn
    torch.backends.cudnn.benchmark = False
    try:
        return fn()
    finally:
        torch.use_deterministic_algorithms(flags[0])
        torch.backends.cudnn.deterministic = flags[1]
        torch.backends.cudnn.benchmark = flags[2]


def _deterministic_replay(cfg, state_cpu, batches, algorithms, cudnn):
    """The f32 step with ``torch.use_deterministic_algorithms(algorithms,
    warn_only=True)`` and ``cudnn.deterministic = cudnn``: whether two eager
    steps from one state agree bit for bit, whether replays then equal
    eager bit for bit, and the ops PyTorch names as nondeterministic."""
    import warnings

    def run():
        step, eager, state = _train_steps(cfg, state_cpu)
        a = eager(_clone_state(state), batches[0])[0]
        b = eager(_clone_state(state), batches[0])[0]
        reproducible = all(torch.equal(a.params[k], b.params[k])
                           for k in a.params)
        _, bitwise, _ = _replays_against_eager(
            "deterministic f32", step, state, batches,
            float(step.opt.schedule(0)))
        torch.cuda.synchronize()
        return reproducible, bitwise

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        reproducible, bitwise = _deterministic(run, algorithms, cudnn)
    return {"eager_reproducible": reproducible, "replay_bitwise": bitwise,
            "nondeterministic_ops": _nondeterministic_ops(caught)}


def _heads_after_steps(cfg, state_cpu, batches):
    """Replayed steps, and after each the detector's captured heads on the
    step's state against eager heads on a fresh clone of it (within
    ``CAPTURE_RTOL`` of each tensor's max); returns the largest |diff|."""
    from pillars_torch.train.loop import variables

    step, _, state = _train_steps(cfg, state_cpu)
    det = step.detector
    thr = cfg.eval_input.anchor_area_threshold
    heads, heads_eager = _captured_heads(det, thr)
    pts, num = _clouds(cfg.model.voxel.max_points, 1, 1)
    eye = torch.eye(4)[None].cuda()
    inputs = (torch.from_numpy(pts[0]).cuda(), torch.from_numpy(num).cuda(),
              eye, eye)
    heads(variables(state), *inputs)
    before = heads(variables(state), *inputs)
    worst = 0.0
    for batch in batches:
        state, _ = step(state, batch)
        fresh = {k: v.clone() for k, v in variables(state).items()}
        got = heads(variables(state), *inputs)
        worst = max(worst, _replay_close(got, heads_eager(fresh, *inputs),
                                         "heads after a replayed step"))
    if all(torch.equal(a, b) for a, b in zip(got, before)):
        raise AssertionError("heads after replayed steps equal the heads "
                             "before them: inference read old weights")
    return worst


def _recal_against_eager(cfg, state_cpu, smi):
    """19.4: the AdaBN recalibration of ``Config.default()`` with
    ``eval_input.bn_recal_batches`` 8 through the Evaluator, captured
    against eager, and the two timed."""
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.bn_recal import CapturedRecal
    from pillars_torch.train.trainer import Evaluator
    from pillars_torch.utils.profiling import cuda_ms

    cfg = cfg.override("eval_input.bn_recal_batches", 8)
    det = PillarsDetector(cfg)
    ev = Evaluator(cfg, det)
    state = det.state_to_device(state_cpu)
    got = ev._maybe_recalibrate(state)
    if not isinstance(ev._recal_step, CapturedRecal):
        raise AssertionError("build_recal_fn did not capture on the card")
    got = {k: v.clone() for k, v in got.items()}
    captured = ev._recal_step
    ev._recal_step = captured.eager
    want = ev._maybe_recalibrate(state)
    err = 0.0
    for k, w in want.items():
        if w.is_floating_point():
            e = float((got[k] - w).abs().max())
            err = max(err, e / max(float(w.abs().max()), 1e-30))
        elif not torch.equal(got[k], w):
            raise AssertionError(f"recal {k}: replay against eager")
    if not err <= CAPTURE_RTOL:
        raise AssertionError(f"recal statistics replay against eager {err}")
    b = ev._recal_batches[0]
    ms = {}
    for name, fn in (("eager", captured.eager), ("captured", captured)):
        box = [state]

        def one():  # each step's statistics into the next, as recalibrate
            box[0] = {**box[0], **fn(box[0], b["points"], b["num_points"])}

        ms[name] = cuda_ms(one, 20)
    print(f"recalibration, {len(ev._recal_batches)} batches of "
          f"{cfg.eval_input.batch_size}: captured against eager statistics "
          f"within {err:.3e} of their max (tol {CAPTURE_RTOL}); ms per recal "
          f"step (CUDA events) eager {ms['eager']:.3f}, captured "
          f"{ms['captured']:.3f} [{smi}]")
    return {"max_rel": err, "ms": ms}


def _stage_sums(state_cpu, smi):
    """19.5: ``profile_stages`` of the dense and fast configs in device ms
    from captured stages against the three stages in one graph."""
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.utils.profiling import stage_sum

    out = {}
    for name, cfg in (("dense", Config.default()), ("fast", _fast_config())):
        det = PillarsDetector(cfg)
        state = det.state_to_device(state_cpu)
        pts, num = _clouds(cfg.model.voxel.max_points, 1, 1)
        eye = torch.eye(4)[None]
        r = stage_sum(det, state, torch.from_numpy(pts[0]),
                      torch.from_numpy(num), eye, eye, 50)
        stages = det.profile_stages(state, torch.from_numpy(pts[0]),
                                    torch.from_numpy(num), eye, eye, 50)
        rounded = lambda d: json.dumps(  # noqa: E731
            {k: round(v, 4) for k, v in d.items()})
        print(f"profile_stages {name} B=1 (device ms, each stage a graph of "
              f"its own): {rounded(stages)}; stage_sum's stages "
              f"{rounded(r['stages'])}, sum {r['sum']:.4f} against the three in one graph "
              f"{r['whole']:.4f} and a boundary {r['boundary']:.4f} [{smi}]")
        if not (0.8 * r["whole"] <= r["sum"]
                <= 1.1 * r["whole"] + 3 * r["boundary"]):
            raise AssertionError(f"profile_stages {name}: the sum "
                                 f"{r['sum']} against the whole {r['whole']}")
        out[name] = {**r, "profile_stages": stages}
    return out


# the capture stress: fresh captured steps per variant, with Python's
# collector at thresholds (1, 1, 1), and then with a collection forced
# inside the capture
STRESS_ROUNDS = 20
STRESS_FORCED_ROUNDS = 2


def _forcing_collection(capture):
    """``capture`` with a collection run at the start of the captured body:
    what the collector may do there at any allocation."""

    def forced(run):
        return capture(lambda: (gc.collect(), run())[1])

    return forced


def capture_stress(root):
    """The capture stress (run by phase 19 in a process of its own): from
    ``weights_59.pkl`` on phase 10's first batch, a fresh f32 and a fresh
    bf16 captured step (``make_train_step`` on one detector each) captured
    in turns, ``STRESS_ROUNDS`` times each, the step before left in a
    reference cycle (as phase 19's loop drops its steps), with the
    collector's thresholds at (1, 1, 1); then ``STRESS_FORCED_ROUNDS``
    rounds with a collection forced inside the capture. A capture that
    fails raises: none may. Returns the captures per mode and variant and
    the seconds they took."""
    from pillars_torch import cuda_graph
    from pillars_torch.config import Config
    from pillars_torch.train.loop import batch_to_device, make_train_step
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = _with_split(Config.default(), root)
    state_cpu = from_jax_variables(*load_params(str(WEIGHTS)), cfg)
    batch = batch_to_device(_train_batches(cfg, 1)[0], CARD)
    setups = {}
    for name, c in (("f32", cfg), ("bf16", cfg.override(
            "runtime.compute_dtype", "bfloat16"))):
        step, _, state = _train_steps(c, state_cpu)
        setups[name] = (step.detector, step.opt, state)
        del step
    capture = cuda_graph._capture_graph
    result, t0 = {}, time.perf_counter()
    thresholds = gc.get_threshold()
    try:
        for mode, rounds, fn in (
                ("thresholds", STRESS_ROUNDS, capture),
                ("forced", STRESS_FORCED_ROUNDS, _forcing_collection(capture))):
            cuda_graph._capture_graph = fn
            gc.set_threshold(1, 1, 1)
            for _ in range(rounds):
                for det, opt, state in setups.values():
                    # the step before is dropped here, into its cycle
                    step = make_train_step(det, opt)
                    step.cycle = step
                    step(_clone_state(state), batch)
            gc.set_threshold(*thresholds)
            del step
            torch.cuda.synchronize()
            result[mode] = {name: rounds for name in setups}
    finally:
        gc.set_threshold(*thresholds)
        cuda_graph._capture_graph = capture
    result["seconds"] = time.perf_counter() - t0
    return result


def _run_capture_stress(root, smi):
    """Phase 19's capture stress in a child process (``--capture-stress``),
    whose heap holds the stress's steps and little else. Fails unless every
    capture held, under the thresholds and the forced collection."""
    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--capture-stress",
         root], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"capture stress: exit {proc.returncode}\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    for mode in ("thresholds", "forced"):
        print(f"capture stress {mode}: fresh captured steps {r[mode]}, "
              f"0 invalidated")
    print(f"capture stress: {r['seconds']:.1f} s in the child, "
          f"{time.perf_counter() - t:.1f} s with its start [{smi}]")
    return r


def run_captured_train(state_cpu, smi, root):
    """Phase 19; returns its numbers."""
    from pillars_torch.config import Config
    from pillars_torch.train import metrics as tm
    from pillars_torch.train.loop import batch_to_device
    from pillars_torch.weights import from_jax_variables, load_params

    t19 = time.perf_counter()
    result = {"voxelizer": _voxelizer_range(smi),
              "voxelizer_ms": _voxelizer_cost(smi)}
    cfg = _with_split(Config.default(), root)
    thr = cfg.train_input.anchor_area_threshold
    batches = [batch_to_device(b, CARD) for b in _train_batches(cfg, 3)]
    variants = {
        "f32": cfg, "bf16": cfg.override("runtime.compute_dtype",
                                         "bfloat16"),
        "remat": cfg.override("model.rpn.remat", True),
        "metrics": cfg}
    result["replay"] = {}
    for name, c in variants.items():
        step, _, state = _train_steps(c, state_cpu)
        if name == "metrics":
            from pillars_torch.train.loop import make_train_step

            step = make_train_step(step.detector, step.opt,
                                   with_metrics=True)
        lr = float(step.opt.schedule(0))
        tm_state = (tm.TrainMetricsState.init(CARD) if name == "metrics"
                    else None)
        worst, bitwise, state = _replays_against_eager(
            f"captured step {name}", step, state, batches, lr, tm_state)
        err, differ = _gradients_graph(step.detector, state, batches[0],
                                       thr)
        if not err <= GRAD_RTOL:
            raise AssertionError(f"captured gradients {name}: {err} of max")
        result["replay"][name] = {**worst, "bitwise": bitwise,
                                  "grad_max_rel": err,
                                  "grad_leaves_differing": differ,
                                  "graphs": len(step.graphs)}
        print(f"captured step {name} B=2 full width, 3 steps (the first "
              f"call, then replays) each against the eager step from the "
              f"same state: loss parts, rate and positives equal; new BN "
              f"statistics max rel {worst['stats']:.3e}, moments "
              f"{worst['mu']:.3e} / {worst['nu']:.3e} of each leaf's max "
              f"(tol {GRAD_RTOL}), parameters {worst['params_over_lr']:.3e} "
              f"rates (tol 2); bit-equal: {bitwise}; gradients through a "
              f"graph of the body's gradients {err:.3e} of each leaf's max, "
              f"{len(differ)} leaves not bit-equal: {differ} [{smi}]")
    result["deterministic"] = {}
    for algorithms, cudnn in ((True, True), (True, False), (False, True)):
        d = _deterministic_replay(cfg, state_cpu, batches, algorithms, cudnn)
        key = f"algorithms_{algorithms}_cudnn_{cudnn}"
        result["deterministic"][key] = d
        print(f"f32 step with deterministic algorithms {algorithms} (warn "
              f"only), cuDNN deterministic {cudnn}: two eager steps "
              f"bit-equal: {d['eager_reproducible']}; replays bit-equal to "
              f"eager: {d['replay_bitwise']}; ops PyTorch names "
              f"nondeterministic: {d['nondeterministic_ops']}")
        if d["eager_reproducible"] and not d["replay_bitwise"]:
            raise AssertionError(f"{key}: the eager step is reproducible "
                                 f"but a replay differs from it")

    scfg = _with_split(Config.from_yaml(
        str(CONFIGS / "second_sparse_d435i.yaml")), root)
    sstate = from_jax_variables(*load_params(str(SECOND_WEIGHTS)), scfg)
    step, _, state = _train_steps(scfg, sstate)
    sb = [batch_to_device(b, CARD) for b in _train_batches(scfg, 2)]
    worst, bitwise, _ = _replays_against_eager(
        "captured step second_sparse", step, state, sb,
        float(step.opt.schedule(0)))
    result["replay"]["second_sparse"] = {**worst, "bitwise": bitwise}
    print(f"captured step second_sparse_d435i B=2 from weights_33.pkl, 2 "
          f"steps against eager: metrics equal, statistics "
          f"{worst['stats']:.3e}, moments {worst['mu']:.3e} / "
          f"{worst['nu']:.3e}, parameters {worst['params_over_lr']:.3e} "
          f"rates; bit-equal: {bitwise} [{smi}]")

    result["heads_after_steps"] = _heads_after_steps(cfg, state_cpu,
                                                     batches)
    print(f"inference after replayed steps: the detector's captured heads "
          f"against eager heads on a fresh clone of the state, max |diff| "
          f"{result['heads_after_steps']:.3e} (tol {CAPTURE_RTOL} of each "
          f"tensor's max), and moved by the steps")
    result["recal"] = _recal_against_eager(cfg, state_cpu, smi)
    result["stages"] = _stage_sums(state_cpu, smi)
    result["capture_stress"] = _run_capture_stress(root, smi)
    print(f"phase 19 (captured training): "
          f"{time.perf_counter() - t19:.1f} s [{smi}]")
    print("captured train: " + json.dumps(result))
    return result


# --------------------------------------------------------------------------
# phase 20: configs/kitti_3class.yaml from its trained checkpoint

K3_CONFIG = CONFIGS / "kitti_3class.yaml"
K3_WEIGHTS = ROOT / "benchmarks" / "kitti3_synth" / "weights_73.pkl"
K3_GOLDEN = ROOT / "tests" / "golden" / "torch_kitti3_val_ap.json"
# the resumed Trainer's short epoch: K3_TRAIN_CLOUDS train clouds (20 steps
# at B=2). The recipe's last epochs read a mean loss of 0.36-0.50
# (benchmarks/kitti3_synth/metrics.csv); its per-epoch eval oscillated
# between 86 and 93 after epoch 52 (README), and the JAX package reads 90.61
# on the CPU from the checkpoint (the golden)
K3_TRAIN_CLOUDS = 40
# the resumed step at B=1, card vs CPU: the gradients by each leaf's relative
# L2, within K3_SPREAD_FACTOR times the largest that one float32 step on
# every parameter moves them by on the card in the same run (the step's own
# rounding sensitivity). Elementwise, GRAD_RTOL of a leaf's max does not
# hold at this scale: that float32 step alone moves single elements by
# 1.6e-3 of their leaf's max, and cuDNN against oneDNN moves one of
# rpn.block2.conv3.weight by 5.6e-3 (printed beside). The same gate must
# reject the step with TF32 convolutions and matmuls on the card
K3_SPREAD_FACTOR = 3.0
K3_LOSS_GATE = 1.0
K3_AP_FLOOR = 80.0
# the checkpoint README's aggregate: the JAX package's per-epoch eval on a
# TPU during training, printed beside the golden, not a target
K3_README_AGGREGATE = 93.42


def make_kitti3_split(root):
    """The split of benchmarks/kitti3_synth/README.md (300 train / 80 val
    kitti3-profile clouds, seed 11) into ``root``, checked against the
    golden value's checksum."""
    from pillars_torch import cli
    from pillars_torch.data.synthetic import split_checksum

    golden = json.loads(K3_GOLDEN.read_text())
    t0 = time.perf_counter()
    cli.main(["synth-data", "--root", root, "--num-train", "300",
              "--num-test", "80", "--profile", "kitti3", "--seed", "11"])
    checksum = split_checksum(root)
    print(f"kitti3 split regenerated in {time.perf_counter() - t0:.1f} s, "
          f"val sha256 {checksum}, the golden's {golden['val_checksum']}")
    if checksum != golden["val_checksum"]:
        raise AssertionError("the regenerated kitti3 val split is not the "
                             "golden value's")


def _nms_inputs(fn, state, b):
    """The NMS kernel's inputs in one eager call of ``fn`` on the batch
    ``b``: the score-sorted standup boxes [B, K, 4], their validity and
    the IoU threshold."""
    from pillars_torch.ops import nms_cuda

    seen, inner = [], nms_cuda.nms_keep_mask

    def spy(boxes, valid, thr):
        seen.append((boxes.clone(), valid.clone(), thr))
        return inner(boxes, valid, thr)

    spy.launches = 0  # the wrapper counts into the module's function
    nms_cuda.nms_keep_mask = spy
    try:
        fn.eager(state, b["points"], b["num_points"], b["rect"], b["trv2c"])
    finally:
        nms_cuda.nms_keep_mask = inner
    return seen[0]


def _nms_k1000(boxes, valid, thr, smi):
    """The NMS kernel on a trained cloud's K = 1000 boxes."""
    out = _nms_kernel_timing(boxes, valid, thr)
    print(f"nms_keep_mask on a trained kitti3 cloud, K={boxes.shape[1]} "
          f"({out['valid']} valid, {out['kept']} kept, {out['pairs']} pairs "
          f"of a box and a kept box before it): bit-equal to its twin; "
          f"{out['ms'] * 1e3:.2f} us per call, {out['device_ms'] * 1e3:.2f} "
          f"us device time (torch.profiler), plain twin "
          f"{out['plain_ms']:.3f} ms; bound {out['bound_ms'] * 1e3:.4f} us "
          f"({out['bound_by']}: {out['flops']} f32 operations, "
          f"{out['bytes']} bytes), the device time "
          f"{out['device_ms'] / out['bound_ms']:.0f}x the bound [{smi}]")
    return out


def _k3_serving(cfg, det, det_cpu, ev, state, state_cpu, smi):
    """20.1: serving at B=1 and B=2 from the recalibrated state: launches,
    the card against the CPU, times."""
    from pillars_torch.cuda_graph import CapturedInference, pool_mib
    from pillars_torch.data.pipeline import collate
    from pillars_torch.utils.profiling import cuda_ms, device_busy
    from pillars_torch.utils.roofline import roofline_report

    thr = cfg.eval_input.anchor_area_threshold
    k = cfg.model.postprocess.nms_pre_max_size
    items = [ev.dataset[i] for i in range(4)]
    batches = [collate([items[0]]), collate([items[1]]), collate(items[2:])]
    on_card = [_on_card(b) for b in batches]
    fn = det.make_inference_fn()
    if not isinstance(fn, CapturedInference):
        raise AssertionError("kitti3: make_inference_fn did not capture")
    launches = _counted(fn, state, on_card)
    print(f"kitti3 serving, 2 batches at B=1 and 1 at B=2 of "
          f"{cfg.model.voxel.max_points}-point pads: launches {launches}")

    head_err, post_err, pillars = 0.0, 0.0, []
    with torch.inference_mode():
        for b, bc in zip(batches, on_card):
            v_cpu = det_cpu.voxelize_batch(torch.from_numpy(b["points"]),
                                           torch.from_numpy(b["num_points"]))
            v = det.voxelize_batch(bc["points"], bc["num_points"])
            for name in ("coords", "pillar_mask", "num_points"):
                if not torch.equal(getattr(v, name).cpu(),
                                   getattr(v_cpu, name)):
                    raise AssertionError(f"kitti3: voxelization {name} "
                                         f"differs")
            pillars += v_cpu.pillar_mask.sum(1).tolist()
            amask_cpu = det_cpu.anchors_mask_batch(v_cpu.coords,
                                                   v_cpu.pillar_mask, thr)
            if not torch.equal(det.anchors_mask_batch(
                    v.coords, v.pillar_mask, thr).cpu(), amask_cpu):
                raise AssertionError("kitti3: anchors mask differs")
            preds_cpu = det_cpu.apply(state_cpu, v_cpu)
            head_err = max(head_err, _heads_close(
                det.apply(state, v), preds_cpu, "kitti3"))
            post_err = max(post_err, _post_close(
                det, det_cpu, preds_cpu, amask_cpu,
                torch.from_numpy(b["rect"]), torch.from_numpy(b["trv2c"]),
                "kitti3"))
    print(f"kitti3 card vs CPU: pillars per cloud {pillars} (cap "
          f"{cfg.model.voxel.max_voxels}), voxelization integers and "
          f"anchors mask equal; head tensors max diff {head_err:.3e} of "
          f"their max (tol {HEAD_RTOL}); the card's postprocess on the "
          f"CPU's heads max |diff| {post_err:.3e} (tol {POST_ATOL}), valid "
          f"and labels equal")

    b0 = on_card[0]
    call = lambda: fn(state, b0["points"], b0["num_points"],  # noqa: E731
                      b0["rect"], b0["trv2c"])
    times = _cloud_times(call, iters=20)
    rows = device_busy(call, 10, "nms_keep_mask_kernel")[2]
    sort_ms = sum(t for n, _, t in rows if "sort" in n.lower())
    nms_ms = sum(t for n, _, t in rows if "nms_keep_mask" in n)
    with torch.inference_mode():
        preds = det.apply(state, det.voxelize_batch(b0["points"],
                                                    b0["num_points"]))
        scores = torch.sigmoid(preds["cls_preds"].reshape(
            1, -1, cfg.model.num_class).amax(-1))
    sort_alone = cuda_ms(lambda: torch.sort(scores, dim=1, descending=True,
                                            stable=True), 50)
    topk_alone = cuda_ms(lambda: torch.topk(scores, k, dim=1), 50)
    roof = roofline_report(cfg, times["device_ms"], 1)
    times.update(
        sort_device_ms=sort_ms, nms_device_ms=nms_ms,
        sort_share=sort_ms / times["device_ms"],
        sort_alone_ms=sort_alone, topk_alone_ms=topk_alone,
        capture_s={str(key[0]): g.seconds for key, g in fn.graphs.items()},
        pool_mib=pool_mib(), bound_ms=roof["bound_ms"],
        bound_by=roof["bound_by"], flops=roof["flops"], bytes=roof["bytes"],
        counts=launches)
    print(f"kitti3 B=1 captured: {times['ms']:.3f} ms/cloud (CUDA events, "
          f"warm), {times['host_wall_ms']:.3f} ms host wall; "
          f"{times['graph_launches']:g} graph and {times['launches']:g} "
          f"kernel launches, {times['device_ms']:.4f} ms of device time per "
          f"cloud, idle share {times['idle_share']:.3f} (torch.profiler); "
          f"inside it the stable sort of {scores.shape[1]} scores "
          f"{sort_ms:.4f} ms ({times['sort_share']:.3f} of the device time) "
          f"and the NMS kernel {nms_ms * 1e3:.2f} us; that sort alone "
          f"{sort_alone:.4f} ms, torch.topk to {k} {topk_alone:.4f} ms (CUDA "
          f"events); first call + capture s per shape {times['capture_s']}, "
          f"graph pool {times['pool_mib']:.1f} MiB; analytic bound "
          f"{roof['bound_ms']:.4f} ms ({roof['bound_by']}: "
          f"{roof['flops']:.4g} FLOP, {roof['bytes']:.4g} B, "
          f"utils/roofline.py) [{smi}]")
    nms = _nms_k1000(*_nms_inputs(fn, state, b0), smi)
    return times, nms


def _k3_evaluate(cfg, ev, state, smi):
    """20.2: the Evaluator over the 80 val clouds with recalibration,
    against the golden; the recal step captured against eager in turns."""
    from pillars_torch.train.bn_recal import CapturedRecal
    from pillars_torch.utils.profiling import cuda_ms

    golden = json.loads(K3_GOLDEN.read_text())
    _reset_counts()
    t0 = time.perf_counter()
    text, bev, d3, aos, score = ev.evaluate(state)
    seconds = time.perf_counter() - t0
    launches = _read_counts()
    print(text)
    if not isinstance(ev._recal_step, CapturedRecal):
        raise AssertionError("kitti3: build_recal_fn did not capture")
    n_batches = -(-len(ev.dataset) // cfg.eval_input.batch_size)
    n_rungs = len(ev._bucketed.buckets)
    if (launches["nms_keep_mask"] != n_batches + n_rungs
            or launches["rpn_sep_block"] != 0):
        raise AssertionError(f"kitti3 evaluate: launches {launches} for "
                             f"{n_batches} batches and {n_rungs} warm-ups")
    worst = max(np.abs(np.asarray(got) - np.asarray(golden[key])).max()
                for got, key in ((bev, "mAP_bev"), (d3, "mAP_3d"),
                                 (aos, "mAP_aos")))
    # the recal step captured against eager, in turns
    b = ev._recal_batches[0]
    recal_ms = []
    for name in ("eager", "captured", "captured", "eager"):
        fn = ev._recal_step if name == "captured" else ev._recal_step.eager
        box = [state]

        def one():  # each step's statistics into the next, as recalibrate
            box[0] = {**box[0], **fn(box[0], b["points"], b["num_points"])}

        recal_ms.append((name, cuda_ms(one, 10)))
    stages = {k: round(v, 4) for k, v in sorted(ev.last_stage_ms.items())}
    print(f"kitti3 evaluate, {len(ev.dataset)} val clouds, batch "
          f"{cfg.eval_input.batch_size}, buckets {ev._bucketed.buckets}, "
          f"recalibrated over {len(ev._recal_batches)} train batches: "
          f"aggregate {score:.6f}, golden {golden['aggregate']:.6f} "
          f"(pillars_tpu on the CPU, f32), difference "
          f"{score - golden['aggregate']:+.6f} (tol {AP_TOL}), largest AP "
          f"cell difference {worst:.4f}; the README's TPU value "
          f"{K3_README_AGGREGATE} is not held against; {seconds:.2f} s with "
          f"recalibration and AP, stages ms/cloud {json.dumps(stages)}; NMS "
          f"launches {launches['nms_keep_mask']} = {n_batches} batches + "
          f"{n_rungs} rung warm-ups; recal step ms (CUDA events) in turns "
          f"{recal_ms} [{smi}]")
    if not abs(score - golden["aggregate"]) <= AP_TOL:
        raise AssertionError(f"kitti3 aggregate {score} vs golden "
                             f"{golden['aggregate']}: more than {AP_TOL}")
    return {"aggregate": score, "golden": golden["aggregate"],
            "max_cell_diff": float(worst), "seconds": seconds,
            "stages_ms": stages, "recal_ms": recal_ms,
            "launches": launches}


def _k3_train_step(cfg, smi):
    """20.3: the train step resumed from the checkpoint's TrainState: card
    against CPU at B=1 on the first cloud, then B=2 times and memory."""
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train import checkpoint as ckpt
    from pillars_torch.train.loop import batch_to_device, forward_backward
    from pillars_torch.weights import from_jax_variables, load_params

    host, _ = ckpt.load_checkpoint(str(K3_WEIGHTS))
    thr = cfg.train_input.anchor_area_threshold
    det, det_cpu = PillarsDetector(cfg), PillarsDetector(cfg, device="cpu")
    state = ckpt.train_state_from_host(host, cfg, det.device)
    state_h = ckpt.train_state_from_host(host, cfg, "cpu")
    if not state.step == state.opt_state.count == 11100:
        raise AssertionError(f"resumed step {state.step}, AdamW count "
                             f"{state.opt_state.count}")
    t0 = time.perf_counter()
    batch = _train_batches(cfg, 1, b=1)[0]
    fb_h = forward_backward(det_cpu, state_h, batch, thr)
    spread = _grads_apart(forward_backward(det, state, batch, thr).grads,
                          forward_backward(det, _ulp_moved(state), batch,
                                           thr).grads)
    gate = K3_SPREAD_FACTOR * spread["l2"]
    print(f"kitti3 train step B=1, the card against itself with every "
          f"parameter moved by one float32 step: {_apart_line(spread)} "
          f"[{smi}]")
    line = _step_close(det, det_cpu, state, state_h, batch, thr,
                       grad_l2=gate, fb_h=fb_h)
    print(f"kitti3 train step B=1 resumed at step 11100, card vs CPU: "
          f"{line}; {time.perf_counter() - t0:.1f} s")
    tf32 = _grads_apart(_tf32_grads(det, state, batch, thr), fb_h.grads)
    print(f"kitti3 train step B=1 with TF32 on the card, against the CPU "
          f"(the control): {_apart_line(tf32)}; the gate "
          f"{K3_SPREAD_FACTOR:g} x {spread['l2']:.3e} = {gate:.3e} [{smi}]")
    if not tf32["l2"] > gate:
        raise AssertionError(f"kitti3: the gradient gate {gate} does not "
                             f"reject a TF32 step ({tf32['l2']})")

    t0 = time.perf_counter()
    batches = _train_batches(cfg, 5)
    loader_ms = (time.perf_counter() - t0) * 1e3 / 5
    on_card = batch_to_device(batches[0], det.device)
    state_cpu = from_jax_variables(*load_params(str(K3_WEIGHTS)), cfg)
    turns = _step_turns(cfg, state_cpu, on_card, host)
    memory = _step_memory(cfg, state_cpu, on_card, host)
    print(f"kitti3 train step B=2 resumed, in turns: {_turns_line(turns)} "
          f"[{smi}]")
    print(f"kitti3 train step B=2: peak device memory of an eager step "
          f"above the state {memory['peak_mib_remat_off']:.1f} MiB with "
          f"rpn.remat off, {memory['peak_mib_remat_on']:.1f} MiB on; the "
          f"host makes one augmented batch in {loader_ms:.1f} ms on one "
          f"thread [{smi}]")
    stages = _train_stages(cfg, state_cpu, on_card, turns, smi, host,
                           "kitti3 train step B=2")
    return {"loader_ms_per_batch": loader_ms, "turns": turns, **memory,
            "stages": stages, "ulp_spread": spread, "grad_gate_l2": gate,
            "tf32_control": tf32}


def _ulp_moved(state):
    """``state`` with every parameter moved by one float32 step (random
    signs, seed 0)."""
    params, gen = {}, None
    for k, v in state.params.items():
        gen = gen or torch.Generator(device=v.device).manual_seed(0)
        up = torch.rand(v.shape, generator=gen, device=v.device) < 0.5
        params[k] = torch.nextafter(v, torch.where(
            up, torch.full_like(v, float("inf")),
            torch.full_like(v, float("-inf"))))
    return state._replace(params=params)


def _tf32_grads(det, state, batch, thr):
    """One batch's gradients on the card with TF32 convolutions and matmuls
    (the detector turns them off at every call; here it turns them on)."""
    from pillars_torch.models import detector
    from pillars_torch.train.loop import forward_backward

    def tf32():
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True

    full = detector._full_f32
    detector._full_f32 = tf32
    try:
        return forward_backward(det, state, batch, thr).grads
    finally:
        detector._full_f32 = full
        full()


def _grads_apart(got, want):
    """How far gradients ``got`` (on the card) lie from ``want``: the
    largest difference over each leaf's max, the largest relative L2, and
    their leaves."""
    want = {k: g.cpu() for k, g in want.items()}
    rel = {k: _max_rel(got[k], g) for k, g in want.items()}
    l2 = {k: _rel_l2(got[k], g) for k, g in want.items()}
    worst, worst_l2 = max(rel, key=rel.get), max(l2, key=l2.get)
    return {"max_rel": rel[worst], "max_rel_leaf": worst,
            "l2": l2[worst_l2], "l2_leaf": worst_l2}


def _apart_line(apart):
    return (f"gradients max diff {apart['max_rel']:.3e} of a leaf's max "
            f"({apart['max_rel_leaf']}), relative L2 at most "
            f"{apart['l2']:.3e} ({apart['l2_leaf']})")


def _k3_trainer(cfg, root, smi, n_clouds=K3_TRAIN_CLOUDS):
    """20.4: a Trainer resumed from the checkpoint for a short epoch on the
    first ``n_clouds`` train clouds, then its eval with recalibration."""
    tcfg = _train_cfg(root, os.path.join(root, "runs"), n_clouds, cfg)
    r = _trainer_epoch(tcfg, 74, resume=(str(K3_WEIGHTS), 11100))
    opt = cfg.train.optimizer
    bs = cfg.train_input.batch_size
    rate = (opt.initial_learning_rate
            * opt.decay_factor ** (11100 / (opt.decay_steps / bs)))
    n_steps = n_clouds // bs
    print(f"kitti3 Trainer resumed from weights_73.pkl: "
          f"{_epoch_line(r, 74, n_clouds)}; mean loss of the steps "
          f"{r['mean_loss']:.4f} (gate {K3_LOSS_GATE}); first rate "
          f"{r['first_rate']:.9e}, the schedule's {rate:.9e}; eval recalibrated "
          f"over {r['recal_batches']} train batches; aggregate AP "
          f"{r['ap']:.4f} (floor {K3_AP_FLOOR}, the golden "
          f"{json.loads(K3_GOLDEN.read_text())['aggregate']:.4f} before "
          f"these steps) [{smi}]")
    if r["n_steps"] != n_steps or r["steps"] != 11100 + n_steps:
        raise AssertionError(f"kitti3 Trainer: {r['n_steps']} steps to "
                             f"step {r['steps']}")
    if not abs(r["first_rate"] - rate) <= 1e-6 * rate:
        raise AssertionError(f"kitti3 Trainer: rate {r['first_rate']}, the "
                             f"schedule's {rate}")
    if not r["mean_loss"] < K3_LOSS_GATE:
        raise AssertionError(f"kitti3 Trainer: mean loss {r['mean_loss']} "
                             f"not below {K3_LOSS_GATE}")
    if not r["ap"] > K3_AP_FLOOR:
        raise AssertionError(f"kitti3 Trainer: aggregate AP {r['ap']} not "
                             f"above {K3_AP_FLOOR}")
    return {k: v for k, v in r.items() if k != "dirs"}


def run_kitti3(smi):
    """Phase 20; returns its numbers, the NMS launches of each path and the
    kernel at K = 1000."""
    from pillars_torch.config import Config
    from pillars_torch.infer import parse_bucket_arg
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.trainer import Evaluator
    from pillars_torch.weights import from_jax_variables, load_params

    t20 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="kitti3_data_")
    try:
        make_kitti3_split(root)
        cfg = _with_split(Config.from_yaml(str(K3_CONFIG)), root)
        det, det_cpu = PillarsDetector(cfg), PillarsDetector(cfg, device="cpu")
        ev = Evaluator(cfg, det, measure_time=True, buckets=parse_bucket_arg(
            cfg.eval_input.buckets, cfg.model.voxel.max_points))
        state = det.state_to_device(
            from_jax_variables(*load_params(str(K3_WEIGHTS)), cfg))
        # serve from the recalibrated statistics, as evaluation does
        t0 = time.perf_counter()
        recal = {k: v.clone() for k, v in ev._maybe_recalibrate(state).items()}
        torch.cuda.synchronize()
        print(f"kitti3 recalibration: {len(ev._recal_batches)} train batches "
              f"of {cfg.eval_input.batch_size} read and refreshed in "
              f"{time.perf_counter() - t0:.1f} s")
        out = {}
        out["serve"], nms = _k3_serving(cfg, det, det_cpu, ev, recal,
                                        {k: v.cpu() for k, v in recal.items()},
                                        smi)
        out["eval"] = _k3_evaluate(cfg, ev, state, smi)
        out["train_step"] = _k3_train_step(cfg, smi)
        out["trainer"] = _k3_trainer(cfg, root, smi)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t20
    print(f"phase 20 (kitti_3class): {out['seconds']:.1f} s [{smi}]")
    print("kitti3: " + json.dumps(out))
    launches = {"kitti3_serve": out["serve"]["counts"]["nms_keep_mask"],
                "kitti3_eval": out["eval"]["launches"]["nms_keep_mask"],
                "kitti3_train_eval": out["trainer"]["nms_launches"]}
    return out, launches, nms


# --------------------------------------------------------------------------
# phase 22: pillars-torch bench, one child process per path and dtype
BENCH_RUNS = (("dense", "float32"), ("fast", "float32"),
              ("fast", "bfloat16"))
BENCH_ITERS = 1000
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "mfu", "bound")


def run_bench(smi):
    """22: ``pillars-torch bench`` for each of ``BENCH_RUNS``."""
    t22 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for path, dtype in BENCH_RUNS:
        label = f"bench --path {path} --dtype {dtype}"
        out = subprocess.run(
            [sys.executable, "-m", "pillars_torch.cli", "bench", "--path",
             path, "--dtype", dtype, "--iters", str(BENCH_ITERS)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
        if out.returncode != 0:
            raise AssertionError(f"{label}: exit {out.returncode}\n"
                                 f"{out.stderr[-4000:]}")
        lines = out.stdout.strip().splitlines()
        if len(lines) != 1:
            raise AssertionError(f"{label}: {len(lines)} lines of output")
        r = json.loads(lines[0])
        missing = [k for k in BENCH_KEYS if k not in r]
        if (missing or not np.isfinite(r["value"]) or r["value"] <= 0
                or r["device"]["name"] != torch.cuda.get_device_name(0)
                or not r["detail"]["captured"]):
            raise AssertionError(f"{label}: missing {missing} or a bad "
                                 f"line: {lines[0]}")
        launches = r["detail"]["launches_per_call"]
        fast = path == "fast"
        # BN + ReLU in float32: the dense RPN's 19 pairs, the fast path's
        # 3 deconvs (its blocks' BN is folded into the fused kernel); the
        # PFN kernel once a call in float32
        want = {"nms_keep_mask.launches": 1.0,
                "fused_sep_block.launches": float(fast),
                "fused_sep_block.launches_bf16": float(
                    fast and dtype == "bfloat16"),
                "bn_relu.launches": float(
                    (3 if fast else 19) * (dtype == "float32")),
                "pfn_max.launches": float(dtype == "float32")}
        if launches != want:
            raise AssertionError(f"{label}: launches per timed call "
                                 f"{launches}, want {want}")
        print(f"{label}: {lines[0]}")
        print(f"{label}: launches per timed call {launches} (one cloud per "
              f"call; {smi})")
    print(f"phase 22 (bench): {time.perf_counter() - t22:.1f} s")


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train-clouds", type=int, default=300,
                   help="train clouds of the Trainer phase (600: the "
                        "recipe's whole split, 300 steps per epoch)")
    p.add_argument("--ranks", type=int,
                   help="run only phase 21: the captured mesh paths over N "
                        "NCCL ranks on N cards")
    p.add_argument("--capture-stress", metavar="ROOT",
                   help="run only phase 19's capture stress on the hard "
                        "split in ROOT; print its result as JSON")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.capture_stress:
        print(json.dumps(capture_stress(args.capture_stress)))
        return 0
    from pillars_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {_build.sources()}")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    if args.ranks:
        run_mesh_ranks(args.ranks, smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    from pillars_torch.config import Config
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = Config.default()
    nms = check_nms_kernel(cfg.model.postprocess.nms_iou_threshold)
    rpn = check_rpn_kernel(cfg.model)
    bn_relu = check_bn_relu_kernel(cfg.model)
    pfn = check_pfn_max_kernel()
    state_cpu = from_jax_variables(*load_params(str(WEIGHTS)), cfg)
    dense, batches, on_card, outs, dense_times = run_main_path(state_cpu)
    fast, fast_times = run_fast_path(state_cpu, batches, on_card, outs)
    check_big_grid_voxelizer(smi)
    check_bucketed(state_cpu, smi)
    serving = run_serving(state_cpu, smi)
    root = tempfile.mkdtemp(prefix="hard_data_")
    try:
        make_hard_split(root)
        serving["evaluate"] = run_evaluate(state_cpu, smi, root)
        run_train_step(state_cpu, smi, root)
        trainer_runs = run_trainer(smi, root, os.path.join(root, "runs"),
                                   args.train_clouds)
        second = run_second_sparse(smi, root)
        t15 = time.perf_counter()
        rpn_bf16 = check_rpn_kernel_bf16(cfg.model, rpn)
        bf16 = run_bf16_paths(state_cpu, batches, on_card,
                              {"dense": dense_times, "fast": fast_times})
        bf16["evaluate"] = run_bf16_evaluate(state_cpu, smi, root)
        bf16["second_sparse"] = run_bf16_second(root)
        print(f"phase 15 (bf16): {time.perf_counter() - t15:.1f} s")
        t16 = time.perf_counter()
        run_bf16_train_step(state_cpu, smi, root)
        bf16_trainer = run_bf16_trainer(
            smi, root, os.path.join(root, "runs_bf16"), args.train_clouds,
            trainer_runs[0])
        print(f"phase 16 (bf16 training): {time.perf_counter() - t16:.1f} s")
        parallel = run_parallel(state_cpu, smi, root)
        run_captured_train(state_cpu, smi, root)
        second_dense = run_second_dense(smi)
        kitti = run_kitti_second(smi)
        kitti3, kitti3_launches, nms["k1000"] = run_kitti3(smi)
        run_captured(state_cpu, smi)
        run_bench(smi)
        transfer = run_transfer(state_cpu, smi, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    nms["launches"] = dense["nms_keep_mask"]
    rpn["launches"] = fast["rpn_sep_block"]
    # kernel 2 in both dtypes, each a kernel of its own: the bfloat16
    # kernel's launches read around the bfloat16 fast path
    rpn["dtype"] = "float32"
    rpn_bf16["launches"] = bf16["fast"]["rpn_sep_block_bf16"]
    # the same counts on the serving and evaluation paths, each read around
    # its own run
    # the SECOND paths, each read around its own run
    second_paths = {
        "second_sparse": [second["B1"], second["B2"]],
        "second_eval": [second["eval"]],
        "second_dense": [second_dense["B1"], second_dense["B2"]],
        "kitti_second": [kitti]}
    nms["launches_by_path"] = {
        "dense": dense["nms_keep_mask"], "fast": fast["nms_keep_mask"],
        **{k: v["nms_keep_mask"] for k, v in serving.items()},
        "train_eval": sum(r["nms_launches"] for r in trainer_runs),
        "train_eval_bf16": bf16_trainer["nms_launches"],
        "transfer_eval": transfer["trainer"]["nms_launches"],
        **{k: sum(c["nms_keep_mask"] for c in v)
           for k, v in second_paths.items()},
        **{f"{k}_bf16": v["nms_keep_mask"] for k, v in bf16.items()},
        **{k: v["nms_keep_mask"] for k, v in parallel.items()},
        **kitti3_launches}
    rpn["launches_by_path"] = {
        "fast": fast["rpn_sep_block"],
        **{k: v["rpn_sep_block"] for k, v in serving.items()},
        **{k: sum(c["rpn_sep_block"] for c in v)
           for k, v in second_paths.items()},
        **{k: v["rpn_sep_block"] for k, v in parallel.items()},
        "kitti3_serve": kitti3["serve"]["counts"]["rpn_sep_block"],
        "kitti3_eval": kitti3["eval"]["launches"]["rpn_sep_block"]}
    rpn_bf16["launches_by_path"] = {
        f"{k}_bf16": v["rpn_sep_block_bf16"] for k, v in bf16.items()}
    bn_relu["launches"] = dense["bn_relu"]
    bn_relu["launches_by_path"] = {
        "dense": dense["bn_relu"], "fast": fast["bn_relu"],
        **{k: v["bn_relu"] for k, v in serving.items()},
        **{k: sum(c["bn_relu"] for c in v) for k, v in second_paths.items()},
        **{f"{k}_bf16": v["bn_relu"] for k, v in bf16.items()},
        **{k: v["bn_relu"] for k, v in parallel.items()},
        "kitti3_serve": kitti3["serve"]["counts"]["bn_relu"],
        "kitti3_eval": kitti3["eval"]["launches"]["bn_relu"]}
    pfn["launches"] = dense["pfn_max"]
    print(json.dumps({"kernels": [nms, rpn, rpn_bf16, bn_relu, pfn]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
