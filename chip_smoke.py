"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

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
4. the dense-cell main path: ``PillarsDetector(Config.default())`` with the
   trained checkpoint ``benchmarks/hard_synth/weights_59.pkl`` through
   ``make_inference_fn`` on d435i-sized clouds (19200 points, NumPy seed 0)
   at B=1 and B=2, with the kernels' launch counts set to 0 before that run
   and read after it; the head tensors against the same clouds through the
   port on the CPU, and the card's postprocess fed the CPU's head tensors
   against the CPU's predictions; then the warm ms/cloud at B=1;
5. the point-major fast path: the same config with ``model.pfn.dense_cell``
   false and ``model.rpn.use_pallas_blocks`` true, the same checkpoint and
   clouds, launch counts set to 0 before and read after (the fused blocks
   and NMS once each per batch); its head tensors against the port on the
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
9. evaluation: the hard validation split of benchmarks/hard_synth/README.md
   regenerated through the port's ``synth-data`` into a temporary directory,
   its checksum, the port's ``Evaluator`` over its 150 clouds on the card,
   the AP matrix, the stage times, and the aggregate score against the
   golden value of tests/golden/torch_hard_val_ap.json (the JAX package on
   the CPU in f32) within ``AP_TOL``.

Prints the kernel table as one JSON line, then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero without a card, or when
the port is not beside this script.
"""

import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
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
    bt = torch.from_numpy(boxes).cuda()
    vt = torch.from_numpy(valid).cuda()
    ms = cuda_ms(lambda: nms_cuda.nms_keep_mask(bt, vt, iou_threshold), 500)
    plain_ms = cuda_ms(lambda: keep_mask_plain(bt, vt, iou_threshold), 20)
    device_ms = device_busy(
        lambda: nms_cuda.nms_keep_mask(bt, vt, iou_threshold), 200,
        "nms_keep_mask_kernel")[1]
    floor_ms = device_busy(nms_cuda.launch_floor, 200, "empty_kernel")[1]
    floor_call_ms = cuda_ms(nms_cuda.launch_floor, 500)
    n_valid = int(valid.sum())
    n_bytes = bt.numel() * 4 + vt.numel() + vt.numel()
    # per valid pair j < i: 2 max, 2 min, 4 add/sub, 2 clamps, mul, add,
    # sub, div, compare; per valid box: its area (5)
    flops = 15 * n_valid * (n_valid - 1) // 2 + 5 * n_valid
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    print(f"nms_keep_mask B=1 K=100: kernel {ms * 1e3:.2f} us per call, "
          f"{device_ms * 1e3:.2f} us device time (torch.profiler); an empty "
          f"kernel of one block {floor_call_ms * 1e3:.2f} us per call, "
          f"{floor_ms * 1e3:.2f} us device time; plain twin "
          f"{plain_ms * 1e3:.2f} us")
    return {"name": "nms_keep_mask", "route": "cuda",
            "source": "pillars_torch/csrc/nms_keep_mask.cu",
            "replaces": "pillars_tpu/ops/nms_pallas.py:24",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "device_ms": device_ms,
            "launch_floor_device_ms": floor_ms}


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


def _block_work(b, h, w, cin, cout, n, stride):
    """(f32 operations, bytes) one fused block needs: per output pixel and
    layer the depthwise (9 multiply-adds per input channel), the pointwise
    (C_in multiply-adds per output channel), bias and ReLU; the input read
    once, the output and every weight written or read once."""
    px = b * (h // stride) * (w // stride)
    flops, n_bytes = 0, 4 * (b * h * w * cin + px * cout)
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
        _, dev_ms, rows = device_busy(
            lambda: rpn_cuda.fused_sep_chain(xs[0], packed), 50,
            "rpn_sep_chain_kernel")
        _, cudnn_dev_ms, cudnn_rows = device_busy(
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


def _reset_counts():
    from pillars_torch.ops import nms_cuda, rpn_cuda

    nms_cuda.nms_keep_mask.launches = 0
    rpn_cuda.fused_sep_block.launches = 0


def _read_counts():
    from pillars_torch.ops import nms_cuda, rpn_cuda

    return {"nms_keep_mask": nms_cuda.nms_keep_mask.launches,
            "rpn_sep_block": rpn_cuda.fused_sep_block.launches}


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


def _warm_ms(fn, state, p, n, eye, label):
    from pillars_torch.utils.profiling import cuda_ms, device_busy

    ms = cuda_ms(lambda: fn(state, p, n, eye, eye), 50)
    t0 = time.perf_counter()
    for _ in range(50):
        fn(state, p, n, eye, eye)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 50
    print(f"{label} B=1: {ms:.3f} ms/cloud (CUDA events, warm), "
          f"{wall_ms:.3f} ms/cloud host wall")
    _, device, rows = device_busy(lambda: fn(state, p, n, eye, eye), 20,
                                  "nms_keep_mask_kernel")
    print(f"{label} B=1: {sum(c for _, c, _ in rows):g} kernel launches and "
          f"{device:.4f} ms of device time per cloud (torch.profiler)")


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
    _warm_ms(fn, state, *on_card[0], eye[1], "dense-cell path")
    return launches, batches, on_card, outs


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
    _warm_ms(fn, state, *on_card[0], eye[1], "point-major fast path")
    return launches


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


def run_evaluate(state_cpu, smi):
    """Offline evaluation on the card against the golden AP; returns the
    NMS launches of the run."""
    from pillars_torch import cli
    from pillars_torch.config import Config
    from pillars_torch.data.synthetic import split_checksum
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.trainer import Evaluator

    golden = json.loads(GOLDEN.read_text())
    root = tempfile.mkdtemp(prefix="hard_data_")
    try:
        t0 = time.perf_counter()
        cli.main(["synth-data", "--root", root, "--num-train", "600",
                  "--num-test", "150", "--profile", "hard", "--seed", "7"])
        checksum = split_checksum(root)
        print(f"hard val split regenerated in "
              f"{time.perf_counter() - t0:.1f} s, sha256 {checksum}")
        if checksum != golden["val_checksum"]:
            raise AssertionError("the regenerated val split is not the "
                                 "golden value's")
        cfg = Config.default()
        for key, value in (("eval_input.dataset_root", root),
                           ("eval_input.info_path",
                            f"{root}/kitti_infos_val.pkl")):
            cfg = cfg.override(key, value)
        det = PillarsDetector(cfg)
        ev = Evaluator(cfg, det, measure_time=True)
        _reset_counts()
        t0 = time.perf_counter()
        text, bev, d3, aos, score = ev.evaluate(
            det.state_to_device(state_cpu))
        seconds = time.perf_counter() - t0
        launches = _read_counts()
    finally:
        shutil.rmtree(root, ignore_errors=True)
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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

    from pillars_torch.config import Config
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = Config.default()
    nms = check_nms_kernel(cfg.model.postprocess.nms_iou_threshold)
    rpn = check_rpn_kernel(cfg.model)
    state_cpu = from_jax_variables(*load_params(str(WEIGHTS)), cfg)
    dense, batches, on_card, outs = run_main_path(state_cpu)
    fast = run_fast_path(state_cpu, batches, on_card, outs)
    check_big_grid_voxelizer(smi)
    check_bucketed(state_cpu, smi)
    serving = run_serving(state_cpu, smi)
    serving["evaluate"] = run_evaluate(state_cpu, smi)
    nms["launches"] = dense["nms_keep_mask"]
    rpn["launches"] = fast["rpn_sep_block"]
    # the same counts on the serving and evaluation paths, each read around
    # its own run
    nms["launches_by_path"] = {
        "dense": dense["nms_keep_mask"], "fast": fast["nms_keep_mask"],
        **{k: v["nms_keep_mask"] for k, v in serving.items()}}
    rpn["launches_by_path"] = {
        "fast": fast["rpn_sep_block"],
        **{k: v["rpn_sep_block"] for k, v in serving.items()}}
    print(json.dumps({"kernels": [nms, rpn]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
