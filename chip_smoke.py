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
   ms/cloud at B=1, and its kernel launches and device time per cloud.

Prints the kernel table as one JSON line, then, as the last line,
``{"ok": true, "device": {...}}``. Exits non-zero without a card, or when
the port is not beside this script.
"""

import json
import pathlib
import subprocess
import sys
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
        lambda: nms_cuda.nms_keep_mask(bt, vt, iou_threshold), 200)[1]
    floor_ms = device_busy(nms_cuda.launch_floor, 200)[1]
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
        dev = {name: [device_busy(lambda i=i: f(i, xin[i]), 50)[1]
                      for i in range(3)]
               for name, f, xin in (("kernel", kernel, xs),
                                    ("cudnn", cudnn, nchw))}
        _, dev_ms, rows = device_busy(
            lambda: rpn_cuda.fused_sep_chain(xs[0], packed), 50)
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
    _, device, rows = device_busy(lambda: fn(state, p, n, eye, eye), 20)
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
    nms["launches"] = dense["nms_keep_mask"]
    rpn["launches"] = fast["rpn_sep_block"]
    print(json.dumps({"kernels": [nms, rpn]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
