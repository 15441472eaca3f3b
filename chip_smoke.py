"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, none of whose failures is caught:
1. build every CUDA kernel of the port from ``pillars_torch/csrc`` (one
   ``nvcc`` per source, all at once) and print the build seconds;
2. print the card's name and power limit (nvidia-smi);
3. each kernel against its plain PyTorch twin on the card, on random inputs
   at the main path's shapes and beyond (NMS keep-mask: B in {1, 4}, K in
   {100, 1000}, duplicate boxes and invalid rows; bit-equal), with warm
   CUDA-event times of kernel and twin at the d435i shape;
4. the main path: ``PillarsDetector(Config.default())`` with the trained
   checkpoint ``benchmarks/hard_synth/weights_59.pkl`` through
   ``make_inference_fn`` on d435i-sized clouds (19200 points, NumPy seed 0)
   at B=1 and B=2, with the kernels' launch counts read around that run;
   the head tensors against the same clouds through the port on the CPU,
   and the card's postprocess fed the CPU's head tensors against the CPU's
   predictions; then the warm ms/cloud at B=1.

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
    from pillars_torch.utils.profiling import cuda_ms

    rng = np.random.RandomState(0)
    max_err = 0.0
    for b in (1, 4):
        for k in (100, 1000):
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
    n_valid = int(valid.sum())
    n_bytes = bt.numel() * 4 + vt.numel() + vt.numel()
    # per valid pair j < i: 2 max, 2 min, 4 add/sub, 2 clamps, mul, add,
    # sub, div, compare; per valid box: its area (5)
    flops = 15 * n_valid * (n_valid - 1) // 2 + 5 * n_valid
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS * 1e3
    print(f"nms_keep_mask B=1 K=100: kernel {ms * 1e3:.2f} us, plain twin "
          f"{plain_ms * 1e3:.2f} us")
    return {"name": "nms_keep_mask", "route": "cuda",
            "source": "pillars_torch/csrc/nms_keep_mask.cu",
            "replaces": "pillars_tpu/ops/nms_pallas.py:24",
            "launches": None, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


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


def run_main_path():
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.ops import nms_cuda
    from pillars_torch.utils.profiling import cuda_ms
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = Config.default()
    thr = cfg.eval_input.anchor_area_threshold
    state_cpu = from_jax_variables(*load_params(str(WEIGHTS)), cfg)
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
    nms_cuda.nms_keep_mask.launches = 0
    outs = [fn(state, p, n, eye[p.shape[0]], eye[p.shape[0]])
            for p, n in on_card]
    torch.cuda.synchronize()
    launches = {"nms_keep_mask": nms_cuda.nms_keep_mask.launches}
    print(f"main path: {len(on_card)} batches, launches {launches}")
    if launches["nms_keep_mask"] < len(on_card):
        raise AssertionError("the main path did not run the NMS kernel")

    K = cfg.model.postprocess.nms_post_max_size
    for (p, _), out in zip(on_card, outs):
        b = p.shape[0]
        if (out.boxes_lidar.shape != (b, K, 7) or out.valid.shape != (b, K)
                or not out.valid.any()):
            raise AssertionError(f"unexpected predictions at B={b}")
        for t in (out.boxes_lidar, out.boxes_camera, out.scores):
            if not torch.isfinite(t[out.valid]).all():
                raise AssertionError("non-finite predictions")

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

    p1, n1 = on_card[0]
    ms = cuda_ms(lambda: fn(state, p1, n1, eye[1], eye[1]), 50)
    t0 = time.perf_counter()
    for _ in range(50):
        fn(state, p1, n1, eye[1], eye[1])
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / 50
    print(f"main path B=1: {ms:.3f} ms/cloud (CUDA events, warm), "
          f"{wall_ms:.3f} ms/cloud host wall")
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

    record = check_nms_kernel(Config.default().model.postprocess
                              .nms_iou_threshold)
    launches = run_main_path()
    record["launches"] = launches[record["name"]]
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
