"""Where the fused RPN block kernel's time goes, layer by layer, on the card.

    python -m pillars_torch.utils.kernel_phases [--dtype float32|bfloat16]
        [--batch 1] [--flush-l2] [--out FILE]

builds ``csrc/rpn_sep_block.cu`` with ``-DRPN_PHASE_CLOCKS`` (one thread of
CTA 0 stamps ``clock64()`` at the phase boundaries of every layer), runs
the three d435i blocks in one launch of the kernel that ``--dtype``
launches, on random inputs in that dtype and folded weights (NumPy seed
0), and prints, per layer, the SM cycles CTA 0 spent on: issuing the
copies of its input halo (and, in a block's first layer, of its weights);
waiting for them; the depthwise (and issuing the next layer's weight
prefetch); the pointwise product; the cross-warp reduction, bias, ReLU and
stores; and the grid barrier, and the SM clock those cycles ran at (the
span over the stamped launch's device time: a lower bound). The stamps
cost a few hundred cycles per layer, so the launch is also timed without
them. ``--flush-l2`` writes 256 MB between two launches, so that the
kernel finds its weights and input in device memory as it does inside the
inference path, where hundreds of other kernels run between two clouds.
Needs a card; the numbers name it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import numpy as np
import torch

PHASES = ("issue", "wait", "depthwise", "product", "epilogue", "barrier")
DEFINES = ("RPN_PHASE_CLOCKS",)


def d435i_blocks(mcfg, batch: int, seed: int = 0):
    """(x [B, H, W, C] on the card, the three packed blocks) at the d435i
    widths, random folded weights."""
    from pillars_torch.ops.rpn_blocks import FoldedLayer, pack_block

    rng = np.random.RandomState(seed)
    _, h, w = mcfg.feature_map_size
    cin = mcfg.pfn.num_filters
    x = torch.from_numpy(np.maximum(rng.randn(batch, h, w, cin), 0)
                         .astype(np.float32)).cuda()
    blocks = []
    for i in range(3):
        cout, n = mcfg.rpn.num_filters[i], mcfg.rpn.layer_nums[i]
        layers = []
        for j in range(n + 1):
            ci = cin if j == 0 else cout
            layers.append(FoldedLayer(*(
                torch.from_numpy(a.astype(np.float32)).cuda() for a in (
                    rng.randn(3, 3, ci), rng.randn(ci, cout) / np.sqrt(9 * ci),
                    rng.randn(cout) * 0.1))))
        blocks.append(pack_block(layers, n, mcfg.rpn.layer_strides[i]))
        cin = cout
    return x, blocks


def main():
    from pillars_torch.config import Config
    from pillars_torch.ops import _build, rpn_cuda
    from pillars_torch.utils.profiling import cuda_ms, device_busy

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--flush-l2", action="store_true",
                    help="write 256 MB between launches (cold L2)")
    ap.add_argument("--out", default=None, help="write the result as JSON")
    args = ap.parse_args()

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dtype = getattr(torch, args.dtype)
    x, blocks = d435i_blocks(Config.default().model, args.batch)
    x = x.to(dtype)
    n_layers = sum(b.num_layers + 1 for b in blocks)

    flush = (torch.empty(64 << 20, device="cuda") if args.flush_l2 else None)

    def run(defines=()):
        if flush is not None:
            flush.zero_()
        return rpn_cuda.fused_sep_chain(x, blocks, defines)

    def kernel_ms(defines=()):
        rows = device_busy(lambda: run(defines), 50)[2]
        return sum(ms for name, _, ms in rows if "rpn_sep_chain" in name)

    plain_ms = cuda_ms(run, 200)
    device_ms = kernel_ms()
    stamped_ms = kernel_ms(DEFINES)
    torch.cuda.synchronize()
    read = _build.load("rpn_sep_block", DEFINES).rpn_phase_clocks
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    buf = (ctypes.c_longlong * (n_layers * (len(PHASES) + 1)))()
    err = read(buf, n_layers)
    if err != 0:
        raise RuntimeError(f"reading the phase clocks failed: CUDA error {err}")
    stamps = np.array(buf[:], dtype=np.int64).reshape(n_layers, -1)
    cycles = np.diff(stamps, axis=1)
    cycles[-1, -1] = 0  # no barrier after the last layer
    span = int(stamps[-1, -2] - stamps[0, 0])

    print(card)
    print(f"{args.dtype} kernel, three blocks, B={args.batch}, one launch: "
          f"{device_ms * 1e3:.2f} us "
          f"device time{' after an L2 flush' if args.flush_l2 else ''} "
          f"({plain_ms * 1e3:.2f} us per back-to-back call); with "
          f"the stamps {stamped_ms * 1e3:.2f} us, {span} SM cycles from the "
          f"first stamp to the last (at least {span / stamped_ms / 1e6:.3f} "
          f"GHz)")
    print(f"{'layer':>5} " + " ".join(f"{p:>9}" for p in PHASES))
    for i, row in enumerate(cycles):
        print(f"{i:>5} " + " ".join(f"{int(c):>9}" for c in row))
    total = cycles.sum(axis=0)
    print(f"{'sum':>5} " + " ".join(f"{int(c):>9}" for c in total))
    print(f"{'share':>5} " + " ".join(f"{c / span:>9.3f}" for c in total)
          + f"   (of the span; {1 - total.sum() / span:.3f} between stamps)")
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps({
            "card": card, "dtype": args.dtype, "batch": args.batch,
            "flush_l2": args.flush_l2,
            "device_ms": device_ms,
            "call_ms": plain_ms, "stamped_device_ms": stamped_ms,
            "span_cycles": span, "phases": PHASES,
            "cycles": cycles.tolist()}, indent=1))


if __name__ == "__main__":
    main()
