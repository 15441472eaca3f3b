"""Run one cell of the port's benchmark once.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It sets up ``pillars_torch`` for the cell's
configuration, serves the cell's traffic for ``--seconds`` (the window; set-up
and warm-up before it), judges every delivered answer against the plain
reference in ``port_bench/reference/``, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, read
from a part timed with the profiler off and a torch.profiler trace of the
part after it), ``device``, ``detail`` and ``checks`` (each compared number
with its limit, also the last lines on standard error).

It needs the card: without CUDA, or with fewer cards than the cell asks
for, it exits 3 and prints no result. It exits 4 and prints no result if,
once the window has closed, the process holds ``jax``, ``jaxlib``, ``flax``
or ``pillars_tpu``.
"""

import time

T_PROCESS = time.perf_counter()  # set-up starts with the process

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from port_bench import harness

    bench = harness.benchmark()
    wl = harness.workload(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(wl["chips"]):
        print(f"port_bench: the cell {args.workload} needs {wl['chips']} "
              f"CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), t_process=T_PROCESS, bench=bench)
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(harness.FORBIDDEN))
    if found:
        print(f"port_bench: the process holds {found}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
