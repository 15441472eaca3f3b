"""The control of the comparison: the reference put in the program's place
and computed in the precision below the configuration's (float32 with TF32
on, where the configuration states float32 with TF32 off). Its detection
gap against the float32 reference, over a cell's own bank, is the upper
reading of the cell's limit (``port_bench/limits/<cell>.json``); the
benchmark's runs do not run it.

    python3 -m port_bench.control --workload d435i_sensor1 --seeds 1 2 3

prints one JSON line per seed (on the card; the CPU has no TF32).
"""

from __future__ import annotations

import argparse
import json

from port_bench import harness


def control_gap(wl_name: str, seed: int, device: str = "cuda") -> dict:
    """The detection gap of the TF32 reference's served detections against
    the float32 reference's, on the cell's bank for ``seed``."""
    import shutil

    from port_bench.gen.bank import traffic_bank
    from port_bench.reference.compare import run_gap
    from port_bench.reference.pointpillars import served

    wl = harness.workload(harness.benchmark(), wl_name)
    config = harness.config_file(wl["config"])
    traffic = harness.traffic_file(wl["traffic"])
    bank = traffic_bank(config["profile"], traffic, seed)
    cell = harness.Cell(config, traffic, seed, 0.0, False, device, 0.0)
    try:
        ref = harness.reference_class(config)(
            config["model"], harness.checkpoint(cell), device=device)
    finally:
        if cell.scratch is not None:
            shutil.rmtree(cell.scratch, ignore_errors=True)
    cands = ref.run(bank)
    low = ref.run(bank, tf32=True)
    deliveries = [(i, *served(c)) for i, c in enumerate(low)]
    out = run_gap(deliveries, cands, config["model"])
    out.update(workload=wl_name, seed=seed)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for wl in args.workload:
        for seed in args.seeds:
            print(json.dumps(control_gap(wl, seed)), flush=True)


if __name__ == "__main__":
    main()
