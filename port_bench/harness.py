"""One run of one cell: set-up, the serving loop's window, the reference's
judgement, the metrics.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``port_bench/configs/<config>.json``: the configuration as run (the
  program's yaml, the checkpoint, the model section the reference reads);
- ``port_bench/traffic/<traffic>.json``: the mix's parameters, and
  ``loop``, the module of ``port_bench/loops/`` that serves it;
- ``port_bench/metrics/<metric>.py``: ``read(record)``, the metric's value
  or None where the run holds nothing to read;
- ``port_bench/limits/<workload>.json``: the limit of each number the
  comparison reads, with the readings it was set from.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from port_bench.metrics._common import device_idle_frac, host_ms_per_cloud

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "pillars_tpu")


def load_json(path: pathlib.Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def workload(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config_file(name: str) -> Dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic_file(name: str) -> Dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits_file(name: str) -> Dict:
    return load_json(HERE / "limits" / f"{name}.json")


def metric_reader(name: str):
    """``read`` of ``port_bench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench.metrics.{name.replace('.', '__')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def loop(name: str):
    return importlib.import_module(f"port_bench.loops.{name}")


def cell_metrics(bench: Dict, wl_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``wl_name`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in rows
            if "workloads" not in m or wl_name in m["workloads"]]


@dataclass
class Cell:
    """What a serving loop gets: the program set up for one configuration, the
    traffic's parameters and the bank of clouds made from the seed."""

    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    device: str
    t_process: float
    cfg: Any = None
    detector: Any = None
    state: Any = None
    bank: List[np.ndarray] = field(default_factory=list)


def program_config(config: Dict):
    """The program's ``Config`` of a configuration file, checked against the
    model section the reference reads."""
    from pillars_torch.config import Config

    cfg = Config.from_yaml(str(ROOT / config["yaml"]))
    for key, value in config["overrides"].items():
        cfg = cfg.override(key, value)
    if cfg.runtime.compute_dtype != config["dtype"]:
        raise RuntimeError(f"{config['name']}: the program computes in "
                           f"{cfg.runtime.compute_dtype}, the file states "
                           f"{config['dtype']}")
    return cfg


def set_up(cell: Cell) -> None:
    """The program's detector and the checkpoint's state on the device, and
    the bank (set-up, before any loop runs)."""
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.weights import from_jax_variables, load_params

    from port_bench.gen.bank import traffic_bank

    cell.cfg = program_config(cell.config)
    cell.detector = PillarsDetector(cell.cfg, device=cell.device)
    cell.state = cell.detector.state_to_device(from_jax_variables(
        *load_params(str(ROOT / cell.config["weights"])), cell.cfg))
    cell.bank = traffic_bank(cell.config["profile"], cell.traffic, cell.seed)


def judge(cell: Cell, record: Dict) -> Dict:
    """The reference's candidates for every cloud of the bank, and the
    comparison of every delivery with them."""
    from port_bench.reference.compare import run_gap
    from port_bench.reference.pointpillars import Reference

    ref = Reference(cell.config["model"], str(ROOT / cell.config["weights"]),
                    device=cell.device)
    cands = ref.run(cell.bank)
    record["cands"] = cands
    return run_gap(record["deliveries"], cands, cell.config["model"])


def free_program(cell: Cell) -> None:
    cell.detector = cell.state = None
    gc.collect()
    if cell.device != "cpu":
        import torch

        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run_cell(wl_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_process: Optional[float] = None,
             bench: Optional[Dict] = None, traffic_overrides=None) -> Dict:
    """One run of the cell ``wl_name``: the result line's dict, and
    ``checks`` (each compared number with its limit) last. ``device``
    "cpu" drives the program on the CPU (tests); the card's figures are
    then absent."""
    t_process = time.perf_counter() if t_process is None else t_process
    bench = bench or benchmark()
    wl = workload(bench, wl_name)
    traffic = dict(traffic_file(wl["traffic"]), **(traffic_overrides or {}))
    cell = Cell(config_file(wl["config"]), traffic, int(seed),
                float(seconds), bool(trace), device, t_process)
    set_up(cell)
    record = loop(traffic["loop"]).run(cell)
    record["model"] = cell.config["model"]
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": "cpu", "count": int(wl["chips"]),
           "memory_peak_bytes": 0}
    if device != "cpu":
        import torch

        dev["kind"] = torch.cuda.get_device_name(0)
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        dev["power_limit_w"] = _power_limit()
    record["device"] = dev
    free_program(cell)
    verdict = judge(cell, record)
    limits = limits_file(wl_name)["limits"]
    checks = {
        "detection_gap": {"value": verdict["detection_gap"],
                          "limit": limits["detection_gap"]},
        "undelivered": {"value": record["attempted"] - record["delivered"],
                        "limit": 0},
    }
    correct = (record["delivered"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    for m in cell_metrics(bench, wl_name, trace):
        value = metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    summary = record.get("trace")
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    out = {"correct": bool(correct), "attempted": int(record["attempted"]),
           "failed": int(record["attempted"] - record["delivered"]),
           "metrics": metrics, "device": dev,
           "detail": {"deliveries": verdict["deliveries"],
                      "distinct": verdict["distinct"],
                      "paired": verdict["paired"],
                      "unpaired": verdict["unpaired"],
                      "window_clouds": record["clouds"],
                      "per_second": record["per_second"],
                      "traced_per_s": record["traced_per_s"],
                      "replays": record["replays"],
                      "host_ms_per_cloud": host_ms_per_cloud(record),
                      "device_idle_frac": device_idle_frac(record),
                      "latency_ms": _percentiles(record["latencies_ms"]),
                      "setup_s": record["setup_s"]}}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["checks"] = checks
    return out


def _percentiles(latencies: List[float]) -> Optional[Dict[str, float]]:
    """p50, p95 and p99 of the window's latencies (the result's detail; a
    cell's end-to-end latency is its ``latency_p95_ms`` metric)."""
    if not latencies:
        return None
    return {f"p{q}": float(np.percentile(latencies, q)) for q in (50, 95, 99)}


def _power_limit() -> Optional[float]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
