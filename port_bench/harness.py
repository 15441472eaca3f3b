"""One run of one cell: set-up, the serving loop's window, the reference's
judgement, the metrics.

Everything that belongs to one configuration, traffic mix, metric or cell
sits in a file of its own, found by the name ``BENCHMARK.json`` gives:

- ``port_bench/configs/<config>.json``: the configuration as run: the
  program's ``yaml`` and its ``overrides``, ``dtype``, the traffic
  ``profile``, the ``model`` section the reference reads, and

  - ``weights``: a checkpoint file, or ``{"seed": n}``: a checkpoint that
    the configuration's reference writes at set-up from n
    (``Reference.write_seeded``), which the program and the reference then
    read as they read a trained one;
  - ``reference`` (optional, default ``pointpillars``): the module of
    ``port_bench/reference/`` whose ``Reference(model, checkpoint,
    device)`` judges the configuration; its ``run(clouds)`` gives each
    cloud's ``Candidates`` (with ``flops``, its own count of the cloud's
    forward pass, which the ``mfu`` metrics read);
- ``port_bench/traffic/<traffic>.json``: the mix's parameters, and
  ``loop``, the module of ``port_bench/loops/`` that serves it;
- ``port_bench/metrics/<metric>.py``: ``read(record)``, the metric's value
  or None where the run holds nothing to read;
- ``port_bench/limits/<workload>.json``: the limit of each number the
  comparison reads, with the readings it was set from.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from port_bench.metrics._common import (device_idle_frac, host_ms_per_cloud,
                                       part_spans)

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "pillars_tpu")
# clouds of the cell's traffic that calibrate seeded weights
CALIBRATION_CLOUDS = 4


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


def reference_name(config: Dict) -> str:
    return config.get("reference", "pointpillars")


def reference_class(config: Dict):
    """``Reference`` of ``port_bench/reference/<module>.py``, the module the
    configuration names (module docstring)."""
    name = reference_name(config)
    path = HERE / "reference" / f"{name}.py"
    key = f"port_bench.reference.{name}"
    module = sys.modules.get(key)
    if module is None or pathlib.Path(module.__file__).resolve() != \
            path.resolve():
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    return module.Reference


def cell_metrics(bench: Dict, wl_name: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``wl_name`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    rows = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in rows
            if "workloads" not in m or wl_name in m["workloads"]]


def takes_marks(bench: Dict, wl_name: str, trace: bool) -> bool:
    """Whether a run of ``wl_name`` turns the program's tracing on: a
    ``--trace 1`` run of a cell that reports a per-layer metric read from
    the program's spans (``source`` ``program_span``)."""
    return trace and any(m["source"] == "program_span"
                         for m in cell_metrics(bench, wl_name, True))


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
    # the program's tracing, turned on by the harness for this run: on
    # through set-up (the graphs are captured with their device marks), off
    # in the timed and traced parts, on in the marked part after them
    # (loops/_window.py)
    marks: bool = False
    checkpoint: Optional[str] = None
    scratch: Optional[str] = None  # a seeded checkpoint's directory
    writer_s: float = 0.0  # the seeded checkpoint's writer, not set-up
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


def checkpoint(cell: Cell) -> str:
    """The checkpoint file the program and the reference read: the file the
    configuration's ``weights`` names, or for ``{"seed": n}`` the one its
    reference writes from n, calibrated on :data:`CALIBRATION_CLOUDS` clouds
    of the cell's traffic made from n, into a directory of ``TMPDIR``
    (``cell.scratch``, which ``run_cell`` removes). The writer is the
    reference's, not the program's: its seconds (``cell.writer_s``, the
    CUDA context left out, which the program's set-up would make) are not
    set-up, its cuBLAS workspaces are released and the card's peak is
    reset after it."""
    weights = cell.config["weights"]
    if isinstance(weights, str):
        return str(ROOT / weights)
    from port_bench.gen.bank import traffic_bank

    if cell.device != "cpu":
        import torch

        torch.cuda.synchronize(cell.device)  # makes the CUDA context
    t0 = time.perf_counter()
    seed = int(weights["seed"])
    clouds = traffic_bank(cell.config["profile"],
                          dict(cell.traffic, bank=CALIBRATION_CLOUDS), seed)
    cell.scratch = tempfile.mkdtemp(prefix="port_bench_weights_")
    path = os.path.join(cell.scratch, "seeded.pkl")
    reference_class(cell.config).write_seeded(
        cell.config["model"], seed, clouds, path, device=cell.device)
    if cell.device != "cpu":
        torch.cuda.synchronize()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    cell.writer_s = time.perf_counter() - t0
    return path


def set_up(cell: Cell) -> None:
    """The checkpoint, the program's detector and its state on the device,
    and the bank (set-up, before any loop runs). A seeded checkpoint's
    writer is not set-up: the process's clock moves past it."""
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.weights import from_jax_variables, load_params

    from port_bench.gen.bank import traffic_bank

    cell.checkpoint = checkpoint(cell)
    cell.t_process += cell.writer_s
    cell.cfg = program_config(cell.config)
    cell.detector = PillarsDetector(cell.cfg, device=cell.device)
    cell.state = cell.detector.state_to_device(from_jax_variables(
        *load_params(cell.checkpoint), cell.cfg))
    cell.bank = traffic_bank(cell.config["profile"], cell.traffic, cell.seed)


def judge(cell: Cell, record: Dict) -> Dict:
    """The candidates of the configuration's reference for every cloud of
    the bank, and the comparison of every delivery with them."""
    from port_bench.reference.compare import run_gap

    ref = reference_class(cell.config)(cell.config["model"], cell.checkpoint,
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
    then absent. The program's spans and device marks
    (``pillars_torch.utils.tracing``) are turned on only where
    :func:`takes_marks` says, and then only in set-up and the window's
    marked part (``Cell.marks``); tracing that the caller turned on is left
    as it is."""
    t_process = time.perf_counter() if t_process is None else t_process
    bench = bench or benchmark()
    wl = workload(bench, wl_name)
    traffic = dict(traffic_file(wl["traffic"]), **(traffic_overrides or {}))
    cell = Cell(config_file(wl["config"]), traffic, int(seed),
                float(seconds), bool(trace), device, t_process)
    try:
        return _run(cell, bench, wl)
    finally:
        if cell.scratch is not None:
            shutil.rmtree(cell.scratch, ignore_errors=True)


def _run(cell: Cell, bench: Dict, wl: Dict) -> Dict:
    from pillars_torch.utils import tracing

    cell.marks = (takes_marks(bench, wl["name"], cell.trace)
                  and not tracing.enabled())
    with (tracing.tracing_on() if cell.marks else contextlib.nullcontext()):
        set_up(cell)
        record = loop(cell.traffic["loop"]).run(cell)
    record["model"] = cell.config["model"]
    device = cell.device
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
    limits = limits_file(wl["name"])["limits"]
    checks = {
        "detection_gap": {"value": verdict["detection_gap"],
                          "limit": limits["detection_gap"]},
        "undelivered": {"value": record["attempted"] - record["delivered"],
                        "limit": 0},
    }
    correct = (record["delivered"] > 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    metrics = {}
    for m in cell_metrics(bench, wl["name"], cell.trace):
        value = metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    summary = record.get("trace")
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    # the spans and counters of the run's last part: the marked one, where
    # the run has one (Cell.marks)
    part = list(record["parts"].values())[-1]
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
                      "setup_s": record["setup_s"],
                      "spans": part_spans(part, part["clouds"]),
                      "counters": part["counters"]}}
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
