"""Run one cell of the port's benchmark (``port_bench``) with the port's
tracing on (``pillars_torch/utils/tracing.py``), and report the spans and
counters of the window's parts beside the benchmark's own result.

    python tools/trace_cell.py --workload d435i_sensor1 --seed 7 \
        --seconds 20 --trace 0|1 [--dump cell.trace.json]

from the root of a checkout, on the card (``--spans 0`` makes the same run
and report with tracing left off). Tracing is turned on before the cell's
set-up, so that the builds and the captures are spans and the
inference graph is captured with its device marks; the window's parts are
the benchmark's (``port_bench/loops/_window.py``: with ``--trace 1`` a timed
part with the profiler off, then a traced part under torch.profiler, whose
idle gaps are then labelled by the program's spans). It prints the
benchmark's result line with, under ``detail``:

- ``spans`` / ``spans_traced``: per span name of the timed / traced part,
  ``count``, ``ms`` and ``ms_per_cloud`` (the part's total over the clouds
  delivered in it); the ``device.*`` totals per sampled cloud instead;
- ``counters`` / ``counters_traced``: what each counter added in the part;
- ``setup_spans``: the spans before the window opened (builds, captures);
- ``readings``: the per-layer numbers these spans give (:func:`readings`);
- ``graph_clock_ms_per_cloud`` and ``latency_mean_ms``: the benchmark's
  own clock of the timed part's replays, per slot, and its mean latency.

The benchmark's files are used as they are: this script wraps the window's
edges in its own process only.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import Dict, Optional

T_PROCESS = time.perf_counter()

ROOT = pathlib.Path(__file__).resolve().parent.parent
STAGES = ("voxelize", "pfn", "rpn", "post")


def _edge() -> Dict:
    from pillars_torch.utils import tracing

    return {"spans": tracing.snapshot(), "counters": tracing.counters()}


def part_spans(a: Dict, b: Dict, clouds: int) -> Dict:
    """Per span name, what the part between edges ``a`` and ``b`` added:
    ``count``, ``ms`` and ``ms_per_cloud`` (the ``device.*`` totals over
    the sampled clouds); and the counters it added."""
    counters = {k: v - a["counters"].get(k, 0)
                for k, v in b["counters"].items()
                if v != a["counters"].get(k, 0)}
    sampled = counters.get("device.sampled_clouds", 0)
    spans = {}
    for name, row in b["spans"].items():
        before = a["spans"].get(name, {"count": 0, "ns": 0})
        n, ns = row["count"] - before["count"], row["ns"] - before["ns"]
        if n <= 0:
            continue
        per = sampled if name.startswith("device.") else clouds
        spans[name] = {"count": n, "ms": ns / 1e6,
                       "ms_per_cloud": ns / 1e6 / per if per else None}
    return {"spans": spans, "counters": counters}


def _ms(spans: Dict, *names: str) -> Optional[float]:
    vals = [spans[n]["ms_per_cloud"] for n in names if n in spans]
    if len(vals) != len(names) or any(v is None for v in vals):
        return None
    return sum(vals)


def readings(timed: Dict, setup: Dict) -> Dict:
    """The per-layer numbers the timed part's spans give: the card's time
    per cloud of each stage of the inference graph, the host's dispatch
    (the capture wrapper's call and the fetch's enqueue) and the stream
    loop's take and staging per cloud, and the set-up's builds and
    captures in seconds."""
    s = timed["spans"]
    out = {f"{st}_ms_per_cloud": _ms(s, f"device.{st}") for st in STAGES}
    out["stages_ms_per_cloud"] = _ms(s, *(f"device.{st}" for st in STAGES))
    out["device_replay_ms_per_cloud"] = _ms(s, "device.replay")
    out["dispatch_ms_per_cloud"] = _ms(s, "graph.call", "fetch.enqueue")
    out["stage_ms_per_cloud"] = _ms(s, "stream.take", "stream.stage")
    total = lambda n: (setup["spans"][n]["ms"] / 1e3  # noqa: E731
                       if n in setup["spans"] else None)
    out["capture_s"] = total("graph.capture")
    out["build_s"] = total("build.extensions")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1,
                    help="0: leave tracing off (the same run and report, "
                         "for a comparison with tracing on)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default=None,
                    help="JSON of traffic parameters to replace (a CPU "
                         "rehearsal at a tiny size)")
    ap.add_argument("--dump", default=None,
                    help="write the spans of the run as a Chrome trace")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from pillars_torch.utils import tracing
    from port_bench import harness
    from port_bench.loops import _window

    edges, records = {}, []
    win = _window.Window
    orig = {k: getattr(win, k) for k in ("open", "_start_trace", "close",
                                           "record")}

    def open_(self):
        orig["open"](self)
        edges["open"] = _edge()

    def start_trace(self):
        edges["timed_end"] = _edge()
        orig["_start_trace"](self)

    def close(self):
        edges.setdefault("timed_end" if self.phase == "timed"
                         else "traced_end", _edge())
        orig["close"](self)

    def record(self, *a, **kw):
        rec = orig["record"](self, *a, **kw)
        records.append(rec)
        return rec

    win.open, win._start_trace, win.close, win.record = (
        open_, start_trace, close, record)
    if args.spans:
        tracing.enable()
    try:
        out = harness.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            device=args.device, t_process=T_PROCESS,
            traffic_overrides=(json.loads(args.overrides)
                               if args.overrides else None))
    finally:
        tracing.disable()
        for k, v in orig.items():
            setattr(win, k, v)
    rec = records[-1]
    zero = {"spans": {}, "counters": {}}
    setup = part_spans(zero, edges["open"], 1)
    timed = part_spans(edges["open"], edges["timed_end"], rec["clouds"])
    d = out["detail"]
    d["spans"], d["counters"] = timed["spans"], timed["counters"]
    d["setup_spans"] = setup["spans"]
    if "traced_end" in edges:
        traced = part_spans(edges["timed_end"], edges["traced_end"],
                            rec["traced_clouds"])
        d["spans_traced"] = traced["spans"]
        d["counters_traced"] = traced["counters"]
    d["readings"] = readings(timed, setup)
    # the benchmark's clock of the same replays, per slot of the graph
    d["graph_clock_ms_per_cloud"] = (rec["replay_ms"] / rec["slots"]
                                     if rec.get("replay_ms") else None)
    d["latency_mean_ms"] = (sum(rec["latencies_ms"]) / len(rec["latencies_ms"])
                            if rec["latencies_ms"] else None)
    if args.dump:
        d["dumped_spans"] = tracing.dump(args.dump)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
