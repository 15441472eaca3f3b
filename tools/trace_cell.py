"""Run one cell of the port's benchmark (``port_bench``) with the port's
tracing on (``pillars_torch/utils/tracing.py``), and report the spans and
counters of the window's parts beside the benchmark's own result.

    python tools/trace_cell.py --workload d435i_sensor1 --seed 7 \
        --seconds 20 --trace 0|1 [--dump cell.trace.json]

from the root of a checkout, on the card (``--spans 0`` makes the same run
and report with tracing left off). Tracing is turned on before the cell's
set-up, so that the builds and the captures are spans and the
inference graph is captured with its device marks; the window's parts are
the benchmark's (``port_bench/loops/_window.py``: a timed part with the
profiler off, with ``--trace 1`` then a traced part under torch.profiler,
and in a cell whose metrics read the program's spans a marked part, during
which alone the benchmark keeps tracing on). It prints the benchmark's
result line with, under ``detail``:

- ``spans`` / ``spans_traced`` / ``spans_marked``: per span name of the
  timed / traced / marked part, ``count``, ``ms`` and ``ms_per_cloud``
  (the part's total over the clouds delivered in it); the ``device.*``
  totals per sampled cloud instead;
- ``counters`` / ``counters_traced`` / ``counters_marked``: what each
  counter added in the part;
- ``setup_spans``: the spans before the window opened (builds, captures);
- ``readings``: the per-layer numbers the timed part's spans give
  (:func:`readings`);
- ``graph_clock_ms_per_cloud`` and ``latency_mean_ms``: the benchmark's
  own clock of the timed part's replays, per slot, and its mean latency.

The parts and their readings are the benchmark's own (``record["parts"]``,
``_window.added``, ``metrics/_common.py``); this script adds the set-up's
spans, which the record does not keep, by reading the edge at the window's
opening in its own process.
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
sys.path.insert(0, str(ROOT))

from port_bench.loops._window import added, edge  # noqa: E402
from port_bench.metrics._common import (part_spans,  # noqa: E402
                                        stage_ms_per_cloud)

STAGES = ("voxelize", "pfn", "rpn", "post")


def _ms(spans: Dict, *names: str) -> Optional[float]:
    vals = [spans[n]["ms_per_cloud"] for n in names if n in spans]
    if len(vals) != len(names) or any(v is None for v in vals):
        return None
    return sum(vals)


def readings(timed: Dict, setup: Dict) -> Dict:
    """The per-layer numbers of the part ``timed`` (as ``added`` gives it,
    with the ``clouds`` delivered in it): the card's time per cloud of each
    stage of the inference graph (the benchmark's stage reader, handed this
    part), the host's dispatch (the capture wrapper's call and the fetch's
    enqueue) and the stream loop's take and staging per cloud; and from
    ``setup`` (the same, before the window) the builds and captures in
    seconds."""
    s = part_spans(timed, timed["clouds"])
    part = {"parts": {"marked": timed}}
    out = {f"{st}_ms_per_cloud": stage_ms_per_cloud(part, st)
           for st in STAGES}
    stages = list(out.values())
    out["stages_ms_per_cloud"] = (None if None in stages else sum(stages))
    out["device_replay_ms_per_cloud"] = _ms(s, "device.replay")
    out["dispatch_ms_per_cloud"] = _ms(s, "graph.call", "fetch.enqueue")
    out["stage_ms_per_cloud"] = _ms(s, "stream.take", "stream.stage")
    total = lambda n: (setup["spans"][n]["ns"] / 1e9  # noqa: E731
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
    from pillars_torch.utils import tracing
    from port_bench import harness
    from port_bench.loops import _window

    opened, records = [], []
    win = _window.Window
    orig = {k: getattr(win, k) for k in ("open", "record")}

    def open_(self):
        opened.append(edge())
        orig["open"](self)

    def record(self, *a, **kw):
        rec = orig["record"](self, *a, **kw)
        records.append(rec)
        return rec

    win.open, win.record = open_, record
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
    setup = dict(added({"spans": {}, "counters": {}}, opened[0]), clouds=1)
    d = out["detail"]
    for name, part in rec["parts"].items():
        suffix = "" if name == "timed" else f"_{name}"
        d[f"spans{suffix}"] = part_spans(part, part["clouds"])
        d[f"counters{suffix}"] = part["counters"]
    d["setup_spans"] = part_spans(setup, 1)
    d["readings"] = readings(rec["parts"]["timed"], setup)
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
