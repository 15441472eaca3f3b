"""The benchmark's contract as functions of a benchmark and a tree: each
check takes ``(bench, here)`` -- the parsed ``BENCHMARK.json`` and the
benchmark's directory, where the harness finds each file by the name
``bench`` gives -- and, where it is made once per metric, cell or
configuration, that entry. A check raises ``AssertionError`` where the
benchmark breaks the contract.

The tests in ``test_port_bench_contract.py`` and
``test_port_bench_registry.py`` call them on ``BENCHMARK.json`` and
``harness.HERE``; ``test_port_bench_new_config.py`` calls :func:`failures`
on a copy to which a configuration of another architecture was added as
new files and entries.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import operator
import pathlib
import re
import sys
from typing import Dict, List

from port_bench import harness
# imported, so that the harness must hand back this module's class for the
# configurations that name no reference (:func:`_reference`)
from port_bench.reference import pointpillars  # noqa: F401

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
# the methods ``harness.checkpoint`` calls on a reference whose
# configuration's weights are ``{"seed": n}``
SEEDED = ("write_seeded", "layers", "seeded_trees")
# Keys of a configuration file's ``model`` section that the program holds
# elsewhere than at the same path under its ``Config.model``: the
# attribute path of each in the program's ``Config``. Every other key is
# compared at ``model.<key>``, derived values included (``voxel.grid_size``
# is ``VoxelConfig.grid_size``, worked out from the range and voxel size).
ELSEWHERE = {
    "anchor_generators": "model.target.generators",
    "anchor_area_threshold": "eval_input.anchor_area_threshold",
    "prediction_min_score": "runtime.prediction_min_score",
}


@contextlib.contextmanager
def looking_in(here: pathlib.Path):
    """The harness's loaders look in ``here`` while the block runs."""
    before = harness.HERE
    harness.HERE = pathlib.Path(here)
    try:
        yield
    finally:
        harness.HERE = before


def _config_file(here, name: str) -> Dict:
    with looking_in(here):
        return harness.config_file(name)


# ---------------------------------------------------------- the entries
def names(bench: Dict) -> List[str]:
    out = set()
    for c in bench["configs"]:
        out.add(c["name"])
        out.update(c["reduced"])
    for w in bench["workloads"]:
        out.update((w["name"], w["config"], w["traffic"]))
    for m in metrics(bench):
        out.add(m["name"])
    return sorted(out)


def metrics(bench: Dict) -> List[Dict]:
    return bench["end_to_end"] + bench["per_layer"]


# -------------------------------------------------------------- checks
def name_chars(bench, here, name: str) -> None:
    assert NAME.match(name), name


def metric_fields(bench, here, metric: Dict) -> None:
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    kind = "per_layer" if "layer" in metric else "end_to_end"
    assert set(metric) - {"workloads"} == KEYS[kind]
    if kind == "end_to_end":
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    if metric["name"].endswith("_roofline") or "_roofline." in metric["name"] \
            or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


def top_level_shape(bench, here) -> None:
    assert set(bench) == KEYS["top"]
    assert len(json.dumps(bench)) <= 64 * 1024
    assert bench["paths"] == ["port_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert all(set(c) == KEYS["config"] for c in bench["configs"])
    assert all(set(w) == KEYS["workload"] for w in bench["workloads"])
    for text in [w["why"] for w in bench["workloads"]] + [
            c["why"] for c in bench["configs"]] + [
            c["source"] for c in bench["configs"]] + bench["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    names_ = [m["name"] for m in metrics(bench)]
    assert len(names_) == len(set(names_))
    # every configuration used by some cell, every cell's configuration
    # listed
    assert {c["name"] for c in bench["configs"]} == {
        w["config"] for w in bench["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def run_seconds_fit(bench, here) -> None:
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def cells_report_enough(bench, here) -> None:
    for w in bench["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(bench, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert harness.cell_metrics(bench, w["name"], True), w["name"]


def per_layer_moves(bench, here, metric: Dict) -> None:
    moves = [m for m in bench["end_to_end"] if m["name"] == metric["moves"]]
    assert len(moves) == 1
    cells = metric.get("workloads", [w["name"] for w in bench["workloads"]])
    for cell in cells:
        reported = [m["name"] for m in harness.cell_metrics(bench, cell, False)]
        assert metric["moves"] in reported, (metric["name"], cell)


def one_layer_name(bench, here) -> None:
    layers: Dict[str, set] = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def has_a_reader(bench, here, metric: Dict) -> None:
    with looking_in(here):
        assert callable(harness.metric_reader(metric["name"]))


def cell_files(bench, here, wl: Dict) -> None:
    """The configuration, traffic, loop and limits files of a cell, and the
    configuration's weights (:func:`weights`)."""
    with looking_in(here):
        config = harness.config_file(wl["config"])
        assert config["name"] == wl["config"]
        traffic = harness.traffic_file(wl["traffic"])
        assert callable(harness.loop(traffic["loop"]).run)
        limits = harness.limits_file(wl["name"])["limits"]
    assert limits["detection_gap"] > 0
    entry = [c for c in bench["configs"] if c["name"] == wl["config"]][0]
    assert (pathlib.Path(here).parent / entry["file"]).resolve() == (
        pathlib.Path(here) / "configs" / f"{wl['config']}.json").resolve()
    assert entry["reduced"] == config["reduced"]
    assert all(key in config["assumed"] for key in config["reduced"])
    weights(bench, here, entry)


def weights(bench, here, entry: Dict) -> None:
    """A checkpoint file under the repo, or ``{"seed": <int>}`` whose
    reference class has the methods that write seeded weights."""
    data = _config_file(here, entry["name"])
    w = data["weights"]
    if isinstance(w, str):
        assert (harness.ROOT / w).is_file(), f"weights: no file {w}"
        return
    assert isinstance(w, dict) and set(w) == {"seed"}, f"weights: {w!r}"
    seed = w["seed"]
    assert isinstance(seed, int) and not isinstance(seed, bool), \
        f"weights: seed {seed!r} is not a whole number"
    ref = _reference(here, entry)
    missing = [m for m in SEEDED if not callable(getattr(ref, m, None))]
    assert not missing, f"weights: {ref} has no {missing}"


def _reference(here, entry: Dict):
    """The ``Reference`` that judges the configuration: that of the module
    the file names, or of ``pointpillars`` where it names none."""
    data = _config_file(here, entry["name"])
    name = data.get("reference", "pointpillars")
    path = pathlib.Path(here) / "reference" / f"{name}.py"
    assert path.is_file(), f"reference: no module {path}"
    assert harness.reference_name(data) == name
    with looking_in(here):
        ref = harness.reference_class(data)
    # the harness loads <here>/reference/<name>.py under this module name,
    # and hands back the class of that module where it is already imported
    assert ref.__module__ == f"port_bench.reference.{name}", \
        f"reference: {ref} is not {path}'s"
    module = sys.modules.get(ref.__module__)
    if module is not None and \
            pathlib.Path(module.__file__).resolve() == path.resolve():
        assert ref is module.Reference, f"reference: a second copy of {path}"
    return ref


def reference_resolves(bench, here, entry: Dict) -> None:
    """The configuration resolves to its reference module; a checkpoint
    file is the path the program and the reference read."""
    _reference(here, entry)
    data = _config_file(here, entry["name"])
    if isinstance(data["weights"], str):
        cell = harness.Cell(data, {}, 1, 1.0, False, "cpu", 0.0)
        assert harness.checkpoint(cell) == str(harness.ROOT / data["weights"])
        assert cell.scratch is None


def reference_runs(bench, here, entry: Dict) -> None:
    """The reference module's ``Reference`` is a class with ``run``."""
    ref = _reference(here, entry)
    assert inspect.isclass(ref), ref
    assert callable(getattr(ref, "run", None)), f"reference: {ref} has no run"


def model_section(bench, here, entry: Dict) -> None:
    """Every key of the file's ``model`` section, the reference's view of
    the network, equals the program's ``Config`` of the yaml and overrides
    the file names: at ``model.<key>``, or where :data:`ELSEWHERE` puts
    it. A key the program does not hold fails, unless the file's
    ``reference_own`` names it (``{"<key>": "<why>"}``, a nested key as
    ``section.key``): a key that the reference alone reads."""
    from pillars_torch.config import Config

    data = _config_file(here, entry["name"])
    own = data.get("reference_own", {})
    assert all(isinstance(why, str) and why for why in own.values()), \
        f"reference_own: a key without its reason: {own}"
    cfg = harness.program_config(data)
    assert isinstance(cfg, Config)
    assert cfg.model.postprocess.use_direction_classifier
    for key, value in data["model"].items():
        if key not in own:
            path = ELSEWHERE.get(key, f"model.{key}")
            _same(value, _get(cfg, path, key), key, own)


def _get(obj, path: str, key: str):
    try:
        return operator.attrgetter(path)(obj)
    except AttributeError:
        raise AssertionError(f"model.{key}: the program holds no {path}") \
            from None


def _same(value, got, key: str, own: Dict[str, str]) -> None:
    """``value`` of the file's key ``key`` against the program's ``got``:
    sections key by key (but the keys in ``own``), lists item by item,
    numbers, flags and strings exactly."""
    if isinstance(value, dict):
        for k, v in value.items():
            sub = f"{key}.{k}"
            if sub not in own:
                _same(v, _get(got, k, sub), sub, own)
    elif isinstance(value, list):
        assert isinstance(got, (list, tuple)) and len(got) == len(value), \
            f"model.{key}: {value} against the program's {got}"
        for i, (v, g) in enumerate(zip(value, got)):
            _same(v, g, f"{key}[{i}]", own)
    else:
        assert isinstance(value, bool) == isinstance(got, bool) \
            and value == got, f"model.{key}: {value!r} against the " \
            f"program's {got!r}"


# the checks, each with the entries it is made for (None: once)
CHECKS = (
    (name_chars, names),
    (metric_fields, metrics),
    (top_level_shape, None),
    (run_seconds_fit, None),
    (cells_report_enough, None),
    (per_layer_moves, operator.itemgetter("per_layer")),
    (one_layer_name, None),
    (has_a_reader, metrics),
    (cell_files, operator.itemgetter("workloads")),
    (model_section, operator.itemgetter("configs")),
    (reference_resolves, operator.itemgetter("configs")),
    (reference_runs, operator.itemgetter("configs")),
)


def failures(bench: Dict, here: pathlib.Path) -> List[str]:
    """Every check over every entry it is made for: one line for each that
    fails, ``<check>[<entry>]: <what failed>``."""
    out = []
    for check, entries in CHECKS:
        for item in [None] if entries is None else entries(bench):
            args = () if item is None else (item,)
            try:
                check(bench, here, *args)
            except Exception as exc:  # a check that cannot run has failed
                label = "" if item is None else \
                    f"[{item if isinstance(item, str) else item['name']}]"
                out.append(f"{check.__name__}{label}: "
                           f"{type(exc).__name__}: {exc}")
    return out
