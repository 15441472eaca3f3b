"""A configuration of another architecture joins the benchmark with new
files and entries only: in a copy of the benchmark's tree, a reference
module of its own, a configuration that names it with seeded weights and a
model section the PointPillars files do not carry, a traffic mix, limits
and a reader of the program's spans, and the entries a cell-adding change
makes in ``BENCHMARK.json``, pass every check of ``contract.py`` and run
``correct``; each fault of such an addition fails the contract."""

import hashlib
import json
import shutil

import pytest
import torch

from port_bench import harness
from port_bench.tests import contract

CONFIG, CELL, READER = "pillars_nomid", "nomid_sensor1", \
    "graph_ms_per_cloud.replay"
# the layer of the model path as BENCHMARK.json names it
LAYER = ("model path and capture wrapper: models/detector.py "
         "make_inference_fn, cuda_graph.py")

# A reference that reads a section of the model the PointPillars reference
# does not: it judges only a network without a middle between the pillar
# features and the RPN, and records the section on each construction.
NO_MIDDLE = """
import json
import pathlib

from port_bench.reference.pointpillars import Reference as PointPillars

BUILT = pathlib.Path(__file__).with_suffix(".built")


class Reference(PointPillars):
    def __init__(self, model, checkpoint, device="cpu"):
        if model["middle"]["enabled"]:
            raise ValueError("this reference has no middle")
        super().__init__(model, checkpoint, device)
        with open(BUILT, "a") as f:
            f.write(json.dumps(model["middle"]) + "\\n")
"""
READER_SOURCE = """
import functools

from port_bench.metrics._common import stage_ms_per_cloud

read = functools.partial(stage_ms_per_cloud, stage="replay")
"""


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of the benchmark's data files and BENCHMARK.json, where the
    harness looks."""
    here = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "metrics", "limits", "reference"):
        shutil.copytree(harness.HERE / sub, here / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    monkeypatch.setattr(harness, "HERE", here)
    return here


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).digest()
            for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add(here):
    """The new files of the configuration and its cell, and the copy's
    BENCHMARK.json with their entries appended; the bench returned."""
    (here / "reference" / f"{CONFIG}.py").write_text(NO_MIDDLE)
    cfg = json.loads((here / "configs" / "pedestrian_d435i.json").read_text())
    cfg.update(name=CONFIG, reference=CONFIG, weights={"seed": 2**31 + 17})
    cfg["model"]["middle"] = {"enabled": False, "sparse": False}
    (here / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "closed_loop_b1_bank64.json")
                     .read_text())
    mix.update(bank=6, warmup=3)
    (here / "traffic" / "closed_loop_b1_bank6.json").write_text(
        json.dumps(mix))
    (here / "limits" / f"{CELL}.json").write_text(
        json.dumps({"limits": {"detection_gap": 3e-4}}))
    (here / "metrics" / f"{READER}.py").write_text(READER_SOURCE)

    path = here.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["configs"].append({
        "name": CONFIG, "source": "https://arxiv.org/abs/1812.05784",
        "file": f"port_bench/configs/{CONFIG}.json", "reduced": [],
        "why": "PointPillars judged by a reference that reads the middle"})
    bench["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "closed_loop_b1_bank6",
        "chips": 1, "why": "one sensor, batch 1, seeded weights"})
    bench["per_layer"].append({
        "name": READER, "unit": "ms", "better": "lower",
        "source": "program_span", "layer": LAYER, "moves": "replay_ms",
        "workloads": [CELL]})
    for m in contract.metrics(bench):
        if m["name"] in ("replay_ms", "device_ms_per_cloud.replay",
                         "kernels_per_cloud.replay"):
            m["workloads"].append(CELL)
    path.write_text(json.dumps(bench, indent=1))
    return bench


def _config(here, **update):
    path = here / "configs" / f"{CONFIG}.json"
    cfg = json.loads(path.read_text())
    cfg.update(update)
    path.write_text(json.dumps(cfg))
    return cfg


def test_a_configuration_of_another_architecture_joins_as_new_files(tree):
    before = _digests(tree)
    bench = _add(tree)
    after = _digests(tree)
    assert {k: after[k] for k in before} == before

    assert contract.failures(bench, tree) == []
    read = harness.metric_reader(READER)
    marked = {"spans": {"device.replay": {"ns": 3e6}},
              "counters": {"device.sampled_clouds": 2}}
    assert read({"parts": {"marked": marked}}) == 1.5
    assert read({"parts": {}}) is None

    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        out = harness.run_cell(CELL, 2**31 + 5, 1.5, False, device="cpu",
                               bench=bench)
    finally:
        torch.set_num_threads(threads)
    assert out["correct"], out["checks"]
    assert out["detail"]["paired"] > 0
    # built to write the seeded checkpoint and to judge, reading the middle
    built = (tree / "reference" / f"{CONFIG}.built").read_text().split("\n")
    assert [json.loads(x) for x in built if x] == \
        [{"enabled": False, "sparse": False}] * 2


def _model_value(here, bench):
    cfg = json.loads((here / "configs" / f"{CONFIG}.json").read_text())
    cfg["model"]["middle"]["enabled"] = True
    _config(here, model=cfg["model"])


def _no_reference(here, bench):
    (here / "reference" / f"{CONFIG}.py").unlink()


def _moves_unreported(here, bench):
    for m in bench["per_layer"]:
        if m["name"] == "host_ms_per_cloud.latency":
            m["workloads"].append(CELL)


MUTATIONS = {
    "model_value": (_model_value, {f"model_section[{CONFIG}]"}),
    "no_reference": (_no_reference, {
        f"cell_files[{CELL}]", f"reference_resolves[{CONFIG}]",
        f"reference_runs[{CONFIG}]"}),
    "seed_not_int": (lambda here, bench: _config(here, weights={"seed": "x"}),
                     {f"cell_files[{CELL}]"}),
    "seed_extra_key": (
        lambda here, bench: _config(here, weights={"seed": 1, "file": "x"}),
        {f"cell_files[{CELL}]"}),
    "weights_no_file": (
        lambda here, bench: _config(here, weights="benchmarks/none.pkl"),
        {f"cell_files[{CELL}]"}),
    "moves_unreported": (_moves_unreported,
                         {"per_layer_moves[host_ms_per_cloud.latency]"}),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_the_contract_refuses_a_faulty_addition(tree, mutation):
    bench = _add(tree)
    mutate, expected = MUTATIONS[mutation]
    mutate(tree, bench)
    failed = {f.split(":")[0] for f in contract.failures(bench, tree)}
    assert failed == expected


def test_a_model_key_the_program_lacks_fails_unless_named_the_references(
        tree):
    bench = _add(tree)
    cfg = json.loads((tree / "configs" / f"{CONFIG}.json").read_text())
    cfg["model"]["middle"]["reference_knob"] = 1
    _config(tree, model=cfg["model"])
    failed = contract.failures(bench, tree)
    assert [f.split(":")[0] for f in failed] == [f"model_section[{CONFIG}]"]
    assert "middle.reference_knob" in failed[0]
    _config(tree, reference_own={"middle.reference_knob": ""})
    assert [f.split(":")[0] for f in contract.failures(bench, tree)] == \
        [f"model_section[{CONFIG}]"]  # named without its reason
    _config(tree, reference_own={"middle.reference_knob": "the reference's"})
    assert contract.failures(bench, tree) == []
