"""BENCHMARK.json against the rules of its format, and every name it gives
against the files that the harness finds by that name.

    python -m pytest port_bench/tests -q
"""

import json
import pathlib
import re

import pytest

from port_bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
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


def _names():
    for c in BENCH["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        yield m["name"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_names_use_only_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
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


def test_top_level_shape():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(set(c) == KEYS["config"] for c in BENCH["configs"])
    assert all(set(w) == KEYS["workload"] for w in BENCH["workloads"])
    for text in [w["why"] for w in BENCH["workloads"]] + [
            c["why"] for c in BENCH["configs"]] + [
            c["source"] for c in BENCH["configs"]] + BENCH["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_run_seconds_fits_a_full_check_of_24_cells():
    cells = 24
    runs = 2 + 14 * cells
    need = runs * (BENCH["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert need <= 43200


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(BENCH, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert harness.cell_metrics(BENCH, w["name"], True), w["name"]


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_per_layer_metric_moves_a_metric_its_cells_report(metric):
    moves = [m for m in BENCH["end_to_end"] if m["name"] == metric["moves"]]
    assert len(moves) == 1
    cells = metric.get("workloads", [w["name"] for w in BENCH["workloads"]])
    for cell in cells:
        reported = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
        assert metric["moves"] in reported, (metric["name"], cell)


def test_one_layer_name_per_layer_module():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.metric_reader(metric["name"]))


@pytest.mark.parametrize("wl", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files(wl):
    config = harness.config_file(wl["config"])
    assert config["name"] == wl["config"]
    traffic = harness.traffic_file(wl["traffic"])
    assert callable(harness.loop(traffic["loop"]).run)
    limits = harness.limits_file(wl["name"])["limits"]
    assert limits["detection_gap"] > 0
    entry = [c for c in BENCH["configs"] if c["name"] == wl["config"]][0]
    assert (ROOT / entry["file"]).resolve() == (
        harness.HERE / "configs" / f"{wl['config']}.json").resolve()
    assert entry["reduced"] == config["reduced"]
    assert all(key in config["assumed"] for key in config["reduced"])
    assert (ROOT / config["weights"]).is_file()


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_states_what_the_program_runs(config):
    """The model section the reference reads equals the program's Config of
    the yaml the file names."""
    from pillars_torch.config import Config

    data = harness.config_file(config["name"])
    cfg = harness.program_config(data)
    m, model = cfg.model, data["model"]
    assert isinstance(cfg, Config)
    assert model["num_class"] == m.num_class
    assert model["num_point_features"] == m.num_point_features
    v = model["voxel"]
    assert v["point_cloud_range"] == list(m.voxel.point_cloud_range)
    assert v["voxel_size"] == list(m.voxel.voxel_size)
    assert v["grid_size"] == list(m.voxel.grid_size)
    for key in ("max_points_per_voxel", "max_voxels", "max_points"):
        assert v[key] == getattr(m.voxel, key)
    assert model["pfn"] == {"num_filters": m.pfn.num_filters,
                            "bn_eps": m.pfn.bn_eps}
    for key, value in model["rpn"].items():
        got = getattr(m.rpn, key)
        assert value == (list(got) if isinstance(got, tuple) else got), key
    assert model["anchor_generators"] == [
        {"sizes": list(g.sizes), "strides": list(g.strides),
         "offsets": list(g.offsets), "rotations": list(g.rotations)}
        for g in m.target.generators]
    for key, value in model["postprocess"].items():
        assert value == getattr(m.postprocess, key), key
    assert model["anchor_area_threshold"] == \
        cfg.eval_input.anchor_area_threshold
    assert model["prediction_min_score"] == cfg.runtime.prediction_min_score
    assert m.postprocess.use_direction_classifier
