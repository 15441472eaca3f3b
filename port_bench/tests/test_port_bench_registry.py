"""A configuration, a traffic mix and a metric added as new files are
found by the names BENCHMARK.json gives them, with no file edited."""

import json
import shutil

import pytest

from port_bench import harness


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of the benchmark's data files, where the harness looks."""
    here = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "metrics", "limits"):
        shutil.copytree(harness.HERE / sub, here / sub)
    monkeypatch.setattr(harness, "HERE", here)
    return here


def test_new_files_are_found_by_name(tree):
    cfg = json.loads((tree / "configs" / "pedestrian_d435i.json").read_text())
    cfg["name"] = "pedestrian_d435i_copy"
    (tree / "configs" / "pedestrian_d435i_copy.json").write_text(
        json.dumps(cfg))
    mix = json.loads((tree / "traffic" / "closed_loop_b1_bank64.json")
                     .read_text())
    mix["bank"] = 16
    (tree / "traffic" / "closed_loop_b1_bank16.json").write_text(
        json.dumps(mix))
    (tree / "metrics" / "clouds_seen.serve.py").write_text(
        "def read(rec):\n    return float(rec['clouds']) or None\n")
    (tree / "limits" / "copy_cell.json").write_text(
        json.dumps({"limits": {"detection_gap": 1e-4}}))

    assert harness.config_file("pedestrian_d435i_copy")["name"] == \
        "pedestrian_d435i_copy"
    assert harness.traffic_file("closed_loop_b1_bank16")["bank"] == 16
    assert harness.metric_reader("clouds_seen.serve")({"clouds": 3}) == 3.0
    assert harness.metric_reader("clouds_seen.serve")({"clouds": 0}) is None
    assert harness.limits_file("copy_cell")["limits"]["detection_gap"] == 1e-4

    bench = harness.benchmark()
    bench["workloads"].append({
        "name": "copy_cell", "config": "pedestrian_d435i_copy",
        "traffic": "closed_loop_b1_bank16", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "clouds_seen.serve", "unit": "clouds", "better": "higher",
        "source": "host_clock", "layer": "x", "moves": "clouds_per_s",
        "workloads": ["copy_cell"]})
    assert harness.workload(bench, "copy_cell")["traffic"] == \
        "closed_loop_b1_bank16"
    names = [m["name"] for m in harness.cell_metrics(bench, "copy_cell", True)]
    assert names == ["clouds_seen.serve"]
    assert "clouds_seen.serve" not in [
        m["name"] for m in harness.cell_metrics(bench, "d435i_sensor1", True)]
