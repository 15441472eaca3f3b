"""A configuration, a traffic mix, a metric and a reference added as new
files are found by the names BENCHMARK.json and the configuration file give
them, with no file edited; seeded weights."""

import json
import shutil

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.tests import contract


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of the benchmark's data files, where the harness looks."""
    here = tmp_path / "port_bench"
    for sub in ("configs", "traffic", "metrics", "limits", "reference"):
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


# a reference module of its own, written beside the PointPillars one: it
# records each construction, so the test sees which class judged the run
SUBCLASS = """
import pathlib

from port_bench.reference.pointpillars import Reference as PointPillars

BUILT = pathlib.Path(__file__).with_suffix(".built")


class Reference(PointPillars):
    def __init__(self, model, checkpoint, device="cpu"):
        super().__init__(model, checkpoint, device)
        with open(BUILT, "a") as f:
            f.write(type(checkpoint).__name__ + "\\n")
"""


def test_a_configuration_of_another_reference_with_seeded_weights_runs(
        tree):
    """New files only: a reference module, a configuration that names it
    and seeded weights, a limits file; the run sets up, serves, judges
    with that module's class and comes out correct."""
    (tree / "reference" / "pillars_sub.py").write_text(SUBCLASS)
    cfg = json.loads((tree / "configs" / "pedestrian_d435i.json").read_text())
    cfg.update(name="seeded_sub", reference="pillars_sub",
               weights={"seed": 2**31 + 17})
    (tree / "configs" / "seeded_sub.json").write_text(json.dumps(cfg))
    (tree / "limits" / "seeded_cell.json").write_text(
        json.dumps({"limits": {"detection_gap": 3e-4}}))
    bench = harness.benchmark()
    bench["workloads"].append({
        "name": "seeded_cell", "config": "seeded_sub",
        "traffic": "closed_loop_b1_bank64", "chips": 1, "why": "x"})
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        out = harness.run_cell("seeded_cell", 2**31 + 5, 1.5, False,
                               device="cpu", bench=bench,
                               traffic_overrides={"bank": 6, "warmup": 3})
    finally:
        torch.set_num_threads(threads)
    assert out["correct"], out["checks"]
    assert out["checks"]["detection_gap"]["value"] < 1e-5
    assert out["detail"]["paired"] > 0
    # built once to write the seeded checkpoint (from its trees), once to
    # judge (from the file)
    built = (tree / "reference" / "pillars_sub.built").read_text().split()
    assert built == ["tuple", "str"]


@pytest.mark.parametrize("config", harness.benchmark()["configs"],
                         ids=lambda c: c["name"])
def test_every_configuration_resolves_to_its_reference_module(config):
    """The module the file names, or ``pointpillars`` where it names none;
    a checkpoint file is the path that the program and the reference
    read."""
    contract.reference_resolves(harness.benchmark(), harness.HERE, config)


@pytest.mark.parametrize("config", harness.benchmark()["configs"],
                         ids=lambda c: c["name"])
def test_every_reference_is_a_class_with_run(config):
    contract.reference_runs(harness.benchmark(), harness.HERE, config)


def _seeded(tmp_path, seed, name):
    from port_bench.gen.bank import make_bank
    from port_bench.reference.pointpillars import Reference

    model = harness.config_file("pedestrian_d435i")["model"]
    clouds = make_bank("hard", 2, 99)
    path = tmp_path / name
    Reference.write_seeded(model, seed, clouds, str(path))
    return path


def test_a_seeded_checkpoint_follows_its_seed_and_reads_alike(tmp_path):
    from pillars_torch.weights import from_jax_variables, load_params

    from port_bench.reference.pointpillars import load_checkpoint

    a = _seeded(tmp_path, 2**31 + 7, "a.pkl")
    b = _seeded(tmp_path, 2**31 + 7, "b.pkl")
    c = _seeded(tmp_path, 2**31 + 8, "c.pkl")
    assert a.read_bytes() == b.read_bytes()
    assert a.read_bytes() != c.read_bytes()
    ours, theirs = load_checkpoint(str(a)), load_params(str(a))

    def leaves(tree, prefix=()):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, prefix + (k,))
            else:
                yield prefix + (k,), v

    for mine, prog in zip(ours, theirs):
        x, y = list(leaves(mine)), list(leaves(prog))
        assert [k for k, _ in x] == [k for k, _ in y]
        for (_, u), (_, v) in zip(x, y):
            assert u.dtype == np.float32 and np.array_equal(u, v)
            assert np.isfinite(u).all()
    cfg = harness.program_config(harness.config_file("pedestrian_d435i"))
    from_jax_variables(*theirs, cfg)  # strict: every name and shape


# a writer that takes WRITER_S longer than the PointPillars one
SLOW_WRITER = """
import time

from port_bench.reference.pointpillars import Reference as PointPillars


class Reference(PointPillars):
    @classmethod
    def write_seeded(cls, *args, **kwargs):
        time.sleep(%r)
        return super().write_seeded(*args, **kwargs)
"""
WRITER_S = 1.5


def test_the_seeded_writer_is_not_set_up(tree):
    """``setup_s`` runs from ``Cell.t_process`` to the window's opening;
    set-up moves that clock past the reference's writer, so a writer
    slower by WRITER_S leaves it at least WRITER_S later."""
    import time

    (tree / "reference" / "slow_writer.py").write_text(
        SLOW_WRITER % WRITER_S)
    cfg = harness.config_file("pedestrian_d435i")
    cfg.update(reference="slow_writer", weights={"seed": 2**31 + 17})
    traffic = dict(harness.traffic_file("closed_loop_b1_bank64"), bank=2)
    t0 = time.perf_counter()
    cell = harness.Cell(cfg, traffic, 2**31 + 5, 1.0, False, "cpu", t0)
    try:
        harness.set_up(cell)
        t1 = time.perf_counter()
    finally:
        shutil.rmtree(cell.scratch, ignore_errors=True)
    assert cell.writer_s >= WRITER_S
    assert cell.t_process == t0 + cell.writer_s
    assert t1 - cell.t_process <= t1 - t0 - WRITER_S
    # a trained checkpoint has no writer
    cell = harness.Cell(harness.config_file("pedestrian_d435i"), traffic, 1,
                        1.0, False, "cpu", t0)
    harness.checkpoint(cell)
    assert cell.writer_s == 0.0
