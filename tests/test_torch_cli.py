"""The ``pillars-torch`` command line (pillars_torch/cli.py) on the CPU,
called as ``python -m pillars_torch.cli`` (an editable install names the
console script only after a reinstall)."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
WEIGHTS = str(ROOT / "benchmarks" / "hard_synth" / "weights_59.pkl")


def cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", "pillars_torch.cli", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli") / "data")
    out = cli("synth-data", "--root", root, "--num-train", "3", "--num-test",
              "4", "--seed", "2")
    assert out.returncode == 0, out.stderr
    assert f"synthetic dataset at {root} (profile=easy)" in out.stdout
    return root


def dataset_overrides(root):
    return ["--set", f"eval_input.dataset_root={root}",
            f"eval_input.info_path={root}/kitti_infos_val.pkl",
            "eval_input.num_workers=0"]


def test_synth_data_writes_the_reference_layout(dataset):
    root = pathlib.Path(dataset)
    assert len(list((root / "training" / "velodyne").glob("*.pkl"))) == 3
    assert len(list((root / "testing" / "label_2").glob("*.txt"))) == 4
    for name in ("kitti_infos_train.pkl", "kitti_infos_val.pkl",
                 "kitti_dbinfos_train.pkl"):
        assert (root / name).stat().st_size > 0


def test_create_data_rebuilds_the_info_files(dataset):
    root = pathlib.Path(dataset)
    before = (root / "kitti_infos_train.pkl").read_bytes()
    (root / "kitti_infos_train.pkl").unlink()
    out = cli("create-data", "--root", dataset, "--num-train", "3",
              "--num-test", "4")
    assert out.returncode == 0, out.stderr
    assert "val info file:" in out.stdout
    assert (root / "kitti_infos_train.pkl").read_bytes() == before


def test_evaluate_on_the_cpu(dataset, tmp_path):
    save = tmp_path / "out" / "result.pkl"
    out = cli("evaluate", "--device", "cpu", "--checkpoint", WEIGHTS,
              "--max-samples", "4", "--save-predictions", str(save),
              *dataset_overrides(dataset))
    assert out.returncode == 0, out.stderr
    assert "Pedestrian AP@0.70, 0.50, 0.50:" in out.stdout
    assert "aggregate score:" in out.stdout
    assert save.stat().st_size > 0


def test_evaluate_with_buckets_and_coco_and_random_init(dataset):
    out = cli("evaluate", "--device", "cpu", "--max-samples", "2", "--coco",
              "--buckets", "auto", *dataset_overrides(dataset))
    assert out.returncode == 0, out.stderr
    assert "no checkpoint given - random init" in out.stderr
    assert "coco AP" in out.stdout or "AP" in out.stdout


def test_stream_single(tmp_path):
    out = cli("stream", "--device", "cpu", "--checkpoint", WEIGHTS,
              "--duration", "0.5", "--hz", "30", "--buckets", "9984,19968",
              "--viz-dir", str(tmp_path / "viz"))
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["frames_processed"] >= 1
    assert any((tmp_path / "viz").iterdir())


def test_stream_two_streams():
    out = cli("stream", "--device", "cpu", "--duration", "0.5", "--hz", "30",
              "--num-streams", "2", "--window", "2")
    assert out.returncode == 0, out.stderr
    stats = json.loads(out.stdout.strip().splitlines()[-1])
    assert stats["num_streams"] == 2 and stats["frames_processed"] >= 1


@pytest.mark.parametrize("extra, message", [
    (["--buckets", "auto"], "does not support --buckets"),
    (["--source", "replay:/nowhere"], "supports only --source synthetic"),
])
def test_stream_refusals(extra, message):
    out = cli("stream", "--device", "cpu", "--num-streams", "2", *extra)
    assert out.returncode != 0
    assert message in out.stderr


def test_bad_buckets_exit_with_usage():
    out = cli("stream", "--device", "cpu", "--buckets", "32k")
    assert out.returncode != 0
    assert "--buckets: expected 'auto'" in out.stderr


@pytest.mark.parametrize("cmd", ["train", "capture", "sample-val-data",
                                 "visualize", "bench"])
def test_later_slices_say_so(cmd):
    out = cli(cmd, "--config", "configs/pedestrian_d435i.yaml")
    assert out.returncode != 0
    assert f"pillars-torch {cmd}: not ported yet" in out.stderr


def test_default_device_is_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = cli("stream", "--duration", "0.2")
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr


def test_xla_flags_are_ignored_with_a_note(dataset):
    out = cli("evaluate", "--device", "cpu", "--max-samples", "1",
              *dataset_overrides(dataset),
              "runtime.xla_flags=--xla_foo=1")
    assert out.returncode == 0, out.stderr
    assert "runtime.xla_flags has no meaning" in out.stderr
