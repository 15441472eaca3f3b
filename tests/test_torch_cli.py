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


def test_evaluate_second_sparse_gives_the_evaluators_annos(dataset,
                                                           tmp_path):
    """``evaluate --config configs/second_sparse_d435i.yaml`` (reduced)
    with the trained sparse checkpoint: the saved annos are those of the
    port's Evaluator called in this process (floats within 1e-5: the two
    processes run the convs on different thread counts)."""
    import pickle

    import numpy as np

    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector
    from pillars_torch.train.trainer import Evaluator
    from pillars_torch.weights import from_jax_variables, load_params

    weights = str(ROOT / "benchmarks" / "second_sparse_synth"
                  / "weights_33.pkl")
    config = str(ROOT / "configs" / "second_sparse_d435i.yaml")
    sets = dataset_overrides(dataset) + ["model.voxel.max_points=8192",
                                         "model.voxel.max_voxels=6000",
                                         "model.middle.max_active=6000"]
    save = tmp_path / "result.pkl"
    out = cli("evaluate", "--config", config, "--device", "cpu",
              "--checkpoint", weights, "--save-predictions", str(save), *sets)
    assert out.returncode == 0, out.stderr
    assert "aggregate score:" in out.stdout
    cfg = Config.from_yaml(config).overrides(sets[1:])
    det = PillarsDetector(cfg, device="cpu")
    want, _ = Evaluator(cfg, det).run(
        from_jax_variables(*load_params(weights), cfg))
    with open(save, "rb") as f:
        got = pickle.load(f)
    assert len(got) == len(want) == 4
    assert sum(len(a["score"]) for a in want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key, value in w.items():
            if np.asarray(value).dtype.kind == "f":
                np.testing.assert_allclose(g[key], value, rtol=0, atol=1e-5,
                                           err_msg=key)
            else:
                np.testing.assert_array_equal(g[key], value, err_msg=key)


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


def train_overrides(root, out):
    return ["--set", f"train_input.dataset_root={root}",
            f"train_input.info_path={root}/kitti_infos_train.pkl",
            f"train_input.sampler.info_path={root}/kitti_dbinfos_train.pkl",
            "train_input.num_workers=1", f"eval_input.dataset_root={root}",
            f"eval_input.info_path={root}/kitti_infos_val.pkl",
            "eval_input.num_workers=1", "model.voxel.max_points=4096",
            "train.log_every_steps=1", f"out_dir={out}"]


def test_train_on_the_cpu(dataset, tmp_path):
    """One epoch (one step at B=2 of the 3 train clouds) with the
    per-epoch eval, then a resumed second epoch."""
    out = tmp_path / "runs"
    got = cli("train", "--device", "cpu", "--epochs", "1",
              *train_overrides(dataset, out))
    assert got.returncode == 0, got.stderr
    assert "[train] epoch 0 step 0 loss" in got.stdout
    assert "best eval score:" in got.stdout
    run = out / "model_1"
    assert (run / "checkpoints" / "weights_temp.pkl").stat().st_size > 0
    assert (run / "results" / "model_result_0.txt").exists()
    assert (run / "results" / "result_0.pkl").exists()
    assert (run / "logs" / "metrics.csv").exists()
    assert (run / "train.yaml").exists()
    again = cli("train", "--device", "cpu", "--epochs", "2", "--resume",
                str(run / "checkpoints" / "weights_temp.pkl"),
                *train_overrides(dataset, out))
    assert again.returncode == 0, again.stderr
    assert "at step 1" in again.stdout
    assert "[train] epoch 1 done" in again.stdout
    assert "[train] epoch 0" not in again.stdout
    assert (out / "model_2" / "results" / "model_result_1.txt").exists()


def test_sample_val_data_matches_jax(dataset):
    import pickle

    import numpy as np

    from pillars_tpu.config import Config as JaxConfig
    from pillars_tpu.data.val_sampling import create_sampled_val_dataset

    root = pathlib.Path(dataset)
    sets = ["--set", f"train_input.dataset_root={dataset}",
            f"train_input.info_path={dataset}/kitti_infos_train.pkl",
            f"train_input.sampler.info_path={dataset}/kitti_dbinfos_train.pkl"]
    out = cli("sample-val-data", "--val-info",
              f"{dataset}/kitti_infos_val.pkl", "--seed", "3", *sets)
    assert out.returncode == 0, out.stderr
    assert "sampled val info file:" in out.stdout
    jcfg = JaxConfig.default().overrides(sets[1:])
    create_sampled_val_dataset(jcfg, f"{dataset}/kitti_infos_val.pkl",
                               out_info_name="jax_sampled.pkl",
                               out_dir_name="velodyne_jax", seed=3)
    with open(root / "kitti_infos_val_sampled.pkl", "rb") as f:
        got = pickle.load(f)
    with open(root / "jax_sampled.pkl", "rb") as f:
        want = pickle.load(f)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for key, value in w["annos"].items():
            np.testing.assert_array_equal(g["annos"][key], value, err_msg=key)
        mine = (root / g["velodyne_path"]).read_bytes()
        theirs = (root / w["velodyne_path"]).read_bytes()
        assert mine == theirs


@pytest.mark.parametrize("cmd", ["bench"])
def test_later_slices_say_so(cmd):
    """The subcommand that came with the last slice of the port runs: on
    the CPU when asked for, its JSON line on stdout; without a card and
    without ``--device cpu`` it fails and says why."""
    import math

    import torch

    out = cli(cmd, "--device", "cpu", "--path", "fast", "--dtype",
              "bfloat16", "--n-clouds", "1", "--iters", "1")
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert math.isfinite(result["value"]) and result["value"] > 0
    assert (result["detail"]["path"], result["detail"]["dtype"]) == (
        "fast", "bfloat16")
    if not torch.cuda.is_available():
        out = cli(cmd, "--n-clouds", "1", "--iters", "1")
        assert out.returncode != 0
        assert "no CUDA device is available" in out.stderr


def test_capture_synthetic_matches_jax(tmp_path):
    """``capture --source synthetic``: every 2nd of the seeded synthetic
    scenes with the cycling predefined box, the files byte for byte the
    JAX package's capture of the same scenes; then ``--mode unannotated``."""
    import itertools

    import numpy as np

    from pillars_tpu.data import capture as jcapture
    from pillars_tpu.data.synthetic import make_scene

    root = tmp_path / "port"
    out = cli("capture", "--root", str(root), "--source", "synthetic",
              "--every-nth", "2", "--max-frames", "3", "--seed", "4")
    assert out.returncode == 0, out.stderr
    assert "[capture] saved 3 predefined clouds" in out.stdout
    rng = np.random.RandomState(4)
    frames = (make_scene(rng)[0] for _ in itertools.count())
    assert jcapture.capture_predefined(frames, str(tmp_path / "jax"),
                                       every_nth=2, already_lidar=True,
                                       max_frames=3) == 3
    for sub in ("velodyne", "label_2", "calib"):
        got = sorted((root / "training" / sub).iterdir())
        assert len(got) == 3
        for path in got:
            want = tmp_path / "jax" / "training" / sub / path.name
            assert path.read_bytes() == want.read_bytes(), path
    out = cli("capture", "--root", str(tmp_path / "live"), "--mode",
              "unannotated", "--source", f"replay:{root}", "--end", "2")
    assert out.returncode == 0, out.stderr
    assert len(list((tmp_path / "live" / "testing" / "velodyne").iterdir())
               ) == 2


def test_visualize_matches_jax(dataset, tmp_path):
    """``visualize`` over the val split with predictions (the gt boxes
    scored, above and below --min-score): one BEV PNG per frame, byte for
    byte the JAX package's."""
    import pickle

    import numpy as np

    from pillars_tpu import cli as jax_cli

    with open(f"{dataset}/kitti_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)
    annos = []
    for i, info in enumerate(infos):
        a = {k: np.asarray(v) for k, v in info["annos"].items()}
        a["score"] = np.linspace(0.9, 0.3, len(a["name"])) - 0.01 * i
        annos.append(a)
    result = tmp_path / "result.pkl"
    with open(result, "wb") as f:
        pickle.dump(annos, f)
    args = ["--root", dataset, "--result", str(result), "--max-frames", "2"]
    out = cli("visualize", *args, "--out", str(tmp_path / "port"))
    assert out.returncode == 0, out.stderr
    assert f"rendered 2 frames to {tmp_path / 'port'}" in out.stdout
    jax_cli.main(["visualize", *args, "--out", str(tmp_path / "jax")])
    got = sorted((tmp_path / "port").iterdir())
    assert [p.name for p in got] == ["000000.png", "000001.png"]
    for path in got:
        assert path.stat().st_size > 1000
        assert path.read_bytes() == (tmp_path / "jax" / path.name
                                     ).read_bytes()


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


def test_evaluate_in_bfloat16(dataset, tmp_path):
    """``runtime.compute_dtype=bfloat16`` from the command line: evaluate
    runs the bfloat16 network (4 clouds, 4096-point pad) and saves its
    annos; train runs a bfloat16 epoch and writes its checkpoint."""
    import pickle

    save = tmp_path / "result.pkl"
    out = cli("evaluate", "--device", "cpu", "--checkpoint", WEIGHTS,
              "--save-predictions", str(save), *dataset_overrides(dataset),
              "model.voxel.max_points=4096", "runtime.compute_dtype=bfloat16")
    assert out.returncode == 0, out.stderr
    assert "aggregate score:" in out.stdout
    with open(save, "rb") as f:
        annos = pickle.load(f)
    assert len(annos) == 4 and sum(len(a["score"]) for a in annos) > 0
    runs = tmp_path / "runs"
    out = cli("train", "--device", "cpu", "--epochs", "1",
              *train_overrides(dataset, runs),
              "runtime.compute_dtype=bfloat16")
    assert out.returncode == 0, out.stderr
    assert "[train] epoch 0 step 0 loss" in out.stdout
    path = runs / "model_1" / "checkpoints" / "weights_temp.pkl"
    with open(path, "rb") as f:
        state = pickle.load(f)["state"]
    assert int(state[0]) == 1  # one step at B=2 of the 3 train clouds
    leaves = [state[1]]
    while leaves:
        leaf = leaves.pop()
        if isinstance(leaf, dict):
            leaves.extend(leaf.values())
        else:
            assert leaf.dtype == "float32"
