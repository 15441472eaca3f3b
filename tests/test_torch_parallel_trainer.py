"""The port's data-parallel ``Trainer`` and ``Evaluator`` on 2 gloo CPU
ranks (one spawn, tests/torch_parallel_ranks.py::run_trainer), the
counterparts of tests/test_trainer_multichip.py, and ``pillars-torch
train|evaluate --device cpu --set runtime.num_devices=2``.

- an epoch with its eval at B=2 (one cloud per rank): the run directory,
  checkpoints, result text and ``metrics.csv`` written once (by rank 0),
  the same parameters on both ranks;
- the overfit fixture records the global batch, a new Trainer replays it;
- the data-parallel ``Evaluator`` (eval batch 4 over 5 val clouds: one
  batch split over the ranks, the remainder on rank 0) gives every rank
  the single-rank port's annos and the JAX package's: names equal, score
  and location within the JAX test's 1e-4 / 1e-5 (location 1e-4, as
  there);
- ``Trainer`` and ``Evaluator`` with ``runtime.num_devices=2`` outside a
  process group of 2 raise, and so does a batch that does not split; with
  the default 0 they run in one process even where 4 cards are visible.
"""

import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from pillars_torch.config import Config as TorchConfig
from pillars_torch.data import synthetic
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.parallel.launch import spawn
from pillars_torch.train.trainer import Evaluator as TorchEvaluator
from pillars_torch.train.trainer import Trainer as TorchTrainer
from pillars_torch.weights import from_jax_variables, load_params
from torch_parallel_ranks import run_trainer

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
WEIGHTS = str(ROOT / "benchmarks" / "hard_synth" / "weights_59.pkl")
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-5
LOC_RTOL, LOC_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("synth_mc")
    synthetic.generate_dataset(str(r), num_train=8, num_test=5, seed=1)
    return str(r)


def overrides(root):
    """test_trainer_multichip's make_cfg, at 2 ranks."""
    return (
        ("model.voxel.max_points", 16384),
        ("model.voxel.max_voxels", 1024),
        ("train_input.info_path", f"{root}/kitti_infos_train.pkl"),
        ("train_input.dataset_root", root),
        ("train_input.sampler.info_path", f"{root}/kitti_dbinfos_train.pkl"),
        ("train_input.batch_size", 2),  # 1 per rank
        ("eval_input.info_path", f"{root}/kitti_infos_val.pkl"),
        ("eval_input.dataset_root", root),
        ("eval_input.batch_size", 4),
        ("runtime.num_devices", 2),
        ("train_input.num_workers", 1),
        ("eval_input.num_workers", 1))


def _cfg(config_cls, root, **extra):
    cfg = config_cls.default()
    for key, value in overrides(root) + tuple(extra.items()):
        cfg = cfg.override(key, value)
    return cfg


@pytest.fixture(scope="module")
def ranks(root, tmp_path_factory):
    out = tmp_path_factory.mktemp("trainer_ranks")
    state = from_jax_variables(*load_params(WEIGHTS), TorchConfig.default())
    spec = dict(overrides=overrides(root), out=str(out),
                eval_state={k: v.numpy() for k, v in state.items()})
    path = out / "spec.pkl"
    with open(path, "wb") as f:
        pickle.dump(spec, f)
    spawn(run_trainer, 2, args=(str(path),), threads=1)
    results = [torch.load(out / f"rank{r}.pt", weights_only=False)
               for r in range(2)]
    return dict(out=out, results=results, state=state)


def _model_dirs(path):
    return sorted(os.listdir(path))


def test_train_epoch_with_eval(ranks):
    out, (r0, r1) = ranks["out"], ranks["results"]
    # one run directory, written once
    assert _model_dirs(out / "epoch") == ["model_1"]
    model = out / "epoch" / "model_1"
    assert "weights_temp.pkl" in os.listdir(model / "checkpoints")
    assert (model / "results" / "model_result_0.txt").exists()
    assert (model / "train.yaml").exists()
    with open(model / "logs" / "metrics.csv") as f:
        rows = f.read().splitlines()
    assert len([r for r in rows if r.startswith("0,")]) == 1  # step 0 once
    assert r0["steps"] == r1["steps"] == 4  # 8 clouds at B=2
    assert np.isfinite(r0["best"]) and r0["best"] == r1["best"]
    for k, v in r0["epoch_params"].items():
        assert torch.equal(v, r1["epoch_params"][k]), k


def test_overfit_fixture(ranks):
    out, (r0, r1) = ranks["out"], ranks["results"]
    assert os.path.exists(out / "batch.pkl")
    with open(out / "batch.pkl", "rb") as f:
        batch = pickle.load(f)
    assert batch["points"].shape[0] == 2  # the global batch
    assert r0["overfit_steps"] == r1["overfit_steps"] == 3
    assert r0["replay_steps"] == r1["replay_steps"] == 2
    assert _model_dirs(out / "replay") == ["model_1"]
    for k, v in r0["replay_params"].items():
        assert torch.equal(v, r1["replay_params"][k]), k


def _close_annos(got, want):
    assert len(got) == len(want)
    n = 0
    for a, b in zip(got, want):
        assert list(a["name"]) == list(b["name"])
        np.testing.assert_allclose(a["score"], b["score"], rtol=SCORE_RTOL,
                                   atol=SCORE_ATOL)
        np.testing.assert_allclose(a["location"], b["location"],
                                   rtol=LOC_RTOL, atol=LOC_ATOL)
        n += len(a["name"])
    assert n > 0  # detections to compare


def test_sharded_eval_matches_unsharded(ranks, root):
    import jax

    from pillars_tpu.config import Config as JaxConfig
    from pillars_tpu.models.detector import PillarsDetector as JaxDetector
    from pillars_tpu.train.trainer import Evaluator as JaxEvaluator

    r0, r1 = ranks["results"]
    assert r0["eval_split"] and r1["eval_split"]
    assert len(r0["annos"]) == 5
    _close_annos(r1["annos"], r0["annos"])
    cfg1 = _cfg(TorchConfig, root, **{"runtime.num_devices": 1})
    det = TorchDetector(cfg1, device="cpu")
    ev = TorchEvaluator(cfg1, det)
    assert ev.mesh is None
    single, gt = ev.run(ranks["state"], progress=False)
    assert len(gt) == 5
    _close_annos(r0["annos"], single)
    jcfg = _cfg(JaxConfig, root, **{"runtime.num_devices": 1})
    params, stats = load_params(WEIGHTS)
    jev = JaxEvaluator(jcfg, JaxDetector(jcfg))
    want, _ = jev.run({"params": jax.tree_util.tree_map(np.asarray, params),
                       "batch_stats": stats}, progress=False)
    _close_annos(r0["annos"], want)


def test_num_devices_without_ranks_raises(root, tmp_path):
    cfg = _cfg(TorchConfig, root, out_dir=str(tmp_path / "o"))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        TorchTrainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="needs 2 ranks"):
        TorchEvaluator(cfg, TorchDetector(cfg, device="cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        TorchTrainer(cfg.override("train_input.batch_size", 3), device="cpu")


def test_default_num_devices_runs_one_process_on_many_cards(
        root, tmp_path, monkeypatch):
    """``runtime.num_devices`` 0 in one process outside any group is one
    device, however many cards are visible; only the CLI's launcher reads
    it as every card."""
    from pillars_torch.parallel import launch

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cfg = _cfg(TorchConfig, root, out_dir=str(tmp_path / "o"),
               **{"runtime.num_devices": 0})
    trainer = TorchTrainer(cfg, device="cpu")
    assert trainer.mesh is None and trainer.evaluator.mesh is None
    assert TorchEvaluator(cfg, TorchDetector(cfg, device="cpu")).mesh is None
    assert launch.resolve_num_devices(0) == 1
    assert launch.resolve_num_devices(3) == 3
    assert launch.visible_devices("cuda") == 4
    assert launch.visible_devices("cpu") == 1


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, "-m", "pillars_torch.cli", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_train_and_evaluate_on_two_cpu_ranks(root, tmp_path):
    sets = ["--set", *(f"{k}={v}" for k, v in overrides(root)
                       if not k.startswith("runtime")),
            "runtime.num_devices=2", "model.voxel.max_points=8192",
            f"out_dir={tmp_path / 'out'}"]
    out = _cli("train", "--device", "cpu", "--epochs", "1", *sets)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("best eval score:") == 1
    assert _model_dirs(tmp_path / "out") == ["model_1"]
    ckpt = tmp_path / "out" / "model_1" / "checkpoints" / "weights_temp.pkl"
    out = _cli("evaluate", "--device", "cpu", "--checkpoint", str(ckpt),
               *sets)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("aggregate score:") == 1


def test_a_rank_joins_from_torchrun_environment():
    """``launch.init_from_env``: the process group that ``torchrun``'s
    environment describes (here one gloo rank on localhost)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    code = ("from pillars_torch.parallel import launch, make_mesh\n"
            "dev = launch.init_from_env('cpu')\n"
            "mesh = make_mesh(0)\n"
            "print(dev, mesh.size, mesh.axis_index('data'), "
            "launch.is_main())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(port))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["cpu", "1", "0", "True"]
