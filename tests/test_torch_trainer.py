"""The port's ``Trainer`` (pillars_torch/train/trainer.py) against the JAX
package's on the CPU: the same tiny synthetic split, seed, reduced model and
starting weights (one JAX params checkpoint through ``train.load_weights``),
one epoch of two steps at B=2 with the per-epoch eval and gating.

- the per-step losses of the epoch (metrics.csv, every step logged) within
  1e-4 relative, and the learning rates;
- the same files: weights_temp.pkl, the gated weights_<epoch>.pkl when the
  score improved, result_<epoch>.pkl, model_result_<epoch>.txt, the CSV;
- a NEW port Trainer resumed from the port's weights_temp.pkl continues the
  epoch numbering and the step count;
- the same epoch in bfloat16: the per-step losses by torch_parity's loss
  criterion, the same files, float32 weights.
"""

import csv
import os

import numpy as np
import pytest
import torch

from pillars_torch.config import Config as TorchConfig
from pillars_torch.data import synthetic
from pillars_torch.train import checkpoint as tckpt
from pillars_torch.train.trainer import Trainer as TorchTrainer
from pillars_torch.weights import to_jax_variables
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.train import checkpoint as jckpt
from pillars_tpu.train.trainer import Trainer as JaxTrainer
from torch_parity import randomize_variables, train_config

torch.set_num_threads(2)
LOSS_RTOL = 1e-4
STEP_KEYS = ("loss", "loc_loss_reduced", "cls_loss_reduced",
             "dir_loss_reduced", "learning_rate")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    root = synthetic.generate_dataset(str(tmp / "data"), num_train=4,
                                      num_test=2, seed=3)
    state = TorchDetector(train_config(TorchConfig), device="cpu").init(
        torch.Generator().manual_seed(0))
    params, stats = to_jax_variables(state)
    v = randomize_variables({"params": params, "batch_stats": stats}, seed=5)
    weights = str(tmp / "start.pkl")
    jckpt.save_params(weights, v["params"], v["batch_stats"])

    def cfg(config_cls, out):
        c = train_config(config_cls)
        for key, value in (
                ("train_input.dataset_root", root),
                ("train_input.info_path", f"{root}/kitti_infos_train.pkl"),
                ("train_input.sampler.info_path",
                 f"{root}/kitti_dbinfos_train.pkl"),
                ("train_input.num_workers", 1),
                ("eval_input.dataset_root", root),
                ("eval_input.info_path", f"{root}/kitti_infos_val.pkl"),
                ("eval_input.num_workers", 1),
                ("train.load_weights", weights),
                ("train.log_every_steps", 1),
                ("train.print_every_steps", 1000),
                ("runtime.num_devices", 1),
                ("out_dir", str(tmp / out))):
            c = c.override(key, value)
        return c

    jt = JaxTrainer(cfg(JaxConfig, "jax"))
    jt.train(epochs=1)
    tt = TorchTrainer(cfg(TorchConfig, "torch"), device="cpu")
    tt.train(epochs=1)
    return dict(jax=jt, torch=tt, cfg=cfg)


def _rows(trainer):
    with open(os.path.join(trainer.dirs["logs"], "metrics.csv")) as f:
        return list(csv.DictReader(f))


def _files(trainer):
    return {k: sorted(os.listdir(trainer.dirs[k]))
            for k in ("checkpoints", "results", "logs")}


def test_first_epoch_losses_match_jax(runs):
    want = [r for r in _rows(runs["jax"]) if r.get("loss")]
    got = [r for r in _rows(runs["torch"]) if r.get("loss")]
    assert [r["step"] for r in got] == [r["step"] for r in want] == ["0", "1"]
    for g, w in zip(got, want):
        for key in STEP_KEYS:
            np.testing.assert_allclose(float(g[key]), float(w[key]),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"step {w['step']} {key}")
        assert float(g["epochs"]) == float(w["epochs"]) == 0
    assert float(want[0]["loss"]) > 0


@pytest.fixture(scope="module")
def runs_bf16(runs):
    """The same epoch with ``runtime.compute_dtype=bfloat16``, in both
    packages."""
    def cfg(config_cls, out):
        return runs["cfg"](config_cls, out).override(
            "runtime.compute_dtype", "bfloat16")

    jt = JaxTrainer(cfg(JaxConfig, "jax_bf16"))
    jt.train(epochs=1)
    tt = TorchTrainer(cfg(TorchConfig, "torch_bf16"), device="cpu")
    tt.train(epochs=1)
    return dict(jax=jt, torch=tt)


def test_first_epoch_losses_match_jax_in_bfloat16(runs, runs_bf16):
    """Per-step losses of a bfloat16 epoch by torch_parity's loss criterion
    (against the JAX package's bf16-f32 gap of the same step, or 1e-2
    relative); learning rates equal; float32 weights in the checkpoint."""
    from torch_parity import loss_criterion

    want = [r for r in _rows(runs_bf16["jax"]) if r.get("loss")]
    want32 = [r for r in _rows(runs["jax"]) if r.get("loss")]
    got = [r for r in _rows(runs_bf16["torch"]) if r.get("loss")]
    assert [r["step"] for r in got] == [r["step"] for r in want] == ["0", "1"]
    for g, w, w32 in zip(got, want, want32):
        for key in STEP_KEYS:
            if key == "learning_rate":
                np.testing.assert_allclose(float(g[key]), float(w[key]),
                                           rtol=1e-6)
            else:
                loss_criterion(g[key], w[key], w32[key],
                               f"step {w['step']} {key}")
    assert _files(runs_bf16["torch"]) == _files(runs_bf16["jax"])
    path = os.path.join(runs_bf16["torch"].dirs["checkpoints"],
                        "weights_temp.pkl")
    params, _ = jckpt.load_params(path)
    leaves = [params]
    while leaves:
        leaf = leaves.pop()
        if isinstance(leaf, dict):
            leaves.extend(leaf.values())
        else:
            assert np.asarray(leaf).dtype == np.float32


def test_the_same_files(runs):
    got, want = _files(runs["torch"]), _files(runs["jax"])
    assert got == want
    assert "weights_temp.pkl" in got["checkpoints"]
    assert {"result_0.pkl", "model_result_0.txt"} <= set(got["results"])
    # the eval row: the same columns, the AP of the same predictions
    jrow = [r for r in _rows(runs["jax"]) if r.get("avg")][-1]
    trow = [r for r in _rows(runs["torch"]) if r.get("avg")][-1]
    assert trow.keys() == jrow.keys()
    # the port's files are JAX-readable and hold the trained step
    path = os.path.join(runs["torch"].dirs["checkpoints"], "weights_temp.pkl")
    state, extra = jckpt.load_checkpoint(path)
    assert int(state[0]) == 2 and extra["evaluated"] is True
    jckpt.load_params(path)


def test_a_resumed_run_continues(runs):
    first = runs["torch"]
    t = TorchTrainer(runs["cfg"](TorchConfig, "torch_resumed"), device="cpu")
    step = t.resume(os.path.join(first.dirs["checkpoints"],
                                 "weights_temp.pkl"))
    assert step == 2 and t._start_epoch == 1
    t.train(epochs=2)
    assert t.state.step == 4
    rows = [r for r in _rows(t) if r.get("loss")]
    assert [(int(r["step"]), float(r["epochs"])) for r in rows] == [
        (2, 1), (3, 1)]
    assert all(np.isfinite(float(r["loss"])) for r in rows)
    assert "model_result_1.txt" in os.listdir(t.dirs["results"])
    assert "model_result_0.txt" not in os.listdir(t.dirs["results"])
    state, extra = tckpt.load_checkpoint(
        os.path.join(t.dirs["checkpoints"], "weights_temp.pkl"))
    assert int(state.step) == 4 and extra["epoch"] == 1


def test_overfit_and_replay_fixtures(runs, tmp_path):
    """The reference's debug fixtures: the first batch repeated, recorded
    to a file, and a new Trainer training on the recorded batch."""
    cfg = runs["cfg"](TorchConfig, "fixtures").override(
        "train.do_evaluate", False)
    t = TorchTrainer(cfg, device="cpu")
    batch_file = str(tmp_path / "batch.pkl")
    t.train(epochs=1, overfit_first_batch=True, save_batch_file=batch_file,
            fixture_repeats=3)
    assert t.state.step == 3 and os.path.getsize(batch_file) > 0
    t2 = TorchTrainer(cfg, device="cpu")
    t2.train(epochs=1, replay_batch_file=batch_file, fixture_repeats=2)
    assert t2.state.step == 2
    losses = [float(r["loss"]) for r in _rows(t2) if r.get("loss")]
    first = [float(r["loss"]) for r in _rows(t) if r.get("loss")]
    # the same weights and the same recorded batch: the same first loss
    assert losses[0] == pytest.approx(first[0], rel=1e-6)
