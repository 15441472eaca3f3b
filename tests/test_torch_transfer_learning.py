"""``configs/transfer_learning.yaml`` end to end: the port's ``Trainer`` and
the JAX package's, each from the same ``train.load_weights`` pickle (a JAX
params checkpoint), one epoch of two steps at B=2 on a tiny synthetic split
(the reduced model of torch_parity.train_config, no eval).

- every leaf that ``freeze_patterns`` (pfn, block1-block3) matches keeps the
  loaded value bit for bit, in both packages;
- the per-step losses and learning rates (metrics.csv) within
  tests/test_torch_trainer.py's 1e-4 relative, at the config's
  transfer-learning rate;
- the trainable leaves moved, and their mass (the sum of |w| over them)
  within 1e-4 relative of the JAX package's (Adam's sign-like first steps
  amplify f32 noise leaf by leaf, as in tests/test_torch_train_step.py).
"""

import csv
import os
import pathlib

import numpy as np
import pytest
import torch

from pillars_torch.config import Config as TorchConfig
from pillars_torch.data import synthetic
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.train.optim import trainable_names
from pillars_torch.train.trainer import Trainer as TorchTrainer
from pillars_torch.weights import (convert_tree, from_jax_variables,
                                   to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.train import checkpoint as jckpt
from pillars_tpu.train.trainer import Trainer as JaxTrainer
from torch_parity import TRAIN_OVERRIDES, randomize_variables

torch.set_num_threads(2)
YAML = str(pathlib.Path(__file__).resolve().parent.parent / "configs"
           / "transfer_learning.yaml")
LOSS_RTOL = 1e-4
STEP_KEYS = ("loss", "loc_loss_reduced", "cls_loss_reduced",
             "dir_loss_reduced", "learning_rate")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("transfer")
    root = synthetic.generate_dataset(str(tmp / "data"), num_train=4,
                                      num_test=2, seed=3)
    cfg0 = TorchConfig.from_yaml(YAML)
    for key, value in TRAIN_OVERRIDES:
        cfg0 = cfg0.override(key, value)
    state = TorchDetector(cfg0, device="cpu").init(
        torch.Generator().manual_seed(0))
    params, stats = to_jax_variables(state)
    v = randomize_variables({"params": params, "batch_stats": stats}, seed=9)
    weights = str(tmp / "stage1.pkl")
    jckpt.save_params(weights, v["params"], v["batch_stats"])

    def cfg(config_cls, out):
        c = config_cls.from_yaml(YAML)
        for key, value in TRAIN_OVERRIDES + (
                ("train_input.dataset_root", root),
                ("train_input.info_path", f"{root}/kitti_infos_train.pkl"),
                ("train_input.sampler.info_path",
                 f"{root}/kitti_dbinfos_train.pkl"),
                ("train_input.num_workers", 1),
                ("train.load_weights", weights),
                ("train.do_evaluate", False),
                ("train.log_every_steps", 1),
                ("train.print_every_steps", 1000),
                ("runtime.num_devices", 1),
                ("out_dir", str(tmp / out))):
            c = c.override(key, value)
        return c

    tcfg = cfg(TorchConfig, "torch")
    assert tuple(tcfg.train.optimizer.freeze_patterns) == (
        "pfn", "block1", "block2", "block3")
    jt = JaxTrainer(cfg(JaxConfig, "jax"))
    jt.train(epochs=1)
    tt = TorchTrainer(tcfg, device="cpu")
    tt.train(epochs=1)
    loaded = from_jax_variables(v["params"], v["batch_stats"], tcfg)
    return dict(jax=jt, torch=tt, loaded=loaded, cfg=tcfg)


def _rows(trainer):
    with open(os.path.join(trainer.dirs["logs"], "metrics.csv")) as f:
        return [r for r in csv.DictReader(f) if r.get("loss")]


def test_frozen_leaves_keep_the_loaded_weights(runs):
    params = runs["torch"].state.params
    trainable = set(trainable_names(
        params, runs["cfg"].train.optimizer.freeze_patterns))
    frozen = [k for k in params if k not in trainable]
    assert any(k.startswith("pfn.") for k in frozen)
    assert any(".block3." in k for k in frozen)
    assert all(".block" not in k and not k.startswith("pfn.")
               for k in trainable)
    want_jax = convert_tree(runs["jax"].state.params, None)
    for k in frozen:
        assert torch.equal(params[k], runs["loaded"][k]), k
        assert torch.equal(want_jax[k], runs["loaded"][k]), k
    moved = {k for k in trainable
             if not torch.equal(params[k], runs["loaded"][k])}
    assert moved == trainable


def test_losses_and_trainable_leaves_match_jax(runs):
    want, got = _rows(runs["jax"]), _rows(runs["torch"])
    assert [r["step"] for r in got] == [r["step"] for r in want] == ["0", "1"]
    for g, w in zip(got, want):
        for key in STEP_KEYS:
            np.testing.assert_allclose(float(g[key]), float(w[key]),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"step {w['step']} {key}")
    assert float(got[0]["learning_rate"]) == pytest.approx(0.005)
    params = runs["torch"].state.params
    want_p = convert_tree(runs["jax"].state.params, None)
    trainable = trainable_names(params,
                                runs["cfg"].train.optimizer.freeze_patterns)
    mass = lambda d: sum(float(d[k].abs().sum())  # noqa: E731
                         for k in trainable)
    np.testing.assert_allclose(mass(params), mass(want_p), rtol=LOSS_RTOL)
