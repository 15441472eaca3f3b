"""Checkpoints both ways between the port and the JAX package
(pillars_torch/weights.py, pillars_torch/train/checkpoint.py), bit-equal:

- ``to_jax_variables`` is the exact inverse of ``from_jax_variables``
  (the trained d435i checkpoint and a reduced random one);
- a port checkpoint read by ``pillars_tpu.train.checkpoint.load_params``;
- JAX TrainState files read by the port, optax Adam state included, also
  with freeze patterns (optax's multi_transform state, masked leaves);
- the out-dir layout, the atomic write, and the bookkeeping of
  ``Trainer.resume`` (epoch, best score, pending eval).
"""

import os
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.train import checkpoint as tckpt
from pillars_torch.train.loop import TrainState, create_train_state
from pillars_torch.train.trainer import Trainer
from pillars_torch.weights import (from_jax_variables, load_params,
                                   to_jax_variables)
from pillars_tpu.config import OptimizerConfig as JaxOptConfig
from pillars_tpu.train import checkpoint as jckpt
from pillars_tpu.train.loop import TrainState as JaxTrainState
from pillars_tpu.train.optim import make_optimizer
from torch_parity import randomize_variables, small_config

torch.set_num_threads(2)
WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")


def assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, path
    assert np.array_equal(a, b), path


def _small_variables(seed=0):
    state = TorchDetector(small_config(TorchConfig), device="cpu").init(
        torch.Generator().manual_seed(seed))
    params, stats = to_jax_variables(state)
    return randomize_variables({"params": params, "batch_stats": stats},
                               seed=seed)


def test_to_jax_variables_inverts_from_jax_variables():
    for (params, stats), cfg in (
            (load_params(WEIGHTS), TorchConfig.default()),
            (tuple(_small_variables().values()), small_config(TorchConfig))):
        state = from_jax_variables(params, stats, cfg)
        p2, s2 = to_jax_variables(state, cfg)
        assert_trees_equal(p2, jax.device_get(params))
        assert_trees_equal(s2, jax.device_get(stats))
        again = from_jax_variables(p2, s2, cfg)
        assert all(torch.equal(again[k], state[k]) for k in state)


def test_port_checkpoint_is_read_by_the_jax_package(tmp_path):
    cfg = small_config(TorchConfig)
    det = TorchDetector(cfg, device="cpu")
    state, opt = create_train_state(det, torch.Generator().manual_seed(1), 2)
    path = str(tmp_path / "weights_0.pkl")
    tckpt.save_checkpoint(path, state, extra={"score": 1.5, "epoch": 0})
    assert not os.path.exists(path + ".tmp")  # the atomic tmp + rename
    params, stats = jckpt.load_params(path)
    want_p, want_s = to_jax_variables({**state.params, **state.batch_stats})
    assert_trees_equal(jax.device_get(params), want_p)
    assert_trees_equal(jax.device_get(stats), want_s)
    loaded, extra = jckpt.load_checkpoint(path)
    assert extra == {"score": 1.5, "epoch": 0}
    assert int(loaded[0]) == 0
    # a params-only file of the JAX package (train.load_weights)
    jckpt.save_params(str(tmp_path / "j.pkl"), want_p, want_s)
    params, stats = tckpt.load_params(str(tmp_path / "j.pkl"))
    assert_trees_equal(params, want_p)
    assert_trees_equal(stats, want_s)


def test_jax_train_state_files_are_read_by_the_port(tmp_path):
    variables = _small_variables(seed=2)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    r = np.random.RandomState(0)
    grads = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.randn(*a.shape).astype(np.float32)), params)
    cfg = small_config(TorchConfig)
    for patterns in ((), ("pfn", "conv_cls")):
        tx = make_optimizer(JaxOptConfig(freeze_patterns=patterns), 2, params)
        opt_state = tx.init(params)
        _, opt_state = jax.jit(tx.update)(grads, opt_state, params)
        jstate = JaxTrainState(jnp.int32(7), params, variables["batch_stats"],
                               opt_state)
        path = str(tmp_path / f"jax_{len(patterns)}.pkl")
        jckpt.save_checkpoint(path, jstate, extra={"epoch": 3})
        host, extra = tckpt.load_checkpoint(path)
        assert extra == {"epoch": 3}
        state = tckpt.train_state_from_host(host, cfg, "cpu")
        assert isinstance(state, TrainState) and state.step == 7
        assert state.opt_state.count == 1
        want = from_jax_variables(variables["params"],
                                  variables["batch_stats"], cfg)
        assert all(torch.equal(v, want[k]) for k, v in
                   {**state.params, **state.batch_stats}.items())
        frozen = {n for n in state.params
                  if n.startswith("pfn.") or n.startswith("rpn.conv_cls.")}
        assert set(state.opt_state.mu) == set(state.params) - (
            frozen if patterns else set())
        # the first moment after one update is (1 - b1) * g, in torch layout
        g = from_jax_variables(jax.device_get(grads),
                               variables["batch_stats"], cfg)
        for name, mu in state.opt_state.mu.items():
            np.testing.assert_allclose(mu.numpy(), 0.1 * g[name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)


def test_out_dirs_auto_increment(tmp_path):
    d1 = tckpt.create_out_dirs(str(tmp_path), "1")
    d2 = tckpt.create_out_dirs(str(tmp_path), "1")
    assert (d1["model_id"], d2["model_id"]) == ("1", "2")
    assert all(os.path.isdir(d2[k]) for k in ("checkpoints", "logs",
                                               "results"))


def test_resume_restores_epoch_and_gate(tmp_path):
    """As tests/test_train.py's: the epoch counter, the best-score gate and
    an interrupted eval come back from the checkpoint's ``extra``."""
    cfg = small_config(TorchConfig)
    state, _ = create_train_state(TorchDetector(cfg, device="cpu"),
                                  torch.Generator().manual_seed(0), 2)
    full = state._replace(step=123)
    path = str(tmp_path / "weights_temp.pkl")
    t = object.__new__(Trainer)  # bookkeeping only; no dataset needed
    t.cfg, t.device, t.state = cfg, torch.device("cpu"), state
    tckpt.save_checkpoint(path, full, extra={"epoch": 4, "best_score": 37.5})
    assert t.resume(path) == 123
    assert (t._start_epoch, t._best_score) == (5, 37.5)
    tckpt.save_checkpoint(path, full)
    t.resume(path)
    assert (t._start_epoch, t._best_score, t._pending_eval_epoch) == (
        0, 0.0, None)
    tckpt.save_checkpoint(path, full, extra={
        "epoch": 4, "best_score": 37.5, "evaluated": False})
    t.resume(path)
    assert (t._start_epoch, t._pending_eval_epoch) == (5, 4)
    tckpt.save_checkpoint(path, full, extra={
        "epoch": 4, "best_score": 40.0, "evaluated": True})
    t.resume(path)
    assert t._pending_eval_epoch is None and t._best_score == 40.0


def test_trainer_on_several_cards_says_which_slice():
    """Data-parallel training needs its ranks (``parallel.launch``); one
    process asked for two devices raises and says how to start them."""
    cfg = small_config(TorchConfig).override("runtime.num_devices", 2)
    with pytest.raises(ValueError, match="pillars_torch.parallel.launch"):
        Trainer(cfg, device="cpu")
