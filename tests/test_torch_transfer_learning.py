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

The port's step under the freeze differentiates only the trainable leaves,
as the JAX package's jitted step drops the backward of what optax's
``set_to_zero`` never reads (no JAX here; the dense-cell and the fast
config, ``rpn.remat`` off and on):

- ``train_body``'s loss parts, trainable gradients and new BN statistics
  are bit-equal to ``gradients()`` over every leaf, and its frozen leaves
  are the tensors it was handed;
- the outputs of the PFN and of block1-block3 carry no ``grad_fn``;
- under ``torch.profiler`` the backward runs one ``convolution_backward``
  per convolution of the trainable layers (three deconvs and three 1x1
  heads over three branches: 12) where the every-leaf one runs one per
  convolution of the network, and under ``rpn.remat`` recomputes the
  deconvs alone (no frozen block);
- without ``freeze_patterns`` the body differentiates every leaf.
"""

import csv
import os
import pathlib
from collections import Counter

import numpy as np
import pytest
import torch

from pillars_torch.config import Config as TorchConfig
from pillars_torch.data import synthetic
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.train.loop import (_counts, create_train_state, gradients,
                                      train_body)
from pillars_torch.train.optim import trainable_names
from pillars_torch.train.trainer import Trainer as TorchTrainer
from pillars_torch.weights import (convert_tree, from_jax_variables,
                                   to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.train import checkpoint as jckpt
from pillars_tpu.train.trainer import Trainer as JaxTrainer
from torch_parity import (TRAIN_OVERRIDES, fast_config, randomize_variables,
                          train_batches)

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


# ----------------------------------------------------------------------
# the step under the freeze: only the trainable leaves differentiated

FROZEN_MODULES = ("pfn", "rpn.block1", "rpn.block2", "rpn.block3")
# 3 deconvs + 3 heads (box, class, direction) x 3 branches, one 1x1 conv
# each (rpn.no_concat_heads)
TRAINABLE_CONVS = 12


def _reduced(fast, remat, yaml=YAML):
    cfg = TorchConfig.from_yaml(yaml) if yaml else TorchConfig.default()
    for key, value in TRAIN_OVERRIDES:
        cfg = cfg.override(key, value)
    cfg = fast_config(cfg) if fast else cfg
    return cfg.override("model.rpn.remat", remat)


def _profiled(fn):
    """``fn()`` and the counts of the ops it ran (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, Counter(e.name for e in prof.events())


@pytest.fixture(scope="module")
def frozen_steps():
    """Per (fast, remat): the every-leaf gradients and the train body
    under the freeze, from one state on one batch, with the ops each ran
    and the outputs of the frozen modules during the body."""
    batch = {k: torch.from_numpy(v)
             for k, v in train_batches(2, 1)[0].items()}
    out = {}
    for fast in (False, True):
        for remat in (False, True):
            cfg = _reduced(fast, remat)
            det = TorchDetector(cfg, device="cpu")
            state, opt = create_train_state(
                det, torch.Generator().manual_seed(0), 2)
            thr = cfg.train_input.anchor_area_threshold
            full, full_ops = _profiled(lambda: gradients(
                det, state.params, state.batch_stats, batch, thr))
            seen = {}
            hooks = [det.network.get_submodule(name).register_forward_hook(
                lambda m, i, o, name=name: seen.setdefault(name, []).append(
                    o))
                for name in FROZEN_MODULES + ("rpn.deconv1",)]
            body, body_ops = _profiled(lambda: train_body(
                det, opt, thr, state.params, state.batch_stats,
                state.opt_state.mu, state.opt_state.nu, _counts(state),
                batch))
            for h in hooks:
                h.remove()
            out[fast, remat] = dict(state=state, full=full, body=body,
                                    full_ops=full_ops, body_ops=body_ops,
                                    seen=seen)
    return out


CASES = pytest.mark.parametrize("fast,remat", [
    (False, False), (False, True), (True, False), (True, True)],
    ids=["dense", "dense_remat", "fast", "fast_remat"])


@CASES
def test_frozen_step_matches_the_every_leaf_step(frozen_steps, fast, remat):
    run = frozen_steps[fast, remat]
    state, full, body = run["state"], run["full"], run["body"]
    trainable = trainable_names(state.params, (
        "pfn", "block1", "block2", "block3"))
    assert tuple(state.opt_state.mu) == trainable
    assert tuple(body.fb.grads) == trainable
    assert len(trainable) == 15 and len(full.grads) == len(state.params)
    for name, g, w in zip(full.loss._fields, body.fb.loss, full.loss):
        assert torch.equal(g, w), name
    for k in trainable:
        assert torch.equal(body.fb.grads[k], full.grads[k]), k
    assert body.fb.batch_stats.keys() == full.batch_stats.keys()
    for k, w in full.batch_stats.items():
        assert torch.equal(body.fb.batch_stats[k], w), k
    assert any(k.startswith("pfn.") for k in body.fb.batch_stats)
    for k, p in state.params.items():
        if k not in trainable:
            assert body.params[k] is p, k
        else:
            assert not torch.equal(body.params[k], p), k


@CASES
def test_frozen_modules_carry_no_graph(frozen_steps, fast, remat):
    seen = frozen_steps[fast, remat]["seen"]
    for name in FROZEN_MODULES:
        outs = seen[name]
        assert len(outs) == 1, (name, len(outs))  # no recomputation
        flat = [t for o in outs
                for t in (o if isinstance(o, (tuple, list)) else (o,))]
        assert all(t.grad_fn is None and not t.requires_grad
                   for t in flat if isinstance(t, torch.Tensor)), name
        assert any(isinstance(t, torch.Tensor) for t in flat), name
    # the first trainable layer (under remat it runs again in the backward)
    assert seen["rpn.deconv1"][0].grad_fn is not None


@CASES
def test_backward_runs_only_the_trainable_convolutions(frozen_steps, fast,
                                                       remat):
    run = frozen_steps[fast, remat]
    full, body = run["full_ops"], run["body_ops"]
    assert body["aten::convolution_backward"] == TRAINABLE_CONVS
    assert full["aten::convolution_backward"] > TRAINABLE_CONVS
    no_remat = frozen_steps[fast, False]["body_ops"]["aten::convolution"]
    # the forward convolutions once each; under remat the deconvs again
    assert body["aten::convolution"] == no_remat + (3 if remat else 0)
    if not remat:
        assert full["aten::convolution_backward"] == full["aten::convolution"]


def test_without_freeze_every_leaf_is_differentiated():
    cfg = _reduced(False, False, yaml=None)
    assert not cfg.train.optimizer.freeze_patterns
    det = TorchDetector(cfg, device="cpu")
    state, opt = create_train_state(det, torch.Generator().manual_seed(0), 2)
    batch = {k: torch.from_numpy(v)
             for k, v in train_batches(2, 1)[0].items()}
    thr = cfg.train_input.anchor_area_threshold
    body = train_body(det, opt, thr, state.params, state.batch_stats,
                      state.opt_state.mu, state.opt_state.nu,
                      _counts(state), batch)
    full = gradients(det, state.params, state.batch_stats, batch, thr)
    assert tuple(body.fb.grads) == tuple(full.grads) == tuple(state.params)
    for k, w in full.grads.items():
        assert torch.equal(body.fb.grads[k], w), k
