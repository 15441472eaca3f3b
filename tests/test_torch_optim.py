"""The port's optimizer (pillars_torch/train/optim.py) against the JAX
package's optax chain on the CPU: the decay schedule, five tfa-style AdamW
steps on the SAME gradients (parameters and both moments within 1e-6), and
freeze patterns matched on the flax paths (frozen parameters exactly
unchanged, the same leaves frozen as the JAX mask).

Adam's first steps are sign-like (m_hat / sqrt(v_hat) is about +-1), so
the optimizer is compared on identical gradients, never on gradients of two
networks.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from pillars_torch.config import Config as TorchConfig
from pillars_torch.config import OptimizerConfig as TorchOptConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.train.optim import (AdamW, exponential_decay_schedule,
                                       trainable_names)
from pillars_torch.weights import (convert_tree, params_to_jax_tree,
                                   to_jax_variables)
from pillars_tpu.config import OptimizerConfig as JaxOptConfig
from pillars_tpu.train.optim import exponential_decay_schedule as jax_sched
from pillars_tpu.train.optim import freeze_mask, make_optimizer
from torch_parity import randomize_variables, small_config

torch.set_num_threads(2)
OPT_TOL = 1e-6


@pytest.mark.parametrize("staircase", [False, True])
def test_schedule_matches_jax(staircase):
    kw = dict(initial_learning_rate=0.002, decay_steps=7000,
              decay_factor=0.8, staircase=staircase)
    got = exponential_decay_schedule(TorchOptConfig(**kw), batch_size=2)
    want = jax_sched(JaxOptConfig(**kw), batch_size=2)
    for step in (0, 1, 2, 299, 3499, 3500, 7000, 12345):
        assert got(step) == pytest.approx(float(want(jnp.int32(step))),
                                          rel=1e-6)
    assert got(3500) == pytest.approx(0.002 * 0.8, rel=1e-6)


@pytest.mark.parametrize("staircase", [False, True])
def test_device_schedule_matches_jax_up_to_1e5(staircase):
    """The rate as the captured step computes it, on an int32 count tensor
    in f32, against the JAX package's at every count to 2000 and 5001
    counts to 1e5: within 1e-6 relative, as the schedule at host ints
    above (XLA's f32 pow drifts to 8 ulps from PyTorch's at 1e5, where
    p = count / 3500 is 28)."""
    kw = dict(initial_learning_rate=0.002, decay_steps=7000,
              decay_factor=0.8, staircase=staircase)
    counts = np.unique(np.concatenate([
        np.arange(2000), np.linspace(0, 1e5, 5001)]).astype(np.int32))
    got = exponential_decay_schedule(TorchOptConfig(**kw), batch_size=2)(
        torch.from_numpy(counts))
    assert got.dtype == torch.float32
    want = jax.jit(jax_sched(JaxOptConfig(**kw), batch_size=2))(
        jnp.asarray(counts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.fixture(scope="module")
def params_tree():
    """A flax params tree of the reduced network (its structure from the
    port's state through the inverse bridge, its values from a seed)."""
    state = TorchDetector(small_config(TorchConfig), device="cpu").init(
        torch.Generator().manual_seed(0))
    params, stats = to_jax_variables(state)
    return randomize_variables({"params": params, "batch_stats": stats},
                               seed=3)["params"]


def _grads(seed, tree):
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (r.randn(*a.shape) * 10.0 ** r.uniform(-6, 0)).astype(
            np.float32), tree)


@pytest.mark.parametrize("patterns", [(), ("pfn", "block1/bn0", "conv_cls")])
def test_adamw_five_steps_match_optax(params_tree, patterns):
    kw = dict(weight_decay=1e-4, adam_eps=1e-8, freeze_patterns=patterns)
    tx = make_optimizer(JaxOptConfig(**kw), batch_size=2, params=params_tree)
    jstate = tx.init(params_tree)
    jparams = params_tree
    update = jax.jit(tx.update)
    params = convert_tree(params_tree, None)
    opt = AdamW(TorchOptConfig(**kw), batch_size=2)
    state = opt.init(params)
    for step in range(5):
        g = _grads(step, params_tree)
        g["pfn"]["dense"]["kernel"][0] = 0.0  # a zero gradient: decay only
        updates, jstate = update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        params, state = opt.update(convert_tree(g, None), state, params)
    assert state.count == 5
    want = convert_tree(jax.device_get(jparams), None)
    for name, w in want.items():
        np.testing.assert_allclose(params[name].numpy(), w, rtol=OPT_TOL,
                                   atol=OPT_TOL * np.abs(w).max(),
                                   err_msg=name)
    adam = (jstate[0] if not patterns else
            jstate.inner_states["train"].inner_state[0])
    for mine, theirs in ((state.mu, adam.mu), (state.nu, adam.nu)):
        flat = jax.tree_util.tree_leaves_with_path(jax.device_get(theirs))
        theirs = {"/".join(str(k.key) for k in p): np.asarray(v)
                  for p, v in flat if not isinstance(v, optax.MaskedNode)}
        ours = {"/".join(p): v for p, v in _paths(params_to_jax_tree(mine))}
        assert ours.keys() == theirs.keys()
        for k, v in theirs.items():
            np.testing.assert_allclose(ours[k], v, rtol=OPT_TOL,
                                       atol=OPT_TOL * np.abs(v).max(),
                                       err_msg=k)


def test_adamw_late_counts_match_optax(params_tree):
    """Five updates from a count of 99990: the bias corrections and the
    rate from the int32 count on the device against optax's."""
    kw = dict(weight_decay=1e-4, adam_eps=1e-8)
    tx = make_optimizer(JaxOptConfig(**kw), batch_size=2)
    adam, sched, *rest = tx.init(params_tree)
    start = jnp.int32(99990)
    jstate = (adam._replace(count=start), sched._replace(count=start),
              *rest)
    jparams = params_tree
    update = jax.jit(tx.update)
    params = convert_tree(params_tree, None)
    opt = AdamW(TorchOptConfig(**kw), batch_size=2)
    state = opt.init(params)._replace(count=99990)
    for step in range(5):
        g = _grads(10 + step, params_tree)
        updates, jstate = update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        params, state = opt.update(convert_tree(g, None), state, params)
    assert state.count == 99995
    want = convert_tree(jax.device_get(jparams), None)
    for name, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(params[name].numpy(), w, rtol=OPT_TOL,
                                   atol=OPT_TOL * np.abs(w).max(),
                                   err_msg=name)


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_freeze_patterns_match_flax_paths(params_tree):
    patterns = ("pfn", "block1/bn0", "conv_cls", "deconv2/deconv")
    mask = freeze_mask(params_tree, patterns)
    frozen_jax = {"/".join(p) for p, trainable in _paths(mask)
                  if not trainable}
    params = convert_tree(params_tree, None)
    names = set(trainable_names(params, patterns))
    frozen = set(params) - names
    assert frozen_jax == {"/".join(p) for p, _ in _paths(
        params_to_jax_tree({n: params[n] for n in frozen}))}
    assert "pfn.dense.weight" in frozen and "rpn.block1.bn0.bias" in frozen
    assert "rpn.block1.bn1.bias" not in frozen

    opt = AdamW(TorchOptConfig(freeze_patterns=patterns), batch_size=2)
    state = opt.init(params)
    grads = convert_tree(_grads(0, params_tree), None)
    new, state = opt.update(grads, state, params)
    new, state = opt.update(grads, state, new)
    for n in params:
        if n in frozen:
            assert torch.equal(new[n], params[n]), n
        else:
            assert not torch.equal(new[n], params[n]), n
    assert set(state.mu) == names


def test_decay_is_not_scaled_by_lr():
    """tfa.AdamW: with a zero gradient and zero moments the step is exactly
    -wd * p."""
    p = {"rpn.conv_box.bias": torch.ones(3)}
    opt = AdamW(TorchOptConfig(weight_decay=0.01), batch_size=2)
    new, _ = opt.update({"rpn.conv_box.bias": torch.zeros(3)},
                        opt.init(p), p)
    np.testing.assert_allclose(new["rpn.conv_box.bias"].numpy(), 0.99,
                               rtol=1e-7)
