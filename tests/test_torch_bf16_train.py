"""``runtime.compute_dtype=bfloat16`` training: the port against the JAX
package in bfloat16 on the CPU, on the reduced training setup of
``torch_parity.train_config`` (B=2) and NumPy-seeded weights.

The JAX side compiles with XLA's excess precision off
(``torch_parity.jit_strict``), as in tests/test_torch_bf16.py. Criteria
(``torch_parity``):
- the train-mode forward: every head and every new BN statistic by
  ``head_criterion`` with BF16_RMS_FACTOR_TRAIN and BF16_MAX_FACTOR_TRAIN;
- one step's loss: each part within BF16_LOSS_GAP_FACTOR of the JAX
  package's own bfloat16-float32 gap of that part, or within
  BF16_LOSS_RTOL relative, whichever is larger;
- one step's gradients: each leaf by ``grad_criterion`` (BF16_GRAD_FACTOR
  and BF16_GRAD_MAX_FACTOR of the larger of its bf16-f32 gap and one
  bfloat16 step of its values), but the class head's bias: the JAX
  package's bfloat16 sum of its cotangent saturates (48 where float32 gives
  105), and the port's float32 sum must lie nearer float32 than that;
- three AdamW steps: each step's loss parts as above, the parameters after
  them by ``grad_criterion`` with the step's size as the floor.
The factors and the measurements behind them are in tests/torch_parity.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.train.loop import make_train_step, split_state
from pillars_torch.train.optim import AdamW
from pillars_torch.train import checkpoint as tckpt
from pillars_torch.weights import (convert_tree, from_jax_variables,
                                   params_to_jax_tree, to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.train.loop import TrainState as JaxTrainState
from pillars_tpu.train.loop import make_train_step as jax_make_step
from pillars_tpu.train.optim import make_optimizer
from torch_parity import (BF16_MAX_FACTOR_TRAIN, BF16_RMS_FACTOR_TRAIN,
                          grad_criterion,
                          head_criterion, heads_criterion, jit_strict,
                          loss_criterion, randomize_variables, train_batches,
                          train_config)

torch.set_num_threads(2)

# the networks the JAX package trains: the point-major PointPillars (with
# and without the shift-add depthwise lowering), the dense [P, N, D] layout,
# SimpleVoxel with the sparse SECOND middle
NETWORKS = {
    "point_major": (),
    "point_major_shift_add": (("model.rpn.depthwise_shift_add", True),),
    "dense_layout": (("model.pfn.pointwise", False),),
    "second_sparse_d435i": None,
}


def _configs(name, dtype="bfloat16"):
    if NETWORKS[name] is None:
        from test_torch_second import reduced

        cfgs = [reduced(c, name) for c in (JaxConfig, TorchConfig)]
        over = (("train_input.batch_size", 2),)
    else:
        cfgs = [train_config(c) for c in (JaxConfig, TorchConfig)]
        over = NETWORKS[name]
    over += (("runtime.compute_dtype", dtype),)
    for key, value in over:
        cfgs = [c.override(key, value) for c in cfgs]
    return cfgs


def _setup(name, seed=5, batch_seed=1):
    """(jcfg, tcfg, port detector, port state, flax variables, port
    voxelization, the same as JAX arrays, targets) on one batch."""
    jcfg, tcfg = _configs(name)
    tdet = TorchDetector(tcfg, device="cpu")
    maxpts = tcfg.model.voxel.max_points
    batch = train_batches(batch_seed, 1, maxpts=maxpts)[0]
    thr = tcfg.train_input.anchor_area_threshold
    with torch.no_grad():
        tv = tdet.voxelize_batch(torch.from_numpy(batch["points"]),
                                 torch.from_numpy(batch["num_points"]))
        amask = tdet.anchors_mask_batch(tv.coords, tv.pillar_mask, thr)
        targets = tdet.assign_targets(
            *(torch.from_numpy(batch[k])
              for k in ("gt_boxes", "gt_classes", "gt_valid")), amask)
    assert (targets.labels > 0).any()
    params, stats = to_jax_variables(
        tdet.init(torch.Generator().manual_seed(0)))
    variables = randomize_variables({"params": params, "batch_stats": stats},
                                    seed)
    state = from_jax_variables(variables["params"], variables["batch_stats"],
                               tcfg)
    jdet = JaxDetector(jcfg)
    jv = jdet.voxelize_batch(jnp.asarray(batch["points"]),
                             jnp.asarray(batch["num_points"]))
    jv = type(jv)(*(jnp.asarray(t.numpy()) for t in tv))
    return dict(jcfg=jcfg, tcfg=tcfg, tdet=tdet, state=state,
                variables=variables, tv=tv, jv=jv, targets=targets)


def _jax_forward(jcfg, variables, jv, dtype):
    det = JaxDetector(jcfg.override("runtime.compute_dtype", dtype))
    return jax.device_get(jit_strict(lambda v, x: det.network.apply(
        v, x, True, mutable=["batch_stats"]))(variables, jv))


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_train_mode_forward(name):
    """bfloat16 heads and float32 new BN statistics, against the JAX
    package in bfloat16, relative to its bfloat16-float32 gap."""
    s = _setup(name, batch_seed=3 if name.startswith("second") else 1)
    want, want_stats = _jax_forward(s["jcfg"], s["variables"], s["jv"],
                                    "bfloat16")
    want32, want_stats32 = _jax_forward(s["jcfg"], s["variables"], s["jv"],
                                        "float32")
    got, got_stats = s["tdet"].apply(s["state"], s["tv"], train=True)
    assert all(t.dtype == torch.bfloat16 for t in got.values())
    heads_criterion({k: t.detach() for k, t in got.items()}, want, want32,
                    name, BF16_RMS_FACTOR_TRAIN, BF16_MAX_FACTOR_TRAIN)
    want_stats = convert_tree({}, want_stats["batch_stats"])
    want_stats32 = convert_tree({}, want_stats32["batch_stats"])
    floats = {k: t for k, t in got_stats.items() if t.is_floating_point()}
    assert set(floats) == set(want_stats)
    for k, t in floats.items():
        assert t.dtype == torch.float32, k
        head_criterion(t, want_stats[k].numpy(), want_stats32[k].numpy(),
                       f"{name} {k}", BF16_RMS_FACTOR_TRAIN,
                       BF16_MAX_FACTOR_TRAIN)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(tree[k])


def _jax_loss_and_grads(s, dtype):
    det = JaxDetector(s["jcfg"].override("runtime.compute_dtype", dtype))
    labels = jnp.asarray(s["targets"].labels.numpy())
    reg = jnp.asarray(s["targets"].bbox_targets.numpy())
    stats = s["variables"]["batch_stats"]

    def f(params, jv):
        preds, _ = det.network.apply({"params": params, "batch_stats": stats},
                                     jv, True, mutable=["batch_stats"])
        out = det.loss(preds, labels, reg)
        return out.loss, out

    (_, out), grads = jit_strict(jax.value_and_grad(f, has_aux=True))(
        s["variables"]["params"], s["jv"])
    return jax.device_get(out), dict(_leaves(jax.device_get(grads)))


def _port_loss_and_grads(s, remat=False):
    tdet = s["tdet"]
    if remat:
        tdet = TorchDetector(s["tcfg"].override("model.rpn.remat", True),
                             device="cpu")
    params, stats = split_state(s["state"])
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    preds, _ = tdet.apply({**params, **stats}, s["tv"], train=True)
    out = tdet.loss(preds, s["targets"].labels, s["targets"].bbox_targets)
    out.loss.backward()
    assert all(p.grad.dtype == torch.float32 for p in params.values())
    return out, params_to_jax_tree({k: p.grad for k, p in params.items()})


@pytest.mark.parametrize("name", ["point_major", "point_major_shift_add"])
def test_one_step_loss_and_gradients(name):
    """The float32 parameters receive float32 gradients through the casts
    (flax's promote_dtype, transposed); the loss is float32."""
    s = _setup(name)
    want, jgrads = _jax_loss_and_grads(s, "bfloat16")
    want32, jgrads32 = _jax_loss_and_grads(s, "float32")
    got, grads = _port_loss_and_grads(s)
    for field, g, w, w32 in zip(got._fields, got, want, want32):
        assert g.dtype == torch.float32 and np.asarray(w).dtype == np.float32
        loss_criterion(g.detach(), w, w32, f"{name} {field}")
    got_leaves = dict(_leaves(grads))
    assert set(got_leaves) == set(jgrads)
    for path, g in got_leaves.items():
        if path == "/rpn/conv_cls/bias":
            rms = lambda a: np.sqrt(np.mean(np.square(a)))  # noqa: E731
            jax_off = rms(jgrads[path] - jgrads32[path])
            port_off = rms(g - jgrads32[path])
            print(f"{path}: port {g}, jax bf16 {jgrads[path]}, jax f32 "
                  f"{jgrads32[path]}")
            assert port_off < 0.1 * jax_off, (port_off, jax_off)
            continue
        grad_criterion(g, jgrads[path], jgrads32[path], f"{name} {path}")


def test_remat_recomputes_the_same_bf16_gradients():
    """``rpn.remat`` recomputes each block in the backward
    (torch.utils.checkpoint): in bfloat16 the gradients equal those without
    it, bit for bit."""
    s = _setup("point_major")
    out, grads = _port_loss_and_grads(s)
    out_r, grads_r = _port_loss_and_grads(s, remat=True)
    assert float(out.loss) == float(out_r.loss)
    for (path, g), (_, r) in zip(_leaves(grads), _leaves(grads_r)):
        np.testing.assert_array_equal(r, g, err_msg=path)


@pytest.fixture(scope="module")
def three_steps():
    return three_step_runs()


def port_steps(start, batches):
    """The port's bf16 AdamW steps from the JAX TrainState ``start``:
    (state, [StepMetrics])."""
    tcfg = train_config(TorchConfig).override("runtime.compute_dtype",
                                              "bfloat16")
    tstate = tckpt.train_state_from_host(tuple(start), tcfg, "cpu")
    step = make_train_step(TorchDetector(tcfg, device="cpu"),
                           AdamW(tcfg.train.optimizer, 2))
    metrics = []
    for batch in batches:
        tstate, m = step(tstate, batch)
        metrics.append(m)
    return tstate, metrics


def three_step_runs():
    """Three bf16 AdamW steps and three f32 ones of the JAX package from one
    start, and the port's three bf16 steps from the same start."""
    batches = train_batches(2, 3)
    tcfg = train_config(TorchConfig).override("runtime.compute_dtype",
                                              "bfloat16")
    tdet = TorchDetector(tcfg, device="cpu")
    # the start from the port's init (flax's runs eagerly, for seconds)
    params, stats = to_jax_variables(
        tdet.init(torch.Generator().manual_seed(0)))
    out = {}
    for dtype in ("bfloat16", "float32"):
        jcfg = train_config(JaxConfig).override("runtime.compute_dtype",
                                                dtype)
        jdet = JaxDetector(jcfg)
        tx = make_optimizer(jcfg.train.optimizer, 2, params)
        jstate = JaxTrainState(jnp.zeros((), jnp.int32), params, stats,
                               tx.init(params))
        start = jax.device_get(jstate)
        step = jax_make_step(jdet, tx, donate=False)
        metrics = []
        for batch in batches:
            jstate, m = step(jstate, batch)
            metrics.append(jax.device_get(m))
        out[dtype] = (jax.device_get(jstate), metrics)
    out["port"] = port_steps(start, batches)
    out["start"], out["batches"] = start, batches
    out["lr"] = tcfg.train.optimizer.initial_learning_rate
    return out


def test_three_bf16_adamw_steps(three_steps):
    """StepMetrics of the JAX package's dtypes, the loss parts of every step
    by the loss criterion, the parameters after three steps by the gradient
    criterion; the Adam moments stay float32."""
    tstate, tm = three_steps["port"]
    jstate, jm = three_steps["bfloat16"]
    jstate32, jm32 = three_steps["float32"]
    for i, (g, w, w32) in enumerate(zip(tm, jm, jm32)):
        for field, a, b, c in zip(g._fields, g, w, w32):
            assert str(a.dtype).replace("torch.", "") == str(
                np.asarray(b).dtype), field
            if field in ("learning_rate", "num_positives"):
                np.testing.assert_allclose(float(a), float(b), rtol=1e-6,
                                           err_msg=field)
            else:
                loss_criterion(a, b, c, f"step {i} {field}")
    assert tstate.step == 3 and tstate.opt_state.count == 3
    assert all(t.dtype == torch.float32 for d in (
        tstate.params, tstate.opt_state.mu, tstate.opt_state.nu)
        for t in d.values())
    lr = three_steps["lr"]
    got = dict(_leaves(params_to_jax_tree(tstate.params)))
    want = dict(_leaves(jstate.params))
    want32 = dict(_leaves(jstate32.params))
    assert set(got) == set(want)
    for path, g in got.items():
        grad_criterion(g, want[path], want32[path], f"params {path}",
                       floor_rms=lr, floor_max=2 * 3 * lr)
