"""The port's train step (pillars_torch/train/loop.py) against the JAX
package's ``make_train_step`` on the CPU, on the reduced training setup of
``torch_parity.train_config`` (narrow RPN, 2048-point pad, 512 pillars,
4 gt slots, B=2).

- Forward + loss + gradients in float64 on the same voxelization and
  targets (made in f32, cast to f64), the loss parts within 1e-9 relative,
  every gradient leaf and new BN statistic within 1e-9 of its max |value|.
  The JAX package casts the loss inputs and the PFN's BN statistics to f32
  (``jnp.float32``); for this comparison its modules see ``jnp`` with
  ``float32`` meaning float64, so both sides compute in f64 throughout.
- Three f32 steps, with and without ``with_metrics``: losses within 1e-4
  relative, every StepMetrics field, the running train metrics and the new
  BN statistics.
- A JAX TrainState saved after two steps, resumed by the port (Adam moments
  and step included) for a third step, against JAX's third step.

Each JAX step is built once per module (two train-step compiles here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pillars_tpu.models.losses as jax_losses
import pillars_tpu.models.pfn as jax_pfn
from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.ops.voxelize import VoxelizedPoints
from pillars_torch.train import checkpoint as tckpt
from pillars_torch.train import metrics as ttm
from pillars_torch.train.loop import (TrainState, create_train_state,
                                      make_train_step, split_state, variables)
from pillars_torch.train.optim import AdamW
from pillars_torch.weights import (convert_tree, params_to_jax_tree,
                                   to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.ops.voxelize import VoxelizedPoints as JaxVoxelizedPoints
from pillars_tpu.train import checkpoint as jckpt
from pillars_tpu.train import metrics as jtm
from pillars_tpu.train.loop import create_train_state as jax_create
from pillars_tpu.train.loop import make_train_step as jax_make_step
from torch_parity import train_batches, train_config

torch.set_num_threads(2)
LOSS_RTOL = 1e-4
F64_TOL = 1e-9


class _F64Numpy:
    """``jnp`` whose ``float32`` is float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_forward_loss_grads_match_jax_in_f64(monkeypatch):
    jcfg, tcfg = train_config(JaxConfig), train_config(TorchConfig)
    jdet, tdet = JaxDetector(jcfg), TorchDetector(tcfg, device="cpu")
    batch = train_batches(1, 1)[0]
    thr = tcfg.train_input.anchor_area_threshold
    # one voxelization, anchors mask and target set (the port's, each held
    # against JAX in its own test) feeds both sides
    with torch.no_grad():
        tv = tdet.voxelize_batch(torch.from_numpy(batch["points"]),
                                 torch.from_numpy(batch["num_points"]))
        amask = tdet.anchors_mask_batch(tv.coords, tv.pillar_mask, thr)
        targets = tdet.assign_targets(
            *(torch.from_numpy(batch[k])
              for k in ("gt_boxes", "gt_classes", "gt_valid")), amask)
    labels = targets.labels.numpy()
    assert (labels > 0).sum() > 0
    state32 = tdet.init(torch.Generator().manual_seed(0))
    params32, stats32 = to_jax_variables(state32)
    variables = {"params": params32, "batch_stats": stats32}
    as64 = lambda a: (np.asarray(a, np.float64)  # noqa: E731
                      if np.issubdtype(np.asarray(a).dtype, np.floating)
                      else np.asarray(a))
    vox64 = [as64(t.numpy()) for t in tv]
    reg64 = as64(targets.bbox_targets.numpy())

    monkeypatch.setattr(jax_losses, "jnp", _F64Numpy())
    monkeypatch.setattr(jax_pfn, "jnp", _F64Numpy())
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(as64, variables)

        def f(params):
            preds, mut = jdet.network.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                JaxVoxelizedPoints(*(jnp.asarray(a) for a in vox64)), True,
                mutable=["batch_stats"])
            out = jdet.loss(preds, jnp.asarray(labels), jnp.asarray(reg64))
            return out.loss, (out, mut["batch_stats"])

        (_, (want, want_stats)), jgrads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                     v64["params"]))
        jgrads = jax.device_get(jgrads)
        assert np.asarray(want.loss).dtype == np.float64

    state = {k: v.double() if v.is_floating_point() else v
             for k, v in state32.items()}
    params, stats = split_state(state)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    tv = VoxelizedPoints(*(torch.from_numpy(a) for a in vox64))
    preds, new_stats = tdet.apply({**params, **stats}, tv, train=True)
    out = tdet.loss(preds, targets.labels, torch.from_numpy(reg64))
    out.loss.backward()
    for name, g, w in zip(out._fields, out, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=F64_TOL, atol=1e-12, err_msg=name)
    # compared in the flax layout, where both keep their f64
    assert all(p.grad is not None and p.grad.dtype == torch.float64
               for p in params.values())
    got_grads = params_to_jax_tree({k: p.grad for k, p in params.items()})
    got_stats = to_jax_variables(new_stats)[1]
    for got, want, what in ((got_grads, jgrads, "grad"),
                            (got_stats, jax.device_get(want_stats), "stat")):
        want, got = list(_leaves(want)), list(_leaves(got))
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, w), (_, g) in zip(want, got):
            assert g.dtype == np.float64, path
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=F64_TOL * np.abs(w).max(),
                                       err_msg=f"{what} {path}")


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(tree[k])


# ----------------------------------------------------------------------
# three f32 steps, and the resume of a JAX TrainState

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = train_config(JaxConfig), train_config(TorchConfig)
    jdet = JaxDetector(jcfg)
    jstate, tx = jax_create(jdet, jax.random.PRNGKey(0), 2)
    return dict(jcfg=jcfg, tcfg=tcfg, jdet=jdet, jstate=jstate, tx=tx,
                tdet=TorchDetector(tcfg, device="cpu"),
                batches=train_batches(2, 3), steps={})


def _jax_step(setup, with_metrics):
    if with_metrics not in setup["steps"]:
        setup["steps"][with_metrics] = jax_make_step(
            setup["jdet"], setup["tx"], donate=False,
            with_metrics=with_metrics)
    return setup["steps"][with_metrics]


def _port_state(setup, jstate):
    """The JAX TrainState through a checkpoint file of the JAX package,
    read and resumed by the port."""
    return tckpt.train_state_from_host(
        tuple(jax.device_get(jstate)), setup["tcfg"], "cpu")


def _close_rel(got, want, tol, what):
    want = np.asarray(want, np.float64)
    got = float(got) if np.ndim(want) == 0 else np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=tol, atol=1e-7, err_msg=what)


@pytest.mark.parametrize("with_metrics", [False, True])
def test_three_f32_steps_match_jax(setup, with_metrics):
    jstep = _jax_step(setup, with_metrics)
    tdet = setup["tdet"]
    opt = AdamW(setup["tcfg"].train.optimizer, 2)
    tstep = make_train_step(tdet, opt, with_metrics=with_metrics)
    jstate = setup["jstate"]
    tstate = _port_state(setup, jstate)
    jtm_state, ttm_state = jtm.TrainMetricsState.init(), \
        ttm.TrainMetricsState.init()
    for batch in setup["batches"]:
        if with_metrics:
            jstate, jtm_state, jm, jvals = jstep(jstate, jtm_state, batch)
            tstate, ttm_state, tm, tvals = tstep(tstate, ttm_state, batch)
            assert tvals.keys() == jvals.keys()
            for k in jvals:
                _close_rel(tvals[k], jvals[k], LOSS_RTOL, k)
        else:
            jstate, jm = jstep(jstate, batch)
            tstate, tm = tstep(tstate, batch)
        for name, g, w in zip(tm._fields, tm, jm):
            _close_rel(g, w, LOSS_RTOL, name)
        assert int(tm.num_positives) == int(jm.num_positives) > 0
    assert tstate.step == int(jstate.step) == 3
    want_stats = convert_tree({}, jax.device_get(jstate.batch_stats))
    for name, w in want_stats.items():
        np.testing.assert_allclose(tstate.batch_stats[name].numpy(), w,
                                   rtol=0, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    # parameter mass moves together (leaf by leaf, Adam's sign-like steps
    # amplify f32 noise; the sums do not)
    want_p = convert_tree(jax.device_get(jstate.params), None)
    mass = lambda d: sum(float(np.abs(np.asarray(v)).sum())  # noqa: E731
                         for v in d.values())
    _close_rel(mass({k: v.numpy() for k, v in tstate.params.items()}),
               mass(want_p), 1e-4, "parameter mass")


def test_resume_a_jax_train_state(setup, tmp_path):
    """Two JAX steps, saved by the JAX package; the port resumes the file
    (Adam count, mu, nu and the step) and takes the third step."""
    jstep = _jax_step(setup, False)
    jstate = setup["jstate"]
    b1, b2, b3 = setup["batches"]
    for batch in (b1, b2):
        jstate, _ = jstep(jstate, batch)
    path = str(tmp_path / "weights_temp.pkl")
    jckpt.save_checkpoint(path, jstate, extra={"epoch": 0})
    host, extra = tckpt.load_checkpoint(path)
    assert extra == {"epoch": 0}
    tstate = tckpt.train_state_from_host(host, setup["tcfg"], "cpu")
    assert isinstance(tstate, TrainState)
    assert tstate.step == 2 and tstate.opt_state.count == 2
    assert set(tstate.opt_state.mu) == set(tstate.params)
    opt = AdamW(setup["tcfg"].train.optimizer, 2)
    tstate, tm = make_train_step(setup["tdet"], opt)(tstate, b3)
    jstate, jm = jstep(jstate, b3)
    _close_rel(tm.loss, jm.loss, LOSS_RTOL, "third loss")
    _close_rel(tm.learning_rate, jm.learning_rate, 1e-6, "third lr")
    assert tstate.step == 3

    # the port writes what the JAX package reads, and reads it back
    out = str(tmp_path / "port.pkl")
    tckpt.save_checkpoint(out, tstate, extra={"epoch": 1})
    params, stats = jckpt.load_params(out)
    want = split_state({k: v for k, v in tstate.params.items()})[0]
    for name, t in convert_tree(params, None).items():
        assert torch.equal(t, want[name]), name
    back = tckpt.train_state_from_host(tckpt.load_checkpoint(out)[0],
                                       setup["tcfg"], "cpu")
    assert back.step == 3 and back.opt_state.count == 3
    for a, b in ((back.opt_state.mu, tstate.opt_state.mu),
                 (back.opt_state.nu, tstate.opt_state.nu),
                 (back.params, tstate.params)):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(back.batch_stats[k], tstate.batch_stats[k])
               for k in back.batch_stats
               if not k.endswith("num_batches_tracked"))


def test_fold_cache_refolds_after_an_optimizer_step():
    """The fast inference path caches the folded RPN blocks per state; a
    train step hands back new parameter tensors, so the next eval folds
    again and agrees with an uncached fold."""
    from torch_parity import fast_config

    cfg = fast_config(train_config(TorchConfig))
    det = TorchDetector(cfg, device="cpu")
    assert det.fast
    state, opt = create_train_state(det, torch.Generator().manual_seed(0), 2)
    batch = train_batches(6, 1)[0]
    with torch.no_grad():
        vox = det.voxelize_batch(torch.from_numpy(batch["points"]),
                                 torch.from_numpy(batch["num_points"]))
        det._forward_fast(variables(state), vox)
        det._forward_fast(variables(state), vox)
        assert det.folded_blocks.folds == 1
        state, _ = make_train_step(det, opt)(state, batch)
        got = det._forward_fast(variables(state), vox)
        assert det.folded_blocks.folds == 2
        want = det.apply(variables(state), vox)  # the unfused network
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0,
                                   atol=1e-4 * float(want[key].abs().max()))
