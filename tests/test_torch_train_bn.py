"""Train mode of the port's network against pillars_tpu's on the CPU:
flax-convention BatchNorm (batch statistics with the fast biased variance,
the running update with flax's momentum), the point-major PFN's masked
statistics over the dense layout's row count, the RPN in train mode, and
rpn.remat / rpn.remat_bf16.

Tolerances: outputs, new running statistics and gradients 1e-5 (relative to
each tensor's max |value|; the same f32 products summed in another order).
remat: gradients with and without it equal to 1e-10 in f64. remat_bf16: the
JAX package's own criteria (tests/test_train.py::TestRemat).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.models.layers import BatchNorm
from pillars_torch.models.pfn import PointwisePFN as TorchPFN
from pillars_torch.models.rpn import RPN as TorchRPN
from pillars_torch.ops.voxelize import VoxelizedPoints
from pillars_torch.weights import (convert_tree, from_jax_variables,
                                   to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.pfn import PointwisePFN as JaxPFN
from pillars_tpu.models.rpn import RPN as JaxRPN
from torch_parity import crowded_clouds, randomize_variables, small_config

torch.set_num_threads(2)
TOL = 1e-5


def close(got, want, what, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _stats_and_grads(jgrads, jstats, tgrads, tstats, prefix=""):
    """Every new running statistic and every gradient leaf, flax trees
    against torch names."""
    want_stats = convert_tree({}, jstats)
    for name, w in want_stats.items():
        close(tstats[prefix + name], w, "stat " + name)
    want_grads = convert_tree(jgrads, None)
    assert set(prefix + n for n in want_grads) == set(tgrads)
    for name, w in want_grads.items():
        close(tgrads[prefix + name], w, "grad " + name)


def test_batchnorm_train_matches_flax():
    """The module itself against flax.linen.BatchNorm (installed version):
    normalised output with the batch's fast variance, the running update
    new = m * old + (1 - m) * batch with the biased variance, gradients
    through the mean and the variance."""
    r = np.random.RandomState(0)
    x = (r.randn(2, 6, 7, 5) * 3 + 1).astype(np.float32)    # NHWC
    w = r.randn(*x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                       epsilon=1e-3)
    variables = randomize_variables(
        jax.device_get(bn.init(jax.random.PRNGKey(0), x)), seed=1)

    def f(params, xx):
        y, mut = bn.apply({"params": params,
                           "batch_stats": variables["batch_stats"]}, xx,
                          mutable=["batch_stats"])
        return jnp.sum(y * w), (y, mut["batch_stats"])

    (_, (want, stats)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    tbn = BatchNorm(5, 1e-3, 0.99).train()
    tbn.load_state_dict({**convert_tree(variables["params"],
                                        variables["batch_stats"]),
                         "num_batches_tracked": torch.tensor(0)})
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    y = tbn(xt)
    (y * torch.from_numpy(w.transpose(0, 3, 1, 2).copy())).sum().backward()
    close(y.permute(0, 2, 3, 1), want, "output")
    new_mean, new_var, count = tbn.new_stats
    close(new_mean, stats["mean"], "running mean")
    close(new_var, stats["var"], "running var")
    assert int(count) == 1
    close(xt.grad.permute(0, 2, 3, 1), gx, "input grad")
    close(tbn.weight.grad, gp["scale"], "scale grad")
    close(tbn.bias.grad, gp["bias"], "bias grad")
    # the module's own buffers are untouched
    close(tbn.running_mean, variables["batch_stats"]["mean"], "buffer", 0)


def _voxelized(cfg_t, b, maxpts=2048, seed=5):
    """The port's voxelization (held against JAX in its own tests) as
    NumPy arrays, the input of both PFNs."""
    n_valid = np.array([1900, 1300][:b], np.int32)
    pts = crowded_clouds(seed, b, maxpts, n_valid)
    v = TorchDetector(cfg_t, device="cpu").voxelize_batch(
        torch.from_numpy(pts), torch.from_numpy(n_valid))
    return type(v)(*(t.numpy() for t in v))


@pytest.mark.parametrize("b", [1, 2])
def test_pointwise_pfn_train_mode(b):
    jcfg = small_config(JaxConfig).override("model.pfn.dense_cell", False)
    tcfg = small_config(TorchConfig).override("model.pfn.dense_cell", False)
    v = _voxelized(tcfg, b)
    p = v.pillar_mask.shape[1]
    flat = lambda a: np.array(a).reshape((-1,) + a.shape[2:])  # noqa: E731
    pid = np.asarray(v.point_pillar) + (np.arange(b) * p)[:, None]
    args = (flat(v.points), flat(pid), flat(v.point_kept),
            flat(v.point_mean), flat(v.point_zyx), flat(v.num_points),
            flat(v.pillar_mask))
    pfn = JaxPFN(jcfg.model)
    tpfn = TorchPFN(tcfg.model).train()
    variables = randomize_variables(
        {"params": {"dense": {"kernel": tpfn.dense.weight.detach().numpy().T},
                    "bn": {"scale": tpfn.bn.weight.detach().numpy(),
                           "bias": tpfn.bn.bias.detach().numpy()}},
         "batch_stats": {"bn": {"mean": tpfn.bn.running_mean.numpy(),
                                "var": tpfn.bn.running_var.numpy()}}},
        seed=b)
    w = np.random.RandomState(9).randn(b * p, jcfg.model.pfn.num_filters
                                       ).astype(np.float32)

    def f(params):
        out, mut = pfn.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             *args, train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, mut["batch_stats"])

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(variables["params"])

    tpfn.load_state_dict(convert_tree(variables["params"],
                                      variables["batch_stats"]))
    got = tpfn(*(torch.from_numpy(a) for a in args))
    (got * torch.from_numpy(w)).sum().backward()
    close(got, want, "pfn output")
    mean, var = tpfn.bn.new_stats
    _stats_and_grads(
        grads, stats, {n: t.grad for n, t in tpfn.named_parameters()},
        {"bn.running_mean": mean, "bn.running_var": var})
    # the count is the dense layout's: real pillars x N rows, more than the
    # kept points, so a plain BN over the points would not match
    assert v.pillar_mask.sum() * 50 > v.point_kept.sum()


def test_rpn_train_mode():
    jcfg, tcfg = small_config(JaxConfig), small_config(TorchConfig)
    _, ny, nx = jcfg.model.feature_map_size
    r = np.random.RandomState(3)
    canvas = np.maximum(r.randn(2, ny, nx, jcfg.model.pfn.num_filters), 0
                        ).astype(np.float32)
    rpn = JaxRPN(jcfg.model)
    trpn = TorchRPN(tcfg.model)
    params, stats = to_jax_variables({f"rpn.{k}": v for k, v in
                                      trpn.state_dict().items()})
    variables = randomize_variables({"params": params["rpn"],
                                     "batch_stats": stats["rpn"]}, seed=4)
    r = np.random.RandomState(0)
    ws = {k: r.randn(2, ny, nx, c).astype(np.float32) for k, c in (
        ("box_preds", 14), ("cls_preds", 2), ("dir_cls_preds", 4))}

    def f(params):
        out, mut = rpn.apply({"params": params,
                              "batch_stats": variables["batch_stats"]},
                             jnp.asarray(canvas), True,
                             mutable=["batch_stats"])
        total = sum(jnp.sum(out[k] * ws[k]) for k in sorted(out))
        return total, (out, mut["batch_stats"])

    (_, (want, stats)), grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(variables["params"])

    trpn.load_state_dict(
        {**convert_tree(variables["params"], variables["batch_stats"]),
         **{n: b for n, b in trpn.state_dict().items()
            if n.endswith("num_batches_tracked")}})
    trpn.train()
    got = trpn(torch.from_numpy(canvas))
    sum((got[k] * torch.from_numpy(ws[k])).sum() for k in got).backward()
    for k in want:
        close(got[k], want[k], k)
    from pillars_torch.models.layers import collect_batch_stats

    _stats_and_grads(grads, stats,
                     {n: t.grad for n, t in trpn.named_parameters()},
                     collect_batch_stats(trpn))


# ----------------------------------------------------------------------
# the whole network through the detector: remat and remat_bf16

def _network_inputs(tcfg, b=1, n=300, seed=0):
    r = np.random.RandomState(seed)
    maxpts = tcfg.model.voxel.max_points
    pts = np.zeros((b, maxpts, 3), np.float32)
    pts[:, :n, 0] = r.uniform(0, 6.4, (b, n))
    pts[:, :n, 1] = r.uniform(-2.5, 2.5, (b, n))
    pts[:, :n, 2] = r.uniform(-2.9, 0.5, (b, n))
    det = TorchDetector(tcfg, device="cpu")
    vox = det.voxelize_batch(torch.from_numpy(pts),
                             torch.full((b,), n, dtype=torch.int32))
    params, stats = to_jax_variables(det.init(
        torch.Generator().manual_seed(seed)))
    v = randomize_variables({"params": params, "batch_stats": stats},
                            seed=seed)
    return vox, from_jax_variables(v["params"], v["batch_stats"], tcfg)


def _grads(det, state, vox):
    params = {k: v.detach().clone().requires_grad_(v.is_floating_point()
                                                   and "running" not in k)
              for k, v in state.items()}
    preds, _ = det.apply(params, vox, train=True)
    (preds["box_preds"] ** 2).sum().backward()
    return preds, {k: v.grad for k, v in params.items() if v.grad is not None}


def test_remat_grads_equal_in_f64():
    cfg = TorchConfig.default().override("model.voxel.max_points", 2048)
    vox, state = _network_inputs(cfg)
    as64 = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
    vox = VoxelizedPoints(*(as64(t) for t in vox))
    state = {k: as64(v) for k, v in state.items()}
    _, g1 = _grads(TorchDetector(cfg, device="cpu"), state, vox)
    _, g2 = _grads(TorchDetector(cfg.override("model.rpn.remat", True),
                                 device="cpu"), state, vox)
    assert g1.keys() == g2.keys() and len(g1) > 50
    for k in g1:
        assert g1[k].dtype == torch.float64
        np.testing.assert_allclose(g2[k].numpy(), g1[k].numpy(), rtol=1e-10,
                                   atol=1e-10, err_msg=k)


def test_remat_bf16_boundaries_close_to_f32():
    """As the JAX package's test: parameters, outputs and gradients stay
    f32; the forward within 3e-2 relative L2 of f32 remat; every gradient
    leaf of at least 1% of the largest keeps its direction (cosine > 0.9)
    and its norm within a factor 2."""
    cfg = TorchConfig.default().override("model.voxel.max_points", 2048)
    cfg_r = cfg.override("model.rpn.remat", True)
    cfg_b = cfg_r.override("model.rpn.remat_bf16", True)
    vox, state = _network_inputs(cfg)
    preds_r, g_r = _grads(TorchDetector(cfg_r, device="cpu"), state, vox)
    preds_b, g_b = _grads(TorchDetector(cfg_b, device="cpu"), state, vox)
    assert preds_b["box_preds"].dtype == torch.float32
    assert all(g.dtype == torch.float32 for g in g_b.values())
    d = (preds_b["box_preds"] - preds_r["box_preds"]).norm()
    s = preds_r["box_preds"].norm() + 1e-12
    assert float(d / s) < 3e-2
    # not the f32 result: the boundaries really were rounded
    assert float(d) > 0
    gmax = max(float(g.norm()) for g in g_r.values())
    for k, a in g_r.items():
        a, b = a.flatten().double(), g_b[k].flatten().double()
        na, nb = float(a.norm()), float(b.norm())
        if na < 1e-2 * gmax:
            continue
        cos = float(a @ b) / (na * nb + 1e-12)
        assert cos > 0.9, f"{k}: grad cosine {cos:.4f}"
        assert 0.5 < nb / na < 2.0, f"{k}: norm ratio {nb / na:.3f}"


def test_train_apply_leaves_its_state_untouched():
    cfg = small_config(TorchConfig).override("model.rpn.remat", True)
    vox, _ = _network_inputs(cfg)
    det = TorchDetector(cfg, device="cpu")
    state = det.init(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in state.items()}
    preds, new = det.apply(state, vox, train=True)
    assert all(torch.equal(state[k], before[k]) for k in state)
    assert set(new) == {k for k in state
                        if k.rsplit(".", 1)[-1] in ("running_mean",
                                                    "running_var",
                                                    "num_batches_tracked")}
    assert not torch.equal(new["rpn.block1.bn0.running_mean"],
                           state["rpn.block1.bn0.running_mean"])
    assert int(new["rpn.block1.bn0.num_batches_tracked"]) == 1
    # the network is back in eval mode, and eval reads the running stats
    assert not det.network.training
    again = det.apply(state, vox)
    assert all(torch.isfinite(t).all() for t in again.values())
