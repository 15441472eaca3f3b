"""The dense-layout front end of the port (``voxelize``, ``voxelize_np``,
``MaskedBatchNorm``, ``PillarFeatureNet``) on the CPU: the counterpart of
tests/test_pfn_equivalence.py (``PillarFeatureNet`` against
``PointwisePFN`` on the same weights: eval outputs, pillars at the point
cap, train statistics, gradients), each front end against pillars_tpu's,
the voxelizers against the JAX package's, and ``pfn.with_distance``, which
the port's two point-major PFNs ignore as the JAX package's do.

Tolerances between the two front ends are the JAX test's (their cluster
means round differently, which the RPN amplifies); against the JAX package
each front end is held within 1e-4 of each head's max |value|, and the
voxelizations are equal."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.ops.voxelize import make_voxelizer, voxelize_np
from pillars_torch.train.loop import split_state
from pillars_torch.weights import (from_jax_variables, params_to_jax_tree,
                                   to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.ops import voxelize as jvox
from torch_parity import (compare_predictions, d435i_clouds,
                          randomize_variables, small_config)

torch.set_num_threads(2)
HEAD_RTOL = 1e-4  # port vs JAX, of each head's max |value|


def make_cfg(cls, pointwise):
    cfg = cls.default()
    for key, value in (("model.voxel.max_voxels", 2048),
                       ("model.voxel.max_points", 8192),
                       ("model.pfn.pointwise", pointwise),
                       ("model.rpn.layer_nums", [1, 2, 2]),
                       ("model.rpn.num_filters", [32, 32, 64]),
                       ("model.rpn.num_upsample_filters", [32, 32, 32])):
        cfg = cfg.override(key, value)
    return cfg


@pytest.fixture(scope="module")
def both():
    det_pw = TorchDetector(make_cfg(TorchConfig, True), device="cpu")
    det_dn = TorchDetector(make_cfg(TorchConfig, False), device="cpu")
    assert not (det_pw.dense_cell or det_dn.dense_cell)
    params, stats = to_jax_variables(det_pw.init(
        torch.Generator().manual_seed(0)))
    variables = randomize_variables({"params": params, "batch_stats": stats},
                                    seed=5)
    state = from_jax_variables(variables["params"], variables["batch_stats"],
                               det_pw.config)
    jdets = {pw: JaxDetector(make_cfg(JaxConfig, pw)) for pw in (True, False)}
    return det_pw, det_dn, state, variables, jdets


def cloud(rng, n=3000, crowded=False):
    pts = np.zeros((2, 8192, 3), np.float32)
    spread = 0.15 if crowded else 6.0
    pts[:, :n, 0] = rng.uniform(0.2, 0.2 + spread, (2, n))
    pts[:, :n, 1] = rng.uniform(-2.4, 2.4, (2, n))
    pts[:, :n, 2] = rng.uniform(-2.5, 0.5, (2, n))
    return pts, np.asarray([n, n - 500], np.int32)


def _port(det, state, pts, num, train=False):
    vox = det.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num))
    with torch.no_grad():
        return det.apply(state, vox, train=train)


def _jax(jdet, variables, pts, num, train=False):
    fn = jax.jit(lambda v, p, n: jdet.apply(
        v, jdet.voxelize_batch(p, n), train=train,
        mutable=["batch_stats"] if train else False))
    return jax.device_get(fn(variables, jnp.asarray(pts), jnp.asarray(num)))


def _close_heads(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                   atol=HEAD_RTOL * np.abs(w).max(),
                                   err_msg=key)


class TestEquivalence:
    def test_eval_forward_identical(self, both, rng):
        det_pw, det_dn, state, variables, jdets = both
        pts, num = cloud(rng)
        preds_pw = _port(det_pw, state, pts, num)
        preds_dn = _port(det_dn, state, pts, num)
        # the same accumulation-order gap as the JAX test: cluster means
        # summed per pillar in f32 vs exact fixed-point segment sums
        for key in ("box_preds", "cls_preds"):
            np.testing.assert_allclose(preds_pw[key].numpy(),
                                       preds_dn[key].numpy(),
                                       rtol=1e-3, atol=5e-4)
        _close_heads(preds_dn, _jax(jdets[False], variables, pts, num))
        _close_heads(preds_pw, _jax(jdets[True], variables, pts, num))

    def test_eval_forward_identical_with_full_pillars(self, both, rng):
        """Crowded clouds: pillars reach the 50-point cap, where the
        processed zero row must not enter the max."""
        det_pw, det_dn, state, variables, jdets = both
        pts, num = cloud(rng, n=6000, crowded=True)
        vox = det_dn.voxelize_batch(torch.from_numpy(pts),
                                    torch.from_numpy(num))
        assert int(vox.num_points.max()) == 50
        preds_pw = _port(det_pw, state, pts, num)
        preds_dn = _port(det_dn, state, pts, num)
        np.testing.assert_allclose(preds_pw["box_preds"].numpy(),
                                   preds_dn["box_preds"].numpy(),
                                   rtol=2e-2, atol=1e-4)
        _close_heads(preds_dn, _jax(jdets[False], variables, pts, num))

    def test_train_stats_identical(self, both, rng):
        det_pw, det_dn, state, variables, jdets = both
        pts, num = cloud(rng)
        _, st_pw = _port(det_pw, state, pts, num, train=True)
        _, st_dn = _port(det_dn, state, pts, num, train=True)
        for key, rtol in (("pfn.bn.running_mean", 1e-4),
                          ("pfn.bn.running_var", 1e-3)):
            np.testing.assert_allclose(st_pw[key].numpy(),
                                       st_dn[key].numpy(), rtol=rtol,
                                       atol=1e-6)
        _, want = _jax(jdets[False], variables, pts, num, train=True)
        _, got = to_jax_variables(st_dn)
        for key in ("mean", "var"):
            w = np.asarray(want["batch_stats"]["pfn"]["bn"][key])
            np.testing.assert_allclose(got["pfn"]["bn"][key], w, rtol=1e-5,
                                       atol=1e-7)

    def test_grads_flow_and_match(self, both, rng):
        """Gradients of sum(box_preds^2) w.r.t. the PFN kernel: the two
        front ends close to each other, the dense one within 1e-4 of its
        max against the JAX package's."""
        det_pw, det_dn, state, variables, jdets = both
        pts, num = cloud(rng)

        def grad(det):
            vox = det.voxelize_batch(torch.from_numpy(pts),
                                     torch.from_numpy(num))
            params, stats = split_state(state)
            params = {k: v.clone().requires_grad_(True)
                      for k, v in params.items()}
            preds, _ = det.apply({**params, **stats}, vox, train=True)
            (preds["box_preds"] ** 2).sum().backward()
            return params_to_jax_tree({k: p.grad for k, p in params.items()
                                       if p.grad is not None})

        g_pw, g_dn = grad(det_pw), grad(det_dn)
        k_pw = g_pw["pfn"]["dense"]["kernel"]
        k_dn = g_dn["pfn"]["dense"]["kernel"]
        assert np.isfinite(k_dn).all() and np.abs(k_dn).max() > 0
        np.testing.assert_allclose(k_pw, k_dn, rtol=0,
                                   atol=1e-2 * np.abs(k_dn).max())

        jdet = jdets[False]

        def loss(params, p, n):
            preds, _ = jdet.apply({"params": params,
                                   "batch_stats": variables["batch_stats"]},
                                  jdet.voxelize_batch(p, n), train=True,
                                  mutable=["batch_stats"])
            return jnp.sum(preds["box_preds"] ** 2)

        want = jax.device_get(jax.jit(jax.grad(loss))(
            variables["params"], jnp.asarray(pts), jnp.asarray(num)))
        w = np.asarray(want["pfn"]["dense"]["kernel"])
        np.testing.assert_allclose(k_dn, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


# ----------------------------------------------------------------------
# the voxelizers

@pytest.mark.parametrize("max_voxels,n", [(2048, 1500), (300, 1500)])
def test_voxelize_against_jax(max_voxels, n):
    """B=2, different counts; the second case has more cells than pillars
    (the arrival-order cap and the overflow cutoff)."""
    cfg = TorchConfig.default().override("model.voxel.max_voxels",
                                         max_voxels).override(
        "model.voxel.max_points", 2048)
    jcfg = JaxConfig.default().override("model.voxel.max_voxels",
                                        max_voxels).override(
        "model.voxel.max_points", 2048)
    pts, num = d435i_clouds(max_voxels, 2, 2048, n)
    # 60 points in one cell: past the 50-point cap
    pts[:, :60] = [3.04, 0.01, 0.5] + np.random.RandomState(0).uniform(
        0, 0.02, (2, 60, 3))
    num[1] = n - 300
    got = make_voxelizer(cfg.model.voxel)(torch.from_numpy(pts),
                                          torch.from_numpy(num))
    fn = jax.jit(jax.vmap(jvox.make_voxelizer(jcfg.model.voxel)))
    want = jax.device_get(fn(jnp.asarray(pts), jnp.asarray(num)))
    assert int(got.num_points.max()) == 50
    if max_voxels == 300:
        assert bool(got.pillar_mask.all())
    for name, g, w in zip(want._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_voxelize_np_against_jax_and_voxelize():
    """The NumPy twin equals the JAX package's; ``voxelize`` holds the same
    pillars (in cell order, the twin in arrival order)."""
    pts, num = d435i_clouds(9, 1, 2048, 1200)
    vcfg = TorchConfig.default().override("model.voxel.max_voxels",
                                          2048).model.voxel
    args = (vcfg.voxel_size, vcfg.point_cloud_range,
            vcfg.max_points_per_voxel, vcfg.max_voxels)
    got = voxelize_np(pts[0, :1200], *args)
    want = jvox.voxelize_np(pts[0, :1200], *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    vox = make_voxelizer(vcfg)(torch.from_numpy(pts), torch.from_numpy(num))
    n = int(vox.pillar_mask.sum())
    assert n == len(got[0])
    order = np.lexsort(got[1].T[::-1])
    np.testing.assert_array_equal(vox.coords[0, :n].numpy(), got[1][order])
    np.testing.assert_array_equal(vox.num_points[0, :n].numpy(),
                                  got[2][order])
    np.testing.assert_array_equal(vox.voxels[0, :n].numpy(), got[0][order])


# ----------------------------------------------------------------------
# pfn.with_distance

@pytest.mark.parametrize("front", ["dense_cell", "point_major", "dense"])
def test_with_distance(front):
    """make_inference_fn with ``pfn.with_distance`` against the JAX
    package's: the dense-cell and point-major PFNs ignore it (an 8-wide
    kernel), PillarFeatureNet appends the point norm (9 wide)."""
    over = {"dense_cell": (),
            "point_major": (("model.pfn.dense_cell", False),),
            "dense": (("model.pfn.dense_cell", False),
                      ("model.pfn.pointwise", False))}[front]
    over += (("model.pfn.with_distance", True),)
    jcfg, tcfg = small_config(JaxConfig), small_config(TorchConfig)
    for key, value in over:
        jcfg, tcfg = jcfg.override(key, value), tcfg.override(key, value)
    tdet = TorchDetector(tcfg, device="cpu")
    assert tdet.dense_cell == (front == "dense_cell")
    params, stats = to_jax_variables(tdet.init(
        torch.Generator().manual_seed(2)))
    assert params["pfn"]["dense"]["kernel"].shape[0] == (
        9 if front == "dense" else 8)
    variables = randomize_variables({"params": params, "batch_stats": stats},
                                    seed=2)
    state = from_jax_variables(variables["params"], variables["batch_stats"],
                               tcfg)
    pts, num = d435i_clouds(4, 2, 2048, 1800)
    eye = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    want = jax.device_get(JaxDetector(jcfg).make_inference_fn()(
        variables, pts, num, eye, eye))
    got = tdet.make_inference_fn()(state, *(torch.from_numpy(a) for a in
                                            (pts, num, eye, eye)))
    compare_predictions(want, got)


@pytest.mark.parametrize("over", [
    (("model.pfn.simple_mean", True),),
    (("model.pfn.pointwise", False), ("model.pfn.with_distance", True)),
], ids=["simple_mean", "dense_layout_with_distance"])
def test_dense_cell_stays_off_where_its_pfn_cannot_read_the_weights(over):
    """On a grid that fits the dense cell, a front end whose weights the
    dense-cell PFN cannot read (SimpleVoxel has none; PillarFeatureNet
    with ``with_distance`` is 9 wide) infers through the network itself,
    giving what the same config with ``pfn.dense_cell`` off gives (held
    against the JAX package above). The JAX package's dense cell fails on
    these configs."""
    cfg = small_config(TorchConfig)
    for key, value in over:
        cfg = cfg.override(key, value)
    off = cfg.override("model.pfn.dense_cell", False)
    det, ref = (TorchDetector(c, device="cpu") for c in (cfg, off))
    assert cfg.model.pfn.dense_cell and not det.dense_cell
    state = det.init(torch.Generator().manual_seed(4))
    pts, num = d435i_clouds(6, 2, 2048, 1800)
    eye = torch.eye(4).expand(2, 4, 4)
    args = (torch.from_numpy(pts), torch.from_numpy(num), eye, eye)
    got = det.make_inference_fn()(state, *args)
    want = ref.make_inference_fn()(state, *args)
    assert got.valid.any()
    for name, g, w in zip(want._fields, got, want):
        assert torch.equal(g, w), name
