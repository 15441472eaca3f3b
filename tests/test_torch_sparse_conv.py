"""The port's sparse 3D convs (pillars_torch/ops/sparse_conv.py) and SECOND
sparse middle (pillars_torch/models/sparse_middle.py): the counterpart of
every case of tests/test_sparse_conv.py (dense NumPy oracles), and each
rulebook and active set integer-equal to pillars_tpu's, on the CPU.

The middle's outputs agree with the JAX package's within 1e-5 of their max
|value| (the same f32 products summed in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.models.sparse_middle import SparseMiddleExtractor
from pillars_torch.ops import sparse_conv as sp
from pillars_torch.weights import from_jax_variables, to_jax_variables
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.models.sparse_middle import (
    SparseMiddleExtractor as JaxSparseMiddle)
from pillars_tpu.ops import sparse_conv as jsp

torch.set_num_threads(2)
DIMS = (4, 6, 8)  # (nz, ny, nx)
MIDDLE_RTOL = 1e-5

# the JAX side jitted: eager sort/scan pipelines compile op by op
j_match = jax.jit(jsp.match_sorted, static_argnums=4)
j_nbr = jax.jit(jsp.neighbor_indices, static_argnums=(2, 3))
j_down = jax.jit(lambda *a: jsp.downsample_active_set(*a)[:2],
                 static_argnums=(2, 3, 4, 5, 6))
j_strided = jax.jit(jsp.strided_rulebook, static_argnums=(4, 5, 6, 7, 8))


def _random_active(rng, dims, n_active, cap):
    """Sorted-unique keys [cap] + valid prefix, the voxelizer layout."""
    n_cells = dims[0] * dims[1] * dims[2]
    keys = np.sort(rng.choice(n_cells, size=n_active, replace=False))
    full = np.full(cap, n_cells, np.int32)
    full[:n_active] = keys
    return full, np.arange(cap) < n_active


def _dense_from_sparse(keys, valid, feats, dims):
    dense = np.zeros((int(np.prod(dims)), feats.shape[-1]), np.float32)
    dense[keys[valid]] = feats[valid]
    return dense.reshape(dims + (feats.shape[-1],))


def dense_conv_oracle(dense, taps, kernel, stride, padding):
    """Direct NumPy conv: out[o] = sum_t in[stride*o - pad + t] @ W[t]."""
    dims = dense.shape[:3]
    odims = tuple(sp.conv_out_dim(n, k, s, p)
                  for n, k, s, p in zip(dims, kernel, stride, padding))
    out = np.zeros(odims + (taps.shape[-1],), np.float32)
    offs = sp.kernel_offsets(kernel)
    for o in np.ndindex(*odims):
        for t, off in enumerate(offs):
            p = [o[i] * stride[i] - padding[i] + off[i] for i in range(3)]
            if all(0 <= p[i] < dims[i] for i in range(3)):
                out[o] += dense[tuple(p)] @ taps[t]
    return out


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _oracle_rulebook(keys, valid, dims, cap):
    lookup = {int(k): i for i, k in enumerate(keys[valid])}
    want = np.full((cap, 27), cap)
    for v in np.flatnonzero(valid):
        z, y, x = np.unravel_index(keys[v], dims)
        for t, (dz, dy, dx) in enumerate(sp.kernel_offsets((3, 3, 3))):
            p = (z + dz - 1, y + dy - 1, x + dx - 1)
            if all(0 <= p[i] < dims[i] for i in range(3)):
                want[v, t] = lookup.get(
                    int(np.ravel_multi_index(p, dims)), cap)
    return want


class TestMatchSorted:
    def test_against_dict(self, rng):
        n_cells, cap = 1000, 80
        keys = np.sort(rng.choice(n_cells, 60, replace=False)).astype(np.int32)
        full = np.full(cap, n_cells, np.int32)
        full[:60] = keys
        valid = np.arange(cap) < 60
        q = rng.randint(0, n_cells, size=200).astype(np.int32)
        qvalid = rng.rand(200) > 0.1
        got = sp.match_sorted(*_t(full, valid, q, qvalid), n_cells).numpy()
        lookup = {int(k): i for i, k in enumerate(keys)}
        want = [lookup.get(int(q[m]), cap) if qvalid[m] else cap
                for m in range(200)]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, np.asarray(j_match(
            *(jnp.asarray(a) for a in (full, valid, q, qvalid)), n_cells)))

    def test_all_invalid(self):
        got = sp.match_sorted(torch.full((8,), 50, dtype=torch.int32),
                              torch.zeros(8, dtype=torch.bool),
                              torch.arange(5, dtype=torch.int32),
                              torch.ones(5, dtype=torch.bool), 50)
        assert torch.all(got == 8)


class TestSubmConv:
    @pytest.mark.parametrize("n_active", [1, 17, 40])
    def test_vs_dense_oracle(self, rng, n_active):
        cap, cin, cout = 48, 5, 7
        keys, valid = _random_active(rng, DIMS, n_active, cap)
        feats = (rng.randn(cap, cin) * valid[:, None]).astype(np.float32)
        w = (rng.randn(27, cin, cout) * 0.2).astype(np.float32)
        nbr = sp.neighbor_indices(*_t(keys, valid), DIMS, (3, 3, 3))
        np.testing.assert_array_equal(nbr.numpy(), np.asarray(
            j_nbr(jnp.asarray(keys), jnp.asarray(valid), DIMS,
                                 (3, 3, 3))))
        out = sp.gather_conv(*_t(feats), nbr, *_t(w)).numpy()
        ref = dense_conv_oracle(_dense_from_sparse(keys, valid, feats, DIMS),
                                w, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        for v in np.flatnonzero(valid):
            np.testing.assert_allclose(
                out[v], ref[np.unravel_index(keys[v], DIMS)],
                rtol=1e-5, atol=1e-5)

    def test_neighbor_indices_oracle(self, rng):
        cap = 32
        keys, valid = _random_active(rng, DIMS, 20, cap)
        nbr = sp.neighbor_indices(*_t(keys, valid), DIMS, (3, 3, 3)).numpy()
        np.testing.assert_array_equal(nbr, _oracle_rulebook(keys, valid,
                                                            DIMS, cap))
        # the centre tap is the voxel itself
        np.testing.assert_array_equal(nbr[valid, 13], np.flatnonzero(valid))

    def test_neighbor_indices_dense_runs_and_borders(self):
        """Full x-rows of consecutive keys, actives on the x borders (key
        adjacency wraps grid rows, the grid does not) and a leading query
        with no preceding source."""
        dims = (2, 3, 5)
        pts = ([(0, 0, x) for x in range(5)] + [(1, 2, 0), (1, 2, 2),
                                                 (1, 2, 4), (1, 0, 3)])
        keys = np.sort([(z * 3 + y) * 5 + x for z, y, x in pts])
        cap = 16
        full = np.full(cap, 30, np.int32)
        full[:len(keys)] = keys
        valid = np.arange(cap) < len(keys)
        nbr = sp.neighbor_indices(*_t(full, valid), dims, (3, 3, 3)).numpy()
        np.testing.assert_array_equal(nbr, _oracle_rulebook(full, valid,
                                                            dims, cap))
        np.testing.assert_array_equal(nbr, np.asarray(j_nbr(
            jnp.asarray(full), jnp.asarray(valid), dims, (3, 3, 3))))

    def test_batched_equals_per_sample(self, rng):
        cap = 40
        rows = [_random_active(rng, DIMS, n, cap) for n in (12, 33)]
        keys = torch.from_numpy(np.stack([k for k, _ in rows]))
        valid = torch.from_numpy(np.stack([v for _, v in rows]))
        nbr = sp.neighbor_indices(keys, valid, DIMS, (3, 3, 3))
        for i in range(2):
            assert torch.equal(nbr[i], sp.neighbor_indices(
                keys[i], valid[i], DIMS, (3, 3, 3)))


class TestStridedConv:
    @pytest.mark.parametrize("kernel,stride", [
        ((3, 3, 3), (2, 2, 2)),
        ((3, 1, 1), (2, 1, 1)),
        ((3, 3, 3), (1, 1, 1)),
    ])
    def test_vs_dense_oracle(self, rng, kernel, stride):
        cap, cin, cout, ocap = 48, 4, 6, 512
        pad = tuple((k - 1) // 2 for k in kernel)
        keys, valid = _random_active(rng, DIMS, 25, cap)
        feats = (rng.randn(cap, cin) * valid[:, None]).astype(np.float32)
        K = int(np.prod(kernel))
        w = (rng.randn(K, cin, cout) * 0.2).astype(np.float32)
        okeys, ovalid, odims = sp.downsample_active_set(
            *_t(keys, valid), DIMS, kernel, stride, pad, ocap)
        nbr = sp.strided_rulebook(*_t(keys, valid), okeys, ovalid, DIMS,
                                  odims, kernel, stride, pad)
        jk, jv = j_down(jnp.asarray(keys), jnp.asarray(valid), DIMS, kernel,
                        stride, pad, ocap)
        np.testing.assert_array_equal(okeys.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ovalid.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(nbr.numpy(), np.asarray(
            j_strided(jnp.asarray(keys), jnp.asarray(valid), jk,
                                 jv, DIMS, odims, kernel, stride, pad)))

        # the oracle's active set: outputs with an active input in window
        want_active = set()
        for k in keys[valid]:
            c = np.unravel_index(k, DIMS)
            for off in sp.kernel_offsets(kernel):
                num = [c[i] + pad[i] - off[i] for i in range(3)]
                o = [n // s for n, s in zip(num, stride)]
                if (all(n == oo * s for n, oo, s in zip(num, o, stride))
                        and all(0 <= o[i] < odims[i] for i in range(3))):
                    want_active.add(int(np.ravel_multi_index(o, odims)))
        ok, ov = okeys.numpy(), ovalid.numpy()
        assert set(ok[ov].tolist()) == want_active
        assert np.all(np.sort(ok[ov]) == ok[ov])  # sorted-unique layout

        out = sp.gather_conv(*_t(feats), nbr, *_t(w)).numpy()
        ref = dense_conv_oracle(_dense_from_sparse(keys, valid, feats, DIMS),
                                w, kernel, stride, pad)
        for v in np.flatnonzero(ov):
            np.testing.assert_allclose(
                out[v], ref[np.unravel_index(ok[v], odims)],
                rtol=1e-5, atol=1e-5)

    def test_cap_overflow_keeps_lowest_keys(self, rng):
        # stride 1, kernel 3: the active set dilates; past a tight cap the
        # lowest output keys survive
        keys, valid = _random_active(rng, DIMS, 20, 32)
        args = (DIMS, (3, 3, 3), (1, 1, 1), (1, 1, 1))
        okeys, ovalid, _ = sp.downsample_active_set(*_t(keys, valid), *args,
                                                    10)
        big, big_valid, _ = sp.downsample_active_set(*_t(keys, valid), *args,
                                                     512)
        full = big[big_valid].numpy()
        assert len(full) > 10
        np.testing.assert_array_equal(okeys[ovalid].numpy(),
                                      np.sort(full)[:10])
        jk, jv = j_down(jnp.asarray(keys), jnp.asarray(valid), *args, 10)
        np.testing.assert_array_equal(okeys.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(ovalid.numpy(), np.asarray(jv))


def _middle_cfg(cls):
    cfg = cls.default()
    for key, value in (
            ("model.voxel.voxel_size", [0.8, 0.64, 0.75]),  # 8 x 8 x 8
            ("model.voxel.max_voxels", 64),
            ("model.voxel.max_points", 256),
            ("model.middle.enabled", True),
            ("model.middle.sparse", True),
            ("model.middle.num_filters", [8, 16]),
            ("model.middle.subm_per_stage", 1),
            ("model.middle.downsample_strides", [[2, 2, 2], [2, 1, 1]]),
            ("model.middle.downsample_kernels", [[3, 3, 3], [3, 1, 1]]),
            ("model.pfn.pointwise", False),
            ("model.pfn.dense_cell", False),
            ("model.rpn.layer_nums", [1, 1, 1]),
            ("model.rpn.num_filters", [16, 16, 16]),
            ("model.rpn.num_upsample_filters", [16, 16, 16])):
        cfg = cfg.override(key, value)
    return cfg


def _middle_inputs(rng, dims=(8, 8, 8), cap=64, cin=4, b=2, n=30):
    feats = np.zeros((b, cap, cin), np.float32)
    coords = np.zeros((b, cap, 3), np.int32)
    mask = np.zeros((b, cap), bool)
    for i in range(b):
        k, v = _random_active(np.random.RandomState(i), dims, n, cap)
        coords[i] = np.stack(np.unravel_index(np.where(v, k, 0), dims), -1)
        mask[i] = v
        feats[i] = rng.randn(cap, cin).astype(np.float32) * v[:, None]
    return feats, coords, mask


def _middle_state(mcfg, feats, seed=0):
    """The middle's state from the port's initialiser, random BN."""
    mid = SparseMiddleExtractor(mcfg, feats.shape[-1]).eval()
    r = np.random.RandomState(seed)
    state = {}
    for k, v in mid.state_dict().items():
        if k.endswith("running_var"):
            a = r.uniform(0.5, 2.0, v.shape)
        elif k.endswith("weight") and v.ndim == 3:
            a = r.randn(*v.shape) * np.sqrt(2.0 / (v.shape[0] * v.shape[1]))
        elif k.endswith("weight"):
            a = r.uniform(0.5, 1.5, v.shape)
        else:
            a = r.randn(*v.shape) * 0.1
        state[k] = torch.from_numpy(a.astype(np.float32))
    return mid, state


class TestSparseMiddleExtractor:
    def test_shapes_and_batch_fold(self, rng):
        """Output shape, equality with per-sample runs, and the JAX
        package's middle on the same inputs and weights (eval and train
        mode, with the new BN statistics)."""
        mcfg = _middle_cfg(TorchConfig).model
        feats, coords, mask = _middle_inputs(rng)
        mid, state = _middle_state(mcfg, feats)
        inputs = _t(feats, coords, mask)
        with torch.no_grad():
            out = torch.func.functional_call(mid, state, tuple(inputs))
        # 8x8x8 -> s(2,2,2): 4x4x4 -> s(2,1,1): 2x4x4; z folds: 2 * 16
        assert out.shape == (2, 4, 4, 32)
        assert torch.isfinite(out).all()
        for i in range(2):
            with torch.no_grad():
                solo = torch.func.functional_call(
                    mid, state, tuple(t[i:i + 1] for t in inputs))
            torch.testing.assert_close(out[i], solo[0], rtol=1e-5, atol=1e-5)

        params, stats = to_jax_variables(state)
        jmid = JaxSparseMiddle(_middle_cfg(JaxConfig).model)
        jin = [jnp.asarray(a) for a in (feats, coords, mask)]
        variables = {"params": params, "batch_stats": stats}
        want = np.asarray(jax.jit(lambda v, *a: jmid.apply(v, *a, False))(
            variables, *jin))
        np.testing.assert_allclose(out.numpy(), want, rtol=0,
                                   atol=MIDDLE_RTOL * np.abs(want).max())
        want_t, new = jax.jit(lambda v, *a: jmid.apply(
            v, *a, True, mutable=["batch_stats"]))(variables, *jin)
        mid.train()
        got_t = torch.func.functional_call(mid, state, tuple(inputs))
        from pillars_torch.models.layers import collect_batch_stats

        got_stats = collect_batch_stats(mid)
        mid.eval()
        np.testing.assert_allclose(
            got_t.detach().numpy(), np.asarray(want_t), rtol=0,
            atol=MIDDLE_RTOL * np.abs(np.asarray(want_t)).max())
        _, want_stats = to_jax_variables(got_stats)
        jax_stats = jax.device_get(new["batch_stats"])
        for layer, leaves in want_stats.items():
            for key in ("mean", "var"):
                w = np.asarray(jax_stats[layer]["bn"][key])
                np.testing.assert_allclose(
                    leaves["bn"][key], w, rtol=0,
                    atol=MIDDLE_RTOL * max(np.abs(w).max(), 1e-6),
                    err_msg=f"{layer} {key}")

    def test_rulebooks_equal_jax_per_stage(self, rng):
        mcfg = _middle_cfg(TorchConfig).model
        feats, coords, mask = _middle_inputs(rng)
        mid, _ = _middle_state(mcfg, feats)
        stages, _ = mid.rulebooks(*_t(coords, mask))
        dims, cap = (8, 8, 8), 64
        for i in range(2):
            keys = ((coords[i, :, 0] * 8 + coords[i, :, 1]) * 8
                    + coords[i, :, 2])
            keys = jnp.asarray(np.where(mask[i], keys, 512), jnp.int32)
            valid = jnp.asarray(mask[i])
            d = dims
            for (_, _, subm, okeys, ovalid, down), stride, kernel in zip(
                    stages, ((2, 2, 2), (2, 1, 1)), ((3, 3, 3), (3, 1, 1))):
                pad = tuple((k - 1) // 2 for k in kernel)
                np.testing.assert_array_equal(
                    subm[i].numpy(), np.asarray(j_nbr(
                        keys, valid, d, (3, 3, 3))))
                jk, jv = j_down(keys, valid, d, kernel, stride, pad, cap)
                od = tuple(sp.conv_out_dim(n, k, s, q) for n, k, s, q in
                           zip(d, kernel, stride, pad))
                np.testing.assert_array_equal(okeys[i].numpy(),
                                              np.asarray(jk))
                np.testing.assert_array_equal(ovalid[i].numpy(),
                                              np.asarray(jv))
                np.testing.assert_array_equal(
                    down[i].numpy(), np.asarray(j_strided(
                        keys, valid, jk, jv, d, od, kernel, stride, pad)))
                keys, valid, d = jk, jv, od

    def test_grads_flow_through_sparse_convs(self, rng):
        cfg = _middle_cfg(TorchConfig)
        det = TorchDetector(cfg, device="cpu")
        state = det.init(torch.Generator().manual_seed(0))
        n = 120
        pts = np.zeros((1, 256, 3), np.float32)
        pts[0, :n] = np.stack([rng.uniform(0, 6.4, n),
                               rng.uniform(-2.5, 2.5, n),
                               rng.uniform(-2.9, 2.9, n)], 1)
        vox = det.voxelize_batch(*_t(pts, np.asarray([n], np.int32)))
        params = {k: v.requires_grad_(True) for k, v in state.items()
                  if v.is_floating_point() and "running" not in k}
        preds, _ = det.apply({**state, **params}, vox, train=True)
        (preds["box_preds"] ** 2).sum().backward()
        touched = 0
        for name, p in params.items():
            assert p.grad is None or torch.isfinite(p.grad).all(), name
            if name.startswith("middle.") and p.grad is not None \
                    and p.grad.abs().max() > 0:
                touched += 1
        assert touched >= 4  # every sparse conv stage gets gradient

    def test_kitti_second_config(self):
        cfg = TorchConfig.from_yaml("configs/kitti_second.yaml")
        assert cfg.model.middle.sparse
        assert cfg.model.voxel.grid_size == (1408, 1600, 40)
        # 1600x1408 -> /2 -> /2 -> y/x untouched by the z-squash stage
        assert cfg.model.feature_map_size == (1, 400, 352)
        assert cfg.model.pfn.simple_mean
        net = TorchDetector(cfg, device="cpu").network
        # the (3, 1, 1) z-squash: 3 taps, 5 z-layers left of 40
        assert net.middle.down2.weight.shape == (3, 64, 64)
        assert net.rpn.block1.conv0.weight.shape[1] == 5 * 64

    def test_train_step_runs(self, rng):
        """The port's train step (voxelize, targets, forward, backward,
        AdamW) through the sparse middle on a tiny grid."""
        from pillars_torch.train.loop import (create_train_state,
                                              make_train_step)

        cfg = _middle_cfg(TorchConfig)
        det = TorchDetector(cfg, device="cpu")
        state, opt = create_train_state(det, torch.Generator().manual_seed(0),
                                        2)
        step = make_train_step(det, opt)
        n, g = 150, cfg.model.target.max_gt_boxes
        pts = np.zeros((2, 256, 3), np.float32)
        pts[:, :n] = np.stack([rng.uniform(0, 6.4, (2, n)),
                               rng.uniform(-2.5, 2.5, (2, n)),
                               rng.uniform(-2.9, 0.5, (2, n))], -1)
        gt = np.zeros((2, g, 7), np.float32)
        gt[..., 3:6] = 1.0
        gt[:, 0] = [3.0, 0.0, -1.5, 0.6, 0.8, 1.73, 0.3]
        batch = dict(points=pts, num_points=np.full((2,), n, np.int32),
                     gt_boxes=gt, gt_classes=np.ones((2, g), np.int32),
                     gt_valid=np.arange(g)[None].repeat(2, 0) == 0)
        state2, metrics = step(state, batch)
        assert torch.isfinite(metrics.loss)
        assert state2.step == 1
        assert not torch.equal(state.params["middle.subm0_0.weight"],
                               state2.params["middle.subm0_0.weight"])
        assert not torch.equal(
            state.batch_stats["middle.down1.bn.running_mean"],
            state2.batch_stats["middle.down1.bn.running_mean"])

    @pytest.mark.parametrize("pointwise", [False, True])
    def test_detector_forward(self, rng, pointwise):
        """apply on the dense layout and, with SimpleVoxel over the
        point-major voxelizer (the kitti_second front end), against the JAX
        package's on the same weights."""
        overrides = ((("model.pfn.pointwise", True),
                      ("model.pfn.simple_mean", True)) if pointwise else ())
        tcfg, jcfg = _middle_cfg(TorchConfig), _middle_cfg(JaxConfig)
        for key, value in overrides:
            tcfg, jcfg = tcfg.override(key, value), jcfg.override(key, value)
        det = TorchDetector(tcfg, device="cpu")
        jdet = JaxDetector(jcfg)
        state = det.init(torch.Generator().manual_seed(1))
        params, stats = to_jax_variables(state)
        n = 100
        pts = np.zeros((1, 256, 3), np.float32)
        pts[0, :n] = np.stack([rng.uniform(0, 6.4, n),
                               rng.uniform(-2.5, 2.5, n),
                               rng.uniform(-2.9, 2.9, n)], 1)
        num = np.asarray([n], np.int32)
        with torch.no_grad():
            got = det.apply(state, det.voxelize_batch(*_t(pts, num)))
        _, ny, nx = tcfg.model.feature_map_size
        assert got["cls_preds"].shape[1:3] == (ny, nx)
        want = jax.jit(lambda v, p, n: jdet.apply(v, jdet.voxelize_batch(
            p, n)))({"params": params, "batch_stats": stats},
                    jnp.asarray(pts), jnp.asarray(num))
        for key, w in jax.device_get(want).items():
            np.testing.assert_allclose(got[key].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=key)
        assert set(from_jax_variables(params, stats, tcfg)) == set(state)

