"""SECOND in the port against pillars_tpu on the CPU: the dense middle
(``scatter_to_grid3d``, ``MiddleExtractor3D`` with flax's SAME padding),
``second_d435i`` and ``second_sparse_d435i`` end to end through
``make_inference_fn`` at reduced width (B=1, B=2) and one full-width sparse
cloud from the trained checkpoint, forward + loss + gradients in float64
for both middles, ``kitti_second`` at reduced width, and a SECOND checkpoint
through the flax layout and back.

Predictions: ``torch_parity.compare_predictions`` (valid and labels equal,
scores 1e-5, boxes 1e-4 + 2e-5 relative). The f64 comparison maps the JAX
package's f32 casts to f64 as tests/test_torch_train_step.py does; every
gradient leaf and new BN statistic within 1e-9 of its max |value|. The JAX
side takes its weights from the port's initialiser through
``to_jax_variables`` (flax's init runs the sparse pipeline eagerly).
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pillars_tpu.models.losses as jax_losses
import pillars_tpu.models.pfn as jax_pfn
from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.models.middle import MiddleExtractor3D, scatter_to_grid3d
from pillars_torch.models.layers import collect_batch_stats
from pillars_torch.train.loop import split_state
from pillars_torch.weights import (from_jax_variables, load_params,
                                   params_to_jax_tree, to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.models.middle import MiddleExtractor3D as JaxMiddle3D
from pillars_tpu.models.middle import scatter_to_grid3d as jax_scatter3d
from pillars_tpu.ops.voxelize import VoxelizedPoints as JaxVoxelizedPoints
from pillars_tpu.train.checkpoint import load_params as jax_load_params
from torch_parity import (compare_predictions, d435i_clouds,
                          randomize_variables, train_batches)

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
WEIGHTS_33 = str(ROOT / "benchmarks" / "second_sparse_synth"
                 / "weights_33.pkl")
MIDDLE_RTOL = 1e-5
F64_TOL = 1e-9

# a narrow RPN, a small point pad and voxel budget, four gt slots
REDUCED = (
    ("model.rpn.layer_nums", [1, 1, 1]),
    ("model.rpn.num_filters", [16, 16, 32]),
    ("model.rpn.num_upsample_filters", [16, 16, 16]),
    ("model.voxel.max_points", 4096),
    ("model.target.max_gt_boxes", 4),
)
CONFIGS = {
    "second_sparse_d435i": REDUCED + (("model.voxel.max_voxels", 3000),
                                      ("model.middle.max_active", 3000)),
    "second_d435i": REDUCED + (("model.voxel.max_voxels", 2048),),
}


def reduced(cls, name):
    cfg = cls.from_yaml(str(ROOT / "configs" / f"{name}.yaml"))
    for key, value in CONFIGS[name]:
        cfg = cfg.override(key, value)
    return cfg


def _random_state(tdet, seed):
    """A port state and the same values as a flax tree, random BN."""
    params, stats = to_jax_variables(
        tdet.init(torch.Generator().manual_seed(seed)))
    variables = randomize_variables({"params": params, "batch_stats": stats},
                                    seed)
    return (from_jax_variables(variables["params"], variables["batch_stats"],
                               tdet.config), variables)


# ----------------------------------------------------------------------
# the dense middle

def test_scatter_places_by_zyx():
    feats = torch.tensor([[[1.0], [2.0], [3.0]]])
    coords = torch.tensor([[[0, 1, 2], [3, 1, 2], [0, 0, 0]]])
    mask = torch.tensor([[True, True, False]])
    grid = scatter_to_grid3d(feats, coords, mask, nz=4, ny=2, nx=3)
    assert grid[0, 0, 1, 2, 0] == 1.0 and grid[0, 3, 1, 2, 0] == 2.0
    assert grid.sum() == 3.0  # the padding row dropped


def test_scatter_to_grid3d_against_jax(rng):
    """B=2 with a shared cell (the features add) and padding rows."""
    b, v, c, dims = 2, 40, 5, (6, 4, 5)
    coords = np.stack([rng.randint(0, n, (b, v)) for n in dims],
                      -1).astype(np.int32)
    coords[:, 1] = coords[:, 0]
    mask = rng.rand(b, v) > 0.2
    feats = rng.randn(b, v, c).astype(np.float32)
    got = scatter_to_grid3d(*(torch.from_numpy(a) for a in
                              (feats, coords, mask)), *dims)
    want = jax.vmap(lambda f, co, m: jax_scatter3d(f, co, m, *dims))(
        jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("nz", [16, 5])
def test_middle3d_against_jax(rng, nz):
    """Eval and train mode, with the new BN statistics. At nz=16 flax's
    SAME pads z by (0, 1) at stride 2 (16 -> 8 -> 4); at nz=5 by (1, 1)."""
    tcfg = reduced(TorchConfig, "second_d435i").override(
        "model.voxel.voxel_size", [0.08, 0.08, 6.0 / nz])
    mcfg = tcfg.model
    assert mcfg.voxel.grid_size[2] == nz
    grid = rng.randn(2, nz, 6, 7, 16).astype(np.float32)
    mid = MiddleExtractor3D(mcfg, 16).eval()
    r = np.random.RandomState(nz)
    state = {}
    for k, v in mid.state_dict().items():
        if not v.is_floating_point():  # num_batches_tracked
            state[k] = v
            continue
        positive = k.endswith(("running_var", "bn0.weight", "bn1.weight"))
        a = r.uniform(0.5, 2.0, v.shape) if positive else (
            r.randn(*v.shape) * 0.1)
        state[k] = torch.from_numpy(a.astype(np.float32))
    params, stats = to_jax_variables(state)
    jmid = JaxMiddle3D(JaxConfig.from_yaml(
        str(ROOT / "configs" / "second_d435i.yaml")).override(
        "model.voxel.voxel_size", [0.08, 0.08, 6.0 / nz]).model)
    variables = {"params": params, "batch_stats": stats}
    for train in (False, True):
        mid.train(train)
        got = torch.func.functional_call(mid, state,
                                         (torch.from_numpy(grid),))
        got_stats = collect_batch_stats(mid)
        want, new = jax.jit(lambda v, g: jmid.apply(
            v, g, train, mutable=["batch_stats"]))(variables,
                                                   jnp.asarray(grid))
        want = np.asarray(want)
        assert got.shape == want.shape == (2, 6, 7, -(-nz // 4) * 32)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=MIDDLE_RTOL * np.abs(want).max(),
                                   err_msg=f"train={train}")
        if train:
            _, got_tree = to_jax_variables(got_stats)
            for layer in ("bn0", "bn1"):
                for key in ("mean", "var"):
                    w = np.asarray(new["batch_stats"][layer][key])
                    np.testing.assert_allclose(
                        got_tree[layer][key], w, rtol=0,
                        atol=MIDDLE_RTOL * np.abs(w).max())


# ----------------------------------------------------------------------
# end to end

def _run_both(name, batch, seed):
    jcfg, tcfg = reduced(JaxConfig, name), reduced(TorchConfig, name)
    tdet = TorchDetector(tcfg, device="cpu")
    state, variables = _random_state(tdet, seed)
    pts, num = d435i_clouds(seed, batch, 4096, 1500)
    rect = np.tile(np.eye(4, dtype=np.float32), (batch, 1, 1))
    trv2c = rect.copy()
    trv2c[:, :3, 3] = [0.1, -0.2, 0.3]
    want = jax.device_get(JaxDetector(jcfg).make_inference_fn()(
        variables, pts, num, rect, trv2c))
    got = tdet.make_inference_fn()(state, *(torch.from_numpy(a) for a in
                                            (pts, num, rect, trv2c)))
    return want, got


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("name", ["second_sparse_d435i", "second_d435i"])
def test_inference_reduced_against_jax(name, batch):
    want, got = _run_both(name, batch, seed=batch)
    compare_predictions(want, got)


def test_sparse_full_width_trained_checkpoint():
    """second_sparse_d435i at its full width (grid 160 x 128 x 16, 20000
    voxels and active rows) with benchmarks/second_sparse_synth/
    weights_33.pkl, one cloud of 15000 points."""
    path = str(ROOT / "configs" / "second_sparse_d435i.yaml")
    jcfg, tcfg = JaxConfig.from_yaml(path), TorchConfig.from_yaml(path)
    params, stats = jax_load_params(WEIGHTS_33)
    state = from_jax_variables(*load_params(WEIGHTS_33), tcfg)
    pts, num = d435i_clouds(5, 1, tcfg.model.voxel.max_points, 15000)
    eye = np.eye(4, dtype=np.float32)[None]
    want = jax.device_get(JaxDetector(jcfg).make_inference_fn()(
        {"params": params, "batch_stats": stats}, pts, num, eye, eye))
    tdet = TorchDetector(tcfg, device="cpu")
    got = tdet.make_inference_fn()(state, *(torch.from_numpy(a) for a in
                                            (pts, num, eye, eye)))
    compare_predictions(want, got)
    v = tdet.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num))
    assert int(v.pillar_mask.sum()) > 10000


def test_kitti_second_reduced():
    """kitti_second (the 1408 x 1600 x 40 grid, the (3, 1, 1) z-squash
    stage, 4 point features) at a narrow width: make_inference_fn against
    the JAX package, then apply(train=True) and the loss run."""
    over = (("model.voxel.max_points", 4096), ("model.voxel.max_voxels", 2000),
            ("model.middle.max_active", 2000),
            ("model.middle.num_filters", [8, 8, 16]),
            ("model.rpn.layer_nums", [1, 1, 1]),
            ("model.rpn.num_filters", [8, 8, 8]),
            ("model.rpn.num_upsample_filters", [8, 8, 8]))
    path = str(ROOT / "configs" / "kitti_second.yaml")
    jcfg, tcfg = JaxConfig.from_yaml(path), TorchConfig.from_yaml(path)
    for key, value in over:
        jcfg, tcfg = jcfg.override(key, value), tcfg.override(key, value)
    tdet = TorchDetector(tcfg, device="cpu")
    state, variables = _random_state(tdet, 7)
    r = np.random.RandomState(7)
    pts = np.zeros((1, 4096, 4), np.float32)
    n = 3500
    pts[0, :n] = np.stack([r.uniform(0, 70, n), r.uniform(-40, 40, n),
                           r.uniform(-3, 1, n), r.uniform(0, 1, n)], 1)
    num = np.asarray([n], np.int32)
    eye = np.eye(4, dtype=np.float32)[None]
    want = jax.device_get(JaxDetector(jcfg).make_inference_fn()(
        variables, pts, num, eye, eye))
    got = tdet.make_inference_fn()(state, *(torch.from_numpy(a) for a in
                                            (pts, num, eye, eye)))
    compare_predictions(want, got)
    v = tdet.voxelize_batch(torch.from_numpy(pts), torch.from_numpy(num))
    params, stats = split_state(state)
    params = {k: p.requires_grad_(True) for k, p in params.items()}
    preds, new_stats = tdet.apply({**params, **stats}, v, train=True)
    assert "middle.down2.bn.running_var" in new_stats
    amask = tdet.anchors_mask_batch(v.coords, v.pillar_mask, 1.0)
    gt = torch.zeros((1, 48, 7))
    gt[..., 3:6] = 1.0
    gt[0, 0] = torch.tensor([20.0, 0.0, -1.0, 1.6, 3.9, 1.56, 0.3])
    t = tdet.assign_targets(gt, torch.ones((1, 48), dtype=torch.int32),
                            torch.arange(48)[None] == 0, amask)
    loss = tdet.loss(preds, t.labels, t.bbox_targets)
    assert torch.isfinite(loss.loss)
    loss.loss.backward()
    assert params["middle.down2.weight"].grad.abs().max() > 0


# ----------------------------------------------------------------------
# forward + loss + gradients in float64

class _F64Numpy:
    """``jnp`` whose ``float32`` is float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", np.asarray(tree[k])


@pytest.mark.parametrize("name", ["second_sparse_d435i", "second_d435i"])
def test_forward_loss_grads_match_jax_in_f64(monkeypatch, name):
    jcfg, tcfg = reduced(JaxConfig, name), reduced(TorchConfig, name)
    jdet, tdet = JaxDetector(jcfg), TorchDetector(tcfg, device="cpu")
    batch = train_batches(3, 1, maxpts=4096)[0]
    thr = tcfg.train_input.anchor_area_threshold
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
    as64 = lambda a: (np.asarray(a, np.float64)  # noqa: E731
                      if np.issubdtype(np.asarray(a).dtype, np.floating)
                      else np.asarray(a))
    vox64 = [as64(t.numpy()) for t in tv]
    reg64 = as64(targets.bbox_targets.numpy())

    monkeypatch.setattr(jax_losses, "jnp", _F64Numpy())
    monkeypatch.setattr(jax_pfn, "jnp", _F64Numpy())
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(as64, params32)
        s64 = jax.tree_util.tree_map(as64, stats32)

        def f(params):
            preds, mut = jdet.network.apply(
                {"params": params, "batch_stats": s64},
                JaxVoxelizedPoints(*(jnp.asarray(a) for a in vox64)), True,
                mutable=["batch_stats"])
            out = jdet.loss(preds, jnp.asarray(labels), jnp.asarray(reg64))
            return out.loss, (out, mut["batch_stats"])

        (_, (want, want_stats)), jgrads = jax.jit(jax.value_and_grad(
            f, has_aux=True))(jax.tree_util.tree_map(jnp.asarray, p64))
        jgrads = jax.device_get(jgrads)
        assert np.asarray(want.loss).dtype == np.float64

    state = {k: v.double() if v.is_floating_point() else v
             for k, v in state32.items()}
    params, stats = split_state(state)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    tv = type(tv)(*(torch.from_numpy(a) for a in vox64))
    preds, new_stats = tdet.apply({**params, **stats}, tv, train=True)
    out = tdet.loss(preds, targets.labels, torch.from_numpy(reg64))
    out.loss.backward()
    for field, g, w in zip(out._fields, out, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=F64_TOL, atol=1e-12, err_msg=field)
    got_grads = params_to_jax_tree({k: p.grad for k, p in params.items()})
    got_stats = to_jax_variables(new_stats)[1]
    for got, want, what in ((got_grads, jgrads, "grad"),
                            (got_stats, jax.device_get(want_stats), "stat")):
        want, got = list(_leaves(want)), list(_leaves(got))
        assert [p for p, _ in got] == [p for p, _ in want]
        assert any("middle" in p for p, _ in got)
        for (path, w), (_, g) in zip(want, got):
            assert g.dtype == np.float64, path
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=F64_TOL * np.abs(w).max(),
                                       err_msg=f"{what} {path}")


# ----------------------------------------------------------------------
# checkpoints

def test_checkpoint_round_trip(tmp_path):
    """weights_33.pkl -> the port's state -> the flax layout gives the same
    trees; a port checkpoint of it reads back into the JAX package and
    the port alike."""
    from pillars_torch.train import checkpoint as tckpt
    from pillars_torch.train.loop import create_train_state

    tcfg = TorchConfig.from_yaml(str(ROOT / "configs"
                                     / "second_sparse_d435i.yaml"))
    params, stats = load_params(WEIGHTS_33)
    state = from_jax_variables(params, stats, tcfg)
    assert any(k.startswith("middle.subm0_0.") for k in state)
    back_p, back_s = to_jax_variables(state)
    for tree, back in ((params, back_p), (stats, back_s)):
        want, got = list(_leaves(tree)), list(_leaves(back))
        assert [p for p, _ in want] == [p for p, _ in got]
        for (path, w), (_, g) in zip(want, got):
            np.testing.assert_array_equal(g, w, err_msg=path)

    det = TorchDetector(tcfg, device="cpu")
    ts, _ = create_train_state(det, torch.Generator().manual_seed(0), 2)
    p, s = split_state(state)
    ts = ts._replace(params=p, batch_stats=s)
    path = str(tmp_path / "ckpt.pkl")
    tckpt.save_checkpoint(path, ts)
    jp, js = jax_load_params(path)
    for tree, back in ((params, jp), (stats, js)):
        for (pa, w), (_, g) in zip(_leaves(tree), _leaves(back)):
            np.testing.assert_array_equal(g, w, err_msg=pa)
    again = from_jax_variables(*load_params(path), tcfg)
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_dense_middle_checkpoint_round_trip():
    """A second_d435i flax tree (conv3d [kd, kh, kw, Ci, Co] kernels)
    through the port's layout and back, bit for bit."""
    jcfg = reduced(JaxConfig, "second_d435i")
    tcfg = reduced(TorchConfig, "second_d435i")
    _, variables = _random_state(TorchDetector(tcfg, device="cpu"), 3)
    state = from_jax_variables(variables["params"], variables["batch_stats"],
                               tcfg)
    assert state["middle.conv3d_0.weight"].shape == (16, 16, 3, 3, 3)
    jdet = JaxDetector(jcfg)
    shapes = jax.eval_shape(lambda: jdet.init(jax.random.PRNGKey(0)))
    back_p, back_s = to_jax_variables(state)
    for tree, back, want_shapes in ((variables["params"], back_p,
                                     shapes["params"]),
                                    (variables["batch_stats"], back_s,
                                     shapes["batch_stats"])):
        want, got = list(_leaves(tree)), list(_leaves(back))
        assert [p for p, _ in want] == [p for p, _ in got] == [
            p for p, _ in _leaves(jax.tree_util.tree_map(
                lambda a: np.zeros(a.shape), want_shapes))]
        for (path, w), (_, g) in zip(want, got):
            np.testing.assert_array_equal(g, w, err_msg=path)
