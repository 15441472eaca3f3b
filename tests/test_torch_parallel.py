"""The port's parallel/ (data and BEV-grid spatial parallelism over process
groups) on gloo CPU ranks, against the port in one process and against the
JAX package's unsharded forward and step (which tests/test_spatial_*.py pin
to its sharded ones). The ranks run tests/torch_parallel_ranks.py through
``pillars_torch.parallel.launch.spawn``: three spawns (4, 8 and 2 ranks)
serve every test here.

Counterparts, with their tolerances:
- ``test_spatial_parallel.py::test_sharded_forward_matches_replicated``:
  ``Config.default()`` (full width, 8192-point pad, the trained
  ``weights_59.pkl``: random full-width weights regress boxes of 1e30) in 4 and
  8 bands of its 64 rows, ``apply(train=False)``: heads within 1e-5 of
  each head's max |value| of the port's unsharded forward (the same convs
  on bands pick other oneDNN algorithms), within JAX's own 1e-3 / 1e-4 of
  the JAX package's, the same on every rank;
- ``::test_sharded_postprocess_end_to_end``: valid and labels equal, boxes
  and scores within ``compare_predictions``' tolerances, against both;
- ``::test_sharded_train_step_matches_replicated``: 4 bands, B=1 (the
  narrow RPN of torch_parity, 64 x 80 grid): loss parts within 1e-5
  relative, ``num_positives`` equal and > 0, each gradient leaf's relative
  L2 within 1e-3 of the port's unsharded step and within JAX's 1e-2 of the
  JAX package's;
- ``test_spatial_train.py::test_2d_mesh_step_matches_unsharded`` and
  ``::test_second_step_runs_sharded`` on a 2 x 2 data x spatial mesh, B=4,
  at full width from ``weights_59.pkl`` (from a random init, train-mode
  f32 BN statistics differ between the port and the JAX package unsharded
  already: a PFN BN scale's gradient -0.0200 against +0.0174):
  JAX's criteria (loss and loc loss 1e-4 relative, ``num_positives``
  equal, at most 1% of each parameter leaf beyond 2e-5 + 2e-3 |w| after a
  step; two steps, finite, the loss moving); also each gradient leaf's
  relative L2 within 1e-3 of the port's unsharded step, which an RPN BN
  reduced over the data ranks only fails; the front end's BNs reduce over
  the 2 data ranks and the RPN's over all 4. (A front-end BN reduced over
  every rank gives the same numbers: each replica's pillars enter the sums
  and the row count alike, and each band's gradient returns once. It only
  costs a wider collective, so the groups themselves are checked.)
- a 2-rank data-parallel step against the port's single-process step on
  the same global batch (torch_parity.train_config, B=2): float32 loss
  parts within 1e-6 relative, gradients within 1e-5 of each leaf's max,
  new BN statistics within 1e-6 of each one's max; bfloat16 by the training
  criteria of tests/torch_parity.py (against the single-process bf16-f32
  gap); under configs/transfer_learning.yaml's ``freeze_patterns`` the
  step's flat all-reduce carries the 15 trainable gradient leaves alone,
  each within 1e-5 of its max of the single-process gradients;
- ``runtime.spatial_axis`` without a mesh that defines it raises; more
  NCCL ranks than cards raise;
- the captured paths over a data mesh and 2 bands (the 2-rank spawn's
  ``capture`` cases, under the stand-in graph of
  tests/test_torch_train_capture.py): two captured steps bit-equal to two
  eager steps, donated as without a mesh; the train bodies and the band's
  inference body free of host syncs and host data with their collectives
  inside (test_torch_capture.py's dispatch check); the band's captured
  inference equal to eager; the captured data-parallel step's metrics
  within 1e-6 relative of the port's single-process step, whose metrics
  are within 1e-5 relative (+1e-6) of the JAX package's step.
"""

import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.parallel import launch
from pillars_torch.parallel.spatial import band_rows
from pillars_torch.train.loop import (TrainState, forward_backward,
                                      make_train_step, split_state)
from pillars_torch.train.optim import AdamW
from pillars_torch.weights import (convert_tree, from_jax_variables,
                                   load_params, to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.train.loop import create_train_state as jax_create
from pillars_tpu.train.loop import make_train_step as jax_make_step
from torch_parallel_ranks import spawn_cases
from torch_parity import (TRAIN_OVERRIDES, compare_predictions,
                          grad_criterion, loss_criterion, train_batches)

torch.set_num_threads(2)
WEIGHTS = str(pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
              / "hard_synth" / "weights_59.pkl")

NARROW = (("model.pfn.num_filters", 16), ("model.rpn.layer_nums", [1, 2, 2]),
          ("model.rpn.num_filters", [16, 32, 64]),
          ("model.rpn.num_upsample_filters", [32, 32, 32]))
FWD = (("model.voxel.max_points", 8192),)       # test_spatial_parallel's
TRAIN = FWD + NARROW
SMALL_2D = (("model.voxel.max_voxels", 1024),   # test_spatial_train's
            ("model.voxel.max_points", 4096),
            ("model.target.max_gt_boxes", 8))
SPATIAL = (("runtime.spatial_axis", "spatial"),)
REMAT = (("model.rpn.remat", True),)
REMAT_BF16 = (("model.rpn.remat_bf16", True),)
FREEZE = (("train.optimizer.freeze_patterns",
           ["pfn", "block1", "block2", "block3"]),)
POINT_MAJOR = (("model.pfn.dense_cell", False),)  # inference runs the band
HEAD_TOL = 1e-5
JAX_RTOL, JAX_ATOL = 1e-3, 1e-4
GRAD_L2_PORT, GRAD_L2_JAX = 1e-3, 1e-2
DP_LOSS_RTOL, DP_GRAD_TOL, DP_STAT_TOL = 1e-6, 1e-5, 1e-6


def _cfg(config_cls, overrides):
    cfg = config_cls.default()
    for key, value in overrides:
        cfg = cfg.override(key, value)
    return cfg


def _cloud(maxpts, n=4000):
    """test_spatial_parallel's cloud from its rng fixture."""
    rng = np.random.RandomState(42)
    pts = np.zeros((1, maxpts, 3), np.float32)
    pts[0, :n, 0] = rng.uniform(0, 6.4, n)
    pts[0, :n, 1] = rng.uniform(-2.5, 2.5, n)
    pts[0, :n, 2] = rng.uniform(-2.9, 2.9, n)
    return pts, np.asarray([n], np.int32)


def _train_batch_b1(maxpts):
    """test_sharded_train_step_matches_replicated's batch."""
    pts, num = _cloud(maxpts)
    g = np.zeros((1, 4, 7), np.float32)
    g[0, :, :3] = [[3.0, 0.5, -1.0], [1.5, -1.0, -1.2],
                   [5.0, 1.5, -0.8], [2.5, 0.0, -1.1]]
    g[0, :, 3:6] = [0.6, 0.8, 1.7]
    g[0, :, 6] = [0.3, -1.1, 2.0, 0.0]
    return dict(points=pts, num_points=num, gt_boxes=g,
                gt_classes=np.ones((1, 4), np.int32),
                gt_valid=np.ones((1, 4), bool))


def _batch_2d(cfg, batch_size):
    """test_spatial_train's batch from its rng fixture."""
    rng = np.random.RandomState(42)
    n = 500
    maxpts = cfg.model.voxel.max_points
    g = cfg.model.target.max_gt_boxes
    points = np.zeros((batch_size, maxpts, 3), np.float32)
    points[:, :n, 0] = rng.uniform(0, 6.4, (batch_size, n))
    points[:, :n, 1] = rng.uniform(-2.5, 2.5, (batch_size, n))
    points[:, :n, 2] = rng.uniform(-2.9, 0.5, (batch_size, n))
    gt = np.zeros((batch_size, g, 7), np.float32)
    gt[..., 3:6] = 1.0
    gt[:, 0] = [3.0, 0.0, -1.5, 0.6, 0.8, 1.73, 0.3]
    return dict(points=points,
                num_points=np.full((batch_size,), n, np.int32),
                gt_boxes=gt, gt_classes=np.ones((batch_size, g), np.int32),
                gt_valid=np.pad(np.ones((batch_size, 1), bool),
                                ((0, 0), (0, g - 1))))


def _state(overrides, seed=0):
    det = TorchDetector(_cfg(TorchConfig, overrides), device="cpu")
    return det.init(torch.Generator().manual_seed(seed))


def _arrays(state):
    return {k: v.numpy() for k, v in state.items()}


@pytest.fixture(scope="module")
def inputs():
    train_cfg = _cfg(TorchConfig, SMALL_2D)
    return dict(
        fwd_state=from_jax_variables(*load_params(WEIGHTS),
                                     _cfg(TorchConfig, FWD)),
        train_state=_state(TRAIN),
        state_2d=from_jax_variables(*load_params(WEIGHTS), train_cfg),
        cloud=_cloud(8192),
        batch_b1=_train_batch_b1(8192), batch_2d=_batch_2d(train_cfg, 4),
        dp_state=_state(TRAIN_OVERRIDES, seed=3),
        dp_batch=train_batches(7, 1)[0])


def _forward_case(inputs, n):
    pts, num = inputs["cloud"]
    return dict(overrides=FWD + SPATIAL, mesh=(("spatial", n),),
                state=_arrays(inputs["fwd_state"]),
                batch=dict(points=pts, num_points=num), ops=["postprocess"])


@pytest.fixture(scope="module")
def runs4(inputs, tmp_path_factory):
    cases = [
        _forward_case(inputs, 4),
        dict(overrides=TRAIN + SPATIAL, mesh=(("spatial", 4),),
             state=_arrays(inputs["train_state"]), batch=inputs["batch_b1"],
             ops=["grads", "steps"], n_steps=1),
        dict(overrides=SMALL_2D + SPATIAL,
             mesh=(("data", 2), ("spatial", 2)),
             state=_arrays(inputs["state_2d"]), batch=inputs["batch_2d"],
             ops=["grads", "steps"], n_steps=2),
    ]
    out = spawn_cases(str(tmp_path_factory.mktemp("ranks4")), 4, cases)
    return dict(zip(("forward", "train", "mesh2d"), out))


@pytest.fixture(scope="module")
def runs8(inputs, tmp_path_factory):
    return spawn_cases(str(tmp_path_factory.mktemp("ranks8")), 8,
                       [_forward_case(inputs, 8)])[0]


@pytest.fixture(scope="module")
def runs2(inputs, tmp_path_factory):
    cases = [dict(overrides=TRAIN_OVERRIDES + extra, mesh=(("data", 2),),
                  state=_arrays(inputs["dp_state"]), batch=inputs["dp_batch"],
                  ops=ops, n_steps=1)
             for extra, ops in (((), ["grads", "steps", "metrics"]),
                                ((("runtime.compute_dtype", "bfloat16"),),
                                 ["grads"]),
                                (REMAT + SPATIAL, ["grads"]),
                                (REMAT + REMAT_BF16 + SPATIAL, ["grads"]))]
    # the captured paths (tests/test_torch_parallel_capture.py's subject)
    cases += [dict(overrides=TRAIN_OVERRIDES + extra, mesh=mesh,
                   state=_arrays(inputs["dp_state"]),
                   batch=inputs["dp_batch"], ops=["capture"])
              for extra, mesh in (((), (("data", 2),)),
                                  (SPATIAL + POINT_MAJOR,
                                   (("spatial", 2),)))]
    # configs/transfer_learning.yaml's freeze over the data ranks
    cases.append(dict(overrides=TRAIN_OVERRIDES + FREEZE,
                      mesh=(("data", 2),), state=_arrays(inputs["dp_state"]),
                      batch=inputs["dp_batch"], ops=["flat_reduce"]))
    for case in cases[2:4]:
        case["mesh"] = (("spatial", 2),)
    out = spawn_cases(str(tmp_path_factory.mktemp("ranks2")), 2, cases)
    return dict(zip(("float32", "bfloat16", "remat", "remat_bf16",
                     "capture_data", "capture_spatial", "frozen"), out))


# ----------------------------------------------------------------------
# the references: the port in one process, the JAX package unsharded

def _port_forward(inputs):
    det = TorchDetector(_cfg(TorchConfig, FWD), device="cpu")
    pts, num = (torch.as_tensor(a) for a in inputs["cloud"])
    with torch.inference_mode():
        vox = det.voxelize_batch(pts, num)
        heads = det.apply(inputs["fwd_state"], vox)
        thr = det.config.eval_input.anchor_area_threshold
        amask = det.anchors_mask_batch(vox.coords, vox.pillar_mask, thr)
        eye = torch.eye(4)[None]
        preds = det.postprocess(heads, amask, eye, eye)
    return heads, preds


@pytest.fixture(scope="module")
def unsharded(inputs):
    heads, preds = _port_forward(inputs)
    jdet = JaxDetector(_cfg(JaxConfig, FWD))
    p, s = to_jax_variables(inputs["fwd_state"])
    jvars = {"params": p, "batch_stats": s}
    thr = jdet.config.eval_input.anchor_area_threshold
    eye = jnp.eye(4, dtype=jnp.float32)[None]

    def infer(pts, num):
        v = jdet.voxelize_batch(pts, num)
        amask = jdet.anchors_mask_batch(v.coords, v.pillar_mask, thr)
        out = jdet.apply(jvars, v, train=False)
        return out, jdet.postprocess(out, amask, eye, eye)

    jheads, jpreds = jax.device_get(jax.jit(infer)(*inputs["cloud"]))
    return dict(heads=heads, preds=preds, jax_heads=jheads,
                jax_preds=jpreds)


def _port_grads(overrides, state, batch):
    cfg = _cfg(TorchConfig, overrides)
    det = TorchDetector(cfg, device="cpu")
    params, stats = split_state(state)
    opt = AdamW(cfg.train.optimizer, cfg.train_input.batch_size)
    ts = TrainState(0, params, stats, opt.init(params))
    fb = forward_backward(det, ts, batch,
                          cfg.train_input.anchor_area_threshold)
    steps, s = [], ts
    step = make_train_step(det, opt)
    for _ in range(2):
        s, m = step(s, batch)
        steps.append({"metrics": m, "params": s.params})
    return fb, steps


def _jax_step(overrides, state, batch):
    """The JAX package's unsharded gradients and one train step from the
    port's ``state``: (grads by port name, StepMetrics, params by port
    name after the step)."""
    cfg = _cfg(JaxConfig, overrides)
    det = JaxDetector(cfg)
    b = batch["points"].shape[0]
    jstate, tx = jax_create(det, jax.random.PRNGKey(0), b)
    p, s = to_jax_variables(state)
    p = jax.tree_util.tree_map(jnp.asarray, p)
    jstate = jstate._replace(params=p, batch_stats=s, opt_state=tx.init(p))
    thr = cfg.train_input.anchor_area_threshold

    def loss_fn(params):
        vox = det.voxelize_batch(batch["points"], batch["num_points"])
        amask = det.anchors_mask_batch(vox.coords, vox.pillar_mask, thr)
        tgt = det.assign_targets(batch["gt_boxes"], batch["gt_classes"],
                                 batch["gt_valid"], amask)
        preds, _ = det.network.apply(
            {"params": params, "batch_stats": s}, vox, True,
            mutable=["batch_stats"])
        return det.loss(preds, tgt.labels, tgt.bbox_targets).loss

    grads = jax.device_get(jax.jit(jax.grad(loss_fn))(p))
    new_state, metrics = jax_make_step(det, tx, donate=False)(jstate, batch)
    return (convert_tree(grads, None), jax.device_get(metrics),
            convert_tree(jax.device_get(new_state.params), None))


def _rel_l2(got, want):
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)


def _same_on_every_rank(outs, key):
    first = outs[0][key]
    for o in outs[1:]:
        for k in first:
            assert torch.equal(o[key][k], first[k]), k


# ----------------------------------------------------------------------

def test_band_rows():
    assert band_rows(64, 4, 4) == [(0, 16), (16, 32), (32, 48), (48, 64)]
    assert band_rows(64, 8, 4)[-1] == (56, 64)
    # the last band takes the remainder, every band a multiple of 4 rows
    assert band_rows(64, 3, 4) == [(0, 20), (20, 40), (40, 64)]
    with pytest.raises(ValueError):
        band_rows(64, 17, 4)
    with pytest.raises(ValueError):
        band_rows(62, 2, 4)


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_forward_matches_replicated(n, runs4, runs8, unsharded):
    outs = runs4["forward"] if n == 4 else runs8
    assert len(outs) == n
    _same_on_every_rank(outs, "heads")
    got = outs[0]["heads"]
    for k, want in unsharded["heads"].items():
        assert got[k].shape == want.shape
        scale = float(want.abs().max())
        print(f"{n} bands, {k}: max |diff| {float((got[k] - want).abs().max()) / scale:.3e} "
              f"of its max against the port unsharded")
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), rtol=0,
                                   atol=HEAD_TOL * scale, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(),
                                   np.asarray(unsharded["jax_heads"][k]),
                                   rtol=JAX_RTOL, atol=JAX_ATOL, err_msg=k)


@pytest.mark.parametrize("n", [4, 8])
def test_bands_of_the_canvas_and_the_anchors(n, runs4, runs8, unsharded):
    """Each rank's band of rows (whole multiples of the RPN's total stride
    4) of a head tensor (``shard_canvas``), and of the (y, x, T)-major flat
    anchors (``shard_anchors_flat``): the same rows, tiling the whole in
    rank order."""
    outs = runs4["forward"] if n == 4 else runs8
    ny, nx = unsharded["heads"]["cls_preds"].shape[1:3]
    per_row = nx * TorchConfig.default().model.num_anchors_per_loc
    whole = outs[0]["heads"]["cls_preds"]
    for o, (start, stop) in zip(outs, band_rows(ny, n, 4)):
        assert torch.equal(o["bands"]["cls"], whole[:, start:stop])
        assert torch.equal(o["bands"]["anchor_ids"][0],
                           torch.arange(start * per_row, stop * per_row))


@pytest.mark.parametrize("n", [4, 8])
def test_sharded_postprocess_end_to_end(n, runs4, runs8, unsharded):
    outs = runs4["forward"] if n == 4 else runs8
    got = outs[0]["preds"]
    compare_predictions(unsharded["jax_preds"], got)
    compare_predictions(type(got)(*(t.numpy() for t in unsharded["preds"])),
                        got)
    for o in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(o["preds"], got))


def test_sharded_train_step_matches_replicated(inputs, runs4):
    got = runs4["train"][0]
    fb, _ = _port_grads(TRAIN, inputs["train_state"], inputs["batch_b1"])
    jgrads, jm, _ = _jax_step(TRAIN, inputs["train_state"],
                              inputs["batch_b1"])
    for name, g, w, j in zip(fb.loss._fields, got["loss"], fb.loss, jm):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(float(g), float(j), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    assert (int(got["num_positives"]) == int(fb.num_positives)
            == int(jm.num_positives) > 0)
    worst = {"port": 0.0, "jax": 0.0}
    for k, w in fb.grads.items():
        worst["port"] = max(worst["port"], _rel_l2(got["grads"][k], w))
        worst["jax"] = max(worst["jax"], _rel_l2(got["grads"][k], jgrads[k]))
    print(f"4 bands, per-leaf relative L2 of the gradients: at most "
          f"{worst['port']:.3e} from the port unsharded, {worst['jax']:.3e} "
          f"from the JAX package")
    assert worst["port"] < GRAD_L2_PORT and worst["jax"] < GRAD_L2_JAX
    assert int(got["steps"][0]["metrics"].num_positives) > 0
    # the replicated front end reduces over no rank, each band over all 4
    assert all(n == (4 if k.startswith("rpn.") else 1)
               for k, n in got["bn_group_sizes"].items())
    for o in runs4["train"][1:]:  # one AdamW step: identical parameters
        assert all(torch.equal(o["steps"][0]["params"][k], v)
                   for k, v in got["steps"][0]["params"].items())


def test_2d_mesh_step_matches_unsharded(inputs, runs4):
    outs = runs4["mesh2d"]
    got = outs[0]
    fb, _ = _port_grads(SMALL_2D, inputs["state_2d"], inputs["batch_2d"])
    _, jm, jparams = _jax_step(SMALL_2D, inputs["state_2d"],
                               inputs["batch_2d"])
    m = got["steps"][0]["metrics"]
    np.testing.assert_allclose(float(m.loss), float(jm.loss), rtol=1e-4)
    np.testing.assert_allclose(float(m.loc_loss_reduced),
                               float(jm.loc_loss_reduced), rtol=1e-4)
    assert int(m.num_positives) == int(jm.num_positives)
    params = got["steps"][0]["params"]
    assert params.keys() == jparams.keys()
    for k, w in jparams.items():
        g, w = params[k].numpy(), w.numpy()
        bad = np.abs(g - w) > 2e-5 + 2e-3 * np.abs(w)
        assert bad.mean() <= 0.01, (k, int(bad.sum()), bad.size)
    worst = max(_rel_l2(got["grads"][k], w) for k, w in fb.grads.items())
    print(f"2 x 2 mesh, per-leaf relative L2 of the gradients: at most "
          f"{worst:.3e} from the port unsharded")
    assert worst < GRAD_L2_PORT
    sizes = got["bn_group_sizes"]
    assert sizes and all(n == (4 if k.startswith("rpn.") else 2)
                         for k, n in sizes.items()), sizes
    for o in outs[1:]:
        for i in range(2):
            assert all(torch.equal(o["steps"][i]["params"][k], v)
                       for k, v in got["steps"][i]["params"].items())


def test_second_step_runs_sharded(runs4):
    m1, m2 = (s["metrics"] for s in runs4["mesh2d"][0]["steps"])
    assert np.isfinite(float(m1.loss)) and np.isfinite(float(m2.loss))
    assert float(m2.loss) != float(m1.loss)  # params actually moved


def test_data_parallel_f32_step_matches_single_process(inputs, runs2):
    got = runs2["float32"]
    fb, steps = _port_grads(TRAIN_OVERRIDES, inputs["dp_state"],
                            inputs["dp_batch"])
    assert int(got[0]["num_positives"]) == int(fb.num_positives) > 0
    for name, g, w in zip(fb.loss._fields, got[0]["loss"], fb.loss):
        np.testing.assert_allclose(float(g), float(w), rtol=DP_LOSS_RTOL,
                                   atol=1e-9, err_msg=name)
    for k, w in fb.grads.items():
        np.testing.assert_allclose(got[0]["grads"][k].numpy(), w.numpy(),
                                   rtol=0,
                                   atol=DP_GRAD_TOL * float(w.abs().max()),
                                   err_msg=k)
    for k, w in fb.batch_stats.items():
        if w.is_floating_point():
            np.testing.assert_allclose(
                got[0]["batch_stats"][k].numpy(), w.numpy(), rtol=0,
                atol=DP_STAT_TOL * float(w.abs().max()), err_msg=k)
        else:
            assert torch.equal(got[0]["batch_stats"][k], w), k
    # every rank: the same global metrics and, after the step, parameters
    _same_on_every_rank(got, "grads")
    assert set(got[0]["bn_group_sizes"].values()) == {2}
    m, want = got[1]["steps"][0]["metrics"], steps[0]["metrics"]
    for name, g, w in zip(m._fields, m, want):
        np.testing.assert_allclose(float(g), float(w), rtol=DP_LOSS_RTOL,
                                   atol=1e-9, err_msg=name)


def test_data_parallel_step_under_the_freeze(inputs, runs2):
    """configs/transfer_learning.yaml's ``freeze_patterns`` over 2 data
    ranks: the step's flat all-reduce of the gradients carries the 15
    trainable leaves alone, in the same order on both ranks, and each
    within 1e-5 of its max of the single-process gradients; after the step
    both ranks hold the same parameters, the frozen ones the state's bit
    for bit and the trainable ones the single-process step's by the 2 x 2
    mesh test's criterion (Adam's first step divides each gradient by its
    own magnitude, which turns the gradients' f32 noise into a few ulps of
    a parameter where a gradient is near 0)."""
    over = TRAIN_OVERRIDES + FREEZE
    fb, steps = _port_grads(over, inputs["dp_state"], inputs["dp_batch"])
    start = split_state(inputs["dp_state"])[0]
    outs = [r["flat_reduce"] for r in runs2["frozen"]]
    trainable = outs[0]["trainable"]
    assert len(trainable) == 15 and len(start) > 15
    for o in outs:
        assert o["trainable"] == trainable
        grads, losses = o["calls"]  # the gradients, then the loss parts
        assert len(grads) == len(trainable)
        assert len(losses) == len(fb.loss) + 1  # and num_positives
        for k, g in zip(trainable, grads):
            w = fb.grads[k]
            np.testing.assert_allclose(
                g.numpy(), w.numpy(), rtol=0,
                atol=DP_GRAD_TOL * float(w.abs().max()), err_msg=k)
    _same_on_every_rank(outs, "params")
    want = steps[0]["params"]
    for k, p in outs[0]["params"].items():
        if k not in trainable:
            assert torch.equal(p, start[k]) and torch.equal(want[k], p), k
            continue
        assert not torch.equal(want[k], start[k]), k
        g, w = p.numpy(), want[k].numpy()
        bad = np.abs(g - w) > 2e-5 + 2e-3 * np.abs(w)
        assert bad.mean() <= 0.01, (k, int(bad.sum()), bad.size)
    m, w = outs[0]["metrics"], steps[0]["metrics"]
    for name, g, v in zip(m._fields, m, w):
        np.testing.assert_allclose(float(g), float(v), rtol=DP_LOSS_RTOL,
                                   atol=1e-9, err_msg=name)


def test_data_parallel_train_metrics_are_the_global_batch(inputs, runs2):
    """``with_metrics``: the streaming accuracy and precision/recall of the
    global batch (each rank gathers the others' predictions and labels)."""
    from pillars_torch.train.metrics import TrainMetricsState

    cfg = _cfg(TorchConfig, TRAIN_OVERRIDES)
    det = TorchDetector(cfg, device="cpu")
    params, stats = split_state(inputs["dp_state"])
    opt = AdamW(cfg.train.optimizer, 2)
    step = make_train_step(det, opt, with_metrics=True)
    _, _, _, want = step(TrainState(0, params, stats, opt.init(params)),
                         TrainMetricsState.init(), inputs["dp_batch"])
    for r in runs2["float32"]:
        got = r["metric_values"]
        assert got.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(float(got[k]), float(w),
                                       rtol=DP_LOSS_RTOL, atol=1e-9,
                                       err_msg=k)


def test_spatial_step_with_remat(inputs, runs2):
    """``rpn.remat`` recomputes each block in the backward, halo exchanges
    and BN all-reduces included: 2 bands against the same config
    unsharded, loss parts within 1e-5 relative and each gradient leaf's
    relative L2 within 1e-3. With ``rpn.remat_bf16`` the boundaries round
    to bf16, and a value the bands compute 1e-6 apart can round one step
    apart (measured: gradient leaves 6.4e-3 relative L2 from the unsharded
    run), so that run is held by the training criteria of
    tests/torch_parity.py against the gap between the unsharded run with
    and without bf16 boundaries."""
    over = TRAIN_OVERRIDES + REMAT
    fb, _ = _port_grads(over, inputs["dp_state"], inputs["dp_batch"])
    fb16, _ = _port_grads(over + REMAT_BF16, inputs["dp_state"],
                          inputs["dp_batch"])
    for r, r16 in zip(runs2["remat"], runs2["remat_bf16"]):
        for name, g, w in zip(fb.loss._fields, r["loss"], fb.loss):
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                       atol=1e-7, err_msg=name)
        worst = max(_rel_l2(r["grads"][k], w) for k, w in fb.grads.items())
        assert worst < GRAD_L2_PORT, worst
        for name, g, w, f in zip(fb.loss._fields, r16["loss"], fb16.loss,
                                 fb.loss):
            loss_criterion(g, w, f, name)
        for k, w in fb16.grads.items():
            grad_criterion(r16["grads"][k].numpy(), w.numpy(),
                           fb.grads[k].numpy(), k)


def test_data_parallel_bf16_step_matches_single_process(inputs, runs2):
    got = runs2["bfloat16"][0]
    bf16 = TRAIN_OVERRIDES + (("runtime.compute_dtype", "bfloat16"),)
    fb16, _ = _port_grads(bf16, inputs["dp_state"], inputs["dp_batch"])
    fb32, _ = _port_grads(TRAIN_OVERRIDES, inputs["dp_state"],
                          inputs["dp_batch"])
    assert int(got["num_positives"]) == int(fb16.num_positives) > 0
    for name, g, w, f in zip(fb16.loss._fields, got["loss"], fb16.loss,
                             fb32.loss):
        loss_criterion(g, w, f, name)
    for k, w in fb16.grads.items():
        grad_criterion(got["grads"][k].numpy(), w.numpy(),
                       fb32.grads[k].numpy(), k)
    _same_on_every_rank(runs2["bfloat16"], "grads")


def test_spatial_axis_without_a_mesh_raises(inputs):
    det = TorchDetector(_cfg(TorchConfig, FWD + SPATIAL), device="cpu")
    pts, num = (torch.as_tensor(a) for a in inputs["cloud"])
    vox = det.voxelize_batch(pts, num)
    with pytest.raises(ValueError, match="spatial_axis"):
        det.apply(inputs["fwd_state"], vox)
    with pytest.raises(ValueError, match="spatial_axis"):
        det.apply(inputs["fwd_state"], vox, train=True)


def test_more_ranks_than_cards_raise(monkeypatch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.spawn(print, 2, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 NCCL ranks need 2 cards"):
        launch.spawn(print, 2, device="cuda")
    launch.check_devices(2, "cuda", "gloo")  # gloo ranks may share a card


# ----------------------------------------------------------------------
# the captured paths over a mesh, with the stand-in graph of
# tests/test_torch_train_capture.py (the spawn's "capture" cases; the rule
# that picks them and the card are in tests/test_torch_parallel_capture.py)

def _equal_trees(got, want, label):
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want), label
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), label
        for k in want:
            _equal_trees(got[k], want[k], f"{label}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), label
        for i, (g, w) in enumerate(zip(got, want)):
            _equal_trees(g, w, f"{label}/{i}")
    else:
        assert got == want, label


@pytest.mark.parametrize("mesh", ["data", "spatial"])
def test_captured_steps_over_a_mesh_match_eager(mesh, runs2):
    """Two captured steps (the first call, then a replay) against two eager
    steps from the same state, bit for bit on every rank (the same ops in
    the same order, collectives included), donated as without a mesh: the
    state returned holds the static tensors, the last one returned is not
    copied in again, the state handed in stays as it was."""
    for rank, r in enumerate(runs2[f"capture_{mesh}"]):
        c = r["capture"]
        assert c["eager_is_eager"]  # the CPU takes the eager step
        _equal_trees(c["captured"], c["eager"], f"rank {rank} metrics")
        _equal_trees(c["captured_state"], c["eager_state"],
                     f"rank {rank} state")
        assert int(c["captured"][1].num_positives) > 0
        assert c["donated"] and c["untouched"]
        assert c["copies"] == [1, 1] and c["replays"] == 1
    first, second = (r["capture"] for r in runs2[f"capture_{mesh}"])
    _equal_trees(second["captured_state"].params,
                 first["captured_state"].params, "ranks")


@pytest.mark.parametrize("mesh,body", [("data", "train_sync"),
                                       ("spatial", "train_sync"),
                                       ("spatial", "infer_sync")])
def test_mesh_bodies_are_sync_free(mesh, body, runs2):
    """The data-parallel and 2-band train bodies (flat gradient and loss
    all-reduces, the BNs' statistics, halo exchanges, the heads' gather)
    and the 2-band inference body replay with no host sync and no tensor
    made from host data (test_torch_capture.py's dispatch check)."""
    for r in runs2[f"capture_{mesh}"]:
        assert r["capture"][body] == [], r["capture"][body]


def test_captured_spatial_inference_matches_eager(runs2):
    """2 bands, point-major: the captured inference (first call and a
    replay) equals the eager function on each rank, and the ranks agree."""
    outs = [r["capture"]["infer"] for r in runs2["capture_spatial"]]
    for first, replay, eager in outs:
        _equal_trees(first, eager, "first call")
        _equal_trees(replay, eager, "replay")
    _equal_trees(outs[1][2], outs[0][2], "ranks")
    assert bool(outs[0][2].valid.any())


def test_captured_data_parallel_step_matches_single_process(inputs, runs2):
    """The captured data-parallel step's metrics within
    test_data_parallel_f32_step_matches_single_process's tolerance of the
    port's single-process step, and that step's within
    test_sharded_train_step_matches_replicated's of the JAX package's."""
    _, steps = _port_grads(TRAIN_OVERRIDES, inputs["dp_state"],
                           inputs["dp_batch"])
    _, jm, _ = _jax_step(TRAIN_OVERRIDES, inputs["dp_state"],
                         inputs["dp_batch"])
    want = steps[0]["metrics"]
    for r in runs2["capture_data"]:
        m = r["capture"]["captured"][0]
        for name, g, w in zip(m._fields, m, want):
            np.testing.assert_allclose(float(g), float(w), rtol=DP_LOSS_RTOL,
                                       atol=1e-9, err_msg=name)
    for name in jm._fields:
        np.testing.assert_allclose(float(getattr(want, name)),
                                   float(getattr(jm, name)), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
