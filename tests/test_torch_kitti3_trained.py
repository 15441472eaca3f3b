"""``configs/kitti_3class.yaml`` with its trained checkpoint
``benchmarks/kitti3_synth/weights_73.pkl`` in the port against the JAX
package on the CPU, at full width with nothing cut from the config (the
432 x 496 grid, 1.29M anchors from three interleaved generators, 16000
pillars of 32 points, the 131072-point pad, NMS 1000 -> 300, AdaBN
recalibration), on a tiny split of the config's synthetic profile
(``generate_dataset(profile="kitti3")``, 4 train / 2 val clouds, seed 11).
The JAX side is jitted with XLA's excess precision off
(``torch_parity.XLA_STRICT``), as the port's other parity tests compile it.

- The generator: both packages write the same files.
- The checkpoint: the port reads the JAX TrainState (step and AdamW count
  11100, the moments of every parameter).
- Evaluation: the 2 val clouds through each package's ``Evaluator`` with
  ``eval_input.bn_recal_batches`` 1 read from the train split: the
  recalibrated BN statistics within 1e-5 of each leaf's max |value|, the
  annos by ``tests/test_torch_eval.py``'s criterion (names equal; scores,
  locations, dimensions and rotations within 1e-4).
- ``slow``: one f32 train step at B=1 resumed from the checkpoint's
  TrainState on the first train cloud (``PedestrianDataset(training=True)``
  with the GT-database sampler, seed 0): labels and positives equal, loss
  parts within 1e-4 relative, the rate equal to optax's, the new BN
  statistics within 1e-4 of each leaf's max, and by the standing criteria
  for trained one-step checks the new parameters (at most 0.1% of each leaf
  beyond 2e-5 + 2e-3 |w|) and the gradients (each leaf's relative L2 within
  1e-2). The JAX step at full width costs about two minutes on the CPU, so
  it stays out of the quick suite.
"""

import filecmp
import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.data import pipeline as torch_pipeline
from pillars_torch.data import sampler as torch_sampler
from pillars_torch.data import synthetic
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.train import checkpoint as tckpt
from pillars_torch.train.loop import forward_backward, make_train_step
from pillars_torch.train.optim import AdamW
from pillars_torch.train.trainer import Evaluator
from pillars_torch.weights import convert_tree, from_jax_variables
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.data import pipeline as jax_pipeline
from pillars_tpu.data import sampler as jax_sampler
from pillars_tpu.data import synthetic as jax_synthetic
from pillars_tpu.models.detector import PillarsDetector as JaxDetector
from pillars_tpu.train import checkpoint as jckpt
from pillars_tpu.train.loop import make_train_step as jax_make_step
from pillars_tpu.train.optim import make_optimizer
from pillars_tpu.train.trainer import Evaluator as JaxEvaluator
from torch_parity import XLA_STRICT

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
YAML = str(ROOT / "configs" / "kitti_3class.yaml")
WEIGHTS = str(ROOT / "benchmarks" / "kitti3_synth" / "weights_73.pkl")
STAT_TOL = 1e-5    # recalibrated statistics, of each leaf's max |value|
ANNO_ATOL = 1e-4   # tests/test_torch_eval.py
LOSS_RTOL = 1e-4
STEP_STAT_TOL = 1e-4
# trained one-step checks (ROADMAP, standing criteria): new parameters
# elementwise within 2e-5 + 2e-3 |w|, at most this share of a leaf beyond;
# gradients by each leaf's relative L2 (tests/test_torch_parallel.py's
# criterion against the JAX package): a train-mode BN's bias gradient sums
# a whole map and cancels, so single elements move with the summation order
PARAM_ATOL, PARAM_RTOL, PARAM_SHARE = 2e-5, 2e-3, 1e-3
GRAD_L2 = 1e-2


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The tiny kitti3 split by the port's generator; the JAX package's
    beside it."""
    base = tmp_path_factory.mktemp("kitti3")
    ours = synthetic.generate_dataset(str(base / "torch"), num_train=4,
                                      num_test=2, seed=11, profile="kitti3")
    theirs = jax_synthetic.generate_dataset(str(base / "jax"), num_train=4,
                                            num_test=2, seed=11,
                                            profile="kitti3")
    return ours, theirs


@pytest.fixture
def strict_jit(monkeypatch):
    """Every ``jax.jit`` the JAX package makes compiles XLA-strict."""
    plain = jax.jit
    monkeypatch.setattr(jax, "jit", lambda fn=None, **kw: plain(
        fn, compiler_options=XLA_STRICT, **kw))


def _cfg(config_cls, root, **sets):
    cfg = config_cls.from_yaml(YAML)
    for key, value in (("eval_input.dataset_root", root),
                       ("eval_input.info_path", f"{root}/kitti_infos_val.pkl"),
                       ("eval_input.num_workers", 0),
                       ("train_input.dataset_root", root),
                       ("train_input.info_path",
                        f"{root}/kitti_infos_train.pkl"),
                       ("train_input.sampler.info_path",
                        f"{root}/kitti_dbinfos_train.pkl"),
                       ("runtime.num_devices", 1), *sets.items()):
        cfg = cfg.override(key, value)
    return cfg


def test_generator_and_checkpoint(split):
    ours, theirs = split
    n_files = 0
    for path in sorted(pathlib.Path(theirs).rglob("*")):
        if path.is_file():
            assert filecmp.cmp(path, pathlib.Path(ours)
                               / path.relative_to(theirs), shallow=False), path
            n_files += 1
    assert n_files >= 6 * 3 + 3
    assert synthetic.split_checksum(ours) == synthetic.split_checksum(theirs)
    host, extra = tckpt.load_checkpoint(WEIGHTS)
    cfg = TorchConfig.from_yaml(YAML)
    state = tckpt.train_state_from_host(host, cfg, "cpu")
    assert state.step == state.opt_state.count == 11100
    assert set(state.opt_state.mu) == set(state.opt_state.nu) == set(
        state.params)
    assert extra["epoch"] == 73 and round(extra["best_score"], 2) == 93.42
    det = TorchDetector(cfg, device="cpu")
    assert det.anchors.shape == (432 * 496 * 6, 7)
    assert cfg.model.rpn.no_concat_heads
    # a 64-filter PointwisePFN over 9 decorated features; split 3-class
    # heads: 6 anchors per location, 7 box codes and 3 classes each
    assert state.params["pfn.dense.weight"].shape == (64, 9)
    assert state.params["rpn.conv_box.weight"].shape[0] == 6 * 7
    assert state.params["rpn.conv_cls.weight"].shape[0] == 6 * 3


def test_evaluator_with_recalibration_matches_jax(split, strict_jit):
    root = split[0]
    jcfg = _cfg(JaxConfig, root, **{"eval_input.bn_recal_batches": 1})
    tcfg = _cfg(TorchConfig, root, **{"eval_input.bn_recal_batches": 1})
    pp = tcfg.model.postprocess
    assert (pp.nms_pre_max_size, pp.nms_post_max_size) == (1000, 300)
    assert tcfg.model.voxel.max_points == 131072

    params, stats = jckpt.load_params(WEIGHTS)
    jev = JaxEvaluator(jcfg, JaxDetector(jcfg))
    tev = Evaluator(tcfg, TorchDetector(tcfg, device="cpu"))
    recal = {}
    for name, ev in (("jax", jev), ("torch", tev)):
        inner = ev._maybe_recalibrate
        ev._maybe_recalibrate = functools.partial(
            lambda inner, name, v: recal.setdefault(name, inner(v)),
            inner, name)
    want, _ = jev.run({"params": params, "batch_stats": stats},
                      progress=False)
    state = from_jax_variables(params, stats, tcfg)
    got, _ = tev.run(state, progress=False)

    assert len(jev._recal_batches) == len(tev._recal_batches) == 1
    for name, w in convert_tree({}, jax.device_get(
            recal["jax"]["batch_stats"])).items():
        assert not torch.equal(recal["torch"][name], state[name]), name
        np.testing.assert_allclose(recal["torch"][name].numpy(), w, rtol=0,
                                   atol=STAT_TOL * np.abs(w).max(),
                                   err_msg=name)
    assert len(want) == len(got) == 2
    names = set()
    for w, g in zip(want, got):
        assert list(g["name"]) == list(w["name"])
        names |= set(w["name"])
        for key in ("score", "location", "dimensions", "rotation_y"):
            np.testing.assert_allclose(g[key], w[key], atol=ANNO_ATOL,
                                       rtol=0, err_msg=key)
    assert sum(len(a["name"]) for a in want) >= 10
    assert len(names) >= 2


def _first_train_batch(pipeline, sampler_mod, cfg):
    """The first cloud as training reads it, through one package's
    pipeline."""
    sampler = sampler_mod.DataBaseSampler(cfg.train_input.sampler.info_path,
                                          cfg.train_input.sampler,
                                          rng=np.random.RandomState(0))
    ds = pipeline.PedestrianDataset(cfg, cfg.train_input, training=True,
                                    sampler=sampler,
                                    rng=np.random.RandomState(0))
    return pipeline.collate([ds[0]])


def _share_beyond(got, want):
    return float((np.abs(got - want)
                  > PARAM_ATOL + PARAM_RTOL * np.abs(want)).mean())


def _rel_l2(got, want):
    return float(np.linalg.norm((got - want).ravel())
                 / max(np.linalg.norm(want.ravel()), 1e-30))


@pytest.mark.slow
def test_resumed_train_step_matches_jax(split, strict_jit):
    root = split[0]
    one = {"train_input.batch_size": 1}
    jcfg, tcfg = _cfg(JaxConfig, root, **one), _cfg(TorchConfig, root, **one)
    batch = _first_train_batch(jax_pipeline, jax_sampler, jcfg)
    mine = _first_train_batch(torch_pipeline, torch_sampler, tcfg)
    assert batch.keys() == mine.keys()
    for k in batch:
        np.testing.assert_array_equal(np.asarray(mine[k]),
                                      np.asarray(batch[k]), err_msg=k)
    thr = tcfg.train_input.anchor_area_threshold

    # the JAX package: its step, and the gradients and targets of that step
    jstate, _ = jckpt.load_checkpoint(WEIGHTS)
    jdet = JaxDetector(jcfg)
    tx = make_optimizer(jcfg.train.optimizer, 1, jstate.params)
    jnew, jm = jax.device_get(jax_make_step(jdet, tx, donate=False)(
        jstate, batch))

    def grads_fn(state, batch):
        vox = jdet.voxelize_batch(batch["points"], batch["num_points"])
        amask = jdet.anchors_mask_batch(vox.coords, vox.pillar_mask, thr)
        t = jdet.assign_targets(batch["gt_boxes"], batch["gt_classes"],
                                batch["gt_valid"], amask)

        def loss_fn(params):
            preds, _ = jdet.network.apply(
                {"params": params, "batch_stats": state.batch_stats}, vox,
                True, mutable=["batch_stats"])
            return jdet.loss(preds, t.labels, t.bbox_targets).loss

        return jax.grad(loss_fn)(state.params), t.labels, t.bbox_targets

    jgrads, jlabels, jtargets = jax.device_get(jax.jit(grads_fn)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}))

    # the port, resumed from the same file
    tdet = TorchDetector(tcfg, device="cpu")
    tstate = tckpt.train_state_from_host(tckpt.load_checkpoint(WEIGHTS)[0],
                                         tcfg, "cpu")
    fb = forward_backward(tdet, tstate, batch, thr)
    tnew, tm = make_train_step(tdet, AdamW(tcfg.train.optimizer, 1))(
        tstate, batch)

    np.testing.assert_array_equal(fb.targets.labels.numpy(), jlabels)
    np.testing.assert_allclose(fb.targets.bbox_targets.numpy(), jtargets,
                               rtol=0, atol=1e-5)
    n_pos = int(tm.num_positives)
    assert n_pos == int(jm.num_positives) == int((jlabels > 0).sum()) > 0
    for name, g, w in zip(tm._fields, tm, jm):
        np.testing.assert_allclose(float(g), float(w), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=name)
    np.testing.assert_allclose(float(tm.learning_rate),
                               float(jm.learning_rate), rtol=1e-6)
    assert tnew.step == int(jnew.step) == 11101
    assert tnew.opt_state.count == 11101

    for name, w in convert_tree({}, jnew.batch_stats).items():
        np.testing.assert_allclose(tnew.batch_stats[name].numpy(), w, rtol=0,
                                   atol=STEP_STAT_TOL * np.abs(w).max(),
                                   err_msg=name)
    want_g = convert_tree(jgrads, None)
    want_p = convert_tree(jnew.params, None)
    assert want_g.keys() == fb.grads.keys() == tnew.params.keys()
    l2 = {k: _rel_l2(fb.grads[k].numpy(), np.asarray(w))
          for k, w in want_g.items()}
    shares = {k: _share_beyond(tnew.params[k].numpy(), np.asarray(w))
              for k, w in want_p.items()}
    worst_g, worst_p = max(l2, key=l2.get), max(shares, key=shares.get)
    print(f"resumed step at B=1: {n_pos} positive anchors, loss "
          f"{float(tm.loss):.6f} (JAX {float(jm.loss):.6f}), rate "
          f"{float(tm.learning_rate):.6e} (optax {float(jm.learning_rate):.6e}"
          f"); gradients' largest relative L2 {l2[worst_g]:.2e} "
          f"({worst_g}); new parameters' largest share beyond 2e-5 + 2e-3 "
          f"|w| {shares[worst_p]:.2e} ({worst_p})")
    assert l2[worst_g] <= GRAD_L2, (worst_g, l2[worst_g])
    assert shares[worst_p] <= PARAM_SHARE, (worst_p, shares[worst_p])
