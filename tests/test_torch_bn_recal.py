"""AdaBN recalibration of the BN statistics before eval
(pillars_torch/train/bn_recal.py and ``Evaluator._maybe_recalibrate``)
against pillars_tpu's on the CPU: the refreshed statistics within 1e-5 of
their max |value|, parameters untouched, the state handed in unchanged; the
Evaluator with ``eval_input.bn_recal_batches`` > 0 reads the train split.
"""

import numpy as np
import torch

import jax

from pillars_torch.config import Config as TorchConfig
from pillars_torch.data import synthetic
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.train.bn_recal import build_recal_fn
from pillars_torch.train.bn_recal import recalibrate as torch_recal
from pillars_torch.train.trainer import Evaluator
from pillars_torch.weights import (convert_tree, from_jax_variables,
                                   to_jax_variables)
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.train.bn_recal import recalibrate as jax_recal
from torch_parity import randomize_variables, small_config, train_batches

torch.set_num_threads(2)
STAT_TOL = 1e-5


def test_recalibrate_matches_jax():
    jcfg, tcfg = small_config(JaxConfig), small_config(TorchConfig)
    state = TorchDetector(tcfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    params, stats = to_jax_variables(state)
    v = randomize_variables({"params": params, "batch_stats": stats}, seed=7)
    batches = [{k: b[k] for k in ("points", "num_points")}
               for b in train_batches(4, 3)]
    want = jax.device_get(jax_recal(jcfg, v, batches)["batch_stats"])
    tstate = from_jax_variables(v["params"], v["batch_stats"], tcfg)
    before = {k: t.clone() for k, t in tstate.items()}
    got = torch_recal(tcfg, tstate, batches, device="cpu")
    assert all(torch.equal(tstate[k], before[k]) for k in tstate)
    moved = 0
    for name, w in convert_tree({}, want).items():
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=STAT_TOL * np.abs(w).max(),
                                   err_msg=name)
        moved += not torch.equal(got[name], before[name])
    assert moved == len(convert_tree({}, want))
    assert all(got[k] is tstate[k] for k in tstate
               if not k.rsplit(".", 1)[-1].startswith(("running", "num_")))


def test_evaluator_recalibrates_from_the_train_split(tmp_path):
    root = synthetic.generate_dataset(str(tmp_path / "d"), num_train=3,
                                      num_test=2, seed=1)
    cfg = small_config(TorchConfig)
    for key, value in (("eval_input.dataset_root", root),
                       ("eval_input.info_path", f"{root}/kitti_infos_val.pkl"),
                       ("train_input.dataset_root", root),
                       ("train_input.info_path",
                        f"{root}/kitti_infos_train.pkl"),
                       ("eval_input.bn_recal_batches", 2),
                       ("eval_input.batch_size", 1),
                       ("eval_input.num_workers", 1)):
        cfg = cfg.override(key, value)
    det = TorchDetector(cfg, device="cpu")
    state = det.init(torch.Generator().manual_seed(0))
    ev = Evaluator(cfg, det)
    recal = ev._maybe_recalibrate(state)
    assert ev._recal_batches is not None and len(ev._recal_batches) == 2
    assert not torch.equal(recal["rpn.block1.bn0.running_mean"],
                           state["rpn.block1.bn0.running_mean"])
    # the same refresh as recalibrate over those scenes
    want = torch_recal(cfg, state, ev._recal_batches,
                       step=build_recal_fn(cfg, device="cpu"))
    assert all(torch.equal(recal[k], want[k]) for k in want)
    result, bev, d3, aos, score = ev.evaluate(state, max_samples=2)
    assert np.isfinite(score)
