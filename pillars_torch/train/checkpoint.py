"""Checkpoints (pillars_tpu/train/checkpoint.py): atomic pickles of host
NumPy trees in the JAX package's flax layout, and the out-dir layout.

A file holds ``{"state": (step, params, batch_stats, opt_state), "extra":
{...}}`` with plain tuples and dicts of NumPy arrays: params and
batch_stats are flax trees (``weights.to_jax_variables``), opt_state is
optax's chain (scale_by_adam (count, mu, nu), scale_by_schedule (count,),
two empty states) with flax-layout moments. So ``pillars_tpu.train.
checkpoint.load_params`` reads the port's files, and the port reads the JAX
package's (optax's classes through the restricted unpickler of
``weights.py``) and resumes them, Adam moments included.

reference behaviour kept: auto-incrementing model dirs (reference
libraries/train_helper_functions.py:95-143), best-score-gated retention and
a rolling temp checkpoint (train.py:403-440), optimizer state saved for an
exact resume. ``import_reference_h5`` (the reference's Keras .h5) is not
ported yet.
"""

from __future__ import annotations

import os
import pathlib
import pickle
from typing import Dict, Optional

import numpy as np

from pillars_torch import weights
from pillars_torch.train.loop import TrainState, split_state
from pillars_torch.train.optim import AdamState
# files of either package, read without JAX: (state, extra) and the
# (params, batch_stats) flax trees
from pillars_torch.weights import load_checkpoint, load_params  # noqa: F401


def create_out_dirs(out_dir_base: str, model_id: str) -> Dict[str, str]:
    """Auto-incrementing out/model_<id>/ with checkpoint/log subdirs
    (reference train_helper_functions.py:95-143)."""
    base = pathlib.Path(out_dir_base)
    base.mkdir(parents=True, exist_ok=True)
    mid = str(model_id)
    while (base / f"model_{mid}").exists():
        mid = str(int(mid) + 1)
    model_dir = base / f"model_{mid}"
    dirs = {
        "model_dir": str(model_dir),
        "model_id": mid,
        "checkpoints": str(model_dir / "checkpoints"),
        "logs": str(model_dir / "logs"),
        "results": str(model_dir / "results"),
    }
    for k in ("checkpoints", "logs", "results"):
        pathlib.Path(dirs[k]).mkdir(parents=True, exist_ok=True)
    return dirs


def to_host(state: TrainState) -> tuple:
    """A port :class:`TrainState` -> the flax-layout plain tuple."""
    params, stats = weights.to_jax_variables(
        {**state.params, **state.batch_stats})
    opt = state.opt_state
    count = np.int32(opt.count)
    adam = (count, weights.params_to_jax_tree(opt.mu),
            weights.params_to_jax_tree(opt.nu))
    return (np.int32(state.step), params, stats, (adam, (count,), (), ()))


def save_checkpoint(path: str, state, extra: Optional[Dict] = None) -> None:
    """Write a :class:`TrainState` (or an already host-side tree) with the
    atomic tmp + rename."""
    if isinstance(state, TrainState):
        state = to_host(state)
    payload = {"state": state, "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    os.replace(tmp, path)


def _adam_of(opt_state):
    """optax's ScaleByAdamState fields (count, mu, nu) from the plain chain
    tuple, or from the multi_transform state of ``freeze_patterns``
    (PartitionState({"train": MaskedState(chain), ...}))."""
    if isinstance(opt_state[0], dict):
        opt_state = opt_state[0]["train"][0]
    return opt_state[0]


def _drop_masked(tree):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _drop_masked(v)
            if v:
                out[k] = v
        elif not isinstance(v, weights.MaskedNode):
            out[k] = v
    return out


def train_state_from_host(host, cfg, device) -> TrainState:
    """A flax-layout TrainState (the JAX package's or the port's) -> a port
    :class:`TrainState` on ``device``."""
    step, params, stats, opt_state = host
    state = weights.from_jax_variables(params, stats, cfg)
    p, s = split_state({k: v.to(device) for k, v in state.items()})
    count, mu, nu = _adam_of(opt_state)
    moments = [{k: v.to(device) for k, v in
                weights.convert_tree(_drop_masked(m), None).items()}
               for m in (mu, nu)]
    return TrainState(int(np.asarray(step)), p, s,
                      AdamState(int(np.asarray(count)), *moments))
