"""Checkpoints of the JAX package, read without JAX, and turned into the
port's ``state_dict``.

A JAX checkpoint is a pickle of ``{"state": TrainState(step, params,
batch_stats, opt_state), "extra": {...}}`` (or ``{"state": {"params",
"batch_stats"}}``) with NumPy leaves. Its pickle names classes of the JAX
package and of optax; :func:`load_params` maps those to local tuple
stand-ins, so neither package is imported, and refuses every other class
outside NumPy.
"""

from __future__ import annotations

import importlib
import pickle
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch


class TrainState(NamedTuple):
    """Stand-in for the JAX package's train-loop state."""

    step: Any
    params: Any
    batch_stats: Any
    opt_state: Any


class _OpaqueState(tuple):
    """Stand-in for optax's optimizer-state tuples (unused here)."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


_STAND_INS = {
    ("pillars_tpu.train.loop", "TrainState"): TrainState,
    ("optax._src.transform", "ScaleByAdamState"): _OpaqueState,
    ("optax._src.transform", "ScaleByScheduleState"): _OpaqueState,
    ("optax._src.base", "EmptyState"): _OpaqueState,
}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _STAND_INS:
            return _STAND_INS[(module, name)]
        if module == "numpy" or module.startswith("numpy."):
            try:
                return super().find_class(module, name)
            except ModuleNotFoundError:
                # a NumPy 2 pickle (numpy._core) read under NumPy 1
                legacy = module.replace("numpy._core", "numpy.core", 1)
                return getattr(importlib.import_module(legacy), name)
        raise pickle.UnpicklingError(
            f"checkpoint names {module}.{name}, which is neither NumPy nor a "
            f"known checkpoint class")


def load_params(path: str) -> Tuple[Dict, Dict]:
    """(params, batch_stats) NumPy trees of a JAX checkpoint file."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    state = payload["state"] if isinstance(payload, dict) else payload
    if isinstance(state, dict):
        return state["params"], state.get("batch_stats")
    if isinstance(state, tuple) and len(state) >= 3:
        return state[1], state[2]
    raise ValueError(f"unrecognized checkpoint structure in {path}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def _convert_param(path, arr: np.ndarray) -> Tuple[str, np.ndarray]:
    *mods, leaf = path
    if leaf == "kernel":
        if arr.ndim == 2:                      # Dense [in, out] -> [out, in]
            arr = arr.T
        elif mods[-1] == "deconv":
            # flax ConvTranspose [k, k, Ci, Co] (transpose_kernel=False) ->
            # torch ConvTranspose2d [Ci, Co, k, k], spatially flipped
            arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)
        else:                                  # conv [kh, kw, Ci, Co]
            arr = arr.transpose(3, 2, 0, 1)
        leaf = "weight"
    elif leaf == "scale":
        leaf = "weight"
    elif leaf != "bias":
        raise KeyError(f"unexpected parameter {'/'.join(path)}")
    return ".".join(mods + [leaf]), arr


_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def convert_tree(params: Dict, batch_stats: Optional[Dict]
                 ) -> Dict[str, torch.Tensor]:
    """Flax ``params``/``batch_stats`` trees (of the whole network or of one
    module) -> torch names and layouts, unchecked."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(params):
        name, arr = _convert_param(path, arr)
        out[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    for path, arr in _flatten(batch_stats or {}):
        *mods, leaf = path
        name = ".".join(mods + [_STAT_NAMES[leaf]])
        out[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))
    return out


def from_jax_variables(params: Dict, batch_stats: Optional[Dict],
                       cfg) -> Dict[str, torch.Tensor]:
    """Flax ``params``/``batch_stats`` trees -> the ``state_dict`` of
    :class:`pillars_torch.models.detector.Network` for the model config
    ``cfg`` (a :class:`~pillars_torch.config.Config` or its ``model``),
    dense-cell or point-major: the two share their names. Checked strictly
    against that network's names and shapes."""
    from pillars_torch.models.detector import Network

    out = convert_tree(params, batch_stats)
    net = Network(getattr(cfg, "model", cfg))
    for name, buf in net.named_buffers():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.zeros_like(buf)
    net.load_state_dict(out, strict=True)  # raises on a name/shape mismatch
    return out
