"""Checkpoints of the JAX package, read without JAX, and the bridge between
flax variable trees and the port's ``state_dict``, both ways.

A JAX checkpoint is a pickle of ``{"state": TrainState(step, params,
batch_stats, opt_state), "extra": {...}}`` (or ``{"state": {"params",
"batch_stats"}}``) with NumPy leaves. Its pickle names classes of the JAX
package and of optax; :func:`load_checkpoint` maps those to local tuple
stand-ins, so neither package is imported, and refuses every other class
outside NumPy. The port writes the same layout with plain tuples and dicts
(``train/checkpoint.py``), which either package reads.
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
    """Stand-in for optax's optimizer-state tuples: their fields in order."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


class MaskedNode(tuple):
    """Stand-in for optax's placeholder of a masked (frozen) leaf."""

    def __new__(cls, *fields):
        return tuple.__new__(cls, fields)


_STAND_INS = {
    ("pillars_tpu.train.loop", "TrainState"): TrainState,
    ("optax._src.transform", "ScaleByAdamState"): _OpaqueState,
    ("optax._src.transform", "ScaleByScheduleState"): _OpaqueState,
    ("optax._src.base", "EmptyState"): _OpaqueState,
    # train.optimizer.freeze_patterns: optax.multi_transform's states
    ("optax.transforms._combining", "PartitionState"): _OpaqueState,
    ("optax.transforms._masking", "MaskedState"): _OpaqueState,
    ("optax.transforms._masking", "MaskedNode"): MaskedNode,
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


def load_checkpoint(path: str) -> Tuple[Any, Dict]:
    """(state, extra) of a checkpoint file of either package: the state a
    :class:`TrainState` of NumPy trees (optax's states as plain tuples) or a
    ``{"params", "batch_stats"}`` dict."""
    with open(path, "rb") as f:
        payload = _Unpickler(f).load()
    if isinstance(payload, dict) and "state" in payload:
        state, extra = payload["state"], payload.get("extra") or {}
    else:
        state, extra = payload, {}
    if isinstance(state, tuple) and not isinstance(state, TrainState) \
            and len(state) == 4:
        state = TrainState(*state)
    return state, extra


def load_params(path: str) -> Tuple[Dict, Dict]:
    """(params, batch_stats) NumPy trees of a checkpoint file."""
    state, _ = load_checkpoint(path)
    if isinstance(state, dict):
        return state["params"], state.get("batch_stats")
    if isinstance(state, tuple) and len(state) >= 3:
        return state[1], state[2]
    raise ValueError(f"unrecognized checkpoint structure in {path}")


def _flatten(tree, prefix=()):
    """(path, array) of every leaf of a nested dict."""
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
        elif arr.ndim == 3:                    # sparse taps [K, Ci, Co]
            pass
        elif arr.ndim == 5:                    # conv3d [kd, kh, kw, Ci, Co]
            arr = arr.transpose(4, 3, 0, 1, 2)
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


def _unconvert_param(name: str, arr: np.ndarray) -> Tuple[tuple, np.ndarray]:
    """The inverse of :func:`_convert_param`: a torch name and layout ->
    (flax path, flax layout)."""
    *mods, leaf = name.split(".")
    if leaf == "weight" and arr.ndim == 1:
        leaf = "scale"
    elif leaf == "weight":
        if arr.ndim == 2:                      # Linear [out, in] -> [in, out]
            arr = arr.T
        elif arr.ndim == 3:                    # sparse taps, as they are
            pass
        elif arr.ndim == 5:                    # [Co, Ci, kd, kh, kw]
            arr = arr.transpose(2, 3, 4, 1, 0)
        elif mods[-1] == "deconv":             # [Ci, Co, k, k] -> flipped
            arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
        else:                                  # [Co, Ci, kh, kw]
            arr = arr.transpose(2, 3, 1, 0)
        leaf = "kernel"
    elif leaf != "bias":
        raise KeyError(f"unexpected parameter {name}")
    return tuple(mods) + (leaf,), arr


def flax_path(name: str, ndim: int) -> str:
    """The flax path string ("rpn/block1/bn0/scale") of the torch parameter
    ``name`` of ``ndim`` dimensions."""
    return "/".join(_unconvert_param(name, np.empty((1,) * ndim))[0])


def _nest(tree: Dict, path: tuple, arr: np.ndarray) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = np.ascontiguousarray(arr)


def params_to_jax_tree(params: Dict[str, torch.Tensor]) -> Dict:
    """Torch-named parameter-shaped tensors (parameters, gradients, Adam
    moments) -> a flax-layout tree of NumPy arrays of their dtype."""
    out: Dict = {}
    for name, t in params.items():
        _nest(out, *_unconvert_param(name, t.detach().cpu().numpy()))
    return out


def to_jax_variables(state: Dict[str, torch.Tensor], cfg=None
                     ) -> Tuple[Dict, Dict]:
    """A port ``state_dict`` -> flax (params, batch_stats) trees of NumPy
    arrays, the exact inverse of :func:`from_jax_variables`
    (``num_batches_tracked`` has no flax counterpart and is dropped).
    ``cfg`` is accepted for the symmetry of the two and unused: the names
    and shapes say everything."""
    del cfg
    inverse = {v: k for k, v in _STAT_NAMES.items()}
    stats: Dict = {}
    params = {}
    for name, t in state.items():
        *mods, leaf = name.split(".")
        if leaf in inverse:
            _nest(stats, tuple(mods) + (inverse[leaf],),
                  t.detach().cpu().numpy())
        elif leaf != "num_batches_tracked":
            params[name] = t
    return params_to_jax_tree(params), stats


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
