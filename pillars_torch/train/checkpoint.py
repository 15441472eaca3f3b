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
exact resume; ``import_reference_h5`` maps the reference's Keras .h5
weights onto a port state.
"""

from __future__ import annotations

import os
import pathlib
import pickle
from typing import Dict, Optional, Tuple

import numpy as np
import torch

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


# ---------------------------------------------------------------------------
# reference .h5 import (Keras save_weights layout)
# ---------------------------------------------------------------------------

def _keras_h5_arrays(h5path: str) -> Tuple[Dict[str, np.ndarray], bool]:
    """Flatten a Keras save_weights .h5 into ({path: array}, keras_tagged)
    where keras_tagged is True when the file carries Keras save_weights
    attrs (layer_names / keras_version / backend) at the root."""
    import h5py

    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = np.asarray(obj)

    with h5py.File(h5path, "r") as f:
        f.visititems(visit)
        keras_tagged = any(k in f.attrs
                           for k in ("layer_names", "keras_version",
                                     "backend"))
    return out, keras_tagged


def _natural_key(s: str):
    import re

    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def _collect_bn(group_arrays):
    """Pick (gamma, beta, moving_mean, moving_variance) from a dataset dict
    by Keras naming."""
    out = {}
    for name, arr in group_arrays:
        low = name.lower()
        if "gamma" in low:
            out["scale"] = arr
        elif "beta" in low:
            out["bias"] = arr
        elif "moving_mean" in low:
            out["mean"] = arr
        elif "moving_var" in low:
            out["var"] = arr
    return out


def import_reference_h5(h5path: str, state: Dict[str, torch.Tensor],
                        strict: bool = True,
                        deconv_orientation: str = "auto"
                        ) -> Dict[str, torch.Tensor]:
    """Map a reference VoxelNet Keras .h5 checkpoint (save_weights layout)
    onto a copy of the port's ``state`` (a network ``state_dict``, e.g.
    ``PillarsDetector.init``'s, which gives the names and shapes): the
    tensors ``weights.from_jax_variables`` gives from the JAX package's
    import of the same file. The mapping runs on the flax layout
    (``weights.to_jax_variables``), as the JAX package's does.

    Correspondence (reference model/voxelnet.py + pointpillars.py ->
    models/pfn.py + models/rpn.py):
      pillar feature net Dense/BN                     -> pfn/dense, pfn/bn
      rpn blockN separable convs (depthwise+pointwise) + BN
                                                      -> rpn/blockN/conv*/bn*
      rpn deconvN Conv2DTranspose + BN                -> rpn/deconvN
      conv_box / conv_cls / conv_dir_cls              -> rpn/conv_*

    Kernel layout conversions (to flax's, then the port's through
    ``weights.convert_tree``): Dense (I, O) and pointwise Conv2D
    (1, 1, I, O) match flax directly; SeparableConv2D depthwise kernels
    (3, 3, C, 1) transpose to flax's grouped layout (3, 3, 1, C);
    Conv2DTranspose kernels (k, k, O, I) transpose to flax (k, k, I, O).

    Keras auto-numbers layer names, so matching is structural: datasets are
    grouped by path prefix (natural-sorted to respect _10 > _2), classified
    by shape/keyword, and consumed in build order. The mapping is validated
    against self-built Keras-layout files (tests/test_torch_h5_import.py),
    not against a genuine reference file: with ``strict=True`` any
    unconsumed or unmatched weight raises. ``h5py`` is imported here only.

    ``deconv_orientation``: Conv2DTranspose kernel convention in the file —
      * "keras": (k, k, O, I), gradient-of-conv orientation; converted with
        a spatial flip + channel transpose (settled numerically,
        tests/test_torch_h5_import.py::TestConv2DTransposeOrientation);
      * "flax": (k, k, I, O), used as-is;
      * "auto" (default): inferred per file — non-square (I != O) kernels
        identify the convention unambiguously by shape, and one file has
        one convention, so a single non-square deconv settles all of them;
        files whose deconvs are ALL square fall back to the Keras
        save_weights root attrs (layer_names/keras_version), and when even
        that is absent the import FAILS LOUDLY rather than silently
        guessing a kernel orientation that would corrupt every decode.
    """
    if deconv_orientation not in ("auto", "keras", "flax"):
        raise ValueError(f"deconv_orientation {deconv_orientation!r} not in "
                         "('auto', 'keras', 'flax')")
    arrays, keras_tagged = _keras_h5_arrays(h5path)
    if not arrays:
        raise ValueError(f"no datasets found in {h5path}")

    items = sorted(arrays.items(), key=lambda kv: _natural_key(kv[0]))
    consumed = set()

    def take(pred, what, required=True):
        for name, arr in items:
            if name in consumed:
                continue
            if pred(name.lower(), arr):
                consumed.add(name)
                return np.asarray(arr)
        if required and strict:
            raise ValueError(f"h5 import: could not locate {what} in {h5path}")
        return None

    def take_group(prefix_pred, what):
        """All not-yet-consumed datasets whose path matches, in order."""
        got = [(n, a) for n, a in items
               if n not in consumed and prefix_pred(n.lower())]
        for n, _ in got:
            consumed.add(n)
        if not got and strict:
            raise ValueError(f"h5 import: no datasets for {what}")
        return got

    params, stats = weights.to_jax_variables(state)  # fresh trees

    # ---- PFN -----------------------------------------------------------
    dkernel = params["pfn"]["dense"]["kernel"]
    arr = take(lambda n, a: a.ndim == 2 and a.shape == dkernel.shape,
               "pfn dense kernel")
    params["pfn"]["dense"]["kernel"] = arr
    c = dkernel.shape[1]
    # the first four [c]-shaped arrays (natural order) are the PFN BatchNorm
    bn_sets = [(n, a) for n, a in items
               if n not in consumed and a.shape == (c,)][:4]
    for n, _ in bn_sets:
        consumed.add(n)
    pfn_bn = _collect_bn(bn_sets)
    if len(pfn_bn) != 4 and strict:
        raise ValueError("h5 import: pfn BatchNorm weights not found")
    params["pfn"]["bn"]["scale"] = pfn_bn["scale"]
    params["pfn"]["bn"]["bias"] = pfn_bn["bias"]
    stats["pfn"]["bn"]["mean"] = pfn_bn["mean"]
    stats["pfn"]["bn"]["var"] = pfn_bn["var"]

    # ---- RPN blocks ------------------------------------------------------
    # groups inside the h5 are traversed alphabetically (Keras gives no
    # build order without the weight_names attr), so pair by CATEGORY:
    # depthwise kernels / pointwise kernels / BN groups, each natural-sorted
    # (Keras counters increase with build order), matched positionally.
    for bi in (1, 2, 3):
        block = params["rpn"][f"block{bi}"]
        bstats = stats["rpn"][f"block{bi}"]
        n_layers = len([k for k in block if k.startswith("conv")])
        grp = take_group(lambda n, bi=bi: f"block{bi}" in n, f"block{bi}")
        dws = [(n, a) for n, a in grp
               if a.ndim == 4 and a.shape[:2] == (3, 3) and a.shape[3] == 1]
        pws = [(n, a) for n, a in grp
               if a.ndim == 4 and a.shape[:2] == (1, 1)]
        bn_groups: dict = {}
        for n, a in grp:
            if a.ndim == 1:
                bn_groups.setdefault(n.rsplit("/", 1)[0], []).append((n, a))
        bn_names = sorted(bn_groups, key=_natural_key)
        if strict and not (len(dws) == len(pws) == len(bn_names) == n_layers):
            raise ValueError(
                f"h5 import: block{bi} expects {n_layers} layers, found "
                f"{len(dws)} depthwise / {len(pws)} pointwise / "
                f"{len(bn_names)} BN groups")
        for li in range(n_layers):
            conv = block[f"conv{li}"]
            name, arr = dws[li]
            want = (3, 3, conv["depthwise"]["kernel"].shape[3], 1)
            if arr.shape != want and strict:
                raise ValueError(
                    f"h5 import: block{bi} conv{li} depthwise shape "
                    f"{arr.shape} != {want} ({name})")
            conv["depthwise"]["kernel"] = np.transpose(arr, (0, 1, 3, 2))
            name, arr = pws[li]
            if arr.shape != conv["pointwise"]["kernel"].shape and strict:
                raise ValueError(
                    f"h5 import: block{bi} conv{li} pointwise shape "
                    f"{arr.shape} ({name})")
            conv["pointwise"]["kernel"] = np.asarray(arr)
            bn = _collect_bn(bn_groups[bn_names[li]])
            block[f"bn{li}"]["scale"] = bn["scale"]
            block[f"bn{li}"]["bias"] = bn["bias"]
            bstats[f"bn{li}"]["mean"] = bn["mean"]
            bstats[f"bn{li}"]["var"] = bn["var"]

    # ---- deconvs ---------------------------------------------------------
    # pass 1: collect all three kernels, then resolve the file's ONE
    # Conv2DTranspose orientation (see the docstring) before writing any.
    dec_entries = []
    votes = set()
    for di in (1, 2, 3):
        dec = params["rpn"][f"deconv{di}"]
        grp = take_group(lambda n, di=di: f"deconv{di}" in n, f"deconv{di}")
        kshape = dec["deconv"]["kernel"].shape  # flax layout (k, k, I, O)
        kernels = [(n, a) for n, a in grp if a.ndim == 4]
        if len(kernels) != 1 and strict:
            raise ValueError(f"h5 import: deconv{di}: {len(kernels)} kernels")
        name, arr = kernels[0]
        keras_shape = (kshape[0], kshape[1], kshape[3], kshape[2])
        if arr.shape not in (kshape, keras_shape) and strict:
            raise ValueError(
                f"h5 import: deconv{di} kernel shape {arr.shape} "
                f"!= {kshape} ({name})")
        if kshape[2] != kshape[3]:  # non-square: shape identifies it
            votes.add("keras" if arr.shape == keras_shape else "flax")
        dec_entries.append((di, arr, kshape, grp))

    if deconv_orientation == "auto":
        if len(votes) > 1:
            raise ValueError(
                "h5 import: deconv kernels mix (O, I) and (I, O) channel "
                "orders within one file — refusing to guess; pass "
                "deconv_orientation='keras' or 'flax' explicitly")
        if votes:
            orientation = votes.pop()
        elif keras_tagged:
            orientation = "keras"  # save_weights attrs mark a Keras file
        else:
            raise ValueError(
                "h5 import: every Conv2DTranspose kernel is square "
                "(in_ch == out_ch) and the file carries no Keras "
                "save_weights attrs, so the kernel orientation cannot be "
                "inferred; a wrong guess would silently corrupt every "
                "decode. Pass deconv_orientation='keras' (TF/Keras "
                "(k, k, O, I) gradient-of-conv kernels) or 'flax' "
                "((k, k, I, O), used as-is).")
    else:
        orientation = deconv_orientation
        if votes and {orientation} != votes:
            raise ValueError(
                f"h5 import: deconv_orientation={orientation!r} was "
                f"requested but a non-square deconv kernel has the "
                f"{votes.pop()!r} channel order")

    for di, arr, kshape, grp in dec_entries:
        dec = params["rpn"][f"deconv{di}"]
        dstats = stats["rpn"][f"deconv{di}"]
        if orientation == "keras":
            # Keras Conv2DTranspose kernels are (k, k, O, I) with the
            # gradient-of-conv orientation: flax's ConvTranspose
            # (lax.conv_transpose, transpose_kernel=False) additionally
            # needs the SPATIAL axes flipped, not just the channel
            # transpose (settled numerically:
            # tests/test_torch_h5_import.py::TestConv2DTransposeOrientation).
            dec["deconv"]["kernel"] = np.transpose(
                arr[::-1, ::-1], (0, 1, 3, 2))
        else:
            dec["deconv"]["kernel"] = np.asarray(arr)
        bn = _collect_bn([(n, a) for n, a in grp if a.ndim == 1])
        dec["bn"]["scale"] = bn["scale"]
        dec["bn"]["bias"] = bn["bias"]
        dstats["bn"]["mean"] = bn["mean"]
        dstats["bn"]["var"] = bn["var"]

    # ---- heads -----------------------------------------------------------
    for head in ("conv_box", "conv_cls", "conv_dir_cls"):
        if head not in params["rpn"]:
            continue
        hk = params["rpn"][head]["kernel"].shape
        arr = take(lambda n, a, head=head, hk=hk:
                   head in n and a.shape == hk, f"{head} kernel")
        params["rpn"][head]["kernel"] = arr
        hb = params["rpn"][head]["bias"].shape
        arr = take(lambda n, a, head=head, hb=hb:
                   head in n and a.shape == hb, f"{head} bias")
        params["rpn"][head]["bias"] = arr

    leftovers = [n for n, _ in items if n not in consumed
                 and "code_weights" not in n.lower()]
    if leftovers and strict:
        raise ValueError(f"h5 import: unconsumed datasets: {leftovers}")
    out = dict(state)
    for name, t in weights.convert_tree(params, stats).items():
        out[name] = t.to(state[name].device)
    return out
