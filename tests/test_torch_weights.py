"""The weight bridge: the port reads the JAX checkpoint array for array, the
layout conversion round-trips, and the ConvTranspose orientation holds."""

import pathlib

import numpy as np
import pytest
import torch

import jax
from flax import linen as nn

from pillars_torch.config import Config
from pillars_torch.models.detector import Network
from pillars_torch.weights import (_convert_param, from_jax_variables,
                                    load_params)
from pillars_tpu.train.checkpoint import load_params as jax_load_params

torch.set_num_threads(2)

WEIGHTS = (pathlib.Path(__file__).resolve().parent.parent / "benchmarks"
           / "hard_synth" / "weights_59.pkl")


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_load_params_equals_jax_loader():
    params, stats = load_params(str(WEIGHTS))
    jparams, jstats = jax_load_params(str(WEIGHTS))
    for mine, ref in ((params, jparams), (stats, jstats)):
        got = dict(_leaves(mine))
        want = dict(_leaves(jax.device_get(ref)))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _back_to_flax(name, t):
    """Inverse of the bridge's layout change, for the round trip."""
    a = t.numpy()
    if name.endswith("running_mean") or name.endswith("running_var"):
        return "batch_stats", name.rsplit(".", 1)[0].split(".") + [
            name.rsplit("_", 1)[1]], a
    *mods, leaf = name.split(".")
    if leaf == "bias":
        return "params", mods + ["bias"], a
    if a.ndim == 1:
        return "params", mods + ["scale"], a
    if a.ndim == 2:
        return "params", mods + ["kernel"], a.T
    if mods[-1] == "deconv":
        return "params", mods + ["kernel"], a.transpose(2, 3, 0, 1)[::-1, ::-1]
    return "params", mods + ["kernel"], a.transpose(2, 3, 1, 0)


def test_state_dict_round_trip():
    params, stats = load_params(str(WEIGHTS))
    state = from_jax_variables(params, stats, Config.default())
    back = {"params": {}, "batch_stats": {}}
    for name, t in state.items():
        if name.endswith("num_batches_tracked"):
            continue
        coll, path, a = _back_to_flax(name, t)
        d = back[coll]
        for p in path[:-1]:
            d = d.setdefault(p, {})
        d[path[-1]] = a
    for mine, ref in ((back["params"], params), (back["batch_stats"], stats)):
        got, want = dict(_leaves(mine)), dict(_leaves(ref))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bridge_rejects_mismatched_config():
    params, stats = load_params(str(WEIGHTS))
    narrow = Config.default().override("model.rpn.num_filters", [32, 64, 128])
    with pytest.raises(RuntimeError):
        from_jax_variables(params, stats, narrow)


def test_point_major_network_loads_the_same_state():
    """PointwisePFN and DenseCellPFN share parameter names, and the fused
    blocks read the RPN's: one state serves both front ends."""
    params, stats = load_params(str(WEIGHTS))
    dense = from_jax_variables(params, stats, Config.default())
    point_major = (Config.default().override("model.pfn.dense_cell", False)
                   .override("model.rpn.use_pallas_blocks", True))
    net = Network(point_major.model)
    assert not net.dense_cell
    state = from_jax_variables(params, stats, point_major)
    assert state.keys() == dense.keys() == net.state_dict().keys()
    for k in state:
        assert torch.equal(state[k], dense[k]), k


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_conv_transpose_orientation(stride):
    """flax ConvTranspose (kernel == stride, VALID) == torch ConvTranspose2d
    with the bridge's flipped kernel; equal up to f32 summation order."""
    r = np.random.RandomState(stride)
    ci, co, h, w = 5, 3, 4, 6
    x = r.randn(2, h, w, ci).astype(np.float32)
    kernel = r.randn(stride, stride, ci, co).astype(np.float32)
    conv = nn.ConvTranspose(co, (stride, stride), strides=(stride, stride),
                            padding="VALID", use_bias=False)
    want = np.asarray(conv.apply({"params": {"kernel": kernel}}, x))

    name, weight = _convert_param(("rpn", "deconv1", "deconv", "kernel"),
                                  kernel)
    assert name == "rpn.deconv1.deconv.weight"
    got = torch.nn.functional.conv_transpose2d(
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(weight.copy()), stride=stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)
