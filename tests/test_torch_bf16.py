"""``runtime.compute_dtype=bfloat16``: the port against the JAX package in
bfloat16 on the CPU, on NumPy-seeded inputs and weights.

Both round to bfloat16 at the same points (flax's ``dtype``: a Dense, conv
or deconv casts its input and weights, a BN computes in float32 and rounds
once, ``_SplitHead`` rounds after every branch sum, the PFN's scatter-max is
in bfloat16, the fused blocks round only their outputs). Criteria
(``torch_parity``):
- module criterion, for a layer with one rounding point at its output: the
  JAX package's dtype, every element within one bfloat16 step, at most 1%
  of the elements differing (BF16_MAX_SHARE);
- head criterion, for anything with several rounding points in sequence:
  the JAX package's dtype, rms(port - jax_bf16) <= 0.25 x rms(jax_bf16 -
  jax_f32) per head (BF16_RMS_FACTOR) and max |port - jax_bf16| <= max
  |jax_bf16 - jax_f32| (BF16_MAX_FACTOR), on the same inputs and weights;
- predictions matched as sets (``compare_predictions_bf16``): bfloat16
  heads give exact score ties, and near-tied boxes trade slots; the
  random-init cases, whose boxes reach 1e5 m, hold boxes to
  BF16_BOX_RTOL_RANDOM_INIT, the spread measured between two faithful
  variants of the port.
The JAX side runs under ``jax.jit`` (eager JAX over these graphs costs
minutes), compiled with XLA's excess precision off
(``torch_parity.XLA_STRICT``): XLA then keeps every rounding the JAX
package's code asks for, where by default it drops the rounding of a conv's
output that a BatchNorm upcasts at once.
"""

import functools
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models import layers as tl
from pillars_torch.models import rpn as trpn
from pillars_torch.weights import convert_tree
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models import layers as jl
from pillars_tpu.models import rpn as jrpn
from torch_parity import (BF16_BOX_RTOL_RANDOM_INIT, BF16_RMS_FACTOR,
                          BF16_RMS_FACTOR_FULL, head_criterion, head_ratio,
                          heads_criterion,
                          jit_strict, module_criterion, randomize_variables,
                          small_config)

torch.set_num_threads(2)
BF16 = jnp.bfloat16
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load(module, variables):
    state = convert_tree(variables["params"], variables.get("batch_stats"))
    missing, unexpected = module.load_state_dict(state, strict=False)
    assert not unexpected, unexpected
    assert all(m.endswith("num_batches_tracked") for m in missing), missing
    return module.eval()


def _random(module, seed, *args, **kwargs):
    """Randomized variables of a flax module (init under jit)."""
    init = jit_strict(functools.partial(module.init, **kwargs))(
        jax.random.PRNGKey(seed), *args)
    init = jax.device_get(init)
    return randomize_variables({"params": init["params"],
                                "batch_stats": init.get("batch_stats", {})},
                               seed)


def _apply(module, variables, *args, **kwargs):
    return jax.device_get(jit_strict(functools.partial(
        module.apply, **kwargs))(variables, *args))


def _nchw(a):
    return torch.from_numpy(np.asarray(a, np.float32)).permute(0, 3, 1, 2)


def _bf16_nchw(a):
    return _nchw(a).to(torch.bfloat16)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _rng_images(seed, shape, relu=False):
    r = np.random.RandomState(seed)
    x = r.randn(*shape).astype(np.float32)
    return np.maximum(x, 0) if relu else x


# ----------------------------------------------------------------------
# module criterion: one rounding point at the output


def test_dense_module():
    r = np.random.RandomState(0)
    x = r.randn(3000, 8).astype(np.float32) * 3
    dense = fnn.Dense(64, use_bias=False, dtype=BF16)
    variables = _random(dense, 0, jnp.asarray(x))
    want = _apply(dense, {"params": variables["params"]}, jnp.asarray(x))
    lin = tl.Linear(8, 64, dtype=torch.bfloat16)
    lin.weight.data = torch.from_numpy(
        np.asarray(variables["params"]["kernel"]).T.copy())
    with torch.no_grad():
        got = lin(torch.from_numpy(x))
    module_criterion(got, want, "Dense")


def test_masked_batch_norm_module():
    r = np.random.RandomState(1)
    x = jnp.asarray(r.randn(300, 6, 16).astype(np.float32) * 4).astype(BF16)
    mask = jnp.asarray(r.rand(300, 1) > 0.3)
    bn = jl.MaskedBatchNorm(dtype=BF16)
    variables = _random(bn, 1, x, mask, use_running_average=True)
    want = _apply(bn, variables, x, mask, use_running_average=True)
    got_bn = tl.MaskedBatchNorm(16, 1e-3, 0.99, dtype=torch.bfloat16)
    _load(got_bn, variables)
    with torch.no_grad():
        got = got_bn(torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16), torch.from_numpy(np.array(mask)))
    module_criterion(got, want, "MaskedBatchNorm")


def test_batch_norm_module():
    x = jnp.asarray(_rng_images(2, (2, 12, 14, 16)) * 3).astype(BF16)
    bn = fnn.BatchNorm(use_running_average=True, epsilon=1e-3, dtype=BF16)
    variables = _random(bn, 2, x)
    want = _apply(bn, variables, x)
    got_bn = _load(tl.BatchNorm(16, 1e-3, 0.99, dtype=torch.bfloat16),
                   variables)
    with torch.no_grad():
        got = _nhwc(got_bn(_bf16_nchw(x)))
    module_criterion(got, want, "BatchNorm")


@pytest.mark.parametrize("stride,shift_add", [(1, False), (2, False),
                                              (1, True)])
def test_separable_conv_module(stride, shift_add):
    x = jnp.asarray(_rng_images(3 + stride, (2, 12, 16, 16), relu=True))
    pad = "SAME" if stride == 1 else ((1, 1), (1, 1))
    conv = jl.SeparableConv(24, 3, stride, padding=pad, dtype=BF16,
                            shift_add=shift_add)
    variables = _random(conv, stride, x)
    want = _apply(conv, {"params": variables["params"]}, x)
    got_conv = _load(tl.SeparableConv(16, 24, stride, padding=1,
                                      dtype=torch.bfloat16,
                                      shift_add=shift_add), variables)
    with torch.no_grad():
        got = _nhwc(got_conv(_nchw(x)))
    module_criterion(got, want, f"SeparableConv stride {stride}"
                     f"{' shift-add' if shift_add else ''}")


@pytest.mark.parametrize("stride", [1, 2])
def test_plain_conv_module(stride):
    x = jnp.asarray(_rng_images(5 + stride, (2, 12, 16, 16), relu=True))
    conv = fnn.Conv(24, (3, 3), strides=(stride, stride),
                    padding=((1, 1), (1, 1)), use_bias=False, dtype=BF16)
    variables = _random(conv, 5 + stride, x)
    want = _apply(conv, {"params": variables["params"]}, x)
    got_conv = tl.Conv2d(16, 24, 3, stride=stride, padding=1,
                         dtype=torch.bfloat16)
    got_conv.weight.data = torch.from_numpy(np.ascontiguousarray(
        np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)))
    with torch.no_grad():
        got = _nhwc(got_conv(_nchw(x)))
    module_criterion(got, want, f"Conv stride {stride}")


class _DeconvOnly(fnn.Module):
    """flax's ConvTranspose as the RPN's up-branch names it."""

    stride: int

    @fnn.compact
    def __call__(self, x):
        return fnn.ConvTranspose(24, (self.stride,) * 2,
                                 strides=(self.stride,) * 2, padding="VALID",
                                 use_bias=False, dtype=BF16, name="deconv")(x)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_deconv_module(stride):
    x = jnp.asarray(_rng_images(8, (2, 8, 10, 32), relu=True)).astype(BF16)
    deconv = _DeconvOnly(stride)
    variables = _random(deconv, stride, x)
    want = _apply(deconv, {"params": variables["params"]}, x)
    up = trpn._Deconv(32, 24, stride, 1e-3, dtype=torch.bfloat16)
    state = convert_tree(variables["params"], None)
    up.deconv.load_state_dict({"weight": state["deconv.weight"]})
    with torch.no_grad():
        got = _nhwc(up.deconv(_bf16_nchw(x)))
    module_criterion(got, want, f"ConvTranspose stride {stride}")


def _head_inputs(seed, chs, scale):
    r = np.random.RandomState(seed)
    return [jnp.asarray(np.maximum(r.randn(2, 10, 12, c), 0) * s).astype(BF16)
            for c, s in zip(chs, scale)]


@pytest.mark.parametrize("case", ["split", "concat", "large_terms"])
def test_split_head_module(case):
    """``_SplitHead`` rounds after each branch's einsum, after each branch
    sum and after the bias. ``large_terms``: branches of 30x the others'
    scale whose terms cancel, where one f32 sum rounded once differs from
    the bfloat16 sums in most elements (checked)."""
    chs = [16, 24, 8]
    scale = [30.0, 30.0, 1.0] if case == "large_terms" else [1.0] * 3
    ups = _head_inputs(9, chs, scale)
    head = jrpn._SplitHead(12, dtype=BF16)
    concat = case == "concat"
    jups = [jnp.concatenate(ups, axis=-1)] if concat else ups
    variables = _random(head, 9, jups)
    if case == "large_terms":
        # the second branch's weights cancel the first's on average
        k = np.asarray(variables["params"]["kernel"]).copy()
        k[0, 0, 16:32] = -k[0, 0, :16]
        variables["params"]["kernel"] = k
    want = _apply(head, {"params": variables["params"]}, jups)
    got_head = trpn._SplitHead(chs, 12, dtype=torch.bfloat16, concat=concat)
    got_head.weight.data = torch.from_numpy(np.ascontiguousarray(
        np.asarray(variables["params"]["kernel"]).transpose(3, 2, 0, 1)))
    got_head.bias.data = torch.from_numpy(np.asarray(
        variables["params"]["bias"]))
    tups = [_bf16_nchw(u) for u in ups]
    with torch.no_grad():
        got = _nhwc(got_head(tups))
    module_criterion(got, want, f"_SplitHead {case}")
    if case == "large_terms":
        # one f32 sum, rounded once: far outside the criterion
        w = got_head.weight.float()
        once = sum(torch.nn.functional.conv2d(u.float(), wi) for u, wi in zip(
            tups, w.split(chs, dim=1))) + got_head.bias[None, :, None, None]
        once = _nhwc(once.to(torch.bfloat16))
        differ = (once.view(torch.int16).numpy()
                  != np.asarray(want).view(np.int16)).mean()
        assert differ > 0.05, differ


# ----------------------------------------------------------------------
# head criterion: several rounding points in sequence


def _bf16_valued(a):
    """``a`` rounded to bfloat16, as float32: the same input for the
    float32 and the bfloat16 runs."""
    return np.asarray(jnp.asarray(a).astype(BF16).astype(jnp.float32))


def _both_dtypes(make, variables, *args, **kwargs):
    """(bf16 output, f32 output) of the flax module ``make(dtype)``."""
    return tuple(_apply(make(dt), variables, *args, **kwargs)
                 for dt in (BF16, None))


def test_block_head():
    x = _bf16_valued(_rng_images(11, (2, 16, 20, 16), relu=True))

    def make(dt):
        return jrpn._Block(32, 2, 2, 0.99, 1e-3, separable=True, dtype=dt)

    variables = _random(make(None), 11, jnp.asarray(x), train=False)
    want, want_f32 = _both_dtypes(make, variables, jnp.asarray(x),
                                  train=False)
    block = _load(trpn._Block(16, 32, 2, 2, 1e-3, True,
                              dtype=torch.bfloat16), variables)
    with torch.no_grad():
        got = _nhwc(block(_bf16_nchw(x)))
    head_criterion(got, want, want_f32, "_Block")


@pytest.mark.parametrize("separable", [True, False])
def test_rpn_head(separable):
    jcfg = small_config(JaxConfig).override("model.rpn.use_separable_conv",
                                            separable)
    tcfg = small_config(TorchConfig).override("model.rpn.use_separable_conv",
                                              separable)
    _, ny, nx = jcfg.model.feature_map_size
    canvas = jnp.asarray(_bf16_valued(_rng_images(
        12, (2, ny, nx, jcfg.model.pfn.num_filters), relu=True)))
    variables = _random(jrpn.RPN(jcfg.model), 12, canvas, train=False)
    want = _apply(jrpn.RPN(jcfg.model, dtype=BF16), variables,
                  canvas.astype(BF16), train=False)
    want_f32 = _apply(jrpn.RPN(jcfg.model), variables, canvas,
                      train=False)
    rpn = _load(trpn.RPN(tcfg.model, dtype=torch.bfloat16), variables)
    with torch.no_grad():
        got = rpn(torch.from_numpy(np.asarray(canvas)).to(torch.bfloat16))
    for key in want:
        assert str(want[key].dtype) == "bfloat16"
    heads_criterion(got, want, want_f32, f"RPN separable={separable}")


def test_remat_bf16_applies_only_to_a_float32_rpn():
    """``rpn.remat_bf16`` stores bfloat16 boundaries only where the network
    computes in float32 (the JAX package's ``self.dtype is None``): in a
    bfloat16 network the flags change nothing."""
    tcfg = small_config(TorchConfig)
    _, ny, nx = tcfg.model.feature_map_size
    flagged = tcfg.override("model.rpn.remat", True).override(
        "model.rpn.remat_bf16", True)
    torch.manual_seed(0)
    plain = trpn.RPN(tcfg.model, dtype=torch.bfloat16).eval()
    remat = trpn.RPN(flagged.model, dtype=torch.bfloat16).eval()
    remat.load_state_dict(plain.state_dict())
    canvas = torch.relu(torch.randn(1, ny, nx, tcfg.model.pfn.num_filters))
    with torch.no_grad():
        want = plain(canvas.to(torch.bfloat16))
        got = remat(canvas.to(torch.bfloat16))
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _pfn_inputs(kind, with_distance=False):
    """(jax config, torch config, PFN args as NumPy arrays) from the JAX
    package's voxelizer on two clouds, for one PFN kind."""
    from pillars_tpu.models.detector import PillarsDetector as JaxDetector
    from pillars_tpu.ops.voxelize import make_cell_voxelizer
    from torch_parity import d435i_clouds

    over = [("model.pfn.with_distance", with_distance)]
    if kind != "dense_cell":
        over += [("model.pfn.dense_cell", False),
                 ("model.pfn.pointwise", kind == "pointwise")]
    jcfg, tcfg = small_config(JaxConfig), small_config(TorchConfig)
    for key, value in over:
        jcfg, tcfg = jcfg.override(key, value), tcfg.override(key, value)
    pts, num = d435i_clouds(13, 2, jcfg.model.voxel.max_points, 1800)
    pts[:, :300, :2] = pts[:, :1, :2] + np.random.RandomState(13).uniform(
        0, 0.02, (2, 300, 2))  # a crowded cell: the cap of 50 points
    flat = lambda a: np.array(a).reshape((-1,) + a.shape[2:])  # noqa: E731
    if kind == "dense_cell":
        vcfg = jcfg.model.voxel
        nx, ny, nz = vcfg.grid_size
        cv = jax.device_get(jax.jit(make_cell_voxelizer(vcfg))(
            jnp.asarray(pts), jnp.asarray(num)))
        cell_global = np.asarray(cv.cell) + (np.arange(2) * nx * ny * nz
                                             )[:, None]
        return jcfg, tcfg, (flat(cv.points), flat(cv.cell), flat(cell_global),
                            flat(cv.kept), flat(cv.count), flat(cv.mean)), (
            int(np.sum(cv.num_pillars)), 2 * nx * ny * nz)
    v = jax.device_get(jax.jit(JaxDetector(jcfg).voxelize_batch)(
        jnp.asarray(pts), jnp.asarray(num)))
    if kind == "pointwise":
        p = v.pillar_mask.shape[1]
        pid = np.asarray(v.point_pillar) + (np.arange(2) * p)[:, None]
        return jcfg, tcfg, (flat(v.points), flat(pid), flat(v.point_kept),
                            flat(v.point_mean), flat(v.point_zyx),
                            flat(v.num_points), flat(v.pillar_mask)), ()
    return jcfg, tcfg, (flat(v.voxels), flat(v.num_points), flat(v.coords),
                        flat(v.pillar_mask)), ()


@pytest.mark.parametrize("kind,with_distance", [
    ("pointwise", False), ("dense_cell", False), ("dense", False),
    ("dense", True)])
def test_pfn_head(kind, with_distance):
    from pillars_torch.models import pfn as tpfn
    from pillars_tpu.models import pfn as jpfn

    jcfg, tcfg, args, extra = _pfn_inputs(kind, with_distance)
    name = {"pointwise": "PointwisePFN", "dense_cell": "DenseCellPFN",
            "dense": "PillarFeatureNet"}[kind]
    jargs = [jnp.asarray(a) for a in args]
    if kind == "dense_cell":
        jargs.append(jnp.asarray(extra[0]))
    static = {"n_cells_total": extra[1]} if kind == "dense_cell" else {}

    def make(dt):
        return getattr(jpfn, name)(jcfg.model, dtype=dt)

    variables = _random(make(None), 14, *jargs, train=False, **static)
    want, want_f32 = _both_dtypes(make, variables, *jargs, train=False,
                                  **static)
    pfn = getattr(tpfn, name)(tcfg.model, dtype=torch.bfloat16).eval()
    pfn.load_state_dict(convert_tree(variables["params"],
                                     variables["batch_stats"]))
    with torch.no_grad():
        got = pfn(*(torch.from_numpy(np.asarray(a)) for a in args),
                  *extra[1:])
    if kind == "dense_cell":
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        assert np.asarray(want[1]).max() == 50
        got, want, want_f32 = got[0], want[0], want_f32[0]
    head_criterion(got, want, want_f32,
                   f"{name}{' with_distance' if with_distance else ''}")


def test_dense_middle_head():
    from pillars_torch.models.middle import MiddleExtractor3D
    from pillars_tpu.models.middle import MiddleExtractor3D as JaxMiddle3D
    from test_torch_second import reduced

    jcfg, tcfg = (reduced(c, "second_d435i") for c in (JaxConfig, TorchConfig))
    grid = jnp.asarray(_bf16_valued(_rng_images(15, (2, 16, 6, 7, 16),
                                                relu=True)))

    def make(dt):
        return JaxMiddle3D(jcfg.model, dtype=dt)

    variables = _random(make(None), 15, grid, train=False)
    want, want_f32 = _both_dtypes(make, variables, grid, train=False)
    mid = _load(MiddleExtractor3D(tcfg.model, 16, dtype=torch.bfloat16),
                variables)
    with torch.no_grad():
        got = mid(torch.from_numpy(np.asarray(grid)).to(torch.bfloat16))
    head_criterion(got, want, want_f32, "MiddleExtractor3D")


def _random_state(tdet, seed):
    """A port state and the same values as a flax tree, random BN (the
    tree's structure from the port's init: flax's init of a SECOND config
    runs for minutes)."""
    from pillars_torch.weights import from_jax_variables, to_jax_variables

    params, stats = to_jax_variables(
        tdet.init(torch.Generator().manual_seed(seed)))
    variables = randomize_variables({"params": params, "batch_stats": stats},
                                    seed)
    return (from_jax_variables(variables["params"], variables["batch_stats"],
                               tdet.config), variables)


def test_sparse_middle_head():
    from pillars_torch.models.detector import PillarsDetector as TorchDetector
    from pillars_tpu.models.detector import PillarsDetector as JaxDetector
    from pillars_tpu.models.sparse_middle import SparseMiddleExtractor
    from test_torch_second import reduced
    from torch_parity import d435i_clouds

    jcfg, tcfg = (reduced(c, "second_sparse_d435i")
                  for c in (JaxConfig, TorchConfig))
    tdet = TorchDetector(tcfg.override("runtime.compute_dtype", "bfloat16"),
                         device="cpu")
    state, variables = _random_state(tdet, 16)
    pts, num = d435i_clouds(16, 2, 4096, 1500)
    v = jax.device_get(jax.jit(JaxDetector(jcfg).voxelize_batch)(
        jnp.asarray(pts), jnp.asarray(num)))
    args = (jnp.asarray(v.voxel_mean), jnp.asarray(v.coords),
            jnp.asarray(v.pillar_mask))
    sub = {"params": variables["params"]["middle"],
           "batch_stats": variables["batch_stats"]["middle"]}
    want, want_f32 = _both_dtypes(
        lambda dt: SparseMiddleExtractor(jcfg.model, dtype=dt), sub, *args,
        train=False)
    mid = tdet.network.middle
    mstate = {k[len("middle."):]: t for k, t in state.items()
              if k.startswith("middle.")}
    with torch.no_grad():
        got = torch.func.functional_call(
            mid, mstate, tuple(torch.from_numpy(np.asarray(a)) for a in args))
    head_criterion(got, want, want_f32, "SparseMiddleExtractor")


# ----------------------------------------------------------------------
# end to end


def _eye(b):
    rect = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    trv2c = rect.copy()
    trv2c[:, :3, 3] = [0.1, -0.2, 0.3]
    return rect, trv2c


def _bf16_config(cfg):
    return cfg.override("runtime.compute_dtype", "bfloat16")


def _end_to_end(jcfg, tcfg, state, variables, pts, num, label,
                fast_monkeypatch=None, full=False, box_rtol=None):
    """The heads under the head criterion (``full``: the whole-network
    factor), then the predictions matched as sets: the port in bfloat16
    against the JAX package in bfloat16 (and in float32 for the heads' gap).
    With ``full`` the JAX package compiled with XLA's default excess
    precision (conv outputs not rounded before their BN) must fail the same
    criterion on some head. Returns the borderline exceptions."""
    from pillars_torch.models.detector import PillarsDetector as TorchDetector
    from pillars_tpu.models.detector import PillarsDetector as JaxDetector
    from pillars_tpu.ops import rpn_pallas
    from torch_parity import compare_predictions_bf16

    jdet, jdet32 = JaxDetector(_bf16_config(jcfg)), JaxDetector(jcfg)
    tdet = TorchDetector(_bf16_config(tcfg), device="cpu")
    thr = jcfg.eval_input.anchor_area_threshold
    rect, trv2c = _eye(pts.shape[0])
    fast = fast_monkeypatch is not None
    if fast:
        fast_monkeypatch.setattr(
            rpn_pallas, "fused_rpn_blocks", functools.partial(
                rpn_pallas.fused_rpn_blocks, interpret=True))
        assert tdet.fast

    def heads(det):
        if det.dense_cell:
            return det._forward_dense(variables, pts, num, thr)[0]
        v = det.voxelize_batch(pts, num)
        return (det._forward_fast(variables, v) if fast
                else det.apply(variables, v))

    def predict(det):
        def run(p, n, r, t):
            if fast:
                v = det.voxelize_batch(p, n)
                amask = det.anchors_mask_batch(v.coords, v.pillar_mask, thr)
                return det.postprocess(det._forward_fast(variables, v),
                                       amask, r, t)
            return det.make_inference_fn()(variables, p, n, r, t)
        return jax.device_get(jit_strict(run)(pts, num, rect, trv2c))

    want = jax.device_get(jit_strict(lambda: heads(jdet))())
    want_f32 = jax.device_get(jit_strict(lambda: heads(jdet32))())
    tp, tn = torch.from_numpy(pts), torch.from_numpy(num)
    with torch.inference_mode():
        if tdet.dense_cell:
            got = tdet._forward_dense(state, tp, tn, thr)[0]
        else:
            v = tdet.voxelize_batch(tp, tn)
            got = (tdet._forward_fast if fast else tdet.apply)(state, v)
    factor = BF16_RMS_FACTOR_FULL if full else BF16_RMS_FACTOR
    heads_criterion(got, want, want_f32, label, factor)
    if full:
        loose = jax.device_get(jax.jit(lambda: heads(jdet))())
        ratios = {k: head_ratio(loose[k], want[k], want_f32[k]) for k in want}
        print(f"{label}: XLA's default excess precision, rms ratio {ratios}")
        assert max(ratios.values()) > factor, ratios
    got_p = tdet.make_inference_fn()(state, tp, tn, *map(torch.from_numpy,
                                                         (rect, trv2c)))
    pp = tcfg.model.postprocess
    return compare_predictions_bf16(
        predict(jdet), got_p, pp.nms_score_threshold, pp.nms_iou_threshold,
        label, **({} if box_rtol is None else {"box_rtol": box_rtol}))


REDUCED_PATHS = {
    "dense_cell": (),
    "point_major_apply": (("model.pfn.dense_cell", False),),
    "point_major_fast": (("model.pfn.dense_cell", False),
                         ("model.rpn.use_pallas_blocks", True)),
    "dense_layout": (("model.pfn.dense_cell", False),
                     ("model.pfn.pointwise", False)),
    "simple_voxel": (("model.pfn.dense_cell", False),
                     ("model.pfn.simple_mean", True)),
}


@pytest.mark.parametrize("path", sorted(REDUCED_PATHS) + [
    "second_sparse_d435i", "second_d435i"])
def test_inference_reduced_random_init(path, monkeypatch):
    """B=2, narrow widths, random weights."""
    from pillars_torch.models.detector import PillarsDetector as TorchDetector
    from test_torch_second import reduced
    from torch_parity import d435i_clouds

    if path.startswith("second"):
        jcfg, tcfg = (reduced(c, path) for c in (JaxConfig, TorchConfig))
        n = 1500
    else:
        jcfg, tcfg = small_config(JaxConfig), small_config(TorchConfig)
        for key, value in REDUCED_PATHS[path]:
            jcfg, tcfg = jcfg.override(key, value), tcfg.override(key, value)
        n = 1800
    state, variables = _random_state(TorchDetector(tcfg, device="cpu"), 17)
    pts, num = d435i_clouds(17, 2, jcfg.model.voxel.max_points, n)
    _end_to_end(jcfg, tcfg, state, variables, pts, num, path,
                monkeypatch if path == "point_major_fast" else None,
                box_rtol=BF16_BOX_RTOL_RANDOM_INIT)


WEIGHTS = str(ROOT / "benchmarks" / "hard_synth" / "weights_59.pkl")


@pytest.mark.parametrize("path", ["dense_cell", "point_major_fast"])
def test_inference_full_width_trained_weights(path, monkeypatch):
    """B=1 at ``Config.default()`` widths (4096-point pad) from the trained
    checkpoint: the dense cell, and the fast path with the JAX package's
    Pallas blocks in interpret mode. No borderline exception expected."""
    from pillars_torch.weights import from_jax_variables, load_params
    from pillars_tpu.train.checkpoint import load_params as jax_load_params
    from torch_parity import d435i_clouds

    jcfg = JaxConfig.default().override("model.voxel.max_points", 4096)
    tcfg = TorchConfig.default().override("model.voxel.max_points", 4096)
    if path == "point_major_fast":
        for key, value in REDUCED_PATHS[path]:
            jcfg, tcfg = jcfg.override(key, value), tcfg.override(key, value)
    params, stats = jax_load_params(WEIGHTS)
    state = from_jax_variables(*load_params(WEIGHTS), tcfg)
    pts, num = d435i_clouds(11, 1, 4096, 4000)
    exceptions = _end_to_end(
        jcfg, tcfg, state, {"params": params, "batch_stats": stats}, pts,
        num, f"{path} full width",
        monkeypatch if path == "point_major_fast" else None, full=True)
    assert exceptions == 0


def test_bucketed_inference_runs_bf16():
    """``BucketedInference`` builds every rung in the config's compute
    dtype: in bfloat16 a cloud gives, in each rung that holds it, the same
    bits as the fixed bfloat16 path of that rung's width (max_voxels 2048
    keeps every rung point-major), float32 predictions."""
    from pillars_torch.infer import BucketedInference
    from pillars_torch.models.detector import PillarsDetector as TorchDetector
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = _bf16_config(TorchConfig.default().override(
        "model.voxel.max_voxels", 2048).override("model.voxel.max_points",
                                                 4096))
    state = from_jax_variables(*load_params(WEIGHTS), cfg)
    r = np.random.RandomState(18)
    pts = np.zeros((1, 4096, 3), np.float32)
    pts[0, :1500] = np.stack([r.uniform(0.2, 6.2, 1500),
                              r.uniform(-2.4, 2.4, 1500),
                              r.uniform(-2.5, 0.5, 1500)], 1)
    num = np.array([1500], np.int32)
    eye = np.eye(4, dtype=np.float32)[None]
    bi = BucketedInference(cfg, buckets=[2048, 4096], device="cpu")
    got = bi(state, pts, num, eye, eye)
    assert bi.select_bucket(1500) == 2048
    want = TorchDetector(cfg.override("model.voxel.max_points", 2048),
                         device="cpu").make_inference_fn()(
        state, pts[:, :2048], num, eye, eye)
    assert got.scores.dtype == torch.float32 and bool(got.valid.any())
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name
