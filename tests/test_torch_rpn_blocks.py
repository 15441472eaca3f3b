"""The port's fused RPN blocks (pillars_torch/ops/rpn_blocks.py) and RPNTail
against pillars_tpu's on the CPU, on NumPy-seeded inputs and weights.

Tolerances: BN folding 1e-6 (the same f32 ops, rsqrt in another library).
The plain fused block against the Pallas kernel in interpret mode, and the
three blocks against the flax _Block chain: 1e-5 of the output's largest
magnitude (the same f32 products summed in another order; the JAX package
measured 1.5e-6 between its fused kernel and flax at |out| ~ 1). RPNTail:
1e-4 relative to the head's largest magnitude, as the RPN heads. The fold
cache and the chain wrapper against the uncached, block-by-block calls: bit
for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.rpn import RPNTail as TorchTail
from pillars_torch.ops import rpn_cuda
from pillars_torch.ops.rpn_blocks import (FoldedBlocksCache, FoldedLayer,
                                          fold_block_params,
                                          fused_rpn_blocks,
                                          fused_sep_block_plain, pack_block)
from pillars_torch.utils import tracing
from pillars_torch.weights import convert_tree
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.rpn import RPN as JaxRPN
from pillars_tpu.models.rpn import RPNTail as JaxTail
from pillars_tpu.models.rpn import _Block as JaxBlock
from pillars_tpu.ops import rpn_pallas
from torch_parity import randomize_variables, small_config

torch.set_num_threads(2)

REL_TOL = 1e-5


def _rpn_variables(seed):
    jcfg = small_config(JaxConfig)
    _, ny, nx = jcfg.model.feature_map_size
    rpn = JaxRPN(jcfg.model)
    init = rpn.init(jax.random.PRNGKey(seed),
                    jnp.zeros((1, ny, nx, jcfg.model.pfn.num_filters)), False)
    return jcfg, randomize_variables(jax.device_get(init), seed=seed)


def _random_layers(seed, cin, cout, n):
    r = np.random.RandomState(seed)
    out = []
    for i in range(n + 1):
        ci = cin if i == 0 else cout
        out.append((r.randn(3, 3, ci).astype(np.float32),
                    (r.randn(ci, cout) / np.sqrt(ci)).astype(np.float32),
                    (r.randn(cout) * 0.1).astype(np.float32)))
    return out


def _assert_rel_close(got, want, tol=REL_TOL):
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"max |diff| {err} > {tol} * {scale}"


@pytest.mark.parametrize("block", [1, 2, 3])
def test_fold_block_params(block):
    jcfg, variables = _rpn_variables(seed=block)
    rcfg = jcfg.model.rpn
    name = f"block{block}"
    n = rcfg.layer_nums[block - 1]
    want = rpn_pallas.fold_block_params(
        variables["params"][name], variables["batch_stats"][name], n,
        rcfg.bn_eps)
    state = convert_tree({"rpn": variables["params"]},
                         {"rpn": variables["batch_stats"]})
    got = fold_block_params(state, f"rpn.{name}", n, rcfg.bn_eps)
    assert len(got) == len(want) == n + 1
    for g, w in zip(got, want):
        for gt, wt in zip(g, w):
            assert gt.shape == wt.shape
            np.testing.assert_allclose(gt.numpy(), np.asarray(wt),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_sep_block_plain_matches_pallas(stride):
    b, h, w, cin, cout, n = 2, 10, 12, 8, 12, 2
    r = np.random.RandomState(stride)
    x = np.maximum(r.randn(b, h, w, cin), 0).astype(np.float32)
    raw = _random_layers(stride, cin, cout, n)
    jlayers = tuple(rpn_pallas.FoldedLayer(*map(jnp.asarray, t)) for t in raw)
    want = np.stack([np.asarray(rpn_pallas.fused_sep_block(
        jnp.asarray(x[i]), jlayers, n, stride, interpret=True))
        for i in range(b)])
    tlayers = [FoldedLayer(*map(torch.from_numpy, t)) for t in raw]
    got = fused_sep_block_plain(torch.from_numpy(x), tlayers, n, stride)
    assert got.shape == want.shape == (b, h // stride, w // stride, cout)
    _assert_rel_close(got.numpy(), want)


def test_stride2_keeps_even_centres():
    """One tap at a time: at stride 2, output (oy, ox) reads input
    (2*oy + dy - 1, 2*ox + dx - 1), zero outside. An odd-centre rule
    fails for every tap."""
    h, w, c = 6, 8, 4
    x = np.random.RandomState(0).uniform(1, 2, (1, h, w, c)).astype(
        np.float32)
    padded = np.pad(x[0], ((1, 1), (1, 1), (0, 0)))
    for dy in range(3):
        for dx in range(3):
            wd = np.zeros((3, 3, c), np.float32)
            wd[dy, dx] = 1.0
            layer = FoldedLayer(torch.from_numpy(wd), torch.eye(c),
                                torch.zeros(c))
            got = fused_sep_block_plain(torch.from_numpy(x), [layer], 0, 2)
            want = padded[dy:dy + h:2, dx:dx + w:2]
            np.testing.assert_array_equal(got[0].numpy(), want)


def test_fused_rpn_blocks_match_flax_blocks():
    jcfg, variables = _rpn_variables(seed=5)
    rcfg = jcfg.model.rpn
    _, ny, nx = jcfg.model.feature_map_size
    r = np.random.RandomState(5)
    canvas = np.maximum(r.randn(2, ny, nx, jcfg.model.pfn.num_filters), 0
                        ).astype(np.float32)
    x = jnp.asarray(canvas)
    want = []
    for i in range(3):
        name = f"block{i + 1}"
        blk = JaxBlock(rcfg.num_filters[i], rcfg.layer_nums[i],
                       rcfg.layer_strides[i], rcfg.bn_momentum, rcfg.bn_eps,
                       separable=True)
        x = blk.apply({"params": variables["params"][name],
                       "batch_stats": variables["batch_stats"][name]},
                      x, False)
        want.append(np.asarray(x))
    state = convert_tree({"rpn": variables["params"]},
                         {"rpn": variables["batch_stats"]})
    tcfg = small_config(TorchConfig)
    got = fused_rpn_blocks(torch.from_numpy(canvas), state, tcfg.model.rpn)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _assert_rel_close(g.numpy(), w)


def test_rpn_tail():
    jcfg, variables = _rpn_variables(seed=6)
    rcfg = jcfg.model.rpn
    _, ny, nx = jcfg.model.feature_map_size
    r = np.random.RandomState(6)
    blocks = []
    for i in range(3):
        s = int(np.prod(rcfg.layer_strides[:i + 1]))
        blocks.append(np.maximum(r.randn(2, ny // s, nx // s,
                                         rcfg.num_filters[i]), 0
                                 ).astype(np.float32))
    want = JaxTail(jcfg.model).apply(variables, *map(jnp.asarray, blocks),
                                     False)
    tail = TorchTail(small_config(TorchConfig).model)
    missing, unexpected = tail.load_state_dict(
        convert_tree(variables["params"], variables["batch_stats"]),
        strict=False)
    assert all(m.endswith("num_batches_tracked") for m in missing), missing
    assert all(k.startswith("block") for k in unexpected), unexpected
    with torch.no_grad():
        got = tail.eval()(*map(torch.from_numpy, blocks))
    assert set(got) == set(want)
    for key in want:
        w = np.asarray(want[key])
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)


def test_wrapper_takes_the_twin_on_the_cpu():
    raw = _random_layers(3, 8, 8, 1)
    layers = [FoldedLayer(*map(torch.from_numpy, t)) for t in raw]
    x = torch.from_numpy(np.random.RandomState(3).randn(1, 6, 8, 8)
                         .astype(np.float32))
    before = tracing.counters()["fused_sep_block.launches"]
    got = rpn_cuda.fused_sep_block(x, layers, 1, 2)
    assert tracing.counters()["fused_sep_block.launches"] == before
    assert torch.equal(got, fused_sep_block_plain(x, layers, 1, 2))


def test_plain_rejects_bad_arguments():
    raw = _random_layers(4, 4, 4, 0)
    layers = [FoldedLayer(*map(torch.from_numpy, t)) for t in raw]
    x = torch.zeros(1, 4, 4, 4)
    with pytest.raises(ValueError):
        fused_sep_block_plain(x, layers, 0, 3)
    with pytest.raises(ValueError):
        fused_sep_block_plain(x, layers, 1, 1)


def _small_state(seed):
    jcfg, variables = _rpn_variables(seed=seed)
    _, ny, nx = jcfg.model.feature_map_size
    state = convert_tree({"rpn": variables["params"]},
                         {"rpn": variables["batch_stats"]})
    canvas = torch.from_numpy(np.maximum(np.random.RandomState(seed).randn(
        2, ny, nx, jcfg.model.pfn.num_filters), 0).astype(np.float32))
    return state, canvas, small_config(TorchConfig).model.rpn


def _all_equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, want))


def test_fold_cache_folds_once_per_state():
    state, canvas, rcfg = _small_state(7)
    cache = FoldedBlocksCache()
    want = fused_rpn_blocks(canvas, state, rcfg)
    for _ in range(3):
        assert _all_equal(fused_rpn_blocks(canvas, state, rcfg, cache), want)
    assert cache.folds == 1
    # the same tensors under another dict are the same state
    assert _all_equal(fused_rpn_blocks(canvas, dict(state), rcfg, cache), want)
    assert cache.folds == 1


@pytest.mark.parametrize("key", [
    "rpn.block1.conv0.depthwise.weight", "rpn.block2.conv2.pointwise.weight",
    "rpn.block3.bn2.weight", "rpn.block3.bn0.bias",
    "rpn.block2.bn1.running_mean", "rpn.block1.bn1.running_var"])
@pytest.mark.parametrize("how", ["replaced", "in_place"])
def test_fold_cache_refolds_a_changed_state(key, how):
    state, canvas, rcfg = _small_state(8)
    cache = FoldedBlocksCache()
    before = fused_rpn_blocks(canvas, state, rcfg, cache)
    if how == "replaced":
        state = dict(state)
        state[key] = state[key] * 1.5
    else:
        state[key].mul_(1.5)
    after = fused_rpn_blocks(canvas, state, rcfg, cache)
    assert cache.folds == 2
    assert _all_equal(after, fused_rpn_blocks(canvas, state, rcfg))
    assert not torch.equal(after[-1], before[-1])
    assert _all_equal(fused_rpn_blocks(canvas, state, rcfg, cache), after)
    assert cache.folds == 2


def test_fold_cache_ignores_other_entries_and_follows_the_config():
    state, canvas, rcfg = _small_state(9)
    cache = FoldedBlocksCache()
    want = fused_rpn_blocks(canvas, state, rcfg, cache)
    other = next(k for k in state if k.startswith("rpn.deconv"))
    state[other].add_(1.0)  # not part of the blocks
    assert _all_equal(fused_rpn_blocks(canvas, state, rcfg, cache), want)
    assert cache.folds == 1
    eps2 = dataclasses.replace(rcfg, bn_eps=rcfg.bn_eps * 100)
    got = fused_rpn_blocks(canvas, state, eps2, cache)
    assert cache.folds == 2
    assert _all_equal(got, fused_rpn_blocks(canvas, state, eps2))
    assert not torch.equal(got[-1], want[-1])


def test_fold_cache_folds_inference_tensors_every_call():
    """Inference tensors carry no version counter, so a write in place
    could not be seen: such a state is never kept."""
    state, canvas, rcfg = _small_state(10)
    with torch.inference_mode():
        state = {k: v.clone() for k, v in state.items()}
        cache = FoldedBlocksCache()
        want = fused_rpn_blocks(canvas, state, rcfg)
        for n in (1, 2):
            assert _all_equal(fused_rpn_blocks(canvas, state, rcfg, cache),
                              want)
            assert cache.folds == n


def test_chain_on_the_cpu_is_the_twin_block_by_block():
    shapes = [(8, 12, 2, 1), (12, 8, 1, 2), (8, 16, 0, 2)]
    blocks = [pack_block([FoldedLayer(*map(torch.from_numpy, t))
                          for t in _random_layers(i, cin, cout, n)], n, s)
              for i, (cin, cout, n, s) in enumerate(shapes)]
    x = torch.from_numpy(np.random.RandomState(11).randn(2, 8, 12, 8)
                         .astype(np.float32))
    before = tracing.counters()["fused_sep_block.launches"]
    got = rpn_cuda.fused_sep_chain(x, blocks)
    assert tracing.counters()["fused_sep_block.launches"] == before
    assert [tuple(g.shape) for g in got] == [(2, 8, 12, 12), (2, 4, 6, 8),
                                             (2, 2, 3, 16)]
    for g, blk in zip(got, blocks):
        x = fused_sep_block_plain(x, blk.layers, blk.num_layers, blk.stride)
        assert torch.equal(g, x)
        assert (blk.cin, blk.cout) == (blk.layers[0].wp.shape)
        assert torch.equal(blk.packed, torch.cat(
            [t.reshape(-1) for layer in blk.layers for t in layer]))


@pytest.mark.parametrize("fault", ["too_few", "stride", "shape", "dtype"])
def test_pack_block_rejects_bad_layers(fault):
    layers = [FoldedLayer(*map(torch.from_numpy, t))
              for t in _random_layers(12, 8, 12, 1)]
    if fault == "too_few":
        with pytest.raises(ValueError):
            pack_block(layers[:1], 1, 1)
    elif fault == "stride":
        with pytest.raises(ValueError):
            pack_block(layers, 1, 3)
    elif fault == "shape":
        layers[1] = layers[1]._replace(wd=layers[1].wd[:, :, :8])
        with pytest.raises(ValueError):
            pack_block(layers, 1, 1)
    else:
        layers[0] = layers[0]._replace(bias=layers[0].bias.double())
        with pytest.raises(TypeError):
            pack_block(layers, 1, 1)


@pytest.mark.parametrize("stride", [1, 2])
def test_fused_sep_block_plain_bf16_matches_pallas(stride):
    """runtime.compute_dtype=bfloat16: a bfloat16 x in, every layer in f32
    from the f32 weights, the block's output rounded once to bfloat16, as
    the Pallas kernel (interpret mode) does. Both round the same f32 sums
    summed in another order: at most one bfloat16 step anywhere."""
    from torch_parity import bf16_steps

    b, h, w, cin, cout, n = 2, 10, 12, 8, 12, 2
    r = np.random.RandomState(10 + stride)
    x = jnp.asarray(np.maximum(r.randn(b, h, w, cin), 0).astype(
        np.float32)).astype(jnp.bfloat16)
    raw = _random_layers(10 + stride, cin, cout, n)
    jlayers = tuple(rpn_pallas.FoldedLayer(*map(jnp.asarray, t)) for t in raw)
    want = np.stack([np.asarray(rpn_pallas.fused_sep_block(
        x[i], jlayers, n, stride, interpret=True)) for i in range(b)])
    assert want.dtype.name == "bfloat16"
    tlayers = [FoldedLayer(*map(torch.from_numpy, t)) for t in raw]
    got = fused_sep_block_plain(
        torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16), tlayers, n, stride)
    assert got.dtype == torch.bfloat16
    assert got.shape == want.shape == (b, h // stride, w // stride, cout)
    steps = bf16_steps(got, want)
    print(f"stride {stride}: {(steps > 0).mean():.4f} of the elements differ")
    assert steps.max() <= 1


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_wrappers_reject_other_dtypes_before_a_launch(dtype):
    """float32 and bfloat16 only, on the CPU as on the card: the check
    comes before the twin and before any launch."""
    raw = _random_layers(5, 8, 8, 1)
    layers = [FoldedLayer(*map(torch.from_numpy, t)) for t in raw]
    x = torch.zeros(1, 6, 8, 8, dtype=dtype)
    before = tracing.counters()["fused_sep_block.launches"]
    with pytest.raises(TypeError):
        rpn_cuda.fused_sep_block(x, layers, 1, 1)
    with pytest.raises(TypeError):
        rpn_cuda.fused_sep_chain(x, [pack_block(layers, 1, 1)])
    assert tracing.counters()["fused_sep_block.launches"] == before


def test_bf16_chain_takes_the_twin_on_the_cpu():
    """A bfloat16 CPU canvas: the twin block by block, bfloat16 out, no
    launch counted."""
    raw = _random_layers(6, 8, 8, 1)
    layers = [FoldedLayer(*map(torch.from_numpy, t)) for t in raw]
    x = torch.from_numpy(np.random.RandomState(6).rand(1, 6, 8, 8).astype(
        np.float32)).to(torch.bfloat16)
    before = (tracing.counters()["fused_sep_block.launches"],
              tracing.counters()["fused_sep_block.launches_bf16"])
    got = rpn_cuda.fused_sep_chain(x, [pack_block(layers, 1, 2)] * 1)
    assert (tracing.counters()["fused_sep_block.launches"],
            tracing.counters()["fused_sep_block.launches_bf16"]) == before
    assert got[0].dtype == torch.bfloat16
    assert torch.equal(got[0], fused_sep_block_plain(x, layers, 1, 2))


# the ragged shapes at which tests/test_torch_rpn_cuda.py holds the
# bfloat16 kernel to this twin: channel counts that are not a multiple of 8
# and odd widths (b, h, w, cin, cout, n, stride)
RAGGED = [(2, 9, 11, 4, 8, 1, 1), (1, 10, 14, 12, 16, 2, 2),
          (3, 6, 10, 20, 20, 2, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,cin,cout,n,stride", RAGGED)
def test_fused_sep_block_plain_ragged_matches_pallas(b, h, w, cin, cout, n,
                                                     stride, dtype):
    """The twin against the Pallas kernel (interpret mode) at those shapes:
    float32 within REL_TOL of the max, bfloat16 at most one bfloat16 step
    apart (each rounds its f32 sums once)."""
    from torch_parity import bf16_steps

    r = np.random.RandomState(b * 100 + cin)
    x = jnp.asarray(np.maximum(r.randn(b, h, w, cin), 0).astype(
        np.float32)).astype(dtype)
    raw = _random_layers(b * 100 + cin, cin, cout, n)
    jlayers = tuple(rpn_pallas.FoldedLayer(*map(jnp.asarray, t)) for t in raw)
    want = np.stack([np.asarray(rpn_pallas.fused_sep_block(
        x[i], jlayers, n, stride, interpret=True)) for i in range(b)])
    tlayers = [FoldedLayer(*map(torch.from_numpy, t)) for t in raw]
    got = fused_sep_block_plain(
        torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            getattr(torch, dtype)), tlayers, n, stride)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == want.shape == (b, h // stride, w // stride, cout)
    if dtype == "float32":
        _assert_rel_close(got.numpy(), want)
    else:
        assert bf16_steps(got, want).max() <= 1
