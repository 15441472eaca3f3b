"""The fused RPN block kernel (csrc/rpn_sep_block.cu) against its plain twin,
on the card.

Marked ``cuda``: these skip without a GPU. On a machine with a card and no
JAX run ``python -m pytest --noconftest tests/test_torch_rpn_cuda.py``
(``tests/conftest.py`` imports JAX).

Tolerance: max |kernel - twin| <= 1e-5 * max |twin|; the same f32 products
summed in another order (the kernel's FMAs, the twin's matmul). bfloat16 in
and out: each rounds its f32 result once, so an element is within one
bfloat16 step of the twin's, or, near 0 where a step is finer than the f32
sums' own difference, within the same 1e-5 * max |twin|.
"""

import numpy as np
import pytest
import torch

from pillars_torch.utils import tracing

pytestmark = pytest.mark.cuda

REL_TOL = 1e-5


@pytest.fixture
def cuda_rpn():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from pillars_torch.ops import rpn_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    return rpn_cuda


def _layers(seed, cin, cout, n):
    from pillars_torch.ops.rpn_blocks import FoldedLayer

    r = np.random.RandomState(seed)
    out = []
    for i in range(n + 1):
        ci = cin if i == 0 else cout
        out.append(FoldedLayer(
            torch.from_numpy(r.randn(3, 3, ci).astype(np.float32)).cuda(),
            torch.from_numpy((r.randn(ci, cout) / np.sqrt(ci)).astype(
                np.float32)).cuda(),
            torch.from_numpy((r.randn(cout) * 0.1).astype(np.float32)).cuda()))
    return out


# the three d435i blocks, then small and ragged shapes (tiles cut at the
# edge, fewer channels than a tile, a single layer), block 3 at B=4 (two
# rows per tile), and output widths (48, 33) that no pixel tile (20 or 40)
# divides
SHAPES = [
    (1, 64, 80, 128, 64, 3, 1), (2, 64, 80, 128, 64, 3, 1),
    (1, 64, 80, 64, 128, 5, 2), (2, 64, 80, 64, 128, 5, 2),
    (1, 32, 40, 128, 256, 5, 2), (2, 32, 40, 128, 256, 5, 2),
    (3, 10, 14, 8, 12, 2, 2), (1, 7, 9, 4, 20, 0, 1),
    (4, 32, 40, 128, 256, 5, 2), (1, 37, 48, 64, 64, 2, 1),
    (1, 22, 66, 32, 128, 3, 2),
]


@pytest.mark.parametrize("b,h,w,cin,cout,n,stride", SHAPES)
def test_kernel_matches_plain(cuda_rpn, b, h, w, cin, cout, n, stride):
    from pillars_torch.ops.rpn_blocks import fused_sep_block_plain

    layers = _layers(b * 100 + n, cin, cout, n)
    x = torch.from_numpy(np.maximum(np.random.RandomState(b).randn(
        b, h, w, cin), 0).astype(np.float32)).cuda()
    before = tracing.counters()["fused_sep_block.launches"]
    got = cuda_rpn.fused_sep_block(x, layers, n, stride)
    torch.cuda.synchronize()
    assert tracing.counters()["fused_sep_block.launches"] == before + 1
    want = fused_sep_block_plain(x, layers, n, stride)
    assert got.shape == want.shape == (b, h // stride, w // stride, cout)
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= REL_TOL * scale


def test_chain_matches_single_blocks(cuda_rpn):
    """Three blocks in one launch give, bit for bit, what three launches of
    one block give (the same tiles and sums either way)."""
    from pillars_torch.ops.rpn_blocks import pack_block

    shapes = [(16, 8, 3, 1), (8, 16, 2, 2), (16, 32, 2, 2)]
    blocks = [pack_block(_layers(i, cin, cout, n), n, s)
              for i, (cin, cout, n, s) in enumerate(shapes)]
    x = torch.from_numpy(np.maximum(np.random.RandomState(7).randn(
        2, 12, 20, 16), 0).astype(np.float32)).cuda()
    before = tracing.counters()["fused_sep_block.launches"]
    got = cuda_rpn.fused_sep_chain(x, blocks)
    assert tracing.counters()["fused_sep_block.launches"] == before + 1
    y = x
    for g, blk in zip(got, blocks):
        y = cuda_rpn.fused_sep_block(y, blk.layers, blk.num_layers,
                                     blk.stride)
        assert torch.equal(g, y)
    assert tracing.counters()["fused_sep_block.launches"] == before + 4
    assert got[-1].shape == (2, 3, 5, 32)


def test_fused_rpn_blocks_on_a_sliced_canvas(cuda_rpn):
    """The three blocks as the fast path runs them: a B=2 canvas that is a
    slice of a padded scatter buffer (not contiguous), kernel against the
    twin on the CPU, one launch, with and without the fold cache."""
    from pillars_torch.config import Config
    from pillars_torch.models.rpn import RPN
    from pillars_torch.ops.rpn_blocks import (FoldedBlocksCache,
                                              fused_rpn_blocks)

    mcfg = Config.default().model
    _, ny, nx = mcfg.feature_map_size
    torch.manual_seed(0)
    rpn = RPN(mcfg)
    for m in rpn.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.1, 0.1)
            m.running_var.uniform_(0.5, 2.0)
    state = {f"rpn.{k}": v for k, v in rpn.state_dict().items()}
    padded = torch.relu(torch.randn(2, ny * nx + 1, mcfg.pfn.num_filters))
    canvas = padded[:, :ny * nx].reshape(2, ny, nx, -1)
    assert not canvas.is_contiguous()
    want = fused_rpn_blocks(canvas, state, mcfg.rpn)
    before = tracing.counters()["fused_sep_block.launches"]
    state_gpu = {k: v.cuda() for k, v in state.items()}
    got = fused_rpn_blocks(canvas.cuda(), state_gpu, mcfg.rpn)
    torch.cuda.synchronize()
    assert tracing.counters()["fused_sep_block.launches"] == before + 1
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert scale > 0
        assert (g.cpu() - w).abs().max().item() <= REL_TOL * scale
    cache = FoldedBlocksCache()
    for _ in range(2):
        cached = fused_rpn_blocks(canvas.cuda(), state_gpu, mcfg.rpn, cache)
        assert all(torch.equal(c, g) for c, g in zip(cached, got))
    assert cache.folds == 1


def test_kernel_rejects_bad_inputs(cuda_rpn):
    layers = _layers(0, 8, 8, 1)
    x = torch.zeros(1, 6, 8, 8, device="cuda")
    with pytest.raises(ValueError):  # odd H at stride 2
        cuda_rpn.fused_sep_block(torch.zeros(1, 5, 8, 8, device="cuda"),
                                 layers, 1, 2)
    with pytest.raises(TypeError):
        cuda_rpn.fused_sep_block(x.double(), layers, 1, 1)
    with pytest.raises(ValueError):  # not contiguous
        cuda_rpn.fused_sep_block(x.transpose(1, 2), layers, 1, 1)
    with pytest.raises(ValueError):  # one layer too few
        cuda_rpn.fused_sep_block(x, layers[:1], 1, 1)
    with pytest.raises(ValueError):  # channels not a multiple of 4
        cuda_rpn.fused_sep_block(torch.zeros(1, 6, 8, 6, device="cuda"),
                                 _layers(1, 6, 8, 0), 0, 1)


# the bfloat16 kernel's own cases besides: channel counts that are not a
# multiple of 8 (C_in 4, 12, 20; C_out 20 in every layer), odd and ragged
# pixel tiles, and B = 8 at the three d435i block shapes (several tiles per
# CTA, channel tiles changing between them)
BF16_SHAPES = SHAPES + [
    (2, 9, 11, 4, 8, 1, 1), (1, 10, 14, 12, 16, 2, 2),
    (3, 6, 10, 20, 20, 2, 1), (8, 64, 80, 128, 64, 3, 1),
    (8, 64, 80, 64, 128, 5, 2), (8, 32, 40, 128, 256, 5, 2),
]


# bfloat16 in and out, float32 inside each block: kernel and twin round
# float32 results that agree within REL_TOL of their max once each
@pytest.mark.parametrize("b,h,w,cin,cout,n,stride", BF16_SHAPES)
def test_bf16_kernel_matches_plain(cuda_rpn, b, h, w, cin, cout, n, stride):
    from pillars_torch.ops.rpn_blocks import fused_sep_block_plain
    from torch_parity import bf16_rounded_close

    layers = _layers(b * 100 + n, cin, cout, n)
    x = torch.from_numpy(np.maximum(np.random.RandomState(b).randn(
        b, h, w, cin), 0).astype(np.float32)).cuda().to(torch.bfloat16)
    before = tracing.counters()
    got = cuda_rpn.fused_sep_block(x, layers, n, stride)
    torch.cuda.synchronize()
    after = tracing.counters()
    for name in ("fused_sep_block.launches", "fused_sep_block.launches_bf16"):
        assert after[name] == before[name] + 1
    want = fused_sep_block_plain(x, layers, n, stride)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape == (b, h // stride, w // stride, cout)
    bf16_rounded_close(got, want, REL_TOL, f"bf16 {b}x{h}x{w}x{cin}->{cout}")


def test_bf16_chain_matches_single_blocks(cuda_rpn):
    """Three bfloat16 blocks in one launch give, bit for bit, what three
    launches of one block give (each block reads the bfloat16 output of
    the one before)."""
    from pillars_torch.ops.rpn_blocks import pack_block

    shapes = [(16, 8, 3, 1), (8, 16, 2, 2), (16, 32, 2, 2)]
    blocks = [pack_block(_layers(i, cin, cout, n), n, s)
              for i, (cin, cout, n, s) in enumerate(shapes)]
    x = torch.from_numpy(np.maximum(np.random.RandomState(7).randn(
        2, 12, 20, 16), 0).astype(np.float32)).cuda().to(torch.bfloat16)
    got = cuda_rpn.fused_sep_chain(x, blocks)
    y = x
    for g, blk in zip(got, blocks):
        y = cuda_rpn.fused_sep_block(y, blk.layers, blk.num_layers,
                                     blk.stride)
        assert g.dtype == torch.bfloat16 and torch.equal(g, y)


def test_bf16_fused_rpn_blocks_against_the_cpu(cuda_rpn):
    """The three blocks as the bfloat16 fast path runs them, the kernel on
    a bfloat16 canvas in one launch against the twin on the CPU, each block
    fed what the kernel's block before it wrote (a flipped rounding in one
    block moves the next block's sums by more than a step where they are
    near 0): each block within one bfloat16 step or 1e-5 of the max."""
    from pillars_torch.config import Config
    from pillars_torch.models.rpn import RPN
    from pillars_torch.ops.rpn_blocks import (fold_rpn_blocks,
                                              fused_rpn_blocks,
                                              fused_sep_block_plain)
    from torch_parity import bf16_rounded_close

    mcfg = Config.default().model
    _, ny, nx = mcfg.feature_map_size
    torch.manual_seed(1)
    state = {f"rpn.{k}": v for k, v in RPN(mcfg).state_dict().items()}
    for k in state:
        if k.endswith("running_var"):
            state[k] = torch.rand_like(state[k]) + 0.5
        elif k.endswith("wise.weight"):  # activations of O(1) to the end
            state[k] = state[k] * 2
    canvas = torch.relu(torch.randn(2, ny, nx, mcfg.pfn.num_filters)).to(
        torch.bfloat16)
    before = tracing.counters()["fused_sep_block.launches_bf16"]
    got = fused_rpn_blocks(canvas.cuda(),
                           {k: v.cuda() for k, v in state.items()}, mcfg.rpn)
    torch.cuda.synchronize()
    assert tracing.counters()["fused_sep_block.launches_bf16"] == before + 1
    x = canvas
    for g, blk in zip(got, fold_rpn_blocks(state, mcfg.rpn)):
        w = fused_sep_block_plain(x, blk.layers, blk.num_layers, blk.stride)
        assert g.dtype == w.dtype == torch.bfloat16
        bf16_rounded_close(g, w, REL_TOL, f"block {tuple(g.shape)}")
        x = g.cpu()


def test_kernel_rejects_other_dtypes(cuda_rpn):
    layers = _layers(0, 8, 8, 1)
    for dtype in (torch.float16, torch.float64):
        x = torch.zeros(1, 6, 8, 8, device="cuda", dtype=dtype)
        before = tracing.counters()["fused_sep_block.launches"]
        with pytest.raises(TypeError):
            cuda_rpn.fused_sep_block(x, layers, 1, 1)
        with pytest.raises(TypeError):
            cuda_rpn.fused_sep_chain(x, [])
        assert tracing.counters()["fused_sep_block.launches"] == before
