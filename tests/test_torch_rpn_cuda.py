"""The fused RPN block kernel (csrc/rpn_sep_block.cu) against its plain twin,
on the card.

Marked ``cuda``: these skip without a GPU. On a machine with a card and no
JAX run ``python -m pytest --noconftest tests/test_torch_rpn_cuda.py``
(``tests/conftest.py`` imports JAX).

Tolerance: max |kernel - twin| <= 1e-5 * max |twin|; the same f32 products
summed in another order (the kernel's FMAs, the twin's matmul).
"""

import numpy as np
import pytest
import torch

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
# edge, fewer channels than a tile, a single layer)
SHAPES = [
    (1, 64, 80, 128, 64, 3, 1), (2, 64, 80, 128, 64, 3, 1),
    (1, 64, 80, 64, 128, 5, 2), (2, 64, 80, 64, 128, 5, 2),
    (1, 32, 40, 128, 256, 5, 2), (2, 32, 40, 128, 256, 5, 2),
    (3, 10, 14, 8, 12, 2, 2), (1, 7, 9, 4, 20, 0, 1),
]


@pytest.mark.parametrize("b,h,w,cin,cout,n,stride", SHAPES)
def test_kernel_matches_plain(cuda_rpn, b, h, w, cin, cout, n, stride):
    from pillars_torch.ops.rpn_blocks import fused_sep_block_plain

    layers = _layers(b * 100 + n, cin, cout, n)
    x = torch.from_numpy(np.maximum(np.random.RandomState(b).randn(
        b, h, w, cin), 0).astype(np.float32)).cuda()
    before = cuda_rpn.fused_sep_block.launches
    got = cuda_rpn.fused_sep_block(x, layers, n, stride)
    torch.cuda.synchronize()
    assert cuda_rpn.fused_sep_block.launches == before + 1
    want = fused_sep_block_plain(x, layers, n, stride)
    assert got.shape == want.shape == (b, h // stride, w // stride, cout)
    scale = want.abs().max().item()
    assert scale > 0
    assert (got - want).abs().max().item() <= REL_TOL * scale


def test_fused_rpn_blocks_on_a_sliced_canvas(cuda_rpn):
    """The three blocks as the fast path runs them: a B=2 canvas that is a
    slice of a padded scatter buffer (not contiguous), kernel against the
    twin on the CPU, three launches."""
    from pillars_torch.config import Config
    from pillars_torch.models.rpn import RPN
    from pillars_torch.ops.rpn_blocks import fused_rpn_blocks

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
    before = cuda_rpn.fused_sep_block.launches
    got = fused_rpn_blocks(canvas.cuda(), {k: v.cuda() for k, v in
                                           state.items()}, mcfg.rpn)
    torch.cuda.synchronize()
    assert cuda_rpn.fused_sep_block.launches == before + 3
    for g, w in zip(got, want):
        scale = w.abs().max().item()
        assert scale > 0
        assert (g.cpu() - w).abs().max().item() <= REL_TOL * scale


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
