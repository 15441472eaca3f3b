"""The RPN's eval 3x3 conv + BN + ReLU on the CPU: the wrapper's plain twin
(ops/conv_cuda.py) is what a plain block conv computed before, conv then
``BatchNorm.forward_relu``; the rule by which ``_Block`` calls take the
kernel (``_Block.takes_kernel``), with the wrapper replaced by a recording
stub; the wrapper's refusals; the launch counter declared at 0; and a NumPy
emulation of the kernel's tiles (csrc/conv3x3_bn_relu.cu: the patch with its
halo and zero fill, the weights' transposition, each thread's reads and
stores) against the twin. The kernel itself runs only on the card:
``tests/test_torch_conv_bn_relu_cuda.py``.
"""

import pathlib
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from pillars_torch.config import Config
from pillars_torch.models import layers, rpn
from pillars_torch.models.layers import BatchNorm, Conv2d
from pillars_torch.models.rpn import RPN, _Block
from pillars_torch.ops import conv_cuda
from pillars_torch.utils import tracing

ROOT = pathlib.Path(__file__).resolve().parent.parent
EPS = 1e-3

# kitti3's block convs: (C_in, C_out, stride)
SHAPES = [(64, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
          (256, 256, 1)]
# (B, H, W, padding): odd and even grids, the band path's padding
GRIDS = [(1, 7, 9, 1), (2, 8, 6, 1), (2, 9, 10, (0, 1)), (1, 6, 7, (0, 1))]


def _conv_bn(c_in, c_out, stride, seed=0, dtype=None):
    g = torch.Generator().manual_seed(seed)
    conv = Conv2d(c_in, c_out, 3, stride=stride, padding=1, dtype=dtype)
    bn = BatchNorm(c_out, EPS, 0.99, dtype=dtype)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g)
                          / (3 * c_in ** 0.5))
        bn.weight.copy_(torch.randn(c_out, generator=g))
        bn.bias.copy_(torch.randn(c_out, generator=g))
        bn.running_mean.copy_(torch.randn(c_out, generator=g) * 0.1)
        bn.running_var.copy_(torch.rand(c_out, generator=g) + 0.1)
    return conv.eval(), bn.eval()


def _bn_args(bn):
    return (bn.running_mean, bn.running_var, bn.weight.detach(),
            bn.bias.detach(), bn.eps)


@pytest.mark.parametrize("grid", GRIDS, ids=[f"b{b}_{h}x{w}_pad{p}"
                                             for b, h, w, p in GRIDS])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{i}to{o}_s{s}"
                                               for i, o, s in SHAPES])
def test_twin_is_the_module_path(shape, grid):
    c_in, c_out, stride = shape
    b, h, w, padding = grid
    conv, bn = _conv_bn(c_in, c_out, stride, seed=c_in + c_out)
    x = torch.randn((b, c_in, h, w), generator=torch.Generator()
                    .manual_seed(h * w))
    with torch.no_grad():
        want = bn.forward_relu(conv(x) if padding == 1
                               else conv(x, padding=padding))
        twin = conv_cuda.conv3x3_bn_relu_plain(
            x, conv.weight, *_bn_args(bn), stride=stride, padding=padding)
    assert torch.equal(twin, want)
    if stride != 1:  # stride 2 stays with cuDNN: the wrapper refuses it
        with pytest.raises(ValueError):
            conv_cuda.conv3x3_bn_relu(x, conv.weight, *_bn_args(bn),
                                      stride=stride, padding=padding)
        return
    before = tracing.counters()["conv3x3_bn_relu.launches"]
    with torch.no_grad():
        got = conv_cuda.conv3x3_bn_relu(x, conv.weight, *_bn_args(bn),
                                        stride=stride, padding=padding)
    assert torch.equal(got, want)
    assert tracing.counters()["conv3x3_bn_relu.launches"] == before


def _fake(is_cuda=True, dtype=torch.float32, requires_grad=False):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("mode,want", [
    ("eval_f32", [True] * 4), ("cpu", [False] * 4), ("train", [False] * 4),
    ("bf16", [False] * 4), ("x_wants_grad", [False] * 4),
    ("params_want_grad", [False] * 4), ("separable", [False] * 4),
    ("band_padding", [True] * 4), ("stride_2", [False] + [True] * 3)])
def test_the_rule_for_taking_the_kernel(mode, want):
    """A block of 4 convs: each takes the kernel in float32 eval on the
    card with no gradient wanted, at padding 1 or the band's (0, 1); a
    strided first conv does not."""
    dtype = torch.bfloat16 if mode == "bf16" else None
    block = _Block(64, 64, 3, 2 if mode == "stride_2" else 1, EPS,
                   mode == "separable", dtype=dtype)
    block.train(mode == "train")
    x = _fake(is_cuda=mode != "cpu", requires_grad=mode == "x_wants_grad")
    padding = (0, 1) if mode == "band_padding" else (1, 1)
    with torch.set_grad_enabled(mode in ("x_wants_grad",
                                         "params_want_grad")):
        if mode == "x_wants_grad":
            block.requires_grad_(False)
        got = [block.takes_kernel(i, x, padding) for i in range(4)]
    assert got == want


@pytest.mark.parametrize("form,want", [
    ({}, True), ({"stride": 2}, False), ({"padding": (0, 1)}, True),
    ({"c_out": 256, "c_in": 128}, True), ({"c_in": 8}, True),
    ({"groups": 64}, False), ({"k": 1}, False), ({"k": 5}, False),
    ({"dilation": 2}, False), ({"stride": 3}, False),
    ({"stride": (1, 2)}, False), ({"padding": 2}, False),
    ({"padding": (1, 0)}, False), ({"c_out": 96}, False),
    ({"c_out": 32}, False), ({"c_in": 12}, False)])
def test_the_forms_the_kernel_takes(form, want):
    f = {"c_out": 64, "c_in": 64, "k": 3, "stride": 1, "padding": 1,
         "groups": 1, "dilation": 1, **form}
    shape = (f["c_out"], f["c_in"] // f["groups"], f["k"], f["k"])
    assert conv_cuda.takes(shape, f["stride"], f["padding"], f["groups"],
                           f["dilation"]) is want
    # a module of that form, inside an eval float32 block on the card
    conv = Conv2d(f["c_in"], f["c_out"], f["k"], stride=f["stride"],
                  padding=f["padding"], groups=f["groups"],
                  dilation=f["dilation"])
    block = _Block(f["c_in"], f["c_out"], 0, 1, EPS, False).eval()
    block.conv0 = conv
    with torch.no_grad():
        assert block.takes_kernel(0, _fake(), conv.padding) is want


def _on_card(monkeypatch, calls):
    """A CPU run whose ``_Block`` calls see a CUDA tensor and whose kernel
    is a stub: it records each call and returns the twin, NCHW as the
    kernel does."""
    def as_cuda(x):
        return _fake(dtype=x.dtype, requires_grad=x.requires_grad)

    def takes(bn, x, *tensors):
        return layers.takes_kernel(bn, as_cuda(x), *tensors)

    def stub(x, weight, *args, **kwargs):
        calls.append({"x": x, "shape": tuple(weight.shape), **kwargs,
                      "args": args})
        return conv_cuda.conv3x3_bn_relu_plain(x, weight, *args,
                                               **kwargs).contiguous()

    monkeypatch.setattr(rpn, "takes_kernel", takes)
    monkeypatch.setattr(conv_cuda, "conv3x3_bn_relu", stub)


def _kitti3_rpn(seed=0, separable=False):
    cfg = Config.from_yaml(str(ROOT / "configs" / "kitti_3class.yaml"))
    cfg.model.rpn.use_separable_conv = separable
    net = RPN(cfg.model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if t.is_floating_point():
                if "running_var" in name:
                    t.copy_(torch.rand(t.shape, generator=g) + 0.5)
                elif "running_mean" in name:
                    t.zero_()
                else:
                    t.copy_(torch.randn(t.shape, generator=g)
                            * (0.05 if t.dim() == 4 else 0.5))
    return net.eval()


@pytest.mark.parametrize("mode", ["eval_f32", "train", "wants_grad",
                                  "separable"])
def test_block_calls_take_the_stub_by_the_rule(monkeypatch, mode):
    """kitti3's RPN at a small grid: in float32 eval its 14 stride-1 block
    convs call the kernel, its 2 strided ones stay with the library, and
    every head is as the library path computes it; otherwise none does."""
    net = _kitti3_rpn(separable=mode == "separable")
    net.train(mode == "train")
    canvas = torch.randn((2, 24, 20, 64),
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = net(canvas)
    calls = []
    _on_card(monkeypatch, calls)
    with torch.set_grad_enabled(mode == "wants_grad"):
        got = net(canvas)
    if mode != "eval_f32":
        assert calls == []
        return
    assert [c["shape"] for c in calls] == (
        [(64, 64, 3, 3)] * 4 + [(128, 128, 3, 3)] * 5
        + [(256, 256, 3, 3)] * 5)
    assert all(c["padding"] == (1, 1) and c["x"].is_contiguous()
               for c in calls)
    for k in want:
        assert got[k].shape == want[k].shape
        scale = float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k


def test_the_band_path_takes_the_stub(monkeypatch):
    """``halo`` (parallel/spatial.py): every conv pads along x only, and the
    kernel is asked for that padding."""
    net = _kitti3_rpn(seed=2)
    canvas = torch.randn((1, 16, 20, 64),
                         generator=torch.Generator().manual_seed(3))

    def halo(t):  # a band whose neighbours are zero
        z = torch.zeros_like(t[:, :, :1])
        return torch.cat([z, t, z], dim=2)

    with torch.no_grad():
        want = net(canvas, halo=halo)
        calls = []
        _on_card(monkeypatch, calls)
        got = net(canvas, halo=halo)
    assert len(calls) == 14
    assert all(c["padding"] == (0, 1) for c in calls)
    for k in want:
        scale = float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= 1e-5 * scale, k


@pytest.mark.parametrize("bad", [
    "weight_1x1", "c_out_96", "c_in_12", "channels_differ", "stride_2",
    "padding_2", "float64", "bn_vector_shape", "x_3d", "no_output",
    "meta_device"])
def test_wrapper_refusals(bad):
    x = torch.randn(1, 16, 6, 6)
    w = torch.randn(64, 16, 3, 3)
    vec = [torch.randn(64), torch.rand(64) + 0.1, torch.randn(64),
           torch.randn(64)]
    kw = {"stride": 1, "padding": 1}
    err = ValueError
    if bad == "weight_1x1":
        w = torch.randn(64, 16, 1, 1)
    elif bad == "c_out_96":
        w, vec = torch.randn(96, 16, 3, 3), [v.repeat(2)[:96] for v in vec]
    elif bad == "c_in_12":
        x, w = x[:, :12], w[:, :12]
    elif bad == "channels_differ":
        x = torch.randn(1, 24, 6, 6)
    elif bad == "stride_2":
        kw["stride"] = 2
    elif bad == "padding_2":
        kw["padding"] = 2
    elif bad == "float64":
        x, err = x.double(), TypeError
    elif bad == "bn_vector_shape":
        vec[2] = vec[2][:32]
    elif bad == "x_3d":
        x = x[0]
    elif bad == "no_output":
        x, kw["padding"] = torch.randn(1, 16, 2, 6), (0, 1)
    elif bad == "meta_device":
        x, w = x.to("meta"), w.to("meta")
        vec = [v.to("meta") for v in vec]
    with pytest.raises(err):
        conv_cuda.conv3x3_bn_relu(x, w, *vec, EPS, **kw)


def test_counter_declared_at_zero_on_import():
    code = ("from pillars_torch.ops import conv_cuda\n"
            "from pillars_torch.utils import tracing\n"
            "print(tracing.counters()['conv3x3_bn_relu.launches'])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "0"
    assert tracing.counters()["conv3x3_bn_relu.launches"] == 0


# ------------------------------------------------- the kernel, emulated
def tile_of(c_in, c_out):
    """The block tile csrc/conv3x3_bn_relu.cu takes for these widths: (TR,
    TC, CG, WN, WR, WC, KC)."""
    kc = 16 if c_in % 16 == 0 else 8
    return {64: (4, 8, 8, 1, 4, 2), 128: (4, 8, 8, 2, 2, 2),
            256: (4, 8, 8, 2, 4, 1)}[c_out] + (kc,)


def _emulate(x, w, vec, eps, pad_y, grid, order_seed=0):
    """The kernel's arithmetic in float64 NumPy, index for index: block
    tiles, the weights staged [TN][9 KC + 4] and laid out [tap][c][TN], the
    patch with its halo and zeros outside the image, each thread's reads,
    sums and stores;
    ``grid`` blocks, each with an equal share of the (tile, chunk)
    iterations, run in a random order: a tile shared among blocks is
    finished by the last to count in, from every block's partial sums in
    the order of the chunks. Every output must be written exactly once, and
    every counter left at 0."""
    n_b, c_in, h, w_ = x.shape
    c_out = w.shape[0]
    tr, tc, cg_n, wn_n, wr_n, wc_n, kc = tile_of(c_in, c_out)
    pg_n = 32 // cg_n
    nt = 32 * wn_n * wr_n * wc_n
    tn, br, bc = wn_n * tc * cg_n, tr * wr_n, 4 * pg_n * wc_n
    pr, pc = br + 2, bc + 2
    pcs = (pc + 3) // 4 * 4
    plane = pr * pcs
    ho, wo = h + 2 * pad_y - 2, w_
    xs = x.numpy().astype(np.float64)
    wf = w.numpy().astype(np.float64).reshape(-1)
    mean, var, gamma, beta = (v.numpy().astype(np.float64) for v in vec)
    out = np.full((n_b, c_out, ho, wo), np.nan)
    written = np.zeros(out.shape, np.int64)
    chunks, ntiles = c_in // kc, c_out // tn
    n_weights = 9 * kc * tn  # a chunk's


    tid = np.arange(nt)
    lane, warp = tid % 32, tid // 32
    wn_i, ws = warp % wn_n, warp // wn_n
    wr_i, wc_i = ws % wr_n, ws // wr_n
    cg, pg = lane // pg_n, lane % pg_n
    ty, tx = tr * wr_i, 4 * (pg + pg_n * wc_i)
    cb = wn_i * tc * cg_n + 4 * cg
    joff = np.array([0, 1, 2, 3] + [4 * cg_n + j for j in range(4)])[:tc]

    pe = np.arange(kc * pr * pc)
    c_e, rk = pe % pc, pe // pc
    r_e, k_e = rk % pr, rk // pr
    tiles_x, tiles_y = -(-wo // bc), -(-ho // br)
    tiles = tiles_x * tiles_y * n_b * ntiles
    iters = tiles * chunks
    grid = min(grid, iters)

    def first_of(b):
        return iters * b // grid

    def block_of(i):
        return ((i + 1) * grid + iters - 1) // iters - 1

    def tile_at(t):
        ntile, rest = t % ntiles, t // ntiles
        ox0, rest = rest % tiles_x * bc, rest // tiles_x
        return ntile, rest % tiles_y * br, ox0, rest // tiles_y

    def step(t, ch, acc):
        ntile, oy0, ox0, n = tile_at(t)
        iy, ix = oy0 - pad_y + r_e, ox0 - 1 + c_e
        inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w_)
        patch = np.full(kc * plane, np.nan)
        vals = np.zeros(len(pe))
        vals[inside] = xs[n, ch * kc + k_e[inside], iy[inside], ix[inside]]
        patch[k_e * plane + r_e * pcs + c_e] = vals
        row = 9 * kc + 4  # the staging's row: a channel's 9 KC values
        raw = np.full(tn * row, np.nan)
        o, q = np.divmod(np.arange(tn * 9 * kc // 4), 9 * kc // 4)
        for u in range(4):
            raw[o * row + 4 * q + u] = wf[(ntile * tn + o) * c_in * 9
                                          + ch * 9 * kc + 4 * q + u]
        wt = np.full(n_weights, np.nan)
        o, q = np.arange(tn * 9 * kc // 4) % tn, np.arange(
            tn * 9 * kc // 4) // tn
        for u in range(4):
            kt = 4 * q + u
            wt[((kt % 9) * kc + kt // 9) * tn + o] = raw[o * row + kt]
        pa = ty * pcs + tx
        for k in range(kc):
            for dy in range(3):
                for dx in range(3):
                    b = wt[(cb + ((dy * 3 + dx) * kc + k) * tn)[:, None]
                           + joff[None]]
                    for i in range(tr):
                        row = pa + k * plane + (i + dy) * pcs
                        a = patch[row[:, None] + np.arange(4)[None] + dx]
                        acc[:, i] += a[:, :, None] * b[:, None, :]

    def finish(t, acc):
        ntile, oy0, ox0, n = tile_at(t)
        ch_all = ntile * tn + cb[:, None] + joff[None]         # [nt, tc]
        scale = 1 / np.sqrt(var[ch_all] + eps) * gamma[ch_all]
        y = np.maximum((acc - mean[ch_all][:, None, None])
                       * scale[:, None, None] + beta[ch_all][:, None, None],
                       0)
        for i in range(tr):
            for p in range(4):
                oy, ox = oy0 + ty + i, ox0 + tx + p
                ok = (oy < ho) & (ox < wo)
                for j in range(tc):
                    out[n, ch_all[ok, j], oy[ok], ox[ok]] = y[ok, i, p, j]
                    np.add.at(written, (n, ch_all[ok, j], oy[ok], ox[ok]), 1)

    ws, counters = {}, np.zeros(tiles, np.int64)
    for blk in np.random.RandomState(order_seed).permutation(grid):
        begin, end = first_of(blk), first_of(blk + 1)
        c0 = begin % chunks
        acc = np.zeros((nt, tr, 4, tc))
        for it in range(begin, end):
            t, ch = divmod(it, chunks)
            step(t, ch, acc)
            if ch != chunks - 1 and it + 1 != end:
                continue
            whole = c0 == 0 and ch == chunks - 1
            c0 = 0
            if not whole:
                t_first = t * chunks
                b_first = block_of(t_first)
                segments = block_of(t_first + chunks - 1) - b_first + 1

                def slot(b):
                    return (b, 1 if first_of(b) < t_first else 0)

                ws[slot(blk)] = acc.copy()
                counters[t] += 1
                if counters[t] != segments:
                    acc[:] = 0
                    continue
                counters[t] = 0
                acc = ws[slot(b_first)].copy()
                for sgm in range(1, segments):
                    acc += ws[slot(b_first + sgm)]
            finish(t, acc)
            acc = np.zeros((nt, tr, 4, tc))
    assert (written == 1).all() and not counters.any()
    return out


# (C_in, C_out, padding along y, B, H, W, grid): kitti3's widths, C_in = 8
# (a chunk of 8 channels), grids from one block to more than iterations
EMULATED = [(16, 64, 1, 2, 19, 37, 5), (64, 64, 1, 1, 21, 35, 40),
            (8, 64, 0, 2, 13, 40, 3), (32, 64, 1, 1, 9, 9, 1000),
            (16, 128, 1, 2, 19, 37, 6), (128, 128, 1, 1, 9, 33, 50),
            (24, 128, 0, 1, 15, 20, 4), (16, 256, 1, 2, 19, 37, 13),
            (32, 256, 0, 1, 10, 17, 7), (8, 256, 1, 1, 8, 16, 1)]


@pytest.mark.parametrize("case", EMULATED, ids=[
    f"{ci}to{co}_pad{p}1_b{b}_{h}x{w}_g{g}"
    for ci, co, p, b, h, w, g in EMULATED])
def test_kernel_tiles_emulated_equal_twin(case):
    c_in, c_out, pad_y, b, h, w, grid = case
    g = torch.Generator().manual_seed(c_out + grid)
    x = torch.randn((b, c_in, h, w), generator=g)
    weight = torch.randn((c_out, c_in, 3, 3), generator=g) / (3 * c_in ** 0.5)
    vec = [torch.randn(c_out, generator=g) * 0.1,
           torch.rand(c_out, generator=g) + 0.1,
           torch.randn(c_out, generator=g), torch.randn(c_out, generator=g)]
    got = _emulate(x, weight, vec, EPS, pad_y, grid, order_seed=grid)
    want = conv_cuda.conv3x3_bn_relu_plain(
        x.double(), weight.double(), *[v.double() for v in vec], EPS, 1,
        (pad_y, 1)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
