"""The eval PFN kernel (``csrc/pfn_max.cu``, ``ops/pfn_cuda.py::pfn_max``).

On the CPU: the modules' rule for taking the kernel (eval, float32, CUDA
tensors, no gradient wanted; ``BatchNorm.forward_relu``'s), under which a
CPU tensor, train mode, bfloat16 and a tensor that wants a gradient take the
modules' own computation and count no launch; the plain twin equal to the
modules' eval output bit for bit; what the kernel relies on from the
voxelizers; and the kernel's algorithm (warps of 32 points, a run per row,
an integer max on the float's bits into a zeroed output, the point-major
list of rows with non-finite values) emulated in NumPy on the twin's point
outputs, equal to the twin, non-finite values included.

On the card (marked ``cuda``; they skip without a GPU): the kernel against
the twin at kitti3's shape (M = 131,072, P = 12,000, N = 100: a pillar over
N points, clouds past the pillar cap), the d435i dense cell at B = 1 and
B = 8 with padding tails, F = 64 and 128, D = 3 and 4, an empty cloud,
non-finite point features, bit-equal launches, a captured graph reading
weights and BN values changed after its capture, one launch a replay of the
served detectors, and the wrapper's refusals. Tolerance: the kernel sums
the Linear in its own order (fma over D + 5 terms) against cuBLAS's: max
|kernel - twin| <= 1e-6 * max |twin|; the counts exactly. On a machine with
a card and no JAX: ``python -m pytest --noconftest
tests/test_torch_pfn_cuda.py``.
"""

import pathlib
import types

import numpy as np
import pytest
import torch

from pillars_torch.config import Config
from pillars_torch.models import pfn as pfn_mod
from pillars_torch.ops import pfn_cuda
from pillars_torch.ops.pfn_cuda import pfn_max, pfn_max_plain
from torch_parity import fast_config, pfn_case, pfn_clouds

ROOT = pathlib.Path(__file__).resolve().parent.parent
REL_TOL = 1e-6
NAN_BITS = 0x7FFFFFFF


def _kitti3(**overrides):
    """configs/kitti_3class.yaml at the benchmark's P = 12000, N = 100."""
    cfg = (Config.from_yaml(str(ROOT / "configs" / "kitti_3class.yaml"))
           .override("model.voxel.max_voxels", 12000)
           .override("model.voxel.max_points_per_voxel", 100))
    for key, value in overrides.items():
        cfg = cfg.override(f"model.{key}", value)
    return cfg.model


def _d435i(**overrides):
    cfg = Config.default()
    for key, value in overrides.items():
        cfg = cfg.override(f"model.{key}", value)
    return cfg.model


def _case(mcfg, dense, b, n, seed, clump=0, device="cpu"):
    pts, num = pfn_clouds(mcfg.voxel, mcfg.num_point_features, b, n, seed,
                          clump)
    return pfn_case(mcfg, torch.from_numpy(pts).to(device),
                    torch.from_numpy(num).to(device), dense, seed)


def _module_call(module, args, kwargs):
    """The module's forward on ``pfn_max``'s arguments."""
    points, mean, cell, row, kept = args[:5]
    if "count" in kwargs:
        occupied = torch.unique(row[kept]).numel()
        return module(points, cell, row, kept, kwargs["count"], mean,
                      args[-1], torch.tensor(occupied))
    return module(points, row, kept, mean, cell, kwargs["num_points"],
                  kwargs["pillar_mask"])


def _same(got, want):
    """Equal values (NaN equal to NaN, -0 to +0)."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


# small CPU cases: (label, model config, dense cell, batch, points, clump)
CPU_CASES = [
    ("kitti3_small", lambda: _kitti3(**{"voxel.max_points": 4096,
                                        "voxel.max_voxels": 1500}),
     False, 2, 3000, 150),
    ("kitti3_past_cap", lambda: _kitti3(**{"voxel.max_points": 4096,
                                           "voxel.max_voxels": 600}),
     False, 1, 4000, 0),
    ("d435i_fast", lambda: _d435i(**{"pfn.dense_cell": False,
                                     "voxel.max_points": 4096}),
     False, 2, 3500, 80),
    ("d435i_dense", lambda: _d435i(**{"voxel.max_points": 4096}),
     True, 2, 3500, 80),
    ("d435i_dense_d4_f64", lambda: _d435i(**{"voxel.max_points": 4096,
                                             "num_point_features": 4,
                                             "pfn.num_filters": 64}),
     True, 1, 3000, 0),
    ("empty", lambda: _d435i(**{"voxel.max_points": 1024}), True, 1, 0, 0),
]
CPU_IDS = [c[0] for c in CPU_CASES]


# ------------------------------------------------------------------- CPU
def _fake(is_cuda=True, dtype=torch.float32, requires_grad=False):
    return types.SimpleNamespace(is_cuda=is_cuda, dtype=dtype,
                                 requires_grad=requires_grad)


@pytest.mark.parametrize("mode,want", [
    ("eval_cuda", True), ("cpu", False), ("train", False),
    ("bfloat16", False), ("points_want_grad", False),
    ("weights_want_grad", False), ("weights_under_no_grad", True)])
def test_the_rule_for_taking_the_kernel(mode, want):
    module = pfn_mod.PointwisePFN(
        _d435i(**{"pfn.dense_cell": False}),
        dtype=torch.bfloat16 if mode == "bfloat16" else None).eval()
    module.train(mode == "train")
    points = _fake(is_cuda=mode != "cpu",
                   requires_grad=mode == "points_want_grad")
    if mode not in ("weights_want_grad", "weights_under_no_grad"):
        module.requires_grad_(False)
    with torch.set_grad_enabled(mode != "weights_under_no_grad"):
        assert pfn_mod._takes_kernel(module, points, _fake()) is want


@pytest.mark.parametrize("mode", ["eval", "train", "bfloat16",
                                  "requires_grad"])
@pytest.mark.parametrize("dense", [False, True], ids=["points", "cells"])
def test_modules_off_the_kernel_count_no_launch(dense, mode):
    mcfg = _d435i(**{"voxel.max_points": 2048,
                     "pfn.dense_cell": dense})
    module, args, kwargs = _case(mcfg, dense, 2, 1500, seed=3, clump=60)
    if mode == "bfloat16":
        bf16 = type(module)(mcfg, dtype=torch.bfloat16)
        bf16.load_state_dict(module.state_dict())
        module = bf16.eval()
    module.train(mode == "train")
    if mode == "requires_grad":
        args = (args[0].clone().requires_grad_(True),) + args[1:]
    before = pfn_cuda.pfn_max.launches
    with torch.set_grad_enabled(mode in ("train", "requires_grad")):
        out = _module_call(module, args, kwargs)
    feats = out[0] if dense else out
    assert pfn_cuda.pfn_max.launches == before
    assert feats.shape == (args[-1], mcfg.pfn.num_filters)
    assert bool(torch.isfinite(feats).all()) and bool((feats > 0).any())
    assert feats.requires_grad == (mode in ("train", "requires_grad"))


@pytest.mark.parametrize("case", CPU_CASES, ids=CPU_IDS)
def test_twin_is_the_modules_eval_output(case):
    _, make, dense, b, n, clump = case
    module, args, kwargs = _case(make(), dense, b, n, seed=5, clump=clump)
    before = pfn_cuda.pfn_max.launches
    with torch.no_grad():
        want = _module_call(module, args, kwargs)
    twin = pfn_max_plain(*args, **kwargs)
    wrapped = pfn_max(*args, **kwargs)  # a CPU tensor takes the twin
    assert pfn_cuda.pfn_max.launches == before
    for got in (twin, wrapped):
        for g, w in zip(got if dense else [got], want if dense else [want]):
            assert g.dtype == w.dtype and torch.equal(g, w)
    feats = want[0] if dense else want
    assert bool((feats > 0).any()) == (n > 0)


@pytest.mark.parametrize("case", CPU_CASES, ids=CPU_IDS)
def test_voxelizers_give_what_the_kernel_relies_on(case):
    """Rows non-decreasing over the points; every row that takes a value
    holds a kept point: point-major, ``pillar_mask`` is ``num_points > 0``
    and ``num_points`` counts the row's kept points; dense cell, every
    valid point of a cell carries the cell's kept count, at least 1."""
    _, make, dense, b, n, clump = case
    mcfg = make()
    _, args, kwargs = _case(mcfg, dense, b, n, seed=6, clump=clump)
    _, _, cell, row, kept = args[:5]
    rows = args[-1]
    assert bool((row[1:] >= row[:-1]).all())
    assert bool(((row[kept] >= 0) & (row[kept] < rows)).all())
    kept_per_row = torch.bincount(row[kept].long(), minlength=rows)
    if dense:
        count = kwargs["count"]
        valid = cell < int(np.prod(mcfg.voxel.grid_size))
        assert bool((count[valid] >= 1).all())
        per_row = torch.zeros(rows + 1, dtype=torch.int32).scatter_reduce(
            0, row[valid].long(), count[valid], "amax", include_self=False)
        assert torch.equal(per_row[row[valid].long()], count[valid])
        assert torch.equal(kept_per_row[row[valid].long()].int(),
                           count[valid])
    else:
        num_points, mask = kwargs["num_points"], kwargs["pillar_mask"]
        assert torch.equal(mask, num_points > 0)
        assert torch.equal(kept_per_row.int(), num_points)


def _emulate(args, kwargs):
    """The kernel's algorithm in NumPy on the twin's point outputs."""
    x, zero = (t.detach().numpy() for t in pfn_cuda.point_outputs(
        *args[:3], args[4], *args[5:12]))
    row, kept = args[3].numpy(), args[4].numpy()
    voxel, rows = args[11], args[12]
    n_max = voxel.max_points_per_voxel
    dense = "count" in kwargs
    out = np.zeros((rows, x.shape[1]), np.int32)
    counts = np.zeros(rows, np.int32)
    listed = []
    for w0 in range(0, len(row), 32):
        runs = []
        for i in np.flatnonzero(kept[w0:w0 + 32]) + w0:
            if runs and runs[-1][0] == row[i]:
                runs[-1][1].append(i)
            else:
                runs.append((row[i], [i]))
        for r, idx in runs:
            if not 0 <= r < rows:
                continue
            if dense:
                c = int(kwargs["count"][idx[0]])
                if c <= 0:
                    continue
                pad = c < n_max
            else:
                if not kwargs["pillar_mask"][r]:
                    continue
                pad = int(kwargs["num_points"][r]) < n_max
            v = np.maximum(np.float32(0), x[idx].max(axis=0))
            if pad:
                v = np.maximum(v, zero)
            bits = np.where(np.isnan(v), NAN_BITS, v.view(np.int32))
            out[r] = np.maximum(out[r], np.where(bits > 0, bits, 0))
            if dense:
                counts[r] = max(counts[r], c)
            elif not np.isfinite(v).all():
                listed.append(r)
    vals = out.view(np.float32)
    for r in listed:
        vals[r][~np.isfinite(vals[r])] = 0
    if dense:
        return torch.from_numpy(vals), torch.from_numpy(counts)
    return torch.from_numpy(vals)


def _poison(args, seed, kinds=("nan", "inf")):
    """A copy of the arguments with non-finite values in some kept points'
    features: a NaN or an infinity in the last column (intensity; z where
    D = 3, which leaves the cell alone) and in the pillar means."""
    r = np.random.RandomState(seed)
    points, mean = args[0].clone(), args[1].clone()
    idx = torch.nonzero(args[4]).flatten()
    pick = idx[torch.from_numpy(r.choice(len(idx), 6, replace=False))]
    for j, i in enumerate(pick.tolist()):
        value = float("nan") if kinds[j % len(kinds)] == "nan" else (
            float("inf") if j % 4 < 2 else float("-inf"))
        if j < 4:
            points[i, -1] = value
        else:
            mean[i, j % 3] = value
    return (points, mean) + args[2:]


@pytest.mark.parametrize("poisoned", [False, True], ids=["finite",
                                                         "non_finite"])
@pytest.mark.parametrize("case", CPU_CASES[:-1], ids=CPU_IDS[:-1])
def test_kernel_algorithm_emulated_equals_twin(case, poisoned):
    _, make, dense, b, n, clump = case
    _, args, kwargs = _case(make(), dense, b, n, seed=7, clump=clump)
    if poisoned:
        args = _poison(args, seed=8)
    want = pfn_max_plain(*args, **kwargs)
    got = _emulate(args, kwargs)
    for g, w in zip(got if dense else [got], want if dense else [want]):
        _same(g, w)
    feats = want[0] if dense else want
    if poisoned and dense:
        assert bool(torch.isnan(feats).any())
    elif poisoned:  # the point-major rule: a non-finite value is 0
        assert bool(torch.isfinite(feats).all())


def test_wrapper_takes_one_layout():
    _, args, kwargs = _case(_d435i(**{"voxel.max_points": 1024}), True, 1,
                            500, seed=9)
    with pytest.raises(ValueError):
        pfn_max(*args)
    with pytest.raises(ValueError):
        pfn_max(*args, count=kwargs["count"],
                num_points=kwargs["count"][:10])


def test_wrapper_rejects_an_unsupported_device():
    _, args, kwargs = _case(_d435i(**{"voxel.max_points": 1024}), True, 1,
                            500, seed=10)
    with pytest.raises(ValueError):
        pfn_max(args[0].to("meta"), *args[1:], **kwargs)


# ------------------------------------------------------------------ card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _check(args, kwargs):
    """The kernel against the twin on the card: one launch; features
    within REL_TOL of max |twin|, non-finite values where the twin's are;
    the dense cell's counts exact."""
    before = pfn_cuda.pfn_max.launches
    got = pfn_max(*args, **kwargs)
    torch.cuda.synchronize()
    assert pfn_cuda.pfn_max.launches == before + 1
    with torch.no_grad():
        want = pfn_max_plain(*args, **kwargs)
    dense = "count" in kwargs
    g, w = (got[0], want[0]) if dense else (got, want)
    assert g.shape == w.shape and g.dtype == torch.float32
    finite = torch.isfinite(w)
    assert torch.equal(torch.isfinite(g), finite)
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    assert torch.equal(g[~finite & ~torch.isnan(w)],
                       w[~finite & ~torch.isnan(w)])
    scale = float(w[finite].abs().max()) if bool(finite.any()) else 0.0
    err = float((g[finite] - w[finite]).abs().max()) if scale else 0.0
    assert err <= REL_TOL * scale, (err, scale)
    assert bool((g[finite] >= 0).all())
    if dense:
        assert got[1].dtype == torch.int32 and torch.equal(got[1], want[1])
    return got, want


CARD_CASES = {
    # kitti3: P = 12000, N = 100, M = 131072
    "kitti3_n10000_clump150": (_kitti3, False, 1, 10000, 150),
    "kitti3_past_cap_n15000": (_kitti3, False, 1, 15000, 0),
    "kitti3_far_past_cap_n60000": (_kitti3, False, 1, 60000, 150),
    "kitti3_b2": (_kitti3, False, 2, 15000, 150),
    # d435i dense cell, padding tails (19968 rows a sample)
    "d435i_dense_b1": (_d435i, True, 1, 19200, 120),
    "d435i_dense_b8": (_d435i, True, 8, 19200, 120),
    # d435i point-major (the fast path's PFN): D = 3, F = 128
    "d435i_points_b2": (lambda: _d435i(**{"pfn.dense_cell": False}),
                        False, 2, 19200, 120),
    # the other widths: D = 4 with F = 128, D = 3 with F = 64
    "kitti3_f128": (lambda: _kitti3(**{"pfn.num_filters": 128}), False, 1,
                    15000, 150),
    "d435i_dense_d4_f64": (lambda: _d435i(**{"num_point_features": 4,
                                             "pfn.num_filters": 64}),
                           True, 2, 19200, 120),
    "d435i_dense_f64": (lambda: _d435i(**{"pfn.num_filters": 64}), True, 1,
                        19200, 0),
    "kitti3_d3_f64": (lambda: _kitti3(**{"num_point_features": 3}), False,
                      1, 15000, 0),
    # empty clouds
    "kitti3_empty": (_kitti3, False, 1, 0, 0),
    "d435i_dense_empty": (_d435i, True, 2, 0, 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_twin(card, name):
    make, dense, b, n, clump = CARD_CASES[name]
    _, args, kwargs = _case(make(), dense, b, n, seed=11, clump=clump,
                            device=card)
    got, _ = _check(args, kwargs)
    feats = got[0] if dense else got
    assert bool((feats > 0).any()) == (n > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kitti3_b2", "d435i_dense_b8",
                                  "d435i_points_b2"])
def test_non_finite_point_features(card, name):
    """Each module's rule: point-major, a non-finite value of a row is 0;
    dense cell, NaN and infinity stay."""
    make, dense, b, n, clump = CARD_CASES[name]
    _, args, kwargs = _case(make(), dense, b, n, seed=12, clump=clump,
                            device=card)
    got, want = _check(_poison(args, seed=13), kwargs)
    feats = want[0] if dense else want
    assert bool(torch.isnan(feats).any()) == dense


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kitti3_b2", "d435i_dense_b8"])
def test_bit_equal_launches(card, name):
    make, dense, b, n, clump = CARD_CASES[name]
    _, args, kwargs = _case(make(), dense, b, n, seed=14, clump=clump,
                            device=card)
    first = pfn_max(*args, **kwargs)
    second = pfn_max(*args, **kwargs)
    for f, s in zip(first if dense else [first],
                    second if dense else [second]):
        assert torch.equal(f.view(torch.int32) if f.is_floating_point()
                           else f, s.view(torch.int32)
                           if s.is_floating_point() else s)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kitti3_n10000_clump150",
                                  "d435i_dense_b1"])
def test_captured_graph_reads_weights_changed_after_capture(card, name):
    make, dense, b, n, clump = CARD_CASES[name]
    _, args, kwargs = _case(make(), dense, b, n, seed=15, clump=clump,
                            device=card)
    pfn_max(*args, **kwargs)  # build and load outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = pfn_cuda.pfn_max.launches
    with torch.cuda.graph(graph):
        out = pfn_max(*args, **kwargs)
    graph.replay()
    torch.cuda.synchronize()
    assert pfn_cuda.pfn_max.launches == before + 1
    first = [t.clone() for t in (out if dense else [out])]
    _same(first[0], pfn_max(*args, **kwargs)[0] if dense
          else pfn_max(*args, **kwargs))
    # the Linear weight and the four BN vectors (args 5-9) changed in place
    g = torch.Generator(device=card).manual_seed(16)
    with torch.no_grad():
        for t in args[5:10]:
            t.mul_(1 + 0.1 * torch.rand(t.shape, generator=g, device=card))
    graph.replay()
    torch.cuda.synchronize()
    want = pfn_max(*args, **kwargs)
    for o, w in zip(out if dense else [out], want if dense else [want]):
        _same(o, w)
    assert not torch.equal(first[0], (out[0] if dense else out))


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["d435i_dense", "d435i_fast", "kitti3"])
def test_one_launch_a_replay(card, config):
    from pillars_torch.cuda_graph import CapturedInference
    from pillars_torch.models.detector import PillarsDetector

    if config == "kitti3":
        cfg = Config.from_yaml(str(ROOT / "configs" / "kitti_3class.yaml"))
    else:
        cfg = Config.default()
        if config == "d435i_fast":
            cfg = fast_config(cfg)
    det = PillarsDetector(cfg)
    state = det.init(torch.Generator().manual_seed(0))
    fn = det.make_inference_fn()
    assert isinstance(fn, CapturedInference)
    vcfg = cfg.model.voxel
    pts, num = pfn_clouds(vcfg, cfg.model.num_point_features, 2, 9000, 17)
    eye = torch.eye(4, device=card).expand(2, 4, 4).contiguous()
    args = [torch.from_numpy(pts).to(card), torch.from_numpy(num).to(card),
            eye, eye]
    fn(state, *args)                      # eager first call, then capture
    before = pfn_cuda.pfn_max.launches
    for _ in range(3):
        fn(state, *args)
    torch.cuda.synchronize()
    assert pfn_cuda.pfn_max.launches == before + 3


@pytest.mark.cuda
def test_wrapper_refusals(card, monkeypatch):
    make, dense, b, n, clump = CARD_CASES["d435i_dense_b1"]
    _, args, kwargs = _case(make(), dense, b, n, seed=18, device=card)
    points, mean, cell, row, kept = args[:5]
    rest = args[5:]
    with pytest.raises(TypeError):
        pfn_max(points.double(), *args[1:], **kwargs)
    with pytest.raises(TypeError):
        pfn_max(points, mean, cell, row.long(), kept, *rest, **kwargs)
    with pytest.raises(ValueError):
        pfn_max(points, mean, cell, row[:-1], kept, *rest, **kwargs)
    with pytest.raises(ValueError):
        pfn_max(points, mean.cpu(), cell, row, kept, *rest, **kwargs)
    wide = torch.zeros(257, points.shape[1] + 5, device=card)
    vec = torch.ones(257, device=card)
    with pytest.raises(ValueError):
        pfn_max(*args[:5], wide, vec, vec, vec, vec, *args[10:], **kwargs)
    deep = torch.zeros(points.shape[0], 5, device=card)
    with pytest.raises(ValueError):
        pfn_max(deep, *args[1:], **kwargs)
    # a reported launch error makes the wrapper raise and count nothing
    monkeypatch.setattr(pfn_cuda, "_fn", lambda: (lambda *a: 98))
    before = pfn_cuda.pfn_max.launches
    with pytest.raises(RuntimeError):
        pfn_max(*args, **kwargs)
    assert pfn_cuda.pfn_max.launches == before
