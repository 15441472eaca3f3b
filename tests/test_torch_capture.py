"""The captured inference of the port (pillars_torch/cuda_graph.py), the
counterpart of the JAX package's ``jax.jit`` for inference.

On the CPU, where nothing can be captured:

- sync-free: the eager inference body (``PillarsDetector._infer``) of every
  single-process inference config at reduced width, under a dispatch mode
  that fails on any op that makes the host wait for the card or has a
  data-dependent shape (``_local_scalar_dense`` and ``item``, ``nonzero``,
  ``masked_select``, ``unique*``, ``bincount``, ``repeat_interleave``,
  ``equal``, ``is_nonzero``, boolean-mask indexing) and on a tensor made
  from host data (``lift_fresh``: a host-to-device copy on every call, which
  a graph cannot hold). The body runs once before the check, as the card's
  first call runs it before the capture (``device_constant`` keeps its
  constants from then on). Excluded by name, because it never runs on the
  card: ``keep_mask_plain`` (the NMS kernel's twin);
- parity: ``CapturedInference`` with a stand-in for the graph that reruns
  the captured function into the same static outputs (the capture-shaped
  body: static inputs in, static packed outputs out, cloned per call)
  against the JAX package's ``make_inference_fn`` on the same seeded NumPy
  inputs and weights, on the dense-cell and the fast config, under
  ``tests/torch_parity.py``'s tolerances (valid and labels equal, scores
  1e-5, boxes 1e-4 + 2e-5 relative);
- the state key: a new dict of new tensors, one new tensor, an in-place
  write and a state of inference tensors each copy the state into the
  static tensors and refold the fast path's blocks in place; the same
  tensors do not;
- through the wrapper: replays follow every state swap, and call n's
  predictions outlive call n+1;
- counters: with a stand-in graph whose replay runs nothing, a capture
  leaves the counters as they were and each replay adds what its body
  counted on the capturing thread, and nothing that another thread counted.

Marked ``cuda`` (skip here): replay against eager on the card, the state
swap and the outputs of call n after call n+1. Run them on a machine with a
card and no JAX with ``python -m pytest --noconftest
tests/test_torch_capture.py -m cuda``.
"""

import functools
import pathlib
import threading
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from pillars_torch import cuda_graph
from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector as TorchDetector
from pillars_torch.models.detector import Predictions
from pillars_torch.utils import tracing
from torch_parity import (SMALL_OVERRIDES, compare_predictions,
                          d435i_clouds, fast_config, small_config)

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parent.parent
WEIGHTS = str(ROOT / "benchmarks" / "hard_synth" / "weights_59.pkl")

# ops that make the host wait for the card or give a data-dependent shape,
# and lift_fresh: a tensor made from host data inside the body
SYNC_OPS = {"_local_scalar_dense", "item", "nonzero", "masked_select",
            "_unique", "_unique2", "unique_dim", "unique_consecutive",
            "bincount", "repeat_interleave", "equal", "is_nonzero",
            "lift_fresh"}
INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}
# functions that run only for CPU tensors: the NMS kernel's plain twin
CPU_ONLY = {"keep_mask_plain"}


class _SyncCheck(TorchDispatchMode):
    """Records every op of ``SYNC_OPS`` and every boolean-mask index, with
    the port's line that issued it, outside the ``CPU_ONLY`` functions."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        bad = name in SYNC_OPS or (name in INDEX_OPS and any(
            isinstance(i, torch.Tensor) and i.dtype in (torch.bool,
                                                        torch.uint8)
            for i in args[1] if i is not None))
        if bad:
            frames = [f for f in traceback.extract_stack()
                      if "pillars_torch" in f.filename]
            if not any(f.name in CPU_ONLY for f in frames):
                where = frames[-1] if frames else None
                self.found.append(
                    (name, f"{where.filename}:{where.lineno}" if where
                     else "?"))
        return func(*args, **(kwargs or {}))


def _reduced_second(name):
    from test_torch_second import reduced

    return reduced(TorchConfig, name)


def _kitti_second():
    cfg = TorchConfig.from_yaml(str(ROOT / "configs" / "kitti_second.yaml"))
    for key, value in (("model.voxel.max_points", 4096),
                       ("model.voxel.max_voxels", 2000),
                       ("model.middle.max_active", 2000),
                       ("model.middle.num_filters", [8, 8, 16]),
                       ("model.rpn.layer_nums", [1, 1, 1]),
                       ("model.rpn.num_filters", [8, 8, 8]),
                       ("model.rpn.num_upsample_filters", [8, 8, 8])):
        cfg = cfg.override(key, value)
    return cfg


def _kitti_3class():
    from test_torch_kitti_scale import REDUCED

    cfg = TorchConfig.from_yaml(str(ROOT / "configs" / "kitti_3class.yaml"))
    for key, value in REDUCED:
        cfg = cfg.override(key, value)
    return cfg


def _bf16(cfg):
    return cfg.override("runtime.compute_dtype", "bfloat16")


def _transfer_learning():
    """configs/transfer_learning.yaml (its train body differentiates only
    the leaves that ``freeze_patterns`` leaves trainable)."""
    cfg = TorchConfig.from_yaml(str(ROOT / "configs"
                                    / "transfer_learning.yaml"))
    for key, value in SMALL_OVERRIDES:
        cfg = cfg.override(key, value)
    return cfg


# every single-process inference config, at the widths of the other tests
CONFIGS = {
    "dense_cell": lambda: small_config(TorchConfig),
    "point_major_fast": lambda: fast_config(small_config(TorchConfig)),
    "dense_cell_bf16": lambda: _bf16(small_config(TorchConfig)),
    "point_major_fast_bf16": lambda: _bf16(fast_config(
        small_config(TorchConfig))),
    "second_sparse_d435i": lambda: _reduced_second("second_sparse_d435i"),
    "second_sparse_d435i_bf16": lambda: _bf16(_reduced_second(
        "second_sparse_d435i")),
    "second_d435i": lambda: _reduced_second("second_d435i"),
    "kitti_second": _kitti_second,
    "kitti_3class": _kitti_3class,
    "transfer_learning": _transfer_learning,
}


def _clouds(cfg, b, seed):
    """``b`` clouds in the config's point range, with its point features."""
    r = np.random.RandomState(seed)
    lo, hi = np.asarray(cfg.model.voxel.point_cloud_range, np.float32
                        ).reshape(2, 3)
    maxpts, d = cfg.model.voxel.max_points, cfg.model.num_point_features
    n = min(1500, maxpts)
    pts = np.zeros((b, maxpts, d), np.float32)
    pts[:, :n, :3] = r.uniform(lo, hi, (b, n, 3))
    if d > 3:
        pts[:, :n, 3:] = r.uniform(0, 1, (b, n, d - 3))
    num = np.asarray([n, n - 100][:b], np.int32)
    eye = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    return tuple(map(torch.from_numpy, (pts, num, eye, eye)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_inference_body_is_sync_free(name):
    cfg = CONFIGS[name]()
    det = TorchDetector(cfg, device="cpu")
    state = det.init(torch.Generator().manual_seed(0))
    args = _clouds(cfg, 2, seed=1)
    thr = cfg.eval_input.anchor_area_threshold
    with torch.inference_mode():
        want = det._infer(state, *args, thr)  # the first call, eager
        check = _SyncCheck()
        with check:
            got = det._infer(state, *args, thr)
    assert not check.found, check.found
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ----------------------------------------------------------------------
# the wrapper on the CPU, with a stand-in for the graph


class _RerunGraph:
    """Replays by running the captured function again into the static
    outputs the capture returned."""

    def __init__(self, run, packed):
        self.run, self.packed, self.replays = run, packed, 0

    def replay(self):
        self.packed.copy_(self.run()[1])
        self.replays += 1


def _rerun_capture(run):
    out = run()
    return _RerunGraph(run, out[1]), out


@pytest.fixture
def rerun_graphs(monkeypatch):
    monkeypatch.setattr(cuda_graph, "_capture_graph", _rerun_capture)
    monkeypatch.setattr(cuda_graph, "_run_on_side_stream",
                        lambda run, device: run())


def _captured(det, thr=None):
    """A ``CapturedInference`` of a CPU detector, as the card's detector
    builds it, with its eager function."""
    thr = (det.config.eval_input.anchor_area_threshold if thr is None
           else thr)
    eager = det.make_inference_fn(thr)
    st = cuda_graph.StaticState()
    return cuda_graph.CapturedInference(
        functools.partial(det._infer, thr=thr, folded=st), eager, st,
        "cpu", Predictions)


def _random_state(tcfg, seed):
    from pillars_torch.weights import from_jax_variables, to_jax_variables
    from torch_parity import randomize_variables

    tdet = TorchDetector(tcfg, device="cpu")
    params, stats = to_jax_variables(tdet.init(
        torch.Generator().manual_seed(seed)))
    variables = randomize_variables({"params": params, "batch_stats": stats},
                                    seed)
    return (from_jax_variables(variables["params"], variables["batch_stats"],
                               tcfg), variables)


def _jax_predictions(path, variables, args, monkeypatch):
    import jax

    from pillars_tpu.config import Config as JaxConfig
    from pillars_tpu.models.detector import PillarsDetector as JaxDetector
    from pillars_tpu.ops import rpn_pallas

    jcfg = small_config(JaxConfig)
    if path == "point_major_fast":
        jcfg = fast_config(jcfg)
        monkeypatch.setattr(rpn_pallas, "fused_rpn_blocks", functools.partial(
            rpn_pallas.fused_rpn_blocks, interpret=True))
    det = JaxDetector(jcfg)
    thr = jcfg.eval_input.anchor_area_threshold

    @jax.jit
    def run(p, n, r, t):
        if path == "dense_cell":
            return det.make_inference_fn()(variables, p, n, r, t)
        v = det.voxelize_batch(p, n)
        amask = det.anchors_mask_batch(v.coords, v.pillar_mask, thr)
        return det.postprocess(det._forward_fast(variables, v), amask, r, t)

    return jax.device_get(run(*(a.numpy() for a in args)))


@pytest.mark.parametrize("path", ["dense_cell", "point_major_fast"])
def test_capture_shaped_body_matches_jax(path, rerun_graphs, monkeypatch):
    tcfg = CONFIGS[path]()
    state, variables = _random_state(tcfg, 21)
    det = TorchDetector(tcfg, device="cpu")
    fn = _captured(det)
    for b in (1, 2):
        args = _clouds_d435i(b, tcfg.model.voxel.max_points, seed=30 + b)
        want = _jax_predictions(path, variables, args, monkeypatch)
        first = fn(state, *args)  # the eager first call, then the capture
        replayed = fn(state, *args)
        assert fn.graphs[tuple(tuple(a.shape) for a in args)].graph.replays \
            == 1
        compare_predictions(want, replayed)
        for g, w in zip(replayed, first):
            assert torch.equal(g, w)


def _clouds_d435i(b, maxpts, seed):
    pts, num = d435i_clouds(seed, b, maxpts, 1800)
    rect = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    trv2c = rect.copy()
    trv2c[:, :3, 3] = [0.1, -0.2, 0.3]
    return tuple(map(torch.from_numpy, (pts, num, rect, trv2c)))


def _fast_state():
    tcfg = CONFIGS["point_major_fast"]()
    return tcfg, _random_state(tcfg, 22)[0]


def test_state_key_copies_and_refolds_in_place():
    from pillars_torch.ops.rpn_blocks import fold_rpn_blocks

    tcfg, state = _fast_state()
    rpn = tcfg.model.rpn
    st = cuda_graph.StaticState()

    def load(s):
        with torch.inference_mode():  # as the wrapper calls it
            st.load(s, "cpu")

    def packed():
        with torch.inference_mode():
            return [b.packed for b in st.blocks(st.tensors, rpn)]

    load(state)
    ptrs = [p.data_ptr() for p in packed()]

    def expect(want_state, copies):
        """``copies`` copies so far; the static tensors and the static
        blocks hold ``want_state`` and its fold, the blocks where the first
        fold put them."""
        assert st.copies == copies
        for k, t in want_state.items():
            assert torch.equal(st.tensors[k], t), k
        with torch.no_grad():
            fresh = fold_rpn_blocks(want_state, rpn)
        for got, want in zip(packed(), fresh):
            assert torch.equal(got, want.packed)
        assert [p.data_ptr() for p in packed()] == ptrs

    load(state)
    load(dict(state))  # a new dict of the same tensors
    expect(state, 1)
    other = {k: v * 1.5 if v.is_floating_point() else v.clone()
             for k, v in state.items()}
    load(other)  # a new dict of new tensors
    expect(other, 2)
    key = "rpn.block1.bn0.running_var"
    other[key] = other[key] * 2.0  # one new tensor
    load(other)
    expect(other, 3)
    with torch.no_grad():
        other["rpn.block2.conv0.pointwise.weight"].mul_(0.5)  # in place
    load(other)
    expect(other, 4)
    load(other)
    expect(other, 4)
    with torch.inference_mode():
        frozen = {k: v.clone() for k, v in other.items()}  # no versions
    load(frozen)
    load(frozen)
    expect(frozen, 6)
    with pytest.raises(ValueError):
        load({k: v for k, v in frozen.items() if k != "rpn.conv_cls.bias"})


def test_replays_follow_the_state_and_keep_earlier_outputs(rerun_graphs):
    tcfg, state = _fast_state()
    det = TorchDetector(tcfg, device="cpu")
    fn = _captured(det)
    a = _clouds_d435i(1, tcfg.model.voxel.max_points, seed=41)
    b = _clouds_d435i(1, tcfg.model.voxel.max_points, seed=42)

    def same(got, want):
        for g, w in zip(got, want):
            assert torch.equal(g, w)

    fn(state, *a)
    first = fn(state, *a)
    kept = Predictions(*(t.clone() for t in first))
    same(fn(state, *b), fn.eager(state, *b))
    same(first, kept)  # call n after call n+1
    other = {k: v.clone() for k, v in state.items()}
    with torch.no_grad():
        for k, v in other.items():
            if k.startswith("rpn.block") and v.is_floating_point():
                v.mul_(1.1)
    scaled = fn(other, *a)
    same(scaled, fn.eager(other, *a))
    assert not torch.equal(scaled.scores, first.scores)
    with torch.inference_mode():
        frozen = {k: v.clone() for k, v in state.items()}
    same(fn(frozen, *a), first)
    with torch.inference_mode():
        frozen["rpn.block3.bn1.weight"].mul_(0.25)
    same(fn(frozen, *a), fn.eager(frozen, *a))
    same(fn(state, *a), first)
    assert len(fn.graphs) == 1


class _IdleGraph:
    """A graph whose replay runs nothing, as a card's replay runs no
    Python."""

    def replay(self):
        pass


@pytest.mark.parametrize("where,after_capture,per_replay", [
    ("this_thread", 2, 2), ("other_thread", 4, 0)])
def test_a_replay_adds_what_its_capture_counted(monkeypatch, where,
                                                after_capture, per_replay):
    """A body counts ``probe.calls`` twice. Counted on the capturing
    thread, the eager first call's two stay, the capture's are taken off
    again and every replay adds two; counted by another thread, both calls'
    stay and no replay adds any."""
    monkeypatch.setattr(cuda_graph, "_run_on_side_stream",
                        lambda run, device: run())
    monkeypatch.setattr(cuda_graph, "_capture_graph",
                        lambda run: (_IdleGraph(), run()))
    name = f"probe.calls.{where}"

    def count_twice():
        tracing.count(name)
        tracing.count(name)

    def body(x):
        if where == "this_thread":
            count_twice()
        else:
            worker = threading.Thread(target=count_twice)
            worker.start()
            worker.join()
        return []

    call = cuda_graph.CapturedCall(body, "cpu")
    before = tracing.counters().get(name, 0)
    call(torch.zeros(3))
    assert tracing.counters()[name] == before + after_capture
    for i in range(1, 4):
        call(torch.zeros(3))
        assert tracing.counters()[name] == (before + after_capture
                                            + i * per_replay)


def test_make_inference_fn_is_eager_on_the_cpu():
    det = TorchDetector(small_config(TorchConfig), device="cpu")
    fn = det.make_inference_fn()
    assert det.graph_state is None
    assert fn.eager is fn


# ----------------------------------------------------------------------
# on the card


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _same(got, want):
    for name, g, w in zip(want._fields, got, want):
        if w.is_floating_point():
            tol = 1e-6 * float(w.abs().max())
            assert float((g - w).abs().max()) <= tol, name
        else:
            assert torch.equal(g, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["dense_cell", "point_major_fast"])
def test_replay_matches_eager_on_the_card(card, path):
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = TorchConfig.default()
    if path == "point_major_fast":
        cfg = fast_config(cfg)
    det = TorchDetector(cfg)
    state = det.state_to_device(from_jax_variables(*load_params(WEIGHTS),
                                                   cfg))
    fn = det.make_inference_fn()
    assert isinstance(fn, cuda_graph.CapturedInference)
    for b in (1, 2):
        args = [a.cuda() for a in _clouds_d435i(b, cfg.model.voxel.max_points,
                                                seed=b)]
        fn(state, *args)
        before = tracing.counters()["nms_keep_mask.launches"]
        got = fn(state, *args)
        assert tracing.counters()["nms_keep_mask.launches"] == before + 1
        want = fn.eager(state, *args)
        assert want.valid.any()
        _same(got, want)


@pytest.mark.cuda
def test_state_swap_and_earlier_outputs_on_the_card(card):
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = fast_config(TorchConfig.default())
    det = TorchDetector(cfg)
    state = det.state_to_device(from_jax_variables(*load_params(WEIGHTS),
                                                   cfg))
    fn = det.make_inference_fn()
    a, b = ([t.cuda() for t in _clouds_d435i(1, cfg.model.voxel.max_points,
                                             seed=s)] for s in (5, 6))
    fn(state, *a)
    first = fn(state, *a)
    kept = Predictions(*(t.clone() for t in first))
    _same(fn(state, *b), fn.eager(state, *b))
    torch.cuda.synchronize()
    _same(first, kept)
    other = {k: v.clone() for k, v in state.items()}
    with torch.no_grad():
        for v in other.values():
            if v.is_floating_point():
                v.mul_(1.01)
    _same(fn(other, *a), fn.eager(other, *a))
    with torch.inference_mode():
        frozen = {k: v.clone() for k, v in state.items()}
    _same(fn(frozen, *a), fn.eager(frozen, *a))
    _same(fn(state, *a), kept)
