"""The captured train and AdaBN recalibration steps of the port
(pillars_torch/train/loop.py ``CapturedTrainStep``,
pillars_torch/train/bn_recal.py ``CapturedRecal``), the counterparts of the
JAX package's ``jax.jit(step, donate_argnums=(0,))`` and jitted recal step,
on the CPU, where nothing can be captured:

- sync-free: the captured train body (train_body, the streaming metrics,
  the in-place writes of the new state, the packed outputs) of every
  single-process config of ``tests/test_torch_capture.py::CONFIGS`` at
  reduced width, with ``with_metrics`` on the default config and
  ``rpn.remat`` on and off, and the recal body, under that file's dispatch
  mode, which fails on host syncs, data-dependent shapes and tensors made
  from host data inside the body;
- the wrappers with a stand-in for the graph (the capture runs the body
  and restores the state it wrote, as a capture executes nothing; a replay
  reruns it): captured steps against the eager step from the same state,
  bit for bit (the same ops on the CPU), with and without metrics, and
  under configs/transfer_learning.yaml's freeze, whose graph writes back
  only the trainable parameters (the frozen static tensors keep their
  values and versions); the donation (the state returned holds the static tensors, a state other
  than the last one returned is copied in, ``donate=False`` returns
  copies, the state handed in stays as it was); the recal step against the
  eager one;
- the version trap: a write that leaves versions alone is not seen by
  ``StaticState`` or ``FoldedBlocksCache`` until ``increment_version``,
  and after captured steps a detector's inference graphs and fold cache
  read the new weights;
- the profiled stages of ``PillarsDetector.profile_stages``, each a graph
  of its own, give the eager inference's predictions;
- ``cuda_graph._capture_graph`` itself, with stand-ins for the CUDA graph
  and its capture context: a dead reference cycle is collected before the
  capture, the body runs with Python's cyclic collector off, and the
  collector's state is restored after it, also when the body raises.

The card's half is ``tests/test_torch_train_cuda.py``.
"""

import gc
import weakref

import numpy as np
import pytest
import torch
from torch.autograd.graph import increment_version

from pillars_torch import cuda_graph
from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.detector import PillarsDetector
from pillars_torch.ops.rpn_blocks import FoldedBlocksCache
from pillars_torch.train import metrics as tm
from pillars_torch.train.bn_recal import (CapturedRecal, build_recal_fn,
                                          recalibrate)
from pillars_torch.train.loop import (CapturedTrainStep, create_train_state,
                                      make_train_step, variables)
from test_torch_capture import CONFIGS, _SyncCheck
from torch_parity import fast_config, train_batches, train_config

torch.set_num_threads(2)


class _Graph:
    """A replay reruns the captured function into its static outputs."""

    def __init__(self, run, packed):
        self.run, self.packed, self.replays = run, packed, 0

    def replay(self):
        out = self.run()[1]
        if self.packed is not None:
            self.packed.copy_(out)
        self.replays += 1


class _Capture:
    """``cuda_graph._capture_graph`` on the CPU: runs the function for its
    outputs and restores the static state tensors it wrote (``states``), as
    a capture executes nothing."""

    def __init__(self):
        self.states = []

    def __call__(self, run):
        saved = [{k: t.clone() for k, t in st.tensors.items()}
                 for st in self.states]
        out = run()
        with torch.no_grad():
            for st, snap in zip(self.states, saved):
                for k, t in st.tensors.items():
                    t.copy_(snap[k])
        return _Graph(run, out[1]), out


@pytest.fixture
def capture(monkeypatch):
    cap = _Capture()
    monkeypatch.setattr(cuda_graph, "_capture_graph", cap)
    monkeypatch.setattr(cuda_graph, "_run_on_side_stream",
                        lambda run, device: run())
    return cap


def _batch(cfg, seed):
    vcfg = cfg.model.voxel
    b = train_batches(seed, 1, b=2, maxpts=vcfg.max_points,
                      max_gt=cfg.model.target.max_gt_boxes,
                      n=min(1500, vcfg.max_points - 400))[0]
    extra = cfg.model.num_point_features - 3
    if extra:
        r = np.random.RandomState(seed)
        b["points"] = np.concatenate([b["points"], r.uniform(
            0, 1, b["points"].shape[:2] + (extra,)).astype(np.float32)], -1)
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _captured(cfg, capture, with_metrics=False, donate=True, seed=0):
    det = PillarsDetector(cfg, device="cpu")
    state, opt = create_train_state(det, torch.Generator().manual_seed(seed),
                                    2)
    eager = make_train_step(det, opt, with_metrics=with_metrics)
    assert eager.eager is eager  # the CPU takes the eager step
    step = CapturedTrainStep(det, opt,
                             cfg.train_input.anchor_area_threshold,
                             with_metrics, donate, eager)
    capture.states.append(step.static)
    return det, state, step


# (config, with_metrics, rpn.remat)
SYNC_CASES = [(name, False, False) for name in sorted(CONFIGS)] + [
    ("dense_cell", True, False), ("dense_cell", False, True),
    ("point_major_fast", False, True)]


@pytest.mark.parametrize("name,with_metrics,remat", SYNC_CASES)
def test_train_body_is_sync_free(name, with_metrics, remat, capture):
    cfg = CONFIGS[name]().override("model.rpn.remat", remat)
    det, state, step = _captured(cfg, capture, with_metrics)
    batch = _batch(cfg, 1)
    args = (tm.TrainMetricsState.init(),) if with_metrics else ()
    step(state, *args, batch)  # the first call, eager, then the capture
    (graph,) = step.graphs.values()
    check = _SyncCheck()
    with check:
        graph.graph.replay()
    assert not check.found, check.found
    assert graph.graph.replays == 1


def test_recal_body_is_sync_free(capture):
    cfg = CONFIGS["dense_cell"]()
    eager = build_recal_fn(cfg, device="cpu")
    assert eager.eager is eager
    recal = CapturedRecal(PillarsDetector(
        cfg.override("model.pfn.bn_momentum", 0.9)
        .override("model.rpn.bn_momentum", 0.9), device="cpu"), eager)
    capture.states.append(recal.static)
    state = PillarsDetector(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = _batch(cfg, 2)
    recal(state, batch["points"], batch["num_points"])
    (graph,) = recal.graphs.values()
    check = _SyncCheck()
    with check:
        graph.graph.replay()
    assert not check.found, check.found


def _equal_states(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for x, y in ((a.params, b.params), (a.batch_stats, b.batch_stats),
                 (a.opt_state.mu, b.opt_state.mu),
                 (a.opt_state.nu, b.opt_state.nu)):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k


@pytest.mark.parametrize("with_metrics", [False, True])
def test_captured_steps_match_eager_steps(with_metrics, capture):
    cfg = train_config(TorchConfig)
    det, state, step = _captured(cfg, capture, with_metrics)
    batches = [_batch(cfg, 10 + i) for i in range(3)]
    before = {k: v.clone() for k, v in state.params.items()}
    want, got = state, state
    tm_want = tm_got = tm.TrainMetricsState.init() if with_metrics else None
    for batch in batches:
        if with_metrics:
            want, tm_want, m_want, v_want = step.eager(want, tm_want, batch)
            got, tm_got, m_got, v_got = step(got, tm_got, batch)
            assert v_got.keys() == v_want.keys()
            for k in v_want:
                assert torch.equal(v_got[k], v_want[k]), k
            for g, w in zip(tm_got, tm_want):
                for a, b in zip(g, w):
                    assert torch.equal(a, b)
        else:
            want, m_want = step.eager(want, batch)
            got, m_got = step(got, batch)
        for name, g, w in zip(m_want._fields, m_got, m_want):
            assert torch.equal(g, w), name
        assert int(m_got.num_positives) > 0
    _equal_states(got, want)
    assert len(step.graphs) == 1
    (graph,) = step.graphs.values()
    assert graph.graph.replays == 2
    # the state handed in is untouched; the one returned is the graph's
    assert all(torch.equal(state.params[k], v) for k, v in before.items())
    assert all(got.params[k] is step.static.tensors[f"params/{k}"]
               for k in got.params)


def test_captured_transfer_step_writes_only_the_trainable_leaves(capture):
    """configs/transfer_learning.yaml: the captured steps equal the eager
    ones, the graph writes back the trainable parameters alone, and the
    frozen leaves' static tensors keep their values and their versions."""
    cfg = CONFIGS["transfer_learning"]()
    det, state, step = _captured(cfg, capture)
    trainable = set(state.opt_state.mu)
    assert 0 < len(trainable) < len(state.params)
    batches = [_batch(cfg, 40 + i) for i in range(3)]
    want = got = state
    for i, batch in enumerate(batches):
        want, m_want = step.eager(want, batch)
        got, m_got = step(got, batch)
        for name, g, w in zip(m_want._fields, m_got, m_want):
            assert torch.equal(g, w), name
        if i == 0:
            versions = {k: got.params[k]._version for k in got.params
                        if k not in trainable}
    _equal_states(got, want)
    assert {k for k in step._written if k.startswith("params/")} == {
        f"params/{k}" for k in trainable}
    for k, v in state.params.items():
        if k in trainable:
            assert not torch.equal(got.params[k], v), k
        else:
            assert torch.equal(got.params[k], v), k
            assert got.params[k]._version == versions[k], k


def test_donation(capture):
    cfg = train_config(TorchConfig)
    det, state, step = _captured(cfg, capture)
    a, b = _batch(cfg, 20), _batch(cfg, 21)
    s1, _ = step(state, a)
    copies = step.static.copies
    s2, _ = step(s1, b)  # the last state returned: nothing to copy
    assert step.static.copies == copies
    # an earlier state is copied in, and gives what it gave before
    again, _ = step(state, a)
    assert step.static.copies == copies + 1
    _equal_states(again, step.eager(state, a)[0])
    # one new tensor in the last state: that entry alone is copied
    s3 = again._replace(params={**again.params})
    key = next(iter(s3.params))
    s3.params[key] = s3.params[key] * 0.5
    step(s3, a)
    assert step.static.copies == copies + 2
    # donate=False: copies of the static tensors, which later steps leave
    _, _, kept_step = _captured(cfg, capture, donate=False)
    kept, _ = kept_step(state, a)
    assert not any(kept.params[k] is kept_step.static.tensors[f"params/{k}"]
                   for k in kept.params)
    snapshot = {k: v.clone() for k, v in kept.params.items()}
    kept_step(kept, b)
    assert all(torch.equal(kept.params[k], v) for k, v in snapshot.items())
    _equal_states(kept, step.eager(state, a)[0])


def test_recal_step_matches_eager(capture):
    cfg = train_config(TorchConfig)
    det = PillarsDetector(cfg, device="cpu")
    state = det.init(torch.Generator().manual_seed(3))
    eager = build_recal_fn(cfg, device="cpu")
    recal = CapturedRecal(PillarsDetector(
        cfg.override("model.pfn.bn_momentum", 0.9)
        .override("model.rpn.bn_momentum", 0.9), device="cpu"), eager)
    capture.states.append(recal.static)
    batches = [{k: _batch(cfg, 30 + i)[k] for k in ("points", "num_points")}
               for i in range(3)]
    before = {k: v.clone() for k, v in state.items()}
    want = recalibrate(cfg, state, batches, step=eager)
    got = recalibrate(cfg, state, batches, step=recal)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert all(torch.equal(state[k], v) for k, v in before.items())
    assert recal.static.copies == 1  # the state once, then in place
    (graph,) = recal.graphs.values()
    assert graph.graph.replays == 2


def test_increment_version_invalidates_the_caches():
    """A write that bumps no version (as a graph replay writes) is not
    seen until ``increment_version``."""
    cfg = fast_config(train_config(TorchConfig))
    state = PillarsDetector(cfg, device="cpu").init(
        torch.Generator().manual_seed(4))
    st = cuda_graph.StaticState()
    st.load(state, "cpu")
    key = "rpn.block1.conv0.pointwise.weight"
    state[key].data.mul_(2.0)  # .data: a write without a version bump
    st.load(state, "cpu")
    assert st.copies == 1 and not torch.equal(st.tensors[key], state[key])
    increment_version(state[key])
    st.load(state, "cpu")
    assert st.copies == 2 and torch.equal(st.tensors[key], state[key])

    cache = FoldedBlocksCache()
    cache.blocks(state, cfg.model.rpn)
    state[key].data.mul_(2.0)
    cache.blocks(state, cfg.model.rpn)
    assert cache.folds == 1
    increment_version(state[key])
    cache.blocks(state, cfg.model.rpn)
    assert cache.folds == 2

    # StaticState.written: what a replay wrote is no longer the caller's
    st.written([key])
    st.load(state, "cpu")
    assert st.copies == 3


def test_inference_reads_the_weights_of_captured_steps(capture):
    """After captured steps, the detector's inference graph state copies
    the donated tensors again and its fold cache refolds: inference reads
    the newest weights, as after eager steps."""
    cfg = fast_config(train_config(TorchConfig))
    det, state, step = _captured(cfg, capture)
    assert det.fast
    batch = _batch(cfg, 40)
    graph_state = cuda_graph.StaticState()
    with torch.no_grad():
        vox = det.voxelize_batch(batch["points"], batch["num_points"])
    for i in range(3):
        state, _ = step(state, batch)
        with torch.inference_mode():
            graph_state.load(variables(state), "cpu")
            got = det._forward_fast(variables(state), vox)
            want = det.apply(variables(state), vox)
        assert graph_state.copies == i + 1
        assert det.folded_blocks.folds == i + 1
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0,
                                       atol=1e-4 * float(want[k].abs().max()))


@pytest.mark.parametrize("name", ["dense_cell", "point_major_fast"])
def test_profiled_stages_give_the_eager_predictions(name, monkeypatch):
    from test_torch_capture import _clouds, _rerun_capture

    monkeypatch.setattr(cuda_graph, "_capture_graph", _rerun_capture)
    monkeypatch.setattr(cuda_graph, "_run_on_side_stream",
                        lambda run, device: run())
    cfg = CONFIGS[name]().override("model.pfn.dense_cell", False)
    det = PillarsDetector(cfg, device="cpu")
    state = det.init(torch.Generator().manual_seed(5))
    args = _clouds(cfg, 2, seed=6)
    calls = det.profiled_stages(state, *args)
    assert set(calls) == {"t_voxel_features", "t_spatial_features_plus_rpn",
                          "t_nms_func", "t_whole"}
    for call in calls.values():  # each captured, then replayed once
        (graph,) = call.graphs.values()
        assert graph.graph.replays == 1
    points, num, rect, trv2c = args
    with torch.inference_mode():  # the stages eagerly: apply, never fused
        vox = det.voxelize_batch(points, num)
        amask = det.anchors_mask_batch(vox.coords, vox.pillar_mask,
                                       cfg.eval_input.anchor_area_threshold)
        want = det.postprocess(det.apply(state, vox), amask, rect, trv2c)
    for g, w in zip(calls["t_whole"](*args), want):
        assert torch.equal(g, w)


class _StandInGraph:
    pass


class _StandInCapture:
    """``torch.cuda.graph`` on the CPU: a context that captures nothing."""

    def __init__(self, graph, pool=None, capture_error_mode="global"):
        assert isinstance(graph, _StandInGraph)
        assert capture_error_mode == "thread_local"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _Cycle:
    pass


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_holds_the_collector_off(enabled, monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph", _StandInCapture)
    monkeypatch.setattr(cuda_graph, "graph_pool", lambda: None)

    def body():
        return gc.isenabled(), dead() is None

    def failing():
        raise RuntimeError("the body failed")

    was = gc.isenabled()
    try:
        (gc.enable if enabled else gc.disable)()
        cycle = _Cycle()
        cycle.me = cycle
        dead = weakref.ref(cycle)
        del cycle
        graph, out = cuda_graph._capture_graph(body)
        assert isinstance(graph, _StandInGraph)
        assert out == (False, True)  # collector off, the cycle collected
        assert gc.isenabled() is enabled
        with pytest.raises(RuntimeError, match="the body failed"):
            cuda_graph._capture_graph(failing)
        assert gc.isenabled() is enabled
    finally:
        (gc.enable if was else gc.disable)()
