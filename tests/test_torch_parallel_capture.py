"""The captured paths over a mesh: the counterpart of the JAX package's
``jax.jit`` over a ``Mesh`` (pillars_tpu/parallel/mesh.py,
pillars_tpu/train/loop.py), where XLA puts the collectives inside the one
compiled program.

The rule, decided when the callable is built (``PillarsDetector.captures``,
``parallel/collectives.py::graph_safe``): on the card a body with
collectives (every train body on a mesh, a spatial band's inference) is
captured over NCCL and runs eagerly over gloo, which copies through host
memory; a body without one (no mesh, inference on a mesh without a band)
is captured whatever the backend; the CPU runs every body eagerly. Here,
with no process group, over stand-in meshes whose groups name a backend
(``_StandInMesh``): what ``make_train_step``, ``make_inference_fn`` and
``build_recal_fn`` return for each backend on the card.

The bodies themselves run in the 2-rank gloo spawn of
tests/test_torch_parallel.py (its ``capture`` cases: captured steps
against eager bit for bit, donation, sync-free bodies, the 2-band captured
inference). Marked ``cuda`` (skips here): one NCCL rank on the card
through chip_smoke.py's check of the captured mesh paths; run it on a
machine with a card and no JAX with ``python -m pytest --noconftest
tests/test_torch_parallel_capture.py -m cuda``.
"""

import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pillars_torch.config import Config
from pillars_torch.cuda_graph import CapturedInference, StaticState
from pillars_torch.models.detector import PillarsDetector
from pillars_torch.parallel.collectives import graph_safe
from pillars_torch.train.bn_recal import CapturedRecal, build_recal_fn
from pillars_torch.train.loop import CapturedTrainStep, make_train_step
from pillars_torch.train.optim import AdamW

NARROW = (("model.pfn.num_filters", 16), ("model.rpn.layer_nums", [1, 1, 1]),
          ("model.rpn.num_filters", [16, 16, 16]),
          ("model.rpn.num_upsample_filters", [16, 16, 16]))
SPATIAL = (("runtime.spatial_axis", "spatial"),)
POINT_MAJOR = (("model.pfn.dense_cell", False),)
FAST = POINT_MAJOR + (("model.rpn.use_pallas_blocks", True),)


class _Group:
    """A stand-in process group: its backend and size."""

    def __init__(self, backend, size):
        self.backend, self.size = backend, size


class _StandInMesh:
    """``parallel/mesh.py::Mesh``'s interface over stand-in groups of one
    backend, seen from rank 0."""

    def __init__(self, shape, backend):
        self.axis_names = tuple(a for a, _ in shape)
        self.shape = dict(shape)
        self.size = self.world_size = math.prod(self.shape.values())
        self.world = _Group(backend, self.size)
        self.groups = {a: self.world if n == self.size else _Group(backend, n)
                       for a, n in shape}

    def group(self, axis=None):
        return self.world if axis is None else self.groups.get(axis)

    def axis_size(self, axis):
        return self.shape.get(axis, 1)

    def axis_index(self, axis):
        return 0


@pytest.fixture
def stand_in_groups(monkeypatch):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: group.backend)
    monkeypatch.setattr(dist, "get_world_size",
                        lambda group=None: group.size)


def _config(overrides):
    cfg = Config.default()
    for key, value in NARROW + tuple(overrides):
        cfg = cfg.override(key, value)
    return cfg


def _on_the_card(cfg, mesh):
    """A detector built on the CPU over ``mesh``, then taken for one on
    the card (the routes are decided from its device and groups; nothing
    here allocates on the card): its graph state as ``__init__`` gives it
    there."""
    det = PillarsDetector(cfg, device="cpu", mesh=mesh)
    det.device = torch.device("cuda")
    det.graph_state = StaticState() if det.captures(False) else None
    return det


# (mesh, overrides, whether the inference body holds collectives: a band)
MESHES = {
    "data": ((("data", 2),), (), False),
    "spatial_point_major": ((("spatial", 2),), SPATIAL + POINT_MAJOR, True),
    "spatial_dense_cell": ((("spatial", 2),), SPATIAL, True),
    "spatial_fast": ((("spatial", 2),), SPATIAL + FAST, True),
    "2d": ((("data", 2), ("spatial", 2)), SPATIAL + POINT_MAJOR, True),
}


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_route_rule_on_the_card(name, backend, stand_in_groups):
    """An NCCL mesh captures every body; over gloo a body with collectives
    (every train body, a band's inference) gives the eager function, and a
    body without one (inference on a data mesh) is captured all the
    same."""
    shape, overrides, infer = MESHES[name]
    cfg = _config(overrides)
    det = _on_the_card(cfg, _StandInMesh(shape, backend))
    opt = AdamW(cfg.train.optimizer, cfg.train_input.batch_size)
    step = make_train_step(det, opt)
    fn = det.make_inference_fn()
    if backend == "nccl":
        assert isinstance(step, CapturedTrainStep)
        assert isinstance(fn, CapturedInference)
    else:
        assert not isinstance(step, CapturedTrainStep)
        assert step.eager is step
        assert isinstance(fn, CapturedInference) == (not infer)
        if infer:
            assert fn.eager is fn
    assert isinstance(make_train_step(det, opt, with_metrics=True),
                      CapturedTrainStep) == (backend == "nccl")


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_the_cpu_stays_eager(backend, stand_in_groups):
    shape, overrides, _ = MESHES["2d"]
    cfg = _config(overrides)
    det = PillarsDetector(cfg, device="cpu",
                          mesh=_StandInMesh(shape, backend))
    assert not det.captures(True) and not det.captures(False)
    assert det.graph_state is None
    step = make_train_step(det, AdamW(cfg.train.optimizer, 2))
    assert step.eager is step
    fn = det.make_inference_fn()
    assert fn.eager is fn


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_graph_safe(backend, stand_in_groups):
    assert graph_safe(_Group(backend, 2)) == (backend == "nccl")


def test_recal_detector_has_no_mesh(monkeypatch):
    """``build_recal_fn`` builds its own detector without a mesh: the rule
    captures it on the card on every rank, whatever the ranks' backend."""
    made = []
    real = PillarsDetector.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        made.append(self)
        self.device = torch.device("cuda")

    monkeypatch.setattr(PillarsDetector, "__init__", init)
    step = build_recal_fn(_config(()), device="cpu")
    (det,) = made
    assert det.mesh is None and isinstance(step, CapturedRecal)


class _Graph:
    """Stands in for a captured graph that holds NCCL work: records
    whether it was freed before the process group went."""

    def __init__(self, events):
        self.events = events
        self.cycle = self

    def __del__(self):
        self.events.append("graph freed")


def _rank_leaving_a_cycle(rank, device, events):
    _Graph(events)  # unreachable, freed only by the cycle collector


@pytest.mark.parametrize("backend", ["nccl", "gloo"])
def test_a_rank_frees_its_graphs_before_the_group_goes(backend, monkeypatch):
    """NCCL's teardown waits until every CUDA graph that holds its
    collectives is destroyed, so a rank that left captured callables in
    reference cycles would never exit: ``launch`` collects them before it
    destroys the process group; a rank that raised leaves an NCCL group to
    the process's exit."""
    from pillars_torch.parallel import launch

    events = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: None)
    monkeypatch.setattr(dist, "destroy_process_group",
                        lambda: events.append("group destroyed"))
    launch._entry(0, _rank_leaving_a_cycle, 1, backend, "file://x", "cpu",
                  0, (events,))
    assert events == ["graph freed", "group destroyed"]

    def fails(rank, device):
        raise RuntimeError("rank failed")

    events.clear()
    with pytest.raises(RuntimeError, match="rank failed"):
        launch._entry(0, fails, 1, backend, "file://x", "cpu", 0, ())
    assert events == ([] if backend == "nccl" else ["group destroyed"])


# ----------------------------------------------------------------------
# on the card

@pytest.mark.cuda
def test_one_nccl_rank_replays_equal_eager(tmp_path):
    """One NCCL rank at full width from weights_59.pkl (every axis group is
    the world, so each collective of the body runs), through chip_smoke.py's
    check of the captured mesh paths (``_p17_captured``, untimed) on two
    seeded batches: for the data, the one-band spatial and the 2-D mesh
    ``make_train_step`` captures, and its first call and replay equal eager
    steps from the same state bit for bit under cuDNN's deterministic
    algorithms; the band's ``make_inference_fn`` captures, its replays
    equal to the eager function (max |diff| 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import chip_smoke
    from pillars_torch.weights import from_jax_variables, load_params

    cfg = Config.default()
    state = from_jax_variables(*load_params(str(chip_smoke.WEIGHTS)), cfg)
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(2):
        points = np.zeros((2, cfg.model.voxel.max_points, 3), np.float32)
        points[:, :12000] = rng.uniform([0, -2.5, -2.9], [6.4, 2.5, 0.5],
                                            (2, 12000, 3))
        gt = np.zeros((2, 4, 7), np.float32)
        gt[..., 3:6] = 1.0
        gt[:, 0] = [3.0, 0.0, -1.5, 0.6, 0.8, 1.73, 0.3]
        batches.append(dict(
            points=points, num_points=np.full((2,), 12000, np.int32),
            gt_boxes=gt, gt_classes=np.ones((2, 4), np.int32),
            gt_valid=np.arange(4)[None].repeat(2, 0) == 0))
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = chip_smoke._p17_captured(
            cfg, state, {name: batches for name, _ in chip_smoke.P17_MESHES},
            torch.device("cuda", 0), timed=False)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()
    for name, _ in chip_smoke.P17_MESHES:
        assert out[name]["steps"] == 2
    assert out["spatial_inference"]["max_abs_diff"] == {"B1": 0, "B2": 0}
