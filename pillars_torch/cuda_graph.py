"""The counterpart of ``jax.jit``: captured CUDA graphs.

The JAX package never runs inference or a train step op by op: it returns
``jax.jit(fn)`` (pillars_tpu/models/detector.py::make_inference_fn) and
``jax.jit(step, donate_argnums=(0,))`` (pillars_tpu/train/loop.py), one
compiled program per static input shape. On the card the port replays one
``torch.cuda.CUDAGraph`` per static input shape instead, with one launch
from the host: :class:`CapturedCall` is that per-shape captured callable,
and :class:`CapturedInference` (``PillarsDetector.make_inference_fn``), the
captured train step and AdaBN recalibration step (train/loop.py,
train/bn_recal.py) and the profiled stages
(``PillarsDetector.profile_stages``) are built on it.

- A new shape runs the eager body once on a side stream (the kernels' nvcc
  builds, cuDNN's algorithm choice, autograd's warm-up, the folded RPN
  blocks), which answers that call, and is then captured, as ``jax.jit``
  traces and compiles at a new shape. Every graph of the process draws on
  one memory pool.
- Inputs are copied, on the caller's stream, into the graph's static device
  tensors before the replay: a CUDA tensor on the card, a pinned host tensor
  without blocking the host (the caller leaves it alone until the call is
  done, as with the eager function), anything else through pinned memory of
  PyTorch's caching host allocator, which keeps a block until its copy has
  run.
- The state: the graphs read :class:`StaticState`, copies of the state
  tensors on the card. Before a replay each of the caller's tensors is
  copied in unless it is the static tensor itself or the tensor copied last
  into that entry, unwritten since (same object, same version), and the
  fast path's folded RPN blocks are then refolded in place. A state of
  inference tensors carries no version, so it is copied on every call.
- State the graph writes (a train step's parameters, statistics and
  moments) is written in place into the static tensors. A replay writes
  without bumping the versions of what it wrote, and two caches trust
  versions (:meth:`StaticState.load` here and ``FoldedBlocksCache``), so
  every replay that writes bumps them (:meth:`StaticState.written`): a
  detector's inference graphs then read the new weights.
- The outputs: the graph packs its outputs into one static buffer, which
  each replay clones, so call *n*'s outputs outlive call *n+1*, as
  ``jax.jit``'s fresh arrays do.
- Launch counts: a kernel wrapper counts its launches in Python, which a
  replay does not run. Each graph records what its capture launched, and
  every replay adds that to the wrappers' counts; the capture itself adds
  nothing.
- Tracing (utils/tracing.py): a call is the span ``graph.call``, with the
  children ``graph.state_load`` (:class:`CapturedInference`),
  ``graph.stage_inputs``, ``graph.replay`` (the launch) and
  ``graph.outputs`` (the clone and its views), or ``graph.capture`` at a
  new shape; the counters ``graph.replays``, ``graph.captures`` and
  ``graph.state_copies`` count always. An inference graph captured while
  tracing is on holds the body's device marks, read between its replays
  (``graph.read_marks``).

- Collectives: a body may hold NCCL collectives (a train step over a mesh,
  a spatial band's halo exchange), which the graph captures with the rest:
  the process group's stream forks from the capturing stream and joins it
  again within each collective. The eager first call creates the NCCL
  communicators the body uses, so the capture makes none. Every rank calls
  at the same shapes in the same order, so all capture at the same call and
  replay their collectives in the same order; eager collectives may run on
  the same communicators between replays. Which bodies are captured is
  decided when the callable is built (``PillarsDetector.captures``): never
  a body with a gloo collective, which copies through host memory.

Nothing falls back: a capture or a replay that fails raises. Calls come from
one thread at a time, on the stream that is current there.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.graph import increment_version

from pillars_torch.ops import bn_relu_cuda, nms_cuda, pfn_cuda, rpn_cuda
from pillars_torch.utils import tracing

# (wrapper, attribute) of every kernel launch count a graph replays
COUNTERS = ((nms_cuda.nms_keep_mask, "launches"),
            (rpn_cuda.fused_sep_block, "launches"),
            (rpn_cuda.fused_sep_block, "launches_bf16"),
            (bn_relu_cuda.bn_relu, "launches"),
            (pfn_cuda.pfn_max, "launches"))

_pool = None


def graph_pool():
    """The id of the memory pool every graph of this process captures
    into: a ``torch.cuda.MemPool`` kept for the life of the process, so that
    the pool outlives each graph that draws on it (a bare pool handle dies
    with the last graph that holds it, and a later capture into it
    fails)."""
    global _pool
    if _pool is None:
        _pool = torch.cuda.MemPool()
    return _pool.id


def pool_mib() -> float:
    """MiB of device memory the graph pool holds (its segments in the
    allocator's snapshot)."""
    pool = tuple(graph_pool())
    total = 0
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg["segment_pool_id"]) == pool:
            total += seg["total_size"]
    return total / 2**20


def _read_counts() -> Tuple[int, ...]:
    return tuple(getattr(obj, attr) for obj, attr in COUNTERS)


def _set_counts(values) -> None:
    for (obj, attr), v in zip(COUNTERS, values):
        setattr(obj, attr, v)


class StaticState:
    """The state tensors that the graphs of a detector or a step read (a
    detector's are shared by the rungs of a ``BucketedInference``, whose
    detectors take the same state).

    :meth:`load` copies a caller's state in; :meth:`written` marks the
    static tensors as written by a replay; :meth:`blocks` is the
    ``FoldedBlocksCache`` interface (ops/rpn_blocks.py) over the copy: the
    fast path's folded blocks, folded at their first use and refolded in
    place by every later :meth:`load` that copies, so that the graphs go on
    reading the same buffers."""

    def __init__(self):
        self.tensors: Dict[str, torch.Tensor] = {}
        self.copies = 0
        # by entry, the caller's tensor last copied in and its version (None
        # for an inference tensor); holding it keeps the identity valid
        self._src: Dict[str, Tuple[torch.Tensor, Optional[int]]] = {}
        self._blocks = None
        self._rpn_cfg = None

    def _holds(self, name: str, t: torch.Tensor) -> bool:
        if t is self.tensors[name]:
            return True
        src = self._src.get(name)
        return (src is not None and src[0] is t and src[1] is not None
                and t._version == src[1])

    def load(self, state: Dict[str, torch.Tensor], device) -> None:
        """Makes the static tensors hold ``state``: copies in each entry
        that does not hold it already. Raises for a state whose entries,
        shapes or dtypes differ from the first one's."""
        if not self.tensors:
            self.tensors = {k: torch.empty(v.shape, dtype=v.dtype,
                                           device=device)
                            for k, v in state.items()}
        if state.keys() != self.tensors.keys():
            raise ValueError(
                f"the state's entries differ from those the graphs read: "
                f"{sorted(set(state) ^ set(self.tensors))[:5]}")
        stale = [k for k, t in state.items() if not self._holds(k, t)]
        if not stale:
            return
        for k in stale:
            t = self.tensors[k]
            if state[k].shape != t.shape or state[k].dtype != t.dtype:
                raise ValueError(
                    f"{k}: {tuple(state[k].shape)} {state[k].dtype}, the "
                    f"graphs read {tuple(t.shape)} {t.dtype}")
        torch._foreach_copy_([self.tensors[k] for k in stale],
                             [state[k] for k in stale])
        for k in stale:
            self._src[k] = (state[k], None if state[k].is_inference()
                            else state[k]._version)
        self.copies += 1
        tracing.count("graph.state_copies")
        if self._blocks is not None:
            self._refold()

    def written(self, names) -> None:
        """After a replay that wrote the static tensors ``names``: bumps
        their versions, which the replay left as they were, and forgets the
        caller's tensors they were copied from."""
        increment_version([self.tensors[k] for k in names])
        for k in names:
            self._src.pop(k, None)

    def _refold(self) -> None:
        from pillars_torch.ops.rpn_blocks import fold_rpn_blocks

        new = fold_rpn_blocks(self.tensors, self._rpn_cfg)
        torch._foreach_copy_(
            [t for blk in self._blocks for t in _block_tensors(blk)],
            [t for blk in new for t in _block_tensors(blk)])

    def blocks(self, state: Dict[str, torch.Tensor], rpn_cfg):
        """The folded blocks of the static tensors (``state`` must be
        them)."""
        from pillars_torch.ops.rpn_blocks import fold_rpn_blocks

        if state is not self.tensors:
            raise ValueError("StaticState.blocks folds its own tensors only")
        if self._blocks is None:
            self._rpn_cfg = rpn_cfg
            self._blocks = fold_rpn_blocks(self.tensors, rpn_cfg)
        return self._blocks


def _block_tensors(blk) -> List[torch.Tensor]:
    return [blk.packed, *(t for layer in blk.layers for t in layer)]


def _stage(dst: torch.Tensor, x) -> None:
    """Enqueues the copy of ``x`` into the static input ``dst``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if dst.is_cuda and x.device.type == "cpu" and not x.is_pinned():
        x = x.to(dst.dtype).pin_memory()
    dst.copy_(x, non_blocking=True)


def _pack(outputs) -> torch.Tensor:
    """Every output's bytes in one flat uint8 tensor, in order."""
    return torch.cat([t.reshape(-1).view(torch.uint8) for t in outputs])


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]   # static device inputs
    packed: Optional[torch.Tensor]     # static packed outputs
    layout: Tuple[Tuple[torch.dtype, Tuple[int, ...], int], ...]
    launches: Tuple[int, ...]          # per replay, in COUNTERS order
    seconds: float                     # eager first call + capture
    marks: Optional[tracing.DeviceMarks]  # captured while tracing was on


class CapturedCall:
    """``fn(*inputs) -> list of tensors`` that replays one captured graph
    per static input shape (module docstring).

    ``body(*inputs)`` runs on device tensors and returns a sequence of
    tensors (possibly empty); it may read and write tensors that outlive the
    call (the state), which the graph then reads and writes in place.
    ``dtypes``: the dtype of each static input (None: the first call's).
    ``context``: the grad mode the call stages, captures and replays in
    (``torch.inference_mode``, or ``torch.no_grad`` for a body that takes
    gradients itself). ``marks``: a capture while tracing is on collects
    the body's device marks (utils/tracing.py). ``graphs`` maps each input
    shape to its graph."""

    def __init__(self, body: Callable, device, dtypes=None,
                 context: Callable = torch.inference_mode,
                 marks: bool = False):
        self.body = body
        self.device = torch.device(device)
        self.dtypes = dtypes
        self.context = context
        self.marks = marks
        self.graphs: Dict[Tuple, _Graph] = {}

    def __call__(self, *inputs) -> List[torch.Tensor]:
        with tracing.span("graph.call"):
            return self.run(*inputs)

    def run(self, *inputs) -> List[torch.Tensor]:
        """The call without its ``graph.call`` span (for a caller that
        opens it around more)."""
        key = tuple(tuple(np.shape(x)) for x in inputs)
        with self.context():
            g = self.graphs.get(key)
            if g is None:
                with tracing.span("graph.capture"):
                    return self._capture(key, inputs)
            with tracing.span("graph.stage_inputs"):
                for dst, x in zip(g.inputs, inputs):
                    _stage(dst, x)
            if g.marks is not None:
                with tracing.span("graph.read_marks"):
                    g.marks.before_replay()
            with tracing.span("graph.replay"):
                g.graph.replay()
            if g.marks is not None:
                g.marks.after_replay()
            tracing.count("graph.replays")
            _set_counts(a + b for a, b in zip(_read_counts(), g.launches))
            if g.packed is None:
                return []
            with tracing.span("graph.outputs"):
                flat = g.packed.clone()
                outs, offset = [], 0
                for dtype, shape, nbytes in g.layout:
                    outs.append(flat[offset:offset + nbytes].view(dtype)
                                .view(shape))
                    offset += nbytes
        return outs

    def _capture(self, key, inputs):
        """The first call at a new shape: the eager body on a side stream
        (its result answers the call), then the capture."""
        t0 = time.perf_counter()
        dtypes = self.dtypes or tuple(
            x.dtype if isinstance(x, torch.Tensor)
            else torch.as_tensor(np.asarray(x)).dtype for x in inputs)
        static = tuple(torch.empty(shape, dtype=dtype, device=self.device)
                       for shape, dtype in zip(key, dtypes))
        for dst, x in zip(static, inputs):
            _stage(dst, x)

        def run():
            return list(self.body(*static))

        def run_packed():
            outs = run()
            return outs, (_pack(outs) if outs else None)

        first = _run_on_side_stream(run, self.device)
        before = _read_counts()
        with (tracing.capturing_marks() if self.marks
              else contextlib.nullcontext(())) as marks:
            graph, (outs, packed) = _capture_graph(run_packed)
        launches = tuple(a - b for a, b in zip(_read_counts(), before))
        _set_counts(before)  # a capture launches nothing
        layout = tuple((t.dtype, tuple(t.shape), t.numel() * t.element_size())
                       for t in outs)
        batch = key[0][0] if key and key[0] else 1
        self.graphs[key] = _Graph(
            graph, static, packed, layout, launches, time.perf_counter() - t0,
            tracing.DeviceMarks(marks, batch) if marks else None)
        tracing.count("graph.captures")
        return first


class CapturedInference:
    """``fn(state, points [B, MAXPTS, D], num_valid [B], rect [B, 4, 4],
    trv2c [B, 4, 4]) -> Predictions`` that replays one captured graph per
    static input shape (module docstring).

    ``body(state, points, num_valid, rect, trv2c)`` is the eager inference
    body on device tensors, which the graphs capture; ``eager`` the whole
    eager function (inputs anywhere), kept to compare against; ``state`` the
    :class:`StaticState` the graphs read; ``output_type`` the NamedTuple the
    body returns. ``call`` is the :class:`CapturedCall`, and ``graphs`` maps
    each input shape to its graph."""

    def __init__(self, body: Callable, eager: Callable, state: StaticState,
                 device, output_type):
        self.body = body
        self.eager = eager
        self.state = state
        self.device = torch.device(device)
        self.output_type = output_type
        self.call = CapturedCall(
            lambda *x: body(state.tensors, *x), device,
            (torch.float32, torch.int32, torch.float32, torch.float32),
            marks=True)
        self.graphs = self.call.graphs

    def __call__(self, state, points, num_valid, rect, trv2c):
        with tracing.span("graph.call"):
            with tracing.span("graph.state_load"), torch.inference_mode():
                self.state.load(state, self.device)
            return self.output_type(*self.call.run(points, num_valid, rect,
                                                   trv2c))


def replay_ms(call: CapturedCall, iters: int) -> float:
    """Warm mean ms per replay of ``call``'s one graph, replayed back to
    back between two CUDA events (no staging, no clone)."""
    if len(call.graphs) != 1:
        raise ValueError(f"replay_ms times one graph, the call holds "
                         f"{len(call.graphs)}")
    graph = next(iter(call.graphs.values())).graph
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _run_on_side_stream(run: Callable, device):
    """``run()`` on a new stream that waits for the current one, which then
    waits for it; its output tensors are marked as used on the current
    stream."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        out = run()
    current.wait_stream(side)
    for t in out:
        t.record_stream(current)
    return out


def _capture_graph(run: Callable):
    """(graph, what ``run()`` returned during its capture into the shared
    pool). Python's cyclic collector runs before the capture and is held
    off during it (its state restored after, also on an error): captured
    callables sit in reference cycles, and a collection in mid-capture
    destroys a dead one's graph on the capturing thread, a call that a
    capture does not permit, which invalidates it
    (``cudaErrorStreamCaptureInvalidated``; ``chip_smoke.py`` phase 19's
    capture stress). Holding the collector off is the repair; the full
    collection before it frees dead callables' graphs and their memory
    first, so that not even a collection called inside ``run`` finds one.
    A collection of the young generations alone does not reach them: the
    callables have aged into the oldest. It costs about 0.2 s per capture
    on a large heap, once per shape (PERF.md §6)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=graph_pool(),
                              capture_error_mode="thread_local"):
            out = run()
    finally:
        if enabled:
            gc.enable()
    return graph, out
