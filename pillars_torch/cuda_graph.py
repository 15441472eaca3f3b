"""The counterpart of ``jax.jit`` for inference: a captured CUDA graph.

The JAX package never runs its inference op by op:
pillars_tpu/models/detector.py::make_inference_fn returns ``jax.jit(fn)``,
one compiled program per static input shape. On the card,
:meth:`pillars_torch.models.detector.PillarsDetector.make_inference_fn`
returns a :class:`CapturedInference` instead: per static input shape (batch
size, padded point width, point features) one ``torch.cuda.CUDAGraph``
holding the whole eager body (voxelizer, network, postprocess with the NMS
kernel and, on the fast configs, the fused RPN chain kernel), replayed with
one launch from the host.

- A new shape runs the eager body once on a side stream (the kernels' nvcc
  builds, cuDNN's algorithm choice, the folded RPN blocks), which answers
  that call, and is then captured, as ``jax.jit`` traces and compiles at a
  new shape. Every graph of the process draws on one memory pool.
- Inputs are copied, on the caller's stream, into the graph's static device
  tensors before the replay: a CUDA tensor on the card, a pinned host tensor
  without blocking the host (the caller leaves it alone until the batch is
  done, as with the eager function), anything else through pinned memory of
  PyTorch's caching host allocator, which keeps a block until its copy has
  run.
- The state: every graph reads :class:`StaticState`, a copy of the state
  made on the card. Before a replay the caller's state is copied into it
  when it is not the state copied last (other tensors, or the same tensors
  written in place since), and the fast path's folded RPN blocks are then
  refolded in place. A state of inference tensors carries no version, so it
  is copied on every call.
- The outputs: the graph packs the predictions into one static buffer,
  which each replay clones, so call *n*'s predictions outlive call *n+1*, as
  ``jax.jit``'s fresh arrays do.
- Launch counts: a kernel wrapper counts its launches in Python, which a
  replay does not run. Each graph records what its capture launched, and
  every replay adds that to the wrappers' counts; the capture itself adds
  nothing.

Nothing falls back: a capture or a replay that fails raises. Calls come from
one thread at a time (the serving loops' dispatch thread), on the stream
that is current there.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from pillars_torch.ops import nms_cuda, rpn_cuda

# (wrapper, attribute) of every kernel launch count a graph replays
COUNTERS = ((nms_cuda.nms_keep_mask, "launches"),
            (rpn_cuda.fused_sep_block, "launches"),
            (rpn_cuda.fused_sep_block, "launches_bf16"))

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
    """The state tensors that the graphs of a detector read (shared by the
    rungs of a ``BucketedInference``, whose detectors take the same state).

    :meth:`load` copies a caller's state in; :meth:`blocks` is the
    ``FoldedBlocksCache`` interface (ops/rpn_blocks.py) over the copy: the
    fast path's folded blocks, folded at their first use and refolded in
    place by every later :meth:`load` that copies, so that the graphs go on
    reading the same buffers."""

    def __init__(self):
        self.tensors: Dict[str, torch.Tensor] = {}
        self.copies = 0
        # the caller's tensors last copied, each with its version (None for
        # an inference tensor); holding them keeps the identities valid
        self._src: Tuple[Tuple[str, torch.Tensor, Optional[int]], ...] = ()
        self._blocks = None
        self._rpn_cfg = None

    def _is_loaded(self, state: Dict[str, torch.Tensor]) -> bool:
        if len(state) != len(self._src):
            return False
        for name, t, version in self._src:
            if (state.get(name) is not t or version is None
                    or t._version != version):
                return False
        return True

    def load(self, state: Dict[str, torch.Tensor], device) -> None:
        """Makes the static tensors hold ``state``: copies it in unless it
        is the state copied last, unchanged. Raises for a state whose
        entries, shapes or dtypes differ from the first one's."""
        if self._is_loaded(state):
            return
        if not self.tensors:
            self.tensors = {k: torch.empty(v.shape, dtype=v.dtype,
                                           device=device)
                            for k, v in state.items()}
        if state.keys() != self.tensors.keys():
            raise ValueError(
                f"the state's entries differ from those the graphs read: "
                f"{sorted(set(state) ^ set(self.tensors))[:5]}")
        for k, t in self.tensors.items():
            if state[k].shape != t.shape or state[k].dtype != t.dtype:
                raise ValueError(
                    f"{k}: {tuple(state[k].shape)} {state[k].dtype}, the "
                    f"graphs read {tuple(t.shape)} {t.dtype}")
        names = list(self.tensors)
        torch._foreach_copy_([self.tensors[k] for k in names],
                             [state[k] for k in names])
        self._src = tuple((k, state[k], None if state[k].is_inference()
                           else state[k]._version) for k in names)
        self.copies += 1
        if self._blocks is not None:
            self._refold()

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
    packed: torch.Tensor               # static packed outputs
    layout: Tuple[Tuple[torch.dtype, Tuple[int, ...], int], ...]
    launches: Tuple[int, ...]          # per replay, in COUNTERS order
    seconds: float                     # eager first call + capture


class CapturedInference:
    """``fn(state, points [B, MAXPTS, D], num_valid [B], rect [B, 4, 4],
    trv2c [B, 4, 4]) -> Predictions`` that replays one captured graph per
    static input shape (module docstring).

    ``body(state, points, num_valid, rect, trv2c)`` is the eager inference
    body on device tensors, which the graphs capture; ``eager`` the whole
    eager function (inputs anywhere), kept to compare against; ``state`` the
    :class:`StaticState` the graphs read; ``output_type`` the NamedTuple the
    body returns. ``graphs`` maps each input shape to its graph."""

    def __init__(self, body: Callable, eager: Callable, state: StaticState,
                 device, output_type):
        self.body = body
        self.eager = eager
        self.state = state
        self.device = torch.device(device)
        self.output_type = output_type
        self.graphs: Dict[Tuple, _Graph] = {}

    def __call__(self, state, points, num_valid, rect, trv2c):
        inputs = (points, num_valid, rect, trv2c)
        key = tuple(tuple(np.shape(x)) for x in inputs)
        with torch.inference_mode():
            self.state.load(state, self.device)
            g = self.graphs.get(key)
            if g is None:
                return self._capture(key, inputs)
            for dst, x in zip(g.inputs, inputs):
                _stage(dst, x)
            g.graph.replay()
            _set_counts(a + b for a, b in zip(_read_counts(), g.launches))
            flat = g.packed.clone()
        outs, offset = [], 0
        for dtype, shape, nbytes in g.layout:
            outs.append(flat[offset:offset + nbytes].view(dtype).view(shape))
            offset += nbytes
        return self.output_type(*outs)

    def _capture(self, key, inputs):
        """The first call at a new shape: the eager body on a side stream
        (its result answers the call), then the capture."""
        t0 = time.perf_counter()
        dtypes = (torch.float32, torch.int32, torch.float32, torch.float32)
        static = tuple(torch.empty(shape, dtype=dtype, device=self.device)
                       for shape, dtype in zip(key, dtypes))
        for dst, x in zip(static, inputs):
            _stage(dst, x)

        def run():
            return self.body(self.state.tensors, *static)

        def run_packed():
            outs = run()
            return outs, _pack(outs)

        first = _run_on_side_stream(run, self.device)
        before = _read_counts()
        graph, (outs, packed) = _capture_graph(run_packed)
        launches = tuple(a - b for a, b in zip(_read_counts(), before))
        _set_counts(before)  # a capture launches nothing
        layout = tuple((t.dtype, tuple(t.shape), t.numel() * t.element_size())
                       for t in outs)
        self.graphs[key] = _Graph(graph, static, packed, layout, launches,
                                  time.perf_counter() - t0)
        return first


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
    pool)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=graph_pool(),
                          capture_error_mode="thread_local"):
        out = run()
    return graph, out
