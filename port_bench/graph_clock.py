"""The card's time of every replay of a captured CUDA graph in a stretch of
the window, by CUDA events recorded just before and just after each
``torch.cuda.CUDAGraph.replay`` on the replaying thread's stream.

The program serves each dispatch by one replay (``pillars_torch/
cuda_graph.py``), so a replay's span is the card's time for that dispatch:
its kernels and the gaps between them inside the graph, from the moment the
launch reaches the card. The copies in and out, and the host's work around
them, lie outside it. The events come from a ring made in set-up and are
read when their turn comes round again (a replay that many dispatches back
has ended: the serving loops keep at most ``window`` in flight) and when
the clock stops.
"""

from __future__ import annotations

from typing import List, Optional

RING = 64


class GraphClock:
    """``start()`` times every replay until ``stop()``; then ``total_ms``
    and ``replays`` hold the sum of the spans and their number. Does
    nothing where CUDA is absent."""

    def __init__(self):
        import torch

        self.enabled = torch.cuda.is_available()
        self.total_ms = 0.0
        self.replays = 0
        self._ring: List = []
        self._used: List[bool] = []
        self._orig = None
        if self.enabled:
            self._ring = [(torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
                          for _ in range(RING)]
            for a, b in self._ring:  # made on the card now, not in the window
                a.record()
                b.record()
            torch.cuda.synchronize()
            self._used = [False] * RING

    def _read(self, k: int) -> None:
        if self._used[k]:
            a, b = self._ring[k]
            b.synchronize()
            self.total_ms += a.elapsed_time(b)
            self._used[k] = False

    def start(self) -> None:
        if not self.enabled:
            return
        import torch

        cls = torch.cuda.CUDAGraph
        orig = cls.replay
        clock = self

        def replay(graph) -> None:
            k = clock.replays % RING
            clock._read(k)
            a, b = clock._ring[k]
            a.record()
            orig(graph)
            b.record()
            clock._used[k] = True
            clock.replays += 1

        cls.replay = replay
        self._orig = orig

    def stop(self) -> None:
        if self._orig is None:
            return
        import torch

        torch.cuda.CUDAGraph.replay = self._orig
        self._orig = None
        for k in range(RING):
            self._read(k)

    def ms_per_replay(self) -> Optional[float]:
        return self.total_ms / self.replays if self.replays else None
