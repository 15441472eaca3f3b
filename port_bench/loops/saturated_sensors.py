"""Several sensors sharing one card through
``pillars_torch.data.stream.run_multi_stream`` (``pillars-torch stream
--num-streams``): one batched dispatch of all sensors' newest clouds.

The clouds come in through the loop's own ``source_fn``. One thread of the
benchmark publishes to every sensor's mailbox at ``hz_per_stream``, sensor
``i`` the bank rotated by ``i``, above what the card serves, so every
dispatch finds fresh clouds.
The benchmark follows which cloud each dispatch took by wrapping ``take`` of
each mailbox it is handed; the loop's ``on_detections(i, ...)`` then comes
in dispatch order for each sensor.

Traffic parameters: ``bank``, ``streams``, ``hz_per_stream``, ``warmup``
(deliveries before the window), ``window`` (the loop's in-flight window).
"""

from __future__ import annotations

import threading
import time
from collections import deque

from port_bench.loops._window import Window


def run(cell):
    from pillars_torch.data import stream

    bank = cell.bank
    n = int(cell.traffic["streams"])
    period = 1.0 / float(cell.traffic["hz_per_stream"])
    ids = {id(cloud): i for i, cloud in enumerate(bank)}
    win = Window(cell, cell.traffic["warmup"])
    fifos = [deque() for _ in range(n)]
    mailboxes = []
    deliveries = []
    stop = threading.Event()
    round_ = []
    taken = {"n": 0}

    def publisher():
        k, nxt = 0, time.perf_counter()
        while not stop.is_set():
            for i, mb in enumerate(mailboxes):
                mb.publish(bank[(k + i) % len(bank)])
            k += 1
            nxt += period
            dt = nxt - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
        for mb in mailboxes:
            mb.close()

    def source_fn(mailbox, i):
        take = mailbox.take

        def recording_take(timeout=None):
            frame, skipped = take(timeout)
            if frame is not None:
                fifos[i].append(ids[id(frame)])
                round_.append(ids[id(frame)])
                taken["n"] += 1
            if i == n - 1 and round_:  # the loop dispatches this round
                win.dispatched(tuple(round_))
                round_.clear()
            return frame, skipped

        mailbox.take = recording_take
        mailboxes.append(mailbox)
        if len(mailboxes) == n:
            threading.Thread(target=publisher, daemon=True).start()

    def on_detections(i, boxes, scores):
        idx = fifos[i].popleft()
        deliveries.append((idx, boxes, scores))
        if not win.delivered(idx, None):
            stop.set()

    stream.run_multi_stream(cell.cfg, cell.detector, cell.state,
                            num_streams=n, duration_s=cell.seconds,
                            window=int(cell.traffic["window"]),
                            on_detections=on_detections, source_fn=source_fn)
    stop.set()
    return win.record(deliveries=deliveries, attempted=taken["n"],
                      delivered=len(deliveries), slots=n)
