"""One sensor in a closed loop through ``pillars_torch.data.stream.run_stream``
(what ``pillars-torch stream`` runs for one sensor), batch 1.

``run_stream`` takes no injected source: for the run, the module's
``synthetic_source`` is bound to the benchmark's producer, which gets the
mailbox ``run_stream`` made (as the ROS subscriber does in production) and
publishes the bank's first cloud. Every later cloud is published from the
``on_detections`` callback, the moment the previous cloud's detections have
reached it: the sensor waits for each answer. A cloud's latency runs from
its publication to its detections' arrival in the callback. Nothing else of
the loop is replaced.

Traffic parameters: ``bank`` (clouds made from the seed), ``warmup``
(deliveries before the window opens, after ``run_stream``'s own warm-up
call), ``window`` (``run_stream``'s in-flight window).
"""

from __future__ import annotations

import threading
import time

from port_bench.loops._window import Window


def run(cell):
    from pillars_torch.data import stream

    bank = cell.bank
    win = Window(cell, cell.traffic["warmup"])
    deliveries = []
    sent = {"n": 0, "idx": None, "t": None}
    box = {}

    def publish():
        idx = sent["n"] % len(bank)
        sent["n"] += 1
        sent["idx"] = idx
        sent["t"] = time.perf_counter()
        box["mailbox"].publish(bank[idx])

    def producer(mailbox, *args, **kwargs):
        box["mailbox"] = mailbox
        publish()
        return threading.Thread(target=lambda: None)

    def on_detections(boxes, scores):
        deliveries.append((sent["idx"], boxes, scores))
        if win.delivered(sent["idx"], sent["t"]):
            publish()
        else:
            box["mailbox"].close()

    saved = stream.synthetic_source
    stream.synthetic_source = producer
    try:
        stream.run_stream(cell.cfg, cell.detector, cell.state, hz=1.0,
                          duration_s=cell.seconds, source="synthetic",
                          on_detections=on_detections,
                          window=int(cell.traffic["window"]))
    finally:
        stream.synthetic_source = saved
    return win.record(in_flight=1, deliveries=deliveries,
                      attempted=sent["n"], delivered=len(deliveries), slots=1)
