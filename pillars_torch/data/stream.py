"""Streaming (production-mode) inference: sensor -> mailbox -> detector
(pillars_tpu/data/stream.py).

The reference's production mode wires a ROS subscriber to the data generator
through an UNSYNCHRONIZED attribute (production_pc written by the ROS thread,
read by the generator; its 'new frame' flag is never cleared — SURVEY §5.2,
reference load_data.py:2125-2127, :2244-2246). Here the handoff is an
explicit single-slot latest-frame MAILBOX with a lock and a sequence number:
the consumer always gets the newest frame, skipped frames are counted, and
the race is gone.

Sources: an emulated d435i at a fixed rate (synthetic scenes or dataset
replay) — the ROS adapter (reference scripts/realsense_make_dataset.py
subscribing /camera/depth/color/points) plugs in behind the same Mailbox
interface when rospy is available.

How the loops meet the card. One thread dispatches (``torch.inference_mode``
is thread-local, and the detector enters it itself). Each dispatch writes
the frame into one of ``window`` pinned host buffers used in turn and hands
it to the detector as a tensor, so the copy to the card does not block the
dispatch thread; a buffer comes up again only after the dispatch that used it
was consumed, so no pending copy is overwritten. The copy of the predictions
back is enqueued by the dispatch thread behind the batch
(:class:`~pillars_torch.models.detector.HostFetch`); a worker thread waits
for that batch's event only and stamps the latency when the data is there.
"""

from __future__ import annotations

import pickle
import threading
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch


class LatestFrameMailbox:
    """Single-slot, lock-protected latest-value mailbox."""

    def __init__(self):
        self._lock = threading.Lock()
        self._frame = None
        self._seq = 0
        self._taken_seq = 0
        self._cv = threading.Condition(self._lock)
        self._closed = False

    def publish(self, frame) -> None:
        with self._cv:
            self._frame = frame
            self._seq += 1
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def take(self, timeout: Optional[float] = None):
        """Block for a frame NEWER than the last taken one.

        Returns (frame, skipped_count) or (None, 0) on close/timeout.
        ``timeout=0`` is a non-blocking poll."""
        with self._cv:
            if not self._cv.wait_for(
                    lambda: self._closed or self._seq > self._taken_seq,
                    timeout=timeout):
                return None, 0
            if self._closed and self._seq <= self._taken_seq:
                return None, 0
            skipped = self._seq - self._taken_seq - 1
            self._taken_seq = self._seq
            return self._frame, skipped

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed


def synthetic_source(mailbox: LatestFrameMailbox, hz: float,
                     duration_s: float, seed: int = 0,
                     n_points: int = 19200) -> threading.Thread:
    """Emulated d435i publisher at ``hz`` frames/sec."""
    from pillars_torch.data.synthetic import make_scene

    def run():
        rng = np.random.RandomState(seed)
        period = 1.0 / hz
        t_end = time.perf_counter() + duration_s
        nxt = time.perf_counter()
        while time.perf_counter() < t_end:
            points, _ = make_scene(rng)
            mailbox.publish(points)
            nxt += period
            dt = nxt - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
        mailbox.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def bank_source(mailbox: LatestFrameMailbox, hz: float, duration_s: float,
                frames) -> threading.Thread:
    """Publish PRE-GENERATED frames round-robin at ``hz``.

    For serving measurements: per-frame scene synthesis costs more CPU
    than the whole dispatch loop on a small host, so an 8-stream run with
    live synthetic sources measures the host's generator, not the device
    path (the r3 multi-stream probe failed exactly this way). A bank
    publish is one lock + reference assignment."""
    def run():
        period = 1.0 / hz
        t_end = time.perf_counter() + duration_s
        nxt = time.perf_counter()
        i = 0
        while time.perf_counter() < t_end:
            mailbox.publish(frames[i % len(frames)])
            i += 1
            nxt += period
            dt = nxt - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
        mailbox.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def synthetic_bank(count: int, seed: int = 0,
                   max_points: Optional[int] = None) -> list:
    """``count`` synthetic d435i scenes [n, 3] for :func:`bank_source`, each
    in random point order; with ``max_points`` thinned at random to that
    many points (the generator emits the background first, so cutting the
    tail off would lose the pedestrians)."""
    from pillars_torch.data.synthetic import make_scene

    rng = np.random.RandomState(seed)
    bank = []
    for _ in range(count):
        pts = make_scene(rng)[0][:, :3].astype(np.float32)
        bank.append(pts[rng.permutation(len(pts))[:max_points]])
    return bank


def replay_source(mailbox: LatestFrameMailbox, hz: float, duration_s: float,
                  dataset_root: str, info_name: str = "kitti_infos_val.pkl"
                  ) -> threading.Thread:
    """Replay recorded clouds from a dataset at a fixed rate (the reference's
    offline-replay debugging path, scripts/rviz_show_predictions.py)."""
    with open(f"{dataset_root}/{info_name}", "rb") as f:
        infos = pickle.load(f)

    def load(i):
        path = f"{dataset_root}/{infos[i % len(infos)]['velodyne_path']}"
        with open(path[:-3] + "pkl", "rb") as f:
            return np.asarray(pickle.load(f, encoding="latin1"),
                              dtype=np.float32)[:, :3]

    def run():
        period = 1.0 / hz
        t_end = time.perf_counter() + duration_s
        nxt = time.perf_counter()
        i = 0
        while time.perf_counter() < t_end:
            mailbox.publish(load(i))
            i += 1
            nxt += period
            dt = nxt - time.perf_counter()
            if dt > 0:
                time.sleep(dt)
        mailbox.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def d435i_to_lidar(points_xyz: np.ndarray, subsample: int = 4,
                   z_lift: float = 1.0) -> np.ndarray:
    """RealSense image coords -> lidar coords (the one function of
    pillars_tpu/data/capture.py that the live source needs).

    reference load_data.py:2433-2444 / realsense_make_dataset.py:395-412:
    take every 4th point, rotate R_y(-90) then R_x(90), lift z by 1 m."""
    pts = np.asarray(points_xyz, dtype=np.float32)[::subsample]
    cy, sy = np.cos(-np.pi / 2), np.sin(-np.pi / 2)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], dtype=np.float32)
    cx, sx = np.cos(np.pi / 2), np.sin(np.pi / 2)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]], dtype=np.float32)
    pts = pts @ ry
    pts = pts @ rx
    pts = pts + np.array([0.0, 0.0, z_lift], dtype=np.float32)
    return pts


def ros_source(mailbox: LatestFrameMailbox,
               topic: str = "/camera/depth/color/points",
               subsample: int = 4) -> "object":
    """Live RealSense source: subscribe the ROS pointcloud topic and publish
    lidar-frame clouds into the mailbox.

    reference load_data.py:2077-2127 (production_pc_update subscriber) +
    :2433-2444 (image->lidar transform, every-4th subsampling) — but through
    the locked mailbox instead of the reference's racy attribute handoff.
    Requires rospy + ros_numpy; raises ImportError otherwise."""
    import rospy
    import ros_numpy
    from sensor_msgs.msg import PointCloud2

    if rospy.get_node_uri() is None:
        rospy.init_node("pillars_torch_stream", anonymous=True)

    def callback(msg):
        xyz = ros_numpy.point_cloud2.pointcloud2_to_xyz_array(msg)
        mailbox.publish(d435i_to_lidar(xyz, subsample=subsample))

    return rospy.Subscriber(topic, PointCloud2, callback, queue_size=1)


class _Staging:
    """``depth`` host buffers [batch, maxpts, 3] handed out in turn, in
    pinned memory when the detector runs on the card."""

    def __init__(self, depth: int, batch: int, maxpts: int, device):
        pin = torch.device(device).type == "cuda"
        self.ring = [torch.zeros((batch, maxpts, 3), dtype=torch.float32,
                                 pin_memory=pin) for _ in range(depth)]
        self._i = 0

    def next(self):
        """(NumPy view to fill, the tensor to hand to the detector)."""
        t = self.ring[self._i % len(self.ring)]
        self._i += 1
        return t.numpy(), t


def _fetch(fetch, t0):
    out = fetch.result()
    return out, (time.perf_counter() - t0) * 1e3


def run_stream(cfg, detector, variables, hz: float = 120.0,
               duration_s: float = 5.0, source: str = "synthetic",
               on_detections: Optional[Callable] = None,
               window: int = 8,
               buckets: Optional[Sequence[int]] = None,
               publisher=None) -> Dict:
    """Pull frames from the mailbox through the detector as fast as they
    arrive; report throughput / latency / drop statistics.

    Dispatch and readback are decoupled: up to ``window`` frames are in
    flight, their device->host fetches are awaited on a small thread pool,
    and results are consumed (latency stats + ``on_detections``) strictly in
    dispatch order. The bounded window keeps memory honest while the card
    works ahead of the consumer.

    ``buckets`` enables bucketed dispatch (pillars_torch.infer): each frame
    runs through the smallest point-count bucket that holds it instead of
    the worst-case width; all buckets are warmed before the source starts,
    so the stream never stalls on a kernel build or an algorithm search.

    ``publisher`` (a viz.publisher object) mirrors the reference's
    production-mode RVIZ output per consumed frame: the raw cloud on
    ``debug_points`` and score-filtered predictions on ``bb_pred_guess_1``
    (reference train.py:810-829).

    reference production loop (train.py:689-861 + load_data.py:2244-2246)."""
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from pillars_torch.models.detector import HostFetch

    device = detector.device
    variables = detector.state_to_device(variables)
    maxpts = cfg.model.voxel.max_points
    eye = torch.eye(4, dtype=torch.float32, device=device)[None]
    min_score = cfg.runtime.prediction_min_score

    # warm up BEFORE the source starts, or the whole stream drops frames
    # during the (slow) first call
    if buckets is not None:
        from pillars_torch.infer import BucketedInference
        infer = BucketedInference(
            cfg, buckets, cfg.eval_input.anchor_area_threshold,
            device=device)
        infer.warmup(variables, num_features=3)
        maxpts = max(infer.buckets)
    else:
        infer = detector.make_inference_fn(
            cfg.eval_input.anchor_area_threshold)
        infer(variables, np.zeros((1, maxpts, 3), np.float32),
              np.asarray([0], np.int32), eye, eye)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    mailbox = LatestFrameMailbox()
    if source == "synthetic":
        producer = synthetic_source(mailbox, hz, duration_s)
    elif source.startswith("replay:"):
        producer = replay_source(mailbox, hz, duration_s,
                                 source.split(":", 1)[1])
    elif source == "ros":
        producer = ros_source(mailbox)
        threading.Timer(duration_s, mailbox.close).start()
    else:
        raise ValueError(f"unknown stream source {source!r}")

    processed = 0
    skipped_total = 0
    latencies = []
    t_start = time.perf_counter()
    window = max(1, int(window))
    fetchers = ThreadPoolExecutor(max_workers=window)
    inflight = deque()  # futures, dispatch order
    staging = _Staging(window, 1, maxpts, device)

    def consume(entry):
        nonlocal processed
        fut, frame_pts = entry
        out, lat_ms = fut.result()
        latencies.append(lat_ms)
        processed += 1
        keep = None
        if on_detections is not None or publisher is not None:
            keep = out.valid[0] & (out.scores[0] >= min_score)
        if on_detections is not None:
            on_detections(out.boxes_lidar[0][keep], out.scores[0][keep])
        if publisher is not None:
            from pillars_torch.viz.publisher import publish_reference_topics

            publish_reference_topics(
                publisher, points=frame_pts,
                pred_boxes=out.boxes_lidar[0][keep],
                pred_scores=out.scores[0][keep])

    while True:
        frame, skipped = mailbox.take(timeout=2.0)
        if frame is None:
            break
        skipped_total += skipped
        t0 = time.perf_counter()
        n = min(len(frame), maxpts)
        # the full-width buffer with a zero tail: the bucketed dispatcher
        # slices it to the smallest bucket that holds n (a view of the same
        # pinned memory)
        pts, handed = staging.next()
        pts[0, :n] = frame[:n, :3]
        pts[0, n:] = 0.0
        # num stays a HOST array: the bucketed dispatcher reads it to pick
        # the bucket, and a device tensor there would cost a blocking copy
        # back per frame
        out = infer(variables, handed, np.asarray([n], np.int32), eye, eye)
        # the publisher outlives the buffer's turn: give it its own copy
        shown = pts[0, :n].copy() if publisher is not None else None
        inflight.append((fetchers.submit(_fetch, HostFetch(out), t0), shown))
        while len(inflight) >= window:
            consume(inflight.popleft())
    while inflight:
        consume(inflight.popleft())
    fetchers.shutdown()
    wall = time.perf_counter() - t_start
    lat = np.asarray(latencies) if latencies else np.zeros(1)
    return {
        "frames_processed": processed,
        "frames_skipped": int(skipped_total),
        "wall_s": round(wall, 3),
        "throughput_hz": round(processed / max(wall, 1e-9), 2),
        "latency_p50_ms": round(float(np.percentile(lat, 50)), 3),
        "latency_p99_ms": round(float(np.percentile(lat, 99)), 3),
    }


def run_multi_stream(cfg, detector, variables, num_streams: int = 4,
                     hz: float = 30.0, duration_s: float = 5.0,
                     window: int = 8,
                     on_detections: Optional[Callable] = None,
                     source_fn: Optional[Callable] = None) -> Dict:
    """Serve N independent sensor streams through ONE batched call.

    The multi-sensor serving pattern: a robot with N depth cameras (or N
    robots sharing one card) amortizes the per-dispatch cost, which
    dominates a network this small, across the batch.

    Each stream keeps its own :class:`LatestFrameMailbox` (per-sensor
    drop-oldest semantics); a dispatch fires as soon as at least one
    stream has a fresh frame, and stale slots ride along masked with
    ``num_valid=0`` (padding is inert through the whole path: the
    voxelizer sorts zero valid points to the tail and the postprocess
    emits no valid detections for that slot).

    ``on_detections(stream_idx, boxes_lidar, scores)`` fires per fresh
    slot, in dispatch order. ``source_fn(mailbox, stream_idx)`` overrides
    the per-stream producer (default: live synthetic scenes; serving
    measurements inject :func:`bank_source` so host-side scene synthesis
    doesn't masquerade as the serving ceiling).

    No reference counterpart: the reference's production loop is
    single-sensor (train.py:689-861).
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from pillars_torch.models.detector import HostFetch

    N = int(num_streams)
    device = detector.device
    variables = detector.state_to_device(variables)
    infer = detector.make_inference_fn(cfg.eval_input.anchor_area_threshold)
    maxpts = cfg.model.voxel.max_points
    eyes = torch.eye(4, dtype=torch.float32, device=device).repeat(N, 1, 1)
    min_score = cfg.runtime.prediction_min_score
    window = max(1, int(window))

    # the first B=N call BEFORE the sources start (kernel builds, cuDNN's
    # algorithm search per shape)
    infer(variables, np.zeros((N, maxpts, 3), np.float32),
          np.zeros((N,), np.int32), eyes, eyes)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    mailboxes = [LatestFrameMailbox() for _ in range(N)]
    for i, mb in enumerate(mailboxes):
        if source_fn is not None:
            source_fn(mb, i)
        else:
            synthetic_source(mb, hz, duration_s, seed=i)

    processed = np.zeros(N, np.int64)
    skipped = np.zeros(N, np.int64)
    latencies = []
    fetchers = ThreadPoolExecutor(max_workers=window)
    inflight = deque()  # (future, fresh_slots, t0), dispatch order
    staging = _Staging(window, N, maxpts, device)

    def consume(entry):
        fut, fresh, t0 = entry
        out = fut.result()
        lat_ms = (time.perf_counter() - t0) * 1e3
        for i in fresh:
            latencies.append(lat_ms)
            processed[i] += 1
            if on_detections is not None:
                keep = out.valid[i] & (out.scores[i] >= min_score)
                on_detections(i, out.boxes_lidar[i][keep],
                              out.scores[i][keep])

    t_start = time.perf_counter()
    while True:
        fresh = []  # (slot, frame, frames skipped before it)
        for i, mb in enumerate(mailboxes):
            frame, sk = mb.take(timeout=0)
            if frame is not None:
                fresh.append((i, frame, sk))
        if not fresh:
            if all(mb.closed for mb in mailboxes):
                break
            time.sleep(0.0005)
            continue
        # a buffer of its own per dispatch in flight: the copy to the card
        # of an earlier dispatch may still be pending. Stale slots keep
        # whatever the buffer held and are masked out with num_valid = 0
        # rather than re-run
        pts, handed = staging.next()
        num = np.zeros((N,), np.int32)
        for i, frame, sk in fresh:
            n = min(len(frame), maxpts)
            pts[i, :n] = frame[:n, :3]
            pts[i, n:] = 0.0
            num[i] = n
            skipped[i] += sk
        t0 = time.perf_counter()
        out = infer(variables, handed, num, eyes, eyes)
        inflight.append((fetchers.submit(HostFetch(out).result),
                         tuple(i for i, _, _ in fresh), t0))
        while len(inflight) >= window:
            consume(inflight.popleft())
    while inflight:
        consume(inflight.popleft())
    fetchers.shutdown()
    wall = time.perf_counter() - t_start
    lat = np.asarray(latencies) if latencies else np.zeros(1)
    total = int(processed.sum())
    return {
        "num_streams": N,
        "frames_processed": total,
        "per_stream_processed": [int(c) for c in processed],
        "frames_skipped": int(skipped.sum()),
        "wall_s": round(wall, 3),
        "aggregate_hz": round(total / max(wall, 1e-9), 2),
        "per_stream_hz": round(total / max(wall, 1e-9) / N, 2),
        "latency_p50_ms": round(float(np.percentile(lat, 50)), 3),
        "latency_p99_ms": round(float(np.percentile(lat, 99)), 3),
    }
