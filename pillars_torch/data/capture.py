"""Dataset capture + semi-automatic annotation (a copy of
pillars_tpu/data/capture.py; ``d435i_to_lidar`` is data/stream.py's).

Rebuild of the reference's scripts/realsense_make_dataset.py (862 LoC):
a ROS listener with three modes —
  1. live buffered capture (dump unannotated clouds),
  2. the "few-annotation trick": save every Nth cloud paired with ONE of 8
     predefined box rotations, the operator standing at a marked pose
     (reference README.md:102-126, realsense_make_dataset.py:212-543),
  3. keyboard-driven 3D box annotation against RVIZ
     (callback_real_annotation_anno, :622-801).

Here the sensor is abstracted behind a frame-source callable (the ROS
subscriber plugs in where available; replay/synthetic sources work
headless), the d435i image->lidar transform is reproduced exactly, and the
annotation session is a programmatic API (drive it from keyboard, notebook,
or scripted poses).
"""

from __future__ import annotations

import dataclasses
import pathlib
import pickle
from typing import Iterable, Optional, Sequence

import numpy as np

from pillars_torch.data.stream import d435i_to_lidar  # noqa: F401


# the 8 predefined capture rotations of the few-annotation trick
# (reference realsense_make_dataset.py: fixed annotation at 8 known
# rotations, pi/4 apart)
PREDEFINED_ROTATIONS = tuple(np.arange(8) * (np.pi / 4))


@dataclasses.dataclass
class AnnotationBox:
    """One lidar-frame annotation, matching the reference's fixed pedestrian
    box (w, l, h defaults from the predefined-annotation capture)."""

    x: float = 2.0
    y: float = 0.0
    z: float = -1.45
    w: float = 0.6
    l: float = 0.8
    h: float = 1.73
    yaw: float = 0.0

    def as_array(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z, self.w, self.l, self.h,
                         self.yaw], dtype=np.float32)


class AnnotationSession:
    """Keyboard-style incremental box editing (reference wasd/qe bindings,
    realsense_make_dataset.py:744-801; up/down there move the vertical axis —
    bound to r/f here so a plain terminal suffices). Drive with .apply('w')
    etc. or set fields directly. Yaw wraps to [-pi, pi] like the reference's
    q/e handlers."""

    STEP_POS = 0.05
    STEP_ROT = np.pi / 16

    EDIT_KEYS = "wsadqerf"

    def __init__(self, box: Optional[AnnotationBox] = None):
        self.box = box or AnnotationBox()

    def apply(self, key: str) -> AnnotationBox:
        b = self.box
        if key == "w":
            b.x += self.STEP_POS
        elif key == "s":
            b.x -= self.STEP_POS
        elif key == "a":
            b.y += self.STEP_POS
        elif key == "d":
            b.y -= self.STEP_POS
        elif key == "q":
            b.yaw += self.STEP_ROT
            if b.yaw > np.pi:
                b.yaw -= 2 * np.pi
        elif key == "e":
            b.yaw -= self.STEP_ROT
            if b.yaw < -np.pi:
                b.yaw += 2 * np.pi
        elif key == "r":
            b.z += self.STEP_POS
        elif key == "f":
            b.z -= self.STEP_POS
        return b


class DatasetWriter:
    """Write clouds + annotations in the reference's on-disk layout
    (training/velodyne/*.pkl + label_2/*.txt + calib/*.txt)."""

    def __init__(self, root: str, training: bool = True):
        from pillars_torch.data.synthetic import RECT, VELO2CAM, _write_calib

        self.root = pathlib.Path(root)
        self.sub = "training" if training else "testing"
        for d in ("velodyne", "label_2", "calib"):
            (self.root / self.sub / d).mkdir(parents=True, exist_ok=True)
        self._rect = RECT
        self._velo2cam = VELO2CAM
        self._write_calib = _write_calib
        self.index = 0

    def write(self, points: np.ndarray,
              boxes_lidar: Optional[np.ndarray] = None) -> int:
        from pillars_torch.data.synthetic import _write_kitti_label

        sid = "%06d" % self.index
        with open(self.root / self.sub / "velodyne" / f"{sid}.pkl", "wb") as f:
            pickle.dump(np.asarray(points, dtype=np.float32), f, 2)
        boxes = (np.asarray(boxes_lidar, dtype=np.float32).reshape(-1, 7)
                 if boxes_lidar is not None else np.zeros((0, 7), np.float32))
        _write_kitti_label(self.root / self.sub / "label_2" / f"{sid}.txt",
                           boxes)
        self._write_calib(self.root / self.sub / "calib" / f"{sid}.txt")
        self.index += 1
        return self.index - 1


def capture_predefined(frames: Iterable[np.ndarray], root: str,
                       every_nth: int = 4,
                       base_box: Optional[AnnotationBox] = None,
                       rotations: Sequence[float] = PREDEFINED_ROTATIONS,
                       already_lidar: bool = False,
                       max_frames: Optional[int] = None) -> int:
    """Few-annotation capture: save every Nth frame with the predefined box
    at a cycling rotation (reference 'live_mode_off' path). Returns number
    of saved samples."""
    writer = DatasetWriter(root, training=True)
    box = base_box or AnnotationBox()
    saved = 0
    for i, frame in enumerate(frames):
        if i % every_nth:
            continue
        pts = frame if already_lidar else d435i_to_lidar(frame)
        b = box.as_array().copy()
        b[6] = rotations[saved % len(rotations)]
        writer.write(pts, b[None])
        saved += 1
        if max_frames and saved >= max_frames:
            break
    return saved


def capture_unannotated(frames: Iterable[np.ndarray], root: str,
                        already_lidar: bool = False,
                        max_frames: Optional[int] = None) -> int:
    """Live buffered capture without annotations (reference 'live_mode_on')."""
    writer = DatasetWriter(root, training=False)
    saved = 0
    for frame in frames:
        pts = frame if already_lidar else d435i_to_lidar(frame)
        writer.write(pts, None)
        saved += 1
        if max_frames and saved >= max_frames:
            break
    return saved


# ---------------------------------------------------------------------------
# Interactive annotation (reference callback_real_annotation_anno,
# realsense_make_dataset.py:622-801): walk the saved clouds of a split,
# publish each cloud + the candidate box for live visual feedback, edit the
# box from the keyboard, and commit per-frame KITTI labels.
# ---------------------------------------------------------------------------

COMMIT_KEYS = ("\r", "\n", "enter")   # reference: enter -> save_anno()
BACK_KEY = "z"                        # reference: z -> counter -= 2 (net -1)
SKIP_KEY = "h"                        # reference: h -> next, nothing written
EMPTY_KEY = "m"                       # reference: m -> save_anno(empty=True)
QUIT_KEY = "x"                        # new: clean exit (reference: ctrl-c)


def stdin_key_source():
    """Yield single keypresses. On a TTY, switches stdin to cbreak (raw)
    mode so keys arrive without Enter; otherwise reads stdin byte-wise
    (piped scripts — a newline then acts as the commit key, so a line of
    edits ends with a commit, matching COMMIT_KEYS)."""
    import sys

    if sys.stdin.isatty():
        import termios
        import tty

        fd = sys.stdin.fileno()
        old = termios.tcgetattr(fd)
        try:
            tty.setcbreak(fd)
            while True:
                ch = sys.stdin.read(1)
                if not ch:
                    return
                yield ch
        finally:
            termios.tcsetattr(fd, termios.TCSADRAIN, old)
    else:
        while True:
            ch = sys.stdin.read(1)
            if not ch:
                return
            yield ch


def annotate_dataset(root: str, keys: Iterable[str], split: str = "training",
                     publisher=None, start_idx: int = 0,
                     session: Optional[AnnotationSession] = None,
                     verbose: bool = False) -> dict:
    """Interactive annotation REPL over the saved clouds of ``root/split``.

    Reference semantics (realsense_make_dataset.py:622-801): clouds are the
    sorted ``velodyne/*.pkl`` of the split; the candidate box PERSISTS
    across frames (consecutive captures move little, so each frame starts
    from the previous answer — the tool's whole "semi-automatic" point);
    every edit republishes the box; enter commits the current box as the
    frame's label (+calib), ``m`` commits an empty label, ``h`` moves on
    without writing, ``z`` steps back one frame, ``x``/EOF ends the
    session. Edits are AnnotationSession keys (wasd move, q/e yaw with
    [-pi, pi] wrap, r/f vertical).

    ``keys``: any iterable of key strings — ``stdin_key_source()`` for a
    live terminal, a list for scripted tests. ``publisher``: a
    viz.publisher-style object; clouds go to ``debug_points`` and candidate
    boxes to ``debug_load_data_bb`` (the reference's topics). Returns
    ``{"annotated": n, "empty": n, "skipped": n, "last_index": i}``.
    """
    from pillars_torch.data.synthetic import _write_calib, _write_kitti_label
    from pillars_torch.viz.publisher import BoxArray, NullPublisher

    pub = publisher or NullPublisher()
    session = session or AnnotationSession()
    rootp = pathlib.Path(root)
    cloud_dir = rootp / split / "velodyne"
    label_dir = rootp / split / "label_2"
    calib_dir = rootp / split / "calib"
    label_dir.mkdir(parents=True, exist_ok=True)
    calib_dir.mkdir(parents=True, exist_ok=True)
    sids = sorted(p.stem for p in cloud_dir.glob("*.pkl"))
    if not sids:
        raise FileNotFoundError(f"no clouds under {cloud_dir}")

    def _publish_box():
        pub.publish_boxes("debug_load_data_bb", BoxArray.from_boxes7(
            session.box.as_array()[None]))

    def _commit(sid: str, empty: bool) -> None:
        boxes = (np.zeros((0, 7), np.float32) if empty
                 else session.box.as_array()[None])
        _write_kitti_label(label_dir / f"{sid}.txt", boxes)
        _write_calib(calib_dir / f"{sid}.txt")

    stats = {"annotated": 0, "empty": 0, "skipped": 0, "last_index": start_idx}
    key_it = iter(keys)
    i = max(0, int(start_idx))
    published = -1
    while i < len(sids):
        sid = sids[i]
        if published != i:
            with open(cloud_dir / f"{sid}.pkl", "rb") as f:
                pub.publish_points("debug_points",
                                   np.asarray(pickle.load(f), np.float32))
            _publish_box()
            published = i
            if verbose:
                b = session.box
                print(f"[annotate] frame {sid} ({i + 1}/{len(sids)}) box "
                      f"x={b.x:.2f} y={b.y:.2f} z={b.z:.2f} yaw={b.yaw:.2f} "
                      f"| wasd/qe/rf edit, enter save, m empty, h skip, "
                      f"z back, x quit")
        key = next(key_it, None)
        if key is None or key == QUIT_KEY:
            break
        if key in COMMIT_KEYS:
            _commit(sid, empty=False)
            stats["annotated"] += 1
            i += 1
        elif key == EMPTY_KEY:
            _commit(sid, empty=True)
            stats["empty"] += 1
            i += 1
        elif key == SKIP_KEY:
            stats["skipped"] += 1
            i += 1
        elif key == BACK_KEY:
            i = max(0, i - 1)
            published = -1
        elif key in AnnotationSession.EDIT_KEYS:
            session.apply(key)
            _publish_box()
    stats["last_index"] = i
    return stats
