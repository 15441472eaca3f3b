"""ctypes loader for the native geometry library (csrc/geometry_ops.cc): the
port's own copy of pillars_tpu/native, bound to the same root ``csrc/``. Host
geometry of the evaluator, not a device kernel.

Replaces the reference's on-demand pybind11/nvcc build harness
(second/utils/buildtools/pybind11_build.py:76-115): on first use we invoke
``make`` in csrc/ if the shared object is missing, then bind through ctypes.
Everything degrades gracefully to the NumPy implementations when no
toolchain is available.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()

_CSRC = pathlib.Path(__file__).resolve().parent.parent.parent / "csrc"
_SO = _CSRC / "libpillars_native.so"


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_CSRC)], check=True,
                       capture_output=True, timeout=120)
        return _SO.exists()
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None.

    A stale pre-existing .so that predates a symbol (AttributeError at
    bind time) triggers ONE rebuild; any remaining failure degrades to
    None so callers fall back to the NumPy paths."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not _SO.exists() and not _build():
            return None
        try:
            _LIB = _bind(ctypes.CDLL(str(_SO)))
        except (OSError, AttributeError):
            _LIB = None
            if _build():
                try:
                    _LIB = _bind(ctypes.CDLL(str(_SO)))
                except (OSError, AttributeError):
                    _LIB = None
        return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every ctypes signature. Raises AttributeError if the .so
    is missing a symbol (stale build from an older csrc/)."""
    lib.rotated_overlap_matrix.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
    lib.rotated_overlap_matrix.restype = None
    lib.nms_standup.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.c_float, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.nms_standup.restype = ctypes.c_int64
    _d = ctypes.POINTER(ctypes.c_double)
    _i = ctypes.POINTER(ctypes.c_int64)
    lib.eval_match_scores_batch.argtypes = [
        _d, _i, _d, _i, _d, _i, _i, _i,
        ctypes.c_int64, ctypes.c_int, ctypes.c_double, _d, _i]
    lib.eval_match_scores_batch.restype = None
    lib.eval_fused_statistics_batch.argtypes = [
        _d, _i, _d, _i, _d, _i, _i, _i, _d, _i,
        ctypes.c_int64, ctypes.c_int, ctypes.c_double,
        _d, ctypes.c_int64, ctypes.c_int, _d]
    lib.eval_fused_statistics_batch.restype = None
    return lib


def available() -> bool:
    return load() is not None


def rotated_overlap_matrix(boxes1: np.ndarray, boxes2: np.ndarray,
                           criterion: int = -1) -> Optional[np.ndarray]:
    """[N,5] x [K,5] -> [N,K] float32, or None if the library is missing."""
    lib = load()
    if lib is None:
        return None
    b1 = np.ascontiguousarray(boxes1, dtype=np.float32)
    b2 = np.ascontiguousarray(boxes2, dtype=np.float32)
    n, k = b1.shape[0], b2.shape[0]
    out = np.empty((n, k), dtype=np.float32)
    if n and k:
        lib.rotated_overlap_matrix(
            b1.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            b2.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), k,
            criterion, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def nms_standup(boxes_sorted: np.ndarray, iou_threshold: float,
                post_max: int) -> Optional[np.ndarray]:
    """Greedy NMS over score-sorted [N,4] standup boxes -> kept indices."""
    lib = load()
    if lib is None:
        return None
    b = np.ascontiguousarray(boxes_sorted, dtype=np.float32)
    keep = np.empty((b.shape[0],), dtype=np.int64)
    n = lib.nms_standup(
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b.shape[0],
        iou_threshold, post_max,
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return keep[:n]


def _ptr_d(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _ptr_i(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


class EvalFrames:
    """Flattened per-frame eval inputs for the native greedy matcher
    (csrc/eval_matcher.cc — the reference's numba compute_statistics_jit /
    fused_compute_statistics, eval.py:166-345, as batched C++).

    Built once per (class, difficulty) in kitti_ap.eval_class and reused
    for all min_overlap levels and both matcher phases.
    """

    def __init__(self, overlaps, gt_datas, dt_datas, ignored_gts,
                 ignored_dets, dontcares, ov_flat=None):
        n = len(gt_datas)
        self.num_frames = n
        ngt = np.array([g.shape[0] for g in gt_datas], dtype=np.int64)
        ndt = np.array([d.shape[0] for d in dt_datas], dtype=np.int64)
        ndc = np.array([c.shape[0] for c in dontcares], dtype=np.int64)
        self.gt_off = np.zeros(n + 1, np.int64)
        np.cumsum(ngt, out=self.gt_off[1:])
        self.dt_off = np.zeros(n + 1, np.int64)
        np.cumsum(ndt, out=self.dt_off[1:])
        self.dc_off = np.zeros(n + 1, np.int64)
        np.cumsum(ndc, out=self.dc_off[1:])
        if ov_flat is not None:  # precomputed once per metric (eval_class)
            self.ov, self.ov_off = ov_flat
        else:
            self.ov, self.ov_off = flatten_overlaps(overlaps)
        assert self.ov_off.shape[0] == n + 1
        self.gt = _concat_flat(gt_datas, 5)
        self.dt = _concat_flat(dt_datas, 6)
        self.igt = _concat_flat(ignored_gts, 1, np.int64)
        self.idt = _concat_flat(ignored_dets, 1, np.int64)
        self.dc = _concat_flat(dontcares, 4)

    def match_scores(self, metric: int, min_overlap: float) -> np.ndarray:
        """Phase 1: concatenated matched-TP scores across frames."""
        lib = load()
        scores = np.empty(int(self.gt_off[-1]), np.float64)
        counts = np.empty(self.num_frames, np.int64)
        lib.eval_match_scores_batch(
            _ptr_d(self.ov), _ptr_i(self.ov_off), _ptr_d(self.gt),
            _ptr_i(self.gt_off), _ptr_d(self.dt), _ptr_i(self.dt_off),
            _ptr_i(self.igt), _ptr_i(self.idt), self.num_frames,
            int(metric), float(min_overlap), _ptr_d(scores), _ptr_i(counts))
        out = [scores[self.gt_off[i]:self.gt_off[i] + counts[i]]
               for i in range(self.num_frames)]
        return np.concatenate(out) if out else np.zeros(0)

    def fused_statistics(self, metric: int, min_overlap: float,
                         thresholds: np.ndarray,
                         compute_aos: bool) -> np.ndarray:
        """Phase 2: pr [num_thresholds, 4] = (tp, fp, fn, similarity)."""
        lib = load()
        thr = np.ascontiguousarray(thresholds, np.float64)
        pr = np.zeros((thr.shape[0], 4), np.float64)
        lib.eval_fused_statistics_batch(
            _ptr_d(self.ov), _ptr_i(self.ov_off), _ptr_d(self.gt),
            _ptr_i(self.gt_off), _ptr_d(self.dt), _ptr_i(self.dt_off),
            _ptr_i(self.igt), _ptr_i(self.idt), _ptr_d(self.dc),
            _ptr_i(self.dc_off), self.num_frames, int(metric),
            float(min_overlap), _ptr_d(thr), thr.shape[0],
            int(compute_aos), _ptr_d(pr))
        return pr


def _concat_flat(arrays, width, dtype=np.float64):
    """Concatenate per-frame row arrays into one flat buffer, validating
    the row width the C++ side indexes with a fixed stride (e.g.
    f.dt[j*6+5]) — a wrong column count must fail fast here, not silently
    misalign the native matcher."""
    if not arrays:
        return np.zeros(0, dtype)
    flat = []
    for a in arrays:
        a = np.ascontiguousarray(a, dtype)
        assert a.size == 0 or (a.ndim == 2 and a.shape[1] == width) \
            or (width == 1 and a.ndim == 1), (
            f"expected [n, {width}] rows, got shape {a.shape}")
        flat.append(a.reshape(-1))
    return np.ascontiguousarray(np.concatenate(flat))


def flatten_overlaps(overlaps):
    """Flatten per-frame [ndt, ngt] overlap matrices into one contiguous
    float64 buffer plus ELEMENT offsets (len = num_frames + 1).

    eval_class calls this once per metric and shares the result across all
    (class, difficulty, min_overlap) EvalFrames — the matrices themselves
    never change within a metric.
    """
    n = len(overlaps)
    off = np.zeros(n + 1, np.int64)
    if n:
        np.cumsum([o.size for o in overlaps], out=off[1:])
        flat = np.concatenate(
            [np.ascontiguousarray(o, np.float64).reshape(-1)
             for o in overlaps])
    else:
        flat = np.zeros(0, np.float64)
    return flat, off
