"""Publisher interface: 3D boxes / pointclouds to RVIZ, disk, or nowhere.

reference libraries/eval_helper_functions.py:73-145 (send_3d_bbox),
train.py:643-682 (topic setup: bb_pred_guess_1, bb_ground_truth,
debug_points, bb_pub_confidenceMap), load_data.py:2063-2085
(debug_save_points publishers).
"""

from __future__ import annotations

import os
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np


@dataclass
class BoxArray:
    """Detections/annotations in lidar frame: centers [N,3], dims [N,3]
    (w, l, h), yaw [N], optional confidences [N]."""

    centers: np.ndarray
    dims: np.ndarray
    yaws: np.ndarray
    confidences: Optional[np.ndarray] = None

    @classmethod
    def from_boxes7(cls, boxes: np.ndarray,
                    confidences: Optional[np.ndarray] = None) -> "BoxArray":
        boxes = np.asarray(boxes).reshape(-1, 7)
        return cls(boxes[:, :3], boxes[:, 3:6], boxes[:, 6], confidences)


class NullPublisher:
    def publish_boxes(self, topic: str, boxes: BoxArray) -> None:
        pass

    def publish_points(self, topic: str, points: np.ndarray) -> None:
        pass


class OfflinePublisher:
    """Record published topics to <out_dir>/<topic>/<seq>.pkl — replayable
    by viz/plot.py or any external viewer; replaces RVIZ for headless runs."""

    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self._seq: Dict[str, int] = {}
        os.makedirs(out_dir, exist_ok=True)

    def _path(self, topic: str) -> str:
        d = os.path.join(self.out_dir, topic)
        os.makedirs(d, exist_ok=True)
        seq = self._seq.get(topic, 0)
        self._seq[topic] = seq + 1
        return os.path.join(d, f"{seq:06d}.pkl")

    def publish_boxes(self, topic: str, boxes: BoxArray) -> None:
        with open(self._path(topic), "wb") as f:
            pickle.dump({
                "t": time.time(),
                "centers": np.asarray(boxes.centers),
                "dims": np.asarray(boxes.dims),
                "yaws": np.asarray(boxes.yaws),
                "confidences": (np.asarray(boxes.confidences)
                                if boxes.confidences is not None else None),
            }, f, 2)

    def publish_points(self, topic: str, points: np.ndarray) -> None:
        with open(self._path(topic), "wb") as f:
            pickle.dump(np.asarray(points), f, 2)


class RosPublisher:
    """jsk_recognition_msgs BoundingBoxArray publishers, matching the
    reference topics and the quaternion convention
    (eval_helper_functions.py:107-145: R.from_euler('z', -yaw))."""

    def __init__(self, frame_id: str = "camera_color_frame"):
        import rospy  # noqa: F401  (raises if ROS absent)
        import std_msgs
        from jsk_recognition_msgs.msg import BoundingBox, BoundingBoxArray
        from scipy.spatial.transform import Rotation as R
        import sensor_msgs.point_cloud2 as pc2
        from sensor_msgs.msg import PointField

        self._rospy = rospy
        self._BoundingBox = BoundingBox
        self._BoundingBoxArray = BoundingBoxArray
        self._R = R
        self._pc2 = pc2
        self._PointField = PointField
        self._std_msgs = std_msgs
        self.frame_id = frame_id
        self._pubs: Dict[str, object] = {}
        if rospy.get_node_uri() is None:
            rospy.init_node("pillars_torch", anonymous=True)

    def _pub(self, topic, msg_type):
        if topic not in self._pubs:
            self._pubs[topic] = self._rospy.Publisher(
                topic, msg_type, queue_size=10)
        return self._pubs[topic]

    def publish_boxes(self, topic: str, boxes: BoxArray) -> None:
        arr = self._BoundingBoxArray()
        header = self._std_msgs.msg.Header()
        header.stamp = self._rospy.Time.now()
        header.frame_id = self.frame_id
        arr.header = header
        for i in range(len(boxes.centers)):
            b = self._BoundingBox()
            b.header.stamp = self._rospy.Time.now()
            b.header.frame_id = self.frame_id
            b.pose.position.x = float(boxes.centers[i][0])
            b.pose.position.y = float(boxes.centers[i][1])
            b.pose.position.z = float(boxes.centers[i][2])
            q = self._R.from_euler("z", -float(boxes.yaws[i])).as_quat()
            b.pose.orientation.x = q[0]
            b.pose.orientation.y = q[1]
            b.pose.orientation.z = q[2]
            b.pose.orientation.w = q[3]
            b.dimensions.x = float(boxes.dims[i][0])
            b.dimensions.y = float(boxes.dims[i][1])
            b.dimensions.z = float(boxes.dims[i][2])
            if boxes.confidences is not None:
                b.value = max(-10.0, float(boxes.confidences[i]))
            arr.boxes.append(b)
        self._pub(topic, self._BoundingBoxArray).publish(arr)

    def publish_points(self, topic: str, points: np.ndarray) -> None:
        from sensor_msgs.msg import PointCloud2

        header = self._std_msgs.msg.Header()
        header.stamp = self._rospy.Time.now()
        header.frame_id = self.frame_id
        fields = [
            self._PointField("x", 0, self._PointField.FLOAT32, 1),
            self._PointField("y", 4, self._PointField.FLOAT32, 1),
            self._PointField("z", 8, self._PointField.FLOAT32, 1),
        ]
        msg = self._pc2.create_cloud(header, fields, points[:, :3])
        self._pub(topic, PointCloud2).publish(msg)


def confidence_map_boxes(cfg) -> BoxArray:
    """Static pillar-grid boxes for the confidence-map topic: one flat
    voxel-footprint box (0.2 m tall) per feature-map location, laid out
    over the real-world field. reference train.py:651-673 (the
    printConfidenceMap grid build; x/y swap + point_cloud_range offset).
    The reference multiplies by ``voxel_size`` directly (its config has
    out_size_factor 1); we scale by canvas/feature ratio so the grid stays
    aligned for strided configs too — viz-only, not AP-load-bearing."""
    pcr = np.asarray(cfg.model.voxel.point_cloud_range, np.float32)
    vx, vy = cfg.model.voxel.voxel_size[:2]
    nx_g, ny_g, _ = cfg.model.voxel.grid_size
    _, ny_f, nx_f = cfg.model.feature_map_size
    sx = vx * (nx_g / nx_f)
    sy = vy * (ny_g / ny_f)
    jj, ii = np.meshgrid(np.arange(nx_f), np.arange(ny_f))  # x-fast like ref
    centers = np.stack([
        jj.ravel() * sx + pcr[0],
        ii.ravel() * sy + pcr[1],
        np.zeros(nx_f * ny_f, np.float32)], axis=1).astype(np.float32)
    dims = np.tile(np.array([sx, sy, 0.2], np.float32), (len(centers), 1))
    yaws = np.zeros(len(centers), np.float32)
    return BoxArray(centers, dims, yaws)


def publish_reference_topics(pub, *, points: Optional[np.ndarray] = None,
                             pred_boxes: Optional[np.ndarray] = None,
                             pred_scores: Optional[np.ndarray] = None,
                             gt_boxes: Optional[np.ndarray] = None,
                             candidate_boxes: Optional[np.ndarray] = None,
                             cls_scores: Optional[np.ndarray] = None,
                             cfg=None) -> None:
    """Emit one frame on the reference's RVIZ topic set (the live-ROS
    contract, pinned headlessly via OfflinePublisher in
    tests/test_viz_capture.py):

    - ``debug_points``        raw cloud      (reference load_data.py:2071)
    - ``bb_pred_guess_1``     predictions    (reference train.py:677,828)
    - ``bb_ground_truth``     annotations    (reference
                              scripts/rviz_show_predictions.py:295)
    - ``debug_load_data_bb``  capture/candidate boxes
                              (reference load_data.py:2072,2099)
    - ``bb_pub_confidenceMap`` per-location class scores on the static
                              pillar grid (reference train.py:648,804-808;
                              pass raw head scores — the reference sends
                              logits straight through as box ``value``)

    Every argument is optional: only the provided topics publish, so the
    streaming path (no gt available) and the capture path (no predictions)
    share this one contract point."""
    if points is not None:
        pub.publish_points("debug_points", np.asarray(points))
    if pred_boxes is not None:
        pub.publish_boxes("bb_pred_guess_1",
                          BoxArray.from_boxes7(pred_boxes, pred_scores))
    if gt_boxes is not None:
        pub.publish_boxes("bb_ground_truth", BoxArray.from_boxes7(gt_boxes))
    if candidate_boxes is not None:
        pub.publish_boxes("debug_load_data_bb",
                          BoxArray.from_boxes7(candidate_boxes))
    if cls_scores is not None:
        if cfg is None:
            raise ValueError("cls_scores needs cfg for the pillar grid")
        grid = confidence_map_boxes(cfg)
        scores = np.asarray(cls_scores).reshape(-1)
        if len(scores) != len(grid.centers):
            raise ValueError(
                f"cls_scores has {len(scores)} entries, feature map has "
                f"{len(grid.centers)} locations")
        pub.publish_boxes("bb_pub_confidenceMap", BoxArray(
            grid.centers, grid.dims, grid.yaws, scores))


REFERENCE_TOPIC_SET = frozenset({
    "debug_points", "bb_pred_guess_1", "bb_ground_truth",
    "debug_load_data_bb", "bb_pub_confidenceMap"})


def make_publisher(kind: str = "auto", out_dir: Optional[str] = None):
    """kind: 'ros' | 'offline' | 'null' | 'auto' (ros if available, else
    offline when out_dir given, else null)."""
    if kind in ("ros", "auto"):
        try:
            return RosPublisher()
        except Exception:
            if kind == "ros":
                raise
    if kind in ("offline", "auto") and out_dir:
        return OfflinePublisher(out_dir)
    return NullPublisher()
