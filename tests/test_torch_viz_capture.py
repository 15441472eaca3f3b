"""The port's capture tool (pillars_torch/data/capture.py) and matplotlib
plots (pillars_torch/viz/plot.py) against the JAX package's
(tests/test_viz_capture.py's TestCapture and TestPlot): on the same
NumPy-seeded frames and keys the same files, byte for byte, and the same
session statistics; on the same inputs the same PNG bytes."""

import os
import pickle

import numpy as np
import pytest

from pillars_torch.data import capture
from pillars_torch.viz import BoxArray, OfflinePublisher
from pillars_torch.viz import plot
from pillars_tpu.data import capture as jcapture
from pillars_tpu.viz import plot as jplot


def _tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _record(data):
    """An OfflinePublisher record without its wall-clock stamp."""
    rec = pickle.loads(data)
    if isinstance(rec, dict):
        rec.pop("t", None)
        return rec
    return {"points": rec}


class TestPlot:
    def _both(self, tmp_path, fn, jfn, *args, **kwargs):
        out, jout = str(tmp_path / "port.png"), str(tmp_path / "jax.png")
        fn(*args, save_path=out, **kwargs)
        jfn(*args, save_path=jout, **kwargs)
        assert os.path.getsize(out) > 1000
        with open(out, "rb") as a, open(jout, "rb") as b:
            assert a.read() == b.read()

    def test_bev_png(self, tmp_path, rng):
        pts = rng.uniform(-1, 5, (500, 3)).astype(np.float32)
        gt = np.array([[2, 0, -1.4, 0.6, 0.8, 1.7, 0.2]], np.float32)
        self._both(tmp_path, plot.plot_bev, jplot.plot_bev, points=pts,
                   gt_boxes=gt, pred_boxes=gt, scores=np.array([0.8]))

    def test_confidence_map(self, tmp_path, rng):
        cls = rng.randn(64, 80, 2).astype(np.float32)
        self._both(tmp_path, plot.confidence_map, jplot.confidence_map, cls,
                   (0, -2.56, -3, 6.4, 2.56, 3), (0.08, 0.08, 4.0))

    def test_replay_offline_topic(self, tmp_path):
        pub = OfflinePublisher(str(tmp_path / "rec"))
        boxes = BoxArray.from_boxes7(
            np.array([[2, 0, -1.4, 0.6, 0.8, 1.7, 0.2]], np.float32))
        pub.publish_boxes("preds", boxes)
        pub.publish_points("preds", np.zeros((20, 3), np.float32))
        outs = plot.replay_offline_topic(str(tmp_path / "rec" / "preds"),
                                         str(tmp_path / "png"))
        jouts = jplot.replay_offline_topic(str(tmp_path / "rec" / "preds"),
                                           str(tmp_path / "jpng"))
        assert len(outs) == 2 and all(os.path.exists(p) for p in outs)
        for a, b in zip(outs, jouts):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()


class TestCapture:
    def test_d435i_transform(self, rng):
        pts = np.array([[0.0, 0.0, 2.0]] * 4, np.float32)
        out = capture.d435i_to_lidar(pts, subsample=1)
        np.testing.assert_allclose(out[0], [2.0, 0.0, 1.0], atol=1e-5)
        assert len(capture.d435i_to_lidar(np.repeat(pts, 2, 0),
                                          subsample=4)) == 2
        cloud = rng.uniform(-3, 3, (1001, 3)).astype(np.float32)
        np.testing.assert_array_equal(capture.d435i_to_lidar(cloud),
                                      jcapture.d435i_to_lidar(cloud))

    def test_annotation_session_keys(self):
        s, js = capture.AnnotationSession(), jcapture.AnnotationSession()
        for key in "wwsadqqqqeeeeeeeeeeeeeeeeeeeeeerfx":
            s.apply(key)
            js.apply(key)
            np.testing.assert_array_equal(s.box.as_array(),
                                          js.box.as_array())
        assert -np.pi <= s.box.yaw <= np.pi

    def test_predefined_capture_writes_dataset(self, tmp_path, rng):
        frames = [rng.uniform(-1, 1, (400, 3)).astype(np.float32)
                  for _ in range(16)]
        n = capture.capture_predefined(frames, str(tmp_path / "port"),
                                       every_nth=4, already_lidar=True)
        jn = jcapture.capture_predefined(frames, str(tmp_path / "jax"),
                                         every_nth=4, already_lidar=True)
        assert n == jn == 4
        got = _tree_bytes(tmp_path / "port")
        assert len(got) == 12
        assert got == _tree_bytes(tmp_path / "jax")
        from pillars_torch.data.kitti_infos import get_label_anno

        rots = [float(get_label_anno(str(
            tmp_path / "port" / "training" / "label_2" / f"{i:06d}.txt"))
            ["rotation_y"][0]) for i in range(4)]
        assert len(set(np.round(rots, 3))) == 4

    def test_capture_is_ingestible(self, tmp_path, rng):
        from pillars_torch.data import kitti_infos as ki

        frames = [rng.uniform(0.5, 3.0, (300, 3)).astype(np.float32)
                  for _ in range(4)]
        capture.capture_predefined(frames, str(tmp_path), every_nth=1,
                                   already_lidar=True)
        with open(ki.create_info_file(str(tmp_path), list(range(4))),
                  "rb") as f:
            infos = pickle.load(f)
        assert len(infos) == 4
        assert infos[0]["annos"]["name"][0] == "Pedestrian"

    @pytest.mark.parametrize("keys", [list("www") + ["q", "\n", "m", "h"],
                                      ["\n", "z", "w", "w", "\n", "x"]])
    def test_annotate_scripted_keys(self, tmp_path, rng, keys):
        """Unannotated capture, then the keyboard session on the same keys:
        the same statistics, the same label and calib files, the same
        publishes on the reference topics."""
        frames = [rng.uniform(0.5, 3.0, (200, 3)).astype(np.float32)
                  for _ in range(3)]
        results = []
        for mod, name in ((capture, "port"), (jcapture, "jax")):
            root = str(tmp_path / name)
            assert mod.capture_unannotated(frames, root,
                                           already_lidar=True) == 3
            pub = OfflinePublisher(str(tmp_path / f"{name}_topics"))
            stats = mod.annotate_dataset(root, keys, split="testing",
                                         publisher=pub)
            topics = {k: _record(v) for k, v in
                      _tree_bytes(tmp_path / f"{name}_topics").items()}
            results.append((stats, _tree_bytes(root), topics))
        assert results[0][:2] == results[1][:2]
        stats, files, topics = results[0]
        assert topics.keys() == results[1][2].keys()
        for k, v in topics.items():
            w = results[1][2][k]
            assert v.keys() == w.keys(), k
            for field in v:
                np.testing.assert_array_equal(v[field], w[field], err_msg=k)
        assert stats["annotated"] >= 1
        assert {p.split(os.sep)[0] for p in topics} == {
            "debug_points", "debug_load_data_bb"}
