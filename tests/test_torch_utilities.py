"""The last utilities of the port against the JAX package's:

- ``geometry/rotated_iou.py::rotated_iou_torch`` against ``rotated_iou_jax``
  on the boxes of tests/test_geometry.py's ``test_jax_matches_numpy`` case,
  within 1e-5, and its three criteria on the case of ``test_criteria``;
- ``utils/profiling.py::profiler_trace`` writes a Chrome trace on the CPU;
- ``PillarsDetector.profile_stages`` returns the JAX package's three stage
  names on a card (``cuda``-marked) and raises on the CPU, like the other
  card-only timers.
"""

import json

import numpy as np
import pytest
import torch

from pillars_torch.geometry.rotated_iou import (rotated_iou_np,
                                                rotated_iou_torch)

IOU_ATOL = 1e-5
STAGES = {"t_voxel_features", "t_spatial_features_plus_rpn", "t_nms_func"}


def _boxes(rng, n):
    return np.stack([
        rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
        rng.uniform(0.5, 2, n), rng.uniform(0.5, 2, n),
        rng.uniform(-np.pi, np.pi, n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("criterion", [-1, 0, 1, 2])
def test_rotated_iou_torch_matches_jax(rng, criterion):
    import jax.numpy as jnp

    from pillars_tpu.geometry.rotated_iou import rotated_iou_jax

    b1, b2 = _boxes(rng, 12), _boxes(rng, 9)
    want = np.asarray(rotated_iou_jax(jnp.array(b1), jnp.array(b2),
                                      criterion=criterion))
    got = rotated_iou_torch(torch.tensor(b1), torch.tensor(b2), criterion)
    assert got.dtype == torch.float32 and got.shape == (12, 9)
    assert (want > 0).sum() > 5  # overlapping pairs, not only zeros
    np.testing.assert_allclose(got.numpy(), want, atol=IOU_ATOL, rtol=0)
    np.testing.assert_allclose(
        rotated_iou_torch(torch.tensor(b1, dtype=torch.float64),
                          torch.tensor(b2, dtype=torch.float64),
                          criterion).numpy(),
        rotated_iou_np(b1, b2, criterion), atol=1e-6)


def test_rotated_iou_torch_criteria():
    b1 = torch.tensor([[0.0, 0.0, 2.0, 2.0, 0.0]])
    b2 = torch.tensor([[1.0, 0.0, 2.0, 2.0, 0.0]])
    assert float(rotated_iou_torch(b1, b2, 2)[0, 0]) == pytest.approx(
        2.0, abs=1e-5)
    for criterion in (0, 1):
        assert float(rotated_iou_torch(b1, b2, criterion)[0, 0]) == (
            pytest.approx(0.5, abs=1e-5))
    assert float(rotated_iou_torch(b1, b2)[0, 0]) == pytest.approx(
        1 / 3, abs=1e-5)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    from pillars_torch.utils.profiling import profiler_trace

    with profiler_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::matmul" in names or "aten::mm" in names


def _inputs(det, device):
    from torch_parity import d435i_clouds

    pts, num = d435i_clouds(0, 1, det.config.model.voxel.max_points, 3000)
    eye = torch.eye(4)[None]
    state = det.init(torch.Generator().manual_seed(0))
    return state, torch.as_tensor(pts), torch.as_tensor(num), eye, eye


def test_profile_stages_raises_on_the_cpu():
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector

    det = PillarsDetector(Config.default(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA events"):
        det.profile_stages(*_inputs(det, "cpu"), iters=2)


@pytest.mark.cuda
def test_profile_stages_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pillars_torch.config import Config
    from pillars_torch.models.detector import PillarsDetector

    det = PillarsDetector(Config.default())
    state, pts, num, rect, trv2c = _inputs(det, "cuda")
    got = det.profile_stages(det.state_to_device(state), pts, num, rect,
                             trv2c, iters=3)
    assert set(got) == STAGES
    assert all(v > 0 for v in got.values())
