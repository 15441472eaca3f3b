"""The port's analytic FLOP and byte counts (pillars_torch/utils/roofline.py)
against the JAX package's (pillars_tpu/utils/roofline.py): every stage of
``detector_cost`` equal, for ``Config.default()``, the fast config and
``second_sparse_d435i`` at B=1 and B=2, and the placement on the H100's
published peaks."""

import pathlib

import pytest

from pillars_torch.config import Config as TorchConfig
from pillars_torch.utils import roofline as rf
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.utils import roofline as jax_rf
from torch_parity import fast_config

ROOT = pathlib.Path(__file__).resolve().parent.parent

CONFIGS = {
    "default": lambda cls: cls.default(),
    "fast": lambda cls: fast_config(cls.default()),
    "second_sparse_d435i": lambda cls: cls.from_yaml(
        str(ROOT / "configs" / "second_sparse_d435i.yaml")),
}


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stage_costs_equal_jax(name, batch):
    got = rf.detector_cost(CONFIGS[name](TorchConfig), batch)
    want = jax_rf.detector_cost(CONFIGS[name](JaxConfig), batch)
    assert list(got) == list(want)
    for stage in want:
        assert (got[stage].flops, got[stage].bytes) == (
            want[stage].flops, want[stage].bytes), stage
    assert got["total"].flops > 0


def test_report_on_the_h100():
    cfg = TorchConfig.default()
    peaks = rf.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks.name == "h100" and peaks.f32_flops == 67e12
    assert rf.device_peaks("NVIDIA H100 PCIe").hbm_bytes == 2.0e12
    assert rf.device_peaks("Tesla V100-SXM2-16GB") is None
    rep = rf.roofline_report(cfg, 1.24, device_name="NVIDIA H100 80GB HBM3")
    total = rf.detector_cost(cfg)["total"]
    bound = max(total.flops / 67e12, total.bytes / 3.35e12) * 1e3
    assert rep["bound_ms"] == pytest.approx(bound)
    assert rep["bound_by"] == "operations"
    assert rep["bound"] == "latency"
    bf16 = rf.roofline_report(cfg, 1.24, device_name="NVIDIA H100 80GB HBM3",
                              dtype_bytes=2)
    assert bf16["peak_flops"] == 989e12
    unknown = rf.roofline_report(cfg, 1.24, device_name="some other card")
    assert unknown["bound_ms"] is None and unknown["flops"] == total.flops
