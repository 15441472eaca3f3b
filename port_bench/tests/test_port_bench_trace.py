"""The reduction of a traced window to the per-layer metrics' inputs, on
events made up for the purpose (the trace itself is the card's)."""

import pytest

from port_bench.trace import WINDOW, summarize


def _ev(name, dev, s, e, tid=1):
    return (name, dev, s, e, tid)


def test_busy_union_gaps_and_labels():
    events = [
        _ev(WINDOW, False, 1000, 11000),
        _ev("host_wait", False, 0, 20000, 7),
        _ev("stage", False, 3500, 5500, 1),
        _ev("k1", True, 900, 2000),      # starts before the window
        _ev("k2", True, 1500, 3000),     # overlaps k1
        _ev("nms_keep_mask_kernel", True, 6000, 6500),
        _ev("Memcpy HtoD (Pinned -> Device)", True, 6500, 7000),
        _ev("ncclDevKernel_AllReduce", True, 9000, 12000),  # runs past it
    ]
    s = summarize(events)
    assert s["window_s"] == pytest.approx(10000 / 1e9)
    busy = (3000 - 1000) + (7000 - 6000) + (11000 - 9000)
    assert s["busy_s"] == pytest.approx(busy / 1e9)
    assert s["device_s"] == pytest.approx((1000 + 1500 + 500 + 500 + 2000)
                                          / 1e9)
    assert s["kernels"] == 4  # the copy is no kernel
    assert s["nms_launches"] == 1 and s["nms_s"] == pytest.approx(500 / 1e9)
    assert s["nccl_kernels"] == 1
    gaps = s["idle_gaps"]
    assert [g[1] for g in gaps] == pytest.approx([3000 / 1e9, 2000 / 1e9])
    assert gaps[0][0].startswith("stage")       # innermost at 4500
    assert gaps[1][0].startswith("host_wait")   # only host_wait at 8000
    assert s["device_ops"][0][0] == "ncclDevKernel_AllReduce"


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError):
        summarize([_ev("k", True, 0, 1)])
