"""The control must fail the comparison: the reference computed with TF32
on, put in the program's place, reads a detection gap above each cell's
limit, at the cell's own bank size, on three seeds. Card only:

    python -m pytest port_bench/tests/test_port_bench_control.py -m cuda
"""

import pytest

from port_bench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("wl", CELLS)
def test_the_tf32_control_is_not_correct(wl):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control needs the card: the CPU computes no TF32")
    from port_bench.control import control_gap

    limit = harness.limits_file(wl)["limits"]["detection_gap"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        gap = control_gap(wl, seed)["detection_gap"]
        assert gap > limit, (wl, seed, gap, limit)
