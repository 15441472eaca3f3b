"""The CUDA NMS keep-mask kernel against its plain twin, on the card.

Marked ``cuda``: these skip without a GPU. On a machine with a card and no
JAX run ``python -m pytest --noconftest tests/test_torch_nms_cuda.py``
(``tests/conftest.py`` imports JAX).
"""

import pytest
import torch

from pillars_torch.utils import tracing
from torch_parity import standup_box_sets

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_nms():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from pillars_torch.ops import nms_cuda

    return nms_cuda


def _assert_bit_equal(cuda_nms, boxes, valid):
    bt = torch.from_numpy(boxes).cuda()
    vt = torch.from_numpy(valid).cuda()
    before = tracing.counters()["nms_keep_mask.launches"]
    got = cuda_nms.nms_keep_mask(bt, vt, 0.5)
    torch.cuda.synchronize()
    assert tracing.counters()["nms_keep_mask.launches"] == before + 1
    want_gpu = cuda_nms.keep_mask_plain(bt, vt, 0.5)
    want_cpu = cuda_nms.keep_mask_plain(bt.cpu(), vt.cpu(), 0.5)
    assert torch.equal(got, want_gpu)
    assert torch.equal(got.cpu(), want_cpu)
    return got


@pytest.mark.parametrize("b,k", [(1, 100), (4, 100), (1, 1000), (4, 1000),
                                 (3, 33), (2, 1024), (2, 1), (2, 31), (2, 32),
                                 (1, 33), (5, 64), (1, 1024)])
def test_kernel_bit_equal_to_plain(cuda_nms, b, k):
    boxes, _, valid = standup_box_sets(b * 1000 + k, b, k, n_dup=k // 10)
    _assert_bit_equal(cuda_nms, boxes, valid)


@pytest.mark.parametrize("k", [1, 33, 100, 1024])
def test_all_invalid_and_all_duplicates(cuda_nms, k):
    """Sample 0 has no valid box: nothing is kept. Sample 1 is one box k
    times over: only the first is kept. Sample 2 is the same with the first
    box invalid: the second is kept."""
    boxes, _, valid = standup_box_sets(k, 3, k, n_dup=0)
    valid[0] = False
    boxes[1:] = boxes[1, 0]
    valid[1:] = True
    valid[2, 0] = False
    got = _assert_bit_equal(cuda_nms, boxes, valid).cpu()
    assert not got[0].any()
    assert got[1].sum() == 1 and got[1, 0]
    if k > 1:
        assert got[2].sum() == 1 and got[2, 1]


def test_kernel_rejects_bad_inputs(cuda_nms):
    with pytest.raises(ValueError):
        cuda_nms.nms_keep_mask(torch.zeros(1, 1025, 4, device="cuda"),
                               torch.ones(1, 1025, dtype=torch.bool,
                                          device="cuda"), 0.5)
    with pytest.raises(TypeError):
        cuda_nms.nms_keep_mask(torch.zeros(1, 8, 4, device="cuda",
                                           dtype=torch.float64),
                               torch.ones(1, 8, dtype=torch.bool,
                                          device="cuda"), 0.5)
