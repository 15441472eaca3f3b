"""Port modules (DenseCellPFN, RPN, SeparableConv) against the flax modules
on the same NumPy-seeded inputs and weights, eval mode.

Tolerances: the same f32 products summed in another order (oneDNN vs XLA
CPU), relative to activations of O(1-10): PFN 1e-5, RPN heads 1e-4 after
~10 stacked convs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import Config as TorchConfig
from pillars_torch.models.layers import SeparableConv as TorchSepConv
from pillars_torch.models.pfn import DenseCellPFN as TorchPFN
from pillars_torch.models.rpn import RPN as TorchRPN
from pillars_torch.weights import convert_tree
from pillars_tpu.config import Config as JaxConfig
from pillars_tpu.models.layers import SeparableConv as JaxSepConv
from pillars_tpu.models.pfn import DenseCellPFN as JaxPFN
from pillars_tpu.models.rpn import RPN as JaxRPN
from pillars_tpu.ops.voxelize import make_cell_voxelizer
from torch_parity import randomize_variables, small_config

torch.set_num_threads(2)


def _load(module, variables):
    state = convert_tree(variables["params"], variables.get("batch_stats"))
    missing, unexpected = module.load_state_dict(state, strict=False)
    assert not unexpected, unexpected
    assert all(m.endswith("num_batches_tracked") for m in missing), missing
    return module.eval()


@pytest.mark.parametrize("b", [1, 2])
def test_dense_cell_pfn(b):
    jcfg = small_config(JaxConfig)
    tcfg = small_config(TorchConfig)
    vcfg = jcfg.model.voxel
    nx, ny, nz = vcfg.grid_size
    n_cells = nx * ny * nz
    r = np.random.RandomState(b)
    maxpts = vcfg.max_points
    pts = np.zeros((b, maxpts, 3), np.float32)
    pts[:, :1800] = np.stack([r.uniform(0, 6.4, (b, 1800)),
                              r.uniform(-2.56, 2.56, (b, 1800)),
                              r.uniform(-3, 3, (b, 1800))], -1)
    pts[:, :300, :2] = pts[:, :1, :2] + r.uniform(0, 0.02, (b, 300, 2))
    cv = make_cell_voxelizer(vcfg)(jnp.asarray(pts),
                                  jnp.full((b,), 1800, jnp.int32))
    flat = lambda a: np.array(a).reshape((-1,) + a.shape[2:])  # noqa
    cell_global = np.asarray(cv.cell) + (np.arange(b) * n_cells)[:, None]
    args = (flat(cv.points), flat(cv.cell), flat(cell_global), flat(cv.kept),
            flat(cv.count), flat(cv.mean))

    pfn = JaxPFN(jcfg.model)
    init = pfn.init(jax.random.PRNGKey(0), *args, jnp.sum(cv.num_pillars),
                    b * n_cells, train=False)
    variables = randomize_variables(jax.device_get(init), seed=b)
    want_f, want_n = pfn.apply(variables, *args, jnp.sum(cv.num_pillars),
                               b * n_cells, train=False)

    tpfn = _load(TorchPFN(tcfg.model), variables)
    with torch.no_grad():
        got_f, got_n = tpfn(*(torch.from_numpy(a) for a in args),
                            b * n_cells)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=1e-5, atol=1e-5)
    assert np.asarray(want_n).max() == 50  # the capped cell is exercised


def test_pfn_train_mode_raises():
    pfn = TorchPFN(small_config(TorchConfig).model).train()
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(NotImplementedError):
        pfn(torch.zeros(4, 3), z, z, z.bool(), z, torch.zeros(4, 3), 8)


@pytest.mark.parametrize("separable", [True, False])
def test_rpn_heads(separable):
    jcfg = small_config(JaxConfig).override("model.rpn.use_separable_conv",
                                            separable)
    tcfg = small_config(TorchConfig).override("model.rpn.use_separable_conv",
                                              separable)
    _, ny, nx = jcfg.model.feature_map_size
    r = np.random.RandomState(7)
    canvas = np.maximum(r.randn(2, ny, nx, jcfg.model.pfn.num_filters), 0
                        ).astype(np.float32)
    rpn = JaxRPN(jcfg.model)
    init = rpn.init(jax.random.PRNGKey(1), jnp.asarray(canvas), False)
    variables = randomize_variables(jax.device_get(init), seed=3)
    want = rpn.apply(variables, jnp.asarray(canvas), False)

    trpn = _load(TorchRPN(tcfg.model), variables)
    with torch.no_grad():
        got = trpn(torch.from_numpy(canvas))
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        w = np.asarray(want[key])
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("stride", [1, 2])
def test_separable_conv(stride):
    r = np.random.RandomState(stride)
    x = r.randn(2, 10, 12, 6).astype(np.float32)
    pad = "SAME" if stride == 1 else ((1, 1), (1, 1))
    conv = JaxSepConv(5, 3, stride, padding=pad)
    variables = randomize_variables(
        {"params": jax.device_get(conv.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x)))["params"],
         "batch_stats": {}}, seed=stride)
    want = np.asarray(conv.apply({"params": variables["params"]},
                                 jnp.asarray(x)))
    tconv = _load(TorchSepConv(6, 5, stride, padding=1), variables)
    with torch.no_grad():
        got = tconv(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)
