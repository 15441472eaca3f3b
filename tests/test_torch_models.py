"""Port modules (DenseCellPFN, RPN, SeparableConv) against the flax modules
on the same NumPy-seeded inputs and weights, eval mode, and DenseCellPFN in
train mode.

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
from pillars_torch.models.layers import collect_batch_stats
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


def _dense_cell_inputs(b):
    """(jax config, torch config, PFN args as NumPy arrays, num_pillars,
    n_cells_total) from the JAX package's cell voxelizer on b clouds with
    one crowded cell."""
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
    return jcfg, tcfg, args, np.asarray(cv.num_pillars), b * n_cells


@pytest.mark.parametrize("b", [1, 2])
def test_dense_cell_pfn(b):
    jcfg, tcfg, args, num_pillars, n_total = _dense_cell_inputs(b)
    pfn = JaxPFN(jcfg.model)
    init = pfn.init(jax.random.PRNGKey(0), *args, num_pillars, n_total,
                    train=False)
    variables = randomize_variables(jax.device_get(init), seed=b)
    want_f, want_n = pfn.apply(variables, *args, num_pillars, n_total,
                               train=False)

    tpfn = _load(TorchPFN(tcfg.model), variables)
    with torch.no_grad():
        got_f, got_n = tpfn(*(torch.from_numpy(a) for a in args), n_total)
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f),
                               rtol=1e-5, atol=1e-5)
    assert np.asarray(want_n).max() == 50  # the capped cell is exercised


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pfn_train_mode(dtype):
    """DenseCellPFN in train mode (B=2): the batch statistics over the kept
    points with the dense layout's row count num_pillars x N, taken in
    float32; the features within 1e-5 in float32 and by the module
    criterion in bfloat16 (one rounding point, the BN's output), the new
    statistics within 1e-5 of their max; the gradient reaches the Dense."""
    from torch_parity import jit_strict, module_criterion

    jcfg, tcfg, args, num_pillars, n_total = _dense_cell_inputs(2)
    jdt = {"float32": None, "bfloat16": jnp.bfloat16}[dtype]
    pfn = JaxPFN(jcfg.model, dtype=jdt)
    init = pfn.init(jax.random.PRNGKey(0), *args, num_pillars, n_total,
                    train=False)
    variables = randomize_variables(jax.device_get(init), seed=4)
    (want_f, want_n), mut = jax.device_get(jit_strict(
        lambda v, *a: pfn.apply(v, *a, n_cells_total=n_total, train=True,
                                mutable=["batch_stats"]))(
        variables, *args, num_pillars))

    tpfn = _load(TorchPFN(tcfg.model, dtype=getattr(torch, dtype)),
                 variables).train()
    got_f, got_n = tpfn(*(torch.from_numpy(a) for a in args), n_total,
                        torch.tensor(int(num_pillars)))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    if dtype == "float32":
        np.testing.assert_allclose(got_f.detach().numpy(), want_f,
                                   rtol=1e-5, atol=1e-5)
    else:
        module_criterion(got_f.detach(), want_f, "DenseCellPFN train")
    got_stats = collect_batch_stats(tpfn)
    want_stats = convert_tree({}, mut["batch_stats"])
    assert set(got_stats) == set(want_stats)
    for k, w in want_stats.items():
        assert got_stats[k].dtype == torch.float32
        np.testing.assert_allclose(got_stats[k].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * w.abs().max().item(),
                                   err_msg=k)
    got_f.float().sum().backward()
    assert tpfn.dense.weight.grad.dtype == torch.float32
    assert tpfn.dense.weight.grad.abs().sum() > 0


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
