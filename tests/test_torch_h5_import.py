"""The port's reference .h5 import (pillars_torch/train/checkpoint.py::
import_reference_h5) against the JAX package's on the same self-built
Keras save_weights files (tests/test_h5_import.py builds them from a NumPy
seed, in every naming and nesting variant): the port's state equals
``weights.from_jax_variables`` of the JAX package's import, tensor for
tensor, and the refusals are the same. Also the Conv2DTranspose
orientation, settled numerically for the port's ConvTranspose2d."""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

h5py = pytest.importorskip("h5py")

from pillars_torch.config import Config as TorchConfig  # noqa: E402
from pillars_torch.models.detector import PillarsDetector  # noqa: E402
from pillars_torch.train.checkpoint import import_reference_h5  # noqa: E402
from pillars_torch.weights import (convert_tree, from_jax_variables,  # noqa
                                   to_jax_variables)
from pillars_tpu.train.checkpoint import (  # noqa: E402
    import_reference_h5 as jax_import)
from test_h5_import import VARIANTS, build_fake_keras_h5  # noqa: E402
from test_h5_import import (  # noqa: E402
    TestConv2DTransposeOrientation as _JaxOrientation)


def _setup(upsample=None):
    """The port's config (test_h5_import's small config), a port state and
    the same structure as flax variables."""
    cfg = (TorchConfig.default().override("model.voxel.max_voxels", 256)
           .override("model.voxel.max_points", 1024))
    if upsample:
        cfg = cfg.override("model.rpn.num_upsample_filters", upsample)
    state = PillarsDetector(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    params, stats = to_jax_variables(state)
    return cfg, state, {"params": params, "batch_stats": stats}


def _check(cfg, state, variables, path, expected=None, **kwargs):
    got = import_reference_h5(path, state, strict=True, **kwargs)
    jax_out = jax_import(path, variables, strict=True, **kwargs)
    want = from_jax_variables(jax_out["params"], jax_out["batch_stats"], cfg)
    assert set(got) == set(want) == set(state)
    for name, t in want.items():
        assert got[name].dtype == t.dtype, name
        np.testing.assert_array_equal(got[name].numpy(), t.numpy(),
                                      err_msg=name)
    if expected is not None:
        exp = from_jax_variables(expected["params"], expected["batch_stats"],
                                 cfg)
        for name, t in exp.items():
            np.testing.assert_allclose(got[name].numpy(), t.numpy(),
                                       rtol=1e-6, err_msg=name)


class TestH5Import:
    @pytest.mark.parametrize("variant", VARIANTS)
    def test_roundtrip_all_leaves(self, tmp_path, rng, variant):
        cfg, state, variables = _setup()
        path = str(tmp_path / f"fake_keras_{variant}.h5")
        expected = build_fake_keras_h5(path, variables, rng, variant)
        _check(cfg, state, variables, path, expected)

    @pytest.mark.parametrize("variant", VARIANTS)
    def test_roundtrip_flax_orientation(self, tmp_path, rng, variant):
        cfg, state, variables = _setup()
        path = str(tmp_path / f"flax_{variant}.h5")
        expected = build_fake_keras_h5(path, variables, rng, variant,
                                       deconv_layout="flax")
        _check(cfg, state, variables, path, expected)

    def _all_square(self, tmp_path, rng, variant="plain",
                    deconv_layout="keras"):
        cfg, state, variables = _setup(upsample=[64, 128, 256])
        path = str(tmp_path / "square.h5")
        expected = build_fake_keras_h5(path, variables, rng, variant,
                                       deconv_layout=deconv_layout)
        return cfg, state, variables, path, expected

    def test_all_square_unmarked_fails_loudly(self, tmp_path, rng):
        cfg, state, variables, path, _ = self._all_square(tmp_path, rng)
        with pytest.raises(ValueError, match="orientation"):
            import_reference_h5(path, state, strict=True)
        with pytest.raises(ValueError, match="orientation"):
            jax_import(path, variables, strict=True)

    def test_all_square_keras_attrs_resolve(self, tmp_path, rng):
        args = self._all_square(tmp_path, rng, variant="shuffled_attrs")
        _check(*args)

    @pytest.mark.parametrize("layout", ["keras", "flax"])
    def test_all_square_explicit_override(self, tmp_path, rng, layout):
        args = self._all_square(tmp_path, rng, deconv_layout=layout)
        _check(*args, deconv_orientation=layout)

    def test_explicit_override_contradicting_shapes_raises(self, tmp_path,
                                                           rng):
        _, state, variables = _setup()
        path = str(tmp_path / "contradiction.h5")
        build_fake_keras_h5(path, variables, rng, "plain",
                            deconv_layout="keras")
        with pytest.raises(ValueError, match="channel order"):
            import_reference_h5(path, state, strict=True,
                                deconv_orientation="flax")

    def test_missing_weight_raises(self, tmp_path):
        _, state, _ = _setup()
        path = str(tmp_path / "incomplete.h5")
        with h5py.File(path, "w") as f:
            f.create_dataset("rpn/conv_box/kernel:0",
                             data=np.zeros((1, 1, 384, 14), np.float32))
        with pytest.raises(ValueError):
            import_reference_h5(path, state, strict=True)


class TestConv2DTransposeOrientation:
    """A Keras Conv2DTranspose kernel [k, k, O, I] taken to flax's layout
    (spatial flip + channel transpose, as import_reference_h5 does) and on
    to torch's (``weights.convert_tree``): the port's ConvTranspose2d then
    computes the Keras layer (the scatter-form oracle of
    tests/test_h5_import.py); the plain channel transpose does not."""

    @pytest.mark.parametrize("k,s", [(2, 2), (4, 4), (1, 1), (3, 2)])
    def test_flip_transpose_matches_keras(self, rng, k, s):
        i_ch, o_ch = 3, 5
        x = rng.randn(2, 4, 5, i_ch).astype(np.float32)
        K = rng.randn(k, k, o_ch, i_ch).astype(np.float32)
        want = _JaxOrientation._oracle(None, x, K, s)

        def run(flax_kernel):
            w = convert_tree({"deconv": {"kernel": flax_kernel}},
                             None)["deconv.weight"]
            out = F.conv_transpose2d(
                torch.from_numpy(x).permute(0, 3, 1, 2), w, stride=s)
            return out.permute(0, 2, 3, 1).numpy()

        np.testing.assert_allclose(
            run(np.transpose(K[::-1, ::-1], (0, 1, 3, 2))), want,
            rtol=1e-5, atol=1e-5)
        if k > 1:
            wrong = run(np.transpose(K, (0, 1, 3, 2)))
            assert np.abs(wrong - want).max() > 1e-3
