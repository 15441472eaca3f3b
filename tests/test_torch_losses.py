"""The port's detection loss (pillars_torch/models/losses.py) against
pillars_tpu's on the CPU: every LossOutput field and the gradient with
respect to the three heads, within 1e-5 relative; for one and for three
classes, with and without the direction classifier and the sin encoding.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pillars_torch.config import LossConfig as TorchLossConfig
from pillars_torch.models.losses import detection_loss as torch_loss
from pillars_tpu.config import LossConfig as JaxLossConfig
from pillars_tpu.models.losses import detection_loss as jax_loss

torch.set_num_threads(2)
RTOL = 1e-5


def _inputs(seed, num_class, b=2, h=8, w=10, t=2):
    r = np.random.RandomState(seed)
    a = h * w * t
    box = (r.randn(b, h, w, t * 7) * 0.5).astype(np.float32)
    cls = (r.randn(b, h, w, t * num_class) * 2.0).astype(np.float32)
    dirp = r.randn(b, h, w, t * 2).astype(np.float32)
    anchors = np.zeros((a, 7), np.float32)
    anchors[:, 6] = r.choice([0.0, 1.57], a)
    labels = r.choice([-1, 0, 0, 0] + list(range(1, num_class + 1)),
                      (b, a)).astype(np.int32)
    labels[1, :] = np.where(labels[1] > 0, 0, labels[1])  # no positives
    reg = (r.randn(b, 7, a) * 0.3).astype(np.float32)
    reg[:, :, :5] = 0.01  # residuals inside the smooth-L1 quadratic zone
    return box, cls, dirp, anchors, labels, reg


@pytest.mark.parametrize("num_class, use_dir, sin", [
    (1, True, True), (3, True, True), (1, False, False)])
def test_detection_loss_and_head_grads_match_jax(num_class, use_dir, sin):
    box, cls, dirp, anchors, labels, reg = _inputs(num_class, num_class)
    jcfg = JaxLossConfig(encode_rad_error_by_sin=sin)
    tcfg = TorchLossConfig(encode_rad_error_by_sin=sin)

    def jf(bp, cp, dp):
        out = jax_loss(jcfg, num_class, bp, cp, dp, jnp.asarray(anchors),
                       jnp.asarray(labels), jnp.asarray(reg),
                       use_direction_classifier=use_dir)
        return out.loss, out

    (_, want), jgrads = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(
        jnp.asarray(box), jnp.asarray(cls), jnp.asarray(dirp))
    heads = [torch.from_numpy(x).requires_grad_(True)
             for x in (box, cls, dirp)]
    got = torch_loss(tcfg, num_class, *heads, torch.from_numpy(anchors),
                     torch.from_numpy(labels), torch.from_numpy(reg),
                     use_direction_classifier=use_dir)
    got.loss.backward()
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=1e-7, err_msg=name)
    assert float(want.loc_loss_reduced) > 0 and float(want.cls_loss_reduced) > 0
    for head, gj, name in zip(heads, jgrads, ("box", "cls", "dir")):
        gj = np.asarray(gj)
        scale = np.abs(gj).max()
        if not use_dir and name == "dir":
            assert head.grad is None or not head.grad.abs().max()
            continue
        assert scale > 0
        np.testing.assert_allclose(head.grad.numpy(), gj, rtol=0,
                                   atol=RTOL * scale, err_msg=name)


def test_reg_targets_in_either_layout():
    box, cls, dirp, anchors, labels, reg = _inputs(5, 1)
    args = [torch.from_numpy(x) for x in (box, cls, dirp, anchors, labels)]
    cfg = TorchLossConfig()
    lane = torch_loss(cfg, 1, *args, torch.from_numpy(reg))
    rows = torch_loss(cfg, 1, *args,
                      torch.from_numpy(reg.transpose(0, 2, 1).copy()))
    for a, b in zip(lane, rows):
        assert torch.equal(a, b)
