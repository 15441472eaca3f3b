"""Optimizer: AdamW with exponential LR decay, as the reference
(pillars_tpu/train/optim.py; reference train.py:223-246: tf.keras
ExponentialDecay(2e-3, decay_steps=7000/batch_size, 0.8) feeding
tfa.optimizers.AdamW(weight_decay=1e-4, eps=1e-8)).

tfa's AdamW applies DECOUPLED weight decay NOT scaled by the learning rate:
``p -= lr * m_hat / (sqrt(v_hat) + eps) + wd * p``, with bias-corrected
moments and eps outside the square root. ``torch.optim.AdamW`` scales the
decay by lr, so the update is written here, in the order of the JAX
package's optax chain (scale_by_adam, scale_by_schedule,
add_decayed_weights, scale(-1)).

``freeze_patterns`` (transfer learning; the reference's positional
set_trainable) are substrings of the FLAX parameter paths
("rpn/block1/bn0/scale"); torch names are mapped to those paths, so a
pattern freezes what it freezes in JAX. Frozen parameters keep their
values: no gradient step and no decay.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence, Tuple

import torch

from pillars_torch.config import OptimizerConfig
from pillars_torch.weights import flax_path

B1, B2 = 0.9, 0.999


def exponential_decay_schedule(cfg: OptimizerConfig, batch_size: int
                               ) -> Callable[[torch.Tensor], torch.Tensor]:
    """lr(step) = initial * factor**(step / (decay_steps / batch_size)),
    evaluated at the count of updates taken BEFORE this one (optax's
    scale_by_schedule). The reference divides decay_steps by batch_size
    (train.py:230). ``step``: an int, or an int32 tensor; the rate is an
    f32 tensor on its device, computed there in f32 as the JAX package
    computes it, so that a captured step reads the rate of each replay's
    count."""
    decay_steps = cfg.decay_steps / batch_size

    def schedule(step) -> torch.Tensor:
        p = torch.as_tensor(step, dtype=torch.int32).to(
            torch.float32) / decay_steps
        if cfg.staircase:
            p = torch.floor(p)
        return cfg.initial_learning_rate * torch.pow(cfg.decay_factor, p)

    return schedule


def trainable_names(params: Dict[str, torch.Tensor],
                    patterns: Sequence[str]) -> Tuple[str, ...]:
    """The names of ``params`` whose flax path contains none of
    ``patterns``."""
    return tuple(n for n, t in params.items()
                 if not any(p in flax_path(n, t.ndim) for p in patterns))


class AdamState(NamedTuple):
    """optax's ScaleByAdamState over the trainable parameters: ``count``
    updates taken (a host int; the step hands it to the device as an int32
    tensor), first and second moments by torch name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    """The tfa-style AdamW with the decay schedule. :meth:`update` is
    functional (new parameter tensors and a new state; changes neither
    argument); :meth:`step` is its body on tensors, which a captured train
    step runs with the count on the device."""

    def __init__(self, cfg: OptimizerConfig, batch_size: int):
        self.cfg = cfg
        self.schedule = exponential_decay_schedule(cfg, batch_size)

    def init(self, params: Dict[str, torch.Tensor]) -> AdamState:
        names = trainable_names(params, self.cfg.freeze_patterns)
        zeros = lambda: {n: torch.zeros_like(params[n]) for n in names}  # noqa: E731
        return AdamState(0, zeros(), zeros())

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: AdamState,
               params: Dict[str, torch.Tensor]
               ) -> Tuple[Dict[str, torch.Tensor], AdamState]:
        count = torch.tensor(state.count, dtype=torch.int32).to(
            next(iter(params.values())).device)
        new, mu, nu = self.step(grads, state.mu, state.nu, params, count)
        return new, AdamState(state.count + 1, mu, nu)

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor],
             mu: Dict[str, torch.Tensor], nu: Dict[str, torch.Tensor],
             params: Dict[str, torch.Tensor], count: torch.Tensor
             ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor],
                        Dict[str, torch.Tensor]]:
        """(new parameters, new first and second moments) after one update
        from ``count`` (int32 tensor: updates taken before this one), with
        no host sync and no host constant. The bias corrections and the rate
        are f32 scalars on the device, as optax computes them."""
        names = list(mu)
        g = [grads[n] for n in names]
        p = [params[n] for n in names]
        new_mu = torch._foreach_add(torch._foreach_mul(g, 1 - B1),
                                    torch._foreach_mul([mu[n] for n in names],
                                                       B1))
        new_nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2),
            torch._foreach_mul([nu[n] for n in names], B2))
        n = (count + 1).to(torch.float32)
        c1 = 1 - torch.pow(B1, n)
        c2 = 1 - torch.pow(B2, n)
        lr = self.schedule(count)
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(new_nu, c2)),
            self.cfg.adam_eps)
        step = torch._foreach_div(torch._foreach_div(new_mu, c1), denom)
        step = torch._foreach_add(torch._foreach_mul(step, lr),
                                  torch._foreach_mul(p, self.cfg.weight_decay))
        new = dict(params)
        new.update(zip(names, torch._foreach_sub(p, step)))
        return new, dict(zip(names, new_mu)), dict(zip(names, new_nu))
