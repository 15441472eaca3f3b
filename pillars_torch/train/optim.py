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
                               ) -> Callable[[int], float]:
    """lr(step) = initial * factor**(step / (decay_steps / batch_size)),
    evaluated at the count of updates taken BEFORE this one (optax's
    scale_by_schedule). The reference divides decay_steps by batch_size
    (train.py:230)."""
    decay_steps = cfg.decay_steps / batch_size

    def schedule(step):
        p = float(step) / decay_steps
        if cfg.staircase:
            p = float(int(p))
        return cfg.initial_learning_rate * cfg.decay_factor ** p

    return schedule


def trainable_names(params: Dict[str, torch.Tensor],
                    patterns: Sequence[str]) -> Tuple[str, ...]:
    """The names of ``params`` whose flax path contains none of
    ``patterns``."""
    return tuple(n for n, t in params.items()
                 if not any(p in flax_path(n, t.ndim) for p in patterns))


class AdamState(NamedTuple):
    """optax's ScaleByAdamState over the trainable parameters: ``count``
    updates taken, first and second moments by torch name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class AdamW:
    """The tfa-style AdamW with the decay schedule, functional:
    :meth:`update` returns new parameter tensors and a new state and
    changes neither argument."""

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
        names = list(state.mu)
        g = [grads[n] for n in names]
        p = [params[n] for n in names]
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - B1),
                                torch._foreach_mul([state.mu[n] for n in names],
                                                   B1))
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1 - B2),
            torch._foreach_mul([state.nu[n] for n in names], B2))
        count = state.count + 1
        # the bias corrections and the rate are f32 scalars in optax
        c1 = torch.tensor(1 - B1 ** count, dtype=torch.float32).item()
        c2 = torch.tensor(1 - B2 ** count, dtype=torch.float32).item()
        lr = torch.tensor(self.schedule(state.count),
                          dtype=torch.float32).item()
        denom = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(nu, c2)), self.cfg.adam_eps)
        step = torch._foreach_div(torch._foreach_div(mu, c1), denom)
        step = torch._foreach_add(torch._foreach_mul(step, lr),
                                  torch._foreach_mul(p, self.cfg.weight_decay))
        new = dict(params)
        new.update(zip(names, torch._foreach_sub(p, step)))
        return new, AdamState(count, dict(zip(names, mu)),
                              dict(zip(names, nu)))
