"""optax's Adam chain in PyTorch, with optax's arithmetic.

The RNNoise, DeepFilterNet and DAC trainers of the JAX package step

    optax.chain(optax.clip_by_global_norm(clip),
                optax.adam(optax.cosine_decay_schedule(lr, steps, alpha)))

(``adamw(..., weight_decay)`` for DAC; DeepFilterNet's ``train`` has no
clipping).  ``AdamChain`` takes the same step:

* clipping: where the global norm ``sqrt(sum of every leaf's squares)`` is
  at least ``clip``, each leaf becomes ``(g / norm) * clip`` (not
  ``clip_grad_norm_``'s ``clip / (norm + 1e-6)``);
* moments ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, bias
  corrected by ``1 - b^count`` after the count's increment, the step
  ``mu_hat / (sqrt(nu_hat) + eps)``;
* ``adamw``'s decay ``+ weight_decay * p`` on every parameter;
* the learning rate ``cosine_decay_schedule`` at the count before the
  increment: ``lr * ((1 - alpha) * 0.5 (1 + cos(pi min(count, steps) /
  steps)) + alpha)``, in float32.

A parameter whose ``.grad`` is ``None`` steps as one whose gradient is
zero (optax sees a zero leaf: its moments decay and ``adamw`` still decays
it), never skipped as ``torch.optim`` skips it.
"""
from __future__ import annotations

import math
from typing import Iterable, List, Optional

import numpy as np
import torch


def cosine_decay(lr: float, steps: int, alpha: float, count: int) -> float:
    """``optax.cosine_decay_schedule(lr, steps, alpha)(count)`` in float32."""
    f = np.float32
    c = f(min(count, steps))
    cosine = f(0.5) * (f(1.0) + np.cos(f(math.pi) * c / f(steps)))
    return float(f(lr) * (f(1.0 - alpha) * cosine + f(alpha)))


class AdamChain:
    """``optax.chain(clip_by_global_norm(clip), adam(w)(cosine_decay_schedule(
    lr, steps, alpha)))`` over ``params`` (float32 tensors, stepped in
    place); ``clip=None`` leaves the clipping out."""

    def __init__(self, params: Iterable[torch.Tensor], lr: float, steps: int, alpha: float,
                 clip: Optional[float] = 1.0, weight_decay: float = 0.0, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        if steps <= 0:
            raise ValueError(f"AdamChain: the schedule needs steps > 0, got {steps}")
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.steps, self.alpha = lr, steps, alpha
        self.clip, self.weight_decay = clip, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Optional[List[Optional[torch.Tensor]]] = None) -> None:
        """One update from ``grads`` (default: each parameter's ``.grad``;
        ``None`` counts as zeros)."""
        if grads is None:
            grads = [p.grad for p in self.params]
        g = [torch.zeros_like(p) if t is None else t.float() for p, t in zip(self.params, grads)]
        if self.clip is not None:
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g))
            keep = norm < self.clip
            g = [torch.where(keep, t, (t / norm) * self.clip) for t in g]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        lr = cosine_decay(self.lr, self.steps, self.alpha, self.count)
        self.count += 1
        c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(self.count))
        c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(self.count))
        den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(self.nu, c2)), self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, c1), den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params, self.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(upd, -lr))
