"""AdamW optimizer + LR schedules (counterpart of ``repro.optim.adamw``).

The arithmetic is the JAX package's, operation for operation: global-norm
clipping of the gradients, fp32 first and second moments, bias
corrections at the incremented step, decoupled weight decay added to the
update before the ``lr * lr_scale`` multiply, and the result cast back to
each parameter's dtype.  It is plain tensor code on whatever device the
parameters live on, as the JAX package leaves it to XLA outside any
kernel.

Unlike the JAX version, which returns new trees, ``update`` writes the
new moments and parameters into the tensors it is given (in place, under
``torch.no_grad``): a full-size model cannot hold a second copy of its
optimizer state.  It still returns ``(params, state)`` so call sites read
the same.  Parameters, gradients and moments are dicts of the same keys
(``state_dict`` names); the step is a 0-d int32 tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Union

import torch

Tensors = Dict[str, torch.Tensor]


class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Tensors
    nu: Tensors


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0

    def init(self, params: Tensors) -> AdamWState:
        zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for n, p in params.items()}
        nu = {n: torch.zeros_like(z) for n, z in zeros.items()}
        device = next(iter(params.values())).device if params else "cpu"
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          mu=zeros, nu=nu)

    @torch.no_grad()
    def update(self, grads: Tensors, state: AdamWState, params: Tensors,
               lr_scale: Union[torch.Tensor, float] = 1.0
               ) -> tuple[Tensors, AdamWState]:
        step = state.step + 1
        scale = None
        if self.grad_clip:
            sq = [torch.sum(torch.square(g.float())) for g in grads.values()]
            gnorm = torch.sqrt(torch.stack(sq).sum())
            scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        stepf = step.float()
        mu_hat_c = 1.0 - torch.pow(self.b1, stepf)
        nu_hat_c = 1.0 - torch.pow(self.b2, stepf)
        lr = self.lr * lr_scale
        for name, p in params.items():
            g = grads[name].float()
            if scale is not None:
                g = g * scale
            m, v = state.mu[name], state.nu[name]
            m.copy_(self.b1 * m + (1 - self.b1) * g)
            v.copy_(self.b2 * v + (1 - self.b2) * torch.square(g))
            del g
            u = (m / mu_hat_c) / (torch.sqrt(v / nu_hat_c) + self.eps)
            pf = p.float()
            u = u + self.weight_decay * pf
            p.copy_((pf - lr * u).to(p.dtype))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu)


# ---------------------------------------------------------------------------
# LR schedules
# ---------------------------------------------------------------------------


def warmup_cosine(step: torch.Tensor, *, base_lr: float = 1.0,
                  warmup_steps: int = 100, total_steps: int = 10_000,
                  min_frac: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, dtype=torch.float32,
                                   device=step.device) * prog))
    return base_lr * torch.where(step < warmup_steps, warm, cos)


def linear_scaling(n_nodes: int, base_nodes: int = 1,
                   max_scale: float = 32.0) -> float:
    """Linear LR scaling rule for weak-scaling elastic rescale."""
    return float(min(n_nodes / base_nodes, max_scale))
