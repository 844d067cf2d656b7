"""Adam with torch-Adam/optax semantics, as a functional update over lists.

Counterpart of ``councilx/train/optim.py``: the reference's three
torch.optim.Adam groups (gen / dis / council-dis), each with a StepLR
scheduler stepped once per iteration, which the JAX package builds as

    add_decayed_weights(wd) -> scale_by_adam(b1, b2, eps=1e-8, mu_dtype)
        -> scale_by_schedule(-lr * gamma ** (count // step_size))

Reproduced exactly: L2 weight decay added to the gradient (not decoupled);
eps outside the sqrt; bias-corrected moments; ``count`` is the optimizer's
own update count starting at 0, as optax's schedule sees it; with
``mu_dtype=bfloat16`` the first moment is held in bf16 (optax forms
``b1 * mu`` in bf16, adds ``(1 - b1) * g`` in f32, bias-corrects in f32,
and stores the result rounded to bf16).

:meth:`Adam.update` returns new tensors and never writes its inputs, and the
count and the step size live on the parameters' device, so a caller can
select the old or the new values on the device without a host sync
(``CouncilTrainer._apply_if_finite``). The moment math runs as
``torch._foreach_*`` ops over the whole group.

:func:`assign_` writes the values a caller selected into the parameters'
and the state's own tensors: the port's counterpart of the JAX step's
donated state. A captured train step (``utils/graphs.py``) replays on the
tensors it was captured with, so the state it updates must stay those
tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

Tensors = List[torch.Tensor]


@dataclass
class AdamState:
    """count: int32 0-d (updates applied so far); mu, nu: one per param."""

    count: torch.Tensor
    mu: Tensors
    nu: Tensors


class Adam:
    """One parameter group's Adam + StepLR."""

    def __init__(self, lr: float, beta1: float, beta2: float,
                 weight_decay: float, step_size: int, gamma: float,
                 mu_dtype: Optional[torch.dtype] = None, eps: float = 1e-8):
        self.lr, self.b1, self.b2 = lr, beta1, beta2
        self.weight_decay = weight_decay
        self.step_size, self.gamma = step_size, gamma
        self.mu_dtype = mu_dtype
        self.eps = eps

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        device = params[0].device if params else torch.device("cpu")
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=[torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                for p in params],
            nu=[torch.zeros_like(p) for p in params])

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """lr * gamma ** (count // step_size), f32 on count's device."""
        return self.lr * torch.pow(self.gamma, count // self.step_size)

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: AdamState
               ) -> Tuple[Tensors, AdamState]:
        """-> (new params, new state); inputs are left as they were."""
        params, grads = list(params), list(grads)
        n = len(params)
        # the foreach ops launch once per chunk of tensors only where the
        # tensors of every list share their strides: each gradient laid out
        # as its parameter and moments are (autograd may hand back a
        # permuted one), else they run one op per tensor
        grads = [g if g.stride() == p.stride() else
                 torch.empty_like(p, dtype=g.dtype).copy_(g)
                 for g, p in zip(grads, params)]
        g = (torch._foreach_add(grads, params, alpha=self.weight_decay)
             if self.weight_decay else grads)
        decayed = torch._foreach_mul(state.mu, self.b1)
        if self.mu_dtype is not None:
            decayed = [m.float() for m in decayed]
        mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - self.b1), decayed)
        nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - self.b2),
            torch._foreach_mul(state.nu, self.b2))
        count = state.count + 1
        bc1 = 1.0 - torch.pow(self.b1, count)
        bc2 = 1.0 - torch.pow(self.b2, count)
        den = torch._foreach_sqrt(torch._foreach_div(nu, [bc2] * n))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, [bc1] * n), den)
        step = -self.learning_rate(state.count)
        torch._foreach_mul_(upd, [step] * n)
        new_params = torch._foreach_add(params, upd)
        if self.mu_dtype is not None:
            mu = [m.to(self.mu_dtype) for m in mu]
        return new_params, AdamState(count=count, mu=mu, nu=nu)


@torch.no_grad()
def assign_(params: Sequence[torch.Tensor], state: AdamState,
            new_params: Sequence[torch.Tensor], new_state: AdamState) -> None:
    """Copy new parameter and optimizer values into the tensors of
    ``params`` and ``state``, which keep their storage."""
    torch._foreach_copy_(list(params), list(new_params))
    torch._foreach_copy_(state.mu, new_state.mu)
    torch._foreach_copy_(state.nu, new_state.nu)
    state.count.copy_(new_state.count)


def make_optimizers(cfg) -> Tuple[Adam, Adam, Adam]:
    """-> (gen, dis, cdis) optimizers, mirroring the reference's 3 groups."""
    mu_dtype = torch.bfloat16 if cfg.adam_mu_dtype == "bfloat16" else None
    if cfg.lr_policy == "step":
        step_size, gamma = cfg.step_size, cfg.gamma
    elif cfg.lr_policy == "constant":
        step_size, gamma = 1, 1.0
    else:
        raise ValueError(f"unsupported lr_policy: {cfg.lr_policy}")
    return tuple(Adam(cfg.lr, cfg.beta1, cfg.beta2, cfg.weight_decay,
                      step_size, gamma, mu_dtype) for _ in range(3))
