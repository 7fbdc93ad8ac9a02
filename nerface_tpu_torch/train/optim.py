"""SGD and RMSprop with optax's semantics.

`torch.optim.SGD` adds `−lr·g` through a host scalar (a tensor LR is read
back to the host), and `torch.optim.RMSprop` adds ε outside the square
root where optax adds it inside. These two keep the JAX package's math
(`optax.sgd` and `optax.rmsprop` at optax's defaults) in foreach ops on a
0-d LR tensor, so their step reads nothing back to the host and can be
captured in a CUDA graph (train/window.py).
"""

from __future__ import annotations

import torch


class SGD(torch.optim.Optimizer):
    """`optax.sgd(lr)`: p ← p − lr·g (no momentum)."""

    def __init__(self, params, lr):
        super().__init__(params, {"lr": lr})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if params:
                upd = torch._foreach_mul([p.grad for p in params], group["lr"])
                torch._foreach_sub_(params, upd)


class RMSprop(torch.optim.Optimizer):
    """`optax.rmsprop(lr)` at its defaults: ν ← decay·ν + (1 − decay)·g²
    from ν = 0, p ← p − lr·g/√(ν + ε)."""

    def __init__(self, params, lr, decay: float = 0.9, eps: float = 1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            nus = []
            for p in params:
                st = self.state[p]
                if "square_avg" not in st:
                    st["square_avg"] = torch.zeros_like(p)
                nus.append(st["square_avg"])
            torch._foreach_mul_(nus, group["decay"])
            torch._foreach_addcmul_(nus, grads, grads, value=1.0 - group["decay"])
            scale = torch._foreach_add(nus, group["eps"])
            torch._foreach_rsqrt_(scale)
            torch._foreach_mul_(scale, grads)
            torch._foreach_mul_(scale, group["lr"])
            torch._foreach_sub_(params, scale)
