"""Plain PyTorch RMSNorm: the CPU path, the CUDA kernel's oracle and its
backward."""
from __future__ import annotations

from typing import Tuple

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D); w: (D,).  f32 math, result in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * w.float()).to(x.dtype)


def rmsnorm_backward_ref(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                         eps: float = 1e-5
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw) of ``rmsnorm_ref(x, w, eps)`` at the incoming gradient
    ``g``: autograd of the plain version, recomputed, as ``jax.grad`` of
    the reference's XLA ``rmsnorm`` is the JAX package's only gradient of
    it (its Pallas kernel is forward-only)."""
    with torch.enable_grad():
        xd = x.detach().requires_grad_()
        wd = w.detach().requires_grad_()
        dx, dw = torch.autograd.grad(rmsnorm_ref(xd, wd, eps), (xd, wd), g)
    return dx, dw
