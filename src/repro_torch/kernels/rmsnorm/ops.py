"""RMSNorm op: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors.

On the card the kernel runs inside ``RMSNormFn``, with grad or without: its
forward is the kernel, its backward the gradient of the plain version
(``rmsnorm_backward_ref``), as the JAX package differentiates its XLA
``rmsnorm`` and never its forward-only Pallas kernel.  A pybind call
records no ``grad_fn``, so without the Function the norm weight and
everything upstream would get no gradient, and no error.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import Kernel, extension
from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref, rmsnorm_ref

RMSNORM = Kernel("rmsnorm")

_DTYPES = (torch.float32, torch.bfloat16)


class RMSNormFn(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of the plain version at the
    incoming gradient, from the saved x and w."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        out = extension().rmsnorm(x, w, eps)
        RMSNORM.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_backward_ref(x, w, g, ctx.eps)
        return dx, dw, None


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """x: (..., D) f32 or bf16; w: (D,) f32.  Leading dims are flattened
    into rows, as the Pallas wrapper does."""
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    D = x.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes f32 or bf16 x, got {x.dtype}")
    if w.dtype != torch.float32 or w.shape != (D,):
        raise TypeError(f"rmsnorm kernel takes f32 w of shape ({D},), got "
                        f"{w.dtype} {tuple(w.shape)}")
    if w.device != x.device or not (x.is_contiguous()
                                    and w.is_contiguous()):
        raise ValueError("rmsnorm kernel needs contiguous x and w on one "
                         "device")
    return RMSNormFn.apply(x, w, eps)
