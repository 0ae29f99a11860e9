"""Flash attention op: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.  Same (B, S, H, D) interface as the JAX package's
``kernels/flash_attention/ops.py``; the kernel handles ragged sequence
tails itself, so no block size is picked.  On the card f32 runs the scalar
kernel and bf16 the tensor-core one (see ``kernel.cu``).

On the card the kernel runs inside ``FlashAttentionFn``, with grad or without:
its forward is the kernel, its backward the gradient of the plain version
(``attention_backward_ref``), as the JAX package differentiates its XLA
attention and never its forward-only Pallas kernel.  A pybind call records
no ``grad_fn``: without the Function, q, k, v and the projections upstream
would get no gradient, and no error."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import Kernel, extension
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_ref, attention_ref)

FLASH_ATTENTION = Kernel("flash_attention")

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64, 128)


class FlashAttentionFn(torch.autograd.Function):
    """Forward: the kernel.  Backward: autograd of the plain version at the
    incoming gradient, from the saved q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.softcap = causal, softcap
        out = extension().flash_attention(q, k, v, causal, float(softcap))
        FLASH_ATTENTION.launches += 1
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward_ref(q, k, v, g, causal=ctx.causal,
                                            softcap=ctx.softcap)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S, H, D); k/v: (B, S, Kv, D).  Returns (B, S, H, D)."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, S, H, D = q.shape
    Kv = k.shape[2]
    if k.shape != (B, S, Kv, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel needs k/v of shape "
                         f"(B, S, Kv, D) = ({B}, {S}, Kv, {D}), got "
                         f"{tuple(k.shape)} / {tuple(v.shape)}")
    if Kv == 0 or H % Kv:
        raise ValueError(f"H={H} is not a multiple of Kv={Kv}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes D in {HEAD_DIMS}, "
                         f"got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes one dtype of f32 or "
                        f"bf16, got {q.dtype} {k.dtype} {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention kernel needs contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel needs q, k, v at 16-byte "
                         "aligned addresses (it copies rows 16 bytes at a "
                         "time)")
    return FlashAttentionFn.apply(q, k, v, causal, softcap)
