"""Chunked mLSTM op: the CUDA kernel for CUDA tensors, the plain version for
CPU tensors.  Same interface as the JAX package's
``kernels/mlstm/ops.py::mlstm``: the scan starts from C = n = 0 and
m = -1e30.  On the card f32 runs the scalar kernel and bf16 the tensor-core
ones (see ``kernel.cu``); one call counts as one launch of K4, whatever
number of device kernels it issues.

On the card the kernel runs inside ``MLSTMFn``, with grad or without: its
forward is the kernel, its backward the gradient of the plain version
(``mlstm_backward_ref``), as the JAX package's training path
differentiates its XLA ``mlstm_chunked`` and never its forward-only Pallas
kernel.  A pybind call records no ``grad_fn``: without the Function, q, k,
v, the gates and the projections upstream would get no gradient, and no
error."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._build import Kernel, extension
from repro_torch.kernels.mlstm.ref import (Carry, check_chunk,
                                          mlstm_backward_ref, mlstm_chunked)

MLSTM = Kernel("mlstm")

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 384)   # D
MAX_CHUNK = 256


class MLSTMFn(torch.autograd.Function):
    """Forward: the kernel, (h, C, n, m).  Backward: autograd of the plain
    version at the incoming gradients, from the saved q, k, v and gates; an
    output whose gradient is None (the final carry, on the training path)
    takes no part in it."""

    @staticmethod
    def forward(ctx, q, k, v, i_raw, f_raw, chunk):
        ctx.save_for_backward(q, k, v, i_raw, f_raw)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        h, C, n, m = extension().mlstm(q, k, v, i_raw, f_raw, chunk)
        MLSTM.launches += 1
        return h, C, n, m

    @staticmethod
    def backward(ctx, gh, gC, gn, gm):
        grads = mlstm_backward_ref(*ctx.saved_tensors, gh, (gC, gn, gm),
                                   chunk=ctx.chunk)
        return (*grads, None)


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          i_raw: torch.Tensor, f_raw: torch.Tensor, *,
          chunk: int = 256) -> Tuple[torch.Tensor, Carry]:
    """q, k, v: (B, S, H, D) f32 or bf16; i_raw, f_raw: (B, S, H) f32.
    Returns (h (B, S, H, D) in q's dtype, (C (B, H, D, D), n (B, H, D),
    m (B, H)) f32)."""
    if q.device.type == "cpu":
        return mlstm_chunked(q, k, v, i_raw, f_raw, chunk=chunk)
    if q.device.type != "cuda":
        raise ValueError(f"mlstm: unsupported device {q.device}")
    B, S, H, D = q.shape
    check_chunk(S, chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"mlstm kernel takes a chunk of at most "
                         f"{MAX_CHUNK} tokens, got {chunk}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"mlstm kernel needs q, k and v of one shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    if i_raw.shape != (B, S, H) or f_raw.shape != (B, S, H):
        raise ValueError(f"mlstm kernel needs gates of shape ({B}, {S}, "
                         f"{H}), got {tuple(i_raw.shape)} "
                         f"{tuple(f_raw.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"mlstm kernel takes D in {HEAD_DIMS}, got {D}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"mlstm kernel takes q, k and v of one dtype, f32 "
                        f"or bf16, got {q.dtype} {k.dtype} {v.dtype}")
    if i_raw.dtype != torch.float32 or f_raw.dtype != torch.float32:
        raise TypeError(f"mlstm kernel takes f32 gates, got {i_raw.dtype} "
                        f"{f_raw.dtype}")
    tensors = (q, k, v, i_raw, f_raw)
    if any(t.device != q.device for t in tensors):
        raise ValueError("q, k, v and the gates must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("mlstm kernel needs contiguous q, k, v and gates")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("mlstm kernel needs bf16 q, k, v at 16-byte "
                         "aligned addresses (it copies rows 16 bytes at a "
                         "time)")
    h, C, n, m = MLSTMFn.apply(q, k, v, i_raw, f_raw, chunk)
    return h, (C, n, m)
