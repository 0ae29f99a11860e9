"""SSD chunked-scan op: the CUDA kernel for CUDA tensors, the plain version
for CPU tensors.  Same interface as the JAX package's
``kernels/mamba_scan/ops.py::ssd``: the scan starts from a zero state.
On the card f32 runs the scalar kernel and bf16 the tensor-core one (see
``kernel.cu``).

On the card the kernel runs inside ``SSDFn``, with grad or without: its
forward is the kernel, its backward the gradient of the plain version
(``ssd_backward_ref``), as the JAX package's training path differentiates
its XLA ``ssd_chunked`` and never its forward-only Pallas kernel.  A pybind
call records no ``grad_fn``: without the Function, x, dt, A, B, C and the
projections upstream would get no gradient, and no error."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._build import Kernel, extension
from repro_torch.kernels.mamba_scan.ref import (check_chunk, ssd_backward_ref,
                                                ssd_chunked)

SSD = Kernel("ssd")

_DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (32, 64)          # P
STATE_DIMS = (16, 32, 64)     # N
MAX_CHUNK = 256


class SSDFn(torch.autograd.Function):
    """Forward: the kernel, (y, final state).  Backward: autograd of the
    plain version at the incoming gradients, from the saved x, dt, A, B and
    C; an output whose gradient is None (the final state, on the training
    path) takes no part in it."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        y, state = extension().ssd(x, dt, A, B, C, chunk)
        SSD.launches += 1
        return y, state

    @staticmethod
    def backward(ctx, gy, gstate):
        grads = ssd_backward_ref(*ctx.saved_tensors, gy, gstate,
                                 chunk=ctx.chunk)
        return (*grads, None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, *,
        chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (Bt, S, H, P); dt: (Bt, S, H) f32; A: (H,) f32; B/C:
    (Bt, S, G, N) in x's dtype.  Returns (y (Bt, S, H, P) in x's dtype,
    final state (Bt, H, P, N) f32)."""
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, B, C, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd: unsupported device {x.device}")
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    check_chunk(S, chunk)
    if chunk > MAX_CHUNK:
        raise ValueError(f"ssd kernel takes a chunk of at most {MAX_CHUNK} "
                         f"tokens, got {chunk}")
    if dt.shape != (Bt, S, H) or A.shape != (H,):
        raise ValueError(f"ssd kernel needs dt ({Bt}, {S}, {H}) and A "
                         f"({H},), got {tuple(dt.shape)} {tuple(A.shape)}")
    if B.shape != (Bt, S, G, N) or C.shape != B.shape:
        raise ValueError(f"ssd kernel needs B/C of shape (Bt, S, G, N) = "
                         f"({Bt}, {S}, G, N), got {tuple(B.shape)} / "
                         f"{tuple(C.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"H={H} is not a multiple of G={G}")
    if P not in HEAD_DIMS or N not in STATE_DIMS:
        raise ValueError(f"ssd kernel takes P in {HEAD_DIMS} and N in "
                         f"{STATE_DIMS}, got P={P} N={N}")
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd kernel takes x, B and C of one dtype, f32 or "
                        f"bf16, got {x.dtype} {B.dtype} {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd kernel takes f32 dt and A, got {dt.dtype} "
                        f"{A.dtype}")
    tensors = (x, dt, A, B, C)
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, dt, A, B and C must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd kernel needs contiguous x, dt, A, B, C")
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd kernel needs x, B, C at 16-byte aligned "
                         "addresses (it copies rows 16 bytes at a time)")
    return SSDFn.apply(x, dt, A, B, C, chunk)
