"""RMSNorm op: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import Kernel, extension
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

RMSNORM = Kernel("rmsnorm")

_DTYPES = (torch.float32, torch.bfloat16)


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
    out = extension().rmsnorm(x, w, eps)
    RMSNORM.launches += 1
    return out
