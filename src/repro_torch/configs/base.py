"""Architecture configuration of the port.

A copy of the fields of ``repro.configs.base.ArchConfig`` that the dense
family reads, so the port needs nothing of the JAX package.  Field names and
defaults are the JAX package's.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                  # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0   # partial RoPE
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    act: str = "silu"            # silu (SwiGLU) | gelu
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)
