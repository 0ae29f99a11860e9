"""Architecture configuration of the port.

A copy of the fields of ``repro.configs.base.ArchConfig`` (and of its
``SSMConfig``) that the dense, hybrid and ssm (xLSTM) families read, so the
port needs nothing of the JAX package.  Field names and defaults are the JAX
package's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 block shape: d_inner = expand * d_model, split into heads of
    ``head_dim``; the SSD scan runs over chunks of ``chunk`` tokens."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                  # dense | hybrid | ssm (the ported families)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0            # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0   # partial RoPE
    use_rope: bool = True
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    act: str = "silu"            # silu (SwiGLU) | gelu

    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): the shared attention block follows every N ssm blocks
    hybrid_attn_every: int = 0
    # xlstm: every Nth block is an sLSTM (the rest mLSTM)
    slstm_every: int = 0
    # sub-quadratic (recurrent state)
    sub_quadratic: bool = False
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)
