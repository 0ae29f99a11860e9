"""Plain PyTorch attention: the CPU path, the CUDA kernel's oracle and its
backward.

Grouped-query attention without KV repetition: q (B, Sq, H, D) is viewed
as (B, Sq, Kv, G, D) against k/v (B, Sk, Kv, D).  Scores, probabilities
and the P·V product are f32; masked scores are -1e30, as in the JAX
package's ``models/layers.py::full_attention``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

NEG_INF = -1e30


def gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, Kv, G, D), k: (B, Sk, Kv, D) -> (B, Kv, G, Sq, Sk) f32."""
    return torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float())


def gqa_out(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """p: (B, Kv, G, Sq, Sk) f32; v: (B, Sk, Kv, D) -> (B, Sq, Kv, G, D)
    f32: probabilities stay f32 and P·V accumulates in f32."""
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.float())


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, Kv, D|Dv) -> (B, Sq, H, Dv)."""
    B, Sq, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    G = H // Kv
    s = gqa_scores(q.reshape(B, Sq, Kv, G, D), k) / math.sqrt(D)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        q_pos = torch.arange(Sq, device=q.device)
        mask = q_pos[:, None] >= torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = gqa_out(p, v)
    return o.reshape(B, Sq, H, v.shape[3]).to(q.dtype)


def attention_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           g: torch.Tensor, *, causal: bool = True,
                           softcap: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """(dq, dk, dv) of ``attention_ref`` at the incoming gradient ``g``:
    autograd of the plain version, recomputed.  It is the port's
    ``full_attention``, which the JAX package's training path
    differentiates (its Pallas kernel is forward-only).  Its f32 scores and
    probabilities take (B, Kv, G, Sq, Sk) each."""
    with torch.enable_grad():
        qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
        out = attention_ref(qd, kd, vd, causal=causal, softcap=softcap)
        return torch.autograd.grad(out, (qd, kd, vd), g)
