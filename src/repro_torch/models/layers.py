"""Core neural-net primitives of the port (counterpart of
``repro/models/layers.py``).

Weights keep the JAX package's (d_in, d_out) layout, so a projection is
``x @ w``.  Matmul weights are bf16 by default; norms, rotary angles and
softmax run in f32.  On a CUDA tensor, ``rmsnorm`` runs the hand-written
RMSNorm kernel unless the caller asks for the plain path (``kernels=False``,
which the checks use as their reference); on a CPU tensor it is the plain
version.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention.ref import (NEG_INF, gqa_scores,
                                                     attention_ref)
from repro_torch.kernels.rmsnorm.ops import rmsnorm as rmsnorm_op
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.parallel import collectives as PX
from repro_torch.parallel.tensor import copy_to, reduce_from, replicated
from repro_torch.sharding import MeshRules, Part, part, tensor_axes

DEFAULT_DTYPE = torch.bfloat16

# the unblocked reference attention of the JAX package (small shapes, oracle)
full_attention = attention_ref


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    return nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=generator)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               dtype: torch.dtype = DEFAULT_DTYPE,
               scale: Optional[float] = None) -> torch.Tensor:
    """Truncated normal in [-2, 2] times ``scale`` (1/sqrt(d_in) unless
    given), on the generator's device."""
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return (_trunc_normal((d_in, d_out), generator) * scale).to(dtype)


def empty_param(*shape: int, dtype: torch.dtype, device) -> nn.Parameter:
    """An uninitialised parameter; ``init`` methods fill it from a seed and
    ``load_state_dict`` from converted weights."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


def embed_init(generator: torch.Generator, vocab: int, d: int, *,
               dtype: torch.dtype = DEFAULT_DTYPE) -> torch.Tensor:
    return (_trunc_normal((vocab, d), generator) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5, *,
            kernels: bool = True) -> torch.Tensor:
    if kernels:
        return rmsnorm_op(x, weight, eps)
    return rmsnorm_ref(x, weight, eps)


def layernorm(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor],
              eps: float = 1e-5) -> torch.Tensor:
    """f32 math with bias, result in x's dtype.  Plain PyTorch: the JAX
    package has no kernel for it."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


class RMSNorm(nn.Module):
    """Norm parameters: ``w`` (D,), always f32."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                         device=device))


class LayerNorm(nn.Module):
    """Norm parameters: ``w`` (D,) and ``b`` (D,), always f32."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.ones(d, dtype=torch.float32,
                                         device=device))
        self.b = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                          device=device))


def make_norm(d: int, kind: str, *,
              device=None) -> Union[RMSNorm, LayerNorm]:
    """The norm module of ``kind`` (a config's ``norm``)."""
    if kind not in ("rmsnorm", "layernorm"):
        raise ValueError(f"unknown norm {kind!r}")
    return (RMSNorm if kind == "rmsnorm" else LayerNorm)(d, device=device)


def norm_apply(x: torch.Tensor, p: Union[RMSNorm, LayerNorm], kind: str,
               eps: float, *, kernels: bool = True,
               rules: Optional[MeshRules] = None) -> torch.Tensor:
    """RMSNorm (the kernel on CUDA tensors unless ``kernels`` is off) or
    LayerNorm (plain), as the config's ``norm`` says.  The rules leave
    ``norm`` whole: every rank of a tensor-parallel grid runs it whole."""
    tp = tensor_axes(rules)
    if kind == "rmsnorm":
        return rmsnorm(x, replicated(p.w, tp), eps, kernels=kernels)
    return layernorm(x, replicated(p.w, tp), replicated(p.b, tp), eps)


@torch.no_grad()
def init_norms(model: nn.Module) -> None:
    """Every norm of ``model`` to w = 1 (and b = 0), as the JAX init."""
    for norm in model.modules():
        if isinstance(norm, (RMSNorm, LayerNorm)):
            norm.w.fill_(1.0)
        if isinstance(norm, LayerNorm):
            norm.b.zero_()


# ---------------------------------------------------------------------------
# rotary embeddings (partial-rotary supported)
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, rope_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., rope_dim//2), f32."""
    half = rope_dim // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=positions.device) / half
    freqs = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                         device=positions.device), exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rope_dim: int) -> torch.Tensor:
    """x: (B, S, H, D); cos/sin: (B, S, rope_dim//2) or (S, rope_dim//2)."""
    if rope_dim == 0:
        return x
    rot, rest = x[..., :rope_dim], x[..., rope_dim:]
    half = rope_dim // 2
    x1, x2 = rot[..., :half].float(), rot[..., half:].float()
    if cos.dim() == 2:            # (S, half) -> broadcast over batch & heads
        c, s = cos[None, :, None, :], sin[None, :, None, :]
    else:                         # (B, S, half)
        c, s = cos[:, :, None, :], sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, block_q: int = 512,
                      block_k: int = 1024,
                      softcap: float = 0.0) -> torch.Tensor:
    """Memory-bounded online-softmax attention (the JAX package's XLA
    fallback, same math: f32 scores, probabilities and P·V, -1e30 masking).

    q: (B, Sq, H, D); k/v: (B, Sk, Kv, D|Dv) -> (B, Sq, H, Dv).
    """
    B, Sq, H, D = q.shape
    Sk, Kv = k.shape[1], k.shape[2]
    Dv = v.shape[3]
    G = H // Kv
    scale = 1.0 / math.sqrt(D)
    block_q, block_k = min(block_q, Sq), min(block_k, Sk)
    while Sq % block_q:
        block_q -= 1
    while Sk % block_k:
        block_k -= 1
    qg = q.reshape(B, Sq, Kv, G, D)
    outs = []
    for q0 in range(0, Sq, block_q):
        qb = qg[:, q0:q0 + block_q]
        q_pos = q0 + torch.arange(block_q, device=q.device)
        m = torch.full((B, Kv, G, block_q), NEG_INF, device=q.device)
        l = torch.zeros((B, Kv, G, block_q), device=q.device)
        o = torch.zeros((B, Kv, G, block_q, Dv), device=q.device)
        for k0 in range(0, Sk, block_k):
            kb, vb = k[:, k0:k0 + block_k], v[:, k0:k0 + block_k]
            s = gqa_scores(qb, kb) * scale
            if softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            if causal:
                k_pos = k0 + torch.arange(block_k, device=q.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                                   vb.float())
            m = m_new
        o = o / torch.clamp(l[..., None], min=1e-30)
        outs.append(o.permute(0, 3, 1, 2, 4))       # (B, bq, Kv, G, Dv)
    return torch.cat(outs, dim=1).reshape(B, Sq, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """SwiGLU (``act="silu"``: w_gate, w_up, w_down) or gelu (w_up,
    w_down)."""

    def __init__(self, d_model: int, d_ff: int, act: str, *, device=None,
                 dtype: torch.dtype = DEFAULT_DTYPE):
        super().__init__()
        if act not in ("silu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        if act == "silu":
            self.w_gate = empty_param(d_model, d_ff, dtype=dtype,
                                      device=device)
        self.w_up = empty_param(d_model, d_ff, dtype=dtype, device=device)
        self.w_down = empty_param(d_ff, d_model, dtype=dtype, device=device)
        self.act = act

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        d_model, d_ff = self.w_up.shape
        dtype = self.w_up.dtype
        if self.act == "silu":
            self.w_gate.copy_(dense_init(generator, d_model, d_ff,
                                         dtype=dtype))
        self.w_up.copy_(dense_init(generator, d_model, d_ff, dtype=dtype))
        self.w_down.copy_(dense_init(generator, d_ff, d_model, dtype=dtype))


def mlp_apply(x: torch.Tensor, p: MLP, act: str, *,
              rules: Optional[MeshRules] = None) -> torch.Tensor:
    """The MLP; where the rules split ``ff`` (the reference's ``h`` over
    ``ff``), the rank's columns of ``w_gate`` and ``w_up`` and its rows of
    ``w_down`` (column- then row-parallel), their partial sums added over
    the split's axes."""
    ff = part(p.w_up.shape[1], "ff", rules)
    if ff.n > 1:
        x = copy_to(x, ff.axes)
        w_up, w_down = p.w_up[:, ff.slice], p.w_down[ff.slice]
        w_gate = p.w_gate[:, ff.slice] if act == "silu" else None
    else:
        tp = tensor_axes(rules)
        w_up, w_down = replicated(p.w_up, tp), replicated(p.w_down, tp)
        w_gate = replicated(p.w_gate, tp) if act == "silu" else None
    up = x @ w_up
    if act == "silu":
        h = F.silu(x @ w_gate) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return reduce_from(h @ w_down, ff.axes)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 z_loss: float = 1e-4, *, vocab: Optional[Part] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (B,S,V) any dtype; targets (B,S) int.  Returns the means of
    (nll, z_loss * lse²), f32.

    ``vocab``, a split vocabulary (``sharding.part``), makes it
    vocab-parallel: ``logits`` are the rank's columns ``vocab.slice``; the
    max is the ``pmax`` of the ranks' (detached) maxima, the exp-sums and
    the gold logit are summed over the split's axes (``reduce_from``), and
    nothing gathers the whole logits."""
    lf = logits.float()
    axes = vocab.axes if vocab is not None else ()
    # the shift is detached on BOTH sides: subtracting a detached m but
    # adding back a live one leaks an extra +1 into the argmax logit's
    # gradient (d lse/dl = softmax + one_hot(argmax))
    m = lf.max(dim=-1, keepdim=True).values.detach()
    if axes:
        m = PX.pmax(m, axes)
    lse = torch.log(reduce_from(torch.exp(lf - m).sum(dim=-1), axes)) \
        + m[..., 0]
    t = targets.long()
    if axes:
        t = t - vocab.lo
        inside = (t >= 0) & (t < lf.shape[-1])
        gold = torch.gather(lf, -1, t.clamp(0, lf.shape[-1] - 1)[..., None])
        gold = reduce_from(torch.where(inside, gold[..., 0], 0.0), axes)
    else:
        gold = torch.gather(lf, -1, t[..., None])[..., 0]
    return (lse - gold).mean(), (z_loss * lse.square()).mean()


# ---------------------------------------------------------------------------
# depthwise causal convolution (Mamba2's short conv)
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv in x's dtype.  x: (B, L, C); w: (C, K).

    ``state`` (B, K-1, C), if given, is prepended in place of the zero
    padding (decode path).  The result is contiguous: the einsum may
    return a permuted layout, and the SSD kernel reads (B, L, C) rows.
    """
    K = w.shape[1]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1) + tuple(x.shape[2:]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                     # (B, L+K-1, C)
    n = x.shape[1]
    stack = torch.stack([xp[:, i:i + n] for i in range(K)], dim=-1)
    return torch.einsum("blck,ck->blc", stack, w.to(x.dtype)).contiguous()
