"""Mamba2 (SSD) block of the port (counterpart of ``repro/models/ssm.py``).

The full-sequence path runs the hand-written SSD kernel on a CUDA tensor
unless the caller asks for the plain path (``kernels=False``); on a CPU
tensor the op is the plain ``ssd_chunked``.  The decode path is the plain
one-token recurrence ``ssd_step``, as in the JAX package.

Dtype order follows the reference: the projections and the conv run in the
model's dtype, dt and the scan in f32, and the skip term and the SiLU gate
are applied in y's dtype before the gated RMSNorm over d_inner.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mamba_scan.ops import ssd
from repro_torch.kernels.mamba_scan.ref import ssd_chunked, ssd_step
from repro_torch.models import layers as L

G = 1     # B/C groups of the block (as in the JAX package)


class Mamba(nn.Module):
    """One Mamba2 block's parameters, named as the JAX leaves: projections
    wz, wx (d, d_inner), wB, wC (d, G*N), wdt (d, H); depthwise convs
    conv_x/conv_B/conv_C (channels, K); A_log, Dskip, dt_bias (H,) f32;
    the gated norm ``norm.w`` (d_inner,) f32; ``out`` (d_inner, d)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = L.DEFAULT_DTYPE):
        super().__init__()
        s, D = cfg.ssm, cfg.d_model
        Di, H = s.d_inner(D), s.n_heads(D)
        GN, K = G * s.d_state, s.d_conv

        def param(*shape, dt=dtype):
            return L.empty_param(*shape, dtype=dt, device=device)

        self.wz, self.wx = param(D, Di), param(D, Di)
        self.wB, self.wC = param(D, GN), param(D, GN)
        self.wdt = param(D, H)
        self.conv_x, self.conv_B, self.conv_C = (param(Di, K), param(GN, K),
                                                 param(GN, K))
        self.A_log = param(H, dt=torch.float32)
        self.Dskip = param(H, dt=torch.float32)
        self.dt_bias = param(H, dt=torch.float32)
        self.norm = L.RMSNorm(Di, device=device)
        self.out = param(Di, D)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for w in (self.wz, self.wx, self.wB, self.wC, self.wdt, self.out):
            w.copy_(L.dense_init(generator, *w.shape, dtype=w.dtype))
        for w in (self.conv_x, self.conv_B, self.conv_C):
            t = torch.randn(w.shape, generator=generator,
                            device=generator.device)
            w.copy_(t / math.sqrt(w.shape[1]))
        H = self.A_log.shape[0]
        self.A_log.zero_()                      # A = -exp(0) = -1
        self.Dskip.fill_(1.0)
        lin = torch.linspace(1e-3, 1e-1, H, device=self.dt_bias.device)
        self.dt_bias.copy_(torch.log(torch.expm1(lin)))


def _softplus(v: torch.Tensor) -> torch.Tensor:
    """log(1 + e^v) with no linear cut-over, as ``jax.nn.softplus``."""
    return torch.logaddexp(v, torch.zeros((), device=v.device))


def _proj(x, p: Mamba):
    z, xi = x @ p.wz, x @ p.wx
    Bp, Cp = x @ p.wB, x @ p.wC
    dt = _softplus((x @ p.wdt).float() + p.dt_bias.float())
    return z, xi, Bp, Cp, dt


def _gate_out(y, xh, z, p: Mamba, cfg: ArchConfig, *, kernels: bool):
    """Skip term and SiLU gate in y's dtype, gated RMSNorm over d_inner,
    output projection.  y, xh: (B, S, H, P); z: (B, S, d_inner)."""
    Bsz, S = y.shape[:2]
    y = y + xh * p.Dskip.to(y.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, -1)
    y = L.rmsnorm(y * F.silu(z.float()).to(y.dtype), p.norm.w, cfg.norm_eps,
                  kernels=kernels)
    return y @ p.out


def mamba_apply(x, p: Mamba, cfg: ArchConfig, *,
                kernels: bool = True) -> torch.Tensor:
    """Full-sequence (train / prefill) Mamba2 block.  x: (B, S, D).

    The scan takes chunks of ``min(chunk, S)`` tokens on both paths, as the
    reference's forward does.  On a CUDA tensor with ``kernels`` it is the
    SSD kernel, under autograd too (``SSDFn``: the backward is the plain
    scan's gradient); the causal conv is plain PyTorch on every path, as it
    is plain XLA in the reference.
    """
    s = cfg.ssm
    Bsz, S, D = x.shape
    H, N = s.n_heads(D), s.d_state
    z, xi, Bp, Cp, dt = _proj(x, p)
    xi = F.silu(L.causal_conv1d(xi, p.conv_x))
    Bp = F.silu(L.causal_conv1d(Bp, p.conv_B))
    Cp = F.silu(L.causal_conv1d(Cp, p.conv_C))
    xh = xi.reshape(Bsz, S, H, s.head_dim)
    A = -torch.exp(p.A_log)
    Bg, Cg = Bp.reshape(Bsz, S, G, N), Cp.reshape(Bsz, S, G, N)
    scan = ssd if kernels else ssd_chunked
    y, _ = scan(xh, dt, A, Bg, Cg, chunk=min(s.chunk, S))
    return _gate_out(y, xh, z, p, cfg, kernels=kernels)


def mamba_make_cache(cfg: ArchConfig, n_blocks: int, batch: int, *,
                     device=None,
                     dtype: torch.dtype = L.DEFAULT_DTYPE
                     ) -> Dict[str, torch.Tensor]:
    """Per block: the last K-1 rows of each pre-conv projection (in
    ``dtype``, bf16 by default whatever the model's dtype, as in the JAX
    package) and the SSM state (B, H, P, N) f32."""
    s, D = cfg.ssm, cfg.d_model
    Di, H = s.d_inner(D), s.n_heads(D)
    K1, GN = s.d_conv - 1, G * s.d_state
    return {
        "conv_x": torch.zeros(n_blocks, batch, K1, Di, dtype=dtype,
                              device=device),
        "conv_B": torch.zeros(n_blocks, batch, K1, GN, dtype=dtype,
                              device=device),
        "conv_C": torch.zeros(n_blocks, batch, K1, GN, dtype=dtype,
                              device=device),
        "state": torch.zeros(n_blocks, batch, H, s.head_dim, s.d_state,
                             dtype=torch.float32, device=device),
    }


def _conv_step(seg, w, state):
    """seg: (B, 1, C); state: (B, K-1, C).  Returns (silu(conv) (B, 1, C),
    the new state: the last K-1 rows of the pre-conv input)."""
    full = torch.cat([state.to(seg.dtype), seg], dim=1)     # (B, K, C)
    out = torch.einsum("bkc,ck->bc", full, w.to(seg.dtype))[:, None]
    return F.silu(out), full[:, 1:]


def mamba_decode(x, p: Mamba, cfg: ArchConfig,
                 cache_blk: Dict[str, torch.Tensor], *,
                 kernels: bool = True):
    """One-token step.  x: (B, 1, D); cache_blk: one block's cache (views
    into the model's cache).

    Writes the new conv and SSM states into ``cache_blk`` in place (the
    JAX function returns an updated copy) and returns (out, cache_blk).
    """
    s = cfg.ssm
    Bsz, _, D = x.shape
    H, N, P = s.n_heads(D), s.d_state, s.head_dim
    z, xi, Bp, Cp, dt = _proj(x, p)
    xi, cx = _conv_step(xi, p.conv_x, cache_blk["conv_x"])
    Bp, cb = _conv_step(Bp, p.conv_B, cache_blk["conv_B"])
    Cp, cc = _conv_step(Cp, p.conv_C, cache_blk["conv_C"])
    xh = xi[:, 0].reshape(Bsz, H, P)
    y, state = ssd_step(cache_blk["state"], xh, dt[:, 0], -torch.exp(p.A_log),
                        Bp[:, 0].reshape(Bsz, G, N),
                        Cp[:, 0].reshape(Bsz, G, N))
    out = _gate_out(y[:, None], xh[:, None], z, p, cfg, kernels=kernels)
    for key, new in (("conv_x", cx), ("conv_B", cb), ("conv_C", cc),
                     ("state", state)):
        cache_blk[key].copy_(new)
    return out, cache_blk
