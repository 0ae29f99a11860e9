"""xLSTM LM of the port (counterpart of ``repro/models/xlstm.py``):
super-blocks of (``slstm_every`` - 1) mLSTM blocks and one sLSTM block,
then the mLSTM blocks past the last whole super-block (the ``tail``).

Parameters, named as the JAX tree un-stacked: ``blocks.mlstm.<i>.<j>.*``
(i < n_super, j < slstm_every - 1), ``blocks.slstm.<i>.*``, ``tail.<i>.*``,
``embed`` (tied) and ``final_norm``.  Surface as ``TransformerLM``:

    init(generator)                       fill the weights from a seed
    forward_logits(tokens) -> logits      (B, S) -> (B, S, V)
    loss(batch) -> (loss, metrics)        the training objective
    init_cache(batch_size, seq_len) -> cache
    decode_step(cache, tokens, pos) -> (logits, cache)

Logits come out in the model's dtype (bf16 for a bf16 model), as the
reference computes them with no f32 accumulation type.  ``use_kernels``
(True by default) sends the output RMSNorms and the prefill's mLSTM cell
of CUDA tensors to the hand-written kernels (K1, K4), under autograd too
(their backward is the gradient of the plain version).  The block norms
are the config's LayerNorm, plain PyTorch as in the reference; the sLSTM
recurrence and the decode step's mLSTM cell are plain PyTorch too, as they
are plain XLA in the reference.  ``remat`` (True by default) recomputes in
the backward where the reference's ``jax.checkpoint`` does around a block:
each super-block (its mLSTM blocks and its sLSTM block) and each tail
block; it acts only while grad mode is on, so serving is unchanged.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.mlstm.ops import mlstm
from repro_torch.kernels.mlstm.ref import NEG_BIG, mlstm_chunked, mlstm_step
from repro_torch.models import layers as L
from repro_torch.models.zamba import cache_view

CONV_K = 4     # the mLSTM block's causal conv width (as in the JAX package)

SCarry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# sLSTM cell (recurrent)
# ---------------------------------------------------------------------------

def slstm_scan(x_gates: torch.Tensor, r_w: torch.Tensor, carry: SCarry
               ) -> Tuple[torch.Tensor, SCarry]:
    """x_gates: (B, S, H, 4, Dh) input contributions; r_w: (H, 4, Dh, Dh)
    recurrent weights; carry: (c, n, m, h), each (B, H, Dh) f32.  Returns
    (hs (B, S, H, Dh) f32, the final carry).  One token at a time, as the
    reference's scan; the recurrent product is one batched matmul per
    token over the heads."""
    H, _, Dh, _ = r_w.shape
    r = r_w.float().permute(0, 2, 1, 3).reshape(H, Dh, 4 * Dh)
    c, n, m, h = carry
    hs = []
    for t in range(x_gates.shape[1]):
        rec = torch.bmm(h.transpose(0, 1), r)               # (H, B, 4 Dh)
        g = x_gates[:, t].float() + \
            rec.view(H, -1, 4, Dh).transpose(0, 1)          # (B, H, 4, Dh)
        i_raw, f_raw, z_raw, o_raw = g.unbind(dim=2)
        lf = F.logsigmoid(f_raw)
        m_new = torch.maximum(lf + m, i_raw)
        i_s = torch.exp(i_raw - m_new)
        f_s = torch.exp(lf + m - m_new)
        c = f_s * c + i_s * torch.tanh(z_raw)
        n = f_s * n + i_s
        h = torch.sigmoid(o_raw) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class MLSTMBlock(nn.Module):
    """Parameters named as the JAX leaves: the block norm; w_up, w_z
    (D, Di); conv (Di, 4); wq, wk, wv (Di, Di); w_if (Di, 2H) and
    if_bias (2H,) f32; the output norm ``onorm`` (Di,) f32; w_down
    (Di, D).  Di = 2 D."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = L.DEFAULT_DTYPE):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        Di = 2 * D

        def param(*shape, dt=dtype):
            return L.empty_param(*shape, dtype=dt, device=device)

        self.norm = L.make_norm(D, cfg.norm, device=device)
        self.w_up, self.w_z = param(D, Di), param(D, Di)
        self.conv = param(Di, CONV_K)
        self.wq, self.wk, self.wv = param(Di, Di), param(Di, Di), \
            param(Di, Di)
        self.w_if = param(Di, 2 * H, dt=torch.float32)
        self.if_bias = param(2 * H, dt=torch.float32)
        self.onorm = L.RMSNorm(Di, device=device)
        self.w_down = param(Di, D)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for w in (self.w_up, self.w_z, self.wq, self.wk, self.wv,
                  self.w_down):
            w.copy_(L.dense_init(generator, *w.shape, dtype=w.dtype))
        self.conv.copy_(torch.randn(self.conv.shape, generator=generator,
                                    device=generator.device) / 2.0)
        self.w_if.copy_(L.dense_init(generator, *self.w_if.shape,
                                     dtype=torch.float32, scale=0.01))
        H = self.if_bias.shape[0] // 2
        self.if_bias[:H] = 0.0
        self.if_bias[H:] = torch.linspace(3.0, 6.0, H,
                                         device=self.if_bias.device)


class SLSTMBlock(nn.Module):
    """Parameters named as the JAX leaves: the block norm; w_in (D, 4D);
    gate_bias (4D,) f32, laid out (i, f, z, o) over all heads; r_w
    (H, 4, Dh, Dh) f32; the output norm ``onorm`` (D,) f32; w_out (D, D).
    Dh = D / H."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = L.DEFAULT_DTYPE):
        super().__init__()
        D, H = cfg.d_model, cfg.n_heads
        Dh = D // H
        self.norm = L.make_norm(D, cfg.norm, device=device)
        self.w_in = L.empty_param(D, 4 * D, dtype=dtype, device=device)
        self.gate_bias = L.empty_param(4 * D, dtype=torch.float32,
                                       device=device)
        self.r_w = L.empty_param(H, 4, Dh, Dh, dtype=torch.float32,
                                 device=device)
        self.onorm = L.RMSNorm(D, device=device)
        self.w_out = L.empty_param(D, D, dtype=dtype, device=device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        H, _, Dh, _ = self.r_w.shape
        D = H * Dh
        self.w_in.copy_(L.dense_init(generator, D, 4 * D,
                                     dtype=self.w_in.dtype))
        self.gate_bias.zero_()
        self.gate_bias[D:2 * D] = torch.linspace(
            3.0, 6.0, H, device=self.gate_bias.device)[:, None].expand(
                H, Dh).reshape(-1)
        self.r_w.copy_(torch.randn(self.r_w.shape, generator=generator,
                                   device=generator.device) * 0.01)
        self.w_out.copy_(L.dense_init(generator, D, D,
                                      dtype=self.w_out.dtype))


def _mlstm_qkvg(x, p: MLSTMBlock, cfg: ArchConfig,
                conv_state: Optional[torch.Tensor] = None):
    """Projections of the mLSTM block: (xu, z, q, k, v, i_raw, f_raw); q,
    k, v (B, S, H, Dh) in x's dtype, the gates (B, S, H) f32, all
    contiguous (the K4 kernel reads them as such)."""
    B, S, D = x.shape
    H = cfg.n_heads
    Dh = 2 * D // H
    xu, z = x @ p.w_up, x @ p.w_z
    xc = F.silu(L.causal_conv1d(xu, p.conv, state=conv_state))
    q = (xc @ p.wq).reshape(B, S, H, Dh)
    k = (xc @ p.wk).reshape(B, S, H, Dh)
    v = (xu @ p.wv).reshape(B, S, H, Dh)
    gates = xu.float() @ p.w_if + p.if_bias
    i_raw, f_raw = gates[..., :H].contiguous(), gates[..., H:].contiguous()
    return xu, z, q, k, v, i_raw, f_raw


def _mlstm_out(h, z, x, p: MLSTMBlock, cfg: ArchConfig, *,
               kernels: bool) -> torch.Tensor:
    """Output RMSNorm over Di, SiLU gate, down projection, residual.
    h: (B, S, H, Dh) in x's dtype."""
    out = h.reshape(h.shape[0], h.shape[1], -1)
    out = L.rmsnorm(out, p.onorm.w, cfg.norm_eps, kernels=kernels)
    out = out * F.silu(z.float()).to(out.dtype)
    return x + out @ p.w_down


def mlstm_block_apply(x, p: MLSTMBlock, cfg: ArchConfig, *,
                      chunk: int = 256, kernels: bool = True
                      ) -> torch.Tensor:
    """Full-sequence (prefill) mLSTM block.  x: (B, S, D).  The cell takes
    chunks of ``min(chunk, S)`` tokens on both paths, as the reference's
    forward does: K4 on a CUDA tensor unless ``kernels`` is off, the plain
    ``mlstm_chunked`` otherwise."""
    S = x.shape[1]
    h = L.norm_apply(x, p.norm, cfg.norm, cfg.norm_eps, kernels=kernels)
    _, z, q, k, v, i_raw, f_raw = _mlstm_qkvg(h, p, cfg)
    cell = mlstm if kernels else mlstm_chunked
    out, _ = cell(q, k, v, i_raw, f_raw, chunk=min(chunk, S))
    return _mlstm_out(out, z, x, p, cfg, kernels=kernels)


def _slstm_gates(x, p: SLSTMBlock, cfg: ArchConfig) -> torch.Tensor:
    """(B, S, D) -> input contributions (B, S, H, 4, Dh) f32."""
    B, S, D = x.shape
    H = cfg.n_heads
    g = (x @ p.w_in).float() + p.gate_bias
    # layout: (i all heads, f all heads, z, o)
    return g.reshape(B, S, 4, H, D // H).transpose(2, 3)


def slstm_zero_carry(B: int, H: int, Dh: int, device=None) -> SCarry:
    """(c, n, m, h) before the first token: zeros, and m = -1e30."""
    return (torch.zeros(B, H, Dh, device=device),
            torch.zeros(B, H, Dh, device=device),
            torch.full((B, H, Dh), NEG_BIG, device=device),
            torch.zeros(B, H, Dh, device=device))


def slstm_block_apply(x, p: SLSTMBlock, cfg: ArchConfig,
                      carry: Optional[SCarry] = None, *,
                      kernels: bool = True) -> Tuple[torch.Tensor, SCarry]:
    """sLSTM block over x (B, S, D) from ``carry`` (zeros by default).
    Returns (x + block output, the final carry)."""
    B, S, D = x.shape
    H = cfg.n_heads
    h = L.norm_apply(x, p.norm, cfg.norm, cfg.norm_eps, kernels=kernels)
    xg = _slstm_gates(h, p, cfg)
    if carry is None:
        carry = slstm_zero_carry(B, H, D // H, x.device)
    hs, carry = slstm_scan(xg, p.r_w, carry)
    hs = hs.reshape(B, S, D).to(x.dtype)
    hs = L.rmsnorm(hs, p.onorm.w, cfg.norm_eps, kernels=kernels)
    return x + hs @ p.w_out, carry


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

class SuperBlocks(nn.Module):
    """The stacked part of the JAX tree: ``mlstm`` (n_super lists of
    slstm_every - 1 blocks) and ``slstm`` (n_super blocks)."""

    def __init__(self, cfg: ArchConfig, n_super: int, n_m: int, *,
                 device=None, dtype: torch.dtype = L.DEFAULT_DTYPE):
        super().__init__()
        self.mlstm = nn.ModuleList(
            nn.ModuleList(MLSTMBlock(cfg, device=device, dtype=dtype)
                          for _ in range(n_m)) for _ in range(n_super))
        self.slstm = nn.ModuleList(SLSTMBlock(cfg, device=device,
                                              dtype=dtype)
                                   for _ in range(n_super))


class XLSTMLM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = L.DEFAULT_DTYPE, remat: bool = True):
        super().__init__()
        if cfg.family != "ssm":
            raise ValueError(f"XLSTMLM needs an ssm (xLSTM) config, got "
                             f"family {cfg.family!r}")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "untied embeddings (an lm_head) are not ported yet: "
                "ROADMAP.md queue 1 item 10 (dense variants)")
        self.cfg = cfg
        self.use_kernels = True
        self.remat = remat
        se = cfg.slstm_every
        self.n_super = cfg.n_layers // se if se else 0
        self.n_m_per_super = se - 1 if se else 0
        self.n_tail = cfg.n_layers - self.n_super * se
        self.embed = L.empty_param(cfg.vocab_size, cfg.d_model, dtype=dtype,
                                   device=device)
        self.final_norm = L.make_norm(cfg.d_model, cfg.norm, device=device)
        self.blocks = SuperBlocks(cfg, self.n_super, self.n_m_per_super,
                                  device=device, dtype=dtype)
        self.tail = nn.ModuleList(MLSTMBlock(cfg, device=device, dtype=dtype)
                                  for _ in range(self.n_tail))

    # ---------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "XLSTMLM":
        cfg = self.cfg
        self.embed.copy_(L.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                      dtype=self.embed.dtype))
        L.init_norms(self)
        for blk in self.modules():
            if isinstance(blk, (MLSTMBlock, SLSTMBlock)):
                blk.init(generator)
        return self

    # ------------------------------------------------------------ forward
    def _super_block(self, x, group, sblk: SLSTMBlock):
        """A super-block: its mLSTM blocks, then its sLSTM block."""
        for blk in group:
            x = mlstm_block_apply(x, blk, self.cfg, kernels=self.use_kernels)
        x, _ = slstm_block_apply(x, sblk, self.cfg, kernels=self.use_kernels)
        return x

    def _tail_block(self, x, blk: MLSTMBlock):
        return mlstm_block_apply(x, blk, self.cfg, kernels=self.use_kernels)

    def forward_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int -> logits (B, S, V) in the model's dtype.

        With remat under grad, each super-block and each tail block is
        checkpointed whole, as the reference's ``jax.checkpoint`` of
        ``super_body`` and of the tail's block.  The reference also
        checkpoints its mLSTM chunk step and its sLSTM token step inside
        their scans; those trade memory for recompute and change no value,
        and are not checkpointed again here: one region a token would add
        3,072 regions a microbatch at S 1024 to a loop whose cost is the
        host's.  What a super-block's recompute holds instead is its sLSTM
        loop's graph and, a chunk at a time, the plain mLSTM backward's
        (B, H, Q, Q) f32 tiles: a training step of xlstm-125m at 8 x 1024
        tokens peaks at 9.91 GiB on an H100, its f32 optimizer state
        included (PERF.md)."""
        cfg = self.cfg
        x = self.embed[tokens]
        remat = self.remat and torch.is_grad_enabled()
        for group, sblk in zip(self.blocks.mlstm, self.blocks.slstm):
            if remat:
                x = checkpoint(self._super_block, x, group, sblk,
                               use_reentrant=False)
            else:
                x = self._super_block(x, group, sblk)
        for blk in self.tail:
            if remat:
                x = checkpoint(self._tail_block, x, blk, use_reentrant=False)
            else:
                x = self._tail_block(x, blk)
        x = L.norm_apply(x, self.final_norm, cfg.norm, cfg.norm_eps,
                         kernels=self.use_kernels)
        return x @ self.embed.t()

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: tokens and targets (B, S) int.  Returns (nll + z_loss,
        {"nll", "z_loss", "aux"}), f32, from the model's-dtype logits as
        the reference's; aux is 0."""
        logits = self.forward_logits(batch["tokens"])
        nll, zl = L.softmax_xent(logits, batch["targets"])
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return nll + zl, {"nll": nll, "z_loss": zl, "aux": aux}

    # ------------------------------------------------------------- decode
    def init_cache(self, batch_size: int, seq_len: int):
        """{"mlstm": per-block conv (bf16) and (C, n, m) (f32) states
        stacked (n_super, slstm_every - 1, B, ...), "slstm": (c, n, m, h)
        stacked (n_super, B, H, D / H), "tail": (n_tail, B, ...)}.
        ``seq_len`` is unused: the state does not grow."""
        cfg = self.cfg
        D, H = cfg.d_model, cfg.n_heads
        Di = 2 * D
        Dh, Dh_s = Di // H, D // H
        dev = self.embed.device

        def m_cache(*lead):
            return {
                "conv": torch.zeros(*lead, batch_size, CONV_K - 1, Di,
                                    dtype=L.DEFAULT_DTYPE, device=dev),
                "C": torch.zeros(*lead, batch_size, H, Dh, Dh, device=dev),
                "n": torch.zeros(*lead, batch_size, H, Dh, device=dev),
                "m": torch.full((*lead, batch_size, H), NEG_BIG,
                                device=dev),
            }

        cache = {}
        if self.n_super:
            cache["mlstm"] = m_cache(self.n_super, self.n_m_per_super)
            c, n, m, h = slstm_zero_carry(self.n_super * batch_size, H, Dh_s,
                                          dev)
            cache["slstm"] = {
                key: val.reshape(self.n_super, batch_size, H, Dh_s)
                for key, val in (("c", c), ("n", n), ("m", m), ("h", h))}
        if self.n_tail:
            cache["tail"] = m_cache(self.n_tail)
        return cache

    def _mlstm_decode(self, x, blk: MLSTMBlock, c):
        """One-token step of an mLSTM block; writes its new conv and
        (C, n, m) states into ``c`` (views into the model's cache)."""
        cfg = self.cfg
        h = L.norm_apply(x, blk.norm, cfg.norm, cfg.norm_eps,
                         kernels=self.use_kernels)
        xu, z, q, k, v, i_raw, f_raw = _mlstm_qkvg(h, blk, cfg,
                                                   conv_state=c["conv"])
        conv = torch.cat([c["conv"][:, 1:], xu.to(c["conv"].dtype)], dim=1)
        hq, (C, n, m) = mlstm_step(q[:, 0], k[:, 0], v[:, 0], i_raw[:, 0],
                                   f_raw[:, 0], (c["C"], c["n"], c["m"]))
        for key, new in (("conv", conv), ("C", C), ("n", n), ("m", m)):
            c[key].copy_(new)
        return _mlstm_out(hq[:, None], z, x, blk, cfg,
                          kernels=self.use_kernels)

    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        """tokens: (B, 1); ``pos`` is unused (the state carries the
        position).  Returns (logits (B, 1, V) in the model's dtype, cache);
        the cache is updated in place."""
        cfg, kernels = self.cfg, self.use_kernels
        x = self.embed[tokens]
        for i, (group, sblk) in enumerate(zip(self.blocks.mlstm,
                                              self.blocks.slstm)):
            for j, blk in enumerate(group):
                x = self._mlstm_decode(x, blk, cache_view(cache["mlstm"], i,
                                                          j))
            sc = cache_view(cache["slstm"], i)
            x, carry = slstm_block_apply(
                x, sblk, cfg, (sc["c"], sc["n"], sc["m"], sc["h"]),
                kernels=kernels)
            for key, new in zip(("c", "n", "m", "h"), carry):
                sc[key].copy_(new)
        for i, blk in enumerate(self.tail):
            x = self._mlstm_decode(x, blk, cache_view(cache["tail"], i))
        x = L.norm_apply(x, self.final_norm, cfg.norm, cfg.norm_eps,
                         kernels=kernels)
        return x @ self.embed.t(), cache
