"""Dense GQA transformer LM of the port (counterpart of the dense family of
``repro/models/transformer.py``).

One ``Block`` module per layer in a ``ModuleList`` takes the place of the
JAX package's scanned, layer-stacked parameters.  Surface:

    init(generator)                       fill the weights from a seed
    forward_logits(tokens) -> logits      (B, S) -> (B, S, V) f32
    loss(batch) -> (loss, metrics)        the training objective
    init_cache(batch_size, seq_len) -> cache
    decode_step(cache, tokens, pos) -> (logits, cache)

``use_kernels`` (True by default) sends RMSNorm and prefill attention of
CUDA tensors to the hand-written kernels, under autograd too (their
backward is the gradient of the plain version); set it to False for the
plain PyTorch path, which the checks use as their reference on the card.
``remat`` (True by default, as the reference's ``build_model``) recomputes
each layer's activations in the backward (``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint`` on the reference's scanned layer); it
acts only while grad mode is on, so serving is unchanged.

Under rules that split ``heads``, ``ff`` and ``vocab`` over a grid's
``model`` axis (``repro_torch.sharding``; an entry point sets them with
``use_rules``), each rank computes its share of every layer's attention
and MLP and its rows of the tied embedding's logits, which stay the rank's
columns: ``forward_logits`` and ``decode_step`` return (B, S, V / M) and
``loss`` is vocab-parallel.  The residual stream, the norms and the token
embedding's gather are whole on every rank.  The rules are read once, at
the entry of each method, and passed down, so remat's recompute sees the
same ones.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.parallel.tensor import copy_to, replicated
from repro_torch.sharding import MeshRules, current_rules, part, tensor_axes


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = L.DEFAULT_DTYPE):
        super().__init__()
        self.attn_norm = L.make_norm(cfg.d_model, cfg.norm, device=device)
        self.attn = A.GQA(cfg, device=device, dtype=dtype)
        self.ffn_norm = L.make_norm(cfg.d_model, cfg.norm, device=device)
        self.ffn = L.MLP(cfg.d_model, cfg.d_ff, cfg.act, device=device,
                         dtype=dtype)


def layer_apply(x, p: Block, cfg: ArchConfig, *, positions,
                kernels: bool = True,
                rules: Optional[MeshRules] = None) -> torch.Tensor:
    h = L.norm_apply(x, p.attn_norm, cfg.norm, cfg.norm_eps,
                     kernels=kernels, rules=rules)
    x = x + A.gqa_apply(h, p.attn, cfg, positions=positions, kernels=kernels,
                        rules=rules)
    h2 = L.norm_apply(x, p.ffn_norm, cfg.norm, cfg.norm_eps,
                      kernels=kernels, rules=rules)
    return x + L.mlp_apply(h2, p.ffn, cfg.act, rules=rules)


def layer_decode(x, p: Block, cfg: ArchConfig, k_cache, v_cache, pos: int,
                 *, kernels: bool = True,
                 rules: Optional[MeshRules] = None,
                 seq_len: Optional[int] = None) -> torch.Tensor:
    """One-token step of a block; writes its K/V entry into the caches
    (B, S, Kv, hd), the rank's part of ``seq_len`` positions, in place."""
    h = L.norm_apply(x, p.attn_norm, cfg.norm, cfg.norm_eps,
                     kernels=kernels, rules=rules)
    a, _, _ = A.gqa_decode(h, p.attn, cfg, k_cache, v_cache, pos,
                           rules=rules, seq_len=seq_len)
    x = x + a
    h2 = L.norm_apply(x, p.ffn_norm, cfg.norm, cfg.norm_eps,
                      kernels=kernels, rules=rules)
    return x + L.mlp_apply(h2, p.ffn, cfg.act, rules=rules)


class LogitsFn(torch.autograd.Function):
    """x (N, d) @ embedᵀ -> (N, V) f32 from bf16 operands on the card.

    The backward takes the f32 cotangent to bf16 and returns dx and
    d(embed) in bf16, accumulated in f32 by the GEMMs: no f32 copy of the
    embedding.  (The reference's einsum transpose promotes the bf16 operand
    and keeps the cotangent f32; the card rounds the cotangent once.)"""

    @staticmethod
    def forward(ctx, x, embed):
        ctx.save_for_backward(x, embed)
        return torch.mm(x, embed.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, embed = ctx.saved_tensors
        gb = g.to(x.dtype)
        return gb @ embed, gb.t() @ x


class TransformerLM(nn.Module):
    """Dense transformer LM with tied embeddings; weights in (d_in, d_out)
    layout."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = L.DEFAULT_DTYPE, remat: bool = True):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP.md queue "
                f"1 item 10")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "untied embeddings (an lm_head) are not ported yet: "
                "ROADMAP.md queue 1 item 10 (dense variants)")
        self.cfg = cfg
        self.use_kernels = True
        self.remat = remat
        self.embed = L.empty_param(cfg.vocab_size, cfg.d_model, dtype=dtype,
                                   device=device)
        self.final_norm = L.make_norm(cfg.d_model, cfg.norm, device=device)
        self.blocks = nn.ModuleList(
            Block(cfg, device=device, dtype=dtype)
            for _ in range(cfg.n_layers))

    # ---------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TransformerLM":
        cfg = self.cfg
        self.embed.copy_(L.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                      dtype=self.embed.dtype))
        L.init_norms(self)
        for blk in self.blocks:
            blk.attn.init(generator)
            blk.ffn.init(generator)
        return self

    # ------------------------------------------------------------ forward
    def forward_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int -> logits (B, S, V) f32 (the rank's vocab
        columns under rules that split ``vocab``)."""
        cfg = self.cfg
        rules = current_rules()
        # the embedding is gathered through f32, as the JAX forward does
        embed = replicated(self.embed, tensor_axes(rules))
        x = embed.float()[tokens].to(self.embed.dtype)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            if remat:
                x = checkpoint(layer_apply, x, blk, cfg, positions=positions,
                               kernels=self.use_kernels, rules=rules,
                               use_reentrant=False)
            else:
                x = layer_apply(x, blk, cfg, positions=positions,
                                kernels=self.use_kernels, rules=rules)
        x = L.norm_apply(x, self.final_norm, cfg.norm, cfg.norm_eps,
                         kernels=self.use_kernels, rules=rules)
        return self._logits(x, rules)

    def _logits(self, x: torch.Tensor,
                rules: Optional[MeshRules] = None) -> torch.Tensor:
        """f32 logits from bf16 operands without rounding them to bf16.

        On the card, ``torch.mm(..., out_dtype=float32)`` accumulates and
        writes in f32 while reading the bf16 weights as they are; an f32
        copy of the tied 128256x2048 embedding would cost 1 GB of memory
        and twice the bytes per decode step.  It runs in ``LogitsFn``
        (this torch has no derivative for ``mm`` with ``out_dtype``), whose
        backward keeps the operands bf16 too.  The CPU
        backend has no ``out_dtype`` matmul, so there the operands are
        upcast.

        Where the rules split ``vocab`` (the reference's logits over
        ``vocab``), the rank's rows of the embedding give its columns of
        the logits: a region entered by ``copy_to``, left by the
        vocab-parallel loss.
        """
        vocab = part(self.cfg.vocab_size, "vocab", rules)
        if vocab.n > 1:
            x = copy_to(x, vocab.axes)
            embed = self.embed[vocab.slice]
        else:
            embed = replicated(self.embed, tensor_axes(rules))
        x2 = x.reshape(-1, x.shape[-1])
        if x2.is_cuda and x2.dtype != torch.float32:
            out = LogitsFn.apply(x2, embed)
        else:
            out = x2.float() @ embed.t().float()
        return out.reshape(*x.shape[:-1], out.shape[-1])

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: tokens and targets (B, S) int.  Returns (nll + z_loss +
        aux, {"nll", "z_loss", "aux"}), f32; aux is 0 for the dense
        model."""
        logits = self.forward_logits(batch["tokens"])
        nll, zl = L.softmax_xent(logits, batch["targets"], vocab=part(
            self.cfg.vocab_size, "vocab", current_rules()))
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
        return nll + zl + aux, {"nll": nll, "z_loss": zl, "aux": aux}

    # ------------------------------------------------------------- decode
    def init_cache(self, batch_size: int,
                   seq_len: int) -> Dict[str, torch.Tensor]:
        """{"k", "v": (n_layers, B, S, Kv, hd) bf16}.  Under rules with a
        grid (``use_rules``), the rank's block of that cache: its rows and
        its ``kv_seq`` slice, every key/value head, and ``"seq_len"``, the
        global length."""
        return A.make_rank_cache(
            lambda b, s: A.gqa_make_cache(self.cfg, b, s, self.cfg.n_layers,
                                          device=self.embed.device),
            batch_size, seq_len)

    def decode_step(self, cache: Dict[str, torch.Tensor],
                    tokens: torch.Tensor, pos: int):
        """tokens: (B, 1); pos: int.  Returns (logits (B,1,V) f32, cache);
        the cache is updated in place.  Under rules that split ``vocab`` the
        logits are the rank's columns; under rules that split ``kv_seq``
        the cache is the rank's slice (``init_cache``)."""
        cfg = self.cfg
        rules = current_rules()
        x = self.embed[tokens]
        for i, blk in enumerate(self.blocks):
            x = layer_decode(x, blk, cfg, cache["k"][i], cache["v"][i], pos,
                             kernels=self.use_kernels, rules=rules,
                             seq_len=cache.get(A.SEQ_LEN))
        x = L.norm_apply(x, self.final_norm, cfg.norm, cfg.norm_eps,
                         kernels=self.use_kernels, rules=rules)
        return self._logits(x, rules), cache
