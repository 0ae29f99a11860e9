"""Zamba2-style hybrid LM of the port (counterpart of
``repro/models/zamba.py``): a Mamba2 backbone plus one *shared* attention
block, the dense family's ``Block``, applied after every
``hybrid_attn_every`` mamba blocks with one weight set and one KV cache per
application.  Blocks past the last whole group form the ``tail``.

Parameters: ``blocks.<i>.<j>.{norm,mamba}`` (i < n_super, j <
hybrid_attn_every), ``tail.<i>.{norm,mamba}``, ``shared_attn``, ``embed``
(tied) and ``final_norm``.  Surface as ``TransformerLM``:

    init(generator)                       fill the weights from a seed
    forward_logits(tokens) -> logits      (B, S) -> (B, S, V)
    loss(batch) -> (loss, metrics)        the training objective
    init_cache(batch_size, seq_len) -> cache
    decode_step(cache, tokens, pos) -> (logits, cache)

Logits come out in the model's dtype (bf16 for a bf16 model), as the
reference computes them with no f32 accumulation type; the dense model's
are f32.  ``use_kernels`` (True by default) sends RMSNorm, prefill
attention and the SSD scan of CUDA tensors to the hand-written kernels,
under autograd too (their backward is the gradient of the plain version).
``remat`` (True by default) recomputes in the backward where the
reference's ``jax.checkpoint`` does: each super-block (its mamba blocks and
the shared attention's application) and each tail block; it acts only
while grad mode is on, so serving is unchanged.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.transformer import Block, layer_apply, layer_decode
from repro_torch.sharding import current_rules


class MambaBlock(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = L.DEFAULT_DTYPE):
        super().__init__()
        self.norm = L.make_norm(cfg.d_model, cfg.norm, device=device)
        self.mamba = SSM.Mamba(cfg, device=device, dtype=dtype)


def cache_view(cache: Dict[str, torch.Tensor], *index) -> Dict[str,
                                                                torch.Tensor]:
    """One block's slice of a stacked mamba cache, as views."""
    return {key: val[index] for key, val in cache.items()}


class ZambaLM(nn.Module):
    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = L.DEFAULT_DTYPE, remat: bool = True):
        super().__init__()
        if cfg.family != "hybrid" or cfg.ssm is None:
            raise ValueError(f"ZambaLM needs a hybrid config with an ssm "
                             f"section, got family {cfg.family!r}")
        if not cfg.tie_embeddings:
            raise NotImplementedError(
                "untied embeddings (an lm_head) are not ported yet: "
                "ROADMAP.md queue 1 item 10 (dense variants)")
        self.cfg = cfg
        self.use_kernels = True
        self.remat = remat
        every = cfg.hybrid_attn_every
        self.n_super = cfg.n_layers // every
        self.n_tail = cfg.n_layers - self.n_super * every

        def mamba_blocks(n):
            return nn.ModuleList(MambaBlock(cfg, device=device, dtype=dtype)
                                 for _ in range(n))

        self.embed = L.empty_param(cfg.vocab_size, cfg.d_model, dtype=dtype,
                                   device=device)
        self.final_norm = L.make_norm(cfg.d_model, cfg.norm, device=device)
        self.blocks = nn.ModuleList(mamba_blocks(every)
                                    for _ in range(self.n_super))
        self.shared_attn = Block(cfg, device=device, dtype=dtype)
        self.tail = mamba_blocks(self.n_tail)

    # ---------------------------------------------------------------- init
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "ZambaLM":
        cfg = self.cfg
        self.embed.copy_(L.embed_init(generator, cfg.vocab_size, cfg.d_model,
                                      dtype=self.embed.dtype))
        L.init_norms(self)
        for blk in self._mamba_blocks():
            blk.mamba.init(generator)
        self.shared_attn.attn.init(generator)
        self.shared_attn.ffn.init(generator)
        return self

    def _mamba_blocks(self):
        for group in self.blocks:
            yield from group
        yield from self.tail

    # ------------------------------------------------------------ forward
    def _mamba_block(self, x, blk: MambaBlock):
        h = L.norm_apply(x, blk.norm, self.cfg.norm, self.cfg.norm_eps,
                         kernels=self.use_kernels)
        return x + SSM.mamba_apply(h, blk.mamba, self.cfg,
                                   kernels=self.use_kernels)

    def _super_block(self, x, group, positions):
        """A group's mamba blocks, then the shared attention block."""
        for blk in group:
            x = self._mamba_block(x, blk)
        return layer_apply(x, self.shared_attn, self.cfg,
                           positions=positions, kernels=self.use_kernels)

    def forward_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens: (B, S) int -> logits (B, S, V) in the model's dtype."""
        cfg = self.cfg
        x = self.embed[tokens]
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        remat = self.remat and torch.is_grad_enabled()
        for group in self.blocks:
            if remat:
                x = checkpoint(self._super_block, x, group, positions,
                               use_reentrant=False)
            else:
                x = self._super_block(x, group, positions)
        for blk in self.tail:
            if remat:
                x = checkpoint(self._mamba_block, x, blk,
                               use_reentrant=False)
            else:
                x = self._mamba_block(x, blk)
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
        """{"mamba": per-block states stacked (n_super, every, ...),
        "attn_k"/"attn_v": (n_super, B, S, Kv, hd) bf16, one per
        application of the shared block, "tail": (n_tail, ...)}.  Under
        rules with a grid (``use_rules``), the rank's block of that cache:
        its rows of every leaf, its ``kv_seq`` slice of the attention caches
        with every key/value head, the mamba states whole, and
        ``"seq_len"``, the global length."""
        return A.make_rank_cache(self._make_cache, batch_size, seq_len)

    def _make_cache(self, batch_size: int, seq_len: int):
        cfg = self.cfg
        dev = self.embed.device
        every = cfg.hybrid_attn_every
        mamba = SSM.mamba_make_cache(cfg, self.n_super * every, batch_size,
                                     device=dev)
        kv = (self.n_super, batch_size, seq_len, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        cache = {
            "mamba": {key: val.reshape((self.n_super, every)
                                       + tuple(val.shape[1:]))
                      for key, val in mamba.items()},
            "attn_k": torch.zeros(kv, dtype=L.DEFAULT_DTYPE, device=dev),
            "attn_v": torch.zeros(kv, dtype=L.DEFAULT_DTYPE, device=dev),
        }
        if self.n_tail:
            cache["tail"] = SSM.mamba_make_cache(cfg, self.n_tail,
                                                 batch_size, device=dev)
        return cache

    def _mamba_decode(self, x, blk: MambaBlock, cache_blk):
        h = L.norm_apply(x, blk.norm, self.cfg.norm, self.cfg.norm_eps,
                         kernels=self.use_kernels)
        out, _ = SSM.mamba_decode(h, blk.mamba, self.cfg, cache_blk,
                                  kernels=self.use_kernels)
        return x + out

    def decode_step(self, cache, tokens: torch.Tensor, pos: int):
        """tokens: (B, 1); pos: int.  Returns (logits (B, 1, V) in the
        model's dtype, cache); the cache is updated in place.  Under rules
        that split ``kv_seq`` the attention caches are the rank's slice
        (``init_cache``); the mamba states run whole on every rank."""
        cfg = self.cfg
        rules = current_rules()
        x = self.embed[tokens]
        for i, group in enumerate(self.blocks):
            for j, blk in enumerate(group):
                x = self._mamba_decode(x, blk,
                                       cache_view(cache["mamba"], i, j))
            x = layer_decode(x, self.shared_attn, cfg, cache["attn_k"][i],
                             cache["attn_v"][i], pos,
                             kernels=self.use_kernels, rules=rules,
                             seq_len=cache.get(A.SEQ_LEN))
        for i, blk in enumerate(self.tail):
            x = self._mamba_decode(x, blk, cache_view(cache["tail"], i))
        x = L.norm_apply(x, self.final_norm, cfg.norm, cfg.norm_eps,
                         kernels=self.use_kernels)
        return x @ self.embed.t(), cache
