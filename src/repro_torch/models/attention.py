"""GQA attention of the port (counterpart of ``repro/models/attention.py``).

Prefill attention runs the hand-written flash-attention kernel on a CUDA
tensor; on the CPU (and on the plain path, ``kernels=False``) it is the
JAX package's full or blocked attention.  Decode attention is the JAX
package's chunked partial softmax in plain PyTorch: it is plain XLA there
too, not a Pallas kernel.  MLA waits for a later slice.

Under rules that split ``kv_seq`` (``make_rules(seq_shard=True)`` over
``model``, ``long_ctx=True`` over ``(data, model)``) a rank's KV cache is
its slice of the sequence, and decode attention is flash-decode: each
rank's partial softmax over its slice, merged across the ``kv_seq`` axes
by ``pmax`` and ``psum`` (:func:`sharded_decode_attention`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF
from repro_torch.models import layers as L
from repro_torch.parallel import collectives as PX
from repro_torch.parallel.mesh import axes_size
from repro_torch.parallel.tensor import copy_to, reduce_from, replicated
from repro_torch.sharding import (MeshRules, Part, current_rules, part,
                                  tensor_axes)


def _local_partial_softmax(q, k, v, valid, *, chunk: int = 1024,
                           softcap: float = 0.0):
    """Online-softmax partials over the KV cache, ``chunk`` keys at a time.

    q: (B,1,Kv,G,D); k/v: (B,Sl,Kv,Dv); valid: (Sl,) bool.
    Returns (m, l, acc): (B,Kv,G,1[,Dv]) f32 partial stats.  Scores are f32
    from the cache's dtype, as the JAX einsum's ``preferred_element_type``.
    """
    B, Sl, Kv, _ = k.shape
    Dv = v.shape[-1]
    G = q.shape[3]
    scale = 1.0 / math.sqrt(q.shape[-1])
    while Sl % chunk:
        chunk -= 1
    qf = q.float()
    m = torch.full((B, Kv, G, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Kv, G, 1), device=q.device)
    a = torch.zeros((B, Kv, G, 1, Dv), device=q.device)
    for c0 in range(0, Sl, chunk):
        kb, vb = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kb.float()) * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        s = torch.where(valid[c0:c0 + chunk], s, NEG_INF)
        m1 = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m1[..., None])
        corr = torch.exp(m - m1)
        l = l * corr + p.sum(dim=-1)
        a = a * corr[..., None] + torch.einsum("bkgqs,bskd->bkgqd", p,
                                               vb.float())
        m = m1
    return m, l, a


def merge_partials(m, l, acc, *, pmax, psum):
    """Flash-decode's merge of the shards' partials (m, l, acc) of
    :func:`_local_partial_softmax`: ``gm = pmax(m)``, each shard's ``l`` and
    ``acc`` rescaled by ``exp(m - gm)`` and summed, ``acc / max(l,
    1e-30)``.  ``pmax(m)`` reduces over the shards, ``psum(l, acc)`` sums
    both.  A shard with no valid key holds ``m = -1e30`` and contributes
    ``exp(-1e30 - gm) = 0`` exactly."""
    gm = pmax(m)
    corr = torch.exp(m - gm)
    l, acc = psum(l * corr, acc * corr[..., None])
    return acc / torch.clamp(l[..., None], min=1e-30)


def _grid_reductions(axes):
    """``merge_partials``' reductions over grid axes: ``pmax`` of m, and
    ``l`` and ``acc`` summed in one all-reduce (each element's sum is the
    same as in two)."""
    def pmax(m):
        return PX.pmax(m, axes)

    def psum(l, acc):
        flat = PX.psum(torch.cat([l.reshape(-1), acc.reshape(-1)]), axes)
        return (flat[:l.numel()].view_as(l),
                flat[l.numel():].view_as(acc))

    return dict(pmax=pmax, psum=psum)


def seq_part(seq_len: Optional[int], local: int,
             rules: Optional[MeshRules] = None) -> Part:
    """The rank's :class:`Part` of a KV cache's ``seq_len`` positions under
    ``rules`` (the active ones by default): its ``kv_seq`` slice, whole
    where the drop rule keeps the sequence whole (``seq_len`` not divisible
    by the shards).  ``seq_len`` None means a whole cache of ``local``
    positions, which rules that split ``kv_seq`` refuse: the rank's slice
    alone does not say which positions it holds.  Raises unless the rank's
    cache holds ``local`` positions, that part's."""
    if seq_len is None:
        rules = rules if rules is not None else current_rules()
        if rules is not None and axes_size(
                rules.mesh, rules.rules.get("kv_seq")) > 1:
            raise ValueError(
                f"rules split kv_seq over {rules.rules['kv_seq']!r}, but "
                f"the cache of {local} positions does not give the global "
                f"length: make it with init_cache under the rules")
        seq_len = local
    seq = part(seq_len, "kv_seq", rules)
    if seq.hi - seq.lo != local:
        raise ValueError(
            f"the rank's KV cache holds {local} positions; its part of "
            f"{seq_len} under the rules is {seq.hi - seq.lo}: make the "
            f"cache under the rules (init_cache)")
    return seq


def sharded_decode_attention(q, k_cache, v_cache, pos: int, *,
                             softcap: float = 0.0,
                             seq_len: Optional[int] = None,
                             rules: Optional[MeshRules] = None
                             ) -> torch.Tensor:
    """Decode attention of q (B, 1, H, D) over the KV cache, keys ``<= pos``
    valid (``repro/models/attention.py::sharded_decode_attention``).

    ``k_cache``/``v_cache`` (B, S_loc, Kv, D) are the rank's part of a cache
    of ``seq_len`` positions (default: the whole cache, ``S_loc``), split
    over the ``kv_seq`` axes of ``rules`` (the active rules by default):
    rank ``index`` of ``n`` holds positions ``[index * S_loc, (index + 1) *
    S_loc)``, ``index`` row-major over the axes in the rule's order.  With
    one shard, or where the drop rule leaves the sequence whole, this is
    the chunked partial softmax over the whole cache; else each rank's
    partials over its slice merge across the axes (:func:`merge_partials`).
    Every rank returns every head's output."""
    B, _, H, D = q.shape
    S_loc, Kv = k_cache.shape[1], k_cache.shape[2]
    Dv = v_cache.shape[-1]
    seq = seq_part(seq_len, S_loc, rules)
    qg = q.reshape(B, 1, Kv, H // Kv, D)
    valid = seq.lo + torch.arange(S_loc, device=q.device) < pos + 1
    m, l, acc = _local_partial_softmax(qg, k_cache, v_cache, valid,
                                       softcap=softcap)
    if seq.n == 1:
        out = acc / torch.clamp(l[..., None], min=1e-30)
    else:
        out = merge_partials(m, l, acc, **_grid_reductions(seq.axes))
    return out.reshape(B, 1, H, Dv).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Projections wq (d, H*hd), wk/wv (d, Kv*hd), wo (H*hd, d)."""

    def __init__(self, cfg: ArchConfig, *, device=None,
                 dtype: torch.dtype = L.DEFAULT_DTYPE):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        H, Kv = cfg.n_heads, cfg.n_kv_heads
        self.wq = L.empty_param(d, H * hd, dtype=dtype, device=device)
        self.wk = L.empty_param(d, Kv * hd, dtype=dtype, device=device)
        self.wv = L.empty_param(d, Kv * hd, dtype=dtype, device=device)
        self.wo = L.empty_param(H * hd, d, dtype=dtype, device=device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.copy_(L.dense_init(generator, *w.shape, dtype=w.dtype))


def _kv_range(heads: Part, cfg: ArchConfig) -> Tuple[int, int]:
    """The key/value heads [k0, k1) that the query heads of ``heads``
    read."""
    G = cfg.n_heads // cfg.n_kv_heads
    return heads.lo // G, (heads.hi - 1) // G + 1


def _kv_for_heads(k, v, heads: Part, cfg: ArchConfig):
    """k, v (B, S, k1-k0, hd) of :func:`_kv_range` laid out for the rank's
    query heads: as they are when each of them serves the same number of
    consecutive query heads; else one key/value head per query head."""
    G = cfg.n_heads // cfg.n_kv_heads
    k0, k1 = _kv_range(heads, cfg)
    if k1 - k0 == 1 or (heads.lo % G == 0 and heads.hi % G == 0):
        return k, v
    idx = torch.tensor([h // G - k0 for h in range(heads.lo, heads.hi)],
                       device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


def _heads(cfg: ArchConfig, rules: Optional[MeshRules]) -> Part:
    return part(cfg.n_heads, "heads", rules)


def _qkv(x, p: GQA, cfg: ArchConfig, heads: Part, tp=()):
    """q of the rank's query heads and k, v of the key/value heads they
    read, (B, S, heads, hd); every head when ``heads`` is whole."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    if heads.n == 1:
        q = x @ replicated(p.wq, tp)
        k, v = x @ replicated(p.wk, tp), x @ replicated(p.wv, tp)
    else:
        k0, k1 = _kv_range(heads, cfg)
        q = x @ p.wq[:, heads.lo * hd:heads.hi * hd]
        k, v = x @ p.wk[:, k0 * hd:k1 * hd], x @ p.wv[:, k0 * hd:k1 * hd]
    return (q.reshape(B, S, -1, hd), k.reshape(B, S, -1, hd),
            v.reshape(B, S, -1, hd))


def _out(o, p: GQA, cfg: ArchConfig, heads: Part, tp=()):
    """o (B, S, heads, hd) through ``wo``: the rank's rows of it, the
    partial outputs summed over the split's axes."""
    o = o.reshape(o.shape[0], o.shape[1], -1)
    if heads.n == 1:
        return o @ replicated(p.wo, tp)
    hd = cfg.resolved_head_dim
    return reduce_from(o @ p.wo[heads.lo * hd:heads.hi * hd], heads.axes)


def _rope_dims(cfg: ArchConfig) -> int:
    rd = int(cfg.resolved_head_dim * cfg.rope_fraction)
    return rd - (rd % 2)


def gqa_apply(x, p: GQA, cfg: ArchConfig, *, positions: torch.Tensor,
              kernels: bool = True,
              rules: Optional[MeshRules] = None) -> torch.Tensor:
    """Causal prefill attention.  x: (B,S,D); positions: (S,)."""
    heads, tp = _heads(cfg, rules), tensor_axes(rules)
    x = copy_to(x, heads.axes)
    q, k, v = _qkv(x, p, cfg, heads, tp)
    rd = _rope_dims(cfg)
    if rd:
        cos, sin = L.rope_angles(positions, rd, cfg.rope_theta)
        q = L.apply_rope(q, cos, sin, rd)
        k = L.apply_rope(k, cos, sin, rd)
    if heads.n > 1:
        k, v = _kv_for_heads(k, v, heads, cfg)
    if kernels and x.is_cuda:
        o = flash_attention(q, k, v, causal=True, softcap=cfg.logit_softcap)
    elif q.shape[1] * k.shape[1] <= 1024 * 1024:
        o = L.full_attention(q, k, v, causal=True, softcap=cfg.logit_softcap)
    else:
        o = L.blocked_attention(q, k, v, causal=True,
                                softcap=cfg.logit_softcap)
    return _out(o, p, cfg, heads, tp)


def gqa_make_cache(cfg: ArchConfig, batch: int, seq: int, n_layers: int, *,
                   device=None,
                   dtype: torch.dtype = L.DEFAULT_DTYPE
                   ) -> Dict[str, torch.Tensor]:
    shape = (n_layers, batch, seq, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# the key of a rank's cache (``make_rank_cache``) that holds the global
# length its ``kv_seq`` slice is a part of
SEQ_LEN = "seq_len"


def make_rank_cache(make, batch_size: int, seq_len: int):
    """``make(rows, positions)``, a cache of that many rows and positions,
    for this rank: under the active rules, with a grid, its block of a
    (``batch_size``, ``seq_len``) cache, its ``kv_batch`` rows and its
    ``kv_seq`` slice, with ``SEQ_LEN``; else the whole cache."""
    rules = current_rules()
    if rules is None or rules.mesh is None:
        return make(batch_size, seq_len)
    rows = part(batch_size, "kv_batch", rules)
    seq = part(seq_len, "kv_seq", rules)
    cache = make(rows.hi - rows.lo, seq.hi - seq.lo)
    cache[SEQ_LEN] = seq_len
    return cache


def gqa_decode(x, p: GQA, cfg: ArchConfig, k_cache, v_cache, pos: int, *,
               rules: Optional[MeshRules] = None,
               seq_len: Optional[int] = None):
    """x: (B,1,D); caches (B,S,Kv,hd), the rank's part of ``seq_len``
    positions (default: whole); pos: index of the new token.

    Writes the new K/V entry into the caches in place (the JAX function
    returns updated copies; in place saves a cache copy per layer and step)
    and returns (out, k_cache, v_cache); only the rank whose ``kv_seq``
    slice holds ``pos`` writes, at ``pos`` less its slice's start.  Under
    rules that split ``heads`` the caches keep every key/value head
    (``kv_heads`` maps to nothing).  With a whole cache each rank computes
    its query heads against the key/value heads they read; with a
    sequence-sharded one every rank computes every head over its slice, as
    the reference's shard_map takes q whole, merges them across the
    ``kv_seq`` axes, and keeps its own heads' output for the row-parallel
    ``wo``.
    """
    heads = _heads(cfg, rules)
    seq = seq_part(seq_len, k_cache.shape[1], rules)
    if not 0 <= pos < seq.size:
        raise IndexError(f"position {pos} outside a cache of {seq.size}")
    B, hd = x.shape[0], cfg.resolved_head_dim
    qh = heads if seq.n == 1 else Part(cfg.n_heads)
    q = (x @ p.wq[:, qh.lo * hd:qh.hi * hd]).reshape(B, 1, -1, hd)
    rd = _rope_dims(cfg)
    if rd:
        posv = torch.tensor([pos], device=x.device)
        cos, sin = L.rope_angles(posv, rd, cfg.rope_theta)
        q = L.apply_rope(q, cos, sin, rd)
    if seq.lo <= pos < seq.hi:
        k = (x @ p.wk).reshape(B, 1, -1, hd)
        v = (x @ p.wv).reshape(B, 1, -1, hd)
        if rd:
            k = L.apply_rope(k, cos, sin, rd)
        k_cache[:, pos - seq.lo] = k[:, 0].to(k_cache.dtype)
        v_cache[:, pos - seq.lo] = v[:, 0].to(v_cache.dtype)
    if seq.n > 1:
        o = sharded_decode_attention(q, k_cache, v_cache, pos,
                                     softcap=cfg.logit_softcap,
                                     seq_len=seq.size, rules=rules)
        o = o[:, :, heads.lo:heads.hi]
    else:
        kc, vc = k_cache, v_cache
        if heads.n > 1:
            k0, k1 = _kv_range(heads, cfg)
            kc, vc = _kv_for_heads(kc[:, :, k0:k1], vc[:, :, k0:k1], heads,
                                   cfg)
        o = sharded_decode_attention(q, kc, vc, pos,
                                     softcap=cfg.logit_softcap,
                                     seq_len=seq.size, rules=rules)
    return _out(o, p, cfg, heads), k_cache, v_cache
