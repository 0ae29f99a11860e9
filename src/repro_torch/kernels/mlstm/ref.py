"""Plain PyTorch mLSTM (xLSTM's matrix-memory cell): the CPU path, the CUDA
kernel's oracle and its backward, the decode step and the token-by-token
oracle of the tests.

Counterparts of ``repro/models/xlstm.py``: ``mlstm_chunked``,
``mlstm_step`` and ``mlstm_sequential_ref``, with the same shapes and the
same f32 arithmetic.  The carry is (C (B, H, D, D), n (B, H, D), m (B, H)),
all f32; the stabilized recurrence, per token, is

    m' = max(log sigmoid(f) + m, i)
    C' = exp(log sigmoid(f) + m - m') C + exp(i - m') k v^T
    n' = exp(log sigmoid(f) + m - m') n + exp(i - m') k
    h  = C'^T q / max(|n'.q|, exp(-m'))          (q scaled by 1/sqrt(D))

and ``mlstm_chunked`` computes it a chunk of Q tokens at a time: with b_t
the cumsum of log sigmoid(f) over the chunk, a_s = i_s - b_s and the
stabilizer rm_t = max(cummax(a)_t, m0),

    scores[t, s] = (q_t . k_s) exp(a_s - rm_t)               (s <= t)
    h_t = (sum_s scores[t, s] v_s + exp(m0 - rm_t) C0^T q_t)
          / max(|sum_s scores[t, s] + exp(m0 - rm_t) n0 . q_t|,
                exp(-(b_t + rm_t)))

and carries C' = exp(m0 - R) C0 + sum_s exp(a_s - R) k_s v_s^T (n' alike)
and m' = b_Q + R, R = rm_Q.  It materialises (B, H, Q, Q) f32 tensors: at
B 4, H 4 and Q 256 each is 4 MB.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_BIG = -1e30

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def check_chunk(S: int, chunk: int) -> None:
    """The sequence must split into whole chunks."""
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")


def zero_carry(B: int, H: int, D: int, device=None) -> Carry:
    """The carry before the first token: C = n = 0, m = -1e30."""
    return (torch.zeros(B, H, D, D, device=device),
            torch.zeros(B, H, D, device=device),
            torch.full((B, H), NEG_BIG, device=device))


def mlstm_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  i_raw: torch.Tensor, f_raw: torch.Tensor, *, chunk: int,
                  carry: Optional[Carry] = None
                  ) -> Tuple[torch.Tensor, Carry]:
    """q, k, v: (B, S, H, D); i_raw, f_raw: (B, S, H).  Returns (h
    (B, S, H, D) in q's dtype, the final carry)."""
    B, S, H, D = q.shape
    check_chunk(S, chunk)
    nc = S // chunk
    scale = 1.0 / math.sqrt(D)

    qc = (q.float() * scale).reshape(B, nc, chunk, H, D)
    kc = k.float().reshape(B, nc, chunk, H, D)
    vc = v.float().reshape(B, nc, chunk, H, D)
    lc = F.logsigmoid(f_raw.float()).reshape(B, nc, chunk, H)
    ic = i_raw.float().reshape(B, nc, chunk, H)
    C, n, m0 = zero_carry(B, H, D, q.device) if carry is None else carry
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool,
                                device=q.device))

    hs = []
    for c in range(nc):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]          # (B, Q, H, D)
        b = torch.cumsum(lc[:, c], dim=1)                   # (B, Q, H)
        a = ic[:, c] - b
        rm = torch.maximum(torch.cummax(a, dim=1).values, m0[:, None, :])
        m_t = b + rm

        qk = torch.einsum("bqhd,bshd->bhqs", qb, kb)
        # a select, not a product with a mask: above the diagonal the
        # exponent is positive and may overflow, and inf * 0 would be NaN
        w = torch.where(tri, torch.exp(a.transpose(1, 2)[:, :, None, :]
                                       - rm.transpose(1, 2)[:, :, :, None]),
                        0.0)                                # (B, H, t, s)
        scores = qk * w

        inter_scale = torch.exp(m0[:, :, None] - rm.transpose(1, 2))
        inter = torch.einsum("bhdk,bqhd->bhqk", C, qb)     # C^T q
        num = torch.einsum("bhqs,bshd->bhqd", scores, vb) \
            + inter * inter_scale[..., None]
        den = scores.sum(dim=-1) \
            + torch.einsum("bhd,bqhd->bhq", n, qb) * inter_scale
        h = num / torch.maximum(den.abs(),
                                torch.exp(-m_t).transpose(1, 2))[..., None]
        hs.append(h.transpose(1, 2))                        # (B, Q, H, D)

        R = rm[:, -1, :]                                    # (B, H)
        decay_in = torch.exp(a - R[:, None, :])             # (B, Q, H)
        kd = kb * decay_in[..., None]
        C = C * torch.exp(m0 - R)[:, :, None, None] \
            + torch.einsum("bshd,bshe->bhde", kd, vb)
        n = n * torch.exp(m0 - R)[:, :, None] + kd.sum(dim=1)
        m0 = b[:, -1, :] + R
    h = torch.stack(hs, dim=1).reshape(B, S, H, D)
    return h.to(q.dtype), (C, n, m0)


def mlstm_backward_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       i_raw: torch.Tensor, f_raw: torch.Tensor,
                       gh: Optional[torch.Tensor],
                       gcarry: Tuple[Optional[torch.Tensor], ...], *,
                       chunk: int) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv, di_raw, df_raw) of ``mlstm_chunked`` at the incoming
    gradients ``gh`` of h and ``gcarry`` of the final (C, n, m) (None: that
    output is not differentiated): autograd of the plain version,
    recomputed.  It is what the JAX package's training path differentiates
    (its Pallas kernel is forward-only), and it builds the (B, H, Q, Q)
    intermediates ``mlstm_chunked`` does, a chunk at a time."""
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_()
                       for t in (q, k, v, i_raw, f_raw))
        h, carry = mlstm_chunked(*leaves, chunk=chunk)
        pairs = [(o, g) for o, g in zip((h, *carry), (gh, *gcarry))
                 if g is not None]
        return torch.autograd.grad([o for o, _ in pairs], leaves,
                                   [g for _, g in pairs])


def mlstm_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_raw: torch.Tensor, f_raw: torch.Tensor, carry: Carry
               ) -> Tuple[torch.Tensor, Carry]:
    """One token.  q, k, v: (B, H, D); gates: (B, H).  Returns (h in q's
    dtype, the new carry)."""
    C, n, m = carry
    D = q.shape[-1]
    qf = q.float() / math.sqrt(D)
    kf, vf = k.float(), v.float()
    lf = F.logsigmoid(f_raw.float())
    ii = i_raw.float()
    m_new = torch.maximum(lf + m, ii)
    i_s = torch.exp(ii - m_new)
    f_s = torch.exp(lf + m - m_new)
    C = C * f_s[..., None, None] + i_s[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", kf, vf)
    n = n * f_s[..., None] + i_s[..., None] * kf
    num = torch.einsum("bhde,bhd->bhe", C, qf)
    den = torch.einsum("bhd,bhd->bh", n, qf)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (C, n, m_new)


def mlstm_sequential_ref(q, k, v, i_raw, f_raw,
                         carry: Optional[Carry] = None):
    """Token-by-token oracle (tests only)."""
    B, S, H, D = q.shape
    if carry is None:
        carry = zero_carry(B, H, D, q.device)
    hs = []
    for t in range(S):
        h, carry = mlstm_step(q[:, t], k[:, t], v[:, t], i_raw[:, t],
                              f_raw[:, t], carry)
        hs.append(h)
    return torch.stack(hs, dim=1), carry
