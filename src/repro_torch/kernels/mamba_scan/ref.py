"""Plain PyTorch SSD (Mamba2 scan): the CPU path, the CUDA kernel's oracle
and its backward, the decode step and the token-by-token oracle of the
tests.

Counterparts of ``repro/models/ssm.py``: ``ssd_chunked``, ``ssd_step`` and
``ssd_sequential_ref``, with the same shapes and the same f32 arithmetic:

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t
    y_t = C_t . h_t

One difference from the reference: the cumulative sum b of the f32 log
decays dt·A over a chunk is taken in f64.  Every decay is exp(b_t - b_s),
a difference of two cumsums; in f32 each carries an error of order
|b|·2⁻²⁴, which at Q 256 and |dt·A| ≈ 1 (|b| in the hundreds) puts
errors of 1e-4 relative into the decays next to the diagonal, and hence
into y, beyond the reference's own f32 tolerance for this scan.  The CUDA
kernel takes the same sum in f64, so the two agree.

``ssd_chunked`` materialises (Bt, n_chunks, H, Q, Q) tensors (the decay
matrix L, C·Bᵀ and their product in f32, the segment sums in f64); at
B 4, S 1024, 64 heads and Q 256 each f32 one is 268 MB.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def check_chunk(S: int, chunk: int) -> None:
    """The sequence must split into whole chunks."""
    if chunk <= 0 or S % chunk:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"chunk {chunk}")


def _segsum(cs: torch.Tensor) -> torch.Tensor:
    """cs: (..., Q) f64 cumsum of log-decays -> (..., Q, Q) f32
    lower-triangular segment sums out[t, s] = b_t - b_s, -inf above the
    diagonal, so that its exponential is 0 there."""
    Q = cs.shape[-1]
    diff = (cs[..., :, None] - cs[..., None, :]).float()
    mask = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=cs.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel SSD.

    x: (Bt, S, H, P); dt: (Bt, S, H) > 0; A: (H,) < 0; B/C: (Bt, S, G, N)
    with H % G == 0.  Returns (y (Bt, S, H, P) in x's dtype, final state
    (Bt, H, P, N) f32).
    """
    Bt, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    check_chunk(S, chunk)
    nc = S // chunk

    xf = x.float() * dt.float()[..., None]              # discretised input
    la = dt.float() * A.float()                          # (Bt, S, H)
    xc = xf.reshape(Bt, nc, chunk, H, P)
    lac = la.reshape(Bt, nc, chunk, H)
    Bc = B.float().reshape(Bt, nc, chunk, G, N)
    Cc = C.float().reshape(Bt, nc, chunk, G, N)
    Bh = Bc.repeat_interleave(rep, dim=3)                # (Bt,nc,Q,H,N)
    Ch = Cc.repeat_interleave(rep, dim=3)

    b_end = torch.cumsum(lac.double(), dim=2)            # (Bt,nc,Q,H) f64
    total = b_end[:, :, -1, :]                           # (Bt,nc,H)

    # within-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(b_end.permute(0, 1, 3, 2)))  # (Bt,nc,H,Q,Q)
    CB = torch.einsum("bcqhn,bcshn->bchqs", Ch, Bh)
    y_diag = torch.einsum("bchts,bcshp->bcthp", CB * Lmat, xc)

    # chunk states
    decay_states = torch.exp((total[:, :, None, :] - b_end).float())
    states = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", decay_states, Bh, xc)

    # cross-chunk recurrence
    state = (torch.zeros(Bt, H, P, N, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * torch.exp(total[:, c].float())[:, :, None, None] \
            + states[:, c]
    prev_states = torch.stack(prev, dim=1)               # (Bt,nc,H,P,N)

    # inter-chunk output
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, prev_states,
                         torch.exp(b_end.float()))
    y = (y_diag + y_off).reshape(Bt, S, H, P)
    return y.to(x.dtype), state


def ssd_backward_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                     B: torch.Tensor, C: torch.Tensor,
                     gy: Optional[torch.Tensor],
                     gstate: Optional[torch.Tensor], *, chunk: int
                     ) -> Tuple[torch.Tensor, ...]:
    """(dx, ddt, dA, dB, dC) of ``ssd_chunked`` at the incoming gradients
    ``gy`` of y and ``gstate`` of the final state (None: that output is
    not differentiated): autograd of the plain version, recomputed.  It is
    what the JAX package's training path differentiates (its Pallas kernel
    is forward-only), and it builds the (Bt, n_chunks, H, Q, Q)
    intermediates ``ssd_chunked`` does."""
    with torch.enable_grad():
        leaves = tuple(t.detach().requires_grad_()
                       for t in (x, dt, A, B, C))
        outs = ssd_chunked(*leaves, chunk=chunk)
        pairs = [(o, g) for o, g in zip(outs, (gy, gstate)) if g is not None]
        return torch.autograd.grad([o for o, _ in pairs], leaves,
                                   [g for _, g in pairs])


def ssd_step(state: torch.Tensor, x_t: torch.Tensor, dt_t: torch.Tensor,
             A: torch.Tensor, B_t: torch.Tensor, C_t: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One token.  state: (Bt, H, P, N) f32; x_t: (Bt, H, P); dt_t:
    (Bt, H); B_t/C_t: (Bt, G, N).  Returns (y_t in x_t's dtype, new
    state)."""
    rep = x_t.shape[1] // B_t.shape[1]
    dA = torch.exp(dt_t.float() * A.float())
    Bh = B_t.repeat_interleave(rep, dim=1).float()      # (Bt, H, N)
    Ch = C_t.repeat_interleave(rep, dim=1).float()
    xd = x_t.float() * dt_t.float()[..., None]
    state = state * dA[..., None, None] + torch.einsum("bhp,bhn->bhpn",
                                                       xd, Bh)
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y.to(x_t.dtype), state


def ssd_sequential_ref(x, dt, A, B, C, *, init_state=None):
    """Token-by-token oracle (tests only)."""
    Bt, S, H, P = x.shape
    N = B.shape[-1]
    state = (torch.zeros(Bt, H, P, N, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        y, state = ssd_step(state, x[:, t], dt[:, t], A, B[:, t], C[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), state
