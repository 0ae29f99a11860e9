"""The rounding of the bf16 tensor-core paths of K2 (flash attention), K3
(SSD scan) and K4 (chunked mLSTM), emulated in plain PyTorch on the CPU and
held against the JAX package's Pallas kernels (interpret mode, as
tests/test_kernels.py runs them) and against the port's plain versions, on
numpy inputs from a seed.

The CUDA kernels cannot run here; these emulations do what their bf16
paths do, product by product, so that the tolerances the card holds them
to (chip_smoke.py's ``TOL``) are known to leave room for the roundings the
tensor cores add:

- K2: scores from bf16 q and k in f32, online softmax over 64-key tiles in
  f32, the probabilities P rounded to bf16 before P·V (the one rounding the
  f32 reference does not make), the row sum taken of the f32 P.
- K3: the products of bf16 inputs (C·Bᵀ, and x in W'·x and xᵀ·B') are
  exact; each f32 operand of a product -- the intra-chunk weight
  W' = (C·Bᵀ)·exp(b_t - b_s)·dt_s, the state, and the scaled
  B' = exp(b_Q - b_s)·dt_s·B_s -- is split into a bf16 pair hi + lo,
  hi = bf16(v), lo = bf16(v - hi), one product each.
- K4: the scores q·kᵀ from bf16 q and k are exact products summed in f32,
  scaled by 1/√D after the sum; the gate chain, the row sums (den) and
  q·n are f32.  Each f32 operand of a product is a bf16 pair: the state
  C entering a chunk (stored as a pair by the state stage, read by the
  inter-chunk term q·C), the weighted scores P of P·V, and the scaled keys
  k ∘ exp(a - R) of the state update (k ∘ exp(a - R))ᵀ·v.

Tolerances: K2 bf16 2e-2 (tests/test_kernels.py::_tol); K3 y 4e-2 and the
final state 1e-3 (test_ssd_kernel_sweep); K4 h bf16 2e-2, C and n 1e-3,
m 1e-4 (test_mlstm_kernel_sweep, with _tol's bf16 bound for h).  The
``single_rounding_misses`` tests show why K3 and K4 split their f32
operands into pairs: rounded once to bf16, each of them puts an output
outside its bound.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.mamba_scan.ops import ssd as jax_ssd
from repro.kernels.mlstm.ops import mlstm as jax_mlstm
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba_scan.ref import ssd_chunked
from repro_torch.kernels.mlstm.ref import mlstm_chunked

ATTN_TOL = dict(rtol=2e-2, atol=2e-2)
Y_TOL = dict(rtol=4e-2, atol=4e-2)
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
H_TOL = dict(rtol=2e-2, atol=2e-2)
M_TOL = dict(rtol=1e-4, atol=1e-4)
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """f32 -> bf16 (round to nearest even) -> f32."""
    return t.to(torch.bfloat16).float()


def _split(t: torch.Tensor):
    """An f32 tensor as the bf16 pair (hi, lo) with hi + lo ~ t."""
    hi = _bf16(t)
    return hi, _bf16(t - hi)


def attention_tc(q, k, v, *, causal, softcap=0.0, block_k=64):
    """K2's bf16 path.  q: (B, S, H, D); k/v: (B, S, Kv, D) bf16."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q.float().permute(0, 2, 1, 3)                       # (B, H, S, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(G, dim=1)
    m = torch.full((B, H, S, 1), NEG_INF)
    l = torch.zeros(B, H, S, 1)
    acc = torch.zeros(B, H, S, D)
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, block_k):
        keys = torch.arange(k0, min(k0 + block_k, S))[None, :]
        s = qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2) \
            * (1.0 / math.sqrt(D))
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        if causal:
            s = torch.where(keys <= rows, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + _bf16(p) @ vf[:, :, k0:k0 + block_k]
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ssd_tc(x, dt, A, B, C, *, chunk, single=()):
    """K3's bf16 path.  x: (Bt, S, H, P) bf16; dt: (Bt, S, H) f32; A: (H,)
    f32; B/C: (Bt, S, G, N) bf16.  ``single`` names the operands rounded
    once to bf16 instead of split into a pair: "w" (the intra-chunk weight
    W'), "state" (the state and the scaled B of the state update)."""
    Bt, S, H, P = x.shape
    rep = H // B.shape[2]
    N = B.shape[3]

    def operand(t, name):
        return (_bf16(t), torch.zeros_like(t)) if name in single \
            else _split(t)

    xf = x.float().permute(0, 2, 1, 3)                       # (Bt, H, S, P)
    Bf = B.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    Cf = C.float().repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)
    dtf = dt.float().permute(0, 2, 1)                        # (Bt, H, S)
    state = torch.zeros(Bt, H, P, N)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    ys = []
    for c0 in range(0, S, chunk):
        xs, Bs, Cs = (t[:, :, c0:c0 + chunk] for t in (xf, Bf, Cf))
        dts = dtf[:, :, c0:c0 + chunk]
        b = torch.cumsum((dts * A[None, :, None]).double(), dim=-1)
        total = b[..., -1:]
        # b_t - b_s = bl_t + (b_t0 - b_s0) - bl_s in f32, bl the offset from
        # the start of the 64-row tile, each term rounded from the f64 sums
        start = b[..., (torch.arange(b.shape[-1]) // 64) * 64]
        bl = ((b - start) * LOG2E).float()
        dj = ((start[..., :, None] - start[..., None, :]) * LOG2E).float()
        seg = (bl[..., :, None] + dj) - bl[..., None, :]
        decay = torch.exp2(torch.where(tri, seg, 0.0))
        w = torch.where(tri, (Cs @ Bs.transpose(-1, -2)) * decay
                        * dts[..., None, :], 0.0)
        whi, wlo = operand(w, "w")
        hi, lo = operand(state, "state")
        y_off = (Cs @ hi.transpose(-1, -2) + Cs @ lo.transpose(-1, -2)) \
            * torch.exp(b.float())[..., None]
        ys.append(whi @ xs + wlo @ xs + y_off)
        scaled = Bs * (torch.exp((total - b).float()) * dts)[..., None]
        bhi, blo = operand(scaled, "state")
        xt = xs.transpose(-1, -2)
        state = state * torch.exp(total.float())[..., None] \
            + xt @ bhi + xt @ blo
    y = torch.cat(ys, dim=2).permute(0, 2, 1, 3).to(x.dtype)
    return y, state


def mlstm_tc(q, k, v, i_raw, f_raw, *, chunk, single=()):
    """K4's bf16 path.  q, k, v: (B, S, H, D) bf16; i_raw, f_raw: (B, S, H)
    f32.  ``single`` names the operands rounded once to bf16 instead of
    split into a pair: "state" (C in the inter-chunk term), "p" (the
    weighted scores in P·V), "keys" (the scaled keys of the state
    update)."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)

    def operand(t, name):
        return (_bf16(t), torch.zeros_like(t)) if name in single \
            else _split(t)

    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    lf = torch.nn.functional.logsigmoid(f_raw.float()).permute(0, 2, 1)
    ig = i_raw.float().permute(0, 2, 1)                      # (B, H, S)
    C = torch.zeros(B, H, D, D)
    n = torch.zeros(B, H, D)
    m0 = torch.full((B, H), NEG_INF)
    tri = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    hs = []
    for c0 in range(0, S, chunk):
        qs, ks, vs = (t[:, :, c0:c0 + chunk] for t in (qf, kf, vf))
        b = torch.cumsum(lf[..., c0:c0 + chunk], dim=-1)
        a = ig[..., c0:c0 + chunk] - b
        rm = torch.maximum(torch.cummax(a, dim=-1).values, m0[..., None])
        # inter-chunk term from the state as a pair, scaled after the sum
        isc = torch.exp(m0[..., None] - rm) * scale
        chi, clo = operand(C, "state")
        num = (qs @ chi + qs @ clo) * isc[..., None]
        den = (qs @ n[..., None])[..., 0] * isc
        # weights exp(a_s - rm_t) where s <= t, a select
        w = torch.exp(torch.where(tri, a[..., None, :] - rm[..., :, None],
                                  0.0))
        p = torch.where(tri, (qs @ ks.transpose(-1, -2)) * scale * w, 0.0)
        den = den + p.sum(-1)
        phi, plo = operand(p, "p")
        num = num + phi @ vs + plo @ vs
        hs.append(num / torch.maximum(den.abs(),
                                      torch.exp(-(b + rm)))[..., None])
        R = rm[..., -1]
        kd = ks * torch.exp(a - R[..., None])[..., None]
        khi, klo = operand(kd, "keys")
        decay = torch.exp(m0 - R)
        C = C * decay[..., None, None] + khi.transpose(-1, -2) @ vs \
            + klo.transpose(-1, -2) @ vs
        n = n * decay[..., None] + kd.sum(-2)
        m0 = b[..., -1] + R
    h = torch.cat(hs, dim=2).permute(0, 2, 1, 3).to(q.dtype)
    return h, (C, n, m0)


def _worst(out, ref, rtol, atol):
    """max |out - ref| / (atol + rtol |ref|): above 1 fails allclose."""
    out, ref = out.float(), torch.from_numpy(np.array(ref, np.float32))
    return ((out - ref).abs() / (atol + rtol * ref.abs())).max().item()


def _close(out, ref, **tol):
    if isinstance(ref, torch.Tensor):
        ref = ref.float().numpy()
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


# ------------------------------------------------------------------- K2

@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("H,Kv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_bf16_rounding_within_tolerance(D, H, Kv, causal):
    rng = np.random.default_rng(20)
    shapes = ((2, 192, H, D), (2, 192, Kv, D), (2, 192, Kv, D))
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    out = attention_tc(tq, tk, tv, causal=causal)
    assert out.dtype == torch.bfloat16
    _close(out, jax_flash(jq, jk, jv, causal=causal, block_q=64,
                          block_k=64), **ATTN_TOL)
    _close(out, attention_ref(tq, tk, tv, causal=causal), **ATTN_TOL)


def test_attention_bf16_rounding_with_softcap():
    rng = np.random.default_rng(21)
    arrays = [rng.standard_normal((1, 200, 2, 64)).astype(np.float32) * 3
              for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in arrays)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    out = attention_tc(tq, tk, tv, causal=True, softcap=20.0)
    _close(out, jax_flash(jq, jk, jv, causal=True, softcap=20.0,
                          block_q=40, block_k=40), **ATTN_TOL)
    _close(out, attention_ref(tq, tk, tv, causal=True, softcap=20.0),
           **ATTN_TOL)


# ------------------------------------------------------------------- K3

def _ssd_inputs(seed, Bt, T, H, P, G, N):
    """The JAX sweep's draws (x, B, C normal in bf16; dt = softplus(normal),
    A = -exp(normal / 2) in f32), as (jax, torch) tuples."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bt, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, T, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    B = rng.standard_normal((Bt, T, G, N)).astype(np.float32)
    C = rng.standard_normal((Bt, T, G, N)).astype(np.float32)
    jax_side = (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dt),
                jnp.asarray(A), jnp.asarray(B).astype(jnp.bfloat16),
                jnp.asarray(C).astype(jnp.bfloat16))
    torch_side = (torch.from_numpy(x).to(torch.bfloat16),
                  torch.from_numpy(dt), torch.from_numpy(A),
                  torch.from_numpy(B).to(torch.bfloat16),
                  torch.from_numpy(C).to(torch.bfloat16))
    return jax_side, torch_side


# the serving widths (P = N = 64, G 1) over two full 256-token chunks, from
# ten seeds, and a short chunk with groups
SERVING = (1, 512, 2, 64, 1, 64, 256)
SEEDS = range(20, 30)
SSD_CASES = [(SERVING, seed) for seed in SEEDS] + \
    [((2, 96, 4, 32, 2, 16, 48), 20)]


@functools.lru_cache(maxsize=None)
def _ssd_case(shape, seed):
    """Inputs (torch) and the Pallas kernel's (y, state) as numpy."""
    Bt, T, H, P, G, N, chunk = shape
    jin, tin = _ssd_inputs(seed, Bt, T, H, P, G, N)
    ref_y, ref_state = jax_ssd(*jin, chunk=chunk)
    return tin, (np.asarray(ref_y, np.float32), np.asarray(ref_state))


@pytest.mark.parametrize("shape,seed", SSD_CASES)
def test_ssd_bf16_rounding_within_tolerance(shape, seed):
    tin, (ref_y, ref_state) = _ssd_case(shape, seed)
    y, state = ssd_tc(*tin, chunk=shape[-1])
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    _close(y, ref_y, **Y_TOL)
    _close(state, ref_state, **STATE_TOL)
    plain_y, plain_state = ssd_chunked(*tin, chunk=shape[-1])
    _close(y, plain_y, **Y_TOL)
    _close(state, plain_state, **STATE_TOL)


@pytest.mark.parametrize("operand,out", [("state", 1), ("w", 0)])
def test_ssd_single_rounding_misses(operand, out):
    """Rounding an operand once to bf16, as a straight port would, puts the
    result outside its bound at the serving widths for some of the seeds
    the pairs pass with (the test above): the state and the scaled B put
    the final state outside 1e-3; W', whose terms reach tens where y may be
    near 0 by cancellation, puts y outside 4e-2."""
    tol = (Y_TOL, STATE_TOL)[out]
    worst = 0.0
    for seed in SEEDS:
        tin, ref = _ssd_case(SERVING, seed)
        got = ssd_tc(*tin, chunk=SERVING[-1], single=(operand,))[out]
        worst = max(worst, _worst(got, ref[out], **tol))
    assert worst > 1.0


# ------------------------------------------------------------------- K4

def _mlstm_inputs(seed, B, T, H, D, gates):
    """q, k, v normal in bf16; the JAX sweep's gates (i 2 normal, f 2
    normal + 3) or, given (log f, log i), constant gates; as (jax, torch)
    tuples."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((B, T, H, D)).astype(np.float32)
           for _ in range(3)]
    if gates is None:
        i_raw = (rng.standard_normal((B, T, H)) * 2).astype(np.float32)
        f_raw = (rng.standard_normal((B, T, H)) * 2 + 3).astype(np.float32)
    else:
        f_raw = np.full((B, T, H), gates[0], np.float32)
        i_raw = np.full((B, T, H), gates[1], np.float32)
    jax_side = tuple(jnp.asarray(a).astype(jnp.bfloat16) for a in qkv) + (
        jnp.asarray(i_raw), jnp.asarray(f_raw))
    torch_side = tuple(torch.from_numpy(a).to(torch.bfloat16)
                       for a in qkv) + (torch.from_numpy(i_raw),
                                        torch.from_numpy(f_raw))
    return jax_side, torch_side


# two 256-token chunks (xlstm-125m's chunk) at head widths 64 and 384 (its
# mLSTM heads), from several seeds of the sweep's gates and at the
# gate-stability property's extremes, |log gate| = 5 in each sign
MLSTM_SEEDS = range(40, 45)
STABILITY = [(f, i) for f in (5.0, -5.0) for i in (5.0, -5.0)]
MLSTM_CASES = [(D, seed, None) for D in (64, 384) for seed in MLSTM_SEEDS] \
    + [(D, 40, gates) for D in (64, 384) for gates in STABILITY]


@functools.lru_cache(maxsize=None)
def _mlstm_case(D, seed, gates):
    """Inputs (torch) and the Pallas kernel's (h, C, n, m) as numpy."""
    jin, tin = _mlstm_inputs(seed, 1, 512, 2, D, gates)
    h, (C, n, m) = jax_mlstm(*jin, chunk=256)
    return tin, tuple(np.asarray(x, np.float32) for x in (h, C, n, m))


@pytest.mark.parametrize("D,seed,gates", MLSTM_CASES)
def test_mlstm_bf16_rounding_within_tolerance(D, seed, gates):
    tin, ref = _mlstm_case(D, seed, gates)
    h, carry = mlstm_tc(*tin, chunk=256)
    assert h.dtype == torch.bfloat16 and torch.isfinite(h).all()
    assert all(c.dtype == torch.float32 for c in carry)
    plain_h, plain_carry = mlstm_chunked(*tin, chunk=256)
    for want_h, want_carry in ((ref[0], ref[1:]), (plain_h, plain_carry)):
        _close(h, want_h, **H_TOL)
        for got, want, tol in zip(carry, want_carry,
                                  (STATE_TOL, STATE_TOL, M_TOL)):
            _close(got, want, **tol)


@pytest.mark.parametrize("operand,out", [("state", 0), ("p", 0),
                                         ("keys", 1)])
def test_mlstm_single_rounding_misses(operand, out):
    """Rounding an operand once to bf16 puts an output outside its bound
    at xlstm-125m's head width for some of the cases the pairs pass with
    (the test above): the state C in q·C and the weighted scores P in P·V
    put h outside 2e-2; the scaled keys put the final C outside 1e-3."""
    tol = (H_TOL, STATE_TOL)[out]
    worst = 0.0
    for D, seed, gates in MLSTM_CASES:
        if D != 384:
            continue
        tin, ref = _mlstm_case(D, seed, gates)
        h, (C, _, _) = mlstm_tc(*tin, chunk=256, single=(operand,))
        worst = max(worst, _worst((h, C)[out], ref[out], **tol))
    assert worst > 1.0
