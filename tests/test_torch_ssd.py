"""The port's SSD scan (Mamba2) and causal conv against the JAX package's, on
inputs drawn from a numpy seed: the plain ``ssd_chunked`` against JAX's
``ssd_chunked`` and against the Pallas kernel (``repro.kernels.mamba_scan``,
interpret mode, as tests/test_kernels.py runs it), the decode step, the
token-by-token oracle; and the CUDA kernel against the plain version on the
card.

Tolerances are tests/test_kernels.py::test_ssd_kernel_sweep's: y f32 2e-4,
bf16 4e-2; the final state 1e-3.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.kernels.mamba_scan.ops import ssd as jax_ssd
from repro.models import layers as JL
from repro.models import ssm as JS
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.mamba_scan.ops import SSD, ssd
from repro_torch.kernels.mamba_scan.ref import (ssd_chunked,
                                                ssd_sequential_ref, ssd_step)
from repro_torch.models import layers as L

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)


def _y_tol(dtype):
    return dict(rtol=4e-2, atol=4e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, Bt, T, H, P, G, N, dtype):
    """x, B, C in ``dtype``; dt = softplus(normal) and A = -exp(normal / 2)
    in f32, as the JAX sweep draws them; each as a (jax, torch) pair."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((Bt, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, T, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H) * 0.5).astype(np.float32)
    B = rng.standard_normal((Bt, T, G, N)).astype(np.float32)
    C = rng.standard_normal((Bt, T, G, N)).astype(np.float32)
    jax_side = (jnp.asarray(x).astype(jdt), jnp.asarray(dt), jnp.asarray(A),
                jnp.asarray(B).astype(jdt), jnp.asarray(C).astype(jdt))
    torch_side = (torch.from_numpy(x).to(tdt), torch.from_numpy(dt),
                  torch.from_numpy(A), torch.from_numpy(B).to(tdt),
                  torch.from_numpy(C).to(tdt))
    return jax_side, torch_side


def _close(out, ref, **tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


# the JAX sweep's shapes, and one sequence shorter than the model's chunk
# (the model scans it as one chunk of S tokens: not a power of two)
SWEEP = [
    (128, 4, 32, 1, 16, 32),
    (128, 4, 32, 2, 16, 64),
    (64, 2, 64, 2, 32, 16),
    (24, 4, 32, 1, 16, 24),
]


@pytest.mark.parametrize("T,H,P,G,N,chunk", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_chunked_matches_jax_and_pallas(T, H, P, G, N, chunk, dtype):
    jin, tin = _inputs(3, 2, T, H, P, G, N, dtype)
    y, state = ssd_chunked(*tin, chunk=chunk)
    assert y.dtype == tin[0].dtype and state.dtype == torch.float32
    assert tuple(state.shape) == (2, H, P, N)
    for ref_y, ref_state in (JS.ssd_chunked(*jin, chunk=chunk),
                             jax_ssd(*jin, chunk=chunk)):
        _close(y, ref_y, **_y_tol(dtype))
        _close(state, ref_state, **STATE_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_chunked_matches_sequential_oracle(G):
    """Chunked and token-by-token, from a nonzero initial state, against
    the JAX oracle; f32."""
    jin, tin = _inputs(4, 2, 64, 4, 32, G, 16, "float32")
    init = np.random.default_rng(5).standard_normal((2, 4, 32, 16)).astype(
        np.float32)
    ref_y, ref_state = JS.ssd_sequential_ref(*jin,
                                             init_state=jnp.asarray(init))
    for y, state in (
            ssd_chunked(*tin, chunk=16, init_state=torch.from_numpy(init)),
            ssd_sequential_ref(*tin, init_state=torch.from_numpy(init))):
        _close(y, ref_y, **_y_tol("float32"))
        _close(state, ref_state, **STATE_TOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_step_matches_jax(dtype):
    jin, tin = _inputs(6, 3, 1, 4, 32, 2, 16, dtype)
    st = np.random.default_rng(7).standard_normal((3, 4, 32, 16)).astype(
        np.float32)
    jx, jdt, jA, jB, jC = jin
    tx, tdt, tA, tB, tC = tin
    ref_y, ref_state = JS.ssd_step(jnp.asarray(st), jx[:, 0], jdt[:, 0], jA,
                                   jB[:, 0], jC[:, 0])
    y, state = ssd_step(torch.from_numpy(st), tx[:, 0], tdt[:, 0], tA,
                        tB[:, 0], tC[:, 0])
    assert y.dtype == tx.dtype
    _close(y, ref_y, **_y_tol(dtype))
    _close(state, ref_state, rtol=1e-5, atol=1e-5)


def test_ssd_rejects_ragged_chunks():
    """S > chunk with S % chunk != 0 raises, on the op and the plain path
    alike, as the reference's ssd_chunked does."""
    _, tin = _inputs(8, 1, 40, 2, 32, 1, 16, "float32")
    for fn in (ssd, ssd_chunked):
        with pytest.raises(ValueError, match="not a multiple of the chunk"):
            fn(*tin, chunk=32)


def test_cpu_tensors_take_the_plain_ssd():
    _, tin = _inputs(9, 2, 64, 4, 32, 1, 16, "bfloat16")
    before = SSD.launches
    y, state = ssd(*tin, chunk=32)
    ref_y, ref_state = ssd_chunked(*tin, chunk=32)
    assert torch.equal(y, ref_y) and torch.equal(state, ref_state)
    assert SSD.launches == before


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_causal_conv1d(with_state, dtype):
    rng = np.random.default_rng(10)
    jdt, tdt = DTYPES[dtype]
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = (rng.standard_normal((24, 4)) / 2).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jst = jnp.asarray(st).astype(jdt) if with_state else None
    tst = torch.from_numpy(st).to(tdt) if with_state else None
    ref = JL.causal_conv1d(jnp.asarray(x).astype(jdt),
                           jnp.asarray(w).astype(jdt), jst)
    out = L.causal_conv1d(torch.from_numpy(x).to(tdt),
                          torch.from_numpy(w).to(tdt), tst)
    # contiguous, as the SSD kernel reads (B, L, C) rows
    assert out.dtype == tdt and out.is_contiguous()
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" \
        else dict(rtol=1e-5, atol=1e-5)
    _close(out, ref, **tol)


def test_ssm_config_matches_jax():
    for d_model in (128, 2048):
        ours, ref = SSMConfig(), JaxSSMConfig()
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.d_inner(d_model) == ref.d_inner(d_model)
        assert ours.n_heads(d_model) == ref.n_heads(d_model)


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,P,G,N,chunk", SWEEP + [
    (1024, 64, 64, 1, 64, 256),     # zamba2-1.2b's prefill, per sequence
    (100, 8, 64, 1, 64, 100),       # S < chunk: one chunk of 100 tokens
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ssd_kernel_matches_plain(cuda, T, H, P, G, N, chunk, dtype):
    _, tin = _inputs(11, 2, T, H, P, G, N, dtype)
    tin = tuple(t.to(cuda) for t in tin)
    before = SSD.launches
    y, state = ssd(*tin, chunk=chunk)
    torch.cuda.synchronize()
    assert SSD.launches == before + 1
    ref_y, ref_state = ssd_chunked(*tin, chunk=chunk)
    torch.testing.assert_close(y.float(), ref_y.float(), **_y_tol(dtype))
    torch.testing.assert_close(state, ref_state, **STATE_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,P,G,N,chunk", [
    (512, 2, 64, 1, 64, 256),       # two full chunks at the serving widths
    (384, 4, 64, 2, 32, 192),       # three t tiles to a chunk, groups
    (96, 4, 32, 2, 16, 48),         # a chunk shorter than a tile
])
def test_ssd_tensor_core_kernel_matches_plain(cuda, T, H, P, G, N, chunk):
    """bf16 runs the tensor-core kernel, whose f32 operands go in as bf16
    pairs (tests/test_torch_tc_numerics.py emulates it)."""
    _, tin = _inputs(12, 2, T, H, P, G, N, "bfloat16")
    tin = tuple(t.to(cuda) for t in tin)
    y, state = ssd(*tin, chunk=chunk)
    ref_y, ref_state = ssd_chunked(*tin, chunk=chunk)
    torch.testing.assert_close(y.float(), ref_y.float(),
                               **_y_tol("bfloat16"))
    torch.testing.assert_close(state, ref_state, **STATE_TOL)
