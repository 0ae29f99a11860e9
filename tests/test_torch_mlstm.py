"""The port's mLSTM cell against the JAX package's, on inputs drawn from a
numpy seed: the plain ``mlstm_chunked`` against JAX's ``mlstm_chunked``
and against the Pallas kernel (``repro.kernels.mlstm``, interpret mode, as
tests/test_kernels.py runs it), the decode step, the token-by-token
oracle, the gate-stability property; and the CUDA kernel (K4) against the
plain version on the card.

Tolerances are tests/test_kernels.py::test_mlstm_kernel_sweep's: h 5e-3,
C 1e-3 (n at C's bound), m 1e-4; bf16 h at that file's bf16 bound, 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels.mlstm.ops import mlstm as jax_mlstm
from repro.models import xlstm as JX
from repro_torch.kernels.mlstm.ops import MLSTM, mlstm
from repro_torch.kernels.mlstm.ref import (mlstm_chunked,
                                           mlstm_sequential_ref, mlstm_step)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
STATE_TOL = dict(rtol=1e-3, atol=1e-3)        # C and n
M_TOL = dict(rtol=1e-4, atol=1e-4)

# tests/test_kernels.py::test_mlstm_kernel_sweep's (T, H, D, chunk)
SWEEP = [(128, 2, 32, 32), (64, 4, 16, 16), (96, 2, 64, 32)]


def _h_tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=5e-3, atol=5e-3)


def _inputs(seed, B, T, H, D, dtype, gates=None):
    """q, k, v in ``dtype`` (normal); i_raw = 2 normal, f_raw = 2 normal + 3
    in f32, as the JAX sweep draws them, or given ``gates`` = (log f,
    log i) constant gates; each as a (jax, torch) pair."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    qkv = [rng.standard_normal((B, T, H, D)).astype(np.float32)
           for _ in range(3)]
    i_raw = (rng.standard_normal((B, T, H)) * 2).astype(np.float32)
    f_raw = (rng.standard_normal((B, T, H)) * 2 + 3).astype(np.float32)
    if gates is not None:
        f_raw = np.full((B, T, H), gates[0], np.float32)
        i_raw = np.full((B, T, H), gates[1], np.float32)
    jax_side = tuple(jnp.asarray(a).astype(jdt) for a in qkv) + (
        jnp.asarray(i_raw), jnp.asarray(f_raw))
    torch_side = tuple(torch.from_numpy(a).to(tdt) for a in qkv) + (
        torch.from_numpy(i_raw), torch.from_numpy(f_raw))
    return jax_side, torch_side


def _carry(seed, B, H, D):
    """A nonzero carry: C, n normal, m normal (all f32), as numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, D, D)).astype(np.float32),
            rng.standard_normal((B, H, D)).astype(np.float32),
            rng.standard_normal((B, H)).astype(np.float32))


def _close(out, ref, **tol):
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **tol)


def _close_all(h, carry, ref_h, ref_carry, dtype):
    _close(h, ref_h, **_h_tol(dtype))
    (C, n, m), (Cr, nr, mr) = carry, ref_carry
    _close(C, Cr, **STATE_TOL)
    _close(n, nr, **STATE_TOL)
    _close(m, mr, **M_TOL)


@pytest.mark.parametrize("T,H,D,chunk", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_chunked_matches_jax_and_pallas(T, H, D, chunk, dtype):
    jin, tin = _inputs(3, 2, T, H, D, dtype)
    h, carry = mlstm_chunked(*tin, chunk=chunk)
    assert h.dtype == tin[0].dtype and h.shape == tin[0].shape
    assert all(c.dtype == torch.float32 for c in carry)
    assert tuple(carry[0].shape) == (2, H, D, D)
    for ref_h, ref_carry in (JX.mlstm_chunked(*jin, chunk=chunk),
                             jax_mlstm(*jin, chunk=chunk)):
        _close_all(h, carry, ref_h, ref_carry, dtype)


@pytest.mark.parametrize("T,H,D,chunk", SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_chunked_with_carry_matches_jax(T, H, D, chunk, dtype):
    """From a nonzero carry, against JAX's chunked function and its
    token-by-token oracle."""
    jin, tin = _inputs(4, 2, T, H, D, dtype)
    init = _carry(5, 2, H, D)
    h, carry = mlstm_chunked(*tin, chunk=chunk,
                             carry=tuple(map(torch.from_numpy, init)))
    jinit = tuple(map(jnp.asarray, init))
    for ref_h, ref_carry in (JX.mlstm_chunked(*jin, chunk=chunk,
                                              carry=jinit),
                             JX.mlstm_sequential_ref(*jin, carry=jinit)):
        _close_all(h, carry, ref_h, ref_carry, dtype)


def test_mlstm_sequential_ref_matches_jax():
    jin, tin = _inputs(6, 2, 48, 2, 16, "float32")
    init = _carry(7, 2, 2, 16)
    ref_h, ref_carry = JX.mlstm_sequential_ref(
        *jin, carry=tuple(map(jnp.asarray, init)))
    h, carry = mlstm_sequential_ref(*tin,
                                    carry=tuple(map(torch.from_numpy, init)))
    _close_all(h, carry, ref_h, ref_carry, "float32")
    # and from the zero carry, where m starts at -1e30
    ref_h, ref_carry = JX.mlstm_sequential_ref(*jin)
    h, carry = mlstm_sequential_ref(*tin)
    _close_all(h, carry, ref_h, ref_carry, "float32")


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mlstm_step_matches_jax(dtype):
    jin, tin = _inputs(8, 3, 1, 4, 32, dtype)
    init = _carry(9, 3, 4, 32)
    ref_h, ref_carry = JX.mlstm_step(*(a[:, 0] for a in jin),
                                     tuple(map(jnp.asarray, init)))
    h, carry = mlstm_step(*(t[:, 0] for t in tin),
                          tuple(map(torch.from_numpy, init)))
    assert h.dtype == tin[0].dtype
    _close(h, ref_h, **_h_tol(dtype))
    for ours, theirs in zip(carry, ref_carry):
        _close(ours, theirs, rtol=1e-5, atol=1e-5)


@settings(max_examples=10, deadline=None)
@given(logf=st.floats(-5.0, 5.0), logi=st.floats(-5.0, 5.0))
def test_mlstm_gate_stability_property(logf, logi):
    """Property: extreme gate magnitudes never produce NaN/Inf (the
    max-stabilizer contract), on the plain path and through the op."""
    B, T, H, D = 1, 32, 1, 8
    rng = np.random.default_rng(10)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, T, H, D))
                                .astype(np.float32)) for _ in range(3))
    i_raw = torch.full((B, T, H), logi)
    f_raw = torch.full((B, T, H), logf)
    for fn in (mlstm_chunked, mlstm):
        h, (C, n, m) = fn(q, k, v, i_raw, f_raw, chunk=16)
        for t in (h, C, n, m):
            assert torch.isfinite(t).all()


def test_mlstm_rejects_ragged_chunks():
    """S % chunk != 0 raises, on the op and the plain path alike, as the
    reference asserts."""
    _, tin = _inputs(11, 1, 40, 2, 16, "float32")
    for fn in (mlstm, mlstm_chunked):
        with pytest.raises(ValueError, match="not a multiple of the chunk"):
            fn(*tin, chunk=32)


def test_cpu_tensors_take_the_plain_mlstm():
    _, tin = _inputs(12, 2, 64, 4, 16, "bfloat16")
    before = MLSTM.launches
    h, carry = mlstm(*tin, chunk=32)
    ref_h, ref_carry = mlstm_chunked(*tin, chunk=32)
    assert torch.equal(h, ref_h)
    assert all(torch.equal(a, b) for a, b in zip(carry, ref_carry))
    assert MLSTM.launches == before


def test_mlstm_refuses_other_devices():
    """Neither CPU nor CUDA: the op raises rather than pick a path."""
    q = torch.empty(1, 16, 1, 16, device="meta")
    g = torch.empty(1, 16, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mlstm(q, q, q, g, g, chunk=16)


# --------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


# the sweep and xlstm-125m's prefill (per sequence) in both dtypes, and
# the tensor-core kernels at the serving width under constant gates at
# |log gate| = 5 (the gate-stability property's extreme)
KERNEL_CASES = [(T, H, D, chunk, None, dtype)
                for T, H, D, chunk in SWEEP + [(1024, 4, 384, 256)]
                for dtype in DTYPES] + [(512, 4, 384, 256, (5.0, 5.0),
                                         "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("T,H,D,chunk,gates,dtype", KERNEL_CASES)
def test_mlstm_kernel_matches_plain(cuda, T, H, D, chunk, gates, dtype):
    _, tin = _inputs(13, 2, T, H, D, dtype, gates)
    tin = tuple(t.to(cuda) for t in tin)
    before = MLSTM.launches
    h, carry = mlstm(*tin, chunk=chunk)
    torch.cuda.synchronize()
    assert MLSTM.launches == before + 1
    ref_h, ref_carry = mlstm_chunked(*tin, chunk=chunk)
    assert torch.isfinite(h).all()
    torch.testing.assert_close(h.float(), ref_h.float(), **_h_tol(dtype))
    for ours, theirs, tol in zip(carry, ref_carry,
                                 (STATE_TOL, STATE_TOL, M_TOL)):
        torch.testing.assert_close(ours, theirs, **tol)


@pytest.mark.cuda
def test_mlstm_kernel_refuses_unsupported_input(cuda):
    """On a CUDA tensor the op launches the kernel or raises; it never
    takes the plain path."""
    _, tin = _inputs(14, 1, 32, 2, 48, "float32")
    q, k, v, i_raw, f_raw = (t.to(cuda) for t in tin)
    with pytest.raises(ValueError, match="D in"):
        mlstm(q, k, v, i_raw, f_raw, chunk=32)
    q16 = q[..., :16]
    with pytest.raises(ValueError, match="contiguous"):
        mlstm(q16, q16, q16, i_raw, f_raw, chunk=32)
    with pytest.raises(TypeError, match="f32 gates"):
        mlstm(q16.contiguous(), q16.contiguous(), q16.contiguous(),
              i_raw.half(), f_raw, chunk=32)
