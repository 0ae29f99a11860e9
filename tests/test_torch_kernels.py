"""The port's kernels: their plain versions against the JAX package's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) on the same
numpy inputs, and the CUDA kernels against their plain versions on the
card.

Tolerances follow tests/test_kernels.py::_tol: f32 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro_torch.kernels.flash_attention.ops import FLASH_ATTENTION, \
    flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm.ops import RMSNORM, rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(a, name):
    """One numpy f32 array as a JAX and a torch array of dtype ``name``;
    both round f32 -> bf16 to nearest even, so they hold equal values."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


RMS_SHAPES = [(64, 128), (256, 512), (100, 96)]
# the serving paths' widths (xlstm-125m 768 and 1536, llama 2048, zamba2's
# gated norm 4096) at small row counts: the widths the CUDA kernel's vector
# route specialises
RMS_SERVING_SHAPES = [(8, 768), (64, 1536), (32, 2048), (16, 4096)]


@pytest.mark.parametrize("R,D", RMS_SHAPES + RMS_SERVING_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_plain_matches_pallas(R, D, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((R, D)).astype(np.float32)
    w = rng.standard_normal(D).astype(np.float32)
    jx, tx = _pair(x, dtype)
    ref = jax_rmsnorm(jx, jnp.asarray(w))
    out = rmsnorm_ref(tx, torch.from_numpy(w))
    assert out.dtype == tx.dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **_tol(dtype))


FLASH_GRID = [
    (128, 4, 4, 64),      # MHA
    (256, 4, 2, 64),      # GQA 2:1
    (128, 8, 2, 128),     # GQA 4:1
    (192, 2, 1, 32),      # non-pow2 seq, MQA
]


@pytest.mark.parametrize("S,H,Kv,D", FLASH_GRID)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_plain_matches_pallas(S, H, Kv, D, causal, dtype):
    rng = np.random.default_rng(1)
    B = 2
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, S, H, D), (B, S, Kv, D), (B, S, Kv, D)))
    ref = jax_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    out = attention_ref(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), **_tol(dtype))


def test_flash_attention_plain_softcap_matches_pallas():
    rng = np.random.default_rng(2)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(rng.standard_normal((1, 128, 2, 32)).astype(np.float32),
              "float32") for _ in range(3))
    ref = jax_flash(jq, jk, jv, causal=True, softcap=20.0, block_q=64,
                    block_k=64)
    out = attention_ref(tq, tk, tv, causal=True, softcap=20.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol("f32"))


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the ops are their plain versions and launch
    nothing."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 96)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(96).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((1, 40, 4, 32))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 40, 2, 32))
                         .astype(np.float32))
    before = (RMSNORM.launches, FLASH_ATTENTION.launches)
    assert torch.equal(rmsnorm(x, w), rmsnorm_ref(x, w))
    assert torch.equal(flash_attention(q, k, k, causal=True),
                       attention_ref(q, k, k, causal=True))
    assert (RMSNORM.launches, FLASH_ATTENTION.launches) == before


# --------------------------------------------------------------- on the card

@pytest.mark.cuda
@pytest.mark.parametrize(
    "R,D", RMS_SHAPES + [(4096, 2048)]
    # prefill (B*S rows) and decode (max_batch rows) at the serving widths;
    # 4097 rows leave the last CTA of the vector route (2 warps a row at
    # 768) part empty; D 100 (not a multiple of 8 values) and D 8192 (wider
    # than the vector route's 4096) take the scalar route
    + [(R, D) for D in (768, 1536, 4096) for R in (4096, 8)]
    + [(4097, 768), (64, 100), (8, 8192)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_kernel_matches_plain(cuda, R, D, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(R, D, generator=g, device=cuda).to(DTYPES[dtype][1])
    w = torch.randn(D, generator=g, device=cuda)
    before = RMSNORM.launches
    out = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert RMSNORM.launches == before + 1
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, w).float(),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_kernel_misaligned_view(cuda, dtype):
    """Contiguous views one element into their buffers (x and w off 16-byte
    alignment) take the scalar route and give the plain version's answer."""
    g = torch.Generator(device=cuda).manual_seed(0)
    R, D = 64, 2048
    buf = torch.randn(R * D + 1, generator=g, device=cuda)
    x = buf.to(DTYPES[dtype][1])[1:].view(R, D)
    w = torch.randn(D + 1, generator=g, device=cuda)[1:]
    assert x.is_contiguous() and x.data_ptr() % 16 and w.data_ptr() % 16
    out = rmsnorm(x, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, w).float(),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,Kv,D", FLASH_GRID + [(1024, 32, 8, 64),
                                                   (200, 8, 2, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_attention_kernel_matches_plain(cuda, S, H, Kv, D, causal,
                                              dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    tdt = DTYPES[dtype][1]
    q = torch.randn(2, S, H, D, generator=g, device=cuda).to(tdt)
    k = torch.randn(2, S, Kv, D, generator=g, device=cuda).to(tdt)
    v = torch.randn(2, S, Kv, D, generator=g, device=cuda).to(tdt)
    before = FLASH_ATTENTION.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == before + 1
    torch.testing.assert_close(out.float(),
                               attention_ref(q, k, v, causal=causal).float(),
                               **_tol(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("S", [192, 333])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("H,Kv", [(8, 2), (4, 4)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_flash_attention_tensor_core_kernel_matches_plain(cuda, S, D, H, Kv,
                                                          causal, softcap):
    """bf16 runs the tensor-core kernel: its rounding of P to bf16 stays
    inside bf16's 2e-2 (tests/test_torch_tc_numerics.py emulates it), on
    ragged tails, GQA and MHA, with and without a softcap."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(2, S, H, D, generator=g, device=cuda).bfloat16()
    k = torch.randn(2, S, Kv, D, generator=g, device=cuda).bfloat16()
    v = torch.randn(2, S, Kv, D, generator=g, device=cuda).bfloat16()
    before = FLASH_ATTENTION.launches
    out = flash_attention(q, k, v, causal=causal, softcap=softcap)
    torch.cuda.synchronize()
    assert FLASH_ATTENTION.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, softcap=softcap)
    torch.testing.assert_close(out.float(), ref.float(), **_tol("bfloat16"))
