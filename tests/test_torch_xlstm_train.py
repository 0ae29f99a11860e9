"""The port's training path of the xLSTM against the JAX package on the CPU,
at ``reduced_config``: 8 layers at ``slstm_every`` 4 (2 super-blocks of 3
mLSTM blocks and an sLSTM block, no tail), d_model 128, 4 heads (mLSTM
heads of 64, sLSTM heads of 32).

``XLSTMLM.loss``, every leaf of ``make_loss_and_grad`` at accum 1 and 2
against ``jax.grad`` of the reference's loss (as the reference's
``make_loss_and_grad`` differentiates it), a two-chunk case, the mLSTM
cell's gradient and ``MLSTMFn``, remat at the reference's granularity (a
tail at a depth of 6 too), the train step's curve, the bucket layout,
zero1 against hier_bucketed on 4 gloo ranks, the Trainer's checkpoint
bytes and each package's Trainer resuming the other's, and the launcher.

Weights come from the reference's init (key 3) through ``params_from_jax``,
batches from the reference's ``SyntheticCorpus``.  At 64 tokens the mLSTM
cell takes one chunk of 64; the two-chunk case runs 512 tokens, two chunks
of 256, so the cross-chunk carry runs under the gradient.  Bounds: f32
1e-4 of each leaf's largest value (plus 1e-4 relative), see
``test_loss_and_grad_matches_reference``; bf16 the hybrid file's two rules.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jlegacy
from repro import ckpt as jckpt
from repro import data as jdata
from repro import optim as joptim
from repro import train as jtrain
from repro.collectives import bucketing as JBK
from repro.models import xlstm as JX
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch import ckpt, data, optim, train
from repro_torch.collectives import bucketing as BK
from repro_torch.convert import params_from_jax
from repro_torch.kernels.mlstm import ops as mlstm_ops
from repro_torch.kernels.mlstm.ref import mlstm_backward_ref, mlstm_chunked
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import xlstm as X
from repro_torch.models.registry import build_model, get_config, \
    reduced_config
from repro_torch.parallel.launch import run_ranks
from tests import _torch_ranks as R
from tests._torch_threads import one_torch_thread  # noqa: F401

ARCH = "xlstm-125m"
FAMILY = "ssm"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_LEAF = 1e-4           # of each leaf's largest value, plus 1e-4 relative
BF16_MODEL = dict(rtol=2e-2, atol=1e-3)
SEQ, BATCH = 64, 4
LONG_SEQ = 512            # two chunks of 256
TWO_CHUNK_NORM = 5e-3
OCFG = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
SMALL = 64 << 10          # bucket bytes of a multi-bucket layout
TAIL_LAYERS = 6           # one super-block and a 2-block tail


# The reference's programs are compiled with LLVM's optimizations off: at
# reduced width their compile, not their run, takes the time (the hybrid
# file measured it; here a loss-and-grad compiles in about 8 s on one core
# with them off, 20 s on).
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


class _Reference:
    """The reference's model, its init compiled (for the reference's
    Trainer, which calls ``model.init``); ``loss`` is the model's own."""

    def __init__(self, model):
        self.model = model
        self.init = _compile(model.init, jax.random.key(0))

    def loss(self, params, batch):
        return self.model.loss(params, batch)


def _jax_cfg(n_layers=None):
    cfg = jax_reduced_config(jax_get_config(ARCH))
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def _torch_cfg(n_layers=None):
    cfg = reduced_config(get_config(ARCH))
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


@pytest.fixture(scope="module")
def jax_side():
    cfg = _jax_cfg()
    ref = _Reference(jax_build_model(cfg, remat=False))
    return cfg, ref, ref.init(jax.random.key(3))


def _cast(params, dtype):
    """Matmul and conv weights to ``dtype``; the f32 leaves stay f32."""
    return jax.tree.map(
        lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16 else a, params)


def _port(params, dtype, *, remat=True, n_layers=None):
    model = build_model(_torch_cfg(n_layers), device="cpu", dtype=dtype,
                        seed=None, remat=remat)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          FAMILY))
    return model


def _state(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def _by_name(tree):
    """A reference tree (params or gradients) as the port's names ->
    numpy f32."""
    return {n: t.float().numpy() for n, t in params_from_jax(
        jax.tree.map(np.asarray, tree), FAMILY).items()}


def _batches(n, *, seq=SEQ, batch=BATCH):
    corpus = jdata.SyntheticCorpus(jdata.DataConfig(
        vocab_size=512, seq_len=seq, global_batch=batch))
    return [corpus.batch(i) for i in range(n)]


def _halves(batch):
    """The two microbatches of accum 2: rows [0, B/2) and [B/2, B)."""
    n = len(batch["tokens"]) // 2
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(2)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _value_and_grad(ref, dtypes):
    """(loss, metrics), gradients of the reference's loss with respect to
    an f32 view of the params, each leaf cast back to its storage dtype
    inside the loss: the differentiation of the reference's
    ``make_loss_and_grad`` (``repro/train.py:104-117``), its metrics
    kept."""
    def fn(p32, mb):
        def cast_loss(q, mb):
            return ref.loss(jax.tree.map(lambda a, d: a.astype(d), q,
                                         dtypes), mb)
        return jax.value_and_grad(cast_loss, has_aux=True)(p32, mb)
    return fn


def _f32_program(ref, params, mb):
    q = _cast(params, jnp.float32)
    return _compile(_value_and_grad(ref, jax.tree.map(lambda a: a.dtype, q)),
                    q, mb)


@pytest.fixture(scope="module")
def programs(jax_side):
    """Per dtype, the reference's loss with its metrics and gradients at
    a microbatch's shape (2 x 64 tokens); its AdamW ``apply`` on f32
    params; compiled."""
    _, ref, params = jax_side
    mb = _jax_batch(_halves(_batches(1)[0])[0])
    ocfg = joptim.AdamWConfig(**OCFG)
    out = {}
    for name, (jdt, _) in DTYPES.items():
        q = _cast(params, jdt)
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32), q)
        dtypes = jax.tree.map(lambda a: a.dtype, q)
        out[name] = _compile(_value_and_grad(ref, dtypes), p32, mb)
    q = _cast(params, jnp.float32)
    out["apply"] = _compile(lambda p, gr, st: joptim.apply(ocfg, p, gr, st),
                            q, q, joptim.init(ocfg, q))
    return out


def _ref_loss_and_grad(programs, dtype, params, batch, accum):
    """The reference's (loss, metrics, gradient tree) at accum 1 (on
    ``batch``'s first microbatch) or accum 2: the mean of the two
    microbatches', bit for bit its ``make_loss_and_grad``'s (its scan adds
    each microbatch's to zeros, then scales the sums by 1/2)."""
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    halves = [_jax_batch(h) for h in _halves(batch)]
    (l0, m0), g0 = programs[dtype](p32, halves[0])
    if accum == 1:
        return l0, m0, g0
    (l1, _), g1 = programs[dtype](p32, halves[1])
    return ((l0 + l1) * 0.5, None,
            jax.tree.map(lambda a, b: (a + b) * 0.5, g0, g1))


def _hold_f32(ours, ref, bound=F32_LEAF):
    """Every element within ``bound`` of its leaf's largest value, plus
    ``bound`` relative."""
    for n, r in ref.items():
        np.testing.assert_allclose(ours[n], r, rtol=bound,
                                   atol=bound * np.abs(r).max(), err_msg=n)


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_xlstm_loss_matches_reference(jax_side, programs, dtype):
    """loss, nll, z_loss and aux; the logits stay in the model's dtype, as
    the reference's einsum (no f32 accumulation type) gives them."""
    jdt, tdt = DTYPES[dtype]
    _, _, params = jax_side
    params = _cast(params, jdt)
    jl, jm, _ = _ref_loss_and_grad(programs, dtype, params, _batches(1)[0],
                                   1)
    batch = _halves(_batches(1)[0])[0]
    model = _port(params, tdt)
    with torch.no_grad():
        tl, tm = model.loss(_torch_batch(batch))
        logits = model.forward_logits(_torch_batch(batch)["tokens"])
    assert logits.dtype == tdt and tl.dtype == torch.float32
    tol = dict(rtol=1e-5) if dtype == "f32" else dict(rtol=2e-3)
    np.testing.assert_allclose(tl.item(), float(jl), **tol)
    for key in ("nll", "z_loss", "aux"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), **tol,
                                   atol=1e-9)
    assert tm["aux"].item() == 0.0


# --------------------------------------------------------- loss-and-grad

@pytest.fixture(scope="module")
def ref_grads(jax_side, programs):
    """The reference's loss and gradients by dtype and accum, by name."""
    _, _, params = jax_side
    batch = _batches(1)[0]
    out = {}
    for name, (jdt, _) in DTYPES.items():
        p32 = jax.tree.map(lambda a: a.astype(jnp.float32),
                           _cast(params, jdt))
        (l0, _), g0 = programs[name](p32, _jax_batch(_halves(batch)[0]))
        (l1, _), g1 = programs[name](p32, _jax_batch(_halves(batch)[1]))
        out[(name, 1)] = (float(l0), _by_name(g0))
        # the reference's accum 2: the sums over microbatches, halved
        out[(name, 2)] = (float((l0 + l1) * 0.5), _by_name(
            jax.tree.map(lambda a, b: (a + b) * 0.5, g0, g1)))
    return batch, out


@pytest.mark.parametrize("dtype,accum", [("f32", 1), ("f32", 2),
                                         ("bf16", 1), ("bf16", 2)])
def test_loss_and_grad_matches_reference(jax_side, ref_grads, dtype,
                                         accum):
    """Every leaf: the mLSTM blocks' projections, conv, gates (w_if,
    if_bias, f32) and output norm; the sLSTM blocks' w_in, gate_bias and
    recurrent r_w (f32), output norm and w_out; the LayerNorms' weights
    and biases; the tied embedding.

    f32, at accum 1 and 2: every element within 1e-4 of its leaf's largest
    value, plus 1e-4 relative (measured at most 0.23 of that bound).  An
    element-wise 1e-6 floor, as the dense and hybrid files hold, is below
    what two f32 evaluations of this model share: the reference's own two
    compiles (its default and ``FAST_COMPILE``) differ by 2.2e-5 of a
    leaf's norm here, and the port's embedding gradient, which sums the
    logits' and the lookup's, lies 1.9e-5 from the reference's on values
    up to 2.0 (1e-5 of the leaf's largest).

    bf16, at accum 1 and 2: the two sides' bf16 gradients each lie within
    their bf16 rounding noise of the (common) f32 gradient.  (a) On every
    leaf of the reference's (stacked over super-blocks and blocks) the
    port's lies no further from the f32 gradient, by norm, than 1.5x the
    reference's does: a gradient accumulated in bf16 would not.  (b) Every
    leaf lies within the reference's bf16 bound (rtol 2e-2, atol 1e-3) of
    the reference's bf16 gradient, the atol raised, where the reference's
    own bf16 noise (its largest deviation from its f32 gradient on the
    leaf) is larger, to 2.5x that noise: the sum of the two sides' noises
    when the port's is at most 1.5x the reference's.  Measured: (a) at
    most 1.04x at accum 1 and 1.21x at accum 2, (b) at most 0.59 and 0.83
    of the bound.
    """
    jdt, tdt = DTYPES[dtype]
    _, _, params = jax_side
    batch, out = ref_grads
    jl, jg = out[(dtype, accum)]
    model = _port(_cast(params, jdt), tdt)
    tb = _torch_batch(batch if accum == 2 else _halves(batch)[0])
    tl, tg = train.make_loss_and_grad(model, accum=accum)(_state(model), tb)
    assert set(tg) == set(jg) == set(_state(model))
    assert all(g.dtype == torch.float32 for g in tg.values())
    ours = {n: g.numpy() for n, g in tg.items()}
    if dtype == "f32":
        np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
        _hold_f32(ours, jg)
        return
    np.testing.assert_allclose(tl.item(), jl, rtol=2e-3)
    _, g32 = out[("f32", accum)]
    for path, leaf in BK.leaf_tree(tg, FAMILY).items():
        o, r, f = (np.concatenate([t[p].reshape(-1) for p in leaf.parts])
                   for t in (ours, jg, g32))
        assert np.linalg.norm(o - f) <= 1.5 * np.linalg.norm(r - f), path
    for n, ref in jg.items():
        noise = np.abs(ref - g32[n]).max()
        np.testing.assert_allclose(
            ours[n], ref, rtol=BF16_MODEL["rtol"],
            atol=max(BF16_MODEL["atol"], 2.5 * noise), err_msg=n)


def test_two_chunk_loss_and_grad_matches_reference(jax_side):
    """512 tokens, two chunks of 256 in every mLSTM block, f32, accum 1
    (one sequence): the loss within 1e-5, every leaf's gradient within
    TWO_CHUNK_NORM (5e-3) of the reference's by norm (measured: 9.1e-5 at
    most).

    Why not 1e-4 here: the mLSTM's normaliser max(|den|, exp(-m_t)) has a
    kink, and at 512 tokens some position lies near it, where two f32
    evaluations of the same function may take different sides.  Measured
    on the corpus' first batches of 512 tokens: of two sequences (batch
    0), one position (block 1.1, sequence 1, head 1, token 424) lies 4e-6
    from it; the reference's own two compiles (its default and
    ``FAST_COMPILE``) differ by 2.9e-3 by norm there, and a 1e-7 relative
    change of the first block's output moves the port's gradient by
    3.0e-3; of one sequence, batch 4 puts the port 5.2e-2 from the
    reference.  Away from such a kink the f32 gradient still carries
    1e-4-3e-4 (by norm) of rounding at 512 tokens, the port's and the
    reference's alike, against an f64 evaluation of the cell.  The cell's own
    gradient over two chunks, carry included, is held at 1e-4 apart
    (``test_mlstm_cell_gradient_matches_reference``)."""
    _, ref, params = jax_side
    b = _batches(1, seq=LONG_SEQ, batch=1)[0]
    jb = _jax_batch(b)
    (jl, _), jg = _f32_program(ref, params, jb)(
        _cast(params, jnp.float32), jb)
    jg = _by_name(jg)
    model = _port(_cast(params, jnp.float32), torch.float32, remat=False)
    tl, tg = train.make_loss_and_grad(model, accum=1)(_state(model),
                                                       _torch_batch(b))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    dev = {n: np.linalg.norm(tg[n].numpy() - r) / np.linalg.norm(r)
           for n, r in jg.items()}
    worst = max(dev, key=dev.get)
    assert dev[worst] <= TWO_CHUNK_NORM, (worst, dev[worst])


# ------------------------------------------------------------- the cell

def _cell_inputs(seed, B, T, H, D, gates=None):
    """q, k, v normal; i_raw 0.5 normal, f_raw 0.5 normal + 4, as the
    model's gates lie at init (f's bias 3-6), or constant ``gates`` =
    (f, i); all f32 numpy."""
    rng = np.random.default_rng(seed)
    qkv = [rng.standard_normal((B, T, H, D)).astype(np.float32)
           for _ in range(3)]
    i_raw = (rng.standard_normal((B, T, H)) * 0.5).astype(np.float32)
    f_raw = (rng.standard_normal((B, T, H)) * 0.5 + 4).astype(np.float32)
    if gates is not None:
        f_raw = np.full((B, T, H), gates[0], np.float32)
        i_raw = np.full((B, T, H), gates[1], np.float32)
    return qkv + [i_raw, f_raw]


CELL = dict(B=2, T=128, H=2, D=32, chunk=64)     # two chunks


@pytest.fixture(scope="module")
def cell_grad():
    """The reference's ``mlstm_chunked`` input gradients at cotangents of
    h and, weighted by ``w`` (0 or 1), of the final (C, n, m): one program
    for every cell case."""
    def fn(q, k, v, i_raw, f_raw, gh, gC, gn, gm, w):
        h, (C, n, m) = JX.mlstm_chunked(q, k, v, i_raw, f_raw,
                                        chunk=CELL["chunk"])
        return jnp.sum(h * gh) + w * (jnp.sum(C * gC) + jnp.sum(n * gn)
                                      + jnp.sum(m * gm))
    B, T, H, D = CELL["B"], CELL["T"], CELL["H"], CELL["D"]
    f32 = jnp.float32
    shapes = [(B, T, H, D)] * 3 + [(B, T, H)] * 2 + [
        (B, T, H, D), (B, H, D, D), (B, H, D), (B, H), ()]
    prog = _compile(jax.grad(fn, argnums=tuple(range(5))),
                    *[jax.ShapeDtypeStruct(s, f32) for s in shapes])

    def run(arrays, cot, carry: bool):
        return prog(*[jnp.asarray(a) for a in arrays + cot],
                    jnp.float32(carry))
    return run


def _cell_case(cell_grad, seed, gates, *, carry: bool):
    arrays = _cell_inputs(seed, CELL["B"], CELL["T"], CELL["H"], CELL["D"],
                          gates)
    B, T, H, D = arrays[0].shape
    rng = np.random.default_rng(seed + 1)
    cot = [rng.standard_normal(s).astype(np.float32) for s in
           ((B, T, H, D), (B, H, D, D), (B, H, D), (B, H))]
    tcot = [torch.from_numpy(c) for c in cot]
    ours = mlstm_backward_ref(*[torch.from_numpy(a) for a in arrays],
                              tcot[0], tuple(tcot[1:]) if carry
                              else (None, None, None), chunk=CELL["chunk"])
    ref = cell_grad(arrays, cot, carry)
    return [o.numpy() for o in ours], [np.asarray(r) for r in ref]


@pytest.mark.parametrize("carry", [False, True])
def test_mlstm_cell_gradient_matches_reference(cell_grad, carry):
    """The plain ``mlstm_chunked``'s gradient (``mlstm_backward_ref``, K4's
    backward on the card) against ``jax.grad`` of the reference's
    ``mlstm_chunked`` over two chunks, with a cotangent into h alone (the
    training path's) or into h and the final (C, n, m): f32, each input's
    gradient within 1e-4 of its largest value plus 1e-4 relative
    (measured about 2e-6 by norm from an f64 evaluation, either side)."""
    ours, ref = _cell_case(cell_grad, 21, None, carry=carry)
    for name, o, r in zip("q k v i_raw f_raw".split(), ours, ref):
        assert np.isfinite(o).all(), name
        np.testing.assert_allclose(o, r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max(), err_msg=name)


def test_mlstm_cell_gradient_under_stabiliser_ties(cell_grad):
    """f 100, i 0 at every token: log sigmoid(f) rounds to 0 in f32, so
    a_s = i_s - b_s is one value at every token and the stabiliser's
    cummax ties everywhere.  JAX splits a tie's gradient evenly,
    ``torch.cummax`` sends it to one index.  The stabiliser cancels out of
    h, so with a cotangent into h alone (the training path's) every
    gradient agrees; with cotangents into the carry too, whose (C, n) the
    stabiliser scales and whose m it sets, the gate gradients differ token
    by token, and their sums over the tied tokens of each sequence and
    head agree.  f's gradient, sigmoid(-100) times the rest, is 0 in f32
    on both sides up to denormals (the 1e-30 floor)."""
    for carry in (False, True):
        ours, ref = _cell_case(cell_grad, 23, (100.0, 0.0), carry=carry)
        for name, o, r in zip("q k v i_raw f_raw".split(), ours, ref):
            if carry and name in ("i_raw", "f_raw"):
                o, r = o.sum(axis=1), r.sum(axis=1)
            np.testing.assert_allclose(o, r, rtol=1e-4,
                                       atol=1e-4 * np.abs(r).max() + 1e-30,
                                       err_msg=f"{name} carry={carry}")


class _FakeExtension:
    """K4's binding, stood in for by the plain version on the CPU."""

    @staticmethod
    def mlstm(q, k, v, i_raw, f_raw, chunk):
        h, (C, n, m) = mlstm_chunked(q, k, v, i_raw, f_raw, chunk=chunk)
        return h, C, n, m


def test_mlstm_function_takes_the_carrys_gradient(monkeypatch):
    """``MLSTMFn`` (the card's mLSTM op under autograd; here its forward is
    the plain version in place of the kernel), bf16 q, k, v and f32 gates
    over two chunks, with gradients into h and into the final (C, n, m):
    its outputs and each input's gradient are the plain version's bitwise;
    one launch counted a forward.  (With a gradient into h alone, the
    training path's, test_torch_train.py holds it.)"""
    monkeypatch.setattr(mlstm_ops, "extension", _FakeExtension)
    arrays = _cell_inputs(23, 1, 64, 2, 16)
    inputs = [torch.from_numpy(a).bfloat16() for a in arrays[:3]] + \
        [torch.from_numpy(a) for a in arrays[3:]]
    rng = np.random.default_rng(24)
    cot = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in ((1, 64, 2, 16), (1, 2, 16, 16), (1, 2, 16), (1, 2))]
    cot[0] = cot[0].bfloat16()
    out = []
    for fn in (lambda *a: mlstm_ops.MLSTMFn.apply(*a, 32),
               lambda *a: (lambda h, c: (h, *c))(
                   *mlstm_chunked(*a, chunk=32))):
        leaves = [x.detach().requires_grad_() for x in inputs]
        before = mlstm_ops.MLSTM.launches
        outs = fn(*leaves)
        launched = mlstm_ops.MLSTM.launches - before
        grads = torch.autograd.grad(outs, leaves, cot)
        out.append((outs, grads, launched))
    (o, g, n), (o0, g0, n0) = out
    assert (n, n0) == (1, 0)
    assert o[0].grad_fn is not None
    assert all(torch.equal(a, b) for a, b in zip(o, o0))
    assert all(torch.equal(a, b) for a, b in zip(g, g0))


def test_slstm_first_token_gives_a_finite_gradient():
    """m = -1e30 before the first token: exp(log f + m - m_new) is 0 there,
    and the backward through it must stay finite."""
    rng = np.random.default_rng(25)
    xg = torch.from_numpy(rng.standard_normal((1, 4, 2, 4, 8)).astype(
        np.float32)).requires_grad_()
    r_w = torch.from_numpy((rng.standard_normal((2, 4, 8, 8)) * 0.01)
                           .astype(np.float32)).requires_grad_()
    hs, _ = X.slstm_scan(xg, r_w, X.slstm_zero_carry(1, 2, 8))
    gx, gr = torch.autograd.grad(hs.square().sum(), (xg, r_w))
    assert torch.isfinite(gx).all() and torch.isfinite(gr).all()
    assert gx.abs().sum() > 0 and gr.abs().sum() > 0


# ---------------------------------------------------------------- remat

def test_remat_gives_the_same_gradients_bitwise(jax_side):
    _, _, params = jax_side
    batch = _torch_batch(_batches(1)[0])
    out = []
    for remat in (True, False):
        model = _port(params, torch.bfloat16, remat=remat)
        out.append(train.make_loss_and_grad(model, accum=2)(_state(model),
                                                            batch))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n


def expected_calls(cfg, *, remat: bool) -> dict:
    """Op calls of one forward (and backward) of the xLSTM: an mLSTM cell
    an mLSTM block; one RMSNorm a block (its output norm; the block and
    final norms are LayerNorms); one sLSTM scan a super-block.  Remat runs
    each super-block and each tail block once more in the backward, which
    leaves out only the final norm, a LayerNorm: every cell, scan and
    RMSNorm runs twice."""
    n_super = cfg.n_layers // cfg.slstm_every
    once = {"mlstm": cfg.n_layers - n_super, "rmsnorm": cfg.n_layers,
            "slstm": n_super}
    return {k: n * (2 if remat else 1) for k, n in once.items()}


def _count_calls(monkeypatch):
    """Counts of the plain ops the CPU path calls where the card launches
    K4 and K1, and of the sLSTM scan."""
    calls = {k: 0 for k in ("mlstm", "rmsnorm", "slstm")}

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(mlstm_ops, "mlstm_chunked",
                        counted("mlstm", mlstm_ops.mlstm_chunked))
    monkeypatch.setattr(rms_ops, "rmsnorm_ref",
                        counted("rmsnorm", rms_ops.rmsnorm_ref))
    monkeypatch.setattr(X, "slstm_scan", counted("slstm", X.slstm_scan))
    return calls


def test_remat_recomputes_super_blocks_under_grad_only(jax_side,
                                                       monkeypatch):
    """With remat the backward runs every super-block (its mLSTM blocks
    and its sLSTM block) again, and not the final norm; under no_grad
    (serving) each runs once.  Counted at the plain ops the CPU path calls
    where the card launches K4 and K1 (the launch counts of chip_smoke.py's
    train_xlstm phase)."""
    _, _, params = jax_side
    calls = _count_calls(monkeypatch)
    batch = _torch_batch(_batches(1)[0])
    for remat in (True, False):
        model = _port(params, torch.bfloat16, remat=remat)
        calls.update({k: 0 for k in calls})
        train.make_loss_and_grad(model, accum=2)(_state(model), batch)
        want = expected_calls(model.cfg, remat=remat)
        assert calls == {k: 2 * n for k, n in want.items()}, remat
        calls.update({k: 0 for k in calls})
        with torch.no_grad():
            model.forward_logits(batch["tokens"])
        assert calls == expected_calls(model.cfg, remat=False)


@pytest.fixture(scope="module")
def tail_params(jax_side):
    """The reference's params at a depth of 6, one super-block and a
    2-block tail, cut from its 8-layer init (super-block 0; the tail
    super-block 1's first two mLSTM blocks): the tree its depth-6 model
    inits, leaf for leaf in shape and dtype."""
    _, _, params = jax_side
    blocks = jax.tree.map(lambda a: a[:1], params["blocks"])
    tail = jax.tree.map(lambda a: a[1, :2], params["blocks"]["mlstm"])
    params = dict(params, blocks=blocks, tail=tail)
    ref = jax_build_model(_jax_cfg(TAIL_LAYERS), remat=False)
    shapes = jax.eval_shape(ref.init, jax.random.key(0))
    assert jax.tree.map(lambda a: (a.shape, a.dtype), params) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), shapes)
    return params


def test_tail_blocks_are_checkpointed(tail_params, monkeypatch):
    """At a depth of 6 the model has a tail (``dataclasses.replace`` on
    both sides, the reference's tree at that depth loaded): the gradients
    with remat are those without it bit for bit, and remat runs the
    super-block and each tail block again in the backward."""
    mb = _torch_batch(_halves(_batches(1)[0])[0])
    calls = _count_calls(monkeypatch)
    out = []
    for remat in (True, False):
        model = _port(tail_params, torch.bfloat16, remat=remat,
                      n_layers=TAIL_LAYERS)
        assert (model.n_super, model.n_tail) == (1, 2)
        calls.update({k: 0 for k in calls})
        out.append(train.make_loss_and_grad(model, accum=1)(_state(model),
                                                            mb))
        assert calls == expected_calls(model.cfg, remat=remat), remat
    (la, ga), (lb, gb) = out
    assert torch.isfinite(la) and torch.equal(la, lb)
    assert all(torch.equal(ga[n], gb[n]) for n in ga)


# --------------------------------------------------------------- the step

def test_train_curve_matches_reference(jax_side, programs):
    """3 steps of the port's step (accum 2) against the reference's step
    (its accum-2 loss-and-grad, then its AdamW ``apply``, as its
    ``make_train_step`` composes them in the "xla" mode), in f32: loss and
    grad norm each step within 1e-4 (test_torch_train.py's f32 curve
    bound; the bf16 path is held leaf by leaf above)."""
    dtype = "f32"
    jdt, tdt = DTYPES[dtype]
    _, _, params = jax_side
    params = _cast(params, jdt)
    jstate = joptim.init(joptim.AdamWConfig(**OCFG), params)
    model = _port(params, tdt)
    tcfg = optim.AdamWConfig(**OCFG)
    tstep = train.make_train_step(model, tcfg, accum=2, device="cpu")
    tparams = _state(model)
    tstate = optim.init(tcfg, tparams)
    rows = []
    for b in _batches(3):
        jl, _, jg = _ref_loss_and_grad(programs, dtype, params, b, 2)
        params, jstate, jm = programs["apply"](params, jg, jstate)
        tparams, tstate, tm = tstep(tparams, tstate, _torch_batch(b))
        rows.append((float(jl), float(jm["grad_norm"]),
                     tm["loss"].item(), tm["grad_norm"].item()))
    rows = np.asarray(rows)
    np.testing.assert_allclose(rows[:, 2], rows[:, 0], rtol=1e-4)
    np.testing.assert_allclose(rows[:, 3], rows[:, 1], rtol=1e-4)
    assert rows[-1, 2] < rows[0, 2]


# --------------------------------------------------------- bucket layout

def _slot_fields(slot):
    return (slot.bucket, slot.offset, slot.size, tuple(slot.shape),
            str(np.dtype(slot.dtype)) if not isinstance(slot.dtype,
                                                        torch.dtype)
            else str(slot.dtype).replace("torch.", ""))


def _paths(tree):
    """The reference's leaf paths in ``jax.tree.flatten`` order."""
    return [".".join(k.key for k in kp) for kp, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("bucket_bytes,align",
                         [(32 << 20, 1), (SMALL, 2), (SMALL, 4), (4096, 1)])
def test_bucket_layout_and_buffers_match_reference(jax_side, bucket_bytes,
                                                   align):
    """The xLSTM's leaves (``blocks.mlstm`` stacked over super-block and
    block, ``blocks.slstm`` over super-block) in the reference's order,
    buckets and flat buffers bit for bit."""
    _, _, params = jax_side
    tparams = _state(_port(params, torch.bfloat16))
    jl = JBK.plan_buckets(params, bucket_bytes=bucket_bytes, align=align)
    tl = train.make_bucket_layout(tparams, bucket_bytes=bucket_bytes,
                                  family=FAMILY) if align == 1 else \
        BK.plan_buckets(tparams, bucket_bytes=bucket_bytes, align=align,
                        family=FAMILY)
    assert tl.bucket_sizes == jl.bucket_sizes
    assert [_slot_fields(s) for s in tl.slots] == \
        [_slot_fields(s) for s in jl.slots]
    assert [s.path for s in tl.slots] == _paths(params)
    for a, b in zip(BK.flatten_to_buckets(tl, tparams),
                    JBK.flatten_to_buckets(jl, params)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("n_layers", [None, TAIL_LAYERS])
def test_full_config_layout_matches_reference(n_layers):
    """xlstm-125m at full width, from shapes alone (and at a depth of 6,
    with a tail): the reference through ``jax.eval_shape``, the port on
    the meta device."""
    jcfg, tcfg = jax_get_config(ARCH), get_config(ARCH)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.key(0))
    named = dict(build_model(tcfg, device="meta", seed=None)
                 .named_parameters())
    jl = JBK.plan_buckets(shapes, align=2)
    tl = BK.plan_buckets(named, align=2, family=FAMILY)
    assert tl.bucket_sizes == jl.bucket_sizes
    assert [_slot_fields(s) for s in tl.slots] == \
        [_slot_fields(s) for s in jl.slots]
    assert [s.path for s in tl.slots] == _paths(shapes)
    assert tl.n_elements() == sum(p.numel() for p in named.values())


# ------------------------------------------------- the sync on gloo ranks

RANKS, ACCUM = 4, 2
RANK_DATA = dict(vocab_size=512, seq_len=32, global_batch=8)
# no warmup: both steps update the params
RANK_OCFG = {"a": dict(peak_lr=1e-3, warmup_steps=0, total_steps=30)}
RANK_STEPS = 2
RANK_RUNS = {"hier_bucketed": dict(mode="hier_bucketed", steps=RANK_STEPS),
             "zero1": dict(mode="hier_bucketed_zero1", steps=RANK_STEPS)}


@pytest.fixture(scope="module")
def ranks(jax_side):
    """4 gloo ranks on a (pod 2, data 2) grid train the reduced xLSTM in
    f32 (``tests/_torch_ranks.py::sync_train_ranks``: each run, then the
    Trainer on the grid, zero1 for 2 steps)."""
    _, _, params = jax_side
    weights = {n: t.float().numpy() for n, t in params_from_jax(
        jax.tree.map(np.asarray, params), FAMILY).items()}
    spec = {"cfg": _torch_cfg(), "weights": weights, "data": RANK_DATA,
            "ocfg": RANK_OCFG, "accum": ACCUM, "runs": RANK_RUNS,
            "trainer_steps": RANK_STEPS}
    return weights, run_ranks(R.sync_train_ranks, RANKS, args=(spec,),
                              threads=1, deadline_s=600)


def test_zero1_bitwise_equals_hier_bucketed_on_gloo_ranks(ranks):
    """zero1 ≡ hier_bucketed bit for bit on every rank (the reference's
    invariant); every rank holds the same params after every step; the
    Trainer on the grid (zero1, the same weights and batches) is the zero1
    run."""
    _, out = ranks
    for r in range(RANKS):
        a, b = out[r]["hier_bucketed"], out[r]["zero1"]
        assert a["loss"] == b["loss"] and a["digests"] == b["digests"]
        assert a["grad_norm"] == b["grad_norm"]
        for name in RANK_RUNS:
            assert out[r][name]["digests"] == out[0][name]["digests"]
        assert out[r]["trainer"]["loss"] == b["loss"]
    assert len(set(out[0]["zero1"]["digests"])) == RANK_STEPS


def test_hier_bucketed_on_gloo_ranks_matches_the_single_rank_step(ranks):
    """The bucketed manual-sync mode on 4 ranks against the single-rank
    step on the global batch (accum = ranks x accum), within the
    reference's bound between modes (tests/test_bucketing.py, rtol 1e-4,
    atol 1e-5); the single-rank step is held against the reference's by
    ``test_train_curve_matches_reference``."""
    weights, out = ranks
    model = build_model(_torch_cfg(), device="cpu", seed=None, remat=False,
                        dtype=torch.float32)
    model.load_state_dict({n: torch.from_numpy(a) for n, a in
                           weights.items()})
    ocfg = optim.AdamWConfig(**RANK_OCFG["a"])
    step = train.make_train_step(model, ocfg, accum=RANKS * ACCUM,
                                 device="cpu")
    params = _state(model)
    state = optim.init(ocfg, params)
    corpus = data.SyntheticCorpus(data.DataConfig(**RANK_DATA))
    single = []
    for i in range(RANK_STEPS):
        params, state, m = step(params, state,
                                _torch_batch(corpus.batch(i)))
        single.append((m["loss"].item(), m["grad_norm"].item()))
    run = out[0]["hier_bucketed"]
    np.testing.assert_allclose(np.stack([run["loss"], run["grad_norm"]], 1),
                               single, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------ the Trainer's save

MODES = ["xla", "hier_bucketed_zero1"]


def _ref_state(params, mode):
    """The reference's training state for ``mode`` at step 3, its second
    moments random (positive: a resumed step stays finite)."""
    rng = np.random.default_rng(1)
    ocfg = joptim.AdamWConfig(**OCFG)
    if mode == "xla":
        st = joptim.init(ocfg, params)
        nu = jax.tree.map(lambda a: jnp.asarray(np.abs(rng.standard_normal(
            a.shape)).astype(np.float32)), params)
        return st._replace(step=jnp.int32(3), nu=nu), None
    layout = jtrain.make_bucket_layout(params, None, bucket_bytes=SMALL)
    st = joptim.init_bucketed(ocfg, params, layout)
    nu = tuple(jnp.asarray(np.abs(rng.standard_normal(c)).astype(
        np.float32)) for c in layout.bucket_sizes)
    return st._replace(step=jnp.int32(3), nu=nu), layout


def _port_state(jparams, jopt, mode):
    """The same state as the port holds it."""
    params = params_from_jax(jax.tree.map(np.asarray, jparams), FAMILY)
    if mode == "xla":
        opt = optim.OptState(
            step=3, mu=params_from_jax(jax.tree.map(np.asarray, jopt.mu),
                                       FAMILY),
            nu=params_from_jax(jax.tree.map(np.asarray, jopt.nu), FAMILY),
            master=params_from_jax(jax.tree.map(np.asarray, jopt.master),
                                   FAMILY))
    else:
        opt = optim.BucketedOptState(
            step=3, **{k: tuple(torch.from_numpy(np.array(a)) for a in
                                getattr(jopt, k))
                       for k in ("mu", "nu", "master")})
    return params, opt


def _trainer_cfg(ckpt_dir, mode, n_steps=3):
    """Both Trainers' config: a blocking sharded save at step 3."""
    return dict(n_steps=n_steps, ckpt_every=3, log_every=1, accum=2,
                ckpt_dir=ckpt_dir, cross_pod_mode=mode, bucket_bytes=SMALL,
                async_ckpt=False, save_sharded=True)


@pytest.fixture(scope="module")
def saved(jax_side, tmp_path_factory):
    """Each mode's state saved at step 3 by each package's Trainer path:
    the reference's ``Trainer._run`` calls (``save_sharded`` with its
    layout) and the port's ``Trainer._save``."""
    _, _, params = jax_side
    base = tmp_path_factory.mktemp("xlstm_saved")
    out = {}
    for mode in MODES:
        jopt, jlayout = _ref_state(params, mode)
        tparams, topt = _port_state(params, jopt, mode)
        d = {k: str(base / f"{mode}_{k}") for k in ("j", "t")}
        jckpt.save_sharded(jckpt.step_dir(d["j"], 3), 3, (params, jopt),
                           layout=jlayout)
        model = _port(params, torch.bfloat16)
        tr = train.Trainer(model, optim.AdamWConfig(**OCFG),
                           train.TrainerConfig(**_trainer_cfg(d["t"], mode)),
                           data.DataConfig(vocab_size=512, seq_len=32,
                                           global_batch=4),
                           device="cpu")
        tr._init_state(None)
        tr._join(tr._save(3, tparams, topt))
        out[mode] = (d, jopt, tparams, topt)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_trainer_save_matches_reference_bytes(saved, mode):
    d, _, _, _ = saved[mode]
    ref = R.files_digest(jckpt.step_dir(d["j"], 3))
    ours = R.files_digest(jckpt.step_dir(d["t"], 3))
    assert sorted(ours) == sorted(ref) and ours == ref
    assert ckpt.latest_step(d["t"]) == jckpt.latest_step(d["j"]) == 3


def test_gathered_save_matches_reference_bytes(jax_side, tmp_path):
    """The legacy (gathered) format of the "xla" state, saved by each
    package's checkpoint module, byte for byte."""
    _, _, params = jax_side
    jopt, _ = _ref_state(params, "xla")
    tparams, topt = _port_state(params, jopt, "xla")
    jlegacy.save(jckpt.step_dir(str(tmp_path / "j"), 3), 3, (params, jopt))
    model = _port(params, torch.bfloat16)
    tr = train.Trainer(model, optim.AdamWConfig(**OCFG),
                       train.TrainerConfig(**dict(
                           _trainer_cfg(str(tmp_path / "t"), "xla"),
                           save_sharded=False)),
                       data.DataConfig(vocab_size=512, seq_len=32,
                                       global_batch=4), device="cpu")
    tr._init_state(None)
    tr._join(tr._save(3, tparams, topt))
    assert R.files_digest(jckpt.step_dir(str(tmp_path / "t"), 3)) == \
        R.files_digest(jckpt.step_dir(str(tmp_path / "j"), 3))


def _np_leaves(tree):
    return [np.asarray(x).reshape(-1).view(np.uint8)
            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("mode", MODES)
def test_each_trainer_resumes_the_others_checkpoint(jax_side, saved, mode):
    """The port's Trainer resumes the reference's save, the reference's
    Trainer the port's, each through its own restore (templates, policy,
    layout), to the saved state bit for bit; the port's then trains on
    from it."""
    _, ref, params = jax_side
    d, jopt, tparams, topt = saved[mode]
    dcfg = dict(vocab_size=512, seq_len=32, global_batch=4)
    jout = jtrain.Trainer(
        ref, joptim.AdamWConfig(**OCFG),
        jtrain.TrainerConfig(**_trainer_cfg(d["t"], mode)),
        jdata.DataConfig(**dcfg)).run(seed=0, resume=True)
    for a, b in zip(_np_leaves((params, jopt)),
                    _np_leaves((jout["params"], jout["opt_state"]))):
        np.testing.assert_array_equal(a, b)
    model = _port(params, torch.bfloat16)
    tr = train.Trainer(model, optim.AdamWConfig(**OCFG),
                       train.TrainerConfig(**_trainer_cfg(d["j"], mode,
                                                          n_steps=5)),
                       data.DataConfig(**dcfg), device="cpu")
    start, rparams, ropt, _ = tr._restore(*tr._init_state(None))
    assert start == 3 and set(rparams) == set(tparams)
    assert all(torch.equal(rparams[n], tparams[n]) for n in tparams)
    for k in ("mu", "nu", "master"):
        a, b = getattr(ropt, k), getattr(topt, k)
        pairs = ([(a[n], b[n]) for n in b] if mode == "xla"
                 else list(zip(a, b)))
        assert len(pairs) == len(a) and all(torch.equal(x, y)
                                            for x, y in pairs), k
    out = tr.run(seed=None, resume=True)
    assert [h["step"] for h in out["history"]] == [3, 4]
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert out["opt_state"].step == 5


# ------------------------------------------------------------ the launcher

def test_launcher_trains_the_xlstm_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "4",
          "--seq", "32", "--ckpt-dir", str(tmp_path), "--no-resume"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("step    0  loss ")
    loss = float(lines[0].split()[3])
    assert np.isfinite(loss) and abs(loss - np.log(512)) < 1.0


def test_full_config_launches_a_training_step():
    """At the published config (3 super-blocks of 3 mLSTM blocks and an
    sLSTM block) one training step of accum 1 with remat makes 18 mLSTM
    cells and 24 RMSNorms: the K4 and K1 launches chip_smoke.py's
    train_xlstm phase counts on the card."""
    want = expected_calls(get_config(ARCH), remat=True)
    assert {k: want[k] for k in ("mlstm", "rmsnorm")} == \
        {"mlstm": 18, "rmsnorm": 24}
