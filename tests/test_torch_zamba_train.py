"""The port's training path of the hybrid (zamba2) against the JAX package
on the CPU, at ``reduced_config``: 8 layers, the shared attention block
every 3 (2 super-blocks and a 2-block tail), d_model 128, chunk 32.

``ZambaLM.loss``, every leaf of ``make_loss_and_grad`` at accum 1 and 2
against ``jax.grad`` of the reference's loss (as the reference's
``make_loss_and_grad`` differentiates it), remat at the reference's
granularity, ``SSDFn``, the train step's curve, the bucket layout, zero1
against hier_bucketed on 4 gloo ranks, the Trainer's checkpoint bytes and
each package's Trainer resuming the other's, and the launcher.

Weights come from the reference's init (key 3) through ``params_from_jax``,
batches from the reference's ``SyntheticCorpus`` (64 tokens: two chunks, so
the cross-chunk recurrence runs).  Bounds, as ``test_torch_train.py``'s:
f32 1e-4 relative where a model's forward and backward feed a value (the
gradients measured 7e-6 of each leaf's largest value at most, the loss
8e-8: at chunk 32 the port's f64 decay cumsum moves nothing measurable);
bf16 the reference's own bounds of tests/test_train_optim.py (rtol 2e-2,
atol 1e-3), see ``test_loss_and_grad_matches_reference``.
"""
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
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch import ckpt, data, optim, train
from repro_torch.collectives import bucketing as BK
from repro_torch.convert import params_from_jax
from repro_torch.kernels.mamba_scan import ops as ssd_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import layers as L
from repro_torch.models import zamba as Z
from repro_torch.models.registry import build_model, get_config, \
    reduced_config
from repro_torch.parallel.launch import run_ranks
from tests import _torch_ranks as R
from tests._torch_threads import one_torch_thread  # noqa: F401

ARCH = "zamba2-1.2b"
FAMILY = "hybrid"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
F32_MODEL = dict(rtol=1e-4, atol=1e-6)
BF16_MODEL = dict(rtol=2e-2, atol=1e-3)
SEQ, BATCH = 64, 4
OCFG = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
SMALL = 64 << 10          # bucket bytes of a multi-bucket layout


# The reference's programs are compiled with LLVM's optimizations off: at
# reduced width their compile, not their run, takes the time (on one core
# 25 s for the init and 24 s for a loss-and-grad with them on, 6 and 13 s
# off).  The init's output is bitwise the default compile's; a
# loss-and-grad's moves in its last bits, far inside the bounds below.
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


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_reduced_config(jax_get_config(ARCH))
    ref = _Reference(jax_build_model(cfg, remat=False))
    return cfg, ref, ref.init(jax.random.key(3))


def _cast(params, dtype):
    """Matmul and conv weights to ``dtype``; the f32 leaves stay f32."""
    return jax.tree.map(
        lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16 else a, params)


def _port(params, dtype, *, remat=True):
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        dtype=dtype, seed=None, remat=remat)
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


# ---------------------------------------------------------------- the loss

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_zamba_loss_matches_reference(jax_side, programs, dtype):
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
        for accum in (1, 2):
            loss, _, grads = _ref_loss_and_grad(programs, name,
                                                _cast(params, jdt), batch,
                                                accum)
            out[(name, accum)] = (float(loss), _by_name(grads))
    return batch, out


@pytest.mark.parametrize("dtype,accum", [("f32", 1), ("f32", 2),
                                         ("bf16", 1), ("bf16", 2)])
def test_loss_and_grad_matches_reference(jax_side, ref_grads, dtype,
                                         accum):
    """Every leaf: the shared attention block (its gradient the sum over
    its 2 applications), A_log, dt_bias, Dskip, the convs, the gated
    norm, the tied embedding.

    f32, at accum 1 and 2: within 1e-4 (measured: 7e-6 of the leaf's
    largest value).

    bf16, at accum 1 and 2: the two sides' bf16 gradients each lie within
    their bf16 rounding noise of the (common) f32 gradient.  (a) On every
    leaf of the reference's (stacked over blocks) the port's lies no
    further from the f32 gradient, by norm, than 1.5x the reference's
    does, as test_torch_train.py holds the dense model: a gradient
    accumulated in bf16 would not (measured at most 1.26x at accum 2,
    ``blocks.mamba.A_log``; 1.48x at accum 1, ``tail.mamba.A_log``).  (b)
    Every leaf lies within the reference's bf16 bound (rtol 2e-2, atol
    1e-3) of the reference's bf16 gradient, the atol raised, where the
    reference's own bf16 noise (its largest deviation from its f32
    gradient on the leaf) is larger, to 2.5x that noise: the sum of the
    two sides' noises when the port's is at most 1.5x the reference's.
    The leaves this raises are the small, noisy ones (a block's 8 Dskip
    values, up to 1.6e-3 of noise; the embedding, whose rows sum many bf16
    terms, 1.3e-2); measured at most 0.84 of the bound at accum 1
    (``blocks.0.0.mamba.Dskip``), 0.52 at accum 2.

    Why accum 1 comes near (a)'s limit: ``tail.mamba.A_log`` holds 16
    values (2 tail blocks x 8 heads), and the two sides round at different
    points, so their noises on it are independent and each norm is taken
    over 16 draws; the ratio of two such norms spreads wide (it exceeds
    1.5 with a chance of about 6% for equal noises).  At accum 2 the same
    leaf measures 1.23x.  The inputs are fixed, so the measured ratio is
    the same at every thread count (1, 4, 8 measured).
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
    if dtype == "f32":
        np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
        for n, ref in jg.items():
            np.testing.assert_allclose(tg[n].numpy(), ref, err_msg=n,
                                       **F32_MODEL)
        return
    np.testing.assert_allclose(tl.item(), jl, rtol=2e-3)
    _, g32 = out[("f32", accum)]
    ours = {n: g.numpy() for n, g in tg.items()}
    for path, leaf in BK.leaf_tree(tg, FAMILY).items():
        o, r, f = (np.concatenate([t[p].reshape(-1) for p in leaf.parts])
                   for t in (ours, jg, g32))
        assert np.linalg.norm(o - f) <= 1.5 * np.linalg.norm(r - f), path
    for n, ref in jg.items():
        noise = np.abs(ref - g32[n]).max()
        np.testing.assert_allclose(
            ours[n], ref, rtol=BF16_MODEL["rtol"],
            atol=max(BF16_MODEL["atol"], 2.5 * noise), err_msg=n)


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
    """Op calls of one forward (and backward) of the hybrid: an SSD scan a
    mamba block; two norms a mamba block (its pre-norm, its gated norm),
    two an application of the shared block, the final norm; one attention
    an application.  Remat runs each super-block and each tail block once
    more in the backward: all but the final norm."""
    n_super = cfg.n_layers // cfg.hybrid_attn_every
    once = {"ssd": cfg.n_layers, "attention": n_super,
            "rmsnorm": 2 * cfg.n_layers + 2 * n_super + 1,
            "super_blocks": n_super}
    again = {"ssd": cfg.n_layers, "attention": n_super,
             "rmsnorm": 2 * cfg.n_layers + 2 * n_super,
             "super_blocks": n_super}
    return {k: n + (again[k] if remat else 0) for k, n in once.items()}


def test_remat_recomputes_super_and_tail_blocks_under_grad_only(
        jax_side, monkeypatch):
    """With remat the backward runs every super-block (its mamba blocks
    and the shared attention's application) and every tail block again, and
    not the final norm; under no_grad (serving) each runs once.  Counted at
    the plain ops the CPU path calls where the card launches K3, K2 and K1
    (the launch counts of chip_smoke.py's train_hybrid phase)."""
    _, _, params = jax_side
    cfg = reduced_config(get_config(ARCH))
    calls = {k: 0 for k in ("ssd", "attention", "rmsnorm", "super_blocks")}

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ssd_ops, "ssd_chunked",
                        counted("ssd", ssd_ops.ssd_chunked))
    monkeypatch.setattr(L, "full_attention",
                        counted("attention", L.full_attention))
    monkeypatch.setattr(rms_ops, "rmsnorm_ref",
                        counted("rmsnorm", rms_ops.rmsnorm_ref))
    monkeypatch.setattr(Z, "layer_apply",
                        counted("super_blocks", Z.layer_apply))
    batch = _torch_batch(_batches(1)[0])
    for remat in (True, False):
        model = _port(params, torch.bfloat16, remat=remat)
        calls.update({k: 0 for k in calls})
        train.make_loss_and_grad(model, accum=2)(_state(model), batch)
        want = expected_calls(cfg, remat=remat)
        assert calls == {k: 2 * n for k, n in want.items()}, remat
        calls.update({k: 0 for k in calls})
        with torch.no_grad():
            model.forward_logits(batch["tokens"])
        assert calls == expected_calls(cfg, remat=False)


def test_ssd_function_takes_the_final_states_gradient(monkeypatch):
    """``SSDFn`` (the card's SSD op under autograd; here its forward is
    the plain version in place of the kernel) with gradients into both y
    and the final state: the plain version's input gradients, bitwise."""

    class FakeExtension:
        @staticmethod
        def ssd(x, dt, A, B, C, chunk):
            return ssd_ops.ssd_chunked(x, dt, A, B, C, chunk=chunk)

    monkeypatch.setattr(ssd_ops, "extension", FakeExtension)
    rng = np.random.default_rng(11)

    def t(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)

    inputs = (t(1, 64, 4, 32),
              torch.nn.functional.softplus(t(1, 64, 4, dtype=torch.float32)),
              -torch.exp(t(4, dtype=torch.float32)), t(1, 64, 1, 16),
              t(1, 64, 1, 16))
    gy, gs = t(1, 64, 4, 32), t(1, 4, 32, 16, dtype=torch.float32)
    out = []
    for fn in (lambda *a: ssd_ops.SSDFn.apply(*a, 32),
               lambda *a: ssd_ops.ssd_chunked(*a, chunk=32)):
        leaves = [x.detach().requires_grad_() for x in inputs]
        y, state = fn(*leaves)
        out.append((y, state, torch.autograd.grad((y, state), leaves,
                                                  (gy, gs))))
    (y, s, g), (y0, s0, g0) = out
    assert torch.equal(y, y0) and torch.equal(s, s0)
    assert all(torch.equal(a, b) for a, b in zip(g, g0))


# --------------------------------------------------------------- the step

def test_train_curve_matches_reference(jax_side, programs):
    """4 steps of the port's step (accum 2) against the reference's step
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
    for b in _batches(4):
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
    """The hybrid's leaves (``blocks`` stacked over super-block and block,
    ``tail`` over block) in the reference's order, buckets and flat
    buffers bit for bit."""
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


def test_full_config_layout_matches_reference():
    """zamba2-1.2b at full width, from shapes alone: the reference through
    ``jax.eval_shape``, the port on the meta device."""
    jcfg = jax_get_config(ARCH)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.key(0))
    named = dict(build_model(get_config(ARCH), device="meta",
                             seed=None).named_parameters())
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
RANK_OCFG = {"a": dict(peak_lr=1e-3, warmup_steps=2, total_steps=30)}
RANK_RUNS = {"hier": dict(mode="hier", steps=3),
             "hier_bucketed": dict(mode="hier_bucketed", steps=3),
             "zero1": dict(mode="hier_bucketed_zero1", steps=3)}


@pytest.fixture(scope="module")
def ranks(jax_side):
    """4 gloo ranks on a (pod 2, data 2) grid train the reduced hybrid in
    f32 (``tests/_torch_ranks.py::sync_train_ranks``: each run, then the
    Trainer on the grid, zero1 for 3 steps)."""
    _, _, params = jax_side
    weights = {n: t.float().numpy() for n, t in params_from_jax(
        jax.tree.map(np.asarray, params), FAMILY).items()}
    spec = {"cfg": reduced_config(get_config(ARCH)), "weights": weights,
            "data": RANK_DATA, "ocfg": RANK_OCFG, "accum": ACCUM,
            "runs": RANK_RUNS}
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
    assert len(set(out[0]["zero1"]["digests"])) == 3


@pytest.fixture(scope="module")
def single_rank(ranks):
    """The single-rank step on the global batch (accum = ranks x accum):
    per step (loss, grad norm)."""
    weights, _ = ranks
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        seed=None, remat=False, dtype=torch.float32)
    model.load_state_dict({n: torch.from_numpy(a) for n, a in
                           weights.items()})
    ocfg = optim.AdamWConfig(**RANK_OCFG["a"])
    step = train.make_train_step(model, ocfg, accum=RANKS * ACCUM,
                                 device="cpu")
    params = _state(model)
    state = optim.init(ocfg, params)
    corpus = data.SyntheticCorpus(data.DataConfig(**RANK_DATA))
    out = []
    for i in range(RANK_RUNS["hier"]["steps"]):
        params, state, m = step(params, state,
                                _torch_batch(corpus.batch(i)))
        out.append((m["loss"].item(), m["grad_norm"].item()))
    return out


@pytest.mark.parametrize("name", ["hier", "hier_bucketed"])
def test_manual_sync_on_gloo_ranks_matches_the_single_rank_step(
        ranks, single_rank, name):
    """The per-tensor and the bucketed manual-sync modes on 4 ranks
    against the single-rank step on the global batch, within the
    reference's bound between modes (tests/test_bucketing.py, rtol 1e-4,
    atol 1e-5); the single-rank step is held against the reference's by
    ``test_train_curve_matches_reference``."""
    _, out = ranks
    run = out[0][name]
    np.testing.assert_allclose(np.stack([run["loss"], run["grad_norm"]], 1),
                               single_rank, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------ the Trainer's save

MODES = ["xla", "hier_bucketed_zero1"]
FORMATS = ["sharded", "gathered"]


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


def _trainer_cfg(ckpt_dir, mode, fmt, n_steps=3):
    """Both Trainers' config: a blocking save at step 3."""
    return dict(n_steps=n_steps, ckpt_every=3, log_every=1, accum=2,
                ckpt_dir=ckpt_dir, cross_pod_mode=mode, bucket_bytes=SMALL,
                async_ckpt=False, save_sharded=fmt == "sharded")


@pytest.fixture(scope="module")
def saved(jax_side, tmp_path_factory):
    """Each mode's state saved at step 3 by each package's Trainer path:
    the reference's ``Trainer._run`` calls (``save_sharded`` with its
    layout, or the gathered ``checkpoint.save``) and the port's
    ``Trainer._save``."""
    _, _, params = jax_side
    base = tmp_path_factory.mktemp("zamba_saved")
    out = {}
    for mode in MODES:
        jopt, jlayout = _ref_state(params, mode)
        tparams, topt = _port_state(params, jopt, mode)
        for fmt in FORMATS:
            d = {k: str(base / f"{mode}_{fmt}_{k}") for k in ("j", "t")}
            sdir = jckpt.step_dir(d["j"], 3)
            if fmt == "sharded":
                jckpt.save_sharded(sdir, 3, (params, jopt), layout=jlayout)
            else:
                jlegacy.save(sdir, 3, (params, jopt))
            model = _port(params, torch.bfloat16)
            tr = train.Trainer(model, optim.AdamWConfig(**OCFG),
                               train.TrainerConfig(**_trainer_cfg(
                                   d["t"], mode, fmt)),
                               data.DataConfig(vocab_size=512, seq_len=32,
                                               global_batch=4),
                               device="cpu")
            tr._init_state(None)
            tr._join(tr._save(3, tparams, topt))
            out[(mode, fmt)] = (d, jopt, tparams, topt)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", MODES)
def test_trainer_save_matches_reference_bytes(saved, mode, fmt):
    d, _, _, _ = saved[(mode, fmt)]
    ref = R.files_digest(jckpt.step_dir(d["j"], 3))
    ours = R.files_digest(jckpt.step_dir(d["t"], 3))
    assert sorted(ours) == sorted(ref) and ours == ref
    assert ckpt.latest_step(d["t"]) == jckpt.latest_step(d["j"]) == 3


def _np_leaves(tree):
    return [np.asarray(x).reshape(-1).view(np.uint8)
            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", MODES)
def test_each_trainer_resumes_the_others_checkpoint(jax_side, saved, mode,
                                                    fmt):
    """The port's Trainer resumes the reference's save, the reference's
    Trainer the port's, each through its own restore (templates, policy,
    layout), to the saved state bit for bit; the port's then trains on
    from it."""
    _, ref, params = jax_side
    d, jopt, tparams, topt = saved[(mode, fmt)]
    dcfg = dict(vocab_size=512, seq_len=32, global_batch=4)
    jout = jtrain.Trainer(
        ref, joptim.AdamWConfig(**OCFG),
        jtrain.TrainerConfig(**_trainer_cfg(d["t"], mode, fmt)),
        jdata.DataConfig(**dcfg)).run(seed=0, resume=True)
    for a, b in zip(_np_leaves((params, jopt)),
                    _np_leaves((jout["params"], jout["opt_state"]))):
        np.testing.assert_array_equal(a, b)
    model = _port(params, torch.bfloat16)
    tr = train.Trainer(model, optim.AdamWConfig(**OCFG),
                       train.TrainerConfig(**_trainer_cfg(
                           d["j"], mode, fmt, n_steps=5)),
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

def test_launcher_trains_the_hybrid_on_the_cpu(capsys, tmp_path):
    from repro_torch.launch.train import main
    main(["--arch", ARCH, "--device", "cpu", "--steps", "2", "--batch", "4",
          "--seq", "32", "--ckpt-dir", str(tmp_path), "--no-resume"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("step    0  loss ")
    loss = float(lines[0].split()[3])
    assert np.isfinite(loss) and abs(loss - np.log(512)) < 1.0


def test_full_config_launches_a_training_step():
    """At the published config (38 mamba blocks, the shared block every 6)
    one training step of accum 2 with remat makes 152 SSD scans, 354 norms
    and 24 attentions: the K3, K1 and K2 launches chip_smoke.py's
    train_hybrid phase counts on the card."""
    want = expected_calls(get_config(ARCH), remat=True)
    assert {k: 2 * want[k] for k in ("ssd", "rmsnorm", "attention")} == \
        {"ssd": 152, "rmsnorm": 354, "attention": 24}
