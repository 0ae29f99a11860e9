"""The port's training path against the JAX package on the CPU: the loss,
the optimizer, accumulated loss-and-grad, the train step over 10 steps, the
data pipeline, heartbeats and stragglers, the Trainer and its launcher, and
the plain backward of the kernels.

Weights come from the reference's init through ``params_from_jax``, batches
from the reference's ``SyntheticCorpus``, other inputs from a numpy seed.
Bounds: f32 1e-6 relative for elementwise math (the schedule, AdamW, the
loss on given logits; the two sides differ only in exp/log/pow and sum
order), 1e-4 where a model's forward and backward feed it (the bound the
port's prefill tests use for long f32 reductions); bf16 the reference's own
bounds of tests/test_train_optim.py (rtol 2e-2, atol 1e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import elastic as jelastic
from repro import optim as joptim
from repro import train as jtrain
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch import data, elastic, optim, train
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_backward_ref,
                                                     attention_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref, rmsnorm_ref
from repro_torch.models import layers as L
from repro_torch.models.registry import build_model, get_config, \
    reduced_config

ARCH = "llama3.2-1b"
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# model-fed f32 values; the reference's bf16 bound (test_train_optim.py)
F32_MODEL = dict(rtol=1e-4, atol=1e-6)
BF16_MODEL = dict(rtol=2e-2, atol=1e-3)


@pytest.fixture(scope="module")
def jax_side():
    cfg = jax_reduced_config(jax_get_config(ARCH))
    model = jax_build_model(cfg, remat=False)
    return cfg, model, model.init(jax.random.key(3))


def _cast(params, dtype):
    """Matmul weights to ``dtype``; the f32 norm weights stay f32."""
    return jax.tree.map(
        lambda a: a.astype(dtype) if a.dtype == jnp.bfloat16 else a, params)


def _port(params, dtype, *, remat=True):
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        dtype=dtype, seed=None, remat=remat)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model


def _state(model):
    return {n: p.detach() for n, p in model.named_parameters()}


def _jax_grads_by_name(grads):
    """The reference's gradient tree as the port's names -> numpy."""
    return {n: t.float().numpy() for n, t in
            params_from_jax(jax.tree.map(np.asarray, grads)).items()}


def _corpus_batches(vocab, n, *, seq=32, batch=4):
    corpus = jdata.SyntheticCorpus(jdata.DataConfig(
        vocab_size=vocab, seq_len=seq, global_batch=batch))
    return [corpus.batch(i) for i in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close_trees(ours, ref, **tol):
    assert set(ours) == set(ref)
    for n in ref:
        np.testing.assert_allclose(ours[n].float().numpy(), ref[n],
                                   err_msg=n, **tol)


# --------------------------------------------------------------- the loss

@pytest.mark.parametrize("z_loss", [1e-4, 0.0])
def test_softmax_xent_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    B, S, V = 2, 8, 64
    logits = (rng.standard_normal((B, S, V)) * 3).astype(np.float32)
    targets = rng.integers(0, V, (B, S)).astype(np.int32)
    targets[0, :4] = logits[0, :4].argmax(-1)     # gold is the argmax

    def jloss(lg):
        nll, zl = JL.softmax_xent(lg, jnp.asarray(targets), z_loss)
        return nll + zl, (nll, zl)

    (_, (jnll, jzl)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    nll, zl = L.softmax_xent(tl, torch.from_numpy(targets), z_loss)
    (nll + zl).backward()
    np.testing.assert_allclose(nll.item(), float(jnll), rtol=1e-6)
    np.testing.assert_allclose(zl.item(), float(jzl), rtol=1e-6, atol=1e-12)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tl.grad.numpy(), jg, rtol=1e-6,
                               atol=1e-6 * np.abs(jg).max())
    # the argmax logit's gradient: softmax - one_hot (+ z-loss), no
    # parasitic +1 from a live max shift
    arg = logits.argmax(-1)
    picked = np.take_along_axis(tl.grad.numpy(), arg[..., None], -1)
    np.testing.assert_allclose(
        picked, np.take_along_axis(jg, arg[..., None], -1), rtol=1e-6,
        atol=1e-9)
    assert np.all(picked[0, :4] < 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_model_loss_matches_jax(jax_side, dtype):
    jdt, tdt = DTYPES[dtype]
    cfg, jmodel, params = jax_side
    params = _cast(params, jdt)
    batch = _corpus_batches(cfg.vocab_size, 1)[0]
    jl, jm = jmodel.loss(params, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    with torch.no_grad():
        tl, tm = _port(params, tdt).loss(_torch_batch(batch))
    tol = dict(rtol=1e-5) if dtype == "f32" else dict(rtol=2e-3)
    np.testing.assert_allclose(tl.item(), float(jl), **tol)
    for key in ("nll", "z_loss", "aux"):
        np.testing.assert_allclose(tm[key].item(), float(jm[key]), **tol,
                                   atol=1e-9)


def test_loss_of_hybrid_and_xlstm_is_not_ported():
    for arch in ("zamba2-1.2b", "xlstm-125m"):
        model = build_model(reduced_config(get_config(arch)), device="cpu")
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            model.loss({})


# --------------------------------------------------------------- optimizer

def test_lr_schedule_matches_jax():
    ocfg = dict(peak_lr=3e-4, warmup_steps=10, total_steps=50,
                min_lr_frac=0.1)
    ours = optim.AdamWConfig(**ocfg)
    ref = joptim.AdamWConfig(**ocfg)
    assert optim.lr_schedule(ours, 0) == 0.0
    for step in range(0, 60):
        np.testing.assert_allclose(
            optim.lr_schedule(ours, step),
            float(joptim.lr_schedule(ref, jnp.int32(step))), rtol=1e-6,
            err_msg=str(step))


def _mixed_tree(rng):
    """bf16 matmul-like leaves and an f32 norm-like leaf."""
    return {"w": (rng.standard_normal((8, 16)) * 0.1).astype(np.float32),
            "e": (rng.standard_normal((32, 8)) * 0.02).astype(np.float32),
            "n": np.ones(16, np.float32)}


@pytest.mark.parametrize("use_master", [True, False])
@pytest.mark.parametrize("n_steps", [1, 5])
def test_optim_apply_matches_jax(n_steps, use_master):
    rng = np.random.default_rng(1)
    tree = _mixed_tree(rng)
    bf16 = ("w", "e")
    jparams = {k: jnp.asarray(v, jnp.bfloat16 if k in bf16 else jnp.float32)
               for k, v in tree.items()}
    tparams = {k: to_tensor(np.asarray(a)) for k, a in jparams.items()}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5,
              use_master=use_master)
    jcfg, tcfg = joptim.AdamWConfig(**kw), optim.AdamWConfig(**kw)
    jstate, tstate = joptim.init(jcfg, jparams), optim.init(tcfg, tparams)
    for _ in range(n_steps):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                 for k, v in tree.items()}
        jparams, jstate, jm = joptim.apply(
            jcfg, jparams, {k: jnp.asarray(g) for k, g in grads.items()},
            jstate)
        tparams, tstate, tm = optim.apply(
            tcfg, tparams, {k: torch.from_numpy(g) for k, g in grads.items()},
            tstate)
        np.testing.assert_allclose(tm["grad_norm"].item(),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(tm["lr"], float(jm["lr"]), rtol=1e-6)
    assert tstate.step == int(jstate.step) == n_steps
    def close(ours, ref, k):
        """1e-6 relative to the leaf's scale: an update that cancels a
        weight to near 0 keeps the update's absolute rounding."""
        ref = np.asarray(ref).astype(np.float32)
        np.testing.assert_allclose(ours.float().numpy(), ref, err_msg=k,
                                   rtol=1e-6, atol=1e-6 * np.abs(ref).max())

    for k in tree:
        close(tstate.mu[k], jstate.mu[k], k)
        close(tstate.nu[k], jstate.nu[k], k)
        if use_master:
            close(tstate.master[k], jstate.master[k], k)
            # params are the masters in storage dtype, exactly
            assert torch.equal(tparams[k],
                               tstate.master[k].to(tparams[k].dtype))
        assert tparams[k].dtype == to_tensor(np.asarray(jparams[k])).dtype
        if k in bf16:   # one bf16 rounding of masters 1e-6 apart
            np.testing.assert_allclose(
                tparams[k].float().numpy(),
                np.asarray(jparams[k]).astype(np.float32), err_msg=k,
                rtol=2 ** -8)
        else:
            close(tparams[k], jparams[k], k)
    assert tstate.master is None or use_master


def test_masters_do_not_alias_params():
    rng = np.random.default_rng(2)
    tparams = {k: torch.from_numpy(v) for k, v in _mixed_tree(rng).items()}
    tparams["w"] = tparams["w"].bfloat16()
    ocfg = optim.AdamWConfig()
    state = optim.init(ocfg, tparams)
    grads = {k: torch.ones_like(v, dtype=torch.float32)
             for k, v in tparams.items()}
    new, state2, _ = optim.apply(ocfg, tparams, grads, state)
    for k in tparams:
        assert state.master[k].data_ptr() != tparams[k].data_ptr(), k
        assert state2.master[k].data_ptr() != new[k].data_ptr(), k
        assert state.mu[k].data_ptr() != state.nu[k].data_ptr(), k
    # apply updates what it was given in place (the reference's donated
    # step) and counts the step in the new state only
    assert new is tparams and state2.mu is state.mu
    ptrs = {k: v.data_ptr() for k, v in tparams.items()}
    assert {k: v.data_ptr() for k, v in new.items()} == ptrs
    assert state.step == 0 and state2.step == 1
    assert float(state.mu["n"].abs().sum()) > 0.0


# ---------------------------------------------------- loss-and-grad, step

def _jax_loss_and_grad(jmodel, params, batch, dtype):
    jl, jg = jax.jit(jtrain.make_loss_and_grad(jmodel, accum=2))(
        _cast(params, dtype), {k: jnp.asarray(v) for k, v in batch.items()})
    return float(jl), _jax_grads_by_name(jg)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_loss_and_grad_matches_jax(jax_side, dtype):
    """f32: within 1e-4.  bf16: within the reference's bf16 bound (rtol
    2e-2, atol 1e-3) on every leaf but the embedding.  There the rows of
    frequent tokens sum many bf16-rounded contributions, and the reference's
    own bf16 gradient lies up to 2.1e-3 from its f32 one (so does the
    port's), more than that atol: the embedding's atol is the reference's
    own largest bf16-vs-f32 deviation on it.  On every leaf the port's bf16
    gradient must lie no further (by norm, 1.5x) from the common f32
    gradient than the reference's does: an accumulation rounded to bf16
    would not."""
    jdt, tdt = DTYPES[dtype]
    cfg, jmodel, params = jax_side
    batch = _corpus_batches(cfg.vocab_size, 1)[0]
    jl, jg = _jax_loss_and_grad(jmodel, params, batch, jdt)
    model = _port(_cast(params, jdt), tdt)
    tl, tg = train.make_loss_and_grad(model, accum=2)(_state(model),
                                                      _torch_batch(batch))
    assert all(g.dtype == torch.float32 for g in tg.values())
    if dtype == "f32":
        np.testing.assert_allclose(tl.item(), jl, rtol=1e-5)
        _close_trees(tg, jg, **F32_MODEL)
        return
    np.testing.assert_allclose(tl.item(), jl, rtol=2e-3)
    _, g32 = _jax_loss_and_grad(jmodel, params, batch, jnp.float32)
    for n, ref in jg.items():
        ours = tg[n].numpy()
        ref_dev = np.abs(ref - g32[n]).max()
        atol = max(1e-3, ref_dev) if n == "embed" else 1e-3
        np.testing.assert_allclose(ours, ref, rtol=2e-2, atol=atol,
                                   err_msg=n)
        assert np.linalg.norm(ours - g32[n]) <= \
            1.5 * np.linalg.norm(ref - g32[n]), n


def test_grad_accumulation_invariance(jax_side):
    """accum 1 and 4 give the same loss and gradients, within the
    reference's bounds (bf16 forward, other reduction orders)."""
    cfg, _, params = jax_side
    model = _port(params, torch.bfloat16)
    batch = _torch_batch(_corpus_batches(cfg.vocab_size, 1, batch=8)[0])
    l1, g1 = train.make_loss_and_grad(model, accum=1)(_state(model), batch)
    l4, g4 = train.make_loss_and_grad(model, accum=4)(_state(model), batch)
    np.testing.assert_allclose(l1.item(), l4.item(), rtol=2e-5)
    for n in g1:
        np.testing.assert_allclose(g1[n].numpy(), g4[n].numpy(), err_msg=n,
                                   **BF16_MODEL)


def test_remat_gives_the_same_gradients_bitwise(jax_side):
    cfg, _, params = jax_side
    batch = _torch_batch(_corpus_batches(cfg.vocab_size, 1)[0])
    out = []
    for remat in (True, False):
        model = _port(params, torch.bfloat16, remat=remat)
        out.append(train.make_loss_and_grad(model, accum=2)(_state(model),
                                                            batch))
    (la, ga), (lb, gb) = out
    assert torch.equal(la, lb)
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n


def test_remat_recomputes_each_layer_under_grad_only(jax_side, monkeypatch):
    """With remat the backward runs each layer's forward again; under
    no_grad (serving) a layer runs once."""
    from repro_torch.models import transformer as T
    cfg, _, params = jax_side
    calls = []
    inner = T.layer_apply
    monkeypatch.setattr(T, "layer_apply",
                        lambda *a, **k: calls.append(1) or inner(*a, **k))
    model = _port(params, torch.bfloat16)
    batch = _torch_batch(_corpus_batches(cfg.vocab_size, 1)[0])
    train.make_loss_and_grad(model, accum=1)(_state(model), batch)
    assert len(calls) == 2 * cfg.n_layers
    calls.clear()
    with torch.no_grad():
        model.forward_logits(batch["tokens"])
    assert len(calls) == cfg.n_layers


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_train_curve_matches_jax(jax_side, dtype):
    """10 steps of the port's step against the reference's jitted
    single-device step: loss and grad norm each step."""
    jdt, tdt = DTYPES[dtype]
    cfg, jmodel, params = jax_side
    # copies: the jitted step donates its params
    params = jax.tree.map(jnp.copy, _cast(params, jdt))
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jstep = jtrain.make_jitted_train_step(jmodel, joptim.AdamWConfig(**kw),
                                          accum=2, rules=None)
    model = _port(params, tdt)
    tcfg = optim.AdamWConfig(**kw)
    tstep = train.make_train_step(model, tcfg, accum=2, device="cpu")
    tparams = _state(model)
    tstate = optim.init(tcfg, tparams)
    jstate = joptim.init(joptim.AdamWConfig(**kw), params)
    jl, jn, tl, tn = [], [], [], []
    for b in _corpus_batches(cfg.vocab_size, 10):
        params, jstate, jm = jstep(params, jstate,
                                   {k: jnp.asarray(v) for k, v in b.items()})
        tparams, tstate, tm = tstep(tparams, tstate, _torch_batch(b))
        jl.append(float(jm["loss"]))
        jn.append(float(jm["grad_norm"]))
        tl.append(tm["loss"].item())
        tn.append(tm["grad_norm"].item())
    rtol = 1e-4 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    np.testing.assert_allclose(tn, jn, rtol=rtol)
    assert tl[-1] < tl[0]


def test_unknown_cross_pod_mode_is_refused():
    model = build_model(reduced_config(get_config(ARCH)), device="cpu")
    with pytest.raises(ValueError, match="unknown cross_pod_mode 'ring'"):
        train.make_train_step(model, optim.AdamWConfig(), device="cpu",
                              cross_pod_mode="ring")


# --------------------------------------------------- data, elastic, loop

@pytest.mark.parametrize("n_shards", [1, 2])
def test_corpus_batches_bitwise(n_shards):
    kw = dict(vocab_size=1000, seq_len=64, global_batch=4, seed=7)
    for shard in range(n_shards):
        ours = data.SyntheticCorpus(data.DataConfig(**kw), shard=shard,
                                    n_shards=n_shards)
        ref = jdata.SyntheticCorpus(jdata.DataConfig(**kw), shard=shard,
                                    n_shards=n_shards)
        for step in (0, 1, 17):
            a, b = ours.batch(step), ref.batch(step)
            for k in ("tokens", "targets"):
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_matches_reference():
    kw = dict(vocab_size=500, seq_len=16, global_batch=2)
    ours = data.Prefetcher(data.SyntheticCorpus(data.DataConfig(**kw)),
                           start_step=3)
    ref = jdata.Prefetcher(jdata.SyntheticCorpus(jdata.DataConfig(**kw)),
                           start_step=3)
    try:
        for _ in range(4):
            (sa, a), (sb, b) = ours.next(), ref.next()
            assert sa == sb
            np.testing.assert_array_equal(a["tokens"], b["tokens"])
    finally:
        ours.close()
        ref.close()
    assert not ours._thread.is_alive()


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(3)
    times = list(0.1 + 0.002 * rng.standard_normal(40))
    times[12] = times[30] = 0.5
    ours, ref = elastic.StragglerDetector(), jelastic.StragglerDetector()
    assert ours.summary() == ref.summary()
    for dt in times:
        assert ours.record(dt) == ref.record(dt)
    assert ours.flagged == ref.flagged == [12, 30]
    assert ours.summary() == ref.summary()


def test_heartbeat_monitor_matches_reference():
    ours = elastic.HeartbeatMonitor(timeout_s=5.0)
    ref = jelastic.HeartbeatMonitor(timeout_s=5.0)
    for mon in (ours, ref):
        mon.beat(0, t=100.0)
        mon.beat(1, t=103.0)
        mon.beat(2, t=96.0)
    for now in (101.0, 104.0, 108.5, 120.0):
        assert ours.dead_workers(now) == ref.dead_workers(now)
    assert ours.dead_workers(104.0) == [2]


class _F32Model:
    """The reference model with f32 matmul weights from its init, so the
    reference's Trainer runs in f32."""

    def __init__(self, model):
        self.model = model

    def init(self, key):
        return _cast(self.model.init(key), jnp.float32)

    def loss(self, params, batch):
        return self.model.loss(params, batch)


def test_trainer_history_matches_reference(tmp_path, jax_side):
    cfg, jmodel, _ = jax_side
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=6)
    dcfg = dict(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    ref = jtrain.Trainer(
        _F32Model(jmodel), joptim.AdamWConfig(**kw),
        jtrain.TrainerConfig(n_steps=6, ckpt_every=1000, log_every=2,
                             accum=2, ckpt_dir=str(tmp_path)),
        jdata.DataConfig(**dcfg)).run(seed=0, resume=False)
    model = _port(jmodel.init(jax.random.key(0)), torch.float32)
    ours = train.Trainer(
        model, optim.AdamWConfig(**kw),
        train.TrainerConfig(n_steps=6, log_every=2, accum=2,
                            ckpt_dir=str(tmp_path / "port")),
        data.DataConfig(**dcfg), device="cpu").run(seed=None, resume=False)
    assert [h["step"] for h in ours["history"]] == [0, 2, 4]
    assert [h["step"] for h in ref["history"]] == [0, 2, 4]
    np.testing.assert_allclose([h["loss"] for h in ours["history"]],
                               [h["loss"] for h in ref["history"]],
                               rtol=1e-4)
    assert ours["stragglers"]["steps"] == 6
    assert ours["opt_state"].step == 6 and ours["recovery"] is None


def test_launcher_trains_on_the_cpu(capsys):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--steps", "3", "--batch", "4", "--seq", "32"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("step    0  loss ")
    assert lines[0].endswith(" ms")


def test_train_entry_points_without_device_raise_without_card(monkeypatch):
    """The launcher, the step and the Trainer run on the card unless asked
    for the CPU; a model on the CPU is refused without ``device="cpu"``."""
    from repro_torch.launch.train import main
    model = build_model(reduced_config(get_config(ARCH)), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.make_train_step(model, optim.AdamWConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.Trainer(model, optim.AdamWConfig(), train.TrainerConfig(),
                      data.DataConfig(vocab_size=512, seq_len=16,
                                      global_batch=2))


# --------------------------------------- the kernels' plain backward

def _vjp_close(ours, ref, dtype):
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "f32" else \
        dict(rtol=2e-2, atol=2e-2)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b).astype(np.float32), **tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("R,D", [(64, 128), (100, 96)])
def test_rmsnorm_backward_ref_matches_jax_vjp(R, D, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((R, D)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    g = rng.standard_normal((R, D)).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    _, vjp = jax.vjp(lambda a, b: JL.rmsnorm(a, b), jx, jnp.asarray(w))
    ref = vjp(jnp.asarray(g, jdt))
    tx = to_tensor(np.asarray(jx))
    ours = rmsnorm_backward_ref(tx, torch.from_numpy(w),
                                to_tensor(np.asarray(jnp.asarray(g, jdt))))
    assert ours[0].dtype == tdt and ours[1].dtype == torch.float32
    _vjp_close(ours, ref, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("H,Kv,softcap", [(4, 2, 0.0), (4, 4, 20.0)])
def test_attention_backward_ref_matches_jax_vjp(H, Kv, softcap, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(5)
    B, S, D = 2, 16, 32
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np.float32)
               for h in (H, Kv, Kv))
    g = rng.standard_normal((B, S, H, D)).astype(np.float32)
    jq, jk, jv, jgv = (jnp.asarray(a, jdt) for a in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: JL.full_attention(
        a, b, c, causal=True, softcap=softcap), jq, jk, jv)
    ref = vjp(jgv)
    tq, tk, tv, tg = (to_tensor(np.asarray(a)) for a in (jq, jk, jv, jgv))
    ours = attention_backward_ref(tq, tk, tv, tg, causal=True,
                                  softcap=softcap)
    assert all(o.dtype == tdt for o in ours)
    _vjp_close(ours, ref, dtype)


class _FakeExtension:
    """The extension's entry points as the plain versions, so the
    autograd Functions' plumbing runs on the CPU."""

    @staticmethod
    def rmsnorm(x, w, eps):
        return rmsnorm_ref(x, w, eps)

    @staticmethod
    def flash_attention(q, k, v, causal, softcap):
        return attention_ref(q, k, v, causal=causal, softcap=softcap)


def _grads(fn, *inputs):
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    g = torch.from_numpy(np.random.default_rng(6).standard_normal(
        out.shape).astype(np.float32)).to(out.dtype)
    return out, torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("kernel", ["rmsnorm", "flash_attention"])
def test_autograd_functions_match_the_plain_gradient(kernel, monkeypatch):
    """The Functions the card runs under autograd (forward: the kernel,
    stood in for here by the plain version; backward: the plain
    gradient) give the plain version's output and input gradients bitwise,
    and count one launch per forward."""
    monkeypatch.setattr(rms_ops, "extension", _FakeExtension)
    monkeypatch.setattr(fa_ops, "extension", _FakeExtension)
    rng = np.random.default_rng(7)
    if kernel == "rmsnorm":
        x = torch.from_numpy(rng.standard_normal((8, 64)).astype(
            np.float32)).bfloat16()
        w = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
        counter, inputs = rms_ops.RMSNORM, (x, w)
        fn = lambda a, b: rms_ops.RMSNormFn.apply(a, b, 1e-5)  # noqa: E731
        plain = lambda a, b: rmsnorm_ref(a, b, 1e-5)  # noqa: E731
    else:
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (2, 16, h, 32)).astype(np.float32)).bfloat16()
            for h in (4, 2, 2))
        counter, inputs = fa_ops.FLASH_ATTENTION, (q, k, v)
        fn = lambda a, b, c: fa_ops.FlashAttentionFn.apply(  # noqa: E731
            a, b, c, True, 0.0)
        plain = lambda a, b, c: attention_ref(a, b, c)  # noqa: E731
    before = counter.launches
    out, grads = _grads(fn, *inputs)
    assert counter.launches == before + 1
    assert out.grad_fn is not None
    ref, ref_grads = _grads(plain, *inputs)
    assert torch.equal(out, ref)
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)


def test_logits_function_backward_keeps_bf16_operands():
    """LogitsFn's backward (the card's): the f32 cotangent goes to bf16,
    dx and d(embed) come out bf16, within bf16 rounding of the f32
    product."""
    from repro_torch.models.transformer import LogitsFn
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((6, 16)).astype(
        np.float32)).bfloat16()
    e = torch.from_numpy(rng.standard_normal((40, 16)).astype(
        np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))

    class Ctx:
        saved_tensors = (x, e)

    dx, de = LogitsFn.backward(Ctx, g)
    assert dx.dtype == de.dtype == torch.bfloat16
    np.testing.assert_allclose(dx.float().numpy(),
                               (g @ e.float()).numpy(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(de.float().numpy(),
                               (g.t() @ x.float()).numpy(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("scale", [1e-6, 1.0])
def test_logits_function_backward_against_reference_vjp(scale):
    """LogitsFn's backward against ``jax.vjp`` of the reference's logits
    einsum (``preferred_element_type=f32``) on the same bf16 inputs.  The
    reference takes the f32 cotangent as it is and rounds dx and d(embed)
    to bf16 once; the port rounds the cotangent to bf16 first, a second
    rounding.  Measured (4 seeds): the port lies 2.55e-3 by norm from the
    reference, within one bf16 step (2^-8), and 1.41x (two independent
    roundings: sqrt 2) as far as the reference from the exact product.
    ``scale`` 1e-6 is the loss's cotangent (softmax / tokens); 1 a unit
    one."""
    from repro_torch.models.transformer import LogitsFn
    rng = np.random.default_rng(8)
    N, d, V = 256, 128, 1024
    x = rng.standard_normal((N, d)).astype(np.float32)
    e = (0.02 * rng.standard_normal((V, d))).astype(np.float32)
    g = (scale * rng.standard_normal((N, V))).astype(np.float32)
    xb, eb = (torch.from_numpy(a).bfloat16() for a in (x, e))

    class Ctx:
        saved_tensors = (xb, eb)

    ours = LogitsFn.backward(Ctx, torch.from_numpy(g))
    _, vjp = jax.vjp(
        lambda a, b: jnp.einsum("nd,vd->nv", a, b,
                                preferred_element_type=jnp.float32),
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(e, jnp.bfloat16))
    ref = vjp(jnp.asarray(g))
    gd = g.astype(np.float64)
    exact = (gd @ eb.double().numpy(), gd.T @ xb.double().numpy())

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    for o, r, ex in zip(ours, ref, exact):
        assert o.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        o = o.double().numpy()
        r = np.asarray(r.astype(jnp.float32), np.float64)
        assert rel(o, r) <= 2.0 ** -8
        assert rel(o, ex) <= 1.6 * rel(r, ex)


@pytest.mark.parametrize("kernel", ["ssd", "mlstm"])
def test_cpu_ssd_and_mlstm_stay_differentiable(kernel):
    """K3 and K4 refuse inputs that need grad on the card (they have no
    backward); their CPU path, the plain version, stays differentiable."""
    rng = np.random.default_rng(9)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).requires_grad_()

    if kernel == "ssd":
        from repro_torch.kernels.mamba_scan.ops import ssd
        x, B, C = t(1, 32, 2, 32), t(1, 32, 1, 16), t(1, 32, 1, 16)
        dt = torch.nn.functional.softplus(t(1, 32, 2))
        A = -torch.exp(t(2, scale=0.5))
        y, state = ssd(x, dt, A, B, C, chunk=16)
        inputs = (x, B, C)
    else:
        from repro_torch.kernels.mlstm.ops import mlstm
        q, k, v = t(1, 32, 2, 16), t(1, 32, 2, 16), t(1, 32, 2, 16)
        i_raw, f_raw = t(1, 32, 2), t(1, 32, 2)
        y, (state, _, _) = mlstm(q, k, v, i_raw, f_raw, chunk=16)
        inputs = (q, k, v, i_raw, f_raw)
    (y.square().sum() + state.square().sum()).backward()
    for inp in inputs:
        assert inp.grad is not None and torch.isfinite(inp.grad).all()
        assert inp.grad.abs().sum() > 0


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-1.2b",
                                  "xlstm-125m"])
@pytest.mark.parametrize("remat", [True, False])
def test_build_model_passes_remat_to_every_family(arch, remat):
    """As the reference's ``build_model``, the port's hands ``remat`` to
    every family's model."""
    model = build_model(reduced_config(get_config(arch)), device="cpu",
                        seed=None, remat=remat)
    assert model.remat is remat


def test_build_model_remat_default_matches_reference():
    import inspect
    from repro.models import registry as jreg
    ours = inspect.signature(build_model).parameters["remat"].default
    ref = inspect.signature(jreg.build_model).parameters["remat"].default
    assert ours is ref is True
    assert build_model(reduced_config(get_config(ARCH)), device="cpu").remat


def test_adamw_config_matches_reference():
    assert [f.name for f in dataclasses.fields(optim.AdamWConfig)] == \
        [f.name for f in dataclasses.fields(joptim.AdamWConfig)]
    assert optim.AdamWConfig() == optim.AdamWConfig(
        **dataclasses.asdict(joptim.AdamWConfig()))
