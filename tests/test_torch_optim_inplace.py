"""AdamW updates its state in place, as the reference's donated step
(``repro/train.py``, ``donate_argnums=(0, 1)``) reuses its buffers.

``optim.apply`` and ``optim.apply_flat`` write the moments, the f32
masters and the params into their own storage and return the tensors
they were given (checked by ``data_ptr``).  The results are bit for bit
those of the functional update the port had before (kept here as
``functional_apply`` / ``functional_apply_flat``): with masters and
without, bf16 and f32 leaves, flat buckets, and the bucketed train steps
with int8 error feedback (an ``EFState``).  A checkpoint issued before an
update, async or not, holds the state from before it: its host copy is
taken before the save returns.
"""
import numpy as np
import pytest
import torch

from repro_torch import ckpt, optim, train
from repro_torch import checkpoint as legacy_ckpt
from repro_torch.ckpt.state import state_from_tree, state_tree
from repro_torch.data import DataConfig, SyntheticCorpus
from repro_torch.models.registry import build_model, get_config, \
    reduced_config


# ------------------------------------------ the functional update, kept

def _functional_update(cfg, g, m, v, base, *, lr, b1c, b2c, scale):
    g = g.float() * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g.square()
    mh = m / b1c
    vh = v / b2c
    new_w = base - lr * (mh / (vh.sqrt() + cfg.eps)
                         + cfg.weight_decay * base)
    return m, v, new_w


@torch.no_grad()
def functional_apply(cfg, params, grads, state, *, gnorm=None):
    if gnorm is None:
        gnorm = optim.global_norm(grads)
    scale = optim._clip_scale(cfg, gnorm)
    lr, b1c, b2c = optim._step_scalars(cfg, state.step)
    new_params, mu, nu, master = {}, {}, {}, {}
    for n, p in params.items():
        base = state.master[n] if state.master is not None else p.float()
        mu[n], nu[n], new_w = _functional_update(
            cfg, grads[n], state.mu[n], state.nu[n], base, lr=lr, b1c=b1c,
            b2c=b2c, scale=scale)
        new_params[n] = new_w.to(p.dtype, copy=True)
        master[n] = new_w
    return new_params, optim.OptState(
        state.step + 1, mu, nu,
        master if state.master is not None else None), {"lr": lr,
                                                        "grad_norm": gnorm}


@torch.no_grad()
def functional_apply_flat(cfg, grads, state, *, gnorm):
    scale = optim._clip_scale(cfg, gnorm)
    lr, b1c, b2c = optim._step_scalars(cfg, state.step)
    mu, nu, master = [], [], []
    for g, m, v, w in zip(grads, state.mu, state.nu, state.master):
        m, v, new_w = _functional_update(cfg, g, m, v, w, lr=lr, b1c=b1c,
                                         b2c=b2c, scale=scale)
        mu.append(m)
        nu.append(v)
        master.append(new_w)
    return optim.BucketedOptState(state.step + 1, tuple(mu), tuple(nu),
                                  tuple(master)), {"lr": lr,
                                                   "grad_norm": gnorm}


# ------------------------------------------------------------- helpers

def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so that -0.0 and 0.0 (or two NaNs) differ."""
    t = t.detach().contiguous()
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return []


def assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb) and la
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def _ptrs(tree):
    return [t.data_ptr() for t in _leaves(tree)]


def _tree(rng, dtype):
    return {"w": torch.from_numpy(rng.standard_normal((24, 40))
                                  .astype(np.float32)).to(dtype),
            "b": torch.from_numpy(rng.standard_normal(40)
                                  .astype(np.float32)).to(dtype),
            "n": torch.ones(16, dtype=dtype)}


OCFG = optim.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10)


# ---------------------------------------------------------------- apply

@pytest.mark.parametrize("use_master", [True, False],
                         ids=["masters", "no_masters"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_apply_updates_in_place_bitwise(use_master, dtype):
    rng = np.random.default_rng(0)
    cfg = optim.AdamWConfig(peak_lr=1e-2, warmup_steps=2, total_steps=10,
                            use_master=use_master)
    params = _tree(rng, dtype)
    state = optim.init(cfg, params)
    ref_params, ref_state = optim.clone_state((params, state))
    ptrs = _ptrs((params, state))
    for step in range(5):
        grads = {k: torch.from_numpy(rng.standard_normal(tuple(v.shape))
                                     .astype(np.float32))
                 for k, v in params.items()}
        gnorm = None if step % 2 else optim.global_norm(grads) * 0.5
        got = optim.apply(cfg, params, grads, state, gnorm=gnorm)
        ref = functional_apply(cfg, ref_params, grads, ref_state,
                               gnorm=gnorm)
        assert got[0] is params and _ptrs(got[:2]) == ptrs
        params, state, m = got
        ref_params, ref_state, rm = ref
        assert_bitwise((params, state), (ref_params, ref_state))
        assert state.step == ref_state.step == step + 1
        assert (m["lr"], float(m["grad_norm"])) == \
            (rm["lr"], float(rm["grad_norm"]))
    # the update moved the params, and never through the masters
    assert not torch.equal(params["w"], _tree(np.random.default_rng(0),
                                              dtype)["w"])
    if use_master:
        assert all(state.master[k].data_ptr() != p.data_ptr()
                   for k, p in params.items())


def test_apply_flat_updates_in_place_bitwise():
    rng = np.random.default_rng(1)
    sizes = (64, 128, 40)
    master = tuple(torch.from_numpy(rng.standard_normal(n)
                                    .astype(np.float32)) for n in sizes)
    state = optim.BucketedOptState(
        0, tuple(torch.zeros(n) for n in sizes),
        tuple(torch.zeros(n) for n in sizes), master)
    ref_state = optim.clone_state(state)
    ptrs = _ptrs(state)
    for _ in range(5):
        grads = tuple(torch.from_numpy(rng.standard_normal(n)
                                       .astype(np.float32)) for n in sizes)
        gnorm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        state, m = optim.apply_flat(OCFG, grads, state, gnorm=gnorm)
        ref_state, rm = functional_apply_flat(OCFG, grads, ref_state,
                                              gnorm=gnorm)
        assert _ptrs(state) == ptrs
        assert_bitwise(state, ref_state)
        assert m["lr"] == rm["lr"] and state.step == ref_state.step


def test_clone_state_keeps_a_state_through_a_step():
    rng = np.random.default_rng(2)
    params = _tree(rng, torch.bfloat16)
    state = optim.init(OCFG, params)
    kept = optim.clone_state((params, state))
    assert not set(_ptrs(kept)) & set(_ptrs((params, state)))
    grads = {k: torch.ones(v.shape) for k, v in params.items()}
    for _ in range(3):
        params, state, _ = optim.apply(OCFG, params, grads, state)
    assert kept[1].step == 0 and float(kept[1].mu["w"].abs().sum()) == 0
    assert torch.equal(kept[0]["n"], torch.ones(16, dtype=torch.bfloat16))
    assert isinstance(kept[1], optim.OptState)


# ----------------------------------------- the train steps, with EFState

def _model():
    cfg = reduced_config(get_config("llama3.2-1b"))
    return build_model(cfg, device="cpu", seed=0, remat=False,
                       dtype=torch.float32)


def _batches(model, n):
    corpus = SyntheticCorpus(DataConfig(vocab_size=model.cfg.vocab_size,
                                        seq_len=16, global_batch=4))
    return [train.batch_to(corpus.batch(i), "cpu") for i in range(n)]


@pytest.mark.parametrize("mode", ["hier_bucketed", "hier_bucketed_zero1"])
def test_bucketed_steps_with_error_feedback_in_place(mode, monkeypatch):
    """The step with int8 error feedback (an ``EFState``) keeps every
    param's and every optimizer tensor's storage, and is bitwise the step
    with the functional update."""
    kw = dict(cross_pod_mode=mode, bucket_bytes=16 << 10,
              slow_error_feedback=True)

    def run(functional):
        model = _model()
        params, state = train.init_train_state(model, OCFG, seed=0, **kw)
        step = train.make_train_step(model, OCFG, device="cpu",
                                     slow_compress_bits=8, **kw)
        ptrs = _ptrs((params, state.opt))
        losses = []
        with monkeypatch.context() as mp:
            if functional:
                mp.setattr(optim, "apply", functional_apply)
                mp.setattr(optim, "apply_flat", functional_apply_flat)
            for b in _batches(model, 4):
                params, state, m = step(params, state, b)
                losses.append(m["loss"].item())
        assert isinstance(state, train.EFState)
        return losses, params, state, ptrs

    got_l, got_p, got_s, ptrs = run(False)
    ref_l, ref_p, ref_s, _ = run(True)
    assert _ptrs((got_p, got_s.opt)) == ptrs
    assert got_l == ref_l
    assert_bitwise((got_p, got_s), (ref_p, ref_s))


# --------------------------------------------- a save before an update

@pytest.mark.parametrize("fmt", ["sharded", "gathered"])
@pytest.mark.parametrize("blocking", [False, True], ids=["async", "sync"])
def test_save_before_update_holds_the_old_state(tmp_path, fmt, blocking):
    model = _model()
    params, state = train.init_train_state(model, OCFG, seed=0)
    step = train.make_train_step(model, OCFG, device="cpu")
    batches = _batches(model, 3)
    params, state, _ = step(params, state, batches[0])
    kept = optim.clone_state((params, state))
    sdir = ckpt.step_dir(str(tmp_path), 1)
    tree = state_tree(params, state)
    if fmt == "sharded":
        pending = ckpt.save_sharded(sdir, 1, tree, blocking=blocking)
    else:
        pending = legacy_ckpt.save(sdir, 1, tree, blocking=blocking)
    # the next updates overwrite the tensors the save was given
    for b in batches[1:]:
        params, state, _ = step(params, state, b)
    if pending is not None:
        pending.join()
    assert not torch.equal(params["embed"], kept[0]["embed"])
    _, restored = ckpt.restore_auto(sdir, state_tree(*kept))
    assert_bitwise(state_from_tree(restored, list(params)), kept)
