"""Tensor parallelism of the port's dense model over a (data, model) grid
against the JAX package's single-device step on the CPU.

One spawn of 4 gloo ranks (``tests/_torch_ranks.py::tp_ranks``) runs
llama3.2-1b's reduced config in f32 on the (1, 4) and (2, 2) grids
through the port's entry points: ``make_grid_loss_and_grad`` (the ``xla``
step's gradient), two ``make_train_step`` steps, ``make_prefill_step`` and
``make_serve_step``; then the ``Trainer`` on (2, 2), saving and resuming.
Besides the reduced config (4 heads over 4 kv heads) there is one with 2
kv heads on ``model`` 4 (each kv head shared by two ranks) and one with 6
heads over 3 kv heads and ``d_ff`` 150: on ``model`` 4 the drop rule
leaves its heads and ``ff`` whole on every rank, on ``model`` 2 each rank's
3 query heads read two kv heads unevenly.

The oracle is the reference on the same weights (bridged from its
``init``) and the same ``SyntheticCorpus`` batch, accum = data ranks x the
ranks' accum: the body of its single-device ``make_train_step``
(``base_step``: ``make_loss_and_grad``, then ``optim.apply``) as two
programs, so that its gradient is kept, compiled with LLVM's optimizations
off (their compile is the cost at this size), its forward and decode
step.  Bounds: loss and grad norm within the
reference's bound between modes (``rtol=1e-4, atol=1e-5``,
``tests/test_bucketing.py::test_train_modes_equivalent_multidevice``);
every leaf's gradient at each step's reference params within 1e-4 of
the leaf's largest value; params after 2 steps within 1e-4 of each leaf's
largest value but for one element in a thousand (AdamW moves an element
±lr whatever its gradient's size); prefill logits within 1e-4, decode
logits within ``test_torch_model.py``'s f32 decode bound (the KV cache is
bf16 on both sides).  Every rank's params are bitwise equal after every
step.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import optim as joptim
from repro import train as jtrain
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch import optim, train
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import build_model, check_rules, \
    get_config, reduced_config
from repro_torch.parallel.launch import run_ranks
from repro_torch.parallel.mesh import Axis
from repro_torch.sharding import make_rules
from tests import _torch_ranks as R

ARCH = "llama3.2-1b"
CONFIGS = {"base": {}, "shared_kv": dict(n_kv_heads=2),
           "six_heads": dict(n_heads=6, n_kv_heads=3, head_dim=16,
                             d_ff=150)}
# (configuration, grid (data, model), each rank's accum): data x accum = 2
RUNS = [("base", (1, 4), 2), ("base", (2, 2), 1), ("shared_kv", (1, 4), 2),
        ("six_heads", (1, 4), 2), ("six_heads", (2, 2), 1)]
REF_ACCUM = 2
DATA = dict(seq_len=16, global_batch=8)
# no warmup: step 0 updates the params, so step 1 is held after an update
OCFG = dict(peak_lr=1e-3, warmup_steps=0, total_steps=10)
BOUND = dict(rtol=1e-4, atol=1e-5)
LEAF_RTOL = 1e-4
PROMPT = (4, 8)                     # serving batch and cache length
DECODE_STEPS = 3
# tests/test_torch_model.py::test_decode_step_teacher_forced's f32 bound:
# a 1-ulp f32 difference in a new K/V entry can round to the neighbouring
# bf16 value of the cache
DECODE_ATOL = 2e-3
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_COMPILE)


def _names(tree):
    return {n: t.numpy() for n, t in params_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


def _reference(name):
    """The reference's side of one configuration: weights, batches, per
    step loss, grad norm and gradient, params after 2 steps, prefill and
    decode logits."""
    cfg = dataclasses.replace(jax_reduced_config(jax_get_config(ARCH)),
                              **CONFIGS[name])
    model = jax_build_model(cfg, remat=False)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.key(0)))
    corpus = jdata.SyntheticCorpus(jdata.DataConfig(
        vocab_size=cfg.vocab_size, **DATA))
    batches = [corpus.batch(i) for i in range(2)]
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    ocfg = joptim.AdamWConfig(**OCFG)
    lg = _compile(jtrain.make_loss_and_grad(model, accum=REF_ACCUM), params,
                  jb[0])
    st = joptim.init(ocfg, params)
    apply = _compile(lambda p, g, s: joptim.apply(ocfg, p, g, s), params,
                     params, st)
    out = {"cfg": cfg, "weights": _names(params), "batches": batches,
           "loss": [], "grad_norm": [], "grads": [], "step_weights": []}
    p = params
    for b in jb:
        # the body of the reference's make_train_step (base_step), in two
        # programs so that its gradient is kept
        loss, g = lg(p, b)
        out["grads"].append((float(loss), _names(g)))
        out["step_weights"].append(_names(p))
        p, st, m = apply(p, g, st)
        out["loss"].append(float(loss))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["params"] = _names(p)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, PROMPT).astype(np.int32)
    fwd = _compile(lambda pp, t: model.forward_logits(pp, {"tokens": t})[0],
                   params, jnp.asarray(prompt))
    out["prompt"] = prompt
    out["prefill"] = np.asarray(fwd(params, jnp.asarray(prompt)))
    cache = model.init_cache(PROMPT[0], PROMPT[1])
    dec = _compile(model.decode_step, params, cache,
                   jnp.asarray(prompt[:, :1]), jnp.int32(0))
    out["decode"] = []
    for i in range(DECODE_STEPS):
        logits, cache = dec(params, cache, jnp.asarray(prompt[:, i:i + 1]),
                            jnp.int32(i))
        out["decode"].append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def reference():
    return {name: _reference(name) for name in CONFIGS}


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    base = tmp_path_factory.mktemp("tp_trainer")
    configs = {}
    for name, ref in reference.items():
        configs[name] = {
            "cfg": dataclasses.replace(reduced_config(get_config(ARCH)),
                                       **CONFIGS[name]),
            "weights": ref["weights"], "batches": ref["batches"],
            "step_weights": ref["step_weights"],
            "prompt": ref["prompt"], "max_seq": PROMPT[1],
            "decode_steps": DECODE_STEPS}
    spec = {"configs": configs, "runs": RUNS, "ocfg": OCFG,
            "trainer_accum": RUNS[1][2],
            "trainer_data": dict(vocab_size=configs["base"]["cfg"]
                                 .vocab_size, **DATA),
            "ckpt_dir": str(base)}
    return run_ranks(R.tp_ranks, 4, args=(spec,), threads=1,
                     deadline_s=600), spec


RUN_IDS = [f"{c}-{d}x{m}" for c, (d, m), _ in RUNS]


def _coords(out, shape):
    return [r["coords"][shape] for r in out]


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_grid_is_row_major_as_jax_make_mesh(ranks, shape):
    """Rank r of a (D, M) (data, model) grid sits at (r // M, r % M), as
    ``jax.make_mesh`` orders devices: each model group holds the ranks of
    one data index."""
    out, _ = ranks
    M = shape[1]
    assert _coords(out, shape) == [(r // M, r % M) for r in range(4)]


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_steps_match_reference(ranks, reference, run):
    out, _ = ranks
    ref = reference[run[0]]
    for r in out:
        got = r[(run[0], run[1])]
        np.testing.assert_allclose(got["loss"], ref["loss"], **BOUND)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"],
                                   **BOUND)
    assert ref["loss"][1] < ref["loss"][0]


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_every_leaf_gradient_matches_reference(ranks, reference, run, step):
    """Each step's gradient at the reference's params of that step (step 0
    the bridged weights, step 1 after an update), complete on every rank
    after the sum over ``model`` and the mean over ``data``, and the same
    on every rank."""
    out, _ = ranks
    ref_loss, ref_grads = reference[run[0]]["grads"][step]
    first = out[0][(run[0], run[1])]["grads"][step][1]
    for r in out:
        loss, grads = r[(run[0], run[1])]["grads"][step]
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
        assert set(grads) == set(ref_grads)
        for n, want in ref_grads.items():
            np.testing.assert_allclose(
                grads[n], want, rtol=LEAF_RTOL,
                atol=LEAF_RTOL * np.abs(want).max(), err_msg=n)
            np.testing.assert_array_equal(grads[n], first[n])


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_params_after_two_steps_match_reference(ranks, reference, run):
    """Within 1e-4 of each leaf's largest value, but for at most one
    element in a thousand, each within the two updates' size: AdamW moves
    an element ±lr whatever its gradient's size, so one whose tiny
    gradient two orders of summation round to opposite signs ends up to
    2·lr a step apart."""
    out, _ = ranks
    ref = reference[run[0]]
    got = out[0][(run[0], run[1])]["params"]
    lr = OCFG["peak_lr"]
    for n, want in ref["params"].items():
        diff = np.abs(got[n] - want)
        off = diff > LEAF_RTOL * np.abs(want).max()
        assert off.mean() <= 1e-3 and diff.max() <= 4 * lr + 1e-6, \
            (n, off.sum(), diff.max())
        assert np.abs(want - ref["weights"][n]).max() > 0.5 * lr, n


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_every_rank_holds_the_same_params_every_step(ranks, run):
    out, _ = ranks
    first = out[0][(run[0], run[1])]
    for r in out[1:]:
        assert r[(run[0], run[1])]["digests"] == first["digests"]
        assert r[(run[0], run[1])]["loss"] == first["loss"]
    assert len(set(first["digests"])) == len(first["digests"])


def _block(a, coords, shape, batch_axis=0):
    """The rank's block of a global (B, ..., V) array: rows over data,
    vocab columns over model."""
    (d, m), (D, M) = coords, shape
    b, v = a.shape[batch_axis] // D, a.shape[-1] // M
    return a[d * b:(d + 1) * b, ..., m * v:(m + 1) * v]


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_prefill_and_decode_blocks_match_reference(ranks, reference, run):
    out, _ = ranks
    ref = reference[run[0]]
    for r, coords in zip(out, _coords(out, run[1])):
        got = r[(run[0], run[1])]
        want = _block(ref["prefill"], coords, run[1])
        assert got["prefill"].shape == want.shape
        np.testing.assert_allclose(got["prefill"], want, rtol=1e-4,
                                   atol=1e-4)
        for i in range(DECODE_STEPS):
            want = _block(ref["decode"][i], coords, run[1])
            assert got["decode"][i].shape == want.shape
            np.testing.assert_allclose(got["decode"][i], want, rtol=0,
                                       atol=DECODE_ATOL,
                                       err_msg=f"decode {i}")


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_each_rank_computes_its_share(ranks, run):
    """The heads reaching the attention core, the MLP's gated width and
    the logits' columns: a 1/M share where the rules split them, whole
    where the drop rule keeps them whole."""
    out, spec = ranks
    cfg = spec["configs"][run[0]]["cfg"]
    M = run[1][1]
    H, Kv, ff, V = cfg.n_heads, cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size
    G = H // Kv
    for r, coords in zip(out, _coords(out, run[1])):
        got = r[(run[0], run[1])]
        if H % M == 0:
            hl = H // M
            lo, hi = coords[1] * hl, (coords[1] + 1) * hl
            k0, k1 = lo // G, (hi - 1) // G + 1
            # the kv heads its query heads read, or one a query head where
            # they read them unevenly
            even = k1 - k0 == 1 or (lo % G == 0 and hi % G == 0)
            want = (hl, k1 - k0 if even else hl)
        else:
            want = (H, Kv)
        assert got["attention"] == [want], got["attention"]
        assert got["ff"] == [ff // M if ff % M == 0 else ff]
        assert got["prefill"].shape[-1] == V // M


def test_trainer_on_grid_saves_and_resumes(ranks):
    """The Trainer on (2, 2), as ``launch/train.py --data-parallel 2
    --model-parallel 2`` runs it: a run saves step 1, a second resumes it
    to step 2, bitwise the base configuration's two ``make_train_step``
    steps on that grid (the same batches); each leaf of the checkpoint is
    written once and reads back, on one rank, as the grid's params."""
    from repro_torch import ckpt
    from repro_torch.ckpt.manifest import read_manifest
    from repro_torch.ckpt.state import restore_policy, state_from_tree, \
        state_tree
    out, spec = ranks
    for r in out:
        steps, t = r[("base", (2, 2))], r["trainer"]
        assert t["saved"]["loss"] + t["resumed"]["loss"] == steps["loss"]
        assert t["saved"]["digest"] == steps["digests"][0]
        assert t["resumed"]["digest"] == steps["digests"][1]
    sdir = ckpt.step_dir(spec["ckpt_dir"], 1)
    man = read_manifest(sdir)
    assert {e.kind for e in man.leaves.values()} == {"replicated"}
    assert man.mesh == {"axis_names": ["data", "model"], "shape": [2, 2]}
    model = build_model(spec["configs"]["base"]["cfg"], device="cpu", seed=0,
                        dtype=torch.float32, remat=False)
    params, state = train.init_train_state(model, optim.AdamWConfig(**OCFG),
                                           seed=0)
    template = state_tree(params, state)
    step, tree = ckpt.restore_auto(sdir, template,
                                   policy=restore_policy(template))
    params, state = state_from_tree(tree, order=list(params))
    assert step == 1 and state.step == 1
    for n, p in params.items():
        np.testing.assert_array_equal(p.numpy(),
                                      out[0]["trainer"]["saved"]["params"][n])


# ------------------------------------------------------------ refusals

class _Grid:
    """A grid's shape and this rank's axes, without a job."""

    def __init__(self, shape, names):
        self.shape, self.axis_names = dict(zip(names, shape)), names
        self.member = True

    def axis(self, name):
        if name not in self.shape:
            return None
        return Axis(name, self.shape[name], 0, None)


@pytest.mark.parametrize("mode", ["hier", "hier_bucketed",
                                  "hier_bucketed_zero1"])
def test_manual_sync_modes_refuse_a_model_axis(mode):
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        seed=0, remat=False)
    with pytest.raises(ValueError, match="non-trivial axes"):
        train.make_train_step(model, optim.AdamWConfig(), device="cpu",
                              grid=_Grid((2, 2), ("data", "model")),
                              cross_pod_mode=mode)


@pytest.mark.parametrize("names", [("data", "replica"),
                                   ("pod", "data", "expert_group")])
def test_a_grid_axis_no_rule_maps_is_refused(names):
    """A grid axis that the rules map neither the batch nor a layer to
    would have every rank along it compute the same: the ``xla`` step and
    the serving steps refuse it."""
    from repro_torch.serve import make_prefill_step, make_serve_step
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        seed=0, remat=False)
    grid = _Grid((2,) * len(names), names)
    with pytest.raises(ValueError, match=names[-1]):
        train.make_train_step(model, optim.AdamWConfig(), device="cpu",
                              grid=grid)
    for make in (make_prefill_step, make_serve_step):
        with pytest.raises(ValueError, match=names[-1]):
            make(model, device="cpu", grid=grid)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-125m"])
def test_tensor_parallelism_of_other_families_is_refused(arch):
    from repro_torch.launch.train import parse_args
    from repro_torch.serve import make_prefill_step
    model = build_model(reduced_config(get_config(arch)), device="cpu",
                        seed=0, remat=False)
    grid = _Grid((1, 4), ("data", "model"))
    with pytest.raises(NotImplementedError, match="item 15"):
        train.make_train_step(model, optim.AdamWConfig(), device="cpu",
                              grid=grid)
    with pytest.raises(NotImplementedError, match="item 15"):
        make_prefill_step(model, device="cpu", grid=grid)
    with pytest.raises(SystemExit):
        parse_args(["--arch", arch, "--data-parallel", "1",
                    "--model-parallel", "2"])
    # a grid without a model axis leaves them as they were
    assert make_rules(_Grid((4,), ("data",))).rules["heads"] is None


@pytest.mark.parametrize("argv", [
    ["--model-parallel", "2"],
    ["--data-parallel", "2", "--model-parallel", "2", "--cross-pod-mode",
     "hier_bucketed"],
    ["--data-parallel", "2", "--model-parallel", "2", "--reconfig-at",
     "1:2x2"],
])
def test_launcher_refuses(argv):
    from repro_torch.launch.train import parse_args
    with pytest.raises(SystemExit):
        parse_args(argv)


def test_launcher_model_parallel_on_the_cpu(capsys, tmp_path):
    """``--data-parallel 2 --model-parallel 2`` spawns 4 ranks on a
    (data, model) grid (its Trainer's save and resume on that grid:
    ``test_trainer_on_grid_saves_and_resumes``): its losses are the single
    rank's on the same global batches, bf16 rounding apart."""
    from repro_torch.launch.train import main
    common = ["--device", "cpu", "--seq", "16", "--steps", "2",
              "--no-resume", "--ckpt-dir", str(tmp_path)]
    main(common + ["--data-parallel", "2", "--model-parallel", "2"])
    main(common)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(ln.startswith("step    0")
                                   for ln in lines), lines
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines]
    assert abs(losses[0] - losses[1]) < 1e-2, losses


@pytest.mark.parametrize("flags,item", [(dict(seq_parallel=True), "item 16")])
def test_rules_that_split_the_sequence_are_refused(flags, item):
    """No model of the port splits ``seq`` yet: rules that do are refused
    rather than run whole on every rank.  (``kv_seq``, split by
    ``seq_shard`` and ``long_ctx``, is the decode cache's:
    ``tests/test_torch_seq_decode.py``.)"""
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        seed=0, remat=False)
    rules = make_rules(_Grid((2, 2), ("data", "model")), **flags)
    with pytest.raises(NotImplementedError, match=item):
        check_rules(model, rules)


@pytest.mark.parametrize("flags,shape,error,match", [
    (dict(long_ctx=True), (4, 1), ValueError, "grid axes"),
    (dict(seq_shard=True), (1, 4), NotImplementedError, "item 15")])
def test_xlstm_decode_under_sequence_rules_is_refused(flags, shape, error,
                                                      match):
    """The xLSTM has no KV cache: under ``long_ctx`` no rule it reads maps
    to the data axis, so every rank along it would compute the same; under
    ``seq_shard`` on a ``model`` axis its tensor parallelism is not
    ported."""
    from repro_torch.serve import make_serve_step
    model = build_model(reduced_config(get_config("xlstm-125m")),
                        device="cpu", seed=0, remat=False)
    with pytest.raises(error, match=match):
        make_serve_step(model, device="cpu",
                        grid=_Grid(shape, ("data", "model")), **flags)


@pytest.mark.parametrize("step", ["serve"])
def test_hybrid_under_seq_shard_on_a_model_axis_is_refused(step):
    """``seq_shard`` splits the hybrid's heads over ``model`` beside its
    cache's sequence: its tensor parallelism is not ported."""
    from repro_torch.serve import make_serve_step
    model = build_model(reduced_config(get_config("zamba2-1.2b")),
                        device="cpu", seed=0, remat=False)
    with pytest.raises(NotImplementedError, match="item 15"):
        make_serve_step(model, device="cpu",
                        grid=_Grid((1, 4), ("data", "model")),
                        seq_shard=True)


@pytest.mark.parametrize("flags,shape", [(dict(seq_shard=True), (1, 4)),
                                         (dict(long_ctx=True), (2, 2))])
def test_a_split_cache_without_its_global_length_is_refused(flags, shape):
    """Under rules that split ``kv_seq`` a rank's cache carries its global
    length (``init_cache`` under the rules records it).  A cache of 6
    positions without it, a slice of 24 on 4 ranks or a whole cache the
    drop rule would keep whole, is refused rather than read as positions
    0..5 on every rank."""
    from repro_torch.serve import make_serve_step
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        seed=0, remat=False)
    step = make_serve_step(model, device="cpu",
                           grid=_Grid(shape, ("data", "model")), **flags)
    cache = model.init_cache(2, 6)
    with pytest.raises(ValueError, match="global length"):
        step(cache, torch.zeros((2, 1), dtype=torch.long), 3)
