"""The port's checkpoints against the JAX package's, both formats, on the
CPU.

- **Bytes.**  The same bridged state saved by the reference and by the port
  gives the same file names, byte-identical ``.npy`` files (headers
  included: bf16 as ``'<V2'``) and the same ``manifest.json``, single rank
  (sharded and gathered formats, each optimizer state the Trainer saves)
  and on a (2,2) grid (the reference on 4 fake devices, the port on 4 gloo
  ranks).
- **Cross-framework restore.**  Each package restores the other's
  checkpoints bit for bit; a ZeRO-1 + error-feedback checkpoint the
  reference writes at (2,2) restores on 4 gloo ranks at (2,2), (4,1) and
  (1,4), through PAD_FLAT where the bucket padding differs and ZERO where
  the residuals' shape does.
- **Bitwise resharding.**  A port (2,2) save restored on (4,1) and (1,4)
  continues bitwise against an uninterrupted port run
  (``tests/test_ckpt_reshard.py``'s criterion).
- **Trainer resume**, across frameworks within ``test_torch_train.py``'s
  f32 curve bound, and on a grid bitwise (async sharded and gathered
  saves, the corrupt-step fallback).

One reference subprocess (4 fake devices) and one spawn of 4 gloo ranks
(``tests/_torch_ranks.py::ckpt_ranks``) serve the multi-rank cases.
"""
import io
import json
import os
import zlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as jlegacy
from repro import ckpt as jckpt
from repro import data as jdata
from repro import optim as joptim
from repro import train as jtrain
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch import checkpoint as legacy
from repro_torch import ckpt, data, optim, train
from repro_torch.ckpt import state as S
from repro_torch.ckpt.state import (state_digest, state_from_tree,
                                    state_tree)
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import build_model, get_config, \
    reduced_config
from repro_torch.parallel.launch import run_ranks
from tests import _torch_ranks as R
from tests.conftest import run_multidevice

ARCH = "llama3.2-1b"
SMALL = 64 << 10                    # bucket bytes of a multi-bucket layout
DATA = dict(seq_len=16, global_batch=8)
OCFG = dict(peak_lr=1e-3, warmup_steps=2, total_steps=6)
GRIDS = ((2, 2), (4, 1), (1, 4))


# ------------------------------------------------------------ the bytes

@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "int32",
                                   "scalar"])
def test_npy_bytes_match_numpy_save(tmp_path, dtype):
    rng = np.random.default_rng(0)
    if dtype == "scalar":
        a = np.float32(2.5)
    elif dtype == "int32":
        a = rng.integers(-9, 9, (3, 5)).astype(np.int32)
    else:
        a = rng.standard_normal((4, 6)).astype(
            ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32)
    want = io.BytesIO()
    np.save(want, a)
    host, name = legacy.to_host(torch.from_numpy(
        np.asarray(a).view(np.int16)).view(torch.bfloat16)
        if dtype == "bfloat16" else a)
    assert name == ("float32" if dtype == "scalar" else dtype)
    path = str(tmp_path / "a.npy")
    legacy.write_npy(path, host, name)
    with open(path, "rb") as f:
        assert f.read() == want.getvalue()
    assert legacy.read_npy(path, name).tobytes() == np.asarray(a).tobytes()
    assert legacy.crc32(host) == zlib.crc32(np.asarray(a).tobytes())


def test_treepaths_match_reference():
    from repro.ckpt import treepaths as jt
    from repro_torch.ckpt import treepaths as tt
    tree = ({"b": [1, (2, 3)], "a": {"z": 4, "y": None}},
            joptim.OptState(step=5, mu={"w": 6}, nu={"w": 7}, master=None))
    assert tt.leaf_paths(tree) == jt.leaf_paths(tree)
    flat = {k: f"v{k}" for k in tt.leaf_paths(tree)}
    assert tt.rebuild(tree, flat) == jt.rebuild(tree, flat)
    assert tt.sanitize("[0].a b/c") == jt.sanitize("[0].a b/c")


@pytest.fixture(scope="module")
def bridged():
    """The reference's reduced llama3.2-1b (native dtypes: bf16 matmul
    weights, f32 norms), its params and the port's bridged copy."""
    cfg = jax_reduced_config(jax_get_config(ARCH))
    jmodel = jax_build_model(cfg, remat=False)
    jparams = jmodel.init(jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "dense")
    return cfg, jmodel, jparams, tparams


def _random_like(rng, shape, live=None):
    """Random f32 values, zero past ``live`` (a bucket's padding)."""
    a = rng.standard_normal(shape).astype(np.float32)
    if live is not None:
        a[live:] = 0
    return a


def _states(bridged, mode):
    """The same optimizer state on both sides: the reference's and the
    port's, for the Trainer's modes, moments random."""
    cfg, jmodel, jparams, tparams = bridged
    rng = np.random.default_rng(1)
    if mode == "xla":
        jo = joptim.init(joptim.AdamWConfig(), jparams)
        mu = jax.tree.map(lambda a: _random_like(rng, a.shape), jparams)
        jo = jo._replace(step=jnp.int32(3), mu=mu)
        to = optim.init(optim.AdamWConfig(), tparams)
        to = to._replace(step=3, mu={
            n: t.float() for n, t in params_from_jax(mu).items()})
        return (jparams, jo), (tparams, to)
    layout = jtrain.make_bucket_layout(jparams, None, bucket_bytes=SMALL)
    live = jckpt.bucket_live_sizes(layout)
    jo = joptim.init_bucketed(joptim.AdamWConfig(), jparams, layout)
    nu = tuple(_random_like(rng, c, n)
               for c, n in zip(layout.bucket_sizes, live))
    jo = jo._replace(step=jnp.int32(3), nu=tuple(map(jnp.asarray, nu)))
    tlayout = train.make_bucket_layout(tparams, bucket_bytes=SMALL)
    to = optim.init_bucketed(optim.AdamWConfig(), tparams, tlayout)
    to = to._replace(step=3, nu=tuple(map(torch.from_numpy, nu)))
    if mode == "zero1_ef":
        res = tuple(_random_like(rng, c) for c in layout.bucket_sizes)
        jo = jtrain.EFState(jo, tuple(map(jnp.asarray, res)))
        to = train.EFState(to, tuple(map(torch.from_numpy, res)))
    return (jparams, jo), (tparams, to), layout, tlayout


MODES = ["xla", "zero1", "zero1_ef"]
FORMATS = ["sharded", "gathered"]


# the word index at which (A·i + B) mod (2^31-1), the digest weight's root,
# is 0
_ROOT = (-S._B * pow(S._A, -1, S._M31)) % S._M31


@pytest.mark.parametrize("at", [_ROOT, _ROOT + S._M31, 5],
                         ids=["root", "root_next_period", "other"])
def test_box_digest_sees_a_single_changed_word(at):
    words = torch.arange(1, 9, dtype=torch.int32)
    changed = words.clone()
    changed[3] += 1
    offset = at - 3
    assert S.box_digest(words, offset) != S.box_digest(changed, offset)
    # additive over boxes at their offsets
    halves = S.box_digest(words[:3], offset) + S.box_digest(words[3:],
                                                           offset + 3)
    assert halves % S._P == S.box_digest(words, offset)


@pytest.fixture(scope="module")
def saved(bridged, tmp_path_factory):
    """Each mode's state saved by both packages in both formats."""
    base = tmp_path_factory.mktemp("saved")
    out = {}
    for mode in MODES:
        got = _states(bridged, mode)
        jstate, tstate = got[:2]
        jl, tl = (got[2], got[3]) if mode != "xla" else (None, None)
        for fmt in FORMATS:
            d = {k: str(base / f"{mode}_{fmt}_{k}") for k in ("j", "t")}
            tree = state_tree(*tstate)
            if fmt == "sharded":
                jckpt.save_sharded(d["j"], 3, jstate, layout=jl)
                ckpt.save_sharded(d["t"], 3, tree, layout=tl)
            else:
                jlegacy.save(d["j"], 3, jstate)
                legacy.save(d["t"], 3, tree)
            out[(mode, fmt)] = (d, jstate, tstate)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", MODES)
def test_single_rank_checkpoint_bytes_match_reference(saved, mode, fmt):
    d, _, _ = saved[(mode, fmt)]
    ref, ours = R.files_digest(d["j"]), R.files_digest(d["t"])
    assert sorted(ref) == sorted(ours)
    assert ours == ref
    with open(os.path.join(d["t"], "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 3
    if fmt == "sharded":
        dtypes = {e["dtype"] for e in man["leaves"].values()}
        assert "bfloat16" in dtypes and not any("torch" in t
                                                for t in dtypes)


def _np_leaves(tree):
    return [np.asarray(x).reshape(-1).view(np.uint8)
            for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("mode", MODES)
def test_each_package_restores_the_others_checkpoint(saved, mode, fmt):
    d, jstate, tstate = saved[(mode, fmt)]
    # the port restores the reference's
    tree = state_tree(*tstate)
    step, got = ckpt.restore_auto(d["j"], tree)
    assert step == 3
    assert state_digest(got) == state_digest(tree)
    params, opt = state_from_tree(got, list(tstate[0]))
    assert list(params) == list(tstate[0])
    assert all(torch.equal(params[n], tstate[0][n]) for n in params)
    inner = opt.opt if isinstance(opt, train.EFState) else opt
    assert inner.step == 3
    # the reference restores the port's
    step, back = jckpt.restore_auto(d["t"], jstate)
    assert step == 3
    for a, b in zip(_np_leaves(jstate), _np_leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_layout_mismatch_and_missing_leaf_refused(saved):
    d, _, tstate = saved[("zero1", "sharded")]
    other = train.make_bucket_layout(tstate[0], bucket_bytes=32 << 20)
    with pytest.raises(ckpt.CorruptCheckpointError, match="layout"):
        ckpt.restore_sharded(d["t"], state_tree(*tstate), layout=other)
    params, opt = tstate
    grown = {**params, "extra": torch.zeros(3)}
    tree = (state_tree(grown, opt)[0], state_tree(params, opt)[1])
    with pytest.raises(ckpt.CorruptCheckpointError, match="missing leaf"):
        ckpt.restore_sharded(d["t"], tree)


# --------------------------------------------- the Trainer, cross-framework

class _F32Model:
    """The reference's model with f32 weights (``jax.Array`` in, out)."""

    def __init__(self, model):
        self.model = model

    def init(self, key):
        return jax.tree.map(lambda a: a.astype(jnp.float32),
                            self.model.init(key))

    def loss(self, params, batch):
        return self.model.loss(params, batch)


def _jax_trainer(jmodel, n, ckpt_dir, mode, resume):
    cfg = jax_reduced_config(jax_get_config(ARCH))
    out = jtrain.Trainer(
        _F32Model(jmodel), joptim.AdamWConfig(**OCFG),
        jtrain.TrainerConfig(n_steps=n, ckpt_every=3, log_every=1,
                             accum=2, ckpt_dir=ckpt_dir,
                             cross_pod_mode=mode, bucket_bytes=SMALL,
                             async_ckpt=False),
        jdata.DataConfig(vocab_size=cfg.vocab_size, **DATA)).run(
        seed=0, resume=resume)
    return [h["loss"] for h in out["history"]]


def _port_trainer(jmodel, n, ckpt_dir, mode, resume):
    cfg = reduced_config(get_config(ARCH))
    model = build_model(cfg, device="cpu", seed=None, remat=False,
                        dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.tree.map(
        np.asarray, _F32Model(jmodel).init(jax.random.key(0)))))
    out = train.Trainer(
        model, optim.AdamWConfig(**OCFG),
        train.TrainerConfig(n_steps=n, ckpt_every=3, log_every=1, accum=2,
                            ckpt_dir=ckpt_dir, cross_pod_mode=mode,
                            bucket_bytes=SMALL),
        data.DataConfig(vocab_size=cfg.vocab_size, **DATA),
        device="cpu").run(seed=None, resume=resume)
    return [h["loss"] for h in out["history"]]


@pytest.mark.parametrize("mode", ["xla", "hier_bucketed_zero1"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trainer_resumes_the_other_packages_checkpoint(bridged, tmp_path,
                                                       mode, writer):
    """One package's Trainer saves at step 3, the other's resumes and runs
    to 6: its losses lie on the reference's uninterrupted curve within
    ``test_torch_train.py``'s f32 bound."""
    jmodel = bridged[1]
    curve = _jax_trainer(jmodel, 6, str(tmp_path / "ref"), mode, False)
    d = str(tmp_path / "handoff")
    save, resume = ((_jax_trainer, _port_trainer) if writer == "reference"
                    else (_port_trainer, _jax_trainer))
    first = save(jmodel, 3, d, mode, False)
    assert ckpt.latest_step(d) == 3 and jckpt.latest_step(d) == 3
    rest = resume(jmodel, 6, d, mode, True)
    assert len(first) == 3 and len(rest) == 3
    np.testing.assert_allclose(first + rest, curve, rtol=1e-4)


def test_trainer_failure_hook_and_records(tmp_path):
    cfg = reduced_config(get_config(ARCH))
    model = build_model(cfg, device="cpu", seed=None, remat=False,
                        dtype=torch.float32)
    trainer = train.Trainer(
        model, optim.AdamWConfig(**OCFG),
        train.TrainerConfig(n_steps=6, ckpt_every=2, log_every=1,
                            ckpt_dir=str(tmp_path)),
        data.DataConfig(vocab_size=cfg.vocab_size, **DATA), device="cpu",
        failure_hook=lambda step: step == 5)
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        trainer.run(seed=0)
    # the saves before the failure are committed, the last one joined
    assert ckpt.committed_steps(str(tmp_path)) == [2, 4]
    assert [c["step"] for c in trainer.checkpoints] == [2, 4]
    assert all(c["save_s"] >= c["host_copy_s"] > 0
               for c in trainer.checkpoints)
    again = train.Trainer(
        model, optim.AdamWConfig(**OCFG),
        train.TrainerConfig(n_steps=6, ckpt_every=100, log_every=1,
                            ckpt_dir=str(tmp_path)),
        data.DataConfig(vocab_size=cfg.vocab_size, **DATA),
        device="cpu").run(seed=0)
    assert [h["step"] for h in again["history"]] == [4, 5]
    assert again["recovery"] is None


# --------------------------------------------------- 4 ranks, a (2,2) grid

REF_CODE = """
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import ckpt, optim
from repro.models.registry import get_config, build_model, reduced_config
from repro.train import (EFState, init_sharded_zero1, init_slow_residuals,
                         make_bucket_layout)
spec = json.loads(%(spec)r)
cfg = reduced_config(get_config('llama3.2-1b'))
params = jax.tree.map(lambda a: a.astype(jnp.float32),
                      build_model(cfg, remat=False).init(jax.random.key(0)))
mesh = jax.make_mesh((2, 2), ('pod', 'data'))
rng = np.random.default_rng(2)
for name, det in (('det_ef', True), ('nondet_ef', False)):
    layout = make_bucket_layout(params, mesh, bucket_bytes=spec['bb'],
                                deterministic=det)
    st, sh = init_sharded_zero1(optim.AdamWConfig(), params, layout, mesh)
    live = ckpt.bucket_live_sizes(layout)
    truth = {'step': np.int32(7), 'nb': np.int32(layout.n_buckets)}
    for k in ('mu', 'nu'):
        arrs = []
        for b, (c, n) in enumerate(zip(layout.bucket_sizes, live)):
            a = rng.standard_normal(c).astype(np.float32)
            a[n:] = 0
            arrs.append(a)
            truth[f'{k}{b}'] = a
        st = st._replace(**{k: tuple(jax.device_put(a, s) for a, s in
                                     zip(arrs, getattr(sh, k)))})
    for b, m in enumerate(st.master):
        truth[f'master{b}'] = np.asarray(m)
    st = st._replace(step=jax.device_put(jnp.int32(7), sh.step))
    rshard = NamedSharding(mesh, P(('pod', 'data')))
    res = []
    for b, r in enumerate(init_slow_residuals(params, mesh,
                                              bucket_bytes=spec['bb'],
                                              deterministic=det)):
        a = rng.standard_normal(r.shape).astype(np.float32)
        truth[f'residuals{b}'] = a
        res.append(jax.device_put(a, rshard))
    np.savez(spec['truth'][name], **truth)
    ckpt.save_sharded(spec['dirs'][name], 7, (params, EFState(st, tuple(res))),
                      layout=layout, mesh=mesh)
print('REF_SAVED')
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The reference's (2,2) ZeRO-1 checkpoints (4 fake devices), then one
    spawn of 4 gloo ranks: ``tests/_torch_ranks.py::ckpt_ranks``."""
    base = tmp_path_factory.mktemp("grid")
    names = ("det_ef", "nondet_ef")
    ref = {"bb": SMALL,
           "dirs": {n: str(base / f"ref_{n}" / "step_00000007")
                    for n in names},
           "truth": {n: str(base / f"truth_{n}.npz") for n in names}}
    out = run_multidevice(REF_CODE % dict(spec=json.dumps(ref)),
                          n_devices=4)
    assert "REF_SAVED" in out
    cfg = jax_reduced_config(jax_get_config(ARCH))
    weights = params_from_jax(jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        jax_build_model(cfg, remat=False).init(jax.random.key(0))))
    spec = {"cfg": reduced_config(get_config(ARCH)), "dtype": "float32",
            "weights": {n: t.numpy() for n, t in weights.items()},
            "data": dict(vocab_size=cfg.vocab_size, **DATA), "accum": 1,
            "ocfg": {"a": OCFG}, "bucket_bytes": SMALL,
            "dirs": ref["dirs"], "truth": ref["truth"],
            "port_dirs": {n: str(base / f"port_{n}" / "step_00000007")
                          for n in names},
            "base": str(base / "reshard"),
            "trainer_base": str(base / "trainer")}
    res = run_ranks(R.ckpt_ranks, 4, args=(spec,), deadline_s=400,
                    threads=1)
    return spec, res


def _expected_box(truth_full, live, c_new, parts, index):
    a = np.zeros(c_new, np.float32)
    a[:live] = truth_full[:live]
    n = c_new // parts
    return a[index * n:(index + 1) * n]


@pytest.mark.parametrize("name", ["det_ef", "nondet_ef"])
def test_port_saves_the_references_bytes_on_a_grid(four_ranks, name):
    spec, res = four_ranks
    assert res[0]["saved"][name] == R.files_digest(spec["dirs"][name])


@pytest.mark.parametrize("shape", GRIDS, ids=["22", "41", "14"])
@pytest.mark.parametrize("name", ["det_ef", "nondet_ef"])
def test_reference_zero1_checkpoint_restores_on_gloo_grids(four_ranks,
                                                           name, shape):
    """Every rank's boxes of the masters and moments are the saved
    buckets', re-padded to its grid's alignment (PAD_FLAT); deterministic
    residuals restore exactly, hierarchical ones on another grid are
    re-zeroed (ZERO)."""
    spec, res = four_ranks
    truth = dict(np.load(spec["truth"][name]))
    nb = int(truth["nb"])
    man = jckpt.read_manifest(spec["dirs"][name])
    live = man.layout["live_sizes"]
    det = name.startswith("det")
    for rank in range(4):
        got = res[rank]["restore"][(name, shape)]
        assert got["step"] == 7 and got["opt_step"] == 7
        assert got["params"] == res[0]["restore"][(name, shape)]["params"]
        F, idx = shape[1], got["fast_index"]
        for k in ("mu", "nu", "master"):
            for b in range(nb):
                c_new = got[k][b].shape[0] * F
                np.testing.assert_array_equal(
                    got[k][b], _expected_box(truth[f"{k}{b}"], live[b],
                                             c_new, F, idx),
                    err_msg=f"{k}[{b}] rank {rank}")
        for b in range(nb):
            r = got["residuals"][b]
            if det or shape == (2, 2):
                n = truth[f"residuals{b}"].shape[0] // 4
                np.testing.assert_array_equal(
                    r, truth[f"residuals{b}"][rank * n:(rank + 1) * n])
            else:
                assert not r.any()


@pytest.mark.parametrize("ef", [False, True], ids=["noef", "ef"])
def test_reshard_continuation_bitwise_on_gloo_ranks(four_ranks, ef):
    _, res = four_ranks
    for rank in range(4):
        out = res[rank]["continuation"][ef]
        assert out["first"] == out["ref"][:3]
        for shape in ((4, 1), (1, 4)):
            assert out[shape]["step"] == 3
            assert out[shape]["cont"] == out["ref"][3:], (rank, shape)
            assert out[shape]["bitwise"], (rank, shape)
        # every shard file of a flat state is 1/F of its array (F = 2 on
        # (2,2); the residuals 1/4), never a whole bucket
        for key, extents in out["extents"].items():
            # EF residuals ("[1][1][i]" under EFState) shard 4 ways
            residual = ef and key.startswith("[1][1]")
            assert len(extents) == 2 and extents[1] == extents[0] * (
                4 if residual else 2), (key, extents)
        assert out[(4, 1)]["local"] == 4 * out[(1, 4)]["local"]


def test_trainer_on_a_grid_resumes_bitwise(four_ranks):
    """2 steps with async saves, then resume to 4: bitwise the
    uninterrupted run's losses and params, in the sharded and the
    gathered format, on every rank."""
    _, res = four_ranks
    for rank in range(4):
        out = res[rank]["trainer"]
        ref_losses, ref_digest = out["ref"]
        for fmt in ("sharded", "gathered"):
            assert out[fmt]["steps"] == [2]
            assert out[fmt]["losses"] == ref_losses[2:]
            assert out[fmt]["digest"] == ref_digest


def test_trainer_on_a_grid_falls_back_together(four_ranks):
    """One rank's shard file of step 4 is corrupt: every rank falls back to
    step 2, rank 0 alone quarantines, and the run still ends bitwise."""
    _, res = four_ranks
    got = [res[r]["trainer"]["fallback"] for r in range(4)]
    ref_losses, ref_digest = res[0]["trainer"]["ref"]
    for out in got:
        assert out["restored"] == 2
        assert out["quarantined"] == got[0]["quarantined"]
        assert [q for q, _ in out["quarantined"]] == [4]
        assert out["losses"] == ref_losses[2:]
        assert out["digest"] == ref_digest
        assert out["steps"] == [2]
    assert ".quarantined-" in got[0]["quarantined"][0][1]
