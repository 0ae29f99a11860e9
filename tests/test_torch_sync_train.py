"""The port's manual-sync training modes on 4 gloo ranks against the JAX
package on the CPU.

One spawn of 4 ranks (``repro_torch.parallel.launch``) runs every mode and
option of the port's step at reduced width (``tests/_torch_ranks.py``),
mostly on a (pod 2, data 2) grid; each rank draws the global batch from
``SyntheticCorpus`` and trains on its rows.  The oracle is the reference's
single-device jitted step on the same global batch, with the same weights
(bridged from its ``init``, in f32) and accum = ranks x the ranks' accum,
so microbatch j = r·accum + i is rank r's microbatch i.

Bounds: the loss and grad norm of each step within the reference's own
bound between modes (``rtol=1e-4, atol=1e-5``,
``tests/test_bucketing.py::test_train_modes_equivalent_multidevice``);
bitwise where the reference demands it (zero1 against bucketed, overlap
against serial, the deterministic reduce across (2,2), (4,1) and (1,4));
every rank's parameters bitwise equal to every other's after every step.
A compressed slow hop changes the gradients, so those runs (at the
lower learning rate) are held to the oracle at step 0 (the loss is taken before any update) at the same
bound, and over their curve within ``COMPRESSED``, the bounds of
``tests/test_collectives.py::test_hierarchical_allreduce_correct_multidevice``
for a bf16 and an int8 slow hop; int8 with error feedback must track the
uncompressed curve closer than int8 alone, as in
``tests/test_overlap_parity.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import data as jdata
from repro import optim as joptim
from repro import train as jtrain
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch import optim, train
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import build_model, get_config, \
    reduced_config
from repro_torch.parallel.launch import run_ranks
from repro_torch.parallel.mesh import grad_sync_axes, make_rank_grid
from tests import _torch_ranks as R

ARCH = "llama3.2-1b"
RANKS, ACCUM = 4, 2
DATA = dict(seq_len=16, global_batch=8)
OCFG = {"a": dict(peak_lr=1e-3, warmup_steps=2, total_steps=30),
        "b": dict(peak_lr=3e-3, warmup_steps=2, total_steps=20)}
BOUND = dict(rtol=1e-4, atol=1e-5)
# a compressed slow hop against the uncompressed oracle, per step, by its
# bits: the reference's bounds for its bf16 and int8 hierarchical mean
# (tests/test_collectives.py, rtol 2e-2 and 0.05; their atol left out)
COMPRESSED = {16: dict(rtol=2e-2), 8: dict(rtol=5e-2)}
SMALL = 64 << 10          # bucket bytes of a multi-bucket layout
G22, G41, G14 = ((2, 2), ("pod", "data")), ((4, 1), ("pod", "data")), \
    ((1, 4), ("pod", "data"))
INT8_EF = dict(slow_compress_bits=8, slow_error_feedback=True)


def _runs():
    runs = {
        "xla": dict(mode="xla", steps=6),
        "compressed_one_pod": dict(mode="compressed", steps=6, grid=G14),
        "hier": dict(mode="hier", steps=6),
        "hier_bucketed": dict(mode="hier_bucketed", steps=20),
        "zero1": dict(mode="hier_bucketed_zero1", steps=20),
        "hier_bucketed_bf16": dict(mode="hier_bucketed", steps=20,
                                   dtype="bfloat16"),
        "zero1_bf16": dict(mode="hier_bucketed_zero1", steps=20,
                           dtype="bfloat16"),
        "hier_c16": dict(mode="hier", steps=6,
                         opts=dict(slow_compress_bits=16)),
        "hier_c8": dict(mode="hier", steps=6,
                        opts=dict(slow_compress_bits=8)),
        "bucketed_c16": dict(mode="hier_bucketed", steps=6,
                             opts=dict(slow_compress_bits=16)),
        "bucketed_c8": dict(mode="hier_bucketed", steps=6,
                            opts=dict(slow_compress_bits=8)),
        "curve_f32": dict(mode="hier_bucketed", steps=15, ocfg="b",
                          opts=dict(bucket_bytes=SMALL)),
        "curve_int8": dict(mode="hier_bucketed", steps=15, ocfg="b",
                           opts=dict(bucket_bytes=SMALL,
                                     slow_compress_bits=8)),
        "curve_int8_ef": dict(mode="hier_bucketed", steps=15, ocfg="b",
                              opts=dict(bucket_bytes=SMALL, **INT8_EF)),
    }
    for name, mode in (("bucketed", "hier_bucketed"),
                       ("zero1", "hier_bucketed_zero1")):
        for tag, extra in (("small", {}), ("int8_ef", INT8_EF)):
            for overlap in (False, True):
                runs[f"{name}_{tag}{'_overlap' if overlap else ''}"] = dict(
                    mode=mode, steps=6,
                    opts=dict(bucket_bytes=SMALL, overlap=overlap, **extra))
        for gtag, grid in (("22", G22), ("41", G41), ("14", G14)):
            runs[f"det_{name}_{gtag}"] = dict(
                mode=mode, steps=6, grid=grid,
                opts=dict(deterministic_reduce=True))
            runs[f"det_{name}_int8_ef_{gtag}"] = dict(
                mode=mode, steps=6, grid=grid,
                opts=dict(deterministic_reduce=True, **INT8_EF))
    return runs


RUNS = _runs()
# the int8 curves at the higher learning rate are held by the
# error-feedback test, not to the oracle
CURVES = ("curve_int8", "curve_int8_ef")
COMPRESSED_RUNS = [n for n, r in RUNS.items()
                   if r.get("opts", {}).get("slow_compress_bits")
                   and n not in CURVES]
EXACT_RUNS = [n for n, r in RUNS.items()
              if not r.get("opts", {}).get("slow_compress_bits")
              and r.get("dtype", "float32") == "float32"]


@pytest.fixture(scope="module")
def weights():
    cfg = jax_reduced_config(jax_get_config(ARCH))
    model = jax_build_model(cfg, remat=False)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.key(0)))
    return cfg, model, params


@pytest.fixture(scope="module")
def oracle(weights):
    """The reference's single-device step on the global batch: loss and
    grad norm per step, for each optimizer config."""
    cfg, model, params = weights
    corpus = jdata.SyntheticCorpus(jdata.DataConfig(
        vocab_size=cfg.vocab_size, **DATA))
    out = {}
    for name, steps in (("a", 20), ("b", 15)):
        ocfg = joptim.AdamWConfig(**OCFG[name])
        step = jtrain.make_jitted_train_step(model, ocfg,
                                             accum=RANKS * ACCUM, rules=None)
        p = jax.tree.map(jnp.copy, params)
        st = joptim.init(ocfg, p)
        rows = []
        for i in range(steps):
            b = {k: jnp.asarray(v) for k, v in corpus.batch(i).items()}
            p, st, m = step(p, st, b)
            rows.append((float(m["loss"]), float(m["grad_norm"])))
        out[name] = np.asarray(rows)
    return out


@pytest.fixture(scope="module")
def ranks(weights):
    cfg, _, params = weights
    spec = {"cfg": reduced_config(get_config(ARCH)),
            "weights": {n: t.numpy() for n, t in params_from_jax(
                jax.tree.map(np.asarray, params)).items()},
            "data": dict(vocab_size=cfg.vocab_size, **DATA),
            "ocfg": OCFG, "accum": ACCUM, "runs": RUNS}
    return run_ranks(R.sync_train_ranks, RANKS, args=(spec,), threads=1,
                     deadline_s=600)


def _curve(out, name):
    return np.stack([out[0][name]["loss"], out[0][name]["grad_norm"]], 1)


@pytest.mark.parametrize("name", EXACT_RUNS)
def test_mode_matches_reference_step(ranks, oracle, name):
    want = oracle[RUNS[name].get("ocfg", "a")]
    got = _curve(ranks, name)
    np.testing.assert_allclose(got, want[:len(got)], **BOUND)


@pytest.mark.parametrize("name", COMPRESSED_RUNS)
def test_compressed_mode_tracks_reference_step(ranks, oracle, name):
    want = oracle[RUNS[name].get("ocfg", "a")]
    got = _curve(ranks, name)
    np.testing.assert_allclose(got[0, 0], want[0, 0], **BOUND)
    bits = RUNS[name]["opts"]["slow_compress_bits"]
    np.testing.assert_allclose(got, want[:len(got)], **COMPRESSED[bits])
    assert not np.array_equal(got, want[:len(got)])


@pytest.mark.parametrize("name", list(RUNS))
def test_every_rank_holds_the_same_params_every_step(ranks, name):
    n = int(np.prod(RUNS[name].get("grid", G22)[0]))
    first = ranks[0][name]
    for r in range(1, n):
        assert ranks[r][name]["digests"] == first["digests"]
        assert ranks[r][name]["loss"] == first["loss"]
    assert len(set(first["digests"])) == len(first["digests"])


@pytest.mark.parametrize("dtype", ["", "_bf16"])
def test_zero1_bitwise_equals_bucketed_20_steps(ranks, dtype):
    a, b = ranks[0][f"hier_bucketed{dtype}"], ranks[0][f"zero1{dtype}"]
    assert a["loss"] == b["loss"]
    assert a["grad_norm"] == b["grad_norm"]
    assert a["digests"] == b["digests"]
    assert a["loss"][0] != a["loss"][-1]


@pytest.mark.parametrize("name", ["bucketed_small", "zero1_small",
                                  "bucketed_int8_ef", "zero1_int8_ef"])
def test_overlap_bitwise_equals_serial(ranks, name):
    for r in range(RANKS):
        serial, piped = ranks[r][name], ranks[r][f"{name}_overlap"]
        assert serial["loss"] == piped["loss"]
        assert serial["digests"] == piped["digests"]
        if "residual_digest" in serial:
            assert serial["residual_abs_sum"] > 0
            assert serial["residual_digest"] == piped["residual_digest"]


@pytest.mark.parametrize("name", ["det_bucketed", "det_zero1",
                                  "det_bucketed_int8_ef",
                                  "det_zero1_int8_ef"])
def test_deterministic_reduce_bitwise_across_grids(ranks, name):
    runs = [ranks[0][f"{name}_{g}"] for g in ("22", "41", "14")]
    for other in runs[1:]:
        assert other["loss"] == runs[0]["loss"]
        assert other["grad_norm"] == runs[0]["grad_norm"]
        assert other["digests"] == runs[0]["digests"]
    if "int8" in name:
        # each global rank's own residual, whatever the factorization
        for r in range(RANKS):
            digests = {ranks[r][f"{name}_{g}"]["residual_digest"]
                       for g in ("22", "41", "14")}
            assert len(digests) == 1


def test_int8_error_feedback_closer_than_int8(ranks):
    base = np.asarray(ranks[0]["curve_f32"]["loss"])
    dev_plain = np.abs(np.asarray(ranks[0]["curve_int8"]["loss"]) - base)
    dev_ef = np.abs(np.asarray(ranks[0]["curve_int8_ef"]["loss"]) - base)
    assert ranks[0]["curve_int8_ef"]["residual_abs_sum"] > 0
    assert dev_ef.sum() < dev_plain.sum(), (dev_ef.sum(), dev_plain.sum())


def test_trainer_on_grid_matches_reference(ranks, oracle):
    got = [r["trainer"] for r in ranks]
    assert len({g["digest"] for g in got}) == 1
    np.testing.assert_allclose(got[0]["loss"], oracle["a"][:3, 0], **BOUND)


# ------------------------------------------------------------ one rank

@pytest.fixture(scope="module")
def port_model():
    return build_model(reduced_config(get_config(ARCH)), device="cpu",
                       seed=0, remat=False)


@pytest.mark.parametrize("mode", ["hier_bucketed", "hier_bucketed_zero1"])
def test_one_rank_grid_is_the_local_path(port_model, mode):
    """A (1, 1) grid makes no collective; overlap is a no-op there and on a
    single-bucket layout, as in the reference's degenerate cases."""
    from repro_torch.data import DataConfig, SyntheticCorpus
    grid = make_rank_grid((1, 1), ("pod", "data"))
    assert grid.axis("data").group is None
    ocfg = optim.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    corpus = SyntheticCorpus(DataConfig(vocab_size=512, **DATA))
    batches = [{k: R.to_torch(v) for k, v in corpus.batch(i).items()}
               for i in range(2)]
    curves = []
    for kw in (dict(), dict(grid=grid, overlap=True)):
        params, st = train.init_train_state(port_model, ocfg, seed=0,
                                            cross_pod_mode=mode, **{
                                                k: v for k, v in kw.items()
                                                if k == "grid"})
        step = train.make_train_step(port_model, ocfg, accum=2,
                                     device="cpu", cross_pod_mode=mode, **kw)
        losses = []
        for b in batches:
            params, st, m = step(params, st, b)
            losses.append(m["loss"].item())
        curves.append((losses, R.digest(params)))
    assert curves[0] == curves[1]


class _Grid:
    def __init__(self, shape, names):
        self.shape, self.axis_names = dict(zip(names, shape)), names


def test_grad_sync_axes_refuses_parameter_axes():
    assert grad_sync_axes(_Grid((2, 2), ("pod", "data"))) == ("data", "pod")
    assert grad_sync_axes(_Grid((4, 1), ("data", "model"))) == ("data", None)
    with pytest.raises(ValueError, match="non-trivial axes"):
        grad_sync_axes(_Grid((2, 2), ("data", "model")))


@pytest.mark.parametrize("kw,match", [
    (dict(cross_pod_mode="xla", overlap=True), "overlap"),
    (dict(cross_pod_mode="hier", slow_error_feedback=True,
          slow_compress_bits=8), "overlap"),
    (dict(cross_pod_mode="hier_bucketed", slow_error_feedback=True),
     "slow_compress_bits=8"),
    (dict(cross_pod_mode="hier_bucketed_zero1", deterministic_reduce=True,
          overlap=True), "pick one"),
    (dict(cross_pod_mode="hier", deterministic_reduce=True), "bucketed"),
    (dict(cross_pod_mode="nope"), "unknown cross_pod_mode"),
])
def test_argument_errors_match_reference(port_model, kw, match):
    with pytest.raises(ValueError, match=match):
        jtrain.make_train_step(object(), joptim.AdamWConfig(), **kw)
    with pytest.raises(ValueError, match=match):
        train.make_train_step(port_model, optim.AdamWConfig(), device="cpu",
                              **kw)


def test_compressed_refused_on_more_than_one_pod(port_model):
    grid = _Grid((2, 1), ("pod", "data"))
    with pytest.raises(NotImplementedError, match="multi-pod"):
        train.make_train_step(port_model, optim.AdamWConfig(), device="cpu",
                              grid=grid, cross_pod_mode="compressed")


def test_modes_are_the_reference_modes():
    assert train.CROSS_POD_MODES == jtrain.CROSS_POD_MODES
    assert train.MANUAL_SYNC_MODES == jtrain.MANUAL_SYNC_MODES
    assert train.BUCKETED_SYNC_MODES == jtrain.BUCKETED_SYNC_MODES
    assert ({f.name for f in dataclasses.fields(train.TrainerConfig)}
            <= {f.name for f in dataclasses.fields(jtrain.TrainerConfig)})


def test_launcher_data_parallel_on_the_cpu(capsys):
    """``--data-parallel 2`` spawns 2 ranks on a (data,) grid; its step-0
    loss is the single rank's on the same global batch."""
    from repro_torch.launch.train import main
    common = ["--device", "cpu", "--steps", "1", "--seq", "32"]
    main(common + ["--data-parallel", "2", "--cross-pod-mode",
                   "hier_bucketed_zero1"])
    main(common)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 and all(ln.startswith("step    0") for ln in lines)
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines]
    assert abs(losses[0] - losses[1]) < 1e-3, losses
    with pytest.raises(SystemExit):
        main(common + ["--model-parallel", "2"])
