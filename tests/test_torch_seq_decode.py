"""Flash-decode over a ``kv_seq``-sharded KV cache: the port's
sequence-sharded branch of ``sharded_decode_attention`` and the decode
steps that reach it through ``make_serve_step``, against the JAX package.

- **The merge, in one process.** A cache split into n slices, each slice's
  partials from the port's ``_local_partial_softmax``, merged by the
  sharded branch's arithmetic (``merge_partials``) with the shards as a
  leading axis: against the reference's dense ``decode_attention``
  (``repro/models/layers.py:236``) and its single-shard
  ``sharded_decode_attention``, f32 within 2e-5 and bf16 within 2e-2
  (``tests/test_kernels.py::_tol``).
- **The reference's own sharded branch.** One ``run_multidevice``
  subprocess of 8 fake devices runs it under ``seq_shard`` on (1, 4) and
  (2, 4) and under ``long_ctx`` on (2, 2), over meshes built with
  ``jax.sharding.Mesh``: under jax 0.9 ``jax.make_mesh`` builds Explicit
  axes, on which the branch's final reshape raises (why
  ``test_elastic_pipeline::test_flash_decode_sharded_matches_dense_multidevice``
  fails here).  The port's merge, and its branch on 4 gloo ranks, lie
  within 2e-5 of it.
- **Whole models on gloo ranks.** One spawn of 4 ranks
  (``tests/_torch_ranks.py::seq_decode_ranks``) decodes llama3.2-1b's
  reduced config in f32 under ``seq_shard`` on (1, 4) and ``long_ctx`` on
  (2, 2) (``kv_seq`` over two axes and the heads over ``model`` at once),
  and zamba2-1.2b's under ``long_ctx`` on (4, 1), from each rank's block of
  one global cache drawn from a seed, at positions in the first shard,
  either side of a boundary and last, each step from the same cache.
  Each rank's block of the logits is held against the reference model's
  single-device ``decode_step`` on bridged weights and the same cache
  (``DECODE_ATOL`` of ``tests/test_torch_tp.py``); only the rank whose
  slice holds the position writes, the one entry, bitwise elsewhere.
"""
import concurrent.futures
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import \
    sharded_decode_attention as jax_sharded_decode_attention
from repro.models.layers import decode_attention
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.models.attention import _local_partial_softmax, \
    merge_partials
from repro_torch.models.registry import get_config, reduced_config
from repro_torch.parallel.launch import run_ranks
from tests import _torch_ranks as R
from tests.conftest import run_multidevice

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S, KV, D = 2, 64, 2, 16
POS_KINDS = ("first", "before", "after", "last")


def _pos(kind: str, n: int) -> int:
    """A position in the first shard, either side of the first boundary,
    or the last, for a cache of S in n shards."""
    return {"first": 5, "before": S // n - 1, "after": S // n,
            "last": S - 1}[kind]


def _inputs(groups: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    H = KV * groups
    return (rng.standard_normal((B, 1, H, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32),
            rng.standard_normal((B, S, KV, D)).astype(np.float32))


_DENSE = jax.jit(decode_attention, static_argnames=("softcap",))
_SINGLE = jax.jit(jax_sharded_decode_attention, static_argnames=("softcap",))


@functools.lru_cache(maxsize=None)
def _reference(groups, softcap, dtype, pos):
    jd = DTYPES[dtype][0]
    q, k, v = (jnp.asarray(a, jd) for a in _inputs(groups))
    dense = _DENSE(q, k, v, jnp.int32(pos + 1), softcap=softcap)
    single = _SINGLE(q, k, v, jnp.int32(pos), softcap=softcap)
    return (np.asarray(dense, np.float32), np.asarray(single, np.float32))


def _merged(q, k, v, pos, n, softcap=0.0):
    """The sharded branch's arithmetic over n slices in one process: each
    slice's partials, stacked on a leading shard axis, merged by
    ``merge_partials`` with reductions over that axis."""
    Bq, _, H, Dq = q.shape
    Sl, Kv = k.shape[1] // n, k.shape[2]
    qg = q.reshape(Bq, 1, Kv, H // Kv, Dq)
    parts = [_local_partial_softmax(
        qg, k[:, i * Sl:(i + 1) * Sl], v[:, i * Sl:(i + 1) * Sl],
        i * Sl + torch.arange(Sl) < pos + 1, softcap=softcap)
        for i in range(n)]
    m, l, acc = (torch.stack(t) for t in zip(*parts))
    out = merge_partials(m, l, acc, pmax=lambda t: t.amax(0),
                         psum=lambda a, b: (a.sum(0), b.sum(0)))
    return out.reshape(Bq, 1, H, v.shape[-1]).to(q.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("kind", POS_KINDS)
@pytest.mark.parametrize("n", [2, 4])
def test_merge_matches_reference(n, kind, groups, softcap, dtype):
    pos = _pos(kind, n)
    td = DTYPES[dtype][1]
    q, k, v = (torch.from_numpy(a).to(td) for a in _inputs(groups))
    got = _merged(q, k, v, pos, n, softcap).float().numpy()
    dense, single = _reference(groups, softcap, dtype, pos)
    np.testing.assert_allclose(got, dense, **TOL[dtype])
    np.testing.assert_allclose(got, single, **TOL[dtype])


def test_a_shard_with_no_valid_key_adds_nothing():
    """At a position in the first shard every other shard is wholly
    masked; its partials (m = -1e30) are rescaled by exp(-1e30 - gm) = 0,
    so the merge equals the first shard's own normalised output."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(4))
    got = _merged(q, k, v, 5, 4)
    first = _merged(q, k[:, :S // 4], v[:, :S // 4], 5, 1)
    assert torch.equal(got, first)


# ------------------------------------------- the reference's sharded branch

# (key, rule flags, (data, model)); every grid has 4 kv_seq shards
REF_GRIDS = [("seq_shard_1x4", dict(seq_shard=True), (1, 4)),
             ("seq_shard_2x4", dict(seq_shard=True), (2, 4)),
             ("long_ctx_2x2", dict(long_ctx=True), (2, 2))]
RANK_GRIDS = [g for g in REF_GRIDS if g[2][0] * g[2][1] == 4]
REF_POSITIONS = [3, 15, 16, 37, 63]
DROP_S = 62                      # not divisible by 4: the drop rule
DROP_POSITIONS = [5, DROP_S - 1]
REF_CODE = """
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models.attention import sharded_decode_attention
from repro.sharding import make_rules, use_rules
a = np.load(%(inputs)r)
q, k, v = (jnp.asarray(a[n]) for n in ("q", "k", "v"))
out = {}
for key, flags, shape in %(grids)r:
    n = shape[0] * shape[1]
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), ("data", "model"))
    rules = make_rules(mesh, **flags)
    with mesh, use_rules(rules):
        fn = jax.jit(lambda q, k, v, p: sharded_decode_attention(q, k, v, p))
        for p in %(positions)r:
            out[f"{key}/{p}"] = np.asarray(fn(q, k, v, jnp.int32(p)))
np.savez(%(outputs)r, **out)
print("REF_OK")
"""


def _attention_inputs():
    q, k, v = _inputs(2, seed=1)
    rng = np.random.default_rng(2)
    drop = {n: rng.standard_normal((B, DROP_S, KV, D)).astype(np.float32)
            for n in ("k", "v")}
    return q, k, v, drop


@pytest.fixture(scope="module")
def reference_branch(tmp_path_factory):
    """The reference's sharded branch on 8 fake devices (a
    ``run_multidevice`` subprocess, run while this process computes the
    models' references), and its dense ``decode_attention``, on the same
    inputs."""
    base = tmp_path_factory.mktemp("seq_decode_ref")
    q, k, v, _ = _attention_inputs()
    np.savez(base / "in.npz", q=q, k=k, v=v)
    code = REF_CODE % dict(inputs=str(base / "in.npz"),
                           outputs=str(base / "out.npz"), grids=REF_GRIDS,
                           positions=REF_POSITIONS)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        job = pool.submit(run_multidevice, code)
        for name in ARCHS:
            _model_reference(name)
        assert "REF_OK" in job.result()
    got = dict(np.load(base / "out.npz"))
    dense = {p: np.asarray(_DENSE(*(jnp.asarray(a) for a in (q, k, v)),
                                  jnp.int32(p + 1), softcap=0.0))
             for p in REF_POSITIONS}
    return got, dense


@pytest.mark.parametrize("grid", REF_GRIDS, ids=[g[0] for g in REF_GRIDS])
def test_reference_sharded_branch_matches_dense(reference_branch, grid):
    """The oracle: over ``jax.sharding.Mesh`` the reference's branch is
    its dense function's, at every position."""
    got, dense = reference_branch
    for p in REF_POSITIONS:
        np.testing.assert_allclose(got[f"{grid[0]}/{p}"], dense[p],
                                   **TOL["float32"])


@pytest.mark.parametrize("grid", REF_GRIDS, ids=[g[0] for g in REF_GRIDS])
def test_merge_matches_reference_sharded_branch(reference_branch, grid):
    got, _ = reference_branch
    q, k, v = (torch.from_numpy(a) for a in _attention_inputs()[:3])
    for p in REF_POSITIONS:
        np.testing.assert_allclose(_merged(q, k, v, p, 4).numpy(),
                                   got[f"{grid[0]}/{p}"], **TOL["float32"])


# ------------------------------------------------------ gloo ranks

ARCHS = {"llama": "llama3.2-1b", "zamba": "zamba2-1.2b"}
# (model, rule flags, (data, model))
RUNS = [("llama", dict(seq_shard=True), (1, 4)),
        ("llama", dict(long_ctx=True), (2, 2)),
        ("zamba", dict(long_ctx=True), (4, 1))]
RUN_IDS = [f"{m}-{next(iter(f))}-{d}x{n}" for m, f, (d, n) in RUNS]
CACHE_S, CACHE_B = 32, 2
# in the first shard, either side of the first boundary, last
POSITIONS = [3, 7, 8, 31]
# tests/test_torch_tp.py's f32 decode bound: the KV cache is bf16 on both
# sides, and a 1-ulp f32 difference in a new entry can round to the
# neighbouring bf16 value
DECODE_ATOL = 2e-3
KV_KEYS = {"llama": ("k", "v"), "zamba": ("attn_k", "attn_v")}
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _bits(a):
    """An array for the ranks: (numpy, dtype name), bf16 as its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _draw_cache(cache, rng):
    """Every leaf of a reference cache drawn from ``rng``, in its dtype."""
    if isinstance(cache, dict):
        return {k: _draw_cache(v, rng) for k, v in cache.items()}
    return jnp.asarray(rng.standard_normal(cache.shape), cache.dtype)


@functools.lru_cache(maxsize=None)
def _model_reference(name):
    """The reference model's side of one model: bridged weights, the global
    cache, and its single-device decode step from that cache at each
    position: logits and the entries written."""
    cfg = jax_reduced_config(jax_get_config(ARCHS[name]))
    model = jax_build_model(cfg, remat=False)
    key = jax.random.key(0)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), jax.jit(
        model.init).lower(key).compile(compiler_options=FAST_COMPILE)(key))
    rng = np.random.default_rng(7)
    cache = _draw_cache(model.init_cache(CACHE_B, CACHE_S), rng)
    tokens = [rng.integers(0, cfg.vocab_size, (CACHE_B, 1)).astype(np.int32)
              for _ in POSITIONS]
    step = jax.jit(model.decode_step).lower(
        params, cache, jnp.asarray(tokens[0]), jnp.int32(0)).compile(
        compiler_options=FAST_COMPILE)
    logits, entries = [], []
    for pos, tok in zip(POSITIONS, tokens):
        lg, new = step(params, cache, jnp.asarray(tok), jnp.int32(pos))
        logits.append(np.asarray(lg, np.float32))
        entries.append({k: np.asarray(new[k][:, :, pos], np.float32)
                        for k in KV_KEYS[name]})
    weights = {n: t.numpy() for n, t in params_from_jax(
        jax.tree.map(np.asarray, params), cfg.family).items()}
    return dict(weights=weights, cache=jax.tree.map(_bits, cache),
                tokens=tokens, logits=logits, entries=entries)


@pytest.fixture(scope="module")
def ranks():
    q, k, v, drop = _attention_inputs()
    models = {}
    for name in ARCHS:
        ref = _model_reference(name)
        models[name] = dict(
            cfg=reduced_config(get_config(ARCHS[name])),
            weights=ref["weights"], cache=ref["cache"],
            tokens=ref["tokens"], positions=POSITIONS,
            batch_seq=(CACHE_B, CACHE_S))
    spec = {"attention": dict(q=q, k=k, v=v, positions=REF_POSITIONS,
                              grids=RANK_GRIDS,
                              drop=dict(drop, positions=DROP_POSITIONS)),
            "runs": RUNS, "models": models}
    return run_ranks(R.seq_decode_ranks, 4, args=(spec,), threads=1,
                     deadline_s=300)


@pytest.mark.parametrize("grid", RANK_GRIDS,
                         ids=[g[0] for g in RANK_GRIDS])
def test_ranks_match_reference_sharded_branch(ranks, reference_branch,
                                              grid):
    """``sharded_decode_attention`` itself, each rank on its slice: every
    rank returns every head's output, the reference's, and the ranks'
    slices tile the sequence in the rule's row-major order."""
    got, _ = reference_branch
    slices = sorted(r[("attention", grid[0])]["seq"] for r in ranks)
    assert slices == [(i * 16, (i + 1) * 16, 4) for i in range(4)]
    for r in ranks:
        out = r[("attention", grid[0])]
        for p, o in zip(REF_POSITIONS, out["sharded"]):
            np.testing.assert_allclose(o, got[f"{grid[0]}/{p}"],
                                       **TOL["float32"])


@pytest.mark.parametrize("grid", RANK_GRIDS,
                         ids=[g[0] for g in RANK_GRIDS])
def test_the_drop_rule_keeps_the_cache_whole(ranks, grid):
    """A cache of 62 positions does not split 4 ways: every rank holds it
    whole and computes the single-shard branch, the dense function's."""
    q, _, _, drop = _attention_inputs()
    for j, p in enumerate(DROP_POSITIONS):
        got = ranks[0][("attention", grid[0])]["drop"][j]
        for r in ranks:
            np.testing.assert_array_equal(
                r[("attention", grid[0])]["drop"][j], got)
        want = _DENSE(*(jnp.asarray(a) for a in (q, drop["k"], drop["v"])),
                      jnp.int32(p + 1), softcap=0.0)
        np.testing.assert_allclose(got, np.asarray(want), **TOL["float32"])


def _block(a, coords, shape, flags):
    """The rank's block of global logits (B, 1, V): rows over data unless
    ``long_ctx`` keeps the batch whole, vocab columns over model."""
    (d, m), (Dn, M) = coords, shape
    if flags.get("long_ctx"):
        d, Dn = 0, 1
    b, v = a.shape[0] // Dn, a.shape[-1] // M
    return a[d * b:(d + 1) * b, ..., m * v:(m + 1) * v]


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_decode_blocks_match_reference(ranks, run):
    name, flags, shape = run
    ref = _model_reference(name)
    for r in ranks:
        got = r[(name, shape)]
        for i, pos in enumerate(POSITIONS):
            want = _block(ref["logits"][i], r["coords"][shape], shape,
                          flags)
            assert got["logits"][i].shape == want.shape
            np.testing.assert_allclose(got["logits"][i], want, rtol=0,
                                       atol=DECODE_ATOL,
                                       err_msg=f"rank {r['coords']}, "
                                               f"pos {pos}")


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_only_the_owner_writes(ranks, run):
    """Each step changes, bit for bit, only the position it writes, and
    only on the rank whose slice holds it; the slices tile the sequence,
    and the recurrent states (the hybrid's, whole on every rank) are the
    same on every rank after every step."""
    name, _, shape = run
    S_loc = CACHE_S // 4
    seqs = sorted(r[(name, shape)]["seq"] for r in ranks)
    assert seqs == [(i * S_loc, (i + 1) * S_loc) for i in range(4)]
    for i, pos in enumerate(POSITIONS):
        owners = 0
        for r in ranks:
            got = r[(name, shape)]
            lo, hi = got["seq"]
            want = [pos - lo] if lo <= pos < hi else []
            owners += bool(want)
            for k in KV_KEYS[name]:
                assert got["changed"][i][k] == want, (k, pos, got["seq"])
            assert got["states"][i] == ranks[0][(name, shape)]["states"][i]
        assert owners == 1


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_written_entry_matches_reference(ranks, run):
    """The owner's new K/V entry is the reference's, to bf16's resolution:
    both round an f32 value to the bf16 cache."""
    name, _, shape = run
    ref = _model_reference(name)
    for i, pos in enumerate(POSITIONS):
        (entry,) = [r[(name, shape)]["entries"][i] for r in ranks
                    if r[(name, shape)]["entries"][i] is not None]
        for k in KV_KEYS[name]:
            np.testing.assert_allclose(entry[k], ref["entries"][i][k],
                                       rtol=2 ** -7, atol=1e-5,
                                       err_msg=f"{k} at {pos}")


@pytest.mark.parametrize("run", RUNS, ids=RUN_IDS)
def test_init_cache_under_rules_is_the_rank_block(ranks, run):
    """``model.init_cache`` under the step's rules makes the rank's block
    of the global cache, its quarter of the positions and every row, and
    records the global length."""
    name, _, shape = run
    for r in ranks:
        got = r[(name, shape)]
        assert got["seq_len"] == CACHE_S
        for k in KV_KEYS[name]:
            assert got["shapes"][k][2] == CACHE_S // 4
            assert got["shapes"][k][1] == CACHE_B
