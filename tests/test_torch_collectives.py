"""The port's collective layer against the JAX package on the CPU.

Pure functions (int8 quantization, the fixed fold, the alignments, the
analytic transport model) against the reference's on the same numpy
inputs, bitwise.  The bucket layout and flat buffers of bridged
llama3.2-1b weights, at reduced width and at the full config's shapes,
against the reference's ``make_bucket_layout`` and ``flatten_to_buckets``,
bitwise.  The multi-rank layer: 4 gloo ranks of the port
(``repro_torch.parallel.launch``, one spawn for the module) against the
reference in ``run_multidevice`` with 4 fake devices (one subprocess), on
the same per-rank inputs, on the grids of
``test_bucketing.py::test_bucketed_schedule_matches_flat_multidevice``,
with f32, bf16 and int8 slow hops and int8 with error-feedback residuals.
Bounds: bitwise where every sum on both sides adds two values (or is the
deterministic fold, the same on both sides) in plain f32 or bf16
arithmetic, else ``rtol=1e-6, atol=1e-6``, and the norms at ``rtol=1e-5``,
as that test has them (``_bitwise`` says why the int8 hop is not bitwise).
"""
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.collectives import bucketing as JBK
from repro.collectives import compression as JC
from repro.collectives import deterministic as JD
from repro.collectives import transport as JT
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro.models.registry import reduced_config as jax_reduced_config
from repro.train import make_bucket_layout as jax_make_bucket_layout
from repro_torch import train
from repro_torch.collectives import bucketing as BK
from repro_torch.collectives import compression as C
from repro_torch.collectives import deterministic as D
from repro_torch.collectives import transport as T
from repro_torch.convert import params_from_jax
from repro_torch.models.registry import build_model, get_config, \
    reduced_config
from repro_torch.parallel.launch import run_ranks
from tests import _torch_ranks as R
from tests.conftest import run_multidevice

ARCH = "llama3.2-1b"
CLOSE = dict(rtol=1e-6, atol=1e-6)
NORM = dict(rtol=1e-5)


# ------------------------------------------------------- pure functions

@pytest.mark.parametrize("shape,scale", [((1000,), 1.0), ((7, 33), 1e-3),
                                         ((4096,), 50.0), ((3,), 0.0)])
def test_quantize_int8_bitwise(shape, scale):
    x = (np.random.default_rng(0).standard_normal(shape) * scale
         ).astype(np.float32)
    jq, js = JC.quantize_int8(jnp.asarray(x))
    tq, ts = C.quantize_int8(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)
    np.testing.assert_array_equal(
        C.dequantize_int8(tq, ts).numpy(),
        np.asarray(JC.dequantize_int8(jq, js)))


def test_apply_error_feedback_bitwise():
    rng = np.random.default_rng(1)
    g, r = (rng.standard_normal(257).astype(np.float32) for _ in range(2))
    jg, jr = JC.apply_error_feedback(jnp.asarray(g), jnp.asarray(r))
    tg, tr = C.apply_error_feedback(torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 8])
def test_tree_fold_sum_bitwise(n):
    x = np.random.default_rng(n).standard_normal((n, 65)).astype(
        np.float32)
    np.testing.assert_array_equal(
        D.tree_fold_sum(torch.from_numpy(x)).numpy(),
        np.asarray(JD.tree_fold_sum(jnp.asarray(x))))


@pytest.mark.parametrize("fast", [1, 2, 3, 4, 48, 64, 96, 128])
def test_det_align(fast):
    assert D.det_align(fast) == JD.det_align(fast)
    assert D.DETERMINISTIC_ALIGN == JD.DETERMINISTIC_ALIGN


@pytest.mark.parametrize("op", ["all_reduce", "all_gather",
                                "reduce_scatter", "all_to_all"])
def test_ring_factor(op):
    for n in (1, 2, 3, 8):
        assert T._ring_factor(op, n) == JT._ring_factor(op, n)


@pytest.mark.parametrize("transport", ["SHM", "NET"])
@pytest.mark.parametrize("op", ["all_reduce", "reduce_scatter"])
def test_gpu_collective(transport, op):
    for leaves, jobs in (((2, 2), 1), ((1, 3, 4), 2), ((7,), 3)):
        kw = dict(transport=transport, leaves_per_gpu=leaves,
                  concurrent_net_jobs=jobs)
        assert (dataclass_tuple(T.gpu_collective(op, 64e6, **kw))
                == dataclass_tuple(JT.gpu_collective(op, 64e6, **kw)))


def dataclass_tuple(perf):
    return (perf.transport, perf.n_ranks, perf.bytes_per_rank,
            perf.bus_bandwidth_gbps, perf.time_s)


@pytest.mark.cuda
def test_pinned_buffer_taken_in_inference_mode_is_reused_outside():
    """A staging buffer first taken under ``torch.inference_mode`` (a
    serve step's all-reduce) takes a copy outside it (a training step's
    all-reduce of the same size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the staging buffers are pinned "
                    "host memory for CUDA tensors)")
    from repro_torch.parallel import collectives as PX
    x = torch.arange(12.0, device="cuda")
    pool = PX._PinnedPool()
    with torch.inference_mode():
        buf = pool.take(12, torch.float32)
        buf.copy_(x)
    pool.give(buf)
    again = pool.take(12, torch.float32)
    assert again is buf
    again.copy_(x * 2)
    assert torch.equal(again, (x * 2).cpu())


@pytest.mark.parametrize("fast,slow", [(2, 2), (4, 1), (16, 2), (8, 4)])
def test_hierarchical_vs_flat_bytes(fast, slow):
    assert (T.hierarchical_vs_flat_bytes(1.5e9, fast=fast, slow=slow)
            == JT.hierarchical_vs_flat_bytes(1.5e9, fast=fast, slow=slow))
    for op in ("all_reduce", "all_gather"):
        assert (T.tpu_collective_time(op, 1e8, n_chips=fast, axis="ici")
                == JT.tpu_collective_time(op, 1e8, n_chips=fast,
                                          axis="ici"))


# ------------------------------------------------------------- layouts

@pytest.fixture(scope="module")
def bridged():
    cfg = jax_reduced_config(jax_get_config(ARCH))
    params = jax_build_model(cfg, remat=False).init(jax.random.key(5))
    model = build_model(reduced_config(get_config(ARCH)), device="cpu",
                        seed=None)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, {n: p.detach() for n, p in model.named_parameters()}


def _slot_fields(slot):
    return (slot.bucket, slot.offset, slot.size, tuple(slot.shape),
            str(np.dtype(slot.dtype)) if not isinstance(slot.dtype,
                                                        torch.dtype)
            else str(slot.dtype).replace("torch.", ""))


@pytest.mark.parametrize("bucket_bytes", [32 << 20, 1 << 20, 64 << 10])
@pytest.mark.parametrize("align,deterministic",
                         [(1, False), (2, False), (4, False), (2, True)])
def test_layout_and_buffers_match_reference(bridged, bucket_bytes, align,
                                            deterministic):
    jparams, tparams = bridged
    mesh_fast = align
    if deterministic:
        assert jax_make_bucket_layout(
            jparams, _DataAxis(mesh_fast), bucket_bytes=bucket_bytes,
            deterministic=True).align == 64
    jl = jax_make_bucket_layout(
        jparams, _DataAxis(mesh_fast), bucket_bytes=bucket_bytes,
        deterministic=deterministic)
    tl = train.make_bucket_layout(
        tparams, _DataAxis(mesh_fast), bucket_bytes=bucket_bytes,
        deterministic=deterministic)
    assert tl.bucket_sizes == jl.bucket_sizes and tl.align == jl.align
    assert [_slot_fields(s) for s in tl.slots] == \
        [_slot_fields(s) for s in jl.slots]
    jb = JBK.flatten_to_buckets(jl, jparams)
    tb = BK.flatten_to_buckets(tl, tparams)
    for a, b in zip(tb, jb):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    back = BK.unflatten_from_buckets(tl, tb)
    for n, t in tparams.items():
        assert back[n].dtype == t.dtype and torch.equal(back[n], t)


def test_full_config_layout_matches_reference():
    """llama3.2-1b at full width, from shapes alone on both sides: the
    reference through ``jax.eval_shape``, the port on the meta device."""
    jcfg = jax_get_config(ARCH)
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.key(0))
    model = build_model(get_config(ARCH), device="meta", seed=None)
    named = dict(model.named_parameters())
    for fast in (1, 2):
        jl = JBK.plan_buckets(shapes, align=fast)
        tl = BK.plan_buckets(named, align=fast)
        assert tl.bucket_sizes == jl.bucket_sizes
        assert [_slot_fields(s) for s in tl.slots] == \
            [_slot_fields(s) for s in jl.slots]
    assert tl.n_buckets == 11 and tl.n_elements() == 1_235_814_400
    assert [s.path for s in tl.slots][:2] == ["blocks.attn.wk",
                                              "blocks.attn.wo"]


class _DataAxis:
    """A stand-in mesh (and grid) of one data axis of size n: both sides'
    ``make_bucket_layout`` read only ``axis_names`` and ``shape``."""

    def __init__(self, n):
        self.axis_names = ("data",)
        self.shape = {"data": n}


# ------------------------------------------------- multi-rank collectives

BUCKET_BYTES = 128


def _inputs():
    """Per grid, per grid rank: a small tree (f32 and bf16 leaves) and
    residuals for the error-feedback hop, from a numpy seed."""
    rng = np.random.default_rng(11)
    shapes = {"a": (2, 3, 4), "b.c": (7,), "d": (5, 5)}
    dtypes = {"a": "float32", "b.c": "float32", "d": "bfloat16"}
    inputs, residuals = {}, {}
    for gname, (shape, names) in R.GRIDS.items():
        n = int(np.prod(shape))
        nf = dict(zip(names, shape)).get("data", 1)
        per = []
        for _ in range(n):
            t = {k: rng.standard_normal(s).astype(np.float32) * 3
                 for k, s in shapes.items()}
            # bf16 leaf values, carried exactly through f32
            t["d"] = np.asarray(jnp.asarray(t["d"]).astype(jnp.bfloat16)
                                .astype(jnp.float32))
            per.append(t)
        layout = JBK.plan_buckets(_nest(per[0]), bucket_bytes=BUCKET_BYTES,
                                  align=nf)
        inputs[gname] = per
        residuals[gname] = [
            {"hier": [rng.standard_normal(c // nf).astype(np.float32) * 0.1
                      for c in layout.bucket_sizes],
             "det": [rng.standard_normal(c).astype(np.float32) * 0.1
                     for c in layout.bucket_sizes]} for _ in range(n)]
    return inputs, residuals, dtypes


def _nest(flat):
    """{"a", "b.c", "d"} -> the reference's nested tree."""
    return {"a": flat["a"], "b": {"c": flat["b.c"]},
            "d": jnp.asarray(flat["d"]).astype(jnp.bfloat16)}


_REFERENCE = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import parallel as PX
from repro.collectives import bucketing as BK
from repro.collectives import deterministic as DT
from repro.collectives.hierarchical import hier_all_reduce_mean

with open(sys.argv[1], "rb") as f:
    spec = pickle.load(f)
out = {}
for gname, (shape, names) in spec["grids"].items():
    n = int(np.prod(shape))
    mesh = PX.make_device_mesh(shape, names, devices=jax.devices()[:n])
    fast = "data" if "data" in names else None
    slow = "pod" if "pod" in names else None
    nf = mesh.shape[fast] if fast else 1
    per = spec["inputs"][gname]
    def nest(t):
        return {"a": t["a"], "b": {"c": t["b.c"]},
                "d": t["d"].astype(jnp.bfloat16)}
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs),
                           *[nest({k: jnp.asarray(v) for k, v in t.items()})
                             for t in per])
    layout = BK.plan_buckets(jax.tree.map(lambda x: x[0], stacked),
                             bucket_bytes=spec["bucket_bytes"], align=nf)
    res = spec["residuals"][gname]
    hres = tuple(jnp.stack([jnp.asarray(r["hier"][b]) for r in res])
                 for b in range(layout.n_buckets))
    dres = tuple(jnp.stack([jnp.asarray(r["det"][b]) for r in res])
                 for b in range(layout.n_buckets))
    for sname, (bits, ef) in spec["settings"].items():
        def rank(t, hr, dr):
            t = jax.tree.map(lambda x: x[0], t)
            hr = tuple(r[0] for r in hr)
            dr = tuple(r[0] for r in dr)
            b = BK.flatten_to_buckets(layout, t)
            if ef:
                s, nr = BK.hier_reduce_bucket_shards(
                    b, fast_axis=fast, slow_axis=slow, compress_bits=bits,
                    residuals=hr)
            else:
                s = BK.hier_reduce_bucket_shards(
                    b, fast_axis=fast, slow_axis=slow, compress_bits=bits)
                nr = hr
            gn = BK.shard_global_norm(s, fast)
            full = BK.all_gather_buckets(s, fast_axis=fast)
            tree = BK.unflatten_from_buckets(layout, full,
                                             dtype=jnp.float32)
            per_tensor = jax.tree.map(
                lambda x: hier_all_reduce_mean(
                    x.astype(jnp.float32), fast_axis=fast, slow_axis=slow,
                    compress_bits=bits), t)
            dfull, dnr = DT.det_reduce_bucket_full(
                b, sync_axes=tuple(names), compress_bits=bits,
                residuals=dr if ef else None)
            if not ef:
                dnr = dr
            lead = lambda x: x[None]
            return (tuple(map(lead, s)), tuple(map(lead, nr)), gn[None],
                    jax.tree.map(lead, tree), jax.tree.map(lead, per_tensor),
                    tuple(map(lead, dfull)), tuple(map(lead, dnr)))
        spec_all = P(names)
        got = jax.jit(PX.shard_map(
            rank, mesh=mesh,
            in_specs=(jax.tree.map(lambda _: spec_all, stacked),
                      (spec_all,) * len(hres), (spec_all,) * len(dres)),
            out_specs=spec_all, check_vma=False, axis_names=set(names)))(
                stacked, hres, dres)
        s, nr, gn, tree, pt, dfull, dnr = jax.tree.map(np.asarray, got)
        for i in range(n):
            key = f"{gname}/{sname}"
            out.setdefault(i, {})
            o = out[i]
            o[f"{key}/shards"] = [x[i] for x in s]
            o[f"{key}/gnorm"] = gn[i]
            o[f"{key}/tree"] = {"a": tree["a"][i], "b.c": tree["b"]["c"][i],
                                "d": tree["d"][i]}
            o[f"{key}/det_full"] = [x[i] for x in dfull]
            if ef:
                o[f"{key}/residuals"] = [x[i] for x in nr]
                o[f"{key}/det_residuals"] = [x[i] for x in dnr]
            else:
                o[f"{key}/per_tensor"] = {"a": pt["a"][i],
                                          "b.c": pt["b"]["c"][i],
                                          "d": pt["d"][i]}
        out[f"{gname}/n"] = n
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def both_sides(tmp_path_factory):
    import pickle
    inputs, residuals, dtypes = _inputs()
    d = tmp_path_factory.mktemp("collectives")
    spec = {"grids": R.GRIDS, "settings": R.SETTINGS, "inputs": inputs,
            "residuals": residuals, "bucket_bytes": BUCKET_BYTES}
    with open(d / "spec.pkl", "wb") as f:
        pickle.dump(spec, f)
    script = d / "reference.py"
    script.write_text(_REFERENCE)
    out = run_multidevice(
        f"import runpy, sys\nsys.argv = ['reference', {str(d / 'spec.pkl')!r},"
        f" {str(d / 'ref.pkl')!r}]\nrunpy.run_path({str(script)!r}, "
        f"run_name='__main__')\n", n_devices=4)
    assert "REFERENCE_OK" in out
    with open(d / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    port = run_ranks(R.collective_ranks, 4, threads=1, deadline_s=300,
                     args=(dict(spec, dtypes=dtypes),))
    return ref, port


def _bitwise(gname: str, sname: str, output: str) -> bool:
    """Two-value sums (or the fixed fold) on both sides: bitwise.  The
    4-rank reduce-scatter sums in gloo's ring order, not XLA's.  The int8
    hop's dequantize (``q * scale``) feeds a sum or a difference, which
    XLA's CPU backend contracts into fused multiply-adds inside the jitted
    rank function and eager PyTorch does not: 1-4 ulp apart, so the int8
    outputs are held at ``CLOSE``."""
    if sname.startswith("int8"):
        return False
    if output in ("det_full", "det_residuals"):
        return True
    return gname != "data4"


CASES = [(g, s, o) for g in R.GRIDS for s, (bits, ef) in R.SETTINGS.items()
         for o in (("shards", "shards_overlap", "tree", "det_full")
                   + (("residuals", "residuals_overlap", "det_residuals")
                      if ef else ("per_tensor",)))]


@pytest.mark.parametrize("gname,sname,output", CASES)
def test_multirank_outputs_match_reference(both_sides, gname, sname,
                                           output):
    ref, port = both_sides
    n = ref[f"{gname}/n"]
    key = f"{gname}/{sname}"
    ref_key = f"{key}/{output.replace('_overlap', '')}"
    for i in range(n):
        assert port[i][f"{gname}/grid_rank"] == i
        got, want = port[i][f"{key}/{output}"], ref[i][ref_key]
        if isinstance(want, dict):
            got, want = [got[k] for k in want], list(want.values())
        assert len(got) == len(want)
        for a, b in zip(got, want):
            b = np.asarray(b, np.float32)
            assert a.shape == b.shape, (a.shape, b.shape)
            if _bitwise(gname, sname, output):
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, **CLOSE)


@pytest.mark.parametrize("gname", list(R.GRIDS))
@pytest.mark.parametrize("sname", list(R.SETTINGS))
def test_multirank_global_norm_matches_reference(both_sides, gname, sname):
    ref, port = both_sides
    for i in range(ref[f"{gname}/n"]):
        np.testing.assert_allclose(port[i][f"{gname}/{sname}/gnorm"],
                                   ref[i][f"{gname}/{sname}/gnorm"], **NORM)


def test_multirank_ranks_hold_the_same_mean(both_sides):
    """After the all-gather every rank of a grid holds the same tree, and
    an uncompressed mean equals numpy's mean of the inputs."""
    _, port = both_sides
    inputs, _, _ = _inputs()
    for gname in R.GRIDS:
        n = int(np.prod(R.GRIDS[gname][0]))
        trees = [port[i][f"{gname}/f32/tree"] for i in range(n)]
        for k in trees[0]:
            for t in trees[1:]:
                np.testing.assert_array_equal(t[k], trees[0][k])
            want = np.mean([inputs[gname][i][k] for i in range(n)], axis=0)
            np.testing.assert_allclose(trees[0][k], want, **CLOSE)


@pytest.mark.parametrize("gname", list(R.GRIDS))
def test_multirank_named_collectives(both_sides, gname):
    """psum, pmean, pmax, the hierarchical and flat means, all_gather (in
    the axis's order) and the axis coordinates (pod-major) against numpy on
    the per-rank inputs."""
    _, port = both_sides
    inputs, _, _ = _inputs()
    shape, names = R.GRIDS[gname]
    n = int(np.prod(shape))
    xs = np.stack([inputs[gname][i]["a"] for i in range(n)])
    for i in range(n):
        got = port[i][f"{gname}/reductions"]
        coords = np.unravel_index(i, shape)
        assert got["index"] == dict(zip(names, map(int, coords)))
        assert got["size"] == dict(zip(names, shape))
        np.testing.assert_allclose(got["psum"], xs.sum(0), **CLOSE)
        np.testing.assert_allclose(got["pmean"], xs.mean(0), **CLOSE)
        np.testing.assert_array_equal(got["pmax"], xs.max(0))
        np.testing.assert_allclose(got["hier_mean"], xs.mean(0), **CLOSE)
        np.testing.assert_allclose(got["flat_mean"], xs.mean(0), **CLOSE)
        for k, name in enumerate(names):
            # the ranks along this axis through rank i, in coordinate order
            line = [int(np.ravel_multi_index(
                coords[:k] + (j,) + coords[k + 1:], shape))
                for j in range(shape[k])]
            np.testing.assert_array_equal(got[f"gather_{name}"], xs[line])
            np.testing.assert_array_equal(got[f"gather_flat_{name}"],
                                          xs[line].reshape(-1))


def test_run_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"
                       "(.|\n)*ZeroDivisionError"):
        run_ranks(R.fail_on_rank_one, 2, deadline_s=120)
    assert not multiprocessing.active_children()


def test_run_ranks_kills_a_job_past_its_deadline():
    with pytest.raises(TimeoutError, match="did not finish within 5 s"):
        run_ranks(R.sleep, 2, deadline_s=5)
    assert not multiprocessing.active_children()
