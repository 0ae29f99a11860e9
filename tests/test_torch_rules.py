"""The port's logical-axis rules (``repro_torch/sharding.py``) against the
JAX package's ``repro/sharding.py``.

``make_rules``' dict, key for key, for every flag combination over a
duck-typed grid (both sides read only its axis names); the drop rule case
by case: the port's ``tree_shardings`` against the reference's for every
parameter leaf of llama3.2-1b at full width, and the port's ``split``
against the reference's ``shard`` under ``jit``, on ``jax.sharding.Mesh``es
of up to 8 fake CPU devices (one ``run_multidevice`` subprocess).  The
reference's meshes are built with ``Mesh(...)``: under jax 0.9
``jax.make_mesh`` builds Explicit axes, on which ``with_sharding_constraint``
refuses its specs (the cause of ``test_sharding_analysis::
test_rules_divisibility_dropping``'s failure here).
"""
import itertools
import json

import pytest

from repro import sharding as jsharding
from repro_torch import sharding
from repro_torch.launch.mesh import production_rules
from repro_torch.parallel.mesh import Axis, axes_size
from tests.conftest import run_multidevice

FLAGS = ("seq_shard", "long_ctx", "fsdp", "seq_parallel")
AXIS_NAMES = {"data_model": ("data", "model"),
              "pod_data_model": ("pod", "data", "model"),
              "data": ("data",), "model": ("model",),
              "pod_data": ("pod", "data")}
FLAG_SETS = [dict(zip(FLAGS, v))
             for v in itertools.product((False, True), repeat=len(FLAGS))]


class _Grid:
    """A grid's axis names and sizes (rank 0's view), without a job."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))
        self.member = True

    def axis(self, name):
        if name not in self.shape:
            return None
        return Axis(name, self.shape[name], 0, None)


def _flag_id(flags):
    return "-".join(k for k, v in flags.items() if v) or "defaults"


@pytest.mark.parametrize("flags", FLAG_SETS, ids=map(_flag_id, FLAG_SETS))
@pytest.mark.parametrize("names", list(AXIS_NAMES))
def test_make_rules_matches_reference(names, flags):
    axes = AXIS_NAMES[names]
    grid = _Grid((2,) * len(axes), axes)
    got = sharding.make_rules(grid, **flags)
    want = jsharding.make_rules(grid, **flags)
    assert got.rules == want.rules
    assert got.mesh is grid
    assert sharding.batch_axes(got) == jsharding.batch_axes(want)
    assert sharding.model_axes(got) == jsharding.model_axes(want)
    for drop in (frozenset({"model"}), frozenset({"pod", "data"})):
        assert sharding.without_axes(got, drop).rules == \
            jsharding.without_axes(want, drop).rules


def test_single_device_and_production_rules_match_reference():
    assert sharding.single_device_rules().rules == \
        jsharding.single_device_rules().rules
    grid = _Grid((2, 4), ("data", "model"))
    for kw in ({}, dict(long_ctx=True), dict(seq_shard=True)):
        assert production_rules(grid, **kw).rules == \
            jsharding.make_rules(grid, **kw).rules
    with pytest.raises(KeyError, match="unknown logical axis"):
        sharding.make_rules(grid).to_pspec(("nope",))


def test_use_rules_nests_and_restores():
    grid = _Grid((1, 4), ("data", "model"))
    rules = sharding.make_rules(grid)
    assert sharding.current_rules() is None
    with sharding.use_rules(rules):
        assert sharding.current_rules() is rules
        assert sharding.split((8, 4), "batch", "heads") == ("data", "model")
        with sharding.use_rules(None):
            assert sharding.split((8, 4), "batch", "heads") == (None, None)
        p = sharding.part(8, "vocab")
        assert (p.n, p.lo, p.hi) == (4, 0, 2)
        assert [a.name for a in sharding.tensor_axes()] == ["model"]
    assert sharding.current_rules() is None


# the reference's meshes: (shape, axis names, make_rules flags)
MESHES = {
    "2x4": ((2, 4), ("data", "model"), {}),
    "4x2": ((4, 2), ("data", "model"), {}),
    "1x8": ((1, 8), ("data", "model"), {}),
    "8x1": ((8, 1), ("data", "model"), {}),
    "2x3": ((2, 3), ("data", "model"), {}),
    "1x6": ((1, 6), ("data", "model"), {}),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model"), {}),
    "data8": ((8,), ("data",), {}),
    "2x4_no_fsdp": ((2, 4), ("data", "model"), dict(fsdp=False)),
    "2x4_seq_shard": ((2, 4), ("data", "model"), dict(seq_shard=True)),
    "2x4_long_ctx": ((2, 4), ("data", "model"), dict(long_ctx=True)),
    "2x4_seq_parallel": ((2, 4), ("data", "model"),
                         dict(seq_parallel=True)),
}
# (shape, logical axes) of the models' annotations, at sizes around the
# meshes' axes: 6 heads, d_ff 150, vocab 510 and batches of 1 and 6 do not
# divide some of them
CASES = []
for b in (1, 6, 8):
    CASES.append(((b, 2, 6, 2), ("batch", None, "heads", None)))
    CASES.append(((b, 24, 2, 2), ("kv_batch", "kv_seq", None, None)))
    CASES.append(((b, 8, 4), ("batch", "seq", None)))
for h in (2, 8, 32):
    CASES.append(((4, 2, h, 2), ("batch", None, "heads", None)))
    CASES.append(((4, 2, h, 2), ("batch", None, "kv_heads", None)))
for f in (150, 256):
    CASES.append(((2, 2, f), ("batch", None, "ff")))
for v in (510, 512):
    CASES.append(((2, 2, v), ("batch", None, "vocab")))
CASES.append(((4, 6, 2), ("batch", None)))          # a trailing dim unnamed
# the meshes whose ``shard`` runs under jit (a compile each)
SHARD_MESHES = ("2x4", "2x3", "2x2x2", "2x4_seq_parallel")

REF_CODE = r'''
import json
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.models.registry import build_model, get_config
from repro.sharding import make_rules, shard, tree_shardings, use_rules

spec = json.loads(%r)
model = build_model(get_config("llama3.2-1b"), remat=False)
shapes = jax.eval_shape(model.init, jax.random.key(0))
axes = model.param_logical_axes()
is_leaf = lambda v: isinstance(v, tuple) and all(
    isinstance(x, (str, type(None))) for x in v)
key = jax.tree_util.keystr
out = {"shapes": {key(k): list(v.shape) for k, v in
                  jax.tree_util.tree_leaves_with_path(shapes)},
       "axes": {key(k): list(v) for k, v in
                jax.tree_util.tree_leaves_with_path(axes, is_leaf=is_leaf)},
       "meshes": {}}


def spec_of(s):
    return [list(a) if isinstance(a, tuple) else a for a in s]


for name, (shape, names, flags) in spec["meshes"].items():
    n = int(np.prod(shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), tuple(names))
    rules = make_rules(mesh, **flags)
    sh = tree_shardings(mesh, rules, shapes, axes)
    got = {"params": {key(k): spec_of(v.spec) for k, v in
                      jax.tree_util.tree_leaves_with_path(sh)}}
    out["meshes"][name] = got
    if name not in spec["shard_meshes"]:
        continue

    def f(xs):        # every case in one program: one compile a mesh
        with use_rules(rules):
            return [shard(x, *logical)
                    for x, (_, logical) in zip(xs, spec["cases"])]

    with mesh:
        ys = jax.jit(f)([jnp.zeros(c, jnp.float32)
                         for c, _ in spec["cases"]])
    got["cases"] = [spec_of(y.sharding.spec) for y in ys]
print("REF" + json.dumps(out))
'''


@pytest.fixture(scope="module")
def reference():
    spec = {"meshes": MESHES, "cases": CASES, "shard_meshes": SHARD_MESHES}
    stdout = run_multidevice(REF_CODE % json.dumps(spec), n_devices=8)
    line = [ln for ln in stdout.splitlines() if ln.startswith("REF")][-1]
    return json.loads(line[3:])


def _tuple(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def _live(spec, ndim, grid):
    """A spec as the grid axes of size above 1 that split each of ``ndim``
    dimensions (jit's output spec drops trailing Nones)."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    out = []
    for ax in spec:
        names = (ax,) if isinstance(ax, str) else tuple(ax or ())
        live = tuple(a for a in names if grid.shape[a] > 1)
        out.append(live[0] if len(live) == 1 else (live or None))
    return tuple(out)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_tree_shardings_match_reference_for_every_llama_leaf(reference,
                                                             mesh):
    """The drop rule on each parameter of llama3.2-1b at full width: the
    port's ``tree_shardings`` is the reference's spec for spec."""
    shape, names, flags = MESHES[mesh]
    grid = _Grid(shape, names)
    rules = sharding.make_rules(grid, **flags)
    ref = reference["meshes"][mesh]["params"]
    got = sharding.tree_shardings(
        grid, rules, {k: tuple(v) for k, v in reference["shapes"].items()},
        {k: tuple(v) for k, v in reference["axes"].items()})
    assert set(got) == set(ref) and len(ref) >= 11
    for leaf, want in ref.items():
        assert got[leaf] == _tuple(want), leaf


@pytest.mark.parametrize("mesh", SHARD_MESHES)
def test_split_matches_reference_shard(reference, mesh):
    """``split``, the one place the port's models ask, against the
    reference's ``shard`` under ``jit`` on its mesh: the same grid axes
    split the same dimensions, every case."""
    shape, names, flags = MESHES[mesh]
    grid = _Grid(shape, names)
    rules = sharding.make_rules(grid, **flags)
    for (cshape, logical), want in zip(CASES,
                                       reference["meshes"][mesh]["cases"]):
        got = sharding.split(cshape, *logical, rules=rules)
        assert _live(got, len(cshape), grid) == \
            _live(want, len(cshape), grid), (cshape, logical)
        # part(), one dimension of it: as many parts as the axes' ranks
        names_ = tuple(logical) + (None,) * (len(cshape) - len(logical))
        for dim, name, ax in zip(cshape, names_, got):
            assert sharding.part(dim, name, rules=rules).n == \
                axes_size(grid, ax)
