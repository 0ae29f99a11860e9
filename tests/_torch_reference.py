"""The reference's own test files run against both packages.

``reference_cases(name, package)`` executes ``tests/<name>.py`` as a
module: once with its imports as they are, and once with its imports of
the ported modules (``repro.core.*``, ``repro.cluster``, ``repro.faults``,
``repro.elastic`` and ``repro.ckpt``) read as ``repro_torch``'s.  Imports
of anything else (``repro.models``, jax) stay the reference's.
``case_params`` expands a case's ``pytest.mark.parametrize`` marks, so a
parametrised case runs over the reference's own parameters.
"""
import inspect
import itertools
import os
import re
import types

TESTS = os.path.dirname(os.path.abspath(__file__))
PACKAGES = ("repro", "repro_torch")

_CORE = ("profiles", "leaves", "job", "policy", "scheduler", "jct_model",
         "traces", "modes", "simulator", "metrics", "registry", "executor",
         "aggregation")
# ``from repro.<ported module> import ...``, ``from repro.core import
# profiles`` and ``from repro import ckpt``: the ``repro`` of each is
# read as ``repro_torch``
_PORTED = re.compile(
    r"^(\s*from\s+)repro(?=\.(?:core\.(?:" + "|".join(_CORE) + r")\b"
    r"|core\s+import\s+profiles\b|cluster\b|faults\b|elastic\b)"
    r"|\s+import\s+ckpt\b)", re.MULTILINE)


def reference_cases(name: str, package: str) -> types.ModuleType:
    """``tests/<name>.py`` executed as a module, its imports of the ported
    modules read as ``package``'s."""
    path = os.path.join(TESTS, name + ".py")
    with open(path) as f:
        src = f.read()
    if package == "repro_torch":
        src = _PORTED.sub(r"\1repro_torch", src)
    mod = types.ModuleType(f"{name}[{package}]")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def case_params(fn):
    """The keyword sets a case runs with: the product of its
    ``pytest.mark.parametrize`` marks ([{}] for a plain case)."""
    axes = []
    for mark in getattr(fn, "pytestmark", ()):
        if mark.name != "parametrize":
            continue
        names, values = mark.args[0], mark.args[1]
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        rows = [dict(zip(names, v if len(names) > 1 else (v,)))
                for v in values]
        axes.append(rows)
    return [dict(kv for row in combo for kv in row.items())
            for combo in itertools.product(*axes)]


def run_case(mod: types.ModuleType, case: str, tmp_path,
             params=None) -> None:
    fn = getattr(mod, case)
    kw = dict(params or {})
    if "tmp_path" in inspect.signature(fn).parameters:
        kw["tmp_path"] = tmp_path
    fn(**kw)
