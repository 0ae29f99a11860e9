"""The port stands on its own: no module of src/repro_torch/ nor
chip_smoke.py imports jax or the JAX package, and the entry points refuse
to run on the CPU unless asked to."""
import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.models.registry import ARCH_IDS, _NOT_PORTED, \
    build_model, get_config, reduced_config
from repro_torch.serve import BatchedServer, make_prefill_step, \
    make_serve_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[.\s,]|$)", re.MULTILINE)


def _port_sources():
    for root, _, files in os.walk(PORT):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def test_sources_import_no_jax_nor_repro():
    sources = list(_port_sources())
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            hits = FORBIDDEN.findall(f.read())
        assert not hits, f"{path} imports {hits}"


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_build_model_without_device_raises_without_card(no_cuda, arch):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(reduced_config(get_config(arch)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_entry_points_without_device_raise_without_card(no_cuda, arch):
    model = build_model(reduced_config(get_config(arch)),
                        device="cpu", seed=0)
    for entry in (make_prefill_step, make_serve_step, BatchedServer):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry(model)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launcher_without_device_raises_without_card(no_cuda, arch):
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", arch, "--requests", "1"])


def test_launcher_serves_each_arch_on_the_cpu(capsys):
    from repro_torch.launch.serve import main
    for arch in ARCH_IDS:
        main(["--arch", arch, "--device", "cpu", "--requests", "2",
              "--max-new", "3"])
        lines = capsys.readouterr().out.splitlines()
        assert [ln.split(":")[0] for ln in lines] == ["request 0",
                                                       "request 1"]


def test_unported_families_name_their_roadmap_item():
    assert "zamba2-1.2b" not in _NOT_PORTED
    assert "xlstm-125m" not in _NOT_PORTED
    for arch in _NOT_PORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            get_config(arch)
