"""The port stands on its own: no module of src/repro_torch/ nor
chip_smoke.py imports jax, the JAX package or ml_dtypes (the card machine
has none of them), and the entry points refuse to run on the CPU unless
asked to."""
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
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro|ml_dtypes)(?:[.\s,]|$)",
    re.MULTILINE)


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


CONTROL_PLANE = sorted(
    [os.path.join("core", n) for n in ("__init__.py", "profiles.py",
                                       "leaves.py", "job.py", "policy.py",
                                       "scheduler.py", "jct_model.py",
                                       "traces.py", "modes.py",
                                       "simulator.py", "metrics.py",
                                       "registry.py", "executor.py",
                                       "aggregation.py")]
    + [os.path.join("cluster", n) for n in ("__init__.py", "pool.py",
                                            "manager.py", "worker.py",
                                            "runtime.py")]
    + [os.path.join("launch", "cluster.py"),
       os.path.join("configs", "paper_workloads.py")])
# a string naming a module of the JAX package as something to run or
# import: ``python -m repro.launch.train``, ``"repro.elastic"``
JAX_ENTRY = re.compile(r"-m\s+repro\.|[\"']repro\.[a-z]")


@pytest.mark.parametrize("rel", CONTROL_PLANE)
def test_control_plane_sources_import_no_jax_nor_repro(rel):
    """The control plane, the simulator side and the cluster runtime are
    among the sources the walk above reads, and each imports only the
    port, lazily too."""
    path = os.path.join(PORT, rel)
    assert path in set(_port_sources())
    with open(path) as f:
        src = f.read()
    assert not FORBIDDEN.findall(src), rel
    assert not re.search(r"^\s*(?:import|from)\s+repro\b(?!_torch)", src,
                         re.MULTILINE), rel


TENSOR_PARALLEL = ["sharding.py", os.path.join("launch", "mesh.py"),
                   os.path.join("parallel", "tensor.py")]


@pytest.mark.parametrize("rel", TENSOR_PARALLEL)
def test_tensor_parallel_sources_import_no_jax_nor_repro(rel):
    """The rules, the production rules and the differentiable collectives
    of the ``model`` axis are among the sources the walk reads, and each
    imports only the port, lazily too."""
    path = os.path.join(PORT, rel)
    assert path in set(_port_sources())
    with open(path) as f:
        src = f.read()
    assert not FORBIDDEN.findall(src), rel
    assert not re.search(r"^\s*(?:import|from)\s+repro\b(?!_torch)", src,
                         re.MULTILINE), rel


def test_no_source_names_a_jax_entry_point():
    """No source of the port names a module of the JAX package to run
    or import (the executor's pod entry point is the port's launcher)."""
    for path in _port_sources():
        with open(path) as f:
            assert not JAX_ENTRY.findall(f.read()), path


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes')]\n"
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


ORPHANS = """
import multiprocessing as mp
import subprocess
import sys

sys.path.insert(0, {repo!r})
import chip_smoke


def rank(q):
    q.put(1)


if __name__ == "__main__":
    chip_smoke.adopt_orphans()
    q = mp.get_context("spawn").Queue()
    p = mp.get_context("spawn").Process(target=rank, args=(q,))
    p.start()
    q.get()
    p.join()
    del q
    # a worker in a session of its own that leaves a child running
    subprocess.run(["sh", "-c", "sleep 600 & exit 0"],
                   start_new_session=True, check=True)
    left = chip_smoke.stop_descendants()
    print(len(left), "sleep 600" in " ".join(left),
          len(chip_smoke.descendants()))
"""


def test_chip_smoke_stops_every_process_its_run_left(tmp_path):
    """chip_smoke.py adopts the orphans of the processes it starts and, when
    it ends, stops each one still running (here the child that a worker in
    its own session left behind) and closes multiprocessing's resource
    tracker, which a spawned rank started, so nothing outlives the run."""
    script = tmp_path / "orphans.py"
    script.write_text(ORPHANS.format(repo=REPO))
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=60, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "True", "0"], out.stdout
