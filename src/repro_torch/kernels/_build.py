"""Build and load the port's CUDA kernels.

Each kernel's ``kernel.cu`` has a plain C entry point.  ``binding.cpp``, the
only source that includes ``torch/extension.h``, wraps each entry point as a
function on tensors.  ``torch.utils.cpp_extension.load`` compiles the
sources for ``sm_90a`` into one extension, ninja running one compiler per
source in parallel.  The binding is a ``.cpp`` for the host compiler rather
than a ``.cu`` for nvcc: on an H100 machine with 8 cores (torch 2.11, CUDA
12.8) the build took 42 s, and 362 s with the binding in a ``.cu``
(``python -m repro_torch.kernels.build_routes``).

The kernels' shared headers (``common/*.cuh``, the tensor-core building
blocks) are staged beside them and their directory is passed as an include
path, so each ``kernel.cu`` includes them by name from the staged copy as
from the source tree.

The extension is built into ``build/repro_torch_ext/`` at the repository
root (listed in ``.gitignore``) and ``load`` rebuilds only what changed.
Nothing is built at import time: the first launch builds, or ``extension()``
builds ahead of it.
"""
from __future__ import annotations

from pathlib import Path
from typing import List

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch_ext"
# <name>/kernel.cu
KERNELS = ("rmsnorm", "flash_attention", "mamba_scan", "mlstm")
COMMON = _PKG / "common"      # headers the kernels include by name
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]

_ext = None


class Kernel:
    """A kernel's launch count.  Its op wrapper adds one each time it
    launches the kernel, and nowhere else, so a run can show which kernels
    its path took."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def load_extension(build_dir: Path, *, binding: str = "binding.cpp",
                   name: str = "repro_torch_ext"):
    """Compile (or load, when unchanged) the kernels and the binding in
    ``build_dir``, the binding staged under the file name ``binding``.

    ninja names each object after its source's file name and every kernel's
    source is a ``kernel.cu``, so the sources are staged in ``build_dir`` as
    ``<name>.cu``, and the shared headers in ``build_dir/include``; a staged
    file is rewritten only when its source changed, so an unchanged kernel
    is not rebuilt and a changed header rebuilds the kernels that include
    it (ninja reads nvcc's dependency files).
    """
    from torch.utils.cpp_extension import load
    staged_dir = build_dir / "src"
    include_dir = build_dir / "include"
    staged_dir.mkdir(parents=True, exist_ok=True)
    include_dir.mkdir(parents=True, exist_ok=True)
    pairs = [(_PKG / k / "kernel.cu", staged_dir / f"{k}.cu")
             for k in KERNELS]
    pairs.append((_PKG / "binding.cpp", staged_dir / binding))
    headers = [(h, include_dir / h.name)
               for h in sorted(COMMON.glob("*.cuh"))]
    for origin, staged in pairs + headers:
        data = origin.read_bytes()
        if not staged.exists() or staged.read_bytes() != data:
            staged.write_bytes(data)
    sources = [str(staged) for _, staged in pairs]
    return load(name=name, sources=sources, build_directory=str(build_dir),
                extra_cuda_cflags=CUDA_FLAGS,
                extra_include_paths=[str(include_dir)], verbose=False)


def extension():
    """The port's kernels as one extension module, built on first use."""
    global _ext
    if _ext is None:
        _ext = load_extension(BUILD_DIR)
    return _ext


def all_kernels() -> List[Kernel]:
    from repro_torch.kernels.flash_attention.ops import FLASH_ATTENTION
    from repro_torch.kernels.mamba_scan.ops import SSD
    from repro_torch.kernels.mlstm.ops import MLSTM
    from repro_torch.kernels.rmsnorm.ops import RMSNORM
    return [RMSNORM, FLASH_ATTENTION, SSD, MLSTM]
