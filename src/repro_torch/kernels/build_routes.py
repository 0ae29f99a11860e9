"""Time three ways to build and bind the port's CUDA kernels.

    PYTHONPATH=src python -m repro_torch.kernels.build_routes

Run it on a machine with the card and ``nvcc``.  Each route builds the same
``kernel.cu`` of every kernel from nothing, into a fresh directory under
``build/build_routes/``, and is held against the first on one small input:

  load_cpp  the port's route (``_build.extension``):
            ``torch.utils.cpp_extension.load`` of the kernels and
            ``binding.cpp``, whose PyTorch headers the host compiler reads.
  load_cu   the same, with the binding staged as a ``.cu`` so that ``nvcc``
            reads the PyTorch headers, as when a kernel and its binding share
            one source.
  ctypes    ``nvcc`` on each ``kernel.cu`` alone into a shared library, one
            process per source in parallel, called through ``ctypes``.

It also times the host's cost of one call through each binding (allocate
the output, launch) at the decode step's RMSNorm shape, (8, 2048) bf16, and
of one call of the port's ``rmsnorm`` op, which checks its inputs first.
Prints one JSON line per route; exits 1 if a route failed or disagreed.
"""
from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import _build

ROOT = _build.BUILD_DIR.parent / "build_routes"
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _fresh(name: str) -> Path:
    d = ROOT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def build_load_cpp():
    _build.BUILD_DIR = _fresh("load_cpp")
    t0 = time.perf_counter()
    ext = _build.extension()
    return time.perf_counter() - t0, ext.rmsnorm, \
        lambda q, k, v: ext.flash_attention(q, k, v, True, 0.0)


def build_load_cu():
    t0 = time.perf_counter()
    ext = _build.load_extension(_fresh("load_cu"), binding="binding.cu",
                                name="repro_torch_load_cu")
    return time.perf_counter() - t0, ext.rmsnorm, \
        lambda q, k, v: ext.flash_attention(q, k, v, True, 0.0)


def build_ctypes():
    from torch.utils.cpp_extension import CUDA_HOME
    d = _fresh("ctypes")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(_build.COMMON),
         "-o", str(d / f"{k}.so"),
         str(_build._PKG / k / "kernel.cu")]) for k in _build.KERNELS}
    for k, p in procs.items():
        if p.wait() != 0:
            raise RuntimeError(f"nvcc failed for {k}")
    libs = {k: ctypes.CDLL(str(d / f"{k}.so")) for k in _build.KERNELS}
    seconds = time.perf_counter() - t0
    rms_fn = libs["rmsnorm"].rmsnorm_forward
    rms_fn.argtypes = [P, P, P, I, I, F, I, P]
    attn_fn = libs["flash_attention"].flash_attention_forward
    attn_fn.argtypes = [P, P, P, P, I, I, I, I, I, I, F, F, I, P]
    rms_fn.restype = attn_fn.restype = I

    def check(err):
        if err != 0:
            raise RuntimeError(f"kernel launch failed: cudaError {err}")

    def rms(x, w, eps):
        out = torch.empty_like(x)
        check(rms_fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                     x.numel() // x.shape[-1], x.shape[-1], eps, 1,
                     torch.cuda.current_stream().cuda_stream))
        return out

    def attn(q, k, v):
        out = torch.empty_like(q)
        B, S, H, D = q.shape
        check(attn_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), B, S, H, k.shape[2], D, 1, D ** -0.5,
                      0.0, 1, torch.cuda.current_stream().cuda_stream))
        return out
    return seconds, rms, attn


def host_us_per_call(fn, n: int = 2000) -> float:
    """Wall time per call of back-to-back launches: the host's cost when
    each launch's device work is shorter than it."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("build_routes: no CUDA device", file=sys.stderr)
        return 1
    from torch.utils.cpp_extension import is_ninja_available
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 2048, generator=g, device=dev).bfloat16()
    w = torch.randn(2048, generator=g, device=dev)
    q = torch.randn(2, 192, 8, 64, generator=g, device=dev).bfloat16()
    k = torch.randn(2, 192, 2, 64, generator=g, device=dev).bfloat16()
    v = torch.randn(2, 192, 2, 64, generator=g, device=dev).bfloat16()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "ninja": is_ninja_available(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    ok, ref = True, None
    for route, build in (("load_cpp", build_load_cpp),
                         ("ctypes", build_ctypes),
                         ("load_cu", build_load_cu)):
        try:
            seconds, rms, attn = build()
        except Exception as e:  # a route that fails to build is a result
            ok = False
            print(json.dumps({"route": route, "error": repr(e)[-2000:]}),
                  flush=True)
            continue
        outs = (rms(x, w, 1e-5), attn(q, k, v))
        ref = ref or outs
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(outs, ref))
        ok &= err == 0.0
        line = {"route": route, "build_seconds": seconds,
                "max_abs_diff_vs_load_cpp": err,
                "host_us_per_rmsnorm_call": host_us_per_call(
                    lambda: rms(x, w, 1e-5))}
        if route == "load_cpp":
            line["host_us_per_rmsnorm_op_call"] = host_us_per_call(
                lambda: rmsnorm(x, w))
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
