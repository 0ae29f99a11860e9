#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one ``phase <name>: {...}`` line:

1. build    -- compile every CUDA kernel of the serving path and its
               binding from the sources in this checkout, with
               torch.utils.cpp_extension.load (one compiler per source, in
               parallel).
2. kernels  -- hold each kernel against its plain PyTorch version on the
               card (f32 2e-5, bf16 2e-2, as tests/test_kernels.py), with
               its time and the time of the library call for the same
               function (a yardstick only; the port never calls it).
3. prefill  -- full-width llama3.2-1b (random weights from a seed, bf16),
               B=4, S=1024 through ``make_prefill_step`` with the kernels,
               against the same model and weights on the plain path.
4. serve    -- ``BatchedServer`` at full width, max_batch 8, max_seq 1024,
               16 requests of 8-64 prompt tokens and 32 new tokens each;
               plus decode against prefill logits on one short sequence.
5. profile  -- device time by kernel of one prefill and one decode step.

Launch counts are set to 0 just before the main path (prefill + serve) and
read just after; the run fails if a kernel of the path was never launched.
The line before the last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

# published peaks of one H100 SXM (dense), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SEED = 0


def emit(phase: str, **fields) -> None:
    print(f"phase {phase}: {json.dumps(fields)}", flush=True)


def cuda_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def device_kernels(torch, fn) -> dict:
    """The device kernels one call of ``fn`` launches: name -> count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {ev.key[:96]: ev.count for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA}


def check_close(torch, name, out, ref, dtype) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), **TOL[dtype]):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e}, "
                             f"tolerance {TOL[dtype]})")
    return err


# --------------------------------------------------------------- phases

def phase_build(torch):
    from repro_torch.kernels._build import extension
    t0 = time.perf_counter()
    extension()
    emit("build", seconds=time.perf_counter() - t0)


def phase_kernels(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    table = {}

    # K1: the serving path's shapes are (B*S, 2048) in prefill and
    # (max_batch, 2048) in decode; bf16 x with f32 weights
    for R, D in [(100, 96), (256, 512), (8, 2048), (4 * 1024, 2048)]:
        for dname, dt in dts.items():
            x = torch.randn(R, D, generator=g, device=dev).to(dt)
            w = torch.randn(D, generator=g, device=dev)
            err = check_close(torch, f"rmsnorm ({R},{D}) {dname}",
                              rmsnorm(x, w), rmsnorm_ref(x, w), dname)
            ms = cuda_ms(torch, lambda: rmsnorm(x, w))
            lib = cuda_ms(torch, lambda: F.rms_norm(x, (D,), w, 1e-5))
            print(f"  rmsnorm R={R} D={D} {dname} err={err:.3e} "
                  f"ms={ms:.5f} library_ms={lib:.5f}", flush=True)
            if (R, D, dname) == (4 * 1024, 2048, "bfloat16"):
                plain = cuda_ms(torch, lambda: rmsnorm_ref(x, w))
                n_bytes = 2 * x.numel() * x.element_size() + 4 * D
                bms, by = bound_ms(n_bytes, 4 * x.numel(), "float32")
                table["rmsnorm"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib, shape=[R, D],
                    dtype=dname, library_kernels=device_kernels(
                        torch, lambda: F.rms_norm(x, (D,), w, 1e-5)))

    # K2: the serving path's prefill is B=4, S=1024, H:Kv=32:8, D=64, causal
    cases = [(2, S, H, Kv, D, causal, dname, 0.0)
             for S in (128, 192, 1024) for H, Kv in ((32, 8), (4, 4), (2, 1))
             for D in (32, 64, 128) for causal in (True, False)
             for dname in dts]
    # ragged tails: S not a multiple of the kernel's 64-row / 32-key tiles
    cases += [(2, S, 32, 8, D, causal, dname, 0.0)
              for S in (200, 1000) for D in (64, 128)
              for causal in (True, False) for dname in dts]
    cases += [(1, 128, 2, 2, 32, True, "float32", 20.0),
              (4, 1024, 32, 8, 64, True, "bfloat16", 0.0)]
    for B, S, H, Kv, D, causal, dname, cap in cases:
        dt = dts[dname]
        q = torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, Kv, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, Kv, D, generator=g, device=dev).to(dt)
        run = lambda: flash_attention(q, k, v, causal=causal,  # noqa: E731
                                      softcap=cap)
        ref = attention_ref(q, k, v, causal=causal, softcap=cap)
        err = check_close(torch, f"flash_attention B={B} S={S} H={H}:{Kv} "
                          f"D={D} causal={causal} {dname} softcap={cap}",
                          run(), ref, dname)
        del ref
        ms = cuda_ms(torch, run, iters=5)
        lib = None
        if cap == 0.0:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), iters=5)
        lib_txt = "none" if lib is None else f"{lib:.4f}"
        print(f"  flash_attention B={B} S={S} H={H}:{Kv} D={D} "
              f"causal={int(causal)} {dname} softcap={cap} err={err:.3e} "
              f"ms={ms:.4f} library_ms={lib_txt}", flush=True)
        if (B, S, H, Kv, D, causal, dname, cap) == cases[-1]:
            plain = cuda_ms(torch, lambda: attention_ref(
                q, k, v, causal=causal), iters=3)
            pairs = S * (S + 1) // 2 if causal else S * S
            flops = 4 * D * pairs * B * H          # QK^T and P.V
            # q, k, v in; o (the size of q) out
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            bms, by = bound_ms(n_bytes, flops, dname)
            table["flash_attention"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, shape=[B, S, H, Kv, D],
                dtype=dname, causal=causal, library_kernels=device_kernels(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True)))
    emit("kernels", cases_rmsnorm=8, cases_flash_attention=len(cases),
         main_shapes=table)
    return table


def _quantile_top(torch, x, q: float) -> float:
    """Upper quantile of a large tensor (torch.quantile caps its input
    size): the smallest of the top (1 - q) share."""
    flat = x.flatten()
    k = max(1, int(math.ceil((1.0 - q) * flat.numel())))
    return torch.topk(flat, k, sorted=False).values.min().item()


def phase_prefill(torch, dev, model, cfg, launches):
    from repro_torch.serve import make_prefill_step
    B, S = 4, 1024
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)))
    step = make_prefill_step(model, device=dev)

    def timed(n):
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, sorted(times)[len(times) // 2]

    model.use_kernels = True
    launches.reset()
    logits, t_kernel = timed(4)
    launches.read("prefill")
    model.use_kernels = False
    before = launches.snapshot()
    plain, t_plain = timed(2)
    model.use_kernels = True
    if launches.snapshot() != before:
        raise AssertionError("the plain path launched a kernel")

    if tuple(logits.shape) != (B, S, cfg.vocab_size) or \
            logits.dtype != torch.float32:
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype}")
    if not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not all finite")
    diff = (logits - plain).abs()
    p999, dmax = _quantile_top(torch, diff, 0.999), diff.max().item()
    agree = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
    del diff, plain, logits
    # the bound of tests/test_decode_consistency.py
    if not (p999 < 0.2 and dmax < 0.5 and agree > 0.9):
        raise AssertionError(f"prefill with kernels vs plain path: p99.9 "
                             f"|dlogit| {p999}, max {dmax}, top-1 {agree}")
    emit("prefill", batch=B, seq=S, seconds=t_kernel,
         tokens_per_s=B * S / t_kernel, plain_seconds=t_plain,
         p999_abs_dlogit=p999, max_abs_dlogit=dmax, top1_agreement=agree,
         launches=launches.phases["prefill"])


def phase_serve(torch, dev, model, cfg, launches):
    from repro_torch.serve import BatchedServer, Request
    n_req, max_new = 16, 32
    server = BatchedServer(model, max_batch=8, max_seq=1024, device=dev)
    rng = np.random.default_rng(SEED)
    for rid in range(n_req):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=int(rng.integers(8, 65))).astype(np.int32)
        server.submit(Request(rid, prompt, max_new=max_new))
    inner, finite = server.step_fn, []

    def checked_step(cache, toks, pos):
        logits, cache = inner(cache, toks, pos)
        finite.append(torch.isfinite(logits).all())
        return logits, cache

    server.step_fn = checked_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    launches.reset()
    t0 = time.perf_counter()
    server.run_until_drained()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches.read("serve")
    done = sorted(server.completed, key=lambda r: r.rid)
    if len(done) != n_req or any(len(r.out) != max_new for r in done):
        raise AssertionError(f"served {len(done)} of {n_req} requests; "
                             f"lengths {[len(r.out) for r in done]}")
    if not torch.stack(finite).all():
        raise AssertionError("a decode step produced a non-finite logit")
    out_tokens = n_req * max_new
    emit("serve", requests=n_req, decode_steps=server.pos, seconds=seconds,
         output_tokens_per_s=out_tokens / seconds,
         ms_per_decode_step=seconds / server.pos * 1e3,
         peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
         launches=launches.phases["serve"])
    del server

    # decode reproduces the prefill's logits on one short sequence (the
    # JAX package's tests/test_decode_consistency.py check, at full width)
    S = 64
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, S))).to(dev)
    with torch.inference_mode():
        full = model.forward_logits(toks)
        cache = model.init_cache(1, S)
        dec = torch.cat([model.decode_step(cache, toks[:, t:t + 1], t)[0]
                         for t in range(S)], dim=1)
    diff = (full - dec).abs()
    p999, dmax = _quantile_top(torch, diff, 0.999), diff.max().item()
    agree = (full.argmax(-1) == dec.argmax(-1)).float().mean().item()
    if not (p999 < 0.2 and dmax < 0.5 and agree > 0.9):
        raise AssertionError(f"decode vs prefill: p99.9 {p999}, max {dmax}, "
                             f"top-1 {agree}")
    emit("decode_consistency", seq=S, p999_abs_dlogit=p999,
         max_abs_dlogit=dmax, top1_agreement=agree)


def phase_profile(torch, dev, model, cfg):
    """Device time by kernel for one prefill and one decode step at the
    served shapes (torch.profiler; kernel times sum to the busy time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import make_prefill_step, make_serve_step
    rng = np.random.default_rng(SEED + 2)
    prefill = make_prefill_step(model, device=dev)
    step = make_serve_step(model, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1024)))
    cache = model.init_cache(8, 1024)
    dtoks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1)))
    for name, fn, n in (("prefill", lambda: prefill(toks), 2),
                        ("decode_step", lambda: step(cache, dtoks, 100), 8)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        by_kernel = {}
        for ev in prof.key_averages():
            # device-side events only: a CPU op's device time repeats the
            # time of the kernels it launched
            if ev.device_type != DeviceType.CUDA:
                continue
            us = ev.self_device_time_total
            if us > 0:
                by_kernel[ev.key[:48]] = by_kernel.get(ev.key[:48], 0.0) \
                    + us / 1e3 / n
        device_ms = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        emit(f"profile_{name}",
             device_ms=device_ms if device_ms else "not measured",
             profiled_wall_ms=wall_ms,
             top_kernels_ms={k: round(v, 4) for k, v in top})


class Launches:
    """Per-phase launch counts of the kernels' wrappers."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.phases = {}

    def reset(self):
        for k in self.kernels:
            k.launches = 0

    def snapshot(self):
        return {k.name: k.launches for k in self.kernels}

    def read(self, phase):
        self.phases[phase] = self.snapshot()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    from repro_torch.kernels._build import all_kernels
    from repro_torch.models.registry import build_model, get_config

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    kernels = all_kernels()
    phase_build(torch)
    table = phase_kernels(torch, dev)

    cfg = get_config("llama3.2-1b")
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev, seed=SEED)
    torch.cuda.synchronize()
    emit("init", arch=cfg.arch_id, seconds=time.perf_counter() - t0,
         params=sum(p.numel() for p in model.parameters()))
    launches = Launches(kernels)
    phase_prefill(torch, dev, model, cfg, launches)
    phase_serve(torch, dev, model, cfg, launches)
    phase_profile(torch, dev, model, cfg)

    sources = {"rmsnorm": ("src/repro_torch/kernels/rmsnorm/kernel.cu",
                           "src/repro/kernels/rmsnorm/kernel.py:19"),
               "flash_attention": (
                   "src/repro_torch/kernels/flash_attention/kernel.cu",
                   "src/repro/kernels/flash_attention/kernel.py:78")}
    rows = []
    for k in kernels:
        total = sum(p[k.name] for p in launches.phases.values())
        if total == 0:
            raise AssertionError(f"kernel {k.name} was never launched on "
                                 f"the main path")
        by_phase = {ph: p[k.name] for ph, p in launches.phases.items()}
        held = [ph for ph, n in by_phase.items() if n]
        print(f"kernel {k.name}: launches {total} on the main path, by "
              f"phase {by_phase}; held in {', '.join(held)}", flush=True)
        t = table[k.name]
        rows.append({"name": k.name, "route": "cuda",
                     "source": sources[k.name][0],
                     "replaces": sources[k.name][1], "launches": total,
                     "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
