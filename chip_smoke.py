#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Everything it prints also goes to ``chiprun_out/chip_smoke.log`` in the
checkout.  Phases, each printing one ``phase <name>: {...}`` line:

1. build    -- compile every CUDA kernel of the serving paths and their
               binding from the sources in this checkout, with
               torch.utils.cpp_extension.load (one compiler per source, in
               parallel); beside it, ``nvcc -Xptxas -v`` of the sources of
               the bf16 tensor-core kernels (K2, K3, K4) and of K1 reports
               their registers, spills and static shared memory, and
               ``cuobjdump -sass`` their HMMA instructions: none in a
               tensor-core kernel fails the run.
2. kernels  -- hold each kernel against its plain PyTorch version on the
               card, at each kernel's own tolerance (``TOL``), with its
               time, the plain version's time and the time of the library
               call for the same function where there is one (a yardstick
               only; the port never calls it).  f32 cases run K2's, K3's
               and K4's scalar kernels, bf16 cases their tensor-core
               kernels; the serving shapes' rows add TFLOP/s, the share of
               the bound and the time over the library call's, and K4's
               row the device kernels one call issues.  K1 is timed at
               every serving shape, (4096, D) and (8, D) at D 2048, 4096,
               1536 and 768, in f32 and bf16, by the profiler's device time
               with L2 cold (its share of the bytes bound) and warm; every
               K1 case must launch the route its D, dtype and alignment
               give (``rmsnorm_route_for``), by the profiler's kernel names.
               K1 and K2 under autograd (forward the kernel, backward the
               plain version's gradient) must give the plain version's input
               gradients bitwise, at the serving shapes in f32 and bf16; K3
               and K4, which have no backward, must refuse inputs that need
               grad; and ``torch.mm(..., out_dtype=f32)`` must still have no
               derivative (the reason ``LogitsFn`` exists).
3. per model, llama3.2-1b (dense), zamba2-1.2b (hybrid: Mamba2 blocks and
   a shared attention block) and xlstm-125m (ssm: mLSTM and sLSTM blocks),
   each at its published widths and full depth, random weights from a
   seed, bf16:
   init     -- build the model on the card.
   prefill  -- B=4, S=1024 through ``make_prefill_step`` with the kernels,
               against the same model and weights on the plain path.
   serve    -- ``BatchedServer``, max_batch 8, max_seq 1024, 16 requests of
               8-64 prompt tokens and 32 new tokens each; plus decode
               against prefill logits on one sequence of 64 tokens.
   profile  -- device time by kernel of one prefill and one decode step
               (and, for xlstm-125m, of one sLSTM block's prefill), K1's
               among them; every K1 kernel there must be its vector route.
4. train    -- llama3.2-1b at full width, bf16 params, f32 masters, random
               weights from a seed: 6 steps of ``make_train_step`` (global
               batch 8 x 1024 from ``SyntheticCorpus``, accum 2, remat,
               AdamW) with K1 and K2 under autograd, then the same steps on
               the plain path from the same weights.  Every parameter must
               get a finite, nonzero gradient near the plain path's, K1 and
               K2 must launch as the config gives
               (``expected_train_launches``), the loss must fall, and each step's loss and grad norm must
               lie within ``TRAIN_LOSS_ATOL`` / ``TRAIN_GNORM_RTOL`` of the
               plain path's.  AdamW updates the state in place: the
               steps' peak of allocated memory must lie
               ``TRAIN_PEAK_DROP_GIB`` below the functional update's
               (``TRAIN_FUNCTIONAL_PEAK_GIB``), and the same steps with the
               state cloned before each step must give the same losses and
               every leaf of params, mu, nu and masters bit for bit
               (``state_fingerprint``).  Prints step ms, tokens/s, peak
               GiB, the model-FLOPs share and a profile of one step
               (loss-and-grad and AdamW apart).  Then one step of a 2-layer model at the same
               widths on the card against the CPU: loss and grad norm
               (``CARD_VS_CPU_RTOL``) and every leaf's gradient by norm
               (``CARD_VS_CPU_LEAF_RTOL``).
5. sync     -- the two-tier gradient sync: the single-rank step (accum x
               ranks microbatches) as the oracle, then 4 gloo ranks, each
               a process on this card (``sync_rank``; they send their
               numbers to this process, which alone prints), train
               llama3.2-1b's widths at 2 layers on a (pod 2, data 2) grid
               through ``hier_bucketed``, ``hier_bucketed_zero1``, zero1
               with overlap, with int8 + error feedback, and with both (3
               steps each, ``SYNC_RUNS``).  Gates: every rank's params
               bitwise equal after every step; hier_bucketed's loss and
               grad norm within ``SYNC_BOUND`` of the oracle; zero1 bitwise
               hier_bucketed, overlap bitwise serial; K1 and K2 launches a
               rank a step as the config gives.  Then the reduced model in
               f32 (``SYNC_REDUCED_RUNS``): the deterministic reduce
               bitwise on (2,2), (4,1) and (1,4), ``hier`` within
               ``SYNC_BOUND`` of its oracle, int8 + error feedback closer
               to the f32 curve than int8 alone.  Prints each run's step
               and its split, the bytes over each tier and each tier's
               rate beside the analytic SHM/NET model, each rank's peak
               memory, and the MIG mode (information only).
6. ckpt     -- the sharded checkpoint at full width: llama3.2-1b (16
               layers, the train phase's batch and optimizer) through
               ``Trainer`` with K1 and K2: two uninterrupted runs of 4
               steps (the card's own spread), a run of 2 steps that saves
               at its end (async, sharded, ≈ 17 GB), a restore of that
               save timed alone, and a fresh ``Trainer`` resuming from it
               to step 4 (``CKPT``).  Gates: the restored state is the
               saved one bit for bit (per-leaf digests,
               ``ckpt.state.state_digest``); the resumed run's losses and
               final state are the uninterrupted run's (bitwise when the
               two uninterrupted runs are; else within their spread); K1
               and K2 launch as ``expected_train_launches`` gives, K3 and
               K4 never.  Prints the checkpoint's bytes, save and restore
               s and GB/s, and the launches a step as counted.
7. elastic  -- the elastic handoff: 4 gloo ranks on the card
               (``elastic_rank``) first run one step on (4,1) at the sync
               phase's 2 layers (``ELASTIC_PROBE``: each rank holds the
               whole optimizer state there, which ran the card out of
               memory before the update went in place; it must complete,
               and prints its peak GiB a rank), then ``ElasticDriver`` on
               llama3.2-1b's widths at 1 layer (``ELASTIC``, for time): the
               uninterrupted run, (2,2) -> (4,1) -> (1,4) -> (2,2) at steps
               2, 4 and 6 of 8 (``ELASTIC_SCHEDULE``) and a drain cycle;
               then the reduced
               model in f32 (``ELASTIC_REDUCED``): a handoff against a
               drain cycle at the same step, and the job SIGKILLed by its
               fault plan in the commit window of a handoff
               (``ELASTIC_KILL``) and relaunched with ``resume=True``.
               Gates: every handoff verified (the restored state's
               digests the saved state's); every run's losses bitwise the
               uninterrupted run's; in every run of every rank, the
               relaunch too, K1 and K2 launch a step as the config gives
               (the reduced model has no remat) and K3 and K4 never; the
               killed job leaves the previous commit and its relaunch
               continues bitwise.  Prints every handoff's save, restore,
               setup and first-step s and bytes; its ``cycle_s`` is save +
               setup + restore, the first step apart.
               Both phases write under ``chiprun_out/`` and delete it.
8. cluster  -- the multi-tenant cluster runtime: ``ClusterRuntime``
               co-schedules training jobs, each segment a
               ``repro_torch.cluster.worker`` process whose gloo ranks
               share this card.  Run A is the reference's contention
               scenario (``CLUSTER_A``: ``launch/cluster.py``'s demo on a
               2x4 pool, the reference worker's reduced model), then its
               crash case (``CLUSTER_CRASH``); run B a 3-job trace at
               llama3.2-1b's widths at 1 layer on a 2x2 pool
               (``CLUSTER_B``).  Gates: the reference smoke's (a defrag of
               j0 for j2 and at least 2 repacks, every job's steps, j2's
               losses j0's first two bit for bit, every boundary's costs
               above 0), the crash restarting j_a alone with equal losses,
               run B's defrag of b0 for b2 with b0 bitwise b2 (the same
               job run alone), and in every segment K1 and K2 launched as
               the config gives, K3 and K4 never, on ``cuda``.  Prints the
               repacks, every boundary's save, restore and setup s and
               bytes, each segment's step s and peak GiB a rank.  It
               writes under ``chiprun_out/`` and deletes it.
9. replay   -- the cluster simulator priced by the card (host code, no
               kernel): ``ReconfigCostModel.from_measurements`` of the
               elastic phase's three full-width handoffs (beside it, for
               information, the model of cluster run B's boundaries);
               every Table-1 workload's uncapped handoff against the
               1-job drain the simulator charges; the fig7 and fig8 trace
               categories (``REPLAY_TRACES``) at seeds 0-2 replayed by
               ``simulate`` under Dynamic-MIG with drains, with handoffs
               at the card's cost model, and under Flex-MIG; fig7 seed 0
               under seeded host failures with each cost model; a size-4
               job placed by Flex-MIG and launched by ``JobExecutor``
               through the MIG-aware registry.  Gates: the median handoff
               at or below the drain; every job of every replay finished;
               Flex-MIG reconfigures nothing; the summed handoff charge
               below the summed drain charge; the mean makespan delta of
               handoff over drain at least ``REPLAY_MIN_DELTA``; a replay
               run twice equal; the failure replays' failures equal and
               the handoff's restart charge at most the drain's; the
               launch spans both GPUs with SHM transports and fails
               without the MIG-aware registry.  Prints the cost models,
               every replay's makespan, mean JCT and wait, drains or
               handoffs and their charge, the makespan delta, Flex-MIG over
               drained Dynamic-MIG (``metrics.summarize``), the schedule
               fig7 seed 0 would ask the elastic driver for, and the
               phase's seconds.

Logits are held to the bound of tests/test_decode_consistency.py; where
bf16 logits miss it (the xLSTM's bf16 rounding noise exceeds it), the same
comparison is made in f32 on the same weights and must pass whole, and the
bf16 pair must lie closer together than the bf16 plain logits lie to the
f32 ones; all are reported.  Launch counts are set to 0 just before each
path's prefill and serve phases, and before the train phase's steps (and
in each rank before each step of the sync phase, before the ckpt phase's
runs, in each rank before each elastic run and in each cluster segment's
ranks), and read just after; the
run fails if a kernel of a path was never launched on
it, or if a prefill, a decode step or a training step launched other
counts than its model's layers give.  The line before the
last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Any failure exits non-zero.
"""
from __future__ import annotations

import json
import math
import os
import signal
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")
LOG = os.path.join(REPO, "chiprun_out", "chip_smoke.log")

# published peaks of one H100 SXM (dense), for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# each kernel against its plain version: tests/test_kernels.py's bounds
# for the JAX package's kernel of the same function (K3's are those of
# test_ssd_kernel_sweep, its final state held at 1e-3; K4's those of
# test_mlstm_kernel_sweep, n held at C's bound, bf16 h at _tol's bf16)
_DENSE_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
              "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TOL = {"rmsnorm": _DENSE_TOL, "flash_attention": _DENSE_TOL,
       "ssd": {"float32": dict(rtol=2e-4, atol=2e-4),
               "bfloat16": dict(rtol=4e-2, atol=4e-2),
               "state": dict(rtol=1e-3, atol=1e-3)},
       "mlstm": {"float32": dict(rtol=5e-3, atol=5e-3),
                 "bfloat16": dict(rtol=2e-2, atol=2e-2),
                 "state": dict(rtol=1e-3, atol=1e-3),
                 "m": dict(rtol=1e-4, atol=1e-4)}}
ARCHS = ("llama3.2-1b", "zamba2-1.2b", "xlstm-125m")
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


def rates(flops: float, ms: float, bms: float, library_ms) -> dict:
    """The kernel's achieved TFLOP/s on the bound's FLOP count, the share
    of its bound it reaches, and its time over the library call's."""
    return dict(tflops=flops / ms / 1e9, share_of_bound=bms / ms,
                vs_library=None if library_ms is None else ms / library_ms)


def device_events(torch, fn, n: int):
    """torch.profiler's device-side events of ``n`` calls of ``fn``.  The
    window opens with one fill kernel, left out of the result: the profiler
    may drop the first kernel of a fresh window (a window of one K4 call
    read its three kernels as two)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    pad = torch.empty(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad.fill_(0.0)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [ev for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and "FillFunctor" not in ev.key]


def device_kernels(torch, fn, n: int = 4) -> dict:
    """The device kernels one call of ``fn`` launches: name -> count."""
    return {ev.key[:96]: ev.count / n for ev in device_events(torch, fn, n)}


def profiled_ms(torch, fn, n: int = 20, match: str = ""):
    """Device time of one call of ``fn``: the profiler's times of the
    kernels whose names hold ``match``, over ``n`` calls, summed, over
    ``n`` (None if it saw no such kernel).  A window in which the profiler
    saw none is taken again, up to 3 windows: on the H100 machine it has
    dropped a whole window of K1's calls once."""
    for _ in range(3):
        us = sum(ev.self_device_time_total
                 for ev in device_events(torch, fn, n) if match in ev.key)
        if us:
            return us / 1e3 / n
    return None


def check_close(torch, kernel, name, out, ref, dtype) -> float:
    tol = TOL[kernel][dtype]
    err = (out.float() - ref.float()).abs().max().item()
    if not torch.allclose(out.float(), ref.float(), **tol):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3e}, "
                             f"tolerance {tol})")
    return err


# --------------------------------------------------------------- phases

# the tensor-core kernels (bf16 paths): source directory -> kernel names
TC_KERNELS = {"flash_attention": ("flash_fwd_tc_kernel",),
              "mamba_scan": ("ssd_fwd_tc_kernel",),
              "mlstm": ("mlstm_state_tc_kernel", "mlstm_out_tc_kernel")}
# the kernels of the ptxas report: the tensor-core kernels and K1's
REPORTED = dict(TC_KERNELS, rmsnorm=("rmsnorm_",))


def kernel_report(procs, cuda_home) -> dict:
    """Registers, spills and static shared memory of each instantiation of
    the kernels in ``REPORTED`` (``nvcc -Xptxas -v``), and the HMMA
    (tensor-core mma) instructions in its machine code (``cuobjdump -sass``,
    where the toolkit has it).  Fails if a tensor-core kernel has no HMMA;
    K1 needs none."""
    import re
    report = {}
    for src, (proc, cubin) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise AssertionError(f"nvcc -Xptxas -v of {src} failed:\n{out}")
        fn = None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1) if any(
                    name in m.group(1) for name in REPORTED[src]) else None
                if fn:
                    report[fn] = {"source": src}
            elif fn and "spill" in line:
                st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                    line)
                report[fn].update(spill_stores=int(st), spill_loads=int(ld))
            elif fn and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line)
                smem = re.search(r"(\d+) bytes smem", line)
                report[fn].update(
                    registers=int(regs.group(1)),
                    static_smem=int(smem.group(1)) if smem else 0)
        cuobjdump = os.path.join(cuda_home, "bin", "cuobjdump")
        if not os.path.exists(cuobjdump):
            continue
        sass = subprocess.run([cuobjdump, "-sass", cubin], check=True,
                              capture_output=True, text=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = m.group(1) if m.group(1) in report else None
                if fn:
                    report[fn]["hmma"] = 0
            elif fn and "HMMA" in line:
                report[fn]["hmma"] += 1
    if {r["source"] for r in report.values()} != set(REPORTED):
        raise AssertionError(f"the ptxas report lacks a source: {report}")
    for fn, r in report.items():
        if r["source"] in TC_KERNELS and r.get("hmma") == 0:
            raise AssertionError(f"{fn} has no HMMA instruction: it does "
                                 f"not run on the tensor cores")
    return report


def phase_build(torch):
    """The extension (``_build.extension``), and beside it, started
    together, one ``nvcc -cubin -Xptxas -v`` of each source in
    ``REPORTED`` for the report of ``kernel_report``."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels._build import (BUILD_DIR, COMMON, CUDA_FLAGS,
                                            _PKG, extension)
    report_dir = BUILD_DIR / "ptxas"
    report_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for src in REPORTED:
        cubin = str(report_dir / f"{src}.cubin")
        procs[src] = (subprocess.Popen(
            [os.path.join(CUDA_HOME, "bin", "nvcc"), "-cubin", "-std=c++17",
             *CUDA_FLAGS, "-Xptxas", "-v", "-I", str(COMMON), "-o", cubin,
             str(_PKG / src / "kernel.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), cubin)
    extension()
    seconds = time.perf_counter() - t0
    report = kernel_report(procs, CUDA_HOME)
    for fn, r in report.items():
        print(f"  {fn}: {r}", flush=True)
    emit("build", seconds=seconds,
         report_seconds=time.perf_counter() - t0,
         tc_kernels={fn: r for fn, r in report.items()
                     if r["source"] in TC_KERNELS},
         rmsnorm_kernels={fn: r for fn, r in report.items()
                          if r["source"] == "rmsnorm"})


def phase_kernels(torch, dev):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    dts = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    table = {}

    n_rmsnorm = rmsnorm_cases(torch, dev, g, dts, table)

    # K2: llama's prefill is B=4, S=1024, H:Kv=32:8, D=64, causal; zamba2's
    # shared attention the same at 32:32
    cases = [(2, S, H, Kv, D, causal, dname, 0.0)
             for S in (128, 192, 1024) for H, Kv in ((32, 8), (4, 4), (2, 1))
             for D in (32, 64, 128) for causal in (True, False)
             for dname in dts]
    # ragged tails: S not a multiple of the kernels' query and key tiles
    cases += [(2, S, 32, 8, D, causal, dname, 0.0)
              for S in (200, 1000) for D in (64, 128)
              for causal in (True, False) for dname in dts]
    # the bf16 tensor-core kernel with a softcap, and at D 128 on ragged
    # tails under GQA 4:1 and MHA
    cases += [(1, 128, 2, 2, 32, True, "bfloat16", 20.0),
              (2, 200, 32, 8, 64, True, "bfloat16", 20.0),
              (2, 1000, 8, 2, 128, True, "bfloat16", 30.0)]
    cases += [(2, 333, H, Kv, 128, causal, "bfloat16", 0.0)
              for H, Kv in ((8, 2), (4, 4)) for causal in (True, False)]
    main_cases = {(4, 1024, 32, 8, 64, True, "bfloat16", 0.0):
                  "flash_attention",
                  (4, 1024, 32, 32, 64, True, "bfloat16", 0.0):
                  "flash_attention_mha"}
    cases += [(1, 128, 2, 2, 32, True, "float32", 20.0)] + list(main_cases)
    for case in cases:
        B, S, H, Kv, D, causal, dname, cap = case
        dt = dts[dname]
        q = torch.randn(B, S, H, D, generator=g, device=dev).to(dt)
        k = torch.randn(B, S, Kv, D, generator=g, device=dev).to(dt)
        v = torch.randn(B, S, Kv, D, generator=g, device=dev).to(dt)
        run = lambda: flash_attention(q, k, v, causal=causal,  # noqa: E731
                                      softcap=cap)
        ref = attention_ref(q, k, v, causal=causal, softcap=cap)
        err = check_close(torch, "flash_attention",
                          f"flash_attention B={B} S={S} H={H}:{Kv} "
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
        if case in main_cases:
            plain = cuda_ms(torch, lambda: attention_ref(
                q, k, v, causal=causal), iters=3)
            pairs = S * (S + 1) // 2 if causal else S * S
            flops = 4 * D * pairs * B * H          # QK^T and P.V
            # q, k, v in; o (the size of q) out
            n_bytes = (2 * q.numel() + k.numel() + v.numel()) \
                * q.element_size()
            bms, by = bound_ms(n_bytes, flops, dname)
            row = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, shape=[B, S, H, Kv, D],
                dtype=dname, causal=causal, flops=flops, n_bytes=n_bytes,
                **rates(flops, ms, bms, lib))
            if main_cases[case] == "flash_attention":
                row["library_kernels"] = device_kernels(
                    torch, lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True))
            table[main_cases[case]] = row

    n_ssd = ssd_cases(torch, dev, g, dts, table)
    n_mlstm = mlstm_cases(torch, dev, g, dts, table)
    grads = autograd_cases(torch, dev, g, dts)
    refusals = no_backward_cases(torch, dev, g)
    emit("kernels", cases_rmsnorm=n_rmsnorm,
         cases_flash_attention=len(cases), cases_ssd=n_ssd,
         cases_mlstm=n_mlstm, autograd=grads, no_backward=refusals,
         logits_autograd=logits_needs_function(torch, dev),
         main_shapes=table)
    return table


def autograd_cases(torch, dev, g, dts) -> dict:
    """K1 and K2 under autograd, as the training path runs them
    (``RMSNormFn``, ``FlashAttentionFn``: forward the kernel, backward the
    gradient of the plain version), at the serving shapes in f32 and bf16:
    each input's gradient under one incoming gradient must equal, bitwise,
    the plain version's under autograd (the backward recomputes it).
    Returns per-case max abs differences (all 0)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    def input_grads(fn, inputs, gout=None):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        if gout is None:
            gout = torch.randn(out.shape, generator=g, device=dev).to(
                out.dtype)
        if out.grad_fn is None:
            raise AssertionError("a kernel's output under autograd has no "
                                 "grad_fn: its inputs would get no gradient")
        return torch.autograd.grad(out, leaves, gout), gout

    out = {}
    cases = [("rmsnorm", (4 * 1024, D), dname) for D in RMS_WIDTHS
             for dname in dts]
    cases += [("flash_attention", (4, 1024, H, Kv, 64), dname)
              for H, Kv in ((32, 8), (32, 32)) for dname in dts]
    for kernel, shape, dname in cases:
        dt = dts[dname]
        if kernel == "rmsnorm":
            R, D = shape
            inputs = (torch.randn(R, D, generator=g, device=dev).to(dt),
                      torch.randn(D, generator=g, device=dev))
            fn, plain = rmsnorm, rmsnorm_ref
        else:
            B, S, H, Kv, D = shape
            inputs = tuple(torch.randn(B, S, h, D, generator=g,
                                       device=dev).to(dt)
                           for h in (H, Kv, Kv))
            fn, plain = flash_attention, attention_ref
        got, gout = input_grads(fn, inputs)
        want, _ = input_grads(plain, inputs, gout)
        diffs = [(a.float() - b.float()).abs().max().item()
                 for a, b in zip(got, want)]
        name = f"{kernel} {list(shape)} {dname} under autograd"
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: input gradients differ from the "
                                 f"plain version's: max abs {diffs}")
        print(f"  {name}: input gradients equal the plain version's",
              flush=True)
        out[f"{kernel} {shape} {dname}"] = max(diffs)
    return out


def no_backward_cases(torch, dev, g) -> dict:
    """K3 and K4 have no backward: on inputs that need grad they must
    raise, not return an output with no gradient."""
    import torch.nn.functional as F
    from repro_torch.kernels.mamba_scan.ops import ssd
    from repro_torch.kernels.mlstm.ops import mlstm
    x = torch.randn(1, 64, 2, 32, generator=g, device=dev).bfloat16()
    dtv = F.softplus(torch.randn(1, 64, 2, generator=g, device=dev))
    A = -torch.ones(2, device=dev)
    B = torch.randn(1, 64, 1, 16, generator=g, device=dev).bfloat16()
    q = torch.randn(1, 64, 2, 16, generator=g, device=dev).bfloat16()
    gate = torch.randn(1, 64, 2, generator=g, device=dev)
    calls = {"ssd": lambda t: ssd(t, dtv, A, B, B, chunk=32),
             "mlstm": lambda t: mlstm(t, q, q, gate, gate, chunk=32)}
    out = {}
    for name, call in calls.items():
        t = (x if name == "ssd" else q).clone().requires_grad_()
        try:
            call(t)
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
            out[name] = "refused: " + str(e).split(":")[0]
        else:
            raise AssertionError(f"{name} ran on an input that needs grad; "
                                 f"it has no backward")
        with torch.no_grad():
            call(t)        # without grad it runs
    return out


def logits_needs_function(torch, dev) -> str:
    """``LogitsFn`` exists because ``torch.mm(..., out_dtype=float32)`` on
    bf16 operands has no derivative in this torch: fails if it has one
    (then the Function may go), else returns the error it gives."""
    x, e = (torch.ones(16, 32, device=dev, dtype=torch.bfloat16,
                       requires_grad=True) for _ in range(2))
    y = torch.mm(x, e.t(), out_dtype=torch.float32)
    try:
        torch.autograd.grad(y.sum(), (x, e))
    except RuntimeError as err:
        if "not implemented" not in str(err):
            raise
        return f"no derivative: {str(err)[:120]}"
    raise AssertionError("torch.mm(..., out_dtype=float32) now has a "
                         "derivative: LogitsFn may no longer be needed")


# K1's widths on the serving paths: llama's norms and zamba2's pre-norms
# (2048), zamba2's gated norm over d_inner (4096), xlstm-125m's output norms
# of the mLSTM (d_inner 1536) and sLSTM (768) blocks; B*S = 4096 rows in a
# prefill, max_batch = 8 in a decode step.  bf16 x with f32 weights on the
# paths; f32 x beside it.
RMS_WIDTHS = (2048, 4096, 1536, 768)
RMS_ROWS = (4 * 1024, 8)
L2_FLUSH_BYTES = 128 * 2 ** 20     # zeroed before a cold-L2 call: > 2x L2
RMS_VEC_MAX_D = 4096               # widest row of K1's vector route
RMS_KERNELS = {"vector": "rmsnorm_vec_kernel",
               "scalar": "rmsnorm_scalar_kernel"}


def rmsnorm_route(kernels: dict) -> str:
    """The route of a K1 call, from the names of the device kernels it
    launched: "vector" or "scalar", else the names themselves."""
    names = " ".join(kernels)
    for route, kernel in RMS_KERNELS.items():
        if kernel in names:
            return route
    return names


def rmsnorm_route_for(x, w) -> str:
    """The route ``rmsnorm_forward`` must choose for x and w (out is new,
    so aligned): vector where D is a whole number of 16-byte vectors of x,
    at most RMS_VEC_MAX_D, and x and w are 16-byte aligned."""
    D = x.shape[-1]
    fits = D * x.element_size() % 16 == 0 and D <= RMS_VEC_MAX_D
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return "vector" if fits and aligned else "scalar"


def check_route(torch, name, fn, want) -> str:
    """The route one call of ``fn`` launched; fails unless it is ``want``."""
    route = rmsnorm_route(device_kernels(torch, fn))
    if route != want:
        raise AssertionError(f"{name} took the {route} route, not the "
                             f"{want} one")
    return route


def rmsnorm_times(torch, dev, g, dts):
    """K1 at every serving shape (RMS_ROWS x RMS_WIDTHS) in f32 and bf16,
    each held against its plain version: the profiler's device time with
    L2 cold (L2_FLUSH_BYTES zeroed before each call, the fill kernel left
    out) and warm (back-to-back calls, x and out left in L2, so faster than
    the HBM rate the bytes bound assumes); the share of that bound is the
    cold time's, the only one the bound limits; the host-inclusive time (CUDA events over back-to-back calls), the plain
    version's and ``F.rms_norm``'s; the device kernels of one call.  Also
    the host's cost of one op call at (8, 2048) bf16, measured as
    ``python -m repro_torch.kernels.build_routes`` measures its
    ``host_us_per_rmsnorm_op_call``.  Returns (records, that cost in us)."""
    import torch.nn.functional as F
    from repro_torch.kernels.build_routes import host_us_per_call
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=dev)
    recs = []
    for R in RMS_ROWS:
        for D in RMS_WIDTHS:
            for dname, dt in dts.items():
                x = torch.randn(R, D, generator=g, device=dev).to(dt)
                w = torch.randn(D, generator=g, device=dev)
                err = check_close(torch, "rmsnorm",
                                  f"rmsnorm ({R},{D}) {dname}",
                                  rmsnorm(x, w), rmsnorm_ref(x, w), dname)
                run = lambda: rmsnorm(x, w)  # noqa: E731
                warm_ms = profiled_ms(torch, run, match="rmsnorm")
                cold_ms = profiled_ms(
                    torch, lambda: (flush.zero_(), rmsnorm(x, w)),
                    match="rmsnorm")
                n_bytes = 2 * x.numel() * x.element_size() + 4 * D
                bms, by = bound_ms(n_bytes, 4 * x.numel(), "float32")
                kernels = device_kernels(torch, run)
                rec = dict(
                    shape=[R, D], dtype=dname, max_abs_err=err,
                    device_ms_cold_l2=cold_ms, device_ms_warm_l2=warm_ms,
                    bound_ms=bms, bound_by=by,
                    share_of_bound=bms / cold_ms,
                    ms=cuda_ms(torch, run),
                    plain_ms=cuda_ms(torch, lambda: rmsnorm_ref(x, w)),
                    library_ms=cuda_ms(
                        torch, lambda: F.rms_norm(x, (D,), w, 1e-5)),
                    k1_route=rmsnorm_route(kernels), kernels=kernels)
                print(f"  rmsnorm R={R} D={D} {dname} err={err:.3e} "
                      f"cold_l2_ms={cold_ms:.5f} warm_l2_ms={warm_ms:.5f} "
                      f"bound_ms={bms:.5f} share={bms / cold_ms:.3f} "
                      f"ms={rec['ms']:.5f} plain_ms={rec['plain_ms']:.5f} "
                      f"library_ms={rec['library_ms']:.5f} "
                      f"route={rec['k1_route']}", flush=True)
                recs.append(rec)
    x = torch.randn(8, 2048, generator=g, device=dev).bfloat16()
    w = torch.randn(2048, generator=g, device=dev)
    host_us = host_us_per_call(lambda: rmsnorm(x, w))
    print(f"  rmsnorm host_us_per_rmsnorm_op_call={host_us:.3f}",
          flush=True)
    return recs, host_us


def rmsnorm_cases(torch, dev, g, dts, table) -> int:
    """K1 against its plain version, each in f32 and bf16: the JAX sweep's
    (100, 96) and (256, 512); (4097, 768), whose last CTA of the vector
    route is part empty; D 100 (the scalar route in bf16) and (8, 8192)
    (wider than the vector route: the scalar route); contiguous views one
    element into their buffers (x and w off 16-byte alignment: the scalar
    route); every serving shape (``rmsnorm_times``).  Each call must launch
    the route ``rmsnorm_route_for`` gives.  The table's row is llama's
    prefill shape, (4096, 2048) bf16; every timed shape goes with it."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    n = 0
    for R, D in [(100, 96), (256, 512), (4097, 768), (64, 100), (8, 8192)]:
        for dname, dt in dts.items():
            x = torch.randn(R, D, generator=g, device=dev).to(dt)
            w = torch.randn(D, generator=g, device=dev)
            name = f"rmsnorm ({R},{D}) {dname}"
            err = check_close(torch, "rmsnorm", name, rmsnorm(x, w),
                              rmsnorm_ref(x, w), dname)
            route = check_route(torch, name, lambda: rmsnorm(x, w),
                                rmsnorm_route_for(x, w))
            print(f"  {name} err={err:.3e} route={route}", flush=True)
            n += 1
    for dname, dt in dts.items():
        R, D = 64, 2048
        x = torch.randn(R * D + 1, generator=g, device=dev).to(dt)[1:] \
            .view(R, D)
        w = torch.randn(D + 1, generator=g, device=dev)[1:]
        name = f"rmsnorm ({R},{D}) {dname} misaligned view"
        err = check_close(torch, "rmsnorm", name, rmsnorm(x, w),
                          rmsnorm_ref(x, w), dname)
        route = check_route(torch, name, lambda: rmsnorm(x, w), "scalar")
        print(f"  {name} err={err:.3e} route={route}", flush=True)
        n += 1
    recs, host_us = rmsnorm_times(torch, dev, g, dts)
    for rec in recs:
        if rec["k1_route"] != "vector":
            raise AssertionError(f"rmsnorm {rec['shape']} {rec['dtype']} "
                                 f"took the {rec['k1_route']} route, not the "
                                 f"vector one")
    row = next(r for r in recs if r["shape"] == [4 * 1024, 2048]
               and r["dtype"] == "bfloat16")
    x = torch.randn(4 * 1024, 2048, generator=g, device=dev).bfloat16()
    w = torch.randn(2048, generator=g, device=dev)
    table["rmsnorm"] = dict(
        row, host_us_per_rmsnorm_op_call=host_us,
        times=[{k: v for k, v in r.items() if k != "kernels"}
               for r in recs],
        library_kernels=device_kernels(
            torch, lambda: F.rms_norm(x, (2048,), w, 1e-5)))
    return n + len(recs)


def ssd_cases(torch, dev, g, dts, table) -> int:
    """K3 against its plain version: the JAX sweep's shapes
    (tests/test_kernels.py::test_ssd_kernel_sweep), one sequence shorter
    than the chunk (a chunk of 100 tokens, as ``mamba_apply`` scans it),
    chunks of several 64-row tiles (192, and 48 with groups), and
    zamba2-1.2b's prefill (B 4, S 1024, 64 heads of 64, N 64, chunk
    256), each in f32 and bf16.  No single PyTorch call computes an SSD
    scan, so there is no library time."""
    import torch.nn.functional as F
    from repro_torch.kernels.mamba_scan.ops import ssd
    from repro_torch.kernels.mamba_scan.ref import ssd_chunked
    main = (4, 1024, 64, 64, 1, 64, 256)
    # and several t tiles to a chunk, with groups and a ragged last tile
    shapes = [(2, 128, 4, 32, 1, 16, 32), (2, 128, 4, 32, 2, 16, 64),
              (2, 64, 2, 64, 2, 32, 16), (2, 100, 8, 64, 1, 64, 100),
              (2, 384, 4, 64, 2, 32, 192), (2, 96, 4, 32, 2, 16, 48), main]
    n = 0
    for Bt, T, H, P, G, N, Q in shapes:
        for dname, dt in dts.items():
            x = torch.randn(Bt, T, H, P, generator=g, device=dev).to(dt)
            dtv = F.softplus(torch.randn(Bt, T, H, generator=g, device=dev))
            A = -torch.exp(torch.randn(H, generator=g, device=dev) * 0.5)
            B = torch.randn(Bt, T, G, N, generator=g, device=dev).to(dt)
            C = torch.randn(Bt, T, G, N, generator=g, device=dev).to(dt)
            name = f"ssd Bt={Bt} S={T} H={H} P={P} G={G} N={N} chunk={Q} " \
                f"{dname}"
            y, st = ssd(x, dtv, A, B, C, chunk=Q)
            yr, sr = ssd_chunked(x, dtv, A, B, C, chunk=Q)
            err = check_close(torch, "ssd", name, y, yr, dname)
            err_st = check_close(torch, "ssd", name + " state", st, sr,
                                 "state")
            del y, st, yr, sr
            ms = cuda_ms(torch, lambda: ssd(x, dtv, A, B, C, chunk=Q))
            plain = cuda_ms(torch, lambda: ssd_chunked(x, dtv, A, B, C,
                                                       chunk=Q), iters=3)
            # each input read once, y and the f32 state written once
            n_bytes = 2 * x.numel() * x.element_size() + 4 * dtv.numel() \
                + 4 * H + (B.numel() + C.numel()) * B.element_size() \
                + 4 * Bt * H * P * N
            # per (b, h, chunk): C.B^T and W.xd over the causal (t, s)
            # pairs, the inter-chunk term and the chunk state
            pairs = Q * (Q + 1) // 2
            flops = (2 * pairs * (N + P) + 4 * Q * P * N) * Bt * H * (T // Q)
            bms, by = bound_ms(n_bytes, flops, dname)
            print(f"  {name} err={err:.3e} state_err={err_st:.3e} "
                  f"ms={ms:.4f} plain_ms={plain:.4f} bound_ms={bms:.4f} "
                  f"({by}) library_ms=none", flush=True)
            if (Bt, T, H, P, G, N, Q) == main and dname == "bfloat16":
                table["ssd"] = dict(
                    max_abs_err=err, state_max_abs_err=err_st, ms=ms,
                    plain_ms=plain, bound_ms=bms, bound_by=by,
                    library_ms=None, shape=[Bt, T, H, P, G, N, Q],
                    dtype=dname, n_bytes=n_bytes, flops=flops,
                    **rates(flops, ms, bms, None))
            n += 1
    return n


def mlstm_cases(torch, dev, g, dts, table) -> int:
    """K4 against its plain version, each case in f32 (the scalar kernel)
    and bf16 (the tensor-core kernels): the JAX sweep's shapes
    (tests/test_kernels.py::test_mlstm_kernel_sweep), chunks of 100 and 192
    tokens (ragged 64-row tiles), xlstm-125m's prefill (B 4, S 1024, 4
    heads of 384, chunk 256), all with the sweep's inputs (q, k, v normal,
    i 2 normal, f 2 normal + 3), and constant gates at |log gate| = 5 in
    each sign combination at the serving width over two chunks, where h
    must be finite (test_mlstm_gate_stability_property).  No PyTorch call
    computes an mLSTM, so there is no library time."""
    from repro_torch.kernels.mlstm.ops import mlstm
    from repro_torch.kernels.mlstm.ref import mlstm_chunked
    main = (4, 1024, 4, 384, 256)
    shapes = [(2, 128, 2, 32, 32), (2, 64, 4, 16, 16), (2, 96, 2, 64, 32),
              (2, 200, 2, 64, 100), (2, 384, 2, 384, 192), main]
    cases = [(shape, dname, None) for shape in shapes for dname in dts]
    cases += [((1, 512, 4, 384, 256), dname, (log_f, log_i))
              for log_f in (5.0, -5.0) for log_i in (5.0, -5.0)
              for dname in dts]
    for (Bt, T, H, D, Q), dname, const in cases:
        dt = dts[dname]
        q, k, v = (torch.randn(Bt, T, H, D, generator=g, device=dev).to(dt)
                   for _ in range(3))
        if const is None:
            i_raw = torch.randn(Bt, T, H, generator=g, device=dev) * 2
            f_raw = torch.randn(Bt, T, H, generator=g, device=dev) * 2 + 3
            name = f"mlstm B={Bt} S={T} H={H} D={D} chunk={Q} {dname}"
        else:
            f_raw = torch.full((Bt, T, H), const[0], device=dev)
            i_raw = torch.full((Bt, T, H), const[1], device=dev)
            name = f"mlstm B={Bt} S={T} H={H} D={D} chunk={Q} {dname} " \
                f"gates f={const[0]} i={const[1]}"
        h, (C, n, m) = mlstm(q, k, v, i_raw, f_raw, chunk=Q)
        hr, (Cr, nr, mr) = mlstm_chunked(q, k, v, i_raw, f_raw, chunk=Q)
        if not torch.isfinite(h).all():
            raise AssertionError(f"{name}: h is not finite")
        err = check_close(torch, "mlstm", name, h, hr, dname)
        err_C = check_close(torch, "mlstm", name + " C", C, Cr, "state")
        err_n = check_close(torch, "mlstm", name + " n", n, nr, "state")
        err_m = check_close(torch, "mlstm", name + " m", m, mr, "m")
        del h, C, n, m, hr, Cr, nr, mr
        ms = cuda_ms(torch, lambda: mlstm(q, k, v, i_raw, f_raw, chunk=Q),
                     iters=5)
        plain = cuda_ms(torch, lambda: mlstm_chunked(q, k, v, i_raw, f_raw,
                                                     chunk=Q), iters=3)
        # q, k, v read and h written once, the f32 gates read, the f32
        # final (C, n, m) written
        n_bytes = 4 * q.numel() * q.element_size() + 4 * 2 * i_raw.numel() \
            + 4 * Bt * H * (D * D + D + 1)
        # per (b, h, chunk): q.k^T and P.v over the Q(Q+1)/2 causal pairs,
        # q.C0 and the k^T v state update
        pairs = Q * (Q + 1) // 2
        flops = (4 * D * pairs + 4 * Q * D * D) * Bt * H * (T // Q)
        bms, by = bound_ms(n_bytes, flops, dname)
        print(f"  {name} err={err:.3e} C_err={err_C:.3e} n_err={err_n:.3e} "
              f"m_err={err_m:.3e} ms={ms:.4f} plain_ms={plain:.4f} "
              f"bound_ms={bms:.4f} ({by}) library_ms=none", flush=True)
        if (Bt, T, H, D, Q) == main and dname == "bfloat16":
            run = lambda: mlstm(q, k, v, i_raw, f_raw, chunk=Q)  # noqa: E731
            kernels = device_kernels(torch, run)
            print(f"  {name}: device kernels per call {kernels}", flush=True)
            table["mlstm"] = dict(
                max_abs_err=err, C_max_abs_err=err_C, n_max_abs_err=err_n,
                m_max_abs_err=err_m, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=None, shape=[Bt, T, H, D, Q],
                dtype=dname, n_bytes=n_bytes, flops=flops,
                device_kernels=kernels, device_ms=profiled_ms(torch, run),
                **rates(flops, ms, bms, None))
    return len(cases)


def _quantile_top(torch, x, q: float) -> float:
    """Upper quantile of a large tensor (torch.quantile caps its input
    size): the smallest of the top (1 - q) share."""
    flat = x.flatten()
    k = max(1, int(math.ceil((1.0 - q) * flat.numel())))
    return torch.topk(flat, k, sorted=False).values.min().item()


def expected_launches(cfg) -> dict:
    """Launches of each kernel in one prefill of ``cfg``'s model.  Dense:
    two norms per layer and the final norm, one attention per layer.
    Hybrid: two norms per Mamba2 block (its pre-norm and its gated norm
    over d_inner), two per application of the shared attention block, the
    final norm; one attention per application; one SSD scan per Mamba2
    block.  ssm (xLSTM): one RMSNorm per block, its output norm (the block
    and final norms are LayerNorms, plain PyTorch); one mLSTM per mLSTM
    block."""
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        return {"rmsnorm": 2 * cfg.n_layers + 2 * n_attn + 1,
                "flash_attention": n_attn, "ssd": cfg.n_layers, "mlstm": 0}
    if cfg.family == "ssm":
        n_slstm = cfg.n_layers // cfg.slstm_every
        return {"rmsnorm": cfg.n_layers, "flash_attention": 0, "ssd": 0,
                "mlstm": cfg.n_layers - n_slstm}
    return {"rmsnorm": 2 * cfg.n_layers + 1,
            "flash_attention": cfg.n_layers, "ssd": 0, "mlstm": 0}


def logits_dtype(torch, cfg):
    """f32 for the dense model; the model's dtype (bf16) for the hybrid and
    the xLSTM, whose references compute logits without an f32 accumulation
    type."""
    return torch.float32 if cfg.family == "dense" else torch.bfloat16


def logit_stats(torch, a, b) -> dict:
    """p99.9 and max |dlogit|, top-1 agreement, and the share of positions
    whose two largest logits of ``b`` tie (bf16 rounds near-ties to ties)."""
    diff = (a.float() - b.float()).abs()
    top2 = torch.topk(b.float(), 2, dim=-1).values
    return dict(p999_abs_dlogit=_quantile_top(torch, diff, 0.999),
                max_abs_dlogit=diff.max().item(),
                top1_agreement=(a.argmax(-1) == b.argmax(-1)).float()
                .mean().item(),
                tied_top2_share=(top2[..., 0] == top2[..., 1]).float()
                .mean().item())


def hold_logits(torch, what, a, b, f32_pair=None) -> dict:
    """The bound of tests/test_decode_consistency.py (p99.9 |dlogit| < 0.2,
    max < 0.5, top-1 > 0.9) on logits ``a`` against ``b``.

    bf16 logits of the xLSTM carry the model's own rounding noise: in bf16
    the plain path lies further from itself in f32 than that bound (and
    the kernels' f32 arithmetic, ordered otherwise than the plain
    version's, flips some bf16 roundings, which the layers amplify).
    Where the bf16 comparison misses the bound and ``f32_pair`` is given,
    the same comparison on ``f32_pair()`` (the same weights in f32, where
    only the arithmetic differs) must pass it whole, and the bf16 pair must
    lie closer together than the bf16 plain logits lie to the f32 ones (on
    each of the three numbers); all three comparisons are returned."""
    stats = logit_stats(torch, a, b)
    if stats["p999_abs_dlogit"] < 0.2 and stats["max_abs_dlogit"] < 0.5 \
            and stats["top1_agreement"] > 0.9:
        return stats
    if f32_pair is None:
        raise AssertionError(f"{what}: {stats}")
    a32, b32 = f32_pair()
    s32 = logit_stats(torch, a32, b32)
    rounding = logit_stats(torch, b, b32)
    within = (stats["p999_abs_dlogit"] < rounding["p999_abs_dlogit"]
              and stats["max_abs_dlogit"] < rounding["max_abs_dlogit"]
              and stats["top1_agreement"] > rounding["top1_agreement"])
    if not (s32["p999_abs_dlogit"] < 0.2 and s32["max_abs_dlogit"] < 0.5
            and s32["top1_agreement"] > 0.9 and within):
        raise AssertionError(f"{what}: bf16 {stats}, f32 {s32}, bf16 plain "
                             f"vs f32 plain {rounding}")
    return dict(stats, f32=s32, bf16_vs_f32=rounding)


def f32_copy(torch, model, cfg, dev):
    """The model with the same weights in f32."""
    from repro_torch.models.registry import build_model
    m32 = build_model(cfg, device=dev, dtype=torch.float32, seed=None)
    m32.load_state_dict(model.state_dict())
    return m32


def phase_prefill(torch, dev, model, cfg, launches):
    from repro_torch.serve import make_prefill_step
    B, S = 4, 1024
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)))
    step = make_prefill_step(model, device=dev)

    def timed(n):
        """Last logits, each call's wall seconds, peak device GiB (the
        model's weights included)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        times = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(tokens)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, times, torch.cuda.max_memory_allocated(dev) / 2 ** 30

    # one untimed call of each path first: the first calls after the
    # kernels phase pay one-time costs (allocator growth, lazy loading)
    model.use_kernels = False
    step(tokens)
    model.use_kernels = True
    step(tokens)
    launches.reset()
    logits, runs_kernel, gib_kernel = timed(4)
    t_kernel = sorted(runs_kernel)[2]
    launches.read(f"{cfg.arch_id} prefill")
    per_prefill = expected_launches(cfg)
    got = {k: n / 4 for k, n in launches.phases[
        f"{cfg.arch_id} prefill"].items()}
    if got != per_prefill:
        raise AssertionError(f"{cfg.arch_id}: launches per prefill {got}, "
                             f"its layers give {per_prefill}")
    model.use_kernels = False
    before = launches.snapshot()
    plain, runs_plain, gib_plain = timed(2)
    t_plain = sorted(runs_plain)[1]
    model.use_kernels = True
    if launches.snapshot() != before:
        raise AssertionError("the plain path launched a kernel")

    if tuple(logits.shape) != (B, S, cfg.vocab_size) or \
            logits.dtype != logits_dtype(torch, cfg):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} "
                             f"{logits.dtype}")
    if not torch.isfinite(logits).all():
        raise AssertionError("prefill logits are not all finite")

    def f32_pair():
        m32 = f32_copy(torch, model, cfg, dev)
        step32 = make_prefill_step(m32, device=dev)
        a = step32(tokens)
        m32.use_kernels = False
        return a, step32(tokens)

    stats = hold_logits(torch, "prefill with kernels vs plain path", logits,
                        plain, f32_pair if logits.dtype == torch.bfloat16
                        else None)
    del plain, logits
    emit(f"{cfg.arch_id} prefill", batch=B, seq=S, seconds=t_kernel,
         tokens_per_s=B * S / t_kernel, plain_seconds=t_plain,
         runs_seconds=runs_kernel, plain_runs_seconds=runs_plain,
         peak_memory_gib=gib_kernel, plain_peak_memory_gib=gib_plain,
         **stats, launches_per_prefill=per_prefill,
         launches=launches.phases[f"{cfg.arch_id} prefill"])


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
    launches.read(f"{cfg.arch_id} serve")
    done = sorted(server.completed, key=lambda r: r.rid)
    if len(done) != n_req or any(len(r.out) != max_new for r in done):
        raise AssertionError(f"served {len(done)} of {n_req} requests; "
                             f"lengths {[len(r.out) for r in done]}")
    if not torch.stack(finite).all():
        raise AssertionError("a decode step produced a non-finite logit")
    # a decode step runs every norm a prefill runs, and no attention
    # kernel, SSD scan or mLSTM (decode attention, the SSD step and the
    # mLSTM step are plain PyTorch)
    per_step = expected_launches(cfg)["rmsnorm"]
    want = {k: per_step * server.pos if k == "rmsnorm" else 0
            for k in expected_launches(cfg)}
    if launches.phases[f"{cfg.arch_id} serve"] != want:
        raise AssertionError(f"{cfg.arch_id} serve launched "
                             f"{launches.phases[f'{cfg.arch_id} serve']}, "
                             f"its decode steps give {want}")
    out_tokens = n_req * max_new
    emit(f"{cfg.arch_id} serve", requests=n_req, decode_steps=server.pos,
         seconds=seconds, output_tokens_per_s=out_tokens / seconds,
         ms_per_decode_step=seconds / server.pos * 1e3,
         peak_memory_gib=torch.cuda.max_memory_allocated(dev) / 2 ** 30,
         launches=launches.phases[f"{cfg.arch_id} serve"])
    del server

    # decode reproduces the prefill's logits on one short sequence (the
    # JAX package's tests/test_decode_consistency.py check, at full width)
    S = 64
    toks = torch.from_numpy(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, S))).to(dev)

    def decode_pair(m):
        """(decode step logits, prefill logits) of ``m`` on ``toks``."""
        with torch.inference_mode():
            full = m.forward_logits(toks)
            cache = m.init_cache(1, S)
            dec = torch.cat([m.decode_step(cache, toks[:, t:t + 1], t)[0]
                             for t in range(S)], dim=1)
        return dec, full

    dec, full = decode_pair(model)
    stats = hold_logits(torch, "decode vs prefill", dec, full,
                        (lambda: decode_pair(f32_copy(torch, model, cfg,
                                                      dev)))
                        if dec.dtype == torch.bfloat16 else None)
    emit(f"{cfg.arch_id} decode_consistency", seq=S, **stats)


def phase_profile(torch, dev, model, cfg):
    """Device time by kernel for one prefill and one decode step at the
    served shapes (torch.profiler; kernel times sum to the busy time), and
    for xlstm-125m one sLSTM block's prefill, a plain per-token loop.  K1's
    kernels there are counted and timed apart, and each must be its vector
    route: the model's own calls (views of weights and activations
    included) keep to it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import make_prefill_step, make_serve_step
    rng = np.random.default_rng(SEED + 2)
    prefill = make_prefill_step(model, device=dev)
    step = make_serve_step(model, device=dev)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 1024)))
    cache = model.init_cache(8, 1024)
    dtoks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (8, 1)))
    runs = [("prefill", lambda: prefill(toks), 2),
            ("decode_step", lambda: step(cache, dtoks, 100), 8)]
    if cfg.family == "ssm":
        from repro_torch.models.xlstm import slstm_block_apply
        x = torch.randn(4, 1024, cfg.d_model, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED)).to(next(model.parameters()).dtype)

        def slstm_block():
            with torch.inference_mode():
                return slstm_block_apply(x, model.blocks.slstm[0], cfg)

        # its ~60k launches make a profiled prefill slow: profile one
        runs = [("prefill", runs[0][1], 1), runs[1],
                ("slstm_block", slstm_block, 1)]
    for name, fn, n in runs:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        by_kernel, n_kernels, k1 = {}, 0, {"ms": 0.0, "kernels": 0}
        for ev in prof.key_averages():
            # device-side events only: a CPU op's device time repeats the
            # time of the kernels it launched
            if ev.device_type != DeviceType.CUDA:
                continue
            us = ev.self_device_time_total
            if "rmsnorm_" in ev.key:
                if RMS_KERNELS["vector"] not in ev.key:
                    raise AssertionError(f"{cfg.arch_id} {name}: K1 took "
                                         f"another route than the vector "
                                         f"one: {ev.key[:96]}")
                k1["ms"] += us / 1e3 / n
                k1["kernels"] += ev.count / n
            if us > 0:
                by_kernel[ev.key[:48]] = by_kernel.get(ev.key[:48], 0.0) \
                    + us / 1e3 / n
                n_kernels += ev.count
        device_ms = sum(by_kernel.values())
        top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
        emit(f"{cfg.arch_id} profile_{name}",
             device_ms=device_ms if device_ms else "not measured",
             profiled_wall_ms=wall_ms,
             device_kernels_per_call=n_kernels / n,
             rmsnorm_device_ms=k1["ms"], rmsnorm_kernels=k1["kernels"],
             top_kernels_ms={k: round(v, 4) for k, v in top})


# the training run: llama3.2-1b at full width, bf16 params, f32 masters
TRAIN_ARCH = "llama3.2-1b"
TRAIN = dict(seq=1024, global_batch=8, accum=2, steps=6)
TRAIN_OPT = dict(peak_lr=3e-4, warmup_steps=2, total_steps=8)
# kernel path against the plain path on the card, per step; the card
# against the CPU on one step of a 2-layer model; the worst leaf's gradient
# (by norm), kernel against plain path.  Measured on an H100 (PERF.md):
# 1.6e-3, 9.5e-4, 1.3e-4 (the grad norm's; the loss's 1.1e-5) and 8.1e-3.
TRAIN_LOSS_ATOL = 1e-2
TRAIN_GNORM_RTOL = 2e-2
CARD_VS_CPU_RTOL = 2e-3
CARD_VS_CPU_LEAF_RTOL = 2e-2
TRAIN_LEAF_GRAD_RTOL = 0.05
# the peak of allocated memory over the train phase's steps with the
# functional AdamW, which held the old and the new f32 state side by side
# (H100 80GB HBM3, 700 W; PERF.md §6); the in-place update must come
# in at least this far below it (one copy of the f32 master, mu and nu is
# 3 x 4.94 GB)
TRAIN_FUNCTIONAL_PEAK_GIB = 54.62
TRAIN_PEAK_DROP_GIB = 10.0


def expected_train_launches(cfg, accum: int, remat: bool = True) -> dict:
    """K1 and K2 launches of one training step of the dense model: per
    microbatch the forward's (two norms a layer and the final norm; one
    attention a layer) and, with remat, its recompute of every layer in
    the backward (the final norm is not in a checkpointed layer); the
    backward itself launches none (it is the plain versions' gradient)."""
    L = cfg.n_layers
    R = L if remat else 0
    return {"rmsnorm": accum * ((2 * L + 1) + 2 * R),
            "flash_attention": accum * (L + R), "ssd": 0, "mlstm": 0}


def train_flops(cfg, n_params: int, tokens: int, batch: int,
                seq: int) -> float:
    """Model FLOPs of one step: 6·N·tokens for the weights' products
    (forward and backward, the tied embedding counted once for the logits)
    and 3x the causal attention forward's QKᵀ and P·V; remat's recompute
    is left out."""
    pairs = seq * (seq + 1) // 2
    attn = 4 * cfg.resolved_head_dim * pairs * batch * cfg.n_heads \
        * cfg.n_layers
    return 6 * n_params * tokens + 3 * attn


def kernel_group(name: str) -> str:
    """The profile's group of a device kernel, by its name."""
    if "rmsnorm_" in name:
        return "K1 rmsnorm"
    if "flash_fwd" in name:
        return "K2 flash_attention"
    if any(k in name for k in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        return "cuBLAS GEMM"
    if "softmax" in name.lower():
        return "softmax"
    if "reduce" in name.lower():
        return "reductions"
    if "elementwise" in name or "vectorized" in name:
        return "elementwise"
    return "other"


def profile_groups(torch, fn) -> dict:
    """One call of ``fn`` under the profiler: device ms by kernel group,
    device kernels, wall ms (synchronised) and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    groups, n_kernels, top = {}, 0, {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.self_device_time_total <= 0:
            continue
        ms = ev.self_device_time_total / 1e3
        grp = kernel_group(ev.key)
        groups[grp] = groups.get(grp, 0.0) + ms
        n_kernels += ev.count
        top[ev.key[:64]] = top.get(ev.key[:64], 0.0) + ms
    busy = sum(groups.values())
    return dict(wall_ms=wall_ms,
                device_ms=busy if busy else "not measured",
                idle_share=1 - busy / wall_ms if busy else "not measured",
                device_kernels=n_kernels,
                device_ms_by_group={k: round(v, 3) for k, v in
                                    sorted(groups.items(),
                                           key=lambda kv: -kv[1])},
                top_kernels_ms={k: round(v, 3) for k, v in
                                sorted(top.items(),
                                       key=lambda kv: -kv[1])[:8]})


def plain_backward_ms(torch, dev, cfg, rows: int) -> dict:
    """Time of one call of K1's and K2's backward (the plain versions'
    gradients, recomputed) at a training microbatch of ``rows`` x 1024
    tokens of ``cfg``, bf16: the profile groups their kernels with the
    others by name, so they are timed alone."""
    from repro_torch.kernels.flash_attention.ref import \
        attention_backward_ref
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_backward_ref
    g = torch.Generator(device=dev).manual_seed(SEED)
    hd, S = cfg.resolved_head_dim, TRAIN["seq"]
    q, gout = (torch.randn(rows, S, cfg.n_heads, hd, generator=g,
                           device=dev).bfloat16() for _ in range(2))
    k, v = (torch.randn(rows, S, cfg.n_kv_heads, hd, generator=g,
                        device=dev).bfloat16() for _ in range(2))
    x = torch.randn(rows * S, cfg.d_model, generator=g, device=dev)\
        .bfloat16()
    w = torch.randn(cfg.d_model, generator=g, device=dev)
    return {"flash_attention": cuda_ms(
                torch, lambda: attention_backward_ref(q, k, v, gout), iters=5),
            "rmsnorm": cuda_ms(
                torch, lambda: rmsnorm_backward_ref(x, w, x), iters=10)}


def load_weights(torch, model, weights) -> None:
    """Writes ``weights`` (tensors by parameter name) into the model's own
    parameters."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(weights[n])


def state_fingerprint(torch, params, opt_state) -> dict:
    """Per tensor of a training state (params, AdamW's mu, nu and masters),
    two sums of its bits as int64, computed on the card: a changed bit
    changes them, so equal prints stand for a bitwise comparison without
    the state's 17 GB leaving the card."""
    tensors = {f"params.{n}": t for n, t in params.items()}
    for part in ("mu", "nu", "master"):
        tree = getattr(opt_state, part) or {}
        tensors.update({f"{part}.{n}": t for n, t in tree.items()})
    out = {}
    for name, t in tensors.items():
        t = t.detach().contiguous().reshape(-1)
        bits = t.view({2: torch.int16, 4: torch.int32}[t.element_size()])\
            .to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        out[name] = (int(bits.sum()), int((bits * weight).sum()))
        del bits, weight
    return out


def run_steps(torch, dev, step, params, opt_state, batches):
    """``step`` over ``batches``: per step loss, grad norm and synchronised
    wall ms."""
    from repro_torch.train import batch_to
    rows = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, batch_to(b, dev))
        torch.cuda.synchronize()
        rows.append(dict(loss=m["loss"].item(),
                         grad_norm=m["grad_norm"].item(),
                         ms=(time.perf_counter() - t0) * 1e3, lr=m["lr"]))
    return rows, params, opt_state


def phase_train(torch, dev, launches):
    """llama3.2-1b trained at full width on the card through
    ``make_train_step`` (bf16 params, f32 masters, remat, accum 2), with K1
    and K2 under autograd, against the same steps on the plain path from
    the same weights and batches; then one step of a 2-layer model at the
    same widths on the card against the CPU."""
    import dataclasses
    from repro_torch import optim
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.train import (batch_to, init_train_state,
                                   make_loss_and_grad, make_train_step)
    cfg = get_config(TRAIN_ARCH)
    accum, steps = TRAIN["accum"], TRAIN["steps"]
    model = build_model(cfg, device=dev, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    ocfg = optim.AdamWConfig(**TRAIN_OPT)
    corpus = SyntheticCorpus(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=TRAIN["seq"],
        global_batch=TRAIN["global_batch"]))
    batches = [corpus.batch(i) for i in range(steps)]
    tokens = TRAIN["global_batch"] * TRAIN["seq"]

    # every leaf gets a finite, nonzero gradient on the kernel path, and
    # each lies near the plain path's
    params = {n: p.detach() for n, p in model.named_parameters()}
    lg = make_loss_and_grad(model, accum=accum)
    b0 = batch_to(batches[0], dev)
    _, g_kernel = lg(params, b0)
    model.use_kernels = False
    _, g_plain = lg(params, b0)
    model.use_kernels = True
    leaf = {}
    for n, gk in g_kernel.items():
        nk = gk.norm().item()
        if not (math.isfinite(nk) and nk > 0 and torch.isfinite(gk).all()):
            raise AssertionError(f"train: leaf {n} has gradient norm {nk} "
                                 f"on the kernel path")
        leaf[n] = ((gk - g_plain[n]).norm() / g_plain[n].norm()).item()
    worst = max(leaf, key=leaf.get)
    if leaf[worst] > TRAIN_LEAF_GRAD_RTOL:
        raise AssertionError(f"train: leaf {worst}'s gradient lies "
                             f"{leaf[worst]:.3e} (by norm) from the plain "
                             f"path's")
    del g_kernel, g_plain

    # the kernel path's steps, then the same steps with the state cloned
    # before each step (the old and the new state side by side, as the
    # functional update kept them), then the plain path's, every run from
    # the same weights: the step updates the params, which share the
    # model's storage, in place
    step = make_train_step(model, ocfg, accum=accum, device=dev)
    # kept on the host, out of the peak the in-place run is held to
    weights0 = {n: p.cpu() for n, p in params.items()}
    params, opt_state = init_train_state(model, ocfg, seed=None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    launches.reset()
    kernel_rows, params, opt_state = run_steps(torch, dev, step, params,
                                               opt_state, batches)
    launches.read("train")
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    print(f"  train: peak {peak_gib:.2f} GiB allocated over "
          f"{steps} in-place steps (the functional update's: "
          f"{TRAIN_FUNCTIONAL_PEAK_GIB} GiB)", flush=True)
    in_place_print = state_fingerprint(torch, params, opt_state)
    # one more step, profiled, in two windows: loss-and-grad, AdamW
    b = batch_to(batches[0], dev)
    holder = {}
    prof_lg = profile_groups(torch, lambda: holder.update(
        lg=lg(params, b)))
    prof_opt = profile_groups(torch, lambda: optim.apply(
        ocfg, params, holder["lg"][1], opt_state))
    del params, opt_state, holder
    per_step = {k: n / steps for k, n in launches.phases["train"].items()}
    want = expected_train_launches(cfg, accum)
    if per_step != want:
        raise AssertionError(f"train: launches per step {per_step}, the "
                             f"config gives {want}")
    if peak_gib > TRAIN_FUNCTIONAL_PEAK_GIB - TRAIN_PEAK_DROP_GIB:
        raise AssertionError(f"train: the in-place steps peaked at "
                             f"{peak_gib:.2f} GiB, not {TRAIN_PEAK_DROP_GIB}"
                             f" GiB below {TRAIN_FUNCTIONAL_PEAK_GIB}")

    def clone_step(params, opt_state, batch):
        return step(*optim.clone_state((params, opt_state)), batch)

    load_weights(torch, model, weights0)
    params, opt_state = init_train_state(model, ocfg, seed=None)
    torch.cuda.reset_peak_memory_stats(dev)
    launches.reset()
    clone_rows, params, opt_state = run_steps(torch, dev, clone_step,
                                              params, opt_state, batches)
    launches.read("train clone-based")
    clone_peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    clone_print = state_fingerprint(torch, params, opt_state)
    del params, opt_state
    if launches.phases["train clone-based"] != launches.phases["train"]:
        raise AssertionError(f"train: the clone-based steps launched "
                             f"{launches.phases['train clone-based']}, the "
                             f"in-place ones {launches.phases['train']}")
    clone_differs = [k for k in in_place_print
                     if clone_print[k] != in_place_print[k]]
    if ([r["loss"] for r in clone_rows] != [r["loss"] for r in kernel_rows]
            or clone_differs):
        raise AssertionError(f"train: the in-place steps are not bitwise "
                             f"the clone-based ones: losses "
                             f"{[r['loss'] for r in kernel_rows]} vs "
                             f"{[r['loss'] for r in clone_rows]}, leaves "
                             f"{clone_differs[:5]}")
    print(f"  train: clone-based run bitwise the in-place one (losses and "
          f"all {len(in_place_print)} leaves of params, mu, nu and "
          f"masters); its peak {clone_peak_gib:.2f} GiB", flush=True)
    model.use_kernels = False
    load_weights(torch, model, weights0)
    del weights0
    params, opt_state = init_train_state(model, ocfg, seed=None)
    before = launches.snapshot()
    plain_rows, params, opt_state = run_steps(torch, dev, step, params,
                                              opt_state, batches)
    if launches.snapshot() != before:
        raise AssertionError("the plain training path launched a kernel")
    model.use_kernels = True
    del params, opt_state

    losses = [r["loss"] for r in kernel_rows]
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    dloss = [abs(a["loss"] - p["loss"]) for a, p in zip(kernel_rows,
                                                         plain_rows)]
    dnorm = [abs(a["grad_norm"] - p["grad_norm"]) / p["grad_norm"]
             for a, p in zip(kernel_rows, plain_rows)]
    if max(dloss) > TRAIN_LOSS_ATOL or max(dnorm) > TRAIN_GNORM_RTOL:
        raise AssertionError(f"train: kernel path against plain path: "
                             f"|dloss| {dloss}, grad norm rel {dnorm}")
    for i, (a, p) in enumerate(zip(kernel_rows, plain_rows)):
        print(f"  train step {i}: loss {a['loss']:.6f} (plain "
              f"{p['loss']:.6f})  grad_norm {a['grad_norm']:.6f} (plain "
              f"{p['grad_norm']:.6f})  lr {a['lr']:.3e}  {a['ms']:.1f} ms "
              f"(plain {p['ms']:.1f} ms)", flush=True)
    step_s = sorted(r["ms"] for r in kernel_rows[1:])[(steps - 1) // 2] / 1e3
    plain_s = sorted(r["ms"] for r in plain_rows[1:])[(steps - 1) // 2] / 1e3
    flops = train_flops(cfg, n_params, tokens, TRAIN["global_batch"],
                        TRAIN["seq"])
    del model
    torch.cuda.empty_cache()
    # the backward of each K1 and K2 call: 2L + 1 norms and L attentions a
    # microbatch
    bwd = plain_backward_ms(torch, dev, cfg, TRAIN["global_batch"] // accum)
    calls = {"rmsnorm": accum * (2 * cfg.n_layers + 1),
             "flash_attention": accum * cfg.n_layers}
    bwd_per_step = {k: bwd[k] * calls[k] for k in bwd}
    emit("train", arch=TRAIN_ARCH, params=n_params, **TRAIN,
         optimizer=TRAIN_OPT, steps_kernel=kernel_rows,
         steps_plain=plain_rows, median_step_s=step_s,
         plain_median_step_s=plain_s, steps_per_s=1 / step_s,
         tokens_per_s=tokens / step_s, plain_tokens_per_s=tokens / plain_s,
         peak_memory_gib=peak_gib, clone_based_peak_memory_gib=clone_peak_gib,
         functional_peak_memory_gib_pr17=TRAIN_FUNCTIONAL_PEAK_GIB,
         model_flops_per_step=flops,
         model_flops_share=flops / step_s / PEAK_FLOPS["bfloat16"],
         flops_note="6*N*tokens + 3x causal attention; remat's recompute "
                    "left out",
         max_abs_dloss=max(dloss), max_rel_dgrad_norm=max(dnorm),
         leaf_grad_rel_diff_max={worst: leaf[worst]},
         launches_per_step=per_step,
         plain_backward_ms_per_call=bwd,
         plain_backward_ms_per_step=bwd_per_step,
         profile_loss_and_grad=prof_lg,
         profile_adamw=prof_opt)
    card_vs_cpu(torch, dev, dataclasses.replace(cfg, n_layers=2))


def card_vs_cpu(torch, dev, cfg):
    """One training step of ``cfg`` (llama's widths, 2 layers), batch 2 x
    128, bf16, on the card with the kernels and on the CPU from the same
    weights: loss and grad norm within CARD_VS_CPU_RTOL, and every leaf's
    gradient within CARD_VS_CPU_LEAF_RTOL of the CPU's by norm (the
    embedding's is the one ``LogitsFn``'s backward makes on the card)."""
    from repro_torch import optim
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.models.registry import build_model
    from repro_torch.train import (batch_to, init_train_state,
                                   make_loss_and_grad)
    ocfg = optim.AdamWConfig(**TRAIN_OPT)
    batch = SyntheticCorpus(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=128, global_batch=2)).batch(0)
    card = build_model(cfg, device=dev, seed=SEED)
    cpu = build_model(cfg, device="cpu", seed=None)
    cpu.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    out, grads = {}, {}
    for name, model, d in (("card", card, dev),
                           ("cpu", cpu, torch.device("cpu"))):
        params, opt_state = init_train_state(model, ocfg, seed=None)
        t0 = time.perf_counter()
        # make_train_step's body, with the gradients kept
        loss, grads[name] = make_loss_and_grad(model, accum=1)(
            params, batch_to(batch, d))
        _, _, m = optim.apply(ocfg, params, grads[name], opt_state)
        out[name] = dict(loss=loss.item(), grad_norm=m["grad_norm"].item(),
                         seconds=time.perf_counter() - t0)
        del params, opt_state
    rel = {k: abs(out["card"][k] - out["cpu"][k]) / abs(out["cpu"][k])
           for k in ("loss", "grad_norm")}
    leaf = {n: ((gk.cpu() - grads["cpu"][n]).norm()
                / grads["cpu"][n].norm()).item()
            for n, gk in grads["card"].items()}
    worst = max(leaf, key=leaf.get)
    emit("train card_vs_cpu", layers=cfg.n_layers, batch=2, seq=128,
         **out, relative=rel, rtol=CARD_VS_CPU_RTOL,
         leaf_grad_rel_diff={"worst": {worst: leaf[worst]},
                             "embed": leaf["embed"]},
         leaf_rtol=CARD_VS_CPU_LEAF_RTOL)
    if max(rel.values()) > CARD_VS_CPU_RTOL:
        raise AssertionError(f"train: the card against the CPU: {out}, "
                             f"relative {rel}")
    if leaf[worst] > CARD_VS_CPU_LEAF_RTOL:
        raise AssertionError(f"train: leaf {worst}'s gradient on the card "
                             f"lies {leaf[worst]:.3e} (by norm) from the "
                             f"CPU's")
    del card, cpu, grads
    torch.cuda.empty_cache()


# the sync phase: 4 gloo ranks on the one card train llama3.2-1b's widths
# through every manual-sync mode, against the single-rank step
SYNC_ARCH = "llama3.2-1b"
SYNC_RANKS = 4
# 2 layers: four replicas share the card.  At 3 a rank peaks at 17.0 GiB
# and the card kept 0.7-2.0 GiB free (PERF.md, PR 18), too little to count
# on; at 2, 15.8 GiB a rank
SYNC = dict(layers=2, seq=1024, global_batch=8, accum=2, steps=3)
SYNC_GRIDS = {"22": ((2, 2), ("pod", "data")), "41": ((4, 1), ("pod", "data")),
              "14": ((1, 4), ("pod", "data"))}
# hier_bucketed against the single-rank step: the reference's bound between
# modes (tests/test_bucketing.py:211-212)
SYNC_BOUND = dict(rtol=1e-4, atol=1e-5)
INT8_EF = dict(slow_compress_bits=8, slow_error_feedback=True)
SYNC_RUNS = {
    "hier_bucketed": dict(cross_pod_mode="hier_bucketed"),
    "zero1": dict(cross_pod_mode="hier_bucketed_zero1"),
    "zero1_overlap": dict(cross_pod_mode="hier_bucketed_zero1",
                          overlap=True),
    "zero1_int8_ef": dict(cross_pod_mode="hier_bucketed_zero1", **INT8_EF),
    "zero1_int8_ef_overlap": dict(cross_pod_mode="hier_bucketed_zero1",
                                  overlap=True, **INT8_EF),
}
# the reduced model, f32, for the gates that need many steps or several
# grids (the optimizers of tests/test_torch_sync_train.py)
SYNC_REDUCED = dict(seq=64, global_batch=8, accum=2)
SYNC_REDUCED_OPT = {"a": dict(peak_lr=1e-3, warmup_steps=2, total_steps=30),
                    "b": dict(peak_lr=3e-3, warmup_steps=2, total_steps=20)}
SMALL_BUCKETS = 64 << 10
SYNC_REDUCED_RUNS = {
    "hier": dict(cross_pod_mode="hier", steps=4, grid="22", ocfg="a"),
    **{f"det_{g}": dict(cross_pod_mode="hier_bucketed_zero1",
                        deterministic_reduce=True, steps=4, grid=g,
                        ocfg="a") for g in SYNC_GRIDS},
    "curve_f32": dict(cross_pod_mode="hier_bucketed", steps=15, grid="22",
                      ocfg="b", bucket_bytes=SMALL_BUCKETS),
    "curve_int8": dict(cross_pod_mode="hier_bucketed", steps=15, grid="22",
                       ocfg="b", bucket_bytes=SMALL_BUCKETS,
                       slow_compress_bits=8),
    "curve_int8_ef": dict(cross_pod_mode="hier_bucketed", steps=15,
                          grid="22", ocfg="b", bucket_bytes=SMALL_BUCKETS,
                          **INT8_EF),
}
SYNC_DEADLINE_S = 600
# the split of a step, in order, from the collectives' STATS keys
SYNC_SPLIT = ("loss_and_grad", "d2h", "fast reduce_scatter",
              "slow all_reduce", "slow all_gather", "fast all_gather", "h2d",
              "optimizer")


def sync_batches(torch, dev, vocab: int, shape: dict, steps: int):
    """Global batches 0..steps-1 of ``SyntheticCorpus`` (seed 0, one
    shard) on ``dev``."""
    from repro_torch.data import DataConfig, SyntheticCorpus
    from repro_torch.train import batch_to
    corpus = SyntheticCorpus(DataConfig(
        vocab_size=vocab, seq_len=shape["seq"],
        global_batch=shape["global_batch"], seed=0))
    return [batch_to(corpus.batch(i), dev) for i in range(steps)]


def param_digest(torch, params) -> str:
    """sha256 of the parameters' bytes, in name order."""
    import hashlib
    h = hashlib.sha256()
    for name in sorted(params):
        h.update(name.encode())
        h.update(params[name].detach().contiguous().view(torch.uint8).cpu()
                 .numpy().tobytes())
    return h.hexdigest()


def sync_run(torch, dev, model, grid, kw: dict, batches, ocfg_kw: dict,
             accum: int, kernels: dict) -> dict:
    """One run of ``make_train_step`` on ``grid`` from the weights of SEED:
    per step loss, grad norm, seconds (synchronised), launches of each
    kernel, the collectives' split and the params' digest."""
    from repro_torch import optim, train
    from repro_torch.parallel.collectives import STATS
    opts = {k: v for k, v in kw.items()
            if k not in ("cross_pod_mode", "steps", "grid", "ocfg")}
    mode = kw["cross_pod_mode"]
    ocfg = optim.AdamWConfig(**ocfg_kw)
    state_kw = {k: opts[k] for k in ("bucket_bytes", "slow_error_feedback",
                                     "deterministic_reduce") if k in opts}
    params, state = train.init_train_state(
        model, ocfg, seed=SEED, grid=grid, cross_pod_mode=mode, **state_kw)
    step = train.make_train_step(model, ocfg, accum=accum, device=dev,
                                 grid=grid, cross_pod_mode=mode, **opts)
    rows = []
    for b in batches[:kw.get("steps", len(batches))]:
        STATS.reset()
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        params, state, m = step(params, state, b)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        rows.append(dict(loss=m["loss"].item(),
                         grad_norm=m["grad_norm"].item(), seconds=seconds,
                         launches={n: k.launches
                                   for n, k in kernels.items()},
                         stats=STATS.snapshot(),
                         digest=param_digest(torch, params),
                         # the card's free memory while every rank's
                         # allocator still holds what its step reserved
                         card_free_gib=torch.cuda.mem_get_info(dev)[0]
                         / 2 ** 30))
    out = {"steps": rows}
    if isinstance(state, train.EFState):
        out["residual_digest"] = param_digest(
            torch, {str(i): r for i, r in enumerate(state.residuals)})
        out["residual_abs_sum"] = float(sum(r.abs().sum().item()
                                            for r in state.residuals))
    del params, state, step
    torch.cuda.empty_cache()
    return out


def gloo_takes_cuda_tensors(torch, dev, grid) -> bool:
    """Whether this torch's gloo reduce-scatters a CUDA tensor itself (the
    port stages through host memory either way)."""
    import torch.distributed as dist
    import warnings
    ax = grid.axis("data")
    x = torch.ones(ax.size * 4, device=dev)
    out = torch.empty(4, device=dev)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.reduce_scatter_tensor(out, x, group=ax.group)
        return bool((out == ax.size).all().item())
    except (RuntimeError, ValueError, TypeError):
        return False


def sync_rank(rank: int, world: int) -> dict:
    """One rank of the sync phase's gloo job, on the card: the full-width
    runs (``SYNC_RUNS``) on the (2, 2) grid, then the reduced runs
    (``SYNC_REDUCED_RUNS``) on theirs.  Returns numbers for the parent,
    which alone prints."""
    import dataclasses
    import torch
    from repro_torch.kernels._build import all_kernels
    from repro_torch.models.registry import (build_model, get_config,
                                             reduced_config)
    from repro_torch.parallel.mesh import make_rank_grid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {k.name: k for k in all_kernels()}
    grids = {g: make_rank_grid(*SYNC_GRIDS[g]) for g in SYNC_GRIDS}
    out = {"rank": rank,
           "gloo_takes_cuda_tensors": gloo_takes_cuda_tensors(
               torch, dev, grids["22"]), "full": {}, "reduced": {}}
    cfg = dataclasses.replace(get_config(SYNC_ARCH), n_layers=SYNC["layers"])
    model = build_model(cfg, device=dev, seed=None)
    batches = sync_batches(torch, dev, cfg.vocab_size, SYNC, SYNC["steps"])
    torch.cuda.reset_peak_memory_stats(dev)
    for name, kw in SYNC_RUNS.items():
        out["full"][name] = sync_run(torch, dev, model, grids["22"], kw,
                                     batches, TRAIN_OPT, SYNC["accum"],
                                     kernels)
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    out["card_free_gib"] = min(s["card_free_gib"] for run in
                               out["full"].values() for s in run["steps"])
    out["card_total_gib"] = torch.cuda.mem_get_info(dev)[1] / 2 ** 30
    del model, batches
    torch.cuda.empty_cache()
    rcfg = reduced_config(get_config(SYNC_ARCH))
    rmodel = build_model(rcfg, device=dev, seed=None, dtype=torch.float32,
                         remat=False)
    rbatches = sync_batches(torch, dev, rcfg.vocab_size, SYNC_REDUCED, 15)
    for name, kw in SYNC_REDUCED_RUNS.items():
        out["reduced"][name] = sync_run(
            torch, dev, rmodel, grids[kw["grid"]], kw, rbatches,
            SYNC_REDUCED_OPT[kw["ocfg"]], SYNC_REDUCED["accum"], kernels)
    return out


def sync_oracle(torch, dev, model, batches, ocfg_kw: dict, accum: int,
                steps: int) -> list:
    """The single-rank ``"xla"`` step on the global batches, accum x ranks
    microbatches: (loss, grad norm) per step."""
    from repro_torch import optim
    from repro_torch.train import init_train_state, make_train_step
    ocfg = optim.AdamWConfig(**ocfg_kw)
    step = make_train_step(model, ocfg, accum=accum * SYNC_RANKS,
                           device=dev)
    params, state = init_train_state(model, ocfg, seed=SEED)
    rows = []
    for b in batches[:steps]:
        params, state, m = step(params, state, b)
        rows.append((m["loss"].item(), m["grad_norm"].item()))
    del params, state
    return rows


def tier_rates(stats: dict, grid_shape) -> dict:
    """Per (tier op): bytes and seconds of one step, the effective GB/s and
    bus GB/s, beside ``gpu_collective``'s SHM (fast) or NET (slow)
    prediction for the same op and bytes."""
    from repro_torch.collectives.transport import _ring_factor, \
        gpu_collective
    S, F = grid_shape
    out = {}
    for key, nbytes in stats["bytes"].items():
        if " " not in key or nbytes < 1 << 16:    # not the scalars' psums
            continue
        tier, op = key.split(" ")
        n = F if tier == "fast" else S
        sec = stats["seconds"][key]
        model = gpu_collective(op, nbytes, transport="SHM" if tier == "fast"
                               else "NET", leaves_per_gpu=(n,))
        out[key] = dict(bytes=nbytes, seconds=sec, calls=stats["calls"][key],
                        algo_gbps=nbytes / sec / 1e9,
                        bus_gbps=nbytes * _ring_factor(op, n) / sec / 1e9,
                        model_transport=model.transport,
                        model_seconds=model.time_s,
                        model_bus_gbps=model.bus_bandwidth_gbps)
    return out


def phase_sync(torch, dev, launches):
    """The two-tier gradient sync on the card: the oracle (the single-rank
    step, accum x ranks microbatches) in this process, then 4 gloo ranks,
    each a process on this card, through every manual-sync mode; the
    gates, the split of a step and the tiers' rates against the analytic
    model."""
    import dataclasses
    from repro_torch.models.registry import (build_model, get_config,
                                             reduced_config)
    from repro_torch.parallel.launch import run_ranks
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(SYNC_ARCH), n_layers=SYNC["layers"])
    model = build_model(cfg, device=dev, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    batches = sync_batches(torch, dev, cfg.vocab_size, SYNC, SYNC["steps"])
    oracle = sync_oracle(torch, dev, model, batches, TRAIN_OPT,
                         SYNC["accum"], SYNC["steps"])
    del model, batches
    rcfg = reduced_config(get_config(SYNC_ARCH))
    rmodel = build_model(rcfg, device=dev, seed=SEED, dtype=torch.float32,
                         remat=False)
    rbatches = sync_batches(torch, dev, rcfg.vocab_size, SYNC_REDUCED, 4)
    roracle = sync_oracle(torch, dev, rmodel, rbatches,
                          SYNC_REDUCED_OPT["a"], SYNC_REDUCED["accum"], 4)
    del rmodel, rbatches
    torch.cuda.empty_cache()
    mig = subprocess.run(
        ["nvidia-smi", "--query-gpu=mig.mode.current",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(f"  sync: MIG mode {mig!r} (information only)", flush=True)
    parent_gib = torch.cuda.memory_reserved(dev) / 2 ** 30
    # the ranks' allocators: four processes share the card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    t0 = time.perf_counter()
    res = run_ranks(sync_rank, SYNC_RANKS, deadline_s=SYNC_DEADLINE_S,
                    timeout_s=300)
    ranks_s = time.perf_counter() - t0
    full = [r["full"] for r in res]
    reduced = [r["reduced"] for r in res]

    def losses(run):
        return [s["loss"] for s in run["steps"]]

    def digests(run):
        return [s["digest"] for s in run["steps"]]

    # every rank holds the same parameters after every step
    for part in (full, reduced):
        for name, run in part[0].items():
            n = int(np.prod(SYNC_GRIDS[SYNC_REDUCED_RUNS[name]["grid"]][0]
                            if part is reduced else SYNC_GRIDS["22"][0]))
            for r in range(1, n):
                if (digests(part[r][name]) != digests(run)
                        or losses(part[r][name]) != losses(run)):
                    raise AssertionError(f"sync {name}: rank {r}'s params "
                                         f"or losses differ from rank 0's")
    # hier_bucketed against the single-rank step
    got = [(s["loss"], s["grad_norm"]) for s in
           full[0]["hier_bucketed"]["steps"]]
    rel = np.abs(np.subtract(got, oracle)) / np.abs(oracle)
    np.testing.assert_allclose(got, oracle, **SYNC_BOUND,
                               err_msg="sync: hier_bucketed vs oracle")
    # the bitwise invariants of the reference
    for a, b in (("hier_bucketed", "zero1"), ("zero1", "zero1_overlap"),
                 ("zero1_int8_ef", "zero1_int8_ef_overlap")):
        for r in range(SYNC_RANKS):
            ra, rb = full[r][a], full[r][b]
            if (losses(ra) != losses(rb) or digests(ra) != digests(rb)
                    or ra.get("residual_digest") != rb.get(
                        "residual_digest")):
                raise AssertionError(f"sync: {b} is not bitwise {a} on "
                                     f"rank {r}")
    if not full[0]["zero1_int8_ef"]["residual_abs_sum"] > 0:
        raise AssertionError("sync: the int8 residuals stayed zero")
    # K1 and K2 launch as the config gives, in every rank's every step
    want = expected_train_launches(cfg, SYNC["accum"])
    for r in range(SYNC_RANKS):
        for name, run in full[r].items():
            for s in run["steps"]:
                if s["launches"] != want:
                    raise AssertionError(f"sync {name}: rank {r} launched "
                                         f"{s['launches']} in a step, the "
                                         f"config gives {want}")
    launches.phases["sync"] = {
        k: sum(s["launches"][k] for fr in full for run in fr.values()
               for s in run["steps"]) for k in want}
    # reduced width: the deterministic reduce across factorizations, the
    # per-tensor mode against the oracle, int8 with error feedback
    det_runs = [reduced[0][f"det_{g}"] for g in SYNC_GRIDS]
    for other in det_runs[1:]:
        if (losses(other) != losses(det_runs[0])
                or digests(other) != digests(det_runs[0])):
            raise AssertionError("sync: the deterministic reduce differs "
                                 "across (2,2), (4,1) and (1,4)")
    rgot = [(s["loss"], s["grad_norm"]) for s in
            reduced[0]["hier"]["steps"]]
    np.testing.assert_allclose(rgot, roracle, **SYNC_BOUND,
                               err_msg="sync: hier vs oracle (reduced)")
    base = np.asarray(losses(reduced[0]["curve_f32"]))
    dev_int8 = np.abs(np.asarray(losses(reduced[0]["curve_int8"])) - base)
    dev_ef = np.abs(np.asarray(losses(reduced[0]["curve_int8_ef"])) - base)
    if not dev_ef.sum() < dev_int8.sum():
        raise AssertionError(f"sync: int8 with error feedback deviates "
                             f"{dev_ef.sum()} from f32, int8 alone "
                             f"{dev_int8.sum()}")

    # the report: rank 0's median step of each full-width run, its split
    report = {}
    for name, run in full[0].items():
        steps = run["steps"]
        mid = sorted(steps[1:], key=lambda s: s["seconds"])[
            (len(steps) - 2) // 2]
        secs = mid["stats"]["seconds"]
        split = {k: secs.get(k, 0.0) for k in SYNC_SPLIT}
        split["other"] = mid["seconds"] - sum(split.values())
        report[name] = dict(
            step_s=[s["seconds"] for s in steps], median_step_s=mid["seconds"],
            tokens_per_s=SYNC["global_batch"] * SYNC["seq"] / mid["seconds"],
            loss=losses(run), grad_norm=[s["grad_norm"] for s in steps],
            split_s=split,
            sync_share=1 - (split["loss_and_grad"] + split["optimizer"])
            / mid["seconds"],
            bytes_per_tier={t: sum(v for k, v in mid["stats"]["bytes"].items()
                                   if k.startswith(t + " "))
                            for t in ("fast", "slow")},
            tiers=tier_rates(mid["stats"], SYNC_GRIDS["22"][0]))
        print(f"  sync {name}: step {mid['seconds']:.3f} s (steps "
              f"{', '.join(f'{s:.3f}' for s in report[name]['step_s'])}); "
              f"split " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
              + f"; bytes fast {report[name]['bytes_per_tier']['fast']}, "
              f"slow {report[name]['bytes_per_tier']['slow']}", flush=True)
        for key, t in report[name]["tiers"].items():
            print(f"    {name} {key}: {t['bytes']} B in {t['seconds']:.4f} s"
                  f" = {t['algo_gbps']:.3f} GB/s ({t['bus_gbps']:.3f} bus);"
                  f" the {t['model_transport']} model: "
                  f"{t['model_seconds']:.4f} s, {t['model_bus_gbps']:.3f} "
                  f"GB/s bus", flush=True)
    for i, ((lo, go), (lg, gg)) in enumerate(zip(oracle, got)):
        print(f"  sync step {i}: hier_bucketed loss {lg:.6f} grad_norm "
              f"{gg:.6f}; single rank {lo:.6f} {go:.6f}", flush=True)
    emit("sync", arch=SYNC_ARCH, params=n_params, ranks=SYNC_RANKS,
         grid=SYNC_GRIDS["22"], **SYNC,
         optimizer=TRAIN_OPT, seconds=time.perf_counter() - t_phase,
         ranks_seconds=ranks_s, mig_mode=mig,
         gloo_takes_cuda_tensors=[r["gloo_takes_cuda_tensors"] for r in res],
         peak_memory_gib=[r["peak_memory_gib"] for r in res],
         card_free_gib=[r["card_free_gib"] for r in res],
         card_total_gib=res[0]["card_total_gib"],
         parent_reserved_gib=parent_gib,
         oracle=oracle, hier_bucketed_rel_diff=rel.max(axis=0).tolist(),
         bound=SYNC_BOUND, launches_per_step_per_rank=want,
         runs=report,
         reduced=dict(
             oracle=roracle,
             hier=[(s["loss"], s["grad_norm"])
                   for s in reduced[0]["hier"]["steps"]],
             det_losses=losses(det_runs[0]),
             int8_dev_sum=float(dev_int8.sum()),
             int8_ef_dev_sum=float(dev_ef.sum())))


# ---------------------------------------------------------------------------
# checkpoint and elastic handoff
# ---------------------------------------------------------------------------

CKPT_ARCH = "llama3.2-1b"
# full width, 16 layers, the train phase's batch: a run of 4 steps (twice:
# the card's own spread), one of 2 steps that saves at its end (async,
# sharded), and a resume from that save to 4.  The checkpoint holds bf16
# params and f32 masters and moments, ≈ 17 GB
CKPT = dict(seq=1024, global_batch=8, accum=2, steps=4, save_at=2)
# everything the phases write lies under the gitignored chiprun_out/ and
# is deleted when the phase ends
CKPT_DIR = os.path.join(REPO, "chiprun_out", "ckpt_phase")
ELASTIC_DIR = os.path.join(REPO, "chiprun_out", "elastic_phase")
ELASTIC_ARCH = "llama3.2-1b"
ELASTIC_RANKS = 4
# llama3.2-1b's widths at 1 layer and half the sync phase's sequence: four
# ranks share the card, and on the (4,1) grid the fast axis has one rank,
# so each holds the whole f32 optimizer state.  At the sync phase's 2
# layers, with the functional AdamW holding the step's new state beside
# the old, that took ≈ 19.5 GiB a rank and ran the card out of memory
# (PERF.md); the in-place update lets it fit, which the probe shows with
# one step on (4,1) at 2 layers, while the schedule stays at 1 layer for
# time.  (2,2) -> (4,1) -> (1,4) -> (2,2) at steps 2, 4 and 6 of 8, as in
# tests/test_fault_matrix.py
ELASTIC = dict(layers=1, seq=512, global_batch=8, accum=2, steps=8,
               bucket_bytes=32 << 20)
ELASTIC_PROBE = dict(layers=2, shape=(4, 1), steps=1)
ELASTIC_SCHEDULE = ((2, (4, 1)), (4, (1, 4)), (6, (2, 2)))
# the reduced model in f32: a handoff against a drain cycle at one step,
# and the kill-and-resume, whose relaunch replays 6 steps and 2 handoffs
ELASTIC_REDUCED = dict(seq=64, global_batch=8, accum=2, steps=8,
                       bucket_bytes=64 << 10)
ELASTIC_DRAIN = ((2, (4, 1)),)
# the job is killed in the commit window of the second handoff (the
# manifest written, the renames pending): the relaunch resumes at step 2
ELASTIC_KILL = ("sharded.manifest", 2, 2)
ELASTIC_DEADLINE_S = 900


def _disk_free_gb(path: str) -> float:
    import shutil
    os.makedirs(path, exist_ok=True)
    return shutil.disk_usage(path).free / 1e9


def _trainer_run(torch, dev, model, ocfg, dcfg, n, *, every, resume,
                 fallback=False):
    """One ``Trainer`` run of ``n`` steps (every step logged) from the
    weights of SEED or, resuming, from the latest commit: its losses, its
    final state's digest (``ckpt.state.state_digest``), its checkpoint
    records, the recovery report and its wall seconds."""
    from repro_torch.ckpt.state import state_digest, state_tree
    from repro_torch.train import Trainer, TrainerConfig
    tcfg = TrainerConfig(n_steps=n, ckpt_every=every, ckpt_dir=CKPT_DIR,
                         log_every=1, accum=CKPT["accum"], async_ckpt=True,
                         save_sharded=True, fallback_on_corrupt=fallback)
    trainer = Trainer(model, ocfg, tcfg, dcfg, device=dev)
    t0 = time.perf_counter()
    out = trainer.run(seed=SEED, resume=resume)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    digest = state_digest(state_tree(out["params"], out["opt_state"]))
    rec = out["recovery"]
    del out["params"], out["opt_state"]
    torch.cuda.empty_cache()
    return dict(losses=[h["loss"] for h in out["history"]],
                step_s=[h["sec_per_step"] for h in out["history"]],
                digest=digest, checkpoints=trainer.checkpoints,
                restored=rec.restored_step if rec is not None else None,
                seconds=seconds)


def phase_ckpt(torch, dev, launches):
    """The sharded checkpoint at full width on the card: llama3.2-1b
    trained through ``Trainer`` (K1 and K2 under autograd), an async
    sharded save at step 2, a timed restore of it, and a fresh ``Trainer``
    that resumes from it.  Gates: the restored state is the saved state
    bit for bit (per-leaf digests), the resumed run's losses and final
    state are the uninterrupted run's, and K1 and K2 launch as
    ``expected_train_launches`` gives, K3 and K4 never.  Returns the
    kernels' launches a step, as counted."""
    import gc
    import shutil
    from repro_torch import ckpt, optim
    from repro_torch.ckpt.state import state_digest, state_tree
    from repro_torch.data import DataConfig
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.train import init_train_state
    t_phase = time.perf_counter()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    free_gb = _disk_free_gb(CKPT_DIR)
    cfg = get_config(CKPT_ARCH)
    model = build_model(cfg, device=dev, seed=SEED)
    ocfg = optim.AdamWConfig(**TRAIN_OPT)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=CKPT["seq"],
                      global_batch=CKPT["global_batch"])
    n, k = CKPT["steps"], CKPT["save_at"]
    launches.reset()
    runs = {}
    try:
        # two uninterrupted runs: the card's own spread
        for name in ("uninterrupted", "uninterrupted_again"):
            runs[name] = _trainer_run(torch, dev, model, ocfg, dcfg, n,
                                      every=10 ** 6, resume=False)
        runs["saved"] = _trainer_run(torch, dev, model, ocfg, dcfg, k,
                                     every=k, resume=False)
        sdir = ckpt.step_dir(CKPT_DIR, k)
        nbytes = sum(os.path.getsize(os.path.join(sdir, f))
                     for f in os.listdir(sdir))
        # the restore, timed alone, into a fresh state of the same shapes
        params, opt_state = init_train_state(model, ocfg, seed=SEED)
        template = state_tree(params, opt_state)
        del params, opt_state
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        step, tree = ckpt.restore_sharded(sdir, template)
        torch.cuda.synchronize(dev)
        restore_s = time.perf_counter() - t0
        del template
        restored = state_digest(tree)
        del tree
        torch.cuda.empty_cache()
        runs["resumed"] = _trainer_run(torch, dev, model, ocfg, dcfg, n,
                                       every=10 ** 6, resume=True,
                                       fallback=True)
        launches.read("ckpt")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    gc.collect()

    if step != k or restored != runs["saved"]["digest"]:
        bad = [key for key, d in restored.items()
               if runs["saved"]["digest"].get(key) != d]
        raise AssertionError(f"ckpt: the restored state is not the saved "
                             f"one (step {step}; leaves {bad[:5]})")
    if runs["resumed"]["restored"] != k:
        raise AssertionError(f"ckpt: the resumed Trainer restored step "
                             f"{runs['resumed']['restored']}, not {k}")
    ref, again = runs["uninterrupted"], runs["uninterrupted_again"]
    got = runs["saved"]["losses"] + runs["resumed"]["losses"]
    bitwise_runs = (ref["losses"] == again["losses"]
                    and ref["digest"] == again["digest"])
    if bitwise_runs:
        if got != ref["losses"] or runs["resumed"]["digest"] != ref["digest"]:
            raise AssertionError(f"ckpt: save at {k} and resume is not "
                                 f"bitwise the uninterrupted run: {got} vs "
                                 f"{ref['losses']}")
    else:
        # the card's two uninterrupted runs differ: hold the resumed run
        # to their spread
        spread = np.abs(np.subtract(again["losses"], ref["losses"])).max()
        dev_ = np.abs(np.subtract(got, ref["losses"])).max()
        if dev_ > spread:
            raise AssertionError(f"ckpt: the resumed run lies {dev_} from "
                                 f"the uninterrupted one, two "
                                 f"uninterrupted runs {spread}")
    # K1 and K2 launch as the config gives, the other kernels never
    want = expected_train_launches(cfg, CKPT["accum"])
    n_steps = 2 * n + k + (n - k)
    got_l = launches.phases["ckpt"]
    if got_l != {name: w * n_steps for name, w in want.items()}:
        raise AssertionError(f"ckpt: launches {got_l} in {n_steps} steps, "
                             f"the config gives {want} a step")
    per_step = {name: got // n_steps for name, got in got_l.items()}
    rec = runs["saved"]["checkpoints"][0]
    gb = nbytes / 1e9
    print(f"  ckpt: {gb:.3f} GB at step {k}; save {rec['save_s']:.3f} s ({gb / rec['save_s']:.3f} GB/s; "
          f"the step waited {rec['host_copy_s']:.3f} s for the host copy), "
          f"restore {restore_s:.3f} s ({gb / restore_s:.3f} GB/s); "
          f"runs bitwise: {bitwise_runs}", flush=True)
    emit("ckpt", arch=CKPT_ARCH, **CKPT, optimizer=TRAIN_OPT,
         params=sum(p.numel() for p in model.parameters()),
         disk_free_gb=free_gb, checkpoint_bytes=nbytes,
         save_s=rec["save_s"], host_copy_s=rec["host_copy_s"],
         save_gbps=gb / rec["save_s"], restore_s=restore_s,
         restore_gbps=gb / restore_s,
         uninterrupted_bitwise_twice=bitwise_runs,
         losses={name: r["losses"] for name, r in runs.items()},
         step_s={name: r["step_s"] for name, r in runs.items()},
         run_s={name: r["seconds"] for name, r in runs.items()},
         launches_per_step=per_step, seconds=time.perf_counter() - t_phase)
    del model
    torch.cuda.empty_cache()
    return per_step


def _driver_runs(torch, dev, model, runs: dict, shape: dict, kernels,
                 plan=None) -> dict:
    """``ElasticDriver`` runs in this rank: per run its losses, grids,
    handoff measurements, start step and the kernels' launches."""
    import contextlib
    from repro_torch import optim
    from repro_torch.data import DataConfig
    from repro_torch.elastic_driver import ElasticDriver, ReconfigEvent
    from repro_torch.faults import FaultPlan, FaultSpec, install
    out = {}
    for name, run in runs.items():
        drv = ElasticDriver(
            model, optim.AdamWConfig(**TRAIN_OPT),
            DataConfig(vocab_size=model.cfg.vocab_size, seq_len=shape["seq"],
                       global_batch=shape["global_batch"], seed=0),
            base_dir=os.path.join(ELASTIC_DIR, run["base"]),
            bucket_bytes=shape["bucket_bytes"], accum=shape["accum"],
            mode=run.get("mode", "handoff"), device=dev)
        for k in kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        armed = (install(FaultPlan([FaultSpec(plan[0], "crash",
                                              hit=plan[1])]))
                 if plan is not None else contextlib.nullcontext())
        with armed:
            res = drv.run(run["steps"],
                          [ReconfigEvent(step=s, mesh_shape=m)
                           for s, m in run["schedule"]],
                          initial_shape=run.get("initial", (2, 2)),
                          seed=SEED, resume=run.get("resume", False))
        out[name] = dict(losses=res.losses, shapes=res.mesh_shapes,
                         start=res.start_step,
                         measurements=[m.to_dict()
                                       for m in res.measurements],
                         steady_step_s=res.steady_step_s,
                         state_bytes=res.state_bytes,
                         peak_memory_gib=torch.cuda.max_memory_allocated(
                             dev) / 2 ** 30,
                         launches={n: k.launches
                                   for n, k in kernels.items()})
        del res
        torch.cuda.empty_cache()
    return out


def elastic_rank(rank: int, world: int, part: str) -> dict:
    """One rank of the elastic phase's gloo job, on the card.  ``part``:
    "main" (llama3.2-1b's widths at 1 layer: the uninterrupted run, the
    3-handoff run and a drain cycle; then the reduced model's handoff and
    drain), "kill" (the reduced model's 3-handoff run, this job SIGKILLed
    at ``ELASTIC_KILL``) or "resume" (its relaunch)."""
    import dataclasses
    import torch
    from repro_torch.kernels._build import all_kernels
    from repro_torch.models.registry import (build_model, get_config,
                                             reduced_config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernels = {k.name: k for k in all_kernels()}
    rcfg = reduced_config(get_config(ELASTIC_ARCH))
    reduced = dict(ELASTIC_REDUCED)
    full_steps = ELASTIC["steps"]
    steps = reduced["steps"]
    if part in ("kill", "resume"):
        rmodel = build_model(rcfg, device=dev, seed=None,
                             dtype=torch.float32, remat=False)
        point, hit, _ = ELASTIC_KILL
        run = dict(schedule=ELASTIC_SCHEDULE, steps=steps, base="kill",
                   resume=part == "resume")
        return _driver_runs(torch, dev, rmodel, {"run": run}, reduced,
                            kernels, plan=(point, hit)
                            if part == "kill" else None)["run"]
    # the probe: one step on (4,1), where each rank holds the whole f32
    # optimizer state, at the sync phase's 2 layers
    pcfg = dataclasses.replace(get_config(ELASTIC_ARCH),
                               n_layers=ELASTIC_PROBE["layers"])
    model = build_model(pcfg, device=dev, seed=None)
    out = {"probe": _driver_runs(torch, dev, model, {"probe": dict(
        schedule=(), steps=ELASTIC_PROBE["steps"], base="probe",
        initial=ELASTIC_PROBE["shape"])}, ELASTIC, kernels)["probe"]}
    del model
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(ELASTIC_ARCH),
                              n_layers=ELASTIC["layers"])
    model = build_model(cfg, device=dev, seed=None)
    out["full"] = _driver_runs(torch, dev, model, {
        "uninterrupted": dict(schedule=(), steps=full_steps,
                              base="full_ref"),
        "handoff": dict(schedule=ELASTIC_SCHEDULE, steps=full_steps,
                        base="full_handoff"),
        "drain": dict(schedule=ELASTIC_DRAIN, mode="drain",
                      steps=ELASTIC_DRAIN[-1][0] + 1, base="full_drain")},
        ELASTIC, kernels)
    out["peak_memory_gib"] = max(r["peak_memory_gib"]
                                 for r in out["full"].values())
    del model
    torch.cuda.empty_cache()
    rmodel = build_model(rcfg, device=dev, seed=None, dtype=torch.float32,
                         remat=False)
    out["reduced"] = _driver_runs(torch, dev, rmodel, {
        "uninterrupted": dict(schedule=(), steps=steps, base="red_ref"),
        "handoff": dict(schedule=ELASTIC_DRAIN, steps=steps,
                        base="red_handoff"),
        "drain": dict(schedule=ELASTIC_DRAIN, mode="drain", steps=steps,
                      base="red_drain")}, reduced, kernels)
    return out


def _print_measurements(tag: str, run: dict) -> None:
    for m in run["measurements"]:
        print(f"    {tag} reconfig@{m['step']}: {tuple(m['from_shape'])}"
              f"->{tuple(m['to_shape'])} [{m['mode']}] save "
              f"{m['save_s']:.3f} s, restore {m['restore_s']:.3f} s, setup "
              f"{m['setup_s']:.3f} s, first step {m['first_step_s']:.3f} s "
              f"(steady {run['steady_step_s']:.3f}), {m['save_bytes']} B "
              f"on disk, state {m['state_bytes']} B, verified "
              f"{m['verified']}", flush=True)


def phase_elastic(torch, dev, launches):
    """The elastic handoff on the card: 4 gloo ranks run ``ElasticDriver``
    (``elastic_rank``).  Gates: every handoff verified; the 3-handoff
    run's losses (and the drain cycle's) bitwise the uninterrupted run's;
    in every run of every rank, the resumed one too, K1 and K2 launch a
    step as the config gives and K3 and K4 never; the job killed in a
    handoff's commit window resumes from the previous commit and
    continues bitwise.  Returns rank 0's launches a step at full width,
    as counted, and rank 0's full-width measurements by run (the
    handoffs of ``ELASTIC_SCHEDULE`` under "handoff", the drain cycle
    under "drain"), which the replay phase reads."""
    import dataclasses
    import shutil
    from repro_torch import ckpt
    from repro_torch.models.registry import get_config, reduced_config
    from repro_torch.parallel.launch import run_ranks
    import gc
    t_phase = time.perf_counter()
    shutil.rmtree(ELASTIC_DIR, ignore_errors=True)
    free_gb = _disk_free_gb(ELASTIC_DIR)
    gc.collect()
    torch.cuda.empty_cache()
    parent_gib = torch.cuda.memory_reserved(dev) / 2 ** 30
    card_free_gib = torch.cuda.mem_get_info(dev)[0] / 2 ** 30
    print(f"  elastic: this process holds {parent_gib:.2f} GiB, the card "
          f"has {card_free_gib:.2f} GiB free", flush=True)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    try:
        t0 = time.perf_counter()
        res = run_ranks(elastic_rank, ELASTIC_RANKS, args=("main",),
                        deadline_s=ELASTIC_DEADLINE_S, timeout_s=600)
        main_s = time.perf_counter() - t0
        # the job killed by its own fault plan, then relaunched
        t0 = time.perf_counter()
        try:
            run_ranks(elastic_rank, ELASTIC_RANKS, args=("kill",),
                      deadline_s=ELASTIC_DEADLINE_S, timeout_s=600)
        except RuntimeError as e:
            if f"exited with code -{int(signal.SIGKILL)}" not in str(e):
                raise
            killed = str(e).splitlines()[0]
        else:
            raise AssertionError("elastic: the job ran through its fault "
                                 "plan")
        last = ckpt.latest_step(os.path.join(ELASTIC_DIR, "kill"))
        resumed = run_ranks(elastic_rank, ELASTIC_RANKS, args=("resume",),
                            deadline_s=ELASTIC_DEADLINE_S, timeout_s=600)
        kill_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ELASTIC_DIR, ignore_errors=True)

    cfg = dataclasses.replace(get_config(ELASTIC_ARCH),
                              n_layers=ELASTIC["layers"])
    # K1 and K2 launch a rank a step as the config gives, K3 and K4 never:
    # at full width with remat, the reduced model without
    want = {"full": expected_train_launches(cfg, ELASTIC["accum"]),
            "reduced": expected_train_launches(
                reduced_config(get_config(ELASTIC_ARCH)),
                ELASTIC_REDUCED["accum"], remat=False)}

    def check_launches(tag, r, run, want):
        n = len(run["losses"])
        if run["launches"] != {k: w * n for k, w in want.items()}:
            raise AssertionError(f"elastic {tag}: rank {r} launched "
                                 f"{run['launches']} in {n} steps, the "
                                 f"config gives {want} a step")

    pcfg = dataclasses.replace(get_config(ELASTIC_ARCH),
                               n_layers=ELASTIC_PROBE["layers"])
    want["probe"] = expected_train_launches(pcfg, ELASTIC["accum"])
    for r in range(ELASTIC_RANKS):
        check_launches("probe", r, res[r]["probe"], want["probe"])
    probe_gib = [r["probe"]["peak_memory_gib"] for r in res]
    print(f"  elastic probe: one hier_bucketed_zero1 step on "
          f"{ELASTIC_PROBE['shape']} at {ELASTIC_PROBE['layers']} layers "
          f"completed, loss {res[0]['probe']['losses'][0]:.6f}; peak GiB a "
          f"rank {[round(g, 2) for g in probe_gib]}", flush=True)
    for part in ("full", "reduced"):
        for r in range(ELASTIC_RANKS):
            runs = res[r][part]
            ref = runs["uninterrupted"]["losses"]
            for name, run in runs.items():
                if run["losses"] != ref[:len(run["losses"])]:
                    raise AssertionError(
                        f"elastic {part} {name}: rank {r}'s losses "
                        f"{run['losses']} are not the uninterrupted "
                        f"run's {ref}")
                if not all(m["verified"] for m in run["measurements"]):
                    raise AssertionError(f"elastic {part} {name}: a "
                                         f"handoff was not verified")
                check_launches(f"{part} {name}", r, run, want[part])
    full0 = res[0]["full"]
    if [tuple(m["to_shape"]) for m in full0["handoff"]["measurements"]] \
            != [m for _, m in ELASTIC_SCHEDULE]:
        raise AssertionError("elastic: the handoffs did not run as "
                             "scheduled")
    kill_step = ELASTIC_KILL[2]
    rref = res[0]["reduced"]["uninterrupted"]["losses"]
    if last != kill_step or resumed[0]["start"] != kill_step:
        raise AssertionError(f"elastic: the killed job left latest step "
                             f"{last}, resumed at {resumed[0]['start']}; "
                             f"want {kill_step}")
    for r in range(ELASTIC_RANKS):
        if resumed[r]["losses"] != rref[kill_step:]:
            raise AssertionError(f"elastic: the resumed job's losses on "
                                 f"rank {r} are not the uninterrupted "
                                 f"run's")
        check_launches("resumed", r, resumed[r], want["reduced"])
    # rank 0's full-width uninterrupted run, as counted
    ref0 = res[0]["full"]["uninterrupted"]
    per_step = {k: n // len(ref0["losses"])
                for k, n in ref0["launches"].items()}
    launches.phases["elastic"] = {
        k.name: sum(run["launches"][k.name] for rr in res
                    for part in ("full", "reduced")
                    for run in rr[part].values())
        + sum(rr["probe"]["launches"][k.name] for rr in res)
        + sum(rr["launches"][k.name] for rr in resumed)
        for k in launches.kernels}

    for part in ("full", "reduced"):
        for name, run in res[0][part].items():
            print(f"  elastic {part} {name}: steady step "
                  f"{run['steady_step_s']:.3f} s, losses "
                  f"{[round(x, 6) for x in run['losses']]}", flush=True)
            _print_measurements(f"{part} {name}", run)
    _print_measurements("resumed", resumed[0])
    print(f"  elastic: killed job: {killed}", flush=True)
    print(f"  elastic: peak GiB a rank "
          f"{[round(r['peak_memory_gib'], 2) for r in res]}", flush=True)

    def cycle_s(m):
        # the reconfiguration itself; the first step is printed apart
        return m["save_s"] + m["setup_s"] + m["restore_s"]

    cycles = {part: {name: [cycle_s(m) for m in run["measurements"]]
                     for name, run in res[0][part].items()
                     if run["measurements"]}
              for part in ("full", "reduced")}
    emit("elastic", arch=ELASTIC_ARCH, ranks=ELASTIC_RANKS, **ELASTIC,
         schedule=ELASTIC_SCHEDULE, drain=ELASTIC_DRAIN,
         reduced=ELASTIC_REDUCED, kill=ELASTIC_KILL, optimizer=TRAIN_OPT,
         disk_free_gb=free_gb, seconds=time.perf_counter() - t_phase,
         main_s=main_s, kill_and_resume_s=kill_s,
         parent_reserved_gib=parent_gib, card_free_gib=card_free_gib,
         peak_memory_gib=[r["peak_memory_gib"] for r in res],
         probe=dict(ELASTIC_PROBE, peak_memory_gib=probe_gib,
                    loss=res[0]["probe"]["losses"]),
         launches_per_step_per_rank=per_step,
         expected_launches_per_step_per_rank=want,
         measurements={part: {name: run["measurements"]
                              for name, run in res[0][part].items()}
                       for part in ("full", "reduced")},
         resumed_measurements=resumed[0]["measurements"],
         steady_step_s={part: {name: run["steady_step_s"]
                               for name, run in res[0][part].items()}
                        for part in ("full", "reduced")},
         cycle_s=cycles)
    return per_step, {name: run["measurements"]
                      for name, run in res[0]["full"].items()}


# the cluster phase: the multi-tenant runtime co-schedules training jobs,
# each segment a worker process with gloo ranks of its own on this card.
# Run A is the reference's contention scenario (launch/cluster.py's demo:
# a 2x4 pool, backfill of depth 8, tenant beta's quota 6, the reference
# worker's reduced model), j0 at 18 steps in segments of 6 (a defrag of j0
# for j2 at step 6, a rebalance at step 12: j0's middle segment, a restore,
# 6 steps and a save, outlasts j2's 2 steps, which admit the rebalance),
# and beside it its crash case (a 1x4 pool, j_a SIGKILLed at its first
# step).  Run B is a trace of 3 jobs at
# llama3.2-1b's published widths at 1 layer on a 2x2 pool (at most 4 ranks
# live), the elastic phase's data: b0 and b1 fill the pool (2,1) each; b1
# leaves after 1 step, and the tier-0 b2, pinned to one host, finds the
# free devices split across hosts, so b0 is repacked (1,2) at its step-2
# boundary to admit it; b2 is b0's job run alone (the same seed and width),
# 8 steps in all.
CLUSTER_DIR = os.path.join(REPO, "chiprun_out", "cluster_phase")
CLUSTER_A = dict(pool=(2, 4), steps=18, segment_steps=6, policy="backfill",
                 depth=8, quotas={"beta": 6})
CLUSTER_CRASH = dict(pool=(1, 4), point="driver.first_step")
CLUSTER_B = dict(pool=(2, 2), layers=1, seq=512, global_batch=8,
                 bucket_bytes=32 << 20,
                 jobs=(("b0", 2, 4, 2, "acme", "normal", None),
                       ("b1", 2, 1, 1, "beta", "normal", None),
                       ("b2", 2, 3, 3, "beta", "high", "b1")))
CLUSTER_TIMEOUT_S = 600


def cluster_b_specs():
    from repro_torch.cluster import ClusterJobSpec
    from repro_torch.core.job import TIER_HIGH, TIER_NORMAL
    b = CLUSTER_B
    return [ClusterJobSpec(jid, size=size, n_steps=n, segment_steps=seg,
                           tenant=tenant, after=after,
                           priority_tier=TIER_HIGH if tier == "high"
                           else TIER_NORMAL,
                           n_layers=b["layers"], seq_len=b["seq"],
                           global_batch=b["global_batch"],
                           bucket_bytes=b["bucket_bytes"])
            for jid, size, n, seg, tenant, tier, after in b["jobs"]]


def cluster_run(name: str, specs, pool, **kw) -> tuple:
    """One ``ClusterRuntime`` run on the card under ``CLUSTER_DIR/name``:
    (its result, every segment's result file by job)."""
    import glob
    from repro_torch.cluster import ClusterRuntime, DevicePool
    base = os.path.join(CLUSTER_DIR, name)
    rt = ClusterRuntime(specs, pool=DevicePool(*pool), base_dir=base,
                        timeout_s=CLUSTER_TIMEOUT_S, **kw)
    res = rt.run()
    segs = {}
    for path in sorted(glob.glob(os.path.join(base, "*",
                                              "seg*.result.json"))):
        with open(path) as f:
            d = json.load(f)
        segs.setdefault(d["job_id"], []).append(d)
    return res, segs


def check_cluster_run(tag, res, segs, specs, want) -> dict:
    """The runtime's invariants on a run, as
    tests/test_cluster_runtime.py holds them: every job's steps, every
    measurement's costs, every segment on the card with K1 and K2 launched
    as the config gives (``want``, a step) and K3 and K4 never.  Returns
    rank 0's launches summed over the run's segments."""
    total = {k: 0 for k in want}
    for spec in specs:
        got = res.jobs[spec.job_id]
        if len(got.losses) != spec.n_steps or not all(
                math.isfinite(x) for x in got.losses):
            raise AssertionError(f"cluster {tag}: {spec.job_id} has "
                                 f"losses {got.losses}, want "
                                 f"{spec.n_steps}")
        done = segs.get(spec.job_id, [])
        if len(done) != len(got.segments):
            raise AssertionError(f"cluster {tag}: {spec.job_id} wrote "
                                 f"{len(done)} results for "
                                 f"{len(got.segments)} segments")
        for d in done:
            n = len(d["losses"])
            if d["device"] != "cuda" or d["kernel_launches"] != {
                    k: w * n for k, w in want.items()}:
                raise AssertionError(
                    f"cluster {tag}: {spec.job_id} segment at step "
                    f"{d['start_step']} ran on {d['device']} with "
                    f"launches {d['kernel_launches']} in {n} steps; the "
                    f"config gives {want} a step")
            for k in total:
                total[k] += d["kernel_launches"][k]
    for m in res.measurements:
        if not (m["save_s"] > 0 and m["restore_s"] > 0
                and m["state_bytes"] > 0 and m["save_bytes"] > 0):
            raise AssertionError(f"cluster {tag}: measurement {m}")
    return total


def _print_cluster(tag, res, segs) -> None:
    for r in res.repacks:
        print(f"  cluster {tag}: repack {r.job_id} [{r.reason}] at step "
              f"{r.at_step} {r.from_shape}->{r.to_shape}"
              + (f" (admits {r.requested_by})" if r.requested_by else ""),
              flush=True)
    for m in res.measurements:
        print(f"  cluster {tag}: boundary {m['job_id']}@{m['step']} "
              f"{tuple(m['from_shape'])}->{tuple(m['to_shape'])} "
              f"repack={m['repack']}: save {m['save_s']:.3f} s, restore "
              f"{m['restore_s']:.3f} s, setup {m['setup_s']:.3f} s, first "
              f"step {m['first_step_s']:.3f} s, {m['save_bytes']} B on "
              f"disk, state {m['state_bytes']} B", flush=True)
    for jid in sorted(segs):
        for d in segs[jid]:
            print(f"  cluster {tag}: {jid} steps {d['start_step']}-"
                  f"{d['end_step'] - 1} on {tuple(d['shape'])}: first step "
                  f"{d['first_step_s']:.3f} s, steady "
                  f"{d['steady_step_s']:.3f} s, peak GiB a rank "
                  f"{[round(g, 2) for g in d['peak_memory_gib']]}, losses "
                  f"{[round(x, 6) for x in d['losses']]}", flush=True)


def phase_cluster(torch, dev, launches):
    """The multi-tenant cluster runtime on the card (``CLUSTER_A``,
    ``CLUSTER_CRASH``, ``CLUSTER_B``): jobs co-scheduled by
    ``ClusterRuntime``, each segment a ``repro_torch.cluster.worker``
    process whose gloo ranks share this card.  Gates: as
    ``test_cluster_smoke_multidevice`` and
    ``test_cluster_fault_restarts_only_target_multidevice`` hold them, and
    run B's repack and its repacked job bitwise its run alone; every
    segment on the card with K1 and K2 as the config gives.  Returns rank
    0's launches over the phase's segments and run B's boundary
    measurements (``ReconfigCostModel.from_measurements``-shaped)."""
    import dataclasses
    import gc
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.core.scheduler import Scheduler
    from repro_torch.faults.plan import FaultPlan, FaultSpec
    from repro_torch.cluster import ClusterJobSpec
    from repro_torch.launch.cluster import demo_specs
    from repro_torch.models.registry import get_config, reduced_config
    t_phase = time.perf_counter()
    shutil.rmtree(CLUSTER_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    a = CLUSTER_A
    wall = {}

    def timed(name, *args, **kw):
        t0 = time.perf_counter()
        out = cluster_run(name, *args, **kw)
        wall[name] = time.perf_counter() - t0
        return out

    try:
        # run A and the crash case side by side, each with its own pool
        # and runtime (their ranks together use a few GiB of the card)
        specs_a = demo_specs(a["steps"], a["segment_steps"])
        specs_c = [ClusterJobSpec("j_a", size=2, n_steps=2),
                   ClusterJobSpec("j_b", size=2, n_steps=2)]
        with ThreadPoolExecutor(2) as ex:
            fut_a = ex.submit(timed, "a", specs_a, a["pool"],
                              scheduler=Scheduler(a["policy"],
                                                  depth=a["depth"],
                                                  quotas=a["quotas"]))
            fut_c = ex.submit(timed, "crash", specs_c,
                              CLUSTER_CRASH["pool"],
                              fault_plans={"j_a": FaultPlan([FaultSpec(
                                  CLUSTER_CRASH["point"], "crash",
                                  hit=1)])})
            res_a, segs_a = fut_a.result()
            res_c, segs_c = fut_c.result()
        specs_b = cluster_b_specs()
        res_b, segs_b = timed("b", specs_b, CLUSTER_B["pool"],
                              scheduler=Scheduler("backfill", depth=8))
    finally:
        shutil.rmtree(CLUSTER_DIR, ignore_errors=True)

    reduced = expected_train_launches(
        reduced_config(get_config("llama3.2-1b")), 1, remat=False)
    full1 = expected_train_launches(dataclasses.replace(
        get_config("llama3.2-1b"), n_layers=CLUSTER_B["layers"]), 1,
        remat=False)
    counts = [check_cluster_run("a", res_a, segs_a, specs_a, reduced),
              check_cluster_run("crash", res_c, segs_c, specs_c, reduced),
              check_cluster_run("b", res_b, segs_b, specs_b, full1)]
    # run A: the reference smoke's gates
    reasons = [r.reason for r in res_a.repacks]
    if len(reasons) < 2 or "defrag" not in reasons:
        raise AssertionError(f"cluster a: repacks {reasons}")
    defrag = res_a.repacks[reasons.index("defrag")]
    if (defrag.job_id, defrag.requested_by) != ("j0", "j2"):
        raise AssertionError(f"cluster a: the defrag moved "
                             f"{defrag.job_id} for {defrag.requested_by}")
    j0 = res_a.jobs["j0"].losses
    if res_a.jobs["j2"].losses != j0[:2]:
        raise AssertionError(f"cluster a: j2's losses "
                             f"{res_a.jobs['j2'].losses} are not j0's "
                             f"first two {j0[:2]}")
    if not res_a.measurements:
        raise AssertionError("cluster a: no boundary was measured")
    # the crash case
    if (res_c.jobs["j_a"].restarts, res_c.jobs["j_b"].restarts) != (1, 0) \
            or res_c.jobs["j_a"].losses != res_c.jobs["j_b"].losses:
        raise AssertionError(
            f"cluster crash: restarts {res_c.jobs['j_a'].restarts}/"
            f"{res_c.jobs['j_b'].restarts}, losses "
            f"{res_c.jobs['j_a'].losses} vs {res_c.jobs['j_b'].losses}")
    # run B: a scheduler repack, and the repacked job continues bitwise
    # against the same job run alone (b2)
    b0 = res_b.jobs["b0"]
    if not any(r.job_id == "b0" and r.reason == "defrag"
               and r.requested_by == "b2" for r in res_b.repacks):
        raise AssertionError(f"cluster b: repacks {res_b.repacks}")
    if res_b.jobs["b2"].losses != b0.losses[:3] or len(set(b0.shapes)) < 2:
        raise AssertionError(f"cluster b: b0 {b0.losses} on {b0.shapes}, "
                             f"b2 alone {res_b.jobs['b2'].losses}")
    total = {k: sum(c[k] for c in counts) for k in reduced}
    launches.phases["cluster"] = total
    for tag, res, segs in (("a", res_a, segs_a), ("crash", res_c, segs_c),
                           ("b", res_b, segs_b)):
        _print_cluster(tag, res, segs)
    seconds = time.perf_counter() - t_phase
    print(f"  cluster: run A {wall['a']:.1f} s and beside it the crash case "
          f"{wall['crash']:.1f} s, run B {wall['b']:.1f} s; phase "
          f"{seconds:.1f} s", flush=True)

    def summary(res, segs):
        return dict(
            repacks=[r.to_dict() for r in res.repacks],
            measurements=res.measurements,
            jobs={jid: dict(losses=o.losses,
                            shapes=[list(x) for x in o.shapes],
                            restarts=o.restarts)
                  for jid, o in res.jobs.items()},
            segments={jid: [{k: d[k] for k in (
                "start_step", "end_step", "shape", "first_step_s",
                "steady_step_s", "peak_memory_gib", "kernel_launches")}
                for d in ds] for jid, ds in segs.items()},
            wall_s=res.wall_s)

    emit("cluster", run_a=dict(CLUSTER_A, **summary(res_a, segs_a)),
         crash=dict(CLUSTER_CRASH, **summary(res_c, segs_c)),
         run_b=dict(CLUSTER_B, **summary(res_b, segs_b)),
         expected_launches_per_step_per_rank={"reduced": reduced,
                                              "run_b": full1},
         launches_rank0=total, wall_s=wall, seconds=seconds)
    return total, res_b.measurements


# the replay phase: the simulator replays the paper's trace categories
# (benchmarks/elastic_bench.py's two: fig7, train jobs under FIFO; fig8,
# train and serve jobs under backfill) under Dynamic-MIG with drains, with
# handoffs priced by the cost model calibrated from the elastic phase's
# full-width handoffs, and under Flex-MIG.  Host code only, as in the
# reference; the card's part is the measurements.
REPLAY_TRACES = (("fig7", "philly", "balanced", "train", "fifo"),
                 ("fig8", "helios_earth", "balanced", "mixed", "backfill"))
REPLAY_SEEDS = (0, 1, 2)
REPLAY_TRACE_KW = dict(double=True, max_size=4)
# the reference bench's full-run gate on the mean makespan delta of
# handoff over drain, as it stands
REPLAY_MIN_DELTA = -0.01
# tests/test_sim_failures.py's failure model
REPLAY_FAILURES = dict(mtbf_s=3 * 3600.0, ckpt_interval_s=600.0)


def _cost_model_row(cm) -> dict:
    return dict(save_bps=cm.save_bps, restore_bps=cm.restore_bps,
                recompile_s=cm.recompile_s, coord_s=cm.coord_s)


def _replay_row(r) -> dict:
    return dict(makespan=r.makespan, avg_jct=r.avg_jct,
                avg_wait=r.avg_wait, n_reconfigs=r.n_reconfigs,
                n_drains=r.n_drains, n_handoffs=r.n_handoffs,
                drain_cost_s=r.drain_cost_s,
                handoff_cost_s=r.handoff_cost_s, n_events=r.n_events)


def phase_replay(elastic: dict, cluster_measurements) -> None:
    """The simulator priced by the card: ``ReconfigCostModel`` calibrated
    from the elastic phase's full-width handoffs (``elastic``: its
    measurements by run), the handoff against the drain the simulator
    charges, the replays of ``REPLAY_TRACES``, a failure replay, and the
    executor's launch through the MIG-aware registry.  Gates: the median
    Table-1 workload's handoff at or below the 1-job drain; every job of
    every replay finished; Flex-MIG reconfigures nothing; the summed
    handoff charge below the summed drain charge; the mean makespan delta
    at least ``REPLAY_MIN_DELTA``; a replay run twice equal; the failure
    replay's failures the same under both cost models, the handoff's
    restart charge at most the drain's; the launch forms with SHM
    transports MIG-aware and fails without."""
    import dataclasses
    from repro_torch.core import metrics
    from repro_torch.core.executor import JobExecutor
    from repro_torch.core.jct_model import (WORKLOADS, ReconfigCostModel,
                                            ckpt_state_bytes)
    from repro_torch.core.job import Job
    from repro_torch.core.leaves import Cluster
    from repro_torch.core.modes import (CKPT_LOAD_S, CKPT_SAVE_S,
                                        POD_CHURN_S, RECONFIGURE_S, FlexMIG)
    from repro_torch.core.registry import (DuplicateGpuError,
                                           TopologyMismatchError)
    from repro_torch.core.simulator import FailureModel, simulate
    from repro_torch.core.traces import TraceCategory, generate_trace
    from repro_torch.elastic_driver import schedule_from_sim
    t_phase = time.perf_counter()

    # 1. calibrate from the card's handoffs
    handoffs = elastic["handoff"]
    cm = ReconfigCostModel.from_measurements(handoffs)
    cm_b = ReconfigCostModel.from_measurements(cluster_measurements)
    print(f"  replay: cost model from the elastic phase's "
          f"{len(handoffs)} handoffs (llama3.2-1b's widths, "
          f"{ELASTIC['layers']} layer, {handoffs[0]['state_bytes']} B of "
          f"state): save_bps {cm.save_bps:.6g}, restore_bps "
          f"{cm.restore_bps:.6g}, recompile_s {cm.recompile_s:.6g}",
          flush=True)
    print(f"  replay: from cluster run B's {len(cluster_measurements)} "
          f"boundaries (information only): save_bps {cm_b.save_bps:.6g}, "
          f"restore_bps {cm_b.restore_bps:.6g}, recompile_s "
          f"{cm_b.recompile_s:.6g}", flush=True)

    # 2. the handoff against the 1-job drain the simulator charges
    drain_ref = RECONFIGURE_S + CKPT_SAVE_S + CKPT_LOAD_S + POD_CHURN_S
    uncapped = {w: cm.handoff_s(ckpt_state_bytes(w)) for w in WORKLOADS}
    median = float(np.median(list(uncapped.values())))
    below = float(np.mean([u <= drain_ref + 1e-9
                           for u in uncapped.values()]))
    if not median <= drain_ref + 1e-9:
        raise AssertionError(f"replay: the median Table-1 handoff "
                             f"{median} s exceeds the 1-job drain "
                             f"{drain_ref} s")
    drain_cycles = [m["save_s"] + m["restore_s"] for m in elastic["drain"]]
    print(f"  replay: uncapped handoff of the {len(uncapped)} Table-1 "
          f"workloads: median {median:.4f} s, {min(uncapped.values()):.4f}"
          f"-{max(uncapped.values()):.4f} s, {below:.2%} at or below the "
          f"1-job drain {drain_ref} s; the elastic phase's drain cycle "
          f"(save + restore) {[round(c, 3) for c in drain_cycles]} s "
          f"against the simulator's {CKPT_SAVE_S + CKPT_LOAD_S} s",
          flush=True)

    # 3. the replays
    def trace(src, size_dist, mix, seed):
        return generate_trace(TraceCategory(src, size_dist, mix),
                              seed=seed, **REPLAY_TRACE_KW)

    rows, comparisons, by_label = [], [], {}
    for label, src, size_dist, mix, policy in REPLAY_TRACES:
        for seed in REPLAY_SEEDS:
            jobs = trace(src, size_dist, mix, seed)
            ids = {j.job_id for j in jobs}
            t0 = time.perf_counter()
            runs = {"dm_drain": simulate(jobs, "DM", policy=policy),
                    "dm_handoff": simulate(jobs, "DM", policy=policy,
                                           reconfig_mode="handoff",
                                           reconfig_cost=cm),
                    "fm": simulate(jobs, "FM", policy=policy)}
            sim_s = time.perf_counter() - t0
            for name, r in runs.items():
                if r.n_jobs != len(jobs) or set(r.jct_by_job) != ids:
                    raise AssertionError(
                        f"replay {label} seed {seed} {name}: "
                        f"{r.n_jobs} of {len(jobs)} jobs finished")
            if runs["fm"].n_reconfigs:
                raise AssertionError(f"replay {label} seed {seed}: FM "
                                     f"reconfigured")
            drain, hand = runs["dm_drain"], runs["dm_handoff"]
            delta = ((drain.makespan - hand.makespan)
                     / max(drain.makespan, 1e-9))
            cmp = metrics.ModeComparison.of(runs["fm"], drain)
            comparisons.append(cmp)
            by_label.setdefault(label, []).append(cmp)
            row = dict(label=label, source=src, size_dist=size_dist,
                       mix=mix, policy=policy, seed=seed, n_jobs=len(jobs),
                       makespan_delta_frac=delta,
                       fm_over_dm_drain=dataclasses.asdict(cmp),
                       sim_s=sim_s,
                       **{k: _replay_row(r) for k, r in runs.items()})
            rows.append(row)
            print(f"  replay {label} seed {seed} ({len(jobs)} jobs, "
                  f"{policy}): "
                  + "; ".join(
                      f"{k} makespan {r.makespan:.1f} s, avg_jct "
                      f"{r.avg_jct:.1f}, avg_wait {r.avg_wait:.1f}"
                      for k, r in runs.items())
                  + f"; drains {drain.n_drains} charged "
                  f"{drain.drain_cost_s:.1f} s, handoffs "
                  f"{hand.n_handoffs} charged {hand.handoff_cost_s:.3f} s;"
                  f" makespan delta {delta:+.4%}; FM/DM-drain makespan "
                  f"{cmp.makespan_ratio:.4f} ({sim_s * 1e3:.0f} ms)",
                  flush=True)
    drain_total = sum(r["dm_drain"]["drain_cost_s"] for r in rows)
    handoff_total = sum(r["dm_handoff"]["handoff_cost_s"] for r in rows)
    delta_mean = float(np.mean([r["makespan_delta_frac"] for r in rows]))
    if not handoff_total < drain_total:
        raise AssertionError(f"replay: handoffs charged {handoff_total} "
                             f"s, drains {drain_total} s")
    if not delta_mean >= REPLAY_MIN_DELTA:
        raise AssertionError(f"replay: mean makespan delta {delta_mean} "
                             f"below {REPLAY_MIN_DELTA}")
    summary = metrics.summarize(comparisons)
    print(f"  replay: charged {drain_total:.1f} s drained against "
          f"{handoff_total:.3f} s handed off; mean makespan delta "
          f"{delta_mean:+.4%}; FM over DM-drain {summary}", flush=True)
    for label, cmps in by_label.items():
        print(f"  replay {label}: FM over DM-drain "
              f"{metrics.summarize(cmps)}", flush=True)
    # one replay, run twice
    label, src, size_dist, mix, policy = REPLAY_TRACES[0]
    jobs = trace(src, size_dist, mix, REPLAY_SEEDS[0])
    again = [simulate(jobs, "DM", policy=policy, reconfig_mode="handoff",
                      reconfig_cost=cm) for _ in range(2)]
    if len({repr((r.jct_by_job, r.makespan, r.n_events))
            for r in again}) != 1:
        raise AssertionError("replay: one replay run twice differs")

    # 4. failures: the simulator's repack path, under both cost models
    fmodel = FailureModel(**REPLAY_FAILURES)
    fail = {name: simulate(jobs, "DM", policy=policy, failure_model=fmodel,
                           reconfig_cost=model)
            for name, model in (("drain", ReconfigCostModel(mode="drain")),
                                ("handoff", cm))}
    fd, fh = fail["drain"], fail["handoff"]
    if fd.n_failures != fh.n_failures or not (
            fh.failure_restart_cost_s <= fd.failure_restart_cost_s + 1e-9):
        raise AssertionError(
            f"replay: failures {fd.n_failures} / {fh.n_failures}, restart "
            f"charge {fd.failure_restart_cost_s} / "
            f"{fh.failure_restart_cost_s} s (drain / handoff)")
    for name, r in fail.items():
        print(f"  replay {label} seed {REPLAY_SEEDS[0]} with failures "
              f"(mtbf {fmodel.mtbf_s:.0f} s, {name}): {r.n_failures} "
              f"failures, {r.n_recoveries} recoveries, restart charge "
              f"{r.failure_restart_cost_s:.3f} s, lost work "
              f"{r.failure_lost_work_s:.1f} s, goodput {r.goodput:.4f}, "
              f"makespan {r.makespan:.1f} s", flush=True)

    # 5. a size-4 job placed by FM, launched through the registry
    cluster = Cluster(n_hosts=1, gpus_per_host=2)
    fm = FlexMIG()
    fm.setup(cluster)
    job = Job("job-1", "bert-base", "train", 4, 32, 1200.0)
    placement = fm.try_place(job, cluster)
    ex = JobExecutor()
    launched = ex.launch(job, placement, mig_aware=True)
    gpus = sorted({i.gpu_id for i in placement.instances})
    if gpus != [0, 1] or set(launched.transports.values()) != {"SHM"}:
        raise AssertionError(f"replay: the launch spans GPUs {gpus} with "
                             f"transports {launched.transports}")
    try:
        ex.launch(job, placement, mig_aware=False)
    except (DuplicateGpuError, TopologyMismatchError) as e:
        stock = f"{type(e).__name__}: {e}"
    else:
        raise AssertionError("replay: the stock launch formed")
    print(f"  replay: {job.job_id} placed on GPUs {gpus} "
          f"({[i.profile for i in placement.instances]}), "
          f"{launched.pod.n_workers} workers, transports "
          f"{sorted(set(launched.transports.values()))}, entry point "
          f"{launched.pod.entrypoint!r}; stock: {stock}", flush=True)

    # 6. the schedule that trace would ask the elastic driver for
    sched = schedule_from_sim(again[0], n_devices=ELASTIC_RANKS,
                              n_steps=ELASTIC["steps"])
    sched_rows = [(e.step, e.mesh_shape, e.sim_time, e.kind) for e in sched]
    seconds = time.perf_counter() - t_phase
    print(f"  replay: {label} seed {REPLAY_SEEDS[0]}'s handoffs as an "
          f"elastic schedule for {ELASTIC_RANKS} ranks over "
          f"{ELASTIC['steps']} steps (information only): {sched_rows}; "
          f"phase {seconds:.2f} s", flush=True)
    emit("replay", cost_model=_cost_model_row(cm),
         cost_model_cluster_b=_cost_model_row(cm_b),
         handoff_s_uncapped=uncapped, handoff_s_median=median,
         handoff_frac_below_drain=below, drain_ref_s=drain_ref,
         drain_cycle_s=drain_cycles,
         assumed_ckpt_s=CKPT_SAVE_S + CKPT_LOAD_S, rows=rows,
         drain_cost_s=drain_total, handoff_cost_s=handoff_total,
         makespan_delta_mean=delta_mean, fm_over_dm_drain=summary,
         failures={k: dict(n_failures=r.n_failures,
                           n_recoveries=r.n_recoveries,
                           restart_cost_s=r.failure_restart_cost_s,
                           lost_work_s=r.failure_lost_work_s,
                           goodput=r.goodput, makespan=r.makespan)
                   for k, r in fail.items()},
         launch=dict(gpus=gpus, transports=sorted(
             set(launched.transports.values())), stock=stock),
         schedule=sched_rows, seconds=seconds)


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


class Tee:
    """Writes to each of its streams: the console and the log."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)
        return len(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()

    def __getattr__(self, name):
        return getattr(self.streams[0], name)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(LOG), exist_ok=True)
    out, err = sys.stdout, sys.stderr
    with open(LOG, "w") as log:
        sys.stdout, sys.stderr = Tee(out, log), Tee(err, log)
        try:
            return run(torch)
        except Exception:     # reported, and the run exits non-zero
            traceback.print_exc()
            return 1
        finally:
            sys.stdout, sys.stderr = out, err


def run(torch) -> int:
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

    launches = Launches(kernels)
    for arch in ARCHS:
        cfg = get_config(arch)
        t0 = time.perf_counter()
        model = build_model(cfg, device=dev, seed=SEED)
        torch.cuda.synchronize()
        emit(f"{arch} init", arch=arch, seconds=time.perf_counter() - t0,
             params=sum(p.numel() for p in model.parameters()))
        phase_prefill(torch, dev, model, cfg, launches)
        phase_serve(torch, dev, model, cfg, launches)
        phase_profile(torch, dev, model, cfg)
        # every kernel of this path went through its launches
        path = {k: sum(p[k] for ph, p in launches.phases.items()
                       if ph.startswith(arch + " "))
                for k, n in expected_launches(cfg).items() if n}
        if not all(path.values()):
            raise AssertionError(f"{arch}: a kernel of its path was never "
                                 f"launched: {path}")
        del model
        torch.cuda.empty_cache()
    phase_train(torch, dev, launches)
    phase_sync(torch, dev, launches)
    ckpt_per_step = phase_ckpt(torch, dev, launches)
    elastic_per_step, elastic_measured = phase_elastic(torch, dev, launches)
    cluster_launches, cluster_measured = phase_cluster(torch, dev,
                                                       launches)
    phase_replay(elastic_measured, cluster_measured)

    sources = {"rmsnorm": ("src/repro_torch/kernels/rmsnorm/kernel.cu",
                           "src/repro/kernels/rmsnorm/kernel.py:19"),
               "flash_attention": (
                   "src/repro_torch/kernels/flash_attention/kernel.cu",
                   "src/repro/kernels/flash_attention/kernel.py:78"),
               "ssd": ("src/repro_torch/kernels/mamba_scan/kernel.cu",
                       "src/repro/kernels/mamba_scan/kernel.py:72"),
               "mlstm": ("src/repro_torch/kernels/mlstm/kernel.cu",
                         "src/repro/kernels/mlstm/kernel.py:86")}
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
        row = {"name": k.name, "route": "cuda",
               "source": sources[k.name][0],
               "replaces": sources[k.name][1], "launches": total,
               "max_abs_err": t["max_abs_err"], "ms": t["ms"],
               "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
               "bound_by": t["bound_by"], "library_ms": t["library_ms"],
               "launches_per_train_step":
                   launches.phases["train"][k.name]
                   // TRAIN["steps"],
               "launches_per_sync_step_per_rank":
                   launches.phases["sync"][k.name]
                   // (SYNC_RANKS * len(SYNC_RUNS) * SYNC["steps"]),
               "launches_per_ckpt_step": ckpt_per_step[k.name],
               "launches_per_elastic_step_per_rank":
                   elastic_per_step[k.name],
               "launches_cluster_rank0": cluster_launches[k.name]}
        if k.name in ("flash_attention", "ssd", "mlstm"):   # tensor cores
            row.update({f: t[f] for f in ("tflops", "share_of_bound",
                                          "vs_library")})
        if k.name == "rmsnorm":
            # share_of_bound is the cold-L2 device time's
            row.update({f: t[f] for f in (
                "device_ms_cold_l2", "device_ms_warm_l2", "share_of_bound",
                "host_us_per_rmsnorm_op_call")})
            # every serving shape in f32 and bf16, prefill and decode
            row["times"] = [
                {f: r[f] for f in ("shape", "dtype", "device_ms_cold_l2",
                                   "device_ms_warm_l2", "ms", "bound_ms",
                                   "share_of_bound", "k1_route")}
                for r in t["times"]]
        rows.append(row)
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
