"""Run a function in R processes that form one gloo job (the port's
counterpart of ``tests/conftest.py::run_multidevice``).

``run_ranks(fn, R, args=...)`` starts R processes with the ``spawn`` start
method; each joins a ``torch.distributed`` gloo job as rank r of R and
calls ``fn(rank, world_size, *args)``; ``fn`` must be a module-level
function (spawn pickles it by name) and its return value picklable.  The
parent returns the R results in rank order.  It fails with the failing
rank's traceback when any rank raises or exits non-zero, and kills the
whole job when ``deadline_s`` passes, so one hung rank cannot hang the
caller.

The job meets at a ``file://`` store in a fresh temporary directory, so
concurrent jobs (a test suite under pytest-xdist) cannot collide the way
fixed ``MASTER_PORT``s do.  gloo is given an explicit ``timeout``, far
below its default of 30 minutes.  When a rank dies, by a SIGKILL or
otherwise, the parent stops every other rank at once, so the job goes
down with it.  Every rank runs on the one host, so gloo's sockets bind
the loopback interface unless ``GLOO_SOCKET_IFNAME`` says otherwise.
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence


def _rank_main(fn, rank: int, world: int, init_method: str,
               timeout_s: float, threads: Optional[int], args, results):
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist
    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(
            "gloo", init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs):
    for p in procs:
        if p.is_alive():
            p.terminate()
    t_end = time.monotonic() + 5
    for p in procs:
        p.join(max(0.0, t_end - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()


def _killed(procs, wait_s: float = 2.0):
    """(rank, exit code) of a rank a signal ended, waiting up to
    ``wait_s`` for one; None when none was."""
    t_end = time.monotonic() + wait_s
    while True:
        for r, p in enumerate(procs):
            if p.exitcode is not None and p.exitcode < 0:
                return r, p.exitcode
        if time.monotonic() > t_end:
            return None
        time.sleep(0.05)


def run_ranks(fn: Callable[..., Any], world_size: int, *,
              args: Sequence[Any] = (), deadline_s: float = 600.0,
              timeout_s: float = 90.0, threads: Optional[int] = None
              ) -> List[Any]:
    """``fn(rank, world_size, *args)`` in ``world_size`` spawned gloo
    ranks; returns their results by rank.  ``timeout_s`` is gloo's own
    timeout for one collective; ``threads`` sets each rank's
    ``torch.set_num_threads``."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    store_dir = tempfile.mkdtemp(prefix="repro_torch_job_")
    init_method = "file://" + os.path.join(store_dir, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, world_size, init_method, timeout_s,
                               threads, tuple(args), results))
             for r in range(world_size)]
    out: dict = {}
    deadline = time.monotonic() + deadline_s
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0][0]} of {world_size} exited with "
                        f"code {dead[0][1]} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {fn.__name__} did not "
                        f"finish within {deadline_s:.0f} s; ranks done: "
                        f"{sorted(out)}")
                continue
            if not ok:
                # a rank killed by a signal makes its peers fail on a
                # broken connection: name the killed rank, the cause
                killed = _killed(procs)
                cause = (f"rank {killed[0]} of {world_size} exited with "
                         f"code {killed[1]}; " if killed else "")
                raise RuntimeError(f"{cause}rank {rank} of {world_size} "
                                   f"failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with codes {bad}")
    finally:
        _stop(procs)
        results.close()
        shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(world_size)]
