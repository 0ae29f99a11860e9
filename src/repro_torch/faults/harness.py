"""Subprocess kill harness: run real checkpoint/driver code, murder it
(the port's counterpart of ``repro/faults/harness.py``).

In-process fault injection (:mod:`repro_torch.faults.plan`) can raise and
corrupt, but a ``crash`` spec is the only honest way to test the commit
protocol — SIGKILL skips ``finally`` blocks, atexit handlers, and
buffered flushes, exactly like a preempted MIG slice.  Since SIGKILL
takes the test process with it, crash specs must run in a *child*: the
harness serializes a :class:`~repro_torch.faults.plan.FaultPlan` into the
child's environment (the child arms it via
:func:`repro_torch.faults.plan.install_from_env`; a rank function that
the child runs through ``parallel.launch.run_ranks`` arms it with the
same call), runs the child, and asserts how it died.  A child that runs a gloo job dies with
its job: ``run_ranks`` takes every rank down when one is killed, and the
child exits non-zero naming the killed rank (:func:`expect_rank_sigkill`).

The crash-matrix tests then relaunch the same scenario *without* a plan
and assert the recovery invariants: ``latest_step`` never names a torn
dir, and a resumed run continues bitwise-equal to an uninterrupted
reference.
"""
from __future__ import annotations

import dataclasses
import os
import re
import signal
import subprocess
import sys
import textwrap
from typing import Dict, Optional

from repro_torch.faults.plan import ENV_VAR, FaultPlan

# child preamble: arm the env-serialized plan before anything else runs
CHILD_PROLOGUE = textwrap.dedent("""\
    from repro_torch.faults.plan import install_from_env
    install_from_env()
""")


@dataclasses.dataclass
class ChildResult:
    returncode: int
    stdout: str
    stderr: str

    @property
    def sigkilled(self) -> bool:
        return self.returncode == -signal.SIGKILL

    @property
    def rank_sigkilled(self) -> bool:
        """A rank of the child's gloo job was SIGKILLed (``run_ranks``
        reports its exit code, -9)."""
        return bool(re.search(rf"exited with code -{int(signal.SIGKILL)}\b",
                              self.stderr))


def run_child(code: str, *, plan: Optional[FaultPlan] = None,
              env: Optional[Dict[str, str]] = None, timeout: int = 560,
              src_dir: Optional[str] = None) -> ChildResult:
    """Run ``code`` (dedented, prefixed with the plan-arming prologue) in
    a child interpreter.

    ``plan`` is serialized into ``$REPRO_FAULT_PLAN``.  ``src_dir``
    overrides the ``PYTHONPATH`` entry (defaults to the ``src`` directory
    this package was imported from).
    """
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    if src_dir is None:
        # repro_torch/faults/harness.py -> repro_torch/faults ->
        # repro_torch -> src
        src_dir = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = (src_dir + os.pathsep
                               + child_env.get("PYTHONPATH", ""))
    if plan is not None:
        child_env[ENV_VAR] = plan.to_env()
    else:
        child_env.pop(ENV_VAR, None)
    res = subprocess.run(
        [sys.executable, "-c", CHILD_PROLOGUE + textwrap.dedent(code)],
        capture_output=True, text=True, timeout=timeout, env=child_env)
    return ChildResult(res.returncode, res.stdout, res.stderr)


def expect_sigkill(result: ChildResult) -> None:
    """Assert the child died by the plan's crash spec, not by accident."""
    if not result.sigkilled:
        raise AssertionError(
            f"expected the child to be SIGKILLed by its fault plan, got "
            f"returncode {result.returncode}\n--- stdout ---\n"
            f"{result.stdout}\n--- stderr ---\n{result.stderr[-4000:]}")


def expect_rank_sigkill(result: ChildResult) -> None:
    """Assert a rank of the child's job died by the plan's crash spec and
    took the job down."""
    if result.returncode == 0 or not result.rank_sigkilled:
        raise AssertionError(
            f"expected a rank of the child's job to be SIGKILLed by its "
            f"fault plan, got returncode {result.returncode}\n"
            f"--- stdout ---\n{result.stdout}\n--- stderr ---\n"
            f"{result.stderr[-4000:]}")


def expect_clean(result: ChildResult) -> str:
    """Assert the child exited 0; return its stdout."""
    if result.returncode != 0:
        raise AssertionError(
            f"child failed with returncode {result.returncode}\n"
            f"--- stdout ---\n{result.stdout}\n--- stderr ---\n"
            f"{result.stderr[-4000:]}")
    return result.stdout
