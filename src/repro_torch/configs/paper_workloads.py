"""The paper's own evaluation workloads (Table 1 + Table 2).

These drive the simulator (``repro_torch.core.simulator``); the JCT model
lives in ``repro_torch.core.jct_model.WORKLOADS``.  This module re-exports
the job-mix configuration so `--arch paper-workloads` style tooling and the
trace generator agree on one source of truth.

The port's copy of ``repro/configs/paper_workloads.py``.
"""
from repro_torch.core.jct_model import WORKLOADS
from repro_torch.core.traces import (DURATION_BUCKETS, DURATION_SOURCES,
                                     INFER_SIZES, SIZE_DISTS, TRAIN_SIZES)

TABLE1_MODELS = tuple(WORKLOADS)
TABLE2_SIZE_DISTS = SIZE_DISTS
TRACE_SOURCES = tuple(DURATION_SOURCES)

__all__ = ["TABLE1_MODELS", "TABLE2_SIZE_DISTS", "TRACE_SOURCES",
           "TRAIN_SIZES", "INFER_SIZES", "DURATION_BUCKETS"]
