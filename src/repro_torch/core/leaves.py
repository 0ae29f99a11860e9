"""Leaves of the one-to-many model (the port's copy of what it needs of
``repro/core/leaves.py``: the ``TpuLeaf`` dataclass the elastic remesh
plans over; the rest of the control plane is ROADMAP.md queue 1 item 11).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TpuLeaf:
    """A TPU 'leaf' = one chip.  uuid plays the role of the MIG UUID."""
    pod: int
    host: int
    chip: int

    @property
    def uuid(self) -> str:
        return f"TPU-{self.pod}-{self.host}-{self.chip}"
