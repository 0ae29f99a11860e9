"""Production rules over a rank grid (counterpart of
``repro/launch/mesh.py``).

``make_leaf_mesh``, the reference's grid over a permuted leaf order, has
no caller in the reference and is not ported (ROADMAP.md queue 1
item 17).
"""
from __future__ import annotations

from repro_torch.parallel.mesh import RankGrid
from repro_torch.sharding import MeshRules, make_rules


def production_rules(grid: RankGrid, *, long_ctx: bool = False,
                     seq_shard: bool = False) -> MeshRules:
    return make_rules(grid, long_ctx=long_ctx, seq_shard=seq_shard)
