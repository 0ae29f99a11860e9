"""Stable string paths for pytree leaves.

The checkpoint formats key every leaf by a deterministic path string
(``"[0].layers.attn.wq"``) derived from the container structure: dicts
walk sorted keys, lists/tuples/NamedTuples walk indices.  The same walk
produces the same keys for a template at restore time, so save/restore
never depends on pytree registration order.

The port's copy of ``repro/ckpt/treepaths.py``: the same walk gives the
same keys for the port's trees, so both packages name a leaf alike.
"""
from __future__ import annotations

import re
from typing import Any, Dict


def leaf_paths(tree) -> Dict[str, Any]:
    """Flatten ``tree`` into {path: leaf} with deterministic paths."""
    flat: Dict[str, Any] = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}.{k}" if prefix else str(k), node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}[{i}]", v)
        else:
            flat[prefix] = node
    walk("", tree)
    return flat


def rebuild(template, values: Dict[str, Any]):
    """Rebuild ``template``'s structure with leaves from ``values``.

    NamedTuples are reconstructed via their field constructor; plain
    tuples/lists keep their type.
    """
    def go(prefix, node):
        if isinstance(node, dict):
            return {k: go(f"{prefix}.{k}" if prefix else str(k), v)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            vals = [go(f"{prefix}[{i}]", v) for i, v in enumerate(node)]
            return type(node)(vals) if not hasattr(node, "_fields") \
                else type(node)(*vals)
        return values[prefix]

    return go("", template)


def sanitize(path: str) -> str:
    """Filesystem-safe filename stem for a leaf path."""
    return re.sub(r"[^A-Za-z0-9_.\[\]-]", "_", path)
