"""Weight bridge: the JAX package's parameter tree -> the port's state dict.

``params_from_jax`` takes the tree as numpy arrays
(``jax.tree.map(np.asarray, model.init(key))``) and the config's family,
and returns a state dict for the port's model of that family.  Every
stacked subtree is un-stacked over as many leading axes as the family
stacks it: the dense ``blocks`` over one (``blocks.<i>.<path>``), the
hybrid ``blocks`` over two (``blocks.<i>.<j>.<path>``, super-block then
block) and its ``tail`` over one; the xLSTM's ``blocks.mlstm`` over two
(``blocks.mlstm.<i>.<j>.<path>``), its ``blocks.slstm`` and ``tail`` over
one; ``shared_attn``, ``embed`` and ``final_norm`` cross as they are.
Weights keep their (d_in, d_out) layout: the port computes ``x @ w`` as the
JAX package does, so nothing is transposed.  Values are carried bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def to_tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, exactly.  bf16 arrays (ml_dtypes) are recognised by
    dtype name and reinterpreted through uint16, which ``torch.from_numpy``
    accepts."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


# leading axes each family stacks its subtrees over, by subtree path
STACKED_AXES = {"dense": {"blocks": 1},
                "hybrid": {"blocks": 2, "tail": 1},
                "ssm": {"blocks.mlstm": 2, "blocks.slstm": 1, "tail": 1}}


def _unstack(t: torch.Tensor, n_axes: int):
    """(index path, slice) over the first ``n_axes`` axes of ``t``."""
    if n_axes == 0:
        yield "", t
        return
    for i in range(t.shape[0]):
        for rest, sub in _unstack(t[i], n_axes - 1):
            yield f"{i}.{rest}", sub


def _stacked_prefix(path: str, stacked: Mapping[str, int]) -> str:
    """The stacked subtree ``path`` lies in, or "" when it lies in none."""
    for prefix in stacked:
        if path.startswith(prefix + "."):
            return prefix
    return ""


def params_from_jax(tree: Mapping[str, Any],
                    family: str = "dense") -> Dict[str, torch.Tensor]:
    stacked = STACKED_AXES[family]
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        t = to_tensor(leaf)
        prefix = _stacked_prefix(path, stacked)
        if not prefix:
            state[path] = t
            continue
        rest = path[len(prefix) + 1:]
        for index, sub in _unstack(t, stacked[prefix]):
            state[f"{prefix}.{index}{rest}"] = sub
    return state
