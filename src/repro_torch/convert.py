"""Weight bridge: the JAX package's parameter tree -> the port's state dict.

``params_from_jax`` takes the tree as numpy arrays
(``jax.tree.map(np.asarray, model.init(key))``) and returns a state dict for
``TransformerLM.load_state_dict``.  The leading layer axis of ``blocks`` is
un-stacked into ``blocks.<i>.<path>``.  Weights keep their (d_in, d_out)
layout: the port computes ``x @ w`` as the JAX package does, so nothing is
transposed.  Values are carried bit for bit.
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


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(tree):
        t = to_tensor(leaf)
        if path.startswith("blocks."):
            rest = path[len("blocks."):]
            for i in range(t.shape[0]):
                state[f"blocks.{i}.{rest}"] = t[i]
        else:
            state[path] = t
    return state
