"""Model + config registry of the port: ``--arch <id>`` resolution."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.xlstm import XLSTMLM
from repro_torch.models.zamba import ZambaLM
from repro_torch.launch.mesh import production_rules
from repro_torch.parallel.mesh import axes_size, axis_tuple
from repro_torch.sharding import MeshRules, batch_axes, tensor_axes

_CONFIG_MODULES = {
    "llama3.2-1b": "repro_torch.configs.llama32_1b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1_2b",
    "xlstm-125m": "repro_torch.configs.xlstm_125m",
}

_MODELS = {"dense": TransformerLM, "hybrid": ZambaLM, "ssm": XLSTMLM}

# the JAX package's other architectures, and the ROADMAP.md item that ports
# each one
_NOT_PORTED = {
    "whisper-tiny": "queue 1 item 10 (enc-dec)",
    "llama-3.2-vision-90b": "queue 1 item 10 (VLM cross-attn)",
    "command-r-plus-104b": "queue 1 item 10 (dense variants)",
    "glm4-9b": "queue 1 item 10 (dense variants)",
    "stablelm-1.6b": "queue 1 item 10 (dense variants)",
    "qwen2-moe-a2.7b": "queue 1 item 10 (MoE)",
    "deepseek-v2-lite-16b": "queue 1 item 10 (MLA, MoE)",
}

ARCH_IDS = tuple(_CONFIG_MODULES)

# the families whose layers compute their share under tensor-parallel rules
TENSOR_PARALLEL_FAMILIES = ("dense",)
# the ROADMAP.md item that ports the others' tensor parallelism
TENSOR_PARALLEL_ITEM = "queue 1 item 15"


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP.md "
            f"{_NOT_PORTED[arch_id]}")
    if arch_id not in _CONFIG_MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_CONFIG_MODULES[arch_id]).CONFIG


def reduced_config(cfg: ArchConfig) -> ArchConfig:
    """A tiny same-family config for CPU tests: the dense, hybrid and ssm
    arithmetic of the JAX package's ``reduced_config``."""
    recurrent = cfg.family in ("hybrid", "ssm")
    kw = dict(
        n_layers=min(cfg.n_layers, 8 if recurrent else 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=(min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads
                    else 4),
        d_ff=256 if cfg.d_ff else 0,
        vocab_size=512,
        head_dim=0,
    )
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=32,
                                        chunk=32)
    if cfg.hybrid_attn_every:
        kw["hybrid_attn_every"] = 3
    if cfg.slstm_every:
        kw["slstm_every"] = 4
        kw["n_layers"] = 8
    return dataclasses.replace(cfg, **kw)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Raises rather than carry on on the CPU when there is no
    card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch runs on the card by default; pass "
            "device='cpu' to run on the CPU")
    return dev


def check_on_device(model: torch.nn.Module, device: torch.device) -> None:
    found = next(model.parameters()).device
    if found.type != device.type:
        raise ValueError(f"model lies on {found}, entry point asked for "
                         f"{device}")


# the logical axes no model of the port splits yet, and the ROADMAP.md
# item that ports each
_UNSPLIT = {"seq": "queue 1 item 16 (Megatron-SP)"}

# the families whose decode cache has a sequence axis, ``kv_seq``: their
# decode steps split it where the rules say (flash-decode; only the decode
# step takes rules that split it)
KV_SEQ_FAMILIES = ("dense", "hybrid")


def check_rules(model: torch.nn.Module, rules) -> None:
    """Refuse rules that split a layer over a grid axis (``sharding.
    tensor_axes``) for a model whose tensor parallelism is not ported,
    rules that split an axis no model of the port splits, and rules that
    map nothing to a grid axis of more than one rank: each would run whole
    on every rank what the grid splits.  A split ``kv_seq`` uses its axes
    only for a model with a KV cache."""
    if rules is None or rules.mesh is None:
        return
    family = model.cfg.family
    tp = tensor_axes(rules)
    if family not in TENSOR_PARALLEL_FAMILIES and tp:
        raise NotImplementedError(
            f"tensor parallelism of the {family!r} family "
            f"({model.cfg.arch_id}) is not ported yet: ROADMAP.md "
            f"{TENSOR_PARALLEL_ITEM}")
    for name, item in _UNSPLIT.items():
        if axes_size(rules.mesh, rules.rules.get(name)) > 1:
            raise NotImplementedError(
                f"rules split {name!r} over {rules.rules[name]!r}; no "
                f"model of the port splits it yet: ROADMAP.md {item}")
    used = set(batch_axes(rules)) | {a.name for a in tp}
    if family in KV_SEQ_FAMILIES:
        used |= set(axis_tuple(rules.rules.get("kv_seq")))
    idle = [a for a in rules.mesh.axis_names
            if rules.mesh.shape[a] > 1 and a not in used]
    if idle:
        raise ValueError(
            f"no rule maps the batch, a layer or (decoding a model with a "
            f"KV cache) the cache's sequence to grid axes {idle} of "
            f"{dict(rules.mesh.shape)}: every rank along them would "
            f"compute the same")


def grid_rules(model: torch.nn.Module, grid, *, seq_shard: bool = False,
               long_ctx: bool = False) -> Optional[MeshRules]:
    """The rules an entry point runs ``model`` under on ``grid``, as the
    reference builds them (``launch/mesh.py::production_rules``, with its
    ``seq_shard`` and ``long_ctx``, which only the decode step passes), and
    checked (:func:`check_rules`); None without a grid."""
    rules = (production_rules(grid, seq_shard=seq_shard, long_ctx=long_ctx)
             if grid is not None else None)
    check_rules(model, rules)
    return rules


def build_model(cfg: ArchConfig, *, device=None,
                dtype: torch.dtype = L.DEFAULT_DTYPE,
                seed: Optional[int] = 0, remat: bool = True
                ) -> Union[TransformerLM, ZambaLM, XLSTMLM]:
    """The model of ``cfg``'s family on ``device`` (the card by default),
    with weights drawn from ``seed`` by a ``torch.Generator`` on that
    device; ``seed=None`` leaves them uninitialised for
    ``load_state_dict``.  ``remat``: per-layer recompute in the backward,
    the reference's default."""
    if cfg.family not in _MODELS:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: ROADMAP.md queue 1 "
            f"item 10")
    dev = resolve_device(device)
    model = _MODELS[cfg.family](cfg, device=dev, dtype=dtype, remat=remat)
    if seed is not None:
        model.init(torch.Generator(device=dev).manual_seed(seed))
    return model
