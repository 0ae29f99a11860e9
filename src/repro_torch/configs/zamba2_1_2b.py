"""zamba2-1.2b: hybrid, a Mamba2 backbone plus one shared attention block.

[arXiv:2411.15242; hf]  38 Mamba2 blocks, d_model=2048, ssm_state=64; a
single *shared* attention+MLP block (32H MHA, d_ff=8192, vocab=32000) is
applied every 6 mamba blocks (6 applications; weights shared across
applications, as in the Zamba2 paper), then 2 tail blocks.
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    n_layers=38,                 # mamba blocks
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
    hybrid_attn_every=6,
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2411.15242; hf",
)
