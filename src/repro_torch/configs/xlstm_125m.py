"""xlstm-125m: sLSTM + mLSTM blocks.

[arXiv:2405.04517; unverified]  12 blocks, d_model=768, 4H, vocab=50304,
d_ff=0 (blocks carry their own 2x up-projection).  Every 4th block is an
sLSTM (3 sLSTM + 9 mLSTM), matching the paper's mixed [7:1]-ish ratio at this
scale.  Sub-quadratic (recurrent state).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    arch_id="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    use_rope=False,
    norm="layernorm",
    slstm_every=4,
    tie_embeddings=True,
    sub_quadratic=True,
    source="arXiv:2405.04517; unverified",
)
