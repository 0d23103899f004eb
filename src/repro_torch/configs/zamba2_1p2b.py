"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,                     # shared attn block every 6 Mamba2 layers
    block_pattern="mamba_shared_attn",
    supports_long_context=True,       # Mamba2 backbone is sub-quadratic
    tie_embeddings=True,
)
