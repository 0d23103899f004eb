"""dbrx-132b [moe]: 16 experts top-4, fine-grained.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4
[hf:databricks/dbrx-base; unverified]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    moe_experts=16,
    moe_top_k=4,
    moe_d_ff=10752,
    norm="layer",
)
