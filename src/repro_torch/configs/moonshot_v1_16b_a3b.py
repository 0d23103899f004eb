"""moonshot-v1-16b-a3b [moe]: kimi/moonlight fine-grained MoE, 64e top-6.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 vocab=163840, MoE 64e top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    moe_experts=64,
    moe_top_k=6,
    moe_d_ff=1408,
    moe_shared_experts=2,
)
