"""nemotron-4-340b [dense]: GQA, squared-ReLU MLP.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000
[arXiv:2402.16819; unverified]

Its bf16 weights alone (682 GB) fit no single card: on one card it is
served cut in depth, and its fp32 optimizer state (4 TB) is not trained.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab_size=256000,
    activation="squared_relu",
    mlp_type="mlp",
    attn_bias=False,
)
