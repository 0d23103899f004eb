"""musicgen-large [audio]: decoder-only over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]

The EnCodec frontend is a STUB: the backbone consumes codec token ids
directly (vocab 2048); conditioning frame embeddings come precomputed via
``input_specs`` (frontend_tokens slots).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    activation="gelu",
    mlp_type="mlp",
    norm="layer",
    frontend="audio",
    frontend_tokens=64,               # conditioning frames (stubbed)
)
