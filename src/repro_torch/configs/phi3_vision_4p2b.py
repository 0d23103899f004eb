"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP frontend (stub).

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The CLIP vision tower is a STUB: ``input_specs`` provides precomputed patch
embeddings (B, frontend_tokens, d_model) prepended to the text sequence.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision",
    frontend_tokens=144,              # one 336px tile of CLIP patches
)
