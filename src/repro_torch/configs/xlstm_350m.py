"""xlstm-350m [ssm]: sLSTM + mLSTM blocks (attention-free).

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304
[arXiv:2405.04517; unverified]

d_ff=0: xLSTM blocks carry their own up/down projections (expand factor 2);
there is no separate FFN.  sLSTM every 8th layer, mLSTM otherwise (the
paper's sparse-sLSTM placement).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-350m",
    family="ssm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_pattern="xlstm",
    slstm_every=8,
    ssm_expand=2,
    supports_long_context=True,
    tie_embeddings=True,
)
