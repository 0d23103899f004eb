"""Architecture and shape configuration.

Every assigned architecture is an :class:`ArchConfig`; the four assigned
input shapes are :class:`ShapeConfig`.  ``reduced()`` yields the small
same-family variant used by CPU smoke tests (full configs are exercised only
through the dry-run with ShapeDtypeStructs).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense|moe|hybrid|vlm|audio|ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None          # default: d_model // n_heads
    activation: str = "silu"
    mlp_type: str = "swiglu"                # swiglu|geglu|mlp
    norm: str = "rms"                       # rms|layer
    attn_bias: bool = False
    rope_theta: float = 10000.0
    rotary_fraction: float = 1.0            # chatglm3: 0.5 (2d RoPE)
    tie_embeddings: bool = False
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    moe_shared_experts: int = 0
    moe_capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0                      # mamba2 d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0                     # hybrid: shared attn block period
    slstm_every: int = 0                    # xlstm: sLSTM block period
    block_pattern: str = "attn"             # attn|mamba_shared_attn|xlstm
    # modality frontend stub
    frontend: Optional[str] = None          # None|vision|audio
    frontend_tokens: int = 0
    # shape applicability
    supports_long_context: bool = False     # sub-quadratic -> run long_500k
    max_position: int = 544 * 1024

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe_experts > 0

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, hd = self.d_model, self.resolved_head_dim
        p = self.vocab_size * d            # embed
        if not self.tie_embeddings:
            p += d * self.vocab_size       # head
        per_layer = 0
        if self.block_pattern == "mamba_shared_attn":
            d_in = self.ssm_expand * d
            n_h = d_in // self.ssm_head_dim
            per_layer = (d * (2 * d_in + 2 * self.ssm_state) + 3 * n_h
                         + d_in * self.ssm_conv + d_in * d + 2 * d)
            p += per_layer * self.n_layers
            # one shared attention block (+ its mlp) reused across the stack
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            p += q + kv + o + 3 * d * self.d_ff + 2 * d
            return p
        if self.block_pattern == "xlstm":
            d_in = self.ssm_expand * d
            H = self.n_heads
            n_s = self.n_layers // self.slstm_every if self.slstm_every else 0
            n_m = self.n_layers - n_s
            mlstm = (d * (3 * d_in + 2 * H) + d * d_in   # in_proj + o_gate
                     + d_in + d_in * d + d)              # norm + out + ln1
            slstm = (d * 4 * d + 4 * d * d // H          # w_gates + r_gates
                     + d + d * d + d)                    # norm + out + ln1
            p += mlstm * n_m + slstm * n_s
            return p
        q = d * self.n_heads * hd
        kv = 2 * d * self.n_kv_heads * hd
        o = self.n_heads * hd * d
        attn = q + kv + o
        if self.is_moe:
            expert = 3 * d * self.moe_d_ff if self.mlp_type != "mlp" \
                else 2 * d * self.moe_d_ff
            mlp = (self.moe_experts + self.moe_shared_experts) * expert \
                + d * self.moe_experts    # router
        else:
            mlp = 3 * d * self.d_ff if self.mlp_type != "mlp" \
                else 2 * d * self.d_ff
        p += (attn + mlp + 2 * d) * self.n_layers
        return p

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        expert = 3 * d * self.moe_d_ff if self.mlp_type != "mlp" \
            else 2 * d * self.moe_d_ff
        inactive = (self.moe_experts - self.moe_top_k) * expert * self.n_layers
        return self.n_params() - inactive

    def shape_applicable(self, shape: ShapeConfig) -> Tuple[bool, str]:
        if shape.name == "long_500k" and not self.supports_long_context:
            return False, "pure full-attention arch: quadratic at 500k (skip)"
        return True, ""

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(2, min(4, (self.attn_every or 2) + 1)
                         if self.block_pattern == "mamba_shared_attn" else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=128,
            moe_experts=4 if self.is_moe else 0,
            moe_top_k=2 if self.is_moe else 0,
            moe_d_ff=32 if self.is_moe else 0,
            moe_shared_experts=min(1, self.moe_shared_experts),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            attn_every=2 if self.attn_every else 0,
            slstm_every=2 if self.slstm_every else 0,
            frontend_tokens=4 if self.frontend else 0,
            max_position=1024,
        )
