"""How far greedy tokens follow the decode-attention arithmetic, on one card.

  PYTHONPATH=src python examples/greedy_token_sensitivity_torch.py

Serves full-width gemma-2b and zamba2-1.2b with seeded random bf16 weights
(one request of 4 x 128 prompt tokens, 32 new tokens, as ``chip_smoke.py``'s
serve phases do) three times each, with three implementations of decode
attention: the CUDA kernel, its plain fp32 PyTorch version, and the same
attention in float64.  Each result is rounded to bf16, the model's dtype.
Prints the first 16 tokens of batch row 0 for each, and for each pair the
first position where each batch row's tokens part (None: all 32 agree).
Random weights leave near-ties among the logits, so tokens can part
between implementations that all agree to rounding.  Needs a CUDA card.
"""

import sys

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.ref import decode_attention_f64
from repro_torch.models import lm
from repro_torch.serve import ServeEngine


def decode_f64(q, k, v, length):
    return decode_attention_f64(q, k, v, length).to(q.dtype)


IMPLEMENTATIONS = {"kernel": ops.decode_attention,
                   "plain": decode_attention_plain, "float64": decode_f64}


def generate(arch: str, impl) -> torch.Tensor:
    cfg = get_config(arch)
    params = lm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda", dtype=torch.bfloat16)
    prompts = torch.randint(0, cfg.vocab_size, (4, 128),
                            generator=torch.Generator().manual_seed(1))
    kernel = ops.decode_attention
    ops.decode_attention = impl          # what models/attention.py calls
    try:
        eng = ServeEngine(cfg, params, max_seq=1024, batch=4)
        return eng.generate(prompts, 32)[:, 128:].cpu()
    finally:
        ops.decode_attention = kernel


def first_parting(a: torch.Tensor, b: torch.Tensor) -> list:
    return [int((a[i] != b[i]).nonzero()[0]) if (a[i] != b[i]).any()
            else None for i in range(a.shape[0])]


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for arch in ("gemma-2b", "zamba2-1.2b"):
        toks = {name: generate(arch, impl)
                for name, impl in IMPLEMENTATIONS.items()}
        for name, t in toks.items():
            print(arch, name, t[0, :16].tolist())
        names = list(toks)
        for i, a in enumerate(names):
            for b in names[i + 1:]:
                print(arch, a, "vs", b, "first parting position per row:",
                      first_parting(toks[a], toks[b]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
