"""Batched serving example, the PyTorch port's copy of
``examples/serve_batched.py``: greedy generation with KV caches on a
reduced gemma-2b (MQA) config, on the card by default.

  PYTHONPATH=src python examples/serve_batched_torch.py
  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu

Full-width serving of any ported config goes through the launcher, e.g.
``python -m repro_torch.launch.serve --arch yi-6b --max-seq 1024``.
"""

import argparse
import sys
import time
sys.path.insert(0, "src")

import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config("gemma-2b").reduced()
    params = lm.init_params(cfg, torch.Generator(device=args.device)
                            .manual_seed(0), device=args.device)
    engine = ServeEngine(cfg, params, max_seq=128, batch=4,
                         device=args.device)
    prompts = torch.randint(0, cfg.vocab_size, (4, 12),
                            generator=torch.Generator().manual_seed(1))
    t0 = time.perf_counter()
    out = engine.generate(prompts.to(args.device), 24).cpu()
    dt = time.perf_counter() - t0
    toks = engine.stats.prefill_tokens + engine.stats.decode_tokens
    print(f"batch=4 prompt=12 new=24 -> {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.0f} tok/s)")
    for row in out[:2]:
        print(" ", row.tolist()[:20], "...")


if __name__ == "__main__":
    main()
