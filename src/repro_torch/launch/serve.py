"""Serving launcher: batched greedy generation.

  python -m repro_torch.launch.serve --arch gemma --reduced --batch 4 --new 32
  python -m repro_torch.launch.serve --arch gemma --reduced --device cpu
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..models import lm
from ..serve.engine import ServeEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    gen = torch.Generator(device=args.device).manual_seed(0)
    params = lm.init_params(cfg, gen, device=args.device)
    engine = ServeEngine(cfg, params, max_seq=args.max_seq,
                         batch=args.batch, device=args.device)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=args.device)
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.new)
    out = out.cpu()
    dt = time.perf_counter() - t0
    total = engine.stats.prefill_tokens + engine.stats.decode_tokens
    print(f"generated {tuple(out.shape)} in {dt:.2f}s "
          f"({total / dt:.0f} tok/s incl. prefill)")
    print("sample:", out[0, :24].tolist())


if __name__ == "__main__":
    main()
