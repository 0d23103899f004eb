"""Training launcher.

  python -m repro_torch.launch.train --arch gemma-2b --reduced --device cpu
  python -m repro_torch.launch.train --arch gemma-2b --batch 2 --seq-len 2048 --steps 5
  python -m repro_torch.launch.train --arch zamba2 --reduced --device cpu --steps 3 --batch 2 --seq-len 32
  python -m repro_torch.launch.train --arch zamba2-1.2b --batch 2 --seq-len 4096 --steps 5
  python -m repro_torch.launch.train --arch xlstm --reduced --device cpu --steps 3 --batch 2 --seq-len 32
  python -m repro_torch.launch.train --arch xlstm-350m --batch 2 --seq-len 2048 --steps 5
  python -m repro_torch.launch.train --arch musicgen --reduced --device cpu --steps 3 --batch 2 --seq-len 32
  python -m repro_torch.launch.train --arch musicgen-large --batch 2 --seq-len 2048 --steps 5
"""

from __future__ import annotations

import argparse

from ..configs import get_config
from ..optim import AdamWConfig
from ..train.loop import TrainConfig, train


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--moments", choices=["float32", "bfloat16", "int8"],
                    default="float32")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(steps=args.steps, global_batch=args.batch,
                       seq_len=args.seq_len, lr=args.lr,
                       microbatches=args.microbatches,
                       checkpoint_dir=args.checkpoint_dir,
                       device=args.device)
    opt = AdamWConfig(lr=args.lr, moments_dtype=args.moments)
    result = train(cfg, tcfg, opt)
    rest = result.step_times[1:]
    print(f"final loss: {result.losses[-1]:.4f} "
          f"(first: {result.losses[0]:.4f}); "
          f"mean step {1e3 * sum(rest) / max(1, len(rest)):.0f} ms")
    print("unimem:", result.runtime_stats)


if __name__ == "__main__":
    main()
