"""End-to-end training driver, the PyTorch port's copy of
``examples/train_e2e.py``: a ~110M-parameter dense LM trained on the
synthetic pipeline with checkpointing and the Unimem runtime enabled, on
the card by default.

Default profile is small (~25M params, 100 steps).  ``--full`` trains the
110M model for 300 steps (the deliverable profile).  Checkpoints go to
``--ckpt`` (default: a directory under the system's temporary directory).

  PYTHONPATH=src python examples/train_e2e_torch.py
  PYTHONPATH=src python examples/train_e2e_torch.py --device cpu
  PYTHONPATH=src python examples/train_e2e_torch.py --full
"""

import argparse
import os
import sys
import tempfile
sys.path.insert(0, "src")

from repro_torch.configs.base import ArchConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train.loop import TrainConfig, train


def lm_config(full: bool) -> ArchConfig:
    if full:   # ~110M params
        return ArchConfig(name="lm-110m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4,
                          d_ff=2048, vocab_size=32000, tie_embeddings=True)
    return ArchConfig(name="lm-25m", family="dense", n_layers=8,
                      d_model=512, n_heads=8, n_kv_heads=4,
                      d_ff=1408, vocab_size=8192, tie_embeddings=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_e2e_ckpt"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    cfg = lm_config(args.full)
    steps = args.steps or (300 if args.full else 100)
    tcfg = TrainConfig(steps=steps, global_batch=8, seq_len=128, lr=6e-4,
                       checkpoint_dir=args.ckpt, checkpoint_every=50,
                       log_every=10, device=args.device)
    print(f"training {cfg.name}: {cfg.n_params() / 1e6:.1f}M params, "
          f"{steps} steps")
    res = train(cfg, tcfg, AdamWConfig(lr=6e-4))
    print(f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f}; "
          f"checkpoints in {args.ckpt}")
    print("unimem:", res.runtime_stats)


if __name__ == "__main__":
    main()
