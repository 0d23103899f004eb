"""Training loop with the Unimem runtime in charge of tier placement.

Counterpart of the reference package's ``train/loop.py``.  Per-step
phases: data fetch -> train_step -> (periodically) checkpoint.  The
runtime profiles the first iterations, plans placement for the registered
objects (the optimizer state, chunkable; the parameters, pinned) and
moves them between HBM and pinned host memory; its drift monitor doubles
as the straggler detector and triggers re-planning.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Dict, Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs.base import ArchConfig
from ..core import ManualSource, RuntimeConfig, UnimemRuntime
from ..core.tiers import H100_HBM_HOST, MachineProfile
from ..data import DataConfig, SyntheticTokenPipeline
from ..models import lm
from ..models.common import tree_bytes
from ..optim import AdamWConfig, init_opt_state
from .step import build_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    lr: float = 3e-4
    microbatches: int = 1
    remat: bool = True
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 10
    seed: int = 0
    machine: MachineProfile = dataclasses.field(
        default_factory=lambda: H100_HBM_HOST)
    use_unimem: bool = True
    device: str = "cuda"


@dataclasses.dataclass
class TrainResult:
    losses: list
    step_times: list
    final_step: int
    runtime_stats: Dict[str, Any]
    grad_norms: list = dataclasses.field(default_factory=list)
    runtime: Optional[UnimemRuntime] = None


def train(cfg: ArchConfig, tcfg: TrainConfig,
          opt_cfg: Optional[AdamWConfig] = None) -> TrainResult:
    opt_cfg = opt_cfg or AdamWConfig()
    device = torch.device(tcfg.device)
    gen = torch.Generator(device=device).manual_seed(tcfg.seed)
    params = lm.init_params(cfg, gen, device=device)
    opt_state = init_opt_state(params, opt_cfg)
    data = SyntheticTokenPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=tcfg.seq_len,
        global_batch=tcfg.global_batch, seed=tcfg.seed), device=device)
    step_fn = build_train_step(cfg, opt_cfg, microbatches=tcfg.microbatches,
                               remat=tcfg.remat, lr=tcfg.lr)

    ckpt = (CheckpointManager(tcfg.checkpoint_dir)
            if tcfg.checkpoint_dir else None)
    start_step = 0
    if ckpt is not None and ckpt.latest_step() is not None:
        start_step, state = ckpt.restore(device=device)
        params, opt_state = state["params"], state["opt"]

    # ---- Unimem runtime: the optimizer state is the tierable object.
    # Registration records per-leaf byte spans (chunk boundaries can align
    # to them); the state is updated in place by the step, so tiers are
    # tracked logically (manage_payload=False).  The "step" phase's access
    # counts are static for a fixed step function, so a ManualSource states
    # them once.
    rt: Optional[UnimemRuntime] = None
    if tcfg.use_unimem:
        rt = UnimemRuntime(tcfg.machine, RuntimeConfig(
            fast_capacity_bytes=tcfg.machine.fast.capacity_bytes))
        rt.register("opt_state", opt_state, chunkable=True,
                    manage_payload=False)
        rt.register("params", params, pinned=True, manage_payload=False)
        src = ManualSource()
        src.set("step", accesses={"opt_state": tree_bytes(opt_state) / 512,
                                  "params": tree_bytes(params) / 512})
        rt.attach_source(src)

    def phase(name):
        return rt.phase(name) if rt else contextlib.nullcontext()

    losses, times, norms = [], [], []
    for step in range(start_step, tcfg.steps):
        t0 = time.perf_counter()
        with rt.iteration() if rt else contextlib.nullcontext():
            with phase("data"):
                batch = data.batch_at(step)
            with phase("step"):
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])          # waits for the step
            with phase("ckpt"):
                if ckpt is not None \
                        and (step + 1) % tcfg.checkpoint_every == 0:
                    ckpt.save(step + 1, {"params": params, "opt": opt_state})
        losses.append(loss)
        norms.append(float(metrics["grad_norm"]))
        times.append(time.perf_counter() - t0)
        if (step + 1) % tcfg.log_every == 0:
            print(f"step {step + 1}: loss={loss:.4f} "
                  f"({times[-1] * 1e3:.0f} ms)")
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss diverged at step {step}")
    if ckpt is not None:
        ckpt.save(tcfg.steps, {"params": params, "opt": opt_state},
                  blocking=True)
    return TrainResult(losses, times, tcfg.steps, rt.stats() if rt else {},
                       norms, rt)
