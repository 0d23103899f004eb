"""Real tier moves on a CUDA card: the Unimem mover relocating tensors
between HBM (the fast tier) and pinned host memory (the slow tier) with
asynchronous copies on CUDA copy streams — the port of
``examples/tiered_offload_demo.py``.

Tensors are registered as data objects (leaf byte spans recorded), the
loop is the ``iteration()``/``phase()`` context managers, and
``backend="torch_async"`` flips an object's tier when its copy lands
(settled without blocking at phase boundaries).  Needs a CUDA card.

  PYTHONPATH=src python examples/tiered_offload_demo_torch.py
"""

import sys
import time
sys.path.insert(0, "src")

import torch

from repro_torch.core import H100_HBM_HOST, RuntimeConfig, UnimemRuntime

MB = 1024 ** 2


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("this demo moves real tensors between HBM and pinned host "
                 "memory and needs a CUDA card")
    print("device:", torch.cuda.get_device_name(0))
    rt = UnimemRuntime(H100_HBM_HOST,
                       RuntimeConfig(fast_capacity_bytes=64 * MB,
                                     enable_partitioning=False,
                                     backend="torch_async"))

    # register real tensors as target data objects (all start on the host)
    objs = {}
    for name, mbs in (("weights_hot", 24), ("kv_block", 24),
                      ("opt_state_cold", 48)):
        t = torch.ones(mbs * MB // 4, dtype=torch.float32).pin_memory()
        objs[name] = rt.register(name, t)

    # iteration 1 profiles; accesses favor the hot objects
    for it in range(4):
        with rt.iteration():
            with rt.phase("compute", elapsed=0.05,
                          accesses={"weights_hot": 4e5, "kv_block": 3e5}):
                time.sleep(0.01)
            with rt.phase("update", elapsed=0.02,
                          accesses={"opt_state_cold": 5e2}):
                pass
        for name, obj in objs.items():
            where = "HBM" if obj.payload.is_cuda else "pinned host"
            print(f"  iter {it}: {name:16s} tier={obj.tier:5s} "
                  f"payload in {where}")
    print("stats:", rt.stats())


if __name__ == "__main__":
    main()
