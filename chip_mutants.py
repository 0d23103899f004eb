#!/usr/bin/env python3
"""Mutation check of the bf16 flash-attention forward, on one card.

  python3 chip_mutants.py

Makes three broken copies of ``src/`` and ``chip_smoke.py`` under
``build/mutants/``, each with one text replacement in
``csrc/flash_attention.cu``; builds each copy's kernel, runs
``chip_smoke.py``'s bf16 flash checks there and prints one JSON line per
mutant with the checks it failed.  The checks can see these faults only
if every mutant fails at least one of them (or crashes); the script exits
non-zero otherwise.  The mutants:

- ``corr_dropped``: the online softmax never rescales (corr = 1);
- ``last_partial_tile_skipped``: a key tile that ends past k_end is not
  loaded;
- ``diagonal_mask_dropped``: keys past a row's position are not masked.
"""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = "src/repro_torch/csrc/flash_attention.cu"
MUTANTS = {
    "corr_dropped": ("        corr[h] = exp2f(m[h] * sl2 - base[h]);",
                     "        corr[h] = 1.f;"),
    "last_partial_tile_skipped": (
        "  const int n_tiles = (k_end + kN - 1) / kN;",
        "  const int n_tiles = k_end / kN;"),
    "diagonal_mask_dropped": (
        "          if (kp >= T || (a.causal && kp > qpos[(v >> 1) & 1]))",
        "          if (kp >= T)"),
}
# chip_smoke.py's bf16 flash check cases, bar the training shape
CHECKS = r'''
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
timer = cs.Timer()
gen = torch.Generator(device="cuda").manual_seed(42)
for c in [(1, 1, 1, 128, 128, 128, True), (1, 1, 1, 128, 128, 128, False),
          (2, 2, 2, 256, 256, 128, True), (1, 2, 4, 128, 384, 128, True),
          (1, 2, 4, 128, 300, 128, False), (2, 1, 4, 24, 24, 16, True),
          (1, 1, 8, 300, 300, 256, True), (1, 1, 8, 128, 384, 256, True),
          (1, 32, 1, 512, 512, 64, True), (1, 1, 8, 300, 300, 256, True, 8.0),
          (1, 32, 1, 512, 512, 64, True, 8.0),
          (1, 2, 4, 128, 300, 128, False, 8.0)]:
    fwd, _ = cs._flash_case(timer, torch.bfloat16, *c[:7], gen, *c[7:])
    print(json.dumps(dict(case=c, ok=fwd["ok"], err=fwd["max_abs_err"],
                          lse_err=fwd["lse_max_abs_err"])), flush=True)
'''


def main() -> int:
    caught = 0
    for name, (old, new) in MUTANTS.items():
        copy = os.path.join(ROOT, "build", "mutants", name)
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "src"), os.path.join(copy, "src"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), copy)
        path = os.path.join(copy, SRC)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            print(f"chip_mutants: {name}: the line to replace is not in "
                  f"{SRC} once", file=sys.stderr)
            return 1
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        run = subprocess.run([sys.executable, "-c", CHECKS], cwd=copy,
                             capture_output=True, text=True, timeout=600)
        rows = [json.loads(line) for line in run.stdout.splitlines()
                if line.startswith("{")]
        failed = [r for r in rows if not r["ok"]]
        caught += bool(failed) or run.returncode != 0
        print(json.dumps(dict(mutant=name, rc=run.returncode,
                              checks=len(rows), failed=len(failed),
                              failing=failed)), flush=True)
    return 0 if caught == len(MUTANTS) else 1


if __name__ == "__main__":
    sys.exit(main())
