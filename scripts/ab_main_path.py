"""Compare two checkouts of the port on the main path, in one call on one
card.

    python3 scripts/ab_main_path.py OLD_DIR NEW_DIR [ROUNDS]

Each run drives ``chip_smoke.py``'s high-cardinality main path (10,240
keys, 24 batches of 65,536 int32 tuples, TB window 100 ms / slide 25 ms,
Columnar_Source -> Ffat_Windows_GPU -> columnar sink) through one
checkout's ``windflow_tpu_torch`` on ``cuda``, in a fresh process that
imports that checkout's package and its ``chip_smoke.py``. A process runs
the graph twice and reports the second run (the first pays CUDA
initialisation and the first allocations). Runs go old, new, new, old in
each of ROUNDS rounds (default 2). Prints one JSON line per run (tuples/s
after chip_smoke's warm-up batches, K1 launches) and a last line with
each side's runs and medians, beside the card's name and power limit.
Needs a CUDA card and each checkout's kernel source.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as c
import windflow_tpu_torch as wt
from windflow_tpu_torch.kernels import forest_rebuild as fr
if not torch.cuda.is_available():
    sys.exit("no CUDA card")
blocks = c._blocks(c.HC_KEYS, seed=7)
for _ in range(2):
    fr.LAUNCHES = 0
    run = c._run_graph(wt, "cuda", blocks, c.HC_KEYS, None)
rates = c._ffat_rates(blocks, run)
print(json.dumps({{"tuples_per_s": rates["tuples_per_s"],
                  "rebuild_launches": fr.LAUNCHES}}))
"""


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        sys.exit("nvidia-smi failed: " + out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def _run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", _CHILD.format(root=root)],
                         capture_output=True, text=True, cwd=root,
                         timeout=900)
    if out.returncode != 0:
        sys.exit(f"run in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    old, new = (os.path.abspath(p) for p in sys.argv[1:3])
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    card = _card()
    runs = {"old": [], "new": []}
    for r in range(rounds):
        for side in ("old", "new", "new", "old"):
            res = _run(old if side == "old" else new)
            runs[side].append(res["tuples_per_s"])
            print(json.dumps({"round": r, "side": side, "card": card,
                              **res}), flush=True)
    print(json.dumps({"card": card, "old": old, "new": new,
                      "tuples_per_s": runs,
                      "median": {k: statistics.median(v)
                                 for k, v in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()
