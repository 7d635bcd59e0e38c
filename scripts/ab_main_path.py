"""Compare two checkouts of the port on one workload, in one call on one
card.

    python3 scripts/ab_main_path.py OLD_DIR NEW_DIR [ROUNDS]
        [--workload hc|mesh|ysb_paced] [--rate EVENTS_PER_S] [--events N]

Workload ``hc`` (the default) drives ``chip_smoke.py``'s high-cardinality
main path (10,240 keys, 24 batches of 65,536 int32 tuples, TB window
100 ms / slide 25 ms, Columnar_Source -> Ffat_Windows_GPU -> columnar
sink); a process runs the graph twice and reports the second run (the
first pays CUDA initialisation and the first allocations): tuples/s after
chip_smoke's warm-up batches and K1 launches. Workload ``ysb_paced``
drives ``chip_smoke.py``'s YSB device chain (an in-process ``memory://``
Kafka broker of ``--events`` events, default 300,000, read by a
Kafka_Source at parallelism 2 -> Filter_GPU -> Map_GPU ->
Ffat_Windows_GPU over 10 s tumbling windows -> columnar sink) paced at
``--rate`` events/s (default 40,000: about half the rows' saturated
rate), after loading (or first building) the forest-rebuild kernel:
events/s, and p50 / p99 of window emit - the window's latest ingest (ms),
with the counts held to the model. Workload ``mesh`` drives
``chip_smoke.py``'s mesh HC run (Ffat_Windows_Mesh at (4, 2) on 8
virtual shards of one group, 2 warm-up + 6 timed batches of the HC
stream) after loading the kernel, then the same run under
``torch.profiler``: tuples/s of the first, and kernels and copies a
batch of the profiled one.

Each run is a fresh process that imports one checkout's
``windflow_tpu_torch`` and its ``chip_smoke.py`` on ``cuda``. Runs go
old, new, new, old in each of ROUNDS rounds (default 2). Prints one JSON
line per run and a last line with each side's runs and medians, beside
the card's name and power limit. Needs a CUDA card and each checkout's
kernel source.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

_PRELUDE = r"""
import json, sys
sys.path.insert(0, {root!r})
import torch
import chip_smoke as c
import windflow_tpu_torch as wt
if not torch.cuda.is_available():
    sys.exit("no CUDA card")
"""

_CHILD = {
    "hc": r"""
from windflow_tpu_torch.kernels import forest_rebuild as fr
blocks = c._blocks(c.HC_KEYS, seed=7)
for _ in range(2):
    fr.LAUNCHES = 0
    run = c._run_graph(wt, "cuda", blocks, c.HC_KEYS, None)
rates = c._ffat_rates(blocks, run)
print(json.dumps({{"tuples_per_s": rates["tuples_per_s"],
                  "rebuild_launches": fr.LAUNCHES}}))
""",
    "ysb_paced": r"""
from windflow_tpu_torch import kafka
from windflow_tpu_torch.kernels.build import load_library
load_library("forest_rebuild")  # an nvcc build must not land in the run
kafka.MemoryBroker.reset()
c._ysb_fill(kafka, {events})
counts, n_rows, lat, eps = c._ysb_run(wt, kafka, "cuda", "ab", {events},
                                      rate={rate})[:4]
p50, p99 = c._pcts(lat)
print(json.dumps({{"events_per_s": eps, "p50_ms": p50, "p99_ms": p99,
                  "counts_equal_model": counts == c._ysb_model({events})}}))
""",
}

_CHILD["mesh"] = r"""
from windflow_tpu_torch.kernels.build import load_library
from windflow_tpu_torch.mesh import core as mcore
load_library("forest_rebuild")  # an nvcc build must not land in the run
mcore.ensure_virtual_devices(c.MESH_VDEV)
blocks = c._blocks(c.HC_KEYS, seed=71, n_batches=c.MESH_BATCHES,
                   batch=c.BATCH)
mesh_run = lambda: c._run_mesh_ffat(wt, "cuda", blocks, c.HC_KEYS, (4, 2),
                                    c.BATCH)
rates = c._mesh_rates(mesh_run(), c.BATCH, 0)
prof = c._profiled(torch, mesh_run, len(blocks))
print(json.dumps({{"tuples_per_s": rates["tuples_per_s"],
                  "kernels_per_batch": prof["kernels_per_batch"],
                  "copies_per_batch": prof["copies_per_batch"]}}))
"""

# the per-run number each workload's medians are taken over
_KEY = {"hc": "tuples_per_s", "mesh": "kernels_per_batch",
        "ysb_paced": "p50_ms"}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        sys.exit("nvidia-smi failed: " + out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def _run(root: str, args: argparse.Namespace) -> dict:
    code = (_PRELUDE + _CHILD[args.workload]).format(
        root=root, rate=args.rate, events=args.events)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=900)
    if out.returncode != 0:
        sys.exit(f"run in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("rounds", nargs="?", type=int, default=2)
    ap.add_argument("--workload", choices=sorted(_CHILD), default="hc")
    ap.add_argument("--rate", type=float, default=40_000.0)
    ap.add_argument("--events", type=int, default=300_000)
    args = ap.parse_args()
    old, new = os.path.abspath(args.old), os.path.abspath(args.new)
    key = _KEY[args.workload]
    card = _card()
    runs = {"old": [], "new": []}
    for r in range(args.rounds):
        for side in ("old", "new", "new", "old"):
            res = _run(old if side == "old" else new, args)
            if res.get("counts_equal_model") is False:
                sys.exit(f"{side}: counts differ from the model")
            runs[side].append(res)
            print(json.dumps({"round": r, "side": side, "card": card,
                              "workload": args.workload, **res}),
                  flush=True)
    print(json.dumps({"card": card, "old": old, "new": new,
                      "workload": args.workload,
                      key: {k: [x[key] for x in v] for k, v in runs.items()},
                      "median": {k: statistics.median(x[key] for x in v)
                                 for k, v in runs.items()}}), flush=True)


if __name__ == "__main__":
    main()
