"""Compare two checkouts of the port on one workload, in one call on one
card.

    python3 scripts/ab_main_path.py OLD_DIR NEW_DIR [ROUNDS]
        [--workload emit|graph_gpu|hc|lull|mesh|ysb_paced]
        [--rate EVENTS_PER_S]
        [--events N] [--device cuda|cpu]

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
events/s, p50 / p99 of window emit - the window's latest ingest (ms),
the mean size of the staged row batches as the first device stage
takes them, with the counts held to the model; also the staging cuts by
the code path that made them (the three innermost callers of
``GPUStageEmitter._ship``: count, staging age, punctuation, EOS), each
with its mean rows, and the median of how far the source is behind its
pace at a cut (ms; its lag at the first cut taken as 0). Workload
``lull`` measures the latency that a lull costs: a source pushes 8 bursts
of 2,048 rows one by one (no output batch; its watermark stepping on
every push), each followed by 0.6 s without a push, through a host Map
(its worker ticks when idle) whose staging emitter feeds Map_GPU, into
a columnar sink; per burst, the time from its last push to the sink's
receipt of its last row (ms), p50 and max. Workload ``emit`` times the
host side of the row path alone: 200,000 rows of two int32 fields, the
watermark stepping on every row, emitted into one staging emitter
(output batches of 4,096, forward, on ``--device``) whose port drops
what it is sent; the best of 5 passes after one that fills its staging
pool, ns a row. Workload ``mesh`` drives
``chip_smoke.py``'s mesh HC run (Ffat_Windows_Mesh at (4, 2) on 8
virtual shards of one group, 2 warm-up + 6 timed batches of the HC
stream) after loading the kernel, then the same run under
``torch.profiler``: tuples/s of the first, and kernels and copies a
batch of the profiled one. Workload ``graph_gpu`` drives
``chip_smoke.py``'s graph_tests_gpu stream (256 keys, 14 batches of
65,536 int32 tuples, map -> filter -> reduce) through the keyed reduce
at parallelism 2, the global reduce, and both fused (``chain`` at
parallelism 1): each graph run once to build and warm, once timed, once
under ``torch.profiler``; tuples/s after chip_smoke's warm-up batches,
kernels a batch and the card's idle share of each (the medians are of
the keyed graph's kernels a batch).

Each run is a fresh process that imports one checkout's
``windflow_tpu_torch`` and its ``chip_smoke.py`` on ``--device``
(default ``cuda``; ``cpu`` only checks the script). One warm-up run of
each side comes first and is not counted (a call's first two processes
run slower). Runs then go old, new, new, old in each of ROUNDS rounds
(default 2). Prints one JSON
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
if {device!r} == "cuda" and not torch.cuda.is_available():
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
import collections, time
from windflow_tpu_torch import kafka
from windflow_tpu_torch.gpu import emitters_gpu as eg
if {device!r} == "cuda":
    from windflow_tpu_torch.kernels.build import load_library
    load_library("forest_rebuild")  # an nvcc build must not land in the run
cuts = collections.defaultdict(lambda: [0, 0])  # path -> [cuts, rows]
lags, origin = [], []
ship = eg.GPUStageEmitter._ship


def counted_ship(self, buf):
    n = len(self._rows[buf]) + self._ccount[buf]
    if n:
        f, path = sys._getframe(1), []
        while f is not None and len(path) < 3:
            path.append(f.f_code.co_name)
            f = f.f_back
        cut = cuts["<".join(path)]
        cut[0] += 1
        cut[1] += n
        if self._rows[buf]:  # the source's lag behind its pace
            due = self._rows[buf][-1][1] / c.YSB_TS_STEP_US / {rate}
            if not origin:
                origin.append(time.perf_counter() - due)
            lags.append(1e3 * (time.perf_counter() - origin[0] - due))
    return ship(self, buf)


eg.GPUStageEmitter._ship = counted_ship
kafka.MemoryBroker.reset()
c._ysb_fill(kafka, {events})
counts, n_rows, lat, eps, _, graph = c._ysb_run(wt, kafka, {device!r}, "ab",
                                                {events}, rate={rate})
p50, p99 = c._pcts(lat)
# the staged rows' device batches, as the first device stage takes them
first = next(o for o in graph.get_stats()["Operators"]
             if sum(r.get("Device_batches_in", 0) for r in o["replicas"]))
n_in, n_b = (sum(r[k] for r in first["replicas"])
             for k in ("Inputs_received", "Device_batches_in"))
print(json.dumps({{"events_per_s": eps, "p50_ms": p50, "p99_ms": p99,
                  "mean_device_batch": n_in / n_b, "device_batches": n_b,
                  "cuts": {{k: [v[0], v[1] / v[0]] for k, v in cuts.items()}},
                  "lag_p50_ms": sorted(lags)[len(lags) // 2],
                  "counts_equal_model": counts == c._ysb_model({events})}}))
""",
    "emit": r"""
import time
import numpy as np
from windflow_tpu_torch.gpu.emitters_gpu import GPUStageEmitter
from windflow_tpu_torch.gpu.schema import TupleSchema


class DropPort:
    def send(self, msg):
        pass


rows = [{{"a": i, "b": i}} for i in range(200_000)]
em = GPUStageEmitter(1, 4_096, TupleSchema({{"a": np.int32, "b": np.int32}}),
                     None, "forward", wt.ExecutionMode.DEFAULT, None,
                     torch.device({device!r}))
em.set_ports([DropPort()])
best, t = None, 0
for rep in range(6):  # the first pass fills the staging pool: not timed
    t0 = time.perf_counter()
    for r in rows:
        em.emit(r, t, t)
        t += 1
    em.flush()
    if {device!r} == "cuda":
        torch.cuda.synchronize()
    ns = (time.perf_counter() - t0) / len(rows) * 1e9
    if rep:
        best = ns if best is None else min(best, ns)
print(json.dumps({{"emit_ns_per_row": best}}))
""",
    "lull": r"""
import collections, time
import numpy as np
BURST, BURSTS, LULL_S = 2_048, 8, 0.6
pushed, got, seen = {{}}, {{}}, collections.Counter()


def src(shipper, ctx):
    ts = 0
    for k in range(BURSTS):
        for i in range(BURST):
            ts += 10
            shipper.push_with_timestamp({{"burst": k, "v": i}}, ts)
            shipper.set_next_watermark(ts)
        pushed[k] = time.perf_counter()
        time.sleep(LULL_S)


def sink(cols, ts):
    if cols is None:
        return
    for k, n in zip(*np.unique(cols["burst"], return_counts=True)):
        seen[int(k)] += int(n)
        if seen[int(k)] == BURST:
            got[int(k)] = time.perf_counter()


g = wt.PipeGraph("lull", wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT_TIME,
                 device={device!r})
g.add_source(wt.Source_Builder(src).build()) \
    .add(wt.Map_Builder(lambda t: t).with_output_batch_size(4_096).build()) \
    .add(wt.Map_GPU_Builder(lambda f: {{**f, "v": f["v"] + 1}}).build()) \
    .add_sink(wt.Sink_Builder(sink).with_columns().build())
g.run()
lat = sorted(1e3 * (got[k] - pushed[k]) for k in range(BURSTS))
print(json.dumps({{"lull_p50_ms": lat[len(lat) // 2], "lull_max_ms": lat[-1],
                  "bursts": len(lat)}}))
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

_CHILD["graph_gpu"] = r"""
blocks = c._blocks(c.GRAPH_KEYS, seed=9, n_batches=c.GRAPH_BATCHES)
out = {{}}
for name, kw in (("keyed", dict(keyed=True)), ("global", dict(keyed=False)),
                 ("fused_keyed", dict(keyed=True, par=1, chain=True)),
                 ("fused_global", dict(keyed=False, par=1, chain=True))):
    run = lambda kw=kw: c._run_ops_graph(wt, {device!r}, blocks, **kw)
    run()  # builds the kernels and makes the first allocations
    parts, t_yield, _ = run()
    span = max(t for t, _ in parts) - t_yield[c.GRAPH_WARMUP]
    prof = (c._profiled(torch, run, len(blocks)) if {device!r} == "cuda"
            else dict(kernels_per_batch=0.0, device_idle_share=None))
    out[name + "_tuples_per_s"] = \
        (c.GRAPH_BATCHES - c.GRAPH_WARMUP) * c.BATCH / span
    out[name + "_kernels_per_batch"] = prof["kernels_per_batch"]
    out[name + "_idle_share"] = prof["device_idle_share"]
print(json.dumps(out))
"""

# the per-run number each workload's medians are taken over
_KEY = {"emit": "emit_ns_per_row", "hc": "tuples_per_s",
        "graph_gpu": "keyed_kernels_per_batch",
        "lull": "lull_p50_ms",
        "mesh": "kernels_per_batch", "ysb_paced": "p50_ms"}


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        sys.exit("nvidia-smi failed: " + out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def _run(root: str, args: argparse.Namespace) -> dict:
    code = (_PRELUDE + _CHILD[args.workload]).format(
        root=root, rate=args.rate, events=args.events, device=args.device)
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
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()
    old, new = os.path.abspath(args.old), os.path.abspath(args.new)
    key = _KEY[args.workload]
    card = _card() if args.device == "cuda" else "cpu"
    runs = {"old": [], "new": []}
    for side in ("old", "new"):  # warm-up runs, not counted
        res = _run(old if side == "old" else new, args)
        print(json.dumps({"round": "warm-up", "side": side, "card": card,
                          "workload": args.workload, **res}), flush=True)
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
