"""Where the port's map -> filter -> keyed reduce path spends its time on
one CUDA card.

    python3 scripts/profile_torch_graph.py [keys] [reduce_parallelism]

Runs ``chip_smoke.py``'s graph_gpu stream (``bench.py``'s keyed-reduce
configuration: 65,536-tuple int32 batches, default 256 keys, 14 batches)
through ``windflow_tpu_torch`` on ``cuda``: Columnar source -> Map_GPU ->
Filter_GPU -> Reduce_GPU keyed by "key" (default parallelism 2) ->
columnar sink. One run warms up, one is timed plain, one runs under
``torch.profiler`` (CPU and CUDA). Prints one JSON line: the plain run's
wall time; each device operator's host-prep and device-commit time per
batch, summed over its replicas (a Filter's commit includes the keyed
re-shard it emits into, a Reduce's commit its exit); the profiled run's
device busy time and idle share, kernels and copies per batch, the top
device kernels and the top host ops by self CPU time. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import windflow_tpu_torch as wt

    if not torch.cuda.is_available():
        sys.exit("profile_torch_graph: needs a CUDA card")
    n_keys = int(sys.argv[1]) if len(sys.argv) > 1 else cs.GRAPH_KEYS
    cs.GRAPH_PAR = int(sys.argv[2]) if len(sys.argv) > 2 else cs.GRAPH_PAR
    blocks = cs._blocks(n_keys, seed=9, n_batches=cs.GRAPH_BATCHES)
    nb = len(blocks)
    cs._run_ops_graph(wt, "cuda", blocks, True)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, graph = cs._run_ops_graph(wt, "cuda", blocks, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stages = {}
    for op in graph._ops[1:4]:
        st = [r.stats for r in op.replicas]
        stages[op.name] = {
            "replicas": len(st),
            "prep_ms_per_batch": sum(s.dispatch_host_prep_total_us
                                     for s in st) / 1e3 / nb,
            "commit_ms_per_batch": sum(s.dispatch_commit_total_us
                                       for s in st) / 1e3 / nb}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cs._run_ops_graph(wt, "cuda", blocks, True)
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    kernels, copies = cs._events(torch, prof)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels + copies)
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top_dev = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "keys": n_keys,
        "reduce_parallelism": cs.GRAPH_PAR, "batches": nb,
        "batch": cs.BATCH, "wall_ms": wall * 1e3,
        "tuples_per_s": nb * cs.BATCH / wall, "stages": stages,
        "profiled_wall_ms": span * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / (span * 1e3),
        "kernels_per_batch": len(kernels) / nb,
        "copies_per_batch": len(copies) / nb,
        "top_device_ms": [[name[:60], t / 1e3, n]
                          for name, (t, n) in top_dev],
        "top_host_self_ms": [[a.key[:60], a.self_cpu_time_total / 1e3,
                              a.count] for a in host[:12]],
    }))


if __name__ == "__main__":
    main()
