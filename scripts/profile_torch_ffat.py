"""Where the port's FFAT main path spends its time on one CUDA card.

    python3 scripts/profile_torch_ffat.py [n_keys] [win_per_batch]

Runs ``chip_smoke.py``'s main-path stream (``bench.py``'s configuration:
65,536-tuple int32 batches, TB window 100 ms / slide 25 ms, default
10,240 keys) through ``windflow_tpu_torch`` on ``cuda`` once to warm up,
then once under ``torch.profiler``, and prints one JSON line: the
profiled run's wall time, the device's busy time (sum of kernel and copy
durations on the card) and idle share, device launches per batch, the
replica's host-prep vs device-commit split, and the top device kernels
by time. Needs a CUDA card.
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
        sys.exit("profile_torch_ffat: needs a CUDA card")
    n_keys = int(sys.argv[1]) if len(sys.argv) > 1 else 10_240
    wpb = int(sys.argv[2]) if len(sys.argv) > 2 else None
    blocks = cs._blocks(n_keys, seed=7)
    cs._run_graph(wt, "cuda", blocks, n_keys, wpb)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, _, wall, rep = cs._run_graph(wt, "cuda", blocks, n_keys,
                                              wpb)
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    by_name = {}
    for e in dev:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    st = rep.stats
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "keys": n_keys, "batches": len(blocks), "batch": cs.BATCH,
        "wall_ms": span * 1e3, "graph_wall_ms": wall * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / (span * 1e3),
        "device_events": len(dev),
        "device_events_per_batch": len(dev) / len(blocks),
        "host_prep_ms_total": st.dispatch_host_prep_total_us / 1e3,
        "commit_ms_total": st.dispatch_commit_total_us / 1e3,
        "rebuild_kernel_launches": st.rebuild_kernel_launches,
        "top_device_ms": [[name[:80], t / 1e3, n] for name, (t, n) in top],
    }))


if __name__ == "__main__":
    main()
