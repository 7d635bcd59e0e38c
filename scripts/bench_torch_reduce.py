"""The reduce operators' kernels, K7 (the keyed fold) and K6 (the masked
tree), in two or more checkouts in turns, on one CUDA card.

    python3 scripts/bench_torch_reduce.py CHECKOUT [CHECKOUT ...]
        [--no-sweep] [--no-paths]

times ``windflow_tpu_torch/kernels/reduce_fold.cuh`` of each checkout (a
directory holding ``chip_smoke.py`` and ``windflow_tpu_torch/``, such as
another commit's ``git archive`` unpacked under ``build/``), each turn in
a process of its own, in turns (A, B, B, A; with more checkouts A B C C B
A): two designs of the kernels compared in one call on one card. A turn
builds the checkout's libraries of the reduce combines (one nvcc each,
all started together; a stack frame or a spill in any kernel stops the
bench), then runs this tree's ``chip_smoke.py`` layouts against that
checkout's package: each ``FOLD_TIMED`` layout through K7 and K6 as the
checkout's reduce paths call them (K7 with the host's starts where the
checkout takes them; K6 on the graph_gpu batch in the size form where
the checkout has it, else with the mask its path built), held against
the checkout's plain versions (K6 bit for bit, K7 exact on ints), then
timed: device time from ``torch.profiler`` (L2 warm), the event bracket
around the wrapper, the wrapper's host time a call (``host_us``: 2,000
calls back to back), and the library call (``index_add_`` /
``torch.sum``) for the int sums. Unless ``--no-sweep``, for a checkout
with K7's regimes: the regimes' sweep (``sweep_cases``: runs of 8 to
8,192 rows at a fixed batch, each through the warp regime and through
the chunk blocks at each chunk size, held against each other), which
sets ``BLOCK_ROWS`` and ``CHUNK_ROWS``. Unless ``--no-paths``: the four graph_gpu reduce
paths end to end (``path_cases``: keyed at parallelism 2, global, and
both fused): tuples/s, K6 / K7 launches, kernels a batch and the card's
idle share. One JSON line per case and turn, after the card's name and
power limit. Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _here_chip_smoke():
    """This tree's ``chip_smoke.py`` (its case helpers), under a name of
    its own: the checkout's package is what it imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bench", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _build(torch, cs) -> None:
    """The checkout's library of every reduce combine the cases run, in
    parallel."""
    from concurrent.futures import ThreadPoolExecutor
    libs = {fv.variant.library: fv.variant
            for fv in cs._reduce_variants(torch).values()}
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(v.load) for v in libs.values()]:
            fut.result()


def _takes(fn, name: str) -> bool:
    return name in inspect.signature(fn).parameters


def _host_us(torch, fn, calls=2000):
    """The wrapper's host time a call, us: ``calls`` calls back to back
    with no sync between them (the card keeps up: each call's kernels
    take less than its host time), after 200 to warm."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def layout_cases(torch, wt, cs):
    """Each ``FOLD_TIMED`` layout through the checkout's K7 and K6 as its
    paths call them, held against its plain versions, then timed."""
    from windflow_tpu_torch.kernels import reduce_fold as rf
    dev = torch.device("cuda")
    blocks = cs._blocks(cs.GRAPH_KEYS, seed=9,
                        n_batches=cs.GRAPH_WARMUP + 1, batch=cs.BATCH)
    rng = np.random.default_rng(21)
    specs = cs._fold_specs()
    new_k7 = _takes(rf.keyed_fold, "starts")
    new_k6 = _takes(rf.tree_reduce, "size")
    out = []
    # the same rng draws as chip_smoke's, up to the last timed layout
    last = max(cs.FOLD_LAYOUTS.index(t) for t in cs.FOLD_TIMED)
    for name in cs.FOLD_LAYOUTS[:last + 1]:
        comb, cols, order, slots, n_slots, valid, out_rows = cs.fold_layout(
            torch, name, blocks, rng)
        if name not in cs.FOLD_TIMED:
            continue
        starts = np.searchsorted(slots, np.arange(n_slots + 1)).astype(
            np.int32)
        max_run = int(np.diff(starts).max(initial=0))
        c = dict(comb=specs[comb], cname=comb,
                 cols={k: torch.from_numpy(v).to(dev)
                       for k, v in cols.items()},
                 order=torch.from_numpy(order).to(dev),
                 slots=torch.from_numpy(slots).to(dev), n_slots=n_slots,
                 valid=None if valid is None
                 else torch.from_numpy(valid).to(dev), out_rows=out_rows)
        n = len(order)
        if name == "graph_gpu":  # the kept rows first: a prefix
            size = int((slots < n_slots).sum())
            c["mask"] = torch.arange(n, device=dev) < size
            tree_kw = dict(size=size) if new_k6 else dict(valid=c["mask"])
        else:
            c["mask"] = c["valid"] if valid is not None else torch.from_numpy(
                slots[np.argsort(order)] < n_slots).to(dev)
            tree_kw = dict(valid=c["mask"])
        args = (c["comb"], c["cols"], c["order"], c["slots"], n_slots,
                c["valid"], out_rows)
        kw7 = {}
        if new_k7:
            kw7 = (dict(starts=rf.run_starts(c["slots"], n_slots))
                   if name == "mesh" else
                   dict(starts=torch.from_numpy(starts).to(dev),
                        max_run=max_run))
        got, gv = rf.keyed_fold(*args, **kw7)
        ref, rv = rf.keyed_fold_ref(*args)
        torch.cuda.synchronize()
        err = cs._reduce_err(torch, f"K7 {name}", got, gv, ref, rv, False)
        tg, tgv = rf.tree_reduce(c["comb"], c["cols"], **tree_kw)
        tr, trv = rf.tree_reduce_ref(c["comb"], c["cols"], c["mask"])
        torch.cuda.synchronize()
        cs._reduce_err(torch, f"K6 {name}", tg, tgv, tr, trv, True)
        for kernel, fn in (
                ("keyed_fold", lambda: rf.keyed_fold(*args, **kw7)),
                ("tree_reduce", lambda: rf.tree_reduce(
                    c["comb"], c["cols"], **tree_kw))):
            device_ms, launches, bracket = cs._program_ms(
                torch, fn, tries=cs.STEP_TRACE_TRIES)
            row = dict(program=kernel, layout=name, rows=n, slots=n_slots,
                       longest_run=max_run, device_ms=device_ms,
                       launches=launches, wrapper_ms=bracket,
                       host_us=_host_us(torch, fn),
                       max_abs_err=err if kernel == "keyed_fold" else 0.0,
                       form=("size" if "size" in tree_kw else "mask")
                       if kernel == "tree_reduce" else
                       ("starts" if kw7 else "tiles"))
            if c["cname"] == "sum_value":
                lib = cs._fold_library(torch, kernel, c)
                row.update(library_ms=lib["library_ms"],
                           library_device_ms=lib["library_device_ms"])
            out.append(row)
    return out


# run lengths of the regimes' sweep, at a fixed batch of chip_smoke's
# BATCH, and the chunk sizes tried
SWEEP_RUNS = (8, 16, 31, 32, 64, 128, 256, 384, 512, 768, 1024, 2048, 4096,
              8192)
SWEEP_CHUNKS = (128, 256, 512, 1024)


def sweep_cases(torch, wt, cs):
    """K7's regimes against each other at run lengths ``SWEEP_RUNS``
    (``BATCH // L`` slots of L rows each, arrival shuffled; the graph's
    int sum): the kernel with every run in the warp regime (the thread
    regime below 32 rows) and with every run in the chunk blocks at each
    chunk size of ``SWEEP_CHUNKS`` up to L, held against each other.
    Rows of each (L, regime, chunk); none for a checkout without K7's
    regimes."""
    from windflow_tpu_torch.kernels import reduce_fold as rf
    if not hasattr(rf, "chunk_blocks"):
        return []
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    out = []
    for L in SWEEP_RUNS:
        n = cs.BATCH // L * L
        slots = np.repeat(np.arange(n // L, dtype=np.int32), L)
        order = rng.permutation(n).astype(np.int32)
        fields = {"key": torch.from_numpy(rng.integers(0, 256, n).astype(
                      np.int32)).to(dev),
                  "value": torch.from_numpy(rng.integers(0, 100, n).astype(
                      np.int32)).to(dev)}
        o = torch.from_numpy(order).to(dev)
        sk = torch.from_numpy(slots).to(dev)
        k = n // L
        starts = rf.run_starts(sk, k)
        call = rf._call_plan(cs._sum_value, fields)
        stream = torch.cuda.current_stream(dev).cuda_stream
        plans = [("warp" if L >= rf.WARP_ROWS else "thread", 1 << 30,
                  rf.CHUNK_ROWS)]
        plans += [("chunk", L, ch) for ch in SWEEP_CHUNKS if ch <= L]
        got = []
        for regime, br, ch in plans:
            blocks = rf.chunk_blocks(n, L, br, ch)

            def fn(br=br, ch=ch, blocks=blocks):
                return rf.launch_keyed_fold(call, fields, o, sk, starts, k,
                                            None, k, blocks, stream, br, ch)

            res = fn()
            torch.cuda.synchronize()
            got.append(res[0]["value"].clone())
            device_ms, launches, bracket = cs._program_ms(torch, fn)
            out.append(dict(program="K7_sweep", run=L, regime=regime,
                            chunk=ch if regime == "chunk" else None,
                            rows=n, slots=k, device_ms=device_ms,
                            launches=launches, wrapper_ms=bracket,
                            ns_per_row=None if device_ms is None
                            else device_ms * 1e6 / n))
        if not all(torch.equal(got[0], g) for g in got[1:]):
            sys.exit(f"bench_torch_reduce: the regimes differ at runs of {L}")
    return out


def path_cases(torch, wt, cs):
    """The four graph_gpu reduce paths, each one graph run to warm, one
    timed and one profiled: rows held against the numpy fold; tuples/s
    after the warm-up batches, K6 / K7 launches, kernels a batch and the
    card's idle share."""
    blocks = cs._blocks(cs.GRAPH_KEYS, seed=9, n_batches=cs.GRAPH_BATCHES)
    tot, per_batch = cs._fold(blocks)
    out = []
    for name, kw in (("keyed", dict(keyed=True)),
                     ("global", dict(keyed=False)),
                     ("fused_keyed", dict(keyed=True, par=1, chain=True)),
                     ("fused_global", dict(keyed=False, par=1, chain=True))):
        def run(kw=kw):
            return cs._run_ops_graph(wt, "cuda", blocks, **kw)

        run()  # builds and warms
        parts, t_yield, _ = run()
        launches = cs._reduce_launched(
            f"bench {name}", "keyed_fold" if kw["keyed"] else "tree_reduce")
        if kw["keyed"]:
            g = cs._concat(parts)
            got = np.zeros(cs.GRAPH_KEYS, dtype=np.int64)
            np.add.at(got, g["key"], g["value"])
            ok = np.array_equal(got, tot)
        else:
            ok = cs._concat(parts)["value"].tolist() == per_batch
        if not ok:
            sys.exit(f"bench_torch_reduce: {name}: rows differ from the "
                     "numpy fold")
        span = max(t for t, _ in parts) - t_yield[cs.GRAPH_WARMUP]
        prof = cs._profiled(torch, run, len(blocks))
        out.append(dict(program="reduce_path", path=name,
                        batches=len(blocks), warmup=cs.GRAPH_WARMUP,
                        batch=cs.BATCH,
                        tuples_per_s=(cs.GRAPH_BATCHES - cs.GRAPH_WARMUP)
                        * cs.BATCH / span, fold_launches=launches,
                        **{k: prof.get(k) for k in (
                            "kernels_per_batch", "copies_per_batch",
                            "device_idle_share", "device_busy_ms",
                            "wall_ms")}))
    return out


def turn(checkout: str, idx: int, sweep: bool, paths: bool) -> None:
    sys.path.insert(0, checkout)
    import torch

    import windflow_tpu_torch as wt

    if not wt.__file__.startswith(os.path.abspath(checkout)):
        sys.exit(f"bench_torch_reduce: imported {wt.__file__}, not the "
                 f"checkout {checkout}")
    cs = _here_chip_smoke()
    _build(torch, cs)
    from windflow_tpu_torch.kernels import build
    spilled = cs._spills(build, "forest_rebuild")
    if spilled:
        sys.exit(f"bench_torch_reduce: {checkout}: kernels with a stack "
                 f"frame or spills: {spilled}")
    cases = layout_cases(torch, wt, cs)
    if sweep:
        cases += sweep_cases(torch, wt, cs)
    if paths:
        cases += path_cases(torch, wt, cs)
    for row in cases:
        print(json.dumps({"reduce": {"checkout": checkout, "turn": idx,
                                     **row}}), flush=True)


def main(argv) -> None:
    sweep, paths = "--no-sweep" not in argv, "--no-paths" not in argv
    argv = [a for a in argv if a not in ("--no-sweep", "--no-paths")]
    if not argv:
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        sys.exit("bench_torch_reduce: needs a CUDA card (nvidia-smi failed)")
    print(smi.stdout.strip(), flush=True)
    for idx, d in enumerate(argv + argv[::-1]):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--turn", os.path.abspath(d), str(idx),
                        str(int(sweep)), str(int(paths))], check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        turn(sys.argv[2], int(sys.argv[3]), sys.argv[4] == "1",
             sys.argv[5] == "1")
    else:
        main(sys.argv[1:])
