"""The keyed grid scan's kernel, K8, in two or more checkouts in turns, on
one CUDA card.

    python3 scripts/bench_torch_k8.py CHECKOUT [CHECKOUT ...] [--no-sweep]
        [--no-paths]

times ``windflow_tpu_torch/kernels/grid_scan.cuh`` of each checkout (a
directory holding ``chip_smoke.py`` and ``windflow_tpu_torch/``, such as
another commit's ``git archive`` unpacked under ``build/``), each turn in
a process of its own, in turns (A, B, B, A; with more checkouts A B C C B
A): two designs of the kernel compared in one call on one card. A turn
builds the checkout's K8 libraries (one nvcc each, all started together;
a stack frame or a spill in any of them stops the bench), then runs this tree's ``chip_smoke.py`` cases against that checkout's
package: every ``programs`` layout (``k8_layouts`` with ``timed_only``:
each held bit for bit against the checkout's plain version, then timed,
device time from ``torch.profiler`` with marker kernels between calls,
L2 warm) and, unless ``--no-sweep``, the regimes' sweep (``sweep_cases``:
run lengths 8-1,024 at a fixed batch, every key in the thread regime and
every key in the block regime, held against each other; a checkout with
no block regime gives its thread regime) and, unless ``--no-paths``, the
stateful paths K8 serves, end to end (``path_cases``: the ``state`` part
smap and the mesh part ``ops`` stateful map at (4, 2) on one group and on
four groups of the card). One JSON line per case and turn, after the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# this tree's threshold and smap tile: the edges layout's runs where a
# checkout's K8 has no block regime
EDGE_FALLBACK = (32, 256)


def _here_chip_smoke():
    """This tree's ``chip_smoke.py`` (its case helpers), under a name of
    its own: the checkout's package is what it imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_bench", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _shim_thread_only(cs, gs) -> bool:
    """Lets this tree's case helpers drive a checkout whose K8 predates
    the block regime (its ``KeyRows`` has no heavy list, its module no
    ``tile_rows``): every key is walked by a thread, and the edges layout
    takes this tree's threshold and tile. True where it shimmed."""
    if hasattr(gs, "tile_rows"):
        return False
    gs.HEAVY_ROWS, tile = EDGE_FALLBACK
    gs.tile_rows = lambda lib: tile

    def thread_only(rows):
        nt = rows.n_touched
        runs = np.diff(rows.starts.cpu().numpy().astype(np.int64)[:nt + 1])
        return (int(runs.max()) if nt else 0), nt, 0, None

    cs._k8_regimes = thread_only
    return True


def _build(torch, cs) -> None:
    """The checkout's K8 library of every step the cases run, in
    parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from windflow_tpu_torch.kernels import grid_scan as gs
    steps = [gs.step_variant(*s) for s in (
        *cs._k8_step_specs(torch).values(), cs._k8_wide_spec(torch))]
    with ThreadPoolExecutor(len(steps)) as pool:
        for fut in [pool.submit(v.load) for v in steps]:
            fut.result()


# run lengths of the regimes' sweep, at a fixed batch of chip_smoke's BATCH
SWEEP_RUNS = (8, 16, 24, 32, 48, 64, 128, 256, 512, 1024)


def sweep_cases(torch, wt, cs):
    """K8's two regimes against each other at run lengths ``SWEEP_RUNS``
    (``BATCH // L`` keys of L rows each, arrival shuffled; the smap
    step): the kernel once with every key in the thread regime and once
    with every key in the block regime (its threshold set to L), the two
    held bit for bit against each other. Rows of each (L, regime); a
    checkout with no block regime gives its thread regime only."""
    from types import SimpleNamespace

    from windflow_tpu_torch.kernels import grid_scan as gs
    from windflow_tpu_torch.pytree import tree_flatten, tree_unflatten
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    out = []
    for L in SWEEP_RUNS:
        n = cs.BATCH // L * L
        keys = np.repeat(np.arange(cs.BATCH // L, dtype=np.int32), L)
        rng.shuffle(keys)
        eng = cs._k8_engine(torch, wt, cs._smap_fn, False,
                            {"n": np.int32(0)}, "key")
        rows = eng.prep(SimpleNamespace(size=n, capacity=n,
                                        host_keys=keys.astype(np.int64)))
        fields = {"key": torch.from_numpy(keys).to(dev),
                  "value": torch.from_numpy(
                      rng.integers(0, 100, n).astype(np.int32)).to(dev)}
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        regimes = {"thread": rows}
        if hasattr(gs, "heavy_keys"):
            counts = np.diff(rows.starts.cpu().numpy())[:rows.n_touched]
            hl = gs.heavy_keys(counts, L)
            regimes = {"thread": rows._replace(heavy=None, heavy_blocks=0),
                       "block": rows._replace(
                           heavy=torch.from_numpy(hl).to(dev),
                           heavy_blocks=len(hl), heavy_rows=L)}
        leaves, spec = tree_flatten(eng.table)
        got = []
        for name, r in regimes.items():
            tk = tree_unflatten(spec, [lf.clone() for lf in leaves])
            dk = eng.dirty.clone()
            o = gs.grid_walk(eng.step, fields, valid, r, tk, dk)
            torch.cuda.synchronize()
            # one call's table and dirty bits: the timing below calls the
            # kernel on them again, a number of times that varies where
            # the profiler drops a trace and it is taken again
            got.append((o["value"], tree_flatten(tk)[0][0].clone(),
                        dk.clone()))
            device_ms, launches, bracket = cs._program_ms(
                torch, lambda: gs.grid_walk(eng.step, fields, valid, r, tk,
                                            dk), reps=cs.K8_REPS)
            _, n_thread, n_block, _ = cs._k8_regimes(r)
            out.append(dict(
                program="K8_sweep", run=L, regime=name, rows=n,
                keys=rows.n_touched, thread_keys=n_thread,
                block_keys=n_block, device_ms=device_ms, launches=launches,
                wrapper_ms=bracket,
                ns_per_row=None if device_ms is None else device_ms * 1e6 / L))
        if len(got) == 2 and not all(torch.equal(a, b)
                                     for a, b in zip(*got)):
            sys.exit(f"bench_torch_k8: the regimes differ at runs of {L}")
    return out


def path_cases(torch, wt, cs):
    """The stateful paths that launch K8, each one graph run on the card
    and one profiled run: the ``state`` part smap (64 keys) and the mesh
    part ``ops`` stateful map (10,240 keys) at (4, 2) on one group and on
    four groups of cuda:0, 14 batches of 65,536 rows, 2 of them warm-up.
    Rows must equal the numpy fold; a row gives tuples/s after the
    warm-up, K8's launches, and the profiled run's kernels a batch and
    idle share."""
    from windflow_tpu_torch.mesh import core as mcore
    state = cs._blocks(cs.STATE_KEYS, seed=21, n_batches=cs.STATE_BATCHES,
                       batch=cs.BATCH)
    hc = cs._blocks(cs.HC_KEYS, seed=73, n_batches=cs.STATE_BATCHES,
                    batch=cs.BATCH)
    four = [d for _, d in cs._mesh_layouts(torch) if len(d) == 4]
    runs = [("state smap", state, cs._smap_ops, None),
            ("mesh map (4, 2) 1 group", hc,
             lambda w: cs._mesh_ops(w, "map", (4, 2)), None),
            ("mesh map (4, 2) 4 groups", hc,
             lambda w: cs._mesh_ops(w, "map", (4, 2)), four[0])]
    prev = mcore.virtual_device_groups()
    out = []
    for name, blocks, make, devs in runs:
        mcore.ensure_virtual_devices(cs.MESH_VDEV, group_devices=devs)
        try:
            torch.cuda.synchronize()
            cs._k8_reset()
            grun = cs._run_state_graph(wt, "cuda", blocks, make)
            k8 = cs._k8_launched(name)
            if not np.array_equal(cs._concat(grun[0])["value"],
                                  cs._smap_fold(blocks)):
                sys.exit(f"bench_torch_k8: {name}: rows differ from the "
                         "numpy fold")
            prof = cs._profiled(torch, lambda: cs._run_state_graph(
                wt, "cuda", blocks, make), len(blocks))
        finally:
            mcore.ensure_virtual_devices(cs.MESH_VDEV, group_devices=prev)
        out.append(dict(program="K8_path", path=name, batches=len(blocks),
                        warmup=cs.STATE_WARMUP, batch=cs.BATCH,
                        tuples_per_s=cs._state_rates(grun, len(blocks),
                                                     cs.BATCH),
                        k8_launches=k8, **{k: prof.get(k) for k in (
                            "kernels_per_batch", "device_idle_share",
                            "device_busy_ms", "wall_ms")}))
    return out


def turn(checkout: str, idx: int, sweep: bool, paths: bool) -> None:
    sys.path.insert(0, checkout)
    import torch

    import windflow_tpu_torch as wt

    if not wt.__file__.startswith(os.path.abspath(checkout)):
        sys.exit(f"bench_torch_k8: imported {wt.__file__}, not the "
                 f"checkout {checkout}")
    from windflow_tpu_torch.kernels import grid_scan as gs
    cs = _here_chip_smoke()
    shimmed = _shim_thread_only(cs, gs)
    _build(torch, cs)
    from windflow_tpu_torch.kernels import build
    spilled = cs._spills(build, "grid_scan-")
    if spilled:
        sys.exit(f"bench_torch_k8: {checkout}: K8 kernels with a stack "
                 f"frame or spills: {spilled}")
    blocks = cs._blocks(cs.STATE_KEYS, seed=21,
                        n_batches=cs.STATE_WARMUP + 1, batch=cs.BATCH)
    cases = list(cs.k8_layouts(torch, wt, blocks, None,
                               timed_only=True).values())
    if shimmed:
        for row in cases:
            row["tile_rows"] = None
    if sweep:
        cases += sweep_cases(torch, wt, cs)
    if paths:
        cases += path_cases(torch, wt, cs)
    for row in cases:
        row.pop("card", None)
        print(json.dumps({"k8": {"checkout": checkout, "turn": idx, **row}}),
              flush=True)


def main(argv) -> None:
    sweep, paths = "--no-sweep" not in argv, "--no-paths" not in argv
    argv = [a for a in argv if a not in ("--no-sweep", "--no-paths")]
    if not argv:
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        sys.exit("bench_torch_k8: needs a CUDA card (nvidia-smi failed)")
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
