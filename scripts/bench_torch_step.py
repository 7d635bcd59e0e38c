"""The FFAT step's kernels, K2+K3 and K4, in two or more checkouts in turns,
on one CUDA card.

    python3 scripts/bench_torch_step.py CHECKOUT [CHECKOUT ...] [--kinds K]
        [--variants V,...]

times ``windflow_tpu_torch/kernels/ffat_step.cuh`` of each checkout (a
directory holding ``chip_smoke.py`` and ``windflow_tpu_torch/``, such as
another commit's ``git archive`` unpacked under ``build/``), each turn in
a process of its own, in turns (A, B, B, A; with more checkouts A B C C B
A): two designs of the kernels compared in one call on one card. A turn
runs the timed cases of ``chip_smoke.py``'s ``programs`` phase (this
tree's: ``step_cases`` with ``timed_only``) against that checkout's
package: K2+K3 of every variant on its own path's batch (the fieldwise
sum on every layout of ``STEP_LAYOUTS``), K4 after each on the path's
fire steps and, for the fieldwise sum, on the long ring (F 1,024). Each case is checked against the checkout's plain version
first (K2+K3 exact on ints and bools, floats within ``STEP_FOLD_RTOL``;
K4 bit for bit), then timed: device time from ``torch.profiler`` (L2
warm), the event bracket of the wrapper, the bytes bound and, for the
fieldwise K2+K3, ``scatter_reduce_``'s time. ``--kinds ingest`` or
``--kinds query`` keeps one kernel's cases, ``--variants fieldwise,wide``
some variants' (default: every one of ``STEP_VARIANTS``). One JSON line
per case and turn, after the card's name and power limit. Needs a CUDA
card.

A checkout whose ``ffat_step`` predates ``sort_rows`` (its K2+K3 gathers
the keys through the order) is driven through its own signature
(``_adapt``), for comparisons with that design.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

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


def _adapt(torch, fs) -> None:
    """Drive a checkout's K2+K3 wrapper that takes the packed keys and
    the order (no ``sort_rows``): its stand-in ``sort_rows`` gives the
    order and the packed keys, which the stand-in ``ingest_fold`` passes
    on as that wrapper takes them."""
    if hasattr(fs, "sort_rows"):
        return
    fold = fs.ingest_fold

    def ingest_fold(comb, vals, sorted_rows, flat, vflat, F):
        order, comp = sorted_rows
        fold(comb, vals, comp, order, flat, vflat, F)

    fs.sort_rows = lambda comp: (
        torch.sort(comp, stable=True).indices.to(torch.int32), comp)
    fs.ingest_fold = ingest_fold


def turn(checkout: str, idx: int, kinds: str, variants: str) -> None:
    sys.path.insert(0, checkout)
    import numpy as np
    import torch

    import windflow_tpu_torch as wt
    from windflow_tpu_torch.kernels import ffat_step as fs

    if not wt.__file__.startswith(os.path.abspath(checkout)):
        sys.exit(f"bench_torch_step: imported {wt.__file__}, not the "
                 f"checkout {checkout}")
    cs = _here_chip_smoke()
    _adapt(torch, fs)
    rng = np.random.default_rng(17)
    gen = torch.Generator().manual_seed(17)
    batches = {lay: cs.step_batch(lay, rng) for lay in cs.STEP_LAYOUTS}
    fires, long_fires = cs.step_fires(wt, rng)
    names = cs.STEP_VARIANTS if variants == "all" else variants.split(",")
    for name in names:
        for key, row in cs.step_cases(torch, wt, name, batches, fires,
                                      long_fires, gen, None,
                                      timed_only=True,
                                      query=kinds != "ingest"):
            if kinds != "all" and key[0] != kinds:
                continue
            row.pop("card", None)
            print(json.dumps({"step": {"checkout": checkout, "turn": idx,
                                       **row}}), flush=True)


def _option(argv, name, default):
    if name not in argv:
        return argv, default
    i = argv.index(name)
    return argv[:i] + argv[i + 2:], argv[i + 1]


def main(argv) -> None:
    argv, kinds = _option(argv, "--kinds", "all")
    argv, variants = _option(argv, "--variants", "all")
    if not argv or kinds not in ("all", "ingest", "query"):
        sys.exit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        sys.exit("bench_torch_step: needs a CUDA card (nvidia-smi failed)")
    print(smi.stdout.strip(), flush=True)
    for idx, d in enumerate(argv + argv[::-1]):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--turn", os.path.abspath(d), str(idx), kinds,
                        variants], check=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--turn"]:
        turn(sys.argv[2], int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        main(sys.argv[1:])
