"""The forest-rebuild kernel's regimes, each forced, on one CUDA card.

    python3 scripts/bench_torch_k1.py

Times ``windflow_tpu_torch/kernels/forest_rebuild.cu`` with
``chip_smoke.py``'s method (device duration from ``torch.profiler`` per
call, L2 flushed; the event bracket around the wrapper beside it) and
prints one JSON line per forest, after the card's name and power limit:

- ``split``: the warp and the cta regime in turns (warp, cta, cta, warp)
  at every F the warp regime takes (32 to 512), one int32 sum field and
  four min/max fields;
- ``tiles``: the cta regime at tile sizes of 8 to 48 KB of leaves per
  stage, in turns starting and ending with the wrapper's own
  (``forest_rebuild.CTA_TILE_BYTES``).

Every run is checked bit for bit against the plain version. Needs a CUDA
card.

    python3 scripts/bench_torch_k1.py --policy CHECKOUT [CHECKOUT ...]

times the fieldwise library's K1 at the main path's forests (``POLICY``)
in each checkout (a directory holding ``chip_smoke.py`` and
``windflow_tpu_torch/``, such as another commit's ``git archive``
unpacked under ``build/``), each in a process of its own, in turns (A, B,
B, A): two versions of the fieldwise combine policy compared in one call
on one card. One JSON line per forest and turn.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPLIT = [(262144, 32), (65536, 128), (32768, 256), (16384, 512)]
TILES = [(16384, 1024, "int32_sum"), (16384, 1024, "minmax_pairs"),
         (8192, 2048, "int32_sum"), (256, 1024, "int32_sum")]
TILE_BYTES = [8192, 12288, 16384, 24576, 32768, 49152]
# the fieldwise forests of the main paths (10,240 and 64 keys, F 32)
POLICY = [(16384, 32, "int32_sum"), (16384, 32, "float32_sum"),
          (16384, 32, "minmax_pairs"), (64, 32, "int32_sum")]


def policy_turn(checkout: str, turn: int) -> None:
    """K1 of ``checkout``'s fieldwise library at each ``POLICY`` forest,
    checked bit for bit against the plain version and timed."""
    sys.path.insert(0, checkout)
    import torch

    import chip_smoke as cs
    from windflow_tpu_torch.combines import fieldwise
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.kernels.reference import forest_rebuild_ref

    gen = torch.Generator().manual_seed(4321)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    for K, F, sname in POLICY:
        spec = cs.SPECS[sname]
        comb = fieldwise(**{f"f{i}": op for i, (_, op) in enumerate(spec)})
        trees, tvalid = cs._forest(torch, K, F, spec, gen)
        kt, kv = cs._clone(trees, tvalid)
        rt, rv = cs._clone(trees, tvalid)
        fr.forest_rebuild(kt, kv, comb)
        forest_rebuild_ref(rt, rv, comb)
        torch.cuda.synchronize()
        if not cs._bit_identical(torch, kt, kv, rt, rv):
            sys.exit(f"bench_torch_k1: {checkout} differs from the plain "
                     f"version at K_cap={K} F={F} {sname}")
        row = cs.time_rebuild(torch, fr.forest_rebuild, kt, kv, comb, spec,
                              flush, len(fr.forest_plan(kt, kv)))
        print(json.dumps({"policy": {"checkout": checkout, "turn": turn,
                                     "K_cap": K, "F": F, "fields": sname,
                                     "bit_identical": True, **row}}),
              flush=True)


def policy(checkouts) -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    for turn, d in enumerate(checkouts + checkouts[::-1]):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--policy-turn", os.path.abspath(d), str(turn)],
                       check=True)


def main() -> None:
    import torch

    import chip_smoke as cs
    from windflow_tpu_torch.combines import fieldwise
    from windflow_tpu_torch.kernels import build
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.kernels.reference import forest_rebuild_ref

    if not torch.cuda.is_available():
        sys.exit("bench_torch_k1: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    lib = build.load_library("forest_rebuild")
    gen = torch.Generator().manual_seed(4321)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    base_tile = fr.CTA_TILE_BYTES

    def turn(K, F, spec, comb, trees, tvalid, ref, warp_max_f):
        plan = fr.launch_plan(K, F, len(spec), True, warp_max_f=warp_max_f)

        def run(t, v, c):
            fr.run_plan(lib, plan, t, v, c,
                        torch.cuda.current_stream().cuda_stream)
        t, v = cs._clone(trees, tvalid)
        run(t, v, comb)
        torch.cuda.synchronize()
        same = torch.equal(v, ref[1]) and all(
            torch.equal(t[k].view(torch.int32), ref[0][k].view(torch.int32))
            for k in t)
        if not same:
            sys.exit(f"bench_torch_k1: plan {plan} differs from the plain "
                     f"version at K_cap={K} F={F}")
        return {"plan": [[p.regime, p.W, p.S, p.E, p.rows] for p in plan],
                **cs.time_rebuild(torch, run, t, v, comb, spec, flush,
                                  len(plan))}

    def forest(K, F, sname):
        spec = cs.SPECS[sname]
        comb = fieldwise(**{f"f{i}": op for i, (_, op) in enumerate(spec)})
        trees, tvalid = cs._forest(torch, K, F, spec, gen)
        ref = cs._clone(trees, tvalid)
        forest_rebuild_ref(*ref, comb)
        return spec, comb, trees, tvalid, ref

    for K, F in SPLIT:
        for sname in ("int32_sum", "minmax_pairs"):
            spec, comb, trees, tvalid, ref = forest(K, F, sname)
            turns = [{"regime": who, **turn(K, F, spec, comb, trees, tvalid,
                                            ref, wmf)}
                     for who, wmf in (("warp", 1 << 30), ("cta", 8),
                                      ("cta", 8), ("warp", 1 << 30))]
            print(json.dumps({"split": {"K_cap": K, "F": F,
                                        "fields": sname, "turns": turns}}),
                  flush=True)
            del trees, tvalid, ref
    for K, F, sname in TILES:
        spec, comb, trees, tvalid, ref = forest(K, F, sname)
        turns = []
        for tb in [base_tile] + TILE_BYTES + [base_tile]:
            fr.CTA_TILE_BYTES = tb
            fr.launch_plan.cache_clear()
            turns.append({"tile_bytes": tb, **turn(K, F, spec, comb, trees,
                                                   tvalid, ref, 8)})
        fr.CTA_TILE_BYTES = base_tile
        fr.launch_plan.cache_clear()
        print(json.dumps({"tiles": {"K_cap": K, "F": F, "fields": sname,
                                    "turns": turns}}), flush=True)
        del trees, tvalid, ref


if __name__ == "__main__":
    if sys.argv[1:2] == ["--policy-turn"]:
        policy_turn(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1:2] == ["--policy"]:
        policy(sys.argv[2:])
    else:
        main()
