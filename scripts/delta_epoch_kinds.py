"""Count how often an epoch's kind (FULL or delta) varies between runs of
``chip_smoke.py``'s ``delta`` phase, part ``ffat_tumbling``, on one card.

    python3 scripts/delta_epoch_kinds.py [RUNS] [--paced]

Each run drives the part's stream (10,240 keys, 24 batches of 65,536
int32 tuples into a 320 ms tumbling Ffat_Windows_GPU, a checkpoint every 4
batches) once with synchronous delta checkpoints and once with delta +
async uploads, and prints each run's epoch kinds. ``--paced`` requests
each epoch only once the one before is committed (``_ReplayBlocks``'s
``settle``), as the phase's crash run does. The last line counts the runs
whose kinds differ from the synchronous run's usual FULL, FULL, delta,
FULL, FULL, delta, beside the card's name and power limit. Needs a CUDA
card and the kernel source (built on the first run).
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
USUAL = ["FULL", "FULL", "delta", "FULL", "FULL", "delta"]


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    runs = int(args[0]) if args else 15
    paced = "--paced" in sys.argv
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as c
    import windflow_tpu_torch as wt
    from windflow_tpu_torch.checkpoint import CheckpointStore

    card, _ = c.device_phase(torch)
    c.build_phase()
    part = next(p for p in c._delta_parts(wt) if p[0] == "ffat_tumbling")
    unusual = {mode: 0 for mode, _ in c.DELTA_MODES[1:]}
    for i in range(runs):
        for mode, ckpt in c.DELTA_MODES[1:]:
            store = c._ckpt_dir(f"kinds_{i}_{mode}")
            src = c._ReplayBlocks(part[1], every=c.DELTA_EVERY,
                                  settle=store if paced else None)
            g = c._run_delta_graph(wt, "cuda", part, src, store, ckpt)[1]
            st = CheckpointStore(store)
            kinds = ["delta" if st.load_manifest(
                st._dirname(h["ckpt_id"])).get("deps") else "FULL"
                for h in g._coordinator.history]
            unusual[mode] += kinds != USUAL
            print(json.dumps({"run": i, "mode": mode, "paced": paced,
                              "kinds": kinds}), flush=True)
    print(json.dumps({"card": card, "runs": runs, "paced": paced,
                      "unusual": unusual}), flush=True)


if __name__ == "__main__":
    main()
