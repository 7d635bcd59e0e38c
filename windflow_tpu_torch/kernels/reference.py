"""Plain PyTorch version of the FlatFAT forest rebuild.

The level loop of ``windflow_tpu/tpu/ffat_tpu.py:360-373``
(``rebuild_levels``) on torch tensors: one pass per level over the whole
forest, node i = combine(node 2i, node 2i+1) when both children are valid,
else the valid child passes through (the right one when neither is).
The tests hold it against the JAX package, ``chip_smoke.py`` holds the
CUDA kernel against it on the card, and the FFAT replica uses it for
forests that live on the CPU. Like the kernel it updates in place.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def forest_rebuild_ref(trees: Dict[str, torch.Tensor], tvalid: torch.Tensor,
                       combine: Callable) -> Tuple[Dict[str, torch.Tensor],
                                                   torch.Tensor]:
    F = tvalid.shape[1] // 2
    lvl = F >> 1
    while lvl >= 1:
        lc = {k: t[:, 2 * lvl:4 * lvl:2] for k, t in trees.items()}
        rc = {k: t[:, 2 * lvl + 1:4 * lvl:2] for k, t in trees.items()}
        vlc = tvalid[:, 2 * lvl:4 * lvl:2]
        vrc = tvalid[:, 2 * lvl + 1:4 * lvl:2]
        merged = combine(lc, rc)
        both = vlc & vrc
        for k, t in trees.items():
            t[:, lvl:2 * lvl] = torch.where(
                both, merged[k], torch.where(vlc, lc[k], rc[k]))
        tvalid[:, lvl:2 * lvl] = vlc | vrc
        lvl >>= 1
    return trees, tvalid
