"""The inclusive segmented scan with a user combine: the plain versions of
the hand kernels that fold rows by key, K2+K3 (``kernels/ffat_step.py``,
the JAX package's ``ffat_tpu.py`` step) and K7 (``kernels/reduce_fold.py``:
the keyed ``Reduce_GPU``, ``ops_tpu.py`` ``ReduceTPUReplica``, and the
keyed terminator of a fused chain, which scans with a validity plane,
``fused_ops.py`` ``seg_op``). They run on the CPU; a card runs the
kernels.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def rowwise(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row mask shaped to select whole rows of ``x`` (a column with
    trailing dimensions, a composite key, takes the row's flag in each
    element)."""
    return mask.reshape(mask.shape + (1,) * (x.dim() - 1))


def segmented_scan(combine: Callable, vals: Dict[str, torch.Tensor],
                   same_prev: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inclusive segmented scan of ``vals`` (a dict of equal-length
    columns): ``same_prev[i]`` says row ``i`` continues the segment of row
    ``i - 1``. Hillis-Steele log-step form of the JAX package's
    ``associative_scan``: the same operator with another grouping of the
    combines, so float sums may round differently. The combine always sees
    (earlier, later) partials; a field it does not return passes through
    from the later one. The inputs are not written."""
    return masked_segmented_scan(combine, vals, same_prev)[0]


def masked_segmented_scan(combine: Callable, vals: Dict[str, torch.Tensor],
                          same_prev: torch.Tensor,
                          valid: Optional[torch.Tensor] = None
                          ) -> Tuple[Dict[str, torch.Tensor],
                                     Optional[torch.Tensor]]:
    """``segmented_scan`` with validity as an Option (the JAX package's
    fused keyed terminator, ``fused_ops.py`` ``seg_op``): an invalid side
    passes the other through, and the scanned validity says whether any
    valid row of the segment lies at or before each row, so an invalid
    segment tail means the segment had no valid row. The value of a row
    whose scanned validity is False is unspecified. Returns ``(vals,
    valid)``; with ``valid`` None it is ``segmented_scan``, combine for
    combine."""
    n = same_prev.shape[0]
    s = same_prev
    d = 1
    while d < n:
        a = {k: v[:-d] for k, v in vals.items()}
        b = {k: v[d:] for k, v in vals.items()}
        sb = s[d:]
        merged = combine(a, b)
        if valid is None:
            vals = {k: torch.cat([v[:d], torch.where(
                rowwise(sb, v), merged.get(k, b[k]), b[k])])
                for k, v in vals.items()}
        else:
            vb = valid[d:]
            vsb = valid[:-d] & sb  # a is valid and in b's segment
            vals = {k: torch.cat([v[:d], torch.where(
                rowwise(vsb, v), torch.where(rowwise(vb, v),
                                             merged.get(k, b[k]), a[k]),
                b[k])]) for k, v in vals.items()}
            valid = torch.cat([valid[:d], vb | vsb])
        s = torch.cat([s[:d], s[:-d] & sb])
        d *= 2
    return vals, valid
