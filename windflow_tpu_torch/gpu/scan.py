"""The inclusive segmented scan with a user combine, shared by the device
operators that group rows by key: ``Ffat_Windows_GPU`` (pane partials
before the leaf scatter, the JAX package's ``ffat_tpu.py`` step) and the
keyed ``Reduce_GPU`` (per-key partials, ``ops_tpu.py`` ``ReduceTPUReplica``).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def segmented_scan(combine: Callable, vals: Dict[str, torch.Tensor],
                   same_prev: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inclusive segmented scan of ``vals`` (a dict of equal-length
    columns): ``same_prev[i]`` says row ``i`` continues the segment of row
    ``i - 1``. Hillis-Steele log-step form of the JAX package's
    ``associative_scan``: the same operator with another grouping of the
    combines, so float sums may round differently. The combine always sees
    (earlier, later) partials; a field it does not return passes through
    from the later one. The inputs are not written."""
    n = same_prev.shape[0]
    s = same_prev
    d = 1
    while d < n:
        a = {k: v[:-d] for k, v in vals.items()}
        b = {k: v[d:] for k, v in vals.items()}
        sb = s[d:]
        merged = combine(a, b)
        vals = {k: torch.cat([v[:d], torch.where(sb, merged.get(k, b[k]),
                                                 b[k])])
                for k, v in vals.items()}
        s = torch.cat([s[:d], s[:-d] & sb])
        d *= 2
    return vals
