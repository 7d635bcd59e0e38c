"""Field-wise combines for the FFAT window operator.

``fieldwise(pq="sum", q="sum")`` returns a ``Fieldwise`` combine: called
on two dicts of tensors it is the torch combine the segmented scan, the
leaf scatter and the window query use, and its ``ops`` carry the
per-field op codes of the forest-rebuild kernel's fieldwise library
(``kernels/forest_rebuild.cu``, up to 8 int32 / float32 fields). Any
other torch combine works too, as the JAX package's ``jnp`` combines do:
on a card the kernel traces and compiles it (``kernels/combine_trace.py``),
and a ``Fieldwise`` over bool planes or more fields goes the same way.
"""

from __future__ import annotations

from typing import Dict

import torch

from .basic import WindFlowError

#: op name -> (kernel op code, torch function)
OPS = {
    "sum": (0, torch.add),
    "min": (1, torch.minimum),
    "max": (2, torch.maximum),
}


class Fieldwise:
    """Ordered per-field combine: ``{f: op(a[f], b[f])}`` (``a`` is the
    earlier side; sum/min/max are commutative, the order is kept anyway)."""

    def __init__(self, ops: Dict[str, str]) -> None:
        if not ops:
            raise WindFlowError("fieldwise: name at least one field")
        bad = {f: op for f, op in ops.items() if op not in OPS}
        if bad:
            raise WindFlowError(f"fieldwise: unknown ops {bad}; expected "
                                f"one of {sorted(OPS)}")
        self.ops = dict(ops)

    def __call__(self, a, b):
        return {f: OPS[op][1](a[f], b[f]) for f, op in self.ops.items()}

    def op_code(self, field: str) -> int:
        return OPS[self.ops[field]][0]

    def __repr__(self) -> str:  # pragma: no cover
        return "fieldwise(" + ", ".join(
            f"{f}={op!r}" for f, op in self.ops.items()) + ")"


def fieldwise(**ops: str) -> Fieldwise:
    """``fieldwise(value="sum")``: the combine of a sliding-window sum."""
    return Fieldwise(ops)
