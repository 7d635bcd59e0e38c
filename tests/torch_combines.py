"""The combines the port's tests trace for K1, each with its ``jnp`` twin.

``make(name, xp)`` builds a FRESH combine (``xp`` is ``torch`` or
``jax.numpy``): the port caches a traced variant on the combine object,
and xdist workers share processes between files, so no test reuses
another's. ``DTYPES[name]``: its lift planes (field -> torch dtype).

- ``ysb_last``: ``count`` sums, ``last_ing`` keeps the right operand
  (``examples/ysb.py``);
- ``mean_last``: an int32 count ``n``, an int32 ``last`` from ``b`` and a
  float32 ``mean`` weighted by the counts: cross-field, int and float;
- ``argmax_ts``: the float32 ``v`` and int32 ``ts`` of the larger ``v``
  (``b`` only when strictly larger);
- ``flags``: a bool ``|`` beside an int32 sum;
- ``wide``: 12 int32 fields, sums and maxima by turns;
- ``scaled``: a division by a Python constant (torch's CUDA kernel
  multiplies by the reciprocal) and an int32 difference. It is not
  associative, so it is a kernel case only: a window's result would
  depend on how its scan groups the combine (``WINDOWED`` lists the
  others).
"""

import torch

I32, F32, BOOL = torch.int32, torch.float32, torch.bool
WIDE = 12

DTYPES = {
    "ysb_last": {"count": I32, "last_ing": I32},
    "mean_last": {"n": I32, "last": I32, "mean": F32},
    "argmax_ts": {"v": F32, "ts": I32},
    "flags": {"f": BOOL, "n": I32},
    "wide": {f"w{i}": I32 for i in range(WIDE)},
    "scaled": {"x": F32, "k": I32},
}
NAMES = list(DTYPES)
WINDOWED = [n for n in NAMES if n != "scaled"]
#: float fields whose value mixes a product into a sum (``mean_last``):
#: XLA's CPU backend may contract those into an FMA
CONTRACTED = {"mean_last": ("mean",)}


def make(name, xp):
    if name == "ysb_last":
        return lambda a, b: {"count": a["count"] + b["count"],
                             "last_ing": b["last_ing"]}
    if name == "mean_last":
        return lambda a, b: {
            "n": a["n"] + b["n"], "last": b["last"],
            "mean": (a["mean"] * a["n"] + b["mean"] * b["n"])
            / (a["n"] + b["n"])}
    if name == "argmax_ts":
        def argmax_ts(a, b):
            w = b["v"] > a["v"]
            return {"v": xp.where(w, b["v"], a["v"]),
                    "ts": xp.where(w, b["ts"], a["ts"])}
        return argmax_ts
    if name == "flags":
        return lambda a, b: {"f": a["f"] | b["f"], "n": a["n"] + b["n"]}
    if name == "wide":
        return lambda a, b: {
            f"w{i}": a[f"w{i}"] + b[f"w{i}"] if i % 2 == 0
            else xp.maximum(a[f"w{i}"], b[f"w{i}"]) for i in range(WIDE)}
    if name == "scaled":
        return lambda a, b: {"x": a["x"] / 3.0 + b["x"] * 0.5,
                             "k": a["k"] - b["k"] * 3}
    raise KeyError(name)


def every_op(a, b):
    """A torch-only combine using every operation the tracer takes."""
    x, y, i, j, p, q = a["x"], b["x"], a["i"], b["i"], a["p"], b["p"]
    cmp = ((x < y) | ~(i >= j)) & (p != q) | (x == y) | (i <= j) \
        & ~(x > 1.5) | (i != 3) & p
    z = torch.where(cmp, -x, abs(y)) - torch.minimum(x, y) \
        + torch.maximum(x, i) * 2 - 3 / (j + 0.5) + i / j
    k = torch.where(p & q, i - j, torch.abs(-j)) * 7 + (i > 0).to(I32) \
        + torch.where(q, 1, i) - y.to(torch.int32) + torch.add(i, j)
    return {"x": torch.where(p, z, torch.div(x, 4.0)),
            "i": torch.minimum(k, torch.maximum(i, j)) + p.int(),
            "p": torch.logical_or(cmp, q) & (k.float() < x) | (y > 0)}


EVERY_OP_DTYPES = {"x": F32, "i": I32, "p": BOOL}
