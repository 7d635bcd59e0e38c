"""Tracing a torch combine, or a stateful step, into an expression graph
for the hand kernels.

The JAX package's Pallas kernel (``windflow_tpu/tpu/pallas_kernels.py``)
inlines the user's ``jnp`` combine into its body. The port does the same
for a torch combine: ``trace_combine`` calls it once on two dicts of
proxy values, records every operation as a node of a small graph
(``CombineIR``), and ``combine_codegen`` emits the graph as a C++ device
function that the kernel's regimes are instantiated with.

A proxy stands for one lift column of one side (``a[f]`` the lower node,
``b[f]`` the upper one). It takes the arithmetic operators and, through
``__torch_function__``, the torch functions below; every node has the
dtype torch would give its result, with torch's promotion of Python
scalars (an int32 column times a Python float is float32).

Taken: ``+ - *`` (int32 wraps as torch's does), true division ``/``,
unary ``-``, ``abs``, ``torch.minimum`` / ``torch.maximum`` (NaN
propagates), the comparisons, ``& | ~`` on bools, ``torch.where``,
``.to(torch.int32 | torch.float32 | torch.bool)`` (and ``.int()``,
``.float()``, ``.bool()``), Python int / float / bool constants, and a
field passed through unchanged (``b["last_ing"]``).

Refused with a ``WindFlowError`` naming the operation and the fields it
reads: any other torch function or method, ``bool()`` of a proxy (Python
control flow on values: JAX refuses it under tracing too), ``//`` and
``%``, a result torch would type int64 or float64, and an output that is
not a dict with exactly the lift's fields.

``CombineIR.evaluate`` runs the graph with torch ops on tensors: the tests
hold it against the combine called directly. No CUDA path calls it.

``trace_combine(..., opaque=True)`` also takes columns the kernel cannot
compute on (another dtype, trailing dimensions): each enters the trace as
an opaque value that may only pass through as ``b[f]``, recorded in
``CombineIR.passed``. ``trace_reduce`` traces a ``Reduce_GPU`` combine
that way (K6 and K7, ``reduce_fold.cuh``), after filling in every field
the combine does not return as ``b[f]``, as the plain version's
``merged.get(f, b[f])`` does; a field that only passes through leaves the
planes, and the kernel returns the source row the wrapper gathers it
from.

``trace_step`` does the same for the step of a stateful ``Map_GPU`` /
``Filter_GPU`` (``func(row, state) -> (row | keep, state)``), which K8's
kernel (``kernels/grid_scan.cuh``) runs with the step compiled in: its
``StepIR`` reads ``row[f]`` and the state's leaves and gives the computed
output columns (or the keep value) and the new state leaves. A step's
language is a combine's with two more operations: int32 ``//`` and
``%`` by a nonzero Python int constant, with torch's floor semantics
(``jnp``'s too). A row column with trailing dimensions (a composite key)
may only pass through unchanged; an output column that is a row column
unchanged (``{**row, ...}``) is recorded as a pass-through, which the
kernel never copies.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, FrozenSet, List, Mapping, Tuple

import torch

from ..basic import WindFlowError
from ..pytree import tree_flatten, tree_unflatten

I32, F32, BOOL = torch.int32, torch.float32, torch.bool
#: the dtypes a lift plane may have, in torch's promotion order
DTYPES = (BOOL, I32, F32)
_CAT = {BOOL: 0, I32: 1, F32: 2}
_NAMES = {BOOL: "bool", I32: "int32", F32: "float32"}

# node ops: "in" (value: (side, field)), "const" (value: the constant's
# 32-bit pattern; 0/1 for bool), "cast", the binary "add" "sub" "mul"
# "div" "min" "max" "and" "or" "lt" "le" "gt" "ge" "eq" "ne" (operands of
# one dtype), "divc" (division by a Python scalar; value: its float32
# bits), the unary "neg" "abs" "not" "recip", "where" (cond, x, y), and in
# a step "floordivc" / "modc" (int32 // and % by the Python int ``value``).
COMPARE = ("lt", "le", "gt", "ge", "eq", "ne")


@dataclass(frozen=True)
class Node:
    op: str
    dtype: torch.dtype
    args: Tuple[int, ...] = ()
    value: Any = None


def f32_bits(x: float) -> int:
    """The float32 bit pattern of ``x`` rounded to float32 (torch's cast
    of a Python float operand)."""
    return struct.unpack("<I", struct.pack("<f", x))[0]


def bits_f32(w: int) -> float:
    return struct.unpack("<f", struct.pack("<I", w))[0]


@dataclass(frozen=True)
class CombineIR:
    """One expression per lift field over ``a[f]``, ``b[f]`` and
    constants. ``dtypes``: the planes' dtypes, in the planes' order;
    ``outputs``: the node of each field's combined value (its dtype may
    differ from the plane's: the store then promotes as
    ``torch.where`` does and casts, like the plain version)."""
    fields: Tuple[str, ...]
    dtypes: Tuple[torch.dtype, ...]
    nodes: Tuple[Node, ...]
    outputs: Tuple[int, ...]
    #: columns that are no plane and pass through as ``b[f]`` (``opaque``
    #: traces and ``trace_reduce``); the generated code never sees them
    passed: Tuple[str, ...] = ()

    def text(self) -> str:
        """A canonical description (digests, messages)."""
        lines = [f"{f}:{_NAMES[d]}" for f, d in zip(self.fields, self.dtypes)]
        for i, n in enumerate(self.nodes):
            lines.append(f"t{i}={n.op}:{_NAMES[n.dtype]}{list(n.args)}"
                         f"{'' if n.value is None else repr(n.value)}")
        lines.append("out=" + ",".join(f"t{i}" for i in self.outputs))
        return "\n".join(lines)

    def evaluate(self, a: Mapping[str, torch.Tensor],
                 b: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The graph run with torch ops on ``a`` and ``b`` (tensors of one
        shape): the combine's result, field by field."""
        shape = a[self.fields[0]].shape
        dev = a[self.fields[0]].device
        val: List[torch.Tensor] = []
        for n in self.nodes:
            x = [val[i] for i in n.args]
            if n.op == "in":
                side, f = n.value
                v = (a if side == "a" else b)[f]
            elif n.op == "const":
                v = torch.tensor(_const_value(n), dtype=n.dtype, device=dev)
            else:
                v = _eval_node(n, x)
            val.append(v)
        return {f: val[i].expand(shape) if val[i].dim() == 0 else val[i]
                for f, i in zip(self.fields, self.outputs)}


def _eval_node(n: Node, x: List[torch.Tensor]) -> torch.Tensor:
    """One operation node on its operands' tensors (not "in" or "const")."""
    if n.op == "cast":
        return x[0].to(n.dtype)
    if n.op == "divc":
        return x[0] / bits_f32(n.value)
    if n.op == "floordivc":
        return torch.div(x[0], n.value, rounding_mode="floor")
    if n.op == "modc":
        return torch.remainder(x[0], n.value)
    return _EVAL[n.op](*x)


def _const_value(n: Node):
    if n.dtype is F32:
        return bits_f32(n.value)
    if n.dtype is BOOL:
        return bool(n.value)
    return n.value - (1 << 32) if n.value >= 1 << 31 else n.value


_EVAL: Dict[str, Callable] = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul, "div": torch.div,
    "min": torch.minimum, "max": torch.maximum,
    "and": torch.logical_and, "or": torch.logical_or,
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "eq": torch.eq, "ne": torch.ne,
    "neg": torch.neg, "abs": torch.abs, "not": torch.logical_not,
    "recip": torch.reciprocal, "where": torch.where,
}


# ---------------------------------------------------------------------------
class _Tracer:
    """``what``: the traced function's kind in messages; ``int_div``: a
    step's tracer takes int32 ``//`` and ``%`` by constants."""

    def __init__(self, what: str = "combine", int_div: bool = False) -> None:
        self.what = what
        self.int_div = int_div
        self.nodes: List[Node] = []
        self.reads: List[FrozenSet[str]] = []  # fields each node depends on
        self._index: Dict[Node, int] = {}

    def add(self, op: str, dtype: torch.dtype, args: Tuple[int, ...] = (),
            value: Any = None) -> int:
        node = Node(op, dtype, args, value)
        i = self._index.get(node)
        if i is None:
            i = self._index[node] = len(self.nodes)
            self.nodes.append(node)
            reads = frozenset().union(*(self.reads[j] for j in args)) \
                if args else frozenset()
            if op == "in":
                reads = frozenset([f"{value[0]}[{value[1]!r}]"])
            self.reads.append(reads)
        return i

    def const(self, x, dtype: torch.dtype) -> int:
        if dtype is F32:
            return self.add("const", F32, value=f32_bits(float(x)))
        if dtype is BOOL:
            return self.add("const", BOOL, value=int(bool(x)))
        x = int(x)
        if not -2**31 <= x < 2**31:
            raise WindFlowError(f"combine: the constant {x} does not fit "
                                "an int32 operand")
        return self.add("const", I32, value=x & 0xFFFFFFFF)

    def cast(self, i: int, dtype: torch.dtype) -> int:
        n = self.nodes[i]
        if n.dtype is dtype:
            return i
        if n.op == "const":  # fold: torch casts a constant operand first
            return self.const(_const_value(n), dtype)
        return self.add("cast", dtype, (i,))


def _refuse(what: str, *operands) -> WindFlowError:
    proxies = [o for o in operands if isinstance(o, _Proxy)]
    reads = sorted(set().union(*(o._tr.reads[o._id] for o in proxies)))
    on = f" on {', '.join(reads)}" if reads else ""
    kind = proxies[0]._tr.what if proxies else "combine"
    return WindFlowError(f"{kind}: {what} is not supported in a {kind} "
                         f"the CUDA kernel traces{on}")


def _scalar_cat(x) -> int:
    if isinstance(x, bool):
        return 0
    if isinstance(x, int):
        return 1
    if isinstance(x, float):
        return 2
    return -1


def _promote(op: str, *xs) -> torch.dtype:
    """torch's result dtype of ``xs`` (proxies and Python scalars)."""
    tcat, scat = -1, -1
    for x in xs:
        if isinstance(x, _Proxy):
            tcat = max(tcat, _CAT[x.dtype])
        elif isinstance(x, _Opaque):
            raise x.refusal(op)
        else:
            c = _scalar_cat(x)
            if c < 0:
                raise _refuse(f"{op} with an operand of type "
                              f"{type(x).__name__}", *xs)
            scat = max(scat, c)
    if scat <= tcat:
        return DTYPES[tcat]
    if scat == 2:
        if torch.get_default_dtype() is not torch.float32:
            raise _refuse(f"{op} under the default dtype "
                          f"{torch.get_default_dtype()}", *xs)
        return F32
    if scat == 1:
        raise _refuse(f"{op} giving int64 (an int constant with bool "
                      "operands; cast with .to(torch.int32))", *xs)
    return BOOL


def _operand(tr: _Tracer, x, dtype: torch.dtype) -> int:
    if isinstance(x, _Proxy):
        return tr.cast(x._id, dtype)
    return tr.const(x, dtype)


def _first_proxy(xs) -> "_Proxy":
    for x in xs:
        if isinstance(x, _Proxy):
            return x
    raise WindFlowError("combine: an operation on constants only")


def _binary(op: str, x, y) -> "_Proxy":
    tr = _first_proxy((x, y))._tr
    what = {"add": "+", "sub": "-", "mul": "*", "and": "&",
            "or": "|"}.get(op, op)
    dt = _promote(what, x, y)
    if op in ("and", "or") and dt is not BOOL:
        raise _refuse(f"{what} on {_NAMES[dt]} (bools only)", x, y)
    if dt is BOOL:
        if op == "sub":
            raise _refuse("- on bools", x, y)
        op = {"add": "or", "mul": "and", "min": "and",
              "max": "or"}.get(op, op)
    args = (_operand(tr, x, dt), _operand(tr, y, dt))
    res = BOOL if op in COMPARE else dt
    return _Proxy(tr, tr.add(op, res, args))


def _div(x, y) -> "_Proxy":
    tr = _first_proxy((x, y))._tr
    for v in (x, y):
        if isinstance(v, _Opaque):
            raise v.refusal("/")
        if not isinstance(v, _Proxy) and _scalar_cat(v) < 0:
            raise _refuse(f"/ with an operand of type {type(v).__name__}",
                          x, y)
    if not isinstance(y, _Proxy):
        # torch's CUDA true division by a CPU scalar multiplies by the
        # scalar's float32 reciprocal; the code generator follows it
        return _Proxy(tr, tr.add("divc", F32, (_operand(tr, x, F32),),
                                 f32_bits(float(y))))
    return _Proxy(tr, tr.add("div", F32, (_operand(tr, x, F32),
                                          _operand(tr, y, F32))))


def _int_div(op: str, x, y) -> "_Proxy":
    """A step's ``x // c`` or ``x % c``: int32 ``x``, a nonzero Python int
    ``c`` (torch's floor semantics: the remainder takes ``c``'s sign)."""
    sym = "//" if op == "floordivc" else "%"
    if not isinstance(x, _Proxy):
        if isinstance(x, _Opaque):
            raise x.refusal(sym)
        raise _refuse(f"{sym} by a traced value (only by a nonzero Python "
                      "int constant)", y)
    if not x._tr.int_div:
        raise _refuse(sym, x, y)
    if isinstance(y, _Proxy):
        raise _refuse(f"{sym} by a traced value (only by a nonzero Python "
                      "int constant)", x, y)
    if isinstance(y, bool) or not isinstance(y, int) or y == 0 \
            or not -2**31 <= y < 2**31:
        raise _refuse(f"{sym} by {y!r} (only by a nonzero Python int "
                      "constant within int32)", x)
    if x.dtype is not I32:
        raise _refuse(f"{sym} on {_NAMES[x.dtype]} (int32 only)", x)
    return _Proxy(x._tr, x._tr.add(op, I32, (x._id,), y))


def _unary(op: str, x: "_Proxy") -> "_Proxy":
    tr = x._tr
    if op == "not":
        if x.dtype is not BOOL:
            raise _refuse(f"~ on {_NAMES[x.dtype]} (bools only)", x)
        return _Proxy(tr, tr.add("not", BOOL, (x._id,)))
    if op == "recip":
        return _Proxy(tr, tr.add("recip", F32, (tr.cast(x._id, F32),)))
    if x.dtype is BOOL:
        raise _refuse(f"{'unary -' if op == 'neg' else 'abs'} on bools", x)
    return _Proxy(tr, tr.add(op, x.dtype, (x._id,)))


def _where(cond, x, y) -> "_Proxy":
    if not isinstance(cond, _Proxy) or cond.dtype is not BOOL:
        raise _refuse("torch.where with a condition that is not a bool "
                      "column", cond, x, y)
    tr = cond._tr
    if isinstance(x, _Proxy) or isinstance(y, _Proxy):
        dt = _promote("torch.where", x, y)
    else:  # two constants: torch types them as it types Python scalars
        cats = (_scalar_cat(x), _scalar_cat(y))
        if min(cats) < 0:
            raise _refuse("torch.where with a non-numeric operand", cond)
        if max(cats) == 1:
            raise _refuse("torch.where of two int constants (int64)", cond)
        dt = F32 if max(cats) == 2 else BOOL
    return _Proxy(tr, tr.add("where", dt, (cond._id, _operand(tr, x, dt),
                                           _operand(tr, y, dt))))


def _cast(x: "_Proxy", dtype) -> "_Proxy":
    if dtype not in _CAT:
        raise _refuse(f".to({dtype})", x)
    return _Proxy(x._tr, x._tr.cast(x._id, dtype))


_BINARY_FNS = {
    torch.add: "add", torch.sub: "sub", torch.subtract: "sub",
    torch.mul: "mul", torch.multiply: "mul",
    torch.minimum: "min", torch.maximum: "max",
    torch.lt: "lt", torch.less: "lt", torch.le: "le",
    torch.less_equal: "le", torch.gt: "gt", torch.greater: "gt",
    torch.ge: "ge", torch.greater_equal: "ge", torch.eq: "eq",
    torch.ne: "ne", torch.not_equal: "ne",
    torch.logical_and: "and", torch.logical_or: "or",
    torch.bitwise_and: "and", torch.bitwise_or: "or",
}
_UNARY_FNS = {torch.neg: "neg", torch.negative: "neg", torch.abs: "abs",
              torch.absolute: "abs", torch.logical_not: "not",
              torch.bitwise_not: "not", torch.reciprocal: "recip"}
_DIV_FNS = (torch.div, torch.divide, torch.true_divide)
_INT_DIV_FNS = {torch.floor_divide: "floordivc", torch.remainder: "modc"}


def _fn_name(func) -> str:
    name = getattr(func, "__name__", repr(func))
    mod = getattr(func, "__module__", "") or ""
    return f"torch.{name}" if mod.startswith("torch") else name


class _Proxy:
    """One traced column: the node ``_id`` of the tracer ``_tr``."""

    __slots__ = ("_tr", "_id")
    __array_ufunc__ = None  # numpy ufuncs refuse it instead of iterating

    def __init__(self, tr: _Tracer, i: int) -> None:
        self._tr = tr
        self._id = i

    @property
    def dtype(self) -> torch.dtype:
        return self._tr.nodes[self._id].dtype

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _BINARY_FNS and len(args) == 2:
            if kwargs.get("alpha", 1) != 1 or set(kwargs) - {"alpha"}:
                raise _refuse(f"{_fn_name(func)} with {sorted(kwargs)}",
                              *args)
            return _binary(_BINARY_FNS[func], *args)
        if func in _UNARY_FNS and len(args) == 1 and not kwargs:
            return _unary(_UNARY_FNS[func], args[0])
        if func in _DIV_FNS and len(args) == 2 \
                and kwargs.get("rounding_mode") is None:
            return _div(*args)
        if func is torch.where and len(args) == 3 and not kwargs:
            return _where(*args)
        if func in _INT_DIV_FNS and len(args) == 2 and not kwargs:
            return _int_div(_INT_DIV_FNS[func], *args)
        raise _refuse(_fn_name(func), *args, *kwargs.values())

    # arithmetic
    def __add__(self, o): return _binary("add", self, o)
    def __radd__(self, o): return _binary("add", o, self)
    def __sub__(self, o): return _binary("sub", self, o)
    def __rsub__(self, o): return _binary("sub", o, self)
    def __mul__(self, o): return _binary("mul", self, o)
    def __rmul__(self, o): return _binary("mul", o, self)
    def __truediv__(self, o): return _div(self, o)
    # torch: ``c / t`` is ``t.reciprocal() * c``
    def __rtruediv__(self, o): return _binary("mul", _unary("recip", self), o)
    def __neg__(self): return _unary("neg", self)
    def __abs__(self): return _unary("abs", self)
    def __pos__(self): return self
    # comparisons
    def __lt__(self, o): return _binary("lt", self, o)
    def __le__(self, o): return _binary("le", self, o)
    def __gt__(self, o): return _binary("gt", self, o)
    def __ge__(self, o): return _binary("ge", self, o)
    def __eq__(self, o): return _binary("eq", self, o)  # type: ignore
    def __ne__(self, o): return _binary("ne", self, o)  # type: ignore
    __hash__ = object.__hash__
    # bools
    def __and__(self, o): return _binary("and", self, o)
    def __rand__(self, o): return _binary("and", o, self)
    def __or__(self, o): return _binary("or", self, o)
    def __ror__(self, o): return _binary("or", o, self)
    def __invert__(self): return _unary("not", self)
    # casts and a few methods
    def to(self, dtype=None, **kw):
        if kw.keys() - {"dtype"} or (dtype is None) == ("dtype" not in kw):
            raise _refuse(f".to({dtype!r}, {kw})", self)
        return _cast(self, kw.get("dtype", dtype))
    def int(self): return _cast(self, I32)
    def float(self): return _cast(self, F32)
    def bool(self): return _cast(self, BOOL)
    def abs(self): return _unary("abs", self)

    # refused
    def _no(self, what):
        raise _refuse(what, self)
    def __bool__(self): self._no("bool() of a traced value (Python control "
                                 "flow on values)")
    def __int__(self): self._no("int() of a traced value")
    def __float__(self): self._no("float() of a traced value")
    def __index__(self): self._no("a traced value as an index")
    def __len__(self): self._no("len() of a traced value")
    def __iter__(self): self._no("iterating a traced value")
    def __getitem__(self, k): self._no("indexing a traced value")
    def __floordiv__(self, o): return _int_div("floordivc", self, o)
    def __rfloordiv__(self, o): return _int_div("floordivc", o, self)
    def __mod__(self, o): return _int_div("modc", self, o)
    def __rmod__(self, o): return _int_div("modc", o, self)
    def __pow__(self, o): self._no("**")
    def __rpow__(self, o): self._no("**")
    def __xor__(self, o): self._no("^")
    def __rxor__(self, o): self._no("^")
    def __lshift__(self, o): self._no("<<")
    def __rshift__(self, o): self._no(">>")
    def __matmul__(self, o): self._no("@")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise _refuse(f"the method .{name}()", self)


class _Side(dict):
    """``a`` or ``b``: one proxy per lift field (``opaque``: one
    ``_Opaque`` per column the kernel cannot compute on, field -> why)."""

    def __init__(self, tr: _Tracer, side: str, dtypes, opaque=None) -> None:
        super().__init__({f: _Proxy(tr, tr.add("in", dt, value=(side, f)))
                          for f, dt in dtypes.items()})
        for f, why in (opaque or {}).items():
            self[f] = _Opaque(f, why, side)
        self.side = side

    def __missing__(self, key):
        raise WindFlowError(f"combine: reads {self.side}[{key!r}], which "
                            f"the lift does not produce (fields "
                            f"{sorted(self)})")


def _column_kind(d) -> Tuple[Any, Any]:
    """``(dtype, why)`` of a column given as a dtype or ``(dtype, trailing
    shape)``: ``why`` is None for a plane the kernel computes on."""
    dt, trail = d if isinstance(d, tuple) else (d, ())
    if trail:
        return dt, f"trailing dimensions {tuple(trail)}"
    return dt, None if dt in _CAT else f"dtype {dt}"


def trace_combine(combine: Callable, dtypes: Mapping[str, Any],
                  opaque: bool = False) -> CombineIR:
    """Trace ``combine(a, b)`` over lift planes of ``dtypes`` (field ->
    torch.int32 / torch.float32 / torch.bool) into a ``CombineIR``, or
    raise ``WindFlowError`` naming what the kernel cannot take. With
    ``opaque``, a field may also be another dtype or ``(dtype, trailing
    shape)``: it enters as an opaque value, and its output must be
    ``b[f]`` unchanged (``CombineIR.passed``)."""
    kinds = {f: _column_kind(d) for f, d in dtypes.items()}
    bad = {f: dt for f, (dt, why) in kinds.items() if why is not None}
    if (bad and not opaque) or not dtypes:
        raise WindFlowError(f"combine: lift planes must be int32, float32 "
                            f"or bool, got {bad or 'no fields'}")
    planes = {f: dt for f, (dt, why) in kinds.items() if why is None}
    dark = {f: why for f, (_, why) in kinds.items() if why is not None}
    tr = _Tracer()
    a, b = _Side(tr, "a", planes, dark), _Side(tr, "b", planes, dark)
    try:
        out = combine(a, b)
    except WindFlowError:
        raise
    except Exception as e:  # the user's code failed on proxies
        raise WindFlowError(f"combine: cannot be traced for the CUDA kernel "
                            f"({type(e).__name__}: {e})") from e
    if not isinstance(out, dict):
        raise WindFlowError(f"combine: must return a dict of fields, "
                            f"returned {type(out).__name__}")
    missing = [f for f in dtypes if f not in out]
    extra = [f for f in out if f not in dtypes]
    if missing or extra:
        what = " and ".join(w for w in (missing and f"lacks {missing}",
                                        extra and f"adds {extra}") if w)
        raise WindFlowError(f"combine: its output {what} against the "
                            f"lift's fields {list(dtypes)}")
    outputs, passed = [], []
    for f in dtypes:
        v = out[f]
        if f in dark:
            if v is not b[f]:
                raise (v.refusal(f"field {f!r} as the output of a "
                                 "combine")
                       if isinstance(v, _Opaque) else b[f].refusal(
                           f"a computed value for field {f!r}"))
            passed.append(f)
        elif isinstance(v, _Proxy):
            if v._tr is not tr:
                raise WindFlowError(f"combine: field {f!r} comes from "
                                    "another trace")
            outputs.append(v._id)
        elif isinstance(v, _Opaque):
            raise v.refusal(f"field {f!r} as the output of a combine")
        elif _scalar_cat(v) >= 0:
            # a constant: typed as torch.where types it against the plane
            outputs.append(tr.const(v, _promote(f"the constant {f!r}",
                                                a[f], v)))
        else:
            raise WindFlowError(f"combine: field {f!r} is a "
                                f"{type(v).__name__}, not a traced value")
    return CombineIR(tuple(planes), tuple(planes.values()), tuple(tr.nodes),
                     tuple(outputs), tuple(passed))


def _reachable(nodes, roots) -> List[int]:
    """The nodes ``roots`` depend on, in graph order."""
    seen = set()
    stack = list(roots)
    while stack:
        i = stack.pop()
        if i not in seen:
            seen.add(i)
            stack.extend(nodes[i].args)
    return sorted(seen)


def trace_reduce(combine: Callable, columns: Mapping[str, Any]) -> CombineIR:
    """Trace a ``Reduce_GPU`` combine over the batch's ``columns`` (field
    -> dtype, or ``(dtype, trailing shape)``) for K6 and K7. Every field
    the combine does not return is filled in as ``b[f]`` (extra fields
    are dropped, as the plain version drops them); a column of another
    dtype or shape is opaque and must pass through. The planes are the
    fields the combine computes and the fields those read; every other
    column is ``passed`` (taken from the source row the kernel returns).
    A combine that computes nothing keeps its first plane column as a
    plane (its output ``b[f]``); with none, it is refused."""
    names = list(columns)

    def filled(a, b):
        out = combine(a, b)
        if not isinstance(out, dict):
            return out
        return {f: out[f] if f in out else b[f] for f in names}

    ir = trace_combine(filled, columns, opaque=True)
    own = {f: i for f, i in zip(ir.fields, ir.outputs)}
    computed = [f for f in ir.fields
                if ir.nodes[own[f]] != Node("in", ir.dtypes[ir.fields.index(
                    f)], (), ("b", f))]
    read = {ir.nodes[i].value[1]
            for i in _reachable(ir.nodes, [own[f] for f in computed])
            if ir.nodes[i].op == "in"}
    keep = [f for f in ir.fields if f in computed or f in read]
    if not keep:
        if not ir.fields:
            raise WindFlowError(
                "combine: no column is int32, float32 or bool, so the CUDA "
                f"kernel has no plane to fold (columns {names})")
        keep = [ir.fields[0]]
    live = _reachable(ir.nodes, [own[f] for f in keep])
    at = {i: k for k, i in enumerate(live)}
    nodes = tuple(Node(n.op, n.dtype, tuple(at[j] for j in n.args), n.value)
                  for n in (ir.nodes[i] for i in live))
    dt = dict(zip(ir.fields, ir.dtypes))
    return CombineIR(tuple(keep), tuple(dt[f] for f in keep), nodes,
                     tuple(at[own[f]] for f in keep),
                     tuple(f for f in names if f not in keep))


# ---------------------------------------------------------------------------
# stateful steps (K8)
# ---------------------------------------------------------------------------
class _Opaque:
    """A column the kernel cannot compute on (trailing dimensions, or a
    dtype other than int32 / float32 / bool): a step's ``row[f]``, or a
    combine's ``a[f]`` / ``b[f]`` (``side``). It may only pass through
    unchanged. Every operation on it is refused."""

    __slots__ = ("field", "why", "side")
    __array_ufunc__ = None

    def __init__(self, field: str, why: str, side: str = "row") -> None:
        self.field = field
        self.why = why
        self.side = side

    def refusal(self, what: str) -> WindFlowError:
        kind = "step" if self.side == "row" else "combine"
        keep = ("unchanged" if kind == "step"
                else f"unchanged, as b[{self.field!r}]")
        return WindFlowError(
            f"{kind}: {what} on {self.side}[{self.field!r}] ({self.why}) is "
            f"not supported in a {kind} the CUDA kernel traces: a computed "
            "column with trailing dimensions or of another dtype; such a "
            f"column may only pass through {keep}")

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        for a in (*args, *(kwargs or {}).values()):
            if isinstance(a, _Opaque):
                raise a.refusal(_fn_name(func))
        raise WindFlowError(f"{_fn_name(func)} cannot be traced")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        raise self.refusal(f"the method .{name}()")

    def __bool__(self):
        raise self.refusal("bool()")


def _opaque_op(sym: str):
    def op(self, *_):
        raise self.refusal(sym)
    return op


for _name, _sym in (("add", "+"), ("radd", "+"), ("sub", "-"), ("rsub", "-"),
                    ("mul", "*"), ("rmul", "*"), ("truediv", "/"),
                    ("rtruediv", "/"), ("floordiv", "//"),
                    ("rfloordiv", "//"), ("mod", "%"), ("rmod", "%"),
                    ("pow", "**"), ("rpow", "**"), ("neg", "unary -"),
                    ("abs", "abs"), ("invert", "~"), ("lt", "<"),
                    ("le", "<="), ("gt", ">"), ("ge", ">="), ("eq", "=="),
                    ("ne", "!="), ("and", "&"), ("rand", "&"), ("or", "|"),
                    ("ror", "|"), ("xor", "^"), ("getitem", "indexing"),
                    ("matmul", "@")):
    setattr(_Opaque, f"__{_name}__", _opaque_op(_sym))
_Opaque.__hash__ = object.__hash__


class _Row(dict):
    """The step's ``row``: one proxy per traceable column, an ``_Opaque``
    for the others."""

    def __missing__(self, key):
        raise WindFlowError(f"step: reads row[{key!r}], which the batch "
                            f"does not carry (columns {sorted(self)})")


@dataclass(frozen=True)
class StepIR:
    """A traced step. ``row``: the batch's traceable columns (name,
    dtype), the "in" nodes ``("row", name)``; ``state``: the state
    leaves' dtypes in ``tree_flatten`` order, the "in" nodes ``("state",
    i)``. ``outputs``: the computed output columns ``(name, node)`` (in
    filter mode one, ``("keep", node)``); ``passed``: the pass-through
    columns ``(name, row column)``; ``names``: map mode's output columns
    in the function's order. ``new_state``: the node of each new leaf (the
    kernel casts it to the leaf's dtype, as the plain version's ``where``
    does). ``spec``: the state's tree structure."""
    row: Tuple[Tuple[str, torch.dtype], ...]
    state: Tuple[torch.dtype, ...]
    filter_mode: bool
    nodes: Tuple[Node, ...]
    outputs: Tuple[Tuple[str, int], ...]
    passed: Tuple[Tuple[str, str], ...]
    names: Tuple[str, ...]
    new_state: Tuple[int, ...]
    spec: Any = field(compare=False, repr=False)

    def text(self) -> str:
        """A canonical description (digests, messages)."""
        lines = [f"{'filter' if self.filter_mode else 'map'}"]
        lines += [f"row {f}:{_NAMES[d]}" for f, d in self.row]
        lines += [f"state {i}:{_NAMES[d]}" for i, d in enumerate(self.state)]
        for i, n in enumerate(self.nodes):
            lines.append(f"t{i}={n.op}:{_NAMES[n.dtype]}{list(n.args)}"
                         f"{'' if n.value is None else repr(n.value)}")
        lines.append("out=" + ",".join(f"{f}:t{i}" for f, i in self.outputs))
        lines.append("pass=" + ",".join(f"{f}:{g}" for f, g in self.passed))
        lines.append("names=" + ",".join(self.names))
        lines.append("state=" + ",".join(f"t{i}" for i in self.new_state))
        return "\n".join(lines)

    def evaluate(self, row: Mapping[str, torch.Tensor], state) -> tuple:
        """The graph run with torch ops on the tensors of ``row`` and the
        pytree ``state`` (one shape): ``(out, new_state)`` as the step
        returns them, before the cast of the new leaves to the table's
        dtypes (``out`` a dict of columns, pass-throughs the row's own
        tensors, or in filter mode the keep value)."""
        leaves = tree_flatten(state)[0]
        ref = leaves[0]
        val: List[torch.Tensor] = []
        for n in self.nodes:
            x = [val[i] for i in n.args]
            if n.op == "in":
                src, key = n.value
                v = row[key] if src == "row" else leaves[key]
            elif n.op == "const":
                v = torch.tensor(_const_value(n), dtype=n.dtype,
                                 device=ref.device)
            else:
                v = _eval_node(n, x)
            val.append(v)

        def full(i):
            return val[i].expand(ref.shape) if val[i].dim() == 0 else val[i]

        new = tree_unflatten(self.spec, [full(i) for i in self.new_state])
        if self.filter_mode:
            return full(self.outputs[0][1]), new
        computed = {f: full(i) for f, i in self.outputs}
        passed = dict(self.passed)
        return {f: (row[passed[f]] if f in passed else computed[f])
                for f in self.names}, new


def _leaf_dtype(v) -> torch.dtype:
    """A state leaf's dtype in the JAX package's x64-off dtypes."""
    dt = v.dtype if isinstance(v, torch.Tensor) else torch.as_tensor(v).dtype
    return {torch.int64: I32, torch.float64: F32}.get(dt, dt)


def _step_node(tr: _Tracer, v, what: str) -> int:
    if isinstance(v, _Proxy):
        if v._tr is not tr:
            raise WindFlowError(f"step: {what} comes from another trace")
        return v._id
    if isinstance(v, _Opaque):
        raise v.refusal(what)
    raise WindFlowError(f"step: {what} is a {type(v).__name__}, not a "
                        "traced value (the step must return tensors)")


def trace_step(func: Callable, row_dtypes: Mapping[str, Any], state_init,
               filter_mode: bool) -> StepIR:
    """Trace ``func(row, state) -> (out | keep, state)`` into a
    ``StepIR``, or raise ``WindFlowError`` naming what the kernel cannot
    take. ``row_dtypes``: column -> dtype, or (dtype, trailing shape) for
    a column with trailing dimensions; ``state_init``: a pytree whose
    leaves (scalars or tensors) give the state's dtypes."""
    tr = _Tracer("step", int_div=True)
    row = _Row()
    traced = []
    for f, d in row_dtypes.items():
        dt, trail = d if isinstance(d, tuple) else (d, ())
        if trail or dt not in _CAT:
            why = (f"trailing dimensions {tuple(trail)}" if trail
                   else f"dtype {dt}")
            row[f] = _Opaque(f, why)
        else:
            row[f] = _Proxy(tr, tr.add("in", dt, value=("row", f)))
            traced.append((f, dt))
    leaves, spec = tree_flatten(state_init)
    if not leaves:
        raise WindFlowError("step: the state has no leaves")
    sdt = tuple(_leaf_dtype(v) for v in leaves)
    bad = [str(d) for d in sdt if d not in _CAT]
    if bad:
        raise WindFlowError(f"step: state leaves must be int32, float32 or "
                            f"bool, got {bad}")
    state = tree_unflatten(spec, [
        _Proxy(tr, tr.add("in", d, value=("state", i)))
        for i, d in enumerate(sdt)])
    kind = "Filter_GPU predicate" if filter_mode else "Map_GPU function"
    try:
        res = func(row, state)
    except WindFlowError:
        raise
    except Exception as e:  # the user's code failed on proxies
        raise WindFlowError(f"step: cannot be traced for the CUDA kernel "
                            f"({type(e).__name__}: {e})") from e
    if not isinstance(res, tuple) or len(res) != 2:
        raise WindFlowError(f"step: a stateful {kind} must return "
                            "(output, state)")
    out, new = res
    new_leaves = tree_flatten(new)[0]
    if len(new_leaves) != len(leaves):
        raise WindFlowError(f"step: the new state has {len(new_leaves)} "
                            f"leaves, the state {len(leaves)}")
    new_ids = tuple(_step_node(tr, v, f"new state leaf {i}")
                    for i, v in enumerate(new_leaves))
    outputs, passed, names = [], [], ()
    if filter_mode:
        outputs.append(("keep", _step_node(tr, out, "the keep value")))
    else:
        if not isinstance(out, dict):
            raise WindFlowError("step: stateful Map_GPU function must "
                                "return (dict of columns, state)")
        names = tuple(out)
        for f, v in out.items():
            if isinstance(v, _Opaque):
                passed.append((f, v.field))
                continue
            i = _step_node(tr, v, f"output column {f!r}")
            n = tr.nodes[i]
            if n.op == "in" and n.value[0] == "row":
                passed.append((f, n.value[1]))
            else:
                outputs.append((f, i))
    return StepIR(tuple(traced), sdt, filter_mode, tuple(tr.nodes),
                  tuple(outputs), tuple(passed), names, new_ids, spec)
