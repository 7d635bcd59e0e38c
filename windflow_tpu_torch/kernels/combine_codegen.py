"""C++ code for a traced combine (``combine_trace.CombineIR``).

``combine_source(ir)`` emits a ``struct WfgCombine``, the combine policy
that ``forest_rebuild.cuh`` instantiates K1's regimes with:

- ``apply(l, r, o)``: the traced combine over the 32-bit words of every
  field of the left (lower) and right child at once, each output in its
  own result dtype;
- ``node(l, r, vl, vr, o)``: one FlatFAT node, as the plain version
  writes it: ``where(vl & vr, merged, where(vl, l, r))`` in the dtype
  ``torch.where`` promotes to, cast to the plane's dtype;
- ``NF``, ``WORDS`` (every plane 32-bit: the warp and cta regimes run
  only then), ``bytes(f)`` (4, or 1 for a bool plane) and
  ``CTA_MIN_BLOCKS``.

Float arithmetic is ``__fadd_rn`` / ``__fsub_rn`` / ``__fmul_rn`` /
``__fdiv_rn`` on the card (with ``--fmad=false`` nothing is contracted:
torch's eager ops never are), and a division by a Python scalar is a
product with the scalar's float32 reciprocal there, as torch's CUDA true
division by a CPU scalar computes it. min and max propagate NaN as
torch's CUDA ``minimum`` / ``maximum`` do. Outside ``__CUDA_ARCH__`` the
same text compiles with ``g++ -ffp-contract=off`` and computes what
torch's CPU ops compute (plain operators; ``x / c`` divides): the CPU
tests compile and run it.

``kernel_source(ir)`` is the translation unit ``build.load_generated``
compiles: the headers, the policy and its C entry points, K1's, the
FFAT step's (``ffat_step.cuh``: K2+K3 and K4) and the reduce folds'
(``reduce_fold.cuh``: K7 and K6), so one variant is one library.

``step_source(ir)`` emits a traced stateful step (``combine_trace.StepIR``)
as ``struct WfgStep``, the step policy of K8's kernel (``grid_scan.cuh``):
``step(r, s, o)`` from the words of one row's read columns and of the
state to the computed output columns (or the keep byte) and the new state
(each new leaf cast to its table dtype, as the plain version's ``where``
does), with the same arithmetic as a combine; ``step_kernel_source(ir)``
is its translation unit, K8's kernel and C entry points over it.
"""

from __future__ import annotations

import hashlib
from typing import Callable, List, Sequence

import numpy as np
import torch

from .combine_trace import (BOOL, COMPARE, F32, I32, CombineIR, Node,
                            StepIR, f32_bits)

STRUCT = "WfgCombine"
STEP_STRUCT = "WfgStep"
MASK32 = 0xFFFFFFFF
_CTYPE = {I32: "int32_t", F32: "float", BOOL: "bool"}
_CAT = {BOOL: 0, I32: 1, F32: 2}

PRELUDE = r"""#ifndef WFG_PRELUDE
#define WFG_PRELUDE
#include <math.h>
#include <stdint.h>
#include <string.h>
#if defined(__CUDACC__)
#define WFG_HDC __host__ __device__
#define WFG_HD __host__ __device__ __forceinline__
#else
#define WFG_HDC
#define WFG_HD inline
#endif
#if defined(__CUDA_ARCH__)
#define WFG_FADD(x, y) __fadd_rn(x, y)
#define WFG_FSUB(x, y) __fsub_rn(x, y)
#define WFG_FMUL(x, y) __fmul_rn(x, y)
#define WFG_FDIV(x, y) __fdiv_rn(x, y)
/* torch's CUDA true division by a CPU scalar: x * (1 / c) in float32 */
#define WFG_FDIVC(x, c, inv) __fmul_rn(x, inv)
#else
#define WFG_FADD(x, y) ((x) + (y))
#define WFG_FSUB(x, y) ((x) - (y))
#define WFG_FMUL(x, y) ((x) * (y))
#define WFG_FDIV(x, y) ((x) / (y))
#define WFG_FDIVC(x, c, inv) ((x) / (c))
#endif
WFG_HD float wfg_f32(uint32_t w) {
#if defined(__CUDA_ARCH__)
    return __uint_as_float(w);
#else
    float f;
    memcpy(&f, &w, 4);
    return f;
#endif
}
WFG_HD uint32_t wfg_u32(float f) {
#if defined(__CUDA_ARCH__)
    return __float_as_uint(f);
#else
    uint32_t w;
    memcpy(&w, &f, 4);
    return w;
#endif
}
/* torch.minimum / torch.maximum: a NaN operand is the result */
WFG_HD float wfg_fmin(float x, float y) {
    return x != x ? x : y != y ? y : fminf(x, y);
}
WFG_HD float wfg_fmax(float x, float y) {
    return x != x ? x : y != y ? y : fmaxf(x, y);
}
/* int32 arithmetic wraps, as torch's does */
WFG_HD int32_t wfg_iadd(int32_t x, int32_t y) {
    return (int32_t)((uint32_t)x + (uint32_t)y);
}
WFG_HD int32_t wfg_isub(int32_t x, int32_t y) {
    return (int32_t)((uint32_t)x - (uint32_t)y);
}
WFG_HD int32_t wfg_imul(int32_t x, int32_t y) {
    return (int32_t)((uint32_t)x * (uint32_t)y);
}
WFG_HD int32_t wfg_ineg(int32_t x) { return (int32_t)(0u - (uint32_t)x); }
WFG_HD int32_t wfg_iabs(int32_t x) { return x < 0 ? wfg_ineg(x) : x; }
/* torch's int32 // and % by a nonzero constant: floor semantics (the
   remainder takes the divisor's sign); INT_MIN // -1 wraps */
WFG_HD int32_t wfg_ifloordivc(int32_t x, int32_t c) {
    if (c == -1) return wfg_ineg(x);
    const int32_t q = x / c;
    return (x % c != 0 && ((x < 0) != (c < 0))) ? q - 1 : q;
}
WFG_HD int32_t wfg_imodc(int32_t x, int32_t c) {
    if (c == -1) return 0;
    const int32_t r = x % c;
    return (r != 0 && ((r < 0) != (c < 0))) ? r + c : r;
}
#endif
"""

_BINARY = {
    I32: {"add": "wfg_iadd({}, {})", "sub": "wfg_isub({}, {})",
          "mul": "wfg_imul({}, {})", "min": "({0} < {1} ? {0} : {1})",
          "max": "({0} > {1} ? {0} : {1})"},
    F32: {"add": "WFG_FADD({}, {})", "sub": "WFG_FSUB({}, {})",
          "mul": "WFG_FMUL({}, {})", "div": "WFG_FDIV({}, {})",
          "min": "wfg_fmin({}, {})", "max": "wfg_fmax({}, {})"},
    BOOL: {"and": "({} && {})", "or": "({} || {})"},
}
_CMP = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}


def word_to(dt: torch.dtype, w: str) -> str:
    """A plane word as a C++ value of ``dt``."""
    return {I32: f"(int32_t){w}", F32: f"wfg_f32({w})",
            BOOL: f"({w} != 0u)"}[dt]


def to_word(dt: torch.dtype, x: str) -> str:
    return {I32: f"(uint32_t){x}", F32: f"wfg_u32({x})",
            BOOL: f"({x} ? 1u : 0u)"}[dt]


def convert(src: torch.dtype, dst: torch.dtype, x: str) -> str:
    """torch's cast: to bool is ``!= 0``; float to int32 truncates (the
    card's conversion saturates, as torch's CUDA cast does)."""
    if src is dst:
        return x
    if dst is BOOL:
        return f"({x} != 0)"
    if src is BOOL:
        return f"({x} ? 1 : 0)" if dst is I32 else f"({x} ? 1.0f : 0.0f)"
    return f"(float){x}" if dst is F32 else f"(int32_t){x}"


def _literal(dt: torch.dtype, bits: int) -> str:
    if dt is F32:
        return f"wfg_f32(0x{bits:08x}u)"
    if dt is BOOL:
        return "true" if bits else "false"
    return f"(int32_t)0x{bits:08x}u"


def _reciprocal_bits(bits: int) -> int:
    c = np.array([bits], np.uint32).view(np.float32)
    with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
        return f32_bits(float(np.float32(1.0) / c[0]))


def _live(nodes, roots) -> List[bool]:
    live = [False] * len(nodes)
    stack = list(roots)
    while stack:
        i = stack.pop()
        if not live[i]:
            live[i] = True
            stack.extend(nodes[i].args)
    return live


def _node_lines(nodes, live, load: Callable[[Node], str]) -> List[str]:
    """One ``const`` local ``t<i>`` per live node; ``load`` gives an
    "in" node's value."""
    lines: List[str] = []
    for i, n in enumerate(nodes):
        if not live[i]:
            continue
        a = [f"t{j}" for j in n.args]
        if n.op == "in":
            e = load(n)
        elif n.op == "const":
            e = _literal(n.dtype, n.value)
        elif n.op == "cast":
            e = convert(nodes[n.args[0]].dtype, n.dtype, a[0])
        elif n.op == "divc":
            e = (f"WFG_FDIVC({a[0]}, {_literal(F32, n.value)}, "
                 f"{_literal(F32, _reciprocal_bits(n.value))})")
        elif n.op == "recip":
            e = f"WFG_FDIV(1.0f, {a[0]})"
        elif n.op == "neg":
            e = f"wfg_ineg({a[0]})" if n.dtype is I32 else f"(-{a[0]})"
        elif n.op == "abs":
            e = f"wfg_iabs({a[0]})" if n.dtype is I32 else f"fabsf({a[0]})"
        elif n.op == "not":
            e = f"(!{a[0]})"
        elif n.op in COMPARE:
            e = f"({a[0]} {_CMP[n.op]} {a[1]})"
        elif n.op == "where":
            e = f"({a[0]} ? {a[1]} : {a[2]})"
        elif n.op == "floordivc":
            e = f"wfg_ifloordivc({a[0]}, {_literal(I32, n.value & MASK32)})"
        elif n.op == "modc":
            e = f"wfg_imodc({a[0]}, {_literal(I32, n.value & MASK32)})"
        else:
            e = _BINARY[n.dtype][n.op].format(*a)
        lines.append(f"const {_CTYPE[n.dtype]} t{i} = {e};")
    return lines


def _apply_body(ir: CombineIR) -> List[str]:
    idx = {f: k for k, f in enumerate(ir.fields)}

    def load(n: Node) -> str:
        side, f = n.value
        return word_to(n.dtype, f"{'l' if side == 'a' else 'r'}[{idx[f]}]")

    lines = _node_lines(ir.nodes, _live(ir.nodes, ir.outputs), load)
    for k, i in enumerate(ir.outputs):
        lines.append(f"o[{k}] = {to_word(ir.nodes[i].dtype, f't{i}')};")
    return lines


def _node_body(ir: CombineIR) -> List[str]:
    lines = ["uint32_t m[NF];", "apply(l, r, m);",
             "const bool both = vl && vr;"]
    for k, (f, plane) in enumerate(zip(ir.fields, ir.dtypes)):
        merged = ir.nodes[ir.outputs[k]].dtype
        child = f"(vl ? l[{k}] : r[{k}])"
        if merged is plane:
            lines.append(f"o[{k}] = both ? m[{k}] : {child};  // {f}")
            continue
        # torch.where(both, merged, child) promotes, the store casts back
        w = merged if _CAT[merged] > _CAT[plane] else plane
        x = (f"both ? {convert(merged, w, word_to(merged, f'm[{k}]'))} : "
             f"{convert(plane, w, word_to(plane, child))}")
        lines.append(f"{{  // {f}: a {_CTYPE[merged]} result on a "
                     f"{_CTYPE[plane]} plane")
        lines.append(f"    const {_CTYPE[w]} x = {x};")
        lines.append(f"    o[{k}] = {to_word(plane, convert(w, plane, 'x'))};")
        lines.append("}")
    return lines


def _policy(ir: CombineIR) -> str:
    """The ``WfgCombine`` struct of ``ir``."""
    nf = len(ir.fields)
    bools = [k for k, dt in enumerate(ir.dtypes) if dt is BOOL]
    bytes_ = (" || ".join(f"f == {k}" for k in bools) + " ? 1 : 4"
              if bools else "4")
    sig = ("const uint32_t (&l)[NF], const uint32_t (&r)[NF]")
    ind = "        "
    out = ["// " + ", ".join(f"{f}:{str(dt).replace('torch.', '')}"
                             for f, dt in zip(ir.fields, ir.dtypes)),
           f"struct {STRUCT} {{",
           f"    static constexpr int NF = {nf};",
           f"    static constexpr bool WORDS = {'false' if bools else 'true'};",
           "    static constexpr int CTA_MIN_BLOCKS = NF <= 5 ? 2 : 1;",
           "    WFG_HDC static constexpr int bytes(int f) {",
           f"        return {bytes_};",
           "    }",
           f"    WFG_HD static void apply({sig}, uint32_t (&o)[NF]) {{",
           *(ind + ln for ln in _apply_body(ir)),
           "    }",
           f"    WFG_HD static void node({sig}, bool vl, bool vr,",
           "                            uint32_t (&o)[NF]) {",
           *(ind + ln for ln in _node_body(ir)),
           "    }",
           "};", ""]
    return "\n".join(out)


def combine_source(ir: CombineIR) -> str:
    """The prelude and the ``WfgCombine`` policy of ``ir``."""
    return PRELUDE + "\n" + _policy(ir)


def kernel_source(ir: CombineIR) -> str:
    """The translation unit of a traced variant of K1. The policy sits in
    a namespace named by a digest of the trace: every instantiation of
    the header's templates (kernels, and the static locals that hold
    per-kernel settings, which the dynamic linker unifies across loaded
    libraries) is then the variant's own."""
    ns = "wfg_" + hashlib.sha256(ir.text().encode()).hexdigest()[:12]
    return "\n".join(['#include "forest_rebuild.cuh"',
                      '#include "ffat_step.cuh"',
                      '#include "reduce_fold.cuh"', PRELUDE,
                      f"namespace {ns} {{", _policy(ir), f"}}  // {ns}", "",
                      f"WF_REBUILD_ENTRY_POINTS({ns}::{STRUCT})",
                      f"WF_FFAT_ENTRY_POINTS({ns}::{STRUCT})",
                      f"WF_REDUCE_ENTRY_POINTS({ns}::{STRUCT})", ""])


# ---------------------------------------------------------------------------
# stateful steps (K8)
# ---------------------------------------------------------------------------
def step_reads(ir: StepIR) -> List[str]:
    """The row columns the step reads (the kernel's input columns), in
    the row's order."""
    live = _live(ir.nodes, [i for _, i in ir.outputs] + list(ir.new_state))
    read = {n.value[1] for n, lv in zip(ir.nodes, live)
            if lv and n.op == "in" and n.value[0] == "row"}
    return [f for f, _ in ir.row if f in read]


def step_out_dtypes(ir: StepIR) -> List[torch.dtype]:
    """The kernel's output columns' dtypes (filter mode: the keep byte)."""
    if ir.filter_mode:
        return [BOOL]
    return [ir.nodes[i].dtype for _, i in ir.outputs]


def _bytes_fn(name: str, dtypes: Sequence[torch.dtype], var: str) -> List[str]:
    ones = [k for k, dt in enumerate(dtypes) if dt is BOOL]
    body = (" || ".join(f"{var} == {k}" for k in ones) + " ? 1 : 4"
            if ones else "4")
    return [f"    WFG_HDC static constexpr int {name}(int {var}) {{",
            f"        return {body};", "    }"]


def _step_policy(ir: StepIR) -> str:
    """The ``WfgStep`` struct of ``ir``."""
    reads = step_reads(ir)
    row_dt = dict(ir.row)
    idx = {f: k for k, f in enumerate(reads)}
    outs = step_out_dtypes(ir)
    nin, nout, nst = len(reads), len(outs), len(ir.state)

    def load(n: Node) -> str:
        src, key = n.value
        return word_to(n.dtype, f"r[{idx[key]}]" if src == "row"
                       else f"s[{key}]")

    roots = [i for _, i in ir.outputs] + list(ir.new_state)
    body = ["(void)r;", "(void)o;"]
    body += _node_lines(ir.nodes, _live(ir.nodes, roots), load)
    for j, ((f, i), dt) in enumerate(zip(ir.outputs, outs)):
        body.append(f"o[{j}] = {to_word(dt, convert(ir.nodes[i].dtype, dt, f't{i}'))};"
                    f"  // {f}")
    # the new state last: every node above has read the old one
    for l, (i, dt) in enumerate(zip(ir.new_state, ir.state)):
        body.append(f"s[{l}] = {to_word(dt, convert(ir.nodes[i].dtype, dt, f't{i}'))};")
    sig = ("const uint32_t (&r)[RIN], uint32_t (&s)[RST], "
           "uint32_t (&o)[ROUT]")
    ind = "        "
    desc = ", ".join(f"{f}:{str(row_dt[f]).replace('torch.', '')}"
                     for f in reads) or "none"
    out = [f"// {'filter' if ir.filter_mode else 'map'} step; reads {desc}",
           f"struct {STEP_STRUCT} {{",
           f"    static constexpr int NIN = {nin};",
           f"    static constexpr int NOUT = {nout};",
           f"    static constexpr int NST = {nst};",
           "    static constexpr int RIN = NIN > 0 ? NIN : 1;",
           "    static constexpr int ROUT = NOUT > 0 ? NOUT : 1;",
           "    static constexpr int RST = NST;",
           *_bytes_fn("in_bytes", [row_dt[f] for f in reads], "c"),
           *_bytes_fn("out_bytes", outs, "j"),
           *_bytes_fn("st_bytes", ir.state, "l"),
           f"    WFG_HD static void step({sig}) {{",
           *(ind + ln for ln in body),
           "    }",
           "};", ""]
    return "\n".join(out)


def step_source(ir: StepIR) -> str:
    """The prelude and the ``WfgStep`` policy of ``ir``."""
    return PRELUDE + "\n" + _step_policy(ir)


def step_kernel_source(ir: StepIR) -> str:
    """The translation unit of a traced step: K8's kernel
    (``grid_scan.cuh``) over the step's policy, in a namespace named by a
    digest of the trace (as ``kernel_source``'s variants are)."""
    ns = "wfs_" + hashlib.sha256(ir.text().encode()).hexdigest()[:12]
    return "\n".join([PRELUDE, '#include "grid_scan.cuh"', "",
                      f"namespace {ns} {{", _step_policy(ir),
                      f"}}  // {ns}", "",
                      f"WF_GRID_SCAN_ENTRY_POINTS({ns}::{STEP_STRUCT})", ""])
