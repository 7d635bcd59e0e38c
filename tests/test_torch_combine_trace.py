"""The tracer (``kernels/combine_trace.py``) and the code generator
(``kernels/combine_codegen.py``) of K1's traced variants, on the CPU.

(a) The traced graph, run with torch ops (``CombineIR.evaluate``), equals
    the combine called directly on the same CPU tensors: bit for bit for
    ints, bools and floats, NaN for NaN (torch's vector and scalar CPU
    paths give NaNs of other payloads), over hypothesis inputs that hold
    NaN, +-inf, -0.0 and the int32 extremes. Every refusal has a case.
(b) The generated C++ (``combine_source``), compiled with ``g++
    -ffp-contract=off`` and run over the same inputs, equals the torch
    combine (``apply``) and the plain version's node rule (``node``:
    ``where(vl & vr, merged, where(vl, l, r))`` cast to the plane):
    ints and bools bit for bit; floats NaN for NaN and otherwise equal as
    values, so a zero may differ in sign only where min / max meets +0
    and -0 (torch's CPU ``minimum`` returns either zero depending on its
    vector or scalar path; the card's kernel is held bit for bit against
    torch on the card by ``chip_smoke.py``).

The combines come from ``torch_combines.py``."""

import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import torch_combines as tc
from windflow_tpu_torch import WindFlowError, fieldwise
from windflow_tpu_torch.kernels import forest_rebuild as fr
from windflow_tpu_torch.kernels.combine_codegen import (combine_source,
                                                        kernel_source)
from windflow_tpu_torch.kernels.combine_trace import trace_combine

I32, F32, BOOL = torch.int32, torch.float32, torch.bool
CASES = {**{n: (lambda n=n: tc.make(n, torch), tc.DTYPES[n])
            for n in tc.NAMES},
         "every_op": (lambda: tc.every_op, tc.EVERY_OP_DTYPES),
         "fieldwise_bool": (lambda: fieldwise(s="sum", lo="min", hi="max"),
                            {"s": BOOL, "lo": F32, "hi": I32}),
         # a float result on an int32 plane: the node promotes the
         # passed-through child to float32 (ints above 2^24 round)
         "float_on_int": (lambda: lambda a, b: {"k": (a["k"] + b["k"]) * 0.5},
                          {"k": I32})}

_F32_SPECIAL = [float("nan"), float("inf"), float("-inf"), -0.0, 0.0,
                1.5, -3.0, 3.4e38, 1e-45]
_I32_SPECIAL = [-2**31, 2**31 - 1, -1, 0, 1, 3, 1 << 24, (1 << 24) + 1]


def _column(dt, n):
    if dt is F32:
        el = st.one_of(st.sampled_from(_F32_SPECIAL),
                       st.floats(width=32, allow_nan=True,
                                 allow_infinity=True))
        return st.lists(el, min_size=n, max_size=n).map(
            lambda v: np.array(v, np.float32))
    if dt is I32:
        el = st.one_of(st.sampled_from(_I32_SPECIAL),
                       st.integers(-2**31, 2**31 - 1),
                       st.integers(-100, 100))
        return st.lists(el, min_size=n, max_size=n).map(
            lambda v: np.array(v, np.int64).astype(np.int32))
    return st.lists(st.booleans(), min_size=n, max_size=n).map(
        lambda v: np.array(v, bool))


@st.composite
def _inputs(draw, dtypes):
    n = draw(st.integers(1, 24))
    side = lambda: {f: draw(_column(dt, n)) for f, dt in dtypes.items()}
    a, b = side(), side()
    vl = draw(st.lists(st.booleans(), min_size=n, max_size=n))
    vr = draw(st.lists(st.booleans(), min_size=n, max_size=n))
    return a, b, np.array(vl), np.array(vr)


def _words(x: torch.Tensor) -> np.ndarray:
    x = x.contiguous()
    if x.dtype is BOOL:
        return x.numpy().astype(np.uint32)
    return x.numpy().view(np.uint32)


def _same_words(got, exp, dt, signed_zeros_equal):
    if dt is F32:
        g, e = got.view(np.float32), exp.view(np.float32)
        nan = np.isnan(e)
        assert (np.isnan(g) == nan).all()
        if signed_zeros_equal:
            assert (g[~nan] == e[~nan]).all()
        else:
            assert (got[~nan] == exp[~nan]).all()
    else:
        assert (got == exp).all()


def _t(a):
    return {f: torch.from_numpy(v.copy()) for f, v in a.items()}


def _node_ref(comb, a, b, vl, vr, dtypes):
    """The plain version's node: forest_rebuild_ref's where rule."""
    m = comb(a, b)
    vl, vr = torch.from_numpy(vl), torch.from_numpy(vr)
    return {f: torch.where(vl & vr, m[f], torch.where(vl, a[f], b[f]))
            .to(dt) for f, dt in dtypes.items()}


# ---------------------------------------------------------------------------
# (a) the traced graph against the combine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CASES))
@settings(max_examples=30, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_traced_graph_equals_the_combine(name, data):
    make, dtypes = CASES[name]
    comb = make()
    ir = trace_combine(comb, dtypes)
    a, b, _, _ = data.draw(_inputs(dtypes))
    exp = comb(_t(a), _t(b))
    got = ir.evaluate(_t(a), _t(b))
    assert list(got) == list(dtypes)
    for f in dtypes:
        e = exp[f] if isinstance(exp[f], torch.Tensor) else torch.tensor(
            exp[f])
        assert got[f].dtype == e.dtype, f
        _same_words(_words(got[f]), _words(e.expand(got[f].shape)),
                    e.dtype, signed_zeros_equal=False)


def test_trace_nodes_carry_torch_result_dtypes():
    ir = trace_combine(tc.make("mean_last", torch), tc.DTYPES["mean_last"])
    out = [ir.nodes[i].dtype for i in ir.outputs]
    assert out == [I32, I32, F32]
    ir = trace_combine(lambda a, b: {"k": a["k"] * 1.5 > b["k"]}, {"k": I32})
    assert ir.nodes[ir.outputs[0]].dtype is BOOL
    ops = {n.op for n in ir.nodes}
    assert "cast" in ops and "gt" in ops  # int32 * float -> float32
    # a field passed through is its input node, and x / c is one node
    ir = trace_combine(lambda a, b: {"k": b["k"], "x": a["x"] / 2.0},
                       {"k": I32, "x": F32})
    assert ir.nodes[ir.outputs[0]].op == "in"
    assert ir.nodes[ir.outputs[1]].op == "divc"


_REFUSED = {
    "torch_function": (lambda a, b: {"x": torch.sin(a["x"])}, "torch.sin"),
    "method": (lambda a, b: {"x": a["x"].clamp(0)}, ".clamp"),
    "control_flow": (lambda a, b: {"x": a["x"] if a["x"] > 0 else b["x"]},
                     "bool()"),
    "builtin_max": (lambda a, b: {"x": max(a["x"], b["x"])}, "bool()"),
    "floordiv": (lambda a, b: {"x": a["x"] // b["x"]}, "//"),
    "mod": (lambda a, b: {"x": a["x"] % 3}, "%"),
    "pow": (lambda a, b: {"x": a["x"] ** 2}, "**"),
    "int64_result": (lambda a, b: {"x": (a["f"] + 1).to(I32)}, "int64"),
    "bitwise_on_ints": (lambda a, b: {"x": a["x"] & b["x"]}, "bools only"),
    "not_on_ints": (lambda a, b: {"x": ~a["x"]}, "bools only"),
    "minimum_scalar": (lambda a, b: {"x": torch.minimum(a["x"], 3)},
                       "minimum"),
    "add_alpha": (lambda a, b: {"x": torch.add(a["x"], b["x"], alpha=2)},
                  "alpha"),
    "div_rounding": (lambda a, b: {"x": torch.div(a["x"], b["x"],
                                                  rounding_mode="floor")},
                     "torch.div"),
    "int64_cast": (lambda a, b: {"x": a["x"].to(torch.int64)}, "int64"),
    "numpy": (lambda a, b: {"x": np.maximum(a["x"], b["x"])}, "traced"),
    "tensor_constant": (lambda a, b: {"x": a["x"] + torch.ones(1)},
                        "Tensor"),
    "missing_field": (lambda a, b: {"x": a["x"]}, "lacks ['f']"),
    "extra_field": (lambda a, b: {"x": a["x"], "f": a["f"], "y": a["x"]},
                    "adds ['y']"),
    "reads_unknown": (lambda a, b: {"x": a["nope"], "f": a["f"]}, "nope"),
    "not_a_dict": (lambda a, b: [a["x"], a["f"]], "dict"),
    "not_traced_value": (lambda a, b: {"x": "x", "f": a["f"]}, "str"),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_tracer_refusals_name_the_operation_and_field(case):
    comb, what = _REFUSED[case]
    dtypes = {"x": I32, "f": BOOL}
    with pytest.raises(WindFlowError) as e:
        trace_combine(comb, dtypes)
    msg = str(e.value)
    assert what in msg, msg
    if case in ("torch_function", "method", "control_flow", "floordiv",
                "mod", "bitwise_on_ints"):
        assert "a['x']" in msg, msg


def test_tracer_refuses_plane_dtypes_the_kernel_does_not_take():
    with pytest.raises(WindFlowError, match="int32, float32 or bool"):
        trace_combine(lambda a, b: a, {"x": torch.int64})
    with pytest.raises(WindFlowError):
        trace_combine(lambda a, b: a, {})


def test_variant_is_traced_once_per_dtypes_and_cached_on_the_combine():
    comb = tc.make("ysb_last", torch)
    v1 = fr.variant(comb, tc.DTYPES["ysb_last"])
    assert v1.tag != fr.FIELDWISE and v1.ir is not None
    assert fr.variant(comb, tc.DTYPES["ysb_last"]) is v1
    v2 = fr.variant(comb, {"count": F32, "last_ing": I32})
    assert v2.tag != v1.tag
    # fieldwise: its own library up to 8 int32/float32 fields, traced
    # beyond that or over a bool plane
    assert fr.variant(fieldwise(a="sum", b="max"),
                      {"a": I32, "b": F32}).tag == fr.FIELDWISE
    assert fr.variant(fieldwise(a="sum"), {"a": BOOL}).tag != fr.FIELDWISE
    nine = {f"f{i}": I32 for i in range(9)}
    assert fr.variant(fieldwise(**{f: "sum" for f in nine}),
                      nine).tag != fr.FIELDWISE
    # the same combine text gives the same tag (one build per process)
    assert fr.variant(tc.make("ysb_last", torch),
                      tc.DTYPES["ysb_last"]).tag == v1.tag
    assert v1.library == f"forest_rebuild-{v1.tag}"
    assert '#include "forest_rebuild.cuh"' in v1.text
    # the policy sits in a namespace of its own: the header's template
    # instantiations (and their static locals) are the variant's alone
    assert re.search(r"WF_REBUILD_ENTRY_POINTS\(wfg_[0-9a-f]{12}::"
                     r"WfgCombine\)", kernel_source(v1.ir))


# ---------------------------------------------------------------------------
# (b) the generated C++ on the host
# ---------------------------------------------------------------------------
_HARNESS = r"""
#include <stdio.h>
int main(int argc, char** argv) {
    FILE* in = fopen(argv[1], "rb");
    FILE* out = fopen(argv[2], "wb");
    uint32_t n = 0;
    if (fread(&n, 4, 1, in) != 1) return 2;
    for (uint32_t i = 0; i < n; ++i) {
        uint32_t l[WfgCombine::NF], r[WfgCombine::NF], v[2];
        uint32_t m[WfgCombine::NF], o[WfgCombine::NF];
        if (fread(l, 4, WfgCombine::NF, in) != WfgCombine::NF ||
            fread(r, 4, WfgCombine::NF, in) != WfgCombine::NF ||
            fread(v, 4, 2, in) != 2) return 3;
        WfgCombine::apply(l, r, m);
        WfgCombine::node(l, r, v[0] != 0, v[1] != 0, o);
        fwrite(m, 4, WfgCombine::NF, out);
        fwrite(o, 4, WfgCombine::NF, out);
    }
    fclose(out);
    return 0;
}
"""
_BINARIES = {}


def _binary(name, tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the generated C++ cannot be "
                    "compiled on this host")
    if name not in _BINARIES:
        make, dtypes = CASES[name]
        d = tmp_path_factory.mktemp(f"gen_{name}")
        src = d / "combine.cpp"
        src.write_text(combine_source(trace_combine(make(), dtypes))
                       + _HARNESS)
        exe = d / "combine"
        res = subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                              "-Wall", "-Werror", "-o", str(exe), str(src)],
                             capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        _BINARIES[name] = exe
    return _BINARIES[name]


def _run(exe, ta, tb, vl, vr):
    """The binary's (apply, node) words: (n, 2, NF)."""
    n = len(vl)
    la = np.stack([_words(t) for t in ta.values()], 1)
    rb = np.stack([_words(t) for t in tb.values()], 1)
    rows = np.concatenate([la, rb, vl[:, None].astype(np.uint32),
                           vr[:, None].astype(np.uint32)], 1)
    d = exe.parent
    (d / "in.bin").write_bytes(np.uint32(n).tobytes()
                               + rows.astype(np.uint32).tobytes())
    res = subprocess.run([str(exe), str(d / "in.bin"), str(d / "out.bin")],
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return np.fromfile(d / "out.bin", np.uint32).reshape(n, 2, len(ta))


@pytest.mark.parametrize("name", list(CASES))
@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_generated_cpp_equals_the_torch_combine(name, data,
                                                tmp_path_factory):
    exe = _binary(name, tmp_path_factory)
    make, dtypes = CASES[name]
    comb = make()
    a, b, vl, vr = data.draw(_inputs(dtypes))
    ta, tb = _t(a), _t(b)
    got = _run(exe, ta, tb, vl, vr)
    merged = comb(ta, tb)
    node = _node_ref(comb, ta, tb, vl, vr, dtypes)
    for k, f in enumerate(dtypes):
        m = merged[f] if isinstance(merged[f], torch.Tensor) \
            else torch.tensor(merged[f]).expand(len(vl))
        _same_words(got[:, 0, k], _words(m), m.dtype, True)
        _same_words(got[:, 1, k], _words(node[f]), dtypes[f], True)


def test_float_result_on_int_plane_rounds_the_passed_child_as_torch_does(
        tmp_path_factory):
    """Above 2^24 an int32 child passed through a float32 ``where``
    changes: the generated node does what the plain version does."""
    big = np.array([(1 << 24) + 1, (1 << 30) + 3, 7], np.int32)
    ta = {"k": torch.from_numpy(big.copy())}
    tb = {"k": torch.from_numpy(big[::-1].copy())}
    vl, vr = np.array([True, True, False]), np.array([False, True, True])
    node = _node_ref(CASES["float_on_int"][0](), ta, tb, vl, vr,
                     {"k": I32})["k"]
    # the passed children round to float32; the sum wraps, then rounds
    assert node.tolist() == [1 << 24, -(1 << 30), 1 << 24]
    got = _run(_binary("float_on_int", tmp_path_factory), ta, tb, vl, vr)
    assert got[:, 1, 0].view(np.int32).tolist() == node.tolist()
