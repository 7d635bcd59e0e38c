"""The keyed grid scan (K8) of the port on the CPU: the tracer of stateful
steps (``kernels/combine_trace.py:trace_step``), the kernel's algorithm
(``kernels/grid_scan.cuh``) and the layouts it walks (``KeyRows``).

(a) ``trace_step`` traces every stateful function of the repo, and
    ``StepIR.evaluate`` equals the function called directly under
    ``torch.func.vmap`` (as the plain version calls it) on the same
    numpy-seeded inputs: ints and bools exact, floats bit for bit.
(b) What the kernel cannot take is refused, naming the operation.
(c) The kernel's algorithm, each touched key's rows walked in arrival
    order one at a time, three ways: a model in this file (the walk in
    Python with ``StepIR.evaluate``), the kernel's own walk
    (``grid_scan.cuh``'s ``scan_key`` over the generated step policy,
    compiled with ``g++ -ffp-contract=off`` into a host library and called
    through the wrapper's ``run_walk``), held against the port's plain
    version ``grid_scan_core`` (``grid_walk`` on CPU tensors) and the JAX
    package's ``_grid_scan_core`` on its CPU backend. Compared, EXACT for
    int32, bool and float32 alike (each key's fold adds in arrival order
    in all of them): the output columns on the rows ``valid`` admits (on
    the others they carry no meaning: the kernel writes zeros, the plain
    versions the key's first cell), the table rows ``[0, T_cap)`` (never
    the scratch row) and ``dirty[:T_cap]``. One case starts from a JAX
    engine's state carried over by ``convert.scan_state_from_jax``.
    The kernel's two regimes: at a small threshold and ring tile (4 and 8
    rows) the host walk runs the block regime's staging through its ring
    and its walk on runs at every threshold and tile edge, a key holding
    the whole batch, a heavy key mostly outside ``valid``, filter mode and
    bool columns and leaves; one block a heavy key, or two blocks
    striding over a list of every key, -1 for a light one (the mesh's);
    each held exactly against the model, the plain version and the JAX
    core.
(d) The layouts: ``grid_meta``'s rows grouped by key equal a numpy stable
    argsort grouping, and so does the mesh's grouping on the device
    (``mesh/core.py:received_rows``) of each group's received lanes, on
    one and on several CPU groups; the heavy-key lists (``grid_meta``'s
    from the host's counts, the mesh's built on the device) equal a numpy
    model of the same threshold."""

import ctypes
import shutil
import subprocess
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
import test_torch_mesh_ops as tmo
import test_torch_state as tst
import test_torch_state_fusion as tsf
import test_torch_tiered as ttr
from windflow_tpu.tpu.ops_tpu import Map_TPU, _grid_scan_core
from windflow_tpu_torch import WindFlowError
from windflow_tpu_torch.convert import scan_state_from_jax
from windflow_tpu_torch.gpu.ops_gpu import Filter_GPU, Map_GPU
from windflow_tpu_torch.kernels import grid_scan as gs
from windflow_tpu_torch.kernels.build import KERNEL_DIR
from windflow_tpu_torch.kernels.combine_trace import trace_step
from windflow_tpu_torch.mesh import core as ct
from windflow_tpu_torch.pytree import tree_flatten, tree_unflatten

I32, F32, BOOL = torch.int32, torch.float32, torch.bool
TORCH = SimpleNamespace(maximum=torch.maximum)
JNP = SimpleNamespace(maximum=jnp.maximum)


def _run_max(o):
    """``test_torch_state_fusion.py``'s ``run_max`` (``_chain_ops``),
    over ``o.maximum``."""
    def run_max(row, state):
        keep = row["value"] > state["mx"]
        return keep, {"mx": o.maximum(state["mx"], row["value"])}
    return run_max


def _every_2nd(row, st):
    """``test_torch_mesh_ops.py``'s stateful filter: every 2nd row of a
    key (an int32 ``%`` by a constant)."""
    return (st + 1) % 2 == 0, st + 1


def _identity(r, s):
    """``test_torch_mesh_ops.py``'s ``lambda r, s: (r, s)``."""
    return r, s


def _mixed(row, st):
    """int32, float32 and bool leaves, a new bool column."""
    n = st["n"] + 1
    tot = st["tot"] + row["w"]
    hi = st["hi"] | (row["value"] > 50)
    return ({**row, "value": row["value"] + n, "w": tot, "hi": hi},
            {"n": n, "tot": tot, "hi": hi})


def _floor_ops(row, st):
    """Both of the step's integer operations, on negative values too."""
    q = (row["value"] - 50) // 7
    return {**row, "value": q + (st % -3)}, st + (row["value"] % 5) - 2


def _flag_count(row, st):
    """A bool row column read by the step (one byte a row)."""
    n = st + row["f"].int()
    return {**row, "value": row["value"] * 2 + n}, n


def _flag_count_jnp(row, st):
    n = st + row["f"].astype(jnp.int32)
    return {**row, "value": row["value"] * 2 + n}, n


def _bool_both(row, st):
    """A bool row column read and a bool state leaf."""
    seen = st["seen"] | row["f"]
    n = st["n"] + row["f"].int()
    return ({**row, "value": row["value"] + n, "seen": seen},
            {"seen": seen, "n": n})


def _bool_both_jnp(row, st):
    seen = st["seen"] | row["f"]
    n = st["n"] + row["f"].astype(jnp.int32)
    return ({**row, "value": row["value"] + n, "seen": seen},
            {"seen": seen, "n": n})


def _two_flags(row, st):
    """Two bool row columns read (two 1-byte arrays in a ring tile)."""
    n = st + row["f"].int() * 2 + row["g"].int()
    return {**row, "value": row["value"] - n}, n


def _two_flags_jnp(row, st):
    n = st + row["f"].astype(jnp.int32) * 2 + row["g"].astype(jnp.int32)
    return {**row, "value": row["value"] - n}, n


KV = {"key": I32, "value": I32}
# name -> (torch step, jnp twin or None, row dtypes, state init, filter)
STEPS = {
    "smap_fn": (cs._smap_fn, cs._smap_fn, KV, {"n": np.int32(0)}, False),
    "run_max_fn": (cs._run_max_fn, _run_max(JNP), KV, {"mx": np.int32(0)},
                   True),
    "tier_fn": (cs._tier_fn, cs._tier_fn, {"k": I32, "v": F32},
                np.float32(0), False),
    "running_sum": (tst._running_sum, tst._running_sum, KV,
                    {"total": np.int32(0)}, False),
    "count_step": (tst._count_step, tst._count_step, KV,
                   {"n": np.int32(0)}, False),
    "running_max_pred": (tst._running_max_pred(TORCH),
                         tst._running_max_pred(JNP), KV,
                         {"mx": np.int32(0)}, True),
    "fusion_step": (tsf._step, tsf._step, KV, {"total": np.int32(0)},
                    False),
    "fusion_run_max": (_run_max(TORCH), _run_max(JNP), KV,
                       {"mx": np.int32(0)}, True),
    "tiered_scan_fn": (ttr._scan_fn, ttr._scan_fn, {"k": I32, "v": F32},
                       np.float32(0), False),
    "mesh_running": (tmo._running, tmo._running, {"key": I32, "v": F32},
                     np.float32(0), False),
    "mesh_every_2nd": (_every_2nd, _every_2nd, {"key": I32, "v": I32},
                       np.int32(0), True),
    "mesh_identity": (_identity, _identity, {"key": I32, "v": F32},
                      np.float32(0), False),
    "mixed": (_mixed, _mixed, {"key": I32, "value": I32, "w": F32},
              {"n": np.int32(0), "tot": np.float32(0), "hi": np.bool_(0)},
              False),
    "floor_ops": (_floor_ops, _floor_ops, KV, np.int32(0), False),
    "flag_count": (_flag_count, _flag_count_jnp, {**KV, "f": BOOL},
                   np.int32(0), False),
    "bool_both": (_bool_both, _bool_both_jnp, {**KV, "f": BOOL},
                  {"seen": np.bool_(0), "n": np.int32(0)}, False),
    "two_flags": (_two_flags, _two_flags_jnp, {**KV, "f": BOOL, "g": BOOL},
                  np.int32(0), False),
}


def _col(rng, dt, n):
    if dt is F32:
        return rng.standard_normal(n).astype(np.float32)
    if dt is BOOL:
        return rng.random(n) < 0.5
    return rng.integers(0, 100, n).astype(np.int32)


def _leaf(rng, v, n):
    a = np.array(v)
    if a.dtype == np.bool_:
        return torch.from_numpy(rng.random(n) < 0.5)
    if a.dtype.kind == "f":
        return torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return torch.from_numpy(rng.integers(-50, 50, n).astype(np.int32))


def _same(a, b):
    """Equal dtypes and bits (floats compared as their words)."""
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    if a.dtype is F32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# (a) the tracer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(STEPS))
def test_traced_step_equals_the_function(name):
    func, _, dtypes, s0, filt = STEPS[name]
    ir = trace_step(func, dtypes, s0, filt)
    rng = np.random.default_rng(len(name))
    n = 257
    row = {f: torch.from_numpy(_col(rng, dt, n)) for f, dt in dtypes.items()}
    leaves, spec = tree_flatten(s0)
    state = tree_unflatten(spec, [_leaf(rng, v, n) for v in leaves])
    out, new = ir.evaluate(row, state)
    ref_out, ref_new = torch.func.vmap(func)(row, state)
    for a, b in zip(tree_flatten(new)[0], tree_flatten(ref_new)[0]):
        _same(a, b)
    if filt:
        _same(out, ref_out)
        return
    assert list(out) == list(ref_out)
    for f in ref_out:
        _same(out[f], ref_out[f])
    # a column returned unchanged is a pass-through: the row's own tensor
    for f, src in ir.passed:
        assert out[f] is row[src]


def test_trace_records_pass_throughs_and_reads():
    ir = trace_step(cs._smap_fn, {**KV, "ck": (torch.int64, (2,))},
                    {"n": np.int32(0)}, False)
    assert dict(ir.passed) == {"key": "key", "ck": "ck"}
    assert [f for f, _ in ir.outputs] == ["value"]
    assert ir.names == ("key", "value", "ck")
    assert gs.step_variant(cs._smap_fn, False, {
        "key": torch.zeros(1, dtype=I32), "value": torch.zeros(1, dtype=I32),
        "ck": torch.zeros((1, 2), dtype=torch.int64)},
        {"n": torch.zeros(1, dtype=I32)}).reads == ("value",)
    ir = trace_step(_identity, {"key": I32}, np.float32(0), False)
    assert not ir.outputs and ir.nodes[ir.new_state[0]].op == "in"
    ops = {n.op for n in trace_step(_floor_ops, KV, np.int32(0),
                                     False).nodes}
    assert {"floordivc", "modc"} <= ops


# ---------------------------------------------------------------------------
# (b) refusals
# ---------------------------------------------------------------------------
_REFUSED = {
    "sin": (lambda r, s: ({"x": torch.sin(r["v"])}, s), "torch.sin"),
    "pow": (lambda r, s: ({"x": r["v"] ** 2}, s), "**"),
    "bool": (lambda r, s: ({"x": r["v"] if r["v"] > 0 else s}, s), "bool()"),
    "floordiv_traced": (lambda r, s: ({"x": r["key"] // s}, s),
                        "// by a traced value"),
    "mod_traced": (lambda r, s: ({"x": r["key"] % r["key"]}, s),
                   "% by a traced value"),
    "floordiv_zero": (lambda r, s: ({"x": r["key"] // 0}, s), "// by 0"),
    "mod_float": (lambda r, s: ({"x": r["v"] % 2}, s), "int32 only"),
    "computed_2d": (lambda r, s: ({"x": r["ck"] + 1}, s),
                    "trailing dimensions"),
    "2d_state": (lambda r, s: (r, r["ck"]), "trailing dimensions"),
    "not_a_pair": (lambda r, s: r, "(output, state)"),
    "map_not_dict": (lambda r, s: (r["v"], s), "dict of columns"),
    "const_output": (lambda r, s: ({"x": 1}, s), "not a traced value"),
    "leaf_count": (lambda r, s: (r, (s, s)), "leaves"),
}


@pytest.mark.parametrize("case", list(_REFUSED))
def test_step_refusals_name_the_operation(case):
    func, what = _REFUSED[case]
    with pytest.raises(WindFlowError) as e:
        trace_step(func, {"key": I32, "v": F32,
                          "ck": (torch.int32, (2,))}, np.int32(0), False)
    assert what in str(e.value), str(e.value)
    assert str(e.value).startswith("step:")


def test_combines_still_refuse_integer_division():
    """``//`` and ``%`` by a constant are a step's only: K1's combines
    refuse them as before."""
    from windflow_tpu_torch.kernels.combine_trace import trace_combine
    with pytest.raises(WindFlowError, match="combine: %"):
        trace_combine(lambda a, b: {"x": a["x"] % 3}, {"x": I32})


# ---------------------------------------------------------------------------
# (c) the kernel's algorithm
# ---------------------------------------------------------------------------
def _model(ir, fields, valid, rows, table):
    """K8's walk in Python: for each touched key, its rows in arrival
    order, one at a time through ``StepIR.evaluate``; a row ``valid``
    excludes leaves the state as it is and gets zeros. Returns (out,
    table leaves, dirty) on copies."""
    leaves, spec = tree_flatten(table)
    leaves = [lf.clone() for lf in leaves]
    n_rows = valid.shape[0]
    dirty = torch.zeros(leaves[0].shape[0], dtype=torch.bool)
    if ir.filter_mode:
        outs = {"keep": torch.zeros(n_rows, dtype=torch.bool)}
    else:
        outs = {f: torch.zeros(n_rows, dtype=ir.nodes[i].dtype)
                for f, i in ir.outputs}
    order, starts = rows.order.tolist(), rows.starts.tolist()
    for k in range(rows.n_touched):
        slot = int(rows.touched[k])
        st = [lf[slot:slot + 1].clone() for lf in leaves]
        for p in range(starts[k], starts[k + 1]):
            i = order[p]
            if not valid[i]:
                continue
            out, new = ir.evaluate({f: v[i:i + 1] for f, v in fields.items()},
                                   tree_unflatten(spec, st))
            st = [nw.to(o.dtype) for nw, o in zip(tree_flatten(new)[0], st)]
            if ir.filter_mode:
                outs["keep"][i] = bool(out[0])
            else:
                for f, _ in ir.outputs:
                    outs[f][i] = out[f][0]
        for lf, s in zip(leaves, st):
            lf[slot] = s[0]
        dirty[slot] = True
    if ir.filter_mode:
        return outs["keep"], leaves, dirty
    passed = dict(ir.passed)
    return ({f: fields[passed[f]] if f in passed else outs[f]
             for f in ir.names}, leaves, dirty)


_HOST_LIBS = {}


def _host_lib(v, tmp_path_factory):
    """The step's translation unit, kernel header included, built by g++
    into a host library: the kernel's walk, run thread after thread."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the kernel's walk cannot be "
                    "compiled on this host")
    if v.tag not in _HOST_LIBS:
        d = tmp_path_factory.mktemp(f"k8_{v.tag}")
        src, lib = d / "step.cpp", d / "step.so"
        src.write_text(v.text)
        res = subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                              "-Wall", "-Wno-unknown-pragmas", "-shared",
                              "-fPIC", f"-I{KERNEL_DIR}", "-o", str(lib),
                              str(src)], capture_output=True, text=True,
                             timeout=120)
        assert res.returncode == 0, res.stderr
        _HOST_LIBS[v.tag] = ctypes.CDLL(str(lib))
    return _HOST_LIBS[v.tag]


def _layout(case, rng):
    """(keys of the batch's n rows, capacity, valid holes or None)."""
    if case == "deep64":  # 64 keys, one holding 1,024 rows: M = 1,024
        keys = np.concatenate([np.zeros(1024, np.int64),
                               np.repeat(np.arange(1, 64), 4)])
        rng.shuffle(keys)
        return keys, 2048, None
    if case == "hc4096":  # 4,096 keys at M 1-2
        keys = np.concatenate([np.arange(4096),
                               rng.choice(4096, 1024, replace=False)])
        rng.shuffle(keys)
        return keys, 8192, None
    if case == "zipf":  # one hot key's chain holds the launch
        keys = (rng.zipf(1.1, 2048) - 1) % 10_000
        return keys, 2048, None
    if case == "holes":  # a fused chain's valid with holes
        keys = rng.integers(0, 40, 700)
        return keys, 1024, rng.random(700) < 0.3
    if case == "empty":
        return np.zeros(0, np.int64), 8, None
    if case.startswith("edges4"):  # runs at HEAVY-4 and TILE-8 edges
        runs = list(EDGE_RUNS)
        while sum(runs) < 260:
            runs.append(int(rng.integers(1, 3)))
        keys = np.repeat(np.arange(len(runs)), runs)
        rng.shuffle(keys)
        return keys, 512, (rng.random(len(keys)) < 0.3
                           if case == "edges4_holes" else None)
    if case == "whole":  # one key holds every row of the batch
        return np.full(150, 7, np.int64), 256, None
    if case == "mostly_invalid":  # a heavy key, 90% of it out of valid
        keys = np.concatenate([np.zeros(60, np.int64),
                               rng.integers(1, 30, 40)])
        rng.shuffle(keys)
        holes = np.where(keys == 0, rng.random(100) < 0.9,
                         rng.random(100) < 0.1)
        return keys, 128, holes
    keys = rng.integers(0, 50, 300)
    return keys, 512, (rng.random(300) < 0.2 if case == "small_holes"
                       else None)


def _batch(case, dtypes, seed):
    """One batch of the case: the port engine's ``KeyRows`` (its
    ``grid_meta``), the grid, the columns and ``valid``."""
    rng = np.random.default_rng(seed)
    keys, cap, holes = _layout(case, rng)
    n = len(keys)
    op = Map_GPU(lambda r, s: (r, s), name="k8", key_extractor="key",
                 state_init={"n": np.int32(0)})
    op.build_replicas()
    eng = op.replicas[0].engine
    rows = eng.prep(SimpleNamespace(size=n, capacity=cap, host_keys=keys))
    g = gs.grid_of(rows, cap)[0].numpy()
    cols = {f: _col(rng, dt, cap) for f, dt in dtypes.items()}
    cols[next(iter(dtypes))][:n] = keys  # the key column
    valid = np.zeros(cap, dtype=bool)
    valid[:n] = True
    if holes is not None:
        valid[:n] &= ~holes
    return rows, g, cols, valid, len(eng.slot_of_key)


def _table(s0, T, seed, from_jax=None):
    """A state table of T rows and the scratch row, random: each of the
    port's leaves (T + 1,) and the JAX package's (T,)."""
    rng = np.random.default_rng(seed)
    leaves, spec = tree_flatten(s0)
    if from_jax is not None:
        port = [torch.cat([lf[:T], lf[:1]]) for lf in from_jax]
    else:
        port = [_leaf(rng, v, T + 1) for v in leaves]
    return (tree_unflatten(spec, port),
            tree_unflatten(spec, [jnp.array(lf[:T].numpy())
                                  for lf in port]))


def _check(name, ir, filt, valid, got, ref, what):
    v = torch.from_numpy(valid)
    out, leaves, dirty = got
    rout, rleaves, rdirty = ref
    T = len(rdirty)
    if filt:
        assert torch.equal(out.to(torch.bool)[v], torch.as_tensor(
            np.array(rout))[v]), (name, what)
    else:
        for f in ir.names:
            _same(torch.as_tensor(np.array(out[f]))[v],
                  torch.as_tensor(np.array(rout[f]))[v])
    for a, b in zip(leaves, rleaves):
        _same(torch.as_tensor(np.array(a))[:T],
              torch.as_tensor(np.array(b))[:T])
    assert torch.equal(torch.as_tensor(np.array(dirty))[:T],
                       torch.as_tensor(np.array(rdirty))[:T]), (name, what)


CASES = [("deep64", "smap_fn"), ("hc4096", "smap_fn"), ("zipf", "tier_fn"),
         ("holes", "smap_fn"), ("holes", "run_max_fn"),
         ("small", "mixed"), ("small_holes", "mixed"),
         ("small", "mesh_every_2nd"), ("small_holes", "floor_ops"),
         ("small", "mesh_identity"), ("small_holes", "flag_count"),
         ("empty", "smap_fn"),
         ("empty", "run_max_fn")]


HEAVY, TILE = 4, 8  # the block regime's threshold and tile in tests
# runs at the threshold (-1, =, +1), the tile (-1, =, +1, two + 1) and the
# ring of four tiles (-1, =, +1: the ring's first tile used again)
EDGE_RUNS = (3, 4, 5, 7, 8, 9, 17, 31, 32, 33)


def _regime(rows, how):
    """``rows`` with its heavy list at ``HEAVY``: one block a heavy key,
    longest first (``blocks``, the host's list), two blocks striding over
    an entry a key, -1 for a light one (``keyed``, the list the mesh
    builds on its cards), or one block over a list of -1 entries with the
    heavy keys 1, 2, ..., 8, 1, ... entries apart and a light key just
    after each where there is room (``spread``: the kernel loads the
    entries after a hit 8 at a time, ``WF_SCAN_LIST_UNROLL``, so the next
    heavy key falls in every slot of that group)."""
    counts = np.diff(rows.starts.numpy().astype(np.int64))[:rows.n_touched]
    hl = gs.heavy_keys(counts, HEAVY)
    nb = len(hl)
    if how == "keyed":
        hl = gs.heavy_keys_device(
            torch.from_numpy(counts), HEAVY,
            torch.arange(len(counts), dtype=torch.int32)).numpy()
        nb = min(nb, 2)
    elif how == "spread":
        light = list(np.flatnonzero(counts < HEAVY))
        at = np.cumsum([0] + [i % 8 + 1 for i in range(nb - 1)])
        spread = np.full(at[-1] + 2, -1, np.int32)
        spread[at] = hl
        for p, q in zip(at[:-1], at[1:]):
            if q - p > 1 and light:
                spread[p + 1] = light.pop()
        hl, nb = spread, 1
    return rows._replace(heavy=torch.from_numpy(hl), heavy_blocks=nb,
                         heavy_rows=HEAVY)


def _walk_all(name, case, tmp_path_factory, from_jax=None, seed=7,
              regime=None):
    func, jfunc, dtypes, s0, filt = STEPS[name]
    rows, grid_idx, cols, valid, n_keys = _batch(case, dtypes, seed)
    T = max(64, 1 << max(0, n_keys - 1).bit_length())
    fields = {f: torch.from_numpy(c.copy()) for f, c in cols.items()}
    tv = torch.from_numpy(valid)
    table, jtable = _table(s0, T, seed + 1, from_jax)
    ir = trace_step(func, {f: t.dtype for f, t in fields.items()}, table,
                    filt)
    # the model
    got = _model(ir, fields, tv, rows, table)
    # the port's plain version (grid_walk on CPU tensors)
    t_plain = tree_unflatten(tree_flatten(table)[1],
                             [lf.clone() for lf in tree_flatten(table)[0]])
    d_plain = torch.zeros(T + 1, dtype=torch.bool)
    step = gs.GridStep(func, filt)
    plain = gs.grid_walk(step, fields, tv, rows, t_plain, d_plain)
    plain_ref = (plain, tree_flatten(t_plain)[0], d_plain[:T])
    # the JAX package's _grid_scan_core on its CPU backend
    KB = rows.touched.shape[0]
    tmask = np.arange(KB) < rows.n_touched
    jout, jt2, jd2 = _grid_scan_core(jfunc, filt, rows.M, KB)(
        {f: jnp.array(c) for f, c in cols.items()}, valid,
        jnp.array(grid_idx), jnp.array(rows.touched.numpy()),
        jnp.array(tmask), jtable, jnp.zeros(T, bool))
    jax_ref = (jout, [np.array(a) for a in tree_flatten(jt2)[0]],
               np.array(jd2))
    _check(name, ir, filt, valid, got, plain_ref, "model vs plain")
    _check(name, ir, filt, valid, got, jax_ref, "model vs JAX")
    # the kernel's own walk, compiled for the host
    v = step.variant(fields, table)
    t_k = tree_unflatten(tree_flatten(table)[1],
                         [lf.clone() for lf in tree_flatten(table)[0]])
    d_k = torch.zeros(T + 1, dtype=torch.bool)
    if regime is None:
        kout = gs.run_walk(_host_lib(v, tmp_path_factory), v, fields, tv,
                           rows, t_k, d_k, 0)
    else:
        krows = _regime(rows, regime)
        assert krows.heavy_blocks > 0
        kout = gs.run_walk(_host_lib(v, tmp_path_factory), v, fields, tv,
                           krows, t_k, d_k, 0, tile=TILE)
    _check(name, ir, filt, valid, (kout, tree_flatten(t_k)[0], d_k),
           plain_ref, "kernel walk vs plain")
    # the kernel writes every row it does not compute: zeros
    off = ~tv
    if filt:
        assert not kout[off].any()
    else:
        for f, _ in ir.outputs:
            assert not kout[f][off].any()
    # the scratch row is never the kernel's
    for a, b in zip(tree_flatten(t_k)[0], tree_flatten(table)[0]):
        _same(a[T:], b[T:])
    assert not d_k[T]
    return got


@pytest.mark.parametrize("case,name", CASES,
                         ids=[f"{c}-{n}" for c, n in CASES])
def test_kernel_walk_equals_plain_and_jax(case, name, tmp_path_factory):
    _walk_all(name, case, tmp_path_factory)


BLOCK_CASES = [("edges4", "smap_fn"), ("edges4", "run_max_fn"),
               ("edges4", "tier_fn"), ("edges4", "bool_both"),
               ("edges4_holes", "mixed"), ("edges4_holes", "flag_count"),
               ("edges4", "two_flags"),
               ("whole", "smap_fn"), ("whole", "tier_fn"),
               ("mostly_invalid", "smap_fn"),
               ("mostly_invalid", "running_max_pred"),
               ("deep64", "smap_fn"), ("holes", "run_max_fn")]


@pytest.mark.parametrize("regime", ["blocks", "keyed", "spread"])
@pytest.mark.parametrize("case,name", BLOCK_CASES,
                         ids=[f"{c}-{n}" for c, n in BLOCK_CASES])
def test_block_regime_walk_equals_plain_and_jax(case, name, regime,
                                                tmp_path_factory):
    """The kernel's host walk with its block regime at ``HEAVY`` rows and
    ``TILE``-row ring tiles: runs at every threshold and tile edge, the
    whole batch one key, a heavy key mostly outside ``valid``, filter
    mode, bool columns and leaves, float adds; exactly the model, the
    plain version and the JAX core (``_walk_all``)."""
    _walk_all(name, case, tmp_path_factory, regime=regime)


def test_block_regime_layouts_reach_every_edge():
    """The block regime's layouts hold the runs their tests name: every
    ``EDGE_RUNS`` length as one key's run, heavy and light keys in one
    batch, one key of the whole batch, a heavy key mostly out of
    ``valid``."""
    rows = _batch("edges4", KV, 7)[0]
    runs = np.diff(rows.starts.numpy())[:rows.n_touched]
    for r in EDGE_RUNS:
        assert r in runs, r
    assert (runs < HEAVY).any() and (runs >= HEAVY).any()
    # the spread list puts the next heavy key in each slot of the group of
    # 8 entries loaded after a hit, with light keys among them
    spread = _regime(rows, "spread").heavy.numpy()
    hits = [e for e in np.flatnonzero(spread >= 0)
            if runs[spread[e]] >= HEAVY]
    assert {(q - p - 1) % 8 for p, q in zip(hits, hits[1:])} == set(range(8))
    assert any(0 <= spread[e] and runs[spread[e]] < HEAVY
               for e in range(len(spread)))
    rows = _batch("whole", KV, 7)[0]
    assert rows.n_touched == 1 and int(rows.starts[1]) == 150
    _, _, cols, valid, _ = _batch("mostly_invalid", KV, 7)
    heavy = cols["key"][:100] == 0
    assert heavy.sum() == 60 and valid[:100][heavy].mean() < 0.25


def test_block_regime_refuses_a_ring_over_a_launch_unasked_share(
        tmp_path_factory):
    """The kernel takes a ring up to the 48 KB of dynamic shared memory a
    launch gets without opting in, and refuses a larger one before it
    walks a row; ``tile_rows`` picks a ring within ``RING_BYTES``."""
    func, _, dtypes, s0, filt = STEPS["smap_fn"]
    rows, _, cols, valid, n_keys = _batch("whole", dtypes, 7)
    fields = {f: torch.from_numpy(c.copy()) for f, c in cols.items()}
    table, _ = _table(s0, 64, 8)
    v = gs.GridStep(func, filt).variant(fields, table)
    lib = _host_lib(v, tmp_path_factory)
    tile = gs.tile_rows(lib)
    assert lib.wf_ring_bytes(tile) <= gs.RING_BYTES <= 48 * 1024
    big = 1
    while lib.wf_ring_bytes(big) <= 48 * 1024:
        big *= 2
    krows = _regime(rows, "blocks")
    dirty = torch.zeros(65, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="invalid arguments"):
        gs.run_walk(lib, v, fields, torch.from_numpy(valid), krows, table,
                    dirty, 0, tile=big)
    assert not dirty.any()
    gs.run_walk(lib, v, fields, torch.from_numpy(valid), krows, table,
                dirty, 0, tile=big // 2)
    assert dirty.any()


def test_kernel_walk_from_a_jax_state(tmp_path_factory):
    """A JAX stateful map runs three batches; its snapshot, carried over
    by ``scan_state_from_jax``, is the table the model, the kernel's walk,
    the plain version and the JAX core all start from."""
    op = Map_TPU(cs._smap_fn, name="k8j", key_extractor="key",
                 state_init={"n": jnp.int32(0)})
    op.build_replicas()
    rep = op.replicas[0]
    rep.set_emitter(tst._Collect(
        lambda b: {k: np.array(v) for k, v in b.fields.items()}))
    tst._feed(rep, tst._blocks(3, seed=5, n_keys=50))
    snap = scan_state_from_jax(rep.snapshot_state()["scan"], "cpu")
    leaves = tree_flatten(snap["table"])[0]
    assert int(leaves[0].sum()) == 3 * tst.BATCH  # every row counted
    _walk_all("smap_fn", "small", tmp_path_factory, from_jax=leaves)


def test_grid_walk_refuses_other_devices_and_counts_only_cuda():
    rows, _g, cols, valid, _n = _batch("small", KV, 3)
    fields = {f: torch.from_numpy(c) for f, c in cols.items()}
    table = {"n": torch.zeros(65, dtype=I32)}
    before = gs.LAUNCHES
    gs.grid_walk(gs.GridStep(cs._smap_fn, False), fields,
                 torch.from_numpy(valid), rows, table,
                 torch.zeros(65, dtype=torch.bool))
    assert gs.LAUNCHES == before  # the plain version launched no kernel
    meta = {f: t.to("meta") for f, t in fields.items()}
    with pytest.raises(WindFlowError, match="no kernel for device meta"):
        gs.grid_walk(gs.GridStep(cs._smap_fn, False), meta,
                     torch.ones(len(valid), dtype=torch.bool,
                                device="meta"), rows, table,
                     torch.zeros(65, dtype=torch.bool))


# ---------------------------------------------------------------------------
# (d) the layouts
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_keys", [5, 300], ids=["bincount", "unique"])
def test_grid_meta_rows_are_a_stable_grouping(n_keys):
    op = Filter_GPU(cs._run_max_fn, name="k8g", key_extractor="key",
                    state_init={"mx": np.int32(0)})
    op.build_replicas()
    eng = op.replicas[0].engine
    rng = np.random.default_rng(n_keys)
    for n, cap in ((200, 256), (24, 32), (0, 8), (40, 64)):
        keys = (rng.permutation(max(n_keys, n))[:n] % n_keys if n == 200
                else rng.integers(0, n_keys, n))
        order, starts, touched, nt, M, walked = eng.grid_meta(
            SimpleNamespace(size=n, capacity=cap, host_keys=keys))[:6]
        KB = len(touched)
        assert walked == n
        gslot = np.array([eng.slot_of_key[int(k)] for k in keys],
                         dtype=np.int64)
        want = np.argsort(gslot, kind="stable")
        assert order.dtype == np.int32 and starts.dtype == np.int32
        assert np.array_equal(order[:n], want)
        assert np.array_equal(order[n:], np.arange(n, cap))
        assert np.array_equal(touched[:nt], np.unique(gslot))
        cnt = np.array([np.count_nonzero(gslot == s) for s in touched[:nt]])
        assert np.array_equal(starts, np.r_[0, np.cumsum(cnt),
                                            np.full(KB - nt, n)])
        assert M >= (cnt.max() if n else 1)
    if n_keys == 300:
        assert eng.table_capacity > 4 * 40  # the np.unique path at the end


def _heavy_model(counts, hr, keyed=False):
    """The heavy list of ``counts`` at threshold ``hr`` in numpy: keys by
    run length, longest first, ties by key, the light ones dropped; or,
    ``keyed`` (the mesh's list), an entry a key, -1 for a light one."""
    if keyed:
        return np.where(counts >= hr, np.arange(len(counts)),
                        -1).astype(np.int32)
    by = np.argsort(-counts, kind="stable")
    return by[counts[by] >= hr].astype(np.int32)


@pytest.mark.parametrize("hr", [4, gs.HEAVY_ROWS])
def test_grid_meta_heavy_list_equals_numpy_model(hr, monkeypatch):
    """``grid_meta``'s heavy list from the host's counts equals the numpy
    model at the same threshold, its blocks one a key; ``prep`` ships it
    with the starts. Where M < the threshold no key is heavy and no
    block-regime block launches."""
    from windflow_tpu_torch.gpu import ops_gpu
    monkeypatch.setattr(ops_gpu, "HEAVY_ROWS", hr)
    op = Map_GPU(cs._smap_fn, name="k8h", key_extractor="key",
                 state_init={"n": np.int32(0)})
    op.build_replicas()
    eng = op.replicas[0].engine
    rng = np.random.default_rng(hr)
    seen_heavy = seen_none = 0
    for n, cap, n_keys in ((300, 512, 20), (200, 256, 9), (24, 32, 12),
                           (64, 64, 64), (0, 8, 1), (900, 1024, 3)):
        keys = rng.integers(0, n_keys, n)
        batch = SimpleNamespace(size=n, capacity=cap, host_keys=keys)
        rows = eng.grid_meta(batch)
        counts = np.diff(rows.starts.astype(np.int64))[:rows.n_touched]
        want = _heavy_model(counts, hr)
        assert rows.heavy_rows == hr
        if not len(want):
            assert rows.heavy is None and rows.heavy_blocks == 0
            assert rows.M < hr or n == 0 or counts.max() < hr
            seen_none += rows.M < hr
            continue
        seen_heavy += 1
        assert rows.heavy.dtype == np.int32
        assert np.array_equal(rows.heavy, want)
        assert rows.heavy_blocks == len(want)
        dev = eng.prep(batch)
        assert np.array_equal(dev.starts.numpy(), rows.starts)
        assert np.array_equal(dev.heavy.numpy(), want)
    assert seen_heavy and seen_none


@pytest.mark.parametrize("M", [None, 2], ids=["rows", "M_below"])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_mesh_heavy_list_equals_numpy_model(groups, M, virtual_devices,
                                            monkeypatch):
    """Each group's heavy list, built on the device inside a sharded step
    (``received_rows``: no host sync), equals the numpy model of its
    received lanes' counts at the same threshold (an entry a key, -1 for
    a light one), and its launch takes the host's bound of blocks: at
    most the slice's rows // threshold, the group's keys and
    ``MAX_HEAVY_BLOCKS``. With the host's M below the threshold no list
    is built and no block-regime block launches. The kept rows equal a
    numpy model's."""
    hr = 3
    monkeypatch.setattr(ct, "HEAVY_ROWS", hr)
    monkeypatch.setattr(ct, "MAX_HEAVY_BLOCKS", 5)
    seen, walked = [], []
    real_rows, real_walk = ct.received_rows, ct.grid_walk

    def spy_rows(gslot, n_keys, heavy_rows, keys):
        out = real_rows(gslot, n_keys, heavy_rows, keys)
        seen.append((gslot.numpy().copy(), n_keys, heavy_rows, keys,
                     out[2]))
        return out

    def spy_walk(step, fields, valid, rows, table, dirty):
        walked.append(rows)
        return real_walk(step, fields, valid, rows, table, dirty)

    monkeypatch.setattr(ct, "received_rows", spy_rows)
    monkeypatch.setattr(ct, "grid_walk", spy_walk)
    cpu = torch.device("cpu")
    ct.ensure_virtual_devices(8, group_devices=[cpu] * groups
                              if groups > 1 else None)
    mesh = ct.make_key_mesh(8, shape=(4, 2), device="cpu")
    rng = np.random.default_rng(groups)
    lb, cap = 8, 40
    slots = rng.integers(0, 12, 8 * lb).astype(np.int32)  # keys of many rows
    slots[rng.random(8 * lb) < 0.2] = -1
    vals = rng.integers(0, 50, 8 * lb).astype(np.int32)
    step, (K_pad, _, GB) = ct.sharded_grid_scan(mesh, _every_2nd, True,
                                                cap, M, lb)
    table = ct.make_mesh_table(mesh, np.int32(0), K_pad)

    def lanes(a):
        return mesh.split(a, mesh.lane_sizes(lb))

    step(table, lanes(slots), lanes(np.arange(GB, dtype=np.int32)),
         lanes({"v": vals}))
    assert len(seen) == len(walked) == groups
    any_heavy = False
    for (gslot, n_keys, heavy_rows, keys, heavy), rows in zip(seen, walked):
        assert heavy_rows == hr and rows.heavy_rows == hr
        if M is not None:
            assert keys is None and heavy is None and rows.heavy is None
            assert rows.heavy_blocks == 0
            continue
        cnt = np.bincount(gslot, minlength=n_keys + 1)[:n_keys]
        want = _heavy_model(cnt, hr, keyed=True)
        assert heavy.dtype == torch.int32
        assert np.array_equal(heavy.numpy(), want)
        assert rows.heavy is heavy
        assert rows.heavy_blocks == min(n_keys, GB // hr, 5)
        any_heavy |= bool((want >= 0).any())
    assert any_heavy or M is not None
    keep = mesh.join(step(ct.make_mesh_table(mesh, np.int32(0), K_pad),
                          lanes(slots), lanes(np.arange(GB, dtype=np.int32)),
                          lanes({"v": vals}))[1]).numpy()
    want = np.zeros(len(slots), bool)
    for sl in np.unique(slots[slots >= 0]):
        idx = np.flatnonzero(slots == sl)
        want[idx[1::2]] = True
    assert np.array_equal(keep, want)


@pytest.fixture
def virtual_devices():
    prev = (ct.virtual_device_count(), ct.virtual_device_groups(),
            ct.excluded_device_ids())
    ct.set_excluded_devices(())
    yield
    ct.ensure_virtual_devices(prev[0], group_devices=prev[1])
    ct.set_excluded_devices(prev[2])


@pytest.mark.parametrize("depth", ["host", "rows"])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_mesh_rows_are_a_stable_grouping(groups, depth, virtual_devices,
                                         monkeypatch):
    """Each group's received lanes, grouped on the device by
    ``received_rows`` inside a sharded step, equal numpy's stable argsort
    of their slots (the invalid lanes last), and the step's output equals
    the one-group mesh's on the real lanes. The plain version's depth M
    comes from the host (``host``) or, as ``Map_Mesh`` runs it, from each
    group's own rows (``rows``: M None)."""
    seen = []
    real = ct.received_rows

    def spy(gslot, n_keys, heavy_rows, keys):
        order, starts, heavy = real(gslot, n_keys, heavy_rows, keys)
        seen.append((gslot.numpy().copy(), n_keys, order, starts))
        return order, starts, heavy

    monkeypatch.setattr(ct, "received_rows", spy)
    cpu = torch.device("cpu")
    ct.ensure_virtual_devices(8, group_devices=[cpu] * groups
                              if groups > 1 else None)
    mesh = ct.make_key_mesh(8, shape=(4, 2), device="cpu")
    assert mesh.n_groups == groups
    rng = np.random.default_rng(17)
    lb, cap = 8, 40
    slots = rng.integers(0, cap, 8 * lb).astype(np.int32)
    slots[rng.random(8 * lb) < 0.2] = -1
    vals = rng.integers(0, 50, 8 * lb).astype(np.int32)
    M = (1 << (int(np.bincount(slots[slots >= 0]).max()) - 1).bit_length()
         if depth == "host" else None)
    step, (K_pad, _, GB) = ct.sharded_grid_scan(mesh, _every_2nd, True,
                                                cap, M, lb)
    table = ct.make_mesh_table(mesh, np.int32(0), K_pad)

    def lanes(a):
        return mesh.split(a, mesh.lane_sizes(lb))

    _, out, _ = step(table, lanes(slots), lanes(np.arange(GB,
                                                          dtype=np.int32)),
                     lanes({"v": vals}))
    assert len(seen) == groups
    for gslot, n_keys, order, starts in seen:
        assert order.dtype == torch.int32 and starts.dtype == torch.int32
        assert np.array_equal(order.numpy(),
                              np.argsort(gslot, kind="stable"))
        cnt = np.bincount(gslot, minlength=n_keys + 1)[:n_keys]
        assert np.array_equal(starts.numpy(), np.r_[0, np.cumsum(cnt)])
    keep = mesh.join(out).numpy()
    # every 2nd real lane of a slot, in arrival order
    want = np.zeros(len(slots), bool)
    for s in np.unique(slots[slots >= 0]):
        idx = np.flatnonzero(slots == s)
        want[idx[1::2]] = True
    assert np.array_equal(keep, want)


# ---------------------------------------------------------------------------
# (e) the wrapper's columns and the fused chain's steps
# ---------------------------------------------------------------------------
def test_pass_through_takes_the_plain_dtype(tmp_path_factory):
    """A pass-through column leaves the kernel in the plain version's
    dtype (an int64 key as int32, ``canonical``), and an int32 one is the
    input tensor itself (aliased, no copy)."""
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 9, 60)
    op = Map_GPU(cs._smap_fn, name="k8p", key_extractor="key",
                 state_init={"n": np.int32(0)})
    op.build_replicas()
    eng = op.replicas[0].engine
    rows = eng.prep(SimpleNamespace(size=60, capacity=64, host_keys=keys))
    valid = torch.arange(64) < 60
    for kdt in (torch.int64, I32):
        fields = {"key": torch.from_numpy(np.r_[keys, np.zeros(4, int)])
                  .to(kdt),
                  "value": torch.from_numpy(_col(rng, I32, 64))}
        table = {"n": torch.zeros(17, dtype=I32)}
        v = eng.step.variant(fields, table)
        kout = gs.run_walk(_host_lib(v, tmp_path_factory), v, fields, valid,
                           rows, {"n": table["n"].clone()},
                           torch.zeros(17, dtype=BOOL), 0)
        plain = gs.grid_walk(eng.step, fields, valid, rows,
                             {"n": table["n"].clone()},
                             torch.zeros(17, dtype=BOOL))
        like = gs.output_like(v, fields)
        for f in plain:
            _same(kout[f][valid], plain[f][valid])
            assert like[f].dtype == plain[f].dtype and like[f].shape == (1,)
        assert (kout["key"] is fields["key"]) == (kdt is I32)


def _widen(f):
    """A stateless map in front: a float32 column the step reads."""
    return {**f, "w": f["value"].to(torch.float32) * 0.5}


def _acc_w(row, st):
    """A stateful map behind ``_widen``: reads its column, adds one."""
    tot = st["tot"] + row["w"]
    return {**row, "tot": tot}, {"tot": tot}


def _fused(second, third=None):
    from windflow_tpu_torch.gpu.fused_ops import FusedGPUReplica
    ops = [Map_GPU(_widen, name="widen"),
           Map_GPU(second, name="acc", key_extractor="key",
                   state_init={"tot": np.float32(0)})]
    if third is not None:
        ops.append(Filter_GPU(third, name="run_max", key_extractor="key",
                              state_init={"mx": np.int32(0)}))
    return FusedGPUReplica(ops, 0)


def test_fused_chain_traces_every_step_before_a_commit(monkeypatch):
    """A stateful sub-op behind others in a fused chain: ``_load_steps``
    (what prep and prewarm call on a card) traces each step over the
    columns it will see, the ones the sub-ops before it emit, and loads
    its library once per batch dtypes."""
    loads = []
    monkeypatch.setattr(gs.StepVariant, "load",
                        lambda v: loads.append(v.tag))
    fr = _fused(_acc_w, cs._run_max_fn)
    fields = {"key": torch.zeros(8, dtype=I32),
              "value": torch.zeros(8, dtype=I32)}
    assert fr._load_steps(fields) == 2
    acc, flt = (fr.specs[i].engine.step for i in (1, 2))
    [(akey, av)] = acc._variants.items()
    assert dict((f, dt) for f, dt, _ in akey[0]) == {
        "key": I32, "value": I32, "w": F32}
    assert av.reads == ("w",) and av.out_dtypes == (F32,)
    [(fkey, _)] = flt._variants.items()
    assert [f for f, _, _ in fkey[0]] == ["key", "value", "w", "tot"]
    assert len(loads) == 2
    assert fr._load_steps(fields) == 0 and len(loads) == 2
    assert fr.prewarm([8]) is None  # on the CPU: nothing to build


def test_fused_chain_refuses_a_later_step_before_a_commit(monkeypatch):
    """A step the tracer refuses, second in the chain, raises naming the
    operation when its chain's steps are loaded, before any commit."""
    monkeypatch.setattr(gs.StepVariant, "load", lambda v: None)
    fr = _fused(lambda r, s: ({**r, "tot": torch.sin(r["w"])}, s))
    with pytest.raises(WindFlowError, match="torch.sin"):
        fr._load_steps({"key": torch.zeros(4, dtype=I32),
                        "value": torch.zeros(4, dtype=I32)})

