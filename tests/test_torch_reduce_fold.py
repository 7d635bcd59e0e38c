"""The reduce operators' folds (``windflow_tpu_torch/kernels/reduce_fold``)
held against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through the JAX functions and
through the port's plain versions:

- K7, ``keyed_fold``: ``ReduceTPUReplica``'s ``run``
  (``windflow_tpu/tpu/ops_tpu.py:1238-1259``), the fused chain's keyed
  terminator (``windflow_tpu/tpu/fused_ops.py`` ``seg_op`` with validity:
  a fused ``Filter_TPU -> Reduce_TPU`` chain body) and
  ``windflow_tpu/mesh/core.py:843`` ``sharded_keyed_reduce`` (the port's
  runs K7 with the group's slot count as the sentinel of its padding
  lanes);
- K6, ``tree_reduce``: ``windflow_tpu/tpu/ops_tpu.py:280``
  ``masked_tree_reduce``, at capacities that are no power of two.

Cases: int32 and float32 computed fields, a combine that omits fields, a
slot whose rows are all invalid, sentinel lanes, one key, every row its
own key, a run over many 128-row tiles; a pass-through int64 and a 2-D
column, which the JAX package (x64 off, and its ``where`` over rows) does
not take, against a numpy model. Tolerance: ints and bools exact, floats
within ``STEP_FOLD_RTOL`` (the port's Hillis-Steele scan groups the
combine differently from ``lax.associative_scan``); K6 walks the same
tree as ``masked_tree_reduce``, bit for bit, but for a product XLA may
contract into an FMA (``CONTRACTED_RTOL``).

The CUDA kernels run on a card (``chip_smoke.py`` holds them against
these plain versions there). Here their source is also built with g++
for a host stand-in of the CUDA runtime (``tests/torch_kernel_host.py``,
``tests/torch_cuda_host.h``: a block's threads as OS threads, blocks in
sequence) and the fieldwise library's K7, K6 and K2+K3 run against the
plain versions, in a child process with a time limit. Also: the trace
(``trace_reduce``: the planes and the pass-through columns, the refusal
of a computed int64 field) and the generated sources' entry points, K6's
stages (each row and partial read once by the kernel's class layout),
K7's ``starts`` from the host's sort and from the mesh's device sort on
every ``chip_smoke`` layout, a launch's one output buffer and in-kernel
gathers, the ``size`` form of K6 against ``masked_tree_reduce``, that the
reduce replicas hand the kernels ``size`` and ``starts``, that
``Reduce_GPU`` on ``device="cpu"`` takes any combine, and that nothing
reads the padding rows of a keyed ``Reduce_GPU``'s output.
"""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_kernel_host as kh
import windflow_tpu.tpu as wj
from windflow_tpu.mesh import core as cj
from windflow_tpu.tpu.fused_ops import FusedTPUReplica
from windflow_tpu.tpu.ops_tpu import masked_tree_reduce as jax_tree_reduce
from windflow_tpu_torch import WindFlowError, fieldwise
import windflow_tpu_torch as wt
from windflow_tpu_torch.gpu.batch import bucket_capacity
from windflow_tpu_torch.kernels import ffat_step as fs
from windflow_tpu_torch.kernels import forest_rebuild as fr
from windflow_tpu_torch.kernels import reduce_fold as rf
from windflow_tpu_torch.kernels.combine_codegen import kernel_source
from windflow_tpu_torch.kernels.combine_trace import trace_reduce
from windflow_tpu_torch.mesh import core as ct

KERNELS = Path(rf.__file__).resolve().parent
STEP_FOLD_RTOL = 1e-5
CONTRACTED_RTOL = 1e-6
I32, F32 = torch.int32, torch.float32


# ---------------------------------------------------------------------------
# combines (twins: xp is jnp or torch)
# ---------------------------------------------------------------------------
def _combine(name, xp):
    if name == "sum":
        return lambda a, b: {"v": a["v"] + b["v"]}
    if name == "sum_key":  # the key passes through as b's
        return lambda a, b: {"key": b["key"], "v": a["v"] + b["v"]}
    if name == "max_n":  # an int max and a count; the rest omitted
        return lambda a, b: {"n": a["n"] + b["n"],
                             "v": xp.maximum(a["v"], b["v"])}
    if name == "mean":  # a float mean weighted by an int count
        return lambda a, b: {
            "n": a["n"] + b["n"],
            "x": (a["x"] * a["n"] + b["x"] * b["n"]) / (a["n"] + b["n"])}
    raise KeyError(name)


def _columns(rng, n, keys):
    """key, v (int32), n (int32, 1-4), x (float32 in [1, 2)), f (bool)."""
    return {"key": keys.astype(np.int32),
            "v": rng.integers(-1000, 1000, n).astype(np.int32),
            "n": rng.integers(1, 5, n).astype(np.int32),
            "x": (1 + rng.random(n)).astype(np.float32),
            "f": rng.random(n) < 0.3}


def _keys(rng, n, layout):
    if layout == "one_key":
        return np.full(n, 7)
    if layout == "every_row":
        return rng.permutation(n)
    if layout == "long_runs":  # runs over many 128-row tiles
        return np.repeat(np.arange(3), [1000, 1500, n - 2500])
    return rng.integers(0, 40, n)


def _sorted(keys):
    """(order, sorted dense slots, n_slots) as the host's
    ``reduce_order_and_slots`` makes them for int keys."""
    order = np.argsort(keys, kind="stable").astype(np.int32)
    sk = keys[order]
    new = np.r_[True, sk[1:] != sk[:-1]]
    return order, (np.cumsum(new) - 1).astype(np.int32), int(new.sum())


def _t(cols):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in cols.items()}


def _j(cols):
    return {k: jnp.asarray(v) for k, v in cols.items()}


def _close(name, got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=name)
    else:
        assert np.array_equal(got, want), name


# ---------------------------------------------------------------------------
# K7 against ReduceTPUReplica's run
# ---------------------------------------------------------------------------
K7_CASES = [("sum", "random", 300), ("sum_key", "random", 1000),
            ("max_n", "random", 700), ("mean", "random", 900),
            ("sum", "one_key", 500), ("sum_key", "every_row", 400),
            ("mean", "long_runs", 3000), ("max_n", "long_runs", 3000)]


@pytest.mark.parametrize("comb,layout,n", K7_CASES,
                         ids=[f"{c}-{lay}-{n}" for c, lay, n in K7_CASES])
def test_keyed_fold_matches_jax_reduce_replica(comb, layout, n):
    rng = np.random.default_rng(n)
    keys = _keys(rng, n, layout)
    cols = _columns(rng, n, keys)
    order, slots, n_slots = _sorted(keys)
    op = wj.Reduce_TPU_Builder(_combine(comb, jnp)).with_key_by("key") \
        .build()
    op.build_replicas()
    want = op.replicas[0]._jitted(_j(cols), jnp.asarray(order),
                                  jnp.asarray(slots))
    out_cap = 1 << max(3, (n_slots - 1).bit_length())
    got, gv = rf.keyed_fold(_combine(comb, torch), _t(cols),
                            torch.from_numpy(order), torch.from_numpy(slots),
                            n_slots, None, out_cap)
    assert gv[:n_slots].all() and not gv[n_slots:].any()
    for f in cols:
        _close(f, got[f][:n_slots].numpy(), want[f][:n_slots],
               STEP_FOLD_RTOL)
        if f != "f":  # no run: computed and pass-through fields zero
            assert not got[f][n_slots:].any(), f


def _last_rows(keys, order, slots, n_slots, valid=None):
    """numpy: each slot's last (valid) row in arrival order, -1 for none."""
    last = np.full(n_slots, -1)
    for i, r in enumerate(order):
        if slots[i] < n_slots and (valid is None or valid[r]):
            last[slots[i]] = r
    return last


def test_keyed_fold_passes_int64_and_2d_columns_from_the_last_row():
    """Columns the combine does not return, of any dtype or shape, take
    the last (valid) row of the run; computed ones fold."""
    rng = np.random.default_rng(5)
    n = 600
    keys = rng.integers(0, 30, n)
    cols = _columns(rng, n, keys)
    cols["k64"] = keys.astype(np.int64) * 3_000_000_019
    cols["pair"] = np.stack([keys, rng.integers(0, 9, n)], 1).astype(
        np.int32)
    order, slots, n_slots = _sorted(keys)
    for valid in (None, rng.random(n) < 0.5):
        got, gv = rf.keyed_fold(
            _combine("sum", torch), _t(cols), torch.from_numpy(order),
            torch.from_numpy(slots), n_slots,
            None if valid is None else torch.from_numpy(valid))
        last = _last_rows(keys, order, slots, n_slots, valid)
        assert np.array_equal(gv.numpy(), last >= 0)
        ok = last >= 0
        for f in ("k64", "pair", "key", "x", "f"):
            assert np.array_equal(got[f].numpy()[ok], cols[f][last[ok]]), f
        tot = np.zeros(n_slots, np.int64)
        keep = np.ones(n, bool) if valid is None else valid
        np.add.at(tot, slots[np.argsort(order)][keep], cols["v"][keep])
        assert np.array_equal(got["v"].numpy()[ok], tot[ok])


# ---------------------------------------------------------------------------
# K7 with validity against the fused keyed terminator
# ---------------------------------------------------------------------------
FUSED_CASES = [("sum_key", 0.5, "random"), ("mean", 0.7, "random"),
               ("max_n", 0.2, "random"), ("sum", 0.0, "random"),
               ("sum_key", 0.5, "long_runs"), ("max_n", 0.9, "every_row")]


@pytest.mark.parametrize("comb,frac,layout", FUSED_CASES,
                         ids=[f"{c}-{f}-{lay}" for c, f, lay in FUSED_CASES])
def test_keyed_fold_with_valid_matches_jax_fused_terminator(comb, frac,
                                                            layout):
    """A fused ``Filter_TPU (keep) -> Reduce_TPU`` chain body folds each
    key's valid rows and compacts the surviving keys; K7's plain version
    with ``valid`` = keep gives the same slots and values (a slot whose
    rows are all invalid comes out invalid, and is dropped)."""
    n = 3000 if layout == "long_runs" else 800
    rng = np.random.default_rng(int(frac * 100) + n)
    keys = _keys(rng, n, layout)
    cols = _columns(rng, n, keys)
    keep = rng.random(n) < frac
    order, slots, n_slots = _sorted(keys)
    chain = FusedTPUReplica(
        [wj.Filter_TPU_Builder(lambda f: f["keep"]).build(),
         wj.Reduce_TPU_Builder(_combine(comb, jnp)).with_key_by("key")
         .build()], 0)
    jcols = _j({**cols, "keep": keep})
    tails, tslots, tcount, *_ = chain._chain_body((None, None))(
        jcols, n, (None, (jnp.asarray(order), jnp.asarray(slots))), ())
    tcount = int(tcount)
    got, gv = rf.keyed_fold(_combine(comb, torch), _t(cols),
                            torch.from_numpy(order), torch.from_numpy(slots),
                            n_slots, torch.from_numpy(keep), n)
    surv = np.flatnonzero(gv.numpy())
    assert np.array_equal(surv, np.asarray(tslots)[:tcount])
    for f in cols:
        _close(f, got[f].numpy()[surv], np.asarray(tails[f])[:tcount],
               STEP_FOLD_RTOL)


# ---------------------------------------------------------------------------
# K7 on the mesh's lanes against sharded_keyed_reduce
# ---------------------------------------------------------------------------
@pytest.fixture
def eight_devices():
    prev = (ct.virtual_device_count(), ct.virtual_device_groups(),
            ct.excluded_device_ids())
    ct.ensure_virtual_devices(8)
    ct.set_excluded_devices(())
    yield
    ct.ensure_virtual_devices(prev[0], group_devices=prev[1])
    ct.set_excluded_devices(prev[2])


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_keyed_fold_on_mesh_lanes_matches_jax_sharded_keyed_reduce(
        eight_devices, shape):
    """The port's ``sharded_keyed_reduce`` folds each group's received
    lanes with K7 (invalid lanes on the slot count, the sentinel): the
    per-slot results and the touched mask equal the JAX mesh op's, with
    a column the combine omits passing through."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    key_cap, lb = 64, 16
    rng = np.random.default_rng(sum(shape))
    mesh_t = ct.make_key_mesh(8, shape=shape, device="cpu")
    mesh_j = cj.make_key_mesh(8, shape=shape)
    step_t, _ = ct.sharded_keyed_reduce(mesh_t, _combine("sum", torch),
                                        key_cap, lb)
    step_j, _ = cj.sharded_keyed_reduce(mesh_j, _combine("sum", jnp),
                                        key_cap, lb)
    sh = NamedSharding(mesh_j, P(("key", "data")))
    for _ in range(3):
        slots = rng.integers(0, key_cap, 8 * lb).astype(np.int32)
        slots[rng.random(8 * lb) < 0.2] = -1  # padding lanes
        vals = {"v": rng.integers(-50, 50, 8 * lb).astype(np.int32),
                "w": rng.integers(0, 9, 8 * lb).astype(np.int32)}
        res_t, touched_t, _ = step_t(torch.from_numpy(slots), _t(vals))
        res_j, touched_j, _ = step_j(
            jax_put(slots, sh), {k: jax_put(v, sh) for k, v in vals.items()})
        assert np.array_equal(touched_t.numpy(), np.asarray(touched_j))
        for f in vals:
            assert np.array_equal(res_t[f].numpy(), np.asarray(res_j[f])), f


def jax_put(a, sh):
    import jax
    return jax.device_put(a, sh)


# ---------------------------------------------------------------------------
# K6 against masked_tree_reduce
# ---------------------------------------------------------------------------
K6_CASES = [(n, comb) for n in (1, 3, 100, 1000, 4097)
            for comb in ("sum", "max_n", "mean")]


@pytest.mark.parametrize("n,comb", K6_CASES,
                         ids=[f"{c}-{n}" for n, c in K6_CASES])
def test_tree_reduce_matches_jax_masked_tree_reduce(n, comb):
    rng = np.random.default_rng(n)
    cols = _columns(rng, n, rng.integers(0, 40, n))
    valid = rng.random(n) < 0.6
    valid[rng.integers(0, n)] = True
    want = jax_tree_reduce(_combine(comb, jnp), _j(cols), jnp.asarray(valid))
    got, gv = rf.tree_reduce(_combine(comb, torch), _t(cols),
                             torch.from_numpy(valid))
    assert gv.numpy().tolist() == [True]
    for f in cols:
        _close(f, got[f].numpy(), want[f],
               CONTRACTED_RTOL if comb == "mean" else 0.0)
    # a field the combine omits: the row the tree's selects keep
    assert int(got["key"][0]) == cols["key"][_tree_source(valid)]


def _tree_source(valid):
    """numpy: the row whose pass-through columns the halving tree keeps
    (the later side where both are valid, else the valid one)."""
    n = len(valid)
    m = 1 << max(0, n - 1).bit_length()
    v = np.r_[valid, np.zeros(m - n, bool)]
    src = np.arange(m)
    while len(v) > 1:
        h = len(v) // 2
        va, vb = v[:h], v[h:]
        src = np.where(va & ~vb, src[:h], src[h:])
        v = va | vb
    return int(src[0])


def test_tree_reduce_passes_int64_and_2d_columns():
    rng = np.random.default_rng(9)
    n = 777
    cols = _columns(rng, n, rng.integers(0, 40, n))
    cols["k64"] = rng.integers(0, 2**40, n).astype(np.int64)
    cols["pair"] = rng.integers(0, 9, (n, 2)).astype(np.int32)
    valid = rng.random(n) < 0.5
    got, gv = rf.tree_reduce(_combine("sum", torch), _t(cols),
                             torch.from_numpy(valid))
    top = _tree_source(valid)
    assert gv.item() and valid[top]
    assert int(got["v"][0]) == int(cols["v"][valid].astype(np.int64).sum()
                                   .astype(np.int32))
    assert int(got["k64"][0]) == cols["k64"][top]
    assert np.array_equal(got["pair"][0].numpy(), cols["pair"][top])


# ---------------------------------------------------------------------------
# the trace, the sources, the plan
# ---------------------------------------------------------------------------
def test_trace_reduce_records_pass_throughs():
    """Omitted fields and ``b[f]`` outputs pass through; the planes are
    the computed fields and what they read; an int64 or 2-D column is
    opaque. Two combines with the same computed fields share a library."""
    cols = {"key": I32, "v": I32, "x": F32, "k64": torch.int64,
            "pair": (I32, (2,))}
    ir = trace_reduce(lambda a, b: {"key": b["key"], "v": a["v"] + b["v"]},
                      cols)
    assert ir.fields == ("v",) and ir.passed == ("key", "x", "k64", "pair")
    ir2 = trace_reduce(lambda a, b: {"v": a["v"] + b["v"]},
                       {"key": I32, "v": I32})
    assert ir2.text() == ir.text()
    ir3 = trace_reduce(lambda a, b: {"x": a["x"] * b["v"]}, cols)
    assert ir3.fields == ("v", "x") and "k64" in ir3.passed
    # a combine that computes nothing keeps a plane (its b[f])
    ir4 = trace_reduce(lambda a, b: b, cols)
    assert ir4.fields == ("key",) and len(ir4.passed) == 4


def test_computed_int64_field_is_refused_with_its_name():
    comb = lambda a, b: {"v": a["v"] + b["v"]}  # noqa: E731
    fields = {"key": torch.zeros(2, dtype=I32),
              "v": torch.zeros(2, dtype=torch.int64)}
    with pytest.raises(WindFlowError, match=r"\+ on a\['v'\] \(dtype "
                       r"torch\.int64\)"):
        rf.fold_variant(comb, fields)
    with pytest.raises(WindFlowError, match=r"a\['pair'\]"):
        rf.fold_variant(lambda a, b: {"pair": a["pair"]},
                        {"v": torch.zeros(2, dtype=I32),
                         "pair": torch.zeros((2, 2), dtype=I32)})


def test_fold_variant_is_traced_once_and_fieldwise_takes_its_library():
    fields = {"key": torch.zeros(2, dtype=I32), "v": torch.zeros(2, dtype=I32)}
    comb = _combine("sum_key", torch)
    v1 = rf.fold_variant(comb, fields)
    assert rf.fold_variant(comb, fields) is v1
    assert v1.planes == ("v",) and v1.passed == ("key",)
    fw = rf.fold_variant(fieldwise(v="sum"), fields)
    assert fw.variant.tag == fr.FIELDWISE and fw.passed == ("key",)
    with pytest.raises(WindFlowError, match="does not carry"):
        rf.fold_variant(fieldwise(w="sum"), fields)


def test_library_sources_expand_the_reduce_entry_points():
    """No nvcc here: the fieldwise library and a traced variant's
    translation unit define K7's and K6's C entry points; the host's
    geometry is the header's."""
    cu = (KERNELS / "forest_rebuild.cu").read_text()
    cuh = (KERNELS / "reduce_fold.cuh").read_text()
    assert '#include "reduce_fold.cuh"' in cu
    for fn in ("wf_keyed_fold", "wf_tree_reduce"):
        assert re.search(rf"\bint {fn}\(", cu), fn
        assert re.search(rf"\bint {fn}\(", cuh), fn
    assert "#define WF_REDUCE_ENTRY_POINTS(Comb)" in cuh
    for name, value in (("WF_FOLD_THREADS", rf.FOLD_THREADS),
                        ("WF_FOLD_WARP_ROWS", rf.WARP_ROWS),
                        ("WF_MAX_GATHER", rf.MAX_GATHER)):
        assert int(re.search(rf"#define {name} (\d+)", cuh)[1]) == value
    for fn, py in (("tree_rows", rf.tree_rows), ("tree_parts", rf.tree_parts)):
        body = re.search(rf"constexpr int {fn}\(\) \{{\s*return ([^;]*);",
                         cuh)[1]
        for nf in range(3, 70):
            assert _ternary(body, nf) == py(nf), (fn, nf)
    fv = rf.fold_variant(_combine("mean", torch),
                         {"n": torch.zeros(1, dtype=I32),
                          "x": torch.zeros(1, dtype=F32)})
    src = kernel_source(fv.variant.ir)
    assert src == fv.variant.text and '#include "reduce_fold.cuh"' in src
    assert re.search(r"WF_REDUCE_ENTRY_POINTS\(wfg_[0-9a-f]{12}::"
                     r"WfgCombine\)", src)


def _ternary(expr, nf):
    """The value of a C chain ``NF <= a ? x : NF <= b ? y : z`` at nf."""
    for bound, val in re.findall(r"NF <= (\d+) \? (\d+) :", expr):
        if nf <= int(bound):
            return int(val)
    return int(expr.rsplit(":", 1)[1])


def _stage_positions(Q, B, per):
    """numpy: the positions each thread of a K6 stage of B blocks over Q
    positions loads (the header's class layout), and the positions the
    stage's blocks hand on, by the kernel's index formulas."""
    T = rf.FOLD_THREADS * B
    b, w, lane = np.meshgrid(np.arange(B), np.arange(4), np.arange(32),
                             indexing="ij")
    c = (32 * b + lane + 32 * B * w).ravel()
    cnt = Q // T if Q >= T else 1
    assert cnt <= per
    read = (c[:, None] + T * np.arange(cnt)[None, :]).ravel()
    return read[read < Q], (32 * np.arange(B)[:, None]
                            + np.arange(32)[None, :]).ravel()


@pytest.mark.parametrize("n", [1, 2, 255, 1024, 1025, 65536, 65537,
                               1 << 20])
@pytest.mark.parametrize("nf", [3, 10, 66])
def test_tree_stages_cover_every_row(n, nf):
    """K6's stages: the first stage's threads, by the kernel's class
    layout, read each of the m padded rows once, at most tree_rows a
    thread; each later stage reads each partial the stage before it
    published once, at most tree_parts a thread; the last stage is one
    block; the scratch holds every stage's partials and counters."""
    m = 1 << max(0, n - 1).bit_length()
    stages = rf.tree_stages(n, nf)
    assert stages[-1] == 1 and all(b >= 1 for b in stages)
    Q, per = m, rf.tree_rows(nf)
    for i, B in enumerate(stages):
        read, handed = _stage_positions(Q, B, per)
        assert np.array_equal(np.sort(read), np.arange(Q)), (i, B)
        Q, per = len(handed), rf.tree_parts(nf)
        if i + 1 < len(stages):  # the next stage's blocks gather 4 * per
            nxt = stages[i + 1]
            assert nxt == 1 or B == nxt * 4 * per
    counters, parts = rf.tree_words(n, nf)
    assert counters == sum(stages[1:])
    assert parts == sum(nf * 32 * b for b in stages[:-1])


def _layouts():
    """chip_smoke's K7 layouts at 4,096 rows: name -> (order, sorted
    slots, n_slots), numpy."""
    import chip_smoke as cs
    blocks = cs._blocks(cs.GRAPH_KEYS, seed=9,
                        n_batches=cs.GRAPH_WARMUP + 1, batch=4096)
    rng = np.random.default_rng(21)
    out = {}
    for name in cs.FOLD_LAYOUTS:
        _, _, order, slots, n_slots, _, _ = cs.fold_layout(torch, name,
                                                           blocks, rng)
        out[name] = (order, slots, n_slots)
    return out


def _starts_model(ssorted, n_slots):
    """numpy: slot s's first sorted row, s = 0..n_slots."""
    return np.array([int(np.sum(ssorted < s)) for s in range(n_slots + 1)],
                    dtype=np.int32)


@pytest.fixture(scope="module")
def fold_layouts():
    return _layouts()


FOLD_LAYOUT_NAMES = ("graph_gpu", "fused", "mesh", "one_run", "all_invalid",
                     "keys_65536", "float32", "half_valid", "tile_edges",
                     "passthrough", "dag")


@pytest.mark.parametrize("name", FOLD_LAYOUT_NAMES)
def test_starts_from_the_host_sort(fold_layouts, name):
    """A keyed Reduce_GPU's host prep on a layout's live rows (their
    slots as int keys): ``reduce_order_and_slots`` then ``slot_starts``
    gives each slot's first sorted row and the longest run, and the rows
    of slot s's range are exactly the rows of its key, in arrival
    order; ``fold_rows_to_device`` ships the three arrays as views of one
    tensor."""
    from windflow_tpu_torch.gpu.batch import BatchGPU
    from windflow_tpu_torch.gpu.ops_gpu import (
        fold_rows_to_device, reduce_order_and_slots, slot_starts)
    order0, sk0, n_slots0 = fold_layouts[name]
    arrival = np.empty_like(sk0)
    arrival[order0] = sk0
    keys = arrival[arrival < n_slots0].astype(np.int32)
    cap = len(arrival)
    op = wt.Reduce_GPU_Builder(_combine("sum", torch)).with_key_by("key") \
        .build()
    col = np.zeros(cap, np.int32)
    col[:len(keys)] = keys
    batch = BatchGPU({"key": torch.from_numpy(col)},
                     np.zeros(cap, np.int64), len(keys), None, 0)
    order, ssorted, slot_of_key = reduce_order_and_slots(op, batch)
    n_slots = len(slot_of_key)
    starts, longest = slot_starts(ssorted, n_slots)
    assert starts.dtype == np.int32
    assert np.array_equal(starts, _starts_model(ssorted, n_slots))
    lens = np.diff(starts)
    assert longest == (lens.max() if n_slots else 0)
    for key, s in slot_of_key.items():
        rows = order[starts[s]:starts[s + 1]]
        assert np.array_equal(rows, np.flatnonzero(keys == key)), key
    o, k, st = fold_rows_to_device(order, ssorted, starts,
                                   torch.device("cpu"))
    assert np.array_equal(o.numpy(), order)
    assert np.array_equal(k.numpy(), ssorted)
    assert np.array_equal(st.numpy(), starts)
    assert o.untyped_storage().data_ptr() == st.untyped_storage().data_ptr()


@pytest.mark.parametrize("name", FOLD_LAYOUT_NAMES)
def test_starts_from_the_mesh_device_sort(fold_layouts, name):
    """The mesh's keyed reduce: a layout's slots in arrival order (the
    sentinel on the invalid lanes) sorted on the device (``sort_rows``)
    and searched (``run_starts``): the starts equal the host's
    ``slot_starts`` of the same sorted slots and the numpy model."""
    from windflow_tpu_torch.gpu.ops_gpu import slot_starts
    order0, sk0, n_slots = fold_layouts[name]
    arrival = np.empty_like(sk0)
    arrival[order0] = sk0
    order, sl = fs.sort_rows(torch.from_numpy(arrival.astype(np.int32)))
    starts = rf.run_starts(sl, n_slots)
    assert starts.dtype is torch.int32 and starts.numel() == n_slots + 1
    model = _starts_model(sl.numpy(), n_slots)
    assert np.array_equal(starts.numpy(), model)
    assert np.array_equal(slot_starts(sl.numpy(), n_slots)[0], model)
    assert np.array_equal(sl.numpy(), np.sort(arrival, kind="stable"))


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """A CPU tensor never reaches a library: no trace, no load, no
    launch counted."""
    def no_load(self):
        raise AssertionError("a CPU tensor loaded a kernel library")

    monkeypatch.setattr(fr.Variant, "load", no_load)
    monkeypatch.setattr(rf, "fold_variant", lambda *a: pytest.fail(
        "a CPU tensor traced the combine"))
    before = rf.REDUCE_LAUNCHES
    n = 64
    fields = {"v": torch.arange(n, dtype=torch.int64)}  # any dtype
    order = torch.arange(n, dtype=I32)
    out, ov = rf.keyed_fold(lambda a, b: {"v": a["v"] * 2 + b["v"]},
                            fields, order, order // 8, 8)
    assert ov.all() and out["v"].dtype is torch.int64
    out, ov = rf.tree_reduce(lambda a, b: {"v": a["v"] + b["v"]}, fields,
                             torch.ones(n, dtype=torch.bool))
    assert int(out["v"][0]) == n * (n - 1) // 2
    assert rf.prepare(lambda a, b: a, fields) is None
    assert rf.REDUCE_LAUNCHES == before


@pytest.mark.parametrize("rows", [0, 1, 9])
def test_empty_fold_is_what_the_plain_versions_give_for_no_rows(rows):
    """With no row to fold a wrapper launches nothing on a card and
    returns ``empty_fold``: the plain versions' zeros, every row
    invalid, the trailing dimensions and dtypes kept."""
    fields = {"v": torch.zeros(0, dtype=I32),
              "k64": torch.zeros(0, dtype=torch.int64),
              "pair": torch.zeros((0, 2), dtype=I32)}
    none = torch.zeros(0, dtype=I32)
    want, wv = rf.keyed_fold_ref(_combine("sum", torch), fields, none, none,
                                 rows, None, rows)
    got, gv = rf.empty_fold(fields, rows, torch.device("cpu"))
    tree, tv = rf.tree_reduce_ref(_combine("sum", torch), fields,
                                  torch.zeros(0, dtype=torch.bool))
    one, ov = rf.empty_fold(fields, 1, torch.device("cpu"))
    assert torch.equal(gv, wv) and torch.equal(ov, tv) and not ov.any()
    for f in fields:
        assert got[f].dtype is want[f].dtype and one[f].dtype is tree[f].dtype
        assert torch.equal(got[f], want[f]) and torch.equal(one[f], tree[f])


def test_wrappers_check_their_arguments():
    n = 16
    fields = {"v": torch.zeros(n, dtype=I32)}
    good = torch.arange(n, dtype=I32)
    with pytest.raises(WindFlowError, match="order"):
        rf.keyed_fold(_combine("sum", torch), fields, good.long(), good, n)
    with pytest.raises(WindFlowError, match="skeys"):
        rf.keyed_fold(_combine("sum", torch), fields, good, good.float(), n)
    with pytest.raises(WindFlowError, match="output rows"):
        rf.keyed_fold(_combine("sum", torch), fields, good, good, n, None,
                      n - 1)
    with pytest.raises(WindFlowError, match="column 'v'"):
        rf.keyed_fold(_combine("sum", torch), {"v": fields["v"][:8]}, good,
                      good, n)
    with pytest.raises(WindFlowError, match="valid"):
        rf.tree_reduce(_combine("sum", torch), fields, good)


def test_tree_reduce_takes_the_mask_or_the_size():
    """One of ``valid`` and ``size``, the size within the rows."""
    fields = {"v": torch.arange(8, dtype=I32)}
    mask = torch.ones(8, dtype=torch.bool)
    for kw in ({}, {"valid": mask, "size": 8}):
        with pytest.raises(WindFlowError, match="one of them"):
            rf.tree_reduce(_combine("sum", torch), fields, **kw)
    with pytest.raises(WindFlowError, match="size 9 of 8 rows"):
        rf.tree_reduce(_combine("sum", torch), fields, size=9)


SIZE_CASES = [(1, 1, "sum"), (100, 37, "max_n"), (1000, 1000, "mean"),
              (4097, 2049, "sum"), (3000, 1, "mean")]


@pytest.mark.parametrize("n,size,comb", SIZE_CASES,
                         ids=[f"{c}-{n}-{k}" for n, k, c in SIZE_CASES])
def test_tree_reduce_size_matches_jax_masked_tree_reduce(n, size, comb):
    """``size`` stands for the prefix mask (the unfused global reduce's
    batch rows): the same row as JAX's ``masked_tree_reduce`` under
    ``arange(n) < size``."""
    rng = np.random.default_rng(n + size)
    cols = _columns(rng, n, rng.integers(0, 40, n))
    mask = np.arange(n) < size
    want = jax_tree_reduce(_combine(comb, jnp), _j(cols), jnp.asarray(mask))
    got, gv = rf.tree_reduce(_combine(comb, torch), _t(cols), size=size)
    assert gv.numpy().tolist() == [True]
    for f in cols:
        _close(f, got[f].numpy(), want[f],
               CONTRACTED_RTOL if comb == "mean" else 0.0)
    assert int(got["key"][0]) == cols["key"][_tree_source(mask)]


def _fake_lib(seen):
    """A stand-in for a loaded library: records each kernel call's packed
    pointers and ints and writes source row 0 for each output row (the
    pointer after the planes, the gathered columns and their outputs, and
    K7's valid, skeys, order, starts, out_valid or K6's valid, out_valid;
    K7's out_rows rows, K6's one)."""
    import ctypes

    def kernel(name, n_ints, src_after, rows_at):
        def call(p, a, kinds):
            ints = list(a[:n_ints])
            seen.append((name, ints))
            at = 2 * ints[0] + 2 * ints[1] + src_after
            ctypes.memset(p[at], 0, 4 * (1 if rows_at is None
                                         else ints[rows_at]))
            return 0
        return call
    return SimpleNamespace(wf_keyed_fold=kernel("keyed_fold", 11, 5, 5),
                           wf_tree_reduce=kernel("tree_reduce", 6, 2, None),
                           wf_error_string=lambda code: b"")


def _recorded(monkeypatch, name):
    plain, seen = getattr(rf, name), []

    def rec(*a, **k):
        seen.append((a, k))
        return plain(*a, **k)

    monkeypatch.setattr(rf, name, rec)
    return seen


def test_global_reduce_gpu_folds_the_first_size_rows(monkeypatch):
    """The unfused global Reduce_GPU hands K6 the batch's size, not a
    mask tensor."""
    seen = _recorded(monkeypatch, "tree_reduce")
    rng = np.random.default_rng(8)
    blocks = _blocks(rng, 3)
    got = _reduce_graph(_combine("sum", torch), blocks, keyed=False)
    assert int(got["v"].sum()) == sum(int(c["v"].sum()) for c, _, _ in
                                      blocks)
    assert seen and all(len(a) == 2 and set(k) == {"size"} and k["size"] > 0
                        for a, k in seen), seen


def test_keyed_reduce_gpu_ships_each_slots_starts(monkeypatch):
    """The keyed Reduce_GPU hands K7 each slot's first sorted row and the
    longest run, made on the host from its sorted slots."""
    seen = _recorded(monkeypatch, "keyed_fold")
    rng = np.random.default_rng(9)
    _reduce_graph(_combine("sum_key", torch), _blocks(rng, 3))
    assert seen
    for a, _ in seen:
        skeys, n_slots, starts, longest = a[3], a[4], a[7], a[8]
        model = _starts_model(skeys.numpy(), n_slots)
        assert np.array_equal(starts.numpy(), model)
        assert longest == np.diff(model).max()


# ---------------------------------------------------------------------------
# Reduce_GPU on the CPU
# ---------------------------------------------------------------------------
def _reduce_graph(combine, blocks, keyed=True, then_map=False):
    parts = []

    def sink(cols, ts):
        if cols is not None:
            parts.append({k: v.copy() for k, v in cols.items()})

    g = wt.PipeGraph("reduce_fold", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT_TIME, device="cpu")
    red = wt.Reduce_GPU_Builder(combine)
    if keyed:
        red = red.with_key_by("key")
    mp = g.add_source(wt.Columnar_Source_Builder(lambda: iter(blocks))
                      .with_output_batch_size(64).build()).add(red.build())
    if then_map:
        mp.add(wt.Map_GPU_Builder(
            lambda f: {**f, "v": f["v"] * 2 + 1}).build())
    mp.add_sink(wt.Sink_Builder(sink).with_columns().build())
    g.run()
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _blocks(rng, n_blocks, dtype=np.int32):
    out = []
    for b in range(n_blocks):
        keys = rng.integers(0, 11, 64).astype(np.int32)
        cols = {"key": keys, "v": rng.integers(-9, 9, 64).astype(dtype)}
        out.append((cols, np.arange(64, dtype=np.int64) + 64 * b,
                    64 * b + 63))
    return out


@pytest.mark.parametrize("keyed", [True, False])
def test_reduce_gpu_on_cpu_takes_any_combine(keyed):
    """On ``device="cpu"`` the plain versions run any torch combine: an
    int64 column computed with Python control flow on a constant."""
    rng = np.random.default_rng(3)
    blocks = _blocks(rng, 4, np.int64)

    def comb(a, b):
        scale = 2 if a["v"].dtype is torch.int64 else 1
        return {"v": (a["v"] + b["v"]) * scale // scale}

    got = _reduce_graph(comb, blocks, keyed)
    assert got["v"].dtype == np.int64
    want = sum(int(c["v"].sum()) for c, _, _ in blocks)
    assert int(got["v"].sum()) == want


def test_reduce_padding_rows_are_read_by_nothing(monkeypatch):
    """A keyed Reduce_GPU's output batch holds one row a key and padding
    rows up to its bucket capacity (zeros on a card, the last fold's in
    the JAX package). Garbage there changes no row of a device operator
    behind it or of the sink."""
    rng = np.random.default_rng(4)
    blocks = _blocks(rng, 5)
    comb = _combine("sum_key", torch)
    want = _reduce_graph(comb, blocks, then_map=True)
    plain = rf.keyed_fold

    def scribbled(*a, **k):
        out, ov = plain(*a, **k)
        pad = ~ov
        return ({f: torch.where(pad, torch.full_like(t, -12345), t)
                 for f, t in out.items()}, ov)

    monkeypatch.setattr(rf, "keyed_fold", scribbled)
    got = _reduce_graph(comb, blocks, then_map=True)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.sort(got[k]), np.sort(want[k])), k


def _fused_keyed_graph(blocks, fusion):
    """src -> map -> filter -> keyed Reduce -> sink, the device trio built
    with chain() so it fuses when ``fusion`` is on; the sink's rows."""
    parts = []

    def sink(cols, ts):
        if cols is not None:
            parts.append({k: v.copy() for k, v in cols.items()})

    g = wt.PipeGraph("reduce_fold_fused", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT_TIME, device="cpu", fusion=fusion)
    g.add_source(wt.Columnar_Source_Builder(lambda: iter(blocks))
                 .with_output_batch_size(64).build()) \
        .add(wt.Map_GPU_Builder(lambda f: {**f, "v": f["v"] * 3})
             .build()) \
        .chain(wt.Filter_GPU_Builder(lambda f: f["v"] % 2 == 0).build()) \
        .chain(wt.Reduce_GPU_Builder(_combine("sum_key", torch))
               .with_key_by("key").build()) \
        .add_sink(wt.Sink_Builder(sink).with_columns().build())
    g.run()
    kinds = {o["kind"] for o in g.get_stats()["Operators"]}
    assert ("Fused_GPU_Chain" in kinds) == fusion, kinds
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def test_fused_keyed_exit_folds_into_the_slots_bucket(monkeypatch):
    """The fused keyed exit folds into a buffer of its slots' capacity
    bucket, as the unfused replica does, not one of the batch's rows; its
    rows equal the unfused run's."""
    rng = np.random.default_rng(5)
    blocks = _blocks(rng, 5)
    want = _fused_keyed_graph(blocks, False)
    plain, seen = rf.keyed_fold, []

    def recorded(*a, **k):
        seen.append((a[4], a[6]))
        return plain(*a, **k)

    monkeypatch.setattr(rf, "keyed_fold", recorded)
    got = _fused_keyed_graph(blocks, True)
    assert seen and all(rows == bucket_capacity(n_slots) < 64
                        for n_slots, rows in seen), seen
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.sort(got[k]), np.sort(want[k])), k


# ---------------------------------------------------------------------------
# the kernels built for the host
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def host_results(tmp_path_factory):
    """Each case of ``torch_kernel_host.CASES``: the fieldwise library
    built for the host stand-in, its kernels run in a child process."""
    if shutil.which("g++") is None:
        pytest.skip("the host build of the kernels needs g++")
    lib = kh.build_host_library((KERNELS / "forest_rebuild.cu").read_text(),
                                tmp_path_factory.mktemp("host_kernels"))
    res = subprocess.run([sys.executable, str(Path(kh.__file__)), str(lib)],
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", sorted(kh.CASES))
def test_host_built_kernels_match_their_plain_versions(host_results, case):
    """K7 (tiles, the look-back, Options, sentinel and gap rows, the
    source rows), K6 (one and two levels, a ragged capacity) and K2+K3
    (the shared tiled fold), and a K7 launch between two K2+K3 launches
    on one scratch: equal to the plain versions."""
    assert host_results[case] is True
