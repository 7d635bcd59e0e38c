"""Keyed device state in the port: stateful ``Map_GPU`` / ``Filter_GPU``
(``windflow_tpu_torch/gpu/ops_gpu.py``: the grid scan ``grid_scan_core``
and its engine ``_KeyedStateScan``) held against the JAX package's
``Map_TPU`` / ``Filter_TPU`` built ``with_state``, on its CPU backend.

Each case builds the same graph (or replica) through both packages with
twin user functions (``jnp`` and ``torch``) on one numpy stream made from
a seed. Tolerance: EXACT for int32 and float32 states alike — each key's
fold runs in arrival order in both packages, one row per step, so the
float32 additions happen in the same order. Row sequences are compared at
parallelism 1 with block-aligned columnar input; above 1, per-key values.
The state tables, slot maps and dirty bitmaps are compared at replica
level, where both engines see the same batches."""

import threading
from collections import defaultdict
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.tpu import Filter_TPU_Builder, Map_TPU_Builder
from windflow_tpu.tpu import keymap as keymap_j
from windflow_tpu.tpu.batch import BatchTPU
from windflow_tpu.tpu.ops_tpu import Filter_TPU, Map_TPU
from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
from windflow_tpu_torch.convert import scan_state_from_jax
from windflow_tpu_torch.gpu import keymap as keymap_t
from windflow_tpu_torch.gpu.batch import BatchGPU
from windflow_tpu_torch.gpu.ops_gpu import Filter_GPU, Map_GPU
from windflow_tpu_torch.gpu.schema import TupleSchema
from windflow_tpu_torch.kernels.grid_scan import grid_of

from common import TupleT, make_ingress_source

BATCH = 32


def _ops(pkg):
    if pkg is wj:
        return SimpleNamespace(Map=Map_TPU_Builder, Filter=Filter_TPU_Builder,
                               kw={}, maximum=jnp.maximum, i32=jnp.int32)
    return SimpleNamespace(Map=wt.Map_GPU_Builder,
                           Filter=wt.Filter_GPU_Builder, kw={"device": "cpu"},
                           maximum=torch.maximum, i32=np.int32)


def _running_sum(row, state):
    s2 = {"total": state["total"] + row["value"]}
    return {**row, "value": s2["total"]}, s2


def _count_step(row, state):
    s2 = {"n": state["n"] + 1}
    return {**row, "value": s2["n"]}, s2


def _running_max_pred(o):
    def pred(row, state):
        # keep only values strictly greater than the running max
        keep = row["value"] > state["mx"]
        return keep, {"mx": o.maximum(state["mx"], row["value"])}
    return pred


def _blocks(n_blocks, seed, n_keys, batch=BATCH, float_w=False):
    """(cols, ts, wm) blocks of ``batch`` rows: int32 key and value (and a
    float32 weight)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        cols = {"key": rng.integers(0, n_keys, batch).astype(np.int32),
                "value": rng.integers(0, 100, batch).astype(np.int32)}
        if float_w:
            cols["w"] = rng.standard_normal(batch).astype(np.float32)
        ts = b * batch + np.arange(batch, dtype=np.int64)
        out.append((cols, ts, int(ts[0])))
    return out


def _run_cols(pkg, make_op, blocks, batch=BATCH):
    """Columnar source -> the op -> columnar sink at parallelism 1; the
    sink's rows in arrival order (columns concatenated) and the graph."""
    o = _ops(pkg)
    g = pkg.PipeGraph("state", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT_TIME, **o.kw)
    out, lock = [], threading.Lock()

    def sink(cols, ts):
        if cols is not None:
            with lock:
                out.append(({k: np.array(v) for k, v in cols.items()},
                            np.array(ts)))

    g.add_source(pkg.Columnar_Source_Builder(lambda: iter(blocks))
                 .with_output_batch_size(batch).build()) \
        .add(make_op(o).build()) \
        .add_sink(pkg.Sink_Builder(sink).with_columns().build())
    run_bounded(g)
    names = sorted(out[0][0])
    rows = {k: np.concatenate([c[k] for c, _ in out]) for k in names}
    rows["ts"] = np.concatenate([t for _, t in out])
    return rows, g


def _assert_same_rows(ref, got):
    assert ref.keys() == got.keys() and len(ref["ts"]) > 0
    for k in ref:
        assert ref[k].dtype == got[k].dtype, k
        assert np.array_equal(ref[k], got[k]), k


def _run_rows(pkg, make_op, src_fn, src_par, batch, sink_key="key"):
    """Row source (``common`` generators) -> op -> row sink: per key, the
    list of values the sink saw (sorted: arrival order across replicas
    follows scheduling)."""
    o = _ops(pkg)
    g = pkg.PipeGraph("state_rows", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **o.kw)
    seen, lock = defaultdict(list), threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                seen[int(getattr(t, sink_key))].append(int(t.value))

    g.add_source(pkg.Source_Builder(src_fn).with_parallelism(src_par)
                 .with_output_batch_size(batch).build()) \
        .add(make_op(o).build()) \
        .add_sink(pkg.Sink_Builder(sink).build())
    run_bounded(g)
    return {k: sorted(v) for k, v in seen.items()}


# ---------------------------------------------------------------------------
# the stateful cases of test_tpu_ops.py, through both packages' graphs
# ---------------------------------------------------------------------------
def test_running_sum_matches_jax():
    """``test_tpu_ops.py:97``: a per-key running sum at parallelism 2 on
    both sides; every key's outputs are its prefix sums (exact, int32)."""
    def mk(o):
        return (o.Map(_running_sum).with_key_by(lambda t: t.key)
                .with_state({"total": o.i32(0)}).with_parallelism(2))
    src = make_ingress_source(6, 64)
    ref = _run_rows(wj, mk, src, 2, 8)
    got = _run_rows(wt, mk, src, 2, 8)
    assert got == ref
    prefix = np.cumsum(np.arange(1, 65)).tolist()
    assert got == {k: prefix for k in range(6)}


def test_running_sum_rows_match_jax_in_order():
    """Block-aligned columnar input at parallelism 1: the row sequences
    (every column, ts included) are equal."""
    blocks = _blocks(10, seed=3, n_keys=7)

    def mk(o):
        return (o.Map(_running_sum).with_key_by("key")
                .with_state({"total": o.i32(0)}))
    _assert_same_rows(_run_cols(wj, mk, blocks)[0],
                      _run_cols(wt, mk, blocks)[0])


def test_dedup_filter_matches_jax_both_streams():
    """``test_tpu_ops.py:196``: the running-max predicate passes a monotone
    stream whole (parallelism 2) and drops the non-increasing values of an
    up/down stream."""
    def mk(o):
        return (o.Filter(_running_max_pred(o)).with_key_by(lambda t: t.key)
                .with_state({"mx": o.i32(0)}).with_parallelism(2))
    src = make_ingress_source(4, 40)
    ref = _run_rows(wj, mk, src, 2, 16)
    got = _run_rows(wt, mk, src, 2, 16)
    assert got == ref == {k: list(range(1, 41)) for k in range(4)}

    def updown(shipper, ctx):
        for v in [1, 5, 3, 7, 7, 2, 9]:
            shipper.push(TupleT(0, v))

    def mk1(o):
        return (o.Filter(_running_max_pred(o)).with_key_by(lambda t: t.key)
                .with_state({"mx": o.i32(0)}))
    outs = {}
    for pkg in (wj, wt):
        o, seen = _ops(pkg), []
        g = pkg.PipeGraph("updown", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.INGRESS_TIME, **o.kw)
        g.add_source(pkg.Source_Builder(updown).with_output_batch_size(4)
                     .build()) \
            .add(mk1(o).build()) \
            .add_sink(pkg.Sink_Builder(
                lambda t: seen.append(t.value) if t else None).build())
        run_bounded(g)
        outs[pkg.__name__] = seen
    assert outs["windflow_tpu_torch"] == outs["windflow_tpu"] == [1, 5, 7, 9]


def test_stateful_filter_rows_match_jax_in_order():
    blocks = _blocks(8, seed=5, n_keys=5)

    def mk(o):
        return (o.Filter(_running_max_pred(o)).with_key_by("key")
                .with_state({"mx": o.i32(0)}))
    ref, gj = _run_cols(wj, mk, blocks)
    got, gt = _run_cols(wt, mk, blocks)
    _assert_same_rows(ref, got)
    ign = [sum(r["Inputs_ignored"] for r in g.get_stats()["Operators"][1]
               ["replicas"]) for g in (gj, gt)]
    assert ign[0] == ign[1] > 0


def test_deep_keys_match_jax():
    """``test_tpu_ops.py:249``: two keys, 500 rows each in 64-row batches:
    M (the most rows of one key in a batch) is large."""
    def mk(o):
        return (o.Map(_count_step).with_key_by(lambda t: t.key)
                .with_state({"n": o.i32(0)}))
    src = make_ingress_source(2, 500)
    ref = _run_rows(wj, mk, src, 1, 64)
    got = _run_rows(wt, mk, src, 1, 64)
    assert got == ref == {0: list(range(1, 501)), 1: list(range(1, 501))}
    blocks = _blocks(4, seed=8, n_keys=2, batch=64)
    _assert_same_rows(_run_cols(wj, lambda o: o.Map(_count_step)
                                .with_key_by("key")
                                .with_state({"n": o.i32(0)}), blocks, 64)[0],
                      _run_cols(wt, lambda o: o.Map(_count_step)
                                .with_key_by("key")
                                .with_state({"n": o.i32(0)}), blocks, 64)[0])


def test_table_growth_matches_jax():
    """``test_tpu_ops.py:278``: 200 keys grow the 64-row table twice; no
    key's state is lost in the copy."""
    def mk(o):
        return (o.Map(_count_step).with_key_by(lambda t: t.key)
                .with_state({"n": o.i32(0)}))
    src = make_ingress_source(200, 20)
    ref = _run_rows(wj, mk, src, 2, 32)
    got = _run_rows(wt, mk, src, 2, 32)
    assert got == ref == {k: list(range(1, 21)) for k in range(200)}


@pytest.mark.parametrize("init", ["int64", "float64", "py_int", "bare_f32"])
def test_state_dtypes_canonicalized_like_jax(init):
    """x64 off in the JAX package: an int64 / float64 initial state gives
    an int32 / float32 table, a Python int an int32 one, and a bare
    float32 scalar state a one-leaf table. The port canonicalizes the same
    way, so the outputs' dtypes and values (float32: exact) are equal."""
    blocks = _blocks(6, seed=12, n_keys=4, float_w=True)
    if init == "bare_f32":
        def mk(o):
            return (o.Map(lambda r, s: ({**r, "w": s + r["w"]}, s + r["w"]))
                    .with_key_by("key").with_state(np.float32(0)))
    else:
        s0 = {"int64": np.int64(0), "float64": np.float64(0.5),
              "py_int": 0}[init]

        def mk(o):
            return (o.Map(lambda r, s: (
                {**r, "value": r["value"] + s["acc"], "w": r["w"] * 2},
                {"acc": s["acc"] + r["value"]}))
                .with_key_by("key").with_state({"acc": s0}))
    ref, gj = _run_cols(wj, mk, blocks)
    got, gt = _run_cols(wt, mk, blocks)
    _assert_same_rows(ref, got)
    tj = gj._stages[1].first_op.replicas[0].engine.snapshot_state()["table"]
    tt = gt._stages[1].first_op.replicas[0].engine.snapshot_state()["table"]
    for a, b in zip(_leaves(tj), _leaves(tt)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _leaves(table):
    if isinstance(table, dict):
        return [np.asarray(table[k]) for k in sorted(table)]
    return [np.asarray(table)]


# ---------------------------------------------------------------------------
# replica level: tables, slot maps, dirty bitmaps, snapshots
# ---------------------------------------------------------------------------
class _Collect:
    """Emitter stand-in: the emitted rows, in order."""

    def __init__(self, to_host):
        self.to_host = to_host
        self.rows = []

    def set_stats(self, stats):
        pass

    def emit_device_batch(self, b):
        cols = {k: np.asarray(v)[:b.size] for k, v in self.to_host(b).items()}
        for i in range(b.size):
            self.rows.append(tuple(cols[n][i].item() for n in sorted(cols)))

    def propagate_punctuation(self, wm):
        pass

    def flush(self):
        pass


def _replica(pkg, kind, func, state_init, tiering=None):
    if pkg == "jax":
        cls = Map_TPU if kind == "map" else Filter_TPU
        op = cls(func, name=f"s{kind}", key_extractor="key",
                 state_init=state_init, tiering=tiering)
        to_host = lambda b: {k: np.asarray(v) for k, v in b.fields.items()}
    else:
        cls = Map_GPU if kind == "map" else Filter_GPU
        op = cls(func, name=f"s{kind}", key_extractor="key",
                 state_init=state_init, tiering=tiering)
        to_host = lambda b: b.host_columns()
    op.build_replicas()  # the port's operators default to the CPU device
    rep = op.replicas[0]
    rep.set_emitter(_Collect(to_host))
    return rep


def _feed(rep, blocks):
    jax_side = isinstance(rep.op, (Map_TPU, Filter_TPU))
    for cols, ts, wm in blocks:
        n = len(ts)
        cap = 1 << max(3, (n - 1).bit_length())
        pad = lambda a: np.concatenate([a, np.zeros(cap - n, a.dtype)])
        dts = {k: v.dtype for k, v in cols.items()}
        keys = cols["key"].astype(np.int64)
        if jax_side:
            import jax
            b = BatchTPU({k: jax.device_put(pad(v)) for k, v in cols.items()},
                         pad(ts), n, SchemaJ(dts), wm, host_keys=keys)
        else:
            b = BatchGPU({k: torch.from_numpy(pad(v)) for k, v in
                          cols.items()}, pad(ts), n, TupleSchema(dts), wm,
                         host_keys=keys)
        rep.handle_msg(0, b)
    rep.dispatch.drain()


def _engine_view(rep):
    """(slot map, capacity, table leaves, dirty bits) of an engine, host."""
    eng = rep.engine
    cap = eng.table_capacity
    snap = eng.snapshot_state()
    dirty = np.asarray(eng.dirty)[:cap].astype(bool)
    return snap["slot_of_key"], cap, _leaves(snap["table"]), dirty


def _assert_same_engine(jrep, trep):
    sj, cj, tj, dj = _engine_view(jrep)
    st, ct, tt, dt = _engine_view(trep)
    assert sj == st and cj == ct
    for a, b in zip(tj, tt):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(dj, dt) and dj.any()


@pytest.mark.parametrize("n_keys", [5, 300], ids=["bincount", "unique"])
def test_grid_meta_matches_jax(n_keys):
    """The host grid assembly: the same grid positions, touched rows and
    (M, KB) on both sides, through the bincount path (table near batch
    size) and the ``np.unique`` path (table far larger than the batch).
    The port's host prep gives the rows grouped by key (``KeyRows``); its
    plain version's grid comes from them (``grid_of``)."""
    jrep = _replica("jax", "map", _running_sum, {"total": jnp.int32(0)})
    trep = _replica("torch", "map", _running_sum, {"total": np.int32(0)})
    blocks = _blocks(6, seed=21, n_keys=n_keys, batch=24)
    _feed(jrep, blocks[:3])
    _feed(trep, blocks[:3])
    for cols, ts, wm in blocks[3:]:
        keys = cols["key"].astype(np.int64)
        bj = SimpleNamespace(size=len(ts), capacity=32, host_keys=keys)
        mj = jrep.engine.grid_meta(bj)
        rows = trep.engine.grid_meta(bj)
        KB = len(rows.touched)
        grid_idx, tmask, M = grid_of(rows._replace(
            order=torch.from_numpy(rows.order),
            starts=torch.from_numpy(rows.starts),
            touched=torch.from_numpy(rows.touched)), bj.capacity)
        mt = (grid_idx.numpy(), np.arange(bj.capacity) < rows.walked,
              rows.touched, tmask.numpy(), M, KB)
        assert len(mj) == len(mt)
        for a, b in zip(mj, mt):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    if n_keys == 300:
        assert trep.engine.table_capacity > 4 * 24  # the np.unique path


def test_tables_and_dirty_bitmap_match_jax():
    """After the same batches the two engines hold the same slot map,
    capacity, table values and dirty bitmap (every touched slot set, the
    rest clear), growth included."""
    jrep = _replica("jax", "map", _running_sum, {"total": jnp.int32(0)})
    trep = _replica("torch", "map", _running_sum, {"total": np.int32(0)})
    blocks = _blocks(9, seed=4, n_keys=90)
    _feed(jrep, blocks)
    _feed(trep, blocks)
    assert jrep.emitter.rows == trep.emitter.rows
    _assert_same_engine(jrep, trep)
    assert trep.engine.table_capacity == 128  # grew from 64
    # the dirty rows a delta snapshot would ship
    rj, rt = jrep.engine._dirty_rows(), trep.engine._dirty_rows()
    assert np.array_equal(rj["slots"], rt["slots"]) and len(rt["slots"])
    assert all(np.array_equal(a, b)
               for a, b in zip(rj["leaves"], rt["leaves"]))


def test_filter_dirty_bitmap_matches_jax():
    pj = _running_max_pred(_ops(wj))
    pt = _running_max_pred(_ops(wt))
    jrep = _replica("jax", "filter", pj, {"mx": jnp.int32(0)})
    trep = _replica("torch", "filter", pt, {"mx": np.int32(0)})
    blocks = _blocks(6, seed=6, n_keys=40)
    _feed(jrep, blocks[:3])
    _feed(trep, blocks[:3])
    assert jrep.emitter.rows == trep.emitter.rows
    _assert_same_engine(jrep, trep)


@pytest.mark.parametrize("kind", ["map", "filter"])
def test_state_carried_from_jax_snapshot(kind):
    """A JAX stateful replica runs N batches; its ``snapshot_state`` goes
    through ``convert.scan_state_from_jax`` into a fresh port replica; both
    run M more batches: the rows after the carry are equal."""
    blocks = _blocks(10, seed=9, n_keys=70)
    if kind == "map":
        fj = ft = _running_sum
        s0j, s0t = {"total": jnp.int32(0)}, {"total": np.int32(0)}
    else:
        fj, ft = _running_max_pred(_ops(wj)), _running_max_pred(_ops(wt))
        s0j, s0t = {"mx": jnp.int32(0)}, {"mx": np.int32(0)}
    jrep = _replica("jax", kind, fj, s0j)
    _feed(jrep, blocks[:5])
    snap = jrep.snapshot_state()
    jrep.emitter.rows.clear()
    trep = _replica("torch", kind, ft, s0t)
    trep.restore_state({"cur_wm": snap["cur_wm"],
                        "scan": scan_state_from_jax(snap["scan"], "cpu")})
    assert trep.cur_wm == jrep.cur_wm
    _feed(jrep, blocks[5:])
    _feed(trep, blocks[5:])
    assert trep.emitter.rows == jrep.emitter.rows and trep.emitter.rows
    sj, cj, tj, _ = _engine_view(jrep)
    st, ct, tt, _ = _engine_view(trep)
    assert (sj, cj) == (st, ct)
    assert all(np.array_equal(a, b) for a, b in zip(tj, tt))


def test_port_snapshot_restores_into_port():
    """The port's own snapshot (host numpy, the JAX layout) restores into a
    fresh port replica that continues like the original."""
    blocks = _blocks(8, seed=13, n_keys=20)
    a = _replica("torch", "map", _running_sum, {"total": np.int32(0)})
    _feed(a, blocks[:4])
    snap = a.snapshot_state()
    b = _replica("torch", "map", _running_sum, {"total": np.int32(0)})
    b.restore_state(snap)
    a.emitter.rows.clear()
    _feed(a, blocks[4:])
    _feed(b, blocks[4:])
    assert a.emitter.rows == b.emitter.rows


def test_grid_cell_index_guarded_within_int32():
    """One key holding 32,769 rows of a 65,536-row batch and 32,767 keys
    with one row each: KB = 32,768 x M = 65,536 = 2^31 cells, no scratch
    cell left inside int32. The port's plain version refuses before any
    allocation, naming M and KB (the JAX package's int32 grid indices
    wrap there: ROADMAP Queue 3); the host prep gives the rows, which
    K8's kernel indexes without a grid."""
    trep = _replica("torch", "map", _count_step, {"n": np.int32(0)})
    keys = np.concatenate([np.zeros(32_769, np.int64),
                           np.arange(1, 32_768, dtype=np.int64)])
    batch = SimpleNamespace(size=len(keys), capacity=len(keys),
                            host_keys=keys)
    rows = trep.engine.prep(batch)
    assert (rows.M, len(rows.touched)) == (65_536, 32_768)
    with pytest.raises(wt.WindFlowError, match=r"KB=32768 .*M=65536"):
        grid_of(rows, len(keys))
    # one row fewer of the deep key: M = 32,768 fits
    batch2 = SimpleNamespace(size=65_535, capacity=65_536,
                             host_keys=keys[1:])
    rows2 = trep.engine.grid_meta(batch2)
    assert (rows2.M, len(rows2.touched)) == (32_768, 32_768)


def test_refusals_match_jax():
    with pytest.raises(wt.WindFlowError, match="with_key_by"):
        wt.Map_GPU_Builder(_count_step).with_state({"n": 0}).build()
    with pytest.raises(wt.WindFlowError, match="with_state"):
        wt.Filter_GPU_Builder(lambda f: f).with_tiering().build()
    with pytest.raises(wt.WindFlowError, match="KEYBY"):
        Map_GPU(_count_step, state_init={"n": 0})
    with pytest.raises(wt.WindFlowError, match="with_tiering requires"):
        Filter_GPU(lambda f: f, key_extractor="key",
                   tiering=wt.TierConfig())
    op = Map_GPU(_count_step, key_extractor="key", state_init={"n": 0})
    assert op.input_routing is wt.RoutingMode.KEYBY
    with pytest.raises(wt.WindFlowError, match="grid-scan engine"):
        op.device_kernel()
    assert not hasattr(wt.Reduce_GPU_Builder(lambda a, b: a), "with_state")
    assert not hasattr(wj.tpu.Reduce_TPU_Builder(lambda a, b: a),
                       "with_state")


# ---------------------------------------------------------------------------
# the host key helpers the grid assembly rests on equal the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keymap_helpers_equal_jax(seed):
    rng = np.random.default_rng(seed)
    n_groups = [5, 40_000, 3][seed]
    slots = rng.integers(0, n_groups, 500)
    for a, b in zip(keymap_j.group_positions(slots, n_groups),
                    keymap_t.group_positions(slots, n_groups)):
        assert np.array_equal(a, b)
    assert np.array_equal(keymap_j.stable_group_argsort(slots, n_groups),
                          keymap_t.stable_group_argsort(slots, n_groups))
    keys = rng.integers(-50, 50, 64)
    assert (keymap_j.distinct_batch_keys(keys, keys, 60)
            == keymap_t.distinct_batch_keys(keys, keys, 60))
    skeys = [f"k{k}" for k in keys]
    assert (keymap_j.distinct_batch_keys(skeys, np.asarray(skeys), 60)
            == keymap_t.distinct_batch_keys(skeys, np.asarray(skeys), 60))
