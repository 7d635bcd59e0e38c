"""The port's replayable columnar ingest (``Columnar_Source`` with
``block_size`` / ``schema``, ``ArrayBlockSource``, ``arrow_block_source``)
against ``tests/test_columnar_ingest.py`` and the JAX package.

The block path must give the row path's output at the sink, the same
values in the same order on a FORWARD edge and the same per-key order
under KEYBY, in the port and in the JAX package (its ``Map_TPU`` on its
CPU backend) on one seeded numpy stream. A re-chunked yield is one cursor
step: a barrier requested between its chunks lands at the next yield, so
a restore never emits the leading chunks twice. A supervised block
source that crashes mid-stream replays through an exactly-once sink to
the crash-free run's output.
"""

from __future__ import annotations

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from windflow_tpu.tpu import Map_TPU_Builder
from windflow_tpu_torch.checkpoint import CheckpointStore
from windflow_tpu_torch.operators.source import ColumnarSourceReplica
from windflow_tpu_torch.sinks.transactional import read_committed_records

from torch_waits import run_bounded

N = 4000
RNG = np.random.default_rng(7)
VALS = RNG.integers(-1_000_000, 1_000_000, N).astype(np.int64)
KEYS = RNG.integers(0, 13, N).astype(np.int64)


def _pkg(which):
    if which == "jax":
        return SimpleNamespace(pkg=wj, Map=Map_TPU_Builder, kw={})
    return SimpleNamespace(pkg=wt, Map=wt.Map_GPU_Builder,
                           kw={"device": "cpu"})


class ColumnCollector:
    def __init__(self):
        self._lock = threading.Lock()
        self.calls = []

    def sink(self, cols, ts):
        if cols is None:
            return
        with self._lock:
            self.calls.append({k: np.array(v) for k, v in cols.items()})

    def col(self, name):
        return (np.concatenate([c[name] for c in self.calls])
                if self.calls else np.array([], dtype=np.int64))


def _run(which, make_source, keyed=False, batch=256):
    p = _pkg(which)
    coll = ColumnCollector()
    g = p.pkg.PipeGraph("col_ingest", p.pkg.ExecutionMode.DEFAULT,
                        p.pkg.TimePolicy.INGRESS_TIME, **p.kw)
    m = p.Map(lambda f: {"key": f["key"], "v": f["v"] * 3 + 1})
    if keyed:
        m = m.with_key_by("key").with_parallelism(2)
    g.add_source(make_source(p.pkg).with_name("src")
                 .with_output_batch_size(batch).build()) \
        .add(m.build()) \
        .add_sink(p.pkg.Sink_Builder(coll.sink).with_columns().build())
    run_bounded(g)
    src_rep = [o for o in g.get_stats()["Operators"]
               if o["name"] == "src"][0]["replicas"][0]
    return coll, src_rep


def _row_source(pkg):
    def src(shipper):
        for k, v in zip(KEYS, VALS):
            shipper.push({"key": int(k), "v": int(v)})
    return pkg.Source_Builder(src)


def _block_source(block_size=300):
    return lambda pkg: pkg.Columnar_Source_Builder(
        pkg.ArrayBlockSource({"key": KEYS, "v": VALS},
                             block_size=block_size))


# ---------------------------------------------------------------------------
# row-vs-block differentials
# ---------------------------------------------------------------------------
def test_forward_differential_byte_identical():
    """FORWARD at parallelism 1: the exact value sequence at the sink, row
    vs block (a block size dividing neither the stream nor the staging
    batch), in the port and the JAX package."""
    row, _ = _run("port", _row_source)
    blk, src_rep = _run("port", _block_source(300))
    jblk, _ = _run("jax", _block_source(300))
    model = VALS * 3 + 1
    for c in (row, blk, jblk):
        assert np.array_equal(c.col("v"), model)
        assert np.array_equal(c.col("key"), KEYS)
    assert src_rep["Ingest_blocks"] == -(-N // 300)  # the block path ran
    assert src_rep["Ingest_rows"] == N


def test_keyby_differential_per_key_order_and_sums():
    """KEYBY at parallelism 2: per-key order and totals equal the row path
    and the JAX package's (cross-key interleave is scheduling)."""
    row, _ = _run("port", _row_source, keyed=True)
    blk, src_rep = _run("port", _block_source(300), keyed=True)
    jblk, _ = _run("jax", _block_source(300), keyed=True)
    assert src_rep["Ingest_blocks"] > 0

    def per_key(coll):
        keys, vs = coll.col("key"), coll.col("v")
        return {int(k): vs[keys == k] for k in np.unique(keys)}

    a, b, c = per_key(row), per_key(blk), per_key(jblk)
    assert set(a) == set(b) == set(c) == set(int(k) for k in np.unique(KEYS))
    for k in a:
        model = VALS[KEYS == k] * 3 + 1
        assert np.array_equal(a[k], model), f"row path diverged at {k}"
        assert np.array_equal(b[k], model), f"block path diverged at {k}"
        assert np.array_equal(c[k], model), f"JAX diverged at {k}"


def test_partial_block_flush_on_eos():
    """A stream that is no multiple of the block or batch size: the staged
    remainder flushes at EOS, nothing truncated, nothing padded in."""
    vals = np.arange(1000, dtype=np.int64)
    got = {}
    for which in ("port", "jax"):
        p = _pkg(which)
        coll = ColumnCollector()
        g = p.pkg.PipeGraph("partial", p.pkg.ExecutionMode.DEFAULT,
                            p.pkg.TimePolicy.INGRESS_TIME, **p.kw)
        g.add_source(p.pkg.Columnar_Source_Builder(
            p.pkg.ArrayBlockSource({"key": vals % 3, "v": vals},
                                   block_size=512))
            .with_output_batch_size(384).build()) \
            .add(p.Map(lambda f: {"v": f["v"] + 1}).build()) \
            .add_sink(p.pkg.Sink_Builder(coll.sink).with_columns().build())
        run_bounded(g)
        got[which] = coll.col("v")
    assert np.array_equal(got["port"], vals + 1)
    assert np.array_equal(got["jax"], vals + 1)


# ---------------------------------------------------------------------------
# block re-chunking and the schema
# ---------------------------------------------------------------------------
def test_with_block_size_rechunks_oversized_yields():
    vals = np.arange(1000, dtype=np.int64)

    def func():
        yield {"v": vals}  # one oversized block

    for which in ("port", "jax"):
        p = _pkg(which)
        coll = ColumnCollector()
        g = p.pkg.PipeGraph("rechunk", p.pkg.ExecutionMode.DEFAULT,
                            p.pkg.TimePolicy.INGRESS_TIME, **p.kw)
        g.add_source(p.pkg.Columnar_Source_Builder(func).with_name("src")
                     .with_block_size(256).with_output_batch_size(256)
                     .build()) \
            .add(p.Map(lambda f: {"v": f["v"]}).build()) \
            .add_sink(p.pkg.Sink_Builder(coll.sink).with_columns().build())
        run_bounded(g)
        assert np.array_equal(coll.col("v"), vals)
        src_rep = [o for o in g.get_stats()["Operators"]
                   if o["name"] == "src"][0]["replicas"][0]
        assert src_rep["Ingest_blocks"] == 4  # 256+256+256+232
        with pytest.raises(p.pkg.WindFlowError, match="block size"):
            p.pkg.Columnar_Source_Builder(func).with_block_size(0)
        with pytest.raises(p.pkg.WindFlowError, match="non-empty"):
            p.pkg.Columnar_Source_Builder(func).with_schema({})


def test_block_size_is_an_argument():
    """The JAX package's ``WF_INGEST_BLOCK_ROWS`` is the port's
    ``block_size`` argument: the port reads no environment variable."""
    op = wt.Columnar_Source(lambda: iter(()), block_size=128)
    assert op.block_size == 128
    assert wt.Columnar_Source(lambda: iter(())).block_size == 0


def test_schema_canonicalizes_dtype_at_edge():
    def func():
        yield {"v": np.arange(64, dtype=np.float64)}  # the wrong dtype

    for which in ("port", "jax"):
        p = _pkg(which)
        coll = ColumnCollector()
        g = p.pkg.PipeGraph("schema", p.pkg.ExecutionMode.DEFAULT,
                            p.pkg.TimePolicy.INGRESS_TIME, **p.kw)
        g.add_source(p.pkg.Columnar_Source_Builder(func)
                     .with_schema({"v": np.int32})
                     .with_output_batch_size(64).build()) \
            .add(p.Map(lambda f: {"v": f["v"] * 2}).build()) \
            .add_sink(p.pkg.Sink_Builder(coll.sink).with_columns().build())
        run_bounded(g)
        got = coll.col("v")
        assert got.dtype in (np.int32, np.int64)  # cast, not float
        assert np.array_equal(np.sort(got), np.arange(64) * 2)


def test_array_block_source_cursor_and_refusals():
    src = wt.ArrayBlockSource({"a": np.arange(10)}, ts=np.arange(10) * 5,
                              block_size=4)
    it = src()
    cols, ts = next(it)
    assert src.snapshot_position() == 0  # advances after the yield
    assert np.array_equal(cols["a"], np.arange(4))
    next(it)
    assert src.snapshot_position() == 4
    src.restore(8)
    assert [len(c["a"]) for c, _ in src()] == [2]
    for bad, match in (
            (lambda: wt.ArrayBlockSource({"a": [1]}, block_size=0),
             "block_size"),
            (lambda: wt.ArrayBlockSource({"a": [1, 2], "b": [1]}),
             "ragged"),
            (lambda: wt.ArrayBlockSource({"a": [1, 2]}, ts=[1]),
             "ts length")):
        with pytest.raises(wt.WindFlowError, match=match):
            bad()


def test_arrow_block_source_matches_jax():
    pa = pytest.importorskip("pyarrow")
    table = pa.table({"key": KEYS, "v": VALS,
                      "ts": np.arange(N, dtype=np.int64) * 10})
    got = {}
    for which, pkg in (("port", wt), ("jax", wj)):
        src = pkg.arrow_block_source(table, ts_column="ts", block_size=512)
        got[which] = list(src())
    assert len(got["port"]) == len(got["jax"]) == -(-N // 512)
    for (pc, pts), (jc, jts) in zip(got["port"], got["jax"]):
        assert pc.keys() == jc.keys() == {"key", "v"}
        assert all(np.array_equal(pc[k], jc[k]) for k in pc)
        assert np.array_equal(pts, jts)


def test_columnar_functor_bad_yield_raises():
    def func():
        yield [1, 2, 3]  # neither a cols dict nor a tuple

    g = wt.PipeGraph("bad", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.INGRESS_TIME, device="cpu")
    g.add_source(wt.Columnar_Source_Builder(func).build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    with pytest.raises(wt.WindFlowError, match="yield"):
        run_bounded(g)


# ---------------------------------------------------------------------------
# a barrier requested between the chunks of one yield
# ---------------------------------------------------------------------------
class _Crash(Exception):
    pass


class _BigYields:
    """Replayable functor of three 1,000-row yields (values 0..2999), a
    cursor of whole yields. With ``crash_store`` it waits (bounded) for
    the first checkpoint to commit there, then dies before yield 3."""

    def __init__(self, crash_store=None):
        self.pos = 0
        self.crash_store = crash_store

    def __call__(self):
        while self.pos < 3:
            if self.crash_store is not None and self.pos == 2:
                deadline = time.monotonic() + 30
                while CheckpointStore(self.crash_store).latest() is None \
                        and time.monotonic() < deadline:
                    time.sleep(0.01)
                raise _Crash("killed before yield 3")
            lo = self.pos * 1000
            yield {"v": np.arange(lo, lo + 1000, dtype=np.int64)}
            self.pos += 1

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _big_yield_graph(src, store, txn):
    g = wt.PipeGraph("midyield", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.INGRESS_TIME, device="cpu")
    g.with_checkpointing(store_dir=store)
    g.add_source(wt.Columnar_Source_Builder(src).with_name("src")
                 .with_block_size(256).with_output_batch_size(256).build()) \
        .add(wt.Map_GPU_Builder(lambda f: {"v": f["v"] + 1}).build()) \
        .add_sink(wt.Sink_Builder(lambda c, t: None).with_columns()
                  .with_name("snk").with_exactly_once(staging_dir=txn)
                  .build())
    return g


def test_barrier_requested_mid_yield_lands_at_the_next_yield(tmp_path,
                                                             monkeypatch):
    """A checkpoint requested while the second chunk of yield 1 ships must
    not inject there: the cursor (0) does not cover the chunks already
    pushed. It injects before yield 2 with cursor 1, so after a kill and
    a restore every value reaches the exactly-once sink once."""
    orig = ColumnarSourceReplica.ship_columns
    chunks = {"n": 0}

    def ship(self, cols, ts_arr, wm):
        chunks["n"] += 1
        if chunks["n"] == 2 and self._coord is not None:
            self._coord.trigger(force=True)  # requested, not injected
        return orig(self, cols, ts_arr, wm)

    monkeypatch.setattr(ColumnarSourceReplica, "ship_columns", ship)
    store = str(tmp_path / "store")
    txn = str(tmp_path / "txn")
    g = _big_yield_graph(_BigYields(crash_store=store), store, txn)
    with pytest.raises(_Crash):
        run_bounded(g)
    monkeypatch.undo()
    st = CheckpointStore(store)
    d = st.checkpoint_dir(st.latest())
    states = st.load_states(d, st.load_manifest(d))
    assert states[("src", 0)]["position"] == 1  # yield 1 whole
    g2 = _big_yield_graph(_BigYields(), store, txn)
    run_bounded(g2, restore_from=store)
    recs = read_committed_records(os.path.join(txn, "snk_r0"))
    got = np.sort(np.concatenate([c["v"] for c, _ in recs]))
    assert np.array_equal(got, np.arange(3000) + 1)  # once each


# ---------------------------------------------------------------------------
# supervised mid-stream crash through an exactly-once sink
# ---------------------------------------------------------------------------
class _CrashingBlockSource(wt.ArrayBlockSource):
    def __init__(self, cols, block_size, crash_after=None):
        super().__init__(cols, block_size=block_size)
        self.crash_after = crash_after
        self.blocks_out = 0

    def __call__(self):
        for block in super().__call__():
            time.sleep(0.004)  # interval checkpoints land before the crash
            yield block
            self.blocks_out += 1
            if self.crash_after is not None \
                    and self.blocks_out == self.crash_after:
                self.crash_after = None
                raise ValueError("synthetic mid-stream block crash")


def _windows_graph(tmp, src_func, results, supervised):
    g = wt.PipeGraph("col_sup", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.INGRESS_TIME, device="cpu")
    g.with_checkpointing(interval=0.05, store_dir=str(tmp / "store"))
    if supervised:
        g.with_supervision(wt.RestartPolicy(max_restarts=4, backoff_s=0.02,
                                            backoff_max_s=0.1))
    win = wt.Keyed_Windows(lambda rows: sum(r["v"] for r in rows),
                           key_extractor=lambda t: int(t["k"]), win_len=4,
                           slide_len=4, win_type=wt.WinType.CB, name="kw",
                           parallelism=2)

    def sink(t):
        if t is not None:
            results.append((t.key, t.wid, t.value))

    g.add_source(wt.Columnar_Source_Builder(src_func).with_name("src")
                 .build()) \
        .add(win) \
        .add_sink(wt.Sink_Builder(sink).with_name("snk")
                  .with_exactly_once(staging_dir=str(tmp / "txn")).build())
    return g


def test_supervised_crash_mid_stream_exactly_once(tmp_path):
    """A block source crashing mid-stream under supervision: the
    block-granular cursor replays from the checkpoint and the exactly-once
    sink's output equals the crash-free run's and the model's."""
    n = 2000
    cols = {"k": (np.arange(n) % 7).astype(np.int64),
            "v": np.arange(n, dtype=np.int64)}
    golden = []
    run_bounded(_windows_graph(tmp_path / "gold",
                               wt.ArrayBlockSource(cols, block_size=50),
                               golden, supervised=False))
    model = []
    for k in range(7):
        vs = list(range(k, n, 7))
        model += [(k, w, sum(vs[i:i + 4]))
                  for w, i in enumerate(range(0, len(vs), 4))]
    assert sorted(golden) == sorted(model)
    results = []
    g = _windows_graph(tmp_path / "run",
                       _CrashingBlockSource(cols, 50, crash_after=25),
                       results, supervised=True)
    run_bounded(g)
    assert sorted(results) == sorted(golden)
    committed = [r for r, _ in read_committed_records(
        str(tmp_path / "run" / "txn" / "snk_r0"))]
    assert sorted((r.key, r.wid, r.value) for r in committed) \
        == sorted(golden)
    st = g.get_stats()
    assert st["Supervision"]["Supervision_restarts"] == 1
    src_op = next(o for o in st["Operators"] if o["name"] == "src")
    assert "ValueError" in src_op["replicas"][0]["Worker_last_error"]
