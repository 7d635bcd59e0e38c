"""Megabatch and the chain terminators in the port: the dispatch queue's
grouping (``windflow_tpu_torch/runtime/dispatch.py``), the window-terminated
chain ``map [-> filter] -> Ffat_Windows_GPU`` (``FusedFfatReplica``), the
keyed reduce terminator, and ``PipeGraph(megabatch=K)``.

Each graph runs three ways on the same stream: the port fused, the port
unfused (``fusion=False``), and the JAX package fused (``WF_TPU_FUSION=1``,
its CPU backend). Window and reduce values are int32 and compared exactly,
with the ``Late_*`` and ``Inputs_ignored`` counts; megabatch K in {4, 8}
must emit the batches of K=1, column for column and in order. The queue
units run against fake commits (no device work)."""

import threading

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.tpu import (Ffat_Windows_TPU_Builder, Filter_TPU_Builder,
                              Map_TPU_Builder, Reduce_TPU_Builder)
from windflow_tpu_torch.runtime.dispatch import DeviceDispatchQueue

N_KEYS = 5
TS_STEP = 137
WIN_US, SLIDE_US = 1000, 400
BLOCK = 30  # rows per columnar block and per batch


# ---------------------------------------------------------------------------
# queue grouping units (fake commits, no device)
# ---------------------------------------------------------------------------
class _FakeCommit:
    """Commit thunk carrying the scan attributes fused_ops attaches."""

    def __init__(self, log, tag, sig, fail=False):
        self._log, self._tag, self._fail = log, tag, fail
        if sig is not None:
            self.scan_sig = sig
            self.scan_runner = self._runner

    def __call__(self):
        self._log.append(("single", self._tag))

    def _runner(self, commits):
        if self._fail:
            raise RuntimeError("group failed")
        self._log.append(("group", [c._tag for c in commits]))


def _tags(log):
    out = []
    for kind, payload in log:
        out.extend(payload if kind == "group" else [payload])
    return out


def test_queue_depth_rides_to_megabatch():
    # a K-wide group needs K commits in the queue
    assert DeviceDispatchQueue(depth=2, megabatch=8).depth == 8
    assert DeviceDispatchQueue(depth=16, megabatch=4).depth == 16
    # synchronous mode wins: commits never queue at all
    assert DeviceDispatchQueue(depth=0, megabatch=8).depth == 0
    assert DeviceDispatchQueue(megabatch=0).megabatch == 1  # 0 = off


def test_queue_pow2_front_runs():
    """Overflow pops the largest power-of-two same-signature FRONT run as
    one group; drain() always runs singles; order is kept throughout."""
    log = []
    q = DeviceDispatchQueue(depth=4, megabatch=4)
    for i in range(11):
        q.submit(_FakeCommit(log, i, sig="A"))
    q.drain(forced=True)
    assert _tags(log) == list(range(11))
    assert ("group", [0, 1, 2, 3]) in log
    drained = log[log.index(("group", [0, 1, 2, 3])) + 1:]
    assert all(k == "single" or len(p) in (2, 4) for k, p in drained)
    assert log[-1][0] == "single"


def test_queue_mixed_signatures_run_single():
    log = []
    q = DeviceDispatchQueue(depth=2, megabatch=4)
    for i, s in enumerate(["A", "B", "A", "B", "A", "B"]):
        q.submit(_FakeCommit(log, i, sig=s))
    q.drain()
    assert all(kind == "single" for kind, _ in log)
    assert _tags(log) == list(range(6))


def test_queue_unfused_commits_run_single():
    log = []
    q = DeviceDispatchQueue(depth=2, megabatch=8)
    for i in range(6):
        q.submit(_FakeCommit(log, i, sig=None))  # no scan attributes
    q.drain()
    assert all(kind == "single" for kind, _ in log)


def test_queue_megabatch_off_runs_single():
    log = []
    q = DeviceDispatchQueue(depth=4, megabatch=1)
    for i in range(9):
        q.submit(_FakeCommit(log, i, sig="A"))
    q.drain()
    assert all(kind == "single" for kind, _ in log)
    assert _tags(log) == list(range(9))


def test_queue_partial_run_truncates_to_pow2():
    """A front run of 3 same-signature commits groups as 2 + 1 single."""
    log = []
    q = DeviceDispatchQueue(depth=3, megabatch=4)  # depth rides to 4
    for i, s in enumerate(["A", "A", "A", "B", "B"]):
        q.submit(_FakeCommit(log, i, sig=s))  # the 5th submit overflows
    q.drain()
    assert log[0] == ("group", [0, 1])
    assert all(kind == "single" for kind, _ in log[1:])
    assert _tags(log[1:]) == [2, 3, 4]


def test_queue_failed_group_discards_the_rest():
    """A group that raises discards the queued entries, as a single
    commit does: they were prepped against state the failure left."""
    log = []
    q = DeviceDispatchQueue(depth=2, megabatch=2)
    q.submit(_FakeCommit(log, 0, sig="A", fail=True))
    q.submit(_FakeCommit(log, 1, sig="A"))
    with pytest.raises(RuntimeError, match="group failed"):
        q.submit(_FakeCommit(log, 2, sig="A"))
    assert len(q) == 0 and log == []


# ---------------------------------------------------------------------------
# FFAT window terminator: map [-> filter] -> Ffat_Windows as one replica
# ---------------------------------------------------------------------------
def _ffat_blocks(stream_len, disorder=0, seed=7, wm_lag=None):
    """Event-time blocks of BLOCK rows (N_KEYS rows per stream position),
    ts up to ``disorder`` behind the position, each block's watermark
    ``wm_lag`` behind its last position (default ``disorder``: no row is
    late; smaller: rows arrive behind the watermark). Block-aligned with
    the output batch size, so batch boundaries do not depend on timing."""
    rng = np.random.default_rng(seed)
    wm_lag = disorder if wm_lag is None else wm_lag
    pos = np.repeat(np.arange(stream_len), N_KEYS)
    ts = pos * TS_STEP
    if disorder:
        ts = np.maximum(0, ts - rng.integers(0, disorder + 1, len(ts)))
    key = np.tile(np.arange(N_KEYS), stream_len).astype(np.int32)
    value = (pos + 1 + key).astype(np.int32)
    out = []
    for lo in range(0, len(ts), BLOCK):
        hi = min(lo + BLOCK, len(ts))
        out.append(({"key": key[lo:hi], "value": value[lo:hi]},
                    ts[lo:hi].astype(np.int64),
                    max(0, int(pos[hi - 1]) * TS_STEP - wm_lag)))
    return out


def _graph(pkg, monkeypatch, fusion, name, policy, megabatch=1):
    if pkg is wj:
        monkeypatch.setenv("WF_TPU_FUSION", "1" if fusion else "0")
        monkeypatch.setenv("WF_MEGABATCH", str(megabatch))
        return wj.PipeGraph(name, wj.ExecutionMode.DEFAULT,
                            getattr(wj.TimePolicy, policy))
    return wt.PipeGraph(name, wt.ExecutionMode.DEFAULT,
                        getattr(wt.TimePolicy, policy), device="cpu",
                        fusion=fusion, megabatch=megabatch)


def _run_ffat_chain(pkg, monkeypatch, fusion, with_filter, stream_len=90,
                    disorder=0, wm_lag=None):
    res, lock = {}, threading.Lock()

    def sink(r):
        if r is not None:
            with lock:
                res[(int(r["key"]), int(r["wid"]))] = (
                    int(r["value"]) if r["valid"] else None)

    g = _graph(pkg, monkeypatch, fusion, "ffat_chain", "EVENT_TIME")
    blocks = _ffat_blocks(stream_len, disorder, wm_lag=wm_lag)
    mp = g.add_source(pkg.Columnar_Source_Builder(lambda: iter(blocks))
                      .with_output_batch_size(BLOCK).build())
    if pkg is wj:
        Map, Filter = Map_TPU_Builder, Filter_TPU_Builder
        w = Ffat_Windows_TPU_Builder(
            lambda f: {"value": f["value"]},
            lambda a, b: {"value": a["value"] + b["value"]})
    else:
        Map, Filter = wt.Map_GPU_Builder, wt.Filter_GPU_Builder
        w = wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                        wt.fieldwise(value="sum"))
    mp = mp.add(Map(lambda f: {**f, "value": f["value"] * 2})
                .with_name("m").build())
    if with_filter:
        mp = mp.chain(Filter(lambda f: f["value"] % 4 == 0)
                      .with_name("flt").build())
    w = (w.with_key_by("key").with_num_win_per_batch(8)
         .with_tb_windows(WIN_US, SLIDE_US).with_name("ffat").build())
    mp.chain(w).add_sink(pkg.Sink_Builder(sink).build())
    run_bounded(g)
    return res, {o["name"]: o["replicas"][0]
                 for o in g.get_stats()["Operators"]}


_LATE = ("Late_records", "Late_dropped", "Late_admitted")


@pytest.mark.parametrize("with_filter", [False, True])
def test_ffat_chain_differential(monkeypatch, with_filter):
    fused, fst = _run_ffat_chain(wt, monkeypatch, True, with_filter)
    plain, pst = _run_ffat_chain(wt, monkeypatch, False, with_filter)
    ref, jst = _run_ffat_chain(wj, monkeypatch, True, with_filter)
    assert fused == plain == ref
    assert len(fused) > 50  # real windows fired
    name = "m∘flt∘ffat" if with_filter else "m∘ffat"
    frep = fst[name]
    assert frep["Fused_ops"] == (3 if with_filter else 2)
    assert all(frep[k] == jst[name][k] for k in _LATE + ("Inputs_ignored",))
    # the prefix's own programs vanish: a map-only chain runs the bare
    # window's program count, a filter adds one prep-time mask per batch
    unfused = pst["ffat"]["Device_programs_run"]
    assert pst["m"]["Device_programs_run"] > 0
    if with_filter:
        assert frep["Device_programs_run"] == (
            unfused + pst["flt"]["Device_programs_run"])
        assert frep["Inputs_ignored"] == pst["flt"]["Inputs_ignored"] > 0
    else:
        assert frep["Device_programs_run"] == unfused


def test_ffat_chain_late_events_differential(monkeypatch):
    """Late rows behind a fused filter: a row the prefix drops must never
    register a key or advance a leaf, so the windows and the Late_*
    counts equal the unfused run and the JAX package's fused run."""
    runs = {}
    for pkg, fusion in ((wt, True), (wt, False), (wj, True)):
        runs[(pkg, fusion)] = _run_ffat_chain(
            pkg, monkeypatch, fusion, True, disorder=2500, wm_lag=100)
    (fused, fst), (plain, pst), (ref, jst) = runs.values()
    assert fused == plain == ref
    assert len(fused) > 50
    assert fst["m∘flt∘ffat"]["Late_dropped"] > 0
    for k in _LATE:
        assert fst["m∘flt∘ffat"][k] == pst["ffat"][k] \
            == jst["m∘flt∘ffat"][k]


# ---------------------------------------------------------------------------
# keyed Reduce_GPU terminates the chain at parallelism 1
# ---------------------------------------------------------------------------
def _run_kreduce(pkg, monkeypatch, fusion, with_filter, drop_all=False,
                 stream_len=60, megabatch=1):
    rows, lock = [], threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                rows.append((int(t["key"]), int(t["value"])))

    g = _graph(pkg, monkeypatch, fusion, "kred_chain", "EVENT_TIME",
               megabatch)
    # block-aligned columnar input: batch boundaries, and so each batch's
    # per-key partials, do not depend on timing
    pos = np.repeat(np.arange(stream_len), N_KEYS)
    key = np.tile(np.arange(N_KEYS, dtype=np.int32), stream_len)
    value = (pos + 1 + key).astype(np.int32)
    blocks = [({"key": key[i:i + 16], "value": value[i:i + 16]},
               np.arange(i, min(i + 16, len(key)), dtype=np.int64), i)
              for i in range(0, len(key), 16)]

    if pkg is wj:
        Map, Filter, Reduce = (Map_TPU_Builder, Filter_TPU_Builder,
                               Reduce_TPU_Builder)
    else:
        Map, Filter, Reduce = (wt.Map_GPU_Builder, wt.Filter_GPU_Builder,
                               wt.Reduce_GPU_Builder)
    mp = g.add_source(pkg.Columnar_Source_Builder(lambda: iter(blocks))
                      .with_output_batch_size(16).build()) \
        .add(Map(lambda f: {**f, "value": f["value"] + 1})
             .with_name("m").build())
    if with_filter:
        pred = ((lambda f: f["value"] < 0) if drop_all
                else (lambda f: f["value"] % 3 != 0))
        mp = mp.chain(Filter(pred).with_name("kf").build())
    red = (Reduce(lambda a, b: {"key": b["key"],
                                "value": a["value"] + b["value"]})
           .with_key_by("key").with_name("kr").build())
    mp.chain(red).add_sink(pkg.Sink_Builder(sink).build())
    run_bounded(g)
    kind = "Fused_TPU_Chain" if pkg is wj else "Fused_GPU_Chain"
    ops = g.get_stats()["Operators"]
    return rows, [o["replicas"][0] for o in ops if o["kind"] == kind], ops


@pytest.mark.parametrize("with_filter", [False, True])
def test_kreduce_chain_differential(monkeypatch, with_filter):
    fused, frep, _ = _run_kreduce(wt, monkeypatch, True, with_filter)
    plain, prep, pops = _run_kreduce(wt, monkeypatch, False, with_filter)
    ref, jrep, _ = _run_kreduce(wj, monkeypatch, True, with_filter)
    # keys emit in the slot order over ALL rows, compacted to survivors:
    # the JAX package's fused order; the unfused run agrees as a multiset
    assert fused == ref and sorted(fused) == sorted(plain)
    assert {k for k, _ in fused} == set(range(N_KEYS))
    assert len(frep) == 1 and not prep
    r = frep[0]
    # one program per batch: the keyed shuffle became the terminator's
    # own sort, no host keyby hop
    assert r["Device_programs_run"] == r["Dispatch_batches"] > 0
    assert r["Inputs_ignored"] == jrep[0]["Inputs_ignored"] == sum(
        o["replicas"][0]["Inputs_ignored"] for o in pops)
    assert (r["Inputs_ignored"] > 0) == with_filter


def test_kreduce_chain_drop_all_batches(monkeypatch):
    """A filter killing every row mid-chain: the fused keyed reduce emits
    nothing and counts every row ignored, like the unfused graph."""
    fused, frep, _ = _run_kreduce(wt, monkeypatch, True, True, True)
    plain, _, pops = _run_kreduce(wt, monkeypatch, False, True, True)
    ref, jrep, _ = _run_kreduce(wj, monkeypatch, True, True, True)
    assert fused == plain == ref == []
    assert len(frep) == 1
    assert frep[0]["Inputs_ignored"] == 60 * N_KEYS \
        == jrep[0]["Inputs_ignored"] == pops[2]["replicas"][0][
            "Inputs_ignored"]


# ---------------------------------------------------------------------------
# megabatch: K in {1, 4, 8} emits the batches of K=1, with its stats
# ---------------------------------------------------------------------------
def _run_chain_batches(monkeypatch, kind, megabatch, n_blocks=64):
    """Columnar source (blocks of 16 rows, 8 keys) -> map -> filter ->
    [map | global reduce | keyed reduce], fused, at parallelism 1; returns
    the sink's batches as they arrived and the fused replica's stats."""
    rng = np.random.default_rng(11)
    blocks = []
    for b in range(n_blocks):
        ts = b * 16 + np.arange(16, dtype=np.int64)
        blocks.append(({"key": rng.integers(0, 8, 16).astype(np.int32),
                        "value": rng.integers(0, 100, 16).astype(np.int32)},
                       ts, int(ts[0])))
    g = _graph(wt, monkeypatch, True, "mb", "EVENT_TIME", megabatch)
    mp = g.add_source(wt.Columnar_Source_Builder(lambda: iter(blocks))
                      .with_output_batch_size(16).build()) \
        .add(wt.Map_GPU_Builder(lambda f: {**f, "value": f["value"] * 3})
             .build()) \
        .chain(wt.Filter_GPU_Builder(lambda f: f["value"] % 2 == 0).build())
    if kind == "map":
        last = wt.Map_GPU_Builder(lambda f: {**f, "value": f["value"] + 7})
    else:
        last = wt.Reduce_GPU_Builder(lambda a, b: {
            "key": b["key"], "value": a["value"] + b["value"]})
        if kind == "kreduce":
            last = last.with_key_by("key")
    out, lock = [], threading.Lock()

    def sink(cols, ts):
        if cols is not None:
            with lock:
                out.append(({k: np.array(v) for k, v in cols.items()},
                            np.array(ts)))

    mp.chain(last.build()).add_sink(
        wt.Sink_Builder(sink).with_columns().build())
    run_bounded(g)
    fused = next(o for o in g.get_stats()["Operators"]
                 if o["kind"] == "Fused_GPU_Chain")
    return out, fused["replicas"][0]


@pytest.mark.parametrize("kind", ["map", "reduce", "kreduce"])
def test_megabatch_batches_equal_k1_with_stats(monkeypatch, kind):
    base, r1 = _run_chain_batches(monkeypatch, kind, 1)
    assert base
    assert r1["Megabatch_loops"] == 0 and r1["Programs_per_batch"] == 1.0
    for k in (4, 8):
        got, r = _run_chain_batches(monkeypatch, kind, k)
        assert len(got) == len(base), f"K={k}"
        for (gc, gts), (bc, bts) in zip(got, base):
            assert np.array_equal(gts, bts)
            assert gc.keys() == bc.keys()
            assert all(np.array_equal(gc[c], bc[c]) for c in bc), f"K={k}"
        assert r["Megabatch_loops"] > 0
        assert r["Megabatch_max"] <= k
        assert r["Megabatch_batches_per_loop_avg"] >= 2.0
        # fewer device programs than batches: groups retire several
        assert r["Programs_per_batch"] < 1.0
        assert r["Inputs_ignored"] == r1["Inputs_ignored"]


def test_megabatch_kreduce_matches_jax(monkeypatch):
    """K=8 under the keyed terminator: the port's rows equal its K=1 rows
    and the JAX package's K=8 (``lax.scan``) rows, in order."""
    one, _, _ = _run_kreduce(wt, monkeypatch, True, True, stream_len=200)
    got, frep, _ = _run_kreduce(wt, monkeypatch, True, True, stream_len=200,
                                megabatch=8)
    ref, _, _ = _run_kreduce(wj, monkeypatch, True, True, stream_len=200,
                             megabatch=8)
    assert got == one == ref and got
    assert frep[0]["Megabatch_loops"] > 0
