"""Exactly-once sinks of the port (``windflow_tpu_torch.sinks``) against
``tests/test_exactly_once.py``: the same graphs and kill points on the
port's classes.

A pipeline is killed at every phase of the two-phase commit: mid-epoch,
after the sink pre-committed but before the coordinator finalized, after
the finalize but before the sink's rename, and inside the rename. The
restored run's committed output must equal the uninterrupted run's (the
golden) and the exact model: no duplicate, no loss, byte-identical where
one replica writes in order. Zombie writes are fenced across a live
rescale, the refusals carry the JAX package's messages, and a checkpoint
the JAX package wrote of an exactly-once graph restores into a port graph
and resolves the segments the JAX sink staged.
"""

from __future__ import annotations

import os
import threading
import time

import pytest

import windflow_tpu_torch as wt
from windflow_tpu_torch.checkpoint import CheckpointStore
from windflow_tpu_torch.kafka.builders_kafka import Kafka_Sink_Builder
from windflow_tpu_torch.kafka.connectors import MemoryBroker, MemoryTransport
from windflow_tpu_torch.persistent.builders_persistent import P_Sink_Builder
from windflow_tpu_torch.persistent.db_handle import DBHandle
from windflow_tpu_torch.sinks.transactional import (EpochSegmentStore,
                                                    EpochTxnDriver,
                                                    FencedWriteError,
                                                    read_committed_records)

from torch_waits import join_bounded, run_bounded, wait_end_bounded


class InjectedCrash(Exception):
    pass


class ReplaySource:
    """Deterministic replayable source: integers 0..n-1 keyed ``v % nk``;
    checkpoints requested at ``ckpt_at`` positions; a crash at
    ``crash_at``."""

    def __init__(self, n, nk=5, ckpt_at=(), crash_at=None):
        self.n = n
        self.nk = nk
        self.ckpt_at = set(ckpt_at)
        self.crash_at = crash_at
        self.pos = 0

    def __call__(self, shipper):
        while self.pos < self.n:
            if self.crash_at is not None and self.pos == self.crash_at:
                raise InjectedCrash(f"killed at tuple {self.pos}")
            v = self.pos
            shipper.push({"k": v % self.nk, "v": v})
            self.pos += 1
            if self.pos in self.ckpt_at:
                assert shipper.request_checkpoint() is not None

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _graph(name, store, **ckpt):
    g = wt.PipeGraph(name, wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.INGRESS_TIME, device="cpu")
    g.with_checkpointing(store_dir=store, **ckpt)
    return g


def _sink_stats(g, name="snk"):
    return [r for o in g.get_stats()["Operators"] if o["name"] == name
            for r in o["replicas"]][0]


# ---------------------------------------------------------------------------
# row sink: the deterministic forward chain gives byte-identical output
# ---------------------------------------------------------------------------
def _row_graph(store, src, txn_dir, results, **ckpt):
    g = _graph("eo_row", store, **ckpt)

    def sink(t):
        if t is not None:
            results.append(t["v"])

    g.add_source(wt.Source_Builder(src).with_name("src").build()) \
        .add_sink(wt.Sink_Builder(sink).with_name("snk")
                  .with_exactly_once(staging_dir=txn_dir).build())
    return g


def _row_golden(tmp_path, n=1500):
    res = []
    run_bounded(_row_graph(str(tmp_path / "gold_store"), ReplaySource(n),
                           str(tmp_path / "gold_txn"), res))
    return res, read_committed_records(str(tmp_path / "gold_txn" / "snk_r0"))


def _row_crash_restore(tmp_path, n=1500, ckpt_at=(500,), crash_at=1000,
                       **ckpt):
    store = str(tmp_path / "store")
    txn = str(tmp_path / "txn")
    crash_res = []
    g = _row_graph(store, ReplaySource(n, ckpt_at=ckpt_at,
                                       crash_at=crash_at), txn, crash_res,
                   **ckpt)
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    rest_res = []
    g2 = _row_graph(store, ReplaySource(n), txn, rest_res, **ckpt)
    run_bounded(g2, restore_from=store)
    return g2, crash_res, rest_res, txn


@pytest.mark.parametrize("ckpt", [{}, {"delta": True, "async_upload": True}],
                         ids=["sync", "delta_async"])
def test_row_kill_mid_epoch_byte_identical(tmp_path, ckpt):
    """Pre-barrier kill: records after the committed barrier were never
    pre-committed, the replay produces them exactly once. Under delta +
    async checkpoints the epoch finalizes after its upload, long after
    the ack, and the sink commits only then."""
    golden, gold_segs = _row_golden(tmp_path)
    assert golden == list(range(1500))
    _, crash_res, rest_res, txn = _row_crash_restore(tmp_path, **ckpt)
    segs = read_committed_records(os.path.join(txn, "snk_r0"))
    assert [p["v"] for p, _ in segs] == [p["v"] for p, _ in gold_segs] \
        == golden
    # the functor saw every record exactly once across the two runs
    assert crash_res + rest_res == golden


def test_row_kill_post_precommit_pre_finalize(tmp_path, monkeypatch):
    """The sink pre-commits epoch 2 and the store commit of epoch 2 dies:
    the restore resolves epoch 1, aborts the staged epoch-2 segment, and
    the replay produces its records again."""
    golden, _ = _row_golden(tmp_path)
    orig = CheckpointStore.commit

    def dying_commit(self, ckpt_id, manifest):
        if ckpt_id == 2:
            raise InjectedCrash("store commit of epoch 2")
        return orig(self, ckpt_id, manifest)

    monkeypatch.setattr(CheckpointStore, "commit", dying_commit)
    store = str(tmp_path / "store")
    txn = str(tmp_path / "txn")
    crash_res = []
    g = _row_graph(store, ReplaySource(1500, ckpt_at=(400, 900),
                                       crash_at=1300), txn, crash_res)
    # the crash lands on whichever worker acks last: two workers may die
    with pytest.raises((InjectedCrash, wt.basic.WorkerFailuresError)):
        run_bounded(g)
    monkeypatch.undo()
    assert g._coordinator.completed == 1  # epoch 2 never finalized
    seg_store = EpochSegmentStore(os.path.join(txn, "snk_r0"))
    assert 2 in seg_store.pending_epochs()  # pre-committed, unfinalized
    rest_res = []
    g2 = _row_graph(store, ReplaySource(1500), txn, rest_res)
    run_bounded(g2, restore_from=store)
    assert seg_store.pending_epochs() == []  # aborted on restore
    segs = read_committed_records(os.path.join(txn, "snk_r0"))
    assert [p["v"] for p, _ in segs] == golden
    assert crash_res + rest_res == golden
    assert _sink_stats(g2)["Sink_txn_aborts"] >= 1


def test_row_kill_post_finalize_rolls_forward(tmp_path, monkeypatch):
    """The coordinator finalized epoch 2 but the sink never renamed
    (poll disabled, then the crash): the restore rolls the pending
    segments FORWARD, since the replay will not produce them again."""
    golden, _ = _row_golden(tmp_path)
    monkeypatch.setattr(EpochTxnDriver, "poll", lambda self: False)
    store = str(tmp_path / "store")
    txn = str(tmp_path / "txn")
    crash_res = []
    g = _row_graph(store, ReplaySource(1500, ckpt_at=(400, 900),
                                       crash_at=1300), txn, crash_res)
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    monkeypatch.undo()
    assert g._coordinator.completed == 2
    pend = EpochSegmentStore(os.path.join(txn, "snk_r0")).pending_epochs()
    assert 1 in pend and 2 in pend  # finalized but never renamed
    rest_res = []
    g2 = _row_graph(store, ReplaySource(1500), txn, rest_res)
    run_bounded(g2, restore_from=store)
    segs = read_committed_records(os.path.join(txn, "snk_r0"))
    assert [p["v"] for p, _ in segs] == golden
    # the roll-forward delivered epochs 1 and 2 to the restored functor
    assert crash_res == []
    assert rest_res == golden


def test_row_kill_during_commit(tmp_path, monkeypatch):
    """The crash lands INSIDE the sink's rename: the pending file
    survives, the restore rolls it forward, nothing duplicates."""
    golden, _ = _row_golden(tmp_path)
    orig = EpochSegmentStore.commit
    state = {"armed": True}

    def dying(self, epoch):
        if state["armed"]:
            state["armed"] = False
            raise InjectedCrash("killed inside commit")
        return orig(self, epoch)

    monkeypatch.setattr(EpochSegmentStore, "commit", dying)
    store = str(tmp_path / "store")
    txn = str(tmp_path / "txn")
    crash_res = []
    g = _row_graph(store, ReplaySource(1500, ckpt_at=(500,)), txn,
                   crash_res)
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    monkeypatch.undo()
    rest_res = []
    g2 = _row_graph(store, ReplaySource(1500), txn, rest_res)
    run_bounded(g2, restore_from=store)
    segs = read_committed_records(os.path.join(txn, "snk_r0"))
    assert [p["v"] for p, _ in segs] == golden
    assert crash_res + rest_res == golden


def test_row_restore_from_older_checkpoint_discards_replayed_epochs(
        tmp_path):
    """A replay from a checkpoint OLDER than committed epochs: the sink
    knows the committed epoch ids and discards the replayed duplicates."""
    golden, _ = _row_golden(tmp_path)
    store = str(tmp_path / "store")
    txn = str(tmp_path / "txn")
    res = []
    g = _row_graph(store, ReplaySource(1500, ckpt_at=(400, 900)), txn, res)
    run_bounded(g)
    assert g._coordinator.completed == 2
    segs_before = read_committed_records(os.path.join(txn, "snk_r0"))
    assert [p["v"] for p, _ in segs_before] == golden
    ckpt1_dir = CheckpointStore(store).checkpoint_dir(1)
    res2 = []
    g2 = _row_graph(store, ReplaySource(1500), txn, res2)
    run_bounded(g2, restore_from=ckpt1_dir)
    segs_after = read_committed_records(os.path.join(txn, "snk_r0"))
    assert [p["v"] for p, _ in segs_after] == golden  # nothing appended
    assert _sink_stats(g2)["Sink_txn_aborts"] >= 1


# ---------------------------------------------------------------------------
# keyed windows (parallelism 2): multiset equality under kills
# ---------------------------------------------------------------------------
def _kw_graph(pkg, store, src, txn_dir, results, device=True):
    kw = dict(device="cpu") if device else {}
    g = pkg.PipeGraph("eo_kw", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **kw)
    g.with_checkpointing(store_dir=store)
    win = pkg.Keyed_Windows(lambda rows: sum(r["v"] for r in rows),
                            key_extractor=lambda t: t["k"], win_len=4,
                            slide_len=4, win_type=pkg.WinType.CB, name="kw",
                            parallelism=2)

    def sink(t):
        if t is not None:
            results.append((t.key, t.wid, t.value))

    g.add_source(pkg.Source_Builder(src).with_name("src").build()) \
        .add(win) \
        .add_sink(pkg.Sink_Builder(sink).with_name("snk")
                  .with_exactly_once(staging_dir=txn_dir).build())
    return g


def _windows_model(n, nk=5, win=4):
    """CB tumbling windows of 4 over each key's values (the EOS flushes
    the partial last window)."""
    out = []
    for k in range(nk):
        vs = list(range(k, n, nk))
        for wid, lo in enumerate(range(0, len(vs), win)):
            out.append((k, wid, sum(vs[lo:lo + win])))
    return sorted(out)


@pytest.mark.parametrize("crash_at", [700, 1201, 1999])
def test_keyed_windows_exactly_once_no_dup_no_loss(tmp_path, crash_at):
    import windflow_tpu as wj
    golden = []
    run_bounded(_kw_graph(wt, str(tmp_path / "gs"), ReplaySource(2000),
                          str(tmp_path / "gt"), golden))
    jax_golden = []
    run_bounded(_kw_graph(wj, str(tmp_path / "js"), ReplaySource(2000),
                          str(tmp_path / "jt"), jax_golden, device=False))
    assert sorted(golden) == sorted(jax_golden) == _windows_model(2000)
    store = str(tmp_path / "store")
    txn = str(tmp_path / "txn")
    crash_res = []
    g = _kw_graph(wt, store, ReplaySource(2000, ckpt_at=(600,),
                                          crash_at=crash_at), txn, crash_res)
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    assert g._coordinator.completed == 1
    rest_res = []
    g2 = _kw_graph(wt, store, ReplaySource(2000), txn, rest_res)
    run_bounded(g2, restore_from=store)
    segs = [r for (r, _) in
            read_committed_records(os.path.join(txn, "snk_r0"))]
    got = sorted((r.key, r.wid, r.value) for r in segs)
    assert got == sorted(golden)  # no duplicate, no loss
    assert sorted(crash_res + rest_res) == sorted(golden)


# ---------------------------------------------------------------------------
# Kafka (memory broker): per-epoch broker transactions, producer fencing
# ---------------------------------------------------------------------------
@pytest.fixture(autouse=True)
def _fresh_brokers():
    """``MemoryBroker`` is a process-wide registry, shared with other test
    files of the same worker: start and end each test with it empty."""
    MemoryBroker.reset()
    yield
    MemoryBroker.reset()


def _kafka_graph(store, src, broker):
    g = _graph("eo_kafka", store)
    g.add_source(wt.Source_Builder(src).with_name("src").build()) \
        .add_sink(Kafka_Sink_Builder(lambda t: ("out", t["k"] % 4, t["v"]))
                  .with_brokers(f"memory://{broker}").with_name("ksnk")
                  .with_exactly_once().build())
    return g


def _topic_payloads(broker):
    b = MemoryBroker.get(broker)
    out = []
    for p in range(b.n_partitions):
        out.extend(m.payload for m in b._topic("out")[p])
    return sorted(out)


def test_kafka_exactly_once_commit_rides_finalize(tmp_path):
    run_bounded(_kafka_graph(str(tmp_path / "gs"), ReplaySource(1000),
                             "eo_kgold"))
    golden = _topic_payloads("eo_kgold")
    assert golden == sorted(range(1000))
    store = str(tmp_path / "store")
    g = _kafka_graph(store, ReplaySource(1000, ckpt_at=(300,),
                                         crash_at=700), "eo_klive")
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    # at the crash exactly the finalized epoch is visible: no tail leaks
    assert _topic_payloads("eo_klive") == sorted(range(300))
    g2 = _kafka_graph(store, ReplaySource(1000), "eo_klive")
    run_bounded(g2, restore_from=store)
    assert _topic_payloads("eo_klive") == golden  # no dup, no loss


def test_kafka_kill_during_commit_rolls_forward(tmp_path, monkeypatch):
    orig = MemoryBroker.txn_commit
    state = {"armed": True}

    def dying(self, txn_id, gen, epoch):
        if state["armed"]:
            state["armed"] = False
            raise InjectedCrash("killed inside broker txn commit")
        return orig(self, txn_id, gen, epoch)

    monkeypatch.setattr(MemoryBroker, "txn_commit", dying)
    store = str(tmp_path / "store")
    g = _kafka_graph(store, ReplaySource(1000, ckpt_at=(300,)), "eo_kc")
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    monkeypatch.undo()
    assert _topic_payloads("eo_kc") == []  # prepared, never committed
    g2 = _kafka_graph(store, ReplaySource(1000), "eo_kc")
    run_bounded(g2, restore_from=store)
    assert _topic_payloads("eo_kc") == sorted(range(1000))


def test_kafka_zombie_producer_fenced():
    b = MemoryBroker.get("eo_fence")
    gen1 = b.txn_init("wf-txn-x")
    b.txn_prepare("wf-txn-x", gen1, 1, [("out", 0, None, 1)])
    gen2 = b.txn_init("wf-txn-x")  # a newer replica takes over
    with pytest.raises(FencedWriteError):
        b.txn_prepare("wf-txn-x", gen1, 2, [])
    with pytest.raises(FencedWriteError):
        b.txn_commit("wf-txn-x", gen1, 1)
    # the new generation can still commit the prepared epoch
    assert b.txn_commit("wf-txn-x", gen2, 1) is True
    assert b.fenced_attempts == 2


# ---------------------------------------------------------------------------
# persistent sink: the epoch-fenced sqlite writer
# ---------------------------------------------------------------------------
def _psink_graph(store, src, dbdir):
    g = _graph("eo_psink", store)
    g.add_source(wt.Source_Builder(src).with_name("src").build()) \
        .add_sink(P_Sink_Builder(
            lambda t, s: (s or 0) + (t["v"] if t is not None else 0))
            .with_key_by(lambda t: t["k"]).with_db_path(dbdir)
            .with_name("psnk").with_exactly_once().build())
    return g


def _read_psink_db(dbdir):
    h = DBHandle("psnk_r0", db_dir=dbdir)
    data = dict(h.items())
    meta = {k: h.meta_get(k) for k in ("epoch", "finalized", "fence")}
    h.close()
    return data, meta


def test_psink_exactly_once_epoch_consistent(tmp_path):
    golden_db = str(tmp_path / "gdb")
    run_bounded(_psink_graph(str(tmp_path / "gs"), ReplaySource(1000),
                             golden_db))
    golden, gmeta = _read_psink_db(golden_db)
    assert golden == {k: sum(range(k, 1000, 5)) for k in range(5)}
    assert gmeta["finalized"] == gmeta["epoch"]
    store = str(tmp_path / "store")
    dbdir = str(tmp_path / "db")
    g = _psink_graph(store, ReplaySource(1000, ckpt_at=(400,),
                                         crash_at=800), dbdir)
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    # mid-crash: epoch 1 finalized; the emergency-EOS tail was
    # PRE-committed as epoch 2, and the markers flag it as unfinalized
    _, mmeta = _read_psink_db(dbdir)
    assert mmeta["finalized"] == 1
    assert mmeta["epoch"] == 2
    g2 = _psink_graph(store, ReplaySource(1000), dbdir)
    run_bounded(g2, restore_from=store)
    final, fmeta = _read_psink_db(dbdir)
    assert final == golden
    assert fmeta["finalized"] == fmeta["epoch"]
    assert fmeta["fence"] == 2  # crash replica gen 1, restored gen 2


def test_psink_zombie_replica_fenced(tmp_path):
    from windflow_tpu_torch.persistent.p_basic_ops import P_Sink

    dbdir = str(tmp_path / "db")
    op = P_Sink(lambda t, s: (s or 0) + 1, key_extractor=lambda t: t,
                initial_state=None, name="zp", parallelism=1,
                output_batch_size=0, db_dir=dbdir)
    op.exactly_once = True
    op.build_replicas()
    old = op.replicas[0]
    op.replicas = []
    op.build_replicas()  # the rebuild bumps the in-DB fence
    new = op.replicas[0]
    assert new._fence == old._fence + 1
    with pytest.raises(FencedWriteError):
        old.precommit_epoch(1)
    assert old.stats.txn_fenced_writes == 1
    new.precommit_epoch(1)  # the new generation commits normally
    assert new.stats.txn_precommits == 1


# ---------------------------------------------------------------------------
# zombie fencing across a LIVE rescale
# ---------------------------------------------------------------------------
def test_fencing_across_rescale(tmp_path):
    """Rescaling a mid-graph operator rebuilds the whole runtime plane;
    the pre-rescale sink replica becomes a zombie whose writes the
    transaction log refuses, and the committed output stays the exact
    running sums."""
    store = str(tmp_path / "store")
    txn = str(tmp_path / "txn")
    results = []
    gate = threading.Event()

    class GatedSource(ReplaySource):
        def __call__(self, shipper):
            while self.pos < self.n:
                if self.pos == 1000:
                    gate.wait(20)
                v = self.pos
                shipper.push({"k": v % self.nk, "v": v})
                self.pos += 1

    src = GatedSource(3000, nk=7)
    g = _graph("eo_rescale", store)
    red = wt.Reduce(lambda t, s: (s or 0) + t["v"],
                    key_extractor=lambda t: t["k"], name="red",
                    parallelism=2)

    def sink(t):
        if t is not None:
            results.append(t)

    g.add_source(wt.Source_Builder(src).with_name("src").build()) \
        .add(red) \
        .add_sink(wt.Sink_Builder(sink).with_name("snk")
                  .with_exactly_once(staging_dir=txn).build())
    g.start()
    deadline = time.monotonic() + 30
    while src.pos < 1000 and time.monotonic() < deadline:
        time.sleep(0.01)
    old_sink = [op for op in g._ops if op.name == "snk"][0].replicas[0]
    timer = threading.Timer(0.2, gate.set)
    timer.start()
    rep = g.rescale("red", 3, timeout_s=30)
    assert rep.changed
    wait_end_bounded(g)
    join_bounded(timer)
    # the zombie's backend generation is stale: fenced, loudly
    with pytest.raises(FencedWriteError):
        old_sink._txn.backend.do_precommit(999, [])
    # every running sum exactly once: per key, the prefix sums in order
    sums = sorted(s for s, _ in
                  read_committed_records(os.path.join(txn, "snk_r0")))
    model = []
    for k in range(7):
        acc = 0
        for v in range(k, 3000, 7):
            acc += v
            model.append(acc)
    assert sums == sorted(model)
    assert sorted(results) == sorted(model)
    # rescaling the exactly-once sink ITSELF refuses
    g2 = _graph("eo_rescale2", str(tmp_path / "s2"))
    src2 = ReplaySource(100000, nk=7)
    g2.add_source(wt.Source_Builder(src2).with_name("src").build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).with_name("snk")
                  .with_exactly_once(staging_dir=str(tmp_path / "t2"))
                  .build())
    g2.start()
    try:
        with pytest.raises(wt.WindFlowError, match="exactly-once"):
            g2.rescale("snk", 2, timeout_s=10)
    finally:
        src2.n = 0  # let the source finish
        wait_end_bounded(g2)


# ---------------------------------------------------------------------------
# guarantee negotiation and refusals
# ---------------------------------------------------------------------------
def test_exactly_once_without_checkpointing_refused(tmp_path):
    import windflow_tpu as wj
    for pkg, kw in ((wt, dict(device="cpu")), (wj, {})):
        g = pkg.PipeGraph("eo_neg", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.INGRESS_TIME, **kw)
        g.add_source(pkg.Source_Builder(ReplaySource(10)).with_name("src")
                     .build()) \
            .add_sink(pkg.Sink_Builder(lambda t: None).with_name("snk")
                      .with_exactly_once(staging_dir=str(tmp_path / "t"))
                      .build())
        with pytest.raises(pkg.WindFlowError,
                           match="exactly-once sinks need the checkpoint "
                                 "plane"):
            run_bounded(g)


def test_graph_wide_exactly_once_flips_all_sinks(tmp_path):
    """The JAX package's ``WF_TXN_DIR`` is the port's
    ``with_exactly_once(staging_dir=...)``."""
    res = []
    src = ReplaySource(200, ckpt_at=(100,))
    g = _graph("eo_graphwide", str(tmp_path / "s"))
    g.with_exactly_once(staging_dir=str(tmp_path / "txn"))
    g.add_source(wt.Source_Builder(src).with_name("src").build()) \
        .add_sink(wt.Sink_Builder(lambda t: res.append(t["v"])
                                  if t is not None else None)
                  .with_name("snk").build())
    run_bounded(g)
    assert res == list(range(200))
    segs = read_committed_records(str(tmp_path / "txn" / "snk_r0"))
    assert [p["v"] for p, _ in segs] == list(range(200))


def test_graph_wide_exactly_once_refuses_incapable_sink(tmp_path):
    from windflow_tpu_torch.operators.basic_ops import Sink

    class LegacySink(Sink):
        supports_exactly_once = False

    g = _graph("eo_refuse", str(tmp_path / "s"))
    g.with_exactly_once()
    g.add_source(wt.Source_Builder(ReplaySource(10)).with_name("src")
                 .build()) \
        .add_sink(LegacySink(lambda t: None, name="legacy"))
    with pytest.raises(wt.WindFlowError, match="legacy.*transactional sink "
                                               "protocol"):
        run_bounded(g)


def test_restore_txn_checkpoint_into_plain_sink_refused(tmp_path):
    store = str(tmp_path / "store")
    txn = str(tmp_path / "txn")
    res = []
    run_bounded(_row_graph(store, ReplaySource(500, ckpt_at=(200,)), txn,
                           res))
    # the same topology WITHOUT exactly-once: the staged epochs would have
    # nowhere to go
    g2 = _graph("eo_row", store)
    g2.add_source(wt.Source_Builder(ReplaySource(500)).with_name("src")
                  .build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).with_name("snk").build())
    with pytest.raises(wt.WindFlowError,
                       match="taken by an exactly-once sink"):
        run_bounded(g2, restore_from=store)


def test_kafka_sink_delivery_error_fails_epoch(tmp_path, monkeypatch):
    """A lost in-flight produce fails the checkpoint: the coordinator
    never finalizes an epoch whose data never reached the broker."""
    def failing_flush(self):
        raise wt.WindFlowError("3 delivery error(s)")

    monkeypatch.setattr(MemoryTransport, "flush", failing_flush)
    g = _graph("kflush", str(tmp_path / "s"))
    g.add_source(wt.Source_Builder(ReplaySource(500, ckpt_at=(200,)))
                 .with_name("src").build()) \
        .add_sink(Kafka_Sink_Builder(lambda t: ("out", None, t["v"]))
                  .with_brokers("memory://eo_kflush").with_name("ksnk")
                  .build())
    with pytest.raises(wt.WindFlowError, match="delivery"):
        run_bounded(g)
    assert g._coordinator.completed == 0


def test_prune_waits_for_concurrent_restore_read(tmp_path):
    """Retain-K pruning never deletes a checkpoint a restore is reading."""
    store = CheckpointStore(str(tmp_path), retain=1)
    store.begin(1)
    for i in range(4):
        store.write_blob(1, "op", i, {"cid": 1, "i": i})
    store.commit(1, {"graph": "t"})
    d1 = store.checkpoint_dir(1)
    manifest = store.load_manifest(d1)
    orig_load = CheckpointStore.load_blob
    started = threading.Event()

    def slow_load(ckpt_dir, fname):
        started.set()
        time.sleep(0.15)
        return orig_load(ckpt_dir, fname)

    CheckpointStore.load_blob = staticmethod(slow_load)
    result = {}

    def reader():
        try:
            result["states"] = store.load_states(d1, manifest)
        except BaseException as e:  # pragma: no cover
            result["error"] = e

    t = threading.Thread(target=reader)
    try:
        t.start()
        started.wait(5)
        writer = CheckpointStore(str(tmp_path), retain=1)
        for cid in (2, 3):
            writer.begin(cid)
            writer.write_blob(cid, "op", 0, {"cid": cid})
            writer.commit(cid, {"graph": "t"})
        join_bounded(t)
    finally:
        CheckpointStore.load_blob = staticmethod(orig_load)
    assert "error" not in result, result.get("error")
    assert len(result["states"]) == 4
    assert all(st["cid"] == 1 for st in result["states"].values())
    assert store.completed_ids() == [3]


# ---------------------------------------------------------------------------
# a JAX-written checkpoint of an exactly-once graph restores into the port
# ---------------------------------------------------------------------------
def _jax_states(root):
    from windflow_tpu.checkpoint import CheckpointStore as StoreJ

    from windflow_tpu_torch.convert import checkpoint_states_from_jax
    sj = StoreJ(root)
    d = sj.checkpoint_dir(sj.latest())
    return checkpoint_states_from_jax(sj.load_states(d, sj.load_manifest(d)),
                                      "cpu")


def test_jax_checkpoint_of_exactly_once_graph_restores(tmp_path,
                                                       monkeypatch):
    """The JAX package crashes after finalizing epoch 2 with its sink's
    renames held back (epochs 1-2 finalized but pending) and the tail
    pre-committed as epoch 3. The port restores the JAX checkpoint: epochs
    1-2 roll forward from the JAX-staged segments, epoch 3 aborts, the
    replay commits the rest, and the committed stream is the golden."""
    import windflow_tpu as wj
    from windflow_tpu.sinks.transactional import EpochTxnDriver as DriverJ

    golden, _ = _row_golden(tmp_path)
    monkeypatch.setattr(DriverJ, "poll", lambda self: False)
    jstore = str(tmp_path / "jstore")
    txn = str(tmp_path / "txn")
    g = wj.PipeGraph("eo_row", wj.ExecutionMode.DEFAULT,
                     wj.TimePolicy.INGRESS_TIME)
    g.with_checkpointing(store_dir=jstore)
    g.add_source(wj.Source_Builder(ReplaySource(
        1500, ckpt_at=(400, 900), crash_at=1300)).with_name("src").build()) \
        .add_sink(wj.Sink_Builder(lambda t: None).with_name("snk")
                  .with_exactly_once(staging_dir=txn).build())
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    monkeypatch.undo()
    seg = EpochSegmentStore(os.path.join(txn, "snk_r0"))
    assert seg.pending_epochs() == [1, 2, 3]
    rest_res = []
    g2 = _row_graph(str(tmp_path / "pstore"), ReplaySource(1500), txn,
                    rest_res)
    run_bounded(g2, restore_from=_jax_states(jstore))
    assert seg.pending_epochs() == []
    segs = read_committed_records(os.path.join(txn, "snk_r0"))
    assert [p["v"] for p, _ in segs] == golden
    assert rest_res == golden  # rolled forward 0..899, then the replay
    assert _sink_stats(g2)["Sink_txn_aborts"] == 1  # the JAX tail epoch


def test_jax_checkpoint_of_windowed_exactly_once_graph_restores(tmp_path):
    """The JAX keyed-windows graph (two replicas, WinResult records in its
    segments) killed mid-epoch; the port restores its checkpoint, reads
    the JAX-staged WinResult segments as the port's class, and commits
    exactly the model's windows."""
    import windflow_tpu as wj
    store = str(tmp_path / "jstore")
    txn = str(tmp_path / "txn")
    g = _kw_graph(wj, store, ReplaySource(2000, ckpt_at=(600,),
                                          crash_at=1201), txn, [],
                  device=False)
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    rest = []
    g2 = _kw_graph(wt, str(tmp_path / "pstore"), ReplaySource(2000), txn,
                   rest)
    run_bounded(g2, restore_from=_jax_states(store))
    segs = [r for r, _ in
            read_committed_records(os.path.join(txn, "snk_r0"))]
    assert all(type(r) is wt.WinResult for r in segs)
    assert sorted((r.key, r.wid, r.value) for r in segs) \
        == _windows_model(2000)


def test_superseded_epoch_finalizing_late_is_not_committed(tmp_path):
    """Two forced epochs overlap and the newer one finalizes first: its
    store commit prunes the older one's staging. The older epoch's late
    finalize (its worker popped it just before) must not commit: its
    exactly-once data rides the newer epoch's watermark."""
    from windflow_tpu_torch.checkpoint import CheckpointCoordinator

    store = CheckpointStore(str(tmp_path))
    coord = CheckpointCoordinator(store, "sup")
    coord.expected_acks = 2
    finalized = []
    coord.add_finalize_listener(finalized.append)
    c1 = coord.trigger(force=True)
    c2 = coord.trigger(force=True)
    coord.ack(c1, "a", {("op", 0): {"v": 1}})
    ent1 = dict(coord._pending[c1])
    coord.ack(c2, "a", {("op", 0): {"v": 2}})
    coord.ack(c2, "b", {("op", 1): {"v": 2}})  # epoch 2 commits first
    assert store.completed_ids() == [c2] and finalized == [c2]
    # epoch 1's last ack had popped its entry just before: it finalizes
    # now, after epoch 2's commit pruned its staging directory
    with coord._lock:
        coord._pending[c1] = ent1
    coord._finalize(c1)
    assert store.completed_ids() == [c2]
    assert coord.last_completed_id == c2 and coord.completed == 1
    assert finalized == [c2]
    # a restore that rewinds the ids commits epochs again from there
    coord.rewind_to(0)
    c3 = coord.trigger(force=True)
    assert c3 == 1
    coord.ack(c3, "a", {})
    coord.ack(c3, "b", {})
    assert coord.last_completed_id == 1 and 1 in store.completed_ids()


def test_source_injects_every_epoch_opened_since_its_last_barrier():
    """Two forced epochs opened before a source's next boundary: it
    injects both barriers, in order. An aligner counts one barrier per
    channel whatever its id, so a source skipping epoch 1 while another
    injects it would close epoch 1 with epoch 2's barrier and mix the
    cut (two Kafka sources requesting checkpoints under an exactly-once
    sink double-counted windows that way)."""
    from types import SimpleNamespace

    from windflow_tpu_torch.kafka.connectors import Kafka_Source
    from windflow_tpu_torch.operators.source import Source

    for op in (Source(lambda s: None, name="s"),
               Kafka_Source(lambda m, s: False, "memory://eo_inject",
                            ["t"], name="k")):
        op.build_replicas()
        r = op.replicas[0]
        coord = SimpleNamespace(requested_id=0,
                                add_finalize_listener=lambda fn: None)
        injected = []
        r.bind_checkpoint(coord, lambda b: injected.append(b.ckpt_id))
        coord.requested_id = 2  # epochs 1 and 2 opened meanwhile
        r._maybe_inject()
        coord.requested_id = 3
        r._maybe_inject()
        r._maybe_inject()
        assert injected == [1, 2, 3]
