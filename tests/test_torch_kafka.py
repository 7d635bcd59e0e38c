"""The port's Kafka connectors (``memory://``) against the JAX package's,
a small YSB graph, and JAX-written checkpoints of window, join and Kafka
graphs restored into port graphs.

Twins of the ``memory://`` cases of ``test_kafka_monitoring.py`` (consume
all, consumer-group partitions, explicit-offset replay, sink round trip,
a real broker refused without a client library), of ``test_columnar_ingest.py`` (columnar
blocks, batch polls advancing the offsets) and of
``test_checkpoint_recovery.py`` (offsets snapshotted with the barrier,
committed on finalize, replayed on restore). Every test resets the
process-wide broker registries of both packages and uses broker names of
its own (other test files share the xdist worker). Inputs come from numpy
seeds; every graph run is bounded (``torch_waits``)."""

import sys
import threading

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from common import GlobalSum, TupleT, make_ingress_source, make_sum_sink
from torch_waits import run_bounded
from windflow_tpu import kafka as kj
from windflow_tpu.checkpoint import CheckpointStore as StoreJ
from windflow_tpu.kafka import connectors as conn_j
from windflow_tpu_torch import convert
from windflow_tpu_torch import kafka as kt
from windflow_tpu_torch.checkpoint import CheckpointStore as StoreT
from windflow_tpu_torch.kafka import connectors as conn_t

KAFKA = {wt: kt, wj: kj}


@pytest.fixture(autouse=True)
def fresh_brokers():
    kt.MemoryBroker.reset()
    kj.MemoryBroker.reset()
    yield
    kt.MemoryBroker.reset()
    kj.MemoryBroker.reset()


def _pg(pkg, name, mode="DEFAULT", time_policy="INGRESS_TIME"):
    kw = {"device": "cpu"} if pkg is wt else {}
    return pkg.PipeGraph(name, getattr(pkg.ExecutionMode, mode),
                         getattr(pkg.TimePolicy, time_policy), **kw)


def fill_topic(pkg, broker, topic, n, n_partitions=4):
    b = KAFKA[pkg].MemoryBroker.get(broker, n_partitions)
    for i in range(n):
        b.produce(topic, {"k": i % 5, "v": i + 1}, key=i % 5)
    return b


def _row_deser(msg, shipper):
    if msg is None:
        return False  # idle: the topic is drained
    shipper.push(TupleT(msg.payload["k"], msg.payload["v"]))
    return True


def _consume(pkg, broker, par=1, offsets=None, **kw):
    acc = GlobalSum()
    g = _pg(pkg, f"ksrc_{broker}")
    b = (KAFKA[pkg].Kafka_Source_Builder(kw.get("deser", _row_deser))
         .with_brokers(f"memory://{broker}").with_topics("events")
         .with_group_id("g1").with_idleness(50).with_parallelism(par))
    if offsets:
        b = b.with_offsets(offsets)
    g.add_source(b.build()).add_sink(
        pkg.Sink_Builder(make_sum_sink(acc)).build())
    run_bounded(g)
    return acc.count, acc.value


def test_kafka_source_consumes_all():
    for pkg in (wt, wj):
        fill_topic(pkg, "tb1", "events", 200)
    assert _consume(wt, "tb1") == _consume(wj, "tb1") \
        == (200, sum(range(1, 201)))


def test_kafka_source_consumer_group_partitions():
    """Two replicas split the partitions; together they read the topic."""
    for pkg in (wt, wj):
        fill_topic(pkg, "tb2", "events", 120)
    assert _consume(wt, "tb2", par=2) == _consume(wj, "tb2", par=2) \
        == (120, sum(range(1, 121)))


def test_kafka_source_explicit_offsets_replay():
    """with_offsets: the start positions replay a suffix of each
    partition."""
    skipped = {}
    for pkg in (wt, wj):
        b = fill_topic(pkg, "tb3", "events", 40, n_partitions=2)
        skipped[pkg] = sum(b.poll("events", p, off).payload["v"]
                           for p in range(2) for off in range(5))
    offs = {("events", 0): 5, ("events", 1): 5}
    got = _consume(wt, "tb3", offsets=offs)
    assert got == _consume(wj, "tb3", offsets=offs)
    assert got == (30, sum(range(1, 41)) - skipped[wt])


def test_kafka_sink_roundtrip():
    """Pipeline -> Kafka_Sink -> broker -> second pipeline."""
    out = {}
    for pkg in (wt, wj):
        g1 = _pg(pkg, "to_kafka")
        sink = (KAFKA[pkg].Kafka_Sink_Builder(
                    lambda t: ("out", t.key, {"k": t.key, "v": t.value}))
                .with_brokers("memory://tb4").build())
        g1.add_source(pkg.Source_Builder(make_ingress_source(3, 30)).build()) \
            .add(pkg.Map_Builder(lambda t: t).build()).add(sink)
        run_bounded(g1)
        acc = GlobalSum()
        g2 = _pg(pkg, "from_kafka")
        src = (KAFKA[pkg].Kafka_Source_Builder(_row_deser)
               .with_brokers("memory://tb4").with_topics("out")
               .with_idleness(50).build())
        g2.add_source(src).add_sink(
            pkg.Sink_Builder(make_sum_sink(acc)).build())
        run_bounded(g2)
        out[pkg] = (acc.count, acc.value)
    assert out[wt] == out[wj] == (90, 3 * sum(range(1, 31)))


def test_kafka_real_brokers_are_refused(monkeypatch):
    """A real broker needs a client library: with neither confluent_kafka
    nor kafka-python importable, both packages refuse at the builder's
    ``build()`` (and ``make_transport``) with the same message, which
    names the client. (The adapters themselves are held to the JAX
    package in ``test_torch_kafka_clients.py``.)"""
    monkeypatch.setitem(sys.modules, "confluent_kafka", None)
    monkeypatch.setitem(sys.modules, "kafka", None)
    for kpkg, conn, err in ((kt, conn_t, wt.WindFlowError),
                            (kj, conn_j, wj.WindFlowError)):
        for build in (lambda: kpkg.Kafka_Source_Builder(lambda m, s: False)
                      .with_brokers("localhost:9092").with_topics("t")
                      .build(),
                      lambda: kpkg.Kafka_Sink_Builder(lambda t: None)
                      .with_brokers("localhost:9092").build(),
                      lambda: kpkg.Kafka_Sink_Builder(lambda t: None)
                      .with_brokers("localhost:9092").with_exactly_once()
                      .build(),
                      lambda: conn.make_transport("localhost:9092")):
            with pytest.raises(err, match=r"no Kafka client library "
                               r"available \(confluent_kafka / "
                               r"kafka-python\)"):
                build()
    # the overload knobs of the Kafka source builder are ported (PR 12):
    # a budget and a priority ride the operator, as in the JAX package
    for kpkg in (kt, kj):
        op = (kpkg.Kafka_Source_Builder(lambda m, s: False)
              .with_brokers("memory://slo_knobs").with_topics("t")
              .with_slo(5.0).with_priority(lambda p: 1).build())
        assert op.slo_p99_ms == 5.0 and op.priority_fn(None) == 1


def test_kafka_retry_heals_then_delivers(monkeypatch):
    """A transient consume error heals through ``_retrying`` (attempts and
    backoff as arguments) and the message still arrives; every retry
    calls ``on_retry``. Exhausted attempts raise."""
    broker = kt.MemoryBroker.get("tretry")
    for i in range(20):
        broker.produce("t", i, partition=0)

    class Hiccup(Exception):
        pass

    flaky = {"n": 2}
    orig = conn_t.MemoryTransport.consume

    def flaky_consume(self):
        if flaky["n"] > 0:
            flaky["n"] -= 1
            raise Hiccup("transient")
        return orig(self)

    monkeypatch.setattr(conn_t.MemoryTransport, "consume", flaky_consume)
    monkeypatch.setattr(conn_t.MemoryTransport, "_transient_excs",
                        lambda self: (Hiccup,))
    t = conn_t.MemoryTransport("tretry")
    retries = []
    t.on_retry = lambda: retries.append(1)
    t.subscribe(["t"], "g", 0, 1, {})
    got = conn_t._retrying(t, t.consume, "consume", attempts=5,
                           base_s=0.001)
    assert got is not None and got.payload == 0 and len(retries) == 2
    flaky["n"] = 99
    with pytest.raises(wt.WindFlowError, match="still failing after 2"):
        conn_t._retrying(t, t.consume, "consume", attempts=2, base_s=0.001)


# ---------------------------------------------------------------------------
# columnar blocks
# ---------------------------------------------------------------------------
def test_kafka_columnar_blocks_consumes_all():
    def deser(msgs, shipper):
        if msgs is None:
            return False
        shipper.push_columns({
            "k": np.array([m.payload["k"] for m in msgs], dtype=np.int64),
            "v": np.array([m.payload["v"] for m in msgs], dtype=np.int64)})
        return True

    out = {}
    for pkg in (wt, wj):
        fill_topic(pkg, "tcb1", "events", 300)
        total = [0, 0]

        def sink(t, total=total):
            if t is not None:
                total[0] += int(t["v"])
                total[1] += 1

        g = _pg(pkg, "kblk")
        src = (KAFKA[pkg].Kafka_Source_Builder(deser)
               .with_brokers("memory://tcb1").with_topics("events")
               .with_group_id("g1").with_columnar_blocks(64)
               .with_idleness(50).build())
        g.add_source(src).add_sink(pkg.Sink_Builder(sink).build())
        run_bounded(g)
        out[pkg] = tuple(total)
    assert out[wt] == out[wj] == (sum(range(1, 301)), 300)


def test_kafka_consume_batch_advances_offsets_like_per_message():
    """``consume_batch`` moves the cursors ``snapshot_positions`` and the
    commit read; explicit start offsets replay the suffix in batch mode
    too. Same answers as the JAX transport."""
    def run(conn):
        b = conn.MemoryBroker.get("tcb2", 2)
        for i in range(10):
            b.produce("t", {"v": i}, partition=i % 2)
        tr = conn.MemoryTransport("tcb2")
        tr.subscribe(["t"], "g", 0, 1, {})
        got = []
        while True:
            msgs = tr.consume_batch(4)
            if not msgs:
                break
            got.extend(m.payload["v"] for m in msgs)
        tr2 = conn.MemoryTransport("tcb2")
        tr2.subscribe(["t"], "g2", 0, 1, {("t", 0): 3, ("t", 1): 3})
        replay = []
        while True:
            msgs = tr2.consume_batch(8)
            if not msgs:
                break
            replay.extend(m.payload["v"] for m in msgs)
        return got, tr.snapshot_positions(), replay

    got, pos, replay = run(conn_t)
    assert (got, pos, replay) == run(conn_j)
    assert sorted(got) == list(range(10))
    assert pos == {("t", 0): 5, ("t", 1): 5} and len(replay) == 4


def test_with_columnar_blocks_validation():
    for pkg in (wt, wj):
        with pytest.raises(pkg.WindFlowError, match="block_size"):
            KAFKA[pkg].Kafka_Source_Builder(
                lambda m, s: False).with_columnar_blocks(0)


# ---------------------------------------------------------------------------
# offsets with the checkpoint barrier
# ---------------------------------------------------------------------------
def _ckpt_graph(pkg, store, broker, name, deser):
    g = _pg(pkg, name)
    g.with_checkpointing(store_dir=store)
    src = KAFKA[pkg].connectors.Kafka_Source(
        deser, f"memory://{broker}", ["in"], group_id="g1",
        idleness_ms=300, name="ksrc")
    g.add_source(src).add_sink(
        pkg.Sink_Builder(lambda t: None).with_name("snk").build())
    return g


def test_kafka_offsets_commit_on_finalize(tmp_path):
    """The barrier snapshots the offsets; the broker's group offsets are
    committed only when the checkpoint finalizes (150, not the final
    400); the blob carries the same offsets."""
    for pkg, Store in ((wt, StoreT), (wj, StoreJ)):
        broker = KAFKA[pkg].MemoryBroker.get("tckpt")
        for i in range(400):
            broker.produce("in", i, partition=i % 4)
        seen = []

        def deser(msg, shipper, seen=seen):
            if msg is None:
                return False
            seen.append(msg.payload)
            shipper.push({"v": msg.payload})
            if len(seen) == 150:
                shipper.request_checkpoint()
            return True

        store = str(tmp_path / pkg.__name__)
        g = _ckpt_graph(pkg, store, "tckpt", "ck_kafka", deser)
        run_bounded(g)
        assert len(seen) == 400
        assert g._coordinator.completed == 1
        committed = {k: v for k, v in broker.committed.items()
                     if k[0] == "g1"}
        assert sum(committed.values()) == 150
        cid, d, manifest = Store.resolve(store)
        st = Store(store).load_states(d, manifest)[("ksrc", 0)]
        assert sum(st["offsets"].values()) == 150


def test_kafka_restore_consumes_remainder(tmp_path):
    """A restored run resumes from the checkpointed offsets: with the
    first run's pre-checkpoint prefix the two runs cover every message
    once. The port restores its own checkpoint and a JAX-written one."""
    def make_deser(out, ckpt_at=None, stop_at=None):
        def deser(msg, shipper):
            if msg is None:
                return False
            out.append(msg.payload)
            shipper.push({"v": msg.payload})
            if ckpt_at is not None and len(out) == ckpt_at:
                shipper.request_checkpoint()
            return not (stop_at is not None and len(out) >= stop_at)
        return deser

    for pkg in (wt, wj):
        broker = KAFKA[pkg].MemoryBroker.get("tckpt2")
        for i in range(300):
            broker.produce("in", i, partition=i % 4)
    runs = {}
    for pkg in (wt, wj):
        store = str(tmp_path / pkg.__name__)
        run1 = []
        run_bounded(_ckpt_graph(pkg, store, "tckpt2", "ck_kafka2",
                                make_deser(run1, 100, 180)))
        runs[pkg] = (run1, store)
    run2 = []
    run_bounded(_ckpt_graph(wt, runs[wt][1], "tckpt2", "ck_kafka2",
                            make_deser(run2)), restore_from=runs[wt][1])
    assert sorted(runs[wt][0][:100] + run2) == list(range(300))
    # the JAX checkpoint, carried across
    st = StoreJ(runs[wj][1])
    d = st.checkpoint_dir(st.latest())
    states = convert.checkpoint_states_from_jax(
        st.load_states(d, st.load_manifest(d)), "cpu")
    run3 = []
    g = _pg(wt, "ck_kafka2")
    g.add_source(kt.connectors.Kafka_Source(
        make_deser(run3), "memory://tckpt2", ["in"], group_id="g1",
        idleness_ms=300, name="ksrc")).add_sink(
        wt.Sink_Builder(lambda t: None).with_name("snk").build())
    run_bounded(g, restore_from=states)
    assert sorted(runs[wj][0][:100] + run3) == list(range(300))


# ---------------------------------------------------------------------------
# a JAX-written checkpoint of a window and join graph, restored in the port
# ---------------------------------------------------------------------------
def _win_join_graph(pkg, name, store, stop_at=None, ckpt_at=None):
    """Kafka topic a -> Keyed_Windows CB -> sink, and topic a (a second
    source) merged with topic b -> Interval_Join KP -> sink. Returns the
    graph and its result sets."""
    win_rows, pairs, lock = set(), set(), threading.Lock()
    seen = {}
    # every source waits for the others at message 100, so the checkpoint
    # requested at ``ckpt_at`` finds all three mid-stream
    meet = threading.Barrier(3, timeout=20)

    def deser_for(src):
        def deser(msg, shipper):
            if msg is None:
                return False
            p = msg.payload
            shipper.push_with_timestamp(p, p["ts"])
            shipper.set_next_watermark(p["ts"])
            seen[src] = seen.get(src, 0) + 1
            if ckpt_at is not None and seen[src] == 100:
                meet.wait()
            if src == "jb" and seen[src] == ckpt_at:
                shipper.request_checkpoint()
            return not (stop_at is not None and seen[src] >= stop_at)
        return deser

    def add(s, v):
        if v is not None:
            with lock:
                s.add(v)

    g = _pg(pkg, name, time_policy="EVENT_TIME")
    if store is not None:
        g.with_checkpointing(store_dir=store)
    K = KAFKA[pkg]

    def src(name, topic):
        return (K.Kafka_Source_Builder(deser_for(name))
                .with_brokers("memory://twj").with_topics(topic)
                .with_group_id(f"g_{name}").with_idleness(200)
                .with_name(f"src_{name}").build())
    win = (pkg.Keyed_Windows_Builder(lambda ws: sum(w["v"] for w in ws))
           .with_key_by(lambda t: t["k"]).with_cb_windows(7, 3)
           .with_name("kw").build())
    join = (pkg.Interval_Join_Builder(lambda x, y: (x["k"], x["v"], y["v"]))
            .with_key_by(lambda t: t["k"]).with_boundaries(1000, 1000)
            .with_name("ij").build())
    g.add_source(src("win", "a")).add(win).add_sink(pkg.Sink_Builder(
        lambda r: add(win_rows, None if r is None
                      else (r.key, r.wid, r.value))).with_name("wsnk").build())
    g.add_source(src("ja", "a")).merge(g.add_source(src("jb", "b"))) \
        .add(join).add_sink(pkg.Sink_Builder(
            lambda r: add(pairs, r)).with_name("jsnk").build())
    return g, win_rows, pairs


def test_port_restores_a_jax_checkpoint_of_windows_join_and_kafka(tmp_path):
    """A JAX-written checkpoint of a graph with Kafka sources, a
    ``Keyed_Windows`` stage and a KP ``Interval_Join`` (their collectors
    included) restores into the port: the restored port run delivers what
    the restored JAX run delivers."""
    for pkg in (wt, wj):
        b = KAFKA[pkg].MemoryBroker.get("twj", 2)
        for t, step in (("a", 100), ("b", 83)):
            for i in range(300):
                b.produce(t, {"k": i % 4, "v": i, "ts": i * step},
                          partition=0)
    store = str(tmp_path / "jax")
    g, _, _ = _win_join_graph(wj, "wj_ckpt", store, stop_at=220,
                              ckpt_at=120)
    run_bounded(g)
    assert g._coordinator.completed >= 1
    st = StoreJ(store)
    d = st.checkpoint_dir(st.latest())
    jstates = st.load_states(d, st.load_manifest(d))
    assert jstates[("kw", 0)]["engine"]["key_map"]
    assert jstates[("ij", 0)]["keys"]
    assert sum(jstates[("src_jb", 0)]["offsets"].values()) == 120
    # both restored runs read the rest of the topics from the offsets
    gj, wj_rows, wj_pairs = _win_join_graph(wj, "wj_ckpt", None)
    run_bounded(gj, restore_from=store)
    gt, wt_rows, wt_pairs = _win_join_graph(wt, "wj_ckpt", None)
    run_bounded(gt, restore_from=convert.checkpoint_states_from_jax(
        jstates, "cpu"))
    assert wt_rows == wj_rows and wt_pairs == wj_pairs
    assert wt_rows and wt_pairs


# ---------------------------------------------------------------------------
# a small YSB graph: Kafka rows -> view filter -> ad->campaign ->
# per-campaign tumbling window, on the device operators (run on the CPU)
# ---------------------------------------------------------------------------
N_CAMPAIGNS, ADS_PER_CAMPAIGN, TS_STEP_US = 100, 10, 100
YSB_EVENTS, YSB_WIN_US = 24_000, 1_000_000


def _ysb_fill(pkg):
    b = KAFKA[pkg].MemoryBroker.get("tysb", 8)
    for i in range(YSB_EVENTS):
        b.produce("ad_events", {"ad_id": i % (N_CAMPAIGNS * ADS_PER_CAMPAIGN),
                                "event_type": i % 3, "ts": i * TS_STEP_US},
                  key=i % 8)


def _ysb_last(a, b_):
    """examples/ysb.py's window combine: counts add, the later side's
    ingest stamp is kept (one function serves both packages)."""
    return {"count": a["count"] + b_["count"], "last_ing": b_["last_ing"]}


def _ysb_graph(pkg, ing_rows, sink_op, store=None, hook=None, src_par=2):
    """Kafka rows -> views -> ad->campaign -> 1 s windows -> ``sink_op``,
    the window with the example's own combine; with ``store``,
    checkpointed there; ``hook(shipper)`` runs after each event's push
    (checkpoint requests, an injected crash). ``src_par`` source replicas
    share the 8 partitions; a replica's watermark is the lowest last ts
    of its partitions (a restored replica resumes its partitions at
    offsets a message apart)."""
    last = {}  # replica -> {partition: its last ts}

    def deser(msg, shipper, ctx):
        if msg is None:
            return False
        p = msg.payload
        shipper.push_with_timestamp(
            {"ad_id": p["ad_id"], "event_type": p["event_type"],
             "ing": ing_rows[p["ts"] // TS_STEP_US]}, p["ts"])
        mine = last.setdefault(ctx.get_replica_index(), {})
        mine[msg.partition] = p["ts"]
        if len(mine) == 8 // src_par:  # all of the replica's partitions
            shipper.set_next_watermark(
                max(shipper.current_watermark, min(mine.values())))
        if hook is not None:
            hook(shipper)
        return True

    g = _pg(pkg, "ysb", time_policy="EVENT_TIME")
    if store is not None:
        g.with_checkpointing(store_dir=store)
    src = (KAFKA[pkg].Kafka_Source_Builder(deser).with_brokers("memory://tysb")
           .with_topics("ad_events").with_idleness(100)
           .with_parallelism(src_par)
           .with_output_batch_size(4096).with_name("ksrc").build())
    if pkg is wt:
        F, M, W = wt.Filter_GPU_Builder, wt.Map_GPU_Builder, \
            wt.Ffat_Windows_GPU_Builder
    else:
        from windflow_tpu.tpu import (Ffat_Windows_TPU_Builder,
                                      Filter_TPU_Builder, Map_TPU_Builder)
        F, M, W = Filter_TPU_Builder, Map_TPU_Builder, \
            Ffat_Windows_TPU_Builder
    views = F(lambda f: f["event_type"] == 0).with_name("views").build()
    project = M(lambda f: {"campaign": f["ad_id"] // ADS_PER_CAMPAIGN,
                           "one": f["event_type"] * 0 + 1,
                           "ing": f["ing"]}).with_name("project").build()
    win = (W(lambda f: {"count": f["one"], "last_ing": f["ing"]}, _ysb_last)
           .with_key_by("campaign").with_tb_windows(YSB_WIN_US, YSB_WIN_US)
           .with_num_win_per_batch(32).with_key_capacity(N_CAMPAIGNS)
           .with_name("win").build())
    g.add_source(src).add(views).add(project).add(win).add_sink(sink_op)
    return g


def _ysb(pkg, ing_rows, src_par=2):
    _ysb_fill(pkg)
    res = {}

    def sink(cols, ts):
        if cols is None:
            return
        v = cols["valid"].astype(bool)
        for c, w, n, li in zip(cols["campaign"][v].tolist(),
                               cols["wid"][v].tolist(),
                               cols["count"][v].tolist(),
                               cols["last_ing"][v].tolist()):
            res[(c, w)] = (n, li)

    run_bounded(_ysb_graph(pkg, ing_rows, pkg.Sink_Builder(sink)
                           .with_columns().build(), src_par=src_par))
    return res


def _ysb_model(ing):
    """(campaign, window) -> (views, the stamp of its last view in event
    order) and -> the set of its views' stamps."""
    model, stamps = {}, {}
    for i in range(0, YSB_EVENTS, 3):
        c = (i % (N_CAMPAIGNS * ADS_PER_CAMPAIGN)) // ADS_PER_CAMPAIGN
        w = (i * TS_STEP_US) // YSB_WIN_US
        n, _ = model.get((c, w), (0, 0))
        model[(c, w)] = (n + 1, int(ing[i]))
        stamps.setdefault((c, w), set()).add(int(ing[i]))
    return model, stamps


def _holds_counts_and_stamps(rows, ing):
    """With two source replicas which view of a window arrives last is a
    race: the counts equal the model's, and each ``last_ing`` is an
    ingest stamp of that (campaign, window)'s views."""
    model, stamps = _ysb_model(ing)
    assert {k: n for k, (n, _) in rows.items()} \
        == {k: n for k, (n, _) in model.items()}
    assert all(li in stamps[k] for k, (_, li) in rows.items())


def test_ysb_counts_match_jax_and_model():
    """Two source replicas: per-(campaign, window) counts equal the
    closed-form model of ``examples/ysb.py`` and the JAX package's device
    chain, both running the example's own combine; each ``last_ing`` is a
    stamp of the window's views."""
    ing = np.random.default_rng(5).integers(0, 1 << 30, YSB_EVENTS)
    got = _ysb(wt, ing)
    ref = _ysb(wj, ing)
    assert {k: n for k, (n, _) in got.items()} \
        == {k: n for k, (n, _) in ref.items()}
    _holds_counts_and_stamps(got, ing)
    _holds_counts_and_stamps(ref, ing)


def test_ysb_last_ing_matches_jax_and_model_with_one_source_replica():
    """One source replica reads the 8 partitions round-robin, so views
    arrive in event order: each window's ``last_ing`` (the example's
    ``b["last_ing"]``) is its last view's stamp, exactly, in the port and
    in the JAX package."""
    ing = np.random.default_rng(8).integers(0, 1 << 30, YSB_EVENTS)
    got = _ysb(wt, ing, src_par=1)
    ref = _ysb(wj, ing, src_par=1)
    assert got == ref == _ysb_model(ing)[0]


# ---------------------------------------------------------------------------
# YSB into an exactly-once Kafka sink: per-epoch broker transactions
# ---------------------------------------------------------------------------
def _eo_kafka_sink(pkg, broker="tysb_out"):
    def ser(r):
        if not r["valid"]:
            return None
        return ("ysb_out", None, (int(r["campaign"]), int(r["wid"]),
                                  int(r["count"]), int(r["last_ing"])))
    return (KAFKA[pkg].Kafka_Sink_Builder(ser)
            .with_brokers(f"memory://{broker}").with_name("ksnk")
            .with_exactly_once().build())


def _topic_rows(pkg, broker="tysb_out"):
    """The output topic as a read-committed consumer sees it: what the
    committed transactions appended (prepared epochs are invisible)."""
    b = KAFKA[pkg].MemoryBroker.get(broker)
    return [m.payload for part in b._topic("ysb_out") for m in part]


def _requests_every(n_events):
    """A hook requesting a checkpoint every ``n_events`` pushes of a
    source replica."""
    local = threading.local()

    def hook(shipper):
        local.n = getattr(local, "n", 0) + 1
        if local.n % n_events == 0:
            shipper.request_checkpoint()
    return hook


def test_ysb_exactly_once_kafka_sink_matches_jax_and_model(tmp_path):
    """Each (campaign, window) reaches the output topic exactly once, with
    the model's count and an ingest stamp of its views, in both
    packages."""
    ing = np.random.default_rng(6).integers(0, 1 << 30, YSB_EVENTS)
    got = {}
    for pkg in (wt, wj):
        _ysb_fill(pkg)
        g = _ysb_graph(pkg, ing, _eo_kafka_sink(pkg),
                       store=str(tmp_path / pkg.__name__),
                       hook=_requests_every(3000))
        run_bounded(g)
        rows = _topic_rows(pkg)
        assert len(rows) == len(set((c, w) for c, w, _, _ in rows))
        got[pkg] = {(c, w): (n, li) for c, w, n, li in rows}
        assert g._coordinator.completed >= 1
        _holds_counts_and_stamps(got[pkg], ing)


def test_ysb_exactly_once_kill_after_first_epoch_and_restore(tmp_path):
    """The port's YSB graph dies after its first committed epoch (a source
    replica raises) and restores from it: at the crash the topic holds
    only finalized epochs' windows, none twice; after the restore it holds
    every (campaign, window) once, equal to the model."""
    ing = np.random.default_rng(7).integers(0, 1 << 30, YSB_EVENTS)
    model, stamps = _ysb_model(ing)
    _ysb_fill(wt)
    store = str(tmp_path / "store")
    request = _requests_every(2000)
    seen = {"n": 0}
    lock = threading.Lock()

    class Killed(Exception):
        pass

    def hook(shipper):
        request(shipper)
        with lock:
            seen["n"] += 1
            n = seen["n"]
        if n >= 16000 and StoreT(store).latest() is not None:
            raise Killed("after the first committed epoch")

    with pytest.raises((Killed, wt.basic.WorkerFailuresError)):
        run_bounded(_ysb_graph(wt, ing, _eo_kafka_sink(wt), store=store,
                               hook=hook))
    at_crash = _topic_rows(wt)
    assert len(at_crash) == len(set((c, w) for c, w, _, _ in at_crash))
    assert all(model[(c, w)][0] == n and li in stamps[(c, w)]
               for c, w, n, li in at_crash)
    g2 = _ysb_graph(wt, ing, _eo_kafka_sink(wt), store=store)
    run_bounded(g2, restore_from=store)
    rows = _topic_rows(wt)
    assert len(rows) == len(model)
    _holds_counts_and_stamps({(c, w): (n, li) for c, w, n, li in rows}, ing)
