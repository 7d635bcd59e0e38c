"""The port's real-broker Kafka plane against the JAX package's, through
in-process fake client modules (``torch_kafka_clients``): the
confluent_kafka and kafka-python adapters end to end through PipeGraph,
explicit offsets, the no-client refusal, transient-error retries, offsets
committed on checkpoint finalize, the exactly-once refusal of kafka-python,
YSB into the staged exactly-once sink (whole, and killed and restored) and
the staged backend's recovery.

Each differential runs the same graph through both packages, each with a
fresh cluster installed in ``sys.modules`` (``monkeypatch.setitem``), and
compares what a read_committed consumer of the output topic sees. The JAX
package's retries are set through its ``WF_KAFKA_RETRIES`` /
``WF_KAFKA_RETRY_BASE_MS``, the port's through ``with_retries``. Inputs
come from numpy seeds; every graph run is bounded (``torch_waits``)."""

import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_kafka_clients import Cluster, make_confluent, make_kafka_python
from torch_waits import run_bounded
from windflow_tpu import kafka as kj
from windflow_tpu.checkpoint import CheckpointStore as StoreJ
from windflow_tpu.kafka import connectors as conn_j
from windflow_tpu_torch import kafka as kt
from windflow_tpu_torch.checkpoint import CheckpointStore as StoreT
from windflow_tpu_torch.kafka import connectors as conn_t

KAFKA = {wt: kt, wj: kj}
CONN = {wt: conn_t, wj: conn_j}
STORE = {wt: StoreT, wj: StoreJ}
BROKERS = "localhost:9092,localhost:9093"
CLIENTS = ("confluent", "kafka-python")


def install(monkeypatch, client, n_partitions=2, **kw):
    """A fresh cluster behind the fake ``client``, the other client
    hidden."""
    cluster = Cluster(n_partitions)
    if client == "confluent":
        monkeypatch.setitem(sys.modules, "confluent_kafka",
                            make_confluent(cluster, **kw))
        monkeypatch.setitem(sys.modules, "kafka", None)
    else:
        monkeypatch.setitem(sys.modules, "confluent_kafka", None)
        monkeypatch.setitem(sys.modules, "kafka", make_kafka_python(cluster))
    return cluster


def retries(monkeypatch, pkg, builder, attempts=5):
    """The retry settings of one package: env for the JAX package (read
    at each retry loop), ``with_retries`` for the port."""
    if pkg is wj:
        monkeypatch.setenv("WF_KAFKA_RETRIES", str(attempts))
        monkeypatch.setenv("WF_KAFKA_RETRY_BASE_MS", "1")
        return builder
    return builder.with_retries(attempts=attempts, base_ms=1)


def _pg(pkg, name, time_policy="INGRESS_TIME"):
    kw = {"device": "cpu"} if pkg is wt else {}
    return pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                         getattr(pkg.TimePolicy, time_policy), **kw)


def seed_topic(pkg, topic, values, n_partitions):
    """``values`` into ``topic`` through the package's own adapter."""
    t = CONN[pkg].make_transport(BROKERS)
    for i, v in enumerate(values):
        t.produce(topic, v, partition=i % n_partitions)
    t.flush()


def reconnects(graph):
    return sum(r.get("Kafka_reconnects", 0)
               for o in graph.get_stats()["Operators"]
               for r in o["replicas"])


def _stop_when_idle(msg, shipper):
    if msg is None:
        return False
    shipper.push({"v": msg.payload})
    return True


def _roundtrip(pkg, monkeypatch, client, values, src_par=1, blocks=None,
               offsets=None, source_hook=None, attempts=5, **kw):
    """Kafka_Source('in') -> Map (x 10) -> Kafka_Sink('out') on a fresh
    cluster, both with ``attempts`` retries: returns the cluster and the
    graph."""
    cluster = install(monkeypatch, client, **kw)
    seed_topic(pkg, "in", values, cluster.n_partitions)
    if source_hook is not None:
        source_hook(cluster)

    def deser_blocks(msgs, shipper):
        if msgs is None:
            return False
        shipper.push_columns({"v": np.array([m.payload for m in msgs],
                                            dtype=np.int64)})
        return True

    g = _pg(pkg, "kc_roundtrip")
    b = (KAFKA[pkg].Kafka_Source_Builder(
            deser_blocks if blocks else _stop_when_idle)
         .with_brokers(BROKERS).with_topics("in").with_group_id("g1")
         .with_idleness(50).with_parallelism(src_par))
    if blocks:
        b = b.with_columnar_blocks(blocks)
    if offsets:
        b = b.with_offsets(offsets)
    b = retries(monkeypatch, pkg, b, attempts)
    sink = retries(monkeypatch, pkg, KAFKA[pkg].Kafka_Sink_Builder(
        lambda t: ("out", None, int(t["v"]) * 10)).with_brokers(BROKERS),
        attempts)
    g.add_source(b.build()).add(pkg.Map_Builder(lambda t: t).build()) \
        .add_sink(sink.build())
    run_bounded(g)
    return cluster, g


@pytest.mark.parametrize("client", CLIENTS)
def test_roundtrip_through_the_adapter_matches_jax(monkeypatch, client):
    """Kafka_Source -> Map -> Kafka_Sink on a real-broker string: the
    output topic holds the same records, in the same order, in both
    packages."""
    vals = np.random.default_rng(1).integers(0, 1000, 60).tolist()
    out = {pkg: _roundtrip(pkg, monkeypatch, client, vals)[0]
           .read_committed("out") for pkg in (wt, wj)}
    assert out[wt] == out[wj]
    assert sorted(out[wt]) == sorted(v * 10 for v in vals)


@pytest.mark.parametrize("client,batch", [("confluent", True),
                                          ("confluent", False),
                                          ("kafka-python", True)],
                         ids=["confluent", "confluent-single-polls",
                              "kafka-python"])
def test_columnar_blocks_through_the_adapter_match_jax(monkeypatch, client,
                                                       batch):
    """``with_columnar_blocks``: the adapter's batch poll (and the
    confluent adapter's fallback to single polls when the client has no
    ``consume``), two source replicas of one consumer group."""
    vals = np.random.default_rng(2).integers(0, 1000, 300).tolist()
    kw = {} if client == "kafka-python" else {"batch_consume": batch}
    out = {}
    for pkg in (wt, wj):
        cluster, _ = _roundtrip(pkg, monkeypatch, client, vals, src_par=2,
                                blocks=16, n_partitions=4, **kw)
        out[pkg] = sorted(cluster.read_committed("out"))
    assert out[wt] == out[wj] == sorted(v * 10 for v in vals)


@pytest.mark.parametrize("client", CLIENTS)
def test_explicit_offsets_match_jax(monkeypatch, client):
    """``with_offsets``: assign (confluent) or assign + seek
    (kafka-python) of only the listed partitions, split over two
    replicas."""
    vals = list(range(40))
    offs = {("in", 0): 6, ("in", 1): 3, ("in", 3): 9}
    out = {}
    for pkg in (wt, wj):
        cluster, _ = _roundtrip(pkg, monkeypatch, client, vals, src_par=2,
                                offsets=offs, n_partitions=4)
        out[pkg] = sorted(cluster.read_committed("out"))
    want = sorted(10 * v for v in vals
                  if (v % 4, v // 4) in {(p, i) for (_, p), o in offs.items()
                                         for i in range(o, 10)})
    assert out[wt] == out[wj] == want


@pytest.mark.parametrize("client", CLIENTS + ("none",))
def test_make_transport_picks_the_client_as_jax_does(monkeypatch, client):
    """confluent_kafka first, then kafka-python; with neither, a
    ``WindFlowError`` naming the client, in ``make_transport`` and in
    the builders of both packages."""
    if client == "none":
        monkeypatch.setitem(sys.modules, "confluent_kafka", None)
        monkeypatch.setitem(sys.modules, "kafka", None)
        for pkg in (wt, wj):
            for build in (
                    lambda: CONN[pkg].make_transport(BROKERS),
                    lambda: KAFKA[pkg].Kafka_Source_Builder(_stop_when_idle)
                    .with_brokers(BROKERS).with_topics("t").build(),
                    lambda: KAFKA[pkg].Kafka_Sink_Builder(lambda t: None)
                    .with_brokers(BROKERS).with_exactly_once().build()):
                with pytest.raises(pkg.WindFlowError,
                                   match="no Kafka client library"):
                    build()
        return
    install(monkeypatch, client)
    if client == "kafka-python":
        # both installed: confluent_kafka wins
        both = Cluster()
        monkeypatch.setitem(sys.modules, "confluent_kafka",
                            make_confluent(both))
        assert type(conn_t.make_transport(BROKERS)).__name__ \
            == type(conn_j.make_transport(BROKERS)).__name__ \
            == "ConfluentTransport"
        monkeypatch.setitem(sys.modules, "confluent_kafka", None)
    names = {type(CONN[pkg].make_transport(BROKERS)).__name__
             for pkg in (wt, wj)}
    assert names == {"ConfluentTransport" if client == "confluent"
                     else "KafkaPythonTransport"}
    assert type(conn_t.make_transport("memory://mt")).__name__ \
        == "MemoryTransport"


# ---------------------------------------------------------------------------
# transient-error retries
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("client", CLIENTS)
@pytest.mark.parametrize("op", ["connect", "poll", "produce"])
def test_transient_failures_heal_and_count_as_in_jax(monkeypatch, client,
                                                     op):
    """``n`` transient client errors (consumer connect, poll, produce)
    heal: the output equals a clean run's and ``Kafka_reconnects`` is
    ``n`` in both packages."""
    vals = list(range(30))
    n = 3
    clean = _roundtrip(wt, monkeypatch, client, vals)[0].read_committed("out")
    got = {}
    for pkg in (wt, wj):
        cluster, g = _roundtrip(
            pkg, monkeypatch, client, vals,
            source_hook=lambda c: c.fail_next(op, n))
        assert cluster.pending_faults(op) == 0
        got[pkg] = (cluster.read_committed("out"), reconnects(g))
    assert got[wt] == got[wj] == (clean, n)


def test_fatal_error_is_never_retried(monkeypatch):
    """A confluent ``KafkaException`` whose error is ``fatal()`` ends the
    run at once in both packages: no retry, no ``Kafka_reconnects``."""
    for pkg in (wt, wj):
        with pytest.raises(Exception) as err:
            _roundtrip(pkg, monkeypatch, "confluent", list(range(10)),
                       source_hook=lambda c: c.fail_next("poll", 1, True))
        assert "injected poll failure" in str(err.value)
        assert "still failing" not in str(err.value)
        cluster = sys.modules["confluent_kafka"].cluster
        assert cluster.pending_faults("poll") == 0
        assert cluster.read_committed("out") == []


@pytest.mark.parametrize("client", CLIENTS)
def test_exhausted_retries_raise_as_in_jax(monkeypatch, client):
    """More consecutive errors than attempts: each package raises its
    "still failing after N retries" ``WindFlowError`` after N
    reconnects."""
    for pkg in (wt, wj):
        with pytest.raises(pkg.WindFlowError,
                           match="consume: still failing after 2 retries"):
            _roundtrip(pkg, monkeypatch, client, list(range(10)),
                       attempts=2,
                       source_hook=lambda c: c.fail_next("poll", 50))
        cluster = sys.modules["confluent_kafka" if client == "confluent"
                              else "kafka"].cluster
        assert cluster.pending_faults("poll") == 50 - 3


@pytest.mark.parametrize("client", ("confluent",))
def test_lost_delivery_fails_the_flush_as_in_jax(monkeypatch, client):
    """A failed delivery (the callback gets the error) makes the sink's
    flush raise "lost data" in both packages, never a silent loss."""
    for pkg in (wt, wj):
        with pytest.raises(Exception, match="lost data"):
            _roundtrip(pkg, monkeypatch, client, list(range(10)),
                       source_hook=lambda c: c.fail_next("deliver", 1))


# ---------------------------------------------------------------------------
# offsets with the checkpoint barrier
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("client", CLIENTS)
def test_offsets_commit_on_finalize_through_the_adapter(monkeypatch, client,
                                                        tmp_path):
    """A checkpointing source turns the consumer's auto-commit off: the
    group's offsets reach the broker only when the checkpoint requested
    at message 150 finalizes (150 of 400), not before and not at the
    end; the blob records the same offsets. Both packages."""
    for pkg in (wt, wj):
        cluster = install(monkeypatch, client, n_partitions=4)
        seed_topic(pkg, "in", list(range(400)), 4)
        seen, before = [], []

        def deser(msg, shipper, seen=seen, before=before):
            if msg is None:
                return False
            seen.append(msg.payload)
            if len(seen) <= 150:
                before.append(sum(v for (grp, _, _), v
                                  in cluster.committed.items()
                                  if grp == "g1"))
            shipper.push({"v": msg.payload})
            if len(seen) == 150:
                shipper.request_checkpoint()
            return True

        store = str(tmp_path / pkg.__name__)
        g = _pg(pkg, "kc_ckpt")
        g.with_checkpointing(store_dir=store)
        g.add_source(CONN[pkg].Kafka_Source(
            deser, BROKERS, ["in"], group_id="g1", idleness_ms=300,
            name="ksrc")).add_sink(pkg.Sink_Builder(lambda t: None)
                                   .with_name("snk").build())
        run_bounded(g)
        assert len(seen) == 400 and g._coordinator.completed == 1
        assert set(before) == {0}
        committed = {k: v for k, v in cluster.committed.items()
                     if k[0] == "g1"}
        assert sum(committed.values()) == 150
        cid, d, manifest = STORE[pkg].resolve(store)
        st = STORE[pkg](store).load_states(d, manifest)[("ksrc", 0)]
        assert {(t, p): o for (_, t, p), o in committed.items()} \
            == st["offsets"]


def test_kafka_python_exactly_once_refuses_as_in_jax(monkeypatch, tmp_path):
    """kafka-python has no transactional producer: a graph with an
    exactly-once Kafka sink refuses to build, in both packages."""
    for pkg in (wt, wj):
        install(monkeypatch, "kafka-python")
        g = _pg(pkg, "kc_eo_refuse")
        g.with_checkpointing(store_dir=str(tmp_path / pkg.__name__))
        g.add_source(pkg.Source_Builder(lambda sh: None).build()) \
            .add_sink(KAFKA[pkg].Kafka_Sink_Builder(lambda t: None)
                      .with_brokers(BROKERS)
                      .with_exactly_once(str(tmp_path / "txn")).build())
        with pytest.raises(pkg.WindFlowError,
                           match="kafka-python has no transactions"):
            run_bounded(g)


# ---------------------------------------------------------------------------
# YSB into the staged exactly-once sink over the confluent adapter
# ---------------------------------------------------------------------------
N_CAMPAIGNS, ADS_PER_CAMPAIGN, TS_STEP_US = 100, 10, 100
YSB_EVENTS, YSB_WIN_US, YSB_PARTS = 24_000, 1_000_000, 8


def _ysb_seed(pkg):
    t = CONN[pkg].make_transport(BROKERS)
    for i in range(YSB_EVENTS):
        t.produce("ad_events", {"ad_id": i % (N_CAMPAIGNS * ADS_PER_CAMPAIGN),
                                "event_type": i % 3, "ts": i * TS_STEP_US},
                  partition=i % YSB_PARTS)
    t.flush()


def _ysb_last(a, b_):
    return {"count": a["count"] + b_["count"], "last_ing": b_["last_ing"]}


def _ysb_model(ing):
    """(campaign, window) -> views, and -> the set of its views' ingest
    stamps (which view arrives last across two replicas is a race)."""
    counts, stamps = {}, {}
    for i in range(0, YSB_EVENTS, 3):
        k = ((i % (N_CAMPAIGNS * ADS_PER_CAMPAIGN)) // ADS_PER_CAMPAIGN,
             (i * TS_STEP_US) // YSB_WIN_US)
        counts[k] = counts.get(k, 0) + 1
        stamps.setdefault(k, set()).add(int(ing[i]))
    return counts, stamps


def _ysb_graph(pkg, ing, staging, store, hook=None):
    """Kafka rows (two replicas, explicit offsets of the 8 partitions)
    -> views -> ad -> campaign -> 1 s windows with the example's combine
    -> the exactly-once Kafka sink on ``ysb_out``."""
    last = {}

    def deser(msg, shipper, ctx):
        if msg is None:
            return False
        p = msg.payload
        shipper.push_with_timestamp(
            {"ad_id": p["ad_id"], "event_type": p["event_type"],
             "ing": ing[p["ts"] // TS_STEP_US]}, p["ts"])
        mine = last.setdefault(ctx.get_replica_index(), {})
        mine[msg.partition] = p["ts"]
        if len(mine) == YSB_PARTS // 2:
            shipper.set_next_watermark(
                max(shipper.current_watermark, min(mine.values())))
        if hook is not None:
            hook(shipper)
        return True

    def ser(r):
        if not r["valid"]:
            return None
        return ("ysb_out", None, (int(r["campaign"]), int(r["wid"]),
                                  int(r["count"]), int(r["last_ing"])))

    g = _pg(pkg, "ysb", time_policy="EVENT_TIME")
    g.with_checkpointing(store_dir=store)
    src = (KAFKA[pkg].Kafka_Source_Builder(deser).with_brokers(BROKERS)
           .with_topics("ad_events").with_idleness(100).with_parallelism(2)
           .with_offsets({("ad_events", p): 0 for p in range(YSB_PARTS)})
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
    sink = (KAFKA[pkg].Kafka_Sink_Builder(ser).with_brokers(BROKERS)
            .with_name("ksnk").with_exactly_once(staging).build())
    g.add_source(src).add(views).add(project).add(win).add_sink(sink)
    return g


def _requests_every(n_events):
    local = threading.local()

    def hook(shipper):
        local.n = getattr(local, "n", 0) + 1
        if local.n % n_events == 0:
            shipper.request_checkpoint()
    return hook


def _ysb_rows(cluster):
    """The output topic as a read_committed consumer sees it, and whether
    each (campaign, window) is there once."""
    rows = cluster.read_committed("ysb_out")
    keys = [(c, w) for c, w, _, _ in rows]
    return {(c, w): (n, li) for c, w, n, li in rows}, \
        len(keys) == len(set(keys))


def test_ysb_exactly_once_through_confluent_matches_jax_and_model(
        monkeypatch, tmp_path):
    """YSB over the confluent adapter into the staged exactly-once sink,
    a checkpoint every 3,000 events a replica: each (campaign, window) is
    visible once, with the counts of the JAX run and of the closed-form
    model; one Kafka transaction per committed epoch with records."""
    ing = np.random.default_rng(6).integers(0, 1 << 30, YSB_EVENTS)
    model, stamps = _ysb_model(ing)
    got = {}
    for pkg in (wt, wj):
        cluster = install(monkeypatch, "confluent", YSB_PARTS)
        _ysb_seed(pkg)
        root = tmp_path / pkg.__name__
        g = _ysb_graph(pkg, ing, str(root / "txn"), str(root / "store"),
                       hook=_requests_every(3000))
        run_bounded(g)
        rows, once = _ysb_rows(cluster)
        assert once and g._coordinator.completed >= 1
        assert cluster.txn_counts["committed"] >= 2
        assert cluster.txn_counts["aborted"] == 0
        got[pkg] = {k: n for k, (n, _) in rows.items()}
        assert all(li in stamps[k] for k, (_, li) in rows.items())
    assert got[wt] == got[wj] == model


def test_ysb_exactly_once_kill_and_restore_through_confluent(monkeypatch,
                                                            tmp_path):
    """The port's YSB graph over the confluent adapter dies after its
    first committed epoch and restores from it. At the crash no window is
    visible twice and every visible count is the model's; after the
    restore every window is visible once, equal to the model, nothing is
    left staged, and the crashed run's transactional producer is fenced
    by the restored run's ``init_transactions``."""
    ing = np.random.default_rng(7).integers(0, 1 << 30, YSB_EVENTS)
    model, stamps = _ysb_model(ing)
    cluster = install(monkeypatch, "confluent", YSB_PARTS)
    _ysb_seed(wt)
    store, staging = str(tmp_path / "store"), str(tmp_path / "txn")
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
        if n < 16000:
            return
        if StoreT(store).latest() is not None \
                and cluster.txn_counts["committed"] >= 1:
            raise Killed("after the first committed epoch")
        # under load the sources can reach their ends before an epoch
        # with windows commits: slow them down until one has
        time.sleep(0.002)

    g1 = _ysb_graph(wt, ing, staging, store, hook=hook)
    with pytest.raises((Killed, wt.basic.WorkerFailuresError)):
        run_bounded(g1)
    at_crash, once = _ysb_rows(cluster)
    assert once and 0 < len(at_crash) < len(model)
    assert all(model[k] == n and li in stamps[k]
               for k, (n, li) in at_crash.items())
    (snk,) = [o for o in g1._ops if o.name == "ksnk"]
    zombie = snk.replicas[0]._transport._txn_producer
    assert zombie is not None
    g2 = _ysb_graph(wt, ing, staging, store)
    run_bounded(g2, restore_from=store)
    rows, once = _ysb_rows(cluster)
    assert once and {k: n for k, (n, _) in rows.items()} == model
    assert all(li in stamps[k] for k, (_, li) in rows.items())
    from windflow_tpu_torch.sinks.transactional import EpochSegmentStore
    seg = EpochSegmentStore(os.path.join(staging, "ksnk_r0"))
    assert seg.pending_epochs() == [] and seg.committed_epochs()
    with pytest.raises(Exception, match="fenced"):
        zombie.begin_transaction()


def test_finished_replica_restores_at_its_end(monkeypatch, tmp_path):
    """Replica 0 of a two-replica Kafka source runs out of messages and
    retires; an epoch committed after that holds its retired blob, and
    the run then dies. The blob carries the replica's final offsets, so
    the restore resumes it at its end: every record is in the output
    topic once. (Without them the replica replays its partitions from
    the start, and an exactly-once sink delivers their records twice.)"""
    cluster = install(monkeypatch, "confluent", 4)
    t = conn_t.make_transport(BROKERS)
    for p, n in enumerate((6, 300, 6, 300)):  # replica 0 reads 0 and 2
        for j in range(n):
            t.produce("fin_in", p * 1_000 + j, partition=p)
    t.flush()
    want = sorted(p * 1_000 + j for p, n in enumerate((6, 300, 6, 300))
                  for j in range(n))
    store, staging = str(tmp_path / "store"), str(tmp_path / "txn")

    class Killed(Exception):
        pass

    def graph(crash):
        g = _pg(wt, "fin")
        seen = {"n": 0}

        def deser(msg, shipper, ctx):
            if msg is None:
                return False
            shipper.push({"v": msg.payload})
            if not crash or ctx.get_replica_index() != 1:
                return True
            seen["n"] += 1
            if seen["n"] == 200:
                # once replica 0 has retired, one epoch opens; its
                # barrier injects before the next message
                _wait(lambda: any(w.endswith("[0]") for w in
                                  g._coordinator._retired), "retirement")
                seen["cid"] = shipper.request_checkpoint()
            elif seen["n"] == 201:
                _wait(lambda: (StoreT(store).latest() or 0) >= seen["cid"],
                      "the epoch's commit")
            elif seen["n"] == 250:
                raise Killed("after an epoch holding a retired blob")
            return True

        g.with_checkpointing(store_dir=store)
        g.add_source(kt.Kafka_Source_Builder(deser).with_brokers(BROKERS)
                     .with_topics("fin_in").with_idleness(50)
                     .with_parallelism(2)
                     .with_offsets({("fin_in", p): 0 for p in range(4)})
                     .with_name("ksrc").build()) \
            .add_sink(kt.Kafka_Sink_Builder(
                lambda r: ("fin_out", None, int(r["v"])))
                .with_brokers(BROKERS).with_exactly_once(staging)
                .with_name("ksnk").build())
        return g

    with pytest.raises((Killed, wt.basic.WorkerFailuresError)):
        run_bounded(graph(True))
    _, d, manifest = StoreT.resolve(store)
    blob = StoreT(store).load_states(d, manifest)[("ksrc", 0)]
    assert blob["offsets"] == {("fin_in", 0): 6, ("fin_in", 2): 6}
    run_bounded(graph(False), restore_from=store)
    assert sorted(cluster.read_committed("fin_out")) == want


def _wait(cond, what, limit_s=30.0):
    end = time.monotonic() + limit_s
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"waited {limit_s:.0f}s for {what}")
        time.sleep(0.005)


def test_ysb_transaction_aborted_mid_epoch_stays_invisible(monkeypatch,
                                                            tmp_path):
    """The sink's first Kafka transaction fails on its second record: the
    adapter aborts it and the run dies with a record of an aborted
    transaction in the log. A read_committed consumer never sees it; the
    restore produces the epoch again in a new transaction, and every
    window is visible once, equal to the model."""
    ing = np.random.default_rng(9).integers(0, 1 << 30, YSB_EVENTS)
    model, _ = _ysb_model(ing)
    cluster = install(monkeypatch, "confluent", YSB_PARTS)
    _ysb_seed(wt)
    cluster.fail_next("produce", 1, after=1)  # the sink's second record
    store, staging = str(tmp_path / "store"), str(tmp_path / "txn")
    with pytest.raises(Exception, match="injected produce failure"):
        run_bounded(_ysb_graph(wt, ing, staging, store,
                               hook=_requests_every(3000)))
    assert cluster.txn_counts["aborted"] == 1
    assert cluster.read_committed("ysb_out") == []
    assert sum(cluster.end_offsets("ysb_out")) == 1  # the aborted record
    run_bounded(_ysb_graph(wt, ing, staging, store), restore_from=store)
    rows, once = _ysb_rows(cluster)
    assert once and {k: n for k, (n, _) in rows.items()} == model
    assert sum(cluster.end_offsets("ysb_out")) == len(model) + 1


def test_fake_cluster_follows_the_read_committed_rule():
    """The fake's transactional view, which the exactly-once checks
    rely on: records of an open transaction block a read_committed
    reader of their partition, aborted ones are skipped, committed ones
    and plain ones are read; ``init_transactions`` aborts the id's open
    transaction and fences its older producer."""
    cluster = Cluster(1)
    ck = make_confluent(cluster)
    plain = ck.Producer({"bootstrap.servers": BROKERS})
    plain.produce("t", value="p0")
    old = ck.Producer({"bootstrap.servers": BROKERS,
                       "transactional.id": "x"})
    old.init_transactions()
    old.begin_transaction()
    old.produce("t", value="a0")
    plain.produce("t", value="p1")
    assert cluster.read_committed("t") == ["p0"]  # blocked at "a0"
    new = ck.Producer({"bootstrap.servers": BROKERS,
                       "transactional.id": "x"})
    new.init_transactions()  # aborts "a0" and fences ``old``
    assert cluster.read_committed("t") == ["p0", "p1"]
    with pytest.raises(ck.KafkaException, match="fenced"):
        old.begin_transaction()
    new.begin_transaction()
    new.produce("t", value="c0")
    new.commit_transaction()
    assert cluster.read_committed("t") == ["p0", "p1", "c0"]
    assert dict(cluster.txn_counts) == {"aborted_by_init": 1, "fenced": 1,
                                        "committed": 1}
    c = ck.Consumer({"bootstrap.servers": BROKERS, "group.id": "g"})
    c.subscribe(["t"])
    got = [c.poll(0) for _ in range(4)]
    assert [m.value() for m in got[:3]] == ["p0", "p1", "c0"] \
        and got[3] is None


class _RecordingTransport:
    """A transport that records each epoch transaction."""

    supports_transactions = True

    def __init__(self):
        self.calls = []

    def txn_produce_epoch(self, txn_id, records):
        self.calls.append((txn_id, list(records)))


def test_staged_backend_recovery_matches_jax(tmp_path):
    """``_StagedKafkaBackend.do_recover`` over the same staged segments in
    both packages: pending epochs at or below ``last_epoch`` roll forward
    with one ``txn_produce_epoch`` each (an empty epoch needs none), later
    ones are aborted, committed ones stay."""
    from windflow_tpu.sinks.transactional import SegmentBackend
    rng = np.random.default_rng(3)
    base = tmp_path / "seg"
    staged = SegmentBackend(str(base))
    for epoch in range(1, 7):
        recs = [("out", int(p), None, int(v))
                for p, v in rng.integers(0, 4, (int(rng.integers(0, 4)), 2))]
        staged.do_precommit(epoch, recs)
    staged.do_commit(1)
    out = {}
    for pkg, conn in ((wt, conn_t), (wj, conn_j)):
        root = tmp_path / pkg.__name__
        shutil.copytree(base, root)
        rec = _RecordingTransport()
        backend = conn._StagedKafkaBackend(str(root), rec, "wf-txn-s-r0")
        rolled, aborted = backend.do_recover(4)
        store = backend._seg.store
        out[pkg] = (rolled, aborted, rec.calls, store.committed_epochs(),
                    store.pending_epochs())
    assert out[wt] == out[wj]
    rolled, aborted, calls, committed, pending = out[wt]
    assert [e for e, _ in rolled] == [2, 3, 4] and aborted == [5, 6]
    assert committed == [1, 2, 3, 4] and pending == []
    want = [recs for e in (2, 3, 4)
            for recs in [_staged_records(base, e)] if recs]
    assert [r for _, r in calls] == want


def _staged_records(root, epoch):
    import pickle
    with open(os.path.join(root, f"epoch_{epoch:010d}.pending"),
              "rb") as f:
        return pickle.load(f)
