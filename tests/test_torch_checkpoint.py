"""The port's checkpoint plane (``windflow_tpu_torch.checkpoint``) held
against the JAX package's: the store semantics of
``tests/test_checkpoint_recovery.py`` (atomic commit and retention,
resolve, re-staging, the topology-mismatch refusal), the barrier-alignment
property of ``tests/test_checkpoint_alignment.py`` (no post-barrier tuple
in a snapshot, over random merge DAGs with skewed sources) and the
alignment-stall statistic, plus the digest checks, the offline verify and
quarantine, the epoch timeout and the coordinator's statistics. Every
case runs through both packages (the port runs DEFAULT mode only, so the
alignment property is checked in DEFAULT mode in both).

Tolerance: the checks are exact (counts, positions, manifests)."""

from __future__ import annotations

import os
import random
import threading
import time
from types import SimpleNamespace

import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from windflow_tpu.checkpoint import CheckpointStore as StoreJ
from windflow_tpu.tpu import Map_TPU_Builder
from windflow_tpu_torch.checkpoint import CheckpointStore as StoreT


def _pkg(pkg):
    if pkg is wj:
        return SimpleNamespace(pkg=wj, Store=StoreJ, kw={})
    return SimpleNamespace(pkg=wt, Store=StoreT, kw={"device": "cpu"})


PKGS = pytest.mark.parametrize("pkg", [wj, wt], ids=["jax", "torch"])


def _graph(p, name):
    return p.pkg.PipeGraph(name, p.pkg.ExecutionMode.DEFAULT,
                           p.pkg.TimePolicy.INGRESS_TIME, **p.kw)


# ---------------------------------------------------------------------------
# store semantics (tests/test_checkpoint_recovery.py:380-440)
# ---------------------------------------------------------------------------
def _store_commit_and_retention(p, root):
    store = p.Store(root, retain=2)
    for cid in (1, 2, 3):
        store.begin(cid)
        store.write_blob(cid, "op", 0, {"cid": cid})
        store.commit(cid, {"graph": "t"})
    ids, latest = store.completed_ids(), store.latest()
    # an uncommitted (staging) checkpoint is invisible to restore
    store.begin(4)
    store.write_blob(4, "op", 0, {"cid": 4})
    cid, d, manifest = p.Store.resolve(root)
    return (ids, latest, store.latest(), cid,
            store.load_states(d, manifest), sorted(manifest["blobs"]))


def test_store_atomic_commit_and_retention(tmp_path):
    got = [_store_commit_and_retention(_pkg(pkg), str(tmp_path / name))
           for pkg, name in ((wj, "j"), (wt, "t"))]
    assert got[0] == got[1]
    ids, latest, latest_after, cid, states, _ = got[1]
    assert ids == [2, 3] and latest == 3 and latest_after == 3
    assert cid == 3 and states[("op", 0)] == {"cid": 3}


@PKGS
def test_store_resolve_specific_checkpoint(tmp_path, pkg):
    p = _pkg(pkg)
    store = p.Store(str(tmp_path))
    for cid in (1, 2):
        store.begin(cid)
        store.write_blob(cid, "op", 0, {"cid": cid})
        store.commit(cid, {"graph": "t"})
    cid, _, manifest = p.Store.resolve(store.checkpoint_dir(1))
    assert cid == 1 and manifest["ckpt_id"] == 1


@PKGS
def test_store_restage_clears_crashed_debris(tmp_path, pkg):
    p = _pkg(pkg)
    store = p.Store(str(tmp_path))
    store.begin(5)
    store.write_blob(5, "stale_op", 0, {"old": True})
    store.begin(5)  # a restarted coordinator re-opens the same epoch
    store.write_blob(5, "op", 0, {"new": True})
    store.commit(5, {"graph": "t"})
    _, d, manifest = p.Store.resolve(str(tmp_path))
    assert [b for b in manifest["blobs"] if "stale_op" in b] == []


def test_store_blob_names_and_digests_match_jax(tmp_path):
    """Both stores name a blob alike and digest its pickled payload into
    the manifest."""
    mans = []
    for p, name in ((_pkg(wj), "j"), (_pkg(wt), "t")):
        store = p.Store(str(tmp_path / name))
        store.begin(1)
        store.write_blob(1, "op/with:odd name", 3, {"v": 1})
        store.commit(1, {"graph": "t"})
        mans.append(p.Store.load_manifest(store.checkpoint_dir(1)))
    assert mans[0]["blobs"] == mans[1]["blobs"]
    assert set(mans[0]["digests"]) == set(mans[1]["digests"])
    assert all(v.startswith("sha256:") for v in mans[1]["digests"].values())


@PKGS
@pytest.mark.parametrize("damage", ["bitflip", "truncate", "append"])
def test_corrupt_blob_is_named_and_quarantined(tmp_path, pkg, damage):
    """A damaged blob fails its digest: ``load_states`` raises
    ``CorruptCheckpointError`` naming the file, ``verify`` reports it
    without raising, and ``quarantine`` takes the epoch out of the restore
    set."""
    p = _pkg(pkg)
    store = p.Store(str(tmp_path))
    for cid in (1, 2):
        store.begin(cid)
        store.write_blob(cid, "op", 0, {"cid": cid, "pad": list(range(50))})
        store.commit(cid, {"graph": "t"})
    d = store.checkpoint_dir(2)
    blob = os.path.join(d, store.load_manifest(d)["blobs"][0])
    data = bytearray(open(blob, "rb").read())
    if damage == "bitflip":
        data[len(data) // 2] ^= 0x40
    elif damage == "truncate":
        data = data[:len(data) // 2]
    else:
        data += b"garbage"
    open(blob, "wb").write(bytes(data))
    with pytest.raises(pkg.CorruptCheckpointError,
                       match=os.path.basename(blob)):
        store.load_states(d, store.load_manifest(d))
    report = store.verify()
    assert report[1]["ok"] and not report[2]["ok"]
    assert store.quarantine(2).endswith(".corrupt")
    assert store.latest() == 1


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------
class ReplaySource:
    """Replayable source: integers 0..n-1 keyed ``v % nk``, a checkpoint
    requested after ``ckpt_at`` pushes."""

    def __init__(self, n, nk=5, ckpt_at=None):
        self.n, self.nk, self.ckpt_at = n, nk, ckpt_at
        self.pos = 0

    def __call__(self, shipper):
        while self.pos < self.n:
            v = self.pos
            shipper.push({"k": v % self.nk, "v": v})
            self.pos += 1
            if self.ckpt_at is not None and self.pos == self.ckpt_at:
                assert shipper.request_checkpoint() is not None

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _reduce_graph(p, store, src, name="red"):
    g = _graph(p, "ck_red")
    g.with_checkpointing(store_dir=store)
    red = (p.pkg.Reduce_Builder(lambda t, s: (0 if s is None else s) + 1)
           .with_key_by(lambda t: t["k"]).with_name(name)
           .with_parallelism(2).build())
    g.add_source(p.pkg.Source_Builder(src).with_name("src").build()) \
        .add(red) \
        .add_sink(p.pkg.Sink_Builder(lambda t: None).with_name("snk")
                  .build())
    return g


@PKGS
def test_restore_rejects_topology_mismatch(tmp_path, pkg):
    """A checkpoint restores only into its own topology: another operator
    name is refused, and so is a lower parallelism."""
    p = _pkg(pkg)
    store = str(tmp_path / "store")
    g = _reduce_graph(p, store, ReplaySource(500, ckpt_at=200))
    g.run()
    assert g._coordinator.completed == 1
    g2 = _reduce_graph(p, str(tmp_path / "s2"), ReplaySource(500),
                       name="other_name")
    with pytest.raises(pkg.WindFlowError, match="does not contain"):
        g2.run(restore_from=store)
    g3 = _graph(p, "ck_red")
    g3.add_source(p.pkg.Source_Builder(ReplaySource(500)).with_name("src")
                  .build()) \
        .add(p.pkg.Reduce_Builder(lambda t, s: (s or 0) + 1)
             .with_key_by(lambda t: t["k"]).with_name("red").build()) \
        .add_sink(p.pkg.Sink_Builder(lambda t: None).with_name("snk")
                  .build())
    with pytest.raises(pkg.WindFlowError, match="parallelism"):
        g3.run(restore_from=store)


@PKGS
def test_restore_needs_a_replayable_source(tmp_path, pkg):
    """A source checkpointed with a replay position cannot resume from a
    functor that has no ``restore()``: the restored run fails loudly."""
    p = _pkg(pkg)
    store = str(tmp_path / "store")
    _reduce_graph(p, store, ReplaySource(300, ckpt_at=100)).run()

    def plain(shipper):
        shipper.push({"k": 0, "v": 0})

    with pytest.raises(pkg.WindFlowError, match="replayable"):
        _reduce_graph(p, str(tmp_path / "s2"), plain).run(
            restore_from=store)


@PKGS
def test_checkpoint_stats_and_trigger(tmp_path, pkg):
    """``trigger_checkpoint(wait=True)`` commits an epoch; the graph's
    ``Checkpoints`` section and the replicas' ``Checkpoint_*`` counters
    record it under the JAX package's keys."""
    p = _pkg(pkg)
    gate = threading.Event()

    class Gated(ReplaySource):
        def __call__(self, shipper):
            while self.pos < self.n:
                if self.pos == 200:
                    gate.wait(30)
                shipper.push({"k": self.pos % self.nk, "v": self.pos})
                self.pos += 1

    store = str(tmp_path / "store")
    g = _reduce_graph(p, store, Gated(400))
    g.start()
    cid = g._coordinator.trigger(force=True)
    gate.set()
    g._coordinator.wait_committed(cid, 30)
    g.wait_end()
    st = g.get_stats()
    ck = st["Checkpoints"]
    assert ck["Checkpoints_completed"] == 1 and ck["Checkpoint_last_id"] == 1
    assert ck["Checkpoint_last_bytes"] > 0
    reps = [r for op in st["Operators"] for r in op["replicas"]]
    assert sum(r["Checkpoint_snapshots"] for r in reps) == 4
    assert sum(r["Checkpoint_bytes_total"] for r in reps) \
        == ck["Checkpoint_last_bytes"]
    assert p.Store(store).latest() == 1


@PKGS
def test_interval_checkpoints(tmp_path, pkg):
    """``with_checkpointing(interval=...)``: the coordinator's timer opens
    epochs while the stream runs; each commits, ids increase, and the
    store keeps the last ``retain``."""
    p = _pkg(pkg)

    class Slow(ReplaySource):
        def __call__(self, shipper):
            while self.pos < self.n:
                shipper.push({"k": self.pos % self.nk, "v": self.pos})
                self.pos += 1
                if self.pos % 50 == 0:
                    time.sleep(0.02)

    store = str(tmp_path / "store")
    g = _graph(p, "ck_interval")
    g.with_checkpointing(interval=0.1, store_dir=store, retain=2)
    g.add_source(p.pkg.Source_Builder(Slow(2000)).with_name("src").build())\
        .add(p.pkg.Reduce_Builder(lambda t, s: (s or 0) + 1)
             .with_key_by(lambda t: t["k"]).with_name("red").build()) \
        .add_sink(p.pkg.Sink_Builder(lambda t: None).with_name("snk")
                  .build())
    g.run()
    done = g._coordinator.completed
    assert done >= 2
    ids = p.Store(store).completed_ids()
    assert len(ids) == 2 and ids[-1] == g._coordinator.last_completed_id


def test_epoch_timeout_names_the_unacked_workers(tmp_path, monkeypatch):
    """An epoch that cannot complete (a worker never sees its barrier)
    fails after the timeout, naming the workers that never acked, in both
    packages (the JAX package reads ``WF_CKPT_TIMEOUT``, the port takes
    ``with_checkpointing(epoch_timeout_s=...)``)."""
    monkeypatch.setenv("WF_CKPT_TIMEOUT", "0.5")
    for pkg in (wj, wt):
        p = _pkg(pkg)
        gate = threading.Event()

        def src(shipper, _gate=gate):
            shipper.push({"k": 0, "v": 0})
            _gate.wait(30)  # parked: never reaches a push boundary

        g = _graph(p, "ck_timeout")
        if pkg is wt:
            g.with_checkpointing(store_dir=str(tmp_path / "t"),
                                 epoch_timeout_s=0.5)
        else:
            g.with_checkpointing(store_dir=str(tmp_path / "j"))
        g.add_source(p.pkg.Source_Builder(src).with_name("src").build()) \
            .add_sink(p.pkg.Sink_Builder(lambda t: None).with_name("snk")
                      .build())
        g.start()
        try:
            with pytest.raises(pkg.WindFlowError,
                               match=r"timed out.*never acked: .*src"):
                g.trigger_checkpoint(wait=True)
        finally:
            gate.set()
            g.wait_end()


# ---------------------------------------------------------------------------
# barrier alignment (tests/test_checkpoint_alignment.py:55 and :252)
# ---------------------------------------------------------------------------
class SkewedSource:
    def __init__(self, n, src_id, ckpt_at=None, sleep_every=0, sleep_s=0.0):
        self.n, self.src_id, self.ckpt_at = n, src_id, ckpt_at
        self.sleep_every, self.sleep_s = sleep_every, sleep_s
        self.pos = 0

    def __call__(self, shipper):
        while self.pos < self.n:
            shipper.push({"src": self.src_id, "v": self.pos})
            self.pos += 1
            if self.sleep_every and self.pos % self.sleep_every == 0:
                time.sleep(self.sleep_s)
            if self.ckpt_at is not None and self.pos == self.ckpt_at:
                shipper.request_checkpoint()

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _alignment_case(p, seed, root):
    rng = random.Random(0xA11C + seed)
    n_sources = rng.randint(2, 4)
    counts = [rng.randint(150, 2500) for _ in range(n_sources)]
    trig = rng.randrange(n_sources)
    ckpt_at = rng.randint(50, counts[trig])
    batching = rng.choice([0, 0, 8, 32])
    consumer_par = rng.randint(1, 3)
    g = _graph(p, f"align{seed}")
    g.with_checkpointing(store_dir=root)
    pipes = []
    for i in range(n_sources):
        slow = rng.random() < 0.5
        s = SkewedSource(
            counts[i], i, ckpt_at=ckpt_at if i == trig else None,
            sleep_every=rng.choice([50, 100, 200]) if slow else 0,
            sleep_s=rng.choice([0.0005, 0.001]) if slow else 0.0)
        pipes.append(g.add_source(
            p.pkg.Source_Builder(s).with_name(f"s{i}")
            .with_output_batch_size(batching).build()))
    red = (p.pkg.Reduce_Builder(lambda t, s: (0 if s is None else s) + 1)
           .with_key_by(lambda t: t["src"]).with_name("red")
           .with_parallelism(consumer_par).build())
    pipes[0].merge(*pipes[1:]).add(red) \
        .add_sink(p.pkg.Sink_Builder(lambda t: None).with_name("snk")
                  .build())
    g.run()
    assert g._coordinator.completed == 1
    st = p.Store(root)
    d = st.checkpoint_dir(st.latest())
    states = st.load_states(d, st.load_manifest(d))
    seen: dict = {}
    for idx in range(consumer_par):
        for k, v in states[("red", idx)].get("key_state", {}).items():
            seen[k] = seen.get(k, 0) + v
    for i in range(n_sources):
        position = states[(f"s{i}", 0)]["position"]
        assert seen.get(i, 0) == position, (
            f"seed={seed} source {i}: the snapshot saw {seen.get(i, 0)} "
            f"tuples but the source's barrier position was {position} "
            f"(batching={batching}, par={consumer_par})")
    return n_sources


@pytest.mark.parametrize("seed", range(8))
def test_no_post_barrier_tuple_in_snapshot(seed, tmp_path):
    """Exact-prefix consistency: for every source, the tuples counted in
    the downstream keyed state of the checkpoint equal that source's
    recorded position — no post-barrier tuple leaks in, no pre-barrier
    tuple is left out. Random source counts, rate skew, merge fan-in,
    batching and consumer parallelism."""
    for pkg, name in ((wj, "j"), (wt, "t")):
        _alignment_case(_pkg(pkg), seed, str(tmp_path / name))


def _device_alignment_case(p, seed, root):
    """Sources -> a device map each (its exit to the host holds batches
    in a D2H pipeline) -> merge -> device map -> device split (a callable:
    the splitting emitter holds batches too) -> two host branches ->
    merge -> host Reduce counting per source."""
    rng = random.Random(0xD1CE + seed)
    n_sources = rng.randint(2, 3)
    counts = [rng.randint(300, 2000) for _ in range(n_sources)]
    trig = rng.randrange(n_sources)
    ckpt_at = rng.randint(50, counts[trig])
    Map = Map_TPU_Builder if p.pkg is wj else wt.Map_GPU_Builder
    g = _graph(p, f"dalign{seed}")
    g.with_checkpointing(store_dir=root)
    pipes = []
    for i in range(n_sources):
        s = SkewedSource(counts[i], i,
                         ckpt_at=ckpt_at if i == trig else None,
                         sleep_every=100 if i % 2 else 0, sleep_s=0.001)
        mp = g.add_source(p.pkg.Source_Builder(s).with_name(f"s{i}")
                          .with_output_batch_size(16).build())
        mp.add(Map(lambda f: {**f, "v": f["v"] + 1}).with_name(f"m{i}")
               .build())
        pipes.append(mp)
    mp = pipes[0].merge(*pipes[1:])
    mp.add(Map(lambda f: dict(f)).with_name("mid").build())
    mp.split(lambda t: t["v"] % 2, 2)
    b0 = mp.select(0).add(p.pkg.Map_Builder(lambda t: t).with_name("h0")
                          .build())
    b1 = mp.select(1).add(p.pkg.Map_Builder(lambda t: t).with_name("h1")
                          .build())
    red = (p.pkg.Reduce_Builder(lambda t, s: (0 if s is None else s) + 1)
           .with_key_by(lambda t: t["src"]).with_name("red").build())
    b0.merge(b1).add(red) \
        .add_sink(p.pkg.Sink_Builder(lambda t: None).with_name("snk")
                  .build())
    g.run()
    assert g._coordinator.completed == 1
    st = p.Store(root)
    d = st.checkpoint_dir(st.latest())
    states = st.load_states(d, st.load_manifest(d))
    seen = states[("red", 0)]["key_state"]
    for i in range(n_sources):
        assert seen.get(i, 0) == states[(f"s{i}", 0)]["position"], (
            f"seed={seed} source {i}: {seen.get(i, 0)} tuples in the "
            f"snapshot, barrier position "
            f"{states[(f's{i}', 0)]['position']}")


@pytest.mark.parametrize("seed", range(4))
def test_no_post_barrier_tuple_through_device_pipelines(seed, tmp_path):
    """The exact-prefix property with device stages on the path: the
    exit emitters and the device splitting emitter keep batches in their
    D2H pipelines, and each must deliver them before the barrier — a
    pre-barrier row that landed behind the barrier would be missing from
    the snapshot."""
    for pkg, name in ((wj, "j"), (wt, "t")):
        _device_alignment_case(_pkg(pkg), seed, str(tmp_path / name))


def test_two_stage_alignment_stall_recorded(tmp_path):
    """A multi-input worker that aligns a skewed barrier records the
    stall; the checkpoint commits exactly once."""
    for pkg, name in ((wj, "j"), (wt, "t")):
        p = _pkg(pkg)
        g = _graph(p, "align_stats")
        g.with_checkpointing(store_dir=str(tmp_path / name))
        fast = SkewedSource(3000, 0, ckpt_at=500)
        slow = SkewedSource(1200, 1, sleep_every=50, sleep_s=0.002)
        p0 = g.add_source(p.pkg.Source_Builder(fast).with_name("s0")
                          .build())
        p1 = g.add_source(p.pkg.Source_Builder(slow).with_name("s1")
                          .build())
        red = (p.pkg.Reduce_Builder(lambda t, s: (0 if s is None else s) + 1)
               .with_key_by(lambda t: t["src"]).with_name("red").build())
        p0.merge(p1).add(red) \
            .add_sink(p.pkg.Sink_Builder(lambda t: None).with_name("snk")
                      .build())
        g.run()
        assert g._coordinator.completed == 1
        reps = [op for op in g.get_stats()["Operators"]
                if op["name"] == "red"][0]["replicas"]
        assert sum(r["Checkpoint_snapshots"] for r in reps) == 1
        # the fast channel's barrier waited on the slow channel
        assert sum(r["Checkpoint_align_stall_usec_total"]
                   for r in reps) > 0
