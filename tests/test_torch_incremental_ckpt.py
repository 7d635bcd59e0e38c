"""Incremental and asynchronous checkpoints of the port
(``with_checkpointing(delta=True, async_upload=True, full_every=N)``) held
against the JAX package's (``WF_CKPT_DELTA`` / ``WF_CKPT_ASYNC`` /
``WF_CKPT_FULL_EVERY``): every case of ``tests/test_incremental_ckpt.py``
runs through both packages on the same inputs (made from a seed with
numpy), plus the restore of a JAX-written delta chain into a port graph,
the delta snapshot of each keyed engine kind, and the uploader's failure
contract.

- delta nodes: make / resolve / materialize, nested nodes, carry, shards,
  and the eligibility gates of the snapshot context;
- the store: refs to unchanged blobs, retention keeping the refs/deps
  closure, ``verify`` flagging every dependent of a corrupt ancestor, an
  uncommitted upload staying invisible;
- the megabatch carry of the dirty bitmap;
- the Zipf differential over {full, delta, delta+async}, without and with
  a kill (the port restores with ``run(restore_from=...)``; the JAX test
  recovers under supervision, which the port does not have yet);
- the FFAT window's delta epochs (host dirty sets, the zero-byte key
  directory carry, the forest rows), held against the JAX package's and a
  FULL run's, and a kill and restore from an FFAT delta epoch;
- a dense delta-latest checkpoint adopted by a tiered graph, and the tier
  WAL's delta round trip.

Manifests (``blobs``, ``refs``, ``deps``), materialized states and
emitted rows must equal the JAX package's. Tolerance: exact. The values
are integers, and the float32 running sums of integers below 2^24 are
exact in both packages.
"""

from __future__ import annotations

import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import join_bounded, run_bounded
from windflow_tpu.checkpoint import CheckpointStore as StoreJ
from windflow_tpu.checkpoint import delta as delta_j
from windflow_tpu.tpu import Ffat_Windows_TPU_Builder, Map_TPU_Builder
from windflow_tpu_torch.checkpoint import CheckpointCoordinator
from windflow_tpu_torch.checkpoint import CheckpointStore as StoreT
from windflow_tpu_torch.checkpoint import delta as delta_t
from windflow_tpu_torch.checkpoint.store import blob_name
from windflow_tpu_torch.convert import checkpoint_states_from_jax

COMMIT_WAIT_S = 20.0


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), \
            f"{path}: keys {set(a)} != {set(b)}"
        for k in a:
            _tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            _tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.asarray(a).dtype == np.asarray(b).dtype, \
            f"{path}: dtype {np.asarray(a).dtype} != {np.asarray(b).dtype}"
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def _both(case):
    """``case(delta_module)`` through both packages; the results must be
    equal. Returns the port's."""
    got_j, got_t = case(delta_j), case(delta_t)
    _tree_equal(got_j, got_t)
    return got_t


# ---------------------------------------------------------------------------
# delta-node round trips
# ---------------------------------------------------------------------------
def test_delta_make_resolve_roundtrip():
    base = {"table": {"acc": np.arange(10.0), "cnt": np.arange(10)},
            "slot_of_key": {1: 0, 2: 1}, "cap": 10}

    def case(d):
        node = d.make_delta(
            3,
            rows={"table": {"slots": np.array([2, 5]),
                            "leaves": [np.array([20.0, 50.0]),
                                       np.array([7, 9])]}},
            replace={"slot_of_key": {1: 0, 2: 1, 3: 2}, "cap": 10})
        assert d.is_delta(node) and d.delta_bases(node) == {3}
        return d.materialize(node, {3: base})

    full = _both(case)
    assert set(full) == {"table", "slot_of_key", "cap"}
    want_acc = np.arange(10.0)
    want_acc[[2, 5]] = [20.0, 50.0]
    want_cnt = np.arange(10)
    want_cnt[[2, 5]] = [7, 9]
    np.testing.assert_array_equal(full["table"]["acc"], want_acc)
    np.testing.assert_array_equal(full["table"]["cnt"], want_cnt)
    assert full["slot_of_key"] == {1: 0, 2: 1, 3: 2}
    # the base is never mutated in place
    np.testing.assert_array_equal(base["table"]["acc"], np.arange(10.0))


def test_delta_nested_in_blob_tree():
    base_blob = {"scan": {"table": np.zeros(4), "cap": 4}, "wm": 17}

    def case(d):
        node = d.make_delta(
            1, rows={"table": {"slots": np.array([1]),
                               "leaves": [np.array([9.0])]}},
            replace={"cap": 4})
        state = {"scan": node, "wm": 23}
        # a missing base fails loudly, never gives partial state
        with pytest.raises(ValueError):
            d.resolve(state, {2: base_blob})
        return d.materialize(state, {1: base_blob})

    full = _both(case)
    np.testing.assert_array_equal(full["scan"]["table"],
                                  np.array([0.0, 9.0, 0.0, 0.0]))
    assert full["wm"] == 23


def test_delta_carry_fields():
    nk = 10_000
    base = {"table": np.zeros(nk),
            "slot_of_key": {i: i for i in range(nk)}, "cap": nk}
    rows = {"table": {"slots": np.array([2]), "leaves": [np.array([7.0])]}}

    def case(d):
        node = d.make_delta(1, rows=rows, carry=["slot_of_key", "cap"])
        fat = d.make_delta(1, rows=rows,
                           replace={"slot_of_key": base["slot_of_key"],
                                    "cap": nk})
        # the carry costs zero bytes: the directory is not re-pickled
        assert len(pickle.dumps(node)) < len(pickle.dumps(fat)) / 100
        return d.materialize(node, {1: base})

    full = _both(case)
    assert full["slot_of_key"] == base["slot_of_key"]
    assert full["cap"] == nk
    want = np.zeros(nk)
    want[2] = 7.0
    np.testing.assert_array_equal(full["table"], want)


def test_delta_shards_patch():
    base = {"table_shards": [{"v": np.zeros(3)}, {"v": np.ones(3)}]}

    def case(d):
        node = d.make_delta(
            2, shards={"table_shards": [None, {"slots": np.array([0]),
                                               "leaves": [np.array([5.0])]}]})
        return d.materialize({"s": node}, {2: {"s": base}})

    full = _both(case)
    np.testing.assert_array_equal(full["s"]["table_shards"][0]["v"],
                                  np.zeros(3))
    np.testing.assert_array_equal(full["s"]["table_shards"][1]["v"],
                                  np.array([5.0, 1.0, 1.0]))


def test_delta_eligibility_gates(tmp_path, monkeypatch):
    """The JAX gates read ``WF_CKPT_*``; the port's context carries the
    graph's arguments. Each gate answers alike."""
    monkeypatch.setenv("WF_CKPT_DELTA", "1")
    monkeypatch.setenv("WF_CKPT_FULL_EVERY", "3")
    got = {}
    for name, Store in (("j", StoreJ), ("t", StoreT)):
        st = Store(str(tmp_path / name))
        st.begin(1)
        st.write_blob(1, "op", 0, {"x": 1})
        st.commit(1, {})
        if name == "j":
            ctx = delta_j.SnapshotContext(2, st)
            ok = lambda b, n, c=ctx: delta_j.delta_eligible(b, n, c)
            none = delta_j.delta_eligible(1, 0, None)
        else:
            ctx = delta_t.SnapshotContext(2, st, delta=True, full_every=3)
            ok = lambda b, n, c=ctx: delta_t.delta_eligible(b, n, c)
            none = delta_t.delta_eligible(1, 0, None)
        # committed base and cadence not due; cadence due; base never
        # committed; no capture context (retirement snapshots)
        got[name] = [ok(1, 0), ok(1, 1), ok(1, 2), ok(7, 0), none]
    assert got["j"] == got["t"] == [True, True, False, False, False]
    monkeypatch.setenv("WF_CKPT_DELTA", "0")
    st = StoreT(str(tmp_path / "t"))
    assert not delta_j.delta_eligible(1, 0, delta_j.SnapshotContext(
        2, StoreJ(str(tmp_path / "j"))))
    assert not delta_t.delta_eligible(1, 0, delta_t.SnapshotContext(
        2, st, delta=False, full_every=3))


# ---------------------------------------------------------------------------
# the store: refs, the retention closure, the verify closure
# ---------------------------------------------------------------------------
def _store(pkg_name, root, retain=3):
    if pkg_name == "j":
        return StoreJ(root, retain=retain)
    return StoreT(root, retain=retain, delta=True)


def _manifest(st, cid):
    m = type(st).load_manifest(st._dirname(cid))
    return {k: m.get(k) for k in ("blobs", "refs", "deps")}


def test_store_ref_dedup_unchanged_blob(tmp_path, monkeypatch):
    monkeypatch.setenv("WF_CKPT_DELTA", "1")
    state = {"pos": 42, "buf": np.arange(100)}
    fname = blob_name("op", 0)
    mans, loaded = {}, {}
    for name in ("j", "t"):
        st = _store(name, str(tmp_path / name))
        st.begin(1)
        st.write_blob(1, "op", 0, state)
        st.commit(1, {})
        st.begin(2)
        st.write_blob(2, "op", 0, state)  # identical payload
        st.write_blob(2, "other", 0, {"pos": 2})
        st.commit(2, {})
        mans[name] = _manifest(st, 2)
        assert mans[name]["refs"] == {fname: 1}
        assert not os.path.exists(os.path.join(st._dirname(2), fname))
        assert st.delta_blobs >= 1
        # restore resolves the ref through the ancestor's blob, and the
        # offline sweep verifies the ref'd blob where it lies
        loaded[name] = st.load_states(st._dirname(2),
                                      type(st).load_manifest(
                                          st._dirname(2)))
        assert all(r["ok"] for r in st.verify().values())
    assert mans["j"] == mans["t"]
    _tree_equal(loaded["j"], loaded["t"])
    np.testing.assert_array_equal(loaded["t"][("op", 0)]["buf"],
                                  np.arange(100))


def _chain_store(name, root, retain=10):
    """Epoch 1 FULL, epochs 2..5 deltas patching base 1 (an engine's base
    is always its last FULL snapshot)."""
    st = _store(name, root, retain)
    d = delta_j if name == "j" else delta_t
    st.begin(1)
    st.write_blob(1, "op", 0, {"pos": 1, "table": np.arange(8.0)})
    st.commit(1, {})
    for cid in (2, 3, 4, 5):
        node = d.make_delta(
            1, rows={"table": {"slots": np.array([cid % 8]),
                               "leaves": [np.array([cid * 10.0])]}},
            replace={"pos": cid})
        st.begin(cid)
        st.write_blob(cid, "op", 0, node)
        st.commit(cid, {})
    return st


def test_prune_keeps_delta_bases(tmp_path, monkeypatch):
    """retain=2 keeps {4, 5}, and both depend on base 1: retention keeps
    the dependency closure, not just the last K."""
    monkeypatch.setenv("WF_CKPT_DELTA", "1")
    got = {}
    for name, Store in (("j", StoreJ), ("t", StoreT)):
        root = str(tmp_path / name)
        st = _chain_store(name, root, retain=2)
        assert set(st.completed_ids()) == {1, 4, 5}
        assert os.path.isdir(st._dirname(1))
        assert not os.path.isdir(st._dirname(2))
        cid, d, man = Store.resolve(root)
        assert cid == 5 and man["deps"] == {blob_name("op", 0): [1]}
        got[name] = st.load_states(d, man)[("op", 0)]
    _tree_equal(got["j"], got["t"])
    assert got["t"]["pos"] == 5
    np.testing.assert_array_equal(
        got["t"]["table"],
        np.array([0.0, 1.0, 2.0, 3.0, 4.0, 50.0, 6.0, 7.0]))


def test_prune_keeps_ref_ancestors(tmp_path, monkeypatch):
    """Unchanged payloads: epochs 2..5 ref epoch 1's blob, so pruning to
    retain=2 keeps epoch 1 alive for them."""
    monkeypatch.setenv("WF_CKPT_DELTA", "1")
    state = {"frozen": np.arange(64)}
    got, mans = {}, {}
    for name, Store in (("j", StoreJ), ("t", StoreT)):
        root = str(tmp_path / name)
        st = _store(name, root, retain=2)
        for cid in (1, 2, 3, 4, 5):
            st.begin(cid)
            st.write_blob(cid, "op", 0, state)
            st.write_blob(cid, "mover", 0, {"pos": cid})
            st.commit(cid, {})
        assert set(st.completed_ids()) == {1, 4, 5}
        cid, d, man = Store.resolve(root)
        mans[name] = _manifest(st, cid)
        got[name] = st.load_states(d, man)
    assert mans["j"] == mans["t"]
    _tree_equal(got["j"], got["t"])
    np.testing.assert_array_equal(got["t"][("op", 0)]["frozen"],
                                  np.arange(64))
    assert got["t"][("mover", 0)]["pos"] == 5


def test_verify_flags_every_dependent(tmp_path, monkeypatch):
    monkeypatch.setenv("WF_CKPT_DELTA", "1")
    bad = {}
    for name, Store in (("j", StoreJ), ("t", StoreT)):
        root = str(tmp_path / name)
        st = _chain_store(name, root)
        path = os.path.join(st._dirname(1), blob_name("op", 0))
        with open(path, "r+b") as f:
            f.seek(3)
            b = f.read(1)
            f.seek(3)
            f.write(bytes([b[0] ^ 0xFF]))
        rep = Store(root).verify()
        # one corrupt ancestor poisons itself and every epoch whose chain
        # passes through it
        bad[name] = sorted(cid for cid, r in rep.items() if not r["ok"])
        cid, d, man = Store.resolve(root)
        err = (wj if name == "j" else wt).CorruptCheckpointError
        with pytest.raises(err):
            Store(root).load_states(d, man)
    assert bad["j"] == bad["t"] == [1, 2, 3, 4, 5]


def test_async_upload_failure_fails_epoch_loudly(tmp_path):
    """An upload that dies before the commit leaves nothing visible, and
    a later epoch commits and prunes the dead staging directory (the store
    side of the contract; the coordinator side is
    ``test_failed_upload_fails_its_epoch_and_the_run``)."""
    for name, Store in (("j", StoreJ), ("t", StoreT)):
        st = Store(str(tmp_path / name))
        st.begin(1)
        st.write_blob(1, "op", 0, {"pos": 1})
        assert st.completed_ids() == [] and st.latest() is None
        st.begin(2)
        st.write_blob(2, "op", 0, {"pos": 2})
        st.commit(2, {})
        assert st.completed_ids() == [2]
        assert not os.path.isdir(st._dirname(1, staging=True))


# ---------------------------------------------------------------------------
# megabatch: the dirty bits survive all K batches of a group
# ---------------------------------------------------------------------------
class _Sink:
    def emit_device_batch(self, b):
        pass

    def set_stats(self, s):
        pass


def _dirty_after_megabatch(pkg):
    """2K batches of B rows, each touching its own 8 keys, through a
    fused smap ∘ map chain at megabatch K. Returns (dirty bitmap over the
    table's rows, slot_of_key, touched keys, programs run before the final
    drain)."""
    from windflow_tpu.runtime.dispatch import DeviceDispatchQueue as DQJ
    from windflow_tpu.tpu.batch import BatchTPU
    from windflow_tpu.tpu.fused_ops import FusedTPUReplica
    from windflow_tpu.tpu.ops_tpu import Map_TPU
    from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
    from windflow_tpu_torch.gpu.batch import BatchGPU
    from windflow_tpu_torch.gpu.fused_ops import FusedGPUReplica
    from windflow_tpu_torch.gpu.ops_gpu import Map_GPU
    from windflow_tpu_torch.gpu.schema import TupleSchema as SchemaT
    from windflow_tpu_torch.runtime.dispatch import DeviceDispatchQueue as DQT

    K, B, GROUPS = 4, 64, 8
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    sm = (Map(lambda row, st: ({"k": row["k"], "v": st + row["v"]},
                               st + row["v"]))
          .with_state(np.float32(0)).with_key_by("k").with_name("sm")
          .build())
    if pkg is wj:
        fr = FusedTPUReplica([sm, Map_TPU(lambda f: f, name="id")], 0)
        fr.dispatch = DQJ(stats=fr.stats, depth=K, megabatch=K)
    else:
        fr = FusedGPUReplica([sm, Map_GPU(lambda f: f, name="id")], 0)
        fr.dispatch = DQT(stats=fr.stats, depth=K, megabatch=K)
    fr.set_emitter(_Sink())
    dts = {"k": np.int32, "v": np.float32}
    rng = np.random.default_rng(0)
    touched = set()
    for j in range(2 * K):
        keys = (j * GROUPS + rng.integers(0, GROUPS, B)).astype(np.int64)
        touched.update(keys.tolist())
        cols = {"k": keys.astype(np.int32), "v": np.ones(B, np.float32)}
        ts = np.arange(B, dtype=np.int64)
        if pkg is wj:
            import jax
            b = BatchTPU({k: jax.device_put(v) for k, v in cols.items()},
                         ts, B, SchemaJ(dts), host_keys=keys)
        else:
            b = BatchGPU({k: torch.from_numpy(v) for k, v in cols.items()},
                         ts, B, SchemaT(dts), host_keys=keys)
        fr.handle_msg(0, b)
    progs = fr.stats.device_programs_run
    fr.dispatch.drain()
    eng = [s.engine for s in fr.specs if s.engine is not None][0]
    cap = eng.table_capacity
    dirty = np.asarray(eng.dirty if pkg is wj
                       else eng.dirty[:cap].numpy()).astype(bool)
    return dirty[:cap], dict(eng.slot_of_key), touched, progs, 2 * K


def test_megabatch_dirty_bitmap_carry():
    got = {}
    for pkg, name in ((wj, "j"), (wt, "t")):
        dirty, slots, touched, progs, n_batches = _dirty_after_megabatch(pkg)
        # the megabatch path folded batches into groups
        assert progs < n_batches
        # every key a folded batch touched is marked, and only those
        for key in sorted(touched):
            assert dirty[slots[key]], \
                f"{name}: key {key} (slot {slots[key]}) lost its dirty bit"
        assert set(np.nonzero(dirty)[0].tolist()) \
            == {slots[k] for k in touched}
        got[name] = (dirty, slots)
    np.testing.assert_array_equal(got["j"][0], got["t"][0])
    assert got["j"][1] == got["t"][1]


# ---------------------------------------------------------------------------
# pipeline differentials
# ---------------------------------------------------------------------------
class _Boom(Exception):
    pass


class _ScanSource:
    """Replayable keyed pusher whose checkpoints are commit-waited: each
    requested epoch is on disk before the stream goes on, which makes the
    epoch <-> position mapping deterministic in every mode. The wait is
    bounded: a missing commit shows as a mismatch, never a hang."""

    def __init__(self, keys, vals, store, Store, ckpt_at=(), crash_at=None):
        self.keys, self.vals = keys, vals
        self.store, self.Store = store, Store
        self.ckpt_at = set(ckpt_at)
        self.crash_at = crash_at
        self.crashes = 0
        self.pos = 0
        self.first = None

    def __call__(self, shipper):
        st = self.Store(self.store)
        n = len(self.keys)
        while self.pos < n:
            if self.crash_at is not None and self.pos == self.crash_at \
                    and self.crashes < 1:
                self.crashes += 1
                raise _Boom(f"killed at tuple {self.pos}")
            i = self.pos
            if self.first is None:
                self.first = i
            shipper.push({"k": int(self.keys[i]),
                          "v": float(self.vals[i])})
            self.pos += 1
            if self.pos in self.ckpt_at:
                before = st.latest() or 0
                shipper.request_checkpoint()
                deadline = time.time() + COMMIT_WAIT_S
                while (st.latest() or 0) <= before \
                        and time.time() < deadline:
                    time.sleep(0.002)

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


_MODE_ENV = {
    "full": {"WF_CKPT_DELTA": "0", "WF_CKPT_ASYNC": "0"},
    "delta": {"WF_CKPT_DELTA": "1", "WF_CKPT_ASYNC": "0",
              "WF_CKPT_FULL_EVERY": "3"},
    "delta_async": {"WF_CKPT_DELTA": "1", "WF_CKPT_ASYNC": "1",
                    "WF_CKPT_FULL_EVERY": "3"},
}
_MODE_ARGS = {
    "full": {},
    "delta": {"delta": True, "full_every": 3},
    "delta_async": {"delta": True, "async_upload": True, "full_every": 3},
}


def _scan_graph(pkg, store, src, rows, mode, tiered=False, retain=8,
                hot_capacity=8, db_dir=None):
    """Source -> keyed running-sum scan -> sink, checkpointing into
    ``store`` in ``mode`` (the JAX side reads the mode from the
    environment, ``_set_mode``)."""
    kw = {} if pkg is wj else {"device": "cpu"}
    g = pkg.PipeGraph("inc_ckpt", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **kw)
    ck = {} if pkg is wj else _MODE_ARGS[mode]
    g.with_checkpointing(store_dir=store, retain=retain, **ck)
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    mb = (Map(lambda row, st: ({"k": row["k"], "v": st + row["v"]},
                               st + row["v"]))
          .with_state(np.float32(0)).with_key_by("k").with_name("scan"))
    if tiered:
        mb = mb.with_tiering(policy="lru", hot_capacity=hot_capacity,
                             db_dir=db_dir)

    def sink(t):
        if t is not None:
            rows.append((int(t["k"]), float(t["v"])))

    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(8).build()) \
        .add(mb.build()) \
        .add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    return g


def _set_mode(monkeypatch, mode):
    for k, v in _MODE_ENV[mode].items():
        monkeypatch.setenv(k, v)


def _pkgs():
    return ((wj, "j", StoreJ), (wt, "t", StoreT))


def _states(Store, root, cid):
    st = Store(root)
    d = st._dirname(cid)
    return st.load_states(d, Store.load_manifest(d))


def test_zipf_differential_full_delta_async(tmp_path, monkeypatch):
    """One Zipf schedule through {full, delta, delta+async} in both
    packages: identical sink outputs, manifests equal to the JAX
    package's, and the materialized engine state of EVERY retained rung
    identical across modes and packages (a delta chain restores to
    exactly what a FULL snapshot holds)."""
    n, nk = 1200, 64
    rng = np.random.default_rng(7)
    keys = (rng.zipf(1.4, size=n) - 1) % nk
    vals = rng.integers(1, 100, size=n).astype(np.float64)
    # 5 commit-waited epochs; at full_every=3 the delta modes write
    # 1=F, 2=d(1), 3=d(1), 4=F, 5=d(4)
    ckpt_at = [200, 400, 600, 800, n]
    outs, stores, stats = {}, {}, {}
    for pkg, name, Store in _pkgs():
        for mode in ("full", "delta", "delta_async"):
            _set_mode(monkeypatch, mode)
            store = str(tmp_path / f"{name}_{mode}")
            rows = []
            g = _scan_graph(pkg, store, _ScanSource(keys, vals, store, Store,
                                                    ckpt_at), rows, mode)
            run_bounded(g)
            outs[name, mode] = sorted(rows)
            stores[name, mode] = store
            stats[name, mode] = g.get_stats().get("Checkpoints", {})
    ref = outs["j", "full"]
    assert ref and all(o == ref for o in outs.values())
    for name in ("j", "t"):
        # the delta modes wrote deltas and uploaded asynchronously
        assert stats[name, "delta"]["Checkpoint_delta_blobs"] >= 1
        assert stats[name, "delta_async"]["Checkpoint_async_uploads"] >= 1
        assert stats[name, "delta_async"]["Checkpoint_async_pending"] == 0
    rungs = StoreJ(stores["j", "full"]).completed_ids()
    assert len(rungs) == len(ckpt_at)
    for mode in ("full", "delta", "delta_async"):
        sj, st = StoreJ(stores["j", mode]), StoreT(stores["t", mode])
        assert sj.completed_ids() == st.completed_ids() == rungs
        for cid in rungs:
            mj, mt = _manifest(sj, cid), _manifest(st, cid)
            assert mj["blobs"] == mt["blobs"] and mj["deps"] == mt["deps"]
            assert mj["refs"] == mt["refs"]
            if mode != "full":
                assert bool(mt["deps"]) == (cid in (2, 3, 5)), (mode, cid)
            want = _states(StoreJ, stores["j", "full"], cid)
            for name, Store in (("j", StoreJ), ("t", StoreT)):
                got = _states(Store, stores[name, mode], cid)
                # engine state identical; the replica-generic fields carry
                # wall-clock watermarks that differ between runs
                _tree_equal(want[("scan", 0)]["scan"],
                            got[("scan", 0)]["scan"],
                            f"{name}.{mode}.epoch{cid}.scan")
                assert want[("src", 0)]["position"] \
                    == got[("src", 0)]["position"]


def test_zipf_differential_survives_kill(tmp_path, monkeypatch):
    """delta+async with a kill mid-stream after a DELTA epoch: the port
    restores the delta chain with ``run(restore_from=...)`` and its final
    epoch's materialized state equals the FULL-mode final state of both
    packages at the same stream position."""
    n, nk = 1000, 48
    rng = np.random.default_rng(23)
    keys = (rng.zipf(1.4, size=n) - 1) % nk
    vals = rng.integers(1, 100, size=n).astype(np.float64)
    ckpt_at = [250, 500, n]
    gold = {}
    _set_mode(monkeypatch, "full")
    for pkg, name, Store in _pkgs():
        store = str(tmp_path / f"gold_{name}")
        run_bounded(_scan_graph(pkg, store, _ScanSource(
            keys, vals, store, Store, ckpt_at), [], "full"))
        gold[name] = _states(Store, store, Store(store).completed_ids()[-1])
    _tree_equal(gold["j"][("scan", 0)]["scan"],
                gold["t"][("scan", 0)]["scan"], "gold.scan")

    store = str(tmp_path / "killed")
    crashed = _scan_graph(wt, store, _ScanSource(
        keys, vals, store, StoreT, ckpt_at, crash_at=700), [],
        "delta_async")
    with pytest.raises(_Boom):
        run_bounded(crashed)
    st = StoreT(store)
    assert st.completed_ids() == [1, 2]
    # the checkpoint restored is a delta (epoch 2 patches epoch 1)
    assert _manifest(st, 2)["deps"] == {blob_name("scan", 0): [1]}
    src = _ScanSource(keys, vals, store, StoreT, ckpt_at)
    g = _scan_graph(wt, store, src, [], "delta_async")
    run_bounded(g, restore_from=store)
    assert src.first == 500, "the restored source did not resume at the " \
        "checkpoint's position"
    assert g.get_stats()["Checkpoints"]["Checkpoint_async_pending"] == 0
    last = StoreT(store).completed_ids()[-1]
    got = _states(StoreT, store, last)
    _tree_equal(gold["t"][("scan", 0)]["scan"], got[("scan", 0)]["scan"],
                "final.scan")
    assert gold["t"][("src", 0)]["position"] == got[("src", 0)]["position"]


# the FFAT window's host dirty sets: a TB window whose slide (5 blocks) is
# longer than the checkpoint interval (2 blocks), so some captures see no
# firing, no rebuild and no growth, and snapshot a delta
_FF_NK, _FF_ROWS, _FF_STEP = 64, 64, 10
_FF_WIN, _FF_SLIDE = 6400, 3200
_FF_BLOCKS, _FF_CKPT = 24, tuple(range(2, 25, 2))
# the epochs' kinds in both packages at full_every=3: firings force FULL
_FF_KINDS = "FFddFFddFdFd"


def _ffat_blocks():
    """Columnar EVENT_TIME blocks: the first four register all the keys,
    each later one draws its keys from one random quarter of the key
    space, so an interval leaves some slots clean."""
    rng = np.random.default_rng(31)
    out, ts0 = [], 0
    for b in range(_FF_BLOCKS):
        if b < 4:
            k = np.arange(b * 16, b * 16 + 16).repeat(_FF_ROWS // 16)
        else:
            lo = int(rng.integers(0, 4)) * 16
            k = rng.integers(lo, lo + 16, _FF_ROWS)
        v = rng.integers(0, 100, _FF_ROWS)
        ts = ts0 + np.arange(_FF_ROWS, dtype=np.int64) * _FF_STEP
        ts0 = int(ts[-1]) + _FF_STEP
        out.append(({"k": k.astype(np.int32), "v": v.astype(np.int32)}, ts,
                    max(0, int(ts[0]) - 1)))
    return out


class _BlockSource(_ScanSource):
    """``_ScanSource`` over columnar blocks: its position counts blocks."""

    def __init__(self, blocks, store, Store, ckpt_at=(), crash_at=None):
        super().__init__(blocks, None, store, Store, ckpt_at, crash_at)

    def __call__(self, shipper):
        st = self.Store(self.store)
        while self.pos < len(self.keys):
            if self.pos == self.crash_at and self.crashes < 1:
                self.crashes += 1
                raise _Boom(f"killed before block {self.pos}")
            cols, ts, wm = self.keys[self.pos]
            if self.first is None:
                self.first = self.pos
            shipper.set_next_watermark(wm)
            shipper.push_columns(cols, ts)
            self.pos += 1
            if self.pos in self.ckpt_at:
                before = st.latest() or 0
                shipper.request_checkpoint()
                deadline = time.time() + COMMIT_WAIT_S
                while (st.latest() or 0) <= before \
                        and time.time() < deadline:
                    time.sleep(0.002)


def _ffat_graph(pkg, store, src, res, mode):
    """Block source -> keyed TB FFAT window -> sink of (key, wid) -> sum,
    checkpointing into ``store`` in ``mode``."""
    kw = {} if pkg is wj else {"device": "cpu"}
    g = pkg.PipeGraph("inc_ffat", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT_TIME, **kw)
    ck = {} if pkg is wj else _MODE_ARGS[mode]
    g.with_checkpointing(store_dir=store, retain=64, **ck)
    Ffat = Ffat_Windows_TPU_Builder if pkg is wj \
        else wt.Ffat_Windows_GPU_Builder
    ff = (Ffat(lambda f: {"s": f["v"]}, lambda a, b: {"s": a["s"] + b["s"]})
          .with_key_by("k").with_tb_windows(_FF_WIN, _FF_SLIDE)
          .with_name("ffat").build())

    def sink(t):
        if t is not None:
            res[(int(t["k"]), int(t["wid"]))] = int(t["s"])

    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(_FF_ROWS).build()) \
        .add(ff) \
        .add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    return g


def _ffat_run(pkg, Store, store, mode, res, monkeypatch, **src_kw):
    _set_mode(monkeypatch, mode)
    src = _BlockSource(_ffat_blocks(), store, Store, **src_kw)
    return src, _ffat_graph(pkg, store, src, res, mode)


def _forest_leaves(ff):
    """The FFAT state with its forest cut to the leaf columns (F..2F) while
    ``rebuild_dirty`` is set: the internal levels are then a stale cache
    that the next query rebuilds (K1), and before their first rebuild the
    two packages leave different stale values there (in FULL snapshots
    too)."""
    if not ff["rebuild_dirty"] or ff["trees"] is None:
        return ff
    F = ff["F"]
    return {**ff, "trees": {k: v[:, F:] for k, v in ff["trees"].items()},
            "tvalid": ff["tvalid"][:, F:]}


def test_ffat_delta_epochs_match_jax_and_full(tmp_path, monkeypatch):
    """The FFAT window snapshots deltas between firings: the port's epochs
    are FULL or delta exactly where the JAX package's are, with equal
    manifests; a delta blob ships only the dirty slot rows and carries the
    unchanged key directory at zero bytes; and every epoch's materialized
    window state equals the JAX package's and the FULL-mode run's at the
    same block, in sync and async uploads alike (the port's exactly; the
    JAX package's up to the stale internal levels, ``_forest_leaves``)."""
    outs, stores = {}, {}
    for pkg, name, Store, mode in ((wj, "j", StoreJ, "delta"),
                                   (wt, "t", StoreT, "full"),
                                   (wt, "t", StoreT, "delta"),
                                   (wt, "t", StoreT, "delta_async")):
        store = str(tmp_path / f"{name}_{mode}")
        res = {}
        _, g = _ffat_run(pkg, Store, store, mode, res, monkeypatch,
                         ckpt_at=_FF_CKPT)
        run_bounded(g)
        outs[name, mode], stores[name, mode] = res, store
    ref = outs["t", "full"]
    assert ref and all(o == ref for o in outs.values())
    sj = StoreJ(stores["j", "delta"])
    rungs = sj.completed_ids()
    assert len(rungs) == len(_FF_CKPT)
    kinds = "".join("d" if _manifest(sj, c)["deps"] else "F" for c in rungs)
    assert kinds == _FF_KINDS
    carried = 0
    for mode in ("delta", "delta_async"):
        st = StoreT(stores["t", mode])
        assert st.completed_ids() == rungs
        for cid, kind in zip(rungs, kinds):
            mt, mj = _manifest(st, cid), _manifest(sj, cid)
            assert mt["blobs"] == mj["blobs"] and mt["deps"] == mj["deps"]
            # the window's blob is never a ref; the sink's may differ: its
            # watermark comes with punctuations, which both packages send
            # on a wall-clock cadence (DEFAULT_WM_INTERVAL_USEC)
            ff = blob_name("ffat", 0)
            assert ff not in (mt["refs"] or {}) and ff not in (mj["refs"]
                                                                or {})
            d = st._dirname(cid)
            raw = StoreT.load_blob(d, blob_name("ffat", 0))["state"]["ffat"]
            assert delta_t.is_delta(raw) == (kind == "d"), (mode, cid)
            if kind == "d":
                n_dirty = len(raw["rows"]["trees"]["slots"])
                assert 0 < n_dirty < raw["replace"]["K_cap"], (mode, cid)
                carried += raw.get("carry") == ["slot_of_key",
                                                "out_keys_by_slot"]
            want = _states(StoreT, stores["t", "full"], cid)[("ffat", 0)]
            got_j = _states(StoreJ, stores["j", "delta"], cid)[("ffat", 0)]
            got_t = _states(StoreT, stores["t", mode], cid)[("ffat", 0)]
            _tree_equal(_forest_leaves(got_j["ffat"]),
                        _forest_leaves(got_t["ffat"]), f"{mode}.{cid}.jax")
            _tree_equal(want["ffat"], got_t["ffat"], f"{mode}.{cid}.full")
    assert carried >= 2


def test_ffat_restores_from_a_delta_epoch(tmp_path, monkeypatch):
    """delta+async with a kill one block after a DELTA epoch of the FFAT
    window (chain depth 1: a FULL base plus one delta): the restore
    resumes the source at the checkpoint's block, fires no window the
    checkpoint had fired, and the merged windows equal the golden run's,
    in both packages alike."""
    # the first delta epoch after a firing (epoch 7, patching epoch 6)
    cid = _FF_KINDS.index("d", _FF_KINDS.index("dF") + 2) + 1
    ckpt_block = _FF_CKPT[cid - 1]
    got = {}
    for pkg, name, Store in _pkgs():
        gold = {}
        _, g = _ffat_run(pkg, Store, str(tmp_path / f"{name}_gold"), "full",
                         gold, monkeypatch)
        run_bounded(g)
        store = str(tmp_path / f"{name}_killed")
        crash_res = {}
        _, g = _ffat_run(pkg, Store, store, "delta_async", crash_res,
                         monkeypatch, ckpt_at=_FF_CKPT,
                         crash_at=ckpt_block + 1)
        with pytest.raises(_Boom):
            run_bounded(g)
        st = Store(store)
        assert st.completed_ids() == list(range(1, cid + 1))
        assert _manifest(st, cid)["deps"] == {blob_name("ffat", 0):
                                              [cid - 1]}
        _, d, man = Store.resolve(store)
        ff = Store(store).load_states(d, man)[("ffat", 0)]["ffat"]
        fired = {int(k): int(ff["fired"][s])
                 for k, s in ff["slot_of_key"].items()}
        assert any(fired.values())
        restored = {}
        src, g = _ffat_run(pkg, Store, store, "delta_async", restored,
                           monkeypatch, ckpt_at=_FF_CKPT)
        run_bounded(g, restore_from=store)
        assert src.first == ckpt_block, "the restored source did not " \
            "resume at the checkpoint's block"
        assert restored and all(w >= fired[k] for k, w in restored), \
            "the restored run fired again a window the checkpoint had fired"
        merged = {**crash_res, **restored}
        assert merged == gold and gold
        got[name] = gold
    assert got["j"] == got["t"]


def _half_runs(tmp_path, monkeypatch, pkg, name, Store, tiered_a):
    """Golden FULL run and a delta run over the first half (both tiered
    as ``tiered_a``) whose latest epoch is a delta, then a TIERED graph
    restored from it streaming the rest. Returns (golden tail, restored
    rows, the half-run store)."""
    n, nk = 960, 24
    keys = np.arange(n) % nk
    vals = np.ones(n)
    half = n // 2
    tmp = tmp_path / name
    hot_b = 8 if tiered_a else 32
    _set_mode(monkeypatch, "full")
    gold_rows = []
    gold_store = str(tmp / "gold")
    run_bounded(_scan_graph(pkg, gold_store, _ScanSource(
        keys, vals, gold_store, Store), gold_rows, "full", tiered=tiered_a,
        db_dir=str(tmp / "db_gold")))
    _set_mode(monkeypatch, "delta")
    store = str(tmp / "store")
    run_bounded(_scan_graph(pkg, store, _ScanSource(
        keys[:half], vals[:half], store, Store, ckpt_at=[300, 420, half]),
        [], "delta", tiered=tiered_a, db_dir=str(tmp / "db_a")))
    st = Store(store)
    assert len(st.completed_ids()) == 3
    assert _manifest(st, st.completed_ids()[-1])["deps"], \
        "the latest epoch should be a delta"
    rows_b = []
    # the hot tier holds the dense checkpoint's distinct keys (adoption
    # refuses more)
    run_bounded(_scan_graph(pkg, store, _ScanSource(keys, vals, store, Store),
                            rows_b, "delta", tiered=True,
                            hot_capacity=hot_b, db_dir=str(tmp / "db_b")),
                restore_from=store)
    return sorted(gold_rows[half:]), sorted(rows_b), store


@pytest.mark.parametrize("tiered_a", [False, True],
                         ids=["dense_adopted_by_tiered",
                              "tiered_wal_roundtrip"])
def test_delta_latest_restores_into_tiered(tmp_path, monkeypatch,
                                           tiered_a):
    """``test_dense_delta_checkpoint_adopted_by_tiered`` (a dense
    delta-latest checkpoint materializes to a full dense blob and a tiered
    engine adopts it) and ``test_tiered_wal_delta_roundtrip`` (a tiered
    engine's deltas ship dirty hot rows plus the cold store's WAL, and the
    delta-latest restores into a fresh tiered graph): the continued stream
    matches the golden run, in both packages alike."""
    got = {}
    for pkg, name, Store in _pkgs():
        tail, rows_b, store = _half_runs(tmp_path, monkeypatch, pkg, name,
                                         Store, tiered_a)
        assert rows_b == tail and tail
        got[name] = (rows_b, [_manifest(Store(store), c)
                              for c in Store(store).completed_ids()])
    assert got["j"] == got["t"]


def test_port_restores_a_jax_written_delta_chain(tmp_path, monkeypatch):
    """A JAX graph writes FULL + delta epochs; the port's store reads the
    JAX manifests and materializes the chain (equal to the JAX store's
    materialized states), ``convert.checkpoint_states_from_jax`` brings
    them across, and a port graph restored from them continues to the
    golden rows."""
    n, nk = 960, 24
    keys = (np.arange(n) * 7) % nk
    vals = np.arange(n) % 5 + 1.0
    half = n // 2
    _set_mode(monkeypatch, "full")
    gold_rows = []
    gold_store = str(tmp_path / "gold")
    run_bounded(_scan_graph(wt, gold_store, _ScanSource(
        keys, vals, gold_store, StoreT), gold_rows, "full"))
    _set_mode(monkeypatch, "delta")
    jstore = str(tmp_path / "jax")
    run_bounded(_scan_graph(wj, jstore, _ScanSource(
        keys[:half], vals[:half], jstore, StoreJ, ckpt_at=[300, 420, half]),
        [], "delta"))
    cid, d, man = StoreJ.resolve(jstore)
    assert man.get("deps"), "the JAX latest epoch should be a delta"
    states_t = StoreT(jstore).load_states(d, StoreT.load_manifest(d))
    states_j = StoreJ(jstore).load_states(d, man)
    _tree_equal(states_j, states_t)
    rows = []
    src = _ScanSource(keys, vals, str(tmp_path / "port"), StoreT)
    g = _scan_graph(wt, str(tmp_path / "port"), src, rows, "full")
    run_bounded(g, restore_from=checkpoint_states_from_jax(states_t, "cpu"))
    assert src.first == half
    assert sorted(rows) == sorted(gold_rows[half:]) and rows


# ---------------------------------------------------------------------------
# the keyed engines' delta snapshot (formerly "not yet ported")
# ---------------------------------------------------------------------------
def _run_rows(op, n=400, nk=40, rows=16):
    """Feed ``n`` rows of ``nk`` keys, ``rows`` a batch, through one
    replica of ``op``."""
    from windflow_tpu_torch.gpu.batch import BatchGPU
    from windflow_tpu_torch.gpu.schema import TupleSchema
    op.build_replicas()
    rep = op.replicas[0]
    rep.set_emitter(_Sink())
    rng = np.random.default_rng(5)
    for lo in range(0, n, rows):
        k = rng.integers(0, nk, rows).astype(np.int64)
        cols = {"key": k.astype(np.int32),
                "value": rng.integers(0, 9, rows).astype(np.int32)}
        rep.handle_msg(0, BatchGPU({c: torch.from_numpy(v)
                                    for c, v in cols.items()},
                                   np.arange(rows, dtype=np.int64) + lo,
                                   rows,
                                   TupleSchema({c: v.dtype for c, v
                                                in cols.items()}),
                                   host_keys=k))
    rep.dispatch.drain()
    return rep


def _tiering(b, tmp_path):
    return b.with_tiering(policy="lru", hot_capacity=16,
                          db_dir=str(tmp_path))


@pytest.mark.parametrize("make", [
    lambda tmp: wt.Map_GPU_Builder(lambda r, s: (r, {"n": s["n"] + 1}))
    .with_state({"n": np.int32(0)}),
    lambda tmp: wt.Filter_GPU_Builder(
        lambda r, s: (r["value"] > s["n"], {"n": s["n"] + 1}))
    .with_state({"n": np.int32(0)}),
    lambda tmp: _tiering(wt.Map_GPU_Builder(
        lambda r, s: (r, {"n": s["n"] + 1})).with_state({"n": np.int32(0)}),
        tmp),
], ids=["map_state", "filter_state", "tiering"])
def test_keyed_engine_delta_snapshot(make, tmp_path):
    """Each keyed engine kind takes a FULL snapshot under its first delta
    capture (it has no base yet: that capture becomes its lineage base),
    then, once that epoch is committed, the next delta capture returns a
    delta node of the rows dirtied since, which materializes to the FULL
    snapshot taken at the same point."""
    op = make(tmp_path).with_key_by("key").build()
    eng = _run_rows(op, n=256).engine
    st = StoreT(str(tmp_path / "s"))
    with delta_t.capturing(1, st, delta=True):
        base = eng.snapshot_state()
    assert not delta_t.is_delta(base)
    assert not eng.dirty.any()  # the lineage restarts the bitmap
    st.begin(1)
    st.commit(1, {})
    rep = op.replicas[0]
    _feed_more(rep)
    with delta_t.capturing(2, st, delta=True):
        node = eng.snapshot_state()
    assert delta_t.is_delta(node) and node["base"] == 1
    assert 0 < len(node["rows"]["table"]["slots"]) < eng.table_capacity
    full = eng.snapshot_state()
    got = delta_t.materialize({"x": node}, {1: {"x": base}})["x"]
    _tree_equal(_no_tier(full), _no_tier(got))
    if eng.tier is not None:
        # the WAL replayed on the base's cold image gives the cold tier
        assert full["tier"]["cold_image"] != base["tier"]["cold_image"]
        assert _cold(got) == _cold(full)
        for k in ("policy", "hot_capacity", "free_slots", "order"):
            assert got["tier"][k] == full["tier"][k], k


def _no_tier(state):
    return {k: v for k, v in state.items() if k != "tier"}


def _cold(state):
    from windflow_tpu_torch.state.tiered import cold_items_from_image
    return sorted(cold_items_from_image(state["tier"]["cold_image"]))


def _feed_more(rep):
    from windflow_tpu_torch.gpu.batch import BatchGPU
    from windflow_tpu_torch.gpu.schema import TupleSchema
    k = np.array([1, 2, 3, 1] * 8, dtype=np.int64)
    cols = {"key": k.astype(np.int32),
            "value": np.arange(32, dtype=np.int32)}
    rep.handle_msg(0, BatchGPU({c: torch.from_numpy(v)
                                for c, v in cols.items()},
                               np.arange(32, dtype=np.int64) + 10_000, 32,
                               TupleSchema({c: v.dtype
                                            for c, v in cols.items()}),
                               host_keys=k))
    rep.dispatch.drain()


# ---------------------------------------------------------------------------
# the uploader's failure contract
# ---------------------------------------------------------------------------
class _FailingStore(StoreT):
    def __init__(self, root, exc):
        super().__init__(root)
        self.exc = exc

    def write_blob(self, ckpt_id, op_name, replica_idx, state):
        raise self.exc


@pytest.mark.parametrize("exc", [OSError("disk full"),
                                 RuntimeError("unpicklable state")],
                         ids=["storage", "other"])
def test_failed_upload_fails_its_epoch_and_the_run(tmp_path, exc):
    """An upload that raises fails its epoch (``wait_committed`` raises,
    the staging directory goes, nothing commits) and is kept in
    ``upload_error`` for the graph to raise
    (``test_failed_upload_fails_the_graph_run``)."""
    coord = CheckpointCoordinator(_FailingStore(str(tmp_path), exc), "g",
                                  async_upload=True)
    coord.expected_acks = 1
    cid = coord.trigger(force=True)
    assert coord.ack(cid, "w", {("op", 0): {"x": 1}}) == 0
    with pytest.raises(wt.WindFlowError, match="aborted"):
        coord.wait_committed(cid, timeout_s=COMMIT_WAIT_S)
    t = threading.Thread(target=coord.stop, daemon=True)
    t.start()
    join_bounded(t, what="coordinator stop")
    st = coord.stats()
    assert st["Checkpoint_failed_epochs"] == 1
    assert st["Checkpoint_async_uploads"] == 1
    assert st["Checkpoint_async_pending"] == 0
    assert coord.store.completed_ids() == []
    assert not os.path.isdir(coord.store._dirname(cid, staging=True))
    assert coord.upload_error is exc


@pytest.mark.parametrize("exc", [OSError("disk full"),
                                 RuntimeError("unpicklable state")],
                         ids=["storage", "other"])
def test_failed_upload_fails_the_graph_run(tmp_path, monkeypatch, exc):
    """A graph checkpointing with ``async_upload`` whose blob write fails:
    the stream runs to its end (the worker had acked long before), then
    ``run`` raises the upload's error and no epoch committed."""
    def failing(self, ckpt_id, op_name, replica_idx, state):
        raise exc

    class _Requests(_ScanSource):
        def __call__(self, shipper):
            for i in range(len(self.keys)):
                shipper.push({"k": int(self.keys[i]),
                              "v": float(self.vals[i])})
                if i + 1 in self.ckpt_at:
                    shipper.request_checkpoint()

    monkeypatch.setattr(StoreT, "write_blob", failing)
    store = str(tmp_path / "s")
    rows = []
    g = _scan_graph(wt, store, _Requests(np.arange(200) % 5, np.ones(200),
                                         store, StoreT, ckpt_at=[100]),
                    rows, "delta_async")
    with pytest.raises(type(exc), match=str(exc)):
        run_bounded(g)
    assert len(rows) == 200
    assert StoreT(store).completed_ids() == []
    assert g.get_stats()["Checkpoints"]["Checkpoint_failed_epochs"] == 1


def test_async_epoch_commits_when_the_upload_lands(tmp_path):
    """The ack returns before any byte is written; the epoch commits once
    the last upload lands, and the blob restores."""
    gate = threading.Event()

    class _SlowStore(StoreT):
        def write_blob(self, *a):
            gate.wait(COMMIT_WAIT_S)
            return super().write_blob(*a)

    coord = CheckpointCoordinator(_SlowStore(str(tmp_path)), "g",
                                  async_upload=True)
    coord.expected_acks = 1
    cid = coord.trigger(force=True)
    coord.ack(cid, "w", {("op", 0): {"x": np.arange(4)}})
    assert coord.stats()["Checkpoint_async_pending"] == 1
    assert coord.store.latest() is None
    gate.set()
    coord.wait_committed(cid, timeout_s=COMMIT_WAIT_S)
    coord.stop()
    assert coord.store.latest() == cid
    assert coord.history[-1]["upload_s"] > 0
    got = _states(StoreT, str(tmp_path), cid)
    np.testing.assert_array_equal(got[("op", 0)]["x"], np.arange(4))


class _EarlySource(_ScanSource):
    """Requests (and waits for) epoch 1 before its first tuple: the
    keyed engine has no table yet when that epoch captures it."""

    def __call__(self, shipper):
        st = self.Store(self.store)
        shipper.request_checkpoint()
        deadline = time.time() + COMMIT_WAIT_S
        while (st.latest() or 0) < 1 and time.time() < deadline:
            time.sleep(0.002)
        super().__call__(shipper)


def test_delta_base_without_a_table_is_not_used(tmp_path, monkeypatch):
    """An epoch captured before any tuple reached the keyed engine holds
    no table. The JAX engine still makes it the delta base, so its next
    deltas patch a missing table and the chain cannot be materialized
    (``ops_tpu.py:_KeyedStateScan.snapshot_state``: a reference fault).
    The port snapshots FULL again instead: its chain restores, to the
    FULL-mode state at the same position."""
    keys = np.arange(200) % 7
    vals = np.arange(200) % 3 + 1.0
    _set_mode(monkeypatch, "delta")
    deps = {}
    for pkg, name, Store in _pkgs():
        store = str(tmp_path / name)
        run_bounded(_scan_graph(pkg, store, _EarlySource(
            keys, vals, store, Store, ckpt_at=[100, 200]), [], "delta"))
        st = Store(store)
        assert st.completed_ids() == [1, 2, 3]
        deps[name] = [_manifest(st, c)["deps"] for c in (1, 2, 3)]
    scan = blob_name("scan", 0)
    assert deps["j"] == [None, {scan: [1]}, {scan: [1]}]
    assert deps["t"] == [None, None, {scan: [2]}]
    with pytest.raises(wj.CorruptCheckpointError, match="materialization"):
        _states(StoreJ, str(tmp_path / "j"), 3)
    _set_mode(monkeypatch, "full")
    gold = str(tmp_path / "gold")
    run_bounded(_scan_graph(wt, gold, _ScanSource(
        keys, vals, gold, StoreT, ckpt_at=[100, 200]), [], "full"))
    _tree_equal(_states(StoreT, gold, 2)[("scan", 0)]["scan"],
                _states(StoreT, str(tmp_path / "t"), 3)[("scan", 0)]["scan"])
