"""The port's persistent operators (``windflow_tpu_torch.persistent``)
against ``tests/test_persistent.py`` and the JAX package.

The store twins check ``DBHandle`` and the caches as the JAX tests do
(and that each package reads the other's database file). The operator
twins run the same graph through both packages on one seeded numpy
stream, with a cache of one or two entries so that nearly every access
spills to sqlite, and hold the port's rows to the JAX package's exactly
(integer state) and to a numpy fold. A checkpoint the JAX package wrote
of a ``P_Map`` / ``P_Keyed_Windows`` graph (its blob is the sqlite image)
restores into a port graph.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu.persistent as pj
import windflow_tpu_torch as wt
import windflow_tpu_torch.persistent as pt
from windflow_tpu_torch.persistent.cache import LRUCache

from torch_waits import run_bounded

N_KEYS, N_TUPLES, SEED = 8, 240, 11
PKG = {"jax": (wj, pj), "port": (wt, pt)}


def _stream(seed=SEED, n=N_TUPLES, n_keys=N_KEYS):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n_keys, n).astype(np.int64),
            rng.integers(-50, 100, n).astype(np.int64))


class _Rows:
    def __init__(self):
        self._lock = threading.Lock()
        self.rows = []

    def sink(self, t):
        if t is not None:
            with self._lock:
                self.rows.append(t)


def _graph(which, name, **kw):
    pkg, _ = PKG[which]
    extra = {"device": "cpu"} if which == "port" else {}
    return pkg.PipeGraph(name, kw.get("mode", pkg.ExecutionMode.DEFAULT),
                         kw.get("time", pkg.TimePolicy.INGRESS_TIME),
                         **extra)


def _row_source(which, keys, vals, par=1):
    """Each source replica pushes the rows of its keys (disjoint key sets:
    per-key order is the stream's at any parallelism)."""
    pkg, _ = PKG[which]

    def src(shipper, ctx):
        r, p = ctx.get_replica_index(), ctx.get_parallelism()
        for k, v in zip(keys.tolist(), vals.tolist()):
            if k % p == r:
                shipper.push({"key": k, "value": v})

    return pkg.Source_Builder(src).with_parallelism(par)


def _run_op(which, name, op, keys, vals, src_par=1):
    pkg, _ = PKG[which]
    rows = _Rows()
    g = _graph(which, name)
    g.add_source(_row_source(which, keys, vals, src_par).build()) \
        .add(op).add_sink(pkg.Sink_Builder(rows.sink).build())
    run_bounded(g)
    return rows.rows


def _per_key(rows, field="key"):
    out = {}
    for r in rows:
        out.setdefault(r[field], []).append(r)
    return out


# ---------------------------------------------------------------------------
# the store and the caches
# ---------------------------------------------------------------------------
def test_db_handle_roundtrip(tmp_path):
    db_dir = str(tmp_path)
    db = pt.DBHandle("t1", db_dir=db_dir)
    db.put(("k", 1), {"a": [1, 2, 3]})
    db.put("x", 42)
    assert db.get(("k", 1)) == {"a": [1, 2, 3]}
    assert db.get("missing", "d") == "d"
    assert db.contains("x") and not db.contains("y")
    assert len(db) == 2
    db.delete("x")
    assert len(db) == 1
    db.meta_put("epoch", 3)
    assert db.meta_get("epoch") == 3 and db.meta_get("none") is None
    db.close()
    db2 = pt.DBHandle("t1", db_dir=db_dir)  # durable across handles
    assert db2.get(("k", 1)) == {"a": [1, 2, 3]}
    db2.close()
    # one file format: the JAX package reads what the port wrote
    dbj = pj.DBHandle("t1", db_dir=db_dir)
    assert dict(dbj.items()) == {("k", 1): {"a": [1, 2, 3]}}
    assert dbj.meta_get("epoch") == 3
    dbj.close()
    exported = str(tmp_path / "copy.db")
    db3 = pt.DBHandle("t1", db_dir=db_dir)
    db3.export_to(exported)
    db3.close()
    copy = pt.DBHandle("copy", db_dir=db_dir)
    assert dict(copy.items()) == {("k", 1): {"a": [1, 2, 3]}}
    copy.close()


def test_lru_store_spill_and_reload(tmp_path):
    db = pt.DBHandle("t2", db_dir=str(tmp_path))
    store = pt.LRUStore(db, capacity=2)
    for i in range(10):
        store[i] = [i] * 3
    assert store[0] == [0, 0, 0]  # reloaded from the DB after eviction
    assert len(store) == 10
    assert sorted(store) == list(range(10))
    store.flush()
    assert sorted(db.keys()) == list(range(10))
    del store[3]
    assert 3 not in set(store) and len(store) == 9
    db.close()


def test_lfu_eviction_order_vs_lru():
    """On one access trace LRU evicts the least RECENT key (the hot one),
    LFU the least FREQUENT; the JAX package's caches agree."""
    got = {}
    for pkg_name, mod in (("port", pt), ("jax", pj)):
        for name in ("lru", "lfu"):
            evicted = []
            cls = mod.LRUCache if name == "lru" else mod.LFUCache
            c = cls(3, on_evict=lambda k, v: evicted.append(k))
            c.put("a", 1)
            assert c.get("a") == 1 and c.get("a") == 1 and c.get("a") == 1
            c.put("b", 2)
            c.put("c", 3)
            c.put("d", 4)
            got[(pkg_name, name)] = evicted
    assert got[("port", "lru")] == got[("jax", "lru")] == ["a"]
    assert got[("port", "lfu")] == got[("jax", "lfu")] == ["b"]


def test_lfu_tie_break_is_lru_within_frequency():
    evicted = []
    c = pt.LFUCache(2, on_evict=lambda k, v: evicted.append(k))
    c.put("x", 1)
    c.put("y", 2)  # both frequency 1; 'x' is the older insertion
    c.put("z", 3)
    assert evicted == ["x"]
    assert "y" in c and "z" in c


def test_lfu_frequency_survives_update_and_pop():
    c = pt.LFUCache(2)
    c.put("x", 1)
    c.get("x")
    c.put("x", 10)  # an update bumps the frequency, replaces the value
    assert c.get("x") == 10
    c.put("y", 2)
    evicted = []
    c.on_evict = lambda k, v: evicted.append((k, v))
    c.put("z", 3)  # 'y' (frequency 1) goes before the hot 'x'
    assert evicted == [("y", 2)]
    assert c.pop("x") == 10 and "x" not in c
    assert c.pop("missing", "dflt") == "dflt"
    assert len(c) == 1 and sorted(c.keys()) == ["z"]
    lru = LRUCache(2)
    lru.put(1, "a")
    assert 1 in lru and len(lru) == 1 and dict(lru.items()) == {1: "a"}


def test_lfu_store_spill_and_reload(tmp_path):
    db = pt.DBHandle("t_lfu", db_dir=str(tmp_path))
    store = pt.LRUStore(db, capacity=2, policy="lfu")
    store["hot"] = "H"
    for _ in range(5):
        assert store["hot"] == "H"
    for i in range(10):
        store[i] = [i]
    assert "hot" in store.cache  # never the LFU victim
    assert store["hot"] == "H"
    assert len(store) == 11
    store.flush()
    assert sorted(map(str, db.keys())) == sorted(
        map(str, list(range(10)) + ["hot"]))
    db.close()


def test_unknown_cache_policy_rejected_at_build_time():
    for pkg, mod in PKG.values():
        with pytest.raises(pkg.WindFlowError, match="unknown cache policy"):
            mod.P_Map_Builder(lambda t, s: (t, s)).with_cache_policy("mru")


# ---------------------------------------------------------------------------
# the operators, both packages on one seeded stream
# ---------------------------------------------------------------------------
def _number(t, state):
    state["n"] += 1
    state["sum"] += t["value"]
    return {"key": t["key"], "n": state["n"], "sum": state["sum"]}, state


def _pmap(which, db_dir, policy="lru", par=1, name="pmap"):
    _, mod = PKG[which]
    return (mod.P_Map_Builder(_number).with_key_by(lambda t: t["key"])
            .with_initial_state({"n": 0, "sum": 0}).with_db_path(db_dir)
            .with_cache_capacity(2).with_cache_policy(policy)
            .with_parallelism(par).with_name(name).build())


def _running_model(keys, vals):
    out, n, s = {}, {}, {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        n[k] = n.get(k, 0) + 1
        s[k] = s.get(k, 0) + v
        out.setdefault(k, []).append({"key": k, "n": n[k], "sum": s[k]})
    return out


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_p_map_lfu_policy_matches_lru(tmp_path, policy):
    """The cache policy decides residency only: both policies give the
    JAX package's rows and the numpy fold."""
    keys, vals = _stream()
    got = {w: _per_key(_run_op(w, f"pmap_{policy}",
                               _pmap(w, str(tmp_path / w), policy),
                               keys, vals))
           for w in PKG}
    assert got["port"] == got["jax"] == _running_model(keys, vals)


def test_p_map_running_state(tmp_path):
    """Per-key running state through a 2-entry cache at parallelism 2."""
    keys, vals = _stream(seed=SEED + 1)
    got = {w: _per_key(_run_op(w, "pmap2", _pmap(w, str(tmp_path / w),
                                                 par=2), keys, vals,
                               src_par=2))
           for w in PKG}
    assert got["port"] == got["jax"] == _running_model(keys, vals)


def test_p_reduce_matches_reduce(tmp_path):
    keys, vals = _stream(seed=SEED + 2)

    def add(t, state):
        return {"key": t["key"], "value": state["value"] + t["value"]}

    got = {}
    for w, (pkg, mod) in PKG.items():
        for variant in ("memory", "persistent"):
            b = (pkg.Reduce_Builder(add) if variant == "memory"
                 else mod.P_Reduce_Builder(add)
                 .with_db_path(str(tmp_path / w)).with_cache_capacity(2))
            op = (b.with_key_by(lambda t: t["key"])
                  .with_initial_state({"key": -1, "value": 0}).build())
            got[(w, variant)] = _per_key(
                _run_op(w, f"pr_{variant}", op, keys, vals))
    model = {k: [{"key": k, "value": r["sum"]} for r in rows]
             for k, rows in _running_model(keys, vals).items()}
    assert all(v == model for v in got.values())


def test_p_filter_and_flatmap_match_jax(tmp_path):
    """P_Filter keeps a key's tuple while its running count is odd;
    P_FlatMap emits the running sum once per tuple and again for
    negatives."""
    keys, vals = _stream(seed=SEED + 3)

    def keep(t, state):
        state["n"] += 1
        return state["n"] % 2 == 1, state

    def fan(t, shipper, state):
        state["s"] += t["value"]
        shipper.push({"key": t["key"], "s": state["s"]})
        if t["value"] < 0:
            shipper.push({"key": t["key"], "s": -state["s"]})
        return state

    got = {}
    for w, (_, mod) in PKG.items():
        f = (mod.P_Filter_Builder(keep).with_key_by(lambda t: t["key"])
             .with_initial_state({"n": 0}).with_cache_capacity(1)
             .with_db_path(str(tmp_path / w)).with_name("pf").build())
        m = (mod.P_FlatMap_Builder(fan).with_key_by(lambda t: t["key"])
             .with_initial_state({"s": 0}).with_cache_capacity(1)
             .with_db_path(str(tmp_path / w)).with_name("pfm").build())
        got[(w, "f")] = _per_key(_run_op(w, "pf", f, keys, vals))
        got[(w, "m")] = _per_key(_run_op(w, "pfm", m, keys, vals))
    assert got[("port", "f")] == got[("jax", "f")]
    assert got[("port", "m")] == got[("jax", "m")]
    n_kept = sum(len(v) for v in got[("port", "f")].values())
    assert n_kept == sum((np.sum(keys == k) + 1) // 2
                         for k in range(N_KEYS))
    n_fan = sum(len(v) for v in got[("port", "m")].values())
    assert n_fan == len(vals) + int(np.sum(vals < 0))


TS_STEP, WIN_US, SLIDE_US = 100, 1000, 400


def _event_source(which, keys, vals):
    """EVENT_TIME: the stream's i-th tuple at ts i*TS_STEP, the watermark
    following it."""
    pkg, _ = PKG[which]

    def src(shipper):
        for i, (k, v) in enumerate(zip(keys.tolist(), vals.tolist())):
            shipper.push_with_timestamp({"key": k, "value": v}, i * TS_STEP)
            shipper.set_next_watermark(i * TS_STEP)

    return pkg.Source_Builder(src)


def _windows(which, builder, keys, vals, name):
    pkg, _ = PKG[which]
    rows = _Rows()
    g = _graph(which, name, time=pkg.TimePolicy.EVENT_TIME)
    g.add_source(_event_source(which, keys, vals).build()) \
        .add(builder.with_key_by(lambda t: t["key"]).with_parallelism(2)
             .with_name(name).build()) \
        .add_sink(pkg.Sink_Builder(rows.sink).build())
    run_bounded(g)
    return sorted((r.key, r.wid, r.value) for r in rows.rows)


@pytest.mark.parametrize("kind", ["tb", "cb"])
def test_p_keyed_windows_matches_keyed_windows(tmp_path, kind):
    """The in-memory and the persistent keyed windows (a 2-entry cache)
    give the same windows, in both packages."""
    keys, vals = _stream(seed=SEED + 4)

    def agg(ws):
        return sum(w["value"] for w in ws)

    got = {}
    for w, (pkg, mod) in PKG.items():
        for variant in ("memory", "persistent"):
            b = (pkg.Keyed_Windows_Builder(agg) if variant == "memory"
                 else mod.P_Keyed_Windows_Builder(agg)
                 .with_db_path(str(tmp_path / w)).with_cache_capacity(2))
            b = (b.with_tb_windows(WIN_US, SLIDE_US) if kind == "tb"
                 else b.with_cb_windows(13, 5))
            got[(w, variant)] = _windows(w, b, keys, vals, f"pkw_{variant}")
    ref = got[("jax", "memory")]
    assert ref and all(v == ref for v in got.values())


def test_p_sink_final_state(tmp_path):
    keys, vals = _stream(seed=SEED + 5)

    def collect(t, state):
        if t is not None:
            state["sum"] += t["value"]
            state["n"] += 1
        return state

    final = {}
    for w, (pkg, mod) in PKG.items():
        db_dir = str(tmp_path / w)
        g = _graph(w, "psink")
        g.add_source(_row_source(w, keys, vals).build()) \
            .add(mod.P_Sink_Builder(collect).with_key_by(lambda t: t["key"])
                 .with_initial_state({"sum": 0, "n": 0}).with_db_path(db_dir)
                 .with_cache_capacity(1).build())
        run_bounded(g)
        db = mod.DBHandle("p_sink_r0", db_dir=db_dir)
        final[w] = dict(db.items())
        db.close()
    model = {k: {"sum": int(vals[keys == k].sum()),
                 "n": int((keys == k).sum())} for k in np.unique(keys)}
    assert final["port"] == final["jax"] == model


# ---------------------------------------------------------------------------
# JAX-written checkpoints of persistent graphs restore into the port
# ---------------------------------------------------------------------------
class _Crash(Exception):
    pass


class _ReplayEvents:
    """Replayable EVENT_TIME source over the seeded stream; requests a
    checkpoint at ``ckpt_at`` and crashes at ``crash_at``."""

    def __init__(self, keys, vals, ckpt_at=None, crash_at=None):
        self.keys, self.vals = keys.tolist(), vals.tolist()
        self.ckpt_at, self.crash_at = ckpt_at, crash_at
        self.pos = 0

    def __call__(self, shipper):
        while self.pos < len(self.keys):
            if self.pos == self.crash_at:
                raise _Crash("killed")
            i = self.pos
            shipper.push_with_timestamp(
                {"key": self.keys[i], "value": self.vals[i]}, i * TS_STEP)
            shipper.set_next_watermark(i * TS_STEP)
            self.pos += 1
            if self.pos == self.ckpt_at:
                shipper.request_checkpoint()

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _ckpt_graph(which, kind, src, store, db_dir, rows):
    pkg, mod = PKG[which]
    g = _graph(which, f"pckpt_{kind}", time=pkg.TimePolicy.EVENT_TIME)
    g.with_checkpointing(store_dir=store)
    if kind == "pmap":
        op = (mod.P_Map_Builder(_number).with_key_by(lambda t: t["key"])
              .with_initial_state({"n": 0, "sum": 0}).with_db_path(db_dir)
              .with_cache_capacity(2).with_name("pm").build())
    else:
        op = (mod.P_Keyed_Windows_Builder(
            lambda ws: sum(w["value"] for w in ws))
            .with_key_by(lambda t: t["key"]).with_tb_windows(WIN_US, SLIDE_US)
            .with_db_path(db_dir).with_cache_capacity(2).with_name("pkw")
            .build())
    g.add_source(pkg.Source_Builder(src).with_name("src").build()) \
        .add(op).add_sink(pkg.Sink_Builder(rows.sink).with_name("snk")
                          .build())
    return g


@pytest.mark.parametrize("kind", ["pmap", "pkw"])
def test_jax_checkpoint_of_persistent_graph_restores(tmp_path, kind):
    """The JAX graph checkpoints at tuple 120 and dies at 180; the port
    restores that checkpoint (the blob's sqlite image, with the window
    descriptors pickled as JAX classes, converted) and finishes the
    stream: the restored run's rows are exactly the uninterrupted JAX
    run's rows from the checkpoint on."""
    from windflow_tpu.checkpoint import CheckpointStore as StoreJ

    from windflow_tpu_torch.convert import checkpoint_states_from_jax
    keys, vals = _stream(seed=SEED + 6)
    gold = _Rows()
    run_bounded(_ckpt_graph("jax", kind, _ReplayEvents(keys, vals),
                            str(tmp_path / "gs"), str(tmp_path / "gdb"),
                            gold))
    jstore = str(tmp_path / "js")
    crash = _Rows()
    g = _ckpt_graph("jax", kind, _ReplayEvents(keys, vals, 120, 180),
                    jstore, str(tmp_path / "jdb"), crash)
    with pytest.raises(_Crash):
        run_bounded(g)
    sj = StoreJ(jstore)
    d = sj.checkpoint_dir(sj.latest())
    jstates = sj.load_states(d, sj.load_manifest(d))
    states = checkpoint_states_from_jax(jstates, "cpu")
    op = "pm" if kind == "pmap" else "pkw"
    # the window descriptors in the image name the JAX package's classes
    # until the conversion re-pickles them as the port's
    assert (b"windflow_tpu.operators" in jstates[(op, 0)]["db"]) \
        == (kind == "pkw")
    assert b"windflow_tpu.operators" not in states[(op, 0)]["db"]
    rest = _Rows()
    g2 = _ckpt_graph("port", kind, _ReplayEvents(keys, vals),
                     str(tmp_path / "ps"), str(tmp_path / "pdb"), rest)
    run_bounded(g2, restore_from=states)
    if kind == "pmap":
        # the restored run's rows: every tuple from 120 on, running on
        # the state the JAX replica held at the checkpoint
        model = _running_model(keys, vals)
        tail = {}
        for k, rows in model.items():
            n_before = int(np.sum(keys[:120] == k))
            if rows[n_before:]:
                tail[k] = rows[n_before:]
        assert _per_key(rest.rows) == tail
    else:
        restored = {(r.key, r.wid): r.value for r in rest.rows}
        golden = {(r.key, r.wid): r.value for r in gold.rows}
        assert restored and all(golden[kw] == v
                                for kw, v in restored.items())
        fired = {(r.key, r.wid) for r in crash.rows}
        # together the two runs fire every golden window
        assert set(golden) <= fired | set(restored)
    assert os.path.exists(str(tmp_path / "pdb"))
