"""The hot/cold tier plane in the port (``windflow_tpu_torch/state/``,
``with_tiering`` on the stateful device builders) held against the JAX
package's (``windflow_tpu.state``).

The invariant everywhere: a tiered pipeline gives the rows of the dense
one — tier movement is data placement, never semantics — and the moves
are batched (one gather and one scatter per batch). Tolerance: EXACT; the
scan's float32 running sums add in each key's arrival order on both
sides. The checkpoint coordinator is not ported yet, so the migration
scenarios go through the replicas' ``snapshot_state`` /
``restore_state`` directly."""

import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.state import tiered as tiered_j
from windflow_tpu.tpu import Map_TPU_Builder
from windflow_tpu.tpu.batch import BatchTPU
from windflow_tpu.tpu.ops_tpu import Map_TPU
from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
from windflow_tpu_torch.convert import scan_state_from_jax
from windflow_tpu_torch.gpu.batch import BatchGPU
from windflow_tpu_torch.gpu.keymap import KeySlotMap
from windflow_tpu_torch.gpu.ops_gpu import Map_GPU
from windflow_tpu_torch.gpu.schema import TupleSchema
from windflow_tpu_torch.state import TierConfig, TieredKeyStore
from windflow_tpu_torch.state import tiered as tiered_t


class ReplaySource:
    """Integers 0..n-1 keyed ``v % nk`` (or drawn from ``seed``), pushed
    as ``{"k", "v"}`` rows (``test_tiered_state.py``'s source, without
    its checkpoint and crash hooks)."""

    def __init__(self, n, nk, seed=None):
        self.n, self.nk = n, nk
        self.keys = list(range(nk)) if seed is None else \
            [random.Random(seed + i).randrange(nk) for i in range(n)]
        self.seeded = seed is not None

    def __call__(self, shipper):
        for v in range(self.n):
            k = self.keys[v] if self.seeded else v % self.nk
            shipper.push({"k": k, "v": float(v + 1)})


def _scan_fn(row, st):
    # column-preserving: the running sum replaces "v"
    return {"k": row["k"], "v": st + row["v"]}, st + row["v"]


def _run_graph(pkg, src, tiering=None, batch=8):
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    b = (Map(_scan_fn).with_state(np.float32(0)).with_key_by("k")
         .with_name("scan"))
    if tiering is not None:
        b = b.with_tiering(**tiering)
    rows, lock = [], threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                rows.append((int(t["k"]), float(t["v"])))

    kw = {} if pkg is wj else {"device": "cpu"}
    g = pkg.PipeGraph("tier", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **kw)
    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(batch).build()) \
        .add(b.build()) \
        .add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    run_bounded(g)
    return sorted(rows), g


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_tiered_vs_dense_matches_jax(policy, tmp_path):
    """``test_tiered_state.py:101``: a random key stream through the
    running-sum scan, dense and with a hot tier of 8 of 24 keys, in both
    packages: four equal row multisets, float32 sums exact."""
    n, nk = 1_500, 24
    dense_t, _ = _run_graph(wt, ReplaySource(n, nk, seed=11))
    tiered_t_rows, g = _run_graph(wt, ReplaySource(n, nk, seed=11),
                                  _tier(tmp_path, "t", 8, policy))
    dense_j, _ = _run_graph(wj, ReplaySource(n, nk, seed=11))
    tiered_j_rows, _ = _run_graph(wj, ReplaySource(n, nk, seed=11),
                                  _tier(tmp_path, "j", 8, policy))
    assert len(dense_t) == n
    assert tiered_t_rows == dense_t == dense_j == tiered_j_rows
    rep = g.get_stats()["Operators"][1]["replicas"][0]
    assert rep["Tier_promotes"] > 0 and rep["Tier_demotes"] > 0
    assert rep["Tier_hot_keys"] <= 8
    assert rep["Tier_hot_keys"] + rep["Tier_cold_keys"] == nk
    assert 0 < rep["Tier_miss_rate"] < 1


def test_promote_demote_are_batched(monkeypatch, tmp_path):
    """``test_tiered_state.py:122``: batches alternate between two disjoint
    8-key working sets, so each promotes 8 keys and demotes 8, in ONE
    promote and ONE demote batch per stream batch."""
    created = []
    orig = tiered_t.TieredKeyStore.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        created.append(self)

    monkeypatch.setattr(tiered_t.TieredKeyStore, "__init__", spy)
    n_rounds = 20

    def src(shipper):
        for r in range(n_rounds):
            base = 0 if r % 2 == 0 else 8
            for i in range(8):
                shipper.push({"k": base + i, "v": 1.0})

    rows, _ = _run_graph(wt, src, dict(policy="lru", hot_capacity=8,
                                       db_dir=str(tmp_path)))
    assert len(rows) == n_rounds * 8
    assert len(created) == 1
    store = created[0]
    assert store.promoted_keys == 8 + (n_rounds - 1) * 8
    assert store.demoted_keys == (n_rounds - 1) * 8
    assert store.promote_batches <= n_rounds
    assert store.demote_batches <= n_rounds - 1
    assert store.promoted_keys >= 8 * store.promote_batches
    assert store.demoted_keys >= 8 * store.demote_batches


# ---------------------------------------------------------------------------
# replica level: identical batches into both packages' engines
# ---------------------------------------------------------------------------
class _Collect:
    def __init__(self, to_host):
        self.to_host = to_host
        self.rows = []

    def set_stats(self, stats):
        pass

    def emit_device_batch(self, b):
        cols = self.to_host(b)
        for i in range(b.size):
            self.rows.append((int(cols["k"][i]), float(cols["v"][i])))

    def propagate_punctuation(self, wm):
        pass

    def flush(self):
        pass


def _replica(pkg, tiering=None):
    if pkg == "jax":
        cfg = None if tiering is None else tiered_j.TierConfig(**tiering)
        op = Map_TPU(_scan_fn, name="scan", key_extractor="k",
                     state_init=np.float32(0), tiering=cfg)
        to_host = lambda b: {k: np.asarray(v) for k, v in b.fields.items()}
    else:
        cfg = None if tiering is None else TierConfig(**tiering)
        op = Map_GPU(_scan_fn, name="scan", key_extractor="k",
                     state_init=np.float32(0), tiering=cfg)
        to_host = lambda b: b.host_columns()
    op.build_replicas()
    rep = op.replicas[0]
    rep.set_emitter(_Collect(to_host))
    return rep


def _zipf_batches(n_batches, batch, key_space, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        keys = (rng.zipf(1.1, batch) - 1) % key_space
        v = (b * batch + np.arange(batch)).astype(np.float32)
        out.append((keys.astype(np.int64), v))
    return out


def _feed(rep, batches):
    jax_side = isinstance(rep.op, Map_TPU)
    for i, (keys, v) in enumerate(batches):
        n = len(keys)
        cols = {"k": keys.astype(np.int32), "v": v}
        dts = {"k": np.int32, "v": np.float32}
        ts = np.arange(n, dtype=np.int64) + i * n
        if jax_side:
            import jax
            b = BatchTPU({c: jax.device_put(a) for c, a in cols.items()},
                         ts, n, SchemaJ(dts), 0, host_keys=keys)
        else:
            b = BatchGPU({c: torch.from_numpy(a.copy())
                          for c, a in cols.items()}, ts, n,
                         TupleSchema(dts), 0, host_keys=keys)
        rep.handle_msg(0, b)
    rep.dispatch.drain()


def _tier(tmp_path, name, hot=64, policy="lru"):
    return dict(policy=policy, hot_capacity=hot,
                db_dir=str(tmp_path / name))


def test_tier_stats_and_tables_match_jax(tmp_path):
    """A Zipf stream over 5,000 keys with a 64-slot hot tier: the same
    rows, the same ``Tier_*`` counts and gauges, the same hot table, slot
    map and cold rows in both packages."""
    batches = _zipf_batches(30, 32, 5_000)
    jrep = _replica("jax", _tier(tmp_path, "j"))
    trep = _replica("torch", _tier(tmp_path, "t"))
    _feed(jrep, batches)
    _feed(trep, batches)
    assert trep.emitter.rows == jrep.emitter.rows
    sj, st = jrep.stats.to_dict(), trep.stats.to_dict()
    tier_keys = [k for k in sj if k.startswith("Tier_")]
    assert len(tier_keys) == 6
    for k in tier_keys:
        if k != "Tier_promote_usec_total":
            assert st[k] == sj[k], k
    assert st["Tier_demotes"] > 0
    snj = jrep.engine.snapshot_state()
    snt = trep.engine.snapshot_state()
    assert snj["slot_of_key"] == snt["slot_of_key"]
    assert np.array_equal(np.asarray(snj["table"]), snt["table"])
    assert (sorted(jrep.engine.tier.cold.items())
            == sorted(trep.engine.tier.cold.items()))
    tj, tt = snj["tier"], snt["tier"]
    assert tj["digests"]["hot"] == tt["digests"]["hot"]
    for k in ("policy", "hot_capacity", "free_slots", "order"):
        assert tj[k] == tt[k], k


def test_tier_blob_from_jax_verifies_and_continues(tmp_path):
    """A JAX tiered engine's snapshot (hot table, cold sqlite image, both
    digests) through ``convert.scan_state_from_jax``: the port verifies
    both digests, restores both tiers and continues to the JAX rows."""
    batches = _zipf_batches(24, 32, 3_000, seed=8)
    jrep = _replica("jax", _tier(tmp_path, "j"))
    _feed(jrep, batches[:12])
    snap = jrep.snapshot_state()
    assert snap["scan"]["tier"]["digests"]["hot"]
    jrep.emitter.rows.clear()
    trep = _replica("torch", _tier(tmp_path, "t"))
    trep.restore_state({"cur_wm": snap["cur_wm"],
                        "scan": scan_state_from_jax(snap["scan"], "cpu")})
    assert len(trep.engine.tier.cold) == len(jrep.engine.tier.cold) > 0
    _feed(jrep, batches[12:])
    _feed(trep, batches[12:])
    assert trep.emitter.rows == jrep.emitter.rows and trep.emitter.rows


def test_tier_blob_digest_mismatch_refused(tmp_path):
    jrep = _replica("jax", _tier(tmp_path, "j"))
    _feed(jrep, _zipf_batches(8, 32, 3_000))
    scan = scan_state_from_jax(jrep.snapshot_state()["scan"], "cpu")
    scan["table"] = scan["table"] + 1  # a torn hot tier
    with pytest.raises(wt.WindFlowError, match="hot-tier table digest"):
        _replica("torch", _tier(tmp_path, "t")).engine.restore_state(scan)
    scan = scan_state_from_jax(jrep.snapshot_state()["scan"], "cpu")
    scan["tier"] = dict(scan["tier"], cold_image=scan["tier"]["cold_image"]
                        + b"x")
    with pytest.raises(wt.WindFlowError, match="cold-tier image digest"):
        _replica("torch", _tier(tmp_path, "t2")).engine.restore_state(scan)


def test_tiered_blob_refused_by_dense_engine(tmp_path):
    """``test_tiered_state.py:205``: a snapshot taken with tiering cannot
    restore into a dense engine (its cold rows would vanish)."""
    trep = _replica("torch", _tier(tmp_path, "t", hot=8))
    _feed(trep, _zipf_batches(6, 8, 50))
    snap = trep.snapshot_state()
    dense = _replica("torch")
    with pytest.raises(wt.WindFlowError, match="TIERED key store"):
        dense.restore_state(snap)


def test_dense_blob_adopted_by_tiered_engine(tmp_path):
    """``test_tiered_state.py:223``: a dense snapshot restores into a
    tiered engine (every key adopted hot) and continues like the dense
    engine; too many keys for the hot tier is a ``KeyCapacityError``."""
    batches = _zipf_batches(12, 16, 6, seed=3)
    gold = _replica("torch")
    _feed(gold, batches)
    dense = _replica("torch")
    _feed(dense, batches[:6])
    snap = dense.snapshot_state()
    tiered = _replica("torch", _tier(tmp_path, "t", hot=16))
    tiered.restore_state(snap)
    assert tiered.engine.table_capacity == 16
    _feed(tiered, batches[6:])
    assert dense.emitter.rows + tiered.emitter.rows == gold.emitter.rows
    # the same adoption in the JAX package gives the same rows
    jd = _replica("jax")
    _feed(jd, batches[:6])
    jt = _replica("jax", _tier(tmp_path, "j", hot=16))
    jt.restore_state(jd.snapshot_state())
    _feed(jt, batches[6:])
    assert jt.emitter.rows == tiered.emitter.rows
    small = _replica("torch", _tier(tmp_path, "s", hot=4))
    with pytest.raises(wt.KeyCapacityError):
        small.restore_state(snap)


# ---------------------------------------------------------------------------
# capacity refusals and the store's own planning
# ---------------------------------------------------------------------------
def test_key_capacity_error_fields():
    """``test_tiered_state.py:377``, with the JAX error's message."""
    e = wt.KeyCapacityError("scan", 64, 3, hint="raise with_key_capacity")
    ej = wj.KeyCapacityError("scan", 64, 3, hint="raise with_key_capacity")
    assert isinstance(e, wt.WindFlowError)
    assert e.op_name == "scan" and e.k_pad == 64 and e.refused == 3
    assert str(e) == str(ej)


def test_batch_wider_than_hot_tier_refused(tmp_path):
    """``test_tiered_state.py:385``."""
    store = TieredKeyStore("wide", TierConfig(
        policy="lru", hot_capacity=4, db_dir=str(tmp_path / "wide")))
    with pytest.raises(wt.KeyCapacityError) as ei:
        store.plan_batch(KeySlotMap(), list(range(7)))
    assert ei.value.k_pad == 4 and ei.value.refused == 3
    store.cold.close()


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_plans_equal_jax(policy, tmp_path):
    """The planner alone: over a Zipf stream of distinct-key batches (and
    a shrunk target), every plan names the same promotions, demotions and
    slots as the JAX store's, and the tracker orders agree."""
    from windflow_tpu.tpu.keymap import KeySlotMap as KeySlotMapJ
    sj = tiered_j.TieredKeyStore("p", tiered_j.TierConfig(
        policy=policy, hot_capacity=32, db_dir=str(tmp_path / "j")))
    st = TieredKeyStore("p", TierConfig(
        policy=policy, hot_capacity=32, db_dir=str(tmp_path / "t")))
    kj, kt = KeySlotMapJ(), KeySlotMap()
    rng = np.random.default_rng(2)
    for i in range(60):
        if i == 30:
            sj.target_hot_capacity = st.target_hot_capacity = 4
            sj.min_hot = st.min_hot = 2
        batch = list(dict.fromkeys(
            int(k) for k in (rng.zipf(1.2, 12) - 1) % 400))
        pj, pt = sj.plan_batch(kj, batch), st.plan_batch(kt, batch)
        assert (pj is None) == (pt is None)
        if pj is not None:
            assert pj.promote_keys == pt.promote_keys
            assert pj.demote_keys == pt.demote_keys
            assert np.array_equal(pj.promote_slots, pt.promote_slots)
            assert np.array_equal(pj.demote_slots, pt.demote_slots)
        assert kj.slot_of_key == kt.slot_of_key
    assert list(sj.tracker.eviction_order()) == \
        list(st.tracker.eviction_order())
    assert (sj.lookups, sj.misses) == (st.lookups, st.misses)


# ---------------------------------------------------------------------------
# the hot-tier digest and the blob helpers equal the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("table", ["dict", "bare", "bool"])
def test_hot_table_digest_equals_jax(table):
    rng = np.random.default_rng(7)
    if table == "dict":
        t = {"n": rng.integers(0, 9, 16).astype(np.int32),
             "acc": rng.standard_normal(16).astype(np.float32)}
    elif table == "bare":
        t = rng.standard_normal(16).astype(np.float32)
    else:
        t = {"seen": rng.random(16) < 0.5}
    ref = tiered_j.hot_table_digest(
        {k: jnp.asarray(v) for k, v in t.items()} if isinstance(t, dict)
        else jnp.asarray(t))
    assert tiered_t.hot_table_digest(t) == ref
    as_torch = ({k: torch.from_numpy(v) for k, v in t.items()}
                if isinstance(t, dict) else torch.from_numpy(t))
    assert tiered_t.hot_table_digest(as_torch) == ref
    assert tiered_t.hot_table_digest(None) is None


def test_cold_image_and_tier_blob_helpers_interoperate():
    items = [(3, (np.float32(1.5),)), (9, (np.float32(-2.0),))]
    img_t = tiered_t.cold_image_from_items(items)
    img_j = tiered_j.cold_image_from_items(items)
    assert sorted(tiered_j.cold_items_from_image(img_t)) == sorted(items)
    assert sorted(tiered_t.cold_items_from_image(img_j)) == sorted(items)
    bt = tiered_t.build_tier_blob("lru", 8, [7, 6], [3, 9], items, "h")
    bj = tiered_j.build_tier_blob("lru", 8, [7, 6], [3, 9], items, "h")
    assert {k: v for k, v in bt.items() if k not in ("cold_image",
                                                     "digests")} == \
        {k: v for k, v in bj.items() if k not in ("cold_image", "digests")}
    assert bt["digests"]["hot"] == bj["digests"]["hot"] == "h"


def test_tier_config_defaults_and_refusals():
    """The JAX package's ``WF_TIER_*`` defaults as arguments."""
    c = TierConfig()
    assert (c.policy, c.hot_capacity, c.db_dir, c.min_hot) == \
        ("lru", 1024, None, 64)
    assert TierConfig(policy="LFU").policy == "lfu"
    with pytest.raises(wt.WindFlowError, match="eviction policy"):
        TierConfig(policy="fifo")
    with pytest.raises(wt.WindFlowError, match="hot_capacity"):
        TierConfig(hot_capacity=0)
