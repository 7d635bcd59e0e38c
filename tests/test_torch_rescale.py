"""Live rescale in the port (``windflow_tpu_torch/scaling/``), held against
the JAX package (``windflow_tpu/scaling/``, ``tests/test_rescale.py``).

- ``split_operator_states`` on blobs that both packages' graphs wrote for
  the same stream (a grid-scan table, plain and tiered, an FFAT forest, a
  fused chain's sub-states), N -> M for (1 -> 3, 2 -> 1, 2 -> 5): the
  port's split of the JAX-written blobs equals the JAX split exactly, and
  the port's split of its own blobs equals it row for row; the same-F
  and unknown-key refusals carry the JAX messages;
- the repartitioned table through ``restore_state`` at capacities 64 and
  2^20: the table comes back with its scratch row;
- routing: every key of every repartitioned replica (int, str and
  composite keys) is routed to that replica by the device plane's keyed
  routing, on both the column path and the row path;
- live rescales in both packages: the stateful ``Map_GPU`` (2 -> 3), the
  FFAT window (1 -> 2 -> 1, no duplicate window) and the tiered map
  (2 -> 3), each equal to the un-rescaled run and to the JAX package's;
  a host ``Reduce`` 2 -> 4 -> 1 equal to the stream's fold;
- a rescale under delta checkpoints: the rescale's own epoch may be a
  delta, and every new replica's first capture is FULL (no delta across
  parallelisms);
- every refusal of ``tests/test_rescale.py`` with the JAX reasons, the
  graph going on after a refusal or a quiesce timeout, the scale-down
  retire order, and the autoscaler policy's hysteresis, cooldown and idle
  scale-down plus one end-to-end scale-up.

Tolerance: exact (integer sums, and float32 running sums of integers
below 2^24). Every wait is bounded (``torch_waits``).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import join_bounded, run_bounded, wait_end_bounded
from windflow_tpu.checkpoint import CheckpointStore as StoreJ
from windflow_tpu.scaling import repartition as rep_j
from windflow_tpu.tpu.builders_tpu import (Ffat_Windows_TPU_Builder,
                                           Filter_TPU_Builder,
                                           Map_TPU_Builder)
from windflow_tpu_torch.checkpoint import CheckpointStore as StoreT
from windflow_tpu_torch.checkpoint.store import blob_name
from windflow_tpu_torch.gpu.routing import (_dest_of_key,
                                            _stack_key_fields, key_dests)
from windflow_tpu_torch.scaling import repartition as rep_t
from windflow_tpu_torch.state.tiered import cold_items_from_image

WAIT_S = 20.0


def _pg(pkg, name, time_policy=None, **kw):
    extra = {} if pkg is wj else {"device": "cpu", **kw}
    return pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                         time_policy or pkg.TimePolicy.INGRESS_TIME,
                         **extra)


def _wait_for(cond, what):
    deadline = time.monotonic() + WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# the operators, built by either package
# ---------------------------------------------------------------------------
_KEY_BY = {"int": "k", "str": lambda t: f"user-{t['k']:04d}",
           "composite": ("k", "b")}


def _smap(pkg, name="smap", par=1, key="int"):
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    return (Map(lambda row, state: (
        {**row, "v": row["v"] + state["acc"]},
        {"acc": state["acc"] + row["v"]}))
        .with_key_by(_KEY_BY[key]).with_state({"acc": np.int64(0)})
        .with_name(name).with_parallelism(par).build())


def _tiered(pkg, db_dir, name="tscan", par=1, hot=8):
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    return (Map(lambda row, st: ({"k": row["k"], "v": st + row["v"]},
                                 st + row["v"]))
            .with_state(np.float32(0)).with_key_by("k")
            .with_tiering(policy="lru", hot_capacity=hot, db_dir=db_dir)
            .with_name(name).with_parallelism(par).build())


def _ffat(pkg, par=1, win=(9, 4), key="k"):
    Ffat = Ffat_Windows_TPU_Builder if pkg is wj \
        else wt.Ffat_Windows_GPU_Builder
    return (Ffat(lambda f: {"s": f["v"]},
                 lambda a, b: {"s": a["s"] + b["s"]})
            .with_key_by(key).with_cb_windows(*win).with_name("ffat")
            .with_parallelism(par).build())


def _fused_ops(pkg, par):
    Filter = Filter_TPU_Builder if pkg is wj else wt.Filter_GPU_Builder
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    return (_smap(pkg, "fsmap", par),
            Filter(lambda f: f["v"] % 3 != 0).with_name("fodd")
            .with_parallelism(par).build(),
            Map(lambda f: {**f, "v": f["v"] * 2}).with_name("mtail")
            .with_parallelism(par).build())


# ---------------------------------------------------------------------------
# split_operator_states on both packages' blobs
# ---------------------------------------------------------------------------
N_SPLIT, NK_SPLIT = 700, 37
KINDS = ("scan", "tiered", "ffat", "fused")


class _FinalCkptSource:
    """``n`` tuples over ``nk`` keys, then one checkpoint: its barrier
    follows the last push, so the blobs hold the whole stream's state."""

    def __init__(self, n, nk):
        self.n, self.nk, self.pos = n, nk, 0

    def __call__(self, shipper):
        while self.pos < self.n:
            v = self.pos
            shipper.push({"k": (v * 7) % self.nk, "v": v % 11 + 1})
            self.pos += 1
        assert shipper.request_checkpoint() is not None

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _written_states(pkg, kind, par, root):
    """Run ``kind``'s graph at parallelism ``par`` and return the blobs
    of the operator under test from the store's latest checkpoint."""
    store = str(root / f"{kind}_{par}_{'j' if pkg is wj else 't'}")
    g = _pg(pkg, f"split_{kind}_{par}")
    g.with_checkpointing(store_dir=store)
    p = g.add_source(pkg.Source_Builder(_FinalCkptSource(N_SPLIT,
                                                         NK_SPLIT))
                     .with_name("src")
                     .with_output_batch_size(8 if kind == "tiered" else 64)
                     .build())
    if kind == "scan":
        op = _smap(pkg, par=par)
        p = p.add(op)
    elif kind == "tiered":
        op = _tiered(pkg, store + "_db", par=par)
        p = p.add(op)
    elif kind == "ffat":
        op = _ffat(pkg, par)
        p = p.add(op)
    else:
        ops = _fused_ops(pkg, par)
        op = ops[0]
        p = p.add(ops[0]).chain(ops[1]).chain(ops[2])
    p.add_sink(pkg.Sink_Builder(lambda t: None).with_name("snk").build())
    run_bounded(g)
    Store = StoreJ if pkg is wj else StoreT
    _, ckpt_dir, manifest = Store.resolve(store)
    states = Store(store).load_states(ckpt_dir, manifest)
    olds = []
    for i in range(par):
        st = dict(states[(op.name, i)])
        st.pop("__emitter__", None)
        st.pop("__collector__", None)
        olds.append(st)
    return op, olds


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    root = tmp_path_factory.mktemp("split")
    cache = {}

    def get(pkg, kind, par):
        key = (pkg.__name__, kind, par)
        if key not in cache:
            cache[key] = _written_states(pkg, kind, par, root)
        return cache[key]

    return get


def _tier_view(st):
    """A tiered replica's key -> value map over its hot table and cold
    tier."""
    scan = st["scan"]
    out = {k: tuple(float(np.asarray(leaf)[s]) for leaf in
                    (scan["table"] if isinstance(scan["table"], (list,
                                                                 tuple))
                     else [scan["table"]]))
           for k, s in scan["slot_of_key"].items()}
    out.update(_cold(scan["tier"]))
    return out


def _cold(tier):
    return {k: tuple(float(x) for x in row)
            for k, row in cold_items_from_image(tier["cold_image"])}


def _assert_equal(a, b, path="", forest_leaves_only=False, skip=()):
    """Exact structural equality of split states. Tier cold images
    compare by their decoded items (sqlite bytes may differ) and, with
    ``forest_leaves_only``, FFAT forests and their validity bits by their
    leaf half: the internal
    levels are a cache that the first batch after the move rebuilds
    (``rebuild_dirty``). Keys in ``skip`` are not compared."""
    if isinstance(a, dict):
        assert isinstance(b, dict), path
        if "cold_image" in a:
            assert _cold(a) == _cold(b), path
            a = {k: v for k, v in a.items() if k not in ("cold_image",)}
            b = {k: v for k, v in b.items() if k not in ("cold_image",)}
            a["digests"] = {k: v for k, v in a["digests"].items()
                            if k != "cold"}
            b["digests"] = {k: v for k, v in b["digests"].items()
                            if k != "cold"}
        assert set(a) == set(b), f"{path}: {set(a) ^ set(b)}"
        for k in a:
            if k in skip:
                continue
            sub = (forest_leaves_only and k == "trees")
            if sub and a[k] is not None:
                F = a["F"] if "F" in a else None
                for name in a[k]:
                    np.testing.assert_array_equal(
                        np.asarray(a[k][name])[:, F:],
                        np.asarray(b[k][name])[:, F:],
                        err_msg=f"{path}.trees.{name}")
                continue
            if forest_leaves_only and k == "tvalid" and a[k] is not None:
                F = a["F"] if "F" in a else None
                np.testing.assert_array_equal(
                    np.asarray(a[k])[:, F:], np.asarray(b[k])[:, F:],
                    err_msg=f"{path}.tvalid")
                continue
            _assert_equal(a[k], b[k], f"{path}.{k}", forest_leaves_only,
                          skip)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal(x, y, f"{path}[{i}]", forest_leaves_only, skip)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, f"{path}: {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, np.dtype) or isinstance(b, np.dtype):
        assert np.dtype(a) == np.dtype(b), path
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


@pytest.mark.parametrize("n_old,n_new", [(1, 3), (2, 1), (2, 5)])
@pytest.mark.parametrize("kind", KINDS)
def test_split_operator_states_matches_jax(written, kind, n_old, n_new):
    op_j, olds_j = written(wj, kind, n_old)
    op_t, olds_t = written(wt, kind, n_old)
    want = rep_j.split_operator_states(op_j, olds_j, n_new)
    # the port's split of the JAX-written blobs: the JAX split exactly
    _assert_equal(rep_t.split_operator_states(op_t, olds_j, n_new), want)
    # the port's split of its own blobs: row for row (the ingress-time
    # watermark is the wall clock's, so it differs between runs). Under
    # load the staging edge's age flush moves both runs' batch
    # boundaries, so ``fire_ewma`` (a firing-batch rate) and which forest
    # levels the last rebuild left valid differ between runs: the first is
    # not compared, and forests and their validity bits compare by their
    # leaf half. Which keys a tier keeps hot follows batch
    # boundaries too: a tiered split compares each new replica's key ->
    # value map over both tiers
    got = rep_t.split_operator_states(op_t, olds_t, n_new)
    if kind == "tiered":
        assert [_tier_view(st) for st in got] \
            == [_tier_view(st) for st in want]
    else:
        _assert_equal(got, want, forest_leaves_only=True,
                      skip=("cur_wm", "fire_ewma"))
        # and exactly the JAX split of the same blobs
        _assert_equal(got, rep_j.split_operator_states(op_j, olds_t, n_new))
    # every key of the stream is owned by exactly one new replica
    sub = {"scan": "scan", "tiered": "scan", "ffat": "ffat"}.get(kind)
    if sub is not None:
        owned = [k for st in got for k in st[sub]["slot_of_key"]]
        if kind == "tiered":
            owned += [k for st in got for k in dict(cold_items_from_image(
                st["scan"]["tier"]["cold_image"]))]
        assert sorted(owned) == sorted(set(owned)) == list(range(NK_SPLIT))


def test_split_refusals_match_jax(written):
    op_j, olds_j = written(wj, "ffat", 2)
    op_t, _ = written(wt, "ffat", 2)
    for bad in (
            # rings of different depth F cannot merge
            [olds_j[0], {**olds_j[1],
                         "ffat": {**olds_j[1]["ffat"],
                                  "F": 2 * olds_j[1]["ffat"]["F"]}}],
            # a state key this version does not know
            [olds_j[0], {**olds_j[1], "bogus": 1}]):
        with pytest.raises(wj.WindFlowError) as ej:
            rep_j.split_operator_states(op_j, bad, 1)
        with pytest.raises(wt.WindFlowError) as et:
            rep_t.split_operator_states(op_t, bad, 1)
        assert str(et.value) == str(ej.value)
    assert "ring depths" in str(et.value) or "bogus" in str(et.value)


# ---------------------------------------------------------------------------
# the scratch row survives the repartition (capacities 64 and 2^20)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_keys", [40, (1 << 19) + 5])
def test_repartitioned_table_restores_with_scratch_row(n_keys):
    rng = np.random.default_rng(3)
    keys = rng.permutation(4 * n_keys)[:n_keys].astype(np.int64)
    vals = rng.integers(-1000, 1000, n_keys).astype(np.int32)
    halves = (keys[keys % 2 == 0], keys[keys % 2 == 1])
    olds = []
    for part in halves:
        cap = 64
        while cap < len(part):
            cap *= 2
        table = np.zeros(cap, np.int32)
        table[:len(part)] = vals[np.searchsorted(np.sort(keys), part)
                                 .clip(max=n_keys - 1)]
        olds.append({"cur_wm": 0, "scan": {
            "slot_of_key": {int(k): i for i, k in enumerate(part)},
            "table_capacity": cap, "table": {"acc": table}}})
    op_t = _smap(wt)
    op_j = _smap(wj)
    (new,) = rep_t.split_operator_states(op_t, olds, 1)
    if n_keys < 1000:  # the JAX split walks every key in Python
        _assert_equal([new], rep_j.split_operator_states(op_j, olds, 1))
    cap = new["scan"]["table_capacity"]
    assert cap == (64 if n_keys < 64 else 1 << 20)
    op_t.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.INGRESS_TIME,
                   __import__("torch").device("cpu"))
    op_t.build_replicas()
    r = op_t.replicas[0]
    r.restore_state(new)
    table = r.engine.table["acc"]
    assert table.shape == (cap + 1,)  # the scratch row is back
    assert int(table[cap]) == 0       # at the initial state
    np.testing.assert_array_equal(table[:cap].numpy(),
                                  new["scan"]["table"]["acc"])
    for k, s in list(new["scan"]["slot_of_key"].items())[:1000]:
        src = next(o for o in olds if k in o["scan"]["slot_of_key"])
        assert table[s] == src["scan"]["table"]["acc"][
            src["scan"]["slot_of_key"][k]]


# ---------------------------------------------------------------------------
# the routing trap: keys land where the emitters send them
# ---------------------------------------------------------------------------
def _keys_of(kind, n):
    if kind == "int":
        return [int(k) for k in range(0, 3 * n, 3)]
    if kind == "str":
        return [f"user-{k:04d}" for k in range(n)]
    return [(k % 7, f"c{k}") for k in range(n)]


def _column_dests(kind, keys, n_dests):
    """Destinations on the column path of the staging and keyed device
    edges (``key_dests`` over the key column they build)."""
    if kind == "int":
        col = np.asarray(keys, dtype=np.int64)
    elif kind == "str":
        col = np.asarray(keys)
    else:
        col = _stack_key_fields({"a": np.asarray([k[0] for k in keys]),
                                 "b": np.asarray([k[1] for k in keys])},
                                ("a", "b"), len(keys))
    return key_dests(col, len(keys), n_dests)


@pytest.mark.parametrize("kind", ["int", "str", "composite"])
def test_repartitioned_keys_land_where_the_emitters_route(kind):
    keys = _keys_of(kind, 300)
    op_t = _smap(wt)
    olds = []
    for part in (keys[0::2], keys[1::2]):
        olds.append({"cur_wm": 0, "scan": {
            "slot_of_key": {k: i for i, k in enumerate(part)},
            "table_capacity": 256,
            "table": {"acc": np.arange(256, dtype=np.int32)}}})
    for n_new in (1, 3, 5):
        news = rep_t.split_operator_states(op_t, olds, n_new)
        for j, st in enumerate(news):
            owned = list(st["scan"]["slot_of_key"])
            if not owned:
                continue
            assert set(_column_dests(kind, owned, n_new).tolist()) == {j}
            assert {_dest_of_key(k, n_new) for k in owned} == {j}


class _GateSource:
    """Replayable keyed stream: ``n`` pushes of ``{"k", "v"}`` over
    ``keys``, gated at each position of ``gates`` until its event is set,
    so that a test can rescale at a known position."""

    def __init__(self, n, keys, gates=(), ts=False, composite=False):
        self.n, self.keys, self.ts, self.composite = n, keys, ts, composite
        self.gates = {at: threading.Event() for at in gates}
        self.pos = 0

    def __call__(self, shipper):
        while self.pos < self.n:
            ev = self.gates.get(self.pos)
            if ev is not None:
                ev.wait(WAIT_S)
            i = self.pos
            row = {"k": self.keys[i % len(self.keys)], "v": i % 13 + 1}
            if self.composite:
                row["b"] = row["k"] % 3
            if self.ts:
                shipper.push_with_timestamp(row, i * 50)
                shipper.set_next_watermark(i * 50)
            else:
                shipper.push(row)
            self.pos += 1

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _live(g, src, op_name, steps):
    """Start ``g``; for each ``(position, parallelism)`` wait for the
    source to park at the gate, release it just after the rescale barrier
    goes out, rescale; then wait for the end. Returns the reports."""
    reps = []
    g.start()
    try:
        for at, par in steps:
            _wait_for(lambda: src.pos >= at, f"source at {at}")
            threading.Timer(0.2, src.gates[at].set).start()
            reps.append(g.rescale(op_name, par, timeout_s=60))
    finally:
        for ev in src.gates.values():
            ev.set()
        wait_end_bounded(g)
    return reps


def _smap_run(pkg, tmp, steps, name, key="int", n_keys=6):
    rows, lock = [], threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                rows.append((int(t["k"]), int(t["v"])))

    src = _GateSource(1200, list(range(n_keys)), [at for at, _ in steps],
                      composite=key == "composite")
    g = _pg(pkg, name)
    g.with_checkpointing(store_dir=str(tmp / name))
    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(16).build()) \
        .add(_smap(pkg, par=2, key=key)) \
        .add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    if steps:
        reps = _live(g, src, "smap", steps)
    else:
        run_bounded(g)
        reps = []
    return sorted(rows), reps, g


@pytest.mark.parametrize("key", ["int", "str", "composite"])
def test_live_rescale_stateful_map_matches_unrescaled_and_jax(tmp_path,
                                                              key):
    base, _, _ = _smap_run(wt, tmp_path, [], f"base_{key}", key)
    got, reps, g = _smap_run(wt, tmp_path, [(600, 3)], f"rs_{key}", key)
    assert got == base
    (rep,) = reps
    assert rep.changed and rep["old_parallelism"] == 2 \
        and rep["new_parallelism"] == 3
    assert rep["pause_s"] > 0 and rep["total_s"] >= rep["pause_s"]
    for part in ("load_s", "repartition_s", "teardown_s", "rebuild_s",
                 "restore_s"):
        assert 0 <= rep[part] <= rep["pause_s"]
    # every key sits on the replica the emitters route it to
    op = next(o for o in g._ops if o.name == "smap")
    for j, r in enumerate(op.replicas):
        owned = list(r.engine.slot_of_key)
        assert owned and {_dest_of_key(k, 3) for k in owned} == {j}
    if key == "int":
        jax_rows, _, _ = _smap_run(wj, tmp_path, [(600, 3)], "rs_jax")
        assert got == jax_rows


# ---------------------------------------------------------------------------
# live rescales of the device operators, in both packages
# ---------------------------------------------------------------------------
def _ffat_run(pkg, tmp, steps, name):
    res, dups, lock = {}, [0], threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                key = (int(t["k"]), int(t["wid"]))
                dups[0] += key in res
                res[key] = int(t["s"])

    src = _GateSource(120 * 7, list(range(7)), [at for at, _ in steps],
                      ts=True)
    g = _pg(pkg, name, pkg.TimePolicy.EVENT_TIME)
    g.with_checkpointing(store_dir=str(tmp / name))
    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(16).build()) \
        .add(_ffat(pkg)) \
        .add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    if steps:
        reps = _live(g, src, "ffat", steps)
    else:
        run_bounded(g)
        reps = []
    return res, dups[0], reps, g


def test_live_rescale_ffat_forest_1_2_1(tmp_path):
    base, _, _, _ = _ffat_run(wt, tmp_path, [], "ffat_base")
    got, dups, reps, g = _ffat_run(wt, tmp_path, [(280, 2), (560, 1)],
                                   "ffat_rs")
    assert dups == 0
    assert got == base
    assert [(r["old_parallelism"], r["new_parallelism"]) for r in reps] \
        == [(1, 2), (2, 1)]
    jgot, jdups, _, _ = _ffat_run(wj, tmp_path, [(280, 2), (560, 1)],
                                  "ffat_rs_jax")
    assert jdups == 0 and jgot == got
    assert g.get_stats()["Rescales"]["Rescale_events"] == 2


def _tiered_run(pkg, tmp, name, steps):
    acc, counted, lock = {}, [0], threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                acc[int(t["k"])] = max(acc.get(int(t["k"]), 0.0),
                                       float(t["v"]))
                counted[0] += 1

    src = _GateSource(20 * 200, list(range(20)), [at for at, _ in steps])
    g = _pg(pkg, name)
    g.with_checkpointing(store_dir=str(tmp / name))
    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(8).build()) \
        .add(_tiered(pkg, str(tmp / f"{name}_db"), par=2, hot=16)) \
        .add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    if steps:
        _live(g, src, "tscan", steps)
    else:
        run_bounded(g)
    return acc, counted[0]


def test_live_rescale_tiered_map(tmp_path):
    """Both tiers repartition: hot tables by eviction rank, cold rows
    re-bucketed; every key's running sum survives the move. The oracle is
    the exact model ``want`` and the unrescaled runs of both packages:
    the JAX package's live rescale of the tiered map fails under a loaded
    host (ROADMAP Queue 3, faults of the reference), so its rescaled
    output is no oracle."""
    want = {}
    for i in range(20 * 200):
        want[i % 20] = want.get(i % 20, 0.0) + float(i % 13 + 1)
    runs = {"base": _tiered_run(wt, tmp_path, "tier_base", []),
            "got": _tiered_run(wt, tmp_path, "tier_rs", [(2000, 3)]),
            "jbase": _tiered_run(wj, tmp_path, "tier_base_jax", [])}
    for name, (acc, counted) in runs.items():
        wrong = {k: (acc.get(k), v) for k, v in want.items()
                 if acc.get(k) != v}
        assert (acc, counted) == (want, 4000), (
            f"run {name!r}: {counted} rows, keys (got, want) that differ "
            f"{wrong}")


class _PacedSource:
    def __init__(self, n, gate_at=None, n_keys=13):
        self.n, self.n_keys, self.gate_at = n, n_keys, gate_at
        self.gates = {} if gate_at is None else {gate_at: threading.Event()}
        self.pos = 0

    def __call__(self, shipper):
        while self.pos < self.n:
            ev = self.gates.get(self.pos)
            if ev is not None:
                ev.wait(WAIT_S)
            shipper.push({"key": self.pos % self.n_keys, "v": self.pos})
            self.pos += 1
            if self.pos % 400 == 0:
                time.sleep(0.001)

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _reduce_graph(pkg, tmp, name, src, par, results, lock,
                  func=lambda t, s: (0 if s is None else s) + t["v"], **kw):
    g = _pg(pkg, name, **kw) if pkg is wt else \
        pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **kw)
    g.with_checkpointing(store_dir=str(tmp / name))

    def sink(r):
        if r is not None:
            with lock:
                results.append(r)

    red = (pkg.Reduce_Builder(func).with_key_by(lambda t: t["key"])
           .with_name("red").with_parallelism(par).build())
    g.add_source(pkg.Source_Builder(src).with_name("src").build()) \
        .add(red).add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    return g


def test_repeated_rescale_up_then_down(tmp_path):
    results, lock = [], threading.Lock()
    src = _PacedSource(6000, 1500, 11)
    g = _reduce_graph(wt, tmp_path, "multi", src, 2, results, lock)
    g.start()
    try:
        _wait_for(lambda: src.pos >= 1500, "source at 1500")
        threading.Timer(0.2, src.gates[1500].set).start()
        r1 = g.rescale("red", 4, timeout_s=30)
        r2 = g.rescale("red", 1, timeout_s=30)
    finally:
        src.gates[1500].set()
        wait_end_bounded(g)
    assert r1.changed and r2.changed
    per_key, base = {}, []
    for pos in range(6000):
        per_key[pos % 11] = per_key.get(pos % 11, 0) + pos
        base.append(per_key[pos % 11])
    assert sorted(results) == sorted(base)
    st = g.get_stats()
    assert st["Rescales"]["Rescale_events"] == 2
    assert [o for o in st["Operators"] if o["name"] == "red"][0][
        "parallelism"] == 1


# ---------------------------------------------------------------------------
# deltas across a rescale
# ---------------------------------------------------------------------------
class _CkptSource(_GateSource):
    """Requests a checkpoint at each position of ``ckpt_at`` and waits
    (bounded) for it to commit: epoch <-> position is deterministic."""

    def __init__(self, n, keys, gates, ckpt_at, store):
        super().__init__(n, keys, gates)
        self.ckpt_at, self.store = set(ckpt_at), store

    def __call__(self, shipper):
        st = StoreT(self.store)
        while self.pos < self.n:
            ev = self.gates.get(self.pos)
            if ev is not None:
                ev.wait(WAIT_S)
            i = self.pos
            shipper.push({"k": self.keys[i % len(self.keys)],
                          "v": i % 13 + 1})
            self.pos += 1
            if self.pos in self.ckpt_at:
                before = st.latest() or 0
                shipper.request_checkpoint()
                deadline = time.monotonic() + WAIT_S
                while (st.latest() or 0) <= before \
                        and time.monotonic() < deadline:
                    time.sleep(0.002)


def test_delta_rescale_first_capture_is_full(tmp_path):
    """The rescale epoch may be a delta (``load_states`` materializes it
    before the split); every new replica starts a fresh lineage, so the
    first capture after the move is FULL, never a delta against a base
    of another parallelism."""
    store = str(tmp_path / "dstore")
    rows, lock = [], threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                rows.append((int(t["k"]), int(t["v"])))

    keys = list(range(40))
    src = _CkptSource(2400, keys, [1000], [400, 800, 1600, 2000], store)
    g = _pg(wt, "delta_rs")
    g.with_checkpointing(store_dir=store, delta=True, full_every=8,
                         retain=10)
    g.add_source(wt.Source_Builder(src).with_name("src")
                 .with_output_batch_size(16).build()) \
        .add(_smap(wt, par=2)) \
        .add_sink(wt.Sink_Builder(sink).with_name("snk").build())
    (rep,) = _live(g, src, "smap", [(1000, 3)])
    assert rep.changed
    cid = rep["ckpt_id"]
    st = StoreT(store)
    manifests = {c: st.load_manifest(st.checkpoint_dir(c))
                 for c in st.completed_ids()}
    # the rescale's own epoch is a delta (on epoch 1), materialized by
    # load_states before the split
    assert blob_name("smap", 0) in (manifests[cid].get("deps") or {}), \
        manifests[cid]
    # after it: the first epoch's smap blobs are FULL, depend on nothing
    # and refer to no blob of the old parallelism
    after = min(c for c in manifests if c > cid)
    m = manifests[after]
    for j in range(3):
        fname = blob_name("smap", j)
        assert fname in m["blobs"]
        assert fname not in (m.get("deps") or {}), m.get("deps")
        assert fname not in (m.get("refs") or {}), m.get("refs")
        blob = st.load_blob(st.checkpoint_dir(after), fname)
        assert "__state_delta__" not in blob["state"]["scan"]
    want, per_key = [], {}
    for i in range(2400):
        k, v = keys[i % 40], i % 13 + 1
        per_key[k] = per_key.get(k, 0) + v
        want.append((k, per_key[k]))
    assert sorted(rows) == sorted(want)


# ---------------------------------------------------------------------------
# refusals: loud, with the JAX reasons, and the graph survives
# ---------------------------------------------------------------------------
def test_repartition_refusal_reasons_match_jax():
    def pair(fn):
        return fn(wj), fn(wt)

    cases = [
        pair(lambda p: p.Source_Builder(lambda sh: None).with_name("s")
             .build()),
        pair(lambda p: p.Map_Builder(lambda t: t).with_broadcast()
             .with_name("bm").build()),
        (__import__("windflow_tpu.tpu.builders_tpu", fromlist=["x"])
         .Reduce_TPU_Builder(lambda a, b: a).with_name("gr").build(),
         wt.Reduce_GPU_Builder(lambda a, b: a).with_name("gr").build()),
        pair(lambda p: p.Reduce_Builder(lambda t, s: s)
             .with_key_by(lambda t: t).build()),
        (_ffat(wj), _ffat(wt)),
        (_smap(wj), _smap(wt)),
    ]
    reasons = [(rep_j.repartition_refusal(a), rep_t.repartition_refusal(b))
               for a, b in cases]
    for rj, rt in reasons:
        assert rj == rt
    assert "cursor" in reasons[0][1]
    assert "BROADCAST" in reasons[1][1]
    assert "global (unkeyed) reduce" in reasons[2][1]
    assert reasons[3][1] is None and reasons[4][1] is None \
        and reasons[5][1] is None


def _refusal_messages(pkg, tmp):
    results, lock = [], threading.Lock()
    src = _PacedSource(1200, None, 7)
    g = _reduce_graph(pkg, tmp, f"refuse_{pkg.__name__}", src, 1, results,
                      lock, func=lambda t, s: (0 if s is None else s) + 1)
    g.start()
    msgs = []
    try:
        for op, n in (("src", 2), ("nope", 2), ("red", 0)):
            with pytest.raises(pkg.WindFlowError) as ei:
                g.rescale(op, n)
            msgs.append(str(ei.value))
    finally:
        wait_end_bounded(g)
    assert len(results) == 1200  # the graph went on
    return msgs


def test_rescale_refusals_are_loud_and_graph_survives(tmp_path):
    got = _refusal_messages(wt, tmp_path)
    assert got == _refusal_messages(wj, tmp_path)
    assert "cursor" in got[0] and "no operator named" in got[1] \
        and ">= 1" in got[2]


def _no_cursor_message(pkg, tmp):
    release = threading.Event()

    def no_cursor(shipper):
        for i in range(100):
            shipper.push({"key": i % 3, "v": i})
        release.wait(WAIT_S)

    g = _reduce_graph(pkg, tmp, f"nr_{pkg.__name__}", no_cursor, 1, [],
                      threading.Lock(), func=lambda t, s: (s or 0) + 1)
    g.start()
    try:
        with pytest.raises(pkg.WindFlowError, match="not replayable") as ei:
            g.rescale("red", 2)
    finally:
        release.set()
        wait_end_bounded(g)
    return str(ei.value)


def test_rescale_refuses_non_replayable_source(tmp_path):
    assert _no_cursor_message(wt, tmp_path) \
        == _no_cursor_message(wj, tmp_path)


def test_rescale_requires_checkpointing():
    msgs = []
    for pkg in (wj, wt):
        g = _pg(pkg, f"nockpt_{pkg.__name__}")
        red = (pkg.Reduce_Builder(lambda t, s: (s or 0) + 1)
               .with_key_by(lambda t: t["key"]).with_name("red").build())
        g.add_source(pkg.Source_Builder(_PacedSource(50, None, 3))
                     .with_name("src").build()) \
            .add(red).add_sink(pkg.Sink_Builder(lambda t: None).build())
        g.start()
        try:
            with pytest.raises(pkg.WindFlowError, match="checkpoint") as ei:
                g.rescale("red", 2)
        finally:
            wait_end_bounded(g)
        msgs.append(str(ei.value))
    # the port reads no WF_* variable, so its message names no env knob
    assert msgs[1] == msgs[0].replace(" (or set WF_CKPT_INTERVAL)", "")


def test_rescale_timeout_aborts_and_graph_continues(tmp_path):
    """A rescale whose quiesce times out releases the parked workers with
    ``resume``: the stream completes on the OLD topology."""
    release = threading.Event()
    results, lock = [], threading.Lock()

    def half_wedged(shipper):
        for i in range(300):
            shipper.push({"key": i % 5, "v": i})
        release.wait(WAIT_S)  # no barrier can inject while parked here
        for i in range(300, 600):
            shipper.push({"key": i % 5, "v": i})

    half_wedged.snapshot_position = lambda: 0
    half_wedged.restore = lambda pos: None
    g = _reduce_graph(wt, tmp_path, "abort", half_wedged, 2, results, lock,
                      func=lambda t, s: (s or 0) + 1)
    g.start()
    try:
        time.sleep(0.2)
        with pytest.raises(wt.WindFlowError, match="timed out|quiesce"):
            g.rescale("red", 3, timeout_s=0.6)
    finally:
        release.set()
        wait_end_bounded(g)
    assert len(results) == 600
    st = g.get_stats()
    assert [o for o in st["Operators"] if o["name"] == "red"][0][
        "parallelism"] == 2
    assert st["Rescales"]["Rescale_failures"] == 1


def test_scale_down_retires_series_mark_final_then_drop(tmp_path):
    results, lock = [], threading.Lock()
    src = _PacedSource(3000, 1200, 9)
    g = _reduce_graph(wt, tmp_path, "retire", src, 3, results, lock)
    g.start()
    try:
        _wait_for(lambda: src.pos >= 1200, "source at 1200")
        threading.Timer(0.2, src.gates[1200].set).start()
        g.rescale("red", 1, timeout_s=30)
        st = g.get_stats()
        retired = [o for o in st["Operators"] if o.get("retired")]
        assert retired and retired[0]["name"] == "red"
        assert sorted(r["Replica_id"] for r in retired[0]["replicas"]) \
            == [1, 2]
        assert all(r["Final"] for r in retired[0]["replicas"])
        st2 = g.get_stats()
        assert not [o for o in st2["Operators"] if o.get("retired")]
    finally:
        src.gates[1200].set()
        wait_end_bounded(g)
    assert len(results) == 3000


# ---------------------------------------------------------------------------
# the coordinator's hold point and its commit
# ---------------------------------------------------------------------------
def test_hold_point_parks_until_released(tmp_path):
    """A held epoch parks each acking worker until the controller
    releases it; ``wait_all_parked`` needs every live acker parked (a
    retired worker counts as parked), and each worker gets the directive.
    An epoch that is not held does not park."""
    from windflow_tpu_torch.checkpoint import CheckpointCoordinator

    coord = CheckpointCoordinator(StoreT(str(tmp_path / "hold")))
    coord.expected_acks = 3
    cid = coord.trigger(force=True, hold=True)
    coord.retire("w_done", {})
    got = {}

    def worker(name):
        coord.ack(cid, name, {})
        got[name] = coord.park_if_held(cid, name)

    ts = [threading.Thread(target=worker, args=(n,)) for n in ("a", "b")]
    ts[0].start()
    assert not coord.wait_all_parked(cid, 0.05)  # b has not acked yet
    ts[1].start()
    assert coord.wait_all_parked(cid, WAIT_S)
    assert coord.parked == {"a", "b"}
    coord.release_hold("abandon")
    for t in ts:
        join_bounded(t)
    assert got == {"a": "abandon", "b": "abandon"}
    assert coord.park_if_held(cid, "a") is None  # released: not held


def test_wait_committed_spans_the_store_commit(tmp_path, monkeypatch):
    """The last ack's finalize takes the epoch off the pending set before
    the store commit (manifest, fsync, rename) lands; a waiter polling in
    between must wait for the commit, not report the epoch dropped."""
    from windflow_tpu_torch.checkpoint import CheckpointCoordinator

    store = StoreT(str(tmp_path / "slow"))
    in_commit, orig = threading.Event(), StoreT.commit

    def slow_commit(self, *a, **kw):
        in_commit.set()
        time.sleep(0.3)
        return orig(self, *a, **kw)

    monkeypatch.setattr(StoreT, "commit", slow_commit)
    coord = CheckpointCoordinator(store)
    coord.expected_acks = 1
    cid = coord.trigger(force=True)
    t = threading.Thread(target=coord.ack, args=(cid, "w", {}))
    t.start()
    assert in_commit.wait(WAIT_S)
    coord.wait_committed(cid, WAIT_S)  # raised "dropped" before the fix
    join_bounded(t)
    assert coord.last_completed_id == cid


# ---------------------------------------------------------------------------
# the autoscaler
# ---------------------------------------------------------------------------
def _policy_decisions(pkg):
    p = pkg.AutoscalePolicy(interval_s=0.1, cooldown_s=100.0,
                            max_parallelism=8, up_blocked_put_ms=50,
                            hysteresis=3, factor=2.0)
    congested = {"red": {"parallelism": 2, "blocked_put_ms_per_s": 300.0,
                         "blocked_get_ms_per_s": 0.0, "tuples_per_s": 1e4}}
    quiet = {"red": {"parallelism": 2, "blocked_put_ms_per_s": 0.0,
                     "blocked_get_ms_per_s": 0.0, "tuples_per_s": 1e4}}
    out = [p.observe(congested, now=1000.0 + i) for i in range(3)]
    p.note_action(1002.0)
    out.append(p.observe(congested, now=1003.0))  # cooldown
    p2 = pkg.AutoscalePolicy(cooldown_s=0.0, up_blocked_put_ms=50,
                             hysteresis=2, factor=2.0)
    out += [p2.observe(s, float(i)) for i, s in
            enumerate([congested, quiet, congested, congested])]
    p3 = pkg.AutoscalePolicy(cooldown_s=0.0, min_parallelism=1,
                             down_blocked_get_ms=100, hysteresis=2)
    idle = {"red": {"parallelism": 3, "blocked_put_ms_per_s": 0.0,
                    "blocked_get_ms_per_s": 900.0, "tuples_per_s": 10.0}}
    out += [p3.observe(idle, 1.0), p3.observe(idle, 2.0)]
    at_min = {"red": {"parallelism": 1, "blocked_put_ms_per_s": 0.0,
                      "blocked_get_ms_per_s": 900.0, "tuples_per_s": 1.0}}
    p4 = pkg.AutoscalePolicy(cooldown_s=0.0, min_parallelism=1,
                             down_blocked_get_ms=100, hysteresis=1)
    out.append(p4.observe(at_min, 1.0))
    return out


def test_autoscale_policy_hysteresis_cooldown_and_idle():
    got = _policy_decisions(wt)
    assert got == _policy_decisions(wj)
    assert got[:4] == [None, None, got[2], None]
    assert got[2][:2] == ("red", 4) and "backpressure" in got[2][2]
    assert got[4:8] == [None, None, None, got[7]] and got[7][1] == 4
    assert got[8] is None and got[9][:2] == ("red", 2) \
        and "idle" in got[9][2]
    assert got[10] is None


def test_autoscaler_end_to_end_scales_up_bottleneck(tmp_path):
    """A slow keyed host operator backpressures its input queue; the
    autoscaler scales it up mid-run and the results stay exact."""
    results, lock = [], threading.Lock()
    n, n_keys = 2600, 8

    def slow_count(t, s):
        time.sleep(0.0004)  # ~0.4 ms a tuple: the bottleneck
        return (0 if s is None else s) + 1

    src = _PacedSource(n, None, n_keys)
    g = _reduce_graph(wt, tmp_path, "auto", src, 1, results, lock,
                      func=slow_count, channel_capacity=64)
    g.with_autoscaler(wt.AutoscalePolicy(
        interval_s=0.15, cooldown_s=2.0, max_parallelism=4,
        up_blocked_put_ms=30, hysteresis=2, factor=2.0))
    run_bounded(g)
    st = g.get_stats()
    assert st["Rescales"]["Rescale_events"] >= 1
    auto = st["Autoscaler"]
    assert auto["Autoscaler_decisions"] >= 1
    assert auto["Autoscaler_history"][0]["op"] == "red"
    assert auto["Autoscaler_history"][0]["to"] > 1
    per_key, base = {}, []
    for pos in range(n):
        per_key[pos % n_keys] = per_key.get(pos % n_keys, 0) + 1
        base.append(per_key[pos % n_keys])
    assert sorted(results) == sorted(base)


# ---------------------------------------------------------------------------
# host window operators (the Keyed_Windows cases of test_rescale.py)
# ---------------------------------------------------------------------------
def _keyed_windows_run(tmp, name, steps, mode="DEFAULT", n_src=1, n=5000,
                       n_keys=13):
    """source(s) -> Keyed_Windows CB (7, 3) at parallelism 2 -> sink(2);
    ``steps`` rescale the window stage live. With several sources (one
    gated) the window stage sits behind a merging collector: a timestamp
    ordering collector in DETERMINISTIC mode. Returns the sorted
    ``(key, wid, value)`` rows and the reports."""
    results, lock = [], threading.Lock()

    def sink(r):
        if r is not None:
            with lock:
                results.append((r.key, r.wid, r.value))

    srcs = [_GateSource(n, list(range(i, n_keys, n_src)),
                        [at for at, _ in steps] if i == 0 else [], ts=True)
            for i in range(n_src)]
    g = wt.PipeGraph(name, getattr(wt.ExecutionMode, mode),
                     wt.TimePolicy.EVENT_TIME, device="cpu")
    g.with_checkpointing(store_dir=str(tmp / name))
    pipes = [g.add_source(wt.Source_Builder(s).with_name(f"src{i}").build())
             for i, s in enumerate(srcs)]
    mp = pipes[0].merge(*pipes[1:]) if n_src > 1 else pipes[0]
    kw = wt.Keyed_Windows(lambda rows: sum(r["v"] for r in rows),
                          key_extractor=lambda t: t["k"], win_len=7,
                          slide_len=3, win_type=wt.WinType.CB, name="kw",
                          parallelism=2)
    mp.add(kw).add_sink(wt.Sink_Builder(sink).with_name("snk")
                        .with_parallelism(2).build())
    reps = _live(g, srcs[0], "kw", steps) if steps else run_bounded(g)
    return sorted(results), reps or []


def _cb_window_model(n, n_keys, n_src):
    """Per-key CB (7, 3) windows over the sources' streams: the rows of
    ``_GateSource`` in arrival order per key, EOS flushing the open
    windows with their partial content."""
    seqs = {}
    for i in range(n_src):
        keys = list(range(i, n_keys, n_src))
        for pos in range(n):
            seqs.setdefault(keys[pos % len(keys)], []).append(pos % 13 + 1)
    out = []
    for k, vals in seqs.items():
        w = 0
        while w * 3 < len(vals):
            out.append((k, w, sum(vals[w * 3:w * 3 + 7])))
            w += 1
    return sorted(out)


@pytest.mark.parametrize("rescale_to", [3, 1, 5])
def test_live_rescale_keyed_windows_identical(tmp_path, rescale_to):
    """The engine's key map re-buckets by the KEYBY routing: the rescaled
    run equals the unrescaled one and the window model. The oracle is not
    the JAX package's rescaled run (``[3]`` is timing-flaky there,
    ROADMAP Queue 3)."""
    base, _ = _keyed_windows_run(tmp_path, "kw_base", [])
    got, reps = _keyed_windows_run(tmp_path, f"kw_rs{rescale_to}",
                                   [(2200, rescale_to)])
    assert got == base == _cb_window_model(5000, 13, 1)
    (rep,) = reps
    assert rep.changed and rep["old_parallelism"] == 2 \
        and rep["new_parallelism"] == rescale_to
    assert rep["pause_s"] > 0 and rep["total_s"] >= rep["pause_s"]


def test_live_rescale_keyed_windows_behind_an_ordering_collector(tmp_path):
    """DETERMINISTIC mode: the window stage's ordering collectors hold
    pre-barrier messages at the rescale; their buffers re-bucket by key
    and nothing is lost or doubled."""
    base, _ = _keyed_windows_run(tmp_path, "kwd_base", [], "DETERMINISTIC",
                                 n_src=2, n=2500)
    got, (rep,) = _keyed_windows_run(tmp_path, "kwd_rs", [(1100, 3)],
                                     "DETERMINISTIC", n_src=2, n=2500)
    assert got == base == _cb_window_model(2500, 13, 2)
    assert rep.changed and rep["new_parallelism"] == 3


def _host_blobs(root, name, make_op, par, two_streams=False):
    """Checkpoint blobs of one host operator at parallelism ``par`` from a
    port run (a checkpoint requested mid-stream)."""
    class Src(_GateSource):
        def __call__(self, shipper):
            while self.pos < self.n:
                if self.pos == self.n // 2 and self.req:
                    shipper.request_checkpoint()
                i = self.pos
                shipper.push_with_timestamp(
                    {"k": self.keys[i % len(self.keys)], "v": i}, i * 10)
                shipper.set_next_watermark(i * 10)
                self.pos += 1

    g = wt.PipeGraph(name, wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT_TIME, device="cpu")
    g.with_checkpointing(store_dir=str(root / name))
    a = Src(600, list(range(11)))
    a.req = True
    mp = g.add_source(wt.Source_Builder(a).with_name("sa").build())
    if two_streams:
        b = Src(600, list(range(11)))
        b.req = False
        mp = mp.merge(g.add_source(wt.Source_Builder(b).with_name("sb")
                                   .build()))
    mp.add(make_op(par)).add_sink(
        wt.Sink_Builder(lambda r: None).with_name("snk").build())
    run_bounded(g)
    st = StoreT(str(root / name))
    d = st.checkpoint_dir(st.latest())
    states = st.load_states(d, st.load_manifest(d))
    return [states[("op", i)] for i in range(par)]


@pytest.mark.parametrize("kind", ["keyed_windows", "ffat", "join_kp"])
def test_split_host_window_states_matches_jax(tmp_path, kind):
    """The window engine's key map, the host FFAT's per-key trees and the
    KP join's archives re-bucket per key, as the JAX package splits them:
    each new replica holds exactly the keys ``hash(key) % M`` routes to
    it, nothing lost."""
    def make(pkg, par):
        if kind == "keyed_windows":
            return (pkg.Keyed_Windows_Builder(
                lambda ws: sum(w["v"] for w in ws))
                .with_key_by(lambda t: t["k"]).with_tb_windows(400, 200)
                .with_name("op").with_parallelism(par).build())
        if kind == "ffat":
            return (pkg.Ffat_Windows_Builder(lambda t: t["v"],
                                             lambda a, b: a + b)
                    .with_key_by(lambda t: t["k"]).with_tb_windows(400, 200)
                    .with_name("op").with_parallelism(par).build())
        return (pkg.Interval_Join_Builder(lambda a, b: None)
                .with_key_by(lambda t: t["k"]).with_boundaries(500, 500)
                .with_name("op").with_parallelism(par).build())

    olds = _host_blobs(tmp_path, kind, lambda p: make(wt, p), 2,
                       two_streams=kind == "join_kp")
    for st in olds:
        st.pop("__emitter__", None)
        st.pop("__collector__", None)
    field = "engine" if kind == "keyed_windows" else "keys"

    def keys_of(st):
        return set(st[field]["key_map"] if field == "engine" else st[field])

    before = set().union(*(keys_of(st) for st in olds))
    assert before
    for new_n in (1, 3):
        got = rep_t.split_operator_states(make(wt, 2), [dict(s) for s in olds],
                                          new_n)
        ref = rep_j.split_operator_states(make(wj, 2), [dict(s) for s in olds],
                                          new_n)
        assert [keys_of(s) for s in got] == [keys_of(s) for s in ref]
        assert set().union(*(keys_of(s) for s in got)) == before
        for j, s in enumerate(got):
            assert {hash(k) % new_n for k in keys_of(s)} <= {j}


def test_host_window_repartition_refusals_match_jax():
    """BROADCAST windows, DP joins and Kafka sources stay refusals, with
    the JAX reasons; keyed windows and KP joins repartition."""
    from windflow_tpu.kafka import Kafka_Source_Builder as KJ
    from windflow_tpu_torch.kafka import Kafka_Source_Builder as KT

    def pair(fn):
        return fn(wj), fn(wt)
    cases = [
        pair(lambda p: p.Parallel_Windows_Builder(lambda ws: 0)
             .with_key_by(lambda t: t).with_tb_windows(10, 10).build()),
        pair(lambda p: p.Interval_Join_Builder(lambda a, b: None)
             .with_key_by(lambda t: t).with_boundaries(0, 0)
             .with_dp_mode().build()),
        (KJ(lambda m, s: False).with_brokers("memory://rr")
         .with_topics("t").build(),
         KT(lambda m, s: False).with_brokers("memory://rr")
         .with_topics("t").build()),
        pair(lambda p: p.Keyed_Windows_Builder(lambda ws: 0)
             .with_key_by(lambda t: t).with_cb_windows(4, 2).build()),
        pair(lambda p: p.Interval_Join_Builder(lambda a, b: None)
             .with_key_by(lambda t: t).with_boundaries(0, 0).build()),
        pair(lambda p: __import__(f"{p.__name__}.kafka", fromlist=["x"])
             .Kafka_Sink_Builder(lambda t: None).with_brokers("memory://rr")
             .build()),
    ]
    reasons = [(rep_j.repartition_refusal(a), rep_t.repartition_refusal(b))
               for a, b in cases]
    for rj, rt in reasons:
        assert rj == rt
    # a DP join is BROADCAST-routed: that reason comes first in both
    assert "BROADCAST" in reasons[0][1] and "BROADCAST" in reasons[1][1]
    assert "source replicas" in reasons[2][1]  # a source first, as in JAX
    assert reasons[3][1] is None and reasons[4][1] is None
    assert "Kafka connectors" in reasons[5][1]
