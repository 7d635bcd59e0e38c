"""Device-chain fusion in the port (``windflow_tpu_torch/gpu/fused_ops.py``,
the legality rules of ``topology/stage.py``), held against the port's own
unfused run (``PipeGraph(fusion=False)``) and against the JAX package's
fused run (``WF_TPU_FUSION=1``) on the same stream, the JAX side on its
CPU backend. Stateless sub-ops only: keyed device state is not ported.

Tolerances: int32 exact. A global reduce folds the same pairs in both
packages, so its rows match the JAX package's fused rows exactly; against
the unfused run only its value and count are compared, since a combine
that keeps ``b["key"]`` is not commutative and the fold's pairing follows
where the kept rows sit. A float keyed fold is compared with ``rtol=1e-5``
(the port's Hillis-Steele scan groups the combine differently from
``associative_scan``)."""

import random
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wj
import windflow_tpu_torch as wt
from windflow_tpu.tpu import (Ffat_Windows_TPU_Builder, Filter_TPU_Builder,
                              Map_TPU_Builder, Reduce_TPU_Builder)
from windflow_tpu_torch.gpu.scan import (masked_segmented_scan,
                                         segmented_scan)
from windflow_tpu_torch.runtime import dispatch as port_dispatch

from common import (TupleT, make_event_time_source, make_ingress_source,
                    rand_degree)

N_KEYS = 5
STREAM_LEN = 60


def _b(pkg):
    """The package's device-operator builders."""
    if pkg is wj:
        return Map_TPU_Builder, Filter_TPU_Builder, Reduce_TPU_Builder
    return wt.Map_GPU_Builder, wt.Filter_GPU_Builder, wt.Reduce_GPU_Builder


def _graph(pkg, monkeypatch, fusion, name="fusion", event_time=False):
    """A graph with fusion on or off: the port's ``PipeGraph(fusion=...)``,
    the JAX package's ``WF_TPU_FUSION`` (read when ``chain`` runs)."""
    policy = (pkg.TimePolicy.EVENT_TIME if event_time
              else pkg.TimePolicy.INGRESS_TIME)
    if pkg is wj:
        monkeypatch.setenv("WF_TPU_FUSION", "1" if fusion else "0")
        return wj.PipeGraph(name, wj.ExecutionMode.DEFAULT, policy)
    return wt.PipeGraph(name, wt.ExecutionMode.DEFAULT, policy,
                        device="cpu", fusion=fusion)


class RowCollector:
    """Thread-safe (key, value) sink, arrival order kept."""

    def __init__(self):
        self.rows = []
        self._lock = threading.Lock()

    def sink(self, t):
        if t is not None:
            with self._lock:
                self.rows.append((int(t.key), int(t.value)))

    @property
    def multiset(self):
        with self._lock:
            return sorted(self.rows)


def _three_op_chain(pkg, monkeypatch, fusion, p, batch, col,
                    drop_all_pred=False, event_time=False):
    """src -> [map -> filter -> map] -> sink, the device trio built with
    chain() so it fuses when fusion is on."""
    Map, Filter, _ = _b(pkg)
    g = _graph(pkg, monkeypatch, fusion, event_time=event_time)
    src_fn = (make_event_time_source(N_KEYS, STREAM_LEN, seed=3)
              if event_time else make_ingress_source(N_KEYS, STREAM_LEN))
    src = (pkg.Source_Builder(src_fn).with_parallelism(2)
           .with_output_batch_size(batch).build())
    m1 = (Map(lambda f: {**f, "value": f["value"] * 3})
          .with_name("m1").with_parallelism(p).build())
    pred = ((lambda f: f["value"] < 0) if drop_all_pred
            else (lambda f: f["value"] % 2 == 0))
    flt = Filter(pred).with_name("f1").with_parallelism(p).build()
    m2 = (Map(lambda f: {**f, "value": f["value"] + 7})
          .with_name("m2").with_parallelism(p).build())
    g.add_source(src).add(m1).chain(flt).chain(m2) \
        .add_sink(pkg.Sink_Builder(col.sink).build())
    return g


def _fused_stage(g, kind="Fused_GPU_Chain"):
    ops = [o for o in g.get_stats()["Operators"] if o["kind"] == kind]
    assert len(ops) == 1, "expected exactly one fused device stage"
    return ops[0]


# ---------------------------------------------------------------------------
# one program / one commit per batch
# ---------------------------------------------------------------------------
def test_fused_chain_one_program_one_commit_per_batch(monkeypatch):
    col = RowCollector()
    g = _three_op_chain(wt, monkeypatch, True, 2, 16, col)
    g.run()
    # one stage for the whole device trio: threads = src + fused + sink
    assert g.get_num_threads() == 2 + 2 + 1
    op = _fused_stage(g)
    assert op["name"] == "m1∘f1∘m2"
    total = 0
    for r in op["replicas"]:
        assert r["Fused_ops"] == 3
        assert r["Device_batches_in"] > 0
        # one program and one dispatch commit per batch: no mid-chain
        # programs, no mid-chain readback commits
        assert r["Device_programs_run"] == r["Device_batches_in"]
        assert r["Dispatch_batches"] == r["Device_batches_in"]
        assert r["Programs_per_batch"] == 1.0
        total += r["Device_batches_in"]
    assert total > 0
    expected = sorted(
        (k, 3 * v + 7) for k in range(N_KEYS)
        for v in range(1, STREAM_LEN + 1) if (3 * v) % 2 == 0)
    assert col.multiset == expected
    ref = RowCollector()
    _three_op_chain(wj, monkeypatch, True, 2, 16, ref).run()
    assert ref.multiset == expected


def test_fusion_off_restores_per_stage_wiring(monkeypatch):
    col = RowCollector()
    g = _three_op_chain(wt, monkeypatch, False, 2, 16, col)
    g.run()
    assert g.get_num_threads() == 2 + 3 * 2 + 1
    assert not any(o["kind"] == "Fused_GPU_Chain"
                   for o in g.get_stats()["Operators"])
    refused = [s for s in g._stages if s.chain_refused]
    assert len(refused) == 2 and all(
        s.chain_refused == "device-chain fusion disabled "
        "(PipeGraph(fusion=False))" for s in refused)
    assert "unchained" in refused[0].describe(diagnostics=True)
    fused = RowCollector()
    _three_op_chain(wt, monkeypatch, True, 2, 16, fused).run()
    assert col.multiset == fused.multiset and col.multiset


# ---------------------------------------------------------------------------
# fused-vs-unfused randomized differential, and the JAX package's fused run
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [5, 19, 83])
def test_fused_vs_unfused_differential(seed, monkeypatch):
    rng = random.Random(seed)
    p = rand_degree(rng)
    batch = rng.choice([8, 16, 32])
    results = {}
    for pkg, fusion in ((wt, True), (wt, False), (wj, True)):
        col = RowCollector()
        _three_op_chain(pkg, monkeypatch, fusion, p, batch, col).run()
        results[(pkg.__name__, fusion)] = col.multiset
    ref = results[("windflow_tpu", True)]
    assert ref, "differential is vacuous on an empty stream"
    assert results[("windflow_tpu_torch", True)] == ref
    assert results[("windflow_tpu_torch", False)] == ref


def test_differential_empty_batches_and_punctuation(monkeypatch):
    """A filter dropping EVERY tuple mid-chain, with event-time
    punctuation: nothing is delivered either way, and the fused stage
    still ran its programs and counted every row ignored."""
    results = {}
    for fusion in (True, False):
        col = RowCollector()
        g = _three_op_chain(wt, monkeypatch, fusion, 2, 8, col,
                            drop_all_pred=True, event_time=True)
        g.run()
        results[fusion] = col.multiset
        if fusion:
            op = _fused_stage(g)
            assert sum(r["Device_programs_run"] for r in op["replicas"]) > 0
            assert sum(r["Inputs_ignored"] for r in op["replicas"]) \
                == N_KEYS * STREAM_LEN
    assert results[True] == results[False] == []


def test_differential_eos_with_inflight_commits(monkeypatch):
    """Deep dispatch queue: commits stay parked until the EOS drain, so
    delivery rides the terminate path and must equal the synchronous
    run."""
    results = {}
    for fusion, depth in ((True, 64), (False, 64), (True, 0)):
        monkeypatch.setattr(port_dispatch, "DISPATCH_DEPTH", depth)
        col = RowCollector()
        g = _three_op_chain(wt, monkeypatch, fusion, 1, 16, col)
        g.run()
        results[(fusion, depth)] = col.multiset
        if fusion and depth:
            r = _fused_stage(g)["replicas"][0]
            assert r["Dispatch_queue_depth_max"] > 2
    assert results[(True, 64)] == results[(False, 64)] == results[(True, 0)]
    assert results[(True, 64)]


def _ingress_blocks(batch=16):
    """The ingress stream (the N_KEYS keys interleaved, values 1 ..
    STREAM_LEN) as columnar blocks of ``batch`` rows: each block is one
    batch, so batch boundaries, and so each batch's fold, do not depend on
    timing."""
    key = np.tile(np.arange(N_KEYS, dtype=np.int32), STREAM_LEN)
    value = np.repeat(np.arange(1, STREAM_LEN + 1, dtype=np.int32), N_KEYS)
    ts = np.arange(len(key), dtype=np.int64)
    return [({"key": key[i:i + batch], "value": value[i:i + batch]},
             ts[i:i + batch], int(ts[i])) for i in range(0, len(key), batch)]


def _reduce_chain(pkg, monkeypatch, fusion, keyed, with_filter=True,
                  float_value=False):
    """src -> map -> [filter ->] Reduce (global, or keyed by "key") at
    parallelism 1; returns the delivered (key, value) rows in order, and
    the graph."""
    Map, Filter, Reduce = _b(pkg)
    g = _graph(pkg, monkeypatch, fusion, "fusion_red", event_time=True)
    blocks = _ingress_blocks()
    src = (pkg.Columnar_Source_Builder(lambda: iter(blocks))
           .with_output_batch_size(16).build())
    if float_value:
        f32 = ((lambda c: c.astype(jnp.float32)) if pkg is wj
               else (lambda c: c.to(torch.float32)))
        mf = lambda f: {**f, "value": f32(f["value"]) * 1.37}  # noqa: E731
    else:
        mf = lambda f: {**f, "value": f["value"] * 2}  # noqa: E731
    red = Reduce(lambda a, b: {"key": b["key"],
                               "value": a["value"] + b["value"]})
    if keyed:
        red = red.with_key_by("key")
    mp = g.add_source(src).add(Map(mf).with_name("m").build())
    if with_filter:
        mp = mp.chain(Filter(lambda f: f["value"] > 40).with_name("f")
                      .build())
    out, lock = [], threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                out.append((int(t["key"]), float(t["value"])
                            if float_value else int(t["value"])))

    mp.chain(red.with_name("r").build()) \
        .add_sink(pkg.Sink_Builder(sink).build())
    g.run()
    return out, g


@pytest.mark.parametrize("with_filter", [True, False])
def test_differential_reduce_terminator(monkeypatch, with_filter):
    """Global Reduce_GPU ends the chain: the fold takes the chain's keep
    mask (no compaction before it). Rows equal the JAX package's fused
    rows; value and count equal the unfused run's."""
    fused, g = _reduce_chain(wt, monkeypatch, True, False,
                             with_filter)
    plain, _ = _reduce_chain(wt, monkeypatch, False, False,
                             with_filter)
    ref, gj = _reduce_chain(wj, monkeypatch, True, False, with_filter)
    assert g.get_num_threads() == 1 + 1 + 1
    assert fused == ref and len(fused) > 0
    assert [v for _, v in fused] == [v for _, v in plain]
    r = _fused_stage(g)["replicas"][0]
    rj = _fused_stage(gj, "Fused_TPU_Chain")["replicas"][0]
    assert r["Inputs_ignored"] == rj["Inputs_ignored"]
    assert r["Device_programs_run"] == r["Dispatch_batches"]


def test_keyed_reduce_terminator_float_matches_jax(monkeypatch):
    """float32 keyed fold behind a filter: per-batch rows equal the JAX
    package's fused rows within rtol=1e-5, in the same key order."""
    got, _ = _reduce_chain(wt, monkeypatch, True, True,
                           float_value=True)
    ref, _ = _reduce_chain(wj, monkeypatch, True, True,
                           float_value=True)
    assert [k for k, _ in got] == [k for k, _ in ref] and got
    np.testing.assert_allclose([v for _, v in got], [v for _, v in ref],
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the scan with a validity plane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_masked_segmented_scan_matches_a_loop(seed):
    """Validity as an Option: each row holds the fold of its segment's
    valid rows up to it, and the scanned validity says whether there was
    one; with every row valid it is ``segmented_scan`` bit for bit."""
    rng = np.random.default_rng(seed)
    n = 37
    seg = np.sort(rng.integers(0, 6, n))
    same = np.r_[False, seg[1:] == seg[:-1]]
    vals = rng.integers(-50, 50, n).astype(np.int32)
    valid = rng.random(n) < 0.6
    comb = lambda a, b: {"v": a["v"] + b["v"]}  # noqa: E731
    out, vscan = masked_segmented_scan(
        comb, {"v": torch.from_numpy(vals)}, torch.from_numpy(same),
        torch.from_numpy(valid))
    acc, seen = 0, False
    for i in range(n):
        if not same[i]:
            acc, seen = 0, False
        if valid[i]:
            acc, seen = acc + int(vals[i]), True
        assert bool(vscan[i]) == seen
        if seen:
            assert int(out["v"][i]) == acc
    full, vfull = masked_segmented_scan(
        comb, {"v": torch.from_numpy(vals)}, torch.from_numpy(same),
        torch.ones(n, dtype=torch.bool))
    plain = segmented_scan(comb, {"v": torch.from_numpy(vals)},
                           torch.from_numpy(same))
    assert torch.equal(full["v"], plain["v"]) and bool(vfull.all())


@pytest.mark.parametrize("lo,hi,dtype", [
    (0, 256, np.int32),              # fits int16: the radix path
    (-2**15, 2**15, np.int32),       # the int16 range's both ends
    (-2**20, 2**20, np.int32),       # wider: the comparison sort
    (0, 2**16, np.uint32),
    (-2**40, 2**40, np.int64),
])
def test_keyed_host_order_matches_jax_across_key_ranges(lo, hi, dtype):
    """The fused keyed terminator's host sort over ALL rows (the port
    sorts keys that fit int16 through numpy's radix path): order, sorted
    slot ids and key map equal the JAX package's ``reduce_order_and_slots``
    on host keys of every range."""
    from types import SimpleNamespace

    from windflow_tpu.tpu.batch import BatchTPU
    from windflow_tpu.tpu.ops_tpu import reduce_order_and_slots as order_j
    from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
    from windflow_tpu_torch.gpu.batch import BatchGPU
    from windflow_tpu_torch.gpu.ops_gpu import reduce_order_and_slots
    from windflow_tpu_torch.gpu.schema import TupleSchema

    rng = np.random.default_rng(hi)
    n, cap = 3000, 4096
    keys = np.concatenate([[lo, hi - 1], rng.integers(lo, hi, n - 2)]
                          ).astype(dtype)
    rng.shuffle(keys)
    vals = np.arange(cap, dtype=np.int32)
    ts = np.arange(cap, dtype=np.int64)
    sch = {"v": np.int32}
    bj = BatchTPU({"v": jnp.asarray(vals)}, ts, n, SchemaJ(sch), 0, keys)
    bt = BatchGPU({"v": torch.from_numpy(vals)}, ts, n, TupleSchema(sch),
                  0, keys)
    op = SimpleNamespace(name="reduce", key_field="key", key_fields=None)
    o_j, s_j, k_j = order_j(op, bj)
    o_t, s_t, k_t = reduce_order_and_slots(op, bt)
    assert np.array_equal(o_t, o_j) and np.array_equal(s_t, s_j)
    assert list(k_t.items()) == list(k_j.items())


# ---------------------------------------------------------------------------
# legality: every refusal names its reason, the JAX package's reason
# ---------------------------------------------------------------------------
def _legal_graph(pkg, monkeypatch, src_par=1):
    g = _graph(pkg, monkeypatch, True, "legal", event_time=True)

    def src(shipper, ctx):
        for i in range(8):
            shipper.push_with_timestamp(TupleT(i % 2, i, i * 100), i * 100)
            shipper.set_next_watermark(i * 100)

    return g, g.add_source(pkg.Source_Builder(src).with_parallelism(src_par)
                           .with_output_batch_size(8).build())


def _ffat(pkg, name="w", p=1):
    if pkg is wj:
        b = Ffat_Windows_TPU_Builder(
            lambda f: {"value": f["value"]},
            lambda a, b: {"value": a["value"] + b["value"]})
    else:
        b = wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                        wt.fieldwise(value="sum"))
    return (b.with_key_by("key").with_num_win_per_batch(4)
            .with_tb_windows(1000, 400).with_name(name)
            .with_parallelism(p).build())


def _stateful_map(pkg, name):
    """A keyed map with device state, built by each package's builder."""
    if pkg is wj:
        return (Map_TPU_Builder(lambda r, s: (r, s)).with_key_by("key")
                .with_state({"x": jnp.int32(0)}).with_name(name).build())
    return (wt.Map_GPU_Builder(lambda r, s: (r, s)).with_key_by("key")
            .with_state({"x": 0}).with_name(name).build())


def _case(pkg, monkeypatch, case):
    """Build one legality case; returns (graph, the stage it ends on)."""
    Map, Filter, Reduce = _b(pkg)

    def red(name, key=True, p=1):
        b = Reduce(lambda a, b: {"key": b["key"],
                                 "value": a["value"] + b["value"]})
        if key:
            b = b.with_key_by("key")
        return b.with_name(name).with_parallelism(p).build()

    m = lambda name, p=1: (Map(lambda f: f).with_name(name)  # noqa: E731
                           .with_parallelism(p).build())
    g, mp = _legal_graph(pkg, monkeypatch,
                         src_par=2 if case == "cross_device_keyby" else 1)
    if case == "mixed_parallelism":
        mp.add(m("m1")).chain(m("m2", p=2))
    elif case == "host_after_device":
        mp.add(m("m1")).chain(pkg.Map_Builder(lambda t: t).with_name("h")
                              .build())
    elif case == "device_after_host":
        mp.add(pkg.Map_Builder(lambda t: t).with_name("h").build()) \
            .chain(m("m1"))
    elif case == "after_global_reduce":
        mp.add(m("m1")).chain(red("r", key=False)).chain(m("m2"))
    elif case == "after_keyed_reduce":
        mp.add(m("m1")).chain(red("kr")).chain(m("m2"))
    elif case == "after_window":
        mp.add(m("m1")).chain(_ffat(pkg)).chain(m("m2"))
    elif case == "keyed_behind_forward":
        mp.add(m("m1")).chain(Map(lambda f: f).with_key_by("key")
                              .with_name("km").build())
    elif case == "keys_differ":
        mp.add(Map(lambda f: f).with_key_by("key").with_name("k1").build()) \
            .chain(Map(lambda f: f).with_key_by("value").with_name("k2")
                   .build())
    elif case == "cross_device_keyby":
        mp.add(m("m1", p=2)).chain(red("kr2", p=2))
    elif case == "stateful_prefix_window":
        mp.add(_stateful_map(pkg, "sm")).chain(_ffat(pkg, "w4"))
    else:
        raise AssertionError(case)
    return g, g._stages[-1]


@pytest.mark.parametrize("case,needle", [
    ("mixed_parallelism", "mixed parallelism"),
    ("host_after_device", "device and host operators never share"),
    ("device_after_host", "device and host operators never share"),
    ("after_global_reduce", "already terminates the fused chain"),
    ("after_keyed_reduce", "already terminates the fused chain"),
    ("after_window", "window non-terminal position"),
    ("keyed_behind_forward", "is keyed but the chain entry"),
    ("keys_differ", "keys differ"),
    ("cross_device_keyby", "cross-device KEYBY"),
    ("stateful_prefix_window", "stateless map/filter prefix"),
])
def test_legality_refusals_match_jax(monkeypatch, case, needle):
    _, stage = _case(wt, monkeypatch, case)
    _, ref = _case(wj, monkeypatch, case)
    assert stage.chain_refused is not None and needle in stage.chain_refused
    assert stage.chain_refused == ref.chain_refused.replace("_TPU", "_GPU")
    assert stage.describe() == ref.describe()
    assert "unchained" in stage.describe(diagnostics=True)


@pytest.mark.parametrize("chain,label", [
    ("keyed_same_key", "k1∘k2"),
    ("keyed_terminator", "m∘kr"),
    ("window_terminator", "m∘f∘w"),
    ("global_terminator", "m∘f∘r"),
])
def test_legal_chains_fuse_like_jax(monkeypatch, chain, label):
    stages = {}
    for pkg in (wt, wj):
        Map, Filter, Reduce = _b(pkg)
        g, mp = _legal_graph(pkg, monkeypatch)
        m = Map(lambda f: f).with_name("m").build()
        f = Filter(lambda f: f["value"] >= 0).with_name("f").build()
        red = Reduce(lambda a, b: {"key": b["key"],
                                   "value": a["value"] + b["value"]})
        if chain == "keyed_same_key":
            mp.add(Map(lambda f: f).with_key_by("key").with_name("k1")
                   .build()) \
                .chain(Map(lambda f: f).with_key_by("key").with_name("k2")
                       .build())
        elif chain == "keyed_terminator":
            mp.add(m).chain(red.with_key_by("key").with_name("kr").build())
        elif chain == "window_terminator":
            mp.add(m).chain(f).chain(_ffat(pkg))
        else:
            mp.add(m).chain(f).chain(red.with_name("r").build())
        stages[pkg] = g._stages[-1]
    assert stages[wt].describe() == stages[wj].describe() == label
    assert stages[wt].chain_refused is None
    assert stages[wt].is_fused_gpu


def test_stateful_sub_op_in_a_fused_chain_is_not_yet_ported(monkeypatch):
    """A map with device state may join a chain by the legality rules
    (both packages allow a stateful map before a filter), and the port's
    fused replica builds it with one keyed-state engine for the stateful
    sub-op; what is not yet ported is that engine's incremental (delta)
    snapshot: it snapshots FULL, and only an explicit delta request
    raises."""
    g, mp = _legal_graph(wt, monkeypatch)
    mp.add(_stateful_map(wt, "sm")).chain(
        wt.Filter_GPU_Builder(lambda f: f["value"] >= 0).with_key_by("key")
        .with_name("sf").build())
    assert g._stages[-1].describe() == "sm∘sf"
    g.get_num_threads()  # builds the fused replica
    specs = g._stages[-1].first_op.replicas[0].specs
    assert [s.kind for s in specs] == ["smap", "filter"]
    # the engine takes a FULL snapshot (delta snapshots are off); only an
    # explicit delta request raises
    assert specs[0].engine.snapshot_state()["slot_of_key"] == {}
    with pytest.raises(wt.WindFlowError, match="not yet ported"):
        specs[0].engine.snapshot_state(delta=True)


def test_fused_snapshot_names_the_chain(monkeypatch):
    """A fused replica's snapshot carries the chain's signature under
    ``__fused__`` (the JAX package's layout): one entry per sub-op for the
    generic chain, the window's own state for a window-terminated one."""
    col = RowCollector()
    g = _three_op_chain(wt, monkeypatch, True, 1, 16, col)
    g.run()
    rep = g._stages[1].first_op.replicas[0]
    assert rep.snapshot_state() == {"cur_wm": rep.cur_wm,
                                    "__fused__": ["m1", "f1", "m2"],
                                    "fused_sub_states": [None] * 3}
    g2, mp = _legal_graph(wt, monkeypatch)
    mp.add(wt.Map_GPU_Builder(lambda f: f).with_name("m").build()) \
        .chain(_ffat(wt)).add_sink(wt.Sink_Builder(lambda r: None).build())
    g2.run()
    frep = g2._stages[1].first_op.replicas[0]
    st = frep.snapshot_state()
    assert st["__fused__"] == ["m", "w"] and st["ffat"]["K_cap"] >= 1
    assert frep._chain_tag() == ("chain", "m")
    assert st["ffat"]["slot_of_key"] == {0: 0, 1: 1}


@pytest.mark.parametrize("fusion", [True, False])
def test_fused_stage_stages_its_terminators_host_keys(monkeypatch, fusion):
    """A fused stage with an unkeyed entry takes its terminator's key at
    the staging edge, so its host prep reads host keys instead of waiting
    for the key column's copy back from the card; unfused, the map's
    staging edge carries no key."""
    g, mp = _legal_graph(wt, monkeypatch)
    g.fusion = fusion
    mp.add(wt.Map_GPU_Builder(lambda f: f).with_name("m").build()) \
        .chain(wt.Reduce_GPU_Builder(lambda a, b: {
            "key": b["key"], "value": a["value"] + b["value"]})
            .with_key_by("key").with_name("kr").build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    g.get_num_threads()
    staging = g._stages[0].last_op.replicas[0].emitter
    assert staging.key_field == ("key" if fusion else None)
    assert g._stages[1].is_fused_gpu == fusion
