"""The port's Map_GPU, Filter_GPU and Reduce_GPU, its keyed and broadcast
device edges and its host-plane operators, held against the JAX package
(``windflow_tpu``'s ``Map_TPU`` / ``Filter_TPU`` / ``Reduce_TPU``): the
same graph built with each package's own builders and twin user functions
(``jnp`` and ``torch``), on the same numpy stream made from a seed, the
JAX side on its CPU backend.

Tolerances: int32 fields exact; float32 fields exact through the tree
reduce (the same pairing) and ``rtol=1e-5`` through the keyed scan (the
port's Hillis-Steele scan groups the combine differently from
``associative_scan``). At parallelism 1 with block-aligned columnar input
the outputs are compared as row sequences, order included; above 1 as
per-key totals or multisets, since partial boundaries and arrival order
follow scheduling."""

import json
import os
import threading
from collections import Counter
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.tpu import (Filter_TPU_Builder, Map_TPU_Builder,
                              Reduce_TPU_Builder)
from windflow_tpu.tpu.batch import BatchTPU
from windflow_tpu.tpu.ops_tpu import Reduce_TPU
from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
from windflow_tpu_torch.gpu.batch import BatchGPU
from windflow_tpu_torch.gpu.schema import TupleSchema

from common import GlobalSum, TupleT, make_ingress_source, make_sum_sink

BATCH = 64
N_KEYS = 6


def _ops(pkg):
    if pkg is wj:
        return SimpleNamespace(Map=Map_TPU_Builder, Filter=Filter_TPU_Builder,
                               Reduce=Reduce_TPU_Builder, kw={},
                               f32=lambda c: c.astype(jnp.float32),
                               maximum=jnp.maximum)
    return SimpleNamespace(Map=wt.Map_GPU_Builder,
                           Filter=wt.Filter_GPU_Builder,
                           Reduce=wt.Reduce_GPU_Builder, kw={"device": "cpu"},
                           f32=lambda c: c.to(torch.float32),
                           maximum=torch.maximum)


def _blocks(n_blocks, seed, n_keys=N_KEYS, names=False):
    """(cols, ts, wm) blocks of BATCH rows: int32 key and value, a float32
    weight, optionally a str name per key (host metadata only)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        keys = rng.integers(0, n_keys, BATCH).astype(np.int32)
        cols = {"key": keys,
                "value": rng.integers(0, 100, BATCH).astype(np.int32),
                "w": rng.standard_normal(BATCH).astype(np.float32)}
        if names:
            cols["name"] = np.array([f"user{k}" for k in keys])
        ts = b * BATCH + np.arange(BATCH, dtype=np.int64)
        out.append((cols, ts, int(ts[0])))
    return out


def _run(pkg, stages, blocks, schema=None):
    """Columnar source -> stages -> columnar sink. ``stages`` builds each
    operator from the package's builders; returns the sink's batches
    ([(cols, ts)], in arrival order) and the graph."""
    ops = _ops(pkg)
    graph = pkg.PipeGraph("ops", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT_TIME, **ops.kw)
    mp = graph.add_source(pkg.Columnar_Source_Builder(lambda: iter(blocks))
                          .with_output_batch_size(BATCH).build())
    for make in stages:
        b = make(ops)
        if schema is not None:
            b = b.with_schema(schema)
        mp.add(b.build())
    out, lock = [], threading.Lock()

    def sink(cols, ts):
        if cols is not None:
            with lock:
                out.append(({k: np.array(v) for k, v in cols.items()},
                            np.array(ts)))

    mp.add_sink(pkg.Sink_Builder(sink).with_columns().build())
    run_bounded(graph)
    return out, graph


def _rows(out):
    """Concatenated columns and ts, in arrival order."""
    names = sorted(out[0][0])
    cols = {k: np.concatenate([c[k] for c, _ in out]) for k in names}
    cols["ts"] = np.concatenate([t for _, t in out])
    return cols


def _assert_rows(ref, got, rtol=None):
    r, g = _rows(ref), _rows(got)
    assert r.keys() == g.keys() and len(r["ts"]) > 0
    for k in r:
        assert r[k].dtype == g[k].dtype, k
        if rtol is not None and r[k].dtype.kind == "f":
            np.testing.assert_allclose(g[k], r[k], rtol=rtol)
        else:
            assert np.array_equal(g[k], r[k]), k


def _key_totals(out, fields=("value",)):
    tot = Counter()
    for cols, _ in out:
        for i, k in enumerate(cols["key"].tolist()):
            for f in fields:
                tot[(k, f)] += cols[f][i].item()
    return tot


def _stat(graph, op_idx, name):
    return sum(r[name] for r in
               graph.get_stats()["Operators"][op_idx]["replicas"])


# ---------------------------------------------------------------------------
# each operator alone, parallelism 1: row sequences
# ---------------------------------------------------------------------------
def test_map_matches_jax():
    blocks = _blocks(6, seed=1)
    stages = [lambda o: o.Map(lambda f: {
        **f, "value": f["value"] * 3 + f["key"],
        "w": o.f32(f["value"]) * 0.5 + f["w"]})]
    _assert_rows(_run(wj, stages, blocks)[0], _run(wt, stages, blocks)[0])


@pytest.mark.parametrize("mask", ["bool", "int"])
def test_filter_matches_jax(mask):
    pred = ((lambda f: f["value"] % 2 == 0) if mask == "bool"
            else (lambda f: f["value"] % 2))  # an int 0/1 column
    blocks = _blocks(6, seed=2)
    ref, gj = _run(wj, [lambda o: o.Filter(pred)], blocks)
    got, gt = _run(wt, [lambda o: o.Filter(pred)], blocks)
    _assert_rows(ref, got)
    assert _stat(gt, 1, "Inputs_ignored") == _stat(gj, 1, "Inputs_ignored")
    assert 0 < _stat(gt, 1, "Inputs_ignored") < 6 * BATCH


def _sum_combine(o):
    """Sums of value, and of w where the stream has it."""
    return lambda a, b: {"key": b["key"], "value": a["value"] + b["value"],
                         **({"w": a["w"] + b["w"]} if "w" in a else {})}


def test_keyed_reduce_int_keys_matches_jax():
    blocks = _blocks(6, seed=3)
    stages = [lambda o: o.Reduce(_sum_combine(o)).with_key_by("key")]
    ref = _run(wj, stages, blocks)[0]
    got = _run(wt, stages, blocks)[0]
    _assert_rows(ref, got, rtol=1e-5)
    assert len(ref) == 6 and len(_rows(ref)["key"]) == 6 * N_KEYS


def test_keyed_reduce_str_keys_matches_jax():
    """str keys ride host metadata (the schema leaves the column out): one
    output per name, in first-appearance order."""
    blocks = _blocks(6, seed=4, n_keys=9, names=True)
    schema = {"key": np.int32, "value": np.int32, "w": np.float32}
    stages = [lambda o: o.Reduce(lambda a, b: {
        "key": o.maximum(a["key"], b["key"]),
        "value": a["value"] + b["value"]}).with_key_by("name")]
    ref = _run(wj, stages, blocks, schema)[0]
    got = _run(wt, stages, blocks, schema)[0]
    _assert_rows(ref, got, rtol=1e-5)
    assert len(_rows(ref)["key"]) == 6 * 9


@pytest.mark.parametrize("cap", [3, 5, 7, 10, 13, "partial"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_global_reduce_capacities_match_jax(cap, dtype):
    """The tree reduce pads odd capacities; only ``size`` rows take part;
    a field the combine does not return passes through. Exact for float32
    too: both fold the same pairs."""
    size = 6 if cap == "partial" else cap
    cap = 10 if cap == "partial" else cap
    rng = np.random.default_rng(cap)
    vals = (rng.standard_normal(cap) * 100).astype(dtype)
    keys = rng.integers(0, 50, cap).astype(np.int32)
    ts = rng.integers(0, 1000, cap).astype(np.int64)
    combine = lambda a, b: {"value": a["value"] + b["value"]}  # noqa: E731
    outs = {}
    for pkg in ("jax", "port"):
        got = []

        class Cap:
            stats = None

            def emit_device_batch(self, b):
                got.append(({k: np.asarray(v)[:b.size].copy()
                             for k, v in b.fields.items()},
                            b.ts_host[:b.size].copy(), b.size))

            def set_stats(self, s):
                pass

        if pkg == "jax":
            op = Reduce_TPU(combine)
            op.build_replicas()
            batch = BatchTPU({"key": jnp.asarray(keys),
                              "value": jnp.asarray(vals)}, ts, size,
                             SchemaJ({"key": np.int32, "value": dtype}))
        else:
            op = wt.Reduce_GPU(combine)
            op.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.INGRESS_TIME,
                         torch.device("cpu"))
            op.build_replicas()
            batch = BatchGPU({"key": torch.from_numpy(keys),
                              "value": torch.from_numpy(vals)}, ts, size,
                             TupleSchema({"key": np.int32, "value": dtype}))
        rep = op.replicas[0]
        rep.emitter = Cap()
        rep.process_device_batch(batch)
        outs[pkg] = got
    (rj, tj, nj), = outs["jax"]
    (rt, tt, nt), = outs["port"]
    assert nj == nt == 1 and np.array_equal(tt, tj)
    assert tt[0] == ts[:size].max()
    for k in rj:
        assert rt[k].dtype == rj[k].dtype
        assert rt[k].tobytes() == rj[k].tobytes(), k
    if dtype is np.int32:
        assert rt["value"][0] == vals[:size].sum()


# ---------------------------------------------------------------------------
# BASELINE's graph_tests_gpu path: map -> filter -> reduce
# ---------------------------------------------------------------------------
def _chain(keyed):
    def reduce(o):
        b = o.Reduce(_sum_combine(o))
        return b.with_key_by("key") if keyed else b
    return [lambda o: o.Map(lambda f: {**f, "value": f["value"] * 3
                                       + f["key"]}),
            lambda o: o.Filter(lambda f: f["value"] % 2 == 0),
            reduce]


@pytest.mark.parametrize("keyed", [True, False], ids=["keyed", "global"])
def test_graph_tests_gpu_chain_par1_matches_jax(keyed):
    blocks = _blocks(8, seed=5)
    ref, gj = _run(wj, _chain(keyed), blocks)
    got, gt = _run(wt, _chain(keyed), blocks)
    _assert_rows(ref, got, rtol=1e-5)
    assert len(got) == 8
    assert _stat(gt, 2, "Inputs_ignored") == _stat(gj, 2, "Inputs_ignored")


@pytest.mark.parametrize("pars", [(2, 3, 2), (3, 2, 3)])
def test_graph_tests_gpu_chain_parallel_matches_jax(pars):
    """Map, filter and keyed reduce at other parallelisms: the filter ->
    reduce edge is a keyed device -> device re-shard on the key column."""
    def build(pkg):
        o = _ops(pkg)
        acc = {}
        lock = threading.Lock()

        def sink(t):
            if t is not None:
                with lock:
                    acc[t.key] = acc.get(t.key, 0) + t.value

        graph = pkg.PipeGraph("chain", pkg.ExecutionMode.DEFAULT,
                              pkg.TimePolicy.INGRESS_TIME, **o.kw)
        src = (pkg.Source_Builder(make_ingress_source(N_KEYS, 64))
               .with_parallelism(2).with_output_batch_size(16).build())
        ops = [make(o).with_parallelism(p).build()
               for make, p in zip(_chain(True), pars)]
        mp = graph.add_source(src)
        for op in ops:
            mp.add(op)
        mp.add_sink(pkg.Sink_Builder(sink).build())
        run_bounded(graph)
        assert graph.get_num_threads() == 2 + sum(pars) + 1
        return acc

    ref = build(wj)
    assert build(wt) == ref
    assert ref == {k: sum(3 * v + k for v in range(1, 65)
                          if (3 * v + k) % 2 == 0) for k in range(N_KEYS)}


# ---------------------------------------------------------------------------
# device -> device edges
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("key", ["host_keys", "field"])
def test_keyed_device_reshard_matches_jax(key):
    """``host_keys``: keyed staging attaches the keys and the reduce's key
    extractor is a callable, so only the metadata can route it.
    ``field``: forward staging, the key is read back from the column."""
    blocks = _blocks(8, seed=6, n_keys=11)

    def stages():
        if key == "host_keys":
            return [lambda o: o.Map(lambda f: {**f, "value": f["value"] + 1})
                    .with_key_by("key").with_parallelism(2),
                    lambda o: o.Reduce(_sum_combine(o))
                    .with_key_by(lambda t: t["key"]).with_parallelism(3)]
        return [lambda o: o.Map(lambda f: {**f, "value": f["value"] + 1})
                .with_parallelism(2),
                lambda o: o.Reduce(_sum_combine(o)).with_key_by("key")
                .with_parallelism(3)]

    ref = _key_totals(_run(wj, stages(), blocks)[0])
    got = _key_totals(_run(wt, stages(), blocks)[0])
    assert got == ref
    assert sum(ref.values()) == sum(int(c["value"].sum()) + BATCH
                                   for c, _, _ in blocks)


def _multiset(out):
    r = _rows(out)
    return Counter(zip(r["key"].tolist(), r["value"].tolist(),
                       r["ts"].tolist()))


def test_device_broadcast_matches_jax():
    """Every replica after a device -> device broadcast gets every batch;
    neither replica sees the other's output."""
    blocks = _blocks(4, seed=7)
    stages = [lambda o: o.Map(lambda f: {**f, "value": f["value"] + 1})
              .with_key_by("key").with_parallelism(2),
              lambda o: o.Map(lambda f: {**f, "value": f["value"] * 10})
              .with_broadcast().with_parallelism(3)]
    ref = _multiset(_run(wj, stages, blocks)[0])
    got = _multiset(_run(wt, stages, blocks)[0])
    assert got == ref
    assert sum(ref.values()) == 3 * 4 * BATCH
    assert all(c == 3 for c in ref.values())


def test_staging_broadcast_matches_jax():
    """CPU -> device staging with broadcast routing."""
    blocks = _blocks(4, seed=8)
    stages = [lambda o: o.Map(lambda f: {**f, "value": f["value"] - 1})
              .with_broadcast().with_parallelism(2)]
    ref = _multiset(_run(wj, stages, blocks)[0])
    got = _multiset(_run(wt, stages, blocks)[0])
    assert got == ref and sum(ref.values()) == 2 * 4 * BATCH


def test_broadcast_copies_share_columns_and_ops_leave_inputs_unchanged():
    """A broadcast copy shares the device columns, so no device operator
    may write an input column: run each one on one shared batch and check
    its columns after."""
    rng = np.random.default_rng(9)
    n = 40
    sch = TupleSchema({"key": np.int32, "value": np.int32})
    cols = {"key": torch.from_numpy(rng.integers(0, 5, 64).astype(np.int32)),
            "value": torch.from_numpy(rng.integers(0, 99, 64)
                                      .astype(np.int32))}
    batch = BatchGPU(cols, np.arange(64, dtype=np.int64), n, sch)
    copy = batch.copy_for_dest()
    assert all(copy.fields[k] is batch.fields[k] for k in cols)
    before = {k: v.clone() for k, v in cols.items()}
    combine = lambda a, b: {"key": b["key"],  # noqa: E731
                            "value": a["value"] + b["value"]}
    ops = [wt.Map_GPU(lambda f: {**f, "value": f["value"] * 2}),
           wt.Filter_GPU(lambda f: f["value"] % 3 == 0),
           wt.Reduce_GPU(combine, key_extractor="key"),
           wt.Reduce_GPU(combine)]
    emitted = []
    for op in ops:
        op.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.INGRESS_TIME,
                     torch.device("cpu"))
        op.build_replicas()
        rep = op.replicas[0]
        rep.emitter = SimpleNamespace(emit_device_batch=emitted.append,
                                      set_stats=lambda s: None)
        commit = rep.prep_device_batch(copy.copy_for_dest())
        commit()
        for k, v in cols.items():
            assert torch.equal(v, before[k]), (op.name, k)
    assert len(emitted) == 4


# ---------------------------------------------------------------------------
# host-plane operators and mixed graphs
# ---------------------------------------------------------------------------
def test_mixed_cpu_device_graph_matches_jax():
    """CPU map -> device map -> CPU filter -> sink (both boundaries)."""
    def run(pkg):
        o = _ops(pkg)
        acc = GlobalSum()
        graph = pkg.PipeGraph("mixed", **o.kw)
        src = (pkg.Source_Builder(make_ingress_source(3, 40))
               .with_parallelism(2).build())
        cpu_m = (pkg.Map_Builder(lambda t: TupleT(t.key, t.value * 10, t.ts))
                 .with_parallelism(2).with_output_batch_size(8).build())
        dev_m = (o.Map(lambda f: {**f, "value": f["value"] + 5})
                 .with_parallelism(2).build())
        cpu_f = (pkg.Filter_Builder(lambda t: t.value % 4 != 0)
                 .with_parallelism(2).build())
        graph.add_source(src).add(cpu_m).add(dev_m).add(cpu_f).add_sink(
            pkg.Sink_Builder(make_sum_sink(acc)).build())
        run_bounded(graph)
        return acc.value, acc.count

    ref = run(wj)
    assert run(wt) == ref
    assert ref[0] == sum(10 * v + 5 for k in range(3) for v in range(1, 41)
                         if (10 * v + 5) % 4 != 0)


def test_host_plane_ops_match_jax():
    """FlatMap -> keyed Reduce on the CPU plane, and a broadcast into
    in-place maps (copy-on-write keeps the shared payload intact)."""
    def run(pkg):
        out, lock = {}, threading.Lock()

        def sink(t):
            if t is not None:
                with lock:
                    out[t["key"]] = max(out.get(t["key"], 0), t["total"])

        def twice(t, shipper):
            shipper.push({"key": t.key, "value": t.value})
            shipper.push({"key": t.key, "value": t.value * 2})

        def running(t, state):
            state["key"] = t["key"]
            state["total"] += t["value"]

        kw = _ops(pkg).kw
        graph = pkg.PipeGraph("host", **kw)
        graph.add_source(pkg.Source_Builder(make_ingress_source(N_KEYS, 30))
                         .with_parallelism(2).build()) \
            .add(pkg.FlatMap_Builder(twice).with_parallelism(2).build()) \
            .add(pkg.Reduce_Builder(running).with_key_by(lambda t: t["key"])
                 .with_initial_state({"key": -1, "total": 0})
                 .with_parallelism(3).build()) \
            .add_sink(pkg.Sink_Builder(sink).build())
        run_bounded(graph)

        acc = GlobalSum()

        def inplace_double(t):
            t.value *= 2

        g2 = pkg.PipeGraph("bcast", **kw)
        g2.add_source(pkg.Source_Builder(make_ingress_source(2, 30)).build()) \
            .add(pkg.Map_Builder(inplace_double).with_broadcast()
                 .with_parallelism(2).build()) \
            .add_sink(pkg.Sink_Builder(make_sum_sink(acc)).build())
        run_bounded(g2)
        return out, acc.value

    ref = run(wj)
    assert run(wt) == ref
    assert ref[0] == {k: 3 * sum(range(1, 31)) for k in range(N_KEYS)}
    assert ref[1] == 2 * 2 * 2 * sum(range(1, 31))


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def _no_batch_size(pkg):
    o = _ops(pkg)
    g = pkg.PipeGraph("nobatch", **o.kw)
    g.add_source(pkg.Source_Builder(make_ingress_source(1, 4)).build()) \
        .add(o.Map(lambda f: f).build()) \
        .add_sink(pkg.Sink_Builder(lambda t: None).build())
    run_bounded(g)


def _deterministic(pkg):
    o = _ops(pkg)
    g = pkg.PipeGraph("det", pkg.ExecutionMode.DETERMINISTIC, **o.kw)
    g.add_source(pkg.Source_Builder(make_ingress_source(1, 4))
                 .with_output_batch_size(4).build()) \
        .add(o.Map(lambda f: f).build()) \
        .add_sink(pkg.Sink_Builder(lambda t: None).build())
    run_bounded(g)


def _reduce_broadcast(pkg):
    _ops(pkg).Reduce(lambda a, b: a).with_broadcast().build()


@pytest.mark.parametrize("case,match", [
    (_no_batch_size, "output batch size"),
    (_deterministic, "DETERMINISTIC|DEFAULT"),
    (_reduce_broadcast, "withBroadcast is not supported"),
], ids=["no_output_batch_size", "non_default_mode", "reduce_broadcast"])
def test_refusals_match_jax(case, match):
    for pkg in (wj, wt):
        with pytest.raises(pkg.WindFlowError, match=match):
            case(pkg)


def _graph():
    return wt.PipeGraph(device="cpu")


def _ran_graph(name="surf"):
    """A small host graph that has run (the exports need stages)."""
    g = wt.PipeGraph(name, device="cpu")
    g.add_source(wt.Source_Builder(
        lambda sh: [sh.push({"v": i}) for i in range(4)]).build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    g.run()
    return g


def _check_dump_stats(tmp):
    g = _ran_graph("surf_stats")
    path = g.dump_stats(str(tmp))
    return json.load(open(path))["PipeGraph_name"] == "surf_stats" \
        and os.path.exists(os.path.join(str(tmp), "surf_stats_diagram.svg"))


def _check_dump_trace(tmp):
    g = wt.PipeGraph("surf_trace", device="cpu").with_flight_recorder(64)
    g.add_source(wt.Source_Builder(
        lambda sh: [sh.push({"v": i}) for i in range(4)])
        .with_latency_tracing(1).build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).with_latency_tracing(1)
                  .build())
    g.run()
    doc = json.load(open(g.dump_trace(str(tmp / "t.json"))))
    return any(e["ph"] == "X" for e in doc["traceEvents"])


def _check_prewarm_report(tmp):
    g = wt.PipeGraph("surf_pw", device="cpu").with_prewarm()
    g.add_source(wt.Source_Builder(lambda sh: None).build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    assert g.prewarm_report is None  # before start: nothing warmed
    g.run()
    return g.prewarm_report["skipped"] == ["no device stages"]


_PORTED = {
    "slo": lambda tmp: _graph().with_slo(50)._slo_p99_ms == 50.0,
    "prewarm": lambda tmp: _graph().with_prewarm()._prewarm_enabled,
    # the monitoring plane
    "builder_latency_tracing":
        lambda tmp: wt.Map_Builder(lambda t: t).with_latency_tracing(1)
        .build().latency_sample == 1,
    "builder_flight_recorder":
        lambda tmp: wt.Sink_Builder(lambda t: None).with_flight_recorder(64)
        .build().flightrec_events == 64,
    "graph_flight_recorder":
        lambda tmp: _graph().with_flight_recorder(64)._flightrec_events
        == 64,
    "dump_stats": _check_dump_stats,
    "dump_trace": _check_dump_trace,
    "trace_document":
        lambda tmp: _graph().trace_document()["traceEvents"] == [],
    "to_dot": lambda tmp: "->" in _ran_graph("surf_dot").to_dot(),
    "to_svg": lambda tmp: _ran_graph("surf_svg").to_svg().startswith(
        "<svg"),
    # the overload plane
    "source_slo":
        lambda tmp: wt.Source_Builder(lambda s: None).with_slo(50).build()
        .slo_p99_ms == 50.0,
    "source_priority":
        lambda tmp: wt.Columnar_Source_Builder(lambda: iter(()))
        .with_priority(lambda t: 7).build().priority_fn(None) == 7,
    "prewarm_report": _check_prewarm_report,
    # the kernels' compile cache: recorded for start(), nothing
    # process-wide before it
    "compile_cache": lambda tmp: _graph().with_compile_cache(
        str(tmp / "cc"))._compile_cache_dir == str(tmp / "cc"),
    # a mesh over two physical devices: a group of shards on each
    "mesh": lambda tmp: wt.mesh.KeyMesh(
        (2, 1), [(0, torch.device("cpu")),
                 (1, torch.device("meta"))]).n_groups == 2,
}


@pytest.mark.parametrize("case", sorted(_PORTED))
def test_ported_surfaces_work(case, tmp_path):
    """The surfaces of the monitoring, overload and prewarm planes and
    the compile cache that the port now has (they refused until these
    came): each does what the JAX package's does."""
    assert _PORTED[case](tmp_path)


@pytest.mark.parametrize("name", sorted(wj.__all__))
def test_every_jax_top_level_name_is_ported_or_refused(name):
    """Every name the JAX package exports is in the port, or raises
    ``WindFlowError`` saying it is not ported yet (``from ... import``
    included), never ``AttributeError`` / ``ImportError``."""
    try:
        getattr(wt, name)
    except wt.WindFlowError as e:
        assert "not yet ported" in str(e)
        with pytest.raises(wt.WindFlowError, match="not yet ported"):
            exec(f"from windflow_tpu_torch import {name}", {})
    else:
        assert name in wt.__all__
