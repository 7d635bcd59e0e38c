"""The port's flight recorder, stall watchdog and kernel-build
attribution against the JAX package's: twins of
``test_flight_recorder.py``.

Ring semantics and the Chrome trace export are compared with the JAX
package's on the same events; the graph traces are held to the JAX
schema (``scripts/check_metrics.validate_chrome_trace``) and the same
span names; the watchdog, crash dumps and crash stats behave as the JAX
package's. The compile attribution has no jit to count in the port: its
counterpart is the forest-rebuild kernel's build or load
(``flightrec.note_kernel_load``), checked with the library loader
stubbed (this machine has no nvcc). The JAX package's knobs are
arguments here (``stall_sec``, ``log_dir``)."""

import json
import os
import sys
import threading
import time

import pytest

import windflow_tpu_torch as wt
from windflow_tpu.monitoring.flightrec import FlightRecorder as RecJ
from windflow_tpu.monitoring.flightrec import to_chrome_trace as chrome_j
from windflow_tpu_torch.monitoring.flightrec import (FlightRecorder,
                                                     to_chrome_trace)
from windflow_tpu_torch.monitoring.stats import StatsRecord
from common import GlobalSum, TupleT, make_ingress_source, make_sum_sink
from torch_waits import run_bounded, wait_end_bounded

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))
from check_metrics import validate_chrome_trace  # noqa: E402

N_KEYS, STREAM_LEN = 4, 48


def _pg(name, **kw):
    return wt.PipeGraph(name, wt.ExecutionMode.DEFAULT,
                        wt.TimePolicy.INGRESS_TIME, device="cpu", **kw)


def test_ring_wraparound_matches_jax():
    """Fixed capacity, newest kept, oldest dropped first — event for
    event as the JAX ring."""
    rt, rj = FlightRecorder(4, "p", "t"), RecJ(4, "p", "t")
    for i in range(10):
        rt.event(f"e{i}", float(i))
        rj.event(f"e{i}", float(i))
    assert len(rt) == len(rj) == 4 and rt.dropped == rj.dropped == 6
    assert [e[1:] for e in rt.snapshot()] == [e[1:] for e in rj.snapshot()]
    stamps = [e[0] for e in rt.snapshot()]
    assert stamps == sorted(stamps)


def test_ring_below_capacity_keeps_all():
    rec = FlightRecorder(16)
    for i in range(5):
        rec.event(f"e{i}")
    assert len(rec) == 5 and rec.dropped == 0
    assert [e[1] for e in rec.snapshot()] == [f"e{i}" for i in range(5)]


def test_chrome_trace_export_matches_jax():
    """The same ring content exports the same document (events,
    metadata, dropped count)."""
    rt, rj = FlightRecorder(2, "p", "t"), RecJ(2, "p", "t")
    for i in range(7):
        for r in (rt, rj):
            r.event("x", 1.0, {"i": i})
    # same stamps: compare documents built from identical rings
    rj._buf = list(rt._buf)
    rj._n = rt._n
    doc = to_chrome_trace([rt])
    assert doc == chrome_j([rj])
    assert doc["droppedEvents"] == 5
    assert not validate_chrome_trace(doc)


def _spans(doc):
    return [e for e in doc["traceEvents"] if e.get("ph") == "X"]


_RESIDENCY = {"dispatch_wait"}  # queue residency, may overlap by design


def _same_name_spans_disjoint(doc):
    by_key = {}
    for e in _spans(doc):
        if e["name"] in _RESIDENCY:
            continue
        by_key.setdefault((e["pid"], e["tid"], e["name"]), []).append(
            (e["ts"], e["ts"] + e["dur"]))
    checked = 0
    for spans in by_key.values():
        spans.sort()
        for (_, end0), (start1, _) in zip(spans, spans[1:]):
            assert start1 >= end0 - 1.0, spans
            checked += 1
    return checked


def test_cpu_chain_trace_json(tmp_path):
    acc = GlobalSum()
    g = _pg("frec_cpu_t").with_flight_recorder()
    g.add_source(wt.Source_Builder(make_ingress_source(N_KEYS, STREAM_LEN))
                 .with_latency_tracing(1).build()) \
        .chain(wt.Map_Builder(lambda t: TupleT(t.key, t.value * 2, t.ts))
               .with_latency_tracing(1).build()) \
        .chain_sink(wt.Sink_Builder(make_sum_sink(acc))
                    .with_latency_tracing(1).build())
    run_bounded(g)
    assert acc.count == N_KEYS * STREAM_LEN
    path = str(tmp_path / "cpu_trace.json")
    assert g.dump_trace(path) == path
    doc = json.load(open(path))
    assert not validate_chrome_trace(doc), validate_chrome_trace(doc)
    names = {e["name"] for e in _spans(doc)}
    assert {"svc:map", "svc:sink"} <= names, names
    metas = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {m["name"] for m in metas} == {"process_name", "thread_name"}
    assert _same_name_spans_disjoint(doc) > 0
    assert all(e["ts"] >= 0 and e["dur"] >= 0 for e in _spans(doc))


def test_device_pipeline_trace_spans():
    """Staging -> Map -> Filter (device, unfused) -> sink: the dispatch
    pipeline's stages, the emits and the compaction readback leave
    spans, one ring per worker."""
    acc = GlobalSum()
    g = _pg("frec_dev_t", fusion=False).with_flight_recorder()
    g.add_source(wt.Source_Builder(make_ingress_source(N_KEYS, STREAM_LEN))
                 .with_output_batch_size(16).build()) \
        .add(wt.Map_GPU_Builder(
            lambda f: {**f, "value": f["value"] * 3 + f["key"]}).build()) \
        .add(wt.Filter_GPU_Builder(lambda f: (f["value"] % 2) == 0)
             .build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    run_bounded(g)
    doc = g.trace_document()
    assert not validate_chrome_trace(doc), validate_chrome_trace(doc)
    names = {e["name"] for e in _spans(doc)}
    assert names >= {"host_prep", "commit", "emit", "readback",
                     "dispatch_submit"}, names
    _same_name_spans_disjoint(doc)
    assert len({e["tid"] for e in _spans(doc)}) >= 3


def test_per_op_builder_override():
    acc = GlobalSum()
    g = _pg("frec_perop_t")
    g.add_source(wt.Source_Builder(make_ingress_source(2, 8)).build()) \
        .add(wt.Map_Builder(lambda t: t).with_flight_recorder(64)
             .with_parallelism(2).build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    run_bounded(g)
    assert len(g._recorders) == 2  # the map stage only, one per replica
    assert all(r.capacity == 64 for r in g._recorders)


def test_dump_trace_without_recorder_is_empty_but_valid(tmp_path):
    acc = GlobalSum()
    g = _pg("frec_off_t")
    g.add_source(wt.Source_Builder(make_ingress_source(2, 4)).build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    run_bounded(g)
    doc = json.load(open(g.dump_trace(str(tmp_path / "empty.json"))))
    assert doc["traceEvents"] == [] and not validate_chrome_trace(doc)


def test_checkpoint_spans_in_trace(tmp_path):
    class ReplaySrc:
        def __init__(self):
            self.pos = 0

        def __call__(self, shipper):
            while self.pos < 64:
                shipper.push(TupleT(key=self.pos % 4, value=self.pos))
                self.pos += 1
                if self.pos == 32:
                    assert shipper.request_checkpoint() is not None

        def snapshot_position(self):
            return self.pos

        def restore(self, pos):
            self.pos = pos

    acc = GlobalSum()
    g = _pg("frec_ckpt_t").with_flight_recorder()
    g.with_checkpointing(store_dir=str(tmp_path / "store"))
    g.add_source(wt.Source_Builder(ReplaySrc()).build()) \
        .add(wt.Map_Builder(lambda t: t).build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    run_bounded(g)
    assert acc.count == 64
    spans = _spans(g.trace_document())
    names = {e["name"] for e in spans}
    assert {"barrier_open", "ckpt_snapshot", "ckpt_ack",
            "ckpt_commit"} <= names, names
    acks = [e for e in spans if e["name"] == "ckpt_ack"]
    assert {e["args"]["ckpt_id"] for e in acks} == {1} and len(acks) == 3


def test_kernel_load_is_the_compile_event(monkeypatch):
    """K1's first use on a replica is its compile event (an ``nvcc`` build
    or a cached load, timed), every later use a cache hit; the span lands
    in the calling thread's ring. The event names the replica's variant:
    the fieldwise library, or its traced combine's own."""
    import torch

    from windflow_tpu_torch.gpu import ffat_gpu
    from windflow_tpu_torch.kernels import build
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.monitoring.flightrec import set_thread_recorder

    traced = lambda a, b: {"value": b["value"]}  # noqa: E731
    tag = fr.variant(traced, {"value": torch.int32}).tag
    monkeypatch.setattr(fr.Variant, "load", lambda self: None)
    monkeypatch.setitem(build.BUILD_INFO, "forest_rebuild",
                        {"seconds": 12.5, "log": ""})
    monkeypatch.setitem(build.BUILD_INFO, f"forest_rebuild-{tag}",
                        {"seconds": 0.0, "log": ""})

    class Op:
        def __init__(self, combine):
            self.combine = combine

    class Rep:
        def __init__(self, combine):
            self.stats = StatsRecord("ffat_gpu", 0)
            self.op = Op(combine)

    for combine, sig in ((wt.fieldwise(value="sum"), "forest_rebuild:nvcc"),
                         (traced, f"forest_rebuild-{tag}:cached")):
        rep = Rep(combine)
        rec = FlightRecorder(16, "p", "t")
        set_thread_recorder(rec)
        try:
            for _ in range(3):
                ffat_gpu.note_k1_use(rep, {"value": torch.int32})
        finally:
            set_thread_recorder(None)
        d = rep.stats.to_dict()
        assert (d["Compile_count"], d["Compile_cache_hits"]) == (1, 2)
        assert d["Compile_last_signature"] == sig
        assert d["Compile_usec_total"] == d["Compile_last_usec"] >= 0
        ev = [e for e in rec.snapshot() if e[1] == "compile"]
        assert len(ev) == 1 and ev[0][3]["op"] == sig.split(":")[0]


def test_compile_stats_exported_by_device_pipeline():
    """The Compile_* series exist on every replica; on the CPU the device
    path builds no kernel (the plain version needs none), so they stay 0
    and a prewarmed FFAT replica loads nothing."""
    acc = GlobalSum()
    g = _pg("frec_compile_t").with_prewarm()
    g.add_source(wt.Source_Builder(make_ingress_source(N_KEYS, STREAM_LEN))
                 .with_output_batch_size(16).build()) \
        .add(wt.Map_GPU_Builder(lambda f: {**f, "value": f["value"] + 1})
             .build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    run_bounded(g)
    rep = next(op for op in g.get_stats()["Operators"]
               if op["name"] == "map_gpu")["replicas"][0]
    assert rep["Compile_count"] == 0 and rep["Compile_cache_hits"] == 0
    assert rep["Compile_last_signature"] == ""


def test_watchdog_fires_on_stuck_functor(tmp_path):
    release = threading.Event()

    def src(shipper):
        for i in range(4):
            shipper.push(TupleT(key=0, value=i))

    def stuck_map_functor(t):
        if t.value == 2:
            assert release.wait(30.0), "test harness never released"
        return t

    acc = GlobalSum()
    g = _pg("frec_stall_t", stall_sec=0.4,
            log_dir=str(tmp_path)).with_flight_recorder()
    g.add_source(wt.Source_Builder(src).build()) \
        .add(wt.Map_Builder(stuck_map_functor).with_name("stuckmap")
             .build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    g.start()
    try:
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            if any("stuckmap" in w for w in g._watchdog.fired) \
                    and g.last_postmortem is not None:
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"watchdog never flagged the stuck "
                                 f"worker: {g._watchdog.fired}")
    finally:
        release.set()
    wait_end_bounded(g)
    dumps = [p for p in os.listdir(tmp_path) if "stall" in p]
    assert dumps, os.listdir(tmp_path)
    doc = json.load(open(tmp_path / dumps[0]))
    assert not validate_chrome_trace(doc) and "stalledWorker" in doc
    stuck = [name for name, frames in doc["stacks"].items()
             if "stuck_map_functor" in "".join(frames)]
    assert any("stuckmap" in name for name in stuck), doc["stacks"].keys()


def test_watchdog_quiet_on_healthy_idle_graph(tmp_path):
    def slow_src(shipper):
        for i in range(3):
            time.sleep(0.45)  # slower than stall_sec
            shipper.push(TupleT(key=0, value=i))

    acc = GlobalSum()
    g = _pg("frec_idle_t", stall_sec=0.3,
            log_dir=str(tmp_path)).with_flight_recorder()
    g.add_source(wt.Source_Builder(slow_src).build()) \
        .add(wt.Map_Builder(lambda t: t).build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    run_bounded(g)
    assert acc.count == 3
    fired = g._watchdog.fired
    assert not [w for w in fired if "map" in w or "sink" in w], fired


def test_crash_dump_and_stats_on_raising_functor(tmp_path):
    def bad_map(t):
        if t.value == 3:
            raise ValueError("injected functor failure")
        return t

    acc = GlobalSum()
    g = _pg("frec_crash_t", log_dir=str(tmp_path)).with_flight_recorder()
    g.add_source(wt.Source_Builder(make_ingress_source(1, 8)).build()) \
        .add(wt.Map_Builder(bad_map).with_name("badmap").build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    with pytest.raises(ValueError, match="injected functor failure"):
        run_bounded(g)
    st = g.get_stats()
    assert any("badmap" in w for w in st["Worker_errors"])
    assert "ValueError" in next(iter(st["Worker_errors"].values()))
    rep = next(op for op in st["Operators"]
               if op["name"] == "badmap")["replicas"][0]
    assert rep["Worker_crashes"] == 1
    assert "injected functor failure" in rep["Worker_last_error"]
    assert "Traceback" in rep["Worker_last_error"]
    assert g.last_postmortem and os.path.exists(g.last_postmortem)
    doc = json.load(open(g.last_postmortem))
    assert not validate_chrome_trace(doc)
    assert "badmap" in doc["crashedWorker"]
    assert "injected functor failure" in doc["exception"]
    assert "crash" in {e["name"] for e in _spans(doc)} and doc["stacks"]


def test_crash_stats_recorded_without_recorder():
    def bad_map(t):
        raise RuntimeError("boom")

    acc = GlobalSum()
    g = _pg("frec_crash2_t")
    g.add_source(wt.Source_Builder(make_ingress_source(1, 4)).build()) \
        .add(wt.Map_Builder(bad_map).with_name("badmap2").build()) \
        .add_sink(wt.Sink_Builder(make_sum_sink(acc)).build())
    with pytest.raises(RuntimeError):
        run_bounded(g)
    st = g.get_stats()
    assert any("badmap2" in w for w in st["Worker_errors"])
    rep = next(op for op in st["Operators"]
               if op["name"] == "badmap2")["replicas"][0]
    assert rep["Worker_crashes"] == 1 and "boom" in rep["Worker_last_error"]
    assert g.last_postmortem is None  # no ring, no automatic dump
