"""The port's latency-tracing plane against the JAX package's: twins of
``test_latency_tracing.py``.

The histograms are the same buckets, so the same samples give equal
bucket counts and equal merged percentiles in both packages; the
sampling rate parses the same; the same graphs sample the same number
of tuples end to end (per-tuple host plane, batched host plane, the
device staging plane); the queue gauges, EWMA seeding, the dashboard's
reconnect and the Prometheus text match too. Graph runs are bounded
(``torch_waits``)."""

import random
import socket
import time

import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from windflow_tpu.monitoring import histogram as hj
from windflow_tpu.monitoring.monitor import prometheus_text as prom_j
from windflow_tpu.monitoring.stats import StatsRecord as StatsJ
from windflow_tpu.monitoring.tracing import parse_sample_rate as parse_j
from windflow_tpu_torch.monitoring import histogram as ht
from windflow_tpu_torch.monitoring.monitor import (MonitoringServer,
                                                   MonitoringThread)
from windflow_tpu_torch.monitoring.monitor import prometheus_text as prom_t
from windflow_tpu_torch.monitoring.stats import StatsRecord as StatsT
from windflow_tpu_torch.monitoring.tracing import parse_sample_rate
from torch_waits import join_bounded, run_bounded


def _sample_sets():
    rng = random.Random(42)
    yield "uniform", [rng.randint(0, 1_000_000) for _ in range(5000)]
    yield "exponential", [int(rng.expovariate(1 / 500.0))
                          for _ in range(5000)]
    yield "constant", [777] * 1000
    yield "tiny", [0, 1, 2, 3]
    yield "wide", [rng.choice([1, 100, 10_000, 1_000_000, 10**8])
                   for _ in range(2000)]


def test_histogram_buckets_and_percentiles_equal_jax():
    """Same samples: equal bucket counts, count, sum, max and percentiles
    (``record`` and the vectorized ``record_many``)."""
    import numpy as np
    for name, samples in _sample_sets():
        t, j, tv = ht.LatencyHistogram(), hj.LatencyHistogram(), \
            ht.LatencyHistogram()
        for v in samples:
            t.record(float(v))
            j.record(float(v))
        tv.record_many(np.asarray(samples))
        assert t.counts == j.counts == tv.counts, name
        assert (t.count, t.max_us) == (j.count, j.max_us)
        assert t.sum_us == pytest.approx(j.sum_us)
        for q in (0.5, 0.9, 0.99, 1.0):
            assert t.percentile(q) == j.percentile(q), (name, q)
        assert t.cumulative_buckets() == j.cumulative_buckets()
    assert ht.N_BUCKETS == hj.N_BUCKETS
    assert [ht.bucket_bounds(i) for i in range(ht.N_BUCKETS)] \
        == [hj.bucket_bounds(i) for i in range(hj.N_BUCKETS)]


def test_histogram_merge_equals_jax():
    rng = random.Random(7)
    samples = [int(rng.expovariate(1 / 2000.0)) for _ in range(4000)]
    parts_t = [ht.LatencyHistogram() for _ in range(4)]
    parts_j = [hj.LatencyHistogram() for _ in range(4)]
    whole = ht.LatencyHistogram()
    for i, s in enumerate(samples):
        parts_t[i % 4].record(s)
        parts_j[i % 4].record(s)
        whole.record(s)
    mt = ht.LatencyHistogram.merged(parts_t)
    mj = hj.LatencyHistogram.merged(parts_j)
    assert mt.counts == mj.counts == whole.counts
    for q in (0.5, 0.9, 0.99):
        assert mt.percentile(q) == mj.percentile(q) == whole.percentile(q)


def test_histogram_sparse_roundtrip_across_packages():
    """The port's wire form reads back in the JAX package and the other
    way round."""
    t = ht.LatencyHistogram()
    for v in (3, 50, 50, 123456, 10**7):
        t.record(v)
    j = hj.LatencyHistogram.from_sparse(t.to_sparse())
    back = ht.LatencyHistogram.from_sparse(j.to_sparse())
    assert j.counts == t.counts == back.counts
    assert (j.count, j.max_us) == (t.count, t.max_us)


def test_parse_sample_rate_matches_jax():
    for v in (1, "1", "1/64", 0.01, 0, "", None, "garbage", "1/0", 0.5,
              "3/100", 2, -1, "0.001"):
        assert parse_sample_rate(v) == parse_j(v), v
    assert parse_sample_rate("1/64") == 64
    assert parse_sample_rate(0.01) == 128


def _stats(g, idx=-1):
    return g.get_stats()["Operators"][idx]["replicas"][0]


def _run_cpu(pkg, name, batch, n=3000):
    seen = [0]

    def src(shipper):
        for v in range(n):
            shipper.push({"v": v})

    kw = {"device": "cpu"} if pkg is wt else {}
    g = pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **kw)
    g.add_source(pkg.Source_Builder(src).with_latency_tracing(1)
                 .with_output_batch_size(batch).build()) \
        .add(pkg.Map_Builder(lambda t: {"v": t["v"] + 1})
             .with_latency_tracing(1).build()) \
        .add_sink(pkg.Sink_Builder(lambda t: seen.__setitem__(0, seen[0] + 1)
                                   if t else None)
                  .with_latency_tracing(1).build())
    run_bounded(g)
    assert seen[0] == n
    return g


@pytest.mark.parametrize("batch", [0, 4])
def test_e2e_latency_cpu_graph_matches_jax(batch):
    """Every tuple traced: per-tuple messages record one e2e sample each,
    batches of four record their min and max stamps; the sample counts
    equal the JAX package's and the percentiles are ordered."""
    gt = _run_cpu(wt, f"lat_cpu_t{batch}", batch)
    gj = _run_cpu(wj, f"lat_cpu_j{batch}", batch)
    st, sj = _stats(gt), _stats(gj)
    if batch == 0:
        assert st["Latency_e2e_samples"] == sj["Latency_e2e_samples"] \
            == 3000
    else:  # a batch's min and max stamps (one when they are equal)
        assert 0 < st["Latency_e2e_samples"] <= 2 * 3000 // 4 + 2
    assert 0 < st["Latency_e2e_p50_usec"] <= st["Latency_e2e_p99_usec"] \
        <= st["Latency_e2e_max_usec"]
    mt, mj = _stats(gt, 1), _stats(gj, 1)
    assert mt["Latency_service_samples"] > 0
    assert mt["Latency_service_samples"] == mj["Latency_service_samples"]
    assert mt["Latency_service_p99_usec"] >= mt["Latency_service_p50_usec"]


def test_e2e_sampling_interval_matches_jax():
    """1/8 at the source: exactly n/8 sink samples, in both packages."""
    def build(pkg, name):
        kw = {"device": "cpu"} if pkg is wt else {}
        g = pkg.PipeGraph(name, **kw)

        def src(shipper):
            for v in range(4000):
                shipper.push({"v": v})

        g.add_source(pkg.Source_Builder(src).with_latency_tracing("1/8")
                     .build()) \
            .add_sink(pkg.Sink_Builder(lambda t: None)
                      .with_latency_tracing(1).build())
        run_bounded(g)
        return _stats(g)["Latency_e2e_samples"]

    assert build(wt, "lat_8t") == build(wj, "lat_8j") == 4000 // 8


def test_graph_level_rate_and_tracing_off():
    """``PipeGraph(latency_sample=...)`` (the JAX package's
    WF_LATENCY_SAMPLE) samples every operator without a rate of its own;
    the default allocates no histogram and records nothing."""
    def build(name, **kw):
        g = wt.PipeGraph(name, device="cpu", **kw)

        def src(shipper):
            for v in range(512):
                shipper.push({"v": v})

        g.add_source(wt.Source_Builder(src).build()) \
            .add_sink(wt.Sink_Builder(lambda t: None).build())
        run_bounded(g)
        return g

    off = build("lat_off")
    sink = _stats(off)
    assert sink["Latency_sample_every"] == 0
    assert sink["Latency_e2e_samples"] == 0
    assert "Latency_e2e_hist" not in sink
    assert all(r.stats.hist_e2e is None and r.stats.hist_service is None
               for op in off._ops for r in op.replicas)
    on = build("lat_on", latency_sample="1/16")
    assert _stats(on)["Latency_e2e_samples"] == 512 // 16
    assert _stats(on)["Latency_sample_every"] == 16


def test_e2e_latency_device_plane_matches_jax():
    """Source -> Map (device) -> Sink: the stamps survive staging
    (``BatchGPU.trace_min/max``) and the row exit, as in the JAX
    package, and the device operator records prep and commit samples."""
    from windflow_tpu.tpu import Map_TPU_Builder

    from common import GlobalSum, make_ingress_source, make_sum_sink

    def build(pkg, name):
        acc = GlobalSum()
        kw = {"device": "cpu"} if pkg is wt else {}
        mb = wt.Map_GPU_Builder if pkg is wt else Map_TPU_Builder
        g = pkg.PipeGraph(name, **kw)
        g.add_source(pkg.Source_Builder(make_ingress_source(4, 64))
                     .with_output_batch_size(16)
                     .with_latency_tracing(1).build()) \
            .add(mb(lambda f: {**f, "value": f["value"] * 2})
                 .with_latency_tracing(1).build()) \
            .add_sink(pkg.Sink_Builder(make_sum_sink(acc))
                      .with_latency_tracing(1).build())
        run_bounded(g)
        assert acc.count == 4 * 64
        return g, acc.value

    gt, vt = build(wt, "lat_dev_t")
    gj, vj = build(wj, "lat_dev_j")
    assert vt == vj
    st = _stats(gt)
    assert st["Latency_e2e_samples"] > 0 and st["Latency_e2e_p99_usec"] > 0
    dev = _stats(gt, 1)
    assert dev["Latency_prep_samples"] == dev["Dispatch_batches"] > 0
    assert dev["Latency_commit_samples"] > 0
    assert _stats(gj, 1)["Latency_prep_samples"] > 0


def test_queue_gauges_slow_sink_backpressure_match_jax():
    def build(pkg, name):
        kw = {"device": "cpu"} if pkg is wt else {}
        g = pkg.PipeGraph(name, channel_capacity=8, **kw)

        def src(shipper):
            for v in range(600):
                shipper.push({"v": v})

        def slow(t):
            if t is not None:
                time.sleep(0.0002)

        g.add_source(pkg.Source_Builder(src).build()) \
            .add_sink(pkg.Sink_Builder(slow).build())
        run_bounded(g)
        return _stats(g)

    for sink in (build(wt, "bp_t"), build(wj, "bp_j")):
        assert sink["Queue_capacity"] == 8
        assert sink["Queue_depth_max"] >= 8
        assert sink["Queue_puts_blocked"] > 0
        assert sink["Queue_blocked_put_usec"] > 0
        assert sink["Queue_len"] == 0


def test_ewma_seeding_matches_jax():
    for series in ((0.0, 100.0), (40.0, 60.0), (5.0, 0.0, 9.0)):
        t, j = StatsT("op", 0), StatsJ("op", 0)
        for v in series:
            t.note_host_prep(v)
            j.note_host_prep(v)
            t.note_dispatch_commit(v / 2)
            j.note_dispatch_commit(v / 2)
        assert t.dispatch_host_prep_us == pytest.approx(
            j.dispatch_host_prep_us)
        assert t.dispatch_commit_us == pytest.approx(j.dispatch_commit_us)
    st = StatsT("op", 0)
    st.note_host_prep(0.0)
    st.note_host_prep(100.0)
    assert st.dispatch_host_prep_us == pytest.approx(10.0)


class _FakeGraph:
    name = "fake_graph_t"

    def to_dot(self):
        return "digraph g {}"

    def to_svg(self):
        return ""

    def get_stats(self):
        return {"PipeGraph_name": self.name, "Operators": [],
                "Dropped_tuples": 0, "Threads": 0, "Mode": "DEFAULT",
                "Time_policy": "INGRESS_TIME"}


def test_monitoring_thread_reconnects_to_late_dashboard():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    mt = MonitoringThread(_FakeGraph(), "127.0.0.1", port, period_sec=0.1)
    mt.start()
    time.sleep(0.8)  # at least one connect fails (no dashboard yet)
    srv = MonitoringServer("127.0.0.1", port)
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline \
                and "fake_graph_t" not in srv.snapshot()["reports"]:
            time.sleep(0.05)
        snap = srv.snapshot()
        assert "fake_graph_t" in snap["reports"]
        assert "fake_graph_t" in snap["diagrams"]
        assert mt.connects >= 1
    finally:
        mt.stop()
        join_bounded(mt, 5.0)
        srv.close()


def test_prometheus_text_equals_jax():
    """The same snapshot renders the same Prometheus text in both
    packages, hostile label values escaped."""
    import re
    hist = ht.LatencyHistogram()
    for v in (10, 100, 1000):
        hist.record(v)
    snap = {"n_reports": 3, "reports": {
        'evil"graph\nname\\': {
            "Dropped_tuples": 2,
            "Operators": [{
                "name": 'op"1',
                "replicas": [{
                    "Replica_id": 0, "Inputs_received": 5,
                    "Outputs_sent": 4, "Queue_len": 1,
                    "Latency_e2e_hist": hist.to_sparse(),
                }],
            }],
        }}}
    text = prom_t(snap)
    assert text == prom_j(snap)
    for line in text.splitlines():
        if line.startswith("#") or not line:
            continue
        assert re.match(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})?\s+\S+$', line)
    m = re.search(r'windflow_e2e_latency_usec_bucket\{.*le="\+Inf"\} (\d+)',
                  text)
    assert m and int(m.group(1)) == 3


@pytest.mark.parametrize("kind", ["keyed", "ffat"])
def test_lateness_histogram_matches_jax(kind):
    """Late tuples behind the watermark feed the lateness histogram
    (``note_late``'s third argument) of the host window engines: the
    bucket counts equal the JAX package's on the same stream."""
    def build(pkg, name):
        kw = {"device": "cpu"} if pkg is wt else {}
        g = pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT_TIME, **kw)

        def src(shipper):
            for i in range(400):
                ts = i * 100
                shipper.push_with_timestamp({"k": i % 4, "v": 1}, ts)
                shipper.set_next_watermark(ts)
                if i % 50 == 49:  # a straggler 350-1,250 us behind
                    late = ts - 350 - (i % 7) * 150
                    shipper.push_with_timestamp({"k": i % 4, "v": 1}, late)

        if kind == "keyed":
            op = (pkg.Keyed_Windows_Builder(lambda ws: len(ws))
                  .with_key_by(lambda t: t["k"])
                  .with_tb_windows(2_000, 2_000).with_lateness(1_000))
        else:
            op = (pkg.Ffat_Windows_Builder(lambda t: t["v"],
                                           lambda a, b: a + b)
                  .with_key_by(lambda t: t["k"])
                  .with_tb_windows(2_000, 1_000).with_lateness(500))
        g.add_source(pkg.Source_Builder(src).build()) \
            .add(op.with_latency_tracing(1).build()) \
            .add_sink(pkg.Sink_Builder(lambda r: None).build())
        run_bounded(g)
        return _stats(g, 1)

    st, sj = build(wt, f"late_{kind}_t"), build(wj, f"late_{kind}_j")
    assert st["Latency_lateness_samples"] > 0
    for k in ("Late_records", "Late_dropped", "Latency_lateness_samples",
              "Latency_lateness_p50_usec", "Latency_lateness_max_usec"):
        assert st[k] == sj[k], k
    assert st["Latency_lateness_hist"] == sj["Latency_lateness_hist"]
