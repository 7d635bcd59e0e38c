"""The port's overload plane and prewarm against the JAX package's: twins
of ``test_overload.py`` and of ``test_megabatch.py``'s prewarm case.

The units (token bucket, admission gates and their shed policies, the
governor's ladder logic, the actuator's shed re-engage and scale
ranking, the autoscaler and watchdog interlocks, the tune rung) run the
same scenario through both packages and compare. The sustained-overload
soak is timing-driven (its shed counts differ from run to run in either
package), so the port's run is held to the exact model instead: offered
== admitted + shed, one shed-log line per shed, and exactly-once output
over the admitted set equal to a replay of just those records. The
prewarm cases compare the report with the JAX package's where both warm
the same things. The JAX package's ``WF_SHED_DIR`` is
``GovernorPolicy(shed_dir=...)`` here."""

from __future__ import annotations

import json
import os
import threading
import time
import types

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from windflow_tpu.monitoring.stats import StatsRecord as StatsJ
from windflow_tpu.overload import admission as adm_j
from windflow_tpu.overload import governor as gov_j
from windflow_tpu.scaling.autoscaler import AutoscalePolicy as AutoJ
from windflow_tpu_torch.monitoring.stats import StatsRecord as StatsT
from windflow_tpu_torch.overload import admission as adm_t
from windflow_tpu_torch.overload import governor as gov_t
from windflow_tpu_torch.scaling.autoscaler import AutoscalePolicy as AutoT
from torch_waits import run_bounded, wait_end_bounded

PKGS = {"t": (adm_t, gov_t, StatsT), "j": (adm_j, gov_j, StatsJ)}


# ---------------------------------------------------------------------------
# token bucket
# ---------------------------------------------------------------------------
def test_token_bucket_refill_and_burst():
    for adm in (adm_t, adm_j):
        tb = adm.TokenBucket(1000.0, burst=10.0)
        granted = sum(tb.try_take() for _ in range(50))
        assert granted <= 11
        time.sleep(0.05)
        assert tb.try_take()
        assert tb.take_up_to(1000) <= 60


def test_token_bucket_rate_update():
    for adm in (adm_t, adm_j):
        tb = adm.TokenBucket(10.0)
        tb.set_rate(1e6)
        time.sleep(0.01)
        assert tb.take_up_to(10_000) > 100
        assert adm.TokenBucket(500.0).burst == 25.0


def test_parse_shed_policy_refuses_loudly():
    for adm, pkg in ((adm_t, wt), (adm_j, wj)):
        assert adm.parse_shed_policy("drop_oldest") == "drop_oldest"
        assert adm.SHED_POLICIES == adm_j.SHED_POLICIES
        with pytest.raises(pkg.WindFlowError, match="unknown shed policy"):
            adm.parse_shed_policy("drop_sometimes")


# ---------------------------------------------------------------------------
# admission gate policies, the same scenario in both packages
# ---------------------------------------------------------------------------
def _fake_replica(stats_cls):
    return types.SimpleNamespace(op=types.SimpleNamespace(name="src"),
                                 idx=0, stats=stats_cls("src", 0))


def _drained_gate(key, policy, priority_fn=None, shed_log=None,
                  buffer_cap=4):
    adm, _, stats_cls = PKGS[key]
    gate = adm.AdmissionGate(_fake_replica(stats_cls), policy, 0.0,
                             priority_fn=priority_fn, shed_log=shed_log,
                             buffer_cap=buffer_cap)
    gate.bucket.rate = gate.bucket.burst = gate.bucket._tokens = 0.0
    return gate


def _both_gates(policy, **kw):
    return [_drained_gate(k, policy, **kw) for k in ("t", "j")]


def test_gate_drop_newest_sheds_incoming():
    outs = []
    for gate in _both_gates("drop_newest"):
        out = [gate.offer({"v": v}, v) for v in range(5)]
        st = gate.replica.stats
        outs.append((out, st.shed_records, st.shed_bytes, gate.pending))
    assert outs[0] == outs[1] and outs[0][1] == 5 and outs[0][2] > 0


def test_gate_drop_oldest_evicts_buffer_head():
    res = []
    for gate in _both_gates("drop_oldest", buffer_cap=3):
        for v in range(5):
            assert gate.offer({"v": v}, v) == []
        res.append(([p["v"] for p, _, _ in gate._pending],
                    gate.replica.stats.shed_records))
    assert res[0] == res[1] == ([2, 3, 4], 2)


def test_gate_key_priority_evicts_lowest_priority():
    res = []
    for gate in _both_gates("key_priority",
                            priority_fn=lambda p: p["prio"], buffer_cap=3):
        for i, pr in enumerate([5, 1, 9, 3, 7]):
            gate.offer({"v": i, "prio": pr}, i)
        res.append(([p["prio"] for p, _, _ in gate._pending],
                    gate.replica.stats.shed_records))
    assert res[0] == res[1] == ([5, 9, 7], 2)


def test_gate_key_priority_requires_priority_fn():
    for key, pkg in (("t", wt), ("j", wj)):
        adm, _, stats_cls = PKGS[key]
        with pytest.raises(pkg.WindFlowError, match="with_priority"):
            adm.AdmissionGate(_fake_replica(stats_cls), "key_priority",
                              100.0)


def test_gate_probabilistic_sheds_fraction():
    for key in ("t", "j"):
        adm, _, stats_cls = PKGS[key]
        gate = adm.AdmissionGate(_fake_replica(stats_cls), "probabilistic",
                                 50.0)
        admitted = sum(len(gate.offer({"v": v}, v)) for v in range(3000))
        st = gate.replica.stats
        assert admitted + st.shed_records == 3000
        assert st.shed_records > 2000


def test_gate_buffered_admits_when_tokens_return():
    res = []
    for gate in _both_gates("drop_oldest", buffer_cap=8):
        for v in range(3):
            gate.offer({"v": v}, v)
        gate.bucket.set_rate(1e6, burst=1e6)
        gate.bucket._tokens = 1e6
        res.append([p["v"] for p, _, _ in gate.offer({"v": 3}, 3)])
    assert res[0] == res[1] == [0, 1, 2, 3]


def test_gate_release_is_pass_through():
    for gate in _both_gates("drop_oldest", buffer_cap=8):
        gate.offer({"v": 0}, 0)
        gate.released = True
        assert [p["v"] for p, _, _ in gate.offer({"v": 1}, 1)] == [0, 1]
        assert gate.pending == 0


def test_shed_log_jsonl(tmp_path):
    logs = []
    for key, d in (("t", tmp_path / "t"), ("j", tmp_path / "j")):
        adm = PKGS[key][0]
        log = adm.ShedLog("glog", dir=str(d))
        gate = _drained_gate(key, "drop_newest", shed_log=log)
        for v in range(7):
            gate.offer({"v": v}, v)
        assert log.total == 7
        lines = [json.loads(ln) for ln in open(d / "glog.shed.jsonl")]
        logs.append([{k: r[k] for k in ("operator", "replica", "payload",
                                        "ts", "reason")} for r in lines])
    assert logs[0] == logs[1] and len(logs[0]) == 7
    assert logs[0][0]["reason"] == "drop_newest"


def test_gate_columns_admits_prefix():
    res = []
    for key in ("t", "j"):
        adm, _, stats_cls = PKGS[key]
        gate = adm.AdmissionGate(_fake_replica(stats_cls), "drop_newest",
                                 1000.0)
        gate.bucket._tokens = 10.0
        c2, t2, n = gate.offer_columns({"v": np.arange(64)},
                                       np.arange(64, dtype=np.int64))
        res.append((n, list(t2), list(c2["v"]),
                    gate.replica.stats.shed_records))
    assert res[0] == res[1] and res[0][0] == 10 and res[0][3] == 54


# ---------------------------------------------------------------------------
# the gate inside the port's source replica
# ---------------------------------------------------------------------------
class _RecordingEmitter:
    def __init__(self):
        self.rows = []
        self.batches = []
        self.trace_ts = 0

    def emit(self, payload, ts, wm):
        self.rows.append((payload, ts, wm))

    def emit_columns(self, cols, ts_arr, wm, trace_rows=None):
        self.batches.append((cols, ts_arr, wm))


def _gated_source_replica(buffer_cap=8):
    from windflow_tpu_torch.operators.source import Source
    op = Source(lambda s: None, name="s")
    op.build_replicas()
    r = op.replicas[0]
    r.emitter = _RecordingEmitter()
    gate = adm_t.AdmissionGate(r, "drop_oldest", 0.0, buffer_cap=buffer_cap)
    gate.bucket.rate = gate.bucket.burst = gate.bucket._tokens = 0.0
    r._gate = gate
    return r, gate


def test_gate_buffered_admits_keep_accept_time_watermark():
    r, gate = _gated_source_replica()
    r.ship({"v": 0}, 0, 10)
    r.ship({"v": 1}, 1, 20)
    assert r.emitter.rows == [] and r.cur_wm == 0
    gate.bucket.set_rate(1e6, burst=1e6)
    gate.bucket._tokens = 1e6
    r.ship({"v": 2}, 2, 30)
    assert [(p["v"], w) for p, _, w in r.emitter.rows] == \
        [(0, 10), (1, 20), (2, 30)]
    assert r.cur_wm == 30


def test_gate_pending_rides_snapshot_and_reemits_on_restore():
    from windflow_tpu_torch.operators.source import Source
    r, gate = _gated_source_replica()
    for v in range(3):
        r.ship({"v": v}, v, 100 + v)
    st = r.snapshot_state()
    assert [p["v"] for p, _, _ in st["gate_pending"]] == [0, 1, 2]
    op2 = Source(lambda s: None, name="s")
    op2.build_replicas()
    r2 = op2.replicas[0]
    r2.emitter = _RecordingEmitter()
    r2.restore_state(st)
    r2.run_source()
    assert [(p["v"], t, w) for p, t, w in r2.emitter.rows] == \
        [(0, 0, 100), (1, 1, 101), (2, 2, 102)]
    assert r2.stats.inputs_received == st["shipped"] + 3


def test_ship_columns_drains_row_pending():
    r, gate = _gated_source_replica()
    r.ship({"v": 0}, 0, 5)
    gate.released = True
    r.ship_columns({"v": np.arange(4)}, np.arange(4, dtype=np.int64), 50)
    assert [(p["v"], w) for p, _, w in r.emitter.rows] == [(0, 5)]
    assert len(r.emitter.batches) == 1 and r.emitter.batches[0][2] == 50
    assert r._gate is None and r.stats.shed_records == 0
    assert r.stats.inputs_received == 5


# ---------------------------------------------------------------------------
# the ladder logic: the same observations, the same directives
# ---------------------------------------------------------------------------
def _policies(**kw):
    kw.setdefault("slo_p99_ms", 100.0)
    kw.setdefault("interval_s", 0.1)
    kw.setdefault("cooldown_s", 1.0)
    kw.setdefault("breach_hysteresis", 2)
    kw.setdefault("recover_hysteresis", 3)
    return gov_t.GovernorPolicy(**kw), gov_j.GovernorPolicy(**kw)


def _directives(pol, steps):
    out = []
    for obs in steps:
        if obs[0] == "act":
            pol.note_action(obs[1], obs[2])
            continue
        out.append(pol.observe(*obs))
    return out


def test_policy_requires_slo():
    with pytest.raises(wt.WindFlowError, match="positive SLO"):
        gov_t.GovernorPolicy(slo_p99_ms=0)
    with pytest.raises(wt.WindFlowError, match="positive SLO"):
        gov_t.GovernorPolicy()


def test_policy_breach_hysteresis_then_escalate():
    steps = [(200_000.0, 0.0, 10.0), (200_000.0, 0.0, 10.1),
             ("act", 10.1, gov_t.TUNE), (200_000.0, 0.0, 10.2),
             (200_000.0, 0.0, 10.3), (200_000.0, 0.0, 11.2)]
    t, j = (_directives(p, steps) for p in _policies())
    assert t == j == [None, "escalate", None, None, "escalate"]


def test_policy_band_holds_and_no_data_holds():
    steps = [(None, 0.0, 10.0), (90_000.0, 0.0, 10.1)]
    pt, pj = _policies()
    assert _directives(pt, steps) == _directives(pj, steps) == [None, None]
    assert pt._breach_streak == pt._ok_streak == 0


def test_policy_shed_rung_regulates_and_releases():
    steps = [("act", 10.0, gov_t.SHED), (95_000.0, 500.0, 10.1),
             (95_000.0, 500.0, 10.2), (10_000.0, 500.0, 10.3),
             (10_000.0, 0.0, 11.2), (10_000.0, 0.0, 11.3)]
    t, j = (_directives(p, steps) for p in _policies())
    assert t == j == ["shed_down", "shed_down", "shed_up", "shed_up",
                      "release"]


def test_policy_release_unwinds_one_rung_per_cooldown():
    steps = [("act", 10.0, gov_t.TUNE), (1_000.0, 0.0, 10.1),
             (1_000.0, 0.0, 10.2), (1_000.0, 0.0, 11.5)]
    t, j = (_directives(p, steps) for p in _policies())
    assert t == j == [None, None, "release"]


# ---------------------------------------------------------------------------
# the actuator
# ---------------------------------------------------------------------------
def _built_graph(name="govunit_t"):
    g = wt.PipeGraph(name, device="cpu")
    g.add_source(wt.Source_Builder(lambda s: None).with_name("s").build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).with_name("k").build())
    g._build()
    return g


def test_shed_reengage_seeds_prior_admit_rate():
    gov = gov_t.OverloadGovernor(_built_graph(),
                                 gov_t.GovernorPolicy(slo_p99_ms=10.0))
    gov.policy.rung = gov_t.SHED
    gov.admit_rate_tps, gov.admitted_tps = 500.0, 0.0
    gov._engage_shed()
    assert gov.admit_rate_tps == 500.0
    assert all(gt.bucket.rate > 0 for _, gt in gov._gates)
    gov2 = gov_t.OverloadGovernor(_built_graph("govunit_t2"),
                                  gov_t.GovernorPolicy(
                                      slo_p99_ms=10.0,
                                      shed_start_factor=0.9))
    gov2.admitted_tps = 1000.0
    gov2._engage_shed()
    assert gov2.admit_rate_tps == pytest.approx(900.0)


def test_try_scale_ranks_by_windowed_blocked_rate():
    calls = {"t": [], "j": []}
    for key, gov_mod in (("t", gov_t), ("j", gov_j)):
        graph = types.SimpleNamespace(
            name=f"winscale_{key}", _coordinator=object(), _autoscaler=None,
            _recorders=[], _stage_flightrec_events_max=lambda: 0,
            rescale=lambda name, new, _k=key: calls[_k].append((name, new)))
        gov = gov_mod.OverloadGovernor(graph, gov_mod.GovernorPolicy(
            slo_p99_ms=10.0, max_parallelism=8))
        gov._eligible_totals = lambda: {
            "cold": {"parallelism": 1, "blocked_put_usec": 9e9},
            "hot": {"parallelism": 1, "blocked_put_usec": 1e6}}
        gov._blocked_rates = {"cold": 0.0, "hot": 250_000.0}
        assert gov._try_scale()
    assert calls["t"] == calls["j"] == [("hot", 2)]


def test_autoscaler_no_scale_down_while_shedding():
    starved = {"op": {"parallelism": 4, "blocked_put_ms_per_s": 0.0,
                      "blocked_get_ms_per_s": 5000.0, "tuples_per_s": 1.0}}
    pressured = {"op": {"parallelism": 1, "blocked_put_ms_per_s": 900.0,
                        "blocked_get_ms_per_s": 0.0, "tuples_per_s": 1.0}}
    res = []
    for cls in (AutoT, AutoJ):
        kw = dict(interval_s=0.1, cooldown_s=0.0, hysteresis=1,
                  down_blocked_get_ms=100.0, max_parallelism=8)
        free = cls(**kw).observe(dict(starved), now=10.0)
        pol = cls(**kw)
        vetoed = pol.observe(dict(starved), now=10.0, shed_active=True)
        streak = dict(pol._down_streak)
        up = pol.observe(pressured, now=20.0, shed_active=True)
        res.append((free, vetoed, streak, up[:2] if up else None))
    assert res[0] == res[1]
    assert res[0][0][1] == 3 and res[0][1] is None and res[0][2] == {}
    assert res[0][3][1] > 1


def test_watchdog_stands_down_while_shedding():
    from windflow_tpu.monitoring.flightrec import StallWatchdog as WDJ
    from windflow_tpu_torch.monitoring.flightrec import StallWatchdog

    class _W:
        name = "w0"

        def is_alive(self):
            return True

        def progress_value(self):
            return 42  # frozen

    for cls in (StallWatchdog, WDJ):
        gov = types.SimpleNamespace(shedding=True)
        graph = types.SimpleNamespace(name="g", _workers=[_W()],
                                      _rescaling=False, _supervising=False,
                                      _overload_governor=gov)
        wd = cls(graph, stall_sec=0.01)
        wd._check(now=10.0)
        wd._check(now=20.0)
        assert wd.fired == []
        gov.shedding = False
        wd._check(now=30.0)
        wd._check(now=40.0)
        assert wd.fired == ["w0"]


def test_tune_rung_halves_and_restores_knobs():
    """Rung 1 halves the device dispatch depth and restores it on release;
    the staging emitter's batch (the prewarmed bucket) is left alone, as
    in the JAX package."""
    g = wt.PipeGraph("tune_t", device="cpu")
    g.add_source(wt.Source_Builder(lambda s: None).with_name("s")
                 .with_output_batch_size(16).build()) \
        .add(wt.Map_GPU_Builder(lambda f: f).with_schema({"v": np.int32})
             .with_name("m").build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).with_name("k").build())
    g._build()
    gov = gov_t.OverloadGovernor(g, gov_t.GovernorPolicy(slo_p99_ms=10.0))
    m = [op for op in g._ops if op.name == "m"][0]
    depth0 = m.replicas[0].dispatch.depth
    assert depth0 > 0 and gov._try_tune()
    assert m.replicas[0].dispatch.depth == depth0 // 2
    src_em = [op for op in g._ops if op.name == "s"][0].replicas[0].emitter
    assert src_em.output_batch_size == 16
    gov._restore_tuned()
    assert m.replicas[0].dispatch.depth == depth0


# ---------------------------------------------------------------------------
# builder / graph plumbing
# ---------------------------------------------------------------------------
def test_with_slo_and_priority_plumbing():
    for pkg in (wt, wj):
        op = (pkg.Source_Builder(lambda s: None).with_slo(25.0)
              .with_priority(lambda p: p["k"]).build())
        assert op.slo_p99_ms == 25.0 and op.priority_fn({"k": 9}) == 9
        with pytest.raises(pkg.WindFlowError):
            pkg.Source_Builder(lambda s: None).with_slo(0)
    with pytest.raises(wt.WindFlowError):
        wt.PipeGraph("g", device="cpu").with_slo(-1)


def test_key_priority_without_priority_fn_refuses_at_start():
    g = wt.PipeGraph("nopri_t", device="cpu")
    g.with_slo(50.0, wt.GovernorPolicy(slo_p99_ms=50.0,
                                       shed_policy="key_priority"))
    g.add_source(wt.Source_Builder(lambda s: None).with_name("s").build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    with pytest.raises(wt.WindFlowError, match="key_priority"):
        g.start()


def test_idle_governor_is_invisible():
    """A generous SLO: the governor never escalates, the results and the
    accounting are the ungoverned run's; sampling turned on at 1/16."""
    seen = []

    def src(shipper):
        for v in range(20_000):
            shipper.push({"v": v})

    g = wt.PipeGraph("idle_t", device="cpu").with_slo(60_000.0)
    g.add_source(wt.Source_Builder(src).with_name("s").build()) \
        .add(wt.Map_Builder(lambda t: {"v": t["v"] + 1}).with_name("m")
             .build()) \
        .add_sink(wt.Sink_Builder(lambda t: seen.append(t["v"]) if t
                                  else None).with_name("k").build())
    run_bounded(g)
    assert seen == list(range(1, 20_001))
    ov = g.get_stats()["Overload"]
    assert ov["Overload_state_name"] == "idle"
    assert ov["Overload_escalations"] == ov["Overload_shed_records"] == 0
    sink = g.get_stats()["Operators"][-1]["replicas"][0]
    assert sink["Latency_sample_every"] == 16
    assert sink["Latency_e2e_samples"] == 20_000 // 16


def test_sustained_overload_soak_exact_accounting(tmp_path):
    """Offered load far over capacity with no scale headroom: the ladder
    reaches SHED, and the accounting is exact — every offered record is
    admitted or shed, each shed is one shed-log line, and the
    exactly-once committed output equals a governor-less replay of the
    admitted records."""
    CAP = 128
    pushed = [0]
    started = threading.Event()

    def src(shipper):
        started.set()
        t0 = time.monotonic()
        i = 0
        while time.monotonic() - t0 < 5.0:
            shipper.push({"v": i})
            i += 1
            if i % 20 == 0:
                time.sleep(0.001)
        pushed[0] = i

    def work(t):
        time.sleep(0.0005)
        return {"v": t["v"] * 3}

    committed = []
    g = wt.PipeGraph("soak_t", device="cpu", channel_capacity=CAP)
    g.with_checkpointing(store_dir=str(tmp_path / "ckpt"), interval=1.0)
    g.with_slo(50.0, wt.GovernorPolicy(
        slo_p99_ms=50.0, interval_s=0.2, cooldown_s=0.4,
        breach_hysteresis=2, max_parallelism=1,
        shed_dir=str(tmp_path / "shed")))
    g.add_source(wt.Source_Builder(src).with_name("s").build()) \
        .add(wt.Map_Builder(work).with_name("hot").build()) \
        .add_sink(wt.Sink_Builder(lambda t: committed.append(t["v"])
                                  if t is not None else None)
                  .with_name("k")
                  .with_exactly_once(staging_dir=str(tmp_path / "txn"))
                  .build())
    g.start()
    wait_end_bounded(g)
    st = g.get_stats()
    ov = st["Overload"]
    src_rep = [r for o in st["Operators"] if o["name"] == "s"
               for r in o["replicas"]][0]
    admitted, shed = src_rep["Inputs_received"], src_rep["Shed_records"]
    assert ov["Overload_state_name"] == "shed" and shed > 0
    assert admitted + shed == pushed[0]
    lines = sum(1 for _ in open(tmp_path / "shed" / "soak_t.shed.jsonl"))
    assert lines == shed
    from windflow_tpu_torch.sinks import read_committed_records
    segs = [r["v"] for r, _ in read_committed_records(
        str(tmp_path / "txn" / "k_r0"))]
    assert segs == committed and len(segs) == admitted
    admitted_inputs = [v // 3 for v in committed]
    replay = []
    g2 = wt.PipeGraph("soak_replay_t", device="cpu", channel_capacity=CAP)
    g2.with_checkpointing(store_dir=str(tmp_path / "ckpt2"))
    g2.add_source(wt.Source_Builder(
        lambda sh: [sh.push({"v": v}) for v in admitted_inputs])
        .with_name("s").build()) \
        .add(wt.Map_Builder(lambda t: {"v": t["v"] * 3}).with_name("hot")
             .build()) \
        .add_sink(wt.Sink_Builder(lambda t: replay.append(t["v"])
                                  if t else None).with_name("k")
                  .with_exactly_once(staging_dir=str(tmp_path / "txn2"))
                  .build())
    run_bounded(g2)
    assert [r["v"] for r, _ in read_committed_records(
        str(tmp_path / "txn2" / "k_r0"))] == segs


# ---------------------------------------------------------------------------
# prewarm
# ---------------------------------------------------------------------------
def _ragged_columns_source(n_pushes=40, max_n=64, seed=3):
    def src(shipper):
        rng = np.random.default_rng(seed)
        for _ in range(n_pushes):
            n = int(rng.integers(1, max_n + 1))
            shipper.push_columns(
                {"key": rng.integers(0, 8, n).astype(np.int32),
                 "value": rng.integers(0, 100, n).astype(np.int32)})
    return src


def _prewarm_graph(pkg, name, fused):
    sch = {"key": np.int32, "value": np.int32}
    out = []
    if pkg is wt:
        mb, fb = wt.Map_GPU_Builder, wt.Filter_GPU_Builder
        kw = {"device": "cpu", "fusion": fused}
    else:
        from windflow_tpu.tpu import Filter_TPU_Builder as fb
        from windflow_tpu.tpu import Map_TPU_Builder as mb
        kw = {}
    g = pkg.PipeGraph(name, **kw).with_prewarm()
    mp = g.add_source(pkg.Source_Builder(_ragged_columns_source())
                      .with_name("s").with_output_batch_size(64).build())
    m = mb(lambda f: {**f, "value": f["value"] * 2}).with_schema(sch) \
        .with_name("m").build()
    f = fb(lambda f: f["value"] % 4 == 0).with_schema(sch) \
        .with_name("f").build()
    mp = mp.add(m)
    mp = mp.chain(f) if fused else mp.add(f)
    mp.add_sink(pkg.Sink_Builder(
        lambda t: out.append((t["key"], t["value"])) if t else None)
        .with_name("k").build())
    run_bounded(g)
    return g, sorted(out)


@pytest.mark.parametrize("fused", [False, True])
def test_prewarm_ragged_soak_matches_jax(fused, monkeypatch):
    """Ragged columnar pushes land in every power-of-two bucket: the
    prewarm runs each device program once per bucket before the stream
    (the same buckets and program count as the JAX package's compiles),
    and the rows equal the JAX run's."""
    monkeypatch.setenv("WF_TPU_FUSION", "1" if fused else "0")
    gt, rows_t = _prewarm_graph(wt, f"pw_t{int(fused)}", fused)
    gj, rows_j = _prewarm_graph(wj, f"pw_j{int(fused)}", fused)
    rt, rj = gt.prewarm_report, gj.prewarm_report
    assert rows_t == rows_j and rows_t
    assert rt["bucket_caps"] == rj["bucket_caps"] == [8, 16, 32, 64]
    assert rt["skipped"] == rj["skipped"] == []
    assert rt["signatures_compiled"] == len(rt["bucket_caps"]) * (
        1 if fused else 2)
    assert gt.get_stats()["Prewarm"] == rt


def test_prewarm_skips_inferred_schema_and_cpu_graphs():
    g = wt.PipeGraph("pwskip_t", device="cpu").with_prewarm()
    g.add_source(wt.Source_Builder(_ragged_columns_source(n_pushes=4))
                 .with_name("s").with_output_batch_size(16).build()) \
        .add(wt.Map_GPU_Builder(lambda f: f).with_name("m").build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    run_bounded(g)
    rep = g.prewarm_report
    assert rep["signatures_compiled"] == 0
    assert any("m" in s or "schema" in s for s in rep["skipped"])
    g2 = wt.PipeGraph("pwcpu_t", device="cpu").with_prewarm()
    g2.add_source(wt.Source_Builder(
        lambda s: [s.push({"v": i}) for i in range(10)])
        .with_name("s").build()) \
        .add_sink(wt.Sink_Builder(lambda t: None).build())
    run_bounded(g2)
    assert g2.prewarm_report["skipped"] == ["no device stages"]


def test_megabatch_prewarm_rows_match_jax(monkeypatch):
    """Twin of ``test_megabatch.py``'s prewarm case: a fused chain with
    megabatching on prewarms its whole-chain program per bucket, and the
    stream's rows equal the JAX package's megabatched run."""
    monkeypatch.setenv("WF_TPU_FUSION", "1")
    monkeypatch.setenv("WF_MEGABATCH", "4")
    sch = {"key": np.int32, "value": np.int32}

    def build(pkg, name):
        out = []
        if pkg is wt:
            mb = wt.Map_GPU_Builder
            kw = {"device": "cpu", "megabatch": 4}
        else:
            from windflow_tpu.tpu import Map_TPU_Builder as mb
            kw = {}
        g = pkg.PipeGraph(name, **kw).with_prewarm()
        g.add_source(pkg.Source_Builder(_ragged_columns_source(seed=9,
                                                               max_n=32))
                     .with_name("s").with_output_batch_size(32).build()) \
            .add(mb(lambda f: {**f, "value": f["value"] + 1})
                 .with_schema(sch).with_name("m1").build()) \
            .chain(mb(lambda f: {**f, "value": f["value"] * 3})
                   .with_schema(sch).with_name("m2").build()) \
            .add_sink(pkg.Sink_Builder(
                lambda t: out.append((t["key"], t["value"])) if t else None)
                .with_name("k").build())
        run_bounded(g)
        return g, sorted(out)

    gt, rt = build(wt, "pwmb_t")
    gj, rj = build(wj, "pwmb_j")
    assert rt == rj and rt
    rep = gt.prewarm_report
    assert rep["signatures_compiled"] == len(rep["bucket_caps"]) == 3
    assert any(o["kind"] == "Fused_GPU_Chain"
               for o in gt.get_stats()["Operators"])
