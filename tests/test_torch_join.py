"""The port's Interval_Join against the JAX package's.

Twins of ``test_join.py`` (KP and DP modes, DEFAULT and DETERMINISTIC,
the refusals) and of ``test_event_time_health.py::
test_interval_join_counts_admitted_late``: two event-time streams, merged
and joined on key within ``[-lower, +upper]``, run through both packages
on the CPU with the same seeded parallelisms (a numpy generator). The
joined pairs must equal the JAX package's and the host model exactly,
with no duplicate; refusals carry the JAX messages."""

import threading

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from common import TupleT
from torch_waits import run_bounded

N_KEYS = 4
LEN_A, LEN_B = 50, 60
STEP_A, STEP_B = 100, 83
LOWER, UPPER = 120, 200


def _pg(pkg, name, mode="DEFAULT"):
    kw = {"device": "cpu"} if pkg is wt else {}
    return pkg.PipeGraph(name, getattr(pkg.ExecutionMode, mode),
                         pkg.TimePolicy.EVENT_TIME, **kw)


def src_a(shipper, ctx):
    for i in range(LEN_A):
        ts = i * STEP_A
        for k in range(ctx.get_replica_index(), N_KEYS,
                       ctx.get_parallelism()):
            shipper.push_with_timestamp(TupleT(k, 1000 + i, ts), ts)
        shipper.set_next_watermark(ts)


def src_b(shipper, ctx):
    for i in range(LEN_B):
        ts = i * STEP_B
        for k in range(ctx.get_replica_index(), N_KEYS,
                       ctx.get_parallelism()):
            shipper.push_with_timestamp(TupleT(k, 2000 + i, ts), ts)
        shipper.set_next_watermark(ts)


def model_pairs():
    """Every (key, a_value, b_value) with ts_b in [ts_a-LOWER, ts_a+UPPER]."""
    return {(k, 1000 + i, 2000 + j)
            for k in range(N_KEYS) for i in range(LEN_A)
            for j in range(LEN_B)
            if i * STEP_A - LOWER <= j * STEP_B <= i * STEP_A + UPPER}


class PairCollector:
    def __init__(self):
        self._lock = threading.Lock()
        self.pairs = []

    def sink(self, r):
        if r is not None:
            with self._lock:
                self.pairs.append(r)


def run_join(pkg, mode, kp, degrees, obs=(0, 0)):
    pa, pb, pj = degrees
    coll = PairCollector()
    g = _pg(pkg, "join", mode)
    a = (pkg.Source_Builder(src_a).with_parallelism(pa)
         .with_output_batch_size(obs[0]).build())
    b = (pkg.Source_Builder(src_b).with_parallelism(pb)
         .with_output_batch_size(obs[1]).build())
    jb = (pkg.Interval_Join_Builder(lambda x, y: (x.key, x.value, y.value))
          .with_key_by(lambda t: t.key).with_boundaries(LOWER, UPPER)
          .with_parallelism(pj))
    jb = jb.with_kp_mode() if kp else jb.with_dp_mode()
    g.add_source(a).merge(g.add_source(b)).add(jb.build()) \
        .add_sink(pkg.Sink_Builder(coll.sink).build())
    run_bounded(g)
    return coll.pairs


def _check_runs(mode, kp, seed):
    expected = model_pairs()
    degrees = np.random.default_rng(seed).integers(1, 5, (3, 3))
    for r, deg in enumerate(degrees):
        deg = [int(d) for d in deg]
        got = run_join(wt, mode, kp, deg)
        ref = run_join(wj, mode, kp, deg)
        assert len(got) == len(set(got)), f"run {r}: duplicate pairs"
        assert set(got) == set(ref) == expected, (
            f"run {r} {deg}: {len(set(got))} vs {len(expected)}")


@pytest.mark.parametrize("mode", ["DEFAULT", "DETERMINISTIC"])
def test_interval_join_kp(mode):
    _check_runs(mode, True, 3)


@pytest.mark.parametrize("mode", ["DEFAULT", "DETERMINISTIC"])
def test_interval_join_dp(mode):
    _check_runs(mode, False, 5)


@pytest.mark.parametrize("kp", [True, False], ids=["kp", "dp"])
def test_interval_join_deterministic_order_matches_jax(kp):
    """DETERMINISTIC mode, three replicas per stream into one join replica:
    the port's pairs come out in the same order run after run, and in the
    JAX package's order per key. Equal timestamps of different keys may
    swap in the JAX package when a channel's EOS lands early (its
    ordering collector visits open channels first), so the cross-key
    order is held only between the port's own runs."""
    got = run_join(wt, "DETERMINISTIC", kp, (3, 3, 1))
    ref = run_join(wj, "DETERMINISTIC", kp, (3, 3, 1))
    again = run_join(wt, "DETERMINISTIC", kp, (3, 3, 1))
    assert set(got) == model_pairs() and len(got) == len(set(got))
    assert got == again
    assert sorted(got) == sorted(ref)
    for k in range(N_KEYS):
        assert [p for p in got if p[0] == k] == [p for p in ref if p[0] == k]


def _refusal(pkg, build):
    with pytest.raises(pkg.WindFlowError) as ei:
        build(pkg)
    return str(ei.value)


def test_join_requires_two_pipes():
    def build(pkg):
        g = _pg(pkg, "join_bad")
        join = (pkg.Interval_Join_Builder(lambda x, y: None)
                .with_key_by(lambda t: t.key).with_boundaries(0, 0).build())
        g.add_source(pkg.Source_Builder(src_a).build()).add(join)
    msg = _refusal(wt, build)
    assert msg == _refusal(wj, build)
    assert "merging exactly two" in msg


def test_join_asymmetric_bounds():
    """lower=0: only B tuples at or after the A tuple match."""
    def sa(sh, ctx):
        sh.push_with_timestamp(TupleT(0, 1, 1000), 1000)
        sh.set_next_watermark(1000)

    def sb(sh, ctx):
        for ts, v in [(900, 10), (1000, 11), (1100, 12), (1300, 13)]:
            sh.push_with_timestamp(TupleT(0, v, ts), ts)
            sh.set_next_watermark(ts)

    out = {}
    for pkg in (wt, wj):
        coll = PairCollector()
        g = _pg(pkg, "join_asym")
        join = (pkg.Interval_Join_Builder(lambda x, y: (x.value, y.value))
                .with_key_by(lambda t: t.key).with_boundaries(0, 200)
                .build())
        g.add_source(pkg.Source_Builder(sa).build()) \
            .merge(g.add_source(pkg.Source_Builder(sb).build())) \
            .add(join).add_sink(pkg.Sink_Builder(coll.sink).build())
        run_bounded(g)
        out[pkg] = set(coll.pairs)
    assert out[wt] == out[wj] == {(1, 11), (1, 12)}


def test_interval_join_dp_batched_inputs():
    """Batched producers into a DP join: the DP collector flattens the
    batches, so the per-row ts order (the purge frontier) holds."""
    got = run_join(wt, "DEFAULT", False, (2, 2, 3), obs=(50, 37))
    ref = run_join(wj, "DEFAULT", False, (2, 2, 3), obs=(50, 37))
    assert len(got) == len(set(got))
    assert set(got) == set(ref) == model_pairs()


def test_interval_join_dp_rejected_in_probabilistic():
    def build(pkg):
        g = _pg(pkg, "join_dp_prob", "PROBABILISTIC")
        join = (pkg.Interval_Join_Builder(lambda x, y: None)
                .with_key_by(lambda t: t.key).with_boundaries(0, 0)
                .with_dp_mode().build())
        g.add_source(pkg.Source_Builder(src_a).build()) \
            .merge(g.add_source(pkg.Source_Builder(src_b).build())) \
            .add(join).add_sink(pkg.Sink_Builder(lambda t: None).build())
        run_bounded(g)
    msg = _refusal(wt, build)
    assert msg == _refusal(wj, build)
    assert "PROBABILISTIC" in msg


def test_interval_join_builder_refusals_match_jax():
    def msgs(pkg):
        out = []
        for fn in (lambda: pkg.Interval_Join_Builder(lambda a, b: None)
                   .with_boundaries(0, 1).build(),
                   lambda: pkg.Interval_Join_Builder(lambda a, b: None)
                   .with_key_by(lambda t: t.key).build()):
            with pytest.raises(pkg.WindFlowError) as ei:
                fn()
            out.append(str(ei.value))
        return out
    assert msgs(wt) == msgs(wj)


def _late_counters(g, name):
    op = next(o for o in g.get_stats()["Operators"] if o["name"] == name)
    return {k: sum(r.get(k, 0) for r in op["replicas"])
            for k in ("Inputs_received", "Late_records", "Late_dropped",
                      "Late_admitted")}


def test_interval_join_counts_admitted_late():
    """The join never drops: late probes are admitted-late only, in both
    packages."""
    n_straggler = 50
    a_done = threading.Event()

    def sa(shipper, ctx):
        # high timestamps and a watermark at the first of them: side A is
        # never late and never holds the join's watermark below side B's
        shipper.set_next_watermark(10_000_000)
        for i in range(20):
            shipper.push_with_timestamp({"key": 0, "value": i},
                                        10_000_000 + i)
        a_done.set()

    def sb(shipper, ctx):
        ts = 0
        for i in range(200):
            ts += 100
            shipper.push_with_timestamp({"key": 0, "value": i}, ts)
            if i % 10 == 9:
                shipper.set_next_watermark(ts)
        # stragglers ride their own stream's watermark (20_000): late by
        # construction once side A's tuples are ahead of them in the
        # join's channel (before that the join's watermark is side A's 0)
        assert a_done.wait(30.0)
        for j in range(n_straggler):
            shipper.push_with_timestamp({"key": 0, "value": -j},
                                        ts - 19_000 + j)

    counts = {}
    for pkg in (wt, wj):
        a_done.clear()
        g = _pg(pkg, "evt_health_join")
        op = (pkg.Interval_Join_Builder(lambda a, b: (a["value"],
                                                      b["value"]))
              .with_key_by(lambda t: t["key"])
              .with_boundaries(-500, 500).with_name("join").build())
        g.add_source(pkg.Source_Builder(sa).build()) \
            .merge(g.add_source(pkg.Source_Builder(sb).build())) \
            .add(op).add_sink(pkg.Sink_Builder(lambda t: None).build())
        run_bounded(g)
        counts[pkg] = _late_counters(g, "join")
    st = counts[wt]
    assert st["Late_records"] >= n_straggler
    assert st["Late_dropped"] == 0
    assert st["Late_admitted"] == st["Late_records"]
    assert st["Inputs_received"] == counts[wj]["Inputs_received"] \
        == 20 + 200 + n_straggler
    assert counts[wj]["Late_dropped"] == 0
