"""The port's host window operators against the JAX package's.

Twins of ``test_windows.py``, ``test_ffat.py`` and the two host cases of
``test_property_windows.py``: the same graph, built with each package's
builders from the same seeded parallelisms (a numpy generator), runs
through both packages on the CPU. Rows must equal the JAX package's and
the windowing model (``common.expected_windows``) exactly; in
DETERMINISTIC mode a single window replica's output must also come out in
the JAX package's order. Every graph run is bounded
(``torch_waits.run_bounded``)."""

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from common import TupleT, WinCollector, expected_windows
from torch_waits import run_bounded

N_KEYS = 5
STREAM_LEN = 60
TS_STEP = 137  # deliberately unaligned with window boundaries
WIN_US, SLIDE_US = 1000, 400
WIN_CB, SLIDE_CB = 13, 5
MODES = ["DEFAULT", "DETERMINISTIC"]


def _pg(pkg, name, mode="DEFAULT"):
    kw = {"device": "cpu"} if pkg is wt else {}
    return pkg.PipeGraph(name, getattr(pkg.ExecutionMode, mode),
                         pkg.TimePolicy.EVENT_TIME, **kw)


def _degrees(seed, n):
    """Parallelism degrees in 1..4 from a seeded numpy generator (the JAX
    suite draws them with ``random``; both packages get the same)."""
    return [int(d) for d in np.random.default_rng(seed).integers(1, 5, n)]


def keyed_event_source(n_keys=N_KEYS, stream_len=STREAM_LEN):
    """EVENT_TIME source, disjoint keys per replica, per-key ts i*TS_STEP."""

    def src(shipper, ctx):
        for i in range(stream_len):
            ts = i * TS_STEP
            for k in range(ctx.get_replica_index(), n_keys,
                           ctx.get_parallelism()):
                shipper.push_with_timestamp(TupleT(k, i + 1 + k, ts), ts)
            shipper.set_next_watermark(ts)

    return src


def model_seqs(n_keys=N_KEYS, stream_len=STREAM_LEN):
    return {k: [(i + 1 + k, i * TS_STEP) for i in range(stream_len)]
            for k in range(n_keys)}


def sum_ws(ws):
    return sum(w.value for w in ws)


class _OrderedCollector(WinCollector):
    """WinCollector that also keeps the arrival order of the rows."""

    def __init__(self):
        super().__init__()
        self.order = []

    def sink(self, r):
        super().sink(r)
        if r is not None:
            with self._lock:
                self.order.append((r.key, r.wid, r.value))


def _run(pkg, name, mode, op, src_par=1, sink_par=1, src=None):
    coll = _OrderedCollector()
    g = _pg(pkg, name, mode)
    g.add_source(pkg.Source_Builder(src or keyed_event_source())
                 .with_parallelism(src_par).build()) \
        .add(op).add_sink(pkg.Sink_Builder(coll.sink)
                          .with_parallelism(sink_par).build())
    run_bounded(g)
    return coll


def _both(name, mode, make_op, src_par=1, sink_par=1, src=None):
    """Run the graph in both packages; the port's collector, JAX's."""
    got = _run(wt, name, mode, make_op(wt), src_par, sink_par, src)
    ref = _run(wj, name, mode, make_op(wj), src_par, sink_par, src)
    assert got.dups == 0 and ref.dups == 0
    assert got.results == ref.results
    return got, ref


# ---------------------------------------------------------------------------
# Keyed_Windows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("incremental", [False, True])
def test_keyed_windows_tb(mode, incremental):
    expected = expected_windows(model_seqs(), WIN_US, SLIDE_US, False, sum)
    for run, (ps, pw, pk) in enumerate(np.reshape(_degrees(5, 9), (3, 3))):
        def make(pkg):
            b = pkg.Keyed_Windows_Builder(
                (lambda t, acc: acc + t.value) if incremental else sum_ws)
            b = b.with_key_by(lambda t: t.key).with_tb_windows(WIN_US,
                                                               SLIDE_US)
            if incremental:
                b = b.incremental(0)
            return b.with_parallelism(int(pw)).build()
        got, _ = _both(f"kw_tb{run}", mode, make, int(ps), int(pk))
        assert got.results == expected


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("win,slide", [(WIN_CB, SLIDE_CB), (6, 6), (4, 9)])
def test_keyed_windows_cb(mode, win, slide):
    """CB sliding, tumbling and hopping windows."""
    expected = expected_windows(model_seqs(), win, slide, True, sum)
    ps, pw = _degrees(11, 2)

    def make(pkg):
        return (pkg.Keyed_Windows_Builder(sum_ws)
                .with_key_by(lambda t: t.key).with_cb_windows(win, slide)
                .with_parallelism(pw).build())
    got, _ = _both("kw_cb", mode, make, ps)
    assert got.results == expected


# ---------------------------------------------------------------------------
# Parallel_Windows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_parallel_windows_tb(mode):
    expected = expected_windows(model_seqs(), WIN_US, SLIDE_US, False, sum)
    ps, pw = _degrees(17, 2)

    def make(pkg):
        return (pkg.Parallel_Windows_Builder(sum_ws)
                .with_key_by(lambda t: t.key)
                .with_tb_windows(WIN_US, SLIDE_US)
                .with_parallelism(pw).build())
    got, _ = _both("pw_tb", mode, make, ps)
    assert got.results == expected


def _refusal(pkg, make_op, name):
    g = _pg(pkg, name)
    g.add_source(pkg.Source_Builder(keyed_event_source(1, 2)).build()) \
        .add(make_op(pkg)) \
        .add_sink(pkg.Sink_Builder(lambda r: None).build())
    with pytest.raises(pkg.WindFlowError) as ei:
        run_bounded(g)
    return str(ei.value)


def test_parallel_windows_cb_deterministic():
    """CB Parallel_Windows run in DETERMINISTIC mode (one source: one
    per-key arrival order) and are refused in DEFAULT mode with the JAX
    message."""
    expected = expected_windows(model_seqs(), WIN_CB, SLIDE_CB, True, sum)

    def make(pkg):
        return (pkg.Parallel_Windows_Builder(sum_ws)
                .with_key_by(lambda t: t.key)
                .with_cb_windows(WIN_CB, SLIDE_CB)
                .with_parallelism(3).build())
    got, _ = _both("pw_cb", "DETERMINISTIC", make)
    assert got.results == expected

    def bad(pkg):
        return (pkg.Parallel_Windows_Builder(lambda ws: 0)
                .with_key_by(lambda t: t.key).with_cb_windows(4, 2)
                .with_parallelism(2).build())
    msg = _refusal(wt, bad, "pw_cb_bad")
    assert msg == _refusal(wj, bad, "pw_cb_bad")
    assert "DEFAULT mode" in msg


# ---------------------------------------------------------------------------
# Paned_Windows and MapReduce_Windows (two stages each)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("incremental", [False, True])
def test_paned_windows_tb(mode, incremental):
    expected = expected_windows(model_seqs(), WIN_US, SLIDE_US, False, sum)
    ps, p1, p2 = _degrees(23, 3)

    def make(pkg):
        if incremental:
            b = (pkg.Paned_Windows_Builder(lambda t, acc: acc + t.value,
                                           lambda v, acc: acc + v)
                 .incremental(0).incremental_stage2(0))
        else:
            b = pkg.Paned_Windows_Builder(sum_ws, lambda vals: sum(vals))
        return (b.with_key_by(lambda t: t.key)
                .with_tb_windows(WIN_US, SLIDE_US)
                .with_parallelism(p1, p2).build())
    got, _ = _both("paw_tb", mode, make, ps)
    assert got.results == expected


@pytest.mark.parametrize("mode", MODES)
def test_mapreduce_windows_tb(mode):
    expected = expected_windows(model_seqs(), WIN_US, SLIDE_US, False, sum)
    ps, p1, p2 = _degrees(31, 3)

    def make(pkg):
        return (pkg.MapReduce_Windows_Builder(sum_ws, lambda vals: sum(vals))
                .with_key_by(lambda t: t.key)
                .with_tb_windows(WIN_US, SLIDE_US)
                .with_parallelism(p1, p2).build())
    got, _ = _both("mrw_tb", mode, make, ps)
    assert got.results == expected


def test_window_thread_count_composite():
    """A composite window operator expands into two stages with their own
    replicas, in both packages."""
    counts = []
    for pkg in (wt, wj):
        g = _pg(pkg, "paw_threads")
        paw = (pkg.Paned_Windows_Builder(lambda ws: 0, lambda vs: 0)
               .with_key_by(lambda t: t.key).with_tb_windows(1000, 500)
               .with_parallelism(2, 3).build())
        g.add_source(pkg.Source_Builder(keyed_event_source(2, 5)).build()) \
            .add(paw).add_sink(pkg.Sink_Builder(WinCollector().sink).build())
        counts.append(g.get_num_threads())
        run_bounded(g)
    assert counts == [1 + 2 + 3 + 1] * 2


def test_paned_windows_cb_deterministic():
    expected = expected_windows(model_seqs(), WIN_CB, SLIDE_CB, True, sum)

    def make(pkg):
        return (pkg.Paned_Windows_Builder(sum_ws, lambda vals: sum(vals))
                .with_key_by(lambda t: t.key)
                .with_cb_windows(WIN_CB, SLIDE_CB)
                .with_parallelism(2, 3).build())
    got, _ = _both("paw_cb", "DETERMINISTIC", make)
    assert got.results == expected


def test_mapreduce_windows_cb_deterministic():
    """MAP partitions tuples by ts % p even for CB windows (reference
    ``window_replica.hpp:286``)."""
    expected = expected_windows(model_seqs(), WIN_CB, SLIDE_CB, True, sum)

    def make(pkg):
        return (pkg.MapReduce_Windows_Builder(sum_ws, lambda vals: sum(vals))
                .with_key_by(lambda t: t.key)
                .with_cb_windows(WIN_CB, SLIDE_CB)
                .with_parallelism(3, 2).build())
    got, _ = _both("mrw_cb", "DETERMINISTIC", make)
    assert got.results == expected


def test_paned_cb_rejected_in_default_mode():
    def bad(pkg):
        return (pkg.Paned_Windows_Builder(lambda ws: 0, lambda vs: 0)
                .with_key_by(lambda t: t.key).with_cb_windows(8, 4)
                .with_parallelism(2, 2).build())
    msg = _refusal(wt, bad, "paw_cb_bad")
    assert msg == _refusal(wj, bad, "paw_cb_bad")
    assert "count-based windows over BROADCAST" in msg


def test_composite_builder_refusals_match_jax():
    """The builders keep the JAX package's refusals and messages."""
    def msgs(pkg):
        out = []
        for fn in (
                lambda: pkg.Paned_Windows_Builder(sum_ws, sum)
                .with_key_by(lambda t: t.key).with_tb_windows(400, 1000)
                .build(),
                lambda: pkg.Keyed_Windows_Builder(sum_ws)
                .with_tb_windows(10, 10).build(),
                lambda: pkg.Keyed_Windows_Builder(sum_ws)
                .with_key_by(lambda t: t.key).build(),
                lambda: pkg.Keyed_Windows_Builder(sum_ws)
                .with_key_by(lambda t: t.key).with_cb_windows(4, 2)
                .with_tb_origin(0).build(),
                lambda: pkg.Ffat_Windows_Builder(lambda t: 1, sum)
                .incremental(0),
                lambda: pkg.Ffat_Windows_Builder(lambda t: 1, sum)
                .with_key_by(lambda t: t.key).with_tb_windows(10, 10)
                .with_tb_origin(0).build()):
            with pytest.raises(pkg.WindFlowError) as ei:
                fn()
            out.append(str(ei.value))
        return out
    assert msgs(wt) == msgs(wj)


# ---------------------------------------------------------------------------
# reference-compat TB numbering: with_tb_origin
# ---------------------------------------------------------------------------
def _offset_source(start, n_keys):
    def src(shipper, ctx):
        for i in range(40):
            ts = start + i * TS_STEP
            for k in range(n_keys):
                shipper.push_with_timestamp(TupleT(k, i + 1 + k, ts), ts)
            shipper.set_next_watermark(ts)
    return src


def test_keyed_windows_tb_origin_compat():
    """Windows anchored at the origin; those between the origin and a
    key's first tuple fire with the empty value."""
    start = 5_000

    def make(pkg):
        return (pkg.Keyed_Windows_Builder(sum_ws)
                .with_key_by(lambda t: t.key)
                .with_tb_windows(WIN_US, SLIDE_US).with_tb_origin(0).build())
    got, _ = _both("tb_origin", "DEFAULT", make,
                   src=_offset_source(start, 3))
    seqs = {k: [(i + 1 + k, start + i * TS_STEP) for i in range(40)]
            for k in range(3)}
    max_ts = start + 39 * TS_STEP
    expected, w = {}, 0
    while w * SLIDE_US <= max_ts:
        lo, hi = w * SLIDE_US, w * SLIDE_US + WIN_US
        for k in range(3):
            expected[(k, w)] = sum(v for v, ts in seqs[k] if lo <= ts < hi)
        w += 1
    assert got.results == expected
    assert got.results[(0, 0)] == 0
    assert sum(1 for v in got.results.values() if v == 0) \
        >= 3 * (start // SLIDE_US - 2)


def test_keyed_windows_tb_default_skips_origin_windows():
    start = 5_000

    def make(pkg):
        return (pkg.Keyed_Windows_Builder(sum_ws)
                .with_key_by(lambda t: t.key)
                .with_tb_windows(WIN_US, SLIDE_US).build())
    got, _ = _both("tb_default", "DEFAULT", make,
                   src=_offset_source(start, 1))
    assert all(v > 0 for v in got.results.values())
    assert min(w for (_, w) in got.results) >= (start - WIN_US) // SLIDE_US


def test_paned_windows_tb_origin_compat():
    """The origin flows through the composite (PLQ/WLQ) expansion."""
    start = 4_000

    def make(pkg):
        return (pkg.Paned_Windows_Builder(sum_ws, lambda vals: sum(vals))
                .with_key_by(lambda t: t.key)
                .with_tb_windows(WIN_US, SLIDE_US).with_tb_origin(0)
                .with_parallelism(2, 2).build())
    got, _ = _both("paned_origin", "DEFAULT", make,
                   src=_offset_source(start, 1))
    assert got.results[(0, 0)] == 0
    w_data = (start // SLIDE_US) + 1
    lo, hi = w_data * SLIDE_US, w_data * SLIDE_US + WIN_US
    assert got.results[(0, w_data)] == sum(
        i + 1 for i in range(40) if lo <= start + i * TS_STEP < hi)


# ---------------------------------------------------------------------------
# DETERMINISTIC mode: one window replica emits in the JAX order
# ---------------------------------------------------------------------------
def _keyed_tb(pkg):
    return (pkg.Keyed_Windows_Builder(sum_ws).with_key_by(lambda t: t.key)
            .with_tb_windows(WIN_US, SLIDE_US).build())


def _keyed_cb(pkg):
    return (pkg.Keyed_Windows_Builder(sum_ws).with_key_by(lambda t: t.key)
            .with_cb_windows(WIN_CB, SLIDE_CB).build())


def _ffat_tb(pkg):
    return (pkg.Ffat_Windows_Builder(lambda t: t.value, lambda a, b: a + b)
            .with_key_by(lambda t: t.key).with_tb_windows(WIN_US, SLIDE_US)
            .build())


def _paned_tb(pkg):
    return (pkg.Paned_Windows_Builder(sum_ws, lambda vals: sum(vals))
            .with_key_by(lambda t: t.key).with_tb_windows(WIN_US, SLIDE_US)
            .build())


def _mapreduce_tb(pkg):
    return (pkg.MapReduce_Windows_Builder(sum_ws, lambda vals: sum(vals))
            .with_key_by(lambda t: t.key).with_tb_windows(WIN_US, SLIDE_US)
            .with_parallelism(2, 1).build())


@pytest.mark.parametrize("make", [_keyed_tb, _keyed_cb, _ffat_tb, _paned_tb,
                                  _mapreduce_tb],
                         ids=["keyed_tb", "keyed_cb", "ffat_tb", "paned_tb",
                              "mapreduce_tb"])
def test_deterministic_order_matches_jax(make):
    """Three sources merged by timestamp into one window replica: the
    port's rows come out in the JAX package's order per key, with the
    same multiset. DETERMINISTIC guarantees each key's order; the
    cross-key order of equal timestamps follows when a channel's EOS
    lands in the JAX package's ordering collector (and, for MapReduce,
    the MAP replicas' scheduling in both packages), so only the port's
    own repeat run is held to the whole sequence, where the collector
    decides it alone."""
    got, ref = _both("det_order", "DETERMINISTIC", make, src_par=3)
    again = _run(wt, "det_order2", "DETERMINISTIC", make(wt), 3)
    assert _per_key(got.order) == _per_key(ref.order) \
        == _per_key(again.order)
    assert sorted(got.order) == sorted(ref.order)
    if make is not _mapreduce_tb:
        assert got.order == again.order
    assert len(got.order) == len(got.results)


def _per_key(order):
    by_key = {}
    for k, wid, v in order:
        by_key.setdefault(k, []).append((wid, v))
    return by_key


@pytest.mark.parametrize("eos_first", [False, True])
def test_ordering_collector_ties_ignore_eos_timing(eos_first):
    """Equal (ts, id) heads on two channels release in channel order
    whether channel 0's EOS lands before or after the merge."""
    from windflow_tpu_torch.message import Single
    from windflow_tpu_torch.runtime.collectors import OrderingCollector

    class Rec:
        def __init__(self):
            self.seen = []

        def handle_msg(self, ch, m):
            self.seen.append(m.payload)

    rec = Rec()
    coll = OrderingCollector(2, rec)
    for ch, name in ((0, "a0"), (0, "a1")):
        m = Single(name, len([1 for _ in rec.seen]), 5, 0)
        m.id = int(name[1])
        coll.handle_msg(ch, m)
    if eos_first:
        coll.on_channel_eos(0)
    for name in ("b0", "b1"):
        m = Single(name, 0, 5, 0)
        m.id = int(name[1])
        coll.handle_msg(1, m)
    coll.on_channel_eos(0)
    coll.on_channel_eos(1)
    coll.terminate()
    assert rec.seen == ["a0", "b0", "a1", "b1"]


# ---------------------------------------------------------------------------
# FlatFAT against a naive model, in both packages
# ---------------------------------------------------------------------------
def test_flatfat_sliding_vs_naive():
    vals = np.random.default_rng(3).integers(-5, 10, 500).tolist()
    fats = [wt.FlatFAT(16, lambda a, b: a + b),
            wj.FlatFAT(16, lambda a, b: a + b)]
    window = []
    for v in vals:
        window.append(v)
        for fat in fats:
            fat.push(v)
        if len(window) > 13:
            for fat in fats:
                fat.pop(len(window) - 13)
            window = window[-13:]
        for fat in fats:
            assert fat.query_all() == sum(window)
            if len(window) >= 4:
                assert fat.query_logical(1, 3) == sum(window[1:4])
        assert fats[0].tree == fats[1].tree and fats[0].head == fats[1].head


def test_flatfat_noncommutative_order():
    """String concatenation: results in logical insertion order even when
    the ring wraps."""
    fat = wt.FlatFAT(8, lambda a, b: a + b)
    seq = []
    for i in range(30):
        s = chr(ord("a") + i % 26)
        fat.push(s)
        seq.append(s)
        if len(seq) > 6:
            fat.pop(len(seq) - 6)
            seq = seq[-6:]
        assert fat.query_all() == "".join(seq)


def test_flatfat_identity_placeholders():
    fat = wt.FlatFAT(8, lambda a, b: a + b)
    for v in (None, 3, None, 4):
        fat.push(v)
    assert fat.query_all() == 7
    fat.pop(2)
    assert fat.query_all() == 4


# ---------------------------------------------------------------------------
# Ffat_Windows (host)
# ---------------------------------------------------------------------------
def ffat_sum(vals):
    return sum(vals) if vals else None  # empty windows carry the identity


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("win,slide", [(WIN_CB, SLIDE_CB), (8, 8), (3, 7)])
def test_ffat_cb(mode, win, slide):
    expected = expected_windows(model_seqs(), win, slide, True, ffat_sum)
    ps, pw = _degrees(41, 2)

    def make(pkg):
        return (pkg.Ffat_Windows_Builder(lambda t: t.value,
                                         lambda a, b: a + b)
                .with_key_by(lambda t: t.key).with_cb_windows(win, slide)
                .with_parallelism(pw).build())
    got, _ = _both("fat_cb", mode, make, ps)
    assert got.results == expected


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("win,slide", [(WIN_US, SLIDE_US), (800, 800)])
def test_ffat_tb(mode, win, slide):
    expected = expected_windows(model_seqs(), win, slide, False, ffat_sum)
    ps, pw = _degrees(43, 2)

    def make(pkg):
        return (pkg.Ffat_Windows_Builder(lambda t: t.value,
                                         lambda a, b: a + b)
                .with_key_by(lambda t: t.key).with_tb_windows(win, slide)
                .with_parallelism(pw).build())
    got, _ = _both("fat_tb", mode, make, ps)
    assert got.results == expected


def test_ffat_tb_noncommutative():
    """Ordered concatenation per window: panes combine in ts order under a
    non-commutative combine."""
    expected = expected_windows(
        {k: [(str(i % 10), i * TS_STEP) for i in range(STREAM_LEN)]
         for k in range(2)},
        WIN_US, SLIDE_US, False, lambda vals: "".join(vals) if vals else None)

    def src(shipper, ctx):
        for i in range(STREAM_LEN):
            ts = i * TS_STEP
            for k in range(2):
                shipper.push_with_timestamp(TupleT(k, i, ts), ts)
            shipper.set_next_watermark(ts)

    def make(pkg):
        return (pkg.Ffat_Windows_Builder(lambda t: str(t.value % 10),
                                         lambda a, b: a + b)
                .with_key_by(lambda t: t.key)
                .with_tb_windows(WIN_US, SLIDE_US).build())
    got, _ = _both("fat_nc", "DEFAULT", make, src=src)
    assert got.results == expected


def test_ffat_tb_lateness_disorder():
    """Bounded disorder within the declared lateness loses no tuple."""
    disorder = 300
    jitter = np.random.default_rng(9).integers(0, disorder + 1, STREAM_LEN)
    rows = [(i + 1, max(0, i * TS_STEP - int(jitter[i])))
            for i in range(STREAM_LEN)]
    expected = expected_windows({0: rows}, WIN_US, SLIDE_US, False, ffat_sum)

    def src(shipper, ctx):
        for i, (v, ts) in enumerate(rows):
            shipper.push_with_timestamp(TupleT(0, v, ts), ts)
            shipper.set_next_watermark(max(0, i * TS_STEP - disorder))

    def make(pkg):
        return (pkg.Ffat_Windows_Builder(lambda t: t.value,
                                         lambda a, b: a + b)
                .with_key_by(lambda t: t.key)
                .with_tb_windows(WIN_US, SLIDE_US)
                .with_lateness(disorder).build())
    got, _ = _both("fat_late", "DEFAULT", make, src=src)
    assert got.results == expected


# ---------------------------------------------------------------------------
# seeded cases of test_property_windows.py (host engines)
# ---------------------------------------------------------------------------
def _window_case(seed):
    rng = np.random.default_rng(seed)
    win, slide, n = (int(v) for v in (rng.integers(1, 13), rng.integers(1, 13),
                                      rng.integers(1, 41)))
    ts = np.concatenate([[0], np.cumsum(rng.integers(1, 10, n - 1))])
    vals = rng.integers(-5, 10, n)
    return win, slide, [(int(v), int(t)) for v, t in zip(vals, ts)]


def _single_key_source(rows):
    def src(shipper, ctx):
        for v, ts in rows:
            shipper.push_with_timestamp(TupleT(0, v, ts), ts)
            shipper.set_next_watermark(ts)
    return src


@pytest.mark.parametrize("seed", range(8))
def test_keyed_windows_tb_matches_model(seed):
    win, slide, rows = _window_case(seed)
    expected = expected_windows({0: rows}, win, slide, False, sum)

    def make(pkg):
        return (pkg.Keyed_Windows_Builder(sum_ws)
                .with_key_by(lambda t: t.key)
                .with_tb_windows(win, slide).build())
    got, _ = _both("prop_kw", "DEFAULT", make, src=_single_key_source(rows))
    assert got.results == expected


@pytest.mark.parametrize("seed", range(8))
def test_ffat_tb_matches_model(seed):
    win, slide, rows = _window_case(100 + seed)
    expected = expected_windows({0: rows}, win, slide, False, ffat_sum)

    def make(pkg):
        return (pkg.Ffat_Windows_Builder(lambda t: t.value,
                                         lambda a, b: a + b)
                .with_key_by(lambda t: t.key)
                .with_tb_windows(win, slide).build())
    got, _ = _both("prop_fat", "DEFAULT", make, src=_single_key_source(rows))
    assert got.results == expected
