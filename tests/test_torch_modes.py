"""The port's execution modes and collectors against the JAX package's.

- The collectors one by one (``OrderingCollector``,
  ``IDSequencerCollector``, ``DPJoinCollector``, ``KSlackCollector``):
  the same seeded message streams (a numpy generator) go through the JAX
  collector and the port's; what each delivers, in order, must be equal,
  with the release rule, the EOS flush and a snapshot/restore in the
  middle (a port snapshot, and a JAX one carried across by
  ``convert.collector_state_from_jax``).
- PROBABILISTIC mode: K-slack conservation (``delivered + dropped ==
  produced``), the twin of ``test_property_windows.py::
  test_probabilistic_windows_conservation``.
- The device operators refuse the non-DEFAULT modes when the graph
  configures them (each operator, the mesh ones and a fused chain).
- The ``Late_*`` conservation of the host window engines (``keyed_cpu``,
  ``ffat_cpu``) against the exact model ``expected_late_counts()`` of
  ``test_event_time_health.py`` (the JAX runs of that scenario are
  timing-flaky, so the model is the oracle)."""

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from common import TupleT, WinCollector
from test_event_time_health import (LATENESS, N, OBS, SLIDE, WIN,
                                    expected_late_counts, late_src)
from torch_waits import run_bounded
from windflow_tpu import message as msg_j
from windflow_tpu.runtime import collectors as coll_j
from windflow_tpu_torch import convert
from windflow_tpu_torch import message as msg_t
from windflow_tpu_torch.runtime import collectors as coll_t


def _pg(pkg, name, mode="DEFAULT", time_policy="EVENT_TIME"):
    kw = {"device": "cpu"} if pkg is wt else {}
    return pkg.PipeGraph(name, getattr(pkg.ExecutionMode, mode),
                         getattr(pkg.TimePolicy, time_policy), **kw)


# ---------------------------------------------------------------------------
# collectors, one by one
# ---------------------------------------------------------------------------
class _Rec:
    """The next chain node: records what a collector delivers."""

    def __init__(self):
        self.got = []

    def handle_msg(self, ch, m):
        if type(m).__name__ == "Batch":
            self.got.append(("B", [(p, ts) for p, ts in m.rows], m.id,
                             m.stream_tag, m.wm))
        else:
            self.got.append((m.payload, m.ts, m.id, m.stream_tag, m.wm,
                             m.is_punct))


def _single(mod, payload, id_, ts, wm=0, punct=False):
    return mod.Single(payload, id_, ts, wm, punct)


def _script(seed, n_ch=3, n=40, sorted_ts=True, punct_every=0, keyed=False):
    """A seeded arrival script: ``[(ch, payload, id, ts, wm, punct)]`` with
    per-channel ids 0, 1, ... and channel EOS events ``(ch, None, ...)``
    at the end of each channel's stream, interleaved at random."""
    rng = np.random.default_rng(seed)
    per_ch = []
    for c in range(n_ch):
        ts = np.cumsum(rng.integers(0, 30, n)) if sorted_ts \
            else rng.integers(0, 30 * n, n)
        evs = []
        for i in range(n):
            key = int(rng.integers(0, 4))
            payload = {"key": key, "v": c * 1000 + i} if keyed \
                else c * 1000 + i
            wm = int(max(0, ts[i] - 40))
            evs.append((c, payload, i, int(ts[i]), wm, False))
            if punct_every and i % punct_every == punct_every - 1:
                evs.append((c, None, 0, 0, wm, True))
        evs.append((c, "EOS", 0, 0, 0, False))
        per_ch.append(evs)
    out, heads = [], [0] * n_ch
    while any(h < len(e) for h, e in zip(heads, per_ch)):
        live = [c for c in range(n_ch) if heads[c] < len(per_ch[c])]
        c = live[int(rng.integers(0, len(live)))]
        out.append(per_ch[c][heads[c]])
        heads[c] += 1
    return out


def _feed(coll, mod, script, start=0, stop=None):
    for ch, payload, id_, ts, wm, punct in script[start:stop]:
        if payload == "EOS":
            coll.on_channel_eos(ch)
        else:
            coll.handle_msg(ch, _single(mod, payload, id_, ts, wm, punct))


def _make(kind, mod, n_ch, rec, dropped=None):
    c = coll_j if mod is msg_j else coll_t
    if kind == "ordering":
        return c.OrderingCollector(n_ch, rec)
    if kind == "ordering_join":
        return c.OrderingCollector(n_ch, rec, separator_id=2)
    if kind == "id":
        return c.IDSequencerCollector(n_ch, rec, lambda p: p["key"])
    if kind == "dpjoin":
        return c.DPJoinCollector(n_ch, rec, separator_id=1)
    return c.KSlackCollector(n_ch, rec, dropped)


def _id_script(seed, n=60):
    """Per-key dense ids 0..m (a PLQ's pane ids), sent out of order over
    two channels."""
    rng = np.random.default_rng(seed)
    msgs = []
    for key in range(3):
        for i in range(n // 3):
            msgs.append((key, i))
    order = rng.permutation(len(msgs))
    out = [(int(rng.integers(0, 2)), {"key": msgs[j][0], "v": msgs[j][1]},
            msgs[j][1], msgs[j][1] * 10, 0, False) for j in order]
    # a gap: key 3's id 1 never arrives, so id 2 waits until EOS
    out += [(0, {"key": 3, "v": 0}, 0, 0, 0, False),
            (1, {"key": 3, "v": 2}, 2, 20, 0, False)]
    return out + [(0, "EOS", 0, 0, 0, False), (1, "EOS", 0, 0, 0, False)]


SCRIPTS = {
    "ordering": lambda s: (3, _script(s)),
    "ordering_join": lambda s: (3, _script(s)),
    "id": lambda s: (2, _id_script(s)),
    "dpjoin": lambda s: (2, _script(s, n_ch=2, punct_every=7)),
    "kslack": lambda s: (2, _script(s, n_ch=2, sorted_ts=False)),
}


def _deliver(kind, mod, seed, cut=None, via_jax_snapshot=False):
    """Run the script through one collector; with ``cut``, snapshot after
    ``cut`` arrivals and finish on a fresh collector restored from it."""
    n_ch, script = SCRIPTS[kind](seed)
    rec = _Rec()
    dropped = (coll_j if mod is msg_j else coll_t).AtomicCounter()
    c = _make(kind, mod, n_ch, rec, dropped)
    if cut is None:
        _feed(c, mod, script)
    else:
        _feed(c, mod, script, 0, cut)
        st = c.snapshot_state()
        if via_jax_snapshot:
            st = convert.collector_state_from_jax(st)
            mod = msg_t
        c2 = _make(kind, mod, n_ch, rec, dropped)
        c2.restore_state(st)
        # the restored graph's channels open again; those closed before
        # the cut close again here (EOS is not part of the snapshot)
        for ch, payload, *_ in script[:cut]:
            if payload == "EOS":
                c2.on_channel_eos(ch)
        _feed(c2, mod, script, cut)
        c = c2
    c.terminate()
    return rec.got, dropped.value


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", list(SCRIPTS))
def test_collector_delivers_like_jax(kind, seed):
    got, dropped = _deliver(kind, msg_t, seed)
    ref, ref_dropped = _deliver(kind, msg_j, seed)
    assert got == ref and dropped == ref_dropped
    data = [g for g in got if not g[-1]] if kind == "dpjoin" else got
    n_sent = sum(1 for e in SCRIPTS[kind](seed)[1]
                 if e[1] not in ("EOS", None))
    # nothing lost: every message is delivered once, or K-slack-dropped
    assert len(data) + dropped == n_sent
    if kind in ("ordering", "ordering_join"):
        assert [(g[1], g[2]) for g in got] == sorted((g[1], g[2])
                                                     for g in got)
    if kind == "ordering_join":
        assert {g[3] for g in got} == {0, 1}  # channels 0-1 A, 2 B
    if kind == "id":
        for key in range(3):
            ids = [g[2] for g in got if g[0]["key"] == key]
            assert ids == sorted(ids) == list(range(len(ids)))
        assert [g[2] for g in got if g[0]["key"] == 3] == [0, 2]
    if kind == "kslack":
        ts = [g[1] for g in got]
        assert ts == sorted(ts) and dropped > 0


@pytest.mark.parametrize("kind", list(SCRIPTS))
def test_collector_snapshot_restore(kind):
    """A snapshot taken mid-stream and restored into a fresh collector
    finishes with what an uninterrupted collector delivers; so does a JAX
    snapshot carried across by ``convert.collector_state_from_jax``."""
    whole, _ = _deliver(kind, msg_t, 7)
    n = len(SCRIPTS[kind](7)[1])
    for cut in (n // 3, (2 * n) // 3):
        assert _deliver(kind, msg_t, 7, cut)[0] == whole
        assert _deliver(kind, msg_j, 7, cut, via_jax_snapshot=True)[0] \
            == whole


def test_ordering_collector_release_rule():
    """A message is released only once every live channel has input; a
    closed channel stops holding the merge back."""
    rec = _Rec()
    c = coll_t.OrderingCollector(2, rec)
    c.handle_msg(0, msg_t.Single("a", 0, 10))
    c.handle_msg(0, msg_t.Single("b", 1, 30))
    assert rec.got == []  # channel 1 is open and empty
    c.handle_msg(1, msg_t.Single("c", 0, 20))
    assert [g[0] for g in rec.got] == ["a", "c"]
    c.on_channel_eos(1)
    assert [g[0] for g in rec.got] == ["a", "c", "b"]


def test_collector_snapshot_owns_its_messages():
    """A blob must own its data: the DP-join collector rewrites a
    message's watermark on release, which must not reach a snapshot
    taken before it."""
    rec = _Rec()
    c = coll_t.DPJoinCollector(2, rec, separator_id=1)
    c.handle_msg(0, msg_t.Single("x", 0, 5, 0))
    st = c.snapshot_state()
    c.handle_msg(0, msg_t.Single(None, 1, 0, 50, True))
    c.handle_msg(1, msg_t.Single(None, 0, 0, 50, True))
    (row,) = [g for g in rec.got if g[0] == "x"]
    assert row[1] == 5 and row[4] == 50
    assert st["heap"][0][-1].wm == 0


# ---------------------------------------------------------------------------
# graphs in the non-DEFAULT modes
# ---------------------------------------------------------------------------
def _prob_rows():
    jitter = np.random.default_rng(3).integers(0, 401, 400)
    return [(1, max(0, i * 50 - int(jitter[i]))) for i in range(400)]


def test_probabilistic_windows_conservation():
    """K-slack reordering with real disorder feeding keyed windows: window
    sums over the delivered tuples plus the dropped ones conserve the
    stream; the drops are counted in ``get_num_dropped_tuples``, and equal
    the JAX package's."""
    rows = _prob_rows()

    def src(shipper, ctx):
        for i, (v, ts) in enumerate(rows):
            shipper.push_with_timestamp(TupleT(0, v, ts), ts)
            shipper.set_next_watermark(max(0, i * 50 - 400))

    out = {}
    for pkg in (wt, wj):
        g = _pg(pkg, "prob_win", "PROBABILISTIC")
        coll = WinCollector()
        kw = (pkg.Keyed_Windows_Builder(lambda ws: sum(w.value for w in ws))
              .with_key_by(lambda t: t.key)
              .with_tb_windows(1000, 1000).build())  # tumbling
        g.add_source(pkg.Source_Builder(src).build()).add(kw) \
            .add_sink(pkg.Sink_Builder(coll.sink).build())
        run_bounded(g)
        delivered = sum(coll.results.values())
        dropped = g.get_num_dropped_tuples()
        assert delivered + dropped == len(rows)
        assert g.get_stats()["Dropped_tuples"] == dropped
        out[pkg] = (coll.results, dropped)
    assert out[wt] == out[wj]
    assert out[wt][1] > 0


def _two_replicas_in_order(shipper, ctx):
    for i in range(5):
        shipper.push_with_timestamp(TupleT(ctx.get_replica_index(), i + 1,
                                           i * 10), i * 10)
        shipper.set_next_watermark(i * 10)


def _one_replica_disordered(shipper, ctx):
    # ts 20 after 40 is dropped and sets K = 20: from then on the heap
    # releases only up to max_ts - 20, and 45, 50, 55 wait for EOS. One
    # key: the window results fired at EOS share one timestamp, and the
    # sink's own K-slack drops a result whose ts equals its frontier
    for v, ts in [(1, 10), (2, 40), (3, 20), (4, 50), (5, 45), (6, 55)]:
        shipper.push_with_timestamp(TupleT(0, v, ts), ts)


@pytest.mark.parametrize("mode,src,par,want", [
    ("DETERMINISTIC", _two_replicas_in_order, 2, {(0, 0): 15, (1, 0): 15}),
    ("PROBABILISTIC", _one_replica_disordered, 1, {(0, 0): 18})],
    ids=["DETERMINISTIC", "PROBABILISTIC"])
def test_window_firing_only_at_eos_is_delivered(mode, src, par, want):
    """The ordering and K-slack collectors drain at ``terminate``: a
    window that fires only at EOS, over tuples they still hold, reaches
    the sink."""
    out = {}
    for pkg in (wt, wj):
        g = _pg(pkg, "eos_fire", mode)
        coll = WinCollector()
        kw = (pkg.Keyed_Windows_Builder(lambda ws: sum(w.value for w in ws))
              .with_key_by(lambda t: t.key)
              .with_tb_windows(1_000_000, 1_000_000).build())
        g.add_source(pkg.Source_Builder(src).with_parallelism(par).build()) \
            .add(kw).add_sink(pkg.Sink_Builder(coll.sink).build())
        run_bounded(g)
        out[pkg] = (coll.results, g.get_num_dropped_tuples())
    assert out[wt] == out[wj] == (want, 0 if mode == "DETERMINISTIC" else 1)


def _device_ops(pkg_name):
    """Device operators (and a fused chain) of the port, by label."""
    def smap(f, s):
        return {**f, "value": f["value"] + s["n"]}, {"n": s["n"] + 1}
    win = (lambda: wt.Ffat_Windows_GPU_Builder(
        lambda f: {"value": f["value"]}, wt.fieldwise(value="sum"))
        .with_key_by("key").with_tb_windows(100, 100))
    return {
        "Map_GPU": lambda: [wt.Map_GPU_Builder(
            lambda f: {**f, "value": f["value"] * 2}).build()],
        "Filter_GPU": lambda: [wt.Filter_GPU_Builder(
            lambda f: f["value"] > 0).build()],
        "Reduce_GPU": lambda: [wt.Reduce_GPU_Builder(
            wt.fieldwise(value="sum")).with_key_by("key").build()],
        "Ffat_Windows_GPU": lambda: [win().build()],
        "Map_Mesh": lambda: [wt.Map_GPU_Builder(smap)
                             .with_state({"n": np.int32(0)})
                             .with_key_by("key")
                             .with_mesh(mesh_shape=(1, 1)).build()],
        "Reduce_Mesh": lambda: [wt.Reduce_GPU_Builder(
            wt.fieldwise(value="sum")).with_key_by("key")
            .with_mesh(mesh_shape=(1, 1)).build()],
        "Ffat_Windows_Mesh": lambda: [win().with_key_capacity(4)
                                      .with_mesh(mesh_shape=(1, 1))
                                      .build()],
        "fused_chain": lambda: [
            wt.Map_GPU_Builder(lambda f: {**f, "value": f["value"] * 2})
            .build(),
            wt.Filter_GPU_Builder(lambda f: f["value"] > 0).build()],
    }[pkg_name]


@pytest.mark.parametrize("mode", ["DETERMINISTIC", "PROBABILISTIC"])
@pytest.mark.parametrize("op", ["Map_GPU", "Filter_GPU", "Reduce_GPU",
                                "Ffat_Windows_GPU", "Map_Mesh",
                                "Reduce_Mesh", "Ffat_Windows_Mesh",
                                "fused_chain"])
def test_device_operators_refuse_non_default_modes(op, mode):
    """The graph no longer refuses the mode; every device operator does,
    when the graph configures it (``GPUOperatorBase.configure``)."""
    def src(shipper, ctx):
        shipper.push_with_timestamp({"key": 0, "value": 1}, 0)

    g = _pg(wt, f"dev_{op}", mode)
    ops = _device_ops(op)()
    mp = g.add_source(wt.Source_Builder(src).with_output_batch_size(4)
                      .build()).add(ops[0])
    for o in ops[1:]:
        mp = mp.chain(o)
    mp.add_sink(wt.Sink_Builder(lambda r: None).build())
    if op == "fused_chain":
        assert g._stages[1].is_fused_gpu
    with pytest.raises(wt.WindFlowError,
                       match="GPU operators require DEFAULT execution mode"):
        run_bounded(g)


# ---------------------------------------------------------------------------
# late accounting of the host window engines (event-time health)
# ---------------------------------------------------------------------------
def _late_replay(engine):
    g = _pg(wt, f"evt_health_{engine}")
    results = []
    if engine == "keyed_cpu":
        op = (wt.Keyed_Windows_Builder(lambda ws: len(list(ws)))
              .with_key_by(lambda t: t["key"]).with_tb_windows(WIN, SLIDE)
              .with_lateness(LATENESS).with_name("win").build())
    else:
        op = (wt.Ffat_Windows_Builder(lambda t: 1, lambda a, b: a + b)
              .with_key_by(lambda t: t["key"]).with_tb_windows(WIN, SLIDE)
              .with_lateness(LATENESS).with_name("win").build())
    g.add_source(wt.Source_Builder(late_src).with_output_batch_size(OBS)
                 .build()) \
        .add(op).add_sink(wt.Sink_Builder(
            lambda r: results.append(r) if r is not None else None).build())
    run_bounded(g)
    assert results, f"{engine}: no windows fired"
    win = next(o for o in g.get_stats()["Operators"] if o["name"] == "win")
    return {k: sum(r[k] for r in win["replicas"])
            for k in ("Inputs_received", "Late_records", "Late_dropped",
                      "Late_admitted", "Inputs_ignored")}


@pytest.mark.parametrize("engine", ["keyed_cpu", "ffat_cpu"])
def test_late_conservation_invariant(engine):
    exp_admit, exp_drop = expected_late_counts()
    assert exp_admit > 0 and exp_drop > 0
    st = _late_replay(engine)
    assert st["Inputs_received"] == N
    on_time = st["Inputs_received"] - st["Late_records"]
    assert on_time + st["Late_admitted"] + st["Late_dropped"] == N
    assert st["Late_admitted"] == exp_admit, st
    assert st["Late_dropped"] == exp_drop, st
    assert st["Late_records"] == exp_admit + exp_drop, st
    assert st["Inputs_ignored"] == exp_drop


def test_kslack_drops_a_tie_with_its_frontier():
    """Shared with the reference: K-slack drops a message whose timestamp
    EQUALS the released frontier, so of several window results fired at
    one timestamp (several keys flushed at EOS) a sink's K-slack keeps
    the first (ROADMAP Queue 3, faults of the reference)."""
    out = {}
    for coll, msg in ((coll_t, msg_t), (coll_j, msg_j)):
        rec, dropped = _Rec(), coll.AtomicCounter()
        c = coll.KSlackCollector(1, rec, dropped)
        for i, ts in enumerate((10, 10, 11)):
            c.handle_msg(0, msg.Single(i, i, ts))
        c.terminate()
        out[coll] = ([g[0] for g in rec.got], dropped.value)
    assert out[coll_t] == out[coll_j] == ([0, 2], 1)
