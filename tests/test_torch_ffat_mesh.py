"""The port's ``Ffat_Windows_Mesh`` (``windflow_tpu_torch/mesh/ffat_mesh.py``)
held against the JAX package's through the topology layer: the same
sources (CPU source -> keyed staging -> the sharded forest -> CPU sink)
built with each package's builders, the JAX graph on its conftest's 8
virtual CPU devices, the port's on ``device="cpu"`` after
``ensure_virtual_devices(8)``. The twins of ``tests/test_ffat_mesh.py``,
each case also checked against the same origin-anchored window oracle.

Tolerance: EXACT. The values are integer-valued float32 (every partial
sum an integer below 2^24), so no grouping of the additions rounds."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_combines as tc
import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.tpu import Ffat_Windows_TPU_Builder
from windflow_tpu_torch.gpu.batch import BatchGPU
from windflow_tpu_torch.gpu.keymap import KeySlotMap
from windflow_tpu_torch.gpu.schema import TupleSchema
from windflow_tpu_torch.mesh import core as ct
from windflow_tpu_torch.mesh.ffat_mesh import Ffat_Windows_Mesh

N_KEYS = 11
STREAM_LEN = 400
TS_STEP = 37          # us between tuples of one key
WIN_US, SLIDE_US = 800, 200
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 1)]
SPARSE_IDS = [(k * 2_654_435_761 - 5_000_000_000) * (11 + k)
              for k in range(N_KEYS)]


@pytest.fixture(autouse=True)
def virtual_devices():
    """8 virtual devices on the CPU and no excluded device for this
    file's tests; the process-wide registries go back to what they were
    (other port test files share the worker)."""
    prev, prev_excl = ct.virtual_device_count(), ct.excluded_device_ids()
    ct.ensure_virtual_devices(8)
    ct.set_excluded_devices(())
    yield
    ct.ensure_virtual_devices(prev)
    ct.set_excluded_devices(prev_excl)


def _make_src(n_keys, stream_len, keymap=None):
    keymap = keymap or list(range(n_keys))

    def src(shipper, ctx):
        for i in range(stream_len):
            ts = i * TS_STEP
            for k in range(n_keys):
                shipper.push_with_timestamp(
                    {"key": keymap[k], "value": float(i + 1 + k)}, ts)
            if i % 16 == 15:
                shipper.set_next_watermark(ts)
    return src


def _oracle(n_keys, stream_len, win_us, slide_us):
    """Origin-anchored windows: window w of key k sums tuples with ts in
    [w*slide, w*slide + win)."""
    pane = np.gcd(win_us, slide_us)
    win_p, slide_p = win_us // pane, slide_us // pane
    exp = {}
    max_pane = ((stream_len - 1) * TS_STEP) // pane
    w = 0
    while w * slide_p <= max_pane:
        lo_p, hi_p = w * slide_p, w * slide_p + win_p
        for k in range(n_keys):
            s, any_t = 0.0, False
            for i in range(stream_len):
                if lo_p <= (i * TS_STEP) // pane < hi_p:
                    s += i + 1 + k
                    any_t = True
            if any_t:
                exp[(k, w)] = s
        w += 1
    return exp


class Collector:
    def __init__(self):
        self._lock = threading.Lock()
        self.rows = {}
        self.dups = 0

    def sink(self, r):
        if r is None:
            return
        with self._lock:
            key = (int(r["key"]), int(r["wid"]))
            if key in self.rows:
                self.dups += 1
            self.rows[key] = float(r["value"]) if r["valid"] else None

    @property
    def valid(self):
        return {k: v for k, v in self.rows.items() if v is not None}


def _builder(pkg, win, slide, key_capacity, schema=False, **mesh):
    if pkg is wj:
        b = Ffat_Windows_TPU_Builder(
            lambda f: {"value": f["value"]},
            lambda a, b_: {"value": a["value"] + b_["value"]})
    else:
        b = wt.Ffat_Windows_GPU_Builder(
            lambda f: {"value": f["value"]},
            lambda a, b_: {"value": a["value"] + b_["value"]})
        if schema:
            # the port's host staging refuses an int beyond int32 (the JAX
            # package's native encoder truncates it): declare the key int64
            b = b.with_schema({"key": np.int64, "value": np.float32})
    return (b.with_key_by("key").with_tb_windows(win, slide)
            .with_key_capacity(key_capacity).with_mesh(**mesh))


def _run(pkg, src, obs, win=WIN_US, slide=SLIDE_US, key_capacity=N_KEYS,
         schema=False, **mesh):
    coll = Collector()
    kw = {} if pkg is wj else {"device": "cpu"}
    g = pkg.PipeGraph("ffat_mesh", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT_TIME, **kw)
    op = _builder(pkg, win, slide, key_capacity, schema, **mesh).build()
    g.add_source(pkg.Source_Builder(src).with_output_batch_size(obs).build()
                 ).add(op).add_sink(pkg.Sink_Builder(coll.sink).build())
    run_bounded(g)
    return coll, g


def _both(src, obs, **kw):
    """The same source through both packages: (JAX collector, port
    collector, port graph); the two must agree row for row."""
    cj, _ = _run(wj, src, obs, **{k: v for k, v in kw.items()
                                  if k != "schema"})
    ct_, g = _run(wt, src, obs, **kw)
    assert ct_.rows == cj.rows
    assert ct_.dups == cj.dups == 0
    return cj, ct_, g


# ---------------------------------------------------------------------------
def test_mesh_pipeline_matches_oracle():
    """Default mesh (8 visible devices: the automatic (4, 2))."""
    _, got, g = _both(_make_src(N_KEYS, STREAM_LEN), 64)
    assert got.valid == _oracle(N_KEYS, STREAM_LEN, WIN_US, SLIDE_US)
    rep = g.get_stats()["Operators"][1]["replicas"][0]
    assert rep["Mesh_devices"] == 8 and rep["Mesh_steps"] > 0
    assert rep["Mesh_shuffle_bytes"] > 0 and rep["Mesh_shard_skew"] > 0


@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_reshape_invariance(shape):
    """The same stream through every mesh shape gives the oracle's rows,
    in both packages."""
    _, got, _ = _both(_make_src(N_KEYS, STREAM_LEN), 64, mesh_shape=shape)
    assert got.valid == _oracle(N_KEYS, STREAM_LEN, WIN_US, SLIDE_US)


def test_mesh_pipeline_key_capacity_guard():
    for pkg in (wj, wt):
        with pytest.raises(pkg.WindFlowError, match="key_capacity"):
            _run(pkg, _make_src(N_KEYS, STREAM_LEN), 64, key_capacity=4)


def test_mesh_sparse_int_keys_match_oracle():
    """Sparse, negative int64 keys: the rows equal the dense-key oracle
    re-keyed by the original ids."""
    _, got, _ = _both(_make_src(N_KEYS, STREAM_LEN, SPARSE_IDS), 64,
                      schema=True)
    exp = {(SPARSE_IDS[k], w): v
           for (k, w), v in _oracle(N_KEYS, STREAM_LEN, WIN_US,
                                    SLIDE_US).items()}
    assert got.valid == exp


def test_mesh_builder_validation():
    for B in (Ffat_Windows_TPU_Builder, wt.Ffat_Windows_GPU_Builder):
        b = (B(lambda f: f, lambda a, b_: a)
             .with_key_by("key").with_cb_windows(8, 4).with_mesh())
        with pytest.raises(Exception, match="TB"):
            b.build()
        b2 = (B(lambda f: f, lambda a, b_: a)
              .with_key_by("key").with_tb_windows(800, 200)
              .with_parallelism(2).with_mesh())
        with pytest.raises(Exception, match="exclusive"):
            b2.build()
        b3 = (B(lambda f: f, lambda a, b_: a).with_key_by("key")
              .with_tb_windows(800, 200).with_num_win_per_batch(4)
              .with_mesh())
        with pytest.raises(Exception, match="fire_rounds"):
            b3.build()


def test_mesh_cuda_refuses_an_arbitrary_combine():
    """On CUDA the mesh takes any combine K1 can trace (configure no longer
    refuses a callable); one it cannot trace, here Python control flow on
    values, is refused for the forest's planes with the operation named
    (the mesh traces when it first allocates its forest)."""
    from windflow_tpu_torch.kernels.forest_rebuild import variant
    op = (wt.Ffat_Windows_GPU_Builder(lambda f: f, lambda a, b: a)
          .with_key_by("key").with_tb_windows(800, 200).with_mesh().build())
    op.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT_TIME,
                 torch.device("cuda"))
    assert variant(op.combine, {"value": torch.float32}).ir is not None
    bad = (wt.Ffat_Windows_GPU_Builder(
        lambda f: f, lambda a, b: {"value": a["value"] if a["value"] > 0
                                   else b["value"]})
        .with_key_by("key").with_tb_windows(800, 200).with_mesh().build())
    bad.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT_TIME,
                  torch.device("cuda"))
    with pytest.raises(wt.WindFlowError, match=r"bool\(\).*a\['value'\]"):
        variant(bad.combine, {"value": torch.float32})


def _traced_lift(name, pkg):
    """The lift of a traced combine over the source's (key, float value)."""
    if pkg is wj:
        i32 = lambda x: x.astype(jnp.int32)  # noqa: E731
    else:
        i32 = lambda x: x.to(torch.int32)  # noqa: E731
    v = lambda f: f["value"]  # noqa: E731
    return {
        "ysb_last": lambda f: {"count": i32(v(f) * 0 + 1),
                               "last_ing": i32(v(f))},
        "mean_last": lambda f: {"n": i32(v(f) * 0 + 1), "last": i32(v(f)),
                                "mean": v(f)},
        "argmax_ts": lambda f: {"v": v(f), "ts": i32(v(f)) * 3},
        "flags": lambda f: {"f": v(f) > 200, "n": i32(v(f))},
        "wide": lambda f: {f"w{i}": i32(v(f)) * (i + 1) - i
                           for i in range(tc.WIDE)},
    }[name]


@pytest.mark.parametrize("name", tc.WINDOWED)
def test_mesh_traced_combine_matches_jax(name):
    """The traced combines (torch_combines.py; the JAX mesh runs the jnp
    twin) through the (4, 2) mesh: every window row equal, ints and
    bools exactly, mean_last's float mean within rtol 1e-6 (the data
    replicas' deltas merge in the same butterfly order, and every value is
    an integer, so no grouping rounds)."""
    rows = {}
    for pkg in (wj, wt):
        got = {}

        def sink(r, got=got):
            if r is not None and r["valid"]:
                got[(int(r["key"]), int(r["wid"]))] = {
                    k: r[k] for k in tc.DTYPES[name]}

        xp = jnp if pkg is wj else torch
        B = Ffat_Windows_TPU_Builder if pkg is wj \
            else wt.Ffat_Windows_GPU_Builder
        op = (B(_traced_lift(name, pkg), tc.make(name, xp))
              .with_key_by("key").with_tb_windows(WIN_US, SLIDE_US)
              .with_key_capacity(N_KEYS).with_mesh(mesh_shape=(4, 2))
              .build())
        kw = {} if pkg is wj else {"device": "cpu"}
        g = pkg.PipeGraph("ffat_mesh", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT_TIME, **kw)
        g.add_source(pkg.Source_Builder(_make_src(N_KEYS, 120))
                     .with_output_batch_size(64).build()
                     ).add(op).add_sink(pkg.Sink_Builder(sink).build())
        run_bounded(g)
        rows[pkg] = got
    assert rows[wt].keys() == rows[wj].keys() and rows[wt]
    for k, jr in rows[wj].items():
        for f, jv in jr.items():
            if name == "mean_last" and f == "mean":
                assert float(rows[wt][k][f]) == pytest.approx(float(jv),
                                                              rel=1e-6)
            else:
                assert rows[wt][k][f] == jv, (k, f)


def test_mesh_epoch_timestamps_rebase():
    """Epoch-us timestamps would overflow the int32 pane domain without
    the host-side pane rebase; window ids stay origin-anchored."""
    EPOCH = 1_700_000_000_000_000

    def src(shipper, ctx):
        for i in range(200):
            ts = EPOCH + i * TS_STEP
            for k in range(3):
                shipper.push_with_timestamp(
                    {"key": k, "value": float(i + 1)}, ts)
            if i % 16 == 15:
                shipper.set_next_watermark(ts)

    _, got, _ = _both(src, 64, key_capacity=3)
    got = got.valid
    assert got
    pane = np.gcd(WIN_US, SLIDE_US)
    slide_p, win_p = SLIDE_US // pane, WIN_US // pane
    for (k, w), v in got.items():
        assert w >= EPOCH // SLIDE_US - 1
        lo_p, hi_p = w * slide_p, w * slide_p + win_p
        assert v == sum(i + 1 for i in range(200)
                        if lo_p <= (EPOCH + i * TS_STEP) // pane < hi_p)


def _ones_expect(tuples, w_max, win=4):
    exp = {}
    for w in range(0, w_max):
        s = sum(1.0 for p in range(w, w + win) if p in tuples)
        if s:
            exp[(0, w)] = s
    return exp


def test_mesh_watermark_jump_no_ring_aliasing():
    """A watermark jump makes firing lag eviction; panes that wrap the
    ring onto unevicted leaves must trigger catch-up steps first."""
    def src(shipper, ctx):
        for p in range(8):
            shipper.push_with_timestamp({"key": 0, "value": 1.0}, p)
        shipper.set_next_watermark(7)
        for p in range(30, 35):
            shipper.push_with_timestamp({"key": 0, "value": 1.0}, p)
        shipper.set_next_watermark(34)

    _, got, _ = _both(src, 8, win=4, slide=1, key_capacity=1,
                      fire_rounds=2)
    got = got.valid
    tuples = set(range(8)) | set(range(30, 35))
    for (k, w), v in got.items():
        assert v == sum(1.0 for p in range(w, w + 4) if p in tuples)
    assert any(w < 8 for (_, w) in got) and any(w >= 30 for (_, w) in got)


def test_mesh_idle_key_resume_no_ring_aliasing():
    """A drained key idle while the frontier moves fast-forwards on
    resume: no stalled window fires with the new tuple's value."""
    def src(shipper, ctx):
        for p in range(8):
            shipper.push_with_timestamp({"key": 0, "value": 1.0}, p)
        shipper.set_next_watermark(60)
        for p in range(62, 66):
            shipper.push_with_timestamp({"key": 0, "value": 1.0}, p)
        shipper.set_next_watermark(70)

    _, got, _ = _both(src, 8, win=4, slide=1, key_capacity=1)
    got = got.valid
    assert not any(8 <= w < 59 for (_, w) in got)
    assert got == _ones_expect(set(range(8)) | set(range(62, 66)), 66)


def test_mesh_outrun_grows_ring():
    """A source outrunning its watermarks grows the ring (leaf migration)
    and the results stay exact."""
    def src(shipper, ctx):
        for p in range(8):
            shipper.push_with_timestamp({"key": 0, "value": 1.0}, p)
        for p in range(400, 404):
            shipper.push_with_timestamp({"key": 0, "value": 1.0}, p)
        shipper.set_next_watermark(410)

    _, got, g = _both(src, 4, win=4, slide=1, key_capacity=1)
    assert got.valid == _ones_expect(set(range(8)) | set(range(400, 404)),
                                     404)
    op = next(o for o in g._ops if isinstance(o, Ffat_Windows_Mesh))
    assert op.replicas[0]._F == 512  # grown from 32


def test_mesh_outrunning_watermark_beyond_cap_raises():
    def src(shipper, ctx):
        for p in range(8):
            shipper.push_with_timestamp({"key": 0, "value": 1.0}, p)
        shipper.push_with_timestamp({"key": 0, "value": 1.0}, 1 << 21)

    for pkg in (wj, wt):
        with pytest.raises(pkg.WindFlowError, match="ring"):
            _run(pkg, src, 4, win=4, slide=1, key_capacity=1)


def _late_src(shipper, ctx):
    for p in range(8):
        shipper.push_with_timestamp({"key": 0, "value": 1.0}, p)
    shipper.set_next_watermark(5)
    shipper.push_with_timestamp({"key": 0, "value": 0.0}, 7)
    # LATE: pane 2 in [nf, nf + win - slide) = [2, 5)
    shipper.push_with_timestamp({"key": 0, "value": 100.0}, 2)


@pytest.mark.parametrize("late_policy,w2", [("keep_open", 104.0),
                                            ("ref_fired", 4.0)])
def test_mesh_late_policy(late_policy, w2):
    _, got, _ = _both(_late_src, 1, win=4, slide=1, key_capacity=1,
                      late_policy=late_policy)
    got = got.valid
    assert got[(0, 0)] == 4.0 and got[(0, 1)] == 4.0
    assert got[(0, 2)] == w2, got
    assert got[(0, 3)] == 4.0 and got[(0, 7)] == 1.0


def test_mesh_late_policy_validation():
    for B in (Ffat_Windows_TPU_Builder, wt.Ffat_Windows_GPU_Builder):
        with pytest.raises(Exception, match="late_policy"):
            (B(lambda f: f, lambda a, b: a).with_key_by("key")
             .with_tb_windows(4, 1).with_mesh(late_policy="nope").build())


def test_mesh_late_policy_hopping_windows_coincide():
    """Hopping windows (slide > win): gap panes belong to no window, so
    the two policies agree, and no window leaks the gap tuple."""
    def src(shipper, ctx):
        for p in range(12):
            shipper.push_with_timestamp({"key": 0, "value": 1.0}, p)
        shipper.set_next_watermark(7)
        shipper.push_with_timestamp({"key": 0, "value": 0.0}, 11)
        shipper.push_with_timestamp({"key": 0, "value": 100.0}, 4)

    keep = _both(src, 1, win=1, slide=3, key_capacity=1,
                 late_policy="keep_open")[1].valid
    ref = _both(src, 1, win=1, slide=3, key_capacity=1,
                late_policy="ref_fired")[1].valid
    assert keep == ref and all(v == 1.0 for v in keep.values()), keep


def test_keymap_capacity_overflow_rolls_back():
    """A key refused by on_new (capacity) is not registered: a caught and
    retried batch raises again instead of getting an out-of-range slot."""
    cap = 2

    def on_new(key, slot):
        if slot >= cap:
            raise wt.WindFlowError("over capacity")

    m = KeySlotMap(on_new=on_new)
    assert m.slot("a") == 0 and m.slot("b") == 1
    for _ in range(2):
        with pytest.raises(wt.WindFlowError, match="capacity"):
            m.slot("c")
        assert len(m) == 2
    m2 = KeySlotMap(on_new=on_new)
    a = np.array([5, 9, 9])
    assert list(m2.slots_of(a, a, 3)) == [0, 1, 1]
    b = np.array([11])
    for _ in range(2):
        with pytest.raises(wt.WindFlowError, match="capacity"):
            m2.slots_of(b, b, 1)
        assert len(m2) == 2


def test_forest_int32_index_plane_guard():
    """k_local * 2 * ring_panes beyond int32 refuses loudly in both
    packages (ring growth doubles F through the same construction)."""
    from windflow_tpu.mesh.core import make_key_mesh, sharded_ffat_forest
    kw = dict(n_keys=1 << 28, win_panes=4, slide_panes=1, local_batch=8,
              fire_rounds=2, ring_panes=64)
    with pytest.raises(ValueError, match="int32 index plane"):
        sharded_ffat_forest(make_key_mesh(8, shape=(8, 1)), lambda f: f,
                            lambda a, b: a, **kw)
    with pytest.raises(ValueError, match="int32 index plane"):
        ct.sharded_ffat_forest(
            ct.make_key_mesh(8, shape=(8, 1), device="cpu"), lambda f: f,
            lambda a, b: a, **kw)


def test_mesh_catch_up_drain_count_pins_device_rule():
    """``_catch_up`` and the EOS flush size their drain from ONE control
    fetch: the count fires exactly the brute-force eligible windows (a
    probe step after it fires nothing), and one step fewer leaves some."""
    WIN_P, SLIDE_P, ROUNDS = 4, 1, 2
    op = Ffat_Windows_Mesh(
        lift=lambda f: {"value": f["value"]},
        combine=lambda a, b: {"value": a["value"] + b["value"]},
        key_extractor="key", win_len=WIN_P, slide_len=SLIDE_P,
        key_capacity=8, fire_rounds=ROUNDS, mesh_shape=(8, 1),
        name="drain_pin")
    op.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT_TIME,
                 torch.device("cpu"))
    op.build_replicas()
    rep = op.replicas[0]
    emitted = []
    rep._emit_batch = lambda b: emitted.append(b)
    schema = TupleSchema({"value": np.dtype(np.float32)})
    seed = BatchGPU({"value": torch.ones(1)}, np.zeros(1, np.int64), 1,
                    schema, wm=0, host_keys=np.array([0], np.int64))
    rep.process_device_batch(seed)
    assert not emitted

    def craft(nf_vals, ml_vals):
        st = rep._state
        nf = torch.tensor(nf_vals, dtype=torch.int32)
        rep._state = (st[0], st[1], nf,
                      torch.tensor(ml_vals, dtype=torch.int32),
                      (nf // SLIDE_P).to(torch.int32))

    def brute(nf, ml, frontier):
        fires = 0
        while nf + WIN_P <= frontier and ml >= nf:
            fires += 1
            nf += SLIDE_P
        return fires

    def probe_fires():
        before = sum(b.size for b in emitted)
        rep._run_steps(np.zeros(0, np.int32), np.zeros(0, np.int32),
                       rep._empty_vals())
        return sum(b.size for b in emitted) - before

    NF = [0, 5, 28, 10, 26, 0, 0, 0]
    ML = [19, 7, 40, 4, 26, 25, -1, -1]
    FRONTIER = 30
    craft(NF, ML)
    rep._frontier = FRONTIER
    rep._backlog_bound = 1
    emitted.clear()
    rep._catch_up()
    expected = sum(brute(nf, ml, FRONTIER) for nf, ml in zip(NF, ML))
    assert expected > 0
    assert sum(b.size for b in emitted) == expected
    assert probe_fires() == 0

    craft(NF, ML)
    rep._frontier = FRONTIER
    rep._max_pane_seen = 40
    emitted.clear()
    rep.flush_on_termination()
    eos = 40 + WIN_P + 1
    assert sum(b.size for b in emitted) == sum(
        brute(nf, ml, eos) for nf, ml in zip(NF, ML))
    assert probe_fires() == 0

    craft(NF, ML)
    rep._frontier = FRONTIER
    nf, ml = np.array(NF, np.int64), np.array(ML, np.int64)
    per_key = np.minimum((FRONTIER - WIN_P - nf) // SLIDE_P,
                         (ml - nf) // SLIDE_P) + 1
    n_steps = -(-int(np.maximum(per_key, 0).max(initial=0)) // ROUNDS)
    emitted.clear()
    for _ in range(n_steps - 1):
        rep._run_steps(np.zeros(0, np.int32), np.zeros(0, np.int32),
                       rep._empty_vals())
    assert probe_fires() > 0


# ---------------------------------------------------------------------------
# late-record conservation (the mesh case of
# tests/test_event_time_health.py::test_late_conservation_invariant)
# ---------------------------------------------------------------------------
def _late_conservation_src(shipper, ctx):
    """The deterministic late stream of ``test_event_time_health.py``."""
    import test_event_time_health as eth
    return eth.late_src(shipper, ctx)


def _late_counts(pkg):
    import test_event_time_health as eth
    kw = {} if pkg is wj else {"device": "cpu"}
    g = pkg.PipeGraph("late_mesh", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT_TIME, **kw)
    results = []
    B = Ffat_Windows_TPU_Builder if pkg is wj else wt.Ffat_Windows_GPU_Builder
    op = (B(lambda f: {"value": f["value"]},
            lambda a, b: {"value": a["value"] + b["value"]})
          .with_key_by("key").with_tb_windows(eth.WIN, eth.SLIDE)
          .with_lateness(eth.LATENESS).with_name("win")
          .with_key_capacity(eth.N_KEYS).with_mesh().build())
    g.add_source(pkg.Source_Builder(_late_conservation_src)
                 .with_output_batch_size(eth.OBS).build()) \
        .add(op).add_sink(pkg.Sink_Builder(
            lambda r: results.append(r) if r is not None else None).build())
    run_bounded(g)
    assert results
    win = next(o for o in g.get_stats()["Operators"] if o["name"] == "win")
    return {k: sum(r.get(k, 0) for r in win["replicas"])
            for k in ("Inputs_received", "Late_records", "Late_dropped",
                      "Late_admitted")}


def _assert_conserved(st, n):
    """Every input classified once: on time, admitted late or dropped."""
    assert st["Inputs_received"] == n, st
    on_time = st["Inputs_received"] - st["Late_records"]
    assert on_time + st["Late_admitted"] + st["Late_dropped"] == n, st
    assert st["Late_admitted"] == st["Late_records"] - st["Late_dropped"]


def test_late_conservation_invariant_mesh():
    """Exact conservation and the model's counts on the port. The JAX
    mesh cuts its batches on timers wherever the scheduler puts them, so
    its counts follow the scheduling: it is held to conservation only."""
    import test_event_time_health as eth
    exp_admit, exp_drop = eth.expected_late_counts()
    st = _late_counts(wt)
    _assert_conserved(st, eth.N)
    assert st["Late_admitted"] == exp_admit > 0, st
    assert st["Late_dropped"] == exp_drop > 0, st
    _assert_conserved(_late_counts(wj), eth.N)


# ---------------------------------------------------------------------------
# the forest over card groups (every group on the CPU here)
# ---------------------------------------------------------------------------
GROUP_CASES = [((8, 1), 8), ((4, 2), 2), ((4, 2), 8), ((2, 4), 4)]


@pytest.mark.parametrize("shape,groups", GROUP_CASES,
                         ids=[f"{s[0]}x{s[1]}-g{g}" for s, g in GROUP_CASES])
def test_mesh_groups_match_one_group(shape, groups):
    """Ffat_Windows_Mesh over card groups gives the one-group run's rows
    (every row, invalid windows included), the JAX package's and the
    oracle's; at (4, 2) over 8 groups and (2, 4) over 4 the 'data' merge
    crosses groups."""
    one, _ = _run(wt, _make_src(N_KEYS, STREAM_LEN), 64, mesh_shape=shape)
    ct.ensure_virtual_devices(8, group_devices=["cpu"] * groups)
    _, got, g = _both(_make_src(N_KEYS, STREAM_LEN), 64, mesh_shape=shape)
    assert got.rows == one.rows
    assert got.valid == _oracle(N_KEYS, STREAM_LEN, WIN_US, SLIDE_US)
    (rep,) = g.get_stats()["Operators"][1]["replicas"]
    assert rep["Mesh_devices"] == 8
    r = next(op.replicas[0] for op in g._ops
             if getattr(op, "is_mesh", False))
    assert r._mesh.n_groups == groups
    assert r._mesh.copied_bytes > 0


def test_mesh_groups_late_conservation():
    """The late counters of a mesh over 4 groups (summed on the host over
    the groups' read-backs) conserve the inputs as the one-group run's
    do, with the model's counts."""
    import test_event_time_health as eth
    exp_admit, exp_drop = eth.expected_late_counts()
    one = _late_counts(wt)
    ct.ensure_virtual_devices(8, group_devices=["cpu"] * 4)
    st = _late_counts(wt)
    assert st == one
    assert st["Late_admitted"] == exp_admit > 0, st
    assert st["Late_dropped"] == exp_drop > 0, st
