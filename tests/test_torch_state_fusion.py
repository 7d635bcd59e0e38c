"""Stateful sub-ops in fused device chains (kinds ``smap`` / ``sfilter``
of ``windflow_tpu_torch/gpu/fused_ops.py``), megabatch with the state
tables threaded from batch to batch, fused snapshots and the fusion
legality of keyed sub-ops, held against the JAX package's
``FusedTPUReplica`` (``WF_TPU_FUSION`` / ``WF_MEGABATCH`` set for the JAX
side only, its CPU backend).

Tolerance: EXACT (int32 states and values; each key's fold runs in
arrival order in both packages). Row sequences are compared at
parallelism 1 with block-aligned columnar input, multisets above it.
Refusal reasons equal the JAX package's with ``_TPU`` -> ``_GPU``."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.tpu import (Ffat_Windows_TPU_Builder, Filter_TPU_Builder,
                              Map_TPU_Builder, Reduce_TPU_Builder)
from windflow_tpu.tpu.batch import BatchTPU
from windflow_tpu.tpu.fused_ops import FusedTPUReplica
from windflow_tpu.tpu.ops_tpu import Filter_TPU, Map_TPU
from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
from windflow_tpu_torch.convert import fused_state_from_jax
from windflow_tpu_torch.gpu.batch import BatchGPU
from windflow_tpu_torch.gpu.fused_ops import FusedGPUReplica
from windflow_tpu_torch.gpu.ops_gpu import Filter_GPU, Map_GPU
from windflow_tpu_torch.gpu.schema import TupleSchema
from windflow_tpu_torch.runtime import dispatch

from common import TupleT, make_ingress_source

N_KEYS = 5


def _b(pkg):
    if pkg is wj:
        return (Map_TPU_Builder, Filter_TPU_Builder, Reduce_TPU_Builder,
                jnp.int32, jnp.maximum)
    return (wt.Map_GPU_Builder, wt.Filter_GPU_Builder, wt.Reduce_GPU_Builder,
            np.int32, torch.maximum)


def _graph(pkg, monkeypatch, fusion, name, policy="INGRESS_TIME",
           megabatch=1):
    if pkg is wj:
        monkeypatch.setenv("WF_TPU_FUSION", "1" if fusion else "0")
        monkeypatch.setenv("WF_MEGABATCH", str(megabatch))
        return wj.PipeGraph(name, wj.ExecutionMode.DEFAULT,
                            getattr(wj.TimePolicy, policy))
    return wt.PipeGraph(name, wt.ExecutionMode.DEFAULT,
                        getattr(wt.TimePolicy, policy), device="cpu",
                        fusion=fusion, megabatch=megabatch)


def _step(row, state):
    s2 = {"total": state["total"] + row["value"]}
    return {**row, "value": s2["total"]}, s2


def _fused_kind(pkg):
    return "Fused_TPU_Chain" if pkg is wj else "Fused_GPU_Chain"


# ---------------------------------------------------------------------------
# test_fusion.py:72 — the stateful map -> filter -> map chain
# ---------------------------------------------------------------------------
def _three_op(pkg, monkeypatch, fusion, p):
    Map, Filter, _, i32, _ = _b(pkg)
    rows, lock = [], threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                rows.append((int(t.key), int(t.value)))

    g = _graph(pkg, monkeypatch, fusion, "fusion")
    src = (pkg.Source_Builder(make_ingress_source(N_KEYS, 60))
           .with_parallelism(2).with_output_batch_size(16).build())
    m1 = (Map(_step).with_key_by("key").with_state({"total": i32(0)})
          .with_name("m1").with_parallelism(p).build())
    flt = (Filter(lambda f: f["value"] % 2 == 0).with_name("f1")
           .with_parallelism(p).build())
    m2 = (Map(lambda f: {**f, "value": f["value"] + 7}).with_name("m2")
          .with_parallelism(p).build())
    g.add_source(src).add(m1).chain(flt).chain(m2) \
        .add_sink(pkg.Sink_Builder(sink).build())
    run_bounded(g)
    fused = [o for o in g.get_stats()["Operators"]
             if o["kind"] == _fused_kind(pkg)]
    return sorted(rows), fused


@pytest.mark.parametrize("p", [1, 2])
def test_stateful_chain_matches_jax(monkeypatch, p):
    """Fused (one replica per slot, one program per batch), unfused and
    the JAX package's fused chain: the same multiset of rows."""
    got, fused = _three_op(wt, monkeypatch, True, p)
    plain, nofuse = _three_op(wt, monkeypatch, False, p)
    ref, jfused = _three_op(wj, monkeypatch, True, p)
    assert got == plain == ref and got
    assert len(fused) == len(jfused) == 1 and not nofuse
    assert fused[0]["name"] == "m1∘f1∘m2"
    for r in fused[0]["replicas"]:
        assert r["Fused_ops"] == 3
        assert r["Device_programs_run"] == r["Device_batches_in"] > 0


# ---------------------------------------------------------------------------
# row sequences at parallelism 1, tables and dirty bitmaps
# ---------------------------------------------------------------------------
CHAINS = ["smap_filter_map", "sfilter_smap", "smap_sfilter_kreduce",
          "map_smap_reduce"]


def _blocks(n_blocks=40, seed=17, n_keys=8, batch=16):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        ts = b * batch + np.arange(batch, dtype=np.int64)
        out.append(({"key": rng.integers(0, n_keys, batch).astype(np.int32),
                     "value": rng.integers(0, 100, batch).astype(np.int32)},
                    ts, int(ts[0])))
    return out


def _chain_ops(pkg, chain):
    Map, Filter, Reduce, i32, maximum = _b(pkg)

    def run_max(row, state):
        keep = row["value"] > state["mx"]
        return keep, {"mx": maximum(state["mx"], row["value"])}

    smap = (Map(_step).with_key_by("key").with_state({"total": i32(0)})
            .with_name("sm"))
    sfilter = (Filter(run_max).with_key_by("key")
               .with_state({"mx": i32(0)}).with_name("sf"))
    kred = (Reduce(lambda a, b: {"key": b["key"],
                                 "value": a["value"] + b["value"]})
            .with_key_by("key").with_name("kr"))
    gred = Reduce(lambda a, b: {"key": b["key"],
                                "value": a["value"] + b["value"]}) \
        .with_name("gr")
    flt = Filter(lambda f: f["value"] % 3 != 0).with_name("f")
    mp = Map(lambda f: {**f, "value": f["value"] + 1}).with_name("m")
    return {"smap_filter_map": [smap, flt, mp],
            "sfilter_smap": [sfilter, smap],
            "smap_sfilter_kreduce": [smap, sfilter, kred],
            "map_smap_reduce": [mp.with_key_by("key"), smap, gred]}[chain]


def _run_chain(pkg, monkeypatch, chain, fusion=True, megabatch=1,
               blocks=None):
    """Columnar blocks -> the chain (built with ``chain``) -> columnar sink
    at parallelism 1: the sink's batches in order, the fused stage's stats
    and the engines (one per stateful sub-op, in chain order)."""
    blocks = _blocks() if blocks is None else blocks
    g = _graph(pkg, monkeypatch, fusion, "chain", "EVENT_TIME", megabatch)
    ops = [b.build() for b in _chain_ops(pkg, chain)]
    mp = g.add_source(pkg.Columnar_Source_Builder(lambda: iter(blocks))
                      .with_output_batch_size(16).build()).add(ops[0])
    for op in ops[1:]:
        mp = mp.chain(op)
    out, lock = [], threading.Lock()

    def sink(cols, ts):
        if cols is not None:
            with lock:
                out.append(({k: np.array(v) for k, v in cols.items()},
                            np.array(ts)))

    mp.add_sink(pkg.Sink_Builder(sink).with_columns().build())
    run_bounded(g)
    fused = [o["replicas"][0] for o in g.get_stats()["Operators"]
             if o["kind"] == _fused_kind(pkg)]
    if fusion:
        engines = [s.engine for s in ops[0].replicas[0].specs
                   if s.engine is not None]
    else:
        engines = [op.replicas[0].engine for op in ops
                   if getattr(op, "state_init", None) is not None]
    return out, fused, engines


def _engine_state(eng):
    snap = eng.snapshot_state()
    t = snap["table"]
    cap = eng.table_capacity
    return (snap["slot_of_key"], cap,
            [np.asarray(t[k]) for k in sorted(t)],
            np.asarray(eng.dirty)[:cap].astype(bool))


def _assert_batches(got, ref):
    assert len(got) == len(ref) and got
    for (gc, gts), (rc, rts) in zip(got, ref):
        assert np.array_equal(gts, rts)
        assert gc.keys() == rc.keys()
        for c in rc:
            assert gc[c].dtype == rc[c].dtype and np.array_equal(gc[c],
                                                                 rc[c]), c


def _assert_engines(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        sa, ca, ta, da = _engine_state(a)
        sb, cb, tb, db = _engine_state(b)
        assert sa == sb and ca == cb and np.array_equal(da, db)
        assert all(np.array_equal(x, y) for x, y in zip(ta, tb))


@pytest.mark.parametrize("chain", CHAINS)
def test_stateful_chain_rows_tables_and_dirty_match_jax(monkeypatch, chain):
    """Every chain kind with stateful sub-ops: the fused port's batches
    equal the JAX package's fused batches in order, and each sub-op's
    table, slot map and dirty bitmap equal the JAX engine's — a row an
    ``sfilter`` dropped leaves its key's state in the next ``smap``
    untouched, while its slot is still marked dirty (both bitmaps are
    conservative)."""
    got, fused, teng = _run_chain(wt, monkeypatch, chain)
    ref, jfused, jeng = _run_chain(wj, monkeypatch, chain)
    _assert_batches(got, ref)
    _assert_engines(teng, jeng)
    assert fused[0]["Inputs_ignored"] == jfused[0]["Inputs_ignored"]
    assert fused[0]["Device_programs_run"] == fused[0]["Dispatch_batches"]


@pytest.mark.parametrize("chain", ["smap_filter_map", "sfilter_smap"])
def test_stateful_chain_fused_equals_unfused(monkeypatch, chain):
    got, _, teng = _run_chain(wt, monkeypatch, chain)
    plain, nofuse, peng = _run_chain(wt, monkeypatch, chain, fusion=False)
    assert not nofuse
    key = lambda out: sorted(  # noqa: E731
        (int(k), int(v)) for c, _ in out
        for k, v in zip(c["key"], c["value"]))
    assert key(got) == key(plain)
    _assert_engines(teng, peng)


@pytest.mark.parametrize("k", [4, 8])
@pytest.mark.parametrize("chain", ["smap_filter_map",
                                   "smap_sfilter_kreduce"])
def test_megabatch_threads_state_like_k1(monkeypatch, chain, k):
    """Megabatch K: each body of the group reads the tables as the body
    before it left them (the ``lax.scan`` carry), so the batches, the
    tables and the dirty bitmaps equal K=1's and the JAX package's K-scan
    run's."""
    base, r1, eng1 = _run_chain(wt, monkeypatch, chain)
    got, rk, engk = _run_chain(wt, monkeypatch, chain, megabatch=k)
    ref, _, jeng = _run_chain(wj, monkeypatch, chain, megabatch=k)
    _assert_batches(got, base)
    _assert_batches(got, ref)
    _assert_engines(engk, eng1)
    _assert_engines(engk, jeng)
    assert r1[0]["Megabatch_loops"] == 0
    assert rk[0]["Megabatch_loops"] > 0 and rk[0]["Megabatch_max"] <= k


def test_megabatch_stateful_eos_inflight(monkeypatch):
    """``test_megabatch.py:347``: a 64-deep queue and megabatch 8; EOS
    finds the queue near full of commits in flight, drains them as
    singles, and the rows equal K=1's and the JAX package's."""
    monkeypatch.setattr(dispatch, "DISPATCH_DEPTH", 64)
    monkeypatch.setenv("WF_DISPATCH_DEPTH", "64")

    def run(pkg, megabatch):
        Map, Filter, _, i32, _ = _b(pkg)
        rows, lock = [], threading.Lock()

        def sink(t):
            if t is not None:
                with lock:
                    rows.append((int(t.key), int(t.value)))

        g = _graph(pkg, monkeypatch, True, "mb_state", megabatch=megabatch)

        def src(shipper, ctx):
            for i in range(600):
                for k in range(N_KEYS):
                    shipper.push(TupleT(k, i + 1 + k))

        g.add_source(pkg.Source_Builder(src).with_output_batch_size(16)
                     .build()) \
            .add(Map(_step).with_key_by("key")
                 .with_state({"total": i32(0)}).with_name("sm").build()) \
            .chain(Filter(lambda f: f["value"] % 2 == 0).with_name("sf")
                   .build()) \
            .add_sink(pkg.Sink_Builder(sink).build())
        run_bounded(g)
        fused = next(o for o in g.get_stats()["Operators"]
                     if o["kind"] == _fused_kind(pkg))
        return sorted(rows), fused["replicas"][0]

    base, _ = run(wt, 1)
    got, r = run(wt, 8)
    ref, _ = run(wj, 1)
    assert got == base == ref and got
    assert r["Megabatch_loops"] > 0  # groups formed mid-stream


# ---------------------------------------------------------------------------
# fused snapshot / restore
# ---------------------------------------------------------------------------
class _Collect:
    def __init__(self, to_host):
        self.to_host = to_host
        self.rows = []

    def set_stats(self, stats):
        pass

    def emit_device_batch(self, b):
        cols = {k: np.asarray(v)[:b.size] for k, v in self.to_host(b).items()}
        for i in range(b.size):
            self.rows.append(tuple(cols[n][i].item() for n in sorted(cols)))

    def propagate_punctuation(self, wm):
        pass

    def flush(self):
        pass


def _fused_replica(pkg, names=("sm", "f", "sf")):
    if pkg == "jax":
        Map, Filter, maximum, i32 = Map_TPU, Filter_TPU, jnp.maximum, \
            jnp.int32
    else:
        Map, Filter, maximum, i32 = Map_GPU, Filter_GPU, torch.maximum, \
            np.int32

    def run_max(row, state):
        keep = row["value"] > state["mx"]
        return keep, {"mx": maximum(state["mx"], row["value"])}

    ops = [Map(_step, name=names[0], key_extractor="key",
               state_init={"total": i32(0)}),
           Filter(lambda f: f["value"] % 3 != 0, name=names[1]),
           Filter(run_max, name=names[2], key_extractor="key",
                  state_init={"mx": i32(0)})]
    cls = FusedTPUReplica if pkg == "jax" else FusedGPUReplica
    rep = cls(ops, 0)
    rep.set_emitter(_Collect(
        (lambda b: {k: np.asarray(v) for k, v in b.fields.items()})
        if pkg == "jax" else (lambda b: b.host_columns())))
    return rep


def _feed(rep, blocks):
    jax_side = isinstance(rep, FusedTPUReplica)
    for cols, ts, wm in blocks:
        n = len(ts)
        dts = {k: v.dtype for k, v in cols.items()}
        keys = cols["key"].astype(np.int64)
        if jax_side:
            import jax
            b = BatchTPU({k: jax.device_put(v) for k, v in cols.items()},
                         ts.copy(), n, SchemaJ(dts), wm, host_keys=keys)
        else:
            b = BatchGPU({k: torch.from_numpy(v.copy())
                          for k, v in cols.items()}, ts.copy(), n,
                         TupleSchema(dts), wm, host_keys=keys)
        rep.handle_msg(0, b)
    rep.dispatch.drain()


def test_fused_state_carried_from_jax(monkeypatch):
    """A JAX fused chain's snapshot (one engine state per stateful sub-op,
    None for the stateless one) through ``convert.fused_state_from_jax``
    into a fresh port chain: both continue to the same rows and tables."""
    monkeypatch.setenv("WF_MEGABATCH", "1")
    blocks = _blocks(n_blocks=16, n_keys=90)
    jrep = _fused_replica("jax")
    _feed(jrep, blocks[:8])
    snap = jrep.snapshot_state()
    assert [s is None for s in snap["fused_sub_states"]] == [False, True,
                                                             False]
    jrep.emitter.rows.clear()
    trep = _fused_replica("torch")
    trep.restore_state(fused_state_from_jax(snap, "cpu"))
    _feed(jrep, blocks[8:])
    _feed(trep, blocks[8:])
    assert trep.emitter.rows == jrep.emitter.rows and trep.emitter.rows
    for a, b in zip(trep.specs, jrep.specs):
        if a.engine is not None:
            sa, ca, ta, _ = _engine_state(a.engine)
            sb, cb, tb, _ = _engine_state(b.engine)
            assert (sa, ca) == (sb, cb)
            assert all(np.array_equal(x, y) for x, y in zip(ta, tb))


def test_fused_snapshot_roundtrip_and_refusals():
    """The port's own fused snapshot restores; the three refusals: a
    standalone blob, another chain's blob, a wrong number of sub-states."""
    blocks = _blocks(n_blocks=10, n_keys=12)
    a = _fused_replica("torch")
    _feed(a, blocks[:5])
    snap = a.snapshot_state()
    assert snap["__fused__"] == ["sm", "f", "sf"]
    b = _fused_replica("torch")
    b.restore_state(snap)
    a.emitter.rows.clear()
    _feed(a, blocks[5:])
    _feed(b, blocks[5:])
    assert a.emitter.rows == b.emitter.rows
    fresh = _fused_replica("torch")
    with pytest.raises(wt.WindFlowError, match="holds standalone state"):
        fresh.restore_state({"cur_wm": 0, "scan": {}})
    with pytest.raises(wt.WindFlowError, match="fused-chain mismatch"):
        _fused_replica("torch", ("sm", "f", "other")).restore_state(snap)
    bad = dict(snap, fused_sub_states=snap["fused_sub_states"][:2])
    with pytest.raises(wt.WindFlowError, match="expects 3 per-sub-op"):
        fresh.restore_state(bad)


# ---------------------------------------------------------------------------
# legality: test_fusion.py:234-270 and test_megabatch.py:605
# ---------------------------------------------------------------------------
def _legal(pkg, monkeypatch, name):
    g = _graph(pkg, monkeypatch, True, name)
    src = (pkg.Source_Builder(make_ingress_source(2, 8))
           .with_output_batch_size(8).build())
    return g, g.add_source(src)


def _sm(pkg, name, key="key"):
    Map, _, _, i32, _ = _b(pkg)
    return (Map(lambda r, s: (r, s)).with_key_by(key)
            .with_state({"x": i32(0)}).with_name(name).build())


def _keyed_refusals(pkg, monkeypatch):
    """The reasons recorded by the refused keyed chains, after the legal
    one is checked."""
    Map = _b(pkg)[0]
    reasons = []
    # forward entry + keyed stateful candidate: refuse (needs a shuffle)
    g, mp = _legal(pkg, monkeypatch, "legal")
    mp.add(Map(lambda f: f).with_name("m").build()).chain(_sm(pkg, "sm"))
    stage = g._stages[-1]
    assert stage.describe() == "sm" and "keyed" in stage.chain_refused
    assert "unchained" in stage.describe(diagnostics=True)
    reasons.append(stage.chain_refused)
    # keyed entry + keyed candidate on a DIFFERENT key: refuse
    g2, mp2 = _legal(pkg, monkeypatch, "legal2")
    mp2.add(_sm(pkg, "sm1")).chain(_sm(pkg, "sm2", key="value"))
    stage = g2._stages[-1]
    assert stage.describe() == "sm2" and "keys differ" in stage.chain_refused
    reasons.append(stage.chain_refused)
    # keyed entry + SAME key: fuses
    g3, mp3 = _legal(pkg, monkeypatch, "legal3")
    mp3.add(_sm(pkg, "sma")).chain(_sm(pkg, "smb"))
    assert g3._stages[-1].describe() == "sma∘smb"
    return reasons


def test_keyed_subop_requires_compatible_entry(monkeypatch):
    ref = _keyed_refusals(wj, monkeypatch)
    assert _keyed_refusals(wt, monkeypatch) == [
        r.replace("_TPU", "_GPU") for r in ref]


def test_window_terminator_refuses_stateful_prefix(monkeypatch):
    """``test_megabatch.py:605``: a window terminator needs a STATELESS
    prefix (it runs twice per batch); the same reason in both packages."""
    reasons = []
    for pkg in (wj, wt):
        g, mp = _legal(pkg, monkeypatch, "legal4")
        if pkg is wj:
            win = Ffat_Windows_TPU_Builder(
                lambda f: {"value": f["value"]},
                lambda a, b: {"value": a["value"] + b["value"]})
        else:
            win = wt.Ffat_Windows_GPU_Builder(
                lambda f: {"value": f["value"]}, wt.fieldwise(value="sum"))
        win = win.with_key_by("key").with_cb_windows(4, 2).with_name("w4")
        mp.add(_sm(pkg, "sm")).chain(win.build())
        stage = g._stages[-1]
        assert stage.describe() == "w4"
        assert "stateless map/filter prefix" in stage.chain_refused
        reasons.append(stage.chain_refused)
    assert reasons[0] == reasons[1]


def test_window_chain_refuses_stateful_prefix_at_replica():
    """The fused window replica enforces the legality rule again."""
    from windflow_tpu_torch.gpu.fused_ops import FusedFfatReplica
    sm = Map_GPU(_step, name="sm", key_extractor="key",
                 state_init={"total": np.int32(0)})
    win = (wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                       wt.fieldwise(value="sum"))
           .with_key_by("key").with_cb_windows(4, 2).build())
    with pytest.raises(wt.WindFlowError, match="only stateless"):
        FusedFfatReplica([sm, win], 0)
