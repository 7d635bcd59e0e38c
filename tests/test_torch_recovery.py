"""Kill-and-restore of device graphs in the port, held against the JAX
package: the ``_ffat_tpu_graph`` and ``_stateful_map_tpu_graph`` recovery
scenarios of ``tests/test_checkpoint_recovery.py`` at three kill points,
the fused device chain (its blob carries ``__fused__`` and one positional
sub-state per sub-op) and the refusal to restore into a differently fused
topology, a tiered stateful map (hot table and cold image both restored),
and the restore of a PORT graph from a JAX-written checkpoint through
``convert.checkpoint_states_from_jax``.

The harness (the JAX test's): a golden uninterrupted run; a run that
requests a checkpoint after ``ckpt_at`` tuples and dies at ``crash_at``
(an exception inside the source functor: the unwind path of a replica
crash); a restored run from the committed checkpoint that replays the
source from its recorded position. Sinks are idempotent keyed stores, so
the merged crash + restore results must equal the golden run — and the
golden runs of the two packages must be equal.

Tolerance: exact (integer window sums and running sums; the tiered scan's
float32 running sums add in each key's arrival order on both sides)."""

from __future__ import annotations

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.checkpoint import CheckpointStore as StoreJ
from windflow_tpu.tpu.builders_tpu import (Ffat_Windows_TPU_Builder,
                                           Filter_TPU_Builder,
                                           Map_TPU_Builder)
from windflow_tpu_torch.checkpoint import CheckpointStore as StoreT
from windflow_tpu_torch.convert import checkpoint_states_from_jax


class InjectedCrash(Exception):
    pass


class ReplaySource:
    """Integers 0..n-1 keyed ``v % nk``; a checkpoint requested after
    ``ckpt_at`` pushes, a crash injected at ``crash_at``."""

    def __init__(self, n, nk=5, ckpt_at=None, crash_at=None, fvals=False):
        self.n, self.nk = n, nk
        self.ckpt_at, self.crash_at = ckpt_at, crash_at
        self.fvals = fvals
        self.pos = 0
        self.first = None  # the position of the first push

    def __call__(self, shipper):
        while self.pos < self.n:
            if self.crash_at is not None and self.pos == self.crash_at:
                raise InjectedCrash(f"killed at tuple {self.pos}")
            v = self.pos
            if self.first is None:
                self.first = v
            shipper.push({"k": v % self.nk,
                          "v": float(v + 1) if self.fvals else v})
            self.pos += 1
            if self.ckpt_at is not None and self.pos == self.ckpt_at:
                assert shipper.request_checkpoint() is not None

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _graph(pkg, name, store, fusion=True, megabatch=1):
    kw = {} if pkg is wj else {"device": "cpu", "fusion": fusion,
                               "megabatch": megabatch}
    g = pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **kw)
    g.with_checkpointing(store_dir=store)
    return g


def _ffat_graph(pkg, store, src, results, tmp):
    Ffat = Ffat_Windows_TPU_Builder if pkg is wj \
        else wt.Ffat_Windows_GPU_Builder
    g = _graph(pkg, "ck_ffat", store)
    ff = (Ffat(lambda f: {"s": f["v"]}, lambda a, b: {"s": a["s"] + b["s"]})
          .with_key_by("k").with_cb_windows(4, 2).with_name("ffat").build())

    def sink(t):
        if t is not None:
            results[(int(t["k"]), int(t["wid"]))] = int(t["s"])

    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(64).build()) \
        .add(ff) \
        .add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    return g


def _max_sink(results):
    def sink(t):
        # running per-key prefix sums increase strictly: the per-key max
        # is idempotent under replay
        if t is not None:
            k, v = int(t["k"]), t["v"]
            results[k] = max(v, results.get(k, -1))
    return sink


def _smap(pkg):
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    return (Map(lambda row, state: (
        {"k": row["k"], "v": row["v"] + state["acc"]},
        {"acc": state["acc"] + row["v"]}))
        .with_key_by("k").with_state({"acc": np.int64(0)})
        .with_name("smap"))


def _smap_graph(pkg, store, src, results, tmp):
    g = _graph(pkg, "ck_smap", store)
    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(64).build()) \
        .add(_smap(pkg).build()) \
        .add_sink(pkg.Sink_Builder(_max_sink(results)).with_name("snk")
                  .build())
    return g


def _fused_chain_graph(pkg, store, src, results, tmp, fusion=True,
                       megabatch=1):
    """Stateful map ∘ filter ∘ map chained: fused into ONE device replica
    when fusion is on."""
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    Filter = Filter_TPU_Builder if pkg is wj else wt.Filter_GPU_Builder
    g = _graph(pkg, "ck_fused", store, fusion, megabatch)
    flt = Filter(lambda f: f["v"] % 3 != 0).with_name("fodd").build()
    mtail = Map(lambda f: {**f, "v": f["v"] * 2}).with_name("mtail").build()
    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(64).build()) \
        .add(_smap(pkg).build()).chain(flt).chain(mtail) \
        .add_sink(pkg.Sink_Builder(_max_sink(results)).with_name("snk")
                  .build())
    return g


def _tiered_graph(pkg, store, src, results, tmp):
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    g = _graph(pkg, "ck_tier", store)
    scan = (Map(lambda row, st: ({"k": row["k"], "v": st + row["v"]},
                                 st + row["v"]))
            .with_state(np.float32(0)).with_key_by("k")
            .with_tiering(policy="lru", hot_capacity=8, db_dir=tmp)
            .with_name("scan").build())
    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(8).build()) \
        .add(scan) \
        .add_sink(pkg.Sink_Builder(_max_sink(results)).with_name("snk")
                  .build())
    return g


def _run_crash_restart(pkg, builder, tmp, n=2000, ckpt_at=600,
                       crash_at=1200, nk=5, fvals=False):
    """Golden run, crash run, restore run; returns (golden, merged,
    store root). The restore must be one, never a fresh start: its source
    resumes at the checkpoint's position, and (windows) no window that
    the checkpoint had fired fires again."""
    golden = {}
    run_bounded(builder(pkg, str(tmp / "gold_store"),
                        ReplaySource(n, nk, fvals=fvals), golden,
                        str(tmp / "gold")))
    store = str(tmp / "store")
    crash_res = {}
    g = builder(pkg, store,
                ReplaySource(n, nk, ckpt_at=ckpt_at, crash_at=crash_at,
                             fvals=fvals),
                crash_res, str(tmp / "crash"))
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    assert g._coordinator.completed == 1, "checkpoint must commit pre-crash"
    restore_res = {}
    src = ReplaySource(n, nk, fvals=fvals)
    g2 = builder(pkg, store, src, restore_res, str(tmp / "restore"))
    run_bounded(g2, restore_from=store)
    assert src.first == ckpt_at, "the restored source did not resume at " \
        "the checkpoint's position"
    if builder is _ffat_graph:
        Store = StoreJ if pkg is wj else StoreT
        _, ckpt_dir, manifest = Store.resolve(store)
        ff = Store(store).load_states(ckpt_dir, manifest)[("ffat", 0)]
        fired = {int(k): int(ff["ffat"]["fired"][s])
                 for k, s in ff["ffat"]["slot_of_key"].items()}
        assert any(fired.values())
        assert all(w >= fired.get(k, 0) for k, w in restore_res), \
            "the restored run fired again a window the checkpoint had fired"
        # windows: the restored run re-fires the crash run's partial ones
        merged = {**crash_res, **restore_res}
    else:
        merged = {k: max(crash_res.get(k, -1), restore_res.get(k, -1))
                  for k in set(crash_res) | set(restore_res)}
    return golden, merged, store


@pytest.mark.parametrize("crash_at", [700, 1201, 1999])
@pytest.mark.parametrize("builder", [_ffat_graph, _smap_graph],
                         ids=["ffat", "stateful_map"])
def test_crash_matrix_kill_points(builder, crash_at, tmp_path):
    got = {}
    for pkg, name in ((wj, "j"), (wt, "t")):
        golden, merged, _ = _run_crash_restart(pkg, builder,
                                               tmp_path / name,
                                               crash_at=crash_at)
        assert merged == golden and len(golden) > 0
        got[name] = golden
    assert got["j"] == got["t"]


def test_recovery_fused_device_chain(tmp_path, monkeypatch):
    monkeypatch.setenv("WF_TPU_FUSION", "1")  # the JAX side
    got = {}
    for pkg, name in ((wj, "j"), (wt, "t")):
        golden, merged, store = _run_crash_restart(
            pkg, _fused_chain_graph, tmp_path / name)
        assert merged == golden and len(golden) > 0
        got[name] = golden
        # the committed blob holds the fused signature and one POSITIONAL
        # entry per sub-op (index 0 = the stateful map's table)
        Store = StoreJ if pkg is wj else StoreT
        _, ckpt_dir, manifest = Store.resolve(store)
        states = Store(store).load_states(ckpt_dir, manifest)
        fused = {k: v for k, v in states.items() if k[0] == "smap"}
        assert fused, "the fused chain's blob is keyed by its head op"
        for state in fused.values():
            assert state["__fused__"] == ["smap", "fodd", "mtail"]
            subs = state["fused_sub_states"]
            assert len(subs) == 3
            assert subs[0] is not None and subs[0]["table"] is not None
            assert isinstance(subs[0]["table"]["acc"], np.ndarray)
            assert subs[1] is None and subs[2] is None
    assert got["j"] == got["t"]


def test_recovery_fused_chain_megabatch(tmp_path, monkeypatch):
    """The fused chain at megabatch 4: the dispatch queue groups queued
    commits, and a checkpoint must close an open group (the worker's
    ``drain(forced=True)``) before the barrier goes out, or pre-barrier
    rows would land behind it. The merged output equals the golden run,
    in both packages (the JAX package's ``WF_MEGABATCH``)."""
    monkeypatch.setenv("WF_TPU_FUSION", "1")
    monkeypatch.setenv("WF_MEGABATCH", "4")
    loops = []

    def mb(pkg, store, src, results, tmp):
        g = _fused_chain_graph(pkg, store, src, results, tmp, megabatch=4)
        loops.append(g)
        return g

    got = {}
    for pkg, name in ((wj, "j"), (wt, "t")):
        golden, merged, _ = _run_crash_restart(pkg, mb, tmp_path / name,
                                               n=4000, ckpt_at=1900,
                                               crash_at=3100)
        assert merged == golden and len(golden) > 0
        got[name] = golden
    assert got["j"] == got["t"]
    # the port's crash run grouped commits (the queue really ran groups)
    crash = loops[-2]
    reps = [r for op in crash.get_stats()["Operators"]
            for r in op["replicas"]]
    assert sum(r["Megabatch_loops"] for r in reps) > 0


def test_restore_into_differently_fused_topology_fails(tmp_path,
                                                       monkeypatch):
    """A checkpoint of a FUSED chain refuses to restore into an unfused
    build of the same pipeline, and the other way round, in both
    packages, instead of dropping the per-sub-op state."""
    for pkg, name in ((wj, "j"), (wt, "t")):
        def build(store, fused, ckpt_at=None, _pkg=pkg, _name=name):
            monkeypatch.setenv("WF_TPU_FUSION", "1" if fused else "0")
            return _fused_chain_graph(
                _pkg, str(tmp_path / _name / store),
                ReplaySource(800, ckpt_at=ckpt_at), {},
                str(tmp_path / _name), fusion=fused)

        fused_attr = "is_fused_tpu" if pkg is wj else "is_fused_gpu"
        g = build("s1", True, ckpt_at=300)
        run_bounded(g)
        assert g._coordinator.completed == 1
        g_unfused = build("s2", False)
        assert not any(getattr(s, fused_attr) for s in g_unfused._stages)
        with pytest.raises(pkg.WindFlowError, match="fused"):
            run_bounded(g_unfused, restore_from=str(tmp_path / name / "s1"))
        g3 = build("s3", False, ckpt_at=300)
        run_bounded(g3)
        assert g3._coordinator.completed == 1
        g4 = build("s4", True)
        assert any(getattr(s, fused_attr) for s in g4._stages)
        with pytest.raises(pkg.WindFlowError, match="fused"):
            run_bounded(g4, restore_from=str(tmp_path / name / "s3"))


def test_tiered_kill_and_restore_both_tiers(tmp_path):
    """A tiered running-sum scan (8 hot slots, 20 keys) killed after a
    checkpoint: the restore brings back the hot table AND the cold sqlite
    image (a key demoted before the checkpoint resumes its sum)."""
    got = {}
    for pkg, name in ((wj, "j"), (wt, "t")):
        golden, merged, _ = _run_crash_restart(
            pkg, _tiered_graph, tmp_path / name, n=1000, ckpt_at=480,
            crash_at=700, nk=20, fvals=True)
        assert merged == golden and len(golden) == 20
        got[name] = golden
    assert got["j"] == got["t"]


class _Ranged(ReplaySource):
    """Keys ``lo..lo+nk-1`` and values ``v`` from ``off``: one of two
    sources of disjoint keys."""

    def __init__(self, n, lo, off, **kw):
        super().__init__(n, **kw)
        self.lo, self.off = lo, off

    def __call__(self, shipper):
        while self.pos < self.n:
            if self.crash_at is not None and self.pos == self.crash_at:
                raise InjectedCrash(f"killed at tuple {self.pos}")
            v = self.pos
            shipper.push({"k": self.lo + v % self.nk, "v": self.off + v})
            self.pos += 1
            if self.ckpt_at is not None and self.pos == self.ckpt_at:
                assert shipper.request_checkpoint() is not None


def _merged_ffat_graph(pkg, store, srcs, results):
    """Two sources of disjoint keys merged into one FFAT window: the
    window's worker aligns the barrier over two channels and its
    collector's per-channel watermarks ride the blob."""
    Ffat = Ffat_Windows_TPU_Builder if pkg is wj \
        else wt.Ffat_Windows_GPU_Builder
    g = _graph(pkg, "ck_merge", store)
    pa, pb = (g.add_source(pkg.Source_Builder(s).with_name(f"src{i}")
                           .with_output_batch_size(32).build())
              for i, s in enumerate(srcs))
    ff = (Ffat(lambda f: {"s": f["v"]}, lambda a, b: {"s": a["s"] + b["s"]})
          .with_key_by("k").with_cb_windows(4, 2).with_name("ffat").build())

    def sink(t):
        if t is not None:
            results[(int(t["k"]), int(t["wid"]))] = int(t["s"])

    pa.merge(pb).add(ff) \
        .add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    return g


def test_merged_sources_kill_and_restore(tmp_path):
    """Kill-and-restore across a merge: source 0 requests the checkpoint
    and later dies; the restored graph resumes BOTH sources from their
    barrier positions, and the window replica's blob carries the merge
    collector's per-channel watermarks."""
    def srcs(**kw0):
        return [_Ranged(1500, 0, 0, **kw0), _Ranged(1200, 5, 10_000)]

    got = {}
    for pkg, name in ((wj, "j"), (wt, "t")):
        golden = {}
        run_bounded(_merged_ffat_graph(pkg, str(tmp_path / name / "g"),
                                       srcs(), golden))
        store = str(tmp_path / name / "s")
        crash = {}
        g = _merged_ffat_graph(pkg, store,
                               srcs(ckpt_at=500, crash_at=1000), crash)
        with pytest.raises(InjectedCrash):
            run_bounded(g)
        assert g._coordinator.completed == 1
        Store = StoreJ if pkg is wj else StoreT
        _, d, manifest = Store.resolve(store)
        states = Store(store).load_states(d, manifest)
        assert states[("src0", 0)]["position"] == 500
        assert len(states[("ffat", 0)]["__collector__"]["ch_wm"]) == 2
        restored = {}
        run_bounded(_merged_ffat_graph(pkg, store, srcs(), restored),
                    restore_from=store)
        assert {**crash, **restored} == golden and len(golden) > 0
        got[name] = golden
    assert got["j"] == got["t"]


@pytest.mark.parametrize("builder", [_ffat_graph, _smap_graph,
                                     _fused_chain_graph],
                         ids=["ffat", "stateful_map", "fused"])
def test_port_restores_a_jax_checkpoint(builder, tmp_path, monkeypatch):
    """The JAX graph dies after its first committed checkpoint; that
    checkpoint, loaded through the JAX store and converted, restores the
    PORT graph of the same topology, whose source replays from the
    snapshot position: the merged results equal the golden run."""
    monkeypatch.setenv("WF_TPU_FUSION", "1")
    golden = {}
    run_bounded(builder(wt, str(tmp_path / "gold_store"), ReplaySource(2000),
                        golden, str(tmp_path / "gold")))
    jstore = str(tmp_path / "jax_store")
    crash_res = {}
    gj = builder(wj, jstore, ReplaySource(2000, ckpt_at=600,
                                          crash_at=1200),
                 crash_res, str(tmp_path / "crash"))
    with pytest.raises(InjectedCrash):
        run_bounded(gj)
    assert gj._coordinator.completed == 1
    _, ckpt_dir, manifest = StoreJ.resolve(jstore)
    states = checkpoint_states_from_jax(
        StoreJ(jstore).load_states(ckpt_dir, manifest), "cpu")
    assert states[("src", 0)]["position"] == 600
    restore_res = {}
    gt = builder(wt, str(tmp_path / "port_store"), ReplaySource(2000),
                 restore_res, str(tmp_path / "restore"))
    run_bounded(gt, restore_from=states)
    if builder is _ffat_graph:
        merged = {**crash_res, **restore_res}
    else:
        merged = {k: max(crash_res.get(k, -1), restore_res.get(k, -1))
                  for k in set(crash_res) | set(restore_res)}
    assert merged == golden and len(golden) > 0
