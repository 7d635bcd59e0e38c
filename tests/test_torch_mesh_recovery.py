"""Recovery of the port's mesh operators: kill and restore onto ANOTHER
mesh shape (the twins of ``tests/test_checkpoint_recovery.py``'s
``test_mesh_scan_kill_and_restore_onto_different_mesh`` and
``test_mesh_ffat_kill_and_restore_onto_different_mesh``), a JAX-written
mesh checkpoint restored into a port graph through ``convert.py`` onto
another shape, the device-exclusion registry (the twin of
``tests/test_recovery_ladder.py::test_exclusion_registry_clamps_mesh``),
and degrade / re-expand under the port's supervisor.

The port has no exactly-once sink yet, so where the JAX tests compare
committed records the sinks here are idempotent: a replayed row of the
stateful map is identical to the crashed run's, so the DISTINCT rows of
crash + restore equal the golden run's; windows merge by (key, wid) with
the restored run winning (the crash's EOS flushes partial windows).
``test_chaos_mesh_kill``'s output is not used as an oracle (ROADMAP
Queue 3). Tolerance: EXACT (float32 running sums and window sums of
integers below 2^24)."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded, wait_end_bounded
from windflow_tpu.checkpoint import CheckpointStore as StoreJ
from windflow_tpu.tpu import Ffat_Windows_TPU_Builder, Map_TPU_Builder
from windflow_tpu_torch.convert import checkpoint_states_from_jax
from windflow_tpu_torch.mesh import core as ct
from windflow_tpu_torch.supervision.health import failure_domain_map


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


class InjectedCrash(Exception):
    pass


class MeshSrc:
    """Integers 0..n-1 keyed ``v % nk``; a checkpoint requested after
    ``ckpt_at`` pushes, a crash at ``crash_at`` (``crash_times`` times)."""

    def __init__(self, n, nk, ckpt_at=(), crash_at=None, crash_times=None,
                 pace=0.0, on_pos=None):
        self.n, self.nk = n, nk
        self.ckpt_at = set([ckpt_at] if isinstance(ckpt_at, int)
                           else ckpt_at)
        self.crash_at, self.crash_times = crash_at, crash_times
        self.crashes = 0
        self.pace = pace
        self.on_pos = on_pos
        self.pos = 0
        self.first = None

    def __call__(self, shipper):
        while self.pos < self.n:
            if self.crash_at is not None and self.pos == self.crash_at \
                    and (self.crash_times is None
                         or self.crashes < self.crash_times):
                self.crashes += 1
                raise InjectedCrash(f"killed at {self.pos}")
            if self.on_pos is not None:
                self.on_pos(self.pos)
            if self.first is None:
                self.first = self.pos
            v = self.pos
            shipper.push({"k": v % self.nk, "v": float(v + 1)})
            self.pos += 1
            if self.pos in self.ckpt_at:
                assert shipper.request_checkpoint() is not None
            if self.pace:
                time.sleep(self.pace)

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _scan_graph(pkg, store, src, rows, shape, nk, supervise=None,
                probe=None):
    kw = {} if pkg is wj else {"device": "cpu"}
    g = pkg.PipeGraph("mesh_ck", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **kw)
    g.with_checkpointing(store_dir=store)
    if supervise is not None:
        g.with_supervision(supervise)
    if probe is not None:
        g.with_device_probe(probe)
    lock = threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                rows.append((int(t["k"]), float(t["v"]), float(t["run"])))

    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    op = (Map(lambda row, st: ({"k": row["k"], "v": row["v"],
                                "run": st + row["v"]}, st + row["v"]))
          .with_state(np.float32(0)).with_key_by("k")
          .with_mesh(mesh_shape=shape, key_capacity=nk)
          .with_name("mscan").build())
    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(64).build()) \
        .add(op).add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    return g


def test_mesh_scan_kill_and_restore_onto_different_mesh(tmp_path):
    """(8, 1) checkpoint, (2, 4) restore: the per-shard blocks relayout
    across the new shard layout by slot rows, and crash + restore give the
    golden rows, none lost; the JAX package's golden run is the same."""
    n, nk = 800, 7
    golden, gold_j = [], []
    run_bounded(_scan_graph(wt, str(tmp_path / "gs"), MeshSrc(n, nk),
                            golden, (8, 1), nk))
    run_bounded(_scan_graph(wj, str(tmp_path / "gj"), MeshSrc(n, nk),
                            gold_j, (8, 1), nk))
    assert sorted(golden) == sorted(gold_j) and len(golden) == n
    store = str(tmp_path / "store")
    rows = []
    g = _scan_graph(wt, store, MeshSrc(n, nk, ckpt_at=400, crash_at=650),
                    rows, (8, 1), nk)
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    assert g._coordinator.completed == 1
    src = MeshSrc(n, nk)
    run_bounded(_scan_graph(wt, store, src, rows, (2, 4), nk),
                restore_from=store)
    assert src.first == 400
    assert sorted(set(rows)) == sorted(golden)


def _ffat_graph(pkg, store, src, rows, shape, nk):
    kw = {} if pkg is wj else {"device": "cpu"}
    g = pkg.PipeGraph("fm_ck", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT_TIME, **kw)
    g.with_checkpointing(store_dir=store)
    lock = threading.Lock()

    def sink(r):
        if r is None or not r["valid"]:
            return
        with lock:
            rows[(int(r["key"]), int(r["wid"]))] = float(r["value"])

    B = Ffat_Windows_TPU_Builder if pkg is wj else wt.Ffat_Windows_GPU_Builder
    op = (B(lambda f: {"value": f["value"]},
            lambda a, b: {"value": a["value"] + b["value"]})
          .with_key_by("key").with_tb_windows(800, 200)
          .with_key_capacity(nk).with_mesh(mesh_shape=shape)
          .with_name("fwm").build())
    g.add_source(pkg.Source_Builder(src).with_name("src")
                 .with_output_batch_size(64).build()) \
        .add(op).add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    return g


class WinSrc(MeshSrc):
    def __call__(self, shipper):
        while self.pos < self.n:
            if self.crash_at is not None and self.pos == self.crash_at:
                raise InjectedCrash(f"killed at {self.pos}")
            if self.first is None:
                self.first = self.pos
            i = self.pos
            ts = i * 37
            for k in range(self.nk):
                shipper.push_with_timestamp(
                    {"key": k, "value": float(i + 1 + k)}, ts)
            if i % 16 == 15:
                shipper.set_next_watermark(ts)
            self.pos += 1
            if self.pos in self.ckpt_at:
                assert shipper.request_checkpoint() is not None


@pytest.mark.parametrize("dst", [(2, 4), (1, 1)])
def test_mesh_ffat_kill_and_restore_onto_different_mesh(tmp_path, dst):
    """The forest's per-key-shard blocks relayout (rows to the new K_pad,
    leaves pane-remapped) and the merged rows equal the golden run; no
    window the checkpoint had fired fires again."""
    nk, n_steps = 5, 240
    gold = {}
    run_bounded(_ffat_graph(wt, str(tmp_path / "gs"), WinSrc(n_steps, nk),
                            gold, (8, 1), nk))
    gold_j = {}
    run_bounded(_ffat_graph(wj, str(tmp_path / "gj"), WinSrc(n_steps, nk),
                            gold_j, (8, 1), nk))
    assert gold == gold_j and gold
    store = str(tmp_path / "store")
    crash = {}
    g = _ffat_graph(wt, store, WinSrc(n_steps, nk, ckpt_at=120,
                                      crash_at=180), crash, (8, 1), nk)
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    assert g._coordinator.completed == 1
    rest = {}
    src = WinSrc(n_steps, nk)
    run_bounded(_ffat_graph(wt, store, src, rest, dst, nk),
                restore_from=store)
    assert src.first == 120
    from windflow_tpu_torch.checkpoint import CheckpointStore as StoreT
    _, ckpt_dir, manifest = StoreT.resolve(store)
    blob = StoreT(store).load_states(ckpt_dir, manifest)[("fwm", 0)]
    mf = blob["mesh_ffat"]
    # the checkpoint's next window per key (rebased; the slide is one pane)
    fired = np.concatenate(mf["fired"]) + (mf["pane_base"] or 0)
    assert fired.max() > 0
    for (k, w) in rest:
        assert w >= fired[mf["slot_of_key"][k]]
    assert {**crash, **rest} == gold


@pytest.mark.parametrize("kind", ["scan", "ffat"])
def test_port_restores_a_jax_mesh_checkpoint(kind, tmp_path):
    """A JAX mesh graph dies after its checkpoint at (8, 1); the loaded
    checkpoint, converted, restores a PORT graph at (2, 4): merged rows
    equal the golden run."""
    nk = 7 if kind == "scan" else 5
    if kind == "scan":
        n, ckpt, crash, build = 800, 400, 650, _scan_graph
        mk = lambda **kw: MeshSrc(n, nk, **kw)
        golden = []
    else:
        n, ckpt, crash, build = 240, 120, 180, _ffat_graph
        mk = lambda **kw: WinSrc(n, nk, **kw)
        golden = {}
    run_bounded(build(wt, str(tmp_path / "gs"), mk(), golden, (8, 1), nk))
    jstore = str(tmp_path / "jax_store")
    crash_rows = [] if kind == "scan" else {}
    gj = build(wj, jstore, mk(ckpt_at=ckpt, crash_at=crash), crash_rows,
               (8, 1), nk)
    with pytest.raises(InjectedCrash):
        run_bounded(gj)
    assert gj._coordinator.completed == 1
    _, ckpt_dir, manifest = StoreJ.resolve(jstore)
    states = checkpoint_states_from_jax(
        StoreJ(jstore).load_states(ckpt_dir, manifest), "cpu")
    entry = "mesh_scan" if kind == "scan" else "mesh_ffat"
    op = "mscan" if kind == "scan" else "fwm"
    assert states[(op, 0)][entry] is not None
    rest = [] if kind == "scan" else {}
    src = mk()
    run_bounded(build(wt, str(tmp_path / "port_store"), src, rest, (2, 4),
                      nk), restore_from=states)
    assert src.first == ckpt
    if kind == "scan":
        assert sorted(set(crash_rows + rest)) == sorted(golden)
    else:
        assert {**crash_rows, **rest} == golden


# ---------------------------------------------------------------------------
# the device-loss plane
# ---------------------------------------------------------------------------
def test_exclusion_registry_clamps_mesh():
    n_dev = len(ct.visible_devices("cpu"))
    lost = n_dev - 1
    try:
        ct.set_excluded_devices({lost})
        assert ct.excluded_device_ids() == frozenset({lost})
        alive = ct.healthy_devices("cpu")
        assert len(alive) == n_dev - 1
        assert lost not in {i for i, _ in alive}
        mesh = ct.make_key_mesh(n_dev, device="cpu")
        assert mesh.ns == n_dev - 1 and lost not in mesh.device_ids
        # a forced shape that no longer fits degrades to the auto path
        assert ct.make_key_mesh(8, shape=(4, 2), device="cpu").ns == 7
        # a probe gone mad must never produce a zero-device mesh
        ct.set_excluded_devices(range(n_dev))
        assert len(ct.healthy_devices("cpu")) == n_dev
    finally:
        ct.set_excluded_devices(())
    assert ct.excluded_device_ids() == frozenset()
    assert ct.make_key_mesh(n_dev, device="cpu").ns == n_dev


def _mesh_devices(g):
    st = g.get_stats()
    return max((r.get("Mesh_devices", 0) for o in st["Operators"]
                if o["name"] == "mscan" for r in o["replicas"]), default=0)


def test_supervised_degrade_and_reexpand(tmp_path):
    """Supervision with a device probe that reports 4 of the 8 virtual
    devices dead: the crashed graph recovers on the 4 healthy devices
    (``Recovery_degraded_devices`` 4, ``Mesh_devices`` 4), re-expands to
    8 in ONE planned restart when the probe clears them, and the distinct
    rows equal the golden run's."""
    n, nk = 2400, 7
    golden = []
    run_bounded(_scan_graph(wt, str(tmp_path / "gs"), MeshSrc(n, nk),
                            golden, (4, 2), nk))
    probe = wt.StaticDeviceProbe(dead=(4, 5, 6, 7), interval_s=0.02)
    release = threading.Event()

    def hold(pos):
        if pos == int(n * 0.9):
            release.wait(30)  # the tail waits for the 8-device plane

    rows = []
    src = MeshSrc(n, nk, ckpt_at=range(100, n, 100), crash_at=300,
                  crash_times=1, pace=0.002, on_pos=hold)
    g = _scan_graph(wt, str(tmp_path / "store"), src, rows, (4, 2), nk,
                    supervise=wt.RestartPolicy(max_restarts=4,
                                               backoff_s=0.02),
                    probe=probe)
    try:
        g.start()
        deadline = time.time() + 60
        while time.time() < deadline:
            sup = g.get_stats().get("Supervision", {})
            if sup.get("Recovery_degraded_devices", 0) == 4 \
                    and _mesh_devices(g) == 4:
                break
            time.sleep(0.02)
        else:
            pytest.fail("the degraded 4-device recovery never showed")
        assert g.failure_domains() == {d: ["mscan"] for d in range(4)}
        probe.dead.clear()  # the devices return
        while time.time() < deadline:
            sup = g.get_stats().get("Supervision", {})
            if sup.get("Supervision_planned_restarts", 0) >= 1 \
                    and sup.get("Recovery_degraded_devices", 1) == 0:
                break
            time.sleep(0.02)
        else:
            pytest.fail("the planned re-expansion never happened")
        release.set()
        wait_end_bounded(g)
    finally:
        release.set()
    sup = g.get_stats()["Supervision"]
    assert sup["Supervision_restarts"] == 1
    assert sup["Supervision_planned_restarts"] == 1
    assert [h.get("planned", False) for h in sup["Supervision_history"]] \
        == [False, True]
    assert _mesh_devices(g) == 8
    assert failure_domain_map(g) == {d: ["mscan"] for d in range(8)}
    assert sorted(set(rows)) == sorted(golden)


class CommitWaitSrc(MeshSrc):
    """MeshSrc whose requested checkpoints are on disk before the stream
    goes on (bounded wait), so each epoch holds a known position."""

    def __init__(self, n, nk, store, **kw):
        super().__init__(n, nk, **kw)
        self.store = store

    def __call__(self, shipper):
        from windflow_tpu_torch.checkpoint import CheckpointStore
        st = CheckpointStore(self.store)
        while self.pos < self.n:
            if self.crash_at is not None and self.pos == self.crash_at:
                raise InjectedCrash(f"killed at {self.pos}")
            if self.first is None:
                self.first = self.pos
            v = self.pos
            shipper.push({"k": v % self.nk, "v": float(v + 1)})
            self.pos += 1
            if self.pos in self.ckpt_at:
                before = st.latest() or 0
                shipper.request_checkpoint()
                deadline = time.time() + 30
                while (st.latest() or 0) <= before \
                        and time.time() < deadline:
                    time.sleep(0.002)


def test_mesh_scan_delta_checkpoints_restore(tmp_path):
    """``with_checkpointing(delta=True, full_every=3)``: the mesh scan's
    epochs after a FULL base are deltas of per-shard row patches; a kill
    after a delta epoch restores from it (materialized by the store) onto
    another mesh shape, and crash + restore give the golden rows."""
    from windflow_tpu_torch.checkpoint import CheckpointStore

    n, nk = 900, 7
    golden = []
    run_bounded(_scan_graph(wt, str(tmp_path / "gs"), MeshSrc(n, nk),
                            golden, (8, 1), nk))
    store = str(tmp_path / "store")
    rows = []

    def build(src, shape):
        g = _scan_graph(wt, store, src, rows, shape, nk)
        g.with_checkpointing(store_dir=store, delta=True, full_every=3)
        return g

    g = build(CommitWaitSrc(n, nk, store, ckpt_at=(150, 300, 450),
                            crash_at=600), (8, 1))
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    st = CheckpointStore(store)
    assert st.completed_ids() == [1, 2, 3]
    deps = st.load_manifest(st.checkpoint_dir(3)).get("deps") or {}
    assert deps, "the third epoch is a delta against the FULL base"
    src = MeshSrc(n, nk)
    run_bounded(build(src, (2, 4)), restore_from=store)
    assert src.first == 450
    assert sorted(set(rows)) == sorted(golden)


# ---------------------------------------------------------------------------
# card groups (every group on the CPU here): blobs do not depend on the
# group count, and a lost group degrades the mesh to the others
# ---------------------------------------------------------------------------
def _groups(n):
    ct.ensure_virtual_devices(8, group_devices=["cpu"] * n if n > 1
                              else None)


def _mesh_groups(g, name):
    return max((r._mesh.n_groups for o in g._ops if o.name == name
                for r in o.replicas if getattr(r, "_mesh", None)),
               default=0)


@pytest.mark.parametrize("dst", [1, 2], ids=["g1", "g2"])
def test_mesh_ffat_restore_from_four_groups_onto(tmp_path, dst):
    """The forest checkpointed at (4, 2) over 4 groups restores at (2, 4)
    over ``dst`` groups: merged rows equal the golden one-group run."""
    nk, n_steps = 5, 240
    gold = {}
    run_bounded(_ffat_graph(wt, str(tmp_path / "gs"), WinSrc(n_steps, nk),
                            gold, (8, 1), nk))
    _groups(4)
    store = str(tmp_path / "store")
    crash = {}
    g = _ffat_graph(wt, store, WinSrc(n_steps, nk, ckpt_at=120,
                                      crash_at=180), crash, (4, 2), nk)
    with pytest.raises(InjectedCrash):
        run_bounded(g)
    assert g._coordinator.completed == 1 and _mesh_groups(g, "fwm") == 4
    _groups(dst)
    rest = {}
    src = WinSrc(n_steps, nk)
    g2 = _ffat_graph(wt, store, src, rest, (2, 4), nk)
    run_bounded(g2, restore_from=store)
    assert src.first == 120 and _mesh_groups(g2, "fwm") == dst
    assert {**crash, **rest} == gold


@pytest.mark.parametrize("kind", ["scan", "ffat"])
def test_port_restores_a_jax_mesh_checkpoint_onto_groups(kind, tmp_path):
    """A JAX 8-device mesh checkpoint, converted, restores a port graph
    whose mesh spans 4 groups: merged rows equal the golden run."""
    nk = 7 if kind == "scan" else 5
    if kind == "scan":
        n, ckpt, crash, build = 800, 400, 650, _scan_graph
        mk = lambda **kw: MeshSrc(n, nk, **kw)
        golden, crash_rows, rest = [], [], []
    else:
        n, ckpt, crash, build = 240, 120, 180, _ffat_graph
        mk = lambda **kw: WinSrc(n, nk, **kw)
        golden, crash_rows, rest = {}, {}, {}
    run_bounded(build(wt, str(tmp_path / "gs"), mk(), golden, (8, 1), nk))
    jstore = str(tmp_path / "jax_store")
    gj = build(wj, jstore, mk(ckpt_at=ckpt, crash_at=crash), crash_rows,
               (8, 1), nk)
    with pytest.raises(InjectedCrash):
        run_bounded(gj)
    _, ckpt_dir, manifest = StoreJ.resolve(jstore)
    states = checkpoint_states_from_jax(
        StoreJ(jstore).load_states(ckpt_dir, manifest), "cpu")
    _groups(4)
    src = mk()
    g = build(wt, str(tmp_path / "port_store"), src, rest, (2, 4), nk)
    run_bounded(g, restore_from=states)
    assert src.first == ckpt
    assert _mesh_groups(g, "mscan" if kind == "scan" else "fwm") == 4
    if kind == "scan":
        assert sorted(set(crash_rows + rest)) == sorted(golden)
    else:
        assert {**crash_rows, **rest} == golden


def test_supervised_degrade_of_a_whole_group(tmp_path):
    """Two groups of four virtual devices; the probe reports the second
    group's (4-7) dead: the crashed graph recovers on the first group
    alone (4 shards, one group), re-expands to both groups in ONE planned
    restart when the probe clears them, and the distinct rows equal the
    golden run's."""
    n, nk = 1600, 7
    golden = []
    run_bounded(_scan_graph(wt, str(tmp_path / "gs"), MeshSrc(n, nk),
                            golden, (4, 2), nk))
    _groups(2)
    probe = wt.StaticDeviceProbe(dead=(4, 5, 6, 7), interval_s=0.02)
    release = threading.Event()

    def hold(pos):
        if pos == int(n * 0.9):
            release.wait(30)  # the tail waits for the two-group plane

    rows = []
    src = MeshSrc(n, nk, ckpt_at=range(100, n, 100), crash_at=300,
                  crash_times=1, pace=0.002, on_pos=hold)
    g = _scan_graph(wt, str(tmp_path / "store"), src, rows, (4, 2), nk,
                    supervise=wt.RestartPolicy(max_restarts=4,
                                               backoff_s=0.02),
                    probe=probe)
    try:
        g.start()
        deadline = time.time() + 60
        while time.time() < deadline:
            sup = g.get_stats().get("Supervision", {})
            if sup.get("Recovery_degraded_devices", 0) == 4 \
                    and _mesh_devices(g) == 4:
                break
            time.sleep(0.02)
        else:
            pytest.fail("the one-group recovery never showed")
        assert _mesh_groups(g, "mscan") == 1
        assert g.failure_domains() == {d: ["mscan"] for d in range(4)}
        probe.dead.clear()  # the second group's card returns
        while time.time() < deadline:
            sup = g.get_stats().get("Supervision", {})
            if sup.get("Supervision_planned_restarts", 0) >= 1 \
                    and sup.get("Recovery_degraded_devices", 1) == 0:
                break
            time.sleep(0.02)
        else:
            pytest.fail("the planned re-expansion never happened")
        release.set()
        wait_end_bounded(g)
    finally:
        release.set()
    sup = g.get_stats()["Supervision"]
    assert sup["Supervision_restarts"] == 1
    assert sup["Supervision_planned_restarts"] == 1
    assert _mesh_devices(g) == 8 and _mesh_groups(g, "mscan") == 2
    assert sorted(set(rows)) == sorted(golden)
