"""The port's mesh-sharded keyed operators (``windflow_tpu_torch/mesh/
ops_mesh.py``: Map_Mesh / Filter_Mesh / Reduce_Mesh) held against the JAX
package's (``windflow_tpu/mesh/ops_mesh.py``) through the topology layer:
the same stream through each package's builders, the JAX graph on its
conftest's 8 virtual CPU devices, the port's on ``device="cpu"`` after
``ensure_virtual_devices(8)``; the twins of ``tests/test_mesh_ops.py``,
at mesh shapes (8, 1), (4, 2), (2, 4) and (1, 1). Plus the mesh-plane
refusals (builders, rescale, checkpointing) and the sharded snapshot ->
relayout -> restore round trip.

Tolerance: EXACT. Each key's state folds its rows in arrival order in
both packages (float32 running sums of integers below 2^24), and the
reduce combines integer-valued float32.

Not twinned: ``test_governor_scale_rung_skips_mesh_ops`` (the overload
governor is not ported)."""

import threading

import numpy as np
import pytest
import torch

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded, wait_end_bounded
from windflow_tpu.tpu import (Filter_TPU_Builder, Map_TPU_Builder,
                              Reduce_TPU_Builder)
from windflow_tpu_torch.gpu.batch import BatchGPU
from windflow_tpu_torch.gpu.schema import TupleSchema
from windflow_tpu_torch.mesh import core as ct
from windflow_tpu_torch.mesh.ops_mesh import Map_Mesh
from windflow_tpu_torch.scaling.repartition import repartition_refusal

N, NK = 420, 7
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 1)]
SPARSE_IDS = [(k * 2_654_435_761 - 5_000_000_000) * (11 + k)
              for k in range(NK)]


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


def _src(keymap=None):
    keymap = keymap or list(range(NK))

    def src(shipper, ctx):
        for i in range(N):
            shipper.push({"key": keymap[i % NK], "v": float(i + 1)})
    return src


class _Rows:
    def __init__(self, fields):
        self.fields = fields
        self.rows = []
        self._lock = threading.Lock()

    def sink(self, t):
        if t is not None:
            with self._lock:
                self.rows.append(tuple(
                    float(t[f]) if f != "key" else int(t[f])
                    for f in self.fields))

    @property
    def sorted(self):
        with self._lock:
            return sorted(self.rows)


def _run(pkg, name, op, coll, keymap=None, obs=64):
    kw = {} if pkg is wj else {"device": "cpu"}
    g = pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.INGRESS_TIME, **kw)
    g.add_source(pkg.Source_Builder(_src(keymap))
                 .with_output_batch_size(obs).build()) \
        .add(op).add_sink(pkg.Sink_Builder(coll.sink).build())
    run_bounded(g)
    return g


def _B(pkg, kind):
    return {(wj, "map"): Map_TPU_Builder, (wj, "filter"): Filter_TPU_Builder,
            (wj, "reduce"): Reduce_TPU_Builder,
            (wt, "map"): wt.Map_GPU_Builder,
            (wt, "filter"): wt.Filter_GPU_Builder,
            (wt, "reduce"): wt.Reduce_GPU_Builder}[(pkg, kind)]


def _running(row, st):
    return ({"key": row["key"], "v": row["v"], "run": st + row["v"]},
            st + row["v"])


def _map_builder(pkg, shape=None, key_capacity=NK, mesh=True):
    b = _B(pkg, "map")(_running).with_state(np.float32(0)).with_key_by("key")
    return b.with_mesh(mesh_shape=shape, key_capacity=key_capacity) \
        if mesh else b


def _map_oracle(keymap=None):
    keymap = keymap or list(range(NK))
    st, exp = {}, []
    for i in range(N):
        k, v = keymap[i % NK], float(i + 1)
        st[k] = st.get(k, 0.0) + v
        exp.append((k, v, st[k]))
    return sorted(exp)


def _both(kind_build, fields, name, keymap=None):
    """The same op built for both packages; the port's sorted rows, which
    must equal the JAX package's."""
    out = {}
    for pkg in (wj, wt):
        coll = _Rows(fields)
        _run(pkg, name, kind_build(pkg), coll, keymap)
        out[pkg] = coll.sorted
    assert out[wt] == out[wj]
    return out[wt]


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_map_mesh_reshape_invariance(shape):
    got = _both(lambda p: _map_builder(p, shape).build(),
                ("key", "v", "run"), "mm")
    assert got == _map_oracle()


def test_map_mesh_matches_single_chip():
    """Map_Mesh == the single-card stateful Map_GPU == the JAX package's
    mesh and single-chip maps."""
    def running(row, st):
        st2 = st + row["v"]
        return {"key": row["key"], "v": st2}, st2

    ref = _Rows(("key", "v"))
    _run(wt, "mm_ref", wt.Map_GPU_Builder(running).with_state(np.float32(0))
         .with_key_by("key").build(), ref)
    got = _both(lambda p: _B(p, "map")(running).with_state(np.float32(0))
                .with_key_by("key")
                .with_mesh(mesh_shape=(4, 2), key_capacity=NK).build(),
                ("key", "v"), "mm_mesh")
    assert got == ref.sorted


def test_map_mesh_sparse_negative_keys():
    """Sparse, negative int64 keys group by the ORIGINAL key identity
    (the port declares the key column int64: its host staging refuses an
    int beyond int32, which the JAX package's native encoder truncates)."""
    def build(pkg):
        b = _map_builder(pkg, (2, 4))
        if pkg is wt:
            b = b.with_schema({"key": np.int64, "v": np.float32})
        return b.build()

    got = _both(build, ("v", "run"), "mm_sparse", SPARSE_IDS)
    assert got == sorted((v, run) for _, v, run in _map_oracle(SPARSE_IDS))


@pytest.mark.parametrize("shape", SHAPES)
def test_filter_mesh_reshape_invariance(shape):
    """Stateful filter (keep every 2nd occurrence per key)."""
    got = _both(lambda p: _B(p, "filter")(
        lambda row, st: ((st + 1) % 2 == 0, st + 1))
        .with_state(np.int32(0)).with_key_by("key")
        .with_mesh(mesh_shape=shape, key_capacity=NK).build(),
        ("key", "v"), "fm")
    cnt, exp = {}, []
    for i in range(N):
        k, v = i % NK, float(i + 1)
        cnt[k] = cnt.get(k, 0) + 1
        if cnt[k] % 2 == 0:
            exp.append((k, v))
    assert got == sorted(exp)


@pytest.mark.parametrize("shape", SHAPES)
def test_reduce_mesh_matches_single_chip(shape):
    """Keyed per-batch reduce over the mesh == the single-card
    Reduce_GPU: one output per distinct key per batch."""
    comb = lambda a, b: {"v": a["v"] + b["v"]}
    ref = _Rows(("key", "v"))
    _run(wt, "rm_ref", wt.Reduce_GPU_Builder(comb).with_key_by("key")
         .build(), ref)
    got = _both(lambda p: _B(p, "reduce")(comb).with_key_by("key")
                .with_mesh(mesh_shape=shape, key_capacity=NK).build(),
                ("key", "v"), "rm")
    assert got == ref.sorted


def test_reduce_mesh_spans_several_slices():
    """A batch larger than the mesh's global batch: the per-slice results
    merge on the host with the user combine (the JAX package's
    ``_host_combine``)."""
    comb = lambda a, b: {"v": a["v"] + b["v"]}
    got = _both(lambda p: _B(p, "reduce")(comb).with_key_by("key")
                .with_mesh(mesh_shape=(4, 2), key_capacity=NK,
                           local_batch=4).build(), ("key", "v"), "rm_sl")
    ref = _Rows(("key", "v"))
    _run(wt, "rm_ref", wt.Reduce_GPU_Builder(comb).with_key_by("key")
         .build(), ref)
    assert got == ref.sorted


def test_mesh_key_capacity_guard():
    for pkg in (wj, wt):
        op = _map_builder(pkg, (8, 1), key_capacity=3).build()
        with pytest.raises(pkg.WindFlowError, match="key_capacity"):
            _run(pkg, "mm_cap", op, _Rows(("key", "v", "run")))


# ---------------------------------------------------------------------------
# builder validation
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", [wj, wt])
def test_mesh_builder_requires_state(pkg):
    for kind in ("map", "filter"):
        with pytest.raises(pkg.WindFlowError, match="with_state"):
            _B(pkg, kind)(lambda f: f).with_key_by("key") \
                .with_mesh().build()


@pytest.mark.parametrize("pkg", [wj, wt])
def test_mesh_builder_requires_keyby(pkg):
    with pytest.raises(pkg.WindFlowError, match="with_key_by"):
        _B(pkg, "reduce")(lambda a, b: a).with_mesh().build()


@pytest.mark.parametrize("pkg", [wj, wt])
def test_mesh_builder_parallelism_exclusive(pkg):
    with pytest.raises(pkg.WindFlowError, match="exclusive"):
        _B(pkg, "map")(lambda r, s: (r, s)).with_state(0.0) \
            .with_key_by("key").with_parallelism(2).with_mesh().build()
    with pytest.raises(pkg.WindFlowError, match="output_batch_size"):
        _B(pkg, "reduce")(lambda a, b: a).with_key_by("key") \
            .with_output_batch_size(8).with_mesh().build()


def test_mesh_builder_names():
    assert _map_builder(wt).build().name == "map_mesh"
    assert _B(wt, "reduce")(lambda a, b: a).with_key_by("key") \
        .with_mesh().build().name == "reduce_mesh"
    assert _map_builder(wt).with_name("mscan").build().name == "mscan"


# ---------------------------------------------------------------------------
# mesh-plane refusals: rescale / checkpoint
# ---------------------------------------------------------------------------
def test_mesh_ops_not_repartitionable():
    for op in (_map_builder(wt, (8, 1)).build(),
               wt.Reduce_GPU_Builder(lambda a, b: a).with_key_by("key")
               .with_mesh().build(),
               wt.Ffat_Windows_GPU_Builder(lambda f: f, lambda a, b: a)
               .with_key_by("key").with_tb_windows(8, 4).with_mesh()
               .build()):
        reason = repartition_refusal(op)
        assert reason is not None and "mesh" in reason


def test_rescale_refuses_mesh_op():
    gate = threading.Event()

    def src(shipper):
        for i in range(200):
            if i == 100:
                gate.wait(10)
            shipper.push({"key": i % NK, "v": float(i + 1)})
    src.snapshot_position = lambda: 0
    src.restore = lambda p: None

    coll = _Rows(("key", "v", "run"))
    g = wt.PipeGraph("mm_rescale", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.INGRESS_TIME, device="cpu")
    g.with_checkpointing(store_dir=None)
    op = _map_builder(wt, (8, 1)).with_name("mscan").build()
    g.add_source(wt.Source_Builder(src).with_output_batch_size(32).build()) \
        .add(op).add_sink(wt.Sink_Builder(coll.sink).build())
    g.start()
    try:
        with pytest.raises(wt.WindFlowError,
                           match="not repartitionable.*mesh"):
            g.rescale("mscan", 2)
    finally:
        gate.set()
        wait_end_bounded(g)
    assert len(coll.rows) == 200


def test_governor_scale_rung_skips_mesh_ops():
    """Twin of ``test_mesh_ops.py::test_governor_scale_rung_skips_mesh_ops``:
    the overload governor's SCALE rung never picks a mesh op (its
    candidates go through ``repartition_refusal``), in both packages, so
    an escalation falls through toward SHED."""
    for pkg in (wj, wt):
        gate = threading.Event()

        def src(shipper):
            for i in range(120):
                if i == 60:
                    gate.wait(10)
                shipper.push({"key": i % NK, "v": float(i + 1)})

        coll = _Rows(("key", "v", "run"))
        kw = {} if pkg is wj else {"device": "cpu"}
        g = pkg.PipeGraph(f"mm_gov_{pkg.__name__}", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.INGRESS_TIME, **kw)
        g.with_slo(60_000.0)  # idle SLO: attached, never engages
        op = _map_builder(pkg, (8, 1)).with_name("mscan").build()
        g.add_source(pkg.Source_Builder(src).with_output_batch_size(32)
                     .build()) \
            .add(op).add_sink(pkg.Sink_Builder(coll.sink).build())
        g.start()
        try:
            gov = g._overload_governor
            assert gov is not None
            assert "mscan" not in gov._eligible_totals()
            assert gov._try_scale() is False
        finally:
            gate.set()
            wait_end_bounded(g)
        assert len(coll.sorted) == 120


def test_checkpointing_refuses_non_snapshottable_mesh_op(tmp_path):
    class LegacyMesh(Map_Mesh):
        mesh_snapshot_capable = False

    op = LegacyMesh(lambda r, s: (r, s), np.float32(0), "key",
                    name="legacy_mesh", key_capacity=NK)
    g = wt.PipeGraph("mm_refuse", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.INGRESS_TIME, device="cpu")
    g.with_checkpointing(store_dir=str(tmp_path))
    g.add_source(wt.Source_Builder(_src()).with_output_batch_size(32)
                 .build()) \
        .add(op).add_sink(wt.Sink_Builder(_Rows(("key",)).sink).build())
    with pytest.raises(wt.WindFlowError, match="legacy_mesh"):
        run_bounded(g)


def test_checkpointing_accepts_snapshottable_mesh_op(tmp_path):
    coll = _Rows(("key", "v", "run"))
    g = wt.PipeGraph("mm_ckpt_ok", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.INGRESS_TIME, device="cpu")
    g.with_checkpointing(store_dir=str(tmp_path))
    g.add_source(wt.Source_Builder(_src()).with_output_batch_size(64)
                 .build()) \
        .add(_map_builder(wt, (4, 2)).build()) \
        .add_sink(wt.Sink_Builder(coll.sink).build())
    run_bounded(g)
    assert coll.sorted == _map_oracle()


# ---------------------------------------------------------------------------
# sharded snapshot -> relayout -> restore (replica-level round trip)
# ---------------------------------------------------------------------------
SCHEMA = TupleSchema({"key": np.int32, "v": np.float32})


def _batch(lo, hi):
    keys = (np.arange(lo, hi) % NK).astype(np.int32)
    vals = np.arange(lo + 1, hi + 1).astype(np.float32)
    return BatchGPU({"key": torch.from_numpy(keys),
                     "v": torch.from_numpy(vals)},
                    np.arange(lo, hi).astype(np.int64), hi - lo, SCHEMA,
                    wm=0, host_keys=keys)


class _Sink:
    def __init__(self):
        self.rows = []

    def emit_device_batch(self, b):
        run = b.fields["run"][:b.size].numpy()
        keys = b.fields["key"][:b.size].numpy()
        self.rows.extend(zip(keys.tolist(), run.tolist()))


def _replica(shape):
    op = _map_builder(wt, shape).build()
    op.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.INGRESS_TIME,
                 torch.device("cpu"))
    op.build_replicas()
    r = op.replicas[0]
    r.emitter = _Sink()
    return r


@pytest.mark.parametrize("dst", [(2, 4), (1, 1), (8, 1)])
def test_scan_snapshot_relayout_roundtrip(dst):
    """Snapshot a mesh scan replica mid-stream, restore it on another
    mesh shape and continue: rows equal an uninterrupted run."""
    ref = _replica((8, 1))
    ref.process_device_batch(_batch(0, 96))
    ref.process_device_batch(_batch(96, 192))
    r1 = _replica((8, 1))
    r1.process_device_batch(_batch(0, 96))
    blob = r1.snapshot_state()
    assert len(blob["mesh_scan"]["table_shards"]) == 8  # per-shard blocks
    r2 = _replica(dst)
    r2.restore_state(blob)
    r2.process_device_batch(_batch(96, 192))
    assert sorted(r2.emitter.rows) == sorted(ref.emitter.rows[96:])


def test_scan_snapshot_matches_jax_blob():
    """The port's mesh_scan blob equals the JAX package's after the same
    batches: the same keys, slots and per-shard row blocks."""
    import jax

    from windflow_tpu.tpu.batch import BatchTPU
    from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
    opj = _map_builder(wj, (4, 2)).build()
    opj.build_replicas()
    rj = opj.replicas[0]

    class Drop:
        def emit_device_batch(self, b):
            pass
    rj.emitter = Drop()
    sj = SchemaJ({"key": np.int32, "v": np.float32})
    for lo, hi in ((0, 96), (96, 150)):
        keys = (np.arange(lo, hi) % NK).astype(np.int32)
        rj.process_device_batch(BatchTPU(
            {"key": jax.device_put(keys), "v": jax.device_put(
                np.arange(lo + 1, hi + 1).astype(np.float32))},
            np.arange(lo, hi).astype(np.int64), hi - lo, sj, wm=0,
            host_keys=keys))
    rt = _replica((4, 2))
    for lo, hi in ((0, 96), (96, 150)):
        rt.process_device_batch(_batch(lo, hi))
    bj = rj.snapshot_state()["mesh_scan"]
    bt = rt.snapshot_state()["mesh_scan"]
    assert bt["slot_of_key"] == bj["slot_of_key"]
    assert np.array_equal(bt["key_by_slot"], bj["key_by_slot"])
    for k in ("K_pad", "n_shards", "local_batch", "key_capacity"):
        assert bt[k] == bj[k], k
    assert len(bt["table_shards"]) == len(bj["table_shards"]) == 8
    for a, b in zip(bt["table_shards"], bj["table_shards"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_scan_snapshot_passthrough_before_first_batch():
    """Restore then snapshot BEFORE any batch: the blob passes through
    unchanged."""
    r1 = _replica((8, 1))
    r1.process_device_batch(_batch(0, 64))
    blob = r1.snapshot_state()
    r2 = _replica((4, 2))
    r2.restore_state(blob)
    blob2 = r2.snapshot_state()
    assert blob2["mesh_scan"] is blob["mesh_scan"]


def test_grid_scan_int32_cell_guard():
    """The mesh scan's grid cells are int32, like the single-card scan's:
    a K_pad x M grid without a scratch cell inside int32 refuses."""
    mesh = ct.make_key_mesh(8, shape=(8, 1), device="cpu")
    with pytest.raises(wt.WindFlowError, match="beyond int32"):
        ct.sharded_grid_scan(mesh, _running, False, 1 << 20, 1 << 12, 8)


@pytest.mark.parametrize("policy", ["lru", "lfu"])
def test_tiered_mesh_scan_matches_jax(policy, tmp_path):
    """The mesh table as the hot tier (8 of 24 keys; batches of 8 rows):
    the rows equal the dense mesh scan's and the JAX package's tiered
    mesh scan's, and the tier plan moved keys both ways."""
    import random

    n, nk = 1_200, 24
    keys = [random.Random(11 + i).randrange(nk) for i in range(n)]

    def src(shipper, ctx):
        for v in range(n):
            shipper.push({"key": keys[v], "v": float(v + 1)})

    def run(pkg, tiered):
        b = _B(pkg, "map")(_running).with_state(np.float32(0)) \
            .with_key_by("key")
        if tiered:
            b = b.with_tiering(policy=policy, hot_capacity=8,
                               db_dir=str(tmp_path / f"{pkg.__name__}_db"))
        b = b.with_mesh(mesh_shape=(4, 2), key_capacity=8 if tiered else nk)
        coll = _Rows(("key", "v", "run"))
        kw = {} if pkg is wj else {"device": "cpu"}
        g = pkg.PipeGraph("tier_mesh", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.INGRESS_TIME, **kw)
        g.add_source(pkg.Source_Builder(src).with_output_batch_size(8)
                     .build()).add(b.build()) \
            .add_sink(pkg.Sink_Builder(coll.sink).build())
        run_bounded(g)
        return coll.sorted, g

    got, g = run(wt, True)
    assert got == run(wj, True)[0] == run(wt, False)[0]
    assert len(got) == n
    rep = g.get_stats()["Operators"][1]["replicas"][0]
    assert rep["Tier_promotes"] > 0 and rep["Tier_demotes"] > 0
    assert rep["Mesh_devices"] == 8


def test_tiered_mesh_refuses_hot_tier_above_key_capacity(tmp_path):
    for pkg in (wj, wt):
        op = _B(pkg, "map")(_running).with_state(np.float32(0)) \
            .with_key_by("key").with_tiering(hot_capacity=16,
                                             db_dir=str(tmp_path)) \
            .with_mesh(key_capacity=8).build()
        with pytest.raises(pkg.WindFlowError, match="hot_capacity"):
            op.build_replicas()


# ---------------------------------------------------------------------------
# the operators over card groups (every group on the CPU here)
# ---------------------------------------------------------------------------
GROUP_CASES = [((8, 1), 8), ((4, 2), 2), ((4, 2), 8), ((2, 4), 4)]
GROUP_IDS = [f"{s[0]}x{s[1]}-g{g}" for s, g in GROUP_CASES]


def _groups(n):
    ct.ensure_virtual_devices(8, group_devices=["cpu"] * n)


def _filter_builder(pkg, shape):
    return (_B(pkg, "filter")(lambda row, st: ((st + 1) % 2 == 0, st + 1))
            .with_state(np.int32(0)).with_key_by("key")
            .with_mesh(mesh_shape=shape, key_capacity=NK))


def _reduce_builder(pkg, shape):
    return (_B(pkg, "reduce")(lambda a, b: {"v": a["v"] + b["v"]})
            .with_key_by("key")
            .with_mesh(mesh_shape=shape, key_capacity=NK, local_batch=4))


def _key_totals(rows):
    """Per-key sums of a reduce's (key, v) rows, whatever the batches."""
    tot = {}
    for k, v in rows:
        tot[k] = tot.get(k, 0.0) + v
    return tot


@pytest.mark.parametrize("kind", ["map", "filter", "reduce"])
@pytest.mark.parametrize("case", GROUP_CASES, ids=GROUP_IDS)
def test_mesh_ops_over_groups_match_one_group(case, kind):
    """Map_Mesh / Filter_Mesh / Reduce_Mesh over card groups: the rows of
    the one-group run of the same shape, and the JAX package's. The
    reduce emits one row per key and device batch, and an INGRESS_TIME
    source's batch boundaries follow the staging timer (its watermark
    steps on every push), so its graph runs are held to equal per-key
    totals; ``test_reduce_mesh_fixed_split_over_groups`` holds its rows
    exactly at a fixed split."""
    shape, n = case
    build, fields = {
        "map": (lambda p: _map_builder(p, shape).build(),
                ("key", "v", "run")),
        "filter": (lambda p: _filter_builder(p, shape).build(),
                   ("key", "v")),
        "reduce": (lambda p: _reduce_builder(p, shape).build(),
                   ("key", "v"))}[kind]
    one = _Rows(fields)
    _run(wt, f"{kind}_g1", build(wt), one)
    _groups(n)
    if kind == "reduce":
        runs = {}
        for pkg in (wj, wt):
            coll = _Rows(fields)
            _run(pkg, f"{kind}_g{n}", build(pkg), coll)
            runs[pkg] = _key_totals(coll.sorted)
        model = _key_totals((i % NK, float(i + 1)) for i in range(N))
        assert runs[wt] == runs[wj] == _key_totals(one.sorted) == model
        return
    got = _both(build, fields, f"{kind}_g{n}")
    assert got == one.sorted
    if kind == "map":
        assert got == _map_oracle()


class _ReduceSink:
    def __init__(self):
        self.batches = []

    def emit_device_batch(self, b):
        v = b.fields["v"][:b.size].numpy()
        self.batches.append(sorted(zip(np.asarray(b.host_keys).tolist(),
                                       v.tolist())))


def _reduce_replica(shape):
    op = _reduce_builder(wt, shape).build()
    op.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.INGRESS_TIME,
                 torch.device("cpu"))
    op.build_replicas()
    r = op.replicas[0]
    r.emitter = _ReduceSink()
    return r


# uneven batches, each several slices of the reduce's local batch
FIXED_SPLIT = [(0, 64), (64, 101), (101, 229), (229, 230), (230, 420)]


@pytest.mark.parametrize("case", GROUP_CASES, ids=GROUP_IDS)
def test_reduce_mesh_fixed_split_over_groups(case):
    """Reduce_Mesh at a fixed batch split, on one group and on n: the
    same rows, batch by batch, and each batch's per-key sums (the
    cross-group read-back and the per-slice host merge at every
    split)."""
    shape, n = case
    one = _reduce_replica(shape)
    for lo, hi in FIXED_SPLIT:
        one.process_device_batch(_batch(lo, hi))
    _groups(n)
    got = _reduce_replica(shape)
    for lo, hi in FIXED_SPLIT:
        got.process_device_batch(_batch(lo, hi))
    assert got._mesh.n_groups == n
    model = [sorted(_key_totals((i % NK, float(i + 1))
                                for i in range(lo, hi)).items())
             for lo, hi in FIXED_SPLIT]
    assert got.emitter.batches == one.emitter.batches == model


@pytest.mark.parametrize("dst", [1, 2], ids=["g1", "g2"])
def test_scan_snapshot_from_four_groups_restores_onto(dst):
    """A mesh scan replica on 4 groups snapshots mid-stream: per-shard
    blocks, whatever the groups; restored onto 1 or 2 groups (and another
    shape) it goes on as an uninterrupted run does."""
    ref = _replica((8, 1))
    ref.process_device_batch(_batch(0, 96))
    ref.process_device_batch(_batch(96, 192))
    _groups(4)
    r1 = _replica((4, 2))
    r1.process_device_batch(_batch(0, 96))
    assert r1._mesh.n_groups == 4
    blob = r1.snapshot_state()
    assert len(blob["mesh_scan"]["table_shards"]) == 8
    r0 = _replica((4, 2))
    r0.process_device_batch(_batch(0, 96))
    one = r0.snapshot_state()["mesh_scan"]["table_shards"]
    for a, b in zip(blob["mesh_scan"]["table_shards"], one):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    if dst == 1:
        ct.ensure_virtual_devices(8)
    else:
        _groups(2)
    r2 = _replica((2, 4))
    r2.restore_state(blob)
    r2.process_device_batch(_batch(96, 192))
    assert r2._mesh.n_groups == dst
    assert sorted(r2.emitter.rows) == sorted(ref.emitter.rows[96:])


def test_tiered_mesh_scan_over_groups(tmp_path):
    """The cold tier behind a table split over 4 groups (8 hot of 24 keys;
    batches of 8 rows): demotions gather rows from their owning groups,
    promotions scatter them back; the rows equal the one-group run's."""
    import random

    n, nk = 600, 24
    keys = [random.Random(11 + i).randrange(nk) for i in range(n)]

    def src(shipper, ctx):
        for v in range(n):
            shipper.push({"key": keys[v], "v": float(v + 1)})

    def run(name):
        b = (wt.Map_GPU_Builder(_running).with_state(np.float32(0))
             .with_key_by("key")
             .with_tiering(policy="lru", hot_capacity=8,
                           db_dir=str(tmp_path / name))
             .with_mesh(mesh_shape=(4, 2), key_capacity=8))
        coll = _Rows(("key", "v", "run"))
        g = wt.PipeGraph(name, wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.INGRESS_TIME, device="cpu")
        g.add_source(wt.Source_Builder(src).with_output_batch_size(8)
                     .build()).add(b.build()) \
            .add_sink(wt.Sink_Builder(coll.sink).build())
        run_bounded(g)
        return coll.sorted, g

    one, _ = run("tier_g1")
    _groups(4)
    got, g = run("tier_g4")
    assert got == one and len(got) == n
    rep = g.get_stats()["Operators"][1]["replicas"][0]
    assert rep["Tier_promotes"] > 0 and rep["Tier_demotes"] > 0
