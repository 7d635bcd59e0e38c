"""Composite (multi-field) keys in the port, held against the JAX package:
the composite cases of ``tests/test_key_routing.py`` (row-wise and
columnar staging route each key to one destination, the scalar / stacked
/ structured hash twins over every element dtype, the duplicate-field
refusal, byte-order invariance, the randomized twin fuzz) compared as
destinations with the JAX package's, the staging cost as a count of
per-row hash calls (the JAX file bounds it as a timing), and keyed device
graphs whose key is a tuple of fields — through keyed staging and through
a device -> device re-shard that reads the key columns back — compared
row for row with the JAX package.

Tolerance: exact (destinations, slot maps and integer sums)."""

import random
import threading
from collections import Counter

import numpy as np
import pytest
import torch

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.basic import as_key_fn as as_key_fn_j
from windflow_tpu.basic import key_fields_names as key_fields_names_j
from windflow_tpu.tpu import emitters_tpu as ej
from windflow_tpu.tpu import Map_TPU_Builder, Reduce_TPU_Builder
from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
from windflow_tpu_torch.basic import as_key_fn, key_fields_names
from windflow_tpu_torch.gpu import routing as rt
from windflow_tpu_torch.gpu.emitters_gpu import GPUStageEmitter
from windflow_tpu_torch.gpu.schema import TupleSchema

N_DESTS = 4


class _Port:
    def __init__(self):
        self.batches = []

    def send(self, b):
        if getattr(b, "size", None) is not None:
            self.batches.append(b)


def _emitter(pkg, obs=64):
    if pkg is wj:
        em = ej.TPUStageEmitter(N_DESTS, obs, SchemaJ({"v": np.float32}),
                                as_key_fn_j(("c", "a")), "keyby",
                                key_field=None, key_fields=("c", "a"))
    else:
        em = GPUStageEmitter(N_DESTS, obs, TupleSchema({"v": np.float32}),
                             as_key_fn(("c", "a")), "keyby",
                             wt.ExecutionMode.DEFAULT, None,
                             torch.device("cpu"),
                             key_fields=("c", "a"))
    ports = [_Port() for _ in range(N_DESTS)]
    em.set_ports(ports)
    return em, ports


def _dest_map(ports):
    m = {}
    for d, p in enumerate(ports):
        for b in p.batches:
            keys = (b.host_keys.tolist()
                    if isinstance(b.host_keys, np.ndarray) else b.host_keys)
            for k in keys:
                assert m.setdefault(tuple(k), d) == d, \
                    f"key {k!r} split across destinations"
    return m


def _stage_both_ways(pkg):
    cs = (np.arange(40, dtype=np.int64) % 7) - 3  # negative ints included
    ads = np.array([f"ad{i % 11}" for i in range(40)])
    em1, ports1 = _emitter(pkg)
    for i in range(3):
        for c, a in zip(cs.tolist(), ads.tolist()):
            em1.emit({"c": c, "a": a, "v": 1.0}, i, 0)
    em1.flush()
    em2, ports2 = _emitter(pkg)
    em2.emit_columns({"c": np.tile(cs, 3), "a": np.tile(ads, 3),
                      "v": np.ones(120, np.float32)},
                     np.arange(120, dtype=np.int64), 0)
    em2.flush()
    some = next(b for p in ports2 for b in p.batches)
    return _dest_map(ports1), _dest_map(ports2), some.host_keys


def test_composite_keys_rowwise_and_columnar_route_identically():
    mj1, mj2, _ = _stage_both_ways(wj)
    mt1, mt2, hk = _stage_both_ways(wt)
    assert mt1 == mt2, "row-wise vs columnar composite routing diverged"
    assert mt1 == mj1 == mj2, "the port routes keys elsewhere than JAX"
    assert len(set(mt1.values())) >= 2
    # the columnar batches carry STRUCTURED key metadata whose rows are
    # the tuples the per-row path extracts
    assert isinstance(hk, np.ndarray) and hk.dtype.names == ("c", "a")
    assert isinstance(hk.tolist()[0], tuple)


def _stacked_dests(fcols, n):
    """The port's destinations of a multi-field key given its field
    columns: stacked into the structured key column as the staging edge
    does (``_stack_key_fields``), then the vectorized fold (None where a
    field has no vectorized form, and the per-row path routes)."""
    cols = {f"f{i}": c for i, c in enumerate(fcols)}
    return rt._vector_key_dests(rt._stack_key_fields(cols, list(cols), n),
                                n, N_DESTS)


def test_composite_key_scalar_vector_twins():
    """Every element dtype hashes alike on the scalar (per-row tuple),
    stacked-column and structured-column (re-shard) paths, and exactly as
    in the JAX package."""
    n = 60
    rng = np.random.default_rng(1)
    c = rng.integers(-1000, 1000, n)
    a = np.array([f"ad{i % 9}" for i in range(n)])
    f = np.round(rng.standard_normal(n), 3)
    dests = _stacked_dests([c, a, f], n)
    assert (dests == ej._composite_key_dests([c, a, f], n, N_DESTS)).all()
    for i in range(n):
        row = (int(c[i]), str(a[i]), float(f[i]))
        assert rt._dest_of_key(row, N_DESTS) == dests[i] \
            == ej._dest_of_key(row, N_DESTS)
    st = np.empty(n, np.dtype([("c", c.dtype), ("a", a.dtype),
                               ("f", f.dtype)]))
    st["c"], st["a"], st["f"] = c, a, f
    assert (rt._vector_key_dests(st, n, N_DESTS) == dests).all()
    assert (rt.key_dests(st, n, N_DESTS) == dests).all()
    for i in range(5):  # np.void scalar branch
        assert rt._dest_of_key(st[i], N_DESTS) == dests[i]
    assert _stacked_dests([c[:0], a[:0]], 0).size == 0
    # top-level int columns must NOT vectorize here (negative ints route
    # by CPython hash on the per-row paths)
    assert rt._vector_key_dests(c, n, N_DESTS) is None
    # equality-compatible floats, datetimes, NaT and nested structs
    import datetime as dt
    eq = np.array([0.0, -0.0, 1.0, 3.0, 2.5, float("nan")])
    ea = np.array(["x"] * len(eq))
    dd = _stacked_dests([eq, ea], len(eq))
    assert dd[0] == dd[1] == rt._dest_of_key((0, "x"), N_DESTS)
    assert dd[2] == rt._dest_of_key((1, "x"), N_DESTS)
    days = np.array(["2021-01-01", "2021-06-15"], dtype="M8[D]")
    ids = np.array([7, 9], dtype=np.int64)
    ddt = _stacked_dests([days, ids], 2)
    assert ddt[0] == rt._dest_of_key((dt.date(2021, 1, 1), 7), N_DESTS)
    assert (ddt == ej._composite_key_dests([days, ids], 2, N_DESTS)).all()
    nat = np.array(["2021-01-01", "NaT"], dtype="M8[s]")
    assert _stacked_dests([nat, ids], 2) is None
    nest = np.zeros(2, np.dtype([("s", np.dtype([("x", np.int64)]))]))
    assert _stacked_dests([nest, ids], 2) is None


@pytest.mark.parametrize("names", [("c", "c"), ["a", "b", "a"]])
def test_composite_key_duplicate_field_rejected_at_build(names):
    for pkg, fn in ((wj, key_fields_names_j), (wt, key_fields_names)):
        with pytest.raises(pkg.WindFlowError, match="repeats"):
            fn(names)
    with pytest.raises(wt.WindFlowError, match="repeats"):
        wt.Reduce_GPU_Builder(lambda a, b: a).with_key_by(names).build()


def test_composite_key_datetime_byteorder_invariant():
    """A big-endian datetime column routes like a native one (raw-view
    units included), as in the JAX package."""
    ids = np.array([7], dtype=np.int64)
    for dt_s in ("M8[ns]", "M8[s]", "m8[ns]"):
        nat_col = np.array([123456789], dtype=dt_s)
        be_col = nat_col.astype(nat_col.dtype.newbyteorder(">"))
        dn = _stacked_dests([nat_col, ids], 1)
        db = _stacked_dests([be_col, ids], 1)
        assert dn is not None and (dn == db).all(), dt_s
        assert (dn == ej._composite_key_dests([nat_col, ids], 1,
                                              N_DESTS)).all()


@pytest.mark.parametrize("fuzz_seed", [7, 41])
def test_composite_key_twins_randomized_fuzz(fuzz_seed):
    """Random field dtypes (ints of every width and sign, floats, bool,
    fixed-width str/bytes, date/time units) and values: the port's stacked
    fold, structured column and per-row tuples agree with each other and
    with the JAX package's destinations."""
    rng = random.Random(fuzz_seed)
    nprng = np.random.default_rng(fuzz_seed)

    def make_field(n):
        kind = rng.choice(["int", "uint", "float", "bool", "str", "bytes",
                           "date", "time", "tdelta"])
        if kind == "int":
            w = rng.choice([np.int8, np.int16, np.int32, np.int64])
            return nprng.integers(-100, 100, n).astype(w)
        if kind == "uint":
            w = rng.choice([np.uint8, np.uint16, np.uint32, np.uint64])
            return nprng.integers(0, 200, n).astype(w)
        if kind == "float":
            w = rng.choice([np.float16, np.float32, np.float64])
            base = nprng.standard_normal(n).astype(w)
            base[::5] = 3.0
            if n > 2:
                base[1] = -0.0
                base[2] = np.nan
            return base
        if kind == "bool":
            return nprng.integers(0, 2, n).astype(bool)
        if kind == "str":
            vals = np.array([f"k{v}" for v in nprng.integers(0, 30, n)],
                            dtype=f"U{rng.choice([3, 7, 15])}")
            return vals.astype(vals.dtype.newbyteorder(
                rng.choice(["=", ">"])))
        if kind == "bytes":
            return np.array([b"b%d" % v for v in nprng.integers(0, 30, n)],
                            dtype=f"S{rng.choice([4, 9])}")
        if kind == "date":
            unit = rng.choice(["D", "W", "M"])
            return (np.array(["2021-01-01"], dtype=f"M8[{unit}]")
                    + nprng.integers(0, 40, n).astype(f"m8[{unit}]"))
        if kind == "time":
            unit = rng.choice(["h", "m", "s", "ms", "us"])
            return (np.array(["2021-01-01T00:00:00"], dtype=f"M8[{unit}]")
                    + nprng.integers(0, 1000, n).astype(f"m8[{unit}]"))
        unit = rng.choice(["D", "s", "ms", "us"])
        return nprng.integers(0, 90000, n).astype(f"m8[{unit}]")

    vectorized = 0
    for trial in range(120):
        n = rng.choice([1, 7, 33])
        fcols = [make_field(n) for _ in range(rng.choice([1, 2, 3]))]
        dests = _stacked_dests(fcols, n)
        jd = ej._composite_key_dests(fcols, n, N_DESTS)
        assert (dests is None) == (jd is None), trial
        if dests is None:
            continue  # the per-row path on both sides
        vectorized += 1
        assert (dests == jd).all(), trial
        st = np.empty(n, np.dtype([(f"f{i}", c.dtype.newbyteorder("="))
                                   for i, c in enumerate(fcols)]))
        for i, c in enumerate(fcols):
            st[f"f{i}"] = c
        assert (rt._vector_key_dests(st, n, N_DESTS) == dests).all()
        for j in range(n):
            row_item = tuple(c[j].item() for c in fcols)
            if not all(v == v for v in row_item):
                continue  # nan keys are identity-keyed
            assert rt._dest_of_key(row_item, N_DESTS) == dests[j]
            assert rt._dest_of_key(tuple(c[j] for c in fcols),
                                   N_DESTS) == dests[j]
    assert vectorized > 60


def test_composite_key_columnar_staging_is_vectorized(monkeypatch):
    """The JAX file bounds composite-key staging as a timing against
    int-key staging; here the cause is counted instead: a composite-key
    column block routes with NO per-row hash call, an object-key block
    with one per row."""
    calls = Counter()
    orig = rt._dest_of_key

    def counting(key, n):
        calls["rows"] += 1
        return orig(key, n)

    monkeypatch.setattr(rt, "_dest_of_key", counting)
    n = 1 << 12
    rng = np.random.default_rng(0)
    cols = {"c": rng.integers(0, 64, n), "a": rng.integers(0, 16, n),
            "v": np.ones(n, np.float32)}
    em, ports = _emitter(wt, obs=n)
    em.emit_columns(cols, np.arange(n, dtype=np.int64), 0)
    em.flush()
    assert calls["rows"] == 0
    assert sum(b.size for p in ports for b in p.batches) == n
    objs = np.empty(n, object)
    objs[:] = [(int(v), "x") for v in cols["c"]]
    rt.key_dests(objs, n, N_DESTS)
    assert calls["rows"] == n


# ---------------------------------------------------------------------------
# keyed device graphs with a composite key
# ---------------------------------------------------------------------------
def _blocks(n_blocks, seed, batch=64):
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_blocks):
        cols = {"key": rng.integers(0, 5, batch).astype(np.int32),
                "value": rng.integers(0, 100, batch).astype(np.int32)}
        out.append((cols, b * batch + np.arange(batch, dtype=np.int64)))
    return out


def _composite_reduce(pkg, blocks, staged_keyed, par):
    """Columnar source -> [Map adding "branch"] -> Reduce keyed by
    ("key", "branch") -> sink. ``staged_keyed``: the reduce takes its key
    at the staging edge (host metadata) — otherwise a Map sits in front,
    and the keyed device -> device edge reads the key columns back."""
    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    Reduce = Reduce_TPU_Builder if pkg is wj else wt.Reduce_GPU_Builder
    kw = {} if pkg is wj else {"device": "cpu"}
    g = pkg.PipeGraph("ck", pkg.ExecutionMode.DEFAULT,
                      pkg.TimePolicy.EVENT_TIME, **kw)

    def gen():
        for cols, ts in blocks:
            c = dict(cols)
            if staged_keyed:
                c["branch"] = (c["value"] % 3).astype(np.int32)
            yield c, ts

    mp = g.add_source(pkg.Columnar_Source_Builder(gen)
                      .with_output_batch_size(64).build())
    if not staged_keyed:
        mp.add(Map(lambda f: {**f, "branch": f["value"] % 3}).build())
    mp.add(Reduce(lambda a, b: {"key": b["key"], "branch": b["branch"],
                                "value": a["value"] + b["value"]})
           .with_key_by(("key", "branch")).with_parallelism(par)
           .with_name("red").build())
    out, lock = Counter(), threading.Lock()

    def sink(cols, ts):
        if cols is not None:
            with lock:
                for k, b, v in zip(np.asarray(cols["key"]).tolist(),
                                   np.asarray(cols["branch"]).tolist(),
                                   np.asarray(cols["value"]).tolist()):
                    out[(k, b)] += v

    mp.add_sink(pkg.Sink_Builder(sink).with_columns().build())
    run_bounded(g)
    return dict(out)


@pytest.mark.parametrize("staged_keyed", [True, False],
                         ids=["keyed_staging", "device_reshard"])
@pytest.mark.parametrize("par", [1, 3])
def test_composite_keyed_reduce_matches_jax(staged_keyed, par):
    blocks = _blocks(6, seed=3)
    ref = Counter()
    for cols, _ in blocks:
        for k, v in zip(cols["key"].tolist(), cols["value"].tolist()):
            ref[(k, v % 3)] += v
    got_j = _composite_reduce(wj, blocks, staged_keyed, par)
    got_t = _composite_reduce(wt, blocks, staged_keyed, par)
    assert got_t == got_j == dict(ref)


def test_composite_slots_are_sorted_tuples():
    """A batch whose host keys are a structured column maps to dense
    slots in sorted-tuple order, keyed by plain tuples — the JAX
    package's ``op_batch_slots_np`` structured branch."""
    from windflow_tpu.tpu.batch import BatchTPU
    from windflow_tpu.tpu.ops_tpu import op_batch_slots_np as slots_j
    from windflow_tpu_torch.gpu.batch import BatchGPU
    from windflow_tpu_torch.gpu.ops_gpu import op_batch_slots_np as slots_t

    import jax.numpy as jnp
    keys = rt._stack_key_fields({"a": np.array([3, 1, 3, 2, 1]),
                                 "b": np.array(["x", "y", "x", "x", "y"])},
                                ("a", "b"), 5)
    op_t = wt.Reduce_GPU_Builder(lambda a, b: a).with_key_by(("a", "b")) \
        .build()
    op_j = Reduce_TPU_Builder(lambda a, b: a).with_key_by(("a", "b")) \
        .build()
    bt = BatchGPU({"v": torch.zeros(8)}, np.zeros(8, np.int64), 5,
                  TupleSchema({"v": np.float32}), 0, keys)
    bj = BatchTPU({"v": jnp.zeros(8)}, np.zeros(8, np.int64), 5,
                  SchemaJ({"v": np.float32}), 0, keys)
    st, mt = slots_t(op_t, bt)
    sj, mj = slots_j(op_j, bj)
    assert (st == sj).all() and mt == mj
    assert list(mt) == [(1, "y"), (2, "x"), (3, "x")]
