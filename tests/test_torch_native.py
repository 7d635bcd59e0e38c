"""The port's native host runtime (``windflow_tpu_torch/native``) against
the JAX package's: twins of ``test_native.py``.

The C++ ring keeps the port channel's contract (per-producer FIFO under
concurrent producers, bounded backpressure with its gauges, references
held while queued, ``close()`` for a supervised teardown); the staging
encoders fill columns byte for byte as the Python loop does and as the
JAX package's encoders do, and an int beyond int32 raises where the JAX
encoder wraps it. A graph runs the same on native channels and with the
encoders on or off, in both packages."""

import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import windflow_tpu as wj
import windflow_tpu_torch as wt
from windflow_tpu.native import encode_column as encode_j
from windflow_tpu.native import native_available as avail_j
from windflow_tpu_torch.basic import SupervisorTeardown
from windflow_tpu_torch.gpu.schema import TupleSchema
from windflow_tpu_torch.native import (NativeChannel, encode_column,
                                       native_available, native_build_error,
                                       native_state)
from windflow_tpu_torch.runtime.channel import Channel
from torch_waits import join_bounded, run_bounded


def test_native_runtime_builds_into_build_dir():
    """The port builds its own ``wfruntime.cpp`` into ``build/native/``
    (never next to the source); a failed build would be kept and
    reported."""
    assert native_available(), native_build_error()
    st = native_state()
    assert st["Native_loaded"] and st["Native_build_error"] is None
    import windflow_tpu_torch.native as nat
    assert nat.BUILD_DIR.name == "native" \
        and nat.BUILD_DIR.parent.name == "build"
    assert any(nat.BUILD_DIR.glob("wfruntime-*.so"))
    assert not list(nat.SRC.parent.glob("*.so"))


@pytest.mark.parametrize("kind", ["native", "python"])
def test_channel_fifo_concurrent_producers(kind):
    """Per-producer FIFO under four concurrent producers, on the ring and
    on the Python channel alike."""
    ch = NativeChannel(128) if kind == "native" else Channel(128)
    n, n_prod = 3000, 4
    assert [ch.register_input() for _ in range(n_prod)] == [0, 1, 2, 3]

    def producer(pid):
        for i in range(n):
            ch.put(pid, (pid, i))

    threads = [threading.Thread(target=producer, args=(p,))
               for p in range(n_prod)]
    for t in threads:
        t.start()
    seen = {p: [] for p in range(n_prod)}
    for _ in range(n * n_prod):
        tag, (pid, i) = ch.get()
        assert tag == pid
        seen[pid].append(i)
    for t in threads:
        join_bounded(t)
    assert all(seen[p] == list(range(n)) for p in range(n_prod))
    assert ch.get(0.01) is None  # empty: the idle-tick timeout


def test_native_channel_backpressure_gauges_and_refcounts():
    """A full ring blocks its producer (the Queue_* gauges count it) and
    holds one reference per queued message."""
    ch = NativeChannel(4)
    done = threading.Event()

    def producer():
        for i in range(40):
            ch.put(0, i)
        done.set()

    t = threading.Thread(target=producer)
    t.start()
    assert not done.wait(0.1)  # blocked on the bounded ring
    got = [ch.get()[1] for _ in range(40)]
    join_bounded(t)
    assert got == list(range(40))
    assert ch.depth_max == 4 and ch.puts_blocked >= 1
    assert ch.blocked_put_ns > 0
    obj = object()
    base = sys.getrefcount(obj)
    ch.put(0, obj)
    assert sys.getrefcount(obj) == base + 1
    _, back = ch.get()
    assert back is obj
    del back
    assert sys.getrefcount(obj) == base


def test_native_channel_close_tears_down_blocked_calls():
    """``close()`` wakes a blocked consumer and a blocked producer with
    ``SupervisorTeardown``; buffered messages still drain first."""
    ch = NativeChannel(1)
    got = []

    def consumer():
        try:
            while True:
                got.append(ch.get()[1])
        except SupervisorTeardown:
            got.append("teardown")

    t = threading.Thread(target=consumer)
    t.start()
    ch.put(0, "a")
    ch.close()
    join_bounded(t)
    assert got == ["a", "teardown"]
    with pytest.raises(SupervisorTeardown):
        ch.put(0, "b")


@dataclasses.dataclass
class Row:
    a: int
    b: float
    c: int


def test_encoders_match_python_path_and_jax():
    """Every encodable dtype, dataclass and dict payloads: the encoder's
    columns equal the Python staging loop byte for byte, and the JAX
    package's encoder; an int32 overflow raises (the JAX encoder wraps)
    and a missing field raises the payload's own error."""
    rng = np.random.default_rng(11)
    vals = rng.integers(-2**31, 2**31 - 1, 300)
    fl = rng.standard_normal(300) * 1e5
    rows = [Row(int(v), float(f), int(v) * 3) for v, f in zip(vals, fl)]
    drows = [dataclasses.asdict(r) for r in rows]
    sch = TupleSchema({"a": np.int32, "b": np.float32, "c": np.int64})
    for payloads in (rows, drows):
        pairs = [(p, i) for i, p in enumerate(payloads)]
        py, ts_py, used_py = sch.to_columns(pairs, 512)
        nat, ts_nat, used_nat = sch.to_columns(pairs, 512, native=True)
        assert (used_py, used_nat) == (False, True)
        assert np.array_equal(ts_py, ts_nat)
        for name, dt in (("a", np.int32), ("b", np.float32),
                         ("c", np.int64), ("b", np.float64)):
            ref = np.zeros(300, dtype=dt)
            out = np.zeros(300, dtype=dt)
            encode_column(payloads, name, out)
            for i, p in enumerate(payloads):
                ref[i] = p[name] if isinstance(p, dict) else getattr(p,
                                                                     name)
            assert out.tobytes() == ref.tobytes()
            if avail_j():
                outj = np.zeros(300, dtype=dt)
                encode_j(payloads, name, outj)
                assert out.tobytes() == outj.tobytes()
            if name != "b" or dt == np.float32:
                assert out.tobytes() == \
                    nat[name][:300].tobytes() == py[name][:300].tobytes()
    big = [{"a": 2**31}]
    with pytest.raises(OverflowError):
        encode_column(big, "a", np.zeros(1, dtype=np.int32))
    with pytest.raises(OverflowError):
        TupleSchema({"a": np.int32}).to_columns([(big[0], 0)], 8,
                                                native=True)
    if avail_j():
        wrapped = np.zeros(1, dtype=np.int32)
        encode_j(big, "a", wrapped)
        assert wrapped[0] == -2**31  # the JAX encoder truncates
    with pytest.raises(KeyError):
        encode_column([{"b": 1}], "a", np.zeros(1, dtype=np.int32))


def _native_graph(pkg, name, **kw):
    acc = []
    lock = threading.Lock()

    def src(shipper, ctx):
        for i in range(ctx.get_replica_index(), 400, ctx.get_parallelism()):
            shipper.push({"key": i % 7, "value": i})

    def sink(t):
        if t is not None:
            with lock:
                acc.append((t["key"], t["value"]))

    extra = {"device": "cpu", **kw} if pkg is wt else {}
    g = pkg.PipeGraph(name, **extra)
    g.add_source(pkg.Source_Builder(src).with_parallelism(2)
                 .with_output_batch_size(16).build()) \
        .add(pkg.Map_Builder(lambda t: {"key": t["key"],
                                        "value": t["value"] * 2})
             .with_parallelism(3).build()) \
        .add_sink(pkg.Sink_Builder(sink).build())
    run_bounded(g)
    return sorted(acc), g


def test_pipeline_on_native_channels_matches_jax(monkeypatch):
    """The same host graph on the port's native channels, on its Python
    channels, and on the JAX package's native channels: equal rows; every
    channel of the native graph is a NativeChannel."""
    monkeypatch.setenv("WF_NATIVE_CHANNELS", "1")
    ref, _ = _native_graph(wj, "nat_j")
    got, g = _native_graph(wt, "nat_t", native_channels=True)
    py, _ = _native_graph(wt, "nat_py")
    assert got == py == ref and len(got) == 400
    chans = [ch for s in g._stages for ch in s.channels]
    assert chans and all(isinstance(ch, NativeChannel) for ch in chans)


@pytest.mark.parametrize("native", [True, False])
def test_row_staging_with_encoders_matches_jax(native):
    """Rows staged into a device chain with the encoders on and off: the
    rows equal the JAX package's, and the staging replica counts the
    batches the encoders filled (all of them, or none)."""
    def build(pkg, name):
        out = []

        def src(shipper):
            for i in range(500):
                shipper.push({"key": i % 5, "value": i, "w": i * 0.25})

        g = pkg.PipeGraph(name, **({"device": "cpu"} if pkg is wt else {}))
        if pkg is wt:
            g._native_encoders = native
        if pkg is wt:
            mb = wt.Map_GPU_Builder
        else:
            from windflow_tpu.tpu import Map_TPU_Builder as mb
        g.add_source(pkg.Source_Builder(src).with_output_batch_size(64)
                     .build()) \
            .add(mb(lambda f: {**f, "value": f["value"] * 3}).build()) \
            .add_sink(pkg.Sink_Builder(
                lambda t: out.append((t["key"], t["value"], t["w"]))
                if t is not None else None).build())
        run_bounded(g)
        return out, g

    got, g = build(wt, f"enc_t{int(native)}")
    ref, _ = build(wj, f"enc_j{int(native)}")
    assert got == ref and len(got) == 500
    ops = g.get_stats()["Operators"]
    src = ops[0]["replicas"][0]
    n_batches = ops[1]["replicas"][0]["Device_batches_in"]
    assert n_batches >= -(-500 // 64)
    assert src["Staging_native_batches"] == (n_batches if native else 0)
    assert torch.equal(torch.tensor([v for _, v, _ in got]),
                       torch.arange(500) * 3)
