"""Staging-buffer recycling of the port (``windflow_tpu_torch.recycling``)
held against the JAX package's (``windflow_tpu/recycling.py``): the five
cases of ``tests/test_recycling.py`` run through both packages, and the
staging edge of a port graph on ``device="cpu"`` never recycles (its
columns alias the staging buffers).

The FIFO test forces the port's recycler on (``force=True``) with no
release event: on the CPU nothing marks a copy as done, so it checks the
mechanics only. The pooled path with pinned tensors and CUDA events runs
on the card (``chip_smoke.py`` prints its pool hits and misses).

Tolerance: exact (counts, identities and staged values)."""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

import windflow_tpu.recycling as rj
import windflow_tpu_torch as wt
import windflow_tpu_torch.recycling as rt
from torch_waits import join_bounded, run_bounded

MODS = pytest.mark.parametrize("rec", [rj, rt], ids=["jax", "torch"])


@MODS
def test_array_pool_reuse_and_zeroing(rec):
    pool = rec.ArrayPool(max_per_bucket=4)
    a = pool.acquire(np.int32, 64)
    a[:] = 7
    pool.release(a)
    b = pool.acquire(np.int32, 64)
    assert b is a  # reused
    assert (b == 0).all()  # zeroed on reacquire
    c = pool.acquire(np.float32, 64)
    assert c is not a and c.dtype == np.float32
    assert (pool.hits, pool.misses) == (1, 2)


@MODS
def test_array_pool_bucket_cap(rec):
    pool = rec.ArrayPool(max_per_bucket=2)
    arrs = [pool.acquire(np.int64, 8) for _ in range(5)]
    for a in arrs:
        pool.release(a)
    assert len(pool._free[(str(np.dtype(np.int64)), 8)]) == 2


@MODS
def test_object_pool_threaded(rec):
    made = []

    def factory():
        o = {"v": 0}
        made.append(o)
        return o

    pool = rec.ObjectPool(factory, reset=lambda o: o.update(v=0),
                          max_size=16)

    def worker():
        for _ in range(500):
            o = pool.acquire()
            o["v"] += 1
            pool.release(o)

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        join_bounded(t)
    assert len(made) <= 32  # heavy reuse, not 2000 allocations


def _fifo(rec):
    pool = rec.ArrayPool()
    r = rec.InFlightRecycler(pool, max_in_flight=2, force=True)
    for _ in range(6):
        host = pool.acquire(np.int32, 32)
        if rec is rj:
            import jax
            r.track([jax.device_put(np.asarray(host))], [host])
        else:
            r.track(None, [host])
    key = (str(np.dtype(np.int32)), 32)
    before = (len(r._q), len(pool._free[key]), pool.hits, pool.misses)
    r.drain()
    return before + (len(r._q), len(pool._free[key]))


def test_in_flight_recycler_fifo_mechanics():
    """Bounded FIFO: beyond max_in_flight the oldest batch is waited on
    and its buffers return to the pool. Released buffers are re-acquired
    at once each iteration: only the latest release is free, and 3
    acquires were hits; the drain returns the rest."""
    got = [_fifo(rj), _fifo(rt)]
    assert got[0] == got[1] == (2, 1, 3, 3, 0, 3)


def test_staging_recycling_gated_on_cpu():
    """On the CPU a staged column aliases its buffer and no point makes
    the buffer's reuse safe: both recyclers turn themselves off, and every
    staged batch keeps its own values when batches are staged back to
    back."""
    import jax
    from windflow_tpu.tpu.batch import BatchTPU
    from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
    from windflow_tpu_torch.gpu.batch import BatchGPU
    from windflow_tpu_torch.gpu.schema import TupleSchema as SchemaT

    rec_j = rj.InFlightRecycler(rj.ArrayPool(), max_in_flight=4)
    rec_t = rt.InFlightRecycler(rt.ArrayPool(), max_in_flight=4,
                                device="cpu")
    assert jax.default_backend() == "cpu"
    assert not rec_j.enabled and not rec_t.enabled
    cpu = torch.device("cpu")
    staged = []
    for i in range(40):
        rows = [({"v": i * 100 + j}, j) for j in range(16)]
        bj = BatchTPU.stage(rows, SchemaJ({"v": np.int32}), 0, capacity=16,
                            recycler=rec_j)
        bt = BatchGPU.stage_rows(rows, SchemaT({"v": np.int32}), 0, cpu,
                                 capacity=16, recycler=rec_t)
        staged.append((i, bj, bt))
    for i, bj, bt in staged:
        want = np.arange(16) + i * 100
        assert (np.asarray(bj.fields["v"])[:16] == want).all(), i
        assert (bt.fields["v"].numpy()[:16] == want).all(), i
    assert rec_t.pool.hits == rec_t.pool.misses == 0


def test_graph_staging_on_cpu_never_recycles():
    """A port graph on ``device="cpu"``: its staging edge's recycler is
    off, the pool is never asked (``Staging_pool_hits`` and ``_misses``
    stay 0) and the output is the stream's."""
    n, obs = 4096, 256
    vals = np.arange(n, dtype=np.int32)
    got = []

    def src():
        for lo in range(0, n, 1000):
            yield {"key": vals[lo:lo + 1000] % 7,
                   "value": vals[lo:lo + 1000]}

    def sink(t):
        if t is not None:
            got.append(int(t["value"]))

    g = wt.PipeGraph("stage_cpu", device="cpu")
    mp = g.add_source(wt.Columnar_Source_Builder(src)
                      .with_output_batch_size(obs).build())
    mp.add(wt.Map_GPU_Builder(lambda f: {**f, "value": f["value"] * 2})
           .build()).add_sink(wt.Sink_Builder(sink).build())
    run_bounded(g)
    assert sorted(got) == (vals.astype(np.int64) * 2).tolist()
    em = g._stages[0].last_op.replicas[0].emitter
    assert not em.recycler.enabled
    src_stats = g.get_stats()["Operators"][0]["replicas"][0]
    assert src_stats["Staging_pool_hits"] == 0
    assert src_stats["Staging_pool_misses"] == 0
