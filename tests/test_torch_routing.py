"""Keyby routing and the host halves of the port's device programs, held
against the JAX package on the same numpy inputs made from a seed:

- the key -> destination helpers (``gpu/routing.py``) against the JAX
  package's per-row ``_dest_of_key``, for every key kind;
- one key, one replica: the port's CPU -> device staging emitter (row and
  column paths) and its device -> device re-shard send each key where the
  JAX staging emitter sends it, and the re-shard's sub-batches hold
  exactly their rows;
- the Filter compaction permutation (``compact_order``) against
  ``_compact_order``, on bool and int 0/1 masks;
- the keyed Reduce's host order, sorted slots and segment tails against
  ``reduce_order_and_slots`` and ``jnp.nonzero(..., size=n)``.

All comparisons are exact (integer outputs)."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from windflow_tpu.tpu import emitters_tpu as ej
from windflow_tpu.tpu.batch import BatchTPU
from windflow_tpu.tpu.ops_tpu import _compact_order
from windflow_tpu.tpu.ops_tpu import reduce_order_and_slots as order_jax
from windflow_tpu.tpu.schema import TupleSchema as SchemaJ
from windflow_tpu_torch import ExecutionMode
from windflow_tpu_torch.gpu import routing
from windflow_tpu_torch.gpu.batch import BatchGPU
from windflow_tpu_torch.gpu.emitters_gpu import (GPUKeyByEmitter,
                                                 GPUStageEmitter)
from windflow_tpu_torch.gpu.ops_gpu import (compact_order,
                                            reduce_order_and_slots)
from windflow_tpu_torch.gpu.schema import TupleSchema
from windflow_tpu_torch.kernels.reduce_fold import keyed_fold

N_DESTS = 3
CPU = torch.device("cpu")


def _keys(kind, n, seed):
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 40, n)
    if kind == "int32":
        return ints.astype(np.int32)
    if kind == "uint16":
        return ints.astype(np.uint16)
    if kind == "negative_int64":
        return (ints - 20).astype(np.int64)
    if kind == "float32":
        return np.where(ints % 2 == 0, ints, ints + 0.25).astype(np.float32)
    if kind == "str":
        return np.array([f"sym{i:02d}" for i in ints])
    if kind == "bytes":
        return np.array([b"k" * (1 + i % 5) + bytes([65 + i % 26])
                         for i in ints])
    if kind == "str_list":
        return [f"user-{i}" for i in ints]
    if kind == "tuple_list":
        return [(int(i), int(i) % 3) for i in ints]
    raise ValueError(kind)


KINDS = ["int32", "uint16", "negative_int64", "float32", "str", "bytes",
         "str_list", "tuple_list"]


@pytest.mark.parametrize("kind", KINDS)
def test_key_dests_match_jax_per_row_routing(kind):
    keys = _keys(kind, 300, seed=1)
    rows = keys.tolist() if isinstance(keys, np.ndarray) else keys
    ref = [ej._dest_of_key(k, N_DESTS) for k in rows]
    assert routing.key_dests(keys, len(rows), N_DESTS).tolist() == ref
    # the same keys sent one per row take the scalar path: same answer
    assert [routing._dest_of_key(k, N_DESTS) for k in rows] == ref
    assert len(set(ref)) == N_DESTS  # the keys reach every destination


class _Port:
    def __init__(self):
        self.batches = []

    def send(self, b):
        if getattr(b, "size", None):
            self.batches.append(b)

    def send_eos(self):
        pass


def _dest_map(ports):
    """key -> destination over every batch the ports received; a key seen
    at two destinations fails."""
    m = {}
    for d, p in enumerate(ports):
        for b in p.batches:
            hk = b.host_keys
            for k in (hk.tolist() if isinstance(hk, np.ndarray) else hk):
                assert m.setdefault(k, d) == d, f"key {k!r} split"
    return m


def _stage(pkg, schema, key_field, obs=32):
    if pkg == "jax":
        em = ej.TPUStageEmitter(N_DESTS, obs, SchemaJ(schema),
                                lambda t: t["k"], "keyby", key_field="k")
    else:
        em = GPUStageEmitter(N_DESTS, obs, TupleSchema(schema),
                             lambda t: t["k"], "keyby",
                             ExecutionMode.DEFAULT, key_field, CPU)
    ports = [_Port() for _ in range(N_DESTS)]
    em.set_ports(ports)
    return em, ports


@pytest.mark.parametrize("kind", ["int32", "negative_int64", "str"])
def test_staging_rows_columns_and_reshard_agree_with_jax(kind):
    """Rows and column blocks through the port's keyed staging, and a
    keyless device batch through its keyed re-shard, route every key to
    the replica the JAX staging emitter picks."""
    keys = _keys(kind, 200, seed=2)
    vals = np.arange(200, dtype=np.float32)
    schema = {"v": np.float32}
    ref_em, ref_ports = _stage("jax", schema, "k")
    ref_em.emit_columns({"k": keys, "v": vals},
                        np.arange(200, dtype=np.int64), wm=0)
    ref_em.flush()
    ref = _dest_map(ref_ports)

    col_em, col_ports = _stage("port", schema, "k")
    col_em.emit_columns({"k": keys, "v": vals},
                        np.arange(200, dtype=np.int64), wm=0)
    col_em.flush()
    row_em, row_ports = _stage("port", schema, None)
    for i, (k, v) in enumerate(zip(keys.tolist(), vals.tolist())):
        row_em.emit({"k": k, "v": v}, i, 0)
    row_em.flush()
    assert _dest_map(col_ports) == _dest_map(row_ports) == ref

    if kind == "str":
        return  # str keys are host metadata only, never a device column
    # a keyless device batch keyed by its column: the re-shard reads the
    # column back and gathers one sub-batch per destination
    n = len(keys)
    sch = TupleSchema({"k": keys.dtype, "v": np.float32})
    batch = BatchGPU({"k": torch.from_numpy(keys.copy()),
                      "v": torch.from_numpy(vals.copy())},
                     np.arange(n, dtype=np.int64) * 10, n, sch)
    kb = GPUKeyByEmitter(N_DESTS, key_field="k")
    kb_ports = [_Port() for _ in range(N_DESTS)]
    kb.set_ports(kb_ports)
    kb.emit_device_batch(batch)
    kb.flush()
    assert _dest_map(kb_ports) == ref
    seen = []
    for p in kb_ports:
        for sub in p.batches:
            m = sub.size
            rows = sub.ts_host[:m] // 10
            assert np.array_equal(sub.fields["k"][:m].numpy(), keys[rows])
            assert np.array_equal(sub.fields["v"][:m].numpy(), vals[rows])
            assert np.array_equal(np.asarray(sub.host_keys), keys[rows])
            seen.extend(rows.tolist())
    assert sorted(seen) == list(range(n))


@pytest.mark.parametrize("n", [1, 7, 64, 1000])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("mask", ["bool", "int"])
def test_compact_order_matches_jax(n, density, mask):
    rng = np.random.default_rng(n + int(10 * density))
    keep = rng.random(n) < density
    if mask == "int":
        keep = keep.astype(np.int32)
    ref = np.asarray(_compact_order(jnp.asarray(keep)))
    order, count = compact_order(torch.from_numpy(keep))
    assert order.dtype == torch.int32
    assert np.array_equal(order.numpy(), ref)
    assert int(count) == int(np.count_nonzero(keep))


def _batches(kind, n, cap, seed):
    """The same batch for both packages: (jax batch, port batch, op)."""
    keys = _keys(kind, n, seed)
    vals = np.arange(cap, dtype=np.int32)
    if kind in ("int32", "negative_int64"):
        kcol = np.zeros(cap, dtype=keys.dtype)
        kcol[:n] = keys
        host = None  # keys read from the device column
        fields_j = {"key": jnp.asarray(kcol), "v": jnp.asarray(vals)}
        fields_t = {"key": torch.from_numpy(kcol), "v": torch.from_numpy(vals)}
        schema = {"key": keys.dtype, "v": np.int32}
    else:
        host = keys
        fields_j = {"v": jnp.asarray(vals)}
        fields_t = {"v": torch.from_numpy(vals)}
        schema = {"v": np.int32}
    ts = np.arange(cap, dtype=np.int64)
    bj = BatchTPU(fields_j, ts, n, SchemaJ(schema), 0, host)
    bt = BatchGPU(fields_t, ts, n, TupleSchema(schema), 0, host)
    op = SimpleNamespace(name="reduce", key_field="key", key_fields=None)
    return bj, bt, op


@pytest.mark.parametrize("kind", ["int32", "negative_int64", "str_list",
                                  "tuple_list"])
@pytest.mark.parametrize("n,cap", [(1, 8), (50, 64), (64, 64), (200, 256)])
def test_reduce_host_order_and_tails_match_jax(kind, n, cap):
    bj, bt, op = _batches(kind, n, cap, seed=n)
    o_j, s_j, k_j = order_jax(op, bj)
    o_t, s_t, k_t = reduce_order_and_slots(op, bt)
    assert np.array_equal(o_t, o_j) and np.array_equal(s_t, s_j)
    assert list(k_t.items()) == list(k_j.items())
    is_last = jnp.concatenate([jnp.asarray(s_j[1:] != s_j[:-1]),
                               jnp.ones((1,), dtype=bool)])
    ref = np.asarray(jnp.nonzero(is_last, size=cap, fill_value=cap - 1)[0])
    n_out = len(k_t)
    # the keyed fold (K7's plain version) takes each slot from the tail
    # JAX's nonzero finds: a take-the-later combine over the row indices
    # leaves each slot its tail's row
    rows = {"r": torch.arange(cap, dtype=torch.int32)}
    out, ov = keyed_fold(lambda a, b: {"r": b["r"]}, rows,
                         torch.from_numpy(o_t), torch.from_numpy(s_t),
                         n_out, None, cap)
    assert ov[:n_out].all() and not ov[n_out:].any()
    assert np.array_equal(out["r"][:n_out].numpy(), o_j[ref[:n_out]])
