"""Split/select/merge in the port, held against the JAX package: the
DEFAULT-mode cases of ``tests/test_split_merge.py`` (host operators) and
every case of ``tests/test_tpu_split_merge.py`` (branches and merges of
device operators, the device-plane splitting emitter, field routing and
its out-of-range refusal). Each case builds the same graph with each
package's own builders, on the same seeded degrees and streams, the JAX
side on its CPU backend and the port with ``device="cpu"``.

Tolerance: every aggregate is an integer sum or count, compared exactly
between the packages and with the closed-form value."""

import random
import threading
from types import SimpleNamespace

import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.tpu import (Filter_TPU_Builder, Map_TPU_Builder,
                              Reduce_TPU_Builder)

from common import (GlobalSum, TupleT, make_ingress_source, make_sum_sink,
                    rand_batch, rand_degree)

N_KEYS = 6
STREAM_LEN = 40
DEV_STREAM_LEN = 60
RUNS = 3


def _pkg(pkg):
    """Builders and graph keywords of one package."""
    if pkg is wj:
        return SimpleNamespace(pkg=wj, Map=Map_TPU_Builder,
                               Filter=Filter_TPU_Builder,
                               Reduce=Reduce_TPU_Builder, kw={})
    return SimpleNamespace(pkg=wt, Map=wt.Map_GPU_Builder,
                           Filter=wt.Filter_GPU_Builder,
                           Reduce=wt.Reduce_GPU_Builder,
                           kw={"device": "cpu"})


def _graph(p, name):
    return p.pkg.PipeGraph(name, p.pkg.ExecutionMode.DEFAULT, **p.kw)


def _both(case, *args):
    """Run ``case`` through each package; the results must be equal."""
    res = [case(_pkg(pkg), *args) for pkg in (wj, wt)]
    assert res[0] == res[1], f"JAX {res[0]} != port {res[1]}"
    return res[1]


# ---------------------------------------------------------------------------
# tests/test_split_merge.py, DEFAULT mode: host-plane operators
# ---------------------------------------------------------------------------
def _split_two_branches(p, seed):
    rng = random.Random(seed)
    runs = []
    for _ in range(RUNS):
        acc0, acc1 = GlobalSum(), GlobalSum()
        graph = _graph(p, "split2")
        src = (p.pkg.Source_Builder(make_ingress_source(N_KEYS, STREAM_LEN))
               .with_parallelism(rand_degree(rng))
               .with_output_batch_size(rand_batch(rng)).build())
        mp = graph.add_source(src)
        mp.split(lambda t: 0 if t.value % 2 == 0 else 1, 2)
        b0 = mp.select(0)
        b0.add(p.pkg.Map_Builder(lambda t: TupleT(t.key, t.value * 2))
               .with_parallelism(rand_degree(rng))
               .with_output_batch_size(rand_batch(rng)).build())
        b0.add_sink(p.pkg.Sink_Builder(make_sum_sink(acc0))
                    .with_parallelism(rand_degree(rng)).build())
        b1 = mp.select(1)
        b1.add(p.pkg.Map_Builder(lambda t: TupleT(t.key, -t.value))
               .with_parallelism(rand_degree(rng))
               .with_output_batch_size(rand_batch(rng)).build())
        b1.add_sink(p.pkg.Sink_Builder(make_sum_sink(acc1))
                    .with_parallelism(rand_degree(rng)).build())
        run_bounded(graph)
        runs.append((acc0.value, acc1.value, acc0.count, acc1.count))
    assert len(set(runs)) == 1, f"runs diverged: {runs}"
    return runs[0]


def test_split_two_branches():
    """Even values to branch 0 (doubled), odd to branch 1 (negated), with
    randomized degrees and batch sizes: every run gives one checksum."""
    got = _both(_split_two_branches, 7)
    evens = sum(v for v in range(1, STREAM_LEN + 1) if v % 2 == 0)
    odds = sum(v for v in range(1, STREAM_LEN + 1) if v % 2 == 1)
    assert got[0] == N_KEYS * 2 * evens
    assert got[1] == -N_KEYS * odds


def _split_broadcast_indices(p):
    accA, accB = GlobalSum(), GlobalSum()
    graph = _graph(p, "split_multi")
    mp = graph.add_source(p.pkg.Source_Builder(make_ingress_source(2, 10))
                          .build())
    mp.split(lambda t: [0, 1] if t.value % 5 == 0 else [0], 2)
    mp.select(0).add_sink(p.pkg.Sink_Builder(make_sum_sink(accA)).build())
    mp.select(1).add_sink(p.pkg.Sink_Builder(make_sum_sink(accB)).build())
    run_bounded(graph)
    return accA.count, accB.count, accB.value


def test_split_broadcast_indices():
    """Splitting logic may return several branch indices: the tuple is
    copied to each (``wf/splitting_emitter.hpp``)."""
    assert _both(_split_broadcast_indices) == (2 * 10, 2 * 2, 2 * 15)


def _merge_two_pipes(p, seed):
    rng = random.Random(seed)
    runs = []
    for _ in range(RUNS):
        acc = GlobalSum()
        graph = _graph(p, "merge2")
        mp1 = graph.add_source(
            p.pkg.Source_Builder(make_ingress_source(N_KEYS, STREAM_LEN))
            .with_parallelism(rand_degree(rng))
            .with_output_batch_size(rand_batch(rng)).build())
        mp1.add(p.pkg.Map_Builder(lambda t: TupleT(t.key, t.value * 10))
                .with_parallelism(rand_degree(rng)).build())
        mp2 = graph.add_source(
            p.pkg.Source_Builder(make_ingress_source(N_KEYS, STREAM_LEN))
            .with_parallelism(rand_degree(rng))
            .with_output_batch_size(rand_batch(rng)).build())
        mp2.add(p.pkg.Filter_Builder(lambda t: t.value % 2 == 0)
                .with_parallelism(rand_degree(rng)).build())
        mp1.merge(mp2).add_sink(p.pkg.Sink_Builder(make_sum_sink(acc))
                                .with_parallelism(rand_degree(rng)).build())
        run_bounded(graph)
        runs.append((acc.value, acc.count))
    assert len(set(runs)) == 1, f"runs diverged: {runs}"
    return runs[0]


def test_merge_two_pipes():
    got = _both(_merge_two_pipes, 21)
    tot = sum(range(1, STREAM_LEN + 1))
    evens = sum(v for v in range(1, STREAM_LEN + 1) if v % 2 == 0)
    assert got[0] == N_KEYS * (10 * tot + evens)


def _diamond(p):
    acc = GlobalSum()
    graph = _graph(p, "diamond")
    mp = graph.add_source(p.pkg.Source_Builder(make_ingress_source(4, 30))
                          .with_parallelism(2).build())
    mp.split(lambda t: t.value % 2, 2)
    b0 = mp.select(0).add(p.pkg.Map_Builder(
        lambda t: TupleT(t.key, t.value)).build())
    b1 = mp.select(1).add(p.pkg.Map_Builder(
        lambda t: TupleT(t.key, 1000 * t.value)).build())
    b0.merge(b1).add_sink(p.pkg.Sink_Builder(make_sum_sink(acc)).build())
    run_bounded(graph)
    return acc.value, acc.count


def test_split_then_merge_diamond():
    """Diamond: split into two transformed branches, merge into one sink."""
    evens = sum(v for v in range(1, 31) if v % 2 == 0)
    odds = sum(v for v in range(1, 31) if v % 2 == 1)
    assert _both(_diamond) == (4 * (evens + 1000 * odds), 4 * 30)


@pytest.mark.parametrize("pkg", [wj, wt], ids=["jax", "torch"])
def test_topology_misuse_raises(pkg):
    """The same misuse is refused by both packages: an operator after a
    sink, operator reuse, an empty graph, a stage with no sink, and the
    split-specific refusals (select without split, a split tail reused,
    an empty branch, an out-of-range select, a split right after a
    merge)."""
    p = _pkg(pkg)
    graph = _graph(p, "misuse")
    src = p.pkg.Source_Builder(make_ingress_source(1, 1)).build()
    mp = graph.add_source(src)
    mp.add_sink(p.pkg.Sink_Builder(lambda t: None).build())
    with pytest.raises(pkg.WindFlowError, match="already has a sink"):
        mp.add(p.pkg.Map_Builder(lambda t: t).build())
    with pytest.raises(pkg.WindFlowError, match="already added"):
        graph.add_source(src)
    with pytest.raises(pkg.WindFlowError, match="empty PipeGraph"):
        run_bounded(_graph(p, "empty"))
    g3 = _graph(p, "nosink")
    g3.add_source(p.pkg.Source_Builder(make_ingress_source(1, 1)).build())
    with pytest.raises(pkg.WindFlowError, match="no sink downstream"):
        run_bounded(g3)
    g4 = _graph(p, "split_misuse")
    mp4 = g4.add_source(p.pkg.Source_Builder(make_ingress_source(1, 4))
                        .build())
    with pytest.raises(pkg.WindFlowError, match="previous split"):
        mp4.select(0)
    with pytest.raises(pkg.WindFlowError, match="at least 2 branches"):
        mp4.split(lambda t: 0, 1)
    mp4.split(lambda t: 0, 2)
    with pytest.raises(pkg.WindFlowError, match="was split"):
        mp4.add(p.pkg.Map_Builder(lambda t: t).build())
    with pytest.raises(pkg.WindFlowError, match="out of range"):
        mp4.select(2)
    mp4.select(0).add_sink(p.pkg.Sink_Builder(lambda t: None).build())
    with pytest.raises(pkg.WindFlowError, match="empty branches"):
        run_bounded(g4)
    g5 = _graph(p, "merge_split")
    a = g5.add_source(p.pkg.Source_Builder(make_ingress_source(1, 1))
                      .build())
    b = g5.add_source(p.pkg.Source_Builder(make_ingress_source(1, 1))
                      .build())
    with pytest.raises(pkg.WindFlowError, match="after a merge"):
        a.merge(b).split(lambda t: 0, 2)


# ---------------------------------------------------------------------------
# tests/test_tpu_split_merge.py: device operators on the branches
# ---------------------------------------------------------------------------
def _split_into_device_branches(p, seed):
    rng = random.Random(seed)
    runs = []
    for _ in range(RUNS):
        accA, accB = GlobalSum(), GlobalSum()
        graph = _graph(p, "split_dev")
        mp = graph.add_source(
            p.pkg.Source_Builder(make_ingress_source(N_KEYS,
                                                     DEV_STREAM_LEN))
            .with_parallelism(rand_degree(rng))
            .with_output_batch_size(16).build())
        mp.split(lambda t: 0 if t.value % 2 == 0 else 1, 2)
        b0 = mp.select(0)
        b0.add(p.Map(lambda f: {**f, "value": f["value"] * 10})
               .with_parallelism(rand_degree(rng)).build())
        b0.add_sink(p.pkg.Sink_Builder(make_sum_sink(accA)).build())
        b1 = mp.select(1)
        b1.add(p.Filter(lambda f: f["value"] % 3 != 0)
               .with_parallelism(rand_degree(rng)).build())
        b1.add_sink(p.pkg.Sink_Builder(make_sum_sink(accB)).build())
        run_bounded(graph)
        runs.append((accA.value, accA.count, accB.value, accB.count))
    assert len(set(runs)) == 1, f"runs diverged: {runs}"
    return runs[0]


def test_split_into_device_branches():
    """A host split whose branches are device pipelines
    (split_tests_gpu)."""
    got = _both(_split_into_device_branches, 11)
    evens = [v for v in range(1, DEV_STREAM_LEN + 1) if v % 2 == 0]
    odds = [v for v in range(1, DEV_STREAM_LEN + 1) if v % 2 == 1]
    assert got[0] == N_KEYS * 10 * sum(evens)
    assert got[2] == N_KEYS * sum(v for v in odds if v % 3 != 0)


def _keyed_sink():
    acc, lock = {}, threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                acc[int(t.key)] = acc.get(int(t.key), 0) + int(t.value)
    return acc, sink


def _merge_device_pipelines_kb(p):
    acc, sink = _keyed_sink()
    graph = _graph(p, "merge_dev_kb")
    mp1 = graph.add_source(
        p.pkg.Source_Builder(make_ingress_source(N_KEYS, DEV_STREAM_LEN))
        .with_parallelism(2).with_output_batch_size(16).build())
    mp1.add(p.Map(lambda f: {**f, "value": f["value"] * 2})
            .with_key_by("key").with_parallelism(2).build())
    mp2 = graph.add_source(
        p.pkg.Source_Builder(make_ingress_source(N_KEYS, DEV_STREAM_LEN))
        .with_parallelism(1).with_output_batch_size(8).build())
    mp2.add(p.Map(lambda f: {**f, "value": f["value"] * 5})
            .with_key_by("key").with_parallelism(2).build())
    merged = mp1.merge(mp2)
    merged.add(p.Reduce(
        lambda a, b: {"key": b["key"], "value": a["value"] + b["value"]})
        .with_key_by("key").with_parallelism(3).build())
    merged.add_sink(p.pkg.Sink_Builder(sink).build())
    run_bounded(graph)
    return acc


def test_merge_device_pipelines_kb():
    """Two device pipelines merged into one keyed device reduce (the _kb
    merge variant: the merged edge is a keyed device -> device shuffle)."""
    total = sum(range(1, DEV_STREAM_LEN + 1))
    assert _both(_merge_device_pipelines_kb) == \
        {k: 7 * total for k in range(N_KEYS)}


def _device_exit_then_diamond(p):
    acc = GlobalSum()
    graph = _graph(p, "dev_diamond")
    mp = graph.add_source(p.pkg.Source_Builder(make_ingress_source(4, 50))
                          .with_output_batch_size(16).build())
    mp.add(p.Map(lambda f: {**f, "value": f["value"] + 1}).build())
    mp.add(p.pkg.Map_Builder(lambda t: t).build())  # exit to the host
    mp.split(lambda t: t.value % 2, 2)
    b0 = mp.select(0).add(p.pkg.Map_Builder(
        lambda t: TupleT(t.key, t.value)).build())
    b1 = mp.select(1).add(p.pkg.Map_Builder(
        lambda t: TupleT(t.key, 100 * t.value)).build())
    b0.merge(b1).add_sink(p.pkg.Sink_Builder(make_sum_sink(acc)).build())
    run_bounded(graph)
    return acc.value, acc.count


def test_device_exit_then_split_then_merge():
    """Device stage -> host exit -> split -> per-branch host transforms ->
    merge -> sink: the diamond with a device head."""
    vals = [v + 1 for v in range(1, 51)]
    expected = 4 * sum(v if v % 2 == 0 else 100 * v for v in vals)
    assert _both(_device_exit_then_diamond) == (expected, 4 * 50)


def _split_after_device_callable(p, seed):
    rng = random.Random(seed)
    runs = []
    for _ in range(RUNS):
        accA, accB = GlobalSum(), GlobalSum()
        graph = _graph(p, "dev_split_direct")
        mp = graph.add_source(
            p.pkg.Source_Builder(make_ingress_source(N_KEYS,
                                                     DEV_STREAM_LEN))
            .with_parallelism(rand_degree(rng))
            .with_output_batch_size(16).build())
        mp.add(p.Map(lambda f: {**f, "value": f["value"] + 1})
               .with_parallelism(rand_degree(rng)).build())
        mp.split(lambda t: 0 if t.value % 2 == 0 else 1, 2)
        b0 = mp.select(0)
        b0.add(p.Filter(lambda f: f["value"] % 3 != 0)
               .with_parallelism(rand_degree(rng)).build())
        b0.add_sink(p.pkg.Sink_Builder(make_sum_sink(accA)).build())
        mp.select(1).add_sink(p.pkg.Sink_Builder(make_sum_sink(accB))
                              .build())
        run_bounded(graph)
        runs.append((accA.value, accA.count, accB.value, accB.count))
    assert len(set(runs)) == 1, f"runs diverged: {runs}"
    return runs[0]


def test_split_directly_after_device_callable():
    """Device-plane split (reference splitting_emitter_gpu) with a
    callable: source -> Map -> split -> {Filter -> sink, sink}, randomized
    degrees."""
    got = _both(_split_after_device_callable, 21)
    vals = [v + 1 for v in range(1, DEV_STREAM_LEN + 1)]
    assert got[0] == N_KEYS * sum(v for v in vals
                                  if v % 2 == 0 and v % 3 != 0)
    assert got[2] == N_KEYS * sum(v for v in vals if v % 2 == 1)


def _split_field_routing(p):
    accA, accB = GlobalSum(), GlobalSum()
    graph = _graph(p, "dev_split_field")
    mp = graph.add_source(
        p.pkg.Source_Builder(make_ingress_source(N_KEYS, DEV_STREAM_LEN))
        .with_output_batch_size(16).build())
    mp.add(p.Map(lambda f: {**f, "branch": f["value"] % 2}).build())
    mp.split("branch", 2)
    mp.select(0).add_sink(p.pkg.Sink_Builder(make_sum_sink(accA)).build())
    b1 = mp.select(1)
    b1.add(p.Map(lambda f: {**f, "value": f["value"] * 7}).build())
    b1.add_sink(p.pkg.Sink_Builder(make_sum_sink(accB)).build())
    run_bounded(graph)
    if p.pkg is wt:  # the device plane's splitting emitter routed it
        from windflow_tpu_torch.gpu.emitters_gpu import GPUSplittingEmitter
        em = graph._stages[1].last_op.replicas[0].emitter
        assert isinstance(em, GPUSplittingEmitter)
    return accA.value, accB.value, accA.count, accB.count


def test_split_after_device_field_routing():
    """Branch routing by a device-computed int field: one column read
    back, no per-tuple Python."""
    evens = [v for v in range(1, DEV_STREAM_LEN + 1) if v % 2 == 0]
    odds = [v for v in range(1, DEV_STREAM_LEN + 1) if v % 2 == 1]
    assert _both(_split_field_routing) == (
        N_KEYS * sum(evens), N_KEYS * 7 * sum(odds),
        N_KEYS * len(evens), N_KEYS * len(odds))


def _split_multi_select_keyed(p):
    accB = GlobalSum()
    red_acc, red_sink = _keyed_sink()
    graph = _graph(p, "dev_split_multi")
    mp = graph.add_source(
        p.pkg.Source_Builder(make_ingress_source(N_KEYS, DEV_STREAM_LEN))
        .with_output_batch_size(16).build())
    mp.add(p.Map(lambda f: dict(f)).with_key_by("key").build())
    mp.split(lambda t: (0, 1) if t.value % 10 == 0 else 1, 2)
    b0 = mp.select(0)
    b0.add(p.Reduce(
        lambda a, b: {"key": b["key"], "value": a["value"] + b["value"]})
        .with_key_by("key").with_parallelism(2).build())
    b0.add_sink(p.pkg.Sink_Builder(red_sink).build())
    mp.select(1).add_sink(p.pkg.Sink_Builder(make_sum_sink(accB)).build())
    run_bounded(graph)
    return red_acc, accB.value, accB.count


def test_split_after_device_multi_select_and_keyed_branch():
    """A callable selecting SEVERAL branches per tuple; one branch
    re-shards keyed into a device reduce."""
    tens = [v for v in range(1, DEV_STREAM_LEN + 1) if v % 10 == 0]
    red, total, count = _both(_split_multi_select_keyed)
    assert red == {k: sum(tens) for k in range(N_KEYS)}
    assert total == N_KEYS * sum(range(1, DEV_STREAM_LEN + 1))
    assert count == N_KEYS * DEV_STREAM_LEN


@pytest.mark.parametrize("pkg", [wj, wt], ids=["jax", "torch"])
def test_split_field_routing_out_of_range(pkg):
    """A branch field outside [0, n_branches) is refused, in both
    packages with the same reason."""
    p = _pkg(pkg)
    graph = _graph(p, "dev_split_oob")
    mp = graph.add_source(p.pkg.Source_Builder(make_ingress_source(1, 8))
                          .with_output_batch_size(4).build())
    mp.add(p.Map(lambda f: {**f, "branch": f["value"]}).build())
    mp.split("branch", 2)
    mp.select(0).add_sink(p.pkg.Sink_Builder(lambda t: None).build())
    mp.select(1).add_sink(p.pkg.Sink_Builder(lambda t: None).build())
    with pytest.raises(pkg.WindFlowError, match="branch index"):
        run_bounded(graph)
