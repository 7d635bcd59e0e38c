"""The ported slice as a whole: ``Columnar_Source -> Ffat_Windows_{TPU,GPU}
-> Sink`` graphs built with each package's own builders, on the same
numpy stream made from a seed, with a row sink and with a
``with_columns()`` sink. The window rows must be equal: exactly for int32
fields, with ``rtol=1e-5`` for float32 fields (the scans group the combine
differently)."""

import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu.tpu import Ffat_Windows_TPU_Builder

N_SYMBOLS = 6
WIN_US, SLIDE_US = 40_000, 10_000
BATCH = 256


def _blocks(n_blocks, seed):
    """The ``examples/vwap.py`` tick stream, small: (cols, ts, wm) blocks."""
    rng = np.random.default_rng(seed)
    out, ts0 = [], 0
    for _ in range(n_blocks):
        ts = ts0 + np.arange(BATCH, dtype=np.int64) * 500
        ts0 = int(ts[-1]) + 500
        out.append(({
            "symbol": rng.integers(0, N_SYMBOLS, BATCH).astype(np.int32),
            "px": (100 + rng.standard_normal(BATCH)).astype(np.float32),
            "qty": rng.integers(1, 500, BATCH).astype(np.int32),
        }, ts, max(0, int(ts[0]) - 1)))
    return out


def _vwap(pkg):
    if pkg is wj:
        return Ffat_Windows_TPU_Builder(
            lambda f: {"pq": f["px"] * f["qty"].astype(jnp.float32),
                       "q": f["qty"]},
            lambda a, b: {"pq": a["pq"] + b["pq"], "q": a["q"] + b["q"]})
    return wt.Ffat_Windows_GPU_Builder(
        lambda f: {"pq": f["px"] * f["qty"].to(torch.float32),
                   "q": f["qty"]},
        wt.fieldwise(pq="sum", q="sum"))


def _int_sum(pkg):
    if pkg is wj:
        return Ffat_Windows_TPU_Builder(
            lambda f: {"qty": f["qty"]},
            lambda a, b: {"qty": a["qty"] + b["qty"]})
    return wt.Ffat_Windows_GPU_Builder(lambda f: {"qty": f["qty"]},
                                       wt.fieldwise(qty="sum"))


def _run(pkg, make_op, columns, seed=11, n_blocks=12, par=1):
    blocks = _blocks(n_blocks, seed)
    kw = {} if pkg is wj else {"device": "cpu"}
    graph = pkg.PipeGraph("vwap", pkg.ExecutionMode.DEFAULT,
                          pkg.TimePolicy.EVENT_TIME, **kw)
    src = (pkg.Columnar_Source_Builder(lambda: iter(blocks))
           .with_output_batch_size(BATCH).build())
    op = (make_op(pkg).with_key_by("symbol")
          .with_tb_windows(WIN_US, SLIDE_US)
          .with_key_capacity(N_SYMBOLS).with_parallelism(par).build())
    res, lock = {}, threading.Lock()

    def row_sink(w):
        if w is not None:
            with lock:
                assert (w["symbol"], w["wid"]) not in res
                res[(w["symbol"], w["wid"])] = w

    def col_sink(cols, ts):
        if cols is None:
            return
        with lock:
            for i in range(len(ts)):
                w = {k: v[i].item() for k, v in cols.items()}
                assert (w["symbol"], w["wid"]) not in res
                res[(w["symbol"], w["wid"])] = w

    sink = (pkg.Sink_Builder(col_sink).with_columns() if columns
            else pkg.Sink_Builder(row_sink))
    graph.add_source(src).add(op).add_sink(sink.build())
    run_bounded(graph)
    return res


def _assert_same(ref, got, float_fields=()):
    assert ref.keys() == got.keys() and len(ref) > 20
    for k, r in ref.items():
        g = got[k]
        assert r["valid"] == g["valid"], k
        if not r["valid"]:
            continue
        assert set(r) == set(g)
        for f in r:
            if f in float_fields:
                assert g[f] == pytest.approx(r[f], rel=1e-5), (k, f)
            else:
                assert g[f] == r[f], (k, f)


@pytest.mark.parametrize("columns", [False, True], ids=["rows", "columns"])
def test_vwap_pipeline_matches_jax(columns):
    ref = _run(wj, _vwap, columns)
    got = _run(wt, _vwap, columns)
    _assert_same(ref, got, float_fields=("pq",))


@pytest.mark.parametrize("par", [1, 2], ids=["par1", "par2"])
@pytest.mark.parametrize("columns", [False, True], ids=["rows", "columns"])
def test_int_sum_pipeline_matches_jax(columns, par):
    """``par=2``: keyed staging splits the stream over two window replicas
    and the sink merges two input channels (watermark collector)."""
    ref = _run(wj, _int_sum, columns, seed=12, par=par)
    got = _run(wt, _int_sum, columns, seed=12, par=par)
    _assert_same(ref, got)


def test_port_stats_count_programs_not_kernel_launches_on_cpu():
    """On the CPU the rebuild runs the plain version: programs run, no
    kernel launch is counted."""
    graph = wt.PipeGraph("stats", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device="cpu")
    blocks = _blocks(6, 13)
    graph.add_source(wt.Columnar_Source_Builder(lambda: iter(blocks))
                     .with_output_batch_size(BATCH).build()) \
        .add(_int_sum(wt).with_key_by("symbol")
             .with_tb_windows(WIN_US, SLIDE_US).build()) \
        .add_sink(wt.Sink_Builder(lambda w: None).build())
    run_bounded(graph)
    st = graph.get_stats()["Operators"][1]["replicas"][0]
    assert st["Device_programs_run"] > 0
    assert st["Rebuild_kernel_launches"] == 0
    assert st["Inputs_received"] == 6 * BATCH
