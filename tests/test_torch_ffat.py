"""Replica-level differential: the same staged batches (the shape of
``bench.py:_stage_batches``, at a small size, made with numpy from a seed)
go through a JAX ``FfatTPUReplica`` and through the port's
``FfatGPUReplica`` on ``device="cpu"``, in both segmentation modes. The
emitted ``(key, wid) -> (valid, value...)`` rows must be equal: exactly
for int32 fields, with ``rtol=1e-5`` for float32 fields (the port's
Hillis-Steele scan groups the combine differently from
``lax.associative_scan``). Late-record counts must be equal too."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_combines as tc
from windflow_tpu.basic import WinType as JWinType
from windflow_tpu.tpu.batch import BatchTPU
from windflow_tpu.tpu.ffat_tpu import Ffat_Windows_TPU
from windflow_tpu.tpu.schema import TupleSchema as JSchema
from windflow_tpu_torch import WinType, fieldwise
from windflow_tpu_torch.convert import ffat_state_from_jax
from windflow_tpu_torch.gpu.batch import BatchGPU
from windflow_tpu_torch.gpu.ffat_gpu import Ffat_Windows_GPU
from windflow_tpu_torch.gpu.schema import TupleSchema

SEG_MODES = pytest.mark.parametrize("host_seg", [True, False],
                                    ids=["host_seg", "device_seg"])


class _Collect:
    """Emitter stand-in: keeps every fired window as host rows."""

    def __init__(self, to_host):
        self.to_host = to_host
        self.rows = []

    def set_stats(self, stats):
        pass

    def emit_device_batch(self, b):
        cols = {k: np.asarray(v)[:b.size] for k, v in self.to_host(b).items()}
        names = sorted(cols)
        for i in range(b.size):
            self.rows.append({n: cols[n][i].item() for n in names})

    def propagate_punctuation(self, wm):
        pass

    def flush(self):
        pass


def _jax_to_host(b):
    return {k: np.asarray(v) for k, v in b.fields.items()}


def _torch_to_host(b):
    return b.host_columns()


# ---------------------------------------------------------------------------
# the two replicas, built from one configuration
# ---------------------------------------------------------------------------
INT_SUM = dict(
    jax=(lambda f: {"value": f["value"]},
         lambda a, b: {"value": a["value"] + b["value"]}),
    torch=(lambda f: {"value": f["value"]}, fieldwise(value="sum")))
VWAP = dict(
    jax=(lambda f: {"pq": f["px"] * f["value"].astype(jnp.float32),
                    "q": f["value"]},
         lambda a, b: {"pq": a["pq"] + b["pq"], "q": a["q"] + b["q"]}),
    torch=(lambda f: {"pq": f["px"] * f["value"].to(torch.float32),
                      "q": f["value"]}, fieldwise(pq="sum", q="sum")))
MINMAX = dict(
    jax=(lambda f: {"lo": f["value"], "hi": f["value"]},
         lambda a, b: {"lo": jnp.minimum(a["lo"], b["lo"]),
                       "hi": jnp.maximum(a["hi"], b["hi"])}),
    torch=(lambda f: {"lo": f["value"], "hi": f["value"]},
           fieldwise(lo="min", hi="max")))


def _replica(pkg, fns, win, slide, cb=False, key_capacity=8, nwpb=None,
             lateness=0):
    """One replica of either package, collecting its fired windows."""
    if pkg == "jax":
        op = Ffat_Windows_TPU(*fns["jax"], "key", win, slide,
                              JWinType.CB if cb else JWinType.TB, lateness,
                              nwpb, key_capacity=key_capacity)
    else:
        op = Ffat_Windows_GPU(*fns["torch"], "key", win, slide,
                              WinType.CB if cb else WinType.TB, lateness,
                              nwpb, key_capacity=key_capacity)
    op.build_replicas()  # the port's operators default to the CPU device
    rep = op.replicas[0]
    rep.set_emitter(_Collect(_jax_to_host if pkg == "jax"
                             else _torch_to_host))
    return rep


def _stage(n_keys, n_batches, B, seed, ts_step=50, disorder=0,
           with_px=False, wm_lag=0):
    """Per batch: (cols, ts, keys, wm); the watermark trails the batch's
    newest timestamp by ``wm_lag``."""
    rng = np.random.default_rng(seed)
    out, ts0 = [], 0
    for _ in range(n_batches):
        keys = rng.integers(0, n_keys, B).astype(np.int64)
        cols = {"key": keys.astype(np.int32),
                "value": rng.integers(0, 100, B).astype(np.int32)}
        if with_px:
            cols["px"] = (100 + rng.standard_normal(B)).astype(np.float32)
        ts = ts0 + np.arange(B, dtype=np.int64) * ts_step
        ts0 = int(ts[-1]) + ts_step
        if disorder:
            ts = np.maximum(0, ts - rng.integers(0, disorder, B))
        out.append((cols, ts, keys, max(0, int(ts.max()) - wm_lag)))
    return out


def _feed(rep, batches):
    jax_side = isinstance(rep.op, Ffat_Windows_TPU)
    for cols, ts, keys, wm in batches:
        n = len(ts)
        cap = 1 << max(3, (n - 1).bit_length())
        pad = lambda a: np.concatenate([a, np.zeros(cap - n, a.dtype)])
        dts = {k: v.dtype for k, v in cols.items()}
        if jax_side:
            b = BatchTPU({k: jax.device_put(pad(v)) for k, v in cols.items()},
                         pad(ts), n, JSchema(dts), wm, host_keys=keys.copy())
        else:
            b = BatchGPU({k: torch.from_numpy(pad(v))
                          for k, v in cols.items()},
                         pad(ts), n, TupleSchema(dts), wm,
                         host_keys=keys.copy())
        rep.handle_msg(0, b)


def _punctuate(rep, wm):
    rep._advance_wm(wm)
    rep.on_punctuation(wm)


def _windows(rep):
    res = {}
    for r in rep.emitter.rows:
        k = (r["key"], r["wid"])
        assert k not in res, f"window {k} fired twice"
        res[k] = r
    return res


# ---------------------------------------------------------------------------
# scenarios: (lift/combine pair, replica config, batches, float fields).
# The JAX side runs once per scenario (its own default segmentation: its
# tests pin both of its modes to the same windows); the port runs in both.
# ---------------------------------------------------------------------------
SCENARIOS = {
    "tb_int_sum": (INT_SUM, dict(win=1000, slide=250),
                   lambda: _stage(6, 8, 64, seed=1), ()),
    "tb_vwap_float": (VWAP, dict(win=1000, slide=250),
                      lambda: _stage(5, 6, 64, seed=2, with_px=True),
                      ("pq",)),
    "cb_minmax": (MINMAX, dict(win=13, slide=5, cb=True),
                  lambda: _stage(4, 6, 32, seed=3), ()),
    "key_growth": (INT_SUM, dict(win=800, slide=400, key_capacity=4,
                                 nwpb=4),
                   lambda: _stage(20, 6, 64, seed=4, ts_step=20), ()),
    "disorder_late": (INT_SUM, dict(win=1000, slide=400, lateness=100),
                      lambda: _stage(3, 10, 32, seed=5, ts_step=40,
                                     disorder=2500), ()),
    # watermarks never move: every batch is an ingest-only step
    "ingest_then_dataless": (
        INT_SUM, dict(win=1000, slide=250),
        lambda: [(c, t, k, 0) for c, t, k, _ in _stage(4, 4, 64, seed=6)],
        ()),
}
_JAX_RUNS = {}


def _jax_run(name):
    if name not in _JAX_RUNS:
        fns, cfg, make, _ = SCENARIOS[name]
        rep = _replica("jax", fns, **cfg)
        batches = make()
        _feed(rep, batches)
        if name == "ingest_then_dataless":
            _punctuate(rep, int(batches[-1][1].max()) + 10_000)
        rep.terminate()
        _JAX_RUNS[name] = rep
    return _JAX_RUNS[name]


def _assert_same(jrep, trep, float_fields=()):
    jw, tw = _windows(jrep), _windows(trep)
    assert jw.keys() == tw.keys() and len(jw) > 0
    for k, jr in jw.items():
        tr = tw[k]
        assert jr["valid"] == tr["valid"], k
        if not jr["valid"]:
            continue
        for f in jr:
            if f in float_fields:
                assert tr[f] == pytest.approx(jr[f], rel=1e-5), (k, f)
            else:
                assert tr[f] == jr[f], (k, f)


def _port_run(name, host_seg):
    fns, cfg, make, _ = SCENARIOS[name]
    rep = _replica("torch", fns, **cfg)
    rep._host_seg = host_seg
    _feed(rep, make())
    return rep


@SEG_MODES
@pytest.mark.parametrize("name", ["tb_int_sum", "tb_vwap_float",
                                  "cb_minmax", "key_growth"])
def test_windows_match_jax(name, host_seg):
    trep = _port_run(name, host_seg)
    trep.terminate()
    jrep = _jax_run(name)
    if name == "key_growth":
        assert trep.K_cap == jrep.K_cap >= 32
    _assert_same(jrep, trep, SCENARIOS[name][3])


@SEG_MODES
def test_disorder_lateness_counts(host_seg):
    trep = _port_run("disorder_late", host_seg)
    trep.terminate()
    jrep = _jax_run("disorder_late")
    _assert_same(jrep, trep)
    assert trep.ignored == jrep.ignored > 0
    for f in ("late_records", "late_dropped", "inputs_ignored"):
        assert getattr(trep.stats, f) == getattr(jrep.stats, f), f


@SEG_MODES
def test_ingest_only_then_dataless_fire(host_seg):
    """Batches whose watermark never moves fire nothing (ingest-only
    steps, rebuild deferred); a punctuation then fires every window
    through the standalone rebuild (``_ensure_rebuilt``)."""
    trep = _port_run("ingest_then_dataless", host_seg)
    trep.dispatch.drain()
    assert trep._rebuild_dirty and not trep.emitter.rows
    batches = SCENARIOS["ingest_then_dataless"][2]()
    _punctuate(trep, int(batches[-1][1].max()) + 10_000)
    assert not trep._rebuild_dirty and trep.emitter.rows
    trep.terminate()
    _assert_same(_jax_run("ingest_then_dataless"), trep)


@SEG_MODES
def test_state_carried_from_jax(host_seg):
    """Run the JAX replica for N batches, carry its state into a fresh port
    replica, run both for M more: the rows after the carry are equal."""
    batches = _stage(6, 8, 64, seed=7)
    jrep = _replica("jax", INT_SUM, 1000, 250)
    _feed(jrep, batches[:4])
    snap = jrep.snapshot_state()["ffat"]
    jrep.emitter.rows.clear()
    trep = _replica("torch", INT_SUM, 1000, 250)
    trep._host_seg = host_seg
    trep.load_state(ffat_state_from_jax(snap, "cpu"))
    trep.cur_wm = jrep.cur_wm
    for rep in (jrep, trep):
        _feed(rep, batches[4:])
        rep.terminate()
    _assert_same(jrep, trep)


# ---------------------------------------------------------------------------
# traced combines (torch_combines.py): the port runs the user's torch
# combine, the JAX package its jnp twin; lifts over (key, value, px)
# ---------------------------------------------------------------------------
_TRACED_LIFTS = {
    "ysb_last": lambda f: {"count": f["value"] * 0 + 1,
                           "last_ing": f["value"]},
    "mean_last": lambda f: {"n": f["value"] * 0 + 1, "last": f["value"],
                            "mean": f["px"]},
    "argmax_ts": lambda f: {"v": f["px"], "ts": f["value"]},
    "flags": lambda f: {"f": f["value"] > 90, "n": f["value"]},
    "wide": lambda f: {f"w{i}": f["value"] * (i + 1) - i
                       for i in range(tc.WIDE)},
}
# float fields held to rtol 1e-5 (the scan's grouping); argmax_ts's v is
# picked, not computed: exact
_TRACED_FLOATS = {"mean_last": ("mean",)}


def _traced_fns(name):
    return dict(jax=(_TRACED_LIFTS[name], tc.make(name, jnp)),
                torch=(_TRACED_LIFTS[name], tc.make(name, torch)))


@SEG_MODES
@pytest.mark.parametrize("name", tc.WINDOWED)
def test_traced_combine_windows_match_jax(name, host_seg):
    """Each traced window combine of the card (cross-field, a where, a
    bool plane, 12 fields, the example's YSB combine) gives the JAX
    replica's windows on the port's replica."""
    batches = _stage(5, 6, 64, seed=21, with_px=True)
    jrep = _replica("jax", _traced_fns(name), 1000, 250)
    _feed(jrep, batches)
    jrep.terminate()
    trep = _replica("torch", _traced_fns(name), 1000, 250)
    trep._host_seg = host_seg
    _feed(trep, batches)
    trep.terminate()
    assert {k: t.dtype for k, t in trep.trees.items()} == tc.DTYPES[name]
    _assert_same(jrep, trep, _TRACED_FLOATS.get(name, ()))


@SEG_MODES
@pytest.mark.parametrize("name", ["flags", "wide"])
def test_traced_state_carried_from_jax(name, host_seg):
    """``convert.ffat_state_from_jax`` carries a bool plane and a forest of
    12 fields: the rows after the carry are equal."""
    batches = _stage(6, 8, 64, seed=23, with_px=True)
    jrep = _replica("jax", _traced_fns(name), 1000, 250)
    _feed(jrep, batches[:4])
    snap = jrep.snapshot_state()["ffat"]
    jrep.emitter.rows.clear()
    state = ffat_state_from_jax(snap, "cpu")
    assert {k: t.dtype for k, t in state["trees"].items()} \
        == tc.DTYPES[name]
    trep = _replica("torch", _traced_fns(name), 1000, 250)
    trep._host_seg = host_seg
    trep.load_state(state)
    trep.cur_wm = jrep.cur_wm
    for rep in (jrep, trep):
        _feed(rep, batches[4:])
        rep.terminate()
    _assert_same(jrep, trep)
