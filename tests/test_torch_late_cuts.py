"""Where the port's emitters cut batches when a timer falls due.

A batch carries the lowest watermark of its rows, so a late row in a batch
that straddles a watermark step is judged against the older watermark.
The port holds every timer-driven cut (the 100 ms punctuation cadence, the
25 ms staging age, the idle tick's aged ship) until the emitted watermark
steps, with ``TIMER_CUT_BACKSTOP_USEC`` as the liveness backstop
(``windflow_tpu_torch/runtime/emitters.py``). These tests force the
timers with a fake clock that the source advances push by push:

- the deterministic late stream of ``test_event_time_health.py``
  (``late_src``: a watermark step every 100 pushes, output batches of 50)
  with timers falling due inside watermark runs: every window engine's
  ``Late_*`` counts equal the exact model ``expected_late_counts()`` —
  the host ``Keyed_Windows`` and ``Ffat_Windows``, the device
  ``Ffat_Windows_GPU`` and the mesh on one and on four card groups;
- a source whose watermark steps on every push ships the same batches,
  with the same sizes, as a cut made at once would give (at chosen
  pushes, and under random gaps against a model of cuts made at once);
- a source whose watermark never steps ships by the backstop.

Tolerance: EXACT (counts and batch sizes)."""

import time
import types

import numpy as np
import pytest
import torch

import test_event_time_health as eth
import windflow_tpu_torch as wt
from torch_waits import run_bounded
from windflow_tpu_torch.basic import (DEFAULT_WM_AMOUNT,
                                      DEFAULT_WM_INTERVAL_USEC,
                                      TIMER_CUT_BACKSTOP_USEC)
from windflow_tpu_torch.gpu import emitters_gpu
from windflow_tpu_torch.gpu.emitters_gpu import MAX_STAGING_MS
from windflow_tpu_torch.gpu.schema import TupleSchema
from windflow_tpu_torch.mesh import core as ct
from windflow_tpu_torch.monitoring.stats import StatsRecord
from windflow_tpu_torch.runtime import emitters

MS = 1_000  # fake-clock microseconds


@pytest.fixture(autouse=True)
def virtual_devices():
    """8 virtual devices on the CPU in one group; the process-wide
    registries (count, groups, exclusions) go back to what they were."""
    prev = (ct.virtual_device_count(), ct.virtual_device_groups(),
            ct.excluded_device_ids())
    ct.ensure_virtual_devices(8)
    ct.set_excluded_devices(())
    yield
    ct.ensure_virtual_devices(prev[0], group_devices=prev[1])
    ct.set_excluded_devices(prev[2])


class _Clock:
    """The emitters' clocks, set by the source before each push from a
    schedule of (first push index, microseconds) steps, or from each
    push's own time (``times``)."""

    def __init__(self, steps=(), times=None):
        self.steps = sorted(steps)
        self.times = times
        self.us = 0

    def at_push(self, i):
        if self.times is not None:
            self.us = int(self.times[i])
        for first, us in self.steps:
            if i >= first:
                self.us = us

    def usecs(self):
        return self.us

    def monotonic(self):
        return self.us / 1e6


def _install(monkeypatch, clock):
    """The punctuation cadence reads ``current_time_usecs`` as imported in
    ``runtime/emitters.py``; the staging age reads ``time.monotonic`` in
    ``gpu/emitters_gpu.py`` (that module alone sees the fake)."""
    monkeypatch.setattr(emitters, "current_time_usecs", clock.usecs)
    fake = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time)
                                    if not k.startswith("_")})
    fake.monotonic = clock.monotonic
    monkeypatch.setattr(emitters_gpu, "time", fake)


class _TimedShipper:
    """A shipper that moves the clock to push ``i``'s time first."""

    def __init__(self, shipper, clock):
        self._s, self._clock, self._i = shipper, clock, 0

    def push_with_timestamp(self, payload, ts):
        self._clock.at_push(self._i)
        self._i += 1
        self._s.push_with_timestamp(payload, ts)

    def set_next_watermark(self, wm):
        self._s.set_next_watermark(wm)


# Timers due inside watermark runs of ``late_src`` (steps after pushes 99,
# 199, ...; late rows from push 600 on). The staging age (25 ms) falls due
# at pushes 130 and 1,430, 30 ms after their buffers' first rows (pushes
# 100 and 1,400); the punctuation cadence, checked every 64 pushes, at
# pushes 191 and 1,471 (the 192nd and 1,472nd), 100 ms after the last.
LATE_STEPS = [(130, 30 * MS), (191, 130 * MS), (1_430, 160 * MS),
              (1_471, 260 * MS)]


def _late_graph(engine, clock):
    g = wt.PipeGraph(f"late_cuts_{engine}", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT_TIME, device="cpu")
    if engine == "keyed_cpu":
        op = (wt.Keyed_Windows_Builder(lambda ws: len(list(ws)))
              .with_key_by(lambda t: t["key"]))
    elif engine == "ffat_cpu":
        op = (wt.Ffat_Windows_Builder(lambda t: 1, lambda a, b: a + b)
              .with_key_by(lambda t: t["key"]))
    else:
        op = (wt.Ffat_Windows_GPU_Builder(
                lambda f: {"value": f["value"]},
                lambda a, b: {"value": a["value"] + b["value"]})
              .with_key_by("key"))
        if engine.startswith("mesh"):
            op = op.with_key_capacity(eth.N_KEYS).with_mesh()
    op = (op.with_tb_windows(eth.WIN, eth.SLIDE)
          .with_lateness(eth.LATENESS).with_name("win").build())

    def src(shipper, ctx):
        eth.late_src(_TimedShipper(shipper, clock), ctx)

    results = []
    g.add_source(wt.Source_Builder(src).with_output_batch_size(eth.OBS)
                 .build()) \
        .add(op).add_sink(wt.Sink_Builder(
            lambda r: results.append(r) if r is not None else None).build())
    return g, results


@pytest.mark.parametrize("engine", ["keyed_cpu", "ffat_cpu", "ffat_gpu",
                                    "mesh_g1", "mesh_g4"])
def test_timer_cuts_keep_the_late_model(engine, monkeypatch):
    """Timers due inside watermark runs: the counts are the model's."""
    exp_admit, exp_drop = eth.expected_late_counts()
    clock = _Clock(LATE_STEPS)
    _install(monkeypatch, clock)
    if engine == "mesh_g4":
        ct.ensure_virtual_devices(8, group_devices=["cpu"] * 4)
    g, results = _late_graph(engine, clock)
    run_bounded(g)
    assert results, f"{engine}: no windows fired"
    win = next(o for o in g.get_stats()["Operators"] if o["name"] == "win")
    st = {k: sum(r.get(k, 0) for r in win["replicas"])
          for k in ("Inputs_received", "Late_records", "Late_dropped",
                    "Late_admitted")}
    assert st["Inputs_received"] == eth.N
    assert st["Late_admitted"] == exp_admit > 0, st
    assert st["Late_dropped"] == exp_drop > 0, st
    assert st["Late_records"] == exp_admit + exp_drop, st
    # the timers fell due inside watermark runs and were held: the two
    # punctuations (pushes 191 and 1,471) go out at the next step; the
    # staging ages due there give way to the count cut that fills their
    # buffer first
    src = g.get_stats()["Operators"][0]["replicas"]
    held = [sum(r[k] for r in src)
            for k in ("Timer_cuts_held", "Timer_cuts_backstop")]
    assert held == [2, 0]
    if engine == "mesh_g4":
        r = next(op.replicas[0] for op in g._ops
                 if getattr(op, "is_mesh", False))
        assert r._mesh.n_groups == 4


# ---------------------------------------------------------------------------
# batch sizes around the cuts
# ---------------------------------------------------------------------------
def _sizes_run(monkeypatch, clock, n, obs, step_every_push, device):
    """Ship ``n`` rows of one EVENT_TIME source (output batches of
    ``obs``) into a device map (``device``: the staging emitter) or a host
    sink (the forward emitter) under ``clock``; the sizes of the batches
    it shipped."""
    _install(monkeypatch, clock)
    sizes = []
    if device:
        cls, name = emitters_gpu.GPUStageEmitter, "_dispatch_batch"
        orig = cls._dispatch_batch

        def spy(self, buf, batch, k):
            sizes.append(k)
            return orig(self, buf, batch, k)
    else:
        cls, name = emitters.ForwardEmitter, "_send_batch"
        orig = cls._send_batch

        def spy(self, dest, batch):
            sizes.append(batch.size)
            return orig(self, dest, batch)
    monkeypatch.setattr(cls, name, spy)

    def src(shipper, ctx):
        for i in range(n):
            clock.at_push(i)
            shipper.push_with_timestamp({"key": i % 4, "value": i}, 10 * i)
            if step_every_push:
                shipper.set_next_watermark(10 * i)

    g = wt.PipeGraph("late_cut_sizes", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT_TIME, device="cpu")
    mp = g.add_source(wt.Source_Builder(src).with_output_batch_size(obs)
                      .build())
    if device:
        mp = mp.add(wt.Map_GPU_Builder(
            lambda f: {**f, "value": f["value"] + 1}).build())
    got = []
    mp.add_sink(wt.Sink_Builder(
        lambda r: got.append(r) if r is not None else None).build())
    run_bounded(g)
    assert len(got) == n
    return sizes


@pytest.mark.parametrize("device", [True, False], ids=["staging", "host"])
def test_stepping_source_keeps_its_batch_sizes(monkeypatch, device):
    """A watermark that steps on every push: a due cut ships at the next
    push, so each batch ends with the push at which its timer fell due,
    as a cut made at once ends it. Staging: the age is due at push 130
    (30 ms after the buffer's first row, push 100) and at push 191 (100
    ms after push 181), where the punctuation cadence is due too; host:
    the cadence alone, at push 191. The source then stalls 50 ms before
    push 192, and the cadence is due again at push 255, 105 ms after it
    last fell due (it counts from there, not from the held punctuation's
    release), as is the staging age (55 ms)."""
    steps = [(130, 30 * MS), (191, 130 * MS), (192, 180 * MS),
             (255, 235 * MS)]
    sizes = _sizes_run(monkeypatch, _Clock(steps), 300, 50, True, device)
    if device:
        assert sizes == [50, 50, 31, 50, 11, 50, 14, 44]
    else:
        assert sizes == [50, 50, 50, 42, 50, 14, 44]


def _cuts_made_at_once(times, obs, staging):
    """The batch sizes of a source whose watermark steps on every push
    when each timer cut ships at the push where it falls due (the JAX
    package's rule): the staging age after the append, then the cadence
    every 64th push."""
    sizes, n, t0, last, age_s = [], 0, 0, 0, MAX_STAGING_MS / 1e3
    for i, us in enumerate(times):
        if n == 0:
            t0 = us / 1e6
        n += 1
        if n >= obs or (staging and us / 1e6 - t0 >= age_s):
            sizes.append(n)
            n = 0
        if (i + 1) % DEFAULT_WM_AMOUNT == 0 \
                and us - last >= DEFAULT_WM_INTERVAL_USEC:
            last = us
            if n:
                sizes.append(n)
                n = 0
    return sizes + ([n] if n else [])


@pytest.mark.parametrize("device", [True, False], ids=["staging", "host"])
def test_stepping_source_cuts_where_timers_fall_due(monkeypatch, device):
    """Random gaps between pushes (20-80 us, one push in 20 after a 1-60
    ms stall): a source that steps its watermark on every push ships the
    batches that cuts made at once would."""
    rng = np.random.default_rng(16)
    n = 4_000
    gaps = rng.choice([20, 30, 50, 80], n)
    stall = rng.random(n) < 0.05
    gaps[stall] = rng.integers(1_000, 60_000, int(stall.sum()))
    times = np.cumsum(gaps)
    sizes = _sizes_run(monkeypatch, _Clock(times=times), n, 512, True,
                       device)
    assert sizes == _cuts_made_at_once(times, 512, device)
    assert len(sizes) > 2 * n // 512  # the timers cut, not only the count


@pytest.mark.parametrize("device", [True, False], ids=["staging", "host"])
def test_source_that_never_steps_ships_by_the_backstop(monkeypatch, device):
    """A constant watermark: a due cut waits for a step that never comes,
    and ships once it has waited ``TIMER_CUT_BACKSTOP_USEC``. Staging:
    the age falls due at push 100 (30 ms) and the backstop passes at push
    300 (the backstop after that); host: the cadence
    falls due at push 127 (the 128th, 150 ms) and the backstop passes at
    the next check past it, push 255."""
    back = TIMER_CUT_BACKSTOP_USEC
    if device:
        steps = [(100, 30 * MS), (300, 30 * MS + back)]
        sizes = _sizes_run(monkeypatch, _Clock(steps), 400, 10_000, False,
                           True)
        assert sizes == [301, 99]
    else:
        steps = [(120, 150 * MS), (250, 150 * MS + back)]
        sizes = _sizes_run(monkeypatch, _Clock(steps), 400, 10_000, False,
                           False)
        assert sizes == [256, 144]


class _Port:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)


def test_idle_tick_holds_an_aged_buffer_until_the_backstop(monkeypatch):
    """At a lull no push can step the watermark: the idle tick holds an
    aged staging buffer and ships it once the backstop has passed. While
    the cut waits, ``on_idle`` reports pending work, so the worker's idle
    backoff (which grows only over ticks that find nothing) does not push
    the ship past the backstop."""
    clock = _Clock()
    _install(monkeypatch, clock)
    em = emitters_gpu.GPUStageEmitter(
        1, 100, TupleSchema({"v": np.int64}), None, "forward",
        wt.ExecutionMode.DEFAULT, None, torch.device("cpu"))
    em.set_stats(StatsRecord("stage"))
    port = _Port()
    em.set_ports([port])
    for i in range(10):
        em.emit({"v": i}, i, 5)
    assert em.on_idle() is False  # younger than the staging age
    clock.us = 30 * MS
    assert em.on_idle() is True and not port.sent  # due: held
    clock.us = 30 * MS + TIMER_CUT_BACKSTOP_USEC - 1
    assert em.on_idle() is True and not port.sent
    clock.us = 30 * MS + TIMER_CUT_BACKSTOP_USEC
    assert em.on_idle() is True
    assert [b.size for b in port.sent] == [10]
    assert em.on_idle() is False
    st = em.stats.to_dict()
    assert (st["Timer_cuts_held"], st["Timer_cuts_backstop"]) == (0, 1)
