"""Self-healing supervision and per-record error policies in the port
(``windflow_tpu_torch/supervision/``), held against the JAX package
(``windflow_tpu/supervision/``, ``tests/test_supervision.py`` and
``tests/test_recovery_ladder.py``).

Most graphs here use plain sinks, so a recovery replays the segment
after the restored checkpoint and re-emits IDENTICAL rows; their oracle
is the set of distinct output rows, which must equal the uninterrupted
run's, plus the restored checkpoint id, in both packages. The
exactly-once twins of the JAX tests (an exactly-once sink, a keyed
window at parallelism 2) hold the supervised run's committed output to
the uninterrupted run's as a multiset, duplicates included:

- auto-recovery from one and from two crashes, recovery before the
  first checkpoint (a full replay from the captured initial positions),
  budget escalation naming the dead worker, a supervised stateful
  ``Map_GPU``;
- the restore ladder landing on the newest checkpoint that verifies
  (the six seeds of ``test_ladder_lands_on_newest_verifying_checkpoint``);
- dead letters and the skip, fail and retry policies, the policy refused
  on sources, the policy's string form;
- device-batch bisection isolating one poison row of 256 in a guarded
  ``Map_GPU``, and the fusion refusal; a sticky CUDA error (told apart by
  its message) is neither bisected nor restarted on;
- the units: ``RestartPolicy``, ``Channel.close``, the health probes.

Tolerance: exact (integer running sums). Every wait is bounded.
"""

from __future__ import annotations

import os
import random
import threading
import time

import numpy as np
import pytest

import windflow_tpu as wj
import windflow_tpu_torch as wt
from torch_waits import call_bounded, run_bounded
from windflow_tpu.checkpoint import CheckpointStore as StoreJ
from windflow_tpu.tpu.builders_tpu import Map_TPU_Builder
from windflow_tpu.tpu.ops_tpu import MapTPUReplica
from windflow_tpu_torch.basic import SupervisorTeardown
from windflow_tpu_torch.checkpoint import CheckpointStore as StoreT
from windflow_tpu_torch.gpu.ops_gpu import MapGPUReplica
from windflow_tpu_torch.runtime.channel import Channel

WAIT_S = 10.0


def _pg(pkg, name):
    extra = {} if pkg is wj else {"device": "cpu"}
    return pkg.PipeGraph(name, pkg.ExecutionMode.DEFAULT,
                         pkg.TimePolicy.INGRESS_TIME, **extra)


class CrashingSource:
    """Replayable source: crashes at ``crash_at`` the first
    ``crash_times`` times its cursor passes it (None = every time); with
    ``store`` it waits (bounded) for each requested checkpoint to
    commit, so that epoch <-> position is deterministic; ``on_crash``
    runs just before a crash."""

    def __init__(self, n, nk=7, ckpt_at=(), crash_at=None, crash_times=1,
                 store=None, on_crash=None):
        self.n, self.nk = n, nk
        self.ckpt_at = set(ckpt_at)
        self.crash_at, self.crash_times = crash_at, crash_times
        self.store, self.on_crash = store, on_crash
        self.crashes = 0
        self.pos = 0

    def __call__(self, shipper):
        st = None if self.store is None else self.store[0](self.store[1])
        while self.pos < self.n:
            if self.crash_at is not None and self.pos == self.crash_at \
                    and (self.crash_times is None
                         or self.crashes < self.crash_times):
                self.crashes += 1
                if self.on_crash is not None:
                    self.on_crash()
                raise ValueError(f"injected crash #{self.crashes}")
            v = self.pos
            shipper.push({"k": v % self.nk, "v": v})
            self.pos += 1
            if self.pos in self.ckpt_at:
                before = 0 if st is None else (st.latest() or 0)
                shipper.request_checkpoint()
                deadline = time.monotonic() + WAIT_S
                while st is not None and (st.latest() or 0) <= before \
                        and time.monotonic() < deadline:
                    time.sleep(0.002)

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _reduce_graph(pkg, store, src, results, supervised=True, policy=None,
                  probe=None):
    g = _pg(pkg, "t_sup")
    g.with_checkpointing(store_dir=store)
    if supervised:
        g.with_supervision(policy or pkg.RestartPolicy(
            max_restarts=4, backoff_s=0.02, backoff_max_s=0.1))
    if probe is not None:
        g.with_device_probe(probe)
    lock = threading.Lock()

    def sink(t):
        if t is not None:
            with lock:
                results.append(t)

    red = (pkg.Reduce_Builder(lambda t, s: (0 if s is None else s) + t["v"])
           .with_key_by(lambda t: t["k"]).with_name("red")
           .with_parallelism(2).build())
    g.add_source(pkg.Source_Builder(src).with_name("src").build()) \
        .add(red).add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
    return g


def _golden(pkg, tmp, n):
    gold = []
    run_bounded(_reduce_graph(pkg, str(tmp / f"gold_{pkg.__name__}"),
                              CrashingSource(n), gold, supervised=False))
    return set(gold)


def _supervised(pkg, tmp, name, **src_kw):
    res = []
    store = str(tmp / f"{name}_{pkg.__name__}")
    src = CrashingSource(store=(StoreJ if pkg is wj else StoreT, store),
                         **src_kw)
    g = _reduce_graph(pkg, store, src, res)
    run_bounded(g)  # no exception, no manual restore_from
    sup = g.get_stats()["Supervision"]
    return set(res), sup, g


# ---------------------------------------------------------------------------
# supervised auto-recovery
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["one_crash", "double_crash",
                                  "before_first_checkpoint"])
def test_supervised_recovery_matches_jax(tmp_path, case):
    kw = {"one_crash": dict(n=1500, ckpt_at=[400], crash_at=900),
          "double_crash": dict(n=1200, ckpt_at=[300], crash_at=700,
                               crash_times=2),
          "before_first_checkpoint": dict(n=1000, crash_at=600)}[case]
    restarts = {"one_crash": 1, "double_crash": 2,
                "before_first_checkpoint": 1}[case]
    ckpt = {"one_crash": 1, "double_crash": 1,
            "before_first_checkpoint": None}[case]
    out = {}
    for pkg in (wj, wt):
        golden = _golden(pkg, tmp_path, kw["n"])
        res, sup, g = _supervised(pkg, tmp_path, case, **kw)
        assert res == golden, pkg.__name__
        assert sup["Supervision_restarts"] == restarts
        assert not sup["Supervision_escalated"]
        assert sup["Supervision_last_restart_s"] > 0  # the measured MTTR
        out[pkg] = (res, [h["ckpt_id"] for h in sup["Supervision_history"]])
    assert out[wt] == out[wj]
    assert out[wt][1][0] == ckpt
    # cumulative crash counters carried across the rebuild
    src = next(o for o in g.get_stats()["Operators"] if o["name"] == "src")
    assert src["replicas"][0]["Worker_crashes"] == restarts
    assert "ValueError" in src["replicas"][0]["Worker_last_error"]


def test_restart_budget_escalation(tmp_path):
    msgs = []
    for pkg in (wj, wt):
        g = _reduce_graph(
            pkg, str(tmp_path / pkg.__name__),
            CrashingSource(500, crash_at=100, crash_times=None), [],
            policy=pkg.RestartPolicy(max_restarts=2, backoff_s=0.01,
                                     backoff_max_s=0.02))
        with pytest.raises(pkg.SupervisionEscalated) as ei:
            run_bounded(g)
        assert isinstance(ei.value.__cause__, ValueError)
        assert g._supervisor.restarts == 2
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0]
    assert "gave up after 2 restart" in msgs[1] and "src" in msgs[1] \
        and "ValueError" in msgs[1]


def test_supervised_stateful_map_gpu(tmp_path):
    """A supervised device graph: the keyed table comes back from the
    checkpoint; distinct rows equal the uninterrupted run, in both
    packages."""
    def run(pkg, name, **kw):
        rows, lock = [], threading.Lock()

        def sink(t):
            if t is not None:
                with lock:
                    rows.append((int(t["k"]), int(t["v"])))

        Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
        g = _pg(pkg, name)
        store = str(tmp_path / f"{name}_{pkg.__name__}")
        g.with_checkpointing(store_dir=store)
        if kw:
            g.with_supervision(pkg.RestartPolicy(max_restarts=2,
                                                 backoff_s=0.01))
            kw["store"] = (StoreJ if pkg is wj else StoreT, store)
        smap = (Map(lambda row, st: ({"k": row["k"],
                                      "v": row["v"] + st["acc"]},
                                     {"acc": st["acc"] + row["v"]}))
                .with_key_by("k").with_state({"acc": np.int64(0)})
                .with_name("smap").build())
        g.add_source(pkg.Source_Builder(CrashingSource(960, nk=5, **kw))
                     .with_name("src").with_output_batch_size(32).build()) \
            .add(smap) \
            .add_sink(pkg.Sink_Builder(sink).with_name("snk").build())
        run_bounded(g)
        return set(rows), g

    out = {}
    for pkg in (wj, wt):
        gold, _ = run(pkg, "gold")
        got, g = run(pkg, "sup", ckpt_at=[320], crash_at=640)
        assert got == gold
        sup = g.get_stats()["Supervision"]
        assert sup["Supervision_restarts"] == 1
        out[pkg] = (got, sup["Supervision_history"][0]["ckpt_id"])
    assert out[wt] == out[wj]


# ---------------------------------------------------------------------------
# the restore ladder
# ---------------------------------------------------------------------------
_KINDS = ("truncate", "bitflip", "append")


def _damage(Store, root, cid, kind, rng):
    d = Store(root)._dirname(cid)
    blobs = sorted(f for f in os.listdir(d) if f.endswith(".blob"))
    path = os.path.join(d, rng.choice(blobs))
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        if kind == "truncate":
            f.truncate(max(1, size // 2))
        elif kind == "append":
            f.seek(0, 2)
            f.write(b"\x00torn")
        else:
            off = rng.randrange(size)
            f.seek(off)
            b = f.read(1)
            f.seek(off)
            f.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_ladder_lands_on_newest_verifying_checkpoint(tmp_path, seed):
    n, nk = 1500, 7
    out = {}
    for pkg in (wj, wt):
        rng = random.Random(seed)
        Store = StoreJ if pkg is wj else StoreT
        golden = _golden(pkg, tmp_path, n)
        store = str(tmp_path / f"ladder_{pkg.__name__}")
        # seed 5 pins the worst case: every checkpoint corrupt -> replay
        subset = ([1, 2, 3] if seed == 5
                  else sorted(rng.sample([1, 2, 3], rng.randint(1, 3))))
        kinds = {cid: rng.choice(_KINDS) for cid in subset}

        def corrupt():
            for cid in subset:
                _damage(Store, store, cid, kinds[cid], rng)

        res = []
        src = CrashingSource(n, nk, ckpt_at=[250, 500, 750], crash_at=1200,
                             store=(Store, store), on_crash=corrupt)
        g = _reduce_graph(pkg, store, src, res)
        run_bounded(g)
        sup = g.get_stats()["Supervision"]
        newest_good = max((c for c in (1, 2, 3) if c not in subset),
                          default=None)
        depth = 3 - newest_good if newest_good is not None else 3
        assert sup["Supervision_restarts"] == 1
        assert sup["Recovery_ladder_depth"] == depth, (subset, kinds)
        assert sup["Recovery_verify_failures"] == depth
        assert set(res) == golden, (subset, kinds)
        # the corrupt rungs are quarantined, invisible to a later restore
        for cid in subset:
            if cid > (newest_good or 0):
                assert os.path.isdir(Store(store)._dirname(cid)
                                     + ".corrupt")
        out[pkg] = sup["Supervision_history"][0]["ckpt_id"]
    assert out[wt] == out[wj] == newest_good


# ---------------------------------------------------------------------------
# per-record error policies
# ---------------------------------------------------------------------------
def _poison_map(t):
    if t["v"] % 97 == 13:
        raise ValueError(f"poison {t['v']}")
    return {"v": t["v"] * 2}


def _run_policy_graph(pkg, policy, n=800, func=_poison_map):
    seen = []

    def src(shipper):
        for v in range(n):
            shipper.push({"v": v})

    g = _pg(pkg, "t_pol")
    mb = pkg.Map_Builder(func).with_name("pm")
    if policy is not None:
        mb = mb.with_error_policy(policy)
    g.add_source(pkg.Source_Builder(src).build()) \
        .add(mb.build()) \
        .add_sink(pkg.Sink_Builder(
            lambda t: seen.append(t["v"]) if t else None).build())
    run_bounded(g)
    return g, seen


def _letters(g):
    return [(r["operator"], r["payload_obj"], r["error"])
            for r in g.dead_letters()]


def _pm_stats(g):
    pm = next(o for o in g.get_stats()["Operators"] if o["name"] == "pm")
    r = pm["replicas"][0]
    return (r["Dlq_records"], r["Dlq_skipped"], r["Dlq_retries"],
            r["Inputs_ignored"])


@pytest.mark.parametrize("policy", ["dead_letter", "skip", "retry2"])
def test_error_policies_match_jax(policy):
    out = {}
    for pkg in (wj, wt):
        pol = {"dead_letter": pkg.ErrorPolicy.DEAD_LETTER,
               "skip": pkg.ErrorPolicy.SKIP,
               "retry2": pkg.ErrorPolicy.RETRY(2, backoff_s=0.0)}[policy]
        g, seen = _run_policy_graph(pkg, pol, n=800)
        out[pkg] = (seen, _letters(g), _pm_stats(g),
                    g.get_stats().get("Dead_letters"))
        if pkg is wt:
            for rec in g.dead_letters():
                assert "ValueError" in rec["traceback"]
    assert out[wt] == out[wj]
    poisons = [v for v in range(800) if v % 97 == 13]
    seen, letters, stats, total = out[wt]
    assert seen == [v * 2 for v in range(800) if v % 97 != 13]
    if policy == "skip":
        assert letters == [] and stats[1] == len(poisons)
    else:
        assert [p["v"] for _, p, _ in letters] == poisons
        assert total == len(poisons) and stats[0] == len(poisons)
    if policy == "retry2":
        assert stats[2] == 2 * len(poisons)


def test_fail_policy_unchanged():
    for pkg in (wj, wt):
        with pytest.raises(ValueError, match="poison 13"):
            _run_policy_graph(pkg, None)


def test_retry_policy_heals_transient():
    out = {}
    for pkg in (wj, wt):
        failures = {}

        def flaky(t):
            if t["v"] in (7, 31) and failures.setdefault(t["v"], 0) < 2:
                failures[t["v"]] += 1
                raise OSError("transient")
            return t

        g, seen = _run_policy_graph(
            pkg, pkg.ErrorPolicy.RETRY(3, backoff_s=0.001), n=50,
            func=flaky)
        out[pkg] = (seen, _pm_stats(g))
    assert out[wt] == out[wj]
    assert out[wt][0] == list(range(50)) and out[wt][1][2] == 4


def test_error_policy_refused_on_sources_and_parse():
    msgs = []
    for pkg in (wj, wt):
        g = _pg(pkg, "t_ref")
        g.add_source(pkg.Source_Builder(lambda s: None)
                     .with_error_policy(pkg.ErrorPolicy.SKIP).build()) \
            .add_sink(pkg.Sink_Builder(lambda t: None).build())
        with pytest.raises(pkg.WindFlowError, match="generation loop") as ei:
            run_bounded(g)
        msgs.append(str(ei.value))
        assert pkg.ErrorPolicy.parse("skip").kind == "skip"
        assert pkg.ErrorPolicy.parse("dead_letter").kind == "dead_letter"
        p = pkg.ErrorPolicy.parse("retry:3")
        assert p.kind == "retry" and p.retries == 3
        with pytest.raises(pkg.WindFlowError):
            pkg.ErrorPolicy.parse("nonsense")
    assert msgs[1] == msgs[0]


# ---------------------------------------------------------------------------
# device-path poison isolation
# ---------------------------------------------------------------------------
def _bisect_run(pkg, monkeypatch, exc=None):
    """256 rows in 64-row device batches through a DEAD_LETTER-guarded
    map whose prep raises on any batch holding the value 666 (row 100)."""
    cls = MapTPUReplica if pkg is wj else MapGPUReplica
    orig = cls.prep_device_batch
    error = exc or ValueError("poison column value 666")

    def poisoned(self, batch):
        col = batch.fields["v"]
        vals = (np.asarray(col) if pkg is wj else col.numpy())[:batch.size]
        if (vals == 666).any():
            raise error
        return orig(self, batch)

    monkeypatch.setattr(cls, "prep_device_batch", poisoned)
    out = []

    def src(shipper):
        for v in range(256):
            shipper.push({"v": np.int32(v if v != 100 else 666)})

    Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
    g = _pg(pkg, "t_dev")
    g.add_source(pkg.Source_Builder(src).with_output_batch_size(64)
                 .build()) \
        .add(Map(lambda f: {**f, "v": f["v"] + 1}).with_name("dm")
             .with_error_policy(pkg.ErrorPolicy.DEAD_LETTER).build()) \
        .add_sink(pkg.Sink_Builder(
            lambda t: out.append(int(t["v"])) if t is not None else None)
            .build())
    return g, out


def test_device_batch_bisection_isolates_poison(monkeypatch):
    res = {}
    for pkg in (wj, wt):
        g, out = _bisect_run(pkg, monkeypatch)
        run_bounded(g)
        res[pkg] = ([(r["payload_obj"], r["error"])
                     for r in g.dead_letters()], sorted(out))
    assert res[wt] == res[wj]
    letters, out = res[wt]
    assert letters == [({"v": 666}, "ValueError: poison column value 666")]
    assert out == sorted(v + 1 for v in range(256) if v != 100)


STICKY = RuntimeError("CUDA error: an illegal memory access was "
                      "encountered\nCUDA kernel errors might be "
                      "asynchronously reported at some other API call")


def test_sticky_device_error_is_not_bisected(monkeypatch):
    """A sticky CUDA error poisons the context: the guarded batch is not
    bisected (the worker fails), and a supervisor escalates at once
    instead of restarting on a dead context."""
    assert wt.supervision.is_sticky_device_error(STICKY)
    assert not wt.supervision.is_sticky_device_error(ValueError("CUDA"))
    g, _ = _bisect_run(wt, monkeypatch, exc=STICKY)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        run_bounded(g)
    assert g.dead_letters() == []
    g, _ = _bisect_run(wt, monkeypatch, exc=STICKY)
    g.with_supervision(wt.RestartPolicy(max_restarts=3, backoff_s=0.01))
    with pytest.raises(wt.SupervisionEscalated, match="sticky CUDA") as ei:
        run_bounded(g)
    assert g._supervisor.restarts == 0
    assert ei.value.__cause__ is STICKY


def test_error_policy_refuses_device_fusion():
    reasons = []
    for pkg in (wj, wt):
        Map = Map_TPU_Builder if pkg is wj else wt.Map_GPU_Builder
        g = _pg(pkg, "t_fuse")
        g.add_source(pkg.Source_Builder(
            lambda s: [s.push({"v": np.int32(v)}) for v in range(64)])
            .with_output_batch_size(32).build()) \
            .chain(Map(lambda f: {**f, "v": f["v"] + 1})
                   .with_name("m1").build()) \
            .chain(Map(lambda f: {**f, "v": f["v"] * 2}).with_name("m2")
                   .with_error_policy(pkg.ErrorPolicy.DEAD_LETTER)
                   .build()) \
            .add_sink(pkg.Sink_Builder(lambda t: None).build())
        m2 = next(s for s in g._stages if any(o.name == "m2" for o in s.ops))
        assert len(m2.ops) == 1  # m2 keeps its own stage
        reasons.append(m2.chain_refused)
    assert reasons[1] == reasons[0]
    assert "error policy" in reasons[1]


# ---------------------------------------------------------------------------
# units
# ---------------------------------------------------------------------------
def test_restart_policy_budget_and_backoff():
    for pkg in (wj, wt):
        p = pkg.RestartPolicy(max_restarts=2, window_s=1000.0, seed=1)
        assert p.allow_restart(0.0)
        p.note_restart(0.0)
        p.note_restart(0.0)
        assert not p.allow_restart(0.0)  # budget exhausted
        assert p.allow_restart(1001.0)   # outside the window: refreshed
    seen = {}
    for pkg in (wj, wt):
        p = pkg.RestartPolicy(max_restarts=10, window_s=1e9, backoff_s=1.0,
                              backoff_max_s=8.0, backoff_factor=2.0,
                              jitter=0.5, seed=42)
        seen[pkg] = []
        for _ in range(6):
            seen[pkg].append(p.next_backoff(0.0))
            p.note_restart(0.0)
    assert seen[wt] == seen[wj]  # same seed, same jitter
    for k, d in enumerate(seen[wt]):
        base = min(2.0 ** k, 8.0)
        assert base * 0.5 <= d <= base, (k, d)
    assert seen[wt][3] > seen[wt][0]


def test_closed_channel_raises_teardown_after_draining():
    ch = Channel(capacity=1)
    ch.register_input()
    errs = []

    def put(msg):
        try:
            ch.put(0, msg)
        except SupervisorTeardown as e:
            errs.append(e)

    ch.put(0, "a")
    t = threading.Thread(target=put, args=("b",))
    t.start()
    time.sleep(0.05)
    assert ch.get() == (0, "a")  # frees the slot: the put goes through
    call_bounded(t.join, WAIT_S, "blocked put")
    assert ch.blocked_put_ns > 0  # the backpressure the autoscaler reads
    t = threading.Thread(target=put, args=("c",))
    t.start()
    time.sleep(0.05)
    ch.close()
    call_bounded(t.join, WAIT_S, "blocked put")
    assert len(errs) == 1  # the blocked put raised the teardown signal
    assert ch.get() == (0, "b")  # what the channel holds still drains
    for op in (ch.get, lambda: ch.get(timeout=0.01), lambda: ch.put(0, 1)):
        with pytest.raises(SupervisorTeardown):
            op()
    assert ch.blocked_get_ns == 0  # its consumer never waited


def test_dead_letter_queue_writes_jsonl(tmp_path):
    """With a directory the queue also appends one JSON line per record
    (the durable queue a re-drive job reads); the ring keeps the payload
    object, the file its repr."""
    import json

    dlq = wt.DeadLetterQueue("g/1", capacity=2, dir=str(tmp_path))
    for v in range(3):
        try:
            raise ValueError(f"bad {v}")
        except ValueError as e:
            dlq.put("op", 0, {"v": v}, v, e)
    assert dlq.total == 3 and len(dlq) == 2  # the ring keeps the newest
    assert [r["payload_obj"] for r in dlq.records()] == [{"v": 1}, {"v": 2}]
    with open(dlq.path) as f:
        lines = [json.loads(ln) for ln in f]
    assert dlq.path.endswith("g_1.dlq.jsonl")
    assert [(r["payload"], r["error"]) for r in lines] == [
        (repr({"v": v}), f"ValueError: bad {v}") for v in range(3)]


def test_health_probes(tmp_path):
    assert wt.TorchDeviceProbe().dead_devices() == frozenset()
    probe = wt.StaticDeviceProbe(dead=[3])
    res = []
    g = _reduce_graph(wt, str(tmp_path / "probe"),
                      CrashingSource(600, ckpt_at=[200], crash_at=400), res,
                      probe=probe)
    try:
        run_bounded(g)
        # the recovery published the dead device into the process-wide
        # mesh exclusion registry
        assert wt.mesh.excluded_device_ids() == frozenset({3})
    finally:
        wt.mesh.set_excluded_devices(())
    sup = g.get_stats()["Supervision"]
    assert sup["Supervision_restarts"] == 1
    assert sup["Recovery_degraded_devices"] == 1
    assert g.failure_domains() == {}  # no mesh operator in this graph


# ---------------------------------------------------------------------------
# exactly-once sinks under supervision (tests/test_supervision.py:96, :182)
# ---------------------------------------------------------------------------
def _eo_windows_graph(tmp, src, results, supervised=True):
    g = _pg(wt, "t_sup_eo")
    g.with_checkpointing(store_dir=str(tmp / "store"))
    if supervised:
        g.with_supervision(wt.RestartPolicy(max_restarts=4, backoff_s=0.02,
                                            backoff_max_s=0.1))
    win = wt.Keyed_Windows(lambda rows: sum(r["v"] for r in rows),
                           key_extractor=lambda t: t["k"], win_len=4,
                           slide_len=4, win_type=wt.WinType.CB, name="kw",
                           parallelism=2)

    def sink(t):
        if t is not None:
            results.append((t.key, t.wid, t.value))

    g.add_source(wt.Source_Builder(src).with_name("src").build()) \
        .add(win) \
        .add_sink(wt.Sink_Builder(sink).with_name("snk")
                  .with_exactly_once(staging_dir=str(tmp / "txn")).build())
    return g


def _eo_committed(tmp):
    from windflow_tpu_torch.sinks.transactional import read_committed_records
    return sorted((r.key, r.wid, r.value) for r, _ in
                  read_committed_records(str(tmp / "txn" / "snk_r0")))


def _cb_model(n, nk=7):
    out = []
    for k in range(nk):
        vs = list(range(k, n, nk))
        out += [(k, w, sum(vs[i:i + 4]))
                for w, i in enumerate(range(0, len(vs), 4))]
    return sorted(out)


def test_supervised_auto_recovery_exactly_once(tmp_path):
    """An injected source crash heals in-process (no manual restore) and
    the exactly-once sink's output, functor and committed segments alike,
    equals the uninterrupted run's with nothing twice."""
    golden = []
    run_bounded(_eo_windows_graph(tmp_path / "gold", CrashingSource(1500),
                                  golden, supervised=False))
    assert sorted(golden) == _cb_model(1500)
    results = []
    g = _eo_windows_graph(
        tmp_path / "run",
        CrashingSource(1500, ckpt_at=[400], crash_at=900,
                       store=(StoreT, str(tmp_path / "run" / "store"))),
        results)
    run_bounded(g)
    assert sorted(results) == sorted(golden)
    assert _eo_committed(tmp_path / "run") == sorted(golden)
    st = g.get_stats()
    sup = st["Supervision"]
    assert sup["Supervision_restarts"] == 1
    assert sup["Supervision_last_restart_s"] > 0
    assert not sup["Supervision_escalated"]
    src_op = next(o for o in st["Operators"] if o["name"] == "src")
    assert src_op["replicas"][0]["Worker_crashes"] >= 1
    assert "ValueError" in src_op["replicas"][0]["Worker_last_error"]


def test_supervised_recovery_aborts_stale_precommitted_epoch(tmp_path,
                                                            monkeypatch):
    """The sink PRE-COMMITTED an epoch but the store commit dies, so the
    crash leaves a staged segment with NO committed checkpoint. The
    full-replay recovery aborts it; rolling it forward at a later
    checkpointed restore would duplicate its records. The torn-down sink
    replica is fenced."""
    from windflow_tpu_torch.sinks.transactional import FencedWriteError

    golden = []
    run_bounded(_eo_windows_graph(tmp_path / "gold", CrashingSource(1200),
                                  golden, supervised=False))
    orig = StoreT.commit
    armed = [True]

    def dying_commit(self, ckpt_id, manifest):
        if armed[0]:
            armed[0] = False
            raise RuntimeError("store commit dies after sink precommit")
        return orig(self, ckpt_id, manifest)

    monkeypatch.setattr(StoreT, "commit", dying_commit)
    results = []
    g = _eo_windows_graph(
        tmp_path / "run",
        # a second checkpoint and a later crash exercise the checkpointed
        # restore AFTER the full replay (the roll-forward the stale epoch
        # would poison)
        CrashingSource(1200, ckpt_at=[300, 600], crash_at=800), results)
    g.start()
    first_sink = next(o for o in g._ops if o.name == "snk").replicas[0]
    from torch_waits import wait_end_bounded
    wait_end_bounded(g)
    assert sorted(results) == sorted(golden)
    assert _eo_committed(tmp_path / "run") == sorted(golden)
    assert g.get_stats()["Supervision"]["Supervision_restarts"] >= 1
    with pytest.raises(FencedWriteError):
        first_sink._txn.backend.do_precommit(10_000, [])
