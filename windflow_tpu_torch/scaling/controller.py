"""RescaleController: live repartitioning of a running PipeGraph.

The port of ``windflow_tpu/scaling/controller.py``. ``rescale(op_name, parallelism)`` quiesces the
graph exactly at an aligned barrier, rebuilds the runtime plane (replica
lists, channels, emitter routing tables, fused device chains, dispatch
queues) with the target stage at the new parallelism, restores every
replica from the just-committed checkpoint, with the rescaled operator's
keyed blobs split or merged by the KEYBY routing function
(``repartition.py``), and resumes. Sources continue from their barrier
positions: no replay from the start, and a keyed operator's results
equal an uninterrupted run's.

The quiesce: the rescale epoch is triggered with ``hold=True``; every
worker parks inside ``checkpoint_now`` right after acking it. By then
each worker has flushed all pre-barrier output and forwarded the barrier,
and since every producer parks before emitting anything post-barrier, the
channels hold no data once the last ack lands. The controller releases
the old workers with ``abandon`` (they unwind without an EOS cascade),
rebuilds, restores and starts fresh workers. An error before the abandon
releases them with ``resume``, and the graph goes on unharmed on the old
topology.

Each rescale reports ``checkpoint_s`` (trigger -> commit, processing
goes on), ``pause_s`` (all parked -> resumed: the stop-the-world window)
and ``total_s`` (trigger -> resumed), and splits the pause into
``load_s`` (reading the checkpoint), ``repartition_s`` (the re-bucketing
on the host), ``teardown_s``, ``rebuild_s`` and ``restore_s`` (installing
the blobs: on a card, the H2D copies of tables and forests into the new
replicas).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..basic import RoutingMode, WindFlowError
from .repartition import (dest_fn_for, merge_emitter_states,
                          remap_neighbor_collector, repartition_refusal,
                          split_collector_states, split_operator_states,
                          stretch_emitter_state)

_O2O = -1  # channel-layout sentinel: a one-to-one edge (own replica idx)


# ---------------------------------------------------------------------------
# channel layout (mirrors PipeGraph._wire_edge)
# ---------------------------------------------------------------------------
def _edge_one2one(producer, branch, consumer,
                  par_of: Callable[[Any], int]) -> bool:
    first = consumer.first_op
    p_gpu = getattr(producer.last_op, "is_gpu", False)
    c_gpu = getattr(first, "is_gpu", False)
    return (first.input_routing is RoutingMode.FORWARD
            and branch is None
            and not (c_gpu and not p_gpu)
            and par_of(producer) == par_of(consumer))


def _input_layout(consumer, par_of: Callable[[Any], int]
                  ) -> List[Tuple[int, int]]:
    """One consumer replica's input-channel order as ``(edge_idx, pi)``
    (``pi == _O2O`` for a one-to-one edge). Mirrors the port registration
    order of ``PipeGraph._wire_edge``."""
    out: List[Tuple[int, int]] = []
    for e_i, edge in enumerate(consumer.upstreams):
        if _edge_one2one(edge.stage, edge.branch, consumer, par_of):
            out.append((e_i, _O2O))
        else:
            out.extend((e_i, pi) for pi in range(par_of(edge.stage)))
    return out


# ---------------------------------------------------------------------------
# checkpoint-state transformation
# ---------------------------------------------------------------------------
def repartition_checkpoint_states(graph, states: Dict[Tuple[str, int], dict],
                                  stage, new_n: int
                                  ) -> Dict[Tuple[str, int], dict]:
    """A committed checkpoint's state map for a rebuild with ``stage`` at
    ``new_n`` replicas: split/merge the rescaled ops' keyed blobs,
    re-index neighbour collector channels, and re-synthesize the routing
    counters of every emitter whose destination count changes."""
    old_n = stage.parallelism

    def par_old(s) -> int:
        return s.parallelism

    def par_new(s) -> int:
        return new_n if s is stage else s.parallelism

    out = dict(states)

    # --- the rescaled stage's own blobs --------------------------------
    first_name = stage.first_op.name
    for op in stage.ops:
        if getattr(op, "_fused_hidden", False):
            continue  # fused sub-op: its state rides the head op's blob
        olds: List[dict] = []
        for i in range(old_n):
            st = out.pop((op.name, i), None)
            if st is None:
                raise WindFlowError(
                    f"rescale: checkpoint is missing the blob for "
                    f"{op.name!r} replica {i} — cannot repartition")
            olds.append(dict(st))
        emitters = [st.pop("__emitter__", None) for st in olds]
        colls = [st.pop("__collector__", None) for st in olds]
        news = split_operator_states(op, olds, new_n)
        if op.name == first_name and any(colls):
            key_fn = stage.first_op.key_extractor
            if key_fn is None:
                # a FORWARD-routed consumer: any replica may take any
                # tuple, so the whole backlog parks on replica 0
                split_cs = split_collector_states(
                    colls, new_n, lambda p: 0, lambda k: 0, op.name)
            else:
                split_cs = split_collector_states(
                    colls, new_n, key_fn, dest_fn_for(op, new_n), op.name)
            # the rescaled stage's own channel layout can shift too (a
            # FORWARD edge into it flips one-to-one <-> shuffle)
            old_in = _input_layout(stage, par_old)
            new_in = _input_layout(stage, par_new)
            changed = {e for e in range(len(stage.upstreams))
                       if _edge_one2one(stage.upstreams[e].stage,
                                        stage.upstreams[e].branch, stage,
                                        par_old)
                       != _edge_one2one(stage.upstreams[e].stage,
                                        stage.upstreams[e].branch, stage,
                                        par_new)}
            if old_in != new_in:
                split_cs = [None if c is None else
                            remap_neighbor_collector(c, old_in, new_in,
                                                     changed)
                            for c in split_cs]
            for j, c in enumerate(split_cs):
                if c:
                    news[j]["__collector__"] = c
        # new outgoing emitters: the destination count at the NEW
        # parallelism
        n_dests = _emitter_dest_count(stage, par_new)
        for j in range(new_n):
            news[j]["__emitter__"] = merge_emitter_states(emitters, n_dests)
            out[(op.name, j)] = news[j]

    # --- neighbours -----------------------------------------------------
    for t in graph._stages:
        if t is stage:
            continue
        # a downstream consumer of the rescaled stage: its input-channel
        # numbering shifted, re-index its collector state
        feeds_from = any(e.stage is stage for e in t.upstreams)
        old_in = _input_layout(t, par_old)
        new_in = _input_layout(t, par_new)
        if feeds_from and old_in != new_in:
            changed = {e_i for e_i, e in enumerate(t.upstreams)
                       if e.stage is stage
                       or _edge_one2one(e.stage, e.branch, t, par_old)
                       != _edge_one2one(e.stage, e.branch, t, par_new)}
            fo = t.first_op
            for i in range(t.parallelism):
                st = out.get((fo.name, i))
                if st is None:
                    continue
                cs = st.get("__collector__")
                if cs:
                    st = dict(st)
                    st["__collector__"] = remap_neighbor_collector(
                        cs, old_in, new_in, changed)
                    out[(fo.name, i)] = st
        # an upstream producer into the rescaled stage: its emitter's
        # destination count changes, re-synthesize its routing counters
        for b, target in _branch_targets(t):
            if target is not stage:
                continue
            o2o_new = _edge_one2one(t, b, stage, par_new)
            n_dests = 1 if o2o_new else new_n
            lo = t.last_op
            for i in range(t.parallelism):
                st = out.get((lo.name, i))
                if st is None:
                    continue
                st = dict(st)
                em = st.get("__emitter__") or {}
                if b is None:
                    st["__emitter__"] = stretch_emitter_state(em, n_dests)
                else:
                    inner = list(em.get("inner", []))
                    while len(inner) <= b:
                        inner.append({})
                    inner[b] = stretch_emitter_state(inner[b], n_dests)
                    st["__emitter__"] = {"inner": inner}
                out[(lo.name, i)] = st
    return out


def _branch_targets(producer) -> List[Tuple[Optional[int], Any]]:
    """``(branch, consumer stage)`` pairs of a producer stage; branch None
    for the plain downstream edge."""
    if producer.is_split:
        return list(enumerate(producer.split_branches))
    return [(None, producer.downstream)]


def _emitter_dest_count(stage, par_of) -> int:
    """Destination count of the rescaled stage's outgoing emitter under
    the ``par_of`` parallelism view (0 for sinks)."""
    down = stage.downstream
    if down is None:
        return 0
    if _edge_one2one(stage, None, down, par_of):
        return 1
    return par_of(down)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------
class RescaleReport(dict):
    """Per-event timing and accounting (a dict, for JSON export)."""

    @property
    def changed(self) -> bool:
        return bool(self.get("changed"))


class RescaleController:
    """One per PipeGraph; ``PipeGraph.rescale`` delegates here. Rescales
    are serialized by the controller's lock: concurrent callers (the
    autoscaler thread and a manual call) queue up."""

    def __init__(self, graph) -> None:
        self.graph = graph
        self.lock = threading.Lock()
        self.events = 0
        self.failures = 0
        self.history: List[Dict[str, Any]] = []  # bounded, newest last
        self.last: Optional[RescaleReport] = None
        # the "rescale" track of the flight recorder (rescale:* spans)
        from ..monitoring.flightrec import ControlRing
        self._ring = ControlRing(graph, "rescale", "rescale-controller")

    def rescale(self, op_name: str, parallelism: int,
                timeout_s: Optional[float] = None) -> RescaleReport:
        g = self.graph
        if parallelism < 1:
            raise WindFlowError(
                f"rescale({op_name!r}): parallelism must be >= 1")
        if not g._started or g._ended:
            raise WindFlowError(
                "rescale requires a RUNNING graph (between start() and "
                "wait_end() returning)")
        if g._coordinator is None:
            raise WindFlowError(
                "rescale needs aligned checkpointing: call "
                "with_checkpointing() before start()")
        stage = next((s for s in g._stages
                      if any(op.name == op_name for op in s.ops)), None)
        if stage is None:
            raise WindFlowError(
                f"rescale: no operator named {op_name!r} in this graph")
        # legality FIRST, before any barrier is triggered
        for op in stage.ops:
            refusal = repartition_refusal(op)
            if refusal is not None:
                raise WindFlowError(
                    f"rescale: operator {op.name!r} is not "
                    f"repartitionable — {refusal}")
        # every plain source must be replayable: the rescale restores ALL
        # sources from their barrier positions, and a functor without a
        # cursor would silently replay from zero
        from ..operators.source import Source
        for s in g._stages:
            if s.is_source and isinstance(s.first_op, Source) \
                    and getattr(s.first_op.func, "snapshot_position",
                                None) is None:
                raise WindFlowError(
                    f"rescale: source {s.first_op.name!r} is not "
                    "replayable (no snapshot_position()/restore() on the "
                    "functor) — a live rescale would replay its whole "
                    "stream from zero; add the replayable-source protocol "
                    "(the same one checkpoint restore uses)")
        with self.lock:
            return self._rescale_locked(stage, op_name, parallelism,
                                        timeout_s)

    def _rescale_locked(self, stage, op_name: str, new_n: int,
                        timeout_s: Optional[float]) -> RescaleReport:
        g = self.graph
        coord = g._coordinator
        old_n = stage.parallelism
        report = RescaleReport(
            op=op_name, stage=stage.describe(), old_parallelism=old_n,
            new_parallelism=new_n, changed=False, t_unix=time.time())
        if new_n == old_n:
            report["reason"] = "no-op: already at requested parallelism"
            self.last = report
            return report
        timeout = timeout_s if timeout_s is not None else \
            (coord.epoch_timeout_s or 60.0)
        t0 = time.monotonic()
        span = self._ring.span
        span("rescale:trigger", 0.0, {"op": op_name, "from": old_n,
                                      "to": new_n})
        cid = coord.trigger(force=True, hold=True)
        try:
            coord.wait_committed(cid, timeout)
            t_commit = time.monotonic()
            if not coord.wait_all_parked(cid, timeout):
                raise WindFlowError(
                    f"rescale: checkpoint {cid} committed but workers "
                    f"did not all quiesce within {timeout:.0f}s "
                    f"(parked: {sorted(coord.parked)})")
            t_parked = time.monotonic()
            span("rescale:quiesce", (t_parked - t0) * 1e6, {"ckpt_id": cid})
            # transform the checkpoint BEFORE the old plane is torn down:
            # a repartition error here aborts with the graph unharmed
            ckpt_dir = coord.store.checkpoint_dir(cid)
            states = coord.store.load_states(
                ckpt_dir, coord.store.load_manifest(ckpt_dir))
            t_loaded = time.monotonic()
            states = repartition_checkpoint_states(g, states, stage, new_n)
            t_split = time.monotonic()
        except BaseException:
            self.failures += 1
            coord.release_hold("resume")
            raise
        # ---- point of no return: tear down the old runtime plane ------
        coord.abort_pending()
        coord.release_hold("abandon")
        old_workers = list(g._workers)
        for w in old_workers:
            w.join(timeout=max(timeout, 10.0))
        stuck = [w.name for w in old_workers if w.is_alive()]
        if stuck:
            raise WindFlowError(
                f"rescale: old workers failed to unwind: {stuck}")
        t_down = time.monotonic()
        g._note_retired_replicas(stage, new_n)
        for op in stage.ops:
            op.parallelism = new_n
        g._rebuild_runtime()
        t_built = time.monotonic()
        span("rescale:rebuild", (t_built - t_down) * 1e6,
             {"threads": len(g._workers)})
        g._restore_states(states)
        g._sync_device()
        t_restored = time.monotonic()
        span("rescale:restore", (t_restored - t_built) * 1e6,
             {"ckpt_id": cid})
        for w in g._workers:
            w.start()
        t_resume = time.monotonic()
        span("rescale:resume", 0.0, {"op": op_name, "parallelism": new_n})
        report.update(
            changed=True, ckpt_id=cid,
            checkpoint_s=round(t_commit - t0, 6),
            pause_s=round(t_resume - t_parked, 6),
            total_s=round(t_resume - t0, 6),
            load_s=round(t_loaded - t_parked, 6),
            repartition_s=round(t_split - t_loaded, 6),
            teardown_s=round(t_down - t_split, 6),
            rebuild_s=round(t_built - t_down, 6),
            restore_s=round(t_restored - t_built, 6))
        self.events += 1
        self.last = report
        self.history.append(dict(report))
        del self.history[:-64]
        return report

    def stats(self) -> Dict[str, Any]:
        last = self.last or {}
        return {
            "Rescale_events": self.events,
            "Rescale_failures": self.failures,
            "Rescale_last_op": last.get("op"),
            "Rescale_last_from": last.get("old_parallelism"),
            "Rescale_last_to": last.get("new_parallelism"),
            "Rescale_last_checkpoint_s": last.get("checkpoint_s", 0.0),
            "Rescale_last_pause_s": last.get("pause_s", 0.0),
            "Rescale_last_total_s": last.get("total_s", 0.0),
            "Rescale_history": list(self.history),
        }
