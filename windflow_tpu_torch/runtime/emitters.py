"""Emitters: the routing plane on the producer side.

Trimmed copy of ``windflow_tpu/runtime/emitters.py``: the host-plane
FORWARD, KEYBY and BROADCAST emitters (``wf/forward_emitter.hpp``,
``wf/keyby_emitter.hpp:210-259``, ``wf/broadcast_emitter.hpp``), the
``SplittingEmitter`` of ``MultiPipe.split`` (``wf/splitting_emitter.hpp``),
the terminal ``NullEmitter``, the watermark-punctuation cadence
(``wf/basic.hpp:199-216``), the checkpoint hooks (barrier propagation,
routing counters in the snapshot) and the latency-tracing stamp: the
owning replica sets ``trace_ts`` just before an emit, and the first
message made while it is set carries it (a batch folds it into its
``trace_min`` / ``trace_max``). The device-plane edges live in
``windflow_tpu_torch.gpu.emitters_gpu``.

Batch cuts (a deliberate difference from the JAX package). A batch carries
the lowest watermark of its rows, so a late row in a batch that straddles
a watermark step is judged against the older watermark. Cuts made because
a buffer is full, or at EOS, a checkpoint barrier or an explicit flush,
are a function of the input. A cut that a timer makes due (here the
punctuation cadence; the device staging emitter adds its buffers' age)
is not: it falls wherever the scheduler puts it. So a due timer cut that
finds rows buffered is HELD (``_held``: each held cut with the newest
watermark buffered when it fell due). Every emit first releases the held
cuts whose watermark its row's differs from: the buffer ships just
before that row, and a held punctuation goes out right after (the
cadence counts from when it fell due). A source whose watermark steps
on every push thus cuts one row later than a cut made at once would, at
its next push. The one scheduling dependence left is the backstop: a
held cut that has waited ``TIMER_CUT_BACKSTOP_USEC`` (400 ms) ships
whatever the watermark; it is also what ships the rows left at a lull.
The stats count the releases (``Timer_cuts_held``,
``Timer_cuts_backstop``).
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, List, Optional, Sequence,
                    Tuple)

from ..basic import (DEFAULT_WM_AMOUNT, DEFAULT_WM_INTERVAL_USEC,
                     TIMER_CUT_BACKSTOP_USEC, ExecutionMode, WindFlowError,
                     current_time_usecs)
from ..message import Batch, Single, make_punctuation
from .channel import Port

# the key of a held punctuation among the held cuts (staging buffers are
# keyed by their index)
HELD_PUNCT = -1


class BasicEmitter:
    """Base: owns destination ports, optional micro-batching, per-destination
    id counters, punctuation cadence."""

    def __init__(self, num_dests: int, output_batch_size: int = 0,
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT,
                 punct_generation: bool = True) -> None:
        self.num_dests = num_dests
        self.output_batch_size = output_batch_size
        self.execution_mode = execution_mode
        self.punct_generation = punct_generation  # off for inline chain edges
        self.ports: List[Port] = []  # wired by the topology layer
        self._next_ids = [0] * num_dests
        self._emit_count = 0
        self._last_punct_usec = current_time_usecs()
        # timer cuts that fell due with rows buffered (module docstring):
        # the cut (HELD_PUNCT, or a staging buffer's index) -> the newest
        # watermark buffered then, and when it fell due (usec)
        self._held: Dict[int, Tuple[int, int]] = {}
        self.stats = None  # optional StatsRecord of the owning replica
        # transient latency-tracing origin stamp (0 = untraced tuple)
        self.trace_ts = 0

    def set_stats(self, stats) -> None:
        self.stats = stats

    def set_ports(self, ports: Sequence[Port]) -> None:
        assert len(ports) == self.num_dests, (len(ports), self.num_dests)
        self.ports = list(ports)

    # -- core send helpers -------------------------------------------------
    def _send_single(self, dest: int, payload: Any, ts: int, wm: int,
                     msg_id: Optional[int] = None) -> None:
        """``msg_id`` overrides the per-destination counter: window replicas
        stamp result and pane ids for a downstream id-sequencing collector
        (the reference ``doEmit``'s identifier argument)."""
        msg = Single(payload,
                     self._next_ids[dest] if msg_id is None else msg_id,
                     ts, wm)
        if self.trace_ts:
            msg.trace_ts = self.trace_ts
            self.trace_ts = 0
        self._next_ids[dest] += 1
        if self.stats is not None:
            self.stats.outputs_sent += 1
        self.ports[dest].send(msg)

    def _send_batch(self, dest: int, batch: Any) -> None:
        batch.id = self._next_ids[dest]
        self._next_ids[dest] += 1
        if self.stats is not None:
            self.stats.outputs_sent += batch.size
        self.ports[dest].send(batch)

    def _send_punct(self, dest: int, wm: int) -> None:
        p = make_punctuation(wm)
        p.id = self._next_ids[dest]
        self._next_ids[dest] += 1
        if self.stats is not None:
            self.stats.punct_sent += 1
        self.ports[dest].send(p)

    def _maybe_generate_punctuation(self, wm: int) -> None:
        if not self.punct_generation \
                or self.execution_mode is not ExecutionMode.DEFAULT:
            return
        self._emit_count += 1
        if self._emit_count % DEFAULT_WM_AMOUNT != 0:
            return
        now = current_time_usecs()
        if HELD_PUNCT in self._held:
            self._release_held(None, now)  # the backstop
            return
        if now - self._last_punct_usec < DEFAULT_WM_INTERVAL_USEC:
            return
        # the cadence counts from when a punctuation falls due, held or not
        self._last_punct_usec = now
        if self._holds_rows():
            self._held[HELD_PUNCT] = (wm, now)
            return
        self.propagate_punctuation(wm)

    def _holds_rows(self) -> bool:
        """Whether a partial output batch is buffered."""
        return False

    def _release_held(self, wm: Optional[int], now: int = 0) -> int:
        """Release the held cuts that a push of watermark ``wm`` steps
        past (every emit calls this first while one is held) or, with
        ``wm`` None, those held ``TIMER_CUT_BACKSTOP_USEC`` by ``now``.
        Buffers ship first, then the held punctuation; the number
        released."""
        punct = None
        released = 0
        for cut, (w, since) in list(self._held.items()):
            if wm is not None:
                if wm == w:
                    continue
                if self.stats is not None:
                    self.stats.timer_cuts_held += 1
            elif now - since < TIMER_CUT_BACKSTOP_USEC:
                continue
            elif self.stats is not None:
                self.stats.timer_cuts_backstop += 1
            del self._held[cut]
            released += 1
            if cut == HELD_PUNCT:
                punct = w
            else:
                self._ship_held(cut)
        if punct is not None:
            self.propagate_punctuation(punct)
        return released

    def _ship_held(self, buf: int) -> None:
        """Ship staging buffer ``buf`` (the device staging emitter)."""

    # -- public API --------------------------------------------------------
    def emit(self, payload: Any, ts: int, wm: int,
             msg_id: Optional[int] = None) -> None:
        raise NotImplementedError

    def emit_columns(self, cols, ts_arr, wm: int, trace_rows=None) -> None:
        """Columnar push: generic emitters materialize dict rows; the
        device staging emitter overrides this with a vectorized path.
        ``trace_rows`` (int indices into the block) marks the traced rows:
        each re-arms ``trace_ts``, so sampling matches the row path."""
        names = list(cols)
        pulled = [cols[n] for n in names]
        t0 = self.trace_ts
        marks = None
        nxt = -1
        if t0 and trace_rows is not None and len(trace_rows):
            self.trace_ts = 0
            marks = iter(trace_rows)
            nxt = int(next(marks, -1))
        for i in range(len(ts_arr)):
            if i == nxt:
                self.trace_ts = t0
                nxt = int(next(marks, -1))
            self.emit({n: p[i].item() for n, p in zip(names, pulled)},
                      int(ts_arr[i]), wm)

    def propagate_punctuation(self, wm: int) -> None:
        """Flush partial batches then punctuate every destination."""
        self.flush()
        for d in range(self.num_dests):
            self._send_punct(d, wm)

    def flush(self) -> None:
        """Send any partially-filled output batches (EOS / punctuation)."""

    def send_eos_all(self) -> None:
        self.flush()
        for port in self.ports:
            port.send_eos()

    def send_barrier_all(self, barrier) -> None:
        """Checkpoint-barrier propagation: flush partial batches FIRST so
        every already-emitted tuple stays pre-barrier on its channel, then
        send the barrier on every edge (one per port, like EOS — never
        batched, never reordered)."""
        self.flush()
        for port in self.ports:
            port.send(barrier.copy_for_dest())

    def eos_ports(self) -> Sequence[Port]:
        return self.ports

    # -- checkpointing: the routing counters travel with the replica's blob
    # (the round-robin cursor keeps FORWARD placement deterministic)
    def emitter_state(self) -> dict:
        st = {"next_ids": list(self._next_ids),
              "emit_count": self._emit_count}
        rr = getattr(self, "_rr", None)
        if rr is not None:
            st["rr"] = rr
        return st

    def restore_emitter_state(self, state: dict) -> None:
        ids = state.get("next_ids")
        if ids is not None and len(ids) == len(self._next_ids):
            self._next_ids = list(ids)
        self._emit_count = state.get("emit_count", 0)
        if "rr" in state and hasattr(self, "_rr"):
            self._rr = state["rr"]


class ForwardEmitter(BasicEmitter):
    """FORWARD / REBALANCING: round-robin across destinations."""

    def __init__(self, num_dests: int, output_batch_size: int = 0,
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT
                 ) -> None:
        super().__init__(num_dests, output_batch_size, execution_mode)
        self._rr = 0
        self._batch: Optional[Batch] = None

    def emit(self, payload: Any, ts: int, wm: int,
             msg_id: Optional[int] = None) -> None:
        if self._held:
            self._release_held(wm)
        if self.output_batch_size <= 0:
            self._send_single(self._rr, payload, ts, wm, msg_id)
            self._rr = (self._rr + 1) % self.num_dests
        else:
            if self._batch is None:
                self._batch = Batch()
            self._batch.add_tuple(payload, ts, wm)
            if self.trace_ts:
                self._batch.note_trace(self.trace_ts)
                self.trace_ts = 0
            if self._batch.size >= self.output_batch_size:
                self._send_batch(self._rr, self._batch)
                self._rr = (self._rr + 1) % self.num_dests
                self._batch = None
        self._maybe_generate_punctuation(wm)

    def _holds_rows(self) -> bool:
        return self._batch is not None and self._batch.size > 0

    def flush(self) -> None:
        if self._batch is not None and self._batch.size > 0:
            self._send_batch(self._rr, self._batch)
            self._rr = (self._rr + 1) % self.num_dests
            self._batch = None


class KeyByEmitter(BasicEmitter):
    """KEYBY: ``dest = hash(key(payload)) % num_dests``."""

    def __init__(self, key_extractor: Callable[[Any], Any], num_dests: int,
                 output_batch_size: int = 0,
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT
                 ) -> None:
        super().__init__(num_dests, output_batch_size, execution_mode)
        self.key_extractor = key_extractor
        self._batches: List[Optional[Batch]] = [None] * num_dests

    def emit(self, payload: Any, ts: int, wm: int,
             msg_id: Optional[int] = None) -> None:
        if self._held:
            self._release_held(wm)
        dest = hash(self.key_extractor(payload)) % self.num_dests
        if self.output_batch_size <= 0:
            self._send_single(dest, payload, ts, wm, msg_id)
        else:
            b = self._batches[dest]
            if b is None:
                b = self._batches[dest] = Batch()
            b.add_tuple(payload, ts, wm)
            if self.trace_ts:
                b.note_trace(self.trace_ts)
                self.trace_ts = 0
            if b.size >= self.output_batch_size:
                self._send_batch(dest, b)
                self._batches[dest] = None
        self._maybe_generate_punctuation(wm)

    def _holds_rows(self) -> bool:
        return any(b is not None and b.size > 0 for b in self._batches)

    def flush(self) -> None:
        for d, b in enumerate(self._batches):
            if b is not None and b.size > 0:
                self._send_batch(d, b)
                self._batches[d] = None


class BroadcastEmitter(BasicEmitter):
    """BROADCAST: every destination receives a copy
    (``wf/broadcast_emitter.hpp``; the reference shares one refcounted
    message, this copies the batch per destination — payload objects are
    shared, so broadcast-fed in-place operators must copy-on-write,
    ``wf/map.hpp:348``)."""

    def __init__(self, num_dests: int, output_batch_size: int = 0,
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT
                 ) -> None:
        super().__init__(num_dests, output_batch_size, execution_mode)
        self._batch: Optional[Batch] = None

    def emit(self, payload: Any, ts: int, wm: int,
             msg_id: Optional[int] = None) -> None:
        if self._held:
            self._release_held(wm)
        if self.output_batch_size <= 0:
            for d in range(self.num_dests):
                self._send_single(d, payload, ts, wm, msg_id)
        else:
            if self._batch is None:
                self._batch = Batch()
            self._batch.add_tuple(payload, ts, wm)
            if self.trace_ts:
                self._batch.note_trace(self.trace_ts)
                self.trace_ts = 0
            if self._batch.size >= self.output_batch_size:
                self._broadcast_batch(self._batch)
                self._batch = None
        self._maybe_generate_punctuation(wm)

    def _broadcast_batch(self, batch: Batch) -> None:
        for d in range(self.num_dests):
            self._send_batch(d, batch.copy_for_dest() if d > 0 else batch)

    def _holds_rows(self) -> bool:
        return self._batch is not None and self._batch.size > 0

    def flush(self) -> None:
        if self._batch is not None and self._batch.size > 0:
            self._broadcast_batch(self._batch)
            self._batch = None


def check_branch_index(s: int, n_branches: int) -> int:
    """Shared split-branch validation (host and device planes)."""
    if not 0 <= s < n_branches:
        raise WindFlowError(
            f"splitting logic returned branch index {s} outside "
            f"[0, {n_branches})")
    return s


class SplittingEmitter(BasicEmitter):
    """Tree emitter of ``MultiPipe.split``: the user logic maps a tuple to
    a branch index, an iterable of indices (a copy to each) or None (the
    tuple is dropped); one inner emitter per branch
    (``wf/splitting_emitter.hpp:48-341``)."""

    def __init__(self, splitting_logic: Callable[[Any], Any],
                 inner_emitters: List[BasicEmitter],
                 execution_mode: ExecutionMode = ExecutionMode.DEFAULT
                 ) -> None:
        super().__init__(sum(e.num_dests for e in inner_emitters), 0,
                         execution_mode)
        self.splitting_logic = splitting_logic
        self.inner = inner_emitters

    def set_stats(self, stats) -> None:
        super().set_stats(stats)
        for e in self.inner:
            e.set_stats(stats)

    def set_ports(self, ports: Sequence[Port]) -> None:
        # ports are laid out branch by branch, in order
        self.ports = list(ports)
        off = 0
        for e in self.inner:
            e.set_ports(ports[off:off + e.num_dests])
            off += e.num_dests

    def emit(self, payload: Any, ts: int, wm: int,
             msg_id: Optional[int] = None) -> None:
        sel = self.splitting_logic(payload)
        t0 = self.trace_ts
        if t0:
            self.trace_ts = 0
        if sel is None:
            return
        n = len(self.inner)
        if isinstance(sel, int):
            inner = self.inner[check_branch_index(sel, n)]
            inner.trace_ts = t0
            inner.emit(payload, ts, wm, msg_id)
        else:
            for s in sel:
                inner = self.inner[check_branch_index(s, n)]
                inner.trace_ts = t0
                inner.emit(payload, ts, wm, msg_id)

    def propagate_punctuation(self, wm: int) -> None:
        for e in self.inner:
            e.propagate_punctuation(wm)

    def flush(self) -> None:
        for e in self.inner:
            e.flush()

    def send_eos_all(self) -> None:
        for e in self.inner:
            e.send_eos_all()

    def send_barrier_all(self, barrier) -> None:
        for e in self.inner:
            e.send_barrier_all(barrier)

    def eos_ports(self):
        return [p for e in self.inner for p in e.eos_ports()]

    def emitter_state(self) -> dict:
        return {"inner": [e.emitter_state() for e in self.inner]}

    def restore_emitter_state(self, state: dict) -> None:
        for e, st in zip(self.inner, state.get("inner", [])):
            e.restore_emitter_state(st)


class NullEmitter(BasicEmitter):
    """Terminal operators (Sink) have no output."""

    def __init__(self) -> None:
        super().__init__(0, 0)

    def emit(self, payload: Any, ts: int, wm: int,
             msg_id: Optional[int] = None) -> None:  # pragma: no cover
        raise RuntimeError("Sink cannot emit")

    def propagate_punctuation(self, wm: int) -> None:
        pass

    def send_eos_all(self) -> None:
        pass
