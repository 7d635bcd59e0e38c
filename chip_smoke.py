"""Chip smoke test of the PyTorch/CUDA port (``windflow_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one line of its own:

1. device: the card's name and power limit (``nvidia-smi``) and
   ``torch.cuda.get_device_name``;
2. build: compiles the hand-written kernels from the sources in this
   checkout (``windflow_tpu_torch/kernels/*.cu``, ``nvcc`` for sm_90a) and
   lists each kernel's registers, stack frame and spills (``-Xptxas -v``);
   a stack frame or a spill fails the phase;
3. kernel checks: each kernel against its plain PyTorch version on CUDA
   tensors at the main path's shapes, two shapes that move tens of MB and
   a few edge shapes (1% of float values NaN); results must be
   bit-identical (``kernel_check`` lines, with the launch plan);
4. main path, high cardinality (``bench.py``'s HC config: 10,240 keys,
   TB window 100 ms / slide 25 ms, 65,536-tuple int32 batches, watermark
   advancing every batch, ``fieldwise(value="sum")``) through
   ``PipeGraph`` on ``cuda``; the same stream through the port on the CPU
   must give identical window rows; the rebuild kernel must have run;
5. main path, 64 keys (``bench.py``'s base config, 128 windows per batch);
   then phase ``fusion``, part ``ffat``: the high-cardinality stream
   through ``map -> Ffat_Windows_GPU`` and ``map -> filter ->
   Ffat_Windows_GPU`` built with ``chain``, fused (one
   ``FusedFfatReplica``) and unfused (``fusion=False``) on the card in
   turns and fused on the CPU: equal window rows, K1 launched once per
   firing batch, tuples/s and device programs per batch fused and
   unfused;
6. the graph_tests_gpu path (``graph_gpu``): Columnar source -> Map_GPU
   (value*3 + key) -> Filter_GPU (value % 2 == 0) -> Reduce_GPU keyed by
   "key" at parallelism 2 (a keyed device -> device edge) -> columnar sink,
   and the same stream folded by a global Reduce_GPU, at ``bench.py``'s
   keyed-reduce size (256 keys, 65,536-tuple int32 batches; 2 warm-up and
   12 timed batches). Each graph's rows on ``cuda`` must equal the port's
   CPU run of the same stream (as a multiset for the keyed graph, as a
   sequence for the global one) and a numpy fold of the stream; a small
   broadcast graph must too. The line gives tuples/s, and from a run under
   ``torch.profiler`` the device's idle share and launches per batch; the
   ``programs`` lines give the device time per batch and launches of the
   compaction, tree-reduce and keyed-scan programs at 65,536 rows with
   their bytes bound. Before them, phase ``fusion``, part ``ops``: the
   same stream (24 timed batches) through ``map -> filter -> global /
   keyed Reduce_GPU`` built with ``chain`` at parallelism 1, fused (one
   replica) at megabatch 1, 4 and 8 and unfused, in turns; rows must
   equal the unfused CPU run and the numpy fold; one line per megabatch
   width gives tuples/s fused and unfused, host prep and commit ms per
   batch of each stage, Megabatch_*, Programs_per_batch and a profiled
   run's idle share and launches per batch;
7. kernel times (``kernel_time`` lines), after the main path so that the
   profiler's tracing cannot touch it: the timed forests checked again,
   then the kernel's device duration (``device_ms``: its CUDA time by
   name from ``torch.profiler`` over 30 calls, divided by 30), the event
   bracket around the whole wrapper (``wrapper_ms``: wrapper + kernel,
   median of 30), both with the L2 flushed before each call (and warm at
   the two shapes larger than the L2), the plain version's time, the
   memory bound (``bound_ms``) and ``bound_share`` = bound_ms /
   device_ms (``device_ms`` and ``bound_share`` are null when
   ``torch.profiler`` lost the kernel's records in every trace: the
   card's profiler has been seen to drop whole traces);
8. keyed device state (``state`` lines): stateful Map_GPU / Filter_GPU
   through ``PipeGraph`` on the card and on the CPU, rows equal between
   them and to a numpy fold. Parts ``smap`` (``bench.py``'s stateful map:
   ``value + n``, ``n + 1`` per key, 64 keys, 65,536-tuple batches),
   ``smap_hc`` (the same at 10,240 keys, then at 1,048,576 keys, which
   grows the device table to 2^20 rows), ``sfilter`` (a per-key running
   max at 10,240 keys), ``fused`` (map -> smap -> filter -> keyed reduce
   at parallelism 1, fused at megabatch 1 and 4 and unfused, in turns)
   and ``tiered`` (``bench.py``'s run_tiered: Zipf 1.1 over 10^7 keys,
   a 1,024-slot hot tier, 512-tuple batches, against the dense CPU run;
   ``Tier_promotes`` / ``Tier_demotes`` / ``Tier_miss_rate``). Each part
   gives tuples/s, host prep / commit ms per batch and a profiled run's
   idle share and launches per batch; then the ``programs`` line of the
   grid scan (K8) on one smap batch: device time, launches and the bytes
   bound;
9. branching graphs (``dag`` lines), BASELINE's ``split_tests_gpu +
   merge_tests_gpu`` config at ``bench.py``'s sizes (10,240 keys,
   65,536-tuple int32 batches, 2 warm-up and 12 timed batches): part
   ``diamond`` (Map_GPU computing branch = value % 2 -> a device split on
   that column -> {Map_GPU value*3, Filter_GPU value % 3 != 0} -> merge ->
   Reduce_GPU keyed by the composite key ("key", "branch") at
   parallelism 2; rows equal the CPU run as a multiset and a numpy fold)
   and part ``merge_ffat`` (two sources of half the keys each merged into
   the high-cardinality window; window rows equal the CPU run, K1 once
   per firing batch); each gives tuples/s, host prep / commit ms per
   batch of each stage (``diamond``) and a profiled run's idle share and
   launches per batch;
10. kill and restore (``recovery`` lines), parts ``smap`` (the stateful
   map at 10,240 keys), ``ffat`` (the high-cardinality main path) and
   ``fused`` (map -> smap -> filter, fused): a source that requests a
   checkpoint after batch 8 of 24 and raises before batch 16, then
   ``run(restore_from=...)`` of the same graph; the merged output must
   equal the uninterrupted run on the card and on the CPU. Each line
   gives, per committed epoch of a run checkpointing every 4 batches,
   the slowest worker's cut (barrier at the worker -> ack) split into
   drain, capture and write, the bytes, the alignment stall and the
   commit ms; the restore time (``start`` -> first delivery); and
   tuples/s with a checkpoint every 4 batches and with none, in turns;

then the ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It needs ``torch.cuda.is_available()``
and the ``windflow_tpu_torch`` package beside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)

TS_STEP, AGG_RATE_KEYS = 50, 64  # bench.py: event time per tuple
WIN_US, SLIDE_US = 100_000, 25_000
BATCH = 65_536
HC_KEYS = 10_240  # bench.py:83
N_BATCHES = 24
WARMUP = 4
# graph_gpu: bench.py's keyed reduce (256 keys, 12 batches, bench.py:1586)
GRAPH_KEYS = 256
GRAPH_BATCHES, GRAPH_WARMUP = 14, 2
GRAPH_PAR = 2
# fusion (b): 2 warm-up + 24 timed batches, so that K=8 forms groups
FUSION_BATCHES = 26
# state: bench.py's stateful map (64 keys, bench.py:1581) and the other
# parts, 2 warm-up + 12 timed batches; 1,048,576 keys grow the table to
# 2^20 rows within them
STATE_KEYS, STATE_BATCHES, STATE_WARMUP = 64, 14, 2
HUGE_KEYS = 1 << 20
# state, part tiered: bench.py's run_tiered (bench.py:1264-1316)
TIER_KEY_SPACE, TIER_HOT, TIER_TUPLES, TIER_BATCH = 10_000_000, 1024, \
    80_000, 512


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


# ---------------------------------------------------------------------------
def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail("nvidia-smi: " + smi.stderr.strip())
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    phase("device", nvidia_smi=card, torch_name=name,
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda)
    return card, name


def ptxas_report(log):
    """[kernel, registers, stack frame bytes, spill store bytes, spill
    load bytes] for every kernel in an ``nvcc -Xptxas -v`` log."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            cur = [ln.split("Function properties for")[1].strip(), 0, 0, 0, 0]
            out.append(cur)
        elif cur is not None and "bytes stack frame" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split()
                    if w.isdigit()]
            cur[2:5] = nums[:3]
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur[1] = int(ln.split("Used")[1].split()[0])
    return out


def build_phase():
    from windflow_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.load_library("forest_rebuild")
    info = build.BUILD_INFO["forest_rebuild"]
    report = ptxas_report(info["log"])
    phase("build", kernel="forest_rebuild",
          nvcc_s=round(info["seconds"], 3),
          total_s=round(time.perf_counter() - t0, 3),
          kernels=len(report),
          max_registers=max((r[1] for r in report), default=None),
          ptxas=report)
    if info["log"] and not report:
        fail("no kernel in the nvcc -Xptxas -v log")
    bad = [r for r in report if any(r[2:5])]
    if bad:
        fail(f"kernels with a stack frame or spills: {bad}")


# ---------------------------------------------------------------------------
def _forest(torch, K, F, spec, gen):
    """Random (trees, tvalid) on the card: leaves random, stale internals
    random too, validity random, 1% of the float values NaN."""
    trees = {}
    for i, (dt, _op) in enumerate(spec):
        if dt == "int32":
            t = torch.randint(-2**20, 2**20, (K, 2 * F), generator=gen,
                              dtype=torch.int32)
        else:
            t = torch.randn((K, 2 * F), generator=gen, dtype=torch.float32)
            # a few NaNs: min/max must propagate them as torch does
            t[torch.rand((K, 2 * F), generator=gen) < 0.01] = float("nan")
        trees[f"f{i}"] = t.cuda()
    tvalid = (torch.rand((K, 2 * F), generator=gen) < 0.6).cuda()
    return trees, tvalid


def _clone(trees, tvalid):
    return {k: v.clone() for k, v in trees.items()}, tvalid.clone()


def _time_ms(torch, fn, reps, flush):
    """Median ms of ``fn`` between two CUDA events, the L2 flushed before
    each call: the wrapper (validation, ctypes marshalling) and the
    kernel together."""
    out = []
    for _ in range(reps):
        flush.zero_()
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    out.sort()
    return out[len(out) // 2]


TRACE_TRIES = 5


def _lost_trace(what: str) -> None:
    """``torch.profiler`` has been seen to drop CUDA records on this card,
    whole traces at a time. A time from a partial trace would be wrong, so
    the time is reported as not measured (null); the kernels' results
    are checked by other means (bit-identity, launch counters)."""
    print(f"chip_smoke: {what}: device time not measured", file=sys.stderr,
          flush=True)


def _device_ms(torch, fn, reps, flush, match, per_call):
    """The kernel's device duration per call of ``fn``: the CUDA time of
    every kernel whose name contains ``match``, summed by
    ``torch.profiler`` over ``reps`` calls and divided by ``reps``.
    ``flush`` is zeroed before each call (None: the L2 stays warm). Each
    call launches ``per_call`` such kernels; a trace that lost some of
    them is taken again (up to TRACE_TRIES times), then the time is None
    (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = 0
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and match in e.name]
        seen = len(ev)
        if seen == reps * per_call:
            return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / reps
        time.sleep(0.5)
    _lost_trace(f"torch.profiler saw {seen} of {reps * per_call} CUDA "
                f"kernels named like {match!r}")
    return None


def _share(bound, device_ms):
    return None if device_ms is None else bound / device_ms


def bound_ms(K, F, spec):
    """Least time on the card: leaves [F, 2F) read and internals [1, F)
    written once, each node one 4-byte value per field plus one validity
    byte, over the HBM rate."""
    return K * (2 * F - 1) * (4 * len(spec) + 1) / PEAK_BYTES_PER_S * 1e3


SPECS = {
    "int32_sum": [("int32", "sum")],
    "float32_sum": [("float32", "sum")],
    "minmax_pairs": [("float32", "min"), ("float32", "max"),
                     ("int32", "min"), ("int32", "max")],
}
# (K_cap, F): the main path's two forests first (10,240 keys -> K_cap
# 16,384, and 64 keys, F 32), then forests that move tens of MB (10^5-key
# streams; a long window with a fine slide), then edge and wide-row shapes
# (8 x 65,536 needs several passes)
SHAPES = [(16384, 32), (64, 32), (262144, 32), (16384, 1024), (4, 8),
          (256, 1024), (8, 65536)]
# timed: int32 sum at every shape, four fields at the main path's shape
TIMED = {(K, F, "int32_sum") for K, F in SHAPES} | {(16384, 32,
                                                     "minmax_pairs")}
WARM = {(262144, 32), (16384, 1024)}  # larger than the 50 MB L2
KERNEL_MATCH = "wf_rebuild"  # every kernel of forest_rebuild.cu


def time_rebuild(torch, rebuild, trees, tvalid, comb, spec, flush,
                 per_call, match=KERNEL_MATCH, warm=False):
    """Device and wrapper + kernel times of ``rebuild`` on one forest
    (``per_call`` kernel launches per call), with its bound and bound
    share."""
    K, NN = tvalid.shape
    row = {"bound_ms": bound_ms(K, NN // 2, spec),
           "kernels_per_call": per_call}
    run = lambda: rebuild(trees, tvalid, comb)  # noqa: E731
    row["device_ms"] = _device_ms(torch, run, 30, flush, match, per_call)
    row["bound_share"] = _share(row["bound_ms"], row["device_ms"])
    row["wrapper_ms"] = _time_ms(torch, run, 30, flush)
    if warm:
        row["device_ms_warm"] = _device_ms(torch, run, 30, None, match,
                                           per_call)
        row["bound_share_warm"] = _share(row["bound_ms"],
                                         row["device_ms_warm"])
    return row


def kernel_phase(torch, timed):
    """Each forest of SHAPES x SPECS through the kernel and its plain
    version: bit-identical or fail. ``timed``: only the TIMED forests,
    each also timed (``torch.profiler`` stays out of the process until the
    main path has run, so its tracing cannot slow the main path's
    launches)."""
    from windflow_tpu_torch.combines import fieldwise
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.kernels.reference import forest_rebuild_ref
    gen = torch.Generator().manual_seed(1234 + timed)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    timing = None
    max_err = 0.0
    for K, F in SHAPES:
        for sname, spec in SPECS.items():
            if timed and (K, F, sname) not in TIMED:
                continue
            comb = fieldwise(**{f"f{i}": op for i, (_, op) in
                                enumerate(spec)})
            trees, tvalid = _forest(torch, K, F, spec, gen)
            kt, kv = _clone(trees, tvalid)
            rt, rv = _clone(trees, tvalid)
            fr.forest_rebuild(kt, kv, comb)
            forest_rebuild_ref(rt, rv, comb)
            torch.cuda.synchronize()
            same = torch.equal(kv, rv) and all(
                torch.equal(kt[k].view(torch.int32), rt[k].view(torch.int32))
                for k in kt)
            max_err = max([max_err] + [
                (kt[k].double() - rt[k].double()).abs().nan_to_num(0.0)
                .max().item() for k in kt])  # NaN bits: checked above
            if not same:
                fail(f"forest_rebuild differs from its plain version at "
                     f"K_cap={K} F={F} {sname}")
            plan = fr.launch_plan(K, F, len(spec))
            row = {"K_cap": K, "F": F, "fields": sname, "bit_identical": True,
                   "plan": [[p.regime, p.W, p.S, p.E, p.rows] for p in plan]}
            if timed:
                row.update(time_rebuild(torch, fr.forest_rebuild, kt, kv,
                                        comb, spec, flush, len(plan),
                                        warm=(K, F) in WARM))
                row["plain_ms"] = _time_ms(torch, lambda: forest_rebuild_ref(
                    rt, rv, comb), 10, flush)
                if timing is None:
                    timing = row
            phase("kernel_time" if timed else "kernel_check", **row)
            del trees, tvalid, kt, kv, rt, rv
    del flush
    return timing, max_err


# ---------------------------------------------------------------------------
def _blocks(n_keys, seed, n_batches=N_BATCHES, batch=BATCH):
    """``bench.py``'s staged stream: int32 (key, value) batches, event time
    TS_STEP/AGG_RATE_KEYS us per tuple, watermark advancing every batch."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out, ts0 = [], 0
    for _ in range(n_batches):
        keys = rng.integers(0, n_keys, batch).astype(np.int32)
        vals = rng.integers(0, 100, batch).astype(np.int32)
        ts = ts0 + np.arange(batch, dtype=np.int64) * TS_STEP // AGG_RATE_KEYS
        ts0 = int(ts[-1]) + TS_STEP
        out.append(({"key": keys, "value": vals}, ts,
                    max(0, int(ts[0]) - 1)))
    return out


def _run_graph(wt, device, blocks, n_keys, win_per_batch, prefix=(),
               fusion=True):
    """Columnar source -> [prefix ops, chained ->] Ffat_Windows_GPU ->
    columnar sink; returns the window columns (sorted by key, wid), timing
    marks, the window's replica (a fused chain's replica when the prefix
    fused into it) and the graph."""
    import numpy as np
    t_yield, t_in, t_recv = {}, {}, {}
    parts, lock = [], threading.Lock()

    def source():
        for cols, ts, wm in blocks:
            t_yield[wm] = time.perf_counter()
            yield cols, ts, wm

    def sink(cols, ts):
        if cols is None:
            return
        now = time.perf_counter()
        with lock:
            parts.append({"ts": ts.copy(),
                          **{k: v.copy() for k, v in cols.items()}})
            t_recv[int(ts[0])] = now

    graph = wt.PipeGraph("chip_smoke", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device,
                         fusion=fusion)
    b = (wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                     wt.fieldwise(value="sum"))
         .with_key_by("key").with_tb_windows(WIN_US, SLIDE_US)
         .with_key_capacity(n_keys))
    if win_per_batch:
        b = b.with_num_win_per_batch(win_per_batch)
    op = b.build()
    mp = graph.add_source(wt.Columnar_Source_Builder(source)
                          .with_output_batch_size(BATCH).build())
    for i, pre in enumerate(prefix):
        mp = mp.add(pre) if i == 0 else mp.chain(pre)
    mp = mp.chain(op) if prefix else mp.add(op)
    mp.add_sink(wt.Sink_Builder(sink).with_columns().build())
    graph.get_num_threads()  # builds the replicas
    rep = op.replicas[0]
    prep = rep.prep_device_batch

    def timed_prep(batch):  # the operator starts a batch (fire latency)
        t_in[batch.wm] = time.perf_counter()
        return prep(batch)

    rep.prep_device_batch = timed_prep
    t0 = time.perf_counter()
    graph.run()
    wall = time.perf_counter() - t0
    cols = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    order = np.lexsort((cols["wid"], cols["key"]))
    cols = {k: v[order] for k, v in cols.items()}
    return cols, t_yield, t_in, t_recv, wall, rep, graph


def _check_windows(name, what, got, ref):
    """Window rows equal row for row: every column, values where valid."""
    import numpy as np
    if got.keys() != ref.keys() or len(got["key"]) != len(ref["key"]):
        fail(f"{name}: window rows differ in shape from {what}")
    for k in got:
        if k != "value" and not np.array_equal(got[k], ref[k]):
            fail(f"{name}: column {k!r} differs from {what}")
    valid = got["valid"]
    if not np.array_equal(got["value"][valid], ref["value"][valid]):
        fail(f"{name}: window values differ from {what}")


def _ffat_rates(blocks, run):
    """Rates of one FFAT run after the warm-up: tuples/s and windows/s
    from the yield of batch WARMUP to the delivery of the last batch's
    windows (each window row carries ts == the watermark of the batch that
    fired it), and the fire latency: the operator starts a firing batch ->
    its last window row reaches the sink (the dispatch and D2H pipelines'
    lag included)."""
    import numpy as np
    cols, t_yield, t_in, t_recv = run[:4]
    wms = [wm for _, _, wm in blocks]
    lat = sorted(t_recv[wm] - t_in[wm] for wm in wms[WARMUP:]
                 if wm in t_recv)
    t_end = max(t_recv[wm] for wm in wms if wm in t_recv)
    span = t_end - t_yield[wms[WARMUP]]
    return dict(
        tuples_per_s=(len(blocks) - WARMUP) * BATCH / span,
        windows_per_s=int(np.isin(cols["ts"], wms[WARMUP:]).sum()) / span,
        fire_latency_p50_ms=1e3 * lat[len(lat) // 2],
        fire_latency_p99_ms=1e3 * lat[min(len(lat) - 1,
                                          int(0.99 * len(lat)))],
        firing_batches=sum(wm in t_recv for wm in wms),
        firing_batches_timed=len(lat))


def _launched(name, fr, rep):
    """K1's launch count since the last reset, which the window replica
    must have counted too."""
    launches = fr.LAUNCHES
    if launches == 0 or rep.stats.rebuild_kernel_launches != launches:
        fail(f"{name}: the rebuild kernel did not run on the path "
             f"(wrapper {launches}, replica "
             f"{rep.stats.rebuild_kernel_launches})")
    return launches


def main_path_phase(torch, wt, name, n_keys, win_per_batch):
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    blocks = _blocks(n_keys, seed=7)
    fr.LAUNCHES = 0
    torch.cuda.synchronize()
    run = _run_graph(wt, "cuda", blocks, n_keys, win_per_batch)
    launches = _launched(name, fr, run[5])
    gcols, wall, rep = run[0], run[4], run[5]
    ccols = _run_graph(wt, "cpu", blocks, n_keys, win_per_batch)[0]
    _check_windows(name, "the CPU run", gcols, ccols)
    valid = gcols["valid"]
    if not valid.any() or (gcols["value"][valid] < 0).any():
        fail(f"{name}: no valid windows, or negative sums of values >= 0")
    row = dict(config=name, keys=n_keys, batches=N_BATCHES, batch=BATCH,
               windows_total=int(len(gcols["key"])),
               valid_windows=int(valid.sum()),
               rebuild_launches=launches,
               device_programs=rep.stats.device_programs_run,
               **_ffat_rates(blocks, run), wall_s=wall,
               rows_equal_cpu=True)
    return row, launches


def _prefix(wt, with_filter):
    """The chain in front of the window: the graph_gpu map [and filter]."""
    ops = [wt.Map_GPU_Builder(_map_value).build()]
    if with_filter:
        ops.append(wt.Filter_GPU_Builder(_even_value).build())
    return ops


def fusion_ffat_phase(torch, wt, card):
    """Phase ``fusion`` (a): the high-cardinality stream through ``map ->
    Ffat_Windows_GPU`` and ``map -> filter -> Ffat_Windows_GPU`` built with
    ``chain``, fused (one ``FusedFfatReplica``) and unfused
    (``fusion=False``) on the card in turns (fused, unfused, unfused,
    fused) and fused on the CPU: every run's window rows must be equal row
    for row, and K1 must launch once per firing batch, as often fused as
    unfused. K1's count is reset just before each run and read just after.
    Returns K1's launches in the first fused run of each chain."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    blocks = _blocks(HC_KEYS, seed=7)
    fused_launches = 0
    for with_filter in (False, True):
        name = "map_filter_ffat" if with_filter else "map_ffat"
        ccols = _run_graph(wt, "cpu", blocks, HC_KEYS, None,
                           _prefix(wt, with_filter))[0]
        if not ccols["valid"].any():
            fail(f"fusion {name}: no valid windows")
        row = dict(part="ffat", chain=name, keys=HC_KEYS, batches=N_BATCHES,
                   warmup=WARMUP, batch=BATCH, card=card,
                   windows_total=int(len(ccols["key"])))
        for fusion in (True, False, False, True):
            fr.LAUNCHES = 0
            torch.cuda.synchronize()
            run = _run_graph(wt, "cuda", blocks, HC_KEYS, None,
                             _prefix(wt, with_filter), fusion)
            launches = _launched(f"fusion {name}", fr, run[5])
            _check_windows(f"fusion {name} (fusion={fusion})",
                           "the fused CPU run", run[0], ccols)
            ops = run[6].get_stats()["Operators"]
            if fusion != any(o["kind"] == "Fused_GPU_Chain" for o in ops):
                fail(f"fusion {name}: the chain did not fuse as asked")
            rates = _ffat_rates(blocks, run)
            if launches != rates["firing_batches"]:
                fail(f"fusion {name}: K1 launched {launches} times for "
                     f"{rates['firing_batches']} firing batches")
            programs = sum(r["Device_programs_run"] for o in ops
                           for r in o["replicas"])
            runs = row.setdefault("fused" if fusion else "unfused", [])
            runs.append(dict(**rates, rebuild_launches=launches,
                             programs_per_batch=programs / N_BATCHES,
                             wall_s=run[4]))
            if fusion and len(runs) == 1:
                fused_launches += launches
        row["rows_equal_unfused_and_cpu"] = True
        phase("fusion", **row)
    return fused_launches


# ---------------------------------------------------------------------------
def _map_value(f):
    return {**f, "value": f["value"] * 3 + f["key"]}


def _even_value(f):
    return f["value"] % 2 == 0


def _sum_value(a, b):
    return {"key": b["key"], "value": a["value"] + b["value"]}


def _run_ops_graph(wt, device, blocks, keyed, batch=BATCH, par=GRAPH_PAR,
                   chain=False, fusion=True, megabatch=1):
    """Columnar source -> Map_GPU -> Filter_GPU -> Reduce_GPU (keyed by
    "key" at ``par`` replicas, or global) -> columnar sink, the operators
    joined by ``add`` or, with ``chain``, by ``chain`` (one fused replica
    when ``fusion`` is on). Returns the sink's batches in arrival order as
    (arrival time, columns with ts), the source's yield times and the
    graph."""
    t_yield, parts, lock = [], [], threading.Lock()

    def source():
        for cols, ts, wm in blocks:
            t_yield.append(time.perf_counter())
            yield cols, ts, wm

    def sink(cols, ts):
        if cols is None:
            return
        now = time.perf_counter()
        with lock:
            parts.append((now, {"ts": ts.copy(),
                                **{k: v.copy() for k, v in cols.items()}}))

    red = wt.Reduce_GPU_Builder(_sum_value)
    if keyed:
        red = red.with_key_by("key").with_parallelism(par)
    graph = wt.PipeGraph("graph_gpu", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device,
                         fusion=fusion, megabatch=megabatch)
    mp = graph.add_source(wt.Columnar_Source_Builder(source)
                          .with_output_batch_size(batch).build()) \
        .add(wt.Map_GPU_Builder(_map_value).build())
    join = mp.chain if chain else mp.add
    join(wt.Filter_GPU_Builder(_even_value).build())
    join(red.build())
    mp.add_sink(wt.Sink_Builder(sink).with_columns().build())
    graph.run()
    return parts, t_yield, graph


def _concat(parts):
    import numpy as np
    return {k: np.concatenate([p[k] for _, p in parts]) for k in
            parts[0][1]}


def _sorted_rows(parts):
    return _sort_cols(_concat(parts))


def _sort_cols(c):
    """Columns in (ts, key, value) order: a multiset of rows."""
    import numpy as np
    order = np.lexsort((c["value"], c["key"], c["ts"]))
    return {k: v[order] for k, v in c.items()}


def _fold(blocks):
    """numpy fold of the stream through map and filter: per-key totals and
    the per-batch total."""
    import numpy as np
    tot = np.zeros(GRAPH_KEYS, dtype=np.int64)
    per_batch = []
    for cols, _, _ in blocks:
        v = cols["value"].astype(np.int64) * 3 + cols["key"]
        keep = v % 2 == 0
        np.add.at(tot, cols["key"][keep], v[keep])
        per_batch.append(int(v[keep].sum()))
    return tot, per_batch


def _events(torch, prof):
    """(kernels, copies) recorded on the card by ``prof``."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in dev if not e.name.startswith(("Memcpy",
                                                        "Memset"))]
    return kernels, copies


def _program_ms(torch, fn, reps=30):
    """Device time per call of a multi-kernel program (the CUDA time of
    every kernel it launched, from ``torch.profiler``, over ``reps``
    calls), kernels per call, and the CUDA-event bracket around one call
    (median: host launch time and device time together). A trace whose
    kernel count is no multiple of ``reps`` lost records and is taken
    again (up to TRACE_TRIES times); then device time and kernels per
    call are None (not measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels, _ = _events(torch, prof)
        if kernels and len(kernels) % reps == 0:
            device_ms = (sum(e.time_range.elapsed_us() for e in kernels)
                         / 1e3 / reps)
            launches = len(kernels) // reps
            break
        time.sleep(0.5)
    else:
        _lost_trace(f"torch.profiler lost kernel records ({len(kernels)} "
                    f"for {reps} calls)")
        device_ms = launches = None
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    out.sort()
    return device_ms, launches, out[len(out) // 2]


def programs_phase(torch, wt, blocks, card):
    """K5-K7 (the XLA programs of the JAX package's Filter_TPU, global and
    keyed Reduce_TPU, which have no Pallas kernel) as the port runs them,
    on one batch of the graph_gpu stream, with their bytes bound: each
    input read once, each output written once."""
    import numpy as np
    from types import SimpleNamespace
    from windflow_tpu_torch.gpu import ops_gpu as og
    from windflow_tpu_torch.gpu.batch import BatchGPU, bucket_capacity
    from windflow_tpu_torch.gpu.schema import TupleSchema
    cols, ts, _ = blocks[GRAPH_WARMUP]
    n = len(ts)
    dev = torch.device("cuda")
    fields = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    mapped = _map_value(fields)
    # K5: the filter program on the mapped batch
    out, order, count = og.filter_program(_even_value, mapped, n)
    v = cols["value"].astype(np.int64) * 3 + cols["key"]
    kept = np.flatnonzero(v % 2 == 0)
    if int(count) != len(kept) or not np.array_equal(
            out["key"][:len(kept)].cpu().numpy(), cols["key"][kept]):
        fail("filter program: compaction differs from numpy")
    # K6 and K7 on the compacted batch, as the reduce replicas get it
    m = len(kept)
    kb = dict(out)
    mask = og.row_mask(n, m, dev)
    red = og.masked_tree_reduce(_sum_value, kb, mask)
    if int(red["value"][0]) != int(v[kept].sum()):
        fail("tree reduce differs from numpy")
    batch = BatchGPU(kb, ts, m, TupleSchema({"key": np.int32,
                                            "value": np.int32}),
                     0, cols["key"][kept])
    o_np, ssorted, sok = og.reduce_order_and_slots(
        SimpleNamespace(name="programs", key_field="key"), batch)
    n_out = len(sok)
    out_cap = bucket_capacity(n_out)
    order_d = torch.from_numpy(o_np).to(dev)
    same_d = torch.from_numpy(np.r_[False, ssorted[1:] == ssorted[:-1]]
                              ).to(dev)
    tails_d = torch.from_numpy(og.segment_tails(ssorted, n_out, out_cap)
                               ).to(dev)
    kr = og.keyed_reduce_program(_sum_value, kb, order_d, same_d, tails_d)
    ref = np.zeros(GRAPH_KEYS, dtype=np.int64)
    np.add.at(ref, cols["key"][kept], v[kept])
    got_keys = kr["key"][:n_out].cpu().numpy()
    if not np.array_equal(kr["value"][:n_out].cpu().numpy(),
                          ref[got_keys]) or len(set(got_keys)) != n_out:
        fail("keyed reduce program differs from numpy")
    progs = {
        # inputs 2 int32 columns; outputs 2 compacted columns + order +
        # count
        "K5_compaction": (lambda: og.filter_program(_even_value, mapped, n),
                          8 * n + 12 * n + 8,
                          "windflow_tpu/tpu/ops_tpu.py:58"),
        # inputs: the m kept rows of 2 int32 columns; output one row
        "K6_tree_reduce": (lambda: og.masked_tree_reduce(_sum_value, kb,
                                                         mask),
                           8 * m + 8, "windflow_tpu/tpu/ops_tpu.py:280"),
        # inputs: the m kept rows of 2 columns with their order and
        # segment flags, the tails; outputs one row per key
        "K7_keyed_scan": (lambda: og.keyed_reduce_program(
            _sum_value, kb, order_d, same_d, tails_d),
            8 * m + 4 * m + m + 4 * out_cap + 8 * out_cap,
            "windflow_tpu/tpu/ops_tpu.py:1240"),
    }
    rows = []
    for name, (fn, nbytes, replaces) in progs.items():
        device_ms, launches, bracket_ms = _program_ms(torch, fn)
        bound = nbytes / PEAK_BYTES_PER_S * 1e3
        rows.append(dict(program=name, replaces=replaces, rows=n,
                         kept=m, keys=n_out, device_ms=device_ms,
                         launches=launches, wrapper_ms=bracket_ms,
                         bytes=nbytes, bound_ms=bound, bound_by="bytes",
                         bound_share=_share(bound, device_ms), card=card))
        phase("programs", **rows[-1])
    return rows


def _profiled(torch, run, n_batches):
    """One run of ``run`` under ``torch.profiler``: the wall time, the
    card's busy time (kernels and copies) and idle share, and kernels and
    copies per batch."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    kernels, copies = _events(torch, prof)
    busy = sum(e.time_range.elapsed_us() for e in kernels + copies) / 1e3
    return dict(wall_ms=span * 1e3, device_busy_ms=busy,
                device_idle_share=1.0 - busy / (span * 1e3),
                kernels_per_batch=len(kernels) / n_batches,
                copies_per_batch=len(copies) / n_batches)


def graph_gpu_phase(torch, wt, card):
    """The graph_tests_gpu path on the card: rows equal to the CPU run and
    to a numpy fold, tuples/s, then one profiled run for the device's
    idle share and launches per batch."""
    import numpy as np
    blocks = _blocks(GRAPH_KEYS, seed=9, n_batches=GRAPH_BATCHES)
    tot, per_batch = _fold(blocks)
    row = dict(config="graph_gpu", keys=GRAPH_KEYS, batches=GRAPH_BATCHES,
               warmup=GRAPH_WARMUP, batch=BATCH, reduce_parallelism=GRAPH_PAR,
               card=card)
    for keyed in (True, False):
        name = "keyed" if keyed else "global"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gparts, t_yield, graph = _run_ops_graph(wt, "cuda", blocks, keyed)
        wall = time.perf_counter() - t0
        cparts, *_ = _run_ops_graph(wt, "cpu", blocks, keyed)
        if keyed:
            g, c = _sorted_rows(gparts), _sorted_rows(cparts)
            got = np.zeros(GRAPH_KEYS, dtype=np.int64)
            np.add.at(got, g["key"], g["value"])
            ok = (g.keys() == c.keys()
                  and all(np.array_equal(g[k], c[k]) for k in g)
                  and np.array_equal(got, tot))
        else:
            g, c = _concat(gparts), _concat(cparts)
            ok = (g.keys() == c.keys()
                  and all(np.array_equal(g[k], c[k]) for k in g)
                  and g["value"].tolist() == per_batch)
        if not ok:
            fail(f"graph_gpu {name}: rows on cuda differ from the CPU run "
                 "or from the numpy fold")
        t_end = max(t for t, _ in gparts)
        span = t_end - t_yield[GRAPH_WARMUP]
        ops = graph.get_stats()["Operators"]
        row[name] = dict(rows=int(len(g["key"])), rows_equal_cpu=True,
                         tuples_per_s=(GRAPH_BATCHES - GRAPH_WARMUP) * BATCH
                         / span, wall_s=wall,
                         device_programs=[sum(r["Device_programs_run"]
                                              for r in op["replicas"])
                                          for op in ops[1:4]],
                         filter_ignored=sum(r["Inputs_ignored"] for r in
                                            ops[2]["replicas"]))
    # one more keyed run under the profiler: idle share and launches
    row["profiled_keyed"] = _profiled(
        torch, lambda: _run_ops_graph(wt, "cuda", blocks, True),
        GRAPH_BATCHES)
    phase("graph_gpu", **row)
    # broadcast: keyed staging into two maps, broadcast into two more
    small = _blocks(GRAPH_KEYS, seed=10, n_batches=4, batch=4096)
    res = {}
    for device in ("cuda", "cpu"):
        parts, lock = [], threading.Lock()

        def sink(cols, ts, parts=parts):
            if cols is not None:
                with lock:
                    parts.append((0.0, {"ts": ts.copy(), **{
                        k: v.copy() for k, v in cols.items()}}))

        graph = wt.PipeGraph("broadcast", wt.ExecutionMode.DEFAULT,
                             wt.TimePolicy.EVENT_TIME, device=device)
        graph.add_source(wt.Columnar_Source_Builder(lambda: iter(small))
                         .with_output_batch_size(4096).build()) \
            .add(wt.Map_GPU_Builder(lambda f: {**f, "value": f["value"] + 1})
                 .with_key_by("key").with_parallelism(2).build()) \
            .add(wt.Map_GPU_Builder(lambda f: {**f,
                                               "value": f["value"] * 10})
                 .with_broadcast().with_parallelism(2).build()) \
            .add_sink(wt.Sink_Builder(sink).with_columns().build())
        graph.run()
        res[device] = _sorted_rows(parts)
    g, c = res["cuda"], res["cpu"]
    if not (all(np.array_equal(g[k], c[k]) for k in c)
            and len(g["key"]) == 2 * 4 * 4096):
        fail("broadcast graph: rows on cuda differ from the CPU run")
    phase("graph_gpu_broadcast", rows=int(len(g["key"])),
          rows_equal_cpu=True)
    return row, blocks


def fusion_ops_phase(torch, wt, card):
    """Phase ``fusion`` (b): the graph_gpu stream through ``map -> filter
    -> global Reduce_GPU`` and ``map -> filter -> keyed Reduce_GPU``, built
    with ``chain`` at parallelism 1 and fused, with megabatch 1, 4 and 8,
    and unfused (``fusion=False``), the runs in turns (unfused, 1, 4, 8,
    8, 4, 1, unfused). Every run's rows must equal the unfused CPU run (in
    order for the global reduce: value and ts, the key being the
    non-commutative combine's pick, which follows the fold's pairing; all
    columns against the fused CPU run; as a multiset for the keyed
    reduce) and the numpy fold. One line per megabatch width: tuples/s of
    its two runs and of the unfused runs, host prep and commit ms per
    batch of each stage, the fused replica's Megabatch_* and
    Programs_per_batch, and a profiled run's idle share and launches."""
    import numpy as np
    blocks = _blocks(GRAPH_KEYS, seed=9, n_batches=FUSION_BATCHES)
    tot, per_batch = _fold(blocks)
    timed = (FUSION_BATCHES - GRAPH_WARMUP) * BATCH
    for keyed in (False, True):
        kind = "keyed" if keyed else "global"
        common = dict(blocks=blocks, keyed=keyed, par=1, chain=True)
        ref = _concat(_run_ops_graph(wt, "cpu", fusion=False, **common)[0])
        fcpu = _concat(_run_ops_graph(wt, "cpu", **common)[0])
        rates, stages, fused = {}, {}, {}
        for k in (0, 1, 4, 8, 8, 4, 1, 0):  # 0: unfused
            parts, t_yield, graph = _run_ops_graph(
                wt, "cuda", fusion=k > 0, megabatch=max(1, k), **common)
            g = _concat(parts)
            if keyed:
                gs, cs = _sort_cols(g), _sort_cols(ref)
                got = np.zeros(GRAPH_KEYS, dtype=np.int64)
                np.add.at(got, g["key"], g["value"])
                ok = (gs.keys() == cs.keys()
                      and all(np.array_equal(gs[x], cs[x]) for x in gs)
                      and np.array_equal(got, tot))
            else:
                same = fcpu if k else ref
                ok = (g.keys() == ref.keys()
                      and all(np.array_equal(g[x], ref[x])
                              for x in ("ts", "value"))
                      and all(np.array_equal(g[x], same[x]) for x in g)
                      and g["value"].tolist() == per_batch)
            if not ok:
                fail(f"fusion {kind} megabatch {k}: rows on cuda differ "
                     "from the unfused CPU run or the numpy fold")
            rates.setdefault(k, []).append(
                timed / (max(t for t, _ in parts) - t_yield[GRAPH_WARMUP]))
            ops = graph.get_stats()["Operators"][1:-1]
            stages[k] = {o["name"]: [
                round(r[f"Dispatch_{c}_total_usec"] / 1e3
                      / max(1, r["Dispatch_batches"]), 4)
                for c in ("host_prep", "commit")]
                for o in ops for r in o["replicas"]}
            if k:
                st = ops[0]["replicas"][0]
                if ops[0]["kind"] != "Fused_GPU_Chain" \
                        or st["Fused_ops"] != 3:
                    fail(f"fusion {kind}: the chain did not fuse")
                if k > 1 and st["Megabatch_loops"] == 0:
                    fail(f"fusion {kind} megabatch {k}: no group formed")
                fused[k] = st
        for k in (1, 4, 8):
            st = fused[k]
            phase("fusion", part="ops", reduce=kind, megabatch=k,
                  keys=GRAPH_KEYS, batches=FUSION_BATCHES,
                  warmup=GRAPH_WARMUP, batch=BATCH, card=card,
                  rows=int(len(fcpu["key"])), rows_equal_cpu=True,
                  tuples_per_s=rates[k], unfused_tuples_per_s=rates[0],
                  prep_commit_ms_per_batch=stages[k],
                  unfused_prep_commit_ms_per_batch=stages[0],
                  **{x: st[x] for x in (
                      "Device_programs_run", "Programs_per_batch",
                      "Megabatch_loops", "Megabatch_batches_per_loop_avg",
                      "Megabatch_max", "Inputs_ignored")},
                  profiled=_profiled(
                      torch, lambda: _run_ops_graph(
                          wt, "cuda", megabatch=k, **common),
                      FUSION_BATCHES))


# ---------------------------------------------------------------------------
# phase state: keyed device state (stateful Map_GPU / Filter_GPU, the fused
# kinds smap / sfilter, the hot/cold tier plane)
# ---------------------------------------------------------------------------
def _smap_fn(row, st):
    """bench.py's stateful map (bench.py:1581-1584)."""
    return {**row, "value": row["value"] + st["n"]}, {"n": st["n"] + 1}


def _run_max_fn(row, st):
    """tests/test_tpu_ops.py:205-208: keep values above the key's running
    max."""
    import torch
    keep = row["value"] > st["mx"]
    return keep, {"mx": torch.maximum(st["mx"], row["value"])}


def _tier_fn(row, st):
    """bench.py's run_tiered scan: a float32 running sum per key."""
    return {"k": row["k"], "v": st + row["v"]}, st + row["v"]


def _run_state_graph(wt, device, blocks, make_ops, batch=None, chain=False,
                     fusion=True, megabatch=1):
    """Columnar source -> ``make_ops(wt)`` (joined by ``add``, or with
    ``chain`` by ``chain``) -> columnar sink. Returns the sink's batches in
    arrival order, the source's yield times, the end of ``run()`` and the
    graph."""
    t_yield, parts, lock = [], [], threading.Lock()

    def source():
        for cols, ts, wm in blocks:
            t_yield.append(time.perf_counter())
            yield cols, ts, wm

    def sink(cols, ts):
        if cols is not None:
            with lock:
                parts.append((0.0, {"ts": ts.copy(),
                                    **{k: v.copy() for k, v in cols.items()}}))

    graph = wt.PipeGraph("state", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device,
                         fusion=fusion, megabatch=megabatch)
    mp = graph.add_source(wt.Columnar_Source_Builder(source)
                          .with_output_batch_size(batch or BATCH).build())
    for i, op in enumerate(make_ops(wt)):
        mp = mp.chain(op) if (chain and i) else mp.add(op)
    mp.add_sink(wt.Sink_Builder(sink).with_columns().build())
    graph.run()
    return parts, t_yield, time.perf_counter(), graph


def _arrival_ranks(keys):
    """Each row's rank among the earlier rows of its key (numpy)."""
    import numpy as np
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    start = np.r_[True, sk[1:] != sk[:-1]]
    first = np.flatnonzero(start)[np.cumsum(start) - 1]
    rank = np.empty(len(keys), dtype=np.int64)
    rank[order] = np.arange(len(keys)) - first
    return rank


def _stream(blocks):
    import numpy as np
    return {k: np.concatenate([c[k] for c, _, _ in blocks])
            for k in blocks[0][0]}


def _smap_fold(blocks):
    """numpy fold of the stateful map: value + the key's earlier rows."""
    s = _stream(blocks)
    return (s["value"].astype("int64") + _arrival_ranks(s["key"])).astype(
        s["value"].dtype)


def _run_max_keep(blocks):
    """numpy fold of the running-max predicate: a row passes iff its value
    exceeds every earlier value of its key (and 0)."""
    import numpy as np
    s = _stream(blocks)
    keys, vals = s["key"], s["value"].astype(np.int64)
    order = np.argsort(keys, kind="stable")
    sk, sv = keys[order], vals[order]
    grp = np.cumsum(np.r_[True, sk[1:] != sk[:-1]]) - 1
    off = grp * 1_000  # values < 1,000: the cummax restarts per key
    cm = np.maximum.accumulate(sv + off)
    prev = np.r_[off[0], cm[:-1]]
    prev = np.where(np.r_[True, grp[1:] != grp[:-1]], off, prev)
    keep = np.empty(len(keys), dtype=bool)
    keep[order] = sv + off > prev
    return keep


def _state_rates(run, n_batches, batch):
    """Tuples/s from the yield of the first batch after the warm-up to the
    end of ``run()``."""
    _, t_yield, t_end, _ = run
    return ((n_batches - STATE_WARMUP) * batch
            / (t_end - t_yield[STATE_WARMUP]))


def _state_part(torch, wt, card, name, blocks, make_ops, check, extra=None,
                **kw):
    """One part: the graph on the card and on the CPU (rows equal, and
    ``check`` holds them against the numpy fold), tuples/s after the
    warm-up, then one profiled run on the card."""
    torch.cuda.synchronize()
    grun = _run_state_graph(wt, "cuda", blocks, make_ops, **kw)
    crun = _run_state_graph(wt, "cpu", blocks, make_ops, **kw)
    g, c = _concat(grun[0]), _concat(crun[0])
    if g.keys() != c.keys() or not all(np.array_equal(g[k], c[k])
                                       for k in g):
        fail(f"state {name}: rows on cuda differ from the CPU run")
    if not check(g):
        fail(f"state {name}: rows differ from the numpy fold")
    batch = kw.get("batch", BATCH)
    row = dict(part=name, batches=len(blocks), warmup=STATE_WARMUP,
               batch=batch, card=card, rows=int(len(g["ts"])),
               rows_equal_cpu=True, rows_equal_numpy=True,
               tuples_per_s=_state_rates(grun, len(blocks), batch),
               wall_s=grun[2] - grun[1][0])
    ops = grun[3].get_stats()["Operators"][1:-1]
    row["stages"] = {o["name"]: [round(
        r[f"Dispatch_{c}_total_usec"] / 1e3 / max(1, r["Dispatch_batches"]),
        4) for c in ("host_prep", "commit")]
        for o in ops for r in o["replicas"]}
    if extra is not None:
        row.update(extra(grun[3]))
    row["profiled"] = _profiled(
        torch, lambda: _run_state_graph(wt, "cuda", blocks, make_ops, **kw),
        len(blocks))
    phase("state", **row)
    return grun


def _smap_ops(wt):
    import numpy as np
    return [wt.Map_GPU_Builder(_smap_fn).with_key_by("key")
            .with_state({"n": np.int32(0)}).with_name("smap").build()]


def state_phase(torch, wt, card):
    """Phase ``state``: keyed device state through ``PipeGraph`` on the card
    and on the CPU, each part's rows equal between them and to a numpy
    fold; tuples/s, host prep / commit ms per batch and a profiled run's
    idle share and launches per batch. Parts: ``smap`` (bench.py's
    stateful map, 64 keys), ``smap_hc`` (the same at 10,240 keys, and at
    1,048,576 keys: the table grows to 2^20 rows, the grid's host assembly
    takes its np.unique path), ``sfilter`` (the running-max predicate at
    10,240 keys), ``fused`` (map -> smap -> filter -> keyed reduce at
    parallelism 1, fused at megabatch 1 and 4 and unfused, in turns) and
    ``tiered`` (bench.py's run_tiered: Zipf 1.1 over 10,000,000 keys, a
    1,024-slot hot tier). Returns the smap part's first batch for the K8
    programs row."""
    def smap_check(n_keys_blocks):
        return lambda g: np.array_equal(g["value"], _smap_fold(n_keys_blocks))

    # smap: bench.py's config
    blocks = _blocks(STATE_KEYS, seed=21, n_batches=STATE_BATCHES,
                     batch=BATCH)
    _state_part(torch, wt, card, "smap", blocks, _smap_ops,
                smap_check(blocks), extra=lambda gr: dict(keys=STATE_KEYS))
    # smap_hc: 10,240 keys, then keys uniform over 1,048,576
    for n_keys in (HC_KEYS, HUGE_KEYS):
        hb = _blocks(n_keys, seed=22, n_batches=STATE_BATCHES, batch=BATCH)

        def grown(gr, n_keys=n_keys):
            eng = gr._stages[1].first_op.replicas[0].engine
            if n_keys == HUGE_KEYS and eng.table_capacity != HUGE_KEYS:
                fail(f"state smap_hc: the table holds {eng.table_capacity} "
                     "rows, not 2^20")
            return dict(keys=n_keys, distinct_keys=len(eng.slot_of_key),
                        table_rows=eng.table_capacity)

        _state_part(torch, wt, card, "smap_hc", hb, _smap_ops,
                    smap_check(hb), extra=grown)
    # sfilter: the running max at 10,240 keys
    fb = _blocks(HC_KEYS, seed=23, n_batches=STATE_BATCHES, batch=BATCH)
    keep = _run_max_keep(fb)
    kept = {k: v[keep] for k, v in _stream(fb).items()}
    _state_part(
        torch, wt, card, "sfilter", fb,
        lambda wt: [wt.Filter_GPU_Builder(_run_max_fn).with_key_by("key")
                    .with_state({"mx": np.int32(0)}).with_name("sfilter")
                    .build()],
        lambda g: all(np.array_equal(g[k], kept[k]) for k in kept),
        extra=lambda gr: dict(keys=HC_KEYS, kept=int(keep.sum())))
    state_fused_part(torch, wt, card)
    state_tiered_part(torch, wt, card)
    return blocks


def _fused_state_ops(wt):
    """graph_gpu's map (keyed, so the smap behind it fuses) -> the
    stateful map -> graph_gpu's filter -> keyed reduce."""
    return [wt.Map_GPU_Builder(_map_value).with_key_by("key")
            .with_name("m").build(),
            _smap_ops(wt)[0],
            wt.Filter_GPU_Builder(_even_value).with_name("f").build(),
            wt.Reduce_GPU_Builder(_sum_value).with_key_by("key")
            .with_name("kr").build()]


def state_fused_part(torch, wt, card):
    """Part ``fused``: the graph_gpu stream through map -> smap -> filter
    -> keyed Reduce_GPU at parallelism 1, fused at megabatch 1 and 4 and
    unfused, in turns (1, 4, unfused, unfused, 4, 1); every run's rows
    (a multiset) equal the fused CPU run's and the per-key totals of the
    numpy fold."""
    blocks = _blocks(GRAPH_KEYS, seed=24, n_batches=STATE_BATCHES,
                     batch=BATCH)
    s = _stream(blocks)
    v = s["value"].astype(np.int64) * 3 + s["key"] + _arrival_ranks(s["key"])
    keep = v % 2 == 0
    tot = np.zeros(GRAPH_KEYS, dtype=np.int64)
    np.add.at(tot, s["key"][keep], v[keep])
    common = dict(chain=True)
    ref = _sort_cols(_concat(_run_state_graph(wt, "cpu", blocks,
                                              _fused_state_ops,
                                              **common)[0]))
    row = dict(part="fused", keys=GRAPH_KEYS, batches=STATE_BATCHES,
               warmup=STATE_WARMUP, batch=BATCH, card=card,
               rows=int(len(ref["ts"])), rows_equal_cpu=True,
               rows_equal_numpy=True)
    rates, stages, fused = {}, {}, {}
    for k in (1, 4, 0, 0, 4, 1):  # 0: unfused
        run = _run_state_graph(wt, "cuda", blocks, _fused_state_ops,
                               fusion=k > 0, megabatch=max(1, k), **common)
        g = _sort_cols(_concat(run[0]))
        got = np.zeros(GRAPH_KEYS, dtype=np.int64)
        np.add.at(got, g["key"], g["value"])
        if g.keys() != ref.keys() or not all(
                np.array_equal(g[x], ref[x]) for x in g) \
                or not np.array_equal(got, tot):
            fail(f"state fused megabatch {k}: rows on cuda differ from the "
                 "CPU run or the numpy fold")
        rates.setdefault(k, []).append(_state_rates(run, STATE_BATCHES,
                                                    BATCH))
        ops = run[3].get_stats()["Operators"][1:-1]
        stages[k] = {o["name"]: [
            round(r[f"Dispatch_{c}_total_usec"] / 1e3
                  / max(1, r["Dispatch_batches"]), 4)
            for c in ("host_prep", "commit")]
            for o in ops for r in o["replicas"]}
        if k:
            st = ops[0]["replicas"][0]
            if ops[0]["kind"] != "Fused_GPU_Chain" or st["Fused_ops"] != 4:
                fail("state fused: the chain did not fuse")
            fused[k] = {x: st[x] for x in (
                "Device_programs_run", "Programs_per_batch",
                "Megabatch_loops", "Megabatch_max", "Inputs_ignored")}
    row.update(tuples_per_s={("unfused" if k == 0 else f"megabatch_{k}"): r
                             for k, r in rates.items()},
               prep_commit_ms_per_batch={
                   ("unfused" if k == 0 else f"megabatch_{k}"): v
                   for k, v in stages.items()},
               fused_stats=fused,
               profiled=_profiled(torch, lambda: _run_state_graph(
                   wt, "cuda", blocks, _fused_state_ops, **common),
                   STATE_BATCHES))
    phase("state", **row)


def _tier_blocks():
    """bench.py's run_tiered stream: Zipf 1.1 keys over the key space
    (draws beyond it folded back), values 0..n-1, in 512-row blocks."""
    rng = np.random.default_rng(11)
    keys = ((rng.zipf(1.1, size=TIER_TUPLES) - 1) % TIER_KEY_SPACE).astype(
        np.int32)
    vals = np.arange(TIER_TUPLES, dtype=np.float32)
    return [({"k": keys[i:i + TIER_BATCH], "v": vals[i:i + TIER_BATCH]},
             np.arange(i, min(i + TIER_BATCH, TIER_TUPLES), dtype=np.int64),
             i) for i in range(0, TIER_TUPLES, TIER_BATCH)]


def _tier_ops(tiered, db_dir):
    def make(wt):
        b = (wt.Map_GPU_Builder(_tier_fn).with_state(np.float32(0))
             .with_key_by("k").with_name("scan"))
        if tiered:
            b = b.with_tiering(policy="lru", hot_capacity=TIER_HOT,
                               db_dir=db_dir)
        return [b.build()]
    return make


def state_tiered_part(torch, wt, card):
    """Part ``tiered``: bench.py's run_tiered on the card (hot tier of
    1,024 slots, LRU, the cold tail in sqlite under ``build/``) against the
    port's DENSE run on the CPU: the rows equal in order, and equal to a
    numpy float32 fold per key."""
    blocks = _tier_blocks()
    db_dir = os.path.join(HERE, "build", "tier_db")
    dense = _concat(_run_state_graph(wt, "cpu", blocks,
                                     _tier_ops(False, None),
                                     batch=TIER_BATCH)[0])
    s = _stream(blocks)
    fold = np.empty(TIER_TUPLES, dtype=np.float32)
    order = np.argsort(s["k"], kind="stable")
    bounds = np.flatnonzero(np.r_[True, s["k"][order][1:]
                                  != s["k"][order][:-1], True])
    for a, b in zip(bounds[:-1], bounds[1:]):
        idx = order[a:b]
        fold[idx] = np.add.accumulate(s["v"][idx], dtype=np.float32)
    if not np.array_equal(dense["v"], fold):
        fail("state tiered: the dense CPU run differs from the numpy fold")
    row = dict(part="tiered", key_space=TIER_KEY_SPACE, hot_capacity=TIER_HOT,
               policy="lru", tuples=TIER_TUPLES, batch=TIER_BATCH, card=card)
    for prof in (False, True):
        run = (lambda: _run_state_graph(wt, "cuda", blocks,
                                        _tier_ops(True, db_dir),
                                        batch=TIER_BATCH))
        if prof:
            row["profiled"] = _profiled(torch, run, len(blocks))
            continue
        torch.cuda.synchronize()
        got = run()
        g = _concat(got[0])
        if g.keys() != dense.keys() or not all(
                np.array_equal(g[k], dense[k]) for k in g):
            fail("state tiered: rows on cuda differ from the dense CPU run")
        rep = got[3].get_stats()["Operators"][1]["replicas"][0]
        row.update(rows=int(len(g["ts"])), rows_equal_dense_cpu=True,
                   rows_equal_numpy=True,
                   tuples_per_s=TIER_TUPLES / (got[2] - got[1][0]),
                   distinct_keys=rep["Tier_hot_keys"] + rep["Tier_cold_keys"],
                   **{x: rep[x] for x in (
                       "Tier_promotes", "Tier_demotes", "Tier_miss_rate",
                       "Tier_hot_keys", "Tier_cold_keys",
                       "Tier_promote_usec_total")},
                   prep_commit_ms_per_batch=[round(
                       rep[f"Dispatch_{c}_total_usec"] / 1e3
                       / max(1, rep["Dispatch_batches"]), 4)
                       for c in ("host_prep", "commit")])
        if rep["Tier_demotes"] == 0:
            fail("state tiered: no key was demoted")
    phase("state", **row)


def state_programs_phase(torch, wt, blocks, card):
    """K8 (the JAX package's ``_grid_scan_core``, XLA there, plain torch
    ops here) on one batch of the smap part: device time per call, launches
    per call and the bytes bound (each field read once, the output columns
    written once, the grid arrays read once, the touched table rows read
    and written and their dirty bits written)."""
    from types import SimpleNamespace
    from windflow_tpu_torch.gpu import ops_gpu as og
    cols, ts, _ = blocks[STATE_WARMUP]
    n = len(ts)
    dev = torch.device("cuda")
    op = wt.Map_GPU(_smap_fn, name="k8", key_extractor="key",
                    state_init={"n": np.int32(0)})
    op.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT_TIME, dev)
    op.build_replicas()
    eng = op.replicas[0].engine
    batch = SimpleNamespace(size=n, capacity=n,
                            host_keys=cols["key"].astype(np.int64))
    prog, (M, KB), hargs = eng.prep(batch)
    fields = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    valid = og.row_mask(n, n, dev)
    out = eng.run(prog, fields, valid, hargs)
    want = cols["value"].astype(np.int64) + _arrival_ranks(cols["key"])
    if not np.array_equal(out["value"].cpu().numpy(), want):
        fail("K8 grid scan: outputs differ from the numpy fold")
    touched = int(np.count_nonzero(np.bincount(cols["key"])))
    leaves = 1
    nbytes = (8 * n + 8 * n + 4 * n + 5 * KB
              + 2 * 4 * leaves * touched + touched)
    device_ms, launches, bracket_ms = _program_ms(
        torch, lambda: eng.run(prog, fields, valid, hargs))
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    row = dict(program="K8_grid_scan",
               replaces="windflow_tpu/tpu/ops_tpu.py:212", rows=n,
               keys=touched, M=M, KB=KB, device_ms=device_ms,
               launches=launches,
               launches_per_step=None if launches is None else launches / M,
               wrapper_ms=bracket_ms, bytes=nbytes, bound_ms=bound,
               bound_by="bytes", bound_share=_share(bound, device_ms),
               card=card)
    phase("programs", **row)
    return row


# ---------------------------------------------------------------------------
# phase dag: BASELINE's split_tests_gpu + merge_tests_gpu config
# ---------------------------------------------------------------------------
DAG_BATCHES, DAG_WARMUP = 14, 2


def _route(f):
    """The device-computed branch of a row: its value's parity."""
    return {**f, "branch": f["value"] % 2}


def _triple(f):
    return {**f, "value": f["value"] * 3}


def _not_div3(f):
    return f["value"] % 3 != 0


def _sum_key_branch(a, b):
    return {"key": b["key"], "branch": b["branch"],
            "value": a["value"] + b["value"]}


def _sink_parts():
    """A columnar sink that keeps each batch with its arrival time."""
    parts, lock = [], threading.Lock()

    def sink(cols, ts):
        if cols is not None:
            now = time.perf_counter()
            with lock:
                parts.append((now, {"ts": ts.copy(), **{
                    k: v.copy() for k, v in cols.items()}}))
    return parts, sink


def _timed_source(blocks, t_yield):
    def source():
        for cols, ts, wm in blocks:
            t_yield.append(time.perf_counter())
            yield cols, ts, wm
    return source


def _run_diamond(wt, device, blocks):
    """Columnar source -> Map_GPU (branch = value % 2) -> split on the
    "branch" column -> {Map_GPU value*3, Filter_GPU value % 3 != 0} ->
    merge -> Reduce_GPU keyed by ("key", "branch") at parallelism
    GRAPH_PAR -> columnar sink."""
    t_yield = []
    parts, sink = _sink_parts()
    graph = wt.PipeGraph("dag", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device)
    mp = graph.add_source(wt.Columnar_Source_Builder(
        _timed_source(blocks, t_yield)).with_output_batch_size(BATCH)
        .build())
    mp.add(wt.Map_GPU_Builder(_route).with_name("route").build())
    mp.split("branch", 2)
    b0 = mp.select(0).add(wt.Map_GPU_Builder(_triple).with_name("triple")
                          .build())
    b1 = mp.select(1).add(wt.Filter_GPU_Builder(_not_div3)
                          .with_name("not_div3").build())
    b0.merge(b1).add(wt.Reduce_GPU_Builder(_sum_key_branch)
                     .with_key_by(("key", "branch"))
                     .with_parallelism(GRAPH_PAR).with_name("kb_reduce")
                     .build()) \
        .add_sink(wt.Sink_Builder(sink).with_columns().build())
    graph.run()
    return parts, t_yield, graph


def _diamond_fold(blocks):
    """numpy fold of the diamond: per (key, branch) totals."""
    tot = np.zeros((HC_KEYS, 2), dtype=np.int64)
    for cols, _, _ in blocks:
        v = cols["value"].astype(np.int64)
        even = v % 2 == 0
        np.add.at(tot, (cols["key"][even], 0), 3 * v[even])
        odd = ~even & (v % 3 != 0)
        np.add.at(tot, (cols["key"][odd], 1), v[odd])
    return tot


def _sorted_kb(c):
    order = np.lexsort((c["value"], c["branch"], c["key"], c["ts"]))
    return {k: v[order] for k, v in c.items()}


def _key_halves(blocks):
    """The stream split by key into two sources of half the keys each,
    every block keeping its watermark."""
    halves = ([], [])
    for cols, ts, wm in blocks:
        lo = cols["key"] < HC_KEYS // 2
        for h, m in zip(halves, (lo, ~lo)):
            h.append(({k: v[m] for k, v in cols.items()}, ts[m], wm))
    return halves


def _run_merge_ffat(wt, device, halves):
    """Two columnar sources merged into Ffat_Windows_GPU (the HC config)
    -> columnar sink. Returns the window columns sorted by (key, wid), the
    window replica's K1 accounting (data batches that fired, K1 launches in
    them, and launches of the data-less firings: punctuations and the
    end-of-stream flush), the sink's batches, the sources' yield times,
    the replica and the graph."""
    t_yield = []
    k1 = dict(firing_batches=0, batch_launches=0, dataless_launches=0)
    parts, sink = _sink_parts()
    graph = wt.PipeGraph("dag_merge", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device)
    srcs = [graph.add_source(wt.Columnar_Source_Builder(
        _timed_source(h, t_yield)).with_output_batch_size(BATCH)
        .with_name(f"src_{i}").build()) for i, h in enumerate(halves)]
    op = (wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                      wt.fieldwise(value="sum"))
          .with_key_by("key").with_tb_windows(WIN_US, SLIDE_US)
          .with_key_capacity(HC_KEYS).with_name("ffat").build())
    srcs[0].merge(srcs[1]).add(op) \
        .add_sink(wt.Sink_Builder(sink).with_columns().build())
    graph.get_num_threads()  # builds the replicas
    rep = op.replicas[0]
    commit_step, fire_dataless = rep._commit_step, rep._fire_dataless

    def noted_commit(fields, wm, seg, plan):
        n0 = rep.stats.rebuild_kernel_launches
        commit_step(fields, wm, seg, plan)
        if any(entry is not None for entry in plan):  # this batch fired
            k1["firing_batches"] += 1
            k1["batch_launches"] += rep.stats.rebuild_kernel_launches - n0

    def noted_dataless(frontier, partial):
        n0 = rep.stats.rebuild_kernel_launches
        fire_dataless(frontier, partial)
        k1["dataless_launches"] += rep.stats.rebuild_kernel_launches - n0

    rep._commit_step, rep._fire_dataless = noted_commit, noted_dataless
    graph.run()
    cols = _concat(parts)
    order = np.lexsort((cols["wid"], cols["key"]))
    cols = {k: v[order] for k, v in cols.items()}
    return cols, k1, parts, t_yield, rep, graph


def _dag_rate(n_tuples, t_yield, parts):
    """Tuples/s from the yield of the first block after the warm-up to the
    last delivery."""
    span = max(t for t, _ in parts) - sorted(t_yield)[DAG_WARMUP * len(
        t_yield) // DAG_BATCHES]
    return n_tuples * (DAG_BATCHES - DAG_WARMUP) / DAG_BATCHES / span


def dag_phase(torch, wt, card):
    """Phase ``dag``: BASELINE's ``split_tests_gpu + merge_tests_gpu``
    config at bench.py's sizes (65,536-tuple int32 batches, 10,240 keys,
    2 warm-up and 12 timed batches). Part ``diamond``: a device split on a
    device-computed column, two device branches, their merge into a
    Reduce_GPU keyed by the composite key ("key", "branch") at parallelism
    2; rows on the card equal the CPU run (as a multiset) and a numpy
    fold. Part ``merge_ffat``: two sources of half the keys each merged
    into the HC window; window rows equal the CPU run's, and K1 launches
    once per firing batch. Each part gives tuples/s and a profiled run's
    idle share and launches per batch. Returns K1's launches in the
    merge_ffat run on the card."""
    from windflow_tpu_torch.gpu.emitters_gpu import GPUSplittingEmitter
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    blocks = _blocks(HC_KEYS, seed=31, n_batches=DAG_BATCHES, batch=BATCH)
    n_tuples = DAG_BATCHES * BATCH
    # diamond
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gparts, t_yield, graph = _run_diamond(wt, "cuda", blocks)
    wall = time.perf_counter() - t0
    cparts, *_ = _run_diamond(wt, "cpu", blocks)
    g, c = _sorted_kb(_concat(gparts)), _sorted_kb(_concat(cparts))
    if g.keys() != c.keys() or not all(np.array_equal(g[k], c[k])
                                       for k in g):
        fail("dag diamond: rows on cuda differ from the CPU run")
    got = np.zeros((HC_KEYS, 2), dtype=np.int64)
    np.add.at(got, (g["key"], g["branch"]), g["value"])
    if not np.array_equal(got, _diamond_fold(blocks)):
        fail("dag diamond: per (key, branch) totals differ from the numpy "
             "fold")
    route = graph._stages[1].last_op.replicas[0]
    if not isinstance(route.emitter, GPUSplittingEmitter):
        fail("dag diamond: the split after the device map is not the "
             "device splitting emitter")
    ops = {o["name"]: o for o in graph.get_stats()["Operators"]}
    phase("dag", part="diamond", keys=HC_KEYS, batches=DAG_BATCHES,
          warmup=DAG_WARMUP, batch=BATCH, reduce_parallelism=GRAPH_PAR,
          card=card, rows=int(len(g["ts"])), rows_equal_cpu=True,
          rows_equal_numpy=True,
          branch_rows_in={n: sum(r["Inputs_received"]
                                 for r in ops[n]["replicas"])
                          for n in ("triple", "not_div3", "kb_reduce")},
          split_d2h_bytes=sum(r["Device_bytes_D2H"]
                              for r in ops["route"]["replicas"]),
          # host prep and commit ms a batch of each device stage's replicas
          stages={n: [[round(r[f"Dispatch_{c}_total_usec"] / 1e3
                             / max(1, r["Dispatch_batches"]), 4)
                       for c in ("host_prep", "commit")]
                      for r in ops[n]["replicas"]]
                  for n in ("route", "triple", "not_div3", "kb_reduce")},
          tuples_per_s=_dag_rate(n_tuples, t_yield, gparts), wall_s=wall,
          profiled=_profiled(torch, lambda: _run_diamond(wt, "cuda",
                                                          blocks),
                             DAG_BATCHES))
    # merge_ffat
    halves = _key_halves(blocks)
    fr.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gcols, k1, gparts, t_yield, rep, _ = _run_merge_ffat(wt, "cuda",
                                                        halves)
    wall = time.perf_counter() - t0
    launches = _launched("dag merge_ffat", fr, rep)
    ccols = _run_merge_ffat(wt, "cpu", halves)[0]
    # the firing batches' watermarks (a window row's ts) follow the merge's
    # interleaving: compare the windows, not when they fired
    _check_windows("dag merge_ffat", "the CPU run",
                   {k: v for k, v in gcols.items() if k != "ts"},
                   {k: v for k, v in ccols.items() if k != "ts"})
    if not gcols["valid"].any():
        fail("dag merge_ffat: no valid windows")
    # every data batch that fires rebuilds once; a data-less firing
    # (punctuation, end-of-stream flush) rebuilds only a forest that
    # ingest dirtied after the last firing
    if k1["batch_launches"] != k1["firing_batches"] \
            or not k1["firing_batches"] \
            or launches != k1["batch_launches"] + k1["dataless_launches"]:
        fail(f"dag merge_ffat: K1 launched {launches} times for "
             f"{k1['firing_batches']} firing batches ({k1})")
    phase("dag", part="merge_ffat", keys=HC_KEYS, sources=2,
          batches=DAG_BATCHES, warmup=DAG_WARMUP, batch=BATCH, card=card,
          windows_total=int(len(gcols["key"])),
          valid_windows=int(gcols["valid"].sum()), rows_equal_cpu=True,
          **k1, rebuild_launches=launches,
          tuples_per_s=_dag_rate(n_tuples, t_yield, gparts), wall_s=wall,
          profiled=_profiled(torch, lambda: _run_merge_ffat(wt, "cuda",
                                                             halves),
                             DAG_BATCHES))
    return launches


# ---------------------------------------------------------------------------
# phase recovery: kill and restore on the card
# ---------------------------------------------------------------------------
REC_BATCHES, REC_CKPT_AT, REC_CRASH_AT, REC_EVERY = 24, 8, 16, 4


class _InjectedCrash(Exception):
    """The fault a recovery part injects into its own source."""


class _ReplayBlocks:
    """Replayable block source: pushes one block per step (EVENT_TIME),
    requests a checkpoint after block ``ckpt_at`` or every ``every``
    blocks, and raises before block ``crash_at``. Its position counts the
    blocks pushed, so a restore replays from the snapshot's block;
    ``first`` is the block it pushed first."""

    def __init__(self, blocks, ckpt_at=None, crash_at=None, every=0):
        self.blocks, self.ckpt_at, self.crash_at = blocks, ckpt_at, crash_at
        self.every = every
        self.pos = 0
        self.first = None
        self.t_yield = []

    def __call__(self, shipper):
        while self.pos < len(self.blocks):
            if self.pos == self.crash_at:
                raise _InjectedCrash(f"killed before block {self.pos}")
            cols, ts, wm = self.blocks[self.pos]
            if self.first is None:
                self.first = self.pos
            self.t_yield.append(time.perf_counter())
            shipper.set_next_watermark(wm)
            shipper.push_columns(cols, ts)
            self.pos += 1
            if self.pos == self.ckpt_at or (
                    self.every and self.pos % self.every == 0):
                shipper.request_checkpoint()

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _rec_ops(wt, part):
    if part == "smap":
        return _smap_ops(wt)
    if part == "ffat":
        return [wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                            wt.fieldwise(value="sum"))
                .with_key_by("key").with_tb_windows(WIN_US, SLIDE_US)
                .with_key_capacity(HC_KEYS).with_name("ffat").build()]
    return [wt.Map_GPU_Builder(_map_value).with_key_by("key")
            .with_name("m").build(), _smap_ops(wt)[0],
            wt.Filter_GPU_Builder(_even_value).with_name("f").build()]


def _run_rec_graph(wt, device, part, src, store, restore_from=None,
                   crash=False):
    """Replayable source -> the part's operators (chained for ``fused``)
    -> columnar sink, checkpointing into ``store``. Returns the sink's
    batches, the graph, ``start()``'s duration and the time from
    ``start()`` to the first delivery. With ``crash``, the run must end in
    the source's injected crash (and only in that)."""
    parts, sink = _sink_parts()
    graph = wt.PipeGraph(f"rec_{part}", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device)
    graph.with_checkpointing(store_dir=store)
    mp = graph.add_source(wt.Source_Builder(src).with_name("src")
                          .with_output_batch_size(BATCH).build())
    for i, op in enumerate(_rec_ops(wt, part)):
        mp = mp.chain(op) if (part == "fused" and i) else mp.add(op)
    mp.add_sink(wt.Sink_Builder(sink).with_columns().build())
    t0 = time.perf_counter()
    graph.start(restore_from)
    t_start = time.perf_counter() - t0
    try:
        graph.wait_end()
    except _InjectedCrash:
        if not crash:
            raise
    else:
        if crash:
            fail(f"recovery {part}: the injected crash did not end the run")
    first = min((t for t, _ in parts), default=None)
    return parts, graph, t_start, (None if first is None else first - t0)


def _rec_results(part, parts):
    """An idempotent store of a run's output: window rows by (key, wid)
    for ``ffat``; every other part's output batches by their first ts (a
    batch is emitted whole, so a replayed batch overwrites its twin)."""
    out = {}
    for _, c in parts:
        if part == "ffat":
            for k, w, ok, v in zip(c["key"].tolist(), c["wid"].tolist(),
                                   c["valid"].tolist(),
                                   c["value"].tolist()):
                out[(k, w)] = (ok, v if ok else 0)
        else:
            out[int(c["ts"][0])] = tuple(
                (k, c[k].tobytes()) for k in sorted(c))
    return out


def _ckpt_dir(name):
    import shutil
    d = os.path.join(HERE, "build", "ckpt", name)
    shutil.rmtree(d, ignore_errors=True)
    return d


def _epochs(graph, cuts):
    """Per committed epoch: the cut (barrier at the worker -> ack) of its
    slowest worker, split into the drain of the work in flight and the
    barrier's send, the state capture and the blob write (pickle, sha256,
    fsync), the sum of the cuts over workers, the largest alignment stall,
    the bytes of the epoch's blobs and its commit (manifest + rename)."""
    rows = []
    for h in graph._coordinator.history:
        mine = [c for c in cuts if c[0] == h["ckpt_id"]]
        slow = max(mine, key=lambda c: c[1], default=(0, 0.0, 0.0, 0.0, 0.0))
        rows.append(dict(ckpt_id=h["ckpt_id"], workers_cut=len(mine),
                         cut_ms_max=slow[1],
                         drain_ms=slow[1] - slow[3] - slow[4],
                         capture_ms=slow[3], write_ms=slow[4],
                         cut_ms_sum=sum(c[1] for c in mine),
                         align_stall_us_max=max((c[2] for c in mine),
                                                default=0.0),
                         bytes=h["bytes"], commit_ms=h["commit_s"] * 1e3,
                         trigger_to_commit_ms=h["duration_s"] * 1e3))
    return rows


def recovery_part(torch, wt, card, part, cuts):
    """One part of phase ``recovery``: golden runs on the card and on the
    CPU, a run that checkpoints after block REC_CKPT_AT and dies before
    block REC_CRASH_AT, and its restore; the merged crash + restore output
    must equal both golden runs, and the restore must be one, never a
    fresh start: its source resumes at block REC_CKPT_AT, it emits nothing
    from before that block (``ffat``: no window the checkpoint had fired,
    and fewer K1 launches than the uninterrupted run). Then tuples/s with a checkpoint every
    REC_EVERY blocks and with none, in turns. Returns K1's launches in the
    restored run (``ffat``), else 0."""
    from windflow_tpu_torch.checkpoint import CheckpointStore
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    keys = HC_KEYS
    blocks = _blocks(keys, seed=41, n_batches=REC_BATCHES, batch=BATCH)
    fr.LAUNCHES = 0
    torch.cuda.synchronize()
    gold = _rec_results(part, _run_rec_graph(
        wt, "cuda", part, _ReplayBlocks(blocks), _ckpt_dir(f"{part}_g"))[0])
    gold_launches = fr.LAUNCHES
    gold_cpu = _rec_results(part, _run_rec_graph(
        wt, "cpu", part, _ReplayBlocks(blocks), _ckpt_dir(f"{part}_c"))[0])
    if gold != gold_cpu:
        fail(f"recovery {part}: the card's uninterrupted run differs from "
             "the CPU run")
    store = _ckpt_dir(part)
    crash_parts = _run_rec_graph(
        wt, "cuda", part, _ReplayBlocks(blocks, ckpt_at=REC_CKPT_AT,
                                        crash_at=REC_CRASH_AT),
        store, crash=True)[0]
    st = CheckpointStore(store)
    cid = st.latest()
    if cid is None:
        fail(f"recovery {part}: no checkpoint committed before the crash")
    d = st.checkpoint_dir(cid)
    states = st.load_states(d, st.load_manifest(d))
    if states[("src", 0)]["position"] != REC_CKPT_AT:
        fail(f"recovery {part}: the checkpoint's source position is "
             f"{states[('src', 0)]['position']}, not {REC_CKPT_AT}")
    if part == "fused":
        head = states[("m", 0)]
        subs = head.get("fused_sub_states") or []
        if head.get("__fused__") != ["m", "smap", "f"] or len(subs) != 3 \
                or subs[1] is None or subs[0] is not None:
            fail("recovery fused: the blob does not carry the fused "
                 "signature and one positional sub-state per sub-op")
    fr.LAUNCHES = 0
    torch.cuda.synchronize()
    rsrc = _ReplayBlocks(blocks)
    rparts, rgraph, start_s, first_s = _run_rec_graph(
        wt, "cuda", part, rsrc, store, restore_from=store)
    if rsrc.first != REC_CKPT_AT:
        fail(f"recovery {part}: the restored source began at block "
             f"{rsrc.first}, not at the checkpoint's {REC_CKPT_AT}")
    restored = _rec_results(part, rparts)
    if not restored:
        fail(f"recovery {part}: the restored run emitted nothing")
    launches = 0
    if part == "ffat":
        launches = _launched("recovery ffat", fr,
                             rgraph._stages[1].first_op.replicas[0])
        if launches >= gold_launches:
            fail(f"recovery ffat: the restored run launched K1 {launches} "
                 f"times, the uninterrupted run {gold_launches}")
        ff = states[("ffat", 0)]["ffat"]
        fired = {int(k): int(ff["fired"][s])
                 for k, s in ff["slot_of_key"].items()}
        again = sum(w < fired.get(k, 0) for k, w in restored)
        if not any(fired.values()) or again:
            fail(f"recovery ffat: the checkpoint fired "
                 f"{sum(fired.values())} windows, and the restored run "
                 f"fired {again} of them again")
    elif min(restored) < int(blocks[REC_CKPT_AT][1][0]):
        fail(f"recovery {part}: the restored run emitted a batch from "
             f"before block {REC_CKPT_AT}")
    merged = {**_rec_results(part, crash_parts), **restored}
    if merged != gold:
        fail(f"recovery {part}: the crash + restore output differs from "
             "the uninterrupted run")
    # tuples/s with a checkpoint every REC_EVERY blocks and without, in
    # turns; each epoch's cut, bytes, stall and commit from the first
    # checkpointing run
    runs, epochs = {"every": [], "none": []}, None
    for every in (0, REC_EVERY, REC_EVERY, 0):
        src = _ReplayBlocks(blocks, every=every)
        cuts.clear()
        torch.cuda.synchronize()
        p, g, _, _ = _run_rec_graph(wt, "cuda", part, src,
                                    _ckpt_dir(f"{part}_r"))
        span = max(t for t, _ in p) - src.t_yield[STATE_WARMUP]
        runs["every" if every else "none"].append(
            (REC_BATCHES - STATE_WARMUP) * BATCH / span)
        if every and epochs is None:
            epochs = _epochs(g, list(cuts))
            if len(epochs) != REC_BATCHES // REC_EVERY:
                fail(f"recovery {part}: {len(epochs)} epochs committed, "
                     f"not {REC_BATCHES // REC_EVERY}")
    phase("recovery", part=part, keys=keys, batches=REC_BATCHES,
          batch=BATCH, checkpoint_at=REC_CKPT_AT, crash_at=REC_CRASH_AT,
          card=card, merged_equal_card=True, merged_equal_cpu=True,
          restored_checkpoint=cid,
          blob_bytes=sum(os.path.getsize(os.path.join(d, f))
                         for f in st.load_manifest(d)["blobs"]),
          restore_start_ms=start_s * 1e3,
          restore_ms=None if first_s is None else first_s * 1e3,
          rebuild_launches_restored=launches,
          rebuild_launches_uninterrupted=(gold_launches if part == "ffat"
                                          else 0),
          tuples_per_s_every_4=runs["every"], tuples_per_s_none=runs["none"],
          epochs=epochs)
    return launches


def recovery_phase(torch, wt, card):
    """Phase ``recovery``: kill and restore on the card, parts ``smap``
    (bench.py's stateful map at 10,240 keys), ``ffat`` (the HC main path)
    and ``fused`` (map -> smap -> filter chained, fusion on). The cut of
    each worker is timed around ``Worker.checkpoint_now`` (barrier at the
    worker -> ack), its capture around ``Worker._capture_blobs`` and its
    blob write around ``CheckpointCoordinator.ack``, on the worker's own
    thread. Returns K1's launches in the ``ffat`` restored run."""
    from windflow_tpu_torch.checkpoint import CheckpointCoordinator as Coord
    from windflow_tpu_torch.runtime import worker as wmod
    cuts, tl = [], threading.local()
    orig = (wmod.Worker.checkpoint_now, wmod.Worker._capture_blobs,
            Coord.ack)

    def timer(fn, slot):
        def timed_fn(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                setattr(tl, slot, getattr(tl, slot, 0.0)
                        + (time.perf_counter() - t0) * 1e3)
        return timed_fn

    def timed_cut(self, barrier, stall_us=0.0):
        tl.capture = tl.write = 0.0
        t0 = time.perf_counter()
        orig[0](self, barrier, stall_us)
        cuts.append((barrier.ckpt_id, (time.perf_counter() - t0) * 1e3,
                     stall_us, tl.capture, tl.write))

    wmod.Worker.checkpoint_now = timed_cut
    wmod.Worker._capture_blobs = timer(orig[1], "capture")
    Coord.ack = timer(orig[2], "write")
    try:
        return sum(recovery_part(torch, wt, card, part, cuts)
                   for part in ("smap", "ffat", "fused"))
    finally:
        (wmod.Worker.checkpoint_now, wmod.Worker._capture_blobs,
         Coord.ack) = orig


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    if not os.path.isdir(os.path.join(HERE, "windflow_tpu_torch")):
        fail("the windflow_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, HERE)
    import windflow_tpu_torch as wt
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card, name = device_phase(torch)
    build_phase()
    _, err_checks = kernel_phase(torch, timed=False)
    hc, hc_launches = main_path_phase(torch, wt, "high_cardinality",
                                      HC_KEYS, None)
    phase("main_path", **hc)
    base, base_launches = main_path_phase(torch, wt, "64_keys", 64, 128)
    phase("main_path", **base)
    # before any torch.profiler use: its tracing slows later FFAT runs
    fusion_launches = fusion_ffat_phase(torch, wt, card)
    _, graph_blocks = graph_gpu_phase(torch, wt, card)
    fusion_ops_phase(torch, wt, card)
    programs_phase(torch, wt, graph_blocks, card)
    timing, err_timed = kernel_phase(torch, timed=True)
    # last: its profiled runs trace hundreds of thousands of launches,
    # after which torch.profiler has been seen to lose K1's records
    smap_blocks = state_phase(torch, wt, card)
    state_programs_phase(torch, wt, smap_blocks, card)
    dag_launches = dag_phase(torch, wt, card)
    recovery_launches = recovery_phase(torch, wt, card)
    print(json.dumps({"kernels": [{
        "name": "forest_rebuild",
        "route": "cuda",
        "source": "windflow_tpu_torch/kernels/forest_rebuild.cu",
        "replaces": "windflow_tpu/tpu/pallas_kernels.py:29",
        "launches": (hc_launches + base_launches + fusion_launches
                     + dag_launches + recovery_launches),
        "max_abs_err": max(err_checks, err_timed),
        "ms": timing["wrapper_ms"],
        "device_ms": timing["device_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": "bytes",
        "bound_share": timing["bound_share"],
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
