"""Chip smoke test of the PyTorch/CUDA port (``windflow_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, one card

Phases, each printing one line of its own:

1. device: the card's name and power limit (``nvidia-smi``) and
   ``torch.cuda.get_device_name``;
2. build: compiles the hand-written kernels from the sources in this
   checkout (``nvcc`` for sm_90a, one process per library, all started
   together): K1's fieldwise library (``windflow_tpu_torch/kernels/
   forest_rebuild.cu``) and one library per traced combine below (its
   policy generated from the trace, built against ``forest_rebuild.cuh``),
   each library with the FFAT step's kernels over the same policy
   (``ffat_step.cuh``: K2+K3, the segmented fold with the leaf merge, and
   K4, the window query with eviction) and the reduce folds' kernels
   (``reduce_fold.cuh``: K7, the keyed fold, and K6, the masked tree),
   one library per reduce combine the graphs below run (the graph's and
   the diamond's sums share one) and a float32 one, and K8's library
   (the keyed grid scan, ``grid_scan.cuh``) of each stateful step the
   graphs below run
   (the stateful map, the running-max filter, the tiered float32 scan:
   the step traced and compiled in; and a step reading 64 columns, the
   most a step may read), and lists each kernel's
   registers, stack frame and spill bytes (``-Xptxas -v``); a stack
   frame or a spilled byte in any library fails the phase (and, at the
   end, in any K8 library a run built later);
3. kernel checks: each kernel against its plain PyTorch version on CUDA
   tensors at the main path's shapes (and YSB's 128 x 32), two shapes
   that move tens of MB and a few edge shapes (1% of float values NaN):
   the fieldwise combines and the traced ones (``ysb_last``, the example's
   YSB combine; ``mean_last``, cross-field int and float; ``argmax_ts``, a
   where on a comparison; ``flags``, a bool plane; ``wide``, 12 fields;
   ``scaled``, a division by a constant); results must be bit-identical
   (``kernel_check`` lines, with the variant and the launch plan);
4. main path, high cardinality (``bench.py``'s HC config: 10,240 keys,
   TB window 100 ms / slide 25 ms, 65,536-tuple int32 batches, watermark
   advancing every batch, ``fieldwise(value="sum")``) through
   ``PipeGraph`` on ``cuda``; the same stream through the port on the CPU
   must give identical window rows; the rebuild kernel must have run.
   Part ``combine``: the traced combines through ``Ffat_Windows_GPU``,
   ``mean_last`` on the HC stream (4 warm-up + 8 timed batches) and the
   others at 64 keys (6 batches), against the port's CPU run (ints and
   bools exact, floats within 1e-6 relative, the largest difference
   printed); each variant must launch once per firing batch; tuples/s;
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
   ``torch.profiler`` the device's idle share and launches per batch;
   every reduce run on the card must launch its kernel (K7 keyed, K6
   global: ``reduce_fold``'s counts, set to 0 just before each run and
   read just after, as in the ``fusion`` part ``ops``, ``state`` part
   ``fused``, ``dag`` part ``diamond`` and the ``mesh`` Reduce_Mesh
   runs). The ``programs`` lines give K5's (the compaction, plain torch
   ops) device time, launches and bytes bound at 65,536 rows beside
   ``torch.argsort(~keep, stable=True)``; then K7 and K6 (hand kernels)
   against their plain versions on the graph_gpu batch as the reduce
   replicas get it (the kept rows first), as the fused exits get it (the
   filter's mask as ``valid``), on a mesh group's lanes (a quarter on the
   sentinel) and on stress layouts (one run, every row invalid, 65,536
   keys, float32, half of ``valid`` out, runs ending on tile edges, an
   int64 and a 2-D column passing through, the diamond's combine, runs at
   K7's regimes' edges, long runs split over many chunk blocks beside
   slots of no run), K6 in the unfused global reduce's ``size`` form on
   the graph_gpu batch, also at 65,537, 40,000 and 100 rows and at
   ragged sizes and size 1: K6 bit-identical, K7 exact on ints and bools
   and within STEP_FOLD_RTOL on floats, each row with K7's slots by
   regime or K6's stages; a K7 launch between two K2+K3 launches on one
   stream, each exact; for the timed layouts the kernel's device time,
   launches and event bracket, the plain version's bracket, the bytes
   bound (only the rows a kernel must move: K7 the live rows' slots and
   order, the valid live rows' planes, the slots' starts; K6 every row's
   validity under a mask, the valid rows' planes) and for the int sums
   the library call (``index_add_`` into the slot buffer, ``torch.sum`` of
   the kept rows). Before them, phase ``fusion``, part ``ops``: the
   same stream (24 timed batches) through ``map -> filter -> global /
   keyed Reduce_GPU`` built with ``chain`` at parallelism 1, fused (one
   replica) at megabatch 1, 4 and 8 and unfused, in turns; rows must
   equal the unfused CPU run and the numpy fold; one line per megabatch
   width gives tuples/s fused and unfused, host prep and commit ms per
   batch of each stage, Megabatch_*, Programs_per_batch and a profiled
   run's idle share and launches per batch;
7. kernel times (``kernel_time`` lines), after the main path so that the
   profiler's tracing cannot touch it: the timed forests (int32 sums at
   every shape, four fields and every traced combine at 16,384 x 32,
   ``ysb_last`` at YSB's 128 x 32) checked again,
   then the kernel's device duration (``device_ms``: its CUDA time by
   name from ``torch.profiler`` over 30 calls, divided by 30), the event
   bracket around the whole wrapper (``wrapper_ms``: wrapper + kernel,
   median of 30), both with the L2 flushed before each call (and warm at
   the two shapes larger than the L2), the plain version's time, the
   memory bound (``bound_ms``: every plane's bytes, a bool plane one a
   node, and the validity byte) and ``bound_share`` = bound_ms /
   device_ms (``device_ms`` and ``bound_share`` are null when
   ``torch.profiler`` lost the kernel's records in every trace: the
   card's profiler has been seen to drop whole traces); then the
   ``programs`` lines of K2+K3 and K4 for each variant a main path runs
   (the fieldwise sum, ``ysb_last``, ``mean_last``, ``argmax_ts``,
   ``flags``, ``wide``) on the batches of ``STEP_LAYOUTS``: the HC batch
   (65,536 rows into K_cap 16,384 x F 32, 1% on the sentinel), the
   64-key path's (64 x 32), YSB's (4,096 rows into 128 x 32, two thirds
   on the sentinel), and layouts that stress K2+K3's tiles (one run over
   the batch, runs ending on tile edges, a 10,000-row run, every row
   late, 65,537 rows: a last tile part empty), after K2+K3 launches of
   several lengths and widths back to back on one stream
   (``STEP_BACK_TO_BACK``, each exact); K4 after the main paths' batches (W_step 64 and W_cap 8,192
   lanes at HC, 128 on the small forests) and on a 256 x 1,024 ring
   with windows of up to F panes: the kernel against its plain version
   (K2+K3 exact on int and bool planes, floats within 1e-5 relative; K4
   bit-identical, the evicted forest included); for the fieldwise sum
   on every layout, and for each other variant on its own path's batch,
   the kernel's device time, launches and event bracket, the
   plain version's event bracket, the bytes bound, and for the fieldwise
   sum ``scatter_reduce_``'s time
   (after K1's times: the plain versions' traces made the profiler lose
   K1's records); then part ``profiled``
   of phase ``main_path``: 10 batches of each main path under
   ``torch.profiler``, kernels and copies a batch and the idle share;
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
   gives tuples/s, host prep / commit ms per batch, K8's launches (every
   run on the card must launch it) and a profiled run's idle share and
   launches per batch; then the ``programs`` lines of K8 (the keyed grid
   scan, a hand kernel with the step compiled in: a thread a key of
   fewer than ``grid_scan.HEAVY_ROWS`` rows, a block staging a longer
   key's rows through shared memory while one thread walks them)
   against its plain version (``grid_scan_core``, M steps of
   ``torch.func.vmap``), bit for bit on the rows ``valid`` admits, the
   table and the dirty bitmap, at the layouts ``smap`` (64 keys, ~1,024
   rows each), ``hc`` (10,240 keys), ``huge`` (keys over 2^20, a 2^20-row
   table), ``zipf`` (the tiered float32 scan over a Zipf 1.1 batch of
   8,192 rows on a fresh table: the straggler), ``tier`` (the part
   ``tiered`` layout: a 512-row block on the 1,024-slot hot tier after 40
   blocks ran through it), ``holes`` (a fused ``valid`` with holes),
   ``sfilter``, ``mesh_4x2`` (one Map_Mesh step), ``edges`` (runs at
   the regimes' threshold and tile edges) and ``wide`` (the 64-column
   step): device time, launches and event bracket of each, the longest
   run, the keys in each regime, ns a row on the longest run, the bytes
   bound and, beside it, the chain bound (the longest run at
   ``K8_CHAIN_CYCLES`` cycles a row at the card's maximum SM clock: a
   floor of this design, which walks each key's rows in order, not of
   the function, whose exact int32 steps a parallel scan could take);
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
11. incremental and asynchronous checkpoints (``delta`` lines), parts
   ``smap_hc`` (the stateful map at 1,048,576 keys, 24 batches: the
   table grows to 2^20 rows), ``ffat`` (the HC main path),
   ``ffat_tumbling`` (the HC stream into a 320 ms tumbling window, longer
   than the checkpoint interval: epochs without a firing take the FFAT
   delta path), ``fused`` (map -> smap -> filter chained at megabatch 4)
   and ``tiered``
   (bench.py's run_tiered stream, 512-tuple batches): a checkpoint every
   4 batches with ``full_every=8``, in three modes in turns (FULL sync,
   delta sync, delta + async), whose outputs must be equal and equal the
   CPU run's; every epoch of a delta mode, materialized, holds the
   engine state of the FULL run's epoch (smap_hc and both ffat parts).
   Per mode: tuples/s, the FULL and delta epoch counts, the
   ``Checkpoint_delta_*`` / ``_async_uploads`` / ``_upload_usec_total``
   stats and, per epoch, its kind, its bytes (pickled, and on disk), the
   slowest worker's cut split into drain, capture and write (sync) or
   register (async), the upload and the commit ms. Then a delta + async
   run killed two batches after its first delta epoch and restored from
   it (chain depth 1): the merged output must equal the uninterrupted
   runs on the card and the CPU, the source must resume at the
   checkpoint's batch and emit nothing from before it, and (both ffat
   parts) K1 must launch fewer times than uninterrupted. The main-path
   lines give the staging pool's hits and misses;
12. live rescale (``rescale`` lines), part ``ffat`` (the HC main path, the
   window at parallelism 1, rescaled live to 2 before block 8 and back to
   1 before block 16) and part ``smap_hc`` (the stateful map at 1,048,576
   keys, 16 blocks, 2 -> 4 before block 8): the uninterrupted and the
   rescaled runs on the card in turns, and the uninterrupted run on the
   CPU; the rescaled output must equal both (window rows by (key, wid),
   none twice; the map's rows as a multiset, and the numpy fold), and
   K1 must launch on each new replica that holds keys. Per rescale: the
   report's ``checkpoint_s`` / ``pause_s`` / ``total_s`` and the pause's
   split (checkpoint load, host repartition, teardown, rebuild, restore:
   the H2D copies into the new replicas); tuples/s with and without it;
13. supervision (``supervise`` lines): parts ``ffat`` (HC) and ``smap``
   (10,240 keys) under ``with_supervision``, a checkpoint every 4 blocks,
   the source raising once before block 16: one restart, the distinct
   output equal to the uninterrupted run on the card and the CPU, and the
   detection -> resume time; part ``poison``: one 65,536-row batch
   through a DEAD_LETTER-guarded Map_GPU whose function raises on one
   row: exactly one dead letter, every other row mapped exactly, and the
   bisection's commits and host time against a clean batch's;
14. the mesh plane (``mesh`` lines) with 8 virtual shards
   (``ensure_virtual_devices(8)``), first on one group (every shard
   stacked on ``cuda:0``), then on card groups
   (``ensure_virtual_devices(8, group_devices=...)``: 2 and 4 groups of
   ``cuda:0``, where every copy between groups stays on the one card;
   with two cards or more, also a group on each of 2, 4 or 8 cards):
   part ``ffat``, the HC stream (2 warm-up + 6 timed batches) through
   ``Ffat_Windows_Mesh`` at mesh shapes (8, 1) and (4, 2), and
   ``scripts/bench_mesh.py``'s config (64 keys,
   16,384-tuple batches) at (4, 2), then both at (4, 2) over each group
   layout: rows equal the CPU run at the same shape (int32 sums: exact)
   and equal across shapes and layouts, K1 once per step on each group
   holding forest rows; part ``ops``, Map_Mesh (the stateful smap at
   10,240 keys) and Reduce_Mesh (graph_gpu's map -> filter -> keyed
   reduce at 256 keys) at (4, 2) and (1, 1) and at (4, 2) over 4 groups
   (and over the cards), rows equal the CPU run and the single-card
   Map_GPU / Reduce_GPU; part ``restore``, the HC mesh window
   checkpointed at (4, 2) after block 8, killed before block 16 and
   restored onto (2, 4) (output equal to the uninterrupted run, no fired
   window fires again); part ``degrade``, the same graph supervised with
   a device probe that reports 4 of the 8 virtual devices dead, on one
   group and on two (where the dead devices are the whole second group):
   it recovers on 4 shards (one group), re-expands to 8 in one planned
   restart when the probe clears them, and its distinct output equals
   the uninterrupted run. Each line gives ``cards`` and ``groups`` (and
   whether the copies between groups crossed cards), tuples/s (and
   windows/s), ``Mesh_steps``, ``Mesh_shuffle_bytes``,
   ``Mesh_shard_skew``, K1's launches, the bytes copied between groups a
   step, a profiled run's idle share and kernels a batch and, for
   restore / degrade, the restore time or the MTTR of each restart;
15. BASELINE's Yahoo Streaming Benchmark (``ysb`` lines) as
   ``examples/ysb.py`` builds it: 100 campaigns x 10 ads, events typed
   i % 3, 100 us of event time apart, in an in-process Kafka broker
   (``memory://``, 8 partitions, filled once; each part reads it under a
   consumer group of its own) read by a Kafka_Source at parallelism 2
   with 4,096-row output batches, 10 s tumbling windows per campaign.
   Part ``device``: Kafka rows -> Filter_GPU (views) -> Map_GPU (ad ->
   campaign) -> Ffat_Windows_GPU (``with_key_capacity(100)``,
   ``with_num_win_per_batch(32)``, the example's own combine ``count: a +
   b, last_ing: b``) -> columnar sink over 1,000,000 events; every
   (campaign, window) count equals the example's closed-form model and
   the port's CPU run, and each window's ``last_ing`` is an ingest stamp
   the source shipped for that (campaign, window); events/s, p50 / p99
   latency (source ingest -> window emit, from the ``last_ing`` the
   example's combine keeps: the later side's, a traced variant of K1),
   K1's launches and a profiled run's idle share. Part ``paced``: the same chain at
   half the device part's rate over 300,000 events (latency at a rate).
   Part ``blocks``: the chain fed by ``with_columnar_blocks(4096)``
   (counts equal the row-fed run's). Part ``host``: the example's CPU
   variant (host Filter / Map -> host Ffat_Windows with its own
   latest-ingest combine) over the first 100,000 events (per-tuple
   Python: one window a campaign); counts equal the model and the paced
   run's. Part ``win``: BASELINE's win_tests shape on the host plane at
   1,000 keys x 60 tuples: Keyed_Windows CB and TB, Paned_Windows and
   MapReduce_Windows
   TB, Interval_Join KP and DP (100 keys x 200 tuples a stream), each in
   DEFAULT and DETERMINISTIC, rows equal to a numpy model (and one
   Keyed_Windows replica's rows in the model's order in DETERMINISTIC);
   Keyed_Windows TB in PROBABILISTIC over a disordered stream, every
   tuple admitted or dropped; tuples/s for each;
16. exactly-once delivery (``exactly_once`` lines). Part ``columnar``: the
   high-cardinality main path from a replayable block source
   (``ArrayBlockSource`` yielding each batch's watermark,
   ``with_block_size(65536)``, an int32 ``with_schema``) through
   Ffat_Windows_GPU into a columnar sink, checkpointing every 4 batches:
   the plain sink and ``with_exactly_once`` in turns, then an
   exactly-once run killed before batch 14 (after the checkpoint at batch
   12) and ``run(restore_from=...)``; the committed segments of the
   restored run equal the uninterrupted exactly-once run's, the plain
   run's rows and the CPU run, no (key, wid) committed twice, K1 on every
   leg; tuples/s of both sinks, ``Sink_txn_*``, mean pre-commit / commit
   ms and staged bytes per epoch. Part ``kafka``: YSB's device chain fed
   by ``with_columnar_blocks(4096)`` into a Kafka sink on an output topic,
   a checkpoint every 2 s, one plain and one ``with_exactly_once`` run,
   then an exactly-once run killed after its first committed epoch and
   restored: the topic holds each of the 1,000 campaign-windows once with
   the model's count, and the crashed run's prepared epochs never become
   visible. Part ``kafka_client``: the real-broker adapters on
   ``localhost:9092`` over in-process fake client modules
   (``tests/torch_kafka_clients.py``, put in ``sys.modules`` for the part
   only; the part fails if a real ``confluent_kafka`` or ``kafka`` is
   importable): YSB's rows (200,000 events, 8 partitions, two source
   replicas) through the device chain into a Kafka sink, through the
   confluent_kafka adapter with 3 transient poll errors (healed by
   ``with_retries``: ``Kafka_reconnects`` == 3), then into the staged
   exactly-once sink, then an exactly-once run killed after its first
   Kafka transaction and restored (the crashed run's producer fenced, no
   staged epoch left), then through the kafka-python adapter; a
   read_committed view of each output topic holds every campaign-window
   once with the model's count. Part ``replay``: ``bench.py``'s replay mode (Zipf 1.1 over
   512 keys, a diurnal rate curve, 5% late tuples, 512-row blocks, TB
   Keyed_Windows, a checkpoint every 2 s) at-least-once and exactly-once;
   the exactly-once run's committed windows equal the CPU run of the
   blocks its source recorded (host operators only: no device work).
   Part ``persistent``: P_Map (a running per-key sum) and P_Keyed_Windows
   (CB 13/5) at 10,240 keys over 100,000 tuples with a 1,024-entry LRU
   cache, rows equal to a numpy fold; an exactly-once P_Sink killed and
   restored ends with the uninterrupted run's database;
17. the native runtime, the monitoring plane, the overload governor,
   prewarm and the compile cache (``observe`` lines). Part ``native``:
   YSB's rows into the device chain (1,000,000 events) with the staging
   encoders on, then off (counts equal the model every run; the encoders
   filled every staged batch, or none), events/s each; then the HC main
   path on the C++ channel ring against the Python channels (equal rows,
   tuples/s).
   Part ``tracing``: the HC main path traced at 1/64 (source, window,
   sink) against untraced, in turns (equal rows; tuples/s; a device
   window's rows carry no trace stamps, as in the JAX package), the HC
   stream through a traced Map_GPU (the sink's e2e p50 / p99 / max), and
   one traced run under ``torch.profiler``
   recording every thread: the ``wf:prep:`` and ``wf:commit:`` spans are
   there and every K1 launch lies in a commit span. Part ``flightrec``:
   the HC run's ``dump_trace`` is a valid Chrome trace (span counts,
   dropped events); a supervised HC graph whose map blocks 3 s once,
   with a 1 s stall watchdog, is restarted, its distinct rows equal to
   the uninterrupted run's (block -> resumed time). Part ``monitor``: a
   MonitoringServer on 127.0.0.1 takes the HC run's reports; ``/json``
   names the graph, ``/metrics`` parses as Prometheus text, ``/doctor``
   gives a verdict. Part ``overload``: YSB's rows paced at twice the
   native part's rate under ``with_slo(max(1 s, 2 x the ysb paced
   p99))``, then 20,000 of them at an eighth of the native part's rate
   under a 0.5 us SLO, which the governor's queue-delay reading
   exceeds, so that run must shed: in each, offered == admitted + shed,
   one shed-log line per shed record, counts equal the model over the
   events not shed; the rungs, ``Shed_records``, the governor's readings
   and the last 5 s's p99 against the SLO. Part
   ``prewarm``: the HC run with and without ``with_prewarm()``: equal
   rows, the report, K1 loaded before batch 0, the first batch's
   latency. Part ``compile_cache``: two fresh Python processes, one after
   the other, run the HC stream (4 batches) with the traced ``mean_last``
   combine under ``with_compile_cache`` of one directory, empty before
   the first: the first builds K1's variant there (``nvcc``; its build
   seconds), the second loads it without a build (``:cached``); rows
   equal across the two and to the CPU run; each one's first-batch
   latency and ``Compile_usec_total``;

then the ``{"kernels": [...]}`` line (one entry per K1 variant a main
path ran: the fieldwise library and each traced combine but ``scaled``,
which no window runs: it is not associative; then ``ffat_ingest`` (K2+K3)
and ``ffat_query`` (K4) per variant, their launches summed over every
main-path run and their times from the ``programs`` rows, K4's at
W_step; then ``grid_scan`` (K8) per stateful step, its launches summed
over the ``state`` and ``mesh`` phases' runs on the card and its times at
its own path's layout; then ``keyed_fold`` (K7) and ``tree_reduce`` (K6)
per reduce variant, their launches summed over the reduce paths' runs on
the card and their times at the graph_gpu batch), and as the last line
``{"ok": true, "device": {...}}``. Any failed phase raises: the script
exits non-zero and prints no result. It needs ``torch.cuda.is_available()``
and the ``windflow_tpu_torch`` package beside it.
"""

from __future__ import annotations

import dataclasses
import json
from collections import Counter
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


_T0 = time.perf_counter()


def phase(name: str, **fields) -> None:
    """One phase line; ``elapsed_s`` is the script's time so far."""
    print(json.dumps({"phase": name, **fields, "elapsed_s": round(
        time.perf_counter() - _T0, 1)}), flush=True)


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


# ---------------------------------------------------------------------------
# K1's traced variants: combines the port traces and compiles into a
# library of their own (windflow_tpu_torch/kernels/combine_trace.py).
# ``_ysb_last`` is examples/ysb.py's window combine; the others exercise a
# cross-field int/float combine, a where on a comparison, a bool plane,
# 12 fields, a division by a constant (which torch's CUDA kernel
# computes as a product with the reciprocal), a float result on an int32
# plane, and the fieldwise library's int32 sum, traced.
def _ysb_last(a, b):
    return {"count": a["count"] + b["count"], "last_ing": b["last_ing"]}


def _mean_last(a, b):
    return {"n": a["n"] + b["n"], "last": b["last"],
            "mean": (a["mean"] * a["n"] + b["mean"] * b["n"])
            / (a["n"] + b["n"])}


def _argmax_ts(a, b):
    import torch
    w = b["v"] > a["v"]
    return {"v": torch.where(w, b["v"], a["v"]),
            "ts": torch.where(w, b["ts"], a["ts"])}


def _flags(a, b):
    return {"f": a["f"] | b["f"], "n": a["n"] + b["n"]}


WIDE = 12


def _wide(a, b):
    import torch
    return {f"w{i}": a[f"w{i}"] + b[f"w{i}"] if i % 2 == 0
            else torch.maximum(a[f"w{i}"], b[f"w{i}"]) for i in range(WIDE)}


def _scaled(a, b):
    # not associative: a kernel check only, no window runs it
    return {"x": a["x"] / 3.0 + b["x"] * 0.5, "k": a["k"] - b["k"] * 3}


def _promote(a, b):
    # not associative: a kernel check only. A float result on an int32
    # plane whose ints span the int32 range: where one child is valid, the
    # plain version's where promotes it to float32 before the store
    # truncates it, so ints above 2^24 change, and the kernel must match
    return {"big": a["big"] * 0.5 + b["big"]}


def _traced_sum(a, b):
    # the fieldwise library's int32 sum through the traced path: the two
    # timed on the same work
    from windflow_tpu_torch.combines import fieldwise
    return fieldwise(f0="sum")(a, b)



def traced_specs(torch):
    """name -> (plane dtypes, combine) of each traced variant."""
    I, F, B = torch.int32, torch.float32, torch.bool
    return {"ysb_last": ({"count": I, "last_ing": I}, _ysb_last),
            "mean_last": ({"n": I, "last": I, "mean": F}, _mean_last),
            "argmax_ts": ({"v": F, "ts": I}, _argmax_ts),
            "flags": ({"f": B, "n": I}, _flags),
            "wide": ({f"w{i}": I for i in range(WIDE)}, _wide),
            "scaled": ({"x": F, "k": I}, _scaled),
            "promote": ({"big": I}, _promote),
            "traced_sum": ({"f0": I}, _traced_sum)}


def _variants(torch):
    """name -> K1 variant of every traced spec."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    return {n: fr.variant(comb, dtypes)
            for n, (dtypes, comb) in traced_specs(torch).items()}


def _k8_step_specs(torch):
    """name -> (step, filter mode, columns like its runs', state like its
    table) of each stateful step the script's graphs run through K8: the
    stateful map (``state`` smap / smap_hc / fused, the mesh's Map_Mesh,
    ``dag``, ``recovery``, ``delta``, ``rescale``, ``supervise``), the
    running-max filter (``state`` sfilter) and the tiered float32 scan
    (``state`` tiered, ``delta`` tiered)."""
    I, F = torch.int32, torch.float32
    kv = {"key": torch.zeros(1, dtype=I), "value": torch.zeros(1, dtype=I)}
    return {"smap": (_smap_fn, False, kv, {"n": torch.zeros(1, dtype=I)}),
            "sfilter": (_run_max_fn, True, kv,
                        {"mx": torch.zeros(1, dtype=I)}),
            "tier": (_tier_fn, False, {"k": torch.zeros(1, dtype=I),
                                       "v": torch.zeros(1, dtype=F)},
                     torch.zeros(1, dtype=F))}


def _k8_variants(torch):
    """name -> K8's traced step of each ``_k8_step_specs`` entry."""
    from windflow_tpu_torch.kernels import grid_scan as gs
    return {n: gs.step_variant(f, filt, cols, st)
            for n, (f, filt, cols, st) in _k8_step_specs(torch).items()}


def _spills(build, prefix):
    """[library, kernel, registers, stack, spill stores, spill loads] of
    every kernel with a stack frame or spills among the libraries built
    so far whose name starts with ``prefix``."""
    return [[lib] + r for lib, info in sorted(build.BUILD_INFO.items())
            if lib.startswith(prefix)
            for r in ptxas_report(info["log"]) if any(r[2:5])]


def build_phase(torch):
    """Every K1 library from the sources in this checkout, the fieldwise
    one and each traced variant's, and K8's library of each stateful step
    the script runs and of the 64-column step, one nvcc each, all started
    together; a stack frame or a spill in any kernel fails the phase."""
    from concurrent.futures import ThreadPoolExecutor
    from windflow_tpu_torch.kernels import build
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.kernels import grid_scan as gs
    libs = {"fieldwise": fr.Variant(fr.FIELDWISE), **_variants(torch),
            **{f"reduce:{n}": fv.variant
               for n, fv in _reduce_variants(torch).items()},
            **{f"k8:{n}": v for n, v in _k8_variants(torch).items()},
            "k8:wide": gs.step_variant(*_k8_wide_spec(torch))}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(v.load) for v in
                    {v.library: v for v in libs.values()}.values()]:
            fut.result()
    total = time.perf_counter() - t0
    bad = []
    for name, v in libs.items():
        info = build.BUILD_INFO[v.library]
        report = ptxas_report(info["log"])
        phase("build", kernel=v.library, variant=name,
              nvcc_s=round(info["seconds"], 3), total_s=round(total, 3),
              kernels=len(report),
              max_registers=max((r[1] for r in report), default=None),
              ptxas=report)
        if info["log"] and not report:
            fail(f"{v.library}: no kernel in the nvcc -Xptxas -v log")
        bad += [r for r in report if any(r[2:5])]
    if bad:
        fail(f"kernels with a stack frame or spills: {bad}")


# ---------------------------------------------------------------------------
def _typed_forest(torch, K, F, dtypes, gen):
    """Random (trees, tvalid) on the card: leaves random, stale internals
    random too, validity random, 1% of the float values NaN; a count
    plane (``n``) positive, a ``big`` plane over the whole int32 range."""
    trees = {}
    for name, dt in dtypes.items():
        if dt is torch.int32:
            lo, hi = {"n": (1, 100), "big": (-2**31, 2**31)}.get(
                name, (-2**20, 2**20))
            t = torch.randint(lo, hi, (K, 2 * F), generator=gen,
                              dtype=torch.int64).to(torch.int32)
        elif dt is torch.float32:
            t = torch.randn((K, 2 * F), generator=gen, dtype=torch.float32)
            # a few NaNs: min/max must propagate them as torch does
            t[torch.rand((K, 2 * F), generator=gen) < 0.01] = float("nan")
        else:
            t = torch.rand((K, 2 * F), generator=gen) < 0.5
        trees[name] = t.cuda()
    tvalid = (torch.rand((K, 2 * F), generator=gen) < 0.6).cuda()
    return trees, tvalid


def _forest(torch, K, F, spec, gen):
    """A fieldwise spec's forest: fields f0, f1, ... of its dtypes."""
    return _typed_forest(torch, K, F, {
        f"f{i}": getattr(torch, dt) for i, (dt, _op) in enumerate(spec)},
        gen)


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


def _node_bytes(spec):
    """Bytes of one node: a fieldwise spec's 4-byte planes, or a traced
    spec's planes (a bool plane one byte), and the validity byte."""
    if isinstance(spec, dict):
        return sum(1 if str(dt) == "torch.bool" else 4
                   for dt in spec.values()) + 1
    return 4 * len(spec) + 1


def bound_ms(K, F, spec):
    """Least time on the card: leaves [F, 2F) read and internals [1, F)
    written once, each node its planes' values plus one validity byte,
    over the HBM rate."""
    return K * (2 * F - 1) * _node_bytes(spec) / PEAK_BYTES_PER_S * 1e3


SPECS = {
    "int32_sum": [("int32", "sum")],
    "float32_sum": [("float32", "sum")],
    "minmax_pairs": [("float32", "min"), ("float32", "max"),
                     ("int32", "min"), ("int32", "max")],
    "pair": [("int32", "max"), ("float32", "min")],
    "eight_fields": [("int32", "sum"), ("int32", "min"), ("int32", "max"),
                     ("float32", "sum"), ("float32", "min"),
                     ("float32", "max"), ("int32", "sum"),
                     ("float32", "sum")],
}
# (K_cap, F): the main path's two forests first (10,240 keys -> K_cap
# 16,384, and 64 keys, F 32), YSB's (100 campaigns -> K_cap 128), then
# forests that move tens of MB (10^5-key streams; a long window with a
# fine slide), then edge and wide-row shapes (8 x 65,536 needs several
# passes)
SHAPES = [(16384, 32), (64, 32), (128, 32), (262144, 32), (16384, 1024),
          (4, 8), (256, 1024), (8, 65536)]
# timed: int32 sum at every shape but YSB's, four fields and every traced
# variant at the high-cardinality path's shape, and each variant a main
# path runs at the shape it runs there (PATH_SHAPE)
TRACED = ("ysb_last", "mean_last", "argmax_ts", "flags", "wide", "scaled",
          "promote", "traced_sum")
# the forest each variant of the kernels line meets on its main path:
# fieldwise on the high-cardinality path, YSB's combine on YSB's 100
# campaigns, mean_last on the high-cardinality stream, the other traced
# combines on 64 keys (phase main_path, part combine)
PATH_SHAPE = {"fieldwise": (16384, 32, "int32_sum"),
              "ysb_last": (128, 32, "ysb_last"),
              "mean_last": (16384, 32, "mean_last"),
              "argmax_ts": (64, 32, "argmax_ts"),
              "flags": (64, 32, "flags"),
              "wide": (64, 32, "wide")}
TIMED = ({(K, F, "int32_sum") for K, F in SHAPES if K != 128}
         | {(16384, 32, n) for n in ("minmax_pairs",) + TRACED}
         | set(PATH_SHAPE.values()))
WARM = {(262144, 32), (16384, 1024)}  # larger than the 50 MB L2
KERNEL_MATCH = "wf_rebuild"  # every kernel of forest_rebuild.cuh


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


def _bit_identical(torch, kt, kv, rt, rv):
    """Validity and every plane equal bit for bit (NaN bits included)."""
    return torch.equal(kv, rv) and all(
        torch.equal(kt[k], rt[k]) if kt[k].dtype is torch.bool
        else torch.equal(kt[k].view(torch.int32), rt[k].view(torch.int32))
        for k in kt)


def kernel_phase(torch, timed):
    """Each forest of SHAPES x (SPECS and the traced variants) through the
    kernel and its plain version: bit-identical or fail. ``timed``: only
    the TIMED forests, each also timed (``torch.profiler`` stays out of
    the process until the main path has run, so its tracing cannot slow
    the main path's launches). Returns the timed rows by (K_cap, F, spec
    name) and the largest absolute difference by spec name."""
    from windflow_tpu_torch.combines import fieldwise
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.kernels.reference import forest_rebuild_ref
    gen = torch.Generator().manual_seed(1234 + timed)
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    specs = {n: ({f"f{i}": getattr(torch, dt)
                  for i, (dt, _) in enumerate(spec)},
                 fieldwise(**{f"f{i}": op for i, (_, op) in enumerate(spec)}),
                 spec) for n, spec in SPECS.items()}
    specs.update({n: (dtypes, comb, dtypes)
                  for n, (dtypes, comb) in traced_specs(torch).items()})
    timing, max_err = {}, {}
    for K, F in SHAPES:
        for sname, (dtypes, comb, spec) in specs.items():
            if timed and (K, F, sname) not in TIMED:
                continue
            trees, tvalid = _typed_forest(torch, K, F, dtypes, gen)
            kt, kv = _clone(trees, tvalid)
            rt, rv = _clone(trees, tvalid)
            fr.forest_rebuild(kt, kv, comb)
            forest_rebuild_ref(rt, rv, comb)
            torch.cuda.synchronize()
            max_err[sname] = max([max_err.get(sname, 0.0)] + [
                (kt[k].double() - rt[k].double()).abs().nan_to_num(0.0)
                .max().item() for k in kt])  # NaN bits: checked below
            if not _bit_identical(torch, kt, kv, rt, rv):
                fail(f"forest_rebuild differs from its plain version at "
                     f"K_cap={K} F={F} {sname}")
            plan = fr.forest_plan(kt, kv)
            variant = fr.check_forest(kt, kv, comb)
            row = {"K_cap": K, "F": F, "fields": sname,
                   "variant": variant.library, "bit_identical": True,
                   "plan": [[p.regime, p.W, p.S, p.E, p.rows] for p in plan]}
            if timed:
                row.update(time_rebuild(torch, fr.forest_rebuild, kt, kv,
                                        comb, spec, flush, len(plan),
                                        warm=(K, F) in WARM))
                row["plain_ms"] = _time_ms(torch, lambda: forest_rebuild_ref(
                    rt, rv, comb), 10, flush)
                timing[K, F, sname] = row
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
               fusion=True, graph_kw=None, trace_rate=None, setup=None,
               schema=None, first_hook=None, pace_s=0.0, lift=None,
               combine=None):
    """Columnar source -> [prefix ops, chained ->] Ffat_Windows_GPU ->
    columnar sink; returns the window columns (sorted by key, wid), timing
    marks, the window's replica (a fused chain's replica when the prefix
    fused into it) and the graph. The window sums ``value`` unless
    ``lift`` and ``combine`` say otherwise. ``graph_kw`` goes to the PipeGraph,
    ``trace_rate`` to the source's, window's and sink's
    ``with_latency_tracing``, ``setup(graph)`` runs before the build,
    ``schema`` is the window's declared schema, ``first_hook(graph)`` runs
    before the first block is yielded and ``pace_s`` sleeps after each
    block (the observe phase's knobs)."""
    import numpy as np
    t_yield, t_in, t_recv = {}, {}, {}
    parts, lock = [], threading.Lock()
    holder = {}

    def source():
        for cols, ts, wm in blocks:
            if first_hook is not None and not t_yield:
                first_hook(holder["graph"])
            t_yield[wm] = time.perf_counter()
            yield cols, ts, wm
            if pace_s:
                time.sleep(pace_s)

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
                         fusion=fusion, **(graph_kw or {}))
    holder["graph"] = graph
    b = (wt.Ffat_Windows_GPU_Builder(
        lift or (lambda f: {"value": f["value"]}),
        combine or wt.fieldwise(value="sum"))
         .with_key_by("key").with_tb_windows(WIN_US, SLIDE_US)
         .with_key_capacity(n_keys))
    if win_per_batch:
        b = b.with_num_win_per_batch(win_per_batch)
    if schema is not None:
        b = b.with_schema(schema)
    src_b = wt.Columnar_Source_Builder(source).with_output_batch_size(BATCH)
    sink_b = wt.Sink_Builder(sink).with_columns()
    if trace_rate is not None:
        b = b.with_latency_tracing(trace_rate)
        src_b = src_b.with_latency_tracing(trace_rate)
        sink_b = sink_b.with_latency_tracing(trace_rate)
    op = b.build()
    mp = graph.add_source(src_b.build())
    for i, pre in enumerate(prefix):
        mp = mp.add(pre) if i == 0 else mp.chain(pre)
    mp = mp.chain(op) if prefix else mp.add(op)
    mp.add_sink(sink_b.build())
    if setup is not None:
        setup(graph)
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


# K6's and K7's launches on the reduce paths (graph_gpu, fusion, state
# fused, dag, mesh): every run on the card sets the counts to 0 just
# before ``graph.run()`` and records them just after (``_reduce_reset`` /
# ``_reduce_read``, in the runners); the kernels line sums the runs by
# (kernel, variant tag)
REDUCE_PATH = Counter()
_REDUCE_LAST = [Counter()]


def _reduce_reset():
    from windflow_tpu_torch.kernels import reduce_fold as rf
    with rf._count_lock:
        rf.REDUCE_LAUNCHES = 0
        rf.VARIANT_LAUNCHES.clear()


def _reduce_read():
    """K6's and K7's launches since ``_reduce_reset``, by (kernel, tag),
    added to ``REDUCE_PATH``."""
    from windflow_tpu_torch.kernels import reduce_fold as rf
    with rf._count_lock:
        n, counts = rf.REDUCE_LAUNCHES, Counter(rf.VARIANT_LAUNCHES)
    if counts.total() != n:
        fail(f"K6 / K7 variant counts {dict(counts)} do not add up to "
             f"their {n} launches")
    REDUCE_PATH.update(counts)
    _REDUCE_LAST[0] = counts
    return counts


def _reduce_launched(name, kernel):
    """The last card run's launches of ``kernel`` ("keyed_fold" or
    "tree_reduce"); fails if it launched none."""
    n = sum(c for (k, _), c in _REDUCE_LAST[0].items() if k == kernel)
    if n <= 0:
        fail(f"{name}: the reduce's kernel {kernel} never launched")
    return n


# K2+K3's and K4's launches on the main paths: a reset of the counts opens
# a run window, each read of K1's counts records the window's counts of
# the FFAT step's kernels (the last read of a window holds them all), by
# (kernel, variant tag); the kernels line sums the windows
STEP_RUNS = {}
_STEP_WINDOW = [0]


def _reset_launches(fr):
    """Set K1's launch counts, the total and each variant's, and those of
    K2+K3 and K4 to 0: just before each main-path run whose launches the
    script reads."""
    from windflow_tpu_torch.kernels import ffat_step as fs
    fr.LAUNCHES = 0
    fr.VARIANT_LAUNCHES.clear()
    fs.INGEST_LAUNCHES = fs.QUERY_LAUNCHES = 0
    fs.INGEST_VARIANT_LAUNCHES.clear()
    fs.QUERY_VARIANT_LAUNCHES.clear()
    _STEP_WINDOW[0] += 1


def _step_counts():
    """K2+K3's and K4's launches since the last reset, by (kernel,
    variant tag)."""
    from windflow_tpu_torch.kernels import ffat_step as fs
    counts = Counter({("ingest", t): n
                      for t, n in fs.INGEST_VARIANT_LAUNCHES.items()})
    counts.update({("query", t): n
                   for t, n in fs.QUERY_VARIANT_LAUNCHES.items()})
    return counts


def _launch_counts(fr):
    """K1's launches since the last reset, by variant tag (and K2+K3's
    and K4's recorded for the kernels line)."""
    counts = Counter(fr.VARIANT_LAUNCHES)
    if counts.total() != fr.LAUNCHES:
        fail(f"K1's variant counts {dict(counts)} do not add up to its "
             f"{fr.LAUNCHES} launches")
    if _STEP_WINDOW[0]:
        STEP_RUNS[_STEP_WINDOW[0]] = _step_counts()
    return counts


def _launched(name, fr, rep):
    """K1's launches since the last reset, by variant tag; the window
    replica must have counted their total too, and the FFAT step's
    kernels must have run: K2+K3 on every ingest, K4 on every fire step
    (at least once per rebuild)."""
    from windflow_tpu_torch.kernels import ffat_step as fs
    launches = _launch_counts(fr)
    if not launches or rep.stats.rebuild_kernel_launches \
            != launches.total():
        fail(f"{name}: the rebuild kernel did not run on the path "
             f"(wrapper {launches.total()}, replica "
             f"{rep.stats.rebuild_kernel_launches})")
    if fs.INGEST_LAUNCHES < 1 or fs.QUERY_LAUNCHES < launches.total():
        fail(f"{name}: the FFAT step's kernels did not run on the path "
             f"(K2+K3 {fs.INGEST_LAUNCHES}, K4 {fs.QUERY_LAUNCHES}, K1 "
             f"{launches.total()})")
    return launches


def main_path_phase(torch, wt, name, n_keys, win_per_batch):
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    blocks = _blocks(n_keys, seed=7)
    _reset_launches(fr)
    torch.cuda.synchronize()
    run = _run_graph(wt, "cuda", blocks, n_keys, win_per_batch)
    launches = _launched(name, fr, run[5])
    gcols, wall, rep = run[0], run[4], run[5]
    ccols = _run_graph(wt, "cpu", blocks, n_keys, win_per_batch)[0]
    _check_windows(name, "the CPU run", gcols, ccols)
    valid = gcols["valid"]
    if not valid.any() or (gcols["value"][valid] < 0).any():
        fail(f"{name}: no valid windows, or negative sums of values >= 0")
    src = run[6].get_stats()["Operators"][0]["replicas"][0]
    row = dict(config=name, keys=n_keys, batches=N_BATCHES, batch=BATCH,
               windows_total=int(len(gcols["key"])),
               valid_windows=int(valid.sum()),
               rebuild_launches=launches.total(),
               device_programs=rep.stats.device_programs_run,
               **_ffat_rates(blocks, run), wall_s=wall,
               rows_equal_cpu=True,
               # the staging edge's pinned-buffer pool (recycling.py)
               staging_pool_hits=src["Staging_pool_hits"],
               staging_pool_misses=src["Staging_pool_misses"])
    return row, launches


COMBINE_TIMED = 8      # part combine: timed HC batches after WARMUP
COMBINE_64_BATCHES = 6  # the other traced combines, 64 keys


def _combine_lifts(torch):
    """name -> lift over the main path's (key, value) columns, for each
    traced combine part ``combine`` drives through Ffat_Windows_GPU."""
    f32 = torch.float32
    return {
        "mean_last": lambda f: {"n": f["value"] * 0 + 1, "last": f["value"],
                                "mean": f["value"].to(f32)},
        "argmax_ts": lambda f: {"v": f["value"].to(f32) * 0.25,
                                "ts": f["value"] * 3 + f["key"]},
        "flags": lambda f: {"f": f["value"] > 90, "n": f["value"]},
        "wide": lambda f: {f"w{i}": f["value"] * (i + 1) - i
                           for i in range(WIDE)},
    }


# float tolerance against the port's CPU run: mean_last and argmax_ts run
# the same IEEE operations on both devices (1e-6 covers a regrouping)
COMBINE_RTOL = {"mean_last": 1e-6, "argmax_ts": 1e-6}


def _check_combine_rows(name, got, ref, rtol):
    """Window rows equal the CPU run's: keys, windows and validity; ints
    and bools exactly, floats within ``rtol``. Returns the largest
    relative float difference."""
    if got.keys() != ref.keys() or len(got["key"]) != len(ref["key"]):
        fail(f"combine {name}: window rows differ in shape from the CPU run")
    for k in ("key", "wid", "valid"):
        if not np.array_equal(got[k], ref[k]):
            fail(f"combine {name}: column {k!r} differs from the CPU run")
    v = got["valid"].astype(bool)
    worst = 0.0
    for k in got:
        if k in ("key", "wid", "valid", "ts"):
            continue
        g, r = got[k][v], ref[k][v]
        if g.dtype.kind == "f":
            d = np.abs(g.astype(np.float64) - r) / np.maximum(np.abs(r), 1e-30)
            worst = max(worst, float(d.max(initial=0.0)))
            if not np.allclose(g, r, rtol=rtol, atol=0.0):
                fail(f"combine {name}: {k} differs from the CPU run beyond "
                     f"rtol {rtol} (largest {worst})")
        elif not np.array_equal(g, r):
            fail(f"combine {name}: {k} differs from the CPU run")
    return worst


def combine_phase(torch, wt, card):
    """Phase ``main_path``, part ``combine``: the traced combines through
    ``Ffat_Windows_GPU`` on the card, against the port's CPU run of the
    same stream. ``mean_last`` on the high-cardinality stream (10,240
    keys, WARMUP + COMBINE_TIMED batches), the others at 64 keys. K1's
    traced variant must launch once per firing batch, and only it.
    Returns K1's launches by variant."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    specs = traced_specs(torch)
    total = Counter()
    for name, lift in _combine_lifts(torch).items():
        dtypes, comb = specs[name]
        hc = name == "mean_last"
        n_keys = HC_KEYS if hc else 64
        blocks = _blocks(n_keys, seed=11, n_batches=(
            WARMUP + COMBINE_TIMED if hc else COMBINE_64_BATCHES))
        tag = fr.variant(comb, dtypes).tag
        ccols = _run_graph(wt, "cpu", blocks, n_keys, None if hc else 128,
                           lift=lift, combine=comb)[0]
        _reset_launches(fr)
        torch.cuda.synchronize()
        run = _run_graph(wt, "cuda", blocks, n_keys, None if hc else 128,
                         lift=lift, combine=comb)
        launches = _launched(f"combine {name}", fr, run[5])
        total += launches
        mine = launches[tag]
        rates = _ffat_rates(blocks, run)
        if not mine == launches.total() == rates["firing_batches"]:
            fail(f"combine {name}: its variant launched {mine} times (K1 "
                 f"{launches.total()}) for {rates['firing_batches']} "
                 "firing batches")
        gcols = run[0]
        worst = _check_combine_rows(name, gcols, ccols,
                                    COMBINE_RTOL.get(name, 0.0))
        if not gcols["valid"].any():
            fail(f"combine {name}: no valid windows")
        phase("main_path", part="combine", combine=name, card=card,
              keys=n_keys, batches=len(blocks), batch=BATCH,
              planes={k: str(v).replace("torch.", "")
                      for k, v in dtypes.items()},
              variant=fr.variant(comb, dtypes).library,
              windows_total=int(len(gcols["key"])),
              valid_windows=int(gcols["valid"].sum()),
              rebuild_launches=mine, **rates, wall_s=run[4],
              rows_equal_cpu=True, float_rtol=COMBINE_RTOL.get(name),
              float_max_rel_diff=worst)
    return total


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
    fused_launches = Counter()
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
            _reset_launches(fr)
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
            if launches.total() != rates["firing_batches"]:
                fail(f"fusion {name}: K1 launched {launches.total()} "
                     f"times for {rates['firing_batches']} firing batches")
            programs = sum(r["Device_programs_run"] for o in ops
                           for r in o["replicas"])
            runs = row.setdefault("fused" if fusion else "unfused", [])
            runs.append(dict(**rates, rebuild_launches=launches.total(),
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
    if device == "cuda":
        _reduce_reset()
    graph.run()
    if device == "cuda":
        _reduce_read()
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


def _program_ms(torch, fn, reps=30, tries=TRACE_TRIES):
    """Device time per call of a multi-kernel program (the CUDA time of
    every kernel it launched, from ``torch.profiler``), kernels per call,
    and the CUDA-event bracket around one call (median: host launch time
    and device time together). Each call sits between marker kernels
    (``torch.cuda._sleep``'s ``spin_kernel``, on the same stream): a call
    whose kernel count differs from the most common count lost a record
    (the card's profiler has been seen to drop one record of a trace) and
    is left out, and the device time is the mean over the whole calls. A
    trace with fewer than half its calls whole is taken again (up to
    ``tries`` times); then device time and kernels per call are None (not
    measured)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.cuda._sleep(1000)
                fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        kernels = sorted(_events(torch, prof)[0],
                         key=lambda e: e.time_range.start)
        calls, cur = [], None
        for e in kernels:
            if "spin_kernel" in e.name:
                if cur is not None:
                    calls.append(cur)
                cur = []
            elif cur is not None:
                cur.append(e)
        counts = Counter(len(c) for c in calls)
        if counts:
            launches, _n = counts.most_common(1)[0]
            whole = [c for c in calls if len(c) == launches]
            if launches and 2 * len(whole) >= reps:
                device_ms = sum(sum(e.time_range.elapsed_us() for e in c)
                                for c in whole) / 1e3 / len(whole)
                break
        time.sleep(0.5)
    else:
        _lost_trace(f"torch.profiler lost kernel records ({len(kernels)} "
                    f"kernels and markers for {reps} calls)")
        device_ms = launches = None
    return device_ms, launches, _event_ms(torch, fn, reps)


def _event_ms(torch, fn, reps):
    """Median of ``reps`` CUDA-event brackets around one call of ``fn``
    (host launch time and device time together)."""
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    out.sort()
    return out[len(out) // 2]


def programs_phase(torch, wt, blocks, card):
    """K5 (the XLA program of the JAX package's Filter_TPU, which has no
    Pallas kernel) as the port runs it, on one batch of the graph_gpu
    stream, with its bytes bound (each input read once, each output
    written once) and ``torch.argsort(~keep, stable=True)``'s time beside
    it; then K6 and K7, the hand kernels (``reduce_fold_phase``).
    Returns K5's row and K6's and K7's rows and errors."""
    import numpy as np
    from windflow_tpu_torch.gpu import ops_gpu as og
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
    # inputs 2 int32 columns; outputs 2 compacted columns + order + count
    nbytes = 8 * n + 12 * n + 8
    device_ms, launches, bracket_ms = _program_ms(
        torch, lambda: og.filter_program(_even_value, mapped, n))
    keep = _even_value(mapped)
    lib_ms = _event_ms(torch, lambda: torch.argsort(~keep, stable=True), 30)
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    row = dict(program="K5_compaction", replaces="windflow_tpu/tpu/ops_tpu.py:58",
               rows=n, kept=len(kept), device_ms=device_ms,
               launches=launches, wrapper_ms=bracket_ms, bytes=nbytes,
               bound_ms=bound, bound_by="bytes",
               bound_share=_share(bound, device_ms),
               library_ms=lib_ms,
               library_call="torch.argsort(~keep, stable=True)", card=card)
    phase("programs", **row)
    return row, reduce_fold_phase(torch, wt, blocks, card)


# ---------------------------------------------------------------------------
# phase programs, K6 and K7: the reduce folds on the graph_gpu batch as
# the reduce replicas and the fused exits get it, on the mesh's lanes and
# on layouts that stress them
# K7's layouts: (combine, slots, valid, kept rows); K6's the same rows.
# The last three put K7's runs at its regimes' edges (31 / 32 / 33 rows;
# BLOCK_ROWS - 1 / BLOCK_ROWS / BLOCK_ROWS + 1) and split long runs over
# many chunk blocks, with slots of no run beside them
FOLD_LAYOUTS = ("graph_gpu", "fused", "mesh", "one_run", "all_invalid",
                "keys_65536", "float32", "half_valid", "tile_edges",
                "passthrough", "dag", "thread_warp_edges",
                "warp_block_edges", "long_split")
# K6 also at capacities that are no power of two, with a mask; and with
# the size form (the unfused global reduce's) at ragged sizes and size 1
TREE_RAGGED = (BATCH + 1, 40_000, 100)
TREE_SIZES = ((BATCH, 1), (BATCH, 40_001), (BATCH + 1, BATCH + 1))
# the layouts timed (the paths' own, then the stress layouts' on the
# second pass if the script is on time)
FOLD_TIMED = ("graph_gpu", "fused", "mesh", "one_run", "keys_65536",
              "float32", "tile_edges", "passthrough")
# the layout each kernel's kernels-line entry takes its times from
FOLD_PATH = {"keyed_fold": "graph_gpu", "tree_reduce": "graph_gpu"}


def _fsum_max(a, b):
    import torch
    return {"x": a["x"] + b["x"], "m": torch.maximum(a["m"], b["m"])}


def _fold_specs():
    """combine name -> combine: the graph's sum (its key passes through),
    the diamond's, and a float32 sum with a max beside it."""
    return {"sum_value": _sum_value, "sum_key_branch": _sum_key_branch,
            "fsum_max": _fsum_max}


def _reduce_variants(torch):
    """name -> the reduce fold's variant (``reduce_fold.fold_variant``)
    of each combine the script's reduce paths and stress layouts run, over
    their columns' dtypes."""
    from windflow_tpu_torch.kernels import reduce_fold as rf
    I, F = torch.int32, torch.float32
    cols = {"sum_value": {"key": I, "value": I},
            "sum_key_branch": {"key": I, "value": I, "branch": I},
            "fsum_max": {"key": I, "x": F, "m": F}}
    specs = _fold_specs()
    return {n: rf.fold_variant(specs[n], {f: torch.zeros(1, dtype=dt)
                                          for f, dt in c.items()})
            for n, c in cols.items()}


def fold_layout(torch, name, blocks, rng):
    """(combine name, columns, order, sorted slots, n_slots, valid or
    None, out_rows) of one K7 layout, numpy; K6 takes the columns and
    ``valid`` (or the first ``kept`` rows where None)."""
    from windflow_tpu_torch.kernels import reduce_fold as rf
    cols, ts, _ = blocks[GRAPH_WARMUP]
    n = len(ts)
    key = cols["key"].astype(np.int64)
    value = cols["value"].astype(np.int64) * 3 + key
    keep = value % 2 == 0
    value = value.astype(np.int32)
    comb = "sum_value"
    valid = None
    if name == "graph_gpu":  # the replica's batch: the kept rows first
        k = np.flatnonzero(keep)
        m = len(k)
        key = np.r_[key[k], np.zeros(n - m, np.int64)]
        value = np.r_[value[k], np.zeros(n - m, np.int32)]
        slot = np.r_[key[:m], np.full(n - m, GRAPH_KEYS)]
        n_slots, out_rows = GRAPH_KEYS, 256
    elif name in ("fused", "dag"):  # the mapped rows, the filter's mask
        valid = keep  # into the slots' bucket, as the fused exit folds
        slot = key.copy()
        n_slots, out_rows = GRAPH_KEYS, 256
    elif name == "mesh":  # a group's lanes: a quarter padding
        slot = np.where(rng.random(n) < 0.25, GRAPH_KEYS, key)
        n_slots = out_rows = GRAPH_KEYS
    elif name == "one_run":
        slot = np.zeros(n, np.int64)
        n_slots, out_rows = 1, 8
    elif name == "all_invalid":
        valid = np.zeros(n, bool)
        slot = key.copy()
        n_slots, out_rows = GRAPH_KEYS, n
    elif name == "keys_65536":
        slot = rng.permutation(n)
        n_slots = out_rows = n
    elif name == "tile_edges":  # runs of 256 and 1,024 rows
        lens = np.resize([256, 1024], n // 640 + 2)
        lens = lens[np.cumsum(lens) <= n]
        lens[-1] += n - lens.sum()
        slot = np.repeat(np.arange(len(lens)), lens)[rng.permutation(n)]
        n_slots = out_rows = len(lens)
    elif name in ("thread_warp_edges", "warp_block_edges", "long_split"):
        edge = {"thread_warp_edges": rf.WARP_ROWS,
                "warp_block_edges": rf.BLOCK_ROWS}.get(name)
        # runs at the edge - 1, edge, edge + 1 and 1 row, over and over; or
        # runs of 5, 9 and 20 chunks, each beside a slot of no run
        lens = (np.resize([edge - 1, edge, edge + 1, 1],
                          4 * n // (3 * edge + 1) + 8)
                if edge else np.resize([5 * rf.CHUNK_ROWS + 3, 0,
                                        9 * rf.CHUNK_ROWS - 7, 0, 1,
                                        20 * rf.CHUNK_ROWS], 12))
        lens = lens[np.cumsum(lens) <= n]
        lens = np.r_[lens, n - lens.sum()]
        slot = np.repeat(np.arange(len(lens)), lens)[rng.permutation(n)]
        valid = rng.random(n) < 0.7 if name == "warp_block_edges" else None
        n_slots = len(lens)
        out_rows = n_slots + 5
    else:  # float32, half_valid, passthrough: 256 keys, half valid
        valid = rng.random(n) < 0.5
        slot = key.copy()
        n_slots, out_rows = GRAPH_KEYS, 256
    columns = {"key": key.astype(np.int32), "value": value}
    if name == "float32":
        comb = "fsum_max"
        columns = {"key": columns["key"],
                   "x": rng.random(n).astype(np.float32),
                   "m": rng.standard_normal(n).astype(np.float32)}
    elif name == "passthrough":  # an int64 key and a 2-D pair pass
        columns["key64"] = key * 3_000_000_019
        columns["pair"] = np.stack([key, -key], 1).astype(np.int32)
    elif name == "dag":
        comb = "sum_key_branch"
        columns["branch"] = (value % 2).astype(np.int32)
    order = np.argsort(slot, kind="stable").astype(np.int32)
    return (comb, columns, order, slot[order].astype(np.int32), n_slots,
            valid, out_rows)


def _reduce_err(torch, name, got, gv, ref, rv, exact_floats):
    """Largest |kernel - plain| over the valid output rows; fails unless
    validity is equal, ints and bools exact and floats within
    STEP_FOLD_RTOL (bit for bit with ``exact_floats``)."""
    if not torch.equal(gv, rv):
        fail(f"{name}: validity differs from its plain version")
    err = 0.0
    for k, r in ref.items():
        a, b = got[k][rv], r[rv]
        if a.dtype is torch.float32 and not exact_floats:
            if not torch.allclose(a, b, rtol=STEP_FOLD_RTOL, atol=0.0,
                                  equal_nan=True):
                fail(f"{name}: float column {k!r} beyond rtol "
                     f"{STEP_FOLD_RTOL} of its plain version")
            if a.numel():
                err = max(err, (a.double() - b.double()).abs().max().item())
        elif not _same_bits(torch, a, b):
            fail(f"{name}: column {k!r} differs from its plain version")
    return err


def _row_bytes(cols, planes):
    """(a row's plane bytes, a row's bytes over every column)."""
    pb = sum(cols[f].element_size() for f in planes)
    return pb, sum(t[:1].numel() * t.element_size() for t in cols.values())


def _fold_bytes(cols, live, live_valid, valid, out_rows, planes, n_out,
                n_slots):
    """K7's bytes, only the rows it must move: each live row's slot and
    order (and validity byte, with ``valid``), the planes of the live
    rows that are valid, each slot's start; each output row's columns and
    validity written once; the pass-through columns' source rows read.
    The rows past the sentinel hold no run: none counted."""
    pb, row = _row_bytes(cols, planes)
    return (live * (8 + (valid is not None)) + live_valid * pb
            + 4 * (n_slots + 1) + out_rows * (row + 1) + n_out * (row - pb))


def _tree_bytes(cols, n, n_valid, planes, masked):
    """K6's bytes: every row's validity byte (with a mask; the size form
    reads none), the planes of the valid rows; the output row's columns
    and validity written once and its pass-through columns read at the
    source row."""
    pb, row = _row_bytes(cols, planes)
    return n * masked + n_valid * pb + row + 1 + (row - pb)


def _fold_regimes(starts, n, max_run):
    """K7's regimes on a launch's runs (``starts``, numpy): the slots a
    thread folds, a warp, the chunk blocks, the slots with no run, and
    the chunk blocks launched."""
    from windflow_tpu_torch.kernels import reduce_fold as rf
    lens = np.diff(starts)
    return dict(thread=int(((lens > 0) & (lens < rf.WARP_ROWS)).sum()),
                warp=int(((lens >= rf.WARP_ROWS)
                          & (lens < rf.BLOCK_ROWS)).sum()),
                block=int((lens >= rf.BLOCK_ROWS).sum()),
                empty=int((lens == 0).sum()),
                chunk_blocks=rf.chunk_blocks(n, max_run),
                longest=int(lens.max(initial=0)))


def _fold_args(c):
    """A layout's K7 arguments, ``keyed_fold``'s order."""
    return (c["comb"], c["cols"], c["order"], c["slots"], c["n_slots"],
            c["valid"], c["out_rows"], c["starts"], c["max_run"])


def reduce_fold_phase(torch, wt, blocks, card):
    """Phase ``programs``, K6 and K7: every FOLD_LAYOUTS layout through
    K7 (``keyed_fold``, with its starts and longest run as the host's
    prep makes them; the mesh layout with the device's ``run_starts`` and
    no longest run, as the mesh runs it) and K6 (``tree_reduce``, the
    graph_gpu layout in the size form the unfused global reduce uses,
    also at TREE_RAGGED capacities and TREE_SIZES) and their plain
    versions on the card: validity equal, ints and bools exact, K7's
    floats within STEP_FOLD_RTOL, K6 bit for bit; K2+K3, K7 and K2+K3
    again on one stream with no sync between them, each exact; then, for
    the FOLD_TIMED layouts, the kernel's device time, launches and event
    bracket, the plain version's bracket, the bytes bound and, for the
    int sums, the library call (``index_add_`` into the slot buffer,
    ``torch.sum`` over the kept rows). Each row names K7's regimes (slots
    by regime, chunk blocks) or K6's stages. Returns rows by (kernel,
    layout) and errors by kernel."""
    from windflow_tpu_torch.gpu.ops_gpu import slot_starts
    from windflow_tpu_torch.kernels import reduce_fold as rf
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    specs = _fold_specs()
    rows, errs = {}, Counter()
    cases = {}
    for name in FOLD_LAYOUTS:
        comb, cols, order, slots, n_slots, valid, out_rows = fold_layout(
            torch, name, blocks, rng)
        starts, max_run = slot_starts(slots, n_slots)
        c = dict(comb=specs[comb], cname=comb,
                 cols={k: torch.from_numpy(v).to(dev)
                       for k, v in cols.items()},
                 order=torch.from_numpy(order).to(dev),
                 slots=torch.from_numpy(slots).to(dev), n_slots=n_slots,
                 valid=None if valid is None
                 else torch.from_numpy(valid).to(dev), out_rows=out_rows,
                 starts=torch.from_numpy(starts).to(dev), max_run=max_run)
        if name == "mesh":  # as the mesh runs it: starts made on the card
            c["starts"], c["max_run"] = rf.run_starts(c["slots"],
                                                      n_slots), None
        n = len(order)
        if name == "graph_gpu":  # the unfused global reduce's size form
            c["tree"] = dict(size=int((slots < n_slots).sum()))
            c["mask"] = torch.arange(n, device=dev) < c["tree"]["size"]
        else:
            c["mask"] = c["valid"] if valid is not None else torch.from_numpy(
                slots[np.argsort(order)] < n_slots).to(dev)
            c["tree"] = dict(valid=c["mask"])
        cases[name] = c
        fv = rf.fold_variant(c["comb"], c["cols"])
        got, gv = rf.keyed_fold(*_fold_args(c))
        ref, rv = rf.keyed_fold_ref(*_fold_args(c)[:7])
        torch.cuda.synchronize()
        e7 = _reduce_err(torch, f"K7 {name}", got, gv, ref, rv, False)
        tg, tgv = rf.tree_reduce(c["comb"], c["cols"], **c["tree"])
        tr, trv = rf.tree_reduce_ref(c["comb"], c["cols"], c["mask"])
        torch.cuda.synchronize()
        _reduce_err(torch, f"K6 {name}", tg, tgv, tr, trv, True)
        live = c["slots"] < n_slots
        live_valid = int((live if valid is None else live & c["valid"][
            c["order"].long()]).sum())
        live = int(live.sum())
        n_out = int(rv.sum())
        errs["keyed_fold"] = max(errs["keyed_fold"], e7)
        base = dict(layout=name, combine=c["cname"], tag=fv.tag, rows=n,
                    slots=n_slots, out_rows=out_rows, valid_slots=n_out,
                    with_valid=valid is not None, card=card)
        rows["keyed_fold", name] = dict(
            program="K7_keyed_fold", replaces="windflow_tpu/tpu/ops_tpu.py:1238",
            max_abs_err=e7, float_rtol=STEP_FOLD_RTOL,
            bytes=_fold_bytes(c["cols"], live, live_valid, c["valid"],
                              out_rows, fv.planes, n_out, n_slots),
            live_rows=live, live_valid_rows=live_valid,
            starts_on_card=name == "mesh",
            regimes=_fold_regimes(starts, n, c["max_run"]), **base)
        n_valid = int(c["mask"].sum())
        rows["tree_reduce", name] = dict(
            program="K6_tree_reduce", replaces="windflow_tpu/tpu/ops_tpu.py:280",
            bit_identical=True, max_abs_err=0.0,
            bytes=_tree_bytes(c["cols"], n, n_valid, fv.planes,
                              "valid" in c["tree"]),
            valid_rows=n_valid, size_form="size" in c["tree"],
            stages=rf.tree_stages(n, len(fv.planes) + 2), **base)
    for n, size in [(n, None) for n in TREE_RAGGED] + list(TREE_SIZES):
        # K6 at capacities that are no power of two, and the size form
        cols = {"key": torch.from_numpy(rng.integers(0, 256, n).astype(
                    np.int32)).to(dev),
                "value": torch.from_numpy(rng.integers(-99, 99, n).astype(
                    np.int32)).to(dev)}
        mask = (torch.from_numpy(rng.random(n) < 0.5).to(dev) if size is None
                else torch.arange(n, device=dev) < size)
        tg, tgv = rf.tree_reduce(_sum_value, cols, **(
            dict(valid=mask) if size is None else dict(size=size)))
        tr, trv = rf.tree_reduce_ref(_sum_value, cols, mask)
        torch.cuda.synchronize()
        label = f"ragged_{n}" if size is None else f"size_{size}_of_{n}"
        _reduce_err(torch, f"K6 {label}", tg, tgv, tr, trv, True)
        phase("programs", program="K6_tree_reduce", layout=label, rows=n,
              size=size, bit_identical=True,
              stages=rf.tree_stages(n, 3), card=card)
    phase("programs", **fold_back_to_back(torch, wt, cases["graph_gpu"]))
    for name in FOLD_TIMED:
        c = cases[name]
        args = _fold_args(c)
        for kernel, fn, plain in (
                ("keyed_fold", lambda: rf.keyed_fold(*args),
                 lambda: rf.keyed_fold_ref(*args[:7])),
                ("tree_reduce", lambda: rf.tree_reduce(c["comb"], c["cols"],
                                                       **c["tree"]),
                 lambda: rf.tree_reduce_ref(c["comb"], c["cols"],
                                            c["mask"]))):
            row = rows[kernel, name]
            row["device_ms"], row["launches"], row["ms"] = _program_ms(
                torch, fn, tries=STEP_TRACE_TRIES)
            row["plain_ms"] = _event_ms(torch, plain, 10)
            row["bound_ms"] = row["bytes"] / PEAK_BYTES_PER_S * 1e3
            row["bound_by"] = "bytes"
            row["bound_share"] = _share(row["bound_ms"], row["device_ms"])
            row["library_ms"] = row["library_call"] = None
            if c["cname"] == "sum_value":
                row.update(_fold_library(torch, kernel, c))
    for (kernel, name), row in rows.items():
        row["timed"] = name in FOLD_TIMED
        phase("programs", **row)
    return rows, errs


def _fold_library(torch, kernel, c):
    """The one PyTorch call that computes the int sum of a layout:
    ``index_add_`` of each live row's value into its slot of a zeroed
    buffer (K7), ``torch.sum`` of the valid rows' values (K6); its event
    bracket and device time."""
    value = c["cols"]["value"]
    if kernel == "keyed_fold":
        live = c["slots"] < c["n_slots"]
        if c["valid"] is not None:
            live &= c["valid"][c["order"].long()]
        rows = c["order"][live].long()
        idx = c["slots"][live].long()
        vals = value[rows]
        buf = torch.zeros(c["out_rows"], dtype=value.dtype,
                          device=value.device)
        call = "Tensor.index_add_ (the live rows' values into the slots)"
        fn = lambda: buf.index_add_(0, idx, vals)  # noqa: E731
    else:
        kept = value[c["mask"]]
        call = "torch.sum (the valid rows' values)"
        fn = lambda: torch.sum(kept)  # noqa: E731
    device_ms, _, ms = _program_ms(torch, fn, tries=STEP_TRACE_TRIES)
    return dict(library_ms=ms, library_device_ms=device_ms,
                library_call=call)


def fold_back_to_back(torch, wt, c):
    """K2+K3, K7 and K2+K3 again on one stream with no sync between them
    (K7 keeps no state of K2+K3's look-back scratch, and its own counters
    are left zero), then each held against its plain version: exact."""
    from windflow_tpu_torch.kernels import ffat_step as fs
    from windflow_tpu_torch.kernels import reduce_fold as rf
    dev = torch.device("cuda")
    rng = np.random.default_rng(22)
    K, F = STEP_K_CAP, STEP_F
    ingests = []
    for n in (BATCH, 10_001):
        comp = np.full(n, K * F, dtype=np.int64)
        lens = rng.integers(1, 701, n)
        lens = lens[np.cumsum(lens) <= n]
        comp[:lens.sum()] = np.repeat(
            rng.choice(K * F, len(lens), replace=False), lens)
        comp = torch.from_numpy(comp[rng.permutation(n)].astype(
            np.int32)).to(dev)
        ingests.append(dict(
            comp=comp, srt=fs.sort_rows(comp),
            vals={"f0": torch.from_numpy(rng.integers(0, 4, n).astype(
                np.int32)).to(dev)},
            flat={"f0": torch.zeros(K * 2 * F, dtype=torch.int32,
                                    device=dev)},
            vflat=torch.zeros(K * 2 * F, dtype=torch.bool, device=dev)))
    comb = wt.fieldwise(f0="sum")
    args = _fold_args(c)
    torch.cuda.synchronize()
    a = ingests[0]
    fs.ingest_fold(comb, a["vals"], a["srt"], a["flat"], a["vflat"], F)
    got, gv = rf.keyed_fold(*args)
    b = ingests[1]
    fs.ingest_fold(comb, b["vals"], b["srt"], b["flat"], b["vflat"], F)
    for i in ingests:
        rflat = {"f0": torch.zeros_like(i["flat"]["f0"])}
        rvflat = torch.zeros_like(i["vflat"])
        fs.ingest_fold_ref(comb, i["vals"], i["comp"], i["srt"][0], rflat,
                           rvflat, F)
        torch.cuda.synchronize()
        if not torch.equal(rvflat, i["vflat"]) or not torch.equal(
                rflat["f0"], i["flat"]["f0"]):
            fail("K2+K3 beside K7 on one stream: the fold differs from its "
                 "plain version")
    ref, rv = rf.keyed_fold_ref(*args[:7])
    _reduce_err(torch, "K7 between two K2+K3 launches", got, gv, ref, rv,
                True)
    return dict(program="K7_keyed_fold", case="between_K2K3_launches",
                exact=True)


# ---------------------------------------------------------------------------
# phase programs, K2+K3 and K4: the FFAT step's kernels on the batches of
# each main path and on layouts that stress the tiled fold, each variant a
# main path runs, then the fire steps on the forests K1 rebuilt
STEP_VARIANTS = ("fieldwise", "ysb_last", "mean_last", "argmax_ts", "flags",
                 "wide")
# checked, not timed: the fieldwise library's other combines (every op of
# its policy, floats with NaN, 1 to 8 fields), each K1's SPECS entry
STEP_CHECKED = tuple(f"fieldwise:{n}" for n in SPECS if n != "int32_sum")
STEP_K_CAP, STEP_F = 16384, 32
STEP_W = (64, 8192)  # W_step; W_cap, the HC window's default budget
STEP_LATE = 0.01     # rows on the sentinel (late / padding lanes)
# K2+K3's batches, (K_cap, rows): the HC path's (10,240 keys), the 64-key
# path's (a run per key and pane, hundreds of rows), YSB's (100 campaigns,
# 4,096-row batches, the two thirds its filter drops on the sentinel),
# then layouts of the HC forest: one run over the whole batch, runs
# ending on tile edges (256 and 1,024 rows), a 10,000-row run among HC
# rows, every row late, and HC rows whose count is no multiple of any
# tile (the last tile part empty)
STEP_LAYOUTS = {"hc": (STEP_K_CAP, BATCH), "keys64": (64, BATCH),
                "ysb": (128, 4096), "one_run": (STEP_K_CAP, BATCH),
                "tile_edges": (STEP_K_CAP, BATCH),
                "long_run": (STEP_K_CAP, BATCH),
                "all_late": (STEP_K_CAP, BATCH),
                "ragged": (STEP_K_CAP, BATCH + 1)}
# the layout each variant meets on its main path (K1's PATH_SHAPE): the
# kernels line's times
STEP_PATH = {"fieldwise": "hc", "ysb_last": "ysb", "mean_last": "hc",
             "argmax_ts": "keys64", "flags": "keys64", "wide": "keys64"}
# K4 after the fold, on the forest K1 rebuilt: fire steps of these widths
# (two windows a slot; at most two a key row on the small forests)
STEP_QUERY_W = {"hc": STEP_W, "keys64": (128,), "ysb": (128,)}
# K4 on a long ring: windows of up to F panes (a walk of 48 nodes), every
# variant checked, the fieldwise sum timed
STEP_LONG = (256, 1024, (64, 512))  # K_cap, F, widths
# K2+K3 groups the fold by tile, warp and thread, its plain version as a
# Hillis-Steele scan: float planes within this relative tolerance (ints,
# bools exact)
STEP_FOLD_RTOL = 1e-5
# K2+K3 launches of these (rows, int32 sum fields) back to back on one
# stream, nothing synchronised between them, into zeroed forests (as the
# mesh's delta forests): values 0-3 in runs of 1-700 rows across tiles,
# so the tiles' published rows hold small sums; a launch that read an
# earlier one's value as a status word would fold a wrong carry
STEP_BACK_TO_BACK = ((BATCH, 1), (4096, 8), (BATCH + 1, 3), (10_001, 8),
                     (300, 1), (BATCH, 8), (511, 3), (BATCH, 1))
# traces of a step row: a card whose profiler loses records loses them in
# every try (47 rows x 5 tries added ~150 s to one whole run)
STEP_TRACE_TRIES = 2


def _step_timed(name, layout):
    """Whether K2+K3 (and K4 after it) is timed for a variant on a
    layout: the fieldwise sum everywhere, every other variant on its own
    path's batch (scripts/bench_torch_step.py times the same cases)."""
    return name == "fieldwise" or (name in STEP_VARIANTS
                                   and layout == STEP_PATH[name])


def step_batch(layout, rng):
    """(comp, key, value) int64 / int32 numpy columns of one K2+K3 batch of
    ``layout`` (STEP_LAYOUTS): comp the packed composite slot * F + leaf,
    K_cap * F for rows on the sentinel."""
    K, n = STEP_LAYOUTS[layout]
    F, M = STEP_F, STEP_LAYOUTS[layout][0] * STEP_F
    value = rng.integers(0, 100, n).astype(np.int32)
    late = rng.random(n) < STEP_LATE
    if layout in ("hc", "keys64", "long_run", "ragged"):
        keys = rng.integers(0, HC_KEYS if K == STEP_K_CAP else K, n)
        ts = 5 * n * TS_STEP // AGG_RATE_KEYS \
            + np.arange(n, dtype=np.int64) * TS_STEP // AGG_RATE_KEYS
        comp = keys * F + (ts // SLIDE_US) % F
        if layout == "long_run":
            run = rng.permutation(n)[:10_000]
            comp[run] = (K // 2) * F + 1
            late[run] = False
    elif layout == "ysb":
        i = np.arange(n, dtype=np.int64) + 7 * n
        keys = (i % 1000) // 10  # ad -> campaign, one 10 s pane
        comp = keys * F + 3
        late = i % 3 != 0  # the filter keeps views
    elif layout == "one_run":
        keys = np.full(n, 5)
        comp = np.full(n, 5 * F + 3)
        late[:] = False
    elif layout == "tile_edges":
        lens = np.resize([256, 1024], n // 640 + 2)
        ends = np.cumsum(lens)
        lens = lens[ends <= n]
        lens[-1] += n - lens.sum()
        run = np.repeat(np.arange(len(lens)), lens)
        keys = run * 7 % K
        comp = (keys * F + run % F)[rng.permutation(n)]
        late[:] = False
    else:  # all_late
        keys = rng.integers(0, HC_KEYS, n)
        comp = keys * F
        late[:] = True
    comp = np.where(late, M, comp).astype(np.int64)
    return comp, keys.astype(np.int32), value


def step_back_to_back_case(torch, wt, rng):
    """K2+K3 over STEP_BACK_TO_BACK, every input made on the card first,
    the launches issued with no synchronisation between them, then each
    held against its plain version (exact). Returns the phase row."""
    from windflow_tpu_torch.kernels import ffat_step as fs
    dev = torch.device("cuda")
    K, F = STEP_K_CAP, STEP_F
    cases = []
    for n, nf in STEP_BACK_TO_BACK:
        lens = rng.integers(1, 701, n)
        lens = lens[np.cumsum(lens) <= n]
        comp = np.full(n, K * F, dtype=np.int64)  # the rest late
        comp[:lens.sum()] = np.repeat(
            rng.choice(K * F, len(lens), replace=False), lens)
        comp = torch.from_numpy(comp[rng.permutation(n)].astype(np.int32))
        names = [f"f{i}" for i in range(nf)]
        cases.append(dict(
            n=n, nf=nf, runs=len(lens),
            comb=wt.fieldwise(**{nm: "sum" for nm in names}),
            comp=comp.to(dev),
            vals={nm: torch.from_numpy(rng.integers(0, 4, n)
                                       .astype(np.int32)).to(dev)
                  for nm in names},
            flat={nm: torch.zeros(K * 2 * F, dtype=torch.int32, device=dev)
                  for nm in names},
            vflat=torch.zeros(K * 2 * F, dtype=torch.bool, device=dev)))
    torch.cuda.synchronize()
    for c in cases:
        fs.ingest_fold(c["comb"], c["vals"], fs.sort_rows(c["comp"]),
                       c["flat"], c["vflat"], F)
    for c in cases:
        rflat = {k: torch.zeros_like(t) for k, t in c["flat"].items()}
        rvflat = torch.zeros_like(c["vflat"])
        fs.ingest_fold_ref(c["comb"], c["vals"], c["comp"],
                           fs.sort_rows(c["comp"])[0], rflat, rvflat, F)
        torch.cuda.synchronize()
        _fold_err(torch, f"back to back n {c['n']} NF {c['nf']}",
                  c["flat"], c["vflat"], rflat, rvflat)
    return dict(program="K2K3_ingest", case="back_to_back",
                launches=[[c["n"], c["nf"], c["runs"]] for c in cases],
                exact=True)


def _fieldwise_lift(torch, spec):
    """Lift of a fieldwise SPECS entry over (key, value): signed ints,
    floats in multiples of 1/8 (a run's sum is exact in any grouping, so
    a difference next to a leaf it nearly cancels is a fault, not a
    rounding), 1% of each float column NaN."""
    def lift(f):
        v, k = f["value"], f["key"]
        out = {}
        for i, (dt, _) in enumerate(spec):
            x = (v * (2 * i + 3) + k) % 1999
            if dt == "int32":
                out[f"f{i}"] = (x - 999).to(torch.int32)
            else:
                out[f"f{i}"] = torch.where(
                    (v * 13 + k + 7 * i) % 101 == 0, float("nan"),
                    (x - 999).to(torch.float32) / 8)
        return out
    return lift


def _step_spec(torch, wt, name):
    """(plane dtypes, combine, lift over (key, value)) of a variant."""
    if name == "fieldwise":
        return ({"value": torch.int32}, wt.fieldwise(value="sum"),
                lambda f: {"value": f["value"]})
    if name.startswith("fieldwise:"):
        spec = SPECS[name.split(":", 1)[1]]
        return ({f"f{i}": getattr(torch, dt)
                 for i, (dt, _) in enumerate(spec)},
                wt.fieldwise(**{f"f{i}": op
                                for i, (_, op) in enumerate(spec)}),
                _fieldwise_lift(torch, spec))
    dtypes, comb = traced_specs(torch)[name]
    if name == "ysb_last":
        return dtypes, comb, lambda f: {"count": f["value"] * 0 + 1,
                                        "last_ing": f["value"]}
    return dtypes, comb, _combine_lifts(torch)[name]


def _plane_bytes(flat):
    return sum(t.element_size() for t in flat.values())


def _walk_nodes(start, length, F):
    """Nodes the window walk takes for each fire lane (both ranges): what
    K4 must read for these windows."""
    def taken(lo, ln):
        l, r = lo + F, lo + ln + F
        n = np.zeros_like(lo)
        for _ in range((2 * F).bit_length()):
            tl = ((l & 1) == 1) & (l < r)
            n += tl
            l = np.where(tl, l + 1, l)
            tr = ((r & 1) == 1) & (l < r)
            n += tr
            r = np.where(tr, r - 1, r)
            l, r = l >> 1, r >> 1
        return n
    len1 = np.minimum(length, F - start)
    return taken(start, len1) + taken(np.zeros_like(start), length - len1)


def _same_bits(torch, a, b):
    if a.dtype is torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _fold_err(torch, name, kflat, kvflat, rflat, rvflat):
    """Largest |kernel - plain| over the planes after K2+K3; fails unless
    validity and int / bool planes are equal and float planes agree
    within STEP_FOLD_RTOL (NaN where the plain version has NaN)."""
    if not torch.equal(kvflat, rvflat):
        fail(f"K2+K3 {name}: validity differs from its plain version")
    err = 0.0
    for k, t in kflat.items():
        r = rflat[k]
        if t.dtype is torch.float32:
            if not torch.allclose(t, r, rtol=STEP_FOLD_RTOL, atol=0.0,
                                  equal_nan=True):
                fail(f"K2+K3 {name}: float plane {k!r} beyond rtol "
                     f"{STEP_FOLD_RTOL} of its plain version")
            err = max(err, (t.double() - r.double()).abs().nan_to_num(0.0)
                      .max().item())
        elif not torch.equal(t, r):
            fail(f"K2+K3 {name}: plane {k!r} differs from its plain version")
    return err


def _long_fire(rng, K, F, W):
    """A fire buffer of W windows over a K x F forest (``fs.fire_pack``):
    W / 2 slots, two windows each of 0 to F panes from any start (ring
    wraps included), and 0-8 evicted leaves a slot; and E."""
    from windflow_tpu_torch.kernels import ffat_step as fs
    slots = np.sort(rng.choice(K, W // 2, replace=False))
    ne = rng.integers(0, 9, len(slots))
    tot = int(ne.sum())
    f_pack = np.stack([np.repeat(slots, 2), rng.integers(0, F, W),
                       rng.integers(0, F + 1, W), np.arange(W),
                       np.ones(W, np.int64)]).astype(np.int32)
    e_pack = np.zeros((3, max(1, tot)), np.int32)
    e_pack[:, :tot] = [np.repeat(slots, ne), rng.integers(0, F, tot),
                       np.ones(tot, np.int64)]
    return fs.fire_pack(f_pack, e_pack, np.full(len(slots), 2), ne, W), \
        e_pack.shape[1]


def step_ingest_case(torch, name, comb, lift, dtypes, layout, batch, gen,
                     timed):
    """K2+K3 on one batch of ``layout`` (``step_batch``) into a random
    forest through the kernel and its plain version: validity and int /
    bool planes equal, floats within STEP_FOLD_RTOL. Returns the row
    (``timed``: device time, launches and event bracket of the wrapper,
    the plain version's event bracket, the bytes bound and, for the
    fieldwise sum, ``scatter_reduce_``'s time) and the kernel's forest."""
    from windflow_tpu_torch.kernels import ffat_step as fs
    K, n = STEP_LAYOUTS[layout]
    F, M, m = STEP_F, STEP_LAYOUTS[layout][0] * STEP_F, K * 2 * STEP_F
    comp_np, keys, value = batch
    live = comp_np[comp_np < M]
    tails = len(np.unique(live))
    dev = torch.device("cuda")
    comp = torch.from_numpy(comp_np.astype(np.int32)).to(dev)
    srt = fs.sort_rows(comp)
    order = srt[0]
    cols = {"key": torch.from_numpy(keys).to(dev),
            "value": torch.from_numpy(value).to(dev)}
    vals = {k: v.contiguous() for k, v in lift(cols).items()}
    trees, tvalid = _typed_forest(torch, K, F, dtypes, gen)
    flat = {k: t.reshape(-1) for k, t in trees.items()}
    vflat = tvalid.reshape(-1)
    kflat, kvflat = ({k: t.clone() for k, t in flat.items()}, vflat.clone())
    rflat, rvflat = ({k: t.clone() for k, t in flat.items()}, vflat.clone())
    fs.ingest_fold(comb, vals, srt, kflat, kvflat, F)
    fs.ingest_fold_ref(comb, vals, comp, order, rflat, rvflat, F)
    torch.cuda.synchronize()
    err = _fold_err(torch, f"{name} {layout}", kflat, kvflat, rflat, rvflat)
    del rflat, rvflat
    nb = _plane_bytes(flat)
    row = dict(program="K2K3_ingest", variant=name, layout=layout,
               replaces="windflow_tpu/tpu/ffat_tpu.py:409", rows=n,
               K_cap=K, F=F, tails=tails, max_abs_err=err,
               float_rtol=STEP_FOLD_RTOL, timed=timed)
    if timed:
        tb, tv = ({k: t.clone() for k, t in flat.items()}, vflat.clone())
        row["device_ms"], row["launches"], row["ms"] = _program_ms(
            torch, lambda: fs.ingest_fold(comb, vals, srt, tb, tv, F),
            tries=STEP_TRACE_TRIES)
        # the plain version by events alone: its traces (up to ~22,500
        # launches) made torch.profiler lose the next kernel's records
        pb, pv = ({k: t.clone() for k, t in flat.items()}, vflat.clone())
        row["plain_ms"] = _event_ms(torch, lambda: fs.ingest_fold_ref(
            comb, vals, comp, order, pb, pv, F), 10)
        # the live rows' planes, every row's sorted key and order read
        # once; each tail's leaf and validity byte read and written once
        row["bytes"] = len(live) * nb + n * (comp.element_size() + 4) \
            + tails * 2 * (nb + 1)
        row["library_ms"] = None
        if name == "fieldwise":
            # the same leaf update by one library call (no validity)
            idx = torch.where(comp < M, comp // F * 2 * F + F + comp % F,
                              m).long()
            lb = torch.cat([flat["value"], flat["value"].new_zeros(1)])
            row["library_device_ms"], _, row["library_ms"] = _program_ms(
                torch, lambda: lb.scatter_reduce_(
                    0, idx, vals["value"], "sum", include_self=True),
                tries=STEP_TRACE_TRIES)
            row["library_call"] = "Tensor.scatter_reduce_(sum)"
        row["bound_ms"] = row["bytes"] / PEAK_BYTES_PER_S * 1e3
        row["bound_by"] = "bytes"
        row["bound_share"] = _share(row["bound_ms"], row["device_ms"])
    return row, kflat, kvflat


def step_query_case(torch, name, comb, kflat, kvflat, F, buf, W, E, ktable,
                    timed):
    """K4 on one fire buffer over a rebuilt forest, through the kernel and
    its plain version: values, validity, keys and the evicted forest bit
    for bit. Returns the row (``timed``: device time, launches and event
    bracket of the wrapper, the plain version's event bracket, the bytes
    bound)."""
    from windflow_tpu_torch.kernels import ffat_step as fs
    dev = torch.device("cuda")
    f_pack, e_pack, blocks = fs.split_fire_pack(
        torch.from_numpy(buf).to(dev), W, E)
    qf, qvf = ({k: t.clone() for k, t in kflat.items()}, kvflat.clone())
    pf, pvf = ({k: t.clone() for k, t in kflat.items()}, kvflat.clone())
    kq = fs.fire_query(comb, qf, qvf, F, f_pack, e_pack, blocks, ktable)
    pq = fs.fire_query_ref(comb, pf, pvf, F, f_pack, e_pack, ktable)
    torch.cuda.synchronize()
    same = (all(_same_bits(torch, kq[0][k], pq[0][k]) for k in kq[0])
            and torch.equal(kq[1], pq[1]) and torch.equal(kq[2], pq[2])
            and torch.equal(qvf, pvf))
    if not same or not kq[1].any():
        fail(f"K4 {name} F={F} W={W}: not bit-identical to its plain "
             f"version (or no valid window)")
    fp = f_pack.cpu().numpy()
    nodes = int(_walk_nodes(fp[1].astype(np.int64), fp[2].astype(np.int64),
                            F).sum())
    tot_e = int((e_pack[2] != 0).sum())
    nb = _plane_bytes(kflat)
    row = dict(program="K4_query", variant=name,
               replaces="windflow_tpu/tpu/ffat_tpu.py:302", windows=W,
               K_cap=kvflat.numel() // (2 * F), F=F, evictions=tot_e,
               nodes_taken=nodes, bit_identical=True, max_abs_err=0.0,
               timed=timed)
    if timed:
        row["device_ms"], row["launches"], row["ms"] = _program_ms(
            torch, lambda: fs.fire_query(comb, qf, qvf, F, f_pack, e_pack,
                                         blocks, ktable),
            tries=STEP_TRACE_TRIES)
        row["plain_ms"] = _event_ms(torch, lambda: fs.fire_query_ref(
            comb, pf, pvf, F, f_pack, e_pack, ktable), 10)
        # the taken nodes with their validity; per window its pack and its
        # output row (values, valid, key); per eviction its pack lane and
        # one byte; the block bounds
        row["bytes"] = nodes * (nb + 1) + W * (20 + nb + 1 + 4) \
            + tot_e * (12 + 1) + blocks.numel() * 4
        row["library_ms"] = None
        row["bound_ms"] = row["bytes"] / PEAK_BYTES_PER_S * 1e3
        row["bound_by"] = "bytes"
        row["bound_share"] = _share(row["bound_ms"], row["device_ms"])
    return row


def step_fires(wt, rng):
    """The fire buffers of K4's cases: ``(fires, long_fires)``, by
    (layout, W) from the HC window's own packer (each window of 4 panes,
    two a slot, the step evicting the panes it slides past), and by W on
    the long ring (``_long_fire``)."""
    from windflow_tpu_torch import WinType
    from windflow_tpu_torch.gpu.ffat_gpu import Ffat_Windows_GPU
    op = Ffat_Windows_GPU(lambda f: f, wt.fieldwise(value="sum"), "key",
                          WIN_US, SLIDE_US, WinType.TB, 0, None,
                          key_capacity=HC_KEYS)
    op.build_replicas()
    rep = op.replicas[0]
    if (rep.K_cap, rep.F) != (STEP_K_CAP, STEP_F):
        fail(f"K2+K3/K4: the HC window's forest is {rep.K_cap} x {rep.F}")
    fires = {}
    for lay, widths in STEP_QUERY_W.items():
        K = STEP_LAYOUTS[lay][0]
        for W in widths:
            slots = np.sort(rng.choice(min(K, HC_KEYS), W // 2,
                                       replace=False))
            start0 = rng.integers(0, 1000, len(slots))
            chunks = (slots, start0, np.full(len(slots), 2),
                      np.arange(len(slots)), start0 + 5)
            fires[lay, W] = rep._pack_fire_arrays(chunks, W, W)
    KL, FL, WL = STEP_LONG
    return fires, {W: _long_fire(rng, KL, FL, W) for W in WL}


def step_cases(torch, wt, name, batches, fires, long_fires, gen, card,
               timed_only=False, query=True):
    """Every case of one variant (see ``ffat_step_phase``), yielded as
    ((kernel, variant, layout[, W]), row); ``timed_only``: the timed
    cases alone; ``query``: K4's cases too."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    F = STEP_F
    dev = torch.device("cuda")
    dtypes, comb, lift = _step_spec(torch, wt, name)
    tag = fr.variant(comb, dtypes).tag
    for lay, batch in batches.items():
        timed = _step_timed(name, lay)
        if timed_only and not timed:
            continue
        row, kflat, kvflat = step_ingest_case(
            torch, name, comb, lift, dtypes, lay, batch, gen, timed)
        row.update(tag=tag, card=card)
        yield ("ingest", name, lay), row
        if not query or lay not in STEP_QUERY_W:
            del kflat, kvflat
            continue
        # K4 on the forest the fold left, rebuilt by K1
        K = STEP_LAYOUTS[lay][0]
        fr.forest_rebuild({k: t.view(K, 2 * F) for k, t in kflat.items()},
                          kvflat.view(K, 2 * F), comb)
        ktable = torch.arange(K, dtype=torch.int32, device=dev)
        for W in STEP_QUERY_W[lay]:
            buf, E = fires[lay, W]
            row = step_query_case(torch, name, comb, kflat, kvflat, F, buf,
                                  W, E, ktable, timed)
            row.update(tag=tag, layout=lay, card=card)
            yield ("query", name, lay, W), row
        del kflat, kvflat
    # K4 on a long ring
    if not query or (timed_only and name != "fieldwise"):
        return
    KL, FL, _ = STEP_LONG
    trees, tvalid = _typed_forest(torch, KL, FL, dtypes, gen)
    fr.forest_rebuild(trees, tvalid, comb)
    flat = {k: t.reshape(-1) for k, t in trees.items()}
    ktable = torch.arange(KL, dtype=torch.int32, device=dev)
    for W, (buf, E) in long_fires.items():
        row = step_query_case(torch, name, comb, flat, tvalid.reshape(-1),
                              FL, buf, W, E, ktable, name == "fieldwise")
        row.update(tag=tag, layout="long_ring", card=card)
        yield ("query", name, "long_ring", W), row


def ffat_step_phase(torch, wt, card):
    """Phase ``programs``, K2+K3 and K4: for each variant a main path runs
    (and, untimed, the fieldwise library's other combines), one batch of
    every STEP_LAYOUTS layout folded into a random forest (1% of float
    values NaN) through the kernel and its plain version; on the forests
    of the main paths' layouts, rebuilt by K1, fire steps of STEP_QUERY_W
    windows; then K4 on a K_cap 256 x F 1,024 forest with windows of up
    to F panes (``step_fires``). K2+K3 exact on int and bool planes and
    within STEP_FOLD_RTOL on float ones, K4 bit-identical (values, valid,
    keys and the evicted forest). Timed rows (``_step_timed``): device
    time (``torch.profiler``), launches and the event bracket of the
    wrapper (L2 warm, as after the path's previous kernel), the plain
    version's event bracket, the bytes bound and, for the fieldwise sum,
    ``scatter_reduce_``'s time. Returns the rows by (kernel, variant,
    layout[, W]) and the largest absolute difference by (kernel,
    variant)."""
    rng = np.random.default_rng(17)
    gen = torch.Generator().manual_seed(17)
    batches = {lay: step_batch(lay, rng) for lay in STEP_LAYOUTS}
    fires, long_fires = step_fires(wt, rng)
    phase("programs", card=card, **step_back_to_back_case(torch, wt, rng))
    rows, errs = {}, {}
    for name in STEP_VARIANTS + STEP_CHECKED:
        errs["query", name] = 0.0  # K4: bit-identical or failed
        for key, row in step_cases(torch, wt, name, batches, fires,
                                   long_fires, gen, card):
            if key[0] == "ingest":
                errs["ingest", name] = max(errs.get(("ingest", name), 0.0),
                                           row["max_abs_err"])
            rows[key] = row
            phase("programs", **row)
    # the fieldwise library's kernels line: its largest error over every
    # fieldwise combine checked here
    for kind in ("ingest", "query"):
        errs[kind, "fieldwise"] = max(errs[kind, n] for n in
                                      ("fieldwise",) + STEP_CHECKED)
    return rows, errs


PROFILED_BATCHES = 10


def main_path_profiled_part(torch, wt, card):
    """Phase ``main_path``, part ``profiled``: PROFILED_BATCHES batches of
    each main path (10,240 keys and 64 keys) through ``PipeGraph`` under
    ``torch.profiler``: kernels and copies a batch, the card's busy time
    and idle share over the run (graph start and end included). It runs
    after the kernels' timing: the profiler's tracing slows later FFAT
    runs."""
    for name, n_keys, wpb in (("high_cardinality", HC_KEYS, None),
                              ("64_keys", 64, 128)):
        blocks = _blocks(n_keys, seed=7, n_batches=PROFILED_BATCHES)
        prof = _profiled(torch, lambda: _run_graph(
            wt, "cuda", blocks, n_keys, wpb), len(blocks))
        phase("main_path", part="profiled", config=name, keys=n_keys,
              batches=len(blocks), batch=BATCH, card=card, **prof)


def _sync_cards(torch):
    """Wait for every card (a mesh over card groups may use them all)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _profiled(torch, run, n_batches):
    """One run of ``run`` under ``torch.profiler``: the wall time, the
    card's busy time (kernels and copies) and idle share, and kernels and
    copies per batch."""
    from torch.profiler import ProfilerActivity, profile
    _sync_cards(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync_cards(torch)
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
        fold_launches = _reduce_launched(
            f"graph_gpu {name}", "keyed_fold" if keyed else "tree_reduce")
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
                                            ops[2]["replicas"]),
                         fold_launches=fold_launches)
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
            _reduce_launched(f"fusion {kind} megabatch {k}",
                             "keyed_fold" if keyed else "tree_reduce")
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
    if device == "cuda":
        _reduce_reset()
    graph.run()
    t_end = time.perf_counter()
    if device == "cuda":
        _reduce_read()
    return parts, t_yield, t_end, graph


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


# K8's launches by traced step (tag), from the state and mesh phases' runs
# on the card, the counts set to 0 just before each run
K8_PATH = Counter()


def _k8_reset():
    from windflow_tpu_torch.kernels import grid_scan as gs
    with gs._count_lock:
        gs.LAUNCHES = 0
        gs.VARIANT_LAUNCHES.clear()


def _k8_launched(name):
    """K8's launches since ``_k8_reset`` (added to ``K8_PATH``); fails if
    the run launched none."""
    from windflow_tpu_torch.kernels import grid_scan as gs
    with gs._count_lock:
        n, by_tag = gs.LAUNCHES, Counter(gs.VARIANT_LAUNCHES)
    if n <= 0:
        fail(f"{name}: K8's kernel (grid_scan) never launched")
    K8_PATH.update(by_tag)
    return n


def _state_part(torch, wt, card, name, blocks, make_ops, check, extra=None,
                **kw):
    """One part: the graph on the card and on the CPU (rows equal, and
    ``check`` holds them against the numpy fold), tuples/s after the
    warm-up, K8's launches, then one profiled run on the card."""
    torch.cuda.synchronize()
    _k8_reset()
    grun = _run_state_graph(wt, "cuda", blocks, make_ops, **kw)
    k8 = _k8_launched(f"state {name}")
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
               wall_s=grun[2] - grun[1][0], k8_launches=k8)
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
    rates, stages, fused, k8 = {}, {}, {}, {}
    for k in (1, 4, 0, 0, 4, 1):  # 0: unfused
        _k8_reset()
        run = _run_state_graph(wt, "cuda", blocks, _fused_state_ops,
                               fusion=k > 0, megabatch=max(1, k), **common)
        k8.setdefault(k, []).append(_k8_launched(f"state fused {k}"))
        _reduce_launched(f"state fused {k}", "keyed_fold")
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
               k8_launches={("unfused" if k == 0 else f"megabatch_{k}"): v
                            for k, v in k8.items()},
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
        _k8_reset()
        got = run()
        row["k8_launches"] = _k8_launched("state tiered")
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


K8_REPS = 10         # kernel calls timed a layout
K8_PLAIN_REPS = (10, 2)  # plain-version calls timed: M < 512, else (the
                         # smap batch's 2,048 steps take ~0.6 s a call)
K8_ZIPF_ROWS = 8192  # the Zipf batch: its hot key holds ~10% of the rows
K8_TIER_AFTER = 40   # the tiered layout: the batch after this many blocks
K8_PATH_LAYOUT = {"smap": "smap", "sfilter": "sfilter", "tier": "tier"}
K8_EDGE_ROWS = 8192  # the edges batch: runs at the regimes' edges
K8_EDGE_MAX_RUN = 1024  # its longest run (the plain version's M)
K8_CHAIN_CYCLES = 4  # the chain bound: one dependent instruction a row
K8_WIDE_INTS = 63    # the wide step reads 63 int32 columns and one bool
_SM_MHZ = []


def _max_sm_mhz():
    """The card's maximum SM clock, MHz (``nvidia-smi``)."""
    if not _SM_MHZ:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60)
        if smi.returncode != 0:
            fail("nvidia-smi: " + smi.stderr.strip())
        _SM_MHZ.append(float(smi.stdout.split()[0]))
    return _SM_MHZ[0]


def _k8_wide_fn(row, st):
    """A step that reads ``grid_scan.MAX_COLUMNS`` row columns (63 int32
    and one bool): its library must build with no spill."""
    t = st + row["b"].int()
    for i in range(K8_WIDE_INTS):
        t = t + row[f"c{i}"] * (i + 1)
    return {"o": t}, t


def _k8_wide_spec(torch):
    cols = {f"c{i}": torch.zeros(1, dtype=torch.int32)
            for i in range(K8_WIDE_INTS)}
    cols["b"] = torch.zeros(1, dtype=torch.bool)
    return _k8_wide_fn, False, cols, torch.zeros(1, dtype=torch.int32)


def _k8_engine(torch, wt, func, filter_mode, state_init, key, tiering=None):
    """A fresh stateful replica's engine on the card (its table, key map
    and prep: the layout a graph's batch gets)."""
    dev = torch.device("cuda")
    cls = wt.Filter_GPU if filter_mode else wt.Map_GPU
    op = cls(func, name="k8", key_extractor=key, state_init=state_init,
             tiering=tiering)
    op.configure(wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT_TIME, dev)
    op.build_replicas()
    return op.replicas[0].engine


def _k8_bytes(torch, v, fields, rows, n, leaves):
    """Bytes the function must move on this run's rows (each input read
    once, each output written once): the columns the step reads
    (``v.reads``; a pass-through column moves no byte) and ``valid`` on
    the rows the keys walk, ``order`` on every row when the step writes a
    column (the rows no key walks get zeros through it) else on the
    walked rows, ``starts`` and ``touched`` of the touched keys, the
    computed columns or the keep byte written on every row, and the
    touched table rows read and written with their dirty bytes."""
    nt = rows.n_touched
    walked = int(rows.starts[nt])
    row_in = sum(fields[f].element_size() for f in v.reads)
    row_out = sum(torch.empty(0, dtype=dt).element_size()
                  for dt in v.out_dtypes)
    state = sum(lf.element_size() for lf in leaves)
    return (walked * (row_in + 1) + 4 * (n if row_out else walked)
            + 4 * (nt + 1) + 4 * nt + n * row_out + nt * (2 * state + 1))


def _k8_regimes(rows):
    """(longest run, keys in the thread regime, keys in the block
    regime, the threshold or None) of a launch's ``KeyRows``."""
    nt = rows.n_touched
    runs = np.diff(rows.starts.cpu().numpy().astype(np.int64)[:nt + 1])
    longest = int(runs.max()) if nt else 0
    if rows.heavy is None or not rows.heavy_blocks:
        return longest, nt, 0, None
    hl = rows.heavy.cpu().numpy()
    hl = hl[hl >= 0]
    block = int(np.count_nonzero(runs[hl] >= rows.heavy_rows))
    return longest, nt - block, block, rows.heavy_rows


def _k8_case(torch, layout, eng, fields, valid, rows, card, timed_only=False,
             plain_reps=None):
    """K8's kernel against its plain version on the card, on the same
    inputs and copies of the same table: the output columns on the rows
    ``valid`` admits (on the others they carry no meaning), the table
    rows ``[0, T_cap)`` and ``dirty[:T_cap]``, bit for bit; then the
    kernel's and (unless ``timed_only``) the plain version's device time,
    launches and event bracket; the regimes (longest run, keys in each,
    ns a row on the longest run), the bound (bytes) and the chain bound
    beside it (the longest run at ``K8_CHAIN_CYCLES`` cycles a row at the
    card's maximum SM clock: a floor of the design, not the bound)."""
    from windflow_tpu_torch.kernels import grid_scan as gs
    from windflow_tpu_torch.pytree import tree_flatten, tree_unflatten
    leaves, spec = tree_flatten(eng.table)
    T = eng.table_capacity
    n = valid.shape[0]
    KB = rows.touched.shape[0]

    def copy():
        return (tree_unflatten(spec, [lf.clone() for lf in leaves]),
                eng.dirty.clone())

    tk, dk = copy()
    kout = gs.grid_walk(eng.step, fields, valid, rows, tk, dk)
    tp, dp = copy()
    grid_idx, tmask, M = gs.grid_of(rows, n)
    core = gs.grid_scan_core(eng.step.func, eng.step.filter_mode, M, KB)
    pout = core(fields, valid, grid_idx, rows.touched, tmask, tp, dp)
    torch.cuda.synchronize()
    pairs = ([(kout, pout)] if not isinstance(kout, dict)
             else [(kout[f], pout[f]) for f in pout])
    err = 0.0
    for a, b in pairs:
        a, b = a[valid], b[valid]
        if a.dtype != b.dtype:
            fail(f"K8 {layout}: the kernel's output is {a.dtype}, the "
                 f"plain version's {b.dtype}")
        if a.dtype is torch.float32:
            same = torch.equal(a.view(torch.int32), b.view(torch.int32))
            err = max(err, float((a - b).abs().max()) if a.numel() else 0.0)
        else:
            same = torch.equal(a, b)
        if not same:
            fail(f"K8 {layout}: outputs differ from the plain version")
    for a, b in zip(tree_flatten(tk)[0], tree_flatten(tp)[0]):
        if not torch.equal(a[:T].view(torch.uint8), b[:T].view(torch.uint8)):
            fail(f"K8 {layout}: the table differs from the plain version's")
    if not torch.equal(dk[:T], dp[:T]):
        fail(f"K8 {layout}: dirty differs from the plain version's")
    device_ms, launches, bracket = _program_ms(
        torch, lambda: gs.grid_walk(eng.step, fields, valid, rows, tk, dk),
        reps=K8_REPS)
    preps = plain_reps or K8_PLAIN_REPS[M >= 512]
    plain_ms = plain_launches = plain_bracket = None
    if not timed_only:
        plain_ms, plain_launches, plain_bracket = _program_ms(
            torch, lambda: core(fields, valid, grid_idx, rows.touched, tmask,
                                tp, dp), reps=preps)
    v = eng.step.variant(fields, tk)
    nbytes = _k8_bytes(torch, v, fields, rows, n, leaves)
    longest, n_thread, n_block, hr = _k8_regimes(rows)
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    chain_bound = longest * K8_CHAIN_CYCLES / (_max_sm_mhz() * 1e3)
    tile = gs.tile_rows(v.load())
    row = dict(program="K8_grid_scan", layout=layout,
               replaces="windflow_tpu/tpu/ops_tpu.py:212",
               source="windflow_tpu_torch/kernels/grid_scan.cuh",
               route="cuda", tag=v.tag,
               rows=n, keys=rows.n_touched, M=M, KB=KB, table_rows=T,
               longest_run=longest, thread_keys=n_thread,
               block_keys=n_block, heavy_rows=hr, tile_rows=tile,
               bit_identical=True, max_abs_err=err, calls=K8_REPS,
               device_ms=device_ms, launches=launches, wrapper_ms=bracket,
               ns_per_row=(None if device_ms is None or not longest
                           else device_ms * 1e6 / longest),
               plain_calls=None if timed_only else preps,
               plain_device_ms=plain_ms, plain_launches=plain_launches,
               plain_ms=plain_bracket, bytes=nbytes,
               bound_ms=bound, bound_by="bytes",
               bound_share=_share(bound, device_ms),
               chain_bound_ms=chain_bound, max_sm_mhz=_max_sm_mhz(),
               chain_share=_share(chain_bound, device_ms), library_ms=None,
               card=card)
    return row


def _k8_graph_case(torch, wt, layout, func, filter_mode, state_init, cols,
                   card, key="key", valid=None, table_rows=None, **kw):
    """One layout through a fresh engine's prep (``cols`` a numpy batch,
    its own capacity; ``valid`` a mask with holes, or every row)."""
    eng = _k8_engine(torch, wt, func, filter_mode, state_init, key)
    from types import SimpleNamespace
    n = len(cols[key])
    if table_rows is not None:
        eng._ensure_table(table_rows)
    rows = eng.prep(SimpleNamespace(
        size=n, capacity=n, host_keys=cols[key].astype(np.int64)))
    dev = torch.device("cuda")
    fields = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
    v = torch.ones(n, dtype=torch.bool, device=dev) if valid is None \
        else torch.from_numpy(valid).to(dev)
    return _k8_case(torch, layout, eng, fields, v, rows, card, **kw)


def _k8_tier_case(torch, wt, card, **kw):
    """The tiered part's layout: the 512-row block of ``_tier_blocks``
    after ``K8_TIER_AFTER`` others, on an engine whose table is the
    1,024-slot hot tier (LRU, the cold tail in sqlite under ``build/``),
    after those blocks ran through it on the card; each batch's tier moves
    land from the dispatch queue ahead of its scan, as in a graph."""
    from types import SimpleNamespace
    eng = _k8_engine(torch, wt, _tier_fn, False, np.float32(0), "k",
                     tiering=wt.TierConfig(
                         "lru", TIER_HOT,
                         os.path.join(HERE, "build", "tier_db")))
    dev = torch.device("cuda")
    for i, (cols, _, _) in enumerate(_tier_blocks()[:K8_TIER_AFTER + 1]):
        n = len(cols["k"])
        rows = eng.prep(SimpleNamespace(
            size=n, capacity=n, host_keys=cols["k"].astype(np.int64)))
        eng.replica.dispatch.drain()
        fields = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        if i < K8_TIER_AFTER:
            eng.run(fields, valid, rows)
    if eng.tier.demoted_keys == 0:
        fail("K8 tier: no key was demoted before the layout's batch")
    return _k8_case(torch, "tier", eng, fields, valid, rows, card, **kw)


def _k8_mesh_case(torch, wt, blocks, card, **kw):
    """One Map_Mesh step at (4, 2) on one group of the card (the mesh
    part ``ops``'s stateful map at 10,240 keys): the step groups each
    group's received lanes on the device and launches K8 there; that
    launch's inputs are held against the plain version (``_k8_case``)."""
    from types import SimpleNamespace
    from windflow_tpu_torch.mesh import core as mcore
    cols, _, _ = blocks[STATE_WARMUP]
    dev = torch.device("cuda")
    seen = []
    real = mcore.grid_walk

    def spy(step, fields, valid, rows, table, dirty):
        seen.append((step, {k: v.clone() for k, v in fields.items()},
                     valid.clone(), rows, table, dirty))
        return real(step, fields, valid, rows, table, dirty)

    prev = mcore.virtual_device_groups()
    mcore.ensure_virtual_devices(MESH_VDEV)
    mcore.grid_walk = spy
    try:
        mesh = mcore.make_key_mesh(MESH_VDEV, shape=(4, 2), device="cuda")
        lb = BATCH // mcore.mesh_shard_count(mesh)
        slots = torch.from_numpy(cols["key"]).to(dev)
        step, (K_pad, _, GB) = mcore.sharded_grid_scan(
            mesh, _smap_fn, False, HC_KEYS, None, lb)
        table = mcore.make_mesh_table(mesh, {"n": np.int32(0)}, K_pad)
        gpos = torch.arange(GB, dtype=torch.int32, device=dev)
        vals = {k: torch.from_numpy(v).to(dev) for k, v in cols.items()}
        step(table, slots, gpos, vals)
        torch.cuda.synchronize()
    finally:
        mcore.grid_walk = real
        mcore.ensure_virtual_devices(MESH_VDEV, group_devices=prev)
    if len(seen) != 1:
        fail(f"K8 mesh: {len(seen)} launches for one group")
    gstep, fields, valid, rows, table, dirty = seen[0]
    eng = SimpleNamespace(step=gstep, table=table, dirty=dirty,
                          table_capacity=dirty.shape[0] - 1)
    return _k8_case(torch, "mesh_4x2", eng, fields, valid, rows, card, **kw)


def _k8_edge_runs(torch):
    """The ``edges`` batch's run lengths: at the kernel's threshold
    (``HEAVY_ROWS`` - 1, itself, + 1) and the smap step's ring tile (one
    tile - 1, one, + 1, two + 1, the ring of four - 1 and whole, up to
    ``K8_EDGE_MAX_RUN``)."""
    from windflow_tpu_torch.kernels import grid_scan as gs
    spec = _k8_step_specs(torch)["smap"]
    hr, tile = gs.HEAVY_ROWS, gs.tile_rows(gs.step_variant(*spec).load())
    runs = [hr - 1, hr, hr + 1, tile - 1, tile, tile + 1, 2 * tile + 1,
            4 * tile - 1, 4 * tile]
    return sorted({r for r in runs if 0 < r <= K8_EDGE_MAX_RUN}
                  | {K8_EDGE_MAX_RUN})


def _k8_edge_cols(torch, rng):
    """The ``edges`` batch: one key a run of ``_k8_edge_runs``, the rest
    of ``K8_EDGE_ROWS`` rows in keys of 1-16 rows, arrival shuffled."""
    runs = _k8_edge_runs(torch)
    fill, left = [], K8_EDGE_ROWS - sum(runs)
    while left > 0:
        fill.append(min(left, int(rng.integers(1, 17))))
        left -= fill[-1]
    keys = np.repeat(np.arange(len(runs) + len(fill), dtype=np.int32),
                     runs + fill)
    rng.shuffle(keys)
    return {"key": keys,
            "value": rng.integers(0, 100, len(keys)).astype(np.int32)}


def _k8_wide_cols(rng):
    """The wide step's batch: 2,048 rows, four keys of 100-256 rows (the
    block regime, tiles of a few rows) and the rest in keys of 1-8."""
    runs = [100, 150, 200, 256]
    left = 2048 - sum(runs)
    while left > 0:
        runs.append(min(left, int(rng.integers(1, 9))))
        left -= runs[-1]
    keys = np.repeat(np.arange(len(runs), dtype=np.int32), runs)
    rng.shuffle(keys)
    cols = {f"c{i}": rng.integers(-1000, 1000, len(keys)).astype(np.int32)
            for i in range(K8_WIDE_INTS)}
    cols["b"] = rng.random(len(keys)) < 0.5
    cols["key"] = keys
    return cols


def k8_layouts(torch, wt, blocks, card, timed_only=False):
    """K8 at every ``programs`` layout: ``smap`` (one 64-key batch of the
    smap part: 64 serial chains of ~1,024 rows), ``hc`` (10,240 keys),
    ``huge`` (keys over 2^20, the table grown to 2^20 rows), ``zipf``
    (Zipf 1.1 over 10^7 keys, the tiered part's float32 scan on 8,192
    rows and a fresh table: one hot key's chain holds the launch),
    ``tier`` (the part ``tiered`` layout, ``_k8_tier_case``), ``holes``
    (a fused chain's ``valid`` with holes: the graph_gpu filter's mask
    over 256 keys), ``sfilter`` (the running-max filter at 10,240 keys),
    ``mesh_4x2`` (one Map_Mesh step), ``edges`` (runs at the regimes'
    threshold and tile edges, ``_k8_edge_runs``) and ``wide`` (a step
    reading 64 columns, one bool). Returns the rows by layout."""
    st = {"n": np.int32(0)}
    out = {}
    kw = dict(timed_only=timed_only)
    cols, _, _ = blocks[STATE_WARMUP]
    out["smap"] = _k8_graph_case(torch, wt, "smap", _smap_fn, False, st,
                                 cols, card, **kw)
    hb = _blocks(HC_KEYS, seed=22, n_batches=1, batch=BATCH)[0][0]
    out["hc"] = _k8_graph_case(torch, wt, "hc", _smap_fn, False, st, hb,
                               card, **kw)
    ub = _blocks(HUGE_KEYS, seed=22, n_batches=1, batch=BATCH)[0][0]
    out["huge"] = _k8_graph_case(torch, wt, "huge", _smap_fn, False, st, ub,
                                 card, table_rows=HUGE_KEYS, **kw)
    rng = np.random.default_rng(11)
    zk = ((rng.zipf(1.1, size=K8_ZIPF_ROWS) - 1) % TIER_KEY_SPACE).astype(
        np.int32)
    out["zipf"] = _k8_graph_case(
        torch, wt, "zipf", _tier_fn, False, np.float32(0),
        {"k": zk, "v": np.arange(K8_ZIPF_ROWS, dtype=np.float32)}, card,
        key="k", **kw)
    out["tier"] = _k8_tier_case(torch, wt, card, **kw)
    gb = _blocks(GRAPH_KEYS, seed=24, n_batches=1, batch=BATCH)[0][0]
    keep = (gb["value"].astype(np.int64) * 3 + gb["key"]) % 2 == 0
    out["holes"] = _k8_graph_case(torch, wt, "holes", _smap_fn, False, st,
                                  gb, card, valid=keep, **kw)
    fb = _blocks(HC_KEYS, seed=23, n_batches=1, batch=BATCH)[0][0]
    out["sfilter"] = _k8_graph_case(torch, wt, "sfilter", _run_max_fn, True,
                                    {"mx": np.int32(0)}, fb, card, **kw)
    out["mesh_4x2"] = _k8_mesh_case(
        torch, wt, _blocks(HC_KEYS, seed=73, n_batches=STATE_WARMUP + 1,
                           batch=BATCH), card, **kw)
    rng = np.random.default_rng(29)
    out["edges"] = _k8_graph_case(torch, wt, "edges", _smap_fn, False, st,
                                  _k8_edge_cols(torch, rng), card, **kw)
    out["wide"] = _k8_graph_case(torch, wt, "wide", _k8_wide_fn, False,
                                 np.int32(0), _k8_wide_cols(rng), card,
                                 plain_reps=1, **kw)
    return out


def state_programs_phase(torch, wt, blocks, card):
    """K8 (the JAX package's ``_grid_scan_core``, XLA there; a hand kernel
    with the step compiled in here, ``kernels/grid_scan.cuh``) against its
    plain version (``grid_scan_core``: M steps of ``torch.func.vmap``) on
    the card, bit for bit, at ``k8_layouts``' layouts. Each line: device
    time, launches and event bracket of the kernel and of the plain
    version, the regimes, and the bound. Returns the rows by layout."""
    out = k8_layouts(torch, wt, blocks, card)
    for row in out.values():
        phase("programs", **row)
    return out


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
    if device == "cuda":
        _reduce_reset()
    graph.run()
    if device == "cuda":
        _reduce_read()
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
    _reduce_launched("dag diamond", "keyed_fold")
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
    _reset_launches(fr)
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
            or launches.total() != k1["batch_launches"] \
            + k1["dataless_launches"]:
        fail(f"dag merge_ffat: K1 launched {launches.total()} times for "
             f"{k1['firing_batches']} firing batches ({k1})")
    phase("dag", part="merge_ffat", keys=HC_KEYS, sources=2,
          batches=DAG_BATCHES, warmup=DAG_WARMUP, batch=BATCH, card=card,
          windows_total=int(len(gcols["key"])),
          valid_windows=int(gcols["valid"].sum()), rows_equal_cpu=True,
          **k1, rebuild_launches=launches.total(),
          tuples_per_s=_dag_rate(n_tuples, t_yield, gparts), wall_s=wall,
          profiled=_profiled(torch, lambda: _run_merge_ffat(wt, "cuda",
                                                             halves),
                             DAG_BATCHES))
    return launches


# ---------------------------------------------------------------------------
# phase recovery: kill and restore on the card
# ---------------------------------------------------------------------------
REC_BATCHES, REC_CKPT_AT, REC_CRASH_AT, REC_EVERY = 24, 8, 16, 4
SETTLE_WAIT_S = 60.0  # _ReplayBlocks(settle=): the longest commit wait


class _InjectedCrash(Exception):
    """The fault a recovery part injects into its own source."""


class _ReplayBlocks:
    """Replayable block source: pushes one block per step (EVENT_TIME),
    requests a checkpoint after block ``ckpt_at`` or every ``every``
    blocks, and raises before block ``crash_at``. Its position counts the
    blocks pushed, so a restore replays from the snapshot's block;
    ``first`` is the block it pushed first. With ``settle`` (a checkpoint
    store's directory) it requests an epoch, and raises, only once every
    epoch it requested before is committed there."""

    def __init__(self, blocks, ckpt_at=None, crash_at=None, every=0,
                 settle=None):
        self.blocks, self.ckpt_at, self.crash_at = blocks, ckpt_at, crash_at
        self.every = every
        self.settle = settle
        self.requested = 0
        self.pos = 0
        self.first = None
        self.t_yield = []

    def _settle(self):
        if self.settle is None or not self.requested:
            return
        from windflow_tpu_torch.checkpoint import CheckpointStore
        st = CheckpointStore(self.settle)
        deadline = time.monotonic() + SETTLE_WAIT_S
        while (st.latest() or 0) < self.requested:
            if time.monotonic() > deadline:  # a worker thread: raise
                raise RuntimeError(f"epoch {self.requested} was not "
                                   f"committed within {SETTLE_WAIT_S} s")
            time.sleep(0.002)

    def __call__(self, shipper):
        while self.pos < len(self.blocks):
            if self.pos == self.crash_at:
                self._settle()
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
                self._settle()
                shipper.request_checkpoint()
                self.requested += 1

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
    _reset_launches(fr)
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
    _reset_launches(fr)
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
    launches = Counter()
    if part == "ffat":
        launches = _launched("recovery ffat", fr,
                             rgraph._stages[1].first_op.replicas[0])
        if launches.total() >= gold_launches:
            fail(f"recovery ffat: the restored run launched K1 "
                 f"{launches.total()} "
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
          rebuild_launches_restored=launches.total(),
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
        return sum((recovery_part(torch, wt, card, part, cuts)
                    for part in ("smap", "ffat", "fused")), Counter())
    finally:
        (wmod.Worker.checkpoint_now, wmod.Worker._capture_blobs,
         Coord.ack) = orig


# ---------------------------------------------------------------------------
# phase delta: incremental and asynchronous checkpoints on the card
# ---------------------------------------------------------------------------
DELTA_EVERY, DELTA_FULL_EVERY = 4, 8
DELTA_MODES = (
    ("full", {}),
    ("delta", {"delta": True, "full_every": DELTA_FULL_EVERY}),
    ("delta_async", {"delta": True, "async_upload": True,
                     "full_every": DELTA_FULL_EVERY}))
# epochs listed one by one on a part's line (the rest are summarized)
DELTA_LISTED = 8
# ffat_tumbling's window: 6.24 batches of event time (a batch spans
# 51,249 us), so it fires in batches 7, 13 and 19, and the epochs of
# batches 8-11 and 20-23 see no firing
TUMBLE_US = 320_000


def _tumbling_ops(wt):
    return [wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                        wt.fieldwise(value="sum"))
            .with_key_by("key").with_tb_windows(TUMBLE_US, TUMBLE_US)
            .with_key_capacity(HC_KEYS).with_name("ffat").build()]


def _delta_parts(wt):
    """(part, blocks, operators (a function of wt), chained, megabatch,
    batch, the engine's op name). smap_hc: the stateful map at 1,048,576
    keys over 24 batches (the table grows to 2^20 rows); ffat: the HC main
    path; ffat_tumbling: the HC stream into a tumbling window longer than
    the checkpoint interval, 24 batches (``TUMBLE_US``: its epochs without
    a firing are deltas); fused: map -> smap -> filter chained at
    megabatch 4; tiered:
    bench.py's run_tiered stream (Zipf 1.1 over 10^7 keys, 1,024 hot
    slots, 512-row float32 batches)."""
    db_dir = os.path.join(HERE, "build", "tier_db")
    return (
        ("smap_hc", _blocks(HUGE_KEYS, seed=51, n_batches=24, batch=BATCH),
         _smap_ops, False, 1, BATCH, "smap"),
        ("ffat", _blocks(HC_KEYS, seed=52, n_batches=16, batch=BATCH),
         lambda wt: _rec_ops(wt, "ffat"), False, 1, BATCH, "ffat"),
        ("ffat_tumbling", _blocks(HC_KEYS, seed=54, n_batches=24,
                                  batch=BATCH),
         _tumbling_ops, False, 1, BATCH, "ffat"),
        ("fused", _blocks(HC_KEYS, seed=53, n_batches=16, batch=BATCH),
         lambda wt: _rec_ops(wt, "fused"), True, 4, BATCH, "m"),
        ("tiered", _tier_blocks(), _tier_ops(True, db_dir), False, 1,
         TIER_BATCH, "scan"))


def _run_delta_graph(wt, device, part, src, store, ckpt, restore_from=None,
                     crash=False):
    """Replayable source -> the part's operators -> columnar sink,
    checkpointing into ``store`` with ``with_checkpointing(**ckpt)`` (every
    epoch kept on disk). Returns the sink's batches and the graph; with
    ``crash`` the run must end in the source's injected crash."""
    name, _, make_ops, chained, megabatch, batch, _ = part
    parts, sink = _sink_parts()
    graph = wt.PipeGraph(f"delta_{name}", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device,
                         megabatch=megabatch)
    graph.with_checkpointing(store_dir=store, retain=1 << 10, **ckpt)
    mp = graph.add_source(wt.Source_Builder(src).with_name("src")
                          .with_output_batch_size(batch).build())
    for i, op in enumerate(make_ops(wt)):
        mp = mp.chain(op) if (chained and i) else mp.add(op)
    mp.add_sink(wt.Sink_Builder(sink).with_columns().build())
    try:
        graph.run(restore_from)
    except _InjectedCrash:
        if not crash:
            raise
    else:
        if crash:
            fail(f"delta {name}: the injected crash did not end the run")
    return parts, graph


def _delta_epochs(graph, cuts, store, async_upload, writes):
    """Per committed epoch: FULL or delta (a blob of it has ``deps``), its
    blobs' bytes (logical: what was pickled, refs included; on disk: the
    files its directory holds), the slowest worker's cut split into the
    drain, the capture and the write (sync) or the register (async), the
    upload time (async), the commit ms, and its blob writes (all workers,
    wherever they ran) split into pickle, sha256 and the fsync'd write
    (``writes``, by epoch)."""
    from windflow_tpu_torch.checkpoint import CheckpointStore
    rows = []
    for h in graph._coordinator.history:
        cid = h["ckpt_id"]
        d = CheckpointStore(store)._dirname(cid)
        man = CheckpointStore.load_manifest(d)
        mine = [c for c in cuts if c[0] == cid]
        slow = max(mine, key=lambda c: c[1], default=(0, 0.0, 0.0, 0.0, 0.0))
        row = dict(ckpt_id=cid, kind="delta" if man.get("deps") else "FULL",
                   refs=len(man.get("refs") or {}), bytes=h["bytes"],
                   bytes_on_disk=sum(os.path.getsize(os.path.join(d, f))
                                     for f in os.listdir(d)
                                     if f.endswith(".blob")),
                   cut_ms=slow[1], drain_ms=slow[1] - slow[3] - slow[4],
                   capture_ms=slow[3],
                   **{"register_ms" if async_upload else "write_ms":
                      slow[4]},
                   upload_ms=h["upload_s"] * 1e3,
                   commit_ms=h["commit_s"] * 1e3,
                   **{f"{k}_ms": v for k, v in writes.get(cid, {}).items()})
        rows.append(row)
    return rows


def _epoch_summary(rows):
    """Per kind: epochs and the means of the bytes and the cut split."""
    out = {}
    for kind in ("FULL", "delta"):
        sel = [r for r in rows if r["kind"] == kind]
        if sel:
            out[kind] = {k: (len(sel) if k == "epochs" else
                             sum(r[k] for r in sel) / len(sel))
                         for k in ("epochs", "bytes", "bytes_on_disk",
                                   "cut_ms", "drain_ms", "capture_ms",
                                   "write_ms", "register_ms", "upload_ms",
                                   "commit_ms", "pickle_ms", "sha256_ms",
                                   "fsync_write_ms")
                         if k == "epochs" or k in sel[0]}
    return out


# the engine state held across modes, by part: the other parts' blobs
# carry emitter fields that depend on the run, and the tiered one an
# sqlite image
DELTA_HELD = {"smap_hc": "scan", "ffat": "ffat", "ffat_tumbling": "ffat"}


def _same_tree(a, b):
    """Exact equality of two snapshot trees (dicts, lists, arrays)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(map(_same_tree, a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and bool(np.array_equal(a, b)))
    return a == b


def _hold_epochs(name, op, store, full_store):
    """Every epoch of a delta-mode run, materialized (a delta patched onto
    its base), must hold the engine state that the FULL-mode run's epoch
    at the same batch holds."""
    key = DELTA_HELD.get(name)
    if key is None:
        return
    from windflow_tpu_torch.checkpoint import CheckpointStore
    got, want = CheckpointStore(store), CheckpointStore(full_store)
    for cid in want.completed_ids():
        a, b = (st.load_states(st._dirname(cid),
                               st.load_manifest(st._dirname(cid)))[(op, 0)]
                for st in (got, want))
        if not _same_tree(a[key], b[key]):
            fail(f"delta {name}: epoch {cid} restores another {key} state "
                 "than the FULL run's epoch")


def delta_part(torch, wt, card, part, cuts, writes):
    """One part of phase ``delta``: the part's stream on the card with a
    checkpoint every DELTA_EVERY blocks, once in each mode (FULL sync,
    delta sync, delta + async, in turns; their outputs must be equal),
    and on the CPU; then a delta + async run, each epoch requested once
    the one before is committed, killed two blocks after the delta run's
    first delta epoch (after its second epoch where none is a delta, as
    for the HC window, whose every firing batch rebuilds the forest and
    so forces a FULL snapshot), restored with ``run(restore_from=...)``:
    the merged output must equal the card's and the CPU's uninterrupted
    runs, the restored source must resume at the checkpoint's block and
    emit nothing from before it, and (both ffat parts) K1 must launch
    fewer times than in the uninterrupted run. Returns K1's launches in
    the FULL-mode run and in the restored run (ffat parts), else 0."""
    from windflow_tpu_torch.checkpoint import CheckpointStore
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    name, blocks = part[0], part[1]
    n_batches, batch = len(blocks), part[5]
    t_part = time.perf_counter()
    is_ffat = name.startswith("ffat")
    rkey = "ffat" if is_ffat else "batches"
    modes, gold, gold_launches = {}, None, Counter()
    for mode, ckpt in DELTA_MODES:
        src = _ReplayBlocks(blocks, every=DELTA_EVERY)
        store = _ckpt_dir(f"delta_{name}_{mode}")
        cuts.clear()
        writes.clear()
        _reset_launches(fr)
        torch.cuda.synchronize()
        parts, g = _run_delta_graph(wt, "cuda", part, src, store, ckpt)
        if is_ffat:
            _launched(f"delta {name} {mode}", fr,
                      g._stages[1].first_op.replicas[0])
        out = _rec_results(rkey, parts)
        if gold is None:
            gold, gold_launches = out, _launch_counts(fr)
        elif out != gold:
            fail(f"delta {name}: the {mode} run's output differs from the "
                 "FULL run's")
        span = max(t for t, _ in parts) - src.t_yield[STATE_WARMUP]
        epochs = _delta_epochs(g, list(cuts), store,
                               ckpt.get("async_upload", False),
                               dict(writes))
        if len(epochs) != n_batches // DELTA_EVERY:
            fail(f"delta {name}: {mode}: {len(epochs)} epochs committed, "
                 f"not {n_batches // DELTA_EVERY}")
        ck = g.get_stats()["Checkpoints"]
        if ck["Checkpoint_async_pending"]:
            fail(f"delta {name}: {mode}: uploads still pending at the end")
        modes[mode] = dict(
            tuples_per_s=(n_batches - STATE_WARMUP) * batch / span,
            epochs_full=sum(e["kind"] == "FULL" for e in epochs),
            epochs_delta=sum(e["kind"] == "delta" for e in epochs),
            **{k: ck[k] for k in ("Checkpoint_delta_blobs",
                                  "Checkpoint_delta_bytes",
                                  "Checkpoint_full_bytes",
                                  "Checkpoint_async_uploads",
                                  "Checkpoint_upload_usec_total")},
            summary=_epoch_summary(epochs), epochs=epochs[:DELTA_LISTED])
        if mode == "full":
            full_store = store
        else:
            _hold_epochs(name, part[6], store, full_store)
    gold_cpu = _rec_results(rkey, _run_delta_graph(
        wt, "cpu", part, _ReplayBlocks(blocks), _ckpt_dir(f"delta_{name}_c"),
        {})[0])
    if gold != gold_cpu:
        fail(f"delta {name}: the card's uninterrupted run differs from the "
             "CPU run")
    # kill two blocks after the first delta epoch and restore. The crash
    # run requests each epoch only once the one before is committed: an
    # async epoch is a delta only if its base's upload has landed before
    # its capture, so unpaced its kinds vary from run to run; paced they
    # are the synchronous delta run's
    kinds = [e["kind"] for e in modes["delta"]["epochs"]]
    first_delta = kinds.index("delta") + 1 if "delta" in kinds else 2
    ckpt_block = first_delta * DELTA_EVERY
    crash_at = ckpt_block + 2
    if crash_at >= n_batches:
        fail(f"delta {name}: no block left to crash at after epoch "
             f"{first_delta}")
    async_ckpt = dict(DELTA_MODES)["delta_async"]
    store = _ckpt_dir(f"delta_{name}_crash")
    crash_parts = _run_delta_graph(
        wt, "cuda", part, _ReplayBlocks(blocks, every=DELTA_EVERY,
                                        crash_at=crash_at, settle=store),
        store, async_ckpt, crash=True)[0]
    st = CheckpointStore(store)
    cid = st.latest()
    if cid != first_delta:
        fail(f"delta {name}: the crash run's latest epoch is {cid}, not "
             f"{first_delta}")
    d = st.checkpoint_dir(cid)
    man = st.load_manifest(d)
    restored_kind = "delta" if man.get("deps") else "FULL"
    if name == "ffat_tumbling" and restored_kind != "delta":
        fail(f"delta {name}: epoch {cid}, taken without a firing since the "
             f"last, is not a delta (the delta run's epochs: {kinds})")
    states = st.load_states(d, man)
    if states[("src", 0)]["position"] != ckpt_block:
        fail(f"delta {name}: the checkpoint's source position is "
             f"{states[('src', 0)]['position']}, not {ckpt_block}")
    _reset_launches(fr)
    torch.cuda.synchronize()
    rsrc = _ReplayBlocks(blocks, every=DELTA_EVERY)
    t0 = time.perf_counter()
    rparts, rgraph = _run_delta_graph(wt, "cuda", part, rsrc, store,
                                      async_ckpt, restore_from=store)
    restored_run_s = time.perf_counter() - t0
    if rsrc.first != ckpt_block:
        fail(f"delta {name}: the restored source began at block "
             f"{rsrc.first}, not at the checkpoint's {ckpt_block}")
    restored = _rec_results(rkey, rparts)
    if not restored:
        fail(f"delta {name}: the restored run emitted nothing")
    launches = Counter()
    if is_ffat:
        launches = _launched(f"delta {name}", fr,
                             rgraph._stages[1].first_op.replicas[0])
        if launches.total() >= gold_launches.total():
            fail(f"delta {name}: the restored run launched K1 "
                 f"{launches.total()} times, the uninterrupted run "
                 f"{gold_launches.total()}")
        ff = states[("ffat", 0)]["ffat"]
        fired = {int(k): int(ff["fired"][s])
                 for k, s in ff["slot_of_key"].items()}
        again = sum(w < fired.get(k, 0) for k, w in restored)
        if not any(fired.values()) or again:
            fail(f"delta {name}: the checkpoint fired "
                 f"{sum(fired.values())} "
                 f"windows, and the restored run fired {again} of them "
                 "again")
    elif min(restored) < int(blocks[ckpt_block][1][0]):
        fail(f"delta {name}: the restored run emitted a batch from before "
             f"block {ckpt_block}")
    merged = {**_rec_results(rkey, crash_parts), **restored}
    if merged != gold:
        fail(f"delta {name}: the crash + restore output differs from the "
             "uninterrupted run")
    phase("delta", part=name, batches=n_batches, batch=batch,
          checkpoint_every=DELTA_EVERY, full_every=DELTA_FULL_EVERY,
          card=card, outputs_equal_across_modes=True,
          states_equal_full=name in DELTA_HELD,
          outputs_equal_cpu=True, merged_equal_card=True,
          merged_equal_cpu=True, crashed_at=crash_at,
          restored_epoch=cid, restored_epoch_kind=restored_kind,
          restored_chain_deps=man.get("deps") or {},
          restored_run_s=restored_run_s,
          rebuild_launches_uninterrupted=(gold_launches if is_ffat
                                          else 0),
          rebuild_launches_restored=launches, modes=modes,
          part_s=time.perf_counter() - t_part)
    import shutil
    for d in os.listdir(os.path.join(HERE, "build", "ckpt")):
        if d.startswith(f"delta_{name}_"):
            shutil.rmtree(os.path.join(HERE, "build", "ckpt", d),
                          ignore_errors=True)
    return (gold_launches + launches) if is_ffat else Counter()


def delta_phase(torch, wt, card):
    """Phase ``delta``: incremental and asynchronous checkpoints on the
    card, parts smap_hc, ffat, fused and tiered (``_delta_parts``). The
    cut of each worker is timed around ``Worker.checkpoint_now`` (barrier
    at the worker -> ack), its capture around ``Worker._capture_blobs``
    and its ack around ``CheckpointCoordinator.ack`` (the blob write when
    synchronous, the registration with the uploader when asynchronous),
    on the worker's own thread; each blob write's pickle, sha256 and
    fsync'd write around the store's own calls, on whichever thread writes
    (the worker, or the uploader). Returns K1's launches in the ffat
    part's FULL-mode and restored runs."""
    import pickle
    from types import SimpleNamespace
    from windflow_tpu_torch.checkpoint import CheckpointCoordinator as Coord
    from windflow_tpu_torch.checkpoint import store as smod
    from windflow_tpu_torch.runtime import worker as wmod
    cuts, tl, writes = [], threading.local(), {}
    orig = (wmod.Worker.checkpoint_now, wmod.Worker._capture_blobs,
            Coord.ack)
    orig_store = (smod.CheckpointStore.write_blob, smod.pickle,
                  smod._hash_bytes, smod._atomic_write)

    def split(fn, key):
        def timed_fn(*a, **kw):
            cid = getattr(tl, "cid", None)
            if cid is None:  # not a blob write (the commit's manifest)
                return fn(*a, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                ep = writes.setdefault(cid, {})
                ep[key] = ep.get(key, 0.0) + (time.perf_counter() - t0) * 1e3
        return timed_fn

    def noted_write(self, ckpt_id, *a, **kw):
        tl.cid = ckpt_id
        try:
            return orig_store[0](self, ckpt_id, *a, **kw)
        finally:
            tl.cid = None

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
    smod.CheckpointStore.write_blob = noted_write
    smod.pickle = SimpleNamespace(
        dumps=split(pickle.dumps, "pickle"), load=pickle.load,
        HIGHEST_PROTOCOL=pickle.HIGHEST_PROTOCOL)
    smod._hash_bytes = split(orig_store[2], "sha256")
    smod._atomic_write = split(orig_store[3], "fsync_write")
    try:
        return sum((delta_part(torch, wt, card, part, cuts, writes)
                    for part in _delta_parts(wt)), Counter())
    finally:
        (wmod.Worker.checkpoint_now, wmod.Worker._capture_blobs,
         Coord.ack) = orig
        (smod.CheckpointStore.write_blob, smod.pickle, smod._hash_bytes,
         smod._atomic_write) = orig_store


# ---------------------------------------------------------------------------
# phase rescale: live repartition of the HC window and the stateful map
# ---------------------------------------------------------------------------
RS_FFAT_STEPS = ((8, 2), (16, 1))  # (before block, new parallelism)
RS_SMAP_BATCHES, RS_SMAP_STEPS = 16, ((8, 4),)
RS_HOLD_WAIT_S = 120.0


class _GatedBlocks:
    """Replayable block source (EVENT_TIME): one block per step, parked
    before each block of ``gates`` until its event is set; ``every`` > 0
    requests a checkpoint after every ``every`` blocks and, with
    ``store``, waits (bounded) for it to commit; raises once before block
    ``crash_at``; sleeps ``pace_s`` after each block. Its position counts
    the blocks pushed."""

    def __init__(self, blocks, gates=(), every=0, store=None,
                 crash_at=None, pace_s=0.0):
        self.blocks, self.every, self.store = blocks, every, store
        self.pace_s = pace_s
        self.gates = {at: threading.Event() for at in gates}
        self.crash_at = crash_at
        self.pos = 0
        self.t_yield = []

    def __call__(self, shipper):
        from windflow_tpu_torch.checkpoint import CheckpointStore
        while self.pos < len(self.blocks):
            ev = self.gates.get(self.pos)
            if ev is not None and not ev.wait(RS_HOLD_WAIT_S):
                raise RuntimeError(f"gate before block {self.pos} was "
                                   "never released")
            if self.pos == self.crash_at:
                self.crash_at = None  # once
                raise _InjectedCrash(f"killed before block {self.pos}")
            cols, ts, wm = self.blocks[self.pos]
            self.t_yield.append(time.perf_counter())
            shipper.set_next_watermark(wm)
            shipper.push_columns(cols, ts)
            self.pos += 1
            if self.pace_s:
                time.sleep(self.pace_s)
            if self.every and self.pos % self.every == 0:
                before = CheckpointStore(self.store).latest() or 0
                shipper.request_checkpoint()
                deadline = time.monotonic() + RS_HOLD_WAIT_S
                while (CheckpointStore(self.store).latest() or 0) <= before \
                        and time.monotonic() < deadline:
                    time.sleep(0.002)

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _release_when_held(graph, ev):
    """Release a parked source once the rescale's held epoch is
    published: its next push injects that epoch's barrier."""
    def body():
        deadline = time.monotonic() + RS_HOLD_WAIT_S
        coord = graph._coordinator
        while (coord._hold_epoch is None
               or coord.requested_id < coord._hold_epoch) \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        ev.set()
    threading.Thread(target=body, daemon=True).start()


def _rs_ops(wt, part, par):
    if part == "ffat":
        return [wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                            wt.fieldwise(value="sum"))
                .with_key_by("key").with_tb_windows(WIN_US, SLIDE_US)
                .with_key_capacity(HC_KEYS).with_name("ffat")
                .with_parallelism(par).build()]
    return [wt.Map_GPU_Builder(_smap_fn).with_key_by("key")
            .with_state({"n": np.int32(0)}).with_name("smap")
            .with_parallelism(par).build()]


def _run_rescaled(wt, device, part, blocks, steps, store, par0):
    """Replayable gated source -> the part's operator at ``par0`` ->
    columnar sink, rescaled live before each ``(block, parallelism)`` of
    ``steps``. Returns the sink's batches, the source, the rescale
    reports, every plane's replicas of the operator and the graph."""
    parts, sink = _sink_parts()
    src = _GatedBlocks(blocks, gates=[at for at, _ in steps])
    graph = wt.PipeGraph(f"rs_{part}", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device)
    graph.with_checkpointing(store_dir=store)
    (op,) = _rs_ops(wt, part, par0)
    graph.add_source(wt.Source_Builder(src).with_name("src")
                     .with_output_batch_size(BATCH).build()) \
        .add(op).add_sink(wt.Sink_Builder(sink).with_columns().build())
    graph.start()
    planes, reports = [list(op.replicas)], []
    try:
        for at, par in steps:
            # the source parks before block ``at``; the rescale's barrier
            # goes out with that block
            deadline = time.monotonic() + RS_HOLD_WAIT_S
            while src.pos < at and time.monotonic() < deadline:
                time.sleep(0.001)
            _release_when_held(graph, src.gates[at])
            reports.append(graph.rescale(op.name, par,
                                         timeout_s=RS_HOLD_WAIT_S))
            planes.append(list(op.replicas))
    finally:
        for ev in src.gates.values():
            ev.set()
    graph.wait_end()
    return parts, src, reports, planes, graph


def _window_rows(parts):
    """Window rows by (key, wid), and how many arrived more than once."""
    out, dups = {}, 0
    for _, c in parts:
        for k, w, ok, v in zip(c["key"].tolist(), c["wid"].tolist(),
                               c["valid"].tolist(), c["value"].tolist()):
            dups += (k, w) in out
            out[(k, w)] = (ok, v if ok else 0)
    return out, dups


def _row_order(c):
    """Every row of the columns ``c`` in (ts, key, value) order: the
    order of a multiset, whichever replica emitted a row."""
    order = np.lexsort((c["value"], c["key"], c["ts"]))
    return {k: v[order] for k, v in c.items()}


def rescale_part(torch, wt, card, part):
    """One part of phase ``rescale``: the uninterrupted run and the live
    rescaled run on the card in turns (none, rescaled, rescaled, none),
    and the uninterrupted run on the CPU; the rescaled output must equal
    both (``ffat``: window rows by (key, wid), none twice; ``smap``: every
    row in ts order, and the numpy fold). ``ffat``: K1 must launch on each
    new replica that holds keys (its first firing batch rebuilds the
    moved forest). Returns K1's launches in the first rescaled run."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    ffat = part == "ffat"
    n = N_BATCHES if ffat else RS_SMAP_BATCHES
    keys = HC_KEYS if ffat else HUGE_KEYS
    steps = RS_FFAT_STEPS if ffat else RS_SMAP_STEPS
    par0 = 1 if ffat else 2
    blocks = _blocks(keys, seed=53, n_batches=n, batch=BATCH)
    runs = {"none": [], "rescaled": []}
    ref = launches = reports = None
    for mode in ("none", "rescaled", "rescaled", "none"):
        _reset_launches(fr)
        torch.cuda.synchronize()
        p, src, reps, planes, g = _run_rescaled(
            wt, "cuda", part, blocks, steps if mode == "rescaled" else (),
            _ckpt_dir(f"rs_{part}"), par0)
        span = max(t for t, _ in p) - src.t_yield[STATE_WARMUP]
        runs[mode].append((n - STATE_WARMUP) * BATCH / span)
        out = _window_rows(p) if ffat else (_row_order(_concat(p)), 0)
        if out[1]:
            fail(f"rescale {part}: {out[1]} window rows arrived twice")
        if ref is None:
            ref = out[0]
        elif not _same_rows(out[0], ref):
            fail(f"rescale {part} ({mode}): the output differs from the "
                 "uninterrupted run on the card")
        if mode == "rescaled" and reports is None:
            reports, launches = reps, _launch_counts(fr)
            per_plane = [[r.stats.rebuild_kernel_launches for r in pl]
                         for pl in planes]
            keyed = [[len(r.slot_of_key) for r in pl] for pl in planes[1:]] \
                if ffat else None
    cpu = _run_rescaled(wt, "cpu", part, blocks, (),
                        _ckpt_dir(f"rs_{part}_c"), par0)[0]
    if not _same_rows(_window_rows(cpu)[0] if ffat
                      else _row_order(_concat(cpu)),
                      ref):
        fail(f"rescale {part}: the output differs from the CPU run")
    row = dict(part=part, keys=keys, batches=n, batch=BATCH, card=card,
               steps=[list(s) for s in steps],
               rows_equal_uninterrupted_card=True, rows_equal_cpu=True,
               tuples_per_s_rescaled=runs["rescaled"],
               tuples_per_s_none=runs["none"])
    if ffat:
        valid = sum(ok for ok, _ in ref.values())
        if not valid:
            fail("rescale ffat: no valid window")
        if launches.total() != sum(map(sum, per_plane)):
            fail(f"rescale ffat: K1 wrapper launches {launches.total()}, "
                 f"replicas "
                 f"{per_plane}")
        for pl, ks in zip(per_plane[1:], keyed):
            if any(k and not c for c, k in zip(pl, ks)):
                fail(f"rescale ffat: a new replica holding keys never "
                     f"launched K1 (launches {pl}, keys {ks})")
        row.update(windows=len(ref), valid_windows=int(valid),
                   duplicate_windows=0, rebuild_launches=launches.total(),
                   rebuild_launches_per_plane=per_plane,
                   keys_per_new_replica=keyed)
    else:
        s = _stream(blocks)
        fold = _row_order({"ts": np.concatenate([t for _, t, _ in blocks]),
                           "key": s["key"], "value": _smap_fold(blocks)})
        if not all(np.array_equal(ref[k], fold[k]) for k in fold):
            fail("rescale smap_hc: rows differ from the numpy fold")
        row.update(rows=int(len(ref["ts"])), rows_equal_numpy=True)
    row["rescales"] = [{k: r[k] for k in (
        "old_parallelism", "new_parallelism", "ckpt_id", "checkpoint_s",
        "pause_s", "total_s", "load_s", "repartition_s", "teardown_s",
        "rebuild_s", "restore_s")} for r in reports]
    phase("rescale", **row)
    return launches


def _same_rows(a, b):
    if isinstance(a, dict) and a and isinstance(next(iter(a.values())),
                                                np.ndarray):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                            for k in a)
    return a == b


def rescale_phase(torch, wt, card):
    """Phase ``rescale``: part ``ffat`` (the HC main path, the window at
    parallelism 1, rescaled to 2 before block 8 and back to 1 before
    block 16) and part ``smap_hc`` (the stateful map at 1,048,576 keys,
    2 -> 4 before block 8). Each line gives, per rescale, the report's
    ``checkpoint_s`` / ``pause_s`` / ``total_s`` and the pause's split
    (checkpoint load, host repartition, teardown, rebuild, restore: the
    H2D copies of the moved tables and forests), and tuples/s with and
    without the rescale. Returns K1's launches in the ffat part."""
    return sum((rescale_part(torch, wt, card, part)
                for part in ("ffat", "smap_hc")), Counter())


# ---------------------------------------------------------------------------
# phase supervise: self-healing recovery and poison-record isolation
# ---------------------------------------------------------------------------
SUP_EVERY, SUP_CRASH_AT = 4, 16
POISON_VALUE = 1_000_000  # the poison row sits 5/8 into the batch


def _run_supervised(wt, device, part, blocks, store, crash_at=None):
    parts, sink = _sink_parts()
    src = _GatedBlocks(blocks, every=SUP_EVERY, store=store,
                       crash_at=crash_at)
    graph = wt.PipeGraph(f"sup_{part}", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device)
    graph.with_checkpointing(store_dir=store)
    graph.with_supervision(wt.RestartPolicy(max_restarts=2, backoff_s=0.05,
                                            backoff_max_s=0.1, seed=0))
    (op,) = _rs_ops(wt, "ffat" if part == "ffat" else "smap", 1)
    graph.add_source(wt.Source_Builder(src).with_name("src")
                     .with_output_batch_size(BATCH).build()) \
        .add(op).add_sink(wt.Sink_Builder(sink).with_columns().build())
    graph.run()
    return parts, graph, op


def supervise_part(torch, wt, card, part):
    """Parts ``ffat`` (HC) and ``smap`` (10,240 keys) under
    ``with_supervision``, a checkpoint every SUP_EVERY blocks, the source
    raising once before block SUP_CRASH_AT: one restart, and the distinct
    output (window rows by (key, wid); output batches by their first ts)
    equal to the uninterrupted run on the card and on the CPU. Returns
    K1's launches in the supervised run (``ffat``)."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    ffat = part == "ffat"
    blocks = _blocks(HC_KEYS, seed=61, n_batches=N_BATCHES, batch=BATCH)
    res = "ffat" if ffat else "smap"
    torch.cuda.synchronize()
    gold = _rec_results(res, _run_supervised(
        wt, "cuda", part, blocks, _ckpt_dir(f"sup_{part}_g"))[0])
    if gold != _rec_results(res, _run_supervised(
            wt, "cpu", part, blocks, _ckpt_dir(f"sup_{part}_c"))[0]):
        fail(f"supervise {part}: the card's run differs from the CPU run")
    _reset_launches(fr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parts, g, op = _run_supervised(wt, "cuda", part, blocks,
                                   _ckpt_dir(f"sup_{part}"),
                                   crash_at=SUP_CRASH_AT)
    wall = time.perf_counter() - t0
    sup = g.get_stats()["Supervision"]
    if sup["Supervision_restarts"] != 1 or sup["Supervision_escalated"]:
        fail(f"supervise {part}: {sup['Supervision_restarts']} restarts, "
             f"escalated {sup['Supervision_escalated']}")
    if _rec_results(res, parts) != gold:
        fail(f"supervise {part}: the distinct output differs from the "
             "uninterrupted run")
    launches = _launch_counts(fr)
    if ffat and op.replicas[0].stats.rebuild_kernel_launches < 1:
        fail("supervise ffat: the restored replica never launched K1")
    (h,) = sup["Supervision_history"]
    phase("supervise", part=part, keys=HC_KEYS, batches=N_BATCHES,
          batch=BATCH, card=card, checkpoint_every=SUP_EVERY,
          crash_before=SUP_CRASH_AT, restarts=1, restored_checkpoint=h[
              "ckpt_id"], distinct_equal_card=True, distinct_equal_cpu=True,
          detect_to_resume_s=sup["Supervision_last_restart_s"],
          backoff_s=h["backoff_s"], wall_s=wall,
          rebuild_launches=launches.total() if ffat else 0,
          rebuild_launches_restored=(
              op.replicas[0].stats.rebuild_kernel_launches if ffat else 0))
    return launches if ffat else Counter()


def _poison_map(f):
    if bool((f["value"] == POISON_VALUE).any()):  # a host-side check
        raise ValueError("poison record")
    return {**f, "value": f["value"] * 3 + 1}


def _run_poison(wt, device, block):
    parts, sink = _sink_parts()
    graph = wt.PipeGraph("poison", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device)
    graph.add_source(wt.Columnar_Source_Builder(lambda: iter([block]))
                     .with_output_batch_size(BATCH).build()) \
        .add(wt.Map_GPU_Builder(_poison_map).with_name("guarded")
             .with_error_policy(wt.ErrorPolicy.DEAD_LETTER).build()) \
        .add_sink(wt.Sink_Builder(sink).with_columns().build())
    torch_sync = __import__("torch").cuda.synchronize
    if device == "cuda":
        torch_sync()
    t0 = time.perf_counter()
    graph.run()
    wall = time.perf_counter() - t0
    rep = graph.get_stats()["Operators"][1]["replicas"][0]
    return parts, graph, wall, rep


def supervise_poison_part(wt, card):
    """Part ``poison``: one 65,536-row batch through a DEAD_LETTER-guarded
    Map_GPU whose function raises on the one row holding POISON_VALUE.
    The guarded path commits synchronously and halves the failing batch
    until the row is alone: exactly one dead letter, the other rows mapped
    exactly (in order). The line gives the guarded replica's commits
    and host time (prep + commit) against a clean batch's."""
    at = BATCH * 5 // 8
    cols, ts, wm = _blocks(HC_KEYS, seed=71, n_batches=1, batch=BATCH)[0]
    clean = _run_poison(wt, "cuda", (cols, ts, wm))
    bad_cols = {k: v.copy() for k, v in cols.items()}
    bad_cols["value"][at] = POISON_VALUE
    parts, g, wall, rep = _run_poison(wt, "cuda", (bad_cols, ts, wm))
    letters = g.dead_letters()
    if len(letters) != 1 or letters[0]["payload_obj"] != {
            "key": int(cols["key"][at]), "value": POISON_VALUE}:
        fail(f"supervise poison: dead letters {[r['payload'] for r in letters]}")
    out = _concat(parts)
    keep = np.arange(BATCH) != at
    if not (np.array_equal(out["key"], cols["key"][keep])
            and np.array_equal(out["value"], cols["value"][keep] * 3 + 1)
            and np.array_equal(out["ts"], ts[keep])):
        fail("supervise poison: the other rows are not mapped exactly")

    def host_ms(r):
        return (r["Dispatch_host_prep_total_usec"]
                + r["Dispatch_commit_total_usec"]) / 1e3

    phase("supervise", part="poison", batch=BATCH, card=card,
          dead_letters=1, rows_exact=int(keep.sum()),
          commits=rep["Dispatch_batches"], dlq_records=rep["Dlq_records"],
          bisect_ms=host_ms(rep), clean_ms=host_ms(clean[3]),
          wall_s=wall, clean_wall_s=clean[2])


def supervise_phase(torch, wt, card):
    """Phase ``supervise``: parts ``ffat`` and ``smap`` (recovery by the
    supervisor, the detection -> resume time) and ``poison`` (batch
    bisection). Returns K1's launches in the supervised ffat run."""
    launches = sum((supervise_part(torch, wt, card, part)
                    for part in ("ffat", "smap")), Counter())
    supervise_poison_part(wt, card)
    return launches


# ---------------------------------------------------------------------------
# phase mesh: the mesh plane over virtual shards, on one group and on card groups
# ---------------------------------------------------------------------------
MESH_VDEV = 8
# the HC shapes on one group; (1, 1) and (2, 4) run in the CPU tests
# only, to keep the script inside its time
MESH_SHAPES = ((8, 1), (4, 2))
# 2 warm-up + 6 timed batches (12 timed until PR 12 cut the depth to keep
# the script inside its time with the observe phase)
MESH_BATCHES, MESH_WARMUP = 8, 2
# scripts/bench_mesh.py's config: 64 keys, 16,384-tuple batches
MESH_BENCH_KEYS, MESH_BENCH_BATCH = 64, 16_384
MESH_DEAD = (4, 5, 6, 7)   # the degrade part's dead virtual devices (the
# second of two groups of four in its grouped run)
MESH_GROUPS = (2, 4)       # group counts of the grouped runs on cuda:0
MESH_GROUP_SHAPE = (4, 2)  # the grouped runs' mesh shape
MESH_PACE_S = 0.12         # the degrade part's pause between blocks
MESH_CRASH_AT = 8          # the degrade part's crash (before this block)
MESH_WAIT_S = 60.0


def _mesh_ffat_op(wt, n_keys, shape, name="fwm"):
    return (wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                        wt.fieldwise(value="sum"))
            .with_key_by("key").with_tb_windows(WIN_US, SLIDE_US)
            .with_key_capacity(n_keys).with_mesh(mesh_shape=shape)
            .with_name(name).build())


def _run_mesh_ffat(wt, device, blocks, n_keys, shape, batch=BATCH):
    """Columnar source -> Ffat_Windows_Mesh at ``shape`` -> columnar sink:
    the sink's batches (with arrival times), the source's yield times,
    the end of ``run()`` and the graph."""
    t_yield = []
    parts, sink = _sink_parts()
    graph = wt.PipeGraph("mesh_ffat", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device)
    graph.add_source(wt.Columnar_Source_Builder(_timed_source(blocks,
                                                              t_yield))
                     .with_output_batch_size(batch).build()) \
        .add(_mesh_ffat_op(wt, n_keys, shape)) \
        .add_sink(wt.Sink_Builder(sink).with_columns().build())
    graph.run()
    return parts, t_yield, time.perf_counter(), graph


def _window_cols(parts):
    """Window rows sorted by (key, wid)."""
    import numpy as np
    c = _concat(parts)
    order = np.lexsort((c["wid"], c["key"]))
    return {k: v[order] for k, v in c.items()}


def _mesh_stats(graph, name):
    (r,) = next(o for o in graph.get_stats()["Operators"]
                if o["name"] == name)["replicas"]
    return r


def _mesh_stats_live(graph, name):
    """``_mesh_stats`` of a graph that a supervisor may be rebuilding:
    while the rebuild has discarded the operator's replicas and not yet
    made the new one, there is nothing to read and this returns None."""
    reps = next(o for o in graph.get_stats()["Operators"]
                if o["name"] == name)["replicas"]
    return reps[0] if len(reps) == 1 else None


def _mesh_groups_live(graph, name):
    """The group count of mesh operator ``name``'s built mesh, or None
    while a supervisor rebuild has none to read."""
    reps = list(next(o for o in graph._ops if o.name == name).replicas)
    mesh = getattr(reps[0], "_mesh", None) if len(reps) == 1 else None
    return None if mesh is None else mesh.n_groups


def _mesh_rates(run, batch, n_rows):
    """Tuples/s and windows/s from the yield of batch MESH_WARMUP to the
    end of ``run()`` (windows: the rows that reached the sink after that
    yield)."""
    parts, t_yield, t_end = run[0], run[1], run[2]
    t0 = t_yield[MESH_WARMUP]
    span = t_end - t0
    windows = sum(len(c["ts"]) for t, c in parts if t >= t0)
    return dict(tuples_per_s=(len(t_yield) - MESH_WARMUP) * batch / span,
                windows_per_s=windows / span, windows_total=n_rows)


def _same_cols(a, b):
    import numpy as np
    return a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                        for k in a)


def _mesh_layouts(torch):
    """``(label, group devices)`` of the grouped runs: MESH_GROUPS groups
    of the MESH_VDEV virtual devices on cuda:0, and where the machine has
    two cards or more, a group on each of 2, 4 or 8 of them."""
    out = [(f"{g} groups on cuda:0", ["cuda:0"] * g) for g in MESH_GROUPS]
    n = torch.cuda.device_count()
    if n >= 2:
        c = max(d for d in (2, 4, 8) if d <= n)
        out.append((f"{c} cards", [f"cuda:{i}" for i in range(c)]))
    return out


def _mesh_of(graph, name):
    """The built mesh of mesh operator ``name``."""
    return next(o for o in graph._ops if o.name == name).replicas[0]._mesh


def _layout_fields(mesh):
    """The mesh line's ``cards`` and ``groups``, and whether the copies
    between groups crossed cards."""
    cards, groups = len(mesh.cards), mesh.n_groups
    row = dict(cards=cards, groups=groups)
    if groups > 1:
        row["peer_transport"] = (
            "exercised between distinct cards" if cards > 1 else
            "not exercised: every group on one card (copies within it)")
    return row


def _group_launches(name, k1, rep, mesh):
    """K1 once per step on each group that holds forest rows."""
    holders = sum(1 for k in mesh.key_groups() if k.n_home)
    if k1 == 0 or rep["Rebuild_kernel_launches"] != k1 \
            or k1 != holders * rep["Mesh_steps"]:
        fail(f"{name}: K1 launches {k1}, replica "
             f"{rep['Rebuild_kernel_launches']}, {holders} groups x steps "
             f"{rep['Mesh_steps']}: not one launch per group per step")
    return holders


def mesh_ffat_part(torch, wt, card):
    """Part ``ffat``: the HC stream through Ffat_Windows_Mesh at every
    shape of MESH_SHAPES, then bench_mesh's config at (4, 2), all on one
    group; then both at MESH_GROUP_SHAPE over each layout of
    ``_mesh_layouts``. At each: the card's rows equal the port's CPU rows
    (int32 sums: exact) and every shape's and layout's rows equal the
    others'; K1 launched once per step on each group holding forest rows
    (so on every firing step); the late counters conserve the inputs.
    Returns K1's launches."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.mesh import core as mcore
    configs = [("hc", HC_KEYS, BATCH, s) for s in MESH_SHAPES] \
        + [("bench_mesh", MESH_BENCH_KEYS, MESH_BENCH_BATCH, (4, 2))]
    streams = {"hc": _blocks(HC_KEYS, seed=71, n_batches=MESH_BATCHES,
                             batch=BATCH),
               "bench_mesh": _blocks(MESH_BENCH_KEYS, seed=72,
                                     n_batches=MESH_BATCHES,
                                     batch=MESH_BENCH_BATCH)}
    launches, first, cpu_rows = Counter(), {}, {}

    def run_config(cfg, n_keys, batch, shape, layout=None):
        blocks = streams[cfg]
        _reset_launches(fr)
        _sync_cards(torch)
        run = _run_mesh_ffat(wt, "cuda", blocks, n_keys, shape, batch)
        _sync_cards(torch)
        counts = _launch_counts(fr)
        k1 = counts.total()
        rep = _mesh_stats(run[3], "fwm")
        mesh = _mesh_of(run[3], "fwm")
        name = f"mesh ffat {cfg} {shape}" + (f" {layout}" if layout else "")
        _group_launches(name, k1, rep, mesh)
        launches.update(counts)
        g = _window_cols(run[0])
        if layout is None:
            cpu_rows[cfg, shape] = _window_cols(_run_mesh_ffat(
                wt, "cpu", blocks, n_keys, shape, batch)[0])
        if not _same_cols(g, cpu_rows[cfg, shape]):
            fail(f"{name}: window rows differ from the CPU run")
        if cfg in first and not _same_cols(g, first[cfg]):
            fail(f"{name}: window rows differ from shape {MESH_SHAPES[0]}")
        first.setdefault(cfg, g)
        valid = g["valid"]
        if not valid.any() or (g["value"][valid] < 0).any():
            fail(f"{name}: no valid windows, or negative sums")
        if rep["Late_admitted"] != rep["Late_records"] - rep["Late_dropped"] \
                or rep["Inputs_received"] != len(blocks) * batch:
            fail(f"{name}: the late counters do not conserve the inputs")
        row = dict(part="ffat", config=cfg, shape=list(shape), keys=n_keys,
                   batches=len(blocks), warmup=MESH_WARMUP, batch=batch,
                   card=card, **_layout_fields(mesh), rows_equal_cpu=True,
                   rows_equal_shapes=True, valid_windows=int(valid.sum()),
                   rebuild_launches=k1,
                   **_mesh_rates(run, batch, len(g["key"])),
                   **{k: rep[k] for k in (
                       "Mesh_devices", "Mesh_steps", "Mesh_shuffle_bytes",
                       "Mesh_shard_skew", "Mesh_shard_occupancy",
                       "Mesh_step_usec_total", "Late_records",
                       "Late_dropped", "Inputs_ignored")})
        if layout is not None:
            row.update(layout=layout, rows_equal_one_group=True,
                       copied_bytes_per_step=mesh.copied_bytes
                       / rep["Mesh_steps"])
        # profiled: the one-group runs at (4, 2), and the grouped HC run
        # at MESH_GROUPS[0] groups and over several cards (a profile of
        # 4 groups' ~12k kernels a batch takes ~15 s to read)
        if shape == (4, 2) and (layout is None or cfg == "hc" and (
                mesh.n_groups == MESH_GROUPS[0] or len(mesh.cards) > 1)):
            row["profiled"] = _profiled(
                torch, lambda: _run_mesh_ffat(wt, "cuda", blocks, n_keys,
                                              shape, batch), len(blocks))
        phase("mesh", **row)

    for cfg, n_keys, batch, shape in configs:
        run_config(cfg, n_keys, batch, shape)
    prev = mcore.virtual_device_groups()
    try:
        for layout, devs in _mesh_layouts(torch):
            mcore.ensure_virtual_devices(MESH_VDEV, group_devices=devs)
            for cfg, n_keys, batch, shape in configs:
                if shape == MESH_GROUP_SHAPE:
                    run_config(cfg, n_keys, batch, shape, layout)
    finally:
        mcore.ensure_virtual_devices(MESH_VDEV, group_devices=prev)
    return launches


def _mesh_ops(wt, part, shape, mesh=True):
    if part == "map":
        b = (wt.Map_GPU_Builder(_smap_fn).with_key_by("key")
             .with_state({"n": np.int32(0)}).with_name("smap"))
        if mesh:
            b = b.with_mesh(mesh_shape=shape, key_capacity=HC_KEYS)
        return [b.build()]
    red = wt.Reduce_GPU_Builder(_sum_value).with_key_by("key") \
        .with_name("red")
    if mesh:
        red = red.with_mesh(mesh_shape=shape, key_capacity=GRAPH_KEYS)
    return [wt.Map_GPU_Builder(_map_value).build(),
            wt.Filter_GPU_Builder(_even_value).build(), red.build()]


def mesh_ops_part(torch, wt, card):
    """Part ``ops``: Map_Mesh (the stateful smap at 10,240 keys) and
    Reduce_Mesh (graph_gpu's map -> filter -> keyed reduce at 256 keys)
    at (4, 2) and (1, 1), then at (4, 2) over 4 groups of cuda:0 (and a
    group on each card where there are several): rows equal the CPU
    run's and the single-card Map_GPU / Reduce_GPU's on the same stream
    (the map's row for row, the reduce's as a multiset) and the numpy
    fold."""
    from windflow_tpu_torch.mesh import core as mcore
    streams = {"map": _blocks(HC_KEYS, seed=73, n_batches=STATE_BATCHES,
                              batch=BATCH),
               "reduce": _blocks(GRAPH_KEYS, seed=74,
                                 n_batches=GRAPH_BATCHES, batch=BATCH)}
    runs = [((4, 2), None, None), ((1, 1), None, None)] + [
        (MESH_GROUP_SHAPE, layout, devs)
        for layout, devs in _mesh_layouts(torch)
        if len(devs) == 4 or "cards" in layout]
    prev = mcore.virtual_device_groups()
    for part, blocks in streams.items():
        op_name = "smap" if part == "map" else "red"
        canon = _concat if part == "map" else _sorted_rows
        single = canon(_run_state_graph(
            wt, "cuda", blocks, lambda w: _mesh_ops(w, part, None,
                                                    mesh=False))[0])
        if part == "map":
            ok = np.array_equal(single["value"], _smap_fold(blocks))
        else:
            tot, _ = _fold(blocks)
            got = np.zeros(GRAPH_KEYS, np.int64)
            np.add.at(got, single["key"], single["value"])
            ok = np.array_equal(got, tot)
        if not ok:
            fail(f"mesh ops {part}: the single-card run differs from the "
                 "numpy fold")
        cpu_rows = {}
        for shape, layout, devs in runs:
            name = f"mesh ops {part} {shape}" + (f" {layout}"
                                                 if layout else "")
            make = lambda w, s=shape: _mesh_ops(w, part, s)
            mcore.ensure_virtual_devices(MESH_VDEV, group_devices=devs)
            try:
                _sync_cards(torch)
                _k8_reset()
                grun = _run_state_graph(wt, "cuda", blocks, make)
                k8 = (_k8_launched(name) if part == "map" else None)
                if part == "reduce":
                    _reduce_launched(name, "keyed_fold")
                g = canon(grun[0])
                if layout is None:
                    cpu_rows[shape] = canon(_run_state_graph(
                        wt, "cpu", blocks, make)[0])
                if not _same_cols(g, cpu_rows[shape]):
                    fail(f"{name}: rows differ from the CPU run")
                if not _same_cols(g, single):
                    fail(f"{name}: rows differ from the single-card "
                         f"{'Map_GPU' if part == 'map' else 'Reduce_GPU'}")
                rep = _mesh_stats(grun[3], op_name)
                mesh = _mesh_of(grun[3], op_name)
                row = dict(part="ops", op=part, shape=list(shape),
                           keys=HC_KEYS if part == "map" else GRAPH_KEYS,
                           batches=len(blocks), warmup=STATE_WARMUP,
                           batch=BATCH, card=card, **_layout_fields(mesh),
                           rows=int(len(g["ts"])), rows_equal_cpu=True,
                           rows_equal_single_card=True,
                           rows_equal_numpy=True,
                           tuples_per_s=_state_rates(grun, len(blocks),
                                                     BATCH),
                           k8_launches=k8,
                           **{k: rep[k] for k in (
                               "Mesh_devices", "Mesh_steps",
                               "Mesh_shuffle_bytes", "Mesh_shard_skew",
                               "Mesh_step_usec_total")})
                if layout is not None:
                    row.update(layout=layout, copied_bytes_per_step=mesh
                               .copied_bytes / rep["Mesh_steps"])
                row["profiled"] = _profiled(torch, lambda: _run_state_graph(
                    wt, "cuda", blocks, make), len(blocks))
                phase("mesh", **row)
            finally:
                mcore.ensure_virtual_devices(MESH_VDEV, group_devices=prev)


def _run_mesh_rec(wt, src, store, shape, restore_from=None, crash=False,
                  probe=None):
    """Replayable source -> Ffat_Windows_Mesh at ``shape`` -> columnar
    sink, checkpointing into ``store`` (supervised with ``probe``)."""
    parts, sink = _sink_parts()
    graph = wt.PipeGraph("mesh_rec", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device="cuda")
    graph.with_checkpointing(store_dir=store)
    if probe is not None:
        graph.with_supervision(wt.RestartPolicy(max_restarts=2,
                                                backoff_s=0.05,
                                                backoff_max_s=0.1, seed=0))
        graph.with_device_probe(probe)
    graph.add_source(wt.Source_Builder(src).with_name("src")
                     .with_output_batch_size(BATCH).build()) \
        .add(_mesh_ffat_op(wt, HC_KEYS, shape)) \
        .add_sink(wt.Sink_Builder(sink).with_columns().build())
    t0 = time.perf_counter()
    graph.start(restore_from)
    if probe is not None:
        return parts, graph, t0
    try:
        graph.wait_end()
    except _InjectedCrash:
        if not crash:
            raise
    else:
        if crash:
            fail("mesh restore: the injected crash did not end the run")
    first = min((t for t, _ in parts), default=None)
    return parts, graph, None if first is None else first - t0


def mesh_restore_part(torch, wt, card):
    """Part ``restore``: the HC ffat graph at (4, 2) checkpoints after
    block REC_CKPT_AT, dies before block REC_CRASH_AT and is restored
    with ``run(restore_from=...)`` onto (2, 4): the merged output equals
    the uninterrupted run, the source resumes at the checkpoint's block,
    and no window the checkpoint had fired fires again. Returns K1's
    launches."""
    from windflow_tpu_torch.checkpoint import CheckpointStore
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    blocks = _blocks(HC_KEYS, seed=75, n_batches=REC_BATCHES,
                     batch=BATCH)
    _sync_cards(torch)
    gold = _rec_results("ffat", _run_mesh_rec(
        wt, _ReplayBlocks(blocks), _ckpt_dir("mesh_g"), (4, 2))[0])
    store = _ckpt_dir("mesh_rec")
    _reset_launches(fr)
    crash = _run_mesh_rec(wt, _ReplayBlocks(blocks, ckpt_at=REC_CKPT_AT,
                                            crash_at=REC_CRASH_AT),
                          store, (4, 2), crash=True)
    if crash[1]._coordinator.completed != 1:
        fail("mesh restore: the checkpoint did not commit before the crash")
    _, ckpt_dir, manifest = CheckpointStore.resolve(store)
    mf = CheckpointStore(store).load_states(ckpt_dir, manifest)[
        ("fwm", 0)]["mesh_ffat"]
    slide = SLIDE_US // np.gcd(WIN_US, SLIDE_US)
    next_wid = np.concatenate(mf["fired"]).astype(np.int64) \
        + (mf["pane_base"] or 0) // slide
    src = _ReplayBlocks(blocks)
    box = []

    def restored():
        t0 = time.perf_counter()
        box.append(_run_mesh_rec(wt, src, store, (2, 4),
                                 restore_from=store))
        box.append(time.perf_counter() - t0)

    prof = _profiled(torch, restored, REC_BATCHES - REC_CKPT_AT)
    rest, wall = box
    launches = _launch_counts(fr)
    if src.first != REC_CKPT_AT:
        fail(f"mesh restore: the source resumed at block {src.first}")
    slot = mf["slot_of_key"]
    again = sum(int(w < next_wid[slot[k]])
                for _, c in rest[0] for k, w in zip(c["key"].tolist(),
                                                    c["wid"].tolist()))
    if again:
        fail(f"mesh restore: {again} windows the checkpoint had fired "
             "fired again")
    merged = {**_rec_results("ffat", crash[0]),
              **_rec_results("ffat", rest[0])}
    if merged != gold:
        fail("mesh restore: crash + restore differ from the uninterrupted "
             "run")
    rep = _mesh_stats(rest[1], "fwm")
    if rep["Mesh_devices"] != MESH_VDEV:
        fail("mesh restore: the restored mesh is not (2, 4)")
    phase("mesh", part="restore", keys=HC_KEYS, batches=REC_BATCHES,
          batch=BATCH, card=card, shape_checkpoint=[4, 2],
          shape_restore=[2, 4], ckpt_after=REC_CKPT_AT,
          crash_before=REC_CRASH_AT, rows_equal_uninterrupted=True,
          refired_windows=0, restore_to_first_delivery_s=rest[2],
          restored_tuples_per_s=(REC_BATCHES - REC_CKPT_AT) * BATCH / wall,
          restored_windows_per_s=sum(len(c["ts"]) for _, c in rest[0])
          / wall, rebuild_launches=launches.total(), profiled=prof,
          **{k: rep[k] for k in ("Mesh_steps", "Mesh_shuffle_bytes",
                                 "Mesh_shard_skew")})
    return launches


def mesh_degrade_part(torch, wt, card, devs=None, gold=None):
    """Part ``degrade``: the HC ffat graph at (4, 2) under supervision
    with a device probe that reports virtual devices MESH_DEAD dead; the
    source raises once before block MESH_CRASH_AT (checkpoints every
    SUP_EVERY blocks). The graph recovers on 4 shards, and re-expands to
    8 in one planned restart once the probe clears them; the distinct
    output equals the uninterrupted run (``gold``: made here when None).
    ``devs``: the group devices (None: one group); over two groups the
    dead devices are the whole second group, whose card is lost, and the
    recovered mesh spans the first group alone. Returns K1's launches and
    the uninterrupted run's rows."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.mesh import core as mcore
    blocks = _blocks(HC_KEYS, seed=76, n_batches=REC_BATCHES,
                     batch=BATCH)
    if gold is None:
        gold = _rec_results("ffat", _run_mesh_rec(
            wt, _ReplayBlocks(blocks), _ckpt_dir("mesh_dg_g"), (4, 2))[0])
    probe = wt.StaticDeviceProbe(dead=MESH_DEAD, interval_s=0.02)
    groups = 1 if devs is None else len(devs)
    store = _ckpt_dir(f"mesh_dg{groups}")
    src = _GatedBlocks(blocks, every=SUP_EVERY, store=store,
                       crash_at=MESH_CRASH_AT, pace_s=MESH_PACE_S)
    prev = mcore.virtual_device_groups()
    mcore.ensure_virtual_devices(MESH_VDEV, group_devices=devs)
    try:
        _reset_launches(fr)
        _sync_cards(torch)
        box = {}
        run = lambda: box.update(_mesh_degrade_run(wt, src, store, probe))
        # profiled on one group only: reading a grouped run's profile
        # (~5k kernels a batch over 24 batches) takes ~20 s
        prof = _profiled(torch, run, REC_BATCHES) if devs is None \
            else run()
    finally:
        mcore.ensure_virtual_devices(MESH_VDEV, group_devices=prev)
    parts, g, seen, domains, wall = (box[k] for k in (
        "parts", "graph", "seen", "domains", "wall"))
    launches = _launch_counts(fr)
    sup = g.get_stats()["Supervision"]
    rep = _mesh_stats(g, "fwm")
    mesh = _mesh_of(g, "fwm")
    hist = sup["Supervision_history"]
    if sup["Supervision_restarts"] != 1 \
            or [h.get("planned", False) for h in hist] != [False, True]:
        fail(f"mesh degrade: history {hist}")
    if rep.get("Mesh_devices") != MESH_VDEV or mesh.n_groups != groups:
        fail("mesh degrade: the mesh did not re-expand to 8 shards on "
             f"{groups} groups")
    if seen["groups"] != 1:
        fail(f"mesh degrade: the degraded mesh spans {seen['groups']} "
             "groups, not the surviving one")
    if _rec_results("ffat", parts) != gold:
        fail("mesh degrade: the distinct output differs from the "
             "uninterrupted run")
    if domains != {d: ["fwm"] for d in range(MESH_VDEV)
                   if d not in MESH_DEAD}:
        fail(f"mesh degrade: failure domains {domains}")
    phase("mesh", part="degrade", keys=HC_KEYS, batches=REC_BATCHES,
          batch=BATCH, card=card, shape=[4, 2], dead=list(MESH_DEAD),
          **_layout_fields(mesh), degraded_groups=seen["groups"],
          checkpoint_every=SUP_EVERY, crash_before=MESH_CRASH_AT,
          pace_s=MESH_PACE_S, degraded_mesh_devices=seen["Mesh_devices"],
          final_mesh_devices=rep["Mesh_devices"], restarts=1,
          planned_restarts=sup["Supervision_planned_restarts"],
          history=[{k: h[k] for k in ("ckpt_id", "mttr_s")}
                   | {"planned": h.get("planned", False)} for h in hist],
          distinct_equal_uninterrupted=True, wall_s=wall,
          paced_tuples_per_s=REC_BATCHES * BATCH / wall,
          windows_per_s=sum(len(c["ts"]) for _, c in parts) / wall,
          rebuild_launches=launches.total(), profiled=prof,
          **{k: rep[k] for k in ("Mesh_steps", "Mesh_shuffle_bytes",
                                 "Mesh_shard_skew")})
    return launches, gold


def _mesh_degrade_run(wt, src, store, probe):
    """The degrade part's supervised run: wait for the 4-shard recovery,
    clear the probe, wait for the re-expansion, then for the end."""
    from windflow_tpu_torch.mesh import core as mcore
    parts, g, t0 = _run_mesh_rec(wt, src, store, (4, 2), probe=probe)
    try:
        deadline = time.monotonic() + MESH_WAIT_S
        seen = None
        while time.monotonic() < deadline:
            sup = g.get_stats()["Supervision"]
            rep = _mesh_stats_live(g, "fwm")
            groups = _mesh_groups_live(g, "fwm")
            if rep is not None and groups is not None \
                    and sup["Recovery_degraded_devices"] == len(MESH_DEAD) \
                    and rep.get("Mesh_devices") \
                    == MESH_VDEV - len(MESH_DEAD):
                seen = dict(rep, groups=groups)
                break
            time.sleep(0.01)
        if seen is None:
            fail("mesh degrade: the 4-shard recovery never showed")
        domains = g.failure_domains()
        probe.dead.clear()  # the devices return
        while time.monotonic() < deadline:
            sup = g.get_stats()["Supervision"]
            if sup["Supervision_planned_restarts"] >= 1 \
                    and sup["Recovery_degraded_devices"] == 0:
                break
            time.sleep(0.01)
        else:
            fail("mesh degrade: the planned re-expansion never happened")
        g.wait_end()
    finally:
        mcore.set_excluded_devices(())
    return dict(parts=parts, graph=g, seen=seen, domains=domains,
                wall=time.perf_counter() - t0)


# part late: the event-time health stream (tests/test_event_time_health.py
# ``late_src``): after LATE_WARMUP pushes every 20th tuple lags by an
# admissible 3 ms and every 20th + 7 by an inadmissible 10 ms; the
# watermark steps every LATE_WM_EVERY pushes, batches of LATE_OBS
LATE_N, LATE_TS_STEP, LATE_WM_EVERY, LATE_OBS = 2_000, 25, 100, 50
LATE_WARMUP, LATE_LATENESS = 600, 4_500
LATE_ADMIT_US, LATE_DROP_US, LATE_WIN = 3_000, 10_000, 1_000
LATE_KEYS, LATE_TS0 = 8, 200_000
# pauses before these pushes, inside watermark runs: the staging age
# (25 ms) falls due at 130 and 1,430, the punctuation cadence (100 ms,
# checked every 64 pushes) at 191 and 1,471
LATE_PAUSES = {130: 0.03, 191: 0.11, 1_430: 0.03, 1_471: 0.11}


def _late_source(shipper, ctx):
    ts = LATE_TS0
    for i in range(LATE_N):
        pause = LATE_PAUSES.get(i)
        if pause:
            time.sleep(pause)
        ts += LATE_TS_STEP
        if i % 20 == 0 and i >= LATE_WARMUP:
            t = ts - LATE_ADMIT_US
        elif i % 20 == 7 and i >= LATE_WARMUP:
            t = ts - LATE_DROP_US
        else:
            t = ts
        shipper.push_with_timestamp({"key": i % LATE_KEYS, "value": 1}, t)
        if i % LATE_WM_EVERY == LATE_WM_EVERY - 1:
            shipper.set_next_watermark(ts)


def _late_model():
    """(admitted, dropped): a tuple is late iff its ts is behind the
    watermark riding its own push (set_next_watermark applies to the
    pushes after it)."""
    wm = next_wm = 0
    ts, admit, drop = LATE_TS0, 0, 0
    for i in range(LATE_N):
        ts += LATE_TS_STEP
        wm = max(wm, next_wm)
        if i % 20 == 0 and i >= LATE_WARMUP and ts - LATE_ADMIT_US < wm:
            admit += 1
        elif i % 20 == 7 and i >= LATE_WARMUP and ts - LATE_DROP_US < wm:
            drop += 1
        if i % LATE_WM_EVERY == LATE_WM_EVERY - 1:
            next_wm = ts
    return admit, drop


def mesh_late_part(torch, wt, card):
    """Part ``late``: the late stream on the card through Ffat_Windows_GPU
    and through the mesh at (4, 2) on one group, with timers falling due
    inside watermark runs; each must count the model's late tuples (timer
    cuts are held to watermark steps, runtime/emitters.py)."""
    admit, drop = _late_model()
    got = {}
    for engine in ("ffat_gpu", "mesh_4x2"):
        b = (wt.Ffat_Windows_GPU_Builder(
                lambda f: {"value": f["value"]}, wt.fieldwise(value="sum"))
             .with_key_by("key").with_tb_windows(LATE_WIN, LATE_WIN)
             .with_lateness(LATE_LATENESS).with_name("win"))
        if engine == "mesh_4x2":
            b = b.with_key_capacity(LATE_KEYS).with_mesh(mesh_shape=(4, 2))
        rows = []
        graph = wt.PipeGraph(f"late_{engine}", wt.ExecutionMode.DEFAULT,
                             wt.TimePolicy.EVENT_TIME, device="cuda")
        graph.add_source(wt.Source_Builder(_late_source)
                         .with_output_batch_size(LATE_OBS)
                         .with_name("late_src").build()) \
            .add(b.build()).add_sink(wt.Sink_Builder(
                lambda r: rows.append(r) if r is not None else None).build())
        t0 = time.perf_counter()
        graph.run()
        st = graph.get_stats()["Operators"]
        win = next(o for o in st if o["name"] == "win")
        src = next(o for o in st if o["name"] == "late_src")
        c = {k: sum(r.get(k, 0) for r in win["replicas"])
             for k in ("Inputs_received", "Late_records", "Late_admitted",
                       "Late_dropped")}
        if not rows:
            fail(f"late {engine}: no window fired")
        if c["Inputs_received"] != LATE_N or c["Late_admitted"] != admit \
                or c["Late_dropped"] != drop \
                or c["Late_records"] != admit + drop:
            fail(f"late {engine}: counts {c} != the model's admitted "
                 f"{admit}, dropped {drop}")
        held = [sum(r[k] for r in src["replicas"])
                for k in ("Timer_cuts_held", "Timer_cuts_backstop")]
        if held[0] < 2:
            # the pauses before pushes 191 and 1,471 make the cadence due
            # inside watermark runs: two held cuts at least
            fail(f"late {engine}: {held[0]} timer cuts held at a watermark "
                 "step, not the two or more the pauses make due")
        got[engine] = {**c, "source_puncts": sum(
            r.get("Punctuations_sent", 0) for r in src["replicas"]),
            "timer_cuts_held": held[0], "timer_cuts_backstop": held[1],
            "run_s": round(time.perf_counter() - t0, 3)}
    phase("mesh", part="late", card=card, model={"Late_admitted": admit,
                                                 "Late_dropped": drop},
          **got)


def mesh_phase(torch, wt, card):
    """Phase ``mesh``: the mesh plane with MESH_VDEV virtual shards, on
    one group and on groups of cuda:0 (and of each card where there are
    several; parts ``ffat``, ``late``, ``ops``, ``restore``,
    ``degrade``). Returns K1's launches on the mesh paths."""
    from windflow_tpu_torch.mesh import core as mcore
    prev = mcore.virtual_device_count()
    mcore.ensure_virtual_devices(MESH_VDEV)
    try:
        launches = mesh_ffat_part(torch, wt, card)
        mesh_late_part(torch, wt, card)
        mesh_ops_part(torch, wt, card)
        launches += mesh_restore_part(torch, wt, card)
        n, gold = mesh_degrade_part(torch, wt, card)
        launches += n
        # the lost shards one whole group: the second group's card (and
        # a second real card where there is one)
        layouts = [["cuda:0"] * 2] + ([["cuda:0", "cuda:1"]]
                                      if torch.cuda.device_count() >= 2
                                      else [])
        for devs in layouts:
            launches += mesh_degrade_part(torch, wt, card, devs, gold)[0]
    finally:
        mcore.ensure_virtual_devices(prev)
    return launches


# ---------------------------------------------------------------------------
# phase ysb: BASELINE's Yahoo Streaming Benchmark on Kafka (memory://), and
# part win: BASELINE's win_tests shape on the host plane
# ---------------------------------------------------------------------------
YSB_CAMPAIGNS, YSB_ADS = 100, 10        # examples/ysb.py
YSB_TS_STEP_US = 100                    # event-time spacing
YSB_WIN_US = 10_000_000                 # 10 s tumbling windows
YSB_PARTITIONS, YSB_SRC_PAR = 8, 2
YSB_BATCH = 4096                        # output batches, columnar blocks
YSB_EVENTS = 1_000_000                  # 100 s of event time
YSB_PACED_EVENTS = 300_000
YSB_HOST_EVENTS = 100_000   # per-tuple Python: one 10 s window a campaign
YSB_BROKER = "chip_smoke_ysb"
YSB_MEASURED = {}  # ysb_phase's device events/s and paced p99 (ms)
# win_tests shape at a user's size: WIN_KEYS keys x WIN_LEN tuples each
WIN_KEYS, WIN_LEN, WIN_TS_STEP = 1_000, 60, 137
WIN_TB, WIN_CB = (1_000, 400), (13, 5)
WIN_JOIN_KEYS, WIN_JOIN_LEN, WIN_JOIN_BOUNDS = 100, 200, (120, 200)


@dataclasses.dataclass
class _AdEvent:
    """YSB's ad event (examples/ysb.py ``AdEvent``): the device staging
    infers its columns from the fields."""

    ad_id: int
    event_type: int  # 0 view, 1 click, 2 purchase
    ts: int
    ing: int  # ingest wall clock, us since the run started


def _ysb_fill(kafka, n_events):
    """The broker, filled once: event i is ad i % 1,000, type i % 3, at
    event time i * 100 us, on partition i % 8 (examples/ysb.py)."""
    b = kafka.MemoryBroker.get(YSB_BROKER, YSB_PARTITIONS)
    n_ads = YSB_CAMPAIGNS * YSB_ADS
    for i in range(n_events):
        b.produce("ad_events", {"ad_id": i % n_ads, "event_type": i % 3,
                                "ts": i * YSB_TS_STEP_US}, key=i % 8)


def _ysb_model(n_events):
    """The closed form of examples/ysb.py: views (i % 3 == 0) counted per
    (campaign, 10 s window)."""
    i = np.arange(0, n_events, 3, dtype=np.int64)
    camp = (i % (YSB_CAMPAIGNS * YSB_ADS)) // YSB_ADS
    wid = i * YSB_TS_STEP_US // YSB_WIN_US
    keys, counts = np.unique(camp * 1_000_000 + wid, return_counts=True)
    return {(int(k // 1_000_000), int(k % 1_000_000)): int(c)
            for k, c in zip(keys, counts)}


def _ysb_source(kafka, group, clock, n_events, blocks=False, rate=0.0,
                hook=None, record=None):
    """Kafka_Source over the filled broker under its own consumer group,
    stopping at event ``n_events``; ``rate`` (events/s) paces the ingest
    by each event's index (examples/ysb.py ``YSB_RATE``); ``blocks``
    decodes whole batch polls into columns (``with_columnar_blocks``),
    the watermark the lowest of the replica's partitions' last ts;
    ``hook()`` runs before each batch poll is decoded (blocks only);
    ``record`` (a list, rows only) receives ``(ad_id, ts, ingest stamp)``
    of every view shipped."""
    stop_ts = n_events * YSB_TS_STEP_US

    def pace(ts):
        if rate > 0:
            lag = (ts / YSB_TS_STEP_US) / rate * 1e6 - clock()
            while lag > 500:
                time.sleep(min(0.005, lag / 1e6))
                lag = (ts / YSB_TS_STEP_US) / rate * 1e6 - clock()

    def deser(msg, shipper):
        if msg is None:
            return False
        p = msg.payload
        if p["ts"] >= stop_ts:
            return False
        pace(p["ts"])
        ing = clock()
        shipper.push_with_timestamp(
            _AdEvent(p["ad_id"], p["event_type"], p["ts"], ing), p["ts"])
        if record is not None and p["event_type"] == 0:
            record.append((p["ad_id"], p["ts"], ing))
        shipper.set_next_watermark(p["ts"])
        return True

    last = {}  # replica -> {partition: its last ts}

    def deser_blocks(msgs, shipper, ctx):
        if msgs is None:
            return False
        if hook is not None:
            hook()
        ts = np.fromiter((m.payload["ts"] for m in msgs), np.int64,
                         len(msgs))
        keep = ts < stop_ts
        if not keep.any():
            return False
        n = int(keep.sum())
        now = clock()
        shipper.push_columns({
            "ad_id": np.fromiter((m.payload["ad_id"] for m in msgs),
                                 np.int32, len(msgs))[keep],
            "event_type": np.fromiter((m.payload["event_type"]
                                       for m in msgs), np.int32,
                                      len(msgs))[keep],
            "ing": np.full(n, now, np.int32)}, ts[keep])
        # per-partition watermark: a batch poll is one partition's run
        mine = last.setdefault(ctx.get_replica_index(), {})
        mine[msgs[-1].partition] = int(ts[keep][-1])
        if len(mine) == YSB_PARTITIONS // YSB_SRC_PAR:
            shipper.set_next_watermark(min(mine.values()))
        return bool(keep.all())

    b = (kafka.Kafka_Source_Builder(deser_blocks if blocks else deser)
         .with_brokers(f"memory://{YSB_BROKER}").with_topics("ad_events")
         .with_group_id(group).with_idleness(100)
         .with_parallelism(YSB_SRC_PAR).with_output_batch_size(YSB_BATCH)
         .with_name("kafka_src"))
    if blocks:
        b = b.with_columnar_blocks(YSB_BATCH)
    return b.build()


def _ysb_device_ops(wt):
    """Filter_GPU (views) -> Map_GPU (ad -> campaign) -> Ffat_Windows_GPU
    keyed by campaign (examples/ysb.py's device chain, ``YSB_DEVICE_CHAIN``),
    with the example's own combine (``_ysb_last``: counts add, ``last_ing``
    is the later side's), which K1 runs as a traced variant."""
    views = wt.Filter_GPU_Builder(lambda f: f["event_type"] == 0) \
        .with_name("views").build()
    project = wt.Map_GPU_Builder(
        lambda f: {"campaign": f["ad_id"] // YSB_ADS,
                   "one": f["event_type"] * 0 + 1, "ing": f["ing"]}) \
        .with_name("project").build()
    win = (wt.Ffat_Windows_GPU_Builder(
               lambda f: {"count": f["one"], "last_ing": f["ing"]},
               _ysb_last)
           .with_key_by("campaign").with_tb_windows(YSB_WIN_US, YSB_WIN_US)
           .with_num_win_per_batch(32).with_key_capacity(YSB_CAMPAIGNS)
           .with_name("ysb_win").build())
    return [views, project, win]


def _ysb_run(wt, kafka, device, group, n_events, blocks=False, rate=0.0,
             graph_kw=None, setup=None, lat_at=None, record=None,
             lasts=None):
    """One YSB run on the device chain: the (campaign, wid) -> count map,
    the number of valid rows the sink took, the latencies (ms, source
    ingest -> window emit), events/s (run start -> the last window's
    delivery), the window operator and the graph. ``graph_kw`` goes to
    the PipeGraph, ``setup(graph)`` runs before the run, ``lat_at`` (a
    list) receives ``(receipt time, latency ms)`` pairs, ``record`` goes
    to the source and ``lasts`` (a dict) receives each window's
    ``last_ing``."""
    counts, n_rows, lat, t_last = {}, [0], [], [0.0]
    t0 = time.perf_counter()

    def clock():
        return int((time.perf_counter() - t0) * 1e6)

    def sink(cols, ts):
        if cols is None:
            return
        now = clock()
        v = cols["valid"].astype(bool)
        n_rows[0] += int(v.sum())
        for c, w, n in zip(cols["campaign"][v].tolist(),
                           cols["wid"][v].tolist(),
                           cols["count"][v].tolist()):
            counts[(c, w)] = n
        if lasts is not None:
            lasts.update(zip(zip(cols["campaign"][v].tolist(),
                                 cols["wid"][v].tolist()),
                             cols["last_ing"][v].tolist()))
        ms = ((now - cols["last_ing"][v]) / 1e3).tolist()
        lat.extend(ms)
        t_last[0] = time.perf_counter()
        if lat_at is not None:
            lat_at.extend((t_last[0], x) for x in ms)

    graph = wt.PipeGraph("ysb", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device,
                         **(graph_kw or {}))
    ops = _ysb_device_ops(wt)
    mp = graph.add_source(_ysb_source(kafka, group, clock, n_events,
                                      blocks, rate, record=record))
    for op in ops:
        mp = mp.add(op)
    mp.add_sink(wt.Sink_Builder(sink).with_columns().build())
    if setup is not None:
        setup(graph)
    t0 = time.perf_counter()
    graph.run()
    return (counts, n_rows[0], lat, n_events / (t_last[0] - t0), ops[-1],
            graph)


def _pcts(lat):
    s = sorted(lat)
    if not s:
        return None, None
    return s[len(s) // 2], s[min(len(s) - 1, max(0, -(-len(s) * 99 // 100)
                                                  - 1))]


def _ysb_check(name, counts, n_rows, model, *others):
    """Counts equal the model (and each other run's), and the sink took
    one row per (campaign, window): a window fired twice fails even when
    its last row is right."""
    if n_rows != len(counts):
        fail(f"ysb {name}: the sink took {n_rows} rows for {len(counts)} "
             "campaign-windows")
    if counts != model:
        bad = sum(counts.get(k) != v for k, v in model.items())
        fail(f"ysb {name}: {bad} of {len(model)} campaign-window counts "
             f"differ from the model ({len(counts)} rows)")
    for what, other in others:
        if counts != other:
            fail(f"ysb {name}: counts differ from {what}")


def _ysb_check_lasts(shipped, lasts):
    """Each window's ``last_ing`` is an ingest stamp the source shipped
    for one of that (campaign, window)'s views: the example's combine
    keeps the later side's, and which row arrives last across the two
    source replicas is a race."""
    stamps = {}
    for ad, ts, ing in shipped:
        stamps.setdefault((ad // YSB_ADS, ts // YSB_WIN_US), set()).add(ing)
    bad = [k for k, li in lasts.items() if li not in stamps.get(k, ())]
    if bad or not lasts:
        fail(f"ysb device: {len(bad)} of {len(lasts)} windows' last_ing is "
             f"no stamp their source shipped (e.g. {bad[:3]})")


def ysb_phase(torch, wt, card):
    """Phase ``ysb`` (parts ``device``, ``paced``, ``blocks``, ``host``)
    and its part ``win``. Returns K1's launches on the YSB device runs."""
    from windflow_tpu_torch import kafka
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    kafka.MemoryBroker.reset()
    t_fill = time.perf_counter()
    _ysb_fill(kafka, YSB_EVENTS)
    fill_s = time.perf_counter() - t_fill
    model = _ysb_model(YSB_EVENTS)
    cpu, cpu_rows = _ysb_run(wt, kafka, "cpu", "cpu", YSB_EVENTS)[:2]
    _ysb_check("cpu", cpu, cpu_rows, model)
    # part device: Kafka rows -> device chain
    _reset_launches(fr)
    torch.cuda.synchronize()
    shipped, lasts = [], {}
    counts, n_rows, lat, eps, win, g = _ysb_run(
        wt, kafka, "cuda", "device", YSB_EVENTS, record=shipped,
        lasts=lasts)
    k1 = _launched("ysb device", fr, win.replicas[0])
    _ysb_check("device", counts, n_rows, model, ("the CPU run", cpu))
    _ysb_check_lasts(shipped, lasts)
    p50, p99 = _pcts(lat)
    prof = _profiled(torch, lambda: _ysb_run(wt, kafka, "cuda", "prof",
                                             YSB_EVENTS),
                     YSB_EVENTS // YSB_BATCH)
    launches = _launch_counts(fr)  # the device run's and the profiled's
    phase("ysb", part="device", card=card, events=YSB_EVENTS,
          campaigns=YSB_CAMPAIGNS, ads_per_campaign=YSB_ADS,
          partitions=YSB_PARTITIONS, source_parallelism=YSB_SRC_PAR,
          batch=YSB_BATCH, window_us=YSB_WIN_US,
          campaign_windows=len(counts), sink_rows=n_rows,
          counts_equal_model=True, counts_equal_cpu=True,
          last_ing_shipped=True, events_per_s=eps, latency_p50_ms=p50,
          latency_p99_ms=p99, rebuild_launches=k1.total(),
          broker_fill_s=fill_s,
          profiled=prof)
    # part paced: half the device part's rate, YSB's latency protocol
    model_p = _ysb_model(YSB_PACED_EVENTS)
    _reset_launches(fr)
    counts_p, rows_p, lat_p, eps_p, win_p, _ = _ysb_run(
        wt, kafka, "cuda", "paced", YSB_PACED_EVENTS, rate=eps / 2)
    _ysb_check("paced", counts_p, rows_p, model_p)
    p50p, p99p = _pcts(lat_p)
    # the observe phase's overload part sizes its SLO from these
    YSB_MEASURED.update(device_events_per_s=eps, paced_p99_ms=p99p)
    k1_p = _launched("ysb paced", fr, win_p.replicas[0])
    launches += k1_p
    phase("ysb", part="paced", card=card, events=YSB_PACED_EVENTS,
          target_events_per_s=eps / 2, events_per_s=eps_p,
          campaign_windows=len(counts_p), sink_rows=rows_p,
          counts_equal_model=True,
          latency_p50_ms=p50p, latency_p99_ms=p99p,
          rebuild_launches=k1_p.total())
    # part blocks: the same chain fed by columnar blocks
    _reset_launches(fr)
    counts_b, rows_b, lat_b, eps_b, win_b, _ = _ysb_run(
        wt, kafka, "cuda", "blocks", YSB_EVENTS, blocks=True)
    _ysb_check("blocks", counts_b, rows_b, model,
               ("the row-fed run", counts))
    p50b, p99b = _pcts(lat_b)
    k1_b = _launched("ysb blocks", fr, win_b.replicas[0])
    launches += k1_b
    phase("ysb", part="blocks", card=card, events=YSB_EVENTS,
          block=YSB_BATCH, events_per_s=eps_b,
          campaign_windows=len(counts_b), sink_rows=rows_b,
          counts_equal_model=True,
          counts_equal_rows=True, latency_p50_ms=p50b,
          latency_p99_ms=p99b,
          rebuild_launches=k1_b.total())
    ysb_host_part(wt, kafka, card, counts_p)
    kafka.MemoryBroker.reset()
    win_part(wt, card)
    return launches


def ysb_host_part(wt, kafka, card, paced_counts):
    """Part ``host``: examples/ysb.py's CPU variant, host Filter / Map at
    parallelism 2 -> host Ffat_Windows over (count, latest ingest) with
    the example's own combine, over the first YSB_HOST_EVENTS events
    (per-tuple Python); counts equal the model and the paced device run's
    windows over the same events."""
    counts, n_rows, lat, t_last = {}, [0], [], [0.0]
    t0 = time.perf_counter()

    def clock():
        return int((time.perf_counter() - t0) * 1e6)

    def sink(r):
        if r is not None and r.value is not None:
            n_rows[0] += 1
            counts[(r.key, r.wid)] = r.value[0]
            lat.append((clock() - r.value[1]) / 1e3)
            t_last[0] = time.perf_counter()

    g = wt.PipeGraph("ysb_host", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT_TIME, device="cpu")
    src = _ysb_source(kafka, "host", clock, YSB_HOST_EVENTS)
    src.output_batch_size = 0
    views = (wt.Filter_Builder(lambda e: e.event_type == 0)
             .with_parallelism(YSB_SRC_PAR).build())
    project = (wt.Map_Builder(lambda e: (e.ad_id // YSB_ADS, e.ing))
               .with_parallelism(YSB_SRC_PAR).build())
    win = (wt.Ffat_Windows_Builder(lambda e: (1, e[1]),
                                   lambda a, b: (a[0] + b[0], b[1]))
           .with_key_by(lambda e: e[0])
           .with_tb_windows(YSB_WIN_US, YSB_WIN_US).build())
    g.add_source(src).add(views).add(project).add(win) \
        .add_sink(wt.Sink_Builder(sink).build())
    t0 = time.perf_counter()
    g.run()
    eps = YSB_HOST_EVENTS / (t_last[0] - t0)
    n_win = YSB_HOST_EVENTS * YSB_TS_STEP_US // YSB_WIN_US
    _ysb_check("host", counts, n_rows[0], _ysb_model(YSB_HOST_EVENTS),
               ("the paced device run", {k: v for k, v in
                                         paced_counts.items()
                                         if k[1] < n_win}))
    p50, p99 = _pcts(lat)
    phase("ysb", part="host", card=card, events=YSB_HOST_EVENTS,
          events_per_s=eps, campaign_windows=len(counts),
          sink_rows=n_rows[0], counts_equal_model=True,
          counts_equal_device=True,
          latency_p50_ms=p50, latency_p99_ms=p99)


# -- part win ----------------------------------------------------------------
def _win_source(n_keys, length):
    """win_tests' keyed event-time stream at WIN_KEYS keys: key k's i-th
    tuple carries value (i + k) % 97 + 1 at ts i * WIN_TS_STEP + k % 2;
    two replicas, disjoint keys (k % 2), so the merged order has no tie
    between them; the watermark at each step."""
    def src(shipper, ctx):
        r, p = ctx.get_replica_index(), ctx.get_parallelism()
        for i in range(length):
            ts = i * WIN_TS_STEP + r
            for k in range(r, n_keys, p):
                shipper.push_with_timestamp({"k": k, "v": (i + k) % 97 + 1},
                                            ts)
            shipper.set_next_watermark(ts)
    return src


def _disordered_source(n_keys, length):
    """One replica, every key at each step, each tuple up to 2 steps
    early or late (seeded): PROBABILISTIC mode's input."""
    jitter = np.random.default_rng(81).integers(
        -2 * WIN_TS_STEP, 2 * WIN_TS_STEP + 1, (length, n_keys))

    def src(shipper):
        for i in range(length):
            for k in range(n_keys):
                ts = max(0, i * WIN_TS_STEP + int(jitter[i, k]))
                shipper.push_with_timestamp({"k": k, "v": 1}, ts)
    return src


def _win_model(kind):
    """Independent model of the rows: per key, CB windows over the arrival
    order, TB windows [w*slide, w*slide+win) over the timestamps (every
    window the key's stream reaches, partial ones flushed at EOS); and, for
    DETERMINISTIC mode, the firing order of one replica: the two replicas'
    streams merged by timestamp, a window firing on its key's first tuple
    past its end, the rest at EOS in the order the keys first came. Returns
    (rows as a dict, rows in firing order)."""
    n_keys, length = WIN_KEYS, WIN_LEN
    win, slide = WIN_CB if kind == "cb" else WIN_TB
    rows, ends, idx = {}, {}, {}
    for k in range(n_keys):
        vals = (np.arange(length) + k) % 97 + 1
        ix = np.arange(length) if kind == "cb" \
            else np.arange(length) * WIN_TS_STEP + k % 2
        last = int(ix[-1])
        n_win = -(-(last + 1) // slide) if win >= slide \
            else last // slide + 1
        starts = np.arange(n_win) * slide
        csum = np.concatenate([[0], np.cumsum(vals)])
        sums = csum[np.searchsorted(ix, starts + win)] \
            - csum[np.searchsorted(ix, starts)]
        for w in range(n_win):
            rows[(k, w)] = int(sums[w])
        ends[k], idx[k] = starts + win, ix
    order, fired = [], [0] * n_keys
    stream = [k for i in range(length) for r in (0, 1)
              for k in range(r, n_keys, 2)]
    pos = [0] * n_keys
    for k in stream:
        at = idx[k][pos[k]]
        pos[k] += 1
        while fired[k] < len(ends[k]) and ends[k][fired[k]] <= at:
            order.append((k, fired[k], rows[(k, fired[k])]))
            fired[k] += 1
    first_seen = list(dict.fromkeys(stream))
    for k in first_seen:
        order.extend((k, w, rows[(k, w)])
                     for w in range(fired[k], len(ends[k])))
    return rows, order


def _join_model():
    """Every (key, i_a, i_b) with ts_b in [ts_a - lower, ts_a + upper]."""
    lo, hi = WIN_JOIN_BOUNDS
    ta = np.arange(WIN_JOIN_LEN) * 100
    tb = np.arange(WIN_JOIN_LEN) * 83
    ii, jj = np.nonzero((tb[None, :] >= ta[:, None] - lo)
                        & (tb[None, :] <= ta[:, None] + hi))
    return {(k, int(i), int(j)) for k in range(WIN_JOIN_KEYS)
            for i, j in zip(ii, jj)}


def _join_source(step):
    def src(shipper, ctx):
        r, p = ctx.get_replica_index(), ctx.get_parallelism()
        for i in range(WIN_JOIN_LEN):
            ts = i * step
            for k in range(r, WIN_JOIN_KEYS, p):
                shipper.push_with_timestamp({"k": k, "i": i}, ts)
            shipper.set_next_watermark(ts)
    return src


def _win_op(wt, kind, par):
    """The operator of one win_tests graph, at parallelism ``par``."""
    sum_ws = lambda ws: sum(w["v"] for w in ws)  # noqa: E731
    key = lambda t: t["k"]  # noqa: E731
    if kind in ("keyed_cb", "keyed_tb"):
        b = wt.Keyed_Windows_Builder(sum_ws).with_key_by(key)
        b = b.with_cb_windows(*WIN_CB) if kind == "keyed_cb" \
            else b.with_tb_windows(*WIN_TB)
        return b.with_parallelism(par).build()
    if kind == "paned_tb":
        return (wt.Paned_Windows_Builder(sum_ws, lambda vs: sum(vs))
                .with_key_by(key).with_tb_windows(*WIN_TB)
                .with_parallelism(par, par).build())
    if kind == "mapreduce_tb":
        return (wt.MapReduce_Windows_Builder(sum_ws, lambda vs: sum(vs))
                .with_key_by(key).with_tb_windows(*WIN_TB)
                .with_parallelism(par, par).build())
    b = (wt.Interval_Join_Builder(lambda a, b_: (a["k"], a["i"], b_["i"]))
         .with_key_by(key).with_boundaries(*WIN_JOIN_BOUNDS)
         .with_parallelism(par))
    return (b.with_kp_mode() if kind == "join_kp" else b.with_dp_mode()) \
        .build()


def _win_run(wt, kind, mode, win_par=2, src=None):
    rows, lock = [], threading.Lock()

    def sink(r):
        if r is not None:
            with lock:
                rows.append(r if kind.startswith("join")
                            else (r.key, r.wid, r.value))

    g = wt.PipeGraph(f"win_{kind}", getattr(wt.ExecutionMode, mode),
                     wt.TimePolicy.EVENT_TIME, device="cpu")
    if kind.startswith("join"):
        a = g.add_source(wt.Source_Builder(_join_source(100))
                         .with_parallelism(2).build())
        mp = a.merge(g.add_source(wt.Source_Builder(_join_source(83))
                                  .with_parallelism(2).build()))
        n_in = 2 * WIN_JOIN_KEYS * WIN_JOIN_LEN
    else:
        b = wt.Source_Builder(src) if src is not None else \
            wt.Source_Builder(_win_source(WIN_KEYS, WIN_LEN)) \
            .with_parallelism(2)
        mp = g.add_source(b.build())
        n_in = WIN_KEYS * WIN_LEN
    mp.add(_win_op(wt, kind, win_par)).add_sink(wt.Sink_Builder(sink).build())
    t0 = time.perf_counter()
    g.run()
    return rows, n_in / (time.perf_counter() - t0), g


def win_part(wt, card):
    """Part ``win``: Keyed_Windows CB and TB, Paned_Windows and
    MapReduce_Windows TB, Interval_Join KP and DP, each in DEFAULT and
    DETERMINISTIC (operators at parallelism 2 behind two source replicas);
    rows equal the model. In DETERMINISTIC mode one Keyed_Windows replica
    also emits in the model's order. PROBABILISTIC: Keyed_Windows TB with
    its K-slack drops, delivered + dropped == produced."""
    models = {k: _win_model(k) for k in ("cb", "tb")}
    join = _join_model()
    for kind in ("keyed_cb", "keyed_tb", "paned_tb", "mapreduce_tb",
                 "join_kp", "join_dp"):
        for mode in ("DEFAULT", "DETERMINISTIC"):
            rows, tps, _ = _win_run(wt, kind, mode)
            if kind.startswith("join"):
                ok = len(rows) == len(set(rows)) and set(rows) == join
            else:
                want = models["cb" if kind == "keyed_cb" else "tb"][0]
                got = {(k, w): v for k, w, v in rows}
                ok = len(got) == len(rows) and got == want
            if not ok:
                fail(f"win {kind} {mode}: rows differ from the model")
            row = dict(part="win", op=kind, mode=mode, card=card,
                       keys=WIN_JOIN_KEYS if kind.startswith("join")
                       else WIN_KEYS, rows=len(rows), tuples_per_s=tps,
                       rows_equal_model=True)
            if mode == "DETERMINISTIC" and kind.startswith("keyed"):
                seq, tps1, _ = _win_run(wt, kind, mode, win_par=1)
                if seq != models["cb" if kind == "keyed_cb" else "tb"][1]:
                    fail(f"win {kind} {mode}: the single replica's rows "
                         "are not in the model's order")
                row.update(order_equal_model=True,
                           tuples_per_s_one_replica=tps1)
            phase("ysb", **row)
    # PROBABILISTIC, over one disordered replica: K-slack collectors in
    # front of the window stage and the sink drop what arrives behind
    # their frontier; every produced
    # tuple is admitted by a window replica or dropped, and every window
    # result reaches the sink or is dropped there
    rows, tps, g = _win_run(wt, "keyed_tb", "PROBABILISTIC",
                            src=_disordered_source(WIN_KEYS, WIN_LEN))
    ops = {o["name"]: o["replicas"] for o in g.get_stats()["Operators"]}
    win_in = sum(r["Inputs_received"] for r in ops["keyed_windows"])
    win_out = sum(r["Outputs_sent"] for r in ops["keyed_windows"])
    sink_in = sum(r["Inputs_received"] for r in ops["sink"])
    dropped = g.get_num_dropped_tuples()
    dropped_tuples = dropped - (win_out - sink_in)
    if win_in + dropped_tuples != WIN_KEYS * WIN_LEN \
            or len(rows) != sink_in or dropped_tuples < 0:
        fail(f"win keyed_tb PROBABILISTIC: {win_in} admitted + "
             f"{dropped_tuples} dropped != {WIN_KEYS * WIN_LEN} produced")
    phase("ysb", part="win", op="keyed_tb", mode="PROBABILISTIC",
          card=card, keys=WIN_KEYS, tuples_per_s=tps, admitted=win_in,
          dropped_tuples=dropped_tuples, results=win_out,
          dropped_results=win_out - sink_in, conserved=True)


# ---------------------------------------------------------------------------
# exactly_once: the transactional sinks, the replayable columnar ingest and
# the persistent operators (parts columnar, kafka, replay, persistent)
# ---------------------------------------------------------------------------
EO_CKPT_EVERY = 4      # columnar: a checkpoint every 4 batches
EO_CRASH_AT = 14       # columnar: killed before this batch
EO_WAIT_S = 120.0
EO_KAFKA_CKPT_S = 2.0  # kafka: a checkpoint every 2 s
EO_KAFKA_CRASH_FRAC = 0.6  # kafka: slow down past this share, then die
EO_KAFKA_TURNS = 1     # kafka: turns of plain and exactly-once (2 until the
                       # kafka_client part came; the second gave a spread)
# kafka_client: YSB rows through the real-broker adapters over the fake
# client modules of tests/torch_kafka_clients.py
KC_EVENTS = 200_000
KC_BROKERS = "localhost:9092"
KC_FAULTS = 3          # transient poll errors injected into the first run
# replay: bench.py's _replay_mode (bench.py:1097-1262) at its own settings
REPLAY_KEYS, REPLAY_RATE, REPLAY_BLOCK = 512, 12_000, 512
REPLAY_PHASE_S, REPLAY_LATE, REPLAY_LATENESS_US = 2.0, 0.05, 200_000
REPLAY_CURVE = (0.5, 1.0, 2.0, 1.5, 0.7)
REPLAY_WIN_US, REPLAY_PAR = 500_000, 2
# persistent: 10,240 keys, 100,000 tuples (200,000 until PR 12 halved the
# stream to keep the script inside its time), an LRU cache of 1,024 entries
P_KEYS, P_TUPLES, P_CACHE, P_BLOCK = 10_240, 100_000, 1_024, 4_096
P_CB = (13, 5)


def _build_dir(*names):
    import shutil
    d = os.path.join(HERE, "build", *names)
    shutil.rmtree(d, ignore_errors=True)
    return d


def _wait_until(what, cond):
    deadline = time.monotonic() + EO_WAIT_S
    while not cond():
        if time.monotonic() > deadline:
            fail(f"exactly_once: timed out waiting for {what}")
        time.sleep(0.005)


class _TripleBlocks:
    """Replayable block functor of a Columnar_Source over the main path's
    stream: an ``ArrayBlockSource`` over its columns and timestamps whose
    yields carry each batch's watermark, ``(cols, ts, wm)``, so that the
    windows fire as in the stream itself. Every ``every`` batches it asks
    ``graph`` for a checkpoint (the barrier lands before that batch), and
    before batch ``crash_at`` it waits for the checkpoints so far to
    commit, then raises."""

    def __init__(self, wt, blocks, every=0, crash_at=None):
        names = list(blocks[0][0])
        self.bs = len(blocks[0][1])
        self.src = wt.ArrayBlockSource(
            {k: np.concatenate([b[0][k] for b in blocks]) for k in names},
            np.concatenate([b[1] for b in blocks]), block_size=self.bs)
        self.wms = [b[2] for b in blocks]
        self.every, self.crash_at = every, crash_at
        self.graph = None

    def __call__(self):
        for cols, ts in self.src():
            i = self.src.snapshot_position() // self.bs
            if i == self.crash_at:
                coord = self.graph._coordinator
                _wait_until("the checkpoints before the crash",
                            lambda: coord.completed >= (i - 1) // self.every)
                raise _InjectedCrash(f"killed before batch {i}")
            if self.every and i and i % self.every == 0:
                self.graph.trigger_checkpoint()
            yield cols, ts, self.wms[i]

    def snapshot_position(self):
        return self.src.snapshot_position()

    def restore(self, pos):
        self.src.restore(pos)


def _eo_columnar_run(wt, device, src, store, txn=None, restore_from=None,
                     crash=False):
    """Columnar source (block size 65,536, an int32 schema) ->
    Ffat_Windows_GPU (the HC window) -> a columnar sink, at-least-once or
    (``txn``) exactly-once, checkpointing into ``store``. Returns the
    functor's batches, the graph, the window operator and the run's wall
    time."""
    parts, sink = _sink_parts()
    graph = wt.PipeGraph("eo_columnar", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device)
    graph.with_checkpointing(store_dir=store)
    src.graph = graph
    win = (wt.Ffat_Windows_GPU_Builder(lambda f: {"value": f["value"]},
                                       wt.fieldwise(value="sum"))
           .with_key_by("key").with_tb_windows(WIN_US, SLIDE_US)
           .with_key_capacity(HC_KEYS).with_name("ffat").build())
    snk = wt.Sink_Builder(sink).with_columns().with_name("eo_sink")
    if txn is not None:
        snk = snk.with_exactly_once(staging_dir=txn)
    graph.add_source(wt.Columnar_Source_Builder(src).with_name("src")
                     .with_block_size(BATCH)
                     .with_schema({"key": np.int32, "value": np.int32})
                     .with_output_batch_size(BATCH).build()) \
        .add(win).add_sink(snk.build())
    t0 = time.perf_counter()
    try:
        graph.run(restore_from)
    except _InjectedCrash:
        if not crash:
            raise
    else:
        if crash:
            fail("exactly_once columnar: the injected crash did not end "
                 "the run")
    return parts, graph, win, time.perf_counter() - t0


def _sorted_windows(parts):
    cols = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    order = np.lexsort((cols["wid"], cols["key"]))
    return {k: v[order] for k, v in cols.items()}


def _committed_windows(root):
    """The committed window rows of a columnar exactly-once sink, as the
    main path's sink keeps them; fails on a (key, wid) committed twice."""
    from windflow_tpu_torch.sinks.transactional import read_committed_records
    recs = read_committed_records(root)
    cols = _sorted_windows([{"ts": ts, **c} for c, ts in recs])
    pairs = cols["key"].astype(np.int64) * (1 << 32) + cols["wid"]
    if len(np.unique(pairs)) != len(pairs):
        fail(f"exactly_once: a (key, wid) window is committed twice in "
             f"{root}")
    return cols


def _txn_numbers(graph, name):
    """The sink replica's Sink_txn_* counters and the driver's mean
    pre-commit, commit and precommit -> commit times."""
    rep = next(op for op in graph._ops if op.name == name).replicas[0]
    drv, st = rep._txn, rep.stats
    return dict(precommits=st.txn_precommits, commits=st.txn_commits,
                aborts=st.txn_aborts, fenced_writes=st.txn_fenced_writes,
                precommit_ms_mean=drv.precommit_total_us / 1e3
                / max(1, st.txn_precommits),
                commit_ms_mean=drv.commit_total_us / 1e3
                / max(1, drv.commits),
                commit_latency_ms_mean=drv.commit_latency_total_us / 1e3
                / max(1, drv.commits))


def _staged_bytes_per_epoch(root):
    segs = [f for f in os.listdir(root) if f.endswith(".seg")]
    return (sum(os.path.getsize(os.path.join(root, f)) for f in segs)
            / max(1, len(segs)), len(segs))


def eo_columnar_part(torch, wt, card):
    """Part ``columnar``: the HC main path into an exactly-once columnar
    sink. Returns K1's launches."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    blocks = _blocks(HC_KEYS, seed=29)
    tuples = len(blocks) * BATCH
    ref = _run_graph(wt, "cpu", blocks, HC_KEYS, None)[0]
    rates = {"plain": [], "exactly_once": []}
    launches, txn_root, eo_graph = Counter(), None, None
    for turn in range(2):
        for mode in ("plain", "exactly_once"):
            txn = (_build_dir("txn", f"eo_columnar_{turn}")
                   if mode == "exactly_once" else None)
            _reset_launches(fr)
            torch.cuda.synchronize()
            parts, graph, win, wall = _eo_columnar_run(
                wt, "cuda", _TripleBlocks(wt, blocks, EO_CKPT_EVERY),
                _build_dir("ckpt", f"eo_columnar_{mode}_{turn}"), txn)
            launches += _launched(f"exactly_once columnar {mode}", fr,
                                  win.replicas[0])
            rates[mode].append(tuples / wall)
            if mode == "plain":
                _check_windows("exactly_once columnar plain", "the CPU run",
                               _sorted_windows([p for _, p in parts]), ref)
            else:
                txn_root = os.path.join(txn, "eo_sink_r0")
                eo_graph = graph
                _check_windows("exactly_once columnar", "the CPU run",
                               _committed_windows(txn_root), ref)
                _check_windows("exactly_once columnar functor",
                               "the CPU run",
                               _sorted_windows([p for _, p in parts]), ref)
    uninterrupted = _txn_numbers(eo_graph, "eo_sink")
    staged, epochs = _staged_bytes_per_epoch(txn_root)
    # killed after the checkpoint at batch 12, before batch 14; restored
    store = _build_dir("ckpt", "eo_columnar_crash")
    txn = _build_dir("txn", "eo_columnar_crash")
    _reset_launches(fr)
    _, crashed, win_c, _ = _eo_columnar_run(
        wt, "cuda", _TripleBlocks(wt, blocks, EO_CKPT_EVERY, EO_CRASH_AT),
        store, txn, crash=True)
    k1_crash = _launched("exactly_once columnar crash", fr,
                         win_c.replicas[0])
    _reset_launches(fr)
    t0 = time.perf_counter()
    _, restored, win_r, _ = _eo_columnar_run(
        wt, "cuda", _TripleBlocks(wt, blocks, EO_CKPT_EVERY), store, txn,
        restore_from=store)
    restore_wall = time.perf_counter() - t0
    k1_restored = _launched("exactly_once columnar restored", fr,
                            win_r.replicas[0])
    launches += k1_crash + k1_restored
    root = os.path.join(txn, "eo_sink_r0")
    got = _committed_windows(root)
    _check_windows("exactly_once columnar restored",
                   "the uninterrupted exactly-once run",
                   got, _committed_windows(txn_root))
    _check_windows("exactly_once columnar restored", "the CPU run", got, ref)
    rest = _txn_numbers(restored, "eo_sink")
    if rest["aborts"] < 1:
        fail("exactly_once columnar: the crashed run's pending tail was "
             "not aborted on restore")
    phase("exactly_once", part="columnar", card=card, keys=HC_KEYS,
          batches=N_BATCHES, batch=BATCH, checkpoint_every=EO_CKPT_EVERY,
          crash_before_batch=EO_CRASH_AT,
          windows=int(len(ref["key"])), valid_windows=int(ref["valid"].sum()),
          committed_equal_uninterrupted=True, committed_equal_plain=True,
          committed_equal_cpu=True, no_window_twice=True,
          tuples_per_s_plain=rates["plain"],
          tuples_per_s_exactly_once=rates["exactly_once"],
          txn=uninterrupted, staged_bytes_per_epoch=staged,
          committed_epochs=epochs, restored_txn=rest,
          restored_run_s=restore_wall,
          checkpoints_crashed_run=crashed._coordinator.completed,
          rebuild_launches_crashed=k1_crash.total(),
          rebuild_launches_restored=k1_restored.total(),
          rebuild_launches=launches.total())
    return launches


def _ysb_eo_run(wt, kafka, group, store, out, exactly_once, crash=False,
                restore_from=None):
    """YSB's device chain fed by columnar blocks into a Kafka sink (the
    output topic of broker ``out``), checkpointing every 2 s. With
    ``crash``, a source replica raises once an epoch has committed: past
    60% of the stream it requests one (should the stream be shorter than
    the interval) and slows down until one has. Returns the wall time,
    the window operator and the graph."""
    t0 = time.perf_counter()

    def clock():
        return int((time.perf_counter() - t0) * 1e6)

    graph = wt.PipeGraph("ysb_eo", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device="cuda")
    graph.with_checkpointing(interval=EO_KAFKA_CKPT_S, store_dir=store)
    polls = [0, False]
    lock = threading.Lock()

    def hook():
        with lock:
            polls[0] += 1
            late = polls[0] * YSB_BATCH >= EO_KAFKA_CRASH_FRAC * YSB_EVENTS
            request = late and not polls[1]
            polls[1] = polls[1] or late
        if graph._coordinator.completed >= 1:
            raise _InjectedCrash("killed after the first committed epoch")
        if request:
            graph.trigger_checkpoint()
        if late:
            time.sleep(0.05)  # the barrier injects between polls

    def ser(r):
        if not r["valid"]:
            return None
        return ("ysb_out", None, (int(r["campaign"]), int(r["wid"]),
                                  int(r["count"])))

    ops = _ysb_device_ops(wt)
    mp = graph.add_source(_ysb_source(kafka, group, clock, YSB_EVENTS,
                                      blocks=True,
                                      hook=hook if crash else None))
    for op in ops:
        mp = mp.add(op)
    snk = kafka.Kafka_Sink_Builder(ser).with_brokers(f"memory://{out}") \
        .with_name("ysb_out")
    if exactly_once:
        snk = snk.with_exactly_once()
    mp.add_sink(snk.build())
    t0 = time.perf_counter()
    try:
        graph.run(restore_from)
    except (_InjectedCrash, wt.basic.WorkerFailuresError):
        if not crash:
            raise
    else:
        if crash:
            fail("exactly_once kafka: the injected crash did not end the "
                 "run")
    return time.perf_counter() - t0, ops[-1], graph


def _topic_counts(kafka, out):
    """What a read-committed consumer of the output topic sees: the rows
    committed transactions appended (prepared epochs stay in the broker's
    transaction log)."""
    b = kafka.MemoryBroker.get(out)
    rows = [m.payload for part in b._topic("ysb_out") for m in part]
    return {(c, w): n for c, w, n in rows}, len(rows)


def eo_kafka_part(torch, wt, card):
    """Part ``kafka``: YSB into a transactional Kafka sink. Returns K1's
    launches."""
    from windflow_tpu_torch import kafka
    from windflow_tpu_torch.checkpoint import CheckpointStore
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    kafka.MemoryBroker.reset()
    _ysb_fill(kafka, YSB_EVENTS)
    model = _ysb_model(YSB_EVENTS)
    rates = {"plain": [], "exactly_once": []}
    launches = Counter()
    for turn in range(EO_KAFKA_TURNS):
        for mode in ("plain", "exactly_once"):
            out = f"eo_out_{mode}_{turn}"
            _reset_launches(fr)
            wall, win, _ = _ysb_eo_run(
                wt, kafka, f"eo_{mode}_{turn}",
                _build_dir("ckpt", f"eo_kafka_{mode}_{turn}"), out,
                mode == "exactly_once")
            counts, n_rows = _topic_counts(kafka, out)
            _ysb_check(f"exactly_once kafka {mode}", counts, n_rows, model)
            launches += _launched(f"exactly_once kafka {mode}", fr,
                                  win.replicas[0])
            rates[mode].append(YSB_EVENTS / wall)
    store = _build_dir("ckpt", "eo_kafka_crash")
    _reset_launches(fr)
    crashed = _ysb_eo_run(wt, kafka, "eo_crash", store, "eo_out_crash",
                          True, crash=True)[2]
    k1_c = _launch_counts(fr)
    at_crash, rows_crash = _topic_counts(kafka, "eo_out_crash")
    if rows_crash != len(at_crash) or any(model[k] != v
                                          for k, v in at_crash.items()):
        fail("exactly_once kafka: at the crash the topic holds a window "
             "twice or a count the model does not")
    b = kafka.MemoryBroker.get("eo_out_crash")
    txn_id = "wf-txn-ysb_out-r0"
    prepared = b.txn_prepared_epochs(txn_id)
    if not prepared or rows_crash >= len(model):
        fail("exactly_once kafka: the crashed run left no unfinalized "
             "prepared epoch, or its whole output is already visible")
    cid = CheckpointStore(store).latest()
    _reset_launches(fr)
    _, win_r, restored = _ysb_eo_run(wt, kafka, "eo_crash", store,
                                     "eo_out_crash", True,
                                     restore_from=store)
    counts, n_rows = _topic_counts(kafka, "eo_out_crash")
    _ysb_check("exactly_once kafka restored", counts, n_rows, model)
    if b.txn_prepared_epochs(txn_id):
        fail("exactly_once kafka: prepared epochs survive the restore")
    k1_r = _launched("exactly_once kafka restored", fr, win_r.replicas[0])
    launches += k1_c + k1_r
    phase("exactly_once", part="kafka", card=card, events=YSB_EVENTS,
          partitions=YSB_PARTITIONS, source_parallelism=YSB_SRC_PAR,
          block=YSB_BATCH, checkpoint_interval_s=EO_KAFKA_CKPT_S,
          campaign_windows=len(model), counts_equal_model=True,
          each_window_once=True,
          events_per_s_plain=rates["plain"],
          events_per_s_exactly_once=rates["exactly_once"],
          visible_at_crash=rows_crash, prepared_at_crash=prepared,
          restored_from_checkpoint=cid,
          checkpoints_crashed_run=crashed._coordinator.completed,
          restored_txn=_txn_numbers(restored, "ysb_out"),
          rebuild_launches_crashed=k1_c.total(),
          rebuild_launches_restored=k1_r.total(),
          rebuild_launches=launches.total())
    kafka.MemoryBroker.reset()
    return launches


def _fake_kafka_clients():
    """The in-process fake client modules (``tests/torch_kafka_clients.py``
    of this checkout); fails if a real ``confluent_kafka`` or ``kafka``
    is importable, so that a fake never shadows a real client."""
    import importlib.util
    for name in ("confluent_kafka", "kafka"):
        if sys.modules.get(name) is not None \
                or importlib.util.find_spec(name) is not None:
            fail(f"exactly_once kafka_client: a real {name!r} is "
                 "importable; this part installs a fake one")
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_kafka_clients
    return torch_kafka_clients


def _kc_fill(cluster):
    """examples/ysb.py's events on the fake cluster, as ``_ysb_fill``
    writes them to the memory broker: event i on partition i % 8."""
    n_ads = YSB_CAMPAIGNS * YSB_ADS
    for i in range(KC_EVENTS):
        cluster.append("ad_events", {"ad_id": i % n_ads, "event_type": i % 3,
                                     "ts": i * YSB_TS_STEP_US},
                       partition=i % YSB_PARTITIONS)


def _kc_run(wt, kafka, cluster, out, group, store=None, staging=None,
            crash_after=None, restore_from=None):
    """YSB's device chain fed with rows by a Kafka_Source on a real-broker
    string (two replicas, explicit offsets of the 8 partitions; a
    replica's watermark is the lowest last ts of its four, since a
    restored replica resumes them a message apart) into a Kafka_Sink on
    topic ``out``, exactly-once with ``staging``. With ``crash_after`` (a count of committed transactions):
    past 60% of the stream the source requests a checkpoint, slows down,
    and raises once the cluster has committed more transactions than
    that. Returns events/s, the window operator and the graph."""
    t0 = time.perf_counter()

    def clock():
        return int((time.perf_counter() - t0) * 1e6)

    graph = wt.PipeGraph("ysb_kc", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device="cuda")
    if store is not None:
        graph.with_checkpointing(interval=EO_KAFKA_CKPT_S, store_dir=store)
    n = [0, False]
    lock = threading.Lock()
    crash = crash_after is not None
    last = {}  # replica -> {partition: its last ts}

    def deser(msg, shipper, ctx):
        if msg is None:
            return False
        p = msg.payload
        shipper.push_with_timestamp(
            _AdEvent(p["ad_id"], p["event_type"], p["ts"], clock()), p["ts"])
        mine = last.setdefault(ctx.get_replica_index(), {})
        mine[msg.partition] = p["ts"]
        if len(mine) == YSB_PARTITIONS // YSB_SRC_PAR:
            shipper.set_next_watermark(max(shipper.current_watermark,
                                           min(mine.values())))
        if crash:
            with lock:
                n[0] += 1
                request = n[0] >= EO_KAFKA_CRASH_FRAC * KC_EVENTS \
                    and not n[1]
                n[1] = n[1] or request
            if cluster.txn_counts["committed"] > crash_after:
                raise _InjectedCrash("killed after the first committed "
                                     "Kafka transaction")
            if request:
                shipper.request_checkpoint()
            if n[1]:
                time.sleep(0.001)  # the barrier injects between messages
        return True

    src = (kafka.Kafka_Source_Builder(deser).with_brokers(KC_BROKERS)
           .with_topics("ad_events").with_group_id(group).with_idleness(100)
           .with_parallelism(YSB_SRC_PAR).with_output_batch_size(YSB_BATCH)
           .with_retries(attempts=5, base_ms=1).with_name("kafka_src")
           .with_offsets({("ad_events", p): 0
                          for p in range(YSB_PARTITIONS)}))

    def ser(r):
        if not r["valid"]:
            return None
        return (out, None, (int(r["campaign"]), int(r["wid"]),
                            int(r["count"])))

    snk = kafka.Kafka_Sink_Builder(ser).with_brokers(KC_BROKERS) \
        .with_name("kc_out")
    if staging is not None:
        snk = snk.with_exactly_once(staging)
    ops = _ysb_device_ops(wt)
    mp = graph.add_source(src.build())
    for op in ops:
        mp = mp.add(op)
    mp.add_sink(snk.build())
    t0 = time.perf_counter()
    try:
        graph.run(restore_from)
    except (_InjectedCrash, wt.basic.WorkerFailuresError):
        if not crash:
            raise
    else:
        if crash:
            fail("exactly_once kafka_client: the injected crash did not "
                 "end the run")
    return KC_EVENTS / (time.perf_counter() - t0), ops[-1], graph


def _kc_check(name, cluster, out, model, whole=True):
    """The output topic as a read_committed consumer sees it: each
    (campaign, window) once, with the model's count (all of them when
    ``whole``). Returns the number of rows."""
    rows = cluster.read_committed(out)
    counts = {(c, w): n for c, w, n in rows}
    if len(counts) != len(rows):
        fail(f"exactly_once kafka_client {name}: a window is visible twice")
    if whole:
        _ysb_check(f"exactly_once kafka_client {name}", counts, len(rows),
                   model)
    elif any(model.get(k) != v for k, v in counts.items()):
        fail(f"exactly_once kafka_client {name}: a visible count differs "
             "from the model")
    return len(rows)


def _kc_reconnects(graph):
    return sum(r["Kafka_reconnects"] for o in graph.get_stats()["Operators"]
               for r in o["replicas"] if "Kafka_reconnects" in r)


def eo_kafka_client_part(torch, wt, card):
    """Part ``kafka_client``: YSB rows through the confluent_kafka adapter
    (``KC_FAULTS`` transient poll errors injected, healed by retries) into
    a plain Kafka sink, then into the staged exactly-once sink, then an
    exactly-once run killed after its first Kafka transaction and
    restored (the crashed run's producer fenced), then a plain run
    through the kafka-python adapter; the clients are in-process fakes.
    Returns K1's launches."""
    from windflow_tpu_torch import kafka
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.sinks.transactional import EpochSegmentStore
    fakes = _fake_kafka_clients()
    cluster = fakes.Cluster(YSB_PARTITIONS)
    _kc_fill(cluster)
    model = _ysb_model(KC_EVENTS)
    launches = Counter()
    rates, recon = {}, {}
    with fakes.installed(cluster, "confluent"):
        runs = [("plain", {}), ("exactly_once", {
            "store": _build_dir("ckpt", "kc_eo"),
            "staging": _build_dir("txn", "kc_eo")})]
        for mode, kw in runs:
            if mode == "plain":
                cluster.fail_next("poll", KC_FAULTS)
            _reset_launches(fr)
            rates[mode], win, g = _kc_run(wt, kafka, cluster, f"out_{mode}",
                                          f"kc_{mode}", **kw)
            launches += _launched(f"exactly_once kafka_client {mode}", fr,
                                  win.replicas[0])
            _kc_check(mode, cluster, f"out_{mode}", model)
            recon[mode] = _kc_reconnects(g)
        if recon["plain"] != KC_FAULTS or cluster.pending_faults("poll"):
            fail(f"exactly_once kafka_client: {KC_FAULTS} injected poll "
                 f"errors gave {recon['plain']} Kafka_reconnects")
        txn_eo = dict(cluster.txn_counts)
        if not txn_eo.get("committed") or txn_eo.get("aborted"):
            fail(f"exactly_once kafka_client: transactions {txn_eo}")
        store = _build_dir("ckpt", "kc_crash")
        staging = _build_dir("txn", "kc_crash")
        _reset_launches(fr)
        _, _, crashed = _kc_run(wt, kafka, cluster, "out_crash", "kc_crash",
                                store, staging,
                                crash_after=cluster.txn_counts["committed"])
        k1_c = _launch_counts(fr)
        visible = _kc_check("at the crash", cluster, "out_crash", model,
                            whole=False)
        seg = EpochSegmentStore(os.path.join(staging, "kc_out_r0"))
        pending_at_crash = seg.pending_epochs()
        if not 0 < visible < len(model):
            fail(f"exactly_once kafka_client: {visible} of {len(model)} "
                 "windows visible at the crash (want some, not all)")
        zombie = next(o for o in crashed._ops if o.name == "kc_out") \
            .replicas[0]._transport._txn_producer
        _reset_launches(fr)
        _, win_r, restored = _kc_run(wt, kafka, cluster, "out_crash",
                                     "kc_crash", store, staging,
                                     restore_from=store)
        k1_r = _launched("exactly_once kafka_client restored", fr,
                         win_r.replicas[0])
        _kc_check("restored", cluster, "out_crash", model)
        if seg.pending_epochs():
            fail("exactly_once kafka_client: staged epochs survive the "
                 "restore")
        try:
            zombie.begin_transaction()
        except sys.modules["confluent_kafka"].KafkaException as e:
            if "fenced" not in str(e):
                raise
        else:
            fail("exactly_once kafka_client: the crashed run's producer "
                 "is not fenced by the restored run")
        launches += k1_c + k1_r
    with fakes.installed(cluster, "kafka-python"):
        _reset_launches(fr)
        rates["kafka_python"], win, g = _kc_run(
            wt, kafka, cluster, "out_kp", "kc_kp")
        launches += _launched("exactly_once kafka_client kafka-python", fr,
                              win.replicas[0])
        _kc_check("kafka-python", cluster, "out_kp", model)
        recon["kafka_python"] = _kc_reconnects(g)
    phase("exactly_once", part="kafka_client", card=card,
          client="in-process fake", brokers=KC_BROKERS, events=KC_EVENTS,
          partitions=YSB_PARTITIONS, source_parallelism=YSB_SRC_PAR,
          campaign_windows=len(model), counts_equal_model=True,
          each_window_once=True,
          events_per_s_confluent_plain=rates["plain"],
          events_per_s_confluent_exactly_once=rates["exactly_once"],
          events_per_s_kafka_python_plain=rates["kafka_python"],
          injected_poll_errors=KC_FAULTS, kafka_reconnects=recon,
          transactions=dict(cluster.txn_counts),
          visible_at_crash=visible, staged_pending_at_crash=pending_at_crash,
          restored_txn=_txn_numbers(restored, "kc_out"),
          crashed_producer_fenced=True,
          rebuild_launches_crashed=k1_c.total(),
          rebuild_launches_restored=k1_r.total(),
          rebuild_launches=launches.total())
    return launches


class _ReplayTraffic:
    """bench.py's replay source (``_replay_mode.ReplaySource``): Zipf-1.1
    keys at a compressed diurnal rate, ragged bursts, 5% of the tuples
    late by up to 200 ms, shipped as 512-row column blocks with the
    watermark 200 ms behind the wall clock. Records every block it ships
    with its watermark."""

    def __init__(self):
        rng = np.random.default_rng(11)
        ranks = np.arange(1, REPLAY_KEYS + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        probs /= probs.sum()
        self.keys = rng.choice(REPLAY_KEYS, size=1 << 16, p=probs)
        self.jitter = rng.integers(0, REPLAY_LATENESS_US, size=1 << 16)
        self.late = rng.random(1 << 16) < REPLAY_LATE
        self.bursts = rng.integers(1, 32, size=4096)
        self.pos = 0
        self.record = []  # (cols, ts, wm) as shipped

    def __call__(self, shipper):
        t0 = time.monotonic()
        i, pend, pend_n = 0, [], 0
        total_s = len(REPLAY_CURVE) * REPLAY_PHASE_S

        def flush():
            nonlocal pend, pend_n
            if not pend:
                return
            cols = {"key": np.concatenate([c[0] for c in pend]),
                    "v": np.concatenate([c[1] for c in pend])}
            ts = np.concatenate([c[2] for c in pend])
            self.record.append((cols, ts, shipper.current_watermark))
            shipper.push_columns(cols, ts=ts)
            pend, pend_n = [], 0

        while True:
            t_rel = time.monotonic() - t0
            if t_rel >= total_s:
                flush()
                return
            rate = REPLAY_RATE * REPLAY_CURVE[
                min(int(t_rel / REPLAY_PHASE_S), len(REPLAY_CURVE) - 1)]
            burst = int(self.bursts[i & 0xFFF])
            now_us = int(time.time() * 1e6)
            idx = (i + np.arange(burst)) & 0xFFFF
            ts = now_us - np.where(self.late[idx], self.jitter[idx], 0)
            pend.append((self.keys[idx].astype(np.int64),
                         np.arange(i, i + burst, dtype=np.int64),
                         ts.astype(np.int64)))
            pend_n += burst
            i += burst
            if pend_n >= REPLAY_BLOCK:
                flush()
            shipper.set_next_watermark(
                max(shipper.current_watermark, now_us - REPLAY_LATENESS_US))
            self.pos = i
            time.sleep(max(0.0, burst / rate
                           - (time.monotonic() - t0 - t_rel)))

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _replay_run(wt, device, src, store, txn=None):
    """bench.py's replay graph: the source -> TB Keyed_Windows (500 ms,
    lateness 200 ms, parallelism 2) -> a sink, checkpointing every 2 s,
    at-least-once or (``txn``) exactly-once. Returns the window results,
    the wall time and the graph."""
    results = {}
    graph = wt.PipeGraph("replay_eo" if txn else "replay_alo",
                         wt.ExecutionMode.DEFAULT, wt.TimePolicy.EVENT_TIME,
                         channel_capacity=256, device=device)
    graph.with_checkpointing(interval=2.0, store_dir=store)
    win = wt.Keyed_Windows(lambda rows: sum(r["v"] for r in rows),
                           key_extractor=lambda t: t["key"],
                           win_len=REPLAY_WIN_US, slide_len=REPLAY_WIN_US,
                           win_type=wt.WinType.TB,
                           lateness=REPLAY_LATENESS_US, name="sessions",
                           parallelism=REPLAY_PAR)

    def sink(t):
        if t is not None:
            results[(t.key, t.wid)] = t.value

    snk = wt.Sink_Builder(sink).with_name("snk")
    if txn is not None:
        snk = snk.with_exactly_once(staging_dir=txn)
    graph.add_source(wt.Source_Builder(src).with_name("src").build()) \
        .add(win).add_sink(snk.build())
    t0 = time.perf_counter()
    graph.run()
    return results, time.perf_counter() - t0, graph


def eo_replay_part(wt, card):
    """Part ``replay``: bench.py's replay mode, at-least-once and
    exactly-once in turns; the exactly-once run's committed results
    equal the CPU run of the blocks its source recorded. Host operators
    only: no device work."""
    from windflow_tpu_torch.sinks.transactional import read_committed_records
    runs = {}
    for mode in ("at_least_once", "exactly_once"):
        src = _ReplayTraffic()
        txn = _build_dir("txn", "eo_replay") \
            if mode == "exactly_once" else None
        results, wall, graph = _replay_run(
            wt, "cuda", src, _build_dir("ckpt", f"eo_replay_{mode}"), txn)
        runs[mode] = (src, results, wall, graph, txn)
    src, results, wall, graph, txn = runs["exactly_once"]
    recorded = list(src.record)

    def replay(shipper):
        for cols, ts, wm in recorded:
            shipper.set_next_watermark(wm)
            shipper.push_columns(cols, ts=ts)

    ref, _, _ = _replay_run(wt, "cpu", replay,
                            _build_dir("ckpt", "eo_replay_cpu"))
    committed = [r for r, _ in read_committed_records(
        os.path.join(txn, "snk_r0"))]
    got = {(r.key, r.wid): r.value for r in committed}
    if len(got) != len(committed):
        fail("exactly_once replay: a (key, wid) window committed twice")
    if got != ref or results != ref:
        fail(f"exactly_once replay: {len(got)} committed windows differ "
             f"from the CPU run of the recorded blocks ({len(ref)})")
    alo = runs["at_least_once"]
    tx = _txn_numbers(graph, "snk")
    phase("exactly_once", part="replay", card=card, device_work=False,
          note="host operators only (TB Keyed_Windows): no device work",
          keys=REPLAY_KEYS, base_rate=REPLAY_RATE, block=REPLAY_BLOCK,
          curve=list(REPLAY_CURVE), phase_s=REPLAY_PHASE_S,
          late_frac=REPLAY_LATE, window_us=REPLAY_WIN_US,
          blocks_recorded=len(recorded),
          committed_equal_recorded_cpu_run=True, no_window_twice=True,
          tuples_at_least_once=alo[0].pos,
          tuples_per_s_at_least_once=alo[0].pos / alo[2],
          tuples_exactly_once=src.pos,
          tuples_per_s_exactly_once=src.pos / wall,
          window_results_at_least_once=len(alo[1]),
          window_results_exactly_once=len(got),
          checkpoints_at_least_once=alo[3]._coordinator.completed,
          checkpoints_exactly_once=graph._coordinator.completed,
          precommits=tx["precommits"], commits=tx["commits"],
          commit_latency_ms_mean=tx["commit_latency_ms_mean"])


class _PStream:
    """The persistent part's stream: P_TUPLES (key, value) int64 tuples
    over 10,240 keys (numpy, seeded; the first ``n`` of them) as a
    replayable columnar functor of 4,096-row blocks; it asks ``graph`` for
    a checkpoint every ``every`` blocks and raises before block
    ``crash_at`` once they committed."""

    def __init__(self, wt, every=0, crash_at=None, n=None):
        rng = np.random.default_rng(31)
        n = P_TUPLES if n is None else n
        self.keys = rng.integers(0, P_KEYS, P_TUPLES).astype(np.int64)[:n]
        self.vals = rng.integers(0, 1000, P_TUPLES).astype(np.int64)[:n]
        self.src = wt.ArrayBlockSource({"key": self.keys, "value": self.vals},
                                       block_size=P_BLOCK)
        self.every, self.crash_at = every, crash_at
        self.graph = None

    def __call__(self):
        for cols in self.src():
            i = self.src.snapshot_position() // P_BLOCK
            if i == self.crash_at:
                coord = self.graph._coordinator
                _wait_until("the persistent checkpoints",
                            lambda: coord.completed >= (i - 1) // self.every)
                raise _InjectedCrash(f"killed before block {i}")
            if self.every and i and i % self.every == 0:
                self.graph.trigger_checkpoint()
            yield cols

    def snapshot_position(self):
        return self.src.snapshot_position()

    def restore(self, pos):
        self.src.restore(pos)


def _p_run(wt, src, op, store=None, restore_from=None, crash=False,
           sink=True):
    """The stream -> ``op`` [-> a row sink]; returns the rows, the wall
    time and the graph."""
    rows, lock = [], threading.Lock()

    def collect(t):
        if t is not None:
            with lock:
                rows.append(t)

    graph = wt.PipeGraph("eo_persistent", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.INGRESS_TIME, device="cuda")
    if store is not None:
        graph.with_checkpointing(store_dir=store)
    src.graph = graph
    mp = graph.add_source(wt.Columnar_Source_Builder(src).with_name("src")
                          .build())
    if sink:
        mp.add(op).add_sink(wt.Sink_Builder(collect).with_name("rows")
                            .build())
    else:
        mp.add_sink(op)
    t0 = time.perf_counter()
    try:
        graph.run(restore_from)
    except _InjectedCrash:
        if not crash:
            raise
    else:
        if crash:
            fail("exactly_once persistent: the injected crash did not end "
                 "the run")
    return rows, time.perf_counter() - t0, graph


def _p_sum(t, state):
    state += t["value"]
    return {"key": t["key"], "sum": state}, state


def _p_sink_fold(t, state):
    return (state or 0) + (t["value"] if t is not None else 0)


def eo_persistent_part(wt, card):
    """Part ``persistent``: P_Map and P_Keyed_Windows against a numpy
    fold, then an exactly-once P_Sink killed and restored. (The in-memory
    Map / Keyed_Windows twins ran here until PR 11; PR 12 cut them to keep
    the script inside its time with the ``observe`` phase: their rows
    were held to the same fold, and their rates are in PERF.md.)"""
    from windflow_tpu_torch import persistent as P
    base = _PStream(wt)
    keys, vals = base.keys, base.vals
    # numpy fold: per key, the running sums and the CB 13/5 windows
    order = np.argsort(keys, kind="stable")
    ks, vs = keys[order], vals[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    ends = np.r_[starts[1:], len(ks)]
    run_model, win_model = {}, {}
    for a, e in zip(starts, ends):
        k, seq = int(ks[a]), vs[a:e]
        run_model[k] = np.cumsum(seq).tolist()
        win, slide = P_CB
        for w in range(-(-len(seq) // slide)):
            win_model[(k, w)] = int(seq[w * slide:w * slide + win].sum())
    rates = {}

    def running(rows):
        out = {}
        for r in rows:
            out.setdefault(r["key"], []).append(r["sum"])
        return out

    for name, make in (
            ("p_map", lambda: P.P_Map_Builder(_p_sum)
             .with_key_by(lambda t: t["key"]).with_initial_state(0)
             .with_db_path(_build_dir("p_db", "p_map"))
             .with_cache_capacity(P_CACHE).with_name("pmap").build()),):
        rows, wall, _ = _p_run(wt, _PStream(wt), make())
        rates[name] = P_TUPLES / wall
        if running(rows) != run_model:
            fail(f"exactly_once persistent: {name} rows differ from the "
                 "numpy fold")
    for name, make in (
            ("p_keyed_windows", lambda: P.P_Keyed_Windows_Builder(
                lambda ws: sum(w["value"] for w in ws))
             .with_key_by(lambda t: t["key"]).with_cb_windows(*P_CB)
             .with_db_path(_build_dir("p_db", "p_kw"))
             .with_cache_capacity(P_CACHE).with_name("pkw").build()),):
        rows, wall, _ = _p_run(wt, _PStream(wt), make())
        rates[name] = P_TUPLES / wall
        got = {(r.key, r.wid): r.value for r in rows}
        if len(got) != len(rows) or got != win_model:
            fail(f"exactly_once persistent: {name} windows differ from "
                 "the numpy fold")

    def p_sink(db):
        return (P.P_Sink_Builder(_p_sink_fold)
                .with_key_by(lambda t: t["key"]).with_db_path(db)
                .with_cache_capacity(P_CACHE).with_name("psink")
                .with_exactly_once().build())

    def db_state(db):
        h = P.DBHandle("psink_r0", db_dir=db)
        try:
            return dict(h.items()), {k: h.meta_get(k)
                                     for k in ("epoch", "finalized")}
        finally:
            h.close()

    # the P_Sink runs take the first quarter of the stream (three runs of
    # it; sqlite per tuple is the part's cost): a checkpoint every quarter
    # of that, killed at 5/8 of it
    n_sink = P_TUPLES // 4
    n_blocks = -(-n_sink // P_BLOCK)
    every = max(1, n_blocks // 4)
    crash_at = max(every + 1, n_blocks * 5 // 8)
    gold_db = _build_dir("p_db", "psink_gold")
    _, wall, _ = _p_run(wt, _PStream(wt, every=every, n=n_sink),
                        p_sink(gold_db),
                        store=_build_dir("ckpt", "eo_psink_gold"),
                        sink=False)
    rates["p_sink_exactly_once"] = n_sink / wall
    golden, gmeta = db_state(gold_db)
    ks, vs = keys[:n_sink], vals[:n_sink]
    fold = {int(k): int(vs[ks == k].sum()) for k in np.unique(ks)}
    if golden != fold or gmeta["finalized"] != gmeta["epoch"]:
        fail("exactly_once persistent: the P_Sink database differs from "
             "the numpy fold, or its last epoch is not finalized")
    db = _build_dir("p_db", "psink_crash")
    store = _build_dir("ckpt", "eo_psink_crash")
    _, _, crashed = _p_run(wt, _PStream(wt, every, crash_at, n_sink),
                           p_sink(db), store=store, crash=True, sink=False)
    _, mid = db_state(db)
    _, _, restored = _p_run(wt, _PStream(wt, every=every, n=n_sink),
                            p_sink(db),
                            store=store, restore_from=store, sink=False)
    final, fmeta = db_state(db)
    if final != golden or fmeta["finalized"] != fmeta["epoch"]:
        fail("exactly_once persistent: the restored P_Sink database "
             "differs from the uninterrupted run's")
    phase("exactly_once", part="persistent", card=card, device_work=False,
          keys=P_KEYS, tuples=P_TUPLES, cache=P_CACHE, cb_window=list(P_CB),
          rows_equal_fold=True,
          p_sink_db_equal_uninterrupted=True,
          p_sink_tuples=n_sink, checkpoint_every_blocks=every,
          crash_before_block=crash_at,
          tuples_per_s=rates, db_markers_at_crash=mid,
          checkpoints_crashed_run=crashed._coordinator.completed,
          restored_txn=_txn_numbers(restored, "psink"))


def exactly_once_phase(torch, wt, card):
    """Phase ``exactly_once``: parts ``columnar``, ``kafka``,
    ``kafka_client``, ``replay`` and ``persistent``. Returns K1's launches
    (columnar, kafka and kafka_client)."""
    launches = eo_columnar_part(torch, wt, card)
    launches += eo_kafka_part(torch, wt, card)
    launches += eo_kafka_client_part(torch, wt, card)
    eo_replay_part(wt, card)
    eo_persistent_part(wt, card)
    return launches


# ---------------------------------------------------------------------------
# phase observe: the native runtime, the monitoring plane, the overload
# governor and prewarm
# ---------------------------------------------------------------------------
OBS_TRACE_RATE = "1/64"
OBS_STALL_AT = 16          # the stall part's map blocks once, on batch 16
OBS_STALL_BLOCK_S = 3.0
OBS_STALL_SEC = 1.0        # the watchdog's threshold
OBS_PACE_S = 0.02          # the stall part's pause between blocks
OBS_SLO_MIN_MS = 1000.0
OBS_LAST_S = 5.0           # the overload part's tail window
OBS_SHED_EVENTS = 20_000   # the overload part's shedding run, paced at
OBS_SHED_RATE_DIV = 8      # 1/8 of the sustained rate: every shed row
                           # costs its source thread a shed-log append
OBS_SHED_SLO_MS = 0.0005   # below the queue-delay estimate's 1 us floor
OBS_SHED_TICK_S = 0.05     # its governor's tick (cooldown: two ticks;
                           # one breaching tick escalates)
OBS_RING = 16384           # flight-recorder ring per worker
OBS_NATIVE_TURNS = (True, False)  # YSB rows, encoders on / off (on, off,
                                  # off, on until the compile_cache part)
OBS_CC_BATCHES = 4         # compile_cache: HC batches per process
OBS_SCHEMA = {"key": np.int32, "value": np.int32}


def _op_reps(graph, name):
    """The replica stats dicts of the operator named ``name``."""
    return [r for o in graph.get_stats()["Operators"] if o["name"] == name
            for r in o["replicas"]]


def observe_native_part(torch, wt, kafka, card):
    """Part ``native``: YSB rows into the device chain with the staging
    encoders on and off (``OBS_NATIVE_TURNS``), counts equal to the
    model every run and the encoders' batch count equal to the staged
    batches (0 when off); then the HC main path on the C++ channel ring
    against the Python channels. Returns K1's launches and the mean
    events/s with the encoders on."""
    from windflow_tpu_torch import native
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    if not native.native_available():
        fail(f"observe native: the native runtime did not build: "
             f"{native.native_build_error()}")
    model = _ysb_model(YSB_EVENTS)
    eps = {True: [], False: []}
    launches = Counter()
    for i, on in enumerate(OBS_NATIVE_TURNS):
        e0 = native.ENCODE_BATCHES
        _reset_launches(fr)
        torch.cuda.synchronize()
        counts, n_rows, _, rate, win, g = _ysb_run(
            wt, kafka, "cuda", f"obs_native{i}", YSB_EVENTS,
            setup=lambda gr, on=on: setattr(gr, "_native_encoders", on))
        launches += _launched("observe native", fr, win.replicas[0])
        _ysb_check(f"observe native {'on' if on else 'off'}", counts,
                   n_rows, model)
        staged = sum(r["Device_batches_in"] for r in _op_reps(g, "views"))
        encoded = sum(r["Staging_native_batches"]
                      for r in _op_reps(g, "kafka_src"))
        want = staged if on else 0
        if staged == 0 or encoded != want \
                or native.ENCODE_BATCHES - e0 != want:
            fail(f"observe native: encoders {'on' if on else 'off'} filled "
                 f"{encoded} of {staged} staged batches")
        eps[on].append(rate)
    blocks = _blocks(HC_KEYS, seed=7)
    runs, tps = {}, {}
    for kind in ("python", "native", "native", "python"):
        _reset_launches(fr)
        torch.cuda.synchronize()
        run = _run_graph(wt, "cuda", blocks, HC_KEYS, None,
                         graph_kw={"native_channels": kind == "native"})
        launches += _launched(f"observe native channels {kind}", fr,
                              run[5])
        chans = [ch for s in run[6]._stages for ch in s.channels]
        if kind == "native" and not all(
                isinstance(ch, native.NativeChannel) for ch in chans):
            fail("observe native: a channel is not the native ring")
        if kind in runs:
            _check_windows("observe native channels", f"its {kind} twin",
                           run[0], runs[kind])
        runs[kind] = run[0]
        tps.setdefault(kind, []).append(
            _ffat_rates(blocks, run)["tuples_per_s"])
    _check_windows("observe native channels", "the Python channels",
                   runs["native"], runs["python"])
    phase("observe", part="native", card=card, events=YSB_EVENTS,
          counts_equal_model=True, encoder_ran=True,
          encoder_on_events_per_s=eps[True],
          encoder_off_events_per_s=eps[False],
          native_state=native.native_state(), hc_keys=HC_KEYS,
          hc_batches=N_BATCHES, rows_equal_python_channel=True,
          native_channel_tuples_per_s=tps["native"],
          python_channel_tuples_per_s=tps["python"])
    return launches, sum(eps[True]) / len(eps[True])


def _profile_all_threads(torch):
    """``torch.profiler`` arguments that record CPU ranges of every
    thread (the graph's workers run the spans), or None when this torch
    build cannot."""
    from torch.profiler import ProfilerActivity
    try:
        from torch._C._profiler import _ExperimentalConfig
        cfg = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None
    return dict(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                experimental_config=cfg)


def _k1_in_commit(torch, prof):
    """The ``wf:prep:`` / ``wf:commit:`` spans of a profiled run, K1's
    device launches, and how many of them a host thread launched inside a
    ``wf:commit:`` span (the launch's runtime call, matched to the kernel
    by its correlation id, lies in the span's time range on its
    thread)."""
    evs = list(prof.profiler.kineto_results.events())
    spans = {"prep": 0, "commit": 0}
    commits = []
    for e in evs:
        n = e.name()
        if n.startswith("wf:prep:"):
            spans["prep"] += 1
        elif n.startswith("wf:commit:"):
            spans["commit"] += 1
            commits.append((e.start_thread_id(), e.start_ns(),
                            e.start_ns() + e.duration_ns()))
    cuda = torch.autograd.DeviceType.CUDA
    k1 = {e.correlation_id() for e in evs
          if e.device_type() == cuda and KERNEL_MATCH in e.name()}
    inside = set()
    for e in evs:
        if e.device_type() == cuda or e.correlation_id() not in k1:
            continue
        tid, t = e.start_thread_id(), e.start_ns()
        if any(tid == ct and a <= t <= b for ct, a, b in commits):
            inside.add(e.correlation_id())
    return spans, len(k1), len(inside)


def _count_fire_only(wt):
    """Count the K1 launches of the FFAT replicas' fire-only steps
    (``FfatGPUReplica._fire_dataless``: a punctuation or the EOS firing
    windows after ingest-only batches settles the deferred rebuild on the
    worker thread, outside the dispatch queue and so outside any
    ``wf:commit:`` span). The commits still queued drain first, inside
    their spans, and are not counted. Returns ``(count, restore)``."""
    from windflow_tpu_torch.gpu.ffat_gpu import FfatGPUReplica
    orig = FfatGPUReplica._fire_dataless
    count, lock = [0], threading.Lock()

    def counted(self, frontier, partial):
        if self.trees is not None:
            self.dispatch.drain(forced=True)
        before = self.stats.rebuild_kernel_launches
        try:
            return orig(self, frontier, partial)
        finally:
            with lock:
                count[0] += self.stats.rebuild_kernel_launches - before

    FfatGPUReplica._fire_dataless = counted
    return count, lambda: setattr(FfatGPUReplica, "_fire_dataless", orig)


def _stateless_e2e(wt, blocks):
    """The HC stream through columnar source -> Map_GPU -> columnar sink,
    traced at OBS_TRACE_RATE on all three: the mapped values are the
    input's plus one, and the sink's e2e histogram (p50 / p99 / max) has
    samples."""
    got = [0, 0]

    def source():
        yield from blocks

    def sink(cols, ts):
        if cols is not None:
            got[0] += len(cols["value"])
            got[1] += int(cols["value"].astype(np.int64).sum())

    g = wt.PipeGraph("chip_smoke_traced_map", wt.ExecutionMode.DEFAULT,
                     wt.TimePolicy.EVENT_TIME, device="cuda")
    (g.add_source(wt.Columnar_Source_Builder(source)
                  .with_output_batch_size(BATCH)
                  .with_latency_tracing(OBS_TRACE_RATE).build())
     .add(wt.Map_GPU_Builder(lambda f: {**f, "value": f["value"] + 1})
          .with_latency_tracing(OBS_TRACE_RATE).build())
     .add_sink(wt.Sink_Builder(sink).with_columns()
               .with_latency_tracing(OBS_TRACE_RATE).build()))
    t0 = time.perf_counter()
    g.run()
    wall = time.perf_counter() - t0
    n = sum(len(c["value"]) for c, _, _ in blocks)
    want = sum(int(c["value"].astype(np.int64).sum()) for c, _, _ in blocks)
    if got != [n, want + n]:
        fail(f"observe tracing: the traced Map_GPU run gave {got}, "
             f"want {[n, want + n]}")
    (rep,) = _op_reps(g, "sink")
    if rep["Latency_e2e_samples"] == 0:
        fail("observe tracing: the sink behind Map_GPU recorded no e2e "
             "sample")
    return dict(tuples_per_s=n / wall,
                **{k: rep[f"Latency_e2e_{k}"] for k in (
                    "samples", "p50_usec", "p99_usec", "max_usec")})


def observe_tracing_part(torch, wt, card):
    """Part ``tracing``: the HC main path with ``with_latency_tracing(
    "1/64")`` on source, window and sink, against the untraced path in
    turns: equal rows and tuples/s (a device window's output carries no
    trace stamps, as in the JAX package, so its sink samples no e2e);
    the same stream through a traced stateless device op (Map_GPU), whose
    output batches carry their input's stamps: the sink's e2e histogram;
    then one traced run under ``torch.profiler``: the ``wf:prep:`` and
    ``wf:commit:`` spans are there and every K1 launch lies inside a
    commit span. Returns K1's launches."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    blocks = _blocks(HC_KEYS, seed=7)
    ref, tps, win_e2e = None, {"off": [], "on": []}, []
    launches = Counter()
    for traced in (False, True, False, True):
        _reset_launches(fr)
        torch.cuda.synchronize()
        run = _run_graph(wt, "cuda", blocks, HC_KEYS, None,
                         trace_rate=OBS_TRACE_RATE if traced else None)
        launches += _launched("observe tracing", fr, run[5])
        if ref is None:
            ref = run[0]
        else:
            _check_windows("observe tracing", "the untraced run", run[0],
                           ref)
        tps["on" if traced else "off"].append(
            _ffat_rates(blocks, run)["tuples_per_s"])
        (sink,) = _op_reps(run[6], "sink")
        if traced:
            win_e2e.append(sink["Latency_e2e_samples"])
        elif sink["Latency_e2e_samples"]:
            fail("observe tracing: the untraced sink recorded samples")
    e2e = _stateless_e2e(wt, blocks)
    kw = _profile_all_threads(torch)
    if kw is None:
        fail("observe tracing: this torch cannot profile worker threads "
             f"({torch.__version__})")
    from torch.profiler import profile
    _reset_launches(fr)
    torch.cuda.synchronize()
    fire_only, restore = _count_fire_only(wt)
    try:
        with profile(**kw) as prof:
            run = _run_graph(wt, "cuda", blocks, HC_KEYS, None,
                             trace_rate=OBS_TRACE_RATE)
            torch.cuda.synchronize()
    finally:
        restore()
    launches += _launched("observe tracing profiled", fr, run[5])
    _check_windows("observe tracing profiled", "the untraced run", run[0],
                   ref)
    spans, k1, inside = _k1_in_commit(torch, prof)
    if not spans["prep"] or not spans["commit"]:
        fail(f"observe tracing: profiler spans missing: {spans}")
    # every K1 launch lies in a commit span, but a fire-only step's,
    # which runs on the worker thread outside the dispatch queue
    if k1 == 0 or inside + fire_only[0] != k1:
        fail(f"observe tracing: {inside} of {k1} K1 launches lie inside "
             f"a wf:commit: span, {fire_only[0]} in fire-only steps")
    phase("observe", part="tracing", card=card, rate=OBS_TRACE_RATE,
          rows_equal_untraced=True, traced_tuples_per_s=tps["on"],
          untraced_tuples_per_s=tps["off"],
          window_sink_e2e_samples=win_e2e, stateless_sink_e2e=e2e,
          profiled_spans=spans, k1_launches_profiled=k1,
          k1_inside_commit_span=inside, k1_fire_only=fire_only[0],
          torch=torch.__version__)
    return launches


def _valid_chrome(doc):
    """The Chrome trace-event document shape the flight recorder
    promises: complete spans and metadata events, JSON all the way."""
    json.loads(json.dumps(doc))
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            if not (e["ts"] >= 0 and e["dur"] >= 0 and isinstance(
                    e["pid"], int) and isinstance(e["tid"], int)
                    and isinstance(e["name"], str)):
                return False
        elif e["ph"] != "M":
            return False
    return True


class _StallMap:
    """A Map_GPU function that blocks OBS_STALL_BLOCK_S on its
    OBS_STALL_AT-th batch, once per run object."""

    def __init__(self):
        self.calls = 0
        self.t_block = None

    def __call__(self, f):
        self.calls += 1
        if self.calls == OBS_STALL_AT and self.t_block is None:
            self.t_block = time.time()
            time.sleep(OBS_STALL_BLOCK_S)
        return {**f, "value": f["value"] + 0}


class _PacedBlocks:
    """Replayable block source (EVENT_TIME): one block per step, a
    checkpoint requested after every SUP_EVERY blocks without waiting for
    it (a source parked on a commit the stalled map holds back would be
    flagged too), OBS_PACE_S between blocks."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.pos = 0

    def __call__(self, shipper):
        while self.pos < len(self.blocks):
            cols, ts, wm = self.blocks[self.pos]
            shipper.set_next_watermark(wm)
            shipper.push_columns(cols, ts)
            self.pos += 1
            if self.pos % SUP_EVERY == 0:
                shipper.request_checkpoint()
            time.sleep(OBS_PACE_S)

    def snapshot_position(self):
        return self.pos

    def restore(self, pos):
        self.pos = pos


def _run_stall(wt, device, blocks, store, stall):
    parts, sink = _sink_parts()
    src = _PacedBlocks(blocks)
    graph = wt.PipeGraph("obs_stall", wt.ExecutionMode.DEFAULT,
                         wt.TimePolicy.EVENT_TIME, device=device,
                         stall_sec=OBS_STALL_SEC if stall else 0.0,
                         log_dir=_build_dir("observe_log"))
    graph.with_checkpointing(store_dir=store)
    graph.with_supervision(wt.RestartPolicy(max_restarts=2, backoff_s=0.05,
                                            backoff_max_s=0.1, seed=0))
    fn = _StallMap() if stall else (lambda f: {**f, "value": f["value"]})
    (win,) = _rs_ops(wt, "ffat", 1)
    graph.add_source(wt.Source_Builder(src).with_name("src")
                     .with_output_batch_size(BATCH).build()) \
        .add(wt.Map_GPU_Builder(fn).with_name("stallmap").build()) \
        .add(win).add_sink(wt.Sink_Builder(sink).with_columns().build())
    graph.run()
    return parts, graph, win, fn


def observe_flightrec_part(torch, wt, card):
    """Part ``flightrec``: ``dump_trace`` of the HC run is valid Chrome
    JSON (span counts per kind, dropped events); then a supervised FFAT
    graph whose map blocks OBS_STALL_BLOCK_S once, with the watchdog at
    OBS_STALL_SEC: the stall is detected and the graph restarted, and its
    distinct window rows equal the uninterrupted run's. Returns K1's
    launches."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    blocks = _blocks(HC_KEYS, seed=7)
    _reset_launches(fr)
    torch.cuda.synchronize()
    run = _run_graph(wt, "cuda", blocks, HC_KEYS, None,
                     setup=lambda g: g.with_flight_recorder(OBS_RING))
    launches = _launched("observe flightrec", fr, run[5])
    path = run[6].dump_trace(os.path.join(_build_dir("observe_log"),
                                          "hc_trace.json"))
    with open(path) as f:
        doc = json.load(f)
    if not doc["traceEvents"] or not _valid_chrome(doc):
        fail("observe flightrec: dump_trace is no valid Chrome trace")
    kinds = {}
    for e in doc["traceEvents"]:
        if e["ph"] == "X":
            kinds[e["name"]] = kinds.get(e["name"], 0) + 1
    if not {"host_prep", "commit", "emit"} <= set(kinds):
        fail(f"observe flightrec: device spans missing: {sorted(kinds)}")
    sblocks = _blocks(HC_KEYS, seed=61)
    gold = _rec_results("ffat", _run_stall(
        wt, "cuda", sblocks, _ckpt_dir("obs_stall_g"), False)[0])
    _reset_launches(fr)
    torch.cuda.synchronize()
    parts, g, win, fn = _run_stall(wt, "cuda", sblocks,
                                   _ckpt_dir("obs_stall"), True)
    launches += _launch_counts(fr)
    sup = g.get_stats()["Supervision"]
    fired = list(g._watchdog.fired) if g._watchdog is not None else []
    if sup["Supervision_restarts"] < 1 or not any(
            "stallmap" in w for w in fired):
        fail(f"observe flightrec: the stall was not restarted (restarts "
             f"{sup['Supervision_restarts']}, watchdog {fired})")
    if _rec_results("ffat", parts) != gold:
        fail("observe flightrec: the restarted run's distinct rows differ "
             "from the uninterrupted run")
    h = sup["Supervision_history"][0]
    phase("observe", part="flightrec", card=card, trace_events=len(
        doc["traceEvents"]), span_counts=kinds,
          dropped_events=doc.get("droppedEvents", 0), ring=OBS_RING,
          stall_block_s=OBS_STALL_BLOCK_S, stall_sec=OBS_STALL_SEC,
          watchdog_fired=fired, restarts=sup["Supervision_restarts"],
          restored_checkpoint=h["ckpt_id"],
          block_to_resume_s=h["t_unix"] - fn.t_block,
          detect_to_resume_s=h["mttr_s"], distinct_equal_card=True,
          postmortem=g.last_postmortem is not None)
    return launches


def observe_monitor_part(torch, wt, card):
    """Part ``monitor``: a MonitoringServer on 127.0.0.1 (port 0, with its
    HTTP view) receives the HC run's MonitoringThread; ``/json`` names the
    graph, ``/metrics`` parses as Prometheus text and ``/doctor`` gives a
    verdict. Returns K1's launches."""
    import re
    import urllib.request
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    from windflow_tpu_torch.monitoring.monitor import MonitoringServer
    srv = MonitoringServer("127.0.0.1", 0)
    try:
        http_port = srv.serve_http(0)
        blocks = _blocks(HC_KEYS, seed=7)
        _reset_launches(fr)
        torch.cuda.synchronize()
        run = _run_graph(wt, "cuda", blocks, HC_KEYS, None, pace_s=0.1,
                         graph_kw={"dashboard": (srv.host, srv.port),
                                   "log_dir": _build_dir("observe_log")})
        launches = _launched("observe monitor", fr, run[5])
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline \
                and "chip_smoke" not in srv.snapshot()["doctor"]:
            time.sleep(0.05)

        def get(path):
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{http_port}{path}", timeout=10) as r:
                return r.status, r.read().decode()

        code, body = get("/json")
        snap = json.loads(body)
        if code != 200 or "chip_smoke" not in snap["reports"]:
            fail("observe monitor: /json does not name the graph")
        code, metrics = get("/metrics")
        pat = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})?\s+\S+$')
        samples = [ln for ln in metrics.splitlines()
                   if ln and not ln.startswith("#")]
        if code != 200 or not samples or not all(pat.match(ln)
                                                 for ln in samples):
            fail("observe monitor: /metrics is no Prometheus text")
        code, body = get("/doctor")
        doctor = json.loads(body).get("chip_smoke") or {}
        if code != 200 or not doctor.get("summary"):
            fail("observe monitor: /doctor gave no verdict")
    finally:
        srv.close()
    phase("observe", part="monitor", card=card,
          reports=snap["n_reports"], metric_samples=len(samples),
          doctor_summary=doctor["summary"],
          doctor_healthy=doctor["healthy"])
    return launches


def _overload_run(torch, wt, kafka, name, n_events, rate, slo_ms,
                  interval_s, breach_hysteresis=2):
    """One paced YSB device-chain run under ``with_slo(slo_ms)``: offered
    == admitted + shed exactly, one ShedLog line per shed record, and the
    sink's campaign-window counts equal the model over the events the
    shed log does not name. Returns the run's numbers and K1's launches."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    shed_dir = _build_dir(f"observe_{name}")
    policy = wt.GovernorPolicy(slo_p99_ms=slo_ms, interval_s=interval_s,
                               cooldown_s=2 * interval_s,
                               breach_hysteresis=breach_hysteresis,
                               shed_dir=shed_dir)
    lat_at = []
    _reset_launches(fr)
    torch.cuda.synchronize()
    counts, n_rows, _, eps, win, g = _ysb_run(
        wt, kafka, "cuda", f"obs_{name}", n_events, rate=rate,
        setup=lambda gr: gr.with_slo(slo_ms, policy), lat_at=lat_at)
    launches = _launched(f"observe {name}", fr, win.replicas[0])
    reps = _op_reps(g, "kafka_src")
    admitted = sum(r["Inputs_received"] for r in reps)
    shed = sum(r["Shed_records"] for r in reps)
    if admitted + shed != n_events:
        fail(f"observe {name}: offered {n_events} != admitted "
             f"{admitted} + shed {shed}")
    shed_ts = set()
    log = os.path.join(shed_dir, "ysb.shed.jsonl")
    if shed:
        with open(log) as f:
            shed_ts = {json.loads(ln)["ts"] for ln in f}
    if len(shed_ts) != shed:
        fail(f"observe {name}: the shed log names {len(shed_ts)} "
             f"records, Shed_records {shed}")
    i = np.arange(0, n_events, 3, dtype=np.int64)
    i = i[~np.isin(i * YSB_TS_STEP_US,
                   np.fromiter(shed_ts, np.int64, len(shed_ts)))]
    camp = (i % (YSB_CAMPAIGNS * YSB_ADS)) // YSB_ADS
    wid = i * YSB_TS_STEP_US // YSB_WIN_US
    keys, cnt = np.unique(camp * 1_000_000 + wid, return_counts=True)
    model = {(int(k // 1_000_000), int(k % 1_000_000)): int(c)
             for k, c in zip(keys, cnt)}
    _ysb_check(f"observe {name}", counts, n_rows, model)
    ov = g.get_stats()["Overload"]
    hist = ov["Overload_history"]
    (sink,) = _op_reps(g, "sink")
    t_end = max(t for t, _ in lat_at)
    _, tail_p99 = _pcts([x for t, x in lat_at if t >= t_end - OBS_LAST_S])
    return dict(
        events=n_events, offered_events_per_s=rate, events_per_s=eps,
        slo_ms=slo_ms,
        rungs=[h["detail"] for h in hist if h["event"] == "escalate"],
        state=ov["Overload_state_name"], offered=n_events,
        admitted=admitted, shed_records=shed,
        offered_equals_admitted_plus_shed=True,
        counts_equal_model_over_admitted=True,
        last_5s_p99_ms=tail_p99,
        sink_e2e_samples=sink["Latency_e2e_samples"],
        governor_window_p99_ms=ov["Overload_window_p99_usec"] / 1e3,
        governor_readings_ms=[h["window_p99_us"] / 1e3 for h in hist],
        admit_rate_tps=ov["Overload_admit_rate_tps"]), launches


def observe_overload_part(torch, wt, kafka, card, sustained_eps):
    """Part ``overload``: YSB's device chain under an SLO, twice. First
    paced at twice the events/s the native part's row runs sustained,
    under ``with_slo(p99_ms=S)`` (S = twice the ysb paced part's p99, at
    least OBS_SLO_MIN_MS). Then OBS_SHED_EVENTS paced at
    1/OBS_SHED_RATE_DIV of the sustained rate under OBS_SHED_SLO_MS,
    which the governor's reading behind the device window exceeds: it
    samples no end-to-end latency there, as in the JAX package, and
    reads the queue-delay estimate, at least 1 us a queued message. So
    the SHED rung, the gate and the shed log run, and that run must shed.
    Each run holds offered == admitted + shed and the model over the
    admitted events. Returns K1's launches."""
    slo_ms = max(OBS_SLO_MIN_MS,
                 2.0 * float(YSB_MEASURED.get("paced_p99_ms") or 0.0))
    rate = 2.0 * sustained_eps
    out, launches = _overload_run(torch, wt, kafka, "overload", YSB_EVENTS,
                                  rate, slo_ms, 0.25)
    shed, k1 = _overload_run(torch, wt, kafka, "overload_shed",
                             OBS_SHED_EVENTS,
                             sustained_eps / OBS_SHED_RATE_DIV,
                             OBS_SHED_SLO_MS, OBS_SHED_TICK_S,
                             breach_hysteresis=1)
    launches += k1
    if shed["shed_records"] == 0 or "shed" not in shed["rungs"]:
        fail(f"observe overload_shed: the governor shed nothing under a "
             f"{OBS_SHED_SLO_MS} ms SLO (rungs {shed['rungs']})")
    phase("observe", part="overload", card=card,
          sustained_events_per_s=sustained_eps, slo_run=out, shed_run=shed)
    return launches


def observe_prewarm_part(torch, wt, card):
    """Part ``prewarm``: the HC main path (window schema declared) with
    and without ``with_prewarm()``: equal rows, the report, whether the
    window replica had loaded K1 before batch 0, and the first batch's
    latency (yield -> its first window row at the sink). Returns K1's
    launches."""
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    blocks = _blocks(HC_KEYS, seed=7)
    out, ref = {}, None
    launches = Counter()
    for warm in (False, True):
        seen = {}

        def hook(graph):
            (op,) = [o for o in graph._ops if o.name == "ffat_windows_gpu"]
            seen["k1"] = bool(getattr(op.replicas[0], "_k1_loaded", False))

        _reset_launches(fr)
        torch.cuda.synchronize()
        run = _run_graph(wt, "cuda", blocks, HC_KEYS, None,
                         schema=OBS_SCHEMA, first_hook=hook,
                         setup=(lambda g: g.with_prewarm()) if warm
                         else None)
        launches += _launched("observe prewarm", fr, run[5])
        if ref is None:
            ref = run[0]
        else:
            _check_windows("observe prewarm", "the run without prewarm",
                           run[0], ref)
        t_yield, t_recv = run[1], run[3]
        first = min(t_recv.values()) - min(t_yield.values())
        if seen.get("k1") != warm:
            fail(f"observe prewarm: K1 loaded before batch 0 = "
                 f"{seen.get('k1')} with prewarm {warm}")
        out[warm] = dict(first_batch_latency_ms=first * 1e3,
                         k1_loaded_before_batch0=seen["k1"],
                         report=run[6].prewarm_report)
    phase("observe", part="prewarm", card=card, rows_equal=True,
          with_prewarm=out[True], without_prewarm=out[False])
    return launches


_CC_CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
import chip_smoke as c
import windflow_tpu_torch as wt
from windflow_tpu_torch.kernels import build, forest_rebuild as fr
cache, rows_out = sys.argv[2], sys.argv[3]
dtypes, comb = c.traced_specs(torch)["mean_last"]
lift = c._combine_lifts(torch)["mean_last"]
blocks = c._blocks(c.HC_KEYS, seed=11, n_batches=c.OBS_CC_BATCHES)
torch.cuda.init()
c._reset_launches(fr)
run = c._run_graph(wt, "cuda", blocks, c.HC_KEYS, None, lift=lift,
                   combine=comb, setup=lambda g: g.with_compile_cache(cache))
launches = c._launched("observe compile_cache", fr, run[5])
v = fr.variant(comb, dtypes)
np.savez(rows_out, **run[0])
st = run[5].stats
print(json.dumps({
    "library": v.library, "build_dir": str(build.build_dir()),
    "nvcc_s": build.BUILD_INFO[v.library]["seconds"],
    "signature": st.compile_last_signature,
    "compile_usec_total": st.compile_usec_total,
    "first_batch_latency_ms": 1e3 * (min(run[3].values())
                                     - min(run[1].values())),
    "rebuild_launches": launches.total(), "wall_s": run[4]}))
"""


def observe_compile_cache_part(torch, wt, card):
    """Part ``compile_cache``: two fresh Python processes, one after the
    other, each run the HC stream (``OBS_CC_BATCHES`` batches) into
    ``Ffat_Windows_GPU`` with the traced ``mean_last`` combine under
    ``with_compile_cache`` of one directory, empty before the first. The
    first must build K1's variant there (``nvcc`` ran), the second load it
    without a build (``:cached``, build seconds 0); both processes' rows
    equal each other and the port's CPU run. The children's K1 launches
    are their own processes' and stay out of the kernels line."""
    import shutil
    from windflow_tpu_torch.kernels import forest_rebuild as fr
    root = _build_dir("compile_cache_part")
    cache = os.path.join(root, "cache")
    os.makedirs(root)
    dtypes, comb = traced_specs(torch)["mean_last"]
    lift = _combine_lifts(torch)["mean_last"]
    blocks = _blocks(HC_KEYS, seed=11, n_batches=OBS_CC_BATCHES)
    ref = _run_graph(wt, "cpu", blocks, HC_KEYS, None, lift=lift,
                     combine=comb)[0]
    procs = []
    for i in range(2):
        rows_out = os.path.join(root, f"rows{i}.npz")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", _CC_CHILD, HERE, cache,
                              rows_out], capture_output=True, text=True,
                             timeout=300)
        if res.returncode != 0:
            fail(f"observe compile_cache: process {i} failed "
                 f"(rc {res.returncode}):\n{res.stderr[-4000:]}")
        info = json.loads(res.stdout.strip().splitlines()[-1])
        info["process_s"] = time.perf_counter() - t0
        with np.load(rows_out) as z:
            got = {k: z[k] for k in z.files}
        _check_combine_rows(f"compile_cache process {i}", got, ref,
                            COMBINE_RTOL["mean_last"])
        procs.append((info, got))
    (first, rows0), (second, rows1) = procs
    for k in rows0:
        if not np.array_equal(rows0[k], rows1[k]):
            fail(f"observe compile_cache: column {k!r} differs between the "
                 "two processes")
    lib = fr.variant(comb, dtypes).library
    if first["build_dir"] != cache or second["build_dir"] != cache:
        fail(f"observe compile_cache: built in {first['build_dir']} / "
             f"{second['build_dir']}, not {cache}")
    if not (first["nvcc_s"] > 0 and first["signature"] == f"{lib}:nvcc"):
        fail(f"observe compile_cache: the first process did not build "
             f"K1's variant: {first}")
    if not (second["nvcc_s"] == 0.0
            and second["signature"] == f"{lib}:cached"):
        fail(f"observe compile_cache: the second process did not load the "
             f"cached build: {second}")
    cached = sorted(f for f in os.listdir(cache) if f.endswith(".so"))
    phase("observe", part="compile_cache", card=card, keys=HC_KEYS,
          batches=OBS_CC_BATCHES, combine="mean_last", library=lib,
          cache_files=cached, rows_equal_cpu=True,
          rows_equal_across_processes=True,
          first_process={k: first[k] for k in (
              "signature", "nvcc_s", "compile_usec_total",
              "first_batch_latency_ms", "rebuild_launches", "process_s")},
          second_process={k: second[k] for k in (
              "signature", "nvcc_s", "compile_usec_total",
              "first_batch_latency_ms", "rebuild_launches", "process_s")})
    shutil.rmtree(root, ignore_errors=True)


def observe_phase(torch, wt, card):
    """Phase ``observe``: parts ``native``, ``tracing``, ``flightrec``,
    ``monitor``, ``overload``, ``prewarm`` and ``compile_cache``. Returns
    K1's launches (the compile_cache part's child processes' are their
    own)."""
    from windflow_tpu_torch import kafka
    t0 = time.perf_counter()
    kafka.MemoryBroker.reset()
    _ysb_fill(kafka, YSB_EVENTS)
    launches, sustained = observe_native_part(torch, wt, kafka, card)
    launches += observe_tracing_part(torch, wt, card)
    launches += observe_flightrec_part(torch, wt, card)
    launches += observe_monitor_part(torch, wt, card)
    launches += observe_overload_part(torch, wt, kafka, card, sustained)
    launches += observe_prewarm_part(torch, wt, card)
    observe_compile_cache_part(torch, wt, card)
    kafka.MemoryBroker.reset()
    phase("observe", part="total", card=card,
          wall_s=time.perf_counter() - t0,
          rebuild_launches=launches.total())
    return launches


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

    from windflow_tpu_torch.kernels import forest_rebuild as fr

    card, name = device_phase(torch)
    build_phase(torch)
    _, err_checks = kernel_phase(torch, False)
    # K1's launches by variant, each phase's counted from the runs of its
    # main path, the counts set to 0 just before each run
    on_path = Counter()
    hc, n = main_path_phase(torch, wt, "high_cardinality", HC_KEYS, None)
    on_path += n
    phase("main_path", **hc)
    base, n = main_path_phase(torch, wt, "64_keys", 64, 128)
    on_path += n
    phase("main_path", **base)
    on_path += combine_phase(torch, wt, card)
    # before any torch.profiler use: its tracing slows later FFAT runs
    on_path += fusion_ffat_phase(torch, wt, card)
    _, graph_blocks = graph_gpu_phase(torch, wt, card)
    fusion_ops_phase(torch, wt, card)
    _, (fold_rows, fold_errs) = programs_phase(torch, wt, graph_blocks,
                                               card)
    timing, err_timed = kernel_phase(torch, True)
    # after K1's timing: the plain versions' traces (hundreds of launches
    # a call) made torch.profiler lose K1's records when they ran first
    step_rows, step_errs = ffat_step_phase(torch, wt, card)
    main_path_profiled_part(torch, wt, card)
    # last: its profiled runs trace hundreds of thousands of launches,
    # after which torch.profiler has been seen to lose K1's records
    smap_blocks = state_phase(torch, wt, card)
    k8_rows = state_programs_phase(torch, wt, smap_blocks, card)
    for run_phase in (dag_phase, recovery_phase, delta_phase, rescale_phase,
                      supervise_phase, mesh_phase, ysb_phase,
                      exactly_once_phase, observe_phase):
        on_path += run_phase(torch, wt, card)
    variants = {"fieldwise": (fr.Variant(fr.FIELDWISE), tuple(SPECS)),
                **{n: (v, (n,)) for n, v in _variants(torch).items()
                   if n in PATH_SHAPE}}
    kernels = []
    for vname, (v, specs) in variants.items():
        launches = on_path[v.tag]
        if launches <= 0:
            fail(f"K1's {vname} variant never launched on a main path")
        K, F, sname = PATH_SHAPE[vname]
        t = timing[K, F, sname]
        kernels.append({
            "name": "forest_rebuild" if vname == "fieldwise"
            else f"forest_rebuild[{vname}]",
            "route": "cuda",
            "source": "windflow_tpu_torch/kernels/forest_rebuild.cu"
            if vname == "fieldwise"
            else "windflow_tpu_torch/kernels/forest_rebuild.cuh",
            "replaces": "windflow_tpu/tpu/pallas_kernels.py:29",
            "launches": launches,
            "max_abs_err": max(max(err_checks.get(n, 0.0),
                                   err_timed.get(n, 0.0)) for n in specs),
            "ms": t["wrapper_ms"],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "bound_share": t["bound_share"],
            "library_ms": None,
            "shape": [K, F],
        })
    unknown = set(on_path) - {v.tag for v, _ in variants.values()}
    if unknown:
        fail(f"K1 variants {sorted(unknown)} launched on a main path but "
             "are not in the kernels line")
    # K2+K3 and K4: launches summed over the main-path runs, by variant;
    # times and bounds at each variant's path layout (K4: the fire step at
    # the layout's first width)
    step_path = sum(STEP_RUNS.values(), Counter())
    tags = {}
    for vname in STEP_VARIANTS:
        lay = STEP_PATH[vname]
        W = STEP_QUERY_W[lay][0]
        tags[vname] = step_rows["ingest", vname, lay]["tag"]
        for kind, label, key in (("ingest", "ffat_ingest", (lay,)),
                                 ("query", "ffat_query", (lay, W))):
            launches = step_path[kind, tags[vname]]
            if launches <= 0:
                fail(f"{label}'s {vname} variant never launched on a main "
                     "path")
            t = step_rows[(kind, vname) + key]
            kernels.append({
                "name": label if vname == "fieldwise"
                else f"{label}[{vname}]",
                "route": "cuda",
                "source": "windflow_tpu_torch/kernels/ffat_step.cuh",
                "replaces": t["replaces"],
                "launches": launches,
                "max_abs_err": step_errs[kind, vname],
                "ms": t["ms"],
                "device_ms": t["device_ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": "bytes",
                "bound_share": t["bound_share"],
                "library_ms": t["library_ms"],
                "shape": ([STEP_LAYOUTS[lay][1]] if kind == "ingest"
                          else [W]) + [STEP_LAYOUTS[lay][0], STEP_F],
            })
    unknown = {t for _, t in step_path} - set(tags.values())
    if unknown:
        fail(f"K2+K3 / K4 variants {sorted(unknown)} launched on a main "
             "path but are not in the kernels line")
    # K8: launches by traced step over the state and mesh phases' runs on
    # the card; times and bound at each step's own path layout
    from windflow_tpu_torch.kernels import build
    k8_tags = {n: v.tag for n, v in _k8_variants(torch).items()}
    for vname, tag in k8_tags.items():
        if K8_PATH[tag] <= 0:
            fail(f"K8's {vname} step never launched on a main path")
        t = k8_rows[K8_PATH_LAYOUT[vname]]
        if t["tag"] != tag:
            fail(f"K8's {vname} layout ran step {t['tag']}, not {tag}")
        kernels.append({
            "name": f"grid_scan[{vname}]", "route": "cuda",
            "source": "windflow_tpu_torch/kernels/grid_scan.cuh",
            "replaces": "windflow_tpu/tpu/ops_tpu.py:212",
            "launches": K8_PATH[tag],
            "max_abs_err": max(r["max_abs_err"] for r in k8_rows.values()
                               if r["tag"] == tag),
            "ms": t["wrapper_ms"], "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "bound_share": t["bound_share"],
            # a floor of the design (one thread walks a key), not a bound
            "chain_bound_ms": t["chain_bound_ms"], "library_ms": None,
            "shape": [t["rows"], t["keys"], t["M"]],
        })
    unknown = set(K8_PATH) - set(k8_tags.values())
    if unknown:
        fail(f"K8 steps {sorted(unknown)} launched on a main path but are "
             "not in the kernels line")
    spilled = _spills(build, "grid_scan-")
    if spilled:
        fail(f"K8 kernels with a stack frame or spills: {spilled}")
    # K7 and K6: launches by (kernel, variant) over the reduce paths' runs
    # on the card; times and bound at the graph_gpu batch
    names = {}
    for n, fv in _reduce_variants(torch).items():
        names.setdefault(fv.tag, n)
    for kernel in ("keyed_fold", "tree_reduce"):
        tags = {t for k, t in REDUCE_PATH if k == kernel}
        if not tags:
            fail(f"{kernel} never launched on a reduce path")
        for tag in sorted(tags):
            t = fold_rows[kernel, FOLD_PATH[kernel]]
            if tag != t["tag"]:
                fail(f"{kernel}: variant {tag} ({names.get(tag)}) launched "
                     "on a reduce path but is not in the kernels line")
            kernels.append({
                "name": f"{kernel}[{names[tag]}]", "route": "cuda",
                "source": "windflow_tpu_torch/kernels/reduce_fold.cuh",
                "replaces": t["replaces"],
                "launches": REDUCE_PATH[kernel, tag],
                "max_abs_err": fold_errs[kernel],
                "ms": t["ms"], "device_ms": t["device_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": "bytes", "bound_share": t["bound_share"],
                "library_ms": t["library_ms"],
                "shape": [t["rows"], t["slots"], t["out_rows"]],
                # K7: slots by regime at the path layout; K6: its stages
                "regimes": t.get("regimes", t.get("stages")),
            })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
