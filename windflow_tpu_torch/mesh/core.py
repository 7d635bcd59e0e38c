"""Mesh execution plane, collective core: key-sharded streaming state over
a ``('key', 'data')`` mesh of shards, every shard on one card.

The port of ``windflow_tpu/mesh/core.py``. The JAX package runs one
``shard_map`` program per step over a ``jax.sharding.Mesh``, one device
per shard, and moves tuples between devices with XLA collectives. The
port keeps the single-controller model (ONE host replica drives every
shard) and the same block ownership (shard ``s`` owns keys ``[s*k_local,
(s+1)*k_local)``), but holds all the shards of a mesh on ONE card,
STACKED along a leading shard axis, so a collective among them is one
tensor op instead of a copy per pair of shards:

- ``all_to_all`` of a ``(ns, ns, C)`` bucket tensor is the transpose of
  its first two axes (``_all_to_all``; over the ``'key'`` axis alone the
  buckets are ``(ka, da, ka, C)`` and the key axes swap);
- ``psum`` / ``pmax`` over an axis are a reduction over that shard axis
  (or one scatter-add / scatter-max into the global key space);
- ``ppermute`` is an index permutation along the shard axis (the ring
  halo of ``ring_pane_window_query`` is a roll, the butterfly of the
  FFAT delta merge a pairing of even and odd data replicas).

The key-sharded FFAT forest is replicated along ``'data'`` in the JAX
package, and the butterfly merge makes the replicas equal; the port holds
ONE copy per key shard, ``(ka * k_local, 2F)`` rows, which is what the
data replicas would all hold. The flat-owner tables of the sharded
Map/Filter (``sharded_grid_scan``) hold ``ns * k_local`` rows and the
grid scan runs over all of them at once: each key's state only ever sees
its own rows, so scanning the stacked row blocks together is scanning
each block.

There is no ``mode="drop"`` in torch: every masked scatter aims its
dropped lanes at one trailing scratch element, and a negative index
(key -1 marks a padding lane) is clipped before it can wrap.

Devices: ``ensure_virtual_devices(n)`` makes ``n`` virtual devices
visible on the graph's device (a module-level registry, read by
``make_key_mesh``; no environment variable). Without it the visible
devices are the physical ones: the CPU, or each CUDA card. A mesh whose
shards would span more than one physical device raises: peer copies
between cards are not yet ported. The device-health exclusion registry
names virtual ids (physical card indices without virtual devices).
"""

from __future__ import annotations

import math
import threading
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..basic import WindFlowError
from ..gpu.ffat_gpu import comb_valid, window_query
from ..gpu.scan import segmented_scan
from ..gpu.schema import broadcast_scalar_fields, canonical
from ..kernels.forest_rebuild import forest_rebuild
from ..pytree import tree_flatten, tree_map, tree_unflatten

DEFAULT_VIRTUAL_DEVICES = 8
MESH_AXES = ("key", "data")

# -- visible devices ---------------------------------------------------------
_VIRTUAL_DEVICES = 0  # 0: the physical devices
# Device ids the supervision plane has marked lost (health probe,
# supervision/health.py). Every mesh built through make_key_mesh avoids
# them, so a supervised rebuild after device loss lands the sharded state
# on the surviving devices. Process-global on purpose: a lost device is
# lost for every graph in the process.
_EXCLUDED_DEVICE_IDS: frozenset = frozenset()
_LOCK = threading.Lock()


def ensure_virtual_devices(n: int = DEFAULT_VIRTUAL_DEVICES) -> bool:
    """Make ``n`` virtual devices visible on the graph's device, so a mesh
    of up to ``n`` shards runs on one card (or on the CPU). The registry
    is process-wide; ``n=0`` goes back to the physical devices. Returns
    True (the JAX package's twin returns False when it is too late to
    change its platform; here it never is)."""
    global _VIRTUAL_DEVICES
    n = int(n)
    if n < 0:
        raise WindFlowError(f"ensure_virtual_devices: n must be >= 0, "
                            f"got {n}")
    with _LOCK:
        _VIRTUAL_DEVICES = n
    return True


def virtual_device_count() -> int:
    """The registry's virtual device count (0: none, physical devices)."""
    return _VIRTUAL_DEVICES


def _resolve(device) -> torch.device:
    """The graph's device rule (None: the card, which must exist)."""
    from ..topology.pipegraph import resolve_device
    return resolve_device(device)


def visible_devices(device=None) -> List[Tuple[int, torch.device]]:
    """``(device id, torch device)`` of every visible device: the
    registry's virtual devices, all on ``device``; else each CUDA card
    (``device`` on the CUDA side) or the one CPU."""
    dev = _resolve(device)
    if _VIRTUAL_DEVICES:
        return [(i, dev) for i in range(_VIRTUAL_DEVICES)]
    if dev.type == "cuda":
        return [(i, torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
    return [(0, dev)]


def set_excluded_devices(device_ids) -> None:
    """Replace the excluded-device set (ids as ``visible_devices`` gives
    them). The supervisor calls this from the health probe before every
    rebuild; an empty set restores full capacity."""
    global _EXCLUDED_DEVICE_IDS
    with _LOCK:
        _EXCLUDED_DEVICE_IDS = frozenset(int(d) for d in device_ids)


def excluded_device_ids() -> frozenset:
    return _EXCLUDED_DEVICE_IDS


def healthy_devices(device=None) -> List[Tuple[int, torch.device]]:
    """``visible_devices`` minus the excluded set. Falls back to ALL
    devices when the exclusion set would leave nothing: a probe gone mad
    must degrade to the pre-probe behaviour, not to a zero-device mesh."""
    devs = visible_devices(device)
    excl = _EXCLUDED_DEVICE_IDS
    if not excl:
        return list(devs)
    alive = [d for d in devs if d[0] not in excl]
    return alive if alive else list(devs)


class KeyMesh:
    """A ``('key', 'data')`` mesh of ``ka * da`` shards. ``shape`` maps
    axis name -> size (as ``jax.sharding.Mesh.shape`` does); shard
    ``s = i * da + j`` is key index ``i``, data index ``j``, and sits on
    ``devices[s]`` with device id ``device_ids[s]``. Every shard lives on
    ONE physical device (``device``)."""

    def __init__(self, shape: Tuple[int, int],
                 devices: List[Tuple[int, torch.device]]) -> None:
        ka, da = int(shape[0]), int(shape[1])
        if ka * da != len(devices) or ka < 1 or da < 1:
            raise ValueError(f"mesh shape {shape} does not match "
                             f"{len(devices)} devices")
        physical = sorted({str(d) for _, d in devices})
        if len(physical) > 1:
            raise WindFlowError(
                f"mesh: a mesh over {len(physical)} physical devices "
                f"({', '.join(physical)}) is not yet ported to "
                "windflow_tpu_torch (shards of one mesh share one card; "
                "call ensure_virtual_devices(n) to place n shards on the "
                "graph's device)")
        self.shape = {"key": ka, "data": da}
        self.device_ids = [int(i) for i, _ in devices]
        self.devices = [d for _, d in devices]
        self.device = self.devices[0]

    @property
    def ns(self) -> int:
        return self.shape["key"] * self.shape["data"]

    def __repr__(self) -> str:  # pragma: no cover
        return (f"KeyMesh(key={self.shape['key']}, "
                f"data={self.shape['data']}, ids={self.device_ids}, "
                f"on {self.device})")


def default_ring_panes(win_panes: int, slide_panes: int,
                       fire_rounds: int) -> int:
    """Default leaf-ring size: the smallest power of two holding the
    window PLUS the worst-case unfired backlog one step can leave
    (fire_rounds windows of slide panes each)."""
    return 1 << max(3, math.ceil(
        math.log2(win_panes + max(fire_rounds * slide_panes, 16))))


def make_key_mesh(n_devices: int, shape=None, device=None) -> KeyMesh:
    """Largest 2D ('key', 'data') mesh for n devices (data axis >= 1) on
    ``device`` (None: the card). ``shape=(ka, da)`` forces an explicit
    factorization; when it no longer fits the healthy devices (health
    exclusions) the mesh degrades to the automatic path over what is
    healthy rather than refusing to recover."""
    dev = _resolve(device)
    devs = visible_devices(dev)
    alive = healthy_devices(dev)
    if shape is not None:
        ka, da = shape
        if ka * da > len(devs):
            raise ValueError(f"mesh shape {shape} needs {ka * da} devices, "
                             f"have {len(devs)}")
        if ka * da > len(alive):
            return make_key_mesh(len(alive), device=dev)
        return KeyMesh((ka, da), alive[:ka * da])
    n_devices = max(1, min(int(n_devices), len(alive)))
    ka, da = n_devices, 1
    # prefer a 2D mesh when the device count allows it
    for cand in (2, 4):
        if n_devices % cand == 0 and n_devices // cand >= 2:
            da = cand
            ka = n_devices // cand
            break
    return KeyMesh((ka, da), alive[:n_devices])


def make_sharded_state(mesh: KeyMesh, n_keys: int, n_panes: int):
    """Per-key pane accumulators, key-sharded (one stacked copy: the
    ``'data'`` replicas are equal); zeros."""
    ka = mesh.shape["key"]
    n_keys_padded = math.ceil(n_keys / ka) * ka
    state = torch.zeros((n_keys_padded, n_panes), dtype=torch.float32,
                        device=mesh.device)
    counts = torch.zeros((n_keys_padded, n_panes), dtype=torch.int32,
                         device=mesh.device)
    return state, counts


# ---------------------------------------------------------------------------
# routing primitives
# ---------------------------------------------------------------------------
def _bucket_plan(dest: torch.Tensor, n_dst: int, C: int):
    """Bucket-by-owner of a stacked ``(n_src, B)`` destination plane:
    ``(order, flat, ok)`` over the flattened lanes. ``order`` sorts the
    lanes by (source shard, destination) stably (each source shard's
    lanes keep their order within a destination run), ``flat`` is each
    sorted lane's slot ``(src * n_dst + dest) * C + within`` in the
    ``(n_src, n_dst, C)`` bucket tensor and ``ok`` masks the lanes past a
    bucket's capacity ``C``."""
    n_src, B = dest.shape
    dev = dest.device
    comp = (torch.arange(n_src, device=dev).unsqueeze(1) * n_dst
            + dest).reshape(-1)
    order = torch.sort(comp, stable=True).indices
    cs = comp[order]
    counts = torch.bincount(comp, minlength=n_src * n_dst)
    start = torch.cumsum(counts, 0) - counts
    within = torch.arange(n_src * B, device=dev) - start[cs]
    ok = within < C
    flat = cs * C + torch.clamp(within, max=C - 1)
    return order, flat, ok


def _bucketize(col: torch.Tensor, order, flat, ok, n_src: int, n_dst: int,
               C: int, fill) -> torch.Tensor:
    """``(n_src, n_dst, C)`` buckets of a flattened column: lanes past a
    bucket's capacity land on the scratch element and are dropped."""
    m = n_src * n_dst * C
    buf = torch.full((m + 1,) + col.shape[1:], fill, dtype=col.dtype,
                     device=col.device)
    buf[torch.where(ok, flat, m)] = col[order]
    return buf[:m].reshape((n_src, n_dst, C) + col.shape[1:])


def _all_to_all(buckets: torch.Tensor) -> torch.Tensor:
    """``lax.all_to_all`` over the flattened mesh, stacked: block ``d`` of
    source shard ``s`` becomes block ``s`` of shard ``d`` (a transpose of
    the first two axes; its own inverse)."""
    return buckets.transpose(0, 1).contiguous()


def _all_to_all_key(buckets: torch.Tensor, ka: int, da: int) -> torch.Tensor:
    """``lax.all_to_all`` along ``'key'`` only, stacked: ``(ns, ka, C)``
    buckets of shard ``(i, j)`` -> ``(ns, ka * C)`` received by shard
    ``(d, j)`` in source key order ``i`` (the data index stays)."""
    C = buckets.shape[2]
    b = buckets.reshape((ka, da, ka, C) + buckets.shape[3:])
    return b.permute((2, 1, 0, 3) + tuple(range(4, b.dim()))) \
        .reshape((ka * da, ka * C) + buckets.shape[3:])


def _route_to_owners(mesh: KeyMesh, k_local: int, C: int, keys, panes,
                     vals):
    """The keyby shuffle of the key-sharded steps: bucket each shard's
    local tuples by owner key shard and ``all_to_all`` along ``'key'``.
    ``keys`` / ``panes`` / ``vals`` are global ``(ns * B,)`` columns in
    shard order. Returns ``(keys, panes, vals, valid, local_key)`` as
    ``(ns, ka * C)`` planes, one row per receiving shard; key < 0 marks a
    padding lane, routed to key shard 0 and invalid there."""
    ka, da = mesh.shape["key"], mesh.shape["data"]
    ns = ka * da
    dest = torch.clamp(torch.div(keys, k_local, rounding_mode="floor"),
                       0, ka - 1).reshape(ns, -1)
    order, flat, ok = _bucket_plan(dest, ka, C)

    def a2a(col, fill):
        return _all_to_all_key(
            _bucketize(col, order, flat, ok, ns, ka, C, fill), ka, da)

    rk = a2a(keys, -1)
    rp = a2a(panes, 0)
    rv = {f: a2a(v, 0) for f, v in vals.items()}
    valid = rk >= 0
    shard_key = (torch.arange(ns, device=keys.device) // da).unsqueeze(1)
    local_key = torch.where(valid, rk - shard_key * k_local, 0)
    return rk, rp, rv, valid, local_key


def _route_flat(ns: int, k_local: int, C: int, slots, aux, vals):
    """Bucket-by-owner + ``all_to_all`` over the flattened mesh: the KEYBY
    shuffle of the sharded operators. ``slots`` are dense key slots (< 0 =
    padding lane, routed to shard 0 and dropped by the ``valid`` mask),
    ``aux`` is one int column that rides the shuffle (the global arrival
    position for scans), ``vals`` a dict of columns; all ``(ns * B,)`` in
    shard order. Returns ``(recv_slots, recv_aux, recv_vals, valid,
    local_key, order, flat, ok)``, the received planes flattened to
    ``(ns * ns * C,)`` in receiving-shard order (each shard's lanes in
    source-shard order, which is global arrival order); the last three
    are the source-side routing map ``_route_back`` needs."""
    dest = torch.clamp(torch.div(slots, k_local, rounding_mode="floor"),
                       0, ns - 1).reshape(ns, -1)
    order, flat, ok = _bucket_plan(dest, ns, C)

    def a2a(col, fill):
        return _all_to_all(_bucketize(col, order, flat, ok, ns, ns, C,
                                      fill)).reshape((-1,) + col.shape[1:])

    rs = a2a(slots, -1)
    ra = a2a(aux, 0)
    rv = {f: a2a(v, 0) for f, v in vals.items()}
    valid = rs >= 0
    shard = torch.arange(ns, device=slots.device).repeat_interleave(ns * C)
    local_key = torch.where(valid, rs - shard * k_local, 0)
    return rs, ra, rv, valid, local_key, order, flat, ok


def _route_back(ns: int, C: int, routed: torch.Tensor, order, flat, ok,
                fill=0) -> torch.Tensor:
    """Inverse shuffle: per-received-lane results (in the recv layout)
    return to their source shard (the all_to_all is its own inverse) and
    un-permute to the original arrival positions."""
    ret = _all_to_all(routed.reshape((ns, ns, C) + routed.shape[1:])) \
        .reshape((-1,) + routed.shape[1:])
    picked = ret[flat]
    out = torch.full((order.shape[0],) + routed.shape[1:], fill,
                     dtype=routed.dtype, device=routed.device)
    out[order] = torch.where(
        ok.reshape((-1,) + (1,) * (routed.dim() - 1)), picked,
        torch.as_tensor(fill, dtype=routed.dtype, device=routed.device))
    return out


# ---------------------------------------------------------------------------
# the key-sharded steps
# ---------------------------------------------------------------------------
def sharded_keyby_window_step(mesh: KeyMesh, n_keys: int, n_panes: int,
                              local_batch: int):
    """``(step, n_keys_padded, global_batch)``: ``step(state, counts, keys,
    values, panes) -> (state', counts', n_tuples)`` over global
    ``(ns * local_batch,)`` columns in shard order. Tuples route to their
    key-owner shard, each shard folds its received tuples into a DELTA,
    and the deltas of the ``'data'`` replicas sum (the ``psum``) into the
    pane accumulators. Float sums group by shard: within the stated
    tolerance of the JAX package's, not bit-equal."""
    ka, da = mesh.shape["key"], mesh.shape["data"]
    n_keys_padded = math.ceil(n_keys / ka) * ka
    k_local = n_keys_padded // ka
    C = local_batch

    def step(state, counts, keys, values, panes):
        rk, rp, rv, valid, lkey = _route_to_owners(
            mesh, k_local, C, keys, panes, {"v": values})
        rv = rv["v"]
        cells = k_local * n_panes
        pane_idx = torch.where(valid, torch.remainder(rp, n_panes), 0)
        shard = torch.arange(ka * da, device=keys.device).unsqueeze(1)
        idx = torch.where(valid, shard * cells + lkey * n_panes + pane_idx,
                          ka * da * cells)
        delta = torch.zeros(ka * da * cells + 1, dtype=state.dtype,
                            device=state.device)
        delta.index_put_((idx.reshape(-1),),
                         torch.where(valid, rv, 0).reshape(-1)
                         .to(state.dtype), accumulate=True)
        dcount = torch.zeros(ka * da * cells + 1, dtype=counts.dtype,
                             device=counts.device)
        dcount.index_put_((idx.reshape(-1),),
                          valid.reshape(-1).to(counts.dtype),
                          accumulate=True)
        # psum over 'data': the data replicas' deltas of one key shard
        dsum = delta[:-1].reshape(ka, da, cells).sum(1)
        csum = dcount[:-1].reshape(ka, da, cells).sum(1)
        state = state + dsum.reshape(state.shape)
        counts = counts + csum.reshape(counts.shape)
        return state, counts, valid.sum()

    return step, n_keys_padded, ka * da * local_batch


def sharded_ffat_forest(mesh: KeyMesh, lift, combine, n_keys: int,
                        win_panes: int, slide_panes: int, local_batch: int,
                        fire_rounds: int = 2, ring_panes: int = 0,
                        late_policy: str = "keep_open",
                        on_rebuild: Optional[Callable[[], None]] = None):
    """The FlatFAT forest key-sharded over the mesh, with ingestion
    data-parallel along ``'data'`` (the JAX package's
    ``sharded_ffat_forest``; see its docstring for the window rules).

    One step: fast-forward drained keys past the frontier -> route tuples
    to their key-owner shard (``_route_to_owners``) -> the per-key
    lateness rule -> per-shard segmented scan by (key, pane) and a scatter
    of the segment tails into one DELTA forest per shard -> the butterfly
    merge of the ``'data'`` replicas' deltas (replica 0's combine order:
    pairs of adjacent data indices, then pairs of pairs) -> the merged
    delta folds into the leaves -> level rebuild of every key row of every
    shard in ONE call of ``kernels.forest_rebuild`` (K1 on a card, its
    plain version on the CPU; ``on_rebuild`` is called after each) ->
    ``fire_rounds`` fire rounds (window queries of every key row, results
    into column ``r``, eviction of the panes sliding out).

    The JAX step skips the rebuild (``lax.cond``) when no key can fire;
    knowing that on the host would cost a read-back per step, so the port
    rebuilds every step. Internal levels are only read by the step's own
    fire rounds, so the results are the same.

    Returns ``(init_fn, step_fn, meta)``: ``init_fn(sample_vals)`` the
    5-tuple state ``(trees, tvalid, next_fire, max_leaf, fired)`` (trees
    a dict of ``(K_pad, 2F)`` tensors, the control state ``(K_pad,)``
    int32); ``step_fn(*state, keys, values, panes, frontier)`` the flat
    10-tuple ``(trees, tvalid, next_fire, max_leaf, fired, results,
    res_valid, res_wid, n_tuples, n_late)``, results ``(K_pad,
    fire_rounds)`` per lift field; ``meta = (K_pad, k_local,
    global_batch)``."""
    ka, da = mesh.shape["key"], mesh.shape["data"]
    ns = ka * da
    if da & (da - 1):
        raise ValueError(f"sharded_ffat_forest: the 'data' axis must be a "
                         f"power of two for the delta-merge butterfly "
                         f"(got {da})")
    K_pad = math.ceil(n_keys / ka) * ka
    k_local = K_pad // ka
    F = ring_panes or default_ring_panes(win_panes, slide_panes,
                                         fire_rounds)
    if F & (F - 1) or F < win_panes + fire_rounds * slide_panes:
        raise ValueError(
            f"sharded_ffat_forest: ring_panes must be a power of two >= "
            f"win_panes + fire_rounds*slide_panes (got F={F}, "
            f"win={win_panes}, rounds={fire_rounds}, slide={slide_panes})")
    # int32 index-plane guard (the JAX package's, kept for parity): the
    # flat indices reach k_local*2F per shard, and ring GROWTH doubles F
    # through this same construction path
    if k_local * 2 * F > np.iinfo(np.int32).max:
        raise ValueError(
            f"sharded_ffat_forest: k_local*2*ring_panes = {k_local * 2 * F}"
            f" overflows the int32 index plane (k_local={k_local}, "
            f"ring_panes={F}); shard over more 'key' devices or lower "
            f"key_capacity/ring_panes")
    if late_policy not in ("keep_open", "ref_fired"):
        raise ValueError(
            f"sharded_ffat_forest: late_policy must be 'keep_open' or "
            f"'ref_fired' (got {late_policy!r})")
    # static late-bound offset: 0 keeps tuples that still belong to open
    # windows; win-slide reproduces the reference's fired-window bound,
    # clamped at 0 for hopping windows (see the JAX package)
    LATE_OFF = max(0, win_panes - slide_panes) \
        if late_policy == "ref_fired" else 0
    NNODES = 2 * F
    C = local_batch
    dev = mesh.device

    def step(trees, tvalid, next_fire, max_leaf, fired, keys, raw_vals,
             panes, frontier):
        frontier = int(frontier)
        # ---- fast-forward DRAINED keys past the frontier ----------------
        first_unfireable = max(
            0, ((frontier - win_panes) // slide_panes + 1) * slide_panes)
        ff = (max_leaf < next_fire) & (next_fire < first_unfireable)
        next_fire = torch.where(ff, first_unfireable, next_fire) \
            .to(torch.int32)
        fired = torch.where(ff, first_unfireable // slide_panes, fired) \
            .to(torch.int32)

        # ---- route tuples to their key-owner shard ---------------------
        rk, rp, rv, valid, lkey = _route_to_owners(
            mesh, k_local, C, keys, panes, raw_vals)
        rk, rp, valid, lkey = (t.reshape(-1) for t in (rk, rp, valid, lkey))
        rv = {f: v.reshape((-1,) + v.shape[2:]) for f, v in rv.items()}
        gkey = torch.where(valid, rk, 0)
        nf_t = next_fire[gkey]
        late_bound = nf_t
        if LATE_OFF:
            late_bound = nf_t + torch.where(nf_t > 0, LATE_OFF, 0)
        late = valid & (rp < late_bound)
        valid = valid & ~late
        n_late = late.sum()

        # ---- per-shard segmented scan by (key, pane) -------------------
        L = rk.shape[0]
        vals = broadcast_scalar_fields(lift(rv), L, dev)
        leaf = torch.where(valid, torch.remainder(rp, F), 0)
        shard = torch.arange(ns, device=dev).repeat_interleave(L // ns)
        row = shard * k_local + lkey  # the shard's own forest row
        big = ns * k_local * F
        composite = torch.where(valid, row * F + leaf, big)
        order2 = torch.sort(composite, stable=True).indices
        sc = composite[order2]
        same_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                               sc[1:] == sc[:-1]])
        is_end = torch.cat([sc[1:] != sc[:-1],
                            torch.ones(1, dtype=torch.bool, device=dev)]) \
            & (sc < big)
        scanned = segmented_scan(combine, {k: v[order2]
                                           for k, v in vals.items()},
                                 same_prev)
        OOB = ns * k_local * NNODES
        flat_idx = torch.div(sc, F, rounding_mode="floor") * NNODES + F \
            + torch.remainder(sc, F)
        safe_idx = torch.where(is_end, flat_idx, OOB)
        # segment tails scatter into a DELTA forest per shard (each data
        # replica received a disjoint tuple subset)
        dleaf = {}
        for k, sv in scanned.items():
            buf = torch.zeros(OOB + 1, dtype=sv.dtype, device=dev)
            buf[safe_idx] = sv
            dleaf[k] = buf[:OOB].reshape(ka, da, k_local * NNODES)
        vbuf = torch.zeros(OOB + 1, dtype=torch.bool, device=dev)
        vbuf[safe_idx] = is_end
        dvalid = vbuf[:OOB].reshape(ka, da, k_local * NNODES)
        # the butterfly over 'data' (ppermute with partner j ^ shift), in
        # the combine order of replica 0, whose rows every replica holds
        while dvalid.shape[1] > 1:
            dvalid, dleaf = comb_valid(
                combine, dvalid[:, 0::2], {k: v[:, 0::2]
                                           for k, v in dleaf.items()},
                dvalid[:, 1::2], {k: v[:, 1::2] for k, v in dleaf.items()})
        dvalid = dvalid.reshape(-1)
        dleaf = {k: v.reshape(-1) for k, v in dleaf.items()}
        # fold the merged delta into the state leaves
        tflat = {k: t.reshape(-1) for k, t in trees.items()}
        vflat = tvalid.reshape(-1)
        leaf_valid = vflat & dvalid
        merged_all = combine(tflat, dleaf)
        trees = {k: torch.where(dvalid, torch.where(
            leaf_valid, merged_all[k], dleaf[k]), t).reshape(K_pad, NNODES)
            for k, t in tflat.items()}
        tvalid = (vflat | dvalid).reshape(K_pad, NNODES)
        # per-key max pane (the pmax over 'data' is the one scatter)
        ml = torch.cat([max_leaf, max_leaf.new_full((1,), -1)])
        ml = ml.scatter_reduce(
            0, torch.where(valid, rk, K_pad).to(torch.int64),
            torch.where(valid, rp, -1).to(ml.dtype), reduce="amax")
        max_leaf = ml[:K_pad].contiguous()

        # ---- level rebuild of every shard's forest (K1) ----------------
        trees, tvalid = forest_rebuild(trees, tvalid, combine)
        if on_rebuild is not None:
            on_rebuild()

        # ---- fire rounds -------------------------------------------------
        tflat = {k: t.reshape(-1) for k, t in trees.items()}
        base = torch.arange(K_pad, device=dev) * NNODES
        res = {k: torch.zeros((K_pad, fire_rounds), dtype=t.dtype,
                              device=dev) for k, t in trees.items()}
        res_valid = torch.zeros((K_pad, fire_rounds), dtype=torch.bool,
                                device=dev)
        res_wid = torch.zeros((K_pad, fire_rounds), dtype=torch.int32,
                              device=dev)
        evict = torch.arange(slide_panes, device=dev).unsqueeze(0)
        m = K_pad * NNODES
        for r in range(fire_rounds):
            vflat = tvalid.reshape(-1)
            eligible = (next_fire + win_panes <= frontier) \
                & (max_leaf >= next_fire)
            start = next_fire
            length = torch.where(
                eligible, torch.clamp(max_leaf + 1 - start, max=win_panes),
                0)
            qv, qr = window_query(combine, tflat, vflat, base,
                                  torch.remainder(start, F), length, F)
            qv = qv & eligible
            for k in res:
                res[k][:, r] = torch.where(qv, qr[k], 0).to(res[k].dtype)
            res_valid[:, r] = qv
            res_wid[:, r] = torch.where(eligible, fired, -1)
            # evict the panes sliding out of every fired key
            ev = start.unsqueeze(1) + evict
            ev_ok = eligible.unsqueeze(1) & (ev <= max_leaf.unsqueeze(1))
            eflat = torch.where(ev_ok, base.unsqueeze(1) + F
                                + torch.remainder(ev, F), m)
            kill = torch.zeros(m + 1, dtype=torch.bool, device=dev)
            kill[eflat.reshape(-1)] = True
            tvalid = tvalid & ~kill[:m].reshape(K_pad, NNODES)
            next_fire = torch.where(eligible, next_fire + slide_panes,
                                    next_fire).to(torch.int32)
            fired = torch.where(eligible, fired + 1, fired).to(torch.int32)
        return (trees, tvalid, next_fire, max_leaf, fired, res, res_valid,
                res_wid, valid.sum(), n_late)

    def init_fn(sample_vals):
        """``sample_vals``: dict of one-row columns (numpy or torch) with
        the RAW tuple dtypes (pre-lift)."""
        one = {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(dev) for k, v in sample_vals.items()}
        shapes = broadcast_scalar_fields(lift(one), 1, dev)
        trees = {name: torch.zeros((K_pad, NNODES), dtype=s.dtype,
                                   device=dev)
                 for name, s in shapes.items()}
        tvalid = torch.zeros((K_pad, NNODES), dtype=torch.bool, device=dev)
        next_fire = torch.zeros(K_pad, dtype=torch.int32, device=dev)
        max_leaf = torch.full((K_pad,), -1, dtype=torch.int32, device=dev)
        fired = torch.zeros(K_pad, dtype=torch.int32, device=dev)
        return trees, tvalid, next_fire, max_leaf, fired

    return init_fn, step, (K_pad, k_local, ns * local_batch)


def ring_pane_window_query(mesh: KeyMesh, n_panes_global: int,
                           win_panes: int, slide_panes: int):
    """Sliding-window sums over a PANE-SHARDED timeline: the pane axis is
    block-sharded over ``'key'``, a shard owns the windows STARTING in its
    slice, and receives the head of its right neighbour (the ``ppermute``
    ring exchange, here a roll of the stacked heads). Returns
    ``(fn, n_windows)``; ``fn(pane_partials[P_global]) ->
    window_sums[W_global]``, window w = sum of panes [w*slide,
    w*slide+win)."""
    n_shards = mesh.shape["key"]
    if n_panes_global % n_shards:
        raise ValueError("n_panes_global must divide the key axis")
    p_local = n_panes_global // n_shards
    halo = win_panes - 1
    if halo > p_local:
        raise ValueError("window span exceeds one shard + halo; increase "
                         "panes per shard")
    n_windows = (n_panes_global - win_panes) // slide_panes + 1

    def fn(panes: torch.Tensor) -> torch.Tensor:
        dev = panes.device
        local = panes.reshape(n_shards, p_local)
        # shard i receives shard i+1's head (ring: the last wraps to 0)
        right_head = torch.roll(local[:, :halo], -1, dims=0)
        ext = torch.cat([local, right_head], dim=1)  # (n, p_local + halo)
        shard = torch.arange(n_shards, device=dev).unsqueeze(1)
        start0 = shard * p_local
        first_w = torch.div(start0 + slide_panes - 1, slide_panes,
                            rounding_mode="floor")
        max_w_here = p_local // slide_panes + 1
        w_ids = first_w + torch.arange(max_w_here, device=dev)
        starts_local = w_ids * slide_panes - start0
        valid = (w_ids < n_windows) & (starts_local < p_local)
        idx = torch.clamp(starts_local.unsqueeze(2)
                          + torch.arange(win_panes, device=dev),
                          0, p_local + halo - 1)
        gathered = torch.gather(
            ext.unsqueeze(1).expand(-1, max_w_here, -1), 2, idx)
        sums = torch.where(valid.unsqueeze(2), gathered, 0).sum(2) \
            .to(panes.dtype)
        # each window is produced by exactly one shard: the psum assembles
        # the dense global window vector
        out = torch.zeros(n_windows, dtype=panes.dtype, device=dev)
        out.index_put_((torch.clamp(w_ids, 0, n_windows - 1).reshape(-1),),
                       torch.where(valid, sums, 0).reshape(-1),
                       accumulate=True)
        return out

    return fn, n_windows


# ---------------------------------------------------------------------------
# flat-owner plane: the sharded Map/Filter/Reduce
# ---------------------------------------------------------------------------
# A grid-scan state transition is SEQUENTIAL per key, so no cross-replica
# merge exists: every tuple of a key lands on ONE shard. The sharded
# Map/Filter/Reduce block-shard the slot space over the FLATTENED
# ('key', 'data') shard order (ns = ka*da shards); the mesh shape stays a
# pure layout choice, which is what makes 8x1 / 4x2 / 2x4 results equal.

def mesh_shard_count(mesh: KeyMesh) -> int:
    """Shards of the flat-owner plane: every shard of the mesh."""
    return mesh.shape["key"] * mesh.shape["data"]


def make_mesh_table(mesh: KeyMesh, state_init, K_pad: int):
    """Per-key state table of the flat-owner plane: a pytree of
    ``(K_pad + 1,)`` tensors filled with the ``state_init`` leaves (int64
    / float64 become int32 / float32), the shards' row blocks stacked and
    one trailing scratch row (the grid scan's target of the padding
    lanes, ``gpu/ops_gpu.py:grid_scan_core``)."""
    leaves, spec = tree_flatten(state_init)
    out = []
    for v in leaves:
        t = canonical(torch.as_tensor(v).detach().cpu())
        if t.dim():
            raise WindFlowError("mesh: state leaves must be scalars (one "
                                "value per key)")
        out.append(torch.empty(K_pad + 1, dtype=t.dtype,
                               device=mesh.device).fill_(t))
    return tree_unflatten(spec, out)


INT32_MAX = 2**31 - 1


def sharded_grid_scan(mesh: KeyMesh, func, filter_mode: bool,
                      key_capacity: int, M: int, local_batch: int):
    """Mesh-sharded keyed grid scan: the device core of the sharded
    stateful Map/Filter. One step per batch slice: bucket-by-owner +
    ``all_to_all`` over the flat shard order (the table never moves) ->
    per-key arrival ranking (a stable sort of the received lanes by slot:
    the received layout is global arrival order) -> the grid scan of
    ``gpu/ops_gpu.py:grid_scan_core`` over the stacked shards' row blocks
    (``K_pad`` keys x ``M`` positions) -> the inverse ``all_to_all``
    returns outputs to arrival order.

    Returns ``(step, meta)``: ``step(table, slots, gpos, vals) -> (table,
    out, n_tuples)`` (the table, ``make_mesh_table``'s, updated in
    place), ``out`` the per-row output columns (map) or keep mask
    (filter) in arrival order; ``meta = (K_pad, k_local, GB)``."""
    from ..gpu.ops_gpu import grid_scan_core

    ns = mesh_shard_count(mesh)
    K_pad = math.ceil(key_capacity / ns) * ns
    k_local = K_pad // ns
    C = local_batch
    GB = ns * local_batch
    if K_pad * M + 1 > INT32_MAX:
        raise WindFlowError(
            f"sharded_grid_scan: the grid is K_pad={K_pad} keys x M={M} "
            f"positions = {K_pad * M} cells, beyond int32 cell indices; "
            "use smaller batches (M is the most rows of one key)")
    core = grid_scan_core(func, filter_mode, M, K_pad)
    dev = mesh.device
    touched = torch.arange(K_pad, dtype=torch.int32, device=dev)
    tmask = torch.ones(K_pad, dtype=torch.bool, device=dev)
    dirty = torch.zeros(K_pad + 1, dtype=torch.bool, device=dev)

    def step(table, slots, gpos, vals):
        rs, _rg, rv, valid, _lkey, order, flat, ok = _route_flat(
            ns, k_local, C, slots, gpos, vals)
        # per-key arrival rank on the received lanes (the global slot is
        # the owner shard's row block offset + the local key)
        gslot = torch.where(valid, rs, K_pad).to(torch.int64)
        sort2 = torch.sort(gslot, stable=True).indices
        sl = gslot[sort2]
        cnt = torch.bincount(gslot, minlength=K_pad + 1)
        start = torch.cumsum(cnt, 0) - cnt
        within = torch.empty_like(gslot)
        within[sort2] = torch.arange(gslot.shape[0], device=dev) - start[sl]
        grid_idx = torch.where(valid, gslot * M
                               + torch.clamp(within, max=M - 1),
                               K_pad * M).to(torch.int32)
        out = core(rv, valid, grid_idx, touched, tmask, table, dirty)
        if filter_mode:
            ret = _route_back(ns, C, out.to(torch.int8), order, flat,
                              ok).to(torch.bool)
        else:
            ret = {f: _route_back(ns, C, o, order, flat, ok)
                   for f, o in out.items()}
        return table, ret, valid.sum()

    return step, (K_pad, k_local, GB)


def sharded_keyed_reduce(mesh: KeyMesh, combine, key_capacity: int,
                         local_batch: int):
    """Mesh-sharded keyed Reduce: per-batch ``reduce_by_key`` with the
    KEYBY shuffle as the flat-owner ``all_to_all`` and the combine as a
    segmented scan on each key's owner shard (``gpu/scan.py``; stacked,
    one scan over every shard's received lanes sorted by slot). Fields
    the combine does not return pass through unchanged.

    Returns ``(step, meta)``: ``step(slots, vals) -> (res, touched,
    n_tuples)``, ``res`` mapping each field to a ``(K_pad,)`` tensor of
    per-slot results, ``touched`` the ``(K_pad,)`` mask of slots the
    batch touched; ``meta = (K_pad, k_local, GB)``."""
    ns = mesh_shard_count(mesh)
    K_pad = math.ceil(key_capacity / ns) * ns
    k_local = K_pad // ns
    C = local_batch
    GB = ns * local_batch
    dev = mesh.device

    def step(slots, vals):
        rs, _, rv, valid, _lkey, _, _, _ = _route_flat(
            ns, k_local, C, slots, slots, vals)
        gslot = torch.where(valid, rs, K_pad).to(torch.int64)
        order = torch.sort(gslot, stable=True).indices  # arrival in key
        sl = gslot[order]
        same_prev = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                               sl[1:] == sl[:-1]])
        scanned = segmented_scan(combine, {k: v[order]
                                           for k, v in rv.items()},
                                 same_prev)
        is_end = torch.cat([sl[1:] != sl[:-1],
                            torch.ones(1, dtype=torch.bool, device=dev)]) \
            & (sl < K_pad)
        safe = torch.where(is_end, sl, K_pad)
        res = {}
        for f, v in scanned.items():
            buf = torch.zeros(K_pad + 1, dtype=v.dtype, device=dev)
            buf[safe] = torch.where(is_end, v, 0).to(v.dtype)
            res[f] = buf[:K_pad]
        tbuf = torch.zeros(K_pad + 1, dtype=torch.bool, device=dev)
        tbuf[safe] = is_end
        return res, tbuf[:K_pad], valid.sum()

    return step, (K_pad, k_local, GB)


def mesh_occupancy(n_slots: int, k_local: int, ns: int):
    """(max per-shard slot occupancy, skew) for ``n_slots`` dense
    first-seen slots block-owned ``slot // k_local`` over ``ns`` shards.
    Skew is max/mean: 1.0 when keys fill the shards evenly, ns when one
    shard owns everything (dense slots fill shard 0 first, so early-stream
    skew is expected and decays as keys arrive)."""
    if n_slots <= 0 or ns <= 0 or k_local <= 0:
        return 0, 0.0
    occ_max = k_local if n_slots >= k_local else n_slots
    mean = n_slots / ns
    return occ_max, round(occ_max / mean, 3) if mean > 0 else 0.0


def host_tree(table, K_pad: int):
    """The table's rows (no scratch row) as host numpy, tree order."""
    return tree_map(lambda t: t[:K_pad].cpu().numpy().copy(), table)


__all__ = [
    "DEFAULT_VIRTUAL_DEVICES", "KeyMesh", "MESH_AXES",
    "default_ring_panes", "ensure_virtual_devices", "excluded_device_ids",
    "healthy_devices", "make_key_mesh", "make_mesh_table",
    "make_sharded_state", "mesh_occupancy", "mesh_shard_count",
    "ring_pane_window_query", "set_excluded_devices", "sharded_ffat_forest",
    "sharded_grid_scan", "sharded_keyby_window_step",
    "sharded_keyed_reduce", "virtual_device_count", "visible_devices",
]
