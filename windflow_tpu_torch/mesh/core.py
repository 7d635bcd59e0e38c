"""Mesh execution plane, collective core: key-sharded streaming state over
a ``('key', 'data')`` mesh of shards placed on card groups.

The port of ``windflow_tpu/mesh/core.py``. The JAX package runs one
``shard_map`` program per step over a ``jax.sharding.Mesh``, one device
per shard, and moves tuples between devices with XLA collectives. The
port keeps the single-controller model (ONE host replica drives every
shard) and the same block ownership (shard ``s`` owns keys ``[s*k_local,
(s+1)*k_local)``), and places the shards on GROUPS: a group is a
contiguous block of shards of the flat ``(key, data)`` order (shard ``s =
i * da + j``) on one device, STACKED there along a leading shard axis.
Inside a group a collective is one tensor op instead of a copy per pair
of shards:

- ``all_to_all`` of a ``(ns, ns, C)`` bucket tensor is the transpose of
  its first two axes (``_all_to_all``; over the ``'key'`` axis alone the
  buckets are ``(ka, da, ka, C)`` and the key axes swap);
- ``psum`` / ``pmax`` over an axis are a reduction over that shard axis
  (or one scatter-add / scatter-max into the key space);
- ``ppermute`` is an index permutation along the shard axis (the ring
  halo of ``ring_pane_window_query`` is a roll, the butterfly of the
  FFAT delta merge a pairing of even and odd data replicas).

Between groups the collectives are copies from card to card, issued by
the one host process (``Tensor.copy_`` into a buffer allocated on the
receiving card, ``non_blocking``; PyTorch orders a copy between two cards
against the current streams of both, and every op of the mesh runs on its
card's current stream). No NCCL: ``torch.distributed`` wants a process
per card, and the mesh has one host control plane.

- ``all_to_all``: each group buckets its own source shards; the blocks
  for another group's destination shards leave as ONE gather and ONE
  copy per column into a receive buffer on that group's card, where one
  scatter places them (``_exchange``). Lanes keep source-shard order
  within every receiving shard, which is global arrival order. The
  inverse shuffle (``_route_back``) is the same exchange run backwards.
- ``psum`` / the butterfly along ``'data'``: a key shard's state lives
  on the group of its shard ``(i, 0)``, its HOME. Where a group's block
  holds whole key shards (``da`` divides it), the data replicas of each
  of its key shards are on its card and the merge is the stacked one.
  Where it does not, a group also receives for the key shard whose shard
  ``(i, 0)`` lies in an earlier group (its FOREIGN key shard): it merges
  its own replicas of it and sends that partial to the home, which merges
  the partials in group order (``_to_homes``), keeping the butterfly's
  pairing (adjacent data indices, then pairs of pairs) for power-of-two
  blocks. The control rows a foreign key shard needs (the late rule's
  ``next_fire``) are copied from the home first (``_with_foreign``).
- The ring halo: a group's first head goes to the previous group's card;
  the roll stays within each group.
- Counters (``n_tuples``, ``n_late``) stay per group and are summed on
  the host from each group's read-back.

A sharded operand or result is ONE value per group (a list, in group
order, of tensors or dicts of tensors on each group's card); with one
group it is the bare value, and the path is the stacked one, op for op.
``split`` / ``join`` / ``read_host`` move between the global layout and
the groups'.

The key-sharded FFAT forest is replicated along ``'data'`` in the JAX
package, and the butterfly merge makes the replicas equal; the port holds
ONE copy per key shard, on its home, which is what the data replicas
would all hold. The flat-owner tables of the sharded Map/Filter
(``sharded_grid_scan``) hold ``ns_g * k_local`` rows on each group and
the grid scan runs over all of them at once: each key's state only ever
sees its own rows, so scanning the stacked row blocks together is
scanning each block.

There is no ``mode="drop"`` in torch: every masked scatter aims its
dropped lanes at one trailing scratch element, and a negative index
(key -1 marks a padding lane) is clipped before it can wrap.

Devices: without the registry the visible devices are the physical
ones, one shard per device: the CPU, or each CUDA card (a group each, as
the JAX package places one shard per TPU core). ``ensure_virtual_devices
(n)`` makes ``n`` virtual devices visible on the graph's device, one
group; ``ensure_virtual_devices(n, group_devices=[d0, ..., d_{g-1}])``
places them on ``g`` groups, virtual id ``v`` in group ``v // (n // g)``
on ``d_{v // (n // g)}``. Groups may share one device (the CPU, or
``cuda:0``) or take a card each (``cuda:c``); the code between groups is
the same either way. The registry is module state set by that call, never
an environment variable. The device-health exclusion registry names
virtual ids (physical card indices without virtual devices); a card is
lost when every id of its group is excluded, and the rebuilt mesh spans
the surviving groups.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..basic import WindFlowError
from ..kernels.ffat_step import (comb_valid, fire_query, ingest_fold,
                                 lane_blocks, reserve_ingest_scratch,
                                 sort_rows)
from ..gpu.schema import broadcast_scalar_fields, canonical
from ..kernels.forest_rebuild import forest_rebuild
from ..kernels.reduce_fold import keyed_fold, run_starts
from ..kernels.grid_scan import (HEAVY_ROWS, MAX_HEAVY_BLOCKS, GridStep,
                                  KeyRows, grid_walk, heavy_keys_device)
from ..pytree import tree_flatten, tree_map, tree_unflatten

DEFAULT_VIRTUAL_DEVICES = 8
MESH_AXES = ("key", "data")

# -- visible devices ---------------------------------------------------------
_VIRTUAL_DEVICES = 0  # 0: the physical devices
# The devices of the virtual devices' groups (empty: one group on the
# graph's device).
_GROUP_DEVICES: Tuple[torch.device, ...] = ()
# Device ids the supervision plane has marked lost (health probe,
# supervision/health.py). Every mesh built through make_key_mesh avoids
# them, so a supervised rebuild after device loss lands the sharded state
# on the surviving devices. Process-global on purpose: a lost device is
# lost for every graph in the process.
_EXCLUDED_DEVICE_IDS: frozenset = frozenset()
_LOCK = threading.Lock()


def ensure_virtual_devices(n: int = DEFAULT_VIRTUAL_DEVICES,
                           group_devices=None) -> bool:
    """Make ``n`` virtual devices visible, so a mesh of up to ``n`` shards
    runs where there are fewer physical devices. ``group_devices=None``
    puts them all on the graph's device (one group); a list of ``g``
    devices places them on ``g`` groups of ``n // g`` consecutive ids,
    group ``c`` on ``group_devices[c]`` (groups may repeat a device). The
    registry is process-wide; ``n=0`` goes back to the physical devices.
    Returns True (the JAX package's twin returns False when it is too late
    to change its platform; here it never is)."""
    global _VIRTUAL_DEVICES, _GROUP_DEVICES
    n = int(n)
    if n < 0:
        raise WindFlowError(f"ensure_virtual_devices: n must be >= 0, "
                            f"got {n}")
    groups: Tuple[torch.device, ...] = ()
    if group_devices is not None:
        groups = tuple(_card(torch.device(d)) for d in group_devices)
        if not groups or n == 0 or n % len(groups):
            raise WindFlowError(
                f"ensure_virtual_devices: {n} virtual devices do not split "
                f"into {len(groups)} equal groups")
        for d in groups:
            if d.type not in ("cpu", "cuda"):
                raise WindFlowError(f"ensure_virtual_devices: unsupported "
                                    f"group device {d}")
    with _LOCK:
        _VIRTUAL_DEVICES = n
        _GROUP_DEVICES = groups
    return True


def virtual_device_count() -> int:
    """The registry's virtual device count (0: none, physical devices)."""
    return _VIRTUAL_DEVICES


def virtual_device_groups() -> Optional[List[torch.device]]:
    """The registry's group devices (None: one group on the graph's
    device), as ``ensure_virtual_devices(n, group_devices=)`` takes them."""
    return list(_GROUP_DEVICES) if _GROUP_DEVICES else None


def _card(dev: torch.device) -> torch.device:
    """A CUDA device with its index (``cuda`` is the current card); the
    CPU without one."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return torch.device("cpu")
    return dev


def _resolve(device) -> torch.device:
    """The graph's device rule (None: the card, which must exist)."""
    from ..topology.pipegraph import resolve_device
    return resolve_device(device)


def visible_devices(device=None) -> List[Tuple[int, torch.device]]:
    """``(device id, torch device)`` of every visible device: the
    registry's virtual devices (on their groups' devices, else all on
    ``device``); else each CUDA card (``device`` on the CUDA side) or the
    one CPU."""
    dev = _resolve(device)
    if _VIRTUAL_DEVICES:
        if _GROUP_DEVICES:
            per = _VIRTUAL_DEVICES // len(_GROUP_DEVICES)
            return [(i, _GROUP_DEVICES[i // per])
                    for i in range(_VIRTUAL_DEVICES)]
        return [(i, dev) for i in range(_VIRTUAL_DEVICES)]
    if dev.type == "cuda":
        return [(i, torch.device("cuda", i))
                for i in range(torch.cuda.device_count())]
    return [(0, dev)]


def _group_labels(devs) -> Optional[List[int]]:
    """The registry's group of each virtual id (None: group by device)."""
    if not (_VIRTUAL_DEVICES and _GROUP_DEVICES):
        return None
    per = _VIRTUAL_DEVICES // len(_GROUP_DEVICES)
    return [int(i) // per for i, _ in devs]


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


class MeshGroup(NamedTuple):
    """Shards ``[lo, hi)`` of the flat order, stacked on ``device``."""
    device: torch.device
    lo: int
    hi: int

    @property
    def n(self) -> int:
        return self.hi - self.lo


class GroupKeys(NamedTuple):
    """A group's key shards along ``'key'``: the ones its shards receive
    for (``recv``), the ones it holds the state of (``home``: shard ``(i,
    0)`` is in the group), the home group of its foreign key shard (the
    first received one when it is not home; None when there is none) and
    its runs of data replicas, one ``(start, length)`` of local shards per
    received key shard."""
    recv: Tuple[int, int]
    home: Tuple[int, int]
    foreign_home: Optional[int]
    runs: Tuple[Tuple[int, int], ...]

    @property
    def n_home(self) -> int:
        return self.home[1] - self.home[0]


class KeyMesh:
    """A ``('key', 'data')`` mesh of ``ka * da`` shards. ``shape`` maps
    axis name -> size (as ``jax.sharding.Mesh.shape`` does); shard
    ``s = i * da + j`` is key index ``i``, data index ``j``, and sits on
    ``devices[s]`` with device id ``device_ids[s]``. ``groups`` labels
    each shard's group (None: one group per distinct device); a group is
    a contiguous block of shards on one device (``self.groups``, in
    order). ``device`` is the first group's, ``cards`` the distinct
    physical devices."""

    def __init__(self, shape: Tuple[int, int],
                 devices: List[Tuple[int, torch.device]],
                 groups=None) -> None:
        ka, da = int(shape[0]), int(shape[1])
        if ka * da != len(devices) or ka < 1 or da < 1:
            raise ValueError(f"mesh shape {shape} does not match "
                             f"{len(devices)} devices")
        labels = list(groups) if groups is not None \
            else [str(d) for _, d in devices]
        if len(labels) != len(devices):
            raise ValueError("mesh: one group label per shard")
        self.shape = {"key": ka, "data": da}
        self.device_ids = [int(i) for i, _ in devices]
        self.devices = [d for _, d in devices]
        self.groups: List[MeshGroup] = []
        seen = set()
        lo = 0
        for s in range(1, len(labels) + 1):
            if s < len(labels) and labels[s] == labels[lo]:
                continue
            if labels[lo] in seen:
                raise ValueError("mesh: a group must be a contiguous block "
                                 "of shards")
            seen.add(labels[lo])
            if len({str(d) for d in self.devices[lo:s]}) != 1:
                raise ValueError("mesh: the shards of a group share one "
                                 "device")
            self.groups.append(MeshGroup(self.devices[lo], lo, s))
            lo = s
        self.device = self.groups[0].device
        self.cards = sorted({str(g.device) for g in self.groups})
        self._group_of = np.repeat(np.arange(len(self.groups)),
                                   [g.n for g in self.groups])
        self._plans: Dict = {}
        self._keys: Optional[List[GroupKeys]] = None
        # bytes sent from one group's buffers into another's (host tally
        # of every _send; the exchange and merge traffic between groups)
        self.copied_bytes = 0

    @property
    def ns(self) -> int:
        return self.shape["key"] * self.shape["data"]

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    def group_of(self, shard: int) -> int:
        return int(self._group_of[shard])

    def key_groups(self) -> List[GroupKeys]:
        """Each group's ``GroupKeys`` (cached)."""
        if self._keys is None:
            da = self.shape["data"]
            out = []
            for g in self.groups:
                recv = (g.lo // da, (g.hi - 1) // da + 1)
                home = (-(-g.lo // da), -(-g.hi // da))
                foreign = self.group_of(recv[0] * da) \
                    if g.lo % da else None
                runs = tuple((max(g.lo, i * da) - g.lo,
                              min(g.hi, (i + 1) * da) - max(g.lo, i * da))
                             for i in range(*recv))
                out.append(GroupKeys(recv, home, foreign, runs))
            self._keys = out
        return self._keys

    def lane_sizes(self, per_shard: int) -> List[int]:
        """Rows of each group's block of a flat-shard-order operand."""
        return [g.n * per_shard for g in self.groups]

    def key_row_sizes(self, per_key_shard: int) -> List[int]:
        """Rows of each group's block of key-shard-order state (its home
        key shards)."""
        return [k.n_home * per_key_shard for k in self.key_groups()]

    def split(self, x, sizes: List[int]):
        """A global operand (tensor, numpy array or dict of them; rows in
        order) as the mesh's per-group operand: each group's ``sizes[g]``
        rows on its device (one group: the bare value on its device)."""
        if isinstance(x, dict):
            parts = {f: self.split(v, sizes) for f, v in x.items()}
            if self.n_groups == 1:
                return parts
            return [{f: p[g] for f, p in parts.items()}
                    for g in range(self.n_groups)]
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        out, off = [], 0
        for g, n in zip(self.groups, sizes):
            out.append(_to(x[off:off + n], g.device))
            off += n
        if off != x.shape[0]:
            raise ValueError(f"mesh split: {x.shape[0]} rows for groups of "
                             f"{sizes}")
        return out[0] if self.n_groups == 1 else out

    def join(self, xs, device=None):
        """A per-group operand as one tensor (or dict) on ``device``
        (default: the first group's), the groups' rows in order (one
        group: the bare value, where it is)."""
        if self.n_groups == 1:
            return xs
        dev = self.device if device is None else torch.device(device)
        if isinstance(xs[0], dict):
            return {f: self.join([x[f] for x in xs], dev) for f in xs[0]}
        return torch.cat([_to(x, dev) for x in xs])

    def __repr__(self) -> str:  # pragma: no cover
        return (f"KeyMesh(key={self.shape['key']}, "
                f"data={self.shape['data']}, ids={self.device_ids}, "
                f"groups={[(str(g.device), g.lo, g.hi) for g in self.groups]})")


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """``t`` on ``dev`` (itself when it is there already)."""
    if t.device == dev:
        return t
    if t.device.type == "cpu" and dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def _glist(mesh: KeyMesh, x) -> list:
    """A per-group operand as a list (one group: the bare value)."""
    return [x] if mesh.n_groups == 1 else list(x)


def _gout(mesh: KeyMesh, xs: list):
    return xs[0] if mesh.n_groups == 1 else xs


def _send(mesh: KeyMesh, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """Copy ``t`` into a fresh buffer on ``dev``: a peer copy between two
    cards (or a copy on one), ordered against both cards' current
    streams."""
    buf = torch.empty(t.shape, dtype=t.dtype, device=dev)
    buf.copy_(t, non_blocking=True)
    mesh.copied_bytes += t.numel() * t.element_size()
    return buf


def read_tensors(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One read-back per device of named tensors: each card's copies
    start (``gpu/batch.py:host_copies``, one event recorded on that
    card's current stream), then every event is waited on."""
    from ..gpu.batch import host_copies
    by_dev: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, t in tensors.items():
        by_dev.setdefault(str(t.device), {})[name] = t
    host, events = {}, []
    for card, sel in by_dev.items():
        dev = torch.device(card)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                h, ev = host_copies(sel)
        else:
            h, ev = host_copies(sel)
        host.update(h)
        if ev is not None:
            events.append(ev)
    for ev in events:
        ev.synchronize()
    return {name: host[name].numpy() for name in tensors}


def read_host(mesh: KeyMesh, named: Dict[str, object]
              ) -> Dict[str, np.ndarray]:
    """``read_tensors`` of per-group operands (``name -> operand``): one
    read-back per card, the groups' rows concatenated in order."""
    parts = {name: _glist(mesh, v) for name, v in named.items()}
    host = read_tensors({f"{n}|{g}": t for n, xs in parts.items()
                         for g, t in enumerate(xs)})
    out = {}
    for name, xs in parts.items():
        arrs = [host[f"{name}|{g}"] for g in range(len(xs))]
        out[name] = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
    return out


def pick(mesh: KeyMesh, xs, name: str):
    """Field ``name`` of a per-group operand of dicts."""
    return _gout(mesh, [x[name] for x in _glist(mesh, xs)])


def stage_lanes(mesh: KeyMesh, per_shard: int,
                cols: Dict[str, torch.Tensor], lo: int, m: int):
    """The per-group operand of one padded slice of device columns: rows
    ``[lo, lo + m)`` of ``cols``, padded with zeros to ``ns * per_shard``
    lanes and cut into the groups' lane blocks, each on its card (copied
    there from the columns' device)."""
    out = []
    for g in mesh.groups:
        a, n = g.lo * per_shard, g.n * per_shard
        mg = max(0, min(m - a, n))
        d = {}
        for f, col in cols.items():
            buf = torch.zeros((n,) + col.shape[1:], dtype=col.dtype,
                              device=g.device)
            buf[:mg] = col[lo + a:lo + a + mg]
            d[f] = buf
        out.append(d)
    return _gout(mesh, out)


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
        used = alive[:ka * da]
        return KeyMesh((ka, da), used, _group_labels(used))
    n_devices = max(1, min(int(n_devices), len(alive)))
    ka, da = n_devices, 1
    # prefer a 2D mesh when the device count allows it
    for cand in (2, 4):
        if n_devices % cand == 0 and n_devices // cand >= 2:
            da = cand
            ka = n_devices // cand
            break
    used = alive[:n_devices]
    return KeyMesh((ka, da), used, _group_labels(used))


def make_sharded_state(mesh: KeyMesh, n_keys: int, n_panes: int):
    """Per-key pane accumulators, key-sharded (one copy per key shard, on
    its home group: the ``'data'`` replicas are equal); zeros."""
    ka = mesh.shape["key"]
    k_local = math.ceil(n_keys / ka)
    states, counts = [], []
    for g, rows in zip(mesh.groups, mesh.key_row_sizes(k_local)):
        states.append(torch.zeros((rows, n_panes), dtype=torch.float32,
                                  device=g.device))
        counts.append(torch.zeros((rows, n_panes), dtype=torch.int32,
                                  device=g.device))
    return _gout(mesh, states), _gout(mesh, counts)


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


def _exchange_plan(mesh: KeyMesh, kind: str):
    """The block map of an ``all_to_all`` between groups: ``{(G, H):
    (src, dst)}``, ``src`` the block indices of group ``G``'s bucket
    tensor (on its card) that go to group ``H``, ``dst`` where they land
    in ``H``'s receive tensor (on its card). Blocks are ``C`` lanes.
    ``kind``: ``"key"`` (``(ns_G, ka)`` buckets by owner key shard,
    received as ``(ns_H, ka)`` in source key order), ``"flat"`` (``(ns_G,
    ns)`` buckets by owner shard, received as ``(ns_H, ns)`` in source
    shard order) or ``"back"`` (the flat one run backwards). Cached on
    the mesh."""
    plan = mesh._plans.get(kind)
    if plan is not None:
        return plan
    if kind == "back":
        fwd = _exchange_plan(mesh, "flat")
        plan = {(H, G): (d, s) for (G, H), (s, d) in fwd.items()}
        mesh._plans[kind] = plan
        return plan
    ka, da = mesh.shape["key"], mesh.shape["data"]
    ns = ka * da
    pairs: Dict[Tuple[int, int], Tuple[list, list]] = {}
    for r in range(ns):
        H = mesh.group_of(r)
        lo_h = mesh.groups[H].lo
        if kind == "key":
            d, j = divmod(r, da)
            srcs = [(i * da + j, i, d) for i in range(ka)]
            nb = ka
        else:
            srcs = [(s, s, r) for s in range(ns)]
            nb = ns
        for s, slot, b in srcs:
            G = mesh.group_of(s)
            src, dst = pairs.setdefault((G, H), ([], []))
            src.append((s - mesh.groups[G].lo) * nb + b)
            dst.append((r - lo_h) * nb + slot)
    plan = {(G, H): (torch.tensor(s, device=mesh.groups[G].device),
                     torch.tensor(d, device=mesh.groups[H].device))
            for (G, H), (s, d) in pairs.items()}
    mesh._plans[kind] = plan
    return plan


def _exchange(mesh: KeyMesh, kind: str, bufs: list, n_blocks: int) -> list:
    """Run an ``all_to_all`` between groups: ``bufs[G]`` is group ``G``'s
    ``(ns_G * n_blocks, C, ...)`` bucket tensor; returns each group's
    ``(ns_H * n_blocks, C, ...)`` receive tensor on its card. Per pair of
    groups: one gather on the sender, one copy into a buffer on the
    receiver's card (none within a group), one scatter there."""
    plan = _exchange_plan(mesh, kind)
    out = []
    for H, gh in enumerate(mesh.groups):
        o = torch.empty((gh.n * n_blocks,) + bufs[0].shape[1:],
                        dtype=bufs[0].dtype, device=gh.device)
        for G in range(mesh.n_groups):
            idx = plan.get((G, H))
            if idx is None:
                continue
            part = bufs[G][idx[0]]
            if G != H:
                part = _send(mesh, part, gh.device)
            o[idx[1]] = part
        out.append(o)
    return out


def _route_to_owners(mesh: KeyMesh, k_local: int, C: int, keys, panes,
                     vals):
    """The keyby shuffle of the key-sharded steps: bucket each shard's
    local tuples by owner key shard and ``all_to_all`` along ``'key'``.
    ``keys`` / ``panes`` / ``vals`` are each group's ``(ns_g * B,)``
    columns in shard order (one group: the global columns). Returns
    ``(keys, panes, vals, valid, local_key)``, each group's ``(ns_g, ka *
    C)`` planes, one row per receiving shard; key < 0 marks a padding
    lane, routed to key shard 0 and invalid there."""
    ka, da = mesh.shape["key"], mesh.shape["data"]
    ks, ps, vs = _glist(mesh, keys), _glist(mesh, panes), _glist(mesh, vals)
    cols: List[list] = []  # per group: [keys, panes, *vals] buckets
    for G, grp in enumerate(mesh.groups):
        dest = torch.clamp(torch.div(ks[G], k_local, rounding_mode="floor"),
                           0, ka - 1).reshape(grp.n, -1)
        order, flat, ok = _bucket_plan(dest, ka, C)
        cols.append([_bucketize(col, order, flat, ok, grp.n, ka, C, fill)
                     for col, fill in [(ks[G], -1), (ps[G], 0)]
                     + [(v, 0) for v in vs[G].values()]])
    if mesh.n_groups == 1:
        recv = [[_all_to_all_key(b, ka, da) for b in cols[0]]]
    else:
        recv = [[] for _ in mesh.groups]
        for c in range(len(cols[0])):
            bufs = [cg[c].reshape((-1, C) + cg[c].shape[3:]) for cg in cols]
            for H, o in enumerate(_exchange(mesh, "key", bufs, ka)):
                recv[H].append(o.reshape((mesh.groups[H].n, ka * C)
                                         + o.shape[2:]))
    fields = list(vs[0])
    out = ([], [], [], [], [])
    for G, grp in enumerate(mesh.groups):
        rk, rp = recv[G][0], recv[G][1]
        rv = dict(zip(fields, recv[G][2:]))
        valid = rk >= 0
        shard_key = (torch.arange(grp.lo, grp.hi, device=rk.device)
                     // da).unsqueeze(1)
        local_key = torch.where(valid, rk - shard_key * k_local, 0)
        for o, x in zip(out, (rk, rp, rv, valid, local_key)):
            o.append(x)
    return tuple(_gout(mesh, o) for o in out)


def _flat_buckets(n_src: int, ns: int, k_local: int, C: int, slots, aux,
                  vals):
    """One group's source side of the flat shuffle: its ``(n_src, ns,
    C)`` buckets of ``slots`` / ``aux`` / ``vals`` and its routing map
    ``(order, flat, ok)``."""
    dest = torch.clamp(torch.div(slots, k_local, rounding_mode="floor"),
                       0, ns - 1).reshape(n_src, -1)
    order, flat, ok = _bucket_plan(dest, ns, C)

    def b(col, fill):
        return _bucketize(col, order, flat, ok, n_src, ns, C, fill)

    return (b(slots, -1), b(aux, 0), {f: b(v, 0) for f, v in vals.items()},
            (order, flat, ok))


def _flat_recv(lo: int, hi: int, ns: int, k_local: int, C: int, rs):
    """``(valid, local_key)`` of the flattened lanes received by shards
    ``[lo, hi)``."""
    valid = rs >= 0
    shard = torch.arange(lo, hi, device=rs.device).repeat_interleave(ns * C)
    return valid, torch.where(valid, rs - shard * k_local, 0)


def _route_flat(ns: int, k_local: int, C: int, slots, aux, vals):
    """Bucket-by-owner + ``all_to_all`` over the flattened mesh of ONE
    group: the KEYBY shuffle of the sharded operators. ``slots`` are dense
    key slots (< 0 = padding lane, routed to shard 0 and dropped by the
    ``valid`` mask), ``aux`` is one int column that rides the shuffle
    (the global arrival position for scans), ``vals`` a dict of columns;
    all ``(ns * B,)`` in shard order. Returns ``(recv_slots, recv_aux,
    recv_vals, valid, local_key, order, flat, ok)``, the received planes
    flattened to ``(ns * ns * C,)`` in receiving-shard order (each
    shard's lanes in source-shard order, which is global arrival order);
    the last three are the source-side routing map ``_route_back``
    needs. ``_route_flat_groups`` is the same over the mesh's groups."""
    bs, ba, bv, maps = _flat_buckets(ns, ns, k_local, C, slots, aux, vals)

    def a2a(b):
        return _all_to_all(b).reshape((-1,) + b.shape[3:])

    rs, ra = a2a(bs), a2a(ba)
    rv = {f: a2a(v) for f, v in bv.items()}
    valid, local_key = _flat_recv(0, ns, ns, k_local, C, rs)
    return (rs, ra, rv, valid, local_key) + maps


def _route_flat_groups(mesh: KeyMesh, k_local: int, C: int, slots, aux,
                       vals):
    """``_route_flat`` over the mesh's groups: each group's received
    ``(ns_g * ns * C,)`` planes ``(slots, aux, vals, valid, local_key)``
    and its source-side routing map ``(order, flat, ok)`` (one group: the
    bare values, the stacked shuffle)."""
    ns = mesh.ns
    if mesh.n_groups == 1:
        out = _route_flat(ns, k_local, C, slots, aux, vals)
        return out[:5] + (out[5:],)
    ss, ax, vs = _glist(mesh, slots), _glist(mesh, aux), _glist(mesh, vals)
    src = [_flat_buckets(g.n, ns, k_local, C, ss[G], ax[G], vs[G])
           for G, g in enumerate(mesh.groups)]
    fields = list(vs[0])

    def a2a(pick):
        bufs = [pick(s) for s in src]
        bufs = [b.reshape((-1, C) + b.shape[3:]) for b in bufs]
        return [o.reshape((-1,) + o.shape[2:])
                for o in _exchange(mesh, "flat", bufs, ns)]

    rs = a2a(lambda s: s[0])
    ra = a2a(lambda s: s[1])
    rv_cols = {f: a2a(lambda s, f=f: s[2][f]) for f in fields}
    rv = [{f: rv_cols[f][G] for f in fields} for G in range(mesh.n_groups)]
    vl = [_flat_recv(g.lo, g.hi, ns, k_local, C, rs[G])
          for G, g in enumerate(mesh.groups)]
    return (rs, ra, rv, [v for v, _ in vl], [k for _, k in vl],
            [s[3] for s in src])


def _unbucket(ret: torch.Tensor, order, flat, ok, fill) -> torch.Tensor:
    """Per-source-lane values from a source shard's returned buckets
    (flattened), un-permuted to the original arrival positions."""
    picked = ret[flat]
    out = torch.full((order.shape[0],) + ret.shape[1:], fill,
                     dtype=ret.dtype, device=ret.device)
    out[order] = torch.where(
        ok.reshape((-1,) + (1,) * (ret.dim() - 1)), picked,
        torch.as_tensor(fill, dtype=ret.dtype, device=ret.device))
    return out


def _route_back(ns: int, C: int, routed: torch.Tensor, order, flat, ok,
                fill=0) -> torch.Tensor:
    """Inverse shuffle of ONE group: per-received-lane results (in the
    recv layout) return to their source shard (the all_to_all is its own
    inverse) and un-permute to the original arrival positions."""
    ret = _all_to_all(routed.reshape((ns, ns, C) + routed.shape[1:])) \
        .reshape((-1,) + routed.shape[1:])
    return _unbucket(ret, order, flat, ok, fill)


def _route_back_groups(mesh: KeyMesh, C: int, routed, maps, fill=0):
    """``_route_back`` over the mesh's groups: the flat exchange run
    backwards, then each source group un-permutes its lanes."""
    if mesh.n_groups == 1:
        return _route_back(mesh.ns, C, routed, *maps, fill=fill)
    bufs = [r.reshape((-1, C) + r.shape[1:]) for r in routed]
    rets = _exchange(mesh, "back", bufs, mesh.ns)
    return [_unbucket(r.reshape((-1,) + r.shape[2:]), *m, fill)
            for r, m in zip(rets, maps)]


# ---------------------------------------------------------------------------
# merges across groups
# ---------------------------------------------------------------------------
def _fold_runs(keys: GroupKeys, x: Dict[str, torch.Tensor], reduce
               ) -> Dict[str, torch.Tensor]:
    """Reduce a group's ``(ns_g, ...)`` per-shard planes over each run of
    data replicas: ``(n_recv, ...)``, one row per received key shard.
    ``reduce`` maps ``(n_runs, L, ...)`` dicts to ``(n_runs, ...)``."""
    runs = keys.runs
    L = runs[0][1]
    if all(n == L for _, n in runs):
        return reduce({f: v.reshape((len(runs), L) + v.shape[1:])
                       for f, v in x.items()})
    parts = [reduce({f: v[s:s + n].unsqueeze(0) for f, v in x.items()})
             for s, n in runs]
    return {f: torch.cat([p[f] for p in parts]) for f in x}


def _to_homes(mesh: KeyMesh, parts: List[Dict[str, torch.Tensor]],
              merge) -> List[Dict[str, torch.Tensor]]:
    """Per-received-key-shard rows of each group (``(n_recv, ...)``
    dicts) -> its home key shards' rows: a group's foreign row goes to
    its home's card, which merges the rows it receives after its own, in
    group order (``merge(own, [incoming])``, each a one-row dict)."""
    keys = mesh.key_groups()
    out = list(parts)
    incoming: Dict[int, list] = {}
    for G, k in enumerate(keys):
        if k.foreign_home is None:
            continue
        H = k.foreign_home
        dev = mesh.groups[H].device
        incoming.setdefault(H, []).append(
            {f: _send(mesh, v[:1], dev) for f, v in parts[G].items()})
        out[G] = {f: v[1:] for f, v in parts[G].items()}
    for H, ins in incoming.items():
        own = {f: v[-1:] for f, v in out[H].items()}
        merged = merge(own, ins)
        out[H] = {f: torch.cat([v[:-1], merged[f]]) for f, v in out[H].items()}
    return out


def _with_foreign(mesh: KeyMesh, homes: list, per_key_shard: int) -> list:
    """Each group's home rows (``(n_home * per_key_shard, ...)``) with its
    foreign key shard's rows, copied from their home's card, ahead: the
    rows of every key shard the group receives for."""
    keys = mesh.key_groups()
    out = []
    for G, k in enumerate(keys):
        if k.foreign_home is None:
            out.append(homes[G])
            continue
        H = k.foreign_home
        r0 = (k.recv[0] - keys[H].home[0]) * per_key_shard
        rows = _send(mesh, homes[H][r0:r0 + per_key_shard],
                     mesh.groups[G].device)
        out.append(torch.cat([rows, homes[G]]))
    return out


def _sum_axis1(x):
    return {f: v.sum(1) for f, v in x.items()}


def _sum_rows(own, ins):
    return {f: own[f] + sum(i[f] for i in ins) for f in own}


def _max_rows(own, ins):
    out = {}
    for f in own:
        m = own[f]
        for i in ins:
            m = torch.maximum(m, i[f])
        out[f] = m
    return out


# the validity plane's key in a dict of delta planes (no field name of a
# lift starts with a NUL)
_VALID = "\0valid"


def _butterfly(combine, valid: torch.Tensor, leaves: Dict[str, torch.Tensor]):
    """The ``'data'`` butterfly in replica 0's combine order, over axis 1
    of ``(R, L, n)`` planes: pairs of adjacent indices, then pairs of
    pairs (an odd last one rides up a level). Returns ``(R, n)``."""
    while valid.shape[1] > 1:
        n = valid.shape[1]
        e = n - n % 2
        v, lv = comb_valid(
            combine, valid[:, 0:e:2], {k: x[:, 0:e:2]
                                       for k, x in leaves.items()},
            valid[:, 1:e:2], {k: x[:, 1:e:2] for k, x in leaves.items()})
        if n % 2:
            v = torch.cat([v, valid[:, e:]], 1)
            lv = {k: torch.cat([x, leaves[k][:, e:]], 1)
                  for k, x in lv.items()}
        valid, leaves = v, lv
    return valid[:, 0], {k: x[:, 0] for k, x in leaves.items()}


# ---------------------------------------------------------------------------
# the key-sharded steps
# ---------------------------------------------------------------------------
def sharded_keyby_window_step(mesh: KeyMesh, n_keys: int, n_panes: int,
                              local_batch: int):
    """``(step, n_keys_padded, global_batch)``: ``step(state, counts, keys,
    values, panes) -> (state', counts', n_tuples)`` over each group's
    ``(ns_g * local_batch,)`` columns in shard order (one group: the
    global columns). Tuples route to their key-owner shard, each shard
    folds its received tuples into a DELTA, and the deltas of the
    ``'data'`` replicas sum (the ``psum``) into the pane accumulators of
    the key shard's home; ``n_tuples`` is each group's count. Float sums
    group by shard: within the stated tolerance of the JAX package's,
    not bit-equal."""
    ka, da = mesh.shape["key"], mesh.shape["data"]
    n_keys_padded = math.ceil(n_keys / ka) * ka
    k_local = n_keys_padded // ka
    C = local_batch
    keys_g = mesh.key_groups()

    def step(state, counts, keys, values, panes):
        vals = _gout(mesh, [{"v": v} for v in _glist(mesh, values)])
        rk, rp, rv, valid, lkey = (_glist(mesh, x) for x in _route_to_owners(
            mesh, k_local, C, keys, panes, vals))
        sts, cns = _glist(mesh, state), _glist(mesh, counts)
        cells = k_local * n_panes
        parts = []
        for G, grp in enumerate(mesh.groups):
            ok = valid[G]
            pane_idx = torch.where(ok, torch.remainder(rp[G], n_panes), 0)
            shard = torch.arange(grp.n, device=ok.device).unsqueeze(1)
            idx = torch.where(ok, shard * cells + lkey[G] * n_panes
                              + pane_idx, grp.n * cells)
            delta = torch.zeros(grp.n * cells + 1, dtype=sts[G].dtype,
                                device=sts[G].device)
            delta.index_put_((idx.reshape(-1),),
                             torch.where(ok, rv[G]["v"], 0).reshape(-1)
                             .to(sts[G].dtype), accumulate=True)
            dcount = torch.zeros(grp.n * cells + 1, dtype=cns[G].dtype,
                                 device=cns[G].device)
            dcount.index_put_((idx.reshape(-1),),
                              ok.reshape(-1).to(cns[G].dtype),
                              accumulate=True)
            # psum over 'data': the data replicas' deltas of each key shard
            parts.append(_fold_runs(keys_g[G], {
                "d": delta[:-1].reshape(grp.n, cells),
                "c": dcount[:-1].reshape(grp.n, cells)}, _sum_axis1))
        if mesh.n_groups > 1:
            parts = _to_homes(mesh, parts, _sum_rows)
        sts = [s + p["d"].reshape(s.shape) for s, p in zip(sts, parts)]
        cns = [c + p["c"].reshape(c.shape) for c, p in zip(cns, parts)]
        return (_gout(mesh, sts), _gout(mesh, cns),
                _gout(mesh, [v.sum() for v in valid]))

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
    lateness rule -> per-shard segmented fold by (key, pane) merged into
    one zeroed DELTA forest per shard (``kernels.ffat_step.ingest_fold``: K2+K3
    on a card, its plain version on the CPU) -> the butterfly
    merge of the ``'data'`` replicas' deltas (replica 0's combine order:
    pairs of adjacent data indices, then pairs of pairs; a key shard's
    replicas on other groups merge there first and their partials travel
    to its home) -> the merged delta folds into the leaves -> level
    rebuild of the key rows of each group in ONE call of
    ``kernels.forest_rebuild`` per group that holds forest rows (K1 on a
    card, its plain version on the CPU; ``on_rebuild`` is called after
    each) -> ``fire_rounds`` fire rounds on the same card (window queries
    of every key row, ``kernels.ffat_step.fire_query``: K4 on a card with
    no eviction list, results into column ``r``, then the eviction of the
    panes sliding out as a mask over the forest).

    The JAX step skips the rebuild (``lax.cond``) when no key can fire;
    knowing that on the host would cost a read-back per step, so the port
    rebuilds every step. Internal levels are only read by the step's own
    fire rounds, so the results are the same.

    Returns ``(init_fn, step_fn, meta)``: ``init_fn(sample_vals)`` the
    5-tuple state ``(trees, tvalid, next_fire, max_leaf, fired)`` (trees
    a dict of ``(K_g, 2F)`` tensors, the control state ``(K_g,)`` int32,
    per group: its home key rows; one group: ``K_g = K_pad``);
    ``step_fn(*state, keys, values, panes, frontier)`` the flat 10-tuple
    ``(trees, tvalid, next_fire, max_leaf, fired, results, res_valid,
    res_wid, n_tuples, n_late)``, results ``(K_g, fire_rounds)`` per lift
    field, the counters per group; ``meta = (K_pad, k_local,
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
    # through this same construction path; a group's planes hold whole
    # key shards, so the guard per shard holds per group
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
    keys_g = mesh.key_groups()
    rows_g = mesh.key_row_sizes(k_local)

    def butterfly(x):
        v, lv = _butterfly(combine, x[_VALID],
                           {k: t for k, t in x.items() if k != _VALID})
        return {_VALID: v, **lv}

    def merge_partials(own, ins):
        # the home's partial first, then the later groups', paired as the
        # butterfly pairs data indices
        rows = [own] + ins
        return butterfly({k: torch.stack([r[k][0] for r in rows])
                          .unsqueeze(0) for k in own})

    def step(trees, tvalid, next_fire, max_leaf, fired, keys, raw_vals,
             panes, frontier):
        frontier = int(frontier)
        trees, tvalid = _glist(mesh, trees), _glist(mesh, tvalid)
        next_fire, max_leaf = _glist(mesh, next_fire), _glist(mesh, max_leaf)
        fired = _glist(mesh, fired)
        # ---- fast-forward DRAINED keys past the frontier ----------------
        first_unfireable = max(
            0, ((frontier - win_panes) // slide_panes + 1) * slide_panes)
        for G in range(mesh.n_groups):
            ff = (max_leaf[G] < next_fire[G]) \
                & (next_fire[G] < first_unfireable)
            next_fire[G] = torch.where(ff, first_unfireable, next_fire[G]) \
                .to(torch.int32)
            fired[G] = torch.where(ff, first_unfireable // slide_panes,
                                   fired[G]).to(torch.int32)

        # ---- route tuples to their key-owner shard ---------------------
        routed = [_glist(mesh, x) for x in _route_to_owners(
            mesh, k_local, C, keys, panes, raw_vals)]
        nf_recv = next_fire if mesh.n_groups == 1 \
            else _with_foreign(mesh, next_fire, k_local)
        parts, ml_parts, n_valid, n_lates = [], [], [], []
        for G, grp in enumerate(mesh.groups):
            dev = grp.device
            kg = keys_g[G]
            row0 = kg.recv[0] * k_local  # first received key row
            rk, rp, rv, valid, lkey = (x[G] for x in routed)
            rk, rp, valid, lkey = (t.reshape(-1)
                                   for t in (rk, rp, valid, lkey))
            rv = {f: v.reshape((-1,) + v.shape[2:]) for f, v in rv.items()}
            rkl = rk - row0 if row0 else rk
            gkey = torch.where(valid, rkl, 0)
            nf_t = nf_recv[G][gkey]
            late_bound = nf_t
            if LATE_OFF:
                late_bound = nf_t + torch.where(nf_t > 0, LATE_OFF, 0)
            late = valid & (rp < late_bound)
            valid = valid & ~late
            n_lates.append(late.sum())

            # ---- per-shard segmented fold by (key, pane) ---------------
            L = rk.shape[0]
            vals = broadcast_scalar_fields(lift(rv), L, dev)
            leaf = torch.where(valid, torch.remainder(rp, F), 0)
            shard = torch.arange(grp.n, device=dev) \
                .repeat_interleave(L // grp.n)
            row = shard * k_local + lkey  # the shard's own forest row
            big = grp.n * k_local * F
            composite = torch.where(valid, row * F + leaf, big) \
                .to(torch.int32)
            sorted_rows = sort_rows(composite)
            # each run's fold goes into a DELTA forest per shard (each data
            # replica received a disjoint tuple subset): K2+K3 merging
            # into zeroed leaves, where a fold lands as it is
            OOB = grp.n * k_local * NNODES
            dflat = {k: torch.zeros(OOB, dtype=v.dtype, device=dev)
                     for k, v in vals.items()}
            dvalid = torch.zeros(OOB, dtype=torch.bool, device=dev)
            ingest_fold(combine, {k: v.contiguous() for k, v in vals.items()},
                        sorted_rows, dflat, dvalid, F)
            delta = {k: b.reshape(grp.n, k_local * NNODES)
                     for k, b in dflat.items()}
            delta[_VALID] = dvalid.reshape(grp.n, k_local * NNODES)
            # the butterfly over 'data' (ppermute with partner j ^ shift),
            # in the combine order of replica 0, whose rows every replica
            # holds: first over the replicas on this group's card
            parts.append(_fold_runs(kg, delta, butterfly))
            # per-key max pane of the received key rows (the pmax over
            # 'data' is the one scatter, then the merge at the home)
            n_rows = (kg.recv[1] - kg.recv[0]) * k_local
            if kg.foreign_home is None:
                ml = torch.cat([max_leaf[G], max_leaf[G].new_full((1,), -1)])
            else:
                ml = torch.full((n_rows + 1,), -1, dtype=torch.int32,
                                device=dev)
                ml[k_local:n_rows] = max_leaf[G]
            ml = ml.scatter_reduce(
                0, torch.where(valid, rkl, n_rows).to(torch.int64),
                torch.where(valid, rp, -1).to(ml.dtype), reduce="amax")
            ml_parts.append({"ml": ml[:n_rows].reshape(-1, k_local)})
            n_valid.append(valid.sum())
        if mesh.n_groups > 1:
            parts = _to_homes(mesh, parts, merge_partials)
            ml_parts = _to_homes(mesh, ml_parts, _max_rows)

        res_out = {"res": [], "valid": [], "wid": []}
        for G, grp in enumerate(mesh.groups):
            dev = grp.device
            K_g = rows_g[G]
            dvalid = parts[G][_VALID].reshape(-1)
            dleaf = {k: v.reshape(-1) for k, v in parts[G].items()
                     if k != _VALID}
            max_leaf[G] = ml_parts[G]["ml"].reshape(-1).contiguous()
            # fold the merged delta into the state leaves
            tflat = {k: t.reshape(-1) for k, t in trees[G].items()}
            vflat = tvalid[G].reshape(-1)
            leaf_valid = vflat & dvalid
            merged_all = combine(tflat, dleaf)
            trees[G] = {k: torch.where(dvalid, torch.where(
                leaf_valid, merged_all[k], dleaf[k]), t)
                .reshape(K_g, NNODES) for k, t in tflat.items()}
            tvalid[G] = (vflat | dvalid).reshape(K_g, NNODES)

            # ---- level rebuild of the group's key rows (K1) ------------
            if K_g:
                trees[G], tvalid[G] = forest_rebuild(trees[G], tvalid[G],
                                                     combine)
                if on_rebuild is not None:
                    on_rebuild()

            # ---- fire rounds -------------------------------------------
            nf, mlg, fd = next_fire[G], max_leaf[G], fired[G]
            tflat = {k: t.reshape(-1) for k, t in trees[G].items()}
            base = torch.arange(K_g, device=dev) * NNODES
            res = {k: torch.zeros((K_g, fire_rounds), dtype=t.dtype,
                                  device=dev) for k, t in trees[G].items()}
            res_valid = torch.zeros((K_g, fire_rounds), dtype=torch.bool,
                                    device=dev)
            res_wid = torch.zeros((K_g, fire_rounds), dtype=torch.int32,
                                  device=dev)
            evict = torch.arange(slide_panes, device=dev).unsqueeze(0)
            m = K_g * NNODES
            tv = tvalid[G]
            rows = torch.arange(K_g, dtype=torch.int32, device=dev)
            lanes = lane_blocks(K_g, dev)
            for r in range(fire_rounds):
                vflat = tv.reshape(-1)
                eligible = (nf + win_panes <= frontier) & (mlg >= nf)
                start = nf
                length = torch.where(
                    eligible, torch.clamp(mlg + 1 - start, max=win_panes),
                    0)
                # K4 over one lane a key row, with no eviction: the
                # round's eviction follows as a mask over the whole forest
                f_pack = torch.stack([rows, torch.remainder(start, F),
                                      length, torch.zeros_like(rows),
                                      eligible.to(torch.int32)]) \
                    .to(torch.int32)
                qr, qv, _ = fire_query(combine, tflat, vflat, F, f_pack,
                                       blocks=lanes)
                for k in res:
                    res[k][:, r] = torch.where(qv, qr[k], 0).to(res[k].dtype)
                res_valid[:, r] = qv
                res_wid[:, r] = torch.where(eligible, fd, -1)
                # evict the panes sliding out of every fired key
                ev = start.unsqueeze(1) + evict
                ev_ok = eligible.unsqueeze(1) & (ev <= mlg.unsqueeze(1))
                eflat = torch.where(ev_ok, base.unsqueeze(1) + F
                                    + torch.remainder(ev, F), m)
                kill = torch.zeros(m + 1, dtype=torch.bool, device=dev)
                kill[eflat.reshape(-1)] = True
                tv = tv & ~kill[:m].reshape(K_g, NNODES)
                nf = torch.where(eligible, nf + slide_panes, nf) \
                    .to(torch.int32)
                fd = torch.where(eligible, fd + 1, fd).to(torch.int32)
            tvalid[G], next_fire[G], fired[G] = tv, nf, fd
            res_out["res"].append(res)
            res_out["valid"].append(res_valid)
            res_out["wid"].append(res_wid)
        return tuple(_gout(mesh, x) for x in (
            trees, tvalid, next_fire, max_leaf, fired, res_out["res"],
            res_out["valid"], res_out["wid"], n_valid, n_lates))

    def init_fn(sample_vals):
        """``sample_vals``: dict of one-row columns (numpy or torch) with
        the RAW tuple dtypes (pre-lift)."""
        dev0 = mesh.device
        one = {k: torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(dev0) for k, v in sample_vals.items()}
        shapes = broadcast_scalar_fields(lift(one), 1, dev0)
        out = ([], [], [], [], [])
        for grp, K_g in zip(mesh.groups, rows_g):
            dev = grp.device
            out[0].append({name: torch.zeros((K_g, NNODES), dtype=s.dtype,
                                             device=dev)
                           for name, s in shapes.items()})
            out[1].append(torch.zeros((K_g, NNODES), dtype=torch.bool,
                                      device=dev))
            out[2].append(torch.zeros(K_g, dtype=torch.int32, device=dev))
            out[3].append(torch.full((K_g,), -1, dtype=torch.int32,
                                     device=dev))
            out[4].append(torch.zeros(K_g, dtype=torch.int32, device=dev))
            # K2+K3's status words for the group's routed rows, made here
            # rather than in a step
            reserve_ingest_scratch(dev, grp.n * ka * C)
        return tuple(_gout(mesh, x) for x in out)

    return init_fn, step, (K_pad, k_local, ns * local_batch)


def ring_pane_window_query(mesh: KeyMesh, n_panes_global: int,
                           win_panes: int, slide_panes: int):
    """Sliding-window sums over a PANE-SHARDED timeline: the pane axis is
    block-sharded over ``'key'`` (each key shard's block on its home
    group), a shard owns the windows STARTING in its slice, and receives
    the head of its right neighbour (the ``ppermute`` ring exchange: a
    roll of the stacked heads within a group, a copy from the next group
    that holds blocks for a group's last one). Returns ``(fn,
    n_windows)``; ``fn(pane_partials)`` takes each group's ``(n_home *
    P_local,)`` panes (one group: the ``(P_global,)`` timeline) and
    returns ``window_sums[W_global]`` on the first group's card, window
    w = sum of panes [w*slide, w*slide+win)."""
    n_shards = mesh.shape["key"]
    if n_panes_global % n_shards:
        raise ValueError("n_panes_global must divide the key axis")
    p_local = n_panes_global // n_shards
    halo = win_panes - 1
    if halo > p_local:
        raise ValueError("window span exceeds one shard + halo; increase "
                         "panes per shard")
    n_windows = (n_panes_global - win_panes) // slide_panes + 1
    keys_g = mesh.key_groups()
    holders = [G for G, k in enumerate(keys_g) if k.n_home]

    def fn(panes) -> torch.Tensor:
        ps = _glist(mesh, panes)
        local = {G: ps[G].reshape(keys_g[G].n_home, p_local)
                 for G in holders}
        outs = []
        for n, G in enumerate(holders):
            dev = ps[G].device
            loc = local[G]
            # shard i receives shard i+1's head (ring: the last wraps to 0)
            nxt = holders[(n + 1) % len(holders)]
            if nxt == G:
                right_head = torch.roll(loc[:, :halo], -1, dims=0)
            else:
                right_head = torch.cat([loc[1:, :halo], _send(
                    mesh, local[nxt][:1, :halo], dev)])
            ext = torch.cat([loc, right_head], dim=1)  # (n, p_local + halo)
            shard = torch.arange(*keys_g[G].home, device=dev).unsqueeze(1)
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
                .to(ps[G].dtype)
            # each window is produced by exactly one shard: the psum
            # assembles the dense global window vector
            out = torch.zeros(n_windows, dtype=ps[G].dtype, device=dev)
            out.index_put_((torch.clamp(w_ids, 0, n_windows - 1)
                            .reshape(-1),),
                           torch.where(valid, sums, 0).reshape(-1),
                           accumulate=True)
            outs.append(out)
        total = outs[0]
        for o in outs[1:]:
            total = total + _send(mesh, o, total.device)
        return total

    return fn, n_windows


# ---------------------------------------------------------------------------
# flat-owner plane: the sharded Map/Filter/Reduce
# ---------------------------------------------------------------------------
# A grid-scan state transition is SEQUENTIAL per key, so no cross-replica
# merge exists: every tuple of a key lands on ONE shard. The sharded
# Map/Filter/Reduce block-shard the slot space over the FLATTENED
# ('key', 'data') shard order (ns = ka*da shards); the mesh shape stays a
# pure layout choice, which is what makes 8x1 / 4x2 / 2x4 results equal.
# Each group holds the rows of its own shards.

def mesh_shard_count(mesh: KeyMesh) -> int:
    """Shards of the flat-owner plane: every shard of the mesh."""
    return mesh.shape["key"] * mesh.shape["data"]


def make_mesh_table(mesh: KeyMesh, state_init, K_pad: int):
    """Per-key state table of the flat-owner plane: each group's pytree
    of ``(K_g + 1,)`` tensors on its card (``K_g = ns_g * K_pad / ns``)
    filled with the ``state_init`` leaves (int64 / float64 become int32 /
    float32), its shards' row blocks stacked and one trailing scratch row
    (the keyed scan's target of the padding lanes,
    ``kernels/grid_scan.py:grid_scan_core``)."""
    leaves, spec = tree_flatten(state_init)
    k_local = K_pad // mesh.ns
    init = []
    for v in leaves:
        t = canonical(torch.as_tensor(v).detach().cpu())
        if t.dim():
            raise WindFlowError("mesh: state leaves must be scalars (one "
                                "value per key)")
        init.append(t)
    tables = [tree_unflatten(spec, [
        torch.empty(g.n * k_local + 1, dtype=t.dtype,
                    device=g.device).fill_(t) for t in init])
        for g in mesh.groups]
    return _gout(mesh, tables)


INT32_MAX = 2**31 - 1


def received_rows(gslot: torch.Tensor, n_keys: int, heavy_rows: int,
                  keys: Optional[torch.Tensor]):
    """``(order, starts, heavy)`` of ``KeyRows`` built on the device from
    one group's received lanes, with no host sync: ``gslot`` (int64) each
    lane's group-local key slot, ``n_keys`` for an invalid lane. A stable
    ``torch.sort`` of the slots (the received layout is global arrival
    order, so each key's lanes stay in arrival order; the invalid lanes
    sort last) and the starts from the counts, both int32; ``heavy`` the
    list of the kernel's block regime: entry k is key k (``keys``, the
    group's int32 key indices) where it received ``heavy_rows`` lanes or
    more, else -1 (``heavy_keys_device``), or None where ``keys`` is
    None."""
    order = torch.sort(gslot, stable=True).indices.to(torch.int32)
    cnt = torch.bincount(gslot, minlength=n_keys + 1)[:n_keys]
    starts = torch.zeros(n_keys + 1, dtype=torch.int32, device=gslot.device)
    starts[1:] = torch.cumsum(cnt, 0)
    heavy = (None if keys is None
             else heavy_keys_device(cnt, heavy_rows, keys))
    return order, starts, heavy


def sharded_grid_scan(mesh: KeyMesh, func, filter_mode: bool,
                      key_capacity: int, M: Optional[int],
                      local_batch: int):
    """Mesh-sharded keyed grid scan: the device core of the sharded
    stateful Map/Filter. One step per batch slice: bucket-by-owner +
    ``all_to_all`` over the flat shard order (the table never moves) ->
    on each group, its received lanes grouped by key on the device, its
    heavy keys listed there (``received_rows``) -> the keyed scan of
    ``kernels/grid_scan.py`` over its stacked shards' row blocks (``K_g``
    keys: K8's kernel on the group's card, on that card's current stream;
    the plain version ``grid_scan_core`` on a CPU group, ``M`` positions,
    or with ``M`` None the power of two at or above the most rows a key
    of the group received) -> the inverse ``all_to_all`` returns outputs to arrival
    order. The plain version's grid cells are int32: with ``M`` given, a
    mesh with a CPU group whose ``K_g * M`` grid leaves no scratch cell
    inside int32 refuses here (the kernel indexes rows and takes it).

    Returns ``(step, meta)``: ``step(table, slots, gpos, vals) -> (table,
    out, n_tuples)`` over each group's operands (one group: the global
    ones; the table, ``make_mesh_table``'s, updated in place), ``out``
    the per-row output columns (map) or keep mask (filter) in arrival
    order, ``n_tuples`` per group; ``meta = (K_pad, k_local, GB)``."""
    ns = mesh_shard_count(mesh)
    K_pad = math.ceil(key_capacity / ns) * ns
    k_local = K_pad // ns
    C = local_batch
    GB = ns * local_batch
    plain = [g for g in mesh.groups if g.device.type != "cuda"]
    K_max = max((g.n for g in plain), default=0) * k_local
    if M is not None and K_max * M + 1 > INT32_MAX:
        raise WindFlowError(
            f"sharded_grid_scan: the grid is K_pad={K_max} keys x M={M} "
            f"positions = {K_max * M} cells, beyond int32 cell indices; "
            "use smaller batches (M is the most rows of one key)")
    gstep = GridStep(func, filter_mode)
    # the block regime: a slice holds at most GB real rows, so at most
    # GB // HEAVY_ROWS heavy keys, and no more blocks than that; none
    # where the host's M says no key is heavy
    bound = 0 if M is not None and M < HEAVY_ROWS else GB // HEAVY_ROWS
    aux = []
    for g in mesh.groups:
        K_g = g.n * k_local
        aux.append((K_g, g.lo * k_local,
                    torch.arange(K_g, dtype=torch.int32, device=g.device),
                    torch.zeros(K_g + 1, dtype=torch.bool, device=g.device)))

    def step(table, slots, gpos, vals):
        rs, _rg, rv, valid, _lkey, maps = (
            _glist(mesh, x) for x in _route_flat_groups(
                mesh, k_local, C, slots, gpos, vals))
        tables = _glist(mesh, table)
        outs = []
        for G, (K_g, off, touched, dirty) in enumerate(aux):
            ok = valid[G]
            # the group's slot is the owner shard's row block offset + the
            # local key; every key of the group is touched
            gslot = torch.where(ok, rs[G] - off if off else rs[G], K_g) \
                .to(torch.int64)
            # touched is 0..K_g-1: the heavy list's key indices too
            order, starts, heavy = received_rows(
                gslot, K_g, HEAVY_ROWS, touched if bound else None)
            rows = KeyRows(order, starts, touched, K_g, M, None, heavy,
                           min(K_g, bound, MAX_HEAVY_BLOCKS), HEAVY_ROWS)
            outs.append(grid_walk(gstep, rv[G], ok, rows, tables[G], dirty))
        if filter_mode:
            ret = _route_back_groups(
                mesh, C, _gout(mesh, [o.to(torch.int8) for o in outs]),
                _gout(mesh, maps))
            ret = _gout(mesh, [r.to(torch.bool) for r in _glist(mesh, ret)])
        else:
            cols = {f: _route_back_groups(
                mesh, C, _gout(mesh, [o[f] for o in outs]), _gout(mesh, maps))
                for f in outs[0]}
            ret = _gout(mesh, [{f: _glist(mesh, c)[G]
                                for f, c in cols.items()}
                               for G in range(mesh.n_groups)])
        return table, ret, _gout(mesh, [v.sum() for v in valid])

    return step, (K_pad, k_local, GB)


def sharded_keyed_reduce(mesh: KeyMesh, combine, key_capacity: int,
                         local_batch: int):
    """Mesh-sharded keyed Reduce: per-batch ``reduce_by_key`` with the
    KEYBY shuffle as the flat-owner ``all_to_all`` and the combine folding
    each slot's rows on its owner shard (stacked, one fold over each
    group's received lanes sorted by slot: K7, ``kernels/reduce_fold.py``
    ``keyed_fold``, with the group's slot count as the sentinel of the
    invalid lanes and each slot's first sorted lane from one
    ``searchsorted`` of the sorted slots, with no host sync, on the group
    device's current stream). Fields the combine does not return pass
    through unchanged.

    Returns ``(step, meta)``: ``step(slots, vals) -> (res, touched,
    n_tuples)`` over each group's operands (one group: the global ones),
    ``res`` mapping each field to a ``(K_g,)`` tensor of per-slot results
    of the group's rows (computed fields zero where untouched),
    ``touched`` the ``(K_g,)`` mask of slots the batch touched; ``meta =
    (K_pad, k_local, GB)``."""
    ns = mesh_shard_count(mesh)
    K_pad = math.ceil(key_capacity / ns) * ns
    k_local = K_pad // ns
    C = local_batch
    GB = ns * local_batch
    if K_pad + 1 > INT32_MAX:
        raise WindFlowError(f"sharded_keyed_reduce: {K_pad} slots overflow "
                            "the int32 slot index")
    # each group's slots 0..K_g, which its starts are searched for
    slot_ids = [torch.arange(grp.n * k_local + 1, dtype=torch.int32,
                             device=grp.device) for grp in mesh.groups]

    def step(slots, vals):
        routed = _route_flat_groups(mesh, k_local, C, slots, slots, vals)
        rs, rv, valid = (_glist(mesh, routed[i]) for i in (0, 2, 3))
        res_g, touched_g = [], []
        for G, grp in enumerate(mesh.groups):
            K_g, off = grp.n * k_local, grp.lo * k_local
            gslot = torch.where(valid[G], rs[G] - off if off else rs[G],
                                K_g).to(torch.int32)
            order, sl = sort_rows(gslot)  # arrival order within a slot
            res, touched = keyed_fold(
                combine, rv[G], order, sl, K_g,
                starts=run_starts(sl, K_g, slot_ids[G]))
            res_g.append(res)
            touched_g.append(touched)
        return (_gout(mesh, res_g), _gout(mesh, touched_g),
                _gout(mesh, [v.sum() for v in valid]))

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


def host_tree(mesh: KeyMesh, table):
    """The table's rows (no scratch rows) as host numpy, tree order: one
    read-back per card, the groups' rows in order."""
    tables = _glist(mesh, table)
    spec = tree_flatten(tables[0])[1]
    leaves = [tree_flatten(t)[0] for t in tables]
    host = read_host(mesh, {str(i): _gout(mesh, [lv[i][:-1]
                                                 for lv in leaves])
                            for i in range(len(leaves[0]))})
    return tree_unflatten(spec, [host[str(i)].copy()
                                 for i in range(len(leaves[0]))])


def _table_rows(mesh: KeyMesh, k_local: int, slots: np.ndarray):
    """``[(group, local rows, positions)]`` of flat-owner table ``slots``:
    the groups owning them, each group's local row indices and the
    positions of those slots in ``slots``."""
    slots = np.asarray(slots, np.int64)
    group = mesh._group_of[slots // k_local]
    out = []
    for G, g in enumerate(mesh.groups):
        pos = np.nonzero(group == G)[0]
        if len(pos):
            out.append((G, slots[pos] - g.lo * k_local, pos))
    return out


def gather_rows(mesh: KeyMesh, table, k_local: int, slots) -> list:
    """Rows ``slots`` (non-empty) of a flat-owner table as host numpy,
    one array per leaf in tree order: one gather per leaf on each owning
    group, one read-back per card."""
    from ..gpu.batch import to_device
    tables = _glist(mesh, table)
    named, where = {}, []
    for G, rows, pos in _table_rows(mesh, k_local, slots):
        idx = to_device(rows.copy(), mesh.groups[G].device)
        for i, lf in enumerate(tree_flatten(tables[G])[0]):
            named[f"{i}|{G}"] = lf[idx]
        where.append((G, pos))
    host = read_tensors(named)
    out = []
    for i in range(len(tree_flatten(tables[0])[0])):
        parts = [(pos, host[f"{i}|{G}"]) for G, pos in where]
        a = np.empty(len(slots), parts[0][1].dtype)
        for pos, h in parts:
            a[pos] = h
        out.append(a)
    return out


def scatter_rows(mesh: KeyMesh, table, k_local: int, slots, cols) -> None:
    """Write host columns ``cols`` (one per leaf, tree order) into rows
    ``slots`` of a flat-owner table: one scatter per leaf on each owning
    group."""
    from ..gpu.batch import to_device
    tables = _glist(mesh, table)
    for G, rows, pos in _table_rows(mesh, k_local, slots):
        dev = mesh.groups[G].device
        idx = to_device(rows.copy(), dev)
        for lf, col in zip(tree_flatten(tables[G])[0], cols):
            lf[idx] = to_device(np.ascontiguousarray(col[pos]), dev) \
                .to(lf.dtype)


def write_rows(mesh: KeyMesh, table, k_local: int, arrays) -> None:
    """Copy host leaves ``arrays`` (tree order, rows in slot order) into a
    flat-owner table from row 0: each group takes its own rows (rows
    past the arrays keep their values)."""
    tables = _glist(mesh, table)
    for g, t in zip(mesh.groups, tables):
        lo, n = g.lo * k_local, g.n * k_local
        for lf, a in zip(tree_flatten(t)[0], arrays):
            a = np.asarray(a)
            r = max(0, min(a.shape[0] - lo, n))
            lf[:r] = canonical(torch.from_numpy(
                np.ascontiguousarray(a[lo:lo + r]))).to(lf.device)


__all__ = [
    "DEFAULT_VIRTUAL_DEVICES", "GroupKeys", "KeyMesh", "MESH_AXES",
    "MeshGroup", "default_ring_panes", "ensure_virtual_devices",
    "excluded_device_ids", "healthy_devices", "make_key_mesh",
    "make_mesh_table", "make_sharded_state", "mesh_occupancy",
    "mesh_shard_count", "read_host", "read_tensors",
    "ring_pane_window_query",
    "set_excluded_devices", "sharded_ffat_forest", "sharded_grid_scan",
    "sharded_keyby_window_step", "sharded_keyed_reduce",
    "virtual_device_count", "virtual_device_groups", "visible_devices",
]
