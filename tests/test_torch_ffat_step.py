"""The FFAT step's device programs (``windflow_tpu_torch/kernels/ffat_step``)
held against the JAX package's step on the CPU.

The same numpy inputs, made from a seed, go through
``windflow_tpu/tpu/ffat_tpu.py``'s ``_make_step`` (ingest-only and full) and
``_make_fire_step`` and through the port's plain versions of K2+K3
(``ingest_fold``: the segmented fold with the leaf merge) and K4
(``fire_query``: the window query with eviction), with K1's plain rebuild
between them in the full step. The whole forest is compared: every plane
where valid, validity (evicted leaves included), and each fired window's
values, validity, wid and key. Combines: a fieldwise int32 sum and the
traced ``ysb_last`` and ``mean_last`` of ``torch_combines.py`` (fresh for
each test). Tolerance: exact for ints and bools; float planes that went
through a fold within ``rtol=1e-5`` (the port's Hillis-Steele scan groups
the combine differently from ``lax.associative_scan``); a query of the
same forest walks the same nodes in the same order, so its floats are
bitwise, but for ``mean_last``'s mean (``CONTRACTED``: XLA may contract
its product into an FMA), held to ``rtol=1e-6``.

The CUDA kernels themselves run only on a card: ``chip_smoke.py`` holds
them against these plain versions there. Here the string checks that both
libraries expand the new entry points, and that a CPU tensor takes the
plain path.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_combines as tc
from windflow_tpu.basic import WinType as JWinType
from windflow_tpu.tpu.ffat_tpu import Ffat_Windows_TPU
from windflow_tpu_torch import WinType, WindFlowError, fieldwise
from windflow_tpu_torch.gpu.ffat_gpu import Ffat_Windows_GPU
from windflow_tpu_torch.kernels import ffat_step as fs
from windflow_tpu_torch.kernels import forest_rebuild as fr
from windflow_tpu_torch.kernels.combine_codegen import kernel_source
from windflow_tpu_torch.kernels.reference import forest_rebuild_ref

KERNELS = Path(fs.__file__).resolve().parent
K_CAP = 8
WIN, SLIDE = 4, 1  # panes: consecutive windows overlap by 3 panes
FOLD_RTOL = 1e-5
CONTRACTED_RTOL = 1e-6


def _combines(name):
    """(jnp combine, torch combine, plane dtypes) of a combine name."""
    if name == "int_sum":
        return ((lambda a, b: {"v": a["v"] + b["v"]}), fieldwise(v="sum"),
                {"v": torch.int32})
    return tc.make(name, jnp), tc.make(name, torch), tc.DTYPES[name]


def _columns(dtypes, n, rng):
    """Random lifted columns: counts ``n`` in [1, 5), means in [0, 100),
    other ints in [-1000, 1000), floats in [0, 1)."""
    out = {}
    for f, dt in dtypes.items():
        if dt is torch.bool:
            out[f] = rng.random(n) < 0.5
        elif dt is torch.int32:
            lo, hi = (1, 5) if f == "n" else (-1000, 1000)
            out[f] = rng.integers(lo, hi, n).astype(np.int32)
        elif f == "mean":
            out[f] = (100 * rng.random(n)).astype(np.float32)
        else:
            out[f] = rng.random(n).astype(np.float32)
    return out


def _forest(dtypes, F, rng, jcomb):
    """A random forest whose internal nodes are the rebuild of its leaves
    (by JAX's level loop: the fire-only step reads a rebuilt forest)."""
    planes = _columns(dtypes, K_CAP * 2 * F, rng)
    planes = {f: p.reshape(K_CAP, 2 * F) for f, p in planes.items()}
    valid = rng.random((K_CAP, 2 * F)) < 0.6
    rep = _jax_replica(jcomb, F)
    trees, tvalid = rep._rebuild_fn()(
        {f: jnp.asarray(p) for f, p in planes.items()}, jnp.asarray(valid))
    return ({f: np.array(t) for f, t in trees.items()}, np.array(tvalid))


def _jax_replica(jcomb, F):
    op = Ffat_Windows_TPU(lambda f: dict(f), jcomb, "key", WIN, SLIDE,
                          JWinType.TB, 0, None, key_capacity=K_CAP)
    op.build_replicas()
    rep = op.replicas[0]
    rep.F = F
    rep._host_seg = False  # JAX sorts the packed composite itself
    assert rep.K_cap == K_CAP and rep._use_ktable()
    return rep


def _port_replica(F):
    op = Ffat_Windows_GPU(lambda f: dict(f), fieldwise(v="sum"), "key", WIN,
                          SLIDE, WinType.TB, 0, None, key_capacity=K_CAP)
    op.build_replicas()
    rep = op.replicas[0]
    rep.F = F
    return rep


def _packs(F, chunks, W):
    """The port replica's fire, evict and block packs of ``chunks`` (a
    list of (slot, start0, k, wid0, max_leaf)) with budget W."""
    cols = tuple(np.array(c, dtype=np.int64) for c in zip(*chunks))
    n_out = int(cols[2].sum())
    rep = _port_replica(F)
    buf, E = rep._pack_fire_arrays(cols, n_out, W)
    f_pack, e_pack, blocks = fs.split_fire_pack(torch.from_numpy(buf), W, E)
    return f_pack, e_pack, blocks, n_out


def _ktable():
    return np.arange(K_CAP, dtype=np.int32) * 11 + 3


def _port_planes(trees, tvalid):
    flat = {f: torch.from_numpy(t.reshape(-1).copy()) for f, t in
            trees.items()}
    return flat, torch.from_numpy(tvalid.reshape(-1).copy())


def _holds(name, f, got, exp, folded):
    if got.dtype == np.float32:
        rtol = FOLD_RTOL if folded else (
            CONTRACTED_RTOL if f in tc.CONTRACTED.get(name, ()) else 0.0)
        if rtol:
            np.testing.assert_allclose(got, exp, rtol=rtol, err_msg=f)
            return
        assert (got.view(np.int32) == exp.view(np.int32)).all(), f
    else:
        assert (got == exp).all(), f


def _same_forest(name, flat, vflat, jtrees, jvalid, folded):
    """Validity everywhere, planes where valid."""
    ev = np.asarray(jvalid).reshape(-1)
    assert (vflat.numpy() == ev).all()
    for f, t in jtrees.items():
        _holds(name, f, flat[f].numpy()[ev], np.asarray(t).reshape(-1)[ev],
               folded)


def _comp(rng, n, F, late=0.1, runs=None):
    """Packed composites (slot * F + leaf) of n rows over K_CAP slots and
    the first 6 leaves of each ring, ``late`` of them the sentinel; or
    ``runs``: (key, count) pairs, shuffled."""
    M = K_CAP * F
    if runs is not None:
        c = np.concatenate([np.full(k, key) for key, k in runs])
        c = c[rng.permutation(len(c))]
    else:
        c = rng.integers(0, K_CAP, n) * F + rng.integers(0, 6, n)
        c = np.where(rng.random(n) < late, M, c)
    return c.astype(np.int16 if M < 2**15 - 1 else np.int32)


def _order(comp, host):
    if host:
        return torch.from_numpy(np.argsort(comp, kind="stable")
                                .astype(np.int32))
    return fs.sort_rows(torch.from_numpy(comp))[0]


def _jax_step(jcomb, F, cols, comp, trees, tvalid, packs=None):
    """JAX's ingest-only step (``packs`` None) or full step."""
    rep = _jax_replica(jcomb, F)
    step = rep._make_step(len(comp), donate=False, ingest_only=packs is None)
    z = jnp.zeros(1, jnp.int32)
    if packs is None:
        fire, evict = (z,) * 5, (z,) * 3
    else:
        fire = tuple(jnp.asarray(r.numpy()) for r in packs[0])
        evict = tuple(jnp.asarray(r.numpy()) for r in packs[1])
    out = step({f: jnp.asarray(c) for f, c in cols.items()},
               jnp.asarray(comp), z, z, z, z,
               {f: jnp.asarray(t) for f, t in trees.items()},
               jnp.asarray(tvalid), fire, jnp.asarray(_ktable()), evict)
    return out


def _port_ingest(tcomb, cols, comp, flat, vflat, F, host):
    """The plain K2+K3 with the order taken on the host (numpy) or as the
    replica takes it on a card (``sort_rows``, the sorted keys passed)."""
    tc_ = torch.from_numpy(comp)
    if host:
        order = _order(comp, True)
        skeys = tc_[order.long()]
    else:
        order, skeys = fs.sort_rows(tc_)
    fs.ingest_fold(tcomb, {f: torch.from_numpy(c) for f, c in cols.items()},
                   (order, skeys), flat, vflat, F)


NAMES = ["int_sum", "ysb_last", "mean_last"]


@pytest.mark.parametrize("host", [True, False], ids=["host_order",
                                                     "device_order"])
@pytest.mark.parametrize("F", [8, 32])
@pytest.mark.parametrize("name", NAMES)
def test_ingest_only_matches_jax(name, F, host):
    """K2+K3's plain version against JAX's ingest-only step: a few hundred
    rows over 8 slots, 10% late."""
    jcomb, tcomb, dtypes = _combines(name)
    rng = np.random.default_rng(F * 31 + len(name))
    trees, tvalid = _forest(dtypes, F, rng, jcomb)
    n = 300
    cols = _columns(dtypes, n, rng)
    comp = _comp(rng, n, F)
    jt, jv = _jax_step(jcomb, F, cols, comp, trees, tvalid)[:2]
    flat, vflat = _port_planes(trees, tvalid)
    _port_ingest(tcomb, cols, comp, flat, vflat, F, host)
    _same_forest(name, flat, vflat, jt, jv, folded=True)


@pytest.mark.parametrize("name", NAMES)
def test_ingest_run_across_warp_and_block_boundaries(name):
    """A run of 110 rows over sorted rows 990-1,099 crosses a 32-row and
    the 1,024-row boundary; a 40-row run starts at sorted row 20 and
    crosses row 32; one-row runs sit between."""
    jcomb, tcomb, dtypes = _combines(name)
    F = 32
    rng = np.random.default_rng(5)
    trees, tvalid = _forest(dtypes, F, rng, jcomb)
    runs = ([(0, 20), (1, 40)] + [(2 * F + i, 1) for i in range(6)]
            + [(3 * F + 1, 924), (4 * F + 2, 110), (5 * F, 1),
               (7 * F + 5, 200), (K_CAP * F, 50)])
    comp = _comp(rng, 0, F, runs=runs)
    cols = _columns(dtypes, len(comp), rng)
    order = np.argsort(comp, kind="stable")
    sc = comp[order]
    assert (sc[990:1100] == 4 * F + 2).all() and sc[989] != sc[990]
    jt, jv = _jax_step(jcomb, F, cols, comp, trees, tvalid)[:2]
    flat, vflat = _port_planes(trees, tvalid)
    _port_ingest(tcomb, cols, comp, flat, vflat, F, host=False)
    _same_forest(name, flat, vflat, jt, jv, folded=True)


@pytest.mark.parametrize("F", [8, 32])
def test_ingest_all_rows_late(F):
    """Only the sentinel: the forest stays as it was, bit for bit."""
    jcomb, tcomb, dtypes = _combines("ysb_last")
    rng = np.random.default_rng(F)
    trees, tvalid = _forest(dtypes, F, rng, jcomb)
    comp = np.full(200, K_CAP * F, dtype=np.int16)
    cols = _columns(dtypes, 200, rng)
    jt, jv = _jax_step(jcomb, F, cols, comp, trees, tvalid)[:2]
    flat, vflat = _port_planes(trees, tvalid)
    _port_ingest(tcomb, cols, comp, flat, vflat, F, host=False)
    assert (vflat.numpy() == tvalid.reshape(-1)).all()
    assert (np.asarray(jv) == tvalid).all()
    for f, t in trees.items():
        assert (flat[f].numpy() == t.reshape(-1)).all()


def _layout_runs(layout, F):
    """(key, count) runs of a layout that stresses K2+K3's tiles (128 to
    512 sorted rows a tile): one run over the whole batch; runs whose
    sorted ends fall on multiples of 256 (tile edges); rows whose count
    is no multiple of 128 (the last tile part empty); a 1,000-row run
    among short ones."""
    if layout == "one_run":
        return [(3 * F + 2, 1500)]
    if layout == "ragged":
        return ([(i * F + i % 7, n) for i, n in
                 enumerate([300, 1, 257, 129, 200])] + [(K_CAP * F, 46)])
    if layout == "tile_edges":
        return [(i * F + i % 6, n) for i, n in
                enumerate([256, 1024, 256, 256, 512, 256])]
    return ([(i * F + i % 5, 3) for i in range(4)] + [(4 * F + 1, 1000)]
            + [(5 * F + i, 7) for i in range(6)] + [(K_CAP * F, 40)])


@pytest.mark.parametrize("layout", ["one_run", "tile_edges", "long_run",
                                    "ragged"])
@pytest.mark.parametrize("name", NAMES)
def test_ingest_stress_layouts_match_jax(name, layout):
    """The layouts the tiled fold carries across tiles: the plain K2+K3
    (with the sort's order and sorted keys, as on a card) against JAX's
    ingest-only step."""
    jcomb, tcomb, dtypes = _combines(name)
    F = 32
    rng = np.random.default_rng(len(layout) * 13 + len(name))
    trees, tvalid = _forest(dtypes, F, rng, jcomb)
    comp = _comp(rng, 0, F, runs=_layout_runs(layout, F))
    sc = np.sort(comp.astype(np.int64), kind="stable")
    ends = np.flatnonzero(np.r_[sc[1:] != sc[:-1], True]) + 1
    if layout == "tile_edges":
        assert (ends % 256 == 0).all()
    if layout == "ragged":
        assert len(comp) % fs.INGEST_THREADS != 0
    cols = _columns(dtypes, len(comp), rng)
    jt, jv = _jax_step(jcomb, F, cols, comp, trees, tvalid)[:2]
    flat, vflat = _port_planes(trees, tvalid)
    _port_ingest(tcomb, cols, comp, flat, vflat, F, host=False)
    _same_forest(name, flat, vflat, jt, jv, folded=True)


@pytest.mark.parametrize("seed", range(4))
def test_tails_unique_per_slot_and_leaf(seed):
    """The fold merges one tail per run: each (slot, leaf) a batch touches
    gets exactly one write, so the kernel's leaf writes need no atomics.
    A fold into a zeroed forest (the mesh's delta forest) marks exactly
    the distinct live keys, each with its run's sum."""
    F = 8
    rng = np.random.default_rng(seed)
    comp = _comp(rng, 400, F, late=0.2)
    sc = comp[np.argsort(comp, kind="stable")].astype(np.int64)
    tails = sc[np.r_[sc[1:] != sc[:-1], True] & (sc < K_CAP * F)]
    assert len(np.unique(tails)) == len(tails)
    vals = rng.integers(0, 100, 400).astype(np.int32)
    flat = {"v": torch.zeros(K_CAP * 2 * F, dtype=torch.int32)}
    vflat = torch.zeros(K_CAP * 2 * F, dtype=torch.bool)
    fs.ingest_fold(fieldwise(v="sum"), {"v": torch.from_numpy(vals)},
                   fs.sort_rows(torch.from_numpy(comp)), flat, vflat, F)
    live = comp.astype(np.int64) < K_CAP * F
    at = (tails // F) * 2 * F + F + tails % F
    assert sorted(np.flatnonzero(vflat.numpy())) == sorted(at)
    exp = np.zeros(K_CAP * 2 * F, dtype=np.int64)
    c = comp.astype(np.int64)[live]
    np.add.at(exp, (c // F) * 2 * F + F + c % F, vals[live])
    assert (flat["v"].numpy() == exp).all()


# the fire steps: (slot, start0, k, wid0, max_leaf) chunks. Slot 0 fires 3
# overlapping windows whose leaves the same step evicts; slot 2's window
# ring-wraps (start0 % F == F - 2); slot 3 fires 2 clipped by max_leaf
def _chunks(F):
    return [(0, 5, 3, 1, 9), (2, 3 * F - 2, 1, 7, 3 * F + 3),
            (3, 1, 2, 0, 3)]


@pytest.mark.parametrize("F", [8, 32])
@pytest.mark.parametrize("name", NAMES)
def test_fire_only_matches_jax(name, F):
    """K4's plain version against JAX's fire-only program on the same
    rebuilt forest: values, validity & mask, wid, key, and the forest
    after the eviction. Window w of slot 0 reads panes its step evicts
    (w > slide), so an eviction that lands before a query shows."""
    jcomb, tcomb, dtypes = _combines(name)
    rng = np.random.default_rng(F + 100 * len(name))
    trees, tvalid = _forest(dtypes, F, rng, jcomb)
    f_pack, e_pack, blocks, n_out = _packs(F, _chunks(F), W=8)
    assert n_out == 6 and f_pack[2, 3] == WIN  # the wrapping window
    assert int(f_pack[1, 3]) + WIN > F
    rep = _jax_replica(jcomb, F)
    jv, jr, jq, jwid, jkey = rep._make_fire_step()(
        {f: jnp.asarray(t) for f, t in trees.items()}, jnp.asarray(tvalid),
        tuple(jnp.asarray(r.numpy()) for r in f_pack),
        jnp.asarray(_ktable()),
        tuple(jnp.asarray(r.numpy()) for r in e_pack))
    flat, vflat = _port_planes(trees, tvalid)
    qr, qv, key = fs.fire_query(tcomb, flat, vflat, F, f_pack, e_pack, blocks,
                                torch.from_numpy(_ktable()))
    assert (qv.numpy() == np.asarray(jq)).all() and qv[:n_out].any()
    assert (key.numpy() == np.asarray(jkey)).all()
    assert (f_pack[3].numpy() == np.asarray(jwid)).all()
    q = np.asarray(jq)
    for f in dtypes:
        _holds(name, f, qr[f].numpy()[q], np.asarray(jr[f])[q], folded=False)
    assert (vflat.numpy() == np.asarray(jv).reshape(-1)).all()
    # the step evicted slot 0's panes 5-7 (its windows read them first)
    assert not vflat[[F + p % F for p in (5, 6, 7)]].any()


def _long_packs(F, rng, W=16):
    """Fire, evict and block packs of W windows of 0 to F panes from any
    start (two a slot, ring wraps included) and 0-5 evicted leaves a
    slot: the long walks K4 meets at F 1,024."""
    slots = np.sort(rng.choice(K_CAP, W // 2, replace=False))
    ne = rng.integers(0, 6, len(slots))
    tot = int(ne.sum())
    f_pack = np.stack([np.repeat(slots, 2), rng.integers(0, F, W),
                       rng.integers(0, F + 1, W), np.arange(W),
                       np.ones(W, np.int64)]).astype(np.int32)
    f_pack[2, :2] = F  # a whole ring
    E = max(1, tot)
    e_pack = np.zeros((3, E), np.int32)
    e_pack[:, :tot] = [np.repeat(slots, ne), rng.integers(0, F, tot),
                       np.ones(tot, np.int64)]
    buf = fs.fire_pack(f_pack, e_pack, np.full(len(slots), 2), ne, W)
    return fs.split_fire_pack(torch.from_numpy(buf), W, E)


@pytest.mark.parametrize("name", NAMES)
def test_fire_only_long_ring_matches_jax(name):
    """K4's plain version at F 1,024 (a walk of up to 48 nodes, two rounds
    of the kernel's loads) against JAX's fire-only program: values,
    validity & mask, keys and the evicted forest."""
    F = 1024
    jcomb, tcomb, dtypes = _combines(name)
    rng = np.random.default_rng(1024 + len(name))
    trees, tvalid = _forest(dtypes, F, rng, jcomb)
    f_pack, e_pack, blocks = _long_packs(F, rng)
    rep = _jax_replica(jcomb, F)
    jv, jr, jq, jwid, jkey = rep._make_fire_step()(
        {f: jnp.asarray(t) for f, t in trees.items()}, jnp.asarray(tvalid),
        tuple(jnp.asarray(r.numpy()) for r in f_pack),
        jnp.asarray(_ktable()),
        tuple(jnp.asarray(r.numpy()) for r in e_pack))
    flat, vflat = _port_planes(trees, tvalid)
    qr, qv, key = fs.fire_query(tcomb, flat, vflat, F, f_pack, e_pack, blocks,
                                torch.from_numpy(_ktable()))
    q = np.asarray(jq)
    assert (qv.numpy() == q).all() and q.any()
    assert (key.numpy() == np.asarray(jkey)).all()
    for f in dtypes:
        _holds(name, f, qr[f].numpy()[q], np.asarray(jr[f])[q], folded=False)
    assert (vflat.numpy() == np.asarray(jv).reshape(-1)).all()


@pytest.mark.parametrize("F", [8, 32])
@pytest.mark.parametrize("name", NAMES)
def test_full_step_matches_jax(name, F):
    """Ingest, K1's rebuild and the fire step with eviction, against JAX's
    full step: the forest after it and every fired window."""
    jcomb, tcomb, dtypes = _combines(name)
    rng = np.random.default_rng(F * 7 + len(name))
    trees, tvalid = _forest(dtypes, F, rng, jcomb)
    n = 250
    cols = _columns(dtypes, n, rng)
    comp = _comp(rng, n, F)
    f_pack, e_pack, blocks, n_out = _packs(F, _chunks(F), W=8)
    jt, jv, jr, jq, jwid, jkey = _jax_step(jcomb, F, cols, comp, trees,
                                           tvalid, (f_pack, e_pack))
    flat, vflat = _port_planes(trees, tvalid)
    _port_ingest(tcomb, cols, comp, flat, vflat, F, host=True)
    forest_rebuild_ref({f: t.view(K_CAP, 2 * F) for f, t in flat.items()},
                       vflat.view(K_CAP, 2 * F), tcomb)
    qr, qv, key = fs.fire_query(tcomb, flat, vflat, F, f_pack, e_pack, blocks,
                                torch.from_numpy(_ktable()))
    q = np.asarray(jq)
    assert (qv.numpy() == q).all() and q.any()
    assert (key.numpy() == np.asarray(jkey)).all()
    assert (f_pack[3].numpy() == np.asarray(jwid)).all()
    for f in dtypes:
        _holds(name, f, qr[f].numpy()[q], np.asarray(jr[f])[q], folded=True)
    _same_forest(name, flat, vflat, jt, jv, folded=True)


@pytest.mark.parametrize("c_k,W", [
    ([1] * 300, 512), ([3, 1, 200, 2, 130, 1], 400), ([128, 128], 256),
    ([5], 5), ([129, 1], 130), ([], 64), ([7, 1, 8, 9], 32),
    ([8] * 5, 44), ([2, 7, 3], 12), ([31, 2, 32, 33], 100),
    ([32] * 3, 96)])
def test_fire_blocks_own_whole_chunks(c_k, W):
    """Every chunk's fire and evict lanes fall in one block; the blocks
    tile [0, W) and [0, E) in order; padding lanes have blocks of their
    own, with no eviction."""
    c_k = np.array(c_k, dtype=np.int64)
    ne = c_k * 2 + (np.arange(len(c_k)) % 2)  # any per-chunk evict count
    n_out = int(c_k.sum())
    b = fs.fire_blocks(c_k, ne, n_out, W)
    assert b.dtype == np.int32 and b.shape[0] == 2 and b.shape[1] >= 2
    r0, r1 = b.astype(np.int64)
    assert r0[0] == 0 and r0[-1] == W and (np.diff(r0) >= 0).all()
    assert r1[0] == 0 and r1[-1] == ne.sum() and (np.diff(r1) >= 0).all()
    fk = np.r_[0, np.cumsum(c_k)]
    fe = np.r_[0, np.cumsum(ne)]
    for c in range(len(c_k)):
        blk = np.searchsorted(r0, fk[c], side="right") - 1
        assert r0[blk] <= fk[c] and fk[c + 1] <= r0[blk + 1]
        assert r1[blk] <= fe[c] and fe[c + 1] <= r1[blk + 1]
    pad = r0[:-1] >= n_out
    assert (np.diff(r1)[pad] == 0).all()
    assert (np.diff(r0)[pad] <= fs.QUERY_LANES).all()


@pytest.mark.parametrize("W", [1, 7, 31, 32, 33, 64, 1000])
def test_lane_blocks_one_window_a_chunk(W):
    """The mesh's fire rounds: one chunk a key row, no eviction, so every
    block but the last holds exactly QUERY_LANES windows."""
    bt = fs.lane_blocks(W, torch.device("cpu"))
    assert bt.dtype is torch.int32
    b = bt.numpy().astype(np.int64)
    assert b.shape == (2, -(-W // fs.QUERY_LANES) + 1)
    assert b[0, 0] == 0 and b[0, -1] == W
    assert (np.diff(b[0])[:-1] == fs.QUERY_LANES).all()
    assert 1 <= np.diff(b[0])[-1] <= fs.QUERY_LANES
    assert (b[1] == 0).all()


def test_block_constants_match_the_header():
    """The host's windows a block and least rows a tile are the kernels'."""
    cuh = (KERNELS / "ffat_step.cuh").read_text()
    windows = int(re.search(r"#define WF_QUERY_WINDOWS (\d+)", cuh)[1])
    group = int(re.search(r"#define WF_QUERY_GROUP (\d+)", cuh)[1])
    threads = int(re.search(r"#define WF_INGEST_THREADS (\d+)", cuh)[1])
    assert fs.QUERY_LANES == windows and 32 % group == 0
    assert "#define WF_QUERY_THREADS (WF_QUERY_GROUP * WF_QUERY_WINDOWS)" \
        in cuh
    assert fs.INGEST_THREADS == threads


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1024, 65536, 65537])
@pytest.mark.parametrize("n_fields", [1, 2, 3, 8, 12])
def test_ingest_scratch_covers_every_tile(n, n_fields):
    """The status buffer holds the ticket and a status word a tile, the
    rows' buffer a tile's aggregate and inclusive prefix, for tiles of 1,
    2 or 4 rows a thread (``ingest_items``); the status words depend on
    the rows alone, never on the fields."""
    status, rows = fs.ingest_scratch_words(n, n_fields)
    items = 4 if n_fields <= 2 else 2 if n_fields <= 4 else 1
    tiles = -(-n // (fs.INGEST_THREADS * items))
    assert status >= 1 + tiles and rows >= 2 * tiles * n_fields
    assert status == 1 + -(-n // fs.INGEST_THREADS)
    assert rows == 2 * -(-n // fs.INGEST_THREADS) * n_fields
    assert fs.ingest_scratch_words(n, 1)[0] == status


def test_ingest_scratch_per_device_and_stream(monkeypatch):
    """One zeroed status buffer per (device, stream), reused with a new
    sequence number each launch; made again (numbers from 1) when it is
    too small or the numbers run out. The rows' buffer grows apart from
    it."""
    monkeypatch.setattr(fs, "_SCRATCH", {})
    cpu = torch.device("cpu")
    t = fs.INGEST_THREADS
    a, ra, s1 = fs.ingest_scratch(cpu, 7, 100 * t, 1)
    assert a.dtype is torch.int32 and a.numel() == 128 and s1 == 1
    assert not a.any() and ra.dtype is torch.int32 and ra.numel() == 256
    b, rb, s2 = fs.ingest_scratch(cpu, 7, 127 * t, 1)
    assert b is a and rb is ra and s2 == 2
    c, _, s3 = fs.ingest_scratch(cpu, 8, 10, 1)  # another stream
    assert c is not a and s3 == 1
    d, rd, s4 = fs.ingest_scratch(cpu, 7, 128 * t, 1)
    assert d is not a and d.numel() == 256 and s4 == 1 and rd is ra
    monkeypatch.setattr(fs, "SEQ_LIMIT", 3)
    e, _, s5 = fs.ingest_scratch(cpu, 7, 1, 1)
    assert e is d and s5 == 2
    f, _, s6 = fs.ingest_scratch(cpu, 7, 1, 1)
    assert f is not d and s6 == 1


def test_ingest_status_words_stay_put_across_widths(monkeypatch):
    """Launches of other widths and lengths on one stream share the status
    buffer, whose words sit where the tile puts them: a wider launch grows
    the rows' buffer (unfilled: nothing reads it before a launch writes
    it), never the status buffer, and data never lands there."""
    monkeypatch.setattr(fs, "_SCRATCH", {})
    cpu = torch.device("cpu")
    t = fs.INGEST_THREADS
    a, ra, _ = fs.ingest_scratch(cpu, 3, 512 * t, 1)
    b, rb, _ = fs.ingest_scratch(cpu, 3, 512 * t, 8)
    c, rc, _ = fs.ingest_scratch(cpu, 3, 7, 12)
    assert a is b is c and a.numel() == 1024
    assert rb is not ra and rb.numel() == 2 * 512 * 8 and rc is rb
    g, rg, _ = fs.ingest_scratch(cpu, 3, 40 * t + 1, 3)
    assert g is a and rg is rb


def test_reserve_ingest_scratch_before_the_first_batch(monkeypatch):
    """``reserve_ingest_scratch`` makes the status buffer of a card's
    current stream ahead of its batches, and a later launch of no more
    rows makes none; the CPU needs none (its plain version has no
    scratch)."""
    monkeypatch.setattr(fs, "_SCRATCH", {})
    fs.reserve_ingest_scratch(torch.device("cpu"), 65536)
    assert fs._SCRATCH == {}
    seen = []
    monkeypatch.setattr(fs, "_current_stream", lambda dev: 11)
    monkeypatch.setattr(fs, "_scratch_entry",
                        lambda dev, stream, n: seen.append((dev, stream, n)))
    dev = torch.device("cuda", 0)
    fs.reserve_ingest_scratch(dev, 65536)
    fs.reserve_ingest_scratch(dev, 0)  # no rows: nothing
    assert seen == [(dev, 11, 65536)]
    monkeypatch.undo()
    # what it makes on a card, here on the CPU: the status buffer covers
    # every later launch of up to 65,536 rows, whatever its width
    monkeypatch.setattr(fs, "_SCRATCH", {})
    cpu = torch.device("cpu")
    made = fs._scratch_entry(cpu, 11, 65536)[0]
    assert made.numel() == 1024 and not made.any()
    for n, nf in ((65536, 8), (1000, 1), (65535, 12)):
        assert fs.ingest_scratch(cpu, 11, n, nf)[0] is made


def test_sort_rows_gives_order_and_sorted_keys():
    """``sort_rows``: the stable sort's int32 order and comp[order]."""
    rng = np.random.default_rng(3)
    for dt in (np.int16, np.int32):
        comp = torch.from_numpy(rng.integers(0, 50, 500).astype(dt))
        order, skeys = fs.sort_rows(comp)
        assert order.dtype is torch.int32 and skeys.dtype is comp.dtype
        assert torch.equal(skeys, comp[order.long()])
        assert torch.equal(order.long(), torch.from_numpy(
            np.argsort(comp.numpy(), kind="stable")))


@pytest.mark.parametrize("bad", ["length", "dtype", "device", "shape"])
def test_ingest_refuses_wrong_sorted_keys(bad):
    """The sorted keys must be a contiguous 1-D tensor of comp's dtype and
    length on the forest's device: anything else is refused before a
    launch (and before the plain version)."""
    F = 8
    rng = np.random.default_rng(2)
    comp = torch.from_numpy(_comp(rng, 64, F))
    order, skeys = fs.sort_rows(comp)
    skeys = {"length": skeys[:-1], "dtype": skeys.to(torch.int64),
             "device": skeys.to("meta"),
             "shape": skeys.view(8, 8)}[bad]
    flat = {"v": torch.zeros(K_CAP * 2 * F, dtype=torch.int32)}
    vflat = torch.zeros(K_CAP * 2 * F, dtype=torch.bool)
    with pytest.raises(WindFlowError, match="sorted_keys"):
        fs.ingest_fold(fieldwise(v="sum"),
                       {"v": torch.ones(64, dtype=torch.int32)},
                       (order, skeys), flat, vflat, F)
    assert not vflat.any()


def test_fire_pack_round_trip():
    """One buffer, three views: what the kernel and its plain version read
    is the replica's fire and evict packs."""
    F = 8
    f_pack, e_pack, blocks, n_out = _packs(F, _chunks(F), W=8)
    assert f_pack.shape == (5, 8) and e_pack.shape == (3, 8)
    assert f_pack.is_contiguous() and e_pack.is_contiguous()
    assert (f_pack[4].numpy() == [1] * n_out + [0] * (8 - n_out)).all()
    assert (f_pack[0, :n_out].numpy() == [0, 0, 0, 2, 3, 3]).all()
    assert (e_pack[0, :6].numpy() == [0, 0, 0, 2, 3, 3]).all()
    assert (e_pack[1, :6].numpy() == [5, 6, 7, F - 2, 1, 2]).all()
    # one block of whole chunks, then one of the two padding lanes
    assert blocks.numpy().tolist() == [[0, 6, 8], [0, 6, 6]]


def test_library_sources_expand_the_entry_points():
    """No nvcc here: the fieldwise library includes the FFAT header and
    defines both C entry points, and a traced variant's translation unit
    expands the header's macro for its own policy (one variant, one
    library)."""
    cu = (KERNELS / "forest_rebuild.cu").read_text()
    cuh = (KERNELS / "ffat_step.cuh").read_text()
    assert '#include "ffat_step.cuh"' in cu
    for fn in ("wf_ffat_ingest", "wf_ffat_query"):
        assert re.search(rf"\bint {fn}\(", cu), fn
        assert re.search(rf"\bint {fn}\(", cuh), fn
    assert "#define WF_FFAT_ENTRY_POINTS(Comb)" in cuh
    for name in ("ysb_last", "mean_last", "flags"):
        v = fr.variant(tc.make(name, torch), tc.DTYPES[name])
        src = kernel_source(v.ir)
        assert src == v.text
        assert '#include "ffat_step.cuh"' in src
        assert re.search(r"WF_FFAT_ENTRY_POINTS\(wfg_[0-9a-f]{12}::"
                         r"WfgCombine\)", src)
        assert re.search(r"WF_REBUILD_ENTRY_POINTS\(wfg_[0-9a-f]{12}::"
                         r"WfgCombine\)", src)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """A CPU tensor never reaches a library: the build, the load and the
    launch counters stay untouched."""
    def no_load(self):
        raise AssertionError("a CPU tensor loaded a kernel library")

    monkeypatch.setattr(fr.Variant, "load", no_load)
    counts = (fs.INGEST_LAUNCHES, fs.QUERY_LAUNCHES)
    F = 8
    rng = np.random.default_rng(1)
    comp = _comp(rng, 64, F)
    flat = {"v": torch.zeros(K_CAP * 2 * F, dtype=torch.int32)}
    vflat = torch.zeros(K_CAP * 2 * F, dtype=torch.bool)
    fs.ingest_fold(fieldwise(v="sum"),
                   {"v": torch.ones(64, dtype=torch.int32)},
                   fs.sort_rows(torch.from_numpy(comp)), flat, vflat, F)
    f_pack, e_pack, blocks, _ = _packs(F, _chunks(F), W=8)
    fs.fire_query(fieldwise(v="sum"), flat, vflat, F, f_pack, e_pack,
                  blocks)
    assert (fs.INGEST_LAUNCHES, fs.QUERY_LAUNCHES) == counts
    assert int(flat["v"].sum()) == int((comp < K_CAP * F).sum())


def test_no_kernel_for_other_devices():
    """A tensor on neither the CPU nor a CUDA card raises: there is no
    fallback."""
    F = 8
    flat = {"v": torch.zeros(K_CAP * 2 * F, dtype=torch.int32,
                             device="meta")}
    vflat = torch.zeros(K_CAP * 2 * F, dtype=torch.bool, device="meta")
    comp = torch.zeros(4, dtype=torch.int16, device="meta")
    with pytest.raises(WindFlowError, match="no kernel for device"):
        fs.ingest_fold(fieldwise(v="sum"), {"v": comp.int()},
                       (comp.int(), comp), flat, vflat, F)
    with pytest.raises(WindFlowError, match="no kernel for device"):
        fs.fire_query(fieldwise(v="sum"), flat, vflat, F,
                      torch.zeros((5, 4), dtype=torch.int32, device="meta"))
