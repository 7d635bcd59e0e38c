"""The port's mesh core (``windflow_tpu_torch/mesh/core.py``) held against
the JAX package's ``windflow_tpu/mesh/core.py`` on its conftest's 8
virtual CPU devices; the port runs ``ensure_virtual_devices(8)`` on
``device="cpu"``, every shard stacked on the one CPU device.

Inputs are made from numpy seeds and go through both steps. Tolerance:
EXACT for the routing (ints), the window queries over integer-valued
float32 panes and the FFAT forest (integer-valued float32 values: every
partial sum is an integer below 2^24, so no grouping of the additions
rounds); the pane accumulators of ``sharded_keyby_window_step`` sum
uniform floats, where the port groups the additions by shard and the JAX
package by its own scatter: ``rtol=1e-6, atol=1e-5``, counts exact."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from windflow_tpu.mesh import core as cj
from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.mesh import core as ct

SHAPES = [(8, 1), (4, 2), (2, 4), (1, 1)]


@pytest.fixture(autouse=True)
def virtual_devices():
    """8 virtual devices on the CPU and no excluded device for this
    file's tests; the process-wide registries go back to what they were
    (other port test files share the worker)."""
    prev, prev_excl = ct.virtual_device_count(), ct.excluded_device_ids()
    ct.ensure_virtual_devices(8)
    ct.set_excluded_devices(())
    yield
    ct.ensure_virtual_devices(prev)
    ct.set_excluded_devices(prev_excl)


def _meshes(shape):
    return (cj.make_key_mesh(8, shape=shape),
            ct.make_key_mesh(8, shape=shape, device="cpu"))


def _sh(mesh):
    return NamedSharding(mesh, P(("key", "data")))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# mesh construction and devices
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 7, 8])
def test_make_key_mesh_factorization_matches_jax(n):
    mj = cj.make_key_mesh(n)
    mt = ct.make_key_mesh(n, device="cpu")
    assert dict(mt.shape) == dict(mj.shape)
    assert mt.device_ids == [int(d.id) for d in np.ravel(mj.devices)]
    assert mt.ns == mj.devices.size


def test_make_key_mesh_shape_refusal_and_devices():
    with pytest.raises(ValueError, match="needs 16 devices"):
        cj.make_key_mesh(8, shape=(4, 4))
    with pytest.raises(ValueError, match="needs 16 devices"):
        ct.make_key_mesh(8, shape=(4, 4), device="cpu")
    mesh = ct.make_key_mesh(8, shape=(2, 4), device="cpu")
    assert mesh.devices == [torch.device("cpu")] * 8
    # without virtual devices the CPU is one device: a (1, 1) mesh
    ct.ensure_virtual_devices(0)
    assert ct.visible_devices("cpu") == [(0, torch.device("cpu"))]
    assert ct.make_key_mesh(8, device="cpu").shape == {"key": 1, "data": 1}


def test_mesh_over_several_physical_devices_is_refused():
    """A mesh over several physical devices builds one group of shards per
    device (the mesh across cards is ported, ``test_torch_mesh_cards.py``);
    what stays refused is a device whose shards are not one contiguous
    block of the flat order."""
    devs = [(0, torch.device("cpu")), (1, torch.device("meta"))]
    mesh = ct.KeyMesh((2, 1), devs)
    assert [(str(g.device), g.lo, g.hi) for g in mesh.groups] == \
        [("cpu", 0, 1), ("meta", 1, 2)]
    with pytest.raises(ValueError, match="contiguous block"):
        ct.KeyMesh((2, 2), devs + devs)


def test_make_key_mesh_without_device_wants_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(WindFlowError, match="no CUDA device"):
        ct.make_key_mesh(8)


# ---------------------------------------------------------------------------
# routing primitives, padding lanes included
# ---------------------------------------------------------------------------
def _jax_route_to_owners(mesh, k_local, C, keys, panes, vals):
    ka = mesh.shape["key"]

    def local(k, p, v):
        rk, rp, rv, valid, lk = cj._route_to_owners(ka, k_local, C, k, p,
                                                    {"v": v})
        return rk, rp, rv["v"], valid, lk

    spec = P(("key", "data"))
    f = cj.wf_shard_map(local, mesh=mesh, in_specs=(spec,) * 3,
                        out_specs=(spec,) * 5, check_vma=False)
    sh = _sh(mesh)
    return [np.asarray(a) for a in jax.jit(f)(
        jax.device_put(keys, sh), jax.device_put(panes, sh),
        jax.device_put(vals, sh))]


@pytest.mark.parametrize("shape", SHAPES)
def test_route_to_owners_matches_jax(shape):
    mj, mt = _meshes(shape)
    ka = mj.shape["key"]
    k_local, B = 5, 12
    n = mt.ns * B
    rng = np.random.default_rng(17)
    keys = rng.integers(0, ka * k_local, n).astype(np.int32)
    keys[rng.random(n) < 0.25] = -1  # padding lanes
    panes = rng.integers(0, 50, n).astype(np.int32)
    vals = rng.integers(-9, 9, n).astype(np.int32)
    ref = _jax_route_to_owners(mj, k_local, B, keys, panes, vals)
    rk, rp, rv, valid, lk = ct._route_to_owners(
        mt, k_local, B, _t(keys), _t(panes), {"v": _t(vals)})
    got = [a.reshape(-1).numpy() for a in (rk, rp, rv["v"], valid, lk)]
    for name, r, g in zip(("keys", "panes", "vals", "valid", "local_key"),
                          ref, got):
        assert np.array_equal(r, g), name
    # every real tuple arrives exactly once, at its owner
    assert sorted(got[0][got[3]]) == sorted(keys[keys >= 0])


def _jax_route_flat(mesh, k_local, C, slots, aux, vals):
    ns = cj.mesh_shard_count(mesh)

    def local(s, a, v):
        rs, ra, rv, valid, lk, order, flat, ok = cj._route_flat(
            ns, k_local, C, s, a, {"v": v})
        back = cj._route_back(ns, C, ra, order, flat, ok, fill=-7)
        return rs, ra, rv["v"], valid, lk, back

    spec = P(cj.MESH_AXES)
    f = cj.wf_shard_map(local, mesh=mesh, in_specs=(spec,) * 3,
                        out_specs=(spec,) * 6, check_vma=False)
    sh = _sh(mesh)
    return [np.asarray(a) for a in jax.jit(f)(
        jax.device_put(slots, sh), jax.device_put(aux, sh),
        jax.device_put(vals, sh))]


@pytest.mark.parametrize("shape", SHAPES)
def test_route_flat_and_back_match_jax(shape):
    mj, mt = _meshes(shape)
    ns = mt.ns
    k_local, B = 3, 10
    n = ns * B
    rng = np.random.default_rng(5)
    slots = rng.integers(0, ns * k_local, n).astype(np.int32)
    slots[rng.random(n) < 0.3] = -1  # padding lanes
    gpos = np.arange(n, dtype=np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    ref = _jax_route_flat(mj, k_local, B, slots, gpos, vals)
    rs, ra, rv, valid, lk, order, flat, ok = ct._route_flat(
        ns, k_local, B, _t(slots), _t(gpos), {"v": _t(vals)})
    back = ct._route_back(ns, B, ra, order, flat, ok, fill=-7)
    got = [a.numpy() for a in (rs, ra, rv["v"], valid, lk, back)]
    for name, r, g in zip(("slots", "aux", "vals", "valid", "local_key",
                           "back"), ref, got):
        assert np.array_equal(r, g), name
    # the inverse shuffle returns every lane to its arrival position
    assert np.array_equal(got[5], gpos)


def test_route_drops_lanes_past_bucket_capacity():
    """A bucket capacity C smaller than a shard's run to one owner (never
    the case in the operators, where C is the local batch): the port keeps
    each run's first C lanes and drops the rest. The JAX package clamps
    the overflow lanes onto slot C-1 and writes its fill there, so it also
    loses the C-th lane (ROADMAP Queue 3); the first C-1 lanes agree."""
    mj, mt = _meshes((8, 1))
    B, C = 8, 2
    keys = np.zeros(8 * B, np.int32)  # every lane to key shard 0
    panes = np.arange(8 * B, dtype=np.int32)
    ref = _jax_route_to_owners(mj, 1, C, keys, panes, panes)
    rk, rp, rv, valid, lk = ct._route_to_owners(
        mt, 1, C, _t(keys), _t(panes), {"v": _t(panes)})
    rk, rp, valid = rk.numpy(), rp.numpy(), valid.numpy()
    assert int(valid.sum()) == 8 * C and valid[0].all()
    # shard 0 receives source shard s's first C lanes, in order
    assert np.array_equal(rp[0], (np.arange(8)[:, None] * B
                                  + np.arange(C)).reshape(-1))
    first = np.arange(0, 8 * C, C)  # lane 0 of each source bucket
    assert np.array_equal(ref[1][first], rp[0][first])


# ---------------------------------------------------------------------------
# the key-sharded steps (twins of tests/test_mesh.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_keyby_window_step_multistep(shape):
    mj, mt = _meshes(shape)
    n_keys, n_panes, local_b = 32, 8, 16
    sj, cnt_j = cj.make_sharded_state(mj, n_keys, n_panes)
    st, cnt_t = ct.make_sharded_state(mt, n_keys, n_panes)
    step_j, nkp, gb = cj.sharded_keyby_window_step(mj, n_keys, n_panes,
                                                   local_b)
    step_t, nkp_t, gb_t = ct.sharded_keyby_window_step(mt, n_keys, n_panes,
                                                       local_b)
    assert (nkp, gb) == (nkp_t, gb_t)
    sh = _sh(mj)
    rng = np.random.default_rng(4)
    model = np.zeros((nkp, n_panes))
    for _ in range(3):
        keys = rng.integers(0, n_keys, gb).astype(np.int32)
        keys[rng.random(gb) < 0.1] = -1  # padding lanes
        vals = rng.random(gb).astype(np.float32)
        panes = rng.integers(0, 3 * n_panes, gb).astype(np.int32)
        sj, cnt_j, nj = step_j(sj, cnt_j, jax.device_put(keys, sh),
                               jax.device_put(vals, sh),
                               jax.device_put(panes, sh))
        st, cnt_t, nt = step_t(st, cnt_t, _t(keys), _t(vals), _t(panes))
        live = keys >= 0
        np.add.at(model, (keys[live], panes[live] % n_panes), vals[live])
        assert int(nt) == int(nj) == int(live.sum())
    assert np.array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), model, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("win,slide", [(4, 2), (7, 3), (8, 8)])
@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_ring_pane_window_query(win, slide, shape):
    mj, mt = _meshes(shape)
    n_shards = mj.shape["key"]
    p_local = 16
    P_total = n_shards * p_local
    fn_j, nw_j = cj.ring_pane_window_query(mj, P_total, win, slide)
    fn_t, nw_t = ct.ring_pane_window_query(mt, P_total, win, slide)
    assert nw_j == nw_t
    rng = np.random.default_rng(9)
    panes = rng.integers(0, 100, P_total).astype(np.float32)
    ref = np.asarray(fn_j(jax.device_put(panes)))
    got = fn_t(_t(panes)).numpy()
    expect = np.array([panes[w * slide:w * slide + win].sum()
                       for w in range(nw_t)], dtype=np.float32)
    assert np.array_equal(got, ref) and np.array_equal(got, expect)


def _forest_pair(shape, n_keys, win, slide, lb, rounds, late_policy):
    mj, mt = _meshes(shape)
    lift_j = lambda v: {"x": v["x"]}
    comb = lambda a, b: {"x": a["x"] + b["x"]}
    ij, sj, meta_j = cj.sharded_ffat_forest(
        mj, lift_j, comb, n_keys=n_keys, win_panes=win, slide_panes=slide,
        local_batch=lb, fire_rounds=rounds, late_policy=late_policy)
    it, stp, meta_t = ct.sharded_ffat_forest(
        mt, lift_j, comb, n_keys=n_keys, win_panes=win, slide_panes=slide,
        local_batch=lb, fire_rounds=rounds, late_policy=late_policy)
    assert meta_j == meta_t
    return (mj, ij({"x": np.zeros(1, np.float32)}), sj,
            it({"x": np.zeros(1, np.float32)}), stp, meta_t)


def _same_forest_step(oj, ot, F):
    """Every output of one step equal; the trees compare on their leaves
    (the JAX step skips the level rebuild when no key can fire, the port
    rebuilds every step: internal levels are only read in-step)."""
    tj, vj = oj[0]["x"], oj[1]
    assert np.array_equal(np.asarray(tj)[:, F:], ot[0]["x"].numpy()[:, F:])
    assert np.array_equal(np.asarray(vj)[:, F:], ot[1].numpy()[:, F:])
    for i in (2, 3, 4, 6, 7, 8, 9):
        assert np.array_equal(np.asarray(oj[i]),
                              np.asarray(ot[i].numpy())), i
    assert np.array_equal(np.asarray(oj[5]["x"]), ot[5]["x"].numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_ffat_forest_multistep(shape):
    """Key-sharded forest with all_to_all ingestion, the delta merge over
    'data' and the fire rounds: every step's outputs equal the JAX
    package's, and the fired windows the numpy oracle."""
    n_keys, WIN, SLIDE, LB = 13, 4, 1, 32
    mj, sj, step_j, st, step_t, (K_pad, _, GB) = _forest_pair(
        shape, n_keys, WIN, SLIDE, LB, 3, "keep_open")
    F = st[0]["x"].shape[1] // 2
    sh = _sh(mj)
    rng = np.random.default_rng(3)
    pane_sums, fired = {}, {}
    frontier = 0
    for it in range(6):
        keys = rng.integers(0, n_keys, GB).astype(np.int32)
        keys[rng.random(GB) < 0.1] = -1  # padding lanes
        vals = rng.integers(1, 10, GB).astype(np.float32)
        panes = (rng.integers(0, 3, GB) + it * 2).astype(np.int32)
        for k, v, p in zip(keys, vals, panes):
            if k >= 0 and p >= max(0, frontier):
                pane_sums[(int(k), int(p))] = pane_sums.get(
                    (int(k), int(p)), 0.0) + float(v)
        frontier = it * 2 + 2
        oj = step_j(*sj, jax.device_put(keys, sh),
                    {"x": jax.device_put(vals, sh)},
                    jax.device_put(panes, sh), np.int32(frontier))
        ot = step_t(*st, _t(keys), {"x": _t(vals)}, _t(panes), frontier)
        _same_forest_step(oj, ot, F)
        sj, st = oj[:5], ot[:5]
        rv, rx, rw = ot[6].numpy(), ot[5]["x"].numpy(), ot[7].numpy()
        for krow, r in zip(*np.nonzero(rv)):
            fired[(krow, int(rw[krow, r]))] = float(rx[krow, r])
    for (k, w), got in sorted(fired.items()):
        expect = sum(pane_sums.get((k, p), 0.0) for p in range(w, w + WIN))
        assert got == expect, (k, w, got, expect)
    assert len(fired) > 10


@pytest.mark.parametrize("late_policy", ["keep_open", "ref_fired"])
@pytest.mark.parametrize("shape", [(8, 1), (2, 4)])
def test_sharded_ffat_forest_slide_gt_one(shape, late_policy):
    """Non-unit slide (window w covers panes [w*slide, w*slide+win)) and
    late tuples behind the frontier, under both late policies."""
    WIN, SLIDE = 5, 2
    mj, sj, step_j, st, step_t, (K_pad, _, GB) = _forest_pair(
        shape, 9, WIN, SLIDE, 16, 2, late_policy)
    F = st[0]["x"].shape[1] // 2
    sh = _sh(mj)
    rng = np.random.default_rng(11)
    n_fired = 0
    for it in range(8):
        keys = rng.integers(0, 9, GB).astype(np.int32)
        vals = rng.integers(1, 6, GB).astype(np.float32)
        # a few panes behind the frontier: the late rule drops them
        panes = (rng.integers(-3, 3, GB) + it * 2).astype(np.int32)
        panes = np.maximum(panes, 0)
        oj = step_j(*sj, jax.device_put(keys, sh),
                    {"x": jax.device_put(vals, sh)},
                    jax.device_put(panes, sh), np.int32(it * 2 + 2))
        ot = step_t(*st, _t(keys), {"x": _t(vals)}, _t(panes), it * 2 + 2)
        _same_forest_step(oj, ot, F)
        sj, st = oj[:5], ot[:5]
        n_fired += int(ot[6].sum())
    assert n_fired > 10
