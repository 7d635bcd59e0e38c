"""The port's mesh over card groups (``windflow_tpu_torch/mesh/core.py``):
the 8 virtual devices placed on 2, 4 and 8 groups
(``ensure_virtual_devices(8, group_devices=["cpu"] * g)``), every
exchange between groups a copy into a buffer of the receiving group, held
against two references on the same inputs, made from numpy seeds:

- the one-group stacked mesh of the same shape: EXACT (ints, and
  integer-valued float32 values, whose partial sums stay integers below
  2^24 however the additions group);
- the JAX package's 8-device mesh on its conftest's virtual CPU devices,
  under the tolerances ``tests/test_torch_mesh.py`` states: exact for the
  routing, the window queries and the FFAT forest; ``rtol=1e-6,
  atol=1e-5`` for the pane accumulators' float sums (the port groups them
  by shard and group, the JAX package by its own scatter).

Shapes (8, 1), (4, 2) and (2, 4). At (4, 2) over 8 groups and at (2, 4)
over 4 or 8 groups a key shard's data replicas lie on several groups, so
the ``'data'`` merge crosses groups; meshes built straight from
``KeyMesh`` add uneven groups (a degraded layout)."""

import functools

import numpy as np
import pytest
import torch

import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from windflow_tpu.mesh import core as cj
from windflow_tpu_torch.basic import WindFlowError
from windflow_tpu_torch.mesh import core as ct

SHAPES = [(8, 1), (4, 2), (2, 4)]
CASES = [(s, g) for s in SHAPES for g in (2, 4, 8)]
IDS = [f"{s[0]}x{s[1]}-g{g}" for s, g in CASES]
CROSSING = [((4, 2), 8), ((2, 4), 4), ((2, 4), 8)]
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def virtual_devices():
    """8 virtual devices on the CPU and no excluded device; the
    process-wide registries (count, groups, exclusions) go back to what
    they were (other port test files share the worker)."""
    prev = (ct.virtual_device_count(), ct.virtual_device_groups(),
            ct.excluded_device_ids())
    ct.ensure_virtual_devices(8)
    ct.set_excluded_devices(())
    yield
    ct.ensure_virtual_devices(prev[0], group_devices=prev[1])
    ct.set_excluded_devices(prev[2])


def _mesh(shape, groups):
    ct.ensure_virtual_devices(8, group_devices=[CPU] * groups
                              if groups > 1 else None)
    mesh = ct.make_key_mesh(8, shape=shape, device="cpu")
    assert mesh.n_groups == groups
    return mesh


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lanes(mesh, a, per_shard):
    """A global shard-order column as the mesh's per-group operand."""
    return mesh.split(a, mesh.lane_sizes(per_shard))


def _np(x):
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x.numpy()


def _joined(mesh, x):
    return _np(mesh.join(x))


def _jmesh(shape):
    return cj.make_key_mesh(8, shape=shape)


def _sh(mesh):
    return NamedSharding(mesh, P(("key", "data")))


# ---------------------------------------------------------------------------
# devices, groups and placement
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_groups_take_contiguous_blocks(case):
    shape, g = case
    mesh = _mesh(shape, g)
    per = 8 // g
    assert [(x.lo, x.hi) for x in mesh.groups] == \
        [(i * per, (i + 1) * per) for i in range(g)]
    assert mesh.cards == ["cpu"] and mesh.device == CPU
    assert mesh.device_ids == list(range(8))
    assert [i for i, _ in ct.visible_devices("cpu")] == list(range(8))
    da = shape[1]
    keys = mesh.key_groups()
    # every key shard has exactly one home; its rows are on that group
    homes = [i for k in keys for i in range(*k.home)]
    assert homes == list(range(shape[0]))
    assert sum(mesh.key_row_sizes(3)) == shape[0] * 3
    for x, k in zip(mesh.groups, keys):
        if x.lo % da:
            assert k.foreign_home == mesh.group_of((x.lo // da) * da)
        else:
            assert k.foreign_home is None
    assert (case in CROSSING) == any(k.foreign_home is not None
                                     for k in keys)


def test_group_registry_validation_and_default():
    with pytest.raises(WindFlowError, match="equal groups"):
        ct.ensure_virtual_devices(8, group_devices=[CPU] * 3)
    with pytest.raises(WindFlowError, match="equal groups"):
        ct.ensure_virtual_devices(0, group_devices=[CPU])
    with pytest.raises(WindFlowError, match="unsupported"):
        ct.ensure_virtual_devices(8, group_devices=["meta", "meta"])
    ct.ensure_virtual_devices(8, group_devices=["cpu", "cpu"])
    assert ct.virtual_device_groups() == [CPU, CPU]
    # the default: one group on the graph's device
    ct.ensure_virtual_devices(8)
    assert ct.virtual_device_groups() is None
    assert ct.make_key_mesh(8, device="cpu").n_groups == 1


def test_keymesh_over_physical_devices_builds_groups():
    """Without labels a group is a device: two physical devices, two
    groups."""
    mesh = ct.KeyMesh((2, 1), [(0, CPU), (1, torch.device("meta"))])
    assert mesh.n_groups == 2 and mesh.cards == ["cpu", "meta"]
    # a group is one contiguous block of shards
    with pytest.raises(ValueError, match="contiguous"):
        ct.KeyMesh((4, 1), [(i, CPU) for i in range(4)],
                   groups=[0, 1, 0, 1])


def test_lost_group_leaves_the_other_groups():
    """Excluding every virtual id of the second group: the rebuilt mesh
    spans the first group only; excluding part of a group keeps the rest
    of it as a smaller group."""
    ct.ensure_virtual_devices(8, group_devices=[CPU, CPU])
    ct.set_excluded_devices((4, 5, 6, 7))
    mesh = ct.make_key_mesh(8, shape=(4, 2), device="cpu")
    assert mesh.ns == 4 and mesh.n_groups == 1
    assert mesh.device_ids == [0, 1, 2, 3]
    ct.set_excluded_devices((3,))
    mesh = ct.make_key_mesh(8, device="cpu")
    assert [(x.lo, x.hi) for x in mesh.groups] == [(0, 3), (3, 7)]


# ---------------------------------------------------------------------------
# routing primitives
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _owner_inputs(shape):
    ka = shape[0]
    k_local, B = 5, 12
    rng = np.random.default_rng(17)
    keys = rng.integers(0, ka * k_local, 8 * B).astype(np.int32)
    keys[rng.random(8 * B) < 0.25] = -1  # padding lanes
    panes = rng.integers(0, 50, 8 * B).astype(np.int32)
    vals = rng.integers(-9, 9, 8 * B).astype(np.int32)
    return k_local, B, keys, panes, vals


@functools.lru_cache(maxsize=None)
def _jax_owners(shape):
    k_local, B, keys, panes, vals = _owner_inputs(shape)
    mesh = _jmesh(shape)

    def local(k, p, v):
        rk, rp, rv, valid, lk = cj._route_to_owners(
            shape[0], k_local, B, k, p, {"v": v})
        return rk, rp, rv["v"], valid, lk

    spec = P(("key", "data"))
    f = cj.wf_shard_map(local, mesh=mesh, in_specs=(spec,) * 3,
                        out_specs=(spec,) * 5, check_vma=False)
    sh = _sh(mesh)
    return [np.asarray(a) for a in jax.jit(f)(
        jax.device_put(keys, sh), jax.device_put(panes, sh),
        jax.device_put(vals, sh))]


def _port_owners(mesh, shape):
    k_local, B, keys, panes, vals = _owner_inputs(shape)
    out = ct._route_to_owners(
        mesh, k_local, B, _lanes(mesh, keys, B), _lanes(mesh, panes, B),
        _lanes(mesh, {"v": vals}, B))
    rk, rp, rv, valid, lk = (_joined(mesh, x) for x in out)
    return [a.reshape(-1) for a in (rk, rp, rv["v"], valid, lk)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_route_to_owners_over_groups(case):
    shape, g = case
    one = _port_owners(_mesh(shape, 1), shape)
    got = _port_owners(_mesh(shape, g), shape)
    ref = _jax_owners(shape)
    for name, o, r, x in zip(("keys", "panes", "vals", "valid", "lkey"),
                             one, ref, got):
        assert np.array_equal(x, o), name
        assert np.array_equal(x, r), name


@functools.lru_cache(maxsize=None)
def _flat_inputs():
    k_local, B = 3, 10
    rng = np.random.default_rng(5)
    slots = rng.integers(0, 8 * k_local, 8 * B).astype(np.int32)
    slots[rng.random(8 * B) < 0.3] = -1
    gpos = np.arange(8 * B, dtype=np.int32)
    vals = rng.standard_normal(8 * B).astype(np.float32)
    return k_local, B, slots, gpos, vals


@functools.lru_cache(maxsize=None)
def _jax_flat(shape):
    k_local, B, slots, gpos, vals = _flat_inputs()
    mesh = _jmesh(shape)

    def local(s, a, v):
        rs, ra, rv, valid, lk, order, flat, ok = cj._route_flat(
            8, k_local, B, s, a, {"v": v})
        back = cj._route_back(8, B, ra, order, flat, ok, fill=-7)
        return rs, ra, rv["v"], valid, lk, back

    spec = P(cj.MESH_AXES)
    f = cj.wf_shard_map(local, mesh=mesh, in_specs=(spec,) * 3,
                        out_specs=(spec,) * 6, check_vma=False)
    sh = _sh(mesh)
    return [np.asarray(a) for a in jax.jit(f)(
        jax.device_put(slots, sh), jax.device_put(gpos, sh),
        jax.device_put(vals, sh))]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_route_flat_and_back_over_groups(case):
    shape, g = case
    k_local, B, slots, gpos, vals = _flat_inputs()
    outs = []
    for n in (1, g):
        mesh = _mesh(shape, n)
        rs, ra, rv, valid, lk, maps = ct._route_flat_groups(
            mesh, k_local, B, _lanes(mesh, slots, B), _lanes(mesh, gpos, B),
            _lanes(mesh, {"v": vals}, B))
        back = ct._route_back_groups(mesh, B, ra, maps, fill=-7)
        outs.append([_joined(mesh, x) for x in (rs, ra, rv, valid, lk,
                                                back)])
    one, got = outs
    one[2], got[2] = one[2]["v"], got[2]["v"]
    ref = _jax_flat(shape)
    for name, o, r, x in zip(("slots", "aux", "vals", "valid", "lkey",
                              "back"), one, ref, got):
        assert np.array_equal(x, o), name
        assert np.array_equal(x, r), name
    assert np.array_equal(got[5], gpos)  # every lane back at its arrival


# ---------------------------------------------------------------------------
# the key-sharded steps
# ---------------------------------------------------------------------------
N_KEYS, N_PANES, LB = 32, 8, 16


def _keyby_batches():
    rng = np.random.default_rng(4)
    gb = 8 * LB
    out = []
    for _ in range(3):
        keys = rng.integers(0, N_KEYS, gb).astype(np.int32)
        keys[rng.random(gb) < 0.1] = -1
        vals = rng.integers(0, 100, gb).astype(np.float32)
        panes = rng.integers(0, 3 * N_PANES, gb).astype(np.int32)
        out.append((keys, vals, panes))
    return out


def _port_keyby(mesh):
    st, cnt = ct.make_sharded_state(mesh, N_KEYS, N_PANES)
    step, nkp, gb = ct.sharded_keyby_window_step(mesh, N_KEYS, N_PANES, LB)
    n = 0
    for keys, vals, panes in _keyby_batches():
        st, cnt, nt = step(st, cnt, _lanes(mesh, keys, LB),
                           _lanes(mesh, vals, LB), _lanes(mesh, panes, LB))
        n += sum(int(x) for x in (nt if isinstance(nt, list) else [nt]))
    return _joined(mesh, st), _joined(mesh, cnt), n


@functools.lru_cache(maxsize=None)
def _jax_keyby(shape):
    mesh = _jmesh(shape)
    st, cnt = cj.make_sharded_state(mesh, N_KEYS, N_PANES)
    step, _, _ = cj.sharded_keyby_window_step(mesh, N_KEYS, N_PANES, LB)
    sh = _sh(mesh)
    for keys, vals, panes in _keyby_batches():
        st, cnt, _ = step(st, cnt, jax.device_put(keys, sh),
                          jax.device_put(vals, sh),
                          jax.device_put(panes, sh))
    return np.asarray(st), np.asarray(cnt)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_keyby_window_step_over_groups(case):
    shape, g = case
    st1, cnt1, n1 = _port_keyby(_mesh(shape, 1))
    st, cnt, n = _port_keyby(_mesh(shape, g))
    assert n == n1 == sum(int((k >= 0).sum()) for k, _, _ in
                          _keyby_batches())
    assert np.array_equal(cnt, cnt1) and np.array_equal(st, st1)
    sj, cntj = _jax_keyby(shape)
    assert np.array_equal(cnt, cntj)
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=1e-5)


WIN, SLIDE, FOREST_KEYS, FOREST_LB, ROUNDS = 4, 1, 13, 32, 3


def _forest_batches():
    rng = np.random.default_rng(3)
    gb = 8 * FOREST_LB
    out = []
    for it in range(6):
        keys = rng.integers(0, FOREST_KEYS, gb).astype(np.int32)
        keys[rng.random(gb) < 0.1] = -1
        vals = rng.integers(1, 10, gb).astype(np.float32)
        panes = (rng.integers(-1, 3, gb) + it * 2).clip(0).astype(np.int32)
        out.append((keys, vals, panes, it * 2 + 2))
    return out


def _lift(v):
    return {"x": v["x"]}


def _comb(a, b):
    return {"x": a["x"] + b["x"]}


def _port_forest(mesh, late_policy="keep_open"):
    """Every step's outputs, joined over the groups, and K1's calls."""
    calls = []
    init, step, meta = ct.sharded_ffat_forest(
        mesh, _lift, _comb, n_keys=FOREST_KEYS, win_panes=WIN,
        slide_panes=SLIDE, local_batch=FOREST_LB, fire_rounds=ROUNDS,
        late_policy=late_policy, on_rebuild=lambda: calls.append(1))
    st = init({"x": np.zeros(1, np.float32)})
    steps = []
    for keys, vals, panes, frontier in _forest_batches():
        out = step(*st, _lanes(mesh, keys, FOREST_LB),
                   _lanes(mesh, {"x": vals}, FOREST_LB),
                   _lanes(mesh, panes, FOREST_LB), frontier)
        st = out[:5]
        counts = [out[8], out[9]] if mesh.n_groups == 1 else \
            [sum(out[8]), sum(out[9])]
        steps.append([_joined(mesh, x) for x in out[:8]]
                     + [int(c) for c in counts])
    return steps, len(calls), meta


@functools.lru_cache(maxsize=None)
def _jax_forest(shape, late_policy="keep_open"):
    mesh = _jmesh(shape)
    init, step, _ = cj.sharded_ffat_forest(
        mesh, _lift, _comb, n_keys=FOREST_KEYS, win_panes=WIN,
        slide_panes=SLIDE, local_batch=FOREST_LB, fire_rounds=ROUNDS,
        late_policy=late_policy)
    st = init({"x": np.zeros(1, np.float32)})
    sh = _sh(mesh)
    steps = []
    for keys, vals, panes, frontier in _forest_batches():
        out = step(*st, jax.device_put(keys, sh),
                   {"x": jax.device_put(vals, sh)},
                   jax.device_put(panes, sh), np.int32(frontier))
        st = out[:5]
        steps.append([np.asarray(x) if not isinstance(x, dict)
                      else {k: np.asarray(v) for k, v in x.items()}
                      for x in out])
    return steps


def _same_step(a, b, F, leaves_only):
    sl = np.s_[:, F:] if leaves_only else np.s_[:, :]
    assert np.array_equal(a[0]["x"][sl], b[0]["x"][sl])
    assert np.array_equal(a[1][sl], b[1][sl])
    for i in (2, 3, 4, 6, 7):
        assert np.array_equal(a[i], b[i]), i
    assert np.array_equal(a[5]["x"], b[5]["x"])
    assert int(a[8]) == int(b[8]) and int(a[9]) == int(b[9])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ffat_forest_over_groups(case):
    """Every step's outputs equal the one-group mesh's, internal levels
    included, and the JAX package's (leaves: the JAX step skips the level
    rebuild when no key can fire); K1 runs once per group that holds
    forest rows, on every step."""
    shape, g = case
    one, calls1, meta1 = _port_forest(_mesh(shape, 1))
    mesh = _mesh(shape, g)
    got, calls, meta = _port_forest(mesh)
    assert meta == meta1
    F = one[0][0]["x"].shape[1] // 2
    ref = _jax_forest(shape)
    n_fired = 0
    for o, x, r in zip(one, got, ref):
        _same_step(x, o, F, leaves_only=False)
        _same_step(x, r, F, leaves_only=True)
        n_fired += int(x[6].sum())
    assert n_fired > 10
    holders = sum(1 for k in mesh.key_groups() if k.n_home)
    assert calls1 == len(one) and calls == holders * len(got)
    assert holders == (g if shape[1] <= 8 // g else shape[0])


@pytest.mark.parametrize("case", CROSSING, ids=["4x2-g8", "2x4-g4",
                                                "2x4-g8"])
def test_ffat_forest_ref_fired_policy_over_groups(case):
    """The ``ref_fired`` late rule reads each key's ``next_fire`` on the
    receiving group: where the merge crosses groups, the home's rows are
    copied there first."""
    shape, g = case
    one, _, _ = _port_forest(_mesh(shape, 1), "ref_fired")
    got, _, _ = _port_forest(_mesh(shape, g), "ref_fired")
    ref = _jax_forest(shape, "ref_fired")
    F = one[0][0]["x"].shape[1] // 2
    assert sum(x[9] for x in got) > 0  # some tuples were late
    for o, x, r in zip(one, got, ref):
        _same_step(x, o, F, leaves_only=False)
        _same_step(x, r, F, leaves_only=True)


def _uneven_mesh(shape, labels):
    return ct.KeyMesh(shape, [(i, CPU) for i in range(len(labels))],
                      groups=labels)


@pytest.mark.parametrize("shape,labels", [
    ((3, 2), [0, 0, 0, 1, 1, 1]),
    ((7, 1), [0, 0, 0, 1, 1, 1, 1]),
    ((2, 4), [0, 0, 0, 1, 1, 2, 2, 2]),
], ids=["3x2-3+3", "7x1-3+4", "2x4-3+2+3"])
def test_uneven_groups_match_one_group(shape, labels):
    """Groups of unequal blocks, as a partial exclusion leaves them: the
    forest and the pane accumulators equal the one-group mesh's."""
    mesh = _uneven_mesh(shape, labels)
    one_mesh = _uneven_mesh(shape, [0] * len(labels))
    ns = len(labels)

    def lanes(m, a, per):
        return m.split(a, m.lane_sizes(per))

    outs = []
    for m in (one_mesh, mesh):
        init, step, _ = ct.sharded_ffat_forest(
            m, _lift, _comb, n_keys=FOREST_KEYS, win_panes=WIN,
            slide_panes=SLIDE, local_batch=8, fire_rounds=ROUNDS)
        st = init({"x": np.zeros(1, np.float32)})
        rng = np.random.default_rng(8)
        fired = []
        for it in range(4):
            keys = rng.integers(-1, FOREST_KEYS, ns * 8).astype(np.int32)
            vals = rng.integers(1, 10, ns * 8).astype(np.float32)
            panes = (rng.integers(0, 3, ns * 8) + it * 2).astype(np.int32)
            out = step(*st, lanes(m, keys, 8), lanes(m, {"x": vals}, 8),
                       lanes(m, panes, 8), it * 2 + 2)
            st = out[:5]
            fired.append([_joined(m, x) for x in out[:8]])
        sk, ck = ct.make_sharded_state(m, N_KEYS, N_PANES)
        kstep, _, _ = ct.sharded_keyby_window_step(m, N_KEYS, N_PANES, 8)
        keys = rng.integers(-1, N_KEYS, ns * 8).astype(np.int32)
        sk, ck, _ = kstep(sk, ck, lanes(m, keys, 8),
                          lanes(m, (keys % 7).astype(np.float32), 8),
                          lanes(m, keys.clip(0), 8))
        outs.append((fired, _joined(m, sk), _joined(m, ck)))
    (f1, s1, c1), (f2, s2, c2) = outs
    assert np.array_equal(s1, s2) and np.array_equal(c1, c2)
    for a, b in zip(f1, f2):
        assert np.array_equal(a[0]["x"], b[0]["x"])
        for i in (1, 2, 3, 4, 6, 7):
            assert np.array_equal(a[i], b[i]), i
        assert np.array_equal(a[5]["x"], b[5]["x"])


@pytest.mark.parametrize("win,slide", [(4, 2), (7, 3)])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_ring_pane_window_query_over_groups(case, win, slide):
    shape, g = case
    p_local = 16
    P_total = shape[0] * p_local
    rng = np.random.default_rng(9)
    panes = rng.integers(0, 100, P_total).astype(np.float32)
    outs = []
    for n in (1, g):
        mesh = _mesh(shape, n)
        fn, nw = ct.ring_pane_window_query(mesh, P_total, win, slide)
        outs.append(fn(mesh.split(panes, mesh.key_row_sizes(p_local)))
                    .numpy())
    fn_j, nw_j = cj.ring_pane_window_query(_jmesh(shape), P_total, win,
                                           slide)
    ref = np.asarray(fn_j(jax.device_put(panes)))
    assert nw == nw_j
    assert np.array_equal(outs[1], outs[0]) and np.array_equal(outs[1], ref)


# ---------------------------------------------------------------------------
# the flat-owner plane
# ---------------------------------------------------------------------------
KEY_CAP, SCAN_LB = 40, 8


def _scan_fn(row, st):
    return {"v": row["v"], "run": st + row["v"]}, st + row["v"]


def _keep_fn(row, st):
    return (st + row["v"]) % 3 != 0, st + row["v"]


def _scan_batches(seed=21):
    rng = np.random.default_rng(seed)
    gb = 8 * SCAN_LB
    out = []
    for _ in range(3):
        slots = rng.integers(0, KEY_CAP, gb).astype(np.int32)
        slots[rng.random(gb) < 0.2] = -1
        vals = rng.integers(0, 50, gb).astype(np.int32)
        out.append((slots, vals))
    return out


def _M(slots):
    mx = max(1, int(np.bincount(slots[slots >= 0]).max()))
    return 1 << (mx - 1).bit_length()


def _port_scan(mesh, filter_mode):
    fn = _keep_fn if filter_mode else _scan_fn
    table = None
    outs = []
    for slots, vals in _scan_batches():
        step, (K_pad, _, GB) = ct.sharded_grid_scan(
            mesh, fn, filter_mode, KEY_CAP, _M(slots), SCAN_LB)
        if table is None:
            table = ct.make_mesh_table(mesh, np.int32(0), K_pad)
        gpos = np.arange(GB, dtype=np.int32)
        table, out, _ = step(table, _lanes(mesh, slots, SCAN_LB),
                             _lanes(mesh, gpos, SCAN_LB),
                             _lanes(mesh, {"v": vals}, SCAN_LB))
        outs.append(_joined(mesh, out))
    return outs, ct.host_tree(mesh, table)


@functools.lru_cache(maxsize=None)
def _jax_scan(shape, filter_mode):
    import jax.numpy as jnp
    mesh = _jmesh(shape)
    fn = _keep_fn if filter_mode else _scan_fn
    sh = _sh(mesh)
    table, outs = None, []
    for slots, vals in _scan_batches():
        step, (K_pad, _, GB) = cj.sharded_grid_scan(
            mesh, fn, filter_mode, KEY_CAP, _M(slots), SCAN_LB)
        if table is None:
            table = cj.make_mesh_table(mesh, jnp.int32(0), K_pad)
        table, out, _ = step(table, jax.device_put(slots, sh),
                             jax.device_put(np.arange(GB, dtype=np.int32),
                                            sh),
                             {"v": jax.device_put(vals, sh)})
        outs.append(np.asarray(out) if filter_mode
                    else {k: np.asarray(v) for k, v in out.items()})
    return outs, np.asarray(table)


@pytest.mark.parametrize("filter_mode", [False, True], ids=["map", "filter"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_grid_scan_over_groups(case, filter_mode):
    """The tables and every real lane's output equal the one-group mesh's
    and the JAX package's (a padding lane's output is never emitted: the
    filter masks it, the map's value there is unspecified)."""
    shape, g = case
    one, t1 = _port_scan(_mesh(shape, 1), filter_mode)
    got, tg = _port_scan(_mesh(shape, g), filter_mode)
    ref, tj = _jax_scan(shape, filter_mode)
    assert np.array_equal(tg, t1) and np.array_equal(tg, tj)
    for o, x, r, (slots, _) in zip(one, got, ref, _scan_batches()):
        if filter_mode:
            assert np.array_equal(x, o) and np.array_equal(x, r)
            assert not x[slots < 0].any()
        else:
            live = slots >= 0
            for f in ("v", "run"):
                assert np.array_equal(x[f][live], o[f][live]), f
                assert np.array_equal(x[f][live], r[f][live]), f


def _sum_v(a, b):
    return {"v": a["v"] + b["v"]}


def _port_reduce(mesh):
    step, _ = ct.sharded_keyed_reduce(mesh, _sum_v, KEY_CAP, SCAN_LB)
    outs = []
    for slots, vals in _scan_batches(22):
        res, touched, n = step(_lanes(mesh, slots, SCAN_LB),
                               _lanes(mesh, {"v": vals, "w": vals * 2},
                                      SCAN_LB))
        outs.append((_joined(mesh, res), _joined(mesh, touched)))
    return outs


@functools.lru_cache(maxsize=None)
def _jax_reduce(shape):
    mesh = _jmesh(shape)
    step, _ = cj.sharded_keyed_reduce(mesh, _sum_v, KEY_CAP, SCAN_LB)
    sh = _sh(mesh)
    outs = []
    for slots, vals in _scan_batches(22):
        res, touched, _ = step(jax.device_put(slots, sh),
                               {"v": jax.device_put(vals, sh),
                                "w": jax.device_put(vals * 2, sh)})
        outs.append(({k: np.asarray(v) for k, v in res.items()},
                     np.asarray(touched)))
    return outs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_keyed_reduce_over_groups(case):
    shape, g = case
    one = _port_reduce(_mesh(shape, 1))
    got = _port_reduce(_mesh(shape, g))
    for (r1, t1), (rg, tg), (rj, tj) in zip(one, got, _jax_reduce(shape)):
        assert np.array_equal(tg, t1) and np.array_equal(tg, tj)
        for f in ("v", "w"):
            assert np.array_equal(rg[f], r1[f]) and np.array_equal(rg[f],
                                                                   rj[f])


# ---------------------------------------------------------------------------
# no exchange aliases another group's memory
# ---------------------------------------------------------------------------
def _storages(x):
    if isinstance(x, dict):
        return {p for v in x.values() for p in _storages(v)}
    if isinstance(x, (list, tuple)):
        return {p for v in x for p in _storages(v)}
    return {x.untyped_storage().data_ptr()} if x.numel() else set()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_groups_share_no_storage(case):
    """Every group's state (pane accumulators, forest, flat-owner table)
    and its receive buffers (owner and flat shuffles, the route back) sit
    in storages no other group holds; every exchange between groups
    copies (the mesh's tally counts the bytes)."""
    shape, g = case
    mesh = _mesh(shape, g)
    per_group = [set() for _ in range(g)]
    alive = []  # held, so that no freed storage is reused meanwhile

    def add(xs):
        for G, x in enumerate(xs):
            alive.append(x)
            per_group[G] |= _storages(x)

    add(zip(*ct.make_sharded_state(mesh, N_KEYS, N_PANES)))
    init, _, _ = ct.sharded_ffat_forest(mesh, _lift, _comb, FOREST_KEYS,
                                        WIN, SLIDE, FOREST_LB)
    add(zip(*init({"x": np.zeros(1, np.float32)})))
    add(ct.make_mesh_table(mesh, {"a": np.int32(0), "b": np.float32(1)},
                           KEY_CAP))
    assert mesh.copied_bytes == 0
    k_local, B, keys, panes, vals = _owner_inputs(shape)
    add(zip(*ct._route_to_owners(mesh, k_local, B, _lanes(mesh, keys, B),
                                 _lanes(mesh, panes, B),
                                 _lanes(mesh, {"v": vals}, B))))
    k_local, B, slots, gpos, fv = _flat_inputs()
    rs, ra, rv, valid, lk, maps = ct._route_flat_groups(
        mesh, k_local, B, _lanes(mesh, slots, B), _lanes(mesh, gpos, B),
        _lanes(mesh, {"v": fv}, B))
    add(zip(rs, ra, rv, valid, lk))
    add(ct._route_back_groups(mesh, B, ra, maps))
    for a in range(g):
        for b in range(a + 1, g):
            assert not per_group[a] & per_group[b], (a, b)
    assert mesh.copied_bytes > 0


def test_one_group_copies_nothing():
    mesh = _mesh((4, 2), 1)
    k_local, B, keys, panes, vals = _owner_inputs((4, 2))
    ct._route_to_owners(mesh, k_local, B, _t(keys), _t(panes),
                        {"v": _t(vals)})
    assert mesh.copied_bytes == 0
