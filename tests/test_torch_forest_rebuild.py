"""The port's plain forest rebuild (``windflow_tpu_torch.kernels.reference``)
held against the JAX package's Pallas kernel, run in interpret mode as
``tests/test_pallas_kernels.py`` runs it. Inputs are made with numpy from a
seed; stale internal nodes are garbage and must be fully recomputed.
Tolerance: exact equality on every valid node and on the validity plane
(the pairing of the fold is the same, so even float sums agree bit for
bit). The traced combines of ``torch_combines.py`` (run by the port as the
user's torch combine, by JAX as its ``jnp`` twin) are exact too on int and
bool planes and bitwise on float planes, except ``mean_last``'s mean,
where a product meets a sum: XLA's CPU backend may contract that into an
FMA, so it is held to ``rtol=1e-6``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_combines as tc
from windflow_tpu.tpu.pallas_kernels import make_forest_rebuild
from windflow_tpu_torch import WindFlowError, fieldwise
from windflow_tpu_torch.kernels import forest_rebuild as fr
from windflow_tpu_torch.kernels.reference import forest_rebuild_ref

_JNP_OPS = {"sum": lambda a, b: a + b, "min": jnp.minimum,
            "max": jnp.maximum}

SPECS = [("sum",), ("min", "max"), ("max", "sum")]


def _forest(F, K, dtype, n_fields, seed):
    rng = np.random.default_rng(seed)
    planes = []
    for _ in range(n_fields):
        if dtype == np.int32:
            p = rng.integers(-1000, 1000, (K, 2 * F)).astype(np.int32)
        else:
            p = rng.standard_normal((K, 2 * F)).astype(np.float32)
        p[:, :F] = rng.integers(-10**6, 10**6, (K, F)).astype(dtype)
        planes.append(p)
    valid = np.zeros((K, 2 * F), dtype=bool)
    valid[:, F:] = rng.random((K, F)) < 0.6
    valid[:, :F] = rng.random((K, F)) < 0.5  # stale internal validity
    return planes, valid


def _jax_rebuild(planes, valid, spec, F):
    names = [f"f{i}" for i in range(len(spec))]
    ops = dict(zip(names, spec))

    def combine(a, b):
        return {n: _JNP_OPS[ops[n]](a[n], b[n]) for n in names}

    K = valid.shape[0]
    pad = max(0, 8 - K)  # the Pallas kernel tiles rows by 8; rows are
    # independent, so zero rows pad a small forest and are sliced off

    def padded(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    rebuild = make_forest_rebuild(combine, names, F, interpret=True)
    trees, tvalid = rebuild({n: jnp.asarray(padded(p))
                             for n, p in zip(names, planes)},
                            jnp.asarray(padded(valid)))
    return ([np.asarray(trees[n])[:K] for n in names],
            np.asarray(tvalid)[:K])


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: "-".join(s))
@pytest.mark.parametrize("dtype", [np.int32, np.float32],
                         ids=["int32", "float32"])
@pytest.mark.parametrize("F,K", [(8, 8), (32, 16), (64, 8), (8, 4)])
def test_forest_rebuild_ref_matches_pallas(F, K, dtype, spec):
    planes, valid = _forest(F, K, dtype, len(spec), seed=F * 131 + K)
    exp, expv = _jax_rebuild(planes, valid, spec, F)
    names = [f"f{i}" for i in range(len(spec))]
    trees = {n: torch.from_numpy(p.copy()) for n, p in zip(names, planes)}
    tvalid = torch.from_numpy(valid.copy())
    out, outv = forest_rebuild_ref(trees, tvalid,
                                   fieldwise(**dict(zip(names, spec))))
    gotv = outv.numpy()
    assert (gotv[:, 1:] == expv[:, 1:]).all()
    live = expv[:, 1:]
    for n, e in zip(names, exp):
        got = out[n].numpy()
        assert got.dtype == e.dtype
        assert (got[:, 1:][live] == e[:, 1:][live]).all()
        # leaves and node 0 are untouched; the update is in place
        assert (got[:, F:] == planes[names.index(n)][:, F:]).all()
        assert out[n] is trees[n]


def test_forest_rebuild_wrapper_cpu_uses_plain_version():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; on a device with no kernel it raises instead of falling back."""
    planes, valid = _forest(16, 4, np.int32, 1, seed=5)
    comb = fieldwise(f0="sum")
    a = {"f0": torch.from_numpy(planes[0].copy())}
    b = {"f0": torch.from_numpy(planes[0].copy())}
    va, vb = torch.from_numpy(valid.copy()), torch.from_numpy(valid.copy())
    before = fr.LAUNCHES
    fr.forest_rebuild(a, va, comb)
    forest_rebuild_ref(b, vb, comb)
    assert fr.LAUNCHES == before
    assert torch.equal(a["f0"], b["f0"]) and torch.equal(va, vb)
    with pytest.raises(WindFlowError):
        fr.forest_rebuild({"f0": torch.zeros(4, 32, dtype=torch.int32,
                                             device="meta")},
                          torch.zeros(4, 32, dtype=torch.bool,
                                      device="meta"), comb)


def test_fieldwise_rejects_unknown_ops():
    with pytest.raises(WindFlowError):
        fieldwise(v="mean")


# ---------------------------------------------------------------------------
# The CUDA kernel's launch plan, emulated on the CPU. ``launch_plan`` picks
# a regime per pass (warp, cta or chunk; see forest_rebuild.cu) and its
# geometry; the emulation below folds chunk by chunk exactly as the plan and
# the kernel's index formulas say, with torch ops, and must equal the plain
# version bit for bit (values as int32 bit patterns, and validity).

def _pick(comb, l, r, vl, vr):
    """node = combine(l, r) when both are valid, else the valid one, in
    the plane's dtype (the plain version's store casts a promoted
    ``where`` back)."""
    m = comb(l, r)
    return {k: torch.where(vl & vr, m[k], torch.where(vl, l[k], r[k]))
            .to(l[k].dtype) for k in l}


def _fold_chunks(comb, v, vb, W, S, E, c, dst, dstv):
    """Lane-group fold of chunks: row n's chunk c[n] holds nodes
    [W + c*S, W + (c+1)*S) of level W (v: name -> (N, S), vb: (N, S)),
    L = S / E lanes of E nodes. In-lane level d writes E >> d nodes per
    lane at (W >> d) + c*(S >> d) + sub*(E >> d); cross-lane step s writes
    node (W >> (log2 E + s)) + c*(L >> s) + (sub >> s)."""
    N = vb.shape[0]
    L = S // E
    lE = E.bit_length() - 1
    sub = torch.arange(L)
    v = {k: t.reshape(N, L, E) for k, t in v.items()}
    vb = vb.reshape(N, L, E)
    for d in range(1, lE + 1):
        n = E >> d
        v = _pick(comb, {k: t[..., 0::2] for k, t in v.items()},
                  {k: t[..., 1::2] for k, t in v.items()},
                  vb[..., 0::2], vb[..., 1::2])
        vb = vb[..., 0::2] | vb[..., 1::2]
        pos = ((W >> d) + c[:, None, None] * (S >> d)
               + sub[None, :, None] * n + torch.arange(n)[None, None, :])
        for k, t in v.items():
            dst[k].scatter_(1, pos.reshape(N, -1), t.reshape(N, -1))
        dstv.scatter_(1, pos.reshape(N, -1), vb.reshape(N, -1))
    x = {k: t[..., 0].clone() for k, t in v.items()}
    b = vb[..., 0].clone()
    s = 1
    while (1 << s) <= L:
        o = 1 << (s - 1)
        recv = sub[sub % (1 << s) == 0]
        y = _pick(comb, {k: t[:, recv] for k, t in x.items()},
                  {k: t[:, recv + o] for k, t in x.items()},
                  b[:, recv], b[:, recv + o])
        yb = b[:, recv] | b[:, recv + o]
        for k in x:
            x[k][:, recv] = y[k]
        b[:, recv] = yb
        pos = ((W >> (lE + s)) + c[:, None] * (L >> s)
               + (recv >> s)[None, :])
        for k in x:
            dst[k].scatter_(1, pos, y[k])
        dstv.scatter_(1, pos, yb)
        s += 1


def _emulate_plan(plan, trees, tvalid, comb):
    K, NN = tvalid.shape
    F = NN // 2
    for ps in plan:
        if ps.regime == "warp":
            assert ps.W == ps.S == F and F // ps.E <= 32
            out = {k: t[:, :F].clone() for k, t in trees.items()}
            outv = tvalid[:, :F].clone()
            _fold_chunks(comb, {k: t[:, F:] for k, t in trees.items()},
                         tvalid[:, F:], F, F, ps.E,
                         torch.zeros(K, dtype=torch.long), out, outv)
            for k, t in trees.items():  # nodes [0, F), node 0 its own
                t[:, :F] = out[k]
            tvalid[:, :F] = outv
        elif ps.regime == "cta":
            for row0 in range(0, K, ps.rows):  # tiles of `rows` rows
                rows = slice(row0, min(K, row0 + ps.rows))
                out = {k: t[rows, :F].clone() for k, t in trees.items()}
                outv = tvalid[rows, :F].clone()
                n = outv.shape[0]
                for i, (W, S, E) in enumerate(ps.steps):
                    src = trees if i == 0 else out
                    srcv = tvalid if i == 0 else outv
                    C = W // S
                    r = torch.arange(n).repeat_interleave(C)
                    c = torch.arange(C).repeat(n)
                    idx = (W + c * S)[:, None] + torch.arange(S)[None, :]
                    if i == 0:
                        r = r + row0
                    v = {k: t[r[:, None], idx] for k, t in src.items()}
                    vb = srcv[r[:, None], idx]
                    d = {k: torch.zeros(n * C, F, dtype=t.dtype)
                         for k, t in out.items()}
                    dv = torch.zeros(n * C, F, dtype=torch.bool)
                    mark = torch.zeros(n * C, F, dtype=torch.bool)
                    _fold_chunks(comb, v, vb, W, S, E, c, d, dv)
                    _fold_chunks(lambda a, b: a, {"m": torch.zeros(
                        n * C, S, dtype=torch.int32)}, torch.ones(
                        n * C, S, dtype=torch.bool), W, S, E, c,
                        {"m": torch.zeros(n * C, F, dtype=torch.int32)},
                        mark)
                    rr = (r - row0 if i == 0 else r)
                    for k in out:
                        out[k][rr[:, None].expand(-1, F)[mark],
                               torch.arange(F).expand(n * C, F)[mark]] = \
                            d[k][mark]
                    outv[rr[:, None].expand(-1, F)[mark],
                         torch.arange(F).expand(n * C, F)[mark]] = dv[mark]
                for k, t in trees.items():
                    t[rows, :F] = out[k]
                tvalid[rows, :F] = outv
        else:
            W, S = ps.W, ps.S
            C = W // S
            g = torch.arange(K * C)
            r, c = g // C, g % C
            idx = (W + c * S)[:, None] + torch.arange(S)[None, :]
            h = {k: torch.cat([torch.zeros(K * C, S, dtype=t.dtype),
                               t[r[:, None], idx]], 1)
                 for k, t in trees.items()}
            hv = torch.cat([torch.zeros(K * C, S, dtype=torch.bool),
                            tvalid[r[:, None], idx]], 1)
            w = S // 2
            while w >= 1:  # level by level inside the chunk's heap
                m = _pick(comb, {k: t[:, 2 * w:4 * w:2] for k, t in h.items()},
                          {k: t[:, 2 * w + 1:4 * w:2] for k, t in h.items()},
                          hv[:, 2 * w:4 * w:2], hv[:, 2 * w + 1:4 * w:2])
                for k in h:
                    h[k][:, w:2 * w] = m[k]
                hv[:, w:2 * w] = hv[:, 2 * w:4 * w:2] | hv[:, 2 * w + 1:4 * w:2]
                w //= 2
            j = torch.arange(1, S)
            dep = torch.tensor([x.bit_length() - 1 for x in j.tolist()],
                               dtype=torch.long)
            node = (((W // S) + c)[:, None] << dep[None, :]) \
                + (j - (1 << dep))[None, :]
            for k, t in trees.items():
                t[r[:, None].expand(-1, S - 1), node] = h[k][:, 1:S]
            tvalid[r[:, None].expand(-1, S - 1), node] = hv[:, 1:S]
    return trees, tvalid


_KINDS = [("int32", "sum"), ("float32", "sum"), ("float32", "min"),
          ("int32", "max"), ("int32", "min"), ("float32", "max"),
          ("int32", "sum"), ("float32", "min")]


def _mixed_forest(K, F, n_fields, seed):
    rng = np.random.default_rng(seed)
    trees, ops = {}, {}
    for i in range(n_fields):
        dt, op = _KINDS[i]
        if dt == "int32":
            a = rng.integers(-2**31, 2**31, (K, 2 * F),
                             dtype=np.int64).astype(np.int32)
        else:
            # no NaN: torch's vectorised CPU minimum/maximum return NaNs
            # with another payload than its scalar path, so bit patterns of
            # NaNs are compared on the card only (chip_smoke.py)
            a = rng.standard_normal((K, 2 * F)).astype(np.float32)
        trees[f"f{i}"] = torch.from_numpy(a)
        ops[f"f{i}"] = op
    valid = torch.from_numpy(rng.random((K, 2 * F)) < 0.6)
    return trees, valid, fieldwise(**ops)


def _same(a, av, b, bv):
    """Equal validity and planes: ints and bools bit for bit, floats bit
    for bit or both NaN (a NaN's payload follows torch's CPU path)."""
    def eq(x, y):
        if x.dtype is torch.float32:
            return bool(((x.view(torch.int32) == y.view(torch.int32))
                         | (x.isnan() & y.isnan())).all())
        return torch.equal(x, y)
    return torch.equal(av, bv) and all(eq(a[k], b[k]) for k in a)


_PLAN_CASES = [(F, K, nf, al, wmf)
               for F in [2 ** i for i in range(1, 17)]
               for K in (1, 7, 4099) if K * F <= 1 << 20
               for nf in (1, 4, 8)
               for al, wmf in ((True, fr.WARP_MAX_F), (True, 8),
                               (False, fr.WARP_MAX_F))
               if (al and wmf != 8) or (F in (16, 64, 2048) and K != 4099)]


@pytest.mark.parametrize(
    "F,K,nf,aligned,warp_max_f", _PLAN_CASES,
    ids=[f"F{F}-K{K}-{nf}f-{'al' if al else 'unal'}-w{w}"
         for F, K, nf, al, w in _PLAN_CASES])
def test_launch_plan_emulation_matches_plain(F, K, nf, aligned, warp_max_f):
    trees, valid, comb = _mixed_forest(K, F, nf, seed=F * 31 + K * 7 + nf)
    plan = fr.launch_plan(K, F, nf, aligned, warp_max_f=warp_max_f)
    et = {k: t.clone() for k, t in trees.items()}
    ev = valid.clone()
    rt = {k: t.clone() for k, t in trees.items()}
    rv = valid.clone()
    _emulate_plan(plan, et, ev, comb)
    forest_rebuild_ref(rt, rv, comb)
    assert _same(et, ev, rt, rv), plan
    # leaves and node 0 untouched
    for k in trees:
        assert torch.equal(et[k][:, F:].view(torch.int32),
                           trees[k][:, F:].view(torch.int32))
        assert torch.equal(et[k][:, 0].view(torch.int32),
                           trees[k][:, 0].view(torch.int32))


@pytest.mark.parametrize("F,K", [(8, 8), (32, 16), (64, 8)])
def test_launch_plan_emulation_matches_pallas(F, K):
    spec = ("min", "max")
    planes, valid = _forest(F, K, np.float32, len(spec), seed=F + K)
    exp, expv = _jax_rebuild(planes, valid, spec, F)
    names = [f"f{i}" for i in range(len(spec))]
    trees = {n: torch.from_numpy(p.copy()) for n, p in zip(names, planes)}
    tvalid = torch.from_numpy(valid.copy())
    _emulate_plan(fr.launch_plan(K, F, len(spec)), trees, tvalid,
                  fieldwise(**dict(zip(names, spec))))
    assert (tvalid.numpy()[:, 1:] == expv[:, 1:]).all()
    live = expv[:, 1:]
    for n, e in zip(names, exp):
        assert (trees[n].numpy()[:, 1:][live] == e[:, 1:][live]).all()


@pytest.mark.parametrize("nf", [1, 2, 3, 4, 5, 8])
def test_launch_plan_geometry(nf):
    """Every plan folds each level exactly once within the kernel's
    limits: registers (nodes per lane x fields), 32 lanes per row, shared
    memory, and the vector regimes' 16-byte alignment."""
    nb = 4 * nf + 1
    for lf in range(1, 22):
        F = 1 << lf
        for K in (1, 3, 64, 16384, 262144):
            if K * 2 * F >= 2**31 - 1:
                continue
            for aligned in (True, False):
                plan = fr.launch_plan(K, F, nf, aligned)
                assert plan
                levels = 0
                W = F
                for ps in plan:
                    assert ps.W == W and ps.S <= W and W % ps.S == 0
                    levels += ps.S.bit_length() - 1
                    assert ps.smem <= fr.SMEM_MAX
                    if ps.regime == "warp":
                        assert aligned and ps.W == ps.S == F >= 4
                        assert F // ps.E <= 32 and ps.E * nf <= 64
                        assert ps.rows == 32 * ps.E // F
                        assert ps.smem == fr.WARP_THREADS * ps.E * nb
                        assert ps.smem <= fr.SMEM_DEFAULT
                    elif ps.regime == "cta":
                        assert aligned and ps.W == ps.S == F >= 16
                        assert ps.smem == 3 * ps.rows * F * nb + 16
                        assert ps.rows == 1 or \
                            ps.rows * F * nb <= fr.CTA_TILE_BYTES
                        assert [w for w, _, _ in ps.steps][0] == F
                        assert sum(s.bit_length() - 1
                                   for _, s, _ in ps.steps) == lf
                    else:
                        assert ps.regime == "chunk" and ps.rows >= 1
                        assert ps.smem == ps.rows * 2 * ps.S * nb
                    W //= ps.S
                assert W == 1 and levels == lf
                if not aligned:
                    assert all(ps.regime == "chunk" for ps in plan)


def _meta(K, NN, dtype=torch.int32):
    return torch.empty(K, NN, dtype=dtype, device="meta")


@pytest.mark.parametrize("case", ["untraceable_callable",
                                  "unsupported_op", "no_fields",
                                  "noncontig_plane", "noncontig_valid",
                                  "index_overflow", "int64_plane",
                                  "not_pow2", "no_op_for_field",
                                  "no_rows", "too_many_fields"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    comb = fieldwise(f0="sum")
    trees = {"f0": _meta(4, 64)}
    tvalid = _meta(4, 64, torch.bool)
    if case == "untraceable_callable":  # Python control flow on values
        comb = lambda a, b: {  # noqa: E731
            k: a[k] if a[k] > b[k] else b[k] for k in a}
    elif case == "unsupported_op":
        comb = lambda a, b: {k: torch.sin(a[k]) for k in a}  # noqa: E731
    elif case == "too_many_fields":
        n = fr.GEN_MAX_FIELDS + 1
        trees = {f"f{i}": _meta(4, 64) for i in range(n)}
        comb = fieldwise(**{f"f{i}": "sum" for i in range(n)})
    elif case == "no_fields":
        trees = {}
    elif case == "noncontig_plane":
        trees = {"f0": _meta(4, 128)[:, ::2]}
    elif case == "noncontig_valid":
        tvalid = _meta(64, 4, torch.bool).t()
    elif case == "index_overflow":
        trees = {"f0": _meta(1 << 20, 1 << 11)}
        tvalid = _meta(1 << 20, 1 << 11, torch.bool)
    elif case == "int64_plane":
        trees = {"f0": _meta(4, 64, torch.int64)}
    elif case == "not_pow2":
        trees = {"f0": _meta(4, 48)}
        tvalid = _meta(4, 48, torch.bool)
    elif case == "no_op_for_field":
        comb = fieldwise(g="sum")
    elif case == "no_rows":
        trees = {"f0": _meta(0, 64)}
        tvalid = _meta(0, 64, torch.bool)
    with pytest.raises(WindFlowError):
        fr.check_forest(trees, tvalid, comb)


def test_wrapper_takes_the_largest_indexable_forest():
    """K_cap*2F just under 2^31 - 1 is accepted; at 2^31 it is refused."""
    fr.check_forest({"f0": _meta(1 << 19, 1 << 11)},
                    _meta(1 << 19, 1 << 11, torch.bool), fieldwise(f0="sum"))
    with pytest.raises(WindFlowError):
        fr.check_forest({"f0": _meta(1 << 20, 1 << 11)},
                        _meta(1 << 20, 1 << 11, torch.bool),
                        fieldwise(f0="sum"))


# ---------------------------------------------------------------------------
# Traced combines (torch_combines.py): the port's plain version and the
# launch-plan emulation against the Pallas kernel with the jnp twin, and
# the emulation of every regime against the plain version.

def _typed_forest(name, K, F, seed):
    """Random planes of the combine's dtypes: counts (``n``) positive,
    means in [0, 100), other ints over the full int32 range (values above
    2^24 included), floats normal; stale internal nodes and validity."""
    rng = np.random.default_rng(seed)
    planes = {}
    for f, dt in tc.DTYPES[name].items():
        if dt is torch.bool:
            p = rng.random((K, 2 * F)) < 0.5
        elif dt is torch.int32:
            lo, hi = (1, 100) if f == "n" else (-2**31, 2**31)
            p = rng.integers(lo, hi, (K, 2 * F), dtype=np.int64) \
                .astype(np.int32)
        elif f == "mean":
            p = (100 * rng.random((K, 2 * F))).astype(np.float32)
        else:
            p = rng.standard_normal((K, 2 * F)).astype(np.float32)
        planes[f] = p
    valid = rng.random((K, 2 * F)) < 0.6
    return planes, valid


def _jax_rebuild_with(planes, valid, jcomb, F):
    K = valid.shape[0]
    pad = max(0, 8 - K)

    def padded(a):
        return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])

    rebuild = make_forest_rebuild(jcomb, list(planes), F, interpret=True)
    trees, tvalid = rebuild({n: jnp.asarray(padded(p))
                             for n, p in planes.items()},
                            jnp.asarray(padded(valid)))
    return ({n: np.asarray(t)[:K] for n, t in trees.items()},
            np.asarray(tvalid)[:K])


def _holds(name, f, got, exp):
    if got.dtype == np.float32 and f in tc.CONTRACTED.get(name, ()):
        np.testing.assert_allclose(got, exp, rtol=1e-6)
    elif got.dtype == np.float32:
        same = (got.view(np.int32) == exp.view(np.int32)) \
            | (np.isnan(got) & np.isnan(exp))
        assert same.all(), f
    else:
        assert (got == exp).all(), f


@pytest.mark.parametrize("name", [n for n in tc.NAMES if n != "scaled"])
@pytest.mark.parametrize("F,K", [(8, 8), (32, 16), (1024, 8)])
def test_traced_combine_matches_pallas(name, F, K):
    """``scaled`` is held to the plain version only (below and on the
    card): XLA turns a division by a constant into a product with its
    reciprocal (as torch does on CUDA, not on the CPU) and contracts the
    sum of products into an FMA."""
    planes, valid = _typed_forest(name, K, F, seed=F * 7 + K)
    exp, expv = _jax_rebuild_with(planes, valid, tc.make(name, jnp), F)
    live = expv[:, 1:]
    comb = tc.make(name, torch)
    n_bool = sum(dt is torch.bool for dt in tc.DTYPES[name].values())
    plan = fr.launch_plan(K, F, len(planes), bool_planes=n_bool)
    for how in ("plain", "plan"):
        trees = {n: torch.from_numpy(p.copy()) for n, p in planes.items()}
        tvalid = torch.from_numpy(valid.copy())
        if how == "plain":
            forest_rebuild_ref(trees, tvalid, comb)
        else:
            _emulate_plan(plan, trees, tvalid, comb)
        assert (tvalid.numpy()[:, 1:] == expv[:, 1:]).all(), how
        for n, e in exp.items():
            got = trees[n].numpy()
            assert got.dtype == e.dtype
            _holds(name, n, got[:, 1:][live], e[:, 1:][live])
            assert (got[:, F:] == planes[n][:, F:]).all()  # leaves kept


_TRACED_PLAN_CASES = [(name, F, K) for name in tc.NAMES
                      for F in (2, 16, 64, 512, 2048, 65536)
                      for K in (1, 7) if K * F <= 1 << 17]


@pytest.mark.parametrize("name,F,K", _TRACED_PLAN_CASES,
                         ids=[f"{n}-F{F}-K{K}"
                              for n, F, K in _TRACED_PLAN_CASES])
def test_launch_plan_emulation_matches_plain_traced(name, F, K):
    """Every regime a traced variant takes (warp and cta for 32-bit
    planes within their register limits, chunk for bool planes and wide
    forests, several chunk passes for long rows), folding the user's
    combine, equals the plain version bit for bit."""
    planes, valid = _typed_forest(name, K, F, seed=F * 13 + K)
    comb = tc.make(name, torch)
    n_bool = sum(dt is torch.bool for dt in tc.DTYPES[name].values())
    plan = fr.launch_plan(K, F, len(planes), bool_planes=n_bool)
    if n_bool or len(planes) > fr.CTA_MAX_FIELDS:
        assert all(ps.regime == "chunk" for ps in plan)
    et = {n: torch.from_numpy(p.copy()) for n, p in planes.items()}
    ev = torch.from_numpy(valid.copy())
    rt = {n: torch.from_numpy(p.copy()) for n, p in planes.items()}
    rv = torch.from_numpy(valid.copy())
    _emulate_plan(plan, et, ev, comb)
    forest_rebuild_ref(rt, rv, comb)
    assert _same(et, ev, rt, rv), plan


@pytest.mark.parametrize("nf,n_bool", [(1, 1), (2, 1), (3, 0), (12, 0),
                                       (12, 3), (32, 0), (64, 64)])
def test_launch_plan_geometry_of_traced_variants(nf, n_bool):
    """Bool planes and more than 8 fields: the bytes per node are the sum
    over the planes, a bool plane or a wide forest goes to the chunk
    regime, and every level is folded once within shared memory."""
    nb = 4 * (nf - n_bool) + n_bool + 1
    for lf in range(1, 18):
        F = 1 << lf
        for K in (1, 64, 16384):
            if K * 2 * F >= 2**31 - 1:
                continue
            plan = fr.launch_plan(K, F, nf, True, bool_planes=n_bool)
            W, levels = F, 0
            for ps in plan:
                assert ps.W == W and W % ps.S == 0
                assert ps.smem <= fr.SMEM_MAX
                if n_bool or nf > fr.CTA_MAX_FIELDS:
                    assert ps.regime == "chunk"
                if ps.regime == "chunk":
                    assert ps.smem == ps.rows * 2 * ps.S * nb
                elif ps.regime == "warp":
                    assert ps.E * nf <= 64
                    assert ps.smem == fr.WARP_THREADS * ps.E * nb
                else:
                    assert ps.smem == 3 * ps.rows * F * nb + 16
                levels += ps.S.bit_length() - 1
                W //= ps.S
            assert W == 1 and levels == lf
