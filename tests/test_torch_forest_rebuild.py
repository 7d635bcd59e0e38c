"""The port's plain forest rebuild (``windflow_tpu_torch.kernels.reference``)
held against the JAX package's Pallas kernel, run in interpret mode as
``tests/test_pallas_kernels.py`` runs it. Inputs are made with numpy from a
seed; stale internal nodes are garbage and must be fully recomputed.
Tolerance: exact equality on every valid node and on the validity plane
(the pairing of the fold is the same, so even float sums agree bit for
bit)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
