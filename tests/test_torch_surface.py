"""The last names of the JAX package's public surface, ported: ``core.solve``
``chol_factor`` (the upper factor) and ``chol_inverse_multiply``, the
``repro_torch.core`` exports ``chol_factor``, ``backends`` and
``resolve_backend_for``, and ``kernels.ref`` (the kernels' oracles,
re-exported from ``core.blocked``). Each against the JAX function on the
same inputs: f64 against numpy, fp32 within ``tol_for``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.kernels.ref as jkref
from repro.core import solve as jsolve
import repro_torch.core as core
import repro_torch.kernels.ref as kref
from repro_torch.core import blocked, solve
from tests.strategies import make_problem, tol_for


def _spd(n, seed, dtype):
    rng = np.random.default_rng(seed)
    B = rng.uniform(size=(n, n))
    return (B.T @ B + n * np.eye(n)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_chol_factor_is_the_upper_factor(n, dtype):
    A = _spd(n, n, dtype)
    L = solve.chol_factor(torch.from_numpy(A))
    assert L.dtype == torch.from_numpy(A).dtype
    assert torch.equal(L, torch.triu(L))
    want = np.linalg.cholesky(A.astype(np.float64)).T
    jl = np.asarray(jsolve.chol_factor(jnp.asarray(A)))
    if dtype == np.float64:
        np.testing.assert_allclose(L.numpy(), want, rtol=1e-12, atol=1e-12)
    else:
        tol = tol_for(np.float32, n) * np.abs(want).max()
        np.testing.assert_allclose(L.numpy(), jl, atol=tol)
        np.testing.assert_allclose(L.numpy(), want, atol=tol)


def test_chol_factor_takes_a_fleet():
    A = np.stack([_spd(16, s, np.float64) for s in range(3)])
    L = solve.chol_factor(torch.from_numpy(A))
    for i in range(3):
        np.testing.assert_allclose(L[i].numpy(),
                                   np.linalg.cholesky(A[i]).T, rtol=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chol_inverse_multiply(dtype):
    n, m = 40, 5
    A = _spd(n, 3, dtype)
    X = np.random.default_rng(4).normal(size=(n, m)).astype(dtype)
    L = np.linalg.cholesky(A.astype(np.float64)).T.astype(dtype)
    got = solve.chol_inverse_multiply(torch.from_numpy(L),
                                      torch.from_numpy(X)).numpy()
    want = np.linalg.solve(A.astype(np.float64), X.astype(np.float64))
    jgot = np.asarray(jsolve.chol_inverse_multiply(jnp.asarray(L),
                                                   jnp.asarray(X)))
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    else:
        tol = tol_for(np.float32, n) * np.abs(want).max()
        np.testing.assert_allclose(got, jgot, atol=tol)
        np.testing.assert_allclose(got, want, atol=tol)


def test_core_exports_the_jax_names():
    for name in ("chol_factor", "backends", "resolve_backend_for"):
        assert name in jcore.__all__ and hasattr(core, name), name
    assert core.backends.names() == tuple(core.backends.names())
    f = core.CholFactor(torch.eye(8, dtype=torch.float64))
    assert core.resolve_backend_for(f) in core.backends.names()


def test_kernels_ref_reexports_blocked():
    assert set(kref.__all__) == set(jkref.__all__)
    for name in kref.__all__:
        assert getattr(kref, name) is getattr(blocked, name)


@pytest.mark.parametrize("sigma", [1, -1])
def test_kernels_ref_matches_jax(sigma):
    P, k, w = 8, 3, 5
    L, V = make_problem(P, k, seed=5)
    L = np.array(L)
    vtd = np.ascontiguousarray(np.asarray(V).T) * (0.2 if sigma < 0 else 1)
    t = torch.from_numpy
    D, c, s, T = kref.panel_diag(t(L), t(vtd), sigma, with_transform=True)
    jD, jc, js, jT = jkref.panel_diag(jnp.asarray(L), jnp.asarray(vtd), sigma,
                                      with_transform=True)
    tol = tol_for(np.float32, P) * float(np.abs(L).max())
    for ours, theirs in ((D, jD), (c, jc), (s, js), (T, jT)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=tol)
    rng = np.random.default_rng(8)
    R = rng.uniform(size=(P, w)).astype(np.float32)
    vt = rng.uniform(size=(k, w)).astype(np.float32) * 0.1
    a = kref.panel_apply_paper(t(R), t(vt), c, s, sigma)
    b = kref.panel_apply_gemm(t(R), t(vt), T)
    ja = jkref.panel_apply_paper(jnp.asarray(R), jnp.asarray(vt), jc, js,
                                 sigma)
    jb = jkref.panel_apply_gemm(jnp.asarray(R), jnp.asarray(vt), jT)
    for ours, theirs in zip(tuple(a) + tuple(b), tuple(ja) + tuple(jb)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=tol)
