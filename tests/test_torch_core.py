"""The PyTorch port's references, registry and API against the JAX package.

Inputs are made once with numpy (``tests.strategies.make_problem``) and fed
to both packages; JAX stays on the CPU with x64 off, torch gets CPU
tensors. Tolerances: fp32 ``tol_for(float32, n)``; bf16 storage the
relative Frobenius error of the reconstructed A within
``SINGLE_UPDATE_RTOL`` and within 2x of the JAX package's own error; f64
against a numpy float64 refactorization.
"""
from __future__ import annotations

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.backends as jbackends
import repro.core.blocked as jblocked
import repro.core.ref as jref
import repro.core.solve as jsolve
from repro.core import chol_update as jchol_update
from repro.core.precision import Precision as JPrecision
from repro.obs import metrics as jmetrics
from repro_torch.core import api, backends, blocked, ref, solve
from repro_torch.core.precision import Precision
from repro_torch.kernels import fused as tfused
from repro_torch.obs import metrics as tmetrics
from tests.strategies import make_problem, tol_for

BF16_EPS = 2.0 ** -8
SINGLE_UPDATE_RTOL = 32 * BF16_EPS  # tests/test_precision.py


def problem(n, k, seed=0, sigma=1, dtype=np.float32):
    """numpy (L, V) by ``make_problem``'s procedure (kept in numpy, so
    float64 stays float64 with JAX's x64 off); for a downdate L is the
    factor of A + V V^T."""
    if dtype == np.float64:
        rng = np.random.default_rng(seed)
        B = rng.uniform(size=(n, n))
        V = rng.uniform(size=(n, k))
        L = np.linalg.cholesky(B.T @ B + np.eye(n)).T
    else:
        L, V = (np.asarray(x) for x in make_problem(n, k, seed=seed,
                                                    dtype=dtype))
    if sigma < 0:
        A = L.T.astype(np.float64) @ L + V.astype(np.float64) @ V.T
        L = np.linalg.cholesky(A).T.astype(dtype)
    return L, V


def t(x):
    return torch.from_numpy(np.array(x))


def refactor64(L, V, sigma):
    L64, V64 = L.astype(np.float64), V.astype(np.float64)
    return np.linalg.cholesky(L64.T @ L64 + sigma * V64 @ V64.T).T


def rel_frob_A(L_new, L, V, sigma):
    """Relative Frobenius error of the reconstructed A, in float64."""
    L_new = np.asarray(L_new, np.float64)
    A = L.astype(np.float64).T @ L + sigma * V.astype(np.float64) @ V.T
    return float(np.linalg.norm(L_new.T @ L_new - A) / np.linalg.norm(A))


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["float32", "f32", "fp32", "bfloat16",
                                    "bf16", "float64", "f64", "highest"])
def test_precision_presets_match_jax(preset):
    p, q = Precision.parse(preset), JPrecision.parse(preset)
    name = lambda d: None if d is None else str(d).replace("torch.", "")
    assert name(p.storage) == (None if q.storage is None else q.storage.name)
    assert name(p.accum) == q.accum.name
    assert Precision.parse(preset) == p  # canonical: presets dedupe


def test_precision_checks_and_bare_dtypes():
    with pytest.raises(ValueError, match="at least float32"):
        Precision(storage=torch.bfloat16, accum=torch.bfloat16)
    with pytest.raises(ValueError, match="storage <= accum"):
        Precision(storage=torch.float64, accum=torch.float32)
    p = Precision.parse(torch.bfloat16)
    assert (p.storage, p.accum) == (torch.bfloat16, torch.float32)
    assert Precision.parse(torch.float64).accum == torch.float64
    assert Precision.parse(None) is None
    assert Precision.parse("bf16").bytes_per_element(torch.float32) == 2
    assert Precision.parse("highest").storage_for(torch.float32) == torch.float32
    with pytest.raises(ValueError):
        Precision.parse(torch.int32)


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("n,k", [(24, 3), (17, 1)])
def test_ref_matches_jax(n, k, sigma):
    L, V = problem(n, k, seed=n + k, sigma=sigma)
    ours = ref.chol_update_ref(t(L), t(V), sigma=sigma).numpy()
    theirs = np.asarray(jref.chol_update_ref(jnp.asarray(L), jnp.asarray(V),
                                             sigma=sigma))
    np.testing.assert_allclose(ours, theirs, atol=tol_for(np.float32, n))
    assert np.allclose(np.tril(ours, -1), 0.0)


def test_dense_oracle_and_modify_error_match_jax():
    n, k = 20, 4
    L, V = problem(n, k, seed=3)
    for sigma in (1, -1):
        Lx, Vx = (L, V) if sigma > 0 else problem(n, k, seed=3, sigma=-1)
        ours = ref.chol_update_dense(t(Lx), t(Vx), sigma=sigma).numpy()
        theirs = np.asarray(jref.chol_update_dense(jnp.asarray(Lx),
                                                   jnp.asarray(Vx),
                                                   sigma=sigma))
        np.testing.assert_allclose(ours, theirs, atol=tol_for(np.float32, n))
        err = ref.modify_error(t(ours), t(Lx), t(Vx), sigma=sigma)
        jerr = jref.modify_error(jnp.asarray(ours), jnp.asarray(Lx),
                                 jnp.asarray(Vx), sigma=sigma)
        np.testing.assert_allclose(float(err), float(jerr), rtol=1e-3,
                                   atol=1e-5)


def test_upper_convention_is_pinned():
    """The factor is UPPER (A = L^T L); a lower factor gives garbage."""
    n, k = 16, 2
    L, V = problem(n, k, seed=5)
    good = ref.chol_update_ref(t(L), t(V))
    assert float(ref.modify_error(good, t(L), t(V))) < tol_for(np.float32, n)
    bad = ref.chol_update_ref(t(L.T.copy()), t(V))
    assert not float(ref.modify_error(bad, t(L), t(V))) < 1e-2


@pytest.mark.parametrize("method", ["reference", "paper", "gemm", "fused"])
@pytest.mark.parametrize("sigma", [1, -1])
def test_f64_against_numpy_refactorization(method, sigma):
    n, k, panel = 21, 3, 8
    L, V = problem(n, k, seed=11, sigma=sigma, dtype=np.float64)
    out = api.chol_update(t(L), t(V), sigma=sigma, method=method, panel=panel)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), refactor64(L, V, sigma),
                               atol=tol_for(np.float64, n))


# ---------------------------------------------------------------------------
# blocked drivers
# ---------------------------------------------------------------------------


def test_pad_to_panels_pads_with_identity():
    n, k, panel = 10, 2, 8
    L, V = problem(n, k, seed=1)
    Lp, Vp, n0 = blocked._pad_to_panels(t(L), t(V), panel)
    jLp, jVp, jn0 = jblocked._pad_to_panels(jnp.asarray(L), jnp.asarray(V),
                                            panel)
    assert n0 == jn0 == n and Lp.shape == (16, 16) and Vp.shape == (16, k)
    np.testing.assert_array_equal(Lp.numpy(), np.asarray(jLp))
    np.testing.assert_array_equal(Vp.numpy(), np.asarray(jVp))
    assert torch.equal(torch.diagonal(Lp)[n:], torch.ones(6))
    # A fleet pads every member the same way.
    Lb, Vb, _ = blocked._pad_to_panels(t(np.stack([L, L])),
                                       t(np.stack([V, V])), panel)
    assert torch.equal(Lb[1], Lp) and torch.equal(Vb[0], Vp)


@pytest.mark.parametrize("sigma", [1, -1])
def test_panel_diag_and_applies_match_jax(sigma):
    P, k, w = 8, 3, 5
    rng = np.random.default_rng(7)
    L, V = problem(P, k, seed=2, sigma=sigma)
    vtd = np.ascontiguousarray(V.T)
    D, c, s, T = blocked.panel_diag(t(L), t(vtd), sigma, with_transform=True)
    jD, jc, js, jT = jblocked.panel_diag(jnp.asarray(L), jnp.asarray(vtd),
                                         sigma, with_transform=True)
    tol = tol_for(np.float32, P)
    for ours, theirs in ((D, jD), (c, jc), (s, js), (T, jT)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=tol)
    R = rng.uniform(size=(P, w)).astype(np.float32)
    vt = rng.uniform(size=(k, w)).astype(np.float32) * 0.1
    a = blocked.panel_apply_paper(t(R), t(vt), c, s, sigma)
    b = blocked.panel_apply_gemm(t(R), t(vt), T)
    ja = jblocked.panel_apply_paper(jnp.asarray(R), jnp.asarray(vt), jc, js,
                                    sigma)
    jb = jblocked.panel_apply_gemm(jnp.asarray(R), jnp.asarray(vt), jT)
    for ours, theirs in zip(a + b, ja + jb):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=tol)
    # The two applies are the same linear map.
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=tol)


@pytest.mark.parametrize("strategy", ["paper", "gemm"])
@pytest.mark.parametrize("sigma", [1, -1])
def test_blocked_matches_jax(strategy, sigma):
    n, k, panel = 37, 3, 16  # ragged: 37 pads to 48
    L, V = problem(n, k, seed=9, sigma=sigma)
    ours = blocked.chol_update_blocked(t(L), t(V), sigma=sigma, panel=panel,
                                       strategy=strategy).numpy()
    theirs = np.asarray(jblocked.chol_update_blocked(
        jnp.asarray(L), jnp.asarray(V), sigma=sigma, panel=panel,
        strategy=strategy))
    np.testing.assert_allclose(ours, theirs, atol=tol_for(np.float32, n))


@pytest.mark.parametrize("method", ["reference", "gemm", "fused"])
def test_bf16_policy_within_budget_and_jax(method):
    n, k, panel = 32, 4, 16
    L, V = problem(n, k, seed=4)
    ours = api.chol_update(t(L), t(V), method=method, panel=panel,
                           precision="bf16")
    assert ours.dtype == torch.bfloat16
    theirs = jchol_update(jnp.asarray(L), jnp.asarray(V), method=method,
                          panel=panel, precision="bf16", interpret=True)
    e_ours = rel_frob_A(ours.float().numpy(), L, V, 1)
    e_jax = rel_frob_A(np.asarray(theirs, np.float32), L, V, 1)
    assert e_ours <= SINGLE_UPDATE_RTOL
    assert e_ours <= 2 * e_jax


# ---------------------------------------------------------------------------
# solves
# ---------------------------------------------------------------------------


def test_solves_logdet_feasibility_match_jax():
    n, k = 18, 2
    L, V = problem(n, k, seed=6)
    b = np.random.default_rng(1).normal(size=(n,)).astype(np.float32)
    jL = jnp.asarray(L)
    tol = tol_for(np.float32, n)
    np.testing.assert_allclose(solve.chol_solve(t(L), t(b)).numpy(),
                               np.asarray(jsolve.chol_solve(jL, b)),
                               rtol=1e-3, atol=tol)
    for trans in (True, False):
        np.testing.assert_allclose(
            solve.solve_triangular(t(L), t(b), trans=trans).numpy(),
            np.asarray(jsolve.solve_triangular(jL, b, trans=trans)),
            rtol=1e-3, atol=tol)
    B = np.stack([b, 2 * b], axis=1)
    np.testing.assert_allclose(solve.chol_solve(t(L), t(B)).numpy(),
                               np.asarray(jsolve.chol_solve(jL, B)),
                               rtol=1e-3, atol=tol)
    np.testing.assert_allclose(float(solve.chol_logdet(t(L))),
                               float(jsolve.chol_logdet(jL)), rtol=1e-5)
    small, big = 0.1 * V, 100.0 * V
    for W in (small, big, small[:, 0]):
        assert bool(solve.downdate_feasible(t(L), t(W))) == bool(
            jsolve.downdate_feasible(jL, jnp.asarray(W)))
    assert bool(solve.downdate_feasible(t(L), t(small)))
    assert not bool(solve.downdate_feasible(t(L), t(big)))
    assert bool(solve.is_positive_factor(t(L)))
    assert not bool(solve.is_positive_factor(t(-L)))


# ---------------------------------------------------------------------------
# registry, routing, API
# ---------------------------------------------------------------------------


def test_registered_methods_are_the_ported_ones():
    assert backends.methods() == ("reference", "paper", "gemm", "pallas",
                                  "pallas_gemm", "fused", "blocktridiag",
                                  "blocktridiag_ref", "sharded", "auto")
    assert backends.methods("dense") == ("reference", "paper", "gemm",
                                         "pallas", "pallas_gemm", "fused",
                                         "sharded", "auto")
    # Every JAX method is registered, in the same order, with the same
    # structures and the same kind of the collective driver.
    assert backends.names() == jbackends.names()
    for name in backends.names():
        assert backends.get(name).structures == \
            jbackends.get(name).structures
    assert backends.get("sharded").kind == jbackends.get("sharded").kind
    L, V = problem(8, 1)
    with pytest.raises(ValueError, match="method must be one of"):
        backends.resolve("nope", n=8)
    with pytest.raises(ValueError, match="method must be one of"):
        api.chol_update(t(L), t(V), method="nope")
    with pytest.raises(ValueError, match="method must be one of"):
        backends.get("nope")
    # The sharded driver needs its mesh, as in the JAX package.
    with pytest.raises(ValueError, match="requires a mesh"):
        api.chol_update(t(L), t(V), method="sharded")
    with pytest.raises(ValueError, match="requires a mesh"):
        api.chol_update_batched(t(L[None]), t(V[None]), method="sharded")


@pytest.mark.parametrize("kind", ["cpu", "tpu", "gpu", "cuda", "rocm"])
def test_routing_matches_jax_under_fake_kind(kind, fake_device_kind):
    fake_device_kind(kind)
    for n in (100, 600):
        for interp in (None, True):
            ours = backends.resolve("auto", n=n, panel=256, interpret=interp,
                                    device=torch.device("cpu"))
            theirs = jbackends.resolve("auto", n=n, panel=256,
                                       interpret=interp)
            assert ours == theirs
    assert backends.resolve("gemm", n=4) == "gemm"


def test_routing_keys_on_the_tensor_device(monkeypatch):
    monkeypatch.delenv(backends.FAKE_DEVICE_KIND_ENV, raising=False)
    cpu = torch.device("cpu")
    assert backends.resolve("auto", n=100, device=cpu) == "reference"
    assert backends.resolve("auto", n=600, device=cpu) == "gemm"
    assert backends.resolve("auto", n=100, device=cpu,
                            interpret=True) == "fused"
    assert backends.resolve("auto", n=100,
                            device=torch.device("cuda")) == "fused"
    assert backends.device_kind(torch.device("cuda", 0)) == "cuda"
    assert backends.default_interpret(cpu)
    assert not backends.default_interpret(torch.device("cuda"))
    monkeypatch.setenv(backends.FORCE_INTERPRET_ENV, "1")
    assert backends.default_interpret(torch.device("cuda"))


def test_lowering_choices():
    for ok in (None, "auto", "portable"):
        assert backends.resolve_lowering(ok) == "portable"
    with pytest.raises(ValueError, match="'auto', 'portable'"):
        backends.resolve_lowering("mosaic")


def test_dispatch_counts_modeled_bytes_in_the_ports_registry():
    n, k, panel = 40, 3, 16
    L, V = problem(n, k)
    labels = dict(backend="gemm", structure="dense", lowering="none",
                  dtype="float32", sign="up")
    before = tmetrics.value("repro.backends.bytes", **labels)
    jbefore = jmetrics.total("repro.backends.bytes")
    api.chol_update_batched(t(np.stack([L, L])), t(np.stack([V, V])),
                            method="gemm", panel=panel)
    got = tmetrics.value("repro.backends.bytes", **labels) - before
    model = tfused.bytes_per_update(n, panel, k, storage_dtype=torch.float32)
    assert got == 2 * model
    assert model == jbackends.modeled_bytes_per_update(
        structure="dense", n=n, panel=panel, k=k, storage_dtype=jnp.float32)
    # Nothing of the port reached the JAX package's registry.
    assert jmetrics.total("repro.backends.bytes") == jbefore


def test_api_validation_and_dtype_pin():
    n, k = 12, 2
    L, V = problem(n, k)
    with pytest.raises(ValueError, match="sigma"):
        api.chol_update(t(L), t(V), sigma=2)
    with pytest.raises(ValueError, match="chol_update_batched"):
        api.chol_update(t(L[None]), t(V[None]))
    with pytest.raises(ValueError, match=r"\(B, n, n\)"):
        api.chol_update_batched(t(L), t(V))
    with pytest.raises(ValueError, match=r"\(B, n, k\)"):
        api.chol_update_batched(t(L[None]), t(V[None, :5]))
    out = api.chol_update(t(L), t(V.astype(np.float64)), method="reference")
    assert out.dtype == torch.float32  # the factor's dtype wins
    vec = api.chol_update(t(L), t(V[:, 0]), method="reference")
    mat = api.chol_update(t(L), t(V[:, :1]), method="reference")
    assert torch.equal(vec, mat)
    down = api.chol_downdate(api.chol_update(t(L), t(V), method="gemm",
                                             panel=8),
                             t(V), method="gemm", panel=8)
    np.testing.assert_allclose(down.numpy(), L, atol=tol_for(np.float32, n))


def test_requires_grad_raises_on_every_path():
    L, V = problem(8, 1)
    Lg = t(L).requires_grad_(True)
    for method in ("auto", "fused", "reference"):
        with pytest.raises(NotImplementedError, match="queue 1 item 4"):
            api.chol_update(Lg, t(V), method=method)
    with pytest.raises(NotImplementedError, match="queue 1 item 4"):
        api.chol_update_batched(t(L[None]), t(V[None]).requires_grad_(True))


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    from repro_torch.core import CholFactor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    L, V = problem(8, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CholFactor.identity(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CholFactor.from_matrix(L.T @ L)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.chol_update(L, V)
    f = CholFactor.identity(8, device="cpu")
    assert f.device.type == "cpu"
    # A tensor that already lies on a device keeps it.
    assert api.chol_update(t(L), t(V)).device.type == "cpu"


def test_import_leaves_no_jax_or_reference_module():
    """Every module of the package imports, and none of them pulls in JAX or
    the JAX package (the package is walked, so a new module is covered)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert {'repro_torch.kernels.ops', 'repro_torch.core.structure',\n"
        "        'repro_torch.kernels.blocktridiag'} <= set(names), names\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src"),
         os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_metric_types_behave_like_the_jax_registry():
    reg = tmetrics.Registry()
    c = reg.counter("x.count", a=1)
    c.inc()
    c.inc(2)
    g = reg.gauge("x.gauge")
    g.set(5.0)
    g.add(-1.5)
    h = reg.histogram("x.hist")
    for v in (1e-4, 2e-3, 5e-2):
        h.observe(v)
    assert reg.value("x.count", a=1) == 3
    assert reg.value("x.gauge") == 3.5
    assert h.count == 3
    snap = reg.snapshot()
    assert set(snap) >= {"counters", "gauges", "histograms"}
    assert tmetrics.LATENCY_BUCKETS_S == jmetrics.LATENCY_BUCKETS_S
    assert tmetrics.REGISTRY is not jmetrics.REGISTRY
