"""Gradients through the update: the port's Murray rule against JAX's.

The same inputs, made from a seed with numpy, go through ``jax.grad`` /
``jax.jvp`` of the JAX package (methods ``reference`` and ``fused`` with
``interpret=True``, ``blocktridiag_ref`` for structured storage) and
through the port's ``torch.autograd`` / ``torch.func.jvp`` on CPU tensors,
where every kernel backend runs its plain version.

Tolerance (fp32): ``tol_for(float32, n) * kappa_2(L~)`` relative to the
largest entry of the JAX gradient or tangent. The rule runs two triangular
solves against the output factor ``L~``, so its condition number scales
the rounding of both packages; ``kappa_2`` is computed from the float64
refactorization here. bf16 storage mirrors tests/test_precision.py: the
cotangent of an fp32 ``V`` is fp32 and within ``32 * eps(bf16)`` (relative
Frobenius) of the fp32 gradient. The port alone is held to finite
differences in float64 (``gradcheck``, forward-mode AD against a central
difference), and its structured rule to the no-densify pin of
tests/test_structure.py.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import CholFactor as JFactor
from repro.core import chol_update as jchol_update
from repro.core import chol_update_batched as jchol_update_batched
from repro.core.structure import BlockTriDiagStorage as JStorage
from repro_torch.core import BlockTriDiagStorage, CholFactor, api
from tests.strategies import make_banded_problem, tol_for

DENSE_METHODS = ["reference", "gemm", "paper", "pallas", "pallas_gemm",
                 "fused"]
N, K, PANEL = 16, 3, 4
NB, BLK, KS = 4, 4, 2
SINGLE_UPDATE_RTOL = 32 * 2.0 ** -8  # tests/test_precision.py


def t(x):
    return torch.from_numpy(np.array(x))


def dense_problem(n=N, k=K, seed=3, sigma=1, batch=None):
    """tests/test_factor.py's ``_small_problem`` (A = BᵀB + n I, V
    normal), fp32; for a downdate L is the factor of A + V Vᵀ. ``batch``
    stacks that many draws."""
    rng = np.random.default_rng(seed)

    def one():
        B = rng.normal(size=(n, n))
        V = rng.normal(size=(n, k))
        A = B.T @ B + n * np.eye(n)
        if sigma < 0:
            A = A + V @ V.T
        return (np.linalg.cholesky(A).T.astype(np.float32),
                V.astype(np.float32))

    if batch is None:
        return one()
    return tuple(np.stack(x) for x in zip(*[one() for _ in range(batch)]))


def loss_np(x):
    return x.sin() * (0.5 * x).cos()


def kappa(L, V, sigma):
    """kappa_2 of the float64 modified factor, per fleet member (max)."""
    L, V = L.astype(np.float64), V.astype(np.float64)
    A = np.swapaxes(L, -1, -2) @ L + sigma * V @ np.swapaxes(V, -1, -2)
    return float(np.max(np.linalg.cond(np.linalg.cholesky(A))))


def assert_close_rel(ours, theirs, bound, what):
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs,
                                                            np.float64)
    err = np.abs(ours - theirs).max() / np.abs(theirs).max()
    assert err <= bound, f"{what}: relative error {err:.3e} > {bound:.3e}"


@functools.lru_cache(maxsize=None)
def jax_dense(method, sigma, batch=None):
    """JAX's gradient and tangent of the dense loss, one method, cached."""
    L, V = dense_problem(sigma=sigma, batch=batch)
    fn = jchol_update if batch is None else jchol_update_batched

    def f(L, V):
        return fn(L, V, sigma=sigma, method=method, panel=PANEL,
                  interpret=True)

    def loss(L, V):
        return jnp.sum(jnp.sin(f(L, V)) * jnp.cos(0.5 * f(L, V)))

    gL, gV = jax.grad(loss, argnums=(0, 1))(jnp.asarray(L), jnp.asarray(V))
    dL, dV = tangents(L, V)
    _, tan = jax.jvp(f, (jnp.asarray(L), jnp.asarray(V)),
                     (jnp.asarray(dL), jnp.asarray(dV)))
    return np.asarray(gL), np.asarray(gV), np.asarray(tan)


def tangents(L, V, seed=7):
    rng = np.random.default_rng(seed)
    dL = np.triu(rng.normal(size=L.shape)).astype(np.float32)
    return dL, rng.normal(size=V.shape).astype(np.float32)


def port_dense(method, sigma, batch=None):
    L, V = dense_problem(sigma=sigma, batch=batch)
    fn = api.chol_update if batch is None else api.chol_update_batched

    def f(L, V):
        return fn(L, V, sigma=sigma, method=method, panel=PANEL)

    Lg, Vg = t(L).requires_grad_(True), t(V).requires_grad_(True)
    loss_np(f(Lg, Vg)).sum().backward()
    dL, dV = tangents(L, V)
    _, tan = torch.func.jvp(f, (t(L), t(V)), (t(dL), t(dV)))
    return Lg.grad, Vg.grad, tan


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("method", DENSE_METHODS)
def test_dense_grad_and_jvp_match_jax(method, sigma):
    """Every dense method's gradient and tangent against JAX's reference
    method (the rule sees only the primal output, so the backend moves
    the result by its forward rounding alone)."""
    L, V = dense_problem(sigma=sigma)
    bound = tol_for(np.float32, N) * kappa(L, V, sigma)
    theirs = jax_dense("reference", sigma)
    for name, o, th in zip(("Lbar", "Vbar", "tangent"),
                           port_dense(method, sigma), theirs):
        assert o.dtype == torch.float32
        assert_close_rel(o.numpy(), th, bound, f"{method} {name}")


@pytest.mark.parametrize("sigma", [1, -1])
def test_fused_grad_matches_jax_fused_kernel(sigma):
    """The port's fused chain against JAX's fused kernel in interpret
    mode, as tests/test_factor.py differentiates it."""
    L, V = dense_problem(sigma=sigma)
    bound = tol_for(np.float32, N) * kappa(L, V, sigma)
    for name, o, th in zip(("Lbar", "Vbar", "tangent"),
                           port_dense("fused", sigma),
                           jax_dense("fused", sigma)):
        assert_close_rel(o.numpy(), th, bound, f"fused {name}")


@pytest.mark.parametrize("method", ["fused", "reference"])
def test_dense_fleet_grad_matches_jax_vmap(method):
    """A B = 3 fleet through ``chol_update_batched``: the rule on the
    trailing axes against JAX's vmapped rule."""
    L, V = dense_problem(batch=3)
    bound = tol_for(np.float32, N) * kappa(L, V, 1)
    for name, o, th in zip(("Lbar", "Vbar", "tangent"),
                           port_dense(method, 1, batch=3),
                           jax_dense("reference", 1, batch=3)):
        assert o.shape == th.shape
        assert_close_rel(o.numpy(), th, bound, f"fleet {method} {name}")


def test_bf16_storage_grad_is_fp32_and_matches():
    """tests/test_precision.py's bf16 case on the port: an fp32 ``V``'s
    cotangent through a bf16-stored update is fp32, finite, and within
    ``32 eps(bf16)`` of the fp32 gradient and of JAX's bf16 gradient."""
    n, k = 8, 2
    rng = np.random.default_rng(5)
    B = rng.normal(size=(n, n))
    L = np.linalg.cholesky(B.T @ B + n * np.eye(n)).T.astype(np.float32)
    V = rng.normal(size=(n, k)).astype(np.float32)

    def port(precision):
        Vg = t(V).requires_grad_(True)
        out = api.chol_update(t(L), Vg, method="gemm", panel=4,
                              precision=precision)
        (out.float() ** 2).sum().backward()
        return out, Vg.grad

    def jax_grad(precision):
        def loss(V):
            out = jchol_update(jnp.asarray(L), V, method="gemm", panel=4,
                               precision=precision)
            return jnp.sum(out.astype(jnp.float32) ** 2)
        return np.asarray(jax.grad(loss)(jnp.asarray(V)))

    out, g_bf = port("bf16")
    _, g_32 = port(None)
    assert out.dtype == torch.bfloat16 and g_bf.dtype == torch.float32
    assert bool(torch.isfinite(g_bf).all())
    rel = lambda a, b: float(np.linalg.norm(np.asarray(a, np.float64) - b)
                             / np.linalg.norm(b))
    assert rel(g_bf.numpy(), g_32.numpy()) < SINGLE_UPDATE_RTOL
    assert rel(g_bf.numpy(), jax_grad("bf16")) < SINGLE_UPDATE_RTOL
    assert rel(g_32.numpy(), jax_grad(None)) < tol_for(np.float32, n) * \
        kappa(L, V, 1)
    # The tangent's dtype follows the primal output (bf16).
    _, tan = torch.func.jvp(
        lambda L: api.chol_update(L, t(V), method="reference",
                                  precision="bf16"),
        (t(L),), (0.1 * torch.eye(n),))
    assert tan.dtype == torch.bfloat16


def test_factor_update_then_solve_grad_matches_jax():
    """tests/test_factor.py's optimizer shape: the gradient of a solve
    against an updated ``CholFactor``."""
    L, V = dense_problem(n=8, k=2, seed=19)
    b = np.ones(8, np.float32)

    def jloss(V):
        f = JFactor.from_factor(jnp.asarray(L), backend="reference")
        return jnp.sum(f.update(V).solve(jnp.asarray(b)) ** 2)

    theirs = np.asarray(jax.grad(jloss)(jnp.asarray(V)))
    Vg = t(V).requires_grad_(True)
    f = CholFactor.from_factor(t(L), backend="reference")
    (f.update(Vg).solve(t(b)) ** 2).sum().backward()
    assert Vg.grad.shape == V.shape
    assert_close_rel(Vg.grad.numpy(), theirs,
                     tol_for(np.float32, 8) * kappa(L, V, 1), "solve grad")


# ---------------------------------------------------------------------------
# Block-tridiagonal storage.
# ---------------------------------------------------------------------------


def banded(sigma=1, batch=None, seed=0):
    """make_banded_problem's factor and block-local V (fp32); for a
    downdate the factor of A + V Vᵀ. ``batch`` stacks draws."""
    def one(s):
        Ad, Ao, V = (np.asarray(x) for x in make_banded_problem(
            NB, BLK, KS, seed=s))
        S = BlockTriDiagStorage.from_matrix_blocks(t(Ad), t(Ao))
        if sigma < 0:
            S = api.chol_update(S, t(V), method="blocktridiag_ref")
        return S.diag.numpy(), S.off.numpy(), V

    if batch is None:
        return one(seed)
    return tuple(np.stack(x) for x in zip(*[one(seed + i)
                                            for i in range(batch)]))


def dense_of(diag, off):
    """The (..., n, n) factor of block stacks (float64), for kappa_2."""
    S = BlockTriDiagStorage(t(diag).double(), t(off).double())
    return S.to_dense().numpy()


@functools.lru_cache(maxsize=None)
def jax_structured(sigma, batch=None):
    D, O, V = banded(sigma, batch)
    fn = jchol_update if batch is None else jchol_update_batched

    def f(D, O, V):
        S = fn(JStorage(D, O), V, sigma=sigma, method="blocktridiag_ref")
        return S.diag, S.off

    def loss(D, O, V):
        d, o = f(D, O, V)
        return jnp.sum(jnp.sin(d) * jnp.cos(0.5 * d)) + jnp.sum(
            jnp.sin(o) * jnp.cos(0.5 * o))

    args = tuple(jnp.asarray(x) for x in (D, O, V))
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    _, tans = jax.jvp(f, args, tuple(jnp.asarray(x)
                                     for x in struct_tangents(D, O, V)))
    return [np.asarray(x) for x in grads + tans]


def struct_tangents(D, O, V, seed=11):
    """A direction in the storage's family: upper-triangular diagonal
    blocks, full coupling blocks, ``V``'s own block-local support."""
    rng = np.random.default_rng(seed)
    dD = np.triu(rng.normal(size=D.shape)).astype(np.float32)
    dO = rng.normal(size=O.shape).astype(np.float32)
    dV = (rng.normal(size=V.shape) * (V != 0)).astype(np.float32)
    return dD, dO, dV


def port_structured(method, sigma, batch=None):
    D, O, V = banded(sigma, batch)
    fn = api.chol_update if batch is None else api.chol_update_batched

    def f(D, O, V):
        S = fn(BlockTriDiagStorage(D, O), V, sigma=sigma, method=method)
        return S.diag, S.off

    ins = [t(x).requires_grad_(True) for x in (D, O, V)]
    d, o = f(*ins)
    (loss_np(d).sum() + loss_np(o).sum()).backward()
    _, tans = torch.func.jvp(f, tuple(t(x) for x in (D, O, V)),
                             tuple(t(x) for x in struct_tangents(D, O, V)))
    return [x.grad for x in ins] + list(tans)


@pytest.mark.parametrize("batch", [None, 2], ids=["factor", "fleet"])
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("method", ["blocktridiag", "blocktridiag_ref"])
def test_structured_grad_and_jvp_match_jax(method, sigma, batch):
    """The blockwise rule on a structured factor and a structured fleet
    against JAX's (``blocktridiag_ref``, vmapped for the fleet)."""
    D, O, V = banded(sigma, batch)
    L = dense_of(D, O)
    Vd = V.astype(np.float64)
    bound = tol_for(np.float32, NB * BLK) * kappa(L, Vd, sigma)
    names = ("dbar", "obar", "Vbar", "d tangent", "o tangent")
    for name, o, th in zip(names, port_structured(method, sigma, batch),
                           jax_structured(sigma, batch)):
        assert tuple(o.shape) == th.shape, name
        assert_close_rel(o.numpy(), th, bound, f"{method} {name}")


# ---------------------------------------------------------------------------
# The port alone, float64: finite differences.
# ---------------------------------------------------------------------------


def _dense64(sigma):
    L, V = dense_problem(n=6, k=2, seed=3, sigma=sigma)
    return t(L).double(), t(V).double()


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("method", ["reference", "fused"])
def test_dense_gradcheck_f64(method, sigma):
    """``gradcheck`` (reverse and forward mode) on the upper triangle of
    L (the factor's own entries) and V, n = 6, k = 2."""
    L, V = _dense64(sigma)

    def f(L, V):
        return api.chol_update(torch.triu(L), V, sigma=sigma, method=method,
                               panel=4)

    assert torch.autograd.gradcheck(
        f, (L.requires_grad_(True), V.requires_grad_(True)),
        check_forward_ad=True)


def _struct64(sigma):
    Ad, Ao, V = (np.asarray(x, np.float64) for x in make_banded_problem(
        4, 3, 2, seed=0))
    S = BlockTriDiagStorage.from_matrix_blocks(t(Ad), t(Ao))
    V = t(V)
    if sigma < 0:
        S = api.chol_update(S, V, method="blocktridiag_ref")
    return S.diag, S.off, V, (V != 0).double()


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("method", ["blocktridiag", "blocktridiag_ref"])
def test_structured_gradcheck_f64(method, sigma):
    """``gradcheck`` of the blockwise rule, nb = 4, b = 3: diagonal blocks'
    upper triangles, coupling blocks, V on its block-local support (the
    storage's contract)."""
    D, O, V, mask = _struct64(sigma)

    def f(D, O, V):
        S = api.chol_update(BlockTriDiagStorage(torch.triu(D), O), V * mask,
                            sigma=sigma, method=method)
        return S.diag, S.off

    assert torch.autograd.gradcheck(
        f, tuple(x.clone().requires_grad_(True) for x in (D, O, V)),
        check_forward_ad=True)


@pytest.mark.parametrize("structured", [False, True],
                         ids=["dense", "structured"])
def test_forward_ad_tangent_matches_central_difference(structured):
    """``torch.autograd.forward_ad``: the tangent of the update along a
    seeded direction against a central difference of the primal (f64,
    h = 1e-6; truncation ~h² and rounding ~eps/h are both ~1e-10)."""
    rng = np.random.default_rng(23)
    if structured:
        D, O, V, mask = _struct64(1)
        x = (D, O, V)
        d = (torch.triu(t(rng.normal(size=D.shape))),
             t(rng.normal(size=O.shape)), t(rng.normal(size=V.shape)) * mask)

        def f(D, O, V):
            S = api.chol_update(BlockTriDiagStorage(D, O), V,
                                method="blocktridiag")
            return torch.cat([S.diag.reshape(-1), S.off.reshape(-1)])
    else:
        x = _dense64(1)
        d = (torch.triu(t(rng.normal(size=x[0].shape))),
             t(rng.normal(size=x[1].shape)))

        def f(L, V):
            return api.chol_update(L, V, method="fused", panel=4).reshape(-1)

    with fwAD.dual_level():
        out = f(*(fwAD.make_dual(a, b) for a, b in zip(x, d)))
        tangent = fwAD.unpack_dual(out).tangent
    h = 1e-6
    fd = (f(*(a + h * b for a, b in zip(x, d)))
          - f(*(a - h * b for a, b in zip(x, d)))) / (2 * h)
    torch.testing.assert_close(tangent, fd, rtol=0,
                               atol=1e-7 * float(fd.abs().max()))


# ---------------------------------------------------------------------------
# The structured rule never builds an (n, n) tensor.
# ---------------------------------------------------------------------------


class _Sizes(TorchDispatchMode):
    """Records the element count of every operation's tensor outputs."""

    def __init__(self):
        super().__init__()
        self.sizes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.sizes.append((o.numel(), tuple(o.shape), str(func)))
        return out


@pytest.mark.parametrize("method", ["blocktridiag", "blocktridiag_ref"])
def test_structured_grad_does_not_densify(method):
    """tests/test_structure.py's pin on the port: no tensor of the forward
    or the backward of ``logdet(chol_update(S, V))`` reaches n²/2
    elements (a dense lift at n = 48 is 2304), and the (nb, b, b) block
    stack is seen."""
    nb, b, k = 6, 8, 3
    n = nb * b
    Ad, Ao, V = (np.asarray(x) for x in make_banded_problem(nb, b, k))
    S = BlockTriDiagStorage.from_matrix_blocks(t(Ad), t(Ao))
    D, O, Vt = (x.clone().requires_grad_(True) for x in (S.diag, S.off,
                                                          t(V)))
    with _Sizes() as mode:
        out = api.chol_update(BlockTriDiagStorage(D, O), Vt, method=method)
        grads = torch.autograd.grad(out.logdet(), (D, O, Vt),
                                    allow_unused=True)
    assert grads[0] is not None and grads[2] is not None
    biggest = max(mode.sizes)
    assert biggest[0] < n * n // 2, biggest
    assert biggest[0] >= nb * b * b, biggest
