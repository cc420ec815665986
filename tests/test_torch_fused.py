"""The port's fused chain (plain version) against the JAX fused kernel.

The JAX side runs its fused kernel as its own tests do on the CPU:
``chol_update_fused(..., lowering='portable', interpret=True)``. The port
runs on CPU tensors, where the wrapper takes the plain chain walk. The CUDA
kernel itself is held against the same plain version in
``tests/test_torch_cuda.py`` (on the card).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.cholupdate as jcholupdate
import repro.kernels.fused as jfused
from repro_torch.kernels import cholupdate as tcholupdate
from repro_torch.kernels import fused as tfused
from repro_torch.obs import metrics as tmetrics
from tests.strategies import make_problem, tol_for

BF16_EPS = 2.0 ** -8
SINGLE_UPDATE_RTOL = 32 * BF16_EPS  # tests/test_precision.py


def problem(n, k, seed=0, sigma=1):
    L, V = (np.asarray(x) for x in make_problem(n, k, seed=seed))
    if sigma < 0:
        A = L.T.astype(np.float64) @ L + V.astype(np.float64) @ V.T
        L = np.linalg.cholesky(A).T.astype(np.float32)
    return L, V


def t(x):
    return torch.from_numpy(np.array(x))


def jax_fused(L, V, **kw):
    return np.asarray(jfused.chol_update_fused(
        jnp.asarray(L), jnp.asarray(V), lowering="portable", interpret=True,
        **kw))


def rel_frob_A(L_new, L, V, sigma):
    L_new = np.asarray(L_new, np.float64)
    A = L.astype(np.float64).T @ L + sigma * V.astype(np.float64) @ V.T
    return float(np.linalg.norm(L_new.T @ L_new - A) / np.linalg.norm(A))


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("grid_mode", ["indexed", "rect"])
@pytest.mark.parametrize("panel_apply", ["gemm", "paper"])
def test_plain_chain_matches_jax_fused(panel_apply, grid_mode, sigma):
    n, k, panel = 40, 3, 16  # ragged: 40 pads to 48, three tiles
    L, V = problem(n, k, seed=n + k, sigma=sigma)
    kw = dict(sigma=sigma, panel=panel, panel_apply=panel_apply,
              grid_mode=grid_mode)
    ours = tfused.chol_update_fused(t(L), t(V), **kw)
    assert ours.shape == (n, n) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), jax_fused(L, V, **kw),
                               atol=tol_for(np.float32, n))
    assert torch.equal(ours, torch.triu(ours))


def test_rank1_vector_and_grid_modes_identical():
    n, panel = 20, 8
    L, V = problem(n, 1, seed=2)
    vec = tfused.chol_update_fused(t(L), t(V[:, 0]), panel=panel)
    mat = tfused.chol_update_fused(t(L), t(V), panel=panel)
    rect = tfused.chol_update_fused(t(L), t(V), panel=panel,
                                    grid_mode="rect")
    assert torch.equal(vec, mat) and torch.equal(mat, rect)
    np.testing.assert_allclose(
        vec.numpy(), jax_fused(L, V[:, 0], panel=panel),
        atol=tol_for(np.float32, n))


@pytest.mark.parametrize("panel_apply", ["gemm", "paper"])
def test_bf16_chain_within_budget_and_jax(panel_apply):
    n, k, panel = 32, 4, 16
    L, V = problem(n, k, seed=8)
    kw = dict(panel=panel, panel_apply=panel_apply, precision="bf16")
    ours = tfused.chol_update_fused(t(L), t(V), **kw)
    assert ours.dtype == torch.bfloat16
    theirs = jax_fused(L, V, **kw).astype(np.float32)
    e_ours = rel_frob_A(ours.float().numpy(), L, V, 1)
    e_jax = rel_frob_A(theirs, L, V, 1)
    assert e_ours <= SINGLE_UPDATE_RTOL
    assert e_ours <= 2 * e_jax


@pytest.mark.parametrize("panel_apply", ["gemm", "paper"])
@pytest.mark.parametrize("sigma", [1, -1])
def test_f64_chain_against_numpy_refactorization(panel_apply, sigma):
    n, k, panel = 30, 2, 16
    rng = np.random.default_rng(3)
    B = rng.uniform(size=(n, n))
    V = rng.uniform(size=(n, k))
    A = B.T @ B + np.eye(n) + (V @ V.T if sigma < 0 else 0.0)
    L = np.linalg.cholesky(A).T
    out = tfused.chol_update_fused(t(L), t(V), sigma=sigma, panel=panel,
                                   panel_apply=panel_apply)
    assert out.dtype == torch.float64
    oracle = np.linalg.cholesky(A + sigma * V @ V.T).T
    np.testing.assert_allclose(out.numpy(), oracle,
                               atol=tol_for(np.float64, n))


@pytest.mark.parametrize("accum", [None, "bf16"])
def test_value_math_matches_jax(accum):
    """diag_recurrence and apply_rotations: the plain versions the CUDA
    kernel's device functions are held against."""
    P, k, w, sigma = 8, 3, 6, -1
    L, V = problem(P, k, seed=4, sigma=sigma)
    vtd = np.ascontiguousarray(V.T)
    acc_t, acc_j = (None, None) if accum is None else (torch.float32,
                                                       jnp.float32)
    if accum is not None:  # bf16 storage: round the inputs once, as stored
        L = np.asarray(jnp.asarray(L, jnp.bfloat16).astype(jnp.float32))
        vtd = np.asarray(jnp.asarray(vtd, jnp.bfloat16).astype(jnp.float32))
    ours = tcholupdate.diag_recurrence(t(L), t(vtd), sigma=sigma, rows=P,
                                       k=k, accum_dtype=acc_t)
    theirs = jcholupdate.diag_recurrence(jnp.asarray(L), jnp.asarray(vtd),
                                         sigma=sigma, rows=P, k=k,
                                         accum_dtype=acc_j)
    tol = tol_for(np.float32, P)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol)
    _, c, s, _ = ours
    rng = np.random.default_rng(5)
    R = rng.uniform(size=(P, w)).astype(np.float32)
    vt = (0.1 * rng.uniform(size=(k, w))).astype(np.float32)
    a = tcholupdate.apply_rotations(t(R), t(vt), c, s, sigma=sigma, rows=P,
                                    k=k, accum_dtype=acc_t)
    b = jcholupdate.apply_rotations(jnp.asarray(R), jnp.asarray(vt),
                                    jnp.asarray(c.numpy()),
                                    jnp.asarray(s.numpy()), sigma=sigma,
                                    rows=P, k=k, accum_dtype=acc_j)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=tol)


def test_fleet_in_one_call_matches_members_and_jax_vmap():
    Bn, n, k, panel = 3, 20, 2, 8
    Ls, Vs = zip(*[problem(n, k, seed=10 + b) for b in range(Bn)])
    Lb, Vb = np.stack(Ls), np.stack(Vs)
    before = tmetrics.value("repro.kernels.plain_walks", module="fused")
    fleet = tfused.chol_update_fused(t(Lb), t(Vb), panel=panel)
    assert tmetrics.value("repro.kernels.plain_walks",
                          module="fused") == before + 1
    assert fleet.shape == (Bn, n, n)
    for b in range(Bn):
        one = tfused.chol_update_fused(t(Ls[b]), t(Vs[b]), panel=panel)
        np.testing.assert_allclose(fleet[b].numpy(), one.numpy(), atol=1e-6)
    theirs = np.asarray(jax.vmap(lambda l, v: jfused.chol_update_fused(
        l, v, panel=panel, lowering="portable", interpret=True))(
            jnp.asarray(Lb), jnp.asarray(Vb)))
    np.testing.assert_allclose(fleet.numpy(), theirs,
                               atol=tol_for(np.float32, n))


@pytest.mark.parametrize("n,panel", [(1, 1), (100, 32), (256, 64),
                                     (5000, 256)])
def test_accounting_matches_jax(n, panel):
    for method in ("fused", "pallas", "pallas_gemm", "pallas_2phase"):
        assert tfused.launch_count(n, panel, method=method) == \
            jfused.launch_count(n, panel, method=method)
    for grid_mode in tfused.GRID_MODES:
        assert tfused.grid_steps(n, panel, grid_mode=grid_mode) == \
            jfused.grid_steps(n, panel, grid_mode=grid_mode)
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16),
                         (torch.float64, jnp.float32)):
            ours = tfused.bytes_per_update(n, panel, 16, storage_dtype=tdt,
                                           grid_mode=grid_mode)
            theirs = jfused.bytes_per_update(n, panel, 16,
                                             storage_dtype=jdt,
                                             grid_mode=grid_mode)
            scale = 2 if tdt == torch.float64 else 1  # x64 is off in JAX
            assert ours == scale * theirs
    with pytest.raises(ValueError):
        tfused.launch_count(n, panel, method="nope")
    with pytest.raises(ValueError):
        tfused.grid_steps(n, panel, grid_mode="nope")
    with pytest.raises(ValueError):
        tfused.bytes_per_update(n, panel, 1, storage_dtype=torch.float32,
                                grid_mode="nope")


def test_ops_per_update_counts_both_applies():
    n, P, k = 5000, 256, 16
    gemm = tfused.ops_per_update(n, P, k, panel_apply="gemm")
    paper = tfused.ops_per_update(n, P, k, panel_apply="paper")
    tiles = 20 * 19 // 2
    assert gemm - paper == tiles * (2 * (P + k) ** 2 * P - 6 * P * P * k)
    assert gemm > 5 * paper
    with pytest.raises(ValueError):
        tfused.ops_per_update(n, P, k, panel_apply="nope")


@pytest.mark.parametrize("grid_mode", ["indexed", "rect"])
@pytest.mark.parametrize("sigma", [1, -1])
def test_mosaic_lowering_matches_portable_and_jax(grid_mode, sigma):
    """tests/test_fused.py's portable == mosaic == reference, on the port:
    'mosaic' runs the one fused chain (its plain version on CPU tensors)
    and equals 'portable' bit for bit; both agree with the JAX package's
    mosaic and portable kernels within tol_for."""
    n, k, panel = 96, 4, 32
    L, V = problem(n, k, seed=61, sigma=sigma)
    kw = dict(sigma=sigma, panel=panel, grid_mode=grid_mode)
    ours = {lw: tfused.chol_update_fused(t(L), t(V), lowering=lw, **kw)
            for lw in ("mosaic", "portable")}
    assert torch.equal(ours["mosaic"], ours["portable"])
    for lw in ("mosaic", "portable"):
        theirs = np.asarray(jfused.chol_update_fused(
            jnp.asarray(L), jnp.asarray(V), lowering=lw, interpret=True,
            **kw))
        np.testing.assert_allclose(ours[lw].numpy(), theirs,
                                   atol=tol_for(jnp.float32, n))


def test_argument_and_lowering_validation():
    L, V = problem(8, 1)
    with pytest.raises(ValueError, match="sigma"):
        tfused.chol_update_fused(t(L), t(V), sigma=2)
    with pytest.raises(ValueError, match="panel_apply"):
        tfused.chol_update_fused(t(L), t(V), panel_apply="nope")
    with pytest.raises(ValueError, match="grid_mode"):
        tfused.chol_update_fused(t(L), t(V), grid_mode="nope")
    with pytest.raises(ValueError, match="'auto', 'mosaic', 'portable'"):
        tfused.chol_update_fused(t(L), t(V), lowering="triton")
    for lowering in (None, "auto", "portable", "mosaic"):
        tfused.chol_update_fused(t(L), t(V), panel=4, lowering=lowering)


def test_cuda_wrapper_checks_before_it_launches():
    """What the kernel does not take raises before any build or launch; a
    CPU tensor never reaches the kernel and the launch count stays put."""
    P, k, n = 16, 2, 32
    L = torch.eye(n)[None]
    vt = torch.zeros(1, k, n)
    before = tfused.LAUNCHES.count
    for lowering in ("portable", "mosaic"):  # the launch's label
        with pytest.raises(ValueError, match="CUDA tensors"):
            tfused.fused_chain_cuda(L, vt, sigma=1, panel=P,
                                    lowering=lowering)
    with pytest.raises(ValueError, match=r"k <= 32"):
        tfused.fused_chain_cuda(torch.eye(64)[None], torch.zeros(1, 33, 64),
                                sigma=1, panel=P)
    with pytest.raises(ValueError, match=r"panel <= 256"):
        tfused.fused_chain_cuda(torch.eye(512)[None],
                                torch.zeros(1, k, 512), sigma=1, panel=512)
    with pytest.raises(ValueError, match="storage/accum"):
        tfused.fused_chain_cuda(L.half(), vt.half(), sigma=1, panel=P)
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_chain_cuda(L.mT, vt, sigma=1, panel=P)
    with pytest.raises(ValueError, match="shape"):
        tfused.fused_chain_cuda(L, torch.zeros(1, k, n + 1), sigma=1,
                                panel=P)
    assert tfused.LAUNCHES.count == before


@pytest.mark.parametrize("batch,n_tiles,panel,sms,groups", [
    (1, 20, 256, 132, 8),   # n = 5000: 160 blocks, 32 columns each
    (64, 4, 256, 132, 1),   # the B = 64 fleet fills the card alone
    (1, 4, 64, 132, 2),     # 32-column groups at most
    (3, 4, 32, 132, 1),
    (1, 1, 100, 132, 1),    # a panel that is no multiple of 32
])
def test_column_groups(batch, n_tiles, panel, sms, groups):
    assert tfused.column_groups(batch, n_tiles, panel, sms) == groups


def test_plain_walk_counts_no_kernel_launch():
    L, V = problem(16, 2)
    before = tfused.LAUNCHES.count
    launches = dict(module="fused", lowering="portable")
    l0 = tmetrics.value("repro.kernels.launches", **launches)
    p0 = tmetrics.value("repro.kernels.plain_walks", module="fused")
    tfused.chol_update_fused(t(L), t(V), panel=8)
    assert tfused.LAUNCHES.count == before
    assert tmetrics.value("repro.kernels.launches", **launches) == l0
    assert tmetrics.value("repro.kernels.plain_walks",
                          module="fused") == p0 + 1
