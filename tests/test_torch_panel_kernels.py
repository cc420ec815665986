"""The port's per-panel kernels (plain versions) and the ``pallas`` /
``pallas_gemm`` cascade against the JAX package.

The JAX side runs its Pallas kernels as its own tests do on the CPU
(``interpret=True``); the port runs on CPU tensors, where every wrapper
takes its kernel's plain version. The CUDA kernels are held against the
same plain versions in ``tests/test_torch_cuda.py`` (on the card).
Tolerances: fp32 ``tol_for(float32, n)``; bf16 storage the relative
Frobenius error of the reconstructed A within ``SINGLE_UPDATE_RTOL`` and
within 2x of the JAX package's own error; f64 against a numpy float64
refactorization.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as japi
import repro.core.blocked as jblocked
import repro.kernels.cholupdate as jK
import repro.kernels.fused as jfused
from repro_torch.core import api, blocked
from repro_torch.kernels import _launch
from repro_torch.kernels import cholupdate as K
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import ops
from tests.strategies import make_problem, tol_for

BF16_EPS = 2.0 ** -8
SINGLE_UPDATE_RTOL = 32 * BF16_EPS  # tests/test_precision.py


def t(x):
    return torch.from_numpy(np.array(x))


def problem(n, k, seed=0, sigma=1, dtype=np.float32):
    """numpy (L, V) by make_problem's procedure; for a downdate L is the
    factor of A + V V^T."""
    if dtype == np.float64:
        rng = np.random.default_rng(seed)
        B = rng.uniform(size=(n, n))
        V = rng.uniform(size=(n, k))
        L = np.linalg.cholesky(B.T @ B + np.eye(n)).T
    else:
        L, V = (np.asarray(x) for x in make_problem(n, k, seed=seed))
    if sigma < 0:
        A = L.T.astype(np.float64) @ L + V.astype(np.float64) @ V.T
        L = np.linalg.cholesky(A).T.astype(dtype)
    return L, V


def rel_frob_A(L_new, L, V, sigma):
    L_new = np.asarray(L_new, np.float64)
    A = L.astype(np.float64).T @ L + sigma * V.astype(np.float64) @ V.T
    return float(np.linalg.norm(L_new.T @ L_new - A) / np.linalg.norm(A))


# ---------------------------------------------------------------------------
# the three kernels' plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("P,k", [(8, 1), (16, 4), (32, 16)])
def test_diag_block_matches_jax(P, k, sigma):
    L, V = problem(P + 8, k, seed=P * k, sigma=sigma)
    D, vtd = L[:P, :P], np.ascontiguousarray(V[:P].T)
    ours = K.diag_block(t(D), t(vtd), sigma=sigma)
    theirs = jK.diag_block(jnp.asarray(D), jnp.asarray(vtd), sigma=sigma,
                           interpret=True)
    for x, y in zip(ours, theirs):
        assert x.shape == tuple(y.shape) and x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                   atol=tol_for(np.float32, P))
    # The on-device pass equals the blocked driver's serial one.
    ref = blocked.panel_diag(t(D), t(vtd), sigma, with_transform=True)
    for x, y in zip(ours, ref):
        np.testing.assert_allclose(x.numpy(), y.numpy(),
                                   atol=tol_for(np.float32, P))


def test_diag_block_bf16_keeps_state_in_accum_and_matches_jax():
    P, k = 16, 4
    L, V = problem(P, k, seed=3)
    D, vtd = L.astype(jnp.bfloat16), np.ascontiguousarray(V.T)
    D_t = t(L).bfloat16()
    ours = K.diag_block(D_t, t(vtd).bfloat16(), sigma=1,
                        accum_dtype=torch.float32)
    theirs = jK.diag_block(jnp.asarray(D), jnp.asarray(vtd, jnp.bfloat16),
                           sigma=1, interpret=True, accum_dtype=jnp.float32)
    assert ours[0].dtype == torch.bfloat16
    assert all(x.dtype == torch.float32 for x in ours[1:])
    for x, y in zip(ours, theirs):
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(y, np.float32),
                                   atol=4 * BF16_EPS * float(np.abs(y).max()))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("P,k,w,block_w", [(8, 2, 20, 8), (16, 4, 33, 16),
                                           (32, 16, 64, 64)])
def test_panel_applies_match_jax(P, k, w, block_w, dtype):
    rng = np.random.default_rng(P + w)
    L, V = problem(P, k, seed=w)
    _, c, s, T = jblocked.panel_diag(jnp.asarray(L),
                                     jnp.asarray(np.ascontiguousarray(V.T)),
                                     1, with_transform=True)
    R = rng.uniform(size=(P, w)).astype(np.float32)
    vt = (0.1 * rng.uniform(size=(k, w))).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "fp32"
                else (jnp.bfloat16, torch.bfloat16))
    acc_j = None if dtype == "fp32" else jnp.float32
    acc_t = None if dtype == "fp32" else torch.float32
    tol = (tol_for(np.float32, P) if dtype == "fp32"
           else 4 * BF16_EPS * float(np.abs(R).max()))
    Rj, vj = jnp.asarray(R, jdt), jnp.asarray(vt, jdt)
    Rt, vt_t = t(R).to(tdt), t(vt).to(tdt)
    pairs = [
        (K.panel_apply_gemm(Rt, vt_t, t(T), block_w=block_w,
                            accum_dtype=acc_t),
         jK.panel_apply_gemm(Rj, vj, T, block_w=block_w, interpret=True,
                             accum_dtype=acc_j)),
        (K.panel_apply_paper(Rt, vt_t, t(c), t(s), sigma=1, block_w=block_w,
                             accum_dtype=acc_t),
         jK.panel_apply_paper(Rj, vj, c, s, sigma=1, block_w=block_w,
                              interpret=True, accum_dtype=acc_j)),
    ]
    for ours, theirs in pairs:
        for x, y in zip(ours, theirs):
            assert x.dtype == tdt and x.shape == tuple(y.shape)
            np.testing.assert_allclose(x.float().numpy(),
                                       np.asarray(y, np.float32), atol=tol)


def test_in_place_forms_equal_the_functional_ones_on_views():
    P, k, n = 8, 3, 24
    L, V = problem(n, k, seed=5)
    Lt, vt = t(L), t(np.ascontiguousarray(V.T))
    D_new, c, s, T = K.diag_block(Lt[:P, :P], vt[:, :P], sigma=1)
    R_g = K.panel_apply_gemm(Lt[:P, P:], vt[:, P:], T)
    R_p = K.panel_apply_paper(Lt[:P, P:], vt[:, P:], c, s, sigma=1)
    for apply in ("gemm", "paper"):
        L2, v2 = Lt.clone(), vt.clone()
        c2, s2, T2 = K.diag_block_(L2[:P, :P], v2[:, :P], sigma=1)
        assert torch.equal(L2[:P, :P], D_new) and not v2[:, :P].any()
        assert torch.equal(T2, T) and torch.equal(c2, c)
        if apply == "gemm":
            K.panel_apply_gemm_(L2[:P, P:], v2[:, P:], T2)
            want = R_g
        else:
            K.panel_apply_paper_(L2[:P, P:], v2[:, P:], c2, s2, sigma=1)
            want = R_p
        assert torch.equal(L2[:P, P:], want[0])
        assert torch.equal(v2[:, P:], want[1])
        # Nothing else of the factor moved.
        assert torch.equal(L2[P:], Lt[P:])


def test_fleet_axis_runs_every_member():
    B, P, k = 3, 8, 2
    Ls, Vs = zip(*(problem(P, k, seed=s) for s in range(B)))
    D = t(np.stack(Ls))
    vtd = t(np.stack([np.ascontiguousarray(V.T) for V in Vs]))
    fleet = K.diag_block(D, vtd, sigma=1)
    for b in range(B):
        one = K.diag_block(D[b], vtd[b], sigma=1)
        for x, y in zip(fleet, one):
            np.testing.assert_allclose(x[b].numpy(), y.numpy(), atol=1e-6)


def test_cpu_wrappers_count_no_launch_and_cuda_wrappers_check_first():
    """CPU tensors take the plain versions: no kernel launch counted. What
    a kernel does not take raises before anything is built or launched."""
    before = {name: c.count for name, c in K.LAUNCHES.items()}
    L, V = problem(16, 2)
    api.chol_update(t(L), t(V), method="pallas_gemm", panel=8)
    api.chol_update(t(L), t(V), method="pallas", panel=8)
    assert {name: c.count for name, c in K.LAUNCHES.items()} == before
    D, vtd = torch.eye(8), torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K._diag_block_cuda(D, vtd, 1, None, False)
    with pytest.raises(ValueError, match="k <= 32"):
        K._diag_block_cuda(D, torch.zeros(33, 8), 1, None, False)
    with pytest.raises(ValueError, match="P <= 256"):
        K._diag_block_cuda(torch.eye(257), torch.zeros(2, 257), 1, None,
                           False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K._apply_cuda(torch.zeros(8, 4), torch.zeros(2, 4),
                      torch.eye(10), None, None, 1, None, False)
    with pytest.raises(ValueError, match="block_w"):
        K.panel_apply_gemm(torch.zeros(8, 4), torch.zeros(2, 4),
                           torch.eye(10), block_w=0)
    assert {name: c.count for name, c in K.LAUNCHES.items()} == before


# ---------------------------------------------------------------------------
# the cascade: blocked driver hooks, ops, backends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["pallas", "pallas_gemm"])
@pytest.mark.parametrize("sigma", [1, -1])
def test_cascade_backends_match_jax(method, sigma):
    n, k, panel = 40, 3, 16
    L, V = problem(n, k, seed=11, sigma=sigma)
    ours = api.chol_update(t(L), t(V), sigma=sigma, method=method,
                           panel=panel)
    theirs = japi.chol_update(jnp.asarray(L), jnp.asarray(V), sigma=sigma,
                              method=method, panel=panel, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                               atol=tol_for(np.float32, n))


@pytest.mark.parametrize("method", ["pallas", "pallas_gemm"])
@pytest.mark.parametrize("sigma", [1, -1])
def test_cascade_f64_against_numpy_refactorization(method, sigma):
    n, k, panel = 21, 3, 8
    L, V = problem(n, k, seed=12, sigma=sigma, dtype=np.float64)
    out = api.chol_update(t(L), t(V), sigma=sigma, method=method,
                          panel=panel)
    assert out.dtype == torch.float64
    L64, V64 = L.astype(np.float64), V.astype(np.float64)
    ref = np.linalg.cholesky(L64.T @ L64 + sigma * V64 @ V64.T).T
    np.testing.assert_allclose(out.numpy(), ref, atol=tol_for(np.float64, n))


@pytest.mark.parametrize("method", ["pallas", "pallas_gemm"])
def test_cascade_bf16_within_budget_and_jax(method):
    n, k, panel = 32, 2, 8
    L, V = problem(n, k, seed=13)
    ours = api.chol_update(t(L), t(V), method=method, panel=panel,
                           precision="bf16")
    theirs = japi.chol_update(jnp.asarray(L), jnp.asarray(V), method=method,
                              panel=panel, interpret=True, precision="bf16")
    assert ours.dtype == torch.bfloat16
    e_ours = rel_frob_A(ours.float().numpy(), L, V, 1)
    e_theirs = rel_frob_A(np.asarray(theirs, np.float32), L, V, 1)
    assert e_ours <= SINGLE_UPDATE_RTOL
    assert e_ours <= 2 * max(e_theirs, BF16_EPS ** 2)


def test_cascade_fleet_matches_members_and_jax_vmap():
    B, n, k, panel = 3, 24, 2, 8
    Ls, Vs = zip(*(problem(n, k, seed=20 + b) for b in range(B)))
    L, V = np.stack(Ls), np.stack(Vs)
    fleet = api.chol_update_batched(t(L), t(V), method="pallas_gemm",
                                    panel=panel)
    theirs = japi.chol_update_batched(jnp.asarray(L), jnp.asarray(V),
                                      method="pallas_gemm", panel=panel,
                                      interpret=True)
    np.testing.assert_allclose(fleet.numpy(), np.asarray(theirs),
                               atol=tol_for(np.float32, n))
    for b in range(B):
        one = api.chol_update(t(L[b]), t(V[b]), method="pallas_gemm",
                              panel=panel)
        np.testing.assert_allclose(fleet[b].numpy(), one.numpy(), atol=1e-6)


def test_blocked_driver_hooks_see_views_and_may_work_in_place():
    n, k, panel = 24, 2, 8
    L, V = problem(n, k, seed=14)
    seen = []

    def diag_fn(D, vtd, sig):
        seen.append(("diag", tuple(D.shape), D._base is not None))
        c, s, T = K.diag_block_(D, vtd, sigma=sig)
        return D, c, s, T

    def apply_fn(R, vt, c, s, T, sig):
        seen.append(("apply", tuple(R.shape), R._base is not None))
        return K.panel_apply_gemm(R, vt, T)  # functional: copied back

    out = blocked.chol_update_blocked(t(L), t(V), panel=panel,
                                      diag_fn=diag_fn, apply_fn=apply_fn)
    ref = blocked.chol_update_blocked(t(L), t(V), panel=panel)
    np.testing.assert_allclose(out.numpy(), ref.numpy(),
                               atol=tol_for(np.float32, n))
    assert [s[0] for s in seen] == ["diag", "apply"] * 2 + ["diag"]
    assert all(s[2] for s in seen)  # views of the padded factor
    assert seen[1][1] == (panel, n - panel)
    with pytest.raises(ValueError, match="diag_fn"):
        blocked.chol_update_blocked(t(L[None]), t(V[None]), panel=panel)


def test_ops_validation_and_diag_block_pallas():
    L, V = problem(16, 2)
    with pytest.raises(ValueError, match="strategy"):
        ops.chol_update_pallas(t(L), t(V), strategy="nope")
    # interpret=True on the CPU runs the plain versions, like None.
    a = ops.chol_update_pallas(t(L), t(V), panel=8, interpret=True)
    b = ops.chol_update_pallas(t(L), t(V), panel=8)
    assert torch.equal(a, b)
    D, vtd = t(L[:8, :8]), t(np.ascontiguousarray(V[:8].T))
    for x, y in zip(ops.diag_block_pallas(D, vtd),
                    K.diag_block(D, vtd, sigma=1)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# the rules that keep the CUDA routes inside the kernels' limits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("panel,want", [(1, 1), (64, 64), (256, 256),
                                        (300, 150), (384, 192), (512, 256),
                                        (1000, 250), (257, 1), (771, 3)])
def test_kernel_panel_is_the_largest_divisor_at_most_256(panel, want):
    got = _launch.kernel_panel(panel)
    assert got == want and panel % got == 0 and got <= 256
    with pytest.raises(ValueError):
        _launch.kernel_panel(0)


@pytest.mark.parametrize("k,sizes", [(1, [1]), (32, [32]), (33, [32, 1]),
                                     (48, [32, 16]), (96, [32, 32, 32])])
def test_rank_groups_cover_k_in_groups_of_at_most_32(k, sizes):
    groups = _launch.rank_groups(k)
    assert [g.stop - g.start for g in groups] == sizes
    assert groups[0].start == 0 and groups[-1].stop == k
    assert all(a.stop == b.start for a, b in zip(groups, groups[1:]))
    with pytest.raises(ValueError):
        _launch.rank_groups(0)


@pytest.mark.parametrize("batch,w,k,sms,itemsize,nw", [
    (1, 4864, 16, 132, 4, 4),    # n = 5000, panel 0: 608 CTAs, 5 an SM
    (1, 4096, 16, 132, 4, 16),   # 128 CTAs of 16 warps, one an SM
    (1, 256, 16, 132, 4, 4),     # the narrow tail: the tick's latency
    (64, 768, 16, 132, 4, 16),   # the B = 64 fleet: fewer CTAs stage
    (1, 4864, 1, 132, 8, 4),     # f64 at k = 1: the row ring caps nw
    (1, 1, 32, 132, 4, 4),
])
def test_paper_warps(batch, w, k, sms, itemsize, nw):
    got = _launch.paper_warps(batch, w, k, sms, itemsize)
    assert got == nw and got in _launch.PAPER_WARPS
    assert _launch.paper_smem(k, got, itemsize) <= _launch.PAPER_SMEM_CAP


@pytest.mark.parametrize("k,lanes", [(1, 1), (2, 8), (8, 8), (9, 16),
                                     (16, 16), (17, 32), (32, 32)])
def test_paper_lanes_are_the_kernels_buckets(k, lanes):
    assert _launch.paper_lanes(k) == lanes
    with pytest.raises(ValueError):
        _launch.paper_lanes(33)


def test_launch_count_of_the_cuda_routes():
    # The JAX package's counts without k (test_torch_fused.py pins them).
    assert tfused.launch_count(5000, 256, method="pallas_2phase") == 39
    # With k: ceil(k / 32) groups, panels of the kernel panel.
    assert tfused.launch_count(5000, 256, method="pallas_2phase", k=16) == 39
    assert tfused.launch_count(5000, 256, method="fused", k=16) == 1
    assert tfused.launch_count(5000, 256, method="fused", k=48) == 2
    assert tfused.launch_count(600, 512, method="fused", k=48) == 2
    # n = 600 pads to 1024 at panel 512, which runs as 4 panels of 256.
    assert tfused.launch_count(600, 512, method="pallas_2phase", k=48) == 14
    assert tfused.launch_count(600, 512, method="pallas", k=1) == 3
    assert tfused.launch_count(100, 300, method="pallas_2phase", k=1) == 3
    assert jfused.launch_count(5000, 256, method="pallas_2phase") == 39
