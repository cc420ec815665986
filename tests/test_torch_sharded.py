"""The port's column-sharded driver and its panel kernel against the JAX
package, in process: one gloo rank on the CPU against a one-device JAX
mesh.

The same numpy inputs go through both packages. The panel kernel's plain
version is held against the JAX kernel run as its own CPU tests run it
(``interpret=True``); the driver against ``chol_update_sharded``.
Tolerances: fp32 ``tol_for(float32, n)``; bf16 storage the relative
Frobenius error of the reconstructed A within ``32 eps_bf16`` and within
2x of the JAX package's own; f64 against a numpy float64 refactorization.
The process group is initialised through a ``file://`` store in a
temporary directory (never a TCP port) and destroyed by the fixture.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro.core.api import chol_update_batched as jchol_update_batched
from repro.core.distributed import chol_update_sharded as jsharded
from repro.core.factor import CholFactor as JFactor
from repro.kernels import sharded as jk
from repro.runtime.compat import make_mesh_compat
from repro_torch.core import CholFactor, api, distributed
from repro_torch.interop import factor_from_numpy, factor_to_numpy
from repro_torch.kernels import sharded as tk
from repro_torch.obs import metrics as tmetrics
from tests.strategies import make_batched_problem, make_problem, tol_for

N, K, PANEL = 32, 3, 8
BF16_EPS = 2.0 ** -8


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("sharded_store") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def jmesh():
    return make_mesh_compat((1,), ("model",))


def t(x):
    return torch.from_numpy(np.array(x))


def downdate_start(L, V):
    """The factor of A + V V^T (float64), so that the downdate stays PD."""
    A = L.astype(np.float64).swapaxes(-1, -2) @ L + V.astype(
        np.float64) @ V.swapaxes(-1, -2)
    return np.linalg.cholesky(A).swapaxes(-1, -2).astype(L.dtype)


def rel_frob_A(L_new, L, V, sigma):
    L_new = np.asarray(L_new, np.float64)
    L, V = np.asarray(L, np.float64), np.asarray(V, np.float64)
    A = L.swapaxes(-1, -2) @ L + sigma * V @ V.swapaxes(-1, -2)
    return float(np.linalg.norm(L_new.swapaxes(-1, -2) @ L_new - A)
                 / np.linalg.norm(A))


# ---------------------------------------------------------------------------
# the panel kernel
# ---------------------------------------------------------------------------


def stacks(B, n, w, P, k, seed):
    """Random panel-phase operands as the chain phase shapes them: T's
    top-left P x P block lower triangular, D upper triangular."""
    rng = np.random.default_rng(seed)
    lead = (B,) if B else ()
    n_panels = n // P
    L = rng.uniform(-1, 1, size=lead + (n, w)).astype(np.float32)
    T = rng.uniform(-1, 1, size=lead + (n_panels, P + k, P + k))
    T[..., :P, :P] = np.tril(T[..., :P, :P])
    D = np.triu(rng.uniform(0.5, 1.5, size=lead + (n_panels, P, P)))
    vt = rng.uniform(-1, 1, size=lead + (n_panels, k, w)).astype(np.float32)
    return L, T.astype(np.float32), D.astype(np.float32), vt


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("tile_off", [0, 1, 2, 3])
def test_plain_panel_kernel_matches_jax(tile_off, batch, dtype):
    n, w, P, k = 48, 16, 8, 3  # six panels, two local tiles
    L, T, D, vt = stacks(batch, n, w, P, k, seed=tile_off)
    st_t, st_j = ((torch.float32, jnp.float32) if dtype == "fp32"
                  else (torch.bfloat16, jnp.bfloat16))
    ours = tk.panel_apply_sharded(
        t(L).to(st_t), t(T), t(D), t(vt).to(st_t), tile_off=tile_off,
        panel=P, accum_dtype=torch.float32)
    assert ours.dtype == st_t and ours.shape == L.shape
    theirs = jk.panel_apply_sharded(
        jnp.asarray(L, st_j), jnp.asarray(T), jnp.asarray(D),
        jnp.asarray(vt, st_j), tile_off=tile_off, panel=P, interpret=True,
        accum_dtype=jnp.float32, lowering="portable")
    ours = ours.float().numpy()
    theirs = np.asarray(theirs, np.float32)
    if dtype == "fp32":
        np.testing.assert_allclose(ours, theirs, atol=tol_for(np.float32, n))
    else:
        rel = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
        assert rel <= 32 * BF16_EPS
    # Diagonal and zero tiles are copies: exact in both.
    for p in range(n // P):
        for tt in range(w // P):
            g = tile_off + tt
            blk = (..., slice(p * P, (p + 1) * P), slice(tt * P, (tt + 1) * P))
            if p >= g:
                np.testing.assert_array_equal(ours[blk], theirs[blk])


def test_panel_kernel_wrapper_rules():
    L, T, D, vt = (t(x) for x in stacks(None, 16, 16, 8, 2, seed=0))
    w0 = tmetrics.value("repro.kernels.plain_walks", module="sharded")
    l0 = tk.LAUNCHES.count
    tk.panel_apply_sharded(L, T, D, vt, tile_off=0, panel=8, interpret=True)
    # A CPU tensor runs the plain version: a walk, not a launch.
    assert tmetrics.value("repro.kernels.plain_walks",
                          module="sharded") == w0 + 1
    assert tk.LAUNCHES.count == l0
    with pytest.raises(ValueError, match="lowering"):
        tk.panel_apply_sharded(L, T, D, vt, tile_off=0, panel=8,
                               lowering="triton")
    with pytest.raises(ValueError, match="CUDA tensors"):  # the label
        tk.panel_apply_sharded_cuda(L, T, D, vt, tile_off=0, panel=8,
                                    lowering="mosaic")
    with pytest.raises(ValueError, match="takes T_stack"):
        tk.panel_apply_sharded(L, T[:1], D, vt, tile_off=0, panel=8)
    assert tk.launch_count_sharded(5120, 256, strategy="fused") == \
        jk.launch_count_sharded(5120, 256, strategy="fused") == 1
    assert tk.launch_count_sharded(5120, 256, strategy="gemm") == 0
    assert tk.launch_count_sharded(5120, 256, strategy="fused", k=48) == 2
    assert tk.kernel_launches(5120, 256, strategy="fused", k=16) == {
        "diag_block": 20, "panel_apply_sharded": 1}
    assert tk.kernel_launches(1024, 512, strategy="paper", k=40) == {
        "diag_block": 8, "panel_apply_paper": 8}


# ---------------------------------------------------------------------------
# the driver, one rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("strategy", ["fused", "gemm", "paper"])
def test_one_rank_driver_matches_jax(mesh, jmesh, strategy, sigma):
    L, V = (np.asarray(x) for x in make_problem(N, K, seed=1))
    if sigma < 0:
        L = downdate_start(L, V)
    with jmesh:
        theirs = jsharded(jnp.asarray(L), jnp.asarray(V), sigma=sigma,
                          mesh=jmesh, axis="model", panel=PANEL,
                          strategy=strategy, interpret=True)
    w0 = tmetrics.value("repro.kernels.plain_walks", module="sharded")
    ours = api.chol_update(t(L), t(V), sigma=sigma, method="sharded",
                           mesh=mesh, panel=PANEL, strategy=strategy)
    assert distributed.is_sharded(ours)
    assert ours.placements == tuple(
        distributed._placements(mesh, ("model",), 2))
    assert tmetrics.value("repro.kernels.plain_walks", module="sharded") \
        == w0 + (strategy == "fused")
    np.testing.assert_allclose(distributed.gather(ours).numpy(),
                               np.asarray(theirs),
                               atol=tol_for(np.float32, N))


@pytest.mark.parametrize("strategy", ["fused", "paper"])
def test_one_rank_fleet_and_bf16_match_jax(mesh, jmesh, strategy):
    Ls, Vs = (np.asarray(x) for x in make_batched_problem(3, N, K, seed=4))
    with jmesh:
        theirs = jchol_update_batched(
            jnp.asarray(Ls), jnp.asarray(Vs), method="sharded", mesh=jmesh,
            axis="model", panel=PANEL, strategy=strategy, interpret=True)
        theirs16 = jchol_update_batched(
            jnp.asarray(Ls), jnp.asarray(Vs), method="sharded", mesh=jmesh,
            axis="model", panel=PANEL, strategy=strategy, interpret=True,
            precision="bf16")
    ours = api.chol_update_batched(t(Ls), t(Vs), method="sharded",
                                   mesh=mesh, panel=PANEL, strategy=strategy)
    np.testing.assert_allclose(distributed.gather(ours).numpy(),
                               np.asarray(theirs),
                               atol=tol_for(np.float32, N))
    ours16 = api.chol_update_batched(t(Ls), t(Vs), method="sharded",
                                     mesh=mesh, panel=PANEL,
                                     strategy=strategy, precision="bf16")
    assert ours16.dtype == torch.bfloat16
    for m in range(3):
        e_t = rel_frob_A(distributed.gather(ours16)[m].float(), Ls[m],
                         Vs[m], 1)
        e_j = rel_frob_A(np.asarray(theirs16[m], np.float32), Ls[m], Vs[m],
                         1)
        assert e_t <= 32 * BF16_EPS and e_t <= 2 * e_j


@pytest.mark.parametrize("strategy", ["fused", "gemm", "paper"])
def test_one_rank_f64_matches_numpy(mesh, strategy):
    rng = np.random.default_rng(5)
    Bm, V = rng.uniform(size=(N, N)), rng.uniform(size=(N, K))
    A = Bm.T @ Bm + np.eye(N)
    L = np.linalg.cholesky(A).T
    for sigma, start in ((1, L), (-1, downdate_start(L, V))):
        ours = api.chol_update(t(start), t(V), sigma=sigma, method="sharded",
                               mesh=mesh, panel=PANEL, strategy=strategy)
        want = np.linalg.cholesky(start.T @ start + sigma * V @ V.T).T
        out = distributed.gather(ours).numpy()
        assert out.dtype == np.float64
        np.testing.assert_allclose(out, want, atol=tol_for(np.float64, N))


class _FourShardMesh:
    """A mesh-shaped stand-in of four ranks on one dim: validation runs
    before any collective, so it needs only names and sizes."""

    mesh_dim_names = ("model",)

    def size(self, dim=None):
        return 4


def test_validation_errors(mesh):
    L, V = (t(x) for x in make_problem(N, K, seed=2))
    with pytest.raises(ValueError, match="requires a mesh"):
        api.chol_update(L, V, method="sharded")
    with pytest.raises(ValueError, match="requires a mesh"):
        CholFactor.from_factor(L, backend="sharded").update(V)
    with pytest.raises(ValueError, match="sigma"):
        distributed.chol_update_sharded(L, V, sigma=2, mesh=mesh)
    with pytest.raises(ValueError, match="strategy"):
        distributed.chol_update_sharded(L, V, mesh=mesh, strategy="nope")
    with pytest.raises(ValueError, match="column shards"):
        distributed.chol_update_sharded(L[:30, :30], V[:30],
                                        mesh=_FourShardMesh(), panel=2)
    with pytest.raises(ValueError, match="per-device column count"):
        distributed.chol_update_sharded(L, V, mesh=mesh, panel=12)
    with pytest.raises(ValueError, match="per-device column count"):
        distributed.chol_update_sharded(L, V, mesh=_FourShardMesh(),
                                        panel=16)
    with pytest.raises(ValueError, match="must name dims"):
        distributed.chol_update_sharded(L, V, mesh=mesh, axis="data",
                                        panel=PANEL)
    with pytest.raises(ValueError, match="matching L"):
        distributed.chol_update_sharded(L[None], V[None, :8], mesh=mesh,
                                        panel=PANEL)
    with pytest.raises(ValueError, match="lowering"):
        distributed.chol_update_sharded(L, V, mesh=mesh, panel=PANEL,
                                        lowering="triton")
    # 'auto' never picks the collective backend.
    from repro_torch.core import backends

    assert backends.get("sharded").kind == "collective"
    for dev in ("cpu", None):
        assert backends.resolve("auto", n=N, device=dev) != "sharded"


def test_factor_and_interop_round_trip(mesh, jmesh):
    L, V = (np.asarray(x) for x in make_problem(N, K, seed=6))
    jf = JFactor.from_factor(jnp.asarray(L), panel=PANEL, backend="sharded",
                             mesh=jmesh, axis="model", interpret=True)
    tf = factor_from_numpy(np.asarray(jf.data), panel=PANEL,
                           backend="sharded", mesh=mesh, axis=jf.axis)
    assert distributed.is_sharded(tf.data) and tf.n == N
    assert not tf.batched and tf.mesh is mesh and tf.axis == "model"
    with jmesh:
        ju = jf.update(jnp.asarray(V))
    tu = tf.update(t(V))
    data, meta = factor_to_numpy(tu)
    assert meta["backend"] == "sharded" and meta["axis"] == "model"
    np.testing.assert_allclose(data, np.asarray(ju.data),
                               atol=tol_for(np.float32, N))
    # Consumers gather the whole factor first.
    b = np.random.default_rng(7).normal(size=(N,)).astype(np.float32)
    np.testing.assert_allclose(tu.solve(t(b)).numpy(),
                               np.asarray(ju.solve(jnp.asarray(b))),
                               rtol=1e-3, atol=tol_for(np.float32, N))
    np.testing.assert_allclose(float(tu.logdet()), float(ju.logdet()),
                               rtol=1e-5)
    assert bool(tu.is_valid())


@pytest.mark.parametrize("fleet", [False, True])
def test_sharded_diagonal_never_gathers_the_factor(mesh, jmesh, monkeypatch,
                                                   fleet):
    """``diagonal``, ``is_valid`` and ``logdet`` of a sharded factor read
    the diagonal shard by shard (O(n)), never the whole factor, and agree
    with the JAX factor's."""
    if fleet:
        L, V = (np.asarray(x) for x in make_batched_problem(2, N, K, seed=9))
    else:
        L, V = (np.asarray(x) for x in make_problem(N, K, seed=9))
    tu = CholFactor(t(L), panel=PANEL, backend="sharded",
                    mesh=mesh).update(t(V))
    with jmesh:
        ju = JFactor(jnp.asarray(L), panel=PANEL, backend="sharded",
                     mesh=jmesh, interpret=True).update(jnp.asarray(V))
    full = distributed.gather(tu.data)

    def no_gather(x):
        raise AssertionError("the whole factor was gathered")

    monkeypatch.setattr(distributed, "gather", no_gather)
    np.testing.assert_array_equal(
        tu.diagonal().numpy(), np.diagonal(full.numpy(), axis1=-2, axis2=-1))
    np.testing.assert_allclose(tu.logdet().numpy(), np.asarray(ju.logdet()),
                               rtol=1e-5)
    assert tu.is_valid().tolist() == np.asarray(ju.is_valid()).tolist()
    assert not bool(tu.is_valid(tol=float(full.abs().max())).any())


def test_downdate_guarded_rejects_an_infeasible_downdate(mesh, jmesh):
    Ls, Vs = (np.array(x) for x in make_batched_problem(2, N, K, seed=8))
    Ls[0] = downdate_start(Ls[0], Vs[0])  # member 0: A - V V^T stays PD
    Vbad = Vs.copy()
    Vbad[1] *= 40.0  # member 1: A - V V^T leaves the PD cone
    tf = CholFactor(t(Ls), panel=PANEL, backend="sharded", mesh=mesh)
    jf = JFactor(jnp.asarray(Ls), panel=PANEL, backend="sharded", mesh=jmesh,
                 interpret=True)
    new, ok = tf.downdate_guarded(t(Vbad))
    with jmesh:
        _, jok = jf.downdate_guarded(jnp.asarray(Vbad))
    assert ok.tolist() == np.asarray(jok).tolist() == [True, False]
    out = distributed.gather(new.data).numpy()
    np.testing.assert_array_equal(out[1], Ls[1])  # unchanged where infeasible
    want = np.linalg.cholesky(Ls[0].T.astype(np.float64) @ Ls[0]
                              - Vbad[0].astype(np.float64) @ Vbad[0].T).T
    np.testing.assert_allclose(out[0], want, atol=tol_for(np.float32, N))
    one, ok1 = CholFactor(t(Ls[1]), panel=PANEL, backend="sharded",
                          mesh=mesh).downdate_guarded(t(Vbad[1]))
    assert not bool(ok1)
    np.testing.assert_array_equal(distributed.gather(one.data).numpy(),
                                  Ls[1])
