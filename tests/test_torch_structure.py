"""The port's structured storage and block-tridiagonal path against the JAX
package.

The same numpy inputs (``tests.strategies.make_banded_problem``) go into
``repro.core.structure`` / ``repro.kernels.blocktridiag`` (the Pallas kernel
in ``interpret=True``, as the JAX package's own tests run it on the CPU)
and into ``repro_torch`` on CPU tensors, where the ``blocktridiag`` route
runs its kernel's plain version. Tolerances: fp32 ``tol_for(float32, n)``;
bf16 storage within ``SINGLE_UPDATE_RTOL`` relative (Frobenius, the
block form of A) and within 2x of the JAX package's own error; f64 against
a numpy float64 refactorization. The CUDA kernel is held against the same
plain version in ``tests/test_torch_cuda.py`` (on the card).
"""
from __future__ import annotations

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.api as japi
import repro.core.backends as jbackends
import repro.core.structure as jS
import repro.kernels.blocktridiag as jbtd
from repro.core.factor import CholFactor as JFactor
from repro_torch.core import api, backends
from repro_torch.core import structure as S
from repro_torch.core.factor import CholFactor
from repro_torch.interop import (factor_from_numpy, factor_to_numpy,
                                 storage_from_numpy, storage_to_numpy)
from repro_torch.kernels import blocktridiag as tbtd
from repro_torch.obs import metrics as tmetrics
from tests.strategies import make_banded_problem, tol_for

NB, BLK, K = 6, 4, 3
N = NB * BLK
BF16_EPS = 2.0 ** -8
SINGLE_UPDATE_RTOL = 32 * BF16_EPS  # tests/test_precision.py
HERE = os.path.dirname(os.path.abspath(__file__))


def t(x):
    return torch.from_numpy(np.array(x))


def banded(seed=0, nb=NB, b=BLK, k=K):
    return tuple(np.asarray(x) for x in make_banded_problem(nb, b, k,
                                                            seed=seed))


def both(Ad, Ao):
    """The same chain factorization in both packages."""
    return (jS.BlockTriDiagStorage.from_matrix_blocks(jnp.asarray(Ad),
                                                      jnp.asarray(Ao)),
            S.BlockTriDiagStorage.from_matrix_blocks(t(Ad), t(Ao)))


def close(ours, theirs, n=N, atol=None):
    np.testing.assert_allclose(
        np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
        atol=tol_for(np.float32, n) if atol is None else atol)


def close_storage(ours, theirs, n=N):
    close(ours.diag.float(), np.asarray(theirs.diag, np.float32), n)
    close(ours.off.float(), np.asarray(theirs.off, np.float32), n)


def blocks_of_A(St, V, sigma):
    """(Ad, Ao) of U^T U + sigma V V^T in float64, block form."""
    ad, ao = St.astype(torch.float64).matrix_blocks()
    Vb = t(V).double().reshape(St.nblocks, St.block, -1)
    return (ad + sigma * Vb @ Vb.mT,
            ao + sigma * Vb[:-1] @ Vb[1:].mT)


# ---------------------------------------------------------------------------
# BlockTriDiagStorage against repro.core.structure
# ---------------------------------------------------------------------------


def test_chain_factorization_and_views_match_jax():
    Ad, Ao, _ = banded(seed=1)
    js, ts = both(Ad, Ao)
    close_storage(ts, js)
    assert (ts.nblocks, ts.block, ts.n, ts.batched) == (NB, BLK, N, False)
    assert ts.structure == "blocktridiag" and ts.raw is ts
    close(ts.diagonal(), js.diagonal())
    close(ts.to_dense(), js.to_dense())
    for x, y in zip(ts.matrix_blocks(), js.matrix_blocks()):
        close(x, y, atol=1e-4)
    close(ts.matrix_blocks()[0], Ad, atol=1e-4)
    close(ts.matrix(), js.matrix(), atol=1e-4)
    # Slicing the dense factor gives the same blocks back.
    back = S.BlockTriDiagStorage.from_dense(ts.to_dense(), BLK)
    assert torch.equal(back.diag, ts.diag) and torch.equal(back.off, ts.off)
    with pytest.raises(ValueError, match="does not divide"):
        S.BlockTriDiagStorage.from_dense(ts.to_dense(), 5)
    with pytest.raises(ValueError, match="off must be"):
        S.BlockTriDiagStorage(ts.diag, ts.off[1:])
    with pytest.raises(ValueError, match="not positive definite"):
        S.BlockTriDiagStorage.from_matrix_blocks(t(-Ad), t(Ao))


def test_solves_logdet_feasibility_match_jax():
    Ad, Ao, V = banded(seed=2)
    js, ts = both(Ad, Ao)
    rng = np.random.default_rng(3)
    b = rng.normal(size=N).astype(np.float32)
    B2 = rng.normal(size=(N, 2)).astype(np.float32)
    for rhs in (b, B2):
        for trans in (True, False):
            close(ts.solve_triangular(t(rhs), trans=trans),
                  js.solve_triangular(jnp.asarray(rhs), trans=trans),
                  atol=1e-4)
        close(ts.solve(t(rhs)), js.solve(jnp.asarray(rhs)), atol=1e-4)
    np.testing.assert_allclose(float(ts.logdet()), float(js.logdet()),
                               rtol=1e-5)
    assert bool(ts.is_valid()) and bool(js.is_valid())
    for scale in (1.0, 50.0):
        assert bool(ts.downdate_feasible(t(scale * V))) == bool(
            js.downdate_feasible(jnp.asarray(scale * V)))
    assert not bool(ts.downdate_feasible(t(50.0 * V)))
    with pytest.raises(ValueError, match="rhs length"):
        ts.solve(torch.zeros(N + 1))


def test_identity_astype_scale_and_fleet_ops():
    eye = S.BlockTriDiagStorage.identity(NB, BLK, scale=4.0, batch=2,
                                         device="cpu")
    jeye = jS.BlockTriDiagStorage.identity(NB, BLK, scale=4.0, batch=2)
    close_storage(eye, jeye)
    assert eye.batched and eye.batch == 2 and eye.describe() == \
        f"blocktridiag[2x{NB}x{BLK}]"
    half = eye.astype(torch.bfloat16)
    assert half.dtype == torch.bfloat16 and half.off.dtype == torch.bfloat16
    assert torch.equal(eye.scale(-0.5).diag, 0.5 * eye.diag)
    # A fleet's operations are its members' operations.
    Ad, Ao, V = banded(seed=4)
    _, ts = both(Ad, Ao)
    fleet = S.BlockTriDiagStorage.stack([ts, ts.scale(2.0)])
    rhs = torch.randn(2, N, generator=torch.Generator().manual_seed(0))
    sol = fleet.solve(rhs)
    for i, m in enumerate(fleet.members()):
        close(sol[i], m.solve(rhs[i]), atol=1e-5)
    np.testing.assert_allclose(fleet.logdet().numpy(),
                               [float(m.logdet()) for m in fleet.members()],
                               rtol=1e-6)
    ok = fleet.downdate_feasible(t(np.stack([V, 50 * V])))
    assert ok.tolist() == [True, False]
    with pytest.raises(ValueError, match="not a fleet"):
        ts.members()


def test_blocklocal_contract_and_anchor_match_jax():
    _, _, V = banded(seed=5)
    S.assert_blocklocal(t(V), BLK)
    jS.assert_blocklocal(V, BLK)
    wide = np.zeros((N, 1), np.float32)
    wide[0, 0] = wide[3 * BLK, 0] = 1.0
    for check in (S.assert_blocklocal, jS.assert_blocklocal):
        with pytest.raises(ValueError, match="spans block rows 0..3"):
            check(wide, BLK)
    rows = [np.zeros(N, np.float32) for _ in range(3)]
    rows[1][2 * BLK + 1] = 1.0
    rows[2][2 * BLK + 1] = rows[2][3 * BLK + 2] = 1.0
    for r in rows:
        assert S.anchor_block(t(r), BLK) == jS.anchor_block(r, BLK)
    with pytest.raises(ValueError, match="spans"):
        S.anchor_block(wide[:, 0], BLK)
    assert S.is_factor_storage(both(*banded()[:2])[1])
    assert not S.is_factor_storage(torch.eye(2))
    assert isinstance(S.as_storage(torch.eye(2)), S.DenseStorage)


# ---------------------------------------------------------------------------
# the modification: blocktridiag_ref and the blocktridiag plain route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["blocktridiag", "blocktridiag_ref"])
@pytest.mark.parametrize("sigma", [1, -1])
def test_structured_update_matches_jax_kernel(method, sigma):
    Ad, Ao, V = banded(seed=6)
    js, ts = both(Ad, Ao)
    if sigma < 0:
        js = jbtd.chol_update_blocktridiag(js, jnp.asarray(V), sigma=1,
                                           interpret=True)
        ts = S.chol_update_blocktridiag_ref(ts, t(V), sigma=1)
    theirs = jbtd.chol_update_blocktridiag(js, jnp.asarray(V), sigma=sigma,
                                           interpret=True)
    ours = api.chol_update(ts, t(V), sigma=sigma, method=method)
    assert isinstance(ours, S.BlockTriDiagStorage)
    close_storage(ours, theirs)
    # The factor it represents: A + sigma V V^T, in block form.
    want = blocks_of_A(ts, V, sigma)
    for x, y in zip(ours.astype(torch.float64).matrix_blocks(), want):
        close(x, y, atol=1e-4)


def test_structured_f64_against_numpy_refactorization():
    # JAX's x64 is off, so the generator's arrays come back fp32; the test
    # takes them as exact float64 inputs.
    Ad, Ao, V = (x.astype(np.float64) for x in banded(seed=7))
    ts = S.BlockTriDiagStorage.from_matrix_blocks(t(Ad), t(Ao))
    for method in ("blocktridiag", "blocktridiag_ref"):
        for sigma in (1, -1):
            out = api.chol_update(ts, t(V), sigma=sigma, method=method)
            assert out.dtype == torch.float64
            A = ts.matrix().numpy() + sigma * V @ V.T
            ref = np.linalg.cholesky(A).T
            np.testing.assert_allclose(out.to_dense().numpy(), ref,
                                       atol=tol_for(np.float64, N))


@pytest.mark.parametrize("method", ["blocktridiag", "blocktridiag_ref"])
def test_structured_bf16_within_budget_and_jax(method):
    Ad, Ao, V = banded(seed=8)
    js, ts = both(Ad, Ao)
    ours = api.chol_update(ts, t(V), method=method, precision="bf16")
    theirs = japi.chol_update(js, jnp.asarray(V), method=method,
                              interpret=True, precision="bf16")
    assert ours.dtype == torch.bfloat16

    def rel(St):
        got = St.astype(torch.float64).matrix_blocks()
        want = blocks_of_A(ts, V, 1)
        num = sum(float(torch.linalg.norm(g - w)) ** 2
                  for g, w in zip(got, want))
        den = sum(float(torch.linalg.norm(w)) ** 2 for w in want)
        return (num / den) ** 0.5

    e_ours = rel(ours)
    e_theirs = rel(S.BlockTriDiagStorage(
        t(np.asarray(theirs.diag, np.float32)),
        t(np.asarray(theirs.off, np.float32))))
    assert e_ours <= SINGLE_UPDATE_RTOL
    assert e_ours <= 2 * max(e_theirs, BF16_EPS ** 2)


def test_structured_fleet_in_one_call_matches_members_and_jax_vmap():
    Bn = 3
    probs = [banded(seed=10 + b) for b in range(Bn)]
    jst = [jS.BlockTriDiagStorage.from_matrix_blocks(jnp.asarray(a),
                                                     jnp.asarray(o))
           for a, o, _ in probs]
    jfleet = jS.BlockTriDiagStorage(jnp.stack([s.diag for s in jst]),
                                    jnp.stack([s.off for s in jst]))
    V = np.stack([v for _, _, v in probs])
    fleet = storage_from_numpy(np.asarray(jfleet.diag),
                               np.asarray(jfleet.off), device="cpu")
    theirs = japi.chol_update_batched(jfleet, jnp.asarray(V),
                                      method="blocktridiag", interpret=True)
    before = tmetrics.value("repro.kernels.plain_walks",
                            module="blocktridiag")
    ours = api.chol_update_batched(fleet, t(V))  # auto -> blocktridiag_ref
    kern = api.chol_update_batched(fleet, t(V), method="blocktridiag")
    # The kernel route takes the whole fleet in one plain walk.
    assert tmetrics.value("repro.kernels.plain_walks",
                          module="blocktridiag") == before + 1
    close_storage(ours, theirs)
    close_storage(kern, theirs)
    for b, m in enumerate(fleet.members()):
        one = api.chol_update(m, t(V[b]), method="blocktridiag")
        close(kern.diag[b], one.diag, atol=1e-6)
    with pytest.raises(ValueError, match="chol_update_batched"):
        api.chol_update(fleet, t(V))
    with pytest.raises(ValueError, match="batched storage"):
        api.chol_update_batched(fleet.members()[0], t(V))
    with pytest.raises(ValueError, match=r"\(B, n, k\)"):
        api.chol_update_batched(fleet, t(V[:2]))


def test_plain_chain_matches_the_reference_twin():
    Ad, Ao, V = banded(seed=12, nb=5, b=3, k=2)
    ts = S.BlockTriDiagStorage.from_matrix_blocks(t(Ad), t(Ao))
    d, o = tbtd.btd_chain_plain(ts.diag[None], ts.off[None],
                                t(V).mT.contiguous()[None], sigma=1)
    ref = S.chol_update_blocktridiag_ref(ts, t(V), sigma=1)
    close(d[0], ref.diag, atol=1e-5)
    close(o[0], ref.off, atol=1e-5)
    # One block: no coupling block at all.
    one = S.BlockTriDiagStorage(ts.diag[:1], ts.off[:0])
    out = api.chol_update(one, t(V[:3]), method="blocktridiag")
    assert out.off.shape == (0, 3, 3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tbtd.btd_chain_cuda(d, o, t(V).mT.contiguous()[None], sigma=1)
    with pytest.raises(ValueError, match="k <= 32"):
        tbtd.btd_chain_cuda(d, o, torch.zeros(1, 33, 15), sigma=1)


def test_accounting_matches_jax():
    for nb, b, k in ((512, 16, 4), (8192, 4, 16), (512, 64, 16)):
        for tdt, jdt in ((torch.float32, jnp.float32),
                         (torch.bfloat16, jnp.bfloat16)):
            ours = tbtd.bytes_per_update(nb, b, k, storage_dtype=tdt)
            assert ours == jbtd.bytes_per_update(nb, b, k,
                                                 storage_dtype=jdt)
            assert ours == backends.modeled_bytes_per_update(
                structure="blocktridiag", n=nb * b, panel=256, k=k,
                storage_dtype=tdt, nblocks=nb, block=b)
            assert tbtd.factor_bytes(nb, b, storage_dtype=tdt) == \
                jbtd.factor_bytes(nb, b, storage_dtype=jdt)
    assert tbtd.launch_count() == jbtd.launch_count() == 1
    assert tbtd.launch_count(48) == 2
    # The smoother of examples/kalman_smoother.py at T = 8192 (chip_smoke.py).
    assert tbtd.bytes_per_update(8192, 4, 16,
                                 storage_dtype=torch.float32) == 4_194_560


# ---------------------------------------------------------------------------
# registry: structures, resolve, dispatch
# ---------------------------------------------------------------------------


def test_resolve_by_structure_matches_jax(fake_device_kind):
    assert backends.names("blocktridiag") == jbackends.names("blocktridiag")
    assert backends.names("dense") == jbackends.names("dense")
    for kind in ("cpu", "gpu", "tpu"):
        fake_device_kind(kind)
        for interp in (None, True):
            assert backends.resolve(
                "auto", n=N, interpret=interp, structure="blocktridiag",
                device=torch.device("cpu")) == jbackends.resolve(
                "auto", n=N, interpret=interp, structure="blocktridiag")
    for method in ("gemm", "fused", "pallas"):
        with pytest.raises(ValueError, match="supports structures"):
            backends.resolve(method, n=N, structure="blocktridiag")
    with pytest.raises(ValueError, match="valid methods for 'dense'"):
        backends.resolve("blocktridiag", n=N)
    _, ts = both(*banded()[:2])
    with pytest.raises(ValueError, match="supports structures"):
        api.chol_update(ts, torch.zeros(N, 1), method="fused")


def test_auto_routes_a_structured_factor_by_device(monkeypatch):
    monkeypatch.delenv(backends.FAKE_DEVICE_KIND_ENV, raising=False)
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert backends.resolve("auto", n=N, device=cpu,
                            structure="blocktridiag") == "blocktridiag_ref"
    assert backends.resolve("auto", n=N, device=cuda,
                            structure="blocktridiag") == "blocktridiag"
    assert backends.resolve("auto", n=N, device=cpu, interpret=True,
                            structure="blocktridiag") == "blocktridiag"


def test_dispatch_records_structure_and_block_bytes():
    Ad, Ao, V = banded(seed=13)
    _, ts = both(Ad, Ao)
    labels = dict(backend="blocktridiag_ref", structure="blocktridiag",
                  lowering="none", dtype="float32", sign="up")
    before = tmetrics.value("repro.backends.bytes", **labels)
    fleet = S.BlockTriDiagStorage.stack([ts, ts])
    api.chol_update_batched(fleet, t(np.stack([V, V])),
                            method="blocktridiag_ref")
    got = tmetrics.value("repro.backends.bytes", **labels) - before
    assert got == 2 * tbtd.bytes_per_update(NB, BLK, K,
                                            storage_dtype=torch.float32)


# ---------------------------------------------------------------------------
# CholFactor and interop
# ---------------------------------------------------------------------------


def test_structured_factor_matches_jax_factor():
    Ad, Ao, V = banded(seed=14)
    jf = JFactor.from_blocktridiag(jnp.asarray(Ad), jnp.asarray(Ao),
                                   backend="blocktridiag", interpret=True)
    tf = CholFactor.from_blocktridiag(t(Ad), t(Ao))
    assert tf.structure == "blocktridiag" and not tf.batched
    assert (tf.n, tf.dtype, tf.device.type) == (N, torch.float32, "cpu")
    assert "blocktridiag" in repr(tf)
    ju, tu = jf.update(jnp.asarray(V)), tf.update(t(V))
    close_storage(tu.data, ju.data)
    b = np.random.default_rng(15).normal(size=N).astype(np.float32)
    close(tu.solve(t(b)), ju.solve(jnp.asarray(b)), atol=1e-4)
    for trans in (True, False):
        close(tu.solve_triangular(t(b), trans=trans),
              ju.solve_triangular(jnp.asarray(b), trans=trans), atol=1e-4)
    np.testing.assert_allclose(float(tu.logdet()), float(ju.logdet()),
                               rtol=1e-5)
    close(tu.diagonal(), ju.diagonal())
    # Guarded downdates: the feasible one applies, the infeasible one keeps
    # the factor, as in the JAX package.
    for scale, want in ((1.0, True), (50.0, False)):
        g, ok = tu.downdate_guarded(t(scale * V))
        jg, jok = ju.downdate_guarded(jnp.asarray(scale * V))
        assert bool(ok) == bool(jok) == want
        close_storage(g.data, jg.data)
    sc = tu.scale(-0.5)
    close_storage(sc.data, ju.scale(-0.5).data)
    assert CholFactor.from_storage(S.DenseStorage(torch.eye(3))).structure \
        == "dense"


def test_structured_fleet_factor_guard_masks_each_member():
    Ad, Ao, V = banded(seed=16)
    _, ts = both(Ad, Ao)
    f = CholFactor.from_storage(S.BlockTriDiagStorage.stack([ts, ts]))
    assert f.batched and f.structure == "blocktridiag"
    Vs = t(np.stack([V, 50 * V]))
    g, ok = f.downdate_guarded(Vs)
    assert ok.tolist() == [True, False]
    down = CholFactor.from_storage(ts).downdate(t(V))
    close(g.data.diag[0], down.data.diag, atol=1e-6)
    assert torch.equal(g.data.diag[1], ts.diag)
    assert torch.equal(g.data.off[1], ts.off)


def test_interop_carries_structured_state_both_ways():
    Ad, Ao, V = banded(seed=17)
    js = jS.BlockTriDiagStorage.from_matrix_blocks(jnp.asarray(Ad),
                                                   jnp.asarray(Ao))
    state = (np.asarray(js.diag), np.asarray(js.off))
    tf = factor_from_numpy(state, backend="blocktridiag", device="cpu")
    assert isinstance(tf.data, S.BlockTriDiagStorage)
    close_storage(tf.data, js)
    tu = tf.update(t(V))
    data, meta = factor_to_numpy(tu)
    back = jS.BlockTriDiagStorage(jnp.asarray(data[0]), jnp.asarray(data[1]))
    close_storage(tu.data, back)
    assert meta["backend"] == "blocktridiag"
    # bf16 state comes back widened, exactly; a fleet crosses as 4-D.
    half = tf.data.astype(torch.bfloat16)
    d, o = storage_to_numpy(half)
    assert d.dtype == np.float32 and np.array_equal(d, half.diag.float())
    fl = storage_from_numpy(np.stack([state[0]] * 2),
                            np.stack([state[1]] * 2), device="cpu")
    assert fl.batched and fl.batch == 2


# ---------------------------------------------------------------------------
# the smoother of examples/kalman_smoother.py, at T = 32
# ---------------------------------------------------------------------------


def _example():
    path = os.path.join(os.path.dirname(HERE), "examples",
                        "kalman_smoother.py")
    spec = importlib.util.spec_from_file_location("kalman_smoother", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("method", ["blocktridiag", "blocktridiag_ref"])
def test_kalman_smoother_matches_jax_run(method):
    """The example's steps (prior from blocks, chunked measurement
    updates, an outlier's update and downdate, solve, logdet) through both
    packages, from its own numpy helpers."""
    ks = _example()
    T, chunk, seed = 32, 8, 0
    F, H, Q, R, P0 = ks.model()
    _, ys, _ = ks.simulate(T, F, H, Q, R, P0, seed)
    Ad, Ao = ks.prior_precision_blocks(T, F, Q, P0)
    Rinv = np.linalg.inv(R)
    eta = np.zeros(T * ks.D, np.float32)
    for t_ in range(T):
        eta[t_ * ks.D:(t_ + 1) * ks.D] += H.T @ Rinv @ ys[t_]
    results = {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            f = JFactor.from_blocktridiag(jnp.asarray(Ad), jnp.asarray(Ao),
                                          backend=method, interpret=True)
            arr = jnp.asarray
        else:
            f = CholFactor.from_blocktridiag(t(Ad), t(Ao), backend=method)
            arr = t
        for lo in range(0, T, chunk):
            f = f.update(arr(ks.measurement_columns(
                T, range(lo, min(lo + chunk, T)), H, R)))
        Vbad = ks.measurement_columns(T, [T // 2], H, R)
        f_bad = f.update(arr(Vbad))
        assert bool(f_bad.downdate_feasible(arr(Vbad)))
        f = f_bad.downdate(arr(Vbad))
        results[pkg] = (np.asarray(f.solve(arr(eta))), float(f.logdet()))
    xs_j, ld_j = results["jax"]
    xs_t, ld_t = results["torch"]
    np.testing.assert_allclose(xs_t, xs_j, atol=5e-4)
    assert abs(ld_t - ld_j) < 1e-2
    # And both against the dense posterior the example checks (T small).
    J = np.zeros((T * ks.D, T * ks.D))
    for t_ in range(T):
        J[t_ * ks.D:(t_ + 1) * ks.D, t_ * ks.D:(t_ + 1) * ks.D] = Ad[t_]
    for t_ in range(T - 1):
        blk = Ao[t_]
        J[t_ * ks.D:(t_ + 1) * ks.D, (t_ + 1) * ks.D:(t_ + 2) * ks.D] = blk
        J[(t_ + 1) * ks.D:(t_ + 2) * ks.D, t_ * ks.D:(t_ + 1) * ks.D] = blk.T
    Vall = ks.measurement_columns(T, range(T), H, R).astype(np.float64)
    J += Vall @ Vall.T
    xs_exact = np.linalg.solve(J, eta.astype(np.float64))
    assert float(np.abs(xs_t - xs_exact).max()) < 5e-3
    assert abs(ld_t - np.linalg.slogdet(J)[1]) < 1e-2
