"""The port's ``CholFactor`` end to end against the JAX package's.

The same numpy state goes into both packages' factors (through
``repro_torch.interop`` on the port's side), both absorb the same
modifications, and the results must agree within ``tol_for(float32, n)``,
single and ``(B, n, n)``. The port runs on CPU tensors.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.factor import CholFactor as JFactor
from repro.core.precision import Precision as JPrecision
from repro_torch.core import CholFactor
from repro_torch.core import factor as tfactor
from repro_torch.core.precision import Precision
from repro_torch.interop import factor_from_numpy, factor_to_numpy
from repro_torch.obs import metrics as tmetrics
from tests.strategies import make_batched_problem, make_problem, tol_for

N, K, PANEL = 24, 3, 8  # three panels: every backend walks a real chain


def t(x):
    return torch.from_numpy(np.array(x))


def close(ours, theirs, n=N, rtol=0.0):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs),
                               rtol=rtol, atol=tol_for(np.float32, n))


def both(L, backend):
    """One state, two factors. ``interpret=True`` runs the JAX fused
    kernel as its own CPU tests do; the port's CPU tensors take the plain
    chain either way."""
    jf = JFactor.from_factor(jnp.asarray(L), panel=PANEL, backend=backend,
                             interpret=True, lowering="portable")
    data, meta = np.asarray(jf.data), dict(panel=PANEL, backend=backend,
                                           lowering="portable")
    return jf, factor_from_numpy(data, device="cpu", **meta)


@pytest.mark.parametrize("backend", ["auto", "reference", "paper", "gemm",
                                     "fused"])
def test_single_factor_methods_match_jax(backend):
    L, V = (np.asarray(x) for x in make_problem(N, K, seed=1))
    jf, tf = both(L, backend)
    ju, tu = jf.update(jnp.asarray(V)), tf.update(t(V))
    close(tu.data, ju.data)
    jd, td = ju.downdate(jnp.asarray(V)), tu.downdate(t(V))
    close(td.data, jd.data)
    close(td.data, L)  # the round trip returns to the start
    b = np.random.default_rng(2).normal(size=(N,)).astype(np.float32)
    close(tu.solve(t(b)), ju.solve(jnp.asarray(b)), rtol=1e-3)
    for trans in (True, False):
        close(tu.solve_triangular(t(b), trans=trans),
              ju.solve_triangular(jnp.asarray(b), trans=trans), rtol=1e-3)
    np.testing.assert_allclose(float(tu.logdet()), float(ju.logdet()),
                               rtol=1e-5)
    close(tu.diagonal(), ju.diagonal())
    close(tu.matrix(), ju.matrix(), rtol=1e-5)
    close(tu.scale(-2.0).data, ju.scale(-2.0).data)
    assert bool(tu.scale(-2.0).is_valid()) and bool(tu.is_valid())


@pytest.mark.parametrize("backend", ["auto", "fused"])
def test_downdate_guarded_matches_jax(backend):
    L, V = (np.asarray(x) for x in make_problem(N, K, seed=3))
    jf, tf = both(L, backend)
    for W, feasible in ((0.1 * V, True), (50.0 * V, False)):
        jg, jok = jf.downdate_guarded(jnp.asarray(W))
        tg, tok = tf.downdate_guarded(t(W))
        assert bool(tok) == bool(jok) == feasible
        close(tg.data, jg.data)
        assert bool(torch.isfinite(tg.data).all())
        if not feasible:
            assert torch.equal(tg.data, tf.data)  # unchanged factor kept


@pytest.mark.parametrize("backend", ["auto", "gemm", "fused"])
def test_batched_factor_matches_jax_and_member_loop(backend):
    Bn = 3
    Lb, Vb = (np.asarray(x) for x in make_batched_problem(Bn, N, K, seed=4))
    jf, tf = both(Lb, backend)
    assert tf.batched and tf.n == N
    ju, tu = jf.update(jnp.asarray(Vb)), tf.update(t(Vb))
    close(tu.data, ju.data)
    for b in range(Bn):
        one = tf.replace(data=tf.data[b]).update(t(Vb[b]))
        close(tu.data[b], one.data)
    # Member 1 gets an infeasible downdate: the guard keeps its old factor.
    W = 0.1 * Vb
    W[1] *= 500.0
    jg, jok = ju.downdate_guarded(jnp.asarray(W))
    tg, tok = tu.downdate_guarded(t(W))
    assert tok.tolist() == np.asarray(jok).tolist() == [True, False, True]
    close(tg.data, jg.data)
    assert torch.equal(tg.data[1], tu.data[1])
    bb = np.random.default_rng(5).normal(size=(Bn, N)).astype(np.float32)
    close(tu.solve(t(bb)), ju.solve(jnp.asarray(bb)), rtol=1e-3)
    np.testing.assert_allclose(tu.logdet().numpy(), np.asarray(ju.logdet()),
                               rtol=1e-5)
    assert tu.is_valid().tolist() == [True] * Bn
    close(tu.downdate(t(Vb)).data, Lb)


def test_constructors_match_jax():
    L, _ = (np.asarray(x) for x in make_problem(N, K, seed=6))
    A = L.T @ L
    close(CholFactor.from_matrix(t(A)).data,
          JFactor.from_matrix(jnp.asarray(A)).data, rtol=1e-4)
    f = CholFactor.identity(8, scale=4.0, batch=2, device="cpu")
    jf = JFactor.identity(8, scale=4.0, batch=2)
    assert f.data.shape == (2, 8, 8) and f.batched
    np.testing.assert_array_equal(f.data.numpy(), np.asarray(jf.data))
    g = CholFactor.from_factor(t(L), panel=16, backend="gemm")
    assert g.device.type == "cpu" and g.dtype == torch.float32
    assert (g.panel, g.backend) == (16, "gemm")
    assert "24x24" in repr(g)
    assert CholFactor(t(L), precision="bf16").precision == Precision.parse(
        "bf16")


def test_interop_round_trip_carries_state_and_metadata():
    L, V = (np.asarray(x) for x in make_problem(N, K, seed=7))
    jf = JFactor.from_factor(jnp.asarray(L), panel=PANEL, backend="gemm",
                             precision="bf16", lowering="mosaic")
    tf = factor_from_numpy(np.asarray(jf.data), panel=jf.panel,
                           backend=jf.backend, precision="bf16",
                           lowering=jf.lowering, device="cpu")
    assert tf.precision == Precision.parse("bf16")
    assert tf.lowering == "mosaic"  # taken as it is
    # The JAX factor's own policy object carries across as well.
    assert factor_from_numpy(np.asarray(jf.data), precision=jf.precision,
                             device="cpu").precision == tf.precision
    tu = tf.update(t(V))
    assert tu.dtype == torch.bfloat16
    data, meta = factor_to_numpy(tu)
    assert data.dtype == np.float32 and meta["panel"] == PANEL
    assert meta["precision"] == ("bfloat16", "float32")
    back = JFactor.from_factor(
        jnp.asarray(data, jnp.bfloat16), panel=meta["panel"],
        backend=meta["backend"],
        precision=JPrecision(storage=meta["precision"][0],
                             accum=meta["precision"][1]))
    ju = jf.update(jnp.asarray(V))
    # bf16 storage: both rounded the same update once; compare A.
    A_t = np.asarray(back.data, np.float32)
    A_j = np.asarray(ju.data, np.float32)
    rel = np.linalg.norm(A_t.T @ A_t - A_j.T @ A_j) / np.linalg.norm(
        A_j.T @ A_j)
    assert rel < 32 * 2.0 ** -8
    # A fp32 state comes back bit for bit.
    data32, meta32 = factor_to_numpy(factor_from_numpy(L, device="cpu"))
    np.testing.assert_array_equal(data32, L)
    assert meta32["precision"] is None
    with pytest.raises(ValueError, match="not ported"):
        factor_from_numpy(L, backend="nope", device="cpu")
    assert meta32["axis"] == "model"


def test_fake_gpu_kind_routes_the_factor_to_the_fused_chain(
        fake_device_kind):
    fake_device_kind("gpu")
    L, V = (np.asarray(x) for x in make_problem(N, K, seed=8))
    tf = CholFactor.from_factor(t(L), panel=PANEL)
    assert tfactor.resolve_backend_for(tf) == "fused"
    p0 = tmetrics.value("repro.kernels.plain_walks", module="fused")
    m0 = tmetrics.value("repro.core.mutations", op="update",
                        structure="dense", backend="auto")
    tu = tf.update(t(V))
    assert tmetrics.value("repro.kernels.plain_walks",
                          module="fused") == p0 + 1
    assert tmetrics.value("repro.core.mutations", op="update",
                          structure="dense", backend="auto") == m0 + 1
    ju = JFactor.from_factor(jnp.asarray(L), panel=PANEL, backend="fused",
                             interpret=True,
                             lowering="portable").update(jnp.asarray(V))
    close(tu.data, ju.data)
