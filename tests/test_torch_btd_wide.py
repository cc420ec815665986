"""Structured factors with blocks above 256 rows on the CPU.

The CUDA block-chain kernel takes any block size b in one launch (a block
wider than 256 rows is swept as row sub-tiles inside it; it is held
against its plain version on the card in ``tests/test_torch_cuda.py``).
Here the structured route at b = 260 and b = 320 (two blocks, k = 2; and
a fleet of two at b = 260) runs its plain version on CPU tensors and is
held against the JAX package's ``chol_update_blocktridiag_ref`` on the
same numpy inputs, at ``tol_for(float32, n)``. The factors are made as ``chip_smoke.py`` makes
them above b = 8: the strictly upper part of a diagonal block scaled by
8 / b, which keeps its condition number bounded.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.structure as jS
from repro_torch.core import api
from repro_torch.core import structure as S
from repro_torch.kernels import blocktridiag as BT
from tests.strategies import tol_for


def wide_problem(nb, b, k, seed):
    """An upper block-bidiagonal factor (float32 values) and a block-local
    V: every column supported inside one adjacent block pair."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.2, 1.0, size=(nb, b, b))
    d = np.triu(d, 1) * (8.0 / b) + d * np.eye(b) + 2.0 * np.eye(b)
    o = 0.3 * rng.uniform(-1.0, 1.0, size=(nb - 1, b, b))
    V = np.zeros((nb * b, k))
    for c in range(k):
        j = int(rng.integers(nb))
        width = b if j == nb - 1 else 2 * b
        V[j * b:j * b + width, c] = 0.4 * rng.normal(size=width)
    return (d.astype(np.float32), o.astype(np.float32),
            V.astype(np.float32))


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("b", [260, 320])
def test_wide_structured_update_matches_jax_ref(b, sigma):
    nb, k = 2, 2
    d, o, V = wide_problem(nb, b, k, seed=b)
    if sigma < 0:  # a feasible downdate: start from the factor of A + V Vᵀ
        up = api.chol_update(S.BlockTriDiagStorage(torch.from_numpy(d),
                                                   torch.from_numpy(o)),
                             torch.from_numpy(V), sigma=1,
                             method="blocktridiag")
        d, o = up.diag.numpy(), up.off.numpy()
    ours = api.chol_update(S.BlockTriDiagStorage(torch.from_numpy(d),
                                                 torch.from_numpy(o)),
                           torch.from_numpy(V), sigma=sigma,
                           method="blocktridiag")
    theirs = jS.chol_update_blocktridiag_ref(
        jS.BlockTriDiagStorage(jnp.asarray(d), jnp.asarray(o)),
        jnp.asarray(V), sigma=sigma)
    assert isinstance(ours, S.BlockTriDiagStorage)
    assert ours.diag.shape == (nb, b, b) and ours.off.shape == (nb - 1, b, b)
    tol = tol_for(np.float32, nb * b)
    np.testing.assert_allclose(np.triu(ours.diag.numpy()),
                               np.triu(np.asarray(theirs.diag)), atol=tol)
    np.testing.assert_allclose(ours.off.numpy(), np.asarray(theirs.off),
                               atol=tol)


@pytest.mark.parametrize("b", [257, 320, 512])
def test_btd_chain_cuda_names_no_block_limit(b):
    """On CPU tensors the launcher refuses only for the device: any b is
    the kernel's."""
    diag = torch.zeros(1, 2, b, b)
    off = torch.zeros(1, 1, b, b)
    vt = torch.zeros(1, 4, 2 * b)
    with pytest.raises(ValueError, match="CUDA tensors") as err:
        BT.btd_chain_cuda(diag, off, vt, sigma=1)
    assert "256" not in str(err.value) and "b <=" not in str(err.value)


@pytest.mark.parametrize("sigma", [1, -1])
def test_wide_structured_fleet_matches_jax_ref(sigma):
    """A fleet of two factors with b = 260 in one call of the structured
    route: each member against the JAX package's reference on its own."""
    nb, b, k = 2, 260, 2
    probs = [wide_problem(nb, b, k, seed=b + m) for m in range(2)]
    d = np.stack([p[0] for p in probs])
    o = np.stack([p[1] for p in probs])
    V = np.stack([p[2] for p in probs])
    if sigma < 0:
        up = api.chol_update_batched(
            S.BlockTriDiagStorage(torch.from_numpy(d), torch.from_numpy(o)),
            torch.from_numpy(V), sigma=1, method="blocktridiag")
        d, o = up.diag.numpy(), up.off.numpy()
    ours = api.chol_update_batched(
        S.BlockTriDiagStorage(torch.from_numpy(d), torch.from_numpy(o)),
        torch.from_numpy(V), sigma=sigma, method="blocktridiag")
    assert ours.diag.shape == (2, nb, b, b)
    tol = tol_for(np.float32, nb * b)
    for m in range(2):
        theirs = jS.chol_update_blocktridiag_ref(
            jS.BlockTriDiagStorage(jnp.asarray(d[m]), jnp.asarray(o[m])),
            jnp.asarray(V[m]), sigma=sigma)
        np.testing.assert_allclose(np.triu(ours.diag[m].numpy()),
                                   np.triu(np.asarray(theirs.diag)),
                                   atol=tol)
        np.testing.assert_allclose(ours.off[m].numpy(),
                                   np.asarray(theirs.off), atol=tol)
