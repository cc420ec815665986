"""The (row, rotation) wavefront of ``chol_tile.cuh`` ``sweep_wavefront``,
emulated on the CPU, against the port's plain ``diag_block`` and the JAX
package's ``diag_recurrence``.

The CUDA kernels ``diag_block_kernel`` and ``fused_chain_kernel`` sweep a
diagonal block by anti-diagonals: at tick t every column owner applies the
rotations (i, m) with i + m = t - 1 to its column, and rotation (q, t - q)
of each pivot row q in the band is computed from column q (in the kernel
by a chain warp, lane t - q). ``wavefront_sweep`` below runs the same
schedule with torch operations, one column owner a vector entry: the
rotations of the recurrence in anti-diagonal order, with the kernel's
ownership (D column q until its pivot, identity column P + q from then on,
a shift register of rows whose finished row leaves each tick).
Where it equals ``_diag_block_plain`` bit for bit, the reordering keeps
every element's operations and their order, which is what makes the
kernel's outputs the plain version's on the card
(``tests/test_torch_cuda.py::test_diag_block_equals_plain_bit_for_bit``).
Tolerance against the JAX package: ``tol_for(float32, P)``; JAX runs with
x64 off, so f64 inputs are compared with its fp32 result.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.cholupdate as jK
from repro_torch.kernels import cholupdate as K
from tests.strategies import tol_for


def wavefront_sweep(D, vtd, *, sigma: int):
    """The diagonal-block recurrence on D (P, P) and its slab vtd (k, P),
    by the kernel's ticks. Returns (D_new, c, s, T) in D's dtype."""
    P, k = D.shape[-1], vtd.shape[-2]
    pk = P + k
    dt = D.dtype
    cols = torch.arange(pk)
    # Owner q's V values: D column q's slab values; the identity of V row
    # q - P for q >= P.
    V = torch.zeros(k, pk, dtype=dt)
    V[:, :P] = vtd
    V[torch.arange(k), P + torch.arange(k)] = 1
    # Column q's entry of row i as it enters the shift register: D's for
    # i < q < P; zero for the identity columns (rows after the pivot).
    X = torch.zeros(P + k + 1, pk, dtype=dt)
    X[:P, :P] = torch.triu(D, 1)
    Y = torch.zeros(k, pk, dtype=dt)   # stage m holds row t - 1 - m
    piv = torch.zeros(pk, dtype=dt)
    piv[:P] = torch.diagonal(D)        # the pivot l of each owner's row
    z = torch.ones(pk, dtype=dt)       # identity column P + q's entry, row q
    D_new = torch.zeros(P, P, dtype=dt)
    T = torch.zeros(pk, pk, dtype=dt)
    c_out = torch.zeros(P, k, dtype=dt)
    s_out = torch.zeros(P, k, dtype=dt)
    ring = {}
    for t in range(P + k):
        d = t - 1
        # Anti-diagonal d: every owner but the pivot's takes (d - m, m).
        for m in reversed(range(k)):
            i = d - m
            if 0 <= i < P:
                c, s, ss = ring[(i, m)]
                keep = cols == i
                y_new = (Y[m] + ss * V[m]) / c
                v_new = c * V[m] - s * y_new
                Y[m] = torch.where(keep, Y[m], y_new)
                V[m] = torch.where(keep, V[m], v_new)
        # Anti-diagonal t: rotation (q, t - q) of each pivot q in the band.
        for q in range(max(0, t - k + 1), min(t, P - 1) + 1):
            m = t - q
            vm, l = V[m, q], piv[q]
            w = torch.sqrt(l * l + sigma * vm * vm)
            c, s = w / l, vm / l
            ss = sigma * s
            ring[(q, m)] = (c, s, ss)
            c_out[q, m], s_out[q, m] = c, s
            piv[q] = (l + ss * vm) / c
            zq = (z[q] + ss * 0.0) / c   # identity column P + q: (1; 0)
            V[m, q] = c * 0.0 - s * zq
            z[q] = zq
            if m == k - 1:
                D_new[q, q], T[q, q] = piv[q], z[q]
        # Row t - k leaves stage k - 1 final.
        r = t - k
        if 0 <= r < P:
            for q in range(pk):
                if q == r:
                    continue
                if q < P and r < q:
                    D_new[r, q] = Y[k - 1, q]
                else:
                    T[r, q] = Y[k - 1, q]
        Y = torch.cat([X[t][None], Y[:-1]])
    T[P:] = V
    return D_new, c_out, s_out, T


def problem(P, k, sigma, dtype, seed):
    """An upper block and its slab, numpy-seeded; for a downdate the block
    is the factor of A + V V^T, so the downdate is feasible."""
    rng = np.random.default_rng(seed)
    Bm = rng.uniform(size=(P + 4, P + 4))
    V = rng.uniform(size=(P + 4, k))
    A = Bm.T @ Bm + np.eye(P + 4)
    if sigma < 0:
        A = A + V @ V.T
    L = np.linalg.cholesky(A).T
    return L[:P, :P].astype(dtype), np.ascontiguousarray(V[:P].T, dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("P", [4, 37])
def test_wavefront_order_equals_plain_recurrence(P, k, sigma, dtype):
    D, vtd = problem(P, k, sigma, dtype, seed=7 * P + k)
    Dt, vt = torch.from_numpy(D), torch.from_numpy(vtd)
    ours = wavefront_sweep(Dt, vt, sigma=sigma)
    plain = K._diag_block_plain(Dt, vt, sigma, None)
    for x, y in zip(ours, plain):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)
    theirs = jK.diag_recurrence(jnp.asarray(D), jnp.asarray(vtd),
                                sigma=sigma, rows=P, k=k)
    for x, y in zip(ours, theirs):
        np.testing.assert_allclose(x.numpy(), np.asarray(y, np.float64),
                                   atol=tol_for(np.float32, P))
