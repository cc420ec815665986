"""The (row, rotation) wavefront of ``panel_kernels.cu``
``panel_paper_kernel``, emulated on the CPU, against the port's plain
``panel_apply_paper`` and the JAX package's ``apply_rotations``.

The CUDA kernel gives each column a segment of ``paper_lanes(k)`` lanes:
lane m keeps V row m's value and at tick t takes rotation (t - m, m); the
row value passes from lane m to lane m + 1 each tick, lane 0 takes row
t's element and lane k - 1 leaves row t - k + 1's result. A CTA of nw
warps stages its rows and the rotations in two shared-memory rings of
three windows of 32 ticks: during window g it loads chunk g + 1, stores
it to the rings after the window's ticks and writes chunk g - 2 back.
``wavefront_apply`` below runs that schedule with torch operations, one
lane a tensor entry, with the kernel's rings, windows, ragged CTAs and
idle lanes past k. Where it equals ``_paper_plain`` bit for bit, the
schedule keeps every element's operations and their order, which is what
makes the kernel's result the plain version's on the card
(``tests/test_torch_cuda.py::test_paper_apply_equals_plain_bit_for_bit``).
Tolerance against the JAX package: ``tol_for(float32, P)``; JAX runs with
x64 off, so f64 inputs are compared with its fp32 result.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.cholupdate as jK
from repro_torch.kernels import _launch
from repro_torch.kernels import cholupdate as K
from tests.strategies import tol_for

WIN, SLOTS = 32, 3
RING = WIN * SLOTS


def cta_apply(R, vt, c, s, *, sigma, c0, nw, acc):
    """One CTA of the kernel on member arrays R (P, w), vt (k, w), c, s
    (P, k), in place: columns c0 .. c0 + nw 32 / lanes."""
    P, w = R.shape
    k = vt.shape[0]
    kp = _launch.paper_lanes(k)
    cpw = _launch.paper_cpw(k)
    cpc = nw * cpw
    W = min(cpc, w - c0)
    nan = float("nan")
    # The rings start as garbage: an active lane that read an entry never
    # staged would carry a NaN into the result.
    rot = torch.full((RING, kp, 4), nan, dtype=acc)
    xr = torch.full((RING, cpc), nan, dtype=acc)
    m = torch.arange(kp)[:, None]          # lane's rotation
    col = torch.arange(cpc)[None, :]       # lane's column
    live = (col // cpw * cpw < W).expand(kp, cpc)  # its warp has a column

    def fetch(g):                          # chunk g, as the registers hold it
        rows = torch.arange(g * WIN, (g + 1) * WIN)[:, None]
        xq = torch.zeros(WIN, cpc, dtype=acc)
        ok = (rows < P) & (col < W)
        r_, c_ = torch.nonzero(ok, as_tuple=True)
        xq[r_, c_] = R[rows[r_, 0], c0 + c_].to(acc)
        mm = torch.arange(kp)[None, :]
        real = (rows < P) & (mm < k)
        cq = torch.ones(WIN, kp, dtype=acc)
        sq = torch.zeros(WIN, kp, dtype=acc)
        r_, m_ = torch.nonzero(real, as_tuple=True)
        cq[r_, m_] = c[rows[r_, 0], m_].to(acc)
        sq[r_, m_] = s[rows[r_, 0], m_].to(acc)
        return xq, cq, sq

    def commit(g, regs):                   # into the rings, by tick
        xq, cq, sq = regs
        xr[(g % SLOTS) * WIN:(g % SLOTS + 1) * WIN] = xq
        mm = torch.arange(kp)[None, :].expand(WIN, kp)
        tick = g * WIN + torch.arange(WIN)[:, None] + mm  # (32 g + e, mm)
        # The kernel's fourth value, recip_pre(c), only speeds its
        # division up: the emulation divides.
        rot[tick % RING, mm] = torch.stack(
            [cq, sq, sigma * sq, torch.ones_like(cq)], dim=-1)

    def write_back(g):
        rows = torch.arange(g * WIN, min((g + 1) * WIN, P))
        R[rows, c0:c0 + W] = xr[(g % SLOTS) * WIN + rows - g * WIN,
                                :W].to(R.dtype)

    v = torch.zeros(kp, cpc, dtype=acc)
    v[:k, :W] = vt[:, c0:c0 + W].to(acc)
    x = torch.zeros(kp, cpc, dtype=acc)
    n_ticks = P + k - 1
    n_win = -(-n_ticks // WIN)
    n_chunks = -(-P // WIN)
    commit(0, fetch(0))
    for g in range(n_win):
        more = g + 1 < n_chunks
        regs = fetch(g + 1) if more else None
        if g >= 2:
            write_back(g - 2)
        base = (g % SLOTS) * WIN
        t0 = g * WIN
        for t in range(t0, min(t0 + WIN, n_ticks)):
            cm, sm, ssm = (rot[base + t - t0, :, j][:, None] for j in range(3))
            xin = xr[base + t - t0][None, :]
            xu = torch.cat([xin, x[:-1]])   # shuffle up within the segment
            i = t - m
            act = live & (m < k) & (i >= 0) & (i < P)
            y = (xu + ssm * v) / cm
            vn = cm * v - sm * y
            v = torch.where(act, vn, v)
            x = y
            ro = (base + t - t0 - (k - 1)) % RING
            out = act[k - 1]
            xr[ro, out] = y[k - 1, out]
        if more:
            commit(g + 1, regs)
    for g in range(max(0, n_win - 2), n_chunks):
        write_back(g)
    vt[:, c0:c0 + W] = v[:k, :W].to(vt.dtype)


def wavefront_apply(R, vt, c, s, *, sigma, nw, accum_dtype=None):
    """The kernel's grid over (R, vt) (..., P, w) / (..., k, w): returns
    (R_new, vt_new) in the inputs' dtypes."""
    acc = accum_dtype or torch.promote_types(R.dtype, c.dtype)
    R, vt = R.clone(), vt.clone()
    Rb, vb = R.reshape(-1, *R.shape[-2:]), vt.reshape(-1, *vt.shape[-2:])
    cb, sb = c.reshape(-1, *c.shape[-2:]), s.reshape(-1, *s.shape[-2:])
    cpc = nw * _launch.paper_cpw(vt.shape[-2])
    for b in range(Rb.shape[0]):
        for c0 in range(0, R.shape[-1], cpc):
            cta_apply(Rb[b], vb[b], cb[b], sb[b], sigma=sigma, c0=c0, nw=nw,
                      acc=acc)
    return R, vt


def problem(B, P, k, w, sigma, dtype, seed):
    """A factor's row panel and its rotations: the diagonal block's (c, s)
    from the plain recurrence, R and vt its trailing columns; numpy-seeded;
    for a downdate the factor is that of A + V V^T."""
    rng = np.random.default_rng(seed)
    n = P + w
    Bm = rng.uniform(size=(B, n, n))
    V = rng.uniform(size=(B, n, k))
    A = np.swapaxes(Bm, -1, -2) @ Bm + np.eye(n)
    if sigma < 0:
        A = A + V @ np.swapaxes(V, -1, -2)
    L = torch.from_numpy(np.swapaxes(np.linalg.cholesky(A), -1, -2).copy())
    V = torch.from_numpy(V)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    _, c, s, _ = K._diag_block_plain(L[:, :P, :P].to(acc),
                                     V[:, :P].mT.contiguous().to(acc),
                                     sigma, None)
    R = L[:, :P, P:].contiguous().to(dtype)
    vt = V[:, P:].mT.contiguous().to(dtype)
    return R, vt, c, s


CASES = [(B, P, k, w) for P in (1, 4, 37) for k in (1, 5, 16, 32)
         for B, w in ((1, 33), (3, 10))]


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("B,P,k,w", CASES)
def test_wavefront_schedule_equals_plain_and_jax(B, P, k, w, sigma):
    R, vt, c, s = problem(B, P, k, w, sigma, torch.float32, 11 * P + k + w)
    nw = _launch.paper_warps(B, w, k, 132)
    ours = wavefront_apply(R, vt, c, s, sigma=sigma, nw=nw)
    plain = K._paper_plain(R, vt, c, s, sigma, None)
    for x, y in zip(ours, plain):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, y)
    for b in range(B):
        theirs = jK.apply_rotations(
            jnp.asarray(R[b].numpy()), jnp.asarray(vt[b].numpy()),
            jnp.asarray(c[b].numpy()), jnp.asarray(s[b].numpy()),
            sigma=sigma, rows=P, k=k)
        for x, y in zip(ours, theirs):
            np.testing.assert_allclose(x[b].numpy(), np.asarray(y),
                                       atol=tol_for(np.float32, P))


@pytest.mark.parametrize("nw", [4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("P,k,w,sigma", [(37, 16, 33, -1), (130, 5, 20, 1),
                                         (200, 32, 9, -1), (100, 1, 70, 1)])
def test_wavefront_rings_and_dtypes_equal_plain(P, k, w, sigma, dtype, nw):
    """Past three windows (P + k > 96) the rings wrap; any CTA size gives
    the same values; bf16 storage chains in fp32 and rounds once; f64
    against JAX's fp32 result."""
    R, vt, c, s = problem(1, P, k, w, sigma, dtype, P + k)
    acc = torch.float32 if dtype == torch.bfloat16 else None
    ours = wavefront_apply(R, vt, c, s, sigma=sigma, nw=nw, accum_dtype=acc)
    plain = K._paper_plain(R, vt, c, s, sigma, acc)
    for x, y in zip(ours, plain):
        assert x.dtype == dtype and x.shape == y.shape
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, y)
    if dtype == torch.float64:
        theirs = jK.apply_rotations(
            jnp.asarray(R[0].numpy()), jnp.asarray(vt[0].numpy()),
            jnp.asarray(c[0].numpy()), jnp.asarray(s[0].numpy()),
            sigma=sigma, rows=P, k=k)
        for x, y in zip(ours, theirs):
            np.testing.assert_allclose(x[0].numpy(),
                                       np.asarray(y, np.float64),
                                       atol=tol_for(np.float32, P))
