"""The port's CUDA kernels on the card: the fused chain, the per-panel
kernels and the block-tridiagonal chain, each against its plain version,
and the launches each route takes per update.

Marked ``gpu``; the ``cuda`` fixture skips each test where
``torch.cuda.is_available()`` is false (decided inside the fixture, never
at import, so every pytest-xdist worker collects the same tests). Run on a
machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

The first test builds the kernel from ``src/repro_torch/kernels/csrc``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import CholFactor, api, blocked, chol_update_batched
from repro_torch.core import chol_update_dense
from repro_torch.core.structure import BlockTriDiagStorage
from repro_torch.kernels import blocktridiag as BT
from repro_torch.kernels import cholupdate as K
from repro_torch.kernels import fused as F

pytestmark = pytest.mark.gpu

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def spd(B, n, k, dtype, sigma, dev, seed=0):
    """make_problem's procedure in float64 on the card; for a downdate the
    start is the factor of A + V V^T."""
    rng = np.random.default_rng(seed)
    Bm = torch.from_numpy(rng.uniform(size=(B, n, n))).to(dev)
    V = torch.from_numpy(rng.uniform(size=(B, n, k))).to(dev)
    A = Bm.mT @ Bm + torch.eye(n, dtype=torch.float64, device=dev)
    if sigma < 0:
        A = A + V @ V.mT
    return torch.linalg.cholesky(A).mT.contiguous().to(dtype), V.to(dtype)


def entry_err(out, ref):
    """Largest entrywise error of upper factor(s) ``out`` against ``ref``,
    in units of ``out``'s roundoff times the entry's magnitude plus the
    mean magnitude of the upper triangle (the floor for entries formed by
    cancellation), as chip_smoke.py measures it."""
    unit = float(torch.finfo(out.dtype).eps) / 2
    out, ref = torch.triu(out.double()), torch.triu(ref.double())
    n = ref.shape[-1]
    floor = ref.abs().sum(dim=(-2, -1), keepdim=True) / (n * (n + 1) / 2)
    return float(((out - ref).abs() / (unit * (ref.abs() + floor))).max())


def entry_limit(dtype, n):
    """chip_smoke.py's limit on ``entry_err``: 4 n units in fp32/f64 (a
    downdate's rounding grows with n), 4 in bf16 (fp32 arithmetic, only a
    stored rounding may flip)."""
    return 4.0 if dtype == torch.bfloat16 else 4.0 * n


DTYPES = {"fp32": (torch.float32, None),
          "bf16": (torch.bfloat16, torch.float32),
          "f64": (torch.float64, None)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("panel_apply", ["gemm", "paper"])
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("B,n,panel,k", [(1, 100, 32, 16), (3, 256, 64, 1),
                                         (1, 512, 256, 32)])
def test_kernel_matches_plain(cuda, B, n, panel, k, sigma, panel_apply,
                              dtype):
    dt, acc = DTYPES[dtype]
    L, V = spd(B, n, k, dt, sigma, cuda)
    Lp, Vp, _ = blocked._pad_to_panels(L, V, panel)
    Lp, vt = Lp.contiguous(), Vp.mT.contiguous()
    before = F.LAUNCHES.count
    out_k = F.fused_chain_cuda(Lp, vt, sigma=sigma, panel=panel,
                               panel_apply=panel_apply, accum_dtype=acc)
    torch.cuda.synchronize()
    assert F.LAUNCHES.count == before + 1
    out_p = F.fused_chain_plain(Lp, vt, sigma=sigma, panel=panel,
                                panel_apply=panel_apply, accum_dtype=acc)
    Lk = torch.triu(out_k)[:, :n, :n]
    assert entry_err(Lk, out_p[:, :n, :n]) <= entry_limit(dt, n)
    if dt != torch.bfloat16:
        oracle = chol_update_dense(L.double(), V.double(), sigma=sigma)
        assert float((Lk.double() - oracle).abs().max()) <= \
            50 * torch.finfo(dt).eps * n


def test_main_path_takes_one_launch_per_mutation(cuda):
    n, k = 600, 16
    L, V = spd(1, n, k, torch.float32, 1, cuda, seed=1)
    f = CholFactor.from_factor(L[0])
    before = F.LAUNCHES.count
    up = f.update(V[0])
    down = up.downdate(V[0])
    torch.cuda.synchronize()
    assert F.LAUNCHES.count == before + 2
    assert up.device.type == "cuda" and bool(up.is_valid())
    assert float((down.data - f.data).abs().max()) <= \
        50 * torch.finfo(torch.float32).eps * n * float(f.data.abs().max())


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_fleet_takes_one_launch(cuda, precision):
    B, n, k = 8, 300, 4
    L, V = spd(B, n, k, torch.float32, 1, cuda, seed=2)
    before = F.LAUNCHES.count
    out = chol_update_batched(L, V, precision=precision)
    torch.cuda.synchronize()
    assert F.LAUNCHES.count == before + 1
    assert out.shape == (B, n, n) and bool(torch.isfinite(out).all())
    for b in (0, B - 1):
        one = CholFactor.from_factor(L[b], precision=precision).update(V[b])
        assert entry_err(out[b], one.data) <= entry_limit(out.dtype, n)


def test_no_silent_plain_version_on_cuda(cuda):
    L, V = spd(1, 64, 2, torch.float32, 1, cuda)
    with pytest.raises(ValueError, match="interpret=True"):
        F.chol_update_fused(L[0], V[0], panel=32, interpret=True)
    with pytest.raises(ValueError, match="storage/accum"):
        F.fused_chain_cuda(L.half(), V.mT.contiguous().half(), sigma=1,
                           panel=32)


def units(out, ref, unit):
    """max |out - ref| / (unit (|ref| + mean |ref|)) over every entry: the
    measure of ``entry_err`` for tensors that are no upper factor (c, s, T,
    panels, block stacks)."""
    out, ref = out.double(), ref.double()
    floor = ref.abs().mean()
    return float(((out - ref).abs() / (unit * (ref.abs() + floor))).max())


def u_of(dtype):
    return float(torch.finfo(dtype).eps) / 2


def banded(B, nb, b, k, dtype, sigma, dev, seed=0):
    """A block-tridiagonal problem as tests/strategies.py
    make_banded_problem builds it (float64 here), as a fleet of B; for a
    downdate the start is the factor of A + V V^T. Above b = 8 (the sizes
    that procedure was made for) the strictly upper part of a diagonal
    block shrinks by 8 / b, which keeps the block's condition number
    bounded (at full size it grows like ~1.23^b)."""
    rng = np.random.default_rng(seed)
    U0d = rng.uniform(0.2, 1.0, size=(B, nb, b, b))
    U0d = (np.triu(U0d, 1) * min(1.0, 8.0 / b) + U0d * np.eye(b)
           + 2 * np.eye(b))
    U0o = 0.3 * rng.uniform(-1.0, 1.0, size=(B, nb - 1, b, b))
    n = nb * b
    V = np.zeros((B, n, k))
    for m in range(B):
        for c in range(k):
            j = int(rng.integers(nb))
            width = b if j == nb - 1 else 2 * b
            V[m, j * b:j * b + width, c] = 0.4 * rng.normal(size=width)
    S = BlockTriDiagStorage(torch.from_numpy(U0d).to(dev),
                            torch.from_numpy(U0o).to(dev))
    V = torch.from_numpy(V).to(dev)
    if sigma < 0:
        S = BT.btd_chain_plain(S.diag, S.off, V.mT.contiguous(), sigma=1)
        S = BlockTriDiagStorage(*S)
    return BlockTriDiagStorage(S.diag.to(dtype), S.off.to(dtype)), V.to(dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("B,P,k", [(1, 256, 16), (3, 64, 1), (2, 4, 16),
                                   (1, 100, 32)])
def test_diag_block_matches_plain(cuda, B, P, k, sigma, dtype):
    dt, acc = DTYPES[dtype]
    L, V = spd(B, P + 8, k, dt, sigma, cuda, seed=P + k)
    D, vtd = L[:, :P, :P], V[:, :P].mT
    before = K.LAUNCHES["diag_block"].count
    out = K.diag_block(D, vtd, sigma=sigma, accum_dtype=acc)
    torch.cuda.synchronize()
    assert K.LAUNCHES["diag_block"].count == before + 1
    ref = K._diag_block_plain(D, vtd.contiguous(), sigma, acc)
    assert entry_err(out[0], ref[0]) <= entry_limit(dt, P)
    # c, s and T are the accum dtype's, a chain of P rows.
    state = acc or dt
    for x, y in zip(out[1:], ref[1:]):
        assert x.dtype == state and x.shape == y.shape
        assert units(x, y, u_of(state)) <= entry_limit(state, P)


def test_single_row_views_take_their_row_length_as_pitch(cuda):
    """V.mT.contiguous() of a rank-1 V keeps a view whose one row has
    stride 1; the wrappers must not pass that as the leading dimension."""
    L, V = spd(3, 64, 1, torch.float32, 1, cuda, seed=9)
    vtd = V.mT.contiguous()
    assert vtd.stride(-2) == 1
    out = K.diag_block(L, vtd, sigma=1)
    ref = K._diag_block_plain(L, vtd, 1, None)
    assert entry_err(out[0], ref[0]) <= entry_limit(torch.float32, 64)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("apply", ["gemm", "paper"])
@pytest.mark.parametrize("B,P,k,w,block_w", [(1, 256, 16, 4864, 512),
                                             (3, 64, 1, 100, 64),
                                             (2, 4, 16, 12, 512)])
def test_panel_apply_matches_plain(cuda, B, P, k, w, block_w, apply, dtype):
    dt, acc = DTYPES[dtype]
    L, V = spd(B, P + w, k, dt, 1, cuda, seed=w)
    D, vtd = L[:, :P, :P], V[:, :P].mT
    _, c, s, T = K._diag_block_plain(D, vtd.contiguous(), 1, acc)
    R, vt = L[:, :P, P:], (0.1 * V[:, P:].mT).to(dt)
    name = "panel_apply_" + apply
    before = K.LAUNCHES[name].count
    if apply == "gemm":
        out = K.panel_apply_gemm(R, vt, T, block_w=block_w, accum_dtype=acc)
        ref = K._gemm_plain(R, vt, T, acc)
    else:
        out = K.panel_apply_paper(R, vt, c, s, sigma=1, block_w=block_w,
                                  accum_dtype=acc)
        ref = K._paper_plain(R, vt, c, s, 1, acc)
    torch.cuda.synchronize()
    assert K.LAUNCHES[name].count == before + 1
    lim = 4.0 if dt == torch.bfloat16 else 4.0 * P
    for x, y in zip(out, ref):
        assert x.dtype == dt and x.shape == y.shape
        assert units(x, y, u_of(dt)) <= lim


@pytest.mark.parametrize("dtype", ["fp32", "f64"])
@pytest.mark.parametrize("P,k", [(64, 1), (256, 16)])
def test_gemm_apply_reads_t_through_its_pitch(cuda, P, k, dtype):
    """The apply takes T at its row pitch and never reads past column
    P + k: diag_block's own padded T, and a view of a wider buffer whose
    padding holds NaN, both give the plain result."""
    dt, acc = DTYPES[dtype]
    L, V = spd(2, P + 96, k, dt, -1, cuda, seed=P)
    D, vtd = L[:, :P, :P], V[:, :P].mT
    _, _, _, T = K.diag_block(D, vtd, sigma=-1)
    pk = P + k
    wide = torch.full((2, pk, pk + 7), float("nan"), dtype=dt, device=cuda)
    wide[..., :pk] = T
    R, vt = L[:, :P, P:], (0.1 * V[:, P:].mT).to(dt)
    ref = K._gemm_plain(R, vt, T, acc)
    for t in (T, wide[..., :pk]):
        out = K.panel_apply_gemm(R, vt, t)
        for x, y in zip(out, ref):
            assert bool(torch.isfinite(x).all())
            assert units(x, y, u_of(dt)) <= entry_limit(dt, P)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("B,nb,b,k", [(1, 64, 4, 16), (3, 16, 16, 5),
                                      (2, 8, 64, 32), (1, 4, 256, 16)])
def test_blocktridiag_matches_plain(cuda, B, nb, b, k, sigma, dtype):
    dt, acc = DTYPES[dtype]
    S, V = banded(B, nb, b, k, dt, sigma, cuda, seed=nb + b)
    vt = V.mT.contiguous()
    before = BT.LAUNCHES.count
    d_k, o_k = BT.btd_chain_cuda(S.diag, S.off, vt, sigma=sigma,
                                 accum_dtype=acc)
    torch.cuda.synchronize()
    assert BT.LAUNCHES.count == before + 1
    d_p, o_p = BT.btd_chain_plain(S.diag, S.off, vt, sigma=sigma,
                                  accum_dtype=acc)
    lim = 4.0 if dt == torch.bfloat16 else 4.0 * nb * b
    assert units(torch.triu(d_k), torch.triu(d_p), u_of(dt)) <= lim
    assert units(o_k, o_p, u_of(dt)) <= lim
    assert bool(torch.isfinite(d_k).all() and torch.isfinite(o_k).all())


@pytest.mark.parametrize("method", ["pallas", "pallas_gemm"])
@pytest.mark.parametrize("precision", [None, "bf16"])
def test_cascade_takes_two_launches_a_panel(cuda, method, precision):
    n, k, P = 600, 16, 128
    L, V = spd(2, n, k, torch.float32, 1, cuda, seed=3)
    n_panels = -(-n // P)
    name = "panel_apply_" + ("gemm" if method == "pallas_gemm" else "paper")
    d0, a0 = K.LAUNCHES["diag_block"].count, K.LAUNCHES[name].count
    f = CholFactor.from_factor(L[0], panel=P, backend=method,
                               precision=precision)
    one = f.update(V[0])
    fleet = chol_update_batched(L, V, method=method, panel=P,
                                precision=precision)
    torch.cuda.synchronize()
    assert K.LAUNCHES["diag_block"].count - d0 == 2 * n_panels
    assert K.LAUNCHES[name].count - a0 == 2 * (n_panels - 1)
    assert F.launch_count(n, P, method="pallas_2phase", k=k) == \
        2 * n_panels - 1
    ref = CholFactor.from_factor(L[0], panel=P, precision=precision,
                                 backend="fused").update(V[0]).data
    assert entry_err(one.data, ref) <= entry_limit(one.dtype, n)
    assert entry_err(fleet[0], one.data) <= entry_limit(one.dtype, n)


@pytest.mark.parametrize("method", ["fused", "pallas_gemm"])
def test_wide_rank_and_panel_split_into_kernel_limits(cuda, method):
    """k = 48 runs as two column groups, panel = 512 at panel 256: the
    same function, ceil(k / 32) times the launches."""
    n, k, panel = 600, 48, 512
    L, V = spd(1, n, k, torch.float64, -1, cuda, seed=4)
    before = (F.LAUNCHES.count + sum(c.count for c in K.LAUNCHES.values()))
    out = api.chol_update(L[0], V[0], sigma=-1, method=method, panel=panel)
    torch.cuda.synchronize()
    got = (F.LAUNCHES.count + sum(c.count for c in K.LAUNCHES.values())
           - before)
    m = "fused" if method == "fused" else "pallas_2phase"
    assert got == F.launch_count(n, panel, method=m, k=k)
    assert got == (2 if method == "fused" else 2 * (2 * 1024 // 256 - 1))
    oracle = chol_update_dense(L[0], V[0], sigma=-1)
    assert float((out - oracle).abs().max()) <= \
        50 * torch.finfo(torch.float64).eps * n * float(oracle.abs().max())


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_structured_fleet_takes_one_launch_per_sign_block(cuda, precision):
    S, V = banded(4, 32, 8, 16, torch.float32, 1, cuda, seed=5)
    f = CholFactor.from_storage(S, precision=precision)
    before = BT.LAUNCHES.count
    up = f.update(V)
    down = up.downdate(V)
    torch.cuda.synchronize()
    assert BT.LAUNCHES.count == before + 2
    assert down.structure == "blocktridiag" and bool(down.is_valid().all())
    one = CholFactor.from_storage(
        BlockTriDiagStorage(S.diag[1], S.off[1]), precision=precision,
        backend="blocktridiag_ref").update(V[1])
    lim = 4.0 if precision else 4.0 * 256
    unit = u_of(up.dtype)
    assert units(up.data.diag[1], one.data.diag, unit) <= lim
    assert units(up.data.off[1], one.data.off, unit) <= lim


def test_no_plain_version_on_cuda_for_the_new_routes(cuda):
    L, V = spd(1, 64, 2, torch.float32, 1, cuda)
    for method in ("pallas", "pallas_gemm"):
        with pytest.raises(ValueError, match="interpret=True"):
            api.chol_update(L[0], V[0], method=method, panel=32,
                            interpret=True)
    S, Vs = banded(1, 8, 4, 2, torch.float32, 1, cuda)
    one = BlockTriDiagStorage(S.diag[0], S.off[0])
    with pytest.raises(ValueError, match="interpret=True"):
        api.chol_update(one, Vs[0], method="blocktridiag", interpret=True)
    # What a kernel does not take raises; it never runs the plain version.
    with pytest.raises(ValueError, match="storage/accum"):
        K.diag_block(L[0, :8, :8].half(), V[0, :8].mT.half(), sigma=1)
    with pytest.raises(ValueError, match="k <= 32"):
        BT.btd_chain_cuda(S.diag, S.off, torch.zeros(1, 33, 32,
                                                     device=cuda), sigma=1)
