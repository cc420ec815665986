"""The port's CUDA kernels on the card: the fused chain, the per-panel
kernels, the block-tridiagonal chain and the sharded driver's panel
kernel, each against its plain version, and the launches each route takes
per update (the sharded driver on one gloo rank).

Marked ``gpu``; the ``cuda`` fixture skips each test where
``torch.cuda.is_available()`` is false (decided inside the fixture, never
at import, so every pytest-xdist worker collects the same tests). Run on a
machine with an H100 and nvcc:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py -q

The first test builds the kernel from ``src/repro_torch/kernels/csrc``.
"""
from __future__ import annotations

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.core import CholFactor, api, blocked, chol_update_batched
from repro_torch.core import chol_update_dense, distributed
from repro_torch.core.structure import BlockTriDiagStorage
from repro_torch.kernels import blocktridiag as BT
from repro_torch.kernels import cholupdate as K
from repro_torch.kernels import fused as F
from repro_torch.kernels import sharded as SH
from repro_torch.kernels._launch import rank_groups
from repro_torch.obs import metrics as obs_metrics

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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("k", [1, 16, 32])
@pytest.mark.parametrize("P", [4, 37, 100, 256])
def test_diag_block_equals_plain_bit_for_bit(cuda, P, k, B, sigma, dtype):
    """The wavefront sweep takes every rotation in the reference's own
    operations, in the reference's order for each element: D_new, c, s
    and T are the plain recurrence's, bit for bit, in one launch."""
    dt, acc = DTYPES[dtype]
    L, V = spd(B, P + 8, k, dt, sigma, cuda, seed=3 * P + k)
    D, vtd = L[:, :P, :P], V[:, :P].mT
    before = K.LAUNCHES["diag_block"].count
    out = K.diag_block(D, vtd, sigma=sigma, accum_dtype=acc)
    torch.cuda.synchronize()
    assert K.LAUNCHES["diag_block"].count == before + 1
    ref = K._diag_block_plain(D, vtd.contiguous(), sigma, acc)
    for x, y in zip(out, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("panel_apply", ["gemm", "paper"])
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("k", [1, 16, 32])
@pytest.mark.parametrize("P", [4, 37, 100, 256])
def test_fused_single_tile_equals_plain(cuda, P, k, B, sigma, panel_apply,
                                        dtype):
    """A factor of one tile (n = P) is one diagonal sweep and no apply: the
    fused kernel's result is the plain chain's, bit for bit."""
    dt, acc = DTYPES[dtype]
    L, V = spd(B, P, k, dt, sigma, cuda, seed=5 * P + k)
    vt = V.mT.contiguous()
    out_k = F.fused_chain_cuda(L, vt, sigma=sigma, panel=P,
                               panel_apply=panel_apply, accum_dtype=acc)
    out_p = F.fused_chain_plain(L, vt, sigma=sigma, panel=P,
                                panel_apply=panel_apply, accum_dtype=acc)
    assert bool(torch.isfinite(torch.triu(out_k)).all())
    assert torch.equal(torch.triu(out_k), torch.triu(out_p))


def test_single_row_views_take_their_row_length_as_pitch(cuda):
    """V.mT.contiguous() of a rank-1 V keeps a view whose one row has
    stride 1; the wrappers must not pass that as the leading dimension."""
    L, V = spd(3, 64, 1, torch.float32, 1, cuda, seed=9)
    vtd = V.mT.contiguous()
    assert vtd.stride(-2) == 1
    out = K.diag_block(L, vtd, sigma=1)
    ref = K._diag_block_plain(L, vtd, 1, None)
    assert entry_err(out[0], ref[0]) <= entry_limit(torch.float32, 64)


def at_pitch(T, pad):
    """T as a view of a wider buffer whose ``pad`` extra columns hold NaN
    (an odd row pitch for odd ``pad``); T itself for ``pad`` 0."""
    if not pad:
        return T
    wide = torch.full(T.shape[:-1] + (T.shape[-1] + pad,), float("nan"),
                      dtype=T.dtype, device=T.device)
    wide[..., :T.shape[-1]] = T
    return wide[..., :T.shape[-1]]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("apply", ["gemm", "paper"])
@pytest.mark.parametrize("B,P,k,w,block_w,t_pad", [
    (1, 256, 16, 4864, 512, 0),
    (3, 64, 1, 100, 64, 0),
    (2, 4, 16, 12, 512, 0),
    (1, 256, 16, 300, 512, 0),   # w not a multiple of the 64-column strip
    (2, 100, 5, 200, 512, 0),    # P + k not a multiple of the 16-row tile
    (1, 256, 32, 512, 512, 0),   # k = 32 at P = 256
    (1, 256, 16, 256, 512, 0),   # the narrow tail: K split over a cluster
    (3, 256, 16, 768, 512, 0),   # a fleet
    (1, 256, 16, 1000, 512, 5),  # T at an odd pitch
])
def test_panel_apply_matches_plain(cuda, B, P, k, w, block_w, t_pad, apply,
                                   dtype):
    dt, acc = DTYPES[dtype]
    L, V = spd(B, P + w, k, dt, 1, cuda, seed=w)
    D, vtd = L[:, :P, :P], V[:, :P].mT
    _, c, s, T = K._diag_block_plain(D, vtd.contiguous(), 1, acc)
    R, vt = L[:, :P, P:], (0.1 * V[:, P:].mT).to(dt)
    name = "panel_apply_" + apply
    before = K.LAUNCHES[name].count
    if apply == "gemm":
        out = K.panel_apply_gemm(R, vt, at_pitch(T, t_pad), block_w=block_w,
                                 accum_dtype=acc)
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
        assert bool(torch.isfinite(x).all())
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


def test_gemm_tile_layout_is_the_kernels(cuda):
    """The host prices the K split from the tile's layout
    (_launch.GEMM_BN, GEMM_BK, GEMM_WARP_BLOCKS); the built kernel reports
    its own, and the two agree. The split the wrapper picks for the card
    is one it can place."""
    import ctypes

    from repro_torch.kernels import _launch as LA

    out = (ctypes.c_int * 20)()
    K._lib().repro_gemm_tile_layout(out)
    assert (out[0], out[1]) == (LA.GEMM_BN, LA.GEMM_BK)
    assert tuple(out[2:11]) == LA.GEMM_WARP_BLOCKS["vt"]
    assert tuple(out[11:20]) == LA.GEMM_WARP_BLOCKS["panel"]
    for code in (0, 1, 2):
        cap = K._gemm_capacity(cuda, code)
        assert len(cap) == len(LA.GEMM_SPLITS) and cap[0] >= 1
        for w in (256, 1024, 4864):
            split = LA.gemm_split(1, w, 256, 16, cap)
            assert cap[LA.GEMM_SPLITS.index(split)] >= 1


def test_gemm_ffma_rows_is_the_kernels(cuda):
    """The host picks the gemm apply's FFMA form by the kernel's own
    threshold (the capacity it prices the split with is that form's)."""
    from repro_torch.kernels import _launch as LA

    assert K._lib().repro_gemm_ffma_rows() == LA.GEMM_FFMA_ROWS
    for code in (0, 1):
        cap = K._gemm_capacity(cuda, code, True)
        assert len(cap) == len(LA.GEMM_SPLITS) and cap[0] >= 1


def smoke_p4_draw():
    """The float64 draws (Bm, V) of ``chip_smoke.py`` phase 2c's case
    B = 2, P = 4, k = 16, w = 64, gemm, sigma = -1, fp32, as the script
    made them while phase 2b's shapes P = 37 and P = 100 drew from its
    shared generator (seed 0): every call before it, in the script's order
    and shapes. On that draw the 3xTF32 apply read 16.294 units on vt."""
    import itertools

    rng = np.random.default_rng(0)
    # The wide block: banded(1, 512, 64, 16).
    rng.uniform(0.2, 1.0, size=(1, 512, 64, 64))
    rng.uniform(-1.0, 1.0, size=(1, 511, 64, 64))
    rng.integers(512, size=(1, 16))
    rng.normal(size=(1, 128, 16))

    def spd_draw(B, n, k):
        return rng.uniform(size=(B, n, n)), rng.uniform(size=(B, n, k))

    dts = range(3)
    for n, _, k, *_ in itertools.product((100, 256), (32, 64), (1, 16),
                                         (1, -1), ("gemm", "paper"), dts):
        spd_draw(1, n, k)                                   # phase 2a
    for _ in itertools.product((1, -1), ("gemm", "paper"), dts):
        spd_draw(3, 100, 32)
    for (n, _, k), *_ in itertools.product(((200, 64, 48), (300, 512, 16)),
                                           (1, -1), dts):
        spd_draw(1, n, k)
    for (B, P, k), *_ in itertools.product(
            ((1, 256, 16), (3, 64, 1), (2, 4, 16), (1, 128, 32),
             (3, 37, 32), (1, 100, 1)), (1, -1), dts):
        spd_draw(B, P, k)                                   # phase 2b
    for (B, P, k, w), apply, sigma, dt in itertools.product(
            ((1, 256, 16, 512), (3, 64, 1, 100), (2, 4, 16, 64)),
            ("gemm", "paper"), (1, -1), dts):               # phase 2c
        drawn = spd_draw(B, P + w, k)
        if (P, apply, sigma, dt) == (4, "gemm", -1, 0):
            return drawn
    raise AssertionError("the case is not in phase 2c")


def test_gemm_apply_holds_4p_on_the_p4_draw(cuda):
    """The draw on which the 3xTF32 apply at P = 4, k = 16 read 16.294
    units on vt against the 4 P = 16 limit, built as chip_smoke.py
    builds it (spd_factor on the card in f64, then phase 2c's panel); the
    units are the smoke's, each member's entries over that member's mean
    magnitude. The FFMA form (P + k <= 64) holds the limit."""
    Bm, V = (torch.from_numpy(x).to(cuda) for x in smoke_p4_draw())
    n, P = Bm.shape[-1], 4
    A = Bm.mT @ Bm + torch.eye(n, dtype=torch.float64, device=cuda)
    A = A + V @ V.mT
    L = torch.linalg.cholesky(A).mT.contiguous().float()
    V = V.float()
    D, vtd = L[:, :P, :P], V[:, :P].mT.contiguous()
    _, c, s, T = K._diag_block_plain(D, vtd, -1, None)
    R, vt = L[:, :P, P:], (0.1 * V[:, P:].mT).float()
    out = K.panel_apply_gemm(R, vt, T)
    ref = K._gemm_plain(R, vt, T, None)
    for x, y in zip(out, ref):
        x, y = x.double(), y.double()
        floor = y.abs().mean(dim=(-2, -1), keepdim=True)
        err = float(((x - y).abs() / (u_of(torch.float32)
                                      * (y.abs() + floor))).max())
        assert bool(torch.isfinite(x).all()) and err <= 4.0 * P


PAPER_PK = [(P, k) for P in (1, 4, 37, 100, 256) for k in (1, 5, 16, 32)]
PAPER_BW = [(1, 1), (3, 33), (1, 100), (3, 4864)]


def paper_inputs(B, P, k, w, sigma, dt, acc, dev, seed):
    """Rotations (c, s) of a diagonal block of a factor (its plain
    recurrence) and a row panel R, vt of w columns drawn beside it."""
    L, V = spd(B, P + 8, k, dt, sigma, dev, seed=seed)
    _, c, s, _ = K._diag_block_plain(L[:, :P, :P],
                                     V[:, :P].mT.contiguous(), sigma, acc)
    rng = np.random.default_rng(seed + 1)
    R = torch.from_numpy(rng.uniform(-1, 1, size=(B, P, w))).to(dev, dt)
    vt = torch.from_numpy(rng.uniform(size=(B, k, w))).to(dev, dt)
    return R, vt, c, s


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("P,k", PAPER_PK)
def test_paper_apply_equals_plain_bit_for_bit(cuda, P, k, sigma, dtype):
    """The wavefront takes every rotation in apply_rotations' own
    operations, in its order for each element: R and vt are the plain
    version's, bit for bit, in one launch. Each (P, k) takes one of the
    (B, w) shapes, in turn."""
    dt, acc = DTYPES[dtype]
    i = PAPER_PK.index((P, k))
    B, w = PAPER_BW[(i + i // 4) % len(PAPER_BW)]
    R, vt, c, s = paper_inputs(B, P, k, w, sigma, dt, acc, cuda, seed=i)
    before = K.LAUNCHES["panel_apply_paper"].count
    out = K.panel_apply_paper(R, vt, c, s, sigma=sigma, accum_dtype=acc)
    torch.cuda.synchronize()
    assert K.LAUNCHES["panel_apply_paper"].count == before + 1
    ref = K._paper_plain(R, vt, c, s, sigma, acc)
    for x, y in zip(out, ref):
        assert x.dtype == dt and x.shape == y.shape
        assert bool(torch.isfinite(x).all())
        assert torch.equal(x, y)


@pytest.mark.parametrize("k", [1, 16])
def test_paper_apply_redoes_flagged_windows_exactly(cuda, k):
    """Divisions the fast path flags (quotients past 2^60 or under 2^-60
    on some columns and rows, a divisor past 2^30): the warp redoes its
    window with IEEE divisions, and R and vt are still the plain
    version's, bit for bit."""
    R, vt, c, s = paper_inputs(1, 256, k, 300, 1, torch.float32, None, cuda,
                               seed=71)
    R[:, :, ::7] *= 1e19
    R[:, 5::11] *= 1e-20
    c = c.clone()
    c[0, 3, k - 1] = 1.2e9
    out = K.panel_apply_paper(R, vt, c, s, sigma=1)
    ref = K._paper_plain(R, vt, c, s, 1, None)
    for x, y in zip(out, ref):
        assert bool(torch.isfinite(y).all())
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,P,k,w", [(1, 256, 16, 4864), (3, 100, 5, 33),
                                     (3, 37, 32, 100), (1, 4, 1, 1)])
def test_paper_apply_in_place_on_pitched_views_equals_plain(cuda, B, P, k,
                                                            w, dtype):
    """``panel_apply_paper_`` on views of padded buffers (row pitch past w,
    a column offset, member strides): the plain version's values, bit for
    bit, and nothing outside the views written."""
    dt, acc = DTYPES[dtype]
    R, vt, c, s = paper_inputs(B, P, k, w, -1, dt, acc, cuda, seed=w + k)
    Rbuf = torch.full((B, P + 3, w + 41), 7.0, dtype=dt, device=cuda)
    vbuf = torch.full((B, k + 2, w + 19), 7.0, dtype=dt, device=cuda)
    Rv, vv = Rbuf[:, 2:2 + P, 5:5 + w], vbuf[:, 1:1 + k, 3:3 + w]
    Rv.copy_(R)
    vv.copy_(vt)
    K.panel_apply_paper_(Rv, vv, c, s, sigma=-1, accum_dtype=acc)
    ref = K._paper_plain(R, vt, c, s, -1, acc)
    assert torch.equal(Rv, ref[0]) and torch.equal(vv, ref[1])
    Rv.fill_(7.0)
    vv.fill_(7.0)
    assert bool((Rbuf == 7.0).all()) and bool((vbuf == 7.0).all())


@pytest.mark.parametrize("precision", [None, "bf16"])
def test_paper_cascade_splits_k33_into_rank_groups(cuda, precision):
    """k = 33 takes the paper apply through the pallas cascade as two rank
    groups (32 and 1 rotations): per panel two diagonal passes and two
    applies, each equal to its plain version, so the factor is that of
    the same cascade on the card with the plain versions as its hooks,
    bit for bit."""
    from repro_torch.core.precision import Precision
    from repro_torch.kernels import ops
    from repro_torch.kernels._launch import kernel_panel

    n, k, P = 300, 33, 64
    L, V = spd(1, n, k, torch.float32, -1, cuda, seed=33)
    d0 = K.LAUNCHES["panel_apply_paper"].count
    out = ops.chol_update_pallas(L[0], V[0], sigma=-1, panel=P,
                                 strategy="paper", precision=precision)
    torch.cuda.synchronize()
    n_panels = -(-n // P)
    assert K.LAUNCHES["panel_apply_paper"].count - d0 == 2 * (n_panels - 1)
    prec = Precision.parse(precision)
    acc = None if prec is None else prec.accum

    def diag_fn(D, vtd, sig):
        D_new, c, s, T = K._diag_block_plain(D, vtd, sig, acc)
        D.copy_(D_new)
        vtd.zero_()
        return D, c, s, T

    def apply_fn(R, vt, c, s, T, sig):
        R_new, vt_new = K._paper_plain(R, vt, c, s, sig, acc)
        R.copy_(R_new)
        vt.copy_(vt_new)
        return R, vt

    ref, Vp, _ = blocked._pad_to_panels(L[0], V[0], P)
    for g in rank_groups(k):
        ref = blocked.chol_update_blocked(
            ref, Vp[:, g], sigma=-1, panel=kernel_panel(P), strategy="gemm",
            apply_fn=apply_fn, diag_fn=diag_fn, precision=prec)
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, ref[:n, :n])


def chain_units(x, y, unit):
    """Largest error of a block chain's ``(diag, off)`` against another's,
    in units of roundoff (``units``; upper triangles of the diag blocks)."""
    return max(units(torch.triu(x[0]), torch.triu(y[0]), unit),
               units(x[1], y[1], unit))


def chain_oracle(S, V, sigma):
    """The float64 chain refactorization of the (rounded) inputs: the
    block factor of A + sigma V V^T, A = S's own matrix."""
    ad, ao = S.astype(torch.float64).matrix_blocks()
    b = S.diag.shape[-1]
    Vb = V.double().reshape(V.shape[:-2] + (V.shape[-2] // b, b,
                                            V.shape[-1]))
    vd = Vb @ Vb.mT
    vo = Vb[..., :-1, :, :] @ Vb[..., 1:, :, :].mT
    orc = BlockTriDiagStorage.from_matrix_blocks(ad + sigma * vd,
                                                 ao + sigma * vo)
    return orc.diag, orc.off


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("B,nb,b,k", [(1, 64, 4, 16), (3, 16, 16, 5),
                                      (2, 8, 64, 32), (1, 4, 256, 16)])
def test_blocktridiag_matches_plain(cuda, B, nb, b, k, sigma, dtype):
    """Kernel against plain: 4 nb b units in fp32/f64. In bf16 a chain of
    nb > 1 blocks hands each block its slab through the bf16-stored result
    of the block before, and another summation order need not repeat the
    plain version's rounding flips there; so the kernel is held to the
    plain version's own distance from the float64 chain refactorization
    of the rounded inputs, plus 4 units (one flipped stored rounding on
    each side), both finite. The 256-row blocks take three more seeds."""
    dt, acc = DTYPES[dtype]
    two_witness = dt == torch.bfloat16 and nb > 1
    seeds = [nb + b] + ([1001, 1002, 1003]
                        if dt == torch.bfloat16 and b == 256 else [])
    for seed in seeds:
        S, V = banded(B, nb, b, k, dt, sigma, cuda, seed=seed)
        vt = V.mT.contiguous()
        before = BT.LAUNCHES.count
        d_k, o_k = BT.btd_chain_cuda(S.diag, S.off, vt, sigma=sigma,
                                     accum_dtype=acc)
        torch.cuda.synchronize()
        assert BT.LAUNCHES.count == before + 1
        d_p, o_p = BT.btd_chain_plain(S.diag, S.off, vt, sigma=sigma,
                                      accum_dtype=acc)
        assert bool(torch.isfinite(d_k).all() and torch.isfinite(o_k).all())
        assert bool(torch.isfinite(d_p).all() and torch.isfinite(o_p).all())
        if two_witness:
            orc = chain_oracle(S, V, sigma)
            e_k = chain_units((d_k, o_k), orc, u_of(dt))
            e_p = chain_units((d_p, o_p), orc, u_of(dt))
            assert e_k <= e_p + 4.0, (seed, e_k, e_p)
        else:
            lim = 4.0 if dt == torch.bfloat16 else 4.0 * nb * b
            assert units(torch.triu(d_k), torch.triu(d_p), u_of(dt)) <= lim
            assert units(o_k, o_p, u_of(dt)) <= lim


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


# ---------------------------------------------------------------------------
# the redesigned sweep and block step: panels off the 32-column warp grid,
# the one-warp and one-CTA block-chain routes, blocks above 256 rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("panel_apply", ["gemm", "paper"])
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("k", [1, 16, 32, 33])
@pytest.mark.parametrize("panel", [100, 37, 4])
@pytest.mark.parametrize("B", [1, 3])
def test_fused_sweep_off_the_warp_grid_matches_plain(cuda, B, panel, k,
                                                     sigma, panel_apply,
                                                     dtype):
    """Panels that are no multiple of a warp's 32 columns (a warp's
    columns straddle two panels, the last warp is ragged), over a factor
    of two panels and a ragged third. k = 33 runs as two launches of 32
    and 1 columns, so its plain version is walked the same way, one pass
    a column group."""
    dt, acc = DTYPES[dtype]
    n = 2 * panel + 3
    L, V = spd(B, n, k, dt, sigma, cuda, seed=panel + k)
    Lp, Vp, _ = blocked._pad_to_panels(L, V, panel)
    Lp, vt = Lp.contiguous(), Vp.mT.contiguous()
    before = F.LAUNCHES.count
    out_k = F.fused_chain(Lp, vt, sigma=sigma, panel=panel,
                          panel_apply=panel_apply, accum_dtype=acc)
    torch.cuda.synchronize()
    assert F.LAUNCHES.count == before + F.launch_count(
        n, panel, method="fused", k=k)
    out_p = Lp
    for g in rank_groups(k):
        out_p = F.fused_chain_plain(out_p, vt[:, g].contiguous(),
                                    sigma=sigma, panel=panel,
                                    panel_apply=panel_apply, accum_dtype=acc)
    assert bool(torch.isfinite(out_k).all())
    Lk = torch.triu(out_k)[:, :n, :n]
    assert entry_err(Lk, torch.triu(out_p)[:, :n, :n]) <= entry_limit(dt, n)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("B,nb,b,k", [
    (1, 64, 4, 16),    # the smoother's block: one warp
    (3, 16, 16, 16),   # b + k = 32: the one-warp route's edge
    (2, 8, 31, 1),     # b + k = 32 at odd b
    (2, 16, 16, 17),   # b + k = 33: one CTA
    (2, 8, 64, 32),
    (1, 4, 256, 16),
    (1, 3, 320, 16),   # two sub-tiles, the second of 64 rows
    (1, 3, 512, 16),   # two full sub-tiles
])
def test_block_chain_routes_match_plain(cuda, B, nb, b, k, sigma, dtype):
    """Both block-chain routes and the sub-tiled blocks in one launch, at
    the limits of test_blocktridiag_matches_plain: 4 nb b units in fp32;
    in bf16, for nb > 1, the kernel within the plain version's distance
    from the float64 chain refactorization plus 4 units."""
    dt, acc = DTYPES[dtype]
    S, V = banded(B, nb, b, k, dt, sigma, cuda, seed=nb + b + k)
    vt = V.mT.contiguous()
    before = BT.LAUNCHES.count
    d_k, o_k = BT.btd_chain_cuda(S.diag, S.off, vt, sigma=sigma,
                                 accum_dtype=acc)
    torch.cuda.synchronize()
    assert BT.LAUNCHES.count == before + 1
    d_p, o_p = BT.btd_chain_plain(S.diag, S.off, vt, sigma=sigma,
                                  accum_dtype=acc)
    assert bool(torch.isfinite(d_k).all() and torch.isfinite(o_k).all())
    assert torch.equal(torch.tril(d_k, -1), torch.tril(S.diag, -1))
    if dt == torch.bfloat16:
        orc = chain_oracle(S, V, sigma)
        e_k = chain_units((d_k, o_k), orc, u_of(dt))
        e_p = chain_units((d_p, o_p), orc, u_of(dt))
        assert e_k <= e_p + 4.0, (e_k, e_p)
    else:
        lim = 4.0 * nb * b
        assert units(torch.triu(d_k), torch.triu(d_p), u_of(dt)) <= lim
        assert units(o_k, o_p, u_of(dt)) <= lim


@pytest.mark.parametrize("sigma", [1, -1])
def test_block_chain_keeps_wide_slabs_in_scratch(cuda, sigma):
    """f64, b = 600, k = 32: three sub-tiles (the last of 88 rows), the
    block's transform and both running slabs in the CTA route's global
    scratch; 4 nb b units against the plain chain."""
    nb, b, k = 2, 600, 32
    S, V = banded(1, nb, b, k, torch.float64, sigma, cuda, seed=11)
    vt = V.mT.contiguous()
    d_k, o_k = BT.btd_chain_cuda(S.diag, S.off, vt, sigma=sigma)
    d_p, o_p = BT.btd_chain_plain(S.diag, S.off, vt, sigma=sigma)
    assert bool(torch.isfinite(d_k).all() and torch.isfinite(o_k).all())
    lim = 4.0 * nb * b
    assert units(torch.triu(d_k), torch.triu(d_p), u_of(torch.float64)) <= lim
    assert units(o_k, o_p, u_of(torch.float64)) <= lim


@pytest.mark.parametrize("k", [16, 48])
def test_wide_block_factor_takes_one_launch_per_sign_block(cuda, k):
    """A factor with b = 320 updates and downdates on the card through
    CholFactor, ceil(k / 32) launches a sign block."""
    S, V = banded(1, 3, 320, k, torch.float32, 1, cuda, seed=7)
    one = BlockTriDiagStorage(S.diag[0], S.off[0])
    f = CholFactor.from_storage(one)
    before = BT.LAUNCHES.count
    up = f.update(V[0])
    down = up.downdate(V[0])
    torch.cuda.synchronize()
    assert BT.LAUNCHES.count == before + 2 * len(range(0, k, 32))
    assert bool(up.is_valid()) and bool(down.is_valid())
    ref = CholFactor.from_storage(one, backend="blocktridiag_ref").update(
        V[0])
    lim = 4.0 * 3 * 320
    assert units(up.data.diag, ref.data.diag, u_of(torch.float32)) <= lim
    assert units(up.data.off, ref.data.off, u_of(torch.float32)) <= lim


# ---------------------------------------------------------------------------
# the column-sharded driver's panel kernel, one rank on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_mesh(tmp_path_factory):
    """A one-rank mesh on the card (gloo, a file:// store)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    store = tmp_path_factory.mktemp("cuda_mesh") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
    finally:
        dist.destroy_process_group()


def chain_stacks(L, V, sigma, P, acc):
    """The chain phase's stacks of the whole factor (one shard holding
    every column): T and D are the same on every shard, and a shard's
    running V^T is its columns of this one."""
    n = L.shape[-1]
    vt = V.mT.contiguous()
    return distributed._chain_phase(
        L, vt, sigma=sigma, panel=P, w_loc=n, me=0, mesh=None, dims=[],
        acc=acc or L.dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("tile_off", [0, 1, 3])
@pytest.mark.parametrize("B,P,k,t_pad", [
    (None, 64, 1, 0), (3, 64, 16, 0), (None, 256, 32, 0),
    (None, 100, 5, 0),   # a tile of 64 + 36 columns; P + k = 105 rows
    (3, 256, 16, 0),     # a fleet at the main path's panel
    (None, 256, 16, 3),  # T at an odd pitch
])
def test_sharded_panel_kernel_matches_plain(cuda, B, P, k, t_pad, tile_off,
                                            sigma, dtype):
    """One shard of four, one tile wide: its tile on, above or below the
    diagonal of each row panel, against the plain version entry by entry
    (4 P units in fp32/f64, 4 in bf16)."""
    dt, acc = DTYPES[dtype]
    n, w = 4 * P, P
    L, V = spd(B or 1, n, k, dt, sigma, cuda, seed=P + k)
    if B is None:
        L, V = L[0], V[0]
    T, D, vt = chain_stacks(L, V, sigma, P, acc)
    cols = slice(tile_off * w, (tile_off + 1) * w)
    L_loc = L[..., cols].contiguous()
    vt_loc = vt[..., cols].contiguous()
    before = SH.LAUNCHES.count
    out = SH.panel_apply_sharded(L_loc, at_pitch(T, t_pad), D, vt_loc,
                                 tile_off=tile_off, panel=P, accum_dtype=acc)
    torch.cuda.synchronize()
    assert SH.LAUNCHES.count == before + 1
    ref = SH.panel_apply_sharded_plain(L_loc, T, D, vt_loc,
                                       tile_off=tile_off, panel=P,
                                       accum_dtype=acc)
    assert out.dtype == dt and bool(torch.isfinite(out).all())
    assert units(out, ref, u_of(dt)) <= (4.0 if dt == torch.bfloat16
                                         else 4.0 * P)
    # The diagonal tile is D rounded once; below it zeros, exactly.
    rows = slice(tile_off * P, (tile_off + 1) * P)
    assert torch.equal(out[..., rows, :], ref[..., rows, :])
    assert not bool(out[..., (tile_off + 1) * P:, :].any())


@pytest.mark.parametrize("strategy", ["fused", "gemm", "paper"])
def test_sharded_path_launches_per_shard(cuda, cuda_mesh, strategy):
    """One rank: per update n_panels diagonal passes and one panel-phase
    launch (fused) or one panel apply per panel (gemm, paper), for a
    factor and for a fleet alike; the result agrees with the fused
    backend's within 4 n units."""
    n, k, P = 1024, 16, 256
    L, V = spd(3, n, k, torch.float32, 1, cuda, seed=9)
    counters = {"panel_apply_sharded": SH.LAUNCHES}
    counters.update(K.LAUNCHES)

    def counts():
        return {name: c.count for name, c in counters.items()}

    want = SH.kernel_launches(n, P, strategy=strategy, k=k)
    for what, run in (
            ("factor", lambda: api.chol_update(
                L[0], V[0], method="sharded", mesh=cuda_mesh, panel=P,
                strategy=strategy)),
            ("fleet", lambda: chol_update_batched(
                L, V, method="sharded", mesh=cuda_mesh, panel=P,
                strategy=strategy))):
        c0 = counts()
        out = run()
        torch.cuda.synchronize()
        got = {name: v - c0[name] for name, v in counts().items()}
        assert {name: v for name, v in got.items() if v} == want, what
        assert distributed.is_sharded(out)
        ref = chol_update_batched(L, V, method="fused", panel=P)
        full = distributed.gather(out)
        assert entry_err(full, ref[0] if what == "factor" else ref) <= \
            entry_limit(torch.float32, n)


def test_sharded_factor_update_downdate_and_wide_rank(cuda, cuda_mesh):
    """CholFactor(backend='sharded'): k = 48 runs as two passes, each one
    panel-phase launch. Each of the update and the downdate back is held
    against the ``pallas_gemm`` route on the same inputs (the same
    diagonal kernel and transform, another kernel's rounding), entry by
    entry within 4 n units; and, as a second witness, its distance from
    the exact answer (the f64 refactorization, and the start for the
    downdate) may exceed that route's by at most the same 4 n units."""
    n, k, P = 512, 48, 256
    L, V = spd(1, n, k, torch.float64, 1, cuda, seed=11)
    f = CholFactor.from_factor(L[0], panel=P, backend="sharded",
                               mesh=cuda_mesh)
    before = SH.LAUNCHES.count
    up = f.update(V[0])
    down = up.downdate(V[0])
    torch.cuda.synchronize()
    assert SH.LAUNCHES.count - before == 2 * SH.launch_count_sharded(
        n, P, strategy="fused", k=k) == 4
    lim = entry_limit(torch.float64, n)
    up_s = distributed.gather(up.data)
    down_s = distributed.gather(down.data)
    up_g = api.chol_update(L[0], V[0], method="pallas_gemm", panel=P)
    down_g = api.chol_update(up_s, V[0], sigma=-1, method="pallas_gemm",
                             panel=P)
    for got, other, exact in ((up_s, up_g, chol_update_dense(L[0], V[0])),
                              (down_s, down_g, L[0])):
        assert entry_err(got, other) <= lim
        assert entry_err(got, exact) <= entry_err(other, exact) + lim


def test_no_plain_version_on_cuda_for_the_sharded_route(cuda_mesh):
    L, V = spd(1, 64, 2, torch.float32, 1, cuda_mesh.device_type)
    with pytest.raises(ValueError, match="interpret=True"):
        api.chol_update(L[0], V[0], method="sharded", mesh=cuda_mesh,
                        panel=32, interpret=True)
    T, D, vt = chain_stacks(L[0], V[0], 1, 32, None)
    with pytest.raises(ValueError, match="interpret=True"):
        SH.panel_apply_sharded(L[0], T, D, vt, tile_off=0, panel=32,
                               interpret=True)
    with pytest.raises(ValueError, match="k <= 32"):
        SH.panel_apply_sharded_cuda(
            L[0], torch.zeros(2, 65, 65, device="cuda"), D,
            torch.zeros(2, 33, 64, device="cuda"), tile_off=0, panel=32)


# ---------------------------------------------------------------------------
# The stream store's CUDA graphs
# ---------------------------------------------------------------------------

STREAM_N, STREAM_B = 64, 8  # dense n; block size of the structured fleet


def stream_store(dev, structure, dtype, **kw):
    """A two-rung (2, 4) store, widths (1, 4), warmed: its steps are
    captured graphs."""
    from repro_torch.stream import FactorStore

    dt, acc = DTYPES[dtype]
    opts = dict(capacity=2, ladder=(2, 4), width=4, widths=(1, 4),
                panel=32, device=dev, dtype=torch.float32 if acc else dt,
                precision="bf16" if acc else None)
    if structure == "blocktridiag":
        opts.update(structure="blocktridiag", block=STREAM_B)
    opts.update(kw)
    st = FactorStore(STREAM_N, **opts)
    st.warmup()
    return st


def stream_rows(st, w, seed, scale=0.3):
    """A (capacity, n, w) host block of rows (block-local for a structured
    fleet)."""
    rng = np.random.default_rng(seed)
    V = scale * rng.normal(size=(st.capacity, st.n, w))
    if st.block is not None:
        b = st.block
        mask = np.zeros_like(V)
        for m in range(st.capacity):
            for c in range(w):
                j = int(rng.integers(0, st.n // b - 1))
                mask[m, j * b:(j + 2) * b, c] = 1.0
        V = V * mask
    return V.astype(st.row_dtype)


def fleet_leaves(data):
    if isinstance(data, BlockTriDiagStorage):
        return [data.diag, data.off]
    return [data]


def fleet_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(fleet_leaves(a),
                                                 fleet_leaves(b)))


def clone_fleet(data):
    return (BlockTriDiagStorage(data.diag.clone(), data.off.clone())
            if isinstance(data, BlockTriDiagStorage) else data.clone())


@pytest.mark.parametrize("structure", ["dense", "blocktridiag"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_stream_replay_equals_the_eager_step(cuda, structure, dtype):
    """Every step kind replayed from its graph equals the eager calls
    (``CholFactor.update``, ``downdate_guarded``, ``scale``; the eager
    step for slot_set and promote) on a clone of the fleet, bit for bit,
    verdicts included (one member's downdate infeasible)."""
    st = stream_store(cuda, structure, dtype)
    meta = st._meta
    for u in "ab":
        st.admit(u)
    st.apply(stream_rows(st, 4, seed=1), None)
    torch.cuda.synchronize()

    def eager(data):
        return CholFactor(clone_fleet(data), **meta)

    up = stream_rows(st, 4, seed=2)
    before = eager(st.factor.data)
    assert st.apply(up, None) is None
    ref = before.update(torch.from_numpy(up).to(cuda))
    assert fleet_equal(st.factor.data, ref.data), "up"

    for both in (False, True):
        dn = stream_rows(st, 1 if both else 4, seed=3 + both, scale=0.05)
        dn[1] *= 100.0                     # member 1: infeasible
        vup = stream_rows(st, 4, seed=5) if both else None
        before = eager(st.factor.data)
        ok = st.apply(vup, dn)
        if both:
            before = before.update(torch.from_numpy(vup).to(cuda))
        ref, ok_ref = before.downdate_guarded(torch.from_numpy(dn).to(cuda))
        assert ok.tolist() == ok_ref.tolist() == [True, False]
        assert fleet_equal(st.factor.data, ref.data), ("both" if both
                                                       else "down")

    before = eager(st.factor.data)
    st.decay(0.9)
    alpha = torch.tensor(st.row_dtype.type(0.9), device=cuda)
    assert fleet_equal(st.factor.data, before.scale(alpha).data), "scale"

    st.evict("a")
    base = [t.clone() for t in st._base]
    st.admit("c", scale=2.0)
    step = st.steps.entries[st.steps.key("slot_set", 2)]
    step.run(base, eager=True)
    assert all(torch.equal(x, y) for x, y in zip(st._base, base))
    st.admit("d")                           # promote 2 -> 4, then slot_set
    assert st.capacity == 4
    step = st.steps.entries[st.steps.key("promote", 2)]
    step.run(base, eager=True)
    st.steps.entries[st.steps.key("slot_set", 4)].run(base, eager=True)
    assert all(torch.equal(x, y) for x, y in zip(st._base, base))
    assert st.steps.cold_dispatches == 0


@pytest.mark.parametrize("structure", ["dense", "blocktridiag"])
def test_stream_replay_counts_the_launches_its_graph_holds(cuda, structure):
    """A capture holds its launches back (they did not run); each replay
    adds the launches its graph holds: 1 fused_chain (dense, k <= 32) or 1
    btd_chain (structured) per sign block, in ``LAUNCHES`` and in
    ``repro.kernels.launches``."""
    from repro_torch.obs import metrics
    from repro_torch.stream import mutations_issued

    counter = F.LAUNCHES if structure == "dense" else BT.LAUNCHES
    series = "fused" if structure == "dense" else "blocktridiag"

    def registry():
        return sum(v for key, v in metrics.snapshot()["counters"].items()
                   if key.startswith("repro.kernels.launches{")
                   and f"module={series}," in key)

    c0, r0 = counter.count, registry()
    st = stream_store(cuda, structure, "fp32")
    torch.cuda.synchronize()
    warm = counter.count - c0              # the eager warm-up runs only
    assert registry() - r0 == warm > 0
    st.admit("a")
    for vup, dn, want in ((stream_rows(st, 4, 1), None, 1),
                          (None, stream_rows(st, 1, 2, 0.05), 1),
                          (stream_rows(st, 4, 3), stream_rows(st, 4, 4, 0.05),
                           2)):
        c1, r1, m1 = counter.count, registry(), mutations_issued()
        st.apply(vup, dn)
        torch.cuda.synchronize()
        assert counter.count - c1 == registry() - r1 == want
        assert mutations_issued() - m1 == want


def test_stream_service_crossing_a_rung_never_captures(cuda):
    """assert_no_retrace over admit / push / tick / flush / decay / evict /
    readmit / promote after warmup; a cold width met by the background
    worker is captured there and counted."""
    from repro_torch.stream import (RetraceError, StreamService,
                                    assert_no_retrace)

    st = stream_store(cuda, "dense", "fp32")
    svc = StreamService(st, window=3, deadline=2)
    rng = np.random.default_rng(7)
    with assert_no_retrace("two-rung sequence"):
        for t in range(10):
            for u in "ab":
                svc.push(u, 0.3 * rng.normal(size=st.n).astype(np.float32))
            if t == 4:
                svc.admit("c")             # promote 2 -> 4
                svc.decay(0.95)
                svc.evict("b")
                svc.admit("b")
            svc.tick()
        svc.flush(force=True)
    assert st.capacity == 4 and st.steps.cold_dispatches == 0
    assert bool(st.factor.is_valid().all())

    cold = stream_store(cuda, "dense", "fp32")
    del cold.steps.entries[cold.steps.key("up", 2, (4,))]
    svc = StreamService(cold, background=True)
    with pytest.raises(RetraceError):
        with assert_no_retrace("a cold width in the worker"):
            for v in 0.3 * rng.normal(size=(4, cold.n)):
                svc.push("a", v.astype(np.float32))  # 4th row: width flush
            reports = svc.drain()
    svc.stop_background()
    assert [r.widths for r in reports] == [(4,)]
    assert cold.steps.cold_dispatches == 1


def test_stream_capture_in_a_thread_holds_only_its_own_counts(cuda):
    """A graph captured in a worker thread while another store replays in
    this one: the replays count once each, the capture holds back only its
    own thread's launch (its eager warm-up run on a scratch fleet ran and
    counts), and each replay of the new graph adds its one launch, in
    ``LAUNCHES`` and in ``repro.kernels.launches``."""
    import threading

    from repro_torch.obs import metrics

    def registry():
        return sum(v for key, v in metrics.snapshot()["counters"].items()
                   if key.startswith("repro.kernels.launches{")
                   and "module=fused," in key)

    hot = stream_store(cuda, "dense", "fp32")
    cold = stream_store(cuda, "dense", "fp32")
    for st in (hot, cold):
        st.admit("a")
    key = cold.steps.key("up", 2, (4,))
    del cold.steps.entries[key]
    V = stream_rows(hot, 4, seed=1, scale=0.01)
    torch.cuda.synchronize()
    c0, r0 = F.LAUNCHES.count, registry()
    done = threading.Event()
    failed = []

    def capture():
        try:
            cold.steps.build("up", 2, (4,))
        except Exception as e:  # surfaced below
            failed.append(e)
        finally:
            done.set()

    worker = threading.Thread(target=capture)
    worker.start()
    replays = 0
    while not done.is_set() or replays < 20:
        hot.apply(V, None)
        replays += 1
    worker.join()
    torch.cuda.synchronize()
    assert not failed, failed
    want = replays + 1                    # + the capture's eager run
    assert F.LAUNCHES.count - c0 == registry() - r0 == want
    for _ in range(3):
        cold.apply(V, None)
    torch.cuda.synchronize()
    assert F.LAUNCHES.count - c0 == registry() - r0 == want + 3
    assert len(cold.steps.entries[key].graphs) == 1


def test_stream_store_refuses_a_fleet_the_card_cannot_hold(cuda):
    """A CUDA store holds its top rung from construction: a derived ladder
    (top rung 128 x capacity) past the card's free memory is refused by
    name, and an explicit ladder that fits holds exactly its top rung."""
    from repro_torch.stream import FactorStore

    with pytest.raises(ValueError, match="ladder="):
        FactorStore(4096, capacity=64, device=cuda)   # ~550 GB
    st = FactorStore(256, capacity=2, ladder=(2, 4), device=cuda)
    assert st._base[0].shape == (4, 256, 256)


def test_stream_capture_holds_the_collector_off(cuda):
    """Python's cyclic collector is off during every capture and back on
    after: a dropped store's graphs freed by it inside a capture would
    reset there and invalidate the capture."""
    import gc

    from repro_torch.stream import FactorStore

    st = FactorStore(STREAM_N, capacity=2, ladder=(2, 4), width=4,
                     widths=(1, 4), panel=32, device=cuda)
    make, seen = st._make_step, []

    def make_step(name, cap, widths):
        step = make(name, cap, widths)
        parts = list(step.parts)

        def watched(part):
            def run(base):
                if torch.cuda.is_current_stream_capturing():
                    seen.append(gc.isenabled())
                part(base)
            return run

        step.parts = [watched(p) for p in parts]
        return step

    st._make_step = make_step
    assert gc.isenabled()
    st.warmup()
    assert len(seen) == st.steps.graphs > 0 and not any(seen)
    assert gc.isenabled()


# ---------------------------------------------------------------------------
# Gradients through the update and the optimizer on the card.
# ---------------------------------------------------------------------------


def grad_loss(x):
    return (x.float().sin() * (0.5 * x.float()).cos()).sum()


def kappa2(U):
    """kappa_2 of the float64 factor(s), the worst member."""
    s = torch.linalg.svdvals(U.double())
    return float((s[..., 0] / s[..., -1]).max())


def grads_of(fn, *xs):
    """The output and the gradients of ``grad_loss(fn(*xs))``."""
    xs = [x.detach().clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    leaves = list(out) if isinstance(out, tuple) else [out]
    gs = torch.autograd.grad(sum(grad_loss(o) for o in leaves), xs)
    return [o.detach() for o in leaves], gs


@pytest.mark.parametrize("sigma", [1, -1])
@pytest.mark.parametrize("method", ["fused", "pallas", "pallas_gemm"])
def test_dense_grad_on_cuda_matches_the_rule_on_cpu(cuda, method, sigma):
    """The rule around the kernels against the same rule around the plain
    versions on the CPU: fp32, a B = 2 fleet, n = 96, within the CPU tests'
    tol_for(fp32, n) kappa_2(L~) relative to the largest CPU gradient. The
    backward launches no kernel; the forward one a sign block (fused) or
    the cascade's launches."""
    n, k, panel = 96, 5, 32
    L, V = spd(2, n, k, torch.float32, sigma, cuda, seed=3)

    def fn(L, V):
        return chol_update_batched(L, V, sigma=sigma, method=method,
                                   panel=panel)

    before = F.LAUNCHES.count + sum(c.count for c in K.LAUNCHES.values())
    (out,), g_card = grads_of(fn, L, V)
    torch.cuda.synchronize()
    after = F.LAUNCHES.count + sum(c.count for c in K.LAUNCHES.values())
    want = F.launch_count(n, panel, method="fused" if method == "fused"
                          else "pallas_2phase", k=k)
    assert after - before == want
    (out_cpu,), g_cpu = grads_of(fn, L.cpu(), V.cpu())
    bound = 50 * torch.finfo(torch.float32).eps * n * kappa2(out_cpu)
    for a, b in zip(g_card, g_cpu):
        assert a.dtype == torch.float32
        err = float((a.cpu() - b).abs().max() / b.abs().max())
        assert err <= bound, (method, err, bound)


@pytest.mark.parametrize("sigma", [1, -1])
def test_structured_grad_on_cuda_matches_the_rule_on_cpu(cuda, sigma):
    """The blockwise rule around ``btd_chain`` against the plain chain on
    the CPU: a B = 2 fleet, b = 8, nb = 6, k = 3, fp32, same bound."""
    S, V = banded(2, 6, 8, 3, torch.float32, sigma, cuda, seed=5)

    def fn(D, O, V):
        out = chol_update_batched(BlockTriDiagStorage(D, O), V, sigma=sigma,
                                  method="blocktridiag")
        return out.diag, out.off

    before = BT.LAUNCHES.count
    _, g_card = grads_of(fn, S.diag, S.off, V)
    torch.cuda.synchronize()
    assert BT.LAUNCHES.count - before == 1
    outs, g_cpu = grads_of(fn, S.diag.cpu(), S.off.cpu(), V.cpu())
    dense = BlockTriDiagStorage(*outs).to(torch.float64).to_dense()
    bound = 50 * torch.finfo(torch.float32).eps * 48 * kappa2(dense)
    for a, b in zip(g_card, g_cpu):
        err = float((a.cpu() - b).abs().max() / b.abs().max())
        assert err <= bound, (err, bound)


def test_no_grad_fused_update_is_todays_call(cuda):
    """With no input requiring a gradient the call dispatches as before:
    no autograd node, one launch, ``torch.equal`` to the kernel route
    itself; with a gradient the forward's values are the same; 'mosaic'
    runs the same kernel, equal bit for bit, its launch labeled so."""
    from repro_torch.obs import metrics

    L, V = spd(1, 300, 16, torch.float32, 1, cuda, seed=4)
    L, V = L[0], V[0]
    before = F.LAUNCHES.count
    out = api.chol_update(L, V, method="fused")
    assert out.grad_fn is None and F.LAUNCHES.count == before + 1
    direct = F.chol_update_fused(L, V)
    assert torch.equal(out, direct)
    with_grad = api.chol_update(L, V.clone().requires_grad_(True),
                                method="fused")
    assert with_grad.grad_fn is not None
    assert torch.equal(with_grad.detach(), out)
    series = dict(module="fused", kernel="fused_chain", lowering="mosaic",
                  panel=256)
    m0 = metrics.value("repro.kernels.launches", **series)
    assert torch.equal(F.chol_update_fused(L, V, lowering="mosaic"), out)
    assert metrics.value("repro.kernels.launches", **series) == m0 + 1


def test_cholesky_precond_step_on_cuda_matches_cpu(cuda, monkeypatch):
    """Four ``cholesky_precond`` steps (d = 32, other = 48, k = 4, window 2,
    eps = 1) on the card (the fused kernel) against the same steps on the
    CPU (its plain version), one sketch draw for both: the bar
    tests/test_optim.py holds two backends to. Launches: one a step for
    the update, one for the downdate once the ring is full."""
    import importlib

    import repro_torch.optim as optim

    cp = importlib.import_module("repro_torch.optim.cholesky_precond")
    draw = cp.sketch
    monkeypatch.setattr(
        cp, "sketch",
        lambda *a, device, **kw: draw(*a, device="cpu", **kw).to(device))
    rng = np.random.default_rng(13)
    gs = [rng.normal(size=(32, 48)).astype(np.float32) for _ in range(4)]
    runs = {}
    for dev in (cuda, torch.device("cpu")):
        opt = optim.get_optimizer("cholesky_precond", 0.01, rank=4,
                                  block_size=32, window=2, eps=1.0,
                                  update_method="fused")
        params = {"w": torch.zeros((32, 48), device=dev)}
        state = opt.init(params)
        before = F.LAUNCHES.count
        deltas = []
        for g in gs:
            upd, state = opt.update({"w": torch.from_numpy(g).to(dev)},
                                    state, params)
            deltas.append(upd["w"].cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert F.LAUNCHES.count - before == 4 + 2
        runs[dev.type] = deltas, state["factors"]["w"]["c"].data.cpu()
    for a, b in zip(runs["cuda"][0], runs["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(runs["cuda"][1], runs["cpu"][1], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# The stream store's sharded placement and sharded gradients on the card.
# ---------------------------------------------------------------------------


def sharded_stream_store(mesh, dtype, **kw):
    """A warmed two-rung (2, 4) store, widths (1, 4), sharded over the
    one-rank mesh: its steps are captured graphs of the sharded driver."""
    from repro_torch.stream import FactorStore

    dt, acc = DTYPES[dtype]
    opts = dict(capacity=2, ladder=(2, 4), width=4, widths=(1, 4), panel=32,
                dtype=torch.float32 if acc else dt,
                precision="bf16" if acc else None, backend="sharded",
                mesh=mesh)
    opts.update(kw)
    st = FactorStore(STREAM_N, **opts)
    st.warmup()
    return st


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sharded_stream_replay_equals_the_eager_step(cuda, cuda_mesh, dtype):
    """A one-rank sharded store's replayed steps equal the eager calls on
    a copy of the fleet (``CholFactor.update``, ``downdate_guarded``,
    ``scale``), bit for bit, verdicts included; one graph a step (the
    guarded downdate too: its verdict is device ops)."""
    st = sharded_stream_store(cuda_mesh, dtype)
    assert st.step_mode == "graphs"
    assert st.steps.graphs == st.steps.executables
    meta = st._meta
    for u in "ab":
        st.admit(u)

    def eager():
        return CholFactor(distributed.gather(st.factor.data).clone(), **meta)

    def equal(ref):
        return torch.equal(distributed.gather(st.factor.data),
                           distributed.gather(ref.data))

    up = stream_rows(st, 4, seed=2)
    before = eager()
    assert st.apply(up, None) is None
    assert equal(before.update(torch.from_numpy(up).to(cuda))), "up"
    for both in (False, True):
        dn = stream_rows(st, 1 if both else 4, seed=3 + both, scale=0.05)
        dn[1] *= 100.0                     # member 1: infeasible
        vup = stream_rows(st, 4, seed=5) if both else None
        before = eager()
        ok = st.apply(vup, dn)
        if both:
            before = before.update(torch.from_numpy(vup).to(cuda))
        ref, ok_ref = before.downdate_guarded(torch.from_numpy(dn).to(cuda))
        assert ok.tolist() == ok_ref.tolist() == [True, False]
        assert equal(ref), "both" if both else "down"
    before = eager()
    st.decay(0.9)
    alpha = torch.tensor(st.row_dtype.type(0.9), device=cuda)
    assert equal(before.scale(alpha)), "scale"
    st.admit("c")
    st.admit("d")                           # promote 2 -> 4
    assert st.capacity == 4 and st.steps.cold_dispatches == 0


def test_sharded_guarded_step_verdicts_equal_downdate_guarded(cuda,
                                                               cuda_mesh):
    """The store's guarded step (a replayed graph) against
    ``CholFactor.downdate_guarded`` on the same sharded factor: the same
    verdicts (members 1 and 3 infeasible) and the same fleet, bit for
    bit."""
    st = sharded_stream_store(cuda_mesh, "fp32")
    for u in "abcd":
        st.admit(u)
    st.apply(stream_rows(st, 4, seed=7), None)
    dn = stream_rows(st, 4, seed=8, scale=0.05)
    dn[[1, 3]] *= 100.0
    f = CholFactor(st.factor.data.clone(), **st._meta)
    ref, ok_ref = f.downdate_guarded(torch.from_numpy(dn).to(cuda))
    ok = st.apply(None, dn)
    assert ok.tolist() == ok_ref.tolist() == [True, False, True, False]
    assert torch.equal(distributed.gather(st.factor.data),
                       distributed.gather(ref.data))


@pytest.mark.parametrize("sigma", [1, -1])
def test_sharded_grad_on_cuda_matches_the_rule_on_cpu(cuda, cuda_mesh,
                                                      sigma):
    """Gradients through ``method='sharded'`` on the card (the kernels in
    the forward, none in the backward) against the dense rule around the
    plain chain on the CPU: a B = 2 fleet, n = 96, k = 5, fp32, within
    tol_for(fp32, n) kappa_2(L~) relative to the largest CPU gradient; L
    given whole and as a ``DTensor`` (its gradient then a ``DTensor``)."""
    n, k, panel = 96, 5, 32
    L, V = spd(2, n, k, torch.float32, sigma, cuda, seed=4)
    counters = [SH.LAUNCHES, *K.LAUNCHES.values()]

    def run(L, V, method, **kw):
        L = L.detach().clone().requires_grad_(True)
        V = V.detach().clone().requires_grad_(True)
        out = chol_update_batched(L, V, sigma=sigma, method=method,
                                  panel=panel, **kw)
        loc = out.to_local() if distributed.is_sharded(out) else out
        before = sum(c.count for c in counters)
        gs = torch.autograd.grad(grad_loss(loc), [L, V])
        assert sum(c.count for c in counters) == before, "a backward launch"
        return loc.detach(), gs

    (out_cpu, g_cpu) = run(L.cpu(), V.cpu(), "fused")
    bound = 50 * torch.finfo(torch.float32).eps * n * kappa2(out_cpu)
    for L_in in (L, distributed.shard(L, cuda_mesh)):
        before = sum(c.count for c in counters)
        _, g_card = run(L_in, V, "sharded", mesh=cuda_mesh)
        torch.cuda.synchronize()
        want = SH.kernel_launches(n, panel, strategy="fused", k=k)
        assert sum(c.count for c in counters) - before == sum(want.values())
        assert distributed.is_sharded(g_card[0]) == distributed.is_sharded(
            L_in)
        for a, b in zip(g_card, g_cpu):
            a = distributed.gather(a)
            assert a.dtype == torch.float32
            err = float((a.cpu() - b).abs().max() / b.abs().max())
            assert err <= bound, (err, bound)


# -- the examples on the card ------------------------------------------------

def kernel_launches():
    """Every kernel's launch count so far, by kernel."""
    out = {"fused_chain": F.LAUNCHES.count, "btd_chain": BT.LAUNCHES.count,
           "panel_apply_sharded": SH.LAUNCHES.count}
    out.update({name: c.count for name, c in K.LAUNCHES.items()})
    return out


def launches_since(before):
    return {k: v - before[k] for k, v in kernel_launches().items()
            if v != before[k]}


def test_quickstart_runs_on_the_card(cuda):
    """``quickstart.run`` on the card against the same run on the CPU (the
    kernels' plain versions), within tol_for(fp32, n). As in the JAX
    package, methods 'gemm' and 'paper' are the blocked routes in plain
    operations (no kernel); 'pallas_gemm' at n = 512, panel 128 launches
    4 ``diag_block`` and 3 gemm applies, and the factor object's update,
    guarded downdate and downdate one fused chain each."""
    from repro_torch.examples import quickstart

    before = kernel_launches()
    card = quickstart.run(device="cuda")
    torch.cuda.synchronize()
    got = launches_since(before)
    print(f"quickstart launches on the card: {got}")
    cpu = quickstart.run(device="cpu")
    tol = 50 * torch.finfo(torch.float32).eps * 512
    for name in ("L_up", "L_up2", "L_back", "L_pal", "f_back"):
        err = float((card[name].cpu() - cpu[name]).abs().max())
        assert err <= tol, (name, err, tol)
    for name in ("x", "x2"):
        err = float((card[name].cpu() - cpu[name]).abs().max())
        assert err <= tol * float(cpu[name].abs().max()), (name, err)
    assert card["guard_ok"] is False
    assert abs(card["logdet"] - cpu["logdet"]) <= 5e-3 + tol * abs(
        cpu["logdet"])
    assert got == {"fused_chain": 3, "diag_block": 4,
                   "panel_apply_gemm": 3}, got


def test_online_ridge_runs_on_the_card(cuda):
    """``online_ridge``'s single stream and ``--batched`` fleet on the
    card: every row within the example's own bound of the exact windowed
    solve, the batched fleet in six mutations, both through the fused
    chain: the single stream one launch for each of its 12 updates and 8
    downdates."""
    from repro_torch.examples import online_ridge

    before = kernel_launches()
    rows = online_ridge.run_single(device="cuda")
    torch.cuda.synchronize()
    single = launches_since(before)
    before = kernel_launches()
    brows, muts = online_ridge.run_batched(device="cuda")
    torch.cuda.synchronize()
    batched = launches_since(before)
    print(f"online_ridge launches on the card: single {single}, batched "
          f"{batched}")
    assert len(rows) == 12 and all(e < 5e-3 for _, e, _ in rows)
    assert [r[0] for r in brows] == [1, 3, 5, 7] and muts == 6
    assert all(e < 5e-3 for _, e, _ in brows)
    assert single == {"fused_chain": 20}, single
    assert set(batched) == {"fused_chain"}, batched


def _ridge_rank(d):
    """One rank of ``online_ridge --sharded`` on the card: its rows,
    mutations and launches, into ``d``."""
    import json

    import torch.distributed as dist

    from repro_torch.examples import online_ridge

    torch.backends.cuda.matmul.allow_tf32 = False
    before = kernel_launches()
    rows, muts = online_ridge.run_batched(sharded=True, device="cuda")
    torch.cuda.synchronize()
    with open(f"{d}/rank{dist.get_rank()}.json", "w") as f:
        json.dump({"rows": rows, "muts": muts,
                   "launches": launches_since(before)}, f)


def test_online_ridge_sharded_on_four_ranks_sharing_the_card(cuda,
                                                             tmp_path):
    """``online_ridge --sharded``'s run on four gloo ranks sharing the card
    (``run_gloo_ranks``, as the example starts them): every rank's rows
    equal, within the example's bound of the exact solve and of the
    unsharded fleet's rows on the card; every rank launches the sharded
    driver's kernels alike, and no fused chain: per mutation (one sign
    block, k = 16) 64 / 16 ``diag_block`` and one ``panel_apply_sharded``
    (a step_mode 'eager' warmup launches nothing)."""
    import json

    from repro_torch.examples import online_ridge
    from repro_torch.kernels import _build
    from repro_torch.runtime.compat import run_gloo_ranks

    _build.build_all()  # once here, not in each rank
    run_gloo_ranks(4, _ridge_rank, (str(tmp_path),), timeout=300)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(4)]
    print("online_ridge --sharded launches on the card, by rank: "
          f"{[r['launches'] for r in ranks]}")
    want, muts = online_ridge.run_batched(device="cuda")
    true_w = np.random.default_rng(0).normal(size=(4, 64))
    scale = np.sqrt(64) / np.linalg.norm(true_w, axis=1).min()
    for r in ranks:
        assert r["rows"] == ranks[0]["rows"] and r["muts"] == muts == 6
        assert r["launches"] == ranks[0]["launches"]
        for (t, e, w), (tw, ew, ww) in zip(r["rows"], want):
            assert t == tw and e < 5e-3
            assert abs(w - ww) <= 1e-4 + scale * (e + ew), t
    got = ranks[0]["launches"]
    assert got == {"diag_block": 4 * muts, "panel_apply_sharded": muts}, got


def test_kalman_smoother_runs_on_the_card(cuda):
    """``kalman_smoother.run`` on the card (the block chain) against the
    same run on the CPU: each within the example's own bound of the dense
    posterior (the run asserts it), so their means within the sum of the
    two errors; the outlier's pull and the RMSE alike. One block-chain
    launch for each of the four chunk updates and the outlier's update
    and downdate."""
    from repro_torch.examples import kalman_smoother

    before = kernel_launches()
    card = kalman_smoother.run(device="cuda")
    torch.cuda.synchronize()
    got = launches_since(before)
    print(f"kalman_smoother launches on the card: {got}")
    cpu = kalman_smoother.run(device="cpu")
    assert float(np.abs(card["xs"] - cpu["xs"]).max()) <= (
        card["err"] + cpu["err"] + 1e-6)
    assert abs(card["rmse"] - cpu["rmse"]) <= 5e-4
    assert abs(card["pull"] - cpu["pull"]) <= 5e-3
    assert got == {"btd_chain": 6}, got


# -- the LM serving path and serve_lm on the card -----------------------------


def test_serve_cli_full_width_on_the_card(cuda, capsys):
    """``python -m repro_torch.launch.serve --arch h2o-danube-1.8b --full``
    (its ``main``) on the card: batch 8, prompt 32, 64 sampled tokens. The
    model code is plain torch: it launches no kernel of the repo."""
    from repro_torch.launch import serve

    before = kernel_launches()
    tps = serve.main(["--arch", "h2o-danube-1.8b", "--full"])
    torch.cuda.synchronize()
    got = launches_since(before)
    out = capsys.readouterr().out
    with capsys.disabled():
        print(f"serve --full on the card: {out.strip()}; launches {got}")
    assert tps > 0 and "generated (8, 96) tokens" in out
    assert got == {}, got


@contextlib.contextmanager
def _marking(marks):
    """Within: each ``FactorStore.warmup`` that returns appends the launch
    counts at that point to ``marks``."""
    from repro_torch.stream import FactorStore

    warmup = FactorStore.warmup

    def marked(store, **kw):
        out = warmup(store, **kw)
        marks.append(kernel_launches())
        return out

    with mock.patch.object(FactorStore, "warmup", marked):
        yield


@pytest.mark.parametrize("background", [False, True])
def test_serve_lm_runs_on_the_card(cuda, background, capsys):
    """``serve_lm`` (its ``main``, ``--stats``, and ``--background``) on
    the card: the example's own assertions hold, and its sidecar's served
    flushes launch one ``fused_chain`` a mutation (a sign block of width
    <= 8: ceil(8/32) = 1), nothing else. The background worker's
    mutations follow its wake-ups, so two runs may count differently."""
    from repro_torch.examples import serve_lm

    argv = ["--stats"] + (["--background"] if background else [])
    # the summary's counters are process-wide: drop what earlier tests in
    # this process counted, so "retraces=0" speaks of this run alone
    obs_metrics.REGISTRY.reset()
    before = kernel_launches()
    tps, err, muts, rows = serve_lm.main(argv)
    torch.cuda.synchronize()
    total = launches_since(before)
    out = capsys.readouterr().out
    marks = []
    toks, _ = serve_lm.tokens_for(device="cuda")
    with _marking(marks):
        err2, muts2, rows2 = serve_lm.personalize(
            toks[:, 32:], background=background, device="cuda")
    torch.cuda.synchronize()
    served = launches_since(marks[0])
    with capsys.disabled():
        print(f"serve_lm {' '.join(argv)} on the card: launches {total} "
              f"(warmup included); served {served} for {muts2} mutations")
    assert tps > 0 and err < 1e-2 and err2 < 1e-2
    assert muts < rows == rows2 == 512 and muts2 < rows2
    assert background or muts2 == muts
    assert "retraces=0" in out
    assert served == {"fused_chain": muts2}, served
    assert set(total) == {"fused_chain"}, total


def _serve_lm_rank(d):
    """One rank of ``serve_lm --sharded`` on the card: its results and its
    sidecar's launches after warmup, into ``d``."""
    import json

    import torch.distributed as dist

    from repro_torch.examples import serve_lm

    marks = []
    with _marking(marks):
        tps, err, muts, rows = serve_lm.run(sharded=True, device="cuda")
    torch.cuda.synchronize()
    with open(f"{d}/rank{dist.get_rank()}.json", "w") as f:
        json.dump({"err": err, "muts": muts, "rows": rows,
                   "launches": launches_since(marks[0])}, f)


def test_serve_lm_sharded_on_four_ranks_sharing_the_card(cuda, tmp_path,
                                                         capfd):
    """``serve_lm --sharded`` on four gloo ranks sharing the card: the ranks
    hold equal token streams (the example checks), every rank's sidecar
    gives the same mutations and rows, and each launches per mutation (one sign block, n = 32 over panels of 8) the
    sharded driver's 4 ``diag_block`` and 1 ``panel_apply_sharded``. The
    CLI exits cleanly; with ``--background`` every rank's service refuses
    the worker."""
    import json

    from repro_torch.examples import serve_lm
    from repro_torch.kernels import _build
    from repro_torch.runtime.compat import run_gloo_ranks

    _build.build_all()  # once here, not in each rank
    run_gloo_ranks(4, _serve_lm_rank, (str(tmp_path),), timeout=600)
    ranks = [json.loads((tmp_path / f"rank{r}.json").read_text())
             for r in range(4)]
    with capfd.disabled():
        print("serve_lm --sharded launches on the card, by rank: "
              f"{[r['launches'] for r in ranks]}, mutations "
              f"{[r['muts'] for r in ranks]}")
    per_block = SH.kernel_launches(32, 8, strategy="fused", k=8)
    assert per_block == {"diag_block": 4, "panel_apply_sharded": 1}
    for r in ranks:
        assert (r["muts"], r["rows"]) == (ranks[0]["muts"], 512)
        assert r["err"] < 1e-2 and r["muts"] < r["rows"]
        assert r["launches"] == {k: v * r["muts"]
                                 for k, v in per_block.items()}
    serve_lm.main(["--sharded"])
    capfd.readouterr()
    with pytest.raises(RuntimeError, match="gloo ranks exited"):
        serve_lm.main(["--sharded", "--background"])
    assert ("start_background() on a sharded store of 4 ranks"
            in capfd.readouterr().err)


# -- the training path and the encoder-decoder family on the card -------------


def test_train_lm_runs_on_the_card(cuda, tmp_path, capsys):
    """``examples/train_lm`` (reduced llama3.2-3b, ``cholesky_precond``,
    its 200 steps) on the card: the loss falls, and each step takes one
    ``fused_chain`` launch (``embed.tokens`` (512, 64) is the one eligible
    leaf; the ln scales (4, 64) fall under 2·rank). A second call resumes
    at step 200, trains nothing and launches nothing."""
    from repro_torch.examples import train_lm

    before = kernel_launches()
    losses = train_lm.main(["--ckpt-dir", str(tmp_path)])
    got = launches_since(before)
    with capsys.disabled():
        print(f"train_lm on the card: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}; launches {got}")
    assert len(losses) == 200 and losses[-1] < losses[0]
    assert got == {"fused_chain": 200}
    assert train_lm.main(["--ckpt-dir", str(tmp_path)]) == []
    assert launches_since(before) == got


def test_encdec_on_the_card_matches_the_cpu(cuda):
    """seamless-m4t-medium at reduced(): ``loss_fn`` and its gradients,
    ``encode`` / ``decode_train`` with the collected cache, and 4 decode
    steps from it, on the card against the CPU, within fp32
    tol_for(d_model * num_layers) * (1 + max |cpu|) (path 3l (c)'s rule)."""
    from repro_torch import interop
    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import _grads
    from repro_torch.models import decode_step, encdec as ED, init_model
    from repro_torch.optim.base import tree_leaves

    cfg = ARCHS["seamless-m4t-medium"].reduced()
    cpu = init_model(cfg, device="cpu", seed=3)
    card = interop.params_from_numpy(interop.params_to_numpy(cpu), cfg,
                                     device=cuda)
    rng = np.random.default_rng(3)
    batch = {"src_embeds": rng.normal(size=(2, 12, cfg.d_model)),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 8)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 8))}
    batch = {k: torch.from_numpy(v.astype(np.float32 if v.dtype.kind == "f"
                                          else np.int32))
             for k, v in batch.items()}
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2))
                           .astype(np.int32))
    tol = 50 * float(torch.finfo(torch.float32).eps) * (
        cfg.d_model * cfg.num_layers)

    def run(model, dev):
        b = {k: v.to(dev) for k, v in batch.items()}
        total, _, grads = _grads(cfg, model, b)
        out = [total] + tree_leaves(grads)
        with torch.no_grad():
            enc = ED.encode(model, cfg, b["src_embeds"])
            logits, (k, v, xk, xv) = ED.decode_train(
                model, cfg, enc, b["tokens"], collect_cache=True)
            out += [enc, logits, k, v, xk, xv]
            cache = ED.init_encdec_cache(cfg, 2, 12, 12, torch.float32,
                                         device=dev)
            cache["k"][:, :, :8], cache["v"][:, :, :8] = k, v
            cache["xk"], cache["xv"] = xk, xv
            cache["pos"] = cache["pos"] + 8
            for t in range(4):
                lg, cache = decode_step(model, cfg, cache, nxt[t].to(dev))
                # The step wrote its cache in place: keep this step's.
                out += [lg, cache["k"].clone(), cache["v"].clone()]
        return out

    worst = 0.0
    for ref, got in zip(run(cpu, "cpu"), run(card, cuda)):
        assert got.device.type == "cuda"
        err = float((got.cpu().float() - ref.float()).abs().max())
        worst = max(worst, err / (tol * (1 + float(ref.abs().max()))))
    assert worst <= 1.0, worst
