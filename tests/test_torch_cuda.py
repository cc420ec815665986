"""The port's CUDA fused-chain kernel on the card.

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

from repro_torch.core import CholFactor, blocked, chol_update_batched
from repro_torch.core import chol_update_dense
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
