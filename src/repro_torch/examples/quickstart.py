"""Quickstart: the rank-k Cholesky up/down-date public API (PyTorch port).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cpu|cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import (CholFactor, backends, chol_downdate,
                              chol_solve, chol_update, modify_error)
from repro_torch.core.api import default_device
from repro_torch.core.factor import resolve_backend_for


def run(*, n: int = 512, k: int = 16, seed: int = 0, device=None) -> dict:
    """Every step of the quickstart; prints its lines and returns its
    values (tensors on ``device``, default CUDA)."""
    dev = default_device(device)
    out = {}
    # --- Build an SPD matrix and its upper Cholesky factor (A = L^T L). ---
    rng = np.random.default_rng(seed)
    B = rng.uniform(size=(n, n)).astype(np.float32)
    A = torch.from_numpy(B.T @ B + np.eye(n, dtype=np.float32)).to(dev)
    L = torch.linalg.cholesky(A).mT.contiguous()
    V = torch.from_numpy(rng.uniform(size=(n, k)).astype(np.float32)).to(dev)

    # --- Rank-k update: O(k n^2) instead of refactorizing in O(n^3). -----
    L_up = out["L_up"] = chol_update(L, V, method="gemm")  # panel GEMM
    err = modify_error(L_up, L, V, sigma=1)                # the error metric
    print(f"update:   max|A~ - L~^T L~| = {float(err):.3e}")

    # The same result via the paper-faithful element-wise panel path:
    L_up2 = out["L_up2"] = chol_update(L, V, method="paper")
    print(f"paths agree to {float(torch.max(torch.abs(L_up - L_up2))):.3e}")

    # --- Downdate: remove V V^T again and recover the original factor. ---
    L_back = out["L_back"] = chol_downdate(L_up, V, method="gemm")
    print(f"roundtrip: max|L - L_back| = "
          f"{float(torch.max(torch.abs(L - L_back))):.3e}")

    # --- Use the maintained factor: solve A~ x = b without refactorizing.
    b = torch.from_numpy(rng.uniform(size=(n,)).astype(np.float32)).to(dev)
    x = out["x"] = chol_solve(L_up, b)
    resid = torch.max(torch.abs((A + V @ V.T) @ x - b))
    print(f"solve:    max residual = {float(resid):.3e}")

    # --- The per-panel kernel path (the diagonal-block and GEMM-apply
    # kernels on the card, their plain versions on the CPU). -------------
    L_pal = out["L_pal"] = chol_update(L, V, method="pallas_gemm",
                                       panel=128)
    print(f"pallas:   max|gemm - pallas| = "
          f"{float(torch.max(torch.abs(L_up - L_pal))):.3e}")

    # --- The stateful engine: one CholFactor, every op on the same object.
    # Backends are a registry ('auto' resolves by device and size).
    print(f"registered backends: {backends.names()}")
    f = CholFactor.from_matrix(A, panel=128)   # backend='auto'
    print(f"{f!r} -> auto resolves to {resolve_backend_for(f)!r}")
    f = f.update(V)                            # A + V V^T, no refactorization
    x2 = out["x2"] = f.solve(b)                # same two triangular solves
    print(f"factor:   max|x - x_factor| = "
          f"{float(torch.max(torch.abs(x - x2))):.3e}")
    out["logdet"] = float(f.logdet())
    print(f"logdet:   {out['logdet']:.2f}")
    guarded, ok = f.downdate_guarded(100.0 * V)  # the PD guard refuses it
    out["guard_ok"] = bool(ok)
    print(f"guarded downdate of an infeasible V: ok={bool(ok)} "
          "(factor unchanged)")
    f = f.downdate(V)                          # back to the statistics
    out["f_back"] = f.data
    print(f"object roundtrip: max|L - f.data| = "
          f"{float(torch.max(torch.abs(L - f.data))):.3e}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default cuda)")
    args = ap.parse_args(argv)
    run(device=args.device)


if __name__ == "__main__":
    main()
