"""Information-form Kalman smoother on a block-tridiagonal factor
(PyTorch port).

The joint posterior over a whole state trajectory x_0..x_{T-1} of a
linear-Gaussian state-space model has a block-tridiagonal precision
matrix: dynamics couple only adjacent states, measurements touch one
state each. The Cholesky factor is upper block-bidiagonal, so the
smoother runs in O(T·d²) memory where a dense factor needs O(T²·d²).

The demo maintains ONE structured ``CholFactor`` of the trajectory
precision:

* the motion prior (tridiagonal by construction) seeds the factor via
  ``CholFactor.from_blocktridiag``, the block-chain factorization, never a
  dense (n, n) Cholesky;
* each measurement y_t = H x_t + v adds Hᵀ R⁻¹ H to diagonal block t, a
  rank-m update whose V columns live inside block t (block-local).
  Measurements are coalesced into rank-k batches (k = chunk·m) so a chunk
  of timesteps is absorbed in ONE ``btd_chain`` launch on the card;
* an injected outlier is retracted afterwards with a hyperbolic
  ``downdate`` of just its own columns;
* the smoothed means are read back with ``.solve`` (two block
  substitutions), and the posterior log-determinant with ``.logdet``.

Everything is checked against a dense NumPy solve of the same posterior,
which is only affordable because the demo keeps T small.

Run:  PYTHONPATH=src python -m repro_torch.examples.kalman_smoother
      [--T 32] [--chunk 8] [--method auto|blocktridiag|blocktridiag_ref]
      [--seed 0] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import CholFactor
from repro_torch.core.api import default_device
from repro_torch.kernels import blocktridiag as btd_k

# 2D constant-velocity model: state (px, vx, py, vy), positions observed.
D = 4
M = 2
DT = 0.1


def model():
    f1 = np.array([[1.0, DT], [0.0, 1.0]], np.float32)
    F = np.kron(np.eye(2, dtype=np.float32), f1)          # (D, D)
    H = np.zeros((M, D), np.float32)
    H[0, 0] = H[1, 2] = 1.0                               # observe positions
    Q = 0.05 * np.eye(D, dtype=np.float32)                # process noise cov
    R = 0.25 * np.eye(M, dtype=np.float32)                # measurement cov
    P0 = 4.0 * np.eye(D, dtype=np.float32)                # initial state cov
    return F, H, Q, R, P0


def prior_precision_blocks(T, F, Q, P0):
    """Block-tridiagonal precision of the motion prior: interior diagonal
    blocks collect Q⁻¹ + Fᵀ Q⁻¹ F, the upper off-diagonal blocks are
    −Fᵀ Q⁻¹."""
    Qinv = np.linalg.inv(Q)
    Ad = np.zeros((T, D, D), np.float32)
    Ao = np.zeros((T - 1, D, D), np.float32)
    Ad[0] += np.linalg.inv(P0)
    for t in range(T - 1):
        Ad[t] += F.T @ Qinv @ F
        Ad[t + 1] += Qinv
        Ao[t] = -F.T @ Qinv
    return Ad, Ao


def measurement_columns(T, ts, H, R):
    """V with one block-local column group per measurement time:
    Hᵀ R⁻¹ H = V_t V_tᵀ with V_t = Hᵀ R^{-1/2}."""
    Rinv_half = np.linalg.cholesky(np.linalg.inv(R)).astype(np.float32)
    V = np.zeros((T * D, len(ts) * M), np.float32)
    for c, t in enumerate(ts):
        V[t * D:(t + 1) * D, c * M:(c + 1) * M] = H.T @ Rinv_half
    return V


def simulate(T, F, H, Q, R, P0, seed):
    rng = np.random.default_rng(seed)
    x = rng.multivariate_normal(np.zeros(D), P0).astype(np.float32)
    xs, ys = [], []
    for _ in range(T):
        xs.append(x)
        ys.append((H @ x + rng.multivariate_normal(
            np.zeros(M), R)).astype(np.float32))
        x = (F @ x + rng.multivariate_normal(
            np.zeros(D), Q)).astype(np.float32)
    return np.stack(xs), np.stack(ys), rng


def run(*, T=32, chunk=8, method="auto", seed=0, device=None) -> dict:
    """The smoother; prints its lines and returns its readings (the
    smoothed means ``xs``, their errors, the outlier's pull)."""
    dev = default_device(device)
    n = T * D

    def tt(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    F, H, Q, R, P0 = model()
    truth, ys, _ = simulate(T, F, H, Q, R, P0, seed)
    Ad, Ao = prior_precision_blocks(T, F, Q, P0)

    f = CholFactor.from_blocktridiag(tt(Ad), tt(Ao), backend=method)
    print(f"trajectory precision: {f!r}")
    sb = btd_k.factor_bytes(T, D, storage_dtype=torch.float32)
    print(f"factor storage {sb} B vs dense {n * n * 4} B "
          f"({n * n * 4 / sb:.1f}x, grows like T/{2 * D} with T)")

    # Absorb measurements chunk by chunk: each chunk is ONE rank-(chunk*M)
    # block-local update.
    eta = np.zeros(n, np.float32)
    Rinv = np.linalg.inv(R)
    for lo in range(0, T, chunk):
        ts = range(lo, min(lo + chunk, T))
        f = f.update(tt(measurement_columns(T, ts, H, R)))
        for t in ts:
            eta[t * D:(t + 1) * D] += H.T @ Rinv @ ys[t]

    # Inject a corrupted observation at mid-trajectory, then retract it
    # with a hyperbolic downdate of exactly its own columns.
    t_bad = T // 2
    y_bad = ys[t_bad] + np.array([25.0, -25.0], np.float32)
    Vbad = tt(measurement_columns(T, [t_bad], H, R))
    f_bad = f.update(Vbad)
    eta_bad = eta.copy()
    eta_bad[t_bad * D:(t_bad + 1) * D] += H.T @ Rinv @ y_bad
    xs_bad = f_bad.solve(tt(eta_bad)).cpu().numpy().reshape(T, D)
    assert bool(f_bad.downdate_feasible(Vbad))
    f = f_bad.downdate(Vbad)

    # Smoothed means: two block substitutions, never a dense matrix.
    xs = f.solve(tt(eta)).cpu().numpy().reshape(T, D)

    # Dense cross-check of the same posterior (affordable only because the
    # demo keeps T small; the structured path never forms this).
    J = np.zeros((n, n), np.float32)
    for t in range(T):
        J[t * D:(t + 1) * D, t * D:(t + 1) * D] = Ad[t]
    for t in range(T - 1):
        J[t * D:(t + 1) * D, (t + 1) * D:(t + 2) * D] = Ao[t]
        J[(t + 1) * D:(t + 2) * D, t * D:(t + 1) * D] = Ao[t].T
    Vall = measurement_columns(T, range(T), H, R)
    J += Vall @ Vall.T
    xs_exact = np.linalg.solve(J.astype(np.float64),
                               eta.astype(np.float64)).reshape(T, D)
    err = float(np.max(np.abs(xs - xs_exact)))
    sign, ld_exact = np.linalg.slogdet(J.astype(np.float64))
    ld_err = abs(float(f.logdet()) - ld_exact)
    rmse = float(np.sqrt(np.mean((xs[:, [0, 2]] - truth[:, [0, 2]]) ** 2)))
    raw = float(np.sqrt(np.mean((ys - truth[:, [0, 2]]) ** 2)))
    pull = float(np.max(np.abs(xs_bad[t_bad] - xs[t_bad])))
    print(f"T={T} states, {T * M} measurements absorbed in "
          f"{-(-T // chunk)} rank-{chunk * M} updates")
    print(f"smoothed mean vs dense solve: max |err| = {err:.2e}")
    print(f"logdet vs dense slogdet:      |err| = {ld_err:.2e} "
          f"(sign {sign:+.0f})")
    print(f"position RMSE: smoothed {rmse:.3f} vs raw measurements {raw:.3f}")
    print(f"outlier retracted by downdate (had pulled the mid-trajectory "
          f"state {pull:.2f} away)")
    assert err < 5e-3 and ld_err < 1e-2
    print("structured smoother matches the dense posterior it never formed.")
    return {"xs": xs, "xs_bad": xs_bad, "err": err, "ld_err": ld_err,
            "rmse": rmse, "raw": raw, "pull": pull,
            "logdet": float(f.logdet())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=32, help="trajectory length")
    ap.add_argument("--chunk", type=int, default=8,
                    help="measurement timesteps coalesced per update "
                         "(rank k = chunk*2)")
    ap.add_argument("--method", default="auto",
                    choices=("auto", "blocktridiag", "blocktridiag_ref"),
                    help="structured backend (auto: the block-chain kernel "
                         "on the card, its plain twin on the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default cuda)")
    args = ap.parse_args(argv)
    run(T=args.T, chunk=args.chunk, method=args.method, seed=args.seed,
        device=args.device)


if __name__ == "__main__":
    main()
