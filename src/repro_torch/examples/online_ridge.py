"""Streaming ridge regression with a sliding window (PyTorch port): the
classic consumer of Cholesky up/down-dating (Seeger 2004, cited by the
paper).

Maintains the factor of A_t = lambda*I + sum_{s in window} x_s x_s^T and
the solution w_t = A_t^{-1} X^T y over a sliding window of observations as
ONE stateful ``CholFactor``: each step ``.update``s with the newest batch
of rows and ``.downdate``s the batch falling out of the window, never
refactorizing, and reads the solution back with ``.solve``. Compares
against the exact windowed solve.

Two modes (plus a placement flag):

* single: one stream, the paper's original workload (``backend='auto'``:
  the fused-chain kernel on the card, the plain recurrence on the CPU).
* --batched: a fleet of independent per-user streams served through
  ``repro_torch.stream``: per-user rank-1 observations are pushed into a
  ``StreamService``, coalesced in ring buffers to the paper's k = 16 and
  absorbed as fused batched rank-k flushes over one fleet, with the
  sliding window handled as deferred, coalesced downdates.
* --sharded: the batched fleet with every member column-sharded over a
  4-rank mesh: four gloo ranks started on this host
  (``runtime.compat.run_gloo_ranks``; sharing the card, or on the CPU with
  ``--device cpu``), each running the same service, one ``diag_block``
  launch per panel and one ``panel_apply_sharded`` launch per shard per
  sign block, whatever the fleet size. Rank 0 prints.

Run:  PYTHONPATH=src python -m repro_torch.examples.online_ridge
      [--batched|--sharded] [--users B] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import collections

import numpy as np
import torch

from repro_torch.core import CholFactor
from repro_torch.core.api import default_device
from repro_torch.stream import FactorStore, StreamService, mutations_issued

SHARDS = 4


def run_single(*, d=64, batch=8, window_batches=4, steps=12, lam=1e-1,
               seed=0, device=None):
    """One sliding-window stream; prints a row per step and returns the
    rows ``(step, err_vs_exact, w_err)``."""
    dev = default_device(device)
    rng = np.random.default_rng(seed)
    true_w = rng.normal(size=(d,)).astype(np.float32)
    f = CholFactor.identity(d, scale=lam, device=dev)
    xty = torch.zeros(d, device=dev)
    window = collections.deque()
    out = []

    print(f"{'step':>4} {'err_vs_exact':>14} {'w_err':>10}")
    for t in range(steps):
        X = rng.normal(size=(batch, d)).astype(np.float32)
        y = X @ true_w + 0.1 * rng.normal(size=(batch,)).astype(np.float32)
        Xt, yt = torch.from_numpy(X).to(dev), torch.from_numpy(y).to(dev)

        # Rank-`batch` update with the new rows.
        f = f.update(Xt.T)
        xty = xty + Xt.T @ yt
        window.append((X, y, Xt, yt))

        # Slide: downdate the expiring batch (the paper's downdate).
        if len(window) > window_batches:
            _, _, Xold, yold = window.popleft()
            f = f.downdate(Xold.T)
            xty = xty - Xold.T @ yold

        w = f.solve(xty).cpu().numpy()

        # Exact windowed solution for comparison.
        Xw = np.concatenate([x for x, _, _, _ in window])
        yw = np.concatenate([yv for _, yv, _, _ in window])
        A_exact = lam * np.eye(d) + Xw.T @ Xw
        w_exact = np.linalg.solve(A_exact, Xw.T @ yw)
        err = float(np.max(np.abs(w - w_exact)))
        werr = float(np.linalg.norm(w - true_w) / np.linalg.norm(true_w))
        print(f"{t:4d} {err:14.3e} {werr:10.4f}")
        out.append((t, err, werr))

    print("maintained factor tracks the exact sliding-window solution.")
    return out


def run_batched(*, users=4, d=64, batch=8, window_batches=4, steps=8,
                lam=1e-1, panel=32, width=16, seed=0, sharded=False,
                device=None):
    """A fleet of independent sliding-window ridge streams, one per user,
    served through ``repro_torch.stream``.

    Each step produces ``batch`` rank-1 rows per user; the service buffers
    them and flushes every ``width // batch`` steps as ONE fused batched
    rank-k update for the whole fleet (plus, when the window slides, one
    guarded batched downdate).

    With ``sharded=True`` every member of the fleet is column-sharded over
    a mesh of every rank of the process group that runs this on every
    rank (``--sharded`` starts one of ``SHARDS`` ranks), and the flushes
    dispatch through the column-sharded driver: same service, same
    coalescer.

    Returns ``(rows, mutations)``: the printed rows ``(step,
    max_err_vs_exact, mean_w_err)`` and the batched mutations issued.
    """
    rng = np.random.default_rng(seed)
    true_w = rng.normal(size=(users, d)).astype(np.float32)
    if sharded:
        import torch.distributed as dist

        from repro_torch.runtime.compat import make_mesh_compat

        dev = default_device(device)
        shards = dist.get_world_size()
        mesh = make_mesh_compat((shards,), ("model",), device_type=dev.type)
        store = FactorStore(d, capacity=users, width=width,
                            panel=min(panel, d // shards),
                            backend="sharded", mesh=mesh, axis="model",
                            init_scale=lam)
    else:
        store = FactorStore(d, capacity=users, width=width, panel=panel,
                            backend="fused", init_scale=lam, device=device)
    dev = store.device
    svc = StreamService(store, window=window_batches, auto_flush=False)
    # Build the serving rung's steps first (CUDA graphs where the store's
    # step_mode allows): the loop below builds nothing.
    rep = store.warmup(rungs=(store.capacity,))
    print(f"warmup: {rep.compiled} steps built ({rep.graphs} CUDA graphs) "
          f"in {rep.seconds:.1f}s ({rep.cached} already built, step_mode "
          f"{store.step_mode!r})")
    for u in range(users):
        svc.admit(u)

    # Host bookkeeping mirroring the flush reports: rows not yet absorbed,
    # and rows currently inside each user's factor.
    pending = [collections.deque() for _ in range(users)]
    active = [collections.deque() for _ in range(users)]
    xty = np.zeros((users, d), np.float32)

    def absorb(report):
        if report is None or report.empty:
            return
        assert all(report.downdate_ok.values())
        for u, k in report.absorbed.items():
            for _ in range(k):
                x, yv = pending[u].popleft()
                active[u].append((x, yv))
                xty[u] += x * yv
        for u, k in report.downdated.items():
            for _ in range(k):
                x, yv = active[u].popleft()
                xty[u] -= x * yv

    cadence = max(width // batch, 1)
    muts0 = mutations_issued()
    out = []
    print(f"fleet of {users} users, d={d}, {batch} rank-1 rows/user/step, "
          f"coalesce width {width} ({store.factor!r})")
    print(f"{'step':>4} {'max_err_vs_exact':>18} {'mean_w_err':>12}")
    for t in range(steps):
        absorb(svc.tick())                      # window expiry downdates
        X = rng.normal(size=(users, batch, d)).astype(np.float32)
        y = np.einsum("ubd,ud->ub", X, true_w) + 0.1 * rng.normal(
            size=(users, batch)).astype(np.float32)
        for u in range(users):
            for j in range(batch):
                svc.push(u, X[u, j])
                pending[u].append((X[u, j].copy(), float(y[u, j])))
        if (t + 1) % cadence == 0:
            absorb(svc.flush())

            # A sharded fleet is gathered whole for the solve (every rank).
            w = store.factor.solve(torch.from_numpy(xty).to(dev))
            w = w.cpu().numpy()
            errs, werrs = [], []
            for u in range(users):
                Xw = np.stack([x for x, _ in active[u]])
                yw = np.asarray([yv for _, yv in active[u]])
                A_exact = lam * np.eye(d) + Xw.T @ Xw
                w_exact = np.linalg.solve(A_exact, Xw.T @ yw)
                errs.append(float(np.max(np.abs(w[u] - w_exact))))
                werrs.append(float(np.linalg.norm(w[u] - true_w[u])
                                   / np.linalg.norm(true_w[u])))
            print(f"{t:4d} {max(errs):18.3e} {np.mean(werrs):12.4f}")
            out.append((t, max(errs), float(np.mean(werrs))))

    muts = mutations_issued() - muts0
    rows = users * batch * steps
    print(f"{rows} rank-1 rows absorbed in {muts} batched mutations "
          f"({rows / max(muts, 1):.1f} rows/mutation); every user's "
          f"maintained factor tracks its exact windowed solution.")
    return out, muts


def _sharded_rank(users, device):
    """One rank of ``--sharded`` (``run_gloo_ranks`` starts four)."""
    from repro_torch import obs

    run_batched(users=users, sharded=True, device=device)
    print(obs.summary_line())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batched", action="store_true",
                    help="run the fleet-of-users batched mode")
    ap.add_argument("--sharded", action="store_true",
                    help="batched fleet with column-sharded members over "
                         f"{SHARDS} gloo ranks started on this host")
    ap.add_argument("--users", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default cuda)")
    args = ap.parse_args(argv)
    if args.sharded:
        from repro_torch.runtime.compat import run_gloo_ranks

        device = default_device(args.device).type
        run_gloo_ranks(SHARDS, _sharded_rank, (args.users, device))
        return
    if args.batched:
        run_batched(users=args.users, device=args.device)
    else:
        run_single(device=args.device)

    from repro_torch import obs

    print(obs.summary_line())


if __name__ == "__main__":
    main()
