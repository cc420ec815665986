#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Drives every path the port runs on the card, through the entry points a
user calls, and holds every kernel against its plain torch version:

* the dense main path — ``CholFactor.update``/``downdate`` through
  ``core.api`` and ``core.backends`` to the fused-chain kernel — at the
  paper's size (n = 5000, k = 16, fp32), and a B = 64 fleet through
  ``chol_update_batched`` in fp32 and bf16;
* the paper's per-panel cascade (``method='pallas'`` / ``'pallas_gemm'``:
  a diagonal-block kernel and a panel-apply kernel per panel) at n = 5000
  and on a B = 64 fleet;
* the block-tridiagonal path (``CholFactor.from_blocktridiag`` and the
  block-chain kernel): a Kalman smoother over 8192 timesteps, a wide-block
  factor and a B = 64 structured fleet;
* the column-sharded driver (``CholFactor(..., backend='sharded',
  mesh=)``: a chain phase of diagonal-block kernels, then one panel-phase
  kernel per shard) on one rank at n = 5120 and on a B = 64 fleet, and on
  four ranks sharing the card (spawned processes, gloo), whose gathered
  results are held against the one-rank results.

Builds every kernel from the sources in ``src/repro_torch/kernels/csrc``,
checks the launches each path takes (counts set to 0 just before a path
and read just after), checks the results against float64 references, times
the kernels, and prints one JSON line per kernel. Any failure exits
non-zero; without a CUDA device, or without the repository's ``src/``
beside this script, it exits non-zero and prints no result.

Usage: python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from datetime import timedelta

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}
BF16_EPS = 2.0 ** -8

# The Kalman smoother of examples/kalman_smoother.py: a 2-D
# constant-velocity model, state (px, vx, py, vy), positions observed.
KF_D, KF_M, KF_DT = 4, 2, 0.1


#: Checks that failed: every phase runs to its end, and the script fails
#: after the last one if any did.
FAILED = []


def check(ok, what):
    if not ok:
        print(f"FAIL: {what}")
        FAILED.append(what)


def tol_for(torch, dtype, n):
    """The repo's roundoff budget of a long hyperbolic recurrence."""
    return float(50 * torch.finfo(dtype).eps * n)


def unit_roundoff(torch, dtype):
    return float(torch.finfo(dtype).eps) / 2


def units(torch, out, ref, unit):
    """max_ij |out - ref|_ij / (unit (|ref|_ij + mean|ref|)): each entry
    held to its own size, with a floor of a typical entry for those formed
    by cancellation; a 1 % error in an entry of typical size reads 1e-2 /
    unit. ``entry_err`` is this on upper factors."""
    out, ref = out.double(), ref.double()
    floor = ref.abs().mean(dim=(-2, -1), keepdim=True)
    return float(((out - ref).abs() / (unit * (ref.abs() + floor))).max())


def entry_err(torch, out, ref, unit):
    """Largest entrywise error of the upper factor(s) ``out`` against
    ``ref``, in units of ``unit`` times the entry's own magnitude plus the
    mean magnitude of the factor's upper triangle:
    max_ij |out - ref|_ij / (unit (|ref|_ij + mean|ref|)).

    The floor covers entries formed by cancellation, whose error follows
    their column's scale rather than their own; a wrong value in any entry
    of typical size still counts in full (a 1 % error is 1e-2 / unit).
    """
    out, ref = torch.triu(out.double()), torch.triu(ref.double())
    n = ref.shape[-1]
    floor = ref.abs().sum(dim=(-2, -1), keepdim=True) / (n * (n + 1) / 2)
    return float(((out - ref).abs() / (unit * (ref.abs() + floor))).max())


def entry_limit(torch, dtype, n):
    """Limit on ``entry_err``/``units`` for a kernel against its plain
    version, and for a bf16 result against the float64 reference of its
    (rounded) inputs. fp32/f64: 4 n, with n the length of the chain of
    roundings an entry goes through: the factor's order for a factor, a
    block's or panel's rows P for a tile and for a diagonal block's
    rotation state (c, s, T), as the rounding of a downdate grows with n,
    while a 1 % error in an entry of typical size is 8.4e4 fp32 units.
    bf16: 4, as its arithmetic is
    fp32 and only a stored rounding (2 units) may flip. The values this
    script measures against these limits are in PERF.md."""
    return 4.0 if dtype == torch.bfloat16 else 4.0 * n


def timed(torch, fn, reps, warmup):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def host_timed(torch, fn, reps):
    """Host clock per call of ``fn`` ending in a synchronise (ms)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps, out


def _walk_plain(inputs):
    """Worker of ``plain_walks_in_background``: the plain block chain on the
    CPU, numpy in and out."""
    import torch
    from repro_torch.kernels import blocktridiag as BT

    torch.set_num_threads(1)
    out = {}
    for name, arrays in inputs.items():
        d, o, v = (torch.from_numpy(x) for x in arrays)
        out[name] = tuple(x.numpy() for x in BT.btd_chain_plain(d, o, v,
                                                               sigma=1))
    return out


def plain_walks_in_background(torch, cases):
    """Walk ``btd_chain_plain`` (sigma +1) on CPU copies of each case's
    ``(diag, off, vt)`` in a worker process of its own, so that its minutes
    of host time run beside this process's work. Returns a function that
    waits for the walks, stops the worker and gives {name: (diag, off)}."""
    import multiprocessing

    inputs = {name: tuple(x.cpu().numpy() for x in xs)
              for name, xs in cases.items()}
    pool = multiprocessing.get_context("spawn").Pool(1)
    result = pool.apply_async(_walk_plain, (inputs,))

    def join():
        try:
            out = result.get()
        finally:
            pool.terminate()
            pool.join()
        return {name: tuple(torch.from_numpy(x) for x in xs)
                for name, xs in out.items()}

    return join


#: The four-rank cases of the sharded path: name, strategy, fleet, precision.
SHARDED_CASES = (("fused", "fused", False, None),
                 ("gemm", "gemm", False, None),
                 ("paper", "paper", False, None),
                 ("fleet fp32", "fused", True, None),
                 ("fleet bf16", "fused", True, "bf16"))


def _rank_kernel_checks(torch, inp, mesh, P=256):
    """The kernels of the four-rank path against their plain versions on
    this rank's own shard, at that path's shapes (launches not counted):
    ``panel_apply_sharded`` on the rank's chain stacks of the n = 5120
    factor (1280 columns, tile_off 5 · rank) and of the B = 64 fleet (256
    columns, tile_off rank) in fp32 and bf16, its copied tiles (the
    diagonal and those left of it) exactly; ``diag_block`` on the gathered
    block of panel 0 and the gemm and paper applies of that panel on the
    rank's 1280-column strip. Collective: every rank calls it. Returns
    [(what, error in units, limit, ok)]."""
    from repro_torch.core import distributed
    from repro_torch.kernels import cholupdate as K
    from repro_torch.kernels import sharded as SH

    parts, me = mesh.size(0), distributed.shard_index(mesh, "model")
    out = []

    def note(what, err, lim, ok=True):
        out.append((what, err, lim, bool(ok and err <= lim)))

    for name, L, V, dt in (("n=5120 fp32", inp["L"], inp["V"], torch.float32),
                           ("fleet fp32", inp["Lf"], inp["Vf"], torch.float32),
                           ("fleet bf16", inp["Lf"], inp["Vf"],
                            torch.bfloat16)):
        w = L.shape[-1] // parts
        L_loc = L[..., me * w:(me + 1) * w].to(dt).contiguous()
        vt = V.to(dt).mT[..., me * w:(me + 1) * w].contiguous()
        acc = torch.float32 if dt == torch.bfloat16 else None
        T, D, vts = distributed._chain_phase(
            L_loc, vt, sigma=1, panel=P, w_loc=w, me=me, mesh=mesh, dims=[0],
            acc=torch.float32)
        off = me * (w // P)
        o_k = SH.panel_apply_sharded_cuda(L_loc, T, D, vts, tile_off=off,
                                          panel=P, accum_dtype=acc)
        o_p = SH.panel_apply_sharded_plain(L_loc, T, D, vts, tile_off=off,
                                           panel=P, accum_dtype=acc)
        rows = torch.arange(L.shape[-1], device=L_loc.device)[:, None] // P
        cols = torch.arange(w, device=L_loc.device)[None, :] // P
        copied = rows >= off + cols  # diagonal tile and the zeros left of it
        exact = torch.equal(torch.where(copied, o_k, 0),
                            torch.where(copied, o_p, 0))
        note(f"panel_apply_sharded {name} tile_off {off}",
             units(torch, o_k, o_p, unit_roundoff(torch, dt)),
             entry_limit(torch, dt, P),
             exact and bool(torch.isfinite(o_k).all()))
        if name != "n=5120 fp32":  # the single factor's strip only
            continue
        u32 = unit_roundoff(torch, torch.float32)
        blk = distributed._gather_diag(L_loc, vt, 0, panel=P, w_loc=w, me=me,
                                       mesh=mesh, dims=[0])
        D0, vd0 = blk[:P], blk[P:].contiguous()
        got = K.diag_block(D0, vd0, sigma=1)
        ref = K._diag_block_plain(D0, vd0, 1, None)
        note("diag_block panel 0: D", entry_err(torch, got[0], ref[0], u32),
             entry_limit(torch, torch.float32, P))
        for part, x, y in zip(("c", "s", "T"), got[1:], ref[1:]):
            note(f"diag_block panel 0: {part}", units(torch, x, y, u32),
                 entry_limit(torch, torch.float32, P))
        _, c, s, T0 = got
        R, vr = L_loc[:P], vt
        for what, x, y in (
                ("gemm", K.panel_apply_gemm(R, vr, T0),
                 K._gemm_plain(R, vr, T0, None)),
                ("paper", K.panel_apply_paper(R, vr, c, s, sigma=1),
                 K._paper_plain(R, vr, c, s, 1, None))):
            note(f"panel_apply_{what} panel 0, {w}-column strip",
                 max(units(torch, a, b, u32) for a, b in zip(x, y)),
                 entry_limit(torch, torch.float32, P),
                 all(bool(torch.isfinite(a).all()) for a in x))
    torch.cuda.synchronize()
    return out


def _sharded_rank(rank, d):
    """One of four ranks sharing the card (gloo, a ``file://`` store in
    ``d``): the sharded driver through the entry points on the inputs in
    ``d``, then its kernels against their plain versions on the rank's own
    shard (``_rank_kernel_checks``). Rank 0 saves the gathered results;
    every rank saves the kernel launches each case took on it and its
    kernel checks. Any error ends the process non-zero."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import api, distributed
    from repro_torch.kernels import cholupdate as K
    from repro_torch.kernels import sharded as SH

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{d}/store4",
                            world_size=4, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cuda", (4,), mesh_dim_names=("model",))
        inp = torch.load(f"{d}/inputs.pt", map_location="cuda:0")
        counters = {"panel_apply_sharded": SH.LAUNCHES}
        counters.update(K.LAUNCHES)
        out, counts = {}, {}
        for name, strategy, fleet, prec in SHARDED_CASES:
            before = {c: x.count for c, x in counters.items()}
            if fleet:
                r = api.chol_update_batched(
                    inp["Lf"], inp["Vf"], method="sharded", mesh=mesh,
                    panel=256, strategy=strategy, precision=prec)
            else:
                r = api.chol_update(inp["L"], inp["V"], method="sharded",
                                    mesh=mesh, panel=256, strategy=strategy)
            torch.cuda.synchronize()
            counts[name] = {c: x.count - before[c]
                            for c, x in counters.items()
                            if x.count != before[c]}
            full = distributed.gather(r)
            if rank == 0:
                out[name] = full.cpu()
            del r, full
        checks = _rank_kernel_checks(torch, inp, mesh)
        if rank == 0:
            torch.save(out, f"{d}/results.pt")
        with open(f"{d}/counts{rank}.json", "w") as f:
            json.dump({"counts": counts, "checks": checks}, f)
    finally:
        dist.destroy_process_group()


def run_four_ranks(torch, inputs, timeout):
    """Spawn four ranks on the card (``_sharded_rank``), wait for them and
    stop them. Returns (exit codes, rank 0's gathered results, each rank's
    launch counts, each rank's kernel checks); all but the codes are None
    unless all four exited 0."""
    import multiprocessing

    d = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        torch.save({name: x.cpu() for name, x in inputs.items()},
                   f"{d}/inputs.pt")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_sharded_rank, args=(r, d))
                 for r in range(4)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        codes = []
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
            codes.append(p.exitcode)
        if codes != [0] * 4:
            return codes, None, None, None
        saved = []
        for r in range(4):
            with open(f"{d}/counts{r}.json") as f:
                saved.append(json.load(f))
        return (codes, torch.load(f"{d}/results.pt"),
                [x["counts"] for x in saved], [x["checks"] for x in saved])
    finally:
        shutil.rmtree(d, ignore_errors=True)


def bound(nbytes, ops, dtype_name):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    operations over the peak rate of their type."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[dtype_name] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def kf_model(np):
    """examples/kalman_smoother.py ``model``: F, H, Q, R, P0."""
    f1 = np.array([[1.0, KF_DT], [0.0, 1.0]])
    F = np.kron(np.eye(2), f1)
    H = np.zeros((KF_M, KF_D))
    H[0, 0] = H[1, 2] = 1.0
    return F, H, 0.05 * np.eye(KF_D), 0.25 * np.eye(KF_M), 4.0 * np.eye(KF_D)


def kf_prior_blocks(np, T, F, Q, P0):
    """Block-tridiagonal precision of the motion prior (float64): interior
    diagonal blocks Q^-1 + F^T Q^-1 F, upper off-diagonal blocks -F^T Q^-1."""
    Qinv = np.linalg.inv(Q)
    Ad = np.zeros((T, KF_D, KF_D))
    Ad[0] += np.linalg.inv(P0)
    Ad[:-1] += F.T @ Qinv @ F
    Ad[1:] += Qinv
    Ao = np.broadcast_to(-F.T @ Qinv, (T - 1, KF_D, KF_D)).copy()
    return Ad, Ao


def kf_simulate(np, T, F, H, Q, R, P0, seed):
    """Trajectory and measurements, as the example draws them."""
    rng = np.random.default_rng(seed)
    x = rng.multivariate_normal(np.zeros(KF_D), P0)
    w = rng.multivariate_normal(np.zeros(KF_D), Q, size=T)
    v = rng.multivariate_normal(np.zeros(KF_M), R, size=T)
    xs = np.empty((T, KF_D))
    for t in range(T):
        xs[t] = x
        x = F @ x + w[t]
    return xs, xs @ H.T + v


def banded_ab(np, Jd, Jo):
    """Upper banded storage (scipy ``solveh_banded``) of the symmetric
    block-tridiagonal matrix with diagonal blocks Jd, upper blocks Jo."""
    nb, b, _ = Jd.shape
    n, u = nb * b, 2 * b - 1
    ab = np.zeros((u + 1, n))
    r, c = np.triu_indices(b)
    t = np.arange(nb)[:, None]
    i, j = t * b + r, t * b + c
    ab[u + i - j, j] = Jd[:, r, c]
    rr, cc = (x.reshape(-1) for x in np.indices((b, b)))
    t = np.arange(nb - 1)[:, None]
    i, j = t * b + rr, (t + 1) * b + cc
    ab[u + i - j, j] = Jo[:, rr, cc]
    return ab


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    import scipy.linalg

    from repro_torch.core import (BlockTriDiagStorage, CholFactor, blocked,
                                  chol_update_batched, chol_update_dense,
                                  modify_error)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed
    from repro_torch.kernels import _build
    from repro_torch.kernels import blocktridiag as BT
    from repro_torch.kernels import cholupdate as K
    from repro_torch.kernels import fused as F
    from repro_torch.kernels import sharded as SH

    # fp32 matmuls (the plain versions' GEMMs, problem set-up) in full
    # fp32: TF32's ~1e-3 would break the fp32 error budget.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_start = time.perf_counter()

    counters = {"fused_chain": F.LAUNCHES, "btd_chain": BT.LAUNCHES,
                "panel_apply_sharded": SH.LAUNCHES}
    counters.update(K.LAUNCHES)

    def reset_counts():
        for c in counters.values():
            c.reset()

    def read_counts():
        return {name: c.count for name, c in counters.items()}

    main_launches = {name: 0 for name in counters}

    def add_path(got):
        for name, v in got.items():
            main_launches[name] += v

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(args.seed)

    def spd_factor(B, n, k, dtype, sigma):
        """make_problem's procedure (B, V ~ U[0,1], A = B^T B + I) on the
        card in f64; for a downdate the start is the factor of A + V V^T,
        so A' - V V^T = A stays PD. bf16 adds n I: the rounding of the
        stored factor must not push the downdated matrix out of the PD
        cone."""
        Bm = torch.from_numpy(rng.uniform(size=(B, n, n))).to(dev)
        V = torch.from_numpy(rng.uniform(size=(B, n, k))).to(dev)
        shift = 1.0 + (n if dtype == torch.bfloat16 else 0)
        A = Bm.mT @ Bm + shift * torch.eye(n, dtype=torch.float64,
                                           device=dev)
        if sigma < 0:
            A = A + V @ V.mT
        L = torch.linalg.cholesky(A).mT.contiguous()
        return L.to(dtype), V.to(dtype)

    def banded(B, nb, b, k):
        """tests/strategies.py make_banded_problem's procedure on the card
        (float64), as a fleet of B: a diagonally dominant upper
        block-bidiagonal factor and V with every column supported inside
        one adjacent block pair. Above b = 8 (the sizes that procedure was
        made for) the strictly upper part of a diagonal block shrinks by
        8 / b: at full size it grows the block's condition number like
        ~1.23^b (1e23 at b = 256), and a downdate of such a factor is
        meaningless in any precision."""
        U0d = torch.from_numpy(
            rng.uniform(0.2, 1.0, size=(B, nb, b, b))).to(dev)
        eye = torch.eye(b, dtype=torch.float64, device=dev)
        U0d = torch.triu(U0d, 1) * min(1.0, 8.0 / b) + U0d * eye + 2.0 * eye
        U0o = 0.3 * torch.from_numpy(
            rng.uniform(-1.0, 1.0, size=(B, nb - 1, b, b))).to(dev)
        anchor = rng.integers(nb, size=(B, k))
        V = np.zeros((B, nb * b, k))
        vals = 0.4 * rng.normal(size=(B, 2 * b, k))
        for m, c in itertools.product(range(B), range(k)):
            j = anchor[m, c]
            width = b if j == nb - 1 else 2 * b
            V[m, j * b:j * b + width, c] = vals[m, :width, c]
        return (BlockTriDiagStorage(U0d, U0o),
                torch.from_numpy(V).to(dev))

    def vvt_blocks(V, b):
        """(diagonal, upper) blocks of V V^T in block form (f64)."""
        Vb = V.double().reshape(V.shape[:-2] + (V.shape[-2] // b, b,
                                                V.shape[-1]))
        return Vb @ Vb.mT, Vb[..., :-1, :, :] @ Vb[..., 1:, :, :].mT

    def block_modify_error(S_new, Ad, Ao):
        """Relative modify_error in block form: max |U^T U - A| over max
        |A|, per fleet member, O(n b), no dense factor formed."""
        ad, ao = S_new.astype(torch.float64).matrix_blocks()
        num = torch.maximum((ad - Ad).abs().amax(dim=(-3, -2, -1)),
                            (ao - Ao).abs().amax(dim=(-3, -2, -1)))
        den = torch.maximum(Ad.abs().amax(dim=(-3, -2, -1)),
                            Ao.abs().amax(dim=(-3, -2, -1)))
        return float((num / den).max())

    dtypes = [(torch.float32, None), (torch.bfloat16, torch.float32),
              (torch.float64, None)]

    # -- 2. kernel vs plain, small cases --------------------------------------
    # 2a. the fused chain, as in slice 1, plus the repaired k > 32 and
    # panel > 256 routes (column groups, the panel's divisor <= 256).
    cases = [(1, n, P, k, s, pa, dt)
             for n, P, k, s, pa, dt in itertools.product(
                 (100, 256), (32, 64), (1, 16), (1, -1), ("gemm", "paper"),
                 dtypes)]
    # The fleet cases take k = 32, the kernel's widest rotation bucket.
    cases += [(3, 100, 32, 32, s, pa, dt) for s, pa, dt in itertools.product(
        (1, -1), ("gemm", "paper"), dtypes)]
    cases += [(1, n, P, k, s, "gemm", dt)
              for (n, P, k), s, dt in itertools.product(
                  ((200, 64, 48), (300, 512, 16)), (1, -1), dtypes)]
    print(f"phase 2a: fused kernel vs plain, {len(cases)} cases; errors in "
          f"units of the storage dtype's roundoff (entry_err)")
    for i, (B, n, P, k, sigma, pa, (dt, acc)) in enumerate(cases):
        grid_mode = F.GRID_MODES[i % 2]
        name = str(dt)[6:]
        L, V = spd_factor(B, n, k, dt, sigma)
        before = F.LAUNCHES.count
        Lk = F.chol_update_fused(L, V, sigma=sigma, panel=P, panel_apply=pa,
                                 grid_mode=grid_mode,
                                 precision="bf16" if acc else None)
        launches = F.LAUNCHES.count - before
        Lp, Vp, _ = blocked._pad_to_panels(L, V, P)
        out_p = F.fused_chain_plain(Lp.contiguous(), Vp.mT.contiguous(),
                                    sigma=sigma, panel=P, panel_apply=pa,
                                    accum_dtype=acc)
        unit = unit_roundoff(torch, dt)
        err = entry_err(torch, Lk, torch.triu(out_p)[:, :n, :n], unit)
        lim = entry_limit(torch, dt, n)
        oracle = chol_update_dense(L.double(), V.double(), sigma=sigma)
        if dt == torch.bfloat16:
            o_err = entry_err(torch, Lk, oracle, unit)
            o_tol = lim
        else:
            o_err = float((Lk.double() - oracle).abs().max())
            o_tol = tol_for(torch, dt, n)
        want = F.launch_count(n, P, method="fused", k=k)
        ok = (err <= lim and o_err <= o_tol and launches == want
              and bool(torch.isfinite(Lk).all()))
        print(f"  B={B} n={n} panel={P} k={k} sigma={sigma:+d} {pa:5s} "
              f"{grid_mode:7s} {name:8s} vs plain {err:.3f} u (limit {lim:g})"
              f"  vs oracle {o_err:.3e} (limit {o_tol:.3e})  launches "
              f"{launches} (want {want})  {'ok' if ok else 'FAIL'}")
        check(ok, f"phase 2a case {i} disagrees")

    # 2b. the per-panel kernels: each output against its plain version.
    cases = list(itertools.product(
        ((1, 256, 16), (3, 64, 1), (2, 4, 16), (1, 128, 32)), (1, -1),
        dtypes))
    print(f"phase 2b: diag_block vs plain, {len(cases)} cases (units of "
          f"roundoff: D_new in storage, c, s, T in accum)")
    for (B, P, k), sigma, (dt, acc) in cases:
        L, V = spd_factor(B, P, k, dt, sigma)
        vtd = V.mT.contiguous()
        out = K.diag_block(L, vtd, sigma=sigma, accum_dtype=acc)
        ref = K._diag_block_plain(L, vtd, sigma, acc)
        state = acc or dt
        errs = [entry_err(torch, out[0], ref[0], unit_roundoff(torch, dt))]
        errs += [units(torch, x, y, unit_roundoff(torch, state))
                 for x, y in zip(out[1:], ref[1:])]
        lims = [entry_limit(torch, dt, P)] + [
            entry_limit(torch, state, P)] * 3
        ok = all(e <= m for e, m in zip(errs, lims)) and all(
            bool(torch.isfinite(x).all()) for x in out)
        print(f"  B={B} P={P} k={k} sigma={sigma:+d} {str(dt)[6:]:8s} "
              f"D {errs[0]:.3f} c {errs[1]:.3f} s {errs[2]:.3f} "
              f"T {errs[3]:.3f} u (limits D {lims[0]:g}, c s T "
              f"{lims[1]:g})  {'ok' if ok else 'FAIL'}")
        check(ok, "phase 2b: diag_block disagrees with its plain version")

    cases = list(itertools.product(
        ((1, 256, 16, 512), (3, 64, 1, 100), (2, 4, 16, 64)),
        ("gemm", "paper"), (1, -1), dtypes))
    print(f"phase 2c: panel applies vs plain, {len(cases)} cases")
    for (B, P, k, w), apply, sigma, (dt, acc) in cases:
        L, V = spd_factor(B, P + w, k, dt, sigma)
        D, vtd = L[:, :P, :P], V[:, :P].mT.contiguous()
        _, c, s, T = K._diag_block_plain(D, vtd, sigma, acc)
        R, vt = L[:, :P, P:], (0.1 * V[:, P:].mT).to(dt)
        if apply == "gemm":
            out = K.panel_apply_gemm(R, vt, T, accum_dtype=acc)
            ref = K._gemm_plain(R, vt, T, acc)
        else:
            out = K.panel_apply_paper(R, vt, c, s, sigma=sigma,
                                      accum_dtype=acc)
            ref = K._paper_plain(R, vt, c, s, sigma, acc)
        unit = unit_roundoff(torch, dt)
        errs = [units(torch, x, y, unit) for x, y in zip(out, ref)]
        lim = entry_limit(torch, dt, P)
        ok = max(errs) <= lim and all(bool(torch.isfinite(x).all())
                                      for x in out)
        print(f"  B={B} P={P} k={k} w={w} {apply:5s} sigma={sigma:+d} "
              f"{str(dt)[6:]:8s} R {errs[0]:.3f} vt {errs[1]:.3f} u "
              f"(limit {lim:g})  {'ok' if ok else 'FAIL'}")
        check(ok, f"phase 2c: panel_apply_{apply} disagrees with plain")

    cases = list(itertools.product(
        ((1, 64, 4, 16), (3, 16, 16, 5), (2, 4, 64, 32)), (1, -1), dtypes))
    print(f"phase 2d: btd_chain vs plain, {len(cases)} cases")
    for (B, nb, b, k), sigma, (dt, acc) in cases:
        S, V = banded(B, nb, b, k)
        vt = V.mT.contiguous()
        if sigma < 0:
            S = BlockTriDiagStorage(*BT.btd_chain_plain(S.diag, S.off, vt,
                                                        sigma=1))
        S = S.astype(dt)
        vt = vt.to(dt)
        d_k, o_k = BT.btd_chain_cuda(S.diag, S.off, vt, sigma=sigma,
                                     accum_dtype=acc)
        d_p, o_p = BT.btd_chain_plain(S.diag, S.off, vt, sigma=sigma,
                                      accum_dtype=acc)
        unit = unit_roundoff(torch, dt)
        errs = [units(torch, torch.triu(d_k), torch.triu(d_p), unit),
                units(torch, o_k, o_p, unit)]
        lim = entry_limit(torch, dt, nb * b)
        ok = max(errs) <= lim and bool(torch.isfinite(d_k).all()
                                       and torch.isfinite(o_k).all())
        print(f"  B={B} nb={nb} b={b} k={k} sigma={sigma:+d} "
              f"{str(dt)[6:]:8s} diag {errs[0]:.3f} off {errs[1]:.3f} u "
              f"(limit {lim:g})  {'ok' if ok else 'FAIL'}")
        check(ok, "phase 2d: btd_chain disagrees with its plain version")

    # 2e. the sharded driver's panel kernel. The stacks come from the
    # port's own chain phase over the whole factor (T and D are the same on
    # every shard, a shard's running V^T is its columns of the whole one);
    # the shard is one tile wide, so tile_off is its shard index of four.
    def chain_stacks(L, V, sigma, P_, acc):
        return distributed._chain_phase(L, V.mT.contiguous(), sigma=sigma, panel=P_,
                              w_loc=L.shape[-1], me=0, mesh=None, dims=[],
                              acc=acc)

    cases = list(itertools.product((None, 3), (64, 256), (1, 16, 32),
                                   (1, -1), dtypes))
    print(f"phase 2e: panel_apply_sharded vs plain, {len(cases)} chain "
          f"phases x tile_off 0, 1, 3")
    for Bc, Pc, kc, sigma, (dt, acc) in cases:
        L, V = spd_factor(Bc or 1, 4 * Pc, kc, dt, sigma)
        if Bc is None:
            L, V = L[0], V[0]
        T, Dst, vt = chain_stacks(L, V, sigma, Pc, acc or dt)
        errs, ok = [], True
        for tile_off in (0, 1, 3):
            cols = slice(tile_off * Pc, (tile_off + 1) * Pc)
            L_loc, vt_loc = L[..., cols].contiguous(), vt[..., cols].contiguous()
            before = SH.LAUNCHES.count
            out = SH.panel_apply_sharded(L_loc, T, Dst, vt_loc,
                                         tile_off=tile_off, panel=Pc,
                                         accum_dtype=acc)
            ref = SH.panel_apply_sharded_plain(L_loc, T, Dst, vt_loc,
                                               tile_off=tile_off, panel=Pc,
                                               accum_dtype=acc)
            rows = slice(tile_off * Pc, None)  # the diagonal tile, zeros
            errs.append(units(torch, out, ref, unit_roundoff(torch, dt)))
            ok &= (SH.LAUNCHES.count == before + 1
                   and bool(torch.isfinite(out).all())
                   and torch.equal(out[..., rows, :], ref[..., rows, :]))
        lim = entry_limit(torch, dt, Pc)
        ok &= max(errs) <= lim
        print(f"  B={Bc or 1}{'' if Bc else ' (unbatched)'} P={Pc} k={kc} "
              f"sigma={sigma:+d} {str(dt)[6:]:8s} tile_off 0/1/3: "
              f"{errs[0]:.3f} {errs[1]:.3f} {errs[2]:.3f} u (limit {lim:g})"
              f"  {'ok' if ok else 'FAIL'}")
        check(ok, "phase 2e: panel_apply_sharded disagrees with its plain "
              "version")
    print(f"phase 2 done at {time.perf_counter() - t_start:.1f} s")

    # -- 3 + 4. the main paths: counts from 0 just before each, read after ---
    n, k, P = 5000, 16, 256
    Bm = torch.from_numpy(rng.uniform(size=(n, n)).astype(np.float32)).to(dev)
    V = torch.from_numpy(rng.uniform(size=(n, k)).astype(np.float32)).to(dev)
    A = Bm.mT @ Bm + torch.eye(n, device=dev)
    del Bm
    nb, fb, kb = 64, 1024, 16
    Bf = torch.from_numpy(
        rng.uniform(size=(nb, fb, fb)).astype(np.float32)).to(dev)
    Vf = torch.from_numpy(
        rng.uniform(size=(nb, fb, kb)).astype(np.float32)).to(dev)
    Lf = torch.linalg.cholesky(
        Bf.mT @ Bf + torch.eye(fb, device=dev)).mT.contiguous()
    del Bf
    f0 = CholFactor.from_matrix(A)  # panel=256, backend='auto', on the card
    torch.cuda.synchronize()

    # 3a. dense fused path (slice 1).
    reset_counts()
    f1 = f0.update(V)
    torch.cuda.synchronize()
    per_update = F.LAUNCHES.count
    f2 = f1.downdate(V)
    torch.cuda.synchronize()
    per_downdate = F.LAUNCHES.count - per_update
    fleet = {}
    for name, prec in (("fp32", None), ("bf16", "bf16")):
        before = F.LAUNCHES.count
        fleet[name] = chol_update_batched(Lf, Vf, precision=prec)
        torch.cuda.synchronize()
        fleet[name + "_launches"] = F.LAUNCHES.count - before
    got = read_counts()
    add_path(got)
    print(f"path fused: launches {got}: update {per_update}, downdate "
          f"{per_downdate}, fleet fp32 {fleet['fp32_launches']}, fleet bf16 "
          f"{fleet['bf16_launches']}")
    check(per_update == 1 and per_downdate == 1,
          "the factor's update/downdate did not take exactly one launch")
    check(fleet["fp32_launches"] == 1 and fleet["bf16_launches"] == 1,
          "a fleet update did not take exactly one launch")
    check(sum(got.values()) == got["fused_chain"],
          "the fused path launched another kernel")

    L0, L1, L2 = (f.data.double() for f in (f0, f1, f2))
    Vd = V.double()
    A_scale = float((L0.mT @ L0 + Vd @ Vd.mT).abs().max())
    rel_mod = float(modify_error(L1, L0, Vd, sigma=1)) / A_scale
    rel_trip = float((L2 - L0).abs().max() / L0.abs().max())
    nbound = n * torch.finfo(torch.float32).eps
    A_tilde = (L0.mT @ L0 + Vd @ Vd.mT).float()
    L_lib = torch.linalg.cholesky(A_tilde).mT.double()
    rel_lib = float(modify_error(L_lib, L0, Vd, sigma=1)) / A_scale
    print(f"  n={n} k={k} fp32: relative modify_error {rel_mod:.3e} "
          f"(refactorization in fp32: {rel_lib:.3e}), round trip "
          f"{rel_trip:.3e}, bound n*eps = {nbound:.3e}")
    check(bool(torch.isfinite(L1).all() and torch.isfinite(L2).all()),
          "main path produced non-finite values")
    check(bool(f1.is_valid()) and bool(f2.is_valid()), "invalid factor")
    check(rel_mod <= nbound and rel_trip <= nbound,
          "main path error above n*eps")

    Lf_d, Vf_d = Lf.double(), Vf.double()
    A_f = Lf_d.mT @ Lf_d + Vf_d @ Vf_d.mT
    bf16_oracle = chol_update_dense(Lf.bfloat16().double(),
                                    Vf.bfloat16().double())
    for name in ("fp32", "bf16"):
        out = fleet[name].double()
        check(out.shape == (nb, fb, fb) and bool(torch.isfinite(out).all()),
              f"fleet {name}: bad shape or non-finite values")
        if name == "fp32":
            err = float((modify_error(out, Lf_d, Vf_d)
                         / A_f.abs().amax(dim=(-2, -1))).max())
            lim = fb * torch.finfo(torch.float32).eps
            what = "relative modify_error"
        else:
            # Against the float64 refactorization of the bf16-rounded
            # inputs, entry by entry, in units of bf16 roundoff.
            err = entry_err(torch, out, bf16_oracle, BF16_EPS)
            lim = entry_limit(torch, torch.bfloat16, fb)
            what = "entry_err (u) vs f64 refactorization"
        print(f"  fleet B={nb} n={fb} k={kb} {name}: worst member {what} "
              f"{err:.3e} (limit {lim:.3e})")
        check(err <= lim, f"fleet {name} error above its limit")

    # 3b. the paper's per-panel cascade at n = 5000, single factor.
    n_panels = -(-n // P)
    casc = {}
    for method in ("pallas", "pallas_gemm"):
        apply = "panel_apply_" + ("gemm" if method == "pallas_gemm"
                                  else "paper")
        reset_counts()
        fc = CholFactor(f0.data, panel=P, backend=method)
        up = fc.update(V)
        torch.cuda.synchronize()
        per_up = read_counts()
        down = up.downdate(V)
        torch.cuda.synchronize()
        got = read_counts()
        add_path(got)
        want = F.launch_count(n, P, method="pallas_2phase", k=k)
        ok_l = (per_up["diag_block"] == n_panels
                and per_up[apply] == n_panels - 1
                and sum(per_up.values()) == want
                and sum(got.values()) == 2 * want)
        Lu, Ld = up.data.double(), down.data.double()
        e_fused = entry_err(torch, up.data, f1.data,
                            unit_roundoff(torch, torch.float32))
        rel = float(modify_error(Lu, L0, Vd, sigma=1)) / A_scale
        trip = float((Ld - L0).abs().max() / L0.abs().max())
        casc[method] = up
        print(f"path {method}: launches {got}; per update "
              f"{sum(per_up.values())} (want 2*{n_panels}-1 = {want}); vs "
              f"fused {e_fused:.3f} u (limit {entry_limit(torch, torch.float32, n):g}); "
              f"relative modify_error {rel:.3e}, round trip {trip:.3e} "
              f"(bound {nbound:.3e})")
        check(ok_l, f"{method}: launches per update are not 2 n_panels - 1")
        check(e_fused <= entry_limit(torch, torch.float32, n)
              and rel <= nbound and trip <= nbound,
              f"{method}: result above its limit")

    # 3c. the cascade on the B = 64 fleet: the launches of one factor.
    reset_counts()
    cfleet = {}
    for name, prec in (("fp32", None), ("bf16", "bf16")):
        before = read_counts()
        cfleet[name] = chol_update_batched(Lf, Vf, method="pallas_gemm",
                                           panel=P, precision=prec)
        torch.cuda.synchronize()
        after = read_counts()
        cfleet[name + "_launches"] = sum(after.values()) - sum(
            before.values())
    got = read_counts()
    add_path(got)
    want = F.launch_count(fb, P, method="pallas_2phase", k=kb)
    print(f"path pallas_gemm fleet B={nb} n={fb}: launches {got}; fp32 "
          f"{cfleet['fp32_launches']}, bf16 {cfleet['bf16_launches']} "
          f"(want {want})")
    check(cfleet["fp32_launches"] == want and cfleet["bf16_launches"] == want,
          "the cascade fleet did not take the launches of one factor")
    u32 = unit_roundoff(torch, torch.float32)
    err = entry_err(torch, cfleet["fp32"], fleet["fp32"], u32)
    rel = float((modify_error(cfleet["fp32"].double(), Lf_d, Vf_d)
                 / A_f.abs().amax(dim=(-2, -1))).max())
    err16 = entry_err(torch, cfleet["bf16"].double(), bf16_oracle, BF16_EPS)
    lim16 = entry_limit(torch, torch.bfloat16, fb)
    print(f"  fleet fp32: vs the fused fleet {err:.3f} u (limit "
          f"{entry_limit(torch, torch.float32, fb):g}), worst member "
          f"relative modify_error {rel:.3e} (limit {fb * 2 * u32:.3e}); "
          f"bf16 vs f64 refactorization {err16:.3f} u (limit {lim16:g})")
    check(err <= entry_limit(torch, torch.float32, fb)
          and rel <= fb * 2 * u32 and err16 <= lim16,
          "the cascade fleet above its limits")

    # 3d. a wide block: b = 64, nb = 512, k = 16, fp32.
    Sw, Vw = banded(1, 512, 64, 16)
    Sw = BlockTriDiagStorage(Sw.diag[0], Sw.off[0]).astype(torch.float32)
    Vw = Vw[0].float()
    reset_counts()
    fw = CholFactor.from_storage(Sw)
    fw1 = fw.update(Vw)
    fw2 = fw1.downdate(Vw)
    torch.cuda.synchronize()
    got = read_counts()
    add_path(got)
    a0d, a0o = Sw.astype(torch.float64).matrix_blocks()
    vd, vo = vvt_blocks(Vw, 64)
    rel_w = block_modify_error(fw1.data, a0d + vd, a0o + vo)
    trip_w = float(max((fw2.data.diag - Sw.diag).abs().max(),
                       (fw2.data.off - Sw.off).abs().max())
                   / Sw.diag.abs().max())
    wbound = 512 * 64 * torch.finfo(torch.float32).eps
    print(f"path wide block nb=512 b=64 k=16 fp32: launches {got}; "
          f"relative modify_error {rel_w:.3e}, round trip {trip_w:.3e} "
          f"(bound {wbound:.3e})")
    check(got["btd_chain"] == 2 and sum(got.values()) == 2,
          "the wide block did not take one launch per sign block")
    check(rel_w <= wbound and trip_w <= wbound, "wide block above limits")

    # 3e. the Kalman smoother: T = 8192 timesteps, b = 4, k = 16.
    T_kf, chunk = 8192, 8
    Fm, Hm, Qm, Rm, P0m = kf_model(np)
    truth, ys = kf_simulate(np, T_kf, Fm, Hm, Qm, Rm, P0m, args.seed)
    Ad, Ao = kf_prior_blocks(np, T_kf, Fm, Qm, P0m)
    n_kf = T_kf * KF_D
    Rinv = np.linalg.inv(Rm)
    HtRih = Hm.T @ np.linalg.cholesky(Rinv)         # H^T R^{-1/2}, (D, M)
    eta = (ys @ Rinv @ Hm).reshape(-1)              # sum H^T R^-1 y_t
    blk = torch.from_numpy(np.kron(np.eye(chunk), HtRih)).float().to(dev)

    def meas(lo, hi):
        """V of the measurements at times lo..hi-1: block-local columns."""
        Vm = torch.zeros((n_kf, (hi - lo) * KF_M), device=dev)
        Vm[lo * KF_D:hi * KF_D] = blk[:(hi - lo) * KF_D, :(hi - lo) * KF_M]
        return Vm

    reset_counts()
    t0 = time.perf_counter()
    fk = CholFactor.from_blocktridiag(torch.from_numpy(Ad).float().to(dev),
                                      torch.from_numpy(Ao).float().to(dev))
    torch.cuda.synchronize()
    t_prior = time.perf_counter() - t0
    # Inputs of the block chain's comparison with its plain version: this
    # path's first update and the wide block's. The plain walks run on the
    # CPU in a worker process during this path (no launch); the kernel
    # runs after the paths.
    btd_cmp = {"smoother": (fk.data.diag[None], fk.data.off[None],
                            meas(0, chunk).mT.contiguous()[None]),
               "wide": (Sw.diag[None], Sw.off[None],
                        Vw.mT.contiguous()[None])}
    join_walks = plain_walks_in_background(torch, btd_cmp)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    ev0.record()
    for lo in range(0, T_kf, chunk):
        fk = fk.update(meas(lo, min(lo + chunk, T_kf)))
    ev1.record()
    torch.cuda.synchronize()
    n_up = -(-T_kf // chunk)
    kf_dev_ms = ev0.elapsed_time(ev1) / n_up
    kf_host_ms = (time.perf_counter() - t0) * 1e3 / n_up
    t_bad = T_kf // 2
    y_bad = ys[t_bad] + np.array([25.0, -25.0])
    Vbad = meas(t_bad, t_bad + 1)
    f_bad = fk.update(Vbad)
    eta_bad = eta.copy()
    eta_bad[t_bad * KF_D:(t_bad + 1) * KF_D] += Hm.T @ Rinv @ y_bad
    xs_bad = f_bad.solve(torch.from_numpy(eta_bad).float().to(dev))
    feasible = bool(f_bad.downdate_feasible(Vbad))
    fk = f_bad.downdate(Vbad)
    torch.cuda.synchronize()
    got = read_counts()
    add_path(got)
    xs = fk.solve(torch.from_numpy(eta).float().to(dev))
    ld = float(fk.logdet())
    # float64 references: the block-tridiagonal posterior it represents.
    Jd = Ad + (Hm.T @ Rinv @ Hm)[None]
    rel_kf = block_modify_error(
        fk.data, torch.from_numpy(Jd).to(dev), torch.from_numpy(Ao).to(dev))
    ab = banded_ab(np, Jd, Ao)
    xs_exact = scipy.linalg.solveh_banded(ab, eta)
    cb = scipy.linalg.cholesky_banded(ab)
    ld_exact = 2.0 * float(np.log(cb[-1]).sum())
    xs_np = xs.double().cpu().numpy()
    mean_err = float(np.abs(xs_np - xs_exact).max() / np.abs(xs_exact).max())
    ld_err = abs(ld - ld_exact) / abs(ld_exact)
    kbound = n_kf * torch.finfo(torch.float32).eps
    pos = xs_np.reshape(T_kf, KF_D)[:, [0, 2]]
    rmse = float(np.sqrt(np.mean((pos - truth[:, [0, 2]]) ** 2)))
    raw = float(np.sqrt(np.mean((ys - truth[:, [0, 2]]) ** 2)))
    pull = float((xs_bad.double().cpu() - xs.double().cpu()).abs()
                 .reshape(T_kf, KF_D)[t_bad].max())
    want = n_up + 2
    print(f"path smoother T={T_kf} (n={n_kf}, b={KF_D}, k={chunk * KF_M}, "
          f"fp32): launches {got} (want {want}: {n_up} chunk updates, the "
          f"outlier's update and downdate); prior {t_prior:.2f} s; per "
          f"update {kf_dev_ms:.3f} ms on the card, {kf_host_ms:.3f} ms host")
    print(f"  relative modify_error (block form) {rel_kf:.3e}, means vs "
          f"banded f64 solve {mean_err:.3e}, logdet {ld:.6f} vs "
          f"{ld_exact:.6f} (relative {ld_err:.3e}); bound n*eps = "
          f"{kbound:.3e}; outlier feasible {feasible}, had pulled the "
          f"state {pull:.2f}; position RMSE {rmse:.3f} vs raw {raw:.3f}")
    check(got["btd_chain"] == want and sum(got.values()) == want,
          "the smoother did not take one launch per update")
    check(feasible and bool(fk.is_valid()), "smoother factor invalid")
    check(rel_kf <= kbound and mean_err <= kbound and ld_err <= kbound,
          "smoother above its limits")

    # 3f. a structured fleet: B = 64, b = 16, nb = 512, k = 16.
    Sf, Vsf = banded(64, 512, 16, 16)
    Sf32, Vsf32 = Sf.astype(torch.float32), Vsf.float()
    reset_counts()
    sfleet = {}
    for name, prec in (("fp32", None), ("bf16", "bf16")):
        before = BT.LAUNCHES.count
        sfleet[name] = chol_update_batched(Sf32, Vsf32, precision=prec)
        torch.cuda.synchronize()
        sfleet[name + "_launches"] = BT.LAUNCHES.count - before
    got = read_counts()
    add_path(got)
    print(f"path structured fleet B=64 nb=512 b=16 k=16: launches {got}")
    check(sfleet["fp32_launches"] == 1 and sfleet["bf16_launches"] == 1
          and sum(got.values()) == 2,
          "the structured fleet did not take one launch per sign block")
    a0d, a0o = Sf32.astype(torch.float64).matrix_blocks()
    vd, vo = vvt_blocks(Vsf32, 16)
    rel_f = block_modify_error(sfleet["fp32"], a0d + vd, a0o + vo)
    sbound = 512 * 16 * torch.finfo(torch.float32).eps
    # bf16 against the float64 chain refactorization of the rounded inputs.
    S16 = Sf32.astype(torch.bfloat16).astype(torch.float64)
    a1d, a1o = S16.matrix_blocks()
    vd, vo = vvt_blocks(Vsf32.bfloat16(), 16)
    oracle = BlockTriDiagStorage.from_matrix_blocks(a1d + vd, a1o + vo)
    e16 = max(entry_err(torch, sfleet["bf16"].diag, oracle.diag, BF16_EPS),
              units(torch, sfleet["bf16"].off, oracle.off, BF16_EPS))
    lim16 = entry_limit(torch, torch.bfloat16, 0)
    print(f"  fp32 worst member relative modify_error {rel_f:.3e} (bound "
          f"{sbound:.3e}); bf16 vs f64 chain refactorization {e16:.3f} u "
          f"(limit {lim16:g})")
    check(rel_f <= sbound and e16 <= lim16, "structured fleet above limits")

    # 3g. the column-sharded driver on one rank (NCCL where there is one,
    # else gloo; one rank takes no collective): n = 5120, the paper's 5000
    # rounded up to whole panels (the driver takes no padding), k = 16, and
    # the B = 64 fleet in fp32 and bf16.
    store_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    dist.init_process_group("nccl" if dist.is_nccl_available() else "gloo",
                            init_method=f"file://{store_dir}/store1",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    mesh1 = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
    ns = 5120
    Bs = torch.from_numpy(rng.uniform(size=(ns, ns)).astype(np.float32)).to(dev)
    Vs = torch.from_numpy(rng.uniform(size=(ns, k)).astype(np.float32)).to(dev)
    Ls0 = torch.linalg.cholesky(Bs.mT @ Bs + torch.eye(ns, device=dev)
                                ).mT.contiguous()
    del Bs
    Ls_fused = CholFactor(Ls0, panel=P).update(Vs).data  # before the counts
    torch.cuda.synchronize()
    reset_counts()
    fs0 = CholFactor(Ls0, panel=P, backend="sharded", mesh=mesh1)
    fs1 = fs0.update(Vs)
    torch.cuda.synchronize()
    s_up = {name: v for name, v in read_counts().items() if v}
    fs2 = fs1.downdate(Vs)
    torch.cuda.synchronize()
    sfleet = {}
    for name, prec in (("fp32", None), ("bf16", "bf16")):
        before = read_counts()
        sfleet[name] = chol_update_batched(Lf, Vf, method="sharded",
                                           mesh=mesh1, panel=P,
                                           precision=prec)
        torch.cuda.synchronize()
        sfleet[name + "_launches"] = {
            c: v - before[c] for c, v in read_counts().items()
            if v != before[c]}
    got = read_counts()
    add_path(got)
    want_s = SH.kernel_launches(ns, P, strategy="fused", k=k)
    want_f = SH.kernel_launches(fb, P, strategy="fused", k=kb)
    print(f"path sharded, one rank, n={ns} k={k} panel={P} fp32: launches "
          f"{got}; per update {s_up} (want {want_s}); fleet B={nb} n={fb} "
          f"fp32 {sfleet['fp32_launches']}, bf16 {sfleet['bf16_launches']} "
          f"(want {want_f})")
    check(s_up == want_s and sum(got.values()) == 2 * sum(want_s.values())
          + 2 * sum(want_f.values()),
          "sharded: not one panel_apply_sharded launch per shard per sign "
          "block and n_panels diag_block launches")
    check(sfleet["fp32_launches"] == want_f
          and sfleet["bf16_launches"] == want_f,
          "sharded fleet: not one panel-phase launch for the whole fleet")
    Ls1, Ls2 = distributed.gather(fs1.data), distributed.gather(fs2.data)
    L0s, Vsd = Ls0.double(), Vs.double()
    As_scale = float((L0s.mT @ L0s + Vsd @ Vsd.mT).abs().max())
    rel_s = float(modify_error(Ls1.double(), L0s, Vsd, sigma=1)) / As_scale
    trip_s = float((Ls2.double() - L0s).abs().max() / L0s.abs().max())
    e_sf = entry_err(torch, Ls1, Ls_fused, u32)
    sbound_n = ns * torch.finfo(torch.float32).eps
    print(f"  relative modify_error vs f64 {rel_s:.3e}, round trip "
          f"{trip_s:.3e} (bound n*eps = {sbound_n:.3e}); vs the fused path "
          f"{e_sf:.3f} u (limit {entry_limit(torch, torch.float32, ns):g})")
    check(bool(torch.isfinite(Ls1).all() and torch.isfinite(Ls2).all())
          and bool(fs1.is_valid()) and bool(fs2.is_valid()),
          "sharded path: non-finite values or an invalid factor")
    check(rel_s <= sbound_n and trip_s <= sbound_n
          and e_sf <= entry_limit(torch, torch.float32, ns),
          "sharded path above its limits")
    sf32, sf16 = distributed.gather(sfleet["fp32"]), distributed.gather(sfleet["bf16"])
    e_f = entry_err(torch, sf32, fleet["fp32"], u32)
    rel_sf = float((modify_error(sf32.double(), Lf_d, Vf_d)
                    / A_f.abs().amax(dim=(-2, -1))).max())
    e_16 = entry_err(torch, sf16.double(), bf16_oracle, BF16_EPS)
    print(f"  fleet fp32 vs the fused fleet {e_f:.3f} u (limit "
          f"{entry_limit(torch, torch.float32, fb):g}), worst member relative "
          f"modify_error {rel_sf:.3e} (limit {fb * 2 * u32:.3e}); bf16 vs f64 "
          f"refactorization {e_16:.3f} u (limit "
          f"{entry_limit(torch, torch.bfloat16, fb):g})")
    check(e_f <= entry_limit(torch, torch.float32, fb)
          and rel_sf <= fb * 2 * u32
          and e_16 <= entry_limit(torch, torch.bfloat16, fb)
          and bool(torch.isfinite(sf16).all()),
          "sharded fleet above its limits")
    print(f"main paths done at {time.perf_counter() - t_start:.1f} s; "
          f"launches {main_launches}")

    # 3h. four ranks sharing the card (spawned, gloo: NCCL takes one rank
    # per card), against the one-rank results: the n = 5120 factor (1280
    # columns a rank) by each strategy, the B = 64 fleet (256 columns a
    # rank, tile_off 0..3) in fp32 and bf16. Correctness only.
    one = {"fused": Ls1, "fleet fp32": sf32, "fleet bf16": sf16}
    for strat in ("gemm", "paper"):  # the one-rank references, not counted
        one[strat] = distributed.gather(chol_update_batched(
            Ls0[None], Vs[None], method="sharded", mesh=mesh1, panel=P,
            strategy=strat))[0]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    codes, res4, counts4, checks4 = run_four_ranks(
        torch, {"L": Ls0, "V": Vs, "Lf": Lf, "Vf": Vf}, timeout=400)
    print(f"path sharded, four ranks on the card: exit codes {codes}, "
          f"{time.perf_counter() - t0:.1f} s")
    check(codes == [0] * 4, "a rank of the four-rank run failed")
    for rank, rank_checks in enumerate(checks4 or ()):
        for what, err, lim, ok in rank_checks:
            print(f"  rank {rank}: {what} vs plain {err:.3f} u (limit "
                  f"{lim:g})  {'ok' if ok else 'FAIL'}")
            check(ok, f"rank {rank}: {what} disagrees with its plain version")
    check(checks4 is None or all(len(c) == 9 for c in checks4),
          "a rank did not check all its kernels")
    for name, strat, is_fleet, prec in SHARDED_CASES if res4 else ():
        n_ = fb if is_fleet else ns
        dt = torch.bfloat16 if prec else torch.float32
        err = entry_err(torch, res4[name].to(dev), one[name],
                        unit_roundoff(torch, dt))
        lim = entry_limit(torch, dt, n_)
        want = SH.kernel_launches(n_, P, strategy=strat, k=k)
        ok_c = all(c[name] == want for c in counts4)
        print(f"  {name:10s} ({strat}) vs one rank {err:.3f} u (limit "
              f"{lim:g}); launches per rank {[c[name] for c in counts4]} "
              f"(want {want})  {'ok' if err <= lim and ok_c else 'FAIL'}")
        check(err <= lim and ok_c and bool(torch.isfinite(res4[name]).all()),
              f"four ranks disagree with one rank ({name})")
    del res4

    # -- kernel vs plain at the main paths' shapes (not counted) --------------
    # The fused chain: the downdate first, so that Lp, vt are the update's
    # for the timings.
    max_err = {}
    main_lim = entry_limit(torch, torch.float32, n)
    main_err = 0.0
    for sigma, f_in in ((-1, f1), (1, f0)):
        Lp, Vp, _ = blocked._pad_to_panels(f_in.data[None], V[None], P)
        Lp, vt = Lp.contiguous(), Vp.mT.contiguous()
        out_k = F.fused_chain_cuda(Lp, vt, sigma=sigma, panel=P)
        plain_ms, out_p = timed(torch, lambda: F.fused_chain_plain(
            Lp, vt, sigma=sigma, panel=P), reps=1, warmup=0)
        Lk, Lpl = torch.triu(out_k)[0, :n, :n], torch.triu(out_p)[0, :n, :n]
        main_err = max(main_err, float((Lk - Lpl).abs().max()))
        err_u = entry_err(torch, Lk, Lpl, unit_roundoff(torch, torch.float32))
        del out_k, out_p, Lk, Lpl
        print(f"fused kernel vs plain at n={n}, sigma={sigma:+d}: "
              f"{err_u:.3f} u (limit {main_lim:g}), max abs {main_err:.3e}, "
              f"plain {plain_ms:.1f} ms")
        check(err_u <= main_lim, f"kernel disagrees with plain at n={n}")
    max_err["fused_chain"] = main_err
    Lfp, Vfp, _ = blocked._pad_to_panels(Lf, Vf, P)
    for name, dt, acc in (("fp32", torch.float32, None),
                          ("bf16", torch.bfloat16, torch.float32)):
        Lfx, vtx = Lfp.to(dt).contiguous(), Vfp.to(dt).mT.contiguous()
        o_k = F.fused_chain_cuda(Lfx, vtx, sigma=1, panel=P, accum_dtype=acc)
        o_p = F.fused_chain_plain(Lfx, vtx, sigma=1, panel=P,
                                  accum_dtype=acc)
        err = entry_err(torch, torch.triu(o_k)[:, :fb, :fb],
                        torch.triu(o_p)[:, :fb, :fb], unit_roundoff(torch, dt))
        lim = entry_limit(torch, dt, fb)
        print(f"fused kernel vs plain, fleet {name}: {err:.3f} u (limit "
              f"{lim:g})")
        check(err <= lim, f"kernel disagrees with plain on the {name} fleet")

    # The per-panel kernels on panel 0 of the n = 5000 cascade.
    D0, vtd0 = Lp[0, :P, :P], vt[0, :, :P]
    out = K.diag_block(D0, vtd0, sigma=1)
    ref = K._diag_block_plain(D0, vtd0.contiguous(), 1, None)
    errs = [entry_err(torch, out[0], ref[0], u32)] + [
        units(torch, x, y, u32) for x, y in zip(out[1:], ref[1:])]
    max_err["diag_block"] = max(float((x - y).abs().max())
                                for x, y in zip(out, ref))
    _, c0, s0, T0 = ref
    R0, vtr0 = Lp[0, :P, P:], vt[0, :, P:]
    og = K.panel_apply_gemm(R0, vtr0, T0)
    rg = K._gemm_plain(R0, vtr0, T0, None)
    opp = K.panel_apply_paper(R0, vtr0, c0, s0, sigma=1)
    rp = K._paper_plain(R0, vtr0, c0, s0, 1, None)
    errs += [units(torch, x, y, u32) for x, y in zip(og + opp, rg + rp)]
    max_err["panel_apply_gemm"] = max(float((x - y).abs().max())
                                      for x, y in zip(og, rg))
    max_err["panel_apply_paper"] = max(float((x - y).abs().max())
                                       for x, y in zip(opp, rp))
    lims = [entry_limit(torch, torch.float32, P)] * 8
    print(f"per-panel kernels vs plain on panel 0 at n={n} (units): "
          f"diag_block D {errs[0]:.3f} c {errs[1]:.3f} s {errs[2]:.3f} "
          f"T {errs[3]:.3f} (limits {lims[0]:g}, {lims[1]:g}); gemm R "
          f"{errs[4]:.3f} vt {errs[5]:.3f}; paper R {errs[6]:.3f} vt "
          f"{errs[7]:.3f} (limit {lims[4]:g})")
    check(all(e <= m for e, m in zip(errs, lims)),
          "a per-panel kernel disagrees with its plain version at n=5000")

    # The per-panel kernels on panel 0 of the B = 64 cascade fleet, in place
    # on the member-strided views the cascade hands them.
    for name, dt, acc in (("fp32", torch.float32, None),
                          ("bf16", torch.bfloat16, torch.float32)):
        Lx = Lfp.to(dt, copy=True)
        vtx = Vfp.to(dt).mT.contiguous()
        D, vd = Lx[:, :P, :P], vtx[:, :, :P]
        R, vr = Lx[:, :P, P:], vtx[:, :, P:]
        D_in, vd_in, R_in, vr_in = (x.clone() for x in (D, vd, R, vr))
        c_k, s_k, T_k = K.diag_block_(D, vd, sigma=1, accum_dtype=acc)
        K.panel_apply_gemm_(R, vr, T_k, accum_dtype=acc)
        ref = K._diag_block_plain(D_in, vd_in, 1, acc)
        R_p, vr_p = K._gemm_plain(R_in, vr_in, T_k, acc)
        unit, state = unit_roundoff(torch, dt), acc or dt
        errs = [entry_err(torch, D, ref[0], unit)] + [
            units(torch, x, y, unit_roundoff(torch, state))
            for x, y in zip((c_k, s_k, T_k), ref[1:])]
        errs += [units(torch, R, R_p, unit), units(torch, vr, vr_p, unit)]
        lims = [entry_limit(torch, dt, P)] + [
            entry_limit(torch, state, P)] * 3 + [entry_limit(torch, dt, P)] * 2
        ok = (all(e <= m for e, m in zip(errs, lims))
              and not bool(vd.any()))
        print(f"per-panel kernels vs plain on panel 0 of the fleet B={nb} "
              f"n={fb} {name} (member-strided views, units): diag_block D "
              f"{errs[0]:.3f} c {errs[1]:.3f} s {errs[2]:.3f} T "
              f"{errs[3]:.3f} (limits {lims[0]:g}, {lims[1]:g}); gemm R "
              f"{errs[4]:.3f} vt {errs[5]:.3f} (limit {lims[4]:g})  "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"a per-panel kernel disagrees with its plain version on "
              f"the {name} fleet")
        del Lx, vtx, D, vd, R, vr, D_in, vd_in, R_in, vr_in

    # The block chain on the smoother's first update and on the wide block,
    # against the plain walks made on the CPU since the smoother's path.
    plain_btd = join_walks()
    btd_abs = 0.0
    for name, (d, o, v) in btd_cmp.items():
        d_k, o_k = BT.btd_chain_cuda(d, o, v, sigma=1)
        d_p, o_p = plain_btd[name]
        d_k, o_k = d_k.cpu(), o_k.cpu()
        err = max(units(torch, torch.triu(d_k), torch.triu(d_p), u32),
                  units(torch, o_k, o_p, u32))
        btd_abs = max(btd_abs, float((d_k - d_p).abs().max()),
                      float((o_k - o_p).abs().max()))
        lim = entry_limit(torch, torch.float32, d.shape[1] * d.shape[-1])
        print(f"btd_chain vs plain, {name} (B=1 nb={d.shape[1]} "
              f"b={d.shape[-1]} k={v.shape[1]} fp32, plain on the CPU): "
              f"{err:.3f} u (limit {lim:g})  {'ok' if err <= lim else 'FAIL'}")
        check(err <= lim, f"btd_chain disagrees with plain ({name})")

    # The block chain on the structured fleet, fp32 and bf16.
    btd_plain_ms = None
    for name, dt, acc in (("fp32", torch.float32, None),
                          ("bf16", torch.bfloat16, torch.float32)):
        Sx, vtx = Sf32.astype(dt), Vsf32.to(dt).mT.contiguous()
        d_k, o_k = BT.btd_chain_cuda(Sx.diag, Sx.off, vtx, sigma=1,
                                     accum_dtype=acc)
        p_ms, (d_p, o_p) = timed(torch, lambda: BT.btd_chain_plain(
            Sx.diag, Sx.off, vtx, sigma=1, accum_dtype=acc), reps=1,
            warmup=0)
        unit = unit_roundoff(torch, dt)
        err = max(units(torch, torch.triu(d_k), torch.triu(d_p), unit),
                  units(torch, o_k, o_p, unit))
        lim = entry_limit(torch, dt, 512 * 16)
        if name == "fp32":
            btd_plain_ms = p_ms
            max_err["btd_chain"] = max(btd_abs, float(
                (d_k - d_p).abs().max()), float((o_k - o_p).abs().max()))
        print(f"btd_chain vs plain, structured fleet {name}: {err:.3f} u "
              f"(limit {lim:g}), plain {p_ms:.1f} ms")
        check(err <= lim, f"btd_chain disagrees with plain ({name} fleet)")

    # The panel kernel on the sharded path's own stacks: the n = 5120 factor
    # on one rank (tile_off 0, 20 x 20 tiles) and the B = 64 fleet.
    vt_s = Vs.mT.contiguous()

    def stacks_s():
        return distributed._chain_phase(Ls0, vt_s, sigma=1, panel=P, w_loc=ns, me=0,
                              mesh=mesh1, dims=[0], acc=torch.float32)

    Ts, Dss, vts = stacks_s()
    out_k = SH.panel_apply_sharded_cuda(Ls0, Ts, Dss, vts, tile_off=0,
                                        panel=P)
    psh_ms, out_p = timed(torch, lambda: SH.panel_apply_sharded_plain(
        Ls0, Ts, Dss, vts, tile_off=0, panel=P), reps=1, warmup=0)
    err = units(torch, out_k, out_p, u32)
    max_err["panel_apply_sharded"] = float((out_k - out_p).abs().max())
    print(f"panel_apply_sharded vs plain at n={ns} (units): {err:.3f} (limit "
          f"{entry_limit(torch, torch.float32, P):g}), max abs "
          f"{max_err['panel_apply_sharded']:.3e}")
    check(err <= entry_limit(torch, torch.float32, P),
          "panel_apply_sharded disagrees with plain at n=5120")
    del out_k, out_p
    for name, dt, acc in (("fp32", torch.float32, None),
                          ("bf16", torch.bfloat16, torch.float32)):
        Lx, vx = Lf.to(dt), Vf.to(dt).mT.contiguous()
        T_, D_, v_ = distributed._chain_phase(Lx, vx, sigma=1, panel=P, w_loc=fb,
                                    me=0, mesh=mesh1, dims=[0],
                                    acc=torch.float32)
        o_k = SH.panel_apply_sharded_cuda(Lx, T_, D_, v_, tile_off=0,
                                          panel=P, accum_dtype=acc)
        o_p = SH.panel_apply_sharded_plain(Lx, T_, D_, v_, tile_off=0,
                                           panel=P, accum_dtype=acc)
        err = units(torch, o_k, o_p, unit_roundoff(torch, dt))
        lim = entry_limit(torch, dt, P)
        if name == "fp32":
            max_err["panel_apply_sharded"] = max(
                max_err["panel_apply_sharded"],
                float((o_k - o_p).abs().max()))
        print(f"panel_apply_sharded vs plain, fleet B={nb} n={fb} {name}: "
              f"{err:.3f} u (limit {lim:g})  {'ok' if err <= lim else 'FAIL'}")
        check(err <= lim, f"panel_apply_sharded disagrees with plain on the "
              f"{name} fleet")
        del Lx, vx, T_, D_, v_, o_k, o_p

    # -- 5. timings ------------------------------------------------------------
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    groups = F.column_groups(1, Lp.shape[-1] // P, P, sms)
    ms, _ = timed(torch, lambda: F.fused_chain_cuda(Lp, vt, sigma=1, panel=P),
                  reps=10, warmup=2)
    paper_ms, _ = timed(torch, lambda: F.fused_chain_cuda(
        Lp, vt, sigma=1, panel=P, panel_apply="paper"), reps=5, warmup=1)
    one_group_ms, _ = timed(torch, lambda: F.fused_chain_cuda(
        Lp, vt, sigma=1, panel=P, _groups=1), reps=5, warmup=1)
    # Anatomy of the chain: one diagonal block alone (n = P), and two with
    # the apply on tile (0, 1) between them (n = 2P), on the leading blocks
    # of the same factor.
    anatomy = {}
    for tiles in (1, 2):
        m = tiles * P
        La, vta = Lp[:, :m, :m].contiguous(), vt[:, :, :m].contiguous()
        anatomy[tiles], _ = timed(torch, lambda: F.fused_chain_cuda(
            La, vta, sigma=1, panel=P), reps=20, warmup=2)
    A_mod = (A + V @ V.mT).contiguous()
    library_ms, _ = timed(torch, lambda: torch.linalg.cholesky(A_mod),
                          reps=10, warmup=2)
    nbytes = F.bytes_per_update(n, P, k, storage_dtype=torch.float32)
    # The work the function needs: the rotations (the paper apply's count),
    # not the redundant multiply-adds of the transform GEMM.
    ops = F.ops_per_update(n, P, k, panel_apply="paper")
    bound_ms, bound_by = bound(nbytes, ops, "float32")
    print(f"timing fused n={n} k={k} panel={P} fp32 on {card}: kernel "
          f"{ms:.3f} ms (paper apply {paper_ms:.3f} ms), plain "
          f"{plain_ms:.1f} ms, cholesky(A + VV^T) {library_ms:.3f} ms")
    print(f"  bytes_per_update {nbytes} -> {nbytes / ms / 1e6:.1f} GB/s; "
          f"ops {ops} -> {ops / ms / 1e9:.3f} TFLOP/s; bound {bound_ms:.4f} "
          f"ms by {bound_by}; share of bound {bound_ms / ms:.4f}")
    print(f"  column groups {groups} ({Lp.shape[-1] // P * groups} blocks on "
          f"{sms} SMs): {ms:.3f} ms; one group per column tile: "
          f"{one_group_ms:.3f} ms")
    print(f"  chain anatomy: one diagonal block (n={P}) {anatomy[1]:.4f} ms; "
          f"n={2 * P} {anatomy[2]:.4f} ms, so apply + hand-over "
          f"{anatomy[2] - 2 * anatomy[1]:.4f} ms; "
          f"{Lp.shape[-1] // P} chain steps")
    for name, dt, acc in (("fp32", torch.float32, None),
                          ("bf16", torch.bfloat16, torch.float32)):
        Lfx, vtx = Lfp.to(dt).contiguous(), Vfp.to(dt).mT.contiguous()
        f_ms, _ = timed(torch, lambda: F.fused_chain_cuda(
            Lfx, vtx, sigma=1, panel=P, accum_dtype=acc), reps=5, warmup=1)
        f_bytes = nb * F.bytes_per_update(fb, P, kb, storage_dtype=dt)
        print(f"  fleet B={nb} n={fb} {name}: kernel {f_ms:.3f} ms, "
              f"{f_bytes / f_ms / 1e6:.1f} GB/s")

    # The cascade at n = 5000: each kernel's launches of one update, back to
    # back on a copy of the padded factor (T, c, s of panel 0 stand in for
    # every panel's: the time does not depend on their values), and the
    # whole update through CholFactor, on the card and on the host clock.
    Lw, vtw = Lp[0].clone(), vt[0].clone()
    n_pad = Lw.shape[-1]
    panels = range(0, n_pad, P)
    widths = [n_pad - r0 - P for r0 in panels][:-1]

    # The diagonal pass in its functional form (a copy of the block, then
    # the launch): in place, a second pass would sweep the slabs the first
    # annihilated, which are not an update's data.
    blocks = [(Lp[0, r0:r0 + P, r0:r0 + P], vt[0, :, r0:r0 + P].contiguous())
              for r0 in panels]

    def run_diag():
        for D, v in blocks:
            K.diag_block(D, v, sigma=1)

    def run_apply(paper):
        for r0 in panels[:-1]:
            R, vr = Lw[r0:r0 + P, r0 + P:], vtw[:, r0 + P:]
            if paper:
                K.panel_apply_paper_(R, vr, c0, s0, sigma=1)
            else:
                K.panel_apply_gemm_(R, vr, T0)

    diag_ms, _ = timed(torch, run_diag, reps=5, warmup=1)
    gemm_ms, _ = timed(torch, lambda: run_apply(False), reps=5, warmup=1)
    pap_ms, _ = timed(torch, lambda: run_apply(True), reps=5, warmup=1)
    Sstk = [torch.cat([Lp[0, r0:r0 + P, r0 + P:], vt[0, :, r0 + P:]])
            for r0 in panels[:-1]]
    lib_gemm_ms, _ = timed(torch, lambda: [T0 @ x for x in Sstk], reps=5,
                           warmup=1)
    pdiag_ms, _ = timed(torch, lambda: [K._diag_block_plain(D, v, 1, None)
                                        for D, v in blocks], reps=1, warmup=0)
    Rs = [(Lp[0, r0:r0 + P, r0 + P:], vt[0, :, r0 + P:])
          for r0 in panels[:-1]]
    pgemm_ms, _ = timed(torch, lambda: [K._gemm_plain(R, v, T0, None)
                                        for R, v in Rs], reps=1, warmup=0)
    ppap_ms, _ = timed(torch, lambda: [K._paper_plain(R, v, c0, s0, 1, None)
                                       for R, v in Rs], reps=1, warmup=0)
    # Bounds summed over the launches of one update: each input read once,
    # each output written once (fp32: 4 bytes), operations from shapes.
    nd = len(panels)
    b_diag = bound(nd * 4 * (2 * P * P + k * P + 2 * P * k + (P + k) ** 2),
                   nd * 6 * P * (P + 1 + k) * k, "float32")
    b_gemm = bound(sum(4 * (2 * (P + k) * w + (P + k) ** 2) for w in widths),
                   sum(2 * (P + k) ** 2 * w for w in widths), "float32")
    b_pap = bound(sum(4 * (2 * (P + k) * w + 2 * P * k) for w in widths),
                  sum(6 * P * k * w for w in widths), "float32")
    casc_t = {}
    for method in ("pallas", "pallas_gemm"):
        fc = CholFactor(f0.data, panel=P, backend=method)
        d_ms, _ = timed(torch, lambda: fc.update(V), reps=5, warmup=1)
        h_ms, _ = host_timed(torch, lambda: fc.update(V), reps=5)
        casc_t[method] = (d_ms, h_ms)
    print(f"timing cascade n={n} k={k} panel={P} fp32 ({nd} diagonal "
          f"blocks, {len(widths)} applies, widths {widths[0]}..{widths[-1]})"
          f": per update diag_block {diag_ms:.3f} ms (plain {pdiag_ms:.1f}, "
          f"bound {b_diag[0]:.4f} by {b_diag[1]}); panel_apply_gemm "
          f"{gemm_ms:.3f} ms (plain {pgemm_ms:.1f}, torch.matmul "
          f"{lib_gemm_ms:.3f}, bound {b_gemm[0]:.4f} by {b_gemm[1]}); "
          f"panel_apply_paper {pap_ms:.3f} ms (plain {ppap_ms:.1f}, bound "
          f"{b_pap[0]:.4f} by {b_pap[1]})")
    for method, (d_ms, h_ms) in casc_t.items():
        print(f"  CholFactor.update, backend={method}: {d_ms:.3f} ms on the "
              f"card (CUDA events), {h_ms:.3f} ms host clock")
    for name, prec in (("fp32", None), ("bf16", "bf16")):
        def run():
            return chol_update_batched(Lf, Vf, method="pallas_gemm",
                                       panel=P, precision=prec)
        d_ms, _ = timed(torch, run, reps=5, warmup=1)
        h_ms, _ = host_timed(torch, run, reps=5)
        print(f"  chol_update_batched B={nb} n={fb} pallas_gemm {name}: "
              f"{d_ms:.3f} ms on the card, {h_ms:.3f} ms host clock")

    # The block chain: the smoother, the wide block, the structured fleet.
    btd_t = {}
    btd_t["smoother"], _ = timed(torch, lambda: fk.update(
        meas(0, chunk)), reps=3, warmup=1)
    btd_t["wide"], _ = timed(torch, lambda: fw.update(Vw), reps=3, warmup=1)
    for name, prec in (("fleet fp32", None), ("fleet bf16", "bf16")):
        btd_t[name], _ = timed(torch, lambda: chol_update_batched(
            Sf32, Vsf32, precision=prec), reps=5, warmup=1)

    def btd_bound(B, nb_, b, k_, isize):
        nbytes = B * BT.bytes_per_update(nb_, b, k_, storage_dtype=(
            torch.float32 if isize == 4 else torch.bfloat16))
        ops = B * nb_ * 6 * k_ * (b * (b + 1 + k_) + b * b)
        return bound(nbytes, ops, "float32")

    btd_b = {"smoother": btd_bound(1, T_kf, KF_D, 16, 4),
             "wide": btd_bound(1, 512, 64, 16, 4),
             "fleet fp32": btd_bound(64, 512, 16, 16, 4),
             "fleet bf16": btd_bound(64, 512, 16, 16, 2)}
    for name, t_ms in btd_t.items():
        print(f"timing btd_chain {name}: {t_ms:.3f} ms per update (bound "
              f"{btd_b[name][0]:.4f} ms by {btd_b[name][1]})")

    # The sharded path at n = 5120 on one rank: the update, its chain phase
    # and its panel kernel apart; the kernel's bound and the same tile
    # products as one batched library call.
    fsx = CholFactor(Ls0, panel=P, backend="sharded", mesh=mesh1)
    sh_ms, _ = timed(torch, lambda: fsx.update(Vs), reps=5, warmup=1)
    sh_host, _ = host_timed(torch, lambda: fsx.update(Vs), reps=3)
    chain_ms, _ = timed(torch, stacks_s, reps=3, warmup=1)
    shk_ms, _ = timed(torch, lambda: SH.panel_apply_sharded_cuda(
        Ls0, Ts, Dss, vts, tile_off=0, panel=P), reps=10, warmup=2)
    nt = ns // P
    upper = [(p_, t_) for p_ in range(nt) for t_ in range(p_ + 1, nt)]
    Tcat = torch.stack([Ts[p_, :P, :] for p_, _ in upper])
    Scat = torch.stack([torch.cat([Ls0[p_ * P:(p_ + 1) * P,
                                       t_ * P:(t_ + 1) * P],
                                   vts[p_, :, t_ * P:(t_ + 1) * P]])
                        for p_, t_ in upper])
    shlib_ms, _ = timed(torch, lambda: torch.bmm(Tcat, Scat), reps=10,
                        warmup=2)
    del Tcat, Scat
    sh_bytes, sh_ops = SH.panel_phase_work(ns, ns, P, k, tile_off=0,
                                           storage_dtype=torch.float32)
    b_sh = bound(sh_bytes, sh_ops, "float32")
    print(f"timing sharded n={ns} k={k} panel={P} fp32, one rank, on {card}: "
          f"update {sh_ms:.3f} ms on the card ({sh_host:.3f} ms host clock); "
          f"chain phase {chain_ms:.3f} ms ({nt} diag_block launches and the "
          f"V^T steps), share {chain_ms / sh_ms:.3f}; panel_apply_sharded "
          f"{shk_ms:.3f} ms (plain {psh_ms:.1f} ms, torch.bmm of the same "
          f"{len(upper)} tile products {shlib_ms:.3f} ms, bound "
          f"{b_sh[0]:.4f} ms by {b_sh[1]}: {sh_bytes} bytes, {sh_ops} ops, "
          f"{sh_ops / shk_ms / 1e9:.2f} TFLOP/s)")
    for name, prec in (("fp32", None), ("bf16", "bf16")):
        def run():
            return chol_update_batched(Lf, Vf, method="sharded", mesh=mesh1,
                                       panel=P, precision=prec)
        d_ms, _ = timed(torch, run, reps=3, warmup=1)
        print(f"  chol_update_batched B={nb} n={fb} sharded {name}, one rank:"
              f" {d_ms:.3f} ms on the card")
    print(f"timings done at {time.perf_counter() - t_start:.1f} s")

    # -- 6. the bf16 block chain, two witnesses ----------------------------------
    # A bf16 downdate through four chained 256-row blocks: each block's slab
    # arrives through the bf16-stored result of the block before, so the
    # kernel and its plain version are each held against the float64 chain
    # refactorization of the rounded inputs, and the kernel may be no
    # further from it than the plain version plus 4 units (one flipped
    # stored rounding on each side), as tests/test_torch_cuda.py does.
    Sb, Vb = banded(1, 4, 256, 16)
    vtb = Vb.mT.contiguous()
    Sb = BlockTriDiagStorage(*BT.btd_chain_plain(Sb.diag, Sb.off, vtb,
                                                 sigma=1))
    S16, vt16 = Sb.astype(torch.bfloat16), vtb.bfloat16()
    outs = {
        "kernel": BT.btd_chain_cuda(S16.diag, S16.off, vt16, sigma=-1,
                                    accum_dtype=torch.float32),
        "plain": BT.btd_chain_plain(S16.diag, S16.off, vt16, sigma=-1,
                                    accum_dtype=torch.float32)}
    ad, ao = S16.astype(torch.float64).matrix_blocks()
    vd, vo = vvt_blocks(vt16.mT, 256)
    oracle = BlockTriDiagStorage.from_matrix_blocks(ad - vd, ao - vo)
    u16 = unit_roundoff(torch, torch.bfloat16)

    def chain_units(x, y):
        return max(units(torch, torch.triu(x[0]), torch.triu(y[0]), u16),
                   units(torch, x[1], y[1], u16))

    orc = (oracle.diag, oracle.off)
    e_k, e_p = (chain_units(outs[w], orc) for w in ("kernel", "plain"))
    ok = e_k <= e_p + 4.0 and all(bool(torch.isfinite(x).all())
                                  for o in outs.values() for x in o)
    print(f"bf16 block chain B=1 nb=4 b=256 k=16 downdate: kernel vs plain "
          f"{chain_units(outs['kernel'], outs['plain']):.3f} u (reported); "
          f"kernel vs f64 chain {e_k:.3f} u, plain vs f64 chain {e_p:.3f} u "
          f"(limit: plain's + 4)  {'ok' if ok else 'FAIL'}")
    check(ok, "bf16 block chain: the kernel is further from the f64 chain "
          "than its plain version plus 4 units")

    kernels = [{
        "name": "fused_chain",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_chain.cu",
        "replaces": "src/repro/kernels/fused.py:328",
        "launches": main_launches["fused_chain"],
        "max_abs_err": max_err["fused_chain"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    panel_src = "src/repro_torch/kernels/csrc/panel_kernels.cu"
    for name, line, t_ms, p_ms, bnd, lib in (
            ("diag_block", 282, diag_ms, pdiag_ms, b_diag, None),
            ("panel_apply_gemm", 224, gemm_ms, pgemm_ms, b_gemm,
             lib_gemm_ms),
            ("panel_apply_paper", 149, pap_ms, ppap_ms, b_pap, None)):
        kernels.append({
            "name": name, "route": "cuda", "source": panel_src,
            "replaces": f"src/repro/kernels/cholupdate.py:{line}",
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": t_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": lib})
    kernels.append({
        "name": "btd_chain", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/btd_chain.cu",
        "replaces": "src/repro/kernels/blocktridiag.py:117",
        "launches": main_launches["btd_chain"],
        "max_abs_err": max_err["btd_chain"],
        "ms": btd_t["fleet fp32"], "plain_ms": btd_plain_ms,
        "bound_ms": btd_b["fleet fp32"][0],
        "bound_by": btd_b["fleet fp32"][1], "library_ms": None})
    kernels.append({
        "name": "panel_apply_sharded", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sharded_panel.cu",
        "replaces": "src/repro/kernels/sharded.py:118",
        "launches": main_launches["panel_apply_sharded"],
        "max_abs_err": max_err["panel_apply_sharded"],
        "ms": shk_ms, "plain_ms": psh_ms, "bound_ms": b_sh[0],
        "bound_by": b_sh[1], "library_ms": shlib_ms})
    for kk in kernels:
        check(kk["launches"] > 0, f"{kk['name']} never launched on its path")
    dist.destroy_process_group()
    shutil.rmtree(store_dir, ignore_errors=True)
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if FAILED:
        print(f"{len(FAILED)} check(s) failed:", *FAILED, sep="\n  ")
        return 1
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
