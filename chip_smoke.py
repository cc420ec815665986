#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Drives the port's dense main path — ``CholFactor.update``/``downdate``
through ``core.api`` and ``core.backends`` to the fused-chain CUDA kernel —
at the paper's size (n = 5000, k = 16, fp32), and a B = 64 fleet through
``chol_update_batched`` in fp32 and bf16. Builds every kernel from the
sources in ``src/repro_torch/kernels/csrc``, holds the kernel against its
plain torch version and against refactorization on the card, checks one
launch per mutation, times the kernel, and prints one JSON line per
result. Any failure exits non-zero; without a CUDA device, or without the
repository's ``src/`` beside this script, it exits non-zero and prints no
result.

Usage: python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12}
BF16_EPS = 2.0 ** -8


class SmokeFailure(AssertionError):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def tol_for(torch, dtype, n):
    """The repo's roundoff budget of a long hyperbolic recurrence."""
    return float(50 * torch.finfo(dtype).eps * n)


def unit_roundoff(torch, dtype):
    return float(torch.finfo(dtype).eps) / 2


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
    """Limit on ``entry_err`` for the kernel against its plain version, and
    for a bf16 result against the float64 refactorization of its (rounded)
    inputs. fp32/f64: 4 n, as the rounding of a downdate grows with n,
    while a 1 % error in an entry of typical size is 8.4e4 fp32 units.
    bf16: 4, as its arithmetic is fp32 and only a stored rounding (2 units)
    may flip. The values this script measures against these limits are in
    PERF.md."""
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
    from repro_torch.core import (CholFactor, blocked, chol_update_batched,
                                  chol_update_dense, modify_error)
    from repro_torch.kernels import _build
    from repro_torch.kernels import fused as F

    # fp32 matmuls (the plain version's GEMM apply, problem set-up) in full
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

    # -- 2. kernel vs plain, small cases --------------------------------------
    dtypes = [(torch.float32, None), (torch.bfloat16, torch.float32),
              (torch.float64, None)]
    cases = [(1, n, P, k, s, pa, dt)
             for n, P, k, s, pa, dt in itertools.product(
                 (100, 256), (32, 64), (1, 16), (1, -1), ("gemm", "paper"),
                 dtypes)]
    # The fleet cases take k = 32, the kernel's widest rotation bucket.
    cases += [(3, 100, 32, 32, s, pa, dt) for s, pa, dt in itertools.product(
        (1, -1), ("gemm", "paper"), dtypes)]
    print(f"phase 2: kernel vs plain, {len(cases)} cases; errors in units "
          f"of the storage dtype's roundoff (entry_err)")
    for i, (B, n, P, k, sigma, pa, (dt, acc)) in enumerate(cases):
        grid_mode = F.GRID_MODES[i % 2]
        name = str(dt)[6:]
        L, V = spd_factor(B, n, k, dt, sigma)
        Lk = F.chol_update_fused(L, V, sigma=sigma, panel=P, panel_apply=pa,
                                 grid_mode=grid_mode,
                                 precision="bf16" if acc else None)
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
        ok = err <= lim and o_err <= o_tol and bool(torch.isfinite(Lk).all())
        print(f"  B={B} n={n} panel={P} k={k} sigma={sigma:+d} {pa:5s} "
              f"{grid_mode:7s} {name:8s} vs plain {err:.3f} u (limit {lim:g})"
              f"  vs oracle {o_err:.3e} (limit {o_tol:.3e})"
              f"  {'ok' if ok else 'FAIL'}")
        check(ok, f"phase 2 case {i} disagrees")

    # -- 3 + 4. the main path: counts from 0, read right after ---------------
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

    F.LAUNCHES.reset()
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
    main_launches = F.LAUNCHES.count
    print(f"main path launches: update {per_update}, downdate "
          f"{per_downdate}, fleet fp32 {fleet['fp32_launches']}, fleet bf16 "
          f"{fleet['bf16_launches']}, total {main_launches}")
    check(per_update == 1 and per_downdate == 1,
          "the factor's update/downdate did not take exactly one launch")
    check(fleet["fp32_launches"] == 1 and fleet["bf16_launches"] == 1,
          "a fleet update did not take exactly one launch")

    L0, L1, L2 = (f.data.double() for f in (f0, f1, f2))
    Vd = V.double()
    A_scale = float((L0.mT @ L0 + Vd @ Vd.mT).abs().max())
    rel_mod = float(modify_error(L1, L0, Vd, sigma=1)) / A_scale
    rel_trip = float((L2 - L0).abs().max() / L0.abs().max())
    bound = n * torch.finfo(torch.float32).eps
    A_tilde = (L0.mT @ L0 + Vd @ Vd.mT).float()
    L_lib = torch.linalg.cholesky(A_tilde).mT.double()
    rel_lib = float(modify_error(L_lib, L0, Vd, sigma=1)) / A_scale
    print(f"main path n={n} k={k} fp32: relative modify_error {rel_mod:.3e} "
          f"(refactorization in fp32: {rel_lib:.3e}), round trip "
          f"{rel_trip:.3e}, bound n*eps = {bound:.3e}")
    check(bool(torch.isfinite(L1).all() and torch.isfinite(L2).all()),
          "main path produced non-finite values")
    check(bool(f1.is_valid()) and bool(f2.is_valid()), "invalid factor")
    check(rel_mod <= bound and rel_trip <= bound,
          "main path error above n*eps")

    Lf_d, Vf_d = Lf.double(), Vf.double()
    A_f = Lf_d.mT @ Lf_d + Vf_d @ Vf_d.mT
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
            oracle = chol_update_dense(Lf.bfloat16().double(),
                                       Vf.bfloat16().double())
            err = entry_err(torch, out, oracle, BF16_EPS)
            lim = entry_limit(torch, torch.bfloat16, fb)
            del oracle
            what = "entry_err (u) vs f64 refactorization"
        print(f"fleet B={nb} n={fb} k={kb} {name}: worst member {what} "
              f"{err:.3e} (limit {lim:.3e})")
        check(err <= lim, f"fleet {name} error above its limit")

    # -- kernel vs plain at the main path's shapes (not counted) -------------
    # The downdate first, so that Lp, vt are the update's for the timings.
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
        print(f"kernel vs plain at n={n}, sigma={sigma:+d}: {err_u:.3f} u "
              f"(limit {main_lim:g}), max abs {main_err:.3e}, plain "
              f"{plain_ms:.1f} ms")
        check(err_u <= main_lim, f"kernel disagrees with plain at n={n}")
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
        print(f"kernel vs plain, fleet {name}: {err:.3f} u (limit {lim:g})")
        check(err <= lim, f"kernel disagrees with plain on the {name} fleet")

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
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS["float32"] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"timing n={n} k={k} panel={P} fp32 on {card}: kernel {ms:.3f} ms "
          f"(paper apply {paper_ms:.3f} ms), plain {plain_ms:.1f} ms, "
          f"cholesky(A + VV^T) {library_ms:.3f} ms")
    print(f"  bytes_per_update {nbytes} -> {nbytes / ms / 1e6:.1f} GB/s; "
          f"ops {ops} -> {ops / ms / 1e9:.1f} GFLOP/s; bound {bound_ms:.4f} "
          f"ms by {bound_by} (bytes {bytes_ms:.4f} ms, ops {ops_ms:.4f} ms); "
          f"share of bound {bound_ms / ms:.4f}")
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

    kernels = [{
        "name": "fused_chain",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_chain.cu",
        "replaces": "src/repro/kernels/fused.py:328",
        "launches": main_launches,
        "max_abs_err": main_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
