#!/usr/bin/env python3
"""Times the fused-chain and block-chain kernels on their own, in a clean
process, at the shapes of ``chip_smoke.py``'s timings, and prints a digest
of every output so that two checkouts can be held to the same bits.

Rows (fp32 unless said; k = 16; inputs made from ``--seed`` with numpy,
the same in every checkout):

* fused n = 5000, P = 256: one ``fused_chain_cuda`` launch on the padded
  factor, beside ``torch.linalg.cholesky`` of ``A + V Vᵀ`` (the
  refactorization it competes with);
* fused fleet B = 64, n = 1024, fp32 and bf16: one launch for the fleet;
* smoother b = 4, nb = 8192 (a structured factor the shape of
  ``examples/kalman_smoother.py``'s at T = 8192, V over 8 consecutive
  blocks): one ``btd_chain_cuda`` launch;
* wide block b = 64, nb = 512;
* structured fleet B = 64, b = 16, nb = 512, fp32 and bf16;
* diag_block: the diagonal pass of panel 0 of the n = 5000 factor (one
  ``diag_block`` launch, functional form), and of panel 0 of the B = 64,
  n = 1024 fleet, fp32 and bf16 (one launch for the fleet); its digest
  covers D_new, c, s and T, which are the plain recurrence's bit for bit,
  so it is the same in every checkout whose kernel is right;
* pallas_gemm: one ``CholFactor.update`` of the n = 5000 factor through
  the cascade (20 ``diag_block`` and 19 ``panel_apply_gemm`` launches);
* sharded: one ``CholFactor.update`` through the column-sharded driver on
  one rank (a process group of one, NCCL where there is one, else gloo),
  n = 5120 (the paper's 5000 in whole panels), at the end of the run.

Before the rows, the digest of ``fused_chain_cuda``'s output on small
cases of every kind the kernel takes: fp32, bf16 storage and f64; the gemm
and paper applies; sigma = +1 and -1; panels 100, 37 and 4, k = 1, 16 and
32, one factor and a fleet of 3.

With the fused row, the split of one chain step: the kernel on the
factor's leading tile alone (one diagonal sweep) and on its leading two
tiles (two sweeps, the apply on tile (0, 1) and the flag hand-off between
them), device time, so that apply and hand-off = t(2 tiles) - 2 t(1 tile).

For each row: (a) CUDA events around a loop of launches after a warm-up;
(b) device time from ``torch.profiler`` (``key_averages``), or, where the
profiler shows no device time, a CUDA graph of the launch replayed under
events; and the SHA-256 (16 hex digits) of the kernel's output on the
row's inputs. Then the card's name and power limit.

``--chain-errors`` prints instead, for downdates of wide blocks (fp32 at
b = 256, 320, 512, f64 at b = 600, k = 32; the factors of
``tests/test_torch_cuda.py``'s ``banded``), the block chain kernel's
distance from its plain version and each one's distance from the float64
chain refactorization, in units of the dtype's roundoff (``units``, diag
and off blocks), beside the limit 4 nb b.

``--root`` names the checkout whose ``src/`` is imported and whose kernels
are built (into its own ``build/``), so two commits compare on one card:
run the script once per checkout, alternating, on one machine, and compare
the digests (the fused kernel's are the bit-for-bit check). Nothing else of
the port uses this file; it is a measurement aid.

Usage: python3 src/repro_torch/kernels/probes/chain_time.py
           [--root CHECKOUT] [--reps N] [--seed N] [--only NAME ...]
"""
from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

ROWS = ("fused", "fused fleet fp32", "fused fleet bf16", "smoother", "wide",
        "structured fleet fp32", "structured fleet bf16", "diag_block",
        "diag_block fleet fp32", "diag_block fleet bf16", "pallas_gemm",
        "sharded")


def timed(torch, fn, reps, warmup=1):
    """Milliseconds per call: CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(torch, fn, reps):
    """Device milliseconds per call from ``torch.profiler``, else from a
    CUDA graph of the call replayed under events; and how it was read."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            total_us += (getattr(e, "self_device_time_total", None)
                         or getattr(e, "self_cuda_time_total", 0.0))
    if total_us > 0:
        return total_us / 1e3 / reps, "profiler"
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        fn()
    return timed(torch, graph.replay, reps), "cuda graph"


def digest(torch, *tensors):
    """SHA-256 (16 hex digits) of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8)
                 .cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[4]))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", nargs="*", choices=ROWS, default=list(ROWS))
    ap.add_argument("--chain-errors", action="store_true",
                    help="print wide-block downdate errors and stop")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chain_time: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import CholFactor, blocked
    from repro_torch.kernels import _build
    from repro_torch.kernels import cholupdate as K
    from repro_torch.kernels import blocktridiag as BT
    from repro_torch.kernels import fused as F

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {root}; {card}; torch {torch.__version__}")
    _build.build_all()
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def fused_inputs(B, n, k, P=256):
        Bm = rng.uniform(size=(B, n, n))
        V = rng.uniform(size=(B, n, k))
        Bm = torch.from_numpy(Bm).to(dev)
        A = Bm.mT @ Bm + torch.eye(n, dtype=torch.float64, device=dev)
        L = torch.linalg.cholesky(A).mT.contiguous()
        Vt = torch.from_numpy(V).to(dev)
        Lp, Vp, _ = blocked._pad_to_panels(L, Vt, P)
        inputs[(B, n)] = (L, Vt)
        return Lp.contiguous(), Vp.mT.contiguous(), A + Vt @ Vt.mT

    inputs = {}

    def banded(B, nb, b, k, span):
        """The smoke's banded factor (off-diagonals of a diagonal block
        scaled by 8 / b above b = 8) and V: column c supported inside one
        block pair, anchored in a window of ``span`` blocks (nb for any)."""
        d = rng.uniform(0.2, 1.0, size=(B, nb, b, b))
        eye = np.eye(b)
        d = np.triu(d, 1) * min(1.0, 8.0 / b) + d * eye + 2.0 * eye
        o = 0.3 * rng.uniform(-1.0, 1.0, size=(B, nb - 1, b, b))
        V = np.zeros((B, nb * b, k))
        anchor = rng.integers(span, size=(B, k))
        vals = 0.4 * rng.normal(size=(B, 2 * b, k))
        for m in range(B):
            for c in range(k):
                j = anchor[m, c]
                w = b if j == nb - 1 else 2 * b
                V[m, j * b:j * b + w, c] = vals[m, :w, c]
        t = lambda x: torch.from_numpy(x).to(dev)
        return t(d), t(o), t(V).mT.contiguous()

    if args.chain_errors:
        chain_errors(torch, np, BT, dev)
        return 0

    import itertools

    for (B, n, P, k), prec, pa, sigma in itertools.product(
            ((1, 200, 100, 16), (3, 111, 37, 32), (1, 40, 4, 1)),
            ("fp32", "bf16", "f64"), ("gemm", "paper"), (1, -1)):
        Bm = torch.from_numpy(rng.uniform(size=(B, n, n))).to(dev)
        V = torch.from_numpy(rng.uniform(size=(B, n, k))).to(dev)
        A = Bm.mT @ Bm + torch.eye(n, dtype=torch.float64, device=dev)
        if sigma < 0:
            A = A + V @ V.mT
        L = torch.linalg.cholesky(A).mT.contiguous()
        dt = {"fp32": torch.float32, "bf16": torch.bfloat16,
              "f64": torch.float64}[prec]
        Lp, Vp, _ = blocked._pad_to_panels(L.to(dt), V.to(dt), P)
        out = F.fused_chain_cuda(
            Lp.contiguous(), Vp.mT.contiguous(), sigma=sigma, panel=P,
            panel_apply=pa,
            accum_dtype=torch.float32 if prec == "bf16" else None)
        print(f"digest fused B={B} n={n} P={P} k={k} {prec} {pa} "
              f"sigma={sigma:+d}: sha256 {digest(torch, out)}")

    rows = {}
    if {"fused", "diag_block", "pallas_gemm"} & set(args.only):
        Lp, vt, A_mod = fused_inputs(1, 5000, 16)
        Lp, vt = Lp.float(), vt.float()
        A32 = A_mod[0].float()
    if "fused" in args.only:
        rows["fused"] = (lambda: F.fused_chain_cuda(Lp, vt, sigma=1,
                                                    panel=256),
                         lambda: torch.linalg.cholesky(A32))
    fleet = None
    for prec in ("fp32", "bf16"):
        names = [f"fused fleet {prec}", f"diag_block fleet {prec}"]
        if not set(names) & set(args.only):
            continue
        if fleet is None:
            fleet = fused_inputs(64, 1024, 16)[:2]
        dt = torch.float32 if prec == "fp32" else torch.bfloat16
        Lf, vtf = fleet[0].to(dt), fleet[1].to(dt)
        acc = None if prec == "fp32" else torch.float32
        if names[0] in args.only:
            rows[names[0]] = (lambda Lf=Lf, vtf=vtf, acc=acc:
                              F.fused_chain_cuda(Lf, vtf, sigma=1, panel=256,
                                                 accum_dtype=acc), None)
        if names[1] in args.only:
            Df, vdf = Lf[:, :256, :256], vtf[:, :, :256].contiguous()
            rows[names[1]] = (lambda Df=Df, vdf=vdf, acc=acc: K.diag_block(
                Df, vdf, sigma=1, accum_dtype=acc), None)
    if "diag_block" in args.only:
        D0, vd0 = Lp[0, :256, :256], vt[0, :, :256].contiguous()
        rows["diag_block"] = (lambda: K.diag_block(D0, vd0, sigma=1), None)
    if "pallas_gemm" in args.only:
        L1, V1 = inputs[(1, 5000)]
        fc = CholFactor(L1[0].float(), panel=256, backend="pallas_gemm")
        V1 = V1[0].float()
        rows["pallas_gemm"] = (lambda: fc.update(V1).data, None)
    chains = {"smoother": (1, 8192, 4, 16, 8),
              "wide": (1, 512, 64, 16, 512),
              "structured fleet fp32": (64, 512, 16, 16, 512),
              "structured fleet bf16": (64, 512, 16, 16, 512)}
    for name, (B, nb, b, k, span) in chains.items():
        if name not in args.only:
            continue
        d, o, v = banded(B, nb, b, k, span)
        dt = torch.bfloat16 if name.endswith("bf16") else torch.float32
        acc = torch.float32 if dt == torch.bfloat16 else None
        d, o, v = d.to(dt), o.to(dt), v.to(dt)
        rows[name] = (lambda d=d, o=o, v=v, acc=acc: BT.btd_chain_cuda(
            d, o, v, sigma=1, accum_dtype=acc), None)

    store = None
    if "sharded" in args.only:
        update, store = sharded_update(torch, rng, dev)
        rows["sharded"] = (update, None)
    for name, (kernel, library) in rows.items():
        out = kernel()
        torch.cuda.synchronize()
        outs = out if isinstance(out, tuple) else (out,)
        ev = timed(torch, kernel, args.reps)
        dv, how = device_ms(torch, kernel, args.reps)
        line = (f"{name}: events {ev:.4f} ms, device {dv:.4f} ms ({how}); "
                f"sha256 {digest(torch, *outs)}")
        if library is not None:
            line += (f"; torch.linalg.cholesky {timed(torch, library, args.reps):.4f}"
                     f" ms events, {device_ms(torch, library, args.reps)[0]:.4f}"
                     f" ms device")
        print(line, flush=True)
        if name == "fused":
            step = {}
            for tiles in (1, 2):
                m = 256 * tiles
                La = Lp[:, :m, :m].contiguous()
                va = vt[:, :, :m].contiguous()
                step[tiles] = device_ms(torch, lambda: F.fused_chain_cuda(
                    La, va, sigma=1, panel=256), args.reps)[0]
            rest = step[2] - 2 * step[1]
            print(f"fused chain step (P=256, k=16): sweep {step[1]:.4f} ms; "
                  f"two tiles {step[2]:.4f} ms, so apply (0, 1) and hand-off "
                  f"{rest:.4f} ms, {rest / (step[1] + rest):.3f} of a step",
                  flush=True)
    print(card)
    if store is not None:
        import shutil
        import torch.distributed as dist
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return 0


def sharded_update(torch, rng, dev, n=5120, k=16, P=256):
    """One update of an n x n factor through the column-sharded driver on
    a process group of one rank (NCCL where there is one, else gloo; one
    rank takes no collective); returns the call, whose result is the
    gathered factor, and the process group's store directory."""
    import tempfile
    from datetime import timedelta

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import CholFactor, distributed

    store = tempfile.mkdtemp(prefix="chain_time_")
    dist.init_process_group("nccl" if dist.is_nccl_available() else "gloo",
                            init_method=f"file://{store}/store",
                            world_size=1, rank=0,
                            timeout=timedelta(seconds=120))
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
    Bm = torch.from_numpy(rng.uniform(size=(n, n))).to(dev)
    V = torch.from_numpy(rng.uniform(size=(n, k))).to(dev)
    L = torch.linalg.cholesky(Bm.mT @ Bm + torch.eye(
        n, dtype=torch.float64, device=dev)).mT.contiguous().float()
    f = CholFactor(L, panel=P, backend="sharded", mesh=mesh)
    V = V.float()
    return lambda: distributed.gather(f.update(V).data), store


def chain_errors(torch, np, BT, dev):
    """Downdates of wide-block chains: kernel vs plain, and both vs the
    float64 chain refactorization, units of the dtype's roundoff (max over
    the upper triangles of the diag blocks, and over the off blocks)."""
    from repro_torch.core.structure import BlockTriDiagStorage

    for nb, b, k, seed, dt in ((4, 256, 16, 276, torch.float32),
                               (4, 256, 16, 260, torch.float32),
                               (3, 320, 16, 339, torch.float32),
                               (3, 512, 16, 531, torch.float32),
                               (2, 600, 32, 11, torch.float64)):
        u = float(torch.finfo(dt).eps) / 2

        def units(out, ref):
            out, ref = out.double(), ref.double()
            return float(((out - ref).abs()
                          / (u * (ref.abs() + ref.abs().mean()))).max())

        rng = np.random.default_rng(seed)
        d = rng.uniform(0.2, 1.0, size=(1, nb, b, b))
        d = np.triu(d, 1) * min(1.0, 8.0 / b) + d * np.eye(b) + 2 * np.eye(b)
        o = 0.3 * rng.uniform(-1.0, 1.0, size=(1, nb - 1, b, b))
        V = np.zeros((1, nb * b, k))
        for c in range(k):
            j = int(rng.integers(nb))
            w = b if j == nb - 1 else 2 * b
            V[0, j * b:j * b + w, c] = 0.4 * rng.normal(size=w)
        d, o, V = (torch.from_numpy(x).to(dev) for x in (d, o, V))
        d, o = BT.btd_chain_plain(d, o, V.mT.contiguous(), sigma=1)
        d, o, V = d.to(dt), o.to(dt), V.to(dt)
        vt = V.mT.contiguous()
        try:
            kd, ko = BT.btd_chain_cuda(d, o, vt, sigma=-1)
        except ValueError as err:  # a checkout that refuses the block
            print(f"chain errors nb={nb} b={b}: {err}", flush=True)
            continue
        pd, po = BT.btd_chain_plain(d, o, vt, sigma=-1)
        S = BlockTriDiagStorage(d, o).astype(torch.float64)
        ad, ao = S.matrix_blocks()
        Vb = V.double().reshape(1, nb, b, k)
        orc = BlockTriDiagStorage.from_matrix_blocks(
            ad - Vb @ Vb.mT, ao - Vb[:, :-1] @ Vb[:, 1:].mT)
        up = torch.triu
        print(f"chain errors nb={nb} b={b} k={k} seed={seed} "
              f"{str(dt)[6:]} downdate: "
              f"kernel vs plain diag {units(up(kd), up(pd)):.1f} off "
              f"{units(ko, po):.1f} (limit {4 * nb * b}); vs f64 chain: "
              f"kernel diag {units(up(kd), up(orc.diag)):.1f} off "
              f"{units(ko, orc.off):.1f}, plain diag "
              f"{units(up(pd), up(orc.diag)):.1f} off "
              f"{units(po, orc.off):.1f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
