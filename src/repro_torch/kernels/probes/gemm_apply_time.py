#!/usr/bin/env python3
"""Times the cascade's transform-GEMM apply on its own, in a process that
starts no process group, and shows the code nvcc made for it.

At n = 5000, k = 16, P = 256, fp32 (the shapes of ``chip_smoke.py``'s
cascade timing, with its T of panel 0 standing in for every panel's): the
19 ``panel_apply_gemm_`` launches of one update back to back, and the same
19 products ``T @ [R; vt]`` as ``torch.matmul`` with TF32 off, each the mean
of 5 calls after one warm-up, measured ``--repeats`` times. Then, for each
``panel_gemm_kernel`` instance of ``csrc/panel_kernels.cu``, nvcc's
``-Xptxas -v`` lines and a digest of its SASS (``cuobjdump -sass``): equal
digests are equal machine code.

``--root`` names the checkout whose ``src/`` is imported and whose kernels
are built (into its own ``build/``), so that two commits can be compared on
one card: run the script once per checkout, alternating, in one session.
Nothing else of the port uses this file; it is a measurement aid.

Usage: python3 src/repro_torch/kernels/probes/gemm_apply_time.py
           [--root CHECKOUT] [--repeats N] [--seed N]
"""
from __future__ import annotations

import argparse
import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path


def timed(torch, fn, reps, warmup):
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


def ptxas_lines(log, kernel):
    """nvcc's -Xptxas -v lines of each entry function named ``kernel``."""
    out, entry = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)", line)
        if m:
            entry = m.group(1)
            continue
        if entry and kernel in entry and ("Used" in line or "spill" in line):
            out.append(f"{entry}: {line.strip()}")
    return out


def sass_digests(lib, kernel):
    """{entry: (lines, sha256 prefix)} of the SASS of each function named
    ``kernel`` in the shared library ``lib``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        if kernel in name:
            code = [ln for ln in body.splitlines() if "/*" in ln]
            out[name.strip()] = (len(code), hashlib.sha256(
                "\n".join(code).encode()).hexdigest()[:16])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[4]))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gemm_apply_time: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from repro_torch.core import blocked
    from repro_torch.kernels import _build
    from repro_torch.kernels import cholupdate as K

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {root}; {card}; torch {torch.__version__}; process group "
          f"initialised: {dist.is_available() and dist.is_initialized()}")
    paths = _build.build_all()
    for line in ptxas_lines(_build.build_logs.get("panel_kernels", ""),
                            "panel_gemm_kernel"):
        print(f"  ptxas {line}")
    digests = sass_digests(paths["panel_kernels"], "panel_gemm_kernel")
    for name, (lines, digest) in (digests or {}).items():
        print(f"  sass {name}: {lines} lines, sha256 {digest}")
    if digests is None:
        print("  sass: cuobjdump not found")

    dev = torch.device("cuda")
    n, k, P = 5000, 16, 256
    rng = np.random.default_rng(args.seed)
    Bm = torch.from_numpy(rng.uniform(size=(n, n)).astype(np.float32)).to(dev)
    V = torch.from_numpy(rng.uniform(size=(n, k)).astype(np.float32)).to(dev)
    L = torch.linalg.cholesky(Bm.mT @ Bm + torch.eye(n, device=dev)
                              ).mT.contiguous()
    del Bm
    Lp, Vp, _ = blocked._pad_to_panels(L[None], V[None], P)
    Lp, vt = Lp.contiguous(), Vp.mT.contiguous()
    _, _, _, T0 = K._diag_block_plain(Lp[0, :P, :P],
                                      vt[0, :, :P].contiguous(), 1, None)
    Lw, vtw = Lp[0].clone(), vt[0].clone()
    starts = range(0, Lw.shape[-1] - P, P)

    def run_apply():
        for r0 in starts:
            K.panel_apply_gemm_(Lw[r0:r0 + P, r0 + P:], vtw[:, r0 + P:], T0)

    S = [torch.cat([Lp[0, r0:r0 + P, r0 + P:], vt[0, :, r0 + P:]])
         for r0 in starts]
    for i in range(args.repeats):
        gemm_ms = timed(torch, run_apply, reps=5, warmup=1)
        lib_ms = timed(torch, lambda: [T0 @ x for x in S], reps=5, warmup=1)
        print(f"  repeat {i}: {len(starts)} panel_apply_gemm launches "
              f"{gemm_ms:.3f} ms, torch.matmul of the same products "
              f"{lib_ms:.3f} ms, ratio {gemm_ms / lib_ms:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
