#!/usr/bin/env python3
"""Times the two transform-GEMM kernels on their own, in a process that
starts no process group, beside one PyTorch call computing the same
products, and shows the code nvcc made for them.

* The cascade's apply at n = 5000, k = 16, P = 256, fp32 (the shapes of
  ``chip_smoke.py``'s cascade timing, with its T of panel 0 standing in for
  every panel's): the 19 ``panel_apply_gemm_`` launches of one update back
  to back, against the same 19 products ``T @ [R; vt]`` as
  ``torch.matmul``.
* The sharded panel phase at n = 5120, k = 16, P = 256, fp32, one shard:
  one ``panel_apply_sharded_cuda`` launch (190 upper tiles), against
  ``torch.bmm`` of the same 190 tile products ``T[:P] @ [L; vt]``.

* The paper's element-wise apply at the cascade's shapes, with the
  rotations (c, s) of panel 0: the 19 ``panel_apply_paper_`` launches of
  one update back to back (no PyTorch call computes them), a SHA-256
  of the factor and V^T after one pass from the same start, beside the
  plain version's (equal in a checkout whose kernel is bit for bit), and
  the device time of the widest and the narrowest apply alone.

TF32 is off. For each side three numbers: (a) CUDA events around a loop
of calls after a warm-up; (b) device time only: the kernels' own time from
``torch.profiler`` (``key_averages``), or, where the profiler shows no
device time, a CUDA graph of the calls replayed under events; (c) host
microseconds per wrapper or library call, enqueue only. Then, for
``panel_gemm_kernel``, ``sharded_panel_kernel``, ``panel_paper_kernel``,
``diag_block_kernel``, ``fused_chain_kernel`` and the block-chain kernels
(``btd_*``), nvcc's ``-Xptxas -v`` lines and a digest of each instance's
SASS (``cuobjdump -sass``): equal digests are equal machine code.

``--root`` names the checkout whose ``src/`` is imported and whose kernels
are built (into its own ``build/``), so that two commits can be compared on
one card: run the script once per checkout, alternating, in one session.
Nothing else of the port uses this file; it is a measurement aid.

``--splits`` times each of the 19 applies alone with the K split forced to
1, 2 and 4 CTAs a cluster (device time), beside the split the wrapper
picks.

After the cascade's readings comes the wrappers' host trim that replaces
a lookup by a kept value: the launch counter kept by
``metrics.held_counter`` against ``metrics.counter``'s registry lookup,
timed alone, and the 19 applies' host time per call with it and without
it, in turns.

Row ``p4``: the gemm apply's error in units of roundoff on the fp32
downdate draw that ``tests/test_torch_cuda.py`` rebuilds from
``chip_smoke.py`` (``smoke_p4_draw``: B = 2, P = 4, k = 16, w = 64), R and
vt, against the 4·P = 16 limit that test holds.

``--only`` takes a subset of the rows (``gemm``, ``paper``, ``sharded``,
``p4``); the code is shown in every run.

Usage: python3 src/repro_torch/kernels/probes/gemm_apply_time.py
           [--root CHECKOUT] [--repeats N] [--seed N] [--splits]
           [--only ROW ...]
"""
from __future__ import annotations

import argparse
import hashlib
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

#: (library, kernel) pairs whose registers and SASS are shown.
KERNELS = (("panel_kernels", "panel_gemm_kernel"),
           ("sharded_panel", "sharded_panel_kernel"),
           ("panel_kernels", "panel_paper_kernel"),
           ("panel_kernels", "diag_block_kernel"),
           ("fused_chain", "fused_chain_kernel"),
           ("btd_chain", "btd_"))


#: The probe's rows.
ROWS = ("gemm", "paper", "sharded", "p4")


def timed(torch, fn, reps, warmup):
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
    """Milliseconds per call of device time only, and how it was read: the
    kernels' time summed by ``torch.profiler``, else a CUDA graph of the
    calls replayed under events."""
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
    return timed(torch, graph.replay, reps, 1), "cuda graph"


def host_us(torch, fn, calls_per_fn, reps):
    """Host microseconds per call, enqueue only (no synchronisation inside
    the window)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / (reps * calls_per_fn)


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


#: Opcodes counted in the SASS of the two GEMM kernels: the multiply-adds,
#: the shared loads that feed them (LDS; a generic LD would mean the shared
#: window was lost), the asynchronous copies and the barriers.
OPCODES = ("FFMA", "DFMA", "LDS", "LD", "LDG", "LDGSTS", "STS", "BAR")


def sass_digests(lib, kernel):
    """{entry: (lines, sha256 prefix, opcode counts)} of the SASS of each
    function named ``kernel`` in the shared library ``lib``."""
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
            ops = {}
            for ln in code:
                m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)", ln)
                if m and m.group(1) in OPCODES:
                    ops[m.group(1)] = ops.get(m.group(1), 0) + 1
            out[name.strip()] = (len(code), hashlib.sha256(
                "\n".join(code).encode()).hexdigest()[:16], ops)
    return out


def report(torch, label, kernel_fn, lib_fn, calls, repeats):
    """The three readings of a kernel and of its library yardstick."""
    for i in range(repeats):
        k_ms = timed(torch, kernel_fn, reps=5, warmup=1)
        l_ms = timed(torch, lib_fn, reps=5, warmup=1)
        print(f"  {label} repeat {i}: (a) events: kernel {k_ms:.4f} ms, "
              f"library {l_ms:.4f} ms, ratio {k_ms / l_ms:.2f}")
    kd, how = device_ms(torch, kernel_fn, reps=5)
    ld, lhow = device_ms(torch, lib_fn, reps=5)
    print(f"  {label}: (b) device only: kernel {kd:.4f} ms ({how}), "
          f"library {ld:.4f} ms ({lhow}), ratio {kd / ld:.2f}")
    kh = host_us(torch, kernel_fn, calls, reps=20)
    lh = host_us(torch, lib_fn, calls, reps=20)
    print(f"  {label}: (c) host per call: wrapper {kh:.2f} us, library "
          f"{lh:.2f} us ({calls} calls a round)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[4]))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--splits", action="store_true",
                    help="time every cascade apply at K splits 1, 2, 4")
    ap.add_argument("--only", nargs="+", choices=ROWS, default=ROWS,
                    help="the rows to run (default all)")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gemm_apply_time: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from repro_torch.core import blocked, distributed
    from repro_torch.kernels import _build
    from repro_torch.kernels import cholupdate as K
    from repro_torch.kernels import sharded as SH

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {root}; {card}; torch {torch.__version__}; process group "
          f"initialised: {dist.is_available() and dist.is_initialized()}")
    paths = _build.build_all()
    for lib, kernel in KERNELS:
        for line in ptxas_lines(_build.build_logs.get(lib, ""), kernel):
            print(f"  ptxas {line}")
        digests = sass_digests(paths[lib], kernel)
        if digests is None:
            print("  sass: cuobjdump not found")
        for name, (lines, digest, ops) in (digests or {}).items():
            shown = (" " + " ".join(f"{o}={ops[o]}" for o in OPCODES
                                    if o in ops)
                     if "gemm" in kernel or "sharded" in kernel else "")
            print(f"  sass {name}: {lines} lines, sha256 {digest}{shown}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def factor(n, k):
        Bm = torch.from_numpy(rng.uniform(size=(n, n)).astype(np.float32)
                              ).to(dev)
        V = torch.from_numpy(rng.uniform(size=(n, k)).astype(np.float32)
                             ).to(dev)
        L = torch.linalg.cholesky(Bm.mT @ Bm + torch.eye(n, device=dev)
                                  ).mT.contiguous()
        return L, V

    # The cascade's 19 applies of one update at n = 5000.
    n, k, P = 5000, 16, 256
    L, V = factor(n, k)
    Lp, Vp, _ = blocked._pad_to_panels(L[None], V[None], P)
    Lp, vt = Lp.contiguous(), Vp.mT.contiguous()
    _, _, _, T0 = K._diag_block_plain(Lp[0, :P, :P],
                                      vt[0, :, :P].contiguous(), 1, None)
    starts = range(0, Lp.shape[-1] - P, P)

    if "p4" in args.only:
        p4_row(torch, K, root, dev)
    if "paper" in args.only:
        paper_row(torch, K, Lp, vt, P, starts, args.repeats)
    if "gemm" in args.only:
        gemm_row(torch, K, Lp, vt, T0, P, k, starts, args)
    del L, V, Lp, Vp, vt
    if "sharded" in args.only:
        sharded_row(torch, SH, distributed, factor, P, k, args.repeats)
    return 0


def p4_row(torch, K, root, dev):
    """The gemm apply's units on the rebuilt P = 4 draw (the test's
    measure: each member's entries over its mean magnitude). The draw
    comes from this probe's own checkout's tests, the kernel from
    ``root``'s."""
    here = Path(__file__).resolve().parents[4]
    sys.path.insert(0, str(here / "tests"))
    from test_torch_cuda import smoke_p4_draw

    Bm, V = (torch.from_numpy(x).to(dev) for x in smoke_p4_draw())
    n, P = Bm.shape[-1], 4
    A = Bm.mT @ Bm + torch.eye(n, dtype=torch.float64, device=dev)
    L = torch.linalg.cholesky(A + V @ V.mT).mT.contiguous().float()
    V = V.float()
    _, _, _, T = K._diag_block_plain(L[:, :P, :P], V[:, :P].mT.contiguous(),
                                     -1, None)
    R, vt = L[:, :P, P:], (0.1 * V[:, P:].mT).float()
    got = []
    for x, y in zip(K.panel_apply_gemm(R, vt, T), K._gemm_plain(R, vt, T,
                                                                 None)):
        x, y = x.double(), y.double()
        floor = y.abs().mean(dim=(-2, -1), keepdim=True)
        got.append(float(((x - y).abs() / (2.0 ** -24 * (y.abs() + floor)))
                         .max()))
    print(f"p4 draw (B=2 P=4 k=16 w=64 fp32 downdate), gemm apply of {root}:"
          f" R {got[0]:.3f} vt {got[1]:.3f} units (limit {4 * P})")


def paper_row(torch, K, Lp, vt, P, starts, repeats):
    """The cascade's 19 paper applies of one update back to back, with
    panel 0's rotations: events, device time, host time, the output's
    digest beside the plain version's, and the widest and narrowest apply
    alone."""
    _, c0, s0, _ = K._diag_block_plain(Lp[0, :P, :P],
                                       vt[0, :, :P].contiguous(), 1, None)
    Lw, vtw = Lp[0].clone(), vt[0].clone()

    def run(apply=K.panel_apply_paper_):
        for r0 in starts:
            apply(Lw[r0:r0 + P, r0 + P:], vtw[:, r0 + P:], c0, s0, sigma=1)

    def plain_(R, v, c, s, sigma):
        out = K._paper_plain(R, v, c, s, sigma, None)
        R.copy_(out[0])
        v.copy_(out[1])

    digests = {}
    for name, apply in (("kernel", K.panel_apply_paper_), ("plain", plain_)):
        Lw.copy_(Lp[0])
        vtw.copy_(vt[0])
        run(apply)
        torch.cuda.synchronize()
        digests[name] = hashlib.sha256(
            Lw.cpu().numpy().tobytes() + vtw.cpu().numpy().tobytes()
        ).hexdigest()[:16]
    print(f"paper cascade n={Lp.shape[-1]} P={P} k={vt.shape[-2]} fp32: "
          f"{len(starts)} panel_apply_paper launches; digest kernel "
          f"{digests['kernel']}, plain {digests['plain']}, equal "
          f"{digests['kernel'] == digests['plain']}")
    for i in range(repeats):
        print(f"  paper repeat {i}: (a) events {timed(torch, run, 5, 1):.4f}"
              f" ms")
    d_ms, how = device_ms(torch, run, reps=5)
    print(f"  paper: (b) device only {d_ms:.4f} ms ({how}); (c) host per "
          f"call {host_us(torch, run, len(starts), reps=20):.2f} us")
    one = []
    for r0 in (starts[0], starts[-1]):
        R, v = Lw[r0:r0 + P, r0 + P:], vtw[:, r0 + P:]
        t_ms, _ = device_ms(torch, lambda: K.panel_apply_paper_(
            R, v, c0, s0, sigma=1), reps=20)
        one.append(f"{R.shape[-1]}:{t_ms * 1e3:.2f}")
    print("  paper per apply alone, width:device us: " + " ".join(one))


def gemm_row(torch, K, Lp, vt, T0, P, k, starts, args):
    """The cascade's 19 gemm applies against torch.matmul."""
    dev = Lp.device
    n = Lp.shape[-1]
    Lw, vtw = Lp[0].clone(), vt[0].clone()

    def run_apply():
        for r0 in starts:
            K.panel_apply_gemm_(Lw[r0:r0 + P, r0 + P:], vtw[:, r0 + P:], T0)

    S = [torch.cat([Lp[0, r0:r0 + P, r0 + P:], vt[0, :, r0 + P:]])
         for r0 in starts]
    print(f"cascade n={n} k={k} P={P} fp32: {len(starts)} panel_apply_gemm "
          f"launches against torch.matmul of the same products")
    report(torch, "cascade", run_apply, lambda: [T0 @ x for x in S],
           len(starts), args.repeats)
    per = []
    for r0, x in zip(starts, S):
        R, v = Lw[r0:r0 + P, r0 + P:], vtw[:, r0 + P:]
        k_ms = timed(torch, lambda: K.panel_apply_gemm_(R, v, T0), 20, 2)
        l_ms = timed(torch, lambda: T0 @ x, 20, 2)
        per.append(f"{R.shape[-1]}:{k_ms * 1e3:.1f}/{l_ms * 1e3:.1f}")
    print("  cascade per apply, width:kernel/torch.matmul us (events, 20 "
          "back to back): " + " ".join(per))
    if args.splits:
        # Device time of each apply with the K split forced to 1, 2 and 4
        # CTAs a cluster: the data behind _launch.gemm_split's choice.
        chosen, rows = K.gemm_split, []
        try:
            for r0 in starts:
                R, v = Lw[r0:r0 + P, r0 + P:], vtw[:, r0 + P:]
                got = []
                for split in (1, 2, 4):
                    K.gemm_split = lambda *a, _s=split: _s
                    got.append(device_ms(torch, lambda: K.panel_apply_gemm_(
                        R, v, T0), reps=10)[0] * 1e3)
                K.gemm_split = chosen
                pick = chosen(1, R.shape[-1], P, k,
                              K._gemm_capacity(dev, 0))
                rows.append(f"{R.shape[-1]}:" + "/".join(
                    f"{x:.1f}" for x in got) + f"(s{pick})")
        finally:
            K.gemm_split = chosen
        print("  cascade per apply, width:split 1/2/4 device us (chosen "
              "split): " + " ".join(rows))
    held_counter_cost(torch, run_apply, len(starts))


def sharded_row(torch, SH, distributed, factor, P, k, repeats):
    """The sharded panel phase at n = 5120 on one shard against
    torch.bmm."""
    n = 5120
    L, V = factor(n, k)
    vts = V.mT.contiguous()
    Ts, Ds, vs = distributed._chain_phase(
        L, vts, sigma=1, panel=P, w_loc=n, me=0, mesh=None, dims=[],
        acc=torch.float32)
    nt = n // P
    upper = [(p, t) for p in range(nt) for t in range(p + 1, nt)]
    Tcat = torch.stack([Ts[p, :P, :] for p, _ in upper])
    Scat = torch.stack([torch.cat([L[p * P:(p + 1) * P, t * P:(t + 1) * P],
                                   vs[p, :, t * P:(t + 1) * P]])
                        for p, t in upper])
    print(f"sharded n={n} k={k} P={P} fp32, one shard: one "
          f"panel_apply_sharded launch against torch.bmm of the same "
          f"{len(upper)} tile products")
    report(torch, "sharded",
           lambda: SH.panel_apply_sharded_cuda(L, Ts, Ds, vs, tile_off=0,
                                               panel=P),
           lambda: torch.bmm(Tcat, Scat), 1, repeats)


def held_counter_cost(torch, run_apply, calls):
    """The kept launch counter alone (us a lookup) and the 19 applies'
    host us per call with it and without it, in turns. A checkout without
    it prints that it has none."""
    import timeit

    from repro_torch.obs import metrics

    if not hasattr(metrics, "held_counter"):
        print("  held counter: none in this checkout")
        return
    labels = dict(module="cholupdate", kernel="panel_apply_gemm", panel=256)
    n = 100000
    alone = {
        "counter": lambda: metrics.counter("repro.kernels.launches",
                                           **labels),
        "held_counter": lambda: metrics.held_counter(
            "repro.kernels.launches", **labels),
    }
    print("  held counter alone, us a lookup: " + ", ".join(
        f"{name} {timeit.timeit(fn, number=n) / n * 1e6:.3f}"
        for name, fn in alone.items()))
    held = metrics.held_counter
    got = {"with": [], "without": []}
    try:
        for _ in range(3):
            for mode in ("with", "without"):
                metrics.held_counter = held if mode == "with" else \
                    metrics.counter
                got[mode].append(host_us(torch, run_apply, calls, reps=50))
    finally:
        metrics.held_counter = held
    print("  held counter, 19 applies, host us per call: " + "; ".join(
        f"{mode} " + " ".join(f"{x:.2f}" for x in v)
        for mode, v in got.items()))


if __name__ == "__main__":
    sys.exit(main())
