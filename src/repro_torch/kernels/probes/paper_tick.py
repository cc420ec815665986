#!/usr/bin/env python3
"""Cycles of the paper apply's wavefront kernel (``panel_kernels.cu``
``panel_paper_kernel``): its ticks and windows, the latencies of the
operations on its chain, and its time at each CTA size.

* ``clock``: builds a copy of the kernel with ``clock64`` stamps (thread 0
  of CTA 0: the prologue, each window's staging and its ticks, the
  epilogue) into ``build/paper_tick/`` and prints them for one fp32
  apply at P = 256, k = 16 (w = 4864 and 256) and k = 1 (w = 256), with
  the SM clock the kernel ran at (its cycles over its device time).
* ``chain``: one warp's dependent chains of FFMA, FADD, a shuffle and an
  add, two such chains interleaved, and ``__fdiv_rn``, in cycles a link.
* ``warps``: device µs of one apply at each CTA size (4, 8 and 16 warps)
  beside ``_launch.paper_warps``' pick, k = 1, 16 and 32, the widths of
  the n = 5000 cascade and the B = 64 fleet, and whether each size's
  result equals the plain version's.

Device times are CUDA graphs of 20 launches replayed under CUDA events
(the profiler's kernel sums read low here in some runs). Rotations come
from a diagonal block's plain recurrence (orthogonal for an update), so
no division takes the exact redo. ``--root`` names the
checkout whose ``src/`` is imported and whose kernel is copied. Nothing of
the port uses this file; it is a measurement aid.

Usage: python3 src/repro_torch/kernels/probes/paper_tick.py
           [--root CHECKOUT] [--only clock chain warps]
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROWS = ("clock", "chain", "warps")

#: What the instrumented copy adds around the kernel's own text: the
#: includes, the helpers the kernel's launcher uses, the chain kernel and
#: the C entry points.
HEAD = r'''#include <cstddef>
#include <cstdint>
#include "chol_tile.cuh"
__device__ long long g_clk[64];
namespace {
using namespace chol_tile;
bool shape_ok(int B, int P, int k, int sigma) {
  return B >= 1 && P >= 1 && P <= kMaxPanel && k >= 1 && k <= kMaxK &&
         (sigma == 1 || sigma == -1);
}
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
}
__global__ void chains(long long* out, float a, float b, int n) {
  float x = threadIdx.x, y = threadIdx.x + 1;
  long long t0 = clock64();
  for (int i = 0; i < n; ++i) x = fmaf(x, a, b);
  long long t1 = clock64();
  for (int i = 0; i < n; ++i) x = __fadd_rn(x, b);
  long long t2 = clock64();
  for (int i = 0; i < n; ++i) x = __shfl_up_sync(0xffffffffu, x, 1, 16) + b;
  long long t3 = clock64();
  for (int i = 0; i < n; ++i) {
    x = __shfl_up_sync(0xffffffffu, x, 1, 16) + b;
    y = __shfl_up_sync(0xffffffffu, y, 1, 16) + a;
  }
  long long t4 = clock64();
  for (int i = 0; i < n; ++i) x = __fdiv_rn(x, a);
  long long t5 = clock64();
  if (threadIdx.x == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
    out[3] = t4 - t3;
    out[4] = t5 - t4;
  }
  if (x == 12345.f && y == 1.f) out[7] = 1;
}
'''
TAIL = r'''}  // namespace
extern "C" void repro_read_clk(long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, g_clk, sizeof(long long) * 64);
}
extern "C" int repro_chains(long long* host, int n) {
  long long* d = nullptr;
  if (cudaMalloc(&d, 64) != cudaSuccess) return 1;
  for (int rep = 0; rep < 3; ++rep) {
    chains<<<1, 32>>>(d, 1.0000001f, 1e-7f, n);
  }
  cudaMemcpy(host, d, 64, cudaMemcpyDeviceToHost);
  cudaFree(d);
  return int(cudaGetLastError());
}
extern "C" int repro_panel_paper(void* R, long long r_bs, int ldr, void* vt,
                                 long long v_bs, int ldv, const void* c,
                                 const void* s, long long cs_bs, int B,
                                 int w, int nw, int P, int k, int sigma,
                                 int dtype, void* stream) {
  return paper_launch<float, float>(R, r_bs, ldr, vt, v_bs, ldv, c, s,
                                    cs_bs, B, w, nw, P, k, sigma,
                                    static_cast<cudaStream_t>(stream));
}
'''
#: (where, stamp) pairs: each stamp goes right before its anchor.
STAMPS = (
    ("  fetch(0);\n  commit(0);",
     "  const bool probe = blockIdx.x == 0 && blockIdx.y == 0 &&\n"
     "                     threadIdx.x == 0;\n"
     "  if (probe) g_clk[0] = clock64();\n"),
    ("  for (int g = 0; g < n_win; ++g) {",
     "  if (probe) g_clk[1] = clock64();\n"),
    ("    const bool more = g + 1 < n_chunks;",
     "    if (probe) g_clk[2 + 3 * g] = clock64();\n"),
    ("      const bool edge = t0 < k - 1 || t1 > P;",
     "      if (probe) g_clk[3 + 3 * g] = clock64();\n"),
    ("      if (__any_sync(0xffffffffu, flagged)) {",
     "      if (probe) g_clk[4 + 3 * g] = clock64();\n"),
    ("  for (int g = max(0, n_win - 2); g < n_chunks; ++g) write_back(g);",
     "  if (probe) g_clk[40] = clock64();\n"),
)


def instrumented_source(csrc: Path) -> str:
    """The paper kernel and its launcher from ``panel_kernels.cu`` with the
    clock stamps; raises if the kernel's text no longer has an anchor."""
    src = (csrc / "panel_kernels.cu").read_text()
    kern = src[src.index("static constexpr int kPaperWin"):
               src.index("template <typename K>\ncudaError_t allow_smem")]
    launch = src[src.index("template <int KP, typename S, typename A>\n"
                           "int paper_kp("):
                 src.index("// Whether bounds holds")]
    for anchor, stamp in STAMPS:
        if anchor not in kern:
            raise RuntimeError(f"paper_tick: anchor not found: {anchor!r}")
        kern = kern.replace(anchor, stamp + anchor, 1)
    return HEAD + kern + launch + TAIL


def build(root: Path):
    """Compile the instrumented copy with the port's nvcc flags."""
    from repro_torch.kernels import _build

    out = root / "build" / "paper_tick"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "paper_tick.cu"
    cu.write_text(instrumented_source(_build.CSRC))
    lib = out / "libpaper_tick.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(lib), str(cu)], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib))
    ptr, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repro_panel_paper.argtypes = ([ptr, ll, i, ptr, ll, i, ptr, ptr, ll]
                                      + [i] * 7 + [ptr])
    lib.repro_panel_paper.restype = i
    lib.repro_read_clk.argtypes = [ctypes.POINTER(ll)]
    lib.repro_chains.argtypes = [ctypes.POINTER(ll), i]
    lib.repro_chains.restype = i
    return lib


def device_us(torch, fn, reps=20):
    """Device µs per call: ``reps`` calls captured in a CUDA graph, the
    graph replayed under CUDA events (no profiler, no host time)."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(reps):
            fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / (5 * reps)


def rotations(torch, K, P, k, dev, seed=0):
    """(c, s) of the diagonal block of a random SPD factor (an update)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = P + 8
    Bm = torch.from_numpy(rng.uniform(size=(n, n))).to(dev)
    V = torch.from_numpy(rng.uniform(size=(n, k))).to(dev)
    L = torch.linalg.cholesky(Bm.mT @ Bm + torch.eye(
        n, dtype=torch.float64, device=dev)).mT.float()
    _, c, s, _ = K._diag_block_plain(L[:P, :P].contiguous(),
                                     V[:P].mT.float().contiguous(), 1, None)
    return c, s


def launch(torch, lib, R, vt, c, s, nw):
    B = R.shape[0] if R.ndim == 3 else 1
    rc = lib.repro_panel_paper(
        R.data_ptr(), R.stride(0) if R.ndim == 3 else 0, R.stride(-2),
        vt.data_ptr(), vt.stride(0) if vt.ndim == 3 else 0, vt.stride(-2),
        c.data_ptr(), s.data_ptr(), 0, B, R.shape[-1], nw, R.shape[-2],
        vt.shape[-2], 1, 0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"paper kernel launch failed: {rc}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve()
                                          .parents[4]))
    ap.add_argument("--only", nargs="+", choices=ROWS, default=ROWS)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))

    import torch

    if not torch.cuda.is_available():
        print("paper_tick: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _launch as LA
    from repro_torch.kernels import cholupdate as K

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"root {root}; {card}; torch {torch.__version__}")
    dev = torch.device("cuda")
    P = 256
    if "clock" in args.only or "chain" in args.only:
        lib = build(root)
    if "clock" in args.only:
        for k, w in ((16, 4864), (16, 256), (1, 256)):
            c, s = rotations(torch, K, P, k, dev)
            R, vt = torch.rand(P, w, device=dev), torch.rand(k, w, device=dev)
            nw = LA.paper_warps(1, w, k, LA.sm_count(dev))
            us = device_us(torch, lambda: launch(torch, lib, R, vt, c, s, nw))
            R2, vt2 = R.clone(), vt.clone()
            wrap = device_us(torch, lambda: K.panel_apply_paper_(
                R2, vt2, c, s, sigma=1))
            out = (ctypes.c_longlong * 64)()
            lib.repro_read_clk(out)
            t = list(out)
            n_win = -(-(P + k - 1) // 32)
            wins = [(t[3 + 3 * g] - t[2 + 3 * g], t[4 + 3 * g] - t[3 + 3 * g])
                    for g in range(n_win)]
            ticks = sum(b for _, b in wins)
            total = t[40] - t[0]
            print(f"clock k={k} w={w} nw={nw}: {total} cycles, {us:.2f} us "
                  f"device ({total / us / 1e3:.3f} GHz; the port's own "
                  f"kernel {wrap:.2f} us); prologue "
                  f"{t[1] - t[0]}; windows (staging, ticks) {wins}; "
                  f"{ticks / (P + k - 1):.1f} cycles a tick")
    if "chain" in args.only:
        n = 4096
        out = (ctypes.c_longlong * 8)()
        if lib.repro_chains(out, n) != 0:
            raise RuntimeError("chain kernel failed")
        names = ("ffma", "fadd", "shfl.up + fadd", "two shfl.up + fadd chains",
                 "__fdiv_rn")
        print("chain cycles a link: " + ", ".join(
            f"{name} {out[j] / n:.2f}" for j, name in enumerate(names)))
    if "warps" in args.only:
        lib = K._lib()
        for k in (16, 1, 32):
            c, s = rotations(torch, K, P, k, dev)
            for B, w in ((1, 4864), (1, 4096), (1, 2560), (1, 1024),
                         (1, 256), (64, 768)):
                # Every member takes member 0's rotations (member stride 0).
                R0 = torch.rand(B, P, w, device=dev)
                v0 = torch.rand(B, k, w, device=dev)
                ref = K._paper_plain(R0[0], v0[0], c, s, 1, None) \
                    if w <= 1024 and B == 1 else None
                got = []
                for nw in LA.PAPER_WARPS[::-1]:
                    R, vt = R0.clone(), v0.clone()
                    us = device_us(torch, lambda: launch(torch, lib, R, vt,
                                                         c, s, nw))
                    R, vt = R0.clone(), v0.clone()
                    launch(torch, lib, R, vt, c, s, nw)
                    same = "" if ref is None else (
                        " equal" if torch.equal(R[0], ref[0]) and
                        torch.equal(vt[0], ref[1]) else " DIFFERS")
                    got.append(f"nw {nw} {us:.2f}{same}")
                pick = LA.paper_warps(B, w, k, LA.sm_count(dev))
                print(f"warps k={k} B={B} w={w}: rule {pick}; us " +
                      ", ".join(got))
    return 0


if __name__ == "__main__":
    sys.exit(main())
