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
  results are held against the one-rank results;
* the stream stack (``StreamService`` -> ``FactorStore`` -> CUDA graphs of
  the fused and block chains): a dense n = 1024 fleet (fp32 and bf16) and a
  structured B = 64, b = 16, nb = 512 fleet over the ladder (64, 128),
  warmed, then served inside the retrace guard with a checkpoint and a
  restore in the same process; replays held bit for bit to the eager
  calls, the restored fleet to the live one, every member to the float64
  matrix it should hold; the Chrome trace written to
  ``chiprun_out/stream_trace.json``.
* gradients through the update and training (path 3j): ``torch.autograd``
  through ``chol_update`` (the Murray rule around the fused chain) at
  n = 5000 and on the B = 64 fleet (fp32, bf16 storage) and through the
  block chain on the wide block, each against float64 and a central
  difference; then ``cholesky_precond`` training 20 steps on the seven
  weight matrices of one llama3.2-3b layer, its batched factors taking
  scale, update, downdate (the fused chain) and solve every step, held to
  the float64 statistics they should hold.
* the stream store's sharded placement and sharded gradients (path 3k):
  the stream path's dense runs over ``FactorStore(backend='sharded')`` on
  the one-rank mesh (CUDA graphs of ``diag_block`` and
  ``panel_apply_sharded``, the same five checks), gradients through
  ``method='sharded'`` at n = 5120 and on the B = 64 fleet, and, in the
  four-rank spawn, a sharded store's traffic, checkpoints restored across
  rank counts and gradients, each against one rank.
* the LM serving path (path 3l): ``launch.serve.generate`` on full-width
  h2o-danube-1.8b (bf16, batch 8, prompt 32, 64 sampled tokens; plain
  torch, no repo kernel) with its step times beside the HBM bound, decode
  against forward at full width, the nine decoder-only architectures at
  ``reduced()`` on the card against the CPU, and ``serve_lm``'s
  personalization sidecar over the generated tokens, each flush's
  ``fused_chain`` launches held to its budget.
* the training path (path 3m): ``launch.train.build`` and its step on
  full-width llama3.2-3b (bf16, remat, batch 8, seq 128, 20 steps of
  ``cholesky_precond``: three ``fused_chain`` launches a step, the three
  leaves of the JAX package's values tree that take a factor) with its
  step times, tokens/s, share of the card's peak, the share of
  ``opt.update`` and of its factored leaves, and peak memory beside the
  free memory checked before it; ``examples/train_lm`` at ``reduced()``
  (200 steps, one launch a step) and its resume; the encoder-decoder
  family at ``reduced()`` on the card against the CPU.
* the roofline and the dry run (path 3n): one more path 3m step under the
  per-device op counter (``roofline.opcount``, memory tracked) against the
  same cell traced on the meta device (equal dot FLOPs, its three
  ``fused_chain`` launches), its roofline terms beside path 3m's step
  time; and ``python -m repro_torch.launch.dryrun`` on the fake 16x16
  world of 256 ranks for full-size llama3.2-3b ``train_4k
  --optimizer cholesky_precond`` and ``decode_32k`` and arctic-480b
  ``train_4k`` (its MoE expert-parallel), traced on the host's
  CPU in subprocesses started after every timed phase before them (beside
  path 3m's untimed checks) and read before the kernels are timed, each
  record printed.

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
import atexit
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types
import warnings
from datetime import timedelta

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W). The two
# transform-GEMM kernels run fp32 products as 3xTF32 on the tensor cores,
# three TF32 MMAs a product: their rate is the TF32 peak over three.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 67e12,
            "3xtf32": 495e12 / 3}
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


def _sharded_rank(d, root, seed):
    """One of four gloo ranks sharing the card (``run_gloo_ranks``): the
    sharded driver through the entry points on the inputs in ``d``, then
    its kernels against their plain versions on the rank's own shard
    (``_rank_kernel_checks``), then path 3k (iii) (the sharded store's
    traffic and its checkpoint into ``root``/ckpt4, the one-rank
    checkpoint ``root``/ckpt1 restored onto the four ranks, gradients
    through ``method='sharded'``). Rank 0 saves the gathered results;
    every rank saves the kernel launches each case took on it and its
    kernel checks. Any error ends the process non-zero."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import api, distributed
    from repro_torch.kernels import cholupdate as K
    from repro_torch.kernels import sharded as SH
    from repro_torch.stream import restore_service

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
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
    fleet, verdicts, pending, mode = small_store_traffic(
        torch, np, mesh, seed, f"{root}/ckpt4")
    back = restore_service(f"{root}/ckpt1", mesh=mesh, device="cuda")
    back_fleet = distributed.gather(back.store.factor.data)
    gL, gV = sharded_grads(torch, mesh, inp["Lf"][:SMALL_STORE[1]],
                           inp["Vf"][:SMALL_STORE[1]])
    if rank == 0:
        torch.save({"fleet": fleet.cpu(), "restored1": back_fleet.cpu(),
                    "gL": gL.cpu(), "gV": gV.cpu()},
                   f"{root}/store4.pt")
    with open(f"{d}/counts{rank}.json", "w") as f:
        json.dump({"counts": counts, "checks": checks,
                   "store": {"verdicts": verdicts, "pending": pending,
                             "mode": mode,
                             "restored_pending": back.pending("u0")}},
                  f)


def run_four_ranks(torch, inputs, timeout, root, seed):
    """Run ``_sharded_rank`` on four gloo ranks sharing the card
    (``runtime.compat.run_gloo_ranks``, which raises unless all four exit
    0). Returns rank 0's gathered results, each rank's launch counts, each
    rank's kernel checks and each rank's store readings of path 3k
    (iii)."""
    from repro_torch.runtime.compat import run_gloo_ranks

    d = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        torch.save({name: x.cpu() for name, x in inputs.items()},
                   f"{d}/inputs.pt")
        run_gloo_ranks(4, _sharded_rank, (d, root, seed), timeout=timeout)
        saved = []
        for r in range(4):
            with open(f"{d}/counts{r}.json") as f:
                saved.append(json.load(f))
        return (torch.load(f"{d}/results.pt"),
                [x["counts"] for x in saved], [x["checks"] for x in saved],
                [x["store"] for x in saved])
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


# -- the stream phase (path 3i) -----------------------------------------------
#
# The port's serving stack on the card: StreamService.push / tick / flush ->
# FactorStore.apply -> a CUDA graph per (step, rung, width) -> CholFactor
# update / guarded downdate -> the fused_chain kernel (dense fleets) or the
# btd_chain kernel (structured fleets).

#: (name, structure, precision, n, block, ticks, window, checkpoint tick,
#: promote tick, decay tick, evict tick, infeasible tick) of each run.
STREAM_RUNS = (
    ("dense fp32", "dense", None, 1024, None, 72, 32, 40, 21, 30, 33, 46),
    ("dense bf16", "dense", "bf16", 1024, None, 72, 32, 40, 21, 30, 33, 46),
    ("structured fp32", "blocktridiag", None, 8192, 16, 36, 16, 24, 13, 17,
     19, 26),
)
STREAM_WIDTH, STREAM_LADDER, STREAM_PANEL, STREAM_DEADLINE = 16, (64, 128), \
    256, 4
#: Path 3k (i): the dense runs over a sharded store on the one-rank mesh.
SHARDED_STREAM_RUNS = tuple((f"sharded {r[0]}",) + r[1:] for r in STREAM_RUNS
                            if r[1] == "dense")


class StreamShadow:
    """The float64 statistics each fleet member should hold, fed with what
    the store consumed (the blocks ``apply`` staged, its verdicts, decay,
    admissions), and the budget of its relative ``modify_error``: each
    mutation of a member may add ``per_mut`` times the largest entry of the
    member's matrix after it (PERF.md §6, the stream limit)."""

    def __init__(self, torch, store, per_mut, round_bf16):
        self.torch, self.store = torch, store
        self.per_mut, self.round_bf16 = per_mut, round_bf16
        top, n, dev = store.ladder[-1], store.n, store.device
        kw = dict(dtype=torch.float64, device=dev)
        if store.structure == "blocktridiag":
            b = store.block
            nb = n // b
            self.A = [torch.zeros(top, nb, b, b, **kw),
                      torch.zeros(top, nb - 1, b, b, **kw)]
        else:
            self.A = [torch.zeros(top, n, n, **kw)]
        self.budget = torch.zeros(top, **kw)

    def maxabs(self, cap):
        return self.torch.stack(
            [a[:cap].abs().flatten(1).amax(dim=1) for a in self.A]).amax(0)

    def admit(self, s, scale=1.0):
        for a in self.A:
            a[s].zero_()
        self.A[0][s].diagonal(dim1=-2, dim2=-1).fill_(scale)
        self.budget[s] = 0.0

    def modify(self, V, sign, mask):
        torch = self.torch
        cap = V.shape[0]
        V = torch.from_numpy(V).to(self.store.device)
        if self.round_bf16:
            V = V.bfloat16()  # the engine casts V to the storage dtype
        V = V.double()
        touched = (V != 0).flatten(1).any(dim=1) & mask
        m = (sign * mask.double())[:, None, None]
        if self.store.structure == "blocktridiag":
            b = self.store.block
            Vb = V.reshape(cap, V.shape[1] // b, b, V.shape[-1])
            self.A[0][:cap] += m[..., None] * (Vb @ Vb.mT)
            self.A[1][:cap] += m[..., None] * (Vb[:, :-1] @ Vb[:, 1:].mT)
        else:
            self.A[0][:cap] += m * (V @ V.mT)
        self.budget[:cap] += touched.double() * self.per_mut * \
            self.maxabs(cap)

    def scale(self, alpha, active):
        for a in self.A:
            a.mul_(float(alpha) ** 2)
        cap = active.shape[0]
        self.budget[:cap] += active.double() * self.per_mut * \
            self.maxabs(cap)

    def errors(self, slots):
        """Per member in ``slots``: relative modify_error of the fleet's
        factor, its limit, and the factor's distance from the float64
        Cholesky of the member's matrix (relative to its largest entry)."""
        torch, store = self.torch, self.store
        from repro_torch.core import distributed

        idx = torch.as_tensor(slots, device=store.device)
        den = self.maxabs(store.capacity)[idx]
        data = distributed.gather(store.factor.data)
        if store.structure == "blocktridiag":
            from repro_torch.core.structure import BlockTriDiagStorage

            S = BlockTriDiagStorage(data.diag[idx], data.off[idx]).astype(
                torch.float64)
            ad, ao = S.matrix_blocks()
            Ad, Ao = self.A[0][idx], self.A[1][idx]
            num = torch.maximum((ad - Ad).abs().flatten(1).amax(1),
                                (ao - Ao).abs().flatten(1).amax(1))
            ref = BlockTriDiagStorage.from_matrix_blocks(Ad, Ao)
            dist = torch.maximum(
                (S.diag - ref.diag).abs().flatten(1).amax(1),
                (S.off - ref.off).abs().flatten(1).amax(1)) / \
                ref.diag.abs().flatten(1).amax(1)
        else:
            L = data[idx].double()
            A = self.A[0][idx]
            num = (L.mT @ L - A).abs().flatten(1).amax(1)
            ref = torch.linalg.cholesky(A).mT
            dist = (L - ref).abs().flatten(1).amax(1) / \
                ref.abs().flatten(1).amax(1)
        return num / den, self.budget[idx] / den, dist


def _launch_counts():
    """Every kernel wrapper's ``LAUNCHES`` count, by kernel name."""
    from repro_torch.kernels import blocktridiag as BT
    from repro_torch.kernels import cholupdate as K
    from repro_torch.kernels import fused as F
    from repro_torch.kernels import sharded as SH

    counters = {"fused_chain": F.LAUNCHES, "btd_chain": BT.LAUNCHES,
                "panel_apply_sharded": SH.LAUNCHES, **K.LAUNCHES}
    return {name: c.count for name, c in counters.items()}


def _counts_minus(a, *bs):
    return {k: v - sum(b[k] for b in bs) for k, v in a.items()}


def _flush_budget(store, blocks):
    """The launches a flush of ``blocks`` may take, by kernel: a dense
    sign block ceil(w/32) ``fused_chain``, a structured one 1
    ``btd_chain``, a sharded one per 32 columns n / panel ``diag_block``
    and one ``panel_apply_sharded`` (a shard, any fleet size)."""
    from repro_torch.kernels import sharded as SH

    want = {}
    for V in blocks:
        w = V.shape[-1]
        if store.sharded:
            got = SH.kernel_launches(store.n, STREAM_PANEL, strategy="fused",
                                     k=w)
        elif store.structure == "blocktridiag":
            got = {"btd_chain": 1}
        else:
            got = {"fused_chain": -(-w // 32)}
        for k, v in got.items():
            want[k] = want.get(k, 0) + v
    return want


def _stream_run(torch, np, dev, seed, run, ckpt_dir, mesh=None):
    """One fleet through the stream stack: warmup, then (inside
    ``assert_no_retrace``) admissions, one rank-1 row a user a tick,
    deadline flushes, window downdates, a rung crossing, decay, evictions
    and readmissions, a single-row flush (the width-1 bucket) and one
    infeasible downdate; a checkpoint, a restore in the same process (the
    restored store's own warmup) and the rest of the traffic fed to both.
    Returns a dict of results; every failed check is recorded by ``check``.
    ``path_launches``: the launches of the served traffic alone (every
    flush of both services), from the end of the warmup to the end of the
    traffic, less the restore's warmup and the eager comparisons. With
    ``mesh`` the store is sharded over it (``backend='sharded'``), and the
    restore rebuilds its mesh from the checkpoint's record.
    """
    from repro_torch.core import CholFactor
    from repro_torch.stream import (FactorStore, StreamService,
                                    assert_no_retrace, checkpoint_service,
                                    mutations_issued, restore_service)

    from repro_torch.core import distributed

    (name, structure, prec, n, b, T, window, t_ck, t_promote, t_decay,
     t_evict, t_bad) = run
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # A sharded run takes its dense twin's traffic.
    names = [r[0] for r in STREAM_RUNS]
    base = name.removeprefix("sharded ")
    rng = np.random.default_rng(
        [seed, names.index(base) if base in names else len(names)])
    kw = dict(capacity=STREAM_LADDER[0], ladder=STREAM_LADDER,
              width=STREAM_WIDTH, widths=(1, STREAM_WIDTH),
              panel=STREAM_PANEL, precision=prec, device=dev)
    if structure == "blocktridiag":
        kw.update(structure="blocktridiag", block=b)
    if mesh is not None:
        kw.update(backend="sharded", mesh=mesh)
    mem = (lambda: torch.cuda.memory_reserved() / 1e9) if cuda else \
        (lambda: 0.0)
    if cuda:
        torch.cuda.empty_cache()
    before = mem()
    store = FactorStore(n, **kw)
    out = {"name": name}
    t0 = time.perf_counter()
    rep = store.warmup()
    sync()
    out["warmup_s"] = time.perf_counter() - t0
    out["graphs"] = rep.graphs
    out["steps"] = rep.compiled
    out["reserved_gb"] = mem()
    out["store_gb"] = mem() - before
    out["step_mode"] = store.step_mode

    eps32 = float(torch.finfo(torch.float32).eps)
    bf16 = prec == "bf16"
    per_mut = n * eps32 + (float(torch.finfo(torch.bfloat16).eps)
                           if bf16 else 0.0)
    shadow = StreamShadow(torch, store, per_mut, bf16)
    leaves = (lambda x: [x.diag, x.off]
              if structure == "blocktridiag" else [distributed.gather(x)])
    stats = {"flushes": 0, "launches": {}, "want": {}, "mutations": 0,
             "budget_ok": True, "eager": [], "kinds": set(),
             "widths": set(), "rejects": 0,
             "aside": {k: 0 for k in _launch_counts()}}

    def counted(target):
        """Wrap ``target.apply``: each flush's launches and mutations
        against its budget (``_flush_budget``; one mutation a sign
        block); on the live store also the shadow's sums and, for the
        first flush of each kind and the rejected downdate, the eager
        comparison (its launches set aside: not the served path's)."""
        orig_apply = target.apply
        live = target is store

        def apply(Vup=None, Vdn=None):
            kind = ("both" if Vup is not None and Vdn is not None else
                    "up" if Vup is not None else "down")
            cap = store.capacity
            blocks = [V for V in (Vup, Vdn) if V is not None]
            bad_flush = Vdn is not None and bool((np.abs(Vdn) > 5.0).any())
            compare = live and (kind not in stats["kinds"] or bad_flush)
            if compare:
                d = store.factor.data
                pre = (type(d)(d.diag.clone(), d.off.clone())
                       if structure == "blocktridiag"
                       else distributed.gather(d).clone())
            sync()
            c0, m0 = _launch_counts(), mutations_issued()
            ok = orig_apply(Vup, Vdn)
            sync()
            got = {k: v for k, v in
                   _counts_minus(_launch_counts(), c0).items() if v}
            muts = mutations_issued() - m0
            want = _flush_budget(store, blocks)
            stats["flushes"] += 1
            for key, into in (("launches", got), ("want", want)):
                for k, v in into.items():
                    stats[key][k] = stats[key].get(k, 0) + v
            stats["mutations"] += muts
            stats["budget_ok"] &= got == want and muts == len(blocks)
            if not live:
                return ok
            stats["kinds"].add(kind)
            stats["widths"].update((kind, V.shape[-1]) for V in blocks)
            everyone = torch.ones(cap, dtype=torch.bool, device=dev)
            if Vup is not None:
                shadow.modify(Vup, 1.0, everyone)
            if Vdn is not None:
                shadow.modify(Vdn, -1.0, ok)
                stats["rejects"] += int((~ok).sum())
            if compare:
                c0 = _launch_counts()
                f = CholFactor(pre, **store._meta)
                if Vup is not None:
                    f = f.update(torch.from_numpy(Vup).to(dev))
                ok_e = None
                if Vdn is not None:
                    f, ok_e = f.downdate_guarded(
                        torch.from_numpy(Vdn).to(dev))
                sync()
                for k, v in _counts_minus(_launch_counts(), c0).items():
                    stats["aside"][k] += v
                same = all(torch.equal(x, y) for x, y in
                           zip(leaves(store.factor.data), leaves(f.data)))
                same_ok = ok is None or torch.equal(ok, ok_e)
                stats["eager"].append(
                    (kind, tuple(V.shape[-1] for V in blocks),
                     same and same_ok,
                     None if ok is None else int((~ok).sum())))
            return ok

        target.apply = apply

    counted(store)

    def row():
        v = 0.3 * rng.standard_normal(n)
        if structure == "blocktridiag":
            j = int(rng.integers(0, n // b - 1))
            mask = np.zeros(n)
            mask[j * b:(j + 2) * b] = 1.0
            v = v * mask
        return v.astype(np.float32)

    users = [f"u{i}" for i in range(STREAM_LADDER[0])]
    extra = f"u{STREAM_LADDER[0]}"
    sparse, main = users[:3], users[3:]   # sparse: one row, at tick 0
    evicted = main[8:12]
    svcs = []
    reports = []

    def admit(u):
        for s in svcs:
            s.admit(u)
        shadow.admit(store.slot(u))

    def step(t):
        """One tick of traffic, fed to every service alike."""
        live = svcs[0]
        if t == t_promote:
            admit(extra)
        if t == t_decay:
            active = torch.zeros(store.capacity, dtype=torch.bool,
                                 device=dev)
            active[[store.slot(u) for u in store.users()]] = True
            for s in svcs:
                s.decay(0.999)
            shadow.scale(0.999, active)
        if t == t_evict:
            for u in evicted:
                for s in svcs:
                    s.evict(u)
                admit(u)
        pushers = sparse if t == 0 else (
            main + ([extra] if t >= t_promote else []) if t >= 5 else [])
        for u in pushers:
            v = row()
            for s in svcs:
                r = s.push(u, v)
                if s is live and r is not None:
                    reports.append(r)
        if t == t_bad:
            v = 30.0 * row()
            for s in svcs:
                s.push(main[5], v, sign=-1)
        for s in svcs:
            r = s.tick()
            if s is live and r is not None:
                reports.append(r)

    svc = StreamService(store, window=window, deadline=STREAM_DEADLINE)
    svcs.append(svc)
    traces = 0
    sync()
    start = _launch_counts()
    with assert_no_retrace(f"{name}: serving before the checkpoint") as w:
        for u in users:
            admit(u)
        for t in range(t_ck):
            step(t)
        checkpoint_service(svc, ckpt_dir, step=t_ck)
    traces += w.traces
    sync()
    c0, t0 = _launch_counts(), time.perf_counter()
    survivor = restore_service(ckpt_dir, warm=True, device=dev)
    sync()
    out["restore_s"] = time.perf_counter() - t0
    restore = _counts_minus(_launch_counts(), c0)  # its warmup's eager runs
    out["restore_graphs"] = survivor.store.steps.graphs
    counted(survivor.store)
    svcs.append(survivor)
    same_meta = (survivor.store.slot_to_user == store.slot_to_user
                 and survivor.tick_count == svc.tick_count)
    with assert_no_retrace(f"{name}: serving after the restore") as w:
        for t in range(t_ck, T):
            step(t)
        for s in svcs:
            r = s.flush(force=True)
            if s is svc:
                reports.append(r)
    traces += w.traces
    sync()
    path = _counts_minus(_launch_counts(), start, restore, stats["aside"])
    restored_equal = same_meta and all(
        torch.equal(x, y) for x, y in zip(leaves(store.factor.data),
                                          leaves(survivor.store.factor.data)))
    slots = sorted(store.slot(u) for u in store.users())
    rel, lim, dist = shadow.errors(slots)
    served = {k: v for k, v in path.items() if v}
    out.update(
        traces=traces, flushes=stats["flushes"], launches=stats["launches"],
        want=stats["want"], path_launches=path,
        mutations=stats["mutations"],
        budget_ok=(stats["budget_ok"]
                   and served == stats["launches"] == stats["want"]),
        eager=stats["eager"], widths=sorted(stats["widths"]),
        rejects=stats["rejects"], restored_equal=restored_equal,
        rel_err=float(rel.max()), rel_limit_min=float(lim.min()),
        within=bool((rel <= lim).all()), dist=float(dist.max()),
        capacity=store.capacity, cold=store.steps.cold_dispatches
        + survivor.store.steps.cold_dispatches,
        finite=all(bool(torch.isfinite(x).all())
                   for x in leaves(store.factor.data)),
        reasons=sorted({r.reason for r in reports}))
    out["store"], out["svc"], out["survivor"] = store, svc, survivor
    return out


def _profiled_ms(torch, fn, reps):
    """Device milliseconds a call, the kernels' times summed by
    ``torch.profiler`` (graph replays included), or None when the profiler
    shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum((getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0.0))
                   for e in prof.key_averages()
                   if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return total_us / 1e3 / reps if total_us > 0 else None


def stream_timings(torch, np, store, reps=20):
    """Times on the card of the dense fp32 store's ``both`` step at rung
    128, widths (16, 16): the graph replay against the eager call of the
    same step (event loop: host clock to a synchronise; stream: CUDA events
    around the call, which include the stream's idle time while the host
    takes the verdict; device: kernels summed by ``torch.profiler``); the
    host's ``pad_block`` and host-to-device copy of the two blocks; one
    copy of the fleet's size (each step writes its result back)."""
    from repro_torch.core import distributed

    rng = np.random.default_rng(1)
    cap, n, w = store.capacity, store.n, STREAM_WIDTH
    ups = {s: (0.3 * rng.standard_normal((4, n))).astype(np.float32)
           for s in range(cap)}
    dns = {s: (0.01 * x) for s, x in ups.items()}
    out = {}
    host = []
    for _ in range(reps):
        t0 = time.perf_counter()
        Vup, Vdn = store.pad_block(ups), store.pad_block(dns)
        host.append((time.perf_counter() - t0) * 1e3)
    out["pad_block_ms"] = float(np.percentile(host, 50))
    copy = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store._stage("up", Vup)
        store._stage("dn", Vdn)
        torch.cuda.synchronize()
        copy.append((time.perf_counter() - t0) * 1e3)
    out["h2d_ms"] = float(np.percentile(copy, 50))
    key = store.steps.key("both", cap, (w, w))
    entry = store.steps.entries[key]
    calls = {"replay": lambda: store.steps.call("both", cap, (w, w)),
             "eager": lambda: entry.run(store._base, eager=True)}
    for what, fn in calls.items():
        loop, stream = [], []
        fn()
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            loop.append((time.perf_counter() - t0) * 1e3)
            stream.append(e0.elapsed_time(e1))
        out[what] = {"loop_p50": float(np.percentile(loop, 50)),
                     "loop_p90": float(np.percentile(loop, 90)),
                     "stream_p50": float(np.percentile(stream, 50)),
                     "stream_p90": float(np.percentile(stream, 90)),
                     "device_ms": _profiled_ms(torch, fn, 5)}
    fleet = store.factor.data
    if distributed.is_sharded(fleet):
        fleet = fleet.to_local()  # this rank's part of a sharded fleet
    tmp = fleet.clone()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fleet.copy_(tmp)
    e1.record()
    torch.cuda.synchronize()
    out["copy_ms"] = e0.elapsed_time(e1) / reps
    out["fleet_gb"] = fleet.numel() * fleet.element_size() / 1e9
    return out


def stream_phase(torch, np, dev, seed, work_dir, trace_path=None, card="",
                 runs=STREAM_RUNS, mesh=None):
    """Path 3i (or 3k (i) with ``runs=SHARDED_STREAM_RUNS`` and ``mesh``):
    each run, its checks, and the timings of the fp32 store's ``both``
    step (``card``: the card's name and power limit, printed beside them).
    Returns the runs' results and the timings."""
    from repro_torch.obs import tracing

    tracing.RECORDER.clear()
    results, timings = [], None
    for run in runs:
        res = _stream_run(torch, np, dev, seed, run,
                          os.path.join(work_dir, run[0].replace(" ", "_")),
                          mesh=mesh)
        results.append(res)
        eager_ok = len(res["eager"]) >= 4 and all(e[2] for e in res["eager"])
        kinds = {k for k, _ in res["widths"]}
        print(f"stream {res['name']}: warmup {res['warmup_s']:.2f} s, "
              f"{res['graphs']} graphs for {res['steps']} steps, "
              f"memory_reserved after warmup {res['reserved_gb']:.3f} GB "
              f"({res['store_gb']:.3f} GB for this store: its fleet, "
              f"static inputs and graph pool); restore "
              f"{res['restore_s']:.2f} s ({res['restore_graphs']} graphs); "
              f"{res['flushes']} flushes ({', '.join(res['reasons'])}), "
              f"widths {res['widths']}, guard rejects {res['rejects']}, "
              f"capacity {res['capacity']}, step_mode "
              f"{res['step_mode']!r}")
        print(f"  check 1 retraces after warmup {res['traces']} (cold "
              f"dispatches {res['cold']})  "
              f"{'ok' if res['traces'] == 0 else 'FAIL'}")
        print(f"  check 2 replay == eager (torch.equal, fleet and "
              f"verdicts) on {len(res['eager'])} flushes "
              f"{[(k, w, r) for k, w, _, r in res['eager']]}  "
              f"{'ok' if eager_ok else 'FAIL'}")
        print(f"  check 3 restored fleet == live fleet (torch.equal)  "
              f"{'ok' if res['restored_equal'] else 'FAIL'}")
        print(f"  check 4 relative modify_error worst member "
              f"{res['rel_err']:.3e} (its derived limit, smallest over "
              f"members: {res['rel_limit_min']:.3e}); factor vs f64 "
              f"Cholesky {res['dist']:.3e}  "
              f"{'ok' if res['within'] and res['finite'] else 'FAIL'}")
        served = {k: v for k, v in res["path_launches"].items() if v}
        print(f"  check 5 flush launches {res['launches']} (budget "
              f"{res['want']}: ceil(w/32) fused_chain a dense sign block, 1 "
              f"btd_chain a structured one, n/panel diag_block and 1 "
              f"panel_apply_sharded per 32 columns a sharded one, "
              f"independent of B), mutations {res['mutations']} "
              f"(one a sign block) over {res['flushes']} flushes of both "
              f"services; served path, warmups and eager comparisons "
              f"excluded: {served}  {'ok' if res['budget_ok'] else 'FAIL'}")
        check(res["traces"] == 0 and res["cold"] == 0,
              f"stream {res['name']}: a step was built after warmup")
        check(eager_ok, f"stream {res['name']}: a replay differs from the "
              "eager step")
        check(res["restored_equal"], f"stream {res['name']}: the restored "
              "fleet differs from the live one")
        check(res["within"] and res["finite"], f"stream {res['name']}: a "
              "member's modify_error is above its derived limit")
        check(res["budget_ok"] and sum(res["launches"].values()) > 0,
              f"stream {res['name']}: launches or mutations off budget")
        check(kinds == {"up", "down", "both"} and ("up", 1) in res["widths"]
              and res["rejects"] >= 1 and res["capacity"] == 128
              and (res["graphs"] > 0 or dev.type != "cuda"),
              f"stream {res['name']}: the sequence missed a step kind, the "
              "width-1 bucket, the rejected downdate or the rung crossing")
        if dev.type == "cuda" and res["name"].endswith("dense fp32"):
            timings = stream_timings(torch, np, res["store"])
        for key in ("store", "svc", "survivor"):
            res.pop(key, None)
        gc.collect()  # the spy closes a cycle over the store and its graphs
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if timings:
        t = timings
        print(f"stream timing on {card} ({runs[0][0]}, rung 128, both "
              f"16+16): "
              f"replay "
              f"event loop p50 {t['replay']['loop_p50']:.3f} / p90 "
              f"{t['replay']['loop_p90']:.3f} ms, stream p50 "
              f"{t['replay']['stream_p50']:.3f} / p90 "
              f"{t['replay']['stream_p90']:.3f} ms, device "
              f"{t['replay']['device_ms']} ms; eager event loop p50 "
              f"{t['eager']['loop_p50']:.3f} / p90 "
              f"{t['eager']['loop_p90']:.3f} ms, stream p50 "
              f"{t['eager']['stream_p50']:.3f} / p90 "
              f"{t['eager']['stream_p90']:.3f} ms, device "
              f"{t['eager']['device_ms']} ms")
        print(f"stream timing: pad_block {t['pad_block_ms']:.3f} ms, "
              f"host-to-device copy of both blocks {t['h2d_ms']:.3f} ms, "
              f"one fleet-size copy ({t['fleet_gb']:.3f} GB) "
              f"{t['copy_ms']:.3f} ms")
    events = tracing.chrome_trace()["traceEvents"]
    names = sorted({e["name"] for e in events})
    if trace_path:
        tracing.export_chrome_trace(trace_path)
    print(f"stream trace: {len(events)} events {names}"
          + (f", written to {trace_path}" if trace_path else ""))
    check({"stream.flush", "stream.warmup", "stream.checkpoint",
           "stream.restore"} <= set(names),
          "stream: a span is missing from the trace")
    return results, timings


# -- the sharded store's traffic on four ranks (path 3k (iii)) ----------------

#: Path 3k (iii): the store both the one-rank and the four-rank runs serve
#: (n, users, ticks, window, the tick of the decay, of the eviction and
#: readmission, of the refused downdate).
SMALL_STORE = (1024, 8, 12, 6, 5, 7, 9)


def small_store_traffic(torch, np, mesh, seed, ckpt_dir):
    """Path 3k (iii)'s traffic through a sharded store on ``mesh``: 8 users
    at n = 1024 (ladder (8, 16), widths (1, 16), panel 256), warmed, a row
    a user a tick, deadline flushes, window downdates, a decay, an
    eviction and readmission, one refused downdate, a forced flush; then
    one unflushed row and a checkpoint into ``ckpt_dir``. Every rank of
    ``mesh`` calls it alike (the same rows from ``seed``). Returns the
    gathered fleet (at the checkpoint), each flush's downdate verdicts,
    the unflushed rows of user 0 and the store's ``step_mode``."""
    from repro_torch.core import distributed
    from repro_torch.stream import (FactorStore, StreamService,
                                    checkpoint_service)

    n, B, T, window, t_decay, t_evict, t_bad = SMALL_STORE
    rng = np.random.default_rng([seed, 31])
    store = FactorStore(n, capacity=B, ladder=(B, 2 * B),
                        width=STREAM_WIDTH, widths=(1, STREAM_WIDTH),
                        panel=STREAM_PANEL, backend="sharded", mesh=mesh)
    store.warmup()
    svc = StreamService(store, window=window, deadline=STREAM_DEADLINE)
    users = [f"u{i}" for i in range(B)]
    verdicts = []

    def note(r):
        if r is not None and r.downdate_ok:
            verdicts.append(sorted(r.downdate_ok.items()))

    def row(scale=0.3):
        return (scale * rng.standard_normal(n)).astype(np.float32)

    for u in users:
        svc.admit(u)
    for t in range(T):
        if t == t_decay:
            svc.decay(0.999)
        if t == t_evict:
            svc.evict(users[3])
            svc.admit(users[3])
        for u in users:
            note(svc.push(u, row()))
        if t == t_bad:
            note(svc.push(users[5], row(30.0), sign=-1))
        note(svc.tick())
    note(svc.flush(force=True))
    fleet = distributed.gather(store.factor.data)
    svc.push(users[0], row())
    checkpoint_service(svc, ckpt_dir, step=1)
    return fleet, verdicts, svc.pending(users[0]), store.step_mode


def sharded_grads(torch, mesh, L, V):
    """Path 3k (iii)'s gradients: 3j's loss through an update and a
    downdate by half the rows with ``method='sharded'`` on ``mesh``, each
    rank's loss on its own columns (their sum is the whole loss). Returns
    the gradients of L and V, whole."""
    from repro_torch.core import api

    L = L.detach().clone().requires_grad_(True)
    V = V.detach().clone().requires_grad_(True)
    kw = dict(method="sharded", mesh=mesh, panel=STREAM_PANEL)
    up = api.chol_update_batched(L, V, **kw)
    dn = api.chol_update_batched(up, 0.5 * V, sigma=-1, **kw)
    gL, gV = torch.autograd.grad(_phi(torch, [dn.to_local()]), [L, V])
    return gL, gV


# -- the train phase (path 3j) ------------------------------------------------
#
# Gradients through the update (core/autodiff.py: the Murray rule as a
# torch.autograd.Function around the dispatched kernel) and CholeskyPrecond
# training (optim/), whose batched factors take scale, update (fused_chain),
# downdate (fused_chain) and solve on every step.

#: One layer of the repo's llama3.2-3b (src/repro/configs/llama3_2_3b.py:
#: d_model 3072, 24 heads and 8 KV heads of 128, d_ff 8192): its seven
#: weight matrices as (in, out), ``X @ W``.
TRAIN_SHAPES = {"q": (3072, 3072), "k": (3072, 1024), "v": (3072, 1024),
                "o": (3072, 3072), "gate": (3072, 8192),
                "up": (3072, 8192), "down": (8192, 3072)}
#: The optimizer's own configuration (src/repro/launch/dryrun.py:63: lr
#: 3e-4, rank 16, blocks of 1024), with a window of 4 and beta 0.999, over
#: 20 steps of a seeded least-squares loss per matrix (256 rows).
TRAIN_OPT = dict(rank=16, block_size=1024, window=4, beta=0.999)
TRAIN_LR, TRAIN_STEPS, TRAIN_ROWS = 3e-4, 20, 256
#: The step of the fourth-order central difference along a unit direction
#: (f64): its truncation goes as h^4, its rounding as eps(f64) / h.
FD_STEP = 0.05


def _phi(torch, outs):
    """The loss of tests/test_factor.py, sum sin(x) cos(x / 2), over every
    tensor of ``outs`` (fp32 unless float64)."""
    total = 0.0
    for x in outs:
        x = x if x.dtype == torch.float64 else x.float()
        total = total + (x.sin() * (0.5 * x).cos()).sum()
    return total


def _kappa2(torch, U):
    """kappa_2 of the upper factor(s) ``U`` (the worst member), from the
    eigenvalues of ``U^T U`` in float64."""
    U = U.detach().double()
    lam = torch.linalg.eigvalsh(U.mT @ U)
    return float(torch.sqrt(lam[..., -1] / lam[..., 0]).max())


def _unit_direction(torch, gen, xs, masks):
    """A seeded direction of unit norm over the tensors ``xs`` (float64),
    each masked (the factor's own entries, V's support)."""
    d = [torch.randn(x.shape, generator=gen, dtype=torch.float64,
                     device=x.device) * m for x, m in zip(xs, masks)]
    norm = torch.sqrt(sum((t * t).sum() for t in d))
    return [t / norm for t in d]


def _grad_case(torch, name, fwd, xs, masks, *, f64_ref,
               precision_ref=None, mem=None):
    """One gradient case of path 3j: ``fwd(*xs)`` (a tuple of outputs; an
    update, then a downdate by half the rows) with and without gradients.

    (a) the forward with gradients on equals it with gradients off;
    (b) the fp32 gradients against the same rule in float64 on the float64
        forward (``f64_ref``), or ``precision_ref(saved)`` for bf16
        storage, relative to the reference's largest entry, limit
        sqrt(n) u(fp32) kappa_2 (PERF.md §6, path 3j);
    (c) in float64, <g, d> against the central difference of the loss along
        a seeded unit direction d (masked to the storage's entries),
        relative, limit 1e-6;
    (d) the backward launches no repo kernel.
    Returns the forward's launches (the path's count) and the readings."""
    res = {"name": name}
    off = fwd(*xs)
    leaves = [x.detach().clone().requires_grad_(True) for x in xs]
    saved = {}
    if mem is not None:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        m0 = torch.cuda.memory_allocated()
    c0 = _launch_counts()
    t0 = time.perf_counter()
    on = fwd(*leaves, saved=saved)
    torch.cuda.synchronize()
    res["fwd_ms"] = (time.perf_counter() - t0) * 1e3
    c1 = _launch_counts()
    t0 = time.perf_counter()
    grads = torch.autograd.grad(_phi(torch, on), leaves)
    torch.cuda.synchronize()
    res["bwd_ms"] = (time.perf_counter() - t0) * 1e3
    c2 = _launch_counts()
    if mem is not None:
        res["peak_gb"] = (torch.cuda.max_memory_allocated() - m0) / 1e9
        res["mem_bar_gb"] = mem
    res["fwd_launches"] = {k: v for k, v in _counts_minus(c1, c0).items()
                           if v}
    res["bwd_launches"] = {k: v for k, v in _counts_minus(c2, c1).items()
                           if v}
    res["equal"] = all(torch.equal(a.detach(), b) for a, b in zip(on, off))
    res["finite"] = all(bool(torch.isfinite(g).all()) for g in grads)
    res["dtypes"] = [str(g.dtype).replace("torch.", "") for g in grads]
    if precision_ref is not None:
        ref, kappa, n = precision_ref(saved, grads)
        pairs = [(grads[0], ref)]
    else:
        ref, kappa, n = f64_ref
        pairs = list(zip(grads, ref))
    res["b_err"] = max(float((g.double() - r).abs().max() / r.abs().max())
                       for g, r in pairs)
    res["kappa"] = kappa
    res["b_lim"] = math.sqrt(n) * 2.0 ** -24 * kappa
    return res


def _fd_check(torch, fwd64, xs64, grads64, masks, gen):
    """Check (c): <g, d> against the fourth-order central difference of
    the loss, (f(-2h) - 8 f(-h) + 8 f(h) - f(2h)) / 12h."""
    d = _unit_direction(torch, gen, xs64, masks)
    gd = float(sum((g * t).sum() for g, t in zip(grads64, d)))
    with torch.no_grad():
        f = {s: float(_phi(torch, fwd64(*(x + s * FD_STEP * t
                                          for x, t in zip(xs64, d)))))
             for s in (-2, -1, 1, 2)}
    fd = (f[-2] - 8 * f[-1] + 8 * f[1] - f[2]) / (12 * FD_STEP)
    return gd, fd, abs(fd - gd) / abs(gd)


def _f64_run(torch, fwd, xs):
    """The float64 forward and its gradients."""
    leaves = [x.detach().double().requires_grad_(True) for x in xs]
    outs = fwd(*leaves)
    grads = torch.autograd.grad(_phi(torch, outs), leaves)
    return outs, grads


def _print_grad_case(res, card):
    print(f"train grad {res['name']} on {card}: forward {res['fwd_ms']:.1f} "
          f"ms, backward {res['bwd_ms']:.1f} ms; launches forward "
          f"{res['fwd_launches']}, backward {res['bwd_launches']}; "
          f"gradient dtypes {res['dtypes']}"
          + (f"; peak memory added {res['peak_gb']:.4f} GB (bar "
             f"{res['mem_bar_gb']:.3f})" if "peak_gb" in res else ""))
    print(f"  (a) forward with gradients == without (torch.equal) "
          f"{res['equal']}")
    if res.get("b_lim"):
        print(f"  (b) relative error against the float64 rule "
              f"{res['b_err']:.3e} (limit sqrt(n) u kappa_2 = "
              f"{res['b_lim']:.3e}, kappa_2 {res['kappa']:.1f})")
    else:
        print(f"  fp32 against float64 gradients, relative {res['b_err']:.3e}"
              f" (reported)")
    if "fd_rel" in res:
        print(f"  (c) float64 <g, d> {res['gd']:.12e} against the central "
              f"difference {res['fd']:.12e} (fourth order, h = {FD_STEP}): "
              f"relative "
              f"{res['fd_rel']:.3e} (limit 1e-6)")


def _dense_grad_cases(torch, L, V, Lf, Vf, gen):
    """Dense gradients: the factor (n = 5000 on the card) and the fleet
    (B = 64, n = 1024) in fp32, the fleet in bf16 storage."""
    from repro_torch.core import api, autodiff

    def make(fn, precision=None):
        def fwd(L, V, saved=None):
            up = fn(L, V, method="fused", precision=precision)
            dn = fn(up, 0.5 * V, sigma=-1, method="fused",
                    precision=precision)
            if saved is not None and up.requires_grad:
                saved["up"] = up
                up.register_hook(lambda g: saved.__setitem__("g_up", g))
            return (dn,)
        return fwd

    out = []
    for name, fn, Lx, Vx in (("factor", api.chol_update, L, V),
                             ("fleet", api.chol_update_batched, Lf, Vf)):
        fwd = make(fn)
        masks = [torch.triu(torch.ones_like(Lx, dtype=torch.float64)),
                 torch.ones_like(Vx, dtype=torch.float64)]
        xs64 = [Lx.double(), Vx.double()]
        outs64, grads64 = _f64_run(torch, fwd, xs64)
        up64 = fn(xs64[0], xs64[1], method="fused")
        kappa = max(_kappa2(torch, up64), _kappa2(torch, outs64[0]))
        n = Lx.shape[-1]
        del up64
        res = _grad_case(torch, f"{name} fp32", fwd, [Lx, Vx], masks,
                         f64_ref=(grads64, kappa, n))
        res["gd"], res["fd"], res["fd_rel"] = _fd_check(
            torch, fwd, xs64, grads64, masks, gen)
        out.append(res)
        del outs64, grads64
        if name == "fleet":
            def rule64(saved, grads, Lx=Lx):
                # The update's own rule in float64 on what the bf16 run
                # saved: the bf16-stored factor and its cotangent.
                Ln = saved["up"].detach().double()
                Abar = autodiff._murray_adjoint(Ln, saved["g_up"].double())
                ref = Lx.double() @ (Abar + Abar.mT)
                return ref, _kappa2(torch, Ln), Lx.shape[-1]

            out.append(_grad_case(torch, "fleet bf16", make(fn, "bf16"),
                                  [Lx, Vx], masks, f64_ref=None,
                                  precision_ref=rule64))
        torch.cuda.empty_cache()
    return out


def _sharded_grad_cases(torch, mesh, L, V, Lf, Vf, gen):
    """Path 3k (ii): 3j's loss and checks (a)-(d) through
    ``method='sharded'`` on the one-rank ``mesh``: the factor (n = 5120 on
    the card) and the fleet (B = 64, n = 1024) in fp32, the fleet in bf16
    storage. (b) holds the fp32 rule against the same rule in float64 on
    the float64 sharded forward (bf16: the update's rule in float64 on
    what the bf16 run saved), limit sqrt(n) u kappa_2; (c) in float64 on
    the sharded forward; (d) no launch in a backward (it gathers and runs
    the dense rule's solves and products)."""
    from repro_torch.core import api, autodiff, distributed

    def make(fn, precision=None):
        def fwd(L, V, saved=None):
            kw = dict(method="sharded", mesh=mesh, panel=256,
                      precision=precision)
            up = fn(L, V, **kw)
            dn = fn(up, 0.5 * V, sigma=-1, **kw)
            if saved is not None and up.requires_grad:
                saved["up"] = up
                up.register_hook(lambda g: saved.__setitem__("g_up", g))
            return (dn.to_local(),)
        return fwd

    out = []
    for name, fn, Lx, Vx in (("factor", api.chol_update, L, V),
                             ("fleet", api.chol_update_batched, Lf, Vf)):
        fwd = make(fn)
        masks = [torch.triu(torch.ones_like(Lx, dtype=torch.float64)),
                 torch.ones_like(Vx, dtype=torch.float64)]
        xs64 = [Lx.double(), Vx.double()]
        outs64, grads64 = _f64_run(torch, fwd, xs64)
        up64 = distributed.gather(fn(xs64[0], xs64[1], method="sharded",
                                     mesh=mesh, panel=256))
        kappa = max(_kappa2(torch, up64), _kappa2(torch, outs64[0]))
        n = Lx.shape[-1]
        del up64
        res = _grad_case(torch, f"sharded {name} fp32", fwd, [Lx, Vx],
                         masks, f64_ref=(grads64, kappa, n))
        res["gd"], res["fd"], res["fd_rel"] = _fd_check(
            torch, fwd, xs64, grads64, masks, gen)
        res["want"] = _sharded_fwd_want(n, Vx.shape[-1])
        out.append(res)
        del outs64, grads64
        if name == "fleet":
            def rule64(saved, grads, Lx=Lx):
                Ln = distributed.gather(saved["up"].detach()).double()
                G = distributed.gather(saved["g_up"]).double()
                Abar = autodiff._murray_adjoint(Ln, G)
                ref = Lx.double() @ (Abar + Abar.mT)
                return ref, _kappa2(torch, Ln), Lx.shape[-1]

            res = _grad_case(torch, "sharded fleet bf16", make(fn, "bf16"),
                             [Lx, Vx], masks, f64_ref=None,
                             precision_ref=rule64)
            res["want"] = _sharded_fwd_want(n, Vx.shape[-1])
            out.append(res)
        torch.cuda.empty_cache()
    return out


def _sharded_fwd_want(n, k, calls=2):
    """The launches of ``calls`` sharded updates of order n and rank k on
    one rank, panel 256."""
    from repro_torch.kernels import sharded as SH

    return {name: calls * v for name, v in SH.kernel_launches(
        n, 256, strategy="fused", k=k).items()}


def sharded_grad_phase(torch, dev, seed, mesh, dense, fleet, card):
    """Path 3k (ii): ``_sharded_grad_cases`` with 3j's checks. Returns the
    launches of the gradient forwards."""
    gen = torch.Generator(device=dev).manual_seed(seed + 10)
    path = {name: 0 for name in _launch_counts()}
    for res in _sharded_grad_cases(torch, mesh, *dense, *fleet, gen):
        _print_grad_case(res, card)
        for k, v in res["fwd_launches"].items():
            path[k] += v
        want = res["want"] if dev.type == "cuda" else {}
        check(res["equal"] and res["finite"],
              f"grad {res['name']}: check (a) failed or a gradient is not "
              "finite")
        check(res["fwd_launches"] == want and not res["bwd_launches"],
              f"grad {res['name']}: check (d) failed: forward "
              f"{res['fwd_launches']} (want {want}), backward "
              f"{res['bwd_launches']} (want none)")
        check(res["dtypes"][-1] == "float32",
              f"grad {res['name']}: V's gradient is not fp32")
        if res.get("b_lim"):
            check(res["b_err"] <= res["b_lim"],
                  f"grad {res['name']}: check (b) above its limit")
        if "fd_rel" in res:
            check(res["fd_rel"] <= 1e-6,
                  f"grad {res['name']}: check (c) above 1e-6")
    return path


def _structured_grad_case(torch, S, V, gen):
    """Structured gradients on the wide block (b = 64, nb = 512, k = 16,
    block-local V) through btd_chain, with the memory bar: 10 % of one
    dense (n, n) fp32 matrix."""
    from repro_torch.core import BlockTriDiagStorage, api

    def fwd(D, O, V, saved=None):
        up = api.chol_update(BlockTriDiagStorage(D, O), V,
                             method="blocktridiag")
        dn = api.chol_update(up, 0.5 * V, sigma=-1, method="blocktridiag")
        return dn.diag, dn.off

    n = S.n
    xs = [S.diag, S.off, V]
    masks = [torch.triu(torch.ones_like(S.diag, dtype=torch.float64)),
             torch.ones_like(S.off, dtype=torch.float64),
             (V != 0).double()]
    xs64 = [x.double() for x in xs]
    _, grads64 = _f64_run(torch, fwd, xs64)
    res = _grad_case(torch, f"wide block b={S.block} nb={S.nblocks} fp32",
                     fwd, xs, masks, f64_ref=(grads64, 0.0, n),
                     mem=0.1 * 4 * n * n / 1e9)
    res["b_lim"] = None  # check (b) is the dense cases'
    res["gd"], res["fd"], res["fd_rel"] = _fd_check(torch, fwd, xs64,
                                                    grads64, masks, gen)
    return res


def _train_run(torch, dev, seed, shapes, steps, rows):
    """CholeskyPrecond on the seven matrices of ``shapes``: ``steps``
    steps of a seeded least-squares loss per matrix. Records every sketch
    (the optimizer's own draw, recomputed) into float64 statistics with
    their check-4 budget, and times each step (event loop)."""
    import importlib

    import repro_torch.optim as optim

    cp = importlib.import_module("repro_torch.optim.cholesky_precond")
    gen = torch.Generator(device=dev).manual_seed(seed + 19)
    data, params = {}, {}
    for name, (m, n) in shapes.items():
        X = torch.randn(rows, m, generator=gen, device=dev)
        W = torch.randn(m, n, generator=gen, device=dev) / math.sqrt(m)
        data[name] = (X, X @ W)
        params[name] = torch.zeros(m, n, device=dev)
    opt = optim.cholesky_precond(TRAIN_LR, **TRAIN_OPT)
    rank, bs, window, beta = (TRAIN_OPT[k] for k in
                              ("rank", "block_size", "window", "beta"))
    eps = 1e-2  # cholesky_precond's default
    state = opt.init(params)
    order = sorted(shapes)  # the optimizer's parameter index
    shadow, budget, sketches = {}, {}, {name: [] for name in order}
    for name in order:
        d = min(shapes[name])
        b = min(bs, d)
        shadow[name] = eps * torch.eye(b, dtype=torch.float64,
                                       device=dev).repeat(d // b, 1, 1)
        budget[name] = torch.zeros(d // b, dtype=torch.float64, device=dev)

    def account(name):
        # A mutation may add n eps(fp32) times the largest entry of the
        # matrix it leaves, n the factor's order (PERF.md §6, check 4).
        A = shadow[name]
        budget[name] += A.shape[-1] * float(torch.finfo(torch.float32).eps) \
            * A.abs().flatten(1).amax(1)

    losses, step_ms, launches = [], [], []
    for step in range(1, steps + 1):
        torch.cuda.synchronize()
        c0 = _launch_counts()
        t0 = time.perf_counter()
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        loss = sum(0.5 * torch.mean(torch.square(data[k][0] @ leaves[k]
                                                 - data[k][1]))
                   for k in order)
        grads = dict(zip(order, torch.autograd.grad(
            loss, [leaves[k] for k in order])))
        upd, state = opt.update(grads, state, params)
        params = optim.apply_updates(params, upd)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(_counts_minus(_launch_counts(), c0))
        losses.append(float(loss.detach()))
        # The statistics each factor should hold, in float64.
        for i, name in enumerate(order):
            g = grads[name].float()
            m, n = g.shape
            gmat = g if m <= n else g.T
            dd, other = gmat.shape
            b = min(bs, dd)
            v = gmat @ cp.sketch(other, rank, seed=0, step=step, index=i,
                                 device=dev)
            sketches[name].append(v)
            vb = v.double().reshape(dd // b, b, rank)
            shadow[name] *= beta
            account(name)
            shadow[name] += vb @ vb.mT
            account(name)
            if step > window:
                old = sketches[name][step - 1 - window].double().reshape(
                    dd // b, b, rank) * beta ** (window / 2)
                shadow[name] -= old @ old.mT
                account(name)
    out = {"losses": losses, "step_ms": step_ms, "launches": launches,
           "members": {}}
    for name in order:
        c = state["factors"][name]["c"]
        C = c.data.double()
        A = shadow[name]
        den = A.abs().flatten(1).amax(1)
        err = (C.mT @ C - A).abs().flatten(1).amax(1) / den
        out["members"][name] = (bool(c.is_valid().all()),
                                err.tolist(), (budget[name] / den).tolist(),
                                tuple(c.data.shape))
    # The preconditioner alone on the last step's operands (after the
    # counted run): decay, update, downdate and solve of every factor.
    def precond():
        for i, name in enumerate(order):
            fac = state["factors"][name]
            c = fac["c"]
            nb_, b_ = c.data.shape[0], c.data.shape[-1]
            v = sketches[name][-1].reshape(nb_, b_, rank)
            c2 = c.scale(math.sqrt(beta)).update(v).downdate(
                fac["ring"][0].reshape(nb_, b_, rank) * beta)
            g = grads[name].float()
            gmat = g if g.shape[0] <= g.shape[1] else g.T
            c2.solve(gmat.reshape(nb_, b_, -1))

    precond()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    e0.record()
    for _ in range(5):
        precond()
    e1.record()
    torch.cuda.synchronize()
    out["precond_ms"] = e0.elapsed_time(e1) / 5
    return out


def train_phase(torch, np, dev, seed, dense, fleet, wide, card,
                shapes=None, steps=TRAIN_STEPS, rows=TRAIN_ROWS):
    """Path 3j: dense gradients on ``dense`` (L, V) and ``fleet`` (L, V),
    structured gradients on ``wide`` (storage, V), then CholeskyPrecond
    training on ``shapes`` (default one llama3.2-3b layer). Returns the
    launches of the path's own runs (the gradient forwards and the
    training steps; not the float64 references, differences and
    timings)."""
    t_start = time.perf_counter()
    shapes = TRAIN_SHAPES if shapes is None else shapes
    gen = torch.Generator(device=dev).manual_seed(seed + 9)
    path = {name: 0 for name in _launch_counts()}

    def add(got):
        for k, v in got.items():
            path[k] += v

    cases = _dense_grad_cases(torch, *dense, *fleet, gen)
    cases.append(_structured_grad_case(torch, *wide, gen))
    for res in cases:
        _print_grad_case(res, card)
        add(res["fwd_launches"])
        structured = res["name"].startswith("wide")
        kernel = "btd_chain" if structured else "fused_chain"
        want = {kernel: 2} if dev.type == "cuda" else {}
        check(res["equal"] and res["finite"],
              f"train grad {res['name']}: check (a) failed or a gradient "
              "is not finite")
        check(res["fwd_launches"] == want and not res["bwd_launches"],
              f"train grad {res['name']}: check (d) failed: forward "
              f"{res['fwd_launches']} (want {want}), backward "
              f"{res['bwd_launches']} (want none)")
        check(res["dtypes"][-1] == "float32",
              f"train grad {res['name']}: V's gradient is not fp32")
        if res.get("b_lim"):
            check(res["b_err"] <= res["b_lim"],
                  f"train grad {res['name']}: check (b) above its limit")
        if "fd_rel" in res:
            check(res["fd_rel"] <= 1e-6,
                  f"train grad {res['name']}: check (c) above 1e-6")
        if "peak_gb" in res:
            check(res["peak_gb"] < res["mem_bar_gb"],
                  f"train grad {res['name']}: memory above its bar")
    t_grads = time.perf_counter() - t_start
    torch.cuda.empty_cache()

    run = _train_run(torch, dev, seed, shapes, steps, rows)
    fused = [c["fused_chain"] for c in run["launches"]]
    window = TRAIN_OPT["window"]
    want = [len(shapes) * (1 + (s > window)) for s in range(1, steps + 1)]
    if dev.type != "cuda":
        want = [0] * steps
    others = sum(v for c in run["launches"] for k, v in c.items()
                 if k != "fused_chain")
    for c in run["launches"]:
        add(c)
    ms = np.asarray(run["step_ms"])
    p50, p90 = float(np.percentile(ms, 50)), float(np.percentile(ms, 90))
    print(f"train cholesky_precond on {card}: {len(shapes)} matrices "
          f"{sorted(shapes.items())}, {TRAIN_OPT}, lr {TRAIN_LR}, {steps} "
          f"steps: loss step 1 {run['losses'][0]:.6e}, step {steps} "
          f"{run['losses'][-1]:.6e}")
    print(f"  step time (event loop) p50 {p50:.3f} / p90 {p90:.3f} ms "
          f"(first {run['step_ms'][0]:.3f}); the preconditioner alone "
          f"(scale, update, downdate, solve of every factor; CUDA events) "
          f"{run['precond_ms']:.3f} ms = {run['precond_ms'] / p50:.1%} of "
          f"the p50 step")
    print(f"  launches fused_chain per step {fused} (want {want}: one a "
          f"matrix a step, and one more once the ring is full); other "
          f"kernels {others}")
    worst = []
    for name, (valid, err, lim, shape) in run["members"].items():
        ok = valid and all(e <= li for e, li in zip(err, lim))
        worst.append(ok)
        print(f"  factor {name} {shape}: valid {valid}, relative "
              f"modify_error per member "
              f"{', '.join(f'{e:.3e}' for e in err)} (limits "
              f"{', '.join(f'{x:.3e}' for x in lim)})  "
              f"{'ok' if ok else 'FAIL'}")
    check(run["losses"][-1] < run["losses"][0],
          "train: the loss at the last step is not below the first's")
    check(all(worst), "train: a factor is invalid or off its statistics")
    check(fused == want and others == 0,
          "train: launches off the budget (one fused_chain a matrix a "
          "step, one more once the ring is full)")
    print(f"path train: {time.perf_counter() - t_start:.1f} s (gradients "
          f"{t_grads:.1f} s)")
    return path


# -- the serve phase (path 3l) ------------------------------------------------
#
# The port's LM serving path: launch.serve.generate on full-width
# h2o-danube-1.8b (plain torch operations, no repo kernel), decode against
# forward, the nine decoder-only architectures at reduced() on the card
# against the CPU, and serve_lm's personalization sidecar, whose flushes
# launch the fused chain.

SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = "h2o-danube-1.8b", 8, 32, 64
SERVE_TEMPERATURE = 0.8
#: Decode against forward at full width, 16 tokens, B = 2 (PERF.md §2):
#: fp32 parameters under the JAX test's own limits (rtol 2e-2, atol 2e-3,
#: elementwise); bf16 parameters with an fp32 cache (the serve mix) within
#: 16 bf16 unit roundoffs of the largest logit: the forward rounds K/V
#: and the attention weights to bf16, the decode keeps them in fp32.
SERVE_TF_LEN, SERVE_TF_BF16_UNITS = 16, 16


def _serve_decoder_archs():
    from repro_torch.configs import ARCHS

    return [n for n in sorted(ARCHS) if ARCHS[n].family != "encdec"]


def _reduced_on_card(torch, np, dev, seed):
    """Path 3l (c): each decoder-only architecture at reduced(), weights
    drawn on the CPU and carried to the card (params_to_numpy ->
    params_from_numpy): forward and four decode steps on both, within fp32
    tol_for(d_model * num_layers) * (1 + max |cpu|). Returns the worst
    (err / limit) by architecture."""
    from repro_torch import interop
    from repro_torch.configs import ARCHS
    from repro_torch.models import decode_step, forward, init_cache, \
        init_model

    out = {}
    for i, name in enumerate(_serve_decoder_archs()):
        cfg = ARCHS[name].reduced()
        cpu = init_model(cfg, device="cpu", seed=seed + i)
        card = interop.params_from_numpy(interop.params_to_numpy(cpu), cfg,
                                         device=dev)
        rng = np.random.default_rng([seed, i])
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8))
                                .astype(np.int32))
        batch = {"tokens": toks}
        if cfg.family == "vlm":
            batch["embeds"] = torch.from_numpy(rng.normal(
                size=(2, 1, cfg.d_model)).astype(np.float32))
        tol = 50 * float(torch.finfo(torch.float32).eps) * (
            cfg.d_model * cfg.num_layers)
        worst = 0.0
        with torch.no_grad():
            pairs = [(forward(cpu, cfg, batch), forward(
                card, cfg, {k: v.to(dev) for k, v in batch.items()}))]
            cc = init_cache(cfg, 2, 8, torch.float32, device="cpu")
            cg = init_cache(cfg, 2, 8, torch.float32, device=dev)
            for t in range(4):
                lc, cc = decode_step(cpu, cfg, cc, toks[:, t])
                lg, cg = decode_step(card, cfg, cg, toks[:, t].to(dev))
                pairs.append((lc, lg))
                # A step writes its cache in place: keep this step's.
                pairs += [(cc[k].clone(), cg[k].clone()) for k in cc
                          if k != "pos"]
        for ref, got in pairs:
            err = float((got.cpu().float() - ref.float()).abs().max())
            worst = max(worst, err / (tol * (1 + float(ref.abs().max()))))
        out[name] = worst
    return out


def _device_profile(torch, fn, reps):
    """(device ms a call, device kernels a call) of ``fn`` from
    ``torch.profiler`` (the kernels' self times and counts), or (None,
    None) where the profiler shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us, kernels = 0.0, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us += (getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0.0))
            kernels += e.count
    if us <= 0:
        return None, None
    return us / 1e3 / reps, kernels / reps


@contextlib.contextmanager
def _sidecar_instrument(torch, flushes):
    """Within: every ``FactorStore.apply`` (a served flush; warmup calls
    none) records its launches (by kernel), its budget (ceil(w/32)
    fused_chain a dense sign block) and its time (host clock around the
    synced apply) in ``flushes``."""
    from repro_torch.stream import FactorStore

    orig = FactorStore.apply

    def apply(store, Vup=None, Vdn=None):
        blocks = [V for V in (Vup, Vdn) if V is not None]
        torch.cuda.synchronize()
        c0, t0 = _launch_counts(), time.perf_counter()
        ok = orig(store, Vup, Vdn)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        got = {k: v for k, v in
               _counts_minus(_launch_counts(), c0).items() if v}
        want = {"fused_chain": sum(-(-V.shape[-1] // 32) for V in blocks)}
        flushes.append({"got": got, "want": want, "ms": ms,
                        "widths": [V.shape[-1] for V in blocks]})
        return ok

    FactorStore.apply = apply
    try:
        yield
    finally:
        FactorStore.apply = orig


def serve_phase(torch, np, dev, seed, card):
    """Path 3l. Returns the sidecar's served launches (its flushes, not its
    warmup) by kernel."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.examples import serve_lm
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, forward, init_cache, \
        init_model, param_count

    t_start = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    # (a) full-width decode through the serve driver.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model = init_model(cfg, device=dev, seed=seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    pbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    prompts = SyntheticTokens(DataConfig(cfg.vocab_size, SERVE_PROMPT,
                                         SERVE_BATCH, seed=2)).batch_at(0)
    cache_len = SERVE_PROMPT + SERVE_GEN
    toks, tps = serve.generate(cfg, model, prompts["tokens"], gen=SERVE_GEN,
                               cache_len=cache_len,
                               temperature=SERVE_TEMPERATURE, seed=seed)
    c0 = init_cache(cfg, SERVE_BATCH, cache_len, torch.float32, device=dev)
    cbytes = sum(t.numel() * t.element_size() for t in c0.values())
    check(tuple(toks.shape) == (SERVE_BATCH, cache_len)
          and int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size
          and torch.equal(toks[:, :SERVE_PROMPT].cpu(), prompts["tokens"]),
          "serve: generated tokens off the vocabulary or the prompt")
    # The same sequence teacher-forced through decode_step, each step timed
    # by CUDA events and its logits checked finite.
    # The cache is donated: every leaf keeps its storage across the steps,
    # and the last step's peak above its start is its own work, not a
    # copy of the cache.
    step_ms, finite, cache = [], True, c0
    ptrs = {k: v.data_ptr() for k, v in c0.items()}
    with torch.inference_mode():
        for t in range(cache_len):
            if t == cache_len - 1:
                torch.cuda.synchronize()
                peak_before = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                step_base = torch.cuda.memory_allocated()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            lg, cache = decode_step(model, cfg, cache, toks[:, t])
            b.record()
            finite &= bool(torch.isfinite(lg).all())
            b.synchronize()
            step_ms.append(a.elapsed_time(b))
    step_peak = torch.cuda.max_memory_allocated() - step_base
    check({k: v.data_ptr() for k, v in cache.items()} == ptrs,
          "serve: a decode step moved a cache leaf to new storage")
    check(finite, "serve: non-finite decode logits at full width")
    gen_ms = np.asarray(step_ms[SERVE_PROMPT:])
    # Where a step's time goes: the device's own time in it (the kernels'
    # sum) against the step, and the kernels a step launches.
    with torch.inference_mode():
        dev_ms, kernels = _device_profile(
            torch, lambda: decode_step(model, cfg, cache, toks[:, -1]), 3)
    # The bytes a sampled step at position p must move: every parameter
    # but the embedding table, B rows of it, the p cache slots it reads
    # and the one it writes (K and V, every layer), its fp32 logits.
    emb = model["embed"]["tokens"]
    slot_bytes = sum(t.numel() * t.element_size() for t in c0.values()
                     if t.dim() == 5) / cache_len
    step_bytes = [pbytes - emb.numel() * emb.element_size()
                  + SERVE_BATCH * emb.shape[1] * emb.element_size()
                  + (min(p, cache_len) + 1) * slot_bytes
                  + SERVE_BATCH * cfg.vocab_padded * 4
                  for p in range(SERVE_PROMPT, cache_len)]
    bound_ms = float(np.mean(step_bytes)) / HBM_BYTES_PER_S * 1e3
    whole_ms = (pbytes + cbytes) / HBM_BYTES_PER_S * 1e3
    peak_gb = max(peak_before, torch.cuda.max_memory_allocated()) / 1e9
    print(f"path 3l (a) serve {SERVE_ARCH} full width "
          f"({param_count(model)} parameters, {pbytes / 1e9:.3f} GB "
          f"{cfg.param_dtype}; init {t_init:.1f} s) batch {SERVE_BATCH}, "
          f"prompt {SERVE_PROMPT}, {SERVE_GEN} generated at temperature "
          f"{SERVE_TEMPERATURE}, fp32 cache {cbytes / 1e6:.1f} MB, on {card}: "
          f"{tps:.1f} tokens/s; decode step p50 "
          f"{np.percentile(gen_ms, 50):.3f} / p90 "
          f"{np.percentile(gen_ms, 90):.3f} ms (CUDA events, the "
          f"{len(gen_ms)} sampled positions; prompt steps p50 "
          f"{np.percentile(step_ms[:SERVE_PROMPT], 50):.3f}); HBM bound "
          f"(the bytes a sampled step moves, mean over its positions, over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) {bound_ms:.3f} ms, p50 / "
          f"bound {np.percentile(gen_ms, 50) / bound_ms:.2f} (all "
          f"parameters + the whole cache: {whole_ms:.3f} ms); peak memory "
          f"{peak_gb - base_gb:.2f} GB above the {base_gb:.2f} GB the "
          f"smoke held before; logits finite {finite}")
    print(f"  decode step (the last teacher-forced one) peak "
          f"{step_peak / 1e6:.3f} MB above its start beside the "
          f"{cbytes / 1e6:.1f} MB cache it writes in place; every cache "
          f"leaf kept its storage over the {cache_len} steps")
    if dev_ms is None:
        print("  decode step device time: not measured (the profiler shows "
              "no device time)")
    else:
        print(f"  decode step device time {dev_ms:.3f} ms (torch.profiler, "
              f"the kernels' sum), {kernels:.0f} kernels a step; busy share "
              f"of the p50 step {dev_ms / np.percentile(gen_ms, 50):.3f}, "
              f"device / bound {dev_ms / bound_ms:.2f}")
    print(f"  sample: {toks[0, SERVE_PROMPT:SERVE_PROMPT + 16].tolist()}")

    # (b) decode against forward on a fixed 16-token sequence, bf16 (the
    # served parameters, fp32 cache) and an fp32 copy.
    seq = SyntheticTokens(DataConfig(cfg.vocab_size, SERVE_TF_LEN, 2,
                                     seed=3)).batch_at(0)["tokens"].to(dev)
    u16 = float(torch.finfo(torch.bfloat16).eps) / 2
    for what, m in (("bf16", model), ("fp32", None)):
        if m is None:
            m = model.float()
            cfg_m = dataclasses.replace(cfg, param_dtype="float32")
        else:
            cfg_m = cfg
        with torch.inference_mode():
            full = forward(m, cfg_m, {"tokens": seq})
            c = init_cache(cfg_m, 2, SERVE_TF_LEN, torch.float32, device=dev)
            outs = []
            for t in range(SERVE_TF_LEN):
                lg, c = decode_step(m, cfg_m, c, seq[:, t])
                outs.append(lg)
        dec = torch.stack(outs, 1)
        diff = (dec - full).abs()
        big = float(full.abs().max())
        if what == "bf16":
            lim = SERVE_TF_BF16_UNITS * u16 * big
            ok = float(diff.max()) <= lim
            how = (f"max |dec - fwd| {float(diff.max()):.4f} against "
                   f"{SERVE_TF_BF16_UNITS} u_bf16 x max |fwd| {big:.3f} = "
                   f"{lim:.4f} ({float(diff.max()) / (u16 * big):.2f} u)")
        else:
            excess = float((diff - (2e-3 + 2e-2 * full.abs())).max())
            ok = excess <= 0
            how = (f"max |dec - fwd| {float(diff.max()):.3e} (max |fwd| "
                   f"{big:.3f}); worst of |dec - fwd| - (2e-3 + 2e-2 |fwd|)"
                   f" {excess:.3e} (limit 0)")
        print(f"path 3l (b) decode vs forward, {what} parameters, "
              f"{SERVE_TF_LEN} tokens, B = 2: {how}  "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"serve: decode disagrees with forward ({what})")
        del full, dec, diff, outs, c
        if what == "fp32":
            del m
    torch.cuda.empty_cache()

    # (c) the nine decoder-only architectures, card against CPU.
    t0 = time.perf_counter()
    worst = _reduced_on_card(torch, np, dev, seed)
    ok = all(w <= 1.0 for w in worst.values())
    print(f"path 3l (c) {len(worst)} reduced architectures, card vs CPU "
          f"(forward + 4 decode steps + caches; err / fp32 limit): "
          f"{', '.join(f'{n} {w:.3f}' for n, w in worst.items())}, "
          f"{time.perf_counter() - t0:.1f} s  {'ok' if ok else 'FAIL'}")
    check(ok and len(worst) == 9,
          "serve: a reduced architecture on the card disagrees with the CPU")

    # (d) the sidecar over (a)'s generated tokens, on the card.
    t0 = time.perf_counter()
    flushes = []
    with _sidecar_instrument(torch, flushes):
        err, muts, rows = serve_lm.personalize(toks[:, SERVE_PROMPT:],
                                               device=dev)
    got, want = {}, {}
    for f in flushes:
        for key, into in (("got", got), ("want", want)):
            for k, v in f[key].items():
                into[k] = into.get(k, 0) + v
    on_budget = all(f["got"] == f["want"] for f in flushes)
    ms = np.asarray([f["ms"] for f in flushes])
    print(f"path 3l (d) serve_lm sidecar over the generated tokens: max err "
          f"vs exact windowed solve {err:.3e} (limit 1e-2), {rows} rows in "
          f"{muts} mutations over {len(flushes)} store steps (widths "
          f"{sorted({w for f in flushes for w in f['widths']})}); launches "
          f"{got} against the budget {want}, every step on budget "
          f"{on_budget}; step p50 {np.percentile(ms, 50):.3f} / p90 "
          f"{np.percentile(ms, 90):.3f} ms (host clock, synced) on {card}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(err < 1e-2 and muts < rows,
          "serve: the sidecar misses its own assertions")
    check(on_budget and got.get("fused_chain", 0) == muts > 0
          and set(got) == {"fused_chain"},
          "serve: the sidecar's launches are off the flushes' budget")
    del model, cache, c0
    torch.cuda.empty_cache()
    print(f"path 3l: {time.perf_counter() - t_start:.1f} s")
    return got


# -- the training path (path 3m) ----------------------------------------------
#
# The port's training driver on full-width llama3.2-3b (bf16 parameters,
# remat), the JAX driver's --optimizer cholesky_precond at batch 8, seq 128:
# launch.train.build and the step from launch.steps.make_train_step, whose
# optimizer sees the JAX package's values tree, so cholesky_precond
# preconditions embed.tokens (a (48, 64, 64) fleet) and the stacked
# layers.ln1/ln2 scales ((1, 28, 28) each): three fused_chain launches a
# step. Then examples/train_lm at reduced() on the card (one launch a step),
# resumed to nothing, and the encoder-decoder family on the card against
# the CPU.

TRAIN_LM_ARCH, TRAIN_LM_BATCH, TRAIN_LM_SEQ = "llama3.2-3b", 8, 128
TRAIN_LM_STEPS = 20
#: The cholesky_precond settings of launch/train.py (rank 8, block 64) put
#: a factor on three leaves of llama3.2-3b: a launch each a step.
TRAIN_LM_LAUNCHES = 3
#: Free card memory path 3m (a) asks for: its step's peak above what the
#: smoke holds was 59.86 GB (PERF.md §6), and fragmentation takes more.
TRAIN_LM_NEED_GB = 66


def _timed_optimizer(torch, opt, ms):
    """``opt`` whose ``update`` records its CUDA-event time (ms) in
    ``ms``."""
    from repro_torch import optim

    def update(grads, state, params, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = opt.update(grads, state, params, **kw)
        b.record()
        ms.append((a, b))
        return out

    return optim.Optimizer(init=opt.init, update=update)


def _cuda_holdings(torch, scope, top=10):
    """What the process holds on the card: the bytes of every CUDA
    tensor's storage that Python reaches (each storage once), the names
    of ``scope`` (a frame's locals) that reach the most of it, and what
    the allocator counts beyond them (graph pools, library workspaces).
    Returns (GB in tensors, GB allocated, [(GB, name)])."""
    sizes = {}
    with warnings.catch_warnings():  # deprecated names answer isinstance
        warnings.simplefilter("ignore")
        for o in gc.get_objects():
            try:
                if isinstance(o, torch.Tensor) and o.is_cuda:
                    st = o.untyped_storage()
                    sizes[st.data_ptr()] = st.nbytes()
            except Exception:  # objects that refuse the questions
                continue

    def reach(x, out, depth=0):
        if isinstance(x, torch.Tensor):
            try:
                out.add(x.untyped_storage().data_ptr())
            except Exception:
                pass
        elif depth < 4 and not (callable(x) or isinstance(
                x, types.ModuleType)):
            kids = (x.values() if isinstance(x, dict) else
                    x if isinstance(x, (list, tuple)) else
                    vars(x).values() if hasattr(x, "__dict__") else ())
            for y in kids:
                reach(y, out, depth + 1)

    rows = []
    for name, x in scope.items():
        ptrs = set()
        reach(x, ptrs)
        gb = sum(sizes.get(p, 0) for p in ptrs) / 1e9
        if gb >= 0.01:
            rows.append((round(gb, 3), name))
    rows.sort(reverse=True)
    return (sum(sizes.values()) / 1e9, torch.cuda.memory_allocated() / 1e9,
            rows[:top])


def _reserved_by_pool(torch):
    """The allocator's segments by memory pool (the default pool is
    ``(0, 0)``, a CUDA graph's private pool any other): GB reserved and
    GB in live blocks."""
    out = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        pool = str(tuple(seg.get("segment_pool_id", (0, 0))))
        live = sum(b["size"] for b in seg["blocks"]
                   if b["state"] == "active_allocated")
        r, a = out.get(pool, (0, 0))
        out[pool] = (r + seg["total_size"], a + live)
    return {k: (round(r / 1e9, 3), round(a / 1e9, 3))
            for k, (r, a) in sorted(out.items())}


def _factored_update_ms(torch, opt, state, values, reps=3):
    """The optimizer's own ``update`` on a tree of only the leaves that
    hold a factor (their parameters, moments and factors, the last step's
    state; the first moment in the parameter's dtype stands in for the
    gradient): the Adam moments, the factor's scale, its ``fused_chain``
    update, the solves and the graft of those leaves, the code the step
    runs, and nothing of the other leaves. CUDA events, ms a call. The
    tree's leaf indices (0, 1, 2) seed other sketches than the step's,
    which cost the same. Nothing is donated or applied; launches here are
    not counted."""
    names = {}

    def walk(f, path=()):
        if isinstance(f, dict) and "c" not in f:
            for k in sorted(f):
                walk(f[k], path + (k,))
        elif f is not None:
            names[".".join(path)] = path

    walk(state["factors"])

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    params = {k: at(values, p) for k, p in names.items()}
    grads = {k: at(state["m"], p).to(params[k].dtype)
             for k, p in names.items()}
    sub = {"step": state["step"],
           "m": {k: at(state["m"], p) for k, p in names.items()},
           "v": {k: at(state["v"], p) for k, p in names.items()},
           "factors": {k: at(state["factors"], p)
                       for k, p in names.items()}}
    opt.update(grads, sub, params)
    ms, _ = timed(torch, lambda: opt.update(grads, sub, params), reps, 0)
    return ms, [(k, tuple(sub["factors"][k]["c"].data.shape))
                for k in sorted(names)]


def _train_step_profile(torch, step, model, state, batch, top=8):
    """One train step under ``torch.profiler``: its wall ms, the device's
    busy ms (the kernels' self times), the kernels and the aten calls it
    made, and the ``top`` kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(model, state, batch)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    busy, kernels, aten, rows = 0.0, 0, 0, []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = (getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0.0))
            busy += us
            kernels += e.count
            rows.append((us, e.count, e.key[:60]))
        elif e.key.startswith("aten::"):
            aten += e.count
    rows.sort(reverse=True)
    return {"wall_ms": round(wall, 1), "device_busy_ms": round(busy / 1e3, 1),
            "kernels": kernels, "aten_calls": aten,
            "top": [(k, n, round(us / 1e3, 2)) for us, n, k in rows[:top]]}


def _encdec_on_card(torch, np, dev, seed):
    """Path 3m (c): seamless-m4t-medium at reduced(), weights drawn on the
    CPU and carried to the card: loss_fn and its gradients, encode /
    decode_train with the collected cache, and 4 decode steps from it, on
    both, within fp32 tol_for(d_model * num_layers) * (1 + max |cpu|) (path
    3l (c)'s rule). Returns (worst err / limit, the number of outputs)."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import _grads
    from repro_torch.models import decode_step, init_model
    from repro_torch.models import encdec as ED
    from repro_torch.optim.base import tree_leaves

    cfg = get_config("seamless-m4t-medium").reduced()
    cpu = init_model(cfg, device="cpu", seed=seed)
    card = interop.params_from_numpy(interop.params_to_numpy(cpu), cfg,
                                     device=dev)
    rng = np.random.default_rng([seed, 12])
    batch = {"src_embeds": torch.from_numpy(rng.normal(
        size=(2, 12, cfg.d_model)).astype(np.float32))}
    for k in ("tokens", "labels"):
        batch[k] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 8)).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2))
                           .astype(np.int32))
    tol = 50 * float(torch.finfo(torch.float32).eps) * (
        cfg.d_model * cfg.num_layers)

    def run(model, where):
        b = {k: v.to(where) for k, v in batch.items()}
        total, _, grads = _grads(cfg, model, b)
        out = [total] + tree_leaves(grads)
        with torch.no_grad():
            enc = ED.encode(model, cfg, b["src_embeds"])
            logits, (k, v, xk, xv) = ED.decode_train(
                model, cfg, enc, b["tokens"], collect_cache=True)
            out += [enc, logits, k, v, xk, xv]
            cache = ED.init_encdec_cache(cfg, 2, 12, 12, torch.float32,
                                         device=where)
            cache["k"][:, :, :8], cache["v"][:, :, :8] = k, v
            cache["xk"], cache["xv"] = xk, xv
            cache["pos"] = cache["pos"] + 8
            for t in range(4):
                lg, cache = decode_step(model, cfg, cache, nxt[t].to(where))
                # The step wrote its cache in place: keep this step's.
                out += [lg, cache["k"].clone(), cache["v"].clone()]
        return out

    worst = 0.0
    ours, refs = run(card, dev), run(cpu, "cpu")
    for ref, got in zip(refs, ours):
        check(got.device.type == "cuda", "encdec: an output left the card")
        err = float((got.cpu().float() - ref.float()).abs().max())
        worst = max(worst, err / (tol * (1 + float(ref.abs().max()))))
    return worst, len(refs)


# -- the roofline and the dry run (path 3n) -----------------------------------
#
# (a) One more step of path 3m's full-width llama3.2-3b cholesky_precond
# training, before its model and state are freed, under the op counter
# (roofline.opcount, memory tracked), beside the same cell traced on the
# meta device at one rank (launch.dryrun.trace_cell): the dot FLOPs must be
# equal, the step must take its 3 fused_chain launches, and the roofline
# terms (roofline.analysis.analyze) stand beside path 3m's measured p50.
# (b) The dry run itself (python -m repro_torch.launch.dryrun) on the
# single-pod fake world of 256 ranks for three full-size cells, in
# subprocesses started right after (a): they trace on the host's CPU
# beside path 3m's untimed checks ((b) and (c)), and path 3n waits for
# their records before the kernel phases that time anything.

#: Path 3m's first and last losses at --seed 0 (PR 22's smoke): path 3n's
#: repairs to the model code must leave them as they were.
TRAIN_LM_LOSSES_SEED0 = (489.9023, 404.2239)
#: The dry-run cells of path 3n (b): the paper-technique cell the JAX
#: dry run names, a decode cell with its cache placed on the mesh, and
#: an expert-parallel MoE training cell.
DRYRUN_CELLS = (("llama3.2-3b", "train_4k", "cholesky_precond"),
                ("llama3.2-3b", "decode_32k", "adamw"),
                ("arctic-480b", "train_4k", "adamw"))
#: The same cells' records before (H100 host, torch 2.11): the llama
#: cells' before the decode cache was donated and the loss reduced across
#: vocabulary shards, the arctic cell's before its MoE dispatch was made
#: expert-parallel. FLOPs a device (None: not kept), collective bytes a
#: device and ``temp_bytes``.
DRYRUN_BEFORE = {("llama3.2-3b", "train_4k"): (None, 1.708e12, 49.51e9),
                 ("llama3.2-3b", "decode_32k"): (None, 2.85e6, 92.08e9),
                 ("arctic-480b", "train_4k"): (3.88e15, 1.67e13, 387.0e9)}
#: Seconds path 3n waits at most for (b)'s subprocesses to finish.
DRYRUN_WAIT_S = 300


def dryrun_in_background(work_dir):
    """Start path 3n (b): one ``python -m repro_torch.launch.dryrun``
    process a cell of ``DRYRUN_CELLS``, one intra-op thread each, output
    in ``work_dir``. Returns the list of (cell, process, log path, out
    path, start time)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    runs = []
    for arch, shape, opt in DRYRUN_CELLS:
        log = os.path.join(work_dir, f"dryrun_{arch}_{shape}.log")
        out = os.path.join(work_dir, f"dryrun_{arch}_{shape}.jsonl")
        with open(log, "w") as f:
            p = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                 arch, "--shape", shape, "--optimizer", opt, "--out", out],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=HERE)
        runs.append(((arch, shape, opt), p, log, out, time.perf_counter()))
    return runs


def dryrun_phase(runs):
    """Path 3n (b): wait for the dry-run processes (at most
    ``DRYRUN_WAIT_S``), print each record, check each exited 0 with a
    record of the JAX keys; stops any process still running."""
    check(len(runs) == len(DRYRUN_CELLS), "path 3n (b): the dry run never "
          "started")
    t0 = time.perf_counter()
    for (arch, shape, opt), p, log, out, started in runs:
        done_before = p.poll() is not None
        try:
            p.wait(timeout=max(1.0, DRYRUN_WAIT_S
                               - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        took = time.perf_counter() - started
        recs = []
        if os.path.exists(out):
            recs = [json.loads(x) for x in open(out).read().splitlines()]
        tail = open(log).read().splitlines()[-3:]
        when = ("had ended when path 3n (b) began waiting" if done_before
                else f"ended {took:.1f} s after its start")
        trace = f"trace {recs[0]['compile_s']} s" if recs and \
            "compile_s" in recs[0] else "no record"
        print(f"path 3n (b) dryrun {arch} x {shape} --optimizer {opt} on the "
              f"fake 16x16 world: rc {p.returncode} ({when}; {trace}); "
              f"{tail[-1] if tail else ''}")
        for rec in recs:
            print(f"  record: {json.dumps(rec)}")
            flops, coll, temp = DRYRUN_BEFORE[(arch, shape)]
            if "error" not in rec:
                if flops is not None:
                    print(f"  FLOPs a device {rec['flops_per_device']:.4g} "
                          f"(before: {flops:.4g})")
                print(f"  collective bytes a device "
                      f"{rec['collective_bytes_per_device']:.4g} (before: "
                      f"{coll:.4g}), temp_bytes "
                      f"{rec['memory_analysis']['temp_bytes'] / 1e9:.2f} GB "
                      f"(before: {temp / 1e9:.2f} GB), alias_bytes "
                      f"{rec['memory_analysis']['alias_bytes'] / 1e9:.2f} "
                      f"GB")
        check(p.returncode == 0 and len(recs) == 1
              and "error" not in recs[0] and recs[0]["flops_per_device"] > 0,
              f"path 3n (b): the dry run of {arch} x {shape} failed "
              f"({tail})")
    print(f"path 3n (b): waited {time.perf_counter() - t0:.1f} s")


def roofline_phase(torch, cfg, step, model, state, batch, p50_ms,
                   read_counts):
    """Path 3n (a) (see the comment above). Returns its seconds."""
    from repro_torch import optim
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun as DR
    from repro_torch.roofline import analysis as RA
    from repro_torch.roofline import opcount

    t0 = time.perf_counter()
    cell = ShapeCell("train_lm", TRAIN_LM_SEQ, TRAIN_LM_BATCH, "train")
    gc.collect()
    torch.cuda.synchronize()
    before = read_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with opcount.OpCounter(track_memory=True) as cnt:
        step(model, state, batch)
        torch.cuda.synchronize()
    card_peak = torch.cuda.max_memory_allocated() - base
    after = read_counts()
    launches = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    t_card = time.perf_counter() - t0
    # The same cell on the meta device, one rank: the optimizer as path
    # 3m's (rank 8, block 64), the accumulation-free step.
    one = types.SimpleNamespace(shape={"data": 1, "model": 1})
    tr = DR.trace_cell(cfg, cell, one, grad_accum=1,
                       opt=optim.cholesky_precond(3e-4, rank=8,
                                                  block_size=64))
    meta = tr["counted"]
    roof = RA.analyze(cnt, cfg, cell, 1,
                      params_local_bytes=tr["params_local_bytes"],
                      opt_local_bytes=tr["opt_local_bytes"],
                      memory=tr["memory"])
    print(f"path 3n (a) roofline of one more path 3m step "
          f"({cfg.name} full width, batch {TRAIN_LM_BATCH} seq "
          f"{TRAIN_LM_SEQ}, cholesky_precond rank 8 block 64, one rank): "
          f"dot FLOPs counted on the card {cnt.flops:.6e} "
          f"({cnt.flops_by_op}), on the meta device {meta.flops:.6e} "
          f"(trace {tr['seconds']:.1f} s); model_flops "
          f"{roof.model_flops:.6e}, useful_ratio {roof.useful_ratio:.4f}; "
          f"terms compute {roof.compute_s * 1e3:.3f} ms, memory "
          f"{roof.memory_s * 1e3:.3f} ms (analytic {roof.bytes_accessed:.4e}"
          f" B), collective {roof.collective_s * 1e3:.3f} ms -> "
          f"{roof.bottleneck}-bound, beside path 3m's measured step p50 "
          f"{p50_ms:.3f} ms ({100 * roof.compute_s * 1e3 / p50_ms:.2f} % of "
          f"it is the compute term); tracked peak of the step's new storages "
          f"{cnt.peak_bytes / 1e9:.3f} GB (meta trace "
          f"{meta.peak_bytes / 1e9:.3f} GB) beside "
          f"torch.cuda.max_memory_allocated {card_peak / 1e9:.3f} GB above "
          f"the step's start; memory_analysis {roof.per_device_memory}; "
          f"launches in the counted step {launches}; card step under the "
          f"counter {t_card:.1f} s")
    check(cnt.flops == meta.flops and cnt.flops > 0,
          "path 3n (a): the card's counted FLOPs differ from the meta "
          "device's")
    check(launches == {"fused_chain": TRAIN_LM_LAUNCHES},
          f"path 3n (a): the counted step took {launches}, not "
          f"{TRAIN_LM_LAUNCHES} fused_chain launches")
    check(cnt.collectives == [] and meta.collectives == [],
          "path 3n (a): a one-rank step counted a collective")
    return time.perf_counter() - t0


def train_lm_phase(torch, np, dev, seed, card, work_dir, read_counts,
                   reset_counts, after_timed):
    """Path 3m. Returns the fused_chain launches of its counted runs ((a)'s
    steps and (b)'s), by kernel. ``after_timed()`` is called once its
    timed steps and path 3n (a) are done."""
    from repro_torch import optim
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.examples import train_lm
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.train import build
    from repro_torch.models import values_tree
    from repro_torch.roofline.analysis import PEAK_FLOPS, active_params, \
        model_flops

    t_start = time.perf_counter()
    cfg = get_config(TRAIN_LM_ARCH)
    check(cfg.remat and cfg.param_dtype == "bfloat16",
          "train_lm: the full config is not bf16 with remat")
    # (a) full width: build, then 20 steps of the training step.
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_gb = torch.cuda.memory_allocated() / 1e9
    sched = optim.warmup_cosine(3e-4, warmup_steps=max(TRAIN_LM_STEPS // 10,
                                                       1),
                                total_steps=TRAIN_LM_STEPS)
    upd_ev = []
    inner = optim.cholesky_precond(sched, rank=8, block_size=64)
    opt = _timed_optimizer(torch, inner, upd_ev)
    t0 = time.perf_counter()
    model, state, step = build(cfg, opt, single_device_mesh())
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9 - base_gb
    data = SyntheticTokens(DataConfig(cfg.vocab_size, TRAIN_LM_SEQ,
                                      TRAIN_LM_BATCH, seed=1), device=dev)
    host_ms, dev_ms, losses, per_step = [], [], [], []
    reset_counts()
    for i in range(TRAIN_LM_STEPS):
        batch = data.batch_at(i)
        before = read_counts()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        model, state, metrics = step(model, state, batch)
        b.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(a.elapsed_time(b))
        losses.append(float(metrics["loss"]))
        after = read_counts()
        per_step.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
    got = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    retries = torch.cuda.memory_stats().get("num_alloc_retries", 0)
    prof = _train_step_profile(torch, step, model, state,
                               data.batch_at(TRAIN_LM_STEPS))
    upd_ms = [x.elapsed_time(y) for x, y in upd_ev[:TRAIN_LM_STEPS]]
    flops = model_flops(cfg, ShapeCell("train_lm", TRAIN_LM_SEQ,
                                       TRAIN_LM_BATCH, "train"))
    # The first step pays the cuBLAS and allocator warmup: the percentiles
    # are of the other steps.
    hm, dm, um = (np.asarray(x[1:]) for x in (host_ms, dev_ms, upd_ms))
    p50, p90 = np.percentile(dm, 50), np.percentile(dm, 90)
    pre_ms, pre_leaves = _factored_update_ms(torch, inner, state,
                                             values_tree(model))
    print(f"path 3m (a) train {TRAIN_LM_ARCH} full width (28 layers, d 3072, "
          f"{active_params(cfg) / 1e9:.3f} B parameters, bf16, remat), "
          f"cholesky_precond rank 8 block 64, batch {TRAIN_LM_BATCH} seq "
          f"{TRAIN_LM_SEQ}, {TRAIN_LM_STEPS} steps on {card}: build "
          f"{t_build:.1f} s; step p50 {p50:.3f} / p90 {p90:.3f} ms (CUDA "
          f"events), host clock p50 {np.percentile(hm, 50):.3f} / p90 "
          f"{np.percentile(hm, 90):.3f} ms; first step {dev_ms[0]:.1f} ms; "
          f"tokens/s {TRAIN_LM_BATCH * TRAIN_LM_SEQ / (p50 / 1e3):.1f}; "
          f"model FLOPs a step {flops:.4e} (6 N tokens + attention), "
          f"{flops / (p50 / 1e3) / 1e12:.1f} TFLOP/s = "
          f"{100 * flops / (p50 / 1e3) / PEAK_FLOPS:.2f} % of "
          f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s; optimizer update p50 "
          f"{np.percentile(um, 50):.3f} ms "
          f"({100 * np.percentile(um, 50) / p50:.1f} % of the step), of it "
          f"the factored leaves' update (opt.update on {pre_leaves} "
          f"alone: moments, scale, fused_chain, solves, graft) "
          f"{pre_ms:.3f} ms ({100 * pre_ms / p50:.1f} %); memory: state "
          f"{state_gb:.2f} GB, peak {peak_gb:.2f} GB above the "
          f"{base_gb:.2f} GB held before, max reserved "
          f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")
    print(f"  where a step goes (torch.profiler, one more step, not "
          f"counted): {prof}; allocator retries over the 20 steps "
          f"{retries}")
    print(f"  steps' ms (events): {[round(x, 3) for x in dev_ms]}")
    print(f"  losses: {[round(x, 4) for x in losses]}")
    print(f"  launches a step: {per_step}")
    check(all(np.isfinite(losses)), "train_lm: a loss is not finite")
    check(losses[-1] < losses[0], "train_lm: the loss did not fall")
    check(all(d == {"fused_chain": TRAIN_LM_LAUNCHES} for d in per_step),
          f"train_lm: a step took other than {TRAIN_LM_LAUNCHES} fused_chain "
          "launches")
    check(len(pre_leaves) == TRAIN_LM_LAUNCHES,
          "train_lm: not the three preconditioned leaves")
    if seed == 0:
        check((round(losses[0], 4), round(losses[-1], 4))
              == TRAIN_LM_LOSSES_SEED0,
              f"train_lm: the losses moved from {TRAIN_LM_LOSSES_SEED0}")
    # Path 3n (a), on this model, state and batch before they go.
    t3n = roofline_phase(torch, cfg, step, model, state,
                         data.batch_at(TRAIN_LM_STEPS + 1), p50, read_counts)
    print(f"path 3n (a): {t3n:.1f} s")
    after_timed()
    del model, state, step, metrics, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (b) examples/train_lm at reduced() on the card, then resumed.
    t0 = time.perf_counter()
    ckpt = os.path.join(work_dir, "train_lm_ckpt")
    reset_counts()
    losses_b = train_lm.main(["--ckpt-dir", ckpt])
    got_b = read_counts()
    resumed = train_lm.main(["--ckpt-dir", ckpt])
    again = read_counts()
    print(f"path 3m (b) examples/train_lm (reduced, cholesky_precond, "
          f"{len(losses_b)} steps): loss {losses_b[0]:.4f} -> "
          f"{losses_b[-1]:.4f}, launches "
          f"{ {k: v for k, v in got_b.items() if v} }; resumed: "
          f"{len(resumed)} steps, launches "
          f"{ {k: again[k] - got_b[k] for k in again if again[k] - got_b[k]} }"
          f"; {time.perf_counter() - t0:.1f} s")
    check(len(losses_b) == 200 and losses_b[-1] < losses_b[0]
          and all(np.isfinite(losses_b)), "train_lm (b): the loss did not fall")
    check({k: v for k, v in got_b.items() if v} == {"fused_chain": 200},
          "train_lm (b): not one fused_chain launch a step")
    check(resumed == [] and again == got_b,
          "train_lm (b): the resumed call trained")

    # (c) the encoder-decoder family, card against CPU.
    t0 = time.perf_counter()
    worst, n_out = _encdec_on_card(torch, np, dev, seed)
    print(f"path 3m (c) seamless-m4t-medium reduced, card vs CPU: loss, "
          f"{n_out} outputs (gradients, encode, decode_train and its cache, "
          f"4 decode steps): worst err / limit {worst:.4f}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(worst <= 1.0, "encdec: the card disagrees with the CPU")
    print(f"path 3m: {time.perf_counter() - t_start:.1f} s")
    return {k: got[k] + got_b.get(k, 0) for k in got}


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
    from repro_torch.kernels.probes.gemm_apply_time import device_ms

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
    # Path 3n (b) starts inside path 3m, after its timed steps.
    dry_dir = tempfile.mkdtemp(prefix="smoke_dryrun_")
    dry_runs = []
    atexit.register(lambda: [r[1].kill() for r in dry_runs
                             if r[1].poll() is None])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(args.seed)

    def spd_factor(B, n, k, dtype, sigma, gen=None):
        """make_problem's procedure (B, V ~ U[0,1], A = B^T B + I) on the
        card in f64; for a downdate the start is the factor of A + V V^T,
        so A' - V V^T = A stays PD. bf16 adds n I: the rounding of the
        stored factor must not push the downdated matrix out of the PD
        cone. ``gen``: the generator (default the script's)."""
        gen = rng if gen is None else gen
        Bm = torch.from_numpy(gen.uniform(size=(B, n, n))).to(dev)
        V = torch.from_numpy(gen.uniform(size=(B, n, k))).to(dev)
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

    # The wide block's data and the Kalman smoother's model and
    # measurements (paths 3d, 3e). The block chain is compared with its
    # plain version on the smoother's first update and on the wide block;
    # the plain walks, minutes of host time, run on the CPU in a worker
    # process from here on, beside every phase (no launch); the kernel runs
    # after the paths.
    Sw, Vw = banded(1, 512, 64, 16)
    Sw = BlockTriDiagStorage(Sw.diag[0], Sw.off[0]).astype(torch.float32)
    Vw = Vw[0].float()
    T_kf, chunk = 8192, 8
    Fm, Hm, Qm, Rm, P0m = kf_model(np)
    Ad, Ao = kf_prior_blocks(np, T_kf, Fm, Qm, P0m)
    n_kf = T_kf * KF_D
    Rinv = np.linalg.inv(Rm)
    HtRih = Hm.T @ np.linalg.cholesky(Rinv)         # H^T R^{-1/2}, (D, M)
    blk = torch.from_numpy(np.kron(np.eye(chunk), HtRih)).float().to(dev)

    def meas(lo, hi):
        """V of the measurements at times lo..hi-1: block-local columns."""
        Vm = torch.zeros((n_kf, (hi - lo) * KF_M), device=dev)
        Vm[lo * KF_D:hi * KF_D] = blk[:(hi - lo) * KF_D, :(hi - lo) * KF_M]
        return Vm

    # The smoother's prior factor, built once: path 3e walks this object,
    # and its storage is the block chain comparison's input.
    t0 = time.perf_counter()
    fk = CholFactor.from_blocktridiag(torch.from_numpy(Ad).float().to(dev),
                                      torch.from_numpy(Ao).float().to(dev))
    torch.cuda.synchronize()
    t_prior = time.perf_counter() - t0
    btd_cmp = {"smoother": (fk.data.diag[None], fk.data.off[None],
                            meas(0, chunk).mT.contiguous()[None]),
               "wide": (Sw.diag[None], Sw.off[None],
                        Vw.mT.contiguous()[None])}
    join_walks = plain_walks_in_background(torch, btd_cmp)

    # -- 2. kernel vs plain, small cases --------------------------------------
    laps = [time.perf_counter()]

    def lap(what):
        laps.append(time.perf_counter())
        print(f"{what}: {laps[-1] - laps[-2]:.1f} s")

    # 2a. the fused chain, as in slice 1, plus the repaired k > 32 and
    # panel > 256 routes (column groups, the panel's divisor <= 256).
    # n = 256 walks k = 16 in fp32 and bf16 only (k = 1 and f64 are walked
    # at n = 100): the plain walks are this phase's host time.
    cases = [(1, n, P, k, s, pa, dt)
             for n, P, k, s, pa, dt in itertools.product(
                 (100, 256), (32, 64), (1, 16), (1, -1), ("gemm", "paper"),
                 dtypes)
             if n == 100 or (k == 16 and dt[0] != torch.float64)]
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

    lap("phase 2a")

    # 2b. the per-panel kernels: each output against its plain version.
    # The diagonal pass sweeps in the plain recurrence's own operations
    # (chol_tile.cuh sweep_wavefront): D_new, c, s and T equal its plain
    # version's bit for bit.
    # The shapes off the 32-column grid draw from a generator of their
    # own, so that the phases after this one keep the inputs they have
    # always had.
    off_grid = np.random.default_rng(args.seed + 16)
    cases = list(itertools.product(
        ((1, 256, 16), (3, 64, 1), (2, 4, 16), (1, 128, 32), (3, 37, 32),
         (1, 100, 1)), (1, -1), dtypes))
    print(f"phase 2b: diag_block vs plain, {len(cases)} cases (D_new, c, s, "
          f"T each equal, torch.equal)")
    for (B, P, k), sigma, (dt, acc) in cases:
        L, V = spd_factor(B, P, k, dt, sigma,
                          gen=off_grid if P in (37, 100) else None)
        vtd = V.mT.contiguous()
        out = K.diag_block(L, vtd, sigma=sigma, accum_dtype=acc)
        ref = K._diag_block_plain(L, vtd, sigma, acc)
        same = [bool(torch.equal(x, y)) for x, y in zip(out, ref)]
        ok = all(same) and all(bool(torch.isfinite(x).all()) for x in out)
        print(f"  B={B} P={P} k={k} sigma={sigma:+d} {str(dt)[6:]:8s} "
              f"equal D {same[0]} c {same[1]} s {same[2]} T {same[3]}  "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, "phase 2b: diag_block differs from its plain version")

    lap("phase 2b")

    # The paper apply is a wavefront in apply_rotations' own operations:
    # R and vt equal its plain version's bit for bit (torch.equal); the
    # gemm apply is held to 4 P units.
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
        finite = all(bool(torch.isfinite(x).all()) for x in out)
        if apply == "paper":
            same = [bool(torch.equal(x, y)) for x, y in zip(out, ref)]
            ok = all(same) and finite
            got = f"equal R {same[0]} vt {same[1]}"
        else:
            unit = unit_roundoff(torch, dt)
            errs = [units(torch, x, y, unit) for x, y in zip(out, ref)]
            lim = entry_limit(torch, dt, P)
            ok = max(errs) <= lim and finite
            got = f"R {errs[0]:.3f} vt {errs[1]:.3f} u (limit {lim:g})"
        print(f"  B={B} P={P} k={k} w={w} {apply:5s} sigma={sigma:+d} "
              f"{str(dt)[6:]:8s} {got}  {'ok' if ok else 'FAIL'}")
        check(ok, f"phase 2c: panel_apply_{apply} disagrees with plain")

    lap("phase 2c")

    # Blocks above 256 rows (swept as row sub-tiles in the same launch)
    # are held as tests/test_torch_cuda.py holds block chains: 4 nb b units
    # in fp32 and f64; in bf16 two witnesses (the kernel no further from
    # the float64 chain refactorization than the plain version plus 4).
    cases = list(itertools.product(
        ((1, 64, 4, 16), (3, 16, 16, 5), (2, 4, 64, 32)), (1, -1), dtypes))
    # Two blocks (one off-diagonal apply) keep the walk's plain version,
    # a Python loop over rows, inside the smoke's time.
    wide_cases = list(itertools.product(((1, 2, 320, 16), (1, 2, 512, 16)),
                                        (1, -1), dtypes))
    print(f"phase 2d: btd_chain vs plain, {len(cases)} cases, and "
          f"{len(wide_cases)} with blocks above 256 rows")
    for (B, nb, b, k), sigma, (dt, acc) in cases + wide_cases:
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
        finite = bool(torch.isfinite(d_k).all() and torch.isfinite(o_k).all())
        if b > 256 and dt == torch.bfloat16:
            ad, ao = S.astype(torch.float64).matrix_blocks()
            vd, vo = vvt_blocks(vt.mT, b)
            orc = BlockTriDiagStorage.from_matrix_blocks(ad + sigma * vd,
                                                         ao + sigma * vo)

            def to_orc(d, o):
                return max(units(torch, torch.triu(d), torch.triu(orc.diag),
                                 unit), units(torch, o, orc.off, unit))

            e_k, e_p = to_orc(d_k, o_k), to_orc(d_p, o_p)
            ok = e_k <= e_p + 4.0 and finite
            print(f"  B={B} nb={nb} b={b} k={k} sigma={sigma:+d} "
                  f"{str(dt)[6:]:8s} vs plain diag {errs[0]:.3f} off "
                  f"{errs[1]:.3f} u (reported); vs f64 chain kernel "
                  f"{e_k:.3f} plain {e_p:.3f} u (limit: plain's + 4)  "
                  f"{'ok' if ok else 'FAIL'}")
        else:
            ok = max(errs) <= lim and finite
            print(f"  B={B} nb={nb} b={b} k={k} sigma={sigma:+d} "
                  f"{str(dt)[6:]:8s} diag {errs[0]:.3f} off {errs[1]:.3f} u "
                  f"(limit {lim:g})  {'ok' if ok else 'FAIL'}")
        check(ok, "phase 2d: btd_chain disagrees with its plain version")

    lap("phase 2d")

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
    lap("phase 2e")

    # 2f. the fused chain on a rank above one launch's 32 at a factor
    # smaller than the rank: B = 3, P = 4, n = 2P + 3 = 11, k = 33, fp32,
    # a paper downdate, two launches (32 and 1 columns), the plain version
    # walked in the same column groups; tests/test_torch_cuda.py's
    # test_fused_sweep_off_the_warp_grid_matches_plain case, its inputs
    # made as that test makes them (seed P + k), its limit 4 n.
    B33, P33, k33, n33 = 3, 4, 33, 11
    r33 = np.random.default_rng(P33 + k33)
    Bm33 = torch.from_numpy(r33.uniform(size=(B33, n33, n33))).to(dev)
    V33 = torch.from_numpy(r33.uniform(size=(B33, n33, k33))).to(dev)
    A33 = Bm33.mT @ Bm33 + torch.eye(n33, dtype=torch.float64, device=dev)
    L33 = torch.linalg.cholesky(A33 + V33 @ V33.mT).mT.contiguous().float()
    Lp33, Vp33, _ = blocked._pad_to_panels(L33, V33.float(), P33)
    Lp33, vt33 = Lp33.contiguous(), Vp33.mT.contiguous()
    before = F.LAUNCHES.count
    o33 = F.fused_chain(Lp33, vt33, sigma=-1, panel=P33, panel_apply="paper")
    launches33 = F.LAUNCHES.count - before
    p33 = Lp33
    for g in F.rank_groups(k33):
        p33 = F.fused_chain_plain(p33, vt33[:, g].contiguous(), sigma=-1,
                                  panel=P33, panel_apply="paper")
    e33 = entry_err(torch, torch.triu(o33)[:, :n33, :n33],
                    torch.triu(p33)[:, :n33, :n33],
                    unit_roundoff(torch, torch.float32))
    lim33 = entry_limit(torch, torch.float32, n33)
    want33 = F.launch_count(n33, P33, method="fused", k=k33)
    ok = (e33 <= lim33 and launches33 == want33
          and bool(torch.isfinite(o33).all()))
    print(f"phase 2f: fused B={B33} n={n33} panel={P33} k={k33} paper "
          f"downdate fp32 vs plain {e33:.3f} u (limit {lim33:g}), launches "
          f"{launches33} (want {want33})  {'ok' if ok else 'FAIL'}")
    check(ok, "phase 2f: the k = 33 fused paper downdate disagrees with "
          "plain")
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

    # 3d. a wide block: b = 64, nb = 512, k = 16, fp32 (Sw, Vw made above).
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

    # 3e. the Kalman smoother: T = 8192 timesteps, b = 4, k = 16 (its
    # model, measurements and prior factor fk made above).
    truth, ys = kf_simulate(np, T_kf, Fm, Hm, Qm, Rm, P0m, args.seed)
    eta = (ys @ Rinv @ Hm).reshape(-1)              # sum H^T R^-1 y_t
    reset_counts()
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
    # Path 3k (iii)'s one-rank side, before the four ranks start (they
    # restore its checkpoint): the store traffic on the one-rank mesh.
    k3_root = tempfile.mkdtemp(prefix="chip_smoke_3k_")
    fleet1, verdicts1, pending1, mode1 = small_store_traffic(
        torch, np, mesh1, args.seed, os.path.join(k3_root, "ckpt1"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res4, counts4, checks4, store4 = run_four_ranks(
        torch, {"L": Ls0, "V": Vs, "Lf": Lf, "Vf": Vf}, timeout=400,
        root=k3_root, seed=args.seed)
    print(f"path sharded, four ranks on the card: all four exited 0, "
          f"{time.perf_counter() - t0:.1f} s")
    for rank, rank_checks in enumerate(checks4):
        for what, err, lim, ok in rank_checks:
            print(f"  rank {rank}: {what} vs plain {err:.3f} u (limit "
                  f"{lim:g})  {'ok' if ok else 'FAIL'}")
            check(ok, f"rank {rank}: {what} disagrees with its plain version")
    check(all(len(c) == 9 for c in checks4),
          "a rank did not check all its kernels")
    for name, strat, is_fleet, prec in SHARDED_CASES:
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

    # Path 3k (iii): the sharded store's traffic on four ranks against
    # one, each rank count's checkpoint restored on the other, and
    # four-rank gradients against one-rank gradients (correctness only).
    from repro_torch.stream import restore_service

    r4 = torch.load(os.path.join(k3_root, "store4.pt"))
    n3k = SMALL_STORE[0]
    e_st = entry_err(torch, r4["fleet"].to(dev), fleet1, u32)
    lim_st = entry_limit(torch, torch.float32, n3k)
    same_v = all(json.loads(json.dumps(verdicts1)) == x["verdicts"]
                 for x in store4)
    rejected = any(not ok for v in verdicts1 for _, ok in v)
    back1 = restore_service(os.path.join(k3_root, "ckpt4"), mesh=mesh1,
                            device=dev)
    from_four = torch.equal(
        distributed.gather(back1.store.factor.data),
        r4["fleet"].to(dev)) and back1.pending("u0") == 1
    from_one = torch.equal(r4["restored1"].to(dev), fleet1) and all(
        x["restored_pending"] == pending1 == 1 for x in store4)
    modes = [x["mode"] for x in store4]
    gL1, gV1 = sharded_grads(torch, mesh1, Lf[:SMALL_STORE[1]],
                             Vf[:SMALL_STORE[1]])
    up1 = distributed.gather(chol_update_batched(
        Lf[:SMALL_STORE[1]].double(), Vf[:SMALL_STORE[1]].double(),
        method="sharded", mesh=mesh1, panel=P))
    kap = _kappa2(torch, up1)
    g_lim = math.sqrt(n3k) * 2.0 ** -24 * kap
    g_err = max(float((a.to(dev).double() - b.double()).abs().max()
                      / b.double().abs().max())
                for a, b in ((r4["gL"], gL1), (r4["gV"], gV1)))
    print(f"path 3k (iii) sharded store, four ranks (step_mode "
          f"{modes}) against one (step_mode {mode1!r}), n={n3k} "
          f"B={SMALL_STORE[1]}: fleet {e_st:.3f} u (limit {lim_st:g}); "
          f"verdicts equal {same_v} (a refused downdate: {rejected}); "
          f"four-rank checkpoint restored on one rank bit for bit "
          f"{from_four}, one-rank checkpoint restored on four "
          f"{from_one}; gradients four against one relative {g_err:.3e} "
          f"(limit sqrt(n) u kappa_2 = {g_lim:.3e}, kappa_2 {kap:.1f})")
    check(e_st <= lim_st and same_v and rejected,
          "3k (iii): the four-rank store disagrees with one rank")
    check(from_four and from_one,
          "3k (iii): a checkpoint did not restore across rank counts")
    check(mode1 == "graphs" and modes == ["eager"] * 4,
          "3k (iii): step_mode is not graphs on one rank and eager on "
          "four gloo ranks")
    check(g_err <= g_lim, "3k (iii): four-rank gradients disagree with "
          "one rank's")
    del r4, back1, gL1, gV1, up1
    shutil.rmtree(k3_root, ignore_errors=True)

    # 3i. the stream stack: StreamService -> FactorStore -> CUDA graphs of
    # the fused chain (dense fleets, fp32 and bf16) and the block chain (a
    # structured fleet), with its five checks and the timings of the dense
    # fp32 store (stream_phase, STREAM_RUNS).
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    stream_dir = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    trace_path = os.path.join(HERE, "chiprun_out", "stream_trace.json")
    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    try:
        runs, dense_timing = stream_phase(torch, np, dev, args.seed,
                                          stream_dir, trace_path, card)
    finally:
        shutil.rmtree(stream_dir, ignore_errors=True)
    torch.cuda.synchronize()
    # The served traffic's own launches (each run's window: warmups, the
    # eager comparisons and the timings left out).
    got = {name: sum(r["path_launches"][name] for r in runs)
           for name in counters}
    add_path(got)
    want = {}
    for r in runs:
        for kern, cnt in r["want"].items():
            want[kern] = want.get(kern, 0) + cnt
    print(f"path stream: served launches {got} (flush budget {want}), "
          f"{time.perf_counter() - t0:.1f} s")
    check(set(want) == {"fused_chain", "btd_chain"}
          and all(got[k] == v > 0 for k, v in want.items())
          and sum(got.values()) == sum(want.values()),
          "the stream path's launches are off the flushes' budget")
    torch.cuda.empty_cache()

    # 3j. gradients through the update (the Murray rule around the fused
    # chain at n = 5000 and on the B = 64 fleet, fp32 and bf16, around the
    # block chain on the wide block) and CholeskyPrecond training on one
    # llama3.2-3b layer (train_phase): the launches of its own runs.
    reset_counts()
    got = train_phase(torch, np, dev, args.seed, (f0.data, V), (Lf, Vf),
                      (Sw, Vw), card)
    add_path(got)
    print(f"path train: launches {got}")
    torch.cuda.empty_cache()

    # 3k. the stream store's sharded placement on the one-rank mesh of 3g:
    # (i) StreamService over FactorStore(backend='sharded', mesh=mesh1) at
    # 3i's dense shapes and traffic (fp32, bf16), its steps CUDA graphs of
    # the sharded driver's diag_block and panel_apply_sharded kernels, with
    # 3i's five checks and the sharded both step timed beside 3i's dense
    # one; (ii) gradients through method='sharded' on 3g's n = 5120 factor
    # and the B = 64 fleet. (iii) ran in 3h's four-rank spawn.
    t3k = time.perf_counter()
    reset_counts()
    sdir = tempfile.mkdtemp(prefix="chip_smoke_sharded_stream_")
    try:
        sruns, stiming = stream_phase(torch, np, dev, args.seed, sdir, None,
                                      card, runs=SHARDED_STREAM_RUNS,
                                      mesh=mesh1)
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    torch.cuda.synchronize()
    got = {name: sum(r["path_launches"][name] for r in sruns)
           for name in counters}
    add_path(got)
    want = {}
    for r in sruns:
        for kern, cnt in r["want"].items():
            want[kern] = want.get(kern, 0) + cnt
    served = {k: v for k, v in got.items() if v}
    print(f"path 3k (i) sharded stream: served launches {served} (flush "
          f"budget {want}), step_mode {[r['step_mode'] for r in sruns]}, "
          f"{time.perf_counter() - t3k:.1f} s")
    check(served == want and set(want) == {"diag_block",
                                           "panel_apply_sharded"},
          "3k (i): the sharded stream's launches are off the flushes' "
          "budget")
    check(all(r["step_mode"] == "graphs" for r in sruns),
          "3k (i): the one-rank sharded store's steps are not graphs")
    if stiming and dense_timing:
        for what, t in (("sharded", stiming), ("dense (3i)", dense_timing)):
            print(f"path 3k both step 16+16 at rung 128, {what}, on {card}: "
                  f"replay p50 {t['replay']['loop_p50']:.3f} / p90 "
                  f"{t['replay']['loop_p90']:.3f} ms, device "
                  f"{t['replay']['device_ms']} ms; eager p50 "
                  f"{t['eager']['loop_p50']:.3f} / p90 "
                  f"{t['eager']['loop_p90']:.3f} ms, device "
                  f"{t['eager']['device_ms']} ms")
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    got = sharded_grad_phase(torch, dev, args.seed, mesh1, (Ls0, Vs),
                             (Lf, Vf), card)
    add_path(got)
    print(f"path 3k (ii) sharded gradients: launches "
          f"{ {k: v for k, v in got.items() if v} }, "
          f"{time.perf_counter() - t0:.1f} s; path 3k (i)+(ii) "
          f"{time.perf_counter() - t3k:.1f} s")
    torch.cuda.empty_cache()

    # 3l. the LM serving path (serve_phase): full-width h2o-danube-1.8b
    # decode through launch.serve.generate (plain torch, no repo kernel),
    # decode against forward, the nine reduced architectures on the card
    # against the CPU, and serve_lm's sidecar over the generated tokens:
    # its flushes' fused_chain launches (not its warmup's).
    reset_counts()
    got = serve_phase(torch, np, dev, args.seed, card)
    add_path(got)
    print(f"path serve: launches {got}")
    torch.cuda.empty_cache()

    # 3m. the training path (train_lm_phase): full-width llama3.2-3b
    # cholesky_precond steps through launch.train.build (3 fused_chain
    # launches a step), examples/train_lm at reduced() (1 a step) and its
    # resume, and the encoder-decoder family on the card against the CPU.
    # Its step needs ~60 GB above what the smoke holds: the earlier paths'
    # results and f64 checks that no later phase reads go first (the
    # kernel checks below keep their inputs).
    in_tensors, alloc, rows = _cuda_holdings(torch, locals())
    print(f"before path 3m: {alloc:.2f} GB allocated, {in_tensors:.2f} GB "
          f"in tensors Python reaches, by name (GB): {rows}")
    L0 = L1 = L2 = Vd = A_tilde = L_lib = Lf_d = Vf_d = A_f = None
    bf16_oracle = fleet = f2 = cfleet = casc = up = Lu = Ld = None
    L0s = fs0 = Sf = sf32 = sf16 = one = out = oracle = S16 = None
    gc.collect()
    torch.cuda.empty_cache()
    in_tensors, alloc, rows = _cuda_holdings(torch, locals())
    free, total = torch.cuda.mem_get_info()
    reserved = torch.cuda.memory_reserved()
    print(f"path 3m headroom: {alloc:.2f} GB allocated ({in_tensors:.2f} GB "
          f"in tensors; by name {rows}), {reserved / 1e9:.2f} GB reserved "
          f"(by pool, GB reserved and allocated: {_reserved_by_pool(torch)}), "
          f"{(total - free - reserved) / 1e9:.2f} GB used outside the "
          f"allocator; {free / 1e9:.2f} GB of {total / 1e9:.2f} GB free on "
          f"the card, {TRAIN_LM_NEED_GB} GB needed")
    check(free / 1e9 >= TRAIN_LM_NEED_GB,
          "path 3m: too little free memory for the full-width step")
    with tempfile.TemporaryDirectory(prefix="smoke_train_") as tdir:
        got = train_lm_phase(
            torch, np, dev, args.seed, card, tdir, read_counts, reset_counts,
            lambda: dry_runs.extend(dryrun_in_background(dry_dir)))
    add_path(got)
    print(f"path train_lm: launches {got}")
    torch.cuda.empty_cache()

    # 3n (b). the dry run's records, traced since path 3n (a) ended
    # inside path 3m; nothing timed runs until they are in.
    dryrun_phase(dry_runs)
    shutil.rmtree(dry_dir, ignore_errors=True)

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

    # The per-panel kernels on panel 0 of the n = 5000 cascade; the
    # diagonal pass equal to its plain version in fp32 and in f64.
    D0, vtd0 = Lp[0, :P, :P], vt[0, :, :P]
    out = K.diag_block(D0, vtd0, sigma=1)
    ref = K._diag_block_plain(D0, vtd0.contiguous(), 1, None)
    same = [bool(torch.equal(x, y)) for x, y in zip(out, ref)]
    max_err["diag_block"] = max(float((x - y).abs().max())
                                for x, y in zip(out, ref))
    D64, vtd64 = D0.double(), vtd0.double().contiguous()
    same += [bool(torch.equal(x, y)) for x, y in zip(
        K.diag_block(D64, vtd64, sigma=1),
        K._diag_block_plain(D64, vtd64, 1, None))]
    _, c0, s0, T0 = ref
    R0, vtr0 = Lp[0, :P, P:], vt[0, :, P:]
    og = K.panel_apply_gemm(R0, vtr0, T0)
    rg = K._gemm_plain(R0, vtr0, T0, None)
    opp = K.panel_apply_paper(R0, vtr0, c0, s0, sigma=1)
    rp = K._paper_plain(R0, vtr0, c0, s0, 1, None)
    errs = [units(torch, x, y, u32) for x, y in zip(og, rg)]
    pap_same = [bool(torch.equal(x, y)) for x, y in zip(opp, rp)]
    max_err["panel_apply_gemm"] = max(float((x - y).abs().max())
                                      for x, y in zip(og, rg))
    max_err["panel_apply_paper"] = max(float((x - y).abs().max())
                                       for x, y in zip(opp, rp))
    lims = [entry_limit(torch, torch.float32, P)] * 2
    print(f"per-panel kernels vs plain on panel 0 at n={n}: diag_block "
          f"D_new, c, s, T equal fp32 {same[:4]}, f64 {same[4:]}; gemm R "
          f"{errs[0]:.3f} vt {errs[1]:.3f} u (limit {lims[0]:g}); paper R, "
          f"vt equal {pap_same}")
    check(all(same) and all(pap_same)
          and all(e <= m for e, m in zip(errs, lims)),
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
        unit = unit_roundoff(torch, dt)
        same = [bool(torch.equal(x, y))
                for x, y in zip((D, c_k, s_k, T_k), ref)]
        errs = [units(torch, R, R_p, unit), units(torch, vr, vr_p, unit)]
        lim = entry_limit(torch, dt, P)
        ok = (all(same) and all(e <= lim for e in errs)
              and not bool(vd.any()))
        print(f"per-panel kernels vs plain on panel 0 of the fleet B={nb} "
              f"n={fb} {name} (member-strided views): diag_block D_new, c, "
              f"s, T equal {same}; gemm R {errs[0]:.3f} vt {errs[1]:.3f} u "
              f"(limit {lim:g})  {'ok' if ok else 'FAIL'}")
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
    # The paper applies' device time alone (kernels only): beside the
    # event-loop time it shows how much the host's enqueue sets the pace.
    pap_dev_ms, pap_dev_how = device_ms(torch, lambda: run_apply(True),
                                        reps=5)
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
    b_gemm = bound(*K.panel_apply_gemm_work(P, k, widths,
                                            storage_dtype=torch.float32),
                   "3xtf32")
    b_pap = bound(sum(4 * (2 * (P + k) * w + 2 * P * k) for w in widths),
                  sum(6 * P * k * w for w in widths), "float32")
    casc_t = {}
    for method in ("pallas", "pallas_gemm"):
        fc = CholFactor(f0.data, panel=P, backend=method)
        d_ms, _ = timed(torch, lambda: fc.update(V), reps=5, warmup=1)
        h_ms, _ = host_timed(torch, lambda: fc.update(V), reps=5)
        casc_t[method] = (d_ms, h_ms)
    print(f"timing cascade n={n} k={k} panel={P} fp32 on {card} ({nd} diagonal "
          f"blocks, {len(widths)} applies, widths {widths[0]}..{widths[-1]})"
          f": per update diag_block {diag_ms:.3f} ms (plain {pdiag_ms:.1f}, "
          f"bound {b_diag[0]:.4f} by {b_diag[1]}); panel_apply_gemm "
          f"{gemm_ms:.3f} ms (plain {pgemm_ms:.1f}, torch.matmul "
          f"{lib_gemm_ms:.3f}, bound {b_gemm[0]:.4f} by {b_gemm[1]}); "
          f"panel_apply_paper {pap_ms:.3f} ms, device {pap_dev_ms:.4f} ms "
          f"({pap_dev_how}) (plain {ppap_ms:.1f}, bound {b_pap[0]:.4f} by "
          f"{b_pap[1]})")
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
    b_sh = bound(sh_bytes, sh_ops, "3xtf32")
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
