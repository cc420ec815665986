"""Batched serving demo (PyTorch port): SWA ring-cache decode + per-user
personalization.

Two stages, both fleet-shaped:

1. the LM serving path (reduced h2o-danube config) batch-decodes a prompt
   continuation for every user (``repro_torch.launch.serve.generate``);

2. a **personalization sidecar** maintains per-user preference statistics
   over the generated stream through ``repro_torch.stream``: every decode
   step contributes each user's token embedding as a rank-1 ``push`` into
   the ``StreamService``, which coalesces the traffic in per-user ring
   buffers and absorbs it in batched rank-k flushes over one fleet of
   factors (one ``fused_chain`` launch a sign block on the card). A
   sliding window forgets old steps as deferred, coalesced downdates
   scheduled by the service. At every flush boundary the per-user
   preference weights are read back with ``.solve`` and checked against
   the exact windowed regression.

With ``--sharded`` the sidecar's fleet members are each column-sharded
over four gloo ranks started on this host (``runtime.compat.run_gloo_ranks``,
sharing the card, or on the CPU with ``--device cpu``): every flush costs
one ``diag_block`` launch a panel and one ``panel_apply_sharded`` launch a
shard per sign block, whatever the fleet size. Every rank generates the
token stream from the same seed, and the ranks check that they hold equal
streams. A background flush worker over several ranks is refused by the
service (its flush points follow wall time), so ``--sharded --background``
fails in every rank.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm
      [--sharded] [--background] [--stats] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import collections

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.api import default_device
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.serve import generate
from repro_torch.models import init_model
from repro_torch.stream import FactorStore, StreamService, mutations_issued

SHARDS = 4


def personalize(token_stream, *, d_feat=32, width=8, window=16, lam=1e-1,
                panel=16, seed=0, sharded=False, background=False,
                device=None):
    """Per-user online ridge over the generated tokens, one streamed fleet.

    token_stream: (B, T) generated token ids (numpy or a tensor). Returns
    (max tracking error of the maintained solution vs the exact windowed
    solve at every flush boundary, batched mutations issued, rank-1 rows
    absorbed). With ``sharded=True`` the fleet members are column-sharded
    over a mesh of every rank of the process group (which must exist; call
    it alike on every rank). With ``background=True`` the flushes run on
    the service's worker; reports are collected via ``drain()`` at each
    evaluation boundary.
    """
    if isinstance(token_stream, torch.Tensor):
        token_stream = token_stream.cpu().numpy()
    B, T = token_stream.shape
    rng = np.random.default_rng(seed)
    vocab_hash = 4096
    emb = (rng.normal(size=(vocab_hash, d_feat)).astype(np.float32)
           / np.sqrt(d_feat)).astype(np.float32)
    true_pref = rng.normal(size=(B, d_feat)).astype(np.float32)

    # The streaming subsystem: one fleet, rank-1 pushes coalesced to
    # width-k flushes, sliding window via scheduled downdates.
    if sharded:
        import torch.distributed as dist

        from repro_torch.runtime.compat import make_mesh_compat

        shards = dist.get_world_size()
        mesh = make_mesh_compat((shards,), ("model",),
                                device_type=default_device(device).type)
        store = FactorStore(d_feat, capacity=B, width=width,
                            panel=min(panel, d_feat // shards),
                            backend="sharded", mesh=mesh, axis="model",
                            init_scale=lam)
    else:
        store = FactorStore(d_feat, capacity=B, width=width, panel=panel,
                            backend="fused", init_scale=lam, device=device)
    dev = store.device
    svc = StreamService(store, window=window, auto_flush=background,
                        background=background)
    # Build the serving rung's steps before any traffic (CUDA graphs where
    # the store's step_mode allows): the loop below builds nothing.
    store.warmup(rungs=(store.capacity,))
    for u in range(B):
        svc.admit(u)

    # Host-side bookkeeping mirroring the service's reports: rows pushed
    # but unflushed, and rows currently inside each user's factor.
    pending = [collections.deque() for _ in range(B)]
    active = [collections.deque() for _ in range(B)]
    xty = np.zeros((B, d_feat), np.float32)

    def absorb(report):
        if report is None or report.empty:
            return
        assert all(report.downdate_ok.values()), "windowed downdate refused"
        for u, k in report.absorbed.items():
            for _ in range(k):
                phi, r = pending[u].popleft()
                active[u].append((phi, r))
                xty[u] += phi * r
        for u, k in report.downdated.items():
            for _ in range(k):
                phi, r = active[u].popleft()
                xty[u] -= phi * r

    muts0, rows_pushed = mutations_issued(), 0
    max_err = 0.0
    try:
        for t in range(T):
            absorb(svc.tick())                      # window expiry fires here
            phi = emb[token_stream[:, t] % vocab_hash]          # (B, d)
            reward = np.einsum("bd,bd->b", phi, true_pref)      # per-user
            for u in range(B):
                svc.push(u, phi[u])
                pending[u].append((phi[u].copy(), float(reward[u])))
                rows_pushed += 1
            if (t + 1) % width == 0:
                if background:
                    # The worker flushed width-triggered rings off-thread;
                    # collect its reports, then sweep any ready remainder.
                    for rep in svc.drain():
                        absorb(rep)
                absorb(svc.flush())
                # Maintained vs exact windowed solve over the absorbed rows
                # (a sharded fleet is gathered whole, on every rank).
                w = store.factor.solve(torch.from_numpy(xty).to(dev))
                w = w.cpu().numpy()                          # (B, d) prefs
                for u in range(B):
                    Phi = np.stack([p for p, _ in active[u]])
                    R = np.asarray([r for _, r in active[u]])
                    A = lam * np.eye(d_feat) + Phi.T @ Phi
                    w_exact = np.linalg.solve(A, Phi.T @ R)
                    max_err = max(max_err, float(
                        np.max(np.abs(w[u] - w_exact))))
        if background:
            for rep in svc.drain():
                absorb(rep)
    finally:
        svc.stop_background()
    return max_err, mutations_issued() - muts0, rows_pushed


def tokens_for(*, device=None, batch=8, prompt_len=32, gen=64, seed=0):
    """The demo's decode: reduced h2o-danube, weights drawn from ``seed``,
    prompts from ``SyntheticTokens(seed=2)``, 64 tokens sampled at
    temperature 0.8. Returns (tokens (B, P+gen), tokens/s)."""
    cfg = get_config("h2o-danube-1.8b").reduced()
    dev = default_device(device)
    model = init_model(cfg, device=dev, seed=seed)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, prompt_len, batch,
                                      seed=2))
    prompts = data.batch_at(0)["tokens"]
    return generate(cfg, model, prompts, gen=gen, cache_len=prompt_len + gen,
                    temperature=0.8, seed=seed)


def _same_on_every_rank(toks):
    """Hold this rank's token stream against rank 0's (broadcast)."""
    import torch.distributed as dist

    mine = toks.cpu().contiguous()
    ref = mine.clone()
    dist.broadcast(ref, src=0)
    if not torch.equal(mine, ref):
        raise RuntimeError(f"rank {dist.get_rank()} generated another token "
                           "stream than rank 0")


def run(*, sharded=False, background=False, stats=False, device=None):
    """The demo on this process (a rank of a group when ``sharded``):
    decode, then the sidecar. Returns (tokens/s, max err, mutations,
    rows)."""
    batch, prompt_len = 8, 32
    toks, tps = tokens_for(device=device, batch=batch, prompt_len=prompt_len)
    print(f"generated {tuple(toks.shape)} tokens at {tps:.1f} tok/s "
          f"(batch {batch})")
    if sharded:
        _same_on_every_rank(toks)
    err, muts, rows = personalize(toks[:, prompt_len:], sharded=sharded,
                                  background=background, device=device)
    print(f"personalization sidecar: fleet of {batch} per-user factors"
          f"{f' ({SHARDS}-way sharded members)' if sharded else ''}"
          f"{' (background flush worker)' if background else ''}, "
          f"{rows} rank-1 rows coalesced into {muts} batched rank-k "
          f"mutations ({rows / max(muts, 1):.1f} rows/mutation), "
          f"max err vs exact windowed solve = {err:.3e}")
    assert tps > 0
    assert err < 1e-2
    assert muts < rows, "coalescing must batch rank-1 rows into rank-k"
    if stats:
        from repro_torch import obs

        print(obs.summary_line())
    return tps, err, muts, rows


def _sharded_rank(background, stats, device):
    """One rank of ``--sharded`` (``run_gloo_ranks`` starts four)."""
    run(sharded=True, background=background, stats=stats, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sharded", action="store_true",
                    help="column-shard the sidecar fleet's members over "
                         f"{SHARDS} gloo ranks started on this host")
    ap.add_argument("--background", action="store_true",
                    help="run sidecar flushes on the service's worker "
                         "thread instead of inline")
    ap.add_argument("--stats", action="store_true",
                    help="print the one-line metrics summary (flush "
                         "percentiles, mutations, retraces) at exit")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default cuda)")
    args = ap.parse_args(argv)
    if args.sharded:
        from repro_torch.runtime.compat import run_gloo_ranks

        device = default_device(args.device).type
        run_gloo_ranks(SHARDS, _sharded_rank,
                       (args.background, args.stats, device))
        return None
    return run(background=args.background, stats=args.stats,
               device=args.device)


if __name__ == "__main__":
    main()
