"""Deterministic synthetic token pipeline, per-host sharded (PyTorch port).

Production posture: each host generates only its own shard of the global
batch (shard = f(step, host_index)), so the pipeline is

* deterministic — restarts resume mid-stream from the step counter alone
  (no data-state checkpointing needed),
* elastic — a re-mesh only changes (host_index, num_hosts); step k's global
  batch is identical for any host count that divides the batch,
* infinite — no epoch bookkeeping.

Tokens follow a Zipf-like marginal with a Markov backbone so losses have
non-trivial structure. The draw is numpy's, as in the JAX package's
pipeline, so ``batch_at(step)`` gives the JAX package's tokens bit for bit;
they arrive as int32 tensors on the requested device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class SyntheticTokens:
    """Iterable over per-host batches: dict(tokens, labels).

    ``device``: where the batches' tensors live (default the CPU: the
    caller moves them, or passes ``device='cuda'``)."""

    def __init__(self, cfg: DataConfig, *, host_index: int = 0,
                 num_hosts: int = 1, device=None):
        if cfg.global_batch % num_hosts:
            raise ValueError("global_batch must divide over hosts")
        self.cfg = cfg
        self.host_index = host_index
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        self.device = torch.device("cpu" if device is None else device)
        # Zipf-ish unigram over the vocab, fixed by seed.
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        self._probs = 1.0 / ranks**cfg.zipf_a
        self._probs /= self._probs.sum()

    def batch_at(self, step: int) -> dict:
        """The deterministic global-step batch, local shard only."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + self.host_index
        )
        b, s = self.local_batch, cfg.seq_len
        base = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self._probs)
        # Markov backbone: with p=0.25 copy the previous token + 1 (mod V),
        # giving learnable local structure.
        copy = rng.random((b, s)) < 0.25
        base[:, 1:][copy] = (base[:, :-1][copy] + 1) % cfg.vocab_size
        toks = torch.from_numpy(base.astype(np.int64)).to(torch.int32)
        return {
            "tokens": toks[:, :-1].contiguous().to(self.device),
            "labels": toks[:, 1:].contiguous().to(self.device),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def frontend_stub_embeds(cfg, batch: int, length: int, *, step: int = 0,
                         kind: str = "vision", dtype=torch.bfloat16,
                         generator: Optional[torch.Generator] = None,
                         device=None):
    """Pre-computed modality embeddings for the vlm/audio frontend stubs:
    standard normals over ``sqrt(d_model)``, in ``dtype``.

    The draw comes from ``generator`` (default: a CPU generator seeded from
    ``(step, kind)``, or one on ``device``). It cannot equal the JAX
    package's ``jax.random`` draw: tests that compare the two packages
    pass the same numpy embeds to both."""
    dev = torch.device("cpu" if device is None else device)
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed((17 * 1_000_003 + step) * 2
                              + (0 if kind == "vision" else 1))
    x = torch.randn((batch, length, cfg.d_model), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (x / math.sqrt(cfg.d_model)).to(device=dev, dtype=dtype)
