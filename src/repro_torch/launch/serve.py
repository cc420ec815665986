"""Serving driver, PyTorch port: batched autoregressive decode with a
prefix prompt.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
      --batch 8 --prompt-len 32 --gen 64 [--full] [--device cpu]

The model code is plain PyTorch (no hand-written kernel of its own); it
runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time
import torch

from repro_torch.configs import get_config
from repro_torch.core.api import default_device
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import decode_step, init_cache, init_model


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sample(logits, temperature: float, generator: torch.Generator):
    """One token a row: argmax at temperature 0, else a draw from
    softmax(logits / temperature) by the Gumbel-max rule (the rule
    ``jax.random.categorical`` uses; the draw is the generator's)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device).clamp_min(tiny)
    return torch.argmax(logits / temperature - torch.log(-torch.log(u)),
                        dim=-1)


@torch.inference_mode()
def generate(cfg, model, prompts, *, gen: int, cache_len: int,
             temperature: float = 0.0, seed: int = 0):
    """prompts: (B, P) int tokens. Returns ((B, P+gen) int32 tokens on the
    model's device, tokens/s of the sampled part). The prompt is
    teacher-forced through ``decode_step`` into an fp32 cache, then
    ``gen`` tokens are sampled from a generator on the model's device
    seeded with ``seed``."""
    if cfg.family == "encdec":
        raise NotImplementedError("serve driver targets decoder-only archs")
    B, P = prompts.shape
    dev = next(model.parameters()).device
    cache = init_cache(cfg, B, cache_len, torch.float32, device=dev)
    generator = torch.Generator(device=dev)
    generator.manual_seed(seed)

    toks = prompts.to(device=dev, dtype=torch.int32)
    # feed the prompt (teacher-forced), then sample
    for t in range(1, P):
        _, cache = decode_step(model, cfg, cache, toks[:, t - 1])
    cur = toks[:, -1]
    out = [toks]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(gen):
        logits, cache = decode_step(model, cfg, cache, cur)
        cur = sample(logits[:, : cfg.vocab_size], temperature, generator)
        out.append(cur[:, None].to(torch.int32))
    _sync(dev)
    dt = time.perf_counter() - t0
    return torch.cat(out, dim=1), (B * gen) / dt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if cfg.family == "encdec":
        raise SystemExit("serve driver targets decoder-only archs")
    dev = default_device(args.device)
    model = init_model(cfg, device=dev, seed=0)
    data = SyntheticTokens(
        DataConfig(cfg.vocab_size, args.prompt_len, args.batch, seed=2)
    )
    prompts = data.batch_at(0)["tokens"]
    cache_len = args.prompt_len + args.gen
    toks, tps = generate(cfg, model, prompts, gen=args.gen,
                         cache_len=cache_len, temperature=args.temperature)
    print(f"generated {tuple(toks.shape)} tokens at {tps:.1f} tok/s "
          f"(batch {args.batch}, {dev.type})")
    print("sample:", toks[0, args.prompt_len:args.prompt_len + 16].tolist())
    return tps


if __name__ == "__main__":
    main()
