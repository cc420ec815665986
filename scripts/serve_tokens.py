#!/usr/bin/env python3
"""The tokens smoke path 3l generates, from the checkout at ``--root``:
full-width h2o-danube-1.8b from seed 0 on the card, the path's prompts,
64 tokens sampled at 0.8 through ``launch.serve.generate``. Prints the
SHA-256 of the (batch, prompt + generated) int32 tokens and the first
row's sampled part. Run it once per checkout, in one call, and compare
the digests: a change to the model code that keeps the served tokens
prints the same one.

  python3 scripts/serve_tokens.py --root DIR [--seed 0]
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path[:0] = [os.path.join(root, "src"), root]

    import torch

    if not torch.cuda.is_available():
        print("serve_tokens: no CUDA device", file=sys.stderr)
        return 1
    smoke = importlib.import_module("chip_smoke")
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch import serve
    from repro_torch.models import init_model

    cfg = get_config(smoke.SERVE_ARCH)
    model = init_model(cfg, device=torch.device("cuda"), seed=args.seed)
    prompts = SyntheticTokens(DataConfig(
        cfg.vocab_size, smoke.SERVE_PROMPT, smoke.SERVE_BATCH,
        seed=2)).batch_at(0)["tokens"]
    toks, tps = serve.generate(
        cfg, model, prompts, gen=smoke.SERVE_GEN,
        cache_len=smoke.SERVE_PROMPT + smoke.SERVE_GEN,
        temperature=smoke.SERVE_TEMPERATURE, seed=args.seed)
    toks = toks.cpu().to(torch.int32).contiguous()
    digest = hashlib.sha256(toks.numpy().tobytes()).hexdigest()
    print(f"serve_tokens {root}: {tuple(toks.shape)} sha256 {digest} "
          f"({tps:.1f} tokens/s on {torch.cuda.get_device_name(0)})")
    print(f"  sample: {toks[0, smoke.SERVE_PROMPT:][:16].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
