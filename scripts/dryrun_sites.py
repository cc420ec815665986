#!/usr/bin/env python3
"""Where a dry-run cell's FLOPs and collectives come from: one cell of
``launch.dryrun`` at full width, cut to ``--layers`` layers and to
``--seq`` x ``--batch``, traced on the fake 16x16 world (or 2x16x16 with
``--multi-pod``) on the meta device, its counted dot FLOPs and collective
bytes a device summed by call site (the model code's last frames) and
operation. Prints the cell's totals, then the ``--top`` largest sites.
Two runs at 1 and 2 layers give a layer's share and the rest.

  PYTHONPATH=src python3 scripts/dryrun_sites.py --arch arctic-480b \\
      --kind prefill --seq 32768 --batch 32 --layers 1 [--top 30]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import sys
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    import repro_torch.launch.dryrun as D
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.roofline import opcount
    from repro_torch.runtime.compat import init_fake_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--kind", choices=("train", "prefill", "decode"),
                    required=True)
    ap.add_argument("--seq", type=int, required=True)
    ap.add_argument("--batch", type=int, required=True)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    args = ap.parse_args(argv)

    sites = collections.Counter()
    count = opcount.OpCounter.__torch_dispatch__

    def dispatch(self, func, types, a=(), kw=None):
        f0, n0 = self.flops, len(self.collectives)
        out = count(self, func, types, a, kw)
        if out is NotImplemented or (self.flops == f0
                                     and len(self.collectives) == n0):
            return out
        frames = [f for f in traceback.extract_stack()
                  if os.sep + "repro_torch" + os.sep in f.filename
                  and os.sep + "roofline" + os.sep not in f.filename]
        where = ";".join(f"{os.path.basename(f.filename)}:{f.lineno}"
                         for f in frames[-3:]) or "backward"
        shapes = tuple(tuple(t.shape) for t in a
                       if isinstance(t, torch.Tensor))
        if self.flops != f0:
            sites[(where, func._overloadpacket.__name__, str(shapes))] += \
                self.flops - f0
        for c in self.collectives[n0:]:
            sites[(where, c.kind, str(c.shape))] += c.cost()
        return out

    opcount.OpCounter.__torch_dispatch__ = dispatch
    D.SHAPES_BY_NAME = {"cut": ShapeCell("cut", args.seq, args.batch,
                                         args.kind)}
    cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers)
    D.get_config = lambda arch: cfg
    init_fake_world(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
    r = D.lower_cell(args.arch, "cut", mesh, verbose=False, grad_accum=1)
    print(f"total: FLOPs {r['flops_per_device']:.6g}, collective bytes "
          f"{r['collective_bytes_per_device']:.6g} "
          f"{r['collectives']}, temp_bytes "
          f"{r['memory_analysis']['temp_bytes']:.6g} (a device)")
    for (where, op, shape), v in sorted(sites.items(),
                                        key=lambda kv: -kv[1])[:args.top]:
        print(f"{v:12.4g} {op:16s} {where:60s} {shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
