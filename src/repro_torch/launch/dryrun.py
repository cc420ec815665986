"""Multi-pod dry run, PyTorch port of ``repro.launch.dryrun``.

For every (architecture x input-shape) cell and mesh, trace the cell's
step (train / prefill / serve) on the meta device, as rank 0 of a fake
world of 256 (or 512) ranks, with every parameter, optimizer state,
batch and cache a meta-device ``DTensor`` placed by ``sharding.rules``:
nothing is allocated on any device. Record what one device of the mesh
runs (``roofline.opcount``: dot FLOPs and collectives), the roofline terms
and the per-device memory, one JSON line a cell.

Where the JAX module sets ``--xla_force_host_platform_device_count=512``
before importing jax, ``main`` makes this process rank 0 of a fake
process group (``runtime.compat.init_fake_world``) before it builds a
mesh. The fake group moves no data: the numbers here are counts and
shapes, never values. A process holds one default group, so call
``main`` (or ``lower_cell`` on the production meshes) in a process that
holds none.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
  python -m repro_torch.launch.dryrun --all                # 34 cells, single pod
  python -m repro_torch.launch.dryrun --all --multi-pod    # 34 cells, 2 pods
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k \\
      --optimizer cholesky_precond                         # paper-technique cell

Records append to ``--out`` (default ``build/dryrun/dryrun_<tag>.jsonl``
in the repository, never the JAX package's ``benchmarks/results``).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

import torch

import repro_torch.optim as optim
from repro_torch.configs import SHAPES_BY_NAME, cells, get_config
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import opcount
from repro_torch.sharding import rules

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"


def _leaf_tensor(x):
    """The tensor a state leaf holds: a ``CholFactor``'s storage, or the
    leaf itself; None for a host value (the step counter)."""
    data = getattr(x, "data", None)
    if isinstance(data, torch.Tensor) and not isinstance(x, torch.Tensor):
        return data
    return x if isinstance(x, torch.Tensor) else None


def _pairs(shapes_tree, specs_tree):
    """(leaf, placements) of two trees of the same keys."""
    if isinstance(shapes_tree, dict):
        for k in shapes_tree:
            yield from _pairs(shapes_tree[k], specs_tree[k])
    else:
        yield shapes_tree, specs_tree


def _local_bytes(shapes_tree, specs_tree, mesh) -> float:
    """Per-device bytes of a tree of (meta) tensors placed by a tree of
    placements: each leaf's bytes over the sizes of the mesh axes that
    shard it, as the JAX function divides by its spec's axes. A host value
    (the port's step counter; the JAX package's is an int32 array) has no
    device bytes."""
    from torch.distributed.tensor import Shard

    sizes = list(rules.axis_sizes(mesh).values())
    total = 0.0
    for x, spec in _pairs(shapes_tree, specs_tree):
        t = _leaf_tensor(x)
        if t is None:
            continue
        denom = 1
        for size, pl in zip(sizes, spec or ()):
            if isinstance(pl, Shard):
                denom *= size
        total += t.numel() * t.element_size() / denom
    return total


def _device_bytes(tree) -> float:
    """Bytes rank 0 holds of a tree (dicts, lists, tuples; a ``DTensor``
    counts its local shard, a ``CholFactor`` its storage)."""
    if isinstance(tree, dict):
        return sum(_device_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_device_bytes(v) for v in tree)
    t = _leaf_tensor(tree)
    if t is None:
        return 0.0
    if hasattr(t, "to_local"):
        t = t.to_local()
    return float(t.numel() * t.element_size())


def default_optimizer(cfg, name="adamw"):
    state_dtype = getattr(torch, cfg.opt_state_dtype)
    if name == "adamw":
        return optim.adamw(3e-4, state_dtype=state_dtype)
    if name == "cholesky_precond":
        return optim.cholesky_precond(3e-4, rank=16, block_size=1024)
    if name == "sgd":
        return optim.sgd(3e-4)
    raise ValueError(name)


def _place_tree(tree, specs, mesh):
    """A tree of meta tensors as ``DTensor``s on ``mesh`` by ``specs``."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh) for k, v in tree.items()}
    return distribute_tensor(tree, mesh, list(specs))


def trace_cell(cfg, cell, mesh, *, opt=None, grad_accum=4, policy="tp"):
    """Trace one (config, cell) step on the meta device over ``mesh`` (a
    ``DeviceMesh``, or anything whose ``shape`` is {axis: size} for one
    rank) and count it. ``opt``: the train cell's optimizer. Returns a
    dict: ``counted`` (the ``OpCounter`` of the traced step, with its
    memory), ``counts`` (the accumulation-free train step's counter, or
    None), ``memory`` (argument / output / alias bytes a device),
    ``params_local_bytes``, ``opt_local_bytes``, ``notes`` (replicated
    indivisible dims), ``chips`` and ``seconds``."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.train import distribute
    from repro_torch.models import values_tree

    sizes = rules.axis_sizes(mesh)
    n_chips = math.prod(sizes.values())
    several = n_chips > 1
    t0 = time.time()

    batch_axes = rules.data_axes(mesh)
    if policy == "dp":
        batch_axes = batch_axes + rules.model_axes(mesh)
    rules.set_batch_axes(batch_axes)

    model = St._meta_model(cfg)
    values_shapes, axes = St.param_shapes_and_axes(cfg, model)
    pspecs, notes = rules.param_specs(axes, values_shapes, mesh,
                                      fsdp=cfg.fsdp, policy=policy)
    if several:
        distribute(model, pspecs, mesh)
    ins = St.input_specs(cfg, cell)
    ctx = implicit_replication if several else contextlib.nullcontext
    mem = {}

    def traced(fn, *, track_memory):
        with ctx(), opcount.OpCounter(track_memory=track_memory) as c:
            out = fn()
        return out, c

    counts = None
    o_local = 0.0
    if cell.kind == "train":
        opt_state = opt.init(values_tree(model))
        ospecs = St.opt_state_specs(opt_state, pspecs, mesh)
        o_local = _local_bytes(opt_state, ospecs, mesh)
        args_b = _device_bytes(values_tree(model)) + _device_bytes(opt_state)

        def run(accum, state):
            step = St.make_train_step(cfg, opt, grad_accum=accum,
                                      mesh=mesh if several else None,
                                      policy=policy)
            return step(model, state, ins)

        (_, new_state, _), counted = traced(
            lambda: run(grad_accum, opt_state), track_memory=True)
        mem["argument_bytes"] = args_b + _device_bytes(
            _placed_batch_bytes(ins, mesh, policy, several))
        mem["output_bytes"] = (_device_bytes(values_tree(model))
                               + _device_bytes(new_state))
        mem["alias_bytes"] = args_b   # parameters and state are donated
        if grad_accum != 1:
            _, counts = traced(lambda: run(1, new_state), track_memory=False)
    elif cell.kind == "prefill":
        bspecs = St.batch_specs(ins, mesh, policy=policy)
        batch = _place_tree(ins, bspecs, mesh) if several else ins
        step = St.make_prefill_step(cfg)
        out, counted = traced(lambda: step(model, batch), track_memory=True)
        mem["argument_bytes"] = (_device_bytes(values_tree(model))
                                 + _device_bytes(batch))
        mem["output_bytes"] = _device_bytes(out)
        mem["alias_bytes"] = 0
    else:  # decode: the cache placed by rules.cache_specs
        cspecs = rules.cache_specs(ins["cache"], cfg, mesh)
        tspec = St.batch_specs({"tokens": ins["tokens"]}, mesh,
                               policy=policy)["tokens"]
        if several:
            cache = _place_tree(ins["cache"], cspecs, mesh)
            tokens = _place_tree(ins["tokens"], tspec, mesh)
        else:
            cache, tokens = ins["cache"], ins["tokens"]
        step = St.make_serve_step(cfg)
        (logits, new_cache), counted = traced(
            lambda: step(model, cache, tokens), track_memory=True)
        cache_b = _device_bytes(cache)
        mem["argument_bytes"] = (_device_bytes(values_tree(model)) + cache_b
                                 + _device_bytes(tokens))
        mem["output_bytes"] = _device_bytes(logits) + _device_bytes(new_cache)
        mem["alias_bytes"] = cache_b   # the cache is donated
    return {"counted": counted, "counts": counts, "memory": mem,
            "params_local_bytes": _local_bytes(values_shapes, pspecs, mesh),
            "opt_local_bytes": o_local, "notes": notes, "chips": n_chips,
            "mesh": dict(sizes), "seconds": time.time() - t0}


def lower_cell(arch: str, shape: str, mesh, *, optimizer="adamw", verbose=True,
               unroll_layers=False, config_patch=None, grad_accum=4,
               policy="tp"):
    """Trace one cell on the meta device (``trace_cell``). Returns a result
    record dict, with the JAX record's keys.

    ``compile_s`` is the seconds the trace took (model build, placement
    and the step's operations on the meta device); there is no compile.
    ``unroll_layers`` is accepted and does nothing: the layers are a
    Python loop, every one of them traced and counted (the JAX option
    unrolls XLA's while loop so that ``cost_analysis`` sees each layer).
    A train cell traces its ``grad_accum`` step for memory and the
    accumulation-free step for FLOPs and collectives, as the JAX function
    does. ``mesh``: a ``DeviceMesh`` (one rank, or the production meshes
    in a fake world)."""
    del unroll_layers
    cfg = get_config(arch)
    if config_patch:
        cfg = dataclasses.replace(cfg, **config_patch)
    cell = SHAPES_BY_NAME[shape]
    opt = default_optimizer(cfg, optimizer) if cell.kind == "train" else None
    t = trace_cell(cfg, cell, mesh, opt=opt, grad_accum=grad_accum,
                   policy=policy)
    return record(arch, shape, cfg, cell, t, optimizer=optimizer,
                  policy=policy, verbose=verbose)


def record(arch, shape, cfg, cell, t, *, optimizer, policy, verbose=True):
    """The JAX record of a ``trace_cell`` result (and its printout)."""
    roof = RA.analyze(
        t["counted"], cfg, cell, t["chips"], counts=t["counts"],
        params_local_bytes=t["params_local_bytes"],
        opt_local_bytes=t["opt_local_bytes"], memory=t["memory"],
    )
    notes = t["notes"]
    rec = {
        "arch": arch,
        "shape": shape,
        "mesh": t["mesh"],
        "chips": t["chips"],
        "optimizer": optimizer if cell.kind == "train" else None,
        "policy": policy,
        "kind": cell.kind,
        "compile_s": round(t["seconds"], 1),
        "flops_per_device": roof.flops,
        "bytes_per_device": roof.bytes_accessed,
        "collective_bytes_per_device": roof.collective_bytes,
        "collectives": roof.collectives,
        "compute_s": roof.compute_s,
        "memory_s": roof.memory_s,
        "collective_s": roof.collective_s,
        "bottleneck": roof.bottleneck,
        "model_flops": roof.model_flops,
        "useful_ratio": roof.useful_ratio,
        "memory_analysis": roof.per_device_memory,
        "replication_notes": [
            {"axis": a, "dim": d, "mesh_size": s} for a, d, s in notes
        ],
    }
    if verbose:
        print(f"== {arch} x {shape} on {t['mesh']} "
              f"({cell.kind}, trace {t['seconds']:.1f}s)")
        print("   memory_analysis:", roof.per_device_memory)
        print(f"   cost: flops/dev={roof.flops:.3e} "
              f"bytes/dev={roof.bytes_accessed:.3e} "
              f"coll/dev={roof.collective_bytes:.3e}")
        print(f"   roofline: compute={roof.compute_s*1e3:.2f}ms "
              f"memory={roof.memory_s*1e3:.2f}ms "
              f"collective={roof.collective_s*1e3:.2f}ms "
              f"-> {roof.bottleneck}-bound; "
              f"useful_ratio={roof.useful_ratio:.2f}")
        if notes:
            print(f"   replicated (indivisible): {rec['replication_notes']}")
    return rec


def _placed_batch_bytes(ins, mesh, policy, several):
    """The train batch as the step places it (rank 0's shards)."""
    if not several:
        return ins
    return _place_tree(ins, St.batch_specs(ins, mesh, policy=policy), mesh)


def main(argv=None):
    from repro_torch.runtime.compat import init_fake_world

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimizer", type=str, default="adamw")
    ap.add_argument("--policy", type=str, default="tp", choices=["tp", "dp"])
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    if args.all:
        todo = cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        todo = [(args.arch, args.shape)]

    init_fake_world(512 if args.multi_pod else 256)
    mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
    tag = "multipod" if args.multi_pod else "singlepod"
    out_path = Path(args.out) if args.out else OUT_DIR / f"dryrun_{tag}.jsonl"
    out_path.parent.mkdir(parents=True, exist_ok=True)

    n_fail = 0
    with open(out_path, "a") as f:
        for arch, shape in todo:
            try:
                rec = lower_cell(arch, shape, mesh, optimizer=args.optimizer,
                                 policy=args.policy)
                f.write(json.dumps(rec) + "\n")
                f.flush()
            except Exception as e:  # a failure here is a bug in the system
                n_fail += 1
                print(f"!! FAILED {arch} x {shape}: {e}")
                traceback.print_exc()
                f.write(json.dumps({"arch": arch, "shape": shape,
                                    "mesh": dict(rules.axis_sizes(mesh)),
                                    "error": str(e)}) + "\n")
                f.flush()
    print(f"done: {len(todo) - n_fail}/{len(todo)} cells OK -> {out_path}")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
