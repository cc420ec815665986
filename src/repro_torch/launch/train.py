"""Training driver, PyTorch port: config-selected arch, the train step,
resilient loop.

Without ``--full`` it runs the reduced configs end to end on one device
(the card unless ``--device cpu``); ``--full`` takes the full config on the
production mesh, which needs its 256 ranks.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
      --steps 200 --optimizer cholesky_precond --ckpt-dir "$TMPDIR/ckpt"

Without ``--ckpt-dir`` each call checkpoints into a new directory under
the temporary directory (``$TMPDIR``) and so starts from step 0; pass the
same ``--ckpt-dir`` again to resume.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import tempfile
import time

import torch

import repro_torch.optim as optim
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticTokens, frontend_stub_embeds
from repro_torch.launch import steps as St
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import init_model, split_params, values_tree
from repro_torch.runtime import ResilientLoop, StragglerMonitor
from repro_torch.sharding import rules


def distribute(model, specs, mesh) -> None:
    """Place every parameter of ``model`` on ``mesh`` as a ``DTensor`` by
    ``specs`` (``rules.param_specs`` of its values tree), in place: a
    stack of layers becomes one ``DTensor`` whose rows the layers'
    parameters view, as on one device."""
    import torch.nn as nn
    from torch.distributed.tensor import distribute_tensor

    def place(node, spec):
        for name in node.axes:
            node._parameters[name] = nn.Parameter(distribute_tensor(
                getattr(node, name).detach(), mesh, list(spec[name])))
        for name, m in node._modules.items():
            place(m, spec[name])

    def rows(nodes, stacked, spec):
        for name in nodes[0].axes:
            stacked[name] = distribute_tensor(stacked[name], mesh,
                                              list(spec[name]))
            for i, n in enumerate(nodes):
                n._parameters[name] = nn.Parameter(stacked[name][i])
        for name in nodes[0]._modules:
            rows([n._modules[name] for n in nodes], stacked[name],
                 spec[name])

    for name, m in model._modules.items():
        if name in model.stacked:
            rows(list(m), model.stacked[name], specs[name])
        else:
            place(m, specs[name])


def build(cfg, opt, mesh, *, grad_accum=1, seed=0):
    """-> (model, opt_state, step) on the mesh's device.

    The parameter placements are ``rules.param_specs``, as the JAX driver
    computes them. On a mesh of one rank nothing is distributed: the
    parameters stay plain tensors on the rank's device (a ``DTensor``
    would put every operation of the step through its dispatch for
    nothing). On several ranks every parameter becomes a ``DTensor`` by
    its spec (``distribute``), the optimizer state follows its parameter,
    and the step places each batch by ``steps.batch_specs``."""
    several = math.prod(tuple(mesh.shape)) > 1
    device = (torch.device("cuda", torch.cuda.current_device())
              if mesh.device_type == "cuda" else torch.device("cpu"))
    model = init_model(cfg, device=device, seed=seed)
    _, axes = split_params(model)
    specs, _ = rules.param_specs(axes, values_tree(model), mesh,
                                 fsdp=cfg.fsdp)
    if several:
        distribute(model, specs, mesh)
    opt_state = opt.init(values_tree(model))
    step = St.make_train_step(cfg, opt, grad_accum=grad_accum,
                              mesh=mesh if several else None)
    return model, opt_state, step


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "sgd", "cholesky_precond"])
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory to resume from and write to "
                         "(default: a new one under $TMPDIR)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--full", action="store_true",
                    help="full config on the production mesh")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default cuda)")
    args = ap.parse_args(argv)
    if args.ckpt_dir is None:
        args.ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        print(f"checkpoints in {args.ckpt_dir}")

    import torch.distributed as dist

    device_type = args.device or "cuda"
    started = not (dist.is_available() and dist.is_initialized())
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, max_seq_len=args.seq)
        mesh = make_mesh((1, 1), device_type=device_type)
    else:
        mesh = make_production_mesh(device_type=device_type)
    try:
        return _train(args, cfg, mesh)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, mesh):
    sched = optim.warmup_cosine(args.lr, warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    if args.optimizer == "cholesky_precond":
        opt = optim.cholesky_precond(sched, rank=8, block_size=64)
    else:
        opt = optim.get_optimizer(args.optimizer, sched)

    model, opt_state, step_fn_ = build(cfg, opt, mesh)
    dev = next(model.parameters()).device
    data = SyntheticTokens(
        DataConfig(cfg.vocab_size, args.seq, args.batch, seed=1), device=dev)

    def batch_fn(step):
        b = data.batch_at(step)
        if cfg.family == "vlm":
            P = max(1, int(args.seq * cfg.frontend_frac))
            b["embeds"] = frontend_stub_embeds(cfg, args.batch, P, step=step,
                                               dtype=torch.float32,
                                               device=dev)
        if cfg.family == "encdec":
            b["src_embeds"] = frontend_stub_embeds(
                cfg, args.batch, args.seq, step=step, kind="audio",
                dtype=torch.float32, device=dev)
        return b

    # The values tree is the model's own storage: the step updates it in
    # place and a restore copies into it.
    state = {"values": values_tree(model), "opt": opt_state}

    def step_fn(state, batch):
        _, opt_state, metrics = step_fn_(model, state["opt"], batch)
        return {"values": state["values"], "opt": opt_state}, metrics

    t0 = time.time()
    losses = []

    def on_metrics(step, metrics):
        losses.append(metrics["loss"])
        if step % args.log_every == 0:
            dt = time.time() - t0
            print(f"step {step:5d} loss {metrics['loss']:.4f} "
                  f"gnorm {metrics['grad_norm']:.3f} "
                  f"({step / dt:.2f} steps/s)")

    loop = ResilientLoop(step_fn, batch_fn, args.ckpt_dir,
                         ckpt_every=args.ckpt_every,
                         monitor=StragglerMonitor())
    state, step = loop.run(state, args.steps, on_metrics=on_metrics)
    if losses:
        print(f"done at step {step}; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"already at step {step}; nothing to do (resumed checkpoint)")
    return losses


if __name__ == "__main__":
    main()
