"""The model code's mesh placements against one rank, on four gloo ranks
of the CPU: tensor-parallel attention and FFN, and the expert-parallel
MoE dispatch.

One spawn of four gloo ranks (``runtime.compat.run_gloo_ranks``) runs
three reduced configurations, each built by ``launch.train.build`` on a
mesh of the four ranks, and the same three on one rank:

* arctic-480b on a (2, 2) (data, model) mesh: its 4 experts sharded
  over the model axis (expert-parallel), the capacity rows over the data
  axis, the dense residual FFN beside them;
* mixtral-8x22b with 3 experts, which the model axis does not divide:
  the experts replicated and ``expert_mlp`` sharded (TP within expert);
* llama3.2-3b on a (1, 4) mesh: 4 query heads over the model axis and 2
  KV heads that do not divide it (each rank projects the one it reads);
* llama3.2-3b with 6 query heads, which the model axis does not divide
  either, on the same mesh: the heads replicated, each rank attending
  with its share of the query rows;
* llama3.2-3b with one KV head (multi-query, as granite-20b) on the same
  mesh: every rank reads it, so the ranks split its columns.

The MoE configurations take a capacity factor of 0.75, so that the
routing drops copies and the drop mask says something. Each
configuration gives rank 0's forward logits (whole), every rank's drop
masks of its own token copies (``moe._slots``' ``keep``, a layer each),
and two adamw steps' losses and parameters (whole). They equal one
rank's: the masks exactly (a rank of data shard i holds the i-th half of
the tokens, and so of the copies: the second half's positions count the
first half's copies), the rest within ``tests/test_torch_launch.py``'s
four-rank limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.configs import ARCHS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = ("arctic", "mixtral3", "llama", "llama6h", "llama1kv")

_SCRIPT = """
import dataclasses, json, sys
import torch
import torch.distributed as dist

STEPS = 2
CASES = {"arctic": ("arctic-480b", (2, 2)),
         "mixtral3": ("mixtral-8x22b", (2, 2)),
         "llama": ("llama3.2-3b", (1, 4)),
         "llama6h": ("llama3.2-3b", (1, 4)),
         "llama1kv": ("llama3.2-3b", (1, 4))}


def config(name):
    from repro_torch.configs import get_config

    cfg = get_config(CASES[name][0]).reduced()
    if cfg.moe is not None:
        experts = 3 if name == "mixtral3" else cfg.moe.num_experts
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.75, num_experts=experts))
    if name in ("llama6h", "llama1kv"):
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(
            cfg.attn, **({"num_heads": 6} if name == "llama6h"
                         else {"num_kv_heads": 1})))
    return cfg


def whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def values(model):
    from repro_torch.models import values_tree

    out = {}

    def walk(t, path):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], path + k + "/")
            else:
                out[path + k] = whole(t[k]).detach().float().tolist()

    walk(values_tree(model), "")
    return out


def run(name, mesh, several):
    import contextlib
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    import repro_torch.optim as optim
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch import steps as St
    from repro_torch.launch.train import build
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = config(name)
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 16, 4, seed=1))
    model, state, step = build(cfg, optim.adamw(3e-3), mesh, seed=0)
    tokens = data.batch_at(0)["tokens"]
    ctx = implicit_replication if several else contextlib.nullcontext
    if several:
        spec = St.batch_specs({"tokens": tokens}, mesh)["tokens"]
        tokens = distribute_tensor(tokens, mesh, list(spec))
    keeps, slots = [], M._slots

    def spy(*args, **kwargs):
        slot, keep = slots(*args, **kwargs)
        keeps.append(keep.tolist())
        return slot, keep

    M._slots = spy
    try:
        with torch.no_grad(), ctx():
            logits, _ = T.forward_lm(model, cfg, tokens)
            logits = whole(logits)
    finally:
        M._slots = slots
    losses = []
    for i in range(STEPS):
        model, state, met = step(model, state, data.batch_at(i))
        losses.append(float(met["loss"]))
    if several:   # every rank's masks, in rank order
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, keeps)
        keeps = every
    return {"logits": logits.tolist(), "keep": keeps, "losses": losses,
            "values": values(model)}


def target(d):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import make_mesh

    out = {}
    for name, (_, shape) in CASES.items():
        mesh = make_mesh(shape, ("data", "model"), device_type="cpu")
        out[name] = run(name, mesh, True)
    if dist.get_rank() == 0:
        with open(f"{d}/four.json", "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.runtime.compat import run_gloo_ranks

    torch.set_num_threads(1)
    run_gloo_ranks(4, target, (sys.argv[1],), timeout=400)
    mesh = single_device_mesh(device_type="cpu")
    one = {name: run(name, mesh, False) for name in CASES}
    with open(f"{sys.argv[1]}/one.json", "w") as f:
        json.dump(one, f)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(four ranks' results, one rank's) by case."""
    d = tmp_path_factory.mktemp("mesh_four_ranks")
    script = d / "mesh_four_ranks.py"
    script.write_text(textwrap.dedent(_SCRIPT))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = f"{ROOT}/src:" + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, str(script), str(d)],
                         capture_output=True, text=True, env=env, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-6000:]
    return (json.loads((d / "four.json").read_text()),
            json.loads((d / "one.json").read_text()))


def _tol(name):
    # tests/test_torch_launch.py::test_build_on_four_ranks_matches_one's.
    arch = {"arctic": "arctic-480b", "mixtral3": "mixtral-8x22b",
            "llama": "llama3.2-3b", "llama6h": "llama3.2-3b",
            "llama1kv": "llama3.2-3b"}[name]
    cfg = ARCHS[arch].reduced()
    return 50 * float(np.finfo(np.float32).eps) * cfg.d_model * cfg.num_layers


@pytest.mark.parametrize("name", CASES)
def test_forward_logits_match_one_rank(ranks, name):
    four, one = ranks[0][name], ranks[1][name]
    got, want = np.asarray(four["logits"]), np.asarray(one["logits"])
    assert got.shape == want.shape
    err = np.max(np.abs(got - want))
    print(f"{name}: logits max |four - one| {err:.3g}")
    assert err <= _tol(name) * (1 + np.max(np.abs(want)))


@pytest.mark.parametrize("name", ["arctic", "mixtral3"])
def test_dropped_copies_match_one_rank(ranks, name):
    every, one = ranks[0][name]["keep"], ranks[1][name]["keep"]
    layers = ARCHS["arctic-480b" if name == "arctic"
                   else "mixtral-8x22b"].reduced().num_layers
    assert len(one) == layers and all(len(k) == layers for k in every)
    dropped = 0
    for layer, whole in enumerate(one):
        # Rank r of the (2, 2) mesh holds data shard r // 2: the first or
        # the second half of the batch, so of the token copies.
        half = len(whole) // 2
        for rank, keeps in enumerate(every):
            at = (rank // 2) * half
            assert keeps[layer] == whole[at:at + half], (layer, rank)
        dropped += whole.count(False)
    print(f"{name}: {dropped} copies dropped in the forward's layers")
    assert dropped > 0


@pytest.mark.parametrize("name", CASES)
def test_two_adamw_steps_match_one_rank(ranks, name):
    four, one = ranks[0][name], ranks[1][name]
    tol = _tol(name)
    np.testing.assert_allclose(four["losses"], one["losses"], rtol=tol)
    assert set(four["values"]) == set(one["values"])
    for k, want in one["values"].items():
        want, got = np.asarray(want), np.asarray(four["values"][k])
        assert np.max(np.abs(got - want)) <= tol * (
            1 + np.max(np.abs(want))), (name, k)
