"""The port's expert-parallel MoE on a mesh against the JAX package's, and
the op counter's all-to-all, on the CPU.

A fake 2x4 world (``runtime.compat.init_fake_world(8)``, one process)
against the JAX package on 8 emulated host devices, reduced mixtral-8x22b
(its experts replicated, ``expert_mlp`` sharded over the model axis) and
arctic-480b (its experts sharded over the model axis, a dense residual
FFN beside them), batch 8 x seq 64, under ``policy='dp'`` and ``'tp'``:

* FLOPs a device of each prefill and train cell within 1.05 times the
  JAX package's. Each rank runs the expert GEMMs on its own block of the
  capacity buffer (``models.moe._dispatch_on_mesh``), where the
  replicated dispatch ran every expert's whole capacity on every rank
  (1.27-2.41 times the JAX figures).
* Collective bytes a device of each train cell at most half of the
  replicated dispatch's (which gathered every token copy, every slot and
  the whole buffer on every rank); the test prints them beside the JAX
  package's.
* Under ``roofline.opcount.OpCounter`` a ``DTensor`` ``Shard(0)`` ->
  ``Shard(1)`` redistribute over the 4-wide model axis is one
  ``all-to-all`` of the local shard, as the HLO records it, and no
  all-gather (the CPU group runs it as an all-gather and a chunk).

The fake world and the 8 JAX devices run in subprocesses of their own,
side by side.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("mixtral-8x22b", "arctic-480b")

#: Train collective bytes a device of the replicated dispatch on the
#: fake 2x4 world (the same cells, torch 2.13), by (arch, policy).
REPLICATED_TRAIN_COLLECTIVES = {
    ("mixtral-8x22b", "dp"): 6.402e7, ("mixtral-8x22b", "tp"): 3.675e7,
    ("arctic-480b", "dp"): 5.441e7, ("arctic-480b", "tp"): 2.922e7,
}

_JAX8 = textwrap.dedent("""
    import json
    import jax
    assert len(jax.devices()) == 8, jax.devices()
    from repro.configs import ShapeCell, get_config
    import repro.launch.dryrun as D
    from repro.launch.mesh import make_mesh
    D.SHAPES_BY_NAME = {"p": ShapeCell("p", 64, 8, "prefill"),
                        "t": ShapeCell("t", 64, 8, "train")}
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        D.get_config = lambda a, cfg=cfg: cfg
        for pol in ("dp", "tp"):
            for c in ("p", "t"):
                r = D.lower_cell(arch, c, mesh, policy=pol, verbose=False)
                out["/".join((arch, pol, c))] = [
                    r["flops_per_device"], r["collective_bytes_per_device"]]
    print("RESULT " + json.dumps(out))
""")

_PORT8 = textwrap.dedent("""
    import json
    import torch
    from torch.distributed.tensor import Shard, distribute_tensor
    import repro_torch.launch.dryrun as D
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.roofline import opcount
    from repro_torch.runtime.compat import init_fake_world
    D.SHAPES_BY_NAME = {"p": ShapeCell("p", 64, 8, "prefill"),
                        "t": ShapeCell("t", 64, 8, "train")}
    init_fake_world(8)
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    out = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        D.get_config = lambda a, cfg=cfg: cfg
        for pol in ("dp", "tp"):
            for c in ("p", "t"):
                r = D.lower_cell(arch, c, mesh, policy=pol, verbose=False)
                out["/".join((arch, pol, c))] = [
                    r["flops_per_device"], r["collective_bytes_per_device"]]
    x = distribute_tensor(torch.empty((16, 32), device="meta"), mesh,
                          [Shard(0), Shard(0)])
    with opcount.OpCounter() as count:
        y = x.redistribute(mesh, [Shard(0), Shard(1)])
    out["a2a"] = {"records": [[c.kind, list(c.shape), c.group, c.nbytes]
                              for c in count.collectives],
                  "local": list(y.to_local().shape)}
    print("RESULT " + json.dumps(out))
""")


def _start(code, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    code = f"ARCHS = {ARCHS!r}\n" + code
    return subprocess.Popen([sys.executable, "-c", code], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _result(p, timeout=600):
    out, err = p.communicate(timeout=timeout)
    assert p.returncode == 0, out[-3000:] + err[-6000:]
    line = [x for x in out.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def eight():
    """(JAX on 8 host devices, the port on the fake 2x4 world), both run
    at once."""
    jax8 = _start(_JAX8,
                  {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    port8 = _start(_PORT8)
    return _result(jax8), _result(port8)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("policy", ("dp", "tp"))
@pytest.mark.parametrize("c,kind", [("p", "prefill"), ("t", "train")])
def test_moe_flops_within_jax(eight, arch, policy, c, kind):
    jax8, port8 = eight
    key = "/".join((arch, policy, c))
    port, ref = port8[key][0], jax8[key][0]
    print(f"{arch} {policy} {kind}: port {port:.6g} FLOPs a device, "
          f"JAX {ref:.6g} ({port / ref:.4f})")
    assert 0 < port <= 1.05 * ref


def test_moe_train_collectives_halved(eight):
    jax8, port8 = eight
    for (arch, policy), before in REPLICATED_TRAIN_COLLECTIVES.items():
        key = "/".join((arch, policy, "t"))
        port, ref = port8[key][1], jax8[key][1]
        print(f"{arch} {policy} train: port {port:.6g} collective bytes a "
              f"device (replicated dispatch {before:.4g}), JAX {ref:.6g}")
        assert 0 < port <= before / 2, (arch, policy)


def test_shard_to_shard_is_one_all_to_all(eight):
    _, port8 = eight
    a2a = port8["a2a"]
    # (16, 32) on (data 2, model 4): the local shard goes from (8, 8) rows
    # to (8, 8) columns over the model axis.
    assert a2a["local"] == [8, 8]
    assert a2a["records"] == [["all-to-all", [8, 8], 4, 8 * 8 * 4]]
