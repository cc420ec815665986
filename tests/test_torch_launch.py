"""The port's launch layer against the JAX package's, on the CPU: the
sharding rules, the fault-tolerance substrate, the train driver, the cells'
input specs and the roofline arithmetic.

* Sharding: every case of the sharding half of
  ``tests/test_sharding_and_roofline.py`` (its ``FakeMesh``), plus whole
  parameter trees, batch and cache specs, run through both packages; the
  port's placements, mapped back by ``rules.partition_spec``, equal the
  JAX package's ``PartitionSpec`` entries.
* Fault tolerance: ``tests/test_substrate.py``'s loop, straggler and
  elastic-reshard cases (the last on 2x2 and 1x4 gloo meshes in a
  subprocess of four spawned ranks).
* The training driver: ``launch.train.main`` on the reduced h2o-danube,
  12 adamw steps: the loss falls and a second call resumes and returns
  [].
* The roofline: ``model_flops``, ``active_params`` and
  ``analytic_memory_bytes`` equal the JAX package's exactly on every cell.
"""
from __future__ import annotations

import functools
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import SHAPES_BY_NAME as JAX_SHAPES
from repro.configs import cells
from repro.launch import steps as JSt
from repro.models import init_cache as jax_init_cache
from repro.roofline import analysis as JRA
from repro.sharding import rules as JR
from repro_torch.configs import ARCHS, SHAPES_BY_NAME
from repro_torch.launch import steps as St
from repro_torch.roofline import analysis as RA
from repro_torch.runtime import ResilientLoop, StragglerMonitor
from repro_torch.sharding import rules as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are many small operations, and the
    suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


def bare(spec) -> tuple:
    """PartitionSpec entries without trailing Nones (``P()`` and
    ``P(None, None)`` both replicate)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})


def both(axes, shape, mesh, **kw):
    """(port's spec as PartitionSpec entries, JAX's), and their notes."""
    n1, n2 = [], []
    ours = R.partition_spec(R.logical_to_spec(axes, shape, mesh, notes=n1,
                                              **kw), mesh, len(shape))
    theirs = JR.logical_to_spec(axes, shape, mesh, notes=n2, **kw)
    return ours, tuple(theirs), n1, n2


@pytest.mark.parametrize("axes,shape,mesh,kw,want", [
    (("embed", "mlp"), (4096, 14336), MESH, {}, P(None, "model")),
    (("embed", "heads", "head_dim"), (4096, 32, 128), MESH, {},
     P(None, "model", None)),
    (("embed", "heads", "head_dim"), (3072, 24, 128), MESH, {},
     P(None, None, None)),
    (("embed", "mlp"), (4096, 14336), MESH, {"fsdp": True},
     P("data", "model")),
    (("embed", "mlp"), (4096, 14336), MESH3, {"fsdp": True},
     P(("pod", "data"), "model")),
    (("embed", "mlp"), (2560, 8960), MESH, {"policy": "dp"},
     P(("data", "model"), None)),
    (("vocab", "embed"), (65536, 2560), MESH, {"policy": "dp"},
     P(None, ("data", "model"))),
    (("experts", "embed", "expert_mlp"), (128, 7168, 4864), MESH, {},
     P("model", None, None)),
    (("experts", "embed", "expert_mlp"), (8, 6144, 16384), MESH, {},
     P(None, None, "model")),
    (("mlp", "vocab"), (14336, 256000), MESH, {}, P("model", None)),
])
def test_logical_to_spec_matches_jax(axes, shape, mesh, kw, want):
    ours, theirs, n1, n2 = both(axes, shape, mesh, **kw)
    assert theirs == tuple(want)
    assert ours == theirs
    assert n1 == n2


def test_indivisible_heads_are_noted():
    _, _, notes, jnotes = both(("embed", "heads", "head_dim"),
                               (3072, 24, 128), MESH)
    assert notes == jnotes and notes[0][0] == "heads"


def test_placements_are_per_mesh_dim():
    from torch.distributed.tensor import Replicate, Shard

    pl = R.logical_to_spec(("embed", "mlp"), (4096, 14336), MESH3, fsdp=True)
    assert pl == (Shard(0), Shard(0), Shard(1))
    assert R.logical_to_spec(("embed",), (7,), MESH) == (Replicate(),) * 2


@functools.lru_cache(maxsize=None)
def full_trees(arch):
    """(port's, JAX's) (values, axes) of the full config, no allocation."""
    return (St.param_shapes_and_axes(ARCHS[arch]),
            JSt.param_shapes_and_axes(JAX_ARCHS[arch]))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "arctic-480b",
                                  "seamless-m4t-medium", "zamba2-7b"])
@pytest.mark.parametrize("kw", [{}, {"fsdp": True}, {"policy": "dp"}])
def test_param_specs_of_full_trees_match_jax(arch, kw):
    """Every leaf of the full config's values tree (meta shapes here,
    ``eval_shape`` there) lowers to the same spec, with the same notes."""
    (values, axes), (jvalues, jaxes) = full_trees(arch)
    ours, notes = R.param_specs(axes, values, MESH3, **kw)
    theirs, jnotes = JR.param_specs(jaxes, jvalues, MESH3, **kw)
    flat = jax.tree_util.tree_flatten_with_path(
        theirs, is_leaf=lambda x: isinstance(x, P))[0]
    assert len(flat) == len(jax.tree.leaves(jvalues))
    for path, spec in flat:
        node, leaf = ours, values
        for k in path:
            node, leaf = node[k.key], leaf[k.key]
        assert R.partition_spec(node, MESH3, leaf.ndim) == tuple(spec), path
    assert sorted(notes) == sorted(jnotes)


@pytest.mark.parametrize("mesh", [MESH, MESH3, FakeMesh({"model": 4})])
def test_batch_and_cache_specs_match_jax(mesh):
    for ndim in (1, 2, 3):
        assert (R.partition_spec(R.batch_spec(mesh, ndim), mesh, ndim)
                == tuple(JR.batch_spec(mesh, ndim)))
    for arch in ("seamless-m4t-medium", "zamba2-7b", "rwkv6-3b"):
        cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
        cache = St.input_specs(cfg, SHAPES_BY_NAME["decode_32k"])["cache"]
        jcache = jax.eval_shape(lambda: jax_init_cache(jcfg, 128, 32768))
        ours = R.cache_specs(cache, cfg, mesh)
        theirs = JR.cache_specs(jcache, jcfg, mesh)
        assert set(ours) == set(theirs)
        for k in theirs:
            assert (bare(R.partition_spec(ours[k], mesh, cache[k].ndim))
                    == bare(theirs[k])), (arch, k)
    specs = St.input_specs(ARCHS["pixtral-12b"], SHAPES_BY_NAME["train_4k"])
    jspecs = JSt.input_specs(JAX_ARCHS["pixtral-12b"], JAX_SHAPES["train_4k"])
    for policy in ("tp", "dp"):
        ours = St.batch_specs(specs, mesh, policy=policy)
        theirs = JSt.batch_specs(jspecs, mesh, policy=policy)
        for k in theirs:
            assert (bare(R.partition_spec(ours[k], mesh, specs[k].ndim))
                    == bare(theirs[k])), (policy, k)


def test_opt_state_specs_mirror_params():
    values, axes = St.param_shapes_and_axes(ARCHS["llama3.2-3b"])
    pspecs, _ = R.param_specs(axes, values, MESH)
    out = St.opt_state_specs({"step": 0, "m": values, "v": values,
                              "factors": {"x": values["embed"]["tokens"]}},
                             pspecs, MESH)
    assert out["m"] is pspecs and out["v"] is pspecs
    assert R.partition_spec(out["step"], MESH, 0) == ()
    assert R.partition_spec(out["factors"]["x"], MESH, 2) == (None, None)


def test_constrain_batch_dim_noop_without_mesh():
    x = torch.ones((4, 8))
    assert R.constrain_batch_dim(x, 0) is x
    assert R.constrain_dims(x, {0: "data"}) is x


# ---------------------------------------------------------------------------
# Fault tolerance.
# ---------------------------------------------------------------------------


def test_resilient_loop_resume_and_nan_retry(tmp_path):
    """The step NaNs once at step 6; the loop reloads the last checkpoint
    instead of committing the poison (tests/test_substrate.py)."""
    calls = {"n": 0, "nan_fired": False}

    def step_fn(state, batch):
        calls["n"] += 1
        w = state["w"] + 1.0
        loss = float(torch.sum(w))
        if int(state["w"][0]) == 6 and not calls["nan_fired"]:
            calls["nan_fired"] = True
            return {"w": w}, {"loss": float("nan")}
        return {"w": w}, {"loss": loss}

    loop = ResilientLoop(step_fn, lambda step: None, tmp_path, ckpt_every=2,
                         max_retries=3)
    state, step = loop.run({"w": torch.zeros((2,))}, 10)
    assert step == 10
    assert float(state["w"][0]) == 10.0  # exactly 10 committed steps
    assert calls["nan_fired"]

    loop2 = ResilientLoop(step_fn, lambda s: None, tmp_path, ckpt_every=2)
    state2, start = loop2.resume_or_init({"w": torch.zeros((2,))})
    assert start == 10
    assert float(state2["w"][0]) == 10.0


def test_resilient_loop_gives_up_after_its_retries(tmp_path):
    loop = ResilientLoop(lambda s, b: (s, {"loss": float("inf")}),
                         lambda s: None, tmp_path, max_retries=2)
    with pytest.raises(RuntimeError, match="after 2 retries"):
        loop.run({"w": torch.zeros(1)}, 3)


def test_resilient_loop_retries_a_real_step_before_its_first_checkpoint(
        tmp_path):
    """The port's train step changes its state in place, so a NaN step
    has poisoned the values and the moments by the time its loss is read.
    The loop commits its start state, so a fault at step 2, long before
    the first periodic checkpoint, is retried from a committed state: the
    run ends exactly where a run without the fault ends (the
    ``cholesky_precond`` factors included)."""
    import repro_torch.optim as optim
    from repro_torch.checkpoint import all_steps
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.train import build
    from repro_torch.models import values_tree

    cfg = get_config("llama3.2-3b").reduced()
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 16, 2, seed=1))

    def train(ckpt_dir, fault_at=None):
        started = not torch.distributed.is_initialized()
        try:
            model, opt_state, step = build(
                cfg, optim.cholesky_precond(1e-2, rank=4, block_size=64),
                single_device_mesh(device_type="cpu"))
        finally:
            if started:
                torch.distributed.destroy_process_group()
        values = values_tree(model)
        faults = []

        def step_fn(state, batch):
            if len(faults) == 0 and batch["at"] == fault_at:
                # a transient fault: the step computes on a NaN parameter
                faults.append(batch["at"])
                with torch.no_grad():
                    values["final_norm"]["scale"][0] = float("nan")
            _, opt, metrics = step(model, state["opt"], batch["batch"])
            return {"values": state["values"], "opt": opt}, metrics

        def batch_fn(i):
            return {"at": i, "batch": data.batch_at(i)}

        loop = ResilientLoop(step_fn, batch_fn, ckpt_dir, ckpt_every=100)
        state, at = loop.run({"values": values, "opt": opt_state}, 4)
        assert at == 4 and faults == ([] if fault_at is None else [fault_at])
        return state

    clean = train(tmp_path / "clean")
    faulty = train(tmp_path / "faulty", fault_at=2)
    assert all_steps(tmp_path / "faulty") == [0, 4]
    assert faulty["opt"]["step"] == clean["opt"]["step"] == 4
    a = _flat_tensors(clean)
    b = _flat_tensors(faulty)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.isfinite(b[k]).all() and torch.equal(a[k], b[k]), k


def _flat_tensors(tree, path=""):
    """The tensors of a training state by path (a ``CholFactor`` by its
    data)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{path}/{k}"))
    elif hasattr(tree, "data") and not isinstance(tree, torch.Tensor):
        out.update(_flat_tensors(tree.data, path))
    elif isinstance(tree, torch.Tensor):
        out[path] = tree.detach().clone()
    return out


def test_compat_feature_detection():
    from repro_torch.runtime import compat

    assert compat.HAS_AXIS_TYPE is False and compat.AXIS_TYPE_AUTO is None
    assert compat.mesh_axis_types_kwargs(3) == {}
    with pytest.raises(RuntimeError, match="run_gloo_ranks"):
        compat.ensure_host_devices(4)


def test_straggler_monitor():
    m = StragglerMonitor(k=5.0)
    for i in range(20):
        assert not m.record(i, 1.0 + 0.01 * (i % 3))
    assert m.record(20, 10.0)  # 10x the median -> flagged
    assert m.flagged and m.flagged[0][0] == 20


_FOUR_RANKS = """
import json, sys
import numpy as np
import torch
import torch.distributed as dist

STEPS = 2


def reshard(tmp):
    # A DTensor checkpointed on a 2x2 mesh, restored onto the 1x4 mesh of
    # the same ranks and re-placed back; shard_map_norep on the blocks.
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.checkpoint import restore, save
    from repro_torch.runtime import elastic_reshard, make_mesh_compat
    from repro_torch.runtime.compat import shard_map_norep
    from repro_torch.sharding.rules import NamedSharding, partition_spec

    full = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    pl = [Shard(0), Shard(1)]
    mesh1 = make_mesh_compat((2, 2), ("data", "model"), device_type="cpu")
    w = distribute_tensor(full, mesh1, pl)
    assert tuple(w.to_local().shape) == (2, 4)
    save(tmp, 1, {"w": w})
    mesh2 = make_mesh_compat((1, 4), ("data", "model"), device_type="cpu")
    sh = {"w": NamedSharding(mesh2, tuple(pl))}
    out = restore(tmp, 1, {"w": torch.zeros((4, 8))}, shardings=sh)
    assert out["w"].device_mesh.mesh.shape == (1, 4)
    assert tuple(out["w"].to_local().shape) == (4, 2)
    assert partition_spec(out["w"].placements, mesh2, 2) == ("data", "model")
    np.testing.assert_array_equal(out["w"].full_tensor().numpy(), full.numpy())
    out2 = elastic_reshard(out, {"w": NamedSharding(mesh1, tuple(pl))})
    assert out2["w"].device_mesh.mesh.shape == (2, 2)
    np.testing.assert_array_equal(out2["w"].full_tensor().numpy(), full.numpy())
    twice = shard_map_norep(lambda x: 2 * x, mesh=mesh1, in_specs=(pl,),
                            out_specs=pl)
    np.testing.assert_array_equal(twice(out2["w"]).full_tensor().numpy(),
                                  2 * full.numpy())


def build_for(mesh, seed=0):
    import repro_torch.optim as optim
    from repro_torch.configs import get_config
    from repro_torch.launch.train import build

    cfg = get_config("llama3.2-3b").reduced()
    return build(cfg, optim.cholesky_precond(1e-2, rank=4, block_size=64),
                 mesh, seed=seed)


def run(mesh):
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokens

    cfg = get_config("llama3.2-3b").reduced()
    data = SyntheticTokens(DataConfig(cfg.vocab_size, 16, 4, seed=1))
    model, state, step = build_for(mesh)
    losses = []
    for i in range(STEPS):
        model, state, met = step(model, state, data.batch_at(i))
        losses.append(float(met["loss"]))
    return model, state, losses


def flat(model, state):
    # The values and first moments, whole, as nested lists by path.
    from repro_torch.models import values_tree

    out = {}

    def walk(t, path):
        for k in sorted(t):
            if isinstance(t[k], dict):
                walk(t[k], path + k + "/")
            else:
                x = t[k]
                x = x.full_tensor() if hasattr(x, "full_tensor") else x
                out[path + k] = x.detach().float().tolist()

    walk({"values": values_tree(model), "m": state["m"]}, "")
    return out


def target(d):
    torch.set_num_threads(1)
    from repro_torch.checkpoint import save
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import values_tree
    from repro_torch.runtime import ResilientLoop

    reshard(f"{d}/reshard")
    if dist.get_rank() == 0:
        open(f"{d}/reshard.ok", "w").write("ok")
    mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")
    model, state, losses = run(mesh)
    sharded = sum(any(not p.is_replicate() for p in q.placements)
                  for q in model.parameters())
    got = flat(model, state)
    # a checkpoint of the sharded state, resumed into a fresh build
    save(f"{d}/ck", STEPS, {"values": values_tree(model), "opt": state})
    model2, state2, _ = build_for(mesh, seed=1)
    values2 = values_tree(model2)
    back, at = ResilientLoop(None, None, f"{d}/ck").resume_or_init(
        {"values": values2, "opt": state2})
    same = (at == STEPS
            and back["values"]["embed"]["tokens"] is values2["embed"]["tokens"]
            and flat(model2, back["opt"]) == got)
    if dist.get_rank() == 0:
        with open(f"{d}/four.json", "w") as f:
            json.dump({"losses": losses, "flat": got, "sharded": sharded,
                       "resumed_equal": same}, f)


if __name__ == "__main__":
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.runtime.compat import run_gloo_ranks

    torch.set_num_threads(1)
    run_gloo_ranks(4, target, (sys.argv[1],), timeout=400)
    # the build and steps on one rank, in this process
    model, state, losses = run(single_device_mesh(device_type="cpu"))
    with open(f"{sys.argv[1]}/one.json", "w") as f:
        json.dump({"losses": losses, "flat": flat(model, state)}, f)
    dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """One spawn of four gloo ranks (the script above): the elastic
    re-mesh, then ``build`` on their 2x2 mesh; and the same build on one
    rank. Returns (the script's result, its directory)."""
    d = tmp_path_factory.mktemp("four_ranks")
    script = d / "four_ranks.py"
    script.write_text(textwrap.dedent(_FOUR_RANKS))
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{ROOT}/src:" + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, str(script), str(d)],
                         capture_output=True, text=True, env=env, timeout=600)
    return res, d


def test_elastic_reshard_across_meshes(four_ranks):
    """Checkpoint a DTensor sharded over a 2x2 mesh of four gloo ranks,
    restore it onto their 1x4 mesh, and re-place it back with
    ``elastic_reshard``: the values survive each move; ``shard_map_norep``
    maps each rank's block."""
    res, d = four_ranks
    assert (d / "reshard.ok").exists(), res.stderr[-3000:]


def test_build_on_four_ranks_matches_one(four_ranks):
    """``build`` on a 2x2 (data, model) mesh of four gloo ranks distributes
    the parameters by ``param_specs`` and the batches by ``batch_specs``:
    two ``cholesky_precond`` steps (the Adam path on every leaf but
    ``embed.tokens``, whose gradient is gathered for its replicated
    factor) give one rank's losses, values and moments within the limit,
    and a checkpoint of the sharded state resumes into a fresh build
    exactly."""
    import json

    res, d = four_ranks
    assert res.returncode == 0, res.stderr[-3000:]
    four = json.loads((d / "four.json").read_text())
    one = json.loads((d / "one.json").read_text())
    cfg = ARCHS["llama3.2-3b"].reduced()
    tol = 50 * float(np.finfo(np.float32).eps) * cfg.d_model * cfg.num_layers
    np.testing.assert_allclose(four["losses"], one["losses"], rtol=tol)
    assert set(four["flat"]) == set(one["flat"])
    for k, want in one["flat"].items():
        want, got = np.asarray(want), np.asarray(four["flat"][k])
        assert np.max(np.abs(got - want)) <= tol * (1 + np.max(np.abs(want))), k
    assert four["sharded"] > 0 and four["resumed_equal"]


# ---------------------------------------------------------------------------
# The driver and the cells' specs.
# ---------------------------------------------------------------------------


def test_train_driver_end_to_end(tmp_path):
    from repro_torch.launch.train import main as train_main

    argv = ["--arch", "h2o-danube-1.8b", "--steps", "12", "--batch", "4",
            "--seq", "64", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    losses = train_main(argv + ["--optimizer", "adamw", "--lr", "3e-3",
                                "--ckpt-every", "6", "--log-every", "6"])
    assert len(losses) == 12
    assert losses[-1] < losses[0]
    assert not torch.distributed.is_initialized()
    # resumability: a second invocation resumes at step 12 and does nothing
    assert train_main(argv) == []


def test_full_config_needs_the_production_mesh():
    from repro_torch.launch.train import main as train_main

    with pytest.raises(ValueError, match="256 ranks"):
        train_main(["--arch", "llama3.2-3b", "--full", "--device", "cpu"])
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("arch,shape", cells())
def test_input_specs_cover_every_cell(arch, shape):
    cfg = ARCHS[arch]
    cell = SHAPES_BY_NAME[shape]
    specs = St.input_specs(cfg, cell)
    theirs = JSt.input_specs(JAX_ARCHS[arch], JAX_SHAPES[shape])
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    for path, sds in flat:
        node = specs
        for k in path:
            node = node[k.key]
        assert node.device.type == "meta"
        assert tuple(node.shape) == tuple(sds.shape), (path, node.shape)
        assert str(node.dtype).replace("torch.", "") == str(sds.dtype)
    assert len(flat) == len(jax.tree.leaves(specs))


def test_param_shapes_and_axes_structure():
    cfg = ARCHS["gemma2-9b"]
    shapes, axes = St.param_shapes_and_axes(cfg)
    jshapes, jaxes = JSt.param_shapes_and_axes(JAX_ARCHS["gemma2-9b"])
    assert shapes["embed"]["tokens"].shape == (cfg.vocab_padded, cfg.d_model)
    assert shapes["layers"]["mlp"]["wi"].device.type == "meta"
    got = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
           jax.tree_util.tree_flatten_with_path(shapes)[0]}
    want = {jax.tree_util.keystr(p): tuple(x.shape) for p, x in
            jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert got == want
    assert axes == jaxes


# ---------------------------------------------------------------------------
# The roofline arithmetic.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,shape", cells())
def test_roofline_arithmetic_matches_jax(arch, shape):
    cfg, jcfg = ARCHS[arch], JAX_ARCHS[arch]
    cell, jcell = SHAPES_BY_NAME[shape], JAX_SHAPES[shape]
    assert RA.active_params(cfg) == JRA.active_params(jcfg)
    assert RA.model_flops(cfg, cell) == JRA.model_flops(jcfg, jcell)
    for chips in (1, 256, 512):
        kw = dict(params_local_bytes=4e8, opt_local_bytes=1.6e9)
        assert (RA.analytic_memory_bytes(cfg, cell, chips, **kw)
                == JRA.analytic_memory_bytes(jcfg, jcell, chips, **kw))


def test_roofline_constants_are_the_h100s():
    assert RA.PEAK_FLOPS == 989e12 and RA.HBM_BW == 3.35e12
    row = RA.Roofline(1.0, 2.0, 0.0, 1.0, 2.0, 0.0, "memory", 3.0, 0.5)
    assert row.row()["bottleneck"] == "memory"
