"""The port's dry run (``launch.dryrun``) against the JAX package's, on the
CPU.

* ``_local_bytes``: the parameters and the adamw state a device holds
  equal the JAX function's over its specs, for all ten architectures on
  both production meshes (the tests' ``FakeMesh``: no devices needed). The
  JAX state holds its step counter as an int32 array, 4 bytes; the
  port's is a host int.
* A fake 2x4 world (``runtime.compat.init_fake_world(8)``, one process)
  against the JAX package on 8 emulated host devices, reduced llama3.2-3b,
  batch 8 x seq 64:
  - ``policy='dp'``: per-device dot FLOPs equal the JAX package's
    (prefill exactly; train exactly once the two recomputes of
    ``tests/test_torch_roofline.py`` are taken out, a device's eighth of
    them);
  - ``policy='tp'``: prefill equals the JAX figure exactly and train is
    held within 1.05 times it. The model code places what ``DTensor``
    would place op by op otherwise: each row-parallel product's partial
    sum is all-reduced once at its output, and the input gradient of the
    column-parallel products once at their input (Megatron's conjugate
    pair, ``rules.reduce_rows`` / ``copy_to_columns``), so no norm, FFN
    product or residual sees a partial sum and no weight is gathered
    whole; with 2 KV heads on a 4-wide model axis each model rank
    projects the one KV head its query head reads and attends with its
    own head only (``rules.kv_heads_for_queries``,
    ``local_attention``), as XLA does. Train reads 1.023: the port's
    checkpointed loss recomputes the logits, where XLA recomputes the
    attention scores (the ``dp`` train test's terms). A counter that
    counted a contraction-sharded product (a ``Partial`` output) at its
    global size fails the ``dp`` train test: its weight gradients
    contract over the sharded batch.
* ``lower_cell`` on a fake 16x16 world for a train, a prefill and a
  decode cell (the reduced llama3.2-3b at one layer, the cells cut to
  seq 256 x batch 32): every key of the JAX record; ``main --out``
  writes one JSONL line, whose memory a second (warm) trace of the same
  cell repeats; a second fake world in the same process is refused, and
  the production mesh refuses a fake world of 8.

The fake worlds and the 8 JAX devices run in subprocesses of their own.
"""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.optim as jax_optim
from repro.configs import ARCHS as JAX_ARCHS
from repro.launch import steps as JSt
from repro.sharding import rules as JR
import repro_torch.optim as optim
from repro_torch.configs import ARCHS, ShapeCell
from repro_torch.launch import dryrun as D
from repro_torch.launch import steps as St
from repro_torch.models import values_tree
from repro_torch.roofline import opcount
from repro_torch.sharding import rules as R

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DRYRUN = os.path.join(ROOT, "src", "repro", "launch", "dryrun.py")


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_local_bytes():
    """The JAX package's ``_local_bytes``. Its module sets XLA_FLAGS at
    import (512 host devices): the variable is put back at once, so
    nothing started later in this process sees it."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _local_bytes
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return _local_bytes


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_local_bytes_equal_jax(arch):
    jlb = _jax_local_bytes()
    jcfg = JAX_ARCHS[arch]
    jvals, jaxes = JSt.param_shapes_and_axes(jcfg)
    jopt = jax_optim.adamw(3e-4, state_dtype=jnp.dtype(jcfg.opt_state_dtype))
    jost = jax.eval_shape(jopt.init, jvals)
    cfg = ARCHS[arch]
    vals, axes = St.param_shapes_and_axes(cfg)
    opt = D.default_optimizer(cfg, "adamw")
    ost = opt.init(vals)
    for name, mesh in MESHES.items():
        jspecs, _ = JR.param_specs(jaxes, jvals, mesh, fsdp=jcfg.fsdp)
        specs, _ = R.param_specs(axes, vals, mesh, fsdp=cfg.fsdp)
        assert D._local_bytes(vals, specs, mesh) == jlb(jvals, jspecs, mesh), \
            (arch, name)
        jos = JSt.opt_state_specs(jost, jspecs, mesh)
        os_ = St.opt_state_specs(ost, specs, mesh)
        assert D._local_bytes(ost, os_, mesh) == jlb(jost, jos, mesh) - 4, \
            (arch, name)


# -- the fake 2x4 world against 8 JAX devices -------------------------------

_CELLS = """
from repro_torch.configs import ShapeCell
CELLS = {"p": ShapeCell("p", 64, 8, "prefill"),
         "t": ShapeCell("t", 64, 8, "train")}
"""

_JAX8 = textwrap.dedent("""
    import json, os, sys
    import jax
    assert len(jax.devices()) == 8, jax.devices()
    from repro.configs import ShapeCell, get_config
    import repro.launch.dryrun as D
    from repro.launch.mesh import make_mesh
    cfg = get_config("llama3.2-3b").reduced()
    D.get_config = lambda a: cfg
    D.SHAPES_BY_NAME = {"p": ShapeCell("p", 64, 8, "prefill"),
                        "t": ShapeCell("t", 64, 8, "train")}
    mesh = make_mesh((2, 4), ("data", "model"))
    out = {}
    for pol in ("dp", "tp"):
        for c in ("p", "t"):
            r = D.lower_cell("llama3.2-3b", c, mesh, policy=pol,
                             verbose=False)
            out[pol + "/" + c] = r["flops_per_device"]
    print("RESULT " + json.dumps(out))
""")

_PORT8 = textwrap.dedent("""
    import json
    import repro_torch.launch.dryrun as D
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime.compat import init_fake_world
""") + _CELLS + textwrap.dedent("""
    cfg = get_config("llama3.2-3b").reduced()
    D.get_config = lambda a: cfg
    D.SHAPES_BY_NAME = CELLS
    init_fake_world(8)
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    out = {}
    from repro_torch.launch.mesh import make_production_mesh
    try:
        make_production_mesh(device_type="cpu")
        out["wrong_size"] = "built"
    except ValueError as e:
        out["wrong_size"] = str(e)
    for pol in ("dp", "tp"):
        for c in ("p", "t"):
            r = D.lower_cell("llama3.2-3b", c, mesh, policy=pol,
                             verbose=False)
            out[pol + "/" + c] = r["flops_per_device"]
    print("RESULT " + json.dumps(out))
""")


def _run(code, env_extra=None, timeout=600):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    env.update(env_extra or {})
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=timeout, cwd=ROOT)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-6000:]
    line = [x for x in p.stdout.splitlines() if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def eight():
    jax8 = _run(_JAX8,
                {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    port8 = _run(_PORT8)
    return jax8, port8


def _one_device_flops(kind):
    """The port's count of the whole batch-8 step on one device."""
    cfg = ARCHS["llama3.2-3b"].reduced()
    cell = ShapeCell("x", 64, 8, kind)
    model = St._meta_model(cfg)
    ins = St.input_specs(cfg, cell)
    with opcount.OpCounter() as c:
        if kind == "prefill":
            St.make_prefill_step(cfg)(model, ins)
        else:
            opt = optim.adamw(3e-4)
            St.make_train_step(cfg, opt)(model, opt.init(values_tree(model)),
                                         ins)
    return c.flops, cfg


def test_production_mesh_refuses_a_world_of_another_size(eight):
    _, port8 = eight
    assert "needs 256 ranks" in port8["wrong_size"], port8["wrong_size"]


def test_dp_prefill_flops_equal_jax(eight):
    jax8, port8 = eight
    assert port8["dp/p"] == jax8["dp/p"]
    assert port8["dp/p"] == _one_device_flops("prefill")[0] / 8


def test_dp_train_flops_equal_jax(eight):
    jax8, port8 = eight
    whole, cfg = _one_device_flops("train")
    a, B, S = cfg.attn, 8, 64
    logits = 2.0 * B * S * cfg.d_model * cfg.vocab_padded
    scores = 2.0 * B * a.num_heads * S * S * a.head_dim * cfg.num_layers
    assert port8["dp/t"] == jax8["dp/t"] + (logits - scores) / 8
    assert port8["dp/t"] == whole / 8


@pytest.mark.parametrize("c,kind", [("p", "prefill"), ("t", "train")])
def test_tp_flops_against_jax(eight, c, kind):
    jax8, port8 = eight
    whole, _ = _one_device_flops(kind)
    port, ref = port8["tp/" + c], jax8["tp/" + c]
    print(f"tp {kind}: port {port:.6g} a device, JAX {ref:.6g}, "
          f"even share {whole / 8:.6g}")
    if kind == "prefill":
        assert port == ref
    else:
        assert ref <= port <= 1.05 * ref


# -- lower_cell and main on a fake 16x16 world --------------------------------

_PORT256 = textwrap.dedent("""
    import json, sys
    import repro_torch.launch.dryrun as D
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.runtime.compat import init_fake_world
    cfg = get_config("llama3.2-3b").reduced()
    D.get_config = lambda a: cfg
    D.SHAPES_BY_NAME = {
        "train_4k": ShapeCell("train_4k", 256, 32, "train"),
        "prefill_32k": ShapeCell("prefill_32k", 256, 32, "prefill"),
        "decode_32k": ShapeCell("decode_32k", 256, 32, "decode")}
    out_path = sys.argv[1]
    try:
        D.main(["--arch", "llama3.2-3b", "--shape", "decode_32k",
                "--out", out_path])
    except SystemExit as e:
        assert not e.code, e.code
    mesh = make_production_mesh(device_type="cpu")
    recs = {}
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        recs[shape] = D.lower_cell("llama3.2-3b", shape, mesh, verbose=False,
                                   config_patch={"num_layers": 1},
                                   optimizer="cholesky_precond")
    # main's decode ran with DTensor's caches cold; this one runs warm.
    warm = D.lower_cell("llama3.2-3b", "decode_32k", mesh, verbose=False)
    try:
        init_fake_world(4)
        again = "accepted"
    except RuntimeError as e:
        again = str(e)
    print("RESULT " + json.dumps({"recs": recs, "again": again,
                                  "warm": warm}))
""")


def _jax_record_keys():
    """The keys of the record the JAX ``lower_cell`` builds (its ``rec =
    {...}`` literal), read from its source."""
    tree = ast.parse(open(JAX_DRYRUN).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == "rec" for t in node.targets):
            return {k.value for k in node.value.keys}
    raise AssertionError("no rec = {...} in the JAX dry run")


@pytest.fixture(scope="module")
def world256(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun") / "d.jsonl")
    code = _PORT256.replace("sys.argv[1]", repr(out))
    return _run(code), out


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_lower_cell_has_the_jax_record(world256, shape):
    res, _ = world256
    rec = res["recs"][shape]
    assert set(rec) == _jax_record_keys()
    assert rec["chips"] == 256 and rec["mesh"] == {"data": 16, "model": 16}
    assert rec["flops_per_device"] > 0 and rec["useful_ratio"] > 0
    assert rec["collective_bytes_per_device"] == rec["collectives"]["total"]
    assert rec["collectives"]["total"] > 0     # a 16-wide axis gathers
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    mem = rec["memory_analysis"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "alias_bytes"}
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    want_opt = "cholesky_precond" if shape == "train_4k" else None
    assert rec["optimizer"] == want_opt


def test_memory_does_not_count_dtensors_shape_inference(world256):
    """The first trace of a cell runs DTensor's shape inference on fake
    tensors (cold caches), the second does not: the tracked peak must not
    see the difference."""
    res, out = world256
    cold = json.loads(open(out).read().splitlines()[0])
    assert (res["warm"]["memory_analysis"]
            == cold["memory_analysis"]), (res["warm"], cold)
    assert res["warm"]["flops_per_device"] == cold["flops_per_device"]


def test_main_writes_jsonl_and_one_world_a_process(world256):
    res, out = world256
    lines = open(out).read().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert "error" not in rec and set(rec) == _jax_record_keys()
    assert rec["shape"] == "decode_32k" and rec["kind"] == "decode"
    assert "process of its own" in res["again"]


# -- the model code's explicit placements -------------------------------------


class _Mesh:
    def __init__(self, shape):
        self.shape = tuple(shape)


class DTensor:
    """A stand-in with a ``DTensor``'s shape, placements and mesh: the
    gather rules read nothing else."""

    def __init__(self, shape, placements, mesh=(16, 16)):
        self.shape = torch.Size(shape)
        self.ndim = len(shape)
        self.placements = tuple(placements)
        self.device_mesh = _Mesh(mesh)


@pytest.mark.parametrize("shape,pls,target,mesh,want", [
    # 32 heads over a 16-wide axis into 8 KV groups of 4: gathered.
    ((64, 4096, 32, 128), "S0 S2", (64, 2, 2048, 8, 4, 128), (16, 16), {2}),
    # ... over a 4-wide axis the first factor (8) divides: kept.
    ((64, 4096, 32, 128), "S0 S2", (64, 2, 2048, 8, 4, 128), (2, 4), set()),
    # rwkv's mix lora (5 x 32 over 16): gathered; the batch stays.
    ((64, 256, 160), "S0 S2", (64, 256, 5, 32), (16, 16), {2}),
    # a merge keeps a shard on its first dim, gathers one behind it.
    ((64, 4096, 3072), "S0 R", (64 * 4096, 3072), (16, 16), set()),
    ((64, 4096, 3072), "S0 S1", (64 * 4096, 3072), (16, 16), {1}),
    # size-1 dims are no factor.
    ((128, 1, 2560), "S0 S2", (128, 2560), (16, 16), set()),
    ((128, 1, 2560), "S0 S2", (128, 1, 40, 64), (16, 16), {2}),
])
def test_reshape_gathers(shape, pls, target, mesh, want):
    from torch.distributed.tensor import Replicate, Shard

    placements = [Replicate() if p == "R" else Shard(int(p[1:]))
                  for p in pls.split()]
    x = DTensor(shape, placements, mesh)
    assert R.reshape_gathers(x, target) == want


@pytest.mark.parametrize("eq,a,b,want", [
    # attention scores: b and k merge into the matmul's batch, so a shard
    # on k (behind b) is gathered; b's stays.
    ("bkgqd,bksd->bkgqs", ((2, 8, 3, 64, 16), "S0 S1"),
     ((2, 8, 64, 16), "S0 S1"), [{1}, {1}]),
    # the tied logits: a vocabulary shard is its group's first letter.
    ("...d,vd->...v", ((2, 64, 32), "S0 R"), ((512, 32), "R S0"),
     [set(), set()]),
    # the output projection contracts (h, k): a shard on h, the first
    # contracted letter, stays (a partial sum).
    ("bshk,hkd->bsd", ((2, 64, 16, 8), "S0 S2"), ((16, 8, 32), "R S0"),
     [set(), set()]),
    # ... a shard on k, behind h, does not.
    ("bshk,hkd->bsd", ((2, 64, 16, 32), "S0 S3"), ((16, 32, 32), "R S1"),
     [{3}, {1}]),
    # a batch of 1 is no factor: k leads the batch group and stays.
    ("bkgd,bskd->bkgs", ((1, 16, 2, 64), "R S1"),
     ((1, 4096, 16, 64), "S1 S2"), [set(), set()]),
])
def test_einsum_gathers(eq, a, b, want):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models import layers

    def make(spec):
        shape, pls = spec
        return DTensor(shape, [Replicate() if p == "R" else Shard(int(p[1:]))
                               for p in pls.split()])

    assert layers.einsum_gathers(eq, make(a), make(b)) == want
