"""The port's operation counter and roofline analysis against the JAX
package's HLO parser, on one CPU device.

* Dot FLOPs: ``roofline.opcount.OpCounter`` over the port's reduced-config
  prefill and decode steps (on the meta device) equals ``hloparse.
  analyze_hlo`` over the JAX package's compiled steps, exactly, for one
  architecture of each family. The train step differs by two choices of
  the models, computed here from the shapes and then held exactly: the
  port's loss recomputes each chunk's logits in the backward
  (``torch.utils.checkpoint`` per chunk; the JAX scan keeps them), and
  the JAX attention recomputes each key block's scores in the backward
  (``jax.checkpoint`` on the block; the port keeps them).
* Loops: ``tests/test_sharding_and_roofline.py``'s scanned matmul, as the
  Python loop the port runs: 7 * 2 * 8 * 16 * 16.
* Collectives: the same (kind, dtype, shape, group) give the same bytes
  a device as the JAX package's ``collective_stats`` and ``analyze_hlo``
  on HLO lines built from them.
* A factor's update counts nothing, on the CPU (the plain walk) and on
  the meta device (a shape function).
* ``analysis.analyze`` over a counted step: the JAX ``Roofline``'s fields.
* A built model's real CPU train step counts what the same cell traced on
  the meta device counts (the smoke's path 3n (a) does this on the card).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.optim as jax_optim
from repro.configs import ShapeCell as JCell
from repro.configs import get_config as jax_config
from repro.launch import steps as JSt
from repro.roofline import analysis as JRA
from repro.roofline.hloparse import analyze_hlo
import repro_torch.optim as optim
from repro_torch.configs import ShapeCell, get_config
from repro_torch.launch import steps as St
from repro_torch.models import values_tree
from repro_torch.roofline import analysis as RA
from repro_torch.roofline import opcount

B, S = 2, 64

#: One architecture of each family.
FAMILIES = {"dense": "llama3.2-3b", "vlm": "pixtral-12b",
            "moe": "mixtral-8x22b", "rwkv": "rwkv6-3b",
            "mamba_hybrid": "zamba2-7b", "encdec": "seamless-m4t-medium"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_flops(arch, kind):
    cfg = jax_config(arch).reduced()
    cell = JCell("t", S, B, kind)
    vals, _ = JSt.param_shapes_and_axes(cfg)
    ins = JSt.input_specs(cfg, cell)
    if kind == "prefill":
        c = jax.jit(JSt.make_prefill_step(cfg)).lower(vals, ins)
    elif kind == "decode":
        c = jax.jit(JSt.make_serve_step(cfg)).lower(vals, ins["cache"],
                                                    ins["tokens"])
    else:
        opt = jax_optim.adamw(3e-4,
                              state_dtype=jnp.dtype(cfg.opt_state_dtype))
        ost = jax.eval_shape(opt.init, vals)
        c = jax.jit(JSt.make_train_step(cfg, opt, grad_accum=1)).lower(
            vals, ost, ins)
    return analyze_hlo(c.compile().as_text())


def _port_counted(arch, kind):
    cfg = get_config(arch).reduced()
    cell = ShapeCell("t", S, B, kind)
    model = St._meta_model(cfg)
    ins = St.input_specs(cfg, cell)
    with opcount.OpCounter(track_memory=True) as c:
        if kind == "prefill":
            St.make_prefill_step(cfg)(model, ins)
        elif kind == "decode":
            St.make_serve_step(cfg)(model, ins["cache"], ins["tokens"])
        else:
            opt = optim.adamw(3e-4,
                              state_dtype=getattr(torch, cfg.opt_state_dtype))
            state = opt.init(values_tree(model))
            St.make_train_step(cfg, opt, grad_accum=1)(model, state, ins)
    return cfg, cell, c


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dot_flops_equal_analyze_hlo(family, kind):
    arch = FAMILIES[family]
    jf, jc, _, _ = _jax_flops(arch, kind)
    _, _, counted = _port_counted(arch, kind)
    pf, pc, kinds, info = opcount.analyze_ops(counted)
    assert pf == jf, (arch, kind, pf, jf, info["flops_by_op"])
    assert jc == 0.0 and pc == 0.0 and kinds == {"total": 0.0}


def test_train_flops_differ_by_the_two_recomputes():
    arch = "llama3.2-3b"
    jf = _jax_flops(arch, "train")[0]
    cfg, _, counted = _port_counted(arch, "train")
    a = cfg.attn
    tokens = B * S
    # The port recomputes the logits of its one loss chunk (tied
    # embeddings: a (tokens, d) x (d, vocab) product) ...
    logits = 2.0 * tokens * cfg.d_model * cfg.vocab_padded
    # ... and the JAX package each layer's scores, (B, H, S, S_kv) over
    # head_dim, one key block at this length.
    scores = 2.0 * B * a.num_heads * S * S * a.head_dim * cfg.num_layers
    assert counted.flops == jf + logits - scores, (counted.flops, jf)
    assert logits - scores == 4_194_304


def test_python_loop_counts_every_trip():
    """tests/test_sharding_and_roofline.py::test_hloparse_counts_loops as
    the port runs a loop: no trip count to find."""
    x = torch.empty(8, 16, device="meta")
    w = torch.empty(16, 16, device="meta")
    with opcount.OpCounter() as c:
        y = x
        for _ in range(7):
            y = torch.tanh(y @ w)
    flops, coll, kinds, _ = opcount.analyze_ops(c)
    assert flops == 7 * 2 * 8 * 16 * 16
    assert coll == 0.0


_CASES = [
    ("all-reduce", "f32", (128, 256), 16),
    ("all-reduce", "bf16", (4, 3072), 16),
    ("all-gather", "bf16", (16, 3072, 8016), 16),
    ("reduce-scatter", "f32", (2, 2048, 3072), 16),
    ("reduce-scatter", "bf16", (64, 192), 8),
    ("all-to-all", "bf16", (8, 1024, 6144), 16),
    ("collective-permute", "s32", (128,), 2),
]


def _hlo_line(kind, dtype, shape, group, i):
    dims = ",".join(str(d) for d in shape)
    n = 256 // group
    extra = "" if kind == "collective-permute" else \
        f", replica_groups=[{n},{group}]<=[256]"
    return (f"  %c{i} = {dtype}[{dims}] {kind}(%p{i}){extra}, "
            "to_apply=%add")


@pytest.mark.parametrize("case", _CASES, ids=[c[0] + "-" + c[1]
                                              for c in _CASES])
def test_collective_cost_model(case):
    kind, dtype, shape, group = case
    rec = opcount.Collective(kind, dtype, shape, group)
    line = _hlo_line(kind, dtype, shape, group, 0)
    text = ("HloModule test\n\nENTRY %main (p0: f32[1]) -> f32[1] {\n"
            + line + "\n}\n")
    want = JRA.collective_stats(line)
    assert RA.collective_stats([rec]) == want
    flops, coll, kinds, _ = analyze_hlo(text)
    assert coll == rec.cost() == want["total"]
    assert kinds == RA.collective_stats([rec])


def test_collective_stats_sums_kinds():
    recs = [opcount.Collective(*c) for c in _CASES]
    text = "\n".join(_hlo_line(*c, i) for i, c in enumerate(_CASES))
    assert RA.collective_stats(recs) == pytest.approx(
        JRA.collective_stats(text))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_factors_update_counts_nothing(device):
    from repro_torch.core import CholFactor

    c = CholFactor.identity(64, scale=1.0, batch=2, backend="auto",
                            panel=32, device=device)
    V = (torch.randn(2, 64, 4, dtype=torch.float32) * 0.1).to(device)
    with opcount.OpCounter() as cnt:
        out = c.update(V)
    assert out.data.shape == (2, 64, 64) and out.data.device.type == device
    assert cnt.flops == 0.0 and cnt.collectives == []


def test_meta_sketch_is_a_shape():
    from repro_torch.optim.cholesky_precond import sketch

    om = sketch(300, 16, seed=0, step=1, index=2, device="meta")
    assert om.is_meta and om.shape == (300, 16) and om.dtype == torch.float32
    a = sketch(30, 4, seed=0, step=1, index=2, device="cpu")
    b = sketch(30, 4, seed=0, step=1, index=2, device="cpu")
    assert torch.equal(a, b)   # the CPU draw is still seeded


def test_analyze_has_the_jax_fields():
    cfg, cell, counted = _port_counted("llama3.2-3b", "prefill")
    roof = RA.analyze(counted, cfg, cell, 1, params_local_bytes=1e8,
                      memory={"argument_bytes": 1, "output_bytes": 2,
                              "alias_bytes": 0})
    jcfg = jax_config("llama3.2-3b").reduced()
    jroof_fields = set(JRA.Roofline.__dataclass_fields__)
    assert set(RA.Roofline.__dataclass_fields__) == jroof_fields
    assert roof.flops == counted.flops
    assert roof.model_flops == JRA.model_flops(jcfg, JCell("t", S, B,
                                                           "prefill"))
    assert roof.useful_ratio == roof.model_flops / roof.flops
    assert roof.bytes_accessed == JRA.analytic_memory_bytes(
        jcfg, JCell("t", S, B, "prefill"), 1, 1e8)
    assert roof.compute_s == roof.flops / RA.PEAK_FLOPS
    assert roof.bottleneck in ("compute", "memory", "collective")
    assert set(roof.per_device_memory) == {"argument_bytes", "output_bytes",
                                           "temp_bytes", "alias_bytes"}
    assert roof.per_device_memory["temp_bytes"] == counted.peak_bytes > 0
    assert RA.LINK_BW == 50e9


def test_a_real_step_counts_what_the_meta_trace_counts():
    """The smoke's path 3n (a) on the CPU: a built model's train step
    (cholesky_precond, its factors updated by the plain walk) under the
    counter reads the dot FLOPs of the same cell traced on the meta
    device."""
    import types

    import torch.distributed as dist

    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.train import build

    cfg = get_config("llama3.2-3b").reduced()
    cell = ShapeCell("t", 32, 4, "train")
    started = not dist.is_initialized()
    opt = optim.cholesky_precond(3e-4, rank=8, block_size=64)
    try:
        model, state, step = build(cfg, opt,
                                   single_device_mesh(device_type="cpu"))
        g = torch.Generator().manual_seed(0)
        batch = {k: torch.randint(0, cfg.vocab_size, (4, 32), generator=g,
                                  dtype=torch.int32)
                 for k in ("tokens", "labels")}
        with opcount.OpCounter(track_memory=True) as cpu:
            step(model, state, batch)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    one = types.SimpleNamespace(shape={"data": 1, "model": 1})
    meta = DR.trace_cell(cfg, cell, one, grad_accum=1, opt=optim.
                         cholesky_precond(3e-4, rank=8, block_size=64))
    assert cpu.flops == meta["counted"].flops > 0
    assert cpu.collectives == [] and cpu.peak_bytes > 0
