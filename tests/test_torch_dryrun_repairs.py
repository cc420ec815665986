"""The dry run's repairs, on the CPU: the recurrences traced once, the
donated decode cache, the loss reduced across vocabulary shards.

* (a) ``models.layers.scan`` on the meta device traces one step of a
  recurrence for all S of them (``opcount.weighted``). On a fake 2x4
  world, reduced rwkv6-3b and zamba2-7b (2 layers, remat on, as the full
  configs run) at batch 8 x seq 8, prefill and train: the FLOPs and the
  collective bytes a device equal those of the per-token loop (the same
  helper's value path, forced on the meta device) exactly, and the
  tracked peak is within 10 % of the loop's. The test prints, per cell,
  the loop's and the scan's FLOPs, collective bytes, peak bytes and trace
  seconds.
* (b) ``decode_step`` takes its cache donated: for every family each
  cache leaf keeps its storage (``data_ptr``) and the returned dict holds
  the same tensors; on the fake world a reduced llama3.2-3b decode cell's
  ``temp_bytes`` are the same at 2 and at 4 layers (no copy of a cache, no
  graph holding a layer's activations).
* (c) On the fake world a reduced llama3.2-3b ``tp`` train step (the
  vocabulary padded to 1792, so that its shards, 448 wide, match no other
  dim) records no collective of a chunk's logits: the loss's collectives
  are the reductions of its (batch shard, chunk) values.
* (d) granite-20b's tied table, sharded on its embedding dim (fsdp), has
  its gradient from the logits placed as the table (torch 2.11 cannot add
  the two uses' gradients otherwise; 2.13 can). On a fake 16x16 world, a
  reduced granite-20b train step (1 layer, batch 32 x seq 64) with the
  placement and with the same projection but the table's placement: the
  same FLOPs and the same collectives, the table's gradient
  reduce-scattered into its shards either way (the projection gathers
  the table's fsdp shards first; the test prints both totals).

Each fake world runs in a subprocess of its own (a process holds one
default group), as in ``tests/test_torch_dryrun.py``; the two run side by
side.
"""
from __future__ import annotations

import json
import os
from collections import Counter
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.models import decode_step, init_cache, init_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORLD = textwrap.dedent("""
    import dataclasses, json, time
    import repro_torch.launch.dryrun as D
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.runtime.compat import init_fake_world

    init_fake_world(8)
    mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
    out = {"scan": {}, "decode": {}}
    scan = L.scan
    loop = lambda step, c, xs, k=(): L._scan_loop(step, c, xs, k)
    for arch in ("rwkv6-3b", "zamba2-7b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=2,
                                  remat=True)
        for kind in ("prefill", "train"):
            for how, fn in (("loop", loop), ("scan", scan)):
                L.scan = fn
                t0 = time.time()
                t = D.trace_cell(cfg, ShapeCell(kind, 8, 8, kind), mesh,
                                 opt=D.default_optimizer(cfg), grad_accum=1)
                c = t["counted"]
                out["scan"][f"{arch}/{kind}/{how}"] = [
                    c.flops, sum(r.cost() for r in c.collectives),
                    c.peak_bytes, time.time() - t0]
    L.scan = scan
    llama = get_config("llama3.2-3b").reduced()
    for n in (2, 4):
        t = D.trace_cell(dataclasses.replace(llama, num_layers=n),
                         ShapeCell("d", 64, 8, "decode"), mesh)
        out["decode"][n] = [t["counted"].peak_bytes,
                            t["memory"]["alias_bytes"]]
    cfg = dataclasses.replace(llama, vocab_size=1700, loss_chunk=16)
    t = D.trace_cell(cfg, ShapeCell("t", 64, 8, "train"), mesh,
                     opt=D.default_optimizer(cfg), grad_accum=1)
    out["loss"] = {"vocab": cfg.vocab_padded, "records": [
        [r.kind, list(r.shape), r.times] for r in t["counted"].collectives]}
    print("RESULT " + json.dumps(out))
""")


_GRANITE = textwrap.dedent("""
    import dataclasses, json
    import repro_torch.launch.dryrun as D
    import repro_torch.models.transformer as T
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import layers as L
    from repro_torch.runtime.compat import init_fake_world
    from repro_torch.sharding import rules

    def unplaced(model, cfg, x):   # the tied projection, table unplaced
        x = rules.copy_to_columns(x)
        logits = L.einsum("...d,vd->...v", x, model["embed"]["tokens"])
        return L.softcap(logits.float(), cfg.logit_softcap)

    init_fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    cfg = dataclasses.replace(get_config("granite-20b").reduced(),
                              num_layers=1)
    out = {}
    for how, fn in (("placed", T.project_logits), ("unplaced", unplaced)):
        T.project_logits = fn
        t = D.trace_cell(cfg, ShapeCell("t", 64, 32, "train"), mesh,
                         opt=D.default_optimizer(cfg), grad_accum=1)
        c = t["counted"]
        out[how] = [c.flops, sum(r.cost() for r in c.collectives),
                    sorted([r.kind, r.cost()] for r in c.collectives)]
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def worlds():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for name, code in (("world", _WORLD), ("granite", _GRANITE))}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stdout[-3000:] + stderr[-6000:]
        line = [x for x in stdout.splitlines() if x.startswith("RESULT ")]
        out[name] = json.loads(line[-1][len("RESULT "):])
    return out


@pytest.fixture(scope="module")
def world(worlds):
    return worlds["world"]


@pytest.mark.parametrize("cell", ["rwkv6-3b/prefill", "rwkv6-3b/train",
                                  "zamba2-7b/prefill", "zamba2-7b/train"])
def test_scan_counts_what_the_loop_counts(world, cell):
    loop, scan = world["scan"][cell + "/loop"], world["scan"][cell + "/scan"]
    print(f"{cell}: loop flops {loop[0]:.6g} coll {loop[1]:.6g} B peak "
          f"{loop[2]} B {loop[3]:.2f} s; scan flops {scan[0]:.6g} coll "
          f"{scan[1]:.6g} B peak {scan[2]} B {scan[3]:.2f} s")
    assert scan[0] == loop[0] > 0
    assert scan[1] == loop[1] > 0
    assert abs(scan[2] - loop[2]) <= 0.10 * loop[2]


def _family_archs():
    seen = {}
    for name in sorted(ARCHS):
        seen.setdefault(ARCHS[name].family, name)
    return sorted(seen.values())


@pytest.mark.parametrize("arch", _family_archs())
def test_decode_writes_every_leaf_in_place(arch):
    from repro_torch.models import encdec as ED

    cfg = ARCHS[arch].reduced()
    model = init_model(cfg, device="cpu", seed=0)
    with torch.no_grad():
        if cfg.family == "encdec":
            cache = ED.init_encdec_cache(cfg, 2, 8, 8, torch.float32,
                                         device="cpu")
        else:
            cache = init_cache(cfg, 2, 8, torch.float32, device="cpu")
        given = {k: (v, v.data_ptr()) for k, v in cache.items()}
        for t in range(3):
            _, cache = decode_step(model, cfg, cache,
                                   torch.full((2,), t + 1, dtype=torch.int32))
    assert set(cache) == set(given)
    for k, (leaf, ptr) in given.items():
        assert cache[k] is leaf and cache[k].data_ptr() == ptr, k
    assert int(cache["pos"]) == 3


def test_decode_temp_bytes_do_not_grow_with_layers(world):
    (two, alias2), (four, alias4) = world["decode"]["2"], world["decode"]["4"]
    print(f"decode temp bytes: {two} at 2 layers, {four} at 4 (cache "
          f"{alias2:.0f} and {alias4:.0f} B)")
    assert two == four and alias4 > alias2


def test_loss_gathers_no_logits(world):
    loss = world["loss"]
    V = loss["vocab"]
    recs = loss["records"]
    assert recs and V == 1792
    # A chunk's logits are (b, c, V) a data shard (b = 4 sequences, c =
    # 16 tokens), V/4 wide a model shard; the embedding table's gradient
    # (V, d) is reduced over the data axis as a weight's is.
    logits = [r for r in recs if 16 in r[1]
              and (V in r[1] or V // 4 in r[1])]
    assert logits == [], logits
    # The max and the sum (b, c, 1) and the picked logit (b, c): four
    # chunks, each in the forward and again in its recompute.
    per_chunk = [r for r in recs if r[0] == "all-reduce"
                 and r[1] in ([4, 16, 1], [4, 16])]
    assert len(per_chunk) == 4 * 2 * 3, per_chunk


def test_granite_table_gradient_placed(worlds):
    placed, unplaced = worlds["granite"]["placed"], worlds["granite"][
        "unplaced"]
    print(f"granite-20b reduced train on 16x16: FLOPs {placed[0]:.6g} "
          f"(the table unplaced {unplaced[0]:.6g}); collective bytes "
          f"{placed[1]:.6g} ({unplaced[1]:.6g}, "
          f"{placed[1] - unplaced[1]:+.6g})")
    assert placed[0] == unplaced[0] > 0
    # The projection gathers the table's fsdp shards of its embedding dim
    # first (``layers.weight_gathers``), so the table's gradient comes
    # back reduce-scattered into those shards, placed as the table with
    # the placement or without it: every record is the same.
    a, b = Counter(map(tuple, placed[2])), Counter(map(tuple, unplaced[2]))
    assert a == b
    assert any(kind == "reduce-scatter" for kind, _ in a)
