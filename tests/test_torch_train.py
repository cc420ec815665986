"""The port's training path against the JAX package's, on the CPU, at
``reduced()`` sizes (d 64, 4 layers):

* the losses (``lm_loss`` / ``loss_fn``) and their gradients against
  ``jax.value_and_grad`` for the dense, moe (aux terms), vlm and encdec
  families, with masked labels and a sequence that ``loss_chunk`` does
  not divide; limit ``tol_for(float32, d_model * num_layers) * (1 + max
  |ref|)`` leaf by leaf;
* ``cfg.remat`` on and off: equal losses and gradients (``torch.equal``);
  the chunked loss keeps no chunk's logits for the backward;
* the optimizer's leaves: ``cholesky_precond`` preconditions, in the
  port's step, exactly the leaves (and leaf indices) the JAX package's
  does: for full llama3.2-3b (meta shapes) ``embed.tokens``,
  ``layers.ln1.scale`` and ``layers.ln2.scale``, and for every reduced
  family the set ``jax.eval_shape(opt.init)`` gives;
* one train step (``launch.steps.make_train_step``) for adamw, sgd and
  ``cholesky_precond`` (JAX's sketch draws in ``sketch``'s place, as
  tests/test_torch_optim.py does) against the JAX package's step: values,
  optimizer state and metrics; ``grad_accum=2`` against 1 (the mirror of
  ``test_grad_accum_matches_single_batch``) and against JAX's;
* a checkpoint written by the JAX package's ``launch.train.main`` restores
  in the port's ``ResilientLoop`` (same step, values and optimizer state
  equal to the JAX state read through interop), and the port's driver
  resumes from it.
"""
from __future__ import annotations

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as joptim
import repro_torch.optim as optim
from repro.configs import ARCHS as JAX_ARCHS
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.launch import steps as JSt
from repro.models import init_model as jax_init_model
from repro.models import loss_fn as jax_loss_fn
from repro.models import split_params as jax_split_params
from repro_torch import interop
from repro_torch import models as PM
from repro_torch.configs import ARCHS
from repro_torch.launch import steps as St
from repro_torch.models import transformer as PT
from tests.strategies import tol_for

cp = importlib.import_module("repro_torch.optim.cholesky_precond")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are many small operations, and the
    suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

B, S = 2, 8


def configs(name, **changes):
    """(JAX config, port config) of ``name`` at ``reduced()``."""
    return tuple(dataclasses.replace(c[name].reduced(), **changes)
                 for c in (JAX_ARCHS, ARCHS))


def limit(cfg, ref):
    tol = tol_for(np.float32, cfg.d_model * cfg.num_layers)
    return tol * (1.0 + float(np.max(np.abs(ref))))


def assert_close(got, want, cfg, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= limit(cfg, want), (what, err, limit(cfg, want))


def assert_trees_close(got, want, cfg, what):
    """Two nested dicts of arrays, leaf by leaf."""
    flat = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat) == len(jax.tree.leaves(got)), what
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        assert_close(node, leaf, cfg, f"{what}{jax.tree_util.keystr(path)}")


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return interop._array_to_numpy(tree)


def batch_for(cfg, seed, *, seq=S, batch=B):
    """Seeded numpy tokens and labels (some masked), and the family's
    frontend embeds."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)),
           "labels": rng.integers(0, cfg.vocab_size, (batch, seq))}
    out = {k: v.astype(np.int32) for k, v in out.items()}
    out["labels"][0, 2] = -1
    out["labels"][1, -1] = -1
    if cfg.family == "vlm":
        P = max(1, int(seq * cfg.frontend_frac))
        out["embeds"] = rng.normal(size=(batch, P, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "encdec":
        out["src_embeds"] = rng.normal(size=(batch, seq, cfg.d_model)).astype(
            np.float32)
    return out


def port_model(cfg, pcfg, seed=0):
    values, _ = jax_split_params(jax_init_model(jax.random.PRNGKey(seed), cfg))
    return values, interop.params_from_numpy(
        jax.tree.map(np.asarray, values), pcfg, device="cpu")


def tensors(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Losses and their gradients.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,chunk", [
    ("llama3.2-3b", 4),           # two chunks
    ("llama3.2-3b", 3),           # 3 does not divide 8: one chunk
    ("mixtral-8x22b", 4),         # moe: load_balance + router_z in total
    ("pixtral-12b", 8),           # vlm: frontend embeds
    ("seamless-m4t-medium", 3),   # encdec
])
def test_loss_and_gradients_match_jax(name, chunk):
    cfg, pcfg = configs(name, loss_chunk=chunk)
    values, model = port_model(cfg, pcfg)
    batch = batch_for(cfg, 3)
    (total, metrics), grads = jax.jit(jax.value_and_grad(
        lambda v, b: jax_loss_fn(v, cfg, b), has_aux=True))(
        values, {k: jnp.asarray(v) for k, v in batch.items()})
    ptotal, pmetrics, pgrads = St._grads(pcfg, model, tensors(batch))
    assert set(pmetrics) == set(metrics)
    assert_close(float(ptotal), float(total), cfg, "total")
    for k in metrics:
        assert_close(float(pmetrics[k]), float(metrics[k]), cfg, k)
    if cfg.family == "moe":
        assert float(pmetrics["load_balance"]) > 0
        np.testing.assert_allclose(
            float(ptotal), float(pmetrics["loss"] + pmetrics["load_balance"]
                                 + pmetrics["router_z"]), rtol=1e-6)
    assert_trees_close(numpy_tree(pgrads), jax.tree.map(np.asarray, grads),
                       cfg, "grad")


def test_all_masked_labels_give_zero_loss():
    cfg, pcfg = configs("h2o-danube-1.8b")
    _, model = port_model(cfg, pcfg)
    batch = batch_for(cfg, 4)
    batch["labels"][:] = -1
    with torch.no_grad():
        total, metrics = PM.loss_fn(model, pcfg, tensors(batch))
    assert float(metrics["loss"]) == 0.0 and float(total) == 0.0


@pytest.mark.parametrize("name", ["llama3.2-3b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_remat_gives_equal_losses_and_gradients(name):
    cfg, pcfg = configs(name, loss_chunk=4)
    _, model = port_model(cfg, pcfg)
    batch = tensors(batch_for(cfg, 5))
    outs = []
    for remat in (False, True):
        c = dataclasses.replace(pcfg, remat=remat)
        outs.append(St._grads(c, model, batch))
    (t0, m0, g0), (t1, m1, g1) = outs
    assert torch.equal(t0, t1)
    for k in m0:
        assert torch.equal(m0[k], m1[k])
    for a, b in zip(optim.base.tree_leaves(g0), optim.base.tree_leaves(g1)):
        assert torch.equal(a, b)


def test_remat_and_chunks_keep_no_logits_for_the_backward():
    """With ``remat`` the backward saves no tensor of a chunk's logits
    size (B, chunk, vocab) nor a layer's intermediates: only the chunk
    and layer inputs and the parameters."""
    cfg, pcfg = configs("llama3.2-3b", loss_chunk=4, remat=True)
    _, model = port_model(cfg, pcfg)
    batch = tensors(batch_for(cfg, 6))
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        total, _ = PM.loss_fn(model, pcfg, batch)
    logits = B * 4 * pcfg.vocab_padded
    assert sizes and max(sizes) < logits
    assert torch.isfinite(total)


# ---------------------------------------------------------------------------
# The optimizer's leaves.
# ---------------------------------------------------------------------------


def jax_preconditioned(cfg, opt, values):
    """{path: leaf index} of the leaves JAX's cholesky_precond holds a
    factor for (``eval_shape``: no allocation)."""
    state = jax.eval_shape(opt.init, values)
    leaves = jax.tree_util.tree_flatten_with_path(values)[0]
    index = {jax.tree_util.keystr(p): i for i, (p, _) in enumerate(leaves)}
    out = {}
    for path, _ in leaves:
        node = state["factors"]
        for k in path:
            node = node[k.key]
        if node is not None:
            key = ".".join(k.key for k in path)
            out[key] = index[jax.tree_util.keystr(path)]
    return out


def port_preconditioned(state, values):
    out = {}
    for i, (path, _, _) in enumerate(values):
        node = state["factors"]
        for k in path:
            node = node[k]
        if node is not None:
            out[".".join(path)] = i
    return out


def test_full_llama_preconditions_jax_three_leaves():
    """Full llama3.2-3b under launch/train.py's settings (rank 8, block 64):
    JAX's leaves, with JAX's indices; no per-layer matrix."""
    kw = dict(rank=8, block_size=64)
    values, _ = St.param_shapes_and_axes(ARCHS["llama3.2-3b"])
    jvalues, _ = JSt.param_shapes_and_axes(JAX_ARCHS["llama3.2-3b"])
    state = optim.cholesky_precond(1e-3, **kw).init(values)
    leaves = [(p, None, None) for p in _paths(values)]
    ours = port_preconditioned(state, leaves)
    theirs = jax_preconditioned(JAX_ARCHS["llama3.2-3b"],
                                joptim.cholesky_precond(1e-3, **kw), jvalues)
    assert ours == theirs
    assert set(ours) == {"embed.tokens", "layers.ln1.scale",
                         "layers.ln2.scale"}
    fac = state["factors"]["embed"]["tokens"]["c"]
    assert tuple(fac.data.shape) == (48, 64, 64)
    assert tuple(state["factors"]["layers"]["ln1"]["scale"]["c"].data.shape) \
        == (1, 28, 28)


def _paths(tree, path=()):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _paths(tree[k], path + (k,))
        else:
            out.append(path + (k,))
    return out


@pytest.mark.parametrize("name", ["llama3.2-3b", "mixtral-8x22b",
                                  "pixtral-12b", "rwkv6-3b", "zamba2-7b",
                                  "seamless-m4t-medium"])
def test_step_sketches_the_leaves_jax_preconditions(name, monkeypatch):
    """One port train step on each reduced family (dense, moe, vlm, rwkv,
    mamba_hybrid, encdec): the leaves it sketches (by index) are the ones
    JAX's optimizer holds a factor for."""
    cfg, pcfg = configs(name)
    kw = dict(rank=4, block_size=64)
    values, model = port_model(cfg, pcfg)
    seen = {}

    def spy(other, rank, *, seed, step, index, device):
        seen[index] = (other, rank)
        return torch.zeros((other, rank), device=device)

    monkeypatch.setattr(cp, "sketch", spy)
    opt = optim.cholesky_precond(1e-3, **kw)
    state = opt.init(PM.values_tree(model))
    step = St.make_train_step(pcfg, opt)
    step(model, state, tensors(batch_for(cfg, 7)))
    theirs = jax_preconditioned(cfg, joptim.cholesky_precond(1e-3, **kw),
                                values)
    leaves = PT.stacked_leaves(model)
    assert sorted(seen) == sorted(theirs.values())
    assert {".".join(leaves[i][0]) for i in seen} == set(theirs)


# ---------------------------------------------------------------------------
# One train step against the JAX package's.
# ---------------------------------------------------------------------------


def jax_sketch(other, rank, *, seed, step, index, device):
    """JAX's Omega / sqrt(rank) in the port's ``sketch`` signature."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    om = jax.random.normal(jax.random.fold_in(key, index), (other, rank),
                           jnp.float32) / jnp.sqrt(jnp.float32(rank))
    return torch.from_numpy(np.array(om)).to(device)


OPTS = {"adamw": dict(weight_decay=0.01),
        "sgd": dict(momentum=0.9),
        "cholesky_precond": dict(rank=8, block_size=64, eps=1.0)}


def jax_state_numpy(state):
    out = {k: (np.asarray(v) if k == "step" else jax.tree.map(np.asarray, v))
           for k, v in state.items() if k != "factors"}
    if "factors" in state:
        def fac(sub):
            if sub is None:
                return None
            c = sub["c"]
            return {"c": (np.asarray(c.data), dict(
                panel=c.panel, backend=c.backend, precision=c.precision,
                lowering=c.lowering, interpret=c.interpret))}

        out["factors"] = jax.tree.map(
            fac, state["factors"], is_leaf=lambda x: x is None or (
                isinstance(x, dict) and "c" in x))
    return out


def one_step(name, opt_name, *, accum=1, seq=32, batch=4, monkeypatch=None):
    cfg, pcfg = configs(name)
    values, model = port_model(cfg, pcfg)
    data = JSyntheticTokens(JDataConfig(cfg.vocab_size, seq, batch, seed=0))
    b = data.batch_at(0)
    jopt = joptim.get_optimizer(opt_name, 1e-2, **OPTS[opt_name])
    popt = optim.get_optimizer(opt_name, 1e-2, **OPTS[opt_name])
    jstep = jax.jit(JSt.make_train_step(cfg, jopt, grad_accum=accum))
    jv, js, jm = jstep(values, jopt.init(values), b)
    if monkeypatch is not None:
        monkeypatch.setattr(cp, "sketch", jax_sketch)
    pstep = St.make_train_step(pcfg, popt, grad_accum=accum)
    _, ps, pm = pstep(model, popt.init(PM.values_tree(model)), tensors(b))
    return cfg, (jv, js, jm), (model, ps, pm)


@pytest.mark.parametrize("opt_name", ["adamw", "sgd", "cholesky_precond"])
def test_train_step_matches_jax(opt_name, monkeypatch):
    cfg, (jv, js, jm), (model, ps, pm) = one_step(
        "llama3.2-3b", opt_name, monkeypatch=monkeypatch)
    for k in ("loss", "grad_norm", "loss_total"):
        assert_close(float(pm[k]), float(jm[k]), cfg, k)
    assert_trees_close(interop.params_to_numpy(model),
                       jax.tree.map(np.asarray, jv), cfg, "values")
    ours = interop.optimizer_state_to_numpy(ps)
    theirs = jax_state_numpy(js)
    assert int(ours["step"]) == int(theirs["step"]) == 1
    for k in ("m", "v", "mu"):
        if k in theirs:
            assert_trees_close(ours[k], theirs[k], cfg, k)
    if "factors" in theirs:
        got = ours["factors"]["embed"]["tokens"]["c"][0]
        want = theirs["factors"]["embed"]["tokens"]["c"][0]
        assert_close(got, want, cfg, "embed.tokens factor")
        assert ours["factors"]["layers"]["ln1"]["scale"] is None


def test_grad_accum_matches_single_batch_and_jax():
    """grad_accum=2 gives the update of accum=1 (linearity, the JAX
    test's 5e-3) and JAX's own grad_accum=2 step."""
    outs = {}
    for accum in (1, 2):
        cfg, (jv, _, jm), (model, _, pm) = one_step(
            "h2o-danube-1.8b", "sgd", accum=accum)
        outs[accum] = interop.params_to_numpy(model)
        assert_trees_close(outs[accum], jax.tree.map(np.asarray, jv), cfg,
                           f"accum {accum} values")
        assert_close(float(pm["loss"]), float(jm["loss"]), cfg, "loss")
    diffs = [float(np.max(np.abs(a - b))) for a, b in
             zip(jax.tree.leaves(outs[1]), jax.tree.leaves(outs[2]))]
    assert max(diffs) < 5e-3


def test_grad_accum_sums_in_fp32(monkeypatch):
    """bf16 parameters: the microbatches' gradients reach the optimizer
    as fp32 (the accumulator's dtype), not as a bf16 sum."""
    cfg, pcfg = configs("h2o-danube-1.8b", param_dtype="bfloat16")
    _, model = port_model(cfg, pcfg)
    seen = []
    opt = optim.sgd(1e-2, momentum=0.0)
    spy = optim.Optimizer(init=opt.init, update=lambda g, s, p, **kw: (
        seen.append({x.dtype for x in optim.base.tree_leaves(g)})
        or opt.update(g, s, p, **kw)))
    step = St.make_train_step(pcfg, spy, grad_accum=2)
    step(model, spy.init(PM.values_tree(model)),
         tensors(batch_for(cfg, 8, batch=4)))
    assert seen == [{torch.float32}]


# ---------------------------------------------------------------------------
# A checkpoint crosses from the JAX driver to the port's loop.
# ---------------------------------------------------------------------------


def test_jax_driver_checkpoint_restores_in_the_port(tmp_path):
    from repro.checkpoint import restore as jax_restore
    from repro.launch.train import main as jax_main
    from repro_torch.launch.train import build, main as port_main
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.runtime import ResilientLoop

    argv = ["--arch", "llama3.2-3b", "--batch", "4", "--seq", "32",
            "--optimizer", "adamw", "--ckpt-dir", str(tmp_path)]
    jax_main(argv + ["--steps", "2"])

    cfg, pcfg = configs("llama3.2-3b", max_seq_len=32)
    sched = joptim.warmup_cosine(3e-4, warmup_steps=1, total_steps=2)
    jopt = joptim.get_optimizer("adamw", sched)
    jvalues, _ = jax_split_params(jax_init_model(jax.random.PRNGKey(0), cfg))
    jstate = jax_restore(tmp_path, 2, {"values": jvalues,
                                       "opt": jopt.init(jvalues)})
    want = interop.train_state_from_numpy(
        {"values": jax.tree.map(np.asarray, jstate["values"]),
         "opt": jax_state_numpy(jstate["opt"])}, pcfg, device="cpu")

    popt = optim.get_optimizer("adamw", optim.warmup_cosine(
        3e-4, warmup_steps=1, total_steps=2))
    started = not torch.distributed.is_initialized()
    try:
        model, opt_state, _ = build(pcfg, popt,
                                    single_device_mesh(device_type="cpu"))
    finally:
        if started:
            torch.distributed.destroy_process_group()
    values = PM.values_tree(model)
    loop = ResilientLoop(None, None, tmp_path)
    state, step = loop.resume_or_init({"values": values, "opt": opt_state})
    assert step == 2
    assert state["values"]["embed"]["tokens"] is values["embed"]["tokens"]
    assert state["opt"]["step"] == 2
    got = interop.train_state_to_numpy({"values": model, "opt": state["opt"]})
    ref = interop.train_state_to_numpy(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, b)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    # A third step, in the port's driver, resumes from the JAX checkpoint.
    losses = port_main(argv + ["--steps", "3", "--device", "cpu"])
    assert len(losses) == 1 and np.isfinite(losses[0])
