"""The port's LM zoo against the JAX package's, on the CPU: the dense, vlm
and moe families (h2o-danube, llama3.2, granite, gemma2, pixtral, mixtral,
arctic) at ``reduced()``.

A module-scoped fixture per architecture runs the JAX package once:
``init_model`` (``PRNGKey(0)``), ``forward`` on seeded numpy tokens (and,
for the vlm stub, seeded numpy embeds) and 8 jitted decode steps from an
fp32 cache, as ``tests/test_arch_smoke.py`` drives them. The port takes
the same weights (``interop.params_from_numpy``) and the same inputs, and
is held to:

* forward logits, each decode step's logits and the cache after it:
  max |port - jax| <= tol_for(float32, d_model * num_layers) * (1 + max
  |jax|), leaf by leaf;
* its own decode against its own forward at every position, under the
  same limit (the mirror of ``test_decode_matches_forward_*``; not the moe
  family, whose expert capacity depends on the tokens a call routes, so a
  one-token decode step may drop what the forward keeps, in either
  package);
* ``param_count`` and the logical axes of every leaf, equal to JAX's.

One bf16 case: h2o-danube with ``param_dtype='bfloat16'`` and an fp32
cache (the serve-time mix), within 2x the JAX bf16 run's own error against
the JAX fp32 run of the same weights.
"""
from __future__ import annotations

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_model as jax_init_model
from repro.models import param_count as jax_param_count
from repro.models import split_params as jax_split_params
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch import models as PM
from repro_torch.configs import ARCHS
from repro_torch.models import transformer as PT
from tests.strategies import tol_for

B, S = 2, 8
ATTN_ARCHS = ["h2o-danube-1.8b", "llama3.2-3b", "granite-20b", "gemma2-9b",
              "pixtral-12b", "mixtral-8x22b", "arctic-480b"]


def configs(name, *, window=None, **changes):
    """(JAX config, port config) of ``name`` at ``reduced()``; ``window``
    replaces the attention's window in both."""
    out = []
    for cfg in (JAX_ARCHS[name].reduced(), ARCHS[name].reduced()):
        cfg = dataclasses.replace(cfg, **changes)
        if window is not None:
            cfg = dataclasses.replace(
                cfg, attn=dataclasses.replace(cfg.attn, window=window))
        out.append(cfg)
    return tuple(out)


def inputs(cfg, name):
    """Seeded numpy tokens (B, S) and, for the vlm stub, embeds."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    embeds = None
    if cfg.family == "vlm":
        P = max(1, int(S * cfg.frontend_frac))
        embeds = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    return toks, embeds


def jax_run(name, *, collect=False, window=None, **changes):
    """The JAX package's init, forward and 8 decode steps on ``name``."""
    cfg, pcfg = configs(name, window=window, **changes)
    params = jax_init_model(jax.random.PRNGKey(0), cfg)
    values, axes = jax_split_params(params)
    toks, embeds = inputs(cfg, name)
    batch = {"tokens": jnp.asarray(toks)}
    if embeds is not None:
        batch["embeds"] = jnp.asarray(embeds)
    logits = jax.jit(lambda v, b: jax_forward(v, cfg, b))(values, batch)
    cache = jax_init_cache(cfg, B, S, jnp.float32)
    step = jax.jit(lambda v, c, t: jax_decode_step(v, cfg, c, t))
    steps = []
    for t in range(S):
        lg, cache = step(values, cache, jnp.asarray(toks[:, t]))
        steps.append((np.asarray(lg),
                      {k: np.asarray(v) for k, v in cache.items()}))
    out = dict(name=name, cfg=cfg, pcfg=pcfg, values=values, axes=axes,
               count=jax_param_count(params), toks=toks, embeds=embeds,
               logits=np.asarray(logits), steps=steps)
    if collect:
        out["caches"] = jax.jit(lambda v, t: JT.forward_lm(
            v, cfg, t, collect_cache=True)[2])(values, jnp.asarray(toks))
    return out


def port_model(run):
    values = jax.tree.map(np.asarray, run["values"])
    return interop.params_from_numpy(values, run["pcfg"], device="cpu")


@torch.no_grad()
def port_forward(model, run, *, embeds=True):
    batch = {"tokens": torch.from_numpy(run["toks"])}
    if embeds and run["embeds"] is not None:
        batch["embeds"] = torch.from_numpy(run["embeds"])
    return PM.forward(model, run["pcfg"], batch).numpy()


@torch.no_grad()
def port_decode(model, run):
    """The port's 8 decode steps: [(logits, numpy cache)]."""
    cache = PM.init_cache(run["pcfg"], B, S, torch.float32, device="cpu")
    out = []
    for t in range(S):
        lg, cache = PM.decode_step(model, run["pcfg"], cache,
                                   torch.from_numpy(run["toks"][:, t]))
        out.append((lg.numpy(), interop.cache_to_numpy(cache)))
    return out


def limit(cfg, ref):
    """tol_for(float32, d_model * num_layers) * (1 + max |ref|)."""
    tol = tol_for(np.float32, cfg.d_model * cfg.num_layers)
    return tol * (1.0 + float(np.max(np.abs(ref))))


def assert_close(got, want, cfg, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= limit(cfg, want), (what, err, limit(cfg, want))


def check_params(run):
    model = port_model(run)
    values, axes = PM.split_params(model)
    assert values is model
    assert PM.param_count(model) == run["count"]
    is_axes = lambda x: isinstance(x, tuple)  # noqa: E731
    want = jax.tree.map(lambda a: a, run["axes"], is_leaf=is_axes)
    assert axes == want
    # Every leaf's values across and back (bf16 widened to fp32, exactly).
    back = interop.params_to_numpy(model)
    flat_j = jax.tree_util.tree_leaves_with_path(run["values"])
    flat_p = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_p[path], np.asarray(
            leaf, np.float32), err_msg=jax.tree_util.keystr(path))


def check_forward(run):
    assert_close(port_forward(port_model(run), run), run["logits"],
                 run["cfg"], "forward logits")


def check_decode(run):
    ours = port_decode(port_model(run), run)
    for t, ((lg, cache), (lg_j, cache_j)) in enumerate(zip(ours,
                                                           run["steps"])):
        assert_close(lg, lg_j, run["cfg"], f"step {t} logits")
        assert set(cache) == set(cache_j)
        assert int(cache["pos"]) == int(cache_j["pos"]) == t + 1
        for key in cache_j:
            if key != "pos":
                assert_close(cache[key], cache_j[key], run["cfg"],
                             f"step {t} cache {key}")


def check_wrap(run, slots_key, slots):
    """A window narrower than the 8 steps: the cache under ``slots_key``
    holds ``slots`` slots (a ring that wraps when ``slots`` < 8), and each
    step and the decode against the forward hold as in ``check_decode``
    and ``check_decode_matches_forward``."""
    assert run["steps"][0][1][slots_key].shape[2] == slots
    check_decode(run)
    check_decode_matches_forward(run)


def check_decode_matches_forward(run):
    model = port_model(run)
    full = port_forward(model, run, embeds=False)
    dec = np.stack([lg for lg, _ in port_decode(model, run)], axis=1)
    assert_close(dec, full, run["cfg"], "decode vs forward")


@pytest.fixture(scope="module", params=ATTN_ARCHS)
def run(request):
    return jax_run(request.param)


def test_params_and_axes_match_jax(run):
    check_params(run)


def test_forward_matches_jax(run):
    check_forward(run)


def test_decode_steps_and_cache_match_jax(run):
    check_decode(run)


@pytest.mark.parametrize("run", [a for a in ATTN_ARCHS
                                 if ARCHS[a].family != "moe"], indirect=True)
def test_decode_matches_forward(run):
    check_decode_matches_forward(run)


@pytest.mark.parametrize("name,window,slots", [
    ("h2o-danube-1.8b", 3, 3),    # a ring of 3 slots over 8 steps
    ("gemma2-9b", 3, S),          # alternating windows in a linear cache
])
def test_decode_past_the_window_matches_jax(name, window, slots):
    """The ring's slot reuse (``pos % slots``, the positions of overwritten
    slots) and the window mask inside gemma2's linear cache, against JAX
    step by step and against the port's own forward."""
    check_wrap(jax_run(name, window=window), "k", slots)


def test_collected_prefill_cache_matches_jax():
    """forward_lm(collect_cache=True): each layer's rotated K and V."""
    r = jax_run("h2o-danube-1.8b", collect=True)
    model = port_model(r)
    with torch.no_grad():
        _, _, (k, v) = PT.forward_lm(model, r["pcfg"],
                                     torch.from_numpy(r["toks"]),
                                     collect_cache=True)
    assert_close(k.numpy(), r["caches"][0], r["cfg"], "prefill K")
    assert_close(v.numpy(), r["caches"][1], r["cfg"], "prefill V")


def test_moe_top_k_breaks_ties_by_the_lower_index():
    from repro_torch.models.moe import top_k

    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = top_k(probs, 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist() == [[0, 1], [1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_encdec_is_refused():
    """The serve driver refuses the encoder-decoder family, as the JAX
    package's does (the models themselves take it: test_torch_encdec.py)."""
    from repro_torch.launch import serve

    cfg = ARCHS["seamless-m4t-medium"].reduced()
    model = PM.init_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve.generate(cfg, model, torch.zeros((2, 4), dtype=torch.int32),
                       gen=1, cache_len=8)


def test_bf16_params_with_fp32_cache_within_twice_jax_error():
    """h2o-danube at bf16 parameters and an fp32 cache: the port's forward
    and decode logits against the JAX fp32 run of the same (bf16-valued)
    weights, within 2x the JAX bf16 run's own error against it."""
    name = "h2o-danube-1.8b"
    r16 = jax_run(name, param_dtype="bfloat16")
    v32 = jax.tree.map(lambda a: a.astype(jnp.float32), r16["values"])
    cfg32 = dataclasses.replace(r16["cfg"], param_dtype="float32")
    toks = r16["toks"]
    f32 = np.asarray(jax_forward(v32, cfg32, {"tokens": jnp.asarray(toks)}))
    cache = jax_init_cache(cfg32, B, S, jnp.float32)
    step = jax.jit(lambda v, c, t: jax_decode_step(v, cfg32, c, t))
    d32 = []
    for t in range(S):
        lg, cache = step(v32, cache, jnp.asarray(toks[:, t]))
        d32.append(np.asarray(lg))
    model = port_model(r16)
    assert model.embed.tokens.dtype == torch.bfloat16
    fwd = port_forward(model, r16)
    dec = [lg for lg, _ in port_decode(model, r16)]
    for what, ours, jax16, ref in (
            ("forward", fwd, r16["logits"], f32),
            ("decode", np.stack(dec), np.stack([lg for lg, _ in
                                                r16["steps"]]),
             np.stack(d32))):
        jax_err = float(np.max(np.abs(jax16 - ref)))
        our_err = float(np.max(np.abs(ours - ref)))
        assert 0 < jax_err and our_err <= 2 * jax_err, (what, our_err,
                                                        jax_err)


def test_cache_crosses_and_comes_back():
    """A JAX decode cache through ``cache_from_numpy``: the port's next
    step from it equals the step from its own cache at that point."""
    r = jax_run("gemma2-9b")
    model = port_model(r)
    jcache = r["steps"][3][1]
    cache = interop.cache_from_numpy(jcache, device="cpu")
    assert cache["pos"].dtype == torch.int32 and int(cache["pos"]) == 4
    back = interop.cache_to_numpy(cache)
    for key in jcache:
        np.testing.assert_array_equal(back[key], jcache[key])
    with torch.no_grad():
        lg, _ = PM.decode_step(model, r["pcfg"], cache,
                               torch.from_numpy(r["toks"][:, 4]))
    assert_close(lg.numpy(), r["steps"][4][0], r["cfg"], "step from cache")


@pytest.mark.parametrize("window,cap", [(None, None), (5, 50.0)])
def test_chunked_flash_attention_matches_jax(window, cap):
    """Several q and kv chunks (the online softmax across chunks, fully
    masked blocks under a window), GQA, against JAX's flash_attention with
    the same chunks; and against the port's one-chunk call."""
    from repro.models import attention as JA
    from repro_torch.models import attention as PA

    rng = np.random.default_rng(11)
    q = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    kw = dict(causal=True, window=window, cap=cap, q_chunk=4, kv_chunk=4)
    want = np.asarray(JA.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), **kw))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = PA.flash_attention(tq, tk, tv, **kw).numpy()
    one = PA.flash_attention(tq, tk, tv, causal=True, window=window,
                             cap=cap).numpy()
    tol = tol_for(np.float32, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(one, got, rtol=0, atol=tol)


def test_cross_attn_block_matches_jax():
    """Queries from x, keys and values from another sequence (GQA, a
    softcap), against JAX's cross_attn_block on the same weights."""
    from repro.models import attention as JA
    from repro_torch.models import attention as PA

    cfg = dataclasses.replace(JAX_ARCHS["gemma2-9b"].reduced().attn,
                              num_heads=4, num_kv_heads=2, head_dim=8)
    pcfg = dataclasses.replace(ARCHS["gemma2-9b"].reduced().attn,
                               num_heads=4, num_kv_heads=2, head_dim=8)
    rng = np.random.default_rng(5)
    D = 16
    w = {"wq": (D, 4, 8), "wk": (D, 2, 8), "wv": (D, 2, 8), "wo": (4, 8, D)}
    w = {k: (rng.normal(size=sh) / np.sqrt(sh[0])).astype(np.float32)
         for k, sh in w.items()}
    x = rng.normal(size=(2, 6, D)).astype(np.float32)
    src = rng.normal(size=(2, 10, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6), (2, 6)).astype(np.int32)
    kv_pos = np.broadcast_to(np.arange(10), (2, 10)).astype(np.int32)
    want = np.asarray(JA.cross_attn_block(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x),
        jnp.asarray(pos), jnp.asarray(src), jnp.asarray(kv_pos), cfg))
    got = PA.cross_attn_block(
        {k: torch.from_numpy(v) for k, v in w.items()}, torch.from_numpy(x),
        torch.from_numpy(pos), torch.from_numpy(src),
        torch.from_numpy(kv_pos), pcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol_for(
        np.float32, D) * (1 + float(np.max(np.abs(want)))))


def test_final_hidden_state_matches_jax():
    """forward_lm(return_hidden=True): the final-norm hidden state, and
    the logits project_logits makes of it equal the forward's."""
    r = jax_run("h2o-danube-1.8b")
    want, _ = jax.jit(lambda v, t: JT.forward_lm(
        v, r["cfg"], t, return_hidden=True))(r["values"],
                                             jnp.asarray(r["toks"]))
    model = port_model(r)
    with torch.no_grad():
        x, aux = PT.forward_lm(model, r["pcfg"], torch.from_numpy(r["toks"]),
                               return_hidden=True)
        logits = PT.project_logits(model, r["pcfg"], x)
    assert x.shape == (B, S, r["cfg"].d_model) and set(aux)
    assert_close(x.numpy(), np.asarray(want), r["cfg"], "hidden state")
    assert_close(logits.numpy(), r["logits"], r["cfg"], "its logits")
