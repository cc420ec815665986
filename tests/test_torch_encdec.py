"""The port's encoder-decoder family (seamless-m4t-medium at ``reduced()``)
against the JAX package's ``models/encdec.py``, on the CPU.

The JAX package's ``init_model`` (``PRNGKey(0)``) gives the parameters; the
port takes them through ``interop.params_from_numpy``. Seeded numpy frame
embeddings and target tokens go through both packages' ``encode``,
``decode_train(collect_cache=True)``, and then 4 decode steps from the same
cache (the collected self and cross K/V, position St), each step's logits
and cache held to ``tol_for(float32, d_model * num_layers) * (1 + max
|jax|)``, leaf by leaf. ``tests/test_arch_smoke.py`` holds only shapes and
finiteness for this family; this file holds values.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import encdec as JED
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_model as jax_init_model
from repro.models import param_count as jax_param_count
from repro.models import split_params as jax_split_params
from repro_torch import interop
from repro_torch import models as PM
from repro_torch.configs import ARCHS
from repro_torch.models import encdec as ED
from tests.strategies import tol_for

NAME = "seamless-m4t-medium"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the cases are many small operations, and the
    suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
B, SS, ST, STEPS = 2, 12, 8, 4


def limit(cfg, ref):
    tol = tol_for(np.float32, cfg.d_model * cfg.num_layers)
    return tol * (1.0 + float(np.max(np.abs(ref))))


def assert_close(got, want, cfg, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= limit(cfg, want), (what, err, limit(cfg, want))


def cache_from(cfg, collected, src_len, slots):
    """The decode cache a prefill of St target tokens leaves: collected
    self K/V in the first St slots, the cross K/V whole, pos = St."""
    k, v, ck, cv = collected
    cache = JED.init_encdec_cache(cfg, B, slots, src_len, jnp.float32)
    cache["k"] = cache["k"].at[:, :, :ST].set(k)
    cache["v"] = cache["v"].at[:, :, :ST].set(v)
    cache["xk"], cache["xv"] = ck, cv
    cache["pos"] = jnp.asarray(ST, jnp.int32)
    return cache


@pytest.fixture(scope="module")
def run():
    cfg, pcfg = JAX_ARCHS[NAME].reduced(), ARCHS[NAME].reduced()
    params = jax_init_model(jax.random.PRNGKey(0), cfg)
    values, axes = jax_split_params(params)
    rng = np.random.default_rng(11)
    src = rng.normal(size=(B, SS, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.vocab_size, (B, ST)).astype(np.int32)
    nxt = rng.integers(0, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    enc = jax.jit(lambda v, s: JED.encode(v, cfg, s))(values, jnp.asarray(src))
    logits, caches = jax.jit(lambda v, e, t: JED.decode_train(
        v, cfg, e, t, collect_cache=True))(values, enc, jnp.asarray(tgt))
    fwd = jax.jit(lambda v, b: jax_forward(v, cfg, b))(
        values, {"src_embeds": jnp.asarray(src), "tokens": jnp.asarray(tgt)})
    cache = cache_from(cfg, caches, SS, ST + STEPS)
    start = {k: np.asarray(x) for k, x in cache.items()}
    step = jax.jit(lambda v, c, t: jax_decode_step(v, cfg, c, t))
    steps = []
    for t in range(STEPS):
        lg, cache = step(values, cache, jnp.asarray(nxt[t]))
        steps.append((np.asarray(lg),
                      {k: np.asarray(x) for k, x in cache.items()}))
    model = interop.params_from_numpy(jax.tree.map(np.asarray, values), pcfg,
                                      device="cpu")
    return dict(cfg=cfg, pcfg=pcfg, values=values, axes=axes,
                count=jax_param_count(params), src=src, tgt=tgt, nxt=nxt,
                enc=np.array(enc), logits=np.asarray(logits),
                caches=[np.asarray(c) for c in caches], fwd=np.asarray(fwd),
                start=start, steps=steps, model=model)


def test_params_axes_and_count_match_jax(run):
    model = run["model"]
    assert PM.param_count(model) == run["count"]
    _, axes = PM.split_params(model)
    assert axes == run["axes"]
    back = interop.params_to_numpy(model)
    want = jax.tree.map(np.asarray, run["values"])
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@torch.no_grad()
def test_encode_and_decode_train_match_jax(run):
    cfg, pcfg, model = run["cfg"], run["pcfg"], run["model"]
    enc = ED.encode(model, pcfg, torch.from_numpy(run["src"]))
    assert_close(enc.numpy(), run["enc"], cfg, "encode")
    logits, caches = ED.decode_train(model, pcfg, torch.from_numpy(run["enc"]),
                                     torch.from_numpy(run["tgt"]),
                                     collect_cache=True)
    assert logits.dtype == torch.float32
    assert_close(logits.numpy(), run["logits"], cfg, "decode_train")
    for name, got, want in zip("k v xk xv".split(), caches, run["caches"]):
        assert_close(got.numpy(), want, cfg, f"collected {name}")
    fwd = PM.forward(model, pcfg, {"src_embeds": torch.from_numpy(run["src"]),
                                   "tokens": torch.from_numpy(run["tgt"])})
    assert_close(fwd.numpy(), run["fwd"], cfg, "forward")
    hidden = ED.decode_hidden(model, pcfg, torch.from_numpy(run["enc"]),
                              torch.from_numpy(run["tgt"]))
    assert hidden.shape == (B, ST, pcfg.d_model)


@torch.no_grad()
def test_decode_steps_and_caches_match_jax(run):
    """From the same cache, each of 4 steps' logits and the cache after
    it, through the port's ``models.decode_step``, which writes the cache
    it was given in place (donated, as the JAX dry run's step)."""
    cfg, pcfg, model = run["cfg"], run["pcfg"], run["model"]
    cache = interop.cache_from_numpy(run["start"], device="cpu")
    given = {k: v.data_ptr() for k, v in cache.items()}
    for t, (lg, jcache) in enumerate(run["steps"]):
        out, new = PM.decode_step(model, pcfg, cache,
                                  torch.from_numpy(run["nxt"][t]))
        assert_close(out.numpy(), lg, cfg, f"step {t} logits")
        got = interop.cache_to_numpy(new)
        assert set(got) == set(jcache)
        assert int(got["pos"]) == int(jcache["pos"]) == ST + t + 1
        for k in ("k", "v", "xk", "xv"):
            assert_close(got[k], jcache[k], cfg, f"step {t} cache {k}")
        # The cache is donated: each leaf written in its own storage.
        assert {k: v.data_ptr() for k, v in new.items()} == given
        cache = new


def test_init_cache_matches_jax(run):
    cfg, pcfg = run["cfg"], run["pcfg"]
    got = PM.init_cache(pcfg, B, 16, torch.float32, device="cpu")
    from repro.models import init_cache as jax_init_cache

    want = jax_init_cache(cfg, B, 16, jnp.float32)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert not bool(got[k].any())
    assert got["pos"].dtype == torch.int32


def test_serve_driver_refuses_encdec():
    from repro_torch.launch import serve

    pcfg = ARCHS[NAME].reduced()
    model = PM.init_model(pcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="decoder-only"):
        serve.generate(pcfg, model, torch.zeros((1, 2), dtype=torch.int32),
                       gen=1, cache_len=4)
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", NAME, "--device", "cpu"])
