"""The port's attention-free families against the JAX package's, on the
CPU: rwkv6 (Finch time/channel mix) and zamba2 (Mamba2 layers with a
shared attention block) at ``reduced()``.

The harness and the limits are ``tests/test_torch_models_attn.py``'s: one
JAX run per architecture (init, forward, 8 jitted decode steps from an
fp32 cache), the port on the same weights and inputs; forward logits,
each step's logits and cache, the port's decode against its own forward
(``test_decode_matches_forward_ssm``'s mirror), parameter count and
logical axes; within tol_for(float32, d_model * num_layers) * (1 + max
|jax|). Also the prefill caches ``forward_lm(collect_cache=True)`` gives
(the recurrences' end states; zamba2's grouped layout).
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from tests.test_torch_models_attn import (assert_close, check_decode,
                                          check_decode_matches_forward,
                                          check_forward, check_params,
                                          check_wrap, jax_run, port_model)

SSM_ARCHS = ["rwkv6-3b", "zamba2-7b"]


@pytest.fixture(scope="module", params=SSM_ARCHS)
def run(request):
    return jax_run(request.param, collect=True)


def test_params_and_axes_match_jax(run):
    check_params(run)


def test_forward_matches_jax(run):
    check_forward(run)


def test_decode_steps_and_cache_match_jax(run):
    check_decode(run)


def test_decode_matches_forward(run):
    check_decode_matches_forward(run)


def test_collected_prefill_states_match_jax(run):
    model = port_model(run)
    with torch.no_grad():
        _, _, caches = PT.forward_lm(model, run["pcfg"],
                                     torch.from_numpy(run["toks"]),
                                     collect_cache=True)
    want = jax.tree.leaves(run["caches"])
    got = jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), caches))
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close(g, np.asarray(w), run["cfg"], f"prefill state {i}")


def test_shared_block_ring_wraps_like_jax():
    """zamba2's shared attention under a window of 3: each occurrence's K/V
    ring holds 3 slots over 8 steps, written at ``pos % 3``."""
    check_wrap(jax_run("zamba2-7b", window=3), "sk", 3)


def test_causal_conv_state_carries_across_calls():
    """Two calls of the depthwise conv, the state of the first fed to the
    second, equal one call over the whole sequence (as in JAX)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 5, generator=g)
    w = torch.randn(4, 5, generator=g)
    whole, st = PS._causal_conv(x, w)
    a, st_a = PS._causal_conv(x[:, :3], w)
    b, st_b = PS._causal_conv(x[:, 3:], w, st_a)
    torch.testing.assert_close(torch.cat([a, b], 1), whole)
    torch.testing.assert_close(st_b, st)
    assert st.shape == (2, 3, 5)
