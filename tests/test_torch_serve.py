"""The port's configs, data pipeline, serve driver and ``serve_lm`` sidecar
against the JAX package's, on the CPU.

* every ``ModelConfig`` and its ``reduced()`` equal to JAX's field for
  field (``dataclasses.asdict``), ``cells()`` and ``SHAPES`` equal;
* ``SyntheticTokens.batch_at`` equal bit for bit (three steps, and a host
  shard);
* greedy ``generate`` on llama3.2 ``reduced()`` with the JAX weights gives
  JAX's tokens (the mirror of ``tests/test_launch.py``'s serve test);
* ``serve_lm.personalize`` fed the JAX example's own generated token
  stream (the JAX example loaded from its file) returns the JAX run's
  mutations and rows exactly and its max error within
  tol_for(float32, d_feat) of the JAX run's; so does the sidecar sharded
  over a one-rank gloo mesh (the four-rank run is in
  ``tests/test_torch_cuda.py``, on the card).
"""
from __future__ import annotations

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as JC
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.launch.serve import generate as jax_generate
from repro.models import init_model as jax_init_model
from repro.models import split_params as jax_split_params
from repro_torch import configs as PC
from repro_torch import interop
from repro_torch.data import DataConfig, SyntheticTokens, frontend_stub_embeds
from repro_torch.examples import serve_lm
from repro_torch.launch import serve
from repro_torch.obs import metrics as obs_metrics
from repro_torch.stream import FactorStore
from tests.strategies import tol_for
from tests.test_torch_examples import jax_example

D_FEAT = 32


@pytest.mark.parametrize("name", sorted(JC.ARCHS))
def test_config_and_reduced_equal_jax(name):
    ours, theirs = PC.get_config(name), JC.get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(ours.reduced()) == dataclasses.asdict(
        theirs.reduced())
    for cfg, ref in ((ours, theirs), (ours.reduced(), theirs.reduced())):
        assert cfg.vocab_padded == ref.vocab_padded
        assert cfg.sub_quadratic == ref.sub_quadratic


def test_registry_cells_and_shapes_equal_jax():
    assert sorted(PC.ARCHS) == sorted(JC.ARCHS)
    assert PC.cells() == JC.cells()
    assert [dataclasses.asdict(s) for s in PC.SHAPES] == [
        dataclasses.asdict(s) for s in JC.SHAPES]
    with pytest.raises(ValueError, match="unknown arch"):
        PC.get_config("nope")


@pytest.mark.parametrize("hosts", [(0, 1), (1, 2)])
def test_synthetic_tokens_equal_jax_bit_for_bit(hosts):
    host, n = hosts
    ours = SyntheticTokens(DataConfig(512, 16, 4, seed=3), host_index=host,
                           num_hosts=n)
    theirs = JSyntheticTokens(JDataConfig(512, 16, 4, seed=3),
                              host_index=host, num_hosts=n)
    for step in (0, 1, 7):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == torch.int32
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))


def test_frontend_stub_embeds_shape_scale_and_seed():
    cfg = PC.get_config("pixtral-12b").reduced()
    e = frontend_stub_embeds(cfg, 2, 3, dtype=torch.float32)
    assert e.shape == (2, 3, cfg.d_model) and e.dtype == torch.float32
    assert torch.equal(e, frontend_stub_embeds(cfg, 2, 3,
                                               dtype=torch.float32))
    assert not torch.equal(e, frontend_stub_embeds(cfg, 2, 3, step=1,
                                                   dtype=torch.float32))
    g = torch.Generator().manual_seed(5)
    x = frontend_stub_embeds(cfg, 64, 8, generator=g)
    assert x.dtype == torch.bfloat16
    assert abs(float(x.float().std()) * np.sqrt(cfg.d_model) - 1.0) < 0.05


def test_greedy_generate_gives_jax_tokens():
    jcfg = JC.get_config("llama3.2-3b").reduced()
    cfg = PC.get_config("llama3.2-3b").reduced()
    values, _ = jax_split_params(jax_init_model(jax.random.PRNGKey(0), jcfg))
    toks_j, _ = jax_generate(jcfg, values, jnp.ones((2, 8), jnp.int32),
                             gen=8, cache_len=16)
    model = interop.params_from_numpy(jax.tree.map(np.asarray, values), cfg,
                                      device="cpu")
    toks, tps = serve.generate(cfg, model, torch.ones((2, 8),
                                                      dtype=torch.int32),
                               gen=8, cache_len=16)
    assert toks.shape == (2, 16) and toks.dtype == torch.int32 and tps > 0
    np.testing.assert_array_equal(toks.numpy(), np.asarray(toks_j))


def test_sampled_generate_follows_its_generator():
    cfg = PC.get_config("h2o-danube-1.8b").reduced()
    from repro_torch.models import init_model

    model = init_model(cfg, device="cpu", seed=1)
    prompts = SyntheticTokens(DataConfig(cfg.vocab_size, 4, 2,
                                         seed=2)).batch_at(0)["tokens"]
    runs = [serve.generate(cfg, model, prompts, gen=6, cache_len=10,
                           temperature=0.8, seed=s)[0] for s in (0, 0, 1)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0],
                                                              runs[2])
    assert torch.equal(runs[0][:, :4], prompts)
    assert int(runs[0].max()) < cfg.vocab_size and int(runs[0].min()) >= 0


def test_serve_cli_on_the_cpu_and_refusals(capsys):
    tps = serve.main(["--arch", "rwkv6-3b", "--batch", "2", "--prompt-len",
                      "4", "--gen", "3", "--device", "cpu"])
    assert tps > 0
    assert "generated (2, 7) tokens" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "seamless-m4t-medium", "--device", "cpu"])
    cfg = PC.get_config("seamless-m4t-medium").reduced()
    with pytest.raises(NotImplementedError):
        serve.generate(cfg, torch.nn.Linear(1, 1), torch.ones((1, 2)),
                       gen=1, cache_len=3)


@pytest.fixture(scope="module")
def jax_sidecar():
    """The JAX example's decode (its ``main``'s: reduced h2o-danube,
    PRNGKey(0), SyntheticTokens seed 2, temperature 0.8) and its
    ``personalize`` over the generated tokens."""
    mod = jax_example("serve_lm")
    cfg = JC.get_config("h2o-danube-1.8b").reduced()
    values, _ = jax_split_params(jax_init_model(jax.random.PRNGKey(0), cfg))
    prompts = JSyntheticTokens(JDataConfig(cfg.vocab_size, 32, 8,
                                           seed=2)).batch_at(0)["tokens"]
    toks, _ = jax_generate(cfg, values, prompts, gen=64, cache_len=96,
                           temperature=0.8)
    stream = np.asarray(toks[:, 32:])
    return stream, mod.personalize(stream)


def _matches(ours, theirs, *, same_flushes=True):
    """``same_flushes=False``: a background worker's flushes follow its
    wake-ups, so how many mutations absorb the same rows depends on
    timing, in either package."""
    err, muts, rows = ours
    err_j, muts_j, rows_j = theirs
    assert rows == rows_j and muts < rows and err < 1e-2
    if same_flushes:
        assert muts == muts_j
    assert abs(err - err_j) <= tol_for(np.float32, D_FEAT), (err, err_j)


def test_personalize_matches_jax(jax_sidecar):
    stream, theirs = jax_sidecar
    _matches(serve_lm.personalize(stream, device="cpu"), theirs)


def test_personalize_background_worker_matches_jax(jax_sidecar):
    stream, theirs = jax_sidecar
    _matches(serve_lm.personalize(stream, background=True, device="cpu"),
             theirs, same_flushes=False)


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_personalize_sharded_one_rank_matches_jax(jax_sidecar, one_rank):
    stream, theirs = jax_sidecar
    with mock.patch.object(FactorStore, "warmup", autospec=True,
                           side_effect=FactorStore.warmup) as warmup:
        ours = serve_lm.personalize(torch.from_numpy(stream.copy()),
                                    sharded=True, device="cpu")
    assert warmup.call_count == 1 and warmup.call_args.args[0].sharded
    _matches(ours, theirs)


def test_serve_lm_run_on_the_cpu(capsys):
    # the summary's counters are process-wide: drop what earlier tests in
    # this process counted, so "retraces=0" speaks of this run alone
    obs_metrics.REGISTRY.reset()
    tps, err, muts, rows = serve_lm.run(stats=True, device="cpu")
    out = capsys.readouterr().out
    assert tps > 0 and err < 1e-2 and muts < rows == 512
    assert "personalization sidecar" in out and "obs: mutations=" in out
    assert "retraces=0" in out
