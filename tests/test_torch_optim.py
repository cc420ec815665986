"""The port's optimizers against tests/test_optim.py and the JAX package.

Case by case the mirrors of tests/test_optim.py run on the port (CPU
tensors: the maintained factors take the plain versions of the kernel
backends). Then the parity trajectories: ``cholesky_precond`` (d = 32,
other = 48, k = 4, window = 2) and ``adamw`` take 4 steps in both packages
from the same parameters and gradients, with the port's sketch draw
replaced by JAX's ``Omega``; deltas agree at ``rtol=1e-4, atol=1e-5`` and
factors at ``rtol=1e-4, atol=1e-4``, the bar tests/test_optim.py holds the
JAX package's own two backends to. A JAX state carried across after 2
steps (``interop.optimizer_state_from_numpy``) and continued 2 steps in
the port meets the same bar against the JAX run's steps 3-4.

The runs take ``eps = 1``. At the default ``eps = 1e-2`` the statistics
``eps I + sketches`` (rank 4 of 32) are too ill-conditioned for the bar:
the JAX package's own ``fused`` and ``reference`` backends differ by
1.7e-3 on the factor from the first windowed downdate (step 3) on, and
the last-place difference between torch's and XLA's product ``G Omega``
(2.5e-6) moves the port's first delta by 2e-3 relative.
"""
from __future__ import annotations

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as joptim
import repro_torch.optim as optim
from repro_torch import interop

# The module (the package exports its function under the same name).
cp = importlib.import_module("repro_torch.optim.cholesky_precond")

DELTA_TOL = dict(rtol=1e-4, atol=1e-5)
FACTOR_TOL = dict(rtol=1e-4, atol=1e-4)


def quad_problem(seed=0, m=64, n=32, N=256, cond=1e3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, m)).astype(np.float32) @ np.diag(
        np.logspace(0, -np.log10(cond), m)).astype(np.float32)
    Wstar = rng.normal(size=(m, n)).astype(np.float32)
    X, Y = torch.from_numpy(X), torch.from_numpy(X @ Wstar)

    def loss_fn(params):
        return 0.5 * torch.mean(torch.square(X @ params["w"] - Y))

    return loss_fn, {"w": torch.zeros((m, n))}


def run_steps(opt, loss_fn, params, steps):
    state = opt.init(params)
    l0 = None
    for _ in range(steps):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(p)
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        upd, state = opt.update(grads, state, params)
        params = optim.apply_updates(params, upd)
        l0 = float(loss.detach()) if l0 is None else l0
    return params, state, l0, float(loss_fn(params))


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),
    ("sgd", {"momentum": 0.9}),
    ("cholesky_precond", {"rank": 8, "block_size": 64}),
    ("cholesky_precond", {"rank": 8, "block_size": 32, "window": 8}),
])
def test_optimizers_decrease_loss(name, kw):
    loss_fn, params = quad_problem()
    opt = optim.get_optimizer(name, 0.03, **kw)
    params, _, l0, l_end = run_steps(opt, loss_fn, params, 120)
    assert np.isfinite(l_end)
    assert l_end < 0.5 * l0, f"{name} failed to reduce loss: {l0} -> {l_end}"
    assert bool(optim.all_finite(params))


def test_cholesky_precond_factors_stay_valid():
    loss_fn, params = quad_problem(seed=3)
    opt = optim.get_optimizer("cholesky_precond", 0.03, rank=4,
                              block_size=32, window=4)
    _, state, _, _ = run_steps(opt, loss_fn, params, 30)
    c = state["factors"]["w"]["c"]
    assert c.batched and bool(c.is_valid().all())
    assert float(torch.tril(c.data, -1).abs().max()) < 1e-5


def test_cholesky_precond_window_tracks_recent_stats():
    """With a window the factor over W steps equals eps I + the last W
    sketches (beta = 1), which the ring holds."""
    rng = np.random.default_rng(0)
    d, other, k, W = 16, 32, 4, 4
    opt = optim.get_optimizer("cholesky_precond", 0.01, rank=k,
                              block_size=d, window=W, beta=1.0, eps=1e-2)
    params = {"w": torch.zeros((d, other))}
    state = opt.init(params)
    for _ in range(8):
        g = torch.from_numpy(rng.normal(size=(d, other)).astype(np.float32))
        _, state = opt.update({"w": g}, state, params)
    C = state["factors"]["w"]["c"].data[0]
    ring = state["factors"]["w"]["ring"]
    A_expected = 1e-2 * torch.eye(d) + sum(r @ r.T for r in ring)
    torch.testing.assert_close(C.T @ C, A_expected, rtol=2e-3, atol=2e-4)


def test_cholesky_precond_fused_backend_in_training():
    """The maintained factor routes through the registry: the fused
    chain (its plain version on CPU tensors) inside the step matches the
    reference backend's statistics."""
    rng = np.random.default_rng(7)
    d, other, k = 32, 48, 4
    params = {"w": torch.zeros((d, other))}
    grads = {"w": torch.from_numpy(rng.normal(size=(d, other))
                                   .astype(np.float32))}
    outs = {}
    for backend in ("fused", "reference"):
        opt = optim.get_optimizer("cholesky_precond", 0.01, rank=k,
                                  block_size=d, update_method=backend)
        state = opt.init(params)
        assert state["factors"]["w"]["c"].backend == backend
        for _ in range(2):
            upd, state = opt.update(grads, state, params)
        outs[backend] = (upd["w"], state["factors"]["w"]["c"].data)
    torch.testing.assert_close(outs["fused"][0], outs["reference"][0],
                               **DELTA_TOL)
    torch.testing.assert_close(outs["fused"][1], outs["reference"][1],
                               **FACTOR_TOL)


def test_adamw_bf16_state_dtype():
    loss_fn, params = quad_problem(seed=1)
    opt = optim.adamw(0.01, state_dtype=torch.bfloat16)
    _, state, l0, l_end = run_steps(opt, loss_fn, params, 60)
    assert state["m"]["w"].dtype == torch.bfloat16
    assert l_end < l0


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert optim.cast_tree(g, torch.bfloat16)["a"].dtype == torch.bfloat16


def test_schedules():
    s = optim.warmup_cosine(1.0, warmup_steps=10, total_steps=100, floor=0.1)
    assert s(5) == pytest.approx(0.5)
    assert s(10) == pytest.approx(1.0, rel=1e-5)
    assert s(100) == pytest.approx(0.1, rel=1e-5)
    inv = optim.inverse_sqrt(1.0, warmup_steps=100)
    assert inv(400) == pytest.approx(0.5)
    # The JAX package's schedules, step by step.
    js = joptim.warmup_cosine(1.0, warmup_steps=10, total_steps=100,
                              floor=0.1)
    jinv = joptim.inverse_sqrt(1.0, warmup_steps=100)
    for step in (0, 3, 10, 57, 100, 130, 400):
        assert s(step) == pytest.approx(float(js(jnp.asarray(step))),
                                        rel=1e-6, abs=1e-7)
        assert inv(step) == pytest.approx(float(jinv(jnp.asarray(step))),
                                          rel=1e-6)
    assert optim.constant(0.3)(7) == pytest.approx(0.3)


def test_get_optimizer_unknown():
    with pytest.raises(ValueError):
        optim.get_optimizer("adagrad", 0.1)


# ---------------------------------------------------------------------------
# Parity with the JAX package.
# ---------------------------------------------------------------------------

D, OTHER, RANK, WINDOW, SEED = 32, 48, 4, 2, 5


KW = {"cholesky_precond": dict(rank=RANK, block_size=D, window=WINDOW,
                               seed=SEED, eps=1.0),
      "adamw": dict(weight_decay=0.01)}


def jax_sketch(other, rank, *, seed, step, index, device):
    """JAX's Omega / sqrt(rank) (``repro.optim.cholesky_precond``'s draw)
    in the port's ``sketch`` signature."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    om = jax.random.normal(jax.random.fold_in(key, index), (other, rank),
                           jnp.float32) / jnp.sqrt(jnp.float32(rank))
    return torch.from_numpy(np.array(om)).to(device)


def grad_seq(steps=4):
    rng = np.random.default_rng(13)
    return [rng.normal(size=(D, OTHER)).astype(np.float32)
            for _ in range(steps)]


def jax_run(name, steps, state=None):
    """Deltas of each step and the final state, the JAX package."""
    opt = joptim.get_optimizer(name, 0.01, **KW[name])
    params = {"w": jnp.zeros((D, OTHER), jnp.float32)}
    state = opt.init(params) if state is None else state
    deltas = []
    for g in steps:
        upd, state = opt.update({"w": jnp.asarray(g)}, state, params)
        deltas.append(np.asarray(upd["w"]))
    return deltas, state


def port_run(name, steps, state=None):
    opt = optim.get_optimizer(name, 0.01, **KW[name])
    params = {"w": torch.zeros((D, OTHER))}
    state = opt.init(params) if state is None else state
    deltas = []
    for g in steps:
        upd, state = opt.update({"w": torch.from_numpy(g)}, state, params)
        deltas.append(upd["w"].numpy())
    return deltas, state


def jax_state_to_numpy(state):
    """The JAX state as numpy, in ``optimizer_state_from_numpy``'s form."""
    out = {k: (np.asarray(state[k]) if k == "step"
               else jax.tree.map(np.asarray, state[k]))
           for k in state if k != "factors"}
    if "factors" in state:
        fac = state["factors"]["w"]
        c = fac["c"]
        out["factors"] = {"w": {
            "c": (np.asarray(c.data),
                  dict(panel=c.panel, backend=c.backend,
                       precision=c.precision, lowering=c.lowering,
                       interpret=c.interpret)),
            "ring": np.asarray(fac["ring"])}}
    return out


def assert_same_run(ours, theirs):
    (d_o, s_o), (d_t, s_t) = ours, theirs
    for a, b in zip(d_o, d_t):
        np.testing.assert_allclose(a, b, **DELTA_TOL)
    if "factors" in s_t:
        np.testing.assert_allclose(s_o["factors"]["w"]["c"].data.numpy(),
                                   np.asarray(s_t["factors"]["w"]["c"].data),
                                   **FACTOR_TOL)
        np.testing.assert_allclose(s_o["factors"]["w"]["ring"].numpy(),
                                   np.asarray(s_t["factors"]["w"]["ring"]),
                                   **FACTOR_TOL)
    assert s_o["step"] == int(s_t["step"])


@pytest.mark.parametrize("name", ["cholesky_precond", "adamw"])
def test_trajectory_matches_jax(name, monkeypatch):
    """4 steps from the same parameters and gradients (the ring fills at
    step 2, so steps 3-4 downdate)."""
    monkeypatch.setattr(cp, "sketch", jax_sketch)
    gs = grad_seq()
    assert_same_run(port_run(name, gs), jax_run(name, gs))


@pytest.mark.parametrize("name", ["cholesky_precond", "adamw"])
def test_jax_state_carried_across_continues_the_run(name, monkeypatch):
    """JAX's state after 2 steps, carried into the port, gives JAX's steps
    3-4; and the port's state survives its own numpy round trip."""
    monkeypatch.setattr(cp, "sketch", jax_sketch)
    gs = grad_seq()
    _, mid = jax_run(name, gs[:2])
    theirs = jax_run(name, gs[2:], state=mid)
    carried = interop.optimizer_state_from_numpy(jax_state_to_numpy(mid),
                                                 device="cpu")
    assert carried["step"] == 2
    assert_same_run(port_run(name, gs[2:], state=carried), theirs)
    back = interop.optimizer_state_from_numpy(
        interop.optimizer_state_to_numpy(carried), device="cpu")
    assert_same_run(port_run(name, gs[2:], state=back), theirs)


def test_sketch_is_seeded_on_the_parameters_device():
    a = cp.sketch(48, 4, seed=0, step=1, index=0, device="cpu")
    b = cp.sketch(48, 4, seed=0, step=1, index=0, device="cpu")
    c = cp.sketch(48, 4, seed=0, step=1, index=1, device="cpu")
    assert a.shape == (48, 4) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
