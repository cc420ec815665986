"""The port's examples against the JAX package's, on the CPU.

Each example of ``src/repro_torch/examples`` runs at the JAX example's
defaults beside the JAX example (``examples/*.py``, loaded from its file):
``quickstart``'s every value against the module's own; ``online_ridge``'s
single stream and ``--batched`` fleet (and the batched fleet sharded over
a one-rank gloo mesh: the four-rank run is in
``tests/test_torch_sharded_multi.py``) against the rows the JAX example
prints; ``kalman_smoother``'s readings against the lines it prints.

Tolerances: factors and solves within ``tol_for(float32, n)`` (a solve
scaled by the solution's size); a printed value within its printed
precision, widened where both runs carry a float32 error of their own
(the ridge rows: each run's ``err_vs_exact`` over ``||true_w||``).
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.examples import kalman_smoother, online_ridge, quickstart
from tests.strategies import tol_for

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def jax_example(name):
    """The JAX example module ``examples/<name>.py``, imported from its
    file (quickstart runs at import)."""
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def numbers(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+(?:e[-+]\d+)?", line)]


def table(text):
    """The ``step  err  w_err`` rows an online_ridge run prints."""
    out = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 3 and parts[0].isdigit():
            out.append((int(parts[0]), float(parts[1]), float(parts[2])))
    return out


@pytest.fixture(scope="module")
def jax_batched():
    """What the JAX example's ``run_batched()`` prints, at its defaults."""
    jo = jax_example("online_ridge")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jo.run_batched()
    return buf.getvalue()


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    store = tmp_path_factory.mktemp("examples_pg") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_quickstart_matches_jax(capsys):
    jq = jax_example("quickstart")
    jax_printed = capsys.readouterr().out
    ours = quickstart.run(device="cpu")
    printed = capsys.readouterr().out
    n = jq.n
    tol = tol_for(np.float32, n)
    for name in ("L_up", "L_up2", "L_back", "L_pal"):
        np.testing.assert_allclose(ours[name].numpy(),
                                   np.asarray(getattr(jq, name)), rtol=0,
                                   atol=tol, err_msg=name)
    np.testing.assert_allclose(ours["f_back"].numpy(), np.asarray(jq.f.data),
                               rtol=0, atol=tol)
    for name in ("x", "x2"):
        want = np.asarray(getattr(jq, name))
        np.testing.assert_allclose(ours[name].numpy(), want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=name)
    (logdet,) = numbers(next(x for x in jax_printed.splitlines()
                             if x.startswith("logdet:")))
    assert abs(ours["logdet"] - logdet) <= 5e-3 + tol * abs(logdet)
    assert ours["guard_ok"] is False and bool(jq.ok) is False
    assert "auto resolves to 'gemm'" in printed


def test_online_ridge_single_matches_jax(capsys):
    jo = jax_example("online_ridge")
    capsys.readouterr()
    jo.run_single()
    theirs = table(capsys.readouterr().out)
    ours = online_ridge.run_single(device="cpu")
    assert len(ours) == len(theirs) == 12
    true_w = np.random.default_rng(0).normal(size=(64,)).astype(np.float32)
    scale = np.sqrt(64) / np.linalg.norm(true_w)
    for (t, e, w), (tj, ej, wj) in zip(ours, theirs):
        assert t == tj and e < 5e-3 and ej < 5e-3
        assert abs(w - wj) <= 1e-4 + scale * (e + ej), t


def _batched_rows_match(ours, muts, theirs_text, users=4, d=64):
    theirs = table(theirs_text)
    assert [r[0] for r in ours] == [r[0] for r in theirs] == [1, 3, 5, 7]
    m = re.search(r"absorbed in (\d+) batched mutations", theirs_text)
    assert muts == int(m.group(1)) == 6
    true_w = np.random.default_rng(0).normal(size=(users, d))
    scale = np.sqrt(d) / np.linalg.norm(true_w, axis=1).min()
    for (t, e, w), (_, ej, wj) in zip(ours, theirs):
        assert e < 5e-3 and ej < 5e-3
        assert abs(w - wj) <= 1e-4 + scale * (e + ej), t


def test_online_ridge_batched_matches_jax(jax_batched):
    ours, muts = online_ridge.run_batched(device="cpu")
    _batched_rows_match(ours, muts, jax_batched)


def test_online_ridge_sharded_one_rank_matches_jax(capsys, one_rank,
                                                   jax_batched):
    """The fleet sharded over a one-rank gloo mesh: the JAX example's
    ``--sharded`` differs from ``--batched`` only in placement, so its
    rows are the batched run's."""
    capsys.readouterr()
    ours, muts = online_ridge.run_batched(sharded=True, device="cpu")
    out = capsys.readouterr().out
    assert "backend='sharded'" in out and "step_mode 'eager'" in out
    _batched_rows_match(ours, muts, jax_batched)


def test_kalman_smoother_matches_jax(capsys, monkeypatch):
    jk = jax_example("kalman_smoother")
    monkeypatch.setattr(sys, "argv", ["kalman_smoother.py"])
    capsys.readouterr()
    jk.main()
    theirs = capsys.readouterr().out.splitlines()
    ours = kalman_smoother.run(device="cpu")
    line = {key: next(x for x in theirs if x.startswith(key))
            for key in ("smoothed mean", "logdet vs", "position RMSE",
                        "outlier retracted", "T=")}
    assert line["T="].startswith("T=32 states, 64 measurements absorbed "
                                 "in 4 rank-16 updates")
    rmse, raw = numbers(line["position RMSE"])
    assert abs(ours["rmse"] - rmse) <= 5e-4 and abs(ours["raw"] - raw) <= 5e-4
    (pull,) = numbers(line["outlier retracted"])
    assert abs(ours["pull"] - pull) <= 5e-3 + 1e-3
    (err,) = numbers(line["smoothed mean"])
    assert ours["err"] < 5e-3 and err < 5e-3
    ld_err = numbers(line["logdet vs"])[0]
    assert ours["ld_err"] < 1e-2 and ld_err < 1e-2
    # The port's means against the dense posterior built from the JAX
    # example's own model, prior, measurements and simulation.
    T, Dm = 32, jk.D
    F, H, Q, R, P0 = jk.model()
    _, ys, _ = jk.simulate(T, F, H, Q, R, P0, 0)
    Ad, Ao = jk.prior_precision_blocks(T, F, Q, P0)
    J = np.zeros((T * Dm, T * Dm))
    for t in range(T):
        J[t * Dm:(t + 1) * Dm, t * Dm:(t + 1) * Dm] = Ad[t]
    for t in range(T - 1):
        J[t * Dm:(t + 1) * Dm, (t + 1) * Dm:(t + 2) * Dm] = Ao[t]
        J[(t + 1) * Dm:(t + 2) * Dm, t * Dm:(t + 1) * Dm] = Ao[t].T
    Vall = jk.measurement_columns(T, range(T), H, R).astype(np.float64)
    J += Vall @ Vall.T
    eta = np.zeros(T * Dm)
    for t in range(T):
        eta[t * Dm:(t + 1) * Dm] = H.T @ np.linalg.inv(R) @ ys[t]
    xs_exact = np.linalg.solve(J, eta).reshape(T, Dm)
    np.testing.assert_allclose(ours["xs"], xs_exact, rtol=0, atol=5e-3)
