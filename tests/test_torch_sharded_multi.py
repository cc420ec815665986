"""The port's column-sharded driver on four ranks against the JAX package
on four devices, all on the CPU.

ONE JAX subprocess on four virtual CPU devices writes every reference
output to an ``.npz``; ONE spawn of four gloo ranks (a ``file://`` store
in the test's temporary directory, never a TCP port) computes the port's
outputs, gathered whole on rank 0; the parent compares them, case by
case: a single mesh axis of four ranks, a 2 x 2 mesh with
``axis=("data", "model")``, with the reversed ``("model", "data")`` (the
mesh's dims out of order) and with ``axis="model"`` (two shards, each
held by two ranks), update and downdate, a B = 3 fleet, bf16 storage,
the feasibility guard, whose verdict crosses the ranks, and the diagonal
read shard by shard. Tolerances as in
``tests/test_torch_sharded.py``. Marked ``slow`` like
``tests/test_distributed.py``.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import sys
import textwrap
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parent.parent
N, K, PANEL, B = 32, 3, 8, 3
BF16_EPS = 2.0 ** -8
FP32_TOL = 50 * float(np.finfo(np.float32).eps) * N  # tol_for(float32, N)
COMBINED = ["data", "model"]

# name, mesh, axis, strategy, sigma, fleet, precision
CASES = [
    ("m4_fused_up", "m4", "model", "fused", 1, False, None),
    ("m4_fused_down", "m4", "model", "fused", -1, False, None),
    ("m4_gemm_up", "m4", "model", "gemm", 1, False, None),
    ("m4_paper_down", "m4", "model", "paper", -1, False, None),
    ("m22_fused_up", "m22", COMBINED, "fused", 1, False, None),
    ("m22_fused_down", "m22", COMBINED, "fused", -1, False, None),
    ("m22_paper_up", "m22", COMBINED, "paper", 1, False, None),
    ("m22_model_fused_up", "m22", "model", "fused", 1, False, None),
    ("m22_rev_fused_up", "m22", ["model", "data"], "fused", 1, False, None),
    ("m4_fleet_fused_up", "m4", "model", "fused", 1, True, None),
    ("m22_fleet_gemm_down", "m22", COMBINED, "gemm", -1, True, None),
    ("m4_bf16_fused_up", "m4", "model", "fused", 1, False, "bf16"),
]

JAX_SCRIPT = """
import json, sys
import jax.numpy as jnp
import numpy as np
from repro.core.api import chol_update, chol_update_batched
from repro.core.factor import CholFactor
from repro.runtime.compat import make_mesh_compat

d = sys.argv[1]
inp = dict(np.load(f"{d}/inputs.npz"))
meshes = {"m4": make_mesh_compat((4,), ("model",)),
          "m22": make_mesh_compat((2, 2), ("data", "model"))}
out = {}
for name, mesh, axis, strategy, sigma, fleet, prec in json.load(
        open(f"{d}/cases.json")):
    mesh = meshes[mesh]
    axis = axis if isinstance(axis, str) else tuple(axis)
    L = jnp.asarray(inp[("Ls" if fleet else "L") + ("_down" if sigma < 0
                                                    else "")])
    V = jnp.asarray(inp["Vs" if fleet else "V"])
    fn = chol_update_batched if fleet else chol_update
    with mesh:
        r = fn(L, V, sigma=sigma, method="sharded", mesh=mesh, axis=axis,
               panel=%(panel)d, strategy=strategy, interpret=True,
               precision=prec)
    out[name] = np.asarray(r, np.float32)
with meshes["m4"]:
    f = CholFactor(jnp.asarray(inp["Ls_guard"]), panel=%(panel)d,
                   backend="sharded", mesh=meshes["m4"], axis="model",
                   interpret=True)
    new, ok = f.downdate_guarded(jnp.asarray(inp["V_bad"]))
out["guard"] = np.asarray(new.data)
out["guard_ok"] = np.asarray(ok)
np.savez(f"{d}/jax.npz", **out)
""" % {"panel": PANEL}


def _factor_plus(L, V):
    """The factor of A + V V^T (float64), a downdate's start."""
    A = L.astype(np.float64).swapaxes(-1, -2) @ L + V.astype(
        np.float64) @ V.swapaxes(-1, -2)
    return np.linalg.cholesky(A).swapaxes(-1, -2).astype(np.float32)


def make_inputs(seed=0):
    """tests/strategies.py make_problem's procedure (B, V ~ U[0,1], A =
    B^T B + I), single and as a fleet."""
    rng = np.random.default_rng(seed)

    def problem():
        Bm = rng.uniform(size=(N, N)).astype(np.float32)
        V = rng.uniform(size=(N, K)).astype(np.float32)
        A = Bm.T @ Bm + np.eye(N, dtype=np.float32)
        return np.linalg.cholesky(A).T, V

    L, V = problem()
    Ls, Vs = (np.stack(x) for x in zip(*[problem() for _ in range(B)]))
    guard = _factor_plus(Ls, Vs)  # members 0 and 2 stay PD
    V_bad = Vs.copy()
    V_bad[1] *= 40.0  # member 1 leaves the PD cone
    return dict(L=L, V=V, L_down=_factor_plus(L, V), Ls=Ls, Vs=Vs,
                Ls_down=_factor_plus(Ls, Vs), Ls_guard=guard, V_bad=V_bad)


def _rank_main(rank, d):
    """One gloo rank: every case through the port's entry points, the
    results gathered whole; rank 0 saves them."""
    try:
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.core import CholFactor, api, distributed
        from repro_torch.obs import metrics

        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{d}/store",
                                world_size=4, rank=rank,
                                timeout=timedelta(seconds=60))
        meshes = {"m4": init_device_mesh("cpu", (4,),
                                         mesh_dim_names=("model",)),
                  "m22": init_device_mesh("cpu", (2, 2),
                                          mesh_dim_names=("data", "model"))}
        inp = {k: torch.from_numpy(v)
               for k, v in np.load(f"{d}/inputs.npz").items()}
        out = {}
        for name, mesh, axis, strategy, sigma, fleet, prec in CASES:
            mesh = meshes[mesh]
            L = inp[("Ls" if fleet else "L") + ("_down" if sigma < 0
                                                else "")]
            V = inp["Vs" if fleet else "V"]
            fn = api.chol_update_batched if fleet else api.chol_update
            w0 = metrics.value("repro.kernels.plain_walks", module="sharded")
            r = fn(L, V, sigma=sigma, method="sharded", mesh=mesh,
                   axis=axis, panel=PANEL, strategy=strategy,
                   precision=prec)
            walks = metrics.value("repro.kernels.plain_walks",
                                  module="sharded") - w0
            # One panel phase per rank per update (fused); none otherwise.
            assert walks == (strategy == "fused"), (name, walks)
            assert r.to_local().shape[-1] == N // distributed.n_shards(
                mesh, axis), name
            full = distributed.gather(r)
            # JAX's layout: shard index row-major over the axis's dims in
            # the order it lists them, whatever the mesh's order.
            names = mesh.mesh_dim_names
            me = 0
            for ax in distributed.axis_tuple(axis):
                dim = names.index(ax)
                me = me * mesh.size(dim) + mesh.get_local_rank(dim)
            w = r.to_local().shape[-1]
            assert distributed.shard_index(mesh, axis) == me, name
            assert torch.equal(r.to_local(),
                               full[..., me * w:(me + 1) * w]), name
            out[name] = full.float().numpy()
            # The diagonal shard by shard, joined in the shards' order.
            out[name + "_diag"] = distributed.diagonal(
                r, mesh=mesh, axis=axis).float().numpy()
        f = CholFactor(inp["Ls_guard"], panel=PANEL, backend="sharded",
                       mesh=meshes["m4"], axis="model")
        new, ok = f.downdate_guarded(inp["V_bad"])
        out["guard"] = distributed.gather(new.data).numpy()
        out["guard_ok"] = ok.numpy()
        if rank == 0:
            np.savez(f"{d}/port.npz", **out)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.exit(1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_multi")
    inputs = make_inputs()
    np.savez(d / "inputs.npz", **inputs)
    (d / "cases.json").write_text(json.dumps(CASES))
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["PYTHONPATH"] = f"{REPO / 'src'}:{env.get('PYTHONPATH', '')}"
    env["JAX_PLATFORMS"] = "cpu"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    ctx = multiprocessing.get_context("spawn")
    ranks = [ctx.Process(target=_rank_main, args=(r, str(d)))
             for r in range(4)]
    try:
        for p in ranks:
            p.start()
        for p in ranks:
            p.join(timeout=180)
        codes = [p.exitcode for p in ranks]
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        for p in ranks:
            if p.is_alive():
                p.kill()
                p.join()
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert codes == [0] * 4, f"port ranks exited with {codes}"
    assert jax_proc.returncode == 0, log
    return (inputs, dict(np.load(d / "jax.npz")),
            dict(np.load(d / "port.npz")))


def rel_frob_A(L_new, L, V, sigma):
    L_new = np.asarray(L_new, np.float64)
    L, V = L.astype(np.float64), V.astype(np.float64)
    A = L.T @ L + sigma * V @ V.T
    return float(np.linalg.norm(L_new.T @ L_new - A) / np.linalg.norm(A))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_four_ranks_diagonal_without_the_factor(runs, case):
    """The O(n) diagonal of a sharded result is the gathered factor's."""
    _, _, ours = runs
    name = case[0]
    np.testing.assert_array_equal(
        ours[name + "_diag"], np.diagonal(ours[name], axis1=-2, axis2=-1))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_four_ranks_match_jax(runs, case):
    inputs, theirs, ours = runs
    name, _, _, _, sigma, fleet, prec = case
    assert ours[name].shape == theirs[name].shape == (
        (B, N, N) if fleet else (N, N))
    if prec is None:
        np.testing.assert_allclose(ours[name], theirs[name], atol=FP32_TOL)
        return
    L = inputs["L_down" if sigma < 0 else "L"]
    e_t = rel_frob_A(ours[name], L, inputs["V"], sigma)
    e_j = rel_frob_A(theirs[name], L, inputs["V"], sigma)
    assert e_t <= 32 * BF16_EPS and e_t <= 2 * e_j


def test_four_ranks_guard_matches_jax(runs):
    inputs, theirs, ours = runs
    assert ours["guard_ok"].tolist() == theirs["guard_ok"].tolist() == [
        True, False, True]
    # The infeasible member keeps its factor, bit for bit.
    np.testing.assert_array_equal(ours["guard"][1], inputs["Ls_guard"][1])
    np.testing.assert_allclose(ours["guard"], theirs["guard"], atol=FP32_TOL)
