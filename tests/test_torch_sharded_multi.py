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

The same two runs carry the stream store's sharded placement:
``tests/test_distributed.py``'s fleet scenario (n = 64, B = 3, width 16,
panel 16: fleets against JAX's within ``tol_for(float32, n)``, one batched
mutation and one panel-phase walk per shard per sign block, the placement
kept through admit / evict / compact / decay), a kill-and-restart within
the port, each package's sharded checkpoint restored by the other bit for
bit (the two runs wait for each other's through a flag file), gradients
through ``method='sharded'`` against ``jax.grad`` within
``tol_for(float32, n)·κ₂(L~)``, and ``online_ridge``'s ``--sharded`` fleet
against the JAX example's rows. The ranks are started by
``repro_torch.runtime.compat.run_gloo_ranks``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytestmark = pytest.mark.slow

REPO = Path(__file__).resolve().parent.parent
N, K, PANEL, B = 32, 3, 8, 3
BF16_EPS = 2.0 ** -8
FP32_TOL = 50 * float(np.finfo(np.float32).eps) * N  # tol_for(float32, N)
COMBINED = ["data", "model"]
#: The store scenario: n, fleet size, width, panel.
SN, SB, SW, SP = 64, 3, 16, 16
#: Gradient cases: name, fleet, sigma.
GRADS = [("m4_up", False, 1), ("m4_down", False, -1),
         ("fleet_up", True, 1), ("fleet_down", True, -1)]

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

# Gradients through the sharded update (the custom_jvp's rule).
import jax


def phi(x):
    return jnp.sum(jnp.sin(x) * jnp.cos(0.5 * x))


for name, fleet, sigma in json.load(open(f"{d}/grads.json")):
    L = jnp.asarray(inp[("Ls" if fleet else "L") + ("_down" if sigma < 0
                                                    else "")])
    V = jnp.asarray(inp["Vs" if fleet else "V"])
    fn = chol_update_batched if fleet else chol_update
    with meshes["m4"]:
        gL, gV = jax.grad(lambda L, V: phi(fn(
            L, V, sigma=sigma, method="sharded", mesh=meshes["m4"],
            axis="model", panel=%(panel)d, interpret=True)),
            argnums=(0, 1))(L, V)
    out[f"grad_{name}_L"] = np.asarray(gL)
    out[f"grad_{name}_V"] = np.asarray(gV)

# tests/test_distributed.py's sharded fleet scenario.
import os, time
from pathlib import Path
from repro.kernels import sharded as sharded_k
from repro.stream import FactorStore, StreamService, mutations_issued
from repro.stream.durability import checkpoint_service, restore_service
from repro.stream.store import fleet_sharding

m4 = meshes["m4"]
rows = inp["store_rows"]
B, W, n = rows.shape
st = FactorStore(n, capacity=B, width=W, panel=%(spanel)d,
                 backend="sharded", mesh=m4, axis="model")
svc = StreamService(st, auto_flush=False)
bk, bm = sharded_k.launches_traced(), mutations_issued()
for u in range(B):
    for v in rows[u]:
        svc.push(u, v)
svc.flush()
out["store_launches1"] = sharded_k.launches_traced() - bk
out["store_muts1"] = mutations_issued() - bm
out["store_flush1"] = np.asarray(st.factor.data)
bk, bm = sharded_k.launches_traced(), mutations_issued()
for u in range(B):
    for v in rows[u][:4]:
        svc.push(u, (0.3 * v).astype(np.float32))
    for v in rows[u][:2]:
        svc.push(u, (0.1 * v).astype(np.float32), sign=-1)
rep2 = svc.flush(force=True)
out["store_launches2"] = sharded_k.launches_traced() - bk
out["store_muts2"] = mutations_issued() - bm
out["store_ok2"] = np.asarray([rep2.downdate_ok[u] for u in range(B)])
out["store_flush2"] = np.asarray(st.factor.data)
st.admit("x1"); st.admit("x2")
st.evict("x1"); st.evict("x2")
st.compact(min_capacity=B)
st.decay(0.9)
assert st.factor.data.sharding == fleet_sharding(m4, "model")
out["store_maint"] = np.asarray(st.factor.data)
svc.push(0, rows[0][0])                 # unflushed: seeds the log
checkpoint_service(svc, f"{d}/jax_ckpt", 1)
out["jax_ckpt_fleet"] = np.asarray(st.factor.data)
Path(f"{d}/jax_ckpt.ready").write_text("ok")
deadline = time.time() + 240
while not os.path.exists(f"{d}/port_ckpt.ready"):
    assert time.time() < deadline, "no checkpoint from the port"
    time.sleep(0.2)
svc2 = restore_service(f"{d}/port_ckpt")
f2 = svc2.store.factor
assert f2.backend == "sharded"
assert f2.data.sharding == fleet_sharding(f2.mesh, "model")
out["jax_restored_port"] = np.asarray(f2.data)
out["jax_restored_port_pending0"] = np.asarray(svc2.pending(0))

# The online_ridge example's fleet (its --sharded mode differs from
# --batched only in placement).
import contextlib, importlib.util, io
spec = importlib.util.spec_from_file_location(
    "jax_online_ridge", "%(examples)s/online_ridge.py")
ridge = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ridge)
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    ridge.run_batched()
out["ridge_text"] = np.asarray(buf.getvalue())
np.savez(f"{d}/jax.npz", **out)
""" % {"panel": PANEL, "spanel": SP, "examples": REPO / "examples"}


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
    store_rows = (0.2 * rng.normal(size=(SB, SW, SN))).astype(np.float32)
    return dict(L=L, V=V, L_down=_factor_plus(L, V), Ls=Ls, Vs=Vs,
                Ls_down=_factor_plus(Ls, Vs), Ls_guard=guard, V_bad=V_bad,
                store_rows=store_rows)


def _phi(x):
    return (x.sin() * (0.5 * x).cos()).sum()


def _wait_for(path, what, seconds=240.0):
    import time

    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        assert time.monotonic() < deadline, f"no {what}"
        time.sleep(0.2)


def _store_scenario(d, mesh, inp, out, rank):
    """``tests/test_distributed.py``'s fleet scenario on the four ranks,
    then the checkpoints: the port's own kill-and-restart and each
    package's restored by the other."""
    import torch

    from repro_torch.core import distributed
    from repro_torch.obs import metrics
    from repro_torch.stream import (FactorStore, StreamService,
                                    checkpoint_service, mutations_issued,
                                    restore_service)
    from repro_torch.stream.store import fleet_placement

    rows = inp["store_rows"].numpy()
    st = FactorStore(SN, capacity=SB, width=SW, panel=SP,
                     backend="sharded", mesh=mesh, axis="model")
    placed = fleet_placement(mesh, "model")[1]

    def kept():
        return list(st.factor.data.placements) == placed

    def walks():
        return metrics.value("repro.kernels.plain_walks", module="sharded")

    svc = StreamService(st, auto_flush=False)
    w0, m0 = walks(), mutations_issued()
    for u in range(SB):
        for v in rows[u]:
            svc.push(u, v)
    svc.flush()
    out["store_walks1"] = walks() - w0
    out["store_muts1"] = mutations_issued() - m0
    out["store_flush1"] = distributed.gather(st.factor.data).numpy()
    w0, m0 = walks(), mutations_issued()
    for u in range(SB):
        for v in rows[u][:4]:
            svc.push(u, (0.3 * v).astype(np.float32))
        for v in rows[u][:2]:
            svc.push(u, (0.1 * v).astype(np.float32), sign=-1)
    rep2 = svc.flush(force=True)
    out["store_walks2"] = walks() - w0
    out["store_muts2"] = mutations_issued() - m0
    out["store_ok2"] = np.asarray([rep2.downdate_ok[u] for u in range(SB)])
    out["store_flush2"] = distributed.gather(st.factor.data).numpy()
    placements = [kept()]
    st.admit("x1")
    st.admit("x2")               # 3 -> 6
    placements.append(kept() and st.capacity == 6)
    st.evict("x1")
    st.evict("x2")
    st.compact(min_capacity=SB)
    placements.append(kept() and st.capacity == SB)
    st.decay(0.9)
    placements.append(kept())
    out["store_placements"] = np.asarray(placements)
    out["store_maint"] = distributed.gather(st.factor.data).numpy()
    svc.push(0, rows[0][0])                 # unflushed: seeds the log
    checkpoint_service(svc, f"{d}/port_ckpt", 1)
    out["port_ckpt_fleet"] = distributed.gather(st.factor.data).numpy()
    if rank == 0:
        Path(f"{d}/port_ckpt.ready").write_text("ok")
    # Kill-and-restart within the port: the log's tail replays.
    checkpoint_service(svc, f"{d}/own_ckpt", 1)
    svc.push(1, rows[1][1])
    svc.flush(force=True)
    want = distributed.gather(st.factor.data)
    own = restore_service(f"{d}/own_ckpt", device="cpu")
    f2 = own.store.factor
    out["own_restart"] = np.asarray([
        torch.equal(distributed.gather(f2.data), want),
        f2.backend == "sharded",
        list(f2.data.placements) == placed,
        own.pending(0) == svc.pending(0),
        own.store.step_mode == "eager"])
    # The JAX package's checkpoint.
    _wait_for(f"{d}/jax_ckpt.ready", "checkpoint from the JAX package")
    theirs = restore_service(f"{d}/jax_ckpt", device="cpu")
    out["port_restored_jax"] = distributed.gather(
        theirs.store.factor.data).numpy()
    out["port_restored_jax_pending0"] = np.asarray(theirs.pending(0))


def _gradients(mesh, inp, out):
    """Reverse mode through ``method='sharded'``, the loss on each rank's
    own columns (their sum is the whole loss)."""
    from repro_torch.core import api

    for name, fleet, sigma in GRADS:
        L = inp[("Ls" if fleet else "L") + ("_down" if sigma < 0
                                            else "")].clone()
        V = inp["Vs" if fleet else "V"].clone()
        L.requires_grad_(True)
        V.requires_grad_(True)
        fn = api.chol_update_batched if fleet else api.chol_update
        r = fn(L, V, sigma=sigma, method="sharded", mesh=mesh, axis="model",
               panel=PANEL)
        _phi(r.to_local()).backward()
        out[f"grad_{name}_L"] = L.grad.numpy()
        out[f"grad_{name}_V"] = V.grad.numpy()


def _rank_main(d):
    """One gloo rank (``run_gloo_ranks``): every case through the port's
    entry points, the results gathered whole; rank 0 saves them."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import CholFactor, api, distributed
    from repro_torch.examples import online_ridge
    from repro_torch.obs import metrics

    torch.set_num_threads(1)
    rank = dist.get_rank()
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
    _gradients(meshes["m4"], inp, out)
    _store_scenario(d, meshes["m4"], inp, out, rank)
    ridge, muts = online_ridge.run_batched(sharded=True, device="cpu")
    out["ridge_rows"] = np.asarray(ridge)
    out["ridge_muts"] = np.asarray(muts)
    if rank == 0:
        np.savez(f"{d}/port.npz", **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_multi")
    inputs = make_inputs()
    np.savez(d / "inputs.npz", **inputs)
    (d / "cases.json").write_text(json.dumps(CASES))
    (d / "grads.json").write_text(json.dumps(GRADS))
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=4").strip()
    env["PYTHONPATH"] = f"{REPO / 'src'}:{env.get('PYTHONPATH', '')}"
    env["JAX_PLATFORMS"] = "cpu"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_SCRIPT), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
    from repro_torch.runtime.compat import run_gloo_ranks

    failed = None
    try:
        try:
            run_gloo_ranks(4, _rank_main, (str(d),), timeout=300)
        except RuntimeError as exc:
            failed = exc
        log, _ = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert failed is None, failed
    assert jax_proc.returncode == 0, log
    ours = dict(np.load(d / "port.npz"))
    for name in ("jax_ckpt", "port_ckpt"):
        meta = json.loads((d / name / "step_00000001" / "tree.json")
                          .read_text())
        ours[f"{name}_mesh"] = json.dumps(meta["extra"]["stream"]["mesh"])
    return inputs, dict(np.load(d / "jax.npz")), ours


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


def test_four_rank_store_matches_jax(runs):
    """The sharded fleet scenario: fleets within tol_for(float32, n), one
    batched mutation and one panel-phase walk per shard per sign block
    (JAX: one traced launch), verdicts equal, the placement kept."""
    _, theirs, ours = runs
    tol = 50 * float(np.finfo(np.float32).eps) * SN
    for key in ("store_flush1", "store_flush2", "store_maint"):
        assert ours[key].shape == theirs[key].shape == (SB, SN, SN), key
        np.testing.assert_allclose(ours[key], theirs[key], rtol=0, atol=tol,
                                   err_msg=key)
    assert int(ours["store_muts1"]) == int(theirs["store_muts1"]) == 1
    assert int(ours["store_walks1"]) == int(theirs["store_launches1"]) == 1
    assert int(ours["store_muts2"]) == int(theirs["store_muts2"]) == 2
    assert int(ours["store_walks2"]) == int(theirs["store_launches2"]) == 2
    assert ours["store_ok2"].tolist() == theirs["store_ok2"].tolist() == [
        True] * SB
    assert ours["store_placements"].all()


def test_four_rank_checkpoints_cross_packages_bitwise(runs):
    """Each package restores the other's sharded checkpoint bit for bit
    (its unflushed row re-buffered), and the port's own kill-and-restart
    replays its log's tail to the live fleet bit for bit."""
    _, theirs, ours = runs
    np.testing.assert_array_equal(ours["port_restored_jax"],
                                  theirs["jax_ckpt_fleet"])
    np.testing.assert_array_equal(theirs["jax_restored_port"],
                                  ours["port_ckpt_fleet"])
    assert int(ours["port_restored_jax_pending0"]) == 1
    assert int(theirs["jax_restored_port_pending0"]) == 1
    assert ours["own_restart"].all(), ours["own_restart"]


def test_four_rank_mesh_records_are_jaxs(runs):
    """The two packages' checkpoints of the same fleet carry the same mesh
    record, byte for byte."""
    ours = runs[2]
    assert ours["jax_ckpt_mesh"] == ours["port_ckpt_mesh"] == json.dumps(
        {"axes": ["model"], "shape": [4], "axis": "model"})


def _kappa2(U):
    U = np.asarray(U, np.float64)
    lam = np.linalg.eigvalsh(U.swapaxes(-1, -2) @ U)
    return float(np.sqrt(lam[..., -1] / lam[..., 0]).max())


@pytest.mark.parametrize("case", GRADS, ids=[g[0] for g in GRADS])
def test_four_rank_gradients_match_jax_grad(runs, case):
    """``method='sharded'`` gradients on four ranks against ``jax.grad``
    through the JAX package's sharded update, within tol_for(float32, n)
    times kappa_2 of the updated factor, relative to the largest
    entry."""
    inputs, theirs, ours = runs
    name, fleet, sigma = case
    L = inputs[("Ls" if fleet else "L") + ("_down" if sigma < 0 else "")]
    V = inputs["Vs" if fleet else "V"]
    A = L.astype(np.float64).swapaxes(-1, -2) @ L + sigma * (
        V.astype(np.float64) @ V.swapaxes(-1, -2))
    kappa = _kappa2(np.linalg.cholesky(A).swapaxes(-1, -2))
    for part in ("L", "V"):
        ours_g, jax_g = ours[f"grad_{name}_{part}"], theirs[
            f"grad_{name}_{part}"]
        assert ours_g.shape == jax_g.shape
        scale = np.abs(jax_g).max()
        np.testing.assert_allclose(ours_g, jax_g, rtol=0,
                                   atol=FP32_TOL * kappa * scale,
                                   err_msg=part)


def test_online_ridge_sharded_four_ranks_matches_jax(runs):
    """``online_ridge``'s fleet sharded over the four ranks against the
    rows the JAX example prints (its values within their printed precision
    widened by both runs' own error, as in
    ``tests/test_torch_examples.py``)."""
    _, theirs, ours = runs
    text = str(theirs["ridge_text"])
    want = [(int(p[0]), float(p[1]), float(p[2]))
            for p in (line.split() for line in text.splitlines())
            if len(p) == 3 and p[0].isdigit()]
    got = [tuple(r) for r in ours["ridge_rows"]]
    assert [int(r[0]) for r in got] == [r[0] for r in want] == [1, 3, 5, 7]
    assert int(ours["ridge_muts"]) == 6
    assert "absorbed in 6 batched mutations" in text
    true_w = np.random.default_rng(0).normal(size=(4, 64))
    scale = np.sqrt(64) / np.linalg.norm(true_w, axis=1).min()
    for (_, e, w), (_, ej, wj) in zip(got, want):
        assert e < 5e-3 and ej < 5e-3
        assert abs(w - wj) <= 1e-4 + scale * (e + ej)
