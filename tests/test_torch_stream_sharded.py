"""The stream store's sharded placement on one gloo rank, in process.

``FactorStore(backend='sharded', mesh=)`` over a one-rank CPU mesh against
the JAX package's stream stack on the same numpy traffic: the service
sequence (``FlushReport`` fields equal, fleets within
``tol_for(float32, n)``), the constructor's checks, a reused slot starting
fresh, warmup covering the 2 -> 4 rung crossing with no build after it,
the guarded step's verdicts against ``CholFactor.downdate_guarded``, the
checkpoint's mesh record (the JAX package's JSON byte for byte) and its
restore, the background worker's refusal over several ranks, and
gradients through ``method='sharded'`` against the dense rule. The
process group meets at a ``file://`` store in a temporary directory
(never a TCP port) and is destroyed by the fixture. The four-rank cases
are in ``tests/test_torch_sharded_multi.py``.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from repro import stream as jstream
from repro.core.factor import CholFactor as JFactor
from repro.runtime.compat import make_mesh_compat as jmake_mesh
from repro.stream import durability as jdur
from repro_torch import stream as tstream
from repro_torch.core import CholFactor, api, distributed
from repro_torch.runtime.compat import make_mesh_compat
from repro_torch.stream import durability as tdur
from repro_torch.stream import store as tstore
from tests.strategies import tol_for
from tests.test_torch_stream import N, WIDTH, drive, rows, traffic


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    store = tmp_path_factory.mktemp("stream_sharded") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
    finally:
        dist.destroy_process_group()


def sharded_store(mesh, *, ladder=(2, 4), width=WIDTH, **kw):
    return tstream.FactorStore(N, capacity=ladder[0], ladder=ladder,
                               width=width, panel=4, backend="sharded",
                               mesh=mesh, **kw)


def whole(store):
    """The gathered fleet, float32 numpy."""
    return distributed.gather(store.factor.data).float().numpy()


def jax_fleet(store):
    return np.asarray(store.factor.data, np.float32)


def test_constructor_checks_on_a_real_mesh(mesh):
    with pytest.raises(ValueError, match="requires backend='sharded'"):
        tstream.FactorStore(N, mesh=mesh, backend="fused")
    with pytest.raises(tstore.UnsupportedStorageError, match="compose"):
        tstream.FactorStore(N, mesh=mesh, backend="sharded",
                            structure="blocktridiag", block=2)
    st = sharded_store(mesh)
    assert st.sharded and st.ranks == 1 and st.step_mode == "eager"
    assert st.device == torch.device("cpu")
    data = st.factor.data
    assert distributed.is_sharded(data)
    assert (data.device_mesh, list(data.placements)) == (
        tstore.fleet_placement(mesh, "model")[0],
        tstore.fleet_placement(mesh, "model")[1])
    np.testing.assert_array_equal(whole(st), np.broadcast_to(
        np.eye(N, dtype=np.float32), (2, N, N)))


def test_service_sequence_matches_jax(mesh):
    """The traffic of ``tests/test_torch_stream.py`` (window, deadline,
    rung crossing, decay, eviction and readmission, a refused downdate)
    through a one-rank sharded store and the JAX package's reference
    store: the same reports, fleets within tol_for(float32, n), the
    placement kept throughout."""
    js = jstream.StreamService(
        jstream.FactorStore(N, capacity=2, ladder=(2, 4), width=WIDTH,
                            panel=4, backend="reference"),
        window=4, deadline=2)
    ts = tstream.StreamService(sharded_store(mesh), window=4, deadline=2)
    ops = traffic()
    assert drive(js, ops) == drive(ts, ops)
    np.testing.assert_allclose(whole(ts.store), jax_fleet(js.store),
                               rtol=0, atol=tol_for(np.float32, N))
    data = ts.store.factor.data
    assert ts.store.capacity == 4
    assert list(data.placements) == tstore.fleet_placement(mesh,
                                                           "model")[1]
    ts.store.compact(min_capacity=2)
    js.store.compact(min_capacity=2)
    assert ts.store.capacity == js.store.capacity
    np.testing.assert_allclose(whole(ts.store), jax_fleet(js.store),
                               rtol=0, atol=tol_for(np.float32, N))


def test_reused_slot_starts_fresh(mesh):
    st = sharded_store(mesh, init_scale=2.0)
    svc = tstream.StreamService(st, auto_flush=False)
    svc.admit("a")
    for v in rows(N, 3, seed=3):
        svc.push("a", v)
    svc.flush(force=True)
    s = st.slot("a")
    assert not np.array_equal(whole(st)[s], np.sqrt(np.float32(2.0))
                              * np.eye(N, dtype=np.float32))
    svc.evict("a")
    assert svc.admit("b") == s
    np.testing.assert_array_equal(
        whole(st)[s], np.sqrt(np.float32(2.0)) * np.eye(N, dtype=np.float32))
    member = st.factor_for("b")
    assert distributed.is_sharded(member.data)
    np.testing.assert_array_equal(distributed.gather(member.data).numpy(),
                                  whole(st)[s])


def test_warmup_covers_the_rung_crossing(mesh):
    st = sharded_store(mesh)
    rep = st.warmup()
    assert rep.compiled == st.steps.executables and rep.graphs == 0
    svc = tstream.StreamService(st, window=4, deadline=2)
    with tstream.assert_no_retrace("sharded serving across 2 -> 4"):
        drive(svc, traffic())
    assert st.capacity == 4 and st.steps.cold_dispatches == 0


def test_guarded_step_verdicts_equal_downdate_guarded(mesh):
    st = sharded_store(mesh, width=2, widths=(2,))
    for u in "abcd":
        st.admit(u)  # 2 -> 4
    up = np.stack([np.stack(rows(N, 2, seed=20 + i), axis=1)
                   for i in range(4)])
    dn = 0.1 * up
    dn[2] *= 40.0  # member 2 leaves the PD cone
    pre = CholFactor(distributed.gather(st.factor.data).clone(),
                     panel=4, backend="sharded", mesh=mesh)
    ok = st.apply(up, dn)
    want, ok_e = pre.update(torch.from_numpy(up)).downdate_guarded(
        torch.from_numpy(dn))
    assert ok.tolist() == ok_e.tolist() == [True, True, False, True]
    assert torch.equal(distributed.gather(st.factor.data),
                       distributed.gather(want.data))


def test_mesh_record_is_jaxs_json(mesh, tmp_path):
    """The checkpoint's mesh record equals the JAX package's byte for
    byte, for a one-dim and a two-dim mesh with a tuple axis."""
    L = np.eye(4, dtype=np.float32)
    mesh2 = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                             "model"))
    for tm, jm, axis in ((mesh, jmake_mesh((1,), ("model",)), "model"),
                         (mesh2, jmake_mesh((1, 1), ("data", "model")),
                          ("data", "model"))):
        t = tdur._mesh_to_json(CholFactor(torch.from_numpy(L),
                                          backend="sharded", mesh=tm,
                                          axis=axis))
        j = jdur._mesh_to_json(JFactor(L, backend="sharded", mesh=jm,
                                       axis=axis))
        assert json.dumps(t) == json.dumps(j)
    assert tdur._mesh_to_json(CholFactor(torch.from_numpy(L))) is None


def test_checkpoint_restore_rebuilds_the_mesh(mesh, tmp_path):
    svc = tstream.StreamService(sharded_store(mesh), window=4, deadline=2)
    ops = traffic()
    drive(svc, ops[:20])
    tstream.checkpoint_service(svc, tmp_path, step=1)
    meta = json.loads((tmp_path / "step_00000001" / "tree.json").read_text())
    assert meta["extra"]["stream"]["mesh"] == {
        "axes": ["model"], "shape": [1], "axis": "model"}
    drive(svc, ops[20:30])  # the log's tail
    back = tstream.restore_service(tmp_path, device="cpu")
    f = back.store.factor
    assert f.backend == "sharded" and back.store.sharded
    assert tuple(f.mesh.mesh_dim_names) == ("model",)
    assert distributed.is_sharded(f.data)
    np.testing.assert_array_equal(whole(back.store), whole(svc.store))
    assert back.store.slot_to_user == svc.store.slot_to_user
    assert all(back.pending(u) == svc.pending(u) for u in svc.users())
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh_compat((4,), ("model",), device_type="cpu")
    again = tstream.restore_service(tmp_path, mesh=mesh, device="cpu")
    np.testing.assert_array_equal(whole(again.store), whole(svc.store))


def test_background_worker_refused_over_several_ranks(mesh, monkeypatch):
    svc = tstream.StreamService(sharded_store(mesh))
    svc.start_background()  # one rank: allowed
    svc.stop_background()
    monkeypatch.setattr(tstore.FactorStore, "ranks", property(lambda s: 4))
    with pytest.raises(RuntimeError, match="diverge"):
        svc.start_background()
    assert not svc.background_active


@pytest.mark.parametrize("sigma", [1, -1], ids=["update", "downdate"])
def test_fleet_gradients_match_the_dense_rule(mesh, sigma):
    """Reverse mode through ``method='sharded'`` on a B = 3 fleet, ``L``
    whole and as a ``DTensor``: L-bar in L's layout, V-bar whole, both
    against the fused path's rule; forward mode returns the result whole
    with its tangent."""
    rng = np.random.default_rng(5)
    B, n, k = 3, N, 2
    Bm = rng.uniform(size=(B, n, n))
    V0 = rng.uniform(size=(B, n, k))
    A = Bm.swapaxes(-1, -2) @ Bm + np.eye(n)
    if sigma < 0:
        A = A + V0 @ V0.swapaxes(-1, -2)
    L0 = torch.from_numpy(np.linalg.cholesky(A).swapaxes(-1, -2).copy()
                          ).float()
    V0 = torch.from_numpy(V0).float()

    def grads(method, sharded_in=False):
        L = L0.clone()
        if sharded_in:
            L = distributed.shard(L, mesh)
        L.requires_grad_(True)
        V = V0.clone().requires_grad_(True)
        kw = {"mesh": mesh, "panel": 4} if method == "sharded" else {}
        out = api.chol_update_batched(L, V, sigma=sigma, method=method, **kw)
        loc = out.to_local() if distributed.is_sharded(out) else out
        (loc.sin() * (0.5 * loc).cos()).sum().backward()
        return L.grad, V.grad

    ref = grads("fused")
    tol = tol_for(np.float32, n) * 10.0
    for sharded_in in (False, True):
        gL, gV = grads("sharded", sharded_in)
        assert distributed.is_sharded(gL) == sharded_in
        torch.testing.assert_close(distributed.gather(gL), ref[0], rtol=0,
                                   atol=tol)
        torch.testing.assert_close(gV, ref[1], rtol=0, atol=tol)
    import torch.autograd.forward_ad as fwad

    dL, dV = torch.triu(torch.ones_like(L0)), torch.ones_like(V0)
    tangents = []
    for method, kw in (("sharded", {"mesh": mesh, "panel": 4}),
                       ("fused", {})):
        with fwad.dual_level():
            out = api.chol_update_batched(
                fwad.make_dual(L0, dL), fwad.make_dual(V0, dV), sigma=sigma,
                method=method, **kw)
            tangents.append(fwad.unpack_dual(out).tangent)
    torch.testing.assert_close(tangents[0], tangents[1], rtol=0, atol=tol)
