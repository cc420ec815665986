"""Checkpoint + replay-log durability of the port's stream stack, and the
checkpoint format it shares with the JAX package, on the CPU.

A checkpoint directory written by either package is one state for both:
the JAX service's checkpoint and WAL restore into the port's service and
the port's into the JAX one, and both then take the same traffic and agree
within ``tol_for(float32, n)``. The port alone: a kill-and-restart replays
its WAL to the live fleet bit for bit, a bf16 fleet round-trips through its
checkpoint (bfloat16 bytes read through torch, not ``ml_dtypes``), and the
sharded placement's records raise.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import stream as jstream
from repro_torch import checkpoint as tckpt
from repro_torch import stream as tstream
from tests.strategies import tol_for
from tests.test_torch_stream import (BLOCK, N, assert_fleets_close, drive,
                                     fleet, rows, traffic)


def service(pkg, structure, *, precision=None):
    """One service of ``pkg``; the port's steps walk its kernels' plain
    versions, and its records name backends the JAX package also runs on
    the CPU (``interpret=True``: the Pallas kernels' interpret mode)."""
    kw = dict(capacity=2, ladder=(2, 4), width=3, panel=4, interpret=True,
              precision=precision)
    if structure == "blocktridiag":
        kw.update(structure="blocktridiag", block=BLOCK,
                  backend="blocktridiag")
    else:
        kw.update(backend="fused")
    if pkg is tstream:
        kw["device"] = "cpu"
    return pkg.StreamService(pkg.FactorStore(N, **kw), window=4, deadline=2)


def restore(pkg, path, **kw):
    if pkg is tstream:
        kw.setdefault("device", "cpu")
    return pkg.restore_service(path, **kw)


@pytest.mark.parametrize("structure", ["dense", "blocktridiag"])
@pytest.mark.parametrize("writer,reader", [(jstream, tstream),
                                           (tstream, jstream)],
                         ids=["jax-to-torch", "torch-to-jax"])
def test_checkpoint_restores_across_packages(tmp_path, writer, reader,
                                             structure):
    block = BLOCK if structure == "blocktridiag" else None
    ops = traffic(block)
    cut = len(ops) // 2
    live = service(writer, structure)
    drive(live, ops[:cut])
    extra = rows(N, 2, seed=31, block=block)
    live.push("a", extra[0])                  # buffered: in the seeded WAL
    writer.checkpoint_service(live, tmp_path, step=1)
    live.push("b", extra[1])                  # after the checkpoint
    survivor = restore(reader, tmp_path)
    assert survivor.store.structure == live.store.structure
    assert survivor.store.slot_to_user == live.store.slot_to_user
    assert survivor.store.empty_slots == live.store.empty_slots
    assert survivor.tick_count == live.tick_count
    assert survivor.scheduled() == live.scheduled()
    assert survivor.pending("a") == live.pending("a") == 1
    assert survivor.pending("b") == live.pending("b")
    assert_fleets_close(live.store, survivor.store, 0.0)
    assert drive(live, ops[cut:]) == drive(survivor, ops[cut:])
    assert_fleets_close(live.store, survivor.store, tol_for(np.float32, N))


@pytest.mark.parametrize("structure", ["dense", "blocktridiag"])
def test_kill_and_restart_replays_to_the_live_fleet_bitwise(tmp_path,
                                                            structure):
    ops = traffic(BLOCK if structure == "blocktridiag" else None)
    live = service(tstream, structure)
    drive(live, ops[:15])
    tstream.checkpoint_service(live, tmp_path, step=1)
    drive(live, ops[15:40])               # WAL only: replayed at restore
    survivor = restore(tstream, tmp_path, warm=True)
    for a, b in zip(fleet(live.store), fleet(survivor.store)):
        np.testing.assert_array_equal(a, b)
    assert drive(live, ops[40:]) == drive(survivor, ops[40:])
    for a, b in zip(fleet(live.store), fleet(survivor.store)):
        np.testing.assert_array_equal(a, b)


def test_bf16_fleet_round_trips_through_the_port_checkpoint(tmp_path):
    live = service(tstream, "dense", precision="bf16")
    drive(live, traffic()[:25])
    assert live.store.factor.dtype == torch.bfloat16
    tstream.checkpoint_service(live, tmp_path, step=3)
    meta = tckpt.read_meta(tmp_path, 3)
    assert [leaf["dtype"] for leaf in meta["leaves"]] == ["bfloat16"]
    assert meta["extra"]["stream"]["dtype"] == "bfloat16"
    assert meta["extra"]["stream"]["precision"] == {
        "storage": "bfloat16", "accum": "float32"}
    survivor = restore(tstream, tmp_path)
    assert survivor.store.factor.dtype == torch.bfloat16
    assert torch.equal(survivor.store.factor.data, live.store.factor.data)
    # The JAX package reads the same bytes (through ml_dtypes on its side).
    theirs = jckpt.restore(tmp_path, 3, {"fleet": np.zeros(1)})["fleet"]
    np.testing.assert_array_equal(
        np.asarray(theirs, np.float32),
        live.store.factor.data.float().numpy())
    # The port alone, in a process with neither JAX nor ml_dtypes.
    code = (
        "import sys, torch\n"
        "from repro_torch import stream\n"
        f"svc = stream.restore_service({str(tmp_path)!r}, device='cpu')\n"
        "assert svc.store.factor.dtype == torch.bfloat16\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'ml_dtypes', 'repro')]\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(os.path.dirname(__file__)), "src"),
         os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_checkpoint_leaves_and_names_match_jax(tmp_path):
    """The port's checkpoint of named tensors uses the JAX package's leaf
    names (a ``BlockTriDiagStorage`` as ``name/0``, ``name/1``), dtype
    names and step directories, and each package reads the other's."""
    from repro_torch.core.structure import BlockTriDiagStorage

    d = torch.arange(2 * 3 * 2 * 2, dtype=torch.float32).reshape(2, 3, 2, 2)
    o = -torch.arange(2 * 2 * 2 * 2, dtype=torch.float64).reshape(2, 2, 2, 2)
    tree = {"w": torch.ones(3), "fleet": BlockTriDiagStorage(d, o.float())}
    tckpt.save(tmp_path / "t", 7, tree, extra={"k": 1})
    meta = json.loads((tmp_path / "t" / "step_00000007" / "tree.json")
                      .read_text())
    assert [leaf["name"] for leaf in meta["leaves"]] == [
        "fleet/0", "fleet/1", "w"]
    back = tckpt.restore(tmp_path / "t", 7, {"w": torch.Tensor,
                                             "fleet": BlockTriDiagStorage})
    assert torch.equal(back["fleet"].diag, d) and torch.equal(back["w"],
                                                              tree["w"])
    from repro.core.structure import BlockTriDiagStorage as JStorage

    like = {"w": np.zeros(3), "fleet": JStorage(np.zeros((2, 3, 2, 2)),
                                                np.zeros((2, 2, 2, 2)))}
    theirs = jckpt.restore(tmp_path / "t", 7, like)
    np.testing.assert_array_equal(np.asarray(theirs["fleet"].diag), d)
    jckpt.save(tmp_path / "j", 2, {"a": np.arange(4.0)}, keep=1)
    jckpt.save(tmp_path / "j", 5, {"a": np.arange(4.0)}, keep=1)
    assert tckpt.all_steps(tmp_path / "j") == jckpt.all_steps(
        tmp_path / "j") == [5]
    assert tckpt.latest_step(tmp_path / "j") == 5
    got = tckpt.restore(tmp_path / "j", 5, {"a": torch.Tensor})["a"]
    assert got.dtype == torch.float64 and got.tolist() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="missing"):
        tckpt.restore(tmp_path / "j", 5, {"b": torch.Tensor})
    with pytest.raises(FileNotFoundError):
        tckpt.read_meta(tmp_path / "j", 2)
    assert tckpt.torch_dtype_for("bfloat16") == torch.bfloat16


def test_wal_segments_rotate_and_prune_like_jax(tmp_path):
    files = []
    for pkg in (jstream, tstream):
        d = tmp_path / pkg.__name__
        svc = service(pkg, "dense")
        for step in (1, 2, 2, 3):
            drive(svc, traffic()[:4])
            pkg.checkpoint_service(svc, d, step=step, keep=2)
        files.append(sorted(p.name for p in d.iterdir()))
        recs = tstream.ReplayLog.read(d / sorted(
            p.name for p in d.glob("wal_*"))[-1])
        assert {r["op"] for r in recs} <= {"buffer", "sched"}
    assert files[0] == files[1]


def test_sharded_records_restore_like_jax(tmp_path):
    """Both packages refuse a ``mesh=`` override for an unsharded
    checkpoint with the same message, and both fail loudly on a mesh
    record of four ranks in a process that has no such mesh (one device
    for JAX, no four-rank process group here) instead of restoring the
    fleet whole. The restores that succeed are in
    ``tests/test_torch_stream_sharded.py`` (one rank) and
    ``tests/test_torch_sharded_multi.py`` (four ranks, across packages)."""
    for pkg in (jstream, tstream):
        d = tmp_path / pkg.__name__
        svc = service(pkg, "dense")
        drive(svc, traffic()[:6])
        pkg.checkpoint_service(svc, d, step=1)
        with pytest.raises(ValueError, match="carries no sharded-fleet"):
            restore(pkg, d, mesh=object())
        meta_path = d / "step_00000001" / "tree.json"
        meta = json.loads(meta_path.read_text())
        assert meta["extra"]["stream"]["mesh"] is None
        meta["extra"]["stream"]["mesh"] = {"axes": ["model"], "shape": [4],
                                           "axis": "model"}
        meta_path.write_text(json.dumps(meta))
        with pytest.raises((ValueError, RuntimeError)):
            restore(pkg, d)


def test_row_codec_round_trips_like_jax():
    for dt in (np.float32, np.float64):
        v = np.random.default_rng(0).normal(size=5).astype(dt)
        rec = tstream.encode_row(v)
        assert rec == jstream.encode_row(v)
        np.testing.assert_array_equal(tstream.decode_row(rec), v)
        np.testing.assert_array_equal(jstream.decode_row(rec), v)
