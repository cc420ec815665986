"""Durability for the streaming service: fleet checkpoints + replay log.

Port of ``repro.stream.durability``, in the JAX package's formats: the same
checkpoint layout (``repro_torch.checkpoint``), the same ``extra["stream"]``
meta and the same JSONL records, so a checkpoint directory written by
either package is one state for both — the JAX package's checkpoint and
replay log, restored here, give the port's fleet, and back.

* **Checkpoint** — ``checkpoint_service`` writes the fleet (the live
  rung's members) with the factor's execution metadata and the
  service/slot state in the checkpoint's ``extra`` meta.
* **Replay log (WAL)** — every state-changing service call appends one
  JSONL record to ``wal_<step>_<attempt>.jsonl``. The log is rotated at
  checkpoint time and *seeded* with the then-unflushed buffer contents and
  the pending window-downdate schedule, so the log alone carries
  everything the checkpoint's arrays do not.

``restore_service`` = load the newest committed checkpoint, rebuild the
store/service around its meta, then replay the WAL: buffered rows are
re-buffered and logged ``flush`` events re-issue the identical mutation
sequence.

A sharded fleet (``FactorStore(backend='sharded', mesh=)``) is checkpointed
whole, with its mesh record in the JAX package's JSON (axis names, sizes,
the column axis): ``checkpoint_service`` gathers the fleet (a collective:
every rank calls it), the rank at the mesh's origin writes the checkpoint
and the replay log, and the others wait at a barrier and log nothing.
``restore_service`` rebuilds the mesh from the record
(``runtime.compat.make_mesh_compat``) or takes ``mesh=``, each rank keeps
its columns, and every rank replays the log.
"""
from __future__ import annotations

import base64
import json
import os
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.core import CholFactor
from repro_torch.core import distributed as _distributed
from repro_torch.core.precision import Precision
from repro_torch.core.structure import BlockTriDiagStorage
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.stream.coalescer import Coalescer
from repro_torch.stream.service import StreamService
from repro_torch.stream.store import FactorStore

# Rows are float32/float64 host arrays: numpy parses their dtype names.
_np_dtype = ckpt.np_dtype_for


# -- row codec ---------------------------------------------------------------


def encode_row(v: np.ndarray) -> dict:
    arr = np.ascontiguousarray(np.asarray(v))
    return {"v": base64.b64encode(arr.tobytes()).decode("ascii"),
            "dtype": str(arr.dtype), "shape": list(arr.shape)}


def decode_row(rec: dict) -> np.ndarray:
    raw = base64.b64decode(rec["v"])
    return np.frombuffer(raw, dtype=_np_dtype(rec["dtype"])).reshape(
        rec["shape"]).copy()


def _precision_to_json(p: Optional[Precision]):
    if p is None:
        return None
    return {"storage": None if p.storage is None
            else ckpt.dtype_name(p.storage),
            "accum": ckpt.dtype_name(p.accum)}


def _precision_from_json(d) -> Optional[Precision]:
    if d is None:
        return None
    return Precision(storage=d["storage"], accum=d["accum"])


# -- mesh codec (sharded fleets) ---------------------------------------------
#
# A DeviceMesh holds live process groups, so the checkpoint records what
# determines it (dim names and sizes, the column axis) in the JAX package's
# JSON, and restore rebuilds an equivalent mesh over the restoring
# process group. A restore onto another rank count fails loudly in
# make_mesh_compat unless mesh= gives the new layout.


def _mesh_to_json(factor) -> Optional[dict]:
    if factor.backend != "sharded" or factor.mesh is None:
        return None
    mesh = factor.mesh
    axis = factor.axis
    names = tuple(mesh.mesh_dim_names)
    return {
        "axes": [str(a) for a in names],
        "shape": [int(mesh.size(i)) for i in range(len(names))],
        "axis": axis if isinstance(axis, str) else list(axis),
    }


def _mesh_from_json(d, *, mesh=None, device=None):
    """(mesh, axis) from checkpoint meta; ``mesh=`` overrides (a restore
    onto another layout). ``device``: the ranks' device type when the
    mesh is rebuilt (default CUDA)."""
    if d is None:
        if mesh is not None:
            # Dropping the override silently would hand back a whole store
            # the caller believes is sharded.
            raise ValueError(
                "mesh= override given, but the checkpoint carries no "
                "sharded-fleet record (unsharded fleet, or saved before "
                "the sharded placement)")
        return None, "model"
    axis = d["axis"] if isinstance(d["axis"], str) else tuple(d["axis"])
    if mesh is None:
        from repro_torch.core.api import default_device
        from repro_torch.runtime.compat import make_mesh_compat

        mesh = make_mesh_compat(tuple(d["shape"]), tuple(d["axes"]),
                                device_type=default_device(device).type)
    return mesh, axis


def _writes(store) -> bool:
    """True on the rank that writes a store's checkpoint and replay log:
    every rank of an unsharded store, the mesh's origin of a sharded one."""
    if not store.sharded:
        return True
    coord = store._mesh.get_coordinate()
    return coord is not None and not any(coord)


def _mesh_barrier(store) -> None:
    """Every rank of a sharded store's mesh waits for the others (one
    barrier per mesh dim of more than one rank, in order)."""
    if not store.sharded:
        return
    import torch.distributed as dist

    mesh = store._mesh
    for d in range(mesh.ndim):
        if mesh.size(d) > 1:
            dist.barrier(group=mesh.get_group(d))


# -- the write-ahead log -----------------------------------------------------


class ReplayLog:
    """Append-only JSONL event log (one record per state-changing call)."""

    def __init__(self, path, *, truncate: bool = False):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = self.path.open("w" if truncate else "a")

    def append(self, record: dict) -> None:
        line = json.dumps(record) + "\n"
        self._fh.write(line)
        # Flush through to the OS per record: a crashed *process* loses
        # nothing (fsync-per-record durability against power loss is the
        # operator's trade to make; the serving-loop default is flush).
        self._fh.flush()
        obs_metrics.counter("repro.stream.wal_records",
                            op=record.get("op", "seed")).inc()
        obs_metrics.counter("repro.stream.wal_bytes").inc(len(line))

    def close(self) -> None:
        self._fh.close()

    @staticmethod
    def read(path) -> list:
        path = Path(path)
        if not path.exists():
            return []
        records = []
        for line in path.open():
            line = line.strip()
            if line:
                records.append(json.loads(line))
        return records


# -- checkpoint / restore ----------------------------------------------------

# One WAL segment per checkpoint ATTEMPT: wal_<step>_<attempt>.jsonl. The
# committed checkpoint's meta records which segment it pairs with, so the
# two-file commit is effectively atomic — the WAL is written in full
# first, and only the (atomic) checkpoint commit publishes it. Re-using a
# step number therefore never truncates the previously committed step's
# segment; a crash mid-attempt leaves an orphan the next _prune_wals
# collects.
_WAL_FMT = "wal_{step:08d}_{attempt}.jsonl"


def _next_wal_path(ckpt_dir, step: int) -> Path:
    # max(existing)+1, NOT a count: pruning earlier attempts must never
    # make a new attempt collide with (and truncate) the still-referenced
    # committed segment.
    attempts = []
    for p in Path(ckpt_dir).glob(f"wal_{step:08d}_*.jsonl"):
        try:
            attempts.append(int(p.stem.rsplit("_", 1)[1]))
        except ValueError:
            continue
    attempt = max(attempts, default=-1) + 1
    return Path(ckpt_dir) / _WAL_FMT.format(step=step, attempt=attempt)


def checkpoint_service(svc: StreamService, ckpt_dir, step: int, *,
                       keep: int = 3) -> Path:
    """Atomic fleet checkpoint + WAL rotation seeded with unflushed state.

    After this returns, ``restore_service(ckpt_dir)`` reproduces ``svc``
    exactly: fleet arrays from the checkpoint, execution metadata and slot
    table from its ``extra`` meta, buffers/schedule from the new WAL's
    head records, and any later traffic from the WAL's tail.
    """
    # The whole snapshot + rotation runs under the service lock: the
    # background flush worker mutates fleet/rings/schedule/WAL under it,
    # so without it a checkpoint taken mid-flush could record torn state —
    # or rotate the WAL such that the in-flight flush's record lands in
    # the NEW segment whose fleet snapshot already includes that flush,
    # and replay double-applies it. The RLock serialises us after any
    # in-flight flush; requests still queued run against (and log after)
    # the rotated segment, which replay applies on top of the snapshot.
    with svc._lock:
        with obs_tracing.span("stream.checkpoint", step=step):
            return _checkpoint_locked(svc, ckpt_dir, step, keep=keep)


def _checkpoint_locked(svc: StreamService, ckpt_dir, step: int, *,
                       keep: int) -> Path:
    store = svc.store
    f = store.factor
    # A sharded fleet is written whole: the gather is a collective every
    # rank makes; one rank writes, the others wait for its commit.
    fleet = _distributed.gather(f.data)
    if not _writes(store):
        _mesh_barrier(store)
        return Path(ckpt_dir) / f"step_{step:08d}"

    # Seed the NEW WAL segment FIRST — the unflushed ring contents and the
    # pending window schedule, everything the checkpoint's arrays do not
    # carry — and only then commit the checkpoint, whose meta names the
    # segment. A crash before the commit leaves the previous
    # (checkpoint, WAL) pair authoritative; a crash after it finds the
    # seeded segment already complete. The reverse order would open a
    # window where step N is committed but its buffers/schedule are lost.
    wal_path = _next_wal_path(ckpt_dir, step)
    log = ReplayLog(wal_path, truncate=True)
    for u in store.users():
        c = svc._coalescer(u)
        up, down = c.peek()
        first = c.first_tick
        for row in up:
            log.append({"op": "buffer", "user": u, "sign": 1,
                        "first_tick": first, **encode_row(row)})
        for row in down:
            log.append({"op": "buffer", "user": u, "sign": -1,
                        "first_tick": first, **encode_row(row)})
    for due, _, u, row in sorted(svc._schedule):
        log.append({"op": "sched", "user": u, "due": due,
                    **encode_row(row)})

    extra = {"stream": {
        "n": store.n,
        # Storage-kind record (absent in pre-structure checkpoints, which
        # restore as dense — the compat default): a structured fleet's
        # block stacks must never be reinterpreted as a dense (B, n, n)
        # fleet by shape accident, so restore keys the template on this.
        "structure": store.structure,
        "block": store.block,
        "width": store.width,
        "widths": list(store.widths),
        "capacity": store.capacity,
        "ladder": list(store.ladder),
        "panel": f.panel,
        "backend": f.backend,
        "interpret": f.interpret,
        "precision": _precision_to_json(f.precision),
        "mesh": _mesh_to_json(f),
        "dtype": ckpt.dtype_name(f.dtype),
        "init_scale": store.init_scale,
        "slots": [[u, s] for u, s in sorted(
            store._slot_of.items(), key=lambda kv: kv[1])],
        "empty_slots": list(store.empty_slots),
        "last_used": [[u, t] for u, t in store._last_used.items()],
        "tick": svc.tick_count,
        "window": svc.window,
        "deadline": svc.deadline,
        "auto_flush": svc.auto_flush,
        "ring_capacity": svc._ring_capacity,
        "background": svc.background_active,
        "wal": wal_path.name,
    }}
    path = ckpt.save(ckpt_dir, step, {"fleet": fleet}, keep=keep,
                     extra=extra)

    # Rotate: the previous segment is superseded, live traffic appends to
    # the seeded one from here on.
    if svc._wal is not None:
        svc._wal.close()
    svc.attach_wal(log)
    _prune_wals(ckpt_dir)
    _mesh_barrier(store)
    return path


def _prune_wals(ckpt_dir) -> None:
    """Drop WAL segments no committed checkpoint references — pruned
    steps' segments and orphans of crashed checkpoint attempts."""
    referenced = set()
    for step in ckpt.all_steps(ckpt_dir):
        try:
            meta = ckpt.read_meta(ckpt_dir, step)
        except (FileNotFoundError, ValueError):
            continue
        name = meta.get("extra", {}).get("stream", {}).get("wal")
        if name:
            referenced.add(name)
    for p in Path(ckpt_dir).glob("wal_*.jsonl"):
        if p.name not in referenced:
            try:
                os.remove(p)
            except OSError:
                pass


def _apply_record(svc: StreamService, rec: dict) -> None:
    op = rec["op"]
    if op == "buffer":
        svc._coalescer(rec["user"]).push(
            decode_row(rec), sign=rec["sign"],
            tick=rec.get("first_tick") or 0)
    elif op == "sched":
        svc._schedule_row(rec["user"], decode_row(rec), due=rec["due"])
    elif op == "admit":
        svc.admit(rec["user"], scale=rec.get("scale"))
    elif op == "evict":
        svc.evict(rec["user"])
    elif op == "push":
        svc.push(rec["user"], decode_row(rec), sign=rec["sign"])
    elif op == "tick":
        svc.tick()
    elif op == "flush":
        svc.flush(force=rec.get("force", False),
                  reason=rec.get("reason", "manual"))
    elif op == "decay":
        svc.decay(rec["alpha"])
    else:
        raise ValueError(f"unknown replay record op {op!r}")


def restore_service(ckpt_dir, *, step: Optional[int] = None,
                    mesh=None, warm: bool = False,
                    device=None) -> StreamService:
    """Rebuild a ``StreamService`` from checkpoint + WAL replay.

    ``mesh``: for a checkpoint of a sharded fleet, a ``DeviceMesh`` to
    restore onto instead of the one its record rebuilds (another rank
    count or layout); every rank of it calls ``restore_service``. A
    ``mesh=`` for a checkpoint of an unsharded fleet is a ``ValueError``.

    ``warm``: run ``store.warmup()`` BEFORE the WAL replay, so the replayed
    mutation sequence — and everything the restored service serves
    afterwards — replays steps built ahead of time. The restored fleet is a
    new allocation, so its steps are built (captured) here and counted.

    ``device``: where the fleet goes (default CUDA); a rebuilt mesh's ranks
    compute there.
    """
    with obs_tracing.span("stream.restore", warm=warm):
        return _restore_service(ckpt_dir, step=step, mesh=mesh, warm=warm,
                                device=device)


def _restore_service(ckpt_dir, *, step, mesh, warm, device
                     ) -> StreamService:
    if step is None:
        step = ckpt.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    meta = ckpt.read_meta(ckpt_dir, step)
    s = meta.get("extra", {}).get("stream")
    if s is None:
        raise ValueError(
            f"checkpoint step {step} carries no stream meta — was it saved "
            "by checkpoint_service?")

    mesh, axis = _mesh_from_json(s.get("mesh"), mesh=mesh, device=device)
    # The fleet template mirrors the recorded storage kind. Checkpoints
    # from before the record restore as dense; a structured checkpoint read
    # with a dense template fails inside ckpt.restore (the block-stack leaf
    # names do not match a dense 'fleet' leaf).
    structure = s.get("structure", "dense")
    if structure == "dense":
        template = {"fleet": torch.Tensor}
    elif structure == "blocktridiag":
        template = {"fleet": BlockTriDiagStorage}
    else:
        raise ValueError(
            f"checkpoint step {step} records fleet structure "
            f"{structure!r}, which this reader does not support "
            "(supported: 'dense', 'blocktridiag')")
    from repro_torch.core.api import default_device

    where = (_distributed.mesh_device(mesh) if mesh is not None
             else default_device(device))
    data = ckpt.restore(ckpt_dir, step, template, device=where)["fleet"]
    factor = CholFactor.from_factor(
        data, panel=s["panel"], backend=s["backend"],
        interpret=s["interpret"],
        precision=_precision_from_json(s["precision"]),
        mesh=mesh, axis=axis)
    store = FactorStore.from_state(
        factor, width=s["width"],
        slots={_user_key(u): slot for u, slot in s["slots"]},
        last_used={_user_key(u): t for u, t in s["last_used"]},
        init_scale=s["init_scale"],
        # Pre-ladder checkpoints carry no ladder/widths records:
        # from_state then derives the doubling ladder from the restored
        # capacity (the historical grow schedule) and default buckets.
        ladder=tuple(s["ladder"]) if s.get("ladder") else None,
        widths=tuple(s["widths"]) if s.get("widths") else None,
        # Recorded next-assigned-first; restores the live LIFO admission
        # order (eviction history makes it diverge from any derived one).
        empty_slots=(tuple(s["empty_slots"])
                     if s.get("empty_slots") is not None else None))
    if warm:
        store.warmup()
    svc = StreamService(store, window=s["window"], deadline=s["deadline"],
                        auto_flush=s["auto_flush"],
                        capacity=s["ring_capacity"])
    svc.tick_count = s["tick"]
    for u in store.users():
        # Slots restored from meta never went through svc.admit: hand each
        # already-admitted user its (empty) coalescer directly.
        svc._coalescers[u] = Coalescer(
            store.n, width=store.width, capacity=svc._ring_capacity,
            deadline=svc.deadline, dtype=store.row_dtype,
            block=store.block)

    wal_path = Path(ckpt_dir) / s["wal"]
    svc._replaying = True
    try:
        for rec in ReplayLog.read(wal_path):
            _apply_record(svc, rec)
    finally:
        svc._replaying = False
    # Every rank has read the log before its writer appends to it again.
    _mesh_barrier(store)
    if _writes(store):
        svc.attach_wal(ReplayLog(wal_path))  # append-continue the segment
    if s.get("background"):
        # Replay is strictly synchronous (the log's flush grouping is
        # authoritative); only the LIVE service gets its worker back.
        svc.start_background()
    return svc


def _user_key(u):
    """JSON round-trips int/str user ids natively; leave them as stored."""
    return u
