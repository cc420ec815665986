"""The port's stream stack against the JAX package's, on the CPU.

The same numpy traffic (rows from a seed) drives ``repro.stream`` and
``repro_torch.stream``: coalescer drains, store slot maps, promotions,
compaction and counters, a push/tick/flush/decay/evict/readmit sequence
with a window, a deadline and a refused downdate (``FlushReport`` fields
equal, fleets within ``tol_for(float32, n)``), the background worker, the
retrace guard and the span tracing. The JAX side runs its plain
references (``backend='reference'``, ``'blocktridiag_ref'``); the port runs
the plain versions of its kernels (``fused``, ``blocktridiag`` on CPU
tensors), so each store step walks the same code it captures on the card.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro import stream as jstream
from repro.obs import tracing as jtracing
from repro_torch import stream as tstream
from repro_torch.obs import tracing as ttracing
from repro_torch.stream import store as tstore
from tests.strategies import tol_for

N, BLOCK, WIDTH = 8, 2, 3


def rows(n, m, seed, scale=0.3, block=None):
    """``m`` rank-1 rows; with ``block``, each supported inside one
    adjacent block pair (the structured contract)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(m):
        v = (scale * rng.normal(size=n)).astype(np.float32)
        if block is not None:
            j = int(rng.integers(0, n // block - 1))
            mask = np.zeros(n, np.float32)
            mask[j * block:(j + 2) * block] = 1.0
            v = v * mask
        out.append(v)
    return out


def stores(structure="dense", *, ladder=(2, 4), width=WIDTH, **kw):
    """(JAX store, port store) with one configuration."""
    common = dict(capacity=ladder[0], ladder=ladder, width=width, panel=4,
                  **kw)
    if structure == "dense":
        return (jstream.FactorStore(N, backend="reference", **common),
                tstream.FactorStore(N, backend="fused", device="cpu",
                                    **common))
    common.update(structure="blocktridiag", block=BLOCK)
    return (jstream.FactorStore(N, backend="blocktridiag_ref", **common),
            tstream.FactorStore(N, backend="blocktridiag", device="cpu",
                                **common))


def fleet(store):
    """The fleet's leaves as float32 numpy arrays, either package."""
    data = store.factor.data
    if isinstance(data, torch.Tensor):
        return [data.float().numpy()]
    if hasattr(data, "diag") and isinstance(data.diag, torch.Tensor):
        return [data.diag.float().numpy(), data.off.float().numpy()]
    return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(data)]


def assert_fleets_close(a, b, atol):
    fa, fb = fleet(a), fleet(b)
    assert [x.shape for x in fa] == [x.shape for x in fb]
    for x, y in zip(fa, fb):
        np.testing.assert_allclose(x, y, rtol=0, atol=atol)


def summary(report):
    if report is None:
        return None
    return (report.absorbed, report.downdated, report.downdate_ok,
            report.mutations, report.rounds, report.reason, report.widths)


# ---------------------------------------------------------------------------
# Coalescer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [None, BLOCK])
def test_coalescer_drains_equal_jax(block):
    n = N
    ups = rows(n, 7, seed=1, block=block or None)
    dns = rows(n, 4, seed=2, block=block or None)
    cs = [pkg.Coalescer(n, width=3, deadline=2, block=block)
          for pkg in (jstream, tstream)]
    outs = []
    for c in cs:
        got = []
        for t, v in enumerate(ups):
            c.push_update(v, tick=t)
            if t < len(dns):
                c.push_downdate(dns[t], tick=t)
            got.append((c.ready(), c.expired(t + 1), c.pending_up,
                        c.pending_down, c.first_tick))
            if c.ready():
                d = c.drain(tick=t)
                got.append((d.up.copy(), d.down.copy(), d.up_anchors,
                            d.down_anchors))
        d = c.drain(tick=99)
        got.append((d.up.copy(), d.down.copy(), d.up_anchors,
                    d.down_anchors, d.empty, c.pending))
        outs.append(got)
    for a, b in zip(*outs):
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


@pytest.mark.parametrize("pkg", [jstream, tstream], ids=["jax", "torch"])
def test_coalescer_errors_equal(pkg):
    """The same errors from both packages: ring overflow, a row of the
    wrong length, a bad sign, a row off the block-local contract."""
    c = pkg.Coalescer(4, width=2, capacity=2)
    c.push_update(np.ones(4, np.float32))
    c.push_update(np.ones(4, np.float32))
    with pytest.raises(OverflowError):
        c.push_update(np.ones(4, np.float32))
    with pytest.raises(ValueError):
        c.push_downdate(np.ones(5, np.float32))
    with pytest.raises(ValueError):
        c.push(np.ones(4, np.float32), sign=0)
    keyed = pkg.Coalescer(8, width=2, block=2)
    with pytest.raises(ValueError, match="block"):
        keyed.push_update(np.ones(8, np.float32))
    assert keyed.pending == 0
    with pytest.raises(ValueError):
        pkg.Coalescer(8, width=2, block=3)


def test_ring_buffer_equal_jax():
    a, b = jstream.RingBuffer(3, capacity=3), tstream.RingBuffer(3,
                                                                 capacity=3)
    for rb in (a, b):
        for i in range(3):
            rb.push(np.full(3, i, np.float32))
        rb.drain(2)
        rb.push(np.full(3, 7, np.float32))
    np.testing.assert_array_equal(a.peek(), b.peek())
    assert a.count == b.count and a.full == b.full


def test_coalescer_flush_into_single_factor_matches_jax():
    from repro.core import CholFactor as JFactor
    from repro_torch.core import CholFactor as TFactor
    from tests.strategies import make_problem

    L, _ = (np.asarray(x) for x in make_problem(N, 1, seed=4))
    outs = []
    for pkg, f in ((jstream, JFactor.from_factor(L, backend="reference")),
                   (tstream, TFactor.from_factor(torch.from_numpy(L.copy()),
                                                 backend="fused", panel=4))):
        c = pkg.Coalescer(N, width=4)
        for v in rows(N, 3, seed=5):
            c.push_update(v)
        c.push_downdate(0.5 * rows(N, 1, seed=5)[0])
        f, ok = c.flush_into(f, pad_to=4)
        outs.append((np.asarray(f.data.numpy() if isinstance(
            f.data, torch.Tensor) else f.data), bool(ok)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], rtol=0,
                               atol=tol_for(np.float32, N))
    assert outs[0][1] == outs[1][1] is True


# ---------------------------------------------------------------------------
# FactorStore
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("structure", ["dense", "blocktridiag"])
def test_store_slot_maps_promotion_compaction_match_jax(structure):
    j, t = stores(structure, ladder=(2, 4, 8))
    for st in (j, t):
        log = []
        m0 = st.__class__.__module__
        counted = (jstream.mutations_issued if m0.startswith("repro.")
                   else tstream.mutations_issued)
        for u in "abc":
            log.append(st.admit(u))
        log.append((st.capacity, st.empty_slots, st.slot_to_user))
        st.evict("b")
        log.append(st.admit("d"))
        log.append(st.admit("a", tick=5))       # idempotent
        for u in "ef":
            st.admit(u)
        log.append((st.capacity, st.empty_slots, st.slot_to_user,
                    st.active))
        st.evict("c")
        st.evict("e")
        log.append(st.compact())
        log.append((st.capacity, st.empty_slots, st.slot_to_user,
                    st.last_used("a")))
        before = counted()
        blk = st.pad_block({st.slot("a"): np.stack(rows(N, 2, seed=3,
                                                        block=st.block))})
        log.append(blk.shape)
        st.apply(blk, None)
        st.apply(None, 0.1 * blk)
        st.apply(blk, 0.1 * blk)
        log.append(counted() - before)
        st.log = log
    assert j.log == t.log
    assert_fleets_close(j, t, tol_for(np.float32, N))


@pytest.mark.parametrize("structure", ["dense", "blocktridiag"])
def test_cpu_store_holds_its_rung_and_grows_at_a_promotion(structure):
    """On the CPU a store with the derived ladder (top rung 128 x
    capacity) holds only its current rung; a promotion grows the fleet
    and the static inputs, keeping the members' values, and the fleet
    stays within ``tol_for`` of the JAX store's."""
    kw = dict(capacity=2, width=WIDTH, panel=4)
    if structure == "dense":
        j = jstream.FactorStore(N, backend="reference", **kw)
        t = tstream.FactorStore(N, backend="fused", device="cpu", **kw)
    else:
        kw.update(structure="blocktridiag", block=BLOCK)
        j = jstream.FactorStore(N, backend="blocktridiag_ref", **kw)
        t = tstream.FactorStore(N, backend="blocktridiag", device="cpu",
                                **kw)
    assert t.ladder == j.ladder == tstore.ladder_from(2)
    assert [x.shape[0] for x in t._base] == [2] * len(t._base)
    for st in (j, t):
        for u in "ab":
            st.admit(u)
        blk = st.pad_block({s: np.stack(rows(N, 2, seed=s, block=st.block))
                            for s in range(2)})
        st.apply(blk, 0.1 * blk)
        st.admit("c")                         # promote 2 -> 4
        blk = st.pad_block({s: np.stack(rows(N, 3, seed=9 + s,
                                             block=st.block))
                            for s in range(3)})
        st.apply(blk, 0.1 * blk)
    assert t.capacity == j.capacity == 4
    assert [x.shape[0] for x in t._base] == [4] * len(t._base)
    assert all(v.shape[0] == 4 for v in t._vbuf.values())
    assert_fleets_close(j, t, tol_for(np.float32, N))


def test_deferring_holds_only_the_calling_threads_counts():
    """Inside ``obs.metrics.deferring`` a thread's launch and registry
    counts are held, while another thread's count at once; each ``apply``
    of the held counts adds them again (a graph replay)."""
    import threading

    from repro_torch.kernels._launch import LaunchCounter
    from repro_torch.obs import metrics

    launches = LaunchCounter()
    series = metrics.counter("test.deferring", kind="probe")
    s0 = series.value
    inside, outside = threading.Barrier(2), threading.Barrier(2)
    held = []

    def capturing():
        with metrics.deferring() as d:
            inside.wait()
            for _ in range(3):
                launches.inc()
                series.inc(2)
            outside.wait()
            held.append(d)

    worker = threading.Thread(target=capturing)
    worker.start()
    inside.wait()
    for _ in range(5):
        launches.inc()
        series.inc()
    outside.wait()
    worker.join()
    assert metrics.deferred() is None
    assert launches.count == 5 and series.value - s0 == 5
    for _ in range(2):
        held[0].apply()
    assert launches.count == 5 + 2 * 3 and series.value - s0 == 5 + 2 * 6


@pytest.mark.parametrize("pkg", [jstream, tstream], ids=["jax", "torch"])
def test_store_errors_match_jax(pkg):
    dev = {} if pkg is jstream else {"device": "cpu"}
    st = pkg.FactorStore(N, capacity=1, ladder=(1, 2), width=2, panel=4,
                         backend="reference", **dev)
    st.admit("a")
    st.admit("b")
    with pytest.raises(pkg.LadderFullError):
        st.admit("c")
    with pytest.raises(ValueError):
        pkg.FactorStore(N, width=4, widths=(1, 2), backend="reference",
                        **dev)
    with pytest.raises(ValueError):
        pkg.FactorStore(N, ladder=(4, 2), backend="reference", **dev)
    with pytest.raises(ValueError):
        st.pad_block({0: np.ones((3, N), np.float32)})
    with pytest.raises(ValueError):
        pkg.FactorStore(N, structure="blocktridiag", block=3, **dev)
    err = (jstream.store.UnsupportedStorageError if pkg is jstream
           else tstore.UnsupportedStorageError)
    with pytest.raises(err):
        pkg.FactorStore(N, structure="banded", **dev)
    with pytest.raises(ValueError, match="support"):
        pkg.FactorStore(N, structure="blocktridiag", block=2,
                        backend="gemm", **dev)


@pytest.mark.parametrize("kw, err, match", [
    ({"backend": "sharded"}, ValueError, "requires a mesh"),
    ({"mesh": object()}, ValueError, "requires backend='sharded'"),
    ({"mesh": object(), "backend": "reference"}, ValueError,
     "requires backend='sharded'"),
    ({"mesh": object(), "backend": "sharded", "structure": "blocktridiag",
      "block": BLOCK}, "unsupported", "do not compose with mesh"),
], ids=["sharded_without_mesh", "mesh_without_sharded",
        "mesh_with_reference", "mesh_with_blocktridiag"])
def test_mesh_placement_misuse_raises_like_jax(kw, err, match):
    """A sharded placement asked for half-way is refused before anything
    is built, by both packages with the same exception type and message
    (the mesh itself is never touched)."""
    for pkg, dev in ((jstream, {}), (tstream, {"device": "cpu"})):
        exc = err
        if err == "unsupported":
            exc = (jstream.store.UnsupportedStorageError if pkg is jstream
                   else tstore.UnsupportedStorageError)
        with pytest.raises(exc, match=match):
            pkg.FactorStore(N, **kw, **dev)


def test_row_dtype_and_bf16_fleet_storage():
    st = tstream.FactorStore(N, capacity=2, width=2, precision="bf16",
                             device="cpu", backend="fused", panel=4)
    assert st.factor.dtype == torch.bfloat16
    assert st.row_dtype == np.float32
    st64 = tstream.FactorStore(N, capacity=2, width=2, dtype=torch.float64,
                               device="cpu", backend="fused", panel=4)
    assert st64.row_dtype == np.float64
    st.admit("a")
    st.decay(0.5)
    assert st.factor.dtype == torch.bfloat16
    assert float(st.factor.data[0, 0, 0]) == 0.5


# ---------------------------------------------------------------------------
# StreamService: one traffic through both packages
# ---------------------------------------------------------------------------


def traffic(block=None):
    """A push/tick/flush/decay/evict/readmit sequence: window 4, deadline
    2, width 3 with buckets (1, 3), a rung crossing (2 -> 4), a single-row
    deadline flush (the width-1 bucket) and one downdate the guard must
    refuse."""
    ops = [("admit", "a"), ("admit", "b")]
    r = {u: rows(N, 12, seed=10 + i, block=block)
         for i, u in enumerate("abc")}
    for t in range(6):
        for u in "ab":
            ops.append(("push", u, r[u][t], 1))
        ops.append(("tick",))
    ops.append(("admit", "c"))                      # promote 2 -> 4
    ops += [("push", "c", r["c"][0], 1), ("tick",), ("tick",), ("tick",)]
    ops.append(("decay", 0.9))
    ops += [("evict", "b"), ("admit", "b")]
    ops.append(("push", "a", 40.0 * r["a"][7], -1))  # infeasible
    for t in range(6, 10):
        for u in "abc":
            ops.append(("push", u, r[u][t], 1))
        ops.append(("tick",))
    ops.append(("flush", True))
    for _ in range(6):
        ops.append(("tick",))
    return ops


def drive(svc, ops):
    reports = []
    for op in ops:
        if op[0] == "admit":
            svc.admit(op[1])
        elif op[0] == "evict":
            svc.evict(op[1])
        elif op[0] == "push":
            reports.append(svc.push(op[1], op[2], sign=op[3]))
        elif op[0] == "tick":
            reports.append(svc.tick())
        elif op[0] == "flush":
            reports.append(svc.flush(force=op[1]))
        elif op[0] == "decay":
            svc.decay(op[1])
    return [summary(r) for r in reports if r is not None]


def services(structure, **kw):
    return [pkg.StreamService(st, window=4, deadline=2, auto_flush=True,
                              **kw)
            for pkg, st in zip((jstream, tstream), stores(structure))]


@pytest.mark.parametrize("structure", ["dense", "blocktridiag"])
def test_service_sequence_matches_jax(structure):
    js, ts = services(structure)
    ops = traffic(BLOCK if structure == "blocktridiag" else None)
    jr, tr = drive(js, ops), drive(ts, ops)
    assert jr == tr
    widths = {w for r in tr for w in r[6]}
    assert widths == {1, 3}
    assert any(r[2].get("a") is False for r in tr), "no refused downdate"
    assert ts.store.capacity == 4 and ts.scheduled() == js.scheduled()
    assert_fleets_close(js.store, ts.store, tol_for(np.float32, N))
    b = np.ones(N, np.float32)
    np.testing.assert_allclose(ts.solve("a", b).numpy(),
                               np.asarray(js.solve("a", b)), rtol=1e-3,
                               atol=tol_for(np.float32, N))


def test_background_worker_fleet_equals_synchronous():
    """The worker coalesces triggers (grouping may differ from the
    synchronous run): the absorbed totals and the fleet may not."""
    n, width, B, R = N, 3, 3, 9
    data = {u: rows(n, R, seed=70 + u, scale=0.2) for u in range(B)}

    def run(background):
        st = tstream.FactorStore(n, capacity=B, width=width, panel=4,
                                 backend="fused", device="cpu")
        svc = tstream.StreamService(st, auto_flush=True,
                                    background=background,
                                    capacity=R + width)
        for t in range(R):
            for u in range(B):
                svc.push(u, data[u][t])
        reports = svc.drain() if background else ()
        svc.stop_background()
        svc.flush(force=True)
        return svc, reports

    sync, _ = run(False)
    bg, reports = run(True)
    assert reports and all(r.reason in ("width", "deadline")
                           for r in reports)
    assert not bg.background_active
    assert_fleets_close(bg.store, sync.store, 8 * tol_for(np.float32, n))


# ---------------------------------------------------------------------------
# Warmup and the retrace guard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("structure", ["dense", "blocktridiag"])
def test_warmup_then_sequence_builds_nothing(structure):
    _, st = stores(structure)
    rep = tstream.warmup_store(st)
    # Per rung: up/down x2 widths + both x4 + scale + slot_set = 10; two
    # rungs + one promote boundary = 21, as the JAX package compiles.
    assert rep.compiled == 21 and rep.cached == 0
    assert rep.lowering == "portable" and rep.graphs == 0
    assert st.warmup().cached == 21
    svc = tstream.StreamService(st, window=4, deadline=2)
    with tstream.assert_no_retrace("two-rung sequence") as w:
        drive(svc, traffic(BLOCK if structure == "blocktridiag" else None))
    assert w.traces == 0 and st.steps.cold_dispatches == 0


def test_cold_signature_raises():
    _, st = stores("dense")
    with pytest.raises(tstream.RetraceError):
        with tstream.assert_no_retrace("cold admit"):
            st.admit("u")
    with tstream.watch_traces() as w:
        st.admit("v")
    assert w.traces == 0            # the same key: built once
    assert st.steps.cold_dispatches == 1


def test_retrace_metric_counts_a_cold_flush_step():
    _, st = stores("dense")
    st.warmup(widths=(3,))          # the width-1 bucket left cold
    svc = tstream.StreamService(st, auto_flush=False)
    svc.push("a", rows(N, 1, seed=9)[0])
    before = tstore.traces_counted()
    with pytest.raises(tstream.RetraceError):
        with tstream.assert_no_retrace():
            svc.flush(force=True)
    assert tstore.traces_counted() - before == 1


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


def test_chrome_trace_schema_and_span_names_match_jax(tmp_path):
    names = []
    for pkg, tracing, dur in ((jstream, jtracing, jstream.durability),
                              (tstream, ttracing, tstream.durability)):
        tracing.RECORDER.clear()
        st = stores("dense")[0 if pkg is jstream else 1]
        pkg.warmup_store(st)
        svc = pkg.StreamService(st, window=4, deadline=2)
        drive(svc, traffic()[:20])
        svc.start_background()
        svc.push("a", rows(N, 1, seed=8)[0])
        svc.flush(force=True)
        svc.drain()
        svc.stop_background()
        dur.checkpoint_service(svc, tmp_path / pkg.__name__, step=1)
        dur.restore_service(tmp_path / pkg.__name__,
                            **({} if pkg is jstream else {"device": "cpu"}))
        trace = tracing.chrome_trace()
        for ev in trace["traceEvents"]:
            assert {"name", "ph", "ts", "dur", "pid", "tid", "args"} <= set(ev)
        assert trace["displayTimeUnit"] == "ms"
        names.append(sorted({ev["name"] for ev in trace["traceEvents"]}))
        path = tmp_path / f"{pkg.__name__}.json"
        tracing.export_chrome_trace(path)
        assert path.stat().st_size > 0
    assert names[0] == names[1]
    assert {"stream.flush", "stream.warmup", "stream.drain",
            "stream.checkpoint", "stream.restore"} <= set(names[1])
    assert ttracing.TRACE_ENV != jtracing.TRACE_ENV
    assert ttracing.RECORDER is not jtracing.RECORDER


def test_span_instant_traced_record_like_jax():
    recs = []
    for tracing in (jtracing, ttracing):
        rec = tracing.SpanRecorder(capacity=4)

        @tracing.traced("work", kind="x")
        def work():
            return 3

        with tracing.span("outer", recorder=rec, step=1) as ev:
            ev.labels["late"] = True
        tracing.instant("mark", recorder=rec, steps=2)
        assert work() == 3
        for i in range(5):
            with tracing.span("s", recorder=rec, i=i):
                pass
        events = tracing.chrome_trace(rec.events())["traceEvents"]
        recs.append([(e["name"], e["ph"], e["args"], e.get("s"))
                     for e in events])
    assert recs[0] == recs[1] and len(recs[1]) == 4
