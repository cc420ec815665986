"""``StreamService``: the streaming update service over a factor fleet.

Port of ``repro.stream.service``. It owns one ``FactorStore`` fleet plus
one ``Coalescer`` per admitted user, and turns per-user rank-1 traffic into
fused rank-k flushes:

* ``push(user, v, sign=+1)`` buffers a rank-1 observation (auto-admitting
  unknown users); with ``auto_flush`` a push that fills a user's ring
  triggers a fleet flush of every ready user.
* ``tick()`` advances the service's logical clock. It fires deadline
  flushes (stale buffers) and window expiry: a row absorbed with
  ``window=W`` is scheduled as a *future downdate* due ``W`` ticks later.
* ``flush(force=...)`` drains every selected user and issues at most ONE
  batched rank-k mutation per sign block per round (updates first, then
  guarded downdates), zero-padding non-flushing slots so the step's shape
  never changes.
* ``decay(alpha)`` is exact exponential forgetting for the whole fleet.

**Background flushing** (``start_background()``): a bounded-queue daemon
worker runs the flushes instead of the caller; ``push``/``tick`` then only
enqueue a flush request, the worker coalesces everything queued into ONE
flush per wake-up, and a producer that outruns the device blocks on the
bounded queue. All state-changing entry points share one lock. On CUDA,
warm the store before starting the worker: a step first met in the worker
is captured there (and counted by the retrace guard).

Every state-changing call appends one record to the attached write-ahead
``ReplayLog`` (``repro_torch.stream.durability``), in the JAX package's
record format.

**Many controllers.** Over a sharded store of several ranks every rank
runs the same ``StreamService`` on the same calls: coalescing is
deterministic, so every rank issues the same steps and so the same
collectives. The background worker's flush points follow wall time,
which would let the ranks' collectives diverge and deadlock, so
``start_background()`` refuses a store of more than one rank.
"""
from __future__ import annotations

import dataclasses
import heapq
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.stream.coalescer import Coalescer
from repro_torch.stream.store import FactorStore

_MAX_FLUSH_ROUNDS = 64  # backstop: bounded work per flush call


@dataclasses.dataclass
class FlushReport:
    """What one ``flush`` call did (host-side bookkeeping for consumers).

    Attributes:
      absorbed: user -> number of update rows absorbed (FIFO order).
      downdated: user -> number of downdate rows applied (FIFO order);
        counted even when the guard refused (see ``downdate_ok``).
      downdate_ok: user -> feasibility verdict of that user's downdate
        block (absent when the user had no downdates this flush). A False
        verdict means the block was REFUSED — the slot is unchanged.
      mutations: batched rank-k mutations dispatched (one per sign block
        per round; 1–2 in the steady state).
      rounds: drain/apply rounds (1 unless a ring held > width rows).
      reason: 'width' | 'deadline' | 'manual' | 'force' | 'background'.
      t_coalesce_s: host seconds spent draining rings + building the
        zero-padded blocks (summed over rounds).
      t_mutate_s: host seconds spent inside ``store.apply`` dispatches
        (summed over rounds).
      widths: padded block width (the chosen width bucket) of every
        dispatched sign block, dispatch order.
    """

    absorbed: Dict[object, int] = dataclasses.field(default_factory=dict)
    downdated: Dict[object, int] = dataclasses.field(default_factory=dict)
    downdate_ok: Dict[object, bool] = dataclasses.field(default_factory=dict)
    mutations: int = 0
    rounds: int = 0
    reason: str = "manual"
    t_coalesce_s: float = 0.0
    t_mutate_s: float = 0.0
    widths: Tuple[int, ...] = ()

    @property
    def empty(self) -> bool:
        return not self.absorbed and not self.downdated


class _FlushWorker(threading.Thread):
    """Daemon flush worker (the MaxText ``JetThread`` shape): consumes
    flush requests from a bounded queue and runs them under the service
    lock, coalescing everything queued at wake-up into ONE flush (first
    request's reason, any request's force). An exception is captured, not
    swallowed — it re-raises at the next ``drain()``/``stop_background()``
    and the worker drops (but still acknowledges) later requests until
    the failure is cleared, so a poisoned flush cannot silently drop
    traffic; the dropped requests' rows stay buffered in the rings."""

    _STOP = object()

    def __init__(self, svc: "StreamService", maxsize: int):
        super().__init__(daemon=True, name="stream-flush-worker")
        self._svc = svc
        self.requests: "queue.Queue" = queue.Queue(maxsize=maxsize)
        self.exception: Optional[BaseException] = None

    def run(self) -> None:
        while True:
            batch = [self.requests.get()]
            # Coalesce: one flush serves every request already queued —
            # flush selection recomputes from the rings, so a burst of
            # triggers needs (and gets) a single drain/apply pass.
            while True:
                try:
                    batch.append(self.requests.get_nowait())
                except queue.Empty:
                    break
            stop = self._STOP in batch
            reqs = [r for r in batch if r is not self._STOP]
            try:
                if reqs and self.exception is None:
                    force = any(f for f, _ in reqs)
                    obs_metrics.gauge("repro.stream.queue_depth").set(
                        self.requests.qsize())
                    with obs_tracing.span("stream.background_flush",
                                          requests=len(reqs)):
                        self._svc._flush_sync(force=force, reason=reqs[0][1])
            except BaseException as e:  # noqa: BLE001 — reported at drain
                self.exception = e
            finally:
                for _ in batch:
                    self.requests.task_done()
            if stop:
                return

    def submit(self, force: bool, reason: str) -> None:
        self.requests.put((force, reason))
        obs_metrics.gauge("repro.stream.queue_depth").set(
            self.requests.qsize())

    def stop(self) -> None:
        self.requests.put(self._STOP)
        self.join()


class StreamService:
    """Coalescing streaming-update service over a ``FactorStore`` fleet.

    Args:
      store: the fleet (its ``width`` is the coalesce width).
      window: sliding-window length in ticks — every absorbed update row is
        scheduled as a downdate due ``window`` ticks after its flush (None:
        no forgetting).
      deadline: staleness bound in ticks — pending rows older than this
        force a flush at the next ``tick()`` (None: width/manual only).
      auto_flush: flush automatically when a push fills a user's ring.
      capacity: per-sign ring capacity per user (default ``2 * width``).
      background: start the background flush worker immediately (same as
        calling ``start_background()`` after construction).
      queue_size: bound on pending flush requests. The worker coalesces
        everything queued into one flush per wake-up; producers block on
        enqueue when the bound is hit — backpressure.
    """

    def __init__(self, store: FactorStore, *, window: Optional[int] = None,
                 deadline: Optional[int] = None, auto_flush: bool = True,
                 capacity: Optional[int] = None, background: bool = False,
                 queue_size: int = 64):
        self.store = store
        self.window = window
        self.deadline = deadline
        self.auto_flush = auto_flush
        self._ring_capacity = capacity
        self._queue_size = queue_size
        self.tick_count = 0
        self._coalescers: Dict[object, Coalescer] = {}
        # (due_tick, insertion_order, user, row) — heap by due tick.
        self._schedule: List[Tuple[int, int, object, np.ndarray]] = []
        self._sched_seq = 0
        self._wal = None          # durability.ReplayLog or None
        self._replaying = False   # replay applies logged flushes verbatim
        # One lock for every state-changing entry point: the background
        # worker and the producer thread interleave at call granularity.
        self._lock = threading.RLock()
        self._worker: Optional[_FlushWorker] = None
        self._bg_reports: List[FlushReport] = []
        if background:
            self.start_background()

    # -- background worker ---------------------------------------------------
    @property
    def background_active(self) -> bool:
        return self._worker is not None and self._worker.is_alive()

    def start_background(self) -> None:
        """Start the daemon flush worker (idempotent). From here on,
        flush triggers from ``push``/``tick`` are enqueued and executed
        off-thread; explicit ``flush()`` calls remain synchronous."""
        if self.background_active:
            return
        if self.store.ranks > 1:
            raise RuntimeError(
                f"start_background() on a sharded store of "
                f"{self.store.ranks} ranks: the worker's flush points "
                "follow wall time, so the ranks' collectives could diverge "
                "and deadlock; flush from the calls every rank makes")
        self._worker = _FlushWorker(self, self._queue_size)
        self._worker.start()

    def stop_background(self) -> None:
        """Stop the worker after it drains its queue; re-raises any
        exception the worker captured (with the pre-failure reports
        attached as ``partial_reports`` and cleared, like ``drain``).
        Pending ring contents stay buffered — they flush on the next
        trigger or ``flush(force=)``."""
        if self._worker is None:
            return
        self._worker.stop()
        exc, self._worker = self._worker.exception, None
        if exc is not None:
            raise self._attach_partial_reports(exc)

    def drain(self) -> Tuple[FlushReport, ...]:
        """Block until every enqueued background flush has run; returns
        (and clears) their reports. A captured worker exception re-raises
        here instead, carrying the reports of the flushes that DID run
        before the failure as ``exc.partial_reports`` (and clearing them,
        so they never leak into a later drain). Requests enqueued after a
        failure are acknowledged but dropped until a drain clears it —
        their rows stay buffered in the rings. No-op (empty tuple)
        without a worker."""
        if self._worker is None:
            return ()
        with obs_tracing.span("stream.drain"):
            self._worker.requests.join()
        if self._worker.exception is not None:
            exc, self._worker.exception = self._worker.exception, None
            raise self._attach_partial_reports(exc)
        with self._lock:
            reports, self._bg_reports = tuple(self._bg_reports), []
        return reports

    def _attach_partial_reports(self, exc: BaseException) -> BaseException:
        with self._lock:
            exc.partial_reports = tuple(self._bg_reports)
            self._bg_reports = []
        return exc

    def _trigger_flush(self, *, force: bool, reason: str
                       ) -> Optional[FlushReport]:
        """Route a flush trigger: enqueue to the worker or run
        synchronously. Every trigger is enqueued (the worker coalesces
        whatever is queued into one flush), so a producer that outruns
        the device fills the bounded queue and blocks on ``put`` —
        genuine backpressure. Called OUTSIDE the service lock, so a
        blocked producer never stalls the worker."""
        if self.background_active:
            self._worker.submit(force, reason)
            return None
        return self._flush_sync(force=force, reason=reason)

    # -- durability plumbing ------------------------------------------------
    def attach_wal(self, wal) -> None:
        """Attach the write-ahead log new events are appended to."""
        self._wal = wal

    def _log(self, record: dict) -> None:
        if self._wal is not None and not self._replaying:
            self._wal.append(record)

    # -- membership ---------------------------------------------------------
    def users(self):
        return self.store.users()

    def _coalescer(self, user) -> Coalescer:
        return self._coalescers[user]

    def admit(self, user, *, scale: Optional[float] = None) -> int:
        """Admit ``user`` into the fleet (idempotent)."""
        with self._lock:
            # Key on SERVICE membership, not store membership: a user
            # admitted directly on the FactorStore still needs its
            # coalescer here.
            known = user in self._coalescers
            slot = self.store.admit(user, scale=scale, tick=self.tick_count)
            if not known:
                # block= keys the ring to the fleet's storage contract: a
                # structured fleet's rows are anchor-validated at push
                # time (None for dense fleets — no contract to enforce).
                self._coalescers[user] = Coalescer(
                    self.store.n, width=self.store.width,
                    capacity=self._ring_capacity, deadline=self.deadline,
                    dtype=self.store.row_dtype, block=self.store.block)
                self._log({"op": "admit", "user": user, "scale": scale})
            return slot

    def evict(self, user) -> None:
        """Remove a user: pending buffer rows and scheduled downdates are
        DROPPED (the slot's statistics go with it — there is nothing left
        to keep consistent)."""
        with self._lock:
            self.store.evict(user)
            del self._coalescers[user]
            self._schedule = [e for e in self._schedule if e[2] != user]
            heapq.heapify(self._schedule)
            self._log({"op": "evict", "user": user})

    def evict_idle(self, *, max_idle: int) -> tuple:
        with self._lock:
            stale = tuple(
                u for u in self.store.users()
                if self.tick_count - self.store.last_used(u) > max_idle)
            for u in stale:
                self.evict(u)
            return stale

    # -- traffic ------------------------------------------------------------
    def push(self, user, v, *, sign: int = 1) -> Optional[FlushReport]:
        """Buffer one rank-1 observation; may auto-flush (report returned
        when the flush ran synchronously; a background worker returns the
        report via ``drain()`` instead).

        ``sign=+1`` is ``push_update``, ``-1`` ``push_downdate`` — the
        deferred mutation lands at the next flush, coalesced into that
        sign's rank-k block.
        """
        with self._lock:
            self.admit(user)
            v = np.asarray(v, self.store.row_dtype).reshape(-1)
            # Buffer BEFORE logging: a push that raises (full ring, wrong
            # dim) is survivable live, so it must not leave a poison
            # record that would re-raise inside every future replay.
            self._coalescers[user].push(v, sign=sign, tick=self.tick_count)
            self._log({"op": "push", "user": user, "sign": sign,
                       **_encode_row(v)})
            ready = (self.auto_flush and not self._replaying
                     and self._coalescers[user].ready())
        if ready:
            return self._trigger_flush(force=False, reason="width")
        return None

    def push_update(self, user, v) -> Optional[FlushReport]:
        return self.push(user, v, sign=1)

    def push_downdate(self, user, v) -> Optional[FlushReport]:
        return self.push(user, v, sign=-1)

    def tick(self) -> Optional[FlushReport]:
        """Advance the logical clock; fire deadline/window flushes."""
        with self._lock:
            self.tick_count += 1
            self._log({"op": "tick"})
            if self._replaying:
                return None
            due = self._schedule and self._schedule[0][0] <= self.tick_count
            expired = any(c.expired(self.tick_count)
                          for c in self._coalescers.values())
        if due or expired:
            return self._trigger_flush(force=False, reason="deadline")
        return None

    def decay(self, alpha) -> None:
        """Exact exponential forgetting across the fleet (``scale``)."""
        with self._lock:
            self._log({"op": "decay", "alpha": float(alpha)})
            self.store.decay(alpha)

    # -- window forgetting ---------------------------------------------------
    def _schedule_row(self, user, v, *, due: int) -> None:
        heapq.heappush(
            self._schedule,
            (due, self._sched_seq, user,
             np.asarray(v, self.store.row_dtype)))
        self._sched_seq += 1

    def scheduled(self) -> int:
        """Rows awaiting their window-expiry downdate."""
        return len(self._schedule)

    # -- the flush -----------------------------------------------------------
    def flush(self, *, force: bool = False, reason: str = "manual"
              ) -> FlushReport:
        """Drain + absorb: the coalescer's sign schedule over the fleet.

        Selection: users whose rings hit the width trigger, whose buffers
        passed the deadline, or who received due window-downdates; with
        ``force`` every user with any pending row. Each round builds one
        zero-padded block per sign and dispatches at most one batched
        mutation per block (updates first, then guarded downdates).
        Always synchronous — the caller's explicit flush runs in the
        caller's thread even when a background worker is active.
        """
        return self._flush_sync(force=force, reason=reason)

    def _flush_sync(self, *, force: bool, reason: str) -> FlushReport:
        with self._lock:
            t0 = time.perf_counter()
            with obs_tracing.span("stream.flush", reason=reason) as ev:
                report = self._flush_locked(force=force, reason=reason)
                ev.labels.update(reason=report.reason,
                                 mutations=report.mutations,
                                 rounds=report.rounds,
                                 empty=report.empty)
            if not report.empty:
                # Empty flushes (nothing selected) are free no-ops; letting
                # them into the histogram would drown the p50 in noise.
                obs_metrics.histogram(
                    "repro.stream.flush_seconds",
                    reason=report.reason).observe(time.perf_counter() - t0)
            if self._worker is not None and threading.current_thread() \
                    is self._worker:
                self._bg_reports.append(report)
            return report

    def _flush_locked(self, *, force: bool, reason: str) -> FlushReport:
        due_ready = bool(self._schedule
                         and self._schedule[0][0] <= self.tick_count)
        trigger = {u for u, c in self._coalescers.items()
                   if (force and c.pending) or c.ready()
                   or c.expired(self.tick_count)}
        report = FlushReport(reason="force" if force else reason)
        if not due_ready and not trigger:
            return report
        # Log BEFORE mutating: a crash mid-flush replays the whole flush
        # (selection recomputes identically from the replayed state).
        self._log({"op": "flush", "force": force, "reason": report.reason})

        # Due window rows become ordinary buffered downdates first, so ONE
        # code path (the ring drain) feeds the mutation — and the WAL
        # replay, which re-runs this method, reproduces it exactly. A
        # backlog of due groups (missed heartbeats) drains rounds early to
        # make ring room rather than overflowing.
        must: set = set()
        while self._schedule and self._schedule[0][0] <= self.tick_count:
            _, _, user, row = heapq.heappop(self._schedule)
            if user not in self._coalescers:
                continue  # evicted after scheduling: nothing left to forget
            c = self._coalescers[user]
            if c.down_free == 0:
                self._run_flush({user}, report)
            c.push_downdate(row, tick=self.tick_count)
            must.add(user)

        return self._run_flush(trigger | must, report)

    def _run_flush(self, selected: set, report: FlushReport) -> FlushReport:
        from repro_torch.stream import store as store_mod

        store = self.store
        pending = set(selected)
        while pending and report.rounds < _MAX_FLUSH_ROUNDS:
            t_co = time.perf_counter()
            up_rows: Dict[int, np.ndarray] = {}
            dn_rows: Dict[int, np.ndarray] = {}
            dn_users: Dict[object, int] = {}
            for u in sorted(pending, key=store.slot):
                blocks = self._coalescers[u].drain(tick=self.tick_count)
                s = store.slot(u)
                if blocks.up.shape[0]:
                    up_rows[s] = blocks.up
                    report.absorbed[u] = (report.absorbed.get(u, 0)
                                          + blocks.up.shape[0])
                    if self.window is not None:
                        for row in blocks.up:
                            self._schedule_row(
                                u, row, due=self.tick_count + self.window)
                if blocks.down.shape[0]:
                    dn_rows[s] = blocks.down
                    dn_users[u] = s
                    report.downdated[u] = (report.downdated.get(u, 0)
                                           + blocks.down.shape[0])
            pending = {u for u in pending if self._coalescers[u].pending}

            Vup = store.pad_block(up_rows) if up_rows else None
            Vdn = store.pad_block(dn_rows) if dn_rows else None
            report.t_coalesce_s += time.perf_counter() - t_co
            if Vup is None and Vdn is None:
                break
            for sign, blk in (("up", Vup), ("down", Vdn)):
                if blk is not None:
                    w = int(blk.shape[-1])
                    report.widths += (w,)
                    obs_metrics.histogram(
                        "repro.stream.coalesce_width",
                        buckets=obs_metrics.WIDTH_BUCKETS,
                        sign=sign).observe(w)
            before = store_mod.mutations_issued()
            traces_before = store_mod.traces_counted()
            t_mu = time.perf_counter()
            ok = store.apply(Vup, Vdn)
            report.t_mutate_s += time.perf_counter() - t_mu
            # A step built INSIDE flush dispatch means a serving-path shape
            # missed the warmed steps — the event the retrace guard exists
            # to forbid. Warmup builds happen outside flushes, so they never
            # land here.
            retraced = store_mod.traces_counted() - traces_before
            if retraced:
                obs_metrics.counter("repro.stream.retraces").inc(retraced)
                obs_tracing.instant("stream.retrace", steps=retraced,
                                    reason=report.reason)
            report.mutations += store_mod.mutations_issued() - before
            report.rounds += 1
            if ok is not None:
                ok_host = ok.cpu().numpy()
                for u, s in dn_users.items():
                    verdict = bool(ok_host[s])
                    if not verdict:
                        obs_metrics.counter("repro.stream.guard_rejects"
                                            ).inc()
                    report.downdate_ok[u] = bool(
                        report.downdate_ok.get(u, True) and verdict)
        return report

    # -- reads ---------------------------------------------------------------
    def solve(self, user, b):
        """Solve against one user's maintained factor (reflects flushed
        state only — pending buffer rows are not yet absorbed)."""
        with self._lock:
            return self.store.factor_for(user).solve(b)

    def pending(self, user) -> int:
        return self._coalescers[user].pending if user in self._coalescers \
            else 0

    def __repr__(self):
        buffered = sum(c.pending for c in self._coalescers.values())
        return (f"StreamService(users={self.store.active}, "
                f"tick={self.tick_count}, buffered={buffered}, "
                f"scheduled={len(self._schedule)}, window={self.window}, "
                f"background={self.background_active}, "
                f"store={self.store!r})")


def _encode_row(v: np.ndarray) -> dict:
    """WAL row encoding — the codec lives in ``repro_torch.stream.durability``;
    the call-time import avoids the module cycle (durability imports the
    service type for restore)."""
    from repro_torch.stream.durability import encode_row

    return encode_row(v)
