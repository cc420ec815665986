"""``Coalescer``: per-factor ring buffers turning rank-1 traffic into
rank-k flushes.

Port of ``repro.stream.coalescer``: host-side numpy, the same rings, drain
order, deadline clock and ``block=`` anchor keying (through the port's own
``repro_torch.core.structure.anchor_block``).

The modification is bandwidth-bound, so the only real lever is rank-k
amortization (~7x at k=16 in the paper's measurements), yet streaming
consumers produce *rank-1* observations, one per event. The coalescer
buffers ``push_update(v)`` / ``push_downdate(v)`` rank-1 rows in
fixed-capacity ring buffers (one per sign) and drains them as full-width
blocks when a ring reaches the coalesce width (default k=16), a deadline
expires, or an explicit ``flush`` fires.

Flushes are **sign-scheduled**: the update block is absorbed first as ONE
fused rank-k update, then the downdate block through ``downdate_guarded``.
The reorder is sound because the target matrix
``A + sum u u^T - sum d d^T`` does not depend on application order and the
Cholesky factor of an SPD matrix with positive diagonal is unique;
updates-first is the schedule that keeps the most streams SPD
mid-application.

The device work happens in whatever absorbs the drained blocks:
``flush_into`` for a single ``CholFactor``,
``repro_torch.stream.store.FactorStore`` for a fleet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

DEFAULT_WIDTH = 16  # the paper's rank-k sweet spot


class RingBuffer:
    """Fixed-capacity FIFO ring of rank-1 rows (host memory, no realloc).

    Rows are stored in a preallocated ``(capacity, n)`` array; ``push``
    appends, ``drain`` removes the oldest ``limit`` rows in arrival order.
    The ring never reallocates in steady state — the serving loop's push
    path is O(n) per row with zero garbage.
    """

    def __init__(self, n: int, capacity: int, dtype=np.float32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._buf = np.zeros((capacity, n), dtype=dtype)
        self._head = 0  # index of the oldest row
        self._count = 0

    @property
    def capacity(self) -> int:
        return self._buf.shape[0]

    @property
    def count(self) -> int:
        return self._count

    @property
    def full(self) -> bool:
        return self._count == self.capacity

    def push(self, v) -> None:
        v = np.asarray(v, dtype=self._buf.dtype).reshape(-1)
        if v.shape[0] != self._buf.shape[1]:
            raise ValueError(
                f"row has dim {v.shape[0]}, ring expects {self._buf.shape[1]}"
            )
        if self.full:
            raise OverflowError(
                f"ring buffer full (capacity {self.capacity}); flush before "
                "pushing more"
            )
        tail = (self._head + self._count) % self.capacity
        self._buf[tail] = v
        self._count += 1

    def drain(self, limit: Optional[int] = None) -> np.ndarray:
        """Remove and return the oldest ``limit`` rows, arrival order."""
        m = self._count if limit is None else min(limit, self._count)
        idx = (self._head + np.arange(m)) % self.capacity
        out = self._buf[idx].copy()
        self._head = (self._head + m) % self.capacity
        self._count -= m
        return out

    def peek(self) -> np.ndarray:
        """All buffered rows, arrival order, without removing them."""
        idx = (self._head + np.arange(self._count)) % self.capacity
        return self._buf[idx].copy()


@dataclasses.dataclass
class DrainResult:
    """One sign-scheduled drain: the update block, then the downdate block.

    ``up_anchors``/``down_anchors`` carry each row's anchor block-row
    (``repro_torch.core.structure.anchor_block``) when the coalescer was keyed
    to a structured factor's block size; ``None`` for dense coalescers.
    Anchors ride in ring order, aligned row-for-row with the blocks.
    """

    up: np.ndarray    # (k_up, n) rows, arrival order (may be empty)
    down: np.ndarray  # (k_dn, n) rows, arrival order (may be empty)
    up_anchors: Optional[Tuple[Optional[int], ...]] = None
    down_anchors: Optional[Tuple[Optional[int], ...]] = None

    @property
    def empty(self) -> bool:
        return self.up.shape[0] == 0 and self.down.shape[0] == 0


class Coalescer:
    """Buffer rank-1 observations for ONE factor; drain as rank-k blocks.

    Args:
      n: row dimension (must match the factor).
      width: coalesce width k — a drain returns at most ``width`` rows per
        sign, and ``ready`` fires when either ring holds ``width`` rows.
      capacity: ring capacity per sign (default ``2 * width``: headroom for
        deferred window-downdates landing on top of explicit traffic).
      deadline: optional staleness bound in ticks — ``expired(tick)`` is
        True once the oldest pending row has waited ``deadline`` ticks.
      dtype: host buffer dtype (rows are cast on push).
      block: block size b of the target factor's ``BlockTriDiagStorage``
        (None for dense factors). When set, every pushed row is keyed to
        its anchor block (``repro_torch.core.structure.anchor_block``) at
        ``push()`` time — a row violating the block-local contract raises
        HERE, at ingest, instead of corrupting the storage class inside
        the kernel rounds later. Anchors travel with the drained blocks
        (``DrainResult.up_anchors`` / ``down_anchors``).
    """

    def __init__(self, n: int, *, width: int = DEFAULT_WIDTH,
                 capacity: Optional[int] = None,
                 deadline: Optional[int] = None, dtype=np.float32,
                 block: Optional[int] = None):
        if width < 1:
            raise ValueError(f"width must be >= 1, got {width}")
        if block is not None and (block < 1 or n % int(block)):
            raise ValueError(
                f"block= must divide n={n}, got block={block}")
        self.n = n
        self.width = width
        self.deadline = deadline
        self.block = int(block) if block is not None else None
        cap = 2 * width if capacity is None else capacity
        if cap < width:
            raise ValueError(f"capacity {cap} < width {width}")
        self._up = RingBuffer(n, cap, dtype)
        self._down = RingBuffer(n, cap, dtype)
        # Anchor queues ride beside the rings in the same FIFO order
        # (plain lists: drains pop from the front, pushes append).
        self._up_anchors: list = []
        self._down_anchors: list = []
        self._first_tick: Optional[int] = None

    def _anchor_of(self, v) -> Optional[int]:
        """The row's anchor block under the block-local contract, or None
        when this coalescer feeds a dense factor (no contract to key)."""
        if self.block is None:
            return None
        from repro_torch.core.structure import anchor_block

        return anchor_block(v, self.block)

    # -- push ---------------------------------------------------------------
    def push_update(self, v, *, tick: int = 0) -> None:
        """Buffer a rank-1 update row (``+ v v^T`` at the next flush)."""
        anchor = self._anchor_of(v)  # contract check BEFORE mutating state
        self._up.push(v)
        self._up_anchors.append(anchor)
        if self._first_tick is None:
            self._first_tick = tick

    def push_downdate(self, v, *, tick: int = 0) -> None:
        """Buffer a rank-1 downdate row (``- v v^T`` at the next flush)."""
        anchor = self._anchor_of(v)
        self._down.push(v)
        self._down_anchors.append(anchor)
        if self._first_tick is None:
            self._first_tick = tick

    def push(self, v, *, sign: int = 1, tick: int = 0) -> None:
        if sign == 1:
            self.push_update(v, tick=tick)
        elif sign == -1:
            self.push_downdate(v, tick=tick)
        else:
            raise ValueError(f"sign must be +1 or -1, got {sign}")

    # -- flush policy -------------------------------------------------------
    @property
    def pending(self) -> int:
        return self._up.count + self._down.count

    @property
    def pending_up(self) -> int:
        return self._up.count

    @property
    def pending_down(self) -> int:
        return self._down.count

    @property
    def down_free(self) -> int:
        """Free downdate-ring slots (deferred window rows land here)."""
        return self._down.capacity - self._down.count

    def ready(self) -> bool:
        """Width trigger: either sign block has a full rank-k ready."""
        return (self._up.count >= self.width
                or self._down.count >= self.width)

    def expired(self, tick: int) -> bool:
        """Deadline trigger: the oldest pending row is too stale."""
        return (self.deadline is not None and self.pending > 0
                and self._first_tick is not None
                and tick - self._first_tick >= self.deadline)

    # -- drain --------------------------------------------------------------
    def drain(self, *, tick: int = 0, limit: Optional[int] = None
              ) -> DrainResult:
        """Remove up to ``width`` rows per sign (arrival order per ring).

        Sign scheduling happens at *application* time: callers absorb
        ``up`` first (one fused rank-k update), then ``down`` through the
        feasibility guard. Rows beyond ``width`` stay buffered; the
        staleness clock restarts at ``tick`` when anything remains.
        """
        lim = self.width if limit is None else limit
        up = self._up.drain(lim)
        down = self._down.drain(lim)
        if self.block is None:
            ua = da = None
        else:
            ua = tuple(self._up_anchors[:up.shape[0]])
            da = tuple(self._down_anchors[:down.shape[0]])
        del self._up_anchors[:up.shape[0]]
        del self._down_anchors[:down.shape[0]]
        res = DrainResult(up=up, down=down, up_anchors=ua, down_anchors=da)
        self._first_tick = tick if self.pending else None
        return res

    def peek(self) -> Tuple[np.ndarray, np.ndarray]:
        """Buffered (up_rows, down_rows) without draining — durability uses
        this to write the replay-log head at checkpoint time."""
        return self._up.peek(), self._down.peek()

    @property
    def first_tick(self) -> Optional[int]:
        return self._first_tick

    # -- single-factor convenience ------------------------------------------
    def _pad_sign_block(self, rows: np.ndarray, pad_to: Optional[int],
                        factor_block: Optional[int]) -> np.ndarray:
        """``(k, n)`` rows -> ``(n, >=k)`` V, zero-padded to ``pad_to``
        columns for shape-stable dispatch.

        Padding is storage-aware: the pad is zero COLUMNS of V — exact
        no-ops for both signs and trivially block-local (an all-zero
        column has no support, so it anchors nowhere) — never zero ROWS
        of a densified (n, n) carrier. A structured flush with a
        contract-keyed coalescer therefore pads without leaving the
        storage class; an un-keyed coalescer (``block=None``) flushing a
        structured factor re-validates the REAL columns here so the
        contract still fails at the flush boundary, not in the kernel.
        """
        V = rows.T  # (n, k)
        if factor_block is not None and self.block is None:
            from repro_torch.core.structure import assert_blocklocal

            if V.shape[1]:
                assert_blocklocal(V, factor_block)
        if pad_to is not None and V.shape[1] < pad_to:
            pad = np.zeros((self.n, pad_to - V.shape[1]), V.dtype)
            V = np.concatenate([V, pad], axis=1)
        return V

    def flush_into(self, factor, *, pad_to: Optional[int] = None):
        """Drain and absorb into a single (non-batched) ``CholFactor``.

        Returns ``(factor', ok)``: the update block is applied first as one
        rank-k update, then the downdate block via ``downdate_guarded``
        (``ok`` is True when no downdate was pending). The fleet path lives
        in ``repro_torch.stream.store.FactorStore``; this is the one-factor
        analogue for scripts and tests.

        ``pad_to``: zero-pad each non-empty sign block to this many
        columns (a width bucket) so mixed-width flushes share one
        executable shape. The pad is always zero V-columns — exact no-ops
        and block-local for structured factors (see ``_pad_sign_block``)
        — so shape stabilisation never densifies a structured flush.
        """
        import torch

        structured = getattr(factor, "structure", "dense") != "dense"
        fblock = factor.storage.block if structured else None
        blocks = self.drain()
        ok = True
        if blocks.up.shape[0]:
            V = self._pad_sign_block(blocks.up, pad_to, fblock)
            factor = factor.update(torch.as_tensor(V, device=factor.device))
        if blocks.down.shape[0]:
            V = self._pad_sign_block(blocks.down, pad_to, fblock)
            factor, ok = factor.downdate_guarded(
                torch.as_tensor(V, device=factor.device))
        return factor, ok

    def __repr__(self):
        key = f", block={self.block}" if self.block is not None else ""
        return (f"Coalescer(n={self.n}, width={self.width}{key}, "
                f"pending_up={self._up.count}, pending_down={self._down.count})")
