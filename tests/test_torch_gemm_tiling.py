"""The K split of the cascade's transform-GEMM apply
(``csrc/gemm_tile.cuh``), as ``repro_torch.kernels._launch`` picks it and
deals the slices to a cluster's ranks, the upper tiles the sharded kernel
multiplies, and the two kernels' work counts. These run on the CPU; the
kernels' own grids, shared memory and skip are checked where they are
defined (``static_assert`` in the source) and on the card
(``tests/test_torch_cuda.py``, the edge cases and the tile's layout).

* the split is a legal cluster size the card can place, and its ranks sum
  every K slice exactly once, dealt by cost;
* the triangular skip drops only slices whose T values are zero;
* the upper tiles are the tiles right of the diagonal.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import _launch as LA
from repro_torch.kernels import cholupdate as K
from repro_torch.kernels import sharded as SH


@pytest.mark.parametrize("B,w,P,k", [
    (1, 4864, 256, 16),   # n = 5000, panel 0
    (1, 256, 256, 16),    # the narrow tail
    (1, 300, 256, 16),    # w not a multiple of the strip
    (2, 200, 100, 5),     # P + k not a multiple of the row tile
    (1, 512, 256, 32),
    (64, 768, 256, 16),   # the B = 64 fleet
    (3, 12, 4, 16),
    (1, 100, 64, 1),
])
@pytest.mark.parametrize("capacity", [(132, 66, 30), (8, 4, 2)])
def test_cascade_split_sums_every_slice_once(B, w, P, k, capacity):
    """The split is a cluster size the card places, and the boundaries the
    wrapper packs for the kernel give each rank a run of K slices, at
    least one, the ranks together every slice once."""
    split = LA.gemm_split(B, w, P, k, capacity)
    assert split in LA.GEMM_SPLITS and split <= LA.gemm_slices(P, k)
    assert capacity[LA.GEMM_SPLITS.index(split)] >= 1
    n = LA.gemm_slices(P, k)
    packed = LA.gemm_pack_bounds(LA.gemm_split_bounds(P, k, P + k, split))
    # gemm_tile.cuh rank_slices: boundary j in byte j, the first lowest.
    edges = [0] + [(packed >> (8 * j)) & 255 for j in range(split - 1)] + [n]
    ranges = list(zip(edges, edges[1:]))
    assert all(lo < hi for lo, hi in ranges)
    assert sorted(s for lo, hi in ranges for s in range(lo, hi)) == \
        list(range(n))


def test_split_takes_the_fewest_waves_then_the_most_ctas():
    # An H100: 132 CTAs at once, 66 clusters of 2, ~30 of 4 (a cluster
    # stays inside one GPC).
    cap = (132, 66, 30)
    assert LA.gemm_split(1, 4864, 256, 16, cap) == 1     # 76 strips
    assert LA.gemm_split(1, 4096, 256, 16, cap) == 2     # 64
    assert LA.gemm_split(1, 2048, 256, 16, cap) == 2     # 32 > 30
    assert LA.gemm_split(1, 1792, 256, 16, cap) == 4     # 28
    assert LA.gemm_split(1, 256, 256, 16, cap) == 4
    assert LA.gemm_split(64, 768, 256, 16, cap) == 1     # 768: 6 waves
    # Never more ranks than K slices (P + k = 20: two slices).
    assert LA.gemm_split(1, 12, 4, 16, cap) == 2
    assert LA.gemm_split(1, 12, 4, 1, cap) == 1
    # A card that cannot place a cluster runs without one; one that cannot
    # place a CTA raises.
    assert LA.gemm_split(1, 256, 256, 16, (132, 0, 0)) == 1
    assert LA.gemm_split(1, 256, 256, 16, (132, 66, 0)) == 2
    assert LA.gemm_split(1, 256, 256, 16, (132, 0, 30)) == 4
    with pytest.raises(ValueError):
        LA.gemm_split(1, 12, 4, 1, (0, 1, 1))
    for w in range(1, 6000, 97):
        for P, k in ((256, 16), (256, 32), (100, 5), (8, 1)):
            s = LA.gemm_split(1, w, P, k, cap)
            # A cluster of at most 8 CTAs is portable on Hopper.
            assert s in (1, 2, 4) and s <= 8 and s <= LA.gemm_slices(P, k)
            strips = -(-w // LA.GEMM_BN)
            waves = {o: -(-strips // c) for o, c in zip(LA.GEMM_SPLITS, cap)
                     if o <= LA.gemm_slices(P, k)}
            assert waves[s] == min(waves.values())
            assert s == max(o for o, v in waves.items() if v == waves[s])


def count_split_cost(P, k, rows_out, split):
    """The busiest rank's cost with the slices dealt by count."""
    n = LA.gemm_slices(P, k)
    cost = [LA.gemm_slice_cost(s, P, rows_out) for s in range(n)]
    return max(sum(cost[r * n // split:(r + 1) * n // split])
               for r in range(split))


@pytest.mark.parametrize("P,k,rows_out", [
    (256, 16, 272), (256, 32, 288), (100, 5, 105), (64, 1, 65), (4, 16, 20),
    (40, 8, 48), (256, 16, 256)])
def test_split_bounds_deal_the_slices_by_cost(P, k, rows_out):
    """Every rank keeps at least one slice, the ranks take every slice
    once, and the busiest rank costs no more than with the slices dealt by
    count."""
    n = LA.gemm_slices(P, k)
    cost = [LA.gemm_slice_cost(s, P, rows_out) for s in range(n)]
    for split in LA.GEMM_SPLITS:
        if split > n:
            with pytest.raises(ValueError):
                LA.gemm_split_bounds(P, k, rows_out, split)
            continue
        bounds = LA.gemm_split_bounds(P, k, rows_out, split)
        assert len(bounds) == split - 1
        edges = (0, *bounds, n)
        assert all(a < b for a, b in zip(edges, edges[1:]))
        ranges = list(zip(edges, edges[1:]))
        busiest = max(sum(cost[lo:hi]) for lo, hi in ranges)
        assert busiest <= count_split_cost(P, k, rows_out, split)
        packed = LA.gemm_pack_bounds(bounds)
        assert [(packed >> (8 * j)) & 255 for j in range(split - 1)] == \
            list(bounds) and packed < 1 << (8 * (split - 1))


def test_slice_cost_at_the_smoke_panel():
    """P = 256, k = 16, the vt rows applied: the busiest scheduler's 16-row
    tiles per slice, by hand from GEMM_WARP_BLOCKS (schedulers 0-3 hold
    blocks {8, 0, 1}, {7, 2}, {6, 3}, {5, 4}; tile t of T_rr multiplies
    slices 0..t, every tile the vt slice 16)."""
    cost = [LA.gemm_slice_cost(s, 256, 272) for s in range(17)]
    assert cost == [5, 4, 4, 4, 4, 4, 4, 4, 4, 3, 2, 2, 2, 2, 2, 1, 5]
    # By count rank 0 of two takes 33 of the 56; by cost 29.
    assert LA.gemm_split_bounds(256, 16, 272, 2) == (7,)
    assert count_split_cost(256, 16, 272, 2) == 33
    assert LA.gemm_split_bounds(256, 16, 272, 4) == (3, 7, 11)
    assert count_split_cost(256, 16, 272, 4) == 17


def test_warps_take_every_row_block_once_and_balance_the_schedulers():
    """Each table deals the 9 blocks of 32 rows to the 9 warps, and at
    n = 5000's panel (P = 256, k = 16) each scheduler (warp % 4) gets
    about a quarter of the K slices the warps multiply (a warp issues
    while either of its two 16-row tiles multiplies a slice)."""
    for form, rows_out in (("vt", 272), ("panel", 256)):
        blocks = LA.GEMM_WARP_BLOCKS[form]
        assert sorted(blocks) == list(range(9))
        load = [0, 0, 0, 0]
        for warp, rb in enumerate(blocks):
            load[warp % 4] += sum(
                any(LA.gemm_slice_needed(r0, s, 256)
                    for r0 in (32 * rb, 32 * rb + 16) if r0 < rows_out)
                for s in range(LA.gemm_slices(256, 16)))
        assert max(load) <= 1.05 * sum(load) / 4, (form, load)


def lower_triangular_t(P, k, seed=0):
    """A transform with the structure diag_block emits: T_rr lower
    triangular, the other blocks dense, every allowed entry nonzero."""
    rng = np.random.default_rng(seed)
    T = rng.uniform(0.5, 1.5, size=(P + k, P + k))
    T[:P, :P] = np.tril(T[:P, :P])
    return T


@pytest.mark.parametrize("P,k,rows_out", [
    (256, 16, 272), (256, 16, 256), (256, 32, 288), (100, 5, 105),
    (100, 5, 100), (64, 1, 65), (4, 16, 20), (40, 8, 48)])
# Rows a skip decision covers: a 16-row MMA tile, a thread's 8 rows of the
# f64 FFMA form.
@pytest.mark.parametrize("rows", [8, 16])
def test_triangular_skip_drops_only_zero_slices(P, k, rows_out, rows):
    T = lower_triangular_t(P, k)
    bk = LA.GEMM_BK
    for s in range(LA.gemm_slices(P, k)):
        cols = slice(s * bk, min((s + 1) * bk, P + k))
        for r0 in range(0, rows_out, rows):
            block = T[r0:min(r0 + rows, rows_out), cols]
            if not LA.gemm_slice_needed(r0, s, P, rows):
                assert not block.any()
        # Tight inside T_rr: a slice wholly left of column P is skipped by
        # exactly the row tiles whose rows it holds no nonzero of.
        if (s + 1) * bk <= P:
            for r0 in range(0, min(rows_out, P), rows):
                if r0 + rows <= P:
                    assert LA.gemm_slice_needed(r0, s, P, rows) == bool(
                        T[r0:r0 + rows, cols].any())


@pytest.mark.parametrize("n_panels,nt,tile_off,P", [
    (20, 20, 0, 256),   # n = 5120 on one rank: 190 upper tiles
    (20, 5, 5, 256),    # rank 1 of four
    (20, 5, 15, 256),   # rank 3 of four
    (4, 1, 3, 100),
    (4, 1, 3, 40),
    (4, 4, 0, 64),
    (3, 2, 7, 32),      # a shard wholly right of every row panel
    (6, 2, 0, 32),      # lower tiles in the last row panels
    (4, 2, 0, 64),      # the last row panel holds no upper tile
    (4, 1, 0, 64),      # no upper tile
])
def test_upper_tiles_are_right_of_the_diagonal(n_panels, nt, tile_off, P):
    """The tiles the sharded kernel multiplies, per row panel: those whose
    global tile lies right of the panel's diagonal; the work count takes
    the same tiles."""
    ups = LA.upper_tiles(n_panels, nt, tile_off)
    assert ups == [sum(p < tile_off + t for t in range(nt))
                   for p in range(n_panels)]
    # The upper tiles of a panel are its last ones.
    assert all(0 <= u <= nt for u in ups)
    assert SH.panel_phase_work(n_panels * P, nt * P, P, 16, tile_off=tile_off,
                               storage_dtype=torch.float32)[1] == sum(ups) * (
        P * P * (P + 1) + 2 * P * 16 * P)


@pytest.mark.parametrize("P,k", [(8, 3), (16, 16), (32, 1)])
def test_gemm_apply_work_counts_the_nonzeros_of_t(P, k):
    """The operations of panel_apply_gemm_work are two per nonzero of a T
    that the diagonal pass emits, per column."""
    rng = np.random.default_rng(P + k)
    A = rng.uniform(size=(P, P))
    L = torch.from_numpy(np.linalg.cholesky(A.T @ A + P * np.eye(P)).T)
    vtd = torch.from_numpy(rng.uniform(size=(k, P)))
    _, _, _, T = K._diag_block_plain(L, vtd, 1, None)
    nnz = int(torch.count_nonzero(T))
    widths = [5 * P, 3 * P, P]
    nbytes, ops = K.panel_apply_gemm_work(P, k, widths,
                                          storage_dtype=torch.float32)
    assert ops == sum(2 * nnz * w for w in widths)
    assert nbytes == sum(4 * (2 * (P + k) * w + (P + k) ** 2)
                         for w in widths)
    # bf16 storage halves the panel's bytes, not T's (fp32 accumulation).
    nb16, ops16 = K.panel_apply_gemm_work(P, k, widths,
                                          storage_dtype=torch.bfloat16)
    assert ops16 == ops and nb16 == sum(2 * 2 * (P + k) * w
                                        + 4 * (P + k) ** 2 for w in widths)


def test_gemm_apply_work_at_the_smoke_shapes():
    """n = 5000 padded to 5120, P = 256, k = 16: 19 applies over widths
    4864 .. 256; 4.01 GFLOP and 111.46 MB. As 3xTF32 (495 TFLOP/s of TF32
    over three passes) the operations take 0.0243 ms, under the bytes'
    0.0333 ms at 3.35 TB/s: the bound is the bytes'."""
    widths = [5120 - r0 - 256 for r0 in range(0, 5120 - 256, 256)]
    assert len(widths) == 19 and widths[0] == 4864 and widths[-1] == 256
    nbytes, ops = K.panel_apply_gemm_work(256, 16, widths,
                                          storage_dtype=torch.float32)
    assert ops == 2 * (256 * 257 // 2 + 2 * 256 * 16 + 16 * 17 // 2) * 48640
    assert abs(ops / (495e12 / 3) * 1e3 - 0.0243) < 5e-5
    assert abs(nbytes / 1e6 - 111.46) < 0.01
    assert abs(nbytes / 3.35e12 * 1e3 - 0.0333) < 5e-5
