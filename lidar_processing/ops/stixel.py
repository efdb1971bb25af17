"""Exact Euclidean clustering via stixel-graph connected components.

Data-parallel replacement for the reference's KD-tree + BFS FEC
(ref: src/clustering.cpp:47-125): identical contract to ops/clustering.py
(exact CC of the d² <= distance_squared radius graph, labels canonicalized
by minimum original point index) built from fixed-shape device primitives
— multi-operand sorts, segmented scans over sorted runs, contiguous block
gathers, batched block distance math, and a small contracted graph for
label propagation:

  1. ONE sort of all points by (xy-column, z-cell) linear key. Cells are
     h = R/sqrt(3) cubes => every cell is a clique of the radius graph
     (diagonal == R). Columns (xy cells) are contiguous point runs.
  2. Intra-column structure from DENSE shifted comparisons of consecutive
     cell runs: consecutive-occupied (i,i+1) and skip-one (i,i+2) cell pairs
     with iz difference <= 2 are the only possible intra-column links
     (a 2-cell z gap already exceeds R). Links are verified exactly by
     batched block min-distance tests.
  3. Columns contract into SUPERNODES (stixels): maximal runs of cells
     chained by verified (i,i+1) links. Supernodes are contiguous point
     runs; verified (i,i+2) links crossing a supernode boundary become
     edges. ~16k cells contract to ~7k supernodes on KITTI frames.
  4. Inter-column candidate pairs come from ONE small sort-merge: column
     keys + 12 symmetric xy-offsets (the 5x5 window half), ~90k probe rows.
     Matched column pairs expand to supernode pairs (tiered static
     expansion up to 16x16 for the rare multi-supernode columns — KITTI
     peaks at 9 supernodes/column; a counter fires past 16).
  5. Every candidate pair is classified with per-supernode AABB + first-
     point data fetched as ONE coalesced row gather: AABB gap > R =>
     impossible; first-point distance <= R => certain edge; else the pair
     joins the tiered exact block tests (contiguous (P,cap,3) gathers,
     batched min-d² reductions), so the edge set is exactly the
     radius-graph connectivity between supernode point sets.
  6. CC on the supernode graph: min-label hooking with pointer jumping to
     a fixpoint (ops/components.py); a loop that hits its round bound
     raises the overflow counter.
  7. Component stats (true point counts), size filter, canonical
     renumbering by min original point index, and writeback through one
     scatter — bit-identical labels to the radius_cc oracle.

Per-frame capacities live in PipelineConfig; every cap violation increments
the returned overflow counter.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import ClusteringConfig, PipelineConfig
from .components import cc_labels
from ..types import CLUSTER_INVALID, CLUSTER_UNDEFINED, ClusteringResult
from .scan_utils import compact_mask, seg_broadcast_first

_IMAX = jnp.int32(jnp.iinfo(jnp.int32).max)
_F_BIG = jnp.float32(1.0e9)

# grid dims: 2048 x 2048 xy columns, 128 z cells (covers 500 m x 500 m x
# 31 m at the default radius — generous for any automotive LiDAR frame;
# out-of-range coords raise overflow and stay unclustered)
_GX = 2048
_GY = 2048
_GZ = 128

# the symmetric half of the 5x5 xy neighborhood (24 offsets total)
_XY_OFFSETS = [(0, 1), (0, 2), (1, -2), (1, -1), (1, 0), (1, 1), (1, 2),
               (2, -2), (2, -1), (2, 0), (2, 1), (2, 2)]

# exact-test tiers: (u-side cap, v-side cap, pair slots), first-fit in
# order, with every pair ORIENTED so u is the smaller side. Windows are
# fetched as stacked xyz superrows (one gather, 3 coordinates wide), 8-point
# superrows on the u side and 32-point ones on the v side.
#   * slots are sized to the maxima of the 154-frame KITTI recording
#     (tools/measure_caps.py with the 4-rep certain prefilter active:
#     intra [1797,41,697,149,66,43], snp [7760,904,2230,225,988,403]) with
#     >=1.15x headroom; every violation raises the overflow counter (never
#     a silent wrong verdict). Denser out-of-distribution scenes trip
#     overflow (flagged, degraded output: dropped pair verdicts => split
#     clusters) before accuracy degrades silently. To retune for a new
#     deployment, run `python tools/measure_caps.py` over its frames and
#     resize _TIERS_INTRA/_TIERS_SNP/_E_CAPS/_CHUNK_PAIRS_* to the new
#     maxima with >=1.15x headroom; static slots cost work whether occupied
#     or not.
# Pairs with a side beyond 288 split into 288-point sub-pair chunks (8x8
# grid => sides up to 2304 points; beyond that overflow fires).
_TIERS_INTRA = ((8, 32, 2176), (8, 96, 64), (32, 96, 896),
                (96, 96, 192), (96, 288, 96), (288, 288, 64))
_TIERS_SNP = ((8, 32, 9216), (8, 96, 1152), (32, 96, 2688),
              (96, 96, 288), (96, 288, 1280), (288, 288, 512))
_CHUNK = 288
_CHUNK_GRID = 8
# compacted oversized-pair slots per call (154-frame maxima: 18 intra /
# 433 snp sub-chunked pairs)
_CHUNK_PAIRS_INTRA = 64
_CHUNK_PAIRS_SNP = 512

# superrow width for run gathers: points are fetched as whole superrows
# and realigned by masking. 32-point superrows for general use; the tiered
# window gathers use finer 8-point superrows on the u side (see
# _stacked_windows).
_SR = 32


class _SortedPoints(NamedTuple):
    xyz: jnp.ndarray      # (NO,3) f32 key-sorted obstacle points
    key: jnp.ndarray      # (NO,) i32 cell key; IMAX padding
    orig: jnp.ndarray     # (NO,) i32 original indices
    n_obst: jnp.ndarray   # ()
    overflow: jnp.ndarray


def _sort_points(xyz, valid, pcfg: PipelineConfig, h: float) -> _SortedPoints:
    n = xyz.shape[0]
    no = pcfg.max_obstacle_points
    inf3 = jnp.float32(3.4e38)
    pmin = jnp.min(jnp.where(valid[:, None], xyz, inf3), axis=0)
    pmin = jnp.where(jnp.isfinite(pmin), pmin, 0.0)
    rel = jnp.floor((xyz - pmin) * jnp.float32(1.0 / h)).astype(jnp.int32)
    lim = jnp.asarray([_GX, _GY, _GZ], jnp.int32)
    coord_bad = valid & jnp.any((rel < 0) | (rel >= lim), axis=1)
    rel = jnp.clip(rel, 0, lim - 1)
    key = (rel[:, 0] * _GY + rel[:, 1]) * _GZ + rel[:, 2]
    key = jnp.where(valid & ~coord_bad, key, _IMAX)

    orig = jnp.arange(n, dtype=jnp.int32)
    sk, sx, sy, sz, sorig = jax.lax.sort(
        (key, xyz[:, 0], xyz[:, 1], xyz[:, 2], orig), num_keys=1)
    n_obst = jnp.sum((key != _IMAX).astype(jnp.int32))
    overflow = (jnp.sum(coord_bad.astype(jnp.int32))
                + jnp.maximum(n_obst - no, 0))
    sp = jnp.stack([sx[:no], sy[:no], sz[:no]], axis=1)
    return _SortedPoints(sp, sk[:no], sorig[:no],
                         jnp.minimum(n_obst, no), overflow)


class _CellTable(NamedTuple):
    start: jnp.ndarray     # (M,) first point index; NO for empty slots
    end: jnp.ndarray       # (M,)
    count: jnp.ndarray     # (M,)
    iz: jnp.ndarray        # (M,)
    col_id: jnp.ndarray    # (M,)
    aabb: jnp.ndarray      # (M,6) minx..maxz
    min_orig: jnp.ndarray  # (M,)
    rep: jnp.ndarray       # (M,3) first point of each cell (run start row)
    key: jnp.ndarray       # (M,) full grid key (carried, not re-gathered)
    n_cells: jnp.ndarray
    overflow: jnp.ndarray


def _build_cells(sp: _SortedPoints, pcfg: PipelineConfig
                 ) -> Tuple[_CellTable, jnp.ndarray]:
    """Cell/column run structure. Returns (cells, cell_id_per_point)."""
    no = sp.key.shape[0]
    m = pcfg.max_cells
    valid = sp.key != _IMAX
    prev = jnp.concatenate([jnp.array([-1], jnp.int32), sp.key[:-1]])
    new_cell = valid & (sp.key != prev)
    cell_id = jnp.cumsum(new_cell.astype(jnp.int32)) - 1
    n_cells = jnp.sum(new_cell.astype(jnp.int32))


    # run aggregates via ONE scatter-min into the cell table: min xyz /
    # -max xyz / min orig. Padding rows
    # keep the LAST valid cell's id (cumsum doesn't advance), so they must
    # be masked out of the scatter or the last cell's aggregates absorb
    # arbitrary non-obstacle points (wrong min_orig => wrong canonical
    # cluster numbering — bit-exactness bug found by the 154-frame golden
    # run on frames 28/44/110/112/116).
    pack = jnp.concatenate(
        [sp.xyz, -sp.xyz, sp.orig[:, None].astype(jnp.float32)], axis=1)
    tgt = jnp.where(valid, cell_id, m)
    agg_c = jnp.full((m, 7), _F_BIG, jnp.float32).at[tgt].min(
        pack, mode="drop")                            # (M,7)

    # run-start table WITH payloads: the multi-operand sort carries each
    # run-start row's key/col/xyz directly, replacing four table gathers
    pos = jnp.arange(no, dtype=jnp.int32)
    flagged = jnp.where(new_cell, pos, _IMAX)
    sorted5 = jax.lax.sort(
        (flagged, sp.key, sp.xyz[:, 0], sp.xyz[:, 1], sp.xyz[:, 2]),
        num_keys=1)
    if m <= no:
        s_pos, s_key, s_x, s_y, s_z = (a[:m] for a in sorted5)
    else:
        s_pos, s_key, s_x, s_y, s_z = (
            jnp.concatenate([a, jnp.full((m - no,), f, a.dtype)])
            for a, f in zip(sorted5, (_IMAX, _IMAX, 0.0, 0.0, 0.0)))
    starts = jnp.minimum(s_pos, no)
    slot_valid = jnp.arange(m, dtype=jnp.int32) < n_cells
    # end = start of the next cell (cells are consecutive in sorted order)
    nxt = jnp.concatenate([starts[1:], jnp.array([no], jnp.int32)])
    end = jnp.where(slot_valid, jnp.where(
        jnp.arange(m, dtype=jnp.int32) == n_cells - 1, sp.n_obst, nxt), no)
    start = jnp.where(slot_valid, starts, no)
    count = jnp.maximum(end - start, 0)

    cell_key = jnp.where(slot_valid, s_key, _IMAX)
    # column identity derives from the key (col_id stores the column KEY;
    # it is only ever compared for equality between neighboring cells)
    cell_col = jnp.where(slot_valid, s_key // _GZ, _IMAX)
    rep = jnp.stack([s_x, s_y, s_z], axis=1)
    aabb = jnp.concatenate([agg_c[:, 0:3], -agg_c[:, 3:6]], axis=1)
    min_orig = jnp.where(slot_valid, agg_c[:, 6].astype(jnp.int32), _IMAX)
    overflow = jnp.maximum(n_cells - m, 0)
    tbl = _CellTable(start, end, count, cell_key % _GZ, cell_col, aabb,
                     min_orig, rep, cell_key, jnp.minimum(n_cells, m),
                     overflow)
    return tbl, cell_id


def _stacked_windows(sp_xyz, starts, counts, fill, cap: int, sr: int):
    """Gather contiguous runs as stacked-xyz superrows of width `sr`.

    Returns three (P, cap + sr) planar windows (x, y, z) covering
    [starts, starts + min(counts, cap)) with invalid lanes = fill. ONE row
    gather fetches all three coordinates (rows of the (no//sr, 3*sr)
    stacked view). `sr` = 8 for small windows (u side), 32 for wide ones
    (v side).
    """
    no = sp_xyz.shape[0]
    assert cap % sr == 0
    view = jnp.concatenate(
        [sp_xyz[:, a].reshape(no // sr, sr) for a in range(3)], axis=1)
    width = cap + sr
    nrow = width // sr
    sr0 = starts // sr
    j = jnp.arange(nrow, dtype=jnp.int32)
    ridx = jnp.clip(sr0[:, None] + j[None, :], 0, no // sr - 1)
    rows = view[ridx]                                   # (P, nrow, 3*sr)
    off = (starts - sr0 * sr)[:, None]
    aw = jnp.arange(width, dtype=jnp.int32)[None, :]
    ok = (aw >= off) & (aw < off + jnp.minimum(counts, cap)[:, None])
    p = starts.shape[0]
    return tuple(
        jnp.where(ok, rows[:, :, a * sr:(a + 1) * sr].reshape(p, width),
                  fill)
        for a in range(3))


def min_d2_planar(ux, uy, uz, vx, vy, vz):
    """min_{i,j} ((ux[p,i]-vx[p,j])² + (uy..)² + (uz..)²) per pair p.

    All six inputs (P, W*) f32 planar coordinates with masked lanes
    pre-filled so that u-fill − v-fill is huge (the caller uses +BIG /
    −BIG). Returns (P,) f32. XLA fuses the broadcast-subtract-square into
    the min-reduction, so no (P, Wu, Wv) block is written to memory.
    """
    d = ux[:, :, None] - vx[:, None, :]
    d2 = d * d
    d = uy[:, :, None] - vy[:, None, :]
    d2 = d2 + d * d
    d = uz[:, :, None] - vz[:, None, :]
    d2 = d2 + d * d
    return jnp.min(jnp.min(d2, axis=2), axis=1)


def _block_min_d2(sp_xyz, u_start, u_count, v_start, v_count,
                  u_cap: int, v_cap: int, pu=None, dbg_win=None):
    """Exact min pairwise d² between contiguous point runs (batched).

    All index inputs (P,) int32; returns (P,) f32 min over the first u_cap /
    v_cap points of each side (counts beyond the caps must be handled by the
    caller's tier selection / overflow accounting). The u side is fetched at
    8-point superrow granularity; the v side as one wide 32-superrow window.
    """
    if pu is None:
        pu = _stacked_windows(sp_xyz, u_start, u_count, _F_BIG, u_cap, sr=8)
    pv = _stacked_windows(sp_xyz, v_start, v_count, -_F_BIG, v_cap, sr=32)
    if dbg_win is not None:
        dbg_win.append(sum(w.sum() for w in pv))
    return min_d2_planar(*pu, *pv)


class _PairTest(NamedTuple):
    """Candidate pair records awaiting exact point-level tests."""

    u_start: jnp.ndarray
    u_count: jnp.ndarray
    v_start: jnp.ndarray
    v_count: jnp.ndarray
    slot: jnp.ndarray      # destination index in the result array
    active: jnp.ndarray    # bool


def _tiered_exact(sp_xyz, pt: _PairTest, r2: float, n_results: int,
                  tiers=_TIERS_SNP, chunk_pairs: int = _CHUNK_PAIRS_SNP
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Run tiered block tests; scatter edge verdicts into (n_results,) bool.

    Every pair is ORIENTED (u = smaller side) and assigned to the first
    (u_cap, v_cap, slots) tier that fits — min-d² is symmetric, and the
    orientation keeps the u window (the narrow side) minimal. Oversized
    pairs (a side beyond _CHUNK) are split into
    _CHUNK-point sub-pair chunks whose verdicts OR into the original slot;
    sides beyond _CHUNK * _CHUNK_GRID points are counted in the returned
    overflow (verdict False — conservative, flagged).
    """
    maxc0 = jnp.maximum(pt.u_count, pt.v_count)
    big = pt.active & (maxc0 > _CHUNK)
    bidx, n_big, ovf_b = compact_mask(big, chunk_pairs)
    bmask = jnp.arange(chunk_pairs, dtype=jnp.int32) < n_big
    gch = jnp.arange(_CHUNK_GRID, dtype=jnp.int32) * _CHUNK
    shp = (chunk_pairs, _CHUNK_GRID, _CHUNK_GRID)

    def grid(vals, axis):
        e = vals[:, None, :] if axis else vals[:, :, None]
        return jnp.broadcast_to(e, shp).reshape(-1)

    ch_uc2 = jnp.clip(pt.u_count[bidx][:, None] - gch[None, :], 0, _CHUNK)
    ch_vc2 = jnp.clip(pt.v_count[bidx][:, None] - gch[None, :], 0, _CHUNK)
    ch = _PairTest(
        u_start=grid(pt.u_start[bidx][:, None] + gch[None, :], 0),
        u_count=grid(ch_uc2, 0),
        v_start=grid(pt.v_start[bidx][:, None] + gch[None, :], 1),
        v_count=grid(ch_vc2, 1),
        slot=grid(jnp.broadcast_to(pt.slot[bidx][:, None], ch_uc2.shape), 0),
        active=(grid(jnp.broadcast_to(bmask[:, None], ch_uc2.shape), 0)
                & (grid(ch_uc2, 0) > 0) & (grid(ch_vc2, 1) > 0)))
    us_ = jnp.concatenate([pt.u_start, ch.u_start])
    uc_ = jnp.concatenate([jnp.where(big, 0, pt.u_count), ch.u_count])
    vs_ = jnp.concatenate([pt.v_start, ch.v_start])
    vc_ = jnp.concatenate([jnp.where(big, 0, pt.v_count), ch.v_count])
    slot_ = jnp.concatenate([pt.slot, ch.slot])
    act_ = jnp.concatenate([pt.active & ~big, ch.active])

    # orient every (possibly chunked) pair: u = smaller side
    swap = uc_ > vc_
    o_us = jnp.where(swap, vs_, us_)
    o_uc = jnp.where(swap, vc_, uc_)
    o_vs = jnp.where(swap, us_, vs_)
    o_vc = jnp.where(swap, uc_, vc_)

    # ---- sort-packed tier assignment -------------------------------------
    # ONE multi-operand sort by first-fit tier id packs every tier into a
    # contiguous run; each tier then reads its pairs with a dynamic_slice.
    # This replaces a per-tier compact_mask (a full-list scatter each)
    # with a single sort.
    tier_id = jnp.full(o_uc.shape, len(tiers), jnp.int32)
    for t in range(len(tiers) - 1, -1, -1):
        u_cap, v_cap, _ = tiers[t]
        fits = act_ & (o_uc <= u_cap) & (o_vc <= v_cap)
        tier_id = jnp.where(fits, t, tier_id)
    # inactive rows sort last, after any unassigned-but-active rows
    tier_id = jnp.where(act_, tier_id, len(tiers) + 1)

    # pack (start, count) per side into one operand: starts < 2^17 and
    # ACTIVE counts <= 288 < 512 (larger pairs were chunked or overflow-
    # counted above); inactive rows clamp — they are masked on read
    key, s_usuc, s_vsvc, s_slot = jax.lax.sort(
        (tier_id, o_us * 512 + jnp.minimum(o_uc, 511),
         o_vs * 512 + jnp.minimum(o_vc, 511), slot_), num_keys=1)
    n_in_tier = [jnp.sum((tier_id == t).astype(jnp.int32))
                 for t in range(len(tiers))]
    starts = [jnp.int32(0)]
    for t in range(len(tiers)):
        starts.append(starts[-1] + n_in_tier[t])

    overflow = ovf_b + jnp.sum(
        (big & (maxc0 > _CHUNK * _CHUNK_GRID)).astype(jnp.int32))
    # active pairs too big for every tier (uc or vc beyond the top caps)
    overflow = overflow + jnp.sum((tier_id == len(tiers)).astype(jnp.int32))
    dbg_idx = []          # profiling prefixes (DCE'd unless requested)
    dbg_win = []
    tgts = []
    for t, (u_cap, v_cap, slots) in enumerate(tiers):
        n_t = n_in_tier[t]
        overflow = overflow + jnp.maximum(n_t - slots, 0)
        tier_active = jnp.arange(slots, dtype=jnp.int32) < n_t

        def sl(arr):
            return jax.lax.dynamic_slice(arr, (starts[t],), (slots,))

        usuc = sl(s_usuc)
        vsvc = sl(s_vsvc)
        us = jnp.where(tier_active, usuc >> 9, 0)
        uc = jnp.where(tier_active, usuc & 511, 0)
        vs = jnp.where(tier_active, vsvc >> 9, 0)
        vc = jnp.where(tier_active, vsvc & 511, 0)
        dbg_idx.append(us.sum() + vs.sum())
        pu = _stacked_windows(sp_xyz, us, uc, _F_BIG, u_cap, sr=8)
        dbg_win.append(sum(w.sum() for w in pu))
        with jax.named_scope("exact_pair_min_d2"):
            mind2 = _block_min_d2(sp_xyz, us, uc, vs, vc, u_cap, v_cap,
                                  pu=pu, dbg_win=dbg_win)
        verdict = tier_active & (mind2 <= r2)
        tgts.append(jnp.where(verdict, sl(s_slot), n_results))
    # ONE verdict scatter for all tiers
    out = jnp.zeros((n_results,), bool).at[
        jnp.concatenate(tgts)].set(True, mode="drop")
    dbg = {"tier_idx": sum(dbg_idx), "windows": sum(dbg_win)}
    return out, overflow, jnp.stack(n_in_tier + [n_big]), dbg


class _SnTable(NamedTuple):
    start: jnp.ndarray     # (S,) first point index
    count: jnp.ndarray     # (S,) point count
    aabb: jnp.ndarray      # (S,6)
    rep: jnp.ndarray       # (S,3) first point (bottom cell's lowest-z point)
    rep2: jnp.ndarray      # (S,3) TOP cell's first point (z-top probe)
    min_orig: jnp.ndarray  # (S,)
    first_cell: jnp.ndarray  # (S,) first cell id
    n_sn: jnp.ndarray
    overflow: jnp.ndarray


def _build_supernodes(sp, cells: _CellTable, link1: jnp.ndarray,
                      pcfg: PipelineConfig
                      ) -> Tuple[_SnTable, jnp.ndarray]:
    """Contract link1-chained cells into supernodes.

    link1: (M,) bool — verified connection between cell i and cell i+1.
    Returns (table, sn_id_per_cell).
    """
    m = cells.start.shape[0]
    s = pcfg.max_supernodes
    no = sp.key.shape[0]
    slot_valid = jnp.arange(m, dtype=jnp.int32) < cells.n_cells
    prev_link = jnp.concatenate([jnp.array([False]), link1[:-1]])
    new_sn = slot_valid & ~prev_link
    new_sn = new_sn.at[0].set(slot_valid[0])
    sn_of_cell = jnp.cumsum(new_sn.astype(jnp.int32)) - 1
    n_sn = jnp.sum(new_sn.astype(jnp.int32))

    # per-supernode aggregates via ONE scatter-min over the CELL table
    # (same rationale as _build_cells: beats reverse scan + row gather)
    pack = jnp.concatenate(
        [cells.aabb[:, 0:3], -cells.aabb[:, 3:6],
         cells.min_orig[:, None].astype(jnp.float32),
         ], axis=1)
    tgt = jnp.where(slot_valid, sn_of_cell, s)
    agg_s = jnp.full((s, 7), _F_BIG, jnp.float32).at[tgt].min(
        pack, mode="drop")                                # (S,7)

    # run-start table WITH payloads (as in _build_cells): carry each first
    # cell's point start + rep coordinates through the sort instead of
    # re-gathering them afterwards
    pos_m = jnp.arange(m, dtype=jnp.int32)
    flagged = jnp.where(new_sn, pos_m, _IMAX)
    sorted5 = jax.lax.sort(
        (flagged, cells.start, cells.rep[:, 0], cells.rep[:, 1],
         cells.rep[:, 2]), num_keys=1)
    if s <= m:
        f_pos, f_start, f_rx, f_ry, f_rz = (a[:s] for a in sorted5)
    else:
        f_pos, f_start, f_rx, f_ry, f_rz = (
            jnp.concatenate([a, jnp.full((s - m,), f, a.dtype)])
            for a, f in zip(sorted5, (_IMAX, no, 0.0, 0.0, 0.0)))
    first_cell = jnp.minimum(f_pos, m)        # (S,) cell ids
    sn_valid = jnp.arange(s, dtype=jnp.int32) < n_sn
    nxt_first = jnp.concatenate([first_cell[1:], jnp.array([m], jnp.int32)])
    last_cell = jnp.where(
        jnp.arange(s, dtype=jnp.int32) == n_sn - 1, cells.n_cells, nxt_first
    ) - 1
    lc = jnp.clip(last_cell, 0, m - 1)

    start = jnp.where(sn_valid, f_start, no)
    end = jnp.where(sn_valid, cells.end[lc], no)
    count = jnp.maximum(end - start, 0)
    aabb = jnp.concatenate([agg_s[:, 0:3], -agg_s[:, 3:6]], axis=1)
    min_orig = jnp.where(sn_valid, agg_s[:, 6].astype(jnp.int32), _IMAX)
    rep = jnp.stack([f_rx, f_ry, f_rz], axis=1)
    # second rep at the supernode's TOP cell: the first-point "certain"
    # test then covers z-disjoint pairs in both stacking orders (u's top
    # probing v's bottom and vice versa), resolving most of the ambiguous
    # pairs that previously went to the exact block tests
    rep2 = cells.rep[lc]
    overflow = jnp.maximum(n_sn - s, 0)
    tbl = _SnTable(start, count, aabb, rep, rep2, min_orig, first_cell,
                   jnp.minimum(n_sn, s), overflow)
    return tbl, sn_of_cell


def _column_pairs(col_key, n_cols, col_info, pcfg: PipelineConfig):
    """Sort-merge the 12-offset probes against occupied column keys.

    Returns (u_col_slot, v_col_slot, u_info, v_info, n_pairs, overflow):
    pairs of COLUMN table slots whose xy cells are 5x5-window neighbors,
    plus each side's `col_info` payload CARRIED through the sorts instead
    of two 40k-index gathers afterwards. The merge key is
    packed as column_key * 2 + is_probe (column keys < 2^22), so ONE
    single-key sort both merges and orders hosts before their probes; the
    hit list is then packed by a second single-key sort on the miss flag —
    no scatter/gather compaction anywhere.
    """
    c = col_key.shape[0]                                   # column capacity
    cp = pcfg.max_column_pairs
    col_valid = jnp.arange(c, dtype=jnp.int32) < n_cols
    ix = col_key // _GY
    iy = col_key % _GY

    probe_keys = []
    for dx, dy in _XY_OFFSETS:
        nx2, ny2 = ix + dx, iy + dy
        ok = col_valid & (nx2 >= 0) & (nx2 < _GX) & (ny2 >= 0) & (ny2 < _GY)
        probe_keys.append(jnp.where(ok, (nx2 * _GY + ny2) * 2 + 1, _IMAX))
    n_off = len(_XY_OFFSETS)
    pk = jnp.concatenate(probe_keys)
    psrc = jnp.tile(jnp.arange(c, dtype=jnp.int32), n_off)
    keys = jnp.concatenate([jnp.where(col_valid, col_key * 2, _IMAX), pk])
    tags = jnp.concatenate([jnp.arange(c, dtype=jnp.int32), psrc])
    infos = jnp.concatenate([col_info, jnp.tile(col_info, n_off)])
    sk2, st2, si2 = jax.lax.sort((keys, tags, infos), num_keys=1)
    # broadcast each host's slot + info over its equal-column run
    kcol = sk2 >> 1
    is_host = (sk2 != _IMAX) & ((sk2 & 1) == 0)
    host_slot = jnp.where(is_host, st2, _IMAX)
    host_info = jnp.where(is_host, si2, 0)
    run_new = jnp.concatenate(
        [jnp.array([True]), kcol[1:] != kcol[:-1]])
    run_id = jnp.cumsum(run_new.astype(jnp.int32)) - 1
    host_bcast = seg_broadcast_first(host_slot, run_id)
    hinfo_bcast = seg_broadcast_first(host_info, run_id)
    hit = (~is_host) & (sk2 != _IMAX) & (host_bcast != _IMAX)

    _, u_s, v_s, ui_s, vi_s = jax.lax.sort(
        ((~hit).astype(jnp.int32), st2,
         jnp.where(hit, host_bcast, 0), si2,
         jnp.where(hit, hinfo_bcast, 0)), num_keys=1)
    n_pairs = jnp.sum(hit.astype(jnp.int32))
    ovf = jnp.maximum(n_pairs - cp, 0)
    n_pairs = jnp.minimum(n_pairs, cp)
    live = jnp.arange(cp, dtype=jnp.int32) < n_pairs
    u_col = jnp.where(live, u_s[:cp], 0)
    v_col = jnp.where(live, v_s[:cp], 0)
    u_info = jnp.where(live, ui_s[:cp], 0)
    v_info = jnp.where(live, vi_s[:cp], 0)
    return u_col, v_col, u_info, v_info, n_pairs, ovf


@functools.partial(jax.jit, static_argnames=("cfg", "pcfg"))
def cluster(xyz: jnp.ndarray, valid: jnp.ndarray,
            cfg: ClusteringConfig, pcfg: PipelineConfig) -> ClusteringResult:
    """Cluster valid points of a padded cloud (see module docstring).

    Drop-in replacement for ops.clustering.cluster with identical outputs.
    """
    result, _ = _cluster_impl(xyz, valid, cfg, pcfg)
    return result


@functools.partial(jax.jit, static_argnames=("cfg", "pcfg"))
def cluster_debug(xyz, valid, cfg, pcfg):
    """cluster() plus a dict of internal arrays (tests/debugging only)."""
    return _cluster_impl(xyz, valid, cfg, pcfg)


class FusedClusterOut(NamedTuple):
    """cluster_fused output: clustering + segmentation written back in ONE
    scatter, plus the cell-key-sorted obstacle arrays for the hull stage."""

    result: ClusteringResult      # cluster labels in ORIGINAL point order
    seg_labels: jnp.ndarray       # (N,) i32 seg labels in ORIGINAL order
    sorted_xyz: jnp.ndarray       # (NO,3) cell-key-sorted obstacle points
    sorted_label: jnp.ndarray     # (NO,) cluster label per sorted row
    sorted_orig: jnp.ndarray      # (NO,) original index per sorted row


def _sort_points_full(xyz, obstacle, point_valid, orig, seg_labels,
                      pcfg: PipelineConfig, h: float):
    """_sort_points variant that keeps the FULL permutation.

    Obstacle points sort first (by cell key), then remaining valid points
    (key _IMAX - 1), then padding (_IMAX) — so one scatter at the end can
    write back BOTH label arrays for every real point.
    Returns (sp, key_full, orig_full, seg_full).
    """
    n = xyz.shape[0]
    no = pcfg.max_obstacle_points
    inf3 = jnp.float32(3.4e38)
    pmin = jnp.min(jnp.where(obstacle[:, None], xyz, inf3), axis=0)
    pmin = jnp.where(jnp.isfinite(pmin), pmin, 0.0)
    rel = jnp.floor((xyz - pmin) * jnp.float32(1.0 / h)).astype(jnp.int32)
    lim = jnp.asarray([_GX, _GY, _GZ], jnp.int32)
    coord_bad = obstacle & jnp.any((rel < 0) | (rel >= lim), axis=1)
    rel = jnp.clip(rel, 0, lim - 1)
    key = (rel[:, 0] * _GY + rel[:, 1]) * _GZ + rel[:, 2]
    key = jnp.where(obstacle & ~coord_bad, key,
                    jnp.where(point_valid, _IMAX - 1, _IMAX))

    # orig (< 2^17) and the 2-bit seg label pack into ONE sort operand
    # (multi-operand sorts cost per operand; the unsort key stays a
    # permutation-equivalent strictly-increasing key)
    orig4 = orig * 4 + seg_labels
    sk, sx, sy, sz, so4 = jax.lax.sort(
        (key, xyz[:, 0], xyz[:, 1], xyz[:, 2], orig4), num_keys=1)
    n_obst = jnp.sum((key < _IMAX - 1).astype(jnp.int32))
    overflow = (jnp.sum(coord_bad.astype(jnp.int32))
                + jnp.maximum(n_obst - no, 0))
    slice_key = jnp.where(jnp.arange(no, dtype=jnp.int32) < n_obst,
                          sk[:no], _IMAX)
    sp = _SortedPoints(jnp.stack([sx[:no], sy[:no], sz[:no]], axis=1),
                       slice_key, so4[:no] >> 2,
                       jnp.minimum(n_obst, no), overflow)
    return sp, sk, so4, so4 & 3


@functools.partial(jax.jit, static_argnames=("cfg", "pcfg"))
def cluster_fused(xyz_s, obstacle_s, point_valid_s, orig_s, seg_labels_s,
                  cfg: ClusteringConfig, pcfg: PipelineConfig
                  ) -> FusedClusterOut:
    """Fused clustering over a pre-sorted segmented cloud.

    Inputs live in gpf_segment_sorted's (partition, z) space; orig_s carries
    the original index. Both stages' labels return to original order with
    ONE packed int32 scatter (seg in 2 bits, cluster label + 2 above), and
    the cell-key-sorted obstacle arrays feed the hull stage directly —
    replacing three separate full-cloud scatters/sorts in the unfused path.
    """
    n = xyz_s.shape[0]
    no = pcfg.max_obstacle_points
    h = math.sqrt(cfg.distance_squared / 3.0)
    sp, key_full, orig_full, seg_full = _sort_points_full(
        xyz_s, obstacle_s, point_valid_s, orig_s, seg_labels_s, pcfg, h)
    pt_label, num_clusters, overflow, _dbg = _cluster_core(sp, cfg, pcfg)

    pt_valid = sp.key != _IMAX
    cl_plus2 = jnp.concatenate([
        jnp.where(pt_valid, pt_label + 2, 0),
        jnp.zeros((n - no,), jnp.int32)])
    cl_plus2 = jnp.where(key_full != _IMAX, cl_plus2, 0)
    # orig_full carries orig*4+seg — strictly increasing in orig, so it is
    # still a valid inverse-permutation sort key, and the unsort delivers
    # the seg labels for free in its low bits: ONE 2-operand sort instead
    # of a full-cloud scatter (~5x cheaper)
    so4, out_cl = jax.lax.sort((orig_full, cl_plus2), num_keys=1)
    seg_out = so4 & 3
    cl_out = jnp.where(out_cl == 0, CLUSTER_UNDEFINED, out_cl - 2)
    return FusedClusterOut(
        ClusteringResult(cl_out, num_clusters, overflow), seg_out,
        sp.xyz, jnp.where(pt_valid, pt_label, CLUSTER_UNDEFINED), sp.orig)


def _cluster_impl(xyz: jnp.ndarray, valid: jnp.ndarray,
                  cfg: ClusteringConfig, pcfg: PipelineConfig):
    n = xyz.shape[0]
    h = math.sqrt(cfg.distance_squared / 3.0)
    sp = _sort_points(xyz, valid, pcfg, h)
    pt_label, num_clusters, overflow, debug = _cluster_core(sp, cfg, pcfg)
    pt_valid = sp.key != _IMAX
    out = jnp.full((n,), CLUSTER_UNDEFINED, jnp.int32).at[
        jnp.where(pt_valid, sp.orig, n)].set(pt_label, mode="drop")
    return ClusteringResult(out, num_clusters, overflow), debug


def _cluster_core(sp: _SortedPoints,
                  cfg: ClusteringConfig, pcfg: PipelineConfig):
    """Shared clustering core over a sorted obstacle buffer.

    Returns (pt_label (NO,) labels per sorted row, num_clusters, overflow,
    debug dict)."""
    r2 = cfg.distance_squared
    m = pcfg.max_cells
    s_cap = pcfg.max_supernodes
    no = pcfg.max_obstacle_points

    cells, cell_id_pt = _build_cells(sp, pcfg)
    overflow = sp.overflow + cells.overflow

    # ---- intra-column candidate links (dense shifted comparisons) --------
    slot_valid = jnp.arange(m, dtype=jnp.int32) < cells.n_cells

    cand = {}
    for k in (1, 2):
        nb_valid = jnp.concatenate(
            [slot_valid[k:], jnp.zeros((k,), bool)])
        same_col = cells.col_id == jnp.concatenate(
            [cells.col_id[k:], jnp.full((k,), _IMAX)])
        diz = jnp.concatenate(
            [cells.iz[k:], jnp.zeros((k,), jnp.int32)]) - cells.iz
        cand[k] = slot_valid & nb_valid & same_col & (diz >= 1) & (diz <= 2)

    # AABB gap / first-point prefilters for the two shift patterns
    def pair_classify(u_aabb, v_aabb, u_rep, v_rep):
        gap = jnp.maximum(
            0.0, jnp.maximum(u_aabb[:, 0:3] - v_aabb[:, 3:6],
                             v_aabb[:, 0:3] - u_aabb[:, 3:6]))
        impossible = jnp.sum(gap * gap, axis=1) > r2
        dr = u_rep - v_rep
        certain = jnp.sum(dr * dr, axis=1) <= r2
        return impossible, certain

    cell_rep = cells.rep
    intra_link = {}
    intra_tests = []
    for k in (1, 2):
        v_aabb = jnp.roll(cells.aabb, -k, axis=0)
        v_rep = jnp.roll(cell_rep, -k, axis=0)
        impossible, certain = pair_classify(cells.aabb, v_aabb,
                                            cell_rep, v_rep)
        intra_link[k] = cand[k] & ~impossible & certain
        intra_tests.append(cand[k] & ~impossible & ~certain)

    # ---- inter-column pairs ---------------------------------------------
    # column table: first supernode + supernode count per column (built
    # after supernodes; but supernodes need link1 which needs the intra
    # tests — run ALL exact tests in one tiered batch first)
    # Assemble the unified ambiguous-pair test list:
    #   results layout: [0, M) link1 candidates, [M, 2M) link2 candidates,
    #   [2M, 2M + SNP) supernode pairs (filled below after supernode build
    #   in a SECOND tiered batch — supernode sizes depend on link1).
    pt_u_start, pt_u_cnt, pt_v_start, pt_v_cnt, pt_slot, pt_act = \
        [], [], [], [], [], []
    for j, k in enumerate((1, 2)):
        pt_u_start.append(cells.start)
        pt_u_cnt.append(cells.count)
        pt_v_start.append(jnp.roll(cells.start, -k))
        pt_v_cnt.append(jnp.roll(cells.count, -k))
        pt_slot.append(jnp.arange(m, dtype=jnp.int32) + j * m)
        pt_act.append(intra_tests[j])
    pt = _PairTest(*(jnp.concatenate(x) for x in
                     (pt_u_start, pt_u_cnt, pt_v_start, pt_v_cnt,
                      pt_slot, pt_act)))
    intra_verdict, ovf_t, tiers1, _dbg_t1 = _tiered_exact(
        sp.xyz, pt, r2, 2 * m, tiers=_TIERS_INTRA,
        chunk_pairs=_CHUNK_PAIRS_INTRA)
    overflow = overflow + ovf_t

    link1 = intra_link[1] | intra_verdict[:m]
    link2 = intra_link[2] | intra_verdict[m:2 * m]

    # ---- supernodes ------------------------------------------------------
    sn, sn_of_cell = _build_supernodes(sp, cells, link1, pcfg)
    overflow = overflow + sn.overflow

    # link2 edges crossing a supernode boundary
    sn_p2 = jnp.roll(sn_of_cell, -2)
    link2_edge = link2 & (sn_p2 != sn_of_cell)
    e2_u = jnp.where(link2_edge, sn_of_cell, 0)
    e2_v = jnp.where(link2_edge, sn_p2, 0)

    # ---- column table + pair generation ---------------------------------
    c_cap = pcfg.max_columns
    # per-cell column table info: columns are runs in the CELL table
    prev_col_c = jnp.concatenate([jnp.array([-1], jnp.int32),
                                  cells.col_id[:-1]])
    new_col_c = slot_valid & (cells.col_id != prev_col_c)
    col_idx_of_cell = jnp.cumsum(new_col_c.astype(jnp.int32)) - 1
    n_cols = jnp.sum(new_col_c.astype(jnp.int32))
    # run-start table WITH payloads (as in _build_cells): first cell's
    # key and supernode id ride the sort instead of being re-gathered
    pos_c = jnp.arange(m, dtype=jnp.int32)
    flagged_c = jnp.where(new_col_c, pos_c, _IMAX)
    sorted3 = jax.lax.sort((flagged_c, cells.key, sn_of_cell), num_keys=1)
    if c_cap <= m:
        c_pos, c_key, c_sn = (a[:c_cap] for a in sorted3)
    else:
        c_pos, c_key, c_sn = (
            jnp.concatenate([a, jnp.full((c_cap - m,), _IMAX, a.dtype)])
            for a in sorted3)
    col_first_cell = jnp.minimum(c_pos, m)
    col_valid = jnp.arange(c_cap, dtype=jnp.int32) < n_cols
    col_key = jnp.where(col_valid, c_key // _GZ, _IMAX)
    col_first_sn = jnp.where(col_valid, c_sn, 0)
    nxt_col_first = jnp.concatenate([col_first_cell[1:],
                                     jnp.array([m], jnp.int32)])
    col_last_cell = jnp.where(
        jnp.arange(c_cap, dtype=jnp.int32) == n_cols - 1, cells.n_cells,
        nxt_col_first) - 1
    col_last_sn = jnp.where(col_valid,
                            sn_of_cell[jnp.clip(col_last_cell, 0, m - 1)], -1)
    col_sn_count = jnp.where(col_valid, col_last_sn - col_first_sn + 1, 0)
    overflow = overflow + jnp.maximum(n_cols - c_cap, 0)
    overflow = overflow + jnp.sum((col_sn_count > 16).astype(jnp.int32))

    # packed per-column payload (first_sn * 32 + min(count, 31); counts
    # past 16 already raise the overflow counter above) — carried THROUGH
    # the pair merge sorts so no pair-list gathers are needed
    col_info = col_first_sn * 32 + jnp.minimum(col_sn_count, 31)
    u_col, v_col, pa, pb, n_cpairs, ovf_cp = _column_pairs(
        col_key, n_cols, col_info, pcfg)
    overflow = overflow + ovf_cp

    # ---- expand column pairs to supernode pairs -------------------------
    cp = pcfg.max_column_pairs
    snp = pcfg.max_sn_pairs
    cp_valid = jnp.arange(cp, dtype=jnp.int32) < n_cpairs
    uA = pa // 32
    cA = jnp.where(cp_valid, pa % 32, 0)
    uB = pb // 32
    cB = jnp.where(cp_valid, pb % 32, 0)
    # primary slot: first supernode of each column
    prim_u, prim_v = uA, uB
    prim_ok = cp_valid & (cA >= 1) & (cB >= 1)

    # four-level multi-supernode expansion, sized for measured KITTI loads
    # (~7k 2-supernode pairs, ~2k at 3-4, hundreds at 5-8 in the dense
    # mid-sequence frames, and a handful past 8 — columns peak at 10
    # supernodes on frame 95; the counter above fires past 16).
    # ONE 3-operand sort packs the pairs into contiguous class bands (one
    # band per expansion width); each band then reads its rows with a
    # dynamic_slice — this replaces four compact_mask scatter/gather
    # compactions over the full pair list.
    mx = jnp.maximum(cA, cB)
    cls = jnp.where(mx <= 1, 5,
                    jnp.where(mx == 2, 1,
                              jnp.where(mx <= 4, 2,
                                        jnp.where(mx <= 8, 3, 4))))
    cls = jnp.where(cp_valid, cls, 6)
    ck, spa, spb = jax.lax.sort((cls, pa, pb), num_keys=1)
    n_cls = [jnp.sum((ck == k).astype(jnp.int32)) for k in (1, 2, 3, 4)]
    offs = [jnp.int32(0)]
    for k in range(4):
        offs.append(offs[-1] + n_cls[k])
    _E_CAPS = (10240, 3840, 512, 64)
    pad_sl = jnp.zeros((max(_E_CAPS),), jnp.int32)
    spa_p = jnp.concatenate([spa, pad_sl])
    spb_p = jnp.concatenate([spb, pad_sl])

    def expand_band(band, width):
        cap = _E_CAPS[band]
        a = jax.lax.dynamic_slice(spa_p, (offs[band],), (cap,))
        b = jax.lax.dynamic_slice(spb_p, (offs[band],), (cap,))
        nb = n_cls[band]
        act = jnp.arange(cap, dtype=jnp.int32) < jnp.minimum(nb, cap)
        muA, mcA = a // 32, jnp.where(act, a % 32, 0)
        muB, mcB = b // 32, jnp.where(act, b % 32, 0)
        g = jnp.arange(width, dtype=jnp.int32)
        shp = (cap, width, width)
        eu = jnp.broadcast_to(muA[:, None, None] + g[None, :, None],
                              shp).reshape(-1)
        ev = jnp.broadcast_to(muB[:, None, None] + g[None, None, :],
                              shp).reshape(-1)
        eok = ((g[None, :, None] < jnp.minimum(mcA, width)[:, None, None])
               & (g[None, None, :] < jnp.minimum(mcB, width)[:, None, None])
               & ((g[None, :, None] > 0) | (g[None, None, :] > 0))
               ).reshape(-1)
        return eu, ev, eok, jnp.maximum(nb - cap, 0)

    e1u, e1v, e1ok, ovf1 = expand_band(0, 2)
    e2u, e2v, e2ok, ovf2 = expand_band(1, 4)
    e3u, e3v, e3ok, ovf3 = expand_band(2, 8)
    e4u, e4v, e4ok, ovf4 = expand_band(3, 16)
    overflow = overflow + ovf1 + ovf2 + ovf3 + ovf4
    # assemble the supernode pair list. Valid pairs are packed to the front
    # by ONE sort; when supernode ids fit 15 bits the (u, v, ok) triple is
    # packed into a single int32 sort key (u * 2^15 + v, invalid -> 2^30),
    # making this a single-operand sort.
    all_u = jnp.concatenate([prim_u, e1u, e2u, e3u, e4u])
    all_v = jnp.concatenate([prim_v, e1v, e2v, e3v, e4v])
    all_ok = jnp.concatenate([prim_ok, e1ok, e2ok, e3ok, e4ok])
    n_snp = jnp.sum(all_ok.astype(jnp.int32))
    overflow = overflow + jnp.maximum(n_snp - snp, 0)
    n_snp = jnp.minimum(n_snp, snp)
    snp_valid = jnp.arange(snp, dtype=jnp.int32) < n_snp
    if s_cap <= (1 << 15):
        key = jnp.where(all_ok, all_u * (1 << 15) + all_v,
                        jnp.int32(1) << 30)
        skey = jax.lax.sort(key)
        pu = jnp.where(snp_valid, skey[:snp] >> 15, 0)
        pv = jnp.where(snp_valid, skey[:snp] & ((1 << 15) - 1), 0)
    else:
        _, su_, sv_ = jax.lax.sort(
            ((~all_ok).astype(jnp.int32), all_u, all_v), num_keys=1)
        pu = jnp.where(snp_valid, su_[:snp], 0)
        pv = jnp.where(snp_valid, sv_[:snp], 0)

    # ---- classify supernode pairs ---------------------------------------
    # one coalesced row gather per side:
    # [aabb(6), rep(3), rep2(3), start, count]
    sn_rows = jnp.concatenate(
        [sn.aabb, sn.rep, sn.rep2,
         sn.start[:, None].astype(jnp.float32),
         sn.count[:, None].astype(jnp.float32)], axis=1)   # (S,14)
    ru = sn_rows[pu]
    rv = sn_rows[pv]
    gap = jnp.maximum(0.0, jnp.maximum(ru[:, 0:3] - rv[:, 3:6],
                                       rv[:, 0:3] - ru[:, 3:6]))
    impossible = jnp.sum(gap * gap, axis=1) > r2

    def d2(a, b):
        d = a - b
        return jnp.sum(d * d, axis=1)

    # 4 rep-pair probes (bottom/top x bottom/top): any hit connects the
    # pair for certain without a block test
    certain = ((d2(ru[:, 6:9], rv[:, 6:9]) <= r2)
               | (d2(ru[:, 6:9], rv[:, 9:12]) <= r2)
               | (d2(ru[:, 9:12], rv[:, 6:9]) <= r2)
               | (d2(ru[:, 9:12], rv[:, 9:12]) <= r2))
    ambiguous = snp_valid & ~impossible & ~certain
    pair_certain = snp_valid & ~impossible & certain

    pt2 = _PairTest(
        u_start=ru[:, 12].astype(jnp.int32),
        u_count=ru[:, 13].astype(jnp.int32),
        v_start=rv[:, 12].astype(jnp.int32),
        v_count=rv[:, 13].astype(jnp.int32),
        slot=jnp.arange(snp, dtype=jnp.int32), active=ambiguous)
    snp_verdict, ovf_t2, tiers2, _dbg_t2 = _tiered_exact(
        sp.xyz, pt2, r2, snp, tiers=_TIERS_SNP)
    overflow = overflow + ovf_t2
    snp_edge = pair_certain | snp_verdict

    # ---- edge list, compacted by one sort --------------------------------
    # (real edges first; the CC kernel then touches only n_edges entries;
    # single packed int32 key when supernode ids fit 15 bits)
    e_u0 = jnp.concatenate([jnp.where(snp_edge, pu, 0), e2_u])
    e_v0 = jnp.concatenate([jnp.where(snp_edge, pv, 0), e2_v])
    e_ok0 = jnp.concatenate([snp_edge, link2_edge])
    n_edges = jnp.sum(e_ok0.astype(jnp.int32))
    ec = min(pcfg.max_edges, e_u0.shape[0])
    overflow = overflow + jnp.maximum(n_edges - ec, 0)
    n_edges = jnp.minimum(n_edges, ec)
    e_ok = jnp.arange(ec, dtype=jnp.int32) < n_edges
    if s_cap <= (1 << 15):
        ekey = jnp.where(e_ok0, e_u0 * (1 << 15) + e_v0, jnp.int32(1) << 30)
        sek = jax.lax.sort(ekey)
        e_u = jnp.where(e_ok, sek[:ec] >> 15, 0)
        e_v = jnp.where(e_ok, sek[:ec] & ((1 << 15) - 1), 0)
    else:
        _, se_u, se_v = jax.lax.sort(
            ((~e_ok0).astype(jnp.int32),
             jnp.where(e_ok0, e_u0, 0), jnp.where(e_ok0, e_v0, 0)),
            num_keys=1)
        e_u = jnp.where(e_ok, se_u[:ec], 0)
        e_v = jnp.where(e_ok, se_v[:ec], 0)

    # ---- connected components on the supernode graph --------------------
    # min-node-id component labels; a fixpoint loop that stops on its round
    # bound is counted as overflow
    sn_valid_mask = jnp.arange(s_cap, dtype=jnp.int32) < sn.n_sn
    with jax.named_scope("connected_components"):
        labels, cc_rounds, cc_converged = cc_labels(e_u, e_v, n_edges,
                                                    s_cap)
    overflow = overflow + (~cc_converged).astype(jnp.int32)

    # ---- stats, size filter, canonical numbering ------------------------
    comp_size = jnp.zeros((s_cap,), jnp.int32).at[
        jnp.where(sn_valid_mask, labels, s_cap)].add(
            jnp.where(sn_valid_mask, sn.count, 0), mode="drop")
    comp_min = jnp.full((s_cap,), _IMAX, jnp.int32).at[
        jnp.where(sn_valid_mask, labels, s_cap)].min(
            sn.min_orig, mode="drop")
    is_root = sn_valid_mask & (labels == jnp.arange(s_cap, dtype=jnp.int32))
    max_sz = min(cfg.max_cluster_size, 2**31 - 1)
    comp_valid = (is_root & (comp_size >= cfg.min_cluster_size)
                  & (comp_size <= max_sz))

    rank_key = jnp.where(comp_valid, comp_min, _IMAX)
    rorder = jnp.argsort(rank_key)
    ranks = jnp.zeros((s_cap,), jnp.int32).at[rorder].set(
        jnp.arange(s_cap, dtype=jnp.int32))
    num_clusters = jnp.sum(comp_valid.astype(jnp.int32))
    root_label = jnp.where(comp_valid, ranks, CLUSTER_INVALID)

    # ---- per-point labels over the sorted buffer ------------------------
    # compose gathers through the CELL table (20k rows), then expand
    # cell -> point by scattering each cell's label to its RUN START and
    # propagating with a segmented broadcast — cells are contiguous runs
    # in sorted space, so this replaces the 81920-index random gather
    # with a 20k-input scatter + one associative scan
    sn_label = root_label[labels]                       # (S,)
    cell_label = sn_label[jnp.clip(sn_of_cell, 0, s_cap - 1)]   # (M,)
    pt_valid = sp.key != _IMAX
    seed_lab = jnp.full((sp.key.shape[0],), CLUSTER_UNDEFINED, jnp.int32).at[
        cells.start].set(cell_label, mode="drop")       # invalid: dropped
    pt_label = jnp.where(
        pt_valid, seg_broadcast_first(seed_lab, cell_id_pt),
        CLUSTER_UNDEFINED)
    debug = dict(
        sp=sp, cells=cells, cell_id_pt=cell_id_pt, link1=link1, link2=link2,
        intra_tests1=intra_tests[0], intra_tests2=intra_tests[1],
        sn=sn, sn_of_cell=sn_of_cell, col_first_sn=col_first_sn,
        col_sn_count=col_sn_count, u_col=u_col, v_col=v_col,
        n_cpairs=n_cpairs, pu=pu, pv=pv, n_snp=n_snp,
        n_cls=jnp.stack(n_cls),
        n_edges=n_edges,
        impossible=impossible, certain=certain, snp_edge=snp_edge,
        e_u=e_u, e_v=e_v, e_ok=e_ok, labels=labels, cc_rounds=cc_rounds,
        tiers1=tiers1, tiers2=tiers2,
        snp_classify=(impossible.sum(), certain.sum()),
        snp_tier_idx=_dbg_t2["tier_idx"], snp_windows=_dbg_t2["windows"])
    return pt_label, num_clusters, overflow, debug
