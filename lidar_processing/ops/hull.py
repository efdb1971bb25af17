"""Cluster gathering and batched convex hulls on device.

The reference extracts per-cluster outlines serially on the host: Andrew
monotone chain for small clusters, chi-shape concave hull for large ones
(ref: src/polygon_simplification.cpp:82-149). The device redesign:

  * cluster gathering (the scatter loop at ref: src/processor.cpp:180-200)
    becomes one sort-by-label + contiguous-range gather into a padded
    (C, P, 2) batch;
  * small-cluster convex hulls are computed for ALL clusters in one batched,
    branch-free kernel: a point is a hull vertex iff it is a vertex of the
    angular-sorted boundary with a strictly-convex corner — evaluated as a
    dense O(P^2) edge test in place of a serial monotone chain, for the
    small-P regime the live path needs (P <= 32 covers the reference's
    '<20 points => convex' rule, ref: src/polygon_simplification.cpp:98);
  * large-cluster hulls (convex Chan-equivalent and chi-shape concave) run in
    the native host module (native/) over the gathered cluster batch — hulls
    are the cheapest stage and inherently irregular (Delaunay); see
    runtime/pipeline.py for the split.

Conventions match the reference: CCW orientation, strictly convex vertices,
hull indices ordered.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..types import PolygonBatch


class LabelRuns(NamedTuple):
    """Label-sorted cloud + per-cluster run table (the gather-free gather).

    Sorting the cloud ONCE by cluster label makes every cluster a contiguous
    run; the reference's per-point scatter into per-cluster clouds
    (ref: src/processor.cpp:180-200) becomes `sorted_xyz[start:start+count]`
    — a free slice on host and an aligned window gather on device,
    instead of a (C, P) random row gather.

    sorted_xyz: (N, 3) f32 — points ordered by cluster id (stable: within a
                cluster, original point order); non-cluster points last.
    sorted_key: (N,) i32 — cluster id per sorted row (num_slots for
                non-cluster rows); the per-point slot index used by the
                packed-payload compaction.
    starts:     (C,) i32 — run start per cluster id.
    counts:     (C,) i32 — run length per cluster id.
    num:        ()  i32 — number of clusters present.
    overflow:   ()  i32 — clusters beyond the C-slot table (dropped, never
                silently merged).
    """

    sorted_xyz: jnp.ndarray
    sorted_key: jnp.ndarray
    starts: jnp.ndarray
    counts: jnp.ndarray
    num: jnp.ndarray
    overflow: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("num_slots",))
def label_runs(xyz: jnp.ndarray, labels: jnp.ndarray,
               num_slots: int) -> LabelRuns:
    """Sort a labeled cloud by label into contiguous per-cluster runs."""
    n = xyz.shape[0]
    valid = (labels >= 0) & (labels < num_slots)
    key = jnp.where(valid, labels, num_slots)
    skey, sx_, sy_, sz_ = jax.lax.sort(
        (key, xyz[:, 0], xyz[:, 1], xyz[:, 2]), num_keys=1)
    sorted_xyz = jnp.stack([sx_, sy_, sz_], axis=1)
    # starts AND counts from one searchsorted over the sorted keys (no
    # full-cloud scatter: counts[c] = starts[c+1] - starts[c])
    edges = jnp.searchsorted(
        skey, jnp.arange(num_slots + 1, dtype=jnp.int32)).astype(jnp.int32)
    starts = edges[:num_slots]
    counts = edges[1:] - starts
    num = jnp.max(jnp.where(labels >= 0, labels, -1)) + 1
    overflow = jnp.sum((labels >= num_slots).astype(jnp.int32))
    return LabelRuns(sorted_xyz, skey, starts, counts,
                     jnp.minimum(num, num_slots), overflow)


@functools.partial(jax.jit, static_argnames=("num_slots", "orig_bound"))
def label_runs_presorted(xyz: jnp.ndarray, labels: jnp.ndarray,
                         orig: jnp.ndarray, num_slots: int,
                         orig_bound: int = 0) -> LabelRuns:
    """label_runs over an already-compacted labeled buffer.

    Used by the fused pipeline: the clustering stage hands over its
    cell-key-sorted obstacle points (a NO-row buffer instead of the full
    padded cloud), and `orig` restores the within-cluster original point
    order that label_runs guarantees (secondary sort key).
    """
    from .scan_utils import run_starts

    n = xyz.shape[0]
    valid = (labels >= 0) & (labels < num_slots)
    key = jnp.where(valid, labels, num_slots)
    # label and orig pack into ONE sort key when the ranges allow (the
    # standard config: 1537 slot values x orig < 2^17 < 2^31): one operand
    # fewer AND a single-key sort. orig is bounded by the ORIGINAL cloud
    # size — pass it via orig_bound; without it, fall back conservatively
    # to 4x the compacted buffer (the padded cloud is <= 2x the obstacle
    # buffer in every shipped config).
    shift = max(17, ((orig_bound or 4 * n) - 1).bit_length())
    if (num_slots + 1) << shift <= (1 << 31):
        packed = key * jnp.int32(1 << shift) + orig
        pk, sx_, sy_, sz_ = jax.lax.sort(
            (packed, xyz[:, 0], xyz[:, 1], xyz[:, 2]), num_keys=1)
        skey = pk >> shift
    else:
        skey, _, sx_, sy_, sz_ = jax.lax.sort(
            (key, orig, xyz[:, 0], xyz[:, 1], xyz[:, 2]), num_keys=2)
    sorted_xyz = jnp.stack([sx_, sy_, sz_], axis=1)
    num = jnp.max(jnp.where(valid, labels, -1)) + 1
    num = jnp.minimum(num, num_slots)
    overflow = jnp.sum((labels >= num_slots).astype(jnp.int32))
    # cluster ids are COMPACT (0..num-1, each with >= 1 point), so every
    # slot below num is a present run: starts come from one run_starts
    # sort and counts from consecutive-start differences — no binary
    # search
    n_lab = jnp.sum(valid.astype(jnp.int32))
    prev = jnp.concatenate([jnp.array([-1], jnp.int32), skey[:-1]])
    new_run = (skey != prev) & (skey < num_slots)
    # compactness guard: the run table is only valid when every id in
    # [0, num) has >= 1 point (true for _cluster_core's rank-compacted
    # labels). A gappy caller would silently shift every subsequent
    # start — fail loudly through the overflow counter instead.
    n_runs = jnp.sum(new_run.astype(jnp.int32))
    starts_raw = run_starts(new_run, num_slots)
    slot = jnp.arange(num_slots, dtype=jnp.int32)
    slot_valid = slot < num
    nxt = jnp.concatenate([starts_raw[1:], jnp.array([n], jnp.int32)])
    end = jnp.where(slot == num - 1, n_lab, nxt)
    starts = jnp.where(slot_valid, starts_raw, n)
    counts = jnp.where(slot_valid, jnp.maximum(end - starts_raw, 0), 0)
    overflow = overflow + jnp.where(n_runs != num, jnp.int32(1), jnp.int32(0))
    return LabelRuns(sorted_xyz, skey, starts, counts, num, overflow)


_SR = 32  # superrow width for aligned window gathers


@functools.partial(jax.jit, static_argnames=("max_points",))
def gather_runs(sorted_xyz: jnp.ndarray, starts: jnp.ndarray,
                counts: jnp.ndarray, max_points: int) -> jnp.ndarray:
    """Gather contiguous runs into a packed (C, max_points, 3) batch.

    Fetches whole 32-point superrows and realigns them with a local
    gather — the same trick as ops/stixel.py's _stacked_windows, here with
    front-packed output for the hull kernels.
    """
    n = sorted_xyz.shape[0]
    assert n % _SR == 0
    srows = sorted_xyz.reshape(n // _SR, _SR, 3)
    nrow = max_points // _SR + 1
    sr0 = starts // _SR
    j = jnp.arange(nrow, dtype=jnp.int32)
    ridx = jnp.clip(sr0[:, None] + j[None, :], 0, n // _SR - 1)
    wide = srows[ridx].reshape(starts.shape[0], nrow * _SR, 3)
    off = (starts - sr0 * _SR)[:, None]
    lane = jnp.arange(max_points, dtype=jnp.int32)[None, :] + off
    pts = jnp.take_along_axis(wide, lane[..., None], axis=1)
    keep = (jnp.arange(max_points, dtype=jnp.int32)[None, :]
            < jnp.minimum(counts, max_points)[:, None])
    return jnp.where(keep[..., None], pts, 0.0)


def _convex_hull_small_single(
    xy: jnp.ndarray, count: jnp.ndarray, max_out: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Strictly-convex CCW hull of one padded point set (P <= ~64).

    Dense O(P^2) formulation: for each point, test whether it is a strict
    corner of the hull by checking that some half-plane through it contains
    all other points strictly on one side. Implemented via the rotating
    support test: p is a hull VERTEX iff p is strictly extremal in some
    direction; equivalently p is NOT a vertex iff it lies in the convex hull
    of the others. We use the robust pairwise formulation: vertex iff there
    is an edge direction for which all points are on/left and p is an
    endpoint — evaluated by the classic 'point-in-hull' LP dual is overkill;
    instead we mark interior points via triple orientation tests against the
    angular order around the centroid, then emit vertices in angular order.

    Simpler exact route used here (matches Andrew chain for points in
    general position, and strictly-convex semantics for collinear/duplicate
    inputs): gift-wrapping with a fori_loop bounded by max_out steps — each
    step is a vectorized argmin over P, so total work is O(max_out * P).
    """
    p = xy.shape[0]
    idx = jnp.arange(p, dtype=jnp.int32)
    alive = idx < count
    big = jnp.float32(3.4e38)

    # start: lowest (y, then x) point — guaranteed hull vertex
    ykey = jnp.where(alive, xy[:, 1], big)
    min_y = jnp.min(ykey)
    cand = alive & (xy[:, 1] == min_y)
    start = jnp.argmin(jnp.where(cand, xy[:, 0], big)).astype(jnp.int32)

    # Dense successor table: for EVERY potential current vertex c, the next
    # CCW hull vertex is the q with no alive k strictly right of c->q
    # (farthest-on-ray tie-break skips collinear interiors). One (P, P, P)
    # orientation pass replaces the per-step (P, P) pass inside the old
    # sequential gift-wrap scan — the walk below is then just max_out tiny
    # gathers instead of max_out full orientation passes.
    d = xy[None, :, :] - xy[:, None, :]                  # (P cur, P other, 2)
    dist2 = jnp.sum(d * d, axis=-1)                      # (P, P)
    cross = (d[:, :, None, 0] * d[:, None, :, 1]
             - d[:, :, None, 1] * d[:, None, :, 0])      # (P cur, P q, P k)
    # The tolerance must scale with |d_q||d_k|: XLA fuses the cross
    # product with FMA, so collinear pairs produce O(eps*|dq||dk|) noise
    # of either sign, and an unscaled "< 0" test misclassifies them.
    tol = 1e-5 * jnp.sqrt(
        jnp.maximum(dist2[:, :, None] * dist2[:, None, :], 1e-30))
    self_or_dead = (~alive)[None, :] | (idx[None, :] == idx[:, None])
    bad = (cross < -tol) & (~self_or_dead)[:, None, :]
    strictly_right_none = ~jnp.any(bad & (~self_or_dead)[:, :, None], axis=2)
    score = jnp.where(strictly_right_none & (~self_or_dead), dist2, -1.0)
    succ = jnp.argmax(score, axis=1).astype(jnp.int32)   # (P,)
    has_next_tab = jnp.max(score, axis=1) > 0.0          # (P,)

    # walk the successor chain, emitting exactly what the sequential
    # gift-wrap emitted (same state machine, table-driven)
    verts = []
    cur, done = start, count < 1
    n_emitted = jnp.int32(0)
    for _ in range(max_out):
        out = jnp.where(done, -1, cur)
        verts.append(out)
        n_emitted = n_emitted + (out >= 0)
        nxt = succ[cur]
        has_next = has_next_tab[cur]
        done = done | (~has_next) | (nxt == start)
        cur = jnp.where(has_next, nxt, cur)
    return jnp.stack(verts), n_emitted


@functools.partial(jax.jit, static_argnames=("max_out",))
def convex_hulls_batched(
    xy: jnp.ndarray, counts: jnp.ndarray, max_out: int
) -> PolygonBatch:
    """CCW convex hulls for a batch of padded clusters.

    xy: (C, P, 2); counts: (C,). Returns PolygonBatch with up to max_out
    vertices per hull (indices resolved to coordinates).

    MEMORY: the dense successor-table formulation materializes (C, P, P, P)
    f32 transients (cross/tolerance/bad tensors) — several hundred MB at
    the current (1024, 32) batch, growing CUBICALLY in P. Raising SMALL_P
    (runtime/pipeline.py) or SMALL_C beyond ~2x re-evaluate this against
    the O(P^2)-per-step scan variant it replaced, or chunk the batch.
    """
    verts_idx, n = jax.vmap(
        lambda a, c: _convex_hull_small_single(a, c, max_out))(xy, counts)
    coords = jnp.take_along_axis(
        xy, jnp.clip(verts_idx, 0, xy.shape[1] - 1)[..., None], axis=1)
    coords = jnp.where((verts_idx >= 0)[..., None], coords, 0.0)
    return PolygonBatch(coords, n.astype(jnp.int32))
