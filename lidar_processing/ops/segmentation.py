"""Device GPF ground segmentation — masked, fixed-shape, jit/vmap friendly.

Data-parallel redesign of the reference's serial Zermas-style Ground Plane
Fitting (ref: src/segmentation.cpp:62-345):

  * the parallel x-sort + contiguous split (ref: :104-149) becomes one
    device sort with rank-derived partition ids (the integer-division
    tail-drop quirk is preserved: ranks >= P*(n//P) stay UNKNOWN);
  * seed selection (z-sort + cutoff scans, ref: :151-217) becomes a SECOND
    sort by (partition, z): each partition is then a contiguous run in
    ascending z, so the below-ground drop is a run prefix, the LPR mean of
    the lowest min(5000, n) points is a prefix-sum difference, and both
    empty-cutoff quirks are two scalar comparisons (no per-partition
    top-k);
  * the per-iteration covariance (ref: :76-85) is computed as masked moment
    products X^T diag(w) X at full float32 precision, with a pre-centering
    pass to avoid catastrophic cancellation;
  * Eigen::JacobiSVD (ref: :87-99) is replaced by the closed-form 3x3
    eigensolver (ops/eig3.py), normal canonicalized upward;
  * the re-threshold is the SIGNED test  (X @ n - d) < odt * ||n||  over all
    partition points, exactly as the reference (ref: :285-307).

All partitions are processed as a batch (vmap) — the reference's serial
partition loop disappears. The fit runs entirely in (partition, z)-sorted
space (every reduction it does is order-independent up to f32 rounding);
`gpf_segment_sorted` exposes that space so the fused frame pipeline can
carry labels through the clustering sort and write back original-order
labels with ONE scatter for both stages (runtime/pipeline.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import SegmentationConfig
from ..types import (Plane, SegmentationResult, SEG_GROUND, SEG_OBSTACLE,
                     SEG_UNKNOWN)
from .eig3 import smallest_eigenvector_3x3

_BIG = jnp.float32(jnp.finfo(jnp.float32).max)
# every float32 product in the fit runs at full precision: a reduced-
# precision (TF32) dot keeps ~3 decimal digits, and the ground test compares
# a signed distance with 0.3 m at ranges of tens of metres
_HIGHEST = jax.lax.Precision.HIGHEST


class SortedSegmentation(NamedTuple):
    """gpf output in (partition, z)-sorted space (no unsort scatter).

    xyz:    (N, 3) f32 cloud sorted by (partition id, z); invalid points
            and the tail-drop quirk's points sort last.
    labels: (N,) i32 GROUND/OBSTACLE/UNKNOWN per sorted position.
    orig:   (N,) i32 original index per sorted position.
    valid:  (N,) bool validity per sorted position.
    planes: per-partition fitted planes.
    plane_valid: (P,) bool.
    """

    xyz: jnp.ndarray
    labels: jnp.ndarray
    orig: jnp.ndarray
    valid: jnp.ndarray
    planes: Plane
    plane_valid: jnp.ndarray


def _seed_runs(z_s: jnp.ndarray, per_seg: jnp.ndarray, num_p: int,
               cfg: SegmentationConfig
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Initial seed mask over the (partition, z)-sorted cloud.

    Implements ref: src/segmentation.cpp:151-217 per partition run:
    partition p occupies sorted ranks [p*per_seg, (p+1)*per_seg), ascending
    in z. Returns (seeds (N,) bool, seg_of_rank (N,) i32 with -1 padding).
    """
    n = z_s.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    in_any = pos < per_seg * num_p
    seg_of_rank = jnp.where(in_any, pos // jnp.maximum(per_seg, 1), -1)
    seg_of_rank = jnp.where(per_seg > 0, seg_of_rank, -1)

    z_min_cut = jnp.float32(-cfg.z_min_outlier_scale * cfg.sensor_height_m)
    k_cfg = jnp.int32(min(cfg.number_of_lower_point_representatives, n))
    csum = jnp.cumsum(z_s)

    below = (z_s <= z_min_cut) & in_any
    # per-partition count of below-cutoff points (each partition's below
    # points form the PREFIX of its ascending-z run)
    seg_iota = jnp.arange(num_p, dtype=jnp.int32)
    below_per = jnp.sum(
        below[None, :] & (seg_of_rank[None, :] == seg_iota[:, None]),
        axis=1).astype(jnp.int32)                       # (P,)

    start = seg_iota * per_seg
    n_p = jnp.where(per_seg > 0, per_seg, 0)
    has_above = below_per < n_p
    # quirk: if NO point clears the cutoff, nothing is dropped
    n_drop = jnp.where(has_above, below_per, 0)
    s_kept = start + n_drop
    n_kept = n_p - n_drop
    k_eff = jnp.minimum(n_kept, k_cfg)

    # LPR mean via prefix sums over the ascending-z runs
    hi = jnp.clip(s_kept + k_eff - 1, 0, n - 1)
    lo = jnp.clip(s_kept - 1, 0, n - 1)
    z_sum = csum[hi] - jnp.where(s_kept > 0, csum[lo], 0.0)
    z_mean = z_sum / jnp.maximum(k_eff, 1).astype(jnp.float32)
    z_max_cut = z_mean + jnp.float32(cfg.initial_seed_threshold)

    # quirk: if no kept point exceeds the threshold the seed set is EMPTY;
    # the kept run's max z is its last element
    run_max = z_s[jnp.clip(start + n_p - 1, 0, n - 1)]
    any_above = run_max > z_max_cut
    seg_ok = (n_kept > 0) & any_above                   # (P,)

    sel = jnp.clip(seg_of_rank, 0, num_p - 1)
    seeds = (in_any & (pos >= s_kept[sel]) & (z_s <= z_max_cut[sel])
             & seg_ok[sel])
    return seeds, seg_of_rank


def _fit_partition(
    pts: jnp.ndarray, seg_mask: jnp.ndarray, seeds: jnp.ndarray,
    cfg: SegmentationConfig
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """GPF iterations for one partition (any point order).

    pts: (N,3) cloud; seg_mask: (N,) partition membership; seeds: initial
    ground mask. Returns (labels (N,) int32 valid only under seg_mask,
    normal (3,), d (), plane_valid ()).
    """
    seg_n = jnp.sum(seg_mask.astype(jnp.int32))
    ground = seeds

    odt = jnp.float32(cfg.orthogonal_distance_threshold)

    def iteration(carry, _):
        ground, failed, normal, d = carry
        cnt = jnp.sum(ground.astype(jnp.int32))
        failed_now = failed | (cnt < 3)
        cnt_f = jnp.maximum(cnt, 3).astype(jnp.float32)

        w = ground.astype(jnp.float32)
        # two-pass masked moments: center on the masked mean first so the
        # covariance matmul does not cancel catastrophically in f32
        s1 = jnp.matmul(w, pts, precision=_HIGHEST)    # (3,)
        centroid = s1 / cnt_f
        xc = pts - centroid
        s1c = jnp.matmul(w, xc, precision=_HIGHEST)
        s2c = jnp.einsum("ni,nj->ij", xc * w[:, None], xc,
                         preferred_element_type=jnp.float32,
                         precision=_HIGHEST)
        cov = (s2c - jnp.outer(s1c, s1c) / cnt_f) / jnp.maximum(cnt_f - 1.0, 1.0)

        n_vec = smallest_eigenvector_3x3(cov)
        bad = ~jnp.all(jnp.isfinite(n_vec))
        failed_now = failed_now | bad
        d_new = jnp.matmul(n_vec, centroid, precision=_HIGHEST)
        dist = jnp.matmul(pts, n_vec, precision=_HIGHEST) - d_new
        # SIGNED comparison (ref: src/segmentation.cpp:299); ||n|| == 1
        new_ground = seg_mask & (dist < odt)

        ground_out = jnp.where(failed_now, ground, new_ground)
        normal_out = jnp.where(failed_now, normal, n_vec)
        d_out = jnp.where(failed_now, d, d_new)
        return (ground_out, failed_now, normal_out, d_out), None

    init = (ground, jnp.bool_(False), jnp.array([0.0, 0.0, 1.0], jnp.float32),
            jnp.float32(0.0))
    (ground, failed, normal, d), _ = jax.lax.scan(
        iteration, init, None, length=cfg.number_of_iterations)

    labels = jnp.where(ground, SEG_GROUND, SEG_OBSTACLE).astype(jnp.int32)
    labels = jnp.where(failed, SEG_OBSTACLE, labels)
    # <3-point partitions stay UNKNOWN (ref: src/segmentation.cpp:224-229)
    too_small = seg_n < 3
    labels = jnp.where(too_small, SEG_UNKNOWN, labels)
    plane_valid = (~failed) & (~too_small)
    return labels, normal, d, plane_valid


@functools.partial(jax.jit, static_argnames=("cfg",))
def gpf_segment_sorted(
    xyz: jnp.ndarray, mask: jnp.ndarray, cfg: SegmentationConfig
) -> SortedSegmentation:
    """Segment a padded cloud; results stay in (partition, z)-sorted space.

    xyz: (N,3) float32 padded cloud; mask: (N,) bool validity.
    """
    num_p = cfg.number_of_planar_partitions
    n_pts = xyz.shape[0]

    # sort 1: by x — partition membership is x-rank // per_seg
    # (ref: src/segmentation.cpp:104-149). The multi-operand sort carries
    # the coordinates and original index, so no gather is needed.
    sort_key = jnp.where(mask, xyz[:, 0], _BIG)
    _, sx_, sy_, sz_, order = jax.lax.sort(
        (sort_key, xyz[:, 0], xyz[:, 1], xyz[:, 2],
         jnp.arange(n_pts, dtype=jnp.int32)), num_keys=1)

    n_valid = jnp.sum(mask.astype(jnp.int32))
    per_seg = n_valid // num_p
    ranks = jnp.arange(n_pts, dtype=jnp.int32)
    seg_ids = jnp.where(
        (ranks < per_seg * num_p), ranks // jnp.maximum(per_seg, 1), num_p)
    seg_ids = jnp.where(per_seg > 0, seg_ids, num_p)
    # tail-drop-quirk points (valid, UNKNOWN) get key num_p; padding rows
    # key num_p + 1 so valid points stay in sorted ranks [0, n_valid)
    seg_key = jnp.where(ranks < n_valid, seg_ids, num_p + 1)

    # sort 2: by (partition, z) — every partition becomes a contiguous run
    # ascending in z, which turns seed selection into prefix arithmetic
    # (ref: src/segmentation.cpp:151-217's z-sort, done once for all
    # partitions). Stable, so ties keep x-rank order.
    _, pz, px, py, porig = jax.lax.sort(
        (seg_key, sz_, sx_, sy_, order), num_keys=2)
    sp = jnp.stack([px, py, pz], axis=1)

    seeds, seg_of_rank = _seed_runs(pz, per_seg, num_p, cfg)
    seg_masks = seg_of_rank[None, :] == jnp.arange(
        num_p, dtype=jnp.int32)[:, None]
    seeds_p = seg_masks & seeds[None, :]

    fit = jax.vmap(_fit_partition, in_axes=(None, 0, 0, None))
    labels_p, normals, ds, valids = fit(sp, seg_masks, seeds_p, cfg)

    # combine partitions: each sorted position belongs to at most one segment
    labels_sorted = jnp.full((n_pts,), SEG_UNKNOWN, jnp.int32)
    for s in range(num_p):
        labels_sorted = jnp.where(seg_masks[s], labels_p[s], labels_sorted)

    # valid points (including the tail-drop quirk's UNKNOWN ones) occupy
    # sorted ranks [0, n_valid): sort 1 ranks them first, and sort 2's key
    # gives padding rows the strictly larger key num_p + 1
    valid_sorted = jnp.arange(n_pts, dtype=jnp.int32) < n_valid
    return SortedSegmentation(sp, labels_sorted, porig, valid_sorted,
                              Plane(normals, ds), valids)


@functools.partial(jax.jit, static_argnames=("cfg",))
def gpf_segment(
    xyz: jnp.ndarray, mask: jnp.ndarray, cfg: SegmentationConfig
) -> SegmentationResult:
    """Segment a padded cloud into GROUND/OBSTACLE/UNKNOWN.

    xyz: (N,3) float32 padded cloud; mask: (N,) bool validity.
    Returns per-point labels in the ORIGINAL point order plus the fitted
    planes per partition.
    """
    ss = gpf_segment_sorted(xyz, mask, cfg)
    # ss.orig is a permutation of [0, n): unsort via ONE 2-operand sort
    # instead of a full-cloud scatter
    _, labels = jax.lax.sort((ss.orig, ss.labels), num_keys=1)
    labels = jnp.where(mask, labels, SEG_UNKNOWN)
    return SegmentationResult(labels, ss.planes, ss.plane_valid)
