"""Spatially-sharded FULL frame pipeline: GPF + clustering over x-bands.

SURVEY §7 step 6 asks for the whole pipeline under the 'space' axis, not
just clustering. The reference's GPF already partitions by x into
number_of_planar_partitions contiguous bands (ref:
src/segmentation.cpp:104-149); here the x-band BLOCKS of the spatial
sharding are finer than those partitions, and each GPF fit iteration
becomes a distributed moment reduction:

  * prologue (replicated, cheap sorts): partition membership by x-rank
    (with the reference's tail-drop quirk) and the initial seed mask
    (LPR mean + threshold, with both empty-cutoff quirks) — computed
    EXACTLY as the single-device path, on the replicated input;
  * fit iterations (sharded): each block computes masked per-partition
    moment partial sums over ITS points; `lax.psum` over the space axis
    assembles the global centroid/covariance; every device solves the
    same tiny closed-form 3x3 eigenproblem and re-thresholds its own
    points locally. 3 iterations, exactly the reference's loop
    (ref: src/segmentation.cpp:247-309).

Labels match the single-device `gpf_segment` up to f32 reduction order in
the psum'd moments (a few boundary points at the 0.3 m threshold may
flip — the same tolerance as the data-axis sharding, see
__graft_entry__.dryrun_multichip). Clustering then runs `cluster_spatial`
on the sharded obstacle mask — bit-identical to the single-device
clustering of that mask. The hull stage runs unsharded on the
reassembled labels; sharding it would complicate the cluster-contiguity
invariants.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EngineConfig, SegmentationConfig, SpatialConfig
from ..ops.eig3 import smallest_eigenvector_3x3
from ..ops.segmentation import _seed_runs, gpf_segment_sorted  # noqa: F401
from ..types import (SegmentationResult, SEG_GROUND, SEG_OBSTACLE,
                     SEG_UNKNOWN, Plane)
from .spatial import _distribute, cluster_spatial

_BIG = jnp.float32(jnp.finfo(jnp.float32).max)
_HIGHEST = jax.lax.Precision.HIGHEST      # as in ops/segmentation.py


def _gpf_prologue(xyz, mask, cfg: SegmentationConfig):
    """Partition ids + seed mask in ORIGINAL point order (replicated).

    Reuses the exact single-device formulation (two sorts + prefix
    arithmetic, ops/segmentation.py) so partition assignment and seeds are
    bit-identical to gpf_segment; only the fit is distributed.
    """
    num_p = cfg.number_of_planar_partitions
    n_pts = xyz.shape[0]

    sort_key = jnp.where(mask, xyz[:, 0], _BIG)
    _, sz_, order = jax.lax.sort(
        (sort_key, xyz[:, 2], jnp.arange(n_pts, dtype=jnp.int32)),
        num_keys=1)
    n_valid = jnp.sum(mask.astype(jnp.int32))
    per_seg = n_valid // num_p
    ranks = jnp.arange(n_pts, dtype=jnp.int32)
    seg_ids = jnp.where(
        (ranks < per_seg * num_p), ranks // jnp.maximum(per_seg, 1), num_p)
    seg_ids = jnp.where(per_seg > 0, seg_ids, num_p)
    seg_key = jnp.where(ranks < n_valid, seg_ids, num_p + 1)

    _, pz, porig = jax.lax.sort((seg_key, sz_, order), num_keys=2)
    seeds_sorted, seg_of_rank = _seed_runs(pz, per_seg, num_p, cfg)

    # back to original order: pack (seg+1, seed) into one value, ONE
    # 2-operand unsort (seg_of_rank is -1 outside partitions -> 0)
    packed = (seg_of_rank + 1) * 2 + seeds_sorted.astype(jnp.int32)
    _, packed_orig = jax.lax.sort((porig, packed), num_keys=1)
    seg_id = packed_orig // 2 - 1            # (N,) -1 = no partition
    seed = (packed_orig % 2) == 1
    return seg_id, seed


@functools.lru_cache(maxsize=None)
def _make_gpf_spatial_fn(mesh: Mesh, axis: str, s: int,
                         cfg: SegmentationConfig, scfg: SpatialConfig,
                         r: float):
    num_p = cfg.number_of_planar_partitions
    cap = scfg.block_points
    odt = jnp.float32(cfg.orthogonal_distance_threshold)

    def block_body(bx, bo, bv, bseg, bseed):
        bx, bo, bv = bx[0], bo[0], bv[0]
        bseg, bseed = bseg[0], bseed[0]
        in_part = bv & (bseg >= 0)
        pmask = (bseg[None, :] == jnp.arange(num_p, dtype=jnp.int32)[:, None]
                 ) & in_part[None, :]                       # (P, cap)
        seg_n = jax.lax.psum(
            jnp.sum(pmask.astype(jnp.int32), axis=1), axis)  # (P,)

        ground = bseed & in_part
        failed0 = jnp.zeros((num_p,), bool)
        normal0 = jnp.tile(jnp.array([[0.0, 0.0, 1.0]], jnp.float32),
                           (num_p, 1))
        d0 = jnp.zeros((num_p,), jnp.float32)

        def iteration(carry, _):
            ground, failed, normal, d = carry
            w = (pmask & ground[None, :]).astype(jnp.float32)   # (P, cap)
            cnt = jax.lax.psum(jnp.sum(w, axis=1), axis)        # (P,)
            failed_now = failed | (cnt < 3)
            cnt_f = jnp.maximum(cnt, 3.0)

            s1 = jax.lax.psum(
                jnp.matmul(w, bx, precision=_HIGHEST), axis)    # (P,3)
            centroid = s1 / cnt_f[:, None]
            xc = bx[None, :, :] - centroid[:, None, :]          # (P,cap,3)
            s1c = jax.lax.psum(
                jnp.einsum("pn,pni->pi", w, xc, precision=_HIGHEST), axis)
            s2c = jax.lax.psum(
                jnp.einsum("pni,pnj->pij", xc * w[:, :, None], xc,
                           preferred_element_type=jnp.float32,
                           precision=_HIGHEST), axis)
            cov = ((s2c - s1c[:, :, None] * s1c[:, None, :]
                    / cnt_f[:, None, None])
                   / jnp.maximum(cnt_f - 1.0, 1.0)[:, None, None])

            n_vec = jax.vmap(smallest_eigenvector_3x3)(cov)     # (P,3)
            bad = ~jnp.all(jnp.isfinite(n_vec), axis=1)
            failed_now = failed_now | bad
            d_new = jnp.sum(n_vec * centroid, axis=1)
            dist = (jnp.matmul(bx, n_vec.T, precision=_HIGHEST)
                    - d_new[None, :])                           # (cap,P)
            sel = jnp.clip(bseg, 0, num_p - 1)
            my_dist = jnp.take_along_axis(dist, sel[:, None], 1)[:, 0]
            new_ground = in_part & (my_dist < odt)

            keep = failed_now[sel] | ~in_part
            ground_out = jnp.where(keep, ground, new_ground)
            normal_out = jnp.where(failed_now[:, None], normal, n_vec)
            d_out = jnp.where(failed_now, d, d_new)
            return (ground_out, failed_now, normal_out, d_out), None

        (ground, failed, normal, d), _ = jax.lax.scan(
            iteration, (ground, failed0, normal0, d0), None,
            length=cfg.number_of_iterations)

        sel = jnp.clip(bseg, 0, num_p - 1)
        labels = jnp.where(ground, SEG_GROUND, SEG_OBSTACLE).astype(jnp.int32)
        labels = jnp.where(failed[sel], SEG_OBSTACLE, labels)
        too_small = seg_n < 3
        labels = jnp.where(too_small[sel] | ~in_part, SEG_UNKNOWN, labels)
        plane_valid = (~failed) & (~too_small)
        return (labels[None], bo[None], normal[None], d[None],
                plane_valid[None])

    sharded = shard_map(
        block_body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        check_vma=False)

    @jax.jit
    def run(xyz, mask):
        n = xyz.shape[0]
        seg_id, seed = _gpf_prologue(xyz, mask, cfg)
        bx, bo, bv, _x0, _w, ovf_d = _distribute(xyz, mask, s, cap, r)
        # partition id + seed ride into block layout via the orig index
        seg_ext = jnp.concatenate([seg_id, jnp.array([-1], jnp.int32)])
        seed_ext = jnp.concatenate([seed, jnp.array([False])])
        bseg = seg_ext[jnp.where(bo >= 0, bo, n)]
        bseed = seed_ext[jnp.where(bo >= 0, bo, n)]
        sh = NamedSharding(mesh, P(axis))
        bx = jax.lax.with_sharding_constraint(bx, sh)
        bo = jax.lax.with_sharding_constraint(bo, sh)
        bv = jax.lax.with_sharding_constraint(bv, sh)
        bseg = jax.lax.with_sharding_constraint(bseg, sh)
        bseed = jax.lax.with_sharding_constraint(bseed, sh)
        blab, borig, normals, ds, pvalid = sharded(bx, bo, bv, bseg, bseed)
        blab = blab.reshape(-1)
        borig = borig.reshape(-1)
        labels = jnp.full((n,), SEG_UNKNOWN, jnp.int32).at[
            jnp.where(borig >= 0, borig, n)].set(blab, mode="drop")
        labels = jnp.where(mask, labels, SEG_UNKNOWN)
        return labels, normals[0], ds[0], pvalid[0], ovf_d

    return run


def gpf_spatial(mesh: Mesh, xyz, mask, cfg: SegmentationConfig,
                scfg: SpatialConfig, clustering_radius: float,
                axis: str = "space"):
    """GPF ground segmentation of one padded cloud sharded over `axis`.

    Returns (SegmentationResult, overflow): overflow counts points dropped
    by the x-band distribution (block_points cap) — they come back
    SEG_UNKNOWN, and per the package contract that is never silent."""
    s = mesh.shape[axis]
    fn = _make_gpf_spatial_fn(mesh, axis, s, cfg, scfg,
                              float(clustering_radius))
    labels, normals, ds, pvalid, ovf = fn(xyz, mask)
    return SegmentationResult(labels, Plane(normals, ds), pvalid), ovf


def device_frame_step_spatial(mesh: Mesh, xyz, mask, config: EngineConfig,
                              axis: str = "space"):
    """Spatially-sharded segment -> cluster -> hull step for ONE frame.

    Returns a FrameResult like device_frame_step's; seg labels match the
    single-device step within the documented f32 psum tolerance, cluster
    labels are bit-identical to the single-device clustering of the same
    obstacle mask, and the hull stage runs unsharded on the reassembled
    labels (see module docstring).
    """
    from ..ops.hull import label_runs
    from ..runtime.pipeline import NUM_SLOTS, _hull_stage

    r = math.sqrt(config.clustering.distance_squared)
    with mesh:
        seg, seg_ovf = gpf_spatial(mesh, xyz, mask, config.segmentation,
                                   config.spatial, r, axis)
        obstacle = mask & (seg.labels == SEG_OBSTACLE)
        cl = cluster_spatial(mesh, xyz, obstacle, config.clustering,
                             config.pipeline, config.spatial, axis)
    cl = cl._replace(overflow=cl.overflow + seg_ovf)

    @functools.partial(jax.jit, static_argnames=("cfg",))
    def hull(xyz, seg, cl, cfg):
        runs = label_runs(xyz, cl.labels, NUM_SLOTS)
        return _hull_stage(seg, cl, runs, cfg)

    return hull(xyz, seg, cl, config)
