"""End-to-end frame pipeline: segment -> cluster -> polygonize.

The device program (one jitted function per frame shape) performs ground
segmentation, clustering, label-run sorting, and small-cluster convex hulls
entirely on device — the equivalent of Processor::process's stages 1-2 and
the small-cluster branch of stage 3 (ref: src/processor.cpp:135-219,
src/polygon_simplification.cpp:96-115). Large-cluster chi-shape outlines
(Delaunay-based, inherently irregular) run on the host over label-sorted
run slices, using the native C++ module when built, else the scipy oracle
path (ref: src/polygon_simplification.cpp:117-138).

Cluster gathering is ONE label sort (ops/hull.py label_runs): each cluster
becomes a contiguous run, sliced for free on host and window-gathered on
device — replacing the reference's per-point scatter loop
(ref: src/processor.cpp:180-200) without the (C, P) random gather it would
naively map to.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig
from ..ops import clustering as _cellgraph
from ..ops import stixel as _stixel
from ..ops.hull import (LabelRuns, convex_hulls_batched, gather_runs,
                        label_runs, label_runs_presorted)
from ..ops.scan_utils import compact_mask
from ..ops.segmentation import gpf_segment, gpf_segment_sorted
from ..ops.simplify import simplify_ring
from ..types import (ClusteringResult, PolygonBatch, SegmentationResult,
                     SEG_OBSTACLE)

# two-tier outline extraction: small clusters take the device convex-hull
# path, large ones the host concave path (ref: src/polygon_simplification.cpp:98)
SMALL_P = 32          # padded points per small-cluster slot (device hulls)
SMALL_C = 1024        # small-cluster slots
LARGE_C = 512         # large-cluster (host concave) slots
NUM_SLOTS = SMALL_C + LARGE_C   # cluster-id table size


class FrameResult(NamedTuple):
    seg: SegmentationResult
    clustering: ClusteringResult
    runs: LabelRuns               # label-sorted cloud + per-cluster runs
    small_ids: jnp.ndarray        # (SMALL_C,) cluster id per small slot
    small_counts: jnp.ndarray     # (SMALL_C,)
    n_small: jnp.ndarray          # ()
    small_hulls: PolygonBatch     # device convex hulls of small clusters
    large_ids: jnp.ndarray        # (LARGE_C,) cluster id per large slot
    n_large: jnp.ndarray          # ()
    hull_overflow: jnp.ndarray    # () slot-capacity violations


class FrameOutputs(NamedTuple):
    """Host-side per-frame outputs, mirroring the reference's four topics
    (ref: src/processor.cpp:221-267).

    outline_z_extents realizes the reference's planned 2.5-D polygon record
    (PointXYdZ{x, y, z_min, z_max}, ref: src/polygonization.hpp:35-49 — the
    dead-code polygonizer's documented output shape): each 2-D outline
    carries the z range of its cluster's points.
    """

    seg_labels: np.ndarray        # (n,) int32
    cluster_labels: np.ndarray    # (n,) int32 (over the full frame; UNDEFINED
                                  #  for non-obstacle points)
    num_clusters: int
    outlines: List[np.ndarray]    # ordered 2-D polygons, one per cluster
    outline_cluster_ids: List[int]  # cluster id of each outline
    outline_z_extents: List[tuple]  # (z_min, z_max) per outline
    overflow: int
    # per-point intensity, carried through from the input schema
    # (ref: src/dataloader.cpp:106-110 x/y/z/intensity FLOAT32 fields)
    intensity: Optional[np.ndarray] = None


@functools.partial(jax.jit, static_argnames=("config",))
def device_frame_step(
    xyz: jnp.ndarray, mask: jnp.ndarray, config: EngineConfig
) -> FrameResult:
    """Full on-device pipeline for one padded frame.

    On the stixel backend the stages are FUSED in sorted space: gpf leaves
    its results in (partition, z) order, clustering consumes them directly
    and writes BOTH label arrays back to original order with one packed
    scatter, and the hull stage sorts the compacted obstacle buffer instead
    of the full padded cloud — three full-cloud scatter/sorts fewer than
    the stage-by-stage path (kept below for the cellgraph backend).
    """
    if config.pipeline.clustering_backend == "stixel":
        with jax.named_scope("gpf"):
            ss = gpf_segment_sorted(xyz, mask, config.segmentation)
        obstacle_s = ss.valid & (ss.labels == SEG_OBSTACLE)
        with jax.named_scope("clustering"):
            fused = _stixel.cluster_fused(
                ss.xyz, obstacle_s, ss.valid, ss.orig, ss.labels,
                config.clustering, config.pipeline)
        seg = SegmentationResult(fused.seg_labels, ss.planes, ss.plane_valid)
        cl = fused.result
        with jax.named_scope("hulls"):
            runs = label_runs_presorted(
                fused.sorted_xyz, fused.sorted_label, fused.sorted_orig,
                NUM_SLOTS, orig_bound=xyz.shape[0])
            return _hull_stage(seg, cl, runs, config)
    seg = gpf_segment(xyz, mask, config.segmentation)
    obstacle = mask & (seg.labels == SEG_OBSTACLE)
    cl = _cellgraph.cluster(xyz, obstacle, config.clustering, config.pipeline)
    runs = label_runs(xyz, cl.labels, NUM_SLOTS)
    return _hull_stage(seg, cl, runs, config)


def _hull_stage(seg: SegmentationResult, cl: ClusteringResult,
                runs: LabelRuns, config: EngineConfig) -> FrameResult:
    # device convex-hull path only handles up to SMALL_P points per cluster
    small_cut = min(config.polygonization.small_cluster_size, SMALL_P + 1)
    present = runs.counts > 0
    is_small = present & (runs.counts < small_cut)
    small_idx, n_small, ovf_s = compact_mask(is_small, SMALL_C)
    small_act = jnp.arange(SMALL_C, dtype=jnp.int32) < n_small
    s_starts = jnp.where(small_act, runs.starts[small_idx], 0)
    s_counts = jnp.where(small_act, runs.counts[small_idx], 0)
    small_pts = gather_runs(runs.sorted_xyz, s_starts, s_counts, SMALL_P)
    small_hulls = convex_hulls_batched(
        small_pts[..., :2], s_counts, min(SMALL_P, small_cut + 1))

    large_idx, n_large, ovf_l = compact_mask(present & ~is_small, LARGE_C)
    hull_overflow = runs.overflow + ovf_s + ovf_l
    return FrameResult(seg, cl, runs, small_idx, s_counts, n_small,
                       small_hulls, large_idx, n_large, hull_overflow)


@functools.lru_cache(maxsize=1)
def _hull_pool():
    """Shared thread pool for host hull extraction (native calls drop
    the GIL; threads scale over host cores)."""
    import concurrent.futures as _cf
    import os
    # oversubscribe ~4x: per-cluster times are lumpy (one 7k-point wall
    # next to hundreds of 30-point cars) and the tail hides behind the OS
    # scheduler
    workers = min(16, 4 * (os.cpu_count() or 2))
    return _cf.ThreadPoolExecutor(max_workers=workers)


def _outlines_from_slices(slices: List[np.ndarray],
                          config: EngineConfig) -> List[np.ndarray]:
    """Large-cluster outlines from per-cluster xy arrays.

    polygonizer_concave=True (default): chi-shape concave hulls, the
    reference's live path (ref: src/polygon_simplification.cpp:117-138).
    polygonizer_concave=False: all-convex outlines, with Chan's algorithm
    above chan_threshold points — the reference's alternate
    findOrderedConvexOutlines path (ref: src/polygon_simplification.cpp:
    32-63, selection :53-55). Native C++ when built, oracle fallback.
    """
    from ..ops import hull_native
    pcfg = config.polygonization
    m = len(slices)
    if m == 0:
        return []

    if pcfg.polygonizer_concave and hull_native.native_available():
        # ONE native call for the whole frame: internal C++ thread pool,
        # no per-cluster ctypes/GIL round trips; largest-first for load
        # balance (one 7k-point wall next to hundreds of small clusters)
        order = sorted(range(m), key=lambda k: -len(slices[k]))
        offs = np.zeros(m + 1, np.int64)
        for i, k in enumerate(order):
            offs[i + 1] = offs[i] + len(slices[k])
        packed = np.ascontiguousarray(
            np.concatenate([slices[k] for k in order]), np.float32)
        hulls = hull_native.chi_hulls_batch(packed, offs, pcfg.chi)
        results: List = [None] * m
        for k, h in zip(order, hulls):
            results[k] = h
        return results

    def one(k: int) -> np.ndarray:
        xy = slices[k]
        if pcfg.polygonizer_concave:
            return hull_native.chi_concave_hull(xy, pcfg.chi)
        algo = "chan" if len(xy) > pcfg.chan_threshold else "monotone"
        idx = hull_native.convex_hull_indices(xy, algorithm=algo)
        return xy[idx].astype(np.float32)

    # the native calls release the GIL (ctypes), so a thread pool scales
    # across host cores; largest-first order avoids a long tail
    if m >= 8 and hull_native.native_available():
        order = sorted(range(m), key=lambda k: -len(slices[k]))
        results2: List = [None] * m
        for k, out in zip(order, _hull_pool().map(one, order)):
            results2[k] = out
        return results2
    return [one(k) for k in range(m)]


def run_frame(
    xyz_padded: jnp.ndarray, mask: jnp.ndarray, config: EngineConfig,
    n_points: Optional[int] = None,
    intensity: Optional[np.ndarray] = None,
) -> FrameOutputs:
    """Device step + host polygonization for one frame."""
    fr = device_frame_step(xyz_padded, mask, config)
    n = int(n_points) if n_points is not None else int(mask.sum())
    return host_outputs(fr, config, n, intensity=intensity)


def host_outputs(fr: FrameResult, config: EngineConfig,
                 n: int, intensity: Optional[np.ndarray] = None,
                 with_outlines: bool = True) -> FrameOutputs:
    """Host-side readout + polygonization of a device FrameResult.

    Exact (float32) readout path. The streaming runtime uses the slimmer
    quantized single-buffer path (device_frame_step_packed +
    host_outputs_packed) instead — see the payload section below.
    """
    # ONE bulk transfer for the whole result tree: per-leaf np.asarray
    # costs a host<->device round trip EACH, device_get batches them
    fr = jax.device_get(fr)
    sorted_xyz = np.asarray(fr.runs.sorted_xyz)
    starts = np.asarray(fr.runs.starts)
    counts = np.asarray(fr.runs.counts)
    large_ids = np.asarray(fr.large_ids)
    n_large = int(fr.n_large)
    slices = [
        sorted_xyz[int(starts[int(large_ids[k])]):
                   int(starts[int(large_ids[k])])
                   + int(counts[int(large_ids[k])]), :2]
        for k in range(n_large)]

    def zext(c: int):
        s, cnt = int(starts[c]), int(counts[c])
        zs = sorted_xyz[s:s + cnt, 2]
        return ((float(zs.min()), float(zs.max())) if cnt > 0
                else (0.0, 0.0))

    return _assemble_outputs(
        seg_labels=np.asarray(fr.seg.labels),
        cl_labels=np.asarray(fr.clustering.labels),
        small_ids=np.asarray(fr.small_ids),
        n_small=int(fr.n_small),
        sh_v=np.asarray(fr.small_hulls.vertices),
        sh_n=np.asarray(fr.small_hulls.counts),
        large_ids=large_ids, n_large=n_large, large_slices=slices,
        zext=zext,
        num_clusters=int(fr.clustering.num_clusters),
        overflow=int(fr.clustering.overflow) + int(fr.hull_overflow),
        config=config, n=n, intensity=intensity,
        with_outlines=with_outlines)


def _assemble_outputs(seg_labels, cl_labels, small_ids, n_small, sh_v, sh_n,
                      large_ids, n_large, large_slices, zext,
                      num_clusters, overflow, config: EngineConfig, n: int,
                      intensity=None, with_outlines=True) -> FrameOutputs:
    """Build FrameOutputs from host arrays (shared by the exact and
    packed-payload readout paths). zext(c) -> (z_min, z_max) per slot."""
    if not with_outlines:
        return FrameOutputs(
            seg_labels=seg_labels[:n], cluster_labels=cl_labels[:n],
            num_clusters=num_clusters, outlines=[], outline_cluster_ids=[],
            outline_z_extents=[], overflow=overflow,
            intensity=(np.asarray(intensity)[:n]
                       if intensity is not None else None))
    outlines: List[np.ndarray] = []
    outline_ids: List[int] = []
    for c in range(n_small):
        k = int(sh_n[c])
        if k > 0:
            outlines.append(sh_v[c, :k].astype(np.float32))
            outline_ids.append(int(small_ids[c]))

    outlines.extend(_outlines_from_slices(large_slices, config))
    outline_ids.extend(int(large_ids[k]) for k in range(n_large))

    # vertex-count cap (ref: src/polygonization.hpp:56 max_polygon_points)
    pcfg = config.polygonization
    if pcfg.simplify_convex_by_maximum_points:
        outlines = [simplify_ring(o, pcfg.max_points_in_polygon)
                    for o in outlines]

    # 2.5-D record: z extent per outlined cluster from its label run
    # (ref: src/polygonization.hpp:35-49 PointXYdZ{x,y,z_min,z_max})
    z_extents = [zext(c) for c in outline_ids]

    return FrameOutputs(
        seg_labels=seg_labels[:n],
        cluster_labels=cl_labels[:n],
        num_clusters=num_clusters,
        outlines=outlines,
        outline_cluster_ids=outline_ids,
        outline_z_extents=z_extents,
        overflow=overflow,
        intensity=(np.asarray(intensity)[:n]
                   if intensity is not None else None),
    )


# --------------------------------------------------------------------------
# Packed host payload: everything the streaming readout needs, as ONE slim
# int32 device array. Rationale: a FrameResult has ~20 leaves and ~2.2 MB,
# each leaf a transfer of its own; one contiguous ~0.6 MB buffer is a
# single DMA.
#
# Size tricks (packed path only — the exact host_outputs path is float32):
#   * seg (2 bits) + cluster id (11 bits) pack as 13-bit codes, TWO per
#     int32 word;
#   * per-slot z extents are reduced ON DEVICE (two scatter-mins), so the
#     (NO, 3) sorted cloud never crosses the link;
#   * only LARGE-cluster xy crosses, compacted by one sort and quantized
#     to a 1/256 m grid relative to the frame's min corner (<= 2 mm error,
#     well under the 0.3 m clustering scales; outline vertices are
#     visualization/marker outputs, ref: src/conversions.hpp:86-118);
#   * small-hull vertices quantize the same way.
#
# Layout (int32 words):
#   header (8): n_small, n_large, num_clusters, overflow, n_large_pts,
#               origin_x (f32 bits), origin_y (f32 bits),
#               quantization scale (f32 bits)
#   labels   (N/2)        two 13-bit codes per word (lo | hi<<16)
#   zmin     (S) f32 bits; zmax (S) f32 bits
#   small_ids (SC); sh_counts (SC)
#   sh_vq    (SC*P_out)   one word per vertex: x_q | y_q<<16 (u16 halves)
#   large_ids (LC); large_counts (LC)
#   large_xy_q (LP)       one word per point: x_q | y_q<<16
# --------------------------------------------------------------------------

# Quantization scale is DYNAMIC per frame: scale = 65535 / max(span_x,
# span_y), clamped to [16, 8192] — ~1 mm grid on KITTI-sized frames
# (~120 m span), degrading gracefully for huge scenes instead of clipping.
_Q_MIN, _Q_MAX = 16.0, 8192.0


def _payload_dims(config: EngineConfig):
    small_cut = min(config.polygonization.small_cluster_size, SMALL_P + 1)
    p_out = min(SMALL_P, small_cut + 1)
    # the sorted-run buffer has NO rows on the stixel backend, N on the
    # cellgraph backend; the large-point cap cannot exceed it
    rows = (config.pipeline.max_obstacle_points
            if config.pipeline.clustering_backend == "stixel"
            else config.pipeline.max_points)
    lp = min(config.pipeline.payload_large_points, rows)
    return (config.pipeline.max_points, config.pipeline.max_obstacle_points,
            NUM_SLOTS, SMALL_C, LARGE_C, p_out, lp)


def _quant(v, origin, scale):
    return jnp.clip(jnp.round((v - origin) * scale), 0, 65535).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("config",))
def pack_host_payload(fr: FrameResult, config: EngineConfig) -> jnp.ndarray:
    from ..types import CLUSTER_UNDEFINED
    N, NO, S, SC, LC, p_out, LP = _payload_dims(config)

    # 13-bit label codes, two per word
    cl = fr.clustering.labels
    cl_enc = jnp.where(cl == CLUSTER_UNDEFINED, 0, cl + 2)
    code = (cl_enc << 2) | fr.seg.labels
    labels_packed = code[0::2] | (code[1::2] << 16)

    skey = fr.runs.sorted_key                      # (NO,) slot per row
    valid_row = skey < S
    z = fr.runs.sorted_xyz[:, 2]
    zmin = jnp.full((S,), jnp.inf, jnp.float32).at[skey].min(
        jnp.where(valid_row, z, jnp.inf), mode="drop")
    zmax = jnp.full((S,), -jnp.inf, jnp.float32).at[skey].max(
        jnp.where(valid_row, z, -jnp.inf), mode="drop")
    zmin = jnp.where(jnp.isfinite(zmin), zmin, 0.0)
    zmax = jnp.where(jnp.isfinite(zmax), zmax, 0.0)

    # quantization origin: min corner over valid rows
    xy = fr.runs.sorted_xyz[:, :2]
    big = jnp.float32(3e38)
    ox = jnp.min(jnp.where(valid_row, xy[:, 0], big))
    oy = jnp.min(jnp.where(valid_row, xy[:, 1], big))
    ox = jnp.where(jnp.abs(ox) < big, ox, 0.0)
    oy = jnp.where(jnp.abs(oy) < big, oy, 0.0)

    # dynamic quantization scale from the frame's xy span
    sx = jnp.max(jnp.where(valid_row, xy[:, 0], -big)) - ox
    sy = jnp.max(jnp.where(valid_row, xy[:, 1], -big)) - oy
    span = jnp.clip(jnp.maximum(sx, sy), 1e-3, None)
    scale = jnp.clip(65535.0 / span, _Q_MIN, _Q_MAX).astype(jnp.float32)

    # large-cluster point compaction: one 2-operand sort brings large-run
    # rows (already in ascending cluster order) to the front
    act_l = jnp.arange(LC, dtype=jnp.int32) < fr.n_large
    is_large_slot = jnp.zeros((S + 1,), bool).at[
        jnp.where(act_l, fr.large_ids, S + 1)].set(True, mode="drop")
    pt_large = is_large_slot[skey]
    xy_q = _quant(xy[:, 0], ox, scale) | (_quant(xy[:, 1], oy, scale) << 16)
    pos = jnp.arange(xy.shape[0], dtype=jnp.int32)   # NO or N rows per backend
    sort_key = jnp.where(pt_large, pos, jnp.int32(2**30))
    _, xy_q_sorted = jax.lax.sort((sort_key, xy_q), num_keys=1)
    large_xy_q = xy_q_sorted[:LP]
    n_large_pts = jnp.sum(pt_large.astype(jnp.int32))
    pay_ovf = jnp.maximum(n_large_pts - LP, 0)
    large_counts = jnp.where(act_l, fr.runs.counts[fr.large_ids], 0)

    sh_q = (_quant(fr.small_hulls.vertices[..., 0], ox, scale)
            | (_quant(fr.small_hulls.vertices[..., 1], oy, scale) << 16))

    bits = functools.partial(jax.lax.bitcast_convert_type,
                             new_dtype=jnp.int32)
    header = jnp.stack([
        fr.n_small, fr.n_large, fr.clustering.num_clusters,
        fr.clustering.overflow + fr.hull_overflow + pay_ovf,
        jnp.minimum(n_large_pts, LP),
        bits(ox), bits(oy),
        bits(scale),
    ])
    parts = [
        header,
        labels_packed.astype(jnp.int32),
        bits(zmin), bits(zmax),
        fr.small_ids, fr.small_hulls.counts.astype(jnp.int32),
        sh_q.reshape(-1),
        fr.large_ids, large_counts.astype(jnp.int32),
        large_xy_q,
    ]
    return jnp.concatenate(parts)


@functools.partial(jax.jit, static_argnames=("config",))
def device_frame_step_packed(xyz: jnp.ndarray, mask: jnp.ndarray,
                             config: EngineConfig) -> jnp.ndarray:
    """device_frame_step + single-buffer host payload (the streaming path)."""
    return pack_host_payload(device_frame_step(xyz, mask, config), config)


def host_outputs_packed(payload, config: EngineConfig, n: int,
                        intensity: Optional[np.ndarray] = None,
                        with_outlines: bool = True) -> FrameOutputs:
    """host_outputs from a pack_host_payload buffer (one device_get)."""
    from ..types import CLUSTER_UNDEFINED
    buf = np.asarray(jax.device_get(payload))
    N, NO, S, SC, LC, p_out, LP = _payload_dims(config)
    o = 8
    labels_packed = buf[o:o + N // 2]; o += N // 2
    zmin = buf[o:o + S].view(np.float32); o += S
    zmax = buf[o:o + S].view(np.float32); o += S
    small_ids = buf[o:o + SC]; o += SC
    sh_n = buf[o:o + SC]; o += SC
    sh_q = buf[o:o + SC * p_out].view(np.uint32).reshape(SC, p_out)
    o += SC * p_out
    large_ids = buf[o:o + LC]; o += LC
    large_counts = buf[o:o + LC]; o += LC
    large_xy_q = buf[o:o + LP].view(np.uint32); o += LP
    assert o == buf.shape[0], (o, buf.shape)

    n_small, n_large = int(buf[0]), int(buf[1])
    n_large_pts = int(buf[4])
    ox = float(buf[5:6].view(np.float32)[0])
    oy = float(buf[6:7].view(np.float32)[0])
    scale = float(buf[7:8].view(np.float32)[0])

    # decode labels (two 13-bit codes per word)
    w = labels_packed.view(np.uint32)
    code = np.empty(N, np.int32)
    code[0::2] = w & 0xFFFF
    code[1::2] = w >> 16
    seg_labels = (code & 3).astype(np.int32)
    cl_enc = code >> 2
    cl_labels = np.where(cl_enc == 0, CLUSTER_UNDEFINED,
                         cl_enc - 2).astype(np.int32)

    def dq(words: np.ndarray) -> np.ndarray:
        out = np.empty(words.shape + (2,), np.float32)
        out[..., 0] = ox + (words & 0xFFFF).astype(np.float32) / scale
        out[..., 1] = oy + (words >> 16).astype(np.float32) / scale
        return out

    sh_v = dq(sh_q)
    large_xy = dq(large_xy_q)
    ends = np.cumsum(large_counts[:n_large])
    slices = []
    for k in range(n_large):
        lo = int(ends[k]) - int(large_counts[k])
        hi = int(ends[k])
        if hi <= n_large_pts:
            slices.append(large_xy[lo:hi])
        else:                      # payload cap overflow: emit empty hull
            slices.append(large_xy[lo:lo])

    def zext(c: int):
        return (float(zmin[c]), float(zmax[c]))

    return _assemble_outputs(
        seg_labels=seg_labels, cl_labels=cl_labels,
        small_ids=small_ids, n_small=n_small, sh_v=sh_v, sh_n=sh_n,
        large_ids=large_ids, n_large=n_large, large_slices=slices,
        zext=zext, num_clusters=int(buf[2]), overflow=int(buf[3]),
        config=config, n=n, intensity=intensity,
        with_outlines=with_outlines)
