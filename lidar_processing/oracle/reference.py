"""Faithful host-side (NumPy) emulation of the reference pipeline.

This module is the correctness anchor for the device engine: it re-implements the
*behavioral contract* of the reference's C++ pipeline — Zermas-style ground
plane fitting (ref: src/segmentation.cpp:62-345), FEC-style Euclidean
clustering (ref: src/clustering.cpp:47-125), and hull polygonization
(ref: src/polygon_simplification.cpp:32-150) — including its documented quirks:

  * integer-division partition split drops up to (partitions-1) trailing
    x-sorted points, which stay UNKNOWN (ref: src/segmentation.cpp:124-148);
  * the cutoff-scan in seed extraction leaves the cutoff at 0 when no element
    exceeds the threshold, yielding "drop nothing" for the z-min scan and an
    *empty* seed set for the z-max scan (ref: src/segmentation.cpp:173-180,
    :202-210);
  * the ground re-threshold uses the SIGNED plane distance (no abs), so points
    arbitrarily far below the plane are ground (ref: src/segmentation.cpp:299);
  * FEC cluster-size checks count duplicate discoveries (a point re-labeled
    before removal is appended to the member list again,
    ref: src/clustering.cpp:99-100,113).

Documented divergences (the reference cannot be built here — its hull
submodules are empty — so these conventions define this repo's ground truth):

  * The plane normal sign from Eigen::JacobiSVD is algorithm-defined; we
    canonicalize it to point upward (n_z >= 0), the physically meaningful
    orientation for a ground plane.
  * Neighbor enumeration order during FEC BFS follows ascending point index
    (the reference's order is KD-tree traversal order, ref: src/kdtree.hpp:292).
    This can differ only through discovery-order shielding edge cases.
  * Floating-point accumulations use float64 here (the reference uses float32
    Eigen ops); the device path is diffed against this oracle with IoU/F1
    tolerances that absorb borderline flips.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ..config import (ClusteringConfig, EngineConfig, PolygonizationConfig,
                      SegmentationConfig)
from ..types import (CLUSTER_INVALID, CLUSTER_UNDEFINED, SEG_GROUND,
                     SEG_OBSTACLE, SEG_UNKNOWN)

# ---------------------------------------------------------------------------
# Ground segmentation (GPF)
# ---------------------------------------------------------------------------


def _plane_from_points(g: np.ndarray) -> Optional[Tuple[np.ndarray, float]]:
    """Least-squares plane through points g (m,3) -> (unit normal, d).

    Covariance eigen-decomposition, smallest-eigenvalue eigenvector as normal
    (ref: src/segmentation.cpp:62-102). Normal canonicalized upward.
    """
    if g.shape[0] < 3:
        return None
    g64 = g.astype(np.float64)
    centroid = g64.mean(axis=0)
    centered = g64 - centroid
    cov = centered.T @ centered / (g.shape[0] - 1)
    if not np.all(np.isfinite(cov)):
        return None
    w, v = np.linalg.eigh(cov)
    normal = v[:, 0]
    # canonical sign: upward; fall back to largest-magnitude component positive
    if normal[2] < 0.0:
        normal = -normal
    elif normal[2] == 0.0:
        k = int(np.argmax(np.abs(normal)))
        if normal[k] < 0.0:
            normal = -normal
    d = float(normal @ centroid)
    return normal, d


def _extract_initial_seeds(z: np.ndarray, cfg: SegmentationConfig) -> np.ndarray:
    """Seed indices into the segment (ref: src/segmentation.cpp:151-217)."""
    order = np.argsort(z, kind="stable")
    zs = z[order].astype(np.float64)

    z_min_cut = -cfg.z_min_outlier_scale * cfg.sensor_height_m
    above = zs > z_min_cut
    start = int(np.argmax(above)) if above.any() else 0  # quirk: 0 if none
    order = order[start:]
    zs = zs[start:]
    if order.size == 0:
        return order

    k = min(cfg.number_of_lower_point_representatives, order.size)
    z_mean = float(zs[:k].mean())
    z_max_cut = z_mean + cfg.initial_seed_threshold
    above2 = zs > z_max_cut
    cut = int(np.argmax(above2)) if above2.any() else 0  # quirk: empty seeds
    return order[:cut]


def _fit_ground_plane(
    pts: np.ndarray, cfg: SegmentationConfig
) -> Tuple[np.ndarray, Optional[Tuple[np.ndarray, float]]]:
    """Per-segment labels (ref: src/segmentation.cpp:219-309).

    Returns (labels in {UNKNOWN, GROUND, OBSTACLE} for the segment, plane).
    """
    m = pts.shape[0]
    labels = np.full(m, SEG_UNKNOWN, np.int32)
    if m < 3:
        return labels, None  # early return: segment stays UNKNOWN

    seed_idx = _extract_initial_seeds(pts[:, 2], cfg)
    ground_mask = np.zeros(m, bool)
    ground_mask[seed_idx] = True

    pts64 = pts.astype(np.float64)
    plane = None
    for _ in range(cfg.number_of_iterations):
        if int(ground_mask.sum()) < 3:
            labels[:] = SEG_OBSTACLE  # all-obstacle fallback
            return labels, None
        plane = _plane_from_points(pts[ground_mask])
        if plane is None:
            labels[:] = SEG_OBSTACLE
            return labels, None
        normal, d = plane
        dist = pts64 @ normal - d
        # SIGNED comparison, matching the reference exactly
        thr = cfg.orthogonal_distance_threshold * float(np.linalg.norm(normal))
        ground_mask = dist < thr

    labels[:] = np.where(ground_mask, SEG_GROUND, SEG_OBSTACLE)
    return labels, plane


class OracleSegmentation(NamedTuple):
    labels: np.ndarray                 # (n,) int32
    planes: List[Optional[Tuple[np.ndarray, float]]]


def gpf_segment(xyz: np.ndarray, cfg: SegmentationConfig) -> OracleSegmentation:
    """Full-cloud GPF segmentation (ref: src/segmentation.cpp:311-345)."""
    n = xyz.shape[0]
    labels = np.full(n, SEG_UNKNOWN, np.int32)
    planes: List[Optional[Tuple[np.ndarray, float]]] = []
    if n == 0:
        return OracleSegmentation(labels, planes)

    order = np.argsort(xyz[:, 0], kind="stable")
    per_seg = n // cfg.number_of_planar_partitions
    for s in range(cfg.number_of_planar_partitions):
        seg_idx = order[s * per_seg:(s + 1) * per_seg]
        seg_labels, plane = _fit_ground_plane(xyz[seg_idx], cfg)
        labels[seg_idx] = seg_labels
        planes.append(plane)
    # trailing order[per_seg * partitions:] stays UNKNOWN (reference quirk)
    return OracleSegmentation(labels, planes)


# ---------------------------------------------------------------------------
# Euclidean clustering (FEC)
# ---------------------------------------------------------------------------


class _Grid:
    """Uniform-grid radius search with neighbors in ascending index order."""

    def __init__(self, xyz: np.ndarray, radius: float):
        self.xyz = xyz.astype(np.float64)
        self.radius = radius
        self.r2 = radius * radius
        cells = np.floor(self.xyz / radius).astype(np.int64)
        self.cells = cells
        buckets: Dict[Tuple[int, int, int], List[int]] = collections.defaultdict(list)
        for i, c in enumerate(map(tuple, cells)):
            buckets[c].append(i)
        self.buckets = {k: np.asarray(v, np.int64) for k, v in buckets.items()}
        self._offsets = [(dx, dy, dz)
                         for dx in (-1, 0, 1) for dy in (-1, 0, 1)
                         for dz in (-1, 0, 1)]

    def query(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        cx, cy, cz = self.cells[i]
        cand: List[np.ndarray] = []
        for dx, dy, dz in self._offsets:
            b = self.buckets.get((cx + dx, cy + dy, cz + dz))
            if b is not None:
                cand.append(b)
        idx = np.concatenate(cand)
        idx.sort()
        diff = self.xyz[idx] - self.xyz[i]
        d2 = np.einsum("ij,ij->i", diff, diff)
        keep = d2 <= self.r2
        return idx[keep], d2[keep]


def fec_cluster(xyz: np.ndarray, cfg: ClusteringConfig,
                allow_native: bool = True) -> np.ndarray:
    """Serial FEC clustering (ref: src/clustering.cpp:47-125).

    Returns (n,) int32 labels: clusters 0..L-1 in BFS seed order,
    CLUSTER_INVALID for size-filtered clusters. Delegates to the native C++
    implementation when built (bit-identical; see tests/test_native.py).
    """
    if allow_native and xyz.shape[0]:
        from ..ops import hull_native
        native = hull_native.fec_cluster(
            xyz, cfg.distance_squared, cfg.cluster_quality,
            cfg.min_cluster_size, cfg.max_cluster_size)
        if native is not None:
            return native
    n = xyz.shape[0]
    labels = np.full(n, CLUSTER_UNDEFINED, np.int32)
    if n == 0:
        return labels

    grid = _Grid(xyz, math.sqrt(cfg.distance_squared))
    removed = np.zeros(n, bool)
    inner = (1.0 - cfg.cluster_quality) ** 2 * cfg.distance_squared

    label = 0
    for i in range(n):
        if removed[i]:
            continue
        queue = collections.deque([i])
        members: List[int] = []  # with duplicates, as in the reference
        while queue:
            j = queue.popleft()
            if removed[j]:
                continue
            idx, d2 = grid.query(j)
            live = ~removed[idx]
            idx, d2 = idx[live], d2[live]
            labels[idx] = label
            members.extend(idx.tolist())
            inner_mask = d2 <= inner
            removed[idx[inner_mask]] = True
            queue.extend(idx[~inner_mask].tolist())
        if len(members) < cfg.min_cluster_size or len(members) > cfg.max_cluster_size:
            labels[np.asarray(members, np.int64)] = CLUSTER_INVALID
        else:
            label += 1
    return labels


def radius_cc_cluster(xyz: np.ndarray, cfg: ClusteringConfig,
                      allow_native: bool = True) -> np.ndarray:
    """Exact connected components of the radius graph (order-independent).

    This is the device engine's clustering contract; provided here as a
    host oracle for the device implementation. Labels are compact ids
    ordered by each component's minimum point index; components whose
    *point count* is outside [min_cluster_size, max_cluster_size] are
    CLUSTER_INVALID. The component search delegates to the native C++
    radius_cc when built (checked against brute force in
    tests/test_native.py).
    """
    n = xyz.shape[0]
    labels = np.full(n, CLUSTER_UNDEFINED, np.int32)
    if n == 0:
        return labels

    roots = None
    if allow_native:
        from ..ops import hull_native
        if hull_native.native_available():
            roots = hull_native.radius_cc(
                xyz, math.sqrt(cfg.distance_squared)).astype(np.int64)
    if roots is None:
        grid = _Grid(xyz, math.sqrt(cfg.distance_squared))
        parent = np.arange(n)

        def find(a: int) -> int:
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for i in range(n):
            idx, _ = grid.query(i)
            for j in idx[idx > i]:
                ri, rj = find(i), find(int(j))
                if ri != rj:
                    if rj < ri:
                        ri, rj = rj, ri
                    parent[rj] = ri  # union by min index => root == min
        roots = np.asarray([find(i) for i in range(n)])
    uniq, counts = np.unique(roots, return_counts=True)
    valid = (counts >= cfg.min_cluster_size) & (counts <= cfg.max_cluster_size)
    # compact ids ordered by min point index (== root, ascending in uniq)
    remap = np.full(n, CLUSTER_INVALID, np.int32)
    remap[uniq[valid]] = np.arange(int(valid.sum()), dtype=np.int32)
    labels = remap[roots]
    return labels


# ---------------------------------------------------------------------------
# Hulls
# ---------------------------------------------------------------------------


def convex_hull_indices(points: np.ndarray) -> np.ndarray:
    """Andrew monotone chain, CCW, strictly convex; returns indices.

    Behavioral equivalent of the reference's Convex-Hull submodule call
    (ref: src/polygon_simplification.cpp:107-108).
    """
    m = points.shape[0]
    if m == 0:
        return np.zeros((0,), np.int64)
    if m == 1:
        return np.zeros((1,), np.int64)
    pts = points.astype(np.float64)
    order = np.lexsort((pts[:, 1], pts[:, 0]))

    def cross(o, a, b):
        return ((pts[a, 0] - pts[o, 0]) * (pts[b, 1] - pts[o, 1])
                - (pts[a, 1] - pts[o, 1]) * (pts[b, 0] - pts[o, 0]))

    lower: List[int] = []
    for p in order:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(int(p))
    upper: List[int] = []
    for p in order[::-1]:
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(int(p))
    hull = lower[:-1] + upper[:-1]
    if not hull:  # all points identical
        hull = [int(order[0])]
    return np.asarray(hull, np.int64)


def chi_concave_hull_indices(points: np.ndarray, chi: float) -> np.ndarray:
    """Chi-shape concave hull (Duckham et al. 2008): Delaunay triangulation,
    then iterative longest-boundary-edge removal subject to the regularity
    constraint, with length threshold l = l_min + chi * (l_max - l_min) over
    the triangulation's edge lengths.

    Behavioral equivalent of the reference's Concave-Hull submodule call
    (ref: src/polygon_simplification.cpp:129-130). Returns boundary vertex
    indices in order.
    """
    import heapq

    from scipy.spatial import Delaunay, QhullError  # type: ignore

    m = points.shape[0]
    if m < 3:
        return np.arange(m, dtype=np.int64)
    pts = points.astype(np.float64)
    try:
        tri = Delaunay(pts)
    except QhullError:
        return convex_hull_indices(points)

    def elen(a: int, b: int) -> float:
        return float(np.hypot(*(pts[a] - pts[b])))

    # Edge -> set of adjacent triangles
    edge_tris: Dict[Tuple[int, int], List[int]] = collections.defaultdict(list)
    for t, simplex in enumerate(tri.simplices):
        for k in range(3):
            a, b = int(simplex[k]), int(simplex[(k + 1) % 3])
            edge_tris[(min(a, b), max(a, b))].append(t)

    all_lengths = [elen(a, b) for (a, b) in edge_tris]
    l_min, l_max = min(all_lengths), max(all_lengths)
    l_thresh = l_min + chi * (l_max - l_min)

    boundary_edges = {e for e, ts in edge_tris.items() if len(ts) == 1}
    boundary_vertices = collections.Counter()
    for a, b in boundary_edges:
        boundary_vertices[a] += 1
        boundary_vertices[b] += 1
    alive_tri = np.ones(len(tri.simplices), bool)

    heap = [(-elen(a, b), (a, b)) for (a, b) in boundary_edges]
    heapq.heapify(heap)
    while heap:
        neg_l, e = heapq.heappop(heap)
        if e not in boundary_edges:
            continue
        if -neg_l <= l_thresh:
            break  # longest remaining edge within threshold: done
        ts = [t for t in edge_tris[e] if alive_tri[t]]
        if len(ts) != 1:
            continue
        t = ts[0]
        simplex = [int(v) for v in tri.simplices[t]]
        opposite = next(v for v in simplex if v not in e)
        # regularity: the exposed vertex must not already be on the boundary
        if boundary_vertices[opposite] > 0:
            continue
        a, b = e
        boundary_edges.discard(e)
        alive_tri[t] = False
        for v in (a, b):
            ne = (min(v, opposite), max(v, opposite))
            boundary_edges.add(ne)
            heapq.heappush(heap, (-elen(*ne), ne))
        boundary_vertices[opposite] += 2

    # Walk the boundary cycle in order
    adj: Dict[int, List[int]] = collections.defaultdict(list)
    for a, b in boundary_edges:
        adj[a].append(b)
        adj[b].append(a)
    start = min(adj)
    walk = [start]
    prev, cur = -1, start
    while True:
        nxts = [v for v in adj[cur] if v != prev]
        if not nxts:
            break
        nxt = nxts[0]
        if nxt == start:
            break
        walk.append(nxt)
        prev, cur = cur, nxt
        if len(walk) > 2 * len(boundary_edges):
            break  # safety: malformed boundary
    # orient CCW via the shoelace sign
    poly = pts[walk]
    area2 = float(np.sum(poly[:, 0] * np.roll(poly[:, 1], -1)
                         - np.roll(poly[:, 0], -1) * poly[:, 1]))
    if area2 < 0:
        walk = walk[::-1]
    return np.asarray(walk, np.int64)


def cluster_outlines(
    clusters: Sequence[np.ndarray], cfg: PolygonizationConfig
) -> List[np.ndarray]:
    """Per-cluster ordered 2-D outlines, matching the reference's live path
    (ref: src/polygon_simplification.cpp:82-149): clusters smaller than
    ``small_cluster_size`` get a convex hull, larger ones a chi-shape.
    Returns list of (k, 2) float32 vertex arrays; empty hulls are dropped.
    """
    outlines: List[np.ndarray] = []
    for cluster in clusters:
        xy = np.asarray(cluster)[:, :2]
        if xy.shape[0] == 0:
            continue
        if xy.shape[0] < cfg.small_cluster_size:
            idx = convex_hull_indices(xy)
        else:
            idx = chi_concave_hull_indices(xy, cfg.chi)
        if idx.size:
            outlines.append(xy[idx].astype(np.float32))
    return outlines


# ---------------------------------------------------------------------------
# End-to-end oracle pipeline
# ---------------------------------------------------------------------------


class OracleResult(NamedTuple):
    seg_labels: np.ndarray             # (n,) int32
    obstacle_indices: np.ndarray       # (n_obs,) indices into the frame
    cluster_labels: np.ndarray         # (n_obs,) int32, aligned to obstacle_indices
    clusters: List[np.ndarray]         # valid clusters' xyz, label order
    outlines: List[np.ndarray]         # ordered 2-D outlines


def run_pipeline(
    xyz: np.ndarray,
    config: EngineConfig,
    clustering_mode: str = "fec",
) -> OracleResult:
    """Segment -> cluster -> polygonize, mirroring Processor::process
    (ref: src/processor.cpp:135-219).

    The obstacle subset keeps original frame order (divergence from the
    reference's x-sorted obstacle cloud order; affects label numbering only —
    see module docstring).
    """
    seg = gpf_segment(xyz, config.segmentation)
    obstacle_indices = np.flatnonzero(seg.labels == SEG_OBSTACLE)
    obs_xyz = xyz[obstacle_indices]
    if clustering_mode == "fec":
        cl = fec_cluster(obs_xyz, config.clustering)
    elif clustering_mode == "cc":
        cl = radius_cc_cluster(obs_xyz, config.clustering)
    else:
        raise ValueError(f"unknown clustering_mode {clustering_mode!r}")

    # Scatter into per-label clusters, drop INVALID (ref: src/processor.cpp:180-200)
    clusters: List[np.ndarray] = []
    if cl.size:
        max_label = int(cl.max())
        for lbl in range(max_label + 1):
            sel = obs_xyz[cl == lbl]
            if sel.shape[0]:
                clusters.append(sel)
    outlines = cluster_outlines(clusters, config.polygonization)
    return OracleResult(seg.labels, obstacle_indices, cl, clusters, outlines)
