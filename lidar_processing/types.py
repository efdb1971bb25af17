"""Core array types for the LiDAR engine.

The reference passes `pcl::PointCloud<T>` objects of dynamic size between
stages (ref: src/processor.cpp:123-126). On device everything under `jit` must
have static shapes, so the fundamental type is a fixed-capacity padded point
buffer plus a validity mask. Labels use the same integer conventions as the
reference so outputs diff directly:

  segmentation: UNKNOWN=0, GROUND=1, OBSTACLE=2 (ref: src/segmentation.hpp:41-46)
  clustering:   UNDEFINED=INT32_MIN, INVALID=-1, clusters 0..L-1
                (ref: src/clustering.hpp:53-54)
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

# --- label conventions (match the reference bit-for-bit) -------------------
SEG_UNKNOWN = np.int32(0)
SEG_GROUND = np.int32(1)
SEG_OBSTACLE = np.int32(2)

CLUSTER_UNDEFINED = np.int32(np.iinfo(np.int32).min)
CLUSTER_INVALID = np.int32(-1)


class PointCloud(NamedTuple):
    """A fixed-capacity, padded point cloud.

    xyz:       (N, 3) float32 — padded entries hold zeros.
    intensity: (N,)   float32
    mask:      (N,)   bool    — True for real points.

    ``N`` is a static capacity (PipelineConfig.max_points); the number of real
    points is ``mask.sum()``. This replaces the reference's dynamically-sized
    PCL clouds with reserve()d capacity (ref: src/processor.cpp:88-90).
    """

    xyz: jnp.ndarray
    intensity: jnp.ndarray
    mask: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)


def pad_cloud(xyz: np.ndarray, intensity: np.ndarray | None, capacity: int) -> PointCloud:
    """Pad a host-side (n, 3) cloud into a fixed-capacity PointCloud."""
    n = xyz.shape[0]
    if n > capacity:
        raise ValueError(f"cloud has {n} points, exceeds capacity {capacity}")
    out_xyz = np.zeros((capacity, 3), dtype=np.float32)
    out_xyz[:n] = xyz.astype(np.float32)
    out_int = np.zeros((capacity,), dtype=np.float32)
    if intensity is not None:
        out_int[:n] = intensity.astype(np.float32)
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return PointCloud(jnp.asarray(out_xyz), jnp.asarray(out_int), jnp.asarray(mask))


class Plane(NamedTuple):
    """Plane a*x + b*y + c*z = d (ref: src/segmentation.hpp:90-102)."""

    normal: jnp.ndarray  # (..., 3)
    d: jnp.ndarray       # (...,)


class SegmentationResult(NamedTuple):
    """Per-point segmentation labels plus fitted planes per partition."""

    labels: jnp.ndarray        # (N,) int32 in {UNKNOWN, GROUND, OBSTACLE}
    planes: Plane              # (P, 3) normals, (P,) offsets
    plane_valid: jnp.ndarray   # (P,) bool — False => all-obstacle fallback fired


class ClusteringResult(NamedTuple):
    """Per-point cluster labels.

    labels: (N,) int32 — CLUSTER_INVALID for too-small/too-large clusters,
            CLUSTER_UNDEFINED for padded entries, else compact ids 0..L-1
            ordered by each cluster's minimum point index (the reference's BFS
            seed order, ref: src/clustering.cpp:70-124).
    num_clusters: () int32
    overflow: () int32 — static-capacity violations (cells, candidate
            pairs, tier slots, ...). Nonzero means the neighbor graph may
            be missing edges and the relevant cap must be raised. The
            default "stixel" backend measures 0 across all 154 bundled
            frames (tools/golden_run.py); the cross-validation "cellgraph"
            backend needs larger caps than the defaults on dense frames
            (up to 1726 on this dataset) and is exact only when its
            reported overflow is 0.
    """

    labels: jnp.ndarray
    num_clusters: jnp.ndarray
    overflow: jnp.ndarray


class PolygonBatch(NamedTuple):
    """Padded batch of 2-D polygons (cluster outlines).

    vertices: (C, V, 2) float32 — ordered CCW, closed implicitly.
    counts:   (C,)      int32   — vertices used per polygon; 0 => empty slot.
    """

    vertices: jnp.ndarray
    counts: jnp.ndarray
