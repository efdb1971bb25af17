"""Batched neighbor search: the device equivalent of the reference KDTree.

The reference exposes a 3-D KD-tree as a first-class library component with
`rebuild`, `k_nearest`, and `radius_search` (ref: src/kdtree.hpp:41-136,
:174-225 build, :227-290 k-NN, :292-341 radius search) and validates it
against a brute-force oracle (ref: test/test_kdtree.cpp:31-187).

A KD-tree is a pointer-chasing structure built to make *serial* CPU queries
cheap; on an accelerator the same contract is served by dense, batched
distance blocks: queries are answered in bulk, each tile of the point set
is scored against every query at once, and a running top-k merge keeps
per-query results bounded. No tree, no recursion, no data-dependent
control flow — the "index" is just the (padded) point buffer itself, so
`rebuild` is O(1) and queries are one fused scan over the points.

Semantics match the reference exactly:
  * `k_nearest` returns the k smallest-d² points, sorted ascending by d²,
    ties broken by lower point index (ref: kdtree.hpp:227-290 — the bounded
    max-heap yields the same set; the test asserts sorted order,
    ref: test/test_kdtree.cpp:80-93).
  * `radius_search` returns all points with d² <= radius², optionally
    sorted ascending (ref: kdtree.hpp:292-341, `sort_results`), up to a
    static capacity; the true count is always returned so callers can
    detect capacity overflow.

Masked (padding) points never appear in results.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

# true +inf: invalid/absent results are documented as +inf, and the
# `isfinite` guard below relies on it (a large-but-finite fill would make
# that guard a silent no-op)
_F_INF = jnp.float32(jnp.inf)


class KNNResult(NamedTuple):
    """k nearest neighbors per query, ascending by squared distance."""

    indices: jnp.ndarray    # (Q, k) int32; -1 where fewer than k valid points
    distances: jnp.ndarray  # (Q, k) f32 squared distances; +inf where invalid


class RadiusResult(NamedTuple):
    """All neighbors with d² <= r² per query, up to a static capacity."""

    indices: jnp.ndarray    # (Q, cap) int32; -1 past each query's count
    distances: jnp.ndarray  # (Q, cap) f32 squared distances; +inf past count
    counts: jnp.ndarray     # (Q,) int32 TRUE neighbor counts (may exceed cap)
    overflow: jnp.ndarray   # () int32: total results dropped to capacity


def _pairwise_d2(queries: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """(Q, P) exact squared distances, computed by direct difference.

    The direct (q - p)² form is used rather than the matmul expansion
    ‖q‖² + ‖p‖² − 2q·p because the queries here are low-dimensional (3-D)
    and the contract is exact-match against a brute-force oracle
    (ref: test/test_kdtree.cpp:88-93); the cancellation error of the
    expanded form would break distance ties differently.
    """
    d = queries[:, None, :] - points[None, :, :]
    return jnp.sum(d * d, axis=-1)


@functools.partial(jax.jit, static_argnames=("k", "tile"))
def k_nearest(points: jnp.ndarray, queries: jnp.ndarray, k: int,
              mask: Optional[jnp.ndarray] = None,
              tile: int = 8192) -> KNNResult:
    """Batched exact k-NN over a (possibly padded) point set.

    points: (P, 3) f32; queries: (Q, 3) f32; mask: (P,) bool validity
    (None = all valid). Tiles of `tile` points are scored per pass and
    merged into a running per-query top-k, so peak memory is
    O(Q * (tile + 2k)) regardless of P.
    """
    p_n = points.shape[0]
    q_n = queries.shape[0]
    valid = jnp.ones((p_n,), bool) if mask is None else mask

    best_d = jnp.full((q_n, k), _F_INF, jnp.float32)
    best_i = jnp.full((q_n, k), -1, jnp.int32)

    tile = min(tile, p_n)
    for start in range(0, p_n, tile):
        stop = min(start + tile, p_n)
        pts = points[start:stop]
        ok = valid[start:stop]
        d2 = _pairwise_d2(queries, pts)                    # (Q, T)
        d2 = jnp.where(ok[None, :], d2, _F_INF)
        idx = jnp.arange(start, stop, dtype=jnp.int32)
        cat_d = jnp.concatenate([best_d, d2], axis=1)
        cat_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(idx[None, :], d2.shape)], axis=1)
        # ascending-d² top-k with ties broken by LOWEST point index: sort by
        # (d², index) — a single two-key lexicographic sort per merge.
        order = jnp.argsort(cat_d, axis=1, stable=True)
        best_d = jnp.take_along_axis(cat_d, order[:, :k], axis=1)
        best_i = jnp.take_along_axis(cat_i, order[:, :k], axis=1)

    best_i = jnp.where(jnp.isfinite(best_d), best_i, -1)
    return KNNResult(best_i, best_d)


@functools.partial(jax.jit, static_argnames=("capacity", "tile", "sort_results"))
def radius_search(points: jnp.ndarray, queries: jnp.ndarray,
                  radius_squared: float, capacity: int,
                  mask: Optional[jnp.ndarray] = None,
                  sort_results: bool = True,
                  tile: int = 8192) -> RadiusResult:
    """Batched exact fixed-radius search over a (possibly padded) point set.

    Returns up to `capacity` hits per query (the reference's dynamically
    sized result vector becomes a static buffer + true-count + overflow,
    ref: src/kdtree.hpp:292-341). With sort_results=True hits are ascending
    by d² (ties by index), matching the reference's `sort_results` flag;
    otherwise they arrive in point-index order.
    """
    knn = k_nearest(points, queries, capacity, mask=mask, tile=tile)
    in_r = knn.distances <= jnp.float32(radius_squared)
    # the k-NN merge is ascending-d²; index order == stable sort by index
    if not sort_results:
        order = jnp.argsort(
            jnp.where(in_r, knn.indices, jnp.int32(2**31 - 1)),
            axis=1, stable=True)
        knn = KNNResult(
            jnp.take_along_axis(knn.indices, order, axis=1),
            jnp.take_along_axis(knn.distances, order, axis=1))
        in_r = knn.distances <= jnp.float32(radius_squared)

    indices = jnp.where(in_r, knn.indices, -1)
    distances = jnp.where(in_r, knn.distances, _F_INF)

    # true counts via a full masked reduction (cheap: one more pass)
    p_n = points.shape[0]
    valid = jnp.ones((p_n,), bool) if mask is None else mask
    counts = jnp.zeros((queries.shape[0],), jnp.int32)
    t = min(tile, p_n)
    for start in range(0, p_n, t):
        stop = min(start + t, p_n)
        d2 = _pairwise_d2(queries, points[start:stop])
        hit = (d2 <= jnp.float32(radius_squared)) & valid[None, start:stop]
        counts = counts + jnp.sum(hit.astype(jnp.int32), axis=1)
    overflow = jnp.sum(jnp.maximum(counts - capacity, 0))
    return RadiusResult(indices, distances, counts, overflow)


class NeighborIndex:
    """Object-style wrapper mirroring the reference KDTree API.

    `rebuild` just retains the (padded) point buffer — the device "index" is
    the dense array itself (ref: src/kdtree.hpp:174-225 builds a tree here;
    see module docstring for why none is needed).
    """

    def __init__(self, points: Optional[jnp.ndarray] = None,
                 mask: Optional[jnp.ndarray] = None):
        self._points = None
        self._mask = None
        if points is not None:
            self.rebuild(points, mask)

    def rebuild(self, points: jnp.ndarray,
                mask: Optional[jnp.ndarray] = None) -> None:
        self._points = jnp.asarray(points, jnp.float32)
        self._mask = None if mask is None else jnp.asarray(mask, bool)

    def k_nearest(self, queries: jnp.ndarray, k: int) -> KNNResult:
        if self._points is None:
            raise ValueError("rebuild() must be called before queries")
        return k_nearest(self._points, jnp.atleast_2d(queries), k,
                         mask=self._mask)

    def radius_search(self, queries: jnp.ndarray, radius_squared: float,
                      capacity: int = 256,
                      sort_results: bool = True) -> RadiusResult:
        if self._points is None:
            raise ValueError("rebuild() must be called before queries")
        return radius_search(self._points, jnp.atleast_2d(queries),
                             radius_squared, capacity, mask=self._mask,
                             sort_results=sort_results)
