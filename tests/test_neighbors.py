"""KDTree-parity tests: ops/neighbors.py vs brute force.

Mirrors the reference's only test file (ref: test/test_kdtree.cpp:31-187):
k-NN and radius search over random clouds validated against a brute-force
oracle — same scene parameters (1000 points, 50 queries, k=5, radius 2.0),
seeded instead of the reference's nondeterministic std::random_device.
"""

import numpy as np
import pytest

from lidar_processing.ops.neighbors import (NeighborIndex, k_nearest,
                                                radius_search)


def brute_knn(points, queries, k):
    """float64 oracle: ascending d², ties by lower index."""
    d2 = ((queries[:, None, :].astype(np.float64)
           - points[None, :, :].astype(np.float64)) ** 2).sum(-1)
    order = np.lexsort((np.arange(points.shape[0])[None, :].repeat(
        queries.shape[0], 0), d2), axis=1)
    idx = order[:, :k]
    return idx, np.take_along_axis(d2, idx, axis=1)


class TestKNearest:
    def test_matches_brute_force(self, rng):
        # ref: test_kdtree.cpp:31-95 (1000 pts in [-10,10]^3, 50 queries, k=5)
        pts = rng.uniform(-10, 10, (1000, 3)).astype(np.float32)
        q = rng.uniform(-10, 10, (50, 3)).astype(np.float32)
        res = k_nearest(pts, q, k=5)
        ref_i, ref_d = brute_knn(pts, q, 5)
        np.testing.assert_array_equal(np.asarray(res.indices), ref_i)
        np.testing.assert_allclose(np.asarray(res.distances), ref_d,
                                   rtol=1e-6)
        # ascending per query (ref asserts sorted order, :80-93)
        d = np.asarray(res.distances)
        assert np.all(np.diff(d, axis=1) >= 0)

    def test_ties_broken_by_lower_index(self):
        # 4 points exactly equidistant from the origin query
        pts = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0], [0, -1, 0],
                        [5, 5, 5]], np.float32)
        res = k_nearest(pts, np.zeros((1, 3), np.float32), k=4)
        np.testing.assert_array_equal(np.asarray(res.indices)[0],
                                      [0, 1, 2, 3])

    def test_mask_excludes_padding(self, rng):
        pts = rng.uniform(-10, 10, (64, 3)).astype(np.float32)
        mask = np.zeros(64, bool)
        mask[:10] = True
        q = pts[:1]
        res = k_nearest(pts, q, k=12, mask=mask)
        idx = np.asarray(res.indices)[0]
        assert set(idx[idx >= 0]) <= set(range(10))
        assert np.all(idx[10:] == -1)      # only 10 valid points exist
        assert np.all(~np.isfinite(np.asarray(res.distances)[0, 10:]))

    def test_tiling_is_invisible(self, rng):
        pts = rng.uniform(-10, 10, (1000, 3)).astype(np.float32)
        q = rng.uniform(-10, 10, (7, 3)).astype(np.float32)
        a = k_nearest(pts, q, k=5, tile=128)
        b = k_nearest(pts, q, k=5, tile=1000)
        np.testing.assert_array_equal(np.asarray(a.indices),
                                      np.asarray(b.indices))
        np.testing.assert_array_equal(np.asarray(a.distances),
                                      np.asarray(b.distances))


class TestRadiusSearch:
    def test_matches_brute_force(self, rng):
        # ref: test_kdtree.cpp:97-187 (radius 2.0 in [-15,15]^3)
        pts = rng.uniform(-15, 15, (1000, 3)).astype(np.float32)
        q = rng.uniform(-15, 15, (50, 3)).astype(np.float32)
        r2 = 4.0
        res = radius_search(pts, q, r2, capacity=64)
        d2 = ((q[:, None, :].astype(np.float64)
               - pts[None, :, :].astype(np.float64)) ** 2).sum(-1)
        assert int(res.overflow) == 0
        for i in range(q.shape[0]):
            ref = np.flatnonzero(d2[i] <= r2)
            got = np.asarray(res.indices)[i]
            got = got[got >= 0]
            # identical result SET (ref asserts size + per-point equality)
            assert set(got) == set(ref), i
            assert int(res.counts[i]) == ref.size
            # ascending by d² (the reference's sort_results contract)
            dd = np.asarray(res.distances)[i][: ref.size]
            assert np.all(np.diff(dd) >= 0)

    def test_unsorted_returns_index_order(self, rng):
        pts = rng.uniform(-2, 2, (100, 3)).astype(np.float32)
        q = np.zeros((1, 3), np.float32)
        res = radius_search(pts, q, 1.0, capacity=100, sort_results=False)
        idx = np.asarray(res.indices)[0]
        idx = idx[idx >= 0]
        assert np.all(np.diff(idx) > 0)    # strictly increasing point index

    def test_capacity_overflow_reported(self, rng):
        pts = rng.normal(0, 0.01, (50, 3)).astype(np.float32)
        q = np.zeros((1, 3), np.float32)
        res = radius_search(pts, q, 1.0, capacity=8)
        assert int(res.counts[0]) == 50
        assert int(res.overflow) == 42
        # the 8 returned are the NEAREST 8 (ascending merge keeps smallest)
        d2 = (pts.astype(np.float64) ** 2).sum(1)
        nearest8 = set(np.argsort(d2, kind="stable")[:8])
        got = set(np.asarray(res.indices)[0].tolist())
        assert got == nearest8


class TestNeighborIndexAPI:
    def test_rebuild_and_query(self, rng):
        # object API mirrors the reference KDTree (ref: src/kdtree.hpp:41-136)
        idx = NeighborIndex()
        with pytest.raises(ValueError):
            idx.k_nearest(np.zeros(3, np.float32), 1)
        pts = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
        idx.rebuild(pts)
        res = idx.k_nearest(pts[0], k=1)
        assert int(res.indices[0, 0]) == 0
        assert float(res.distances[0, 0]) == 0.0
        rr = idx.radius_search(pts[0], 0.01, capacity=16)
        assert int(rr.counts[0]) >= 1
