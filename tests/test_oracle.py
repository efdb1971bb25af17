"""Self-consistency tests for the host oracle (oracle/reference.py).

These pin down the oracle's behavior with brute-force checks and synthetic
configurations exercising the reference's documented quirks (SURVEY.md §3.3).
"""

import numpy as np
import pytest

from lidar_processing.config import (ClusteringConfig, DEFAULT_CONFIG,
                                         SegmentationConfig)
from lidar_processing.oracle import reference as ref
from lidar_processing.oracle.diff import cluster_f1, ground_mask_iou
from lidar_processing.types import (CLUSTER_INVALID, SEG_GROUND,
                                        SEG_OBSTACLE, SEG_UNKNOWN)


class TestGPF:
    def test_flat_plane_with_boxes(self, rng):
        """Ground points on z=0 plane + obstacle boxes above are separated."""
        n_ground, n_obs = 5000, 500
        ground = np.stack([
            rng.uniform(-20, 20, n_ground), rng.uniform(-20, 20, n_ground),
            rng.normal(0, 0.02, n_ground)], axis=1).astype(np.float32)
        obs = np.stack([
            rng.uniform(-20, 20, n_obs), rng.uniform(-20, 20, n_obs),
            rng.uniform(0.8, 2.0, n_obs)], axis=1).astype(np.float32)
        xyz = np.concatenate([ground, obs])
        seg = ref.gpf_segment(xyz, DEFAULT_CONFIG.segmentation)
        assert np.all(seg.labels[:n_ground] == SEG_GROUND)
        assert np.all(seg.labels[n_ground:] == SEG_OBSTACLE)

    def test_odd_point_dropped(self, rng):
        """Integer-division split leaves the max-x point UNKNOWN when n is odd
        (ref: src/segmentation.cpp:124-148)."""
        n = 1001
        xyz = np.stack([rng.uniform(-10, 10, n), rng.uniform(-10, 10, n),
                        rng.normal(0, 0.02, n)], axis=1).astype(np.float32)
        seg = ref.gpf_segment(xyz, DEFAULT_CONFIG.segmentation)
        dropped = np.argmax(xyz[:, 0])
        assert seg.labels[dropped] == SEG_UNKNOWN
        assert int((seg.labels == SEG_UNKNOWN).sum()) == 1

    def test_empty_seed_quirk_all_obstacle(self):
        """If no point exceeds the seed z-threshold, the cutoff scan yields an
        EMPTY seed set and the all-obstacle fallback fires
        (ref: src/segmentation.cpp:202-210, :249-259)."""
        # All points at the same z => z_mean = z, threshold = z + 0.6 > z for
        # all => no point strictly above => empty seeds => all obstacle.
        n = 100
        xyz = np.zeros((n, 3), np.float32)
        xyz[:, 0] = np.linspace(-5, 5, n)
        xyz[:, 2] = 1.0
        seg = ref.gpf_segment(xyz, DEFAULT_CONFIG.segmentation)
        assert np.all(seg.labels == SEG_OBSTACLE)

    def test_signed_distance_below_plane_is_ground(self, rng):
        """Points far BELOW the plane are ground due to the signed comparison
        (ref: src/segmentation.cpp:299)."""
        n = 4000
        ground = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                           rng.normal(0, 0.02, n)], axis=1).astype(np.float32)
        # tall points are required so the seed-cutoff scan finds a point above
        # mean+0.6 (otherwise the empty-seed quirk fires, see
        # test_empty_seed_quirk_all_obstacle)
        tall = np.stack([rng.uniform(-20, 20, 50), rng.uniform(-20, 20, 50),
                         rng.uniform(1.0, 2.0, 50)], axis=1).astype(np.float32)
        deep = np.array([[0.0, 0.0, -2.0], [1.0, 1.0, -5.0]], np.float32)
        xyz = np.concatenate([ground, tall, deep])
        cfg = SegmentationConfig(number_of_planar_partitions=1)
        seg = ref.gpf_segment(xyz, cfg)
        assert np.all(seg.labels[-2:] == SEG_GROUND)

    def test_tiny_segment_unknown(self):
        """Segments with <3 points stay UNKNOWN (ref: src/segmentation.cpp:224-229)."""
        xyz = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0]], np.float32)
        cfg = SegmentationConfig(number_of_planar_partitions=2)
        seg = ref.gpf_segment(xyz, cfg)
        assert seg.labels.shape == (4,)
        # 2 points per partition => both partitions < 3 points => all UNKNOWN
        assert np.all(seg.labels == SEG_UNKNOWN)


class TestClustering:
    def _brute_cc(self, xyz, r2, min_size):
        """Brute-force O(n^2) connected components oracle."""
        n = len(xyz)
        d2 = ((xyz[:, None, :] - xyz[None, :, :]) ** 2).sum(-1)
        adj = d2 <= r2
        labels = np.full(n, -2, np.int64)
        comp = 0
        for i in range(n):
            if labels[i] != -2:
                continue
            stack = [i]
            labels[i] = comp
            while stack:
                j = stack.pop()
                for k in np.nonzero(adj[j])[0]:
                    if labels[k] == -2:
                        labels[k] = comp
                        stack.append(int(k))
            comp += 1
        out = np.full(n, CLUSTER_INVALID, np.int32)
        next_id = 0
        for c in range(comp):
            m = labels == c
            if m.sum() >= min_size:
                out[m] = next_id
                next_id += 1
        return out

    def test_cc_matches_bruteforce(self, rng):
        xyz = rng.uniform(-3, 3, size=(400, 3)).astype(np.float32)
        cfg = DEFAULT_CONFIG.clustering
        got = ref.radius_cc_cluster(xyz, cfg)
        want = self._brute_cc(xyz.astype(np.float64), cfg.distance_squared,
                              cfg.min_cluster_size)
        # identical partitions and identical compact numbering (min-index order)
        np.testing.assert_array_equal(got, want)

    def test_fec_quality_one_equals_cc_membership(self, rng):
        """FEC with cluster_quality=1.0 has radius-CC connectivity; only the
        size filter differs (the reference counts duplicate discoveries,
        ref: src/clustering.cpp:99-100). With min_cluster_size=1 both match."""
        xyz = rng.uniform(-3, 3, size=(300, 3)).astype(np.float32)
        cfg = ClusteringConfig(cluster_quality=1.0, min_cluster_size=1)
        fec = ref.fec_cluster(xyz, cfg)
        cc = ref.radius_cc_cluster(xyz, cfg)
        f1, _ = cluster_f1(cc, fec)
        assert f1 == 1.0

    def test_fec_two_separate_blobs(self, rng):
        a = rng.normal(0, 0.05, size=(50, 3)).astype(np.float32)
        b = rng.normal(0, 0.05, size=(50, 3)).astype(np.float32) + 10.0
        xyz = np.concatenate([a, b])
        labels = ref.fec_cluster(xyz, DEFAULT_CONFIG.clustering)
        assert len(set(labels[:50].tolist())) == 1
        assert len(set(labels[50:].tolist())) == 1
        assert labels[0] != labels[50]

    def test_small_cluster_invalid(self):
        xyz = np.array([[0, 0, 0], [0.1, 0, 0], [100, 0, 0]], np.float32)
        labels = ref.fec_cluster(xyz, DEFAULT_CONFIG.clustering)
        assert np.all(labels == CLUSTER_INVALID)


class TestHulls:
    def test_convex_square(self):
        pts = np.array([[0, 0], [1, 0], [1, 1], [0, 1], [0.5, 0.5]], np.float32)
        idx = ref.convex_hull_indices(pts)
        assert set(idx.tolist()) == {0, 1, 2, 3}
        # CCW orientation: positive shoelace area
        poly = pts[idx]
        area2 = np.sum(poly[:, 0] * np.roll(poly[:, 1], -1)
                       - np.roll(poly[:, 0], -1) * poly[:, 1])
        assert area2 > 0

    def test_convex_brute_force(self, rng):
        pts = rng.uniform(-1, 1, size=(200, 2))
        idx = ref.convex_hull_indices(pts)
        hull = pts[idx]
        # every input point is inside or on the hull (cross-product test)
        for k in range(len(hull)):
            a, b = hull[k], hull[(k + 1) % len(hull)]
            cross = ((b[0] - a[0]) * (pts[:, 1] - a[1])
                     - (b[1] - a[1]) * (pts[:, 0] - a[0]))
            assert np.all(cross >= -1e-9)

    def test_concave_c_shape(self, rng):
        """A C-shaped cluster: the chi-hull must be non-convex (smaller area)."""
        theta = rng.uniform(0.3 * np.pi, 1.7 * np.pi, size=400)
        r = rng.uniform(4.0, 5.0, size=400)
        pts = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
        chull = pts[ref.convex_hull_indices(pts)]
        cidx = ref.chi_concave_hull_indices(pts, chi=0.1)
        khull = pts[cidx]

        def area(p):
            return 0.5 * abs(np.sum(p[:, 0] * np.roll(p[:, 1], -1)
                                    - np.roll(p[:, 0], -1) * p[:, 1]))

        assert area(khull) < 0.8 * area(chull)
        # simple polygon: no repeated vertices
        assert len(set(map(tuple, khull))) == len(khull)

    def test_chi_one_is_convex(self, rng):
        """chi=1 => threshold = l_max => nothing removable => convex hull."""
        pts = rng.uniform(-1, 1, size=(100, 2))
        cidx = ref.chi_concave_hull_indices(pts, chi=1.0)
        vidx = ref.convex_hull_indices(pts)
        assert set(cidx.tolist()) == set(vidx.tolist())


class TestEndToEnd:
    def test_frame0_pipeline(self, frame0):
        res = ref.run_pipeline(frame0, DEFAULT_CONFIG)
        n = frame0.shape[0]
        assert res.seg_labels.shape == (n,)
        counts = {
            "ground": int((res.seg_labels == SEG_GROUND).sum()),
            "obstacle": int((res.seg_labels == SEG_OBSTACLE).sum()),
        }
        # sanity: most points are labeled, ground dominates a street scene
        assert counts["ground"] + counts["obstacle"] >= n - 1
        assert counts["ground"] > counts["obstacle"] > 10000
        assert len(res.clusters) > 100
        assert len(res.outlines) == len(res.clusters)
        for hull in res.outlines:
            assert hull.ndim == 2 and hull.shape[1] == 2 and hull.shape[0] >= 1


def test_radius_cc_native_matches_python_oracle(rng):
    """The oracle's native component search gives the labels of its own
    pure-Python union-find (ids, numbering and size filter)."""
    from lidar_processing.config import ClusteringConfig
    from lidar_processing.ops import hull_native
    if not hull_native.native_available():
        pytest.skip("native module unavailable (no C++ compiler)")
    cfg = ClusteringConfig()
    centers = rng.uniform(-10, 10, (30, 3))
    pts = (rng.normal(0, 0.3, (30, 40, 3)) + centers[:, None, :]
           ).reshape(-1, 3).astype(np.float32)
    nat = ref.radius_cc_cluster(pts, cfg)
    py = ref.radius_cc_cluster(pts, cfg, allow_native=False)
    np.testing.assert_array_equal(nat, py)
