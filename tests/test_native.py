"""Native C++ module tests: hulls and graph kernels vs oracles/brute force."""

import numpy as np
import pytest

from lidar_processing.ops import hull_native as hn
from lidar_processing.oracle import reference as orc
from lidar_processing.oracle.diff import polygon_chamfer

needs_native = pytest.mark.skipif(
    not hn.native_available(), reason="native module not built")


@needs_native
class TestNativeConvex:
    def test_matches_oracle_random(self, rng):
        for _ in range(20):
            pts = rng.normal(0, 2, (rng.integers(3, 200), 2)).astype(
                np.float32)
            nat = hn.convex_hull_indices(pts)
            ref = orc.convex_hull_indices(pts)
            assert set(nat.tolist()) == set(ref.tolist())
            # CCW order
            x, y = pts[nat, 0], pts[nat, 1]
            area2 = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
            assert area2 > 0

    def test_collinear(self):
        pts = np.array([[0, 0], [1, 1], [2, 2], [3, 3]], np.float32)
        nat = hn.convex_hull_indices(pts)
        assert set(nat.tolist()) == {0, 3}

    def test_chan_matches_monotone_random(self, rng):
        """Chan's grouped march must build the same strictly-convex CCW
        hull as monotone chain (ref picks Chan for >1000-point clusters,
        polygon_simplification.cpp:53-63)."""
        for n in (3, 17, 300, 1500, 5000):
            pts = rng.normal(0, 5, (n, 2)).astype(np.float32)
            chan = hn.convex_hull_indices(pts, algorithm="chan")
            mono = hn.convex_hull_indices(pts, algorithm="monotone")
            assert set(chan.tolist()) == set(mono.tolist()), n
            x, y = pts[chan, 0], pts[chan, 1]
            area2 = np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y)
            assert area2 > 0

    def test_chan_adversarial(self, rng):
        # grid (massive collinearity), duplicates, circle (all on hull),
        # tiny inputs
        g = np.stack(np.meshgrid(np.arange(40), np.arange(40)),
                     -1).reshape(-1, 2).astype(np.float32)
        dup = np.repeat(rng.normal(0, 1, (50, 2)), 30, axis=0).astype(
            np.float32)
        th = rng.uniform(0, 2 * np.pi, 2000)
        circ = np.stack([np.cos(th), np.sin(th)], 1).astype(np.float32)
        for pts in (g, dup, circ,
                    np.zeros((1, 2), np.float32),
                    np.array([[0, 0], [1, 0]], np.float32)):
            perm = rng.permutation(len(pts))
            pts = pts[perm]
            chan = hn.convex_hull_indices(pts, algorithm="chan")
            mono = hn.convex_hull_indices(pts, algorithm="monotone")
            assert (set(map(tuple, pts[chan].tolist()))
                    == set(map(tuple, pts[mono].tolist())))


@needs_native
class TestNativeChi:
    def test_matches_scipy_oracle(self, rng):
        worst = 0.0
        for _ in range(15):
            m = int(rng.integers(25, 400))
            pts = rng.normal(0, 2, (m, 2)).astype(np.float32)
            nat = hn.chi_concave_hull(pts, 0.2)
            idx = orc.chi_concave_hull_indices(pts, 0.2)
            ref = pts[idx]
            worst = max(worst, polygon_chamfer(nat, ref))
        assert worst < 0.05, worst

    def test_chi_one_is_convex(self, rng):
        pts = rng.normal(0, 2, (100, 2)).astype(np.float32)
        nat = hn.chi_concave_hull(pts, 1.0)
        ref = pts[orc.convex_hull_indices(pts)]
        assert polygon_chamfer(nat, ref) < 1e-5

    def test_degenerate_falls_back(self):
        pts = np.array([[0, 0], [1, 0], [2, 0], [3, 0]], np.float32)
        out = hn.chi_concave_hull(pts, 0.2)  # collinear: convex fallback
        assert out.shape[0] >= 2


@needs_native
class TestNativeGraph:
    def test_union_find(self, rng):
        n = 500
        u = rng.integers(0, n, 800).astype(np.int32)
        v = rng.integers(0, n, 800).astype(np.int32)
        lbl = hn.union_find_cc(u, v, n)
        # brute force via repeated min propagation
        ref = np.arange(n)
        for _ in range(n):
            changed = False
            for a, b in zip(u, v):
                m = min(ref[a], ref[b])
                if ref[a] != m or ref[b] != m:
                    ref[a] = ref[b] = m
                    changed = True
            if not changed:
                break
        # canonicalize ref fully
        for i in range(n):
            while ref[i] != ref[ref[i]]:
                ref[i] = ref[ref[i]]
        assert np.array_equal(lbl, ref)

    def test_fec_matches_python_oracle(self, rng):
        from lidar_processing.config import ClusteringConfig
        cfg = ClusteringConfig()
        pts = rng.normal(0, 1.0, (3000, 3)).astype(np.float32)
        nat = hn.fec_cluster(pts, cfg.distance_squared, cfg.cluster_quality,
                             cfg.min_cluster_size, cfg.max_cluster_size)
        py = orc.fec_cluster(pts, cfg, allow_native=False)
        assert np.array_equal(nat, py)

    def test_radius_cc_vs_bruteforce(self, rng):
        n = 400
        pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        r = 0.8
        lbl = hn.radius_cc(pts, r)
        d2 = np.sum((pts[:, None] - pts[None, :]) ** 2, -1)
        adj = d2 <= r * r
        ref = np.arange(n)
        for _ in range(n):
            new = np.min(np.where(adj, ref[None, :], n), axis=1)
            new = np.minimum(ref, new)
            new = new[new]
            if np.array_equal(new, ref):
                break
            ref = new
        assert np.array_equal(lbl, ref)
