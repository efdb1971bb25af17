"""Polygon vertex-cap simplification tests.

The reference's planned ``max_polygon_points{300U}`` cap
(ref: src/polygonization.hpp:56) is live here as Visvalingam-Whyatt
decimation applied to every emitted outline (ops/simplify.py, wired in
runtime/pipeline.py host_outputs).
"""

import dataclasses

import numpy as np
import pytest

from lidar_processing.config import DEFAULT_CONFIG
from lidar_processing.ops.simplify import simplify_ring


def _ring_area(v: np.ndarray) -> float:
    x, y = v[:, 0], v[:, 1]
    return 0.5 * abs(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


class TestSimplifyRing:
    def test_under_cap_unchanged(self):
        v = np.random.default_rng(0).normal(size=(10, 2))
        out = simplify_ring(v, 300)
        np.testing.assert_array_equal(out, v)

    def test_cap_respected_and_order_preserved(self):
        t = np.linspace(0, 2 * np.pi, 1000, endpoint=False)
        circle = np.stack([np.cos(t), np.sin(t)], axis=1)
        out = simplify_ring(circle, 300)
        assert 3 <= len(out) <= 300
        # surviving vertices are a subsequence of the original ring
        idx = [np.flatnonzero((circle == p).all(axis=1))[0] for p in out]
        assert (np.diff(idx) > 0).all()

    def test_shape_preserved(self):
        # unit circle: decimation to 64 vertices keeps >99% of the area
        t = np.linspace(0, 2 * np.pi, 2000, endpoint=False)
        circle = np.stack([np.cos(t), np.sin(t)], axis=1)
        out = simplify_ring(circle, 64)
        assert _ring_area(out) > 0.99 * _ring_area(circle)

    def test_collinear_removed_first(self):
        # square with many collinear edge points decimates to the 4 corners
        e = np.linspace(0, 1, 26)[:-1]
        square = np.concatenate([
            np.stack([e, np.zeros_like(e)], axis=1),
            np.stack([np.ones_like(e), e], axis=1),
            np.stack([1 - e, np.ones_like(e)], axis=1),
            np.stack([np.zeros_like(e), 1 - e], axis=1)])
        out = simplify_ring(square, 4)
        assert len(out) == 4
        assert _ring_area(out) == pytest.approx(1.0)

    def test_degenerate_inputs(self):
        tri = np.array([[0, 0], [1, 0], [0, 1]], float)
        np.testing.assert_array_equal(simplify_ring(tri, 3), tri)
        np.testing.assert_array_equal(simplify_ring(tri[:2], 300), tri[:2])


class TestPipelineCap:
    def test_outlines_respect_configured_cap(self):
        """End-to-end: every emitted outline obeys max_points_in_polygon."""
        import jax.numpy as jnp

        from lidar_processing.runtime.pipeline import run_frame
        from lidar_processing.types import pad_cloud

        rng = np.random.default_rng(5)
        # one big dense blob => a large concave outline with many vertices
        blob = rng.uniform([-4, -4, -1.0], [4, 4, 0.0], (600, 3))
        ground = rng.uniform([-10, -10, -1.75], [10, 10, -1.7], (400, 3))
        xyz = np.concatenate([ground, blob]).astype(np.float32)

        pcfg = dataclasses.replace(
            DEFAULT_CONFIG.pipeline, max_points=1024,
            max_obstacle_points=1024, max_cells=2048, max_columns=1024,
            max_supernodes=1024, max_column_pairs=4096, max_sn_pairs=8192,
            max_live_edges=1024)
        cap = 12
        poly = dataclasses.replace(
            DEFAULT_CONFIG.polygonization,
            simplify_convex_by_maximum_points=True,
            max_points_in_polygon=cap)
        cfg = DEFAULT_CONFIG.replace(pipeline=pcfg, polygonization=poly)

        pc = pad_cloud(xyz, None, pcfg.max_points)
        out = run_frame(jnp.asarray(pc.xyz), jnp.asarray(pc.mask), cfg,
                        n_points=xyz.shape[0])
        assert out.outlines, "expected at least one outline"
        assert any(len(o) == cap for o in out.outlines) or all(
            len(o) <= cap for o in out.outlines)
        assert all(len(o) <= cap for o in out.outlines)

        # with the flag off, the big blob's outline exceeds the cap
        poly_off = dataclasses.replace(
            poly, simplify_convex_by_maximum_points=False)
        out2 = run_frame(jnp.asarray(pc.xyz), jnp.asarray(pc.mask),
                         cfg.replace(polygonization=poly_off),
                         n_points=xyz.shape[0])
        assert max(len(o) for o in out2.outlines) > cap
