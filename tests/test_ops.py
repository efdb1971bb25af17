"""Device-op tests vs the host oracles (CPU backend, small + real data).

Mirrors the reference's brute-force-oracle test pattern
(ref: test/test_kdtree.cpp:31-187) at the level the device design needs:
segmentation labels vs the faithful GPF oracle, clustering vs exact
radius-graph CC, hulls vs the monotone-chain oracle.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from lidar_processing.config import DEFAULT_CONFIG
from lidar_processing.oracle import diff as odiff
from lidar_processing.oracle import reference as orc
from lidar_processing.types import (CLUSTER_UNDEFINED, SEG_GROUND,
                                        SEG_OBSTACLE, SEG_UNKNOWN, pad_cloud)


def small_cfg(max_points=4096, **pipeline_kw):
    pcfg = dataclasses.replace(
        DEFAULT_CONFIG.pipeline, max_points=max_points,
        max_cells=2048, max_ambiguous_pairs=8192, **pipeline_kw)
    return DEFAULT_CONFIG.replace(pipeline=pcfg)


def synth_scene(rng, n_ground=3000, boxes=8, pts_per_box=60):
    g = rng.uniform([-20, -20, -1.8], [20, 20, -1.65],
                    (n_ground, 3)).astype(np.float32)
    centers = rng.uniform([-15, -15, 0], [15, 15, 0], (boxes, 3))
    b = (rng.uniform([-0.8, -0.8, -1.5], [0.8, 0.8, 0.3],
                     (boxes, pts_per_box, 3)) + centers[:, None, :])
    return np.concatenate([g, b.reshape(-1, 3)]).astype(np.float32)


class TestSegmentationOp:
    def test_matches_oracle_synthetic(self, rng):
        from lidar_processing.ops.segmentation import gpf_segment
        xyz = synth_scene(rng)
        cfg = small_cfg()
        pc = pad_cloud(xyz, None, cfg.pipeline.max_points)
        res = gpf_segment(jnp.asarray(pc.xyz), jnp.asarray(pc.mask),
                          cfg.segmentation)
        dev = np.asarray(res.labels)[:xyz.shape[0]]
        ref = orc.gpf_segment(xyz, cfg.segmentation).labels
        iou = odiff.ground_mask_iou(dev, ref)
        assert iou > 0.995, iou

    def test_matches_oracle_frame0(self, frame0):
        from lidar_processing.ops.segmentation import gpf_segment
        cfg = DEFAULT_CONFIG
        pc = pad_cloud(frame0, None, cfg.pipeline.max_points)
        res = gpf_segment(jnp.asarray(pc.xyz), jnp.asarray(pc.mask),
                          cfg.segmentation)
        dev = np.asarray(res.labels)[:frame0.shape[0]]
        ref = orc.gpf_segment(frame0, cfg.segmentation).labels
        assert odiff.ground_mask_iou(dev, ref) > 0.99
        # padded entries stay UNKNOWN
        assert np.all(
            np.asarray(res.labels)[frame0.shape[0]:] == SEG_UNKNOWN)

    def test_empty_cloud(self):
        from lidar_processing.ops.segmentation import gpf_segment
        cfg = small_cfg(max_points=256)
        xyz = jnp.zeros((256, 3), jnp.float32)
        mask = jnp.zeros((256,), bool)
        res = gpf_segment(xyz, mask, cfg.segmentation)
        assert np.all(np.asarray(res.labels) == SEG_UNKNOWN)


def _cluster_fn(backend):
    if backend == "stixel":
        from lidar_processing.ops.stixel import cluster
    else:
        from lidar_processing.ops.clustering import cluster
    return cluster


@pytest.mark.parametrize("backend", ["stixel", "cellgraph"])
class TestClusteringOp:
    def test_exact_cc_synthetic(self, rng, backend):
        cluster = _cluster_fn(backend)
        cfg = small_cfg()
        # blobs with gaps straddling the 0.424 m radius
        centers = rng.uniform(-10, 10, (20, 3))
        pts = (rng.normal(0, 0.25, (20, 80, 3)) + centers[:, None, :]
               ).reshape(-1, 3).astype(np.float32)
        pc = pad_cloud(pts, None, cfg.pipeline.max_points)
        res = cluster(jnp.asarray(pc.xyz), jnp.asarray(pc.mask),
                      cfg.clustering, cfg.pipeline)
        assert int(res.overflow) == 0
        dev = np.asarray(res.labels)[:pts.shape[0]]
        ref = orc.radius_cc_cluster(pts, cfg.clustering)
        f1, det = odiff.cluster_f1(dev, ref)
        assert f1 == pytest.approx(1.0, abs=1e-9), det
        # identical label numbering (min-point-index canonical order)
        assert np.array_equal(dev, ref)

    def test_padding_is_undefined(self, rng, backend):
        cluster = _cluster_fn(backend)
        cfg = small_cfg()
        pts = rng.normal(0, 0.1, (50, 3)).astype(np.float32)
        pc = pad_cloud(pts, None, cfg.pipeline.max_points)
        res = cluster(jnp.asarray(pc.xyz), jnp.asarray(pc.mask),
                      cfg.clustering, cfg.pipeline)
        assert np.all(np.asarray(res.labels)[50:] == CLUSTER_UNDEFINED)

    def test_invalid_point_does_not_corrupt_numbering(self, backend):
        """Regression: padding/invalid rows inherit the LAST cell's id in
        the sorted buffer; their original indices must not leak into that
        cell's min_orig or the canonical numbering flips (seen on KITTI
        frames 28/44/110/112/116 in the 154-frame golden run)."""
        cluster = _cluster_fn(backend)
        cfg = small_cfg(max_points=64)
        xyz = np.zeros((64, 3), np.float32)
        mask = np.zeros(64, bool)
        # index 0: an INVALID point (e.g. ground) with the smallest orig idx
        xyz[0] = [50.0, 0, 0]
        # cluster A: orig 1..4 at x=0; cluster B: orig 5..8 at large x
        # (B sorts last, so padding rows attach to B's final cell)
        for i in range(1, 5):
            xyz[i] = [0.0, 0.05 * i, 0]
        for i in range(5, 9):
            xyz[i] = [80.0, 0.05 * i, 0]
        mask[1:9] = True
        res = cluster(jnp.asarray(xyz), jnp.asarray(mask),
                      cfg.clustering, cfg.pipeline)
        lab = np.asarray(res.labels)
        assert int(res.num_clusters) == 2
        # canonical numbering by min ORIGINAL index: A (min 1) before B (5)
        assert np.all(lab[1:5] == 0), lab[:9]
        assert np.all(lab[5:9] == 1), lab[:9]

    def test_size_filter(self, backend):
        cluster = _cluster_fn(backend)
        cfg = small_cfg(max_points=256)
        # 3-point cluster (below min 4) + 5-point cluster
        a = np.array([[0, 0, 0], [0.1, 0, 0], [0.2, 0, 0]], np.float32)
        b = np.array([[5, 5, 0], [5.1, 5, 0], [5.2, 5, 0],
                      [5.3, 5, 0], [5.4, 5, 0]], np.float32)
        pts = np.concatenate([a, b])
        pc = pad_cloud(pts, None, 256)
        res = cluster(jnp.asarray(pc.xyz), jnp.asarray(pc.mask),
                      cfg.clustering, cfg.pipeline)
        lbl = np.asarray(res.labels)[:8]
        assert np.all(lbl[:3] == -1)          # INVALID
        assert np.all(lbl[3:] == 0)
        assert int(res.num_clusters) == 1

    def test_matches_oracle_frame0_obstacles(self, frame0, backend):
        cluster = _cluster_fn(backend)
        cfg = DEFAULT_CONFIG
        seg = orc.gpf_segment(frame0, cfg.segmentation)
        pc = pad_cloud(frame0, None, cfg.pipeline.max_points)
        obstacle = np.zeros((cfg.pipeline.max_points,), bool)
        obstacle[:frame0.shape[0]] = seg.labels == SEG_OBSTACLE
        res = cluster(jnp.asarray(pc.xyz), jnp.asarray(obstacle),
                      cfg.clustering, cfg.pipeline)
        dev = np.asarray(res.labels)[:frame0.shape[0]]
        obs_idx = np.flatnonzero(seg.labels == SEG_OBSTACLE)
        ref = orc.radius_cc_cluster(frame0[obs_idx], cfg.clustering)
        # overflow > 0 only flags *potentially* missed capped-cell pairs; the
        # oracle diff is the ground truth — labels must be bit-identical.
        assert np.array_equal(dev[obs_idx], ref)


class TestHullOps:
    def test_batched_convex_vs_oracle(self, rng):
        from lidar_processing.ops.hull import convex_hulls_batched
        C, P = 16, 24
        pts = rng.normal(0, 1.0, (C, P, 2)).astype(np.float32)
        counts = rng.integers(3, P + 1, (C,)).astype(np.int32)
        out = convex_hulls_batched(jnp.asarray(pts), jnp.asarray(counts),
                                   P + 1)
        for c in range(C):
            k = int(out.counts[c])
            dev = np.asarray(out.vertices[c][:k])
            idx = orc.convex_hull_indices(pts[c, :counts[c]])
            ref = pts[c, idx]
            assert k == len(idx), (c, k, len(idx))
            # same cyclic order
            roll = np.argmin(
                [np.abs(np.roll(ref, -s, 0) - dev).max()
                 for s in range(k)])
            np.testing.assert_allclose(np.roll(ref, -roll, 0), dev,
                                       atol=1e-6)

    def test_label_runs_and_gather(self, rng):
        from lidar_processing.ops.hull import gather_runs, label_runs
        n = 512
        xyz = rng.normal(0, 1, (n, 3)).astype(np.float32)
        labels = rng.integers(-1, 5, (n,)).astype(np.int32)
        runs = label_runs(jnp.asarray(xyz), jnp.asarray(labels), 8)
        assert int(runs.overflow) == 0
        assert int(runs.num) == 5
        sorted_np = np.asarray(runs.sorted_xyz)
        pts = gather_runs(runs.sorted_xyz, runs.starts, runs.counts, 256)
        for lbl in range(5):
            sel = xyz[labels == lbl]       # original point order
            s, k = int(runs.starts[lbl]), int(runs.counts[lbl])
            assert k == sel.shape[0]
            np.testing.assert_array_equal(sorted_np[s:s + k], sel)
            np.testing.assert_array_equal(
                np.asarray(pts[lbl][:k]), sel)
            assert np.all(np.asarray(pts[lbl][k:]) == 0.0)

    def test_label_runs_overflow_counted(self, rng):
        """Cluster ids beyond the slot table are DROPPED and counted,
        never silently merged into the last slot."""
        from lidar_processing.ops.hull import label_runs
        labels = np.array([0, 1, 2, 3, 3, 9, 9, -1], np.int32)
        xyz = rng.normal(0, 1, (8, 3)).astype(np.float32)
        runs = label_runs(jnp.asarray(xyz), jnp.asarray(labels), 4)
        assert int(runs.overflow) == 2
        assert np.asarray(runs.counts).tolist() == [1, 1, 1, 2]
