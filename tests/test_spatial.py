"""Spatial grid-block sharding vs the single-device clustering path.

Exactness contract (SURVEY §7 step 6): labels from cluster_spatial on the
8-device CPU mesh must be BIT-IDENTICAL to ops.stixel.cluster on one
device — same canonical numbering, same size-filter semantics, same
UNDEFINED handling — on synthetic scenes, a real KITTI frame, and a
1M-point synthetic cloud (env-gated: LIDAR_RUN_1M=1, ~minutes on CPU).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidar_processing.config import DEFAULT_CONFIG, SpatialConfig
from lidar_processing.ops import stixel as sx
from lidar_processing.ops.segmentation import gpf_segment
from lidar_processing.parallel.spatial import cluster_spatial
from lidar_processing.types import SEG_OBSTACLE, pad_cloud


def mesh8():
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:8]), ("space",))


def assert_identical(spatial_res, single_res):
    np.testing.assert_array_equal(np.asarray(spatial_res.labels),
                                  np.asarray(single_res.labels))
    assert int(spatial_res.num_clusters) == int(single_res.num_clusters)
    assert int(spatial_res.overflow) == 0
    assert int(single_res.overflow) == 0


class TestClusterSpatial:
    def test_synthetic_blobs(self, rng):
        cfg = DEFAULT_CONFIG
        n, npad = 6000, 8192
        # blobs straddling band boundaries: a dense rail along x plus blobs
        # (z kept within the 128-cell grid height, as for automotive LiDAR)
        rail = rng.uniform([-40, 0, 0], [40, 0.1, 0.1], (n // 2, 3))
        centers = rng.uniform([-35, -35, -1], [35, 35, 1], (n // 8, 3))
        blobs = (rng.normal(0, 0.15, (n // 2, 3))
                 + np.repeat(centers, 4, axis=0))
        xyz = np.concatenate([rail, blobs]).astype(np.float32)
        pc = pad_cloud(xyz, None, npad)

        pcfg = dataclasses.replace(cfg.pipeline, max_points=npad)
        single = sx.cluster(pc.xyz, pc.mask, cfg.clustering, pcfg)
        scfg = SpatialConfig(block_points=4096, block_clusters=1024,
                             halo_points=1024,
                             block_cells=4096, block_columns=2048,
                             block_supernodes=3072,
                             block_column_pairs=8192,
                             block_sn_pairs=8192, block_live_edges=2048)
        spatial = cluster_spatial(mesh8(), pc.xyz, pc.mask,
                                  cfg.clustering, pcfg, scfg)
        assert_identical(spatial, single)

    def test_size_filter_spans_blocks(self, rng):
        """A cluster whose fragments are each < min_size but whose merged
        size passes the filter must survive (and vice versa)."""
        cfg = DEFAULT_CONFIG
        # chain of points spaced 0.4m (< R=0.4243) along x: one cluster
        # crossing every band boundary, 2 points per band at s=8 bands
        n_chain = 16
        chain = np.stack([np.arange(n_chain) * 0.4,
                          np.zeros(n_chain), np.zeros(n_chain)], 1)
        # an isolated pair (size 2 < min 4) => INVALID everywhere
        pair = np.array([[100.0, 50, 0], [100.3, 50, 0]])
        xyz = np.concatenate([chain, pair]).astype(np.float32)
        pc = pad_cloud(xyz, None, 1024)
        pcfg = dataclasses.replace(
            cfg.pipeline, max_points=1024, max_obstacle_points=1024,
            max_cells=512, max_columns=256, max_supernodes=384,
            max_column_pairs=1024, max_sn_pairs=1024, max_live_edges=256)
        single = sx.cluster(pc.xyz, pc.mask, cfg.clustering, pcfg)
        scfg = SpatialConfig(block_points=256, block_clusters=128,
                             halo_points=128,
                             block_cells=256, block_columns=128,
                             block_supernodes=192, block_column_pairs=512,
                             block_sn_pairs=512, block_live_edges=128)
        spatial = cluster_spatial(mesh8(), pc.xyz, pc.mask,
                                  cfg.clustering, pcfg, scfg)
        assert_identical(spatial, single)
        lab = np.asarray(spatial.labels)
        assert (lab[:n_chain] == lab[0]).all() and lab[0] >= 0
        assert (lab[n_chain:n_chain + 2] == -1).all()

    def test_frame0_obstacles(self, frame0):
        cfg = DEFAULT_CONFIG
        pc = pad_cloud(frame0, None, cfg.pipeline.max_points)
        seg = gpf_segment(pc.xyz, pc.mask, cfg.segmentation)
        obstacle = pc.mask & (seg.labels == SEG_OBSTACLE)
        single = sx.cluster(pc.xyz, obstacle, cfg.clustering, cfg.pipeline)
        spatial = cluster_spatial(mesh8(), pc.xyz, obstacle,
                                  cfg.clustering, cfg.pipeline,
                                  DEFAULT_CONFIG.spatial)
        assert_identical(spatial, single)

    def test_2d_mesh_data_x_space(self, rng):
        """SURVEY §7 step 6: hosts x chips 2-D mesh — frames over 'data',
        each frame's x-bands over 'space'. Per-frame labels bit-identical
        to the single-device path."""
        from jax.sharding import Mesh
        from lidar_processing.parallel.spatial import cluster_spatial_2d
        cfg = DEFAULT_CONFIG
        mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                    ("data", "space"))
        npad = 4096
        frames = []
        for f in range(2):
            rail = rng.uniform([-30, 0, 0], [30, 0.1, 0.1], (1000, 3))
            centers = rng.uniform([-25, -25, -1], [25, 25, 1], (250, 3))
            blobs = (rng.normal(0, 0.15, (1000, 3))
                     + np.repeat(centers, 4, axis=0))
            xyz = np.concatenate([rail, blobs]).astype(np.float32)
            frames.append(pad_cloud(xyz, None, npad))
        xyzs = jnp.stack([f.xyz for f in frames])
        valids = jnp.stack([f.mask for f in frames])

        pcfg = dataclasses.replace(cfg.pipeline, max_points=npad)
        scfg = SpatialConfig(block_points=2048, block_clusters=512,
                             halo_points=512,
                             block_cells=2048, block_columns=1024,
                             block_supernodes=1536,
                             block_column_pairs=4096,
                             block_sn_pairs=4096, block_live_edges=1024)
        res = cluster_spatial_2d(mesh, xyzs, valids, cfg.clustering,
                                 pcfg, scfg)
        for f in range(2):
            single = sx.cluster(xyzs[f], valids[f], cfg.clustering, pcfg)
            np.testing.assert_array_equal(np.asarray(res.labels[f]),
                                          np.asarray(single.labels))
            assert int(res.num_clusters[f]) == int(single.num_clusters)
            assert int(res.overflow[f]) == 0

    def test_full_pipeline_spatial(self, rng):
        """device_frame_step_spatial (SURVEY §7 step 6: GPF + clustering
        both under the space axis): seg within the documented f32-psum
        tolerance of the single-device step; clustering bit-identical on
        the sharded seg's own obstacle mask; hull stage consistent."""
        from lidar_processing.parallel.frame_spatial import (
            device_frame_step_spatial, gpf_spatial)
        from lidar_processing.runtime.pipeline import device_frame_step
        import math
        cfg = DEFAULT_CONFIG
        npad = 4096
        rail = rng.uniform([-30, 0, 0], [30, 0.1, 0.1], (800, 3))
        centers = rng.uniform([-25, -25, -0.8], [25, 25, 0.5], (200, 3))
        blobs = (rng.normal(0, 0.15, (800, 3))
                 + np.repeat(centers, 4, axis=0))
        ground = rng.uniform([-30, -30, -1.78], [30, 30, -1.70], (1500, 3))
        xyz = np.concatenate([ground, rail, blobs]).astype(np.float32)
        pc = pad_cloud(xyz, None, npad)
        n = xyz.shape[0]

        pcfg = dataclasses.replace(
            cfg.pipeline, max_points=npad, max_obstacle_points=npad)
        scfg = SpatialConfig(block_points=2048, block_clusters=512,
                             halo_points=512,
                             block_cells=2048, block_columns=1024,
                             block_supernodes=1536,
                             block_column_pairs=4096,
                             block_sn_pairs=4096, block_live_edges=1024)
        tcfg = cfg.replace(pipeline=pcfg, spatial=scfg)
        mesh = mesh8()

        # seg: within f32-psum wobble of the single-device labels
        with mesh:
            seg_sp, seg_ovf = gpf_spatial(
                mesh, pc.xyz, pc.mask, tcfg.segmentation, scfg,
                math.sqrt(tcfg.clustering.distance_squared))
        assert int(seg_ovf) == 0
        single = device_frame_step(pc.xyz, pc.mask, tcfg)
        seg_diff = int(np.sum(np.asarray(seg_sp.labels)[:n]
                              != np.asarray(single.seg.labels)[:n]))
        assert seg_diff <= max(2, n // 1000), seg_diff

        # full spatial step: clustering bit-identical to the single-device
        # clustering of the SAME (sharded) obstacle mask
        fr = device_frame_step_spatial(mesh, pc.xyz, pc.mask, tcfg)
        from lidar_processing.types import SEG_OBSTACLE as OB
        obst = pc.mask & (np.asarray(fr.seg.labels) == OB)
        ref_cl = sx.cluster(pc.xyz, jnp.asarray(obst), tcfg.clustering,
                            pcfg)
        np.testing.assert_array_equal(np.asarray(fr.clustering.labels),
                                      np.asarray(ref_cl.labels))
        assert int(fr.clustering.overflow) == 0
        assert int(fr.hull_overflow) == 0
        # hull stage emitted one slot per cluster
        assert (int(fr.n_small) + int(fr.n_large)
                == int(fr.clustering.num_clusters))

    @pytest.mark.skipif(os.environ.get("LIDAR_RUN_1M") != "1",
                        reason="set LIDAR_RUN_1M=1 (CPU runtime: minutes)")
    def test_synthetic_1m_points(self, rng):
        cfg = DEFAULT_CONFIG
        n = 1_000_000
        npad = 1 << 20
        # KITTI-like density scaled up: 250m x 250m field of blobs + noise
        centers = rng.uniform([-125, -125, -1], [125, 125, 2],
                              (n // 200, 3))
        blobs = (rng.normal(0, 0.2, (n // 2, 3)).astype(np.float32)
                 + np.repeat(centers, 100, axis=0).astype(np.float32))
        noise = rng.uniform([-125, -125, -2], [125, 125, 3],
                            (n // 2, 3)).astype(np.float32)
        xyz = np.concatenate([blobs, noise]).astype(np.float32)
        pc = pad_cloud(xyz, None, npad)
        pcfg = dataclasses.replace(
            cfg.pipeline, max_points=npad, max_obstacle_points=npad,
            max_cells=1 << 19, max_columns=1 << 18,
            max_supernodes=1 << 18, max_column_pairs=1 << 20,
            max_sn_pairs=1 << 20, max_live_edges=1 << 18)
        single = sx.cluster(pc.xyz, pc.mask, cfg.clustering, pcfg)
        scfg = SpatialConfig(
            block_points=1 << 18, block_clusters=1 << 16,
            halo_points=16384,
            block_cells=1 << 17, block_columns=1 << 16,
            block_supernodes=1 << 16, block_column_pairs=1 << 18,
            block_sn_pairs=1 << 18, block_live_edges=1 << 16)
        spatial = cluster_spatial(mesh8(), pc.xyz, pc.mask,
                                  cfg.clustering, pcfg, scfg)
        assert_identical(spatial, single)
