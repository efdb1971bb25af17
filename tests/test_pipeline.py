"""End-to-end pipeline tests: device step + host outputs vs the oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from lidar_processing.config import DEFAULT_CONFIG
from lidar_processing.oracle import diff as odiff
from lidar_processing.oracle import reference as orc
from lidar_processing.types import pad_cloud


@pytest.fixture(scope="module")
def frame0_outputs(request):
    frame0 = request.getfixturevalue("frame0")
    from lidar_processing.runtime.pipeline import (device_frame_step,
                                                       host_outputs)
    cfg = DEFAULT_CONFIG
    pc = pad_cloud(frame0, None, cfg.pipeline.max_points)
    fr = device_frame_step(jnp.asarray(pc.xyz), jnp.asarray(pc.mask), cfg)
    return host_outputs(fr, cfg, frame0.shape[0])


class TestFramePipeline:
    def test_one_outline_per_cluster(self, frame0_outputs):
        out = frame0_outputs
        assert out.num_clusters > 300
        assert len(out.outlines) == out.num_clusters

    def test_matches_oracle(self, frame0, frame0_outputs):
        cfg = DEFAULT_CONFIG
        out = frame0_outputs
        ref = orc.run_pipeline(frame0, cfg, clustering_mode="cc")
        assert odiff.ground_mask_iou(out.seg_labels, ref.seg_labels) > 0.99
        f1, det = odiff.cluster_f1(
            out.cluster_labels[ref.obstacle_indices], ref.cluster_labels)
        assert f1 > 0.999, det
        assert len(out.outlines) == len(ref.outlines)
        # outlines match the oracle's (same clusters => same hulls), compared
        # as chamfer distance between matched polygons
        chamfer_mean, unmatched = odiff.match_outlines(
            out.outlines, ref.outlines)
        assert unmatched == 0
        assert chamfer_mean < 0.02, chamfer_mean

    def test_z_extents(self, frame0, frame0_outputs):
        """Each outline carries its cluster's z range (the reference's
        planned 2.5-D PointXYdZ record, ref: src/polygonization.hpp:35-49)."""
        out = frame0_outputs
        assert len(out.outline_z_extents) == len(out.outlines)
        for cid, (zmin, zmax) in zip(out.outline_cluster_ids,
                                     out.outline_z_extents):
            pts = frame0[out.cluster_labels == cid]
            assert zmin == pytest.approx(pts[:, 2].min(), abs=1e-6)
            assert zmax == pytest.approx(pts[:, 2].max(), abs=1e-6)

    def test_packed_payload_matches_exact(self, frame0, frame0_outputs):
        """The streaming single-buffer payload path reproduces the exact
        readout: labels/counters bit-identical, outlines within the 2 mm
        quantization grid (runtime/pipeline.py payload section)."""
        from lidar_processing.runtime.pipeline import (
            device_frame_step_packed, host_outputs_packed)
        cfg = DEFAULT_CONFIG
        pc = pad_cloud(frame0, None, cfg.pipeline.max_points)
        pay = device_frame_step_packed(jnp.asarray(pc.xyz),
                                       jnp.asarray(pc.mask), cfg)
        packed = host_outputs_packed(pay, cfg, frame0.shape[0])
        exact = frame0_outputs
        np.testing.assert_array_equal(packed.seg_labels, exact.seg_labels)
        np.testing.assert_array_equal(packed.cluster_labels,
                                      exact.cluster_labels)
        assert packed.num_clusters == exact.num_clusters
        assert packed.overflow == exact.overflow == 0
        assert len(packed.outlines) == len(exact.outlines)
        assert packed.outline_cluster_ids == exact.outline_cluster_ids
        from lidar_processing.oracle.diff import polygon_chamfer
        worst = 0.0
        for a, b in zip(exact.outlines, packed.outlines):
            # chi-shape vertex COUNTS are threshold-sensitive (a 2 mm
            # perturbation can open/close a concave pocket); the geometry
            # itself must agree to ~the quantization grid
            if len(a) >= 3 and len(b) >= 3:
                worst = max(worst, polygon_chamfer(
                    np.asarray(a), np.asarray(b)))
        # same bound as the native-vs-scipy chi parity tests: a sub-mm
        # perturbation can flip a threshold-straddling concave pocket
        assert worst < 0.05, worst
        for (a0, a1), (b0, b1) in zip(exact.outline_z_extents,
                                      packed.outline_z_extents):
            assert a0 == pytest.approx(b0, abs=1e-6)
            assert a1 == pytest.approx(b1, abs=1e-6)

    def test_convex_outline_mode(self, frame0):
        """polygonizer_concave=False routes every large cluster through the
        convex path with Chan above chan_threshold
        (ref: src/polygon_simplification.cpp:32-63)."""
        import dataclasses
        from lidar_processing.runtime.pipeline import (device_frame_step,
                                                           host_outputs)
        cfg = DEFAULT_CONFIG.replace(
            polygonization=dataclasses.replace(
                DEFAULT_CONFIG.polygonization, polygonizer_concave=False))
        pc = pad_cloud(frame0, None, cfg.pipeline.max_points)
        fr = device_frame_step(jnp.asarray(pc.xyz), jnp.asarray(pc.mask), cfg)
        out = host_outputs(fr, cfg, frame0.shape[0])
        assert len(out.outlines) == out.num_clusters
        # every outline is convex CCW (strictly convex vertices)
        for o in out.outlines:
            if len(o) < 4:
                continue
            a, b, c = o, np.roll(o, -1, 0), np.roll(o, -2, 0)
            cr = ((b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1])
                  - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0]))
            assert (cr > 0).all()
