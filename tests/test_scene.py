"""Seeded scene generator: determinism, frame size and content."""

import numpy as np
import pytest

from lidar_processing.io.scene import beam_elevations, frame_seed, scan


def test_deterministic_per_seed():
    a_xyz, a_int = scan(7)
    b_xyz, b_int = scan(7)
    np.testing.assert_array_equal(a_xyz, b_xyz)
    np.testing.assert_array_equal(a_int, b_int)
    c_xyz, _ = scan(8)
    assert c_xyz.shape != a_xyz.shape or not np.array_equal(c_xyz, a_xyz)


def test_frame_seeds_differ_per_index_and_sequence():
    seeds = {frame_seed(s, i) for s in range(3) for i in range(5)}
    assert len(seeds) == 15


@pytest.mark.parametrize("index", range(4))
def test_point_count_in_kitti_range(index):
    xyz, inten = scan(frame_seed(0, index))
    assert 98_000 <= xyz.shape[0] <= 124_000
    assert xyz.dtype == np.float32 and inten.dtype == np.float32
    assert inten.shape == (xyz.shape[0],)
    assert np.all(np.isfinite(xyz))
    # every return lies within the sensor's range limits
    r = np.linalg.norm(xyz, axis=1)
    assert r.min() >= 2.0 - 0.1 and r.max() <= 120.0 + 0.1


def test_beam_table():
    e = np.rad2deg(beam_elevations())
    assert e.shape == (64,)
    assert e[0] == pytest.approx(2.0) and e[-1] == pytest.approx(-24.8)
    assert np.all(np.diff(e) < 0)


def test_frame0_obstacle_share(frame0):
    from lidar_processing.config import DEFAULT_CONFIG
    from lidar_processing.oracle import reference as orc
    from lidar_processing.types import SEG_GROUND, SEG_OBSTACLE
    seg = orc.gpf_segment(frame0, DEFAULT_CONFIG.segmentation)
    ground = int((seg.labels == SEG_GROUND).sum())
    obstacle = int((seg.labels == SEG_OBSTACLE).sum())
    assert ground > obstacle > 10_000
