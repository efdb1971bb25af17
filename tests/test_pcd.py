"""PCD reader/writer tests against seeded scene frames written to disk."""

import numpy as np
import pytest

from lidar_processing.io.dataset import list_frames, load_frame, preload_padded
from lidar_processing.io.pcd import read_pcd, read_pcd_xyzi, write_pcd_xyzi
from lidar_processing.io.scene import frame_seed, scan


def test_dataset_enumeration(scene_dir):
    paths = list_frames(scene_dir)
    assert len(paths) == 3
    assert paths == sorted(paths)


def test_frame0_matches_header(scene_dir):
    paths = list_frames(scene_dir)
    fields = read_pcd(paths[0])
    assert set(fields) == {"x", "y", "z", "intensity"}
    xyz, inten = scan(frame_seed(0, 0))
    # the header's POINTS count and the payload match the generated frame
    assert fields["x"].shape == (xyz.shape[0],)
    assert fields["x"].dtype == np.float32
    np.testing.assert_array_equal(fields["z"], xyz[:, 2])


def test_roundtrip(tmp_path, rng):
    xyz = rng.normal(size=(100, 3)).astype(np.float32)
    inten = rng.uniform(size=(100,)).astype(np.float32)
    p = tmp_path / "t.pcd"
    write_pcd_xyzi(p, xyz, inten)
    rx, ri = read_pcd_xyzi(p)
    np.testing.assert_array_equal(rx, xyz)
    np.testing.assert_array_equal(ri, inten)


def test_preload_padded(scene_dir):
    paths = list_frames(scene_dir)[:2]
    xyz, inten, counts = preload_padded(paths, capacity=131072)
    assert xyz.shape == (2, 131072, 3)
    assert counts[0] == scan(frame_seed(0, 0))[0].shape[0]
    # padding is zero beyond count
    assert np.all(xyz[0, counts[0]:] == 0)
