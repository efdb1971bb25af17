"""ReplayStream + export + CLI tests (VERDICT r1 item 7: no untested
runtime surface).

Uses a tiny synthetic 3-frame dataset written as real binary PCDs, so the
whole dataloader path (enumerate -> parse -> preload -> HBM replay) is
exercised end to end on the CPU mesh.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

from lidar_processing.config import DEFAULT_CONFIG
from lidar_processing.io.pcd import write_pcd_xyzi


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(7)
    sizes = [300, 200, 250]
    for i, n in enumerate(sizes):
        ground = rng.uniform([-10, -10, -1.75], [10, 10, -1.7],
                             (n - 40, 3))
        box = rng.uniform([-.5, -.5, -1.2], [.5, .5, 0], (40, 3)) + [3, 3, 0]
        xyz = np.concatenate([ground, box]).astype(np.float32)
        write_pcd_xyzi(d / f"{i:010d}.pcd", xyz,
                       np.zeros(n, np.float32))
    return str(d), sizes


def tiny_cfg():
    pcfg = dataclasses.replace(
        DEFAULT_CONFIG.pipeline, max_points=512, max_obstacle_points=512,
        max_cells=512, max_columns=256, max_supernodes=256,
        max_column_pairs=1024, max_sn_pairs=1024, max_live_edges=256,
        replay_rate_hz=10.0, queue_depth=2)
    return DEFAULT_CONFIG.replace(pipeline=pcfg)


class TestReplayStream:
    def test_cyclic_wraparound_and_order(self, tiny_dataset):
        from lidar_processing.runtime.stream import ReplayStream
        d, sizes = tiny_dataset
        stream = ReplayStream(tiny_cfg(), data_dir=d)
        assert stream.num_frames == 3
        results = list(stream.run(7, with_outlines=False))
        assert [m.frame_id for _, m in results] == [0, 1, 2, 0, 1, 2, 0]
        for out, m in results:
            n = sizes[m.frame_id]
            assert out.seg_labels.shape == (n,)
            assert m.ground_points + m.obstacle_points <= n
            assert m.ground_points > 50        # the synthetic ground plane
            assert isinstance(m.deadline_missed, bool)
            assert m.overflow == 0

    def test_outlines_and_stage_timing(self, tiny_dataset):
        from lidar_processing.runtime.stream import ReplayStream
        d, _ = tiny_dataset
        stream = ReplayStream(tiny_cfg(), data_dir=d)
        results = list(stream.run(3, stage_timing=True))
        for out, m in results:
            assert m.t_seg_ms is not None and m.t_seg_ms >= 0
            assert m.t_cluster_ms is not None and m.t_cluster_ms >= 0
            assert m.t_hull_ms is not None and m.t_hull_ms >= 0
            # the 40-point box must come out as >= 1 cluster with outline
            assert m.num_clusters >= 1
            assert len(out.outlines) == m.num_clusters
            assert len(out.outline_cluster_ids) == len(out.outlines)

    def test_realtime_pacing_flags(self, tiny_dataset):
        from lidar_processing.runtime.stream import ReplayStream
        d, _ = tiny_dataset
        cfg = tiny_cfg()
        # absurd rate => every frame misses its deadline
        pcfg = dataclasses.replace(cfg.pipeline, replay_rate_hz=1e6)
        fast = cfg.replace(pipeline=pcfg)
        stream = ReplayStream(fast, data_dir=d)
        results = list(stream.run(3, realtime=True, with_outlines=False))
        assert all(m.deadline_missed for _, m in results)

    def test_qos_slow_consumer_drops_not_lags(self, tiny_dataset):
        """DDS keep-last-2: a slow consumer sees frame GAPS, not growing
        lag (ref: src/processor.cpp:69-73 QoS depth-2 keep-last)."""
        import time

        from lidar_processing.runtime.stream import ReplayStream
        d, _ = tiny_dataset
        cfg = tiny_cfg()
        # 200 Hz publication, consumer takes ~25 ms/frame => ~5 pubs per
        # consume, window keeps the newest 2 => drops every cycle
        pcfg = dataclasses.replace(cfg.pipeline, replay_rate_hz=200.0)
        stream = ReplayStream(cfg.replace(pipeline=pcfg), data_dir=d)
        stream.warmup()
        t_end = time.perf_counter()
        dropped = 0
        n_out = 0
        for out, m in stream.run(12, realtime=True, with_outlines=False):
            time.sleep(0.025)        # slow consumer
            dropped += m.frames_dropped
            n_out += 1
            t_end = time.perf_counter()
        assert n_out == 12           # every *retained* frame delivered
        assert dropped > 0           # but publications were dropped
        # lag bound: 12 frames at 25 ms consumer time each ~ 0.3 s; an
        # unbounded queue at 200 Hz would have to wait for 12 publications
        # THEN consume (fine) — the real check is drops occurred while
        # the per-frame dispatch never waited behind a growing backlog.

    def test_non_realtime_processes_every_frame(self, tiny_dataset):
        from lidar_processing.runtime.stream import ReplayStream
        d, _ = tiny_dataset
        stream = ReplayStream(tiny_cfg(), data_dir=d)
        results = list(stream.run(6, with_outlines=False))
        assert [m.frame_id for _, m in results] == [0, 1, 2, 0, 1, 2]
        assert all(m.frames_dropped == 0 for _, m in results)


class TestExport:
    def test_export_frame_artifacts(self, tiny_dataset, tmp_path):
        from lidar_processing.io.export import export_frame
        from lidar_processing.runtime.stream import ReplayStream
        d, sizes = tiny_dataset
        stream = ReplayStream(tiny_cfg(), data_dir=d)
        (out, m), = list(stream.run(1))
        xyz = np.asarray(stream.xyz[0])[: sizes[0]]
        paths = export_frame(str(tmp_path), 0, xyz, out.seg_labels,
                             out.cluster_labels, out.outlines,
                             out.outline_cluster_ids)
        assert len(paths) == 4
        for p in paths:
            assert os.path.exists(p) and os.path.getsize(p) > 0
        # PLY headers well-formed + vertex counts match
        ground = (out.seg_labels == 1).sum()
        head = open(paths[0], "rb").read(200).decode("ascii", "ignore")
        assert f"element vertex {ground}" in head
        polys = json.load(open(paths[3]))
        assert len(polys["polygons"]) == m.num_outlines
        for poly in polys["polygons"]:
            v = poly["vertices"]
            assert v[0] == v[-1]               # closed, ref conversions.hpp:117
            assert poly["cluster_id"] >= 0

    def test_intensity_passthrough_roundtrip(self, tmp_path):
        """Intensity rides the full path: PCD -> preload -> FrameOutputs ->
        PLY export -> read-back (ref schema src/dataloader.cpp:106-110)."""
        from lidar_processing.io.export import (export_frame,
                                                    read_ply_xyzrgb)
        from lidar_processing.runtime.stream import ReplayStream
        d = tmp_path / "frames"
        d.mkdir()
        rng = np.random.default_rng(3)
        n = 300
        ground = rng.uniform([-10, -10, -1.75], [10, 10, -1.7], (n - 40, 3))
        box = rng.uniform([-.5, -.5, -1.2], [.5, .5, 0], (40, 3)) + [3, 3, 0]
        xyz = np.concatenate([ground, box]).astype(np.float32)
        inten = np.arange(n, dtype=np.float32) * 0.25
        write_pcd_xyzi(d / "0000000000.pcd", xyz, inten)

        stream = ReplayStream(tiny_cfg(), data_dir=str(d))
        (out, m), = list(stream.run(1))
        assert out.intensity is not None
        np.testing.assert_allclose(out.intensity, inten)

        xyz_r = np.asarray(stream.xyz[0])[:n]
        paths = export_frame(str(tmp_path), 0, xyz_r, out.seg_labels,
                             out.cluster_labels, out.outlines,
                             out.outline_cluster_ids,
                             intensity=out.intensity)
        # ground PLY carries the ground points' intensities, bit-exact
        _, _, i_ground = read_ply_xyzrgb(paths[0])
        np.testing.assert_array_equal(
            i_ground, inten[out.seg_labels == 1])
        _, _, i_obst = read_ply_xyzrgb(paths[1])
        np.testing.assert_array_equal(
            i_obst, inten[out.seg_labels == 2])

    def test_cluster_colors_deterministic(self):
        from lidar_processing.io.export import cluster_colors
        lab = np.arange(100, dtype=np.int32)
        c1, c2 = cluster_colors(lab), cluster_colors(lab)
        np.testing.assert_array_equal(c1, c2)
        # distinct ids get distinct colors (hash quality, 100 ids)
        assert len({tuple(c) for c in c1}) > 95
        assert c1.min() >= 64                  # bright enough on black


class TestCli:
    def test_run_command(self, tiny_dataset, tmp_path, capsys):
        from lidar_processing.cli import main
        d, _ = tiny_dataset
        rc = main(["run", "--frames", "4", "--data-dir", d,
                   "--export-dir", str(tmp_path), "--export-frames", "1"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "frame   0:" in out and "frame   1:" in out
        assert "4 frames:" in out
        assert (tmp_path / "frame_0001_polygons.json").exists()
