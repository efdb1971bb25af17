"""Launch-equivalent CLI: run the whole system with one command.

The reference's launch.sh starts the dataloader + processor + RViz
(ref: launch.sh:12-16); here one process owns the device-resident replay
stream, the device pipeline, per-frame metrics logging, and optional
visualization export:

    python -m lidar_processing run              # every frame in data/
    python -m lidar_processing run --data-dir DIR --frames 16
    python -m lidar_processing run --realtime   # paced at 10 Hz
    python -m lidar_processing run --stage-timing
    python -m lidar_processing run --export-dir out --export-frames 0,77
    python -m lidar_processing golden           # 154-frame parity run
    python -m lidar_processing bench            # headline benchmark
"""

from __future__ import annotations

import argparse
import sys


def _cmd_run(args) -> int:
    import numpy as np

    from .config import DEFAULT_CONFIG
    from .io.export import export_frame
    from .runtime.stream import ReplayStream

    cfg = DEFAULT_CONFIG
    stream = ReplayStream(cfg, data_dir=args.data_dir)
    n = args.frames if args.frames else stream.num_frames
    export_ids = (set(int(x) for x in args.export_frames.split(","))
                  if args.export_frames else set())

    disp, host, missed, overflow, dropped = [], [], 0, 0, 0
    for out, m in stream.run(n, realtime=args.realtime,
                             stage_timing=args.stage_timing):
        stage = ""
        if m.t_seg_ms is not None:
            stage = (f" seg={m.t_seg_ms:6.2f}ms clu={m.t_cluster_ms:6.2f}ms"
                     f" hull={m.t_hull_ms:6.2f}ms")
        print(f"frame {m.frame_id:3d}: dispatch={m.t_dispatch_ms:7.2f}ms "
              f"host={m.t_host_ms:6.2f}ms{stage} "
              f"ground={m.ground_points:6d} obst={m.obstacle_points:6d} "
              f"clusters={m.num_clusters:3d} outlines={m.num_outlines:3d}"
              f"{' DEADLINE' if m.deadline_missed else ''}"
              f"{' OVERFLOW' if m.overflow else ''}")
        disp.append(m.t_dispatch_ms)
        host.append(m.t_host_ms)
        missed += m.deadline_missed
        overflow += m.overflow
        dropped += m.frames_dropped
        if m.frame_id in export_ids and args.export_dir:
            fid = m.frame_id
            from .io.dataset import list_frames, load_frame
            paths_all = (list_frames(args.data_dir) if args.data_dir
                         else list_frames())
            xyz, _ = load_frame(paths_all[fid])
            paths = export_frame(args.export_dir, fid, xyz,
                                 out.seg_labels, out.cluster_labels,
                                 out.outlines, out.outline_cluster_ids,
                                 out.outline_z_extents,
                                 intensity=out.intensity)
            print(f"  exported: {', '.join(paths)}")

    print(f"\n{n} frames: dispatch p50={np.percentile(disp, 50):.2f}ms "
          f"p99={np.percentile(disp, 99):.2f}ms "
          f"host p50={np.percentile(host, 50):.2f}ms "
          f"deadline_missed={missed} overflow_frames={overflow} "
          f"frames_dropped={dropped}")
    return 0


def _cmd_bench(args) -> int:
    import runpy
    sys.argv = ["bench.py"]
    runpy.run_path("bench.py", run_name="__main__")
    return 0


def _cmd_golden(args) -> int:
    import runpy
    sys.argv = ["golden_run.py"] + (
        ["--frames", str(args.frames)] if args.frames else [])
    try:
        runpy.run_path("tools/golden_run.py", run_name="__main__")
    except SystemExit as e:
        return int(e.code or 0)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="lidar_processing")
    sub = ap.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="replay stream + pipeline + metrics")
    run.add_argument("--frames", type=int, default=None)
    run.add_argument("--realtime", action="store_true",
                     help="pace at replay_rate_hz (10 Hz, ref budget)")
    run.add_argument("--stage-timing", action="store_true",
                     help="time seg/cluster/hull stages separately")
    run.add_argument("--export-dir", default=None)
    run.add_argument("--export-frames", default=None,
                     help="comma-separated frame ids to export")
    run.add_argument("--data-dir", default=None)
    run.set_defaults(fn=_cmd_run)

    bench = sub.add_parser("bench", help="headline benchmark")
    bench.set_defaults(fn=_cmd_bench)

    golden = sub.add_parser("golden", help="154-frame golden parity run")
    golden.add_argument("--frames", type=int, default=None)
    golden.set_defaults(fn=_cmd_golden)

    args = ap.parse_args(argv)
    from .compile_cache import enable_compile_cache
    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
