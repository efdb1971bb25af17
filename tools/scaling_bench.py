"""Scaling-efficiency harness: frames/sec vs device count on a mesh.

Measures the data-axis (frame-parallel) pipeline at 1/2/4/8 devices and
the 2-D data x space mesh, reporting throughput and efficiency vs the
1-device baseline at equal per-device batch.

IMPORTANT caveat when run on the virtual CPU mesh
(JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8):
all "devices" share the host's physical cores, so compute does NOT scale
— what this harness validates there is the ORCHESTRATION overhead
(sharding, collectives, reassembly): efficiency ~= T_serial / T_sharded
for the same total work. Real chip-scaling numbers require a real
multi-GPU host; there the same harness applies unchanged (frames are
independent, so the data axis has zero cross-device communication, and
the space axis communicates only halo margins + merge tables).

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
      python tools/scaling_bench.py [--frames-per-dev 2] [--reps 3]
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

# honor JAX_PLATFORMS through jax.config like tests/conftest.py does
if os.environ.get("JAX_PLATFORMS"):
    import jax as _jax
    _jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def synth_frame(cap: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    n_real = cap // 2
    n_box = min(2000, n_real // 4)
    n_box -= n_box % 100
    xyz = np.zeros((cap, 3), np.float32)
    g = rng.uniform([-40, -40, -1.8], [40, 40, -1.6], (n_real - n_box, 3))
    boxes = rng.uniform([-2, -2, -1.5], [2, 2, 0.5], (n_box, 3)) + np.repeat(
        rng.uniform(-30, 30, (n_box // 100, 3)) * [1, 1, 0], 100, axis=0)
    xyz[:n_real] = np.concatenate([g, boxes]).astype(np.float32)
    mask = np.zeros((cap,), bool)
    mask[:n_real] = True
    return xyz, mask


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames-per-dev", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--max-points", type=int, default=16384)
    args = ap.parse_args()

    import dataclasses

    import jax
    import jax.numpy as jnp

    from lidar_processing.config import DEFAULT_CONFIG, SpatialConfig
    from lidar_processing.parallel.sharded import (make_mesh,
                                                       make_mesh_2d,
                                                       sharded_batch_step,
                                                       sharded_pipeline_2d)

    cap = args.max_points
    pcfg = dataclasses.replace(
        DEFAULT_CONFIG.pipeline, max_points=cap, max_obstacle_points=cap,
        max_cells=cap, max_columns=cap // 2, max_supernodes=cap // 2,
        max_column_pairs=2 * cap, max_sn_pairs=2 * cap,
        max_live_edges=cap // 4, payload_large_points=cap)
    scfg = SpatialConfig(
        block_points=cap // 2, block_clusters=cap // 8,
        halo_points=cap // 8, block_cells=cap // 2,
        block_columns=cap // 4, block_supernodes=cap // 4,
        block_column_pairs=cap, block_sn_pairs=cap,
        block_live_edges=cap // 8)
    cfg = DEFAULT_CONFIG.replace(pipeline=pcfg, spatial=scfg)

    n_avail = len(jax.devices())
    print(f"backend={jax.default_backend()} devices={n_avail} "
          f"points/frame={cap}", flush=True)

    # FIXED total workload across all device counts, so the efficiency
    # column reads as T(1 dev) / T(nd devs) for the SAME work. On a real
    # multi-chip slice this is chip-scaling efficiency; on the virtual
    # CPU mesh (shared physical cores) it isolates orchestration overhead.
    b_total = args.frames_per_dev * min(8, n_avail)
    frames = [synth_frame(cap, seed=i) for i in range(b_total)]
    X = jnp.asarray(np.stack([f[0] for f in frames]))
    M = jnp.asarray(np.stack([f[1] for f in frames]))
    results = {}
    for nd in (1, 2, 4, 8):
        if nd > n_avail:
            continue
        mesh = make_mesh(nd)
        out = sharded_batch_step(mesh, X, M, cfg)   # compile
        jax.block_until_ready(out)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = sharded_batch_step(mesh, X, M, cfg)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        results[nd] = best
        eff = results[1] / best
        print(f"data axis: {b_total} frames on {nd} dev: "
              f"{b_total / best:8.2f} fps ({best * 1e3 / b_total:7.2f} "
              f"ms/frame)  T(1)/T({nd}) = {eff * 100:5.1f}%", flush=True)

    if n_avail >= 8:
        b = 2
        X2, M2 = X[:b], M[:b]
        mesh2 = make_mesh_2d(2, 4)
        seg, cl = sharded_pipeline_2d(mesh2, X2, M2, cfg)   # compile
        jax.block_until_ready(cl.labels)
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            seg, cl = sharded_pipeline_2d(mesh2, X2, M2, cfg)
            jax.block_until_ready(cl.labels)
            best = min(best, time.perf_counter() - t0)
        print(f"2-D mesh (2 data x 4 space), {b} frames: {b / best:8.2f} "
              f"fps ({best * 1e3 / b:7.2f} ms/frame) "
              f"[seg+cluster only]", flush=True)


if __name__ == "__main__":
    main()
