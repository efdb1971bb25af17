"""Headline benchmark: frames/sec on a recorded .pcd sequence in data/.

Covers all three reference stages (segment -> cluster -> polygonize,
ref: src/processor.cpp:135-219):

  * device throughput at B=1 and batched (vmap over B frames/dispatch —
    frames/sec/chip is a throughput metric; batching amortizes the fixed
    per-dispatch overhead);
  * END-TO-END ms/frame including host concave-hull outline extraction,
    overlapped with the next frame's device dispatch (the ReplayStream
    pattern) — the number comparable to the reference's 100 ms budget;
  * accuracy spot-check vs the host oracles.

Prints ONE JSON line:
  {"metric": "frames_per_sec_per_chip", "value": N, "unit": "frames/s",
   "vs_baseline": N, ...}
vs_baseline is relative to the reference's 10 Hz real-time budget
(ref: README.md:4, src/dataloader.cpp:30).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np


def main() -> None:
    import jax
    import jax.numpy as jnp

    from lidar_processing.compile_cache import enable_compile_cache
    enable_compile_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX backend is "
                         f"{jax.default_backend()!r}")

    from lidar_processing.config import DEFAULT_CONFIG
    from lidar_processing.io.dataset import list_frames, load_frame
    from lidar_processing.oracle import diff as odiff
    from lidar_processing.oracle.reference import run_pipeline
    from lidar_processing.runtime.pipeline import (
        device_frame_step, device_frame_step_packed, host_outputs_packed)
    from lidar_processing.types import pad_cloud

    cfg = DEFAULT_CONFIG
    cap = cfg.pipeline.max_points
    frames = list_frames()

    # preload + pad on host (the dataloader's preload, ref: dataloader.cpp:128)
    xs, ms, counts = [], [], []
    for p in frames:
        xyz, inten = load_frame(p)
        pc = pad_cloud(xyz, inten, cap)
        xs.append(pc.xyz)
        ms.append(pc.mask)
        counts.append(xyz.shape[0])
    X = jnp.asarray(np.stack(xs))
    M = jnp.asarray(np.stack(ms))
    clouds = [(X[i], M[i]) for i in range(len(frames))]

    step = jax.jit(lambda x, m: device_frame_step(x, m, cfg))
    out = step(*clouds[0])
    jax.block_until_ready(out)

    # --- B=1 device throughput (best of 3 passes: steady state) ----------
    ms_b1 = float("inf")
    for _rep in range(3):
        t0 = time.perf_counter()
        for xyz, mask in clouds:
            out = step(xyz, mask)
        jax.block_until_ready(out)
        ms_b1 = min(ms_b1, (time.perf_counter() - t0) / len(clouds) * 1e3)

    # --- batched device throughput (amortizes dispatch overhead) ---------
    bstep = jax.jit(jax.vmap(lambda x, m: device_frame_step(x, m, cfg)))
    best_batched = ms_b1
    best_b = 1
    for b in (4, 8):
        n = (len(frames) // b) * b
        o = bstep(X[:b], M[:b])
        jax.block_until_ready(o)
        t0 = time.perf_counter()
        for i in range(0, n, b):
            o = bstep(X[i:i + b], M[i:i + b])
        jax.block_until_ready(o)
        ms_frame = (time.perf_counter() - t0) / n * 1e3
        if ms_frame < best_batched:
            best_batched, best_b = ms_frame, b

    # --- end-to-end including host polygonization ------------------------
    # depth-2 pipeline: dispatch frame k+1, then extract outlines of frame
    # k while the device works (ref budget covers polygonization too,
    # processor.cpp:218-219)
    pstep = jax.jit(lambda x, m: device_frame_step_packed(x, m, cfg))
    jax.block_until_ready(pstep(*clouds[0]))
    n_e2e = len(clouds)
    ms_e2e = float("inf")
    host_ms = []
    n_outlines = 0
    # two passes, best kept
    for _rep in range(2):
        rep_host = []
        outs = []
        pending = []                    # (payload, n) in-flight window
        t0 = time.perf_counter()
        for i in range(n_e2e):
            fr = pstep(*clouds[i])      # async dispatch
            fr.copy_to_host_async()     # single-buffer DMA, overlapped
            pending.append((fr, counts[i]))
            if len(pending) > 2:
                pf, pn = pending.pop(0)
                h0 = time.perf_counter()
                outs.append(host_outputs_packed(pf, cfg, pn))
                rep_host.append((time.perf_counter() - h0) * 1e3)
        while pending:
            pf, pn = pending.pop(0)
            h0 = time.perf_counter()
            outs.append(host_outputs_packed(pf, cfg, pn))
            rep_host.append((time.perf_counter() - h0) * 1e3)
        rep_ms = (time.perf_counter() - t0) / n_e2e * 1e3
        if rep_ms < ms_e2e:
            ms_e2e = rep_ms
            host_ms = rep_host
            n_outlines = sum(len(o.outlines) for o in outs)

    # --- accuracy spot-check vs the host oracles on 3 frames: primary
    # contract is exact Euclidean clustering (= reference FEC at
    # cluster_quality -> 1, order-independent); the order-dependent
    # quality=0.5 comparison is reported as a secondary metric (see
    # ACCURACY.md for FEC's order sensitivity).
    ious, f1s, fec_f1s = [], [], []
    for i in (0, len(frames) // 2, len(frames) - 1):
        xyz, inten = load_frame(frames[i])
        fr = step(*clouds[i])
        n = counts[i]
        ref = run_pipeline(xyz, cfg, clustering_mode="cc")
        fec = run_pipeline(xyz, cfg, clustering_mode="fec")
        seg_dev = np.asarray(fr.seg.labels)[:n]
        cl_dev = np.asarray(fr.clustering.labels)[:n]
        ious.append(odiff.ground_mask_iou(seg_dev, ref.seg_labels))
        f1, _ = odiff.cluster_f1(
            cl_dev[ref.obstacle_indices], ref.cluster_labels)
        f1s.append(f1)
        fec_f1, _ = odiff.cluster_f1(
            cl_dev[fec.obstacle_indices], fec.cluster_labels)
        fec_f1s.append(fec_f1)

    fps = 1000.0 / best_batched
    result = {
        "metric": "frames_per_sec_per_chip",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / 10.0, 3),  # reference budget: 10 Hz
        "ms_per_frame": round(best_batched, 3),
        "batch": best_b,
        "ms_per_frame_b1": round(ms_b1, 3),
        "ms_per_frame_e2e": round(ms_e2e, 3),
        "host_outline_ms_p50": round(float(np.percentile(host_ms, 50)), 3),
        "e2e_vs_budget": round(100.0 / ms_e2e, 2),
        "n_frames": len(clouds),
        "outlines_per_frame": round(n_outlines / n_e2e, 1),
        "ground_iou_min": round(float(min(ious)), 5),
        "cluster_f1_min": round(float(min(f1s)), 5),
        "fec_quality05_f1_min": round(float(min(fec_f1s)), 5),
        "device": {"platform": jax.devices()[0].platform,
                   "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())},
    }
    print(json.dumps(result))


if __name__ == "__main__":
    sys.exit(main())
