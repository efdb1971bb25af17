"""Histogram of ambiguous-pair side sizes, for exact-test tier design.

For a spread of frames, runs the stixel pipeline up to pair classification
and prints the distribution of max(u_count, v_count) over the AMBIGUOUS
pairs (the ones needing exact block tests) — intra-column and supernode
pairs separately. Tier (cap, slots) tables should cover the measured mass
with minimal slots x window-area. CPU backend is fine (exact same logic).

Usage: JAX_PLATFORMS=cpu python tools/tier_hist.py [--step 10]
"""

from __future__ import annotations

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--step", type=int, default=10)
    args = ap.parse_args()

    import jax.numpy as jnp

    from lidar_processing.config import DEFAULT_CONFIG
    from lidar_processing.io.dataset import list_frames, load_frame
    from lidar_processing.ops import stixel as sx
    from lidar_processing.ops.segmentation import gpf_segment
    from lidar_processing.types import SEG_OBSTACLE, pad_cloud

    cfg = DEFAULT_CONFIG
    cap = cfg.pipeline.max_points
    frames = list_frames()[:: args.step]
    bins = [0, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256, 512, 2048, 10**9]

    tot_intra = np.zeros(len(bins) - 1, np.int64)
    tot_snp = np.zeros(len(bins) - 1, np.int64)
    max_intra = np.zeros(len(bins) - 1, np.int64)
    max_snp = np.zeros(len(bins) - 1, np.int64)
    tot_2d = np.zeros((len(bins) - 1, len(bins) - 1))
    max_2d = np.zeros((len(bins) - 1, len(bins) - 1))
    flops_needed = 0.0

    for p in frames:
        xyz, _ = load_frame(p)
        pc = pad_cloud(xyz, None, cap)
        xyzj, maskj = jnp.asarray(pc.xyz), jnp.asarray(pc.mask)
        seg = gpf_segment(xyzj, maskj, cfg.segmentation)
        obst = maskj & (seg.labels == SEG_OBSTACLE)
        _, dbg = sx.cluster_debug(xyzj, obst, cfg.clustering, cfg.pipeline)

        cells = dbg["cells"]
        m = cells.start.shape[0]
        # intra ambiguous: reconstruct the same pair lists as _cluster_impl
        cnt = np.asarray(cells.count)
        intra_sizes = []
        for k in (1, 2):
            act = np.asarray(dbg[f"intra_tests{k}"])
            vc = np.roll(cnt, -k)
            mx = np.maximum(cnt, vc)[act]
            intra_sizes.append(mx)
        intra = np.concatenate(intra_sizes)

        sn = dbg["sn"]
        snc = np.asarray(sn.count)
        pu, pv = np.asarray(dbg["pu"]), np.asarray(dbg["pv"])
        n_snp = int(dbg["n_snp"])
        amb = ((np.arange(len(pu)) < n_snp)
               & ~np.asarray(dbg["impossible"])
               & ~np.asarray(dbg["certain"]))
        mx_snp = np.maximum(snc[pu], snc[pv])[amb]
        mn_snp = np.minimum(snc[pu], snc[pv])[amb]
        h2, _, _ = np.histogram2d(mn_snp, mx_snp, (bins, bins))
        tot_2d = tot_2d + h2
        max_2d = np.maximum(max_2d, h2)

        hi, _ = np.histogram(intra, bins)
        hs, _ = np.histogram(mx_snp, bins)
        tot_intra += hi
        tot_snp += hs
        max_intra = np.maximum(max_intra, hi)
        max_snp = np.maximum(max_snp, hs)
        uc, vc2 = snc[pu][amb], snc[pv][amb]
        flops_needed += float(np.sum(uc.astype(np.float64) * vc2) * 8)

    n = len(frames)
    print(f"frames sampled: {n}")
    print(f"{'bin':>12s} {'intra avg':>10s} {'intra max':>10s} "
          f"{'snp avg':>10s} {'snp max':>10s}")
    for i in range(len(bins) - 1):
        lbl = f"{bins[i]}-{bins[i+1] if bins[i+1] < 10**9 else 'inf'}"
        print(f"{lbl:>12s} {tot_intra[i] / n:10.1f} {max_intra[i]:10d} "
              f"{tot_snp[i] / n:10.1f} {max_snp[i]:10d}")
    print(f"true point-pair flops needed (snp, avg/frame): "
          f"{flops_needed / n / 1e6:.1f} MFLOP")
    lbls = [f"{bins[i]}-{bins[i+1] if bins[i+1] < 10**9 else 'inf'}"
            for i in range(len(bins) - 1)]
    print("\nsnp 2D MAX counts (rows=min side, cols=max side):")
    print(" " * 10 + " ".join(f"{l:>9s}" for l in lbls))
    for i, row in enumerate(max_2d):
        print(f"{lbls[i]:>10s}" + " ".join(f"{int(v):9d}" for v in row))


if __name__ == "__main__":
    main()
