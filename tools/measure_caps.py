"""Measure stixel-clustering cap occupancies over a set of frames.

Prints the max over the frames of every capacity-bound quantity, so
PipelineConfig caps and tier tables can be sized from the deployment's
data: static slots cost work whether occupied or not, and every violation
raises the overflow counter.

    python tools/measure_caps.py --data-dir DIR     # recorded .pcd frames
    python tools/measure_caps.py --seed 0 --frames 16   # seeded scenes
"""

from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args()

    from lidar_processing.config import DEFAULT_CONFIG
    from lidar_processing.io.scene import frame_seed, scan
    from lidar_processing.io.dataset import list_frames, load_frame
    from lidar_processing.ops import stixel as sx
    from lidar_processing.ops.segmentation import gpf_segment
    from lidar_processing.types import SEG_OBSTACLE, pad_cloud

    cfg = DEFAULT_CONFIG
    cap = cfg.pipeline.max_points

    @jax.jit
    def stats(xyz, mask):
        seg = gpf_segment(xyz, mask, cfg.segmentation)
        obst = mask & (seg.labels == SEG_OBSTACLE)
        res, dbg = sx._cluster_impl(xyz, obst, cfg.clustering, cfg.pipeline)
        # replicate CC round 1 to count live edges entering the fixpoint loop
        s_cap = cfg.pipeline.max_supernodes
        e_u, e_v, e_ok = dbg["e_u"], dbg["e_v"], dbg["e_ok"]
        imax = jnp.int32(np.iinfo(np.int32).max)
        l = jnp.arange(s_cap, dtype=jnp.int32)
        mn = jnp.where(e_ok, jnp.minimum(l[e_u], l[e_v]), imax)
        l = l.at[jnp.where(e_ok, l[e_u], s_cap)].min(mn, mode="drop")
        l = l.at[jnp.where(e_ok, l[e_v], s_cap)].min(mn, mode="drop")
        for _ in range(4):
            l = l[l]
        live = e_ok & (l[e_u] != l[e_v])
        return dict(
            n_obst=dbg["sp"].n_obst,
            n_cells=dbg["cells"].n_cells,
            n_sn=dbg["sn"].n_sn,
            n_cols=jnp.sum((dbg["col_sn_count"] > 0).astype(jnp.int32)),
            n_cpairs=dbg["n_cpairs"],
            n_snp=dbg["n_snp"],
            n_edges=jnp.sum(dbg["e_ok"].astype(jnp.int32)),
            n_live=jnp.sum(live.astype(jnp.int32)),
            tiers1=dbg["tiers1"],
            tiers2=dbg["tiers2"],
            n_cls=dbg["n_cls"],
            overflow=res.overflow,
            num=res.num_clusters,
        )

    if args.data_dir:
        frames = [lambda p=p: load_frame(p)[0]
                  for p in list_frames(args.data_dir)]
    else:
        frames = [lambda i=i: scan(frame_seed(args.seed, i))[0]
                  for i in range(args.frames)]
    maxima: dict = {}
    for i, load in enumerate(frames):
        xyz = load()
        pc = pad_cloud(xyz, None, cap)
        out = {k: np.asarray(v) for k, v in
               stats(jnp.asarray(pc.xyz), jnp.asarray(pc.mask)).items()}
        for k, v in out.items():
            maxima[k] = np.maximum(maxima.get(k, v), v)
        print(f"frame {i}: " + " ".join(
            f"{k}={v}" for k, v in out.items() if v.ndim == 0))
    print("\n=== maxima over", len(frames), "frames ===")
    for k, v in maxima.items():
        print(f"{k:12s} {v}")


if __name__ == "__main__":
    sys.exit(main())
