"""Smoke run of the segment -> cluster -> outline pipeline on one GPU.

    python chip_smoke.py [--seed 0] [--frames 8] [--stream-frames 16]
    python chip_smoke.py --multi-gpu        # four cards: sharded paths only

Generates seeded full-size 64-beam scans (io/scene.py, ~110k points padded
to 131,072) into `.scenes/` in the checkout and drives the normal entry
points with the default EngineConfig:

  a. device check: JAX's backend is the GPU, and the native host module
     builds from the committed source;
  b. normal path: ReplayStream (packed payload + host chi-hulls) over the
     frames, then the CLI's `run` command, in this process;
  c. correctness on three frames against the host oracle: ground IoU,
     cluster F1 and bit-identical frames, zero overflow, one outline per
     cluster, packed readout against the exact readout;
  d. the pieces that replaced accelerator-specific kernels, at real widths
     against plain references: exact-pair min-d² at every tier (float64
     brute force), connected components on the frames' supernode edge lists
     and on large random graphs (host union-find), GPF plane normals
     (float64 oracle).

With --multi-gpu it runs only the multi-device paths on four cards (frame
sharding, in-frame x-band sharding, a 2x2 mesh) against single-device runs.

Exits nonzero at the first failed phase, and before any phase when JAX has
no GPU. The last line of standard output is a JSON object with the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


class PhaseError(Exception):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def scene_dir(seed: int, frames: int) -> str:
    from lidar_processing.io.scene import write_scenes
    d = os.path.join(ROOT, ".scenes", f"seed{seed}")
    write_scenes(d, frames, seed=seed)
    return d


# ---------------------------------------------------------------- phases --

def phase_device() -> str:
    import jax
    import jaxlib

    from lidar_processing.ops import hull_native
    check(jax.default_backend() == "gpu",
          f"JAX backend is {jax.default_backend()!r}, not 'gpu'")
    check(hull_native.build() and hull_native.native_available(),
          "native module did not build or load")
    dev = jax.devices()[0]
    return (f"{dev.device_kind} x{len(jax.devices())}, jax {jax.__version__}"
            f", jaxlib {jaxlib.__version__}, native module loaded")


def phase_normal_path(cfg, data_dir: str, n_frames: int, card: str) -> str:
    import jax

    from lidar_processing import cli
    from lidar_processing.runtime.stream import ReplayStream

    stream = ReplayStream(cfg, data_dir=data_dir)
    t0 = time.perf_counter()
    stream.warmup()
    compile_s = time.perf_counter() - t0
    # the first pass also pays one-time host set-up (~0.9 s on an H100
    # host); only the second is timed
    t0 = time.perf_counter()
    for _ in stream.run(n_frames):
        pass
    first_s = time.perf_counter() - t0
    n_out = 0
    t0 = time.perf_counter()
    for out, m in stream.run(n_frames):
        check(m.overflow == 0, f"frame {m.frame_id}: overflow {m.overflow}")
        check(m.num_outlines == m.num_clusters,
              f"frame {m.frame_id}: {m.num_outlines} outlines for "
              f"{m.num_clusters} clusters")
        check(m.obstacle_points > 10_000,
              f"frame {m.frame_id}: {m.obstacle_points} obstacle points")
        n_out += 1
    wall = time.perf_counter() - t0
    check(n_out == n_frames, f"stream yielded {n_out}/{n_frames} frames")
    stats = jax.devices()[0].memory_stats() or {}
    peak = (f"{stats['peak_bytes_in_use'] / 2**20:.1f} MiB"
            if "peak_bytes_in_use" in stats else "not measured")
    print(f"  compile (first packed step): {compile_s:.3f} s [{card}]")
    print(f"  first ReplayStream pass: {first_s:.3f} s for {n_frames} "
          f"frames [{card}]")
    print(f"  ReplayStream steady e2e: {n_frames / wall:.2f} frames/s "
          f"({wall / n_frames * 1e3:.2f} ms/frame over {n_frames} frames, "
          f"host chi-hulls included) [{card}]")
    print(f"  peak device memory: {peak} [{card}]")
    rc = cli.main(["run", "--data-dir", data_dir, "--frames", "8"])
    check(rc == 0, f"cli run returned {rc}")
    return f"{n_frames} stream frames and 8 CLI frames, zero overflow"


def phase_oracle(cfg, paths, normals_out: list) -> str:
    import jax.numpy as jnp

    from lidar_processing.io.dataset import load_frame
    from lidar_processing.oracle import diff as odiff
    from lidar_processing.oracle import reference as orc
    from lidar_processing.runtime.pipeline import (
        device_frame_step, device_frame_step_packed, host_outputs,
        host_outputs_packed)
    from lidar_processing.types import pad_cloud

    cap = cfg.pipeline.max_points
    ious, f1s, identical = [], [], 0
    for i, p in enumerate(paths):
        xyz, _ = load_frame(p)
        n = xyz.shape[0]
        pc = pad_cloud(xyz, None, cap)
        fr = device_frame_step(pc.xyz, pc.mask, cfg)
        exact = host_outputs(fr, cfg, n)
        ref = orc.run_pipeline(xyz, cfg, clustering_mode="cc")
        iou = odiff.ground_mask_iou(exact.seg_labels, ref.seg_labels)
        dev_cl = exact.cluster_labels[ref.obstacle_indices]
        f1, det = odiff.cluster_f1(dev_cl, ref.cluster_labels)
        ious.append(iou)
        f1s.append(f1)
        identical += int(np.array_equal(dev_cl, ref.cluster_labels))
        check(iou > 0.99, f"frame {i}: ground IoU {iou}")
        check(f1 >= 0.999, f"frame {i}: cluster F1 {f1} {det}")
        check(int(fr.clustering.overflow) == 0,
              f"frame {i}: overflow {int(fr.clustering.overflow)}")
        check(int(fr.hull_overflow) == 0,
              f"frame {i}: hull_overflow {int(fr.hull_overflow)}")
        check(len(exact.outlines) == exact.num_clusters,
              f"frame {i}: {len(exact.outlines)} outlines for "
              f"{exact.num_clusters} clusters")
        check(exact.num_clusters > 100,
              f"frame {i}: only {exact.num_clusters} clusters")

        # packed payload against the exact readout (tests/test_pipeline.py)
        pay = device_frame_step_packed(pc.xyz, pc.mask, cfg)
        packed = host_outputs_packed(pay, cfg, n)
        check(np.array_equal(packed.seg_labels, exact.seg_labels)
              and np.array_equal(packed.cluster_labels,
                                 exact.cluster_labels),
              f"frame {i}: packed labels differ from exact readout")
        check(packed.num_clusters == exact.num_clusters
              and packed.overflow == exact.overflow == 0
              and packed.outline_cluster_ids == exact.outline_cluster_ids,
              f"frame {i}: packed counters differ from exact readout")
        worst = max([odiff.polygon_chamfer(np.asarray(a), np.asarray(b))
                     for a, b in zip(exact.outlines, packed.outlines)
                     if len(a) >= 3 and len(b) >= 3] + [0.0])
        check(worst < 0.05, f"frame {i}: packed outline chamfer {worst}")
        zdiff = max([abs(a0 - b0) + abs(a1 - b1) for (a0, a1), (b0, b1)
                     in zip(exact.outline_z_extents,
                            packed.outline_z_extents)] + [0.0])
        check(zdiff <= 2e-6, f"frame {i}: packed z extents off by {zdiff}")

        # GPF planes against the float64 oracle
        oseg = orc.gpf_segment(xyz, cfg.segmentation)
        dev_n = np.asarray(fr.seg.planes.normal)
        for k, plane in enumerate(oseg.planes):
            if plane is not None:
                normals_out.append(float(np.max(np.abs(dev_n[k]
                                                       - plane[0]))))
        print(f"  frame {i}: {n} points, ground IoU {iou:.6f}, cluster F1 "
              f"{f1:.6f}, {exact.num_clusters} clusters, "
              f"{len(exact.outlines)} outlines")
    return (f"{len(paths)} frames: ground IoU min {min(ious):.6f}, cluster "
            f"F1 min {min(f1s):.6f}, {identical}/{len(paths)} frames "
            f"bit-identical to the oracle, zero overflow")


def phase_min_d2(seed: int) -> str:
    import jax
    import jax.numpy as jnp

    from lidar_processing.ops import stixel as sx

    rng = np.random.default_rng(seed)
    fn = jax.jit(sx.min_d2_planar)
    worst = 0
    for u_cap, v_cap, slots in sx._TIERS_INTRA + sx._TIERS_SNP:
        wu, wv = u_cap + 8, v_cap + 32
        u = rng.uniform(-30, 30, (slots, wu, 3)).astype(np.float32)
        v = rng.uniform(-30, 30, (slots, wv, 3)).astype(np.float32)
        for q in range(0, slots, 7):          # masked lane suffixes
            u[q, wu - (q % wu):] = 1.0e9
            v[q, wv - (q % wv):] = -1.0e9
        got = np.asarray(fn(*(jnp.asarray(u[..., a]) for a in range(3)),
                            *(jnp.asarray(v[..., a]) for a in range(3))))
        want = np.empty(slots)
        for s in range(0, slots, 32):
            d = (u[s:s + 32, :, None, :].astype(np.float64)
                 - v[s:s + 32, None, :, :].astype(np.float64))
            want[s:s + 32] = np.min(np.sum(d * d, -1), axis=(1, 2))
        ulp = np.abs(got.view(np.int32)
                     - want.astype(np.float32).view(np.int32))
        worst = max(worst, int(ulp.max()))
        check(ulp.max() <= 4, f"tier ({u_cap},{v_cap},{slots}): "
              f"{int(ulp.max())} ULP from float64")
    n = len(sx._TIERS_INTRA) + len(sx._TIERS_SNP)
    return f"{n} tiers at full slot counts, worst {worst} ULP from float64"


def phase_cc(cfg, paths, seed: int) -> str:
    import jax
    import jax.numpy as jnp

    from lidar_processing.io.dataset import load_frame
    from lidar_processing.ops import components, hull_native
    from lidar_processing.ops import stixel as sx
    from lidar_processing.ops.segmentation import gpf_segment
    from lidar_processing.types import SEG_OBSTACLE, pad_cloud

    s_cap = cfg.pipeline.max_supernodes

    @jax.jit
    def frame_edges(xyz, mask):
        seg = gpf_segment(xyz, mask, cfg.segmentation)
        obst = mask & (seg.labels == SEG_OBSTACLE)
        _, dbg = sx._cluster_impl(xyz, obst, cfg.clustering, cfg.pipeline)
        return (dbg["e_u"], dbg["e_v"], dbg["n_edges"], dbg["labels"],
                dbg["cc_rounds"])

    rounds = []
    for i, p in enumerate(paths):
        xyz, _ = load_frame(p)
        pc = pad_cloud(xyz, None, cfg.pipeline.max_points)
        eu, ev, ne, labels, r = (np.asarray(a)
                                 for a in frame_edges(pc.xyz, pc.mask))
        ne = int(ne)
        want = hull_native.union_find_cc(eu[:ne], ev[:ne], s_cap)
        check(np.array_equal(labels, want),
              f"frame {i}: CC labels differ from host union-find")
        rounds.append((ne, int(r)))

    cc_fn = jax.jit(components.cc_labels, static_argnums=3)
    rng = np.random.default_rng(seed)
    e_cap = cfg.pipeline.max_edges
    for g in range(3):
        # one long chain through a random node order, the rest random
        chain = rng.permutation(s_cap)[: s_cap // (g + 1)]
        n_rand = e_cap - (chain.size - 1)
        eu = np.concatenate([chain[:-1], rng.integers(0, s_cap, n_rand)])
        ev = np.concatenate([chain[1:], rng.integers(0, s_cap, n_rand)])
        labels, r, ok = cc_fn(jnp.asarray(eu, jnp.int32),
                              jnp.asarray(ev, jnp.int32),
                              jnp.int32(e_cap), s_cap)
        check(bool(ok), f"random graph {g}: not converged in {int(r)}")
        want = hull_native.union_find_cc(eu, ev, s_cap)
        check(np.array_equal(np.asarray(labels), want),
              f"random graph {g}: CC labels differ from host union-find")
        rounds.append((e_cap, int(r)))
    return ("frames' supernode graphs and 3 random graphs (s_cap "
            f"{s_cap}, {e_cap} edges, long chains) equal the host "
            f"union-find; (edges, loop rounds): {rounds}")


def phase_gpf_normals(normals: list) -> str:
    """Plane normals collected in phase c against the float64 oracle."""
    check(normals, "no fitted plane to compare")
    worst = max(normals)
    check(worst <= 1e-5, f"plane normals {worst} from the float64 oracle")
    return (f"{len(normals)} planes, max |dn| {worst:.3e} "
            "(products at Precision.HIGHEST)")


# ----------------------------------------------------- multi-device path --

def phase_multi_gpu(cfg, paths) -> str:
    import math

    import jax
    import jax.numpy as jnp

    from lidar_processing.io.dataset import load_frame
    from lidar_processing.ops import stixel as sx
    from lidar_processing.parallel.frame_spatial import (
        device_frame_step_spatial)
    from lidar_processing.parallel.sharded import (
        make_mesh, make_mesh_2d, sharded_batch_step, sharded_pipeline_2d)
    from lidar_processing.parallel.spatial import cluster_spatial
    from lidar_processing.runtime.pipeline import device_frame_step
    from lidar_processing.types import SEG_OBSTACLE, pad_cloud

    check(len(jax.devices()) >= 4, f"{len(jax.devices())} GPUs, need 4")
    cap = cfg.pipeline.max_points
    clouds = [pad_cloud(load_frame(p)[0], None, cap) for p in paths[:4]]
    xyzs = jnp.stack([c.xyz for c in clouds])
    masks = jnp.stack([c.mask for c in clouds])
    single = jax.jit(lambda x, m: device_frame_step(x, m, cfg))
    refs = [single(xyzs[i], masks[i]) for i in range(4)]
    notes = []

    # data = 4: one frame per card
    mesh = make_mesh(4)
    t0 = time.perf_counter()
    out = jax.block_until_ready(sharded_batch_step(mesh, xyzs, masks, cfg))
    notes.append(f"data=4 step {time.perf_counter() - t0:.1f} s cold")
    for i, ref in enumerate(refs):
        n_real = int(masks[i].sum())
        diff = int(np.sum(np.asarray(out.seg.labels[i])
                          != np.asarray(ref.seg.labels)))
        check(diff <= max(2, n_real // 1000),
              f"data=4 frame {i}: {diff} seg labels differ")
    obst = jnp.stack([m & (r.seg.labels == SEG_OBSTACLE)
                      for m, r in zip(masks, refs)])
    from jax.sharding import NamedSharding, PartitionSpec as P

    @jax.jit
    def sharded_cluster(xyzs, obst):
        sh = NamedSharding(mesh, P("data"))
        xyzs = jax.lax.with_sharding_constraint(xyzs, sh)
        obst = jax.lax.with_sharding_constraint(obst, sh)
        return jax.vmap(lambda x, o: sx.cluster(
            x, o, cfg.clustering, cfg.pipeline))(xyzs, obst)

    with mesh:
        cl = sharded_cluster(xyzs, obst)
    for i in range(4):
        ref_cl = sx.cluster(xyzs[i], obst[i], cfg.clustering, cfg.pipeline)
        check(np.array_equal(np.asarray(cl.labels[i]),
                             np.asarray(ref_cl.labels)),
              f"data=4 frame {i}: cluster labels differ from one card")
        check(int(cl.overflow[i]) == 0, f"data=4 frame {i}: overflow")
    notes.append("data=4 clustering bit-identical, seg within 0.1%")

    # space = 4: one frame's x-bands over four cards
    smesh = make_mesh(4, axis_name="space")
    obst0 = obst[0]
    sp = cluster_spatial(smesh, xyzs[0], obst0, cfg.clustering,
                         cfg.pipeline, cfg.spatial)
    ref0 = sx.cluster(xyzs[0], obst0, cfg.clustering, cfg.pipeline)
    check(np.array_equal(np.asarray(sp.labels), np.asarray(ref0.labels)),
          "space=4 cluster labels differ from one card")
    check(int(sp.overflow) == 0, f"space=4 overflow {int(sp.overflow)}")
    fr = device_frame_step_spatial(smesh, xyzs[0], masks[0], cfg)
    n0 = int(masks[0].sum())
    diff = int(np.sum(np.asarray(fr.seg.labels) != np.asarray(
        refs[0].seg.labels)))
    check(diff <= max(2, n0 // 1000), f"space=4 GPF: {diff} labels differ")
    obst_sp = masks[0] & (fr.seg.labels == SEG_OBSTACLE)
    ref_sp = sx.cluster(xyzs[0], obst_sp, cfg.clustering, cfg.pipeline)
    check(np.array_equal(np.asarray(fr.clustering.labels),
                         np.asarray(ref_sp.labels)),
          "space=4 full step: cluster labels differ from one card")
    check(int(fr.clustering.overflow) == 0 and int(fr.hull_overflow) == 0,
          "space=4 full step: overflow")
    notes.append(f"space=4 labels bit-identical "
                 f"({int(sp.num_clusters)} clusters), full spatial step "
                 f"seg diff {diff}")

    # 2 x 2: frames over 'data', x-bands over 'space'
    mesh2 = make_mesh_2d(2, 2)
    seg2, cl2 = sharded_pipeline_2d(mesh2, xyzs[:2], masks[:2], cfg)
    for f in range(2):
        obst_f = masks[f] & (seg2.labels[f] == SEG_OBSTACLE)
        ref2 = sx.cluster(xyzs[f], obst_f, cfg.clustering, cfg.pipeline)
        check(np.array_equal(np.asarray(cl2.labels[f]),
                             np.asarray(ref2.labels)),
              f"2x2 frame {f}: labels differ from one card")
        check(int(cl2.overflow[f]) == 0, f"2x2 frame {f}: overflow")
    notes.append("2x2 mesh bit-identical")
    return "; ".join(notes)


# ------------------------------------------------------------------ main --

def run(args) -> dict:
    from lidar_processing.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax

    from lidar_processing.config import DEFAULT_CONFIG
    from lidar_processing.io.dataset import list_frames

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        try:
            msg = fn(*a)
        except PhaseError as e:
            print(f"phase {name}: FAILED: {e}", flush=True)
            raise SystemExit(1)
        print(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s): {msg}",
              flush=True)

    phase("a device", phase_device)
    card = card_info()
    print(f"card: {card}")
    cfg = DEFAULT_CONFIG
    n_files = max(args.frames, 4)
    paths = list_frames(scene_dir(args.seed, n_files))
    if args.multi_gpu:
        phase("multi-gpu", phase_multi_gpu, cfg, paths)
    else:
        normals: list = []
        phase("b normal path", phase_normal_path, cfg,
              os.path.dirname(paths[0]), args.stream_frames, card)
        phase("c oracle", phase_oracle, cfg, paths[:3], normals)
        phase("d min-d2", phase_min_d2, args.seed)
        phase("d connected components", phase_cc, cfg, paths[:3],
              args.seed)
        phase("d GPF normals", phase_gpf_normals, normals)
    dev = jax.devices()[0]
    return {"ok": True, "device": {"platform": dev.platform,
                                   "kind": dev.device_kind,
                                   "count": len(jax.devices())}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8,
                    help="seeded frames written and replayed")
    ap.add_argument("--stream-frames", type=int, default=16,
                    help="frames pushed through ReplayStream")
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)
    result = run(args)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
