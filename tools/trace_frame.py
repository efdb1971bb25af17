"""Device-time breakdown of the frame step by layer, from a profiler trace.

    python tools/trace_frame.py [--seed 0] [--frames 8] [--out traces]

Compiles device_frame_step_packed, warms it on seeded full-size frames,
then traces one window of `frames` steps and reduces the device events:
busy time (union of kernel intervals), idle share of the window, and device
time per named scope of the step (gpf, clustering with its
exact_pair_min_d2 and connected_components parts, hulls). An event's scope
comes from the op_name metadata of its HLO instruction in the compiled
program. Writes the reduction as JSON next to the trace.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SCOPES = ("connected_components", "exact_pair_min_d2", "gpf", "clustering",
          "hulls")


def hlo_scopes(hlo_text: str) -> dict:
    """kernel name -> op_name metadata, from optimized HLO text. A GPU
    kernel is named after its HLO instruction with '.' replaced by '_'."""
    out = {}
    for m in re.finditer(r"%?([\w.\-]+) = [^\n]*?op_name=\"([^\"]*)\"",
                         hlo_text):
        out[m.group(1).replace(".", "_").replace("-", "_")] = m.group(2)
    return out


def op_name_of(kernel: str, names: dict) -> str:
    """op_name of a kernel; sorts emit several kernels per instruction
    (sort_260_1, ...), so a trailing index is dropped on a miss."""
    if kernel in names:
        return names[kernel]
    base = re.sub(r"_\d+$", "", kernel)
    if base in names:
        return names[base]
    if "gemm" in kernel:
        return "library:gemm"
    if "RadixSort" in kernel or "cub::" in kernel:
        return "library:cub_sort"
    if kernel.startswith("memcpy") or kernel.startswith("Memcpy"):
        return "library:memcpy"
    return ""


def scope_of(op_name: str) -> str:
    if op_name.startswith("library:"):
        return op_name
    for s in SCOPES:
        if f"/{s}/" in f"/{op_name}/":
            return s
    return "other"


def reduce_trace(path: str, names: dict, n_frames: int) -> dict:
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    events = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                events.append((ev.start_ns, ev.end_ns, ev.name))
    if not events:
        raise SystemExit("no device events in the trace")
    events.sort()
    busy, cur_s, cur_e = 0, None, None
    for s, e, *_ in events:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = events[-1][1] - events[0][0]
    per_scope = collections.Counter()
    per_kernel = collections.Counter()
    unmatched = 0
    for s, e, name in events:
        op_name = op_name_of(name, names)
        if not op_name:
            unmatched += 1
        sc = scope_of(op_name)
        per_scope[sc] += e - s
        per_kernel[(name, sc)] += e - s
    f = 1e-6 / n_frames
    return {
        "device_events": len(events),
        "events_without_op_name": unmatched,
        "window_ms_per_frame": window * f,
        "busy_ms_per_frame": busy * f,
        "idle_share": 1.0 - busy / window,
        "ms_per_frame_by_scope": {k: v * f for k, v in per_scope.items()},
        "top_kernels_ms_per_frame": [
            (n, sc, t * f) for (n, sc), t in per_kernel.most_common(25)],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--out", default="traces")
    args = ap.parse_args()

    import jax

    from lidar_processing.config import DEFAULT_CONFIG as cfg
    from lidar_processing.io.scene import frame_seed, scan
    from lidar_processing.runtime.pipeline import device_frame_step_packed
    from lidar_processing.types import pad_cloud

    clouds = [pad_cloud(scan(frame_seed(args.seed, i))[0], None,
                        cfg.pipeline.max_points) for i in range(args.frames)]
    step = jax.jit(lambda x, m: device_frame_step_packed(x, m, cfg))
    compiled = step.lower(clouds[0].xyz, clouds[0].mask).compile()
    hlo = compiled.as_text()
    names = hlo_scopes(hlo)
    for c in clouds:                                   # warm every frame
        jax.block_until_ready(compiled(c.xyz, c.mask))
    t0 = time.perf_counter()
    for c in clouds:
        out = compiled(c.xyz, c.mask)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / args.frames * 1e3

    tdir = os.path.join(args.out, f"trace_{int(time.time())}")
    with jax.profiler.trace(tdir):
        for c in clouds:
            out = compiled(c.xyz, c.mask)
        jax.block_until_ready(out)
    path = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    res = reduce_trace(path, names, args.frames)
    res["untraced_wall_ms_per_frame"] = wall
    res["device"] = jax.devices()[0].device_kind
    with open(os.path.join(tdir, "step.hlo.txt"), "w") as f:
        f.write(hlo)
    with open(os.path.join(tdir, "breakdown.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
