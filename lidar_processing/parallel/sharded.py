"""Multi-device execution: mesh construction + sharded pipeline steps.

The reference's only distribution is two OS processes joined by DDS pub/sub
(ref: src/processor.cpp:93-100, src/dataloader.cpp:79-81, launch.sh:12-16).
This engine replaces that with a device mesh:

  * axis 'data'  — frames sharded across devices (the DP analogue of the
    reference's frame pipelining);
  * axis 'space' — reserved for spatial grid-block sharding of very dense
    clouds across chips with halo exchange (see parallel/spatial.py).

`sharded_batch_step` runs the full per-frame device pipeline on each frame
of a batch, frames laid out over the 'data' axis via shard_map. Per-frame
work is independent (the reference processes frames independently too), so
the only collective is the implicit layout; scaling efficiency is bounded by
compilation, not communication.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import EngineConfig
from ..runtime.pipeline import FrameResult, device_frame_step


def make_mesh(n_devices: int | None = None,
              axis_name: str = "data") -> Mesh:
    """A 1-D mesh over the first n_devices of the default backend (default:
    all). Raises ValueError when the backend has fewer devices."""
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis_name,))


@functools.partial(jax.jit, static_argnames=("mesh", "config"))
def _batch_step(mesh, xyzs, masks, config):
    data_sharding = NamedSharding(mesh, P("data"))
    xyzs = jax.lax.with_sharding_constraint(xyzs, data_sharding)
    masks = jax.lax.with_sharding_constraint(masks, data_sharding)
    step = jax.vmap(lambda x, m: device_frame_step(x, m, config))
    return step(xyzs, masks)


def sharded_batch_step(mesh: Mesh, xyzs, masks,
                       config: EngineConfig) -> FrameResult:
    """Run the per-frame pipeline over a frame batch sharded on 'data'.

    xyzs: (B, N, 3) float32; masks: (B, N) bool; B must be divisible by the
    mesh size. Returns a batched FrameResult with leading axis B.
    """
    b = xyzs.shape[0]
    n_dev = mesh.devices.size
    if b % n_dev != 0:
        raise ValueError(f"batch {b} not divisible by mesh size {n_dev}")
    with mesh:
        return _batch_step(mesh, xyzs, masks, config)


def make_mesh_2d(n_data: int, n_space: int) -> Mesh:
    """A 2-D mesh over the default backend's devices: 'data' (frames) x
    'space' (in-frame x-bands). Raises ValueError when the backend has
    fewer than n_data * n_space devices."""
    devs = jax.devices()
    need = n_data * n_space
    if len(devs) < need:
        raise ValueError(f"need {need} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:need]).reshape(n_data, n_space),
                ("data", "space"))


@functools.partial(jax.jit, static_argnames=("mesh", "config"))
def _seg_step_2d(mesh, xyzs, masks, config):
    from ..ops.segmentation import gpf_segment
    from ..types import SEG_OBSTACLE
    sh = NamedSharding(mesh, P("data"))
    xyzs = jax.lax.with_sharding_constraint(xyzs, sh)
    masks = jax.lax.with_sharding_constraint(masks, sh)
    seg = jax.vmap(lambda x, m: gpf_segment(x, m, config.segmentation))(
        xyzs, masks)
    obstacle = masks & (seg.labels == SEG_OBSTACLE)
    return seg, obstacle


def sharded_pipeline_2d(mesh: Mesh, xyzs, masks, config: EngineConfig):
    """Full segment->cluster pipeline on a 2-D (data, space) mesh.

    Frames shard over 'data' (GPF is per-frame, so it stays a pure batch
    axis); each frame's clustering shards its x-bands over 'space' with
    halo exchange + label merge (parallel/spatial.py). Returns
    (SegmentationResult batched, ClusteringResult batched); clustering is
    bit-identical per frame to the single-device path given the same
    obstacle masks.
    """
    from .spatial import cluster_spatial_2d
    b = xyzs.shape[0]
    if b != mesh.shape["data"]:
        # the space-axis shard_map sees exactly one frame per data shard
        raise ValueError(
            f"batch {b} must equal the data axis size "
            f"{mesh.shape['data']} (chunk larger batches)")
    with mesh:
        seg, obstacle = _seg_step_2d(mesh, xyzs, masks, config)
        cl = cluster_spatial_2d(mesh, xyzs, obstacle, config.clustering,
                                config.pipeline, config.spatial)
    return seg, cl
