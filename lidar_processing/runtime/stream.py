"""Streaming replay runtime: the dataloader/processor node pair on device.

The reference runs two OS processes — a dataloader that preloads all frames
and republishes them cyclically at 10 Hz over DDS, and a processor that runs
the pipeline synchronously in the subscriber callback, timing each stage
(ref: src/dataloader.cpp:128-175, src/processor.cpp:135-268). Its QoS is
keep-last-2 / reliable (ref: src/processor.cpp:69-85): a slow processor
drops the oldest queued frame.

This runtime collapses the process boundary: frames are preloaded into
device memory once (260 MB for a 154-frame sequence), and the replay loop
indexes into the
resident buffer, so the steady state has zero host->device traffic. The DDS
depth-2 queue semantics are kept in realtime mode via a publication clock:
frames "publish" at replay_rate_hz regardless of consumer progress, and
only the newest `queue_depth` unconsumed publications are retained — a slow
consumer sees dropped frames (gaps, counted in FrameMetrics.frames_dropped),
not growing lag. Non-realtime mode processes every frame through a bounded
`queue_depth`-deep in-flight pipeline window.
Per-stage metrics mirror the reference's RCLCPP_INFO timing logs
(ref: src/processor.cpp:167-171,204-207,218-219).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EngineConfig
from ..io.dataset import list_frames, preload_padded
from .pipeline import device_frame_step_packed, host_outputs_packed


@dataclasses.dataclass
class FrameMetrics:
    """Per-frame observability record (ref: processor.cpp logging)."""

    frame_id: int
    t_dispatch_ms: float      # device step dispatch + completion
    t_host_ms: float          # host polygonization + readout
    ground_points: int
    obstacle_points: int
    num_clusters: int
    num_outlines: int
    overflow: int
    deadline_missed: bool     # frame exceeded the replay period
    # frames dropped immediately before this one because the in-flight
    # window was full when they were published (realtime mode only —
    # DDS QoS keep-last-`queue_depth`, ref: src/processor.cpp:69-73)
    frames_dropped: int = 0
    # per-stage device times (stage_timing=True only; mirrors the
    # reference's separate seg/cluster/polygonize logs,
    # ref: src/processor.cpp:167-168,204-205,218-219). TRIAGE-GRADE:
    # seg/cluster are separate standalone jits and t_hull is the fused
    # step's residual after subtracting them, so the split differs from
    # the fused program's true internals (which share sorts across
    # stages) — for optimization use the per-op device traces
    # (tools/trace_frame.py, PERF.md).
    t_seg_ms: Optional[float] = None
    t_cluster_ms: Optional[float] = None
    t_hull_ms: Optional[float] = None


class ReplayStream:
    """Device-resident cyclic frame replayer with a bounded in-flight window.

    Usage:
        stream = ReplayStream(config)
        for out, metrics in stream.run(num_frames=154):
            ...
    """

    def __init__(self, config: EngineConfig,
                 data_dir: Optional[str] = None,
                 device: Optional[jax.Device] = None):
        self.config = config
        paths = list_frames(data_dir) if data_dir else list_frames()
        cap = config.pipeline.max_points
        xyz, inten, counts = preload_padded(paths, cap)
        dev = device or jax.devices()[0]
        # intensity rides along on host for output passthrough
        # (ref: src/dataloader.cpp:106-110 schema carries intensity)
        self.intensity = inten
        # whole sequence resident in device memory
        self.xyz = jax.device_put(jnp.asarray(xyz), dev)
        mask = np.zeros(xyz.shape[:2], bool)
        for i, c in enumerate(counts):
            mask[i, :c] = True
        self.mask = jax.device_put(jnp.asarray(mask), dev)
        self.counts = counts
        self.num_frames = xyz.shape[0]

        cfg = self.config

        @jax.jit
        def _step(frame_idx: jnp.ndarray) -> jnp.ndarray:
            # packed single-buffer payload: ONE device->host DMA per frame
            # instead of ~20 per-leaf transfers (see pipeline.py)
            return device_frame_step_packed(self.xyz[frame_idx],
                                            self.mask[frame_idx], cfg)

        self._step = _step
        self._stage_fns = None

    def warmup(self) -> None:
        jax.block_until_ready(self._step(jnp.int32(0)))

    def _build_stage_fns(self):
        """Separate jits per stage for synchronous per-stage timing —
        the reference times each stage in its callback the same way
        (ref: src/processor.cpp:148-219)."""
        from ..ops import stixel as _stixel
        from ..ops.segmentation import gpf_segment
        from ..types import SEG_OBSTACLE
        cfg = self.config

        @jax.jit
        def _seg(frame_idx):
            xyz = self.xyz[frame_idx]
            mask = self.mask[frame_idx]
            seg = gpf_segment(xyz, mask, cfg.segmentation)
            return seg, mask & (seg.labels == SEG_OBSTACLE)

        @jax.jit
        def _cluster(frame_idx, obstacle):
            return _stixel.cluster(self.xyz[frame_idx], obstacle,
                                   cfg.clustering, cfg.pipeline)

        self._stage_fns = (_seg, _cluster)

    def run(self, num_frames: int, realtime: bool = False,
            with_outlines: bool = True, stage_timing: bool = False):
        """Yield (FrameOutputs, FrameMetrics) for `num_frames` frames.

        realtime=True paces dispatch at replay_rate_hz and flags deadline
        misses (the reference's 100 ms budget, ref: README.md:4).
        stage_timing=True times segmentation/clustering/hulls separately
        (synchronously — lower throughput, richer metrics).
        """
        period = 1.0 / self.config.pipeline.replay_rate_hz
        self.warmup()
        if stage_timing and self._stage_fns is None:
            self._build_stage_fns()
        inflight: List = []   # (fid, dispatch_time, FrameResult, stages, drops)
        depth = self.config.pipeline.queue_depth
        produced = 0
        seq = 0               # publication sequence number (cyclic fids)
        t_start = time.perf_counter()

        while produced < num_frames:
            dropped_before = 0
            if realtime:
                # publication clock: the dataloader publishes seq k at
                # t_start + k*period regardless of consumer progress
                # (ref: src/dataloader.cpp:30,80-81). With QoS
                # keep-last-`depth` (ref: src/processor.cpp:69-73), frames
                # published beyond the window while the consumer was busy
                # are DROPPED — a slow consumer sees gaps, not lag.
                now = time.perf_counter()
                published = int((now - t_start) / period) + 1
                if published <= seq:
                    time.sleep(t_start + seq * period - now)
                    published = seq + 1
                newest_kept = max(seq, published - depth)
                dropped_before = newest_kept - seq
                seq = newest_kept
            fid = seq % self.num_frames
            seq += 1
            produced += 1
            t0 = time.perf_counter()
            stages = None
            if stage_timing:
                seg_fn, cl_fn = self._stage_fns
                idx = jnp.int32(fid)
                _, obstacle = jax.block_until_ready(seg_fn(idx))
                t_seg = time.perf_counter()
                jax.block_until_ready(cl_fn(idx, obstacle))
                t_cl = time.perf_counter()
                stages = (t_seg - t0, t_cl - t_seg)
            fr = self._step(jnp.int32(fid))
            fr.copy_to_host_async()   # overlap the DMA with the window
            inflight.append((fid, t0, fr, stages, dropped_before))
            # bounded window: consume oldest once the queue is full
            while len(inflight) > depth:
                yield self._consume(inflight.pop(0), period,
                                    with_outlines)
        while inflight:
            yield self._consume(inflight.pop(0), period, with_outlines)

    def _consume(self, item, period: float, with_outlines: bool):
        fid, t0, fr, stages, dropped_before = item
        jax.block_until_ready(fr)
        t1 = time.perf_counter()
        n = int(self.counts[fid])
        inten = self.intensity[fid, :n]
        out = host_outputs_packed(fr, self.config, n, intensity=inten,
                                  with_outlines=with_outlines)
        t2 = time.perf_counter()
        seg = out.seg_labels
        t_seg = t_cl = t_hull = None
        if stages is not None:
            t_seg = stages[0] * 1e3
            t_cl = stages[1] * 1e3
            # hull stage = full-step completion minus the timed prefix
            # stages (the full step recomputes seg+cluster; its marginal
            # hull cost is the remainder of the dispatch window)
            t_hull = max(0.0, (t1 - t0) * 1e3 - t_seg - t_cl)
        metrics = FrameMetrics(
            frame_id=fid,
            t_dispatch_ms=(t1 - t0) * 1e3,
            t_host_ms=(t2 - t1) * 1e3,
            ground_points=int(np.sum(seg == 1)),
            obstacle_points=int(np.sum(seg == 2)),
            num_clusters=out.num_clusters,
            num_outlines=len(out.outlines),
            overflow=out.overflow,
            deadline_missed=(t1 - t0) > period,
            frames_dropped=dropped_before,
            t_seg_ms=t_seg, t_cluster_ms=t_cl, t_hull_ms=t_hull,
        )
        return out, metrics
