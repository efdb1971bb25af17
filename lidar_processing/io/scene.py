"""Seeded street scenes scanned by a spinning 64-beam lidar.

A stand-in for recorded KITTI frames (Geiger et al., IJRR 2013) that any
machine can make from a seed: the same sensor geometry (64 beams from +2 deg
to -24.8 deg, ~2,000 azimuth steps per turn, mounted 1.73 m above the road,
120 m maximum range) cast against a procedurally built street. A frame has
98k-124k returns, of which a fifth to a third are obstacles (walls, parked
and moving vehicles, poles, trees, hedges, fences and small clutter) that
form 200-360 clusters, within the pipeline's static caps.

    xyz, intensity = scan(seed)                  # one frame
    paths = write_scenes("scenes", 8, seed=0)    # 8 .pcd frames on disk

The frames are ordinary binary PCD files (io/pcd.py), so every reader of
recorded data (ReplayStream, the CLI, the tools) takes them unchanged.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Tuple

import numpy as np

from .pcd import write_pcd_xyzi

SENSOR_HEIGHT_M = 1.73      # config.SegmentationConfig.sensor_height_m
AZIMUTH_STEPS = 2000
MAX_RANGE_M = 120.0
MIN_RANGE_M = 2.0
RANGE_NOISE_M = 0.015
DROPOUT = 0.03


def beam_elevations() -> np.ndarray:
    """(64,) beam elevations in radians: an upper block of 32 beams at 1/3
    deg spacing from +2 deg and a lower block of 32 down to -24.8 deg (the
    two-block layout of a 64-beam spinning sensor)."""
    upper = np.linspace(2.0, 2.0 - 31.0 / 3.0, 32)
    lower = np.linspace(-8.83, -24.8, 32)
    return np.deg2rad(np.concatenate([upper, lower]))


# surface kinds (for the intensity model and the per-kind noise)
_GROUND, _HARD, _VEG = 0, 1, 2


class _Box(NamedTuple):
    c: np.ndarray       # (3,) centre
    h: np.ndarray       # (3,) half extents
    yaw: float
    kind: int


class _Cyl(NamedTuple):
    c: np.ndarray       # (2,) axis position
    r: float
    z0: float
    z1: float
    kind: int


class _Ell(NamedTuple):
    c: np.ndarray       # (3,) centre
    r: np.ndarray       # (3,) radii
    kind: int


class _Street(NamedTuple):
    y_c: float          # road centre line
    half: float         # road half width
    slope: Tuple[float, float]
    curb: float         # sidewalk height above the road
    objects: list


def _ground_z(st: _Street, x, y):
    return -SENSOR_HEIGHT_M + st.slope[0] * x + st.slope[1] * y


def _build_street(rng: np.random.Generator) -> _Street:
    y_c = rng.uniform(-1.5, 1.5)
    half = rng.uniform(4.5, 7.0)
    slope = (rng.uniform(-0.02, 0.02), rng.uniform(-0.01, 0.01))
    curb = rng.uniform(0.10, 0.16)
    walk = rng.uniform(2.0, 4.0)
    st = _Street(y_c, half, slope, curb, [])
    objs = st.objects

    def base(x, y, on_walk):
        return _ground_z(st, x, y) + (curb if on_walk else 0.0)

    for side in (-1.0, 1.0):
        edge = y_c + side * half                  # curb line
        # building facades with gaps and open lots
        x = rng.uniform(-80.0, -65.0)
        while x < 75.0:
            length = rng.uniform(8.0, 30.0)
            # no facade faces the sensor from beyond 60 m: there the beams
            # are so far apart that a tall face splits into a stack of
            # single-beam pieces per column
            near_end = min(abs(x), abs(x + length)) if x * (x + length) > 0 \
                else 0.0
            if rng.uniform() > 0.6 and near_end < 60.0:
                setback = rng.uniform(3.0, 15.0)
                depth = rng.uniform(8.0, 14.0)
                height = rng.uniform(4.0, 15.0)
                yf = edge + side * (walk + setback)
                cy = yf + side * depth / 2
                cx = x + length / 2
                z0 = base(cx, yf, True)
                objs.append(_Box(np.array([cx, cy, z0 + height / 2]),
                                 np.array([length / 2, depth / 2,
                                           height / 2]),
                                 rng.uniform(-0.04, 0.04), _HARD))
                # bushes along the facade
                for _ in range(rng.integers(1, 6)):
                    bx = rng.uniform(x, x + length)
                    by = yf - side * rng.uniform(0.5, 1.5)
                    r = rng.uniform([0.3, 0.3, 0.3], [1.2, 1.0, 0.9])
                    objs.append(_Ell(np.array([bx, by, base(bx, by, True)
                                               + r[2] * 0.8]), r, _VEG))
            x += length + rng.uniform(2.0, 10.0)
        # parked cars along the curb
        x = rng.uniform(-70.0, -60.0)
        while x < 70.0:
            if rng.uniform() < 0.4 and abs(x) > 5.0:
                half_l = rng.uniform(1.9, 2.4)
                half_w = rng.uniform(0.8, 0.95)
                height = rng.uniform(1.4, 1.7)
                cy = edge - side * (half_w + rng.uniform(0.2, 0.5))
                z0 = base(x, cy, False) + 0.2
                objs.append(_Box(np.array([x, cy, z0 + height / 2]),
                                 np.array([half_l, half_w, height / 2]),
                                 rng.uniform(-0.1, 0.1), _HARD))
            x += rng.uniform(5.5, 9.0)
        # poles and trees on the sidewalk
        x = rng.uniform(-60.0, -45.0)
        while x < 60.0:
            py = edge + side * rng.uniform(0.4, walk - 0.3)
            z0 = base(x, py, True)
            if rng.uniform() < 0.5:
                objs.append(_Cyl(np.array([x, py]), rng.uniform(0.08, 0.2),
                                 z0, z0 + rng.uniform(3.0, 9.0), _HARD))
            else:
                trunk = rng.uniform(1.2, 2.2)
                objs.append(_Cyl(np.array([x, py]), rng.uniform(0.15, 0.3),
                                 z0, z0 + trunk + 0.5, _HARD))
                r = rng.uniform([1.2, 1.2, 1.0], [2.5, 2.5, 2.0])
                objs.append(_Ell(np.array([x, py, z0 + trunk + r[2]]), r,
                                 _VEG))
            x += rng.uniform(8.0, 22.0)
        # hedges along the lots
        for _ in range(rng.integers(3, 9)):
            hx = rng.uniform(-60.0, 60.0)
            hy = edge + side * rng.uniform(walk + 0.5, walk + 12.0)
            r = rng.uniform([2.0, 0.4, 0.5], [6.0, 0.8, 1.0])
            objs.append(_Ell(np.array([hx, hy, base(hx, hy, True) + r[2]]),
                             r, _VEG))
        # fences: rows of thin posts, each post its own small cluster
        for _ in range(rng.integers(2, 5)):
            x = rng.uniform(-50.0, 40.0)
            x_end = x + rng.uniform(10.0, 30.0)
            py = edge + side * rng.uniform(walk, walk + 2.0)
            gap = rng.uniform(1.0, 2.5)
            while x < x_end:
                z0 = base(x, py, True)
                objs.append(_Cyl(np.array([x, py]), rng.uniform(0.05, 0.08),
                                 z0, z0 + rng.uniform(0.8, 1.3), _HARD))
                x += gap
        # pedestrians, bins, bollards and signs on the sidewalk and in the
        # lots behind it
        for _ in range(rng.integers(120, 180)):
            px = rng.uniform(-70.0, 70.0)
            py = edge + side * rng.uniform(0.3, walk + 4.0)
            z0 = base(px, py, True)
            u = rng.uniform()
            if u < 0.3:
                r = rng.uniform([0.2, 0.2, 0.2], [0.8, 0.8, 0.6])
                objs.append(_Ell(np.array([px, py, z0 + r[2] * 0.7]), r,
                                 _VEG))
            elif u < 0.65:
                objs.append(_Cyl(np.array([px, py]), rng.uniform(0.2, 0.3),
                                 z0, z0 + rng.uniform(1.5, 1.9), _HARD))
            else:
                hh = rng.uniform([0.2, 0.2, 0.3], [0.5, 0.5, 0.6])
                objs.append(_Box(np.array([px, py, z0 + hh[2]]), hh,
                                 rng.uniform(-np.pi, np.pi), _HARD))
    # distant structures seen through the gaps: at these ranges the beams
    # are further apart than the clustering radius, so each beam's sweep
    # across one is a cluster of its own
    for _ in range(rng.integers(60, 90)):
        ang = rng.uniform(-np.pi, np.pi)
        dist = rng.uniform(60.0, 115.0)
        cx, cy = dist * np.cos(ang), dist * np.sin(ang)
        hh = rng.uniform([0.5, 0.5, 0.3], [4.0, 4.0, 1.5])
        c = np.array([cx, cy, _ground_z(st, cx, cy) + hh[2]])
        if rng.uniform() < 0.3:
            objs.append(_Ell(c, hh, _VEG))
        else:
            objs.append(_Box(c, hh, rng.uniform(-np.pi, np.pi), _HARD))
    # moving traffic in the lanes
    for _ in range(rng.integers(3, 9)):
        cx = rng.uniform(-70.0, 70.0)
        if abs(cx) < 6.0:
            continue
        cy = y_c + rng.uniform(-half + 1.2, half - 1.2)
        half_l, half_w = rng.uniform(1.9, 2.5), rng.uniform(0.8, 1.0)
        height = rng.uniform(1.4, 2.0)
        z0 = _ground_z(st, cx, cy) + 0.2
        objs.append(_Box(np.array([cx, cy, z0 + height / 2]),
                         np.array([half_l, half_w, height / 2]),
                         rng.uniform(-0.08, 0.08), _HARD))
    return st


def _hit_ground(st: _Street, d: np.ndarray) -> np.ndarray:
    """Range to the road, curb face or raised sidewalk along unit rays d."""
    a, b = st.slope
    den = d[..., 2] - a * d[..., 0] - b * d[..., 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_road = np.where(den < -1e-6, -SENSOR_HEIGHT_M / den, np.inf)
        t_walk = np.where(den < -1e-6, (st.curb - SENSOR_HEIGHT_M) / den,
                          np.inf)
        off_road = np.abs(t_walk * d[..., 1] - st.y_c) >= st.half
        on_road = np.abs(t_road * d[..., 1] - st.y_c) <= st.half
        # rays that cross the curb line between the two planes hit its face
        t_curb = (st.y_c + np.sign(d[..., 1]) * st.half) / d[..., 1]
    return np.where(off_road, t_walk, np.where(on_road, t_road, t_curb))


def _hit_box(o: _Box, d: np.ndarray) -> np.ndarray:
    cs, sn = np.cos(o.yaw), np.sin(o.yaw)
    # ray origin and direction in the box frame (rotation by -yaw)
    org = np.array([-(cs * o.c[0] + sn * o.c[1]),
                    -(-sn * o.c[0] + cs * o.c[1]), -o.c[2]])
    dl = np.stack([cs * d[..., 0] + sn * d[..., 1],
                   -sn * d[..., 0] + cs * d[..., 1], d[..., 2]], -1)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-o.h - org) / dl
        t2 = (o.h - org) / dl
    t_near = np.nanmax(np.minimum(t1, t2), axis=-1)
    t_far = np.nanmin(np.maximum(t1, t2), axis=-1)
    hit = (t_far >= t_near) & (t_near > 0)
    return np.where(hit, t_near, np.inf)


def _hit_cyl(o: _Cyl, d: np.ndarray) -> np.ndarray:
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = -2.0 * (dx * o.c[0] + dy * o.c[1])
    c = o.c[0] ** 2 + o.c[1] ** 2 - o.r ** 2
    disc = b * b - 4 * a * c
    with np.errstate(invalid="ignore", divide="ignore"):
        t = (-b - np.sqrt(disc)) / (2 * a)
    z = t * d[..., 2]
    hit = (disc >= 0) & (t > 0) & (z >= o.z0) & (z <= o.z1)
    return np.where(hit, t, np.inf)


def _hit_ell(o: _Ell, d: np.ndarray) -> np.ndarray:
    dl = d / o.r
    org = -o.c / o.r
    a = np.sum(dl * dl, -1)
    b = 2.0 * np.sum(dl * org, -1)
    c = np.sum(org * org) - 1.0
    disc = b * b - 4 * a * c
    with np.errstate(invalid="ignore"):
        t = (-b - np.sqrt(disc)) / (2 * a)
    return np.where((disc >= 0) & (t > 0), t, np.inf)


def _footprint(o) -> Tuple[np.ndarray, float]:
    """xy centre and bounding radius of an object."""
    if isinstance(o, _Box):
        return o.c[:2], float(np.hypot(o.h[0], o.h[1]))
    if isinstance(o, _Cyl):
        return o.c, o.r
    return o.c[:2], float(max(o.r[0], o.r[1]))


_HIT = {_Box: _hit_box, _Cyl: _hit_cyl, _Ell: _hit_ell}


def scan(seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """One seeded frame: (n, 3) float32 xyz and (n,) float32 intensity, in
    scan order (azimuth-major, 64 beams per azimuth step)."""
    rng = np.random.default_rng(seed)
    st = _build_street(rng)
    elev = beam_elevations()
    az = (np.arange(AZIMUTH_STEPS) + rng.uniform()) * (
        2 * np.pi / AZIMUTH_STEPS)
    # (A, 64, 3) unit rays
    ce, se = np.cos(elev), np.sin(elev)
    d = np.stack([np.cos(az)[:, None] * ce[None, :],
                  np.sin(az)[:, None] * ce[None, :],
                  np.broadcast_to(se[None, :], (AZIMUTH_STEPS, 64))], -1)

    t = _hit_ground(st, d)
    kind = np.full(t.shape, _GROUND, np.int8)
    step = 2 * np.pi / AZIMUTH_STEPS
    for o in st.objects:
        cxy, rb = _footprint(o)
        dist = float(np.hypot(*cxy))
        if dist <= rb + 0.5:
            continue                           # would enclose the sensor
        half = np.arcsin(rb / dist) + step
        mid = np.arctan2(cxy[1], cxy[0])
        lo = int(np.floor((mid - half) / step))
        hi = int(np.ceil((mid + half) / step))
        idx = np.arange(lo, hi + 1) % AZIMUTH_STEPS
        th = _HIT[type(o)](o, d[idx])
        closer = th < t[idx]
        t[idx] = np.where(closer, th, t[idx])
        kind[idx] = np.where(closer, o.kind, kind[idx])

    noise = rng.normal(0.0, RANGE_NOISE_M, t.shape)
    noise = np.where(kind == _VEG, rng.normal(0.0, 0.12, t.shape), noise)
    r = t + noise
    keep = (np.isfinite(t) & (t <= MAX_RANGE_M) & (r >= MIN_RANGE_M)
            & (rng.uniform(size=t.shape) >= DROPOUT)
            # foliage is porous: half of its rays pass through unseen
            & ~((kind == _VEG) & (rng.uniform(size=t.shape) < 0.5)))
    xyz = (d[keep] * r[keep][:, None]).astype(np.float32)
    base = np.array([0.25, 0.45, 0.15], np.float32)[kind[keep]]
    inten = np.clip(base + rng.normal(0, 0.08, base.shape), 0.0, 1.0)
    return xyz, inten.astype(np.float32)


def frame_seed(seed: int, index: int) -> int:
    """Seed of frame `index` in the sequence generated from `seed`."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def write_scenes(data_dir: str, num_frames: int, seed: int = 0) -> List[str]:
    """Write frames 0..num_frames-1 of seed `seed` as .pcd files named like
    a KITTI sequence; returns their paths in order."""
    os.makedirs(data_dir, exist_ok=True)
    paths = []
    for i in range(num_frames):
        xyz, inten = scan(frame_seed(seed, i))
        p = os.path.join(data_dir, f"{i:010d}.pcd")
        write_pcd_xyzi(p, xyz, inten)
        paths.append(p)
    return paths
