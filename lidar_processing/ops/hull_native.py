"""Host hull operations with native (C++) acceleration.

Dispatches to the C++ module in native/ (liblidar_native.so, loaded via
ctypes), which is compiled from the committed source on first use; falls
back to the scipy/numpy oracle implementations when no compiler is found.
The native module mirrors the role of the reference's Convex-Hull /
Concave-Hull C++ submodules (ref: CMakeLists.txt:24-25,66-67).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SRC = os.path.join(_NATIVE_DIR, "lidar_native.cpp")
_LIB_PATH = os.path.join(_NATIVE_DIR, "liblidar_native.so")
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-march=native",
             "-Wall"]

_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False


def build() -> bool:
    """Compile liblidar_native.so from lidar_native.cpp unless an up-to-date
    build exists. Compiles to a per-process temporary name and renames it
    into place atomically, so concurrent processes (test workers) never
    load a half-written library. Returns whether the library exists."""
    if (os.path.exists(_LIB_PATH)
            and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
        return True
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", tmp,
                        _SRC], check=True, capture_output=True, timeout=600)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
    return os.path.exists(_LIB_PATH)


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if not build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        lib.chi_concave_hull.restype = ctypes.c_int32
        lib.chi_concave_hull.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_double,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.convex_hull.restype = ctypes.c_int32
        lib.convex_hull.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.chan_convex_hull.restype = ctypes.c_int32
        lib.chan_convex_hull.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.union_find_cc.restype = None
        lib.union_find_cc.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
        ]
        lib.radius_cc.restype = ctypes.c_int32
        lib.radius_cc.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.chi_hulls_batch.restype = None
        lib.chi_hulls_batch.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int32, ctypes.c_double, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ]
        lib.fec_cluster.restype = ctypes.c_int32
        lib.fec_cluster.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_double,
            ctypes.c_double, ctypes.c_uint32, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _LIB = lib
    except (OSError, AttributeError):     # unloadable, or a symbol missing
        _LIB = None
    return _LIB


def native_available() -> bool:
    return _load() is not None


def convex_hull_indices(points: np.ndarray,
                        algorithm: str = "monotone") -> np.ndarray:
    """CCW strictly-convex hull indices (native if available).

    algorithm: "monotone" (Andrew chain) or "chan" (Chan's grouped march —
    the reference routes >1000-point clusters to Chan,
    ref: src/polygon_simplification.cpp:53-63). Both produce identical
    hulls; the Python fallback is always the monotone-chain oracle.
    """
    lib = _load()
    pts = np.ascontiguousarray(points[:, :2], np.float32)
    n = pts.shape[0]
    if lib is not None and n >= 1:
        out = np.empty(n + 1, np.int32)
        fn = lib.chan_convex_hull if algorithm == "chan" else lib.convex_hull
        k = fn(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.shape[0])
        if k >= 0:
            return out[:k].astype(np.int64)
    from ..oracle.reference import convex_hull_indices as _py
    return _py(points)


def union_find_cc(edges_u: np.ndarray, edges_v: np.ndarray,
                  n_nodes: int) -> np.ndarray:
    """Connected-component labels (min node id per component) over edges.

    Native when available, else a numpy/scipy path.
    """
    lib = _load()
    u = np.ascontiguousarray(edges_u, np.int32)
    v = np.ascontiguousarray(edges_v, np.int32)
    if lib is not None:
        out = np.empty(n_nodes, np.int32)
        lib.union_find_cc(
            u.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            np.int64(u.size), np.int32(n_nodes),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    import scipy.sparse as sp
    import scipy.sparse.csgraph as csgraph
    g = sp.coo_matrix((np.ones(u.size, np.int8), (u, v)),
                      shape=(n_nodes, n_nodes))
    n_comp, comp = csgraph.connected_components(g, directed=False)
    mins = np.full(max(n_comp, 1), np.iinfo(np.int64).max, np.int64)
    np.minimum.at(mins, comp, np.arange(n_nodes))
    return mins[comp].astype(np.int32)


def fec_cluster(points: np.ndarray, distance_squared: float,
                cluster_quality: float, min_size: int,
                max_size: int) -> np.ndarray | None:
    """Native faithful serial FEC (ref: src/clustering.cpp:47-125).

    Bit-identical to oracle.reference.fec_cluster; returns None when the
    native module is unavailable (caller falls back to the Python oracle).
    """
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    n = pts.shape[0]
    out = np.empty(n, np.int32)
    lib.fec_cluster(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), np.int32(n),
        ctypes.c_double(distance_squared), ctypes.c_double(cluster_quality),
        ctypes.c_uint32(min_size),
        ctypes.c_uint32(min(max_size, 2**32 - 1)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def radius_cc(points: np.ndarray, radius: float) -> np.ndarray:
    """Exact radius-graph CC labels (min point index per component)."""
    lib = _load()
    pts = np.ascontiguousarray(points[:, :3], np.float32)
    n = pts.shape[0]
    if n == 0:
        return np.empty(0, np.int32)
    if lib is not None:
        out = np.empty(n, np.int32)
        lib.radius_cc(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            np.int32(n), np.float32(radius),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    from ..oracle.reference import radius_cc_cluster  # slow fallback
    from ..config import ClusteringConfig
    return radius_cc_cluster(
        pts, ClusteringConfig(distance_squared=radius * radius,
                              min_cluster_size=1))


def chi_hulls_batch(packed_xy: np.ndarray, offsets: np.ndarray,
                    chi: float, n_threads: int = 0):
    """Batched ordered chi-shape outlines for many clusters in ONE native
    call (internal thread pool; pass clusters largest-first).

    packed_xy: (P, 2) f32 concatenated cluster points; offsets: (m+1,)
    int64 point offsets. Returns a list of (k_j, 2) f32 outline vertex
    arrays, or None when the native module is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    m = offsets.shape[0] - 1
    if m == 0:
        return []
    pts = np.ascontiguousarray(packed_xy, np.float32)
    offs = np.ascontiguousarray(offsets, np.int64)
    out = np.empty(pts.shape[0], np.int32)
    counts = np.empty(m, np.int32)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.chi_hulls_batch(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.int32(m), ctypes.c_double(chi),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        np.int32(n_threads))
    res = []
    for j in range(m):
        lo, hi = int(offs[j]), int(offs[j + 1])
        k = int(counts[j])
        if k < 0:
            # degenerate cluster: same fallback chain as the
            # single-cluster path (oracle chi-shape, then convex)
            res.append(chi_concave_hull(pts[lo:hi], chi))
        else:
            res.append(pts[lo:hi][out[lo:lo + k]])
    return res


def chi_concave_hull(points: np.ndarray, chi: float) -> np.ndarray:
    """Ordered chi-shape outline vertices (k,2) float32 (native if available)."""
    pts = np.ascontiguousarray(points[:, :2], np.float32)
    n = pts.shape[0]
    lib = _load()
    if lib is not None and n >= 3:
        out = np.empty(n + 1, np.int32)
        k = lib.chi_concave_hull(
            pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
            ctypes.c_double(chi),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), out.shape[0])
        if k >= 0:
            return pts[out[:k]].astype(np.float32)
        # negative => native failure (degenerate input); fall through
    from ..oracle.reference import (chi_concave_hull_indices,
                                    convex_hull_indices)
    if n < 3:
        return pts[convex_hull_indices(pts)].astype(np.float32)
    idx = chi_concave_hull_indices(pts, chi)
    return pts[idx].astype(np.float32)
