"""Exact pair min-distance (ops/stixel.py) against float64 brute force.

The tests check min_d2_planar at every tier shape the clustering pipeline
instantiates (ops/stixel.py tier tables) plus odd shapes, and
_block_min_d2 end to end: stacked-superrow window gathers from real sorted
runs, lane masking and the reduction. The only rounding allowed is float32
arithmetic on exact inputs: a few ULP of the float64 result.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lidar_processing.ops import stixel as sx


def _tier_widths():
    """(u_cap, v_cap, Wu, Wv) of every tier the pipeline can instantiate:
    the u side is fetched in 8-point superrows, the v side in one wide
    32-point-superrow window."""
    return [(u, v, u + 8, v + 32)
            for u, v, _slots in sx._TIERS_INTRA + sx._TIERS_SNP]


def _tier_shapes():
    """(P, Wu, Wv): every tier width at a small P, plus odd shapes."""
    shapes = [(min(slots, 384), u + 8, v + 32)
              for u, v, slots in sx._TIERS_INTRA + sx._TIERS_SNP]
    shapes += [(1, 64, 64), (7, 160, 160), (100, 288, 160), (9, 64, 96)]
    return shapes


def brute_min_d2(u, v):
    """float64 min over (i, j) of |u_i - v_j|², chunked over pairs."""
    out = np.empty(u.shape[0])
    for s in range(0, u.shape[0], 32):
        d = (u[s:s + 32, :, None, :].astype(np.float64)
             - v[s:s + 32, None, :, :].astype(np.float64))
        out[s:s + 32] = np.min(np.sum(d * d, axis=-1), axis=(1, 2))
    return out


def assert_ulp(got, want64, max_ulp=4):
    want = want64.astype(np.float32)
    ulp = np.abs(np.asarray(got, np.float32).view(np.int32)
                 - want.view(np.int32))
    assert ulp.max() <= max_ulp, (got[ulp > max_ulp], want[ulp > max_ulp])


@pytest.mark.parametrize("p,wu,wv", _tier_shapes())
def test_min_d2_planar_matches_float64(rng, p, wu, wv):
    pts_u = rng.uniform(-30, 30, (p, wu, 3)).astype(np.float32)
    pts_v = rng.uniform(-30, 30, (p, wv, 3)).astype(np.float32)
    # mask a suffix of lanes the way the caller does (+BIG / -BIG fill)
    for q in range(0, p, max(1, p // 7)):
        pts_u[q, wu - (q % wu):] = 1.0e9
        pts_v[q, wv - (q % wv):] = -1.0e9
    args = tuple(pts_u[..., a] for a in range(3)) + tuple(
        pts_v[..., a] for a in range(3))
    got = np.asarray(sx.min_d2_planar(*map(jnp.asarray, args)))
    assert got.shape == (p,)
    assert_ulp(got, brute_min_d2(pts_u, pts_v))


@pytest.fixture(scope="module")
def sorted_runs():
    """Cell-key-sorted obstacle points of a dense synthetic scene and the
    cell runs over them (start, count)."""
    import dataclasses
    from lidar_processing.config import DEFAULT_CONFIG
    rng = np.random.default_rng(5)
    centers = rng.uniform([-20, -20, -1], [20, 20, 1], (40, 3))
    pts = (rng.normal(0, 0.6, (40, 100, 3)) + centers[:, None, :]
           ).reshape(-1, 3).astype(np.float32)
    n = 4096
    xyz = np.zeros((n, 3), np.float32)
    xyz[:pts.shape[0]] = pts
    valid = np.arange(n) < pts.shape[0]
    pcfg = dataclasses.replace(DEFAULT_CONFIG.pipeline, max_points=n,
                               max_obstacle_points=n)
    h = float(np.sqrt(DEFAULT_CONFIG.clustering.distance_squared / 3.0))
    sp = sx._sort_points(jnp.asarray(xyz), jnp.asarray(valid), pcfg, h)
    return np.asarray(sp.xyz), int(sp.n_obst)


@pytest.mark.parametrize("u_cap,v_cap,wu,wv", _tier_widths())
def test_block_min_d2_on_sorted_runs(sorted_runs, u_cap, v_cap, wu, wv):
    sp_xyz, n_obst = sorted_runs
    rng = np.random.default_rng(u_cap * 1000 + v_cap)
    p = 48
    # runs anywhere in the sorted buffer, counts from 1 up past the caps
    u_count = rng.integers(1, u_cap + 4, p).astype(np.int32)
    v_count = rng.integers(1, v_cap + 4, p).astype(np.int32)
    u_start = rng.integers(0, n_obst - u_count).astype(np.int32)
    v_start = rng.integers(0, n_obst - v_count).astype(np.int32)
    got = np.asarray(sx._block_min_d2(
        jnp.asarray(sp_xyz), jnp.asarray(u_start), jnp.asarray(u_count),
        jnp.asarray(v_start), jnp.asarray(v_count), u_cap, v_cap))
    want = np.empty(p)
    for k in range(p):
        # only the first cap points of each side are tested (the caller's
        # tier choice keeps counts within the caps)
        u = sp_xyz[u_start[k]:u_start[k] + min(u_count[k], u_cap)]
        v = sp_xyz[v_start[k]:v_start[k] + min(v_count[k], v_cap)]
        want[k] = brute_min_d2(u[None], v[None])[0]
    assert_ulp(got, want)
