"""Connected components (ops/components.py) against the host union-find,
plus the mesh builders and the compile-cache location."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lidar_processing.ops import components as cc
from lidar_processing.ops import hull_native as hn


def random_graph(seed, s_cap, n_edges):
    rng = np.random.default_rng(seed)
    ec = max(n_edges + 64, 128)
    eu = rng.integers(0, s_cap, ec).astype(np.int32)
    ev = np.minimum(s_cap - 1, rng.integers(0, s_cap, ec)
                    + rng.integers(0, 30, ec)).astype(np.int32)
    return eu, ev


def chain_graph(seed, s_cap):
    """One path through every node in a random order: the longest chain
    a graph of s_cap nodes can hold, plus padding edge slots."""
    perm = np.random.default_rng(seed).permutation(s_cap).astype(np.int32)
    pad = np.zeros(64, np.int32)
    return (np.concatenate([perm[:-1], pad]),
            np.concatenate([perm[1:], pad]), s_cap - 1)


def host_labels(eu, ev, n_edges, s_cap):
    return hn.union_find_cc(eu[:n_edges], ev[:n_edges], s_cap)


GRAPHS = [("random", 0, 512, 900), ("random", 1, 1024, 300),
          ("random", 2, 2048, 4000), ("random", 3, 128, 0),
          ("chain", 4, 10240, None)]


def _graph(kind, seed, s_cap, n_edges):
    if kind == "chain":
        return chain_graph(seed, s_cap)
    eu, ev = random_graph(seed, s_cap, n_edges)
    return eu, ev, n_edges


@pytest.mark.parametrize("kind,seed,s_cap,n_edges", GRAPHS)
def test_cc_labels_matches_host_union_find(kind, seed, s_cap, n_edges):
    eu, ev, ne = _graph(kind, seed, s_cap, n_edges)
    labels, rounds, converged = cc.cc_labels(
        jnp.asarray(eu), jnp.asarray(ev), jnp.int32(ne), s_cap)
    assert bool(converged)
    assert 0 <= int(rounds) <= cc.MAX_ROUNDS
    np.testing.assert_array_equal(np.asarray(labels),
                                  host_labels(eu, ev, ne, s_cap))


def test_cc_round_cap_reports_unconverged():
    """A loop stopped on its round bound says so (the clustering adds it to
    overflow) instead of handing back labels as if final."""
    eu, ev, ne = chain_graph(4, 10240)
    labels, rounds, converged = cc.cc_labels(
        jnp.asarray(eu), jnp.asarray(ev), jnp.int32(ne), 10240,
        max_rounds=1)
    assert int(rounds) == 1
    assert not bool(converged)
    assert not np.array_equal(np.asarray(labels),
                              host_labels(eu, ev, ne, 10240))


def test_cc_round_cap_raises_cluster_overflow(monkeypatch):
    from lidar_processing.config import DEFAULT_CONFIG
    from lidar_processing.ops import stixel as sx
    import dataclasses
    # a straight chain of points 0.4 m apart is one cluster whose supernode
    # graph is a long path
    n = 256
    xyz = np.zeros((n, 3), np.float32)
    xyz[:, 0] = np.arange(n) * 0.4
    valid = np.ones(n, bool)
    pcfg = dataclasses.replace(
        DEFAULT_CONFIG.pipeline, max_points=n, max_obstacle_points=n,
        max_cells=512, max_columns=256, max_supernodes=384,
        max_column_pairs=1024, max_sn_pairs=1024, max_edges=1024)
    full = sx.cluster(jnp.asarray(xyz), jnp.asarray(valid),
                      DEFAULT_CONFIG.clustering, pcfg)
    assert int(full.overflow) == 0 and int(full.num_clusters) == 1
    real = cc.cc_labels
    monkeypatch.setattr(
        sx, "cc_labels",
        lambda *a: real(*a, max_rounds=0))
    capped = jax.jit(lambda x, v: sx._cluster_impl(
        x, v, DEFAULT_CONFIG.clustering, pcfg)[0])(
            jnp.asarray(xyz), jnp.asarray(valid))
    assert int(capped.overflow) >= 1


def test_make_mesh_raises_without_enough_devices():
    from lidar_processing.parallel.sharded import make_mesh
    assert make_mesh(8).devices.size == 8
    with pytest.raises(ValueError):
        make_mesh(16)


def test_make_mesh_2d_raises_without_enough_devices():
    from lidar_processing.parallel.sharded import make_mesh_2d
    assert make_mesh_2d(2, 4).devices.shape == (2, 4)
    with pytest.raises(ValueError):
        make_mesh_2d(4, 4)


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from lidar_processing import compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_default_in_checkout(monkeypatch):
    import os
    from lidar_processing import compile_cache
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.enable_compile_cache()
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        compile_cache.__file__)))
    assert d == os.path.join(root, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", d)]
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
