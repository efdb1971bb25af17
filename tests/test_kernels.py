"""Connected-components building blocks (ops/components.py).

The hook-first hybrid must give the same min-id component labels as the
plain fixpoint loop, including above the packed-key limit where it packs
live edges with a 3-operand sort.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from lidar_processing.ops import components as cc


class TestUnionFindKernel:
    @pytest.mark.parametrize("seed,s_cap,n_edges", [
        (0, 512, 900), (2, 2048, 4000), (4, 8192, 20000), (3, 128, 0),
        (5, 1 << 16, 5000),   # above the packed-key limit: 3-operand path
    ])
    def test_hybrid_matches_xla(self, seed, s_cap, n_edges):
        rng = np.random.default_rng(seed)
        ec = max(n_edges + 64, 128)
        eu = jnp.asarray(rng.integers(0, s_cap, ec), jnp.int32)
        ev = jnp.asarray(
            np.minimum(s_cap - 1,
                       rng.integers(0, s_cap, ec)
                       + rng.integers(0, 30, ec)), jnp.int32)
        ne = jnp.int32(n_edges)
        got, _, got_ok = cc.cc_labels_hybrid(eu, ev, ne, s_cap)
        want, _, want_ok = cc.cc_labels(eu, ev, ne, s_cap)
        assert bool(got_ok) and bool(want_ok)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
