"""Connected components of the supernode graph (ops/stixel.py step 6).

Min-label hooking with pointer jumping over a compacted edge list, run to
a fixpoint in a bounded while loop. Labels are the minimum node id of each
component, the same contract as the host union-find oracle
(native/lidar_native.cpp union_find_cc).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_IMAX = jnp.int32(jnp.iinfo(jnp.int32).max)

# loop iterations before cc_labels gives up (each iteration is two hook +
# pointer-jump passes); a graph still changing then is reported, never
# returned as if converged
MAX_ROUNDS = 32


def cc_labels(eu, ev, n_edges, s_cap: int, max_rounds: int = MAX_ROUNDS):
    """Component labels over the first n_edges edges (eu[k], ev[k]).

    Returns (labels (s_cap,) i32 min node id per component, rounds () i32
    loop iterations run, converged () bool). converged is False when the
    loop stopped on max_rounds while labels were still changing; callers
    count that as overflow.
    """
    ok = jnp.arange(eu.shape[0], dtype=jnp.int32) < n_edges
    uv = jnp.concatenate([eu, ev])
    ok2 = jnp.concatenate([ok, ok])
    labels = jnp.arange(s_cap, dtype=jnp.int32)

    def hook(l):
        luv = l[uv]
        e = eu.shape[0]
        mn = jnp.minimum(luv[:e], luv[e:])
        mn2 = jnp.where(ok2, jnp.concatenate([mn, mn]), _IMAX)
        l = l.at[jnp.where(ok2, luv, s_cap)].min(mn2, mode="drop")
        for _ in range(4):
            l = l[l]
        return l

    def cond(state):
        _, changed, it = state
        return changed & (it < max_rounds)

    def body(state):
        l, _, it = state
        l2 = hook(hook(l))
        return l2, jnp.any(l2 != l), it + 1

    labels, changed, rounds = jax.lax.while_loop(
        cond, body, (hook(labels), jnp.bool_(True), jnp.int32(0)))
    return labels[labels], rounds, ~changed


def cc_labels_hybrid(eu, ev, n_edges, s_cap: int,
                     max_rounds: int = MAX_ROUNDS):
    """Two unconditional hook rounds, then cc_labels on the LIVE edges.

    The first rounds resolve the bulk of the edges (chains and local
    cliques collapse immediately); only the deduplicated label pairs still
    straddling two labels enter the fixpoint loop. Same contract and
    return value as cc_labels.
    """
    ec = eu.shape[0]
    ok = jnp.arange(ec, dtype=jnp.int32) < n_edges
    l = jnp.arange(s_cap, dtype=jnp.int32)
    for _ in range(2):
        lu = l[eu]
        lv = l[ev]
        mn = jnp.where(ok, jnp.minimum(lu, lv), _IMAX)
        l = l.at[jnp.where(ok, lu, s_cap)].min(mn, mode="drop")
        l = l.at[jnp.where(ok, lv, s_cap)].min(mn, mode="drop")
        l = l[l]
        l = l[l]
    lu = l[eu]
    lv = l[ev]
    live = ok & (lu != lv)
    n_live = jnp.sum(live.astype(jnp.int32))
    # pack the live label pairs to the front with one single-operand sort
    # (labels < s_cap <= 2^15 on the standard configs; fall back to the
    # 3-operand pack otherwise)
    if s_cap <= (1 << 15):
        key = jnp.where(live, jnp.minimum(lu, lv) * (1 << 15)
                        + jnp.maximum(lu, lv), jnp.int32(1) << 30)
        sk = jax.lax.sort(key)
        # contraction maps many original edges onto the same label pair —
        # dedup with one more single-operand sort
        prev = jnp.concatenate([jnp.array([-1], jnp.int32), sk[:-1]])
        uniq = (sk != prev) & (sk < (jnp.int32(1) << 30))
        n_live = jnp.sum(uniq.astype(jnp.int32))
        sk = jax.lax.sort(jnp.where(uniq, sk, jnp.int32(1) << 30))
        fresh = jnp.arange(ec, dtype=jnp.int32) < n_live
        le_u = jnp.where(fresh, sk >> 15, 0)
        le_v = jnp.where(fresh, sk & ((1 << 15) - 1), 0)
    else:
        _, le_u, le_v = jax.lax.sort(
            ((~live).astype(jnp.int32), jnp.where(live, lu, 0),
             jnp.where(live, lv, 0)), num_keys=1)
    sub, rounds, converged = cc_labels(le_u, le_v, n_live, s_cap,
                                       max_rounds)
    return sub[l], rounds, converged
