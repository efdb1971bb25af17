"""Segmented-scan primitives over sorted runs.

Associative scans are dense log-depth ops without data-dependent
addressing, so run-aligned scans replace segment_min/segment_max scatters
wherever the data is already sorted by segment. Segments are encoded by
their sorted segment ids.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def seg_scan_min(values: jnp.ndarray, seg_ids: jnp.ndarray,
                 reverse: bool = False) -> jnp.ndarray:
    """Running min within each run of equal (sorted) seg_ids.

    values: (N, ...) — scanned along axis 0, elementwise in trailing dims.
    With reverse=True each element sees the min over the rest of its run, so
    the value at a run START is the aggregate over the whole run.
    """
    ids = _bcast(seg_ids, values)
    out, _ = jax.lax.associative_scan(_min_comb, (values, ids),
                                      reverse=reverse)
    return out


def _min_comb(a, b):
    av, aseg = a
    bv, bseg = b
    return (jnp.where(aseg == bseg, jnp.minimum(av, bv), bv), bseg)


def _max_comb(a, b):
    av, aseg = a
    bv, bseg = b
    return (jnp.where(aseg == bseg, jnp.maximum(av, bv), bv), bseg)


def _keep_comb(a, b):
    av, aseg = a
    bv, bseg = b
    return (jnp.where(aseg == bseg, av, bv), bseg)


def seg_scan_max(values: jnp.ndarray, seg_ids: jnp.ndarray,
                 reverse: bool = False) -> jnp.ndarray:
    ids = _bcast(seg_ids, values)
    out, _ = jax.lax.associative_scan(_max_comb, (values, ids),
                                      reverse=reverse)
    return out


def seg_broadcast_first(values: jnp.ndarray,
                        seg_ids: jnp.ndarray) -> jnp.ndarray:
    """Propagate each run's FIRST value over the whole run."""
    ids = _bcast(seg_ids, values)
    out, _ = jax.lax.associative_scan(_keep_comb, (values, ids))
    return out


def _bcast(seg_ids, values):
    if values.ndim > seg_ids.ndim:
        return jnp.broadcast_to(
            seg_ids[(...,) + (None,) * (values.ndim - seg_ids.ndim)],
            values.shape)
    return seg_ids


def run_starts(new_run: jnp.ndarray, num_runs: int) -> jnp.ndarray:
    """Each run's start position as a (num_runs,) table.

    new_run: (N,) bool marking run starts. Slots beyond the real run count
    hold N.

    CONTRACT: the table is indexed by *implicit* run id == the rank of the
    flagged position, i.e. ``cumsum(new_run) - 1``. Callers that carry
    their own (clamped/remapped) run-id array must ensure it equals that
    cumsum; any other numbering silently reads the wrong starts.

    Because those ranks are monotone in position, the k-th run's start is
    the k-th smallest flagged position — ONE single-operand sort in place
    of a full-length scatter.
    """
    n = new_run.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    flagged = jnp.where(new_run, pos, jnp.int32(jnp.iinfo(jnp.int32).max))
    s = jax.lax.sort(flagged)
    take = s[:num_runs] if num_runs <= n else jnp.concatenate(
        [s, jnp.full((num_runs - n,), jnp.iinfo(jnp.int32).max, jnp.int32)])
    return jnp.minimum(take, n)


def compact_mask(mask: jnp.ndarray, capacity: int
                 ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pack the indices where mask is True into a (capacity,) buffer.

    Returns (indices, count, overflow). Overflowing entries are dropped;
    slots beyond the count hold 0.

    ONE single-operand sort (flagged positions to the front) instead of
    the cumsum+scatter formulation (the same trade as run_starts).
    """
    n = mask.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    flagged = jnp.where(mask, pos, jnp.int32(jnp.iinfo(jnp.int32).max))
    s = jax.lax.sort(flagged)
    take = s[:capacity] if capacity <= n else jnp.concatenate(
        [s, jnp.full((capacity - n,), jnp.iinfo(jnp.int32).max, jnp.int32)])
    count = jnp.sum(mask.astype(jnp.int32))
    idx = jnp.where(jnp.arange(capacity, dtype=jnp.int32) < count, take, 0)
    overflow = jnp.maximum(count - capacity, 0)
    return idx, jnp.minimum(count, capacity), overflow
