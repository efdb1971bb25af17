"""Closed-form symmetric 3x3 eigen-analysis, batched and jit/vmap friendly.

The reference computes the ground-plane normal as the singular vector of the
3x3 point covariance with the smallest singular value via Eigen::JacobiSVD
(ref: src/segmentation.cpp:87-99). An iterative SVD is a poor fit for a
device program (tiny serial op on the critical path); a trigonometric
closed-form
eigensolver (Cardano / Eberly-style) is branch-free, vectorizes over any
batch of covariance matrices, and is exact enough for well-separated ground
planes (eigen-gap ~1e6 on road scenes).

Sign convention: the returned normal is canonicalized upward (n_z >= 0,
falling back to the largest-magnitude component positive) — see ACCURACY.md.
"""

from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def smallest_eigenvalue_3x3(a: jnp.ndarray) -> jnp.ndarray:
    """Smallest eigenvalue of symmetric (...,3,3) matrices (trig closed form)."""
    q = jnp.trace(a, axis1=-2, axis2=-1) / 3.0
    eye = jnp.eye(3, dtype=a.dtype)
    b = a - q[..., None, None] * eye
    p2 = jnp.sum(b * b, axis=(-2, -1))
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    safe_p = jnp.maximum(p, _EPS)
    bn = b / safe_p[..., None, None]
    detbn = jnp.linalg.det(bn)
    r = jnp.clip(detbn / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    # eigenvalues are q + 2p*cos(phi + 2k*pi/3); k=0 gives the largest.
    lam_min = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam_mid = q + 2.0 * p * jnp.cos(phi - 2.0 * jnp.pi / 3.0)
    lam_min = jnp.minimum(lam_min, lam_mid)  # guard ordering edge cases
    return jnp.where(p2 < _EPS, q, lam_min)


def smallest_eigenvector_3x3(a: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector for the smallest eigenvalue of symmetric (...,3,3)
    matrices, canonicalized upward.

    The eigenvector is the null direction of (A - lam*I); it is recovered as
    the largest cross product of two rows (rows span the orthogonal
    complement). Degenerate (isotropic) inputs return +e_z.
    """
    lam = smallest_eigenvalue_3x3(a)
    m = a - lam[..., None, None] * jnp.eye(3, dtype=a.dtype)
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    norms = jnp.stack([n01, n02, n12], axis=-1)
    best = jnp.argmax(norms, axis=-1)
    cands = jnp.stack([c01, c02, c12], axis=-2)          # (...,3cand,3)
    v = jnp.take_along_axis(cands, best[..., None, None].repeat(3, -1),
                            axis=-2)[..., 0, :]
    best_norm = jnp.max(norms, axis=-1)
    degenerate = best_norm < _EPS
    ez = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0], a.dtype), v.shape)
    v = jnp.where(degenerate[..., None], ez, v)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), _EPS)

    # canonical sign: upward; tie-break on largest-magnitude component
    vz = v[..., 2]
    absv = jnp.abs(v)
    kmax = jnp.argmax(absv, axis=-1)
    vmax = jnp.take_along_axis(v, kmax[..., None], axis=-1)[..., 0]
    flip = jnp.where(vz != 0.0, vz < 0.0, vmax < 0.0)
    return jnp.where(flip[..., None], -v, v)
