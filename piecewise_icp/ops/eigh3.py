"""Batched closed-form symmetric 3x3 eigen-decomposition.

The entire geometric feature stack of Piecewise-ICP reduces to eigenvalues /
smallest eigenvectors of 3x3 covariance matrices: per-point PCA normals
(pca_estimate_normals.h:77-99), patch plane fits (Segmentation.cpp:202-209),
and patch features variation/planarity/linearity (Segmentation.cpp:231-257).

A trigonometric (Cardano) closed-form solve vectorises perfectly on a
vector unit — no iteration, no data-dependent control flow — and batches to millions
of points.  This replaces the reference's per-point scalar loops and Eigen
``JacobiSVD`` calls.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def eigvals3(cov: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric ``[..., 3, 3]`` matrices, descending order.

    Uses the trigonometric solution of the characteristic cubic; exact for
    symmetric input up to float rounding.
    """
    a00 = cov[..., 0, 0]
    a01 = cov[..., 0, 1]
    a02 = cov[..., 0, 2]
    a11 = cov[..., 1, 1]
    a12 = cov[..., 1, 2]
    a22 = cov[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 0.0))
    safe_p = jnp.where(p > 0, p, 1.0)

    # det(B / p) / 2 with B = A - q I
    det_b = (b00 * (b11 * b22 - a12 * a12)
             - a01 * (a01 * b22 - a12 * a02)
             + a02 * (a01 * a12 - b11 * a02))
    r = jnp.clip(det_b / (2.0 * safe_p * safe_p * safe_p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    e1 = q + 2.0 * p * jnp.cos(phi)
    e3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    vals = jnp.stack([e1, e2, e3], axis=-1)
    # isotropic / degenerate: all eigenvalues equal q
    iso = (p2 <= 0)[..., None]
    return jnp.where(iso, jnp.broadcast_to(q[..., None], vals.shape), vals)


def smallest_eigvec3(cov: jnp.ndarray, eig_min: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector for the smallest eigenvalue of ``[..., 3, 3]``.

    Picks the largest cross product of two rows of (A - eig I) — the robust
    generalisation of the adjugate-column formula the reference uses
    (pca_estimate_normals.h:96-107).  Degenerate input falls back to
    (0, 0, 1) like the reference.
    """
    e = eig_min[..., None, None]
    b = cov - e * jnp.eye(3, dtype=cov.dtype)
    r0, r1, r2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best12 = jnp.where((n12 >= n02)[..., None], c12, c02)
    nbest12 = jnp.maximum(n12, n02)
    best = jnp.where((n01 >= nbest12)[..., None], c01, best12)
    nbest = jnp.maximum(n01, nbest12)
    norm = jnp.sqrt(jnp.maximum(nbest, 0.0))[..., None]
    fallback = jnp.zeros_like(best).at[..., 2].set(1.0)
    ok = norm > jnp.asarray(1e-20, cov.dtype)
    return jnp.where(ok, best / jnp.where(ok, norm, 1.0), fallback)


def eigh3(cov: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(eigenvalues descending ``[..., 3]``, smallest eigenvector ``[..., 3]``).

    The pair every patch op needs: eigenvalues feed the planarity features,
    the smallest eigenvector is the plane normal.
    """
    vals = eigvals3(cov)
    vec = smallest_eigvec3(cov, vals[..., 2])
    return vals, vec


def cov3_from_points(points: jnp.ndarray, mask: jnp.ndarray | None = None,
                     ddof: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Covariance (divided by N - ddof) and centroid of ``[..., K, 3]`` points.

    ``mask`` (``[..., K]``) selects valid points in padded buffers.
    """
    if mask is None:
        n = jnp.asarray(points.shape[-2], points.dtype)
        mean = jnp.mean(points, axis=-2)
        centered = points - mean[..., None, :]
    else:
        m = mask.astype(points.dtype)
        n = jnp.maximum(jnp.sum(m, axis=-1), 1.0)
        mean = jnp.sum(points * m[..., None], axis=-2) / n[..., None]
        centered = (points - mean[..., None, :]) * m[..., None]
    denom = jnp.maximum(n - ddof, 1.0)
    cov = jnp.einsum("...ki,...kj->...ij", centered, centered,
                     precision="highest")
    cov = cov / denom[..., None, None]
    return cov, mean
