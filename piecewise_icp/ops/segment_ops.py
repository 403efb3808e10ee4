"""Masked segment reductions — the ragged-patch replacement.

The reference stores patches as ragged per-supervoxel point lists
(``pcl::PointCloud`` arrays, Segmentation.cpp:84-103) and loops over them.
This design keeps ONE flat point array plus an int32 ``labels`` array and
computes every per-patch statistic as a masked segment reduction — dense,
static-shaped, and vectorised over all patches at once.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

_NEG = -jnp.inf


def segment_sum(data: jnp.ndarray, segment_ids: jnp.ndarray,
                num_segments: int) -> jnp.ndarray:
    """Sum ``data`` rows per segment; ids < 0 are dropped."""
    ids = jnp.where(segment_ids >= 0, segment_ids, num_segments)
    out = jax.ops.segment_sum(data, ids, num_segments=num_segments + 1)
    return out[:num_segments]


def segment_count(segment_ids: jnp.ndarray, num_segments: int,
                  mask: jnp.ndarray | None = None) -> jnp.ndarray:
    ones = jnp.ones(segment_ids.shape, dtype=jnp.int32)
    if mask is not None:
        ones = jnp.where(mask, ones, 0)
        segment_ids = jnp.where(mask, segment_ids, -1)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data: jnp.ndarray, segment_ids: jnp.ndarray,
                 num_segments: int,
                 mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Mean of ``data`` rows per segment (centroids for ``data``=[N,3])."""
    if mask is not None:
        segment_ids = jnp.where(mask, segment_ids, -1)
    cnt = segment_count(segment_ids, num_segments).astype(data.dtype)
    total = segment_sum(data, segment_ids, num_segments)
    denom = jnp.maximum(cnt, 1.0)
    if data.ndim > 1:
        denom = denom.reshape(denom.shape + (1,) * (data.ndim - 1))
    return total / denom


def segment_max(values: jnp.ndarray, segment_ids: jnp.ndarray,
                num_segments: int) -> jnp.ndarray:
    ids = jnp.where(segment_ids >= 0, segment_ids, num_segments)
    out = jax.ops.segment_max(values, ids, num_segments=num_segments + 1)
    return out[:num_segments]


def segment_min(values: jnp.ndarray, segment_ids: jnp.ndarray,
                num_segments: int) -> jnp.ndarray:
    return -segment_max(-values, segment_ids, num_segments)


def segment_argmax(values: jnp.ndarray, segment_ids: jnp.ndarray,
                   num_segments: int,
                   mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Index (into ``values``) of the max per segment.

    Ties resolve to the smallest index; empty segments return 0.
    """
    if mask is not None:
        values = jnp.where(mask, values, _NEG)
        segment_ids = jnp.where(mask, segment_ids, -1)
    seg_max = segment_max(values, segment_ids, num_segments)
    n = values.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    valid_seg = (segment_ids >= 0) & (segment_ids < num_segments)
    gathered = jnp.where(valid_seg, seg_max[jnp.clip(segment_ids, 0)], _NEG)
    is_max = (values == gathered) & valid_seg
    cand = jnp.where(is_max, idx, n)
    out = segment_min(cand, segment_ids, num_segments)
    return jnp.clip(out, 0, n - 1).astype(jnp.int32)


def segment_argmin(values: jnp.ndarray, segment_ids: jnp.ndarray,
                   num_segments: int,
                   mask: jnp.ndarray | None = None) -> jnp.ndarray:
    vals = -values
    if mask is not None:
        vals = jnp.where(mask, vals, _NEG)
    return segment_argmax(vals, segment_ids, num_segments,
                          mask=None if mask is None else mask)


@functools.partial(jax.jit, static_argnames=("num_segments", "ddof"))
def segment_cov3(points: jnp.ndarray, segment_ids: jnp.ndarray,
                 num_segments: int, mask: jnp.ndarray | None = None,
                 ddof: int = 0) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-segment 3x3 covariance (divided by N - ddof), centroid, count.

    The batched replacement for per-patch ``pcl::PCA`` / Eigen covariance
    loops (Segmentation.cpp:202-209, :240-246).
    """
    ids = segment_ids if mask is None else jnp.where(mask, segment_ids, -1)
    cnt = segment_count(ids, num_segments).astype(points.dtype)
    mean = segment_mean(points, ids, num_segments)
    safe_ids = jnp.clip(ids, 0, num_segments - 1)
    centered = points - mean[safe_ids]
    centered = jnp.where((ids >= 0)[:, None], centered, 0.0)
    outer = jnp.einsum("ni,nj->nij", centered, centered,
                       precision="highest").reshape(-1, 9)
    cov = segment_sum(outer, ids, num_segments).reshape(-1, 3, 3)
    denom = jnp.maximum(cnt - ddof, 1.0)
    cov = cov / denom[:, None, None]
    return cov, mean, cnt
