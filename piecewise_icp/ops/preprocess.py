"""Point-cloud preprocessing: voxel-grid downsampling, statistical outlier
removal, resolution estimation, percentile C2C distances, overlap ratio.

Reference counterparts:
* ``PCpreprocessing`` / ``SORfilter``  — CommonFunc.cpp:423-452 (PCL
  ``VoxelGrid`` + ``StatisticalOutlierRemoval``)
* ``calPCresolution``                  — CommonFunc.cpp:239-263
* ``calPercentileDistBetween2PC``      — CommonFunc.cpp:266-281
* ``calOverlapRatioByC2Cdist``         — Registration.cpp:593-614

Voxel binning produces a data-dependent output size, so it runs on the host
(numpy) where dynamic shapes are free; everything O(N.k) runs on device via
the NN kernels.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .nn import knn, nn1


def voxel_downsample(points: np.ndarray, leaf: float) -> np.ndarray:
    """Voxel-grid downsample: centroid of the points in each occupied voxel.

    Matches PCL ``VoxelGrid`` semantics (voxel index = floor(coord / leaf),
    output sorted by linearised voxel index).
    """
    pts = np.asarray(points, dtype=np.float32)
    if pts.shape[0] == 0:
        return pts
    v = np.floor(pts.astype(np.float64) / leaf).astype(np.int64)
    vmin = v.min(axis=0)
    v -= vmin
    dims = v.max(axis=0) + 1
    lin = (v[:, 0] * dims[1] + v[:, 1]) * dims[2] + v[:, 2]
    order = np.argsort(lin, kind="stable")
    lin_sorted = lin[order]
    pts_sorted = pts[order].astype(np.float64)
    uniq, start = np.unique(lin_sorted, return_index=True)
    counts = np.diff(np.append(start, lin.shape[0]))
    sums = np.add.reduceat(pts_sorted, start, axis=0)
    centroids = sums / counts[:, None]
    return centroids.astype(np.float32)


def sor_filter_mask(points: jnp.ndarray, mask: jnp.ndarray | None,
                    k: int = 14, std_mult: float = 2.7,
                    resolution: float | None = None) -> jnp.ndarray:
    """Statistical outlier removal: keep points whose mean distance to the
    ``k`` nearest neighbours is within mean + std_mult * std of the global
    distribution (PCL ``StatisticalOutlierRemoval``; CommonFunc.cpp:442-452,
    k=14, mult 2.7/5.0 per Registration.cpp:272,:415).

    Returns a boolean keep-mask aligned with ``points``.
    """
    if mask is None:
        mask = jnp.ones((points.shape[0],), dtype=bool)
    # k+1 neighbours: the query itself is among them at distance 0
    if resolution is not None and points.shape[0] > 4096:
        from .grid_nn import build_grid, grid_self_knn

        # the (k+1)-th neighbour of an inlier sits at ~2.2 x resolution,
        # well inside the window; sparser points are recomputed exactly
        h = max(1.5 * np.sqrt((k + 1) / np.pi), 4.0) * resolution
        sel = np.flatnonzero(np.asarray(mask))
        grid = build_grid(np.asarray(points)[sel], h)
        _, dists = grid_self_knn(grid, k + 1)
        # the statistic is order-free: threshold in the grid's sorted
        # order, then scatter the decision back
        n = grid.n_real
        keep_sorted = np.asarray(_sor_threshold(
            dists, jnp.arange(dists.shape[0]) < n, k, std_mult))
        keep = np.zeros(points.shape[0], dtype=bool)
        keep[sel[grid.ids[:n]]] = keep_sorted[:n]
        return jnp.asarray(keep)
    _, dists = knn(points, points, k + 1, q_mask=mask, t_mask=mask)
    return _sor_threshold(dists, mask, k, std_mult)


@functools.partial(jax.jit, static_argnames=("k",))
def _sor_threshold(dists, valid, k: int, std_mult):
    """Keep mask from [N, k+1] neighbour distances (self first): mean
    non-self distance <= mu + std_mult * sigma over the valid rows."""
    mean_d = jnp.sum(dists[:, 1:], axis=1) / k
    valid = valid & jnp.isfinite(mean_d)
    n = jnp.maximum(jnp.sum(valid), 1)
    safe = jnp.where(valid, mean_d, 0.0)
    mu = jnp.sum(safe) / n
    var = (jnp.sum(jnp.where(valid, (mean_d - mu) ** 2, 0.0))
           / jnp.maximum(n - 1, 1))
    return valid & (mean_d <= mu + std_mult * jnp.sqrt(var))


def preprocess_cloud(points: np.ndarray, resolution: float,
                     sor_k: int = 14, sor_mult: float = 2.7
                     ) -> np.ndarray:
    """Voxel downsample at leaf=resolution, then SOR — ``PCpreprocessing``
    (CommonFunc.cpp:423-439).  Returns a compact host array."""
    from ..utils.logging import gphase

    with gphase("prep.voxel"):
        down = voxel_downsample(points, resolution)
    with gphase("prep.sor"):
        keep = _sor_keep_mask(down, resolution, sor_k, sor_mult)
    return down[keep]


def _sor_keep_mask(down: np.ndarray, resolution: float, sor_k: int,
                   sor_mult: float) -> np.ndarray:
    """SOR keep mask over a downsampled cloud, on the device (exact grid
    k-NN) or the host C++ twin — ``backend.sor_on_device`` decides.  Both
    compute the same statistic: mean distance to the k nearest non-self
    neighbours, threshold mu + mult * sigma (sample std)."""
    from .. import backend

    n = down.shape[0]
    if n <= backend.SMALL_CLOUD:
        return np.asarray(sor_filter_mask(jnp.asarray(down), None, k=sor_k,
                                          std_mult=sor_mult))
    if backend.sor_on_device(n):
        try:
            return np.asarray(sor_filter_mask(
                jnp.asarray(down), None, k=sor_k, std_mult=sor_mult,
                resolution=resolution))
        except ValueError:
            pass    # no dense grid at this extent: the host search below
    from .. import native

    mean_d = native.sor_mean_dist(down, sor_k).astype(np.float64)
    mu = mean_d.mean()
    var = ((mean_d - mu) ** 2).sum() / max(len(mean_d) - 1, 1)
    return mean_d <= mu + sor_mult * np.sqrt(var)


def estimate_resolution(points: jnp.ndarray,
                        mask: jnp.ndarray | None = None) -> float:
    """Mean distance to the nearest non-self neighbour
    (``calPCresolution``, CommonFunc.cpp:239-263)."""
    if mask is None:
        mask = jnp.ones((points.shape[0],), dtype=bool)
    _, dists = knn(points, points, 2, q_mask=mask, t_mask=mask)
    d1 = dists[:, 1]
    valid = mask & jnp.isfinite(d1)
    n = jnp.maximum(jnp.sum(valid), 1)
    return float(jnp.sum(jnp.where(valid, d1, 0.0)) / n)


@functools.partial(jax.jit, static_argnames=("percentile",))
def percentile_c2c(target: jnp.ndarray, source: jnp.ndarray,
                   percentile: float,
                   t_mask: jnp.ndarray | None = None,
                   s_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """The p-th percentile of source→target NN distances.

    Index semantics of ``calArrayPercentileElement`` (CommonFunc.cpp:174-179):
    sort ascending and pick element ``int(n * percentile)``.

    """
    _, d = nn1(source, target, q_mask=s_mask, t_mask=t_mask)
    finite = jnp.isfinite(d)
    n = jnp.sum(finite)
    d_sorted = jnp.sort(jnp.where(finite, d, jnp.inf))
    idx = jnp.clip((n * percentile).astype(jnp.int32), 0, d.shape[0] - 1)
    return d_sorted[idx]


def overlap_ratio(target: jnp.ndarray, source: jnp.ndarray, dt_init: float,
                  t_mask: jnp.ndarray | None = None,
                  s_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """Fraction of source points whose NN distance to target is < DTinit
    (``calOverlapRatioByC2Cdist``, Registration.cpp:593-614)."""
    _, d = nn1(source, target, q_mask=s_mask, t_mask=t_mask)
    finite = jnp.isfinite(d)
    n = jnp.maximum(jnp.sum(finite), 1)
    return jnp.sum(finite & (d < dt_init)) / n


def overlap_ratio_grid(target_grid, source: jnp.ndarray,
                       dt_init: float) -> jnp.ndarray:
    """Exact overlap ratio via a grid built with ``h == dt_init``.

    A source point counts as overlapping iff its true NN distance is
    < DTinit.  With cell size h = DTinit, every such point resolves inside
    the 27-cell window with its exact distance, and every unresolved point
    has true distance > h = DTinit — so the ratio equals the brute-force
    ``overlap_ratio`` bit-for-bit with ~100x less arithmetic (no fallback
    branch needed).
    """
    from .grid_nn import _bucket, grid_query_1nn

    if abs(target_grid.h - dt_init) > 1e-12 * max(dt_init, 1.0):
        raise ValueError("overlap grid must be built with h == dt_init")
    n = source.shape[0]
    # bucket the query count so differently sized epochs share one
    # executable
    pad = _bucket(max(n, 1), base=4096) - n
    src = jnp.pad(jnp.asarray(source, jnp.float32), ((0, pad), (0, 0)))
    mask = jnp.arange(n + pad) < n
    _, d, resolved = grid_query_1nn(
        src, mask, jnp.asarray(target_grid.points),
        jnp.asarray(target_grid.cell_starts),
        jnp.asarray(target_grid.origin),
        jnp.asarray(target_grid.dims, jnp.int32), target_grid.max_run,
        jnp.asarray(target_grid.h, jnp.float32))
    hit = mask & resolved & (d < dt_init)
    return jnp.sum(hit) / jnp.maximum(n, 1)
