"""Device segmentation: k-NN graph, PCA normals, seeded label propagation
and patch statistics, all as XLA programs.

This is the device twin of the host C++ segmenter (``native.knn_graph`` →
``native.pca_normals`` → ``native.supervoxel_propagate``; DESIGN.md §2.1):

1. exact 45-NN self-join on the uniform grid (``grid_self_knn``; points
   whose k-th neighbour lies beyond the 27-cell window are recomputed by
   the brute streaming top-k),
2. PCA normals from the graph (``normals_from_graph``),
3. one seed per occupied voxel at the supervoxel resolution
   (``propagate_seeds``, host, cheap),
4. seeded metric label propagation in synchronous rounds of gathers and
   arg-mins over the [N, k] graph (``_propagate``), then the orphan sweep,
5. every patch statistic as masked segment reductions
   (``segmentation._patch_statistics``).

Steps 2, 4 and 5 run as ONE jitted program with one fetch.  Everything
runs in the grid's cell-sorted, bucket-padded point order, so every cloud
of a size bucket shares one executable; a permutation on the host restores
the input order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.eigh3 import eigvals3, smallest_eigvec3
from ..ops.grid_nn import build_grid, grid_self_knn, _bucket

_MAX_ROUNDS = 256           # propagation round cap (matches the host twin)


def _knn_radius(k: int, resolution: float) -> float:
    """Grid cell size for a k-NN graph on a surface sampled at
    ``resolution``: r_k ~ sqrt(k / pi) * spacing, with margin."""
    return float(max(1.2 * np.sqrt(k / np.pi), 3.0) * resolution)


# ---------------------------------------------------------------------------
# PCA normals (device twin of native.pca_normals / Segmentation.cpp:42-44)
# ---------------------------------------------------------------------------


@jax.jit
def normals_from_graph(points: jnp.ndarray, nbr: jnp.ndarray) -> jnp.ndarray:
    safe = jnp.clip(nbr, 0, points.shape[0] - 1)
    p = points[safe]                             # [N, k, 3]
    valid = (nbr >= 0)
    m = valid.astype(points.dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(valid, axis=1), 1).astype(points.dtype)
    mean = jnp.sum(p * m, axis=1) / cnt[:, None]
    c = (p - mean[:, None, :]) * m
    cov = jnp.einsum("nki,nkj->nij", c, c,
                     precision="highest") / cnt[:, None, None]
    vals = eigvals3(cov)
    return smallest_eigvec3(cov, vals[..., 2])


# ---------------------------------------------------------------------------
# Seeds: one per occupied voxel at the supervoxel resolution (host, cheap)
# ---------------------------------------------------------------------------


def propagate_seeds(points: np.ndarray, resolution: float,
                    origin: np.ndarray | None = None) -> np.ndarray:
    """Deterministic seed indices: per occupied voxel, the point nearest
    the voxel centre, in voxel order (the host twin's seed numbering, so
    label ties break identically).  Same voxelisation as GridSample
    (grid_sample.h:49-75: dims = int(extent/res)+1, coordinates clamped),
    so the seed count is the reference's expected supervoxel count K.

    ``origin`` anchors the voxel lattice explicitly (must be <= the cloud
    minimum).  Campaigns anchor every epoch to the SAME world-frame
    lattice (multiples of the supervoxel size), so consecutive epochs —
    which differ by mm-scale rigid motion — are decomposed into nearly
    identical patches; the patch-sampling error of matched patches then
    cancels in the relative pair transform instead of entering it as
    noise.  (The reference cannot do this: its GridSample seeds are
    random, grid_sample.h:55-60.)"""
    pts = np.asarray(points, dtype=np.float64)
    mn = pts.min(axis=0) if origin is None else np.asarray(
        origin, np.float64)
    dims = ((pts.max(axis=0) - mn) / resolution).astype(np.int64) + 1
    cell = np.clip((pts - mn) / resolution, 0,
                   (dims - 1).astype(np.float64)).astype(np.int64)
    lin = (cell[:, 0] * dims[1] + cell[:, 1]) * dims[2] + cell[:, 2]
    ctr = mn + (cell + 0.5) * resolution
    d2c = ((pts - ctr) ** 2).sum(axis=1)
    order = np.lexsort((np.arange(len(pts)), d2c, lin))
    lin_sorted = lin[order]
    first = np.ones(len(pts), dtype=bool)
    first[1:] = lin_sorted[1:] != lin_sorted[:-1]
    return order[first].astype(np.int32)


# ---------------------------------------------------------------------------
# Label propagation (device twin of native.supervoxel_propagate)
# ---------------------------------------------------------------------------


def _propagate(points, normals, nbr, seed_idx, inv_res_04):
    """Seeded metric label propagation over the [N, k] graph.

    Same rules as the host twin (pwicp_host.cpp, pwicp_supervoxel_propagate):
    each synchronous round, every point takes the neighbouring label whose
    SEED is closest under the VCCS metric 1 - |n_i.n_s| + 0.4 |p_i - p_s|
    / res, if that beats its own label's metric (ties go to the smaller
    label); at most 256 rounds.  Then points still unlabelled (no seed in
    their graph component) adopt their Euclidean-nearest labelled
    neighbour until none changes.  Returns labels [N] int32 = the index of
    the seed in ``seed_idx`` (-1: isolated).  Padded seed slots are -1.
    """
    n = points.shape[0]
    s = seed_idx.shape[0]
    big = jnp.asarray(jnp.inf, points.dtype)
    rows = jnp.arange(n, dtype=jnp.int32)
    nb = jnp.clip(nbr, 0, n - 1)
    edge = (nbr >= 0) & (nbr != rows[:, None])

    s_safe = jnp.clip(seed_idx, 0, n - 1)
    seed_p = points[s_safe]
    seed_n = normals[s_safe]
    lab0 = jnp.full((n,), -1, jnp.int32).at[
        jnp.where(seed_idx >= 0, seed_idx, n)].set(
        jnp.arange(s, dtype=jnp.int32), mode="drop")
    dist0 = jnp.where(lab0 >= 0, 0.0, big).astype(points.dtype)

    def prop_round(carry):
        lab, dist, _, it = carry
        lab_nb = lab[nb]                                   # [N, k]
        cand = edge & (lab_nb >= 0) & (lab_nb != lab[:, None])
        ls = jnp.clip(lab_nb, 0, s - 1)
        dp = points[:, None, :] - seed_p[ls]
        dot = jnp.sum(normals[:, None, :] * seed_n[ls], axis=-1)
        m = (1.0 - jnp.abs(dot)
             + jnp.sqrt(jnp.sum(dp * dp, axis=-1)) * inv_res_04)
        m = jnp.where(cand, m, big)
        best = jnp.min(m, axis=1)
        lab_best = jnp.min(jnp.where(m == best[:, None], lab_nb,
                                     jnp.iinfo(jnp.int32).max), axis=1)
        upd = (best < dist) | ((best == dist) & (best < big)
                               & (lab_best < lab))
        new_lab = jnp.where(upd, lab_best, lab)
        new_dist = jnp.where(upd, best, dist)
        return new_lab, new_dist, jnp.sum(new_lab != lab), it + 1

    lab, _, _, _ = jax.lax.while_loop(
        lambda c: (c[2] > 0) & (c[3] < _MAX_ROUNDS), prop_round,
        (lab0, dist0, jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32)))

    # orphan sweep: Euclidean-nearest labelled neighbour, first on ties
    d_nb = points[nb] - points[:, None, :]
    d2_edge = jnp.where(nbr >= 0, jnp.sum(d_nb * d_nb, axis=-1), big)

    def adopt_round(carry):
        lab, _ = carry
        lab_nb = lab[nb]
        d2 = jnp.where(lab_nb >= 0, d2_edge, big)
        j = jnp.argmin(d2, axis=1)
        found = jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0] < big
        take = (lab < 0) & found
        pick = jnp.take_along_axis(lab_nb, j[:, None], axis=1)[:, 0]
        return jnp.where(take, pick, lab), jnp.sum(take)

    lab, _ = jax.lax.while_loop(lambda c: c[1] > 0, adopt_round,
                                (lab, jnp.asarray(1, jnp.int32)))
    return lab


propagate_labels = jax.jit(_propagate)


def supervoxel_propagate_device(points: np.ndarray, normals: np.ndarray,
                                neighbors: np.ndarray, resolution: float,
                                seed_origin: np.ndarray | None = None
                                ) -> tuple[np.ndarray, int]:
    """Device twin of ``native.supervoxel_propagate`` with the same
    signature and result: (labels [N] int32 compacted in first-occurrence
    order, isolated points as singletons; count)."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    seeds = propagate_seeds(pts, resolution, origin=seed_origin)
    lab = np.asarray(propagate_labels(
        jnp.asarray(pts), jnp.asarray(normals, jnp.float32),
        jnp.asarray(neighbors, jnp.int32), jnp.asarray(seeds),
        jnp.float32(0.4 / resolution)))
    # the host twin's compaction: ids in order of first occurrence, each
    # isolated point its own id
    valid = lab >= 0
    uniq, first = np.unique(lab[valid], return_index=True)
    iso = np.flatnonzero(~valid)
    events = np.concatenate([np.flatnonzero(valid)[first], iso])
    rank = np.empty(len(events), dtype=np.int32)
    rank[np.argsort(events)] = np.arange(len(events), dtype=np.int32)
    remap = np.full(len(seeds), -1, dtype=np.int32)
    remap[uniq] = rank[:len(uniq)]
    out = np.empty(len(lab), dtype=np.int32)
    out[valid] = remap[lab[valid]]
    out[iso] = rank[len(uniq):]
    return out, len(events)


# ---------------------------------------------------------------------------
# The whole segmentation as one device program
# ---------------------------------------------------------------------------


@functools.partial(jax.jit,
                   static_argnames=("s_pad", "min_pts", "trim_sigma",
                                    "max_variation", "min_planarity"))
def _segment_fused(points, nbr, seed_idx, inv_res_04, *, s_pad: int,
                   min_pts: int, trim_sigma: float, max_variation: float,
                   min_planarity: float):
    """Normals + propagation + ALL patch statistics in one program.

    Patch statistics are computed per SEED id directly (padded seed slots
    have no members and fail the size gate); the host does the
    first-occurrence reordering afterwards on the single fetched result.

    Returns (labels [N] seed ids, valid [s_pad], trim [N], centroids,
    boundary, normals, std_bp, std_ct, counts).
    """
    from .segmentation import _patch_statistics

    normals = normals_from_graph(points, nbr)
    labels = _propagate(points, normals, nbr, seed_idx, inv_res_04)
    stats = _patch_statistics(points, labels, s_pad, min_pts, trim_sigma,
                              max_variation, min_planarity)
    return (labels,) + tuple(stats)


def segment_patches_device(points: np.ndarray, sv_resolution: float,
                           k: int, resolution: float, cfg,
                           seed_origin: np.ndarray | None = None):
    """Full device segmentation AND patch extraction of one cloud.

    Returns (PatchSet, n_supervoxels) with the host path's conventions:
    patches in first-occurrence order of their supervoxel, the same gates;
    the supervoxel count includes orphan singletons, like the host twin.
    """
    from ..utils.logging import gphase
    from .segmentation import PatchSet

    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    k = min(k, max(n, 1))

    with gphase("seg.knn_graph"):
        grid = build_grid(pts, _knn_radius(k, resolution))
        nbr, _ = grid_self_knn(grid, k)
        jax.block_until_ready(nbr)
    with gphase("seg.device"):
        # seeds in input order, mapped to sorted rows
        seeds = propagate_seeds(pts, sv_resolution, origin=seed_origin)
        row_of = np.empty(n, dtype=np.int32)
        row_of[grid.ids[:n]] = np.arange(n, dtype=np.int32)
        s_pad = _bucket(max(len(seeds), 1), base=256)
        seeds_p = np.full(s_pad, -1, np.int32)
        seeds_p[:len(seeds)] = row_of[seeds]
        # padding rows sit at the origin, unconnected and unlabelled
        pts_rows = np.zeros_like(grid.points)
        pts_rows[:n] = grid.points[:n]
        (lab_rows, valid, trim, ct, bp, nrm, std_bp, std_ct,
         cnt) = jax.device_get(_segment_fused(
            jnp.asarray(pts_rows), nbr, jnp.asarray(seeds_p),
            jnp.float32(0.4 / sv_resolution), s_pad=s_pad,
            min_pts=cfg.min_patch_points, trim_sigma=cfg.patch_trim_sigma,
            max_variation=cfg.max_variation,
            min_planarity=cfg.min_planarity))

    # host post-processing (input order, first-occurrence compaction)
    labels = np.empty(n, dtype=np.int32)
    labels[grid.ids[:n]] = lab_rows[:n]
    trim_in = np.empty(n, dtype=bool)
    trim_in[grid.ids[:n]] = trim[:n]
    valid_pts = labels >= 0
    uniq, first_idx = np.unique(labels[valid_pts], return_index=True)
    nsv = len(uniq) + int((~valid_pts).sum())
    pos = np.flatnonzero(valid_pts)[first_idx]
    seeds_in_order = uniq[np.argsort(pos)]
    keep = seeds_in_order[valid[seeds_in_order]]
    remap = np.full(s_pad, -1, dtype=np.int32)
    remap[keep] = np.arange(len(keep), dtype=np.int32)
    final_labels = np.where(
        trim_in & valid_pts,
        remap[np.clip(labels, 0, s_pad - 1)], -1).astype(np.int32)

    ps = PatchSet(points=pts, labels=final_labels,
                  centroids=ct[keep], boundary=bp[keep], normals=nrm[keep],
                  std_bp=std_bp[keep], std_ct=std_ct[keep],
                  counts=cnt[keep].astype(np.int32))
    return ps, nsv
