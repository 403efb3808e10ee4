"""Patch generation & refinement — supervoxels to planar patches.

Data-parallel reformulation of ``PatchGenerationAndRefinement``
(Segmentation.cpp:11-192):

1. 45-NN graph (native grid kNN on host, or the device grid k-NN),
2. per-point PCA normals — batched closed-form 3x3 eigensolve on device
   (replaces the per-point loop at Segmentation.cpp:37-45),
3. supervoxel segmentation by seeded metric label propagation (the
   framework's from-scratch parallel segmenter; covers the role of the
   reference's sequential energy fusion, supervoxel_segmentation.h:66-248),
4. patch refinement/selection/statistics — ALL patches at once via masked
   segment reductions (replaces the per-supervoxel loop at
   Segmentation.cpp:107-150):
     - reject patches with < 20 points (minPtNum, CommonFunc.h:42),
     - 2-sigma plane-residual trim, std = sqrt(sum d^2 / N)
       (PatchRefinement, Segmentation.cpp:195-228),
     - re-reject < 20 points after trim,
     - planarity gate: variation <= 0.02 and planarity >= 0.25 on the
       trimmed covariance eigenvalues (calPatchFeature, Segmentation.cpp:231-257),
     - centroid + 6 axis-extremal boundary points, order
       (Xmax, Xmin, Ymax, Ymin, Zmax, Zmin) (calPatchCTandBP, :260-303),
     - patch plane STD with denominator N-1 (calPatchSTD,
       CommonFunc.cpp:336-354) and centroid STD = STD / N
       (calBPandCTSTD, Segmentation.cpp:306-321 — note: /N, not /sqrt(N),
       reproduced faithfully),
     - per-patch plane normal (calPatchNormal, CommonFunc.cpp:284-333).

The ragged per-patch point lists of the reference become ONE flat point
array plus an int32 label array; every statistic is a segment reduction.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PiecewiseICPConfig
from ..ops.eigh3 import eigh3, eigvals3, smallest_eigvec3
from ..ops import segment_ops as seg
from ..ops.nn import knn as device_knn
from ..utils.errors import DegenerateGeometryError
from ..utils.logging import gphase, log


@dataclasses.dataclass
class PatchSet:
    """Planar-patch decomposition of one cloud (host numpy arrays)."""

    points: np.ndarray    # [N, 3] f32 — full preprocessed cloud
    labels: np.ndarray    # [N] int32 — compact patch id, -1 = unassigned
    centroids: np.ndarray  # [P, 3] f32
    boundary: np.ndarray   # [P, 6, 3] f32 (Xmax,Xmin,Ymax,Ymin,Zmax,Zmin)
    normals: np.ndarray    # [P, 3] f32 — patch plane normals
    std_bp: np.ndarray     # [P] f32 — plane-fit STD (denominator N-1)
    std_ct: np.ndarray     # [P] f32 — STD / N (reference semantics)
    counts: np.ndarray     # [P] int32 — points per patch after trim

    @property
    def num_patches(self) -> int:
        return self.centroids.shape[0]

    def translated(self, delta: np.ndarray) -> "PatchSet":
        """Patch decomposition under a pure translation.

        Segmentation, normals, plane STDs and membership are
        translation-invariant, so an epoch segmented once in its own
        centroid frame can serve as source OR target of any pair by
        shifting its point-level arrays — the key to segmenting each epoch
        of a campaign exactly once.
        """
        d = np.asarray(delta, dtype=np.float64)
        f32 = np.float32
        return PatchSet(
            points=(self.points.astype(np.float64) + d).astype(f32),
            labels=self.labels,
            centroids=(self.centroids.astype(np.float64) + d).astype(f32),
            boundary=(self.boundary.astype(np.float64) + d).astype(f32),
            normals=self.normals, std_bp=self.std_bp, std_ct=self.std_ct,
            counts=self.counts)

    def transformed(self, t: np.ndarray) -> "PatchSet":
        """Patch decomposition under a rigid transform (warm-start path:
        membership/STDs are invariant, geometry maps, normals rotate)."""
        from ..ops.transform import apply_transform_np

        t = np.asarray(t, dtype=np.float64)
        f32 = np.float32
        p = self.boundary.shape[0]
        return PatchSet(
            points=apply_transform_np(
                self.points.astype(np.float64), t).astype(f32),
            labels=self.labels,
            centroids=apply_transform_np(
                self.centroids.astype(np.float64), t).astype(f32),
            boundary=apply_transform_np(
                self.boundary.reshape(-1, 3).astype(np.float64),
                t).astype(f32).reshape(p, 6, 3),
            normals=(self.normals.astype(np.float64)
                     @ t[:3, :3].T).astype(f32),
            std_bp=self.std_bp, std_ct=self.std_ct,
            counts=self.counts)


def estimate_normals(points: np.ndarray, neighbor_idx: np.ndarray
                     ) -> np.ndarray:
    """Batched PCA normals from a kNN graph.

    Device equivalent of PCAEstimateNormal over 45 neighbours
    (Segmentation.cpp:42-44, pca_estimate_normals.h:77-99): smallest
    eigenvector of the neighbourhood covariance.
    """
    return np.asarray(_normals_jit(jnp.asarray(points),
                                   jnp.asarray(neighbor_idx)))


@jax.jit
def _normals_jit(points: jnp.ndarray, neighbor_idx: jnp.ndarray) -> jnp.ndarray:
    safe_idx = jnp.clip(neighbor_idx, 0, points.shape[0] - 1)
    nbr = points[safe_idx]                      # [N, k, 3]
    valid = (neighbor_idx >= 0)                 # [N, k]
    m = valid.astype(points.dtype)[..., None]
    cnt = jnp.maximum(jnp.sum(valid, axis=1), 1).astype(points.dtype)
    mean = jnp.sum(nbr * m, axis=1) / cnt[:, None]
    centered = (nbr - mean[:, None, :]) * m
    cov = jnp.einsum("nki,nkj->nij", centered, centered,
                     precision="highest") / cnt[:, None, None]
    vals = eigvals3(cov)
    return smallest_eigvec3(cov, vals[..., 2])


def knn_graph(points: np.ndarray, k: int, impl: str = "auto",
              resolution: float | None = None) -> np.ndarray:
    """kNN indices [N, k] with self first.

    ``impl``:
      * "auto" / "native" — exact C++ grid search on the host;
      * "grid" with a resolution hint — the device grid k-NN (exact:
        stragglers beyond the 27-cell window are recomputed by brute
        top-k);
      * anything else — exact brute-force streaming top-k on the device.
    """
    if impl in ("auto", "native"):
        # the host C++ grid search: the graph is consumed on the host
        # (native normals + supervoxel propagation) in this path
        try:
            from .. import native
            return native.knn_graph(points, k)
        except Exception as e:  # pragma: no cover - fallback path
            if impl == "native":
                raise
            log.warning("native kNN unavailable (%s); using device kNN", e)
    if impl == "grid" and resolution is not None:
        from ..ops.grid_nn import build_grid, grid_knn

        # h ~ expected k-NN radius on a surface (r_k ~ sqrt(k/pi) * spacing);
        # stragglers beyond the window are recomputed exactly by the
        # subset fallback inside grid_knn
        h = max(1.2 * np.sqrt(k / np.pi), 3.0) * resolution
        grid = build_grid(points, h)
        idx, _ = grid_knn(jnp.asarray(points), grid, k, exact=True)
        return np.asarray(idx)
    idx, _ = device_knn(jnp.asarray(points), jnp.asarray(points), k)
    return np.asarray(idx)


@functools.partial(jax.jit, static_argnames=("num_patches",))
def _patch_statistics(points: jnp.ndarray, labels: jnp.ndarray,
                      num_patches: int, min_pts: int, trim_sigma: float,
                      max_variation: float, min_planarity: float):
    """All per-patch statistics in one jitted pass over raw supervoxels.

    Returns per-raw-patch: valid mask, trimmed-point mask (aligned with
    ``points``), centroid, boundary points, plane normal, std_bp, std_ct,
    trimmed count.
    """
    n = points.shape[0]
    ids = labels

    # --- size gate #1 (Segmentation.cpp:109) ---
    cnt0 = seg.segment_count(ids, num_patches)
    ok0 = cnt0 >= min_pts

    # --- plane fit #1 + 2-sigma trim (PatchRefinement) ---
    cov1, mean1, n1 = seg.segment_cov3(points, ids, num_patches)
    vals1 = eigvals3(cov1)
    nrm1 = smallest_eigvec3(cov1, vals1[..., 2])
    safe = jnp.clip(ids, 0, num_patches - 1)
    d1 = jnp.abs(jnp.sum((points - mean1[safe]) * nrm1[safe], axis=1))
    d1 = jnp.where(ids >= 0, d1, 0.0)
    # std = sqrt(sum d^2 / N)  (Segmentation.cpp:220 — N, not N-1)
    sum_d1sq = seg.segment_sum(d1 * d1, ids, num_patches)
    std1 = jnp.sqrt(sum_d1sq / jnp.maximum(n1, 1.0))
    trim = (ids >= 0) & (d1 < trim_sigma * std1[safe])

    tids = jnp.where(trim, ids, -1)

    # --- size gate #2 (Segmentation.cpp:119) ---
    cnt2 = seg.segment_count(tids, num_patches)
    ok2 = cnt2 >= min_pts

    # --- plane fit #2 on trimmed points: features + normal + stats ---
    cov2, mean2, n2 = seg.segment_cov3(points, tids, num_patches)
    vals2 = eigvals3(cov2)
    nrm2 = smallest_eigvec3(cov2, vals2[..., 2])
    e1 = jnp.maximum(vals2[..., 0], 1e-30)
    esum = jnp.maximum(vals2[..., 0] + vals2[..., 1] + vals2[..., 2], 1e-30)
    variation = vals2[..., 2] / esum
    planarity = (vals2[..., 1] - vals2[..., 2]) / e1
    ok3 = (variation <= max_variation) & (planarity >= min_planarity)

    valid = ok0 & ok2 & ok3

    # --- centroid + boundary points of trimmed patch ---
    bp_idx = []
    for axis in range(3):
        v = points[:, axis]
        bp_idx.append(seg.segment_argmax(v, tids, num_patches))
        bp_idx.append(seg.segment_argmin(v, tids, num_patches))
    bp = points[jnp.stack(bp_idx, axis=1)]      # [P, 6, 3]

    # --- plane STD with denominator N-1 (calPatchSTD) ---
    d2 = jnp.abs(jnp.sum((points - mean2[safe]) * nrm2[safe], axis=1))
    d2 = jnp.where(tids >= 0, d2, 0.0)
    sum_d2sq = seg.segment_sum(d2 * d2, tids, num_patches)
    std_bp = jnp.sqrt(sum_d2sq / jnp.maximum(n2 - 1.0, 1.0))
    std_ct = std_bp / jnp.maximum(n2, 1.0)      # /N (calBPandCTSTD:319)

    return (valid, trim, mean2, bp, nrm2, std_bp, std_ct,
            cnt2.astype(jnp.int32))


def build_patches(points: np.ndarray, sv_resolution: float,
                  cfg: Optional[PiecewiseICPConfig] = None,
                  resolution: float | None = None,
                  lattice_shift: np.ndarray | None = None,
                  lattice_offset: np.ndarray | None = None) -> PatchSet:
    """Full patch pipeline for one preprocessed cloud.

    Reference call stack: PatchGenerationAndRefinement (Segmentation.cpp:11)
    → normals → SupervoxelSegmentation → per-SV refinement/selection.

    ``lattice_shift``: the translation mapping WORLD coordinates into this
    cloud's frame (the centroid-reduction shift).  With
    ``cfg.seed_grid_align`` the supervoxel seed lattice is anchored to
    multiples of ``sv_resolution`` in the world frame, so every epoch of a
    campaign shares one voxelisation (cross-epoch patch consistency).
    ``None`` anchors to this frame's own lattice (correct whenever both
    clouds of a pair are segmented in a shared frame).

    ``lattice_offset``: extra phase offset of the seed lattice — an
    independent patch DRAW of the same surface.  The acceptance guard uses
    it to re-roll a registration whose stable-set draw converged badly
    (hard-pair bistability, VERDICT r4 items 1/3).
    """
    cfg = cfg or PiecewiseICPConfig()
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    k = min(cfg.knn_normals, max(n - 1, 1))

    seed_origin = None
    if cfg.seed_grid_align and n:
        ls = (np.zeros(3) if lattice_shift is None
              else np.asarray(lattice_shift, np.float64))
        mn = pts.astype(np.float64).min(axis=0)
        # lattice {ls + j*sv}: the largest anchor <= the cloud minimum
        seed_origin = (np.floor((mn - ls) / sv_resolution) * sv_resolution
                       + ls)
    if lattice_offset is not None and n:
        base = (seed_origin if seed_origin is not None
                else pts.astype(np.float64).min(axis=0))
        # shifting the origin BELOW the cloud minimum by the (mod-sv)
        # offset re-phases every voxel boundary without uncovering points
        seed_origin = base - np.mod(
            np.asarray(lattice_offset, np.float64), sv_resolution)

    from .. import backend

    use_device = backend.segmentation_on_device(n, cfg.segmentation_impl)
    if use_device:
        from .segmentation_device import segment_patches_device
        ps, nsv = segment_patches_device(
            pts, sv_resolution, k,
            resolution if resolution else sv_resolution / 10.0, cfg,
            seed_origin=seed_origin)
        log.info("supervoxels generated: %d (cloud %d pts)", nsv, n)
        log.info("selected patches: %d / %d (%.1f%% of points)",
                 ps.num_patches, nsv,
                 100.0 * (ps.labels >= 0).sum() / max(n, 1))
        return ps
    with gphase("seg.knn_graph"):
        nbr = knn_graph(pts, k, impl=cfg.nn_impl, resolution=resolution)
    with gphase("seg.normals"):
        try:
            from .. import native as _native
            normals = _native.pca_normals(pts, nbr)
        except Exception:  # pragma: no cover - fallback path
            normals = estimate_normals(pts, nbr)

    from .. import native
    with gphase("seg.supervoxel"):
        labels_raw, nsv = native.supervoxel_propagate(
            pts, normals, nbr, resolution=sv_resolution,
            seed_origin=seed_origin)
    log.info("supervoxels generated: %d (cloud %d pts)", nsv, n)

    with gphase("seg.patch_stats"):
        # bucket the patch count: num_patches is a static jit arg, and a
        # campaign's epochs each produce a unique supervoxel count — padded
        # slots have zero members, fail the size gate, and drop out below
        from ..ops.grid_nn import _bucket
        nsv_b = _bucket(max(nsv, 1), base=256)
        # one batched device->host fetch
        (valid, trim, ct, bp, nrm, std_bp, std_ct, cnt) = jax.device_get(
            _patch_statistics(jnp.asarray(pts), jnp.asarray(labels_raw),
                              nsv_b,
                              cfg.min_patch_points, cfg.patch_trim_sigma,
                              cfg.max_variation, cfg.min_planarity))
        valid, ct, bp, nrm, std_bp, std_ct, cnt = (
            a[:nsv] for a in (valid, ct, bp, nrm, std_bp, std_ct, cnt))

    # compact valid patches, preserving raw order (Segmentation.cpp:107-150)
    keep = np.where(valid)[0]
    remap = np.full(nsv, -1, dtype=np.int32)
    remap[keep] = np.arange(len(keep), dtype=np.int32)
    point_ok = trim & valid[np.clip(labels_raw, 0, nsv - 1)]
    labels = np.where(point_ok, remap[np.clip(labels_raw, 0, nsv - 1)],
                      -1).astype(np.int32)

    ps = PatchSet(points=pts, labels=labels,
                  centroids=ct[keep], boundary=bp[keep],
                  normals=nrm[keep], std_bp=std_bp[keep],
                  std_ct=std_ct[keep], counts=cnt[keep])
    log.info("selected patches: %d / %d (%.1f%% of points)",
             ps.num_patches, nsv,
             100.0 * (labels >= 0).sum() / max(n, 1))
    return ps
