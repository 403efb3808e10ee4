"""The Piecewise-ICP core: iterative stable-patch classification under a
monotonically decreasing distance threshold, with Level-of-Detection floor.

Device re-design of ``Piecewise_ICP`` / ``PwICP_singleIteration``
(Registration.cpp:618-972).  The data-dependent, variable-iteration DT loop
runs on host (matching the reference's control flow); each iteration's heavy
lifting is two jitted device programs:

  * ``_classify_and_align`` — centroid/boundary correspondences, per-patch
    LoD, stable/unstable classification, inner point-to-plane ICP, bounding
    -box convergence metric (Registration.cpp:735-888), all fused;
  * the stage-1 percentile C2C distance over the full clouds
    (Registration.cpp:905), via the NN kernel.

Static shapes: patch arrays are padded to ``patch_pad_multiple`` and point
arrays to ``point_pad_multiple`` buckets so recompilation across epoch pairs
is rare.

Reference semantics preserved:
  * per-patch LoD = clamp(1.96 sqrt(sigmaCT1(match)^2 + sigmaBP2^2),
    DTmin, 2 DTmin)                                 (Registration.cpp:751-766)
  * classification threshold max(currDT, LoD_i) applied to the centroid AND
    all six boundary-point point-to-plane distances, plus the point-to-point
    guard dist < currDT + SVres1 + SVres2           (Registration.cpp:817-861)
  * 3-stage DT schedule: stage 1 follows the 75th-percentile C2C distance,
    stage 2 decays geometrically with the bounding-box-change ratio clamped
    to [0.5, 0.8], stage 3 terminates at the minimum LoD
                                                    (Registration.cpp:891-935)
  * abort (typed error, not std::exit) when fewer than 4 stable patches
    remain                                          (Registration.cpp:864-867)
  * VCM from the final iteration's stable centroids (Registration.cpp:957-961)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import PiecewiseICPConfig
from ..ops.grid_nn import build_grid
from ..ops.preprocess import percentile_c2c
from ..ops.transform import apply_transform, masked_aabb, \
    bounding_box_corner_change
from ..utils.errors import DegenerateGeometryError
from ..utils.logging import gphase, log
from .icp import _masked_nn, compute_vcm, point_to_plane_icp
from .segmentation import PatchSet, build_patches


# Unresolved stable queries (true NN beyond the 27-cell window: the far
# points of misaligned early iterations) re-measured in-program by a
# chunked brute 1-NN.  Beyond this budget the host takes the exact brute
# percentile instead.
_PCT_RESCUE = 1024


def _bucket_size(n: int, base: int) -> int:
    """Power-of-two-ish bucket (base * 2^k >= n).

    Plain round-up-to-multiple padding gives every epoch of a campaign a
    unique array shape, and each unique shape recompiles the fused
    iteration step.  Power-of-two buckets land every epoch of a campaign
    in ONE executable.
    """
    b = base
    while b < n:
        b *= 2
    return b


def _pad(arr: np.ndarray, multiple: int, value=0.0) -> np.ndarray:
    n = arr.shape[0]
    target = _bucket_size(max(n, 1), multiple)
    if target == n:
        return arr
    pad = [(0, target - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=value)


def _mask(n: int, multiple: int) -> np.ndarray:
    target = _bucket_size(max(n, 1), multiple)
    m = np.zeros(target, dtype=bool)
    m[:n] = True
    return m


def _cell_order(points: np.ndarray, grid) -> np.ndarray:
    """Permutation sorting ``points`` by the linearised cell id of the
    given target :class:`GridIndex` (x-major, z fastest — the order
    ``build_grid`` sorts the targets themselves).  Stable, so re-sorting
    an already coherent cloud is a near-identity permutation."""
    cell = np.floor((np.asarray(points, np.float64) - grid.origin)
                    / grid.h).astype(np.int64)
    dx, dy, dz = grid.dims
    cx = np.clip(cell[:, 0], 0, dx - 1)
    cy = np.clip(cell[:, 1], 0, dy - 1)
    cz = np.clip(cell[:, 2], 0, dz - 1)
    return np.argsort((cx * dy + cy) * dz + cz, kind="stable")


@dataclasses.dataclass
class PairResult:
    """Outcome of one pairwise Piecewise-ICP registration."""

    trans_mat: np.ndarray      # 4x4 f64 — core transform (reduced frame)
    vcm: np.ndarray            # 6x6 f64
    dt_series: List[float]
    iterations: int
    stable_ratio: float        # stable / total patch points, last iteration
    num_patches: tuple         # (P1, P2)
    patches1: "PatchSet | None" = None
    patches2: "PatchSet | None" = None
    stable_point_mask: "np.ndarray | None" = None  # over patches2.points
    total_icp_iters: int = 0   # inner point-to-plane iterations, all outer
    sigma0: float = 0.0        # a-posteriori unit-weight std of the final
    #                            VCM fit (m) — convergence-quality signal
    final_n_stable: int = 0    # stable patches at the final iteration


@functools.partial(jax.jit,
                   static_argnames=("icp_max_iterations", "icp_variant",
                                    "icp_weighting", "axis_name"))
def _classify_and_align(ct1, n1, std_ct1, ct1_mask,
                        ct2, bp2, std_bp2, ct2_mask,
                        curr_dt, dt_min, max_lod, sv_sum,
                        icp_max_iterations: int = 100,
                        icp_trans_eps: float = 1e-8,
                        icp_fitness_eps: float = 1e-6,
                        n2=None, icp_variant: str = "reference",
                        icp_weighting: str = "uniform",
                        axis_name: str | None = None):
    """One fused classification + alignment step (device).

    With ``axis_name`` (inside ``shard_map``) the classification runs on
    the replicated patch arrays (identical on every chip) while the inner
    ICP shards the source-centroid rows across the mesh axis and
    ``psum``-reduces the 6x6 normal equations.

    Returns (T_icp 4x4, stable [P2] bool, LoDet_min, n_stable, icp_iters).
    """
    p2 = ct2.shape[0]
    f32 = ct1.dtype

    # (1) correspondences CT2→CT1 and BP2→CT1 (Registration.cpp:737-747)
    ct_idx, ct_dist = _masked_nn(ct2, ct2_mask, ct1, ct1_mask)
    bp2_mask = jnp.repeat(ct2_mask, 6)
    bp_idx, _ = _masked_nn(bp2, bp2_mask, ct1, ct1_mask)

    # (2) per-patch LoD (Registration.cpp:751-766)
    sig1 = std_ct1[ct_idx]
    lod = 1.96 * jnp.sqrt(sig1 * sig1 + std_bp2 * std_bp2)
    lod = jnp.clip(lod, dt_min, max_lod)
    lod_min = jnp.min(jnp.where(ct2_mask, lod, jnp.inf))

    # (3) point-to-plane distances against the MATCHED TARGET patch plane
    #     (Registration.cpp:779-812; patch normals cached, the reference
    #     recomputes them per correspondence)
    pt2pl_ct = jnp.abs(jnp.sum((ct1[ct_idx] - ct2) * n1[ct_idx], axis=1))
    pt2pl_bp = jnp.abs(jnp.sum((ct1[bp_idx] - bp2) * n1[bp_idx], axis=1))
    pt2pl_bp = pt2pl_bp.reshape(p2, 6)

    # (4) stable / unstable classification (Registration.cpp:817-861)
    thr = jnp.maximum(curr_dt, lod)
    ct_pass = pt2pl_ct <= thr
    bp_pass = jnp.all(pt2pl_bp <= thr[:, None], axis=1)
    ptpt_pass = ct_dist < curr_dt + sv_sum
    stable = ct2_mask & ct_pass & bp_pass & ptpt_pass
    n_stable = jnp.sum(stable)

    # (5) inner point-to-plane ICP: stable CT2 onto CT1-with-normals
    #     (Registration.cpp:874-877).  On a mesh, each chip takes its
    #     contiguous slice of the source rows; psum merges the normal
    #     equations inside point_to_plane_icp.
    src_ct, src_mask, src_n = ct2, stable, n2
    src_var = (std_bp2 * std_bp2
               if icp_weighting == "inverse_variance" else None)
    if axis_name is not None:
        n_dev = jax.lax.axis_size(axis_name)
        dev = jax.lax.axis_index(axis_name)
        rows = p2 // n_dev
        src_ct = jax.lax.dynamic_slice_in_dim(ct2, dev * rows, rows)
        src_mask = jax.lax.dynamic_slice_in_dim(stable, dev * rows, rows)
        if n2 is not None:
            src_n = jax.lax.dynamic_slice_in_dim(n2, dev * rows, rows)
        if src_var is not None:
            src_var = jax.lax.dynamic_slice_in_dim(src_var, dev * rows,
                                                   rows)
    t_icp, icp_iters = point_to_plane_icp(
        ct1, n1, ct1_mask, src_ct, src_mask,
        max_iterations=icp_max_iterations,
        transformation_eps=icp_trans_eps, fitness_eps=icp_fitness_eps,
        source_normals=src_n, symmetric=(icp_variant == "symmetric"),
        axis_name=axis_name,
        target_var=(std_ct1 * std_ct1 if src_var is not None else None),
        source_var=src_var)

    return t_icp, stable, lod_min.astype(f32), n_stable, icp_iters


@jax.jit
def _apply_state(t_icp, cloud2, ct2, bp2):
    """Apply the iteration transform to the source state
    (Registration.cpp:942-954)."""
    return (apply_transform(cloud2, t_icp), apply_transform(ct2, t_icp),
            apply_transform(bp2, t_icp))


@jax.jit
def _bb_change(cloud2, cloud2_mask, t_icp):
    bb_min, bb_max = masked_aabb(cloud2, cloud2_mask)
    return bounding_box_corner_change(bb_min, bb_max, t_icp)


@functools.partial(jax.jit,
                   static_argnames=("icp_max_iterations", "grid_max_run",
                                    "icp_variant", "icp_weighting",
                                    "axis_name"))
def _iteration_step(ct1, n1, std_ct1, ct1_mask,
                    ct2, n2, bp2, std_bp2, ct2_mask,
                    cloud2, cloud2_mask, labels2,
                    g_pts, g_starts, g_origin, g_dims, g_h,
                    curr_dt, dt_min, max_lod, sv_sum, bb_leaf,
                    percentile, need_percentile,
                    icp_max_iterations: int = 100,
                    grid_max_run: int = 32,
                    icp_trans_eps: float = 1e-8,
                    icp_fitness_eps: float = 1e-6,
                    icp_variant: str = "reference",
                    icp_weighting: str = "uniform",
                    axis_name: str | None = None):
    """One COMPLETE Piecewise-ICP iteration as a single device program.

    Fuses classification + inner ICP + bounding-box metric + stage-1
    percentile (grid NN against the static cloud1 index) + state update, so
    the host pays one dispatch and one fetch per iteration instead of
    five.

    ``need_percentile`` (traced bool) skips the percentile work via
    ``lax.cond`` once the DT schedule has left stage 1.

    This SAME body is the multi-chip step: ``parallel.sharded`` wraps it in
    ``shard_map`` with ``axis_name`` set, the full clouds sharded along the
    point axis and patch arrays replicated.  The collective points are the
    inner-ICP psum (inside :func:`_classify_and_align`), the all_gather of
    per-shard percentile distances, pmin/pmax of the bounding box and the
    psum of stable-point counts — so single-device and mesh semantics can
    never drift apart.
    """
    from ..ops.grid_nn import grid_query_1nn

    t_icp, stable, lod_min, n_stable, icp_iters = _classify_and_align(
        ct1, n1, std_ct1, ct1_mask, ct2, bp2, std_bp2, ct2_mask,
        curr_dt, dt_min, max_lod, sv_sum,
        icp_max_iterations=icp_max_iterations,
        icp_trans_eps=icp_trans_eps, icp_fitness_eps=icp_fitness_eps,
        n2=n2, icp_variant=icp_variant, icp_weighting=icp_weighting,
        axis_name=axis_name)

    # bounding-box corner change (Registration.cpp:880-888).  The
    # reference reads the box from a pcl::octree with leaf 2*Res2
    # (Registration.cpp:882-886) whose region is CUBIC with a power-of-two
    # side — larger than the tight AABB, making the corner-displacement
    # metric more conservative and the stage-1 phase correspondingly
    # longer.  Reproduce that box: side = leaf * 2^ceil(log2(extent/leaf)).
    bb_min, bb_max = masked_aabb(cloud2, cloud2_mask)
    if axis_name is not None:
        bb_min = jax.lax.pmin(bb_min, axis_name)
        bb_max = jax.lax.pmax(bb_max, axis_name)
    extent = jnp.max(bb_max - bb_min)
    leaf = jnp.maximum(bb_leaf, 1e-9)
    side = leaf * jnp.exp2(jnp.ceil(jnp.log2(
        jnp.maximum(extent / leaf, 1.0))))
    max_bb = bounding_box_corner_change(bb_min, bb_min + side, t_icp)

    # stable patch points of PC2 (pre-transform), for the stage-1 percentile
    safe_lab = jnp.clip(labels2, 0, stable.shape[0] - 1)
    pt_stable = cloud2_mask & (labels2 >= 0) & stable[safe_lab]

    def compute_percentile(_):
        _, d, resolved = grid_query_1nn(
            cloud2, pt_stable, g_pts, g_starts,
            g_origin, g_dims, grid_max_run, g_h)
        # In-program exact rescue of unresolved stable queries (true NN
        # beyond the 27-cell window — the badly-misaligned first
        # iterations): up to _PCT_RESCUE of them are re-measured by a
        # chunked brute 1-NN against the full target (always on, so no
        # lax.cond compiles a second heavy branch).  With every unresolved
        # query rescued, ALL stable distances are exact; the host brute
        # fallback is the safety net for more than _PCT_RESCUE.
        bad = pt_stable & jnp.logical_not(resolved)
        n_bad = jnp.sum(bad)
        order = jnp.argsort(jnp.logical_not(bad), stable=True)
        u = min(_PCT_RESCUE, cloud2.shape[0])   # shard may be smaller
        up = -(-u // 512) * 512
        sel = order[:u]
        qsel = cloud2[sel]
        if up > u:
            qsel = jnp.pad(qsel, ((0, up - u), (0, 0)))

        def chunk_min(qc):
            d2 = jnp.zeros((qc.shape[0], g_pts.shape[0]), qc.dtype)
            for c in range(3):
                diff = qc[:, c][:, None] - g_pts[None, :, c]
                d2 = d2 + diff * diff
            return jnp.min(d2, axis=1)

        d2min = jax.lax.map(
            chunk_min, qsel.reshape(up // 512, 512, 3)).reshape(-1)[:u]
        d = d.at[sel].set(jnp.where(bad[sel],
                                    jnp.sqrt(jnp.maximum(d2min, 0.0)),
                                    d[sel]))
        rescued_all = n_bad <= u
        # only the first u bad queries are re-measured; entries past the
        # budget keep their window-truncated overestimate and must NOT
        # count as exact (else `idx < n_resolved` could certify an
        # inexact d75 in the heavy-misalignment regime it guards)
        rank = jnp.cumsum(bad) - 1
        rescued = bad & (rank < u)
        ok = resolved | (~pt_stable) | rescued
        d_ok = jnp.where(ok, d, jnp.inf)
        if axis_name is None:
            d_all, stable_n = d_ok, jnp.sum(pt_stable)
            n_resolved = jnp.sum(ok & pt_stable)
        else:
            # per-shard grid query + rescue, then one all_gather for the
            # global order statistic (the only O(N) collective/iteration)
            d_all = jax.lax.all_gather(d_ok, axis_name, tiled=True)
            stable_n = jax.lax.psum(jnp.sum(pt_stable), axis_name)
            n_resolved = jax.lax.psum(jnp.sum(ok & pt_stable), axis_name)
            rescued_all = jax.lax.psum(
                1 - rescued_all.astype(jnp.int32), axis_name) == 0
        idx = jnp.clip((stable_n * percentile).astype(jnp.int32), 0,
                       d_all.shape[0] - 1)
        d_grid = jnp.sort(d_all)[idx]
        # exact when every unresolved stable query was rescued (then all
        # stable distances are true distances), OR by the dichotomy
        # argument (unresolved distances exceed every resolved one, so an
        # index inside the resolved block is exact)
        return (d_grid, rescued_all | (idx < n_resolved),
                n_bad.astype(ct1.dtype))

    d75, d75_exact, pct_bad = jax.lax.cond(
        need_percentile, compute_percentile,
        lambda _: (jnp.asarray(jnp.inf, ct1.dtype), jnp.asarray(True),
                   jnp.asarray(0.0, ct1.dtype)),
        operand=None)

    # apply transform to the source state (Registration.cpp:942-954);
    # source patch normals rotate with the rigid motion
    new_cloud2 = apply_transform(cloud2, t_icp)
    new_ct2 = apply_transform(ct2, t_icp)
    new_bp2 = apply_transform(bp2, t_icp)
    new_n2 = jnp.matmul(n2, t_icp[:3, :3].T, precision="highest")
    n_pt_stable = jnp.sum(pt_stable)
    if axis_name is not None:
        n_pt_stable = jax.lax.psum(n_pt_stable, axis_name)
    # pack the transform and every per-iteration scalar into ONE array so
    # the host pays a single device→host fetch per iteration
    f32 = ct1.dtype
    stats = jnp.concatenate([
        t_icp.reshape(-1),
        jnp.stack([lod_min.astype(f32), n_stable.astype(f32),
                   icp_iters.astype(f32), max_bb.astype(f32),
                   d75.astype(f32), d75_exact.astype(f32),
                   n_pt_stable.astype(f32), pct_bad.astype(f32)])])
    return (stats, stable, pt_stable, new_cloud2, new_ct2, new_bp2,
            new_n2)


def _host_nn(targets: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """NN match over patch centroids on host (scipy tree when available;
    the dense [P2, P1, 3] broadcast costs ~90 ms at 2k x 2k)."""
    try:
        from scipy.spatial import cKDTree
        return cKDTree(targets).query(queries)[1]
    except ImportError:  # pragma: no cover
        d2 = ((queries[:, None, :] - targets[None, :, :]) ** 2).sum(-1)
        return np.argmin(d2, axis=1)


def _robust_refine(ct1h: np.ndarray, n1h: np.ndarray, m1h: np.ndarray,
                   ct2h: np.ndarray, stableh: np.ndarray,
                   p1: int, p2: int, min_keep: int,
                   c_mult: float = 4.685, iters: int = 10):
    """Tukey M-estimator refinement of the final stable-centroid solve.

    Sub-LoD changed surface leaks through the DT/LoD classification (its
    displacement sits below the 4 mm floor) and biases the final
    least-squares fit; because the fit absorbs part of the leak, post-fit
    residual screening cannot separate it (measured corr(z, true change)
    0.06-0.24 on the hard synthetic pairs).  A redescending M-estimator
    resists it instead: IRLS with the Tukey biweight (c = 4.685 sigma_MAD,
    the 95%-efficiency constant) converges to the unchanged majority and
    zero-weights coherent outliers.  Host float64 — P ~ 2k rows.

    Returns (t_corr 4x4 f64, keep [P2pad] bool of surviving patches) or
    None when degenerate.
    """
    valid1 = np.flatnonzero(m1h[:ct1h.shape[0]])
    if p1:
        valid1 = valid1[valid1 < p1]
    s_idx = np.flatnonzero(stableh)
    s_idx = s_idx[s_idx < p2]
    ns = len(s_idx)
    if ns < max(min_keep * 2, 12) or len(valid1) == 0:
        return None

    c1 = ct1h[valid1].astype(np.float64)
    c2 = ct2h[s_idx].astype(np.float64)
    j = _host_nn(c1, c2)
    p = c1[j]
    nrm = n1h[valid1][j].astype(np.float64)

    t_total = np.eye(4)
    q = c2
    w = np.ones(ns)
    for _ in range(iters):
        # linearized p2pl rows at the current state
        a = np.column_stack([
            nrm[:, 2] * q[:, 1] - nrm[:, 1] * q[:, 2],
            nrm[:, 0] * q[:, 2] - nrm[:, 2] * q[:, 0],
            nrm[:, 1] * q[:, 0] - nrm[:, 0] * q[:, 1],
            nrm[:, 0], nrm[:, 1], nrm[:, 2]])
        r = np.einsum("ij,ij->i", nrm, p - q)
        sigma = 1.4826 * np.median(np.abs(r - np.median(r)))
        c_t = c_mult * max(sigma, 1e-9)
        u = np.clip(r / c_t, -1.0, 1.0)
        w = (1.0 - u * u) ** 2
        aw = a * w[:, None]
        ata = aw.T @ a
        atl = aw.T @ r
        try:
            x = np.linalg.solve(ata + 1e-12 * np.eye(6), atl)
        except np.linalg.LinAlgError:
            return None
        from ..ops.transform import params_to_matrix
        t_d = params_to_matrix(x)
        q = q @ t_d[:3, :3].T + t_d[:3, 3]
        t_total = t_d @ t_total
        if np.abs(x).max() < 1e-10:
            break

    keep_local = w > 0.05          # Tukey zero-weight = rejected
    n_keep = int(keep_local.sum())

    # VCMs directly from the final rows (reference formula,
    # Registration.cpp:1322-1335) — saves the separate compute_vcm device
    # dispatch + fetch the loop used to pay.  Both the SCREENED (refine
    # accepted) and UNSCREENED (reference-semantics fallback) variants
    # come from the same row set.
    a_f = np.column_stack([
        nrm[:, 2] * q[:, 1] - nrm[:, 1] * q[:, 2],
        nrm[:, 0] * q[:, 2] - nrm[:, 2] * q[:, 0],
        nrm[:, 1] * q[:, 0] - nrm[:, 0] * q[:, 1],
        nrm[:, 0], nrm[:, 1], nrm[:, 2]])
    r_f = np.einsum("ij,ij->i", nrm, p - q)

    def _vcm_of(sel: np.ndarray):
        a_k, r_k = a_f[sel], r_f[sel]
        ata = a_k.T @ a_k
        if abs(np.linalg.det(ata)) < 1e-9:
            log.warning("VCM normal matrix is near-singular")
            return None, None
        qxx = np.linalg.inv(ata)
        x_k = qxx @ (a_k.T @ r_k)
        v = a_k @ x_k - r_k
        s0 = float(v @ v) / max(int(sel.sum()) - 6, 1)
        return s0 * qxx, s0

    # unscreened VCM of the pre-refine state: rows at the pre-refine
    # geometry (the reference computes its VCM there too)
    q0 = c2
    a_0 = np.column_stack([
        nrm[:, 2] * q0[:, 1] - nrm[:, 1] * q0[:, 2],
        nrm[:, 0] * q0[:, 2] - nrm[:, 2] * q0[:, 0],
        nrm[:, 1] * q0[:, 0] - nrm[:, 0] * q0[:, 1],
        nrm[:, 0], nrm[:, 1], nrm[:, 2]])
    r_0 = np.einsum("ij,ij->i", nrm, p - q0)
    ata0 = a_0.T @ a_0
    try:
        qxx0 = np.linalg.inv(ata0)
    except np.linalg.LinAlgError:
        return None
    x0 = qxx0 @ (a_0.T @ r_0)
    v0 = a_0 @ x0 - r_0
    s0_all = float(v0 @ v0) / max(ns - 6, 1)
    vcm_all = s0_all * qxx0

    if n_keep < max(min_keep, int(0.3 * ns)):
        # degenerate screen: no correction, reference-semantics VCM only
        return None, None, None, None, vcm_all, s0_all
    keep = stableh.copy()
    keep[s_idx[~keep_local]] = False
    vcm_k, s0_k = _vcm_of(keep_local)
    if vcm_k is None:
        return None, None, None, None, vcm_all, s0_all
    return t_total, keep, vcm_k, s0_k, vcm_all, s0_all


def _change_screen(ct1h: np.ndarray, n1h: np.ndarray, m1h: np.ndarray,
                   ct2h: np.ndarray, stableh: np.ndarray,
                   patches1: PatchSet, patches2: PatchSet,
                   k: int, z_thd: float, min_keep: int
                   ) -> np.ndarray | None:
    """Detect sub-LoD changed surface among the converged stable patches.

    A stable patch on truly unchanged surface has a signed point-to-plane
    residual that is zero-mean NOISE, independent of its neighbours; a
    patch on sub-LoD changed surface shares its displacement sign and
    magnitude with the neighbouring patches of the same change region.
    Standardize the signed residuals (robust self-calibration — the
    per-patch noise model need not be trusted), average each over its k
    nearest stable patches, and flag coherent offsets above the noise
    quantile (mean of k unit-normals has std 1/sqrt(k)).

    Returns the screened patch-level keep mask ([P2pad] bool), or None
    when nothing is excluded / the screen would be degenerate.
    """
    p1 = patches1.num_patches
    p2 = patches2.num_patches
    valid1 = np.flatnonzero(m1h[:ct1h.shape[0]])
    valid1 = valid1[valid1 < p1] if p1 else valid1
    s_idx = np.flatnonzero(stableh)
    s_idx = s_idx[s_idx < p2]
    ns = len(s_idx)
    if ns < max(min_keep * 2, 12) or len(valid1) == 0:
        return None

    c1 = ct1h[valid1].astype(np.float64)
    c2 = ct2h[s_idx].astype(np.float64)
    j = _host_nn(c1, c2)
    nmatch = n1h[valid1][j].astype(np.float64)
    signed = np.einsum("ij,ij->i", c2 - c1[j], nmatch)

    se = np.sqrt(
        (patches1.std_bp[valid1][j] ** 2
         / np.maximum(patches1.counts[valid1][j], 1))
        + (patches2.std_bp[s_idx] ** 2
           / np.maximum(patches2.counts[s_idx], 1)))
    z = signed / np.maximum(se, 1e-12)
    med = np.median(z)
    mad = np.median(np.abs(z - med)) * 1.4826
    z = (z - med) / max(mad, 1e-12)

    kk = min(k, ns)
    nb = np.argpartition(
        ((c2[:, None, :] - c2[None, :, :]) ** 2).sum(-1), kk - 1,
        axis=1)[:, :kk]
    z_bar = z[nb].mean(axis=1)
    changed = np.abs(z_bar) > z_thd / np.sqrt(kk)

    import os as _os
    dump = _os.environ.get("PWICP_SCREEN_DUMP")
    if dump:  # diagnostic: per-patch screen state for offline analysis
        np.savez(dump, pos=c2, signed=signed, se=se, z=z, z_bar=z_bar,
                 changed=changed, match_pos=c1[j])
    n_changed = int(changed.sum())
    if n_changed == 0:
        return None
    n_keep = ns - n_changed
    if n_keep < max(min_keep, int(0.3 * ns)):
        log.info("change screen: %d/%d patches flagged — too many to "
                 "refit safely, keeping the unscreened solution",
                 n_changed, ns)
        return None
    keep = stableh.copy()
    keep[s_idx[changed]] = False
    return keep


def piecewise_icp(cloud1: np.ndarray, cloud2: np.ndarray,
                  res1: float, res2: float,
                  cfg: Optional[PiecewiseICPConfig] = None,
                  patches1: Optional[PatchSet] = None,
                  patches2: Optional[PatchSet] = None,
                  mesh=None,
                  lattice_shift: np.ndarray | None = None,
                  lattice_offset: np.ndarray | None = None) -> PairResult:
    """Register preprocessed ``cloud2`` onto ``cloud1`` (both centroid-
    reduced, host float32 arrays).

    Mirrors ``Piecewise_ICP`` (Registration.cpp:618-700): auto DT-init,
    supervoxel sizing, patch generation, then the staged iteration loop.

    With ``mesh`` (a 1-D ``jax.sharding.Mesh``), the FULL staged loop runs
    multi-chip: clouds point-sharded across the mesh axis, patch arrays
    replicated, every iteration one shard_map program with psum-reduced
    normal equations (see ``parallel.sharded``).  Semantics are identical
    to the single-device path — it is the same iteration body.
    """
    cfg = cfg or PiecewiseICPConfig()

    # --- initial DT (Registration.cpp:627-631) ---
    if cfg.set_dtinit:
        curr_dt = float(cfg.dt_init)
    else:
        d75 = float(percentile_c2c(jnp.asarray(cloud1), jnp.asarray(cloud2),
                                   cfg.dtinit_percentile))
        curr_dt = d75 * cfg.dtinit_mult
    log.info("DT initial value = %g m", curr_dt)

    # --- supervoxel sizes (Registration.cpp:635-640) ---
    sv1 = cfg.svsize1 if cfg.set_res_svsize else res1 * cfg.sv_size_res_mult
    sv2 = cfg.svsize2 if cfg.set_res_svsize else res2 * cfg.sv_size_res_mult

    # --- patch generation (Registration.cpp:653-664) ---
    if patches1 is None:
        patches1 = build_patches(cloud1, sv1, cfg, resolution=res1,
                                 lattice_shift=lattice_shift,
                                 lattice_offset=lattice_offset)
    if patches2 is None:
        patches2 = build_patches(cloud2, sv2, cfg, resolution=res2,
                                 lattice_shift=lattice_shift,
                                 lattice_offset=lattice_offset)
    p1, p2 = patches1.num_patches, patches2.num_patches
    log.info("selected patches: PC1=%d PC2=%d", p1, p2)
    if p2 < cfg.min_stable_patches or p1 < cfg.min_stable_patches:
        raise DegenerateGeometryError(
            f"not enough patches: PC1={p1}, PC2={p2} (<4)")

    pm, cm = cfg.patch_pad_multiple, cfg.point_pad_multiple
    if mesh is not None:
        # pad so patch rows and point shards divide evenly across the mesh
        n_dev = int(mesh.devices.size)
        pm = int(np.lcm(pm, n_dev))
        cm = int(np.lcm(cm, n_dev))
        from ..parallel.sharded import point_sharded, replicated
        axis = mesh.axis_names[0]
        repl = functools.partial(replicated, mesh)
        shard = functools.partial(point_sharded, mesh, axis=axis)
    else:
        repl = shard = jnp.asarray

    # device-resident static target state (replicated on a mesh)
    ct1 = repl(_pad(patches1.centroids, pm))
    n1 = repl(_pad(patches1.normals, pm))
    std_ct1 = repl(_pad(patches1.std_ct, pm))
    ct1_mask = repl(_mask(p1, pm))
    cloud1_j = jnp.asarray(_pad(patches1.points, cm))
    cloud1_mask = jnp.asarray(_mask(patches1.points.shape[0], cm))
    # static target grid for the stage-1 percentile NN (cloud1 never moves);
    # grid arrays uploaded once, reused by every fused iteration step
    cloud1_grid = build_grid(patches1.points, h=max(4.0 * res1, 1e-6))
    g_pts = repl(jnp.asarray(cloud1_grid.points))
    g_starts = repl(jnp.asarray(cloud1_grid.cell_starts))
    g_origin = repl(jnp.asarray(cloud1_grid.origin))
    g_dims = repl(jnp.asarray(cloud1_grid.dims, jnp.int32))
    g_h = repl(jnp.asarray(cloud1_grid.h, jnp.float32))

    # device-resident mutable source state (clouds point-sharded on a mesh)
    ct2 = repl(_pad(patches2.centroids, pm))
    n2 = repl(_pad(patches2.normals, pm))
    bp2 = repl(_pad(patches2.boundary.reshape(-1, 3), 6 * pm))
    std_bp2 = repl(_pad(patches2.std_bp, pm))
    ct2_mask = repl(_mask(p2, pm))
    # keep the mutable source cloud in TARGET-grid cell order: neighbouring
    # queries then read neighbouring candidate runs of the stage-1
    # percentile's grid query, and nothing else cares about point order
    # inside the loop (the percentile sorts distances, the AABB is
    # order-free, masks ride along) — one O(N) host permutation here, one
    # inverse permutation on the returned stable mask below
    c2_perm = _cell_order(patches2.points, cloud1_grid)
    cloud2_j = shard(_pad(patches2.points[c2_perm], cm))
    cloud2_mask = shard(_mask(patches2.points.shape[0], cm))
    labels2 = _pad(patches2.labels[c2_perm], cm, value=-1)
    labels2_j = shard(labels2)

    dt_min = float(cfg.dt_min)
    max_lod = dt_min * cfg.lod_max_ratio
    sv_sum = float(sv1 + sv2)

    # grid_max_run is a STATIC jit arg; build_grid buckets it to a power
    # of two, so per-epoch occupancy jitter stays inside one executable
    step_max_run = cloud1_grid.max_run

    # The symmetric point-to-plane objective is a REFINEMENT objective: its
    # bisector residual assumes the matched normals describe the same
    # surface, which only holds once DT is small.  During the coarse
    # stage-1 iterations (large DT, imprecise correspondences) it picks up
    # lateral-offset bias, so the staged loop always starts with the
    # reference objective and switches variants at the stage-2 transition.
    def _make_step(variant: str):
        if mesh is not None:
            from ..parallel.sharded import build_sharded_iteration
            return build_sharded_iteration(
                mesh, mesh.axis_names[0],
                icp_max_iterations=cfg.icp_max_iterations,
                grid_max_run=step_max_run,
                icp_trans_eps=cfg.icp_transformation_eps,
                icp_fitness_eps=cfg.icp_fitness_eps,
                icp_variant=variant, icp_weighting=cfg.icp_weighting)
        return functools.partial(
            _iteration_step,
            icp_max_iterations=cfg.icp_max_iterations,
            grid_max_run=step_max_run,
            icp_trans_eps=cfg.icp_transformation_eps,
            icp_fitness_eps=cfg.icp_fitness_eps,
            icp_variant=variant, icp_weighting=cfg.icp_weighting)

    step_fn = _make_step("reference")
    step_fn_fine = (step_fn if cfg.icp_variant == "reference"
                    else _make_step(cfg.icp_variant))

    trans_mat = np.eye(4, dtype=np.float64)
    dt_series = [curr_dt]
    to_stage2 = to_stage3 = False
    bb1 = bb2 = 0.0
    vcm = np.zeros((6, 6))
    sigma0_sq = 0.0
    stable_ratio = 0.0
    iteration = 0
    total_icp_iters = 0
    max_outer = 100  # hard cap; the reference loop is unbounded

    while not to_stage3:
        iteration += 1
        if curr_dt <= dt_min:  # DT floor (Registration.cpp:724-725)
            curr_dt = dt_min

        with gphase("core.iteration"):
            (stats_j, stable, pt_stable_j, new_cloud2, new_ct2,
             new_bp2, new_n2) = (step_fn_fine if to_stage2 else step_fn)(
                ct1, n1, std_ct1, ct1_mask, ct2, n2, bp2, std_bp2,
                ct2_mask, cloud2_j, cloud2_mask, labels2_j,
                g_pts, g_starts, g_origin, g_dims, g_h,
                jnp.asarray(curr_dt, jnp.float32),
                jnp.asarray(dt_min, jnp.float32),
                jnp.asarray(max_lod, jnp.float32),
                jnp.asarray(sv_sum, jnp.float32),
                jnp.asarray(2.0 * res2, jnp.float32),
                jnp.asarray(cfg.dtinit_percentile, jnp.float32),
                jnp.asarray(not to_stage2))
            stats = np.asarray(stats_j, dtype=np.float64)

        t_icp = stats[:16].reshape(4, 4)
        (lod_min, n_stable, icp_iters, max_bb, d75, d75_exact,
         n_pt_stable, pct_bad) = stats[16:24]
        n_stable = int(n_stable)
        icp_iters = int(icp_iters)
        total_icp_iters += icp_iters
        if n_stable < cfg.min_stable_patches:
            raise DegenerateGeometryError(
                f"only {n_stable} stable patches left — not enough "
                f"overlapping area (iteration {iteration})")

        # only this one packed array is fetched per iteration; the
        # boolean masks stay device-resident until the final iteration
        n_patch_pts = int((labels2 >= 0).sum())
        stable_ratio = int(n_pt_stable) / max(n_patch_pts, 1)

        # ---- stage transitions (Registration.cpp:891-935) ----
        if (not to_stage2) and max_bb < dt_min:
            to_stage2 = True
            log.info("DT changed to Stage 2 (BB %g < minLoD)", max_bb)
        elif curr_dt <= lod_min * (1 + 1e-6):
            to_stage3 = True
            log.info("DT changed to Stage 3 (End)")

        if not to_stage2:
            if pct_bad > 0:
                log.info("percentile: %d unresolved stable queries "
                         "rescued in-program (exact=%s)", int(pct_bad),
                         bool(d75_exact))
            if not bool(d75_exact):
                # heavy misalignment: exact percentile via the brute path.
                # On a mesh the sharded arrays are gathered to host first —
                # this path fires at most once per pair (first iterations of
                # a badly misaligned pair), so simplicity beats a sharded
                # brute kernel here.
                with gphase("core.percentile_exact"):
                    from ..parallel.distributed import fetch
                    c2_full = jnp.asarray(fetch(cloud2_j)) \
                        if mesh is not None else cloud2_j
                    s_full = jnp.asarray(fetch(pt_stable_j))
                    d75 = float(percentile_c2c(
                        cloud1_j, c2_full, cfg.dtinit_percentile,
                        t_mask=cloud1_mask, s_mask=s_full))
            else:
                d75 = float(d75)
            if curr_dt > d75:
                curr_dt = d75  # monotone decrease via percentile
            else:
                to_stage2 = True
                log.info("DT changed to Stage 2 (percentile stalled)")
            if curr_dt <= lod_min:
                curr_dt = lod_min
            bb2, bb1 = bb1, max_bb
        if to_stage2 and not to_stage3:
            alpha = abs(bb1 / bb2) if bb2 != 0.0 else float("inf")
            if not np.isfinite(alpha):
                curr_dt *= cfg.dt_decay_hi
            else:
                curr_dt *= min(max(alpha, cfg.dt_decay_lo), cfg.dt_decay_hi)
            if curr_dt <= lod_min:
                curr_dt = lod_min
            bb2, bb1 = bb1, max_bb

        # ---- final-iteration VCM, from PRE-transform stable centroids
        #      (Registration.cpp:957-961).  Skipped when the robust
        #      refinement below recomputes it from its own rows (the
        #      refine supersedes this VCM whenever it succeeds; on its
        #      rare degenerate bail-out the fallback below recomputes). --
        _refine_will_run = cfg.robust_refine in (True, "always", "auto")
        if (to_stage3 or iteration >= max_outer) \
                and not (_refine_will_run and to_stage3):
            with gphase("core.vcm"):
                # one batched fetch instead of five
                vcm, _, sigma0_sq = compute_vcm(*jax.device_get(
                    (ct1, n1, ct1_mask, ct2, stable)))

        # ---- adopt the transformed state (computed inside the fused step,
        #      Registration.cpp:942-954) ----
        cloud2_j, ct2, bp2, n2 = new_cloud2, new_ct2, new_bp2, new_n2
        trans_mat = np.asarray(t_icp, dtype=np.float64) @ trans_mat
        dt_series.append(curr_dt)

        log.info("iter %d | DT=%.4f cm | stable=%d/%d (%.1f%% pts) | "
                 "BB=%.4g | icp_iters=%d | s2=%s s3=%s",
                 iteration, curr_dt * 100, n_stable, p2,
                 100 * stable_ratio, max_bb, int(icp_iters),
                 to_stage2, to_stage3)

        if iteration >= max_outer and not to_stage3:
            log.warning("DT schedule did not reach stage 3 in %d iterations;"
                        " terminating", max_outer)
            break

    # ---- robust final refinement / change screen (beyond-reference;
    #      VERDICT r4 item 9).  Sub-LoD changed surface passes the DT/LoD
    #      classification (its displacement sits below the 4 mm floor) and
    #      biases the final least-squares solve; re-estimate it robustly
    #      (Tukey IRLS) so the leaked patches are zero-weighted, then
    #      recompute the VCM on the surviving set. ----
    rr_mode = cfg.robust_refine
    do_refine = rr_mode in (True, "always", "auto")
    if (do_refine or cfg.change_screen) and to_stage3:
        ct1h, n1h, m1h, ct2h, stableh = jax.device_get(
            (ct1, n1, ct1_mask, ct2, stable))
        with gphase("core.refine"):
            t_corr, keep = None, None
            vcm_refined = None
            if do_refine:
                rr = _robust_refine(ct1h, n1h, m1h, ct2h, stableh,
                                    p1, p2,
                                    min_keep=cfg.min_stable_patches)
                if rr is None:
                    # refine bailed out (degenerate); recover the
                    # reference VCM the loop skipped
                    vcm, _, sigma0_sq = compute_vcm(ct1h, n1h, m1h,
                                                    ct2h, stableh)
                else:
                    (t_c, kp, vcm_k, s0_k, vcm_all, s0_all) = rr
                    accept = t_c is not None
                    if accept and rr_mode == "auto":
                        # accept only a SIGNIFICANT correction: z of the
                        # correction params against the refined VCM, or
                        # a guard-flagged (suspect) pair.  Healthy pairs
                        # keep exact reference-semantics estimates (the
                        # always-on refine's sub-sigma nudges measurably
                        # accumulated through campaign chaining), while
                        # compact strong change regions — the rockfall
                        # scar — still trigger (z >> 2 there).
                        from ..ops.transform import matrix_to_angles
                        dp = np.concatenate([matrix_to_angles(t_c),
                                             t_c[:3, 3]])
                        z_corr = float(np.max(
                            np.abs(dp) / np.sqrt(np.maximum(
                                np.diag(vcm_k), 1e-24))))
                        accept = (z_corr > 2.0
                                  or stable_ratio < cfg.guard_stable_ratio)
                        if not accept:
                            log.info("robust refine: correction not "
                                     "significant (z=%.1f) — keeping the "
                                     "reference-semantics solution",
                                     z_corr)
                    if accept:
                        t_corr, keep = t_c, kp
                        vcm_refined, sigma0_sq = vcm_k, s0_k
                    else:
                        vcm, sigma0_sq = vcm_all, s0_all
            elif cfg.change_screen:
                keep = _change_screen(
                    ct1h, n1h, m1h, ct2h, stableh, patches1, patches2,
                    k=cfg.change_screen_k, z_thd=cfg.change_screen_z,
                    min_keep=cfg.min_stable_patches)
                if keep is not None:
                    t_icp_corr, _ = point_to_plane_icp(
                        jnp.asarray(ct1h), jnp.asarray(n1h),
                        jnp.asarray(m1h), jnp.asarray(ct2h),
                        jnp.asarray(keep),
                        max_iterations=cfg.icp_max_iterations,
                        transformation_eps=cfg.icp_transformation_eps,
                        fitness_eps=cfg.icp_fitness_eps)
                    t_corr = np.asarray(t_icp_corr, dtype=np.float64)
            if t_corr is not None and keep is not None:
                trans_mat = t_corr @ trans_mat
                if vcm_refined is not None:
                    vcm = vcm_refined
                else:
                    vcm, _, sigma0_sq = compute_vcm(ct1h, n1h, m1h,
                                                    ct2h, keep)
                stable = jnp.asarray(keep)
                n_excl = int(stableh.sum()) - int(keep.sum())
                n_stable = int(keep.sum())
                # per-point stability follows the refined patch set
                safe_lab2 = np.clip(labels2, 0, keep.shape[0] - 1)
                pt_np = (labels2 >= 0) & keep[safe_lab2]
                pt_stable_j = jnp.asarray(pt_np)
                n_patch_pts = int((labels2 >= 0).sum())
                stable_ratio = int(pt_np.sum()) / max(n_patch_pts, 1)
                log.info("robust refine: %d/%d stable patches rejected "
                         "(sub-LoD change), |dT|=%.3g mm",
                         n_excl, n_excl + n_stable,
                         1e3 * float(np.linalg.norm(t_corr[:3, 3])))

    n2 = patches2.points.shape[0]
    # the loop ran in cell-sorted order; hand the mask back in ORIGINAL
    # point order (sorted position i holds original index c2_perm[i])
    from ..parallel.distributed import fetch
    stable_mask = np.empty(n2, dtype=bool)
    stable_mask[c2_perm] = fetch(pt_stable_j)[:n2]
    return PairResult(trans_mat=trans_mat, vcm=vcm, dt_series=dt_series,
                      iterations=iteration, stable_ratio=stable_ratio,
                      num_patches=(p1, p2), patches1=patches1,
                      patches2=patches2,
                      stable_point_mask=stable_mask,
                      total_icp_iters=total_icp_iters,
                      sigma0=float(np.sqrt(max(sigma0_sq, 0.0))),
                      final_n_stable=int(n_stable))
