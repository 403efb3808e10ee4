"""Pairwise registration — public API layer.

Mirrors ``PiecewiseICP_pair_call`` (Registration.cpp:219-398) and the shared
per-pair body ``Piecewise_ICP_4D`` (Registration.cpp:402-548): preprocess,
centroid-reduce, run the core, de-reduce the transform, write reports.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import PiecewiseICPConfig
from ..io import formats, read_pcd, write_pcd
from ..ops.preprocess import estimate_resolution, preprocess_cloud
from ..ops.transform import (apply_transform_np, matrix_to_angles,
                             matrix_to_params_gon, translation_matrix)
from ..utils.errors import PwICPError
from ..utils.logging import PhaseTimer, log
from .piecewise_icp import PairResult, piecewise_icp

ARC_TO_MGON = 1000.0 * 200.0 / np.pi   # rad -> milligon


@dataclasses.dataclass
class TargetState:
    """Preprocessed + segmented target cloud, reusable across pairs.

    In a 4D campaign the same target epoch serves many source epochs
    (adaptive/fixed/direct pair plans), and everything target-side —
    preprocessing, the centroid-reduction shift (a function of the target
    alone, Registration.cpp:277-283) and the patch decomposition — is
    identical for each of them.  The reference recomputes all of it per
    pair; caching it nearly halves campaign time.
    """

    shift: np.ndarray          # [3] f64 reduction shift (-centroid of prep1)
    reduced_points: np.ndarray  # [N1, 3] f32, reduced frame
    patches: object            # PatchSet of the reduced target
    resolution: float


def prepare_target(points1: np.ndarray, cfg: PiecewiseICPConfig,
                   sor_mult: float, resolution: float | None = None,
                   lattice_offset: np.ndarray | None = None,
                   prep_state: "TargetState | None" = None) -> TargetState:
    """Preprocess + segment the target cloud once (reduced frame).

    ``prep_state``: a previous TargetState of the SAME cloud — reuses its
    preprocessing/shift and only re-segments (the acceptance guard's
    lattice re-roll path).
    """
    from .segmentation import build_patches

    if prep_state is not None:
        res1, shift = prep_state.resolution, prep_state.shift
        red1 = prep_state.reduced_points
    else:
        res1 = resolution if resolution is not None else cfg.res1
        if not cfg.set_res_svsize and resolution is None:
            res1 = estimate_resolution(jnp.asarray(points1))
        prep1 = preprocess_cloud(points1, res1, cfg.sor_neighbors, sor_mult)
        shift = -prep1.astype(np.float64).mean(axis=0)
        red1 = (prep1.astype(np.float64) + shift).astype(np.float32)
    sv1 = cfg.svsize1 if cfg.set_res_svsize else res1 * cfg.sv_size_res_mult
    # the reduction shift maps world -> this frame: anchoring the seed
    # lattice through it keeps every epoch on ONE world voxelisation
    patches = build_patches(red1, sv1, cfg, resolution=res1,
                            lattice_shift=shift,
                            lattice_offset=lattice_offset)
    return TargetState(shift=shift, reduced_points=red1, patches=patches,
                       resolution=res1)


@dataclasses.dataclass
class RegistrationOutput:
    """Full pairwise outcome in the original (unreduced) frame."""

    trans_mat: np.ndarray       # 4x4 f64
    vcm: np.ndarray             # 6x6 f64
    params_gon_m: np.ndarray    # (Rx,Ry,Rz [gon], tx,ty,tz [m])
    core: PairResult
    timer: PhaseTimer


def register_pair(points1: Optional[np.ndarray],
                  points2: Optional[np.ndarray],
                  cfg: Optional[PiecewiseICPConfig] = None,
                  sor_mult: Optional[float] = None,
                  target_state: Optional[TargetState] = None,
                  source_state: Optional[TargetState] = None,
                  mesh=None,
                  lattice_offset: np.ndarray | None = None,
                  initial_transform: np.ndarray | None = None
                  ) -> RegistrationOutput:
    """Register cloud2 onto cloud1 (raw input clouds, original frame).

    Pipeline (Registration.cpp:249-330): optional resolution estimation →
    voxel+SOR preprocessing → centroid reduction to the PC1 centroid →
    Piecewise-ICP core → T_final = Shift^-1 · T · Shift.

    Pass ``target_state`` (from :func:`prepare_target`) to reuse the
    target-side work across pairs sharing the same target epoch.

    Pass ``mesh`` (``jax.sharding.Mesh``, e.g. ``parallel.make_mesh()``) to
    run the full staged registration multi-chip (point-sharded clouds,
    psum-reduced normal equations — see ``parallel.sharded``).
    """
    cfg = cfg or PiecewiseICPConfig()
    timer = PhaseTimer()
    mult = sor_mult if sor_mult is not None else cfg.sor_std_mult_pair

    # device profiling: set PWICP_PROFILE_DIR to capture a jax.profiler
    # trace of this registration (the reference's TicToc prints become
    # PhaseTimer records + full XLA traces; SURVEY.md §5)
    import os as _os
    profile_dir = _os.environ.get("PWICP_PROFILE_DIR")
    if profile_dir:
        import jax as _jax
        _jax.profiler.start_trace(profile_dir)

    if target_state is None:
        with timer.phase("target"):
            target_state = prepare_target(points1, cfg, mult,
                                          lattice_offset=lattice_offset)
    res1 = target_state.resolution

    # centroid reduction by the TARGET centroid (Registration.cpp:277-294)
    shift = target_state.shift
    red1 = target_state.reduced_points
    patches2 = None
    if source_state is not None:
        # the source epoch was segmented once in its OWN centroid frame;
        # patches are translation-equivariant, so shift them into the
        # target-reduced frame instead of re-segmenting
        res2 = source_state.resolution
        delta = shift - source_state.shift
        patches2 = source_state.patches.translated(delta)
        red2 = patches2.points
    else:
        res2 = cfg.res2
        if not cfg.set_res_svsize:
            with timer.phase("resolution"):
                res2 = estimate_resolution(jnp.asarray(points2))
        with timer.phase("preprocess"):
            prep2 = preprocess_cloud(points2, res2, cfg.sor_neighbors, mult)
            red2 = (prep2.astype(np.float64) + shift).astype(np.float32)
    log.info("source: %d reduced pts | target: %d pts, %d patches",
             len(red2), len(target_state.reduced_points),
             target_state.patches.num_patches)

    # ---- warm start (beyond-reference; the direct-to-reference mode's
    #      far pairs are bistable under large misalignment for BOTH
    #      implementations — a composed-chain initial guess keeps the
    #      solve in the right basin; the estimate still registers the
    #      raw pair, the guess only moves the starting point) ----
    t_init = np.eye(4)
    if initial_transform is not None:
        t_init = np.asarray(initial_transform, dtype=np.float64)
        s0 = translation_matrix(shift)
        t_init_red = s0 @ t_init @ translation_matrix(-shift)
        red2 = apply_transform_np(red2.astype(np.float64),
                                  t_init_red).astype(np.float32)
        if patches2 is not None:
            patches2 = patches2.transformed(t_init_red)

    def _core_run(tstate: TargetState, p2, off):
        with timer.phase("core"):
            c = piecewise_icp(tstate.reduced_points, red2, res1, res2, cfg,
                              patches1=tstate.patches,
                              patches2=p2, mesh=mesh,
                              lattice_shift=tstate.shift,
                              lattice_offset=off)
        # de-reduce: T_final = S^-1 T S (Registration.cpp:319)
        s = translation_matrix(tstate.shift)
        s_inv = translation_matrix(-tstate.shift)
        return c, s_inv @ c.trans_mat @ s

    core, trans_final = _core_run(target_state, patches2, lattice_offset)

    # ---- acceptance guard (beyond-reference; VERDICT r4 items 1/3):
    #      a low final stable ratio marks a hard pair (large changed area
    #      or low overlap) whose result is sensitive to the patch DRAW.
    #      Re-roll the seed-lattice phase for independent draws and accept
    #      the draw closest to the component-wise parameter median —
    #      robust to bad draws without ground truth. ----
    if (cfg.guard_enabled and cfg.guard_draws > 1
            and lattice_offset is None
            and core.stable_ratio < cfg.guard_stable_ratio):
        log.info("acceptance guard: stable ratio %.3f < %.2f — running "
                 "%d extra lattice draws", core.stable_ratio,
                 cfg.guard_stable_ratio, cfg.guard_draws - 1)
        sv1 = (cfg.svsize1 if cfg.set_res_svsize
               else res1 * cfg.sv_size_res_mult)
        draws = [(core, trans_final)]

        def _one_draw(d: int):
            # deterministic low-discrepancy lattice phases (golden-ratio
            # sequence): arbitrary draw counts without repeats
            off = np.asarray([((d + 1) * 0.381966) % 1.0,
                              ((d + 1) * 0.618034) % 1.0,
                              ((d + 1) * 0.5) % 1.0]) * sv1
            try:
                ts_d = prepare_target(None, cfg, mult, lattice_offset=off,
                                      prep_state=target_state)
                draws.append(_core_run(ts_d, None, off))
            except PwICPError as e:
                log.info("guard draw %d degenerate (%s) — skipped", d, e)

        # sequential escalation: ONE probe draw first.  A low stable
        # ratio alone is scene-dependent (a rigid scene with modest
        # patch yield fires it on every pair); what actually warrants
        # the expensive ensemble is DRAW SENSITIVITY, measured directly:
        # escalate only when the probe disagrees with the first draw
        # beyond their own VCM prediction.
        _one_draw(0)
        if len(draws) > 1:
            p0 = np.concatenate([matrix_to_angles(draws[0][1]),
                                 draws[0][1][:3, 3]])
            p1_ = np.concatenate([matrix_to_angles(draws[1][1]),
                                  draws[1][1][:3, 3]])
            se2 = (np.diag(np.asarray(draws[0][0].vcm))
                   + np.diag(np.asarray(draws[1][0].vcm)))
            z_dis = float(np.max(np.abs(p0 - p1_)
                                 / np.sqrt(np.maximum(se2, 1e-24))))
            # the formal VCMs understate true error, so the threshold
            # runs hot: 2.0 keeps rigid scenes on the cheap path
            # (measured z ~ 0.8-1.3) while the moderately-hard pairs
            # (z ~ 2-3) get the full ensemble
            if z_dis > cfg.guard_escalate_z:
                log.info("acceptance guard: draw disagreement %.1f sigma "
                         "— escalating to %d draws", z_dis,
                         cfg.guard_draws)
                for d in range(1, cfg.guard_draws - 1):
                    _one_draw(d)
            else:
                log.info("acceptance guard: draws agree (%.1f sigma) — "
                         "fusing the probe pair only", z_dis)
        if len(draws) > 1:
            # Combine: GLS (precision-weighted) fusion of the THREE
            # lowest-sigma0 draws.  sigma0 (the a-posteriori unit-weight
            # std of the final fit) rank-correlates with true error on
            # hard pairs — leaked sub-LoD change inflates the residuals
            # of the draw it contaminated — and VCM weighting fuses the
            # draws along each pair's own uncertainty geometry: hard
            # pairs scatter along the VCM's weak direction (narrow-band
            # stable regions trade rotation against translation), where
            # component-wise averaging mixes poorly but GLS weights
            # correctly (r5 offline study on 5 pairs x 9 recorded draws:
            # mean rot 38.9 -> 20.3 mgon, trans 1.17 -> 0.49 mm vs GT;
            # top-2 param averaging got 19.4 / 0.76).
            s0 = np.array([c.sigma0 for c, _ in draws])
            order = np.argsort(s0)
            top = order[:min(3, len(draws))]
            p6 = np.stack([
                np.concatenate([matrix_to_angles(t), t[:3, 3]])
                for _, t in draws])
            w_sum = np.zeros((6, 6))
            b_sum = np.zeros(6)
            for i in top:
                w = np.linalg.inv(np.asarray(draws[int(i)][0].vcm)
                                  + 1e-18 * np.eye(6))
                w_sum += w
                b_sum += w @ p6[i]
            from ..ops.transform import params_to_matrix
            try:
                fused = np.linalg.solve(w_sum, b_sum)
            except np.linalg.LinAlgError:
                fused = p6[top].mean(axis=0)
            trans_final = params_to_matrix(fused)
            core = draws[int(top[0])][0]
            spread = np.ptp(p6, axis=0)
            log.info("acceptance guard: GLS-fused draws %s of %d by "
                     "sigma0 (%s mm); draw spread rot %.2f mgon, "
                     "trans %.3f mm", list(top), len(draws),
                     np.array2string(s0 * 1e3, precision=3),
                     spread[:3].max() * ARC_TO_MGON,
                     1e3 * spread[3:].max())

    if initial_transform is not None:
        # estimated transform acts on the warm-started cloud; compose the
        # guess back in (the LSQ perturbation is a LEFT twist, so the
        # reported VCM is unchanged by this right-composition)
        trans_final = trans_final @ t_init
    params = matrix_to_params_gon(trans_final)
    if profile_dir:
        import jax as _jax
        _jax.profiler.stop_trace()
        log.info("profiler trace written to %s", profile_dir)
    log.info("final transform params (gon/m): %s", np.array2string(
        params, precision=6))
    return RegistrationOutput(trans_mat=trans_final, vcm=core.vcm,
                              params_gon_m=params, core=core, timer=timer)


def write_pair_report(out_prefix: str | pathlib.Path,
                      result: RegistrationOutput,
                      source_points: Optional[np.ndarray] = None) -> None:
    """Write TransMatrix.txt (+ RegisteredSourceCloud.pcd) like the
    reference (Registration.cpp:340-394)."""
    prefix = str(out_prefix)
    angles = matrix_to_angles(result.trans_mat)
    formats.write_trans_matrix_report(
        prefix + "TransMatrix.txt", result.trans_mat, angles,
        result.trans_mat[:3, 3], result.vcm)
    if source_points is not None:
        reg = apply_transform_np(source_points.astype(np.float64),
                                 result.trans_mat).astype(np.float32)
        write_pcd(prefix + "RegisteredSourceCloud.pcd", reg)


def write_visualizations(out_prefix: str, result: RegistrationOutput) -> None:
    """Export the reference's PCLVisualizer views as colored PCDs
    (CommonFunc.cpp:456-493 / Segmentation.cpp:164-190 — headless pods
    have no display, so views become files)."""
    from ..utils import viz

    core = result.core
    if core.patches2 is None:
        return
    prefix = str(out_prefix)
    viz.export_colored_patches(prefix + "Patches1_colored.pcd",
                               core.patches1.points, core.patches1.labels)
    viz.export_colored_patches(prefix + "Patches2_colored.pcd",
                               core.patches2.points, core.patches2.labels)
    if core.stable_point_mask is not None:
        viz.export_stable_unstable(prefix + "StableUnstable2.pcd",
                                   core.patches2.points,
                                   core.stable_point_mask)


def piecewise_icp_pair_call(confile: str, outfile: str, mesh=None,
                            **overrides) -> bool:
    """Drop-in equivalent of the reference C ABI entry
    ``PiecewiseICP_pair_call(confile, outfile)`` (Registration.h:49)."""
    try:
        cfg = PiecewiseICPConfig.from_reference_file(confile, **overrides)
    except (OSError, ValueError) as e:
        log.error("cannot read configuration file: %s", e)
        return False
    try:
        pts1 = read_pcd(cfg.path1)
        pts2 = read_pcd(cfg.path2)
    except Exception as e:
        log.error("cannot load point clouds: %s", e)
        return False
    if len(pts1) < 1 or len(pts2) < 1:
        return False
    result = register_pair(pts1, pts2, cfg, mesh=mesh)
    write_pair_report(outfile, result, source_points=pts2)
    if cfg.visual:
        write_visualizations(outfile, result)
        # the post-registration three-cloud view of the original clouds
        # (Registration.cpp:335-337)
        from ..utils import viz
        reg = apply_transform_np(pts2.astype(np.float64),
                                 result.trans_mat).astype(np.float32)
        viz.export_three_clouds(str(outfile) + "ThreeClouds.pcd",
                                pts1, pts2, reg)
    log.info("transformation results saved to %s", outfile)
    return True
