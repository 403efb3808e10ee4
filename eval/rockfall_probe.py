"""Root-cause probe for the rockfall-sim tx drag (VERDICT r2 #5).

Decomposes the 4D mean-|tx| ~31 mm / pair 10 mm error on the simulated
rockfall series into candidate causes with controlled single-pair
experiments (all on the SAME first pair, epochs 1->2):

  A. baseline        — the standard series (scars + debris + jitter)
  B. no_scars        — identical series with scar growth zeroed: isolates
                       unstable-area classification drag from everything
                       else (if tx persists, scars are not the cause)
  C. tight_dtmin     — DTmin 30 -> 10 mm: if tx shrinks, sub-threshold
                       moved points are leaking through classification
  D. exact_gt_map    — residual statistics of the stable-classified points
                       under the EXACT ground-truth alignment: a clean
                       scene shows pure noise; structure along x exposes a
                       gauge weakness (tx vs Rz*y / Ry*z near-degeneracy
                       of a single distant wall)

Also reports the normal-equation conditioning of the final stable set —
the direct observability measure (small eigenvalue along a (tx, Rz, Ry)
combination = geometry, not classification).

Usage: python eval/rockfall_probe.py [--workdir /tmp/pwicp_rockfall_probe]
Writes eval/rockfall_probe.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import rockfall_sim


def _pair_experiment(scans: str, gt_file: str, label: str, **cfg_over):
    from piecewise_icp.io import formats, read_pcd
    from piecewise_icp.models.pairwise import prepare_target, \
        register_pair
    from piecewise_icp.ops.transform import matrix_to_params_gon

    files = sorted(os.listdir(scans))
    pts1 = read_pcd(os.path.join(scans, files[0]))
    pts2 = read_pcd(os.path.join(scans, files[1]))
    cfg = rockfall_sim.rockfall_config(scans, "/tmp/", **cfg_over)
    _, gt = formats.read_ground_truth_transforms(gt_file)
    ts = prepare_target(pts1, cfg, cfg.sor_std_mult_pair)
    r = register_pair(None, pts2, cfg, sor_mult=cfg.sor_std_mult_pair,
                      target_state=ts)
    err = (matrix_to_params_gon(r.trans_mat)
           - matrix_to_params_gon(gt[1]))
    out = {
        "rot_err_mgon": [round(float(v) * 1000, 2) for v in err[:3]],
        "trans_err_mm": [round(float(v) * 1000, 3) for v in err[3:]],
        "trans_std_mm": [round(float(v) * 1000, 3)
                         for v in np.sqrt(np.diag(r.vcm)[3:])],
        "stable_patches_ratio": round(r.core.stable_ratio, 3),
    }
    print(f"[probe] {label}: {out}", flush=True)
    return out, r, ts.shift, gt


def _reference_semantics_control(scans: str, gt_file: str, label: str,
                                 dt_init: float, dt_min: float,
                                 resolution: float):
    """An INDEPENDENT minimal pipeline with the reference's classification
    semantics — raw points, per-point normals, NN correspondences,
    stable = |point-to-plane residual| <= max(DT, LoD), monotonically
    decreasing DT, point-to-plane LSQ on the stable set.  No supervoxels,
    no patches, no boundary points: nothing of this repo's patch pipeline
    except preprocessing.  If THIS exhibits the same tx drag on the
    scarred scene (and none without scars), the drag follows from the
    DT/LoD semantics on this scene, not from the patch pipeline
    (VERDICT r3 'measure, don't argue')."""
    import jax.numpy as jnp

    from piecewise_icp import native
    from piecewise_icp.io import formats, read_pcd
    from piecewise_icp.ops.grid_nn import build_grid, grid_nn1
    from piecewise_icp.ops.preprocess import preprocess_cloud
    from piecewise_icp.ops.transform import (apply_transform_np,
                                                 matrix_to_params_gon,
                                                 params_to_matrix)

    files = sorted(os.listdir(scans))
    pts1 = read_pcd(os.path.join(scans, files[0]))
    pts2 = read_pcd(os.path.join(scans, files[1]))
    _, gt = formats.read_ground_truth_transforms(gt_file)
    tgt = preprocess_cloud(pts1, resolution, 14, 2.7).astype(np.float64)
    src0 = preprocess_cloud(pts2, resolution, 14, 2.7).astype(np.float64)
    ctr = tgt.mean(axis=0)
    tgt -= ctr
    src0 -= ctr

    nbr = native.knn_graph(tgt.astype(np.float32), 15)
    normals = native.pca_normals(tgt.astype(np.float32), nbr
                                 ).astype(np.float64)
    grid = build_grid(tgt.astype(np.float32), h=4.0 * resolution)

    t_acc = np.eye(4)
    dt = dt_init
    src = src0.copy()
    floors = 0
    for _ in range(40):
        idx, d = grid_nn1(jnp.asarray(src.astype(np.float32)), grid,
                          exact=True)
        idx = np.asarray(idx)
        n = normals[idx]
        q = tgt[idx]
        res = np.sum(n * (q - src), axis=1)
        stable = np.abs(res) <= max(dt, dt_min)
        if stable.sum() < 100:
            break
        a = np.column_stack([
            n[stable, 2] * src[stable, 1] - n[stable, 1] * src[stable, 2],
            n[stable, 0] * src[stable, 2] - n[stable, 2] * src[stable, 0],
            n[stable, 1] * src[stable, 0] - n[stable, 0] * src[stable, 1],
            n[stable]])
        x = np.linalg.lstsq(a, res[stable], rcond=None)[0]
        t_step = params_to_matrix(x)
        src = apply_transform_np(src, t_step)
        t_acc = t_step @ t_acc
        if dt <= dt_min * (1 + 1e-9):
            floors += 1
            if floors >= 3:
                break
        dt = max(dt * 0.7, dt_min)

    s = np.eye(4)
    s[:3, 3] = ctr
    s_inv = np.eye(4)
    s_inv[:3, 3] = -ctr
    t_final = s @ t_acc @ s_inv
    err = matrix_to_params_gon(t_final) - matrix_to_params_gon(gt[1])
    out = {
        "rot_err_mgon": [round(float(v) * 1000, 2) for v in err[:3]],
        "trans_err_mm": [round(float(v) * 1000, 3) for v in err[3:]],
        "stable_ratio": round(float(stable.mean()), 3),
    }
    print(f"[probe] {label}: {out}", flush=True)
    return out


def _gt_residual_map(r, shift, gt):
    """Residuals of the stable-classified source points under the EXACT
    GT alignment, projected on the matched target patch normals, binned
    along x — classification drag shows as a nonzero mean; a gauge
    weakness shows as x-correlated structure."""
    from piecewise_icp.ops.transform import (apply_transform_np,
                                                 translation_matrix)

    core = r.core
    stable = core.stable_point_mask
    src = core.patches2.points[stable]          # reduced frame, pre-reg
    ct1 = core.patches1.centroids.astype(np.float64)
    n1 = core.patches1.normals.astype(np.float64)
    # the exact GT relative transform conjugated into the reduced frame
    s = translation_matrix(shift)
    s_inv = translation_matrix(-shift)
    t_red_gt = s @ gt[1] @ s_inv
    moved = apply_transform_np(src.astype(np.float64), t_red_gt)
    step = max(len(moved) // 20000, 1)
    moved = moved[::step]
    src = src[::step]
    d2 = ((moved[:, None, :] - ct1[None, :, :]) ** 2).sum(-1)
    j = d2.argmin(1)
    res = np.sum((moved - ct1[j]) * n1[j], axis=1)
    xs = src[:, 0]
    bins = np.linspace(xs.min(), xs.max(), 9)
    ib = np.clip(np.digitize(xs, bins) - 1, 0, 7)
    prof = [round(float(res[ib == b].mean() * 1000), 2) if (ib == b).any()
            else None for b in range(8)]
    return {"stable_residual_mean_mm": round(float(res.mean() * 1000), 3),
            "stable_residual_std_mm": round(float(res.std() * 1000), 3),
            "x_binned_mean_mm": prof}


def _conditioning(r):
    """Eigen-spectrum of the final normal-equation matrix over the stable
    set (rows [n x q cross, n]): the observability measure."""
    core = r.core
    ct1 = core.patches1.centroids.astype(np.float64)
    n1 = core.patches1.normals.astype(np.float64)
    ct2 = core.patches2.centroids.astype(np.float64)
    d2 = ((ct2[:, None, :] - ct1[None, :, :]) ** 2).sum(-1)
    j = d2.argmin(1)
    n = n1[j]
    q = ct2
    a = np.column_stack([
        n[:, 2] * q[:, 1] - n[:, 1] * q[:, 2],
        n[:, 0] * q[:, 2] - n[:, 2] * q[:, 0],
        n[:, 1] * q[:, 0] - n[:, 0] * q[:, 1],
        n[:, 0], n[:, 1], n[:, 2]])
    ata = a.T @ a / len(a)
    w, v = np.linalg.eigh(ata)
    weakest = v[:, 0]
    return {"eigvals": [round(float(x), 6) for x in w],
            "weakest_direction_RxRyRzTxTyTz":
                [round(float(x), 3) for x in weakest],
            "condition_number": round(float(w[-1] / max(w[0], 1e-30)), 1)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/pwicp_rockfall_probe")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from piecewise_icp.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    report = {}
    # A: standard series (reuse the main rockfall workdir when present)
    std_dir = "/tmp/pwicp_rockfall"
    if not os.path.isdir(os.path.join(std_dir, "scans")):
        std_dir = os.path.join(args.workdir, "std")
        rockfall_sim.generate_rockfall(std_dir, 6)
    scans = os.path.join(std_dir, "scans")
    gt_file = os.path.join(std_dir, "defined_transformations.txt")
    report["A_baseline"], r, shift, gt = _pair_experiment(
        scans, gt_file, "A_baseline")
    report["A_gt_residual_map"] = _gt_residual_map(r, shift, gt)
    report["A_conditioning"] = _conditioning(r)

    # B: same seed, scar growth zeroed
    ns_dir = os.path.join(args.workdir, "noscars")
    if not os.path.isdir(os.path.join(ns_dir, "scans")):
        rockfall_sim.generate_rockfall(ns_dir, 2, with_scars=False)
    report["B_no_scars"], rb, _, _ = _pair_experiment(
        os.path.join(ns_dir, "scans"),
        os.path.join(ns_dir, "defined_transformations.txt"), "B_no_scars")

    # C: tight DTmin on the standard pair
    report["C_tight_dtmin"], _, _, _ = _pair_experiment(
        scans, gt_file, "C_tight_dtmin", dt_min=0.01)

    # E/F: the reference-semantics control — an independent raw-point
    # DT/LoD-threshold p2pl ICP (no patches).  Shares the drag on the
    # scarred scene and not without scars => the drag follows from the
    # classification semantics on this scene, not from the patch pipeline
    cfg0 = rockfall_sim.rockfall_config(scans, "/tmp/")
    report["E_ref_semantics_control_scars"] = _reference_semantics_control(
        scans, gt_file, "E_ref_semantics_control_scars",
        dt_init=cfg0.dt_init, dt_min=cfg0.dt_min, resolution=cfg0.res1)
    report["F_ref_semantics_control_noscars"] = \
        _reference_semantics_control(
            os.path.join(ns_dir, "scans"),
            os.path.join(ns_dir, "defined_transformations.txt"),
            "F_ref_semantics_control_noscars",
            dt_init=cfg0.dt_init, dt_min=cfg0.dt_min,
            resolution=cfg0.res1)

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "rockfall_probe.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
