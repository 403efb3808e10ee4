"""Quasi-static campaign: the regime where Kalman smoothing demonstrably
pays (VERDICT r3 #8).

Monitoring campaigns routinely contain long stretches where the scene does
NOT move (that is the point of monitoring); every recorded campaign so far
had real epoch-to-epoch motion, which auto-Q correctly refuses to smooth
away (<=0.1% change).  This campaign constructs the static regime
explicitly: K epochs of the SAME synthetic surface, each an independent
noise realisation, ground truth identity throughout.  Per-epoch direct-mode
(pairMode 0) registrations then carry independent errors around a constant
truth — exactly the white-noise regime — and the RTS smoother with auto-Q
must recover a real error reduction (steady-state variance ~ sqrt(Q R)).

Usage: python eval/kalman_quasistatic.py [--epochs 12]
Writes eval/kalman_quasistatic.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SYN = ("/root/reference/python/data/data_synthetic/"
       "syntheticPC_with_transformations/Epoch_001.pcd")
WORKDIR = "/tmp/pwicp_quasistatic"


def generate(workdir: str, epochs: int, noise: float = 5e-4) -> None:
    from piecewise_icp.io import read_pcd, write_pcd

    scans = os.path.join(workdir, "scans")
    os.makedirs(scans, exist_ok=True)
    base = read_pcd(SYN).astype(np.float64)
    rng = np.random.default_rng(7)
    for k in range(epochs):
        pts = base + rng.normal(scale=noise, size=base.shape)
        write_pcd(os.path.join(scans, f"Epoch_{k + 1:03d}.pcd"),
                  pts.astype(np.float32))
    with open(os.path.join(workdir, "defined_transformations.txt"),
              "w") as f:
        # reference layout (defined_transformations.txt): epoch number on
        # its own line, then the 4x4 row-major matrix
        for k in range(epochs):
            f.write(f"{k + 1}\n")
            for row in np.eye(4):
                f.write(" ".join(f"{v:.10f}" for v in row) + " \n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--fresh", action="store_true")
    args = ap.parse_args()

    from piecewise_icp.config import PiecewiseICPConfig
    from piecewise_icp.io import formats
    from piecewise_icp.models.four_d import run_4d
    from piecewise_icp.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    if args.fresh and os.path.isdir(WORKDIR):
        shutil.rmtree(WORKDIR)
    scans = os.path.join(WORKDIR, "scans")
    if not os.path.isdir(scans) or len(os.listdir(scans)) < args.epochs:
        generate(WORKDIR, args.epochs)
    out_dir = os.path.join(WORKDIR, "results/")
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    gt = os.path.join(WORKDIR, "defined_transformations.txt")

    cfg = PiecewiseICPConfig(
        path1=scans, path2=out_dir,
        set_res_svsize=True, res1=0.005, res2=0.005,
        svsize1=0.05, svsize2=0.05, set_dtinit=True,
        dt_init=0.05, dt_min=0.004, kalman_enabled=True)
    ok = run_4d(cfg, 0, args.epochs, 0, overlap_thd=0.75, ground_truth=gt)

    raw = formats.read_abs_errors(
        os.path.join(out_dir, "TransPara_AbsError.txt"))
    sm = formats.read_abs_errors(
        os.path.join(out_dir, "TransPara_AbsError_smoothed.txt"))

    # every epoch registers onto the SAME noisy realisation of epoch 1,
    # so all estimates share a common-mode error (the target's own
    # patch-sampling bias) that no smoother can remove — split it off:
    # the independent (per-epoch) component is what the RTS smoother is
    # predicted to shrink by ~sqrt(N)
    from piecewise_icp.ops.transform import matrix_to_params_gon

    def signed(fname):
        _, mats, _ = formats.read_trans_matrices(
            os.path.join(out_dir, fname), args.epochs - 1)
        return np.stack([matrix_to_params_gon(m) for m in mats])

    z_raw = signed("TransMatrices_toRef.txt")        # truth = 0
    z_sm = signed("TransMatrices_toRef_smoothed.txt")
    std_raw = z_raw.std(axis=0)
    std_sm = z_sm.std(axis=0)
    report = {
        "ok": bool(ok),
        "epochs": args.epochs,
        "raw_mean_rot_mgon": [round(v, 3) for v in raw[:, :3].mean(0)],
        "raw_mean_trans_mm": [round(v, 4) for v in raw[:, 3:].mean(0)],
        "smoothed_mean_rot_mgon": [round(v, 3) for v in sm[:, :3].mean(0)],
        "smoothed_mean_trans_mm": [round(v, 4) for v in sm[:, 3:].mean(0)],
        "rot_reduction": round(float(raw[:, :3].mean()
                                     / max(sm[:, :3].mean(), 1e-12)), 2),
        "trans_reduction": round(float(raw[:, 3:].mean()
                                       / max(sm[:, 3:].mean(), 1e-12)), 2),
        "common_mode_bias_rot_mgon": [
            round(v * 1000, 3) for v in z_raw.mean(0)[:3]],
        "independent_component_reduction": round(
            float(std_raw.mean() / max(std_sm.mean(), 1e-15)), 2),
    }
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "kalman_quasistatic.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
