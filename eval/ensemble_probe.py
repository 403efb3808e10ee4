"""Round-5 probe 2: does a lattice-draw ensemble fix the hard pairs?

For each hard pair, run K=5 seed-lattice phase draws, report per-draw
error vs GT and the error of the draw closest to the component-wise
median of the 6 transform parameters (the acceptance-guard candidate).

Usage: python eval/ensemble_probe.py [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REF = "/root/reference/python"
DATA = f"{REF}/data/data_synthetic/syntheticPC_with_transformations"
GT = f"{REF}/data/data_synthetic/defined_transformations.txt"

PAIRS = [(7, 4), (12, 9), (9, 6), (5, 2), (20, 17)]
ARC_TO_MGON = 1000.0 * 200.0 / np.pi
SV = 0.05
# the guard's golden-ratio low-discrepancy phases (models/pairwise.py)
OFFSETS = [None] + [
    np.array([((d + 1) * 0.381966) % 1.0,
              ((d + 1) * 0.618034) % 1.0,
              ((d + 1) * 0.5) % 1.0]) * SV for d in range(8)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", default=None)
    args = ap.parse_args()

    from piecewise_icp.utils.cache import enable_compilation_cache
    enable_compilation_cache()
    from piecewise_icp.config import PiecewiseICPConfig
    from piecewise_icp.io import read_pcd
    from piecewise_icp.io.formats import read_ground_truth_transforms
    from piecewise_icp.models.pairwise import prepare_target, register_pair
    from piecewise_icp.ops.transform import matrix_to_angles

    gt_ts, gt_tm = read_ground_truth_transforms(GT)
    gt = dict(zip(gt_ts, gt_tm))

    def params_of(tm):
        ang = np.asarray(matrix_to_angles(tm), dtype=np.float64)
        return np.concatenate([ang * ARC_TO_MGON, tm[:3, 3] * 1000.0])

    cfg = PiecewiseICPConfig(
        path1=DATA, path2="/tmp/probe_out/",
        set_res_svsize=True, res1=0.005, res2=0.005,
        svsize1=SV, svsize2=SV,
        set_dtinit=True, dt_init=0.05, dt_min=0.004,
        guard_enabled=False)   # the probe IS the ensemble — no nesting

    results = []
    for (src, tgt) in PAIRS:
        c1 = read_pcd(f"{DATA}/Epoch_{tgt:03d}.pcd")
        c2 = read_pcd(f"{DATA}/Epoch_{src:03d}.pcd")
        want = params_of(np.linalg.inv(gt[tgt]) @ gt[src])
        draws = []
        base_ts = None
        t0 = time.perf_counter()
        for off in OFFSETS:
            ts = prepare_target(c1, cfg, cfg.sor_std_mult_4d,
                                lattice_offset=off,
                                prep_state=base_ts)
            if base_ts is None:
                base_ts = ts
            out = register_pair(None, c2, cfg,
                                sor_mult=cfg.sor_std_mult_4d,
                                target_state=ts, lattice_offset=off)
            draws.append((params_of(out.trans_mat), out))
        p = np.stack([d[0] for d in draws])
        med = np.median(p, axis=0)
        # scale-normalised distance to the median (rot in mgon, trans mm
        # are comparable magnitudes on this data; use per-component MAD)
        mad = np.maximum(np.median(np.abs(p - med), axis=0), 1e-9)
        dist = np.abs(p - med) / mad
        pick = int(np.argmin(dist.max(axis=1)))
        errs = np.abs(p - want)
        rec = {
            "pair": f"{src}->{tgt}",
            "params": [list(np.round(x, 5)) for x in p],
            "want": list(np.round(want, 5)),
            "sigma0": [round(d[1].core.sigma0 * 1000, 4) for d in draws],
            "vcms": [np.asarray(d[1].vcm).tolist() for d in draws],
            "per_draw_rot_err": [round(float(e[:3].max()), 2) for e in errs],
            "per_draw_trans_err": [round(float(e[3:].max()), 3)
                                   for e in errs],
            "spread_rot_mgon": round(float(np.ptp(p[:, :3], axis=0).max()),
                                     2),
            "spread_trans_mm": round(float(np.ptp(p[:, 3:], axis=0).max()),
                                     3),
            "picked": pick,
            "picked_rot_err": round(float(errs[pick][:3].max()), 2),
            "picked_trans_err": round(float(errs[pick][3:].max()), 3),
            "median_rot_err": round(float(np.abs(med - want)[:3].max()), 2),
            "median_trans_err": round(float(np.abs(med - want)[3:].max()),
                                      3),
            "stable_ratios": [round(d[1].core.stable_ratio, 3)
                              for d in draws],
            "wall_s": round(time.perf_counter() - t0, 1),
        }
        print(json.dumps(rec), flush=True)
        results.append(rec)

    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
