"""Concurrent epoch-fleet scaling measurement (BASELINE: >=80% efficiency
at 2 workers; VERDICT r2 #6).

This measures fleet mechanics without accelerators: N concurrent OS
processes on the CPU backend sharing the pair fleet over the filesystem
— the same mechanics as N hosts on a shared FS: contiguous-range pair
assignment (models/four_d.run_4d), durable per-pair npz grain, any worker
finalises once all pairs exist.

Each worker is pinned to ONE thread (OMP_NUM_THREADS=1 +
--xla_cpu_multi_thread_eigen=false) so the scaling curve measures fleet
mechanics, not intra-process threading, and W workers fit the host's
cores.  A warm-up campaign populates the persistent compilation cache
first so every measured worker starts cache-hot (what a real fleet pays).

Usage: python eval/fleet_demo.py [--epochs 13] [--workers 1 2] [--mode 1]
Writes eval/fleet_report.json.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WORKDIR = "/tmp/pwicp_fleet"


def _worker_env() -> dict:
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["OPENBLAS_NUM_THREADS"] = "1"
    xla = env.get("XLA_FLAGS", "")
    env["XLA_FLAGS"] = (xla + " --xla_cpu_multi_thread_eigen=false").strip()
    return env


def run_fleet(conf: str, out_dir: str, epochs: int, mode: int,
              workers: int) -> dict:
    """Launch ``workers`` concurrent 4D shard processes; one finalise pass
    afterwards.  Returns wall-clock stats."""
    if os.path.isdir(out_dir):
        shutil.rmtree(out_dir)
    env = _worker_env()
    cmd = [sys.executable, "-m", "piecewise_icp", "4d",
           "--config", conf, "--epochs", str(epochs), "--mode", str(mode),
           "--backend", "cpu", "--shards", str(workers), "--no-finalize"]
    logs = [open(os.path.join(os.path.dirname(out_dir.rstrip(os.sep)), f"worker_{workers}w_{i}.log"), "w")
            for i in range(workers)]
    t0 = time.perf_counter()
    # cwd=ROOT: `python -m piecewise_icp` only resolves from the repo
    # root (the package is not pip-installed)
    procs = [subprocess.Popen(cmd + ["--shard", str(i)], env=env, cwd=ROOT,
                              stdout=logs[i], stderr=subprocess.STDOUT)
             for i in range(workers)]
    per_worker = []
    for p in procs:
        p.wait()
        per_worker.append(round(time.perf_counter() - t0, 1))
    pairs_wall = time.perf_counter() - t0
    rcs = [p.returncode for p in procs]
    for f in logs:
        f.close()
    if any(rcs):
        raise RuntimeError(
            f"fleet worker failed (rcs={rcs}); see worker_*.log")

    # finalise: chaining + Kalman + accuracy from the durable npz grain
    fin_cmd = [a for a in cmd if a != "--no-finalize"]
    t0 = time.perf_counter()
    fin = subprocess.run(fin_cmd + ["--shard", "0", "--resume"],
                         env=env, cwd=ROOT, capture_output=True, text=True)
    finalize_wall = time.perf_counter() - t0
    if fin.returncode:
        raise RuntimeError(f"finalise failed: {fin.stdout[-2000:]}")
    return {"workers": workers, "pairs_wall_s": round(pairs_wall, 1),
            "per_worker_done_s": per_worker,
            "finalize_wall_s": round(finalize_wall, 1),
            "worker_rcs": rcs}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=13)
    ap.add_argument("--mode", type=int, default=1)
    ap.add_argument("--workers", type=int, nargs="*", default=[1, 2])
    ap.add_argument("--voxel", type=float, default=0.012,
                    help="series voxel size [m]; 0.017 halves the point "
                         "count (the r5 bandwidth-isolation A/B: if "
                         "2-worker efficiency recovers at half size, the "
                         "r4 memory-bandwidth explanation holds)")
    ap.add_argument("--tag", default=None,
                    help="report key (default: r5_voxel<mm>)")
    args = ap.parse_args()

    import numpy as np  # noqa: F401  (scale_demo import path)
    import scale_demo

    vox_mm = int(round(args.voxel * 1000))
    workdir = WORKDIR if vox_mm == 12 else f"{WORKDIR}_{vox_mm}mm"
    os.makedirs(workdir, exist_ok=True)
    scans = os.path.join(workdir, "scans")
    if not os.path.isdir(scans) or len(os.listdir(scans)) < args.epochs:
        print(f"[fleet] generating {args.epochs}-epoch light series "
              f"(voxel {vox_mm} mm)", flush=True)
        if os.path.isdir(scans):
            shutil.rmtree(scans)
        scans = scale_demo.generate_series(workdir, args.epochs,
                                           downsample=args.voxel, digits=3)

    from piecewise_icp.config import PiecewiseICPConfig

    out_dir = os.path.join(workdir, "out") + os.sep
    v = args.voxel
    cfg = PiecewiseICPConfig(
        path1=scans, path2=out_dir, set_res_svsize=True,
        res1=v, res2=v, svsize1=10 * v, svsize2=10 * v,
        set_dtinit=True, dt_init=5 * v, dt_min=0.008)
    conf = os.path.join(workdir, "conf.txt")
    cfg.to_reference_file(conf)

    # warm the persistent compilation cache (workers then start cache-hot)
    print("[fleet] cache warm-up (2-epoch campaign)", flush=True)
    warm_out = os.path.join(workdir, "warm") + os.sep
    warm_cfg = PiecewiseICPConfig(**{**cfg.__dict__, "path2": warm_out})
    warm_conf = os.path.join(workdir, "conf_warm.txt")
    warm_cfg.to_reference_file(warm_conf)
    warm = subprocess.run([sys.executable, "-m", "piecewise_icp", "4d",
                           "--config", warm_conf, "--epochs", "2", "--mode",
                           str(args.mode), "--backend", "cpu"],
                          env=_worker_env(), cwd=ROOT, capture_output=True,
                          text=True)
    if warm.returncode:
        raise RuntimeError(f"warm-up failed: {warm.stdout[-2000:]}")

    report = {"epochs": args.epochs, "mode": args.mode,
              "voxel_mm": vox_mm,
              "host_cores": os.cpu_count(), "runs": []}
    t1 = None
    for w in args.workers:
        r = run_fleet(conf, out_dir, args.epochs, args.mode, w)
        if w == 1:
            t1 = r["pairs_wall_s"]
        if t1:
            speedup = t1 / r["pairs_wall_s"]
            r["speedup_vs_1"] = round(speedup, 2)
            r["efficiency_pct"] = round(100 * speedup / w, 1)
        report["runs"].append(r)
        print(f"[fleet] {r}", flush=True)

    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, "fleet_report.json")
    merged = {}
    if os.path.exists(path):
        try:
            merged = json.load(open(path))
        except ValueError:
            merged = {}
    merged[args.tag or f"r5_voxel{vox_mm}mm"] = report
    with open(path, "w") as f:
        json.dump(merged, f, indent=2)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
