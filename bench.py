"""End-to-end registration benchmark on one GPU.

Registers the seeded synthetic-scale pair (``piecewise_icp.synthetic``:
the reference's configuration_4d.txt scene and settings, ~176k points per
epoch), checks the recovered transform against the known one, and runs a
short seeded 4D campaign through ``run_4d``.

Prints ONE JSON line:
    {"metric": "epochs/s", "value": N, "unit": "epochs/s", ...extras}

Refuses to run (exit 1) unless JAX reports a GPU.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def _measure_cache_hit_cold() -> float | None:
    """Fresh-process cold start WITH a warm persistent compilation cache —
    the start-up cost a fleet worker pays.  Runs BEFORE this process takes
    the card (one JAX process per card); None when the cache is empty."""
    from piecewise_icp.utils.cache import cache_dir

    if not os.path.isdir(cache_dir()) or not os.listdir(cache_dir()):
        return None
    prog = (
        "import time; t0 = time.perf_counter()\n"
        "import jax; assert jax.devices()[0].platform == 'gpu'\n"
        "from piecewise_icp.utils.cache import enable_compilation_cache\n"
        "enable_compilation_cache()\n"
        "from piecewise_icp.models.pairwise import register_pair\n"
        "from piecewise_icp.synthetic import pair_config, synthetic_pair\n"
        "a, b, _ = synthetic_pair()\n"
        "cfg = pair_config('', '')\n"
        "register_pair(a, b, cfg, sor_mult=cfg.sor_std_mult_4d)\n"
        "print('CACHE_COLD_S', time.perf_counter() - t0)\n")
    out = subprocess.run([sys.executable, "-c", prog], timeout=600,
                         capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    for line in out.stdout.splitlines():
        if line.startswith("CACHE_COLD_S"):
            return float(line.split()[1])
    return None


def main() -> int:
    cache_cold = _measure_cache_hit_cold()

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: no GPU (JAX platform is {devices[0].platform!r})",
              file=sys.stderr)
        return 1

    from piecewise_icp.utils.cache import enable_compilation_cache
    enable_compilation_cache()

    import dataclasses

    import jax.numpy as jnp

    from piecewise_icp.models.four_d import run_4d
    from piecewise_icp.models.icp import point_to_plane_icp
    from piecewise_icp.models.pairwise import (prepare_target,
                                                   register_pair)
    from piecewise_icp.ops.transform import matrix_to_params_gon
    from piecewise_icp.synthetic import (pair_config, synthetic_pair,
                                             write_series)
    from piecewise_icp.utils.logging import GLOBAL_TIMER

    pts1, pts2, t_true = synthetic_pair()
    cfg = pair_config("", "")
    mult = cfg.sor_std_mult_4d

    # cold run (includes all jit compilation)
    t0 = time.perf_counter()
    result = register_pair(pts1, pts2, cfg, sor_mult=mult)
    cold = time.perf_counter() - t0

    # warm: median of five repeats after one settling run
    register_pair(pts1, pts2, cfg, sor_mult=mult)
    warm_reps, fine_by_rep = [], []
    for _ in range(5):
        GLOBAL_TIMER.records.clear()
        t0 = time.perf_counter()
        result = register_pair(pts1, pts2, cfg, sor_mult=mult)
        warm_reps.append(time.perf_counter() - t0)
        fine_by_rep.append(GLOBAL_TIMER.summary())
    warm = float(np.median(warm_reps))
    fine = fine_by_rep[int(np.argsort(warm_reps)[len(warm_reps) // 2])]

    err = (matrix_to_params_gon(result.trans_mat)
           - matrix_to_params_gon(np.linalg.inv(t_true)))

    # campaign steady state, serial: one prepare_target + one core
    # registration per epoch (run_4d prepares each epoch once)
    ts1 = prepare_target(pts1, cfg, mult)
    ss2 = prepare_target(pts2, cfg, mult)
    register_pair(None, None, cfg, sor_mult=mult, target_state=ts1,
                  source_state=ss2)
    serial_reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        ss2 = prepare_target(pts2, cfg, mult)
        register_pair(None, None, cfg, sor_mult=mult, target_state=ts1,
                      source_state=ss2)
        serial_reps.append(time.perf_counter() - t0)

    # the real campaign loop: run_4d over a seeded 6-epoch series
    work = tempfile.mkdtemp(prefix="pwicp_bench4d_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        scans = write_series(work, n_epochs=6)
        camp_out = os.path.join(work, "out") + os.sep
        cfg4d = dataclasses.replace(cfg, path1=scans, path2=camp_out)
        run_4d(cfg4d, 0, 6, 1)            # warm every epoch's shape bucket
        campaign_reps = []
        for _ in range(3):
            shutil.rmtree(camp_out, ignore_errors=True)
            t0 = time.perf_counter()
            run_4d(cfg4d, 0, 6, 1)
            campaign_reps.append((time.perf_counter() - t0) / 5.0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    campaign_epoch_s = float(np.median(campaign_reps))

    # inner point-to-plane ICP throughput: 32 chained solves in one program
    p1s, p2s = result.core.patches1, result.core.patches2
    ct1_j = jnp.asarray(p1s.centroids)
    n1_j = jnp.asarray(p1s.normals)
    m1_j = jnp.ones((len(p1s.centroids),), bool)
    ct2_j = jnp.asarray(p2s.centroids + np.array([2e-3, -1e-3, 1.5e-3]))
    m2_j = jnp.ones((len(p2s.centroids),), bool)

    @jax.jit
    def f_icp_chain(s):
        def body(c, _):
            t, it = point_to_plane_icp(
                ct1_j, n1_j, m1_j, c, m2_j, max_iterations=100,
                transformation_eps=0.0, fitness_eps=0.0)
            return ct2_j + 0.0 * t[0, 0], it
        _, its = jax.lax.scan(body, s, None, length=32)
        return its

    icp_iters_micro = int(np.sum(np.asarray(
        jax.block_until_ready(f_icp_chain(ct2_j)))))
    t0 = time.perf_counter()
    jax.block_until_ready(f_icp_chain(ct2_j))
    icp_rate = icp_iters_micro / (time.perf_counter() - t0)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({
        "metric": "epochs/s",
        "value": 1.0 / warm,
        "unit": "epochs/s",
        "warm_s": warm,
        "cold_s": cold,
        "cache_hit_cold_s": cache_cold,
        "campaign_epoch_s": campaign_epoch_s,
        "campaign_serial_epoch_s": float(np.median(serial_reps)),
        "icp_iters_per_s": icp_rate,
        "icp_iters_warm_pair": int(result.core.total_icp_iters),
        "spread": {"warm_s": [min(warm_reps), max(warm_reps)],
                   "campaign_epoch_s": [min(campaign_reps),
                                        max(campaign_reps)]},
        "rot_err_mgon": float(np.abs(err[:3]).max() * 1000),
        "trans_err_mm": float(np.abs(err[3:]).max() * 1000),
        "phases": result.timer.summary(),
        "fine_phases": fine,
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": len(devices),
                   "card": card},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
