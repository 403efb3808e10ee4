"""Shared synthetic-data helpers for pipeline tests."""

import numpy as np

from piecewise_icp.ops.transform import apply_transform_np, \
    params_to_matrix


def terrain_cloud(rng, n_side=90, extent=2.0, noise=3e-4):
    """A gently undulating surface scan — planar at supervoxel scale but not
    globally, so registration is well-constrained in all six DOF.

    Curvature is kept small relative to the patch size (like the reference's
    synthetic data): max |z''| ~ 0.25, so the boundary-point sagitta at
    patch radius 0.08 stays well under the DTmin=4 mm stability threshold.
    """
    u = np.linspace(0.0, extent, n_side)
    xx, yy = np.meshgrid(u, u)
    # jitter the sample locations FIRST so points lie exactly on the surface
    # (jittering after evaluating z would add slope-proportional noise)
    xx = xx + rng.normal(scale=extent / n_side / 6, size=xx.shape)
    yy = yy + rng.normal(scale=extent / n_side / 6, size=yy.shape)
    zz = (0.04 * np.sin(2.0 * xx) * np.cos(1.5 * yy)
          + 0.015 * np.sin(3.1 * yy) + 0.05 * xx - 0.03 * yy)
    # piecewise-planar pyramids: steep planar faces pin the in-plane DOFs
    # (tx, ty, Rz) that a near-horizontal surface leaves unobservable
    for cx, cy, amp, w in ((0.5, 0.55, 0.35, 0.42), (1.5, 0.5, 0.3, 0.38),
                           (0.6, 1.5, 0.32, 0.40), (1.45, 1.5, 0.28, 0.36)):
        zz += amp * np.maximum(
            0.0, 1.0 - np.maximum(np.abs(xx - cx), np.abs(yy - cy)) / w)
    pts = np.stack([xx, yy, zz], axis=-1).reshape(-1, 3)
    pts += rng.normal(scale=noise, size=pts.shape)
    return pts.astype(np.float32)


def make_pair(rng, params, **kw):
    """(cloud1, cloud2, T_true): cloud2 = T_true applied to an independent
    scan of the same surface."""
    c1 = terrain_cloud(rng, **kw)
    c2 = terrain_cloud(rng, **kw)
    t_true = params_to_matrix(np.asarray(params, dtype=np.float64))
    c2 = apply_transform_np(c2.astype(np.float64), t_true).astype(np.float32)
    return c1, c2, t_true


def small_test_config(**overrides):
    from piecewise_icp.config import PiecewiseICPConfig

    # nn_impl="native": exact kNN graphs keep these noise-dominated small
    # scenes deterministic; the grid path is covered by test_grid_nn and an
    # explicit variant in test_models, and validated on real data by bench.py
    defaults = dict(set_res_svsize=True, res1=0.022, res2=0.022,
                    svsize1=0.22, svsize2=0.22, set_dtinit=True,
                    dt_init=0.05, dt_min=0.004, nn_impl="native",
                    point_pad_multiple=512, patch_pad_multiple=64)
    defaults.update(overrides)
    return PiecewiseICPConfig(**defaults)
