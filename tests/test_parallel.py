"""Multi-device tests on the virtual 8-CPU mesh.

The mesh path wraps the SAME iteration body as the single-device path
(``_iteration_step`` with ``axis_name`` set), so these tests assert both
(a) one sharded iteration reproduces one single-device iteration and
(b) the FULL pairwise registration through ``piecewise_icp(mesh=...)``
matches the single-device transform — collectives change the schedule,
not the math."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from piecewise_icp.models.piecewise_icp import (_iteration_step,
                                                    _pad, _mask,
                                                    piecewise_icp)
from piecewise_icp.models.segmentation import build_patches
from piecewise_icp.ops.grid_nn import build_grid
from piecewise_icp.ops.transform import matrix_to_angles
from piecewise_icp.parallel.sharded import (build_sharded_iteration,
                                                make_mesh, point_sharded,
                                                replicated)

from util import make_pair, small_test_config

ARC_TO_MGON = 1000.0 * 200.0 / np.pi


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(7)
    params = np.array([0.001, -0.001, 0.0015, 0.003, -0.004, 0.002])
    c1, c2, t_true = make_pair(rng, params, n_side=60)
    cfg = small_test_config()
    ps1 = build_patches(c1, cfg.svsize1, cfg)
    ps2 = build_patches(c2, cfg.svsize2, cfg)
    return cfg, c1, c2, t_true, ps1, ps2


def _step_args(cfg, ps1, ps2, n_dev=8):
    """Build the positional argument list of _iteration_step (host arrays)."""
    pm = int(np.lcm(cfg.patch_pad_multiple, n_dev))
    cm = int(np.lcm(cfg.point_pad_multiple, n_dev))
    grid = build_grid(ps1.points, h=max(4.0 * cfg.res1, 1e-6))
    args = dict(
        ct1=_pad(ps1.centroids, pm), n1=_pad(ps1.normals, pm),
        std_ct1=_pad(ps1.std_ct, pm), ct1_mask=_mask(ps1.num_patches, pm),
        ct2=_pad(ps2.centroids, pm), n2=_pad(ps2.normals, pm),
        bp2=_pad(ps2.boundary.reshape(-1, 3), 6 * pm),
        std_bp2=_pad(ps2.std_bp, pm), ct2_mask=_mask(ps2.num_patches, pm),
        cloud2=_pad(ps2.points, cm),
        cloud2_mask=_mask(len(ps2.points), cm),
        labels2=_pad(ps2.labels, cm, value=-1),
        g_pts=grid.points, g_starts=grid.cell_starts,
        g_origin=grid.origin, g_dims=np.asarray(grid.dims, np.int32),
        g_h=np.asarray(grid.h, np.float32),
    )
    scalars = dict(curr_dt=np.float32(cfg.dt_init),
                   dt_min=np.float32(cfg.dt_min),
                   max_lod=np.float32(cfg.dt_min * cfg.lod_max_ratio),
                   sv_sum=np.float32(cfg.svsize1 + cfg.svsize2),
                   bb_leaf=np.float32(2.0 * cfg.res2),
                   percentile=np.float32(0.75),
                   need_percentile=np.asarray(True))
    return args, scalars, grid


SHARDED_KEYS = ("cloud2", "cloud2_mask", "labels2")


class TestShardedIteration:
    def test_iteration_matches_single_device(self, scene):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        cfg, _, _, _, ps1, ps2 = scene
        args, scalars, grid = _step_args(cfg, ps1, ps2)

        single = _iteration_step(
            *[jnp.asarray(v) for v in args.values()],
            *[jnp.asarray(v) for v in scalars.values()],
            grid_max_run=grid.max_run)

        mesh = make_mesh(8)
        step = build_sharded_iteration(mesh, grid_max_run=grid.max_run)
        dev_args = [point_sharded(mesh, jnp.asarray(v))
                    if k in SHARDED_KEYS else replicated(mesh, jnp.asarray(v))
                    for k, v in args.items()]
        sharded = step(*dev_args, *[jnp.asarray(v) for v in scalars.values()])

        s_single = np.asarray(single[0], np.float64)
        s_shard = np.asarray(sharded[0], np.float64)
        # transform (16) to accumulation-order tolerance
        np.testing.assert_allclose(s_shard[:16], s_single[:16], atol=5e-5)
        # lod_min, n_stable exact; d75 to float tolerance
        assert s_shard[16] == pytest.approx(s_single[16], rel=1e-6)
        assert int(s_shard[17]) == int(s_single[17])
        assert s_shard[20] == pytest.approx(s_single[20], rel=1e-4)  # d75
        assert bool(s_shard[21]) and bool(s_single[21])              # exact
        np.testing.assert_array_equal(np.asarray(sharded[1]),
                                      np.asarray(single[1]))  # stable
        # sharded state updates match
        np.testing.assert_allclose(np.asarray(sharded[3]),
                                   np.asarray(single[3]), atol=1e-5)
        np.testing.assert_allclose(np.asarray(sharded[6]),
                                   np.asarray(single[6]), atol=1e-5)

    def test_full_registration_matches_single_device(self, scene):
        """End-to-end: the whole staged DT loop through piecewise_icp(mesh)
        lands on the same transform as the single-device run."""
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        cfg, c1, c2, t_true, ps1, ps2 = scene
        res_1dev = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg,
                                 patches1=ps1, patches2=ps2)
        mesh = make_mesh(8)
        res_mesh = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg,
                                 patches1=ps1, patches2=ps2, mesh=mesh)
        assert res_mesh.iterations == res_1dev.iterations
        d_ang = (np.array(matrix_to_angles(res_mesh.trans_mat))
                 - np.array(matrix_to_angles(res_1dev.trans_mat)))
        d_t = res_mesh.trans_mat[:3, 3] - res_1dev.trans_mat[:3, 3]
        assert np.abs(d_ang * ARC_TO_MGON).max() < 0.5   # < 0.5 mgon
        assert np.abs(d_t * 1000).max() < 0.05           # < 0.05 mm
        # sanity: the registration recovers the true transform (T_est maps
        # cloud2 back onto cloud1, i.e. T_est ≈ T_true^-1); point-residual
        # metric as in test_models
        from piecewise_icp.ops.transform import apply_transform_np
        m = res_mesh.trans_mat @ t_true
        disp = np.linalg.norm(apply_transform_np(c2.astype(np.float64), m)
                              - c2.astype(np.float64), axis=1)
        # n_side=60 scene is small (94 patches) — looser floor than
        # test_models' n_side=90 scene
        assert disp.mean() < 5e-3
        np.testing.assert_allclose(res_mesh.vcm, res_1dev.vcm,
                                   rtol=5e-2, atol=1e-14)

    def test_graft_dryrun(self):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        import importlib.util
        import pathlib
        root = pathlib.Path(__file__).resolve().parents[1]
        spec = importlib.util.spec_from_file_location(
            "__graft_entry__", root / "__graft_entry__.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.dryrun_multichip(8)
        fn, args = mod.entry()
        out = jax.jit(fn)(*args)
        assert np.isfinite(np.asarray(out[0])).all()
