"""Grid-hash NN vs exact brute force — including the fallback path and
non-uniform densities."""

import jax.numpy as jnp
import numpy as np

from piecewise_icp.ops.grid_nn import build_grid, grid_nn1
from piecewise_icp.ops.nn import nn1


def _brute(q, t):
    d2 = ((q[:, None, :].astype(np.float64)
           - t[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return d2.argmin(1), np.sqrt(d2.min(1))


class TestGridNN:
    def test_matches_brute_uniform(self, rng):
        t = rng.uniform(0, 2, size=(3000, 3)).astype(np.float32)
        q = rng.uniform(0, 2, size=(1000, 3)).astype(np.float32)
        grid = build_grid(t, h=0.25)
        idx, dist = grid_nn1(jnp.asarray(q), grid)
        ridx, rdist = _brute(q, t)
        np.testing.assert_allclose(np.asarray(dist), rdist, atol=1e-5)
        # tie-breaking may differ; distances must agree
        d_got = np.linalg.norm(q - t[np.asarray(idx)], axis=1)
        np.testing.assert_allclose(d_got, rdist, atol=1e-5)

    def test_surface_cloud_small_h(self, rng):
        # surface-like data, h ~ 2x spacing: the production regime
        u = np.linspace(0, 2, 60)
        xx, yy = np.meshgrid(u, u)
        zz = 0.1 * np.sin(xx * 3) + 0.05 * yy
        t = np.stack([xx, yy, zz], -1).reshape(-1, 3).astype(np.float32)
        q = (t[rng.choice(len(t), 500, replace=False)]
             + rng.normal(scale=5e-3, size=(500, 3)).astype(np.float32))
        grid = build_grid(t, h=0.07)
        idx, dist = grid_nn1(jnp.asarray(q), grid)
        ridx, rdist = _brute(q, t)
        np.testing.assert_allclose(np.asarray(dist), rdist, atol=1e-5)

    def test_fallback_exactness_far_queries(self, rng):
        # queries far outside the grid window force the brute fallback
        t = rng.uniform(0, 1, size=(800, 3)).astype(np.float32)
        q_near = t[:100] + rng.normal(scale=1e-3, size=(100, 3)).astype(
            np.float32)
        q_far = (rng.uniform(0, 1, size=(50, 3)) + 5.0).astype(np.float32)
        q = np.vstack([q_near, q_far])
        grid = build_grid(t, h=0.1)
        idx, dist = grid_nn1(jnp.asarray(q), grid)
        ridx, rdist = _brute(q, t)
        np.testing.assert_allclose(np.asarray(dist), rdist, atol=1e-4)

    def test_nonuniform_density(self, rng):
        a = rng.normal(scale=0.01, size=(2000, 3))
        b = rng.normal(scale=2.0, size=(500, 3)) + 5.0
        t = np.vstack([a, b]).astype(np.float32)
        q = np.vstack([a[:200] + 1e-4, b[:100] + 1e-3]).astype(np.float32)
        grid = build_grid(t, h=0.05)
        idx, dist = grid_nn1(jnp.asarray(q), grid)
        _, rdist = _brute(q, t)
        np.testing.assert_allclose(np.asarray(dist), rdist, atol=1e-5)

    def test_masked_queries(self, rng):
        t = rng.uniform(size=(500, 3)).astype(np.float32)
        q = rng.uniform(size=(100, 3)).astype(np.float32)
        m = np.zeros(100, dtype=bool)
        m[:60] = True
        grid = build_grid(t, h=0.2)
        idx, dist = grid_nn1(jnp.asarray(q), grid, q_mask=jnp.asarray(m))
        _, rdist = _brute(q[:60], t)
        np.testing.assert_allclose(np.asarray(dist)[:60], rdist, atol=1e-5)
        assert np.isinf(np.asarray(dist)[60:]).all()

    def test_masked_targets_in_build(self, rng):
        t = rng.uniform(size=(500, 3)).astype(np.float32)
        tm = np.zeros(500, dtype=bool)
        tm[:300] = True
        q = rng.uniform(size=(100, 3)).astype(np.float32)
        grid = build_grid(t, h=0.2, mask=tm)
        idx, dist = grid_nn1(jnp.asarray(q), grid)
        _, rdist = _brute(q, t[:300])
        np.testing.assert_allclose(np.asarray(dist), rdist, atol=1e-5)

    def test_agrees_with_brute_kernel(self, rng):
        # cross-check the two production kernels against each other
        t = rng.uniform(0, 3, size=(4000, 3)).astype(np.float32)
        q = rng.uniform(0, 3, size=(1500, 3)).astype(np.float32)
        grid = build_grid(t, h=0.3)
        gi, gd = grid_nn1(jnp.asarray(q), grid)
        bi, bd = nn1(jnp.asarray(q), jnp.asarray(t))
        np.testing.assert_allclose(np.asarray(gd), np.asarray(bd), atol=1e-5)


class TestGridPercentile:
    def test_matches_reference_semantics(self, rng):
        from piecewise_icp.ops.grid_nn import grid_percentile

        t = rng.uniform(0, 2, size=(2000, 3)).astype(np.float32)
        s = rng.uniform(0, 2, size=(1500, 3)).astype(np.float32)
        grid = build_grid(t, h=0.2)
        p = float(grid_percentile(jnp.asarray(s), grid, 0.75))
        _, d = _brute(s, t)
        ref = np.sort(d)[int(1500 * 0.75)]
        assert abs(p - ref) < 1e-5

    def test_exact_with_far_stragglers(self, rng):
        from piecewise_icp.ops.grid_nn import grid_percentile

        t = rng.uniform(0, 1, size=(1000, 3)).astype(np.float32)
        s_near = (t[:700] + rng.normal(scale=1e-3, size=(700, 3))
                  ).astype(np.float32)
        s_far = (rng.uniform(0, 1, size=(300, 3)) + 3.0).astype(np.float32)
        s = np.vstack([s_near, s_far])
        grid = build_grid(t, h=0.15)
        # the 90th percentile falls INSIDE the far stragglers — subset
        # fallback must make it exact
        p = float(grid_percentile(jnp.asarray(s), grid, 0.9))
        _, d = _brute(s, t)
        ref = np.sort(d)[int(1000 * 0.9)]
        assert abs(p - ref) < 1e-4

    def test_masked_sources(self, rng):
        from piecewise_icp.ops.grid_nn import grid_percentile

        t = rng.uniform(size=(800, 3)).astype(np.float32)
        s = rng.uniform(size=(600, 3)).astype(np.float32)
        m = np.zeros(600, dtype=bool)
        m[:400] = True
        grid = build_grid(t, h=0.2)
        p = float(grid_percentile(jnp.asarray(s), grid, 0.5,
                                  s_mask=jnp.asarray(m)))
        _, d = _brute(s[:400], t)
        ref = np.sort(d)[int(400 * 0.5)]
        assert abs(p - ref) < 1e-5


class TestGridSelfKnn:
    def test_exact_knn_full_windows(self, rng):
        """The bucket-padded self-join delivers EXACT kNN for every real
        point — inside the window by the grid query, beyond it by the
        straggler fallback — in the grid's sorted order."""
        from piecewise_icp.ops.grid_nn import build_grid, grid_self_knn

        pts = (rng.uniform(size=(3000, 2)) * np.array([2.0, 1.0]))
        z = 0.1 * np.sin(pts[:, 0] * 4)
        pts = np.column_stack([pts, z]).astype(np.float32)
        k, h = 8, 0.12
        grid = build_grid(pts, h)
        nbr, d = (np.asarray(a) for a in grid_self_knn(grid, k))
        n = grid.n_real
        assert grid.points.shape[0] > n           # bucket padding exists
        idx_orig = grid.ids[:n]
        d2 = ((pts[:, None, :].astype(np.float64)
               - pts[None, :, :].astype(np.float64)) ** 2).sum(-1)
        ref_d = np.sqrt(np.sort(d2, axis=1)[:, :k])
        np.testing.assert_allclose(d[:n], ref_d[idx_orig],
                                   rtol=1e-4, atol=1e-6)
        # neighbour rows index the sorted cloud, self first
        assert (nbr[:n, 0] == np.arange(n)).all()
        assert (nbr[n:] == -1).all()
