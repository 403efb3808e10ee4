"""NN kernels (brute references and the XLA grid queries) vs exact
float64 brute force."""

import jax.numpy as jnp
import numpy as np
import pytest

from piecewise_icp.ops.grid_nn import (build_grid, grid_knn,
                                           grid_query_1nn, grid_self_knn)
from piecewise_icp.ops.nn import knn, nn1


_ULP = 2.4e-7          # two f32 roundings, relative


def _brute(q, t):
    d2 = ((q[:, None, :].astype(np.float64)
           - t[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return d2.argmin(1), np.sqrt(d2.min(1))


def _brute_knn_d(q, t, k):
    d2 = ((q[:, None, :].astype(np.float64)
           - t[None, :, :].astype(np.float64)) ** 2).sum(-1)
    return np.sqrt(np.sort(d2, axis=1)[:, :k])


class TestBruteNN:
    @pytest.mark.parametrize("nq,nt", [(700, 900), (513, 1025)])
    def test_matches_brute(self, rng, nq, nt):
        q = rng.normal(size=(nq, 3)).astype(np.float32)
        t = rng.normal(size=(nt, 3)).astype(np.float32)
        idx, dist = nn1(jnp.asarray(q), jnp.asarray(t))
        _, rdist = _brute(q, t)
        np.testing.assert_allclose(np.asarray(dist), rdist, atol=1e-5)
        d_got = np.linalg.norm(q - t[np.asarray(idx)], axis=1)
        np.testing.assert_allclose(d_got, rdist, atol=1e-5)
        # the k-NN kernel's first neighbour is the same
        _, kd = knn(jnp.asarray(q), jnp.asarray(t), 3)
        np.testing.assert_allclose(np.asarray(kd)[:, 0], rdist, atol=1e-5)

    def test_masks(self, rng):
        q = rng.normal(size=(100, 3)).astype(np.float32)
        t = rng.normal(size=(300, 3)).astype(np.float32)
        tm = np.zeros(300, dtype=bool)
        tm[:120] = True
        qm = np.ones(100, dtype=bool)
        qm[5:15] = False
        idx, dist = nn1(jnp.asarray(q), jnp.asarray(t),
                        q_mask=jnp.asarray(qm), t_mask=jnp.asarray(tm))
        _, rdist = _brute(q, t[:120])
        np.testing.assert_allclose(np.asarray(dist)[qm], rdist[qm],
                                   atol=1e-5)
        assert (np.asarray(idx)[qm] < 120).all()
        assert np.isinf(np.asarray(dist)[~qm]).all()

    def test_mm_scale_precision(self, rng):
        base = rng.normal(scale=30.0, size=(600, 3)).astype(np.float32)
        q = base + rng.normal(scale=0.002, size=(600, 3)).astype(np.float32)
        idx, dist = nn1(jnp.asarray(q), jnp.asarray(base))
        d_exact = np.linalg.norm(
            q.astype(np.float64) - base[np.asarray(idx)], axis=1)
        np.testing.assert_allclose(np.asarray(dist), d_exact,
                                   rtol=1e-3, atol=2e-6)


def _query(q, grid, q_mask=None, q_tile=None):
    if q_mask is None:
        q_mask = jnp.ones((q.shape[0],), bool)
    return (np.asarray(a) for a in grid_query_1nn(
        jnp.asarray(q), q_mask, jnp.asarray(grid.points),
        jnp.asarray(grid.cell_starts), jnp.asarray(grid.origin),
        jnp.asarray(grid.dims, jnp.int32), grid.max_run,
        jnp.asarray(grid.h, jnp.float32), q_tile=q_tile))


class TestGridQuery1NN:
    """Grid 1-NN: every resolved query exact, every unresolved one
    farther than h (the dichotomy the percentile relies on), whatever the
    query order or tile size."""

    @pytest.mark.parametrize("q_tile", [256, 2048, 16384])
    def test_coherent_queries_all_exact(self, rng, q_tile):
        t = (rng.uniform(size=(8000, 3))
             * np.array([3.0, 2.0, 1.0])).astype(np.float32)
        grid = build_grid(t, h=0.02)
        q = t + rng.normal(scale=0.004, size=t.shape).astype(np.float32)
        idx, d, res = _query(q, grid, q_tile=q_tile)
        bi, bd = (np.asarray(a) for a in
                  nn1(jnp.asarray(q), jnp.asarray(grid.points)))
        assert res.mean() > 0.999
        # same distances to within one f32 rounding (the two kernels fuse
        # the same arithmetic differently); the same neighbour except at
        # exact ties
        np.testing.assert_allclose(d[res], bd[res], rtol=_ULP, atol=0)
        tie = np.isclose(d, bd, rtol=_ULP, atol=0) & (idx != bi)
        assert (idx[res] == bi[res]).mean() > 0.999 and tie.sum() < 8
        assert (bd[~res] > grid.h).all()   # dichotomy for the rest

    @pytest.mark.parametrize("q_tile", [256, 2048])
    def test_resolved_always_exact_even_scrambled(self, rng, q_tile):
        t = (rng.uniform(size=(20000, 3)) * 8.0).astype(np.float32)
        q = (rng.uniform(size=(3000, 3)) * 8.0).astype(np.float32)
        grid = build_grid(t, h=0.15)
        _, d, res = _query(q, grid, q_tile=q_tile)
        bd = np.asarray(nn1(jnp.asarray(q), jnp.asarray(grid.points))[1])
        np.testing.assert_allclose(d[res], bd[res], rtol=_ULP, atol=0)
        assert (bd[~res] > grid.h).all()

    def test_masked_queries(self, rng):
        t = (rng.uniform(size=(5000, 3)) * 2.0).astype(np.float32)
        grid = build_grid(t, h=0.05)
        q = t.copy()
        qm = np.ones(q.shape[0], bool)
        qm[::3] = False
        _, d, res = _query(q, grid, jnp.asarray(qm))
        assert np.isinf(d[~qm]).all()
        assert res[~qm].all()          # masked queries count as resolved
        assert (d[qm] == 0.0).all()    # q is a copy of t

    def test_tile_size_invariance(self, rng):
        # surface-like cloud: the tile size must not change one bit
        xy = (rng.uniform(size=(5000, 2))
              * np.array([3.0, 2.0])).astype(np.float32)
        z = 0.2 * np.sin(xy[:, 0] * 3) + rng.normal(scale=0.002, size=5000)
        t = np.column_stack([xy, z]).astype(np.float32)
        grid = build_grid(t, h=0.06)
        q = t + rng.normal(scale=0.01, size=t.shape).astype(np.float32)
        a = list(_query(q, grid, q_tile=128))
        b = list(_query(q, grid, q_tile=8192))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def _surface(rng, n, extent=(3.0, 2.0)):
    xy = (rng.uniform(size=(n, 2)) * np.array(extent)).astype(np.float32)
    z = (0.2 * np.sin(xy[:, 0] * 2) * np.cos(xy[:, 1] * 3)
         + rng.normal(scale=0.003, size=n))
    return np.column_stack([xy, z]).astype(np.float32)


class TestGridKnn:
    """Grid k-NN with the straggler fallback: exact for every query."""

    def test_self_join_matches_brute(self, rng):
        t = _surface(rng, 6000)
        k = 9
        grid = build_grid(t, h=0.09)
        nbr, d = (np.asarray(a) for a in grid_self_knn(grid, k))
        n = grid.n_real
        q = grid.points[:n]
        ref_d = _brute_knn_d(q, q, k)
        np.testing.assert_allclose(d[:n], ref_d, rtol=1e-5, atol=1e-6)
        # self first, at distance 0; padding rows carry no neighbours
        assert (d[:n, 0] == 0.0).all()
        assert (nbr[n:] == -1).all()

    def test_indices_are_real_neighbours(self, rng):
        t = (rng.uniform(size=(4000, 3)) * 2.0).astype(np.float32)
        grid = build_grid(t, h=0.15)
        k = 6
        nbr, d = (np.asarray(a) for a in grid_self_knn(grid, k))
        n = grid.n_real
        got = grid.points[nbr[:n]]                 # [n, k, 3]
        dd = np.linalg.norm(got.astype(np.float64)
                            - grid.points[:n][:, None, :], axis=-1)
        np.testing.assert_allclose(dd, d[:n], rtol=1e-5, atol=1e-6)
        for row in nbr[:200]:                      # no duplicate ids
            assert len(set(row.tolist())) == k

    def test_masked_and_edge_queries(self, rng):
        t = (rng.uniform(size=(3000, 3))
             * np.array([4.0, 0.5, 0.5])).astype(np.float32)
        grid = build_grid(t, h=0.1)
        qm = np.ones(t.shape[0], bool)
        qm[::5] = False
        k = 4
        idx, d = (np.asarray(a) for a in
                  grid_knn(jnp.asarray(t), grid, k, q_mask=jnp.asarray(qm)))
        assert np.isinf(d[~qm]).all()
        ref_d = _brute_knn_d(t, t, k)
        np.testing.assert_allclose(d[qm], ref_d[qm], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            np.linalg.norm(t[idx[qm]] - t[qm][:, None, :], axis=-1),
            d[qm], rtol=1e-5, atol=1e-6)

    def test_stragglers_exact(self, rng):
        # a dense surface plus sparse far points: the far points' k-th
        # neighbour lies beyond every window and must come from the
        # brute fallback
        t = np.vstack([_surface(rng, 3000),
                       (rng.uniform(size=(40, 3)) * 4.0
                        + np.array([0.0, 0.0, 3.0])).astype(np.float32)])
        grid = build_grid(t, h=0.12)
        k = 8
        idx, d = (np.asarray(a) for a in grid_knn(jnp.asarray(t), grid, k))
        ref_d = _brute_knn_d(t, t, k)
        np.testing.assert_allclose(d, ref_d, rtol=1e-5, atol=1e-6)
        assert (d[-40:, -1] > grid.h).all()      # they were stragglers

    def test_coarse_pass_exact(self, rng, monkeypatch):
        # h tight for k: most queries straggle in the first window; the
        # twice-coarser pass must resolve them exactly, leaving the brute
        # kernel only the few scene corners
        from piecewise_icp.ops import grid_nn

        t = _surface(rng, 3000)
        grid = build_grid(t, h=0.07)
        k = 12
        _, d1, res1 = grid_nn._grid_query_k(
            jnp.asarray(t), jnp.ones((len(t),), bool),
            jnp.asarray(grid.points), jnp.asarray(grid.cell_starts),
            jnp.asarray(grid.origin), jnp.asarray(grid.dims, jnp.int32),
            grid.max_run, k, jnp.float32(grid.h))
        assert (~np.asarray(res1)).mean() > 0.5
        brute_rows = []

        def counting_knn(q, *a, **kw):
            brute_rows.append(q.shape[0])
            return knn(q, *a, **kw)

        monkeypatch.setattr(grid_nn, "brute_knn", counting_knn)
        _, d = grid_knn(jnp.asarray(t), grid, k)
        np.testing.assert_allclose(np.asarray(d), _brute_knn_d(t, t, k),
                                   rtol=1e-5, atol=1e-6)
        assert sum(brute_rows) <= 512            # one minimal bucket

    def test_inexact_mode_leaves_stragglers(self, rng):
        t = np.vstack([_surface(rng, 2000),
                       np.array([[0.0, 0.0, 5.0]], np.float32)])
        grid = build_grid(t, h=0.12)
        _, d_fast = grid_knn(jnp.asarray(t), grid, 4, exact=False)
        _, d_exact = grid_knn(jnp.asarray(t), grid, 4)
        assert np.isinf(np.asarray(d_fast)[-1, 1:]).all()
        assert np.isfinite(np.asarray(d_exact)[-1]).all()
