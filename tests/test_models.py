"""Model-layer tests: segmentation, inner ICP, VCM, the Piecewise-ICP core
loop, chaining, Kalman smoothing."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

SYN_DATA = "/root/reference/python/data/data_synthetic"

from piecewise_icp.config import ARC_TO_GON, PiecewiseICPConfig
from piecewise_icp.models.chaining import (absolute_errors,
                                               chain_to_reference)
from piecewise_icp.models.icp import compute_vcm, point_to_plane_icp
from piecewise_icp.models.kalman import kalman_smooth_transforms
from piecewise_icp.models.piecewise_icp import piecewise_icp
from piecewise_icp.models.segmentation import build_patches, \
    estimate_normals, knn_graph
from piecewise_icp.ops.transform import (adjoint_6x6,
                                             apply_transform_np,
                                             matrix_to_params_gon,
                                             params_to_matrix)

from util import make_pair, small_test_config, terrain_cloud


class TestNormals:
    def test_plane_normals(self, rng):
        pts = terrain_cloud(rng, n_side=40, noise=1e-5)
        nbr = knn_graph(pts, 20)
        normals = estimate_normals(pts, nbr)
        norms = np.linalg.norm(normals, axis=1)
        np.testing.assert_allclose(norms, 1.0, atol=1e-4)
        # mostly upward-ish surface: |nz| should dominate on this terrain
        assert (np.abs(normals[:, 2]) > 0.5).mean() > 0.9


class TestSegmentationModel:
    def test_build_patches_terrain(self, rng):
        pts = terrain_cloud(rng, n_side=60)
        cfg = small_test_config()
        ps = build_patches(pts, 0.3, cfg)
        assert ps.num_patches >= 10
        assert (ps.counts >= cfg.min_patch_points).all()
        assert ps.boundary.shape == (ps.num_patches, 6, 3)
        # labels reference valid patches only
        assert ps.labels.max() < ps.num_patches
        # centroid of each patch ~ mean of its member points
        for p in range(0, ps.num_patches, max(ps.num_patches // 5, 1)):
            members = ps.points[ps.labels == p]
            np.testing.assert_allclose(ps.centroids[p], members.mean(0),
                                       atol=1e-3)
        # std_ct = std_bp / N (reference calBPandCTSTD semantics)
        np.testing.assert_allclose(ps.std_ct,
                                   ps.std_bp / np.maximum(ps.counts, 1),
                                   rtol=1e-5)

    def test_boundary_points_are_extremal_members(self, rng):
        pts = terrain_cloud(rng, n_side=50)
        ps = build_patches(pts, 0.3, small_test_config())
        p = ps.num_patches // 2
        members = ps.points[ps.labels == p]
        bp = ps.boundary[p]
        assert bp[0, 0] == pytest.approx(members[:, 0].max())
        assert bp[1, 0] == pytest.approx(members[:, 0].min())
        assert bp[2, 1] == pytest.approx(members[:, 1].max())
        assert bp[5, 2] == pytest.approx(members[:, 2].min())

    def test_patch_normals_unit_and_planar(self, rng):
        pts = terrain_cloud(rng, n_side=50)
        ps = build_patches(pts, 0.3, small_test_config())
        np.testing.assert_allclose(np.linalg.norm(ps.normals, axis=1), 1.0,
                                   atol=1e-4)
        # residuals to the fitted plane should be small
        for p in range(0, ps.num_patches, max(ps.num_patches // 4, 1)):
            members = ps.points[ps.labels == p]
            d = np.abs((members - ps.centroids[p]) @ ps.normals[p])
            assert d.mean() < 0.02


class TestInnerICP:
    def _centroid_scene(self, rng, n=300):
        ct = terrain_cloud(rng, n_side=20, noise=0.0)[:n]
        # normals: upward-ish randomised unit vectors
        nrm = rng.normal(size=(len(ct), 3)) * 0.15
        nrm[:, 2] += 1.0
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        return ct.astype(np.float32), nrm.astype(np.float32)

    def test_recovers_small_transform(self, rng):
        ct, nrm = self._centroid_scene(rng)
        params = np.array([0.004, -0.003, 0.006, 0.01, -0.02, 0.015])
        t_true = params_to_matrix(params)
        src = apply_transform_np(ct.astype(np.float64),
                                 np.linalg.inv(t_true)).astype(np.float32)
        mask = np.ones(len(ct), dtype=bool)
        t_est, iters = point_to_plane_icp(
            jnp.asarray(ct), jnp.asarray(nrm), jnp.asarray(mask),
            jnp.asarray(src), jnp.asarray(mask))
        t_est = np.asarray(t_est, dtype=np.float64)
        err = matrix_to_params_gon(t_est) - matrix_to_params_gon(t_true)
        assert np.abs(err[:3]).max() / ARC_TO_GON < 2e-5   # < ~0.02 mrad
        assert np.abs(err[3:]).max() < 5e-5                # < 0.05 mm
        assert int(iters) < 100

    def test_masked_sources_ignored(self, rng):
        ct, nrm = self._centroid_scene(rng)
        src = ct.copy()
        src[200:] += 100.0  # wildly wrong points, masked out
        mask_t = np.ones(len(ct), dtype=bool)
        mask_s = np.ones(len(ct), dtype=bool)
        mask_s[200:] = False
        t_est, _ = point_to_plane_icp(
            jnp.asarray(ct), jnp.asarray(nrm), jnp.asarray(mask_t),
            jnp.asarray(src), jnp.asarray(mask_s))
        np.testing.assert_allclose(np.asarray(t_est), np.eye(4), atol=1e-4)


class TestVCM:
    def test_matches_direct_least_squares(self, rng):
        ct = rng.normal(size=(100, 3)).astype(np.float32)
        nrm = rng.normal(size=(100, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm.astype(np.float32)
        src = (ct + rng.normal(scale=1e-3, size=ct.shape)).astype(np.float32)
        mask = np.ones(100, dtype=bool)
        vcm, x_update, _s0 = compute_vcm(ct, nrm, mask, src, mask)
        # direct reference computation (identical correspondence = identity
        # here because src is a small perturbation of ct)
        q = src.astype(np.float64)
        n_ = nrm.astype(np.float64)
        p = ct.astype(np.float64)
        a = np.column_stack([
            n_[:, 2] * q[:, 1] - n_[:, 1] * q[:, 2],
            n_[:, 0] * q[:, 2] - n_[:, 2] * q[:, 0],
            n_[:, 1] * q[:, 0] - n_[:, 0] * q[:, 1],
            n_[:, 0], n_[:, 1], n_[:, 2]])
        l = np.sum(n_ * (p - q), axis=1)
        qxx = np.linalg.inv(a.T @ a)
        x = qxx @ a.T @ l
        v = a @ x - l
        ref = (v @ v) / (100 - 6) * qxx
        np.testing.assert_allclose(vcm, ref, rtol=1e-3, atol=1e-14)
        assert (np.diag(vcm) > 0).all()


class TestPiecewiseICPCore:
    def test_recovers_known_transform(self, rng):
        params = np.array([0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005])
        c1, c2, t_true = make_pair(rng, params)
        cfg = small_test_config()
        res = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg)
        # registration maps cloud2 back onto cloud1: T_est ≈ T_true^-1, so
        # M = T_est @ T_true should displace no point by more than the
        # statistical floor of this small scene (~150 patches)
        m = res.trans_mat @ t_true
        disp = np.linalg.norm(apply_transform_np(c2.astype(np.float64), m)
                              - c2.astype(np.float64), axis=1)
        assert disp.mean() < 2e-3     # mean residual < 2 mm
        assert disp.max() < 5e-3      # worst-case corner < 5 mm
        assert res.vcm.shape == (6, 6)
        assert (np.diag(res.vcm) > 0).all()
        assert res.dt_series[0] == pytest.approx(cfg.dt_init)
        # monotone non-increasing DT
        assert all(b <= a + 1e-9 for a, b in
                   zip(res.dt_series, res.dt_series[1:]))

    def test_grid_nn_impl_matches_quality(self, rng):
        """The grid-hash kNN-graph path must deliver comparable accuracy to
        the exact native graph (approximate stragglers only)."""
        params = np.array([0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005])
        c1, c2, t_true = make_pair(rng, params)
        cfg = small_test_config(nn_impl="auto")
        res = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg)
        m = res.trans_mat @ t_true
        disp = np.linalg.norm(apply_transform_np(c2.astype(np.float64), m)
                              - c2.astype(np.float64), axis=1)
        assert disp.mean() < 3e-3
        assert disp.max() < 8e-3
        # pyramid-edge patches are rightly rejected at tight DT;
        # a healthy run still keeps a meaningful stable core (0.17 with
        # the propagate segmenter's finer patch decomposition)
        assert res.stable_ratio > 0.1


class TestSeedLatticeAlignment:
    def test_decomposition_immune_to_bbox_jitter(self, rng):
        """With seed_grid_align, the supervoxel lattice is anchored to the
        world frame, so a bounding-box change in one epoch (an extra
        extremal point — outliers surviving SOR, growing deformation at
        the scene edge) cannot re-phase the other epoch's decomposition.
        Anchoring at the per-cloud minimum (round-3 behaviour) shifts the
        lattice by the bbox delta and re-cuts every patch."""
        import dataclasses as dc

        cloud_a = terrain_cloud(rng, n_side=70)
        # epoch B: the SAME points plus one extremal point that drags the
        # bounding-box minimum by ~0.4 supervoxels
        extra = np.array([[-0.088, -0.088, -0.05]], dtype=np.float32)
        cloud_b = np.vstack([cloud_a, extra])
        n = len(cloud_a)

        def partition_agreement(cfg):
            ps_a = build_patches(cloud_a, cfg.svsize1, cfg,
                                 resolution=cfg.res1)
            ps_b = build_patches(cloud_b, cfg.svsize1, cfg,
                                 resolution=cfg.res1)
            la, lb = ps_a.labels, ps_b.labels[:n]
            sel = (la >= 0) & (lb >= 0)
            # co-partition agreement: fraction of selected points whose
            # patch's majority-mapped counterpart matches
            pairs = {}
            for a, b in zip(la[sel], lb[sel]):
                pairs[(a, b)] = pairs.get((a, b), 0) + 1
            best = {}
            for (a, b), c in pairs.items():
                if c > best.get(a, (0, -1))[0]:
                    best[a] = (c, b)
            agree = sum(c for (a, b), c in pairs.items()
                        if best[a][1] == b) / max(sel.sum(), 1)
            return agree

        cfg = small_test_config()
        agree_on = partition_agreement(dc.replace(cfg,
                                                  seed_grid_align=True))
        agree_off = partition_agreement(dc.replace(cfg,
                                                   seed_grid_align=False))
        # aligned lattice: the extra point cannot re-phase the lattice, so
        # the shared points keep (essentially) their decomposition
        assert agree_on > 0.95, f"aligned agreement only {agree_on:.2f}"
        # per-min anchoring re-phases every cell by ~0.4 sv
        assert agree_on > agree_off + 0.05


class TestSymmetricVariant:
    """Regression guards for the symmetric point-to-plane variant.

    Round-3 bench caught the variant silently regressing 30x in
    translation (VERDICT r3 weak #3): the normalised-bisector residual
    gave full weight to inconsistent correspondences during the coarse
    stage-1 iterations.  Guarded twice: the small-scene variant parity
    below, and the real bench-pair pin in
    test_symmetric_bench_pair_regression.
    """

    def test_small_scene_variant_parity(self, rng):
        params = np.array([0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005])
        c1, c2, t_true = make_pair(rng, params)
        errs = {}
        for variant in ("reference", "symmetric"):
            cfg = small_test_config(icp_variant=variant)
            res = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg)
            m = res.trans_mat @ t_true
            disp = np.linalg.norm(
                apply_transform_np(c2.astype(np.float64), m)
                - c2.astype(np.float64), axis=1)
            errs[variant] = disp.mean()
        assert errs["symmetric"] < 2e-3
        # the refinement objective must not be materially worse than the
        # reference objective on a clean scene
        assert errs["symmetric"] < 2.0 * errs["reference"] + 2e-4

    def test_inverse_variance_weighting_parity(self, rng):
        """The Gauss-Markov row weighting must recover transforms at least
        as well as uniform weights on a clean scene (opt-in option)."""
        import dataclasses as dc

        params = np.array([0.002, -0.0015, 0.0025, 0.004, -0.006, 0.005])
        c1, c2, t_true = make_pair(rng, params)
        errs = {}
        for weighting in ("uniform", "inverse_variance"):
            cfg = small_test_config(icp_weighting=weighting)
            res = piecewise_icp(c1, c2, cfg.res1, cfg.res2, cfg)
            m = res.trans_mat @ t_true
            disp = np.linalg.norm(
                apply_transform_np(c2.astype(np.float64), m)
                - c2.astype(np.float64), axis=1)
            errs[weighting] = disp.mean()
        assert errs["inverse_variance"] < 2e-3
        assert errs["inverse_variance"] < 1.5 * errs["uniform"] + 2e-4

    @pytest.mark.skipif(not os.path.exists(SYN_DATA),
                        reason="reference synthetic data not mounted")
    def test_symmetric_bench_pair_regression(self):
        """Pin the bench pair (Epoch_001 <- Epoch_002) symmetric error.

        Round-3 BENCH showed trans_err 3.794 mm (vs 0.079-0.122 mm in
        rounds 1-2); the stage-gated unnormalised-bisector fix restores
        ~0.25 mm.  Bound at 1 mm / 10 mgon to keep headroom for
        segmentation evolution while catching any 30x-class regression.
        """
        import dataclasses as dc

        from piecewise_icp.io import formats, read_pcd
        from piecewise_icp.models.pairwise import register_pair
        from piecewise_icp.ops.transform import matrix_to_params_gon

        syn = SYN_DATA
        cfg = small_test_config(
            set_res_svsize=True, res1=0.005, res2=0.005,
            svsize1=0.05, svsize2=0.05, set_dtinit=True,
            dt_init=0.05, dt_min=0.004, nn_impl="auto",
            icp_variant="symmetric",
            point_pad_multiple=8192, patch_pad_multiple=256)
        pts1 = read_pcd(
            f"{syn}/syntheticPC_with_transformations/Epoch_001.pcd")
        pts2 = read_pcd(
            f"{syn}/syntheticPC_with_transformations/Epoch_002.pcd")
        _, gt = formats.read_ground_truth_transforms(
            f"{syn}/defined_transformations.txt")
        r = register_pair(pts1, pts2, cfg, sor_mult=cfg.sor_std_mult_4d)
        err = (matrix_to_params_gon(r.trans_mat)
               - matrix_to_params_gon(gt[1]))
        assert np.abs(err[3:]).max() * 1000 < 1.0   # mm
        assert np.abs(err[:3]).max() * 1000 < 10.0  # mgon


class TestChaining:
    def _random_se3(self, rng, scale=1e-3):
        return params_to_matrix(np.concatenate([
            rng.normal(scale=scale, size=3), rng.normal(scale=scale, size=3)]))

    def test_direct_mode_copies(self, rng):
        tms = [self._random_se3(rng) for _ in range(3)]
        vcms = [np.eye(6) * 1e-8 for _ in range(3)]
        out_t, out_v = chain_to_reference(tms, vcms, pair_mode=0)
        for a, b in zip(out_t, tms):
            np.testing.assert_allclose(a, b)

    def test_fixed_interval_accumulates(self, rng):
        tms = [self._random_se3(rng) for _ in range(4)]
        vcms = [np.eye(6) * (k + 1) * 1e-9 for k in range(4)]
        out_t, out_v = chain_to_reference(tms, vcms, pair_mode=1)
        # epoch 4 (index 3) maps 4→3→2→1→0, so T = T0 @ T1 @ T2 @ T3
        # (walk-backward left-composition, Registration.cpp:1100-1105)
        ref = tms[0] @ tms[1] @ tms[2] @ tms[3]
        np.testing.assert_allclose(out_t[3], ref, atol=1e-12)
        # VCM simple adding
        np.testing.assert_allclose(out_v[3], sum(vcms), atol=1e-15)

    def test_adaptive_adjoint_propagation(self, rng):
        # pairs: source->target (relative): 1->0, 2->1, 3->1
        pairs = {1: 0, 2: 1, 3: 1}
        tms = [self._random_se3(rng) for _ in range(3)]
        vcms = [np.diag(rng.uniform(1e-9, 1e-8, size=6)) for _ in range(3)]
        out_t, out_v = chain_to_reference(tms, vcms, pair_mode=-1,
                                          reg_pairs=pairs)
        # epoch 3 chains through target 1: T = T(1) @ T(3)
        np.testing.assert_allclose(out_t[2], tms[0] @ tms[2], atol=1e-12)
        ad = adjoint_6x6(tms[0])
        ref_v = vcms[0] + ad @ vcms[2] @ ad.T
        np.testing.assert_allclose(out_v[2], ref_v, atol=1e-15)
        # epoch 2 chains through 1: T = T(1) @ T(2)
        np.testing.assert_allclose(out_t[1], tms[0] @ tms[1], atol=1e-12)

    def test_absolute_errors_units(self, rng):
        t_est = params_to_matrix([0, 0, 0, 0.001, 0, 0])
        t_ref = np.eye(4)
        err = absolute_errors([t_est], [t_ref])
        assert err[0, 3] == pytest.approx(1.0)  # 1 mm
        assert err[0, 0] == pytest.approx(0.0, abs=1e-9)


class TestKalman:
    def test_smoother_reduces_noise(self, rng):
        n = 30
        true_params = np.cumsum(rng.normal(scale=1e-5, size=(n, 6)), axis=0)
        meas_noise = 2e-4
        mats, vcms = [], []
        for k in range(n):
            noisy = true_params[k] + rng.normal(scale=meas_noise, size=6)
            mats.append(params_to_matrix(noisy))
            vcms.append(np.eye(6) * meas_noise ** 2)
        sm = kalman_smooth_transforms(mats, vcms, process_noise=1e-10)
        raw_err = np.abs(np.stack(
            [matrix_to_params_gon(m) / np.array([ARC_TO_GON] * 3 + [1] * 3)
             for m in mats]) - true_params)
        sm_err = np.abs(sm.params - true_params)
        assert sm_err.mean() < raw_err.mean() * 0.6
        assert sm.covariances.shape == (n, 6, 6)
        # smoothed covariance strictly tighter than measurement covariance
        assert np.trace(sm.covariances[n // 2]) < np.trace(vcms[n // 2])

    def test_empty_and_single(self):
        sm = kalman_smooth_transforms([], [])
        assert sm.params.shape == (0, 6)
        m = params_to_matrix([1e-4, 0, 0, 1e-3, 0, 0])
        sm = kalman_smooth_transforms([m], [np.eye(6) * 1e-8])
        np.testing.assert_allclose(sm.trans_mats[0], m, atol=1e-9)

    def test_matches_dense_map_solution(self, rng):
        """The RTS recursion must equal the closed-form MAP solution of the
        linear-Gaussian model — means AND covariances.  Any sign/transpose
        error in the gain or smoother recursion fails this exactly."""
        n, q_diag = 12, 1e-8
        z = np.cumsum(rng.normal(scale=2e-4, size=(n, 6)), axis=0) * 1e-2
        mats = [params_to_matrix(p) for p in z]
        vcms = []
        for _ in range(n):
            a = rng.normal(scale=1e-4, size=(6, 6))
            vcms.append(a @ a.T + np.eye(6) * 1e-8)
        sm = kalman_smooth_transforms(mats, vcms, process_noise=q_diag)

        # dense MAP: prior x0 ~ N(z0, R0 + Q) (the filter's init), walk
        # increments ~ N(0, Q), measurements z_k ~ N(x_k, R_k)
        q = np.eye(6) * q_diag
        qi = np.linalg.inv(q)
        big_j = np.zeros((6 * n, 6 * n))
        big_b = np.zeros(6 * n)
        p0i = np.linalg.inv(vcms[0] + q)
        big_j[:6, :6] += p0i
        big_b[:6] += p0i @ z[0]
        for k in range(n):
            ri = np.linalg.inv(vcms[k])
            sl = slice(6 * k, 6 * k + 6)
            big_j[sl, sl] += ri
            big_b[6 * k:6 * k + 6] += ri @ z[k]
        for k in range(1, n):
            a_sl = slice(6 * (k - 1), 6 * k)
            b_sl = slice(6 * k, 6 * (k + 1))
            big_j[a_sl, a_sl] += qi
            big_j[b_sl, b_sl] += qi
            big_j[a_sl, b_sl] -= qi
            big_j[b_sl, a_sl] -= qi
        x_map = np.linalg.solve(big_j, big_b).reshape(n, 6)
        cov = np.linalg.inv(big_j)
        np.testing.assert_allclose(sm.params, x_map, rtol=1e-7, atol=1e-12)
        for k in range(n):
            np.testing.assert_allclose(
                sm.covariances[k], cov[6 * k:6 * k + 6, 6 * k:6 * k + 6],
                rtol=1e-6, atol=1e-15)

    def test_white_noise_regime_recovers_theoretical_gain(self, rng):
        """Regime the VCMs actually describe (white measurement noise drawn
        from R, true motion a Q-random-walk): the smoother's empirical MSE
        must match its own predicted covariance — a wrong gain inflates
        the MSE far beyond the prediction."""
        n, trials = 40, 15
        q_true = 1e-8
        r_diag = 4e-7
        ratios = []
        for _ in range(trials):
            truth = np.cumsum(rng.normal(scale=np.sqrt(q_true),
                                         size=(n, 6)), axis=0)
            meas = truth + rng.normal(scale=np.sqrt(r_diag), size=(n, 6))
            mats = [params_to_matrix(p) for p in meas]
            vcms = [np.eye(6) * r_diag] * n
            sm = kalman_smooth_transforms(mats, vcms, process_noise=q_true)
            err2 = (sm.params - truth) ** 2
            pred = np.stack([np.diag(c) for c in sm.covariances])
            ratios.append(err2.mean() / pred.mean())
            # and it must genuinely beat the raw measurements: steady-state
            # smoothed variance ~ sqrt(Q R) << R here
            assert err2.mean() < ((meas - truth) ** 2).mean() * 0.5
        ratio = float(np.mean(ratios))
        assert 0.6 < ratio < 1.6, f"MSE/predicted-variance ratio {ratio:.2f}"


class TestKalmanAutoQSafety:
    """auto-Q must NEVER degrade a campaign it can detect as
    motion-dominated (VERDICT r4 weak #5: scale_100 smoothed Rz 3.8x
    worse than raw), while keeping the quasi-static averaging win."""

    def _errs(self, sm, mats, truth):
        raw = np.abs(np.stack(
            [matrix_to_params_gon(m) / np.array([ARC_TO_GON] * 3 + [1] * 3)
             for m in mats]) - truth)
        return raw.mean(axis=0), np.abs(sm.params - truth).mean(axis=0)

    def test_chained_errors_moving_campaign_not_degraded(self, rng):
        """The scale_100 structure: ground truth is a random walk with
        steps well above per-pair noise, and measurement errors ACCUMULATE
        through chaining (z_k error = sum of k pair errors, propagated
        VCM ~ k * pair VCM).  The old auto-Q subtracted 2*mean(diag R) of
        the PROPAGATED covariances from the increment variance — an
        ~n-fold over-subtraction that collapsed Q to the quasi-static
        floor and flattened the moving trajectory."""
        n, pair_sig = 60, 3e-5
        worst = 0.0
        for trial in range(5):
            truth = np.cumsum(rng.normal(scale=5e-4, size=(n, 6)), axis=0)
            pair_err = rng.normal(scale=pair_sig, size=(n, 6))
            meas = truth + np.cumsum(pair_err, axis=0)
            mats = [params_to_matrix(p) for p in meas]
            vcms = [np.eye(6) * pair_sig ** 2 * (k + 1) for k in range(n)]
            sm = kalman_smooth_transforms(mats, vcms)   # auto Q
            raw_e, sm_e = self._errs(sm, mats, truth)
            worst = max(worst, float(np.max(sm_e / raw_e)))
        assert worst < 1.10, f"smoothing degraded a moving campaign {worst:.2f}x"

    def test_deterministic_drift_not_flattened(self, rng):
        """A linear trend must count as motion: np.var on the increments
        removes the mean drift, so the old estimator saw a trending series
        as static and lagged it."""
        n, noise = 40, 2e-5
        drift = np.array([3e-4, -2e-4, 1e-4, 5e-4, -4e-4, 2e-4])
        truth = np.arange(n)[:, None] * drift
        meas = truth + rng.normal(scale=noise, size=(n, 6))
        mats = [params_to_matrix(p) for p in meas]
        vcms = [np.eye(6) * noise ** 2] * n
        sm = kalman_smooth_transforms(mats, vcms)
        raw_e, sm_e = self._errs(sm, mats, truth)
        assert np.all(sm_e < raw_e * 1.10)

    def test_quasi_static_win_preserved(self, rng):
        """Independent per-epoch noise around a static truth: auto-Q must
        still detect the quasi-static regime and genuinely average."""
        n, noise = 30, 2e-4
        truth = np.zeros((n, 6))
        gains = []
        for _ in range(5):
            meas = truth + rng.normal(scale=noise, size=(n, 6))
            mats = [params_to_matrix(p) for p in meas]
            vcms = [np.eye(6) * noise ** 2] * n
            sm = kalman_smooth_transforms(mats, vcms)
            raw_e, sm_e = self._errs(sm, mats, truth)
            gains.append(float(raw_e.mean() / sm_e.mean()))
        assert np.mean(gains) > 2.0, f"static averaging gain {np.mean(gains):.2f}x"


class TestChainingFixedStride:
    def test_stride_two(self, rng):
        from piecewise_icp.models.chaining import chain_to_reference

        tms = [params_to_matrix(np.concatenate([
            rng.normal(scale=1e-3, size=3),
            rng.normal(scale=1e-3, size=3)])) for _ in range(5)]
        vcms = [np.eye(6) * (k + 1) * 1e-9 for k in range(5)]
        out_t, out_v = chain_to_reference(tms, vcms, pair_mode=2)
        # i < pairMode: direct copies (Registration.cpp:1095-1098)
        np.testing.assert_allclose(out_t[0], tms[0])
        np.testing.assert_allclose(out_t[1], tms[1])
        # i=4 (epoch 5): 5→3→1, T = T(3→1 at idx 2) ... walk idx 4, 2, 0
        ref = tms[0] @ tms[2] @ tms[4]
        np.testing.assert_allclose(out_t[4], ref, atol=1e-12)
        np.testing.assert_allclose(out_v[4], vcms[0] + vcms[2] + vcms[4],
                                   atol=1e-15)


class TestRobustRefine:
    def _scene(self, rng, n=400, leak_frac=0.15, leak_mm=2e-3):
        """Plane-ish patch centroids; a coherent sub-LoD 'changed' block
        offset along the normals (the leak the DT classification cannot
        exclude)."""
        from piecewise_icp.models.piecewise_icp import _robust_refine

        xy = rng.uniform(0, 2, size=(n, 2))
        # curved surface -> varied normals (a pure plane leaves the 6x6
        # normal equations rank-deficient and the refine bails out)
        z = 0.15 * np.sin(2 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
        ct1 = np.column_stack([xy, z]).astype(np.float32)
        gx = 0.3 * np.cos(2 * xy[:, 0]) * np.cos(1.5 * xy[:, 1])
        gy = -0.225 * np.sin(2 * xy[:, 0]) * np.sin(1.5 * xy[:, 1])
        n1 = np.column_stack([-gx, -gy, np.ones(n)])
        n1 = (n1 / np.linalg.norm(n1, axis=1, keepdims=True)).astype(
            np.float32)
        ct2 = ct1 + rng.normal(scale=2e-4, size=(n, 3)).astype(np.float32)
        n_leak = int(n * leak_frac)
        leak = np.zeros(n, bool)
        leak[rng.choice(n, n_leak, replace=False)] = True
        ct2[leak] += leak_mm * n1[leak]      # offset along the normals
        mask = np.ones(n, bool)
        return _robust_refine, ct1, n1, mask, ct2, mask.copy(), leak

    def test_rejects_coherent_leak_and_corrects(self, rng):
        rr, ct1, n1, m1, ct2, stable, leak = self._scene(rng)
        out = rr(ct1, n1, m1, ct2, stable, ct1.shape[0], ct2.shape[0],
                 min_keep=4)
        t_corr, keep, vcm_k, s0_k, vcm_all, s0_all = out
        assert t_corr is not None
        rejected = stable & ~keep
        # most rejections should be actual leak patches
        assert rejected.sum() > 0.5 * leak.sum()
        assert (rejected & leak).sum() > 0.7 * rejected.sum()
        # the correction counteracts the absorbed leak: applying it to
        # the contaminated LSQ state must REDUCE the clean-patch misfit
        from piecewise_icp.ops.transform import apply_transform_np
        clean = ~leak
        d_before = np.abs(np.einsum(
            "ij,ij->i", ct2[clean] - ct1[clean], n1[clean]))
        ct2c = apply_transform_np(ct2.astype(np.float64), t_corr)
        d_after = np.abs(np.einsum(
            "ij,ij->i", ct2c[clean] - ct1[clean], n1[clean]))
        assert d_after.mean() <= d_before.mean() + 1e-6
        assert vcm_all.shape == (6, 6) and s0_all > 0

    def test_clean_scene_is_near_identity(self, rng):
        rr, ct1, n1, m1, ct2, stable, _ = self._scene(rng, leak_frac=0.0)
        out = rr(ct1, n1, m1, ct2, stable, ct1.shape[0], ct2.shape[0],
                 min_keep=4)
        t_corr, keep, vcm_k, s0_k, vcm_all, s0_all = out
        # 95%-efficiency estimator on clean data: sub-noise correction
        assert abs(t_corr[2, 3]) < 1e-4
        assert (stable & ~keep).sum() < 0.1 * stable.sum()


class TestPatchSetTransformed:
    def test_rigid_map_including_normals(self, rng):
        from piecewise_icp.models.segmentation import PatchSet
        from piecewise_icp.ops.transform import apply_transform_np, \
            params_to_matrix

        n, p = 50, 4
        pts = rng.normal(size=(n, 3)).astype(np.float32)
        ct = rng.normal(size=(p, 3)).astype(np.float32)
        bp = rng.normal(size=(p, 6, 3)).astype(np.float32)
        nrm = rng.normal(size=(p, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        ps = PatchSet(points=pts, labels=np.zeros(n, np.int32),
                      centroids=ct, boundary=bp,
                      normals=nrm.astype(np.float32),
                      std_bp=np.ones(p, np.float32),
                      std_ct=np.ones(p, np.float32),
                      counts=np.full(p, 10, np.int32))
        t = params_to_matrix([0.3, -0.2, 0.5, 0.04, -0.02, 0.01])
        out = ps.transformed(t)
        np.testing.assert_allclose(
            out.centroids, apply_transform_np(ct.astype(np.float64), t),
            atol=1e-5)
        np.testing.assert_allclose(
            out.boundary.reshape(-1, 3),
            apply_transform_np(bp.reshape(-1, 3).astype(np.float64), t),
            atol=1e-5)
        # normals rotate (no translation), stay unit
        np.testing.assert_allclose(out.normals, nrm @ t[:3, :3].T,
                                   atol=1e-5)
        np.testing.assert_allclose(np.linalg.norm(out.normals, axis=1),
                                   1.0, atol=1e-5)


class TestWarmStart:
    def test_large_offset_recovered_with_initial_transform(self, rng):
        """A pair displaced far beyond DTinit fails (or lands in a wrong
        basin) cold; with a chain-style initial guess the registration
        recovers the exact transform and composes the guess back in."""
        from piecewise_icp.models.pairwise import register_pair

        params = np.array([0.002, -0.001, 0.002, 0.15, -0.12, 0.08])
        c1, c2, t_true = make_pair(rng, params)   # 15 cm offsets
        cfg = small_test_config()
        # registration returns ~t_true^-1 (see test_recovers_known_transform)
        guess = np.linalg.inv(np.asarray(t_true, np.float64))
        guess[:3, 3] += rng.normal(scale=2e-3, size=3)  # imperfect guess
        out = register_pair(c1, c2, cfg, initial_transform=guess)
        m = out.trans_mat @ np.asarray(t_true, np.float64)
        # recovered transform within mm/mgon of truth despite the 15 cm
        # raw displacement
        disp = np.linalg.norm(m[:3, 3])
        assert disp < 5e-3
        assert abs(np.trace(m[:3, :3]) - 3.0) < 1e-5
