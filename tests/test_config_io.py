"""Tests for config parsing, PCD I/O, folder scanning and result formats."""

import os

import numpy as np
import pytest

from piecewise_icp.config import ConfigError, PiecewiseICPConfig
from piecewise_icp.io import (extract_time_from_filename, formats,
                                  read_pcd, scan_epoch_folder, write_pcd)

# The reference's two shipped 11-line configurations
# (configuration_files/configuration_4d.txt and configuration_pair.txt).
REF_CONF_4D = """string FolderFilePath1: data/data_synthetic/syntheticPC_with_transformations
string FolderFilePath2: results/4DPCReg/
bool isSetResSVsize (yes-1, no-0): 1
float PCres1 (m): 0.005
float PCres2 (m): 0.005
float SVsize1 (m): 0.05
float SVsize2 (m): 0.05
bool isSetDTinit (yes-1, no-0): 1
float DTinit (m): 0.05
float DTmin (m): 0.004
bool isVisual (yes-1, no-0): 0
"""
REF_CONF_PAIR = """string FolderFilePath1: data/data_rockfall/SINGLESCANS - 210729_120011.pcd
string FolderFilePath2: data/data_rockfall/SINGLESCANS - 210830_180032.pcd
bool isSetResSVsize (yes-1, no-0): 1
float PCres1 (m): 0.3
float PCres2 (m): 0.3
float SVsize1 (m): 3
float SVsize2 (m): 3
bool isSetDTinit (yes-1, no-0): 1
float DTinit (m): 0.1
float DTmin (m): 0.03
bool isVisual (yes-1, no-0): 1
"""


class TestConfig:
    def test_parse_reference_4d_config(self, tmp_path):
        p = tmp_path / "configuration_4d.txt"
        p.write_text(REF_CONF_4D)
        cfg = PiecewiseICPConfig.from_reference_file(p)
        assert cfg.path1.endswith("syntheticPC_with_transformations")
        assert cfg.path2 == "results/4DPCReg/"
        assert cfg.set_res_svsize is True
        assert cfg.res1 == pytest.approx(0.005)
        assert cfg.svsize1 == pytest.approx(0.05)
        assert cfg.set_dtinit is True
        assert cfg.dt_init == pytest.approx(0.05)
        assert cfg.dt_min == pytest.approx(0.004)
        assert cfg.visual is False

    def test_parse_reference_pair_config(self, tmp_path):
        p = tmp_path / "configuration_pair.txt"
        p.write_text(REF_CONF_PAIR)
        cfg = PiecewiseICPConfig.from_reference_file(p)
        assert cfg.res1 == pytest.approx(0.3)
        assert cfg.svsize1 == pytest.approx(3.0)
        assert cfg.dt_min == pytest.approx(0.03)
        assert cfg.visual is True

    def test_roundtrip(self, tmp_path):
        cfg = PiecewiseICPConfig(path1="a.pcd", path2="b.pcd", res1=0.1,
                                 res2=0.1, svsize1=1.0, svsize2=1.0,
                                 dt_init=0.2, dt_min=0.05)
        p = tmp_path / "conf.txt"
        cfg.to_reference_file(p)
        cfg2 = PiecewiseICPConfig.from_reference_file(p)
        assert cfg2.res1 == pytest.approx(0.1)
        assert cfg2.svsize1 == pytest.approx(1.0)
        assert cfg2.path1 == "a.pcd"

    def test_validation_matches_reference_ranges(self):
        # SVsize in [res, 40*res] (CommonFunc.cpp:76-90)
        with pytest.raises(ConfigError):
            PiecewiseICPConfig(res1=0.01, svsize1=0.5, res2=0.01,
                               svsize2=0.1).validate()
        # DTinit >= DTmin (CommonFunc.cpp:120-123)
        with pytest.raises(ConfigError):
            PiecewiseICPConfig(dt_init=0.01, dt_min=0.02).validate()

    def test_unknown_override_rejected(self, tmp_path):
        cfg = PiecewiseICPConfig()
        p = tmp_path / "c.txt"
        cfg.to_reference_file(p)
        with pytest.raises(ConfigError):
            PiecewiseICPConfig.from_reference_file(p, not_a_field=1)


class TestPCD:
    def test_read_reference_synthetic(self, synthetic_dir):
        path = os.path.join(synthetic_dir, "Epoch_001.pcd")
        pts = read_pcd(path)
        assert pts.shape == (174474, 3)
        assert pts.dtype == np.float32
        assert np.isfinite(pts).all()

    def test_roundtrip_binary(self, tmp_path, rng):
        pts = rng.normal(size=(1000, 3)).astype(np.float32)
        p = tmp_path / "x.pcd"
        write_pcd(p, pts, binary=True)
        back = read_pcd(p)
        np.testing.assert_array_equal(back, pts)

    def test_roundtrip_ascii(self, tmp_path, rng):
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        p = tmp_path / "x.pcd"
        write_pcd(p, pts, binary=False)
        back = read_pcd(p)
        np.testing.assert_allclose(back, pts, rtol=1e-6)

    def test_roundtrip_binary_compressed(self, tmp_path, rng):
        # quantised coordinates so the LZF matcher finds real repeats
        pts = (rng.normal(size=(5000, 3)) * 100).round().astype(np.float32)
        p = tmp_path / "x.pcd"
        write_pcd(p, pts, compressed=True)
        assert b"binary_compressed" in p.read_bytes()[:300]
        back = read_pcd(p)
        np.testing.assert_array_equal(back, pts)

    def test_lzf_codec_roundtrip(self, rng):
        from piecewise_icp.io.pcd import _lzf_compress, _lzf_decompress

        for payload in (b"", b"a", b"abc" * 1000,
                        rng.integers(0, 4, 10000).astype(np.uint8).tobytes(),
                        rng.integers(0, 256, 5000).astype(np.uint8).tobytes()):
            comp = _lzf_compress(payload)
            assert _lzf_decompress(comp, len(payload)) == payload

    def test_lzf_native_and_python_agree(self, rng):
        pytest.importorskip("piecewise_icp.native")
        from piecewise_icp import native
        from piecewise_icp.io import pcd as pcd_mod

        if not native.available():
            pytest.skip("native lib unavailable")
        payload = (rng.integers(0, 8, 20000).astype(np.uint8).tobytes())
        comp_native = native.lzf_compress(payload)
        assert len(comp_native) < len(payload)  # compressible input
        # the pure-python decoder must read the native stream
        import unittest.mock as mock

        with mock.patch.object(native, "lzf_decompress",
                               side_effect=RuntimeError):
            assert pcd_mod._lzf_decompress(
                comp_native, len(payload)) == payload


class TestFolders:
    def test_timestamp_extraction(self):
        assert extract_time_from_filename("Epoch_017.pcd") == 17
        assert extract_time_from_filename("/a/b/Epoch_003.pcd") == 3

    def test_scan_reference_folder(self, synthetic_dir):
        files, times = scan_epoch_folder(synthetic_dir)
        assert len(files) == 20
        assert times == list(range(1, 21))
        assert files == sorted(files)


class TestFormats:
    def test_read_golden_trans_matrices(self):
        path = "/root/reference/python/results/4DPCReg/TransMatrices.txt"
        if not os.path.exists(path):
            pytest.skip("goldens unavailable")
        ts, tms, vcms = formats.read_trans_matrices(path, 19)
        assert ts == list(range(2, 21))
        assert tms[0].shape == (4, 4)
        np.testing.assert_allclose(tms[0][3], [0, 0, 0, 1])
        assert vcms[0].shape == (6, 6)
        # VCMs are symmetric positive-ish
        np.testing.assert_allclose(vcms[0], vcms[0].T, atol=1e-15)

    def test_trans_matrices_roundtrip(self, tmp_path, rng):
        tms = [np.eye(4) + rng.normal(scale=1e-3, size=(4, 4))
               for _ in range(3)]
        vcms = [np.eye(6) * 1e-9 for _ in range(3)]
        p = tmp_path / "tm.txt"
        formats.write_trans_matrices(p, [2, 3, 4], tms, vcms)
        ts, tms2, vcms2 = formats.read_trans_matrices(p, 3)
        assert ts == [2, 3, 4]
        for a, b in zip(tms, tms2):
            np.testing.assert_allclose(a, b, atol=1e-12)

    def test_pair_report_roundtrip(self, tmp_path):
        tm = np.eye(4)
        tm[0, 3] = -0.0054321
        vcm = np.eye(6) * 1e-9
        ang = np.array([1e-5, 2e-5, -1e-5])
        p = tmp_path / "TransMatrix.txt"
        formats.write_trans_matrix_report(p, tm, ang, tm[:3, 3], vcm)
        rep = formats.read_trans_matrix_report(p)
        np.testing.assert_allclose(rep["trans_mat"], tm, atol=1e-12)
        np.testing.assert_allclose(rep["vcm"], vcm, atol=1e-12)

    def test_golden_pair_report_parses(self):
        path = "/root/reference/python/results/PairReg/TransMatrix.txt"
        if not os.path.exists(path):
            pytest.skip("goldens unavailable")
        rep = formats.read_trans_matrix_report(path)
        assert rep["trans_mat"].shape == (4, 4)
        assert rep["stds"]["Std_Rx"] == pytest.approx(0.2730195721)

    def test_ground_truth_reader(self):
        path = ("/root/reference/python/data/data_synthetic/"
                "defined_transformations.txt")
        if not os.path.exists(path):
            pytest.skip("goldens unavailable")
        ts, tms = formats.read_ground_truth_transforms(path)
        assert len(ts) == 20
        np.testing.assert_allclose(tms[0], np.eye(4))

    def test_reg_pairs_roundtrip(self, tmp_path):
        pairs = {1: 0, 2: 0, 3: 2}
        p = tmp_path / "RegPairFile.txt"
        formats.write_reg_pairs(p, pairs)
        assert formats.read_reg_pairs(p) == pairs
