"""C ABI drop-in tests: the same ctypes calling convention as the
reference's python/main.py against our libpwicp_capi.so."""

import ctypes
import os

import numpy as np
import pytest

from piecewise_icp import native
from piecewise_icp.config import PiecewiseICPConfig
from piecewise_icp.io import formats, write_pcd

from util import make_pair, small_test_config


@pytest.fixture(scope="module")
def dll():
    try:
        path = native.build_capi()
    except native.NativeBuildError as e:
        pytest.skip(f"capi build unavailable: {e}")
    lib = ctypes.cdll.LoadLibrary(path)
    # the reference's exact signature declarations (python/main.py:15-18)
    lib.PiecewiseICP_pair_call.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.PiecewiseICP_pair_call.restype = ctypes.c_bool
    lib.PiecewiseICP_4D_call.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float]
    lib.PiecewiseICP_4D_call.restype = ctypes.c_bool
    return lib


class TestCAPI:
    def test_missing_config_returns_false(self, dll):
        assert dll.PiecewiseICP_pair_call(b"/no/such/config.txt",
                                          b"/tmp/") is False

    def test_pair_call_end_to_end(self, dll, tmp_path, rng):
        params = np.array([0.001, -0.001, 0.001, 0.003, -0.002, 0.004])
        c1, c2, t_true = make_pair(rng, params, n_side=60)
        p1 = tmp_path / "target.pcd"
        p2 = tmp_path / "source.pcd"
        write_pcd(p1, c1)
        write_pcd(p2, c2)
        cfg = small_test_config(path1=str(p1), path2=str(p2))
        conf = tmp_path / "conf.txt"
        cfg.to_reference_file(conf)
        out = str(tmp_path) + os.sep
        ok = dll.PiecewiseICP_pair_call(str(conf).encode(), out.encode())
        assert ok is True
        rep = formats.read_trans_matrix_report(tmp_path / "TransMatrix.txt")
        # recovered transform approximately inverts the applied one
        m = rep["trans_mat"] @ t_true
        disp = np.abs(m[:3, 3]) + np.abs(m[:3, :3] - np.eye(3)).sum(1)
        assert disp.max() < 0.02
        assert (tmp_path / "RegisteredSourceCloud.pcd").exists()
