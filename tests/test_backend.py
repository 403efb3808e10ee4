"""The platform-choice module, the compile-cache placement and the chip
smoke script's refusal to run without a GPU."""

import os
import pathlib
import subprocess
import sys
import tempfile

import pytest

from piecewise_icp import backend
from piecewise_icp.utils import cache

REPO = pathlib.Path(__file__).resolve().parents[1]


class TestBackendChoice:
    def test_platform_is_cpu_here(self):
        assert backend.platform() == "cpu"

    @pytest.mark.parametrize("platform", ["cpu", "gpu"])
    @pytest.mark.parametrize("native_ok,n,expect", [
        (True, 200_000, False),
        (False, 200_000, True),
        (False, 1000, False),
    ])
    def test_sor_on_device(self, monkeypatch, platform, native_ok, n,
                           expect):
        monkeypatch.setattr(backend, "platform", lambda: platform)
        monkeypatch.setattr(backend, "_native_available", lambda: native_ok)
        assert backend.sor_on_device(n) is expect

    @pytest.mark.parametrize("impl,native_ok,n,expect", [
        ("jax", True, 100, True),
        ("native", False, 200_000, False),
        ("auto", True, 200_000, False),
        ("auto", False, 200_000, True),
        ("auto", False, 100, False),
    ])
    def test_segmentation_on_device(self, monkeypatch, impl, native_ok, n,
                                    expect):
        monkeypatch.setattr(backend, "_native_available", lambda: native_ok)
        assert backend.segmentation_on_device(n, impl) is expect

    @pytest.mark.parametrize("platform", ["cpu", "gpu"])
    def test_tiles_are_powers_of_two(self, monkeypatch, platform):
        monkeypatch.setattr(backend, "platform", lambda: platform)
        for t in (backend.grid_query_tile(),) + backend.brute_tiles():
            assert t > 0 and t & (t - 1) == 0


class TestCompileCache:
    def test_env_variable_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv(cache.CACHE_ENV, str(tmp_path / "c"))
        assert cache.cache_dir() == str(tmp_path / "c")

    def test_default_is_fixed_inside_checkout(self, monkeypatch):
        monkeypatch.delenv(cache.CACHE_ENV, raising=False)
        d = pathlib.Path(cache.cache_dir())
        assert d == REPO / ".jax_cache"
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()

    def test_no_temporary_or_home_cache_default(self, monkeypatch):
        monkeypatch.delenv(cache.CACHE_ENV, raising=False)
        d = os.path.realpath(cache.cache_dir())
        assert not d.startswith(os.path.realpath(tempfile.gettempdir()))
        assert not d.startswith(
            os.path.realpath(os.path.expanduser("~/.cache")))


class TestChipSmoke:
    def test_refuses_cpu(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                             env=env, capture_output=True, text=True,
                             timeout=300, cwd=REPO)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
        assert "no GPU" in out.stderr
