"""ctypes loader for the native host runtime (``pwicp_host.cpp``).

Builds the shared library on first use (g++ -O3) and caches it next to the
source; the binding style intentionally mirrors the reference's Python layer
(python/main.py:9-18 loads a prebuilt DLL via ctypes), but here the source
ships with the package and compiles anywhere.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "pwicp_host.cpp"
_LIB = _HERE / "libpwicp_host.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    pass


def _build() -> None:
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           "-std=c++17", str(_SRC), "-o", str(_LIB)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        msg = getattr(e, "stderr", str(e))
        raise NativeBuildError(f"native build failed: {msg}") from e


def load() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        stale = (not _LIB.exists()
                 or _LIB.stat().st_mtime < _SRC.stat().st_mtime)
        if stale:
            _build()
        lib = ctypes.CDLL(str(_LIB))
        lib.pwicp_knn_graph.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int32)]
        lib.pwicp_knn_graph.restype = ctypes.c_int
        lib.pwicp_grid_sample_count.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_double]
        lib.pwicp_grid_sample_count.restype = ctypes.c_int
        lib.pwicp_supervoxel_propagate.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_int32)]
        lib.pwicp_supervoxel_propagate.restype = ctypes.c_int
        lib.pwicp_supervoxel_propagate_o.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32)]
        lib.pwicp_supervoxel_propagate_o.restype = ctypes.c_int
        lib.pwicp_pca_normals.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        lib.pwicp_pca_normals.restype = ctypes.c_int
        lib.pwicp_sor_mean_dist.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.POINTER(ctypes.c_float)]
        lib.pwicp_sor_mean_dist.restype = ctypes.c_int
        for fn in (lib.pwicp_lzf_decompress, lib.pwicp_lzf_compress):
            fn.argtypes = [ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
                           ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeBuildError:
        return False


def _c_f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _c_i32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def knn_graph(points: np.ndarray, k: int,
              cell_size: float = -1.0) -> np.ndarray:
    """Exact kNN indices ``[N, k]`` (self included, sorted by distance).

    Host equivalent of cl::KDTree::FindKNearestNeighbors as used for the
    45-NN normal/segmentation graph (Segmentation.cpp:37-45).
    """
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    out = np.empty((n, k), dtype=np.int32)
    rc = load().pwicp_knn_graph(_c_f32(pts), n, k, cell_size, _c_i32(out))
    if rc != 0:
        raise RuntimeError(f"pwicp_knn_graph failed: rc={rc}")
    return out


def grid_sample_count(points: np.ndarray, resolution: float) -> int:
    """Number of occupied voxels at ``resolution`` — the supervoxel seed
    count K (grid_sample.h:49-75)."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    return int(load().pwicp_grid_sample_count(_c_f32(pts), pts.shape[0],
                                              resolution))


def sor_mean_dist(points: np.ndarray, k: int,
                  cell_size: float = -1.0) -> np.ndarray:
    """Mean distance of each point to its k nearest non-self neighbours
    (the SOR statistic, CommonFunc.cpp:442-452) — exact, host, OpenMP."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    n = pts.shape[0]
    out = np.empty((n,), dtype=np.float32)
    rc = load().pwicp_sor_mean_dist(_c_f32(pts), n, k, cell_size,
                                    _c_f32(out))
    if rc != 0:
        raise RuntimeError("pwicp_sor_mean_dist failed")
    return out


def supervoxel_propagate(points: np.ndarray, normals: np.ndarray,
                         neighbors: np.ndarray, resolution: float,
                         seed_origin: np.ndarray | None = None
                         ) -> tuple[np.ndarray, int]:
    """Supervoxel segmentation by seeded metric label propagation — the
    framework's from-scratch parallel segmenter (see pwicp_host.cpp
    pwicp_supervoxel_propagate and DESIGN.md §2.1); covers the role of the
    reference's SupervoxelSegmentation (supervoxel_segmentation.h:66-248).
    ``seed_origin`` anchors the seed lattice (cross-epoch patch
    consistency; see segmentation_device.propagate_seeds).
    Returns (labels [N] int32, count)."""
    pts = np.ascontiguousarray(points, dtype=np.float32)
    nrm = np.ascontiguousarray(normals, dtype=np.float32)
    nbr = np.ascontiguousarray(neighbors, dtype=np.int32)
    n, k = nbr.shape
    assert pts.shape == (n, 3) and nrm.shape == (n, 3)
    labels = np.empty((n,), dtype=np.int32)
    if seed_origin is None:
        org = None
    else:
        org_arr = np.ascontiguousarray(seed_origin, dtype=np.float64)
        org = org_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    nsv = load().pwicp_supervoxel_propagate_o(
        _c_f32(pts), _c_f32(nrm), _c_i32(nbr), n, k, resolution, org,
        _c_i32(labels))
    if nsv < 0:
        raise RuntimeError("pwicp_supervoxel_propagate failed")
    return labels, int(nsv)


def pca_normals(points: np.ndarray, neighbors: np.ndarray) -> np.ndarray:
    """Per-point PCA normals from a kNN graph (host, OpenMP).

    Host twin of models/segmentation.estimate_normals: the host
    segmentation path keeps the [N, k] graph on the host throughout.
    """
    pts = np.ascontiguousarray(points, dtype=np.float32)
    nbr = np.ascontiguousarray(neighbors, dtype=np.int32)
    n, k = nbr.shape
    out = np.empty((n, 3), dtype=np.float32)
    rc = load().pwicp_pca_normals(_c_f32(pts), _c_i32(nbr), n, k, _c_f32(out))
    if rc != 0:
        raise RuntimeError("pwicp_pca_normals failed")
    return out


def _c_u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte))


def lzf_decompress(data: bytes, out_len: int) -> bytes:
    """Decompress an LZF stream (the binary_compressed PCD payload,
    pcl::lzfDecompress semantics)."""
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(out_len, dtype=np.uint8)
    n = load().pwicp_lzf_decompress(_c_u8(src), src.size, _c_u8(out), out_len)
    if n != out_len:
        raise ValueError(f"LZF decompress produced {n} of {out_len} bytes")
    return out.tobytes()


def lzf_compress(data: bytes) -> bytes:
    """Compress to an LZF stream (pcl::lzfCompress-compatible output)."""
    src = np.frombuffer(data, dtype=np.uint8)
    cap = src.size + src.size // 16 + 64   # worst case: all literals
    out = np.empty(cap, dtype=np.uint8)
    n = load().pwicp_lzf_compress(_c_u8(src), src.size, _c_u8(out), cap)
    if n < 0:
        raise ValueError("LZF compress failed")
    return out[:n].tobytes()


_CAPI_SRC = _HERE / "pwicp_capi.cpp"
_CAPI_LIB = _HERE / "libpwicp_capi.so"


def build_capi() -> str:
    """Build (if needed) the drop-in C ABI library exposing the reference's
    DLL symbols (PiecewiseICP_pair_call / PiecewiseICP_4D_call).

    Returns the .so path for ``ctypes.cdll.LoadLibrary`` — the same calling
    convention as the reference's python/main.py:12-18.
    """
    stale = (not _CAPI_LIB.exists()
             or _CAPI_LIB.stat().st_mtime < _CAPI_SRC.stat().st_mtime)
    if stale:
        import sysconfig

        inc = sysconfig.get_paths()["include"]
        libdir = sysconfig.get_config_var("LIBDIR")
        ver = sysconfig.get_config_var("LDVERSION")
        cmd = ["g++", "-O2", "-shared", "-fPIC", str(_CAPI_SRC),
               f"-I{inc}", f"-L{libdir}", f"-lpython{ver}",
               "-o", str(_CAPI_LIB)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except (subprocess.CalledProcessError, FileNotFoundError) as e:
            raise NativeBuildError(
                f"capi build failed: {getattr(e, 'stderr', e)}") from e
    return str(_CAPI_LIB)
