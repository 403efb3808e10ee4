"""Which implementation each stage runs, decided in one place.

Every choice here is made from what the process can observe: the platform
JAX runs on (``jax.default_backend()``), whether the native host library
could be built, and the input size.  No other module asks for the
platform.  The numbers behind each choice are in PERF.md.
"""

from __future__ import annotations

import jax

# Below this many points the whole-cloud brute kernels are cheaper than
# building a grid, on every platform.
SMALL_CLOUD = 4096


def platform() -> str:
    """``"gpu"`` or ``"cpu"`` (the platform JAX dispatches to)."""
    return jax.default_backend()


def _native_available() -> bool:
    from . import native

    return native.available()


def sor_on_device(n_points: int) -> bool:
    """Run the SOR statistic on the device (XLA grid k-NN) rather than
    the host C++ twin (``native.sor_mean_dist``).  The host twin wins on
    both platforms (H100 with 16 host cores: 29 ms vs 50 ms at 149k
    points, and 0.6 s less over a 6-epoch range-dependent series), so the
    device runs it only where the native library cannot be built."""
    return n_points > SMALL_CLOUD and not _native_available()


def segmentation_on_device(n_points: int, impl: str = "auto") -> bool:
    """Run k-NN graph, normals and label propagation on the device rather
    than the host C++ twin.  ``impl`` ("auto" | "native" | "jax") pins
    one side; "auto" takes the host twin wherever it builds: on the H100
    it matches the device at uniform density (96 vs 110 ms at 149k
    points) and is 7 s faster over the 6-epoch rockfall series, whose
    range-dependent density sends many k-NN queries to the brute
    fallback."""
    if impl == "jax":
        return True
    if impl == "native":
        return False
    return n_points > SMALL_CLOUD and not _native_available()


def grid_query_tile() -> int:
    """Queries per step of the grid k-NN / 1-NN ``lax.map`` loop."""
    return 16384 if platform() == "gpu" else 2048


def brute_tiles() -> tuple[int, int]:
    """(query tile, target tile) of the brute-force reference kernels."""
    return (8192, 8192) if platform() == "gpu" else (512, 8192)
