"""Multi-chip sharded Piecewise-ICP (shard_map + collectives).

The reference is strictly single-threaded (SURVEY.md §2.4); every
parallelism axis here is new design:

* **Point sharding ("sp" axis)** — the full clouds are sharded across chips
  along the point dimension.  The hot stage-1 percentile NN (every source
  point against the full target cloud) computes its query shard locally,
  then ``all_gather``s the per-shard distances for the global percentile.
* **Schur-style normal-equation reduction** — the inner point-to-plane ICP
  shards the source-centroid rows across chips; each chip accumulates its
  local 6x6 A^T A / A^T L block and a single ``psum`` over ICI reduces them
  before the (replicated, deterministic) 6x6 solve.  This is the
  BASELINE.json north-star collective pattern.
* Patch-level arrays (centroids, boundary points, stds — O(10^3)) are
  replicated: they are 1000x smaller than the clouds and every chip needs
  them for classification.

There is exactly ONE iteration implementation:
``models.piecewise_icp._iteration_step`` — this module wraps that same
body in ``shard_map`` with ``axis_name`` set, so the mesh path can never
drift from the single-device semantics (cubic power-of-two convergence
box, rotated source normals, symmetric-ICP variant, packed scalar stats).
``models.piecewise_icp.piecewise_icp(mesh=...)`` drives the FULL staged
DT loop through it; :func:`register_pair` and :func:`run_4d` thread the
mesh down from the public API.

The same program runs on an N-GPU mesh or on N virtual CPU devices
(``--xla_force_host_platform_device_count``), which is how the test suite
and the driver's multi-chip dry-run validate it.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

try:  # JAX >= 0.6 exposes shard_map at top level
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map  # type: ignore


def make_mesh(n_devices: Optional[int] = None, axis: str = "sp") -> Mesh:
    """A 1-D device mesh over the point-sharding axis."""
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def _put(x, sharding: NamedSharding):
    """Place host data under ``sharding`` — also when the mesh spans
    multiple controllers (every process passes the identical full array;
    each materialises only its addressable shards)."""
    x = np.asarray(x)
    if all(d.process_index == jax.process_index()
           for d in sharding.mesh.devices.flat):
        return jax.device_put(x, sharding)
    return jax.make_array_from_callback(x.shape, sharding,
                                        lambda idx: x[idx])


def replicated(mesh: Mesh, x):
    """Place an array replicated across the mesh."""
    return _put(x, NamedSharding(mesh, P()))


def point_sharded(mesh: Mesh, x, axis: str = "sp"):
    """Place an array sharded along its leading (point) dimension."""
    return _put(x, NamedSharding(mesh, P(axis)))


@functools.lru_cache(maxsize=32)
def build_sharded_iteration(mesh: Mesh, axis: str = "sp",
                            icp_max_iterations: int = 100,
                            grid_max_run: int = 32,
                            icp_trans_eps: float = 1e-8,
                            icp_fitness_eps: float = 1e-6,
                            icp_variant: str = "reference",
                            icp_weighting: str = "uniform"):
    """Compile the fully sharded Piecewise-ICP iteration for ``mesh``.

    Returns a jitted function with the EXACT positional signature of
    ``models.piecewise_icp._iteration_step`` (statics bound):

        step(ct1, n1, std_ct1, ct1_mask, ct2, n2, bp2, std_bp2, ct2_mask,
             cloud2, cloud2_mask, labels2,             # sharded along axis
             g_pts, g_starts, g_origin, g_dims, g_h,   # cloud1 grid (repl.)
             curr_dt, dt_min, max_lod, sv_sum, bb_leaf,
             percentile, need_percentile)
        -> (stats, stable, pt_stable*, cloud2*, ct2, bp2, n2)  (* = sharded)

    Cached per (mesh, statics) so a 4D campaign reuses one executable.
    """
    from ..models.piecewise_icp import _iteration_step

    body = functools.partial(
        _iteration_step,
        icp_max_iterations=icp_max_iterations, grid_max_run=grid_max_run,
        icp_trans_eps=icp_trans_eps, icp_fitness_eps=icp_fitness_eps,
        icp_variant=icp_variant, icp_weighting=icp_weighting,
        axis_name=axis)

    sharded, repl = P(axis), P()
    step = shard_map(
        body, mesh=mesh,
        in_specs=(repl, repl, repl, repl,        # ct1, n1, std_ct1, mask
                  repl, repl, repl, repl, repl,  # ct2, n2, bp2, std_bp2, mask
                  sharded, sharded, sharded,     # cloud2, mask, labels
                  repl, repl, repl, repl, repl,  # cloud1 grid
                  repl, repl, repl, repl, repl,  # scalars
                  repl, repl),
        out_specs=(repl, repl, sharded, sharded, repl, repl, repl),
        check_vma=False)
    return jax.jit(step)
