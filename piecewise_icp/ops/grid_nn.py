"""Grid-hash 1-NN — the keystone fast path for full-cloud queries.

Brute-force 1-NN over two ~170k clouds costs ~3e10 distance evaluations per
call; the stage-1 percentile C2C runs it every iteration.  This module
replaces it with a uniform-grid candidate search:

* **build (host)**: targets are binned into cells of size ``h`` and sorted
  by linearised cell id (x-major, z fastest).  A CSR ``cell_starts`` array
  gives each cell's point range.  With z fastest, the 27-cell neighbourhood
  of any query is NINE contiguous runs of three z-cells each.
* **query (device, jitted)**: for each query tile, gather the 9 run ranges
  and scan a fixed number of candidate slots per run (the bucketed maximum
  3-cell occupancy), masked by the true run lengths.  Pure VPU work over
  ~100 candidates instead of ~170k.
* **exactness**: a found neighbour at distance <= h is provably the true
  nearest (anything outside the 27-cell window is > h away).  Queries that
  resolve farther than h (stragglers) are recomputed by the exact
  brute-force kernel over a bucket-padded subset, decided on the host from
  the fetched ``resolved`` mask, and merged per query.

Replaces the reference's FLANN KD-trees (Registration.cpp:737-747,
CommonFunc.cpp:266-281) with a data layout XLA vectorises: no pointers, no
recursion, static shapes per (size-bucket, occupancy-bucket).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..backend import grid_query_tile
from .nn import knn as brute_knn
from .nn import nn1 as brute_nn1


def _bucket(n: int, base: int = 8) -> int:
    """Round up to the next power-of-two-ish bucket to bound recompiles."""
    b = base
    while b < n:
        b *= 2
    return b


_MIN_SUBSET = 512            # smallest straggler bucket


def _pad_subset(sub: np.ndarray, total: int) -> np.ndarray:
    """Pad a fallback index subset to a power-of-two bucket (repeating the
    first element) so the brute kernels compile once per bucket."""
    b = _bucket(max(len(sub), 1), base=_MIN_SUBSET)
    b = min(b, total) if total >= _MIN_SUBSET else len(sub)
    if b <= len(sub):
        return sub
    return np.concatenate([sub, np.full(b - len(sub), sub[0],
                                        dtype=sub.dtype)])


@dataclasses.dataclass
class GridIndex:
    """Host-built uniform-grid index over a target cloud."""

    points: np.ndarray        # [Tb, 3] sorted by cell id, bucket-padded
    ids: np.ndarray           # [Tb] original target indices (int32)
    cell_starts: np.ndarray   # [n_cells + 1] CSR offsets (int32)
    origin: np.ndarray        # [3] f32
    dims: Tuple[int, int, int]
    h: float
    max_run: int              # bucketed max occupancy of any 3-z-cell run
    n_real: int = 0           # real (unpadded) target count

    @property
    def n_targets(self) -> int:
        return self.points.shape[0]


MAX_GRID_CELLS = 1 << 26   # dense CSR cap: 64M cells = 256 MB of starts


def build_grid(targets: np.ndarray, h: float,
               mask: np.ndarray | None = None) -> GridIndex:
    """Bin + sort targets into a uniform grid of cell size ``h`` (host).

    The CSR ``cell_starts`` array is DENSE over the bounding box — raises
    ValueError when ``h`` is small relative to the extent (e.g. long-range
    TLS scenes); callers fall back to the brute kernel then.
    """
    pts = np.asarray(targets, dtype=np.float32)
    if mask is not None:
        pts = pts[np.asarray(mask)]
    if pts.shape[0] == 0:
        raise ValueError("cannot build a grid over an empty target cloud")
    origin = pts.min(axis=0)
    cell = np.floor((pts - origin) / h).astype(np.int64)
    dims = cell.max(axis=0) + 1
    dx, dy, dz = (int(dims[0]), int(dims[1]), int(dims[2]))
    if dx * dy * dz > MAX_GRID_CELLS:
        raise ValueError(
            f"dense grid of {dx}x{dy}x{dz} cells exceeds MAX_GRID_CELLS "
            f"(cell size {h} too small for the cloud extent)")
    lin = (cell[:, 0] * dy + cell[:, 1]) * dz + cell[:, 2]
    order = np.argsort(lin, kind="stable").astype(np.int32)
    n_cells = dx * dy * dz
    # CSR via bincount+cumsum: O(N + cells), ~3x cheaper than the
    # searchsorted formulation once cells reach the millions
    counts_all = np.bincount(lin, minlength=n_cells)
    starts = np.zeros(n_cells + 1, dtype=np.int32)
    np.cumsum(counts_all, out=starts[1:])
    # pad the CSR array to a size bucket so the device kernels compile once
    # per bucket instead of once per cloud (padding repeats the total count,
    # so out-of-range cells read empty runs)
    starts_bucket = _bucket(n_cells + 1, base=4096)
    if starts_bucket > starts.shape[0]:
        starts = np.concatenate([
            starts, np.full(starts_bucket - starts.shape[0], pts.shape[0],
                            dtype=np.int32)])
    # max occupancy over any run of three consecutive z-cells
    counts = np.diff(starts)
    if dz >= 3:
        run3 = counts[:-2] + counts[1:-1] + counts[2:]
        # only runs fully inside one (x, y) column matter, but the bound
        # over all windows is safe and simpler
        max_run = int(run3.max()) if run3.size else int(counts.max())
    else:
        max_run = int(counts.max()) * dz
    # bucket the POINT count too: the sorted arrays feed jitted programs
    # whose compile key is their shape — without this every epoch of a
    # campaign has a unique size and recompiles the fused iteration.
    # Padding points sit at +BIG
    # beyond every CSR run, so they never win any query.
    n_real = pts.shape[0]
    n_pad = _bucket(max(n_real, 1), base=4096) - n_real
    pts_sorted = pts[order]
    ids = order
    if n_pad > 0:
        pts_sorted = np.concatenate(
            [pts_sorted, np.full((n_pad, 3), 1e30, dtype=np.float32)])
        ids = np.concatenate([ids, np.zeros(n_pad, dtype=np.int32)])
    return GridIndex(points=pts_sorted, ids=ids,
                     cell_starts=starts, origin=origin.astype(np.float32),
                     dims=(dx, dy, dz), h=float(h),
                     max_run=_bucket(max(max_run, 1)), n_real=n_real)


def _window_runs(q, cell_starts, origin, dims, h):
    """The 27-cell window of each query as nine contiguous CSR runs, one
    per (x, y) column, each spanning z-cells cz-1..cz+1: (run_start,
    run_len), both [Q, 9].  Columns outside the grid are empty runs (a
    clipped column would repeat a real one and duplicate its points)."""
    dx, dy, dz = dims[0], dims[1], dims[2]
    n_cells = jnp.minimum(dx * dy * dz, cell_starts.shape[0] - 1)
    cell = jnp.floor((q - origin) / h).astype(jnp.int32)
    cx = jnp.clip(cell[:, 0], 0, dx - 1)
    cy = jnp.clip(cell[:, 1], 0, dy - 1)
    cz = jnp.clip(cell[:, 2], 0, dz - 1)
    z0 = jnp.clip(cz - 1, 0, dz - 1)
    z1 = jnp.clip(cz + 1, 0, dz - 1)
    starts, lens = [], []
    for ox in (-1, 0, 1):
        x = cx + ox
        for oy in (-1, 0, 1):
            y = cy + oy
            inside = (x >= 0) & (x < dx) & (y >= 0) & (y < dy)
            base = (jnp.clip(x, 0, dx - 1) * dy + jnp.clip(y, 0, dy - 1)) * dz
            s = cell_starts[jnp.clip(base + z0, 0, n_cells)]
            e = cell_starts[jnp.clip(base + z1 + 1, 0, n_cells)]
            starts.append(s)
            lens.append(jnp.where(inside, e - s, 0))
    return jnp.stack(starts, axis=1), jnp.stack(lens, axis=1)


def _map_query_tiles(per_tile, queries, q_mask, q_tile: int | None):
    """``per_tile`` over fixed-size query tiles (``lax.map``, one compiled
    body), outputs flattened back to [Q, ...] with the padding trimmed."""
    qn = queries.shape[0]
    q_tile = min(q_tile or grid_query_tile(), _bucket(qn))
    pad = (-qn) % q_tile
    n_tiles = (qn + pad) // q_tile
    outs = jax.lax.map(per_tile, (
        jnp.pad(queries, ((0, pad), (0, 0))).reshape(n_tiles, q_tile, 3),
        jnp.pad(q_mask, (0, pad)).reshape(n_tiles, q_tile)))
    return tuple(o.reshape((-1,) + o.shape[2:])[:qn] for o in outs)


@functools.partial(jax.jit, static_argnames=("max_run", "q_tile"))
def grid_query_1nn(queries, q_mask, sorted_pts, cell_starts, origin,
                   dims, max_run: int, h, q_tile: int | None = None):
    """Grid 1-NN over the 27-cell window: (idx into sorted targets, dist,
    resolved).

    A resolved query carries its EXACT nearest distance, which is <= h;
    an unresolved one has its true nearest distance > h (nothing outside
    the window is closer than h).  Callers rely on this dichotomy for the
    exactness of order statistics.  ``dims`` is a traced [3] int32 vector
    so differently sized grids reuse the same executable."""
    def per_tile(args):
        q, valid = args
        qt = q.shape[0]
        run_start, run_len = _window_runs(q, cell_starts, origin, dims, h)

        # one block gather over all candidate slots
        offs = jnp.arange(max_run, dtype=jnp.int32)
        slots = run_start[:, :, None] + offs[None, None, :]   # [Qt, 9, M]
        ok = offs[None, None, :] < run_len[:, :, None]
        cand = jnp.clip(slots, 0, sorted_pts.shape[0] - 1)
        flat = cand.reshape(qt, -1)                    # [Qt, 9*M]
        cpts = sorted_pts[flat]                        # [Qt, 9*M, 3]
        diff = cpts - q[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(ok.reshape(qt, -1), d2, jnp.inf)
        j = jnp.argmin(d2, axis=1)
        best_d2 = jnp.take_along_axis(d2, j[:, None], axis=1)[:, 0]
        best_i = jnp.take_along_axis(flat, j[:, None], axis=1)[:, 0]

        d = jnp.sqrt(jnp.maximum(best_d2, 0.0))
        found = jnp.isfinite(d)
        resolved = (~valid) | (found & (d <= h))
        d = jnp.where(valid, d, jnp.inf)
        return best_i, d, resolved

    return _map_query_tiles(per_tile, queries, q_mask, q_tile)


def _stragglers(resolved) -> np.ndarray | None:
    """Host-side straggler subset (bucket-padded) or None when every query
    resolved in its window.  One [Q] bool fetch."""
    bad = np.flatnonzero(~np.asarray(resolved))
    if bad.size == 0:
        return None
    return _pad_subset(bad, resolved.shape[0])


def grid_nn1(queries: jnp.ndarray, grid: GridIndex,
             q_mask: jnp.ndarray | None = None,
             exact: bool = True) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """1-NN of ``queries`` in the gridded target cloud.

    Returns (idx into the ORIGINAL target array, dist).  With ``exact``
    (default), queries unresolved within the 27-cell window are recomputed
    by the brute-force kernel.
    """
    if q_mask is None:
        q_mask = jnp.ones((queries.shape[0],), dtype=bool)
    sorted_pts = jnp.asarray(grid.points)
    ids = jnp.asarray(grid.ids)
    s_idx, dist, resolved = grid_query_1nn(
        queries, q_mask, sorted_pts, jnp.asarray(grid.cell_starts),
        jnp.asarray(grid.origin), jnp.asarray(grid.dims, jnp.int32),
        grid.max_run, jnp.asarray(grid.h, queries.dtype))
    sub = _stragglers(resolved) if exact else None
    if sub is not None:
        sub = jnp.asarray(sub)
        b_idx, b_dist = brute_nn1(queries[sub], sorted_pts)
        s_idx = s_idx.at[sub].set(b_idx)
        dist = dist.at[sub].set(b_dist)
    return ids[s_idx], dist


@functools.partial(jax.jit, static_argnames=("max_run", "k", "q_tile"))
def _grid_query_k(queries, q_mask, sorted_pts, cell_starts, origin,
                  dims, max_run: int, k: int, h, q_tile: int | None = None):
    """k-NN over the 27-cell window.  Returns (idx [Q,k] into sorted
    targets, dist [Q,k], resolved [Q]) — resolved iff the k-th distance is
    <= h, in which case all k are the exact nearest."""
    def per_tile(args):
        q, valid = args
        qt = q.shape[0]
        run_start, run_len = _window_runs(q, cell_starts, origin, dims, h)
        offs = jnp.arange(max_run, dtype=jnp.int32)
        slots = run_start[:, :, None] + offs[None, None, :]
        ok = offs[None, None, :] < run_len[:, :, None]
        cand = jnp.clip(slots, 0, sorted_pts.shape[0] - 1).reshape(qt, -1)
        cpts = sorted_pts[cand]
        diff = cpts - q[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where(ok.reshape(qt, -1), d2, jnp.inf)
        top_d2, sel = jax.lax.top_k(-d2, k)
        top_d2 = -top_d2
        top_idx = jnp.take_along_axis(cand, sel, axis=1)
        d = jnp.sqrt(jnp.maximum(top_d2, 0.0))
        resolved = (~valid) | (jnp.isfinite(d[:, -1]) & (d[:, -1] <= h))
        d = jnp.where(valid[:, None], d, jnp.inf)
        return top_idx, d, resolved

    return _map_query_tiles(per_tile, queries, q_mask, q_tile)


def grid_knn_sorted(queries: jnp.ndarray, q_mask: jnp.ndarray,
                    grid: GridIndex, k: int,
                    exact: bool = True) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact k-NN (ascending) as (idx [Q, k] into the SORTED targets
    ``grid.points``, dist [Q, k]).

    Stragglers — queries whose k-th neighbour lies beyond the 27-cell
    window — go to the brute streaming top-k.  When they fill more than
    one minimal brute bucket, they are first queried again on a grid of
    twice the cell size over the same targets, and only what escapes that
    window too goes to the brute kernel: where the cell size is tight for
    the point spacing the straggler share is large (13% of a 45-NN
    self-join at the synthetic scale) and the brute pass would dominate,
    while a handful of outliers costs less than the coarse grid's build."""
    sorted_pts = jnp.asarray(grid.points)
    s_idx, dist, resolved = _grid_query_k(
        queries, q_mask, sorted_pts, jnp.asarray(grid.cell_starts),
        jnp.asarray(grid.origin), jnp.asarray(grid.dims, jnp.int32),
        grid.max_run, k, jnp.asarray(grid.h, queries.dtype))
    sub = _stragglers(resolved) if exact else None
    if sub is None:
        return s_idx, dist
    coarse = None
    if len(sub) > _MIN_SUBSET:
        try:
            coarse = build_grid(grid.points[:grid.n_real], 2.0 * grid.h)
        except ValueError:
            pass                 # no dense grid at 2h: brute for them all
    sub = jnp.asarray(sub)
    qs = queries[sub]
    if coarse is not None:
        c_idx, c_dist, c_res = _grid_query_k(
            qs, jnp.ones((qs.shape[0],), bool), jnp.asarray(coarse.points),
            jnp.asarray(coarse.cell_starts), jnp.asarray(coarse.origin),
            jnp.asarray(coarse.dims, jnp.int32), coarse.max_run, k,
            jnp.asarray(coarse.h, queries.dtype))
        # coarse ids index the fine grid's sorted points
        s_idx = s_idx.at[sub].set(jnp.asarray(coarse.ids)[c_idx])
        dist = dist.at[sub].set(c_dist)
        sub2 = _stragglers(c_res)
        if sub2 is None:
            return s_idx, dist
        sub = sub[jnp.asarray(sub2)]
        qs = queries[sub]
    b_idx, b_dist = brute_knn(qs, sorted_pts, k)
    return s_idx.at[sub].set(b_idx), dist.at[sub].set(b_dist)


def grid_knn(queries: jnp.ndarray, grid: GridIndex, k: int,
             q_mask: jnp.ndarray | None = None,
             exact: bool = True) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k-NN of ``queries`` in the gridded targets (ascending): (idx into
    the ORIGINAL target array, dist)."""
    if q_mask is None:
        q_mask = jnp.ones((queries.shape[0],), dtype=bool)
    s_idx, dist = grid_knn_sorted(queries, q_mask, grid, k, exact=exact)
    return jnp.asarray(grid.ids)[s_idx], dist


def grid_self_knn(grid: GridIndex, k: int) -> Tuple[jnp.ndarray,
                                                    jnp.ndarray]:
    """Exact k-NN self-join of the gridded cloud, in its cell-sorted,
    bucket-padded order: (nbr [Tb, k] int32 into ``grid.points``, -1 where
    no real neighbour exists; dist [Tb, k]).  Rows past ``grid.n_real`` are
    padding.  Self is the first neighbour.  Sorted order keeps each query's
    candidates contiguous, and the bucketed shape lets every cloud of a
    size bucket share one executable."""
    pts = jnp.asarray(grid.points)
    q_mask = jnp.arange(pts.shape[0]) < grid.n_real
    idx, dist = grid_knn_sorted(pts, q_mask, grid, k)
    nbr = jnp.where((idx < grid.n_real) & jnp.isfinite(dist), idx, -1)
    return nbr, dist


def grid_percentile(source: jnp.ndarray, grid: GridIndex, percentile: float,
                    s_mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """p-th percentile of source→target NN distances via the grid.

    Exactness by order statistics: every query resolved in the 27-cell
    window has an exact distance <= h, and every unresolved query's true
    distance is > h, so sorting resolved-then-inf keeps the true order as
    long as the percentile index lands inside the resolved block.  Only
    when it does not (heavy misalignment) does the brute kernel run.

    Index semantics match calArrayPercentileElement (CommonFunc.cpp:174-179).

    The grid-vs-brute decision is made ON HOST from one scalar fetch — a
    ``lax.cond`` would compile the heavy brute kernel into every caller
    even when it never runs.
    """
    if s_mask is None:
        s_mask = jnp.ones((source.shape[0],), dtype=bool)
    sorted_pts = jnp.asarray(grid.points)
    starts = jnp.asarray(grid.cell_starts)
    origin = jnp.asarray(grid.origin)

    d_grid, use_grid = _grid_percentile_pass(
        source, s_mask, sorted_pts, starts, origin,
        jnp.asarray(grid.dims, jnp.int32), grid.max_run,
        jnp.asarray(grid.h, source.dtype), percentile)
    if bool(use_grid):
        return d_grid
    return _brute_percentile_pass(source, s_mask, sorted_pts, percentile)


@functools.partial(jax.jit, static_argnames=("max_run", "percentile"))
def _grid_percentile_pass(source, s_mask, sorted_pts, starts, origin,
                          dims, max_run: int, h, percentile: float):
    _, dist, resolved = grid_query_1nn(
        source, s_mask, sorted_pts, starts, origin, dims, max_run, h)
    n = jnp.sum(s_mask)
    idx = jnp.clip((n * percentile).astype(jnp.int32), 0,
                   source.shape[0] - 1)
    ok = resolved | (~s_mask)
    n_resolved = jnp.sum(ok & s_mask)
    d = jnp.where(ok, dist, jnp.inf)
    return jnp.sort(d)[idx], idx < n_resolved


@functools.partial(jax.jit, static_argnames=("percentile",))
def _brute_percentile_pass(source, s_mask, sorted_pts, percentile: float):
    n = jnp.sum(s_mask)
    idx = jnp.clip((n * percentile).astype(jnp.int32), 0,
                   source.shape[0] - 1)
    _, d = brute_nn1(source, sorted_pts, q_mask=s_mask)
    return jnp.sort(jnp.where(jnp.isfinite(d), d, jnp.inf))[idx]
