"""Nearest-neighbour kernels — the keystone ops of the framework.

Every hot loop of Piecewise-ICP consumes nearest-neighbour queries: C2C
percentile distances (CommonFunc.cpp:266-281), overlap ratios
(Registration.cpp:593-614), SOR filtering (CommonFunc.cpp:442-452),
resolution estimation (:239-263), centroid/boundary correspondences
(Registration.cpp:737-747), the inner point-to-plane ICP (:1255-1269) and
the VCM correspondences (:1293-1297).  The reference uses FLANN KD-trees —
a pointer-chasing CPU idiom.  Here the queries are dense, tiled, masked
scans with static shapes that XLA compiles for the device.

Numerical note: distances are computed coordinate-difference-first
(sum_c (q_c - t_c)^2), NOT via the |q|^2 - 2 q.t + |t|^2 matmul identity.
With centroid-reduced clouds spanning tens of metres and millimetre-level
distances, the matmul identity loses ~1e-4 absolute in f32 — fatal for the
mm-accurate distance thresholds.  The difference form keeps error at the
micrometre level.  These brute kernels are the exact references; the
full-cloud fast paths are the grid-hash queries of ops/grid_nn.py.

All functions accept padded arrays plus validity masks; padded targets are
excluded via +inf distance, padded queries return index 0 / +inf.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..backend import brute_tiles

BIG = jnp.inf



def _pad_rows(x: jnp.ndarray, multiple: int, value: float = 0.0) -> jnp.ndarray:
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad_width = [(0, rem)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=value)


def _tiles(n_q: int, n_t: int, q_tile: int | None,
           t_tile: int | None) -> Tuple[int, int]:
    """Tile sizes: the platform's defaults, shrunk to the (power-of-two
    rounded) problem so small calls do not pad to a full tile."""
    dq, dt = brute_tiles()
    return (min(q_tile or dq, _pow2(n_q)), min(t_tile or dt, _pow2(n_t)))


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 1).bit_length()


def _tile_sqdist(q: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Exact squared distances ``[Qt, Tt]`` between two point tiles."""
    d2 = jnp.zeros((q.shape[0], t.shape[0]), dtype=q.dtype)
    for c in range(3):
        diff = q[:, c][:, None] - t[None, :, c]
        d2 = d2 + diff * diff
    return d2


@functools.partial(jax.jit, static_argnames=("q_tile", "t_tile"))
def nn1(queries: jnp.ndarray, targets: jnp.ndarray,
        q_mask: jnp.ndarray | None = None,
        t_mask: jnp.ndarray | None = None,
        q_tile: int | None = None, t_tile: int | None = None
        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """1-nearest-neighbour of each query in ``targets``.

    Returns ``(idx [Q] int32, dist [Q] f32)`` — Euclidean (not squared)
    distances, matching ``sqrt(corr.distance)`` usage in the reference.
    Padded/invalid queries get dist=+inf.
    """
    Q = queries.shape[0]
    q_tile, t_tile = _tiles(Q, targets.shape[0], q_tile, t_tile)
    if q_mask is None:
        q_mask = jnp.ones((Q,), dtype=bool)
    if t_mask is None:
        t_mask = jnp.ones((targets.shape[0],), dtype=bool)

    qp = _pad_rows(queries, q_tile)
    qm = _pad_rows(q_mask, q_tile)
    tp = _pad_rows(targets, t_tile)
    tm = _pad_rows(t_mask, t_tile)
    n_t_tiles = tp.shape[0] // t_tile

    tp_tiles = tp.reshape(n_t_tiles, t_tile, 3)
    tm_tiles = tm.reshape(n_t_tiles, t_tile)

    def per_q_tile(args):
        q, valid_q = args

        def scan_body(carry, tile):
            best_d2, best_idx = carry
            t, valid_t, base = tile
            d2 = _tile_sqdist(q, t)
            d2 = jnp.where(valid_t[None, :], d2, BIG)
            tile_min = jnp.min(d2, axis=1)
            tile_arg = jnp.argmin(d2, axis=1).astype(jnp.int32) + base
            upd = tile_min < best_d2
            return ((jnp.where(upd, tile_min, best_d2),
                     jnp.where(upd, tile_arg, best_idx)), None)

        bases = (jnp.arange(n_t_tiles, dtype=jnp.int32) * t_tile)
        init = (jnp.full((q.shape[0],), BIG, dtype=queries.dtype),
                jnp.zeros((q.shape[0],), dtype=jnp.int32))
        (d2, idx), _ = jax.lax.scan(scan_body, init,
                                    (tp_tiles, tm_tiles, bases))
        d = jnp.sqrt(jnp.maximum(d2, 0.0))
        d = jnp.where(valid_q, d, BIG)
        return idx, d

    n_q_tiles = qp.shape[0] // q_tile
    q_tiles = qp.reshape(n_q_tiles, q_tile, 3)
    qm_tiles = qm.reshape(n_q_tiles, q_tile)
    idx, dist = jax.lax.map(per_q_tile, (q_tiles, qm_tiles))
    return idx.reshape(-1)[:Q], dist.reshape(-1)[:Q]


@functools.partial(jax.jit, static_argnames=("k", "q_tile", "t_tile"))
def knn(queries: jnp.ndarray, targets: jnp.ndarray, k: int,
        q_mask: jnp.ndarray | None = None,
        t_mask: jnp.ndarray | None = None,
        q_tile: int | None = None, t_tile: int | None = None
        ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """k-nearest-neighbours via streaming top-k over target tiles.

    Returns ``(idx [Q, k] int32, dist [Q, k] f32)`` sorted ascending by
    distance.  When the query cloud *is* the target cloud the query point
    itself appears at distance 0, matching the reference's KD-tree usage
    (Segmentation.cpp:38 includes self among the 45 neighbours).
    """
    Q = queries.shape[0]
    q_tile, t_tile = _tiles(Q, targets.shape[0], q_tile, t_tile)
    t_tile = max(t_tile, _pow2(k))           # top_k needs k lanes a tile
    if q_mask is None:
        q_mask = jnp.ones((Q,), dtype=bool)
    if t_mask is None:
        t_mask = jnp.ones((targets.shape[0],), dtype=bool)

    qp = _pad_rows(queries, q_tile)
    qm = _pad_rows(q_mask, q_tile)
    tp = _pad_rows(targets, t_tile)
    tm = _pad_rows(t_mask, t_tile)
    n_t_tiles = tp.shape[0] // t_tile
    tp_tiles = tp.reshape(n_t_tiles, t_tile, 3)
    tm_tiles = tm.reshape(n_t_tiles, t_tile)

    def per_q_tile(args):
        q, valid_q = args

        def scan_body(carry, tile):
            best_d2, best_idx = carry          # [Qt, k] each
            t, valid_t, base = tile
            d2 = _tile_sqdist(q, t)
            d2 = jnp.where(valid_t[None, :], d2, BIG)
            tile_d2, tile_arg = jax.lax.top_k(-d2, k)
            tile_d2 = -tile_d2
            tile_idx = tile_arg.astype(jnp.int32) + base
            # merge running top-k with tile top-k
            cat_d2 = jnp.concatenate([best_d2, tile_d2], axis=1)
            cat_idx = jnp.concatenate([best_idx, tile_idx], axis=1)
            new_d2, sel = jax.lax.top_k(-cat_d2, k)
            new_idx = jnp.take_along_axis(cat_idx, sel, axis=1)
            return (-new_d2, new_idx), None

        bases = (jnp.arange(n_t_tiles, dtype=jnp.int32) * t_tile)
        init = (jnp.full((q.shape[0], k), BIG, dtype=queries.dtype),
                jnp.zeros((q.shape[0], k), dtype=jnp.int32))
        (d2, idx), _ = jax.lax.scan(scan_body, init,
                                    (tp_tiles, tm_tiles, bases))
        d = jnp.sqrt(jnp.maximum(d2, 0.0))
        d = jnp.where(valid_q[:, None], d, BIG)
        return idx, d

    n_q_tiles = qp.shape[0] // q_tile
    q_tiles = qp.reshape(n_q_tiles, q_tile, 3)
    qm_tiles = qm.reshape(n_q_tiles, q_tile)
    idx, dist = jax.lax.map(per_q_tile, (q_tiles, qm_tiles))
    return (idx.reshape(-1, k)[:Q], dist.reshape(-1, k)[:Q])
