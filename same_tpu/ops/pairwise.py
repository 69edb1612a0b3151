"""Tiled brute-force radius-kNN on the device.

Candidate generation in the reference is a per-point Python loop over a C++
cKDTree (reference src/utils.py:709-742). The device formulation is a tiled
brute-force sweep: exact squared distances per row-tile, then ``lax.top_k``
per tile. Window problems are <= ~50k points per side, so O(n*m) tiles are
cheap and avoid host round-trips.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("k", "tile"))
def radius_knn_tpu(
    query_xy: jax.Array,
    ref_xy: jax.Array,
    radius: float,
    k: int,
    tile: int = 1024,
):
    """For each query point, the k nearest refs within ``radius``.

    Returns ``(idx, dist, mask)`` with shapes [n, k], padded with -1 / +inf /
    False. Distances are Euclidean. Neighbors are sorted by distance
    (ascending); ties broken towards smaller ref index via a monotone
    composite sort key.
    """
    n = query_xy.shape[0]
    m = ref_xy.shape[0]
    r2 = jnp.asarray(radius, query_xy.dtype) ** 2

    n_pad = (-n) % tile
    q = jnp.pad(query_xy, ((0, n_pad), (0, 0)))
    q_tiles = q.reshape(-1, tile, 2)

    def one_tile(qt):
        # [tile, m] squared distances from coordinate differences. The
        # |q|^2 + |r|^2 - 2 q.r expansion (a matmul) cancels catastrophically
        # in float32 at tissue-scale coordinates (~1e4): its absolute d^2
        # error is ~eps32 * |q|^2, i.e. relative distance errors of 1e-4 and
        # worse for near neighbours, and TF32 matmuls would add more. Two
        # differences per pair keep every distance to float32 rounding.
        dx = qt[:, 0:1] - ref_xy[None, :, 0]
        dy = qt[:, 1:2] - ref_xy[None, :, 1]
        d2 = dx * dx + dy * dy
        key = jnp.where(d2 <= r2, d2, jnp.inf)
        # lax.top_k is stable: equal keys resolve to the smaller ref index.
        neg_key, idx = jax.lax.top_k(-key, k)
        valid = jnp.isfinite(neg_key)
        d2_sel = jnp.take_along_axis(d2, idx, axis=1)
        return (
            jnp.where(valid, idx, -1),
            jnp.where(valid, jnp.sqrt(d2_sel), jnp.inf),
            valid,
        )

    idx, dist, mask = jax.lax.map(one_tile, q_tiles)
    idx = idx.reshape(-1, k)[:n]
    dist = dist.reshape(-1, k)[:n]
    mask = mask.reshape(-1, k)[:n]
    return idx, dist, mask

