"""Batched triangle-orientation ops (JAX, runs on the device).

The space-tearing machinery of SAME reduces to one primitive: the sign of the
cross product ``(b-a) x (c-a)`` for a batch of triangles. The reference
computes this per-triangle in Python inside a Gurobi callback
(reference src/same.py:651-669); here it is a single vectorized op over all
triangles, usable inside jit.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def triangle_cross(coords: jax.Array, tris: jax.Array) -> jax.Array:
    """Cross products ``(b-a) x (c-a)`` for triangles.

    Parameters
    ----------
    coords : [n, 2] float array of point coordinates.
    tris : [T, 3] int array of vertex indices into ``coords``.

    Returns
    -------
    [T] float array. Signed area is half of this value.
    """
    p = coords[tris]  # [T, 3, 2]
    a, b, c = p[:, 0], p[:, 1], p[:, 2]
    return (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) - (
        b[:, 1] - a[:, 1]
    ) * (c[:, 0] - a[:, 0])


def triangle_orientation(
    coords: jax.Array, tris: jax.Array, round_decimals: int | None = None
) -> jax.Array:
    """Orientation sign per triangle: +1 CCW, -1 CW, 0 degenerate.

    ``round_decimals=3`` reproduces the reference's ``signed_area_terms``
    (reference src/helpers.py:398-411) which rounds the cross product to three
    decimals before taking the sign; ``None`` matches the raw ``np.sign``
    used in the lazy callback (reference src/same.py:658).
    """
    cross = triangle_cross(coords, tris)
    if round_decimals is not None:
        scale = 10.0**round_decimals
        cross = jnp.round(cross * scale) / scale
    return jnp.sign(cross).astype(jnp.int32)


def matched_triangle_flips(
    ref_coords: jax.Array,
    tris: jax.Array,
    tri_mask: jax.Array,
    match_ref: jax.Array,
    source_signs: jax.Array,
):
    """Vectorized flip test for all triangles under a matching.

    Mirrors the per-incumbent sweep of the reference's lazy callback
    (reference src/same.py:641-669): a triangle is *checked* iff all three
    vertices are matched and neither its source nor its image orientation is
    degenerate; it is *flipped* iff the image orientation differs from the
    source orientation.

    Parameters
    ----------
    ref_coords : [m, 2] reference point coordinates.
    tris : [T, 3] triangle vertex indices into aligned points.
    tri_mask : [T] bool, False for padding triangles.
    match_ref : [n] int; for each aligned point, matched ref row or -1.
    source_signs : [T] int32 orientation of each source triangle.

    Returns
    -------
    (checked, flipped) : two [T] bool arrays.
    """
    tri_match = match_ref[tris]  # [T, 3]
    all_matched = jnp.all(tri_match >= 0, axis=1) & tri_mask
    # Clamp so gathers stay in-bounds for unmatched vertices; they are masked.
    ref_tris = jnp.clip(tri_match, 0, ref_coords.shape[0] - 1)
    ref_sign = triangle_orientation(ref_coords, ref_tris)
    checked = all_matched & (source_signs != 0) & (ref_sign != 0)
    flipped = checked & (ref_sign != source_signs)
    return checked, flipped
