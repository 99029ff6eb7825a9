"""Triangle→tile binning for the tiled rasterizer.

The replacement for the reference's per-draw pipeline submission:
where Vulkan hardware bins primitives to raster tiles internally, we build
explicit per-tile triangle lists as dense device arrays, keeping every step
static-shape and sort-based (XLA-friendly, SURVEY.md §7 hard part 1).

Scheme (sort-middle):
  * each triangle's conservative screen bbox (from triangle_setup) maps to a
    tile range; triangles covering <= ``k_pairs`` tiles emit one
    (tile, triangle) pair per covered tile;
  * triangles covering more tiles (near-plane spanners, close-up walls) go to
    a single global "large" list that every tile additionally rasterizes —
    these are rare by construction, so the fixed ``large_capacity`` is small;
  * pairs sort by (tile, triangle-index) — one radix sort — giving per-tile
    contiguous runs in draw order; run offsets come from a searchsorted.

Overflow (bin or large-list capacity) is reported in the result so callers
can apply the reference's skip-with-logged-error policy (SURVEY.md §5.3)
outside jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class TriangleBins(NamedTuple):
    bins: jnp.ndarray  # (num_tiles, capacity) i32 triangle ids, draw order
    bin_counts: jnp.ndarray  # (num_tiles,) i32 — may exceed capacity (overflow)
    large: jnp.ndarray  # (large_capacity,) i32 triangle ids, draw order
    large_count: jnp.ndarray  # () i32 — may exceed large_capacity (overflow)


def bin_triangles(
    bbox: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    tile_shape: tuple[int, int],
    tiles_y: int,
    tiles_x: int,
    capacity: int,
    k_pairs: int = 8,
    large_capacity: int = 256,
) -> TriangleBins:
    """Bin triangles to screen tiles.

    bbox: (T,4) i32 pixel bbox (x0,y0,x1,y1), inclusive-exclusive, already
    clipped to the padded framebuffer; valid: (T,) bool.
    """
    th, tw = tile_shape
    num_tiles = tiles_y * tiles_x
    num_tris = bbox.shape[0]

    x0, y0, x1, y1 = bbox[:, 0], bbox[:, 1], bbox[:, 2], bbox[:, 3]
    nonempty = valid & (x1 > x0) & (y1 > y0)
    tx0 = x0 // tw
    ty0 = y0 // th
    tx1 = (x1 - 1) // tw  # inclusive
    ty1 = (y1 - 1) // th
    span_x = jnp.where(nonempty, tx1 - tx0 + 1, 0)
    span_y = jnp.where(nonempty, ty1 - ty0 + 1, 0)
    n_cover = span_x * span_y

    is_small = nonempty & (n_cover <= k_pairs)
    is_large = nonempty & (n_cover > k_pairs)

    tri_idx = jnp.arange(num_tris, dtype=jnp.int32)

    # -- small triangles: one pair per covered tile (k-th covered tile in
    # row-major order within the bbox tile range) ----------------------------
    k = jnp.arange(k_pairs, dtype=jnp.int32)[None, :]  # (1,K)
    safe_span_x = jnp.maximum(span_x, 1)[:, None]
    kt_y = ty0[:, None] + k // safe_span_x
    kt_x = tx0[:, None] + k % safe_span_x
    pair_active = is_small[:, None] & (k < n_cover[:, None])
    pair_tile = jnp.where(pair_active, kt_y * tiles_x + kt_x, num_tiles)

    # one stable sort on the tile key; pairs are laid out triangle-major, so
    # stability keeps each tile's run in draw (triangle-index) order
    pair_tri = jnp.broadcast_to(tri_idx[:, None], pair_tile.shape)
    perm = jnp.argsort(pair_tile.reshape(-1), stable=True)
    sorted_tile = pair_tile.reshape(-1)[perm]
    sorted_tri = pair_tri.reshape(-1)[perm]

    starts = jnp.searchsorted(sorted_tile, jnp.arange(num_tiles + 1, dtype=jnp.int32))
    bin_counts = jnp.diff(starts).astype(jnp.int32)

    slot = jnp.arange(capacity, dtype=jnp.int32)[None, :]  # (1,C)
    gather_idx = jnp.minimum(
        starts[:-1, None] + slot, sorted_tri.shape[0] - 1
    )
    bins = jnp.where(
        slot < bin_counts[:, None], sorted_tri[gather_idx], jnp.int32(0)
    )

    # -- large triangles: compact to a fixed list, draw order ----------------
    large_key = jnp.where(is_large, tri_idx, jnp.int32(num_tris))
    if num_tris < large_capacity:  # pad so the fixed-size slice is total
        large_key = jnp.concatenate(
            [large_key, jnp.full(large_capacity - num_tris, num_tris, jnp.int32)]
        )
    large_sorted = jnp.sort(large_key)[:large_capacity].astype(jnp.int32)
    large_count = jnp.sum(is_large).astype(jnp.int32)
    large = jnp.where(
        jnp.arange(large_capacity) < large_count, large_sorted, jnp.int32(0)
    )

    return TriangleBins(bins, bin_counts, large, large_count)


def binning_overflow(bins: TriangleBins, capacity: int, large_capacity: int):
    """(dropped_pairs, dropped_large) — nonzero means capacity overflow; the
    engine logs it per the skip-and-log policy (model.cppm:301-321 ethos)."""
    dropped = jnp.sum(jnp.maximum(bins.bin_counts - capacity, 0))
    dropped_large = jnp.maximum(bins.large_count - large_capacity, 0)
    return dropped, dropped_large
