"""Tile-binned visibility rasterization.

The production raster path: instead of testing every triangle against every
sample (ops.raster_xla dense path, kept as the semantic reference), the
framebuffer is split into tiles, triangles are binned per tile
(ops.binning), and each tile only rasterizes its bin list plus the shared
large-triangle list. This is the software analogue of the tiling a Vulkan GPU
performs in fixed-function hardware behind the reference's single
``drawIndexed`` stream (mesh.cppm:145-149).

Depth semantics match the dense path and the reference pipeline state
(compare op Less, clear depth 1.0 — graphics_pipeline.cppm:218-221,
engine.cppm:520): the winning fragment per sample is the lexicographic
minimum of (depth, triangle-id), i.e. the earliest-drawn triangle wins ties.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from vktf.ops.binning import TriangleBins, bin_triangles
from vktf.ops.raster_xla import BACKGROUND, SAMPLE_OFFSETS


def _raster_chunk(ids, lane_ok, edge, zw, anchor, sx, sy, best_depth, best_id):
    """Rasterize a chunk of triangles over one tile's samples.

    ids: (B,) triangle ids (garbage where ~lane_ok); sx/sy: (N,) sample
    coords; best_depth/best_id: (N,) running z-buffer. Plane constants are
    anchored at each triangle's bbox corner (triangle_setup), so evaluation
    uses (s - anchor) deltas. Returns updated pair.
    """
    e = edge[ids]  # (B,3,3)
    z = zw[ids]  # (B,2,3)
    anc = anchor[ids]  # (B,2)
    dx = sx[None, :] - anc[:, 0, None]  # (B,N)
    dy = sy[None, :] - anc[:, 1, None]

    def plane(coeff):  # coeff: (B,3) -> (B,N)
        return coeff[:, 0, None] * dx + coeff[:, 1, None] * dy + coeff[:, 2, None]

    e0 = plane(e[:, 0])
    e1 = plane(e[:, 1])
    e2 = plane(e[:, 2])

    def inside_edge(ev, coeff):
        # top-left fill rule (matches ops.raster_xla._edge_inside)
        ax, ay = coeff[:, 0, None], coeff[:, 1, None]
        top_left = (ax > 0) | ((ax == 0) & (ay > 0))
        return jnp.where(top_left, ev >= 0, ev > 0)

    inside = (
        inside_edge(e0, e[:, 0]) & inside_edge(e1, e[:, 1]) & inside_edge(e2, e[:, 2])
    )
    depth = plane(z[:, 0])
    w_recip = plane(z[:, 1])
    inside &= (w_recip > 0) & (depth >= 0.0) & (depth <= 1.0)
    inside &= lane_ok[:, None]

    masked = jnp.where(inside, depth, jnp.inf)
    arg = jnp.argmin(masked, axis=0)  # first min -> lowest chunk slot
    cand_depth = jnp.take_along_axis(masked, arg[None, :], axis=0)[0]
    cand_id = ids[arg]

    # lexicographic (depth, id) min — draw-order tie-break independent of
    # chunk processing order
    win = (cand_depth < best_depth) | (
        (cand_depth == best_depth) & (cand_id < best_id)
    )
    best_depth = jnp.where(win, cand_depth, best_depth)
    best_id = jnp.where(win, cand_id, best_id)
    return best_depth, best_id


def make_tile_raster(
    setup,
    bins: TriangleBins,
    *,
    tile_shape: tuple[int, int],
    tiles_x: int,
    bin_capacity: int,
    msaa_samples: int = 1,
    chunk: int = 32,
):
    """Build tile_fn(tile_idx) -> (tri_id, depth) of shape (S, th, tw).

    The per-tile visibility kernel, shared by the single-chip path and the
    tile-sharded multi-chip path (vktf.parallel).
    """
    th, tw = tile_shape
    # screen-space coverage planes when available (ops/vertex.py)
    edge = setup.get("edge_raster", setup["edge"])
    zw, anchor = setup["zw"], setup["anchor"]
    offsets = np.asarray(SAMPLE_OFFSETS[msaa_samples], np.float32)  # (S,2)
    S = offsets.shape[0]
    n_samples = S * th * tw

    # per-tile-local sample coordinates, flattened (S*th*tw,)
    ly = jax.lax.broadcasted_iota(jnp.float32, (S, th, tw), 1)
    lx = jax.lax.broadcasted_iota(jnp.float32, (S, th, tw), 2)
    lsx = (lx + offsets[:, 0][:, None, None]).reshape(n_samples)
    lsy = (ly + offsets[:, 1][:, None, None]).reshape(n_samples)

    large_capacity = bins.large.shape[0]
    large_total = jnp.minimum(bins.large_count, large_capacity)

    def tile_fn(tile_idx):
        oy = ((tile_idx // tiles_x) * th).astype(jnp.float32)
        ox = ((tile_idx % tiles_x) * tw).astype(jnp.float32)
        sx = lsx + ox
        sy = lsy + oy

        best_depth = jnp.full((n_samples,), 1.0, jnp.float32)
        best_id = jnp.full((n_samples,), BACKGROUND, jnp.int32)

        def make_body(row, count):
            def body(c, carry):
                bd, bi = carry
                ids = jax.lax.dynamic_slice(row, (c * chunk,), (chunk,))
                lane_ok = jnp.arange(chunk) < (count - c * chunk)
                return _raster_chunk(
                    ids, lane_ok, edge, zw, anchor, sx, sy, bd, bi
                )

            return body

        # shared large-triangle list first (order-independent merge)
        n_large_chunks = (large_total + chunk - 1) // chunk
        best_depth, best_id = jax.lax.fori_loop(
            0,
            n_large_chunks,
            make_body(bins.large, large_total),
            (best_depth, best_id),
        )

        row = bins.bins[tile_idx]
        count = jnp.minimum(bins.bin_counts[tile_idx], bin_capacity)
        n_chunks = (count + chunk - 1) // chunk
        best_depth, best_id = jax.lax.fori_loop(
            0, n_chunks, make_body(row, count), (best_depth, best_id)
        )
        return (
            best_id.reshape(S, th, tw),
            best_depth.reshape(S, th, tw),
        )

    return tile_fn


def setup_from_packed(packed):
    """The dict setup rasterize_tiled/rasterize_dense read, rebuilt from the
    packed stream rows of raster_pallas.pack_tri_rows (coverage planes,
    depth/w planes, bbox-corner anchors, bboxes, validity) — so the XLA
    rasterizers can run on exactly the setup the frame program feeds the
    raster kernel."""
    td, br = packed["tri_data"], packed["bbox_rows"]
    t = td.shape[1]
    return {
        "edge": td[0:9].T.reshape(t, 3, 3),
        "zw": td[9:15].T.reshape(t, 2, 3),
        "anchor": br[0:2].T,
        "bbox": br.T.astype(jnp.int32),
        "valid": packed["valid"],
    }


def rasterize_tiled(
    setup,
    height: int,
    width: int,
    *,
    tile_shape: tuple[int, int],
    bin_capacity: int = 2048,
    k_pairs: int = 8,
    large_capacity: int = 256,
    msaa_samples: int = 1,
    chunk: int = 32,
    tile_batch: int = 8,
    bins: TriangleBins | None = None,
):
    """Rasterize with tile binning; returns (tri_id, depth) of shape (S,H,W).

    height/width must be multiples of tile_shape (the pipeline pads).
    """
    th, tw = tile_shape
    assert height % th == 0 and width % tw == 0
    tiles_y, tiles_x = height // th, width // tw
    num_tiles = tiles_y * tiles_x
    S = len(SAMPLE_OFFSETS[msaa_samples])

    if bins is None:
        bins = bin_triangles(
            setup["bbox"],
            setup["valid"],
            tile_shape=tile_shape,
            tiles_y=tiles_y,
            tiles_x=tiles_x,
            capacity=bin_capacity,
            k_pairs=k_pairs,
            large_capacity=large_capacity,
        )

    tile_fn = make_tile_raster(
        setup,
        bins,
        tile_shape=tile_shape,
        tiles_x=tiles_x,
        bin_capacity=bin_capacity,
        msaa_samples=msaa_samples,
        chunk=chunk,
    )

    tile_ids, tile_depths = jax.lax.map(
        tile_fn, jnp.arange(num_tiles, dtype=jnp.int32), batch_size=tile_batch
    )

    def assemble(tiles):  # (num_tiles, S, th, tw) -> (S, H, W)
        return (
            tiles.reshape(tiles_y, tiles_x, S, th, tw)
            .transpose(2, 0, 3, 1, 4)
            .reshape(S, height, width)
        )

    return assemble(tile_ids), assemble(tile_depths)
