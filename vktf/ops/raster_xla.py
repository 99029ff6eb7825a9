"""Visibility-buffer rasterization (pure-XLA path).

Replaces the reference's fixed-function raster state — triangle list, back
-face cull, depth test Less, MSAA (graphics_pipeline.cppm:205-234) — with a
dense chunked depth-resolve: for each triangle chunk, evaluate homogeneous
edge functions over the framebuffer, and keep the closest (depth, tri_id) per
sample. "Closest wins with ties to the earlier triangle" reproduces draw
-order + Less-test semantics for opaque geometry.

The dense path tests every triangle against every pixel (fine for small
scenes and as a reference); the binned path in
:mod:`vktf.ops.binning` restricts work to screen tiles.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

# Vulkan standard sample locations (pixel-relative), spec table "Standard
# sample locations": the reference negotiates max-of-{8,4,2} MSAA
# (engine.cppm:157-171).
SAMPLE_OFFSETS = {
    1: [(0.5, 0.5)],
    2: [(0.75, 0.75), (0.25, 0.25)],
    4: [(0.375, 0.125), (0.875, 0.375), (0.125, 0.625), (0.625, 0.875)],
    8: [
        (0.5625, 0.3125),
        (0.4375, 0.6875),
        (0.8125, 0.5625),
        (0.3125, 0.1875),
        (0.1875, 0.8125),
        (0.0625, 0.4375),
        (0.6875, 0.9375),
        (0.9375, 0.0625),
    ],
}

BACKGROUND = jnp.int32(-1)


def _edge_inside(e, ax, ay):
    """Top-left fill rule: boundary pixels belong to top/left edges only."""
    top_left = (ax > 0) | ((ax == 0) & (ay > 0))
    return jnp.where(top_left, e >= 0, e > 0)


def _raster_one(edge, zw, anchor, sx, sy):
    """Coverage + depth for one triangle over a pixel grid.

    edge: (3,3) anchored edge planes, zw: (2,3) anchored depth/w planes,
    anchor: (2,); sx/sy: (...,) sample coords. Plane constants live at the
    triangle's anchor (triangle_setup), so evaluation uses (s - anchor)
    deltas — this keeps f32 magnitudes small (see triangle_setup docstring).
    Returns (inside, depth) arrays of the grid shape.
    """
    dx = sx - anchor[0]
    dy = sy - anchor[1]
    e0 = edge[0, 0] * dx + edge[0, 1] * dy + edge[0, 2]
    e1 = edge[1, 0] * dx + edge[1, 1] * dy + edge[1, 2]
    e2 = edge[2, 0] * dx + edge[2, 1] * dy + edge[2, 2]
    inside = (
        _edge_inside(e0, edge[0, 0], edge[0, 1])
        & _edge_inside(e1, edge[1, 0], edge[1, 1])
        & _edge_inside(e2, edge[2, 0], edge[2, 1])
    )
    depth = zw[0, 0] * dx + zw[0, 1] * dy + zw[0, 2]
    w_recip = zw[1, 0] * dx + zw[1, 1] * dy + zw[1, 2]
    inside &= (w_recip > 0) & (depth >= 0.0) & (depth <= 1.0)
    return inside, depth


def rasterize_dense(setup, height: int, width: int, msaa_samples: int = 1,
                    chunk: int = 8, layers: int = 1):
    """Rasterize all triangles; returns (tri_id, depth) of shape (S, H, W).

    tri_id == -1 where no triangle covers the sample; depth initialized to the
    clear value 1.0 (engine.cppm:520 clears depth to 1.0, compare op Less).
    layers = K > 1 keeps the K nearest fragments per sample instead, ordered
    by (depth, draw order), as (K, S, H, W) arrays — the depth-peel
    reference for the raster kernel.
    """
    if layers > 1:
        return _rasterize_dense_peel(setup, height, width, msaa_samples,
                                     layers)
    edge, zw, anchor, valid = (
        # screen-space coverage planes when available (ops/vertex.py)
        setup.get("edge_raster", setup["edge"]),
        setup["zw"],
        setup["anchor"],
        setup["valid"],
    )
    num_tris = edge.shape[0]
    offsets = np.asarray(SAMPLE_OFFSETS[msaa_samples], np.float32)  # (S,2)
    S = offsets.shape[0]

    px = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    py = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    sx = px[None] + offsets[:, 0][:, None, None]  # (S,H,W)
    sy = py[None] + offsets[:, 1][:, None, None]

    init_id = jnp.full((S, height, width), BACKGROUND, jnp.int32)
    init_depth = jnp.full((S, height, width), 1.0, jnp.float32)

    num_chunks = -(-num_tris // chunk)

    def body(c, carry):
        best_id, best_depth = carry
        base = c * chunk
        for k in range(chunk):
            t = jnp.minimum(base + k, num_tris - 1)
            ok = ((base + k) < num_tris) & valid[t]
            inside, depth = _raster_one(edge[t], zw[t], anchor[t], sx, sy)
            # Strict < keeps the earlier (lower-index) triangle on depth ties,
            # matching draw order + Less semantics.
            win = ok & inside & (depth < best_depth)
            best_depth = jnp.where(win, depth, best_depth)
            best_id = jnp.where(win, base + k, best_id)
        return best_id, best_depth

    best_id, best_depth = jax.lax.fori_loop(
        0, num_chunks, body, (init_id, init_depth)
    )
    return best_id, best_depth


def _rasterize_dense_peel(setup, height, width, msaa_samples, layers):
    """Every triangle in draw order, inserted into a sorted K-layer list."""
    edge = setup.get("edge_raster", setup["edge"])
    zw, anchor, valid = setup["zw"], setup["anchor"], setup["valid"]
    offsets = np.asarray(SAMPLE_OFFSETS[msaa_samples], np.float32)
    S = offsets.shape[0]
    px = jax.lax.broadcasted_iota(jnp.float32, (height, width), 1)
    py = jax.lax.broadcasted_iota(jnp.float32, (height, width), 0)
    sx = px[None] + offsets[:, 0][:, None, None]
    sy = py[None] + offsets[:, 1][:, None, None]
    shape = (layers, S, height, width)

    def body(t, carry):
        ids, deps = carry
        inside, depth = _raster_one(edge[t], zw[t], anchor[t], sx, sy)
        ok = inside & valid[t]
        cur_d, cur_i = depth, jnp.full(depth.shape, t, jnp.int32)
        out_i, out_d = [], []
        for l in range(layers):
            # lexicographic (depth, draw order): entries displaced downward
            # can tie a deeper entry's depth
            swap = ok & ((cur_d < deps[l])
                         | ((cur_d == deps[l]) & (cur_i < ids[l])))
            out_d.append(jnp.where(swap, cur_d, deps[l]))
            out_i.append(jnp.where(swap, cur_i, ids[l]))
            cur_d = jnp.where(swap, deps[l], cur_d)
            cur_i = jnp.where(swap, ids[l], cur_i)
        return jnp.stack(out_i), jnp.stack(out_d)

    return jax.lax.fori_loop(
        0, edge.shape[0], body,
        (jnp.full(shape, BACKGROUND, jnp.int32),
         jnp.ones(shape, jnp.float32)))
