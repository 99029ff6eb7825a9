"""Component-first texture sampling.

Same sampler semantics as ops.texture.sample_texture (bilinear/nearest,
mip-mapped with analytic LOD, repeat/clamp/mirror wrap — the glTF sampler
states built in gltf_asset.cppm:484-556) but operating on flat (N,) sample
vectors with components as tuples (see ops.shade_cf module docstring).
"""

from __future__ import annotations

import jax.numpy as jnp

from vktf.ops.texture import (
    _LINEAR_LUT,
    _SRGB_LUT,
    WRAP_CLAMP,
    WRAP_REPEAT,
    TexturePool,
)


def _apply_wrap(coord, size, mode):
    size = jnp.maximum(size, 1)
    repeat = jnp.remainder(coord, size)
    clamp = jnp.clip(coord, 0, size - 1)
    period = 2 * size
    m = jnp.remainder(coord, period)
    mirror = jnp.where(m >= size, period - 1 - m, m)
    return jnp.where(mode == WRAP_REPEAT, repeat, jnp.where(mode == WRAP_CLAMP, clamp, mirror))


def _gather_texels_cf(pool: TexturePool, index, srgb_flag):
    """(N,) packed-texel gather -> 4-tuple of (N,) linear floats."""
    v = jnp.take(pool.texels, index, mode="clip")
    srgb_lut = jnp.asarray(_SRGB_LUT)
    lin_lut = jnp.asarray(_LINEAR_LUT)

    def chan(shift, lut_select):
        c = ((v >> shift) & 0xFF).astype(jnp.int32)
        if lut_select:
            return jnp.where(
                srgb_flag != 0,
                jnp.take(srgb_lut, c, mode="clip"),
                jnp.take(lin_lut, c, mode="clip"),
            )
        return jnp.take(lin_lut, c, mode="clip")

    return (chan(0, True), chan(8, True), chan(16, True), chan(24, False))


def _sample_level_cf(pool: TexturePool, tex_id, level, u, v, nearest):
    offset = pool.level_offset[tex_id, level]
    w = pool.level_width[tex_id, level]
    h = pool.level_height[tex_id, level]
    wrap_u = pool.wrap[:, 0][tex_id]
    wrap_v = pool.wrap[:, 1][tex_id]
    srgb_flag = pool.srgb[tex_id]

    x = u * w.astype(jnp.float32) - 0.5
    y = v * h.astype(jnp.float32) - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    fx = jnp.where(nearest, (fx >= 0.5).astype(jnp.float32), fx)
    fy = jnp.where(nearest, (fy >= 0.5).astype(jnp.float32), fy)
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)

    def texel(xi, yi):
        xi = _apply_wrap(xi, w, wrap_u)
        yi = _apply_wrap(yi, h, wrap_v)
        return _gather_texels_cf(pool, offset + yi * w + xi, srgb_flag)

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    gx, gy = fx, fy
    return tuple(
        (c00[c] * (1.0 - gx) + c10[c] * gx) * (1.0 - gy)
        + (c01[c] * (1.0 - gx) + c11[c] * gx) * gy
        for c in range(4)
    )


def sample_texture_cf(pool: TexturePool, tex_id, uv, duvdx, duvdy):
    """Filtered sample; tex_id (N,), uv/duvdx/duvdy 2-tuples of (N,).

    Returns a 4-tuple of (N,) linear-space RGBA channels.
    """
    w0 = pool.level_width[:, 0][tex_id].astype(jnp.float32)
    h0 = pool.level_height[:, 0][tex_id].astype(jnp.float32)
    dx_u = duvdx[0] * w0
    dx_v = duvdx[1] * h0
    dy_u = duvdy[0] * w0
    dy_v = duvdy[1] * h0
    rho2 = jnp.maximum(dx_u * dx_u + dx_v * dx_v, dy_u * dy_u + dy_v * dy_v)
    lod = 0.5 * jnp.log2(jnp.maximum(rho2, 1e-24))

    max_level = (pool.num_levels[tex_id] - 1).astype(jnp.float32)
    lod = jnp.clip(lod, 0.0, max_level)
    level0 = jnp.floor(lod)
    lfrac = lod - level0
    mip_nearest = pool.filters[:, 2][tex_id] != 0
    lfrac = jnp.where(mip_nearest, (lfrac >= 0.5).astype(jnp.float32), lfrac)

    magnifying = lod <= 0.0
    nearest = jnp.where(
        magnifying, pool.filters[:, 0][tex_id] != 0, pool.filters[:, 1][tex_id] != 0
    )

    l0 = level0.astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, max_level.astype(jnp.int32))
    s0 = _sample_level_cf(pool, tex_id, l0, uv[0], uv[1], nearest)
    s1 = _sample_level_cf(pool, tex_id, l1, uv[0], uv[1], nearest)
    return tuple(s0[c] * (1.0 - lfrac) + s1[c] * lfrac for c in range(4))
