"""Device-resident texture pool + filtered sampling.

Replacement for Vulkan combined image samplers
(reference: src/engine/texture.cppm, material descriptor writes
material.cppm:138-171): every decoded mip level of every texture lives in one
packed-u32 RGBA texel pool in HBM; sampling is address arithmetic + gathers.
Wrap modes, mag/min/mip filters, and sRGB decode (performed pre-filter, as
sampler hardware does) follow the glTF sampler state parsed by the loader
(gltf_asset.cppm:484-556 semantics).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from vktf.loaders.images import TextureData, srgb_to_linear

WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR = 0, 1, 2
_WRAP_CODES = {"repeat": WRAP_REPEAT, "clamp_to_edge": WRAP_CLAMP, "mirrored_repeat": WRAP_MIRROR}

# 256-entry sRGB EOTF lookup table: converts gathered u8 channels to linear
# with a gather instead of a per-texel pow.
_SRGB_LUT = srgb_to_linear(np.arange(256, dtype=np.float64) / 255.0).astype(np.float32)
_LINEAR_LUT = (np.arange(256, dtype=np.float32) / 255.0).astype(np.float32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TexturePool:
    """All textures' mip chains packed into one gatherable pool."""

    texels: jnp.ndarray  # (P,) uint32 packed RGBA (r | g<<8 | b<<16 | a<<24)
    level_offset: jnp.ndarray  # (TEX, LMAX) int32 texel offset of each level
    level_width: jnp.ndarray  # (TEX, LMAX) int32
    level_height: jnp.ndarray  # (TEX, LMAX) int32
    num_levels: jnp.ndarray  # (TEX,) int32
    wrap: jnp.ndarray  # (TEX, 2) int32 wrap mode for u/v
    filters: jnp.ndarray  # (TEX, 3) int32: (mag_nearest, min_nearest, mip_nearest)
    srgb: jnp.ndarray  # (TEX,) int32 1 = sRGB-encoded payload


def build_texture_pool(textures: list[tuple[TextureData, dict]]) -> TexturePool:
    """Pack decoded textures into a TexturePool.

    `textures` pairs TextureData with sampler state dicts holding keys
    mag_filter/min_filter/mipmap_mode ("nearest"/"linear") and wrap_u/wrap_v.
    """
    if not textures:
        # single white texel so gathers stay well-defined
        textures = [
            (
                TextureData(levels=[np.full((1, 1, 4), 255, np.uint8)], srgb=False),
                {},
            )
        ]
    max_levels = max(len(t.levels) for t, _ in textures)
    count = len(textures)
    pool = []
    offset = 0
    level_offset = np.zeros((count, max_levels), np.int32)
    level_width = np.ones((count, max_levels), np.int32)
    level_height = np.ones((count, max_levels), np.int32)
    num_levels = np.zeros(count, np.int32)
    wrap = np.zeros((count, 2), np.int32)
    filters = np.zeros((count, 3), np.int32)
    srgb = np.zeros(count, np.int32)
    for i, (tex, sampler) in enumerate(textures):
        num_levels[i] = len(tex.levels)
        srgb[i] = int(tex.srgb)
        wrap[i, 0] = _WRAP_CODES.get(sampler.get("wrap_u", "repeat"), WRAP_REPEAT)
        wrap[i, 1] = _WRAP_CODES.get(sampler.get("wrap_v", "repeat"), WRAP_REPEAT)
        filters[i, 0] = int(sampler.get("mag_filter", "linear") == "nearest")
        filters[i, 1] = int(sampler.get("min_filter", "linear") == "nearest")
        filters[i, 2] = int(sampler.get("mipmap_mode", "linear") == "nearest")
        for lvl, data in enumerate(tex.levels):
            h, w = data.shape[:2]
            level_offset[i, lvl] = offset
            level_width[i, lvl] = w
            level_height[i, lvl] = h
            packed = (
                data[..., 0].astype(np.uint32)
                | (data[..., 1].astype(np.uint32) << 8)
                | (data[..., 2].astype(np.uint32) << 16)
                | (data[..., 3].astype(np.uint32) << 24)
            )
            pool.append(packed.reshape(-1))
            offset += w * h
        # pad remaining level table entries with the last level (clamp lod)
        for lvl in range(len(tex.levels), max_levels):
            level_offset[i, lvl] = level_offset[i, len(tex.levels) - 1]
            level_width[i, lvl] = level_width[i, len(tex.levels) - 1]
            level_height[i, lvl] = level_height[i, len(tex.levels) - 1]
    return TexturePool(
        texels=jnp.asarray(np.concatenate(pool)),
        level_offset=jnp.asarray(level_offset),
        level_width=jnp.asarray(level_width),
        level_height=jnp.asarray(level_height),
        num_levels=jnp.asarray(num_levels),
        wrap=jnp.asarray(wrap),
        filters=jnp.asarray(filters),
        srgb=jnp.asarray(srgb),
    )


def _apply_wrap(coord, size, mode):
    """Integer texel-coordinate wrap. coord int32, size int32, mode int32."""
    size = jnp.maximum(size, 1)
    repeat = jnp.remainder(coord, size)
    clamp = jnp.clip(coord, 0, size - 1)
    period = 2 * size
    m = jnp.remainder(coord, period)
    mirror = jnp.where(m >= size, period - 1 - m, m)
    return jnp.where(mode == WRAP_REPEAT, repeat, jnp.where(mode == WRAP_CLAMP, clamp, mirror))


def _gather_texels(pool: TexturePool, index, srgb_flag):
    """Gather packed texels and unpack to linear-space f32 RGBA."""
    v = jnp.take(pool.texels, index, mode="clip")
    r = (v & 0xFF).astype(jnp.int32)
    g = ((v >> 8) & 0xFF).astype(jnp.int32)
    b = ((v >> 16) & 0xFF).astype(jnp.int32)
    a = ((v >> 24) & 0xFF).astype(jnp.int32)
    srgb_lut = jnp.asarray(_SRGB_LUT)
    lin_lut = jnp.asarray(_LINEAR_LUT)

    def chan(c):
        return jnp.where(
            srgb_flag != 0, jnp.take(srgb_lut, c, mode="clip"), jnp.take(lin_lut, c, mode="clip")
        )

    return jnp.stack([chan(r), chan(g), chan(b), jnp.take(lin_lut, a, mode="clip")], axis=-1)


def _sample_level(pool: TexturePool, tex_id, level, uv, nearest):
    """Bilinear (or nearest, via snapped weights) sample of one mip level."""
    offset = pool.level_offset[tex_id, level]
    w = pool.level_width[tex_id, level]
    h = pool.level_height[tex_id, level]
    wrap_u = pool.wrap[tex_id, 0]
    wrap_v = pool.wrap[tex_id, 1]
    srgb_flag = pool.srgb[tex_id]

    x = uv[..., 0] * w.astype(jnp.float32) - 0.5
    y = uv[..., 1] * h.astype(jnp.float32) - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    # nearest filter == bilinear with weights snapped to {0,1}
    fx = jnp.where(nearest, (fx >= 0.5).astype(jnp.float32), fx)
    fy = jnp.where(nearest, (fy >= 0.5).astype(jnp.float32), fy)
    x0 = x0f.astype(jnp.int32)
    y0 = y0f.astype(jnp.int32)

    def texel(xi, yi):
        xi = _apply_wrap(xi, w, wrap_u)
        yi = _apply_wrap(yi, h, wrap_v)
        return _gather_texels(pool, offset + yi * w + xi, srgb_flag)

    c00 = texel(x0, y0)
    c10 = texel(x0 + 1, y0)
    c01 = texel(x0, y0 + 1)
    c11 = texel(x0 + 1, y0 + 1)
    fx = fx[..., None]
    fy = fy[..., None]
    top = c00 * (1.0 - fx) + c10 * fx
    bottom = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bottom * fy


def sample_texture(pool: TexturePool, tex_id, uv, duvdx, duvdy):
    """Filtered texture sample with analytic LOD.

    tex_id: (...,) int32; uv/duvdx/duvdy: (...,2) float32 (uv derivatives per
    pixel step). Returns linear-space RGBA (...,4).
    """
    w0 = pool.level_width[tex_id, 0].astype(jnp.float32)
    h0 = pool.level_height[tex_id, 0].astype(jnp.float32)
    # Vulkan-style scale factor: max of the two footprint axis lengths.
    ddx = jnp.stack([duvdx[..., 0] * w0, duvdx[..., 1] * h0], axis=-1)
    ddy = jnp.stack([duvdy[..., 0] * w0, duvdy[..., 1] * h0], axis=-1)
    rho2 = jnp.maximum(jnp.sum(ddx * ddx, axis=-1), jnp.sum(ddy * ddy, axis=-1))
    lod = 0.5 * jnp.log2(jnp.maximum(rho2, 1e-24))

    max_level = (pool.num_levels[tex_id] - 1).astype(jnp.float32)
    lod = jnp.clip(lod, 0.0, max_level)
    level0 = jnp.floor(lod)
    lfrac = lod - level0
    mip_nearest = pool.filters[tex_id, 2] != 0
    lfrac = jnp.where(mip_nearest, (lfrac >= 0.5).astype(jnp.float32), lfrac)

    magnifying = lod <= 0.0
    nearest = jnp.where(
        magnifying, pool.filters[tex_id, 0] != 0, pool.filters[tex_id, 1] != 0
    )

    l0 = level0.astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, max_level.astype(jnp.int32))
    s0 = _sample_level(pool, tex_id, l0, uv, nearest)
    s1 = _sample_level(pool, tex_id, l1, uv, nearest)
    return s0 * (1.0 - lfrac[..., None]) + s1 * lfrac[..., None]
