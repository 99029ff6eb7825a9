"""Component-first deferred PBR shading.

Same math as the reference fragment shader (src/game/shaders/fragment.glsl,
cited per formula below), laid out component-first: every per-sample
quantity is a flat ``(N,)`` vector or a ``(C, N)`` stack, never
``(..., C)``, so the sample axis stays the long contiguous one.

Used inside the per-tile render loop (N = samples-per-tile) and by the dense
debug path (N = all samples).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vktf.ops.texture import TexturePool
from vktf.ops.texture_cf import sample_texture_cf

PI = 3.1415927
EPSILON = 1.0e-7
POINT_LIGHT_RADIUS = 0.1


def _rnorm(vx, vy, vz, eps=1e-20):
    r = jax.lax.rsqrt(jnp.maximum(vx * vx + vy * vy + vz * vz, eps))
    return vx * r, vy * r, vz * r


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def material_brdf_cf(base_rgb, metallic, roughness, l, n, v):
    """GetMaterialBrdf (fragment.glsl:111-128); all args component tuples of
    (N,) arrays: base_rgb=(r,g,b), l/n/v=(x,y,z)."""
    hx, hy, hz = _rnorm(l[0] + v[0], l[1] + v[1], l[2] + v[2])
    alpha = roughness * roughness
    alpha2 = alpha * alpha

    h_dot_v = _dot3(hx, hy, hz, *v)
    h_dot_l = _dot3(hx, hy, hz, *l)
    n_dot_l = _dot3(*n, *l)
    n_dot_v = _dot3(*n, *v)
    n_dot_h = _dot3(*n, hx, hy, hz)

    one_minus_metal = 1.0 - metallic
    f0 = tuple(0.04 * one_minus_metal + c * metallic for c in base_rgb)
    fres_pow = jnp.power(1.0 - jnp.abs(h_dot_v), 5.0)
    fresnel = tuple(f + (1.0 - f) * fres_pow for f in f0)

    def smith_half(n_dot):
        return jnp.abs(n_dot) + jnp.sqrt(alpha2 + (1.0 - alpha2) * n_dot * n_dot) + EPSILON

    visibility = (
        jnp.where(h_dot_l >= 0.0, 1.0, 0.0)
        / smith_half(n_dot_l)
        * jnp.where(h_dot_v >= 0.0, 1.0, 0.0)
        / smith_half(n_dot_v)
    )
    d_denom = n_dot_h * n_dot_h * (alpha2 - 1.0) + 1.0
    distribution = (
        jnp.where(n_dot_h >= 0.0, 1.0, 0.0) * alpha2 / (PI * d_denom * d_denom + EPSILON)
    )
    spec_scale = visibility * distribution
    diffuse_scale = one_minus_metal / PI
    return tuple(
        (1.0 - fresnel[c]) * diffuse_scale * base_rgb[c] + fresnel[c] * spec_scale
        for c in range(3)
    )


def shade_lights_cf(world_pos, normal, view_dir, base_rgb, metallic, roughness, lights):
    """Σ radiance·brdf·cosθ over a static light array (fragment.glsl:137-145).

    world_pos/normal/view_dir: 3-tuples of (N,); lights: (L,8) numpy-style
    device array — or a list of 8-tuples of scalars (the Pallas shade
    kernel's form, ops.shade_pallas) — unrolled at trace time (the
    light-count specialization constant analogue,
    graphics_pipeline.cppm:148-155).
    """
    r = [jnp.zeros_like(world_pos[0]) for _ in range(3)]
    count = lights.shape[0] if hasattr(lights, "shape") else len(lights)
    for i in range(count):
        light = lights[i]
        has_position = jnp.where(light[3] != 0.0, 1.0, 0.0)
        lvx = light[0] - has_position * world_pos[0]
        lvy = light[1] - has_position * world_pos[1]
        lvz = light[2] - has_position * world_pos[2]
        dist = jnp.maximum(
            jnp.sqrt(jnp.maximum(lvx * lvx + lvy * lvy + lvz * lvz, 1e-20)),
            POINT_LIGHT_RADIUS,
        )
        attenuation = (1.0 - has_position) + has_position / (dist * dist)
        inv = 1.0 / dist
        l = (lvx * inv, lvy * inv, lvz * inv)
        brdf = material_brdf_cf(base_rgb, metallic, roughness, l, normal, view_dir)
        cos_theta = jnp.maximum(_dot3(*normal, *l), 0.0)
        scale = attenuation * cos_theta
        for c in range(3):
            r[c] = r[c] + scale * light[4 + c] * brdf[c]
    return tuple(r)


def shade_samples_cf(
    tri_id,
    sx,
    sy,
    setup,
    indices,
    world_pos,
    world_normal,
    world_tangent,
    uvs,
    tri_material,
    mat_base_color,
    mat_metallic_roughness,
    mat_normal_scale,
    mat_alpha,
    mat_textures,
    texture_pool: TexturePool,
    camera_position,
    lights,
    background_rgba,
):
    """Shade a flat visibility vector; returns (4, N) linear RGBA.

    tri_id/sx/sy: (N,). Geometry/material inputs are the global scene arrays
    (any layout — gathered per sample into (N,) components here).
    Implements the full reference fragment stage per sample.
    """
    covered = tri_id >= 0
    t = jnp.maximum(tri_id, 0)

    edge = setup["edge"]  # (T,3,3), anchored at the triangle bbox corner

    # e_i = a_i*(sx-ax) + b_i*(sy-ay) + e_i(anchor); lambda_i = e_i / sum(e)
    # (anchored evaluation keeps f32 magnitudes small — triangle_setup)
    ea = [edge[:, i, 0][t] for i in range(3)]  # (N,) each
    eb = [edge[:, i, 1][t] for i in range(3)]
    ec = [edge[:, i, 2][t] for i in range(3)]
    dx = sx - setup["anchor"][:, 0][t]
    dy = sy - setup["anchor"][:, 1][t]
    e = [ea[i] * dx + eb[i] * dy + ec[i] for i in range(3)]
    esum = e[0] + e[1] + e[2]
    esum = jnp.where(jnp.abs(esum) < 1e-30, 1e-30, esum)
    inv_esum = 1.0 / esum
    lam = [ei * inv_esum for ei in e]

    # analytic derivative of lambda for texture LOD
    asum = ea[0] + ea[1] + ea[2]
    bsum = eb[0] + eb[1] + eb[2]
    dlam_dx = [(ea[i] - lam[i] * asum) * inv_esum for i in range(3)]
    dlam_dy = [(eb[i] - lam[i] * bsum) * inv_esum for i in range(3)]

    i0 = indices[t, 0]
    i1 = indices[t, 1]
    i2 = indices[t, 2]

    def interp(attr, c):
        a = attr[:, c]
        return lam[0] * a[i0] + lam[1] * a[i1] + lam[2] * a[i2]

    def d_interp(attr, c, dlam):
        a = attr[:, c]
        return dlam[0] * a[i0] + dlam[1] * a[i1] + dlam[2] * a[i2]

    wp = tuple(interp(world_pos, c) for c in range(3))
    nr = tuple(interp(world_normal, c) for c in range(3))
    tg = tuple(interp(world_tangent, c) for c in range(4))
    uv = tuple(interp(uvs, c) for c in range(2))
    duvdx = tuple(d_interp(uvs, c, dlam_dx) for c in range(2))
    duvdy = tuple(d_interp(uvs, c, dlam_dy) for c in range(2))

    material = tri_material[t]  # (N,)
    base_factor = tuple(mat_base_color[:, c][material] for c in range(4))
    metal_factor = mat_metallic_roughness[:, 0][material]
    rough_factor = mat_metallic_roughness[:, 1][material]
    normal_scale = mat_normal_scale[material]
    tex_base = mat_textures[:, 0][material]
    tex_mr = mat_textures[:, 1][material]
    tex_norm = mat_textures[:, 2][material]

    base_s = sample_texture_cf(texture_pool, tex_base, uv, duvdx, duvdy)
    mr_s = sample_texture_cf(texture_pool, tex_mr, uv, duvdx, duvdy)
    nrm_s = sample_texture_cf(texture_pool, tex_norm, uv, duvdx, duvdy)

    base_rgba = tuple(base_factor[c] * base_s[c] for c in range(4))
    # metallic = factor.x * texel.b, roughness = factor.y * texel.g
    metallic = metal_factor * mr_s[2]
    roughness = rough_factor * mr_s[1]

    # per-fragment TBN (fragment.glsl:59-66)
    n = _rnorm(*nr)
    tang = _rnorm(tg[0], tg[1], tg[2])
    bx = n[1] * tang[2] - n[2] * tang[1]
    by = n[2] * tang[0] - n[0] * tang[2]
    bz = n[0] * tang[1] - n[1] * tang[0]
    bxn, byn, bzn = _rnorm(bx, by, bz)
    handed = tg[3]
    bit = (bxn * handed, byn * handed, bzn * handed)

    snx = (2.0 * nrm_s[0] - 1.0) * normal_scale
    sny = (2.0 * nrm_s[1] - 1.0) * normal_scale
    snz = 2.0 * nrm_s[2] - 1.0
    normal = _rnorm(
        tang[0] * snx + bit[0] * sny + n[0] * snz,
        tang[1] * snx + bit[1] * sny + n[1] * snz,
        tang[2] * snx + bit[2] * sny + n[2] * snz,
    )

    view = _rnorm(
        camera_position[0] - wp[0],
        camera_position[1] - wp[1],
        camera_position[2] - wp[2],
    )

    radiance = shade_lights_cf(
        wp, normal, view, base_rgba[:3], metallic, roughness, lights
    )
    # effective alpha by glTF alphaMode: OPAQUE -> 1, MASK -> step(cutoff),
    # BLEND -> textured alpha. This single-layer backend blends only against
    # the clear color (no depth peeling — use the pallas backend for correct
    # surface-behind-surface translucency).
    amode = mat_alpha[:, 0][t]
    acut = mat_alpha[:, 1][t]
    a = base_rgba[3]
    alpha = jnp.where(
        amode == 0.0,
        1.0,
        jnp.where(amode == 1.0, (a >= acut).astype(jnp.float32), a),
    )

    # blend srcAlpha/(1-srcAlpha) over the clear color, background passthrough
    out = []
    for c in range(3):
        rgb = radiance[c] * alpha + background_rgba[c] * (1.0 - alpha)
        out.append(jnp.where(covered, rgb, background_rgba[c]))
    out.append(jnp.where(covered, 1.0, background_rgba[3]))
    return jnp.stack(out, axis=0)  # (4, N)
