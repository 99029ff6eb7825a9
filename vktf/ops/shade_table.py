"""Shade-table deferred shading: one wide row-gather per sample.

Instead of ~20 independent per-sample gathers (triangle indices, three
vertex attributes each, material factors, texture ids), ALL per-triangle
shading inputs are packed once per frame into a (T, 2*ROW) table —
attribute PLANE equations (perspective-correct: A(s) = P_A.s / W(s),
P_A = sum_i cof_i * A_i) plus material constants and packed-texture
metadata — and each covered sample fetches its entire shading context with
ONE row gather. Texturing then costs two more row gathers into the
block-packed material pool (ops.texture_pack): one per mip level, covering
the 2x2 bilinear footprint of base+MR+normal at once.

Math parity: identical BRDF/TBN/light formulas as ops.shade_cf (which cites
the reference fragment shader line by line); sRGB decode is the exact EOTF
evaluated arithmetically instead of via LUT gathers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vktf.ops.shade_cf import _rnorm, shade_lights_cf
from vktf.ops.texture_pack import WRAP_CLAMP, WRAP_REPEAT

ROW = 64  # f32 lanes per triangle row

# column layout
_C_WPLANE = 0  # 3
_C_UV = 3  # u plane 3, v plane 3
_C_WPOS = 9  # 9
_C_NRM = 18  # 9
_C_TAN = 27  # 12
_C_BASE = 39  # 4
_C_MR = 43  # 2 (metallic, roughness)
_C_NSCALE = 45
_C_MROW = 46  # material base row
_C_MW0 = 47  # level-0 width (pow2 square)
_C_MLEVELS = 48
_C_SAMP0 = 49  # per-slot packed sampler codes (base, mr, normal):
#                wrap_u | wrap_v<<2 | magN<<4 | minN<<5 | mipN<<6
#                (texture_pack.sampler_code; material.cppm:138-171 parity)
_C_AMODE = 52  # alpha mode: 0 OPAQUE, 1 MASK, 2 BLEND
_C_ACUT = 53  # MASK alpha cutoff
_C_AX = 54  # plane anchor x (bbox corner; all plane constants live there)
_C_AY = 55  # plane anchor y


def build_shade_table(setup, scene, inst_matrix=None) -> jnp.ndarray:
    """Per-frame shade table, packed as (T, 2*ROW) uint16 (f32 hi|lo halves).

    Built COMPONENT-MAJOR from tables precomputed at flatten time
    (scene.tri_corner object-space corner attrs, scene.tri_static_cols
    material columns): the only per-frame gather is ONE (T,16) row gather of
    instance matrices, reused from the setup ("mrows") when prepare already
    made it. Takes either setup form: the dict of triangle_setup(_cm)
    ((T,3,3) "edge", (T,2) "anchor") or the packed rows of
    raster_pallas.pack_tri_rows ((9,T) "edge9", (2,T) "anchor2").

    Each f32 column is stored as two u16 halves (hi | lo); the gather in
    gather_table_f32 reconstructs the f32 bits exactly.
    """
    tc = scene.tri_corner  # (36,T) f32, row = attr_base + channel*3 + corner
    if "edge9" in setup:
        e9, anc = setup["edge9"], setup["anchor2"]
        # e[i][k], coefficient k of corner i, as flat (T,) vectors
        e = [[e9[i * 3 + k] for k in range(3)] for i in range(3)]
        anchor = (anc[0], anc[1])
    else:
        edge = setup["edge"]  # (T,3,3) cofactor rows
        e = [[edge[:, i, k] for k in range(3)] for i in range(3)]
        anchor = (setup["anchor"][:, 0], setup["anchor"][:, 1])
    t = tc.shape[1]

    # instance matrix components as flat (T,) vectors (one row gather)
    mrows = setup.get("mrows")
    if mrows is None:
        mrows = inst_matrix.reshape(-1, 16)[scene.tri_instance]  # (T,16)
    m = [[mrows[:, r * 4 + c] for c in range(4)] for r in range(4)]

    def world_corner(base, translate):
        """Rotate (+translate) the 3 object-space corners of a vec3 attr.

        Returns per-channel lists of 3 corner (T,) vectors."""
        out = []
        for c in range(3):
            row = []
            for i in range(3):
                v = (m[c][0] * tc[base + 0 + i] + m[c][1] * tc[base + 3 + i]
                     + m[c][2] * tc[base + 6 + i])
                if translate:
                    v = v + m[c][3]
                row.append(v)
            out.append(row)
        return out

    wp = world_corner(6, translate=True)
    wn = world_corner(15, translate=False)
    wt = world_corner(24, translate=False)
    wt.append([tc[24 + 9 + i] for i in range(3)])  # tangent w passes through
    uv = [[tc[c * 3 + i] for i in range(3)] for c in range(2)]

    cols: list[jnp.ndarray] = []
    # w plane: sum over corners per coefficient
    for k in range(3):
        cols.append(e[0][k] + e[1][k] + e[2][k])
    # attribute planes: plane[channel, coeff] = sum_i e[i][coeff] * attr_i[ch]
    for corners in (uv, wp, wn, wt):
        for corner in corners:
            for k in range(3):
                cols.append(e[0][k] * corner[0] + e[1][k] * corner[1]
                            + e[2][k] * corner[2])
    # static material columns, precomputed at flatten
    for c in range(scene.tri_static_cols.shape[0]):
        cols.append(scene.tri_static_cols[c])
    # plane anchor (bbox corner): sampling evaluates planes with (s - anchor)
    cols += list(anchor)

    zero = jnp.zeros((t,), jnp.float32)
    while len(cols) < ROW:
        cols.append(zero)
    table_f32 = jnp.stack(cols, axis=0).T  # (T, ROW) f32, one transpose
    bits = jax.lax.bitcast_convert_type(table_f32, jnp.uint32)
    hi = (bits >> 16).astype(jnp.uint16)
    lo = (bits & 0xFFFF).astype(jnp.uint16)
    return jnp.concatenate([hi, lo], axis=1)  # (T, 2*ROW) u16


def gather_rows(table2d, row_idx):
    """(N,) row indices -> (N, W) row gather.

    MUST be plain 2-D advanced indexing: this lowers to XLA's vectorized
    row-gather; an explicit lax.gather with slice_sizes from a flat array
    lowers to a scalar slice loop instead."""
    return table2d[row_idx]


def gather_table_f32(table_u16, row_idx):
    """Gather (N, ROW) f32 rows from the u16 hi|lo packed table (bit-exact)."""
    rows = table_u16[row_idx]  # (N, 2*ROW) u16
    hi = rows[:, :ROW].astype(jnp.uint32) << 16
    lo = rows[:, ROW:].astype(jnp.uint32)
    return jax.lax.bitcast_convert_type(hi | lo, jnp.float32)


def _srgb_to_linear(c):
    """Exact sRGB EOTF (matches the build-time LUT of ops.texture)."""
    return jnp.where(c <= 0.04045, c / 12.92, jnp.power((c + 0.055) / 1.055, 2.4))


def _wrap_coord(i, size, mode):
    """Integer wrap; i/size int32 vectors, mode f32 code vector.

    size is ALWAYS a power of two (texture_pack pads chains to pow2 square),
    so the mod-reductions are bit masks — identical to jnp.remainder for
    every i incl. negatives (two's-complement AND == floor-mod for pow2)."""
    size = jnp.maximum(size, 1)
    repeat = i & (size - 1)
    clamp = jnp.clip(i, 0, size - 1)
    m = i & (2 * size - 1)
    mirror = jnp.where(m >= size, 2 * size - 1 - m, m)
    return jnp.where(
        mode == float(WRAP_REPEAT),
        repeat,
        jnp.where(mode == float(WRAP_CLAMP), clamp, mirror),
    )


def _anchored_attrs(col, sx, sy):
    """Anchored plane evaluation helpers from a table-row accessor.

    col(c) returns the c-th table column as a vector of any shape, so every
    shading expression below is written once for all callers."""
    sxa = sx - col(_C_AX)
    sya = sy - col(_C_AY)
    w = col(0) * sxa + col(1) * sya + col(2)
    inv_w = 1.0 / jnp.where(jnp.abs(w) < 1e-30, 1e-30, w)

    def attr(c0):
        return (col(c0) * sxa + col(c0 + 1) * sya + col(c0 + 2)) * inv_w

    return inv_w, attr


def _texture_params(col, sx, sy, max_anisotropy, slot: int = 0,
                    tap_shift=None):
    """uv + mip-selection parameters (the sampler's LOD stage) for one
    texture slot.

    The uv/derivative/LOD geometry is slot-independent (all three material
    textures share the chain size and the footprint) and CSEs across slots;
    the wrap modes and nearest/mip snapping come from the SLOT's packed
    sampler code (_C_SAMP0+slot), so each combined image-sampler behaves
    per its own sampler exactly as in the reference (material.cppm:138-171).

    ``tap_shift`` (a static float in [-0.5, 0.5], or None): TRUE multi-tap
    anisotropic filtering — offset the sample position along the MAJOR
    footprint axis in uv space by this fraction of the axis. The LOD is
    already the minor-axis ("sharpened") LOD when max_anisotropy > 1, so
    averaging taps at shifts (i+0.5)/N - 0.5 reconstructs the reference
    sampler's N-tap anisotropic footprint (model.cppm:261-275; Vulkan
    leaves the exact kernel implementation-defined). None keeps the
    single-tap approximation (and its exact bit patterns) untouched.
    """
    inv_w, attr = _anchored_attrs(col, sx, sy)
    u = attr(_C_UV)
    v = attr(_C_UV + 3)
    # analytic uv screen derivatives: dU/dx = (Pu_a - U * W_a) / W
    du_dx = (col(_C_UV) - u * col(0)) * inv_w
    du_dy = (col(_C_UV + 1) - u * col(1)) * inv_w
    dv_dx = (col(_C_UV + 3) - v * col(0)) * inv_w
    dv_dy = (col(_C_UV + 4) - v * col(1)) * inv_w

    base_row_i = col(_C_MROW).astype(jnp.int32)
    w0_i = col(_C_MW0).astype(jnp.int32)
    max_level = col(_C_MLEVELS) - 1.0
    max_level_i = max_level.astype(jnp.int32)
    w0f = col(_C_MW0)
    ddx2 = (du_dx * w0f) ** 2 + (dv_dx * w0f) ** 2
    ddy2 = (du_dy * w0f) ** 2 + (dv_dy * w0f) ** 2
    if tap_shift is not None:
        # shift along the major footprint axis (uv space); the axis length
        # is clamped to max_anisotropy minor-axes so taps never reach past
        # the footprint the clamped LOD accounts for
        major_x = ddx2 >= ddy2
        adu = jnp.where(major_x, du_dx, du_dy)
        adv = jnp.where(major_x, dv_dx, dv_dy)
        rho_maj = jnp.sqrt(jnp.maximum(jnp.maximum(ddx2, ddy2), 1e-24))
        rho_min = jnp.sqrt(jnp.maximum(jnp.minimum(ddx2, ddy2), 1e-24))
        scale = jnp.minimum(1.0, max_anisotropy * rho_min / rho_maj)
        u = u + tap_shift * scale * adu
        v = v + tap_shift * scale * adv
    rho_max2 = jnp.maximum(jnp.maximum(ddx2, ddy2), 1e-24)
    if max_anisotropy > 1.0:
        # Anisotropic filtering as LOD sharpening (single-tap approximation
        # of the reference's sampler anisotropy, model.cppm:261-275): select
        # the mip by the MINOR footprint axis, clamped so the major/minor
        # ratio never exceeds max_anisotropy.
        rho_min2 = jnp.maximum(jnp.minimum(ddx2, ddy2), 1e-24)
        limit2 = rho_min2 * (max_anisotropy * max_anisotropy)
        lod = 0.5 * jnp.log2(jnp.maximum(jnp.minimum(rho_max2, limit2), 1e-24))
    else:
        lod = 0.5 * jnp.log2(rho_max2)
    lod = jnp.clip(lod, 0.0, max_level)
    level0 = jnp.floor(lod)
    lfrac = lod - level0
    # per-slot sampler code (int ops on the f32-exact small code)
    code = col(_C_SAMP0 + slot).astype(jnp.int32)
    mip_n = (code & 64) != 0
    lfrac = jnp.where(mip_n, (lfrac >= 0.5).astype(jnp.float32), lfrac)
    is_mag = lod <= 0.0
    nearest = (is_mag & ((code & 16) != 0)) | (~is_mag & ((code & 32) != 0))
    l0 = level0.astype(jnp.int32)
    l1 = jnp.minimum(l0 + 1, max_level.astype(jnp.int32))
    return {
        "u": u, "v": v, "l0": l0, "l1": l1, "lfrac": lfrac,
        "nearest": nearest, "base_row_i": base_row_i, "w0_i": w0_i,
        "max_level_i": max_level_i,
        "wrap_u": (code & 3).astype(jnp.float32),
        "wrap_v": ((code >> 2) & 3).astype(jnp.float32),
    }


def _level_addr(tp, level_i):
    """Pool BLOCK-row index + bilinear fractions + in-block case for one mip
    level (texture_pack.py stride-2 fused-mip 3x3 block layout; this
    function addresses ONE level's slot-A window — the classic two-gather
    form).

    The 2x2 footprint with wrapped corner (x0, y0) lies inside block
    (x0>>1, y0>>1); (cx, cy) = (x0&1, y0&1) selects which 2x2 window of the
    3x3 slot holds the taps; one block row serves a whole 2x2 footprint.
    Returns (row, fx, fy, cx, cy, x0, y0).
    """
    w0_i = tp["w0_i"]
    wl = jnp.maximum(w0_i >> level_i, 1)
    wlf = wl.astype(jnp.float32)
    x = tp["u"] * wlf - 0.5
    y = tp["v"] * wlf - 0.5
    x0f = jnp.floor(x)
    y0f = jnp.floor(y)
    fx = x - x0f
    fy = y - y0f
    nearest = tp["nearest"]
    fx = jnp.where(nearest, (fx >= 0.5).astype(jnp.float32), fx)
    fy = jnp.where(nearest, (fy >= 0.5).astype(jnp.float32), fy)
    x0 = _wrap_coord(x0f.astype(jnp.int32), wl, tp["wrap_u"])
    y0 = _wrap_coord(y0f.astype(jnp.int32), wl, tp["wrap_v"])
    # closed-form BLOCK level offset for pow2-square chains
    # (texture_pack.block_level_offset): geometric sum of max(w0>>(l+1),1)^2
    # with a +1 for the final 1x1 level repeating a single-block grid
    b0 = jnp.maximum(w0_i >> 1, 1)
    bl = jnp.maximum(b0 >> level_i, 1)
    n_last = tp["max_level_i"]
    extra = ((level_i == n_last) & (n_last > 0)).astype(jnp.int32)
    offset = 4 * (b0 * b0 - bl * bl) // 3 + extra
    bw = jnp.maximum(w0_i >> (level_i + 1), 1)
    row = tp["base_row_i"] + offset + (y0 >> 1) * bw + (x0 >> 1)
    return row, fx, fy, x0 & 1, y0 & 1, x0, y0


def pool_window_addr(col, sx, sy, max_anisotropy, slot: int = 0,
                     tap_shift=None):
    """Full 2x2-window addressing per mip level for one texture slot:
    ((row, fx, fy, cx, cy, x0, y0) for l0, same for l1). tap_shift: see
    _texture_params (multi-tap anisotropy)."""
    tp = _texture_params(col, sx, sy, max_anisotropy, slot=slot,
                         tap_shift=tap_shift)
    return _level_addr(tp, tp["l0"]), _level_addr(tp, tp["l1"])


def fold_window(q, cx, cy):
    """Pre-shift a gathered 3x3-block pool slot so the sample's 2x2 bilinear
    window sits at the slot origin.

    TWO static lane rotates + TWO row-wide selects (x texel stride = 2 u16
    lanes, y stride = 6) replace a per-tap 4-way selection among the
    (cx, cy) window cases inside _filter_slot. Rolled-in
    lanes from beyond a texture's 18-lane group are never read (taps only
    touch window lanes 0..9 of each group; 9 + the max fold shift 8 = 17
    stays inside the group)."""
    qx = jnp.where((cx == 1)[:, None], jnp.roll(q, -2, axis=1), q)
    return jnp.where((cy == 1)[:, None], jnp.roll(qx, -6, axis=1), qx)


def _filter_slot(quad, slot, fx, fy, srgb):
    """One bilinear tap of ONE material texture from a FOLDED block slot.

    quad(slot, j) returns U16 lane j of the gathered pool row's slot A —
    the pool stores each 3x3 block's 27 u32 texels per slot as
    54 u16 halves (little-endian; texture_pack.build_material_pool).
    Texel t*9+i*3+j lives in u16 lanes 2*(t*9+i*3+j) (RG bytes) and +1 (BA
    bytes). The caller has already rotated the row so the sample's 2x2
    window sits at (i, j) = (0, 0) (fold_window), so every tap is a STATIC
    lane read. Returns an (r, g, b, a) channel tuple; sRGB decoded per
    texel BEFORE filtering (Vulkan rules) when srgb.
    """
    w00 = (1.0 - fx) * (1.0 - fy)
    w10 = fx * (1.0 - fy)
    w01 = (1.0 - fx) * fy
    w11 = fx * fy

    def tap_half(half, dy, dx):
        return quad(slot, 2 * (slot * 9 + dy * 3 + dx) + half)

    taps_by_half = [
        [tap_half(h, 0, 0), tap_half(h, 0, 1), tap_half(h, 1, 0),
         tap_half(h, 1, 1)]
        for h in range(2)
    ]

    def chan(shift, decode):
        # u8 channel -> f32 via int32 (values 0..255, exact). Channels 0/8
        # live in the low u16 half, 16/24 in the high.
        taps = taps_by_half[shift // 16]
        sh = shift % 16
        vals = [
            ((tp >> sh) & 0xFF).astype(jnp.int32).astype(jnp.float32)
            / 255.0
            for tp in taps
        ]
        if decode:  # sRGB decodes per texel BEFORE filtering (Vulkan rules)
            vals = [_srgb_to_linear(vv) for vv in vals]
        return vals[0] * w00 + vals[1] * w10 + vals[2] * w01 + vals[3] * w11

    return (chan(0, srgb), chan(8, srgb), chan(16, srgb), chan(24, False))


def fragment_brdf_alpha(base_tex, mr_tex, nrm_tex, base_f, mr_f,
                        normal_scale, wp, nr, tg, amode, acut, cam3, lights,
                        covered):
    """The fragment shader body AFTER texturing: factor application, TBN +
    normal mapping (fragment.glsl:59-73), BRDF light loop, and glTF
    alphaMode resolution. Inputs are plain vectors of any shape."""
    base_rgba = tuple(base_f[c] * base_tex[c] for c in range(4))
    metallic = mr_f[0] * mr_tex[2]
    roughness = mr_f[1] * mr_tex[1]

    # ---- TBN + normal mapping (fragment.glsl:59-73) -------------------------
    n = _rnorm(*nr)
    tang = _rnorm(tg[0], tg[1], tg[2])
    bx = n[1] * tang[2] - n[2] * tang[1]
    by = n[2] * tang[0] - n[0] * tang[2]
    bz = n[0] * tang[1] - n[1] * tang[0]
    bxn, byn, bzn = _rnorm(bx, by, bz)
    handed = tg[3]
    bit = (bxn * handed, byn * handed, bzn * handed)
    snx = (2.0 * nrm_tex[0] - 1.0) * normal_scale
    sny = (2.0 * nrm_tex[1] - 1.0) * normal_scale
    snz = 2.0 * nrm_tex[2] - 1.0
    normal = _rnorm(
        tang[0] * snx + bit[0] * sny + n[0] * snz,
        tang[1] * snx + bit[1] * sny + n[1] * snz,
        tang[2] * snx + bit[2] * sny + n[2] * snz,
    )

    view = _rnorm(cam3[0] - wp[0], cam3[1] - wp[1], cam3[2] - wp[2])
    radiance = shade_lights_cf(wp, normal, view, base_rgba[:3], metallic,
                               roughness, lights)

    # effective alpha by glTF alphaMode: OPAQUE -> 1, MASK -> step(cutoff),
    # BLEND -> textured alpha; uncovered samples contribute nothing
    a = base_rgba[3]
    alpha = jnp.where(
        amode == 0.0,
        1.0,
        jnp.where(amode == 1.0, (a >= acut).astype(jnp.float32), a),
    )
    alpha = jnp.where(covered, alpha, jnp.zeros_like(alpha))
    return radiance, alpha


def _fragment_from_slot_tex(col, sx, sy, slot_tex, cam3, lights, covered):
    """The fragment body after texture sampling: interpolated world
    attrs + BRDF (shared by the single-tap and multi-tap paths)."""
    base_tex, mr_tex, nrm_tex = slot_tex
    _inv_w, attr = _anchored_attrs(col, sx, sy)
    wp = tuple(attr(_C_WPOS + 3 * c) for c in range(3))
    nr = tuple(attr(_C_NRM + 3 * c) for c in range(3))
    tg = tuple(attr(_C_TAN + 3 * c) for c in range(4))
    return fragment_brdf_alpha(
        base_tex, mr_tex, nrm_tex,
        tuple(col(_C_BASE + c) for c in range(4)),
        (col(_C_MR), col(_C_MR + 1)),
        col(_C_NSCALE), wp, nr, tg, col(_C_AMODE), col(_C_ACUT),
        cam3, lights, covered,
    )


def _slot_tex_from_quads(col, sx, sy, quad0, quad1, max_anisotropy,
                         tap_shift=None):
    """Trilinear-filter the three texture slots from (slot, lane) quad
    accessors at one (possibly tap-shifted) sample position. Returns
    [base_tex, mr_tex, nrm_tex], each a channel tuple — the sampling half
    of the fragment body, shared by the single-tap path and the multi-tap
    anisotropy loop."""
    slot_tex = []
    for slot, srgb in ((0, True), (1, False), (2, False)):
        tp = _texture_params(col, sx, sy, max_anisotropy, slot=slot,
                             tap_shift=tap_shift)
        _r0, fx0, fy0 = _level_addr(tp, tp["l0"])[:3]
        _r1, fx1, fy1 = _level_addr(tp, tp["l1"])[:3]
        s0 = _filter_slot(quad0, slot, fx0, fy0, srgb)
        s1 = _filter_slot(quad1, slot, fx1, fy1, srgb)
        lfrac = tp["lfrac"]
        slot_tex.append(tuple(
            a * (1.0 - lfrac) + b * lfrac for a, b in zip(s0, s1)
        ))
    return slot_tex


def shade_gathered(col, sx, sy, quad0, quad1, cam3, lights, max_anisotropy,
                   covered):
    """Everything after the table + pool gathers (the fragment shader body).

    col is a table-column accessor (see _anchored_attrs); quad0/quad1 are
    (slot, lane) accessors over the gathered AND fold_window-rotated pool
    rows for mip level l0/l1 — the caller decides whether the three slots
    share one gathered row (identical samplers) or have their own (mixed
    samplers). cam3 is a 3-tuple of camera-position scalars. Returns
    (rgb 3-tuple, alpha) of vectors shaped like col's outputs."""
    slot_tex = _slot_tex_from_quads(col, sx, sy, quad0, quad1,
                                    max_anisotropy)
    return _fragment_from_slot_tex(col, sx, sy, slot_tex, cam3, lights,
                                   covered)


def _slot_tex_at_tap(col, sx, sy, quad_pool, max_anisotropy,
                     per_slot_samplers, tap_shift):
    """Gather + trilinear-filter the three texture slots for ONE
    anisotropic tap (its own pool gathers at the shifted uv). Returns
    [base_tex, mr_tex, nrm_tex], each a channel tuple."""
    def fold(a):
        return fold_window(gather_rows(quad_pool, a[0]), a[3], a[4])

    if per_slot_samplers:
        pairs = [pool_window_addr(col, sx, sy, max_anisotropy, slot=slot,
                                  tap_shift=tap_shift) for slot in range(3)]
        quads = [(fold(a0), fold(a1)) for a0, a1 in pairs]
    else:
        a0, a1 = pool_window_addr(col, sx, sy, max_anisotropy, slot=0,
                                  tap_shift=tap_shift)
        quads = [(fold(a0), fold(a1))] * 3  # one gather serves all slots

    quad0 = lambda s, k: quads[s][0][:, k]
    quad1 = lambda s, k: quads[s][1][:, k]
    return _slot_tex_from_quads(col, sx, sy, quad0, quad1, max_anisotropy,
                                tap_shift=tap_shift)


def shade_table_layer(
    tri_id,
    sx,
    sy,
    table,
    quad_pool,
    camera_position,
    lights,
    max_anisotropy: float = 1.0,
    per_slot_samplers: bool = False,
    aniso_taps: int = 1,
):
    """Shade one visibility layer; returns (rgb (3,N), alpha_eff (N,),
    covered (N,) bool).

    alpha_eff applies the glTF alphaMode semantics the reference parses but
    does not act on (gltf material alpha_mode/alpha_cutoff): OPAQUE forces
    1, MASK thresholds the textured alpha at the cutoff (0 or 1), BLEND
    passes it through for over-compositing by the caller.

    per_slot_samplers is a STATIC scene property (SceneMeta.mixed_samplers):
    when the three texture slots of every material share a sampler (the
    overwhelmingly common case) their pool block rows coincide and one
    gather per mip level serves all three textures; a scene with differing
    per-slot wrap modes needs per-slot rows (slots can land in different
    blocks at borders / outside [0,1)) — 3 gathers per level, exact
    reference semantics (material.cppm:138-171).
    """
    covered = tri_id >= 0
    t = jnp.maximum(tri_id, 0)
    row = gather_table_f32(table, t)  # (N, ROW) f32 from packed u16

    def col(c):
        return row[:, c]

    cam3 = (camera_position[0], camera_position[1], camera_position[2])
    if aniso_taps > 1:
        # TRUE multi-tap anisotropic filtering: N evenly spaced taps along
        # the major footprint axis, each with its own pool gathers at the
        # shifted uv, texture samples averaged BEFORE the BRDF (the
        # reference sampler's anisotropy, model.cppm:261-275; N static).
        shifts = [(i + 0.5) / aniso_taps - 0.5 for i in range(aniso_taps)]
        acc = None
        for f in shifts:
            st = _slot_tex_at_tap(col, sx, sy, quad_pool, max_anisotropy,
                                  per_slot_samplers, f)
            acc = st if acc is None else [
                tuple(a + b for a, b in zip(sa, sb))
                for sa, sb in zip(acc, st)
            ]
        inv = 1.0 / aniso_taps
        slot_tex = [tuple(c * inv for c in st) for st in acc]
        radiance, alpha = _fragment_from_slot_tex(
            col, sx, sy, slot_tex, cam3, lights, covered)
        return jnp.stack(radiance, axis=0), alpha, covered
    if per_slot_samplers:
        q0s, q1s = [], []
        for slot in range(3):
            a0, a1 = pool_window_addr(col, sx, sy, max_anisotropy, slot=slot)
            q0s.append(fold_window(gather_rows(quad_pool, a0[0]),
                                   a0[3], a0[4]))
            q1s.append(fold_window(gather_rows(quad_pool, a1[0]),
                                   a1[3], a1[4]))
        quad0 = lambda s, k: q0s[s][:, k]
        quad1 = lambda s, k: q1s[s][:, k]
    else:
        a0, a1 = pool_window_addr(col, sx, sy, max_anisotropy, slot=0)
        q0 = fold_window(gather_rows(quad_pool, a0[0]), a0[3], a0[4])
        q1 = fold_window(gather_rows(quad_pool, a1[0]), a1[3], a1[4])
        quad0 = lambda s, k: q0[:, k]
        quad1 = lambda s, k: q1[:, k]
    radiance, alpha = shade_gathered(
        col, sx, sy, quad0, quad1, cam3, lights, max_anisotropy, covered,
    )
    return jnp.stack(radiance, axis=0), alpha, covered
