"""Material texel pool: block-packed, material-combined texture storage.

Classic per-texel sampling (4 taps x 2 mips x 3 textures = 24 gathers per
sample) is replaced by row gathers of pre-packed texel BLOCKS: one pool row
holds the texels every bilinear footprint in a 2x2 texel area needs, for all
three material textures at once.

This pool packs FUSED-MIP 3x3-texel BLOCKS on a stride-2 anchor grid:

  * the three textures of a material are resampled to one power-of-two
    square chain (they already match in well-authored assets; resampling is
    logged per the skip-and-log ethos);
  * each pool row of mip level l holds TWO slots covering BOTH trilinear
    levels (fused-mip layout; an earlier layout was a 4x4
    single-level block and paid a second row gather for mip l+1):
      - slot A (u32 lanes 0..26): 3x3 texels of LEVEL l anchored at even
        coords, lane t*9 + i*3 + j = texture t at texel
        (2bx + j, 2by + i) — ANY 2x2 bilinear footprint at level l lies
        inside it (its corner (x0, y0) maps to block (x0>>1, y0>>1) with
        in-block case (x0&1, y0&1), and x0&1 + 1 <= 2);
      - slot B (u32 lanes 27..53): 3x3 texels of LEVEL l+1 anchored at
        (bx-1, by-1), lane 27 + t*9 + i*3 + j = texture t at texel
        (bx-1+j, by-1+i) of level l+1 (wrapped) — for REPEAT/CLAMP wrap
        modes this covers every possible l+1 bilinear footprint of a
        sample whose l-level footprint corner lies in block (bx, by)
        (the l+1 corner is floor((a0 + f0 - 0.5)/2) in {bx-1, bx}), so
        one filtered TRILINEAR sample of ALL THREE glTF material textures
        (base color, metallic-roughness, normal — the reference's material
        descriptor set, material.cppm:138-171) costs exactly ONE row
        gather. MIRRORED_REPEAT breaks the containment (a reflection can
        displace the l+1 footprint outside the anchored window), so
        mirror-wrap scenes take the classic two-gather path (slot A alone
        serves any wrap mode at any single level) — MaterialPool.mirror
        is the static scene flag, like .mixed for per-slot samplers.
      The last level's slot B is zero (never read: l1 == l0 there and the
      sampler reuses slot A). Out-of-range texels are wrap-mode-correct,
      baked at build time. 54 u32 lanes used, padded to 64;
  * pow-of-two square chains make the per-level block-row offset a closed
    form (offset(l) = 4*(b0^2 - max(b0>>l,1)^2)/3 + [l == last && last>0],
    b0 = max(w0>>1, 1)), so no per-sample level-offset lookup table is
    needed — everything a sample needs is computable from scalars baked
    per-triangle into the shade table (ops.shade_table). Row count is
    texels/4.

Storage is a (P, 64) u32 array, held as (P, 128) u16 halves, fetched with
one vectorized 2-D row gather per mip level (explicit lax.gather with
slice_sizes lowers to a scalar loop instead). Texel duplication is 4x (16
texels per 4 anchor positions). The XLA shade reads slot A of the l0 and
l1 rows (two gathers); slot B is carried for a single-gather trilinear
form (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax.numpy as jnp

from vktf.loaders.images import TextureData, default_texture_data
from vktf.log import Log, default_log

SLOT_U32 = 27  # 3 textures x 9 texels per slot (3x3 window)
BLOCK_U32 = 2 * SLOT_U32  # slot A (level l) + slot B (level l+1)
ROW_U32 = 64  # padded row width (pow2)

WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR = 0, 1, 2
_WRAP_CODES = {"repeat": WRAP_REPEAT, "clamp_to_edge": WRAP_CLAMP, "mirrored_repeat": WRAP_MIRROR}


@dataclasses.dataclass
class MaterialPool:
    """Per-material block-packed texel rows + per-material scalar metadata."""

    quads: jnp.ndarray  # (P, ROW_U32) uint32 — 2-D for fast row gathers
    # per-material scalars (baked into the shade table per triangle):
    base_row: np.ndarray  # (M,) int64 — first BLOCK row index of the chain
    width0: np.ndarray  # (M,) int32 — level-0 width (= height; pow2 square)
    num_levels: np.ndarray  # (M,) int32
    # PER-SLOT packed sampler codes (base/mr/normal — the reference binds an
    # independent sampler per combined image-sampler, material.cppm:138-171):
    # code = wrap_u | wrap_v<<2 | mag_nearest<<4 | min_nearest<<5
    #        | mip_nearest<<6  (exact in f32 shade-table columns)
    sampler_codes: np.ndarray  # (M, 3) int32
    mixed: bool  # True when any material's three slots differ
    # True when any sampler uses MIRRORED_REPEAT on either axis: the fused
    # single-gather trilinear path is exact only for repeat/clamp (module
    # docstring), so mirror scenes route to the classic two-gather path
    mirror: bool = False


def sampler_code(sampler: dict) -> int:
    """Pack one glTF sampler into the 7-bit shade-table code."""
    wrap_u = _WRAP_CODES.get(sampler.get("wrap_u", "repeat"), WRAP_REPEAT)
    wrap_v = _WRAP_CODES.get(sampler.get("wrap_v", "repeat"), WRAP_REPEAT)
    return (
        wrap_u
        | (wrap_v << 2)
        | (int(sampler.get("mag_filter", "linear") == "nearest") << 4)
        | (int(sampler.get("min_filter", "linear") == "nearest") << 5)
        | (int(sampler.get("mipmap_mode", "linear") == "nearest") << 6)
    )


def _wrap_index(i: np.ndarray, size: int, mode: int) -> np.ndarray:
    """Wrap texel indices (possibly >= size) under the sampler mode."""
    if mode == WRAP_REPEAT:
        return i % size
    if mode == WRAP_CLAMP:
        return np.clip(i, 0, size - 1)
    # mirrored repeat: reflect at the boundary
    m = i % max(2 * size, 1)
    return np.where(m >= size, 2 * size - 1 - m, m)


def _pack_u32(level: np.ndarray) -> np.ndarray:
    return (
        level[..., 0].astype(np.uint32)
        | (level[..., 1].astype(np.uint32) << 8)
        | (level[..., 2].astype(np.uint32) << 16)
        | (level[..., 3].astype(np.uint32) << 24)
    )


def _resample_nearest(img: np.ndarray, size: int) -> np.ndarray:
    h, w = img.shape[:2]
    ys = (np.arange(size) * h // size).clip(0, h - 1)
    xs = (np.arange(size) * w // size).clip(0, w - 1)
    return img[ys][:, xs]


def _to_pow2_square_chain(tex: TextureData, size: int) -> list[np.ndarray]:
    """Return a full mip chain of pow2-square levels of the given size."""
    from vktf.loaders.images import generate_mips

    base = tex.levels[0]
    if base.shape[0] == size and base.shape[1] == size:
        if len(tex.levels) >= int(np.log2(size)) + 1:
            ok = all(
                lvl.shape[0] == lvl.shape[1] == max(size >> i, 1)
                for i, lvl in enumerate(tex.levels)
            )
            if ok:
                return tex.levels
        return generate_mips(base, tex.srgb)
    return generate_mips(_resample_nearest(base, size), tex.srgb)


def blocks_per_level(w0: int, level: int) -> int:
    """Block-grid width of a mip level (stride-2 anchors)."""
    return max(w0 >> (level + 1), 1)


def block_level_offset(w0: int, level: int) -> int:
    """Closed-form BLOCK-row offset of a mip level in a pow2-square chain.

    For levels l of a width-w0 chain, the block grid is max(w0>>(l+1),1)
    square; the geometric sum collapses except the final 1x1 level, which
    repeats the previous level's single block (the +1 term).
    """
    b0 = max(w0 >> 1, 1)
    bl = max(b0 >> level, 1)
    n = int(np.log2(max(w0, 1)))  # last level index
    extra = 1 if (level == n and n > 0) else 0
    return 4 * (b0 * b0 - bl * bl) // 3 + extra


def _chain_block_rows(size: int) -> int:
    levels = int(np.log2(max(size, 1))) + 1
    return block_level_offset(size, levels - 1) + blocks_per_level(size, levels - 1) ** 2


def _pack_blocks_level_np(packed: list[np.ndarray], w: int,
                          wraps: list[tuple[int, int]],
                          packed_next: list[np.ndarray] | None) -> np.ndarray:
    """(bw*bw, ROW_U32) fused-mip block rows for one level (numpy fallback).

    packed: level-l texel arrays (slot A source); packed_next: level-(l+1)
    arrays (slot B source), or None for the last level (slot B stays zero —
    the sampler reuses slot A there, module docstring). wraps: per-slot
    (wrap_u, wrap_v) — each texture's out-of-range block texels bake with
    ITS OWN sampler's wrap mode.
    """
    bw = max(w >> 1, 1)
    out = np.zeros((bw, bw, ROW_U32), np.uint32)
    ax = 2 * np.arange(bw)
    bx = np.arange(bw)
    w1 = max(w >> 1, 1)
    for t, lvl in enumerate(packed):
        wrap_u, wrap_v = wraps[t]
        for i in range(3):
            ty = _wrap_index(ax + i, w, wrap_v)  # (bw,)
            for j in range(3):
                tx = _wrap_index(ax + j, w, wrap_u)
                out[:, :, t * 9 + i * 3 + j] = lvl[ty][:, tx]
        if packed_next is not None:
            nxt = packed_next[t]
            for i in range(3):
                ny = _wrap_index(bx - 1 + i, w1, wrap_v)
                for j in range(3):
                    nx = _wrap_index(bx - 1 + j, w1, wrap_u)
                    out[:, :, SLOT_U32 + t * 9 + i * 3 + j] = nxt[ny][:, nx]
    return out.reshape(-1, ROW_U32)


def build_material_pool(
    materials: list[dict],
    log: Log | None = None,
    max_pool_bytes: int = 4 << 30,
) -> MaterialPool:
    """Pack per-material texture triplets.

    `materials`: list of dicts with keys
      base/mr/normal: Optional[TextureData]
      samplers: list of THREE sampler dicts (base, mr, normal), each with
        wrap_u/wrap_v/mag_filter/min_filter/mipmap_mode — or the legacy
        single `sampler` dict applied to all three slots.

    max_pool_bytes bounds the packed pool's device-memory footprint (the pool
    inflates raw RGBA ~5.3x: 4x anchor duplication x 64->128 lane pad / 3
    textures per row). When the projected size exceeds the budget — or the
    2^24 block-row ceiling above which f32 row addresses lose exactness —
    the LARGEST texture chains are halved until it fits, with a logged
    error per the skip-and-log ethos (the reference analogously clamps to
    device limits, e.g. MSAA/anisotropy probes engine.cppm:157-199). A
    blurrier texture is strictly better than a failed load.
    """
    log = log or default_log()
    if not materials:
        materials = [{"base": None, "mr": None, "normal": None, "sampler": {}}]
    count = len(materials)
    base_row = np.zeros(count, np.int64)
    width0 = np.ones(count, np.int32)
    num_levels = np.ones(count, np.int32)
    codes = np.zeros((count, 3), np.int32)
    mixed = False
    mirror = False

    # pre-pass: pick each material's pow2-square chain size
    sizes_m = np.ones(count, np.int64)
    for m, spec in enumerate(materials):
        base = spec.get("base") or default_texture_data("base_color")
        mr = spec.get("mr") or default_texture_data("metallic_roughness")
        normal = spec.get("normal") or default_texture_data("normal")
        sizes = {t.levels[0].shape[0] for t in (base, mr, normal)} | {
            t.levels[0].shape[1] for t in (base, mr, normal)
        }
        size = 1 << int(np.ceil(np.log2(max(sizes))))
        if len(sizes) > 1 or size != max(sizes):
            log.error(
                f"Material {m}: textures resampled to {size}x{size} pow2 square "
                f"for the packed pool (sizes {sorted(sizes)})"
            )
        sizes_m[m] = size

    # budget clamp: halve the largest chains until the pool fits the byte
    # budget and the f32-exact row ceiling
    max_rows = min((1 << 24) - 1, max_pool_bytes // (4 * ROW_U32))
    orig_sizes = sizes_m.copy()
    while sum(_chain_block_rows(int(s)) for s in sizes_m) > max_rows and (
        sizes_m.max() > 1
    ):
        top = sizes_m.max()
        sizes_m[sizes_m == top] = top >> 1
    if not np.array_equal(orig_sizes, sizes_m):
        shrunk = int((orig_sizes != sizes_m).sum())
        log.error(
            f"Material pool over budget ({max_pool_bytes >> 20} MiB / "
            f"{max_rows} block rows): downsampled {shrunk} of {count} "
            f"material chains (largest now {int(sizes_m.max())}px, was "
            f"{int(orig_sizes.max())}px)"
        )

    blobs: list[np.ndarray] = []
    row_cursor = 0
    for m, spec in enumerate(materials):
        base = spec.get("base") or default_texture_data("base_color")
        mr = spec.get("mr") or default_texture_data("metallic_roughness")
        normal = spec.get("normal") or default_texture_data("normal")
        samplers = spec.get("samplers")
        if samplers is None:
            samplers = [spec.get("sampler") or {}] * 3

        size = int(sizes_m[m])
        chains = [
            _to_pow2_square_chain(base, size),
            _to_pow2_square_chain(mr, size),
            _to_pow2_square_chain(normal, size),
        ]
        levels = len(chains[0])
        wraps = [
            (
                _WRAP_CODES.get(s.get("wrap_u", "repeat"), WRAP_REPEAT),
                _WRAP_CODES.get(s.get("wrap_v", "repeat"), WRAP_REPEAT),
            )
            for s in samplers
        ]

        base_row[m] = row_cursor
        width0[m] = size
        num_levels[m] = levels
        codes[m] = [sampler_code(s) for s in samplers]
        if codes[m, 0] != codes[m, 1] or codes[m, 0] != codes[m, 2]:
            mixed = True
        if any(WRAP_MIRROR in wu_wv for wu_wv in wraps):
            mirror = True

        from vktf import native

        packed_levels = [
            [_pack_u32(chain[l]) for chain in chains] for l in range(levels)
        ]
        for l in range(levels):
            w = max(size >> l, 1)
            packed = packed_levels[l]
            packed_next = packed_levels[l + 1] if l + 1 < levels else None
            rows_native = native.pack_blocks_level(packed, packed_next,
                                                   wraps)
            if rows_native is not None:
                blobs.append(rows_native)
            else:
                blobs.append(_pack_blocks_level_np(packed, w, wraps,
                                                   packed_next))
            row_cursor += max(w >> 1, 1) ** 2

    rows = np.concatenate(blobs) if blobs else np.zeros((1, ROW_U32), np.uint32)
    # pool row indices ride f32 shade-table columns; past 2^24 they stop
    # being exact and texel addressing silently corrupts
    if rows.shape[0] >= 1 << 24:
        raise ValueError(
            f"material pool has {rows.shape[0]} block rows (>= 2^24); texel "
            "addresses would lose f32 exactness — reduce texture sizes"
        )
    # Store the pool as a u16 VIEW of the u32 lanes (little-endian: lane k
    # = u16[2k] | u16[2k+1] << 16): identical bits; the shade reads 8-bit
    # channels straight from the u16 halves.
    rows_u16 = rows.view(np.uint16).reshape(rows.shape[0], 2 * ROW_U32)
    return MaterialPool(
        quads=jnp.asarray(rows_u16),
        base_row=base_row,
        width0=width0,
        num_levels=num_levels,
        sampler_codes=codes,
        mixed=mixed,
        mirror=mirror,
    )
