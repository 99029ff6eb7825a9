"""Image decode + mip-chain generation for texture upload.

Bridges glTF texture sources (KTX2 via :mod:`vktf.loaders.ktx`, PNG/JPEG
via PIL) to the RGBA8 mip chains the renderer gathers from HBM. Mip levels
absent from the container are generated with a 2x2 box filter in **linear**
space (sRGB payloads are linearized, filtered, re-encoded), the software
analogue of the reference's reliance on pre-authored KTX mips
(ktx_texture.cppm:127-147).
"""

from __future__ import annotations

import dataclasses
import io
from pathlib import Path
from typing import Optional

import numpy as np

from vktf.loaders.gltf import Texture
from vktf.loaders.ktx import KtxError, KtxTexture, parse_ktx2
from vktf.log import Log, default_log


@dataclasses.dataclass
class TextureData:
    """Decoded texture ready for atlas packing."""

    levels: list[np.ndarray]  # RGBA8, level 0 first
    srgb: bool


def srgb_to_linear(srgb: np.ndarray) -> np.ndarray:
    """sRGB EOTF (float in [0,1])."""
    return np.where(srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(linear: np.ndarray) -> np.ndarray:
    linear = np.clip(linear, 0.0, 1.0)
    return np.where(
        linear <= 0.0031308, linear * 12.92, 1.055 * np.power(linear, 1.0 / 2.4) - 0.055
    )


def _halve(level: np.ndarray) -> np.ndarray:
    """2x2 box-filter downsample, edge-clamped taps, floor-sized output.

    Level n+1 dims are max(floor(dim/2), 1) — the Vulkan/glTF mip-size rule
    — and each output texel averages the (clamped) 2x2 source footprint.
    Matches native/vktf_native.cpp vktf_generate_mips exactly.
    """
    h, w = level.shape[:2]
    nh, nw = max(h // 2, 1), max(w // 2, 1)
    y0 = np.minimum(2 * np.arange(nh), h - 1)
    y1 = np.minimum(2 * np.arange(nh) + 1, h - 1)
    x0 = np.minimum(2 * np.arange(nw), w - 1)
    x1 = np.minimum(2 * np.arange(nw) + 1, w - 1)
    return 0.25 * (
        level[y0][:, x0] + level[y1][:, x0] + level[y0][:, x1] + level[y1][:, x1]
    )


def generate_mips(base: np.ndarray, srgb: bool) -> list[np.ndarray]:
    """Full mip chain from an RGBA8 base level, filtered in linear space.

    Uses the native runtime (vktf.native) when built; numpy otherwise.
    """
    from vktf import native

    native_levels = native.generate_mips(base, srgb)
    if native_levels is not None:
        return native_levels
    levels = [np.ascontiguousarray(base, np.uint8)]
    current = base.astype(np.float32) / 255.0
    if srgb:
        rgb_linear = srgb_to_linear(current[..., :3])
        current = np.concatenate([rgb_linear, current[..., 3:]], axis=-1)
    while current.shape[0] > 1 or current.shape[1] > 1:
        current = _halve(current)
        quantized = current
        if srgb:
            quantized = np.concatenate(
                [linear_to_srgb(current[..., :3]), current[..., 3:]], axis=-1
            )
        levels.append((np.clip(quantized, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8))
    return levels


_WHITE = np.full((1, 1, 4), 255, np.uint8)
_FLAT_NORMAL = np.asarray([[[128, 128, 255, 255]]], np.uint8)


def default_texture_data(kind: str) -> TextureData:
    """1x1 defaults used when a material slot has no texture: white for base
    color / metallic-roughness (factors pass through), +z for normals."""
    if kind == "normal":
        return TextureData(levels=[_FLAT_NORMAL.copy()], srgb=False)
    return TextureData(levels=[_WHITE.copy()], srgb=kind == "base_color")


def decode_texture(
    texture: Optional[Texture],
    kind: str,
    log: Optional[Log] = None,
) -> Optional[TextureData]:
    """Decode a glTF texture source to an RGBA8 mip chain.

    kind: "base_color" (sRGB), "metallic_roughness" or "normal" (linear).
    Returns None when the source is missing/undecodable — callers apply the
    reference's reject-material-and-log policy (model.cppm:368-409).
    """
    log = log or default_log()
    if texture is None:
        return None
    srgb_hint = kind == "base_color"

    blob: Optional[bytes] = None
    name = texture.name or "<texture>"
    if texture.data is not None:
        blob = texture.data
    elif texture.filepath is not None:
        name = str(texture.filepath)
        try:
            blob = Path(texture.filepath).read_bytes()
        except OSError:
            log.error(f"Failed to read texture file {name}")
            return None
    if blob is None:
        log.error(f"Texture {name} has no data source")
        return None

    if blob[:12] == b"\xabKTX 20\xbb\r\n\x1a\n":
        try:
            ktx: Optional[KtxTexture] = parse_ktx2(blob, name=name, log=log)
        except KtxError as error:
            # KtxError is the fatal tier for DIRECT load_ktx callers; for a
            # texture embedded in a scene the policy is the reference's
            # skip-with-default (model.cppm:301-321) — a malformed .ktx2
            # must not abort the whole engine.load (it previously escaped
            # through the decode thread pool's f.result() in flatten)
            log.error(f"Failed to parse KTX texture {name}: {error}")
            return None
        if ktx is None:
            return None
        levels = ktx.levels
        srgb = ktx.srgb if ktx.srgb is not None else srgb_hint
        # complete a partial mip chain
        if len(levels) == 1:
            levels = generate_mips(levels[0], srgb)
        return TextureData(levels=levels, srgb=srgb)

    # PNG/JPEG via PIL
    try:
        from PIL import Image

        with Image.open(io.BytesIO(blob)) as img:
            base = np.asarray(img.convert("RGBA"), np.uint8)
    except Exception:
        log.error(f"Failed to decode texture image {name}")
        return None
    return TextureData(levels=generate_mips(base, srgb_hint), srgb=srgb_hint)
