"""KTX2 texture container loading.

Re-design of the reference KTX path (src/engine/ktx_texture.cppm): where
the reference transcodes Basis-supercompressed data to a GPU block
-compressed format chosen from device caps (ktx_texture.cppm:62-94), the
software sampler reads no BC/ASTC blocks, so every input decodes on host to
RGBA8 mip-chain numpy arrays that live in device memory as gatherable
arrays (SURVEY.md §2 ktx::Texture row).

Supported: KTX2 with uncompressed vkFormats (R8/RG8/RGB8/RGBA8, UNORM/SRGB)
under supercompression none/zstd/zlib, plus Basis Universal inputs: ETC1S
slices under BasisLZ supercompression and UASTC blocks (vkFormat 0, DFD
color model 163/166) via vktf.loaders.basis — see that module's
docstring for the transcoder's scope/provenance. Unsupported payloads are
skipped with a logged error (the reference's missing-KTX skip semantics,
model.cppm:301-321).
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Optional

import numpy as np

from vktf.log import Log, default_log


class KtxError(RuntimeError):
    pass


_KTX2_IDENTIFIER = b"\xabKTX 20\xbb\r\n\x1a\n"

# VkFormat values we decode (format -> (channels, srgb))
_VK_FORMATS = {
    9: (1, False),  # R8_UNORM
    15: (1, True),  # R8_SRGB
    16: (2, False),  # R8G8_UNORM
    22: (2, True),  # R8G8_SRGB
    23: (3, False),  # R8G8B8_UNORM
    29: (3, True),  # R8G8B8_SRGB
    37: (4, False),  # R8G8B8A8_UNORM
    43: (4, True),  # R8G8B8A8_SRGB
}

SUPERCOMPRESSION_NONE = 0
SUPERCOMPRESSION_BASISLZ = 1
SUPERCOMPRESSION_ZSTD = 2
SUPERCOMPRESSION_ZLIB = 3

# Khronos Data Format descriptor constants (KDF 1.3)
KDF_MODEL_ETC1S = 163
KDF_MODEL_UASTC = 166
KDF_TRANSFER_LINEAR = 1
KDF_TRANSFER_SRGB = 2


@dataclasses.dataclass
class KtxTexture:
    """Decoded texture: RGBA8 mip chain, level 0 first."""

    levels: list[np.ndarray]  # each (H, W, 4) uint8
    srgb: bool  # whether payload is sRGB-encoded (base color) vs linear


def _expand_rgba(data: np.ndarray, channels: int) -> np.ndarray:
    """Channel-expand to RGBA8 (3/4-component preference mirrors
    ktx_texture.cppm:65-68; 1/2-component also accepted here)."""
    h, w = data.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    if channels == 1:
        out[..., 0] = out[..., 1] = out[..., 2] = data[..., 0]
        out[..., 3] = 255
    elif channels == 2:
        out[..., 0] = out[..., 1] = out[..., 2] = data[..., 0]
        out[..., 3] = data[..., 1]
    elif channels == 3:
        out[..., :3] = data
        out[..., 3] = 255
    else:
        out[:] = data
    return out


def _parse_dfd(blob: bytes, offset: int, length: int) -> tuple[int, int]:
    """Return (colorModel, transferFunction) from the Data Format Descriptor
    (KDF 1.3 basic block: colorModel at block byte 8, transfer at byte 10,
    i.e. bytes 12/14 from the DFD start after the u32 totalSize)."""
    if length >= 16 and offset + 16 <= len(blob):
        return blob[offset + 12], blob[offset + 14]
    return 0, 0


def _decompress_level(payload: bytes, scheme: int, uncompressed_length: int,
                      expected_length: Optional[int] = None):
    """Undo zstd/zlib level supercompression (shared by all payload kinds).

    Corrupt/truncated streams surface as KtxError (the loader's fatal
    tier), not as backend-specific exceptions (zstandard.ZstdError,
    zlib.error) — pinned by the truncation fuzz in tests.

    `expected_length` bounds the HEADER-CLAIMED uncompressedByteLength
    before anything allocates: a hostile u64 (e.g. 2^62) would otherwise
    drive np.empty/max_output_size into MemoryError/OOM territory — the
    caller knows the level's true byte size from the image dimensions."""
    if (uncompressed_length and expected_length is not None
            and uncompressed_length > expected_length):
        raise KtxError(
            f"level claims {uncompressed_length} uncompressed bytes; "
            f"dimensions imply at most {expected_length}"
        )
    if scheme == SUPERCOMPRESSION_ZSTD:
        from vktf import native

        out = (
            native.decompress_zstd(payload, uncompressed_length)
            if uncompressed_length
            else None
        )
        if out is None:
            import zstandard

            try:
                out = zstandard.ZstdDecompressor().decompress(
                    payload, max_output_size=uncompressed_length or 1 << 30
                )
            except zstandard.ZstdError as error:
                raise KtxError(f"zstd level data corrupt: {error}") from error
        return out
    if scheme == SUPERCOMPRESSION_ZLIB:
        from vktf import native

        out = (
            native.inflate_zlib(payload, uncompressed_length)
            if uncompressed_length
            else None
        )
        if out is None:
            import zlib

            try:
                out = zlib.decompress(payload)
            except zlib.error as error:
                raise KtxError(f"zlib level data corrupt: {error}") from error
        return out
    return payload


def _parse_basis(
    blob, name, width, height, level_count, scheme,
    kdf_model, kdf_transfer, sgd_offset, sgd_length, log,
) -> Optional[KtxTexture]:
    """Transcode Basis Universal payloads (ETC1S/BasisLZ or UASTC) to RGBA8
    via vktf.loaders.basis (reference: libktx transcode per device caps,
    ktx_texture.cppm:62-94; the target here is always RGBA8)."""
    from vktf.loaders import basis

    srgb = kdf_transfer == KDF_TRANSFER_SRGB
    level_index_offset = 80
    levels = []
    try:
        if scheme == SUPERCOMPRESSION_BASISLZ:
            if kdf_model not in (KDF_MODEL_ETC1S, 0):
                log.error(
                    f"Failed to load KTX texture {name}: BasisLZ with DFD "
                    f"model {kdf_model} unsupported"
                )
                return None
            sgd = blob[sgd_offset : sgd_offset + sgd_length]
            gd = basis.parse_basis_lz_global_data(sgd, level_count)
            for level in range(level_count):
                offset, byte_length, _un = struct.unpack_from(
                    "<3Q", blob, level_index_offset + 24 * level
                )
                payload = blob[offset : offset + byte_length]
                desc = gd.images[level]
                sl = payload[desc["rgb_offset"] : desc["rgb_offset"] + desc["rgb_length"]]
                levels.append(
                    basis.decode_etc1s_slice(
                        sl, max(width >> level, 1), max(height >> level, 1), gd
                    )
                )
        elif kdf_model == KDF_MODEL_UASTC:
            for level in range(level_count):
                offset, byte_length, uncompressed = struct.unpack_from(
                    "<3Q", blob, level_index_offset + 24 * level
                )
                lw, lh = max(width >> level, 1), max(height >> level, 1)
                payload = _decompress_level(
                    blob[offset : offset + byte_length], scheme, uncompressed,
                    expected_length=16 * ((lw + 3) // 4) * ((lh + 3) // 4),
                )
                img = basis.decode_uastc(
                    payload, max(width >> level, 1), max(height >> level, 1), log
                )
                if img is None:
                    return None
                levels.append(img)
        else:
            log.error(
                f"Failed to load KTX texture {name}: vkFormat 0 with DFD "
                f"model {kdf_model} / scheme {scheme} unsupported"
            )
            return None
    except basis.BasisError as e:
        log.error(f"Failed to transcode Basis KTX texture {name}: {e}")
        return None
    return KtxTexture(levels=levels, srgb=srgb)


def parse_ktx2(blob: bytes, name: str = "<memory>", log: Optional[Log] = None) -> Optional[KtxTexture]:
    """Parse a KTX2 blob; returns None (with logged error) for unsupported
    supercompression/formats, raises KtxError for malformed containers.

    The KtxError contract covers ARBITRARY malformed bytes (truncation
    fuzz in tests/test_textures.py): low-level parse failures from
    struct/zlib/slicing are re-raised as KtxError so callers only ever
    see the loader's two-tier policy (fatal KtxError vs skip+log)."""
    import zlib

    try:
        return _parse_ktx2_impl(blob, name, log)
    except KtxError:
        raise
    except (struct.error, ValueError, IndexError, EOFError,
            zlib.error) as error:
        raise KtxError(f"{name}: malformed KTX2 container: {error}") from error


def _parse_ktx2_impl(blob: bytes, name: str, log: Optional[Log]) -> Optional[KtxTexture]:
    log = log or default_log()
    if blob[:12] != _KTX2_IDENTIFIER:
        raise KtxError(f"{name}: not a KTX2 file")
    (
        vk_format,
        _type_size,
        width,
        height,
        depth,
        layer_count,
        face_count,
        level_count,
        scheme,
    ) = struct.unpack_from("<9I", blob, 12)
    if depth > 1 or layer_count > 1 or face_count > 1:
        log.error(f"Failed to load KTX texture {name}: arrays/cubemaps/3D unsupported")
        return None
    height = max(height, 1)
    level_count = max(level_count, 1)
    # hostile-header allocation bound: every decode path allocates
    # O(width*height*4) per level from these fields alone
    if width > 65536 or height > 65536 or width * height > 1 << 30:
        raise KtxError(
            f"{name}: implausible dimensions {width}x{height}"
        )
    if level_count > 17:  # log2(65536) + 1
        raise KtxError(f"{name}: implausible level count {level_count}")
    # index section: dfd (2 u32), kvd (2 u32), sgd (2 u64) at bytes 48..79
    dfd_offset, dfd_length, _kvd_off, _kvd_len = struct.unpack_from("<4I", blob, 48)
    sgd_offset, sgd_length = struct.unpack_from("<2Q", blob, 64)
    kdf_model, kdf_transfer = _parse_dfd(blob, dfd_offset, dfd_length)

    if vk_format == 0:  # Basis Universal payloads
        return _parse_basis(
            blob, name, width, height, level_count, scheme,
            kdf_model, kdf_transfer, sgd_offset, sgd_length, log,
        )
    if scheme == SUPERCOMPRESSION_BASISLZ:
        log.error(
            f"Failed to load KTX texture {name}: BasisLZ supercompression "
            "with a non-Basis vkFormat is malformed"
        )
        return None
    if vk_format not in _VK_FORMATS:
        log.error(f"Failed to load KTX texture {name}: unsupported vkFormat {vk_format}")
        return None
    channels, srgb = _VK_FORMATS[vk_format]

    # Level index starts at byte 48 + 2*4 + 2*4 + 2*8 = 80
    level_index_offset = 80
    levels = []
    for level in range(level_count):
        offset, byte_length, uncompressed_length = struct.unpack_from(
            "<3Q", blob, level_index_offset + 24 * level
        )
        payload = blob[offset : offset + byte_length]
        level_w = max(width >> level, 1)
        level_h = max(height >> level, 1)
        if scheme in (SUPERCOMPRESSION_ZSTD, SUPERCOMPRESSION_ZLIB):
            payload = _decompress_level(
                payload, scheme, uncompressed_length,
                expected_length=level_w * level_h * channels,
            )
        elif scheme != SUPERCOMPRESSION_NONE:
            log.error(f"Failed to load KTX texture {name}: unknown supercompression {scheme}")
            return None
        # KTX2 rows are tightly packed (mipPadding only between levels)
        expected = level_w * level_h * channels
        if len(payload) < expected:
            raise KtxError(
                f"{name} level {level}: expected {expected} bytes, got {len(payload)}"
            )
        data = np.frombuffer(payload, np.uint8, count=expected).reshape(
            level_h, level_w, channels
        )
        levels.append(_expand_rgba(data, channels))
    return KtxTexture(levels=levels, srgb=srgb)


def load_ktx(path: str | Path, log: Optional[Log] = None) -> Optional[KtxTexture]:
    """Load and decode a .ktx2 file (reference: ktx::Load, ktx_texture.cppm:34-45)."""
    path = Path(path)
    try:
        blob = path.read_bytes()
    except OSError as e:
        raise KtxError(f"failed to read KTX file {path}") from e
    return parse_ktx2(blob, name=str(path), log=log)


# ---------------------------------------------------------------------------
# Writing (fixtures/demo assets) — minimal KTX2 emitter so synthetic scenes
# exercise the real container path end to end.
# ---------------------------------------------------------------------------


def encode_ktx2(
    levels: list[np.ndarray],
    srgb: bool,
    supercompression: int = SUPERCOMPRESSION_NONE,
) -> bytes:
    """Encode an RGBA8 mip chain as KTX2 container bytes."""
    vk_format = 43 if srgb else 37  # RGBA8 SRGB/UNORM
    width, height = levels[0].shape[1], levels[0].shape[0]
    header = _KTX2_IDENTIFIER + struct.pack(
        "<9I", vk_format, 1, width, height, 0, 0, 1, len(levels), supercompression
    )
    # indices: dfd (u32 off,u32 len), kvd (u32,u32), sgd (u64,u64)
    level_index_offset = 80
    payload_offset = level_index_offset + 24 * len(levels)
    # minimal empty DFD (just total-size word)
    dfd = struct.pack("<I", 4)
    dfd_offset = payload_offset
    payload_offset += len(dfd)

    blobs = []
    for level in levels:
        raw = np.ascontiguousarray(level, np.uint8).tobytes()
        if supercompression == SUPERCOMPRESSION_ZSTD:
            import zstandard

            blobs.append((zstandard.ZstdCompressor().compress(raw), len(raw)))
        elif supercompression == SUPERCOMPRESSION_ZLIB:
            import zlib

            blobs.append((zlib.compress(raw), len(raw)))
        else:
            blobs.append((raw, len(raw)))

    level_entries = []
    offset = payload_offset
    for compressed, uncompressed_length in blobs:
        offset = (offset + 7) & ~7  # 8-byte align levels
        level_entries.append((offset, len(compressed), uncompressed_length))
        offset += len(compressed)

    out = bytearray()
    out += header
    out += struct.pack("<2I", dfd_offset, len(dfd))  # dfd
    out += struct.pack("<2I", 0, 0)  # kvd
    out += struct.pack("<2Q", 0, 0)  # sgd
    for entry in level_entries:
        out += struct.pack("<3Q", *entry)
    out += dfd
    for (entry, (compressed, _)) in zip(level_entries, blobs):
        while len(out) < entry[0]:
            out.append(0)
        out += compressed
    return bytes(out)


def write_ktx2(
    path: str | Path,
    levels: list[np.ndarray],
    srgb: bool,
    supercompression: int = SUPERCOMPRESSION_NONE,
) -> Path:
    """Write an RGBA8 mip chain as a KTX2 file (optionally compressed)."""
    path = Path(path)
    path.write_bytes(encode_ktx2(levels, srgb, supercompression))
    return path


def _basic_dfd(model: int, transfer: int) -> bytes:
    """Minimal KDF 1.3 basic descriptor block carrying model + transfer."""
    total = 4 + 24
    block = struct.pack(
        "<IHHBBBB",
        0,  # vendor 0 (Khronos), descriptor type 0
        0, 24 + 0,  # versionNumber, descriptorBlockSize (no samples)
        model, 1, transfer, 0,  # colorModel, primaries, transfer, flags
    ) + bytes(24 - 12)
    return struct.pack("<I", total) + block


def encode_ktx2_basis(
    levels: list[np.ndarray],
    srgb: bool,
    mode: str = "etc1s",
) -> bytes:
    """Encode RGBA8 mips as a Basis Universal KTX2 container (vkFormat 0).

    mode="etc1s": BasisLZ-supercompressed ETC1S slices; mode="uastc": UASTC
    blocks (solid-color subset). See vktf.loaders.basis for scope.
    """
    from vktf.loaders import basis

    if mode == "etc1s":
        sgd, payloads = basis.encode_basis_lz(levels)
        scheme = SUPERCOMPRESSION_BASISLZ
        dfd = _basic_dfd(KDF_MODEL_ETC1S,
                         KDF_TRANSFER_SRGB if srgb else KDF_TRANSFER_LINEAR)
    elif mode == "uastc":
        sgd = b""
        payloads = basis.encode_uastc_solid(levels)
        scheme = SUPERCOMPRESSION_NONE
        dfd = _basic_dfd(KDF_MODEL_UASTC,
                         KDF_TRANSFER_SRGB if srgb else KDF_TRANSFER_LINEAR)
    else:
        raise ValueError(f"unknown basis mode {mode!r}")

    width, height = levels[0].shape[1], levels[0].shape[0]
    header = _KTX2_IDENTIFIER + struct.pack(
        "<9I", 0, 1, width, height, 0, 0, 1, len(levels), scheme
    )
    level_index_offset = 80
    cursor = level_index_offset + 24 * len(levels)
    dfd_offset = cursor
    cursor += len(dfd)
    sgd_offset = 0
    if sgd:
        cursor = (cursor + 7) & ~7
        sgd_offset = cursor
        cursor += len(sgd)
    entries = []
    for p in payloads:
        cursor = (cursor + 7) & ~7
        entries.append((cursor, len(p), len(p)))
        cursor += len(p)

    out = bytearray()
    out += header
    out += struct.pack("<2I", dfd_offset, len(dfd))
    out += struct.pack("<2I", 0, 0)  # kvd
    out += struct.pack("<2Q", sgd_offset, len(sgd))
    for entry in entries:
        out += struct.pack("<3Q", *entry)
    out += dfd
    if sgd:
        while len(out) < sgd_offset:
            out.append(0)
        out += sgd
    for entry, p in zip(entries, payloads):
        while len(out) < entry[0]:
            out.append(0)
        out += p
    return bytes(out)


def write_ktx2_basis(
    path: str | Path,
    levels: list[np.ndarray],
    srgb: bool,
    mode: str = "etc1s",
) -> Path:
    path = Path(path)
    path.write_bytes(encode_ktx2_basis(levels, srgb, mode))
    return path
