"""KTX2 container conformance + adversarial BasisLZ VLC fixtures.

VERDICT r2 #7: the clean-failure promise at the ETC1S/UASTC boundary must be
fuzz-pinned at the CONTAINER layer (mip level ordering/padding,
keyValueData, DFD variants, hostile index offsets) AND the BITSTREAM layer
(every BasisError raise site in loaders/basis.py reachable from a container
parse lands in the two-tier policy: skip+log, never a crash).

All fixtures here are HAND-CONSTRUCTED with struct.pack + a local bit
packer — independent of vktf.loaders.ktx's own encoder — so they pin
the reader against the KTX2 spec layout, not against our writer.
Container layout per the Khronos KTX File Format Specification 2.0:
identifier(12) + header(9 u32) + index(dfd 2xu32, kvd 2xu32, sgd 2xu64) +
levelIndex(levelCount x 3 u64) + dfd + kvd + [align(8) sgd] + levels.
"""

import io

import numpy as np
import pytest

from vktf.log import Log
from vktf.loaders.ktx import KtxError, parse_ktx2

import struct


def make_log():
    out, err = io.StringIO(), io.StringIO()
    return Log(out_stream=out, err_stream=err), err


# ---------------------------------------------------------------------------
# hand-rolled container builder (spec layout, no vktf encoder involved)
# ---------------------------------------------------------------------------

IDENT = b"\xabKTX 20\xbb\r\n\x1a\n"
VK_R8G8B8A8_SRGB = 43
VK_R8G8B8A8_UNORM = 37


def basic_dfd(model=1, transfer=2):
    # KDF 1.3: u32 totalSize, then one basic block (24 bytes used here):
    # vendor/type u32, version/size u32, model byte @ +8, primaries,
    # transfer @ +10, flags, texel dims..., planes...
    block = bytearray(24)
    block[0:4] = struct.pack("<I", 0)  # vendor 0 (Khronos), type 0
    block[4:8] = struct.pack("<HH", 2, 24)  # versionNumber, blockSize
    block[8] = model
    block[9] = 1  # primaries BT709
    block[10] = transfer
    return struct.pack("<I", 4 + len(block)) + bytes(block)


def build_ktx2(levels, vk_format=VK_R8G8B8A8_SRGB, scheme=0, dfd=None,
               kvd=b"", sgd=b"", level_overrides=None, mip_padding=0,
               smallest_first=True):
    """levels: list of (H, W, 4) uint8, level 0 first. Layout follows the
    spec's storage recommendation (smallest level first in the file) when
    smallest_first, with `mip_padding` dead bytes between levels — the
    reader must honor the level index offsets either way."""
    dfd = basic_dfd() if dfd is None else dfd
    n = len(levels)
    header = struct.pack(
        "<9I", vk_format, 1, levels[0].shape[1], levels[0].shape[0],
        0, 0, 1, n, scheme,
    )
    index_off = 12 + 36
    level_index_off = index_off + 8 + 8 + 16
    dfd_off = level_index_off + 24 * n
    kvd_off = dfd_off + len(dfd)
    sgd_off = kvd_off + len(kvd)
    if sgd:
        sgd_off = (sgd_off + 7) & ~7  # sgd is 8-aligned per spec
    data_off = sgd_off + len(sgd)

    payloads = [lv.tobytes() for lv in levels]
    order = list(range(n - 1, -1, -1)) if smallest_first else list(range(n))
    offsets = [0] * n
    cur = data_off
    for li in order:
        cur += mip_padding
        offsets[li] = cur
        cur += len(payloads[li])
    level_index = b"".join(
        struct.pack("<3Q", offsets[i], len(payloads[i]), len(payloads[i]))
        for i in range(n)
    )
    if level_overrides:
        li = bytearray(level_index)
        for lvl, (o, bl, ul) in level_overrides.items():
            li[24 * lvl: 24 * lvl + 24] = struct.pack("<3Q", o, bl, ul)
        level_index = bytes(li)

    blob = bytearray()
    blob += IDENT + header
    blob += struct.pack("<4I", dfd_off, len(dfd), kvd_off, len(kvd))
    blob += struct.pack("<2Q", sgd_off if sgd else 0, len(sgd))
    blob += level_index + dfd + kvd
    blob += b"\0" * (sgd_off - len(blob)) + sgd
    body = bytearray(b"\0" * (cur - data_off))
    for li in order:
        body[offsets[li] - data_off: offsets[li] - data_off + len(payloads[li])] = payloads[li]
    blob += body
    return bytes(blob)


def kv_entry(key: str, value: bytes) -> bytes:
    payload = key.encode() + b"\0" + value
    pad = (-(4 + len(payload))) % 4
    return struct.pack("<I", len(payload)) + payload + b"\0" * pad


class Bits:
    """Local LSB-first bit packer (independent of loaders.basis.BitWriter)."""

    def __init__(self):
        self.bits = []

    def put(self, value, n):
        for i in range(n):
            self.bits.append((value >> i) & 1)
        return self

    def put_msb(self, value, n):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)
        return self

    def bytes(self):
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out)


def two_levels():
    rng = np.random.default_rng(7)
    l0 = rng.integers(0, 256, (8, 8, 4), np.uint8)
    l1 = rng.integers(0, 256, (4, 4, 4), np.uint8)
    return [l0, l1]


# ---------------------------------------------------------------------------
# container conformance
# ---------------------------------------------------------------------------


def test_mip_order_padding_and_keyvalue():
    """Smallest-level-first storage with mipPadding and a populated
    keyValueData section must decode bit-exactly (offsets are authoritative;
    kvd is metadata the reader skips)."""
    levels = two_levels()
    kvd = kv_entry("KTXwriter", b"hand-rolled fixture\0") + kv_entry(
        "KTXswizzle", b"rgba\0")
    blob = build_ktx2(levels, kvd=kvd, mip_padding=13, smallest_first=True)
    log, err = make_log()
    tex = parse_ktx2(blob, "fixture", log)
    assert err.getvalue() == ""
    assert tex.srgb is True
    assert len(tex.levels) == 2
    np.testing.assert_array_equal(tex.levels[0], levels[0])
    np.testing.assert_array_equal(tex.levels[1], levels[1])


def test_largest_first_layout_also_decodes():
    levels = two_levels()
    blob = build_ktx2(levels, smallest_first=False)
    tex = parse_ktx2(blob, "fixture")
    np.testing.assert_array_equal(tex.levels[0], levels[0])


def test_dfd_variants():
    """Explicit vkFormats carry their own transfer semantics: the DFD's
    transferFunction must not override R8G8B8A8_SRGB/UNORM, and a truncated
    or out-of-range DFD degrades to model 0 without failing the parse."""
    levels = [two_levels()[0]]
    # (a) SRGB vkFormat + linear-transfer DFD -> srgb stays True
    tex = parse_ktx2(build_ktx2(levels, dfd=basic_dfd(transfer=1)), "a")
    assert tex.srgb is True
    # (b) UNORM vkFormat + sRGB-transfer DFD -> srgb stays False
    tex = parse_ktx2(
        build_ktx2(levels, vk_format=VK_R8G8B8A8_UNORM,
                   dfd=basic_dfd(transfer=2)), "b")
    assert tex.srgb is False
    # (c) truncated DFD (below the 16-byte basic block)
    tex = parse_ktx2(build_ktx2(levels, dfd=b"\x08\0\0\0\0\0\0\0"), "c")
    np.testing.assert_array_equal(tex.levels[0], levels[0])


def test_level_offset_beyond_eof_is_fatal_tier():
    levels = [two_levels()[0]]
    blob = build_ktx2(levels, level_overrides={0: (1 << 40, 256, 256)})
    with pytest.raises(KtxError):
        parse_ktx2(blob, "oob")


def test_level_length_zero_is_fatal_tier():
    levels = [two_levels()[0]]
    blob = build_ktx2(levels, level_overrides={0: (200, 0, 0)})
    with pytest.raises(KtxError):
        parse_ktx2(blob, "zerolen")


# ---------------------------------------------------------------------------
# adversarial BasisLZ (vkFormat 0) — every VLC error path, clean skip
# ---------------------------------------------------------------------------

ETC1S_DFD = None  # built per-test: model 163, sRGB


def basis_container(sgd: bytes, payload: bytes = b"\0" * 8, width=4, height=4,
                    model=163, scheme=1):
    lvl = np.zeros((height, width, 4), np.uint8)
    blob = build_ktx2([lvl], vk_format=0, scheme=scheme,
                      dfd=basic_dfd(model=model), sgd=sgd,
                      level_overrides=None)
    # swap the level payload for the raw basis slice bytes: rebuild with a
    # level whose byte_length matches `payload`
    blob = bytearray(blob)
    # find data start = level0 offset from the index
    off, = struct.unpack_from("<Q", blob, 12 + 36 + 16 + 16)
    blob[off:] = payload
    struct.pack_into("<3Q", blob, 12 + 36 + 16 + 16, off, len(payload),
                     len(payload))
    return bytes(blob)


def sgd_header(endpoint_count=1, selector_count=1, images=((0, 8),),
               endpoints=b"", selectors=b""):
    out = struct.pack("<2H", endpoint_count, selector_count)
    out += struct.pack("<4I", len(endpoints), len(selectors), 0, 0)
    for rgb_off, rgb_len in images:
        out += struct.pack("<5I", 0, rgb_off, rgb_len, 0, 0)
    return out + endpoints + selectors


def expect_clean_skip(blob, needle):
    log, err = make_log()
    tex = parse_ktx2(blob, "adv", log)
    assert tex is None
    assert needle in err.getvalue(), err.getvalue()


def test_basislz_sgd_too_short():
    expect_clean_skip(basis_container(sgd=b"\x01\0\x01\0"), "too short")


def test_basislz_sgd_offset_beyond_eof():
    blob = bytearray(basis_container(sgd=sgd_header()))
    struct.pack_into("<2Q", blob, 64, 1 << 40, 64)  # hostile sgd offset
    expect_clean_skip(bytes(blob), "too short")


def test_basislz_endpoint_stream_overrun():
    # empty endpoint stream: read_huffman_table's 14-bit symbol count
    # immediately overruns
    expect_clean_skip(basis_container(sgd=sgd_header(endpoints=b"")),
                      "overrun")


def test_basislz_invalid_clc_count():
    # num_symbols=1 then a 5-bit code-length-code count of 25 (> 21)
    ep = Bits().put(1, 14).put(25, 5).bytes()
    expect_clean_skip(basis_container(sgd=sgd_header(endpoints=ep)),
                      "code-length code count")


def test_basislz_empty_clc_is_invalid_huffman():
    # 21 code-length codes, all zero length -> the code-length decoder has
    # no codes; the first symbol read must fail as "invalid Huffman code"
    b = Bits().put(5, 14).put(21, 5)
    for _ in range(21):
        b.put(0, 3)
    expect_clean_skip(basis_container(sgd=sgd_header(endpoints=b.bytes())),
                      "invalid Huffman code")


def test_basislz_repeat_without_previous_length():
    # give ONLY the repeat symbol (_CLC_ORDER[2] = 19) a code, then emit it
    # first: "repeat code with no previous length"
    b = Bits().put(5, 14).put(3, 5)
    b.put(0, 3).put(0, 3).put(1, 3)  # lengths for order [17, 18, 19]
    b.put_msb(0, 1)  # symbol 19 (code 0, len 1)
    b.put(0, 2)  # its 2 extra bits
    expect_clean_skip(basis_container(sgd=sgd_header(endpoints=b.bytes())),
                      "no previous length")


def test_basislz_selector_palette_truncated():
    # valid-enough endpoint stream for 0 endpoints: two empty huffman tables
    # (num_symbols=0 consumes no code lengths)... but selector_count=4 with
    # only 3 raw bytes -> "selector palette truncated"
    b = Bits()
    for _ in range(2):  # color + intensity tables, each: 0 symbols, 0 clcs
        b.put(0, 14).put(0, 5)
    sgd = sgd_header(endpoint_count=0, selector_count=4,
                     endpoints=b.bytes(), selectors=b"\0\0\0")
    expect_clean_skip(basis_container(sgd=sgd), "selector palette truncated")


def test_basislz_truncated_slice_bitstream():
    # plausible global data (0 endpoints / 0 selectors), but the SLICE
    # payload is empty -> slice header table read overruns, clean skip
    b = Bits()
    for _ in range(2):
        b.put(0, 14).put(0, 5)
    sgd = sgd_header(endpoint_count=0, selector_count=0, endpoints=b.bytes(),
                     selectors=b"")
    expect_clean_skip(basis_container(sgd=sgd, payload=b""), "overrun")


def test_uastc_payload_truncated():
    # model 166, scheme 0: an 8x8 needs 4 blocks x 16 B; give it 16 B total
    blob = basis_container(sgd=b"", payload=b"\0" * 16, width=8, height=8,
                           model=166, scheme=0)
    expect_clean_skip(blob, "truncated")


def test_basislz_with_explicit_vkformat_is_malformed_skip():
    levels = [np.zeros((4, 4, 4), np.uint8)]
    blob = build_ktx2(levels, vk_format=VK_R8G8B8A8_SRGB, scheme=1)
    log, err = make_log()
    assert parse_ktx2(blob, "bad", log) is None
    assert "malformed" in err.getvalue()


# ---------------------------------------------------------------------------
# UASTC readiness (VERDICT r3 #7): foreign-mode payloads must reject CLEANLY
# through the FULL container stack (not just decode_uastc), including under
# zstd level supercompression, and the register_uastc_transcoder seam must
# close the gap without any loader change.
# ---------------------------------------------------------------------------


def uastc_blocks(bw, bh, mode_byte, rgba=(10, 20, 30, 255)):
    blocks = np.zeros((bh, bw, 16), np.uint8)
    blocks[..., 0] = mode_byte
    blocks[..., 1:5] = rgba
    return blocks.tobytes()


def test_uastc_foreign_mode_container_skips():
    """An 8x8 UASTC level whose blocks carry a non-solid mode byte rejects
    image-wide with the logged mode histogram — through parse_ktx2, not
    just decode_uastc (basis.UASTC_MODE_COVERAGE documents the per-mode
    scope)."""
    blob = basis_container(sgd=b"", payload=uastc_blocks(2, 2, 0x01),
                           width=8, height=8, model=166, scheme=0)
    expect_clean_skip(blob, "unsupported block modes")


def test_uastc_foreign_mode_zstd_container_skips():
    """Same rejection with the payload under zstd supercompression
    (scheme 2): the level inflates correctly first, then the mode check
    rejects — exercising _decompress_level + decode_uastc end-to-end."""
    import zstandard

    raw = uastc_blocks(2, 2, 0x11)
    blob = bytearray(basis_container(
        sgd=b"", payload=zstandard.ZstdCompressor().compress(raw),
        width=8, height=8, model=166, scheme=2))
    # basis_container wrote uncompressedByteLength = compressed length;
    # patch the level index's third u64 to the true uncompressed size
    struct.pack_into("<Q", blob, 12 + 36 + 16 + 16 + 16, len(raw))
    expect_clean_skip(bytes(blob), "unsupported block modes")


def test_uastc_registered_transcoder_closes_gap():
    """Installing a full transcoder via the seam makes the SAME
    foreign-mode container decode through the unchanged loader stack; the
    seam restores cleanly."""
    from vktf.loaders import basis

    def fake_full_transcoder(data, width, height):
        bw, bh = (width + 3) // 4, (height + 3) // 4
        blocks = np.frombuffer(data, np.uint8).reshape(bh, bw, 16)
        rgba = np.repeat(np.repeat(blocks[..., 1:5], 4, 0), 4, 1)
        return rgba[:height, :width]

    blob = basis_container(sgd=b"", payload=uastc_blocks(2, 2, 0x01),
                           width=8, height=8, model=166, scheme=0)
    prev = basis.register_uastc_transcoder(fake_full_transcoder)
    try:
        log, err = make_log()
        tex = parse_ktx2(blob, "adv", log)
        assert tex is not None and len(tex.levels) == 1
        assert tex.levels[0].shape == (8, 8, 4)
        np.testing.assert_array_equal(tex.levels[0][0, 0], [10, 20, 30, 255])
        assert err.getvalue() == ""
    finally:
        basis.register_uastc_transcoder(prev)
    # restored: the built-in subset rejects again
    expect_clean_skip(blob, "unsupported block modes")


def test_uastc_registered_transcoder_failure_is_clean_skip():
    """A transcoder that blows up on hostile bytes stays inside the
    two-tier policy: skip + logged error, never an uncaught exception."""
    from vktf.loaders import basis

    def broken(data, width, height):
        raise ValueError("internal transcoder bug")

    blob = basis_container(sgd=b"", payload=uastc_blocks(2, 2, 0x01),
                           width=8, height=8, model=166, scheme=0)
    prev = basis.register_uastc_transcoder(broken)
    try:
        expect_clean_skip(blob, "transcoder failed")
    finally:
        basis.register_uastc_transcoder(prev)


def test_uastc_foreign_mode_through_gltf_scene_stack(tmp_path):
    """FULL loader stack: a glTF material referencing a foreign-mode UASTC
    .ktx2 builds a working scene on the default texture, increments
    textures.decode_failed, and logs — the reference's reject-material
    ethos (model.cppm:391-409) at the highest level."""
    from vktf.models.gltf_writer import GltfWriter
    from vktf.models.primitives import plane_mesh
    from vktf.utils.profiling import counters

    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    from helpers import build_scene

    blob = basis_container(sgd=b"", payload=uastc_blocks(2, 2, 0x05),
                           width=8, height=8, model=166, scheme=0)
    w = GltfWriter()
    img = w.add_image_bytes(blob, "image/ktx2")
    mat = w.add_material(base_color_texture=w.add_texture(img))
    w.add_scene([
        w.add_node(mesh=w.add_mesh(plane_mesh(1.0), material=mat)),
        w.add_node(light=w.add_light(type="directional")),
    ])
    before = counters.get("textures.decode_failed")
    scene, meta, aux = build_scene(w.write(tmp_path / "uastc.gltf"))
    assert counters.get("textures.decode_failed") == before + 1
    assert scene.tri_corner.shape[1] >= 2  # geometry survived the skip
