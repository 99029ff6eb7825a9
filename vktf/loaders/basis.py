"""Basis Universal (ETC1S / BasisLZ) transcoding for KTX2 textures.

The reference transcodes Basis-supercompressed KTX2 payloads through libktx
to a device block format chosen from GPU caps (ktx_texture.cppm:62-94). The
software sampler reads plain RGBA8, so that is the target here: the ETC1S
intermediate decodes directly to RGBA mip levels that live in device
memory.

Scope and provenance:
  * Container layout follows the KTX2 specification's BasisLZ
    supercompressionGlobalData section (endpoint/selector codebooks + per-
    image slice descriptions).
  * The VLC layer (canonical Huffman code transmission, DPCM endpoint
    palette coding, endpoint-prediction runs) is structured after Basis
    Universal's ETC1S scheme. This environment has no basisu encoder, no
    sample .basis/.ktx2 payloads (the reference's assets are git-LFS
    pointers) and no network egress, so BIT-LEVEL parity with files written
    by the official encoder cannot be validated here; the format is
    exercised end-to-end through this module's own encoder (round-trip
    golden tests, tests/test_basis.py). Real-world files that deviate in
    VLC details fail with a logged error and the loader's usual
    skip-with-default semantics (model.cppm:301-321 ethos) — never a crash.
  * ETC1S block -> RGBA expansion (the bulk data op) runs in native C++
    (native/vktf_native.cpp) with a vectorized numpy fallback.

UASTC: see decode_uastc below — solid-color (mode 8) blocks decode; other
modes are skipped with a logged error listing the mode histogram.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import numpy as np

from vktf.log import Log, default_log


class BasisError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# Bit I/O (LSB-first, as in the Basis bitstreams)
# ---------------------------------------------------------------------------


class BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # bit position

    def read(self, bits: int) -> int:
        out = 0
        for i in range(bits):
            byte = self._pos >> 3
            if byte >= len(self._data):
                raise BasisError("bitstream overrun")
            bit = (self._data[byte] >> (self._pos & 7)) & 1
            out |= bit << i
            self._pos += 1
        return out

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7


class BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def write(self, value: int, bits: int) -> None:
        for i in range(bits):
            self._bits.append((value >> i) & 1)

    def getvalue(self) -> bytes:
        out = bytearray((len(self._bits) + 7) // 8)
        for i, b in enumerate(self._bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out)


# ---------------------------------------------------------------------------
# Canonical Huffman
# ---------------------------------------------------------------------------


def canonical_codes(lengths: list[int]) -> dict[int, tuple[int, int]]:
    """symbol -> (code, length), canonical (shorter codes first, then symbol
    order); codes are read MSB-first within the LSB-first bitstream by
    accumulating one bit at a time."""
    pairs = sorted(
        (l, s) for s, l in enumerate(lengths) if l > 0
    )
    codes: dict[int, tuple[int, int]] = {}
    code = 0
    prev_len = 0
    for length, symbol in pairs:
        code <<= (length - prev_len)
        codes[symbol] = (code, length)
        code += 1
        prev_len = length
    return codes


class HuffmanDecoder:
    def __init__(self, lengths: list[int]):
        self._by_code = {
            (length, code): symbol
            for symbol, (code, length) in canonical_codes(lengths).items()
        }
        self._max_len = max([l for l in lengths if l > 0], default=0)

    def read(self, reader: BitReader) -> int:
        code = 0
        for length in range(1, self._max_len + 1):
            code = (code << 1) | reader.read(1)
            symbol = self._by_code.get((length, code))
            if symbol is not None:
                return symbol
        raise BasisError("invalid Huffman code")


class HuffmanEncoder:
    def __init__(self, lengths: list[int]):
        self._codes = canonical_codes(lengths)
        self.lengths = lengths

    def write(self, writer: BitWriter, symbol: int) -> None:
        code, length = self._codes[symbol]
        for i in range(length - 1, -1, -1):  # MSB-first
            writer.write((code >> i) & 1, 1)


def _code_lengths_for(freqs: list[int], max_len: int = 15) -> list[int]:
    """Length-limited Huffman code lengths (package-merge-free heuristic:
    build Huffman, clamp, repair Kraft)."""
    import heapq

    n = len(freqs)
    heap = [(f, i, None) for i, f in enumerate(freqs) if f > 0]
    if not heap:
        return [0] * n
    if len(heap) == 1:
        lengths = [0] * n
        lengths[heap[0][1]] = 1
        return lengths
    heapq.heapify(heap)
    counter = n
    parents: dict[int, tuple] = {}
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        node = (a[0] + b[0], counter, (a, b))
        parents[counter] = (a, b)
        counter += 1
        heapq.heappush(heap, node)
    lengths = [0] * n

    def walk(node, depth):
        if node[2] is None:
            lengths[node[1]] = max(depth, 1)
            return
        walk(node[2][0], depth + 1)
        walk(node[2][1], depth + 1)

    walk(heap[0], 0)
    # clamp + repair Kraft inequality
    for i, l in enumerate(lengths):
        if l > max_len:
            lengths[i] = max_len
    while sum(2 ** (max_len - l) for l in lengths if l > 0) > (1 << max_len):
        # deepen the shallowest clamped-adjacent symbol
        cand = max((l, i) for i, l in enumerate(lengths) if 0 < l < max_len)
        lengths[cand[1]] += 1
    return lengths


# Code-length transmission follows Basis Universal's canonical-Huffman
# scheme (basisu_transcoder huffman layer; the public .basis/KTX2 BasisLZ
# spec): a 21-symbol code-length alphabet — lengths 0..16 plus FOUR run
# codes — whose own 3-bit lengths are transmitted in a fixed sorted order
# (run codes first, then lengths by typical frequency) so trailing zeros
# compress away. DEFLATE uses a similar but NOT identical scheme (19
# symbols, different order) — round 1 shipped the DEFLATE variant; this is
# the basisu one.
_SYM_ZERO_RUN = 17  # 3-10 zeros (3 extra bits)
_SYM_ZERO_RUN_LONG = 18  # 11-138 zeros (7 extra bits)
_SYM_REPEAT = 19  # repeat previous nonzero length 3-6 times (2 extra bits)
_SYM_REPEAT_LONG = 20  # repeat previous nonzero length 7-134 times (7 extra bits)
_CLC_ORDER = (
    _SYM_ZERO_RUN, _SYM_ZERO_RUN_LONG, _SYM_REPEAT, _SYM_REPEAT_LONG,
    0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15, 16,
)
_MAX_SYMS_LOG2 = 14  # symbol counts are transmitted in 14 bits


def write_huffman_table(writer: BitWriter, lengths: list[int]) -> HuffmanEncoder:
    """Transmit code lengths (with zero-run + repeat symbols), return the
    encoder."""
    if len(lengths) >= 1 << _MAX_SYMS_LOG2:
        raise BasisError(f"Huffman alphabet too large ({len(lengths)})")
    writer.write(len(lengths), _MAX_SYMS_LOG2)
    # run-length the lengths into the 21-symbol code-length alphabet
    symbols: list[tuple[int, int, int]] = []  # (symbol, extra, extra_bits)
    i = 0
    prev_nonzero = -1
    while i < len(lengths):
        if lengths[i] == 0:
            run = 1
            while i + run < len(lengths) and lengths[i + run] == 0 and run < 138:
                run += 1
            if run >= 11:
                symbols.append((_SYM_ZERO_RUN_LONG, run - 11, 7))
                i += run
                continue
            if run >= 3:
                symbols.append((_SYM_ZERO_RUN, run - 3, 3))
                i += run
                continue
        elif lengths[i] == prev_nonzero:
            run = 1
            while (i + run < len(lengths) and lengths[i + run] == prev_nonzero
                   and run < 134):
                run += 1
            if run >= 7:
                symbols.append((_SYM_REPEAT_LONG, run - 7, 7))
                i += run
                continue
            if run >= 3:
                symbols.append((_SYM_REPEAT, run - 3, 2))
                i += run
                continue
        symbols.append((lengths[i], 0, 0))
        if lengths[i]:
            prev_nonzero = lengths[i]
        i += 1
    clc_freq = [0] * 21
    for s, _, _ in symbols:
        clc_freq[s] += 1
    clc_lengths = _code_lengths_for(clc_freq, max_len=7)
    writer.write(len(_CLC_ORDER), 5)
    for idx in _CLC_ORDER:
        writer.write(clc_lengths[idx], 3)
    clc = HuffmanEncoder(clc_lengths)
    for s, extra, extra_bits in symbols:
        clc.write(writer, s)
        if extra_bits:
            writer.write(extra, extra_bits)
    return HuffmanEncoder(lengths)


def read_huffman_table(reader: BitReader) -> HuffmanDecoder:
    num_symbols = reader.read(_MAX_SYMS_LOG2)
    num_clc = reader.read(5)
    if num_clc > len(_CLC_ORDER):
        raise BasisError(f"invalid code-length code count {num_clc}")
    clc_lengths = [0] * 21
    for i in range(num_clc):
        clc_lengths[_CLC_ORDER[i]] = reader.read(3)
    clc = HuffmanDecoder(clc_lengths)
    lengths: list[int] = []
    prev_nonzero = -1
    while len(lengths) < num_symbols:
        s = clc.read(reader)
        if s == _SYM_ZERO_RUN:
            lengths += [0] * (3 + reader.read(3))
        elif s == _SYM_ZERO_RUN_LONG:
            lengths += [0] * (11 + reader.read(7))
        elif s == _SYM_REPEAT:
            if prev_nonzero < 0:
                raise BasisError("repeat code with no previous length")
            lengths += [prev_nonzero] * (3 + reader.read(2))
        elif s == _SYM_REPEAT_LONG:
            if prev_nonzero < 0:
                raise BasisError("repeat code with no previous length")
            lengths += [prev_nonzero] * (7 + reader.read(7))
        else:
            lengths.append(s)
            if s:
                prev_nonzero = s
    return HuffmanDecoder(lengths[:num_symbols])


# ---------------------------------------------------------------------------
# ETC1S block math
# ---------------------------------------------------------------------------

# ETC1 intensity modifier tables (ETC1 spec); ETC1S uses one table per block.
ETC1_MODIFIERS = np.asarray(
    [
        [-8, -2, 2, 8],
        [-17, -5, 5, 17],
        [-29, -9, 9, 29],
        [-42, -13, 13, 42],
        [-60, -18, 18, 60],
        [-80, -24, 24, 80],
        [-106, -33, 33, 106],
        [-183, -47, 47, 183],
    ],
    np.int32,
)


@dataclasses.dataclass
class Etc1sEndpoint:
    color5: tuple[int, int, int]  # 5-bit RGB base color
    inten: int  # 0..7 intensity table


def _expand5(c5: np.ndarray) -> np.ndarray:
    """5-bit -> 8-bit channel expansion (c << 3) | (c >> 2)."""
    return (c5 << 3) | (c5 >> 2)


def decode_etc1s_blocks(endpoint_ids, selector_ids, endpoints, selectors,
                        width: int, height: int) -> np.ndarray:
    """Expand per-block (endpoint id, selector id) to an (H, W, 4) RGBA8
    image. endpoints: (E, 4) int32 [r5, g5, b5, inten]; selectors: (S, 16)
    uint8 of 2-bit selector values in raster order within the 4x4 block.
    """
    from vktf import native

    bw = (width + 3) // 4
    bh = (height + 3) // 4
    endpoint_ids = np.asarray(endpoint_ids, np.int32).reshape(bh, bw)
    selector_ids = np.asarray(selector_ids, np.int32).reshape(bh, bw)
    endpoints = np.asarray(endpoints, np.int32)
    selectors = np.asarray(selectors, np.uint8)

    out = native.decode_etc1s(endpoint_ids, selector_ids, endpoints,
                              selectors, width, height)
    if out is not None:
        return out

    base5 = endpoints[endpoint_ids][..., :3]  # (bh, bw, 3)
    base8 = _expand5(base5)
    inten = endpoints[endpoint_ids][..., 3]  # (bh, bw)
    sel = selectors[selector_ids].reshape(bh, bw, 4, 4)  # (bh,bw,4,4)
    mods = ETC1_MODIFIERS[inten]  # (bh, bw, 4)
    delta = np.take_along_axis(
        mods[:, :, None, None, :].repeat(4, 2).repeat(4, 3),
        sel[..., None].astype(np.int64),
        axis=-1,
    )[..., 0]  # (bh, bw, 4, 4)
    rgb = np.clip(base8[:, :, None, None, :] + delta[..., None], 0, 255)
    img = np.empty((bh * 4, bw * 4, 4), np.uint8)
    img[..., :3] = rgb.transpose(0, 2, 1, 3, 4).reshape(bh * 4, bw * 4, 3)
    img[..., 3] = 255
    return img[:height, :width]


# ---------------------------------------------------------------------------
# BasisLZ global data + slice codec
# ---------------------------------------------------------------------------

# per-block endpoint prediction symbols (run-friendly):
_PRED_LEFT = 0  # repeat the left neighbor's endpoint
_PRED_UP = 1  # repeat the upper neighbor's endpoint
_PRED_DELTA = 2  # explicit delta-coded endpoint index
_MAX_SELECTOR_RAW = True  # selector codebook is transmitted raw (4B each)


@dataclasses.dataclass
class BasisLZGlobalData:
    endpoints: np.ndarray  # (E, 4) int32: r5, g5, b5, inten
    selectors: np.ndarray  # (S, 16) uint8 2-bit values
    images: list[dict]  # rgbSliceByteOffset/rgbSliceByteLength per level


def parse_basis_lz_global_data(sgd: bytes, image_count: int) -> BasisLZGlobalData:
    """Parse the KTX2 supercompressionGlobalData blob for BasisLZ."""
    if len(sgd) < 20:
        raise BasisError("BasisLZ global data too short")
    endpoint_count, selector_count = struct.unpack_from("<2H", sgd, 0)
    endpoints_len, selectors_len, tables_len, extended_len = struct.unpack_from(
        "<4I", sgd, 4
    )
    off = 20
    images = []
    for _ in range(image_count):
        flags, rgb_off, rgb_len, a_off, a_len = struct.unpack_from("<5I", sgd, off)
        images.append(
            {
                "flags": flags,
                "rgb_offset": rgb_off,
                "rgb_length": rgb_len,
                "alpha_offset": a_off,
                "alpha_length": a_len,
            }
        )
        off += 20
    endpoints_data = sgd[off : off + endpoints_len]
    off += endpoints_len
    selectors_data = sgd[off : off + selectors_len]
    off += selectors_len
    # tables/extended blobs are folded into the endpoint stream in this
    # implementation (the Huffman tables travel inline); skip any trailer.

    # endpoint palette: DPCM, Huffman-coded deltas
    reader = BitReader(endpoints_data)
    color_model = read_huffman_table(reader)
    inten_model = read_huffman_table(reader)
    endpoints = np.zeros((endpoint_count, 4), np.int32)
    prev = np.zeros(4, np.int32)
    for e in range(endpoint_count):
        for c in range(3):
            delta = color_model.read(reader) - 31
            prev[c] = (prev[c] + delta) & 31
        prev[3] = (prev[3] + inten_model.read(reader) - 7) & 7
        endpoints[e] = prev
    # selector palette: raw 4 bytes per selector (16 x 2-bit, row-major)
    if len(selectors_data) < 4 * selector_count:
        raise BasisError("selector palette truncated")
    raw = np.frombuffer(selectors_data[: 4 * selector_count], np.uint8)
    rows = raw.reshape(selector_count, 4)
    selectors = np.zeros((selector_count, 16), np.uint8)
    for i in range(4):  # byte = one block row, 2 bits per texel
        for j in range(4):
            selectors[:, i * 4 + j] = (rows[:, i] >> (2 * j)) & 3
    return BasisLZGlobalData(endpoints=endpoints, selectors=selectors, images=images)


def decode_etc1s_slice(
    data: bytes,
    width: int,
    height: int,
    gd: BasisLZGlobalData,
) -> np.ndarray:
    """Decode one ETC1S slice to (H, W, 4) RGBA8."""
    bw, bh = (width + 3) // 4, (height + 3) // 4
    reader = BitReader(data)
    pred_model = read_huffman_table(reader)
    endpoint_delta_model = read_huffman_table(reader)
    selector_model = read_huffman_table(reader)

    num_endpoints = gd.endpoints.shape[0]
    endpoint_ids = np.zeros((bh, bw), np.int32)
    selector_ids = np.zeros((bh, bw), np.int32)
    prev_endpoint = 0
    for y in range(bh):
        for x in range(bw):
            pred = pred_model.read(reader)
            if pred == _PRED_LEFT and x > 0:
                endpoint = endpoint_ids[y, x - 1]
            elif pred == _PRED_UP and y > 0:
                endpoint = endpoint_ids[y - 1, x]
            else:
                delta = endpoint_delta_model.read(reader) - num_endpoints + 1
                endpoint = (prev_endpoint + delta) % num_endpoints
            endpoint_ids[y, x] = endpoint
            prev_endpoint = endpoint
            selector_ids[y, x] = selector_model.read(reader)
    return decode_etc1s_blocks(
        endpoint_ids, selector_ids, gd.endpoints, gd.selectors, width, height
    )


# ---------------------------------------------------------------------------
# Encoder (fixtures + demo assets): RGBA -> ETC1S/BasisLZ
# ---------------------------------------------------------------------------


def _encode_etc1s_block(block: np.ndarray) -> tuple[tuple, bytes]:
    """Quantize a (4,4,3) block to one ETC1S endpoint + selectors."""
    mean = block.reshape(-1, 3).mean(axis=0)
    c5 = np.clip(np.round(mean / 255.0 * 31.0), 0, 31).astype(np.int32)
    base8 = _expand5(c5)
    # luma distances from base select the intensity table + selectors
    diffs = block.reshape(-1, 3).astype(np.int32) - base8
    proj = diffs.mean(axis=1)  # scalar intensity offset per texel
    best = None
    for table in range(8):
        mods = ETC1_MODIFIERS[table]
        sel = np.abs(proj[:, None] - mods[None, :]).argmin(axis=1)
        recon = base8[None, :] + mods[sel][:, None]
        err = float(((np.clip(recon, 0, 255) - block.reshape(-1, 3)) ** 2).sum())
        if best is None or err < best[0]:
            best = (err, table, sel)
    _, table, sel = best
    key = (int(c5[0]), int(c5[1]), int(c5[2]), int(table))
    sel_bytes = bytearray(4)
    for i in range(4):
        for j in range(4):
            sel_bytes[i] |= int(sel[i * 4 + j]) << (2 * j)
    return key, bytes(sel_bytes)


def encode_basis_lz(levels: list[np.ndarray]) -> tuple[bytes, list[bytes]]:
    """Encode RGBA8 mip levels as (supercompressionGlobalData, slice bytes).

    Returns the sgd blob (endpoint/selector codebooks + image descs whose
    offsets index into the concatenated level payloads) and per-level slice
    byte strings.
    """
    # pass 1: per-block quantization + codebooks
    per_level: list[tuple[np.ndarray, list[bytes], list[tuple]]] = []
    endpoint_index: dict[tuple, int] = {}
    selector_index: dict[bytes, int] = {}
    for level in levels:
        h, w = level.shape[:2]
        bw, bh = (w + 3) // 4, (h + 3) // 4
        padded = np.zeros((bh * 4, bw * 4, 3), np.uint8)
        padded[:h, :w] = level[..., :3]
        padded[h:] = padded[max(h - 1, 0) : max(h, 1)]
        padded[:, w:] = padded[:, max(w - 1, 0) : max(w, 1)]
        eids, sids = [], []
        for y in range(bh):
            for x in range(bw):
                block = padded[4 * y : 4 * y + 4, 4 * x : 4 * x + 4]
                key, sel = _encode_etc1s_block(block.astype(np.int32))
                eids.append(endpoint_index.setdefault(key, len(endpoint_index)))
                sids.append(selector_index.setdefault(sel, len(selector_index)))
        per_level.append((np.asarray(eids).reshape(bh, bw),
                          np.asarray(sids).reshape(bh, bw), (w, h)))

    endpoints = list(endpoint_index)
    selectors = list(selector_index)

    # endpoint palette stream (DPCM + Huffman)
    color_freq = [0] * 63
    inten_freq = [0] * 15
    prev = [0, 0, 0, 0]
    deltas = []
    for r, g, b, it in endpoints:
        row = []
        for c, v in enumerate((r, g, b)):
            d = (v - prev[c]) % 32
            d = d if d <= 16 else d - 32
            row.append(d + 31)
            color_freq[d + 31] += 1
            prev[c] = v
        di = (it - prev[3]) % 8
        di = di if di <= 4 else di - 8
        row.append(di + 7)
        inten_freq[di + 7] += 1
        prev[3] = it
        deltas.append(row)
    wr = BitWriter()
    color_enc = write_huffman_table(wr, _code_lengths_for(color_freq))
    inten_enc = write_huffman_table(wr, _code_lengths_for(inten_freq))
    for row in deltas:
        for d in row[:3]:
            color_enc.write(wr, d)
        inten_enc.write(wr, row[3])
    endpoints_data = wr.getvalue()
    selectors_data = b"".join(selectors)

    # per-level slice streams
    num_endpoints = len(endpoints)
    slices = []
    for eids, sids, (w, h) in per_level:
        bh, bw = eids.shape
        pred_freq = [0] * 3
        delta_freq = [0] * (2 * num_endpoints)
        sel_freq = [0] * len(selectors)
        events = []
        prev_e = 0
        for y in range(bh):
            for x in range(bw):
                e = int(eids[y, x])
                if x > 0 and e == eids[y, x - 1]:
                    events.append((_PRED_LEFT, None))
                elif y > 0 and e == eids[y - 1, x]:
                    events.append((_PRED_UP, None))
                else:
                    delta = (e - prev_e) % num_endpoints
                    sym = delta + num_endpoints - 1
                    events.append((_PRED_DELTA, sym))
                    delta_freq[sym] += 1
                pred_freq[events[-1][0]] += 1
                prev_e = e
                sel_freq[int(sids[y, x])] += 1
        wr = BitWriter()
        pred_enc = write_huffman_table(wr, _code_lengths_for(pred_freq))
        delta_enc = write_huffman_table(wr, _code_lengths_for(delta_freq))
        sel_enc = write_huffman_table(wr, _code_lengths_for(sel_freq))
        it = iter(events)
        for y in range(bh):
            for x in range(bw):
                pred, sym = next(it)
                pred_enc.write(wr, pred)
                if pred == _PRED_DELTA:
                    delta_enc.write(wr, sym)
                sel_enc.write(wr, int(sids[y, x]))
        slices.append(wr.getvalue())

    # global data blob; slice offsets are relative to each mip level's
    # payload (the KTX2 level data IS the slice), hence offset 0
    head = struct.pack(
        "<2H4I", len(endpoints), len(selectors), len(endpoints_data),
        len(selectors_data), 0, 0
    )
    descs = b""
    for s in slices:
        descs += struct.pack("<5I", 0, 0, len(s), 0, 0)
    sgd = head + descs + endpoints_data + selectors_data
    return sgd, slices


# ---------------------------------------------------------------------------
# UASTC (4x4, 16 bytes/block)
# ---------------------------------------------------------------------------

# Per-mode coverage. UASTC LDR defines 19 block modes
# (0-18); mode 8 is the solid-color block. This build decodes ONLY
# solid-color blocks, and only in this module's marker form (byte 0x08 +
# RGBA8 — what encode_uastc_solid emits); every other mode — and real
# BISE-packed mode-8 bits — is rejected image-wide with a logged mode
# histogram. The real per-mode bit layouts (variable-length mode codes,
# BISE endpoint/weight packing, ASTC partition tables) come from the
# Khronos Data Format Spec annex, which is not reproducible from this
# offline environment (no spec text, no basisu encoder, no test vectors);
# a from-memory reconstruction would decode real files WRONGLY rather
# than failing cleanly. The seam to close the gap when vectors land is
# register_uastc_transcoder() below.
UASTC_MODE_COVERAGE: dict[int, str] = {
    **{m: "unsupported — clean image-wide reject with logged histogram"
       for m in range(19)},
    8: ("solid-color: decoded in module marker form (0x08 + RGBA8); real "
        "BISE bit-layout unvalidated (no vectors in environment)"),
}

# pluggable full-transcoder seam: a callable (data, width, height) ->
# Optional[np.ndarray (H, W, 4) u8] consulted BEFORE the built-in
# marker-form decoder. Install a real spec-complete UASTC transcoder here
# (e.g. one validated against basisu-encoded vectors) and every caller —
# ktx.py's container path included — picks it up without code changes.
_uastc_transcoder = None


def register_uastc_transcoder(fn):
    """Install (or clear, with None) the full UASTC transcoder; returns the
    previously installed one so tests/callers can restore it."""
    global _uastc_transcoder
    prev = _uastc_transcoder
    _uastc_transcoder = fn
    return prev


def decode_uastc(data: bytes, width: int, height: int,
                 log: Optional[Log] = None) -> Optional[np.ndarray]:
    """Decode UASTC LDR blocks to RGBA8.

    Dispatch: a transcoder installed via register_uastc_transcoder() is
    consulted first (the seam for a spec-complete decoder once validation
    vectors are available); otherwise the built-in subset applies — see
    UASTC_MODE_COVERAGE for the per-mode table. Foreign-mode blocks reject
    the whole image with a logged mode-histogram error per the
    skip-and-log policy (model.cppm:301-321 ethos) — a default texture is
    better than a corrupted one — while this module's own KTX2 exports
    round-trip.
    """
    log = log or default_log()
    if _uastc_transcoder is not None:
        try:
            out = _uastc_transcoder(data, width, height)
        except BasisError:
            raise
        except Exception as error:
            raise BasisError(
                f"installed UASTC transcoder failed: {error}"
            ) from error
        if out is not None:
            out = np.asarray(out, np.uint8)
            if out.shape != (height, width, 4):
                raise BasisError(
                    f"installed UASTC transcoder returned {out.shape}, "
                    f"expected {(height, width, 4)}"
                )
            return out
    bw, bh = (width + 3) // 4, (height + 3) // 4
    if len(data) < 16 * bw * bh:
        raise BasisError("UASTC payload truncated")
    blocks = np.frombuffer(data[: 16 * bw * bh], np.uint8).reshape(bh, bw, 16)
    is_solid = blocks[..., 0] == 0x08
    if not is_solid.all():
        modes, counts = np.unique(blocks[..., 0], return_counts=True)
        log.error(
            "UASTC image uses unsupported block modes "
            f"{dict(zip(modes.tolist(), counts.tolist()))}; only solid-color "
            "blocks (0x08) decode in this build"
        )
        return None
    rgba = blocks[..., 1:5]  # (bh, bw, 4)
    img = np.repeat(np.repeat(rgba, 4, axis=0), 4, axis=1)
    return img[:height, :width]


def encode_uastc_solid(levels: list[np.ndarray]) -> list[bytes]:
    """Encode mip levels as solid-color UASTC blocks (mode-8 subset)."""
    out = []
    for level in levels:
        h, w = level.shape[:2]
        bw, bh = (w + 3) // 4, (h + 3) // 4
        blocks = np.zeros((bh, bw, 16), np.uint8)
        blocks[..., 0] = 0x08
        for y in range(bh):
            for x in range(bw):
                cell = level[4 * y : 4 * y + 4, 4 * x : 4 * x + 4]
                blocks[y, x, 1:5] = cell.reshape(-1, 4).mean(axis=0).astype(np.uint8)
        out.append(blocks.tobytes())
    return out
