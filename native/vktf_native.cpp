// vktf native runtime: the host-side hot loops of the asset pipeline.
//
// The reference engine runs its CPU-bound asset work in native code (cgltf
// attribute unpack gltf_asset.cppm:664-769; libktx decode/transcode
// ktx_texture.cppm:34-45; driver-side mip handling image.cppm:190-212). This
// module is this build's native equivalent for everything that stays on
// the host: sRGB-correct mip-chain generation, quad-pool texel packing
// (ops/texture_pack.py layout), glTF accessor unpacking (strided +
// normalized), and KTX2 supercompression inflate (zlib/zstd).
//
// Exposed as a plain C ABI consumed through ctypes (vktf/native.py),
// with pure-numpy fallbacks when the shared library is unavailable.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>
#include <zstd.h>

extern "C" {

// ---------------------------------------------------------------------------
// sRGB helpers (must match loaders/images.py exactly)
// ---------------------------------------------------------------------------

static inline float srgb_to_linear(float s) {
  return s <= 0.04045f ? s / 12.92f : std::pow((s + 0.055f) / 1.055f, 2.4f);
}

static inline float linear_to_srgb(float l) {
  l = std::min(std::max(l, 0.0f), 1.0f);
  return l <= 0.0031308f ? l * 12.92f : 1.055f * std::pow(l, 1.0f / 2.4f) - 0.055f;
}

// Total texel count of a full mip chain from (h, w) down to 1x1.
int64_t vktf_mip_chain_texels(int32_t h, int32_t w) {
  int64_t total = 0;
  while (true) {
    total += (int64_t)h * w;
    if (h == 1 && w == 1) break;
    h = std::max(h / 2, 1);
    w = std::max(w / 2, 1);
  }
  return total;
}

// Generate the full RGBA8 mip chain (level 0 included) into `out`, which
// must hold vktf_mip_chain_texels(h, w) * 4 bytes. Box filter in linear
// space with edge-clamp for odd dims — semantics identical to
// loaders/images.py generate_mips/_halve.
void vktf_generate_mips(const uint8_t* base, int32_t h, int32_t w,
                        int32_t srgb, uint8_t* out) {
  const int64_t base_texels = (int64_t)h * w;
  std::memcpy(out, base, base_texels * 4);
  uint8_t* out_cursor = out + base_texels * 4;

  // working buffer in linear-space float
  std::vector<float> cur((size_t)base_texels * 4);
  for (int64_t i = 0; i < base_texels; ++i) {
    for (int c = 0; c < 4; ++c) {
      float v = base[i * 4 + c] / 255.0f;
      cur[i * 4 + c] = (srgb && c < 3) ? srgb_to_linear(v) : v;
    }
  }

  int32_t ch = h, cw = w;
  std::vector<float> next;
  while (ch > 1 || cw > 1) {
    const int32_t nh = std::max(ch / 2, 1), nw = std::max(cw / 2, 1);
    next.assign((size_t)nh * nw * 4, 0.0f);
    for (int32_t y = 0; y < nh; ++y) {
      // edge-clamp: odd dims duplicate the last row/column
      const int32_t y0 = std::min(2 * y, ch - 1), y1 = std::min(2 * y + 1, ch - 1);
      for (int32_t x = 0; x < nw; ++x) {
        const int32_t x0 = std::min(2 * x, cw - 1), x1 = std::min(2 * x + 1, cw - 1);
        for (int c = 0; c < 4; ++c) {
          const float sum = cur[((int64_t)y0 * cw + x0) * 4 + c]
                          + cur[((int64_t)y0 * cw + x1) * 4 + c]
                          + cur[((int64_t)y1 * cw + x0) * 4 + c]
                          + cur[((int64_t)y1 * cw + x1) * 4 + c];
          next[((int64_t)y * nw + x) * 4 + c] = 0.25f * sum;
        }
      }
    }
    // special cases 1xN / Nx1 use 2-tap averages; the clamped 4-tap above
    // degenerates to exactly that (duplicated taps), so no branch needed
    for (int64_t i = 0; i < (int64_t)nh * nw; ++i) {
      for (int c = 0; c < 4; ++c) {
        float v = next[i * 4 + c];
        if (srgb && c < 3) v = linear_to_srgb(v);
        v = std::min(std::max(v, 0.0f), 1.0f);
        out_cursor[i * 4 + c] = (uint8_t)(v * 255.0f + 0.5f);
      }
    }
    out_cursor += (int64_t)nh * nw * 4;
    cur.swap(next);
    ch = nh;
    cw = nw;
  }
}

// ---------------------------------------------------------------------------
// Block-pool packing (ops/texture_pack.py: stride-2 fused-mip 3x3 blocks)
// ---------------------------------------------------------------------------

static inline int32_t wrap_index(int32_t i, int32_t size, int32_t mode) {
  // negative-safe: slot B anchors at bx-1, which is -1 on the first block
  // (C++ % is negative for negative operands; match numpy's floor-mod)
  if (mode == 0) {                                            // repeat
    const int32_t m = i % size;
    return m < 0 ? m + size : m;
  }
  if (mode == 1) return std::min(std::max(i, 0), size - 1);   // clamp
  const int32_t p = 2 * size;                                 // mirrored
  int32_t m = i % p;
  if (m < 0) m += p;
  return m >= size ? p - 1 - m : m;
}

// cur0..2: packed-u32 level-l arrays of size w*w; nxt0..2: level-(l+1)
// arrays of size max(w/2,1)^2, or null for the last level (slot B zero).
// out: bw*bw rows of 64 u32 (bw = max(w/2, 1)):
//   slot A lane t*9 + i*3 + j      = texture t level-l   texel
//     (wrap_t(2bx + j, w), wrap_t(2by + i, w))
//   slot B lane 27 + t*9 + i*3 + j = texture t level-l+1 texel
//     (wrap_t(bx - 1 + j, w1), wrap_t(by - 1 + i, w1)), w1 = max(w/2, 1)
// under texture t's OWN sampler wrap (wraps = [wu0, wv0, ..., wv2]);
// lanes 54..63 zero.
void vktf_pack_blocks_level(const uint32_t* cur0, const uint32_t* cur1,
                            const uint32_t* cur2, const uint32_t* nxt0,
                            const uint32_t* nxt1, const uint32_t* nxt2,
                            int32_t w, const int32_t* wraps, uint32_t* out) {
  const uint32_t* cur[3] = {cur0, cur1, cur2};
  const uint32_t* nxt[3] = {nxt0, nxt1, nxt2};
  const int32_t bw = std::max(w >> 1, 1);
  const int32_t w1 = bw;  // level-(l+1) width == the block-grid width
  for (int32_t by = 0; by < bw; ++by) {
    for (int32_t bx = 0; bx < bw; ++bx) {
      uint32_t* row = out + ((int64_t)by * bw + bx) * 64;
      for (int t = 0; t < 3; ++t) {
        const int32_t wrap_u = wraps[2 * t], wrap_v = wraps[2 * t + 1];
        for (int32_t i = 0; i < 3; ++i) {
          const int32_t ty = wrap_index(2 * by + i, w, wrap_v);
          for (int32_t j = 0; j < 3; ++j) {
            const int32_t tx = wrap_index(2 * bx + j, w, wrap_u);
            row[t * 9 + i * 3 + j] = cur[t][(int64_t)ty * w + tx];
          }
        }
        if (nxt[t]) {
          for (int32_t i = 0; i < 3; ++i) {
            const int32_t ny = wrap_index(by - 1 + i, w1, wrap_v);
            for (int32_t j = 0; j < 3; ++j) {
              const int32_t nx = wrap_index(bx - 1 + j, w1, wrap_u);
              row[27 + t * 9 + i * 3 + j] = nxt[t][(int64_t)ny * w1 + nx];
            }
          }
        }
      }
      for (int k = 54; k < 64; ++k) row[k] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// glTF accessor unpack: strided component data -> contiguous float32
// (the cgltf_accessor_unpack_floats analogue, gltf_asset.cppm:665-677)
// ---------------------------------------------------------------------------

// comp_type: glTF componentType codes. normalized per glTF 2.0 spec.
int32_t vktf_unpack_accessor(const uint8_t* src, int64_t count, int32_t comps,
                             int32_t comp_type, int32_t normalized,
                             int64_t stride, float* dst) {
  for (int64_t i = 0; i < count; ++i) {
    const uint8_t* e = src + i * stride;
    for (int32_t c = 0; c < comps; ++c) {
      float v;
      switch (comp_type) {
        case 5120: {  // int8
          int8_t raw; std::memcpy(&raw, e + c, 1);
          v = normalized ? std::max((float)raw / 127.0f, -1.0f) : (float)raw;
          break;
        }
        case 5121: {  // uint8
          v = normalized ? e[c] / 255.0f : (float)e[c];
          break;
        }
        case 5122: {  // int16
          int16_t raw; std::memcpy(&raw, e + c * 2, 2);
          v = normalized ? std::max((float)raw / 32767.0f, -1.0f) : (float)raw;
          break;
        }
        case 5123: {  // uint16
          uint16_t raw; std::memcpy(&raw, e + c * 2, 2);
          v = normalized ? raw / 65535.0f : (float)raw;
          break;
        }
        case 5125: {  // uint32
          uint32_t raw; std::memcpy(&raw, e + c * 4, 4);
          v = (float)raw;
          break;
        }
        case 5126: {  // float32
          std::memcpy(&v, e + c * 4, 4);
          break;
        }
        default:
          return -1;
      }
      dst[i * comps + c] = v;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// KTX2 supercompression inflate
// ---------------------------------------------------------------------------

int64_t vktf_inflate_zlib(const uint8_t* src, int64_t src_len, uint8_t* dst,
                          int64_t dst_len) {
  uLongf out_len = (uLongf)dst_len;
  const int rc = uncompress(dst, &out_len, src, (uLong)src_len);
  return rc == Z_OK ? (int64_t)out_len : -1;
}

int64_t vktf_decompress_zstd(const uint8_t* src, int64_t src_len, uint8_t* dst,
                             int64_t dst_len) {
  const size_t rc = ZSTD_decompress(dst, (size_t)dst_len, src, (size_t)src_len);
  return ZSTD_isError(rc) ? -1 : (int64_t)rc;
}

// ---------------------------------------------------------------------------
// ETC1S block expansion (Basis Universal transcode target -> RGBA8)
//
// ETC1S is the simplified ETC1 subset Basis uses: one 5:5:5 base color and
// one intensity table per 4x4 block, 2-bit selectors per texel (see
// vktf/loaders/basis.py for the container/VLC layer). The reference
// transcodes through libktx (ktx_texture.cppm:62-94); the target here is
// plain RGBA8.
// ---------------------------------------------------------------------------

static const int32_t kEtc1Modifiers[8][4] = {
    {-8, -2, 2, 8},     {-17, -5, 5, 17},   {-29, -9, 9, 29},
    {-42, -13, 13, 42}, {-60, -18, 18, 60}, {-80, -24, 24, 80},
    {-106, -33, 33, 106}, {-183, -47, 47, 183},
};

// endpoint_ids/selector_ids: (bh*bw) i32; endpoints: (E,4) i32 r5,g5,b5,inten;
// selectors: (S,16) u8 2-bit values; out: (bh*4, bw*4, 4) u8 then caller crops.
void vktf_decode_etc1s(const int32_t* endpoint_ids, const int32_t* selector_ids,
                       const int32_t* endpoints, const uint8_t* selectors,
                       int32_t bh, int32_t bw, uint8_t* out) {
  const int32_t stride = bw * 4 * 4;  // bytes per output row
  for (int32_t by = 0; by < bh; ++by) {
    for (int32_t bx = 0; bx < bw; ++bx) {
      const int32_t* ep = endpoints + 4 * endpoint_ids[by * bw + bx];
      const uint8_t* sel = selectors + 16 * selector_ids[by * bw + bx];
      const int32_t r8 = (ep[0] << 3) | (ep[0] >> 2);
      const int32_t g8 = (ep[1] << 3) | (ep[1] >> 2);
      const int32_t b8 = (ep[2] << 3) | (ep[2] >> 2);
      const int32_t* mods = kEtc1Modifiers[ep[3] & 7];
      for (int32_t y = 0; y < 4; ++y) {
        uint8_t* row = out + (by * 4 + y) * stride + bx * 16;
        for (int32_t x = 0; x < 4; ++x) {
          const int32_t m = mods[sel[y * 4 + x] & 3];
          row[4 * x + 0] = (uint8_t)std::min(std::max(r8 + m, 0), 255);
          row[4 * x + 1] = (uint8_t)std::min(std::max(g8 + m, 0), 255);
          row[4 * x + 2] = (uint8_t)std::min(std::max(b8 + m, 0), 255);
          row[4 * x + 3] = 255;
        }
      }
    }
  }
}

int32_t vktf_native_abi_version() { return 2; }

}  // extern "C"
