"""Device-side present encoding: shrink the frame before it leaves HBM.

The reference presents through a zero-copy swapchain (engine.cppm:556-562)
— its present cost is a pointer flip. Here the frame crosses a host link
(PCIe locally, a network link for remote viewing), so the present path's
cost is BYTES LEAVING THE DEVICE. A planar (3, H, W) uint8 RGB frame is
6.2 MB at 1080p.

``encode_yuv420`` is a jitted device stage that converts the frame to
BT.601 full-range YCbCr with 2x2-subsampled chroma, packed into ONE flat
uint8 array of 1.5 bytes/px — halving present traffic for visually
near-lossless output (luma is exact to integer rounding; gray content
round-trips bit-exact, see tests). ``decode_yuv420`` is the numpy host-side
inverse the engine applies before handing the frame to the window sinks.

All math is exact integer arithmetic (x256 fixed-point coefficients,
arithmetic shifts) so the device encode and the numpy oracle are
bit-identical — golden-testable without tolerances, like every other stage.

Opt-in via RenderConfig.present_format ("rgb" default keeps the exact
planar frame); the game CLI exposes --present-format. Beyond the
reference's surface (its swapchain never pays a link), hence off by
default.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# x256 fixed-point BT.601 full-range coefficients. Rows sum to 256 (luma) /
# 0 (chroma), so gray input yields Y == gray exactly and Cb == Cr == 128.
_YR, _YG, _YB = 77, 150, 29
_CBR, _CBG, _CBB = -43, -85, 128
_CRR, _CRG, _CRB = 128, -107, -21
# decode: x256 fixed point of 1.402 / (0.344136, 0.714136) / 1.772
_RCR = 359
_GCB, _GCR = 88, 183
_BCB = 454


def encoded_size(height: int, width: int) -> int:
    """Packed byte count of one yuv420 frame (H, W must be even)."""
    return height * width + 2 * (height // 2) * (width // 2)


def downsample_box(frame, scale: int):
    """Planar (3, H, W) uint8 -> (3, H/scale, W/scale) uint8 device-side
    box average (exact integer, round-half-up) — the PREVIEW stream
    reduction. scale must divide H and W. jnp/np dual like encode_yuv420,
    so this function is its own numpy oracle."""
    if scale == 1:
        return frame
    xp = jnp if isinstance(frame, jnp.ndarray) else np
    c, h, w = frame.shape
    assert h % scale == 0 and w % scale == 0, (frame.shape, scale)
    q = frame.astype(xp.int32).reshape(c, h // scale, scale, w // scale, scale)
    n = scale * scale
    return ((q.sum(axis=(2, 4)) + n // 2) // n).astype(xp.uint8)


def upsample_nearest(frame: np.ndarray, scale: int, *,
                     planar: bool = True) -> np.ndarray:
    """Host-side nearest 2x/4x upsample of a preview frame back to window
    size (numpy). Layout is EXPLICIT (inferring it from
    frame.shape[0] misreads an interleaved frame of height 3 or 4):
    planar=True (the present chain's (C, H, W) form, what both production
    callers pass) upsamples the trailing two axes; planar=False an
    interleaved (H, W, C) frame's leading two."""
    if scale == 1:
        return frame
    axes = (-2, -1) if planar else (0, 1)
    out = np.repeat(frame, scale, axis=axes[0])
    return np.repeat(out, scale, axis=axes[1])


def make_present_encoder(config):
    """Device-side present encode chain for a RenderConfig: preview
    downsample (present_scale) then optional yuv420 pack. Fused into the
    frame's final jitted stage by the callers (ops/pipeline.py,
    parallel/tiles.py) so it costs no extra program launch. The EXACT
    full-resolution frame remains available via Scene.render_still()."""
    scale = getattr(config, "present_scale", 1)
    yuv = config.present_format == "yuv420"

    def encode(frame):
        out = downsample_box(frame, scale)
        return encode_yuv420(out) if yuv else out

    return encode


def decode_present(frame: np.ndarray, config) -> np.ndarray:
    """Host-side inverse of make_present_encoder: yuv decode at preview
    resolution, then nearest upsample to the full window size."""
    scale = getattr(config, "present_scale", 1)
    ph, pw = config.height // scale, config.width // scale
    if config.present_format == "yuv420":
        frame = decode_yuv420(frame, ph, pw)
    return upsample_nearest(frame, scale)


def encode_yuv420(frame):
    """Planar (3, H, W) uint8 RGB -> packed (H*W*3//2,) uint8 [Y | Cb | Cr].

    Chroma is computed from the 2x2 box-averaged RGB (rounding +2 >> 2),
    then converted — equivalent to JPEG's convert-then-average up to
    rounding, one conversion per chroma site instead of four. jnp and numpy
    both use arithmetic right shifts on int32, so this function is its own
    numpy oracle when handed a numpy array.
    """
    xp = jnp if isinstance(frame, jnp.ndarray) else np
    c, h, w = frame.shape
    assert c == 3 and h % 2 == 0 and w % 2 == 0, frame.shape
    rgb = frame.astype(xp.int32)
    r, g, b = rgb[0], rgb[1], rgb[2]
    y = (_YR * r + _YG * g + _YB * b + 128) >> 8  # in [0, 255] by row sum
    # 2x2 box average per channel (exact integer, round-half-up)
    def box(ch):
        q = ch.reshape(h // 2, 2, w // 2, 2)
        return (q.sum(axis=(1, 3)) + 2) >> 2

    r2, g2, b2 = box(r), box(g), box(b)
    cb = 128 + ((_CBR * r2 + _CBG * g2 + _CBB * b2 + 128) >> 8)
    cr = 128 + ((_CRR * r2 + _CRG * g2 + _CRB * b2 + 128) >> 8)
    cb = xp.clip(cb, 0, 255)
    cr = xp.clip(cr, 0, 255)
    return xp.concatenate(
        [y.reshape(-1), cb.reshape(-1), cr.reshape(-1)]
    ).astype(xp.uint8)


def decode_yuv420(packed: np.ndarray, height: int, width: int) -> np.ndarray:
    """Packed yuv420 bytes -> planar (3, H, W) uint8 RGB (numpy, host side).

    Chroma upsamples by 2x2 replication (nearest). Inverse of encode up to
    chroma subsampling and integer rounding; bit-exact on gray content.
    """
    n_y = height * width
    n_c = (height // 2) * (width // 2)
    assert packed.size == n_y + 2 * n_c, (packed.size, height, width)
    y = packed[:n_y].reshape(height, width).astype(np.int32)
    cb = packed[n_y:n_y + n_c].reshape(height // 2, width // 2)
    cr = packed[n_y + n_c:].reshape(height // 2, width // 2)

    def up(ch):
        return np.repeat(np.repeat(ch, 2, axis=0), 2, axis=1).astype(np.int32) - 128

    cbu, cru = up(cb), up(cr)
    r = y + ((_RCR * cru + 128) >> 8)
    g = y - ((_GCB * cbu + _GCR * cru + 128) >> 8)
    b = y + ((_BCB * cbu + 128) >> 8)
    out = np.stack([r, g, b], axis=0)
    return np.clip(out, 0, 255).astype(np.uint8)
