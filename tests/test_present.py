"""Present encoding (ops/present.py): device/oracle equality + fidelity.

The yuv420 present path is OPT-IN and lossy (chroma 2x2 subsample), so the
tests pin (a) the jitted device encode bit-equal to the numpy oracle (the
function is its own oracle — exact integer math), (b) exact invariants
(gray round-trips bit-exact, luma exact), and (c) a PSNR floor end-to-end
through Engine/Window against the exact rgb present of the same scene.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from vktf.config import RenderConfig
from vktf.engine import Engine
from vktf.ops.present import decode_yuv420, encode_yuv420, encoded_size
from vktf.window import Window

from vktf.models.gltf_writer import GltfWriter
from vktf.models.primitives import box_mesh


def _psnr(a, b):
    err = (a.astype(np.float64) - b.astype(np.float64)) ** 2
    mse = err.mean()
    return np.inf if mse == 0 else 10.0 * np.log10(255.0**2 / mse)


def _frame(h, w, seed=0):
    rng = np.random.default_rng(seed)
    # smooth gradients + a hard edge: chroma subsampling is exercised on
    # both friendly and hostile content
    y, x = np.mgrid[:h, :w]
    r = (x * 255 // max(w - 1, 1)).astype(np.uint8)
    g = (y * 255 // max(h - 1, 1)).astype(np.uint8)
    b = rng.integers(0, 256, (h, w), dtype=np.uint8)
    b[:, : w // 2] = 30
    return np.stack([r, g, b])


def test_device_encode_matches_numpy_oracle():
    frame = _frame(32, 64, seed=1)
    dev = np.asarray(jax.jit(encode_yuv420)(jnp.asarray(frame)))
    host = encode_yuv420(frame)
    assert dev.dtype == np.uint8
    assert dev.shape == (encoded_size(32, 64),)
    np.testing.assert_array_equal(dev, host)


def test_gray_roundtrips_bit_exact():
    # R == G == B: luma is the exact gray value, chroma lands on 128, and
    # the decode reconstructs every channel bit-exactly
    ramp = np.tile(np.arange(256, dtype=np.uint8), (2, 1))[None].repeat(3, 0)
    ramp = np.ascontiguousarray(ramp)  # (3, 2, 256)
    out = decode_yuv420(encode_yuv420(ramp), 2, 256)
    np.testing.assert_array_equal(out, ramp)


def test_roundtrip_psnr_floor():
    # smooth content (real renders): chroma subsampling is near-invisible
    y, x = np.mgrid[:64, :128]
    smooth = np.stack([
        (x * 255 // 127).astype(np.uint8),
        (y * 255 // 63).astype(np.uint8),
        np.full((64, 128), 90, np.uint8),
    ])
    out = decode_yuv420(encode_yuv420(smooth), 64, 128)
    assert _psnr(out, smooth) > 40.0
    # pathological content (per-pixel random hue — worst case for 4:2:0)
    # still holds a sanity floor; real frames sit between these bounds
    noisy = _frame(64, 128, seed=2)
    out = decode_yuv420(encode_yuv420(noisy), 64, 128)
    assert _psnr(out, noisy) > 18.0


def test_packed_layout_is_y_cb_cr():
    frame = np.full((3, 4, 4), 200, np.uint8)  # gray 200
    packed = encode_yuv420(frame)
    assert packed[: 16].tolist() == [200] * 16  # Y plane first
    assert packed[16:].tolist() == [128] * 8  # then Cb, Cr at neutral


def test_engine_yuv420_present_end_to_end(tmp_path):
    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.8, 0.3, 0.1, 1.0),
                         metallic_factor=0.0)
    mesh = w.add_mesh(box_mesh(), material=mat)
    light = w.add_light(type="directional")
    w.add_scene([w.add_node(mesh=mesh, translation=(2, 1, 0)),
                 w.add_node(light=light)])
    path = w.write(tmp_path / "box.gltf")

    frames = {}
    for fmt in ("rgb", "yuv420"):
        config = RenderConfig(width=64, height=48, msaa_samples=1,
                              tile_shape=(16, 64), present_format=fmt)
        window = Window(width=64, height=48)
        engine = Engine(window, config)
        scene = engine.load([path])
        for _ in range(3):
            engine.render(scene)
        engine.wait_idle()
        assert window.last_frame is not None
        assert window.last_frame.shape == (48, 64, 4)
        frames[fmt] = window.last_frame
    # the decoded yuv420 present approximates the exact rgb present
    assert _psnr(frames["yuv420"][..., :3], frames["rgb"][..., :3]) > 30.0


def test_odd_dimensions_rejected():
    with pytest.raises(ValueError):
        RenderConfig(width=63, height=48, present_format="yuv420")
    with pytest.raises(ValueError):
        RenderConfig(width=64, height=48, present_format="nope")


# ---------------------------------------------------------------------------
# Preview present stream (present_scale, round 4 — VERDICT r3 #2): device
# downsample == numpy oracle; the presented window frame is the upsampled
# preview; and Scene.render_still stays BIT-EXACT to the scale-1 rgb render.
# ---------------------------------------------------------------------------


def test_downsample_box_matches_numpy_oracle():
    from vktf.ops.present import downsample_box

    frame = _frame(32, 64, seed=3)
    for scale in (1, 2, 4):
        dev = np.asarray(
            jax.jit(lambda f: downsample_box(f, scale))(jnp.asarray(frame)))
        host = downsample_box(frame, scale)
        assert dev.shape == (3, 32 // scale, 64 // scale)
        np.testing.assert_array_equal(dev, host)
    # exactness: a constant frame survives any scale bit-exactly
    const = np.full((3, 16, 32), 77, np.uint8)
    np.testing.assert_array_equal(downsample_box(const, 4),
                                  np.full((3, 4, 8), 77, np.uint8))


def test_present_scale_validation():
    with pytest.raises(ValueError):
        RenderConfig(width=64, height=48, present_scale=3)
    with pytest.raises(ValueError):
        RenderConfig(width=66, height=48, present_scale=4)
    # preview dims must stay even for yuv420: 68/2=34 even -> ok; 66/2=33 odd
    with pytest.raises(ValueError):
        RenderConfig(width=66, height=48, present_format="yuv420",
                     present_scale=2)


def _box_scene(tmp_path):
    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.8, 0.3, 0.1, 1.0),
                         metallic_factor=0.0)
    mesh = w.add_mesh(box_mesh(), material=mat)
    light = w.add_light(type="directional")
    w.add_scene([w.add_node(mesh=mesh, translation=(2, 1, 0)),
                 w.add_node(light=light)])
    return w.write(tmp_path / "box.gltf")


def test_preview_stream_end_to_end_and_exact_still(tmp_path):
    """The preview config's presented frame is EXACTLY the host-upsampled
    device downsample of the exact frame (rgb preview: no other loss), and
    Scene.render_still() under the preview config is BIT-EXACT to the
    scale-1 exact render (VERDICT r3 #2 'stills bit-exact')."""
    from vktf.ops.present import downsample_box, upsample_nearest

    path = _box_scene(tmp_path)
    exact_cfg = RenderConfig(width=64, height=48, msaa_samples=1,
                             tile_shape=(16, 64))
    preview_cfg = exact_cfg.replace(present_scale=2)

    window = Window(width=64, height=48)
    engine = Engine(window, exact_cfg)
    scene = engine.load([path])
    exact = scene.render_still()

    window2 = Window(width=64, height=48)
    engine2 = Engine(window2, preview_cfg)
    scene2 = engine2.load([path])
    for _ in range(3):
        engine2.render(scene2)
    engine2.wait_idle()
    assert window2.last_frame is not None
    assert window2.last_frame.shape == (48, 64, 4)
    expected = upsample_nearest(downsample_box(exact, 2), 2)
    np.testing.assert_array_equal(
        np.moveaxis(window2.last_frame[..., :3], -1, 0), expected)

    # the still bypasses the preview encode bit-exactly
    still = scene2.render_still()
    np.testing.assert_array_equal(still, exact)
    # and the preview+yuv combo still yields an exact still
    scene3 = Engine(Window(width=64, height=48),
                    exact_cfg.replace(present_scale=2,
                                      present_format="yuv420")).load([path])
    np.testing.assert_array_equal(scene3.render_still(), exact)
