"""Shared scene-building helpers for renderer tests."""

import numpy as np

from vktf.config import RenderConfig
from vktf.loaders.gltf import load_gltf
from vktf.mathx import Camera, ViewFrustumParams
from vktf.ops.pipeline import make_frame_fn
from vktf.ops.raster_xla import SAMPLE_OFFSETS
from vktf.ops.reference import ReferenceScene, render_reference
from vktf.scene.flatten import flatten_assets


def checker_png_bytes(size=16, a=(220, 40, 40, 255), b=(40, 40, 220, 255), cell=4):
    import io

    from PIL import Image

    img = np.zeros((size, size, 4), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx // cell) + (yy // cell)) % 2 == 0
    img[mask] = a
    img[~mask] = b
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def normal_map_png_bytes(size=16):
    """Mild bumpy normal map (linear-space RGB encoding of tangent normals)."""
    import io

    from PIL import Image

    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64)
    nx = 0.3 * np.sin(2 * np.pi * xx / size)
    ny = 0.3 * np.cos(2 * np.pi * yy / size)
    nz = np.sqrt(np.clip(1.0 - nx * nx - ny * ny, 0.0, 1.0))
    img = np.stack(
        [
            ((nx * 0.5 + 0.5) * 255).astype(np.uint8),
            ((ny * 0.5 + 0.5) * 255).astype(np.uint8),
            ((nz * 0.5 + 0.5) * 255).astype(np.uint8),
            np.full_like(xx, 255, dtype=np.uint8),
        ],
        axis=-1,
    )
    buf = io.BytesIO()
    Image.fromarray(img, "RGBA").save(buf, format="PNG")
    return buf.getvalue()


def build_scene(path):
    asset = load_gltf(path)
    return flatten_assets([asset])


def make_reference(scene, meta, aux):
    entries = aux["texture_entries"]
    levels = [t.levels for t, _ in entries]
    tex_meta = []
    for t, sampler in entries:
        m = dict(sampler)
        m["srgb"] = t.srgb
        tex_meta.append(m)
    return ReferenceScene(scene, meta, levels, tex_meta)


def default_camera(aspect=1.0, position=(0.0, 0.6, 2.2), direction=(0.0, -0.2, -1.0)):
    return Camera(position, direction, ViewFrustumParams(np.radians(45.0), aspect, 0.1, 100.0))


def render_both(path, width=64, height=64, msaa=1, camera=None, backend="tiled",
                shading_rate="sample"):
    scene, meta, aux = build_scene(path)
    camera = camera or default_camera(aspect=width / height)
    config = RenderConfig(
        width=width, height=height, msaa_samples=msaa, tile_shape=(32, 64),
        backend=backend, pallas_chunk=128, shading_rate=shading_rate,
    )
    frame_fn = make_frame_fn(meta, config)
    produced = np.moveaxis(  # device output is planar (3, H, W) RGB
        np.asarray(frame_fn(scene, camera.view_projection_transform, camera.position)),
        0,
        -1,
    )
    ref_scene = make_reference(scene, meta, aux)
    expected = render_reference(
        ref_scene,
        camera.view_projection_transform,
        camera.position,
        width,
        height,
        SAMPLE_OFFSETS[msaa],
        max_anisotropy=config.max_anisotropy,
        peel_layers=max(meta.peel_layers, 2),
    )
    return produced, expected


def assert_images_close(produced, expected, max_mean=2.0, max_outlier_frac=0.015, tol=8):
    diff = np.abs(
        produced[..., :3].astype(np.int32) - expected[..., :3].astype(np.int32)
    )
    mean = diff.mean()
    outliers = (diff.max(axis=-1) > tol).mean()
    assert mean <= max_mean, f"mean abs diff {mean:.3f} > {max_mean}"
    assert outliers <= max_outlier_frac, (
        f"{outliers * 100:.2f}% pixels differ by more than {tol}"
    )
