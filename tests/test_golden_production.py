"""Pin the PRODUCTION pallas pixel-rate path with an exact golden image.

The oracle comparisons elsewhere use tolerance budgets; this test pins the
production configuration (pallas raster + shade-table deferred shading +
pixel-rate 4x MSAA resolve + K-layer peel + textures + per-slot samplers)
bit-exactly against a checked-in frame, so a regression in any production
stage fails a test instead of needing visual inspection (VERDICT r1 #7).

Interpret-mode Pallas on CPU. On the GPU, chip_smoke.py compares the same
scene with the numpy oracle at the golden tolerance.

Regenerate after an INTENDED rendering change:
    UPDATE_GOLDEN=1 python -m pytest tests/test_golden_production.py
then eyeball tests/golden/production_frame.png before committing it.
"""

import os
import pathlib

import numpy as np

from vktf.config import RenderConfig
from vktf.models.gltf_writer import GltfWriter
from vktf.models.primitives import box_mesh, plane_mesh, uv_sphere_mesh
from vktf.ops.pipeline import make_frame_fn

from helpers import build_scene, checker_png_bytes, default_camera

GOLDEN = pathlib.Path(__file__).parent / "golden" / "production_frame.png"


def _scene_path(tmp_path):
    w = GltfWriter()
    img = w.add_image_bytes(checker_png_bytes(), "image/png")
    tex = w.add_texture(img, w.add_sampler())
    textured = w.add_material(base_color_factor=(1.0, 1.0, 1.0, 1.0),
                              base_color_texture=tex, metallic_factor=0.1,
                              roughness_factor=0.6)
    shiny = w.add_material(base_color_factor=(0.2, 0.4, 0.9, 1.0),
                           metallic_factor=0.9, roughness_factor=0.25)
    blend = w.add_material(base_color_factor=(0.9, 0.3, 0.2, 0.45),
                           metallic_factor=0.0, roughness_factor=0.5,
                           alpha_mode="BLEND")
    floor = w.add_material(base_color_factor=(0.5, 0.5, 0.45, 1.0),
                           roughness_factor=0.9)
    parts = [
        w.add_node(mesh=w.add_mesh(box_mesh(0.5), material=textured),
                   translation=(-0.45, 0.25, 0.0),
                   rotation=(0.0, 0.2588, 0.0, 0.9659)),
        w.add_node(mesh=w.add_mesh(uv_sphere_mesh(0.3, rings=16, sectors=32),
                                   material=shiny),
                   translation=(0.5, 0.3, 0.2)),
        w.add_node(mesh=w.add_mesh(plane_mesh(0.8), material=blend),
                   translation=(0.0, 0.4, 0.8),
                   rotation=(0.7071068, 0.0, 0.0, 0.7071068)),
        w.add_node(mesh=w.add_mesh(plane_mesh(4.0), material=floor)),
        w.add_node(light=w.add_light("point", color=(5.0, 5.0, 5.0)),
                   translation=(1.5, 2.0, 2.0)),
        w.add_node(light=w.add_light("directional", color=(0.8, 0.8, 0.7)),
                   rotation=(0.3827, 0.0, 0.0, 0.9239)),
    ]
    w.add_scene(parts)
    return w.write(tmp_path / "golden_scene.gltf")


def test_production_frame_matches_golden(tmp_path):
    from PIL import Image

    scene, meta, _aux = build_scene(_scene_path(tmp_path))
    config = RenderConfig(
        width=256, height=128, msaa_samples=4, shading_rate="pixel",
        backend="pallas", pallas_interpret=True, tile_shape=(32, 64),
        pallas_chunk=128,
    )
    camera = default_camera(aspect=2.0, position=(0.0, 0.7, 2.4),
                            direction=(0.0, -0.25, -1.0))
    frame_fn = make_frame_fn(meta, config)
    out = np.asarray(
        frame_fn(scene, camera.view_projection_transform, camera.position)
    )  # (3, H, W) u8
    produced = np.moveaxis(out, 0, -1)

    if os.environ.get("UPDATE_GOLDEN"):
        GOLDEN.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(produced, "RGB").save(GOLDEN)
        raise AssertionError(
            f"golden regenerated at {GOLDEN}; inspect and commit it, then "
            "rerun without UPDATE_GOLDEN"
        )
    assert GOLDEN.exists(), "golden missing; run with UPDATE_GOLDEN=1"
    expected = np.asarray(Image.open(GOLDEN).convert("RGB"))
    np.testing.assert_array_equal(produced, expected)
