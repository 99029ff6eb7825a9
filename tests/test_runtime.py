"""Program registry + persistent compile cache (runtime.cache)."""

import numpy as np

from vktf.config import RenderConfig
from vktf.models.gltf_writer import GltfWriter
from vktf.models.primitives import box_mesh
from vktf.runtime import enable_persistent_cache, frame_program, program_cache_info, warmup

from helpers import build_scene, default_camera


def _tiny_scene(tmp_path):
    w = GltfWriter()
    mesh = w.add_mesh(box_mesh(), material=w.add_material())
    w.add_scene([w.add_node(mesh=mesh), w.add_node(light=w.add_light())])
    return build_scene(w.write(tmp_path / "t.gltf"))


def test_frame_program_registry_reuses(tmp_path):
    scene, meta, aux = _tiny_scene(tmp_path)
    config = RenderConfig(width=64, height=32, msaa_samples=1, tile_shape=(32, 64))
    fn1 = frame_program(meta, config)
    fn2 = frame_program(meta, config)
    assert fn1 is fn2  # same scene shape + config -> same compiled program
    other = frame_program(meta, config.replace(msaa_samples=2))
    assert other is not fn1
    assert program_cache_info()["programs"] >= 2


def test_warmup_compiles_and_renders(tmp_path):
    scene, meta, aux = _tiny_scene(tmp_path)
    config = RenderConfig(width=64, height=32, msaa_samples=1, tile_shape=(32, 64))
    camera = default_camera(aspect=2.0)
    secs = warmup(scene, meta, config, camera.view_projection_transform, camera.position)
    assert secs >= 0.0
    out = np.asarray(
        frame_program(meta, config)(
            scene, camera.view_projection_transform, camera.position
        )
    )
    assert out.shape == (3, 32, 64)


def test_persistent_cache_dir_created(tmp_path):
    d = enable_persistent_cache()  # idempotent; already on via other tests
    assert isinstance(d, str)
