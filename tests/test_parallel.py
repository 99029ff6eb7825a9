"""Multi-chip sharded rendering vs the single-chip pipeline.

Runs on the virtual 8-device CPU mesh (conftest). The sharded frame runs the
PRODUCTION pipeline (Pallas streaming rasterizer in interpret mode +
shade-table deferred shading) and must be bit-identical to the single-chip
pallas backend: sort-last compositing reproduces the lexicographic
(depth, draw-order) rule, and sort-first band sharding is a pure work
partition.
"""

import numpy as np
import jax
import pytest

from vktf.config import RenderConfig
from vktf.models.gltf_writer import GltfWriter
from vktf.models.primitives import box_mesh, uv_sphere_mesh
from vktf.ops.pipeline import make_frame_fn
from vktf.parallel import make_render_mesh, make_sharded_frame_fn

from helpers import build_scene, default_camera


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("parallel")
    w = GltfWriter()
    red = w.add_material(base_color_factor=(0.8, 0.1, 0.1, 1.0), roughness_factor=0.7)
    blue = w.add_material(base_color_factor=(0.1, 0.2, 0.8, 1.0), metallic_factor=0.8)
    box = w.add_mesh(box_mesh(), material=red)
    ball = w.add_mesh(uv_sphere_mesh(0.4, rings=12, sectors=24), material=blue)
    light = w.add_light(type="directional")
    point = w.add_light(type="point", color=(4.0, 4.0, 4.0))
    w.add_scene(
        [
            w.add_node(mesh=box, translation=(-0.5, 0.0, 0.0), rotation=(0, 0.2588, 0, 0.9659)),
            w.add_node(mesh=ball, translation=(0.45, 0.1, 0.3)),
            w.add_node(light=light, rotation=(0.3827, 0.0, 0.0, 0.9239)),
            w.add_node(light=point, translation=(1.0, 1.0, 1.5)),
        ]
    )
    return build_scene(w.write(tmp_path / "scene.gltf"))


def _render_single(scene, meta, config, camera):
    fn = make_frame_fn(meta, config)
    return np.asarray(fn(scene, camera.view_projection_transform, camera.position))


def _render_sharded(scene, meta, config, camera, gp):
    mesh = make_render_mesh(jax.devices(), gp=gp)
    fn = make_sharded_frame_fn(meta, config, mesh)
    return np.asarray(fn(scene, camera.view_projection_transform, camera.position))


@pytest.mark.parametrize("gp", [1, 2, 8])
def test_sharded_matches_single_chip(small_scene, gp):
    scene, meta, aux = small_scene
    config = RenderConfig(width=96, height=64, msaa_samples=2,
                          tile_shape=(32, 64), backend="pallas")
    camera = default_camera(aspect=96 / 64)
    single = _render_single(scene, meta, config, camera)
    sharded = _render_sharded(scene, meta, config, camera, gp)
    assert single.shape == sharded.shape == (3, 64, 96)
    np.testing.assert_array_equal(single, sharded)


@pytest.fixture(scope="module")
def blend_scene(tmp_path_factory):
    """Three stacked BLEND quads over an opaque floor: peel_layers == 4,
    exercising the sharded K-round head merge in render_frame_sharded."""
    tmp_path = tmp_path_factory.mktemp("parallel_blend")
    w = GltfWriter()
    from vktf.models.primitives import plane_mesh

    opaque = w.add_material(base_color_factor=(0.7, 0.7, 0.2, 1.0),
                            roughness_factor=0.8)
    glass = [
        w.add_material(base_color_factor=c, alpha_mode="BLEND",
                       roughness_factor=0.4)
        for c in ((0.9, 0.2, 0.2, 0.45), (0.2, 0.9, 0.2, 0.5),
                  (0.2, 0.2, 0.9, 0.55))
    ]
    face = (0.7071068, 0.0, 0.0, 0.7071068)  # plane +y normal -> +z
    w.add_scene(
        [
            w.add_node(mesh=w.add_mesh(plane_mesh(0.9), material=glass[0]),
                       translation=(0.0, 0.0, 0.6), rotation=face),
            w.add_node(mesh=w.add_mesh(plane_mesh(0.9), material=glass[1]),
                       translation=(0.1, 0.05, 0.3), rotation=face),
            w.add_node(mesh=w.add_mesh(plane_mesh(0.9), material=glass[2]),
                       translation=(-0.1, -0.05, 0.0), rotation=face),
            w.add_node(mesh=w.add_mesh(box_mesh(0.5), material=opaque),
                       translation=(0.0, 0.0, -0.6)),
            w.add_node(light=w.add_light(type="point", color=(6.0, 6.0, 6.0)),
                       translation=(0.5, 1.0, 2.0)),
        ]
    )
    return build_scene(w.write(tmp_path / "blend.gltf"))


@pytest.mark.parametrize("gp", [2, 4])
def test_sharded_depth_peel_matches_single_chip(blend_scene, gp):
    scene, meta, aux = blend_scene
    assert meta.peel_layers == 4
    config = RenderConfig(width=96, height=64, msaa_samples=2,
                          tile_shape=(32, 64), backend="pallas")
    camera = default_camera(aspect=96 / 64)
    single = _render_single(scene, meta, config, camera)
    sharded = _render_sharded(scene, meta, config, camera, gp)
    np.testing.assert_array_equal(single, sharded)


@pytest.fixture(scope="module")
def mixed_sampler_scene(tmp_path_factory):
    """A material whose three textures carry DIFFERENT samplers (repeat /
    clamp / mirrored+nearest, uvs leaving [0,1]) so SceneMeta.mixed_samplers
    is set and the sharded frame takes the assembled XLA per-slot fallback
    branch in render_frame_sharded (parallel/tiles.py) instead of the
    unified slice shade (reference binds an independent sampler per
    combined image-sampler, material.cppm:138-171)."""
    from vktf.models.primitives import plane_mesh

    from helpers import checker_png_bytes

    tmp_path = tmp_path_factory.mktemp("parallel_mixed")
    w = GltfWriter()
    base_img = w.add_image_bytes(checker_png_bytes(32, cell=8), "image/png")
    mr_img = w.add_image_bytes(
        checker_png_bytes(32, a=(40, 200, 120, 255), b=(200, 60, 60, 255),
                          cell=16), "image/png")
    nrm_img = w.add_image_bytes(
        checker_png_bytes(32, a=(128, 128, 255, 255),
                          b=(180, 100, 230, 255), cell=16), "image/png")
    s_repeat = w.add_sampler(wrap_s=10497, wrap_t=10497)
    s_clamp = w.add_sampler(wrap_s=33071, wrap_t=33071)
    s_mirror_nearest = w.add_sampler(mag=9728, wrap_s=33648, wrap_t=33648)
    mat = w.add_material(
        base_color_texture=w.add_texture(base_img, s_repeat),
        metallic_roughness_texture=w.add_texture(mr_img, s_clamp),
        normal_texture=w.add_texture(nrm_img, s_mirror_nearest),
        metallic_factor=0.4, roughness_factor=0.7,
    )
    geom = plane_mesh(3.0)
    geom["uvs"] = geom["uvs"] * 2.5 - 0.75  # leave [0,1]: wraps diverge
    sun = w.add_light("directional", color=(2.5, 2.5, 2.5))
    w.add_scene([
        w.add_node(mesh=w.add_mesh(geom, material=mat),
                   translation=(0.0, 0.0, -1.2)),
        w.add_node(light=sun, rotation=(-0.3827, 0.0, 0.0, 0.9239)),
    ])
    return build_scene(w.write(tmp_path / "mixed.gltf"))


@pytest.mark.parametrize("gp", [2, 4])
def test_sharded_mixed_samplers_match_single_chip(mixed_sampler_scene, gp):
    """Bit-equality of the sharded frame vs the single-device pipeline for
    a mixed-sampler scene (per-slot pool gathers in the shade)."""
    scene, meta, aux = mixed_sampler_scene
    assert meta.mixed_samplers, "fixture must set the static flag"
    config = RenderConfig(width=96, height=64, msaa_samples=2,
                          tile_shape=(32, 64), backend="pallas")
    from helpers import default_camera as _cam

    camera = _cam(position=(0.0, 1.6, 1.8), direction=(0.0, -0.7, -1.0),
                  aspect=96 / 64)
    single = _render_single(scene, meta, config, camera)
    sharded = _render_sharded(scene, meta, config, camera, gp)
    assert single.shape == sharded.shape == (3, 64, 96)
    np.testing.assert_array_equal(single, sharded)


def test_sharded_msaa4_uneven_tiles(small_scene):
    """Tile count not divisible by sp (3x2=6 tiles over sp=4) + 4x MSAA."""
    scene, meta, aux = small_scene
    config = RenderConfig(width=128, height=96, msaa_samples=4,
                          tile_shape=(32, 64), backend="pallas")
    camera = default_camera(aspect=128 / 96)
    single = _render_single(scene, meta, config, camera)
    sharded = _render_sharded(scene, meta, config, camera, gp=2)
    np.testing.assert_array_equal(single, sharded)


def test_sharded_preview_encode_matches_single_chip(small_scene):
    """The sharded frame applies the SAME device-side present encode chain
    (preview downsample + yuv420 pack) as the single-chip program — the
    encoded streams must be bit-identical (round-4 preview stream)."""
    scene, meta, aux = small_scene
    config = RenderConfig(width=96, height=64, msaa_samples=2,
                          tile_shape=(32, 64), backend="pallas",
                          present_format="yuv420", present_scale=2)
    camera = default_camera(aspect=96 / 64)
    single = _render_single(scene, meta, config, camera)
    sharded = _render_sharded(scene, meta, config, camera, gp=2)
    from vktf.ops.present import encoded_size

    assert single.shape == sharded.shape == (encoded_size(32, 48),)
    np.testing.assert_array_equal(single, sharded)


@pytest.mark.parametrize("gp", [2, 4])
def test_sharded_sample_rate_matches_single_chip(blend_scene, gp):
    """Sample-rate shading takes the sharded row-slice branch
    (pallas_shade_resolve per gp rank) and stays bit-equal to the single
    device, peel layers included."""
    scene, meta, aux = blend_scene
    config = RenderConfig(width=96, height=64, msaa_samples=2,
                          tile_shape=(32, 64), backend="pallas",
                          shading_rate="sample")
    from helpers import default_camera as _cam

    camera = _cam(aspect=96 / 64)
    single = _render_single(scene, meta, config, camera)
    sharded = _render_sharded(scene, meta, config, camera, gp)
    assert (single.sum(axis=0) > 0).any()
    np.testing.assert_array_equal(single, sharded)
