"""Golden-image tests: the jitted JAX pipeline vs the independent numpy
reference renderer, over the BASELINE.json config ladder (Box → textured →
full PBR → hierarchy/MSAA) at small resolutions."""

import numpy as np
import pytest

from vktf.models.gltf_writer import GltfWriter
from vktf.models.primitives import box_mesh, plane_mesh, uv_sphere_mesh

from helpers import (
    assert_images_close,
    checker_png_bytes,
    default_camera,
    normal_map_png_bytes,
    render_both,
)


def test_box_flat_color(tmp_path):
    """BASELINE config 1: Box, baseColorFactor only, directional light."""
    w = GltfWriter()
    mat = w.add_material(
        base_color_factor=(0.8, 0.1, 0.1, 1.0), metallic_factor=0.0, roughness_factor=0.9
    )
    mesh = w.add_mesh(box_mesh(), material=mat)
    light = w.add_light(type="directional")
    w.add_scene(
        [
            w.add_node(mesh=mesh, rotation=(0.0, 0.2588, 0.0, 0.9659)),  # 30 deg yaw
            w.add_node(light=light, rotation=(0.3827, 0.0, 0.0, 0.9239)),
        ]
    )
    produced, expected = render_both(w.write(tmp_path / "box.gltf"))
    assert produced[..., 0].max() > 30  # something visibly red rendered
    assert_images_close(produced, expected)


def test_textured_quad_bilinear(tmp_path):
    """BASELINE config 2 (Duck-like): textured mesh, bilinear + depth."""
    w = GltfWriter()
    img = w.add_image_bytes(checker_png_bytes(16), "image/png")
    sampler = w.add_sampler()
    tex = w.add_texture(img, sampler=sampler)
    mat = w.add_material(
        base_color_texture=tex, metallic_factor=0.0, roughness_factor=1.0
    )
    mesh = w.add_mesh(plane_mesh(size=1.6), material=mat)
    light = w.add_light(type="point", color=(3.0, 3.0, 3.0))
    w.add_scene(
        [
            w.add_node(mesh=mesh, rotation=(0.5, 0.0, 0.0, 0.8660)),  # tilt toward camera
            w.add_node(light=light, translation=(0.5, 1.0, 1.5)),
        ]
    )
    produced, expected = render_both(w.write(tmp_path / "quad.gltf"))
    assert produced[..., 2].max() > 30  # blue checker cells visible
    assert_images_close(produced, expected)


def test_sphere_full_pbr(tmp_path):
    """BASELINE config 3 (Helmet-like): PBR MR + normal mapping, 2 lights."""
    w = GltfWriter()
    base_img = w.add_image_bytes(checker_png_bytes(16, a=(200, 160, 60, 255), b=(60, 60, 70, 255)), "image/png")
    normal_img = w.add_image_bytes(normal_map_png_bytes(16), "image/png")
    sampler = w.add_sampler()
    base_tex = w.add_texture(base_img, sampler=sampler)
    normal_tex = w.add_texture(normal_img, sampler=sampler)
    mat = w.add_material(
        base_color_texture=base_tex,
        normal_texture=normal_tex,
        normal_scale=0.8,
        metallic_factor=0.7,
        roughness_factor=0.4,
    )
    mesh = w.add_mesh(uv_sphere_mesh(radius=0.7, rings=8, sectors=12), material=mat)
    sun = w.add_light(type="directional", color=(2.0, 2.0, 1.8))
    point = w.add_light(type="point", color=(4.0, 1.0, 1.0))
    w.add_scene(
        [
            w.add_node(mesh=mesh),
            w.add_node(light=sun, rotation=(0.3827, 0.0, 0.0, 0.9239)),
            w.add_node(light=point, translation=(1.2, 0.8, 1.2)),
        ]
    )
    produced, expected = render_both(
        w.write(tmp_path / "sphere.gltf"),
        camera=default_camera(position=(0.0, 0.2, 2.0), direction=(0.0, -0.1, -1.0)),
    )
    assert produced[..., :3].max() > 40
    assert_images_close(produced, expected, max_mean=2.5, max_outlier_frac=0.02)


def test_hierarchy_two_instances_msaa(tmp_path):
    """BASELINE config 4 (Sponza-like, miniature): node hierarchy, shared
    mesh instanced twice, multiple materials, 4x MSAA."""
    w = GltfWriter()
    red = w.add_material(base_color_factor=(0.8, 0.2, 0.2, 1.0), metallic_factor=0.0, roughness_factor=0.6)
    blue = w.add_material(base_color_factor=(0.2, 0.2, 0.8, 1.0), metallic_factor=0.3, roughness_factor=0.3)
    box_red = w.add_mesh(box_mesh(), material=red)
    box_blue = w.add_mesh(box_mesh(0.3), material=blue)
    floor_mat = w.add_material(base_color_factor=(0.4, 0.4, 0.4, 1.0), metallic_factor=0.0, roughness_factor=0.9)
    floor = w.add_mesh(plane_mesh(size=4.0), material=floor_mat)
    child = w.add_node(mesh=box_blue, translation=(0.0, 0.8, 0.0))
    parent = w.add_node(mesh=box_red, translation=(-0.4, 0.0, 0.0), children=[child])
    other = w.add_node(mesh=box_blue, translation=(0.8, -0.2, 0.3))
    floor_node = w.add_node(mesh=floor, translation=(0.0, -0.5, 0.0))
    sun = w.add_light(type="directional", color=(2.5, 2.5, 2.3))
    w.add_scene(
        [parent, other, floor_node, w.add_node(light=sun, rotation=(0.46, 0.18, 0.0, 0.87))]
    )
    produced, expected = render_both(w.write(tmp_path / "mini.gltf"), msaa=4)
    assert_images_close(produced, expected, max_mean=2.5, max_outlier_frac=0.02)


def test_depth_occlusion(tmp_path):
    """Near quad must occlude far quad regardless of draw order."""
    w = GltfWriter()
    red = w.add_material(base_color_factor=(1.0, 0.0, 0.0, 1.0), metallic_factor=0.0, roughness_factor=1.0)
    green = w.add_material(base_color_factor=(0.0, 1.0, 0.0, 1.0), metallic_factor=0.0, roughness_factor=1.0)
    far_mesh = w.add_mesh(plane_mesh(size=2.0, normal_axis="z"), material=red)
    near_mesh = w.add_mesh(plane_mesh(size=1.0, normal_axis="z"), material=green)
    # draw far AFTER near (node order) — depth test must still favor near
    near_node = w.add_node(mesh=near_mesh, translation=(0.0, 0.0, 0.5))
    far_node = w.add_node(mesh=far_mesh, translation=(0.0, 0.0, -0.5))
    light = w.add_light(type="directional", color=(3.0, 3.0, 3.0))
    # light looking along -z so facing quads are lit: node +z column toward camera
    w.add_scene([near_node, far_node, w.add_node(light=light)])
    produced, expected = render_both(
        w.write(tmp_path / "depth.gltf"),
        camera=default_camera(position=(0.0, 0.0, 2.5), direction=(0.0, 0.0, -1.0)),
    )
    h, wdt = produced.shape[:2]
    center = produced[h // 2, wdt // 2]
    assert center[1] > 60 and center[0] < 40  # green wins in the center
    corner_band = produced[h // 8, wdt // 2]
    assert corner_band[0] > 60 and corner_band[1] < 40  # red visible around it
    assert_images_close(produced, expected)
