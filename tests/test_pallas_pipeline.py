"""Golden-image tests of the production frame path (Pallas raster kernel +
shade-table deferred shading) against the independent numpy reference —
the same harness as test_golden.py with backend="pallas" (interpret mode
on CPU) — plus the equivalences its stages rest on."""

import numpy as np

from vktf.models.gltf_writer import GltfWriter
from vktf.models.primitives import box_mesh, plane_mesh, uv_sphere_mesh

from helpers import (
    assert_images_close,
    checker_png_bytes,
    default_camera,
    normal_map_png_bytes,
    render_both,
)


def test_pallas_flat_color_box(tmp_path):
    w = GltfWriter()
    mat = w.add_material(
        base_color_factor=(0.1, 0.7, 0.2, 1.0), metallic_factor=0.0, roughness_factor=0.8
    )
    mesh = w.add_mesh(box_mesh(), material=mat)
    w.add_scene(
        [
            w.add_node(mesh=mesh, rotation=(0.0, 0.2588, 0.0, 0.9659)),
            w.add_node(light=w.add_light(type="directional"), rotation=(0.3827, 0, 0, 0.9239)),
        ]
    )
    produced, expected = render_both(w.write(tmp_path / "box.gltf"), backend="pallas")
    assert produced[..., 1].max() > 30
    assert_images_close(produced, expected)


def test_pallas_full_pbr_textured(tmp_path):
    """PBR + textures exercises the quad-packed material pool + shade table."""
    w = GltfWriter()
    base_img = w.add_image_bytes(
        checker_png_bytes(16, a=(200, 160, 60, 255), b=(60, 60, 70, 255)), "image/png"
    )
    normal_img = w.add_image_bytes(normal_map_png_bytes(16), "image/png")
    sampler = w.add_sampler()
    mat = w.add_material(
        base_color_texture=w.add_texture(base_img, sampler=sampler),
        normal_texture=w.add_texture(normal_img, sampler=sampler),
        normal_scale=0.8,
        metallic_factor=0.7,
        roughness_factor=0.4,
    )
    mesh = w.add_mesh(uv_sphere_mesh(radius=0.7, rings=8, sectors=12), material=mat)
    w.add_scene(
        [
            w.add_node(mesh=mesh),
            w.add_node(light=w.add_light(type="directional", color=(2.0, 2.0, 1.8)),
                       rotation=(0.3827, 0.0, 0.0, 0.9239)),
            w.add_node(light=w.add_light(type="point", color=(4.0, 1.0, 1.0)),
                       translation=(1.2, 0.8, 1.2)),
        ]
    )
    produced, expected = render_both(
        w.write(tmp_path / "sphere.gltf"),
        camera=default_camera(position=(0.0, 0.2, 2.0), direction=(0.0, -0.1, -1.0)),
        backend="pallas",
    )
    assert produced[..., :3].max() > 40
    assert_images_close(produced, expected, max_mean=2.5, max_outlier_frac=0.02)


def test_pallas_hierarchy_msaa(tmp_path):
    """Instanced hierarchy + 4x MSAA through the Pallas backend."""
    w = GltfWriter()
    red = w.add_material(base_color_factor=(0.8, 0.2, 0.2, 1.0), roughness_factor=0.6)
    blue = w.add_material(base_color_factor=(0.2, 0.2, 0.8, 1.0),
                          metallic_factor=0.3, roughness_factor=0.3)
    floor_mat = w.add_material(base_color_factor=(0.4, 0.4, 0.4, 1.0), roughness_factor=0.9)
    box_red = w.add_mesh(box_mesh(), material=red)
    box_blue = w.add_mesh(box_mesh(0.3), material=blue)
    floor = w.add_mesh(plane_mesh(size=4.0), material=floor_mat)
    child = w.add_node(mesh=box_blue, translation=(0.0, 0.8, 0.0))
    w.add_scene(
        [
            w.add_node(mesh=box_red, translation=(-0.4, 0.0, 0.0), children=[child]),
            w.add_node(mesh=box_blue, translation=(0.8, -0.2, 0.3)),
            w.add_node(mesh=floor, translation=(0.0, -0.5, 0.0)),
            w.add_node(light=w.add_light(type="directional", color=(2.5, 2.5, 2.3)),
                       rotation=(0.46, 0.18, 0.0, 0.87)),
        ]
    )
    path = w.write(tmp_path / "mini.gltf")
    # sample-rate shading supersamples exactly like the numpy reference
    produced, expected = render_both(path, msaa=4, backend="pallas",
                                     shading_rate="sample")
    assert produced[..., 0].max() > 40
    assert_images_close(produced, expected, max_mean=2.5, max_outlier_frac=0.02)
    # pixel-rate (the production default, Vulkan non-sampleShading semantics)
    # differs from the supersampled reference only at object-object sample
    # edges — a few percent of pixels at this tiny resolution
    produced_px, _ = render_both(path, msaa=4, backend="pallas",
                                 shading_rate="pixel")
    assert_images_close(produced_px, expected, max_mean=3.5, max_outlier_frac=0.06)


def test_pallas_msaa8_matches_oracle_and_shards(tmp_path):
    """8x MSAA (the reference's PREFERRED sample count, engine.cppm:157-171)
    had no coverage: golden vs the supersampling oracle at the standard
    Vulkan 8-sample positions, plus sharded bit-equality at S=8."""
    import jax
    import numpy as np

    from vktf.config import RenderConfig
    from vktf.ops.pipeline import make_frame_fn
    from vktf.parallel import make_render_mesh, make_sharded_frame_fn

    from helpers import build_scene, default_camera

    w = GltfWriter()
    red = w.add_material(base_color_factor=(0.8, 0.2, 0.2, 1.0),
                         roughness_factor=0.6)
    floor_mat = w.add_material(base_color_factor=(0.4, 0.4, 0.4, 1.0),
                               roughness_factor=0.9)
    w.add_scene([
        w.add_node(mesh=w.add_mesh(box_mesh(), material=red),
                   rotation=(0.0, 0.2588, 0.0, 0.9659)),
        w.add_node(mesh=w.add_mesh(plane_mesh(4.0), material=floor_mat),
                   translation=(0.0, -0.5, 0.0)),
        w.add_node(light=w.add_light(type="directional", color=(2.5, 2.5, 2.3)),
                   rotation=(0.46, 0.18, 0.0, 0.87)),
    ])
    path = w.write(tmp_path / "m8.gltf")
    produced, expected = render_both(path, 96, 64, msaa=8, backend="pallas",
                                     shading_rate="sample")
    assert produced[..., 0].max() > 40
    assert_images_close(produced, expected, max_mean=2.5,
                        max_outlier_frac=0.02)

    # sharded path at S=8 stays bit-equal to single-chip
    scene, meta, _aux = build_scene(path)
    camera = default_camera(aspect=96 / 64)
    config = RenderConfig(width=96, height=64, msaa_samples=8,
                          tile_shape=(32, 64), backend="pallas",
                          pallas_chunk=128)
    vp, pos = camera.view_projection_transform, camera.position
    single = np.asarray(make_frame_fn(meta, config)(scene, vp, pos))
    mesh = make_render_mesh(jax.devices()[:4], gp=2, sp=2)
    sharded = np.asarray(
        make_sharded_frame_fn(meta, config, mesh)(scene, vp, pos))
    np.testing.assert_array_equal(single, sharded)


def test_table_build_packed_matches_dict(tmp_path):
    """build_shade_table takes both setup forms: the packed stream rows of
    the split-stage program (edge9/anchor2 + cached mrows) and the dict of
    prepare_frame. Plane columns agree to FMA-contraction ULPs (the two
    setup programs contract mul+add differently), static material columns
    and anchors exactly."""
    import jax
    import numpy as np
    from vktf.config import RenderConfig
    from vktf.mathx import Camera, ViewFrustumParams
    from vktf.models.gltf_writer import GltfWriter
    from vktf.models.primitives import box_mesh, uv_sphere_mesh
    from vktf.ops.pipeline import PallasFrameProgram, prepare_frame
    from vktf.ops.shade_table import ROW, build_shade_table

    from helpers import build_scene

    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.8, 0.4, 0.2, 1.0))
    w.add_scene([
        w.add_node(mesh=w.add_mesh(box_mesh(), material=mat)),
        w.add_node(mesh=w.add_mesh(uv_sphere_mesh(0.5, rings=7, sectors=13),
                                   material=mat), translation=(1.0, 0.2, 0.0)),
        w.add_node(light=w.add_light(type="directional")),
    ])
    scene, meta, _aux = build_scene(w.write(tmp_path / "t.gltf"))
    config = RenderConfig(width=128, height=128, msaa_samples=1,
                          backend="pallas", tile_shape=(32, 32))
    camera = Camera((0.0, 0.5, 3.0), (0.0, 0.0, -1.0),
                    ViewFrustumParams(np.radians(45.0), 1.0, 0.1, 100.0))
    vp, pos = camera.view_projection_transform, camera.position
    setup, _b, _l, _w, inst = jax.jit(
        lambda s, v, c: prepare_frame(s, v, c, meta=meta, config=config)
    )(scene, vp, pos)
    packed, _lights = PallasFrameProgram(meta, config)._prepare(
        scene, vp, pos)

    def to_f32(u16):
        u16 = np.asarray(u16)
        return ((u16[:, :ROW].astype(np.uint32) << 16)
                | u16[:, ROW:]).view(np.float32)

    a = to_f32(build_shade_table(setup, scene, inst))
    b = to_f32(build_shade_table(packed, scene))
    assert a.shape == b.shape == (meta.num_triangles, ROW)
    # plane coefficients suffer catastrophic cancellation (tiny values from
    # large products), so bound the error per COLUMN: |diff| within a few
    # ULP of the column's magnitude, with a small absolute floor
    col_scale = np.abs(a).max(axis=0, keepdims=True)
    assert (np.abs(b - a) <= col_scale * 2e-5 + 1e-4).all()
    # static material columns + anchors are copies, not arithmetic
    np.testing.assert_array_equal(a[:, 39:], b[:, 39:])


def test_shade_px_slice_composes_to_full(tmp_path):
    """pallas_shade_resolve_tiled's multi-device hooks: shading the flat
    block-layout pixel stream in gp slices (px_slice) and concatenating
    must be BYTE-IDENTICAL to the unsliced shade, and assembling the flat
    pixels must equal the assemble=True image. The sharded path's per-rank
    slicing (parallel/tiles.py) rests on exactly this composition."""
    from vktf.config import RenderConfig
    from vktf.ops.pipeline import (
        _tiled_assemble,
        pallas_shade_resolve_tiled,
        prepare_frame,
    )
    from vktf.ops.raster_pallas import rasterize_pallas
    from vktf.ops.shade_table import build_shade_table

    from helpers import build_scene, checker_png_bytes, default_camera

    w = GltfWriter()
    img = w.add_image_bytes(checker_png_bytes(), "image/png")
    tex = w.add_texture(img, w.add_sampler())
    mat = w.add_material(base_color_factor=(1.0, 0.8, 0.6, 1.0),
                         base_color_texture=tex, metallic_factor=0.2,
                         roughness_factor=0.5)
    w.add_scene([
        w.add_node(mesh=w.add_mesh(uv_sphere_mesh(12, 18), material=mat)),
        w.add_node(mesh=w.add_mesh(plane_mesh(4.0), material=mat),
                   translation=(0.0, -1.0, 0.0)),
        w.add_node(light=w.add_light(type="directional"),
                   rotation=(0.3827, 0.0, 0.0, 0.9239)),
    ])
    scene, meta, aux = build_scene(w.write(tmp_path / "s.gltf"))
    camera = default_camera(aspect=2.0, position=(0.0, 0.5, 3.0),
                            direction=(0.0, -0.1, -1.0))
    config = RenderConfig(width=128, height=64, msaa_samples=2,
                          backend="pallas", pallas_interpret=True,
                          tile_shape=(32, 64), pallas_chunk=128,
                          shade_chunk=1 << 12, shade_skip_mode=False)
    vp, pos = camera.view_projection_transform, camera.position
    setup, _bins, lights, _world, inst = prepare_frame(
        scene, vp, pos, meta=meta, config=config)
    table = build_shade_table(setup, scene, inst)
    ids, deps = rasterize_pallas(
        setup, config.padded_height, config.padded_width,
        tile_shape=config.tile_shape, msaa_samples=config.msaa_samples,
        chunk=config.pallas_chunk, interpret=True, sort="morton",
        assemble=False)

    def shade(px_slice=None, assemble=False):
        return np.asarray(pallas_shade_resolve_tiled(
            ids, deps, scene, table, lights, pos, config=config,
            px_slice=px_slice, assemble=assemble))

    full = shade()
    n_px = full.shape[1]
    for gp in (2, 4):
        parts = [shade((k * n_px // gp, n_px // gp)) for k in range(gp)]
        np.testing.assert_array_equal(np.concatenate(parts, axis=1), full)
    np.testing.assert_array_equal(
        np.asarray(_tiled_assemble(full, config)), shade(assemble=True))


def test_prepare_scene_cache_bit_identical(tmp_path):
    """The split-stage program's cross-frame scene-state cache (camera-
    independent prepare half: node transforms, world lights, the (T,16)
    instance-matrix rows, world AABBs — pipeline._maybe_scene_update) must
    reproduce the fused prepare bit-for-bit, reuse its state while the
    scene pytree is unchanged, and invalidate when node transforms swap."""
    import dataclasses

    import jax.numpy as jnp

    from vktf.config import RenderConfig
    from vktf.ops.pipeline import PallasFrameProgram

    from helpers import build_scene, checker_png_bytes, default_camera

    w = GltfWriter()
    img = w.add_image_bytes(checker_png_bytes(), "image/png")
    tex = w.add_texture(img, w.add_sampler())
    mat = w.add_material(base_color_factor=(1.0, 0.8, 0.6, 1.0),
                         base_color_texture=tex, metallic_factor=0.2,
                         roughness_factor=0.5)
    w.add_scene([
        w.add_node(mesh=w.add_mesh(uv_sphere_mesh(16, 24), material=mat)),
        w.add_node(mesh=w.add_mesh(plane_mesh(4.0), material=mat),
                   translation=(0.0, -1.0, 0.0)),
        w.add_node(light=w.add_light(type="directional"),
                   rotation=(0.3827, 0.0, 0.0, 0.9239)),
    ])
    scene, meta, _aux = build_scene(w.write(tmp_path / "s.gltf"))
    camera = default_camera(aspect=2.0, position=(0.0, 0.5, 3.0),
                            direction=(0.0, -0.1, -1.0))
    base = dict(width=128, height=64, msaa_samples=4, shading_rate="pixel",
                backend="pallas", pallas_interpret=True, tile_shape=(32, 64),
                pallas_chunk=128, shade_chunk=1 << 12)
    cached = PallasFrameProgram(meta, RenderConfig(
        prepare_scene_cache=True, **base))
    fused = PallasFrameProgram(meta, RenderConfig(
        prepare_scene_cache=False, **base))
    vp, pos = camera.view_projection_transform, camera.position
    _sa, la = cached._prepare(scene, vp, pos)
    _sb, lb = fused._prepare(scene, vp, pos)
    np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    # reuse while the scene pytree is unchanged
    assert cached._maybe_scene_update(scene) is cached._maybe_scene_update(
        scene)
    # swapping node transforms invalidates and changes the state
    state = cached._maybe_scene_update(scene)
    nl = np.asarray(scene.node_local).copy()
    nl[:, :3, 3] += 1.0
    moved = dataclasses.replace(scene, node_local=jnp.asarray(nl))
    state2 = cached._maybe_scene_update(moved)
    assert state2 is not state
    assert not np.array_equal(np.asarray(state2[0]), np.asarray(state[0]))
    # whole frames agree
    np.testing.assert_array_equal(np.asarray(cached(scene, vp, pos)),
                                  np.asarray(fused(scene, vp, pos)))


def test_prepare_packed_bit_identical(tmp_path):
    """The split-stage program's PACKED prepare (flat component-major
    triangle setup -> pack_tri_rows stream rows) must reproduce the dict
    prepare of the fused frame: the packed rows match pack_tri_data's row
    semantics exactly, and whole frames agree bit-for-bit — including a
    scene with translucency (peel layers) and a culling-active camera."""
    import jax

    from vktf.config import RenderConfig
    from vktf.ops.pipeline import PallasFrameProgram, make_frame_fn, prepare_frame
    from vktf.ops.raster_pallas import pack_tri_data

    from helpers import build_scene, default_camera

    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.6, 0.5, 0.4, 1.0),
                         metallic_factor=0.3, roughness_factor=0.5)
    blend = w.add_material(base_color_factor=(0.9, 0.2, 0.2, 0.5),
                           alpha_mode="BLEND")
    w.add_scene([
        w.add_node(mesh=w.add_mesh(uv_sphere_mesh(0.6, 10, 16), material=mat)),
        w.add_node(mesh=w.add_mesh(plane_mesh(6.0), material=mat),
                   translation=(0.0, -1.0, 0.0)),
        w.add_node(mesh=w.add_mesh(plane_mesh(0.8), material=blend),
                   translation=(0.2, 0.2, 0.8),
                   rotation=(0.7071068, 0.0, 0.0, 0.7071068)),
        # an instance far outside the frustum so culling bites
        w.add_node(mesh=w.add_mesh(box_mesh(), material=mat),
                   translation=(40.0, 0.0, 0.0)),
        w.add_node(light=w.add_light(type="directional"),
                   rotation=(0.3827, 0.0, 0.0, 0.9239)),
    ])
    scene, meta, _aux = build_scene(w.write(tmp_path / "s.gltf"))
    camera = default_camera(aspect=2.0, position=(0.0, 0.5, 3.0),
                            direction=(0.0, -0.1, -1.0))
    base = dict(width=128, height=64, msaa_samples=2, backend="pallas",
                pallas_interpret=True, tile_shape=(32, 64),
                pallas_chunk=128, shade_chunk=1 << 12,
                shade_skip_mode=False)
    packed_prog = PallasFrameProgram(meta, RenderConfig(**base))
    fused_cfg = RenderConfig(split_stages=False, **base)
    vp, pos = camera.view_projection_transform, camera.position

    # stage-level: same row semantics. Plane-constant values may differ by
    # FMA-contraction ULPs across the two program forms (XLA contracts
    # mul+add differently per fusion — the same tolerance the
    # setup_cm-vs-vertex-route test documents), so discrete rows are exact
    # and plane rows are ULP-tight.
    sp, _lp = packed_prog._prepare(scene, vp, pos)
    sl = jax.jit(lambda s, v, c: prepare_frame(
        s, v, c, meta=meta, config=fused_cfg)[0])(scene, vp, pos)
    # validity RULES differ by design (packed = per-triangle screen cull,
    # legacy = per-instance frustum cull — raster_pallas._packed_valid):
    # both must kill the far-off-screen instance, and triangles valid
    # under BOTH rules must carry identical ids/thresholds.
    vp_mask = np.asarray(sp["valid"])
    vl_mask = np.asarray(sl["valid"])
    # culling is ACTIVE under both rules (the x=40 box dies in both)
    assert vp_mask.sum() < vp_mask.size
    assert vl_mask.sum() < vl_mask.size
    both = vp_mask & vl_mask
    assert both.any()
    tdp = np.asarray(sp["tri_data"])
    tdl = np.asarray(pack_tri_data(sl))
    for row in (15, 16, 17, 18):  # ids + thresholds: discrete
        np.testing.assert_array_equal(tdp[row][both], tdl[row][both])
    # plane rows are valid-independent: comparable everywhere
    np.testing.assert_allclose(tdp[:15], tdl[:15], rtol=1e-5, atol=1e-5)
    t = sl["edge"].shape[0]
    np.testing.assert_allclose(
        np.asarray(sp["edge9"]), np.asarray(sl["edge"].reshape(t, 9).T),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(sp["anchor2"]), np.asarray(sl["anchor"].T))

    # whole frames agree bit-for-bit with the fused program
    np.testing.assert_array_equal(
        np.asarray(packed_prog(scene, vp, pos)),
        np.asarray(make_frame_fn(meta, fused_cfg)(scene, vp, pos)))


def test_split_stage_matches_fused_crossers(tmp_path):
    """Camera INSIDE the scene: triangles cross the eye plane (w <= 0
    corners) and take the near-crosser clipped-bbox route. The split-stage
    program (packed setup, per-triangle screen cull, cached stream sort)
    must render exactly the fused frame (dict setup, per-instance cull)."""
    from vktf.config import RenderConfig
    from vktf.ops.pipeline import PallasFrameProgram, make_frame_fn

    from helpers import build_scene, default_camera

    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.6, 0.5, 0.4, 1.0),
                         metallic_factor=0.2, roughness_factor=0.6)
    floor = w.add_mesh(plane_mesh(12.0, segments=32), material=mat)
    ceil_m = w.add_mesh(plane_mesh(12.0, segments=32), material=mat)
    w.add_scene([
        w.add_node(mesh=floor, translation=(0.0, -0.8, 0.0)),
        w.add_node(mesh=ceil_m, translation=(0.0, 1.2, 0.0),
                   rotation=(1.0, 0.0, 0.0, 0.0)),  # flipped to face down
        w.add_node(light=w.add_light(type="directional"),
                   rotation=(0.3827, 0.0, 0.0, 0.9239)),
    ])
    scene, meta, _aux = build_scene(w.write(tmp_path / "s.gltf"))
    camera = default_camera(aspect=2.0, position=(0.0, 0.2, 0.0),
                            direction=(1.0, 0.05, 0.0))
    base = dict(width=128, height=64, msaa_samples=2, backend="pallas",
                pallas_interpret=True, tile_shape=(32, 64),
                pallas_chunk=128, shade_chunk=1 << 12,
                shade_skip_mode=False)
    vp, pos = camera.view_projection_transform, camera.position
    split = make_frame_fn(meta, RenderConfig(**base))
    assert isinstance(split, PallasFrameProgram)
    a = np.asarray(split(scene, vp, pos))
    b = np.asarray(make_frame_fn(
        meta, RenderConfig(split_stages=False, **base))(scene, vp, pos))
    np.testing.assert_array_equal(a, b)
    assert (a.sum(axis=0) > 0).any(), "camera-inside frame came out empty"


def test_resort_cache_exact(tmp_path):
    """The cross-frame stream-sort cache (PallasFrameProgram._maybe_resort)
    is invisible in output: below resort_threshold the cached (stale)
    permutation is REUSED, above it REFRESHES, and every frame equals a
    program that re-sorts each frame (resort_threshold=0)."""
    from vktf.config import RenderConfig
    from vktf.mathx import Camera, ViewFrustumParams
    from vktf.ops.pipeline import PallasFrameProgram

    from helpers import build_scene

    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.6, 0.5, 0.4, 1.0),
                         metallic_factor=0.3, roughness_factor=0.5)
    blend = w.add_material(base_color_factor=(0.9, 0.2, 0.2, 0.5),
                           alpha_mode="BLEND")
    w.add_scene([
        w.add_node(mesh=w.add_mesh(uv_sphere_mesh(0.6, 10, 16), material=mat)),
        w.add_node(mesh=w.add_mesh(plane_mesh(6.0), material=mat),
                   translation=(0.0, -1.0, 0.0)),
        w.add_node(mesh=w.add_mesh(plane_mesh(0.8), material=blend),
                   translation=(0.2, 0.2, 0.8),
                   rotation=(0.7071068, 0.0, 0.0, 0.7071068)),
        w.add_node(light=w.add_light(type="directional"),
                   rotation=(0.3827, 0.0, 0.0, 0.9239)),
    ])
    scene, meta, _aux = build_scene(w.write(tmp_path / "s.gltf"))
    base = dict(width=128, height=64, msaa_samples=2, backend="pallas",
                pallas_interpret=True, tile_shape=(32, 64),
                pallas_chunk=128, shade_chunk=1 << 12,
                shade_skip_mode=False)
    cached = PallasFrameProgram(meta, RenderConfig(**base))
    fresh = PallasFrameProgram(meta, RenderConfig(resort_threshold=0.0,
                                                  **base))

    def cam(pos, direction):
        c = Camera(pos, direction,
                   ViewFrustumParams(np.radians(45.0), 2.0, 0.1, 1.0e6))
        return c.view_projection_transform, c.position

    frames = [cam((0.0, 0.5, 3.0), (0.0, -0.1, -1.0)),
              cam((0.001, 0.5, 3.0), (0.0, -0.1, -1.0)),  # tiny motion
              cam((0.5, 0.6, 2.0), (0.3, -0.2, -1.0))]    # large motion
    perms = []
    for vp, pos in frames:
        np.testing.assert_array_equal(np.asarray(cached(scene, vp, pos)),
                                      np.asarray(fresh(scene, vp, pos)))
        perms.append(cached._perm)
    assert perms[1] is perms[0], "expected the cached sort to be reused"
    assert perms[2] is not perms[1], "expected a re-sort after large motion"
