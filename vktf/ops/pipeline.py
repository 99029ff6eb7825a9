"""The jitted per-frame render step.

This is the whole of the reference's Engine::Render recording + GPU execution
(engine.cppm:501-563, scene.cppm:314-342) as ONE pure function:

    frame_step(scene, camera) -> sRGB-encoded u8 framebuffer (planar 4xHxW)

  1. scene-graph transform propagation  (Model::Update, model.cppm:163-194)
  2. world-light gathering               (Scene::Update, scene.cppm:183-205)
  3. vertex world/clip transforms        (vertex.glsl)
  4. per-instance frustum culling        (Model::Render, model.cppm:760-768)
  5. triangle->tile binning              (the GPU's internal primitive binning)
  6. visibility raster, then deferred PBR shade + MSAA resolve
     (fragment.glsl + fixed-function raster state + render-pass resolve)

Being pure and jitted, frames pipeline through XLA async dispatch with no
host round-trips — the analogue of the reference's 2-frames-in-flight
fence/semaphore machinery (engine.cppm:40,505-562).

The output is PLANAR (3, H, W) uint8 RGB; the alpha plane is always 255,
so it is synthesized host-side instead of paying 25% more device->host
transfer per frame. Hosts interleave with np.moveaxis (see
Window.present).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from vktf.config import RenderConfig
from vktf.mathx.bounding_box import transform_aabbs
from vktf.mathx.frustum import aabbs_intersect_frustum, frustum_planes
from vktf.ops.binning import bin_triangles
from vktf.ops.raster_xla import SAMPLE_OFFSETS, rasterize_dense
from vktf.ops.raster_tiled import make_tile_raster
from vktf.ops.shade_cf import shade_samples_cf
from vktf.ops.shade_table import build_shade_table, shade_table_layer
from vktf.ops.vertex import (
    clip_transform,
    propagate_transforms,
    triangle_setup,
    triangle_setup_cm,
    vertex_world_transform,
)
from vktf.scene.flatten import RenderScene, SceneMeta


def gather_world_lights(node_global, light_node, light_type, light_color):
    """Extract world-space lights from node globals -> (L, 8).

    Columns 0:4 = position (w=1) or normalized +z direction (w=0), 4:7 =
    color, 7 = pad — exactly the WorldLight uniform layout
    (scene.cppm:42-63, EmplaceWorldLight scene.cppm:183-205).
    """
    if light_node.shape[0] == 0:
        return jnp.zeros((0, 8), jnp.float32)
    transforms = node_global[light_node]  # (L,4,4)
    z_axis = transforms[:, :3, 2]
    direction = z_axis / jnp.linalg.norm(z_axis, axis=-1, keepdims=True)
    position = transforms[:, :3, 3]
    is_point = (light_type == 1)[:, None]
    pos_or_dir = jnp.where(is_point, position, direction)
    w_flag = is_point.astype(jnp.float32)
    pad = jnp.ones((light_node.shape[0], 1), jnp.float32)
    return jnp.concatenate([pos_or_dir, w_flag, light_color, pad], axis=-1)


def linear_to_srgb_u8(linear):
    """Resolve-time sRGB encode (the swapchain's B8G8R8A8Srgb conversion,
    swapchain.cppm:76-85), then quantize to u8. Any shape."""
    c = jnp.clip(linear, 0.0, 1.0)
    srgb = jnp.where(c <= 0.0031308, c * 12.92, 1.055 * jnp.power(c, 1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).astype(jnp.uint8)


def prepare_frame(scene: RenderScene, view_projection, camera_position,
                  *, meta: SceneMeta, config: RenderConfig):
    """Stages 1-5: geometry + light prep shared by all raster backends.

    Returns (setup, bins, lights, world, inst_matrix) where world =
    (pos, normal, tangent) per-vertex arrays and inst_matrix is the (I,4,4)
    per-instance world transform (consumed by the shade-table build). On the
    pallas backend, world is None (nothing downstream needs per-vertex
    arrays) and setup carries "mrows", the (T,16) per-triangle instance
    matrix rows shared by the shade-table build.
    """
    node_global = propagate_transforms(
        scene.node_local, scene.node_parent, meta.level_slices
    )
    lights = gather_world_lights(
        node_global, scene.light_node, scene.light_type, scene.light_color
    )

    inst_matrix = node_global[scene.inst_node]  # (I,4,4)
    # Viewport transform uses the LOGICAL width/height: the padded
    # framebuffer region beyond (width, height) is extra raster area that is
    # cropped away, NOT part of the projection. (Passing padded dims here
    # stretched every frame whose size wasn't a tile multiple — e.g. 1080p
    # rendered with a 0.7% vertical stretch against the 1088-row pad.)
    if config.resolved_backend() == "pallas":
        # component-major geometry path: no per-vertex stage at all — one
        # (T,16) instance-matrix row gather (reused by the shade-table
        # build) + flat (T,) corner math (triangle_setup_cm docstring)
        mrows = inst_matrix.reshape(-1, 16)[scene.tri_instance]
        setup = dict(triangle_setup_cm(
            scene.tri_corner, mrows, view_projection,
            config.width, config.height,
        ))
        setup["mrows"] = mrows
        world = None
    else:
        vert_matrix = inst_matrix[scene.vertex_instance]  # (V,4,4)
        world_pos, world_normal, world_tangent = vertex_world_transform(
            scene.positions, scene.normals, scene.tangents, vert_matrix
        )
        clip = clip_transform(world_pos, view_projection)
        world = (world_pos, world_normal, world_tangent)
        setup = dict(
            triangle_setup(clip, scene.indices, config.width, config.height)
        )

    # frustum culling (per instance = per primitive-draw)
    planes = frustum_planes(view_projection)
    world_aabbs = transform_aabbs(scene.inst_aabb, inst_matrix)
    visible = aabbs_intersect_frustum(world_aabbs, planes)
    setup["valid"] = setup["valid"] & visible[scene.tri_instance]

    bins = None
    if config.resolved_backend() == "tiled":
        bins = bin_triangles(
            setup["bbox"],
            setup["valid"],
            tile_shape=config.tile_shape,
            tiles_y=config.tiles_y,
            tiles_x=config.tiles_x,
            capacity=config.bin_capacity,
            k_pairs=config.k_pairs,
            large_capacity=config.large_capacity,
        )
    return setup, bins, lights, world, inst_matrix


def _shade_flat(tri_id_flat, sx_flat, sy_flat, scene, setup, world, lights,
                camera_position, background):
    world_pos, world_normal, world_tangent = world
    return shade_samples_cf(
        tri_id_flat,
        sx_flat,
        sy_flat,
        setup,
        scene.indices,
        world_pos,
        world_normal,
        world_tangent,
        scene.uvs,
        scene.tri_material,
        scene.mat_base_color,
        scene.mat_metallic_roughness,
        scene.mat_normal_scale,
        scene.mat_alpha,
        scene.mat_textures,
        scene.texture_pool,
        camera_position,
        lights,
        background,
    )


def _tiled_winner(ids, deps, config: RenderConfig):
    """Per-pixel depth-winning triangle + coverage from raw raster blocks.

    ids/deps: (L, num_tiles, S*th, tw) in the raster kernel's block layout
    (row = y*S + s). Returns (id_px (L, n_px), frac (n_px,)) flattened in
    block-layout pixel order — the SAME order as _tiled_pixel_coords and
    _tiled_assemble — via reshapes + reductions only, no transposes.
    """
    layers, num_tiles, rows, tw = ids.shape
    th, tw_c = config.tile_shape
    assert tw == tw_c
    S = rows // th
    idp = ids.reshape(layers, num_tiles, th, S, tw)
    dep = deps.reshape(layers, num_tiles, th, S, tw)
    imax = jnp.int32(2**31 - 1)
    d_min = jnp.min(dep, axis=3, keepdims=True)
    cand = jnp.where((dep == d_min) & (idp >= 0), idp, imax)
    id_px = jnp.min(cand, axis=3)
    id_px = jnp.where(id_px == imax, -1, id_px)
    frac = jnp.mean((idp[0] >= 0).astype(jnp.float32), axis=2)
    return id_px.reshape(layers, -1), frac.reshape(-1)


def _tiled_pixel_coords(config: RenderConfig, num_tiles: int):
    """Pixel-center (sx, sy) in block-layout order: flat (n_px,) f32 each."""
    th, tw = config.tile_shape
    tiles_x = config.tiles_x
    tile_ids = jnp.arange(num_tiles, dtype=jnp.int32)
    oy = (tile_ids // tiles_x) * th
    ox = (tile_ids % tiles_x) * tw
    shape = (num_tiles, th, tw)
    ry = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    rx = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    sx = ox[:, None, None] + rx
    sy = oy[:, None, None] + ry
    return (sx.astype(jnp.float32) + 0.5).reshape(-1), (
        sy.astype(jnp.float32) + 0.5).reshape(-1)


def _tiled_assemble(rgb_u8, config: RenderConfig):
    """(3, n_px) block-layout pixels -> (3, ph, pw) planar image."""
    th, tw = config.tile_shape
    ty, tx = config.tiles_y, config.tiles_x
    return (
        rgb_u8.reshape(3, ty, tx, th, tw)
        .transpose(0, 1, 3, 2, 4)
        .reshape(3, ty * th, tx * tw)
    )


def _composite_resolve(rgbs, alphas, frac, background):
    """Front-to-back over() of the shaded layers onto the clear color, then
    the MSAA coverage resolve against the background."""
    comp = jnp.broadcast_to(background[:3, None], rgbs[0].shape)
    for l in reversed(range(len(rgbs))):
        comp = rgbs[l] * alphas[l] + comp * (1.0 - alphas[l])
    frac_f = frac.reshape(1, -1)
    return comp * frac_f + background[:3, None] * (1.0 - frac_f)


def pallas_shade_resolve_tiled(tri_id, depth, scene, table, lights,
                               camera_position, *, config: RenderConfig,
                               per_slot_samplers: bool = False, y0=0,
                               px_slice=None, assemble: bool = True):
    """Tile-layout shade + MSAA resolve + sRGB encode (pixel-rate).

    Consumes the rasterizer's RAW per-tile blocks (num_tiles, S*th, tw)
    (row = y*S + s) — or (L, ...) peel layers — so the per-pixel
    winner/coverage reductions are pure reshapes; only the final (3, H, W)
    u8 image is assembled.

    Multi-chip hooks (vktf.parallel): ``y0`` offsets the pixel-center sy
    coordinates (a band's place in screen space; traced scalar ok), and
    ``px_slice = (start, count)`` shades only a contiguous slice of the
    BLOCK-LAYOUT flat pixel stream, so the gp ranks of a band each shade
    1/gp of its pixels. assemble=False returns the (3, n) u8 pixels in
    block-layout flat order instead of the assembled image.
    """
    ids = tri_id if tri_id.ndim == 4 else tri_id[None]
    deps = depth if depth.ndim == 4 else depth[None]
    layers, num_tiles = ids.shape[:2]
    th, tw = config.tile_shape
    background = jnp.asarray(config.clear_color, jnp.float32)

    # per-pixel winner + coverage + pixel-center coordinates, all in
    # block-layout flat order (reshapes + reductions only)
    id_px, frac = _tiled_winner(ids, deps, config)  # (L, n_px), (n_px,)
    sx, sy = _tiled_pixel_coords(config, num_tiles)
    if not (isinstance(y0, int) and y0 == 0):
        sy = sy + jnp.asarray(y0, jnp.float32)
    n_px = num_tiles * th * tw
    if px_slice is not None:
        start, n_px = px_slice
        start = jnp.asarray(start, jnp.int32)
        id_px = jax.lax.dynamic_slice(id_px, (0, start), (layers, n_px))
        frac = jax.lax.dynamic_slice(frac, (start,), (n_px,))
        sx = jax.lax.dynamic_slice(sx, (start,), (n_px,))
        sy = jax.lax.dynamic_slice(sy, (start,), (n_px,))

    # Small scenes shade with EMPTY-CHUNK SKIPPING: uncovered pixels
    # contribute exactly nothing to the composite (alpha 0, frac 0), so a
    # lax.cond skipping all-uncovered chunks is exact. A scene under 32k
    # triangles cannot come close to covering a large frame densely; at
    # larger scenes every chunk is covered and the conds only serialize.
    if config.shade_skip_mode is not None:
        skip_mode = config.shade_skip_mode
    else:
        skip_mode = table.shape[0] <= 32768  # static scene size
    if skip_mode:
        shade_chunk = min(max(th * tw * 4, 32768), n_px)
    else:
        shade_chunk = min(config.shade_chunk, n_px)
    n_pad = -(-n_px // shade_chunk) * shade_chunk
    pad = n_pad - n_px

    def flat_pad(x, fill=0):
        x = x.reshape(-1)
        if pad:
            x = jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])
        return x.reshape(n_pad // shade_chunk, shade_chunk)

    def shade_one(args):
        tri_c, sx_c, sy_c = args

        def do(_):
            rgb, a, _covered = shade_table_layer(
                tri_c, sx_c, sy_c, table, scene.quad_pool, camera_position,
                lights, max_anisotropy=config.max_anisotropy,
                per_slot_samplers=per_slot_samplers,
                aniso_taps=config.aniso_taps,
            )
            return rgb, a

        if not skip_mode:
            return do(None)

        def skip(_):
            return (jnp.zeros((3, shade_chunk), jnp.float32),
                    jnp.zeros((shade_chunk,), jnp.float32))

        return jax.lax.cond(jnp.any(tri_c >= 0), do, skip, None)

    sxp, syp = flat_pad(sx), flat_pad(sy)
    rgbs, alphas = [], []
    for l in range(layers):
        # pad ids with -1 (background): 0 is a real triangle id, and a
        # 0-padded tail chunk would fail the skip test AND gather real
        # table/pool rows for lanes that are sliced off anyway
        rgb, a = jax.lax.map(shade_one, (flat_pad(id_px[l], fill=-1), sxp, syp))
        rgbs.append(rgb.transpose(1, 0, 2).reshape(3, n_pad)[:, :n_px])
        alphas.append(a.reshape(n_pad)[:n_px])

    rgb_u8 = linear_to_srgb_u8(
        _composite_resolve(rgbs, alphas, frac, background))
    if not assemble:
        return rgb_u8
    return _tiled_assemble(rgb_u8, config)


def pallas_shade_resolve(tri_id, scene, table, lights, camera_position,
                         *, config: RenderConfig, y0=0, depth=None,
                         per_slot_samplers: bool = False):
    """Shade-table shading + MSAA resolve + sRGB encode of a visibility block.

    tri_id: (S, h, w) winner ids — or (L, S, h, w) depth-peeled layers,
    nearest first — at framebuffer pixel-row offset y0 (y0 may be traced;
    the multi-chip path passes each device's band offset). depth carries the
    matching per-sample depths when pixel-rate shading should pick the
    depth-winning sample's triangle (None -> max-id fallback). Layers
    composite front-to-back with glTF alphaMode semantics
    (OPAQUE/MASK/BLEND) over the clear color. Returns planar (3, h, w) uint8.
    """
    ids = tri_id if tri_id.ndim == 4 else tri_id[None]
    layers, S, h, w = ids.shape
    offsets = np.asarray(SAMPLE_OFFSETS[config.msaa_samples], np.float32)
    background = jnp.asarray(config.clear_color, jnp.float32)
    y_off = jnp.asarray(y0, jnp.float32)

    def shade_chunked(layer_ids, sx_flat, sy_flat):
        """Shade each layer of flat samples; returns (rgb, a) lists.

        Chunked because every per-sample row gather materializes an
        (N, row) buffer — a full 8.3M-sample frame would hold several-GB
        intermediates at once.
        """
        n = sx_flat.shape[0]
        shade_chunk = min(config.shade_chunk, n)
        n_pad = -(-n // shade_chunk) * shade_chunk
        pad = n_pad - n

        def flat_pad(x, fill=0):
            # ids pad with -1 (background): 0 is a real triangle id
            if pad:
                x = jnp.concatenate([x, jnp.full((pad,), fill, x.dtype)])
            return x.reshape(n_pad // shade_chunk, shade_chunk)

        def shade_one(args):
            tri_c, sx_c, sy_c = args
            rgb, a, _covered = shade_table_layer(
                tri_c, sx_c, sy_c, table, scene.quad_pool, camera_position,
                lights, max_anisotropy=config.max_anisotropy,
                per_slot_samplers=per_slot_samplers,
                aniso_taps=config.aniso_taps,
            )
            return rgb, a  # (3, chunk), (chunk,)

        sxp, syp = flat_pad(sx_flat), flat_pad(sy_flat)
        out_rgb, out_a = [], []
        for l in range(layers):
            rgb, a = jax.lax.map(
                shade_one, (flat_pad(layer_ids[l], fill=-1), sxp, syp)
            )
            out_rgb.append(rgb.transpose(1, 0, 2).reshape(3, n_pad)[:, :n])
            out_a.append(a.reshape(n_pad)[:n])
        return out_rgb, out_a

    if config.shading_rate == "pixel" and S > 1:
        # Vulkan non-sampleShading semantics: shade once per pixel at the
        # center, resolve by per-sample coverage fraction. Silhouette-vs-
        # background edges resolve exactly, object-object sample edges
        # approximate to the pixel winner — the DEPTH-winning sample's
        # triangle when depths are available (max id would pick an
        # arbitrary triangle of a Morton-reordered stream).
        n_px = h * w
        if depth is not None:
            depths = depth if depth.ndim == 4 else depth[None]
            imax = jnp.int32(2**31 - 1)
            d_min = jnp.min(depths, axis=1, keepdims=True)  # (L,1,h,w)
            cand = jnp.where((depths == d_min) & (ids >= 0), ids, imax)
            id_px = jnp.min(cand, axis=1)
            id_px = jnp.where(id_px == imax, -1, id_px).reshape(layers, n_px)
        else:
            id_px = jnp.max(ids, axis=1).reshape(layers, n_px)
        py = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + y_off
        px = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
        rgbs, alphas = shade_chunked(
            id_px, (px + 0.5).reshape(n_px), (py + 0.5).reshape(n_px)
        )
        frac = jnp.mean((ids[0] >= 0).astype(jnp.float32), axis=0)  # (h,w)
        resolved = _composite_resolve(rgbs, alphas, frac, background)
        resolved = resolved.reshape(3, h, w)
    else:
        py = jax.lax.broadcasted_iota(jnp.float32, (S, h, w), 1) + y_off
        px = jax.lax.broadcasted_iota(jnp.float32, (S, h, w), 2)
        sx = px + offsets[:, 0][:, None, None]
        sy = py + offsets[:, 1][:, None, None]
        n = S * h * w
        rgbs, alphas = shade_chunked(
            ids.reshape(layers, n), sx.reshape(n), sy.reshape(n)
        )
        comp = jnp.broadcast_to(background[:3, None], rgbs[0].shape)
        for l in reversed(range(layers)):
            comp = rgbs[l] * alphas[l] + comp * (1.0 - alphas[l])
        resolved = jnp.mean(comp.reshape(3, S, h, w), axis=1)
    return linear_to_srgb_u8(resolved)


def make_tile_render(scene, setup, bins, lights, camera_position, world,
                     *, config: RenderConfig):
    """Build tile_render(tile_idx) -> (3, th, tw) uint8: fused raster + shade
    + MSAA resolve + sRGB encode for one framebuffer tile."""
    th, tw = config.tile_shape
    S = len(SAMPLE_OFFSETS[config.msaa_samples])
    offsets = np.asarray(SAMPLE_OFFSETS[config.msaa_samples], np.float32)
    background = jnp.asarray(config.clear_color, jnp.float32)

    tile_raster = make_tile_raster(
        setup,
        bins,
        tile_shape=config.tile_shape,
        tiles_x=config.tiles_x,
        bin_capacity=config.bin_capacity,
        msaa_samples=config.msaa_samples,
        chunk=config.raster_chunk,
    )

    n = S * th * tw
    ly = jax.lax.broadcasted_iota(jnp.float32, (S, th, tw), 1)
    lx = jax.lax.broadcasted_iota(jnp.float32, (S, th, tw), 2)
    lsx = (lx + offsets[:, 0][:, None, None]).reshape(n)
    lsy = (ly + offsets[:, 1][:, None, None]).reshape(n)

    def tile_render(tile_idx):
        tri_id, _depth = tile_raster(tile_idx)  # (S, th, tw)
        tri_flat = jax.lax.optimization_barrier(tri_id.reshape(n))
        oy = ((tile_idx // config.tiles_x) * th).astype(jnp.float32)
        ox = ((tile_idx % config.tiles_x) * tw).astype(jnp.float32)
        rgba = _shade_flat(
            tri_flat, lsx + ox, lsy + oy, scene, setup, world, lights,
            camera_position, background,
        )  # (4, n)
        resolved = jnp.mean(rgba.reshape(4, S, th * tw), axis=1)  # (4, th*tw)
        return linear_to_srgb_u8(resolved[:3]).reshape(3, th, tw)

    return tile_render


def render_frame(
    scene: RenderScene,
    camera_view_projection,
    camera_position,
    *,
    meta: SceneMeta,
    config: RenderConfig,
) -> jnp.ndarray:
    """Render one frame; returns PLANAR (3, H, W) uint8 RGB (sRGB)."""
    height, width = config.height, config.width
    ph, pw = config.padded_height, config.padded_width

    with jax.named_scope("vktf.prepare"):
        setup, bins, lights, world, inst_matrix = prepare_frame(
            scene, camera_view_projection, camera_position, meta=meta, config=config
        )
    backend = config.resolved_backend()

    if backend == "pallas":
        # the production frame path: Pallas raster kernel + shade-table
        # deferred shading (ops.raster_pallas / ops.shade_table)
        from vktf.ops.raster_pallas import rasterize_pallas

        # Stage barriers keep XLA from fusing the geometry pipeline into the
        # raster/shade consumers (compile time grows with program size).
        setup = jax.lax.optimization_barrier(setup)
        tiled_resolve = config.shading_rate == "pixel"
        with jax.named_scope("vktf.raster"):
            tri_id, depth = rasterize_pallas(
                setup, ph, pw, tile_shape=config.tile_shape,
                msaa_samples=config.msaa_samples, chunk=config.pallas_chunk,
                interpret=config.kernel_interpret(), sort="morton",
                layers=config.resolved_peel_layers(meta.peel_layers),
                assemble=not tiled_resolve,
            )
        tri_id, depth = jax.lax.optimization_barrier((tri_id, depth))
        with jax.named_scope("vktf.shade_table"):
            table = jax.lax.optimization_barrier(
                build_shade_table(setup, scene, inst_matrix))
        with jax.named_scope("vktf.shade_resolve"):
            if tiled_resolve:
                rgba = pallas_shade_resolve_tiled(
                    tri_id, depth, scene, table, lights, camera_position,
                    config=config, per_slot_samplers=meta.mixed_samplers,
                )
            else:
                rgba = pallas_shade_resolve(
                    tri_id, scene, table, lights, camera_position,
                    config=config, depth=depth,
                    per_slot_samplers=meta.mixed_samplers,
                )
        return rgba[:, :height, :width]

    if backend in ("dense", "xla"):
        # debug/reference path: dense visibility then one flat shade pass
        tri_id, _depth = rasterize_dense(
            setup, ph, pw, msaa_samples=config.msaa_samples,
            chunk=min(config.raster_chunk, 8),
        )
        tri_id = jax.lax.optimization_barrier(tri_id)
        offsets = np.asarray(SAMPLE_OFFSETS[config.msaa_samples], np.float32)
        S = offsets.shape[0]
        py = jax.lax.broadcasted_iota(jnp.float32, (S, ph, pw), 1)
        px = jax.lax.broadcasted_iota(jnp.float32, (S, ph, pw), 2)
        sx = px + offsets[:, 0][:, None, None]
        sy = py + offsets[:, 1][:, None, None]
        n = S * ph * pw
        background = jnp.asarray(config.clear_color, jnp.float32)
        rgba = _shade_flat(
            tri_id.reshape(n), sx.reshape(n), sy.reshape(n), scene, setup,
            world, lights, camera_position, background,
        )  # (4, n)
        resolved = jnp.mean(rgba.reshape(4, S, ph, pw), axis=1)
        return linear_to_srgb_u8(resolved[:3, :height, :width])

    tile_render = make_tile_render(
        scene, setup, bins, lights, camera_position, world, config=config
    )
    tiles = jax.lax.map(
        tile_render,
        jnp.arange(config.num_tiles, dtype=jnp.int32),
        batch_size=config.tile_batch,
    )  # (num_tiles, 3, th, tw)

    th, tw = config.tile_shape
    image = (
        tiles.reshape(config.tiles_y, config.tiles_x, 3, th, tw)
        .transpose(2, 0, 3, 1, 4)
        .reshape(3, ph, pw)
    )
    return image[:, :height, :width]


class PallasFrameProgram:
    """The pallas frame pipeline as per-stage jit programs.

    Functionally identical to the fused render_frame (same stages), but
    compiled as separate programs — camera-independent scene update,
    triangle setup, stream sort, raster, shade table, shade + resolve:

      * cold compile is the sum of much smaller stage compiles (XLA compile
        time is superlinear in program size);
      * a source edit invalidates only the stage it touched in the
        persistent cache;
      * the Morton stream permutation becomes a cached cross-frame input:
        the argsort reruns only when the camera has moved past
        ``config.resort_threshold`` (sort order affects raster locality,
        never output — lexicographic depth ties use original draw ids).

    Frames still pipeline through XLA async dispatch: every stage call is
    non-blocking, so N-deep frames-in-flight behaves exactly as with the
    fused program.
    """

    def __init__(self, meta: SceneMeta, config: RenderConfig):
        from vktf.ops.raster_pallas import (
            pack_tri_rows,
            rasterize_pallas,
            stream_perm,
        )

        self.meta = meta
        self.config = config
        interpret = config.kernel_interpret()
        ph, pw = config.padded_height, config.padded_width
        height, width = config.height, config.width
        # tile-layout pixel-rate path for ALL msaa counts: at S=1 the
        # single sample IS the pixel center (SAMPLE_OFFSETS[1] = (0.5,
        # 0.5)) and coverage frac is 0/1, so pixel-rate == sample-rate
        tiled_resolve = config.shading_rate == "pixel"

        def prepare(scene, view_projection, camera_position):
            setup, _bins, lights, _world, _inst = prepare_frame(
                scene, view_projection, camera_position,
                meta=meta, config=config,
            )
            return setup, lights

        # Camera-independent half of prepare, cached across frames (see
        # _maybe_scene_update): node transform propagation (Model::Update,
        # model.cppm:163-194), world lights (scene.cppm:183-205), the
        # (T,16) instance-matrix row gather, and world AABBs.
        def scene_update(scene):
            node_global = propagate_transforms(
                scene.node_local, scene.node_parent, meta.level_slices
            )
            lights = gather_world_lights(
                node_global, scene.light_node, scene.light_type,
                scene.light_color,
            )
            inst_matrix = node_global[scene.inst_node]
            mrows = inst_matrix.reshape(-1, 16)[scene.tri_instance]
            world_aabbs = transform_aabbs(scene.inst_aabb, inst_matrix)
            return mrows, lights, world_aabbs

        def prepare_cam(scene, mrows, view_projection):
            # FLAT component-major setup -> PACKED stream rows: every value
            # a (T,) vector stacked once into dense (C, T) rows. Culling is
            # the PER-TRIANGLE screen cull (raster_pallas._packed_valid),
            # frame-identical to the per-instance frustum cull.
            flat = triangle_setup_cm(
                scene.tri_corner, mrows, view_projection,
                config.width, config.height, flat_out=True,
            )
            packed = pack_tri_rows(flat)
            packed["mrows"] = mrows
            return packed

        def perm_fn(setup):
            return stream_perm(setup, chunk=config.pallas_chunk)

        def raster(setup, perm):
            return rasterize_pallas(
                setup, ph, pw, tile_shape=config.tile_shape,
                msaa_samples=config.msaa_samples, chunk=config.pallas_chunk,
                interpret=interpret, sort="none", perm=perm,
                layers=config.resolved_peel_layers(meta.peel_layers),
                assemble=not tiled_resolve,
            )

        def table_fn(setup, scene):
            return build_shade_table(setup, scene)

        # device-side present encoding (preview downsample + optional yuv
        # pack) fused into the final stage (the frame's last producer — no
        # extra program launch or device-memory pass)
        from vktf.ops.present import make_present_encoder

        _present_enc = make_present_encoder(config)

        def shade(tri_id, depth, table, scene, lights, camera_position):
            if tiled_resolve:
                rgba = pallas_shade_resolve_tiled(
                    tri_id, depth, scene, table, lights, camera_position,
                    config=config, per_slot_samplers=meta.mixed_samplers,
                )
            else:
                rgba = pallas_shade_resolve(
                    tri_id, scene, table, lights, camera_position,
                    config=config, depth=depth,
                    per_slot_samplers=meta.mixed_samplers,
                )
            return _present_enc(rgba[:, :height, :width])

        cache_scene = config.prepare_scene_cache
        if cache_scene is None:
            cache_scene = True
        self._prepare_fused = jax.jit(prepare)
        self._scene_update = jax.jit(scene_update)
        self._prepare_cam = jax.jit(prepare_cam)
        self._scene_key = None
        self._scene_state = None
        if cache_scene:
            def prepare_cached(scene, view_projection, camera_position):
                mrows, lights, _aabbs = self._maybe_scene_update(scene)
                return self._prepare_cam(scene, mrows, view_projection), lights

            self._prepare = prepare_cached
        else:
            self._prepare = self._prepare_fused
        self._perm_fn = jax.jit(perm_fn)
        self._raster = jax.jit(raster)
        self._table = jax.jit(table_fn)
        self._shade = jax.jit(shade)
        self._perm = None
        self._sort_vp = None

    def _maybe_scene_update(self, scene):
        """Cross-frame cache of the camera-independent prepare half.

        jax arrays are immutable, so identity of every input array
        scene_update reads implies identical values; animation that swaps
        in new node transforms (a new node_local array / a rebuilt scene
        pytree) naturally invalidates. The strong refs in _scene_key keep
        id() stable against reuse-after-GC.
        """
        key = (scene.node_local, scene.node_parent, scene.light_node,
               scene.light_type, scene.light_color, scene.inst_node,
               scene.tri_instance, scene.inst_aabb)
        if self._scene_state is None or any(
            a is not b for a, b in zip(key, self._scene_key)
        ):
            self._scene_state = self._scene_update(scene)
            self._scene_key = key
        return self._scene_state

    def _maybe_resort(self, setup, view_projection):
        vp = np.asarray(view_projection, dtype=np.float64)
        if self._perm is not None and self.config.resort_threshold > 0:
            ref = self._sort_vp
            if (np.linalg.norm(vp - ref)
                    <= self.config.resort_threshold * np.linalg.norm(ref)):
                return self._perm
        self._perm = self._perm_fn(setup)
        self._sort_vp = vp
        return self._perm

    def __call__(self, scene, view_projection, camera_position):
        with jax.profiler.TraceAnnotation("vktf.prepare"):
            setup, lights = self._prepare(scene, view_projection,
                                          camera_position)
            perm = self._maybe_resort(setup, view_projection)
        with jax.profiler.TraceAnnotation("vktf.raster"):
            tri_id, depth = self._raster(setup, perm)
        with jax.profiler.TraceAnnotation("vktf.shade_table"):
            table = self._table(setup, scene)
        with jax.profiler.TraceAnnotation("vktf.shade"):
            return self._shade(tri_id, depth, table, scene, lights,
                               camera_position)

    def warmup(self, scene, view_projection, camera_position):
        """Compile every stage (AOT analogue); blocks until done."""
        out = self(scene, view_projection, camera_position)
        np.asarray(out)
        return out


def make_frame_fn(meta: SceneMeta, config: RenderConfig):
    """Build the frame function for a given static scene shape.

    Returns a jitted function, or (pallas backend with split_stages, the
    default) a PallasFrameProgram — same call signature, per-stage compiled.
    """
    if config.resolved_backend() == "pallas" and config.split_stages:
        return PallasFrameProgram(meta, config)

    from vktf.ops.present import make_present_encoder

    _present_enc = make_present_encoder(config)

    def frame(scene, view_projection, camera_position):
        out = render_frame(
            scene, view_projection, camera_position, meta=meta, config=config
        )
        return _present_enc(out)

    return jax.jit(frame)
