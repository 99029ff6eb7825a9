"""Asset → device-array scene flattening.

The replacement for the reference's staging/device model build
(StagingModel/Model, src/engine/model.cppm:333-833): instead of per-resource
Vulkan buffers + descriptor sets, the whole multi-asset scene flattens into a
single pytree of SoA device arrays (SURVEY.md §7 architecture stance):

  * pointer-graph node hierarchies become topo-ordered index arrays whose
    per-frame composition is ~depth batched matmuls;
  * per-primitive vertex/index buffers concatenate into global arrays with a
    per-instance (node, material, AABB) table — one "draw" for everything;
  * materials become a factor table + texture-id table; textures pack into
    one HBM texel pool (see vktf.ops.texture).

Validation mirrors the reference's skip-and-log ethos but supports the
reference's TODOs (optional material textures, missing attributes get
defaults instead of rejection — model.cppm:368-423,531-584).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp
import jax

from vktf.loaders.gltf import Asset, Material, Primitive
from vktf.loaders.images import decode_texture, default_texture_data
from vktf.log import Log, default_log
from vktf.ops.texture import TexturePool, build_texture_pool
from vktf.utils.profiling import counters
from vktf.ops.texture_pack import build_material_pool

_ALPHA_MODES = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}

# Raster-kernel depth-peel capacity: the branchless sorted-insertion keeps
# up to this many (depth, id) fragments per sample (raster_pallas kernel).
# Accumulator registers scale linearly with K; scenes estimate K from their
# translucent-instance count and clamp here, RenderConfig.peel_layers
# overrides.
PEEL_LAYERS_MAX = 8


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class RenderScene:
    """Device-resident scene state (a pytree of jnp arrays)."""

    # node hierarchy (topo-sorted by depth)
    node_local: jnp.ndarray  # (N,4,4) f32
    node_parent: jnp.ndarray  # (N,) i32 (index into sorted order; roots = self)
    # geometry (concatenated over all instances)
    positions: jnp.ndarray  # (V,3) f32
    normals: jnp.ndarray  # (V,3) f32
    tangents: jnp.ndarray  # (V,4) f32
    uvs: jnp.ndarray  # (V,2) f32
    indices: jnp.ndarray  # (T,3) i32 global vertex indices
    tri_instance: jnp.ndarray  # (T,) i32
    tri_material: jnp.ndarray  # (T,) i32
    vertex_instance: jnp.ndarray  # (V,) i32
    inst_node: jnp.ndarray  # (I,) i32
    inst_aabb: jnp.ndarray  # (I,2,3) f32 object-space AABB
    # materials
    mat_base_color: jnp.ndarray  # (M,4) f32
    mat_metallic_roughness: jnp.ndarray  # (M,2) f32
    mat_normal_scale: jnp.ndarray  # (M,) f32
    mat_alpha: jnp.ndarray  # (M,2) f32: (mode, cutoff)
    mat_textures: jnp.ndarray  # (M,3) i32: base/mr/normal texture ids
    texture_pool: TexturePool
    # packed per-material texturing (ops.texture_pack / ops.shade_table):
    mat_meta: jnp.ndarray  # (M,6) f32: base_row,w0,levels,sampler codes x3
    quad_pool: jnp.ndarray  # (P,128) u16 view of block-packed texels (texture_pack)
    # precomputed per-triangle tables (component-major, built once at flatten
    # so the per-frame shade-table build does no attribute/material gathers):
    tri_corner: jnp.ndarray  # (36,T) f32 object-space corner attrs (see below)
    tri_static_cols: jnp.ndarray  # (15,T) f32 static material table columns
    # lights
    light_node: jnp.ndarray  # (L,) i32
    light_type: jnp.ndarray  # (L,) i32: 0 directional, 1 point
    light_color: jnp.ndarray  # (L,3) f32


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (trace-time) scene facts; a change triggers recompilation —
    the analogue of the reference's per-scene pipeline creation
    (scene.cppm:269-277) and light-count specialization constant."""

    level_slices: Tuple[Tuple[int, int], ...]
    num_lights: int
    num_instances: int
    num_triangles: int
    num_vertices: int
    # Depth-peel layer count: 1 for all-opaque scenes; otherwise 1 + the
    # translucent (MASK/BLEND) instance count clamped to PEEL_LAYERS_MAX
    # (_estimate_peel_layers) — the raster kernel keeps that many nearest
    # fragments per sample. A static jit-specialization knob like the light
    # count (the analogue of the reference's per-scene pipeline state,
    # graphics_pipeline.cppm:226-234).
    peel_layers: int = 1
    # True when any material's three texture slots carry different samplers:
    # the deferred shade then compiles the exact per-slot pool-gather path
    # (3 block gathers per mip level instead of 1 — ops.shade_table).
    mixed_samplers: bool = False
    # True when any sampler uses MIRRORED_REPEAT on either axis: the
    # fused-mip single-gather trilinear path is exact only for repeat/clamp
    # (ops/texture_pack.py docstring), so such scenes compile the classic
    # two-gather path.
    mirror_wrap: bool = False


def _compute_smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals for primitives missing NORMAL."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    face_n = np.cross(v1 - v0, v2 - v0)
    out = np.zeros_like(positions)
    for k in range(3):
        np.add.at(out, indices[:, k], face_n)
    lengths = np.linalg.norm(out, axis=-1, keepdims=True)
    lengths[lengths == 0] = 1.0
    return (out / lengths).astype(np.float32)


def _estimate_peel_layers(mat_alpha, tri_material, tri_instance,
                          log: Optional[Log] = None) -> int:
    """Scene-derived depth-peel count: 1 + the number of translucent
    instances, clamped to PEEL_LAYERS_MAX (8).

    The reference blends in submission order against the framebuffer
    (graphics_pipeline.cppm:226-234) and so never needs a layer count; the
    depth-peel formulation needs K = (deepest possible stack of MASK/BLEND
    surfaces along a view ray) + 1 layer for the opaque surface behind them.
    With a free camera ANY two translucent instances can align along some
    ray (spatial-overlap tests like AABB intersection undercount the common
    stacked-parallel-surfaces case), so the sound bound is the instance
    count itself, capped at the raster kernel's 8-layer limit — beyond
    that, compositing approximates with the nearest 8 fragments. Stacked
    translucent geometry INSIDE one instance (a single primitive containing
    several quads) is not visible to the count (documented limitation).
    RenderConfig.peel_layers overrides the estimate (cost A/Bs, or forcing
    a deeper K than the per-instance count can see).
    """
    alpha_mask = mat_alpha[:, 0] != 0
    if not bool(alpha_mask.any()):
        return 1
    tri_alpha = alpha_mask[tri_material]
    n_alpha = int(np.unique(tri_instance[tri_alpha]).shape[0])
    if 1 + n_alpha > PEEL_LAYERS_MAX:
        # surface the clamp at load time: the user must
        # be able to tell their scene crossed the nearest-K approximation
        # line without reading this docstring
        counters.add("scene.peel_layers_clamped")
        if log is not None:
            log.warn(
                f"{n_alpha} translucent instances exceed the "
                f"{PEEL_LAYERS_MAX}-layer depth peel limit: stacks deeper "
                f"than {PEEL_LAYERS_MAX} composite only their nearest "
                f"{PEEL_LAYERS_MAX} fragments (reference blends every "
                f"fragment in draw order, graphics_pipeline.cppm:226-234)"
            )
    return min(1 + n_alpha, PEEL_LAYERS_MAX)


def _material_key(material: Optional[Material]):
    return id(material) if material is not None else None


def flatten_assets(
    assets: Sequence[Asset], log: Optional[Log] = None
) -> Tuple[RenderScene, SceneMeta, dict]:
    """Combine glTF assets into one RenderScene (reference: Scene combining
    multiple assets, scene.cppm:265-312).

    Returns (scene, meta, aux) where aux carries host-side byproducts —
    currently the decoded texture entries ("texture_entries": list of
    (TextureData, sampler_dict)) used by the numpy reference renderer.
    """
    log = log or default_log()

    # ---- node forest -> level-sorted flat arrays ---------------------------
    flat_locals: list[np.ndarray] = []
    flat_parents: list[int] = []
    flat_levels: list[int] = []
    node_entries: list[tuple[Asset, int, int]] = []  # (asset, node_idx, flat_idx)
    node_flat_index: dict[tuple[int, int], int] = {}

    order: list[tuple[Asset, int, int, int]] = []  # (asset, node, parent_flat_or_-1, level)
    for asset in assets:
        if asset.default_scene is None:
            # throws-if-no-default-scene in reference (model.cppm:735-744);
            # here: skip asset with log error if it has no scene at all
            if not asset.scenes:
                counters.add("assets.skipped")
                log.error(f"Asset {asset.name} has no scenes; skipping")
                continue
            scene_def = asset.scenes[0]
        else:
            scene_def = asset.scenes[asset.default_scene]
        if not scene_def.root_nodes:
            counters.add("assets.skipped")
            log.error(f"Asset {asset.name} default scene has no root nodes; skipping")
            continue
        stack = [(root, -1, 0) for root in scene_def.root_nodes]
        while stack:
            node_idx, parent_flat, level = stack.pop(0)
            order.append((asset, node_idx, parent_flat, level))
            my_order_pos = len(order) - 1
            for child in asset.nodes[node_idx].children:
                stack.append((child, my_order_pos, level + 1))

    # sort BFS order by level (stable) -> contiguous level slices
    perm = sorted(range(len(order)), key=lambda i: order[i][3])
    order_to_flat = {old: new for new, old in enumerate(perm)}
    level_bounds: list[Tuple[int, int]] = []
    max_level = max((order[i][3] for i in perm), default=-1)
    sorted_entries = [order[i] for i in perm]
    for asset, node_idx, parent_order, level in sorted_entries:
        flat_locals.append(np.asarray(asset.nodes[node_idx].local_transform, np.float32))
        flat_parents.append(order_to_flat[parent_order] if parent_order >= 0 else len(flat_parents))
        flat_levels.append(level)
        node_flat_index[(id(asset), node_idx)] = len(flat_locals) - 1
    start = 0
    for level in range(max_level + 1):
        count = sum(1 for entry_level in flat_levels if entry_level == level)
        level_bounds.append((start, start + count))
        start += count

    # ---- instances + geometry ---------------------------------------------
    positions_list, normals_list, tangents_list, uvs_list = [], [], [], []
    indices_list, tri_inst_list, vert_inst_list = [], [], []
    inst_nodes: list[int] = []
    inst_aabbs: list[np.ndarray] = []
    inst_materials: list[int] = []

    materials: list[Material | None] = []
    material_index: dict[Optional[int], int] = {}

    def get_material_index(material: Optional[Material]) -> int:
        key = _material_key(material)
        if key not in material_index:
            material_index[key] = len(materials)
            materials.append(material)
        return material_index[key]

    vertex_offset = 0
    for asset, node_idx, _parent, _level in sorted_entries:
        node = asset.nodes[node_idx]
        if node.mesh is None:
            continue
        flat_node = node_flat_index[(id(asset), node_idx)]
        for prim_idx, prim in enumerate(asset.meshes[node.mesh].primitives):
            count = prim.positions.shape[0]
            if count == 0 or prim.indices.size == 0:
                continue
            normals = prim.normals
            if normals is None:
                log.warn(
                    f"Mesh primitive {asset.meshes[node.mesh].name}[{prim_idx}] "
                    "has no normals; computing smooth normals"
                )
                normals = _compute_smooth_normals(prim.positions, prim.indices)
            tangents = prim.tangents
            if tangents is None:
                tangents = np.tile(
                    np.asarray([1.0, 0.0, 0.0, 1.0], np.float32), (count, 1)
                )
            uvs = prim.uvs
            if uvs is None:
                uvs = np.zeros((count, 2), np.float32)

            instance = len(inst_nodes)
            inst_nodes.append(flat_node)
            aabb = prim.aabb
            if aabb is None:
                aabb = np.stack([prim.positions.min(axis=0), prim.positions.max(axis=0)])
            inst_aabbs.append(np.asarray(aabb, np.float32))
            material = get_material_index(prim.material)
            inst_materials.append(material)

            positions_list.append(prim.positions)
            normals_list.append(np.asarray(normals, np.float32))
            tangents_list.append(np.asarray(tangents, np.float32))
            uvs_list.append(np.asarray(uvs, np.float32))
            indices_list.append(prim.indices.astype(np.int64) + vertex_offset)
            tri_inst_list.append(np.full(prim.indices.shape[0], instance, np.int32))
            vert_inst_list.append(np.full(count, instance, np.int32))
            vertex_offset += count

    if not inst_nodes:
        raise ValueError("no renderable geometry in assets")

    positions = np.concatenate(positions_list).astype(np.float32)
    normals = np.concatenate(normals_list)
    tangents = np.concatenate(tangents_list)
    uvs = np.concatenate(uvs_list)
    indices = np.concatenate(indices_list).astype(np.int32)
    if indices.size and int(indices.max()) >= positions.shape[0]:
        # belt-and-braces bounds guard: the loader validates per-primitive
        # index bounds (loaders/gltf.py::_build_meshes), but no loader escape
        # may ever surface as a raw numpy IndexError in the gathers below —
        # fatal tier of the two-tier failure policy (SURVEY.md §5.3)
        from vktf.loaders.gltf import GltfError

        raise GltfError(
            f"triangle index {int(indices.max())} out of bounds for "
            f"{positions.shape[0]} vertices"
        )
    tri_instance = np.concatenate(tri_inst_list)
    vertex_instance = np.concatenate(vert_inst_list)
    inst_material = np.asarray(inst_materials, np.int32)
    tri_material = inst_material[tri_instance]

    # ---- static triangle-stream spatial order ------------------------------
    # Sort the triangle stream ONCE by 3-D Morton code of the world-space
    # centroid (initial node transforms, propagated on the host). Spatially
    # coherent chunks give the Pallas streaming rasterizer tight per-chunk
    # bboxes even before the per-frame screen-space sort. Draw order —
    # and therefore the depth-tie rule — becomes this sorted order, shared by
    # every backend and the numpy oracle.
    parents_np = np.asarray(flat_parents, np.int64)
    node_global_np = np.stack(flat_locals).astype(np.float64)
    for lv_start, lv_end in level_bounds[1:]:
        node_global_np[lv_start:lv_end] = np.einsum(
            "nij,njk->nik",
            node_global_np[parents_np[lv_start:lv_end]],
            node_global_np[lv_start:lv_end],
        )
    inst_mats = node_global_np[np.asarray(inst_nodes, np.int64)]
    tri_m = inst_mats[tri_instance]  # (T,4,4)
    centroid = (
        positions[indices[:, 0]] + positions[indices[:, 1]] + positions[indices[:, 2]]
    ) / 3.0
    world_c = (
        np.einsum("tij,tj->ti", tri_m[:, :3, :3], centroid) + tri_m[:, :3, 3]
    )
    lo, hi = world_c.min(axis=0), world_c.max(axis=0)
    q = ((world_c - lo) / np.maximum(hi - lo, 1e-9) * 1023.0).astype(np.uint64)

    def _spread3(x):  # 10 bits -> every 3rd bit
        x &= 0x3FF
        x = (x | (x << 16)) & 0x30000FF
        x = (x | (x << 8)) & 0x300F00F
        x = (x | (x << 4)) & 0x30C30C3
        x = (x | (x << 2)) & 0x9249249
        return x

    morton = _spread3(q[:, 0]) | (_spread3(q[:, 1]) << 1) | (_spread3(q[:, 2]) << 2)
    tri_perm = np.argsort(morton, kind="stable")
    indices = indices[tri_perm]
    tri_instance = tri_instance[tri_perm]
    tri_material = tri_material[tri_perm]

    # ---- materials + textures ---------------------------------------------
    texture_entries: list[tuple] = []  # (TextureData, sampler_dict)
    texture_index: dict[tuple[Optional[int], str], int] = {}

    # Decode every referenced texture in parallel up front — the analogue of
    # the reference's std::async KTX fan-out (model.cppm:333-349). PIL, zstd
    # and the native decoders release the GIL, so a thread pool scales the
    # dominant load cost by ~core count at Sponza scale.
    decode_jobs: dict[tuple[int, str], object] = {}
    for material in materials:
        if material is None:
            continue
        pbr = material.pbr_metallic_roughness
        refs = [(material.normal_texture, "normal")]
        if pbr is not None:
            refs += [(pbr.base_color_texture, "base_color"),
                     (pbr.metallic_roughness_texture, "metallic_roughness")]
        for tex, kind in refs:
            if tex is not None:
                decode_jobs.setdefault((id(tex), kind), (tex, kind))
    decoded: dict[tuple[int, str], object] = {}
    if decode_jobs:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor() as pool:
            futures = {
                key: pool.submit(decode_texture, tex, kind, log)
                for key, (tex, kind) in decode_jobs.items()
            }
            decoded = {key: f.result() for key, f in futures.items()}

    def add_texture(gltf_texture, kind: str) -> int:
        key = (id(gltf_texture) if gltf_texture is not None else None, kind)
        if key in texture_index:
            return texture_index[key]
        data = decoded.get(key) if gltf_texture is not None else None
        if data is None:
            if gltf_texture is not None:
                # decode failed: reference would reject the material
                # (model.cppm:391-409); we fall back to defaults + keep going.
                counters.add("textures.decode_failed")
                log.error(f"Using default {kind} texture after decode failure")
            data = default_texture_data(kind)
        sampler = {}
        if gltf_texture is not None and gltf_texture.sampler is not None:
            s = gltf_texture.sampler
            sampler = {
                "mag_filter": s.mag_filter,
                "min_filter": s.min_filter,
                "mipmap_mode": s.mipmap_mode,
                "wrap_u": s.wrap_u,
                "wrap_v": s.wrap_v,
            }
        texture_index[key] = len(texture_entries)
        texture_entries.append((data, sampler))
        return texture_index[key]

    M = len(materials)
    mat_base_color = np.ones((M, 4), np.float32)
    mat_mr = np.ones((M, 2), np.float32)
    mat_normal_scale = np.ones(M, np.float32)
    mat_alpha = np.zeros((M, 2), np.float32)
    mat_alpha[:, 1] = 0.5
    mat_textures = np.zeros((M, 3), np.int32)

    for i, material in enumerate(materials):
        if material is None:
            # glTF default material: base (1,1,1,1), metallic 1, roughness 1
            mat_textures[i, 0] = add_texture(None, "base_color")
            mat_textures[i, 1] = add_texture(None, "metallic_roughness")
            mat_textures[i, 2] = add_texture(None, "normal")
            continue
        pbr = material.pbr_metallic_roughness
        if pbr is None:
            # reference rejects non-PBR materials (model.cppm:375-380); we
            # substitute the default PBR params and log.
            log.error(
                f"Material {material.name} has no PBR metallic-roughness; using defaults"
            )
            pbr_base, pbr_metallic, pbr_rough = np.ones(4, np.float32), 1.0, 1.0
            base_tex = mr_tex = None
        else:
            pbr_base = pbr.base_color_factor
            pbr_metallic = pbr.metallic_factor
            pbr_rough = pbr.roughness_factor
            base_tex = pbr.base_color_texture
            mr_tex = pbr.metallic_roughness_texture
        mat_base_color[i] = pbr_base
        mat_mr[i] = (pbr_metallic, pbr_rough)
        mat_normal_scale[i] = material.normal_scale
        mat_alpha[i] = (_ALPHA_MODES.get(material.alpha_mode, 0), material.alpha_cutoff)
        mat_textures[i, 0] = add_texture(base_tex, "base_color")
        mat_textures[i, 1] = add_texture(mr_tex, "metallic_roughness")
        mat_textures[i, 2] = add_texture(material.normal_texture, "normal")

    texture_pool = build_texture_pool(texture_entries)

    # quad-packed per-material pool for the shade-table path (texture_pack.py)
    from vktf.ops.texture_pack import sampler_code

    material_specs = []
    for i in range(M):
        slot_samplers = [texture_entries[mat_textures[i, s]][1]
                         for s in range(3)]
        codes = [sampler_code(s) for s in slot_samplers]
        if any(c != codes[0] for c in codes[1:]):
            # per-slot samplers are honored exactly (material.cppm:138-171);
            # a scene containing any mixed-sampler material compiles the
            # per-slot pool-gather path (SceneMeta.mixed_samplers)
            counters.add("materials.per_slot_samplers")
        material_specs.append(
            {
                "base": texture_entries[mat_textures[i, 0]][0],
                "mr": texture_entries[mat_textures[i, 1]][0],
                "normal": texture_entries[mat_textures[i, 2]][0],
                "samplers": slot_samplers,
            }
        )
    material_pool = build_material_pool(material_specs, log)
    mat_meta = np.concatenate(
        [
            material_pool.base_row[:, None].astype(np.float32),
            material_pool.width0[:, None].astype(np.float32),
            material_pool.num_levels[:, None].astype(np.float32),
            material_pool.sampler_codes.astype(np.float32),
        ],
        axis=1,
    )  # (M, 6): base_row, w0, levels, slot sampler codes (texture_pack)

    # ---- precomputed per-triangle tables (ops.shade_table inputs) ----------
    # Corner attributes in OBJECT space, component-major (36, T): row =
    # attr_base + channel*3 + corner. Gathering these per frame cost ~150 ms
    # at 262k triangles (36 element-gathers); precomputing leaves the frame
    # with a single (T,16) instance-matrix row gather.
    num_tris = indices.shape[0]
    tri_corner = np.empty((36, num_tris), np.float32)
    for base, attr, nch in ((0, uvs, 2), (6, positions, 3),
                            (15, normals, 3), (24, tangents, 4)):
        for c in range(nch):
            col = np.ascontiguousarray(attr[:, c])
            for i in range(3):
                tri_corner[base + c * 3 + i] = col[indices[:, i]]
    # Static material columns of the shade table (15, T): base color (4),
    # metallic-roughness (2), normal scale (1), mat_meta (6), alpha mode +
    # cutoff (2).
    mat_cols = np.concatenate(
        [mat_base_color, mat_mr, mat_normal_scale[:, None], mat_meta, mat_alpha],
        axis=1,
    ).astype(np.float32)  # (M, 15)
    tri_static_cols = np.ascontiguousarray(mat_cols[tri_material].T)  # (15,T)

    # ---- lights ------------------------------------------------------------
    light_nodes, light_types, light_colors = [], [], []
    for asset, node_idx, _parent, _level in sorted_entries:
        node = asset.nodes[node_idx]
        if node.light is None:
            continue
        light = asset.lights[node.light]
        light_nodes.append(node_flat_index[(id(asset), node_idx)])
        light_types.append(0 if light.type == "directional" else 1)
        light_colors.append(light.color)

    scene = RenderScene(
        node_local=jnp.asarray(np.stack(flat_locals)),
        node_parent=jnp.asarray(np.asarray(flat_parents, np.int32)),
        positions=jnp.asarray(positions),
        normals=jnp.asarray(normals),
        tangents=jnp.asarray(tangents),
        uvs=jnp.asarray(uvs),
        indices=jnp.asarray(indices),
        tri_instance=jnp.asarray(tri_instance),
        tri_material=jnp.asarray(tri_material),
        vertex_instance=jnp.asarray(vertex_instance),
        inst_node=jnp.asarray(np.asarray(inst_nodes, np.int32)),
        inst_aabb=jnp.asarray(np.stack(inst_aabbs)),
        mat_base_color=jnp.asarray(mat_base_color),
        mat_metallic_roughness=jnp.asarray(mat_mr),
        mat_normal_scale=jnp.asarray(mat_normal_scale),
        mat_alpha=jnp.asarray(mat_alpha),
        mat_textures=jnp.asarray(mat_textures),
        texture_pool=texture_pool,
        mat_meta=jnp.asarray(mat_meta),
        quad_pool=material_pool.quads,
        tri_corner=jnp.asarray(tri_corner),
        tri_static_cols=jnp.asarray(tri_static_cols),
        light_node=jnp.asarray(np.asarray(light_nodes, np.int32).reshape(-1)),
        light_type=jnp.asarray(np.asarray(light_types, np.int32).reshape(-1)),
        light_color=jnp.asarray(
            np.asarray(light_colors, np.float32).reshape(-1, 3)
        ),
    )
    peel = _estimate_peel_layers(mat_alpha, tri_material, tri_instance, log)
    meta = SceneMeta(
        level_slices=tuple(level_bounds),
        num_lights=len(light_nodes),
        num_instances=len(inst_nodes),
        num_triangles=int(indices.shape[0]),
        num_vertices=int(positions.shape[0]),
        peel_layers=peel,
        mixed_samplers=material_pool.mixed,
        mirror_wrap=material_pool.mirror,
    )
    aux = {"texture_entries": texture_entries}
    return scene, meta, aux
