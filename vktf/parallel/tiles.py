"""Multi-device sharded rendering: sort-first bands x sort-last geometry.

The reference is strictly single-GPU — its "communication fabric" is queue
submission + semaphores on one device (SURVEY.md §5.8). Here one frame is
distributed over a 2D device mesh with XLA collectives (NCCL on GPUs),
running the SAME stages as the single-device production path
(ops.raster_pallas raster kernel + ops.shade_table deferred shading):

  * axis ``sp`` (sample/spatial parallel): the framebuffer splits into
    horizontal BANDS of tile rows; each device rasterizes + shades only its
    band (classic sort-first parallel rendering). The raster kernel takes
    the band's pixel-row offset as an input, so every band runs the
    identical compiled kernel.
  * axis ``gp`` (geometry parallel): the triangle stream is block-sharded;
    each device Morton-sorts, bins and rasterizes only its shard for its
    band, emitting GLOBAL triangle ids. Depth compositing is TWO
    ``lax.pmin`` collectives over ``gp`` (classic sort-last compositing):
    first on depth, then on triangle id among depth-winners — which
    reproduces the single-device lexicographic (depth, draw-order) rule
    exactly, including background (id -1 participates at clear depth,
    exactly like the single-device accumulator), because block sharding
    keeps global ids monotonic in (gp_rank, local_id).
  * shading splits each band's composited visibility over ``gp``: the
    ranks of a band shade disjoint 1/gp slices of its flat block-layout
    pixel stream (pallas_shade_resolve_tiled px_slice), reassembled with
    one ``all_gather`` + one band-level _tiled_assemble. Sample-rate
    shading takes disjoint row slices through pallas_shade_resolve.
  * the per-TRIANGLE prep stages (triangle setup + the shade-table build)
    shard over the WHOLE gp*sp mesh: every device computes a 1/(gp*sp)
    micro-shard, then one sp-axis all_gather hands each gp rank its raster
    shard and one (gp, sp) all_gather replicates the shade table (shading
    gathers arbitrary triangle rows). Only O(nodes + instances) work
    (transform propagation, light extraction) stays replicated.

Everything is expressed with shard_map over a Mesh; meshes are 1-D or 2-D
by algorithm alone (the devices of one host are joined all to all).
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from vktf.config import RenderConfig
from vktf.ops.raster_pallas import pack_tri_rows, rasterize_pallas
from vktf.ops.pipeline import (
    _tiled_assemble,
    gather_world_lights,
    pallas_shade_resolve,
    pallas_shade_resolve_tiled,
)
from vktf.ops.shade_table import build_shade_table
from vktf.ops.vertex import propagate_transforms, triangle_setup_cm
from vktf.scene.flatten import RenderScene, SceneMeta


def make_render_mesh(devices=None, gp: int = 1, sp: int | None = None) -> Mesh:
    """Build a (gp, sp) render mesh from the available devices."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if sp is None:
        sp = n // gp
    if gp * sp != n:
        raise ValueError(f"mesh gp*sp = {gp}*{sp} != {n} devices")
    return Mesh(np.asarray(devices).reshape(gp, sp), ("gp", "sp"))


def _pad_axis0(x, multiple):
    n = x.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return x
    pad_block = jnp.zeros((pad,) + x.shape[1:], x.dtype)
    return jnp.concatenate([x, pad_block], axis=0)


def _pad_axis1(x, multiple):
    n = x.shape[1]
    pad = (-n) % multiple
    if pad == 0:
        return x
    return jnp.pad(x, ((0, 0), (0, pad)))


def render_frame_sharded(
    scene: RenderScene,
    view_projection,
    camera_position,
    *,
    meta: SceneMeta,
    config: RenderConfig,
    mesh: Mesh,
    debug_visibility: bool = False,
) -> jnp.ndarray:
    """One frame over the (gp, sp) mesh; returns planar (3, H, W) uint8 RGB.

    debug_visibility=True instead returns the post-composite
    (win_id, win_depth) arrays shaped ([L,] S, ph, pw) — the sort-last
    merge's output — for parity diagnostics against the single-chip raster.
    """
    gp = mesh.shape["gp"]
    sp = mesh.shape["sp"]
    th, tw = config.tile_shape
    pw = config.padded_width

    # the framebuffer pads to sp whole bands of tile rows
    tiles_y = -(-config.height // th)
    tiles_y += (-tiles_y) % sp
    ph = tiles_y * th
    band_h = ph // sp
    # pixel-rate: each gp rank shades a 1/gp slice of the band's flat
    # block-layout pixel stream; sample-rate: a 1/gp row slice
    tiled_shade = not debug_visibility and config.shading_rate == "pixel"
    n_px_band = band_h * pw
    if tiled_shade:
        if n_px_band % gp != 0:
            raise ValueError(
                f"band pixels {n_px_band} not divisible by gp={gp}"
            )
    elif band_h % gp != 0:
        raise ValueError(
            f"band height {band_h} not divisible by gp={gp} for row-split shading"
        )

    interpret = config.kernel_interpret()

    # Replicated O(nodes + instances) prep only (SURVEY §2 Model::Update /
    # Scene::Update analogues) — everything O(T) happens inside shard_map.
    node_global = propagate_transforms(
        scene.node_local, scene.node_parent, meta.level_slices
    )
    lights = gather_world_lights(
        node_global, scene.light_node, scene.light_type, scene.light_color
    )
    inst_matrix = node_global[scene.inst_node]  # (I,4,4)

    # Pad triangle tables to a gp*sp multiple. Padded rows are masked out of
    # `valid` EXPLICITLY by global row index below: zero-padded corners form
    # a degenerate point-triangle whose setup arithmetic runs through
    # inf/NaN, and whether that yields valid=False is a compiler decision —
    # XLA folds it differently jitted vs eager (observed: padded rows
    # rastered as real fragments at the projected world origin under jit).
    # Their (finite or NaN) shade-table rows are never gathered because
    # masked ids never win a sample.
    n_dev = gp * sp
    tri_corner = _pad_axis1(scene.tri_corner, n_dev)  # (36, T_pad)
    static_cols = _pad_axis1(scene.tri_static_cols, n_dev)
    tri_instance = _pad_axis0(scene.tri_instance, n_dev)  # (T_pad,)
    t_pad = tri_instance.shape[0]
    t_micro = t_pad // n_dev  # prep micro-shard per device
    mat16 = inst_matrix.reshape(-1, 16)

    if debug_visibility == "winner":
        out_specs = (P(None, "sp", None), P(None, "sp", None), P(None, None))
    elif debug_visibility:
        vis_spec = (P(None, "sp", None)
                    if config.resolved_peel_layers(meta.peel_layers) == 1
                    else P(None, None, "sp", None))
        out_specs = (vis_spec, vis_spec, P(None, None))
    else:
        out_specs = P(None, "sp", None)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(None, ("gp", "sp")), P(None, ("gp", "sp")),
                  P(("gp", "sp"))),
        out_specs=out_specs,
        check_vma=False,
    )
    def device_frame(tc_micro, stat_micro, tin_micro):
        gp_rank = jax.lax.axis_index("gp")
        sp_rank = jax.lax.axis_index("sp")
        band_y0 = sp_rank.astype(jnp.int32) * band_h

        # per-triangle prep on this device's 1/(gp*sp) micro-shard
        mrows_micro = mat16[tin_micro]  # (t_micro, 16)
        micro_row0 = (gp_rank * sp + sp_rank).astype(jnp.int32) * t_micro
        is_real = (
            micro_row0 + jnp.arange(t_micro, dtype=jnp.int32)
            < meta.num_triangles
        )
        # the single-device packed setup on this micro-shard: per-lane
        # math is position-independent, so micro-shard rows are bit-equal
        # to the single-device rows; global ids are baked at pack time and
        # padding rows are masked out of `valid`
        flat = triangle_setup_cm(
            tc_micro, mrows_micro, view_projection,
            config.width, config.height, flat_out=True,
        )
        setup_micro = pack_tri_rows(flat, extra_valid=is_real,
                                    id_base=micro_row0)
        setup_micro["mrows"] = mrows_micro
        shard_scene = SimpleNamespace(
            tri_corner=tc_micro, tri_static_cols=stat_micro,
            tri_instance=tin_micro,
        )
        table_micro = build_shade_table(setup_micro, shard_scene)
        # (t_micro, 2*ROW) u16
        # shading gathers arbitrary rows -> full table on every device; the
        # ("gp", "sp") gather order is gp-major = global block order
        table = jax.lax.all_gather(
            table_micro, ("gp", "sp"), axis=0, tiled=True
        )  # (t_pad, 2*ROW)
        # raster wants this gp rank's full contiguous shard: gather the sp
        # micro-shards (blocks gp_rank*sp .. gp_rank*sp+sp-1)
        setup_local = {
            k: jax.lax.all_gather(setup_micro[k], "sp", axis=ax, tiled=True)
            for k, ax in (("tri_data", 1), ("bbox_rows", 1), ("valid", 0))
        }
        # SEPARATE barriers: the raster consumes only setup_local, so the
        # table collective is free to overlap raster execution — shade is
        # its first consumer.
        table = jax.lax.optimization_barrier(table)
        setup_local = jax.lax.optimization_barrier(setup_local)

        # sort-first: this device's band, sort-last: its triangle shard
        layers = config.resolved_peel_layers(meta.peel_layers)
        tri_id, depth = rasterize_pallas(
            setup_local, band_h, pw,
            tile_shape=config.tile_shape,
            msaa_samples=config.msaa_samples,
            chunk=config.pallas_chunk,
            interpret=interpret,
            sort="morton",
            y_offset=band_y0,
            layers=layers,
            assemble=not tiled_shade,
        )  # assembled ([L,] S, band_h, pw) — or raw tile blocks
        #    ([L,] Tb, S*th, tw) when tiled_shade; ids GLOBAL, -1 background

        # sort-last compositing: lexicographic (depth, id) min over gp.
        # Uncovered samples carry (clear depth, id -1), which reproduces the
        # single-chip rule that a triangle at exactly the clear depth loses
        # to the background.
        imax = jnp.int32(2**31 - 1)

        def lexmin_gp(d, i):
            gd = jax.lax.pmin(d, "gp")
            gi = jax.lax.pmin(jnp.where(d == gd, i, imax), "gp")
            return gd, gi

        if layers == 1:
            win_depth, win_id = lexmin_gp(depth, tri_id)
        else:
            # merge each rank's sorted K-layer list into the global nearest
            # K: K rounds of (lexmin over gp of every rank's current head;
            # winning ranks advance their local pointer). Real-triangle
            # heads are globally unique (block-sharded ids); background
            # heads (clear depth, id -1) may win on several ranks at once,
            # but every deeper background entry is identical, so the
            # multi-advance is harmless.
            ptr = jnp.zeros_like(tri_id[0])
            out_d, out_i = [], []
            for _k in range(layers):
                head_d, head_i = depth[0], tri_id[0]
                for l in range(1, layers):
                    sel = ptr == l
                    head_d = jnp.where(sel, depth[l], head_d)
                    head_i = jnp.where(sel, tri_id[l], head_i)
                gd, gi = lexmin_gp(head_d, head_i)
                ptr = ptr + ((head_d == gd) & (head_i == gi)).astype(ptr.dtype)
                out_d.append(gd)
                out_i.append(gi)
            win_depth = jnp.stack(out_d)
            win_id = jnp.stack(out_i)
        win_id, win_depth = jax.lax.optimization_barrier((win_id, win_depth))
        if debug_visibility == "winner":
            # replicate pallas_shade_resolve's pixel-rate winner on the
            # merged arrays (diagnostics): per layer, the depth-winning
            # sample's triangle id
            imax_w = jnp.int32(2**31 - 1)
            d_min = jnp.min(win_depth, axis=1, keepdims=True)
            cand = jnp.where((win_depth == d_min) & (win_id >= 0),
                             win_id, imax_w)
            id_px = jnp.min(cand, axis=1)
            id_px = jnp.where(id_px == imax_w, -1, id_px)
            return id_px, d_min[:, 0], table
        if debug_visibility:
            return win_id, win_depth, table

        if tiled_shade:
            # the single-device tile-layout shade on this rank's 1/gp slice
            # of the band's flat block-layout pixel stream (winner/coverage
            # reduction is a cheap replicated reshape+min)
            band_cfg = config.replace(height=band_h)
            rank_px = n_px_band // gp
            rgb_slice = pallas_shade_resolve_tiled(
                win_id, win_depth, scene, table, lights, camera_position,
                config=band_cfg, per_slot_samplers=meta.mixed_samplers,
                y0=band_y0.astype(jnp.float32),
                px_slice=(gp_rank * rank_px, rank_px), assemble=False,
            )  # (3, rank_px) u8, block-layout flat
            rgb_flat = jax.lax.all_gather(
                rgb_slice, "gp", axis=1, tiled=True
            )  # (3, n_px_band)
            return _tiled_assemble(rgb_flat, band_cfg)  # (3, band_h, pw)

        # sample-rate shading: disjoint row-slice of the band per gp rank
        rh = band_h // gp
        rows0 = gp_rank * rh
        s_count = tri_id.shape[-3]
        if layers == 1:
            slicer = lambda v: jax.lax.dynamic_slice(
                v, (0, rows0, 0), (s_count, rh, pw)
            )
        else:
            slicer = lambda v: jax.lax.dynamic_slice(
                v, (0, 0, rows0, 0), (layers, s_count, rh, pw)
            )
        rgba_slice = pallas_shade_resolve(
            slicer(win_id), scene, table, lights, camera_position,
            config=config, y0=band_y0 + rows0, depth=slicer(win_depth),
            per_slot_samplers=meta.mixed_samplers,
        )  # (3, rh, pw) u8
        rgba = jax.lax.all_gather(
            rgba_slice, "gp", axis=1, tiled=True
        )  # (3, band_h, pw)
        return rgba

    out = device_frame(tri_corner, static_cols, tri_instance)
    if debug_visibility:
        return out  # (win_id, win_depth), bands concatenated over rows
    return out[:, : config.height, : config.width]  # (3, ph, pw) -> (3, H, W)


def make_sharded_frame_fn(meta: SceneMeta, config: RenderConfig, mesh: Mesh):
    """Jitted multi-chip frame function (same signature as make_frame_fn,
    including the device-side present encode chain — preview downsample +
    optional yuv420, ops/present.py)."""
    from vktf.ops.present import make_present_encoder

    _present_enc = make_present_encoder(config)

    def frame(scene, view_projection, camera_position):
        out = render_frame_sharded(
            scene, view_projection, camera_position,
            meta=meta, config=config, mesh=mesh,
        )
        return _present_enc(out)

    return jax.jit(frame)
