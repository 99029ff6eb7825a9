"""Pallas visibility rasterizer, compiled for the GPU through Triton.

The hot half of the reference's fixed-function raster pipeline
(graphics_pipeline.cppm:205-234: triangle list, back-face cull, depth Less,
MSAA) as one hand-written kernel. The plain XLA form (ops.raster_tiled) is a
``lax.map`` over tiles with a ``fori_loop`` over triangle chunks inside: a
long chain of small sequential launches that each send (chunk, samples)
edge and depth planes through device memory. This kernel keeps a tile's
K-best (depth, id) accumulators in registers across the whole triangle
stream and writes them once.

Design:
  * One program per framebuffer tile; the programs run in parallel with no
    carry between them.
  * Triangles stream in screen-space Morton order (stream_perm), in chunks
    of ``chunk`` triangles. An XLA prologue builds, per BIN of tiles, the
    list of chunks whose bounding box touches the bin; each program loads
    its bin's hit count and hit list itself.
  * Inside a hit chunk, a group bounding box (``group`` consecutive
    triangles) and then each triangle's own bounding box gate the vector
    work with block-uniform branches, so a program evaluates its samples
    only for triangles that can touch its tile.
  * Triangle rows are plain scalar loads from global memory (L1/L2 cached).
  * Depth follows the single-chip semantic exactly: the lexicographic
    minimum of (depth, draw-order id), so the Morton stream order never
    changes who wins a tie. With ``layers`` K > 1 the kernel keeps the K
    nearest fragments per sample (depth peeling for MASK/BLEND).

Outputs per framebuffer tile: winning triangle id (int32, -1 background)
and depth (f32, 1.0 clear) per MSAA sample, in a (S*th, tw) block whose row
is y*S + s (the samples of one pixel row are adjacent).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from vktf.ops.raster_xla import BACKGROUND, SAMPLE_OFFSETS

# tri_data row layout (component-major, (TRI_ROWS, T) f32). All plane rows
# are ANCHORED at the triangle's bbox corner (triangle_setup): constant = the
# plane's value at the corner, evaluated as a*(sx-ax) + b*(sy-ay) + const.
#   0..8  edge planes e_i = (a, b, e_i(anchor)), i = 0,1,2
#   9..11 depth plane (a, b, depth(anchor))  [inv_det folded]
#  12..14 w-recip plane (a, b, w_recip(anchor))  [positive inside w > 0]
#  15     original triangle id (f32-exact for T < 2^24), -1 for invalid
#  16..18 top/left flag per edge: -1.0 on a top/left edge (e == 0 is
#         inside), 0.0 otherwise
TRI_ROWS = 19

# Framebuffer pixels covered by one hit list (a bin of tiles). Hit lists are
# built per bin, not per tile, so the prologue's (bins x chunks) overlap
# matrix stays small; each tile program then skips the bin's triangles that
# miss it with its own bounding-box tests.
BIN_SHAPE = (64, 128)

# Kernel tile (height, width) in pixels and Triton launch parameters
# (chosen on an H100: see PERF.md "Findings").
TILE_SHAPE = (8, 32)
NUM_WARPS = 2
NUM_STAGES = 1


def pack_tri_data(setup, perm=None, id_base=0):
    """Pack triangle_setup outputs into the kernel stream layout.

    perm optionally reorders the stream (screen-space Morton order); row 15
    carries the ORIGINAL draw-order id (offset by id_base for gp-sharded
    triangle blocks) so depth ties stay exact.
    """
    edge, zw, valid = (
        # coverage uses the screen-space raster planes when the setup
        # provides them (needle-free for slivers; ops/vertex.py)
        setup.get("edge_raster", setup["edge"]),
        setup["zw"],
        setup["valid"],
    )
    num_tris = edge.shape[0]
    tri_ids = jnp.arange(num_tris, dtype=jnp.float32) + jnp.asarray(
        id_base, jnp.float32
    )
    flat = {
        "edges_raster": [[edge[:, i, c] for c in range(3)] for i in range(3)],
        "zplane": [zw[:, 0, c] for c in range(3)],
        "wplane": [zw[:, 1, c] for c in range(3)],
    }
    tri_data = _stack_rows(_tri_rows(flat, valid, tri_ids))
    if perm is not None:
        tri_data = tri_data[:, perm]
    return tri_data


def _stack_rows(rows):
    # 1-D concatenate + reshape keeps every producer a dense (T,) vector
    return jnp.concatenate(rows).reshape(len(rows), rows[0].shape[0])


def pack_tri_rows(flat, extra_valid=None, id_base=0):
    """pack_tri_data + the binning bbox rows + the shade-table-build inputs,
    built straight from the FLAT triangle-setup components
    (vertex.py flat_out=True): every value is a (T,) vector stacked once
    into dense (C, T) rows.

    Returns the PACKED setup dict consumed by rasterize_pallas /
    build_shade_table / stream_perm:
      tri_data  (TRI_ROWS, T) f32 — the raster kernel stream
      bbox_rows (4, T) f32 valid-masked binning bboxes
      edge9     (9, T) f32 cofactor planes (table build)
      anchor2   (2, T) f32
      valid     (T,) bool (final: setup validity AND extra_valid)
    """
    valid = _packed_valid(flat, extra_valid)
    num_tris = valid.shape[0]
    tri_ids = jnp.arange(num_tris, dtype=jnp.float32) + jnp.asarray(
        id_base, jnp.float32
    )
    b0, b1, b2, b3 = flat["bbox_cols"]
    bbox_rows = [
        jnp.where(valid, b0, 2**30).astype(jnp.float32),
        jnp.where(valid, b1, 2**30).astype(jnp.float32),
        jnp.where(valid, b2, -(2**30)).astype(jnp.float32),
        jnp.where(valid, b3, -(2**30)).astype(jnp.float32),
    ]
    edge9 = [c for e in flat["edges"] for c in e]
    anchor2 = [flat["anchor_x"], flat["anchor_y"]]
    return dict(tri_data=_stack_rows(_tri_rows(flat, valid, tri_ids)),
                bbox_rows=_stack_rows(bbox_rows),
                edge9=_stack_rows(edge9), anchor2=_stack_rows(anchor2),
                valid=valid)


def _packed_valid(flat, extra_valid=None):
    """The packed path's validity rule: setup validity AND a non-empty
    clamped screen bbox (PER-TRIANGLE screen cull).

    Frame output is identical to the per-instance frustum cull: an
    instance-culled triangle lies entirely outside the frustum, where no
    sample can pass the kernel's exact inside/0<=depth<=1/w>0 tests, and its
    clamped bbox is empty so the raster never visits it — while a triangle
    this rule culls (empty clamped bbox) could never produce a sample
    either. extra_valid carries the sharded path's is_real padding mask."""
    b0, b1, b2, b3 = flat["bbox_cols"]
    valid = flat["valid"] & (b2 > b0) & (b3 > b1)
    if extra_valid is not None:
        valid = valid & extra_valid
    return valid


def _tri_rows(flat, valid, tri_ids):
    """The TRI_ROWS raster stream rows as (T,) vectors — the single source
    of the row semantics for pack_tri_data and pack_tri_rows."""
    er = flat["edges_raster"]
    zp, wp = flat["zplane"], flat["wplane"]

    def no_negzero(c):
        # exact-zero plane constants as +0.0, so an exactly-zero evaluation
        # at the anchor is +0 as well
        return jnp.where(c == 0.0, jnp.float32(0.0), c)

    rows = []
    for e in er:
        rows += [e[0], e[1], no_negzero(e[2])]
    rows += [zp[0], zp[1], no_negzero(zp[2])]
    rows += [wp[0], wp[1], no_negzero(wp[2])]
    rows += [jnp.where(valid, tri_ids, -1.0)]
    for e in er:  # rows 16..18: top/left edge flags
        tl = (e[0] > 0.0) | ((e[0] == 0.0) & (e[1] > 0.0))
        rows.append(jnp.where(tl, -1.0, 0.0))
    assert len(rows) == TRI_ROWS
    return rows


def _part1by1(x):
    """Spread the low 16 bits of x to even bit positions."""
    x = x & 0xFFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _pad_cols(x, multiple, fill=0.0):
    n = x.shape[-1]
    pad = (-n) % multiple
    if pad == 0:
        return x
    return jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], constant_values=fill)


def _bbox_rows(setup):
    """(4, T) f32 valid-masked screen bboxes (x0, y0, x1, y1)."""
    if "bbox_rows" in setup:  # packed setup (pack_tri_rows)
        return setup["bbox_rows"]
    valid, bbox = setup["valid"], setup["bbox"]
    return jnp.stack([
        jnp.where(valid, bbox[:, 0], 2**30).astype(jnp.float32),
        jnp.where(valid, bbox[:, 1], 2**30).astype(jnp.float32),
        jnp.where(valid, bbox[:, 2], -(2**30)).astype(jnp.float32),
        jnp.where(valid, bbox[:, 3], -(2**30)).astype(jnp.float32),
    ])


def stream_perm(setup, chunk: int = 64, granularity: int = 16):
    """The screen-Morton stream permutation as a (t_pad,) array.

    Sorting the stream by the Morton code of each triangle's screen bbox
    center makes consecutive chunks screen-local, so the per-bin chunk hit
    lists stay short. Invalid triangles and stream padding key to INT_MAX
    and sort to the tail. The order affects only raster locality, never
    output (lexicographic depth ties use original ids), so the split-stage
    frame program caches it across frames and re-sorts only when the
    camera moves past RenderConfig.resort_threshold.
    """
    valid = setup["valid"]
    t = valid.shape[0]
    t_pad = -(-t // chunk) * chunk
    g = granularity
    br = _bbox_rows(setup)
    cx = jnp.clip((br[0] + br[2]).astype(jnp.int32) // (2 * g), 0, 1023)
    cy = jnp.clip((br[1] + br[3]).astype(jnp.int32) // (2 * g), 0, 1023)
    key = _part1by1(cx) | (_part1by1(cy) << 1)
    key = jnp.where(valid, key, jnp.int32(2**31 - 1))
    if t_pad != t:
        key = jnp.pad(key, (0, t_pad - t), constant_values=jnp.int32(2**31 - 1))
    return jnp.argsort(key)


def _raster_kernel(
    counts_ref,  # (num_bins,) i32: hit chunks per bin
    hits_ref,  # (num_bins, n_chunks) i32: hit chunk ids, counted prefix
    params_ref,  # (1,) i32: [0] = framebuffer y offset (sharded bands)
    data_ref,  # (TRI_ROWS, T_pad) f32 triangle stream
    bbox_ref,  # (8, T_pad) f32: triangle bboxes, then group bboxes
    *out_refs,  # per layer: id (rows, tw) i32, depth (rows, tw) f32
    tiles_x: int,
    bin_tiles: tuple,
    bins_x: int,
    tile_h: int,
    tile_w: int,
    chunk: int,
    group: int,
    sample_offsets: tuple,
    layers: int,
):
    tile = pl.program_id(0)
    ty = tile // tiles_x
    tx = tile % tiles_x
    bin_idx = (ty // bin_tiles[0]) * bins_x + tx // bin_tiles[1]
    x0 = (tx * tile_w).astype(jnp.float32)
    y0 = (ty * tile_h + params_ref[0]).astype(jnp.float32)
    x1 = x0 + float(tile_w)
    y1 = y0 + float(tile_h)

    s_count = len(sample_offsets)
    rows = s_count * tile_h
    shape = (rows, tile_w)
    r = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    c = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    s = r & (s_count - 1)
    off_x = jnp.zeros(shape, jnp.float32)
    off_y = jnp.zeros(shape, jnp.float32)
    for k, (ox, oy) in enumerate(sample_offsets):
        off_x = jnp.where(s == k, float(ox), off_x)
        off_y = jnp.where(s == k, float(oy), off_y)
    sx = x0 + c.astype(jnp.float32) + off_x
    sy = y0 + (r // s_count).astype(jnp.float32) + off_y

    def rasterize(t, accs):
        # plane rows are anchored at the bbox corner: evaluate with deltas,
        # which keeps f32 magnitudes small (triangle_setup docstring)
        dx = sx - bbox_ref[0, t]
        dy = sy - bbox_ref[1, t]

        def plane(row):
            return (data_ref[row, t] * dx + data_ref[row + 1, t] * dy
                    + data_ref[row + 2, t])

        inside = None
        for i in range(3):  # top-left fill rule, as ops.raster_xla
            e = plane(3 * i)
            ok = (e > 0.0) | ((e == 0.0) & (data_ref[16 + i, t] < 0.0))
            inside = ok if inside is None else inside & ok
        depth = plane(9)
        ok = inside & (plane(12) > 0.0) & (depth >= 0.0) & (depth <= 1.0)
        # branchless insertion into the sorted K-layer list: the candidate
        # bubbles down, displaced entries continue down in its place
        # (lexicographic (depth, draw-order id); K = 1 is a plain z-test)
        cur_d = depth
        cur_i = jnp.full(shape, data_ref[15, t].astype(jnp.int32))
        out = []
        for l in range(layers):
            d_l, i_l = accs[2 * l], accs[2 * l + 1]
            swap = ok & ((cur_d < d_l) | ((cur_d == d_l) & (cur_i < i_l)))
            out += [jnp.where(swap, cur_d, d_l), jnp.where(swap, cur_i, i_l)]
            if l + 1 < layers:
                cur_d = jnp.where(swap, d_l, cur_d)
                cur_i = jnp.where(swap, i_l, cur_i)
        return tuple(out)

    def hits_tile(row, t):
        # strict on both sides; invalid/padded triangles carry an empty
        # +-2^30 box and never hit
        return ((bbox_ref[row, t] < x1) & (bbox_ref[row + 2, t] > x0)
                & (bbox_ref[row + 1, t] < y1) & (bbox_ref[row + 3, t] > y0))

    def triangle(t, accs):
        return jax.lax.cond(hits_tile(0, t), rasterize,
                            lambda _t, a: a, t, accs)

    def per_group(k0, accs):
        def body(k, a):
            return triangle(k0 + k, a)

        return jax.lax.cond(
            hits_tile(4, k0),
            lambda a: jax.lax.fori_loop(0, group, body, a),
            lambda a: a, accs)

    def visit(i, accs):
        base = hits_ref[bin_idx, i] * chunk
        return jax.lax.fori_loop(
            0, chunk // group, lambda g, a: per_group(base + g * group, a),
            accs)

    accs = []
    for _ in range(layers):
        accs += [jnp.ones(shape, jnp.float32),
                 jnp.full(shape, int(BACKGROUND), jnp.int32)]
    accs = jax.lax.fori_loop(0, counts_ref[bin_idx], visit, tuple(accs))
    for l in range(layers):
        out_refs[2 * l][...] = accs[2 * l + 1]
        out_refs[2 * l + 1][...] = accs[2 * l]


def _pow2(n: int) -> bool:
    return n > 0 and n & (n - 1) == 0


def rasterize_pallas(
    setup,
    height: int,
    width: int,
    *,
    tile_shape: tuple[int, int] = TILE_SHAPE,
    msaa_samples: int = 1,
    chunk: int = 64,
    group: int = 8,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
    sort: str = "morton",
    y_offset=0,
    id_base=0,
    layers: int = 1,
    assemble: bool = True,
    perm=None,
):
    """Rasterize via the Pallas streaming kernel.

    Returns (tri_id, depth) of shape (S, H, W) — same contract as
    rasterize_dense / rasterize_tiled — or (layers, S, H, W) each when
    layers > 1 (depth peeling: the lexicographically nearest fragments per
    sample, nearest first). height/width must be tile multiples.
    sort="morton" streams triangles in screen-space Morton order;
    sort="none" keeps draw order; ``perm`` passes a precomputed stream
    permutation (stream_perm). Results are identical in all modes.

    assemble=False returns the raw per-tile blocks ([L,] num_tiles, S*th,
    tw) (row = y*S + s) that the tile-layout shade consumes.

    For multi-chip sharding (vktf.parallel): y_offset (traced scalar ok)
    places this call's framebuffer band at a pixel-row offset in screen
    space, and id_base offsets the emitted triangle ids so gp-sharded
    triangle blocks keep globally-unique, draw-order-monotonic ids.
    """
    th, tw = tile_shape
    assert height % th == 0 and width % tw == 0
    if not (_pow2(th) and _pow2(tw)):
        raise ValueError(f"tile_shape must be powers of two, got {tile_shape}")
    if not (_pow2(chunk) and _pow2(group) and group <= chunk):
        raise ValueError(
            f"chunk and group must be powers of two with group <= chunk, "
            f"got chunk={chunk} group={group}")
    if not 1 <= layers <= 8:
        raise ValueError(f"layers must be in 1..8, got {layers}")
    if sort not in ("morton", "none"):
        raise ValueError(f"unknown sort mode {sort!r}")
    # triangle ids ride an f32 stream row; beyond 2^24 they stop being exact
    if setup["valid"].shape[0] >= 1 << 24:
        raise ValueError("rasterize_pallas supports < 2^24 triangles")
    tiles_y, tiles_x = height // th, width // tw
    num_tiles = tiles_y * tiles_x
    offsets = tuple(tuple(o) for o in SAMPLE_OFFSETS[msaa_samples])
    S = len(offsets)
    rows = S * th

    num_tris = setup["valid"].shape[0]
    if "tri_data" in setup:  # packed setup: id_base baked at pack time
        if not (isinstance(id_base, int) and id_base == 0):
            raise ValueError("packed setup bakes id_base at pack time")
        tri_data = setup["tri_data"]
    else:
        tri_data = pack_tri_data(setup, None, id_base=id_base)
    bbox_rows = _bbox_rows(setup)
    tri_data = _pad_cols(tri_data, chunk)
    t_pad = tri_data.shape[1]
    if t_pad > num_tris:  # stream padding is invalid (id row < 0)
        tri_data = tri_data.at[15, num_tris:].set(-1.0)
    bbox_rows = jnp.concatenate([
        _pad_cols(bbox_rows[:2], chunk, 2**30),
        _pad_cols(bbox_rows[2:], chunk, -(2**30)),
    ])  # (4, t_pad)

    if perm is None and sort == "morton":
        perm = stream_perm(setup, chunk=chunk)
    if perm is not None:
        tri_data = tri_data[:, perm]
        bbox_rows = bbox_rows[:, perm]

    def group_rows(rows4, size):  # (4, Tp) -> per-size-run bbox
        g = rows4.reshape(4, -1, size)
        return jnp.concatenate([g[:2].min(axis=2), g[2:].max(axis=2)])

    # rows 4..7: the bbox of each group of `group` triangles, repeated
    tri_bbox = jnp.concatenate(
        [bbox_rows, jnp.repeat(group_rows(bbox_rows, group), group, axis=1)])
    chunk_bbox = group_rows(bbox_rows, chunk)  # (4, n_chunks)
    n_chunks = t_pad // chunk

    # Per-bin hit-chunk lists (chunk-level binning in XLA: the
    # (bins x chunks) overlap matrix is small next to the triangle stream)
    bin_h, bin_w = max(BIN_SHAPE[0], th), max(BIN_SHAPE[1], tw)
    bin_tiles = (bin_h // th, bin_w // tw)
    bins_y = -(-tiles_y // bin_tiles[0])
    bins_x = -(-tiles_x // bin_tiles[1])
    y_off = jnp.asarray(y_offset, jnp.int32)
    bin_ids = jnp.arange(bins_y * bins_x, dtype=jnp.int32)
    b_x0 = ((bin_ids % bins_x) * bin_w).astype(jnp.float32)[:, None]
    b_y0 = ((bin_ids // bins_x) * bin_h + y_off).astype(jnp.float32)[:, None]
    overlap = (
        (chunk_bbox[0][None, :] < b_x0 + bin_w)
        & (chunk_bbox[2][None, :] > b_x0)
        & (chunk_bbox[1][None, :] < b_y0 + bin_h)
        & (chunk_bbox[3][None, :] > b_y0)
    )  # (num_bins, n_chunks)
    hit_list = jnp.argsort(~overlap, axis=1, stable=True).astype(jnp.int32)
    hit_counts = jnp.sum(overlap, axis=1).astype(jnp.int32)

    kernel = functools.partial(
        _raster_kernel,
        tiles_x=tiles_x,
        bin_tiles=bin_tiles,
        bins_x=bins_x,
        tile_h=th,
        tile_w=tw,
        chunk=chunk,
        group=group,
        sample_offsets=offsets,
        layers=layers,
    )
    whole = [pl.BlockSpec()] * 5  # small inputs and the stream: whole refs
    out_block = pl.BlockSpec((None, rows, tw), lambda i: (i, 0, 0))
    outs = pl.pallas_call(
        kernel,
        grid=(num_tiles,),
        in_specs=whole,
        out_specs=[out_block] * (2 * layers),
        out_shape=[
            jax.ShapeDtypeStruct((num_tiles, rows, tw),
                                 jnp.int32 if i % 2 == 0 else jnp.float32)
            for i in range(2 * layers)
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="vktf_raster",
    )(hit_counts, hit_list, y_off.reshape(1), tri_data, tri_bbox)

    if not assemble:
        if layers == 1:
            return outs[0], outs[1]
        return (jnp.stack(outs[0::2]), jnp.stack(outs[1::2]))

    def assemble_fn(tiles):  # (num_tiles, th*S, tw) -> (S, H, W)
        return (
            tiles.reshape(tiles_y, tiles_x, th, S, tw)
            .transpose(3, 0, 2, 1, 4)
            .reshape(S, height, width)
        )

    if layers == 1:
        return assemble_fn(outs[0]), assemble_fn(outs[1])
    return (jnp.stack([assemble_fn(o) for o in outs[0::2]]),
            jnp.stack([assemble_fn(o) for o in outs[1::2]]))
