"""Vertex-stage ops: node transform propagation, world/clip transforms, and
homogeneous triangle setup.

Replaces the reference's per-frame CPU scene-graph recursion
(Model::Update, src/engine/model.cppm:163-194) and the GLSL vertex shader
(src/game/shaders/vertex.glsl) with dense batched einsums over SoA arrays.

Triangle setup implements 2D-homogeneous rasterization (Olano-Greer): edge
functions are built directly from clip-space (x', y', w) without near-plane
geometry clipping — pixels where interpolated w <= 0 or depth is outside
[0, 1] are rejected per-pixel instead. This keeps the geometry pipeline fully
dense and branch-free.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp

# Geometry products in full f32: a GPU may otherwise run f32 matrix products
# in TF32 (about three decimal digits), which would move vertices.
_EXACT = jax.lax.Precision.HIGHEST


def propagate_transforms(node_local, node_parent, level_slices: Sequence[Tuple[int, int]]):
    """Compose local transforms into global transforms level by level.

    node_local: (N,4,4) local matrices, nodes sorted topologically by depth so
    each hierarchy level is a contiguous slice; node_parent: (N,) parent index
    (into the same sorted order; roots point at themselves with identity
    composition handled by level 0). level_slices is static: one (start, end)
    per level, roots first.

    This is the jitted analogue of the reference's recursive
    global = parent_global @ local traversal (model.cppm:163-194), flattened
    into ~depth batched (n_l,4,4) matmuls.
    """
    node_global = node_local
    for start, end in level_slices[1:]:  # level 0 = roots: global == local
        parents = node_parent[start:end]
        composed = jnp.einsum(
            "nij,njk->nik", node_global[parents], node_local[start:end],
            precision=_EXACT,
        )
        node_global = jnp.concatenate(
            [node_global[:start], composed, node_global[end:]], axis=0
        )
    return node_global


def vertex_world_transform(positions, normals, tangents, vertex_matrix):
    """Transform vertices to world space with per-vertex model matrices.

    vertex_matrix: (V,4,4) — the node global transform gathered per vertex.
    Normal/tangent use the rotation block directly, matching the reference
    vertex shader's mat3(model) (vertex.glsl:26-31, orthogonal assumption).
    """
    rot = vertex_matrix[:, :3, :3]
    world_pos = (
        jnp.einsum("vij,vj->vi", rot, positions, precision=_EXACT)
        + vertex_matrix[:, :3, 3]
    )
    world_normal = jnp.einsum("vij,vj->vi", rot, normals, precision=_EXACT)
    world_tangent_xyz = jnp.einsum("vij,vj->vi", rot, tangents[:, :3],
                                   precision=_EXACT)
    world_tangent = jnp.concatenate([world_tangent_xyz, tangents[:, 3:4]], axis=-1)
    return world_pos, world_normal, world_tangent


def clip_transform(world_pos, view_projection):
    """world -> clip: (V,4) = VP @ (world, 1) (vertex.glsl:34)."""
    return (
        jnp.einsum("ij,vj->vi", view_projection[:, :3], world_pos,
                   precision=_EXACT)
        + view_projection[:, 3][None, :]
    )


def triangle_setup_cm(tri_corner, mrows, view_projection, width: int,
                      height: int, flat_out: bool = False):
    """triangle_setup from flatten-time per-triangle corner tables.

    Component-major variant for the pallas path: instead of the per-VERTEX
    route (a (V,16) matrix gather + (V,3,3) einsums + a (T,3,4) corner
    gather), it consumes scene.tri_corner's pre-gathered
    object-space corners ((36,T), rows 6..14 = position channels) and the
    (T,16) per-triangle instance-matrix rows (shared with the shade-table
    build), and keeps every intermediate a flat (T,) vector.

    Same outputs/conventions as triangle_setup (same expression structure,
    so results agree to FMA-contraction ULPs).
    """
    m = [[mrows[:, r * 4 + c] for c in range(4)] for r in range(4)]
    vp = view_projection  # (4,4), traced scalars via indexing

    # world corners per channel c, corner i (rotate+translate; tri_corner
    # layout matches build_shade_table's world_corner(6, translate=True))
    wc = [
        [
            m[c][0] * tri_corner[6 + 0 + i]
            + m[c][1] * tri_corner[6 + 3 + i]
            + m[c][2] * tri_corner[6 + 6 + i]
            + m[c][3]
            for i in range(3)
        ]
        for c in range(3)
    ]
    # clip = VP @ (world, 1) per corner (clip_transform, vertex.glsl:34)
    def clip_row(k, i):
        return (
            vp[k, 0] * wc[0][i] + vp[k, 1] * wc[1][i] + vp[k, 2] * wc[2][i]
            + vp[k, 3]
        )

    x = [clip_row(0, i) for i in range(3)]
    y = [clip_row(1, i) for i in range(3)]
    z = [clip_row(2, i) for i in range(3)]
    w = [clip_row(3, i) for i in range(3)]
    return _setup_from_corners(x, y, z, w, width, height, flat_out=flat_out)


def triangle_setup(clip, indices, width: int, height: int):
    """Per-triangle homogeneous raster setup, ANCHORED at the bbox corner.

    clip: (V,4) clip coords; indices: (T,3) int32.

    Every per-triangle linear function f(s) = a*sx + b*sy + c is stored as
    (a, b, f(anchor)) with anchor = the triangle's clipped bbox corner, and
    MUST be evaluated as f(s) = a*(sx - ax) + b*(sy - ay) + f_anchor.
    Raw cofactor constants reach ~1e8 at 1080p while the evaluated values
    are O(1): absolute-coordinate evaluation loses ~8 digits to f32
    cancellation, which produced per-pixel coverage/depth/attribute noise
    ("torn-paper" speckles) on small or distant triangles. The anchored
    constants are computed cancellation-free through vertex 0, where each
    function's value is known in closed form (e_i(s_0) = det/w_0 * [i==0],
    depth(s_0) = z_ndc_0, w_recip(s_0) = det/w_0), plus a gradient step of
    at most the bbox extent.

    Returns a dict of per-triangle arrays:
      edge:   (T,3,3); edge[t,i] = (a, b, e_i(anchor)).
      zw:     (T,2,3); zw[t,0] = depth plane (a, b, depth(anchor)) — FINAL
              values (inv_det folded in); zw[t,1] = w_recip plane
              (a, b, w_recip(anchor)), positive inside w > 0.
      anchor: (T,2) f32 anchor (ax, ay) = bbox corner.
      inv_det:(T,) reciprocal of the homogeneous determinant.
      valid:  (T,) front-facing & non-degenerate mask (back-face culling —
              the analogue of cullMode=back/CCW, graphics_pipeline.cppm:212-216).
      bbox:   (T,4) conservative pixel bbox (x0, y0, x1, y1) inclusive-exclusive,
              full-screen for triangles touching w<=0.
    """
    tri = clip[indices]  # (T,3,4)
    x, y, z, w = tri[..., 0], tri[..., 1], tri[..., 2], tri[..., 3]
    return _setup_from_corners(
        [x[:, i] for i in range(3)],
        [y[:, i] for i in range(3)],
        [z[:, i] for i in range(3)],
        [w[:, i] for i in range(3)],
        width,
        height,
    )


def _setup_from_corners(x, y, z, w, width: int, height: int,
                        flat_out: bool = False):
    """Shared triangle-setup core on per-corner component vectors.

    x/y/z/w: lists of 3 flat (T,) clip components (corner 0..2). Every
    intermediate stays a flat (T,) vector; only the returned dict stacks
    into the documented shapes.
    """
    # Homogeneous pixel-space coords: x'/w = (x/w+1)/2*W  =>  x' linear in clip.
    xs = [(x[i] + w[i]) * (0.5 * width) for i in range(3)]
    ys = [(y[i] + w[i]) * (0.5 * height) for i in range(3)]

    def cross(i, j):  # cross of rows r_i x r_j, r = (xs, ys, w)
        return (
            ys[i] * w[j] - w[i] * ys[j],
            w[i] * xs[j] - xs[i] * w[j],
            xs[i] * ys[j] - ys[i] * xs[j],
        )

    # Sign convention: with the Vulkan y-flip projection and y-down pixel
    # coords, CCW-wound front faces produce a negative homogeneous
    # determinant; negate cofactors+det so front faces have det > 0 and
    # interior pixels satisfy e_i >= 0.
    cof0 = cross(2, 1)  # e_0 coefficients (opposite vertex 0)
    cof1 = cross(0, 2)
    cof2 = cross(1, 0)
    det = xs[0] * cof0[0] + ys[0] * cof0[1] + w[0] * cof0[2]

    # Front faces have det > 0 in this convention (validated by golden tests
    # against CCW winding + the Vulkan y-flip projection). Triangles with all
    # vertices behind the eye plane (w <= 0) can never pass the per-pixel
    # w > 0 test, so they are rejected here — crucial for the streaming
    # rasterizer, where their conservative full-screen bboxes would otherwise
    # poison every chunk they sit in.
    behind = [w[i] <= 1e-12 for i in range(3)]
    all_behind = behind[0] & behind[1] & behind[2]
    any_behind = behind[0] | behind[1] | behind[2]
    valid = (det > 1e-12) & ~all_behind
    inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)

    # Conservative screen bbox (pixel units).
    safe_w = [jnp.maximum(w[i], 1e-12) for i in range(3)]
    px = [xs[i] / safe_w[i] for i in range(3)]
    py = [ys[i] / safe_w[i] for i in range(3)]
    pxmin = jnp.minimum(jnp.minimum(px[0], px[1]), px[2])
    pymin = jnp.minimum(jnp.minimum(py[0], py[1]), py[2])
    pxmax = jnp.maximum(jnp.maximum(px[0], px[1]), px[2])
    pymax = jnp.maximum(jnp.maximum(py[0], py[1]), py[2])

    # Signed doubled screen area of the projected triangle (cross2
    # convention: positive = CCW in math axes). The code's det satisfies
    # det = -(w0*w1*w2) * area2, so front faces (det > 0, all w > 0) have
    # area2 < 0. Triangles taking the SCREEN-SPACE coverage route (below)
    # whose projected area rounds to >= 0 in f32 are culled outright:
    # their screen extent is below f32 edge-function resolution (Vulkan
    # emits no fragments for zero-area primitives), and they are exactly
    # the near-collinear slivers whose perturbed edge lines produce
    # needle-shaped false coverage.
    #
    # The screen-space route itself is gated on SANE projected magnitudes:
    # a vertex with tiny POSITIVE w (just in front of the eye plane, not
    # caught by the behind <= 1e-12 test) projects to |p| ~ 1e6+ px, where
    # area2's cancellation noise (~|p|^2 * 2^-24) dwarfs real areas and
    # the anchored screen-edge constants lose whole pixels of line
    # placement. Those triangles keep the projectively-exact cofactor
    # coverage (their huge projections make them big on screen — cofactor
    # conditioning is fine there; the needle pathology is specific to
    # SMALL near-collinear slivers). At the 32768-px bound, anchored-edge
    # placement error is ~0.002 px and area2 noise ~64 px^2 — which could
    # only flip the cull sign for triangles this large yet that thin, i.e.
    # needle-degenerate ones we would cull anyway.
    sane_lim = jnp.float32(32768.0)
    sane = (
        (jnp.abs(px[0]) <= sane_lim) & (jnp.abs(py[0]) <= sane_lim)
        & (jnp.abs(px[1]) <= sane_lim) & (jnp.abs(py[1]) <= sane_lim)
        & (jnp.abs(px[2]) <= sane_lim) & (jnp.abs(py[2]) <= sane_lim)
    )
    use_screen = ~any_behind & sane
    area2 = (px[1] - px[0]) * (py[2] - py[0]) - (py[1] - py[0]) * (
        px[2] - px[0]
    )
    valid = valid & (~use_screen | (area2 < 0.0))

    # Near-plane crossers (some w <= 0) project unboundedly, but the region
    # that can PASS the kernel's per-sample tests is only
    # {0 <= depth <= 1} = the triangle clipped by z >= 0 and z <= w — a
    # convex region whose projected extremes are (a) vertices satisfying
    # both, (b) edge intersections with z = 0 that satisfy z <= w, and
    # (c) edge intersections with z = w that satisfy z >= 0. (The z=0 and
    # w=0 lines cannot meet inside a triangle of w_obj=1 geometry: z - A·w
    # is the constant P[2,3] != 0 there.) A full-screen bbox would make
    # every crosser's chunk visit every tile; the clipped bbox is exact
    # culling-wise and costs a few (T,) ops.
    inf = jnp.float32(3e38)
    # Accepted candidates clamp to a generous screen-bounded range BEFORE the
    # min/max reductions: the bbox is clipped to [0, width/height] anyway, so
    # clamping loses nothing — while an unclamped candidate whose projected
    # coordinate overflows toward +-inf/3e38 would collide with the
    # 'rejected' sentinel and silently drop out of the max reduction
    # and undersize a near-crosser bbox.
    lim_x = jnp.float32(2.0 * width + 16.0)
    lim_y = jnp.float32(2.0 * height + 16.0)

    def cand(v, lim, ok):
        return jnp.where(ok, jnp.clip(v, -lim, lim), inf)

    cand_x = []
    cand_y = []
    for i in range(3):
        ok = (z[i] >= 0.0) & (z[i] <= w[i])
        cand_x.append(cand(px[i], lim_x, ok))
        cand_y.append(cand(py[i], lim_y, ok))
    for i, j in ((0, 1), (1, 2), (2, 0)):
        for plane in ("near", "far"):
            if plane == "near":
                fi, fj = z[i], z[j]
            else:
                fi, fj = w[i] - z[i], w[j] - z[j]
            crossing = (fi > 0.0) != (fj > 0.0)
            denom = fi - fj
            t = fi / jnp.where(jnp.abs(denom) < 1e-30, 1e-30, denom)
            xt = xs[i] + t * (xs[j] - xs[i])
            yt = ys[i] + t * (ys[j] - ys[i])
            zt = z[i] + t * (z[j] - z[i])
            wt = w[i] + t * (w[j] - w[i])
            other = (zt <= wt) if plane == "near" else (zt >= 0.0)
            ok = crossing & other & (wt > 1e-12)
            wt = jnp.maximum(wt, 1e-12)
            cand_x.append(cand(xt / wt, lim_x, ok))
            cand_y.append(cand(yt / wt, lim_y, ok))

    def vmin(vs):
        acc = vs[0]
        for v in vs[1:]:
            acc = jnp.minimum(acc, v)
        return acc

    cxmin = vmin(cand_x)
    cymin = vmin(cand_y)
    cxmax = vmin([jnp.where(v >= inf, inf, -v) for v in cand_x])
    cymax = vmin([jnp.where(v >= inf, inf, -v) for v in cand_y])
    has_cand = cxmin < inf
    # inflate 1px against f32 rounding of the intersection points; empty
    # pass regions (all candidates rejected) collapse to an empty bbox
    cx0 = jnp.where(has_cand, jnp.floor(cxmin) - 1.0, 0.0)
    cy0 = jnp.where(has_cand, jnp.floor(cymin) - 1.0, 0.0)
    cx1 = jnp.where(has_cand, jnp.ceil(-cxmax) + 2.0, 0.0)
    cy1 = jnp.where(has_cand, jnp.ceil(-cymax) + 2.0, 0.0)

    x0 = jnp.where(any_behind, cx0, jnp.floor(pxmin))
    y0 = jnp.where(any_behind, cy0, jnp.floor(pymin))
    x1 = jnp.where(any_behind, cx1, jnp.ceil(pxmax) + 1.0)
    y1 = jnp.where(any_behind, cy1, jnp.ceil(pymax) + 1.0)
    zeros_i = jnp.zeros_like(det, dtype=jnp.int32)
    bbox_cols = [
        jnp.clip(x0, 0, width),
        jnp.clip(y0, 0, height),
        jnp.clip(x1, 0, width),
        jnp.clip(y1, 0, height),
    ]
    # Degenerate/back-facing triangles get empty bboxes so binning drops them.
    bbox_cols = [
        jnp.where(valid, c.astype(jnp.int32), zeros_i) for c in bbox_cols
    ]

    # ---- anchored plane constants ------------------------------------------
    ax = bbox_cols[0].astype(jnp.float32)
    ay = bbox_cols[1].astype(jnp.float32)
    # vertex-0 screen position + the function values there (w_0 > 0 for all
    # valid triangles that aren't near-plane crossers)
    det_w0 = det / safe_w[0]  # e_0(s_0) = w_recip(s_0)
    dx0 = ax - px[0]  # <= bbox extent for non-crossing triangles
    dy0 = ay - py[0]

    def anchored(a, b, c_raw, value_at_v0):
        """(a, b, f(anchor)): via vertex 0 normally; via the raw constant
        stepped to the clipped-bbox corner for near-plane crossers (their
        vertex 0 may be behind the eye; the raw-constant route has the
        absolute-coordinate cancellation the docstring describes, but
        crossers are huge triangles whose edge magnitudes dwarf it — and it
        is exactly what their old (0,0)-anchored evaluation paid per
        sample). Returns the FLAT (a, b, f_anchor) component tuple; the
        legacy dict stacks at the very end (flat_out docstring)."""
        f_anchor = jnp.where(
            any_behind,
            c_raw + a * ax + b * ay,
            value_at_v0 + a * dx0 + b * dy0,
        )
        return a, b, f_anchor

    zero = jnp.zeros_like(det)
    edges = (
        anchored(cof0[0], cof0[1], cof0[2], det_w0),
        anchored(cof1[0], cof1[1], cof1[2], zero),
        anchored(cof2[0], cof2[1], cof2[2], zero),
    )  # 3 x (a, b, c) flat (T,) components

    # ---- raster COVERAGE planes (screen-space) ---------------------------
    # The cofactor planes above are projectively exact but ill-conditioned
    # for near-collinear slivers: ~1e-7 relative noise in the cofactors
    # displaces their three nearly-parallel edge lines by whole pixels, and
    # the "all edges positive" region becomes a needle extending far
    # outside the triangle (a 5x2 px Sponza sliver won samples 17 px
    # outside its bbox — the oracle,
    # which rasterizes from projected-vertex differences clamped to the
    # bbox, has no such needle). Coverage therefore uses SCREEN-SPACE edge
    # functions built from differences of projected vertices: each line
    # passes within ~ulp(screen coord) of its true vertices, shrinking the
    # needle below sample granularity. Only the raster inside-test consumes
    # these (pack_tri_data); interpolation keeps the cofactor planes (they
    # carry the perspective weights). Near-plane crossers and
    # insane-projection triangles (tiny positive w; use_screen above) keep
    # cofactor coverage — their vertices do not (usefully) project.
    # Inside-positive orientation: e_i(opposite vertex) = -area2 > 0 for
    # front faces.
    def screen_edge(j, k):
        # edge through projected vertices (P_j, P_k), REVERSED orientation
        # (front faces have area2 < 0): e(P) = cross2(P_k, P_j, P)
        a = py[k] - py[j]
        b = px[j] - px[k]
        f_anchor = a * (ax - px[k]) + b * (ay - py[k])
        return a, b, f_anchor

    sedges = [screen_edge(1, 2), screen_edge(2, 0), screen_edge(0, 1)]
    edges_raster = tuple(
        tuple(jnp.where(use_screen, s, c) for s, c in zip(se, ce))
        for se, ce in zip(sedges, edges)
    )  # component-wise select == the old stacked select, bit for bit

    # depth plane (inv_det folded): depth(s_0) = z_ndc_0 exactly
    z_ndc0 = z[0] / safe_w[0]
    za = (cof0[0] * z[0] + cof1[0] * z[1] + cof2[0] * z[2]) * inv_det
    zb = (cof0[1] * z[0] + cof1[1] * z[1] + cof2[1] * z[2]) * inv_det
    zc = (cof0[2] * z[0] + cof1[2] * z[1] + cof2[2] * z[2]) * inv_det
    zplane = anchored(za, zb, zc, z_ndc0)
    # w_recip plane: w_recip(s_0) = det/w_0
    wa = cof0[0] + cof1[0] + cof2[0]
    wb = cof0[1] + cof1[1] + cof2[1]
    wc = cof0[2] + cof1[2] + cof2[2]
    wplane = anchored(wa, wb, wc, det_w0)

    if flat_out:
        # FLAT component-major form: every field stays a (T,) vector and
        # consumers stack straight into dense (C, T) stream rows
        # (raster_pallas.pack_tri_rows). Values are bit-identical to the
        # stacked form: the expressions above are shared, and stacking is
        # exact.
        return {
            "edges": edges,                # 3 x (a, b, c) cofactor planes
            "edges_raster": edges_raster,  # 3 x (a, b, c) coverage planes
            "zplane": zplane,              # (a, b, c)
            "wplane": wplane,              # (a, b, c)
            "anchor_x": ax,
            "anchor_y": ay,
            "inv_det": inv_det,
            "valid": valid,
            "bbox_cols": tuple(bbox_cols),  # 4 x (T,) i32
        }

    edge = jnp.stack(
        [jnp.stack(e, axis=-1) for e in edges], axis=1
    )  # (T,3,3)
    edge_raster = jnp.stack(
        [jnp.stack(e, axis=-1) for e in edges_raster], axis=1
    )  # (T,3,3)
    zw = jnp.stack(
        [jnp.stack(zplane, axis=-1), jnp.stack(wplane, axis=-1)], axis=1
    )
    anchor = jnp.stack([ax, ay], axis=-1)  # (T,2)
    bbox = jnp.stack(bbox_cols, axis=-1)
    return {
        "edge": edge,
        "edge_raster": edge_raster,
        "zw": zw,
        "anchor": anchor,
        "inv_det": inv_det,
        "valid": valid,
        "bbox": bbox,
    }
