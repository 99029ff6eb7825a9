"""The Pallas raster kernel (interpret mode) vs the XLA rasterizers.

The kernel must reproduce the tiled and dense paths bit-for-bit on triangle
ids and depths (all implement lexicographic (depth, draw-order)), at every
MSAA count, for depth-peel layers, and for the sharded band/id offsets.
"""

import numpy as np
import jax
import pytest

from vktf.config import RenderConfig
from vktf.mathx import Camera, ViewFrustumParams
from vktf.models.gltf_writer import GltfWriter
from vktf.models.primitives import box_mesh, plane_mesh, uv_sphere_mesh
from vktf.ops.pipeline import prepare_frame
from vktf.ops.raster_pallas import rasterize_pallas
from vktf.ops.raster_tiled import rasterize_tiled

from helpers import build_scene


@pytest.fixture(scope="module")
def scene_setup(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("pallas")
    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.5, 0.5, 0.5, 1.0))
    nodes = [
        w.add_node(mesh=w.add_mesh(box_mesh(), material=mat),
                   translation=(-0.5, 0.0, 0.0), rotation=(0, 0.2588, 0, 0.9659)),
        w.add_node(mesh=w.add_mesh(uv_sphere_mesh(0.45, rings=10, sectors=20), material=mat),
                   translation=(0.4, 0.1, 0.4)),
        w.add_node(mesh=w.add_mesh(plane_mesh(size=6.0), material=mat),
                   translation=(0.0, -0.5, 0.0)),
        w.add_node(light=w.add_light(type="directional")),
    ]
    w.add_scene(nodes)
    scene, meta, aux = build_scene(w.write(tmp_path / "s.gltf"))
    config = RenderConfig(width=256, height=128, msaa_samples=2, tile_shape=(32, 128))
    camera = Camera((0.0, 0.6, 2.4), (0.0, -0.2, -1.0),
                    ViewFrustumParams(np.radians(45.0), 2.0, 0.1, 100.0))
    setup, _bins, _lights, _world, _inst = jax.jit(
        lambda s, v, c: prepare_frame(s, v, c, meta=meta, config=config)
    )(scene, camera.view_projection_transform, camera.position)
    return setup, config


def test_pallas_matches_tiled(scene_setup):
    setup, config = scene_setup
    ph, pw = config.padded_height, config.padded_width
    ids_t, d_t = jax.jit(
        lambda s: rasterize_tiled(
            s, ph, pw, tile_shape=config.tile_shape,
            bin_capacity=config.bin_capacity, msaa_samples=2, chunk=32,
        )
    )(setup)
    ids_p, d_p = jax.jit(
        lambda s: rasterize_pallas(
            s, ph, pw, tile_shape=config.tile_shape, msaa_samples=2,
            chunk=128, interpret=True,
        )
    )(setup)
    ids_t, ids_p = np.asarray(ids_t), np.asarray(ids_p)
    assert (ids_t >= 0).sum() > 1000  # real coverage
    np.testing.assert_array_equal(ids_t, ids_p)
    np.testing.assert_allclose(np.asarray(d_t), np.asarray(d_p), atol=1e-5)


@pytest.mark.parametrize("layers", [1, 3])
@pytest.mark.parametrize("msaa", [1, 2, 4, 8])
def test_pallas_matches_dense(scene_setup, msaa, layers):
    """Every MSAA count, single layer and 3-layer depth peel, against the
    every-triangle dense reference (rasterize_dense layers=K), with a chunk
    and group smaller than the stream so several hit chunks and group
    skips are exercised."""
    from vktf.ops.raster_xla import rasterize_dense

    setup, config = scene_setup
    ph, pw = config.padded_height, config.padded_width
    ids_d, d_d = jax.jit(lambda s: rasterize_dense(
        s, ph, pw, msaa_samples=msaa, layers=layers))(setup)
    ids_p, d_p = jax.jit(lambda s: rasterize_pallas(
        s, ph, pw, tile_shape=(16, 32), msaa_samples=msaa, chunk=64,
        group=4, interpret=True, layers=layers))(setup)
    ids_d, ids_p = np.asarray(ids_d), np.asarray(ids_p)
    assert ids_p.shape == ids_d.shape
    assert (ids_d >= 0).sum() > 1000 * msaa
    if layers > 1:
        assert (ids_d[1] >= 0).any(), "second peel layer never covered"
    np.testing.assert_array_equal(ids_d, ids_p)
    np.testing.assert_array_equal(np.asarray(d_d), np.asarray(d_p))


def test_pallas_band_offset_and_id_base(scene_setup):
    """The sharded path's hooks: rasterizing the lower half of the frame as
    a band (y_offset) with offset ids (id_base) equals the matching rows of
    the full-frame raster with its ids offset by the same base."""
    setup, config = scene_setup
    ph, pw = config.padded_height, config.padded_width
    full_ids, full_d = jax.jit(lambda s: rasterize_pallas(
        s, ph, pw, tile_shape=(16, 32), msaa_samples=2, chunk=64,
        interpret=True))(setup)
    base = 1000
    band_ids, band_d = jax.jit(lambda s: rasterize_pallas(
        s, ph // 2, pw, tile_shape=(16, 32), msaa_samples=2, chunk=64,
        interpret=True, y_offset=ph // 2, id_base=base))(setup)
    full_ids, band_ids = np.asarray(full_ids), np.asarray(band_ids)
    lower = full_ids[:, ph // 2:]
    assert (lower >= 0).sum() > 1000
    np.testing.assert_array_equal(np.where(lower >= 0, lower + base, -1),
                                  band_ids)
    np.testing.assert_array_equal(np.asarray(full_d)[:, ph // 2:],
                                  np.asarray(band_d))


def test_pallas_raw_blocks_match_assembled(scene_setup):
    """assemble=False returns the (tiles, S*th, tw) blocks (row = y*S + s)
    that the tile-layout shade consumes; assembling them by hand gives the
    (S, H, W) planes."""
    setup, config = scene_setup
    ph, pw = config.padded_height, config.padded_width
    th, tw = 16, 32

    def run(assemble):
        return jax.jit(lambda s: rasterize_pallas(
            s, ph, pw, tile_shape=(th, tw), msaa_samples=4, chunk=128,
            interpret=True, assemble=assemble))(setup)

    ids, _ = run(True)
    blocks, _ = run(False)
    blocks = np.asarray(blocks)
    assert blocks.shape == (ph // th * (pw // tw), 4 * th, tw)
    planes = (blocks.reshape(ph // th, pw // tw, th, 4, tw)
              .transpose(3, 0, 2, 1, 4).reshape(4, ph, pw))
    np.testing.assert_array_equal(planes, np.asarray(ids))


@pytest.mark.parametrize("kwargs, match", [
    (dict(chunk=96), "powers of two"),
    (dict(group=256), "powers of two"),
    (dict(tile_shape=(24, 32)), "powers of two"),
    (dict(layers=9), "layers"),
])
def test_pallas_rejects_bad_blocks(scene_setup, kwargs, match):
    setup, _config = scene_setup
    args = dict(tile_shape=(16, 32), chunk=128)
    args.update(kwargs)
    with pytest.raises(ValueError, match=match):
        rasterize_pallas(setup, 96, 256, interpret=True, **args)


def test_setup_cm_matches_vertex_route(scene_setup, tmp_path_factory):
    """triangle_setup_cm (pallas path: corner tables + (T,16) matrix rows)
    must agree with the per-vertex triangle_setup route to FMA-contraction
    ULPs, and exactly on the integer/bool outputs."""
    import jax.numpy as jnp
    from vktf.models.gltf_writer import GltfWriter
    from vktf.models.primitives import box_mesh, uv_sphere_mesh
    from vktf.ops.pipeline import prepare_frame
    from vktf.mathx import ViewFrustumParams

    from helpers import build_scene

    tmp_path = tmp_path_factory.mktemp("cm")
    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.5, 0.5, 0.5, 1.0))
    child = w.add_node(mesh=w.add_mesh(box_mesh(0.3), material=mat),
                       translation=(0.2, 0.5, 0.0))
    w.add_scene([
        w.add_node(mesh=w.add_mesh(box_mesh(), material=mat),
                   rotation=(0, 0.2588, 0, 0.9659), children=[child]),
        w.add_node(mesh=w.add_mesh(uv_sphere_mesh(0.45, rings=9, sectors=17),
                                   material=mat), translation=(0.6, 0.1, 0.4)),
        w.add_node(light=w.add_light(type="directional")),
    ])
    scene, meta, _aux = build_scene(w.write(tmp_path / "cm.gltf"))
    config = RenderConfig(width=256, height=128, msaa_samples=1)
    camera = Camera((0.0, 0.6, 2.4), (0.0, -0.2, -1.0),
                    ViewFrustumParams(np.radians(45.0), 2.0, 0.1, 100.0))
    vp, cp = camera.view_projection_transform, camera.position

    a = jax.jit(lambda s, v, c: prepare_frame(
        s, v, c, meta=meta, config=config.replace(backend="dense"))[0]
    )(scene, vp, cp)
    b = jax.jit(lambda s, v, c: prepare_frame(
        s, v, c, meta=meta, config=config.replace(backend="pallas"))[0]
    )(scene, vp, cp)

    np.testing.assert_array_equal(np.asarray(a["valid"]), np.asarray(b["valid"]))
    # bboxes may differ by 1 pixel where a projected coordinate rounds
    # across floor/ceil under ULP input differences (conservative either way)
    assert np.abs(np.asarray(a["bbox"]) - np.asarray(b["bbox"])).max() <= 1
    for key in ("edge", "zw"):
        av, bv = np.asarray(a[key]), np.asarray(b[key])
        scale = np.abs(av).max(axis=0, keepdims=True) + 1e-6
        assert (np.abs(av - bv) <= scale * 5e-5 + 1e-4).all(), key


def test_near_crosser_clipped_bbox(tmp_path):
    """Triangles crossing the near plane must still rasterize exactly.

    Their conservative bbox is now the projection of the triangle clipped
    by 0 <= z <= w (was: full screen — 22 ms of a 64 ms raster stage at
    1080p Sponza). rasterize_dense ignores bboxes entirely, so comparing
    ids against it catches any over-tight clip.
    """
    from vktf.models.gltf_writer import GltfWriter
    from vktf.models.primitives import box_mesh, plane_mesh
    from vktf.mathx import ViewFrustumParams
    from vktf.ops.raster_xla import rasterize_dense

    from helpers import build_scene

    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.6, 0.6, 0.6, 1.0))
    w.add_scene([
        # huge floor passing under+behind the camera -> near crossers
        w.add_node(mesh=w.add_mesh(plane_mesh(size=40.0), material=mat),
                   translation=(0.0, -0.4, 0.0)),
        # wall extending behind the camera
        w.add_node(mesh=w.add_mesh(box_mesh(0.5), material=mat),
                   translation=(1.2, 0.3, 1.0), scale=(1.0, 2.0, 30.0)),
        w.add_node(mesh=w.add_mesh(box_mesh(0.4), material=mat),
                   translation=(0.0, 0.2, -2.0)),
        w.add_node(light=w.add_light(type="directional")),
    ])
    scene, meta, _aux = build_scene(w.write(tmp_path / "crossers.gltf"))
    config = RenderConfig(width=256, height=128, msaa_samples=1,
                          tile_shape=(32, 128))
    # camera INSIDE the scene looking along -z: floor + wall cross w=0
    camera = Camera((0.3, 0.4, 0.5), (-0.1, -0.25, -1.0),
                    ViewFrustumParams(np.radians(60.0), 2.0, 0.1, 50.0))
    setup = jax.jit(lambda s, v, c: prepare_frame(
        s, v, c, meta=meta, config=config.replace(backend="pallas"))[0]
    )(scene, camera.view_projection_transform, camera.position)

    bbox = np.asarray(setup["bbox"])
    area = (bbox[:, 2] - bbox[:, 0]) * (bbox[:, 3] - bbox[:, 1])
    assert (area > 0).sum() > 4  # scene is visible
    # the clip must have produced at least one PARTIAL (non-full-screen,
    # non-empty) crosser bbox, or this test exercises nothing
    full = (area == 256 * 128).sum()
    partial = ((area > 0) & (area < 256 * 128)).sum()
    assert partial > 0

    ids_d, _ = jax.jit(lambda s: rasterize_dense(
        s, 128, 256, msaa_samples=1, chunk=8))(setup)
    ids_p, _ = jax.jit(lambda s: rasterize_pallas(
        s, 128, 256, tile_shape=(32, 128), msaa_samples=1, chunk=128,
        interpret=True))(setup)
    np.testing.assert_array_equal(np.asarray(ids_d), np.asarray(ids_p))
    assert (np.asarray(ids_d) >= 0).sum() > 2000


def _sliver_setup(width, height, count, seed):
    """Near-collinear sliver triangles as triangle_setup input.

    Projected points span a few pixels, perturbed off a line by
    ~1e-5..1e-2.5 px, small clip w (Sponza-like magnitudes). Both windings
    are emitted; one of each pair survives back-face culling.
    """
    from vktf.ops.vertex import triangle_setup

    rng = np.random.default_rng(seed)
    clips, index_rows = [], []
    for _ in range(count):
        x0 = rng.uniform(width * 0.45, width * 0.95)
        y0 = rng.uniform(height * 0.45, height * 0.95)
        dx, dy = rng.uniform(-5, 5), rng.uniform(-2.5, 2.5)
        t_mid = rng.uniform(0.3, 0.7)
        off = 10.0 ** rng.uniform(-5, -2.5)
        px_ = np.array([x0, x0 + t_mid * dx - off * dy, x0 + dx])
        py_ = np.array([y0, y0 + t_mid * dy + off * dx, y0 + dy])
        w_ = rng.uniform(0.05, 0.15)
        z_ = rng.uniform(0.1, 0.9) * w_
        for wind in ((0, 1, 2), (0, 2, 1)):
            base = len(clips)
            for i in wind:
                clips.append([
                    (px_[i] / width * 2 - 1) * w_,
                    (py_[i] / height * 2 - 1) * w_,
                    z_,
                    w_,
                ])
            index_rows.append([base, base + 1, base + 2])
    clip = np.asarray(clips, np.float32)
    indices = np.asarray(index_rows, np.int32)
    setup = jax.jit(
        lambda c: triangle_setup(c, indices, width, height)
    )(clip)
    return {k: np.asarray(v) for k, v in setup.items()}


def test_tiny_positive_w_keeps_cofactor_coverage():
    """A vertex with tiny POSITIVE w (just in front of the eye plane, not
    flagged 'behind') projects to ~1e8 px, where screen-space area/edge
    math is f32 garbage. Such triangles must keep the projectively-exact
    cofactor coverage and NOT be culled by the f32 area2 test (code-review
    r2 finding: the unconditioned cull could blink large visible triangles
    out for frames where one vertex grazes the camera plane)."""
    from vktf.ops.vertex import triangle_setup
    from vktf.ops.raster_xla import rasterize_dense

    width, height = 256, 128
    # big on-screen triangle; vertex 2 almost exactly at the eye plane
    clip = np.asarray([
        [-0.5 * 0.8, -0.5 * 0.8, 0.4 * 0.8, 0.8],
        [0.5 * 0.9, -0.4 * 0.9, 0.45 * 0.9, 0.9],
        [0.3, 0.2, 0.4e-7, 1e-7],  # w = 1e-7 > behind eps; px ~ 4e8
    ], np.float32)
    indices = np.asarray([[0, 1, 2], [0, 2, 1]], np.int32)  # both windings
    setup = jax.jit(lambda c: triangle_setup(c, indices, width, height))(clip)
    valid = np.asarray(setup["valid"])
    assert valid.any(), "tiny-positive-w triangle was wrongly culled"
    # and its coverage planes must be the cofactor set (finite anchors):
    # dense and pallas agree either way — the real check is it RENDERS
    ids_d, _ = jax.jit(lambda s: rasterize_dense(
        s, height, width, msaa_samples=1, chunk=2))(setup)
    ids_p, _ = jax.jit(lambda s: rasterize_pallas(
        s, height, width, tile_shape=(32, 128), msaa_samples=1, chunk=128,
        interpret=True))(setup)
    np.testing.assert_array_equal(np.asarray(ids_d), np.asarray(ids_p))
    assert (np.asarray(ids_d) >= 0).sum() > 50, "triangle did not render"


def test_sliver_no_needle_planes_1080p():
    """Sliver coverage planes must not pass outside the triangle's bbox.

    Regression test for the cofactor-plane "needle": a 5x2 px Sponza sliver
    won samples 17 px outside its bbox (tools/sliver_probe.py) because
    ~1e-7 relative noise in the clip-space cofactors displaced its three
    nearly-parallel edge lines, whose all-positive region then extended as
    a long strip. Coverage now uses screen-space edge planes
    (setup["edge_raster"]); triangles whose projected area rounds to
    zero/backward in f32 are culled (Vulkan: zero-area emits nothing).
    Evaluates the planes exactly as the kernel does, at pixel centers in a
    48 px band around each bbox — with the OLD cofactor planes this same
    data measures 17 needle pixels (the sensitivity control lives in the
    plane choice below, not a tolerance).
    """
    width, height = 1920, 1080
    setup = _sliver_setup(width, height, count=200, seed=3)
    assert setup["valid"].sum() > 50  # survivors of the area cull

    bad = 0
    for t in np.nonzero(setup["valid"])[0]:
        e = setup["edge_raster"][t]
        zw = setup["zw"][t]
        ax, ay = setup["anchor"][t]
        b = setup["bbox"][t]
        xs = np.arange(max(b[0] - 48, 0), min(b[2] + 48, width)) + 0.5
        ys = np.arange(max(b[1] - 48, 0), min(b[3] + 48, height)) + 0.5
        gx, gy = np.meshgrid(xs, ys)
        dxx = (gx - ax).astype(np.float32)
        dyy = (gy - ay).astype(np.float32)
        ins = np.ones(gx.shape, bool)
        for i in range(3):
            a_, b_, c_ = e[i]
            ev = np.float32(a_) * dxx + np.float32(b_) * dyy + np.float32(c_)
            tl = (a_ > 0) | ((a_ == 0) & (b_ > 0))
            ins &= (ev > 0) | ((ev == 0) & tl)
        depth = (np.float32(zw[0, 0]) * dxx + np.float32(zw[0, 1]) * dyy
                 + np.float32(zw[0, 2]))
        wr = (np.float32(zw[1, 0]) * dxx + np.float32(zw[1, 1]) * dyy
              + np.float32(zw[1, 2]))
        ins &= (wr > 0) & (depth >= 0) & (depth <= 1)
        outside = (gx < b[0]) | (gx >= b[2]) | (gy < b[1]) | (gy >= b[3])
        bad += int((ins & outside).sum())
    assert bad == 0, f"{bad} needle pixels outside sliver bboxes"


def test_sliver_no_needle_coverage():
    """End-to-end: the pallas kernel never emits ids outside their bbox
    for a sliver-only scene (wiring check for edge_raster consumption)."""
    width, height = 256, 128
    setup = _sliver_setup(width, height, count=64, seed=7)
    assert setup["valid"].sum() > 0

    ids, _ = jax.jit(lambda s: rasterize_pallas(
        s, height, width, tile_shape=(32, 128), msaa_samples=1, chunk=128,
        interpret=True))(setup)
    ids = np.asarray(ids)
    bbox = setup["bbox"]
    ss, yy, xx = np.nonzero(ids >= 0)
    for s, y, x in zip(ss, yy, xx):
        b = bbox[ids[s, y, x]]
        assert b[0] <= x < b[2] and b[1] <= y < b[3], (
            f"needle: tri {ids[s, y, x]} bbox={b.tolist()} "
            f"covered sample ({x},{y})"
        )


# ---------------------------------------------------------------------------
# Hand-computed Vulkan fill-rule conformance (VERDICT r4 weak #4).
#
# Every expectation below is derived BY HAND from the spec rules — top-left
# fill rule, standard sample locations, shared-edge watertightness
# (graphics_pipeline.cppm:205-221 relies on the hardware rasterizer for
# these; our software rasterizer must pin them against literal arrays, not
# against the independent numpy oracle, whose agreement the golden suite
# already covers). Geometry uses dyadic-rational pixel coordinates with
# w == 1 so the clip -> screen round-trip is EXACT in f32: edge function
# values at the asserted samples are exact, no tolerance budget can mask a
# one-sample boundary disagreement.
# ---------------------------------------------------------------------------


def _setup_px(tris, width, height, z=0.5):
    """triangle_setup input from PIXEL-space corners (w=1, constant depth).

    tris: one [(px, py)] * 3 list per triangle, coordinates dyadic rationals
    (exact under /width, *2, -1 in f32). With w = 1 the homogeneous screen
    coords equal the pixel coords exactly.
    """
    from vktf.ops.vertex import triangle_setup

    clips, index_rows = [], []
    for corners in tris:
        base = len(clips)
        for px, py in corners:
            clips.append([px / width * 2 - 1, py / height * 2 - 1, z, 1.0])
        index_rows.append([base, base + 1, base + 2])
    clip = np.asarray(clips, np.float32)
    indices = np.asarray(index_rows, np.int32)
    return jax.jit(lambda c: triangle_setup(c, indices, width, height))(clip)


def _raster_both(setup, width, height, msaa):
    """(dense ids, pallas ids) as (S, H, W) int arrays — production kernel
    and the dense XLA form must BOTH match the hand expectation."""
    from vktf.ops.raster_xla import rasterize_dense

    ids_d, _ = jax.jit(lambda s: rasterize_dense(
        s, height, width, msaa_samples=msaa, chunk=2))(setup)
    ids_p, _ = jax.jit(lambda s: rasterize_pallas(
        s, height, width, tile_shape=(32, 128), msaa_samples=msaa,
        chunk=128, interpret=True))(setup)
    return np.asarray(ids_d), np.asarray(ids_p)


class TestFillRulesHandComputed:
    W, H = 128, 32

    def test_shared_diagonal_exactly_once_1x(self):
        """Quad [2,10)x[2,10) split by the main diagonal; 1x MSAA samples
        (k+0.5, k+0.5) lie EXACTLY on the diagonal. Hand classification:

          tri 0 = (2,2),(10,10),(10,2): diagonal edge has (a,b) = (8,-8)
            -> a > 0 -> top-left -> INCLUSIVE; right edge x=10 (a=-8)
            strict; top edge y=2 (a=0, b=8) inclusive.
          tri 1 = (2,2),(2,10),(10,10): diagonal edge has a = -8 -> strict
            (EXCLUSIVE); bottom edge y=10 (a=0, b=-8) strict; left edge
            x=2 (a=8) inclusive.

        So every diagonal sample belongs to tri 0 alone: covered exactly
        once, no double-shade, no gap — and right/bottom quad borders emit
        nothing (pixel centers at half-integers only meet the diagonal)."""
        setup = _setup_px(
            [[(2, 2), (10, 10), (10, 2)], [(2, 2), (2, 10), (10, 10)]],
            self.W, self.H,
        )
        expected = np.full((1, self.H, self.W), -1, np.int32)
        # literal per-pixel winners for rows 2..9, cols 2..9: the diagonal
        # (row == col) goes to tri 0 by the top-left rule
        expected[0, 2:10, 2:10] = np.asarray([
            [0, 0, 0, 0, 0, 0, 0, 0],
            [1, 0, 0, 0, 0, 0, 0, 0],
            [1, 1, 0, 0, 0, 0, 0, 0],
            [1, 1, 1, 0, 0, 0, 0, 0],
            [1, 1, 1, 1, 0, 0, 0, 0],
            [1, 1, 1, 1, 1, 0, 0, 0],
            [1, 1, 1, 1, 1, 1, 0, 0],
            [1, 1, 1, 1, 1, 1, 1, 0],
        ], np.int32)
        ids_d, ids_p = _raster_both(setup, self.W, self.H, msaa=1)
        np.testing.assert_array_equal(ids_d, expected)
        np.testing.assert_array_equal(ids_p, expected)

    def test_shared_diagonal_exactly_once_4x(self):
        """Same split quad at 4x MSAA: per-SAMPLE winners follow the hand
        rule id = (sy <= sx ? 0 : 1) inside [2,10)^2 — every sample covered
        exactly once across the shared edge at all 4 standard offsets."""
        from vktf.ops.raster_xla import SAMPLE_OFFSETS

        setup = _setup_px(
            [[(2, 2), (10, 10), (10, 2)], [(2, 2), (2, 10), (10, 10)]],
            self.W, self.H,
        )
        offs = np.asarray(SAMPLE_OFFSETS[4], np.float64)  # (4,2)
        gy, gx = np.mgrid[0:self.H, 0:self.W]
        sx = gx[None] + offs[:, 0][:, None, None]  # (4,H,W)
        sy = gy[None] + offs[:, 1][:, None, None]
        inside = (sx >= 2) & (sx < 10) & (sy >= 2) & (sy < 10)
        # no 4x offset has equal x/y parts, so no sample sits ON the
        # diagonal: strict comparison decides every winner
        assert not np.any(inside & (sx == sy))
        expected = np.where(inside, np.where(sy < sx, 0, 1), -1).astype(np.int32)
        ids_d, ids_p = _raster_both(setup, self.W, self.H, msaa=4)
        np.testing.assert_array_equal(ids_d, expected)
        np.testing.assert_array_equal(ids_p, expected)

    def test_top_left_rule_edges_through_samples_1x(self):
        """Rectangle [2.5,6.5)x[2.5,4.5) split by its diagonal — ALL four
        border lines pass exactly through 1x sample centers, and the
        diagonal (slope 1/2) passes exactly through sample (4.5, 3.5).

        Hand classification: top edge y=2.5 (a=0, b=4) INCLUSIVE; left
        edge x=2.5 (a=2) INCLUSIVE; right edge x=6.5 (a=-2) and bottom
        edge y=4.5 (a=0, b=-4) EXCLUSIVE; diagonal inclusive for tri 0
        (a=2), exclusive for tri 1 (a=-2) -> sample (4.5,3.5) is tri 0."""
        setup = _setup_px(
            [[(2.5, 2.5), (6.5, 4.5), (6.5, 2.5)],
             [(2.5, 2.5), (2.5, 4.5), (6.5, 4.5)]],
            self.W, self.H,
        )
        expected = np.full((1, self.H, self.W), -1, np.int32)
        # rows 2..3, cols 2..5; diagonal sample (col 4, row 3) -> tri 0
        expected[0, 2:4, 2:6] = np.asarray([
            [0, 0, 0, 0],
            [1, 1, 0, 0],
        ], np.int32)
        ids_d, ids_p = _raster_both(setup, self.W, self.H, msaa=1)
        np.testing.assert_array_equal(ids_d, expected)
        np.testing.assert_array_equal(ids_p, expected)

    def test_standard_4x_sample_x_positions(self):
        """Vertical band x in [3.375, 3.625) (full height): its borders sit
        exactly ON the standard 4x sample x-offsets 0.375 (sample 0) and
        0.625 (sample 3). Left edge inclusive covers sample 0; right edge
        strict excludes sample 3; samples 1 (0.875) and 2 (0.125) fall
        outside the band. Coverage mask must be exactly {sample 0, col 3}."""
        setup = _setup_px(
            [[(3.375, 0), (3.625, 32), (3.625, 0)],
             [(3.375, 0), (3.375, 32), (3.625, 32)]],
            self.W, self.H,
        )
        expected = np.zeros((4, self.H, self.W), bool)
        expected[0, :, 3] = True
        ids_d, ids_p = _raster_both(setup, self.W, self.H, msaa=4)
        np.testing.assert_array_equal(ids_d >= 0, expected)
        np.testing.assert_array_equal(ids_p >= 0, expected)

    def test_standard_4x_sample_y_positions(self):
        """Horizontal band y in [2.375, 2.625) (full width): borders sit
        exactly ON the standard 4x sample y-offsets 0.375 (sample 1) and
        0.625 (sample 2). Top edge inclusive covers sample 1; bottom edge
        strict excludes sample 2; samples 0 (0.125) and 3 (0.875) fall
        outside. Coverage mask must be exactly {sample 1, row 2}."""
        setup = _setup_px(
            [[(0, 2.375), (128, 2.625), (128, 2.375)],
             [(0, 2.375), (0, 2.625), (128, 2.625)]],
            self.W, self.H,
        )
        expected = np.zeros((4, self.H, self.W), bool)
        expected[1, 2, :] = True
        ids_d, ids_p = _raster_both(setup, self.W, self.H, msaa=4)
        np.testing.assert_array_equal(ids_d >= 0, expected)
        np.testing.assert_array_equal(ids_p >= 0, expected)


@pytest.mark.gpu
def test_compiled_kernel_matches_tiled(scene_setup, gpu_device):
    """On the card: the kernel compiled through Triton reproduces the XLA
    tiled rasterizer (ids exactly; depths to FMA-contraction ULPs)."""
    setup, config = scene_setup
    ph, pw = config.padded_height, config.padded_width
    ids_t, d_t = jax.jit(lambda s: rasterize_tiled(
        s, ph, pw, tile_shape=config.tile_shape,
        bin_capacity=config.bin_capacity, msaa_samples=4))(setup)
    ids_p, d_p = jax.jit(lambda s: rasterize_pallas(
        s, ph, pw, tile_shape=(16, 32), msaa_samples=4,
        interpret=False))(setup)
    np.testing.assert_array_equal(np.asarray(ids_t), np.asarray(ids_p))
    np.testing.assert_allclose(np.asarray(d_t), np.asarray(d_p), atol=1e-6)
