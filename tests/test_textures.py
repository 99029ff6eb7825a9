"""KTX2 container + image decode + mip generation tests."""

import io

import numpy as np
import pytest

from vktf.loaders.gltf import Texture
from vktf.loaders.images import (
    decode_texture,
    default_texture_data,
    generate_mips,
    linear_to_srgb,
    srgb_to_linear,
)
from vktf.loaders.ktx import (
    SUPERCOMPRESSION_ZLIB,
    SUPERCOMPRESSION_ZSTD,
    KtxError,
    load_ktx,
    parse_ktx2,
    write_ktx2,
)
from vktf.log import Log


def checker(size=8, a=(255, 0, 0, 255), b=(0, 0, 255, 255)):
    img = np.zeros((size, size, 4), np.uint8)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx // 2) + (yy // 2)) % 2 == 0
    img[mask] = a
    img[~mask] = b
    return img


class TestKtxRoundTrip:
    @pytest.mark.parametrize(
        "scheme", [0, SUPERCOMPRESSION_ZSTD, SUPERCOMPRESSION_ZLIB]
    )
    def test_roundtrip_schemes(self, tmp_path, scheme):
        levels = generate_mips(checker(8), srgb=False)
        path = write_ktx2(tmp_path / "t.ktx2", levels, srgb=True, supercompression=scheme)
        tex = load_ktx(path)
        assert tex is not None
        assert tex.srgb
        assert len(tex.levels) == 4  # 8,4,2,1
        np.testing.assert_array_equal(tex.levels[0], levels[0])
        np.testing.assert_array_equal(tex.levels[3], levels[3])

    def test_not_ktx_raises(self):
        with pytest.raises(KtxError):
            parse_ktx2(b"not a ktx file....", name="x")

    def test_malformed_basis_skipped_with_log(self, tmp_path):
        """vkFormat 0 without a recognizable Basis DFD/scheme skips with a
        logged error (proper Basis payloads transcode — tests/test_basis.py)."""
        levels = [checker(4)]
        path = write_ktx2(tmp_path / "b.ktx2", levels, srgb=False)
        blob = bytearray(path.read_bytes())
        blob[12:16] = (0).to_bytes(4, "little")  # vkFormat = UNDEFINED (Basis)
        err = io.StringIO()
        log = Log(out_stream=io.StringIO(), err_stream=err)
        assert parse_ktx2(bytes(blob), name="b.ktx2", log=log) is None
        assert "unsupported" in err.getvalue()


class TestMips:
    def test_mip_chain_shapes(self):
        levels = generate_mips(np.zeros((16, 8, 4), np.uint8), srgb=False)
        shapes = [lvl.shape[:2] for lvl in levels]
        assert shapes == [(16, 8), (8, 4), (4, 2), (2, 1), (1, 1)]

    def test_linear_box_filter_average(self):
        base = np.zeros((2, 2, 4), np.uint8)
        base[0, 0] = [100, 0, 0, 255]
        base[0, 1] = [200, 0, 0, 255]
        base[1, 0] = [100, 0, 0, 255]
        base[1, 1] = [200, 0, 0, 255]
        levels = generate_mips(base, srgb=False)
        assert levels[1][0, 0, 0] == 150

    def test_srgb_filtering_in_linear_space(self):
        base = np.zeros((2, 2, 4), np.uint8)
        base[..., 3] = 255
        base[0, 0, 0] = 255  # half the pixels full red (sRGB)
        base[1, 1, 0] = 255
        levels = generate_mips(base, srgb=True)
        # average in linear: 0.5 linear -> sRGB ~188, not 128
        assert abs(int(levels[1][0, 0, 0]) - 188) <= 2

    def test_srgb_transfer_roundtrip(self):
        x = np.linspace(0, 1, 64)
        np.testing.assert_allclose(linear_to_srgb(srgb_to_linear(x)), x, atol=1e-6)


class TestDecodeTexture:
    def test_png_decode(self, tmp_path):
        from PIL import Image

        img = checker(8)
        path = tmp_path / "c.png"
        Image.fromarray(img, "RGBA").save(path)
        tex = decode_texture(Texture(filepath=path), kind="base_color")
        assert tex is not None and tex.srgb
        np.testing.assert_array_equal(tex.levels[0], img)
        assert len(tex.levels) == 4

    def test_embedded_ktx2(self, tmp_path):
        levels = generate_mips(checker(4), srgb=False)
        path = write_ktx2(tmp_path / "e.ktx2", levels, srgb=False)
        tex = decode_texture(Texture(data=path.read_bytes()), kind="normal")
        assert tex is not None and not tex.srgb
        assert len(tex.levels) == 3

    def test_missing_file_returns_none_and_logs(self):
        err = io.StringIO()
        log = Log(out_stream=io.StringIO(), err_stream=err)
        tex = decode_texture(Texture(filepath="/nope.png"), kind="base_color", log=log)
        assert tex is None
        assert "Failed to read" in err.getvalue()

    def test_defaults(self):
        assert default_texture_data("base_color").levels[0].shape == (1, 1, 4)
        n = default_texture_data("normal").levels[0]
        np.testing.assert_array_equal(n[0, 0], [128, 128, 255, 255])


class TestAnisotropy:
    def test_aniso_lod_sharpening_matches_oracle(self, tmp_path):
        """max_anisotropy sharpens grazing-angle mips identically in the
        pallas sampler and the numpy oracle (single-tap LOD clamp)."""
        import numpy as np

        from vktf.config import RenderConfig
        from vktf.models.gltf_writer import GltfWriter
        from vktf.models.primitives import plane_mesh
        from vktf.ops.pipeline import make_frame_fn
        from vktf.ops.raster_xla import SAMPLE_OFFSETS
        from vktf.ops.reference import render_reference

        import sys
        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from helpers import (assert_images_close, build_scene,
                             checker_png_bytes, default_camera, make_reference)

        w = GltfWriter()
        img = w.add_image_bytes(checker_png_bytes(128, cell=4), "image/png")
        tex = w.add_texture(img, w.add_sampler())
        mat = w.add_material(base_color_texture=tex, metallic_factor=0.0,
                             roughness_factor=0.9)
        floor = w.add_mesh(plane_mesh(20.0), material=mat)
        sun = w.add_light("directional", color=(2.0, 2.0, 2.0))
        w.add_scene([
            # pulled forward so no triangle crosses the near plane (the
            # oracle intentionally skips near-plane crossers)
            w.add_node(mesh=floor, translation=(0.0, 0.0, -1.5)),
            # rotated so the light's +z direction has positive y (lights the
            # upward-facing floor)
            w.add_node(light=sun, rotation=(-0.3827, 0.0, 0.0, 0.9239)),
        ])
        path = w.write(tmp_path / "floor.gltf")
        scene, meta, aux = build_scene(path)
        # grazing view along the floor: anisotropic footprints
        camera = default_camera(position=(0.0, 0.2, 9.5),
                                direction=(0.0, -0.05, -1.0))
        config = RenderConfig(width=96, height=64, msaa_samples=1,
                              tile_shape=(32, 64), backend="pallas",
                              shading_rate="sample", max_anisotropy=8.0)
        fn = make_frame_fn(meta, config)
        produced = np.moveaxis(
            np.asarray(fn(scene, camera.view_projection_transform,
                          camera.position)), 0, -1)
        expected = render_reference(
            make_reference(scene, meta, aux),
            camera.view_projection_transform, camera.position, 96, 64,
            SAMPLE_OFFSETS[1], max_anisotropy=8.0,
        )
        assert_images_close(produced, expected)
        # and it actually sharpens: aniso frame differs from isotropic
        fn_iso = make_frame_fn(meta, config.replace(max_anisotropy=1.0))
        iso = np.moveaxis(
            np.asarray(fn_iso(scene, camera.view_projection_transform,
                              camera.position)), 0, -1)
        assert np.abs(produced.astype(int) - iso.astype(int)).max() > 8, (
            "anisotropic LOD clamp had no effect on the grazing floor"
        )


class TestPerSlotSamplers:
    def test_mixed_per_texture_samplers_match_oracle(self, tmp_path):
        """A material whose three textures carry DIFFERENT samplers (repeat
        base / clamp metallic-roughness / mirrored+nearest normal, with uvs
        leaving [0,1] so the wrap modes actually diverge) renders
        identically to the numpy oracle through the pallas per-slot path
        (reference binds an independent sampler per combined image-sampler,
        material.cppm:138-171)."""
        import numpy as np

        from vktf.config import RenderConfig
        from vktf.models.gltf_writer import GltfWriter
        from vktf.models.primitives import plane_mesh
        from vktf.ops.pipeline import make_frame_fn
        from vktf.ops.raster_xla import SAMPLE_OFFSETS
        from vktf.ops.reference import render_reference

        import sys
        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from helpers import (assert_images_close, build_scene,
                             checker_png_bytes, default_camera, make_reference)

        w = GltfWriter()
        base_img = w.add_image_bytes(checker_png_bytes(32, cell=8), "image/png")
        mr_img = w.add_image_bytes(
            checker_png_bytes(32, a=(40, 200, 120, 255), b=(200, 60, 60, 255),
                              cell=16), "image/png")
        nrm_img = w.add_image_bytes(checker_png_bytes(32, a=(128, 128, 255, 255),
                                                      b=(180, 100, 230, 255),
                                                      cell=16), "image/png")
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
        floor = w.add_mesh(geom, material=mat)
        sun = w.add_light("directional", color=(2.5, 2.5, 2.5))
        w.add_scene([
            w.add_node(mesh=floor, translation=(0.0, 0.0, -1.2)),
            w.add_node(light=sun, rotation=(-0.3827, 0.0, 0.0, 0.9239)),
        ])
        path = w.write(tmp_path / "mixed.gltf")
        scene, meta, aux = build_scene(path)
        assert meta.mixed_samplers, "mixed samplers must set the static flag"
        camera = default_camera(position=(0.0, 1.6, 1.8),
                                direction=(0.0, -0.7, -1.0))
        config = RenderConfig(width=96, height=64, msaa_samples=1,
                              tile_shape=(32, 64), backend="pallas",
                              shading_rate="sample")
        fn = make_frame_fn(meta, config)
        produced = np.moveaxis(
            np.asarray(fn(scene, camera.view_projection_transform,
                          camera.position)), 0, -1)
        expected = render_reference(
            make_reference(scene, meta, aux),
            camera.view_projection_transform, camera.position, 96, 64,
            SAMPLE_OFFSETS[1], max_anisotropy=config.max_anisotropy,
        )
        assert_images_close(produced, expected)

    def _fused_scene(self, tmp_path, wrap, mag=9729, min=9987):
        """Small textured scene exercising the fused-mip edge cases: uvs far
        outside [0,1] (wrap saturation), a deep perspective plane (lod spans
        the whole chain incl. the top, where l1 == l0), an 8px chain."""
        from vktf.models.gltf_writer import GltfWriter
        from vktf.models.primitives import plane_mesh

        import sys
        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from helpers import checker_png_bytes

        w = GltfWriter()
        img = w.add_image_bytes(checker_png_bytes(8, cell=2), "image/png")
        s = w.add_sampler(mag=mag, min=min, wrap_s=wrap, wrap_t=wrap)
        mat = w.add_material(
            base_color_texture=w.add_texture(img, s),
            metallic_roughness_texture=w.add_texture(img, s),
            normal_texture=w.add_texture(img, s),
            metallic_factor=0.3, roughness_factor=0.6,
        )
        geom = plane_mesh(40.0)  # deep plane: lod reaches the chain top
        geom["uvs"] = geom["uvs"] * 4.0 - 1.5  # far outside [0,1]
        sun = w.add_light("directional", color=(2.5, 2.5, 2.5))
        w.add_scene([
            w.add_node(mesh=w.add_mesh(geom, material=mat),
                       translation=(0.0, 0.0, -2.0)),
            w.add_node(light=sun, rotation=(-0.3827, 0.0, 0.0, 0.9239)),
        ])
        return w.write(tmp_path / f"fused_{wrap}_{mag}_{min}.gltf")

    @pytest.mark.parametrize("wrap,mag,min", [
        (10497, 9729, 9987),   # linear mag, trilinear min
        (10497, 9728, 9984),   # nearest mag/min + nearest mip
        (10497, 9729, 9985),   # linear min + nearest mip
        (10497, 9728, 9986),   # nearest mag/min + linear mip
    ])
    def test_filter_modes_match_oracle(self, tmp_path, wrap, mag,
                                                min):
        """The filter and mip modes render like the numpy oracle under
        repeat wrap — uvs far outside [0,1], a deep perspective plane whose
        lod spans the whole chain (incl. the top, where l1 == l0), an 8px
        chain (ops/texture_pack.py block layout, ops/shade_table.py
        addressing)."""
        import numpy as np

        from vktf.config import RenderConfig
        from vktf.ops.pipeline import make_frame_fn
        from vktf.ops.raster_xla import SAMPLE_OFFSETS
        from vktf.ops.reference import render_reference

        import sys
        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from helpers import (assert_images_close, build_scene,
                             default_camera, make_reference)

        path = self._fused_scene(tmp_path, wrap, mag=mag, min=min)
        scene, meta, aux = build_scene(path)
        assert not meta.mirror_wrap and not meta.mixed_samplers
        # the whole plane in front of the camera: the oracle skips
        # near-plane crossers
        camera = default_camera(position=(0.0, 1.5, 19.0),
                                direction=(0.0, -0.12, -1.0))
        config = RenderConfig(width=96, height=64, msaa_samples=1,
                              tile_shape=(32, 32), backend="pallas",
                              shading_rate="sample")
        fn = make_frame_fn(meta, config)
        produced = np.moveaxis(np.asarray(
            fn(scene, camera.view_projection_transform, camera.position)
        ), 0, -1)
        expected = render_reference(
            make_reference(scene, meta, aux),
            camera.view_projection_transform, camera.position, 96, 64,
            SAMPLE_OFFSETS[1], max_anisotropy=config.max_anisotropy,
        )
        assert produced[..., :3].max() > 40
        assert_images_close(produced, expected)

    def test_identical_samplers_stay_single_gather(self, tmp_path):
        """Scenes whose materials share samplers across slots keep
        mixed_samplers=False (the 1-gather-per-level fast path)."""
        from vktf.models.gltf_writer import GltfWriter
        from vktf.models.primitives import plane_mesh

        import sys
        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from helpers import build_scene, checker_png_bytes

        w = GltfWriter()
        img = w.add_image_bytes(checker_png_bytes(16), "image/png")
        s = w.add_sampler()
        mat = w.add_material(
            base_color_texture=w.add_texture(img, s),
            metallic_roughness_texture=w.add_texture(img, s),
        )
        w.add_scene([w.add_node(mesh=w.add_mesh(plane_mesh(2.0), material=mat))])
        _scene, meta, _aux = build_scene(w.write(tmp_path / "same.gltf"))
        assert not meta.mixed_samplers


def test_ktx2_truncation_fuzz_fails_cleanly(tmp_path):
    """Every prefix-truncation of valid BasisLZ and zstd .ktx2 files either
    decodes, skips with a logged error (None), or raises KtxError — never a
    backend exception (struct.error, zstandard.ZstdError, zlib.error). The
    loader's two-tier policy must hold for arbitrary malformed bytes
    (ktx_texture.cppm:62-94's role, model.cppm:301-321 skip-and-log)."""
    import io

    import numpy as np

    from vktf.loaders.images import generate_mips
    from vktf.loaders.ktx import KtxError, load_ktx
    from vktf.log import Log
    from vktf.models.export import write_ktx2, write_ktx2_basis

    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (16, 16, 4), dtype=np.uint8)
    levels = generate_mips(img, srgb=True)
    for name in ("basis", "zstd"):
        p = tmp_path / f"{name}.ktx2"
        if name == "basis":
            write_ktx2_basis(p, levels, True)
        else:
            write_ktx2(p, levels, True, supercompression=2)
        blob = p.read_bytes()
        cuts = {int(c) for c in rng.integers(0, len(blob), 48)}
        cuts |= {0, 11, 12, 47, 48, 79, 80, len(blob) - 1}
        for cut in sorted(cuts):
            q = tmp_path / f"{name}{cut}.ktx2"
            q.write_bytes(blob[:cut])
            try:
                load_ktx(q, log=Log(io.StringIO(), io.StringIO()))
            except KtxError:
                pass  # the fatal tier


def test_ktx2_hostile_header_lengths_fail_cleanly(tmp_path):
    """Header-claimed sizes must be bounded BEFORE anything allocates:
    a corrupt uncompressedByteLength (2^62) or implausible dimensions
    raise KtxError instead of MemoryError/OOM (code-review r2s4)."""
    import struct

    import numpy as np

    from vktf.loaders.images import generate_mips
    from vktf.loaders.ktx import KtxError, parse_ktx2
    from vktf.models.export import write_ktx2

    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (16, 16, 4), dtype=np.uint8)
    p = tmp_path / "t.ktx2"
    write_ktx2(p, generate_mips(img, srgb=True), True, supercompression=2)
    blob = bytearray(p.read_bytes())

    # level 0 index entry at byte 80: offset, byteLength, uncompressedLength
    hostile = bytearray(blob)
    struct.pack_into("<Q", hostile, 80 + 16, 1 << 62)
    with pytest.raises(KtxError):
        parse_ktx2(bytes(hostile), "hostile-len")

    # implausible dimensions (width u32 at byte 12 + 8)
    hostile = bytearray(blob)
    struct.pack_into("<I", hostile, 12 + 8, 1 << 24)
    with pytest.raises(KtxError):
        parse_ktx2(bytes(hostile), "hostile-dims")


def test_corrupt_ktx2_texture_degrades_not_aborts(tmp_path):
    """A malformed .ktx2 referenced by a scene falls back to the default
    texture (model.cppm:301-321 skip-and-log) instead of aborting
    engine.load — KtxError previously escaped through flatten's decode
    thread pool (code-review r2s4 follow-up)."""
    import io

    import numpy as np

    from vktf.loaders.gltf import Texture
    from vktf.loaders.images import decode_texture
    from vktf.log import Log

    # unit tier: decode_texture returns None with a logged error
    blob = b"\xabKTX 20\xbb\r\n\x1a\n" + b"\x00" * 4  # truncated header
    out, err = io.StringIO(), io.StringIO()
    tex = Texture(name="bad", data=blob, filepath=None, sampler=None)
    assert decode_texture(tex, "base_color", Log(out, err)) is None
    assert "bad" in err.getvalue()


class TestMultiTapAnisotropy:
    def _floor_scene(self, tmp_path):
        from vktf.models.gltf_writer import GltfWriter
        from vktf.models.primitives import plane_mesh

        import sys
        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from helpers import checker_png_bytes

        w = GltfWriter()
        img = w.add_image_bytes(checker_png_bytes(128, cell=4), "image/png")
        tex = w.add_texture(img, w.add_sampler())
        mat = w.add_material(base_color_texture=tex, metallic_factor=0.0,
                             roughness_factor=0.9)
        floor = w.add_mesh(plane_mesh(20.0), material=mat)
        sun = w.add_light("directional", color=(2.0, 2.0, 2.0))
        w.add_scene([
            w.add_node(mesh=floor, translation=(0.0, 0.0, -1.5)),
            w.add_node(light=sun, rotation=(-0.3827, 0.0, 0.0, 0.9239)),
        ])
        return w.write(tmp_path / "floor.gltf")

    def test_multi_tap_matches_oracle(self, tmp_path):
        """TRUE N-tap anisotropic filtering (aniso_taps=4, VERDICT r3
        missing #3): the production multi-tap sampler (XLA shade form)
        matches the numpy oracle's identical N-tap kernel on a grazing
        floor, and actually differs from the single-tap approximation."""
        import numpy as np

        from vktf.config import RenderConfig
        from vktf.ops.pipeline import make_frame_fn
        from vktf.ops.raster_xla import SAMPLE_OFFSETS
        from vktf.ops.reference import render_reference

        import sys
        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from helpers import (assert_images_close, build_scene,
                             default_camera, make_reference)

        scene, meta, aux = build_scene(self._floor_scene(tmp_path))
        camera = default_camera(position=(0.0, 0.2, 9.5),
                                direction=(0.0, -0.05, -1.0))
        config = RenderConfig(width=96, height=64, msaa_samples=1,
                              tile_shape=(32, 64), backend="pallas",
                              shading_rate="sample", max_anisotropy=8.0,
                              aniso_taps=4)
        fn = make_frame_fn(meta, config)
        produced = np.moveaxis(
            np.asarray(fn(scene, camera.view_projection_transform,
                          camera.position)), 0, -1)
        expected = render_reference(
            make_reference(scene, meta, aux),
            camera.view_projection_transform, camera.position, 96, 64,
            SAMPLE_OFFSETS[1], max_anisotropy=8.0, aniso_taps=4,
        )
        assert_images_close(produced, expected)
        # the taps change pixels vs the single-tap approximation
        single = np.moveaxis(
            np.asarray(make_frame_fn(
                meta, config.replace(aniso_taps=1))(
                    scene, camera.view_projection_transform,
                    camera.position)), 0, -1)
        assert np.abs(produced.astype(int) - single.astype(int)).max() > 2, (
            "multi-tap made no difference on a grazing floor"
        )

    def test_multi_tap_sharded_bit_equal(self, tmp_path):
        """aniso_taps > 1 routes the SHARDED frame through the assembled
        XLA fallback (parallel/tiles.py gate) and stays bit-equal to the
        single-chip multi-tap render."""
        import jax
        import numpy as np

        from vktf.config import RenderConfig
        from vktf.ops.pipeline import make_frame_fn
        from vktf.parallel import make_render_mesh, make_sharded_frame_fn

        import sys
        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from helpers import build_scene, default_camera

        scene, meta, aux = build_scene(self._floor_scene(tmp_path))
        camera = default_camera(aspect=96 / 64, position=(0.0, 0.2, 9.5),
                                direction=(0.0, -0.05, -1.0))
        config = RenderConfig(width=96, height=64, msaa_samples=2,
                              tile_shape=(32, 64), backend="pallas",
                              max_anisotropy=8.0, aniso_taps=2)
        single = np.asarray(make_frame_fn(meta, config)(
            scene, camera.view_projection_transform, camera.position))
        mesh = make_render_mesh(jax.devices(), gp=2)
        sharded = np.asarray(make_sharded_frame_fn(meta, config, mesh)(
            scene, camera.view_projection_transform, camera.position))
        np.testing.assert_array_equal(single, sharded)

    def test_multi_tap_split_stage_matches_fused(self, tmp_path):
        """Multi-tap anisotropy through the split-stage program (pixel-rate
        tile-layout shade, 2x MSAA) equals the fused single-program frame
        bit-for-bit."""
        import numpy as np

        from vktf.config import RenderConfig
        from vktf.ops.pipeline import PallasFrameProgram, make_frame_fn

        import sys
        sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
        from helpers import build_scene, default_camera

        scene, meta, aux = build_scene(self._floor_scene(tmp_path))
        camera = default_camera(aspect=2.0, position=(0.0, 0.2, 9.5),
                                direction=(0.0, -0.05, -1.0))
        base = dict(width=128, height=64, msaa_samples=2,
                    backend="pallas", pallas_interpret=True,
                    tile_shape=(32, 64), pallas_chunk=128,
                    shade_chunk=1 << 12, shade_skip_mode=False,
                    max_anisotropy=8.0, aniso_taps=2)
        split_fn = make_frame_fn(meta, RenderConfig(**base))
        assert isinstance(split_fn, PallasFrameProgram)
        fused_fn = make_frame_fn(meta, RenderConfig(split_stages=False,
                                                    **base))
        vp, pos = camera.view_projection_transform, camera.position
        a = np.asarray(split_fn(scene, vp, pos))
        b = np.asarray(fused_fn(scene, vp, pos))
        np.testing.assert_array_equal(a, b)
        assert (a.sum(axis=0) > 0).any()
