"""glTF loader tests: round-trip through the fixture writer, accessor
unpacking (strides, dtypes, sparse), skip-and-log semantics, node transforms."""

import io
import json

import numpy as np
import pytest

from vktf.log import Log
from vktf.loaders.gltf import GltfError, load_gltf
from vktf.models.gltf_writer import GltfWriter
from vktf.models.primitives import box_mesh, plane_mesh, uv_sphere_mesh


def make_log():
    out, err = io.StringIO(), io.StringIO()
    return Log(out_stream=out, err_stream=err), err


def write_box_asset(path, **material_kwargs):
    w = GltfWriter()
    material = w.add_material(name="red", base_color_factor=(0.8, 0.1, 0.1, 1.0),
                              metallic_factor=0.0, roughness_factor=0.9, **material_kwargs)
    mesh = w.add_mesh(box_mesh(), material=material, name="box")
    light = w.add_light(type="directional", color=(1.0, 1.0, 1.0))
    mesh_node = w.add_node(mesh=mesh, translation=(0, 0, -3), name="box_node")
    light_node = w.add_node(light=light, rotation=(0, 0, 0, 1), name="sun")
    w.add_scene([mesh_node, light_node], name="main")
    return w.write(path)


class TestRoundTrip:
    def test_box(self, tmp_path):
        path = write_box_asset(tmp_path / "box.gltf")
        log, err = make_log()
        asset = load_gltf(path, log)
        assert err.getvalue() == ""
        assert asset.name == "box"
        assert len(asset.meshes) == 1
        prim = asset.meshes[0].primitives[0]
        assert prim.positions.shape == (24, 3)
        assert prim.normals.shape == (24, 3)
        assert prim.tangents.shape == (24, 4)
        assert prim.uvs.shape == (24, 2)
        assert prim.indices.shape == (12, 3)
        assert prim.indices.dtype == np.uint32
        np.testing.assert_allclose(prim.aabb[0], [-0.5, -0.5, -0.5])
        np.testing.assert_allclose(prim.aabb[1], [0.5, 0.5, 0.5])
        mat = prim.material
        np.testing.assert_allclose(
            mat.pbr_metallic_roughness.base_color_factor, [0.8, 0.1, 0.1, 1.0]
        )
        assert mat.pbr_metallic_roughness.metallic_factor == 0.0
        assert len(asset.lights) == 1
        assert asset.lights[0].type == "directional"
        assert asset.default_scene == 0
        roots = asset.scenes[0].root_nodes
        assert len(roots) == 2
        node = asset.nodes[roots[0]]
        np.testing.assert_allclose(node.local_transform[:3, 3], [0, 0, -3])
        assert node.mesh == 0
        assert asset.nodes[roots[1]].light == 0

    def test_sphere_and_plane_geometry(self, tmp_path):
        w = GltfWriter()
        sphere = w.add_mesh(uv_sphere_mesh(rings=4, sectors=6), name="sphere")
        plane = w.add_mesh(plane_mesh(segments=2), name="plane")
        a = w.add_node(mesh=sphere)
        b = w.add_node(mesh=plane, children=[a])
        w.add_scene([b])
        asset = load_gltf(w.write(tmp_path / "two.gltf"))
        assert len(asset.meshes) == 2
        assert asset.nodes[1].children == [0]
        plane_prim = asset.meshes[1].primitives[0]
        assert plane_prim.indices.shape == (8, 3)  # 2x2 quads * 2 tris


class TestAccessors:
    def test_u16_indices_and_normalized_attrs(self, tmp_path):
        w = GltfWriter()
        geometry = plane_mesh()
        # force u16 indices
        attributes = {
            "POSITION": w.add_accessor(geometry["positions"], with_min_max=True),
        }
        indices = w.add_accessor(geometry["indices"].reshape(-1).astype(np.uint16))
        w.gltf["meshes"].append(
            {"primitives": [{"attributes": attributes, "indices": indices, "mode": 4}]}
        )
        node = w.add_node(mesh=0)
        w.add_scene([node])
        asset = load_gltf(w.write(tmp_path / "u16.gltf"))
        prim = asset.meshes[0].primitives[0]
        assert prim.indices.dtype == np.uint32
        np.testing.assert_array_equal(prim.indices.reshape(-1), geometry["indices"].reshape(-1))

    def test_interleaved_stride(self, tmp_path):
        # interleave position+uv in one buffer view with byteStride
        w = GltfWriter()
        pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        uv = np.array([[0, 0], [1, 0], [0, 1]], np.float32)
        interleaved = np.concatenate([pos, uv], axis=1).astype(np.float32)  # (3,5)
        view = w._add_buffer_view(interleaved.tobytes())
        w.gltf["bufferViews"][view]["byteStride"] = 20
        w.gltf["accessors"].append(
            {"bufferView": view, "byteOffset": 0, "componentType": 5126, "count": 3, "type": "VEC3"}
        )
        w.gltf["accessors"].append(
            {"bufferView": view, "byteOffset": 12, "componentType": 5126, "count": 3, "type": "VEC2"}
        )
        indices = w.add_accessor(np.array([0, 1, 2], np.uint32))
        w.gltf["meshes"].append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
                        "indices": indices,
                        "mode": 4,
                    }
                ]
            }
        )
        w.add_scene([w.add_node(mesh=0)])
        asset = load_gltf(w.write(tmp_path / "interleaved.gltf"))
        prim = asset.meshes[0].primitives[0]
        np.testing.assert_allclose(prim.positions, pos)
        np.testing.assert_allclose(prim.uvs, uv)


class TestSkipAndLog:
    def test_non_triangle_primitive_skipped(self, tmp_path):
        w = GltfWriter()
        geometry = plane_mesh()
        material = w.add_material()
        w.add_mesh(geometry, material=material)
        w.gltf["meshes"][0]["primitives"][0]["mode"] = 1  # LINES
        w.add_scene([w.add_node(mesh=0)])
        log, err = make_log()
        asset = load_gltf(w.write(tmp_path / "lines.gltf"), log)
        assert asset.meshes[0].primitives == []
        assert "unsupported mode" in err.getvalue()

    def test_unsupported_light_skipped_and_reindexed(self, tmp_path):
        w = GltfWriter()
        spot = w.add_light(type="spot")
        point = w.add_light(type="point", color=(0.0, 1.0, 0.0))
        spot_node = w.add_node(light=spot)
        point_node = w.add_node(light=point)
        w.add_scene([spot_node, point_node])
        log, err = make_log()
        asset = load_gltf(w.write(tmp_path / "lights.gltf"), log)
        assert "unsupported type" in err.getvalue()
        assert len(asset.lights) == 1
        assert asset.lights[0].type == "point"
        assert asset.nodes[0].light is None  # spot dropped
        assert asset.nodes[1].light == 0  # re-indexed

    def test_missing_file_raises(self):
        with pytest.raises(GltfError):
            load_gltf("/nonexistent/asset.gltf")

    def test_bad_json_raises(self, tmp_path):
        path = tmp_path / "bad.gltf"
        path.write_text("{not json")
        with pytest.raises(GltfError):
            load_gltf(path)


class TestNodeTransforms:
    def test_trs_composition(self, tmp_path):
        w = GltfWriter()
        mesh = w.add_mesh(plane_mesh())
        # rotate 90 deg about y (x,y,z,w), then translate
        node = w.add_node(
            mesh=mesh,
            translation=(1, 2, 3),
            rotation=(0, np.sin(np.pi / 4), 0, np.cos(np.pi / 4)),
            scale=(2, 2, 2),
        )
        w.add_scene([node])
        asset = load_gltf(w.write(tmp_path / "trs.gltf"))
        m = asset.nodes[0].local_transform
        np.testing.assert_allclose(m[:3, 3], [1, 2, 3], atol=1e-6)
        # +x axis maps to -z after +90deg yaw, scaled by 2
        np.testing.assert_allclose(m[:3, :3] @ [1, 0, 0], [0, 0, -2], atol=1e-6)

    def test_matrix_column_major(self, tmp_path):
        w = GltfWriter()
        mesh = w.add_mesh(plane_mesh())
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [4, 5, 6]
        node = w.add_node(mesh=mesh, matrix=m)
        w.add_scene([node])
        asset = load_gltf(w.write(tmp_path / "matrix.gltf"))
        np.testing.assert_allclose(asset.nodes[0].local_transform, m, atol=1e-6)


def test_glb_container(tmp_path):
    # build a GLB by hand from a writer-produced gltf
    w = GltfWriter()
    w.add_mesh(box_mesh())
    w.add_scene([w.add_node(mesh=0)])
    gltf_path = w.write(tmp_path / "box.gltf")
    gltf = json.loads(gltf_path.read_text())
    import base64 as b64
    import struct

    payload = b64.b64decode(gltf["buffers"][0]["uri"].split(",", 1)[1])
    del gltf["buffers"][0]["uri"]
    json_chunk = json.dumps(gltf).encode()
    json_chunk += b" " * (-len(json_chunk) % 4)
    bin_chunk = payload + b"\0" * (-len(payload) % 4)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    glb = (
        struct.pack("<III", 0x46546C67, 2, total)
        + struct.pack("<II", len(json_chunk), 0x4E4F534A)
        + json_chunk
        + struct.pack("<II", len(bin_chunk), 0x004E4942)
        + bin_chunk
    )
    glb_path = tmp_path / "box.glb"
    glb_path.write_bytes(glb)
    asset = load_gltf(glb_path)
    assert asset.meshes[0].primitives[0].positions.shape == (24, 3)


def test_truncation_fuzz_fails_cleanly(tmp_path):
    """Every prefix-truncation of a valid .glb and .gltf either loads with
    skip+log or raises GltfError — never an unhandled exception (the
    two-tier failure policy, SURVEY §5.3: fatal throw vs skip-and-log)."""
    w = GltfWriter()
    w.add_mesh(box_mesh())
    w.add_scene([w.add_node(mesh=0)])
    gltf_path = w.write(tmp_path / "box.gltf")
    gltf = json.loads(gltf_path.read_text())
    import base64 as b64
    import struct

    payload = b64.b64decode(gltf["buffers"][0]["uri"].split(",", 1)[1])
    del gltf["buffers"][0]["uri"]
    json_chunk = json.dumps(gltf).encode()
    json_chunk += b" " * (-len(json_chunk) % 4)
    bin_chunk = payload + b"\0" * (-len(payload) % 4)
    total = 12 + 8 + len(json_chunk) + 8 + len(bin_chunk)
    glb = (
        struct.pack("<III", 0x46546C67, 2, total)
        + struct.pack("<II", len(json_chunk), 0x4E4F534A)
        + json_chunk
        + struct.pack("<II", len(bin_chunk), 0x004E4942)
        + bin_chunk
    )
    text = gltf_path.read_bytes()
    rng = np.random.default_rng(7)
    cases = sorted(
        {int(c) for c in rng.integers(0, len(glb), 24)}
        | {0, 1, 11, 12, 19, 20, len(glb) - 1}
    )
    for cut in cases:
        p = tmp_path / f"t{cut}.glb"
        p.write_bytes(glb[:cut])
        try:
            load_gltf(p)
        except GltfError:
            pass  # the fatal tier
    for cut in sorted({int(c) for c in rng.integers(0, len(text), 16)}):
        p = tmp_path / f"t{cut}.gltf"
        p.write_bytes(text[:cut])
        try:
            load_gltf(p)
        except GltfError:
            pass


def test_non_object_json_raises(tmp_path):
    # valid JSON that is not a glTF object must be the fatal tier, not an
    # AttributeError downstream (code-review r2s4)
    for body in ("[]", "null", "3"):
        p = tmp_path / f"x{len(body)}.gltf"
        p.write_text(body)
        with pytest.raises(GltfError):
            load_gltf(p)


def test_hostile_fields_raise_gltf_error(tmp_path):
    """Structured corruption of glTF JSON fields must surface as the fatal
    tier (GltfError), never a backend exception — and a node cycle must be
    rejected at LOAD time (it previously HUNG transform propagation at
    scene flatten). cgltf_validate's role, gltf_asset.cppm:466-470."""
    import copy

    w = GltfWriter()
    w.add_mesh(box_mesh())
    w.add_scene([w.add_node(mesh=0)])
    base = json.loads((w.write(tmp_path / "base.gltf")).read_text())

    mutations = {
        "acc_count_huge": lambda g: g["accessors"][0].__setitem__("count", 1 << 40),
        "acc_count_neg": lambda g: g["accessors"][0].__setitem__("count", -5),
        "bv_offset_huge": lambda g: g["bufferViews"][0].__setitem__("byteOffset", 1 << 40),
        "acc_bad_type": lambda g: g["accessors"][0].__setitem__("type", "MAT9"),
        "acc_bad_comp": lambda g: g["accessors"][0].__setitem__("componentType", 9999),
        "node_child_self": lambda g: g["nodes"][0].__setitem__("children", [0]),
        "node_child_oob": lambda g: g["nodes"][0].__setitem__("children", [99]),
        "root_is_child": lambda g: (
            g["nodes"].append({"children": [0]}),
            g["scenes"][0]["nodes"].append(1),
        )[0],
        "mesh_oob": lambda g: g["nodes"][0].__setitem__("mesh", 99),
        "scene_oob": lambda g: g.__setitem__("scene", 99),
        "prim_attr_oob": lambda g: g["meshes"][0]["primitives"][0][
            "attributes"
        ].__setitem__("POSITION", 99),
        "acc_str_count": lambda g: g["accessors"][0].__setitem__("count", "many"),
        "nodes_not_list": lambda g: g.__setitem__("nodes", 7),
        "cycle_2": lambda g: (
            g["nodes"].append({"children": [2]}),
            g["nodes"].append({"children": [1]}),
        )[0],
    }
    for name, mutate in mutations.items():
        g = copy.deepcopy(base)
        mutate(g)
        p = tmp_path / f"{name}.gltf"
        p.write_text(json.dumps(g))
        with pytest.raises(GltfError):
            load_gltf(p)


def test_index_oob_skips_primitive(tmp_path):
    """A hostile index buffer (index >= POSITION count) lands in the
    skip-and-log tier like the attribute count checks
    (gltf_asset.cppm:744-760) — previously it passed load_gltf and crashed
    flatten_assets with a raw numpy IndexError (VERDICT r2 missing #3)."""
    import base64 as b64

    path = write_box_asset(tmp_path / "box.gltf")
    g = json.loads(path.read_text())
    # patch the first u32 of the indices accessor's buffer view to an
    # out-of-bounds vertex index
    prim = g["meshes"][0]["primitives"][0]
    accessor = g["accessors"][prim["indices"]]
    view = g["bufferViews"][accessor["bufferView"]]
    payload = bytearray(b64.b64decode(g["buffers"][0]["uri"].split(",", 1)[1]))
    ofs = view.get("byteOffset", 0) + accessor.get("byteOffset", 0)
    payload[ofs:ofs + 4] = np.uint32(99999).tobytes()
    g["buffers"][0]["uri"] = (
        "data:application/octet-stream;base64,"
        + b64.b64encode(bytes(payload)).decode()
    )
    p = tmp_path / "index_oob.gltf"
    p.write_text(json.dumps(g))

    log, err = make_log()
    asset = load_gltf(p, log)  # must NOT raise
    assert "out of bounds" in err.getvalue()
    assert asset.meshes[0].primitives == []  # primitive skipped


def test_flatten_guards_hostile_indices(tmp_path):
    """No loader escape may surface as a raw IndexError in flatten's
    tri_corner gather: the flatten-level guard raises the fatal tier."""
    from vktf.scene.flatten import flatten_assets

    asset = load_gltf(write_box_asset(tmp_path / "box.gltf"))
    asset.meshes[0].primitives[0].indices[0, 0] = 99999
    log, _err = make_log()
    with pytest.raises(GltfError, match="out of bounds"):
        flatten_assets([asset], log)
