"""Minimal glTF 2.0 writer for authoring fixtures and demo scenes.

Writes .gltf with an embedded base64 buffer (single self-contained file) so
synthetic assets flow through the exact same loader path as external content.
Supports: triangle meshes with POSITION/NORMAL/TANGENT/TEXCOORD_0, PBR MR
materials with PNG/KTX2 texture references, KHR_lights_punctual, node
hierarchies with TRS or matrix transforms, and multiple scenes.
"""

from __future__ import annotations

import base64
import json
from pathlib import Path
from typing import Any, Optional

import numpy as np


class GltfWriter:
    def __init__(self) -> None:
        self._buffer = bytearray()
        self.gltf: dict[str, Any] = {
            "asset": {"version": "2.0", "generator": "vktf.gltf_writer"},
            "buffers": [],
            "bufferViews": [],
            "accessors": [],
            "meshes": [],
            "nodes": [],
            "scenes": [],
        }

    # -- low-level -----------------------------------------------------------
    def _add_buffer_view(self, data: bytes, target: Optional[int] = None) -> int:
        # align to 4 bytes
        while len(self._buffer) % 4:
            self._buffer.append(0)
        view = {
            "buffer": 0,
            "byteOffset": len(self._buffer),
            "byteLength": len(data),
        }
        if target is not None:
            view["target"] = target
        self._buffer.extend(data)
        self.gltf["bufferViews"].append(view)
        return len(self.gltf["bufferViews"]) - 1

    _COMPONENT_TYPES = {
        np.dtype(np.float32): 5126,
        np.dtype(np.uint32): 5125,
        np.dtype(np.uint16): 5123,
        np.dtype(np.uint8): 5121,
    }
    _TYPES = {1: "SCALAR", 2: "VEC2", 3: "VEC3", 4: "VEC4", 16: "MAT4"}

    def add_accessor(self, array: np.ndarray, target: Optional[int] = None,
                     with_min_max: bool = False) -> int:
        array = np.ascontiguousarray(array)
        ncomp = 1 if array.ndim == 1 else array.shape[-1]
        view = self._add_buffer_view(array.tobytes(), target)
        accessor: dict[str, Any] = {
            "bufferView": view,
            "componentType": self._COMPONENT_TYPES[array.dtype],
            "count": int(array.shape[0]) if array.ndim > 1 else int(array.size),
            "type": self._TYPES[ncomp],
        }
        if with_min_max:
            flat = array.reshape(-1, ncomp)
            accessor["min"] = [float(x) for x in flat.min(axis=0)]
            accessor["max"] = [float(x) for x in flat.max(axis=0)]
        self.gltf["accessors"].append(accessor)
        return len(self.gltf["accessors"]) - 1

    # -- elements ------------------------------------------------------------
    def add_sampler(self, mag=9729, min=9987, wrap_s=10497, wrap_t=10497) -> int:
        self.gltf.setdefault("samplers", []).append(
            {"magFilter": mag, "minFilter": min, "wrapS": wrap_s, "wrapT": wrap_t}
        )
        return len(self.gltf["samplers"]) - 1

    def add_image_uri(self, uri: str) -> int:
        self.gltf.setdefault("images", []).append({"uri": uri})
        return len(self.gltf["images"]) - 1

    def add_image_bytes(self, data: bytes, mime_type: str) -> int:
        uri = f"data:{mime_type};base64," + base64.b64encode(data).decode("ascii")
        self.gltf.setdefault("images", []).append({"uri": uri, "mimeType": mime_type})
        return len(self.gltf["images"]) - 1

    def add_texture(self, image: int, sampler: Optional[int] = None, basisu: bool = False) -> int:
        tex: dict[str, Any] = {}
        if basisu:
            tex["extensions"] = {"KHR_texture_basisu": {"source": image}}
            self.gltf.setdefault("extensionsUsed", [])
            if "KHR_texture_basisu" not in self.gltf["extensionsUsed"]:
                self.gltf["extensionsUsed"].append("KHR_texture_basisu")
        else:
            tex["source"] = image
        if sampler is not None:
            tex["sampler"] = sampler
        self.gltf.setdefault("textures", []).append(tex)
        return len(self.gltf["textures"]) - 1

    def add_material(
        self,
        name: Optional[str] = None,
        base_color_factor=(1.0, 1.0, 1.0, 1.0),
        base_color_texture: Optional[int] = None,
        metallic_factor: float = 1.0,
        roughness_factor: float = 1.0,
        metallic_roughness_texture: Optional[int] = None,
        normal_texture: Optional[int] = None,
        normal_scale: float = 1.0,
        alpha_mode: str = "OPAQUE",
        alpha_cutoff: Optional[float] = None,
        double_sided: bool = False,
    ) -> int:
        pbr: dict[str, Any] = {
            "baseColorFactor": list(map(float, base_color_factor)),
            "metallicFactor": float(metallic_factor),
            "roughnessFactor": float(roughness_factor),
        }
        if base_color_texture is not None:
            pbr["baseColorTexture"] = {"index": base_color_texture}
        if metallic_roughness_texture is not None:
            pbr["metallicRoughnessTexture"] = {"index": metallic_roughness_texture}
        material: dict[str, Any] = {"pbrMetallicRoughness": pbr}
        if name:
            material["name"] = name
        if normal_texture is not None:
            material["normalTexture"] = {"index": normal_texture, "scale": float(normal_scale)}
        if alpha_mode != "OPAQUE":
            material["alphaMode"] = alpha_mode
        if alpha_cutoff is not None:
            material["alphaCutoff"] = float(alpha_cutoff)
        if double_sided:
            material["doubleSided"] = True
        self.gltf.setdefault("materials", []).append(material)
        return len(self.gltf["materials"]) - 1

    def add_mesh(self, geometry: dict[str, np.ndarray], material: Optional[int] = None,
                 name: Optional[str] = None) -> int:
        attributes = {
            "POSITION": self.add_accessor(
                geometry["positions"], target=34962, with_min_max=True
            )
        }
        for key, attr_name in (("normals", "NORMAL"), ("tangents", "TANGENT"), ("uvs", "TEXCOORD_0")):
            if geometry.get(key) is not None:
                attributes[attr_name] = self.add_accessor(geometry[key], target=34962)
        primitive: dict[str, Any] = {
            "attributes": attributes,
            "indices": self.add_accessor(
                geometry["indices"].reshape(-1).astype(np.uint32), target=34963
            ),
            "mode": 4,
        }
        if material is not None:
            primitive["material"] = material
        mesh: dict[str, Any] = {"primitives": [primitive]}
        if name:
            mesh["name"] = name
        self.gltf["meshes"].append(mesh)
        return len(self.gltf["meshes"]) - 1

    def add_light(self, type: str = "point", color=(1.0, 1.0, 1.0), intensity: float = 1.0) -> int:
        ext = self.gltf.setdefault("extensions", {}).setdefault(
            "KHR_lights_punctual", {"lights": []}
        )
        ext["lights"].append({"type": type, "color": list(map(float, color)), "intensity": intensity})
        used = self.gltf.setdefault("extensionsUsed", [])
        if "KHR_lights_punctual" not in used:
            used.append("KHR_lights_punctual")
        return len(ext["lights"]) - 1

    def add_node(
        self,
        mesh: Optional[int] = None,
        light: Optional[int] = None,
        translation=None,
        rotation=None,
        scale=None,
        matrix=None,
        children: Optional[list[int]] = None,
        name: Optional[str] = None,
    ) -> int:
        node: dict[str, Any] = {}
        if name:
            node["name"] = name
        if mesh is not None:
            node["mesh"] = mesh
        if light is not None:
            node["extensions"] = {"KHR_lights_punctual": {"light": light}}
        if matrix is not None:
            # glTF stores column-major; we use row-major internally
            node["matrix"] = [float(x) for x in np.asarray(matrix).T.reshape(-1)]
        else:
            if translation is not None:
                node["translation"] = list(map(float, translation))
            if rotation is not None:
                node["rotation"] = list(map(float, rotation))  # (x,y,z,w)
            if scale is not None:
                node["scale"] = list(map(float, scale))
        if children:
            node["children"] = children
        self.gltf["nodes"].append(node)
        return len(self.gltf["nodes"]) - 1

    def add_scene(self, root_nodes: list[int], name: Optional[str] = None, default: bool = True) -> int:
        scene: dict[str, Any] = {"nodes": root_nodes}
        if name:
            scene["name"] = name
        self.gltf["scenes"].append(scene)
        index = len(self.gltf["scenes"]) - 1
        if default:
            self.gltf["scene"] = index
        return index

    # -- output --------------------------------------------------------------
    def write(self, path: str | Path) -> Path:
        path = Path(path)
        data = bytes(self._buffer)
        self.gltf["buffers"] = [
            {
                "byteLength": len(data),
                "uri": "data:application/octet-stream;base64,"
                + base64.b64encode(data).decode("ascii"),
            }
        ]
        path.write_text(json.dumps(self.gltf))
        return path
