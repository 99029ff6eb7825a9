"""Procedural geometry, demo scenes, and glTF fixture authoring.

The reference ships Intel Sponza + glTF sample assets via git-LFS; this
environment has no network, so demo/benchmark scenes are generated
procedurally at matching scale (triangle counts, material/texture variety)
and written through :mod:`vktf.models.gltf_writer` so they exercise the
real asset pipeline end-to-end.
"""

from vktf.models.primitives import box_mesh, plane_mesh, uv_sphere_mesh

__all__ = ["box_mesh", "plane_mesh", "uv_sphere_mesh"]
