"""Math primitives: quaternions, camera, AABBs, view frustum.

Pure-functional jax-numpy implementations designed to run either host-side
(on numpy-compatible inputs) or inside jitted per-frame steps.
"""

from vktf.mathx.quaternion import (
    quat_angle_axis,
    quat_conjugate,
    quat_look_at,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
)
from vktf.mathx.camera import Camera, ViewFrustumParams, perspective, view_matrix
from vktf.mathx.bounding_box import BoundingBox, transform_aabb, transform_aabbs
from vktf.mathx.frustum import frustum_planes, aabbs_intersect_frustum

__all__ = [
    "quat_angle_axis",
    "quat_conjugate",
    "quat_look_at",
    "quat_multiply",
    "quat_normalize",
    "quat_rotate",
    "quat_to_matrix",
    "Camera",
    "ViewFrustumParams",
    "perspective",
    "view_matrix",
    "BoundingBox",
    "transform_aabb",
    "transform_aabbs",
    "frustum_planes",
    "aabbs_intersect_frustum",
]
