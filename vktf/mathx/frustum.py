"""View-frustum plane extraction and vectorized AABB intersection tests.

Reference: src/engine/view_frustum.cppm — six planes extracted from the
transposed view-projection matrix (Gribb-Hartmann) with a [0,1] depth-range
near plane, and an AABB test using the positive vertex. Here the AABB test is
batched over all meshes at once, producing the per-frame visibility mask used
by the rasterizer (SURVEY.md §2 ViewFrustum row).
"""

from __future__ import annotations


from vktf.mathx._backend import xp_for


def frustum_planes(view_projection):
    """Extract 6 normalized frustum planes, shape (6, 4).

    Plane order (view_frustum.cppm:53-60): left, right, top, bottom, near,
    far. With row-major matrices the glm "columns of the transpose" are simply
    the rows of `view_projection`. Near plane = row 2 alone because depth is
    in [0, 1] (GLM_FORCE_DEPTH_ZERO_TO_ONE).
    """
    xp = xp_for(view_projection)
    m = xp.asarray(view_projection)
    rows = m  # (4,4): rows[i] == transpose(VP) column i in glm terms
    planes = xp.stack(
        [
            rows[3] + rows[0],  # left
            rows[3] - rows[0],  # right
            rows[3] + rows[1],  # top
            rows[3] - rows[1],  # bottom
            rows[2],            # near ([0,1] depth convention)
            rows[3] - rows[2],  # far
        ]
    )
    norms = xp.linalg.norm(planes[:, :3], axis=-1, keepdims=True)
    return planes / norms


def aabbs_intersect_frustum(aabbs, planes):
    """Batched AABB-vs-frustum test.

    aabbs: (N, 2, 3) world-space (min, max); planes: (6, 4).
    Returns (N,) bool visibility mask. Mirrors ViewFrustum::Intersects
    (view_frustum.cppm:68-77): for each plane pick the "positive vertex"
    (max where the plane normal component is >= 0 else min) and require a
    non-negative signed distance on all six planes.
    """
    xp = xp_for(aabbs, planes)
    aabbs = xp.asarray(aabbs)
    planes = xp.asarray(planes)
    normals = planes[:, :3]  # (6,3)
    lo = aabbs[:, 0, :][:, None, :]  # (N,1,3)
    hi = aabbs[:, 1, :][:, None, :]
    positive = xp.where(normals[None, :, :] >= 0.0, hi, lo)  # (N,6,3)
    dist = xp.einsum("npk,pk->np", positive, normals) + planes[None, :, 3]
    return xp.all(dist >= 0.0, axis=-1)
