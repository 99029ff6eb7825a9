"""Quaternion operations (w, x, y, z layout).

Semantics match the rotations used by the reference camera
(src/engine/camera.cppm:87-124), which builds on glm: unit quaternions acting
on vectors by conjugation, Hamilton product composition, and a
``quat_look_at`` that orients the local -z axis along a view direction.

All functions dispatch between numpy (host) and jax.numpy (traced) on their
argument types; quaternions are arrays of shape (..., 4) ordered (w,x,y,z).
"""

from __future__ import annotations

import numpy as np

from vktf.mathx._backend import xp_for


def quat_normalize(q):
    xp = xp_for(q)
    q = xp.asarray(q)
    return q / xp.linalg.norm(q, axis=-1, keepdims=True)


def quat_conjugate(q):
    xp = xp_for(q)
    q = xp.asarray(q)
    return q * xp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_multiply(a, b):
    """Hamilton product a*b (apply b's rotation first, then a's)."""
    xp = xp_for(a, b)
    a, b = xp.asarray(a), xp.asarray(b)
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return xp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_angle_axis(angle, axis):
    """Unit quaternion for a rotation of `angle` radians about unit `axis`."""
    xp = xp_for(angle, axis)
    axis = xp.asarray(axis, dtype=np.float32)
    half = xp.asarray(angle, dtype=np.float32)[..., None] * 0.5
    return xp.concatenate([xp.cos(half), xp.sin(half) * axis], axis=-1)


def quat_rotate(q, v):
    """Rotate vector(s) v of shape (...,3) by unit quaternion(s) q."""
    xp = xp_for(q, v)
    q, v = xp.asarray(q), xp.asarray(v)
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    # v' = v + 2*qw*(qv x v) + 2*(qv x (qv x v))
    t = 2.0 * xp.cross(qv, v)
    return v + qw * t + xp.cross(qv, t)


def quat_to_matrix(q):
    """Rotation matrix (...,3,3) such that M @ v == quat_rotate(q, v)."""
    xp = xp_for(q)
    q = xp.asarray(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = xp.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def _matrix_to_quat(m, xp):
    """Rotation matrix (3,3) -> unit quaternion (w,x,y,z); branch-free."""
    m00, m01, m02 = m[0, 0], m[0, 1], m[0, 2]
    m10, m11, m12 = m[1, 0], m[1, 1], m[1, 2]
    m20, m21, m22 = m[2, 0], m[2, 1], m[2, 2]
    trace = m00 + m11 + m22
    # Four candidate magnitudes; signs recovered from off-diagonal terms.
    qw = xp.sqrt(xp.maximum(0.0, 1.0 + trace)) / 2.0
    qx = xp.sqrt(xp.maximum(0.0, 1.0 + m00 - m11 - m22)) / 2.0
    qy = xp.sqrt(xp.maximum(0.0, 1.0 - m00 + m11 - m22)) / 2.0
    qz = xp.sqrt(xp.maximum(0.0, 1.0 - m00 - m11 + m22)) / 2.0
    qx = xp.copysign(qx, m21 - m12)
    qy = xp.copysign(qy, m02 - m20)
    qz = xp.copysign(qz, m10 - m01)
    return quat_normalize(xp.stack([qw, qx, qy, qz]))


def quat_look_at(direction, up):
    """Orientation whose local -z axis points along `direction`.

    Matches glm::quatLookAt (right-handed) used by the reference camera ctor
    (src/engine/camera.cppm:105-109): the rotation matrix columns are
    (right, true_up, -direction).
    """
    xp = xp_for(direction, up)
    direction = xp.asarray(direction, dtype=np.float32)
    up = xp.asarray(up, dtype=np.float32)
    back = -direction / xp.linalg.norm(direction)
    right = xp.cross(up, back)
    right = right / xp.linalg.norm(right)
    true_up = xp.cross(back, right)
    m = xp.stack([right, true_up, back], axis=-1)  # columns
    return _matrix_to_quat(m, xp)
