"""Camera math tests.

Port of the reference test strategy (tests/engine/camera_test.cpp): compare
the camera's view matrix against an independently computed look-at reference
over parameterized translation directions and pitch/yaw combinations, with
eps = 1e-6-ish tolerances, plus the zero-direction error case.
"""

import numpy as np
import pytest

from vktf.mathx import Camera, ViewFrustumParams, perspective
from vktf.mathx.quaternion import (
    quat_angle_axis,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_matrix,
)

ATOL = 1e-5


def look_at(eye, center, up):
    """Independent right-handed look-at (the test oracle, as in camera_test.cpp)."""
    eye, center, up = (np.asarray(v, np.float64) for v in (eye, center, up))
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -np.dot(s, eye)
    m[1, 3] = -np.dot(u, eye)
    m[2, 3] = np.dot(f, eye)
    return m.astype(np.float32)


FRUSTUM = ViewFrustumParams(np.radians(45.0), 16.0 / 9.0, 0.1, 1.0e6)


def make_camera(position=(1.0, 2.0, 3.0), direction=(0.4, -0.3, 0.7)):
    return Camera(position, direction, FRUSTUM)


class TestView:
    def test_view_matches_look_at(self):
        position = np.array([2.0, -3.0, 5.0], np.float32)
        direction = np.array([0.5, 0.25, -1.0], np.float32)
        cam = Camera(position, direction, FRUSTUM)
        expected = look_at(position, position + direction, [0.0, 1.0, 0.0])
        np.testing.assert_allclose(cam.view_transform, expected, atol=ATOL)

    def test_zero_direction_raises(self):
        # death-test analogue (camera_test.cpp:95-97)
        with pytest.raises(ValueError):
            Camera((0, 0, 0), (0, 0, 0), FRUSTUM)


# 7 translation directions as in the reference parameterized suite.
TRANSLATIONS = [
    (0.0, 0.0, 0.0),
    (1.0, 0.0, 0.0),
    (0.0, 1.0, 0.0),
    (0.0, 0.0, 1.0),
    (-1.0, 0.0, 0.0),
    (0.0, -2.0, 0.0),
    (0.5, -1.5, 2.5),
]


@pytest.mark.parametrize("translation", TRANSLATIONS)
def test_translate_moves_in_local_frame(translation):
    cam = make_camera()
    q0 = cam.orientation.copy()
    p0 = cam.position.copy()
    cam.translate(np.array(translation, np.float32))
    expected = p0 + np.asarray(quat_rotate(q0, np.array(translation, np.float32)))
    np.testing.assert_allclose(cam.position, expected, atol=ATOL)
    # orientation unchanged by translation
    np.testing.assert_allclose(cam.orientation, q0, atol=ATOL)


# 9 pitch/yaw combos as in the reference parameterized suite.
ANGLES = [-np.pi / 4, 0.0, np.pi / 4]
PITCH_YAW = [(p, y) for p in ANGLES for y in ANGLES]


@pytest.mark.parametrize("pitch,yaw", PITCH_YAW)
def test_rotate_composes_yaw_world_pitch_local(pitch, yaw):
    cam = make_camera()
    q0 = cam.orientation.copy()
    cam.rotate(pitch, yaw)
    pitch_q = quat_angle_axis(np.float32(pitch), np.array([1.0, 0.0, 0.0], np.float32))
    yaw_q = quat_angle_axis(np.float32(yaw), np.array([0.0, 1.0, 0.0], np.float32))
    expected = quat_normalize(quat_multiply(yaw_q, quat_multiply(q0, pitch_q)))
    # quaternions are double covers; compare rotation matrices
    np.testing.assert_allclose(
        np.asarray(quat_to_matrix(cam.orientation)),
        np.asarray(quat_to_matrix(expected)),
        atol=ATOL,
    )


class TestProjection:
    def test_perspective_zo_with_y_flip(self):
        fovy, aspect, near, far = np.radians(60.0), 1.5, 0.25, 100.0
        proj = np.asarray(perspective(fovy, aspect, near, far))
        tan_half = np.tan(fovy / 2)
        assert proj[0, 0] == pytest.approx(1.0 / (aspect * tan_half))
        assert proj[1, 1] == pytest.approx(-1.0 / tan_half)  # Vulkan y-flip
        # depth range checks: z_view=-near -> depth 0, z_view=-far -> depth 1
        for z, expected_depth in ((-near, 0.0), (-far, 1.0)):
            clip = proj @ np.array([0.0, 0.0, z, 1.0])
            assert clip[2] / clip[3] == pytest.approx(expected_depth, abs=1e-6)

    def test_camera_projection_cached(self):
        cam = make_camera()
        p1 = cam.projection_transform
        assert cam.projection_transform is p1
