"""Tests for data views, AABB transform, and frustum culling math."""

import numpy as np
import pytest

from vktf.utils import as_view, size_bytes
from vktf.mathx import (
    BoundingBox,
    aabbs_intersect_frustum,
    frustum_planes,
    perspective,
    transform_aabb,
    transform_aabbs,
    view_matrix,
)
from vktf.mathx.quaternion import quat_look_at


class TestDataView:
    # port of tests/engine/data_view_test.cpp constructor coverage
    def test_single_value(self):
        v = as_view(3.5, dtype=np.float32)
        assert v.shape == (1,)
        assert size_bytes(3.5, dtype=np.float32) == 4

    def test_sequence(self):
        v = as_view([1, 2, 3], dtype=np.uint16)
        assert v.shape == (3,)
        assert size_bytes([1, 2, 3], dtype=np.uint16) == 6

    def test_array_flattened_no_copy(self):
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        v = as_view(arr)
        assert v.shape == (12,)
        assert np.shares_memory(v, arr)  # view, not copy
        assert size_bytes(arr) == 48

    def test_none_raises(self):
        # the reference's null-with-size death test (data_view_test.cpp:60-62)
        import pytest

        with pytest.raises(TypeError):
            as_view(None)
        with pytest.raises(TypeError):
            as_view(object())



class TestBoundingBox:
    def test_translate(self):
        box = BoundingBox(np.zeros(3, np.float32), np.ones(3, np.float32))
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [5.0, -1.0, 2.0]
        out = transform_aabb(box, m)
        np.testing.assert_allclose(out.min, [5.0, -1.0, 2.0], atol=1e-6)
        np.testing.assert_allclose(out.max, [6.0, 0.0, 3.0], atol=1e-6)

    def test_rotation_refits(self):
        # 90 deg about z: unit box corners land in x in [-1,0]
        box = BoundingBox(np.zeros(3, np.float32), np.ones(3, np.float32))
        m = np.eye(4, dtype=np.float32)
        c, s = 0.0, 1.0
        m[:2, :2] = [[c, -s], [s, c]]
        out = transform_aabb(box, m)
        np.testing.assert_allclose(out.min, [-1.0, 0.0, 0.0], atol=1e-6)
        np.testing.assert_allclose(out.max, [0.0, 1.0, 1.0], atol=1e-6)

    def test_batched_matches_single(self):
        rng = np.random.default_rng(0)
        boxes = rng.uniform(-2, -1, size=(5, 2, 3)).astype(np.float32)
        boxes[:, 1, :] += 2.0  # ensure max > min
        mats = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
        mats[:, :3, 3] = rng.normal(size=(5, 3))
        out = np.asarray(transform_aabbs(boxes, mats))
        for i in range(5):
            single = transform_aabb(BoundingBox(boxes[i, 0], boxes[i, 1]), mats[i])
            np.testing.assert_allclose(out[i, 0], single.min, atol=1e-5)
            np.testing.assert_allclose(out[i, 1], single.max, atol=1e-5)


class TestFrustum:
    def _vp(self):
        view = np.asarray(
            view_matrix(np.zeros(3, np.float32), quat_look_at([0, 0, -1.0], [0, 1.0, 0]))
        )
        proj = np.asarray(perspective(np.radians(90.0), 1.0, 0.1, 100.0))
        return proj @ view

    def test_box_in_front_visible(self):
        planes = frustum_planes(self._vp())
        box = np.array([[[-0.5, -0.5, -10.5], [0.5, 0.5, -9.5]]], np.float32)
        assert bool(aabbs_intersect_frustum(box, planes)[0])

    def test_box_behind_culled(self):
        planes = frustum_planes(self._vp())
        box = np.array([[[-0.5, -0.5, 9.5], [0.5, 0.5, 10.5]]], np.float32)
        assert not bool(aabbs_intersect_frustum(box, planes)[0])

    def test_box_far_left_culled_and_partial_visible(self):
        planes = frustum_planes(self._vp())
        boxes = np.array(
            [
                [[-200.0, -0.5, -10.5], [-150.0, 0.5, -9.5]],  # far left: culled
                [[-12.0, -0.5, -10.5], [-9.0, 0.5, -9.5]],  # straddles left plane
                [[-0.5, -0.5, -200.0], [0.5, 0.5, -150.0]],  # beyond far plane
                [[-0.5, -0.5, -0.05], [0.5, 0.5, -0.01]],  # in front of near plane
            ],
            np.float32,
        )
        vis = np.asarray(aabbs_intersect_frustum(boxes, planes))
        assert list(vis) == [False, True, False, False]


def test_quat_look_at_forward_is_negative_z():
    q = np.asarray(quat_look_at([0.0, 0.0, -1.0], [0.0, 1.0, 0.0]))
    # identity orientation: camera already looks down -z
    np.testing.assert_allclose(q, [1.0, 0.0, 0.0, 0.0], atol=1e-6)
