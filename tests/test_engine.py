"""Engine / Window / game-layer tests: load filtering, frame pipelining,
input handling, and the end-to-end run loop."""

import io

import numpy as np
import pytest

from vktf.config import RenderConfig
from vktf.engine import Engine
from vktf.game import (
    DRAG_SPEED,
    MouseLook,
    create_window,
    fly_through_script,
    handle_key_events,
    start,
)
from vktf.log import Log
from vktf.models.gltf_writer import GltfWriter
from vktf.models.primitives import box_mesh
from vktf.window import (
    KEY_ESCAPE,
    KEY_W,
    MOUSE_BUTTON_LEFT,
    ScriptedInput,
    Window,
)


def write_box(tmp_path, name="box.gltf"):
    w = GltfWriter()
    mat = w.add_material(base_color_factor=(0.8, 0.1, 0.1, 1.0), metallic_factor=0.0)
    mesh = w.add_mesh(box_mesh(), material=mat)
    light = w.add_light(type="directional")
    w.add_scene([w.add_node(mesh=mesh, translation=(2, 1, 0)), w.add_node(light=light)])
    return w.write(tmp_path / name)


def small_config():
    return RenderConfig(width=64, height=48, msaa_samples=1, tile_shape=(16, 64))


class TestWindow:
    def test_key_events_and_listeners(self):
        window = Window(width=64, height=48)
        events = []
        window.add_key_event_listener(lambda e: events.append((e.key, e.action)))
        window.press_key("w")
        assert window.is_key_pressed("w")
        window.release_key("w")
        assert not window.is_key_pressed("w")
        assert events == [("w", "press"), ("w", "release")]

    def test_escape_closes_via_game_listener(self):
        window = create_window(64, 48)
        assert not window.is_closed()
        window.press_key(KEY_ESCAPE)
        assert window.is_closed()

    def test_script_closes_at_end(self):
        window = Window(width=8, height=8)
        window.attach_script(ScriptedInput([None, None]))
        window.update()
        window.update()
        assert not window.is_closed()
        window.update()
        assert window.is_closed()


class TestEngineLoad:
    def test_filters_bad_extension_with_log(self, tmp_path):
        err = io.StringIO()
        log = Log(out_stream=io.StringIO(), err_stream=err)
        window = Window(width=64, height=48)
        engine = Engine(window, small_config(), log=log)
        path = write_box(tmp_path)
        bad = tmp_path / "model.obj"
        bad.write_text("not gltf")
        scene = engine.load([bad, path])
        assert scene is not None
        assert "unsupported file extension" in err.getvalue()

    def test_returns_none_when_nothing_loadable(self, tmp_path):
        err = io.StringIO()
        log = Log(out_stream=io.StringIO(), err_stream=err)
        engine = Engine(Window(width=64, height=48), small_config(), log=log)
        bad = tmp_path / "model.obj"
        bad.write_text("x")
        assert engine.load([bad]) is None

    def test_scene_camera_defaults(self, tmp_path):
        engine = Engine(Window(width=64, height=48), small_config(), log=Log(io.StringIO(), io.StringIO()))
        scene = engine.load([write_box(tmp_path)])
        np.testing.assert_allclose(scene.camera.position, [0.0, 1.0, 0.0])
        assert scene.light_count == 1


class TestRenderLoop:
    def test_frames_pipeline_and_present(self, tmp_path):
        window = Window(width=64, height=48)
        engine = Engine(window, small_config(), log=Log(io.StringIO(), io.StringIO()))
        scene = engine.load([write_box(tmp_path)])
        engine.render(scene)  # first frame: still in flight
        assert window.last_frame is None
        engine.render(scene)  # queue full: oldest presented
        assert window.last_frame is not None
        assert window.last_frame.shape == (48, 64, 4)
        engine.wait_idle()
        assert len(engine._in_flight) == 0

    def test_engine_mesh_renders_sharded_same_pixels(self, tmp_path):
        """Engine(mesh=...) routes Scene through the multi-chip sharded
        frame path (the viewer CLI's --mesh); pixels match the plain
        engine bit-for-bit on the virtual device mesh."""
        import jax

        from vktf.parallel import make_render_mesh

        config = RenderConfig(width=128, height=64, msaa_samples=1,
                              tile_shape=(32, 64), backend="pallas")
        log = Log(io.StringIO(), io.StringIO())
        path = write_box(tmp_path)

        window_a = Window(width=128, height=64)
        plain = Engine(window_a, config, log=log)
        scene_a = plain.load([path])
        plain.render(scene_a)
        plain.render(scene_a)
        plain.wait_idle()

        mesh = make_render_mesh(jax.devices()[:4], gp=2, sp=2)
        window_b = Window(width=128, height=64)
        sharded = Engine(window_b, config, log=log, mesh=mesh)
        scene_b = sharded.load([path])
        sharded.render(scene_b)
        sharded.render(scene_b)
        sharded.wait_idle()

        np.testing.assert_array_equal(window_a.last_frame,
                                      window_b.last_frame)

    def test_run_loop_with_script(self, tmp_path):
        window = Window(width=64, height=48)
        window.attach_script(ScriptedInput([None] * 3))
        engine = Engine(window, small_config(), log=Log(io.StringIO(), io.StringIO()))
        scene = engine.load([write_box(tmp_path)])
        frames = []

        def callback(dt):
            engine.render(scene)
            frames.append(dt)

        engine.run(callback)
        assert window.is_closed()
        assert len(frames) == 4  # 3 scripted steps + closing update
        assert window.last_frame is not None


class TestControls:
    def test_wasd_translation_matches_reference_math(self):
        window = Window(width=64, height=48)
        engine_cam = _camera()
        window.press_key(KEY_W)
        handle_key_events(window, engine_cam, delta_time=0.5)
        # W only: translation (0,0,-6*0.5) in local frame; initial orientation
        # looks along +x so local -z == world +x
        np.testing.assert_allclose(engine_cam.position, [3.0, 1.0, 0.0], atol=1e-5)

    def test_mouse_drag_rotates(self):
        window = Window(width=64, height=48)
        cam = _camera()
        look = MouseLook()
        window.press_mouse(MOUSE_BUTTON_LEFT)
        window.move_cursor(0, 0)
        look.handle(window, cam)  # records start, no rotation yet
        q0 = cam.orientation.copy()
        window.move_cursor(100, 0)
        look.handle(window, cam)
        assert not np.allclose(cam.orientation, q0)
        # yaw by -100*k: forward direction rotates about +y
        from vktf.mathx.quaternion import quat_rotate

        fwd = np.asarray(quat_rotate(cam.orientation, np.asarray([0.0, 0.0, -1.0])))
        expected_yaw = -100 * DRAG_SPEED
        np.testing.assert_allclose(
            fwd, [np.cos(expected_yaw), 0.0, -np.sin(expected_yaw)], atol=1e-5
        )

    def test_release_resets_drag_anchor(self):
        window = Window(width=64, height=48)
        cam = _camera()
        look = MouseLook()
        window.press_mouse(MOUSE_BUTTON_LEFT)
        window.move_cursor(0, 0)
        look.handle(window, cam)
        window.release_mouse(MOUSE_BUTTON_LEFT)
        look.handle(window, cam)
        window.press_mouse(MOUSE_BUTTON_LEFT)
        window.move_cursor(500, 500)  # big jump must NOT rotate (fresh anchor)
        q0 = cam.orientation.copy()
        look.handle(window, cam)
        np.testing.assert_allclose(cam.orientation, q0)


def _camera():
    from vktf.mathx import Camera, ViewFrustumParams

    return Camera((0.0, 1.0, 0.0), (1.0, 0.0, 0.0), ViewFrustumParams(np.radians(45), 4 / 3, 0.1, 1e6))


def test_game_start_end_to_end(tmp_path):
    path = write_box(tmp_path)
    window = start(
        [str(path)],
        width=64,
        height=48,
        config=small_config(),
        script=fly_through_script(num_frames=6),
    )
    assert window.is_closed()
    assert window.last_frame is not None
    assert window.last_frame.shape == (48, 64, 4)
