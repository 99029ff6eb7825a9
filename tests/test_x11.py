"""X11 present sink: headless fallback + pure conversion helpers.

A real X server is unavailable in CI, so these tests pin the degradation
contract (Window stays headless, explicit display='x11' raises) and the
display-independent pixel conversion. Reference parity target:
src/engine/window.cppm:28-214 (GLFW window + input polling).
"""

import numpy as np
import pytest

from vktf.window import Window
from vktf.x11 import X11Display, rgba_to_bgrx


def test_rgba_to_bgrx_swizzle():
    frame = np.zeros((2, 3, 4), np.uint8)
    frame[0, 0] = (10, 20, 30, 40)   # R G B A
    frame[1, 2] = (200, 100, 50, 255)
    out = rgba_to_bgrx(frame)
    assert out.shape == (2, 3, 4)
    assert tuple(out[0, 0]) == (30, 20, 10, 255)  # B G R X
    assert tuple(out[1, 2]) == (50, 100, 200, 255)


def test_rgb_input_accepted():
    frame = np.zeros((1, 1, 3), np.uint8)
    frame[0, 0] = (1, 2, 3)
    out = rgba_to_bgrx(frame)
    assert tuple(out[0, 0]) == (3, 2, 1, 255)


def test_unavailable_without_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    assert not X11Display.available()


def test_window_stays_headless_without_display(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    w = Window("t", 32, 16, display="auto")
    assert w._display is None
    # present still works through the headless sink
    w.present(np.zeros((3, 16, 32), np.uint8))
    assert w.last_frame is not None and w.last_frame.shape == (16, 32, 4)


def test_window_explicit_x11_raises(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)
    with pytest.raises(RuntimeError):
        Window("t", 32, 16, display="x11")


def test_window_display_none_skips_probe(monkeypatch):
    # display=None must not even probe X11 (no import side effects)
    monkeypatch.setenv("DISPLAY", ":9999")
    w = Window("t", 32, 16, display=None)
    assert w._display is None


def test_window_default_is_headless():
    # library default must not acquire X side effects implicitly; only the
    # viewer CLI opts into display="auto" (code-review r2s4)
    w = Window("t", 8, 8)
    assert w.has_display is False


def test_interactive_without_display_refuses():
    # script=None (interactive) + no reachable display would render an
    # un-closable loop; start() must refuse before engine construction
    import pytest

    from vktf.game import start

    with pytest.raises(RuntimeError, match="interactive"):
        start(["missing.gltf"], width=8, height=8, script=None, display=None)
