"""Optional X11 present sink + input source (ctypes, no SDL/GLFW needed).

The reference opens a real GLFW window and polls keys/mouse from it
(src/engine/window.cppm:28-214). This environment is normally headless, so
``Window`` is display-agnostic — but when a local X server IS reachable
($DISPLAY set and libX11 loadable) this module gives the viewer a real
on-screen swapchain: an ``X11Display`` owns one X window, presents planar
RGB frames via XPutImage (ZPixmap), and translates X key/button/motion
events into the Window's input model (window.cppm:60-96 polling parity).

Pure ctypes on libX11.so.6; degrades to unavailable (never raises at
import) when the library or the display is missing, so the headless path
is untouched. Driven by Window(display="auto") — see vktf.window.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional

import numpy as np

# X11 constants (Xlib.h / X.h)
_KeyPress = 2
_KeyRelease = 3
_ButtonPress = 4
_ButtonRelease = 5
_MotionNotify = 6
_ClientMessage = 33
_KeyPressMask = 1 << 0
_KeyReleaseMask = 1 << 1
_ButtonPressMask = 1 << 2
_ButtonReleaseMask = 1 << 3
_PointerMotionMask = 1 << 6
_StructureNotifyMask = 1 << 17
_ExposureMask = 1 << 15
_ZPixmap = 2
_Button1 = 1

_XK_Escape = 0xFF1B


class _XEvent(ctypes.Union):
    _fields_ = [("type", ctypes.c_int), ("pad", ctypes.c_long * 24)]


def _load_xlib():
    name = ctypes.util.find_library("X11") or "libX11.so.6"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.XOpenDisplay.restype = ctypes.c_void_p
    lib.XOpenDisplay.argtypes = [ctypes.c_char_p]
    lib.XDefaultScreen.argtypes = [ctypes.c_void_p]
    lib.XRootWindow.restype = ctypes.c_ulong
    lib.XRootWindow.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.XDefaultVisual.restype = ctypes.c_void_p
    lib.XDefaultVisual.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.XDefaultDepth.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.XCreateSimpleWindow.restype = ctypes.c_ulong
    lib.XCreateSimpleWindow.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint, ctypes.c_uint, ctypes.c_ulong,
        ctypes.c_ulong,
    ]
    lib.XSelectInput.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.c_long,
    ]
    lib.XMapWindow.argtypes = [ctypes.c_void_p, ctypes.c_ulong]
    lib.XStoreName.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.c_char_p,
    ]
    lib.XInternAtom.restype = ctypes.c_ulong
    lib.XInternAtom.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.XSetWMProtocols.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.POINTER(ctypes.c_ulong),
        ctypes.c_int,
    ]
    lib.XCreateGC.restype = ctypes.c_void_p
    lib.XCreateGC.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.c_ulong, ctypes.c_void_p,
    ]
    lib.XCreateImage.restype = ctypes.c_void_p
    lib.XCreateImage.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_uint, ctypes.c_uint,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.XPutImage.argtypes = [
        ctypes.c_void_p, ctypes.c_ulong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint, ctypes.c_uint,
    ]
    lib.XFlush.argtypes = [ctypes.c_void_p]
    lib.XImageByteOrder.argtypes = [ctypes.c_void_p]
    lib.XFree.argtypes = [ctypes.c_void_p]
    lib.XPending.argtypes = [ctypes.c_void_p]
    lib.XNextEvent.argtypes = [ctypes.c_void_p, ctypes.POINTER(_XEvent)]
    lib.XLookupKeysym.restype = ctypes.c_ulong
    lib.XCloseDisplay.argtypes = [ctypes.c_void_p]
    lib.XDestroyWindow.argtypes = [ctypes.c_void_p, ctypes.c_ulong]
    return lib


def rgba_to_bgrx(frame: np.ndarray) -> np.ndarray:
    """Interleaved (H, W, 3|4) uint8 RGB(A) -> (H, W, 4) BGRX bytes.

    X11 24-depth TrueColor ZPixmap on little-endian stores pixels as
    B,G,R,X in memory. Pure helper so the conversion is unit-testable
    without a display.
    """
    h, w = frame.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = frame[..., 2]
    out[..., 1] = frame[..., 1]
    out[..., 2] = frame[..., 0]
    out[..., 3] = 255
    return out


class X11Display:
    """One X window: present uint8 frames, poll key/button/motion events.

    Parity target: the reference's GLFW window + input polling
    (window.cppm:28-109). Use ``X11Display.available()`` before
    constructing; construction raises RuntimeError when the display
    cannot be opened.
    """

    @staticmethod
    def available() -> bool:
        if not os.environ.get("DISPLAY"):
            return False
        lib = _load_xlib()
        if lib is None:
            return False
        dpy = lib.XOpenDisplay(None)
        if not dpy:
            return False
        # the present path packs 4-byte little-endian BGRX (rgba_to_bgrx),
        # so only 24/32-bit LSBFirst servers are supported; anything else
        # (16-bit, 30-bit deep color, big-endian) falls back to headless
        # rather than blitting scrambled pixels
        depth = lib.XDefaultDepth(dpy, lib.XDefaultScreen(dpy))
        lsb_first = lib.XImageByteOrder(dpy) == 0
        lib.XCloseDisplay(dpy)
        return depth in (24, 32) and lsb_first

    def __init__(self, title: str, width: int, height: int):
        self._lib = lib = _load_xlib()
        if lib is None:
            raise RuntimeError("libX11 not loadable")
        self._dpy = lib.XOpenDisplay(None)
        if not self._dpy:
            raise RuntimeError("cannot open $DISPLAY")
        self.width, self.height = width, height
        screen = lib.XDefaultScreen(self._dpy)
        self._depth = lib.XDefaultDepth(self._dpy, screen)
        if self._depth not in (24, 32) or lib.XImageByteOrder(self._dpy) != 0:
            lib.XCloseDisplay(self._dpy)
            self._dpy = None
            raise RuntimeError(
                f"unsupported X visual (depth {self._depth}); the BGRX "
                "present path needs a 24/32-bit little-endian server"
            )
        self._visual = lib.XDefaultVisual(self._dpy, screen)
        root = lib.XRootWindow(self._dpy, screen)
        self._win = lib.XCreateSimpleWindow(
            self._dpy, root, 0, 0, width, height, 0, 0, 0
        )
        lib.XStoreName(self._dpy, self._win, title.encode())
        lib.XSelectInput(
            self._dpy, self._win,
            _KeyPressMask | _KeyReleaseMask | _ButtonPressMask
            | _ButtonReleaseMask | _PointerMotionMask | _StructureNotifyMask
            | _ExposureMask,
        )
        # close-button -> WM_DELETE_WINDOW ClientMessage (the GLFW
        # window-should-close analogue)
        self._wm_delete = lib.XInternAtom(
            self._dpy, b"WM_DELETE_WINDOW", 0
        )
        self._wm_protocols = lib.XInternAtom(
            self._dpy, b"WM_PROTOCOLS", 0
        )
        atom = ctypes.c_ulong(self._wm_delete)
        lib.XSetWMProtocols(self._dpy, self._win, ctypes.byref(atom), 1)
        lib.XMapWindow(self._dpy, self._win)
        self._gc = lib.XCreateGC(self._dpy, self._win, 0, None)
        self._buf: Optional[ctypes.Array] = None
        self._img = None
        self._img_size = (0, 0)
        lib.XFlush(self._dpy)

    # -- presentation --------------------------------------------------------
    def present(self, frame: np.ndarray) -> None:
        """Blit an interleaved (H, W, 3|4) uint8 RGB(A) frame."""
        bgrx = rgba_to_bgrx(np.asarray(frame))
        h, w = bgrx.shape[:2]
        data = bgrx.tobytes()
        if (self._buf is None or len(self._buf) != len(data)
                or (w, h) != self._img_size):
            if self._img is not None:
                # free only the Xlib-malloc'd XImage struct; the data
                # pointer is this object's ctypes buffer (XDestroyImage
                # would free() it and corrupt the Python heap)
                self._lib.XFree(self._img)
            self._buf = ctypes.create_string_buffer(len(data))
            self._img = self._lib.XCreateImage(
                self._dpy, self._visual, self._depth, _ZPixmap, 0,
                ctypes.cast(self._buf, ctypes.c_char_p), w, h, 32, 0,
            )
            self._img_size = (w, h)
        ctypes.memmove(self._buf, data, len(data))
        self._lib.XPutImage(
            self._dpy, self._win, self._gc, self._img, 0, 0, 0, 0, w, h
        )
        self._lib.XFlush(self._dpy)

    # -- input ----------------------------------------------------------------
    def poll(self):
        """Drain pending X events -> list of (kind, payload) tuples.

        kinds: ("key", name, pressed: bool), ("mouse", "mouse_left",
        pressed), ("motion", x, y), ("close",).
        """
        lib = self._lib
        events = []
        ev = _XEvent()
        while lib.XPending(self._dpy):
            lib.XNextEvent(self._dpy, ctypes.byref(ev))
            kind = ev.type
            if kind in (_KeyPress, _KeyRelease):
                keysym = lib.XLookupKeysym(ctypes.byref(ev), 0)
                name = None
                if keysym == _XK_Escape:
                    name = "escape"
                elif 0x20 <= keysym < 0x7F:
                    name = chr(keysym).lower()
                if name:
                    events.append(("key", name, kind == _KeyPress))
            elif kind in (_ButtonPress, _ButtonRelease):
                # XButtonEvent (LP64): bytes 80-87 hold (state, button)
                button = (ev.pad[10] >> 32) & 0xFFFFFFFF
                if button == _Button1:
                    events.append(
                        ("mouse", "mouse_left", kind == _ButtonPress)
                    )
            elif kind == _MotionNotify:
                x = ctypes.c_int(ev.pad[8] & 0xFFFFFFFF).value
                y = ctypes.c_int((ev.pad[8] >> 32) & 0xFFFFFFFF).value
                events.append(("motion", float(x), float(y)))
            elif kind == _ClientMessage:
                # XClientMessageEvent (LP64): message_type at long-offset 5,
                # data.l[0] at 7. Gate on WM_PROTOCOLS — an unrelated
                # ClientMessage (XEmbed, Xdnd) whose first data long happens
                # to equal the atom id must not close the viewer.
                if (ev.pad[5] == self._wm_protocols
                        and (ev.pad[7] & 0xFFFFFFFF) == self._wm_delete):
                    events.append(("close",))
        return events

    def close(self) -> None:
        if getattr(self, "_dpy", None):
            if self._img is not None:
                self._lib.XFree(self._img)  # struct only; data is ours
                self._img = None
            self._lib.XDestroyWindow(self._dpy, self._win)
            self._lib.XCloseDisplay(self._dpy)
            self._dpy = None
