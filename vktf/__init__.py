"""vktf — a glTF 2.0 physically-based renderer in JAX.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the Vulkan
reference renderer (mjrister/VkTF): glTF 2.0 + KTX2 asset pipeline, a tile
-based software rasterizer with depth test, back-face culling and MSAA, the
full glTF PBR metallic-roughness BRDF with normal mapping and punctual
lights, a quaternion first-person camera, view-frustum culling, and an
engine loop pipelining frames through XLA async dispatch.
"""

from vktf.config import RenderConfig, MAX_RENDER_FRAMES, select_msaa_samples
from vktf.log import Log, Severity, default_log
from vktf.mathx import Camera, ViewFrustumParams

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "MAX_RENDER_FRAMES",
    "select_msaa_samples",
    "Log",
    "Severity",
    "default_log",
    "Camera",
    "ViewFrustumParams",
    "Engine",
    "Window",
]


def __getattr__(name):  # lazy imports to keep `import vktf` light
    if name == "Engine":
        from vktf.engine import Engine

        return Engine
    if name == "Window":
        from vktf.window import Window

        return Window
    raise AttributeError(f"module 'vktf' has no attribute {name!r}")
