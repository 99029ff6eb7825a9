"""Render/engine configuration.

The reference has no runtime config system; configuration is compile-time
constants, CMake defines, and device-capability auto-probes (SURVEY.md §5.6;
reference: src/engine/engine.cppm:40,157-199). Here it is a small frozen
dataclass whose "static" fields feed jit specialization — the direct
analogue of the reference's shader specialization constant for light count
(src/engine/graphics_pipeline.cppm:148-155) — plus the device probes that
pick the backend, whether Pallas kernels compile or run in the interpreter,
and MSAA from a supported set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax.numpy as jnp

# Frames in flight; the reference pipelines 2 frames via fences/semaphores
# (src/engine/engine.cppm:40). Here it bounds how many frame_step results may
# be un-awaited before we block (XLA async dispatch provides the overlap).
MAX_RENDER_FRAMES = 2

_SUPPORTED_MSAA = (8, 4, 2, 1)


def device_platform() -> str:
    """Platform of the default JAX device ("gpu", "cpu", ...)."""
    import jax

    return jax.devices()[0].platform


def _supported_platform() -> str:
    platform = device_platform()
    if platform not in ("gpu", "cpu"):
        raise ValueError(
            f"unsupported platform {platform!r}: the renderer runs on a GPU, "
            "or on the CPU for tests")
    return platform


def select_msaa_samples(requested: int) -> int:
    """Pick the highest supported MSAA count <= requested.

    Mirrors the reference's "max supported of {8,4,2} else 1" probe
    (src/engine/engine.cppm:157-171); our software rasterizer supports all of
    them, so this clamps/validates the request.
    """
    for samples in _SUPPORTED_MSAA:
        if requested >= samples:
            return samples
    return 1


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration; a change triggers (cached) recompilation."""

    width: int = 1920
    height: int = 1080
    msaa_samples: int = 4

    # Tile dimensions, (height, width) in pixels. None picks per backend:
    # the raster kernel's tile (ops.raster_pallas.TILE_SHAPE, powers of two
    # so a tile's samples form one Triton block) for "pallas", (32, 128) for
    # the XLA tiled backend (whose per-tile bin capacities scale with tile
    # area).
    tile_shape: Optional[Tuple[int, int]] = None
    # Max triangles binned per tile; overflow is skipped with a logged error,
    # following the reference's skip-and-log ethos (SURVEY.md §5.3).
    bin_capacity: int = 4096
    # Max tiles a triangle may cover before it falls to the shared
    # large-triangle list, and that list's capacity (ops.binning).
    k_pairs: int = 8
    large_capacity: int = 256
    # Triangles processed per rasterizer inner step of the tiled backend.
    raster_chunk: int = 32
    # Tiles rasterized together per grid step of the tiled path.
    tile_batch: int = 8
    # Triangles per streamed chunk of the raster kernel (a power of two):
    # the granularity of the per-bin hit lists (ops.raster_pallas; chosen
    # on an H100, PERF.md).
    pallas_chunk: int = 64
    # Run Pallas kernels in the interpreter. None decides by platform
    # (kernel_interpret): interpreted on the CPU, compiled on the GPU. True
    # is the explicit test switch and is refused on a GPU.
    pallas_interpret: Optional[bool] = None
    # Samples shaded per chunk of the XLA deferred shade (bounds the gather
    # intermediates held at once).
    shade_chunk: int = 1 << 19
    # Fragment shading rate (pallas backend): "pixel" shades once per pixel
    # at the center and resolves by coverage fraction — Vulkan's actual
    # non-sampleShading behavior (and 4x cheaper at 4x MSAA); "sample"
    # supersamples every MSAA sample (matches the numpy reference exactly).
    shading_rate: str = "pixel"
    # Empty-chunk skipping in the deferred shade: None = auto (on for scenes
    # under 32k triangles, which cannot densely cover a large frame); True/
    # False forces it, e.g. off for a small scene that densely covers the
    # screen (fullscreen quad / skybox).
    shade_skip_mode: Optional[bool] = None
    # Sampler anisotropy (pallas backend + numpy oracle), as single-tap LOD
    # sharpening: mips select by the minor footprint axis, ratio clamped to
    # this value. 1.0 = isotropic (off). Default ON at 16x — the reference
    # enables sampler anisotropy up to the device max whenever the device
    # supports it (model.cppm:261-275), and 16 is the universal device max.
    max_anisotropy: float = 16.0
    # TRUE multi-tap anisotropic filtering (1 = the single-tap LOD
    # sharpening above; 2/4/8 = N taps along the major footprint axis with
    # their own pool gathers, averaged before the BRDF — the reference
    # sampler's anisotropy, model.cppm:261-275). An opt-in fidelity knob;
    # the numpy oracle implements the same kernel, golden-pinned
    # (tests/test_textures.py).
    aniso_taps: int = 1

    # Depth-peel layer count override (pallas backend). None = auto: the
    # scene-derived estimate (1 + translucent instances, clamped to the
    # kernel's 8-layer cap — scene/flatten.PEEL_LAYERS_MAX). An explicit
    # 1..8 forces K, e.g. for stacked translucent geometry inside ONE
    # instance, which the per-instance estimate cannot see
    # (flatten._estimate_peel_layers docstring). All-opaque scenes estimate
    # K=1 and pay nothing.
    peel_layers: Optional[int] = None

    # Clear values (reference: engine.cppm:520 clears black, depth 1.0).
    clear_color: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 1.0)
    clear_depth: float = 1.0

    # Present encoding: what leaves the device per frame (ops/present.py).
    # "rgb" (default) = the exact planar (3, H, W) uint8 frame — the
    # reference's lossless present. "yuv420" = device-side BT.601 4:2:0
    # encode packed into one flat uint8 array (1.5 B/px, half the present
    # traffic; luma exact, chroma 2x2-subsampled) — for link-bound remote
    # viewing; the engine decodes on host before the window sinks.
    present_format: str = "rgb"
    # Preview present stream: device-side box downsample of the presented
    # frame by this factor (1 = full resolution). At scale 2 the present
    # traffic drops 4x (8x combined with yuv420) — for link-bound remote
    # viewing where the device->host transfer, not the render, limits the
    # interactive rate. The RENDER itself stays full-resolution: exact stills remain available
    # via Scene.render_still() (test-pinned bit-exact), and the host
    # upsamples the preview for display (ops/present.py).
    present_scale: int = 1

    # Compute dtypes. Geometry stays f32 (raster precision); shading math f32;
    # texture storage uint8 in device memory, converted post-gather.
    geom_dtype: jnp.dtype = jnp.float32
    shade_dtype: jnp.dtype = jnp.float32

    # Raster backend: "auto" picks "pallas" (the production frame path: the
    # Triton raster kernel + XLA setup/table/shade) on a GPU and "tiled"
    # (binned XLA) on the CPU (resolved_backend); "dense" is the
    # every-triangle-vs-every-sample semantic reference. "xla" is an alias
    # for "dense".
    backend: str = "auto"

    # Split the pallas frame into per-stage jit programs (prepare / raster /
    # shade-table / shade+resolve) instead of one fused program. XLA compile
    # time is superlinear in program size, a source edit only recompiles the
    # stage it touched, and the split enables cross-frame caching of the
    # Morton stream sort.
    split_stages: bool = True
    # Relative view-projection change (Frobenius) above which the cached
    # Morton stream permutation is recomputed (split-stage path). The sort
    # affects only raster locality, never output, so staleness is exact;
    # 0 re-sorts every frame.
    resort_threshold: float = 0.03
    # Cache the CAMERA-INDEPENDENT half of prepare (node transform
    # propagation, world lights, the (T,16) instance-matrix row gather,
    # world AABBs) across frames in the split-stage program, recomputed
    # only when the scene pytree changes identity (jax arrays are
    # immutable, so same-object means same values — the analogue of the
    # reference recomputing Scene::Update only for dirty transforms).
    # None = auto (on for the split-stage pallas program).
    prepare_scene_cache: Optional[bool] = None

    # Number of devices to shard framebuffer tiles across (1 = single chip).
    num_devices: int = 1

    def __post_init__(self) -> None:
        if self.msaa_samples not in _SUPPORTED_MSAA:
            raise ValueError(f"msaa_samples must be one of {_SUPPORTED_MSAA}, got {self.msaa_samples}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("render target must be non-empty")
        if self.backend not in ("auto", "tiled", "dense", "xla", "pallas"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.shading_rate not in ("pixel", "sample"):
            raise ValueError(f"unknown shading_rate {self.shading_rate!r}")
        if self.aniso_taps not in (1, 2, 4, 8):
            raise ValueError(
                f"aniso_taps must be 1, 2, 4 or 8, got {self.aniso_taps}"
            )
        if self.peel_layers is not None and not 1 <= self.peel_layers <= 8:
            raise ValueError(
                f"peel_layers must be None or 1..8, got {self.peel_layers}"
            )
        if self.present_format not in ("rgb", "yuv420"):
            raise ValueError(f"unknown present_format {self.present_format!r}")
        if self.present_scale not in (1, 2, 4):
            raise ValueError(
                f"present_scale must be 1, 2 or 4, got {self.present_scale}"
            )
        if self.width % self.present_scale or self.height % self.present_scale:
            raise ValueError(
                "present_scale must divide the frame dimensions, got "
                f"{self.width}x{self.height} / {self.present_scale}"
            )
        if self.present_format == "yuv420" and (
            (self.width // self.present_scale) % 2
            or (self.height // self.present_scale) % 2
        ):
            raise ValueError("yuv420 present requires even (preview) "
                             "width and height")
        if self.tile_shape is None:
            if self.resolved_backend() == "pallas":
                from vktf.ops.raster_pallas import TILE_SHAPE as shape
            else:
                shape = (32, 128)
            object.__setattr__(self, "tile_shape", shape)

    def resolved_peel_layers(self, scene_layers: int) -> int:
        """Effective depth-peel K: the explicit override, else the scene's
        estimate (SceneMeta.peel_layers)."""
        return self.peel_layers if self.peel_layers is not None else scene_layers

    def resolved_backend(self) -> str:
        """Resolve "auto" against the live device (the device-capability
        auto-probe spirit of the reference, SURVEY.md §5.6)."""
        if self.backend != "auto":
            return self.backend
        return {"gpu": "pallas", "cpu": "tiled"}[_supported_platform()]

    def kernel_interpret(self) -> bool:
        """Whether Pallas kernels run in the interpreter: compiled (through
        their GPU route) on a GPU, interpreted on the CPU, which serves tests
        and CPU rehearsal only. No path interprets a kernel while a GPU is
        present."""
        platform = _supported_platform()
        if platform == "gpu":
            if self.pallas_interpret:
                raise ValueError(
                    "pallas_interpret=True on a GPU: kernels compile for the "
                    "card; interpret mode is for the CPU")
            return False
        if self.pallas_interpret is False:
            raise ValueError(
                "pallas_interpret=False on the CPU: compiled Pallas kernels "
                "need a GPU")
        return True

    # -- derived quantities --------------------------------------------------
    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_shape[0])

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_shape[1])

    @property
    def num_tiles(self) -> int:
        return self.tiles_y * self.tiles_x

    @property
    def padded_height(self) -> int:
        return self.tiles_y * self.tile_shape[0]

    @property
    def padded_width(self) -> int:
        return self.tiles_x * self.tile_shape[1]

    def replace(self, **kwargs) -> "RenderConfig":
        return dataclasses.replace(self, **kwargs)
