"""Engine orchestration: load assets, run the frame loop, render.

Reference parity (src/engine/engine.cppm):
  * ``Engine(window, config)`` — the ctor's Vulkan bootstrap (instance →
    device → swapchain → render pass → sync primitives,
    engine.cppm:395-457) maps to JAX backend/device discovery and compiled
    -function caching; there is no API-object zoo to build.
  * ``load(paths)`` — filters non-glTF files with a logged error
    (engine.cppm:462-473), parses each asset, and builds a Scene whose
    device arrays upload in one batch (the single staging submission,
    scene.cppm:288-312).
  * ``run(callback)`` — the main loop: delta-time update, window event poll,
    user callback (engine.cppm:76-84).
  * ``render(scene)`` — one frame. The reference throttles to 2 frames in
    flight with fences/semaphores (engine.cppm:40,501-563); here frames
    pipeline through XLA async dispatch and we block only when more than
    MAX_RENDER_FRAMES results are outstanding.
"""

from __future__ import annotations

from collections import deque
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import jax

from vktf.config import MAX_RENDER_FRAMES, RenderConfig
from vktf.loaders.gltf import load_gltf
from vktf.log import Log, default_log
from vktf.scene.scene import Scene
from vktf.utils.delta_time import DeltaTime
from vktf.utils.profiling import annotate, counters
from vktf.utils.timing import FrameTimer
from vktf.window import Window

_GLTF_EXTENSIONS = (".gltf", ".glb")

# platform preference for device ranking, best first (the discrete-GPU-
# highest ranking of physical_device.cppm:126-142 mapped to JAX backends)
_PLATFORM_RANK = {"gpu": 0, "cuda": 0, "rocm": 0, "cpu": 1}


def rank_devices(devices):
    """Order devices accelerator-first, then by process locality and id."""
    return sorted(
        devices,
        key=lambda d: (
            _PLATFORM_RANK.get(d.platform, 3),
            getattr(d, "process_index", 0),
            d.id,
        ),
    )


class Engine:
    def __init__(
        self,
        window: Window,
        config: Optional[RenderConfig] = None,
        log: Optional[Log] = None,
        mesh=None,
    ):
        """``mesh``: optional (gp, sp) jax.sharding.Mesh — scenes loaded by
        this engine render through the multi-chip sharded frame path
        (vktf.parallel) instead of the single-chip program."""
        self.log = log or default_log()
        self.window = window
        self.mesh = mesh
        self.config = config or RenderConfig(width=window.width, height=window.height)
        # Device discovery + ranking — the PhysicalDevice selection analogue
        # (physical_device.cppm:126-142 ranks discrete GPUs highest): rank
        # accelerators above host devices, then by local device ordinal, and
        # log the topology the way the reference logs the chosen adapter.
        self.devices = rank_devices(jax.devices())
        first = self.devices[0]
        topo = {}
        for d in self.devices:
            topo[d.platform] = topo.get(d.platform, 0) + 1
        self.log.info(
            f"Engine using {first.platform} device {first.id}"
            + (f" ({getattr(first, 'device_kind', '')})" if getattr(first, "device_kind", "") else "")
            + f"; topology: {topo}"
        )
        # persistent XLA compile cache — the offline .spv shader cache
        # analogue (cmake/compile_shader.cmake); survives process restarts
        from vktf.runtime import enable_persistent_cache

        cache_dir = enable_persistent_cache()
        self.log.info(f"Compile cache at {cache_dir}")
        self._in_flight: deque = deque()
        self._checked_scene: Optional[Scene] = None
        self.frame_timer = FrameTimer()

    # -- asset loading (engine.cppm:459-499) ---------------------------------
    def load(self, paths: Sequence[str | Path]) -> Optional[Scene]:
        """Load glTF assets into a renderable Scene.

        Non-glTF paths are skipped with a logged error (engine.cppm:465-470);
        returns None when nothing loadable remains.
        """
        assets = []
        for path in paths:
            path = Path(path)
            if path.suffix.lower() not in _GLTF_EXTENSIONS:
                self.log.error(
                    f"Failed to load {path} with unsupported file extension {path.suffix}"
                )
                continue
            assets.append(load_gltf(path, self.log))
        if not assets:
            return None
        return Scene(assets, self.config, self.log, mesh=self.mesh)

    # -- main loop (engine.cppm:76-84) ---------------------------------------
    def run(self, callback: Callable[[float], None]) -> None:
        """Loop until the window closes: delta update -> poll -> callback."""
        delta_time = DeltaTime()
        delta_time.update()
        while not self.window.is_closed():
            dt = delta_time.update()
            self.window.update()
            callback(dt)
        self.wait_idle()

    # -- per-frame rendering (engine.cppm:501-563) ---------------------------
    def render(self, scene: Scene) -> None:
        """Dispatch one frame; present the oldest completed frame.

        Frames pipeline MAX_RENDER_FRAMES deep: the render call returns after
        async dispatch, and we only block on (and present) a frame once the
        in-flight queue is full — the fence-wait analogue (engine.cppm:505-509).
        """
        if scene is not self._checked_scene:
            # one-time binning-overflow diagnostic per scene (skip-and-log
            # policy, SURVEY.md §5.3): the tiled backend drops triangles
            # silently past its bin capacities
            self._checked_scene = scene
            diag = scene.binning_diagnostics()
            if diag["dropped_pairs"] or diag["dropped_large"]:
                counters.add("binning.dropped_pairs", diag["dropped_pairs"])
                counters.add("binning.dropped_large", diag["dropped_large"])
                self.log.error(
                    f"Binning overflow: {diag['dropped_pairs']} tile pairs + "
                    f"{diag['dropped_large']} large triangles dropped — raise "
                    "bin_capacity/large_capacity or use the pallas backend"
                )
        with annotate("engine.dispatch"):
            frame = scene.render_async()
        # start the device->host copy now so it overlaps the next frame's
        # compute (the swapchain-present DMA analogue); np.asarray below then
        # only waits, instead of serializing an 8 MB transfer per frame
        try:
            frame.copy_to_host_async()
        except AttributeError:  # non-jax array (tests with numpy stubs)
            pass
        self._in_flight.append(frame)
        if len(self._in_flight) >= MAX_RENDER_FRAMES:
            oldest = self._in_flight.popleft()
            with annotate("engine.present"):
                self.window.present(self._to_presentable(np.asarray(oldest)))
            self.frame_timer.tick()

    def _to_presentable(self, frame: np.ndarray) -> np.ndarray:
        """Host-side decode of device present encodings (ops/present.py):
        yuv420 unpack at preview resolution, then nearest upsample back to
        the window size when the preview stream (present_scale > 1) is on."""
        if (self.config.present_format != "rgb"
                or self.config.present_scale != 1):
            from vktf.ops.present import decode_present

            return decode_present(frame, self.config)
        return frame

    def wait_idle(self) -> None:
        """Drain in-flight frames (the deviceWaitIdle analogue, engine.cppm:83)."""
        while self._in_flight:
            self.window.present(
                self._to_presentable(np.asarray(self._in_flight.popleft()))
            )
            self.frame_timer.tick()
        summary = self.frame_timer.summary()
        if summary.get("frames", 0) > 1:
            self.log.info(
                "Frame stats: {fps:.2f} FPS, {frame_ms_mean:.1f} ms mean, "
                "p50 {frame_ms_p50:.1f} / p99 {frame_ms_p99:.1f} ms over "
                "{frames} frames".format(**summary)
            )
        events = counters.snapshot()
        if events:
            self.log.info(f"Counters: {events}")
