"""User-facing Scene: device state + camera + compiled frame function.

Reference parity: vktf::Scene (src/engine/scene.cppm:39-139) combines N glTF
assets, owns the active camera (initial position (0,1,0), direction +x, 45°
vertical FoV — scene.cppm:159-169), and exposes per-frame Update/Render.
Here Update+Render collapse into one jitted ``frame_step`` whose
compilation is keyed on the static scene shape (the analogue of the
per-scene pipeline + light-count specialization constant,
scene.cppm:269-277, graphics_pipeline.cppm:148-155).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from vktf.config import RenderConfig
from vktf.loaders.gltf import Asset
from vktf.log import Log, default_log
from vktf.mathx import Camera, ViewFrustumParams
from vktf.scene.flatten import flatten_assets


class Scene:
    def __init__(
        self,
        assets: Sequence[Asset],
        config: RenderConfig,
        log: Optional[Log] = None,
        camera: Optional[Camera] = None,
        mesh=None,
    ):
        """``mesh``: an optional ``jax.sharding.Mesh`` with axes (gp, sp) —
        the frame function then runs the multi-chip sharded path
        (vktf.parallel) instead of the single-chip program. Same
        signature, same pixels (bit-equal, tests/test_parallel.py)."""
        log = log or default_log()
        self.config = config
        self.render_scene, self.meta, self.aux = flatten_assets(assets, log)
        # camera defaults from the reference (scene.cppm:159-169)
        self.camera = camera or Camera(
            position=(0.0, 1.0, 0.0),
            direction=(1.0, 0.0, 0.0),
            view_frustum=ViewFrustumParams(
                field_of_view_y=np.radians(45.0),
                aspect_ratio=config.width / config.height,
                z_near=0.1,
                z_far=1.0e6,
            ),
        )
        if mesh is not None:
            from vktf.parallel import make_sharded_frame_fn

            self._frame_fn = make_sharded_frame_fn(self.meta, config, mesh)
        else:
            # shared program registry: same scene shape + config reuses the
            # compiled frame function (vktf.runtime.cache)
            from vktf.runtime import frame_program

            self._frame_fn = frame_program(self.meta, config)
        log.info(
            f"Scene ready: {self.meta.num_triangles} tris, "
            f"{self.meta.num_vertices} verts, {self.meta.num_instances} instances, "
            f"{self.meta.num_lights} lights"
        )

    @property
    def light_count(self) -> int:
        return self.meta.num_lights

    def render_async(self):
        """Dispatch one frame; returns the device array WITHOUT blocking —
        XLA async dispatch provides the frames-in-flight overlap."""
        return self._frame_fn(
            self.render_scene,
            self.camera.view_projection_transform,
            self.camera.position,
        )

    def render_still(self) -> np.ndarray:
        """EXACT full-resolution (3, H, W) uint8 frame at the current
        camera, regardless of the present encoding (preview scale /
        yuv420). The preview stream trades present bytes for rate
        (config.present_scale); stills bypass it — same pixels as a
        present_format="rgb", present_scale=1 render, test-pinned
        (tests/test_present.py). Uses the shared program registry, so the
        still program compiles once per (scene shape, config)."""
        if (self.config.present_format == "rgb"
                and self.config.present_scale == 1):
            fn = self._frame_fn
        else:
            if getattr(self, "_still_fn", None) is None:
                from vktf.runtime import frame_program

                exact = self.config.replace(present_format="rgb",
                                            present_scale=1)
                self._still_fn = frame_program(self.meta, exact)
            fn = self._still_fn
        return np.asarray(fn(
            self.render_scene,
            self.camera.view_projection_transform,
            self.camera.position,
        ))

    def binning_diagnostics(self) -> dict:
        """Dropped-triangle diagnostics for the current camera.

        The tiled/dense backends bin into fixed-capacity per-tile lists;
        overflow silently drops triangles, so this surfaces it per the
        skip-and-log policy (SURVEY.md §5.3). The pallas backend streams
        every triangle (no capacities) and always reports zero drops.
        """
        if self.config.resolved_backend() != "tiled":
            return {"dropped_pairs": 0, "dropped_large": 0}
        import jax

        from vktf.ops.binning import binning_overflow
        from vktf.ops.pipeline import prepare_frame

        def check(scene, vp, pos):
            _setup, bins, _lights, _world, _inst = prepare_frame(
                scene, vp, pos, meta=self.meta, config=self.config
            )
            return binning_overflow(
                bins, self.config.bin_capacity, self.config.large_capacity
            )

        dropped, dropped_large = jax.jit(check)(
            self.render_scene,
            self.camera.view_projection_transform,
            self.camera.position,
        )
        return {
            "dropped_pairs": int(dropped),
            "dropped_large": int(dropped_large),
        }
