"""Frame timing and FPS accounting.

The reference exposes only DeltaTime; FPS is the north-star metric of this
renderer (SURVEY.md §5.1), so a small windowed frame timer is first-class.
"""

from __future__ import annotations

import time
from collections import deque


class FrameTimer:
    """Sliding-window FPS / frame-ms counter."""

    def __init__(self, window: int = 120) -> None:
        self._stamps: deque[float] = deque(maxlen=window + 1)

    def tick(self) -> None:
        self._stamps.append(time.monotonic())

    @property
    def frame_ms(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return 1000.0 * span / (len(self._stamps) - 1)

    @property
    def fps(self) -> float:
        ms = self.frame_ms
        return 1000.0 / ms if ms > 0.0 else 0.0

    def summary(self) -> dict:
        """Windowed stats incl. tail latency (p50/p99 frame ms)."""
        if len(self._stamps) < 2:
            return {"frames": len(self._stamps), "fps": 0.0}
        import numpy as np

        stamps = np.asarray(self._stamps)
        dts = np.diff(stamps)
        return {
            "frames": len(self._stamps),
            "fps": float(1.0 / dts.mean()),
            "frame_ms_mean": float(dts.mean() * 1e3),
            "frame_ms_p50": float(np.percentile(dts, 50) * 1e3),
            "frame_ms_p99": float(np.percentile(dts, 99) * 1e3),
        }
