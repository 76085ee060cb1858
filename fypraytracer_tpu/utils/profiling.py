"""Profiling & observability.

The reference only has wall-clock frame timing with a running average
(Walnut::Timer around Renderer::Render, WalnutApp.cpp:880-897, average at
:782-785) and no device-side profiling (SURVEY.md §5).  Here:

  * ``FrameTimer`` — the same running-average protocol;
  * ``RaysCounter`` — rays/s accounting (BASELINE.md metric);
  * ``device_trace`` — jax profiler capture producing a TensorBoard /
    Perfetto trace of the actual device timeline;
  * ``log_event`` — structured JSONL logging (the reference logs by
    encoding metadata into output filenames).
"""

from __future__ import annotations

import contextlib
import json
import time


class FrameTimer:
    """Per-frame wall time + running average (WalnutApp.cpp:782-785)."""

    def __init__(self):
        self.total_s = 0.0
        self.frames = 0
        self.last_ms = 0.0

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.last_ms = dt * 1000.0
        self.total_s += dt
        self.frames += 1

    @property
    def avg_ms(self) -> float:
        return (self.total_s / self.frames * 1000.0) if self.frames else 0.0

    @property
    def total_minutes(self) -> float:
        return self.total_s / 60.0


class RaysCounter:
    """Accumulates traced-ray counts; reports rays/s."""

    def __init__(self):
        self.rays = 0

    def add_frame(self, width: int, height: int, samples: int, bounces: int,
                  shadow_rays_per_bounce: int = 0):
        self.rays += width * height * samples * (
            1 + bounces * (1 + shadow_rays_per_bounce))

    def rays_per_second(self, elapsed_s: float) -> float:
        return self.rays / max(elapsed_s, 1e-12)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a device profile (view with TensorBoard or Perfetto)."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def log_event(path: str, **fields) -> None:
    """Append one structured JSONL record."""
    fields.setdefault("ts", time.time())
    with open(path, "a") as f:
        f.write(json.dumps(fields, default=str) + "\n")
