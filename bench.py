"""Benchmark harness — one JSON line.

Times the flagship configuration (Cornell box 256², NEE+MIS with the light
tree, 2 bounces, 1 spp) through ``Renderer.render_many`` on the default
JAX device and reports rays/second.  Protocol: one compile-and-warm
dispatch, then ``REPS`` dispatches of ``FRAMES`` frames each, each ended
by ``block_until_ready``; the reported frame time is the median dispatch
over ``FRAMES``.  rays/frame = W·H·samples·(1 primary + bounces·(1 shadow
+ 1 continuation)), as BASELINE.md defines it.

The line names the device (JAX platform, kind, count) and, on an NVIDIA
GPU, the card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np

WIDTH = HEIGHT = 256
BOUNCES = 2
SAMPLES = 1
FRAMES = 64
REPS = 7


def _card() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    import jax

    from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu.render.renderer import Renderer
    from fypraytracer_tpu.scene.procedural import cornell_box
    from fypraytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    builder, cam = cornell_box(width=WIDTH, height=HEIGHT)
    settings = RenderSettings(technique=SamplingTechnique.NEE_MIS,
                              bounces=BOUNCES, samples=SAMPLES,
                              sky_color=(0.05, 0.06, 0.08))
    r = Renderer(builder.compile(), cam, settings)

    jax.block_until_ready(r.render_many(FRAMES))      # compile + warm
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(r.render_many(FRAMES))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times)) / FRAMES

    rays_per_frame = WIDTH * HEIGHT * SAMPLES * (1 + BOUNCES * 2)
    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "rays_per_second",
        "value": rays_per_frame / dt,
        "unit": f"rays/s (cornell {WIDTH}x{HEIGHT}, NEE+MIS, {BOUNCES} "
                f"bounces, {SAMPLES} spp, render_many({FRAMES}), median of "
                f"{REPS} dispatches)",
        "frame_ms": dt * 1000.0,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": _card(),
    }))


if __name__ == "__main__":
    main()
