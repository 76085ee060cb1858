"""CPU oracle renderer — golden images for every later stage.

The reference has no tests (SURVEY.md §4); this oracle substitutes for
them.  It renders with a *linear* (no-BVH) brute-force intersector in
NumPy, so a BVH / traversal / jit bug on the device path cannot also hide
here: the accelerated path must match this one at identical seeds
(``tests/test_parity.py``), and the shared estimator math is pinned by
analytic sampler tests.

Linear intersection = test every ray against every triangle and keep the
closest t > 1e-4 hit, exactly what the BVH path must reproduce.
"""

from __future__ import annotations

import numpy as np

from fypraytracer_tpu.core.camera import Camera, generate_rays
from fypraytracer_tpu.ops.intersect import moller_trumbore
from fypraytracer_tpu.render.integrators import (
    radiance_hemisphere,
    radiance_light_source,
    radiance_nee_mis,
)
from fypraytracer_tpu.scene.types import Geometry, Scene


def make_linear_trace(geometry: Geometry, chunk: int = 4096):
    """Brute-force closest-hit tracer: (B,3),(B,3) -> (B,) tri id or -1."""
    p0 = geometry.positions[geometry.tri_v[:, 0]]
    p1 = geometry.positions[geometry.tri_v[:, 1]]
    p2 = geometry.positions[geometry.tri_v[:, 2]]

    def trace(origins: np.ndarray, directions: np.ndarray) -> np.ndarray:
        out = np.full(origins.shape[0], -1, np.int32)
        for s in range(0, origins.shape[0], chunk):
            o = origins[s:s + chunk, None, :]
            d = directions[s:s + chunk, None, :]
            t, _, _, hit = moller_trumbore(o, d, p0[None], p1[None], p2[None])
            t = np.where(hit, t, np.inf)
            best = np.argmin(t, axis=1)
            rows = np.arange(t.shape[0])
            found = np.isfinite(t[rows, best])
            out[s:s + chunk] = np.where(found, best.astype(np.int32), -1)
        return out

    return trace


def render_oracle(scene: Scene, camera: Camera, settings, frame: int,
                  state=None) -> np.ndarray:
    """One frame of HDR radiance, (H, W, 3) float32, pure NumPy.

    For ReSTIR techniques (7/8) pass ``state`` (or None for frame-1
    reservoirs) — or use ``render_oracle_restir`` for a stateful
    multi-frame run.  The ReSTIR modules are backend-generic, so the
    oracle drives the *same* estimator code as the jitted path but with
    the linear NumPy intersector — seed-matched parity pins tracer and
    jit behavior, not just statistics."""
    origins, directions = generate_rays(camera.inv_projection, camera.inv_view,
                                        camera.width, camera.height, xp=np)
    origins = origins.astype(np.float32)
    directions = directions.astype(np.float32)
    trace = make_linear_trace(scene.geometry)
    pixel_ids = np.arange(camera.width * camera.height, dtype=np.uint32)
    f = np.uint32(frame)
    t = int(settings.technique)
    if t <= 4:
        sampler = {0: "brute", 1: "uniform", 2: "cosine", 3: "ggx", 4: "brdf"}[t]
        hdr = radiance_hemisphere(scene, trace, origins, directions, pixel_ids,
                                  f, settings, sampler)
    elif t == 5:
        hdr = radiance_light_source(scene, trace, origins, directions,
                                    pixel_ids, f, settings)
    elif t == 6:
        hdr = radiance_nee_mis(scene, trace, origins, directions, pixel_ids,
                               f, settings)
    elif t in (7, 8):
        hdr, _ = _restir_frame(scene, trace, origins, directions, pixel_ids,
                               f, settings, state, camera)
    else:
        raise NotImplementedError(f"oracle for technique {t} pending")
    return np.asarray(hdr, np.float32).reshape(camera.height, camera.width, 3)


def _restir_frame(scene, trace, origins, directions, pixel_ids, f, settings,
                  state, camera):
    from fypraytracer_tpu.render import restir_di, restir_gi

    mod = restir_di if int(settings.technique) == 7 else restir_gi
    n = camera.width * camera.height
    if state is None:
        state = mod.init_state(n)
    fn = (restir_di.render_restir_di if int(settings.technique) == 7
          else restir_gi.render_restir_gi)
    return fn(scene, trace, origins, directions, pixel_ids, f, settings,
              state, camera.width, camera.height,
              np.asarray(camera.prev_proj_view, np.float32))


def render_oracle_restir(scene: Scene, camera: Camera, settings,
                         frames: int) -> np.ndarray:
    """Averaged ReSTIR render over ``frames`` frames with persistent
    reservoir state (the stateful loop of Renderer.render_hdr), pure
    NumPy + linear intersector."""
    origins, directions = generate_rays(camera.inv_projection, camera.inv_view,
                                        camera.width, camera.height, xp=np)
    origins = origins.astype(np.float32)
    directions = directions.astype(np.float32)
    trace = make_linear_trace(scene.geometry)
    pixel_ids = np.arange(camera.width * camera.height, dtype=np.uint32)
    state = None
    acc = np.zeros((camera.height, camera.width, 3), np.float32)
    for f in range(1, frames + 1):
        hdr, state = _restir_frame(scene, trace, origins, directions,
                                   pixel_ids, np.uint32(f), settings, state,
                                   camera)
        acc += np.asarray(hdr, np.float32).reshape(acc.shape)
    return acc / frames


def accumulate_oracle(scene: Scene, camera: Camera, settings, frames: int) -> np.ndarray:
    """Average ``frames`` frames (accumulation oracle, Renderer.cu:2453-2456)."""
    acc = np.zeros((camera.height, camera.width, 3), np.float32)
    for f in range(1, frames + 1):
        acc += render_oracle(scene, camera, settings, f)
    return acc / frames
