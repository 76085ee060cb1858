"""Runtime configuration.

Immutable replacement for the reference's single mutable struct
(``RenderingSettings.h:5-22``) that is passed by value into every CUDA
kernel, plus the technique enum (``SamplingTechniqueEnum.h:4-17``).

Here the settings are a frozen dataclass: all fields that change compiled
code (technique, bounce count, sample count, ReSTIR toggles) are static —
changing them triggers a re-``jit`` — while per-frame scalars (frame index,
seed) travel as traced arguments.
"""

from __future__ import annotations

import dataclasses
import enum


class SamplingTechnique(enum.IntEnum):
    """The nine techniques benchmarked by the framework.

    Mirrors SamplingTechniqueEnum.h:4-17 in the reference.
    """

    BRUTE_FORCE = 0
    UNIFORM = 1
    COSINE = 2
    GGX = 3
    BRDF = 4
    LIGHT_SOURCE = 5
    NEE_MIS = 6
    RESTIR_DI = 7
    RESTIR_GI = 8


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Static render configuration (hashable; usable as a jit static arg).

    Field semantics follow RenderingSettings.h:5-22:
      * ``accumulate``        — average over frames (toAccumulate)
      * ``bounces``           — path depth (lightBounces)
      * ``samples``           — paths per pixel per frame (sampleCount)
      * ``sky_color``         — miss radiance (skyColor)
      * ``technique``         — which integrator runs
      * ``light_candidates``  — ReSTIR DI M candidates (lightCandidateCount)
      * ``temporal_reuse`` / ``spatial_reuse`` — ReSTIR toggles
      * ``temporal_history_limit`` — history clamp factor (default 2)
      * ``spatial_neighbors`` / ``spatial_radius`` — spatial reuse params
    """

    technique: SamplingTechnique = SamplingTechnique.COSINE
    accumulate: bool = True
    bounces: int = 2
    samples: int = 1
    sky_color: tuple[float, float, float] = (0.0, 0.0, 0.0)
    # ReSTIR
    light_candidates: int = 8
    temporal_reuse: bool = True
    spatial_reuse: bool = True
    temporal_history_limit: int = 2
    spatial_neighbors: int = 5
    spatial_radius: int = 30
    # tracer: 'auto' picks the dense O(B·T) trace for small scenes (the
    # Triton kernel on CUDA, XLA elsewhere) and the stackless BVH walk for
    # large ones (ops/dense.py::pick_tracer); 'pallas' | 'dense' | 'bvh'
    # force one
    tracer: str = "auto"

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)
