"""fypraytracer_tpu — a differentiable path-tracing framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of the reference
CUDA path tracer (Savasstion/FYPRayTracer): nine ray-tracing sampling
techniques (brute force, uniform / cosine hemisphere, GGX, combined BRDF,
light-tree light sampling, NEE+MIS, ReSTIR DI, ReSTIR GI) benchmarked
against each other on shared scenes — plus differentiability, multi-chip
sharding, and a headless benchmark harness the reference lacks.

Architecture (a redesign, not a port):
  * SoA everywhere — the scene is a pytree of dense ``jnp`` arrays.
  * Wavefront integrators — ray batches processed by vectorized stages
    under ``jit``; bounce loops are ``lax`` control flow with masked lanes
    (replaces CUDA per-thread megakernel divergence).
  * Stackless threaded BVH — preorder flat node array with hit/miss skip
    links so traversal is a single ``while_loop`` over gathers (replaces
    the reference's per-thread 256/1024-entry stacks, Renderer.cu:472-477).
  * Counter-based PCG RNG keyed by (pixel, frame, sample) for exact
    oracle parity (replaces the order-dependent seed discipline at
    Renderer.cu:577-578).
  * Multi-chip via ``shard_map`` over pixel tiles on a ``jax.sharding.Mesh``;
    scene replicated, image tiles sharded.
"""

__version__ = "0.1.0"

from fypraytracer_tpu.config import RenderSettings, SamplingTechnique  # noqa: F401
