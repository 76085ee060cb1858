"""Counter-based PCG random number generation.

The reference uses a *stateful* per-thread PCG stream seeded with
``(x + y*W) * frameIndex`` (Renderer.cu:577-578) and mutated on every draw
(MathUtils.cuh:47-59).  That discipline is order-dependent and aliases when
``frameIndex`` multiples collide, so — per SURVEY.md §7 — we replace it with
a *counter-based* scheme: a path key derived by hashing
``(pixel, frame, sample, stream)`` through the same PCG output permutation,
after which draws inside a path advance the key functionally.

Every function here is written against the NumPy array API surface that
``numpy`` and ``jax.numpy`` share (``*``, ``^``, ``>>``, ``astype``), so the
CPU oracle and the jitted device path consume **bit-identical** uniform streams —
the foundation of the seed-matched allclose tests (SURVEY.md §4).

All state is uint32; wraparound arithmetic is exact in both backends.
"""

from __future__ import annotations

import numpy as np

# PCG-RXS-M-XS-32 constants, same family as MathUtils.cuh:47-52.
_MUL1 = np.uint32(747796405)
_INC = np.uint32(2891336453)
_MUL2 = np.uint32(277803737)
# Weyl-style stream separators for key folding.
_GOLDEN = np.uint32(0x9E3779B9)

# Uniform convention: top 24 bits scaled by 2^-24 — exactly representable
# in float32 (its mantissa width), u ∈ [0, 1).  Deviation from the
# reference's ``(float)seed / (float)UINT32_MAX`` (MathUtils.cuh:58, which
# can yield exactly 1.0): a 24-bit integer is exact in float32, so the
# stream is reproducible in any kernel that has only int32→f32 casts.
_INV_24 = np.float32(1.0) / np.float32(16777216.0)


def pcg_hash(x):
    """PCG output permutation: uint32 -> uint32 (MathUtils.cuh:47-52)."""
    with np.errstate(over="ignore"):
        state = x * _MUL1 + _INC
        word = ((state >> ((state >> np.uint32(28)) + np.uint32(4))) ^ state) * _MUL2
        return (word >> np.uint32(22)) ^ word


def fold(key, data):
    """Mix ``data`` into ``key`` (both uint32), order-sensitively."""
    with np.errstate(over="ignore"):
        return pcg_hash(key ^ (data * _GOLDEN + _INC))


def path_key(pixel_id, frame, sample, stream=0):
    """Derive the per-path RNG key from independent counters.

    ``pixel_id``/``frame``/``sample`` may be scalars or arrays (broadcast);
    ``stream`` separates logical draw streams (e.g. ReSTIR passes).
    """
    u32 = np.uint32
    k = pcg_hash(_as_u32(pixel_id))
    k = fold(k, _as_u32(frame))
    k = fold(k, _as_u32(sample))
    if not (np.isscalar(stream) and stream == 0):
        k = fold(k, _as_u32(stream))
    else:
        k = fold(k, u32(0))
    return k


def _as_u32(x):
    if hasattr(x, "astype"):
        return x.astype(np.uint32)
    return np.uint32(x)


def next_uniform(key):
    """Advance the key and return ``(new_key, u)`` with u in [0, 1).

    Mirrors the stateful ``randomFloat`` (MathUtils.cuh:54-59): the new key
    is ``pcg_hash(key)`` and the uniform is its top 24 bits × 2⁻²⁴ (see
    the _INV_24 note for why this differs from the reference's scaling).
    """
    new_key = pcg_hash(key)
    bits = (new_key >> np.uint32(8)).astype(np.int32)
    return new_key, bits.astype(np.float32) * _INV_24


def uniforms(key, n: int):
    """Draw ``n`` sequential uniforms; returns (new_key, list-of-arrays)."""
    us = []
    for _ in range(n):
        key, u = next_uniform(key)
        us.append(u)
    return key, us
