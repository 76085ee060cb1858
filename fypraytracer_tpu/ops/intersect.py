"""Ray–AABB and ray–triangle intersection, vectorized over ray batches.

Backend-generic (numpy / jax.numpy): the same code runs in the CPU oracle's
linear intersector and inside the jitted traversal loop.

Semantics match the reference device code:
  * slab test — BVH.cuh:124-165
  * Möller–Trumbore with hit epsilon ``t > 1e-4`` — Renderer.cu:508-537
    (the degenerate-triangle check the reference comments out at :518 is
    kept OFF for parity; padded/degenerate triangles report no hit via the
    determinant guard).
"""

from __future__ import annotations

from fypraytracer_tpu.core.mathutils import _xp, cross3, dot3

T_EPSILON = 1.0e-4   # Renderer.cu:531
DET_EPSILON = 1.0e-12


def ray_aabb(origin, inv_dir, lo, hi, t_best):
    """Slab test (BVH.cuh:124-165).

    Shapes: origin/inv_dir (..., 3); lo/hi broadcastable to (..., 3);
    t_best (...,). Returns hit mask (...,). A box behind the ray or farther
    than the current best hit misses.
    """
    xp = _xp(origin)
    t0 = (lo - origin) * inv_dir
    t1 = (hi - origin) * inv_dir
    tmin = xp.minimum(t0, t1).max(axis=-1)
    tmax = xp.maximum(t0, t1).min(axis=-1)
    return (tmax >= xp.maximum(tmin, 0.0)) & (tmin < t_best)


def moller_trumbore(origin, direction, p0, p1, p2):
    """Möller–Trumbore (Renderer.cu:508-537).

    Shapes: all (..., 3), broadcastable.  Returns ``(t, u, v, hit)`` where
    ``hit`` enforces 0<=u, 0<=v, u+v<=1, t > T_EPSILON and a non-degenerate
    determinant.
    """
    xp = _xp(origin)
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = cross3(direction, e2)
    det = dot3(e1, pvec, keepdims=False)
    valid_det = xp.abs(det) > DET_EPSILON
    inv_det = 1.0 / xp.where(valid_det, det, 1.0)
    tvec = origin - p0
    u = dot3(tvec, pvec, keepdims=False) * inv_det
    qvec = cross3(tvec, e1)
    v = dot3(direction, qvec, keepdims=False) * inv_det
    t = dot3(e2, qvec, keepdims=False) * inv_det
    hit = valid_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_EPSILON)
    return t, u, v, hit
