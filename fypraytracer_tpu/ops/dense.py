"""Dense ray×triangle intersection — the small-scene tracer.

The threaded-BVH walk (ops/traverse.py) is a ``while_loop`` whose every
step is a round of gathers for the whole ray batch, and the loop runs
until the slowest ray finishes.  For small-to-medium scenes a *dense*
formulation does better on a wide machine: test every ray against every
triangle as fused ``(B, T)`` element-wise math plus a min-reduction — no
gathers and no data-dependent control flow.  This mirrors how the
wavefront design brief calls for masked lanes instead of divergence
(SURVEY.md §7): here the "mask" is the full intersection matrix.

Crossover: the O(B·T) work beats the O(B·depth) walk up to a triangle
count measured on the card (``DENSE_MAX_TRIS``, PERF.md); ``pick_tracer``
selects by triangle count and platform.  On a CUDA device the dense trace
is the fused Pallas-Triton kernel (ops/triton_dense.py); elsewhere it is
the XLA formulation below.

Semantics identical to TraceRay: Möller–Trumbore, t > 1e-4, closest hit,
miss sentinel -1 (Renderer.cu:460-561).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fypraytracer_tpu.ops.intersect import T_EPSILON
from fypraytracer_tpu.scene.types import Geometry

_BIG = jnp.float32(3.0e38)

# auto-tracer crossover (triangles), measured on an H100 with the Triton
# kernel against the BVH walk on 1080p primary + bounce rays (PERF.md):
# the kernel wins by 35 % at 8k and 18 % at 12k triangles, ties at
# 16k, and loses from 20k on
DENSE_MAX_TRIS = 16384


def trace_rays_dense(geometry: Geometry, origins, directions, t_max=None,
                     ray_chunk: int = 8192):
    """Closest-hit over all triangles, densely vectorized via matmuls.

    Baldwin–Weber formulation: per triangle, precompute affine rows such
    that ``t``/``u``/``v`` are affine in the homogeneous ray origin and
    direction.  Intersecting a ray chunk against all triangles is then two
    ``(C, 4) @ (4, 3T)`` matrix products plus ~a dozen element-wise
    ops and a min-reduction — versus ~120 elementwise ops/pair for
    broadcast Möller–Trumbore.  Numerically equivalent hit classification
    (plane + barycentric tests); degenerate triangles masked at precompute
    (the reference comments its degenerate check out, Renderer.cu:518 —
    here padding/degenerates are excluded exactly).

    Same contract as ops.traverse.trace_rays: returns dict with ``tri``
    (B,) i32 (-1 miss), ``t`` (-1 sentinel on miss), ``u``, ``v`` (0 on a
    miss); the lowest triangle index wins a tie.
    Rays are processed in chunks of ``ray_chunk`` via ``lax.map`` to bound
    the (chunk, T) working set.
    """
    origins = jax.lax.stop_gradient(origins)
    directions = jax.lax.stop_gradient(directions)

    tv = geometry.tri_v
    p0 = geometry.positions[tv[:, 0]]          # (T, 3)
    e1 = geometry.positions[tv[:, 1]] - p0
    e2 = geometry.positions[tv[:, 2]] - p0

    B = origins.shape[0]
    T = tv.shape[0]

    # --- per-triangle affine rows (computed once per trace; ~40 flops/tri)
    n = jnp.cross(e1, e2)                       # unnormalized normal
    denom = (n * n).sum(-1)                     # |n|^2
    valid_tri = denom > 1e-18
    inv_denom = 1.0 / jnp.where(valid_tri, denom, 1.0)
    u3 = jnp.cross(e2, n) * inv_denom[:, None]  # barycentric-u row
    v3 = jnp.cross(n, e1) * inv_denom[:, None]  # barycentric-v row
    # homogeneous 4th component folds the constant term in
    w_n = jnp.concatenate([n, -(n * p0).sum(-1, keepdims=True)], axis=-1)
    w_u = jnp.concatenate([u3, -(u3 * p0).sum(-1, keepdims=True)], axis=-1)
    w_v = jnp.concatenate([v3, -(v3 * p0).sum(-1, keepdims=True)], axis=-1)
    W = jnp.concatenate([w_n, w_u, w_v], axis=0).T    # (4, 3T)

    def chunk_fn(args):
        o, d, tmax_c = args                    # (C, 3), (C, 3), (C,)
        C = o.shape[0]
        o4 = jnp.concatenate([o, jnp.ones((C, 1), o.dtype)], axis=-1)
        d4 = jnp.concatenate([d, jnp.zeros((C, 1), d.dtype)], axis=-1)
        # full f32: TF32 operands would flip hit classification and the
        # t > 1e-4 self-intersection test on thin or grazing triangles
        O = jnp.dot(o4, W, precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)        # (C, 3T)
        D = jnp.dot(d4, W, precision=jax.lax.Precision.HIGHEST,
                    preferred_element_type=jnp.float32)
        o_n, o_u, o_v = O[:, :T], O[:, T:2 * T], O[:, 2 * T:]
        d_n, d_u, d_v = D[:, :T], D[:, T:2 * T], D[:, 2 * T:]

        parallel_ok = jnp.abs(d_n) > 1e-12
        t = -o_n / jnp.where(parallel_ok, d_n, 1.0)
        u = o_u + t * d_u
        v = o_v + t * d_v
        hit = valid_tri[None, :] & parallel_ok & (u >= 0.0) & (v >= 0.0) \
            & (u + v <= 1.0) & (t > T_EPSILON) & (t < tmax_c[:, None])
        t = jnp.where(hit, t, _BIG)
        k = jnp.argmin(t, axis=1)                            # (C,)
        rows = jnp.arange(C)
        t_best = t[rows, k]
        found = t_best < _BIG
        return (jnp.where(found, k.astype(jnp.int32), -1),
                jnp.where(found, t_best, -1.0),
                jnp.where(found, u[rows, k], 0.0),
                jnp.where(found, v[rows, k], 0.0))

    tmax = (origins[:, 0] * 0.0 + _BIG) if t_max is None else jnp.asarray(t_max, jnp.float32)

    if B <= ray_chunk:
        tri, t, u, v = chunk_fn((origins, directions, tmax))
    else:
        # pad B to a multiple of the chunk so lax.map sees static shapes
        pad = (-B) % ray_chunk
        o = jnp.pad(origins, ((0, pad), (0, 0)))
        d = jnp.pad(directions, ((0, pad), (0, 0)), constant_values=1.0)
        tm = jnp.pad(tmax, (0, pad))
        n_chunks = (B + pad) // ray_chunk
        o = o.reshape(n_chunks, ray_chunk, 3)
        d = d.reshape(n_chunks, ray_chunk, 3)
        tm = tm.reshape(n_chunks, ray_chunk)
        tri, t, u, v = jax.lax.map(chunk_fn, (o, d, tm))
        tri = tri.reshape(-1)[:B]
        t = t.reshape(-1)[:B]
        u = u.reshape(-1)[:B]
        v = v.reshape(-1)[:B]

    return dict(tri=tri, t=t, u=u, v=v)


def pick_tracer(scene, force: str = "auto"):
    """Return a ``trace(o, d) -> tri`` closure.

    ``force``: 'auto' | 'pallas' | 'dense' | 'bvh'.  'auto' takes the
    dense trace for scenes of at most ``DENSE_MAX_TRIS`` triangles and the
    threaded-BVH walk above.  The dense trace is chosen per lowering
    platform (``lax.platform_dependent``): the fused Triton kernel on CUDA,
    the XLA formulation elsewhere — so one jitted renderer runs on the
    card and, for reference runs, on the host CPU in the same process.
    'pallas' demands the kernel and raises off a CUDA backend (there is no
    silent interpreter fallback; interpret mode is for tests).
    """
    from fypraytracer_tpu.ops.traverse import trace_rays

    def dense(o, d):
        return trace_rays_dense(scene.geometry, o, d)["tri"]

    def kernel(o, d):
        from fypraytracer_tpu.ops.triton_dense import trace_rays_triton

        return trace_rays_triton(scene.geometry, o, d)["tri"]

    def bvh(o, d):
        return trace_rays(scene.bvh, scene.geometry, o, d)["tri"]

    if force == "pallas":
        if jax.default_backend() != "gpu":
            raise ValueError(
                "tracer='pallas' needs a CUDA device for the Triton kernel; "
                f"the default backend is {jax.default_backend()!r}")
        return kernel
    if force == "dense":
        return dense
    if force == "bvh":
        return bvh
    if force != "auto":
        raise ValueError(f"unknown tracer {force!r}")
    if scene.geometry.tri_v.shape[0] > DENSE_MAX_TRIS:
        return bvh

    def auto(o, d):
        # hit ids carry no gradient: keep the platform switch out of AD
        o, d = jax.lax.stop_gradient(o), jax.lax.stop_gradient(d)
        return jax.lax.platform_dependent(o, d, cuda=kernel, default=dense)
    return auto
