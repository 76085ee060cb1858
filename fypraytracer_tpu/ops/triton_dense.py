"""Pallas-Triton kernel: dense ray×triangle closest hit, fused on the GPU.

The XLA version (ops/dense.py) writes two ``(C, 3T)`` f32 products to
device memory per ray chunk and reads them back for the hit test.  Here
one program owns a power-of-two block of rays and loops over triangle
tiles inside the kernel, so device memory sees rays in and hits out and
nothing in between.  The running closest hit ``(t, tri, u, v)`` stays in
registers; ``num_stages`` pipelines the triangle-tile loads.

The affine Baldwin–Weber rows (see ops/dense.py) are applied as explicit
f32 multiply-adds, not ``pl.dot``: with K = 4 the products cannot feed the
tensor cores, and plain FMAs keep full f32 precision (no TF32).

Semantics are those of ``trace_rays_dense``: same hit test, lowest
triangle index wins ties, ``tri = -1`` / ``t = -1`` / ``u = v = 0`` on a
miss, zero (padding or degenerate) triangle rows never hit, optional
per-ray ``t_max``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from fypraytracer_tpu.ops.intersect import T_EPSILON
from fypraytracer_tpu.scene.types import Geometry

_BIG = 3.0e38          # python floats: jnp scalars would be captured consts
_NO_TRI = 2 ** 30

# block sizes measured on an H100 (PERF.md): (64, 16) and (32, 32)
# are fastest; tiles of 64 triangles or blocks of 128 rays spill registers
RAY_BLOCK = 64         # rays per program (power of two)
TRI_TILE = 16          # triangles per loop step (power of two)
NUM_WARPS = 4
NUM_STAGES = 2


def _closest_hit_kernel(rays_ref, tris_ref, t_ref, tri_ref, u_ref, v_ref, *,
                        n_tiles: int, tri_tile: int):
    ox, oy, oz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]   # (R,)
    dx, dy, dz = rays_ref[3, :], rays_ref[4, :], rays_ref[5, :]
    tmax = rays_ref[6, :]
    col = jax.lax.broadcasted_iota(jnp.int32, (1, tri_tile), 1)

    def affine(row0, base, px, py, pz, point):
        # (R, Tt) = p · row[:3] (+ row[3] for a point), as f32 FMAs
        r = [tris_ref[row0 + i, pl.ds(base, tri_tile)][None, :]
             for i in range(4 if point else 3)]
        out = px[:, None] * r[0] + py[:, None] * r[1] + pz[:, None] * r[2]
        return out + r[3] if point else out

    def body(j, carry):
        t_run, tri_run, u_run, v_run = carry
        base = pl.multiple_of(j * tri_tile, tri_tile)
        o_n = affine(0, base, ox, oy, oz, True)
        d_n = affine(0, base, dx, dy, dz, False)
        o_u = affine(4, base, ox, oy, oz, True)
        d_u = affine(4, base, dx, dy, dz, False)
        o_v = affine(8, base, ox, oy, oz, True)
        d_v = affine(8, base, dx, dy, dz, False)

        parallel_ok = jnp.abs(d_n) > 1e-12
        t = -o_n / jnp.where(parallel_ok, d_n, 1.0)
        u = o_u + t * d_u
        v = o_v + t * d_v
        hit = parallel_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) \
            & (t > T_EPSILON) & (t < tmax[:, None])
        t = jnp.where(hit, t, _BIG)

        t_min = jnp.min(t, axis=1)                               # (R,)
        best = t == t_min[:, None]
        k = jnp.min(jnp.where(best, col, _NO_TRI), axis=1)       # first min
        first = col == k[:, None]
        u_best = jnp.sum(jnp.where(first, u, 0.0), axis=1)
        v_best = jnp.sum(jnp.where(first, v, 0.0), axis=1)

        # strict '<': an earlier tile keeps a tie (lowest index wins)
        closer = t_min < t_run
        return (jnp.where(closer, t_min, t_run),
                jnp.where(closer, base + k, tri_run),
                jnp.where(closer, u_best, u_run),
                jnp.where(closer, v_best, v_run))

    n_rays = ox.shape[0]
    init = (jnp.full((n_rays,), _BIG, jnp.float32),
            jnp.full((n_rays,), -1, jnp.int32),
            jnp.zeros((n_rays,), jnp.float32),
            jnp.zeros((n_rays,), jnp.float32))
    t_run, tri_run, u_run, v_run = jax.lax.fori_loop(0, n_tiles, body, init)
    t_ref[...] = t_run
    tri_ref[...] = tri_run
    u_ref[...] = u_run
    v_ref[...] = v_run


@functools.partial(jax.jit, static_argnames=("ray_block", "tri_tile",
                                             "num_warps", "num_stages",
                                             "interpret"))
def _closest_hit(rays, tris, *, ray_block, tri_tile, num_warps, num_stages,
                 interpret):
    n_pad = rays.shape[1]
    n_tiles = tris.shape[1] // tri_tile
    ray_spec = pl.BlockSpec((8, ray_block), lambda i: (0, i))
    out_spec = pl.BlockSpec((ray_block,), lambda i: (i,))
    kernel = functools.partial(_closest_hit_kernel, n_tiles=n_tiles,
                               tri_tile=tri_tile)
    return pl.pallas_call(
        kernel,
        grid=(n_pad // ray_block,),
        in_specs=[ray_spec, pl.no_block_spec],
        out_specs=[out_spec] * 4,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.float32)],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        interpret=interpret,
        name="dense_closest_hit",
    )(rays, tris)


def triangle_rows(geometry: Geometry, tri_tile: int = TRI_TILE):
    """(16, T_pad) f32: rows 0-3 plane, 4-7 barycentric-u, 8-11
    barycentric-v (homogeneous affine rows), 12-15 zero.  Degenerate and
    padding triangles get all-zero rows, so ``d_n == 0`` and they never
    hit."""
    tv = geometry.tri_v
    pos = jax.lax.stop_gradient(geometry.positions)
    p0 = pos[tv[:, 0]]
    e1 = pos[tv[:, 1]] - p0
    e2 = pos[tv[:, 2]] - p0
    n = jnp.cross(e1, e2)
    denom = (n * n).sum(-1)
    valid = denom > 1e-18
    inv_denom = 1.0 / jnp.where(valid, denom, 1.0)
    n = jnp.where(valid[:, None], n, 0.0)
    u3 = jnp.cross(e2, n) * inv_denom[:, None]
    v3 = jnp.cross(n, e1) * inv_denom[:, None]

    def hom(w):
        return jnp.concatenate([w, -(w * p0).sum(-1, keepdims=True)], axis=-1)

    rows = jnp.concatenate([hom(n), hom(u3), hom(v3),
                            jnp.zeros_like(hom(n))], axis=-1).T   # (16, T)
    pad_t = (-rows.shape[1]) % tri_tile
    return jnp.pad(rows, ((0, 0), (0, pad_t)))


def trace_rays_triton(geometry: Geometry, origins, directions, t_max=None, *,
                      ray_block: int = RAY_BLOCK, tri_tile: int = TRI_TILE,
                      num_warps: int = NUM_WARPS,
                      num_stages: int = NUM_STAGES, interpret: bool = False):
    """Same contract as ``ops.dense.trace_rays_dense``, one fused kernel.

    ``interpret`` runs the kernel through the Pallas interpreter (for the
    CPU tests); compiled, it runs only on a CUDA device."""
    origins = jax.lax.stop_gradient(origins).astype(jnp.float32)
    directions = jax.lax.stop_gradient(directions).astype(jnp.float32)
    n = origins.shape[0]
    tmax = (jnp.full((n,), _BIG, jnp.float32) if t_max is None
            else jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), (n,)))
    rays = jnp.concatenate([origins.T, directions.T, tmax[None, :],
                            jnp.zeros((1, n), jnp.float32)], axis=0)  # (8, B)
    pad_b = (-n) % ray_block
    # padded rays: zero direction -> parallel to every plane -> miss
    rays = jnp.pad(rays, ((0, 0), (0, pad_b)))

    t, tri, u, v = _closest_hit(
        rays, triangle_rows(geometry, tri_tile), ray_block=ray_block,
        tri_tile=tri_tile, num_warps=num_warps, num_stages=num_stages,
        interpret=interpret)
    t, tri, u, v = t[:n], tri[:n], u[:n], v[:n]
    return dict(tri=tri, t=jnp.where(tri < 0, -1.0, t), u=u, v=v)
