"""Stackless BVH traversal — the large-scene tracer.

Replaces the reference's per-thread TLAS→BLAS stack traversal
(``RendererGPU::TraceRay``, Renderer.cu:460-561) with a vectorized
threaded-BVH walk: every ray carries a single current-node index; on AABB
hit at an inner node it advances to ``i+1`` (preorder fall-through), on
miss or after a leaf it jumps to the precomputed skip link.  One
``lax.while_loop`` over whole ray batches, all memory traffic as gathers —
no stacks, no divergence, static shapes.

Leaf handling: each leaf owns exactly ``leaf_size`` aligned primitive
slots (padded with -1), so leaf intersection is a fixed-shape
Möller–Trumbore over (B, leaf_size) lanes with a mask.

Differentiability: the loop returns discrete results (triangle id) plus
detached t/u/v; ``closest_hit`` recomputes hit attributes differentiably
from the selected triangle (hit *ids* detached, attributes attached —
SURVEY.md §7 design principle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from fypraytracer_tpu.ops.intersect import moller_trumbore, ray_aabb
from fypraytracer_tpu.scene.types import FlatBVH, Geometry

_BIG = 3.0e38  # python float: a module-level jnp array trips shard_map mesh checks


def trace_rays(bvh: FlatBVH, geometry: Geometry, origins, directions, t_max=None):
    """Closest-hit trace of a ray batch against the scene BVH.

    Args:
      origins, directions: (B, 3) f32 (directions need not be unit —
        matches the reference, which traces unnormalized camera dirs).
      t_max: optional (B,) upper bound (shadow rays).

    Returns dict with ``tri`` (B,) i32 (-1 = miss), ``t`` (B,) f32,
    ``u``/``v`` (B,) f32 barycentrics — all stop-gradiented.
    """
    n_nodes = bvh.lo.shape[0]
    leaf_size = bvh.leaf_size
    # accept host-built (numpy) structures: promote leaves to jnp once
    bvh = jax.tree_util.tree_map(jnp.asarray, bvh)
    geometry = jax.tree_util.tree_map(jnp.asarray, geometry)

    origins = jax.lax.stop_gradient(origins)
    directions = jax.lax.stop_gradient(directions)

    # Signed clamp away from zero so the slab test sees large finite values
    # instead of inf (0 * inf = NaN poisons the min/max reductions).
    d_safe = jnp.where(jnp.abs(directions) < 1e-20,
                       jnp.where(directions < 0, -1e-20, 1e-20),
                       directions)
    inv_dir = 1.0 / d_safe

    B = origins.shape[0]
    # derive the init carry from the ray data itself (a broadcast constant
    # would be shard_map-unvarying and trip VMA carry-type checking; note
    # origins alone can be a broadcast of the replicated camera position)
    zf = (origins[:, 0] + directions[:, 0]) * 0.0
    zi = zf.astype(jnp.int32)
    t_init = zf + _BIG if t_max is None else jnp.asarray(t_max, jnp.float32) + zf

    state = dict(
        node=zi,
        t=t_init,
        tri=zi - 1,
        u=zf,
        v=zf,
    )

    def cond(s):
        return jnp.any(s["node"] < n_nodes)

    def body(s):
        node = s["node"]
        active = node < n_nodes
        idx = jnp.minimum(node, n_nodes - 1)

        lo = bvh.lo[idx]
        hi = bvh.hi[idx]
        hit_box = ray_aabb(origins, inv_dir, lo, hi, s["t"]) & active

        first = bvh.first[idx]
        is_leaf = first >= 0
        do_leaf = hit_box & is_leaf

        # static-shape leaf intersection over leaf_size aligned slots
        slot = jnp.maximum(first, 0)[:, None] + jnp.arange(leaf_size, dtype=jnp.int32)[None, :]
        tri_ids = jnp.where(do_leaf[:, None], bvh.prim_idx[slot], -1)  # (B, K)
        tv = geometry.tri_v[jnp.maximum(tri_ids, 0)]                   # (B, K, 3)
        p0 = geometry.positions[tv[..., 0]]                            # (B, K, 3)
        p1 = geometry.positions[tv[..., 1]]
        p2 = geometry.positions[tv[..., 2]]
        t, u, v, hit = moller_trumbore(origins[:, None, :], directions[:, None, :], p0, p1, p2)
        hit = hit & (tri_ids >= 0)
        t = jnp.where(hit, t, _BIG)
        k_best = jnp.argmin(t, axis=1)                                 # (B,)
        bk = jnp.arange(B)
        t_leaf = t[bk, k_best]
        closer = t_leaf < s["t"]
        s_t = jnp.where(closer, t_leaf, s["t"])
        s_tri = jnp.where(closer, tri_ids[bk, k_best], s["tri"])
        s_u = jnp.where(closer, u[bk, k_best], s["u"])
        s_v = jnp.where(closer, v[bk, k_best], s["v"])

        nxt = jnp.where(hit_box & ~is_leaf, idx + 1, bvh.miss[idx])
        nxt = jnp.where(active, nxt, n_nodes)

        return dict(node=nxt, t=s_t, tri=s_tri, u=s_u, v=s_v)

    out = jax.lax.while_loop(cond, body, state)
    miss = out["tri"] < 0
    return dict(
        tri=out["tri"],
        t=jnp.where(miss, -1.0, out["t"]),  # -1 sentinel (Renderer.cu:2423)
        u=out["u"],
        v=out["v"],
    )
