"""BVH builder invariants + traversal equivalence vs linear intersection."""

import numpy as np
import pytest

from fypraytracer_tpu.accel import bvh as bvh_mod
from fypraytracer_tpu.oracle.cpu_renderer import make_linear_trace
from fypraytracer_tpu.scene.types import Geometry


def _random_tris(n, seed=0, spread=10.0):
    r = np.random.default_rng(seed)
    base = (r.random((n, 1, 3), np.float32) - 0.5) * spread
    offs = (r.random((n, 3, 3), np.float32) - 0.5) * 1.0
    verts = (base + offs).reshape(-1, 3).astype(np.float32)
    tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    return verts, tri_v


def _geometry(verts, tri_v):
    return Geometry(positions=verts,
                    normals=np.tile(np.float32([0, 0, 1]), (len(verts), 1)),
                    uvs=np.zeros((len(verts), 2), np.float32),
                    tri_v=tri_v, tri_mat=np.zeros(len(tri_v), np.int32))


def _tri_aabbs(verts, tri_v):
    p = verts[tri_v]  # (T, 3, 3)
    return p.min(axis=1), p.max(axis=1)


def test_flatten_structure_invariants():
    verts, tri_v = _random_tris(500, seed=1)
    lo, hi = _tri_aabbs(verts, tri_v)
    flat = bvh_mod.build_scene_bvh(lo, hi, [(0, len(tri_v))], leaf_size=4)
    n = flat.lo.shape[0]
    # every prim appears exactly once among leaf slots
    prims = flat.prim_idx[flat.prim_idx >= 0]
    assert sorted(prims.tolist()) == list(range(len(tri_v)))
    # miss links point strictly forward (preorder) and terminate at n
    assert np.all(flat.miss > np.arange(n))
    assert np.all(flat.miss <= n)
    # leaves have first aligned to leaf_size slots
    leaves = flat.first >= 0
    assert np.all(flat.first[leaves] % flat.leaf_size == 0)
    # node boxes contain their leaf triangles
    for i in np.nonzero(leaves)[0][:50]:
        ids = flat.prim_idx[flat.first[i]: flat.first[i] + flat.count[i]]
        assert np.all(lo[ids] >= flat.lo[i] - 1e-5)
        assert np.all(hi[ids] <= flat.hi[i] + 1e-5)


@pytest.mark.parametrize("n_meshes", [1, 4])
def test_traversal_matches_linear(n_meshes):
    import jax.numpy as jnp

    from fypraytracer_tpu.ops.traverse import trace_rays

    rng_ = np.random.default_rng(7)
    all_v, all_t = [], []
    ranges = []
    off = 0
    toff = 0
    for m in range(n_meshes):
        v, t = _random_tris(120, seed=m + 2)
        all_v.append(v)
        all_t.append(t + off)
        off += len(v)
        ranges.append((toff, toff + len(t)))
        toff += len(t)
    verts = np.concatenate(all_v)
    tri_v = np.concatenate(all_t)
    geom = _geometry(verts, tri_v)
    lo, hi = _tri_aabbs(verts, tri_v)
    flat = bvh_mod.build_scene_bvh(lo, hi, ranges, leaf_size=4)

    B = 512
    origins = (rng_.random((B, 3)).astype(np.float32) - 0.5) * 30.0
    targets = (rng_.random((B, 3)).astype(np.float32) - 0.5) * 8.0
    dirs = (targets - origins)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)

    linear = make_linear_trace(geom)
    want = linear(origins, dirs)

    got = trace_rays(flat, geom, jnp.asarray(origins), jnp.asarray(dirs))
    got_tri = np.asarray(got["tri"])

    # identical hit/miss classification
    np.testing.assert_array_equal(got_tri >= 0, want >= 0)
    # same triangle (ties on shared edges may rarely differ; require ≥99.5%)
    both = (got_tri >= 0) & (want >= 0)
    agree = (got_tri[both] == want[both]).mean() if both.any() else 1.0
    assert agree >= 0.995


def test_shadow_ray_tmax():
    import jax.numpy as jnp

    from fypraytracer_tpu.ops.traverse import trace_rays

    # single triangle at z=0; ray from z=5 pointing down
    verts = np.float32([[-1, -1, 0], [1, -1, 0], [0, 1, 0]])
    tri_v = np.int32([[0, 1, 2]])
    geom = _geometry(verts, tri_v)
    lo, hi = _tri_aabbs(verts, tri_v)
    flat = bvh_mod.build_scene_bvh(lo, hi, [(0, 1)], leaf_size=4)
    o = jnp.asarray(np.float32([[0, 0, 5], [0, 0, 5]]))
    d = jnp.asarray(np.float32([[0, 0, -1], [0, 0, -1]]))
    t_max = jnp.asarray(np.float32([10.0, 3.0]))  # hit at t=5
    out = trace_rays(flat, geom, o, d, t_max=t_max)
    assert int(out["tri"][0]) == 0
    assert int(out["tri"][1]) == -1


def test_dense_matches_bvh():
    """Dense O(B·T) tracer and the threaded-BVH walk must agree exactly."""
    import jax.numpy as jnp

    from fypraytracer_tpu.ops.dense import trace_rays_dense
    from fypraytracer_tpu.ops.traverse import trace_rays

    rng_ = np.random.default_rng(11)
    verts, tri_v = _random_tris(300, seed=5)
    geom = _geometry(verts, tri_v)
    lo, hi = _tri_aabbs(verts, tri_v)
    flat = bvh_mod.build_scene_bvh(lo, hi, [(0, len(tri_v))], leaf_size=4)

    B = 9000  # exceeds default ray_chunk to exercise the lax.map tiling
    origins = (rng_.random((B, 3)).astype(np.float32) - 0.5) * 30.0
    targets = (rng_.random((B, 3)).astype(np.float32) - 0.5) * 8.0
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o, d = jnp.asarray(origins), jnp.asarray(dirs)

    dense = trace_rays_dense(geom, o, d)
    walk = trace_rays(flat, geom, o, d)

    np.testing.assert_array_equal(np.asarray(dense["tri"] >= 0),
                                  np.asarray(walk["tri"] >= 0))
    both = np.asarray((dense["tri"] >= 0) & (walk["tri"] >= 0))
    agree = (np.asarray(dense["tri"])[both] == np.asarray(walk["tri"])[both]).mean()
    assert agree >= 0.995
    hit = np.asarray(dense["tri"]) == np.asarray(walk["tri"])
    np.testing.assert_allclose(np.asarray(dense["t"])[hit],
                               np.asarray(walk["t"])[hit], rtol=1e-4)
