"""The dense closest-hit tracers against a float64 NumPy reference.

Two implementations share one contract (ops/dense.py): the XLA
formulation and the fused Pallas-Triton kernel (ops/triton_dense.py),
which here runs through the Pallas interpreter.  Both must find the same
closest triangle as an exact float64 Möller–Trumbore sweep, keep full f32
precision on thin and grazing triangles, and be selected by platform and
triangle count in ``pick_tracer``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fypraytracer_tpu.ops.dense import (DENSE_MAX_TRIS, pick_tracer,
                                        trace_rays_dense)
from fypraytracer_tpu.ops.intersect import T_EPSILON
from fypraytracer_tpu.ops.triton_dense import (TRI_TILE, trace_rays_triton,
                                               triangle_rows)
from fypraytracer_tpu.scene.types import Geometry


def _geometry(verts, tri_v):
    verts = np.asarray(verts, np.float32)
    return Geometry(positions=jnp.asarray(verts),
                    normals=jnp.zeros_like(jnp.asarray(verts)),
                    uvs=jnp.zeros((len(verts), 2), jnp.float32),
                    tri_v=jnp.asarray(tri_v, jnp.int32),
                    tri_mat=jnp.zeros(len(tri_v), jnp.int32))


def reference_hits(verts, tri_v, origins, directions, t_max=None):
    """Exact closest hit in float64: (tri, t, u, v, margin).  ``margin`` is
    how far a ray is from changing its answer (distance of its hit to the
    triangle's edges in barycentric units, and to the runner-up's t), so
    comparisons can skip rays that sit on a shared edge."""
    with np.errstate(invalid="ignore", divide="ignore"):
        return _reference_hits(verts, tri_v, origins, directions, t_max)


def _reference_hits(verts, tri_v, origins, directions, t_max):
    v = np.asarray(verts, np.float64)[np.asarray(tri_v)]
    p0, e1, e2 = v[:, 0], v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
    o = np.asarray(origins, np.float64)[:, None, :]
    d = np.asarray(directions, np.float64)[:, None, :]
    pv = np.cross(d, e2[None])
    det = (e1[None] * pv).sum(-1)
    area = np.linalg.norm(np.cross(e1, e2), axis=-1)
    ok = (np.abs(det) > 1e-12) & (area[None] > 1e-9)
    inv = 1.0 / np.where(ok, det, 1.0)
    tv = o - p0[None]
    u = (tv * pv).sum(-1) * inv
    qv = np.cross(tv, e1[None])
    w = (d * qv).sum(-1) * inv
    t = (e2[None] * qv).sum(-1) * inv
    tmax = np.inf if t_max is None else np.asarray(t_max, np.float64)[:, None]
    hit = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t > T_EPSILON) & (t < tmax)
    tt = np.where(hit, t, np.inf)
    k = np.argmin(tt, axis=1)
    rows = np.arange(len(k))
    found = np.isfinite(tt[rows, k])
    edge = np.minimum(np.minimum(u, w), 1 - u - w)[rows, k]
    second = np.sort(tt, axis=1)[:, 1] if tt.shape[1] > 1 else np.full(len(k), np.inf)
    t_best = tt[rows, k]
    gap = np.where(np.isfinite(second), (second - t_best) / np.maximum(t_best, 1e-9), np.inf)
    # misses: distance of the nearest would-be hit to its edges / t bounds
    near = np.abs(np.minimum(np.minimum(u, w), 1 - u - w))
    miss_margin = np.where(ok & (t > T_EPSILON), near, np.inf).min(axis=1)
    if t_max is not None:
        cand = ok & (u >= 0) & (w >= 0) & (u + w <= 1) & (t > T_EPSILON)
        rel = np.where(cand, np.abs(t - tmax) / np.maximum(tmax, 1e-9), np.inf)
        miss_margin = np.minimum(miss_margin, rel.min(axis=1))
        tmax_gap = np.abs(tmax[:, 0] - t_best) / np.maximum(t_best, 1e-9)
        gap = np.minimum(gap, np.where(found, tmax_gap, np.inf))
    margin = np.where(found, np.minimum(edge, gap), miss_margin)
    return (np.where(found, k, -1), np.where(found, t_best, -1.0),
            np.where(found, u[rows, k], 0.0), np.where(found, w[rows, k], 0.0),
            margin)


# ---- triangle sets ---------------------------------------------------------

def _cornell():
    from fypraytracer_tpu.scene.procedural import cornell_box

    scene = cornell_box(width=8, height=8)[0].compile(light_tree=False)
    return np.asarray(scene.geometry.positions), np.asarray(scene.geometry.tri_v)


def _soup_with_degenerates():
    r = np.random.default_rng(3)
    n = 150
    base = (r.random((n, 1, 3)) - 0.5) * 6.0
    verts = (base + (r.random((n, 3, 3)) - 0.5)).astype(np.float32)
    verts[1::7, 2] = verts[1::7, 0]                     # repeated vertex
    verts[4::7, 1] = verts[4::7, 0] + np.float32([0.5, 0.0, 0.0])  # collinear
    verts[4::7, 2] = verts[4::7, 0] + np.float32([1.0, 0.0, 0.0])
    return verts.reshape(-1, 3), np.arange(3 * n, dtype=np.int32).reshape(n, 3)


def _tile_multiple():
    r = np.random.default_rng(5)
    n = 2 * TRI_TILE                                    # no padding needed
    base = (r.random((n, 1, 3)) - 0.5) * 4.0
    verts = (base + (r.random((n, 3, 3)) - 0.5)).astype(np.float32)
    return verts.reshape(-1, 3), np.arange(3 * n, dtype=np.int32).reshape(n, 3)


_SETS = {"cornell": _cornell, "soup": _soup_with_degenerates,
         "tile_multiple": _tile_multiple}


@pytest.fixture(scope="module")
def tri_sets():
    return {name: fn() for name, fn in _SETS.items()}


def _rays(verts, n, seed):
    """Rays from a box around the geometry toward random points on it, so
    most hit; the first ray is aimed straight at triangle 0's centroid."""
    r = np.random.default_rng(seed)
    lo, hi = verts.min(0), verts.max(0)
    c, ext = 0.5 * (lo + hi), (hi - lo).max() + 1.0
    origins = c + (r.random((n, 3)) - 0.5) * 2.0 * ext
    targets = verts[r.integers(0, len(verts), n)] + (r.random((n, 3)) - 0.5) * 0.2
    targets[0] = verts[:3].mean(0)
    d = targets - origins
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return origins.astype(np.float32), d.astype(np.float32)


_IMPLS = {
    "xla": lambda g, o, d, tm: trace_rays_dense(g, o, d, t_max=tm),
    "triton": lambda g, o, d, tm: trace_rays_triton(g, o, d, t_max=tm,
                                                    interpret=True),
}


@pytest.mark.parametrize("with_tmax", [False, True], ids=["no_tmax", "tmax"])
@pytest.mark.parametrize("tris", sorted(_SETS))
@pytest.mark.parametrize("n_rays", [1, 200, 8193])
@pytest.mark.parametrize("impl", sorted(_IMPLS))
def test_dense_trace_matches_float64(tri_sets, impl, n_rays, tris, with_tmax):
    verts, tri_v = tri_sets[tris]
    o, d = _rays(verts, n_rays, seed=n_rays)
    t_max = None
    if with_tmax:
        _, t_full, *_ = reference_hits(verts, tri_v, o, d)
        scale = np.where(np.arange(n_rays) % 2 == 1, 0.5, 2.0)
        t_max = np.where(t_full > 0, t_full * scale, 1e3).astype(np.float32)
    want_tri, want_t, want_u, want_v, margin = reference_hits(
        verts, tri_v, o, d, t_max)
    got = _IMPLS[impl](_geometry(verts, tri_v), jnp.asarray(o),
                       jnp.asarray(d),
                       None if t_max is None else jnp.asarray(t_max))
    tri, t = np.asarray(got["tri"]), np.asarray(got["t"])
    u, v = np.asarray(got["u"]), np.asarray(got["v"])

    degenerate = np.abs(np.linalg.norm(np.cross(
        verts[tri_v[:, 1]] - verts[tri_v[:, 0]],
        verts[tri_v[:, 2]] - verts[tri_v[:, 0]]), axis=-1)) < 1e-9
    assert not degenerate[tri[tri >= 0]].any(), "a degenerate triangle hit"
    assert (want_tri >= 0).any()
    # rays clear of shared edges and near-ties must match exactly
    clear = margin > 1e-4
    np.testing.assert_array_equal(tri[clear], want_tri[clear])
    assert (tri == want_tri).mean() >= 0.99
    same = (tri == want_tri) & (tri >= 0)
    np.testing.assert_allclose(t[same], want_t[same], rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(u[same], want_u[same], atol=2e-4)
    np.testing.assert_allclose(v[same], want_v[same], atol=2e-4)
    miss = tri < 0
    assert (t[miss] == -1.0).all()
    assert (u[miss] == 0.0).all() and (v[miss] == 0.0).all()


# ---- precision: thin and grazing triangles ---------------------------------

def _round_tf32(x):
    """Round float32 to TF32's 10-bit mantissa (round to nearest even)."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0xFFF + ((b >> 13) & 1)) & 0xFFFFE000
    return b.astype(np.uint32).view(np.float32)


def _thin_scene():
    """Sliver triangles 40 units from the origin, hit by rays that graze
    their planes near an edge: the affine rows' constant terms are large
    and the sum cancels, so 10-bit operands move t, u and v by more than
    the margins these rays have."""
    r = np.random.default_rng(7)
    n = 64
    c = np.float32([40.0, 37.0, -41.0]) + (r.random((n, 3)) - 0.5) * 4.0
    a = r.normal(size=(n, 3))
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b = np.cross(a, r.normal(size=(n, 3)))
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    verts = np.stack([c, c + 0.6 * a, c + 0.6 * a + 2e-3 * b], 1)
    tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    # each ray aims at a point inside its sliver, from a grazing angle
    bary = np.stack([r.uniform(0.3, 0.6, n), r.uniform(0.01, 0.2, n)], 1)
    tgt = verts[:, 0] + bary[:, :1] * (verts[:, 1] - verts[:, 0]) \
        + bary[:, 1:] * (verts[:, 2] - verts[:, 0])
    nrm = np.cross(verts[:, 1] - verts[:, 0], verts[:, 2] - verts[:, 0])
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    orig = tgt - 3.0 * a + 0.02 * nrm
    d = tgt - orig
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (verts.reshape(-1, 3).astype(np.float32), tri_v,
            orig.astype(np.float32), d.astype(np.float32))


def _tf32_dense_tri(verts, tri_v, o, d):
    """The XLA dense formulation with operands rounded to TF32, as an f32
    matmul left at default precision may run on a tensor-core GPU."""
    rows = np.asarray(triangle_rows(_geometry(verts, tri_v), 1))[:12]
    o4 = np.concatenate([o, np.ones((len(o), 1), np.float32)], 1)
    d4 = np.concatenate([d, np.zeros((len(d), 1), np.float32)], 1)
    W = _round_tf32(rows.T.reshape(-1, 3, 4).transpose(1, 2, 0))  # (3,4,T)
    O = np.einsum("bk,ckt->cbt", _round_tf32(o4), W)
    D = np.einsum("bk,ckt->cbt", _round_tf32(d4), W)
    ok = np.abs(D[0]) > 1e-12
    t = -O[0] / np.where(ok, D[0], 1.0)
    u = O[1] + t * D[1]
    v = O[2] + t * D[2]
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_EPSILON)
    tt = np.where(hit, t, np.inf)
    k = tt.argmin(1)
    return np.where(np.isfinite(tt[np.arange(len(k)), k]), k, -1)


@pytest.mark.parametrize("impl", sorted(_IMPLS))
def test_full_f32_on_thin_triangles(impl):
    verts, tri_v, o, d = _thin_scene()
    want = reference_hits(verts, tri_v, o, d)[0]
    assert (want >= 0).mean() > 0.9
    # the scene is sensitive: TF32 operands misclassify some of these rays
    assert (_tf32_dense_tri(verts, tri_v, o, d) != want).sum() >= 3
    got = _IMPLS[impl](_geometry(verts, tri_v), jnp.asarray(o),
                       jnp.asarray(d), None)
    np.testing.assert_array_equal(np.asarray(got["tri"]), want)


def test_xla_dense_pins_highest_precision():
    verts, tri_v = _tile_multiple()
    g = _geometry(verts, tri_v)
    o = jnp.zeros((4, 3))
    jaxpr = jax.make_jaxpr(lambda o, d: trace_rays_dense(g, o, d))(o, o)
    dots = [e.params["precision"] for e in jaxpr.jaxpr.eqns
            if e.primitive.name == "dot_general"]
    assert len(dots) == 2
    highest = jax.lax.Precision.HIGHEST
    assert all(p == (highest, highest) for p in dots), dots


# ---- the kernel wrapper ----------------------------------------------------

def test_triangle_rows_layout_and_padding():
    verts, tri_v = _soup_with_degenerates()
    rows = np.asarray(triangle_rows(_geometry(verts, tri_v)))
    assert rows.shape == (16, len(tri_v) + (-len(tri_v)) % TRI_TILE)
    assert not rows[:, len(tri_v):].any(), "padding rows must be zero"
    assert not rows[12:].any()
    degenerate = np.abs(np.linalg.norm(np.cross(
        verts[tri_v[:, 1]] - verts[tri_v[:, 0]],
        verts[tri_v[:, 2]] - verts[tri_v[:, 0]]), axis=-1)) < 1e-9
    assert degenerate.any()
    assert not rows[:, :len(tri_v)][:, degenerate].any()


def test_triton_block_sizes_do_not_change_hits():
    verts, tri_v = _cornell()
    g = _geometry(verts, tri_v)
    o, d = _rays(verts, 300, seed=9)
    base = trace_rays_triton(g, o, d, interpret=True)
    other = trace_rays_triton(g, o, d, ray_block=32, tri_tile=16,
                              interpret=True)
    for k in ("tri", "t", "u", "v"):
        np.testing.assert_array_equal(np.asarray(base[k]),
                                      np.asarray(other[k]))


def test_triton_kernel_lowers_for_cuda():
    """The kernel lowers to Triton IR for a CUDA target on this CPU-only
    machine: block shapes, loads and the loop pass the Triton lowering
    (compiling to PTX happens only on the card)."""
    verts, tri_v = _cornell()
    g = _geometry(verts, tri_v)
    o = jnp.zeros((1000, 3))
    lowered = jax.jit(lambda o, d: trace_rays_triton(g, o, d)["tri"]).trace(
        o, o).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "dense_closest_hit" in text


# ---- tracer selection ------------------------------------------------------

class _Scene:
    def __init__(self, verts, tri_v):
        from fypraytracer_tpu.accel import bvh as bvh_mod

        self.geometry = _geometry(verts, tri_v)
        p = np.asarray(verts)[tri_v]
        self.bvh = bvh_mod.build_scene_bvh(p.min(1), p.max(1),
                                           [(0, len(tri_v))], leaf_size=4)


def test_pick_tracer_small_scene_is_dense_per_platform():
    verts, tri_v = _cornell()
    scene = _Scene(verts, tri_v)
    o, d = _rays(verts, 64, seed=1)
    trace = pick_tracer(scene)
    jaxpr = str(jax.make_jaxpr(trace)(o, d))
    assert "platform_index" in jaxpr and "pallas_call" in jaxpr
    # on this CPU the XLA formulation is what runs
    np.testing.assert_array_equal(
        np.asarray(jax.jit(trace)(o, d)),
        np.asarray(trace_rays_dense(scene.geometry, o, d)["tri"]))
    cuda = jax.jit(trace).trace(o, d).lower(lowering_platforms=("cuda",))
    assert "__gpu$xla.gpu.triton" in cuda.as_text()
    cpu = jax.jit(trace).trace(o, d).lower(lowering_platforms=("cpu",))
    assert "triton" not in cpu.as_text()


def test_pick_tracer_big_scene_walks_bvh():
    n = DENSE_MAX_TRIS + 1
    r = np.random.default_rng(0)
    verts = (r.random((n, 3, 3)) * 10.0).astype(np.float32).reshape(-1, 3)
    tri_v = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    scene = _Scene(verts, tri_v)
    o, d = _rays(verts[:30], 8, seed=2)
    jaxpr = str(jax.make_jaxpr(pick_tracer(scene))(o, d))
    assert "while" in jaxpr
    assert "pallas_call" not in jaxpr and "platform_index" not in jaxpr


def test_pick_tracer_forced_kernel_raises_off_gpu():
    verts, tri_v = _cornell()
    with pytest.raises(ValueError, match="CUDA"):
        pick_tracer(_Scene(verts, tri_v), "pallas")


def test_pick_tracer_forced_paths_and_unknown():
    verts, tri_v = _cornell()
    scene = _Scene(verts, tri_v)
    o, d = map(jnp.asarray, _rays(verts, 32, seed=4))
    dense = np.asarray(pick_tracer(scene, "dense")(o, d))
    walk = np.asarray(pick_tracer(scene, "bvh")(o, d))
    assert (dense == walk).mean() >= 0.95
    with pytest.raises(ValueError, match="unknown tracer"):
        pick_tracer(scene, "mosaic")
