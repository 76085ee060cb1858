"""Hit-attribute reconstruction — backend-generic (numpy / jax.numpy).

``hit_payload`` mirrors ``RendererGPU::ClosestHit`` (Renderer.cu:2389-2421):
barycentric-interpolated world normal and UV, world position from ray
equation, material id; miss lanes get t = -1 (Renderer.cu:2423 sentinel)
and mat = -1.  Used by both the CPU oracle (numpy) and the jitted device path
(jnp) so payload semantics are defined exactly once.

Gradients flow through vertex positions/normals/uvs and the ray; the
triangle *selection* is discrete by construction (int index input).
"""

from __future__ import annotations

from fypraytracer_tpu.core.mathutils import _xp, normalize
from fypraytracer_tpu.ops.intersect import moller_trumbore
from fypraytracer_tpu.scene.types import Geometry


def hit_payload(geometry: Geometry, origins, directions, tri):
    """Reconstruct hit attributes for selected triangles.

    Args:
      tri: (B,) i32 triangle ids; -1 = miss.
    Returns dict: ``t`` (B,), ``position`` (B,3), ``normal`` (B,3),
    ``uv`` (B,2), ``tri`` (B,), ``mat`` (B,).
    """
    xp = _xp(origins)
    valid = tri >= 0
    tid = xp.maximum(tri, 0)
    tv = geometry.tri_v[tid]
    p0 = geometry.positions[tv[..., 0]]
    p1 = geometry.positions[tv[..., 1]]
    p2 = geometry.positions[tv[..., 2]]
    t, u, v, _ = moller_trumbore(origins, directions, p0, p1, p2)
    t = xp.where(valid, t, -1.0)

    w = 1.0 - u - v
    n0 = geometry.normals[tv[..., 0]]
    n1 = geometry.normals[tv[..., 1]]
    n2 = geometry.normals[tv[..., 2]]
    normal = normalize(n0 * w[..., None] + n1 * u[..., None] + n2 * v[..., None])

    uv0 = geometry.uvs[tv[..., 0]]
    uv1 = geometry.uvs[tv[..., 1]]
    uv2 = geometry.uvs[tv[..., 2]]
    uv = uv0 * w[..., None] + uv1 * u[..., None] + uv2 * v[..., None]

    position = origins + directions * t[..., None]
    mat = xp.where(valid, geometry.tri_mat[tid], -1)
    return dict(t=t, position=position, normal=normal, uv=uv, tri=tri, mat=mat)
