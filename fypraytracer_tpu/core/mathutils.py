"""Sampling / BRDF math library.

Vectorized, branch-free re-implementations of the reference's device math
(``MathUtils.cuh``).  Every function is written against the array API
shared by ``numpy`` and ``jax.numpy`` and is therefore used by BOTH the
CPU oracle renderer and the jitted device wavefront — formula bugs cannot
hide between the two.  Correctness of the formulas themselves is pinned by
analytic tests (PDF normalization, sample/pdf Monte-Carlo consistency,
white-furnace) in ``tests/test_sampling.py``.

Conventions:
  * Vectors are ``(..., 3)`` float32 arrays; functions broadcast.
  * Samplers take explicit uniform draws (from ``core.rng``) instead of
    mutating a seed — the caller owns RNG order.
  * Invalid samples (below-horizon GGX reflections etc.) are reported via
    ``pdf == 0`` exactly like the reference (MathUtils.cuh:149-162), and
    handled by callers with masked ``where`` lanes.
"""

from __future__ import annotations

import numpy as np

PI = 3.1415926535  # matches MathUtils.cuh:17
INV_PI = 1.0 / PI
TWO_PI = 2.0 * PI


def _xp(x):
    """Return the array namespace (numpy or jax.numpy) of ``x``."""
    if type(x).__module__.startswith("jax") or "jax" in type(x).__module__:
        import jax.numpy as jnp

        return jnp
    return np


def _tail1(x, like):
    """Broadcast a per-lane scalar field to shape (..., 1) matching ``like``.

    Accepts python floats, (...,) arrays, or already-(...,1) arrays.
    """
    if not hasattr(x, "ndim"):
        return x
    if x.ndim == like.ndim - 1:
        return x[..., None]
    return x


def dot3(a, b, keepdims=True):
    return (a * b).sum(axis=-1, keepdims=keepdims)


def normalize(v, eps=1e-20):
    xp = _xp(v)
    return v / xp.sqrt(xp.maximum(dot3(v, v), eps))


def cross3(a, b):
    return _xp(a).cross(a, b)


def reflect(i, n):
    """glm::reflect — reflect incident ``i`` about normal ``n``."""
    return i - 2.0 * dot3(i, n) * n


def build_onb(n):
    """Orthonormal basis from a unit normal (MathUtils.cuh:61-71).

    Returns ``(tangent, bitangent)``; branch select on |n.x| vs |n.z|.
    """
    xp = _xp(n)
    nx, ny, nz = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    zeros = xp.zeros_like(nx)
    t_a = normalize(xp.concatenate([-ny, nx, zeros], axis=-1))
    t_b = normalize(xp.concatenate([zeros, -nz, ny], axis=-1))
    cond = (nx * nx) > (nz * nz)
    tangent = xp.where(cond, t_a, t_b)
    bitangent = normalize(cross3(n, tangent))
    return tangent, bitangent


def to_world(n, local_x, local_y, local_z):
    """Map tangent-space components onto the ONB around ``n``."""
    tangent, bitangent = build_onb(n)
    return normalize(tangent * local_x + bitangent * local_y + n * local_z)


# ---------------------------------------------------------------------------
# Hemisphere samplers (MathUtils.cuh:73-190)
# ---------------------------------------------------------------------------


def cosine_sample_hemisphere(normal, u1, u2):
    """Cosine-weighted direction about ``normal`` (MathUtils.cuh:73-90)."""
    xp = _xp(normal)
    u1 = _tail1(u1, normal)
    u2 = _tail1(u2, normal)
    r = xp.sqrt(u1)
    theta = TWO_PI * u2
    x = r * xp.cos(theta)
    y = r * xp.sin(theta)
    z = xp.sqrt(xp.maximum(0.0, 1.0 - u1))
    return to_world(normal, x, y, z)


def cosine_hemisphere_pdf(cos_theta):
    """pdf = cosθ/π (MathUtils.cuh:92-95)."""
    return cos_theta * INV_PI


def uniform_sample_hemisphere(normal, u1, u2):
    """Uniform direction in the hemisphere (MathUtils.cuh:97-114)."""
    xp = _xp(normal)
    u1 = _tail1(u1, normal)
    u2 = _tail1(u2, normal)
    phi = TWO_PI * u1
    cos_theta = u2
    sin_theta = xp.sqrt(xp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    x = sin_theta * xp.cos(phi)
    y = sin_theta * xp.sin(phi)
    return to_world(normal, x, y, cos_theta)


def uniform_hemisphere_pdf():
    """pdf = 1/(2π) (MathUtils.cuh:116)."""
    return 1.0 / TWO_PI


def ggx_sample_hemisphere(normal, view, roughness, u1, u2):
    """Sample GGX half-vector, reflect view (MathUtils.cuh:118-174).

    Returns ``(L, pdf)``; pdf is 0 for below-horizon / invalid samples.
    ``roughness`` is artist roughness; alpha = roughness².
    """
    xp = _xp(normal)
    u1 = _tail1(u1, normal)
    u2 = _tail1(u2, normal)
    r = _tail1(roughness, normal)
    alpha = r * r
    a2 = alpha * alpha

    phi = TWO_PI * u2
    cos_theta = xp.sqrt(xp.clip((1.0 - u1) / xp.maximum(1.0 + (a2 - 1.0) * u1, 1e-12), 0.0, 1.0))
    cos_theta = xp.clip(cos_theta, 0.0, 1.0)
    sin_theta = xp.sqrt(xp.maximum(0.0, 1.0 - cos_theta * cos_theta))

    hx = sin_theta * xp.cos(phi)
    hy = sin_theta * xp.sin(phi)
    h = to_world(normal, hx, hy, cos_theta)

    l = reflect(-view, h)

    n_dot_l = dot3(normal, l)
    n_dot_h = dot3(normal, h)
    v_dot_h = dot3(view, h)

    denom = (n_dot_h * n_dot_h) * (a2 - 1.0) + 1.0
    d = a2 / xp.maximum(PI * denom * denom, 1e-20)
    p_h = d * n_dot_h
    # grazing-half-vector guard: 4·(v·h) below 1e-6 makes the sample
    # degenerate (pdf ~ 1e20, contribution ~ 1e-20) AND its division
    # gradient overflows f32 (d(1/x)/dθ ~ 1/x² ~ 1e40 → inf → NaN in the
    # differentiable estimators) — double-where pins both to exactly 0.
    denom4 = 4.0 * v_dot_h
    valid = (n_dot_l > 0.0) & (denom4 > 1e-6) & (n_dot_h > 0.0)
    pdf = xp.where(valid, p_h / xp.where(valid, denom4, 1.0), 0.0)
    l = xp.where(valid, l, 0.0)
    return l, pdf[..., 0]


def ggx_hemisphere_pdf(normal, view, l, roughness):
    """pdf of ``l`` under GGX half-vector sampling (MathUtils.cuh:176-190)."""
    xp = _xp(normal)
    r = _tail1(roughness, normal)
    h = normalize(view + l)
    n_dot_h = xp.maximum(dot3(normal, h), 0.0)
    v_dot_h = xp.maximum(dot3(view, h), 0.0)
    alpha = r * r
    a2 = alpha * alpha
    denom = (n_dot_h * n_dot_h) * (a2 - 1.0) + 1.0
    d = a2 / xp.maximum(PI * denom * denom, 1e-20)
    # same grazing guard as ggx_sample_hemisphere (gradient overflow)
    denom4 = 4.0 * v_dot_h
    valid = (n_dot_h > 0.0) & (denom4 > 1e-6)
    pdf = xp.where(valid, d * n_dot_h / xp.where(valid, denom4, 1.0), 0.0)
    return pdf[..., 0]


def fresnel_schlick(albedo, metallic, cos_term):
    """F0 = mix(0.04, albedo, metallic); Schlick (MathUtils.cuh:293-295)."""
    xp = _xp(albedo)
    m = _tail1(metallic, albedo)
    f0 = 0.04 * (1.0 - m) + albedo * m
    return f0 + (1.0 - f0) * (1.0 - cos_term) ** 5.0


def specular_weight(normal, view, albedo, metallic):
    """Lobe-selection weight: mean Fresnel at N·V (MathUtils.cuh:216-218).

    Special cases fold in branch-free: metallic==1 → 1, metallic==0 → 0
    (MathUtils.cuh:201-212).
    """
    xp = _xp(normal)
    m = _tail1(metallic, normal)
    n_dot_v = xp.maximum(dot3(normal, view), 0.0)
    f = fresnel_schlick(albedo, metallic, n_dot_v)
    w = f.mean(axis=-1, keepdims=True)
    w = xp.where(m >= 1.0, 1.0, xp.where(m <= 0.0, 0.0, w))
    return w


def brdf_sample_hemisphere(normal, view, albedo, metallic, roughness, u_sel, u1, u2):
    """Fresnel-weighted GGX/cosine mixture sample (MathUtils.cuh:192-244).

    Branch-free: both lobes are evaluated and selected by ``u_sel <= wSpec``.
    Draw convention (differs from the reference's data-dependent draw
    order, deliberately — counters must be static): ``u_sel`` first, then
    ``(u1, u2)`` feed whichever lobe was chosen.
    Returns ``(L, mixture_pdf)``.
    """
    xp = _xp(normal)
    w_spec = specular_weight(normal, view, albedo, metallic)  # (...,1)

    l_spec, pdf_spec_s = ggx_sample_hemisphere(normal, view, roughness, u1, u2)
    l_diff = cosine_sample_hemisphere(normal, u1, u2)

    u_sel = _tail1(u_sel, normal)
    take_spec = u_sel <= w_spec
    l = xp.where(take_spec, l_spec, l_diff)

    cos_theta = xp.maximum(dot3(normal, l), 0.0)
    pdf_diff = cosine_hemisphere_pdf(cos_theta)[..., 0]
    pdf_spec = xp.where(take_spec[..., 0], pdf_spec_s, ggx_hemisphere_pdf(normal, view, l, roughness))
    pdf = w_spec[..., 0] * pdf_spec + (1.0 - w_spec[..., 0]) * pdf_diff
    return l, pdf


def brdf_hemisphere_pdf(normal, view, l, albedo, metallic, roughness):
    """Mixture pdf of ``l`` (MathUtils.cuh:246-274)."""
    xp = _xp(normal)
    w_spec = specular_weight(normal, view, albedo, metallic)[..., 0]
    pdf_spec = ggx_hemisphere_pdf(normal, view, l, roughness)
    cos_theta = xp.maximum(dot3(normal, l), 0.0)[..., 0]
    pdf_diff = cosine_hemisphere_pdf(cos_theta)
    return w_spec * pdf_spec + (1.0 - w_spec) * pdf_diff


def cook_torrance_brdf(normal, view, l, albedo, metallic, roughness):
    """Cook-Torrance: Lambert diffuse + GGX specular (MathUtils.cuh:276-317).

    Smith G with k = roughness/2; D uses alpha = roughness².  Returns the
    BRDF value (NOT premultiplied by cosθ), zero when either N·L or N·V
    is non-positive.
    """
    xp = _xp(normal)
    m = _tail1(metallic, normal)
    r = _tail1(roughness, normal)
    a = r * r
    a2 = a * a

    h = normalize(view + l)
    n_dot_l = xp.maximum(dot3(normal, l), 0.0)
    n_dot_v = xp.maximum(dot3(normal, view), 0.0)
    n_dot_h = xp.maximum(dot3(normal, h), 0.0)
    v_dot_h = xp.maximum(dot3(view, h), 0.0)

    f0 = 0.04 * (1.0 - m) + albedo * m
    f = f0 + (1.0 - f0) * (1.0 - v_dot_h) ** 5.0

    k = r / 2.0
    g_v = n_dot_v / xp.maximum(n_dot_v * (1.0 - k) + k, 1e-12)
    g_l = n_dot_l / xp.maximum(n_dot_l * (1.0 - k) + k, 1e-12)
    g = g_v * g_l

    kd = 1.0 - f
    diffuse = kd * albedo * INV_PI

    denom = (n_dot_h * n_dot_h) * (a2 - 1.0) + 1.0
    d = a2 * INV_PI / xp.maximum(denom * denom, 1e-12)

    specular = (d * g * f) / xp.maximum(4.0 * n_dot_v * n_dot_l, 1e-12)

    val = diffuse + specular
    return xp.where((n_dot_l > 0.0) & (n_dot_v > 0.0), val, 0.0)


def linearize_depth(depth, near, far):
    """Depth-buffer linearization (MathUtils.cuh:319-326): [0,1] depth →
    NDC → linear, remapped to [0,1]."""
    z = depth * 2.0 - 1.0
    lin = (2.0 * near * far) / (far + near - z * (far - near))
    return lin * 0.5 + 0.5


# ---------------------------------------------------------------------------
# Octahedral normal encoding (MathUtils.cuh:328-374) — ReSTIR GI payloads
# ---------------------------------------------------------------------------


def encode_octahedral(v):
    """Unit vec3 -> vec2 in [-1,1]² (MathUtils.cuh:328-352)."""
    xp = _xp(v)
    denom = xp.abs(v[..., 0:1]) + xp.abs(v[..., 1:2]) + xp.abs(v[..., 2:3])
    p = v / xp.maximum(denom, 1e-20)
    ex, ey, ez = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    sx = xp.where(ex >= 0.0, 1.0, -1.0)
    sy = xp.where(ey >= 0.0, 1.0, -1.0)
    fold_x = (1.0 - xp.abs(ey)) * sx
    fold_y = (1.0 - xp.abs(ex)) * sy
    out_x = xp.where(ez < 0.0, fold_x, ex)
    out_y = xp.where(ez < 0.0, fold_y, ey)
    return xp.concatenate([out_x, out_y], axis=-1)


def decode_octahedral(e):
    """vec2 -> unit vec3 (MathUtils.cuh:354-374)."""
    xp = _xp(e)
    ex, ey = e[..., 0:1], e[..., 1:2]
    z = 1.0 - xp.abs(ex) - xp.abs(ey)
    sx = xp.where(ex >= 0.0, 1.0, -1.0)
    sy = xp.where(ey >= 0.0, 1.0, -1.0)
    new_x = (1.0 - xp.abs(ey)) * sx
    new_y = (1.0 - xp.abs(ex)) * sy
    x = xp.where(z < 0.0, new_x, ex)
    y = xp.where(z < 0.0, new_y, ey)
    return normalize(xp.concatenate([x, y, z], axis=-1))


# ---------------------------------------------------------------------------
# Reprojection (MathUtils.cuh:376-402) — ReSTIR temporal reuse
# ---------------------------------------------------------------------------


def world_to_ndc(proj_view, world_pos):
    """World position -> NDC xy via a combined 4x4 (MathUtils.cuh:376-390).

    ``proj_view``: (..., 4, 4) row = output component (projection @ view).
    """
    xp = _xp(world_pos)
    hom = xp.concatenate([world_pos, xp.ones_like(world_pos[..., :1])], axis=-1)
    clip = (proj_view * hom[..., None, :]).sum(axis=-1)
    w = clip[..., 3:4]
    safe_w = xp.where(xp.abs(w) < 1e-20, 1.0, w)
    ndc = clip[..., 0:2] / safe_w
    return xp.where(xp.abs(w) < 1e-20, 0.0, ndc)


def ndc_to_uv(ndc):
    """NDC [-1,1] -> UV [0,1] (MathUtils.cuh:398-402)."""
    return ndc * 0.5 + 0.5
