"""Wavefront path-tracing integrators — the technique zoo, part 1.

Backend-generic (numpy / jax.numpy) masked-lane re-implementations of the
reference's per-pixel megakernels.  Shared structure follows SURVEY.md
§2.2 and the kernel bodies at Renderer.cu:565-1284:

  * primary ray → sky / emissive early-outs (Renderer.cu:589-598);
  * per-sample loop from the *cached primary hit*;
  * per-bounce loop: trace → miss adds throughput·sky, emissive hit adds
    throughput·emission (path ends), else scatter with
    ``throughput *= brdf · cosθ / pdf`` (Renderer.cu:634);
  * next-ray origin offset ``+ normal · 1e-12`` kept verbatim — the real
    self-intersection guard is the t > 1e-4 epsilon (SURVEY appendix).

Divergent CUDA ``break``s become per-lane ``active`` masks; both loops are
statically unrolled (bounces/samples are compile-time settings), which XLA
fuses into a flat wavefront program.

Deliberate fixes of reference quirks (documented per SURVEY appendix):
  * lanes with pdf == 0 (invalid GGX samples) are killed instead of
    emitting inf/NaN for the end-of-frame scrub;
  * the GGX bounce loop uses the *current* hit's roughness, not the
    primary hit's (bug at Renderer.cu:1091-1092).

The brute-force variant (Renderer.cu:565-701) traces exactly one path per
frame and ignores ``samples`` — reproduced faithfully since it defines the
equal-time baseline estimator.
"""

from __future__ import annotations

from fypraytracer_tpu.core import rng
from fypraytracer_tpu.core.mathutils import (
    _xp,
    brdf_hemisphere_pdf,
    brdf_sample_hemisphere,
    cook_torrance_brdf,
    cosine_hemisphere_pdf,
    cosine_sample_hemisphere,
    dot3,
    ggx_sample_hemisphere,
    uniform_hemisphere_pdf,
    uniform_sample_hemisphere,
)
from fypraytracer_tpu.ops.hit import hit_payload
from fypraytracer_tpu.ops.texture import sample_bilinear
from fypraytracer_tpu.scene.types import Scene

ORIGIN_EPS = 1e-12  # Renderer.cu:636 — kept for parity; see module docstring


def material_emission(scene: Scene, mat_id):
    """emission = color · power, zero for miss lanes (Material.cu:5-18)."""
    xp = _xp(scene.materials.albedo)
    m = xp.maximum(mat_id, 0)
    em = scene.materials.emission_color[m] * scene.materials.emission_power[m][..., None]
    return xp.where((mat_id >= 0)[..., None], em, 0.0)


def fetch_albedo(scene: Scene, mat_id, uv, bounce: bool = False):
    """Flat albedo or bilinear texture fetch (Renderer.cu:609-621).

    ``bounce=True`` reads the prefiltered bounce mip level — the shared
    sampling policy (scene/types.py::TextureAtlas) every render path
    follows so the wavefront and the oracle stay bit-matched."""
    xp = _xp(uv)
    m = xp.maximum(mat_id, 0)
    flat = scene.materials.albedo[m]
    tex_id = scene.materials.albedo_map[m]
    textured = sample_bilinear(scene.textures, tex_id, uv[..., 0], uv[..., 1],
                               bounce=bounce)
    return xp.where((tex_id >= 0)[..., None], textured, flat)


def _scatter(scene: Scene, pay, view, key, sampler: str,
             bounce: bool = False):
    """Draw one scatter direction at a hit; returns (key, L, pdf).

    ``view`` is the direction from hit towards the previous vertex (-ray);
    ``bounce`` selects the texture mip per the TextureAtlas policy.
    """
    normal = pay["normal"]
    mats = scene.materials
    xp = _xp(normal)
    m = xp.maximum(pay["mat"], 0)
    rough = mats.roughness[m]
    metal = mats.metallic[m]
    albedo = fetch_albedo(scene, pay["mat"], pay["uv"], bounce=bounce)

    if sampler == "uniform":
        key, (u1, u2) = rng.uniforms(key, 2)
        l = uniform_sample_hemisphere(normal, u1, u2)
        pdf = xp.full(normal.shape[:-1], uniform_hemisphere_pdf(), dtype=normal.dtype)
    elif sampler == "cosine":
        key, (u1, u2) = rng.uniforms(key, 2)
        l = cosine_sample_hemisphere(normal, u1, u2)
        pdf = cosine_hemisphere_pdf(xp.maximum(dot3(normal, l, keepdims=False), 0.0))
    elif sampler == "ggx":
        key, (u1, u2) = rng.uniforms(key, 2)
        l, pdf = ggx_sample_hemisphere(normal, view, rough, u1, u2)
    elif sampler == "brdf":
        key, (u_sel, u1, u2) = rng.uniforms(key, 3)
        l, pdf = brdf_sample_hemisphere(normal, view, albedo, metal, rough, u_sel, u1, u2)
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    return key, l, pdf, albedo, rough, metal


def sampler_pdf(scene: Scene, pay, view, l, sampler: str):
    """pdf the scatter sampler assigns to direction ``l`` (for MIS)."""
    xp = _xp(l)
    normal = pay["normal"]
    m = xp.maximum(pay["mat"], 0)
    rough = scene.materials.roughness[m]
    metal = scene.materials.metallic[m]
    albedo = fetch_albedo(scene, pay["mat"], pay["uv"])
    cos_t = xp.maximum(dot3(normal, l, keepdims=False), 0.0)
    if sampler == "uniform":
        return xp.full(cos_t.shape, uniform_hemisphere_pdf(), dtype=cos_t.dtype)
    if sampler == "cosine":
        return cosine_hemisphere_pdf(cos_t)
    if sampler == "brdf":
        return brdf_hemisphere_pdf(normal, view, l, albedo, metal, rough)
    raise ValueError(f"unknown sampler {sampler!r}")


def radiance_hemisphere(scene: Scene, trace_fn, origins, directions, pixel_ids,
                        frame, settings, sampler: str):
    """Shared body of the brute-force / uniform / cosine / GGX / BRDF
    kernels (Renderer.cu:565-1284).

    Args:
      trace_fn: (origins, dirs) -> (B,) i32 triangle id (-1 miss).
      pixel_ids: (B,) i32 global pixel index (RNG counter key).
      frame: scalar frame index (traced ok).
    Returns (B, 3) HDR radiance for this frame.
    """
    xp = _xp(origins)
    sky = xp.asarray(settings.sky_color, dtype=origins.dtype)
    brute = sampler == "brute"
    eff_sampler = "uniform" if brute else sampler
    num_samples = 1 if brute else settings.samples

    prim_tri = trace_fn(origins, directions)
    prim = hit_payload(scene.geometry, origins, directions, prim_tri)
    prim_miss = prim["t"] < 0.0
    prim_emission = material_emission(scene, prim["mat"])
    prim_emissive = dot3(prim_emission, prim_emission, keepdims=False) > 0.0

    path_lanes = ~(prim_miss | prim_emissive)
    radiance = xp.zeros_like(origins)

    for s in range(num_samples):
        key = rng.path_key(pixel_ids, frame, s)
        active = path_lanes
        throughput = xp.ones_like(origins)

        pay = prim
        view = -directions  # towards previous vertex; camera dirs may be unnormalized? normalized by raygen
        key, l, pdf, albedo, rough, metal = _scatter(scene, pay, view, key, eff_sampler)
        brdf = cook_torrance_brdf(pay["normal"], view, l, albedo, metal, rough)
        cos_t = xp.maximum(dot3(l, pay["normal"]), 0.0)
        ok = pdf > 0.0
        throughput = throughput * brdf * cos_t / xp.where(ok, pdf, 1.0)[..., None]
        active = active & ok

        ray_o = pay["position"] + pay["normal"] * ORIGIN_EPS
        ray_d = l

        for _b in range(settings.bounces):
            tri = trace_fn(ray_o, ray_d)
            pay = hit_payload(scene.geometry, ray_o, ray_d, tri)
            miss = pay["t"] < 0.0

            radiance = radiance + xp.where((active & miss)[..., None], throughput * sky, 0.0)
            active = active & ~miss

            emission = material_emission(scene, pay["mat"])
            is_emissive = dot3(emission, emission, keepdims=False) > 0.0
            radiance = radiance + xp.where((active & is_emissive)[..., None], throughput * emission, 0.0)
            active = active & ~is_emissive

            view = -ray_d
            key, l, pdf, albedo, rough, metal = _scatter(
                scene, pay, view, key, eff_sampler, bounce=True)
            brdf = cook_torrance_brdf(pay["normal"], view, l, albedo, metal, rough)
            cos_t = xp.maximum(dot3(l, pay["normal"]), 0.0)
            ok = pdf > 0.0
            throughput = throughput * brdf * cos_t / xp.where(ok, pdf, 1.0)[..., None]
            active = active & ok

            ray_o = pay["position"] + pay["normal"] * ORIGIN_EPS
            ray_d = l

    if num_samples > 1:
        radiance = radiance / float(num_samples)

    out = xp.where(prim_miss[..., None], sky, radiance)
    out = xp.where(prim_emissive[..., None], prim_emission, out)
    return out


# ---------------------------------------------------------------------------
# Light-source sampling + NEE with MIS (Renderer.cu:1287-1626)
# ---------------------------------------------------------------------------


def _sample_point_on_triangle(geometry, tri_ids, u1, u2):
    """Uniform point via sqrt warp (Triangle::GetRandomPointOnTriangle,
    Triangle.cuh:20-34) + averaged face normal (:36-43) + area (:45-51).

    Returns (point, normal, area); tri_ids < 0 lanes give arbitrary data
    (callers mask).
    """
    xp = _xp(u1)
    tid = xp.maximum(tri_ids, 0)
    tv = geometry.tri_v[tid]
    p0 = geometry.positions[tv[..., 0]]
    p1 = geometry.positions[tv[..., 1]]
    p2 = geometry.positions[tv[..., 2]]
    su = xp.sqrt(u1)[..., None]
    b0 = 1.0 - su
    b1 = su * (1.0 - u2[..., None])
    b2 = su * u2[..., None]
    point = p0 * b0 + p1 * b1 + p2 * b2

    n0 = geometry.normals[tv[..., 0]]
    n1 = geometry.normals[tv[..., 1]]
    n2 = geometry.normals[tv[..., 2]]
    normal = _normalize(n0 + n1 + n2)

    cross = _cross(p1 - p0, p2 - p0)
    area = 0.5 * xp.sqrt(dot3(cross, cross, keepdims=False))
    return point, normal, area


def _normalize(v):
    xp = _xp(v)
    return v / xp.sqrt(xp.maximum(dot3(v, v), 1e-20))


def _cross(a, b):
    return _xp(a).cross(a, b)


def radiance_light_source(scene: Scene, trace_fn, origins, directions,
                          pixel_ids, frame, settings):
    """Light-tree direct-light sampling (PerPixel_LightSourceSampling,
    Renderer.cu:1287-1408): one-bounce direct illumination; emitter picked
    by importance descent, uniform point on the triangle; pdf =
    pmf · (1/area) · dist² with cosθ_x·cosθ_y geometry terms; visibility by
    retracing and identity check (Renderer.cu:1393)."""
    from fypraytracer_tpu.ops.lighttree import pick_light

    xp = _xp(origins)
    sky = xp.asarray(settings.sky_color, dtype=origins.dtype)

    prim_tri = trace_fn(origins, directions)
    prim = hit_payload(scene.geometry, origins, directions, prim_tri)
    prim_miss = prim["t"] < 0.0
    prim_emission = material_emission(scene, prim["mat"])
    prim_emissive = dot3(prim_emission, prim_emission, keepdims=False) > 0.0
    path_lanes = ~(prim_miss | prim_emissive)

    albedo = fetch_albedo(scene, prim["mat"], prim["uv"])
    m = xp.maximum(prim["mat"], 0)
    rough = scene.materials.roughness[m]
    metal = scene.materials.metallic[m]
    view = -directions

    radiance = xp.zeros_like(origins)
    for s in range(settings.samples):
        key = rng.path_key(pixel_ids, frame, s)
        key, (u_pick, u1, u2) = rng.uniforms(key, 3)
        lt_tri, pmf = pick_light(scene.light_tree, prim["position"], u_pick)

        point, l_normal, area = _sample_point_on_triangle(scene.geometry, lt_tri, u1, u2)
        to_light = point - prim["position"]
        dist = xp.sqrt(xp.maximum(dot3(to_light, to_light, keepdims=False), 1e-20))
        l_dir = to_light / dist[..., None]

        brdf = cook_torrance_brdf(prim["normal"], view, l_dir, albedo, metal, rough)
        cos_x = xp.maximum(dot3(l_dir, prim["normal"], keepdims=False), 0.0)
        cos_y = xp.maximum(dot3(-l_dir, l_normal, keepdims=False), 0.0)
        pdf = pmf * (1.0 / xp.maximum(area, 1e-20)) * dist * dist

        contrib = brdf * (cos_x * cos_y / xp.maximum(pdf, 1e-20))[..., None]

        shadow_o = prim["position"] + prim["normal"] * ORIGIN_EPS
        vis_tri = trace_fn(shadow_o, l_dir)
        visible = (vis_tri == lt_tri) & (lt_tri >= 0)

        emission = material_emission(scene, xp.where(lt_tri >= 0, scene.geometry.tri_mat[xp.maximum(lt_tri, 0)], -1))
        lane = path_lanes & visible & (pmf > 0.0)
        radiance = radiance + xp.where(lane[..., None], contrib * emission, 0.0)

        # shadow ray escaping to sky contributes sky (Renderer.cu:1388-1392)
        sky_lane = path_lanes & (vis_tri < 0)
        radiance = radiance + xp.where(sky_lane[..., None], contrib * sky, 0.0)

    radiance = radiance / float(settings.samples)
    out = xp.where(prim_miss[..., None], sky, radiance)
    out = xp.where(prim_emissive[..., None], prim_emission, out)
    return out


def radiance_nee_mis(scene: Scene, trace_fn, origins, directions, pixel_ids,
                     frame, settings):
    """NEE with balance-heuristic MIS (PerPixel_NextEventEstimation,
    Renderer.cu:1411-1626).

    Per bounce: (a) shadow-rayed light-tree sample weighted by
    pdf_direct/(pdf_direct+pdf_brdf) with solid-angle light pdf
    (Renderer.cu:1519-1524,1539); (b) BRDF-mixture continuation; when it
    hits an emitter, weighted by pdf_brdf/(pdf_brdf+pdf_direct) with
    pdf_direct recovered via light-tree PMF replay (Renderer.cu:1613-1617).

    Documented fixes vs the reference (SURVEY appendix):
      * the MIS pdf for a BRDF-hit emitter uses the ACTUAL hit point
        (distance/cosine at the hit), not a fresh random point on the hit
        triangle (quirk at Renderer.cu:1598-1612);
      * continuation cosθ clamped at 0 (unclamped at Renderer.cu:1572).

    With bounces == 1 this degrades to plain light-source sampling with no
    MIS weight (Renderer.cu:1530-1536).
    """
    from fypraytracer_tpu.ops.lighttree import emitter_pmf, pick_light

    xp = _xp(origins)
    sky = xp.asarray(settings.sky_color, dtype=origins.dtype)

    prim_tri = trace_fn(origins, directions)
    prim = hit_payload(scene.geometry, origins, directions, prim_tri)
    prim_miss = prim["t"] < 0.0
    prim_emission = material_emission(scene, prim["mat"])
    prim_emissive = dot3(prim_emission, prim_emission, keepdims=False) > 0.0
    path_lanes = ~(prim_miss | prim_emissive)

    radiance = xp.zeros_like(origins)
    single_bounce = settings.bounces == 1

    for s in range(settings.samples):
        key = rng.path_key(pixel_ids, frame, s)
        active = path_lanes
        throughput = xp.ones_like(origins)
        pay = prim
        ray_d = directions

        for _b in range(settings.bounces):
            view = -ray_d
            mclamp = xp.maximum(pay["mat"], 0)
            rough = scene.materials.roughness[mclamp]
            metal = scene.materials.metallic[mclamp]
            albedo = fetch_albedo(scene, pay["mat"], pay["uv"], bounce=_b > 0)

            # ---- direct light sample -------------------------------------
            key, (u_pick, u1, u2) = rng.uniforms(key, 3)
            lt_tri, pmf = pick_light(scene.light_tree, pay["position"], u_pick)
            point, l_normal, area = _sample_point_on_triangle(scene.geometry, lt_tri, u1, u2)
            to_light = point - pay["position"]
            dist = xp.sqrt(xp.maximum(dot3(to_light, to_light, keepdims=False), 1e-20))
            l_dir = to_light / dist[..., None]

            shadow_o = pay["position"] + pay["normal"] * ORIGIN_EPS
            vis_tri = trace_fn(shadow_o, l_dir)
            visible = (vis_tri == lt_tri) & (lt_tri >= 0)

            brdf_d = cook_torrance_brdf(pay["normal"], view, l_dir, albedo, metal, rough)
            cos_x = xp.maximum(dot3(l_dir, pay["normal"], keepdims=False), 0.0)
            cos_y = xp.maximum(dot3(-l_dir, l_normal, keepdims=False), 1e-12)
            pdf_direct = pmf * (1.0 / xp.maximum(area, 1e-20)) * dist * dist / cos_y
            pdf_brdf_l = brdf_hemisphere_pdf(pay["normal"], view, l_dir, albedo, metal, rough)

            l_emission = material_emission(
                scene, xp.where(lt_tri >= 0, scene.geometry.tri_mat[xp.maximum(lt_tri, 0)], -1))
            w_direct = (xp.ones_like(pdf_direct) if single_bounce else
                        pdf_direct / xp.maximum(pdf_brdf_l + pdf_direct, 1e-12))
            direct = (w_direct / xp.maximum(pdf_direct, 1e-20) * cos_x)[..., None] * brdf_d * l_emission
            lane = active & visible & (pmf > 0.0)
            radiance = radiance + xp.where(lane[..., None], throughput * direct, 0.0)

            if single_bounce:
                break

            # ---- BRDF continuation ---------------------------------------
            key, (u_sel, v1, v2) = rng.uniforms(key, 3)
            l, pdf_brdf = brdf_sample_hemisphere(pay["normal"], view, albedo,
                                                 metal, rough, u_sel, v1, v2)
            brdf_c = cook_torrance_brdf(pay["normal"], view, l, albedo, metal, rough)
            cos_t = xp.maximum(dot3(l, pay["normal"]), 0.0)
            ok = pdf_brdf > 0.0
            throughput = throughput * brdf_c * cos_t / xp.maximum(pdf_brdf, 1e-12)[..., None]
            active = active & ok

            ray_o = pay["position"] + pay["normal"] * ORIGIN_EPS
            ray_d = l
            tri = trace_fn(ray_o, ray_d)
            new_pay = hit_payload(scene.geometry, ray_o, ray_d, tri)
            miss = new_pay["t"] < 0.0

            radiance = radiance + xp.where((active & miss)[..., None], throughput * sky, 0.0)
            active = active & ~miss

            emission = material_emission(scene, new_pay["mat"])
            hit_emissive = dot3(emission, emission, keepdims=False) > 0.0
            # MIS for the BRDF-found emitter: light pdf at the ACTUAL hit
            cos_y2 = xp.maximum(dot3(-ray_d, new_pay["normal"], keepdims=False), 1e-12)
            tv2 = scene.geometry.tri_v[xp.maximum(tri, 0)]
            e1 = scene.geometry.positions[tv2[..., 1]] - scene.geometry.positions[tv2[..., 0]]
            e2 = scene.geometry.positions[tv2[..., 2]] - scene.geometry.positions[tv2[..., 0]]
            cr = _cross(e1, e2)
            area2 = 0.5 * xp.sqrt(xp.maximum(dot3(cr, cr, keepdims=False), 1e-20))
            dist2 = xp.maximum(new_pay["t"], 0.0)
            pmf2 = emitter_pmf(scene.light_tree, tri, pay["position"])
            pdf_direct2 = pmf2 * (1.0 / area2) * dist2 * dist2 / cos_y2
            w_brdf = pdf_brdf / xp.maximum(pdf_brdf + pdf_direct2, 1e-12)
            radiance = radiance + xp.where((active & hit_emissive)[..., None],
                                           throughput * emission * w_brdf[..., None], 0.0)
            active = active & ~hit_emissive
            pay = new_pay

    radiance = radiance / float(settings.samples)
    out = xp.where(prim_miss[..., None], sky, radiance)
    out = xp.where(prim_emissive[..., None], prim_emission, out)
    return out
