"""ReSTIR DI/GI: smoke + statistical correctness.

ReSTIR is a resampling estimator — it must be *unbiased* against the
plain estimators on the same scene (the reference's
convergence-by-accumulation oracle, SURVEY.md §4.4), and the jitted device
path must match the NumPy oracle at matched seeds.
"""

import numpy as np
import pytest

from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu.core.camera import generate_rays
from fypraytracer_tpu.oracle.cpu_renderer import make_linear_trace
from fypraytracer_tpu.render import restir_di, restir_gi
from fypraytracer_tpu.scene.procedural import cornell_box


def _run_oracle_restir(scene, cam, settings, frames, module):
    trace = make_linear_trace(scene.geometry)
    origins, dirs = generate_rays(cam.inv_projection, cam.inv_view,
                                  cam.width, cam.height, xp=np)
    origins = origins.astype(np.float32)
    dirs = dirs.astype(np.float32)
    pixel_ids = np.arange(cam.width * cam.height, dtype=np.uint32)
    state = module.init_state(cam.width * cam.height)
    ppv = cam.prev_proj_view
    acc = np.zeros((cam.width * cam.height, 3), np.float32)
    fn = module.render_restir_di if module is restir_di else module.render_restir_gi
    for f in range(1, frames + 1):
        hdr, state = fn(scene, trace, origins, dirs, pixel_ids, np.uint32(f),
                        settings, state, cam.width, cam.height, ppv)
        acc += np.asarray(hdr)
    return acc / frames


@pytest.fixture(scope="module")
def scene_and_cam():
    builder, cam = cornell_box(width=32, height=32, with_spheres=False)
    return builder.compile(), cam


def test_restir_di_unbiased_vs_light_sampling(scene_and_cam):
    from fypraytracer_tpu.oracle.cpu_renderer import accumulate_oracle

    scene, cam = scene_and_cam
    frames = 40
    di = _run_oracle_restir(
        scene, cam,
        RenderSettings(technique=SamplingTechnique.RESTIR_DI, light_candidates=4,
                       temporal_reuse=True, spatial_reuse=True,
                       spatial_neighbors=3, spatial_radius=8),
        frames, restir_di).reshape(cam.height, cam.width, 3)
    ref = accumulate_oracle(scene, cam, RenderSettings(
        technique=SamplingTechnique.LIGHT_SOURCE, samples=4), frames)
    # same direct-light integral (1 bounce direct); agree in the mean
    rel = abs(di.mean() - ref.mean()) / max(ref.mean(), 1e-9)
    assert rel < 0.1, (di.mean(), ref.mean())
    assert np.isfinite(di).all()


def test_restir_di_parity_jit(scene_and_cam):
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.ops.traverse import trace_rays

    scene, cam = scene_and_cam
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_DI,
                              light_candidates=4, spatial_neighbors=2,
                              spatial_radius=6)
    want = _run_oracle_restir(scene, cam, settings, 2, restir_di)

    dscene = scene.device_put()

    def trace(o, d):
        return trace_rays(dscene.bvh, dscene.geometry, o, d)["tri"]

    origins, dirs = generate_rays(cam.inv_projection, cam.inv_view,
                                  cam.width, cam.height, xp=np)
    o = jnp.asarray(origins, jnp.float32)
    d = jnp.asarray(dirs, jnp.float32)
    pixel_ids = jnp.arange(cam.width * cam.height, dtype=jnp.uint32)
    state = jax.tree_util.tree_map(jnp.asarray,
                                   restir_di.init_state(cam.width * cam.height))
    ppv = jnp.asarray(cam.prev_proj_view)
    acc = jnp.zeros((cam.width * cam.height, 3), jnp.float32)
    for f in (1, 2):
        hdr, state = restir_di.render_restir_di(
            dscene, trace, o, d, pixel_ids, jnp.uint32(f), settings, state,
            cam.width, cam.height, ppv)
        acc = acc + hdr
    got = np.asarray(acc) / 2

    diff = np.abs(got - want)
    assert (diff.max(axis=-1) > 1e-2).mean() < 0.02
    assert float(np.median(diff)) < 1e-4


def test_restir_gi_unbiased_vs_brdf_path(scene_and_cam):
    from fypraytracer_tpu.oracle.cpu_renderer import accumulate_oracle

    scene, cam = scene_and_cam
    frames = 50
    gi = _run_oracle_restir(
        scene, cam,
        RenderSettings(technique=SamplingTechnique.RESTIR_GI, bounces=2,
                       temporal_reuse=True, spatial_reuse=True,
                       spatial_neighbors=3, spatial_radius=8),
        frames, restir_gi).reshape(cam.height, cam.width, 3)
    ref = accumulate_oracle(scene, cam, RenderSettings(
        technique=SamplingTechnique.BRDF, bounces=2, samples=4), frames)
    rel = abs(gi.mean() - ref.mean()) / max(ref.mean(), 1e-9)
    assert rel < 0.05, (gi.mean(), ref.mean())
    assert np.isfinite(gi).all()


def test_restir_gi_parity_jit(scene_and_cam):
    """Seed-matched GI parity: jitted BVH path vs the NumPy linear-tracer
    oracle (render_oracle_restir) — the golden parity the other
    techniques get (VERDICT r1 missing #7/#9)."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.ops.traverse import trace_rays

    scene, cam = scene_and_cam
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_GI,
                              bounces=2, spatial_neighbors=2,
                              spatial_radius=6)
    want = _run_oracle_restir(scene, cam, settings, 2, restir_gi)

    dscene = scene.device_put()

    def trace(o, d):
        return trace_rays(dscene.bvh, dscene.geometry, o, d)["tri"]

    origins, dirs = generate_rays(cam.inv_projection, cam.inv_view,
                                  cam.width, cam.height, xp=np)
    o = jnp.asarray(origins, jnp.float32)
    d = jnp.asarray(dirs, jnp.float32)
    pixel_ids = jnp.arange(cam.width * cam.height, dtype=jnp.uint32)
    state = jax.tree_util.tree_map(
        jnp.asarray, restir_gi.init_state(cam.width * cam.height))
    ppv = jnp.asarray(cam.prev_proj_view)
    acc = jnp.zeros((cam.width * cam.height, 3), jnp.float32)
    for f in (1, 2):
        hdr, state = restir_gi.render_restir_gi(
            dscene, trace, o, d, pixel_ids, jnp.uint32(f), settings, state,
            cam.width, cam.height, ppv)
        acc = acc + hdr
    got = np.asarray(acc) / 2

    diff = np.abs(got - want)
    assert (diff.max(axis=-1) > 1e-2).mean() < 0.02
    assert float(np.median(diff)) < 1e-4


def test_renderer_restir_matches_oracle_end_to_end(scene_and_cam):
    """Full Renderer orchestration (stateful jit step, device tracer)
    vs oracle.render_oracle_restir at matched seeds and frame count."""
    from fypraytracer_tpu.oracle.cpu_renderer import render_oracle_restir
    from fypraytracer_tpu.render.renderer import Renderer

    scene, cam = scene_and_cam
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_DI,
                              light_candidates=4, spatial_neighbors=2,
                              spatial_radius=6)
    want = render_oracle_restir(scene, cam, settings, 3)
    r = Renderer(scene, cam, settings)
    for _ in range(3):
        got = r.render_hdr()
    got = np.asarray(got)
    diff = np.abs(got - want)
    assert (diff.max(axis=-1) > 1e-2).mean() < 0.02
    assert float(np.median(diff)) < 1e-4
