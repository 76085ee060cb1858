"""Sharded ReSTIR DI (halo exchange over the device mesh) must match the
single-chip renderer at matched seeds.

The single-chip reference is computed with the same in-jit ray generation
as the sharded body (host-computed rays differ in final-ulp rounding,
which reservoir accept decisions amplify chaotically across frames)."""

import numpy as np
import pytest

from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu.scene.procedural import cornell_box


@pytest.mark.parametrize("n_devices", [2, 8])
def test_sharded_render_matches_single_device(n_devices):
    """Pixel-sharded cosine render (scene replicated, rows sharded) equals
    the same frame on one device: the per-shard body is the single-device
    wavefront and the RNG keys on the global pixel id."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.parallel.shard import (make_pixel_mesh,
                                                 replicate_scene,
                                                 sharded_render)

    width = height = 32
    builder, cam = cornell_box(width=width, height=height, sphere_res=(6, 10))
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.COSINE, bounces=2,
                              sky_color=(0.1, 0.15, 0.2))
    ip = jnp.asarray(cam.inv_projection)
    iv = jnp.asarray(cam.inv_view)

    one = make_pixel_mesh(jax.devices()[:1])
    ref = sharded_render(replicate_scene(scene, one), one, width, height,
                         settings, "cosine")(ip, iv, jnp.uint32(3))
    mesh = make_pixel_mesh(jax.devices()[:n_devices])
    got = sharded_render(replicate_scene(scene, mesh), mesh, width, height,
                         settings, "cosine")(ip, iv, jnp.uint32(3))
    assert got.sharding.shard_shape(got.shape)[0] == width * height // n_devices
    ref, got = np.asarray(ref), np.asarray(got)
    assert np.isfinite(got).all() and got.mean() > 1e-3
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_sharded_nee_train_step_big_scene():
    """Sharded NEE train step on a scene above DENSE_MAX_TRIS (the BVH
    walk inside shard_map): finite loss, albedo moves, and the step
    matches the same step on one device."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.ops.dense import DENSE_MAX_TRIS
    from fypraytracer_tpu.parallel.shard import (make_pixel_mesh,
                                                 make_train_step,
                                                 replicate_scene)
    from fypraytracer_tpu.scene.procedural import stress

    width = height = 16
    # 2 layers of grid² spheres of 2·16·32 triangles each
    grid = int(np.ceil(np.sqrt(DENSE_MAX_TRIS / (2 * 2 * 16 * 32)))) + 1
    builder, cam = stress(width=width, height=height, grid=grid,
                          sphere_res=(16, 32))
    scene = builder.compile()
    assert scene.geometry.tri_v.shape[0] > DENSE_MAX_TRIS
    settings = RenderSettings(technique=SamplingTechnique.NEE_MIS, bounces=1,
                              sky_color=(0.05, 0.06, 0.08))
    ip = jnp.asarray(cam.inv_projection)
    iv = jnp.asarray(cam.inv_view)
    target = jnp.zeros((width * height, 3), jnp.float32)

    outs = []
    for n in (1, 4):
        mesh = make_pixel_mesh(jax.devices()[:n])
        scene_r = replicate_scene(scene, mesh)
        step = make_train_step(scene_r, mesh, width, height, settings,
                               lr=1.0)
        p, loss = step(scene_r.materials, ip, iv, jnp.uint32(1), target)
        outs.append((np.asarray(p.albedo), float(loss)))
    (a1, l1), (a4, l4) = outs
    assert np.isfinite(l1) and l1 > 0.0
    assert np.abs(a1 - np.asarray(scene.materials.albedo)).max() > 0.0
    np.testing.assert_allclose(l4, l1, rtol=1e-4)
    np.testing.assert_allclose(a4, a1, atol=1e-5)


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_sharded_restir_di_matches_single_chip(n_devices):
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.core.camera import generate_rays
    from fypraytracer_tpu.ops.dense import pick_tracer
    from fypraytracer_tpu.parallel.restir_shard import make_restir_di_sharded
    from fypraytracer_tpu.parallel.shard import make_pixel_mesh, replicate_scene
    from fypraytracer_tpu.render import restir_di

    width = height = 64
    builder, cam = cornell_box(width=width, height=height, with_spheres=False)
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_DI,
                              light_candidates=4, spatial_neighbors=3,
                              spatial_radius=height // n_devices - 1)

    dscene = scene.device_put()
    ip = jnp.asarray(cam.inv_projection)
    iv = jnp.asarray(cam.inv_view)
    ppv = jnp.asarray(cam.prev_proj_view)

    @jax.jit
    def ref_step(frame, state):
        pix = jnp.arange(width * height, dtype=jnp.int32)
        o, d = generate_rays(ip, iv, width, height, xp=jnp,
                             pixel_x=pix % width, pixel_y=pix // width)
        trace = pick_tracer(dscene, settings.tracer)
        return restir_di.render_restir_di(dscene, trace, o, d,
                                          pix.astype(jnp.uint32), frame,
                                          settings, state, width, height, ppv)

    st = jax.tree_util.tree_map(jnp.asarray,
                                restir_di.init_state(width * height))
    ref_acc = np.zeros((width * height, 3), np.float32)
    for f in (1, 2, 3):
        hdr, st = ref_step(jnp.uint32(f), st)
        ref_acc += np.asarray(hdr)

    mesh = make_pixel_mesh(jax.devices()[:n_devices])
    scene_r = replicate_scene(scene, mesh)
    step, init_state = make_restir_di_sharded(scene_r, mesh, width, height,
                                              settings)
    state = init_state()
    got_acc = np.zeros((width * height, 3), np.float32)
    for f in (1, 2, 3):
        hdr, state = step(ip, iv, ppv, jnp.uint32(f), state)
        got_acc += np.asarray(hdr)

    diff = np.abs(got_acc - ref_acc)
    assert float(np.median(diff)) < 1e-6
    # fusion-level float reassociation can still flip razor-thin accepts
    # on isolated pixels; require statistical + overwhelming agreement
    assert (diff.max(axis=-1) > 1e-3).mean() < 0.03, diff.max()
    assert abs(got_acc.mean() - ref_acc.mean()) / ref_acc.mean() < 0.01


@pytest.mark.parametrize("n_devices", [4])
def test_sharded_restir_gi_matches_single_chip(n_devices):
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.core.camera import generate_rays
    from fypraytracer_tpu.ops.dense import pick_tracer
    from fypraytracer_tpu.parallel.restir_shard import make_restir_gi_sharded
    from fypraytracer_tpu.parallel.shard import make_pixel_mesh, replicate_scene
    from fypraytracer_tpu.render import restir_gi

    width = height = 64
    builder, cam = cornell_box(width=width, height=height, with_spheres=False)
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_GI,
                              bounces=2, spatial_neighbors=3,
                              spatial_radius=height // n_devices - 1)

    dscene = scene.device_put()
    ip = jnp.asarray(cam.inv_projection)
    iv = jnp.asarray(cam.inv_view)
    ppv = jnp.asarray(cam.prev_proj_view)

    @jax.jit
    def ref_step(frame, state):
        pix = jnp.arange(width * height, dtype=jnp.int32)
        o, d = generate_rays(ip, iv, width, height, xp=jnp,
                             pixel_x=pix % width, pixel_y=pix // width)
        trace = pick_tracer(dscene, settings.tracer)
        return restir_gi.render_restir_gi(dscene, trace, o, d,
                                          pix.astype(jnp.uint32), frame,
                                          settings, state, width, height, ppv)

    st = jax.tree_util.tree_map(jnp.asarray,
                                restir_gi.init_state(width * height))
    ref_acc = np.zeros((width * height, 3), np.float32)
    for f in (1, 2):
        hdr, st = ref_step(jnp.uint32(f), st)
        ref_acc += np.asarray(hdr)

    mesh = make_pixel_mesh(jax.devices()[:n_devices])
    scene_r = replicate_scene(scene, mesh)
    step, init_state = make_restir_gi_sharded(scene_r, mesh, width, height,
                                              settings)
    state = init_state()
    got_acc = np.zeros((width * height, 3), np.float32)
    for f in (1, 2):
        hdr, state = step(ip, iv, ppv, jnp.uint32(f), state)
        got_acc += np.asarray(hdr)

    diff = np.abs(got_acc - ref_acc)
    assert float(np.median(diff)) < 1e-6
    assert (diff.max(axis=-1) > 1e-3).mean() < 0.03, diff.max()
    assert abs(got_acc.mean() - ref_acc.mean()) / max(ref_acc.mean(), 1e-9) < 0.02


def test_sharded_restir_di_moving_camera_matches_single_chip():
    """Moving camera: temporal reprojection crosses shard boundaries; the
    temporal state halo must make the sharded result match the
    single-chip one for motion within `radius` rows (VERDICT r1 #6)."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.core.camera import Camera, generate_rays
    from fypraytracer_tpu.ops.dense import pick_tracer
    from fypraytracer_tpu.parallel.restir_shard import make_restir_di_sharded
    from fypraytracer_tpu.parallel.shard import make_pixel_mesh, replicate_scene
    from fypraytracer_tpu.render import restir_di

    width = height = 64
    n_devices = 4
    builder, cam = cornell_box(width=width, height=height, with_spheres=False)
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_DI,
                              light_candidates=4, spatial_neighbors=3,
                              spatial_radius=12)

    # per-frame camera poses: pan up slightly each frame (sub-halo motion)
    poses = []
    c = Camera(position=(0.0, 1.0, 2.6), forward=(0.0, 0.0, -1.0),
               vfov_deg=45.0, width=width, height=height)
    for f in range(3):
        c2 = Camera(position=(0.0, 1.0 + 0.05 * f, 2.6),
                    forward=(0.0, 0.0, -1.0), vfov_deg=45.0,
                    width=width, height=height)
        poses.append((jnp.asarray(c2.inv_projection),
                      jnp.asarray(c2.inv_view),
                      jnp.asarray(c2.proj_view)))
    # frame f renders pose f with ppv = pose f-1 (frame 0's ppv unused:
    # fresh reservoirs have m == 0)
    frames = [(poses[f][0], poses[f][1],
               poses[max(f - 1, 0)][2]) for f in range(3)]

    dscene = scene.device_put()

    @jax.jit
    def ref_step(ip, iv, ppv, frame, state):
        pix = jnp.arange(width * height, dtype=jnp.int32)
        o, d = generate_rays(ip, iv, width, height, xp=jnp,
                             pixel_x=pix % width, pixel_y=pix // width)
        trace = pick_tracer(dscene, settings.tracer)
        return restir_di.render_restir_di(dscene, trace, o, d,
                                          pix.astype(jnp.uint32), frame,
                                          settings, state, width, height, ppv)

    st = jax.tree_util.tree_map(jnp.asarray,
                                restir_di.init_state(width * height))
    ref_acc = np.zeros((width * height, 3), np.float32)
    for f, (ip, iv, ppv) in enumerate(frames, start=1):
        hdr, st = ref_step(ip, iv, ppv, jnp.uint32(f), st)
        ref_acc += np.asarray(hdr)

    mesh = make_pixel_mesh(jax.devices()[:n_devices])
    scene_r = replicate_scene(scene, mesh)
    step, init_state = make_restir_di_sharded(scene_r, mesh, width, height,
                                              settings)
    state = init_state()
    got_acc = np.zeros((width * height, 3), np.float32)
    for f, (ip, iv, ppv) in enumerate(frames, start=1):
        hdr, state = step(ip, iv, ppv, jnp.uint32(f), state)
        got_acc += np.asarray(hdr)

    diff = np.abs(got_acc - ref_acc)
    assert float(np.median(diff)) < 1e-6
    assert (diff.max(axis=-1) > 1e-3).mean() < 0.03, diff.max()
    assert abs(got_acc.mean() - ref_acc.mean()) / ref_acc.mean() < 0.01
