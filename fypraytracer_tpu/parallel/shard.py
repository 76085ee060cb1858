"""Multi-chip rendering & training — pixel-tile data parallelism on a
``jax.sharding.Mesh``.

The reference's entire parallelism story is a single-GPU 2D CUDA grid, one
thread per pixel (Renderer.cu:80-84; SURVEY.md §2.7).  The multi-device
mapping: pixels are the data-parallel axis, sharded across the cards;
the scene (geometry, BVH, light tree, materials, textures) is replicated;
gradients of shared parameters are combined with ``psum``; the assembled
image is an ``all_gather`` (or left sharded for sharded IO).

Everything routes through ``shard_map`` so collectives are explicit and
the per-shard body is exactly the single-chip wavefront code — no separate
multi-chip implementation to keep in sync.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fypraytracer_tpu.core.camera import generate_rays
from fypraytracer_tpu.ops.dense import pick_tracer
from fypraytracer_tpu.render.integrators import radiance_hemisphere, radiance_nee_mis
from fypraytracer_tpu.scene.types import Scene


def make_pixel_mesh(devices=None, axis: str = "px") -> Mesh:
    """1D device mesh over the pixel (data-parallel) axis."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (axis,))


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Upload the scene replicated on every chip (the reference re-uploads
    on dirty only, Renderer.cu:62-69; here upload happens once)."""
    sharding = NamedSharding(mesh, P())
    return scene.device_put(sharding)


def sharded_render(scene: Scene, mesh: Mesh, width: int, height: int,
                   settings, technique_sampler: str = "cosine", axis: str = "px"):
    """Build a pjit-ed frame renderer with pixels sharded over ``mesh``.

    Returns ``render(inv_projection, inv_view, frame) -> (H*W, 3) hdr``
    (sharded over rows).  H*W must divide by mesh size.
    """
    n_dev = mesh.devices.size
    n_pix = width * height
    assert n_pix % n_dev == 0, f"{n_pix} pixels not divisible by {n_dev} devices"

    def body(scene_rep, inv_proj, inv_view, frame, pixel_ids):
        # pixel_ids: this shard's slice of the global pixel index space
        ys = pixel_ids // width
        xs = pixel_ids % width
        origins, directions = generate_rays(inv_proj, inv_view, width, height,
                                            xp=jnp, pixel_x=xs, pixel_y=ys)

        trace = pick_tracer(scene_rep, settings.tracer)

        return radiance_hemisphere(scene_rep, trace, origins, directions,
                                   pixel_ids.astype(jnp.uint32), frame,
                                   settings, technique_sampler)

    # check_vma=False: the Triton tracer's pallas_call results carry no
    # varying-mesh-axes annotation, which the check would reject
    shard_body = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis)),
        out_specs=P(axis), check_vma=False)

    @jax.jit
    def render(inv_proj, inv_view, frame):
        pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
        return shard_body(scene, inv_proj, inv_view, frame.astype(jnp.uint32),
                          pixel_ids)

    return render


# ---------------------------------------------------------------------------
# Differentiable training step (inverse rendering), data-parallel
# ---------------------------------------------------------------------------


def psum_loss_and_grads(loss, grads, axis: str):
    """Sum a per-shard loss and its parameter gradients over ``axis``
    (float leaves only: integer leaves carry float0 gradients)."""
    grads = jax.tree_util.tree_map(
        lambda g: (jax.lax.psum(g, axis)
                   if jnp.issubdtype(g.dtype, jnp.floating) else g), grads)
    return jax.lax.psum(loss, axis), grads


def make_train_step(scene: Scene, mesh: Mesh, width: int, height: int,
                    settings, lr: float = 0.05, axis: str = "px",
                    technique: str = "nee", optimizer=None):
    """Data-parallel inverse-rendering step: optimize material parameters
    to match a target image.

    The differentiable path (SURVEY.md §7 step 7): radiance w.r.t. material
    albedo/roughness/metallic/emission with discrete hit/light selections
    detached.  Per-shard losses and gradients are ``psum``-reduced across
    cards — the
    all-reduce the reference never needed single-GPU (§2.7 table).
    For gradients through the ReSTIR DI reservoir estimator use
    ``parallel.restir_shard.make_restir_di_train_step``.

    ``optimizer``: an optax GradientTransformation (e.g. ``optax.adam``);
    None = plain SGD at ``lr``.  With an optimizer the returned step is
    ``step(params, opt_state, ...) -> (new_params, new_opt_state, loss)``
    and ``make_train_step`` returns ``(step, init_opt_state)``.

    Returns ``step(params, inv_proj, inv_view, frame, target) ->
    (new_params, loss)`` — jit-compiled over the mesh.
    """
    n_dev = mesh.devices.size
    n_pix = width * height
    assert n_pix % n_dev == 0

    def shard_loss(params, scene_rep, inv_proj, inv_view, frame, pixel_ids, target):
        scene_p = dataclasses.replace(scene_rep, materials=params)
        ys = pixel_ids // width
        xs = pixel_ids % width
        origins, directions = generate_rays(inv_proj, inv_view, width, height,
                                            xp=jnp, pixel_x=xs, pixel_y=ys)

        trace = pick_tracer(scene_p, settings.tracer)

        if technique == "nee":
            hdr = radiance_nee_mis(scene_p, trace, origins, directions,
                                   pixel_ids.astype(jnp.uint32), frame, settings)
        else:
            hdr = radiance_hemisphere(scene_p, trace, origins, directions,
                                      pixel_ids.astype(jnp.uint32), frame,
                                      settings, technique)
        err = hdr - target
        # this shard's share of the mean over the GLOBAL pixel dim; the
        # caller psums loss and gradients (shard_map runs unchecked, so a
        # psum inside the differentiated loss would not be transposed
        # into a gradient sum)
        return jnp.sum(err * err) / (n_pix * 3)

    def _float_mask_update(params, upd):
        return jax.tree_util.tree_map(
            lambda p, u: (p + u).astype(p.dtype)
            if jnp.issubdtype(p.dtype, jnp.floating) else p,
            params, upd)

    def _zero_int_grads(params, grads):
        # allow_int grads of int leaves come back as float0 — replace with
        # float zeros so optax transforms can consume the tree
        return jax.tree_util.tree_map(
            lambda p, g: (g if jnp.issubdtype(p.dtype, jnp.floating)
                          else jnp.zeros_like(p, jnp.float32)),
            params, grads)

    def _floatify(params):
        # optax-consumable mirror of the param tree: int leaves (the
        # albedo_map ids) become float32 zeros; their updates are dropped
        # by _float_mask_update anyway
        return jax.tree_util.tree_map(
            lambda x: (jnp.asarray(x) if jnp.issubdtype(
                jnp.asarray(x).dtype, jnp.floating)
                else jnp.zeros_like(jnp.asarray(x), jnp.float32)), params)

    def shard_step(params, opt_state, scene_rep, inv_proj, inv_view, frame,
                   pixel_ids, target):
        # allow_int: the material table carries int albedo_map ids (their
        # float0 grads are ignored by the float-only update below)
        loss, grads = jax.value_and_grad(shard_loss, allow_int=True)(
            params, scene_rep, inv_proj, inv_view, frame, pixel_ids, target)
        loss, grads = psum_loss_and_grads(loss, grads, axis)
        if optimizer is None:
            new_params = jax.tree_util.tree_map(
                lambda p, g: (p - lr * g).astype(p.dtype)
                if jnp.issubdtype(p.dtype, jnp.floating) else p,
                params, grads)
            return new_params, opt_state, loss
        upd, new_opt = optimizer.update(_zero_int_grads(params, grads),
                                        opt_state, _floatify(params))
        return _float_mask_update(params, upd), new_opt, loss

    if optimizer is None:
        sharded = jax.shard_map(
            shard_step, mesh=mesh,
            in_specs=(P(), P(), P(), P(), P(), P(), P(axis), P(axis)),
            out_specs=(P(), P(), P()), check_vma=False)

        @jax.jit
        def step(params, inv_proj, inv_view, frame, target):
            pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
            p, _, loss = sharded(params, 0, scene, inv_proj, inv_view,
                                 frame.astype(jnp.uint32), pixel_ids, target)
            return p, loss

        return step

    opt_spec = jax.tree_util.tree_map(
        lambda _: P(),
        jax.eval_shape(lambda: optimizer.init(_floatify(scene.materials))))
    sharded = jax.shard_map(
        shard_step, mesh=mesh,
        in_specs=(P(), opt_spec, P(), P(), P(), P(), P(axis), P(axis)),
        out_specs=(P(), opt_spec, P()), check_vma=False)

    @jax.jit
    def step_opt(params, opt_state, inv_proj, inv_view, frame, target):
        pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
        return sharded(params, opt_state, scene, inv_proj, inv_view,
                       frame.astype(jnp.uint32), pixel_ids, target)

    def init_opt_state(params):
        return optimizer.init(_floatify(params))

    return step_opt, init_opt_state
