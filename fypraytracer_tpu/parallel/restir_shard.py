"""Sharded ReSTIR — spatiotemporal reuse across pixel-shard boundaries.

The reference's ReSTIR spatial reuse reads random neighbors within a
30-pixel radius in a single GPU's memory (Renderer.cu:1913-1941).  Under
multi-chip pixel sharding those reads cross shard boundaries; SURVEY.md
§2.7/§5 maps this to **halo exchange between devices**.

Implementation: the image is sharded by pixel *rows* across the mesh.
Stage 1 (candidates + temporal) first halo-exchanges the PREVIOUS frame's
state by ``radius`` rows, so temporal reprojection under a moving camera
(prev view/proj, Renderer.cu:1750-1765) reads exact history for motion up
to ``radius`` rows across the shard boundary; reprojections landing
beyond the halo read reservoirs with m forced to 0, which the temporal
merge rejects exactly (history is dropped, estimator stays unbiased — the
same fallback as a disocclusion).  Between stages each shard exchanges
``radius`` rows of its stage-1 output with both neighbors via
``jax.lax.ppermute`` (NCCL collectives on GPUs); stage 2's neighbor gathers then
index the local-plus-halo arrays, bit-compatible with the single-chip
renderer (identical RNG offsets; |dy| <= radius by construction, so every
drawable neighbor is inside the halo).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from fypraytracer_tpu.core.camera import generate_rays
from fypraytracer_tpu.core.mathutils import encode_octahedral
from fypraytracer_tpu.ops.dense import pick_tracer
from fypraytracer_tpu.parallel.shard import psum_loss_and_grads
from fypraytracer_tpu.render import restir_di


def _halo_exchange(x, halo_elems: int, axis: str):
    """Concatenate [tail of up-neighbor, x, head of down-neighbor].

    Edge shards receive zero-filled halos (their reservoirs carry m == 0,
    so merges reject them, matching clamped out-of-image neighbors).
    """
    n = jax.lax.psum(1, axis)
    idx = jax.lax.axis_index(axis)
    up = [(i, (i - 1) % n) for i in range(n)]     # our head -> their bottom halo
    down = [(i, (i + 1) % n) for i in range(n)]   # our tail -> their top halo

    head = jax.lax.slice_in_dim(x, 0, halo_elems, axis=0)
    tail = jax.lax.slice_in_dim(x, x.shape[0] - halo_elems, x.shape[0], axis=0)

    from_below = jax.lax.ppermute(head, axis, up)
    from_above = jax.lax.ppermute(tail, axis, down)

    zero = jnp.zeros_like(from_above)
    from_above = jnp.where(idx == 0, zero, from_above)
    from_below = jnp.where(idx == n - 1, zero, from_below)
    return jnp.concatenate([from_above, x, from_below], axis=0)


class _Shifted:
    """Global-index view over a shard-local array: indexing clamps
    (idx - base) into the local extent.  part1/part2 index their inputs
    with global pixel ids, so shard-local arrays wear this shim."""

    def __init__(self, arr, base):
        self.arr = arr
        self.base = base

    def __getitem__(self, idx):
        local = jnp.clip(idx - self.base, 0, self.arr.shape[0] - 1)
        return self.arr[local]


class _ShiftedZeroOutside(_Shifted):
    """_Shifted that yields ZEROS for global indices outside the local
    (+halo) extent instead of clamped edge values.  Worn by reservoir
    ``m`` leaves so a temporal reprojection past the exchanged halo reads
    m == 0 and the merge rejects it exactly."""

    def __getitem__(self, idx):
        local = idx - self.base
        ok = (local >= 0) & (local < self.arr.shape[0])
        v = self.arr[jnp.clip(local, 0, self.arr.shape[0] - 1)]
        return jnp.where(ok, v, jnp.zeros_like(v))


def _shift_tree(tree, base):
    """Wrap every array leaf of a (possibly nested) state dict in a
    global-index shim."""
    if isinstance(tree, dict):
        return {k: _shift_tree(v, base) for k, v in tree.items()}
    return _Shifted(tree, base)


def _make_restir_body(width: int, height: int, settings, part1, part2,
                      pack_state, axis: str, n_dev: int):
    """The per-shard ReSTIR frame body (halo exchanges + part1/part2),
    shared by the renderer (`_make_restir_sharded`) and the differentiable
    train step (`make_restir_di_train_step`)."""
    assert height % n_dev == 0, f"height {height} not divisible by {n_dev}"
    rows = height // n_dev
    radius = int(settings.spatial_radius)
    assert radius <= rows, (
        f"spatial radius {radius} exceeds shard rows {rows}; "
        "use fewer devices or a smaller radius")
    halo = radius * width

    def shard_step(scene_rep, inv_proj, inv_view, ppv, frame, pixel_ids, state):
        trace = pick_tracer(scene_rep, settings.tracer)
        ys = pixel_ids // width
        xs = pixel_ids % width
        origins, directions = generate_rays(inv_proj, inv_view, width, height,
                                            xp=jnp, pixel_x=xs, pixel_y=ys)

        shard_row0 = jax.lax.axis_index(axis) * rows

        # temporal halo: exchange `radius` rows of PREVIOUS-frame state so
        # moving-camera reprojection is exact across shard boundaries
        state_h = jax.tree_util.tree_map(
            lambda v: _halo_exchange(v, halo, axis), state)
        halo_base = (shard_row0 - radius) * width
        state_view = dict(state_h)
        state_view["normal_oct"] = _Shifted(state_h["normal_oct"], halo_base)
        rsv = _shift_tree(state_h["reservoir"], halo_base)
        rsv["m"] = _ShiftedZeroOutside(state_h["reservoir"]["m"], halo_base)
        state_view["reservoir"] = rsv
        g = part1(scene_rep, trace, origins, directions,
                  pixel_ids.astype(jnp.uint32), frame, settings, state_view,
                  width, height, ppv)

        # halo exchange of every stage-1 field
        g_halo = {k: _halo_exchange(v, halo, axis) for k, v in g.items()}

        # stage 2: halo row 0 corresponds to global row (shard_row0 - radius)
        halo_base = (shard_row0 - radius) * width
        full_view = {k: _Shifted(v, halo_base) for k, v in g_halo.items()}

        hdr, res = part2(scene_rep, trace, origins, directions,
                         pixel_ids.astype(jnp.uint32), frame, settings, g,
                         full_view, width, height)
        return hdr, pack_state(res, g)

    return shard_step


def _make_restir_sharded(scene, mesh: Mesh, width: int, height: int,
                         settings, module, part1, part2, pack_state,
                         axis: str = "px"):
    """Shared builder for sharded ReSTIR DI / GI (see make_* wrappers)."""
    n_dev = mesh.devices.size
    shard_step = _make_restir_body(width, height, settings, part1, part2,
                                   pack_state, axis, n_dev)

    state_specs = jax.tree_util.tree_map(
        lambda _: P(axis), module.init_state(1, xp=np))
    # check_vma=False: the Triton tracer's pallas_call results carry no
    # varying-mesh-axes annotation, which the check would reject (the CPU
    # tests lower the XLA dense tracer and never reach the kernel)
    sharded = jax.shard_map(
        shard_step, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(axis), state_specs),
        out_specs=(P(axis), state_specs), check_vma=False)

    @jax.jit
    def step(inv_proj, inv_view, ppv, frame, state):
        pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
        return sharded(scene, inv_proj, inv_view, ppv,
                       frame.astype(jnp.uint32), pixel_ids, state)

    def init_state():
        st = module.init_state(width * height, xp=np)
        sharding = jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, P(axis)), st)
        return jax.tree_util.tree_map(
            lambda x, s: jax.device_put(jnp.asarray(x), s), st, sharding)

    return step, init_state


def _di_pack_state(res, g):
    """DI double-buffer state layout (the single source: renderer AND
    train step share it, so a reservoir-field change cannot skew)."""
    return dict(
        reservoir=dict(index=res["index"], w=res["w"], pdf=res["pdf"],
                       wsum=res["wsum"], m=res["m"]),
        depth=g["t"],
        normal_oct=encode_octahedral(g["normal"]))


def _gi_pack_state(flat_res, g):
    """GI state layout (PathSample fields flattened with s_ prefixes)."""
    sample = {k[2:]: v for k, v in flat_res.items() if k.startswith("s_")}
    return dict(
        reservoir=dict(sample=sample, w=flat_res["w"], m=flat_res["m"],
                       wsum=flat_res["wsum"]),
        depth=g["t"],
        normal_oct=encode_octahedral(g["normal"]))


def make_restir_di_sharded(scene, mesh: Mesh, width: int, height: int,
                           settings, axis: str = "px"):
    """Sharded ReSTIR DI: ``(step, init_state)`` where ``step(inv_proj,
    inv_view, prev_proj_view, frame, state) -> (hdr row-sharded, state)``."""

    return _make_restir_sharded(scene, mesh, width, height, settings,
                                restir_di, restir_di.restir_di_part1,
                                restir_di.restir_di_part2, _di_pack_state,
                                axis)


def make_restir_di_train_step(scene, mesh: Mesh, width: int, height: int,
                              settings, lr: float = 0.05, axis: str = "px",
                              fields: tuple | None = None,
                              steps_per_call: int = 1, clip01: tuple = ()):
    """Differentiable ReSTIR DI: data-parallel inverse-rendering step
    through the reservoir estimator (the blueprint north-star capability —
    SURVEY.md §7 step 7 / hard-part #4; pass criteria BASELINE.md:39).

    Gradient design (validated vs central finite differences at matched
    seeds, tests/test_gradients.py::test_restir_di_*): the DISCRETE
    machinery — candidate indices, reservoir accept/merge decisions,
    neighbor picks, M/Z counts, visibility outcomes — is integer/boolean
    and carries no gradient by construction; the CONTINUOUS factors — the
    target-pdf p̂ evaluations feeding the RIS weight sums, the reservoir
    weight W = (1/p̂)·(wsum/M), and the final shade brdf·G·emission·W
    (Renderer.cu:1957-2031, the estimator being differentiated:
    Renderer.cu:1628-2041) — differentiate w.r.t. the material table
    (albedo, roughness, metallic, emission).  The incoming reservoir
    state is stop-gradient'ed: each step differentiates the single-frame
    estimator given the history, not the full frame recurrence (which
    would backprop through every previous frame's render).

    Returns ``(step, init_state)`` with
    ``step(params, inv_proj, inv_view, ppv, frame, state, target) ->
    (new_params, new_state, loss)`` — jit over the mesh, spatial/temporal
    halo exchanges differentiated through ``ppermute`` transposes, grads
    of the replicated params psum-combined after differentiation.
    """

    body = _make_restir_body(width, height, settings,
                             restir_di.restir_di_part1,
                             restir_di.restir_di_part2, _di_pack_state,
                             axis, mesh.devices.size)
    return _make_restir_train_step(scene, mesh, width, height, settings,
                                   body, restir_di.init_state, lr, axis,
                                   fields, steps_per_call, clip01)


def _make_restir_train_step(scene, mesh: Mesh, width: int, height: int,
                            settings, body, init_state_fn, lr: float,
                            axis: str, fields: tuple | None,
                            steps_per_call: int = 1,
                            clip01: tuple = ()):
    """Shared differentiable train-step builder over a ReSTIR body (see
    make_restir_di_train_step for the gradient design).

    ``steps_per_call`` > 1 runs that many SGD micro-steps inside ONE
    jitted dispatch via ``lax.scan`` (same frame/state realization each
    micro-step, matching the caller's fixed-seed loop) — one host round
    trip per group of steps, the training analog of ``render_many``.
    The returned loss is then a (steps_per_call,) vector."""
    import dataclasses as _dc

    n_pix = width * height

    def shard_loss(params, scene_rep, ip, iv, ppv, frame, pixel_ids, state,
                   target):
        scene_p = _dc.replace(scene_rep, materials=params)
        state = jax.lax.stop_gradient(state)
        hdr, new_state = body(scene_p, ip, iv, ppv, frame, pixel_ids, state)
        err = hdr - target
        # per-shard share; loss and grads are psum-ed by the caller
        return jnp.sum(err * err) / (n_pix * 3), new_state

    def shard_step(params, scene_rep, ip, iv, ppv, frame, pixel_ids, state,
                   target):
        (loss, new_state), grads = jax.value_and_grad(
            shard_loss, allow_int=True, has_aux=True)(
                params, scene_rep, ip, iv, ppv, frame, pixel_ids, state,
                target)
        loss, grads = psum_loss_and_grads(loss, grads, axis)
        # ``fields`` restricts the SGD update (e.g. ("albedo",)): the
        # material fields have very different curvature under this loss,
        # so a single lr across all of them is ill-conditioned
        names = (fields if fields is not None
                 else [f.name for f in _dc.fields(params)])
        upd = {}
        for name in names:
            p = getattr(params, name)
            g = getattr(grads, name)
            if jnp.issubdtype(p.dtype, jnp.floating):
                v = (p - lr * g).astype(p.dtype)
                # in-dispatch projection for box-constrained fields (the
                # caller cannot clip between scan micro-steps)
                upd[name] = jnp.clip(v, 0.0, 1.0) if name in clip01 else v
        new_params = _dc.replace(params, **upd)
        return new_params, new_state, loss

    if steps_per_call > 1:
        inner = shard_step

        def shard_step(params, scene_rep, ip, iv, ppv, frame, pixel_ids,
                       state, target):
            # carry (params, last_state); stacking every micro-step's
            # state would cost O(K * state) memory (800 MB at 1080p, K=10)
            def micro(carry, _):
                p, _unused = carry
                p2, new_state, loss = inner(p, scene_rep, ip, iv, ppv,
                                            frame, pixel_ids, state, target)
                return (p2, new_state), loss
            (params, last_state), losses = jax.lax.scan(
                micro, (params, state), None, length=steps_per_call)
            return params, last_state, losses

    state_specs = jax.tree_util.tree_map(
        lambda _: P(axis), init_state_fn(1, xp=np))
    sharded = jax.shard_map(
        shard_step, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(axis), state_specs,
                  P(axis)),
        out_specs=(P(), state_specs, P()), check_vma=False)

    @jax.jit
    def step(params, ip, iv, ppv, frame, state, target):
        pixel_ids = jnp.arange(n_pix, dtype=jnp.int32)
        return sharded(params, scene, ip, iv, ppv, frame.astype(jnp.uint32),
                       pixel_ids, state, target)

    def init_state():
        st = init_state_fn(n_pix, xp=np)
        sharding = jax.tree_util.tree_map(
            lambda _: NamedSharding(mesh, P(axis)), st)
        return jax.tree_util.tree_map(
            lambda x, s: jax.device_put(jnp.asarray(x), s), st, sharding)

    return step, init_state


def make_restir_gi_train_step(scene, mesh: Mesh, width: int, height: int,
                              settings, lr: float = 0.05, axis: str = "px",
                              fields: tuple | None = None,
                              steps_per_call: int = 1, clip01: tuple = ()):
    """Differentiable ReSTIR GI: inverse rendering through the path-sample
    reservoir estimator (Renderer.cu:2043-2387) — same detached-discrete
    design as :func:`make_restir_di_train_step`; the continuous factors
    (path throughput, sample radiance, p̂ = ‖L‖, reconnection shade term,
    W) differentiate, FD-validated in tests/test_gradients.py."""
    from fypraytracer_tpu.render import restir_gi

    body = _make_restir_body(width, height, settings,
                             restir_gi.restir_gi_part1,
                             restir_gi.restir_gi_part2, _gi_pack_state,
                             axis, mesh.devices.size)
    return _make_restir_train_step(scene, mesh, width, height, settings,
                                   body, restir_gi.init_state, lr, axis,
                                   fields, steps_per_call, clip01)


def make_restir_gi_sharded(scene, mesh: Mesh, width: int, height: int,
                           settings, axis: str = "px"):
    """Sharded ReSTIR GI (same halo pattern; stage-1 fields include the
    PathSample payload, flattened with s_ prefixes)."""
    from fypraytracer_tpu.render import restir_gi

    return _make_restir_sharded(scene, mesh, width, height, settings,
                                restir_gi, restir_gi.restir_gi_part1,
                                restir_gi.restir_gi_part2, _gi_pack_state,
                                axis)
