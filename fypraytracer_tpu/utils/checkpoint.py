"""Checkpoint / resume — long offline renders survive restarts.

The reference has no checkpointing (SURVEY.md §5): its accumulation buffer
round-trips through host memory every frame and a crash loses the render.
Here the full render state — accumulation buffer, frame index, ReSTIR
reservoir/G-buffer state, camera matrices, settings — is saved with Orbax
(JAX's checkpointing library) and restored into a ``Renderer``,
enabling elastic restarts of multi-hour equal-time benchmark runs
(the reference's default budget is 120 min, WalnutApp.cpp:23).

Falls back to ``np.savez`` when Orbax is unavailable (e.g. minimal CI).
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax
import numpy as np

from fypraytracer_tpu.config import RenderSettings, SamplingTechnique


def _flatten_state(renderer) -> dict:
    state = {"accum": np.asarray(renderer.accum),
             "frame_index": np.int64(renderer.frame_index)}
    # ReSTIR reservoir/G-buffer state pytree
    if renderer.aux_state is not None:
        leaves = jax.tree_util.tree_leaves(renderer.aux_state)
        for i, leaf in enumerate(leaves):
            state[f"aux_{i}"] = np.asarray(leaf)
    return state


def save_checkpoint(path: str, renderer) -> None:
    """Save renderer state + settings + camera to ``path`` (a directory)."""
    os.makedirs(path, exist_ok=True)
    state = _flatten_state(renderer)
    try:
        import orbax.checkpoint as ocp

        ckpt = ocp.PyTreeCheckpointer()
        ckpt.save(os.path.join(os.path.abspath(path), "state"), state,
                  force=True)
    except Exception:
        np.savez(os.path.join(path, "state.npz"), **state)

    meta = {
        # the renderer class is part of the state layout; load_checkpoint
        # refuses a checkpoint written by any other implementation
        "renderer": {"class": type(renderer).__name__},
        "settings": {k: (int(v) if isinstance(v, SamplingTechnique) else v)
                     for k, v in dataclasses.asdict(renderer.settings).items()},
        "camera": {
            "position": renderer.camera.position.tolist(),
            "forward": renderer.camera.forward.tolist(),
            "vfov_deg": renderer.camera.vfov_deg,
            "near": renderer.camera.near,
            "far": renderer.camera.far,
            "width": renderer.camera.width,
            "height": renderer.camera.height,
        },
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_checkpoint(path: str, scene):
    """Rebuild a ``render.renderer.Renderer`` from a checkpoint directory
    + compiled scene.  A checkpoint written by another renderer class (such
    as the fused TPU kernels this package once had) raises ``ValueError``:
    its state planes do not fit the wavefront renderer's layout."""
    import jax.numpy as jnp

    from fypraytracer_tpu.core.camera import Camera
    from fypraytracer_tpu.render.renderer import Renderer

    meta = json.load(open(os.path.join(path, "meta.json")))
    saved_cls = meta.get("renderer", {}).get("class", Renderer.__name__)
    if saved_cls != Renderer.__name__:
        raise ValueError(
            f"checkpoint at {path} was written by {saved_cls}, not "
            f"{Renderer.__name__}; its state layout cannot be resumed")
    s = dict(meta["settings"])
    s["technique"] = SamplingTechnique(s["technique"])
    s["sky_color"] = tuple(s["sky_color"])
    settings = RenderSettings(**s)
    cam = Camera(**meta["camera"])

    npz = os.path.join(path, "state.npz")
    if os.path.exists(npz):
        state = dict(np.load(npz))
    else:
        import orbax.checkpoint as ocp

        ckpt = ocp.PyTreeCheckpointer()
        state = ckpt.restore(os.path.join(os.path.abspath(path), "state"))

    r = Renderer(scene, cam, settings)
    r.accum = jnp.asarray(state["accum"])
    r.frame_index = int(state["frame_index"])
    if r.aux_state is not None:
        leaves, treedef = jax.tree_util.tree_flatten(r.aux_state)
        restored = [jnp.asarray(state[f"aux_{i}"]) for i in range(len(leaves))]
        r.aux_state = jax.tree_util.tree_unflatten(treedef, restored)
    return r
