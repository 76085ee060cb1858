"""Dense-trace measurements on a GPU: the Triton kernel against the XLA
dense path and the BVH walk.

    python benchmarks/dense_trace.py [--out FILE]

Prints one JSON line per measurement (and appends them to ``--out``):

  frame      Cornell 1920x1088 NEE+MIS, 2 bounces: ms/frame through
             ``Renderer.render_many`` with each tracer forced
             (kernel / XLA dense at Precision.HIGHEST / BVH walk);
  trace      1920x1088 primary rays plus one diffuse bounce on Cornell:
             ms per trace call for each tracer;
  config     the same trace with other kernel block sizes;
  crossover  the same ray set on ``stress()`` lattices of ~8k to ~33k
             triangles: kernel against BVH walk (sets DENSE_MAX_TRIS).

Times are host-clock medians over repeated calls ended by
``block_until_ready``, after a warm call.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H = 1920, 1088
SKY = (0.05, 0.06, 0.08)


def _median_s(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _rays(scene, cam):
    """Primary rays plus one diffuse bounce from their hits (missed
    primaries re-trace themselves)."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.core.camera import generate_rays
    from fypraytracer_tpu.ops.traverse import trace_rays

    g = scene.geometry

    @jax.jit
    def make():
        o, d = generate_rays(jnp.asarray(cam.inv_projection),
                             jnp.asarray(cam.inv_view), W, H, xp=jnp)
        hit = trace_rays(scene.bvh, g, o, d)
        p = g.positions[g.tri_v[jnp.maximum(hit["tri"], 0)]]
        n = jnp.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
        n = jnp.where((n * d).sum(-1, keepdims=True) > 0, -n, n)
        r = jax.random.normal(jax.random.PRNGKey(0), d.shape)
        b = n + r / jnp.linalg.norm(r, axis=-1, keepdims=True)
        b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
        ok = (hit["tri"] >= 0)[:, None]
        x = o + hit["t"][:, None] * d + 1e-3 * n
        return (jnp.concatenate([o, jnp.where(ok, x, o)]),
                jnp.concatenate([d, jnp.where(ok, b, d)]))

    return make()


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also append JSON lines here")
    ap.add_argument("--parts", default="frame,trace,config,crossover",
                    help="comma list of the measurements to take")
    args = ap.parse_args()

    import jax

    from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu.ops.dense import trace_rays_dense
    from fypraytracer_tpu.ops.traverse import trace_rays
    from fypraytracer_tpu.ops.triton_dense import trace_rays_triton
    from fypraytracer_tpu.render.renderer import Renderer
    from fypraytracer_tpu.scene.procedural import cornell_box, stress
    from fypraytracer_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("dense_trace.py measures a GPU; JAX has none")
    enable_compile_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    base = {"card": card, "device_kind": jax.devices()[0].device_kind}

    def emit(rec):
        line = json.dumps({**base, **rec})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    builder, cam = cornell_box(width=W, height=H)
    scene = builder.compile().device_put()
    n_tris = int(scene.geometry.tri_v.shape[0])

    parts = set(args.parts.split(","))
    if "frame" in parts:
        for tracer in ("pallas", "dense", "bvh", "pallas"):
            settings = RenderSettings(technique=SamplingTechnique.NEE_MIS,
                                      bounces=2, samples=1, sky_color=SKY,
                                      tracer=tracer)
            r = Renderer(scene, cam, settings)
            t0 = time.perf_counter()
            jax.block_until_ready(r.render_many(4))
            compile_s = time.perf_counter() - t0
            s = _median_s(r.render_many, 4, reps=3) / 4
            emit({"kind": "frame", "scene": "cornell", "tris": n_tris,
                  "res": f"{W}x{H}", "technique": "NEE_MIS", "bounces": 2,
                  "tracer": tracer, "ms_per_frame": s * 1e3,
                  "first_call_s": compile_s})

    o, d = _rays(scene, cam)
    n_rays = int(o.shape[0])
    g = scene.geometry
    fns = {
        "kernel": jax.jit(lambda o, d: trace_rays_triton(g, o, d)),
        "xla_dense_highest": jax.jit(lambda o, d: trace_rays_dense(g, o, d)),
        "bvh_walk": jax.jit(lambda o, d: trace_rays(scene.bvh, g, o, d)),
    }
    for name, fn in fns.items() if "trace" in parts else ():
        emit({"kind": "trace", "scene": "cornell", "tris": n_tris,
              "rays": n_rays, "tracer": name,
              "ms": _median_s(fn, o, d) * 1e3})

    configs = ((32, 32, 4, 2), (64, 16, 4, 2), (64, 16, 4, 3), (64, 16, 2, 2),
               (64, 8, 4, 2), (32, 16, 4, 2), (64, 32, 4, 2), (128, 16, 4, 2))
    for rb, tt, nw, ns in configs if "config" in parts else ():
        fn = jax.jit(functools.partial(
            lambda o, d, **kw: trace_rays_triton(g, o, d, **kw),
            ray_block=rb, tri_tile=tt, num_warps=nw, num_stages=ns))
        try:
            ms = _median_s(fn, o, d) * 1e3
        except Exception as exc:  # a block shape the compiler refuses
            emit({"kind": "config", "ray_block": rb, "tri_tile": tt,
                  "num_warps": nw, "num_stages": ns,
                  "error": f"{type(exc).__name__}: {str(exc)[:200]}"})
            continue
        emit({"kind": "config", "ray_block": rb, "tri_tile": tt,
              "num_warps": nw, "num_stages": ns, "rays": n_rays, "ms": ms})

    sizes = ((2, (16, 32)), (2, (24, 32)), (2, (32, 32)), (2, (40, 32)),
             (2, (48, 32)), (4, (16, 32)))
    for grid, res in sizes if "crossover" in parts else ():
        b, c = stress(width=W, height=H, grid=grid, sphere_res=res)
        sc = b.compile().device_put()
        so, sd = _rays(sc, c)
        sg = sc.geometry
        for name, fn in (
                ("kernel", jax.jit(lambda o, d: trace_rays_triton(sg, o, d))),
                ("bvh_walk", jax.jit(
                    lambda o, d: trace_rays(sc.bvh, sg, o, d)))):
            emit({"kind": "crossover", "scene": f"stress grid={grid} "
                  f"res={res}", "tris": int(sg.tri_v.shape[0]),
                  "rays": int(so.shape[0]), "tracer": name,
                  "ms": _median_s(fn, so, sd, reps=3) * 1e3})


if __name__ == "__main__":
    main()
