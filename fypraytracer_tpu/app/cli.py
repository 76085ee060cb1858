"""Headless CLI — the framework's app surface.

Replaces the reference's interactive Walnut/ImGui app (WalnutApp.cpp) with
three commands mirroring its workflows (SURVEY.md §7 step 9):

  render     one technique, fixed frame count or time budget, image +
             provenance filename (WalnutApp.cpp:780-910 offline mode)
  benchmark  all (or selected) techniques at equal time/frames, MSE/PSNR
             against a golden image or a long-run self-reference
             (the "Benchmark render results" button, WalnutApp.cpp:590-615)
  train      inverse rendering: fit material parameters to a target image
             (new capability; SURVEY.md §7 step 7)

Usage::

    python -m fypraytracer_tpu.app.cli render --scene cornell --technique
        nee --width 256 --height 256 --frames 64 -o out/
    python -m fypraytracer_tpu.app.cli benchmark --scene cornell --seconds 10
    python -m fypraytracer_tpu.app.cli train --scene cornell --steps 50
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from fypraytracer_tpu.config import RenderSettings, SamplingTechnique

_TECH = {
    "brute": SamplingTechnique.BRUTE_FORCE,
    "uniform": SamplingTechnique.UNIFORM,
    "cosine": SamplingTechnique.COSINE,
    "ggx": SamplingTechnique.GGX,
    "brdf": SamplingTechnique.BRDF,
    "light": SamplingTechnique.LIGHT_SOURCE,
    "nee": SamplingTechnique.NEE_MIS,
    "restir-di": SamplingTechnique.RESTIR_DI,
    "restir-gi": SamplingTechnique.RESTIR_GI,
}


def _load_scene(args):
    from fypraytracer_tpu.scene.sceneio import builtin_scene, load_scene_file

    if args.scene.endswith(".json"):
        builder, cam = load_scene_file(args.scene)
    else:
        builder, cam = builtin_scene(args.scene, args.width, args.height)
    cam.resize(args.width, args.height)
    return builder.compile(), cam


def _settings(args, technique) -> RenderSettings:
    return RenderSettings(
        technique=technique, bounces=args.bounces, samples=args.samples,
        sky_color=tuple(args.sky), light_candidates=args.candidates,
        spatial_neighbors=args.neighbors, spatial_radius=args.radius,
        temporal_history_limit=args.history)


def _render_run(scene, cam, settings, frames=None, seconds=None):
    """Accumulate frames; returns (avg_hdr, frames, avg_frame_ms).

    A ``frames`` budget renders through ``Renderer.render_many`` (one
    timed dispatch after a compile-and-warm batch that is then discarded);
    a ``seconds`` budget renders frame by frame until the time is up (the
    reference's equal-time protocol, WalnutApp.cpp:880-905)."""
    from fypraytracer_tpu.render.renderer import Renderer

    r = Renderer(scene, cam, settings)
    if frames is not None:
        np.asarray(r.render_many(frames))     # compile + warm
        r.reset()
        t0 = time.perf_counter()
        avg = np.asarray(r.render_many(frames))
        dt = time.perf_counter() - t0
        return avg, frames, dt / frames * 1000.0

    avg = r.render_hdr()
    np.asarray(avg)  # exclude compile from timing (forces completion)
    r.reset()
    t0 = time.perf_counter()
    n = 0
    while True:
        avg = r.render_hdr()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    avg = np.asarray(avg)
    dt = time.perf_counter() - t0
    return avg, n, dt / n * 1000.0


def _render_checkpointed(scene, cam, settings, frames, ckpt_dir, every):
    """Long-offline-render path: accumulate ``frames`` in ``every``-frame
    batches, checkpointing after each (utils/checkpoint.py — accumulation
    + frame index + ReSTIR reservoir state), resuming from ``ckpt_dir``
    if it already holds a checkpoint.  The reference's 120-min offline
    renders (WalnutApp.cpp:23,901-905) lose everything on a crash; here
    `cli render --checkpoint-dir D` survives restarts exactly."""
    from fypraytracer_tpu.render.renderer import Renderer
    from fypraytracer_tpu.utils.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    resumed = os.path.exists(os.path.join(ckpt_dir, "meta.json"))
    if resumed:
        r = load_checkpoint(ckpt_dir, scene)
    else:
        r = Renderer(scene, cam, settings)
    done0 = r.frame_index - 1
    print(json.dumps({"checkpoint": ckpt_dir, "resumed": resumed,
                      "frames_done": done0}))

    t0 = time.perf_counter()
    avg = None
    while r.frame_index - 1 < frames:
        n = min(every, frames - (r.frame_index - 1))
        for _ in range(n):
            avg = r.render_hdr()
        avg = np.asarray(avg)
        save_checkpoint(ckpt_dir, r)
        print(json.dumps({"frames_done": r.frame_index - 1,
                          "checkpointed": True}))
    if avg is None:   # already complete on resume
        avg = np.asarray(r.accum / max(r.frame_index - 1, 1))
    n_new = (r.frame_index - 1) - done0
    dt = time.perf_counter() - t0
    ms = dt / max(n_new, 1) * 1000.0
    return avg, r.frame_index - 1, ms


def _save(outdir, name, hdr, settings, avg_ms, minutes, golden=None):
    from fypraytracer_tpu.core.color import finalize_pixels, to_uint8_rgb
    from fypraytracer_tpu.utils import metrics
    from fypraytracer_tpu.utils.image import load_bmp, save_bmp, save_png
    from fypraytracer_tpu.utils.provenance import run_name, write_sidecar

    rgb8 = to_uint8_rgb(finalize_pixels(hdr, np.float32(1.0)))
    mse = psnr = None
    if golden:
        ref = load_bmp(golden) if golden.endswith(".bmp") else None
        if ref is None:
            raise SystemExit("golden must be a .bmp (MisUtils protocol)")
        mse = metrics.mse_8bit(rgb8, ref)
        psnr = metrics.psnr(mse)
    base = run_name(settings, avg_frame_ms=avg_ms, total_minutes=minutes,
                    mse=mse, psnr=psnr)
    os.makedirs(outdir, exist_ok=True)
    save_bmp(os.path.join(outdir, base + ".bmp"), rgb8)
    save_png(os.path.join(outdir, base + ".png"), rgb8)
    write_sidecar(os.path.join(outdir, base + ".json"), settings,
                  avg_frame_ms=avg_ms, total_minutes=minutes, mse=mse,
                  psnr=psnr)
    return base, mse, psnr


def cmd_render(args):
    scene, cam = _load_scene(args)
    settings = _settings(args, _TECH[args.technique])
    if args.checkpoint_dir:
        if args.frames is None:
            raise SystemExit("--checkpoint-dir requires --frames")
        hdr, n, avg_ms = _render_checkpointed(
            scene, cam, settings, args.frames, args.checkpoint_dir,
            args.checkpoint_every)
    else:
        hdr, n, avg_ms = _render_run(scene, cam, settings,
                                     frames=args.frames,
                                     seconds=args.seconds)
    base, mse, psnr = _save(args.out, args.technique, hdr, settings, avg_ms,
                            n * avg_ms / 60000.0, args.golden)
    print(json.dumps({"output": base, "frames": n,
                      "avg_frame_ms": round(avg_ms, 2),
                      "mse": mse, "psnr": psnr}))


def cmd_benchmark(args):
    """Equal-budget comparison across techniques (the reference's whole
    purpose, README.md:5-7)."""
    scene, cam = _load_scene(args)
    techniques = (args.techniques.split(",") if args.techniques
                  else ["uniform", "cosine", "ggx", "brdf", "light", "nee",
                        "restir-di", "restir-gi"])

    # golden: long accumulation of the lowest-variance estimator
    # (convergence oracle, SURVEY §4.4; the reference's implicit oracle is
    # a long-run render, README.md:31) — default 256 frames of NEE+MIS
    from fypraytracer_tpu.core.color import finalize_pixels, to_uint8_rgb
    from fypraytracer_tpu.utils import metrics as M

    golden8 = None
    if args.golden_frames > 0:
        golden_hdr, _, _ = _render_run(
            scene, cam, _settings(args, _TECH[args.golden_technique]).replace(
                samples=max(args.samples, 4)),
            frames=args.golden_frames)
        golden8 = to_uint8_rgb(finalize_pixels(golden_hdr, np.float32(1.0)))
        if args.out:
            from fypraytracer_tpu.utils.image import save_png
            os.makedirs(args.out, exist_ok=True)
            save_png(os.path.join(args.out, "golden.png"), golden8)

    rows = []
    for name in techniques:
        settings = _settings(args, _TECH[name])
        hdr, n, avg_ms = _render_run(scene, cam, settings,
                                     frames=args.frames,
                                     seconds=args.seconds)
        rgb8 = to_uint8_rgb(finalize_pixels(hdr, np.float32(1.0)))
        row = {"technique": name, "frames": n,
               "avg_frame_ms": round(avg_ms, 2)}
        if golden8 is not None:
            mse = M.mse_8bit(rgb8, golden8)
            row.update(mse=round(mse, 4), psnr=round(M.psnr(mse), 2))
        rows.append(row)
        print(json.dumps(rows[-1]))
        if args.out:
            from fypraytracer_tpu.utils.image import save_png
            os.makedirs(args.out, exist_ok=True)
            save_png(os.path.join(args.out, name + ".png"), rgb8)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "benchmark.json"), "w") as f:
            json.dump(rows, f, indent=2)


def _train_restir(args, scene, cam, mode="restir-di"):
    """Inverse rendering THROUGH the ReSTIR reservoir estimators
    (differentiable ReSTIR: detached discrete reservoir machinery,
    differentiated shade/W factors — parallel/restir_shard.py
    ::make_restir_{di,gi}_train_step; estimators Renderer.cu:1628-2041
    (DI) and :2043-2387 (GI))."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.parallel import restir_shard as RS
    from fypraytracer_tpu.parallel.shard import (
        make_pixel_mesh, replicate_scene)

    gi = mode == "restir-gi"
    make_restir_di_sharded = (RS.make_restir_gi_sharded if gi
                              else RS.make_restir_di_sharded)
    make_restir_di_train_step = (RS.make_restir_gi_train_step if gi
                                 else RS.make_restir_di_train_step)
    settings = _settings(args, SamplingTechnique.RESTIR_GI if gi
                         else SamplingTechnique.RESTIR_DI)
    mesh = make_pixel_mesh(
        jax.devices()[:args.devices] if args.devices else None)
    scene_d = replicate_scene(scene, mesh)
    ip = jnp.asarray(cam.inv_projection)
    iv = jnp.asarray(cam.inv_view)
    ppv = jnp.asarray(cam.prev_proj_view)

    render, init_state = make_restir_di_sharded(scene_d, mesh, cam.width,
                                                cam.height, settings)
    target, _ = render(ip, iv, ppv, jnp.uint32(1), init_state())

    true_albedo = scene_d.materials.albedo
    key = jax.random.PRNGKey(0)
    params = dataclasses.replace(
        scene_d.materials,
        albedo=jnp.clip(true_albedo + 0.25 * jax.random.normal(
            key, true_albedo.shape), 0.05, 0.95))

    # scan-batch micro-steps into one dispatch (the training analog of
    # render_many): one host round trip per group instead of per step
    group = max(min(args.steps, 10), 1)
    # lr scale per estimator (test_gradients lr probes): DI's MSE sits
    # ~1e-4 -> lr ~100-150; GI's pixel values are larger -> lr ~5
    lr = args.lr * (25 if gi else 500)
    step, init_tr = make_restir_di_train_step(
        scene_d, mesh, cam.width, cam.height, settings, lr=lr,
        fields=("albedo",), steps_per_call=group, clip01=("albedo",))
    state0 = init_tr()
    done = 0
    while done < args.steps:
        params, _, losses = step(params, ip, iv, ppv, jnp.uint32(1), state0,
                                 target)
        done += group
        print(json.dumps({"step": min(done, args.steps) - 1,
                          "loss": float(jnp.asarray(losses)[-1])}))
    err = float(jnp.abs(params.albedo - true_albedo).mean())
    print(json.dumps({"final_albedo_mae": err, "impl": mode}))


def cmd_train(args):
    """Inverse-rendering demo: recover albedos from a rendered target."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.parallel.shard import (
        make_pixel_mesh, make_train_step, replicate_scene)

    scene, cam = _load_scene(args)
    if args.technique in ("restir-di", "restir-gi"):
        return _train_restir(args, scene, cam, mode=args.technique)
    settings = _settings(args, SamplingTechnique.NEE_MIS)
    mesh = make_pixel_mesh(jax.devices()[:args.devices] if args.devices else None)
    scene_d = replicate_scene(scene, mesh)

    # target: render with TRUE materials
    from fypraytracer_tpu.parallel.shard import sharded_render
    step = make_train_step(scene_d, mesh, cam.width, cam.height, settings,
                           lr=args.lr)
    render = sharded_render(scene_d, mesh, cam.width, cam.height,
                            settings.replace(technique=SamplingTechnique.COSINE),
                            "cosine")
    ip = jnp.asarray(cam.inv_projection)
    iv = jnp.asarray(cam.inv_view)
    target = render(ip, iv, jnp.uint32(1))

    # perturb albedos, then recover
    import dataclasses
    params = scene_d.materials
    key = jax.random.PRNGKey(0)
    params = dataclasses.replace(
        params, albedo=jnp.clip(params.albedo + 0.25 * jax.random.normal(
            key, params.albedo.shape), 0.05, 0.95))

    for i in range(args.steps):
        params, loss = step(params, ip, iv, jnp.uint32(i + 1), target)
        if i % max(args.steps // 10, 1) == 0 or i == args.steps - 1:
            print(json.dumps({"step": i, "loss": float(loss)}))
    err = float(jnp.abs(params.albedo - scene_d.materials.albedo).mean())
    print(json.dumps({"final_albedo_mae": err}))


def main(argv=None):
    from fypraytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="fypraytracer_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--scene", default="cornell",
                        help="builtin name or scene .json path")
        sp.add_argument("--width", type=int, default=256)
        sp.add_argument("--height", type=int, default=256)
        sp.add_argument("--bounces", type=int, default=2)
        sp.add_argument("--samples", type=int, default=1)
        sp.add_argument("--sky", type=float, nargs=3, default=[0.05, 0.06, 0.08])
        sp.add_argument("--candidates", type=int, default=8)
        sp.add_argument("--neighbors", type=int, default=5)
        sp.add_argument("--radius", type=int, default=30)
        sp.add_argument("--history", type=int, default=2)

    r = sub.add_parser("render", help="render one technique")
    common(r)
    r.add_argument("--technique", choices=sorted(_TECH), default="nee")
    r.add_argument("--frames", type=int, default=None)
    r.add_argument("--seconds", type=float, default=None)
    r.add_argument("--golden", default=None, help="golden BMP for MSE/PSNR")
    r.add_argument("--checkpoint-dir", default=None,
                   help="checkpoint/resume directory for long renders: "
                        "saves accumulation + reservoir state every "
                        "--checkpoint-every frames and resumes from an "
                        "existing checkpoint")
    r.add_argument("--checkpoint-every", type=int, default=64)
    r.add_argument("-o", "--out", default="RenderedImages")
    r.set_defaults(fn=cmd_render)

    b = sub.add_parser("benchmark", help="equal-budget technique comparison")
    common(b)
    b.add_argument("--techniques", default=None, help="comma list")
    b.add_argument("--frames", type=int, default=None)
    b.add_argument("--seconds", type=float, default=None)
    b.add_argument("--golden-frames", type=int, default=256,
                   help="0 = timing-only (skip the golden render + PSNR)")
    b.add_argument("--golden-technique", choices=sorted(_TECH),
                   default="nee", help="estimator for the golden image")
    b.add_argument("-o", "--out", default=None)
    b.set_defaults(fn=cmd_benchmark)

    t = sub.add_parser("train", help="inverse-rendering material fit")
    common(t)
    t.add_argument("--steps", type=int, default=30)
    t.add_argument("--lr", type=float, default=0.2)
    t.add_argument("--devices", type=int, default=None)
    t.add_argument("--technique", choices=["nee", "restir-di", "restir-gi"],
                   default="nee",
                   help="estimator to differentiate through; restir-di/"
                        "restir-gi = pixel gradients through the reservoir "
                        "estimators")
    t.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    if args.cmd == "render" and args.frames is None and args.seconds is None:
        args.frames = 16
    if args.cmd == "benchmark" and args.frames is None and args.seconds is None:
        args.frames = 16
    args.fn(args)


if __name__ == "__main__":
    main()
