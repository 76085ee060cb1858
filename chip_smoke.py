"""Smoke test of the renderer on an NVIDIA GPU, through its user entry points.

    python chip_smoke.py                # one card: every single-card phase
    python chip_smoke.py --devices 4    # four cards: the sharded phase only

Each phase runs real work at full size and compares it with a reference;
any failed comparison raises, so the script exits non-zero.  The last line
of standard output is one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

It refuses to run (exit 2, no result line) when JAX finds no GPU.

Single-card phases:
  dense     the Triton dense tracer on Cornell (1,164 triangles), 1920x1088
            primary rays plus one diffuse bounce, against the BVH walk and
            the XLA dense path at Precision.HIGHEST;
  renders   NEE+MIS, ReSTIR DI and ReSTIR GI (8 candidates, 5 neighbours,
            radius 30, history 2) through ``Renderer.render_many`` and
            ``render_hdr`` at 1920x1088, the same code at 256^2 against the
            host CPU (8-bit PSNR floor), and one ``cli render`` call;
  stress    the 200k-triangle lattice through the BVH walk at 512^2, and at
            128^2 against the host CPU;
  training  NEE inverse-rendering steps at 512^2 on a one-card mesh (loss
            finite and decreasing) and the albedo gradient at 64^2 against
            the host CPU.
Four-card phase (``--devices 4``): the sharded NEE train step, the sharded
ReSTIR DI render and train step, and the sharded ReSTIR GI render, each
against the same work on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

from fypraytracer_tpu.utils.compile_cache import enable_compile_cache

REPO = os.path.dirname(os.path.abspath(__file__))
SKY = (0.05, 0.06, 0.08)

# tolerances, each with its reason
TRI_AGREEMENT_MIN = 0.999   # shared-edge tie flips between f32 formulations
T_REL_MAX = 1e-4            # f32 t of one triangle from three formulations
# PSNR floors, 8-bit post-tonemap, card vs host CPU at the same seeds: the
# RNG is counter-based, so only float reassociation differs, and reservoir
# accept decisions amplify it on isolated pixels (more for GI's paths)
PSNR_FLOOR = {"NEE_MIS": 40.0, "RESTIR_DI": 32.0, "RESTIR_GI": 28.0}
GRAD_REL_MAX = 2e-2         # albedo gradient card vs CPU (relative L2)
SHARDED_REL_MAX = 1e-2      # image checksum, sharded vs one card


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Full sizes by default; a rehearsal on the CPU shrinks them."""
    width: int = 1920
    height: int = 1088
    small: int = 256
    frames: int = 8
    stress: int = 512
    stress_small: int = 128
    train: int = 512
    train_small: int = 64
    train_steps: int = 4
    sharded_train: int = 512


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu(n_devices: int):
    """The devices to run on; exits with code 2 unless JAX has GPUs."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.stderr.write(f"chip_smoke: no GPU (JAX platform is "
                         f"{devs[0].platform!r}); refusing to run\n")
        raise SystemExit(2)
    if len(devs) < n_devices:
        sys.stderr.write(f"chip_smoke: need {n_devices} GPUs, JAX has "
                         f"{len(devs)}\n")
        raise SystemExit(2)
    return devs[:n_devices]


def card_line() -> str:
    """`nvidia-smi` name and power limit of every card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def image_psnr(a_hdr, b_hdr) -> float:
    """8-bit post-tonemap PSNR between two HDR running averages."""
    from fypraytracer_tpu.core.color import finalize_pixels, to_uint8_rgb
    from fypraytracer_tpu.utils import metrics

    a = to_uint8_rgb(finalize_pixels(np.asarray(a_hdr, np.float32),
                                     np.float32(1.0)))
    b = to_uint8_rgb(finalize_pixels(np.asarray(b_hdr, np.float32),
                                     np.float32(1.0)))
    return metrics.psnr(metrics.mse_8bit(np.asarray(a), np.asarray(b)))


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)
    log(f"  ok: {what}")


def _timed(fn, *args, reps: int = 3):
    """(result, median seconds) of ``fn(*args)`` after one warm call."""
    import jax

    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


def _settings(technique, **kw):
    from fypraytracer_tpu.config import RenderSettings, SamplingTechnique

    return RenderSettings(technique=SamplingTechnique[technique], bounces=2,
                          samples=1, sky_color=SKY, light_candidates=8,
                          spatial_neighbors=5, spatial_radius=30,
                          temporal_history_limit=2, **kw)


def _scene(name, width, height):
    from fypraytracer_tpu.scene.sceneio import builtin_scene

    builder, cam = builtin_scene(name, width, height)
    return builder.compile(), cam


def _render(scene, cam, settings, frames, device=None):
    """``render_many(frames)`` on ``device`` (default: the default one)."""
    import jax

    from fypraytracer_tpu.render.renderer import Renderer

    if device is None:
        return np.asarray(Renderer(scene, cam, settings).render_many(frames))
    with jax.default_device(device):
        return np.asarray(Renderer(scene, cam, settings).render_many(frames))


def _nonblack(img, what):
    check(bool(np.isfinite(img).all()) and float(img.mean()) > 1e-3,
          f"{what}: finite and non-black (mean {float(img.mean()):.4f})")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_dense(sz: Sizes):
    """The kept dense tracer against the BVH walk and XLA at HIGHEST."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.core.camera import generate_rays
    from fypraytracer_tpu.ops.dense import trace_rays_dense
    from fypraytracer_tpu.ops.traverse import trace_rays
    from fypraytracer_tpu.ops.triton_dense import trace_rays_triton

    scene, cam = _scene("cornell", sz.width, sz.height)
    dscene = scene.device_put()
    geom = dscene.geometry
    log(f"phase dense: cornell {geom.tri_v.shape[0]} triangles, "
        f"{sz.width}x{sz.height} primary + 1 diffuse bounce")

    @jax.jit
    def rays():
        o, d = generate_rays(jnp.asarray(cam.inv_projection),
                             jnp.asarray(cam.inv_view), sz.width, sz.height,
                             xp=jnp)
        hit = trace_rays(dscene.bvh, geom, o, d)
        tri = jnp.maximum(hit["tri"], 0)
        p = geom.positions[geom.tri_v[tri]]
        n = jnp.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        n = n / jnp.linalg.norm(n, axis=-1, keepdims=True)
        n = jnp.where((n * d).sum(-1, keepdims=True) > 0, -n, n)
        x = o + hit["t"][:, None] * d + 1e-3 * n
        r = jax.random.normal(jax.random.PRNGKey(0), d.shape)
        b = n + r / jnp.linalg.norm(r, axis=-1, keepdims=True)
        b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
        ok = (hit["tri"] >= 0)[:, None]
        # missed primaries re-trace themselves as their "bounce"
        return (jnp.concatenate([o, jnp.where(ok, x, o)]),
                jnp.concatenate([d, jnp.where(ok, b, d)]))

    o, d = rays()
    k, t_k = _timed(jax.jit(lambda o, d: trace_rays_triton(geom, o, d)), o,
                    d)
    w, t_w = _timed(jax.jit(lambda o, d: trace_rays(dscene.bvh, geom, o, d)),
                    o, d)
    x, t_x = _timed(jax.jit(lambda o, d: trace_rays_dense(geom, o, d)), o, d)
    k, w, x = (jax.tree_util.tree_map(np.asarray, r) for r in (k, w, x))
    log(f"  {o.shape[0]} rays: kernel {t_k * 1e3:.2f} ms, BVH walk "
        f"{t_w * 1e3:.2f} ms, XLA dense (HIGHEST) {t_x * 1e3:.2f} ms")
    for name, ref in (("BVH walk", w), ("XLA dense HIGHEST", x)):
        agree = float((k["tri"] == ref["tri"]).mean())
        same = (k["tri"] == ref["tri"]) & (k["tri"] >= 0)
        dt = np.abs(k["t"][same] - ref["t"][same])
        rel = float((dt / np.maximum(np.abs(ref["t"][same]), 1e-6)).max())
        log(f"  kernel vs {name}: tri agreement {agree:.6f}, "
            f"max|dt| {float(dt.max()):.3e}, max|dt|/t {rel:.3e}")
        check(agree >= TRI_AGREEMENT_MIN,
              f"tri agreement vs {name} >= {TRI_AGREEMENT_MIN}")
        check(rel <= T_REL_MAX, f"max|dt|/t vs {name} <= {T_REL_MAX} (f32)")
    check(float((k["tri"] >= 0).mean()) > 0.5, "most rays hit")


def phase_renders(sz: Sizes, cpu, out_dir: str):
    """1080p renders through Renderer, 256^2 vs the host CPU, one CLI run."""
    import jax

    from fypraytracer_tpu.app import cli
    from fypraytracer_tpu.render.renderer import Renderer

    scene, cam = _scene("cornell", sz.width, sz.height)
    small, small_cam = _scene("cornell", sz.small, sz.small)
    for tech in ("NEE_MIS", "RESTIR_DI", "RESTIR_GI"):
        settings = _settings(tech)
        log(f"phase renders: {tech} {sz.width}x{sz.height}")
        t0 = time.perf_counter()
        r = Renderer(scene, cam, settings)
        img = np.asarray(r.render_many(sz.frames))
        t1 = time.perf_counter()
        img = np.asarray(r.render_many(sz.frames))
        log(f"  render_many({sz.frames}): first call incl. compile "
            f"{t1 - t0:.1f} s, then {(time.perf_counter() - t1) / sz.frames * 1e3:.1f}"
            f" ms/frame")
        _nonblack(img, f"{tech} render_many")
        t0 = time.perf_counter()
        for _ in range(2):
            hdr = r.render_hdr()
        hdr = np.asarray(jax.block_until_ready(hdr))
        log(f"  2x render_hdr incl. compile {time.perf_counter() - t0:.1f} s")
        _nonblack(hdr, f"{tech} render_hdr")

        gpu = _render(small, small_cam, settings, sz.frames)
        ref = _render(small, small_cam, settings, sz.frames, device=cpu)
        p = image_psnr(gpu, ref)
        log(f"  {sz.small}^2 card vs host CPU: PSNR {p:.2f} dB")
        check(p >= PSNR_FLOOR[tech],
              f"{tech} PSNR vs CPU >= {PSNR_FLOOR[tech]} dB")

    log("phase renders: cli render restir-gi")
    cli.main(["render", "--scene", "cornell", "--technique", "restir-gi",
              "--width", str(sz.width), "--height", str(sz.height),
              "--frames", str(sz.frames), "-o", os.path.join(out_dir, "cli")])
    pngs = [f for f in os.listdir(os.path.join(out_dir, "cli"))
            if f.endswith(".png")]
    check(len(pngs) >= 1, "cli render wrote an image")


def phase_stress(sz: Sizes, cpu):
    """The 200k-triangle lattice through the BVH walk."""
    from fypraytracer_tpu.ops.dense import DENSE_MAX_TRIS

    settings = _settings("NEE_MIS")
    scene, cam = _scene("stress", sz.stress, sz.stress)
    n = scene.geometry.tri_v.shape[0]
    log(f"phase stress: {n} triangles, NEE {sz.stress}^2")
    check(n > DENSE_MAX_TRIS, "scene is above DENSE_MAX_TRIS (BVH walk)")
    t0 = time.perf_counter()
    img = _render(scene, cam, settings, 2)
    log(f"  render_many(2) incl. compile {time.perf_counter() - t0:.1f} s")
    _nonblack(img, "stress render")
    small, small_cam = _scene("stress", sz.stress_small, sz.stress_small)
    p = image_psnr(_render(small, small_cam, settings, 2),
                   _render(small, small_cam, settings, 2, device=cpu))
    log(f"  {sz.stress_small}^2 card vs host CPU: PSNR {p:.2f} dB")
    check(p >= PSNR_FLOOR["NEE_MIS"],
          f"stress PSNR vs CPU >= {PSNR_FLOOR['NEE_MIS']} dB")


def _train(scene, cam, devices, steps, step_size=0.02):
    """(losses, first-step albedo gradient) of NEE descent on ``devices``.

    Each step moves the albedo against its gradient by at most
    ``step_size`` (normalized steepest descent): a correct gradient must
    then lower the loss, whatever the loss's scale."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.parallel.shard import (make_pixel_mesh,
                                                 make_train_step,
                                                 replicate_scene)
    from fypraytracer_tpu.render.renderer import Renderer

    settings = _settings("NEE_MIS")
    with jax.default_device(devices[0]):
        target = Renderer(scene, cam, settings).render_hdr().reshape(-1, 3)
        mesh = make_pixel_mesh(devices)
        scene_r = replicate_scene(scene, mesh)
        # lr=1: the step's update is exactly the gradient
        step = make_train_step(scene_r, mesh, cam.width, cam.height, settings,
                               lr=1.0)
        true = scene_r.materials.albedo
        params = dataclasses.replace(
            scene_r.materials, albedo=jnp.clip(true + 0.2 * jax.random.normal(
                jax.random.PRNGKey(0), true.shape), 0.05, 0.95))
        ip, iv = jnp.asarray(cam.inv_projection), jnp.asarray(cam.inv_view)
        losses, grad = [], None
        for _ in range(steps):
            new, loss = step(params, ip, iv, jnp.uint32(1), target)
            g = params.albedo - new.albedo
            if grad is None:
                grad = np.asarray(g)
            # fit the albedo alone: the other fields' curvatures differ by
            # orders of magnitude
            eta = step_size / jnp.maximum(jnp.abs(g).max(), 1e-30)
            params = dataclasses.replace(
                params, albedo=jnp.clip(params.albedo - eta * g, 0.0, 1.0))
            losses.append(float(loss))
    return losses, grad


def phase_training(sz: Sizes, gpu, cpu):
    """NEE inverse rendering on a one-card mesh."""
    small, small_cam = _scene("cornell", sz.train_small, sz.train_small)
    _, g_gpu = _train(small, small_cam, [gpu], 1)
    _, g_cpu = _train(small, small_cam, [cpu], 1)
    rel = float(np.linalg.norm(g_gpu - g_cpu) / np.linalg.norm(g_cpu))
    log(f"phase training: {sz.train_small}^2 albedo gradient card vs host "
        f"CPU: relative L2 {rel:.3e} (|g| {float(np.linalg.norm(g_cpu)):.3e})")
    check(rel <= GRAD_REL_MAX, f"albedo gradient vs CPU <= {GRAD_REL_MAX}")

    scene, cam = _scene("cornell", sz.train, sz.train)
    log(f"phase training: NEE descent {sz.train}^2, {sz.train_steps} steps")
    t0 = time.perf_counter()
    losses, _ = _train(scene, cam, [gpu], sz.train_steps)
    log(f"  losses {['%.6g' % v for v in losses]} "
        f"({time.perf_counter() - t0:.1f} s incl. compile)")
    check(all(np.isfinite(losses)), "losses finite")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          "loss decreases at every step")


def phase_multi_device(sz: Sizes, devices):
    """Sharded paths on the pixel mesh against the same work on one card."""
    import jax
    import jax.numpy as jnp

    from fypraytracer_tpu.parallel.restir_shard import (
        make_restir_di_sharded, make_restir_di_train_step,
        make_restir_gi_sharded)
    from fypraytracer_tpu.parallel.shard import (make_pixel_mesh,
                                                 replicate_scene)

    n = len(devices)
    log(f"phase multi-device: {n} cards, flat 1-D pixel mesh")
    scene, cam = _scene("cornell", sz.sharded_train, sz.sharded_train)
    losses_n, g_n = _train(scene, cam, devices, 1)
    losses_1, g_1 = _train(scene, cam, devices[:1], 1)
    rel = float(np.linalg.norm(g_n - g_1) / np.linalg.norm(g_1))
    log(f"  NEE train {sz.sharded_train}^2: loss {losses_n[0]:.6g} vs "
        f"{losses_1[0]:.6g}, albedo gradient relative L2 {rel:.3e}")
    check(abs(losses_n[0] - losses_1[0]) / losses_1[0] <= SHARDED_REL_MAX,
          f"sharded NEE loss within {SHARDED_REL_MAX} of one card")
    check(rel <= GRAD_REL_MAX, f"sharded NEE gradient within {GRAD_REL_MAX}")

    def run(make, mesh_devs, scene, cam, settings, frames=4):
        """(sum of ``frames`` frames, ms/frame over frames 2..frames)."""
        mesh = make_pixel_mesh(mesh_devs)
        dscene = replicate_scene(scene, mesh)
        step, init = make(dscene, mesh, cam.width, cam.height, settings)
        ip, iv = jnp.asarray(cam.inv_projection), jnp.asarray(cam.inv_view)
        ppv = jnp.asarray(cam.prev_proj_view)
        acc, st = jax.block_until_ready(
            step(ip, iv, ppv, jnp.uint32(1), init()))     # compiles
        t0 = time.perf_counter()
        for f in range(2, frames + 1):
            hdr, st = step(ip, iv, ppv, jnp.uint32(f), st)
            acc = acc + hdr
        acc = jax.block_until_ready(acc)
        ms = (time.perf_counter() - t0) / (frames - 1) * 1e3
        return np.asarray(acc), ms

    big, big_cam = _scene("cornell", sz.width, sz.height)
    for name, make, tech in (("ReSTIR DI", make_restir_di_sharded, "RESTIR_DI"),
                             ("ReSTIR GI", make_restir_gi_sharded, "RESTIR_GI")):
        settings = _settings(tech)
        got, ms_n = run(make, devices, big, big_cam, settings)
        ref, ms_1 = run(make, devices[:1], big, big_cam, settings)
        _nonblack(got, f"sharded {name} render")
        rel = abs(float(got.sum()) - float(ref.sum())) / float(ref.sum())
        p = image_psnr(got / 4, ref / 4)
        log(f"  {name} {sz.width}x{sz.height}: checksum rel diff {rel:.3e}, "
            f"PSNR {p:.2f} dB; {ms_n:.1f} ms/frame on {n} cards vs "
            f"{ms_1:.1f} on one (per-frame dispatch, scaling efficiency "
            f"{ms_1 / (n * ms_n):.2f})")
        check(rel <= SHARDED_REL_MAX,
              f"sharded {name} checksum within {SHARDED_REL_MAX} of one card")
        check(p >= PSNR_FLOOR[tech], f"sharded {name} PSNR >= "
              f"{PSNR_FLOOR[tech]} dB")

    settings = _settings("RESTIR_DI")
    outs = []
    for mesh_devs in (devices, devices[:1]):
        mesh = make_pixel_mesh(mesh_devs)
        dscene = replicate_scene(scene, mesh)
        step, init = make_restir_di_train_step(
            dscene, mesh, cam.width, cam.height, settings, lr=1.0,
            fields=("albedo",))
        p, _, loss = step(dscene.materials, jnp.asarray(cam.inv_projection),
                          jnp.asarray(cam.inv_view),
                          jnp.asarray(cam.prev_proj_view), jnp.uint32(1),
                          init(), jnp.zeros((cam.width * cam.height, 3)))
        outs.append((float(loss), np.asarray(
            dscene.materials.albedo - p.albedo)))
    (l_n, g_n), (l_1, g_1) = outs
    rel = float(np.linalg.norm(g_n - g_1) / np.linalg.norm(g_1))
    log(f"  ReSTIR DI train {sz.sharded_train}^2: loss {l_n:.6g} vs "
        f"{l_1:.6g}, albedo gradient relative L2 {rel:.3e}")
    check(np.isfinite(l_n) and abs(l_n - l_1) / l_1 <= SHARDED_REL_MAX,
          f"sharded ReSTIR DI loss within {SHARDED_REL_MAX} of one card")
    check(rel <= GRAD_REL_MAX,
          f"sharded ReSTIR DI gradient within {GRAD_REL_MAX}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4 = run only the sharded multi-device phase")
    ap.add_argument("--out", default=os.path.join(REPO, "smoke_out"),
                    help="directory for the CLI phase's images")
    args = ap.parse_args(argv)

    import jax

    devices = require_gpu(args.devices)
    log(f"compile cache: {enable_compile_cache()}")
    log(f"jax {jax.__version__}, {len(jax.devices())} x "
        f"{devices[0].device_kind}")
    log(card_line())
    cpu = jax.devices("cpu")[0]
    sz = Sizes()
    t_start = time.perf_counter()
    if args.devices == 4:
        phases = [lambda: phase_multi_device(sz, devices)]
    else:
        os.makedirs(args.out, exist_ok=True)
        phases = [lambda: phase_dense(sz),
                  lambda: phase_renders(sz, cpu, args.out),
                  lambda: phase_stress(sz, cpu),
                  lambda: phase_training(sz, devices[0], cpu)]
    for run in phases:
        t0 = time.perf_counter()
        run()
        log(f"  phase time {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
