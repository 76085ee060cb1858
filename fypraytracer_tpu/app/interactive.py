"""Interactive session — the live-edit loop of the reference's viewer.

The reference couples rendering to a Vulkan/ImGui window (WalnutApp.cpp:
535-756): fly camera (Camera::OnUpdate), live material/mesh/settings
panels flushed through SceneManager, accumulation reset on edits, image
save.  An accelerator host is headless, so this module provides the same loop as a
line-oriented command REPL (stdin/script-driven, also usable from
notebooks via :class:`InteractiveSession`): every reference panel maps to
a command, edits flow through SceneManager's incremental rebuilds, and a
moving camera keeps ReSTIR temporal reuse valid via the latched prev
matrices (WalnutApp.cpp:908-909).

Commands::

    tech <name>                 sampling technique (resets accumulation)
    bounces/samples <n>         settings (reset)
    move x y z [fx fy fz]       camera teleport (prev matrices latched)
    fly <fwd> <right> <up> [yaw pitch]   incremental camera motion
    fov <deg>                   vertical FOV (Camera.h ctor panel; reset)
    clip <near> <far>           clip planes (reset)
    restir <candidates|history|neighbors|radius|temporal|spatial> <n>
                                live ReSTIR knobs + reuse toggles
                                (WalnutApp.cpp:617-643 panel; reset)
    sky <r g b>                 sky color (settings panel; reset)
    accumulate <0|1>            toAccumulate toggle (reset)
    mat <id> albedo r g b | roughness v | metallic v | emission r g b pow
             | map <tid>        (tid from `texture`; -1 = untextured)
    texture <path.png|bmp>      register a texture mid-session
                                (WalnutApp.cpp:674 Add-Texture flow)
    mesh <id> position x y z | rotation x y z | scale x y z
    load <path.obj> [mat] [x y z [sx sy sz [rx ry rz]]]   add mesh mid-session
    add-sphere [mat] [radius] [x y z]                     procedural UV sphere
    step [n]                    render n frames (default 1), print stats
    save <path>                 save current average (PNG or BMP)
    info                        scene/camera/settings summary
    quit
"""

from __future__ import annotations

import json
import shlex
import sys
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


class InteractiveSession:
    """Owns builder + SceneManager + Renderer; applies edits and renders.

    The renderer is rebuilt lazily after scene/settings edits (the
    reference resets frameIndex on any change, WalnutApp.cpp:638-643)."""

    def __init__(self, builder, camera, settings: RenderSettings | None = None,
                 out=sys.stdout):
        from fypraytracer_tpu.scene.manager import SceneManager

        self.manager = SceneManager(builder)
        self.camera = camera
        self.settings = settings or RenderSettings(
            technique=SamplingTechnique.NEE_MIS, bounces=2, samples=1,
            sky_color=(0.05, 0.06, 0.08))
        self.out = out
        self._renderer = None
        self._avg = None

    def _emit(self, **kv):
        print(json.dumps(kv), file=self.out, flush=True)

    def _get_renderer(self):
        if self._renderer is None:
            from fypraytracer_tpu.render.renderer import Renderer

            self._renderer = Renderer(self.manager.scene, self.camera,
                                      self.settings)
        return self._renderer

    def _reset(self):
        self._renderer = None

    def _restart_accumulation(self):
        """Camera/projection changes restart accumulation in place; ReSTIR
        state persists (temporal reprojection uses the latched prev
        matrices, WalnutApp.cpp:908-909)."""
        if self._renderer is not None:
            self._renderer.accum = self._renderer.accum * 0
            self._renderer.frame_index = 1

    # -- commands ------------------------------------------------------------

    def cmd_tech(self, name):
        self.settings = self.settings.replace(technique=_TECH[name])
        self._reset()

    def cmd_bounces(self, n):
        self.settings = self.settings.replace(bounces=int(n))
        self._reset()

    def cmd_samples(self, n):
        self.settings = self.settings.replace(samples=int(n))
        self._reset()

    def cmd_move(self, *a):
        a = [float(x) for x in a]
        self.camera.move_to(a[:3], a[3:6] if len(a) >= 6 else None)
        self._restart_accumulation()

    def cmd_fly(self, *a):
        a = [float(x) for x in a]
        self.camera.fly(1.0, forward=a[0], right=a[1], up=a[2],
                        yaw=a[3] if len(a) > 3 else 0.0,
                        pitch=a[4] if len(a) > 4 else 0.0)
        self._restart_accumulation()

    def cmd_fov(self, deg):
        """Vertical field of view (the reference's camera panel edits the
        Camera ctor params, Camera.h ctor / WalnutApp.cpp:548-560)."""
        self.camera.vfov_deg = float(deg)
        self.camera._update()
        self._restart_accumulation()

    def cmd_clip(self, near, far):
        """Near/far clip planes (Camera.h ctor panel)."""
        self.camera.near = float(near)
        self.camera.far = float(far)
        self.camera._update()
        self._restart_accumulation()

    def cmd_restir(self, knob, val):
        """Live ReSTIR knobs (the WalnutApp.cpp:617-643 panel): editing
        any of them resets accumulation (WalnutApp.cpp:638-643).
        ``temporal``/``spatial`` are the useTemporalReuse/useSpatialReuse
        checkboxes (RenderingSettings.h:18-19)."""
        field = {"candidates": "light_candidates",
                 "history": "temporal_history_limit",
                 "neighbors": "spatial_neighbors",
                 "radius": "spatial_radius",
                 "temporal": "temporal_reuse",
                 "spatial": "spatial_reuse"}[knob]
        cast = bool if field.endswith("_reuse") else int
        self.settings = self.settings.replace(**{field: cast(int(val))})
        self._reset()

    def cmd_sky(self, r, g, b):
        """Sky color (the settings panel's skyColor edit; reset)."""
        self.settings = self.settings.replace(
            sky_color=(float(r), float(g), float(b)))
        self._reset()

    def cmd_accumulate(self, val):
        """toAccumulate toggle (RenderingSettings.h:7; reset)."""
        self.settings = self.settings.replace(accumulate=bool(int(val)))
        self._reset()

    def cmd_mat(self, mid, field, *vals):
        mid = int(mid)
        if field == "map":
            self.manager.set_material(mid, albedo_map=int(vals[0]))
            return
        vals = [float(v) for v in vals]
        if field == "albedo":
            self.manager.set_material(mid, albedo=tuple(vals))
        elif field == "roughness":
            self.manager.set_material(mid, roughness=vals[0])
        elif field == "metallic":
            self.manager.set_material(mid, metallic=vals[0])
        elif field == "emission":
            self.manager.set_material(mid, emission_color=tuple(vals[:3]),
                                      emission_power=vals[3])
        else:
            raise ValueError(f"unknown material field {field!r}")

    def cmd_texture(self, path):
        """Register a texture mid-session (WalnutApp.cpp:674 Add-Texture
        dialog → Scene::AddNewTexture, Scene.cpp:188); assign it with
        `mat <id> map <tid>` — the next `step` repacks the atlas."""
        tid = self.manager.add_texture(path)
        self._emit(texture=path, texture_id=tid)

    def cmd_mesh(self, mid, field, *vals):
        vals = [float(v) for v in vals]
        kw = {field: tuple(vals)}
        self.manager.set_mesh_transform(int(mid), **kw)

    def cmd_load(self, path, mat="0", *vals):
        """Add a mesh from an OBJ file mid-session — the reference's
        runtime import (WalnutApp.cpp:742 file dialog →
        Scene::CreateNewMeshInScene, Scene.cpp:241-290); structures are
        rebuilt at the next `step` via SceneManager.apply."""
        vals = [float(v) for v in vals]
        kw = {}
        if len(vals) >= 3:
            kw["position"] = tuple(vals[0:3])
        if len(vals) >= 6:
            kw["scale"] = tuple(vals[3:6])
        if len(vals) >= 9:
            kw["rotation"] = tuple(vals[6:9])
        mesh_id = self.manager.load_mesh(path, material=int(mat), **kw)
        self._emit(loaded=path, mesh_id=mesh_id,
                   triangles=int(len(self.manager.builder.meshes[mesh_id].tri_v)))

    def cmd_add_sphere(self, mat="0", radius="0.5", *vals):
        """Procedural UV sphere (Mesh::GenerateSphereMesh, Mesh.cpp:7-95)."""
        from fypraytracer_tpu.scene.procedural import uv_sphere

        pos = tuple(float(v) for v in vals[:3]) if len(vals) >= 3 \
            else (0.0, 0.0, 0.0)
        p, t, n, u = uv_sphere(float(radius))
        mesh_id = self.manager.add_mesh(p, t, normals=n, uvs=u,
                                        material=int(mat), position=pos)
        self._emit(mesh_id=mesh_id, triangles=int(len(t)))

    def cmd_step(self, n="1"):
        if self.manager.dirty:
            self.manager.apply()
            self._reset()
        r = self._get_renderer()
        t0 = time.perf_counter()
        for _ in range(int(n)):
            self._avg = r.render_hdr()
        dt = (time.perf_counter() - t0) / int(n)
        hdr = np.asarray(self._avg)
        self._emit(frames=r.frame_index - 1, frame_ms=round(dt * 1000, 2),
                   mean=float(hdr.mean()), finite=bool(np.isfinite(hdr).all()))

    def cmd_save(self, path):
        from fypraytracer_tpu.core.color import finalize_pixels, to_uint8_rgb
        from fypraytracer_tpu.utils.image import save_bmp, save_png

        assert self._avg is not None, "render with `step` before saving"
        rgb8 = to_uint8_rgb(finalize_pixels(np.asarray(self._avg),
                                            np.float32(1.0)))
        (save_bmp if path.endswith(".bmp") else save_png)(path, rgb8)
        self._emit(saved=path)

    def cmd_info(self):
        s = self.manager.scene
        self._emit(triangles=int(s.num_triangles),
                   emissive=int(s.num_emissive),
                   materials=int(s.materials.albedo.shape[0]),
                   camera=list(map(float, self.camera.position)),
                   technique=int(self.settings.technique),
                   scene_version=self.manager.version)

    def run(self, lines):
        """Execute an iterable of command lines; returns on quit/EOF."""
        for line in lines:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = shlex.split(line)
            if parts[0] in ("quit", "exit"):
                break
            fn = getattr(self, "cmd_" + parts[0].replace("-", "_"), None)
            if fn is None:
                self._emit(error=f"unknown command {parts[0]!r}")
                continue
            try:
                fn(*parts[1:])
            except Exception as exc:  # keep the session alive on bad input
                self._emit(error=f"{type(exc).__name__}: {exc}")


def main(argv=None):
    import argparse

    from fypraytracer_tpu.scene.sceneio import builtin_scene, load_scene_file

    p = argparse.ArgumentParser(prog="fypraytracer_tpu.interactive")
    p.add_argument("--scene", default="cornell")
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    args = p.parse_args(argv)
    if args.scene.endswith(".json"):
        builder, cam = load_scene_file(args.scene)
    else:
        builder, cam = builtin_scene(args.scene, args.width, args.height)
    cam.resize(args.width, args.height)
    InteractiveSession(builder, cam).run(sys.stdin)


if __name__ == "__main__":
    main()
