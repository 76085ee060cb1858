"""Room benchmark scene (scene/procedural.py::room) — the reference's
authored content (WalnutApp.cpp:43-521): textured banana + toaster OBJs,
six-wall room, 5 emissive ceiling planes."""

import os

import numpy as np
import pytest

from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
from fypraytracer_tpu.scene.procedural import _find_asset, room

pytestmark = pytest.mark.skipif(
    not os.path.isdir("/root/reference/FYPRayTracer/Assets/3D Models/Test")
    and not os.environ.get("FYP_ASSETS"),
    reason="room scene assets unavailable")


@pytest.fixture(scope="module")
def room_scene():
    b, cam = room(64, 64)
    return b.compile(), cam


def test_room_structure(room_scene):
    scene, cam = room_scene
    g = scene.geometry
    # banana (1.5-2k tris) + toaster (~5k) + 6 walls (12) + 5 lights (10)
    assert 5000 < len(g.tri_v) < 20000
    assert len(scene.emissive_tris) == 10  # 5 planes x 2 tris
    # two texture pages registered, the textured materials reference them
    assert scene.textures.pages.shape[0] == 2
    am = np.asarray(scene.materials.albedo_map)
    assert set(am[am >= 0].tolist()) == {0, 1}
    # 9 materials in the reference's emplacement order
    assert len(am) == 9
    assert np.asarray(scene.materials.emission_power)[2] == 40.0
    np.testing.assert_allclose(cam.position, [1.752, -0.845, -2.812])


def test_room_renders_nonblack(room_scene):
    scene, cam = room_scene
    from fypraytracer_tpu.render.renderer import Renderer

    r = Renderer(scene.device_put(), cam,
                 RenderSettings(technique=SamplingTechnique.NEE_MIS,
                                bounces=2, samples=1))
    hdr = np.asarray(r.render_hdr())
    assert np.isfinite(hdr).all()
    assert hdr.mean() > 0.01
    # the emissive ceiling is visible somewhere near the top of frame
    assert hdr.max() > 1.0


def test_room_obj_sizes():
    from fypraytracer_tpu.scene.objloader import load_obj

    pos, tri, nrm, uv = load_obj(_find_asset("banana.obj"))
    assert len(tri) > 500 and uv is not None
    pos, tri, nrm, uv = load_obj(_find_asset("toaster.obj"))
    assert len(tri) > 2000 and uv is not None


def test_stress_scene_builds_and_renders():
    """The ~200k-tri stress scene compiles (native builders) and renders
    correctly through the large-scene traversal path."""
    import numpy as np

    from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu.render.renderer import Renderer
    from fypraytracer_tpu.scene.sceneio import builtin_scene

    b, cam = builtin_scene("stress", 16, 16)
    scene = b.compile()
    assert scene.geometry.tri_v.shape[0] > 100_000
    r = Renderer(scene, cam, RenderSettings(
        technique=SamplingTechnique.COSINE, bounces=1, samples=1))
    hdr = np.asarray(r.render_hdr())
    assert np.isfinite(hdr).all()
    assert hdr.mean() > 1e-3
