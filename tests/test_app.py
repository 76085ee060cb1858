"""App surface: CLI commands, scene files, OBJ loader, provenance."""

import json
import os

import jax
import numpy as np
import pytest

from fypraytracer_tpu.scene.objloader import load_obj


def test_obj_loader_cube(tmp_path):
    obj = tmp_path / "cube.obj"
    obj.write_text("""
v -1 -1 -1
v 1 -1 -1
v 1 1 -1
v -1 1 -1
v -1 -1 1
v 1 -1 1
v 1 1 1
v -1 1 1
f 1 2 3 4
f 5 8 7 6
f 1 5 6 2
f 3 7 8 4
f 2 6 7 3
f 1 4 8 5
""")
    pos, tri, nrm, uv = load_obj(str(obj))
    assert tri.shape == (12, 3)  # 6 quads fan-triangulated
    assert nrm is None and uv is None
    # z-flip applied
    assert pos[:, 2].min() == -1.0 and pos[:, 2].max() == 1.0


def test_obj_loader_with_uv_normals(tmp_path):
    obj = tmp_path / "t.obj"
    obj.write_text("""
v 0 0 0
v 1 0 0
v 0 1 0
vt 0 0
vt 1 0
vt 0 1
vn 0 0 1
f 1/1/1 2/2/1 3/3/1
""")
    pos, tri, nrm, uv = load_obj(str(obj))
    assert pos.shape == (3, 3)
    np.testing.assert_allclose(nrm[0], [0, 0, -1])  # z-flipped normal
    np.testing.assert_allclose(uv[:, 1], [1, 1, 0])  # FlipUVs


def test_scene_json_roundtrip(tmp_path):
    from fypraytracer_tpu.scene.sceneio import load_scene_file

    spec = {
        "materials": [
            {"name": "w", "albedo": [0.7, 0.7, 0.7]},
            {"name": "l", "emission_color": [1, 1, 1], "emission_power": 3.0},
        ],
        "meshes": [
            {"type": "quad", "material": "w", "size": [2, 2]},
            {"type": "sphere", "material": "w", "radius": 0.4, "rows": 4,
             "cols": 6, "position": [0, 0.4, 0]},
            {"type": "quad", "material": "l", "position": [0, 2, 0],
             "rotation": [180, 0, 0]},
        ],
        "camera": {"position": [0, 1, 3], "width": 32, "height": 32},
    }
    p = tmp_path / "scene.json"
    p.write_text(json.dumps(spec))
    builder, cam = load_scene_file(str(p))
    scene = builder.compile()
    assert scene.num_triangles == 2 + 4 * 6 * 2 + 2
    assert scene.num_emissive == 2
    assert cam.width == 32


def test_cli_render_end_to_end(tmp_path):
    from fypraytracer_tpu.app.cli import main

    out = tmp_path / "out"
    main(["render", "--scene", "cornell-empty", "--width", "32", "--height",
          "32", "--technique", "cosine", "--frames", "2", "-o", str(out)])
    files = os.listdir(out)
    assert any(f.endswith(".bmp") for f in files)
    assert any(f.endswith(".png") for f in files)
    sidecars = [f for f in files if f.endswith(".json")]
    assert sidecars
    rec = json.load(open(out / sidecars[0]))
    assert rec["settings"]["technique"] == "COSINE"


def test_cli_benchmark_two_techniques(tmp_path):
    from fypraytracer_tpu.app.cli import main

    out = tmp_path / "bench"
    main(["benchmark", "--scene", "cornell-empty", "--width", "24",
          "--height", "24", "--techniques", "cosine,nee", "--frames", "2",
          "--golden-frames", "4", "-o", str(out)])
    rows = json.load(open(out / "benchmark.json"))
    assert {r["technique"] for r in rows} == {"cosine", "nee"}
    assert all(np.isfinite(r["psnr"]) or r["mse"] == 0 for r in rows)


def test_cli_benchmark_timing_only(tmp_path):
    """--golden-frames 0 skips the golden render and PSNR columns."""
    from fypraytracer_tpu.app.cli import main

    out = tmp_path / "bench"
    main(["benchmark", "--scene", "cornell-empty", "--width", "24",
          "--height", "24", "--techniques", "cosine", "--frames", "2",
          "--golden-frames", "0", "-o", str(out)])
    rows = json.load(open(out / "benchmark.json"))
    assert rows[0]["technique"] == "cosine"
    assert "psnr" not in rows[0]
    assert not os.path.exists(out / "golden.png")


def test_cli_train_reduces_loss():
    from fypraytracer_tpu.app.cli import main
    import io
    import contextlib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["train", "--scene", "cornell-empty", "--width", "16",
              "--height", "16", "--bounces", "1", "--steps", "6",
              "--lr", "0.3"])
    lines = [json.loads(l) for l in buf.getvalue().splitlines()]
    losses = [l["loss"] for l in lines if "loss" in l]
    assert losses[-1] < losses[0]
    assert np.isfinite(lines[-1]["final_albedo_mae"])


def test_checkpoint_roundtrip(tmp_path):
    from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu.render.renderer import Renderer
    from fypraytracer_tpu.scene.procedural import cornell_box
    from fypraytracer_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    builder, cam = cornell_box(width=16, height=16, with_spheres=False)
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_DI,
                              light_candidates=2, spatial_neighbors=2,
                              spatial_radius=4)
    r = Renderer(scene, cam, settings)
    for _ in range(3):
        r.render_hdr()

    ck = tmp_path / "ckpt"
    save_checkpoint(str(ck), r)

    r2 = load_checkpoint(str(ck), scene)
    assert r2.frame_index == r.frame_index
    np.testing.assert_allclose(np.asarray(r2.accum), np.asarray(r.accum))

    # resumed render continues identically to an uninterrupted run
    a = np.asarray(r.render_hdr())
    b = np.asarray(r2.render_hdr())
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_checkpoint_roundtrip_restir_gi(tmp_path):
    """ReSTIR GI checkpoint/resume: accumulation, frame index and the
    path-sample reservoir state round-trip, so a resumed render continues
    exactly like an uninterrupted one."""
    from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu.render.renderer import Renderer
    from fypraytracer_tpu.scene.procedural import cornell_box
    from fypraytracer_tpu.utils.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    builder, cam = cornell_box(width=16, height=16, with_spheres=False)
    scene = builder.compile()
    settings = RenderSettings(technique=SamplingTechnique.RESTIR_GI,
                              bounces=2, spatial_neighbors=2,
                              spatial_radius=4)
    r = Renderer(scene, cam, settings)
    r.render_many(3)

    ck = tmp_path / "ckpt_gi"
    save_checkpoint(str(ck), r)
    r2 = load_checkpoint(str(ck), scene)
    assert r2.frame_index == r.frame_index
    for x, y in zip(jax.tree_util.tree_leaves(r.aux_state),
                    jax.tree_util.tree_leaves(r2.aux_state)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    a = np.asarray(r.render_many(2))
    b = np.asarray(r2.render_many(2))
    np.testing.assert_array_equal(a, b)


def test_checkpoint_from_removed_renderer_raises(tmp_path):
    """A checkpoint whose meta names another renderer class cannot be
    resumed into the wavefront renderer's state layout."""
    from fypraytracer_tpu.config import RenderSettings, SamplingTechnique
    from fypraytracer_tpu.render.renderer import Renderer
    from fypraytracer_tpu.scene.procedural import cornell_box
    from fypraytracer_tpu.utils.checkpoint import (load_checkpoint,
                                                   save_checkpoint)

    builder, cam = cornell_box(width=8, height=8, with_spheres=False)
    scene = builder.compile()
    r = Renderer(scene, cam, RenderSettings(
        technique=SamplingTechnique.COSINE, bounces=1))
    r.render_hdr()
    ck = tmp_path / "ck"
    save_checkpoint(str(ck), r)
    meta = json.load(open(ck / "meta.json"))
    meta["renderer"]["class"] = "MegakernelReSTIRGI"
    json.dump(meta, open(ck / "meta.json", "w"))
    with pytest.raises(ValueError, match="MegakernelReSTIRGI"):
        load_checkpoint(str(ck), scene)


def test_cli_render_checkpoint_resume(tmp_path):
    """`cli render --checkpoint-dir`: an interrupted render resumed from
    its checkpoint produces the SAME image as an uninterrupted run (the
    reference's offline renders lose everything on a crash,
    WalnutApp.cpp:901-905)."""
    import json as _json

    from fypraytracer_tpu.app import cli
    from fypraytracer_tpu.utils.image import load_png

    out_a = tmp_path / "a"
    out_b = tmp_path / "b"
    base = ["render", "--scene", "cornell", "--technique", "cosine",
            "--width", "16", "--height", "16", "--bounces", "1"]
    # uninterrupted 4-frame run
    cli.main(base + ["--frames", "4", "-o", str(out_a),
                     "--checkpoint-dir", str(tmp_path / "ck_a")])
    # interrupted: 2 frames, then resume to 4
    ck = str(tmp_path / "ck_b")
    cli.main(base + ["--frames", "2", "-o", str(tmp_path / "scratch"),
                     "--checkpoint-dir", ck])
    cli.main(base + ["--frames", "4", "-o", str(out_b),
                     "--checkpoint-dir", ck])

    a = load_png(str(next(out_a.glob("*.png"))))
    b = load_png(str(next(out_b.glob("*.png"))))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("technique", ["restir-di", "restir-gi"])
def test_cli_render_checkpoint_resume_restir(tmp_path, technique):
    """Checkpointed CLI render through the ReSTIR estimators: the
    reservoir state rides along, so resumed == uninterrupted."""
    from fypraytracer_tpu.app import cli
    from fypraytracer_tpu.utils.image import load_png

    out_a = tmp_path / "a"
    out_b = tmp_path / "b"
    base = ["render", "--scene", "cornell-empty", "--technique", technique,
            "--width", "16", "--height", "16", "--bounces", "1",
            "--candidates", "2", "--neighbors", "2", "--radius", "4",
            "--checkpoint-every", "2"]
    cli.main(base + ["--frames", "4", "-o", str(out_a),
                     "--checkpoint-dir", str(tmp_path / "ck_a")])
    ck = str(tmp_path / "ck_b")
    cli.main(base + ["--frames", "2", "-o", str(tmp_path / "scratch"),
                     "--checkpoint-dir", ck])
    cli.main(base + ["--frames", "4", "-o", str(out_b),
                     "--checkpoint-dir", ck])

    a = load_png(str(next(out_a.glob("*.png"))))
    b = load_png(str(next(out_b.glob("*.png"))))
    np.testing.assert_array_equal(a, b)
