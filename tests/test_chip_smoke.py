"""chip_smoke.py off the card: it refuses the CPU, ``--devices 4`` runs
only the sharded phase, the last line is the result object, and the image
comparison helper is an 8-bit PSNR."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300,
                         cwd=REPO)
    assert out.returncode == 2
    assert "no GPU" in out.stderr
    assert '"ok"' not in out.stdout


class _Dev:
    platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fake_card(monkeypatch, tmp_path):
    """Pretend JAX has GPUs and record which phases run."""
    ran = []
    monkeypatch.setattr(chip_smoke, "require_gpu",
                        lambda n: [_Dev()] * n)
    monkeypatch.setattr(chip_smoke, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(chip_smoke, "enable_compile_cache", lambda: "x")
    for name in ("phase_dense", "phase_renders", "phase_stress",
                 "phase_training", "phase_multi_device"):
        monkeypatch.setattr(chip_smoke, name,
                            lambda *a, _n=name, **k: ran.append(_n))
    return ran, ["--out", str(tmp_path / "out")]


def test_devices_4_runs_only_the_sharded_phase(fake_card, capsys):
    ran, out = fake_card
    assert chip_smoke.main(["--devices", "4"] + out) == 0
    assert ran == ["phase_multi_device"]
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"]["count"] == 4


def test_last_line_is_the_result_object(fake_card, capsys):
    ran, out = fake_card
    assert chip_smoke.main(out) == 0
    assert ran == ["phase_dense", "phase_renders", "phase_stress",
                   "phase_training"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert "700.00 W" in "\n".join(lines[:-1])
    assert json.loads(lines[-1]) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_image_psnr_is_8bit_post_tonemap():
    a = np.full((8, 8, 3), 0.5, np.float32)
    assert chip_smoke.image_psnr(a, a) == float("inf")
    b = a.copy()
    b[0, 0, 0] = 100.0            # tonemaps to (nearly) white: one channel
    from fypraytracer_tpu.core.color import finalize_pixels, to_uint8_rgb

    d = (to_uint8_rgb(finalize_pixels(b, np.float32(1.0))).astype(float)
         - to_uint8_rgb(finalize_pixels(a, np.float32(1.0))).astype(float))
    want = 10 * np.log10(255.0 ** 2 / np.mean(d * d))
    assert chip_smoke.image_psnr(a, b) == pytest.approx(want)
    assert 20.0 < want < 60.0
