"""Interactive viewer (apps/viewer.py) driven headlessly with scripted keys
(reference UX parity: Space alg toggle, orbit, fly, P pause, C camera print —
optixPathTracer.cpp:121-240)."""
import os

import numpy as np
import pytest

from spcbpt_tpu.apps import viewer


def test_orbit_and_fly_move_camera():
    class Cam:
        eye = np.array([0.0, 0.0, -5.0], np.float32)
        lookat = np.array([0.0, 0.0, 0.0], np.float32)
        up = np.array([0.0, 1.0, 0.0], np.float32)
        fov_y = 45.0

    c = Cam()
    viewer.orbit(c, 90.0, 0.0)
    np.testing.assert_allclose(c.eye, [-5, 0, 0], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(c.eye - c.lookat), 5.0,
                               rtol=1e-6)
    viewer.fly(c, 0.1)
    np.testing.assert_allclose(np.linalg.norm(c.eye - c.lookat), 5.0,
                               rtol=1e-6)  # fly translates both
    d0 = np.linalg.norm(c.eye)
    viewer.strafe(c, 0.2)
    assert abs(np.linalg.norm(c.eye - c.lookat) - 5.0) < 1e-4


def test_ansi_frame_shapes():
    img = np.random.default_rng(0).integers(0, 255, (64, 64, 3),
                                            dtype=np.uint8)
    s = viewer.ansi_frame(img, max_cols=32, max_rows=16)
    rows = s.split("\n")
    # 64px tall, downsample fy=4 -> 16 rows -> 8 half-block text rows
    assert len(rows) == 8
    assert all(len(r) > 0 for r in rows)
    assert "▀" in rows[0]


def test_scripted_session_renders_and_saves(tmp_path, capsys, read_png):
    out = str(tmp_path / "view.png")
    rc = viewer.main(["--scene", "cornell", "--dim", "32x32",
                      "--max-depth", "4", "--keys", " cp", "--frames", "5",
                      "--no-display", "--out", out])
    assert rc == 0
    assert os.path.exists(out)
    cap = capsys.readouterr()
    assert "[camera]" in cap.out  # the 'c' key printed the pose
    im = read_png(out)
    assert im.shape == (32, 32, 3)
    assert im.mean() > 1  # scene is lit
