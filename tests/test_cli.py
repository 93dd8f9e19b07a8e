"""CLI smoke tests (run in-process; JAX already forced to CPU)."""

import json
import os

import numpy as np
import pytest

from fluidsim_tpu.cli import main


def run_cli(capsys, *argv):
    main(list(argv))
    out = capsys.readouterr().out.strip().splitlines()
    return out


def test_cli_presets(capsys):
    lines = run_cli(capsys, "presets")
    assert any("scene_a" in l for l in lines)
    assert any("bench128" in l for l in lines)


def test_cli_run_and_checkpoint(tmp_path, capsys):
    ckpt = str(tmp_path / "s.npz")
    db = str(tmp_path / "m.db")
    lines = run_cli(
        capsys, "run", "--preset", "smoke32", "--steps", "6",
        "--substeps", "3", "--db", db, "--checkpoint", ckpt,
    )
    res = json.loads(lines[-1])
    assert res["steps"] == 6
    assert res["grid"] == [32, 32, 32]
    assert res["steps_per_sec"] > 0
    assert os.path.exists(ckpt)
    assert os.path.exists(db)


def test_cli_bench(capsys):
    lines = run_cli(capsys, "bench", "--preset", "smoke32", "--steps", "4",
                    "--substeps", "2")
    res = json.loads(lines[-1])
    assert res["p50_ms"] > 0


def test_cli_render_3d(tmp_path, capsys):
    out = str(tmp_path / "frames")
    lines = run_cli(capsys, "render", "--preset", "smoke32", "--steps", "4",
                    "--render-every", "2", "-o", out)
    res = json.loads(lines[-1])
    assert res["frames"] == 2
    files = os.listdir(out)
    assert len(files) == 2


def test_cli_render_2d_streamlines(tmp_path, capsys):
    from fluidsim_tpu.config import SimConfig
    from fluidsim_tpu.io.checkpoint import save_config

    cfg = SimConfig(
        size=32, time_step=0.05, enable_custom_source=True,
        source_emits_velocity=True, source_velocity=10.0,
        source_position=(0.3, 0.5), enable_obstacle=False,
        obstacle_position=(0.5, 0.5), show_streamlines=True,
        streamline_density=1,
    )
    cfg_path = str(tmp_path / "cfg.json")
    save_config(cfg_path, cfg)
    out = str(tmp_path / "frames2d")
    lines = run_cli(capsys, "render", "--config", cfg_path, "--steps", "4",
                    "--render-every", "2", "-o", out)
    res = json.loads(lines[-1])
    assert res["frames"] == 2


def test_cli_save_config(tmp_path, capsys):
    out = str(tmp_path / "cfg.json")
    db = str(tmp_path / "m.db")
    lines = run_cli(capsys, "save-config", "--preset", "scene_a",
                    "-o", out, "--db", db)
    res = json.loads(lines[-1])
    assert os.path.exists(out)
    assert res["run_id"] > 0  # scene_a's dt=0.0025 passes the 0.1-guard


def test_cli_render_html(tmp_path, capsys):
    out = str(tmp_path / "web")
    lines = run_cli(capsys, "render", "--preset", "smoke32", "--steps", "4",
                    "--render-every", "2", "-o", out, "--html")
    res = json.loads(lines[-1])
    assert res["html"] and os.path.exists(res["html"])
    html = open(res["html"]).read()
    assert "data:image/png;base64," in html
    assert "canvas" in html


def test_png_writer_fallback(tmp_path):
    """The dependency-free PNG encoder produces a decodable file."""
    import numpy as np
    from fluidsim_tpu.render.viewer import _encode_png

    img = (np.random.RandomState(0).rand(16, 16, 3) * 255).astype(np.uint8)
    data = _encode_png(img)
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    from PIL import Image
    import io

    back = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(back, img)


def test_build_engine_pulse_clock():
    """cmd_serve's --pulse-clock folds into the engine's config at build
    time (no post-hoc set_config / obstacle re-rasterization)."""
    import argparse

    from fluidsim_tpu.cli import _build_engine

    args = argparse.Namespace(
        preset="smoke32", config=None, size=None,
        dtype=None, nan_guard=False, pulse_clock="wall",
    )
    eng = _build_engine(args)
    assert eng.cfg.pulse_clock == "wall"


def test_build_engine_advect_substeps_override():
    """--advect-substeps forces the substepped scheme with that count
    (n_sub=1 = the reference's single semi-Lagrangian backtrace)."""
    import argparse

    from fluidsim_tpu.cli import _build_engine

    args = argparse.Namespace(
        preset="bench128", config=None, size=32,
        dtype=None, nan_guard=False, advect_substeps=1,
    )
    eng = _build_engine(args)
    assert eng.cfg.advection_scheme == "substep"
    assert eng.cfg.advect_substeps == 1


def test_cli_bench_mesh(capsys):
    """`bench --mesh N` measures the slab-sharded step (BASELINE config 5's
    reproducible command).  The test mesh reuses the
    conftest's 8 virtual CPU devices."""
    lines = run_cli(
        capsys, "bench", "--preset", "smoke32", "--mesh", "8",
        "--halo", "explicit", "--halo-block-iters", "2",
        "--steps", "4", "--substeps", "2",
    )
    res = json.loads(lines[-1])
    assert res["mesh"] == 8
    assert res["halo"] == "explicit"
    assert res["steps_per_sec"] > 0


def test_cli_bench_mesh_too_many_devices(capsys):
    lines = run_cli(
        capsys, "bench", "--preset", "smoke32", "--mesh", "64",
        "--steps", "2", "--substeps", "1",
    )
    res = json.loads(lines[-1])
    assert "error" in res and "64 devices requested" in res["error"]
