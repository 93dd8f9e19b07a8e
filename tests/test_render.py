"""Render layer tests: colormap modes, streamlines (native + NumPy
rasterizer agreement), raymarcher."""

import os
import shutil
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp

import fluidsim_tpu as fs
from fluidsim_tpu.config import ColorMode, SimConfig
from fluidsim_tpu.render.colormap import evaluate_gradient, render_frame_2d
from fluidsim_tpu.render.raymarch import raymarch_density, render_frame_3d
from fluidsim_tpu.render.streamlines import (
    _rasterize_numpy,
    compute_streamline_segments,
    native_rasterizer_available,
    rasterize_streamlines,
    streamline_skip,
)


def cfg2d(**kw):
    base = dict(size=32, enable_obstacle=False,
                obstacle_position=(0.5, 0.5),
                enable_custom_source=False)
    base.update(kw)
    return SimConfig(**base)


def fields(n=32):
    rng = np.random.RandomState(0)
    density = jnp.asarray(np.abs(rng.randn(n, n)) * 80, jnp.float32)
    pressure = jnp.asarray(rng.randn(n, n) * 40, jnp.float32)
    obst = np.zeros((n, n), bool)
    obst[10:14, 10:14] = True
    return density, pressure, jnp.asarray(obst)


@pytest.mark.parametrize("mode", list(ColorMode))
def test_render_modes_shapes_and_range(mode):
    density, pressure, obst = fields()
    cfg = cfg2d(color_mode=mode, enable_obstacle=True)
    frame = render_frame_2d(density, pressure, obst, cfg)
    assert frame.shape == (32, 32, 4)
    assert bool(jnp.isfinite(frame).all())
    # obstacles painted obstacle_color
    np.testing.assert_allclose(
        np.asarray(frame)[11, 11], cfg.obstacle_color, atol=1e-6
    )


def test_single_color_scales_with_density():
    density, pressure, _ = fields()
    obst = jnp.zeros((32, 32), bool)
    cfg = cfg2d(color_mode=ColorMode.SINGLE_COLOR,
                fluid_color=(1.0, 0.5, 0.25, 1.0), colour_intensity=0.01)
    frame = np.asarray(render_frame_2d(density, pressure, obst, cfg))
    d = np.asarray(density)
    np.testing.assert_allclose(frame[..., 0], d * 0.01, rtol=1e-5)
    np.testing.assert_allclose(frame[..., 1], d * 0.01 * 0.5, rtol=1e-5)


def test_gradient_eval_matches_reference_walk():
    colors = ((0, 0, 1, 1), (0, 1, 0, 1), (1, 0, 0, 1))
    times = (0.0, 0.4, 1.0)
    t = jnp.asarray([0.0, 0.2, 0.4, 0.7, 1.0, 1.5])
    out = np.asarray(evaluate_gradient(t, colors, times))
    np.testing.assert_allclose(out[0], (0, 0, 1, 1), atol=1e-6)
    np.testing.assert_allclose(out[1], (0, 0.5, 0.5, 1), atol=1e-6)  # mid blue→green
    np.testing.assert_allclose(out[2], (0, 1, 0, 1), atol=1e-6)
    np.testing.assert_allclose(out[3], (0.5, 0.5, 0, 1), atol=1e-6)  # mid green→red
    np.testing.assert_allclose(out[4], (1, 0, 0, 1), atol=1e-6)
    np.testing.assert_allclose(out[5], (1, 0, 0, 1), atol=1e-6)  # clamped


def test_streamline_segments():
    n = 40
    # density=1 → skip = max(1, 40//10) = 4, so max length = 3
    # (density=4 would give skip=1 → all lengths min(0, ·) = 0, faithful
    # to the reference formula at FluidSim.cs:892,1720)
    cfg = cfg2d(size=40, streamline_density=1, streamline_scale=2.0)
    vx = jnp.ones((n, n), jnp.float32) * 0.5
    vy = jnp.zeros((n, n), jnp.float32)
    obst = jnp.zeros((n, n), bool)
    segs = np.asarray(compute_streamline_segments(vx, vy, obst, cfg))
    skip = streamline_skip(cfg)
    valid = segs[segs[:, 0] >= 0]
    assert len(valid) > 0
    # horizontal flow → segments extend in +x, length = |v|·scale = 1
    np.testing.assert_allclose(valid[:, 2] - valid[:, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(valid[:, 3], valid[:, 1], atol=1e-5)
    # low-flow cells are invalid
    segs2 = np.asarray(
        compute_streamline_segments(vx * 0.001, vy, obst, cfg)
    )
    assert (segs2[:, 0] < 0).all()


@pytest.fixture
def native_rasterizer():
    """The native rasterizer, built with ``make -C native`` when missing."""
    from fluidsim_tpu.render import streamlines

    if not native_rasterizer_available():
        if shutil.which("make") is None or shutil.which("g++") is None:
            pytest.skip("no make/g++ to build native/librasterizer.so")
        native = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "native")
        subprocess.run(["make", "-C", native], check=True,
                       capture_output=True)
        streamlines._NATIVE = streamlines._load_native()
    assert native_rasterizer_available()


def test_native_rasterizer_matches_numpy(native_rasterizer):
    n = 48
    cfg = cfg2d(size=48, streamline_thickness=2.0,
                streamline_color=(1, 0, 0, 1))
    rng = np.random.RandomState(1)
    segs = np.zeros((20, 4), np.float32)
    segs[:, 0] = rng.randint(2, n - 2, 20)
    segs[:, 1] = rng.randint(2, n - 2, 20)
    segs[:, 2] = segs[:, 0] + rng.randint(-6, 7, 20)
    segs[:, 3] = segs[:, 1] + rng.randint(-6, 7, 20)
    segs[::5, 0] = -1  # invalid rows
    native = rasterize_streamlines(jnp.asarray(segs), cfg)
    ref = np.zeros((n, n, 4), np.float32)
    _rasterize_numpy(segs, ref, np.asarray(cfg.streamline_color, np.float32),
                     n, cfg.streamline_thickness)
    np.testing.assert_array_equal(native, ref)


def test_composite_over():
    cfg = cfg2d(size=32, streamline_color=(0, 1, 0, 1))
    segs = np.asarray([[5, 5, 12, 5]], np.float32)
    base = np.zeros((32, 32, 4), np.float32)
    base[..., 2] = 0.3
    out = rasterize_streamlines(jnp.asarray(segs), cfg, base_frame=base)
    assert (out[5, 5] == (0, 1, 0, 1)).all()       # overlay wins
    np.testing.assert_allclose(out[20, 20], (0, 0, 0.3, 0), atol=1e-7)


def test_raymarch_basics():
    n = 24
    d = np.zeros((n, n, n), np.float32)
    d[:, 8:16, 8:16] = 100.0  # a dense column along z
    img = np.asarray(raymarch_density(jnp.asarray(d), None))
    assert img.shape == (n, n, 3)
    assert img[12, 12].sum() > img[2, 2].sum()  # column brighter than empty
    assert np.isfinite(img).all()
    # opaque obstacle occludes: obstacle at front → gray pixel
    obst = np.zeros((n, n, n), bool)
    obst[0, 4, 4] = True
    img2 = np.asarray(raymarch_density(jnp.asarray(d), jnp.asarray(obst)))
    np.testing.assert_allclose(img2[4, 4], (0.5, 0.5, 0.5), atol=1e-5)


def test_render_frame_3d_from_engine():
    from fluidsim_tpu.engine import Engine

    cfg = fs.get_preset("smoke32").replace(advect_window=2)
    eng = Engine(cfg)
    eng.step(5)
    img = render_frame_3d(eng.state, cfg)
    assert img.shape == (32, 32, 3)
    assert float(jnp.abs(img).sum()) > 0


def test_use_lerp_color_cycling():
    """PingPong color cycling (FluidSim.cs:790-794): the effective fluid
    color interpolates start→end with t·0.1 ping-ponged in [0,1]."""
    density = jnp.ones((16, 16), jnp.float32)  # density 1, intensity 1
    pressure = jnp.zeros((16, 16), jnp.float32)
    obst = jnp.zeros((16, 16), bool)
    cfg = cfg2d(size=32, use_lerp=True,
                start_color=(0.0, 0.0, 0.0, 1.0),
                end_color=(1.0, 1.0, 1.0, 1.0))
    # t=0 → cycle = 1-|0-1| = 0 → start color → black frame
    f0 = np.asarray(render_frame_2d(density, pressure, obst, cfg,
                                    elapsed_time=0.0))
    # t·0.1 = 1 → cycle = 1 → end color (white·density=1)
    f1 = np.asarray(render_frame_2d(density, pressure, obst, cfg,
                                    elapsed_time=10.0))
    np.testing.assert_allclose(f0[4, 4, :3], 0.0, atol=1e-6)
    np.testing.assert_allclose(f1[4, 4, :3], 1.0, atol=1e-6)
