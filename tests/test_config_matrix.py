"""Randomized config-matrix smoke test.

The reference exposes its whole parameter surface live in the Unity
Inspector (FluidSim.cs:12-110 — any combination can be dialed in at
runtime via OnValidate), so the engine must not have config-space
cliffs: every valid SimConfig combination must build, step, and stay
finite.  This fuzzes small grids across the interacting axes (ndim,
schemes, obstacle shapes, emitters, forces, dtype, boundary-relevant
sizes) — a seeded sample, so failures reproduce.
"""

import itertools
import random

import jax.numpy as jnp
import numpy as np
import pytest

import fluidsim_tpu as fs
from fluidsim_tpu.config import ObstacleShape, SimConfig
from fluidsim_tpu.engine import Engine

pytestmark = pytest.mark.slow  # exhaustive config matrix


def _random_cfg(rng: random.Random) -> SimConfig:
    ndim = rng.choice((2, 3))
    # [Range(32,512)] clamp (FluidSim.cs:21-22) — 32 is the legal minimum.
    size = 32 if ndim == 3 else rng.choice((32, 48, 64))
    scheme = rng.choice(
        ("semi_lagrangian",) if ndim == 2
        else ("semi_lagrangian", "windowed", "substep")
    )
    enable_obstacle = rng.random() < 0.7
    shape = rng.choice(list(ObstacleShape))
    nd_pos = tuple(rng.uniform(0.3, 0.7) for _ in range(ndim))
    kwargs = dict(
        ndim=ndim,
        size=size,
        resolution_multiplier=1.0,
        time_step=rng.choice((0.02, 0.1)),
        diffusion=rng.choice((0.0, 1e-4)),
        viscosity=rng.choice((0.0, 1e-4)),
        jacobi_iters=rng.choice((4, 20)),
        double_diffuse=rng.random() < 0.5,
        auto_adjust_parameters=rng.random() < 0.5,
        advection_scheme=scheme,
        enable_obstacle=enable_obstacle,
        obstacle_shape=shape,
        obstacle_position=nd_pos,
        obstacle_radius=rng.uniform(0.05, 0.2),
        enable_custom_source=rng.random() < 0.8,
        source_position=nd_pos,
        source_strength=rng.uniform(10.0, 200.0),
        source_emits_velocity=rng.random() < 0.5,
        source_pulsing=rng.random() < 0.3,
        pulse_clock=rng.choice(("sim", "wall")),
        apply_turbulent_noise=rng.random() < 0.3,
        dtype=rng.choice(("float32", "bfloat16")),
    )
    if scheme == "substep":
        kwargs["advect_substeps"] = rng.choice((1, 2, 3))
    if ndim == 3:
        kwargs.update(
            buoyancy=rng.choice((0.0, 1.0)),
            vorticity_confinement=rng.choice((0.0, 0.2)),
            gravity=rng.choice((0.0, 0.5)),
            density_dissipation=rng.choice((0.0, 3.0)),
            velocity_damping=rng.choice((0.0, 2.0)),
        )
    return SimConfig(**kwargs)


@pytest.mark.parametrize("seed", range(16))
def test_random_config_steps_finite(seed):
    rng = random.Random(1000 + seed)
    cfg = _random_cfg(rng)
    eng = Engine(cfg)
    eng.step(3)
    d = np.asarray(eng.state.density, dtype=np.float32)
    v = np.asarray(eng.state.velocity, dtype=np.float32)
    label = (
        f"seed={seed} ndim={cfg.ndim} size={cfg.size} "
        f"scheme={cfg.advection_scheme} obst={cfg.obstacle_shape} "
        f"dtype={cfg.dtype}"
    )
    assert np.isfinite(d).all() and np.isfinite(v).all(), label
    if cfg.enable_obstacle:
        ob = np.asarray(eng.state.obstacles)
        inner = ob.copy()
        for ax in range(inner.ndim):
            sl = [slice(None)] * inner.ndim
            sl[ax] = 0
            inner[tuple(sl)] = False
            sl[ax] = -1
            inner[tuple(sl)] = False
        if inner.any():
            assert np.abs(v[:, inner]).max() == 0.0, label


def test_all_presets_step():
    """Every shipped preset builds and steps at a scaled-down size."""
    from fluidsim_tpu.config import PRESETS

    for name in sorted(PRESETS):
        cfg = PRESETS[name]()
        if cfg.current_size > 48:
            cfg = cfg.replace(size=32, resolution_multiplier=1.0)
        eng = Engine(cfg)
        eng.step(2)
        assert bool(jnp.isfinite(eng.state.density).all()), name
