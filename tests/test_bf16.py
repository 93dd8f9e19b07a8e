"""bfloat16 field-storage audit.

Contract: fields may be *stored* bf16 (halving HBM traffic), but every
accumulation that matters — backtrace coordinates, hat weights, Jacobi
iterates, divergence/gradient — runs in float32.  These tests pin that:
the bf16 run must stay stable and track the f32 run to bf16 resolution.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fluidsim_tpu.config import SimConfig
from fluidsim_tpu.models.stable3d import make_step_3d
from fluidsim_tpu.scene.sources import apply_custom_source
from fluidsim_tpu.state import zeros_state

pytestmark = pytest.mark.slow  # bf16 rollouts


def cfg3(dtype, n=32):
    return SimConfig(
        size=n,
        ndim=3,
        dtype=dtype,
        time_step=0.02,
        diffusion=0.0,
        viscosity=1e-4,
        jacobi_iters=20,
        buoyancy=1.0,
        advect_window=2,
        enable_custom_source=True,
        source_strength=12.0,   # keeps densities O(10): bf16 resolution
        source_radius=3.0,      # ~0.06 there, so increments survive adds
        source_position=(0.5, 0.2, 0.5),
        obstacle_position=(0.5, 0.5, 0.5),
        enable_obstacle=False,
    ).validate()


def run(cfg, steps=10):
    state = zeros_state(cfg)
    step = make_step_3d(cfg)
    dt = np.float32(cfg.effective_params()[0])
    for _ in range(steps):
        t = state.time + dt
        d, v = apply_custom_source(state.density, state.velocity, cfg, t)
        state = step(state.replace(density=d.astype(state.density.dtype),
                                   velocity=v.astype(state.velocity.dtype)))
    return state


def test_bf16_step_stable_and_tracks_f32():
    s16 = run(cfg3("bfloat16"))
    s32 = run(cfg3("float32"))
    assert s16.density.dtype == jnp.bfloat16
    d16 = np.asarray(s16.density, np.float32)
    d32 = np.asarray(s32.density, np.float32)
    assert not np.isnan(d16).any()
    # Pointwise comparison is meaningless after chaotic advection (a
    # one-cell plume shift = full-scale local diff); audit the physics
    # instead: conserved mass, plume position, and bulk drift.  Mass
    # tolerance is bf16-inherent: with ~8 mantissa bits, adding a small
    # source increment to a much larger density absorbs part of it
    # (documented bf16-storage artifact; f32 accumulation only protects
    # *within* ops, not the state itself).
    mass16, mass32 = d16.sum(), d32.sum()
    assert abs(mass16 - mass32) < 3e-2 * abs(mass32)
    idx = np.indices(d32.shape).reshape(3, -1)
    com32 = (idx * d32.ravel()).sum(1) / d32.sum()
    com16 = (idx * d16.ravel()).sum(1) / d16.sum()
    assert np.abs(com16 - com32).max() < 0.5  # within half a cell
    scale = max(1.0, float(np.abs(d32).max()))
    assert float(np.abs(d16 - d32).mean()) < 2e-2 * scale
    v16 = np.asarray(s16.velocity, np.float32)
    v32 = np.asarray(s32.velocity, np.float32)
    vscale = max(1e-3, float(np.abs(v32).max()))
    assert float(np.abs(v16 - v32).mean()) < 2e-2 * vscale
